"""PyTorch port vs the JAX reference: multi-head latent attention (MLA) at
the reference's smoke size (``smoke_variant``, float32, on the CPU), for
``minicpm3-4b`` (dense), ``deepseek-v2-236b`` (MoE with shared experts)
and MiniCPM3's smoke variant with full-rank queries (``q_lora_rank=0``).

The same parameters (numpy, from a seed, in the reference's nested
layout) and token ids feed both packages:

* ``mla_forward`` of one layer against the reference's ``impl="xla"``: no
  cache; a chunked prefill then one-token steps at a shared length; per-
  sequence lengths with an idle lane past the cache's end (its rows
  clamped to ``S - T``); absorbed (latent-space) attention against the
  reference's absorbed path, at a shared length and per sequence (T = 3:
  its causal mask);
* the configurations and ``param_counts``, ``init_cache`` shapes, and
  every leaf through ``interop.lm_params_from_arrays``;
* ``forward``, ``decode_step`` (absorbed and not) and ``generate``; the
  absorbed decode against the expanded one on the port alone;
* the plain attention versions at a value width below the key width
  against the reference's ``_sdpa`` jnp path (flash and decode shapes).

The reference's Pallas path sizes v by q's head dim and raises on MLA
(``ROADMAP.md`` queue 3), so the port is held to ``impl="xla"``.  Each
world's reference runs are cached for the module.  Tolerance: 2e-5 on one
layer, 2e-4 on logits (``test_torch_lm.py``; the reference's own MLA
tolerance, ``tests/test_models_smoke.py``).
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.models import attention as r_attn
from repro.models import lm as r_lm
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import base as p_base
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.kernels.decode_attention import ref as p_da_ref
from repro_torch.kernels.flash_attention import ref as p_fa_ref
from repro_torch.models import attention as p_attn
from repro_torch.models import lm as p_lm
from repro_torch.serve import lm as p_serve
from test_torch_batcher import (  # noqa: F401
    _draw, _jitted_serve_fns, one_torch_thread)

ARCHS = ("minicpm3-4b", "deepseek-v2-236b")
WORLDS = ARCHS + ("minicpm3-4b-q0",)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
S = 16                                  # cache rows of the layer tests


def _q0(cfg):
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, q_lora_rank=0))


def _absorbed(cfg):
    return dataclasses.replace(cfg, mla_absorbed=True)


@functools.lru_cache(maxsize=None)
def _world(name):
    """Both packages' smoke configs (full-rank queries for ``-q0``) and
    the same parameters."""
    arch = name.replace("-q0", "")
    rcfg = r_base.smoke_variant(r_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    if name.endswith("-q0"):
        rcfg, cfg = _q0(rcfg), _q0(cfg)
    arrays = _draw(rcfg)
    return dict(cfg=cfg, rcfg=rcfg, arrays=arrays,
                rparams=jax.tree.map(jnp.asarray, arrays),
                model=interop.lm_params_from_arrays(arrays, cfg))


def _tokens(b, t, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _pos(start, b, t):
    start = np.broadcast_to(np.asarray(start), (b,))
    return (start[:, None] + np.arange(t)).astype(np.int32)


# --------------------------------------------------------------------------
# one layer
# --------------------------------------------------------------------------

def _steps(mode):
    """(T, positions start) of each call, and the cache: None, a shared
    length, or per-sequence lengths (4 lanes; 19 and 16 lie past the
    16-row cache, so their rows go at S - T)."""
    if mode == "nocache":
        return [(6, 0)], None
    if mode in ("shared", "absorbed_shared"):
        return [(5, 0), (3, 5), (1, 8), (1, 9)], 0
    lens = np.array([0, 5, 19, 16], np.int32)
    return [(1, lens), (3, lens + 1)], lens


@functools.lru_cache(maxsize=None)
def _r_mla(rcfg):
    return jax.jit(functools.partial(r_attn.mla_forward, cfg=rcfg,
                                     impl="xla"))


@functools.lru_cache(maxsize=None)
def _layer_runs(name, mode):
    """Both sides' outputs and caches after each call of ``_steps``."""
    w = _world(name)
    cfg, rcfg = w["cfg"], w["rcfg"]
    if mode.startswith("absorbed"):
        cfg, rcfg = _absorbed(cfg), _absorbed(rcfg)
    at = {n: jnp.asarray(a[0]) for n, a in
          w["arrays"]["blocks"]["sub0"]["attn"].items()}
    ours = w["model"].blocks[0].attn
    steps, lens = _steps(mode)
    b = 2 if lens is None or np.ndim(lens) == 0 else len(lens)
    rng = np.random.default_rng(len(mode))
    pc = rc = None
    if lens is not None:
        per_seq = np.ndim(lens) > 0
        pc = p_attn.mla_cache_shape(cfg, b, S, torch.float32, "cpu", per_seq)
        rc = r_attn.mla_cache_shape(rcfg, b, S, jnp.float32, per_seq)
        if per_seq:                  # lanes already holding rows
            ckv = rng.standard_normal(pc["ckv"].shape).astype(np.float32)
            kr = rng.standard_normal(pc["krope"].shape).astype(np.float32)
            pc["ckv"].copy_(torch.from_numpy(ckv))
            pc["krope"].copy_(torch.from_numpy(kr))
            pc["len"].copy_(torch.from_numpy(lens))
            rc = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr),
                  "len": jnp.asarray(lens)}
    got, want = [], []
    for t, start in steps:
        x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
        pos = _pos(start, b, t)
        out, pc = p_attn.mla_forward(ours, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos).long(), pc)
        r_out, rc = _r_mla(rcfg)(at, x=jnp.asarray(x),
                                 positions=jnp.asarray(pos), cache=rc)
        got.append((out.numpy(), pc and {k: np.array(v) if torch.is_tensor(v)
                                         else v for k, v in pc.items()}))
        want.append((np.asarray(r_out), rc and {k: np.asarray(v)
                                                for k, v in rc.items()}))
    return got, want


@pytest.mark.parametrize("mode", ["nocache", "shared", "per_seq",
                                  "absorbed_shared", "absorbed_per_seq"])
@pytest.mark.parametrize("name", WORLDS)
def test_mla_forward_matches_reference(name, mode):
    got, want = _layer_runs(name, mode)
    for (out, pc), (r_out, rc) in zip(got, want):
        assert out.shape == r_out.shape
        np.testing.assert_allclose(out, r_out, **LAYER_TOL)
        if rc is None:
            assert pc is None
            continue
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(pc[k], rc[k], **LAYER_TOL)
        np.testing.assert_array_equal(np.asarray(pc["len"]), rc["len"])


def test_mla_cache_rows_are_written_in_place():
    """The port writes the latent rows into the given tensors (the
    reference returns new arrays), and a shared length that does not fit
    raises."""
    w = _world("minicpm3-4b")
    cfg, layer = w["cfg"], w["model"].blocks[0].attn
    cache = p_attn.mla_cache_shape(cfg, 1, 8, torch.float32)
    ckv = cache["ckv"]
    x = torch.ones((1, 3, cfg.d_model))
    _, new = p_attn.mla_forward(layer, cfg, x, torch.arange(3)[None], cache)
    assert new["ckv"] is ckv and new["len"] == 3
    assert bool((ckv[0, :3] != 0).any()) and bool((ckv[0, 3:] == 0).all())
    with pytest.raises(ValueError, match="do not fit"):
        p_attn.mla_forward(layer, cfg, torch.ones((1, 6, cfg.d_model)),
                           torch.arange(3, 9)[None], new)


# --------------------------------------------------------------------------
# configuration, caches and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    for ours, ref in ((get_config(arch), r_get_config(arch)),
                      (smoke_variant(get_config(arch)),
                       r_base.smoke_variant(r_get_config(arch)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert (ours.padded_vocab, ours.num_periods, ours.resolved_head_dim) \
            == (ref.padded_vocab, ref.num_periods, ref.resolved_head_dim)
    assert arch in registered() and arch not in p_base.NOT_PORTED
    full = get_config(arch)
    m = full.mla
    dims = (m.nope_head_dim + m.rope_head_dim, m.v_head_dim)
    total = round(full.param_counts()["total"] / 1e9, 2)
    if arch == "minicpm3-4b":
        assert (dims, full.num_heads, total) == ((96, 64), 40, 4.26)
    else:
        assert (dims, full.num_heads, total) == ((192, 128), 128, 239.37)
        assert (full.moe.num_experts, full.moe.top_k,
                full.moe.num_shared) == (160, 6, 2)


@pytest.mark.parametrize("per_seq", [False, True])
@pytest.mark.parametrize("name", WORLDS)
def test_init_cache_shapes_match_reference(name, per_seq):
    w = _world(name)
    pc = p_lm.init_cache(w["cfg"], 3, 11, device="cpu", per_seq=per_seq)
    rc = r_lm.init_cache(w["rcfg"], 3, 11, per_seq=per_seq)["sub0"]["attn"]
    assert set(pc) == set(rc) == {"ckv", "krope", "len"}
    for k in ("ckv", "krope"):
        assert tuple(pc[k].shape) == rc[k].shape
        assert pc[k].dtype == torch.float32 and not bool(pc[k].any())
    if per_seq:
        assert pc["len"].dtype == torch.int32 and pc["len"].tolist() == [0] * 3
    else:
        assert pc["len"] == 0


@pytest.mark.parametrize("name", WORLDS)
def test_params_carry_every_leaf(name):
    w = _world(name)
    cfg, state = w["cfg"], w["model"].state_dict()
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(w["arrays"]):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(cfg.num_layers):
                name_i = ".".join(["blocks", str(i)] + keys[2:])
                np.testing.assert_array_equal(state[name_i].numpy(), a[i])
                seen.add(name_i)
        else:
            np.testing.assert_array_equal(state[keys[0]].numpy(), a)
            seen.add(keys[0])
    assert seen == set(state)
    attn = {n.split(".")[-1] for n in seen if ".attn." in n}
    query = {"wq"} if name.endswith("-q0") else {"wq_a", "wq_b"}
    assert attn == query | {"wkv_a", "wk_rope", "wkv_b", "wo"}
    # the port's own init builds the same tree
    ours = p_lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert set(ours.state_dict()) == set(state)


def test_init_attention_draws_the_reference_distributions():
    """MiniCPM3's widths: MLA weights normal / sqrt(fan_in)."""
    cfg = dataclasses.replace(get_config("minicpm3-4b"), num_layers=1)
    layer = p_attn.init_attention(cfg, torch.Generator().manual_seed(0),
                                  "cpu", torch.float32)
    assert isinstance(layer, p_attn.MLA) and layer.wq is None
    for name, fan_in in (("wq_a", 2560), ("wq_b", 768), ("wkv_a", 2560),
                         ("wk_rope", 2560), ("wkv_b", 256), ("wo", 2560)):
        w = getattr(layer, name)
        assert w.shape[0] == fan_in
        assert abs(float(w.std()) * fan_in ** 0.5 - 1) < 0.02, name
    assert layer.wkv_b.shape == (256, 40 * 128)
    assert layer.wo.shape == (40 * 64, 2560)


# --------------------------------------------------------------------------
# the model and generation
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _r_forward(rcfg):
    return jax.jit(functools.partial(r_lm.forward, cfg=rcfg, impl="xla"))


@functools.lru_cache(maxsize=None)
def _r_decode(rcfg):
    return jax.jit(functools.partial(r_lm.decode_step, cfg=rcfg, impl="xla"))


@pytest.mark.parametrize("name", WORLDS)
def test_forward_matches_reference(name):
    w = _world(name)
    toks = _tokens(2, 20, 3)
    got = p_lm.forward(w["model"], torch.from_numpy(toks))
    want, _ = _r_forward(w["rcfg"])(w["rparams"], batch={
        "tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("name", WORLDS)
def test_decode_step_matches_reference(name, absorbed):
    """A 9-token prefill, a 3-token chunk, then two one-token steps."""
    w = _world(name)
    cfg, rcfg = w["cfg"], w["rcfg"]
    if absorbed:
        cfg, rcfg = _absorbed(cfg), _absorbed(rcfg)
    model = interop.lm_params_from_arrays(w["arrays"], cfg)
    pc = p_lm.init_cache(cfg, 2, 16, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, 16)
    start = 0
    for t, seed in ((9, 4), (3, 5), (1, 6), (1, 7)):
        toks = _tokens(2, t, seed)
        got = p_lm.decode_step(model, torch.from_numpy(toks), pc)
        want, rc = _r_decode(rcfg)(w["rparams"], batch={
            "tokens": jnp.asarray(toks)}, caches=rc, pos=jnp.int32(start))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        start += t
        assert pc["len"] == start
    np.testing.assert_allclose(pc["ckv"].numpy(),
                               np.asarray(rc["sub0"]["attn"]["ckv"]),
                               **LOGIT_TOL)


@pytest.mark.parametrize("name", WORLDS)
def test_generate_matches_reference(name):
    """Equal ids; and the teacher-forced logits of the prefill and every
    step, both sides fed the reference's ids."""
    w = _world(name)
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    prompt, max_new, max_len = _tokens(2, 7, 8), 5, 14
    got = p_serve.generate(model, prompt, max_new, max_len=max_len,
                           device="cpu")
    with mock.patch.object(r_serve, "make_serve_fns", _jitted_serve_fns):
        want = r_serve.generate(w["rparams"], rcfg, jnp.asarray(prompt),
                                max_new, max_len=max_len, impl="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    prefill, step = p_serve.make_serve_fns(model)
    r_prefill, r_step = _jitted_serve_fns(rcfg, max_len)
    pc = p_lm.init_cache(cfg, 2, max_len, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, max_len)
    ours = prefill(torch.from_numpy(prompt), pc)
    ref, rc = r_prefill(w["rparams"], {"tokens": jnp.asarray(prompt)}, rc)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LOGIT_TOL)
    ids = np.asarray(want)
    for i in range(max_new - 1):
        tok = ids[:, i:i + 1].copy()
        ours = step(torch.from_numpy(tok), pc)
        ref, rc = r_step(w["rparams"], {"tokens": jnp.asarray(tok)}, rc,
                         jnp.int32(7 + i))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                                   **LOGIT_TOL)


def test_absorbed_decode_equals_expanded_decode():
    """Absorption reorders the products of one function: the two paths'
    logits agree on the port alone."""
    w = _world("deepseek-v2-236b")
    toks = _tokens(2, 12, 9)
    out = {}
    for absorbed in (False, True):
        cfg = dataclasses.replace(w["cfg"], mla_absorbed=absorbed)
        model = interop.lm_params_from_arrays(w["arrays"], cfg)
        cache = p_lm.init_cache(cfg, 2, 12, device="cpu")
        out[absorbed] = torch.cat(
            [p_lm.decode_step(model, torch.from_numpy(toks[:, :8]), cache)]
            + [p_lm.decode_step(model, torch.from_numpy(toks[:, i:i + 1]),
                                cache) for i in range(8, 12)], dim=1)
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(),
                               **LOGIT_TOL)


# --------------------------------------------------------------------------
# the plain attention versions at a value width below the key width
# --------------------------------------------------------------------------

# (b, hq, hk, tq, tk, d, dv, q_offset): MLA's smoke dims (24, 16), MiniCPM3's
# (96, 64) and DeepSeek-V2's (192, 128)
PLAIN_CASES = [(2, 4, 4, 6, 11, 24, 16, 5), (1, 4, 2, 5, 5, 96, 64, 0),
               (1, 2, 2, 3, 9, 192, 128, 6)]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_attention_at_a_narrower_value_matches_reference(case):
    b, hq, hk, tq, tk, d, dv, off = case
    rng = np.random.default_rng(d)
    q = rng.standard_normal((b, tq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hk, dv)).astype(np.float32)

    def bhtd(a):
        return torch.from_numpy(a.transpose(0, 2, 1, 3).copy())

    want = np.asarray(r_attn._sdpa(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), True, None, off))
    got = p_fa_ref.attention_ref(bhtd(q), bhtd(k), bhtd(v), True, None, off)
    assert got.shape == (b, hq, tq, dv)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), want,
                               **LAYER_TOL)
    # one query row per sequence at its own offset: decode attention
    offs = np.array([off + tq - 1] * b, np.int32) - np.arange(b, dtype=np.int32)
    want = np.asarray(r_attn._sdpa(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                   jnp.asarray(v), True, None,
                                   jnp.asarray(offs)))
    got = p_da_ref.decode_attention_ref(bhtd(q[:, :1]), bhtd(k), bhtd(v),
                                        torch.from_numpy(offs + 1))
    assert got.shape == (b, hq, 1, dv)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3), want,
                               **LAYER_TOL)
