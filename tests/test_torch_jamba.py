"""PyTorch port vs the JAX reference: Mamba-1 and the hybrid layer
pattern of ``jamba-v0.1-52b`` at the reference's smoke widths
(``smoke_variant``: d_model 64, d_inner 128, d_state 16, dt rank 4, 4/2
heads of 16, 4 experts top-2, float32, on the CPU), cut to one period of
the pattern (8 layers: Mamba-1 but for attention at layer 4, an MoE FFN
on the odd layers, a dense one on the even).

The same parameters (numpy, from a seed, in the reference's nested
layout) and token ids feed both packages:

* the configuration, ``param_counts`` and the registry;
* ``_causal_conv`` at Mamba-1's width, and ``mamba1_forward`` in its
  three branches (no cache, a cached prefill from a nonzero state, one
  token), the cache it writes in place included; the chunked scan against
  one chunk, no chunk longer than ``scan_chunk``;
* ``forward`` (capacity and dropless MoE), ``decode_step`` (a prefill,
  then one-token steps) and greedy ``generate`` against the reference's
  ``impl="xla"`` (Mamba-1 has no Pallas kernel there);
* the hybrid cache (attention and Mamba stacks side by side) and every
  leaf through ``lm_params_from_arrays``, a Mamba layer's FFN included.

Each reference function is jitted once per shape.  Tolerance: 2e-4
absolute and relative (float32 sums in another order: the port's scan
chunks and its log-depth steps against ``associative_scan``).
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
from repro.models import lm as r_lm
from repro.models import mamba as r_mamba
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.models import lm as p_lm
from repro_torch.models import mamba as p_mamba
from repro_torch.serve import lm as p_serve
from test_torch_batcher import (  # noqa: F401
    _draw, _jitted_serve_fns, one_torch_thread)

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=2e-4, atol=2e-4)


def one_period(cfg):
    return dataclasses.replace(cfg, num_layers=cfg.period)


@functools.lru_cache(maxsize=None)
def _world():
    rcfg = one_period(r_base.smoke_variant(r_get_config(ARCH)))
    cfg = one_period(smoke_variant(get_config(ARCH)))
    arrays = _draw(rcfg)
    return dict(cfg=cfg, rcfg=rcfg, arrays=arrays,
                rparams=jax.tree.map(jnp.asarray, arrays),
                model=interop.lm_params_from_arrays(arrays, cfg))


def _tokens(b, t, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def test_config_equals_reference():
    for ours, ref in ((get_config(ARCH), r_get_config(ARCH)),
                      (smoke_variant(get_config(ARCH)),
                       r_base.smoke_variant(r_get_config(ARCH)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert (ours.padded_vocab, ours.num_periods, ours.resolved_head_dim) \
            == (ref.padded_vocab, ref.num_periods, ref.resolved_head_dim)
    assert ARCH in registered()
    full = get_config(ARCH)
    assert [(s.mixer, s.ffn) for s in full.layer_pattern] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]
    assert (full.mamba.version, full.mamba.d_inner(4096),
            p_mamba.dt_rank(4096)) == (1, 8192, 256)
    assert round(full.param_counts()["total"] / 1e9, 2) == 51.46
    assert round(one_period(full).param_counts()["total"] / 1e9, 2) == 13.27


# --------------------------------------------------------------------------
# one Mamba-1 layer
# --------------------------------------------------------------------------

def _layer(w, sub=0):
    """Sub-layer ``sub``'s Mamba leaves (period 0) for the reference and the
    port's module."""
    p = {n: jnp.asarray(a[0])
         for n, a in w["arrays"]["blocks"]["sub%d" % sub]["mamba"].items()}
    return p, w["model"].blocks[sub].mamba


@pytest.mark.parametrize("t,tail", [(7, False), (2, True)])
def test_causal_conv_at_mamba1_width(t, tail):
    di = _world()["cfg"].mamba.d_inner(64)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, di)).astype(np.float32)
    w = rng.standard_normal((4, di)).astype(np.float32)
    b = rng.standard_normal(di).astype(np.float32)
    tl = rng.standard_normal((2, 3, di)).astype(np.float32) if tail else None
    got = p_mamba._causal_conv(*(None if a is None else torch.from_numpy(a)
                                 for a in (x, w, b, tl)))
    want = r_mamba._causal_conv(*(None if a is None else jnp.asarray(a)
                                  for a in (x, w, b, tl)))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


@functools.lru_cache(maxsize=None)
def _r_mamba1(rcfg):
    return jax.jit(functools.partial(r_mamba.mamba1_forward, cfg=rcfg))


def test_mamba1_forward_matches_reference():
    """No cache; a cached prefill of 9 tokens from a nonzero conv tail and
    SSM state; then two one-token steps: outputs, and the cache the port
    writes in place against the reference's."""
    w = _world()
    cfg, rcfg = w["cfg"], w["rcfg"]
    p, ours = _layer(w)
    assert ours.version == 1 and not hasattr(ours, "norm_w")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    got, none = p_mamba.mamba1_forward(ours, cfg, torch.from_numpy(x))
    want, _ = _r_mamba1(rcfg)(p, x=jnp.asarray(x))
    assert none is None and got.shape == (2, 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    rc = r_mamba.mamba_cache_shape(rcfg, 2, jnp.float32)
    rc = {k: jnp.asarray(0.5 * rng.standard_normal(v.shape).astype(np.float32))
          for k, v in rc.items()}
    pc = {k: torch.from_numpy(np.array(v)) for k, v in rc.items()}
    assert tuple(pc["conv"].shape) == (2, 3, 128)
    assert tuple(pc["ssm"].shape) == (2, 128, 16)
    ssm = pc["ssm"]
    for t in (9, 1, 1):
        x = rng.standard_normal((2, t, 64)).astype(np.float32)
        got, new = p_mamba.mamba_forward(ours, cfg, torch.from_numpy(x), pc)
        want, rc = _r_mamba1(rcfg)(p, x=jnp.asarray(x), cache=rc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert new["ssm"] is ssm                 # written in place
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                       **TOL)


@pytest.mark.parametrize("cached", [False, True])
def test_chunked_scan_equals_one_chunk(cached):
    """SCAN_BYTES cut to chunks of 3 steps: the same outputs and final
    state as one chunk over all 13, and no chunk of the scan longer than
    ``scan_chunk``."""
    w = _world()
    cfg, (_, ours) = w["cfg"], _layer(w, 2)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 13, 64)).astype(np.float32))
    state = 0.5 * rng.standard_normal((2, 128, 16)).astype(np.float32)

    def run():
        cache = None
        if cached:
            cache = p_mamba.mamba_cache_shape(cfg, 2, torch.float32)
            cache["ssm"].copy_(torch.from_numpy(state))
        out, _ = p_mamba.mamba1_forward(ours, cfg, x, cache)
        return out, cache and cache["ssm"].clone()

    lengths = []
    scan = p_mamba._scan_

    def spy(a, h):
        lengths.append(a.shape[1])
        scan(a, h)

    whole, whole_state = run()
    assert p_mamba.scan_chunk(2, 128, 16) >= 13
    with mock.patch.object(p_mamba, "SCAN_BYTES",
                           3 * p_mamba.SCAN_LIVE * 4 * 2 * 128 * 16), \
            mock.patch.object(p_mamba, "_scan_", spy):
        assert p_mamba.scan_chunk(2, 128, 16) == 3
        chunked, chunked_state = run()
    assert lengths == [3, 3, 3, 3, 1]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), **TOL)
    if cached:
        np.testing.assert_allclose(chunked_state.numpy(),
                                   whole_state.numpy(), **TOL)


# --------------------------------------------------------------------------
# the hybrid stack
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _r_forward(rcfg, dropless):
    return jax.jit(functools.partial(r_lm.forward, cfg=rcfg, impl="xla",
                                     dropless=dropless))


@functools.lru_cache(maxsize=None)
def _r_decode(rcfg):
    return jax.jit(functools.partial(r_lm.decode_step, cfg=rcfg, impl="xla"))


@pytest.mark.parametrize("dropless", [False, True])
def test_forward_matches_reference(dropless):
    w = _world()
    toks = _tokens(2, 20, 3)
    got = p_lm.forward(w["model"], torch.from_numpy(toks), dropless=dropless)
    want, _ = _r_forward(w["rcfg"], dropless)(w["rparams"], batch={
        "tokens": jnp.asarray(toks)})
    assert got.shape == (2, 20, w["cfg"].padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _stack_of(cfg, sub, period):
    """The port's cache index of the reference's ``sub%d`` at ``period``."""
    return p_lm.cache_slots(cfg)[period * cfg.period + sub]


def test_decode_step_matches_reference_and_forward():
    """A 9-token prefill, then three one-token steps: logits against the
    reference's ``decode_step`` and the port's own dropless ``forward``,
    and every sub-layer's cache against the reference's."""
    w = _world()
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    toks = _tokens(2, 12, 4)
    pc = p_lm.init_cache(cfg, 2, 16, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, 16)
    got, start = [], 0
    for t in (9, 1, 1, 1):
        chunk = toks[:, start:start + t]
        out = p_lm.decode_step(model, torch.from_numpy(chunk), pc)
        want, rc = _r_decode(rcfg)(w["rparams"], batch={
            "tokens": jnp.asarray(chunk)}, caches=rc, pos=jnp.int32(start))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
        got.append(out)
        start += t
        assert pc["len"] == start
    whole = p_lm.forward(model, torch.from_numpy(toks), dropless=True)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), whole.numpy(),
                               **TOL)
    for i, spec in enumerate(cfg.layer_pattern):
        kind, j = _stack_of(cfg, i, 0)
        assert kind == spec.mixer
        names = ("conv", "ssm") if kind == "mamba" else ("k", "v")
        for n in names:
            ref = np.asarray(rc["sub%d" % i][kind][n])[0]
            if kind == "attn":                  # [B, S, Hk, D] -> heads first
                ref = ref.transpose(0, 2, 1, 3)
            np.testing.assert_allclose(pc[n][j].numpy(), ref, **TOL)


def test_generate_matches_reference():
    """Equal greedy ids, and the teacher-forced logits of the prefill and
    every step."""
    w = _world()
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    prompt, max_new, max_len = _tokens(2, 7, 8), 5, 12
    got = p_serve.generate(model, prompt, max_new, max_len=max_len,
                           device="cpu")
    with mock.patch.object(r_serve, "make_serve_fns", _jitted_serve_fns):
        want = r_serve.generate(w["rparams"], rcfg, jnp.asarray(prompt),
                                max_new, max_len=max_len, impl="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    step = p_serve.make_serve_fns(model)[1]
    r_prefill, r_step = _jitted_serve_fns(rcfg, max_len)
    pc = p_lm.init_cache(cfg, 2, max_len, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, max_len)
    ours = step(torch.from_numpy(prompt), pc)
    ref, rc = r_prefill(w["rparams"], {"tokens": jnp.asarray(prompt)}, rc)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    ids = np.asarray(want)
    for i in range(max_new - 1):
        tok = ids[:, i:i + 1].copy()
        ours = step(torch.from_numpy(tok), pc)
        ref, rc = r_step(w["rparams"], {"tokens": jnp.asarray(tok)}, rc,
                         jnp.int32(7 + i))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_seq", [False, True])
def test_hybrid_cache_holds_both_kinds(per_seq):
    """Keys and values stacked over the attention layer, conv tails and
    SSM states over the seven Mamba layers, each in the reference's
    shapes (keys heads first), and one length the attention views share."""
    w = _world()
    cfg = w["cfg"]
    pc = p_lm.init_cache(cfg, 3, 11, device="cpu", per_seq=per_seq)
    rc = r_lm.init_cache(w["rcfg"], 3, 11, per_seq=per_seq)
    assert set(pc) == {"k", "v", "conv", "ssm", "len"}
    assert p_lm.cache_slots(cfg) == [("mamba", 0), ("mamba", 1),
                                     ("mamba", 2), ("mamba", 3), ("attn", 0),
                                     ("mamba", 4), ("mamba", 5), ("mamba", 6)]
    for n in ("k", "v"):
        ref = rc["sub4"]["attn"][n]
        assert tuple(pc[n].shape) == (1, 3, 2, 11, 16)
        assert tuple(pc[n].transpose(2, 3).shape) == ref.shape
    for n in ("conv", "ssm"):
        assert tuple(pc[n].shape) == (7,) + rc["sub0"]["mamba"][n].shape[1:]
        assert pc[n].dtype == torch.float32 and not bool(pc[n].any())
    if per_seq:
        assert pc["len"].dtype == torch.int32 and pc["len"].tolist() == [0] * 3
    else:
        assert pc["len"] == 0
    views = [p_lm._layer_cache(pc, kind, i) for kind, i in
             p_lm.cache_slots(cfg)]
    assert set(views[4]) == {"k", "v", "len"} and views[4]["len"] is pc["len"]
    assert all(set(v) == {"conv", "ssm"} for v in views[:4] + views[5:])
    assert views[5]["ssm"].data_ptr() == pc["ssm"][4].data_ptr()


def test_params_carry_every_leaf():
    """Every reference leaf lands on layer ``period * 8 + sub`` (Mamba-1's
    leaves and the FFN of a Mamba layer, dense and MoE, included), and the
    port's own init builds the same tree with Mamba-1's float32 leaves."""
    w = _world()
    cfg, state = w["cfg"], w["model"].state_dict()
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(w["arrays"]):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            sub = int(keys[1][3:])
            for i in range(cfg.num_periods):
                name = ".".join(["blocks", str(i * cfg.period + sub)]
                                + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), a[i])
                seen.add(name)
        else:
            np.testing.assert_array_equal(state[keys[0]].numpy(), a)
            seen.add(keys[0])
    assert seen == set(state)
    assert {n.split(".")[-1] for n in seen if ".mamba." in n} == set(
        p_mamba.LEAVES[1])
    blocks = w["model"].blocks
    assert blocks[0].mlp is not None and blocks[1].moe is not None
    assert blocks[0].nf is not None and blocks[4].attn is not None
    ours = p_lm.init_model(dataclasses.replace(cfg, dtype="bfloat16"),
                           torch.Generator().manual_seed(0), device="cpu")
    assert set(ours.state_dict()) == set(state)
    for name, t in ours.state_dict().items():
        leaf = name.split(".")[-1]
        f32 = leaf in p_mamba.FLOAT32_LEAVES or leaf == "router"
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name


def test_init_mamba1_draws_the_reference_distributions():
    """Jamba's Mamba-1 leaves at d_model 512: projections normal /
    sqrt(fan_in), conv_w 0.5, A_log, dt_bias, conv_b 0, D 1."""
    cfg = dataclasses.replace(get_config(ARCH), d_model=512)
    m = p_mamba.init_mamba(cfg, torch.Generator().manual_seed(0), "cpu",
                           torch.float32)
    shapes = {n: tuple(getattr(m, n).shape) for n in p_mamba.LEAVES[1]}
    assert shapes == {"in_proj": (512, 2048), "conv_w": (4, 1024),
                      "conv_b": (1024,), "x_proj": (1024, 32 + 32),
                      "dt_proj": (32, 1024), "dt_bias": (1024,),
                      "A_log": (1024, 16), "D": (1024,),
                      "out_proj": (1024, 512)}
    for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        w_ = getattr(m, name)
        assert abs(float(w_.std()) * w_.shape[0] ** 0.5 - 1) < 0.03, name
    assert abs(float(m.conv_w.std()) - 0.5) < 0.03
    assert not bool(m.A_log.any() or m.dt_bias.any() or m.conv_b.any())
    assert bool((m.D == 1).all())
    with pytest.raises(ValueError, match="takes 9 tensors"):
        p_mamba.Mamba(m.in_proj, version=1)
