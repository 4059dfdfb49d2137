"""PyTorch port vs the JAX reference: Qwen2-1.5B generation at the
reference's smoke size (``smoke_variant``, float32, on the CPU), and the
dense stacks H2O-Danube-1.8B (sliding window, head dim 80 at full width)
and OLMo-1B (non-parametric LayerNorm, tied head).

The same parameters (numpy, from a seed, in the reference's nested
layout) and token ids feed both packages:

* the configuration, ``param_counts`` and the registry;
* ``rms_norm``, ``apply_rope``, ``dense``, the MLP and ``gqa_forward``
  with and without a cache;
* ``forward`` against ``lm.forward(impl="pallas")`` and ``impl="xla"``;
* ``decode_step`` (one token) against ``decode_step(impl="pallas")``;
* ``generate`` against ``generate(impl="xla")``: equal token ids, and
  teacher-forced logits of the prefill and every step;
* ``lm_params_from_arrays`` on every leaf; the device checks and the
  errors of what is not ported; and that no module of the port (nor
  ``chip_smoke.py``) imports JAX or the JAX package;
* for danube and olmo: the configuration and ``param_counts`` field for
  field, ``layer_norm_nonparam``, ``forward`` (danube across its smoke
  window of 16), ``decode_step`` and ``lm_params_from_arrays``.

The reference's ``generate(impl="pallas")`` is never called: its prefill
runs inside a ``fori_loop``, where ``attention.py`` calls ``int()`` on the
traced cache length.  Tolerance: 2e-4 absolute and relative on logits
(``tests/test_decode_attention_kernel.py``), 2e-5 on single layers:
float32 sums taken in another order.
"""
import ast
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.models import mlp as r_mlp
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import base as p_base
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.models import attention as p_attn
from repro_torch.models import common as p_common
from repro_torch.models import lm as p_lm
from repro_torch.models.mlp import MLP
from repro_torch.serve import lm as p_serve
from test_torch_batcher import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def cfg():
    return smoke_variant(get_config("qwen2-1.5b"))


@pytest.fixture(scope="module")
def rcfg():
    return r_base.smoke_variant(r_get_config("qwen2-1.5b"))


def _arrays(rcfg, seed=0):
    """Reference-layout parameters as numpy: weights normal / sqrt(fan_in),
    the embedding 0.5, norms 1 + 0.1 normal, biases 0.1 normal (so every
    leaf matters)."""
    params, _ = r_lm.init_model(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        shape = a.shape
        if "embed" in name:
            x = 0.5 * rng.standard_normal(shape)
        elif any(n in name for n in ("'nm'", "'nf'", "final_norm")):
            x = 1 + 0.1 * rng.standard_normal(shape)
        elif any(n in name for n in ("'bq'", "'bk'", "'bv'")):
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = rng.standard_normal(shape) / np.sqrt(shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def arrays(rcfg):
    return _arrays(rcfg)


@pytest.fixture(scope="module")
def rparams(arrays):
    return jax.tree.map(jnp.asarray, arrays)


@pytest.fixture(scope="module")
def model(arrays, cfg):
    return interop.lm_params_from_arrays(arrays, cfg)


def _tokens(b, t, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(
        np.int32)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def test_config_equals_reference():
    for ours, ref in ((get_config("qwen2-1.5b"), r_get_config("qwen2-1.5b")),
                      (smoke_variant(get_config("qwen2-1.5b")),
                       r_base.smoke_variant(r_get_config("qwen2-1.5b")))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert (ours.padded_vocab, ours.num_periods, ours.resolved_head_dim) \
            == (ref.padded_vocab, ref.num_periods, ref.resolved_head_dim)
    assert registered() == ("deepseek-v2-236b", "h2o-danube-1.8b",
                            "jamba-v0.1-52b", "mamba2-130m", "minicpm3-4b",
                            "mixtral-8x22b", "olmo-1b", "qwen2-1.5b")
    full = get_config("qwen2-1.5b")
    assert full.padded_vocab == 152064
    assert round(full.param_counts()["total"] / 1e9, 2) == 1.54


@pytest.mark.parametrize("arch", sorted(p_base.NOT_PORTED))
def test_other_archs_name_their_roadmap_item(arch):
    assert arch in r_base.registered()
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md queue 1: %s" % p_base.NOT_PORTED[arch]):
        get_config(arch)


def test_unported_model_features_raise(cfg, rcfg):
    # per-sequence caches are ported: the reference's shapes, int32 lengths
    ours = p_lm.init_cache(cfg, 2, 8, device="cpu", per_seq=True)
    ref = r_lm.init_cache(rcfg, 2, 8, per_seq=True)["sub0"]["attn"]
    assert ours["len"].dtype == torch.int32 and ours["len"].tolist() == [0, 0]
    assert ref["len"].shape == (cfg.num_layers, 2)
    assert tuple(ours["k"].transpose(2, 3).shape) == ref["k"].shape
    # MLA is ported (tests/test_torch_mla.py); M-RoPE is not
    mrope = dataclasses.replace(cfg, mrope_sections=(2, 3, 3))
    with pytest.raises(NotImplementedError, match="Other LM architectures"):
        p_lm.init_model(mrope, device="cpu")
    # MoE (tests/test_torch_moe.py) and hybrid patterns
    # (tests/test_torch_jamba.py) are ported
    hybrid = dataclasses.replace(
        cfg, moe=p_base.MoEConfig(4, 2, 64), mamba=p_base.MambaConfig(),
        layer_pattern=(p_base.LayerSpec("attn", "moe"),
                       p_base.LayerSpec("mamba", "dense")))
    m = p_lm.init_model(hybrid, device="cpu")
    assert m.blocks[0].moe is not None and m.blocks[1].mlp is not None
    # a Mamba pattern: Mamba-1 is ported; no MambaConfig is an error
    mamba = dataclasses.replace(
        cfg, layer_pattern=(p_base.LayerSpec("mamba", None),),
        mamba=p_base.MambaConfig(version=1, d_state=16, expand=2))
    assert p_lm.init_model(mamba, device="cpu").blocks[0].mamba.version == 1
    with pytest.raises(ValueError, match="no MambaConfig"):
        p_lm.init_model(dataclasses.replace(mamba, mamba=None), device="cpu")
    # a mixer of neither kind
    other = dataclasses.replace(
        cfg, layer_pattern=(p_base.LayerSpec("conv", None),))
    with pytest.raises(NotImplementedError, match="Other LM architectures"):
        p_lm.init_model(other, device="cpu")


def test_entry_points_default_to_the_card(cfg, model):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CPU-only refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_lm.init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_serve.generate(model, _tokens(1, 4, 0), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_lm.init_cache(cfg, 1, 8)


def test_init_model_distributions():
    """The reference's distributions at the full width's fan-ins: weights
    normal / sqrt(fan_in), the embedding 0.02, norms 1, biases 0."""
    small = dataclasses.replace(smoke_variant(get_config("qwen2-1.5b")),
                                d_model=256, d_ff=512, vocab_size=1000)
    gen = torch.Generator().manual_seed(0)
    m = p_lm.init_model(small, gen, device="cpu")
    assert m.embed.shape == (1024, 256)
    assert abs(float(m.embed.std()) - 0.02) < 0.001
    blk = m.blocks[0]
    assert abs(float(blk.attn.wq.std()) - 1 / 16) < 0.003
    assert abs(float(blk.mlp.wo.std()) - 1 / np.sqrt(512)) < 0.002
    assert torch.all(blk.nm == 1) and torch.all(blk.attn.bk == 0)
    assert m.lm_head is None and len(m.blocks) == small.num_layers
    logits = p_lm.forward(m, torch.tensor([[1, 2, 999]]))
    assert torch.all(logits[..., 1000:] == -1e30)
    assert torch.all(logits[..., :1000].abs() < 1e3)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_norm_rope_dense_mlp_match_reference(arrays):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(p_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w))),
        np.asarray(r_common.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        **LAYER_TOL)
    xr = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.tile(np.arange(5, 12), (2, 1)).astype(np.int32)
    np.testing.assert_allclose(
        _np(p_common.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos),
                                1e6)),
        np.asarray(r_common.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                       1e6)), **LAYER_TOL)
    wd = rng.standard_normal((64, 24)).astype(np.float32)
    bd = rng.standard_normal(24).astype(np.float32)
    np.testing.assert_allclose(
        _np(p_common.dense(torch.from_numpy(x), torch.from_numpy(wd),
                           torch.from_numpy(bd))),
        np.asarray(r_common.dense(jnp.asarray(x), jnp.asarray(wd),
                                  jnp.asarray(bd))), **LAYER_TOL)
    mlp = {n: a[0] for n, a in arrays["blocks"]["sub0"]["mlp"].items()}
    ours = MLP(*(torch.from_numpy(mlp[n]) for n in ("wi", "wg", "wo")))
    np.testing.assert_allclose(
        _np(ours(torch.from_numpy(x))),
        np.asarray(r_mlp.mlp_forward(jax.tree.map(jnp.asarray, mlp),
                                     jnp.asarray(x))), **LAYER_TOL)


def test_gqa_forward_matches_reference(arrays, cfg, rcfg, model):
    """No cache; a cached prefill at length 0, a second chunk at length 5
    (flash attention with q_offset 5) and a one-token step (decode
    attention), each against the reference with the same cache contents."""
    at = {n: jnp.asarray(a[0]) for n, a in
          arrays["blocks"]["sub0"]["attn"].items()}
    ours = model.blocks[0].attn
    rng = np.random.default_rng(2)
    b, s = 2, 16

    def pos(start, t):
        return np.tile(np.arange(start, start + t), (b, 1)).astype(np.int32)

    x = rng.standard_normal((b, 5, 64)).astype(np.float32)
    got, _ = p_attn.gqa_forward(ours, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos(0, 5)))
    for impl in ("xla", "pallas"):
        want, _ = r_attn.gqa_forward(at, rcfg, jnp.asarray(x),
                                     jnp.asarray(pos(0, 5)), impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)

    pc = p_attn.gqa_cache_shape(cfg, b, s, torch.float32)
    rc = r_attn.gqa_cache_shape(rcfg, b, s, jnp.float32)
    start = 0
    for t in (5, 3, 1):
        x = rng.standard_normal((b, t, 64)).astype(np.float32)
        got, pc = p_attn.gqa_forward(ours, cfg, torch.from_numpy(x),
                                     torch.from_numpy(pos(start, t)), pc)
        impl = "pallas" if t == 1 else "xla"
        want, rc = r_attn.gqa_forward(at, rcfg, jnp.asarray(x),
                                      jnp.asarray(pos(start, t)), rc,
                                      impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
        start += t
        assert pc["len"] == int(rc["len"]) == start
        np.testing.assert_allclose(_np(pc["k"]).transpose(0, 2, 1, 3),
                                   np.asarray(rc["k"]), **LAYER_TOL)
        np.testing.assert_allclose(_np(pc["v"]).transpose(0, 2, 1, 3),
                                   np.asarray(rc["v"]), **LAYER_TOL)


# --------------------------------------------------------------------------
# the model and generation
# --------------------------------------------------------------------------

def test_forward_matches_reference(model, rparams, rcfg):
    toks = _tokens(2, 12, 3)
    got = p_lm.forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 12, rcfg.padded_vocab)
    for impl in ("pallas", "xla"):
        want, _ = r_lm.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                               impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def test_decode_step_matches_reference(model, rparams, cfg, rcfg):
    """A 4-token prefill, then one token through decode attention, as
    ``tests/test_decode_attention_kernel.py`` drives the reference."""
    warm, toks = _tokens(2, 4, 4), _tokens(2, 1, 5)
    pc = p_lm.init_cache(cfg, 2, 32, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, 32)
    got0 = p_lm.decode_step(model, torch.from_numpy(warm), pc)
    want0, rc = r_lm.decode_step(rparams, rcfg, {"tokens": jnp.asarray(warm)},
                                 rc, jnp.int32(0))
    np.testing.assert_allclose(_np(got0), np.asarray(want0), **LOGIT_TOL)
    got = p_lm.decode_step(model, torch.from_numpy(toks), pc)
    want, rc = r_lm.decode_step(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                                rc, jnp.int32(4), impl="pallas")
    assert pc["len"] == 5
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
    last = p_lm.decode_step(model, torch.from_numpy(toks),
                            p_lm.init_cache(cfg, 2, 8, device="cpu"),
                            last_only=True)
    assert last.shape == (2, rcfg.padded_vocab)


def test_generate_matches_reference(model, rparams, cfg, rcfg):
    prompt, max_new, max_len = _tokens(2, 7, 6), 6, 16
    got = p_serve.generate(model, prompt, max_new, max_len=max_len,
                           device="cpu")
    want = r_serve.generate(rparams, rcfg, jnp.asarray(prompt), max_new,
                            max_len=max_len, impl="xla")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))

    # teacher-forced logits: both sides fed the same ids at every step
    prefill, step = p_serve.make_serve_fns(model)
    r_prefill, r_step = r_serve.make_serve_fns(rcfg, max_len, impl="xla")
    pc = p_lm.init_cache(cfg, 2, max_len, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, max_len)
    ours = prefill(torch.from_numpy(prompt), pc)
    ref, rc = r_prefill(rparams, {"tokens": jnp.asarray(prompt)}, rc)
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **LOGIT_TOL)
    ids = np.asarray(want)
    for i in range(max_new - 1):
        tok = ids[:, i:i + 1].copy()
        ours = step(torch.from_numpy(tok), pc)
        ref, rc = r_step(rparams, {"tokens": jnp.asarray(tok)}, rc,
                         jnp.int32(7 + i))
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **LOGIT_TOL)
    assert pc["len"] == 7 + max_new - 1


def test_greedy_and_sampled_tokens():
    logits = torch.tensor([[0.0, 2.0, 1.0], [5.0, -1.0, 4.9]])
    assert p_serve.greedy_token(logits).tolist() == [1, 0]
    assert torch.equal(p_serve.sample_token(logits, None, 0.0),
                       p_serve.greedy_token(logits))
    a = p_serve.sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    b = p_serve.sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b) and a.dtype == torch.int32


def test_generate_rejects_a_short_cache(model):
    with pytest.raises(ValueError, match="cannot hold"):
        p_serve.generate(model, _tokens(1, 6, 0), 4, max_len=8, device="cpu")


# --------------------------------------------------------------------------
# interop and the import boundary
# --------------------------------------------------------------------------

def test_lm_params_from_arrays_carries_every_leaf(arrays, model, cfg):
    state = model.state_dict()
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(arrays):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(cfg.num_layers):
                name = ".".join(["blocks", str(i)] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), a[i])
                seen.add(name)
        else:
            np.testing.assert_array_equal(state[keys[0]].numpy(), a)
            seen.add(keys[0])
    assert seen == set(state)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    for new in (("kernels", "ssd", "ops.py"), ("kernels", "ssd", "kernel.py"),
                ("kernels", "ssd", "ref.py"), ("models", "mamba.py"),
                ("configs", "mamba2_130m.py"), ("obs", "trace.py"),
                ("obs", "metrics.py"), ("obs", "report.py"),
                ("core", "faults.py"), ("core", "recovery.py"),
                ("serve", "engine.py"), ("serve", "batcher.py"),
                ("launch", "dscep_run.py"), ("launch", "mesh.py"),
                ("core", "kb_dist.py"), ("configs", "dscep.py"),
                ("launch", "serve.py"), ("configs", "h2o_danube_1_8b.py"),
                ("configs", "olmo_1b.py"), ("models", "moe.py"),
                ("configs", "mixtral_8x22b.py"), ("configs", "minicpm3_4b.py"),
                ("configs", "deepseek_v2_236b.py")):
        assert os.path.join(REPO, "src", "repro_torch", *new) in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


# --------------------------------------------------------------------------
# H2O-Danube-1.8B and OLMo-1B
# --------------------------------------------------------------------------

NEW_ARCHS = ("h2o-danube-1.8b", "olmo-1b")


@functools.lru_cache(maxsize=None)
def _new_arch(arch):
    rcfg = r_base.smoke_variant(r_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    arrays = _arrays(rcfg)
    return (cfg, rcfg, arrays, jax.tree.map(jnp.asarray, arrays),
            interop.lm_params_from_arrays(arrays, cfg))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_config_equals_reference(arch):
    for ours, ref in ((get_config(arch), r_get_config(arch)),
                      (smoke_variant(get_config(arch)),
                       r_base.smoke_variant(r_get_config(arch)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert (ours.padded_vocab, ours.num_periods, ours.resolved_head_dim) \
            == (ref.padded_vocab, ref.num_periods, ref.resolved_head_dim)
    full = get_config(arch)
    if arch == "h2o-danube-1.8b":
        assert (full.resolved_head_dim, full.swa_window) == (80, 4096)
        assert round(full.param_counts()["total"] / 1e9, 2) == 1.83
    else:
        assert full.norm == "layernorm_nonparam" and full.tie_embeddings
        assert round(full.param_counts()["total"] / 1e9, 2) == 1.18


def test_layer_norm_nonparam_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 7, 64)).astype(
        np.float32) * 3 + 1
    np.testing.assert_allclose(
        _np(p_common.layer_norm_nonparam(torch.from_numpy(x))),
        np.asarray(r_common.layer_norm_nonparam(jnp.asarray(x))),
        **LAYER_TOL)
    np.testing.assert_allclose(
        _np(p_common.apply_norm("layernorm_nonparam", torch.from_numpy(x),
                                None)),
        np.asarray(r_common.apply_norm("layernorm_nonparam", jnp.asarray(x),
                                       None)), **LAYER_TOL)
    with pytest.raises(ValueError):
        p_common.apply_norm("batchnorm", torch.from_numpy(x), None)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_forward_matches_reference(arch):
    """24 tokens: danube's smoke window of 16 masks the earliest keys."""
    cfg, rcfg, _, rparams, model = _new_arch(arch)
    toks = _tokens(2, 24, 7)
    got = p_lm.forward(model, torch.from_numpy(toks))
    for impl in ("pallas", "xla"):
        want, _ = r_lm.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                               impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_decode_step_matches_reference(arch):
    """An 18-token prefill, then two one-token steps (past danube's window:
    decode attention with a window) against the reference's."""
    cfg, rcfg, _, rparams, model = _new_arch(arch)
    pc = p_lm.init_cache(cfg, 2, 24, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, 24)
    start = 0
    for t, seed in ((18, 8), (1, 9), (1, 10)):
        toks = _tokens(2, t, seed)
        got = p_lm.decode_step(model, torch.from_numpy(toks), pc)
        want, rc = r_lm.decode_step(rparams, rcfg,
                                    {"tokens": jnp.asarray(toks)}, rc,
                                    jnp.int32(start))
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)
        start += t
        assert pc["len"] == start


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_arch_params_carry_every_leaf(arch):
    cfg, _, arrays, _, model = _new_arch(arch)
    state = model.state_dict()
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(arrays):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i in range(cfg.num_layers):
                name = ".".join(["blocks", str(i)] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), a[i])
                seen.add(name)
        else:
            np.testing.assert_array_equal(state[keys[0]].numpy(), a)
            seen.add(keys[0])
    assert seen == set(state)
    norms = {n for n in seen if n.split(".")[-1] in ("nm", "nf",
                                                    "final_norm")}
    assert bool(norms) == (arch != "olmo-1b")
    # the port's own init builds the same tree: no norm weights for olmo
    ours = p_lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert set(ours.state_dict()) == set(state)
