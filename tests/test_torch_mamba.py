"""PyTorch port vs the JAX reference: Mamba-2 (mamba2-130m) at the
reference's smoke size (``smoke_variant``: 2 layers, d_model 64, 8 heads
of 16, d_state 16, float32, on the CPU).

The same parameters (numpy, from a seed, in the reference's nested
layout) and token ids feed both packages:

* the configuration, ``param_counts``, the registry, the error of a
  Mamba layer without a ``MambaConfig``, and Mamba-1 and hybrid patterns
  building (``tests/test_torch_jamba.py`` holds them to the reference);
* ``_causal_conv`` with and without a tail, T below K-1 included;
* ``mamba2_forward`` in its three branches (no cache, a cached prefill
  from a nonzero state, one token), the cache it leaves included;
* ``forward`` against ``lm.forward(impl="pallas")`` (the SSD kernel in
  interpret mode) and ``impl="xla"``;
* ``generate`` against ``generate(impl="xla")``: equal token ids, and
  teacher-forced logits of the prefill and every step;
* ``lm_params_from_arrays`` on every Mamba leaf and its dtypes.

Tolerance: 2e-4 absolute and relative on logits, 2e-5 on single layers
(float32 sums in another order; the chunked scan against the reference's
step-by-step prefill).
"""
import dataclasses

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
from repro_torch.configs import base as p_base
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.models import lm as p_lm
from repro_torch.models import mamba as p_mamba
from repro_torch.serve import lm as p_serve
from test_torch_batcher import one_torch_thread  # noqa: F401

ARCH = "mamba2-130m"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def cfg():
    return smoke_variant(get_config(ARCH))


@pytest.fixture(scope="module")
def rcfg():
    return r_base.smoke_variant(r_get_config(ARCH))


@pytest.fixture(scope="module")
def arrays(rcfg):
    """Reference-layout parameters as numpy, every leaf away from its init
    constant so that each matters: projections normal / sqrt(fan_in), the
    embedding 0.5, conv_w 0.5 normal, norms and D 1 + 0.1 normal, conv_b,
    A_log and dt_bias 0.1 normal."""
    params, _ = r_lm.init_model(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(0)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            x = 0.5 * rng.standard_normal(a.shape)
        elif any(n in name for n in ("'nm'", "final_norm", "'norm_w'", "'D'")):
            x = 1 + 0.1 * rng.standard_normal(a.shape)
        elif any(n in name for n in ("'conv_b'", "'A_log'", "'dt_bias'")):
            x = 0.1 * rng.standard_normal(a.shape)
        elif "'conv_w'" in name:
            x = 0.5 * rng.standard_normal(a.shape)
        else:
            x = rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


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


def _layer0(arrays):
    return {n: a[0] for n, a in arrays["blocks"]["sub0"]["mamba"].items()}


# --------------------------------------------------------------------------
# configuration
# --------------------------------------------------------------------------

def test_config_equals_reference():
    for ours, ref in ((get_config(ARCH), r_get_config(ARCH)),
                      (smoke_variant(get_config(ARCH)),
                       r_base.smoke_variant(r_get_config(ARCH)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert ours.padded_vocab == ref.padded_vocab
        assert ours.mamba.nheads(ours.d_model) == ref.mamba.nheads(ref.d_model)
    assert registered() == ("deepseek-v2-236b", "h2o-danube-1.8b",
                            "jamba-v0.1-52b", "mamba2-130m", "minicpm3-4b",
                            "mixtral-8x22b", "olmo-1b", "qwen2-1.5b")
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.padded_vocab) == (24, 768,
                                                                  50432)
    assert (full.mamba.d_inner(768), full.mamba.nheads(768)) == (1536, 24)
    assert round(full.param_counts()["total"] / 1e6, 2) == 128.92
    small = smoke_variant(full)
    assert (small.num_layers, small.d_model, small.mamba.nheads(64),
            small.mamba.headdim, small.mamba.d_state) == (2, 64, 8, 16, 16)


def test_mamba1_and_a_missing_mamba_config_raise(cfg):
    """A Mamba layer without a ``MambaConfig`` raises; Mamba-1 (Jamba's)
    and hybrid patterns, which raised before they were ported, now build,
    with their caches."""
    assert get_config("jamba-v0.1-52b").mamba.version == 1
    v1 = dataclasses.replace(cfg, mamba=p_base.MambaConfig(
        version=1, d_state=16, d_conv=4, expand=2))
    hybrid = dataclasses.replace(cfg, layer_pattern=(
        p_base.LayerSpec("attn", "dense"), p_base.LayerSpec("mamba", None)))
    for c in (v1, hybrid):
        p_lm.check_supported(c)
        m = p_lm.init_model(c, torch.Generator().manual_seed(0), device="cpu")
        cache = p_lm.init_cache(c, 1, 8, device="cpu")
        assert m.blocks[1].mamba.version == c.mamba.version
        assert cache["ssm"].shape[0] == (2 if c is v1 else 1)
    assert m.blocks[0].mlp is not None and "k" in cache
    with pytest.raises(ValueError, match="no MambaConfig"):
        p_lm.check_supported(dataclasses.replace(cfg, mamba=None))
    with pytest.raises(ValueError, match="no Mamba-3"):
        p_lm.check_supported(dataclasses.replace(
            cfg, mamba=p_base.MambaConfig(version=3)))


def test_init_model_and_cache_shapes():
    """The reference's distributions at the full width's fan-ins, and the
    cache: conv tails in the model dtype, SSM states in float32."""
    full = dataclasses.replace(get_config(ARCH), num_layers=2)
    m = p_lm.init_model(full, torch.Generator().manual_seed(0), device="cpu")
    mx = m.blocks[0].mamba
    assert mx.in_proj.shape == (768, 2 * 1536 + 2 * 128 + 24)
    assert mx.in_proj.dtype == torch.bfloat16 and mx.A_log.dtype == torch.float32
    assert abs(float(mx.in_proj.float().std()) - 1 / np.sqrt(768)) < 0.002
    assert abs(float(mx.conv_w.float().std()) - 0.5) < 0.02
    assert torch.all(mx.A_log == 0) and torch.all(mx.D == 1)
    assert torch.all(mx.dt_bias == 0) and torch.all(mx.conv_b == 0)
    assert not hasattr(m.blocks[0], "nf") and m.blocks[0].mlp is None
    cache = p_lm.init_cache(full, 3, 99, device="cpu")
    assert cache["conv"].shape == (2, 3, 3, 1536 + 2 * 128)
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].shape == (2, 3, 24, 128, 64)
    assert cache["ssm"].dtype == torch.float32 and cache["len"] == 0
    # per-sequence lanes: the reference's conv and SSM shapes (its Mamba
    # caches hold no length), one int32 length a lane
    lanes = p_lm.init_cache(full, 3, 99, device="cpu", per_seq=True)
    ref = r_lm.init_cache(r_base.smoke_variant(r_get_config(ARCH)), 3, 99,
                          per_seq=True)["sub0"]["mamba"]
    small = p_lm.init_cache(smoke_variant(full), 3, 99, device="cpu",
                            per_seq=True)
    assert set(ref) == {"conv", "ssm"}
    for k in ("conv", "ssm"):
        assert tuple(small[k].shape) == ref[k].shape
        assert lanes[k].shape == cache[k].shape
    assert lanes["len"].dtype == torch.int32 and lanes["len"].tolist() == [0] * 3


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t,tail", [(7, False), (7, True), (2, True),
                                    (1, True)])
def test_causal_conv_matches_reference(t, tail):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    tl = rng.standard_normal((2, 3, 24)).astype(np.float32) if tail else None
    got = p_mamba._causal_conv(*(None if a is None else torch.from_numpy(a)
                                 for a in (x, w, b, tl)))
    want = r_mamba._causal_conv(*(None if a is None else jnp.asarray(a)
                                  for a in (x, w, b, tl)))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_np(g_), np.asarray(w_), **LAYER_TOL)


def test_mamba2_forward_matches_reference(arrays, cfg, rcfg, model):
    """No cache (against the reference's impl pallas and xla), a cached
    prefill of 9 tokens from a nonzero cache, then two one-token steps;
    the cache the port writes in place against the reference's."""
    p = {n: jnp.asarray(a) for n, a in _layer0(arrays).items()}
    ours = model.blocks[0].mamba
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    got, none = p_mamba.mamba2_forward(ours, cfg, torch.from_numpy(x))
    assert none is None
    for impl in ("pallas", "xla"):
        want, _ = r_mamba.mamba2_forward(p, rcfg, jnp.asarray(x), impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)

    rc = r_mamba.mamba_cache_shape(rcfg, 2, jnp.float32)
    rc = {k: jnp.asarray(0.5 * rng.standard_normal(v.shape).astype(np.float32))
          for k, v in rc.items()}
    pc = {k: torch.from_numpy(np.array(v)) for k, v in rc.items()}
    ssm = pc["ssm"]
    for t in (9, 1, 1):
        x = rng.standard_normal((2, t, 64)).astype(np.float32)
        got, new = p_mamba.mamba2_forward(ours, cfg, torch.from_numpy(x), pc)
        want, rc = r_mamba.mamba2_forward(p, rcfg, jnp.asarray(x), rc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
        assert new["ssm"] is ssm                 # written in place
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(pc[k]), np.asarray(rc[k]),
                                       **LAYER_TOL)


# --------------------------------------------------------------------------
# the model and generation
# --------------------------------------------------------------------------

def test_forward_matches_reference(model, rparams, rcfg):
    toks = _tokens(2, 40, 3)
    got = p_lm.forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 40, rcfg.padded_vocab)
    for impl in ("pallas", "xla"):
        want, _ = r_lm.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)},
                               impl=impl)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


def test_generate_matches_reference(model, rparams, cfg, rcfg):
    prompt, max_new = _tokens(2, 9, 6), 6
    got = p_serve.generate(model, prompt, max_new, device="cpu")
    want = r_serve.generate(rparams, rcfg, jnp.asarray(prompt), max_new,
                            impl="xla")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))

    # teacher-forced logits: both sides fed the same ids at every step
    max_len = 9 + max_new
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
                         jnp.int32(9 + i))
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **LOGIT_TOL)
    assert pc["len"] == 9 + max_new - 1
    np.testing.assert_allclose(_np(pc["ssm"]),
                               np.asarray(rc["sub0"]["mamba"]["ssm"]),
                               **LOGIT_TOL)
    with pytest.raises(ValueError, match="cannot hold"):
        p_serve.generate(model, prompt, max_new, max_len=9, device="cpu")


# --------------------------------------------------------------------------
# interop
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
    assert {n.split(".")[-1] for n in seen if ".mamba." in n} == set(
        p_mamba.LEAVES[2])

    bf16 = interop.lm_params_from_arrays(
        arrays, dataclasses.replace(cfg, dtype="bfloat16"))
    for name, t in bf16.state_dict().items():
        f32 = name.split(".")[-1] in p_mamba.FLOAT32_LEAVES
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
