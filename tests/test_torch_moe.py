"""PyTorch port vs the JAX reference: the MoE FFN (``models/moe.py``) and
Mixtral-8x22B at the reference's smoke size (``smoke_variant``, float32,
on the CPU).

The same inputs and parameters (numpy, from a seed, in the reference's
nested layout) feed both packages:

* ``capacity``, ``topk_router`` and ``dispatch_group``: the expert
  selection ``sel`` and the kept slots equal exactly;
* ``moe_forward`` at float32: capacity mode with drops that happen,
  ``dropless``, ``dispatch_groups`` 1, 2, 4 and two that fall back to 1,
  shared experts, and a router with two equal columns (ties); ``sel`` and
  the kept slots exactly, ``y`` within ``LAYER_TOL``, aux within 1e-6;
  one bfloat16 case within ``BF16_TOL``;
* Mixtral's configuration and ``param_counts``; ``forward`` (capacity and
  dropless, aux too), ``decode_step``, decode against the port's own
  forward, ``generate`` ids, and the weight carry-over through
  ``interop.lm_params_from_arrays`` (the router float32 in a bfloat16
  model);
* a hand-made pattern ``((attn, dense), (attn, moe))``, a period of 2,
  through the same comparisons.

Every reference function is jitted once per shape (``impl="xla"``).
Tolerance: 2e-4 absolute and relative on logits, 2e-5 on one layer
(``test_torch_lm.py``).
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
from repro.models import moe as r_moe
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import base as p_base
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.models import lm as p_lm
from repro_torch.models import moe as p_moe
from repro_torch.models.mlp import MLP
from repro_torch.serve import lm as p_serve
from test_torch_batcher import (  # noqa: F401
    _draw, _jitted_serve_fns, one_torch_thread)

ARCH = "mixtral-8x22b"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
AUX_TOL = 1e-6
# bfloat16 sums in another order: one rounding of the output is 2^-8
# relative, the products and the combine add a few
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D, E, F_EXP, K = 64, 4, 64, 2
B, T = 2, 16                          # 32 tokens a call


# --------------------------------------------------------------------------
# one MoE layer
# --------------------------------------------------------------------------

def _layer(seed, num_shared=0, ties=False):
    """Reference-layout MoE weights as numpy: projections normal /
    sqrt(fan_in), the router normal / sqrt(d) (with ``ties`` its column 1
    a copy of column 0, scaled up so that the tied pair often leads)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    p = {"router": w(D, E), "wi": w(E, D, F_EXP), "wg": w(E, D, F_EXP),
         "wo": w(E, F_EXP, D)}
    if ties:
        p["router"][:, 0] *= 3
        p["router"][:, 1] = p["router"][:, 0]
    if num_shared:
        width = 32 * num_shared
        p["shared"] = {"wi": w(D, width), "wg": w(D, width),
                       "wo": w(width, D)}
    return p


def _port_moe(p, dtype=torch.float32):
    def t(a, dt=dtype):
        return torch.from_numpy(np.array(a)).to(dt)

    shared = (MLP(*(t(p["shared"][n]) for n in ("wi", "wg", "wo")))
              if "shared" in p else None)
    return p_moe.MoE(t(p["router"], torch.float32),
                     *(t(p[n]) for n in ("wi", "wg", "wo")), shared)


def _mo(num_shared=0, cf=1.25):
    return p_base.MoEConfig(num_experts=E, top_k=K, expert_ff=F_EXP,
                            num_shared=num_shared, shared_ff=32,
                            capacity_factor=cf)


def _r_mo(mo):
    return r_base.MoEConfig(**dataclasses.asdict(mo))


def _plan(n, groups, dropless, mo):
    """The reference's group count and capacity for ``n`` tokens."""
    g = 1 if n % groups or n // groups < 4 else groups
    ng = n // g
    cap = max(4, -(-ng // 4) * 4) if dropless else p_moe.capacity(ng, mo)
    return g, ng, cap


@functools.lru_cache(maxsize=None)
def _r_moe_forward(mo, dropless, groups):
    return jax.jit(functools.partial(r_moe.moe_forward, mo=mo,
                                     dropless=dropless,
                                     dispatch_groups=groups))


@functools.lru_cache(maxsize=None)
def _r_dispatch(k, e, cap):
    """The reference's ``_dispatch_group`` over G groups (its vmap)."""
    return jax.jit(jax.vmap(lambda xg, pg: r_moe._dispatch_group(
        xg, pg, k, e, cap)))


def _r_routing(p, x, groups, cap):
    xf = jnp.asarray(x).reshape(-1, D)
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ jnp.asarray(p["router"]),
                           axis=-1)
    n = xf.shape[0]
    return _r_dispatch(K, E, cap)(xf.reshape(groups, n // groups, D),
                                  probs.reshape(groups, n // groups, E))


def _p_routing(pm, x, groups, cap):
    xf = x.reshape(-1, D)
    probs = torch.softmax(xf.float() @ pm.router, dim=-1)
    n = xf.shape[0]
    return p_moe.dispatch_group(xf.view(groups, n // groups, D),
                                probs.view(groups, n // groups, E), K, E, cap)


def _x(seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(dtype)


# (id, dropless, dispatch_groups, num_shared, capacity_factor, ties)
MOE_CASES = [
    ("capacity_drops", False, 1, 0, 0.5, False),
    ("capacity_default_factor", False, 1, 0, 1.25, False),
    ("dropless", True, 1, 0, 1.25, False),
    ("capacity_g2", False, 2, 0, 0.5, False),
    ("capacity_g4", False, 4, 0, 0.5, False),
    ("dropless_g4", True, 4, 0, 1.25, False),
    ("g3_falls_back", False, 3, 0, 0.5, False),
    ("g16_falls_back", False, 16, 0, 0.5, False),
    ("shared2_capacity", False, 1, 2, 0.5, False),
    ("shared2_dropless_g2", True, 2, 2, 1.25, False),
    ("ties_capacity", False, 1, 0, 0.5, True),
    ("ties_dropless", True, 1, 0, 1.25, True),
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_forward_matches_reference(case):
    name, dropless, groups, shared, cf, ties = case
    p = _layer(MOE_CASES.index(case), shared, ties)
    x = _x(1)
    mo = _mo(shared, cf)
    pm = _port_moe(p)
    g, ng, cap = _plan(B * T, groups, dropless, mo)
    if name.endswith("falls_back"):
        assert g == 1
    elif groups > 1:
        assert g == groups

    # the routing: selection and kept slots exactly, weights to 1e-6
    r_xe, r_tok, r_w, r_sel = _r_routing(p, x, g, cap)
    xe, tok, w, sel = _p_routing(pm, torch.from_numpy(x), g, cap)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(r_sel))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
    np.testing.assert_allclose(w.numpy(), np.asarray(r_w), atol=1e-6)
    np.testing.assert_array_equal(xe.numpy(),
                                  np.asarray(r_xe).reshape(xe.shape))
    kept = int((tok >= 0).sum())
    if dropless:
        assert kept == B * T * K
    elif cf < 1:
        assert kept < B * T * K                     # tokens were dropped
    if ties:
        probs = torch.softmax(torch.from_numpy(x).reshape(-1, D)
                              @ pm.router, -1)
        assert torch.equal(probs[:, 0], probs[:, 1])
        lead = sel.reshape(-1, K)
        assert bool(((lead[:, 0] == 0) & (lead[:, 1] == 1)).any())
        assert not bool((lead[:, 0] == 1).any())    # a tie goes to 0

    y, aux = p_moe.moe_forward(pm, mo, torch.from_numpy(x), dropless, groups)
    r_y, r_aux = _r_moe_forward(_r_mo(mo), dropless, groups)(
        jax.tree.map(jnp.asarray, p), x=jnp.asarray(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(r_y), **LAYER_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
    if name == "g3_falls_back":
        y1, _ = p_moe.moe_forward(pm, mo, torch.from_numpy(x), dropless, 1)
        assert torch.equal(y, y1)


def test_dispatch_groups_change_capacity_mode_only():
    """Per-group capacity: in capacity mode G = 4 keeps other tokens than
    G = 1; dropless, G does not change the result beyond float sums."""
    p, x = _layer(5), torch.from_numpy(_x(2))
    pm = _port_moe(p)
    mo = _mo(cf=0.5)
    kept = {g: _p_routing(pm, x, g, _plan(B * T, g, False, mo)[2])[1]
            for g in (1, 4)}
    assert not torch.equal(kept[1].reshape(-1).sort().values,
                           kept[4].reshape(-1).sort().values)
    ys = [p_moe.moe_forward(pm, mo, x, True, g)[0] for g in (1, 2, 4)]
    for y in ys[1:]:
        np.testing.assert_allclose(y.numpy(), ys[0].numpy(), **LAYER_TOL)


def test_moe_forward_bf16_matches_reference():
    """bfloat16 activations and experts, the router float32 on both sides."""
    p, x = _layer(7), _x(3)
    mo = _mo(cf=0.5)
    pm = _port_moe(p, torch.bfloat16)
    assert pm.router.dtype == torch.float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, aux = p_moe.moe_forward(pm, mo, xb)
    rp = jax.tree.map(jnp.asarray, p)
    rp = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in rp.items()}
    r_y, r_aux = _r_moe_forward(_r_mo(mo), False, 1)(
        rp, x=jnp.asarray(x).astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and r_y.dtype == jnp.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(r_y.astype(jnp.float32)),
                               **BF16_TOL)
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL


@pytest.mark.parametrize("n", [1, 4, 7, 32, 100, 4600])
def test_capacity_matches_reference(n):
    for cf in (0.5, 1.0, 1.25, 2.0):
        mo = _mo(cf=cf)
        assert p_moe.capacity(n, mo) == r_moe._capacity(n, _r_mo(mo))


def test_topk_router_matches_reference():
    rng = np.random.default_rng(4)
    probs = rng.random((3, 9, 6)).astype(np.float32)
    probs[0, :, 2] = probs[0, :, 4] = 2.0             # ties at the top
    probs[1, :, 1] = probs[1, :, 3] = probs[1, :, 5] = 2.0
    for k in (1, 2, 3):
        w, sel = p_moe.topk_router(torch.from_numpy(probs), k)
        r_w, r_sel = r_moe._topk_router(jnp.asarray(probs), k)
        assert sel.dtype == torch.int32
        np.testing.assert_array_equal(sel.numpy(), np.asarray(r_sel))
        np.testing.assert_array_equal(w.numpy(), np.asarray(r_w))
    assert sel[0, 0].tolist() == [2, 4, int(np.argsort(-probs[0, 0])[2])]
    assert sel[1, 0].tolist() == [1, 3, 5]


# a prefill's token count (its dropless capacity above TRIM_MIN_CAP) and a
# decode tick's (8 lanes)
TRIM_SIDES = {"prefill": 2 * p_moe.TRIM_MIN_CAP + 40, "tick": 8}


@pytest.mark.parametrize("side", list(TRIM_SIDES))
def test_dispatch_trims_to_the_fullest_expert(side):
    """Above ``TRIM_MIN_CAP`` slots an expert, dispatch keeps the first
    ``rows`` slots of each expert, rows the fullest expert's kept count:
    they equal the reference's, whose slots past them are all empty.  At
    a tick's capacity every slot is kept, as in the reference."""
    n = TRIM_SIDES[side]
    p = _layer(9)
    x = np.random.default_rng(4).standard_normal((1, n, D)).astype(np.float32)
    pm = _port_moe(p)
    cap = p_moe.dropless_capacity(n)
    assert cap == _plan(n, 1, True, _mo())[2]
    r_xe, r_tok, _, _ = _r_routing(p, x, 1, cap)
    xe, tok, _, _ = _p_routing(pm, torch.from_numpy(x), 1, cap)
    rows = xe.shape[2]
    r_xe = np.asarray(r_xe).reshape(1, E, cap, D)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(r_tok))
    np.testing.assert_array_equal(xe.numpy(), r_xe[:, :, :rows])
    if side == "tick":
        assert rows == cap <= p_moe.TRIM_MIN_CAP
        return
    assert cap > p_moe.TRIM_MIN_CAP and rows < cap
    assert not r_xe[:, :, rows:].any()
    assert bool((tok.view(1, E, cap)[:, :, rows:] == -1).all())
    assert bool((tok.view(1, E, cap)[:, :, rows - 1] >= 0).any())


# --------------------------------------------------------------------------
# Mixtral-8x22B and a dense/MoE pattern
# --------------------------------------------------------------------------

def _mixed(cfg, base):
    """Mixtral's smoke variant with the pattern ((attn, dense), (attn,
    moe)), 4 layers (2 periods)."""
    return dataclasses.replace(
        cfg, layer_pattern=(base.LayerSpec("attn", "dense"),
                            base.LayerSpec("attn", "moe")), num_layers=4)


@functools.lru_cache(maxsize=None)
def _world(kind):
    rcfg = r_base.smoke_variant(r_get_config(ARCH))
    cfg = smoke_variant(get_config(ARCH))
    if kind == "mixed":
        rcfg, cfg = _mixed(rcfg, r_base), _mixed(cfg, p_base)
    arrays = _draw(rcfg)
    return dict(cfg=cfg, rcfg=rcfg, arrays=arrays,
                rparams=jax.tree.map(jnp.asarray, arrays),
                model=interop.lm_params_from_arrays(arrays, cfg))


@functools.lru_cache(maxsize=None)
def _r_forward(rcfg, dropless):
    return jax.jit(functools.partial(r_lm.forward, cfg=rcfg, impl="xla",
                                     dropless=dropless))


@functools.lru_cache(maxsize=None)
def _r_decode(rcfg):
    return jax.jit(functools.partial(r_lm.decode_step, cfg=rcfg, impl="xla"))


def _tokens(b, t, seed, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


WORLDS = ("mixtral", "mixed")


def test_mixtral_config_equals_reference():
    for ours, ref in ((get_config(ARCH), r_get_config(ARCH)),
                      (smoke_variant(get_config(ARCH)),
                       r_base.smoke_variant(r_get_config(ARCH)))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_counts() == ref.param_counts()
        assert (ours.padded_vocab, ours.num_periods, ours.resolved_head_dim) \
            == (ref.padded_vocab, ref.num_periods, ref.resolved_head_dim)
    assert ARCH in registered() and ARCH not in p_base.NOT_PORTED
    full = get_config(ARCH)
    counts = full.param_counts()
    assert round(counts["total"] / 1e9, 1) == 140.6
    assert round(counts["active"] / 1e9, 1) == 39.2
    assert (full.resolved_head_dim, full.swa_window, full.moe.top_k) == (
        128, 4096, 2)
    mixed = _world("mixed")
    assert mixed["cfg"].param_counts() == mixed["rcfg"].param_counts()


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_reference(world, dropless):
    """24 tokens past the smoke window of 16; in capacity mode the 48
    tokens of a call overflow an expert's ceil(48 * 2 * 1.25 / 4) = 32
    slots only under imbalance, so aux and the logits are held too."""
    w = _world(world)
    toks = _tokens(2, 24, 11)
    got = p_lm.forward(w["model"], torch.from_numpy(toks), dropless=dropless)
    h, aux = p_lm.forward_hidden(w["model"], torch.from_numpy(toks),
                                 dropless=dropless)
    want, r_aux = _r_forward(w["rcfg"], dropless)(w["rparams"], batch={
        "tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(r_aux)) <= AUX_TOL
    assert h.shape == (2, 24, 64)


def test_capacity_mode_drops_in_the_model():
    """With a capacity factor of 0.25 the forward drops tokens, and the
    port still equals the reference (capacity is the default mode)."""
    w = _world("mixtral")
    rcfg = dataclasses.replace(w["rcfg"], moe=dataclasses.replace(
        w["rcfg"].moe, capacity_factor=0.25))
    cfg = dataclasses.replace(w["cfg"], moe=dataclasses.replace(
        w["cfg"].moe, capacity_factor=0.25))
    model = interop.lm_params_from_arrays(w["arrays"], cfg)
    toks = _tokens(2, 24, 12)
    got = p_lm.forward(model, torch.from_numpy(toks))
    want, _ = _r_forward(rcfg, False)(w["rparams"], batch={
        "tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    exact = p_lm.forward(model, torch.from_numpy(toks), dropless=True)
    assert not torch.allclose(got, exact, atol=1e-3)    # drops changed it


@pytest.mark.parametrize("world", WORLDS)
def test_decode_step_matches_reference(world):
    """An 18-token prefill, then two one-token steps past the window: both
    sides dropless."""
    w = _world(world)
    pc = p_lm.init_cache(w["cfg"], 2, 24, device="cpu")
    rc = r_lm.init_cache(w["rcfg"], 2, 24)
    start = 0
    for t, seed in ((18, 13), (1, 14), (1, 15)):
        toks = _tokens(2, t, seed)
        got = p_lm.decode_step(w["model"], torch.from_numpy(toks), pc)
        want, rc = _r_decode(w["rcfg"])(w["rparams"], batch={
            "tokens": jnp.asarray(toks)}, caches=rc, pos=jnp.int32(start))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        start += t
        assert pc["len"] == start


@pytest.mark.parametrize("world", WORLDS)
def test_decode_equals_dropless_forward(world):
    """The cached path (prefill, then one token at a time) gives the
    dropless forward's logits at every position."""
    w = _world(world)
    toks = _tokens(2, 22, 16)
    want = p_lm.forward(w["model"], torch.from_numpy(toks), dropless=True)
    pc = p_lm.init_cache(w["cfg"], 2, 22, device="cpu")
    got = [p_lm.decode_step(w["model"], torch.from_numpy(toks[:, :14]), pc)]
    for i in range(14, 22):
        got.append(p_lm.decode_step(w["model"],
                                    torch.from_numpy(toks[:, i:i + 1]), pc))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               **LOGIT_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_generate_matches_reference(world):
    w = _world(world)
    prompt, max_new, max_len = _tokens(2, 9, 17), 9, 20
    got = p_serve.generate(w["model"], prompt, max_new, max_len=max_len,
                           device="cpu")
    with mock.patch.object(r_serve, "make_serve_fns", _jitted_serve_fns):
        want = r_serve.generate(w["rparams"], w["rcfg"], jnp.asarray(prompt),
                                max_new, max_len=max_len, impl="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", WORLDS)
def test_params_carry_every_leaf(world):
    """Every reference leaf lands in the port's state: layer j = period
    j // P of sub-layer j % P."""
    w = _world(world)
    cfg, state = w["cfg"], w["model"].state_dict()
    period = cfg.period
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(w["arrays"]):
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            sub = int(keys[1][3:])
            for i in range(cfg.num_periods):
                name = ".".join(["blocks", str(i * period + sub)] + keys[2:])
                np.testing.assert_array_equal(state[name].numpy(), a[i])
                seen.add(name)
        else:
            np.testing.assert_array_equal(state[keys[0]].numpy(), a)
            seen.add(keys[0])
    assert seen == set(state)
    moe = [n for n in seen if ".moe." in n]
    assert len(moe) == 4 * cfg.num_layers // period


def test_router_stays_float32_in_a_bf16_model():
    """``init_model`` and the carry-over keep the router float32 when the
    model is bfloat16; the experts take the model's dtype."""
    w = _world("mixtral")
    bf16 = dataclasses.replace(w["cfg"], dtype="bfloat16")
    for model in (p_lm.init_model(bf16, torch.Generator().manual_seed(0),
                                  device="cpu"),
                  interop.lm_params_from_arrays(w["arrays"], bf16)):
        for blk in model.blocks:
            assert blk.moe.router.dtype == torch.float32
            assert blk.moe.wi.dtype == blk.moe.wo.dtype == torch.bfloat16
        out = p_lm.forward(model, torch.from_numpy(_tokens(1, 8, 18)))
        assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="router is float32"):
        p_moe.MoE(torch.zeros(4, 2, dtype=torch.bfloat16),
                  *(torch.zeros(2, 4, 3),) * 2, torch.zeros(2, 3, 4))


def test_init_moe_distributions():
    """The reference's distributions: the router normal / sqrt(d), every
    expert weight normal / sqrt(e) (its first axis), shared experts one
    MLP of width shared_ff * num_shared."""
    mo = p_base.MoEConfig(num_experts=8, top_k=2, expert_ff=512,
                          num_shared=2, shared_ff=96)
    m = p_moe.init_moe(256, mo, torch.Generator().manual_seed(0), "cpu",
                       torch.float32)
    assert abs(float(m.router.std()) - 1 / 16) < 0.003
    for t in (m.wi, m.wg, m.wo):
        assert abs(float(t.std()) - 1 / np.sqrt(8)) < 0.01
    assert tuple(m.wo.shape) == (8, 512, 256)
    assert tuple(m.shared.wi.shape) == (256, 192)
    assert p_moe.init_moe(256, dataclasses.replace(mo, num_shared=0), None,
                          "cpu", torch.float32).shared is None


def test_supported_layer_patterns():
    """Attention layers with a dense, MoE or no FFN run, and so do hybrid
    patterns (Mamba layers with an MoE FFN among them); an MoE layer needs
    a MoEConfig."""
    cfg = smoke_variant(get_config(ARCH))
    none_ffn = dataclasses.replace(
        cfg, layer_pattern=(p_base.LayerSpec("attn", None),
                            p_base.LayerSpec("attn", "moe")))
    m = p_lm.init_model(none_ffn, torch.Generator().manual_seed(0),
                        device="cpu")
    assert m.blocks[0].mlp is None and m.blocks[0].moe is None
    assert not hasattr(m.blocks[0], "nf") and m.blocks[1].moe is not None
    hybrid = dataclasses.replace(
        cfg, layer_pattern=(p_base.LayerSpec("attn", "moe"),
                            p_base.LayerSpec("mamba", "moe")),
        mamba=p_base.MambaConfig())
    m = p_lm.init_model(hybrid, torch.Generator().manual_seed(0),
                        device="cpu")
    assert m.blocks[0].attn is not None and m.blocks[1].moe is not None
    assert m.blocks[1].mamba.version == 2
    with pytest.raises(ValueError, match="no MoEConfig"):
        p_lm.check_supported(dataclasses.replace(cfg, moe=None))
    with pytest.raises(ValueError, match="not whole periods"):
        p_lm.check_supported(dataclasses.replace(
            none_ffn, num_layers=3))
