"""PyTorch port vs the JAX reference: M-RoPE with the vision frontend stub
(``qwen2-vl-7b``) and codebook heads with the audio frontend stub
(``musicgen-large``), at the reference's smoke widths (``smoke_variant``:
2 layers, d_model 64, 4/2 heads of 16, vocab 128 padded to 256, M-RoPE
sections (2, 3, 3), 4 codebooks; float32, on the CPU).

The same parameters (numpy, from a seed, in the reference's nested
layout), token ids, frame embeddings and position ids feed both packages:

* the configurations, ``param_counts`` and the registry;
* ``apply_mrope`` at sections (2, 3, 3), D 16 and at Qwen2-VL's (16, 24,
  24), D 128, on random ``[3, B, T]`` positions; with three equal streams
  it equals ``apply_rope``;
* ``forward`` on token ids and on the stubs (``embeds``, and for Qwen2-VL
  image-grid ``positions`` laid out by ``chip_smoke.rope_index``, as
  Qwen2-VL's ``get_rope_index`` lays them out) against the reference's
  ``forward(impl="xla")``, and once against ``impl="pallas"`` (interpret
  mode on the CPU);
* ``decode_step`` (a cached prefill of ids or of ``embeds``, then
  one-token steps) and greedy ``generate`` (MusicGen on ``[B, T, K]``
  prompts, its padded-vocab ``-1e30`` rows compared in every codebook);
* a tick of per-lane M-RoPE over a per-sequence cache against the
  reference's per-sequence ``decode_step``;
* every leaf through ``lm_params_from_arrays``; the launcher refusing
  MusicGen, as the reference's does.

Each reference function is jitted once per shape.  Tolerance: 2e-4
absolute and relative on logits and rotated vectors (float32 sums and
``cos``/``sin`` of another library).
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
from repro.launch import serve as r_launch
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.launch import serve as p_launch
from repro_torch.models import common as p_common
from repro_torch.models import lm as p_lm
from repro_torch.serve import lm as p_serve
from test_torch_batcher import (  # noqa: F401
    _draw, _jitted_serve_fns, one_torch_thread)
from test_torch_kernel_sources import _load_chip_smoke

ARCHS = ("qwen2-vl-7b", "musicgen-large")
TOL = dict(rtol=2e-4, atol=2e-4)
T = 13
# two sequences of T positions: text and image grids of merged patches
LAYOUTS = ([("text", 3), ("image", 2, 3), ("text", 2), ("image", 1, 2)],
           [("text", 5), ("image", 2, 2), ("text", 4)])


rope_index = _load_chip_smoke().rope_index


@functools.lru_cache(maxsize=None)
def _world(arch):
    rcfg = r_base.smoke_variant(r_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    arrays = _draw(rcfg)
    return dict(cfg=cfg, rcfg=rcfg, arrays=arrays,
                rparams=jax.tree.map(jnp.asarray, arrays),
                model=interop.lm_params_from_arrays(arrays, cfg))


@functools.lru_cache(maxsize=None)
def _ref_forward(rcfg, impl):
    return jax.jit(lambda p, batch: r_lm.forward(p, rcfg, batch,
                                                 impl=impl)[0])


@functools.lru_cache(maxsize=None)
def _ref_decode(rcfg):
    return jax.jit(lambda p, batch, caches, pos: r_lm.decode_step(
        p, rcfg, batch, caches, pos))


def _tokens(cfg, shape, seed):
    """Token ids ``shape + (K,)`` for K codebooks, else ``shape``."""
    full = shape + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, full).astype(np.int32)


def _embeds(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _grid_positions():
    return np.stack([rope_index(lay) for lay in LAYOUTS], axis=1)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------------------------------
# configurations
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
    assert arch in registered()
    full = get_config(arch)
    if arch == "qwen2-vl-7b":
        assert (full.mrope_sections, full.frontend) == ((16, 24, 24),
                                                        "vision")
        assert sum(full.mrope_sections) == full.resolved_head_dim // 2
        assert round(full.param_counts()["total"] / 1e9, 3) == 7.615
    else:
        assert (full.num_codebooks, full.frontend, full.padded_vocab) == (
            4, "audio", 2048)
        assert round(full.param_counts()["total"] / 1e9, 3) == 3.242


def test_param_counts_count_the_extra_codebooks_once():
    """MusicGen's embedding ``[K, Vp, d]`` and head ``[d, K * Vp]`` hold
    ``K * Vp * d`` each; the reference's ``param_counts`` counts ``V * d``
    for each and the other codebooks' ``(K - 1) * V * d`` once.  At full
    width: 3.242 B counted against 3.255 B in the tensors (Vp = V)."""
    w = _world("musicgen-large")
    cfg, model = w["cfg"], w["model"]
    k, v, d = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    assert model.embed.shape == (k, cfg.padded_vocab, d)
    assert model.lm_head.shape == (d, k * cfg.padded_vocab)
    full = get_config("musicgen-large")
    missing = (full.num_codebooks - 1) * full.vocab_size * full.d_model
    assert round((full.param_counts()["total"] + missing) / 1e9, 3) == 3.255
    # at smoke size the tensors hold the padded rows too
    counted = cfg.param_counts()["total"]
    norms = (2 * cfg.num_layers + 1) * d
    held = sum(p.numel() for p in model.parameters())
    assert held == counted - (k + 1) * v * d + 2 * k * cfg.padded_vocab * d \
        + norms


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

def test_rope_index_lays_out_image_grids():
    got = rope_index([("text", 2), ("image", 2, 3), ("text", 2)])
    assert got.tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6],
                            [0, 1, 2, 2, 2, 3, 3, 3, 5, 6],
                            [0, 1, 2, 3, 4, 2, 3, 4, 5, 6]]
    assert rope_index([("text", 4)]).tolist() == [list(range(4))] * 3


@pytest.mark.parametrize("sections, d, theta", [((2, 3, 3), 16, 1e4),
                                                ((16, 24, 24), 128, 1e6)])
def test_apply_mrope_matches_reference(sections, d, theta):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    got = p_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                               sections, theta)
    want = r_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                                theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # three equal streams: plain RoPE, value for value
    same = torch.from_numpy(np.broadcast_to(pos[0], pos.shape).copy())
    assert torch.equal(
        p_common.apply_mrope(torch.from_numpy(x), same, sections, theta),
        p_common.apply_rope(torch.from_numpy(x), same[0], theta))
    with pytest.raises(ValueError, match="do not sum"):
        p_common.apply_mrope(torch.from_numpy(x), same, (1, 1, 1), theta)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

FORWARD_CASES = [("qwen2-vl-7b", "tokens"), ("qwen2-vl-7b", "stub"),
                 ("musicgen-large", "tokens"), ("musicgen-large", "stub")]


@pytest.mark.parametrize("arch, inputs", FORWARD_CASES)
def test_forward_matches_reference(arch, inputs):
    """Token ids, or the frontend stub: frame or patch embeddings, with
    Qwen2-VL's image-grid positions.  The vision stub is also held to the
    reference's Pallas path (interpret mode)."""
    w = _world(arch)
    cfg = w["cfg"]
    if inputs == "tokens":
        batch = {"tokens": _tokens(cfg, (2, T), 3)}
        got = p_lm.forward(w["model"], torch.from_numpy(batch["tokens"]))
    else:
        batch = {"embeds": _embeds(cfg, 2, T, 4)}
        if cfg.mrope_sections:
            batch["positions"] = _grid_positions()
        got = p_lm.forward(w["model"], None, **{
            k: torch.from_numpy(a) for k, a in batch.items()})
    shape = (2, T) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()) \
        + (cfg.padded_vocab,)
    assert got.shape == shape
    impls = ("xla", "pallas") if (arch, inputs) == ("qwen2-vl-7b",
                                                    "stub") else ("xla",)
    for impl in impls:
        want = _ref_forward(w["rcfg"], impl)(
            w["rparams"], {k: jnp.asarray(a) for k, a in batch.items()})
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_grid_positions_move_the_logits():
    """The image-grid positions are not the default ones: the stub's
    logits change with them (so the forward case above tests them)."""
    w = _world("qwen2-vl-7b")
    emb = torch.from_numpy(_embeds(w["cfg"], 2, T, 4))
    grid = p_lm.forward(w["model"], None, embeds=emb,
                        positions=torch.from_numpy(_grid_positions()))
    plain = p_lm.forward(w["model"], None, embeds=emb)
    assert float((grid - plain)[..., :w["cfg"].vocab_size].abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """A cached prefill of 6 frame or patch embeddings, then of 4 ids, then
    two one-token steps (decode attention), logits against the
    reference's ``decode_step`` at every call, and the cache length."""
    w = _world(arch)
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    pc = p_lm.init_cache(cfg, 2, 16, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, 16)
    start = 0
    calls = [{"embeds": _embeds(cfg, 2, 6, 5)},
             {"tokens": _tokens(cfg, (2, 4), 6)},
             {"tokens": _tokens(cfg, (2, 1), 7)},
             {"tokens": _tokens(cfg, (2, 1), 8)}]
    for batch in calls:
        got = p_lm.decode_step(model, torch.from_numpy(batch["tokens"])
                               if "tokens" in batch else None, pc,
                               embeds=torch.from_numpy(batch["embeds"])
                               if "embeds" in batch else None)
        want, rc = _ref_decode(rcfg)(w["rparams"],
                                     {k: jnp.asarray(a)
                                      for k, a in batch.items()},
                                     rc, jnp.int32(start))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        start += got.shape[1]
        assert pc["len"] == start
    last = p_lm.decode_step(model, torch.from_numpy(_tokens(cfg, (2, 1), 9)),
                            pc, last_only=True)
    assert last.shape == (2,) + got.shape[2:]


def _ref_generate(w, prompt, max_new, max_len):
    with mock.patch.object(r_serve, "make_serve_fns", _jitted_serve_fns):
        return np.asarray(r_serve.generate(w["rparams"], w["rcfg"],
                                           jnp.asarray(prompt), max_new,
                                           max_len=max_len, impl="xla"))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """Greedy ids equal, then teacher-forced logits of the prefill and of
    every step, MusicGen's padded-vocab -1e30 rows of every codebook
    included."""
    w = _world(arch)
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    prompt, max_new, max_len = _tokens(cfg, (2, 7), 10), 6, 16
    got = p_serve.generate(model, prompt, max_new, max_len=max_len,
                           device="cpu")
    want = _ref_generate(w, prompt, max_new, max_len)
    assert got.shape == want.shape == (2, max_new) + prompt.shape[2:]
    np.testing.assert_array_equal(_np(got), want)

    prefill, step = p_serve.make_serve_fns(model)
    r_prefill, r_step = _jitted_serve_fns(rcfg, max_len)
    pc = p_lm.init_cache(cfg, 2, max_len, device="cpu")
    rc = r_lm.init_cache(rcfg, 2, max_len)
    ours = prefill(torch.from_numpy(prompt), pc)
    ref, rc = r_prefill(w["rparams"], {"tokens": jnp.asarray(prompt)}, rc)
    logits = [(ours, ref)]
    for i in range(max_new - 1):
        tok = want[:, i:i + 1].copy()
        ref, rc = r_step(w["rparams"], {"tokens": jnp.asarray(tok)}, rc,
                         jnp.int32(7 + i))
        logits.append((step(torch.from_numpy(tok), pc), ref))
    for ours, ref in logits:
        np.testing.assert_allclose(_np(ours), np.asarray(ref), **TOL)
        pad = _np(ours)[..., cfg.vocab_size:]
        assert (pad == -1e30).all() and (np.asarray(ref)[
            ..., cfg.vocab_size:] == pad).all()
    assert pc["len"] == 7 + max_new - 1


def test_codebook_logits_mask_each_codebook():
    """The head's K * Vp outputs become ``[.., K, Vp]`` before the padded
    rows are masked: every codebook keeps its real rows (a mask over the
    flat axis would wipe codebooks 1 to 3 whole at smoke size)."""
    w = _world("musicgen-large")
    cfg = w["cfg"]
    h = torch.from_numpy(_embeds(cfg, 1, 3, 11))
    logits = p_lm.lm_logits(w["model"], h)
    assert logits.shape == (1, 3, cfg.num_codebooks, cfg.padded_vocab)
    assert torch.all(logits[..., cfg.vocab_size:] == -1e30)
    real = logits[..., :cfg.vocab_size]
    assert torch.all(real.abs() < 1e3) and torch.all(real.std(-1) > 0)
    flat = h @ w["model"].lm_head
    assert torch.equal(real, flat.reshape(1, 3, cfg.num_codebooks,
                                          cfg.padded_vocab)[
        ..., :cfg.vocab_size])


def test_sample_token_draws_each_codebook():
    """``[B, K, Vp]`` -> ``[B, K]``: greedy over the last axis, and a draw
    from each codebook's own distribution."""
    logits = torch.full((2, 4, 8), -1e30)
    for b in range(2):
        for k in range(4):
            logits[b, k, (b + k) % 8] = 0.0
    want = torch.tensor([[0, 1, 2, 3], [1, 2, 3, 4]], dtype=torch.int32)
    assert torch.equal(p_serve.greedy_token(logits), want)
    got = p_serve.sample_token(logits, torch.Generator().manual_seed(0), 1.0)
    assert got.dtype == torch.int32 and torch.equal(got, want)


# --------------------------------------------------------------------------
# per-lane M-RoPE over a per-sequence cache
# --------------------------------------------------------------------------

def test_per_lane_mrope_tick_matches_reference():
    """A one-token tick of 3 lanes at lengths 0, 5 and 11 over a
    per-sequence cache of drawn keys and values: each lane's three
    position streams come from its own length.  Logits and the written
    rows against the reference's per-sequence ``decode_step``."""
    w = _world("qwen2-vl-7b")
    cfg, rcfg = w["cfg"], w["rcfg"]
    lens = np.asarray([0, 5, 11], np.int32)
    empty = r_lm.init_cache(rcfg, 3, 12, per_seq=True)
    rng = np.random.default_rng(12)
    attn = {n: rng.standard_normal(a.shape).astype(np.float32)
            for n, a in empty["sub0"]["attn"].items() if n != "len"}
    rc = {"sub0": {"attn": dict({n: jnp.asarray(a) for n, a in attn.items()},
                                len=jnp.broadcast_to(jnp.asarray(lens),
                                                     (cfg.num_layers, 3)))}}
    pc = p_lm.init_cache(cfg, 3, 12, device="cpu", per_seq=True)
    for n, a in attn.items():
        pc[n].copy_(torch.from_numpy(a.transpose(0, 1, 3, 2, 4)))
    pc["len"].copy_(torch.from_numpy(lens))
    toks = _tokens(cfg, (3, 1), 13)
    got = p_lm.decode_step(w["model"], torch.from_numpy(toks), pc)
    want, rc = _ref_decode(rcfg)(w["rparams"], {"tokens": jnp.asarray(toks)},
                                 rc, jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert pc["len"].tolist() == (lens + 1).tolist()
    for n in attn:
        np.testing.assert_allclose(
            _np(pc[n]), np.asarray(rc["sub0"]["attn"][n]).transpose(
                0, 1, 3, 2, 4), **TOL)


# --------------------------------------------------------------------------
# interop and the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_carry_every_leaf(arch):
    w = _world(arch)
    cfg, state = w["cfg"], w["model"].state_dict()
    seen = set()
    for path, a in jax.tree_util.tree_leaves_with_path(w["arrays"]):
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
    ours = p_lm.init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert {n: t.shape for n, t in ours.state_dict().items()} == {
        n: t.shape for n, t in state.items()}


def test_launcher_refuses_codebooks_as_the_reference_does():
    """The batcher decodes one id a lane (``argmax`` over ``[Vp]``): both
    launchers refuse a codebook model."""
    with pytest.raises(AssertionError, match="token LMs"):
        r_launch.main(["--arch", "musicgen-large"])
    with pytest.raises(ValueError, match="token LMs"):
        p_launch.main(["--arch", "musicgen-large"], device="cpu")
