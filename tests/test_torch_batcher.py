"""PyTorch port vs the JAX reference: LM continuous batching at the
reference's smoke size (``smoke_variant``, float32, on the CPU), for
``qwen2-1.5b``, ``h2o-danube-1.8b`` (sliding window 16), ``olmo-1b``
(non-parametric LayerNorm), ``mamba2-130m``, ``mixtral-8x22b`` (MoE,
dropless on the serving path, sliding window 16), ``minicpm3-4b`` and
``deepseek-v2-236b`` (MLA: a latent cache ``ckv``/``krope``; DeepSeek's
FFN an MoE with shared experts) and ``jamba-v0.1-52b`` (the hybrid
pattern, cut to one period of 8 layers: Mamba-1 and one attention layer
with RoPE, dense and MoE FFNs; its cache holds both kinds).

The same parameters (numpy, from a seed, in the reference's nested
layout) and token ids feed both packages:

* the port's ``ContinuousBatcher`` (``launch.serve.make_slot_fns``) against
  the reference's ``generate(impl="xla")`` of each request on its own:
  more requests than slots (every lane is reused), danube's window crossed
  by prompt plus new tokens, and an ``eos_id``;
* the reference's own batcher in lockstep with the port's: unchanged on
  Mamba-2 (equal ids, equal lane states after every tick), and on the
  attention stacks with its ``decode_all`` wrapped to pass ``pos - 1``
  (equal ids, equal per-lane lengths after every tick, idle lanes
  included);
* the reference batcher's RoPE-position fault: its ids differ from
  ``generate``'s on a counterexample, and the port's do not;
* ``decode_step`` over a per-sequence cache (T = 1 and T = 3, lengths
  past the cache's end) against the reference's on a ``per_seq=True``
  cache;
* ``launch.serve.main`` against the reference's ``main``.

The reference's serving functions are jitted once per shape here
(``generate`` itself is eager and recompiles its loop every step): two
prompt lengths a model.  Tolerance: 2e-4 absolute and relative on logits
and states (``test_torch_lm.py``).
"""
import contextlib
import dataclasses
import functools
import io
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.launch import serve as r_launch
from repro.models import lm as r_lm
from repro.serve import lm as r_serve
from repro_torch import interop
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch import serve as p_launch
from repro_torch.models import lm as p_lm
from repro_torch.serve import lm as p_serve

ARCHS = ("qwen2-1.5b", "h2o-danube-1.8b", "olmo-1b", "mamba2-130m",
         "mixtral-8x22b", "minicpm3-4b", "deepseek-v2-236b",
         "jamba-v0.1-52b")
ATTENTION_ARCHS = tuple(a for a in ARCHS if a != "mamba2-130m")
TOL = dict(rtol=2e-4, atol=2e-4)
SLOTS = 2
MAX_LEN = 20
# (prompt length, max_new): 5 requests on 2 lanes reuse both; 9 + 9 crosses
# danube's smoke window of 16
REQUESTS = ((5, 10), (9, 3), (5, 7), (9, 9), (9, 4))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's LM tensors here are small.  With one intra-op thread
    pool over every core in each pytest-xdist worker beside the
    reference's own, the workers wait on one another: the LM port modules
    took twice the worker time under ``-n 6``.  One thread a worker while
    a module's tests run; the count is restored after.  A thread count
    reorders float32 sums at most, far inside the stated tolerances."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(rcfg, seed=0):
    """Reference-layout parameters as numpy, every leaf away from its init
    constant: projections normal / sqrt(fan_in), the embedding 0.5,
    conv_w 0.5 normal, norm weights and D 1 + 0.1 normal, biases, conv_b,
    A_log and dt_bias 0.1 normal."""
    params, _ = r_lm.init_model(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "embed" in name:
            x = 0.5 * rng.standard_normal(a.shape)
        elif any(n in name for n in ("'nm'", "'nf'", "final_norm",
                                     "'norm_w'", "'D'")):
            x = 1 + 0.1 * rng.standard_normal(a.shape)
        elif any(n in name for n in ("'bq'", "'bk'", "'bv'", "'conv_b'",
                                     "'A_log'", "'dt_bias'")):
            x = 0.1 * rng.standard_normal(a.shape)
        elif "'conv_w'" in name:
            x = 0.5 * rng.standard_normal(a.shape)
        else:
            x = rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


_serve_fns = r_serve.make_serve_fns


@functools.lru_cache(maxsize=None)
def _jitted_serve_fns(cfg, max_len, impl="xla"):
    prefill, step = _serve_fns(cfg, max_len, impl)
    return jax.jit(prefill), jax.jit(step)


@functools.lru_cache(maxsize=None)
def _jitted_slot_fns(cfg, max_len):
    return r_launch.make_slot_fns(cfg, max_len)


def _generate(rparams, rcfg, prompt, max_new, max_len=MAX_LEN):
    """The reference's ``generate(impl="xla")`` of one prompt, its serving
    functions jitted."""
    with mock.patch.object(r_serve, "make_serve_fns", _jitted_serve_fns):
        out = r_serve.generate(rparams, rcfg, jnp.asarray(prompt)[None],
                               max_new, max_len=max_len, impl="xla")
    return np.asarray(out)[0].tolist()


@functools.lru_cache(maxsize=None)
def _world(arch):
    """Both packages' configs and parameters, and the requests.  A layer
    pattern of more than one layer (Jamba's) keeps one period."""
    rcfg = r_base.smoke_variant(r_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    if cfg.period > 1:
        rcfg = dataclasses.replace(rcfg, num_layers=rcfg.period)
        cfg = dataclasses.replace(cfg, num_layers=cfg.period)
    arrays = _draw(rcfg)
    rparams = jax.tree.map(jnp.asarray, arrays)
    model = interop.lm_params_from_arrays(arrays, cfg)
    rng = np.random.default_rng(1)
    requests = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
                for n, new in REQUESTS]
    return dict(cfg=cfg, rcfg=rcfg, rparams=rparams, model=model,
                requests=requests)


@functools.lru_cache(maxsize=None)
def _want(arch):
    """The reference's ``generate`` of each request on its own."""
    w = _world(arch)
    return [_generate(w["rparams"], w["rcfg"], p, new)
            for p, new in w["requests"]]


def _port_batcher(w, eos_id=-1):
    batcher = p_serve.ContinuousBatcher(
        SLOTS, *p_launch.make_slot_fns(w["model"], MAX_LEN), eos_id=eos_id)
    for rid, (prompt, new) in enumerate(w["requests"]):
        batcher.submit(p_serve.Request(rid, prompt, new))
    cache = p_lm.init_cache(w["cfg"], SLOTS, MAX_LEN, device="cpu",
                            per_seq=True)
    return batcher, cache


def _ids(batcher):
    return {r.rid: r.generated for r in batcher.completed}


# --------------------------------------------------------------------------
# the port's batcher against per-request generate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_equals_generate(arch):
    w = _world(arch)
    batcher, cache = _port_batcher(w)
    admitted = []
    prefill = batcher.prefill_fn

    def prefill_rec(tokens, cache, slot):
        admitted.append(slot)
        return prefill(tokens, cache, slot)

    batcher.prefill_fn = prefill_rec
    cache, ticks = batcher.run_until_drained(cache)
    assert not batcher.queue and not batcher.active()
    assert _ids(batcher) == dict(enumerate(_want(arch)))
    assert sorted(set(admitted)) == list(range(SLOTS))
    assert len(admitted) == len(REQUESTS) > SLOTS      # lanes were reused
    assert all(r.done for r in batcher.completed)
    assert ticks >= max(n for _, n in REQUESTS) - 1
    if arch in ("h2o-danube-1.8b", "mixtral-8x22b"):
        assert max(len(p) + n for p, n in w["requests"]) > w["cfg"].swa_window


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_stops_at_eos(arch):
    """A request ends at the first decoded ``eos_id`` (the prefill's token
    is not checked, as in the reference), or at ``max_new``."""
    w = _world(arch)
    eos = _want(arch)[3][2]
    batcher, cache = _port_batcher(w, eos_id=eos)
    batcher.run_until_drained(cache)
    got = _ids(batcher)
    cut = 0
    for rid, ids in enumerate(_want(arch)):
        stop = next((i for i in range(1, len(ids)) if ids[i] == eos),
                    len(ids) - 1)
        assert got[rid] == ids[:stop + 1]
        cut += stop + 1 < len(ids)
    assert cut >= 1


# --------------------------------------------------------------------------
# the reference's batcher in lockstep with the port's
# --------------------------------------------------------------------------

def _lockstep(w, decode_wrap, compare):
    """Tick the reference's batcher and the port's side by side; after each
    tick ``compare(reference caches, port cache, active lanes)``.  Returns
    both batchers' ids."""
    rcfg, rparams = w["rcfg"], w["rparams"]
    prefill, decode = _jitted_slot_fns(rcfg, MAX_LEN)
    ref = r_serve.ContinuousBatcher(SLOTS, prefill, decode_wrap(decode))
    for rid, (prompt, new) in enumerate(w["requests"]):
        ref.submit(r_serve.Request(rid, prompt, new))
    rc = r_lm.init_cache(rcfg, SLOTS, MAX_LEN, per_seq=True)
    port, pc = _port_batcher(w)
    ticks = 0
    while ref.queue or ref.active():
        rc, _ = ref.step(rparams, rc)
        pc, _ = port.step(pc)
        ticks += 1
        assert ref.active() == port.active()
        compare(rc, pc, port.active())
    assert not port.queue and not port.active() and ticks > len(REQUESTS)
    return _ids(ref), _ids(port)


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_reference_batcher_with_positions_fixed_equals_port(arch):
    """The reference batcher with ``decode_all`` given ``pos - 1`` (each
    token's RoPE position = its cache row) runs in lockstep with the port:
    the same ids, and the same per-lane cache lengths after every tick,
    idle lanes (which both advance by one a tick) included."""
    w = _world(arch)

    def fixed(decode):
        return lambda params, tokens, caches, pos: decode(params, tokens,
                                                          caches, pos - 1)

    idle_steps = []

    def compare(rc, pc, active):
        attn = next(sub["attn"] for sub in rc.values() if "attn" in sub)
        rlen = np.asarray(attn["len"])                    # [periods, lanes]
        plen = pc["len"].numpy()
        assert (rlen == plen[None]).all(), (rlen, plen)
        idle_steps.extend(i for i in range(SLOTS) if i not in active)

    ref_ids, port_ids = _lockstep(w, fixed, compare)
    assert ref_ids == port_ids == dict(enumerate(_want(arch)))
    assert idle_steps                          # a lane idled through a tick


def test_reference_batcher_on_mamba2_equals_port():
    """Mamba-2 takes no positions: the reference batcher, unchanged, runs in
    lockstep with the port, with equal ids and equal conv tails and SSM
    states in every lane after every tick."""
    w = _world("mamba2-130m")

    def compare(rc, pc, active):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(pc[k].numpy(),
                                       np.asarray(rc["sub0"]["mamba"][k]),
                                       **TOL)

    ref_ids, port_ids = _lockstep(w, lambda decode: decode, compare)
    assert ref_ids == port_ids == dict(enumerate(_want("mamba2-130m")))


def test_reference_batcher_rope_fault_is_not_copied():
    """The reference batcher gives a slot ``pos = len(prompt) + 1`` after its
    prefill and rotates each decoded token by it, while the token's key row
    lands at ``len(prompt)``.  On Qwen2's smoke variant with the reference's
    own ``init_model(PRNGKey(0))`` weights its ids leave ``generate``'s at
    the third token; the port's equal ``generate``'s."""
    rcfg = r_base.smoke_variant(r_get_config("qwen2-1.5b"))
    params, _ = r_lm.init_model(jax.random.PRNGKey(0), rcfg)
    prompt, max_new = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32), 8
    want = _generate(params, rcfg, prompt, max_new, max_len=16)

    ref = r_serve.ContinuousBatcher(1, *_jitted_slot_fns(rcfg, 16))
    ref.submit(r_serve.Request(0, prompt, max_new))
    ref.run_until_drained(params, r_lm.init_cache(rcfg, 1, 16, per_seq=True))

    model = interop.lm_params_from_arrays(jax.tree.map(np.asarray, params),
                                          smoke_variant(get_config(
                                              "qwen2-1.5b")))
    port = p_serve.ContinuousBatcher(1, *p_launch.make_slot_fns(model, 16))
    port.submit(p_serve.Request(0, prompt, max_new))
    port.run_until_drained(p_lm.init_cache(model.cfg, 1, 16, device="cpu",
                                           per_seq=True))
    got_ref, got_port = ref.completed[0].generated, port.completed[0].generated
    assert got_ref[:2] == want[:2] and got_ref != want
    assert got_port == want


# --------------------------------------------------------------------------
# decode_step over a per-sequence cache
# --------------------------------------------------------------------------

S = 24


def _port_layout(name, a):
    """A reference cache leaf in the port's layout: GQA keys and values
    ``[L, B, S, Hk, D]`` -> ``[L, B, Hk, S, D]``; MLA's ``ckv`` and
    ``krope`` as they are."""
    return a.transpose(0, 1, 3, 2, 4) if name in ("k", "v") else a


# the lanes' lengths before the step: 0, inside the window, across danube's
# window of 16, past the cache's end (the T rows then go at S - T)
LENGTHS = {1: [0, 5, 20, 27], 3: [0, 5, 22, 27]}


def _subs(cfg, rc):
    """``(sub name, kind, [(period, port stack index)])`` of each
    sub-layer of a reference cache."""
    slots = p_lm.cache_slots(cfg)
    out = []
    for name, sub in rc.items():
        i = int(name[3:])
        kind = "attn" if "attn" in sub else "mamba"
        out.append((name, kind, [(n, slots[n * cfg.period + i][1])
                                 for n in range(cfg.num_periods)]))
    return out


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_sequence_decode_step_matches_reference(arch, t):
    """Every sub-layer's cache filled (attention rows at the lanes' lengths,
    Mamba conv tails and SSM states), one step, and every sub-layer's
    cache after it."""
    w = _world(arch)
    cfg, rcfg, model = w["cfg"], w["rcfg"], w["model"]
    lens = np.asarray(LENGTHS[t], np.int32)
    b = len(lens)
    empty = r_lm.init_cache(rcfg, b, S, per_seq=True)
    pc = p_lm.init_cache(cfg, b, S, device="cpu", per_seq=True)
    rng = np.random.default_rng(t)
    rc, filled = {}, {}
    for name, kind, stacks in _subs(cfg, empty):
        leaves = empty[name][kind]
        scale = 1.0 if kind == "attn" else 0.5
        drawn = {n: (scale * rng.standard_normal(a.shape)).astype(np.float32)
                 for n, a in leaves.items() if n != "len"}
        rc[name] = {kind: {n: jnp.asarray(a) for n, a in drawn.items()}}
        if kind == "attn":
            rc[name][kind]["len"] = jnp.broadcast_to(jnp.asarray(lens),
                                                     leaves["len"].shape)
        for n, a in drawn.items():
            for period, j in stacks:
                pc[n][j].copy_(torch.from_numpy(_port_layout(n, a)[period]))
        filled[name] = set(drawn)
    pc["len"].copy_(torch.from_numpy(lens))

    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    got = p_lm.decode_step(model, torch.from_numpy(toks).long(), pc)
    want, rc = r_lm.decode_step(w["rparams"], rcfg,
                                {"tokens": jnp.asarray(toks)}, rc,
                                jnp.asarray(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert pc["len"].tolist() == (lens + t).tolist()
    for name, kind, stacks in _subs(cfg, rc):
        new = rc[name][kind]
        if kind == "attn":
            assert (np.asarray(new["len"]) == lens + t).all()
        for n in filled[name]:
            ref = _port_layout(n, np.asarray(new[n]))
            for period, j in stacks:
                np.testing.assert_allclose(pc[n][j].numpy(), ref[period],
                                           **TOL)


def test_per_sequence_cache_shapes_match_reference():
    """Each sub-layer's reference cache against the port's stack of its
    kind (attention and Mamba stacks side by side for Jamba), and one
    int32 length a lane."""
    for arch in ARCHS:
        w = _world(arch)
        cfg = w["cfg"]
        pc = p_lm.init_cache(cfg, 3, 11, device="cpu", per_seq=True)
        rc = r_lm.init_cache(w["rcfg"], 3, 11, per_seq=True)
        assert pc["len"].dtype == torch.int32 and pc["len"].tolist() == [0] * 3
        names = {"len"}
        counts = {}
        for kind, _ in p_lm.cache_slots(cfg):
            counts[kind] = counts.get(kind, 0) + 1
        for name, kind, _ in _subs(cfg, rc):
            for n, a in rc[name][kind].items():
                if n == "len":
                    assert (np.asarray(a) == 0).all()
                    continue
                names.add(n)
                assert tuple(pc[n].shape) == (counts[kind],) + _port_layout(
                    n, np.asarray(a)).shape[1:]
        assert set(pc) == names


def test_prefill_one_zeroes_a_reused_lane():
    """A lane keeps nothing of its previous request: its keys and values
    past the new prompt are zero, and its length is the prompt's."""
    w = _world("qwen2-1.5b")
    prefill, _ = p_launch.make_slot_fns(w["model"], MAX_LEN)
    cache = p_lm.init_cache(w["cfg"], SLOTS, MAX_LEN, device="cpu",
                            per_seq=True)
    for name in ("k", "v"):
        cache[name].fill_(7.0)
    cache["len"].fill_(13)
    prefill(torch.tensor([[1, 2, 3]]), cache, 1)
    assert cache["len"].tolist() == [13, 3]
    assert torch.all(cache["k"][:, 1, :, 3:] == 0)
    assert torch.all(cache["k"][:, 0] == 7.0)
    with pytest.raises(ValueError, match="does not fit"):
        prefill(torch.zeros((1, MAX_LEN + 1), dtype=torch.long), cache, 0)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def _main_lines(fn, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        done = fn(argv, **kw)
    return done, out.getvalue().splitlines()


MAIN_ARGV = ["--requests", "6"]     # 6 prompt lengths for the reference


@pytest.fixture(scope="module")
def reference_main():
    """The reference's ``main`` on qwen2-1.5b: requests, ticks and tokens
    depend only on its seeded draws (no ``eos_id``), not on the
    architecture or the weights, so its line stands for every arch."""
    done, lines = _main_lines(r_launch.main,
                              ["--arch", "qwen2-1.5b"] + MAIN_ARGV)
    return done, lines[0].split(", ")[:2]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_main_matches_reference(arch, reference_main):
    done, lines = _main_lines(p_launch.main, ["--arch", arch] + MAIN_ARGV,
                              device="cpu")
    want_done, want_counts = reference_main
    assert done == want_done == 6
    head = lines[0].split(", ")
    assert head[0] == want_counts[0].replace("qwen2-1.5b", arch)
    assert head[1] == want_counts[1]
    assert len(lines) == 4 and all(l.startswith("  req ") for l in lines[1:])
