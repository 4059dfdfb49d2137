"""PyTorch port vs the JAX reference: LM training on one device, at the
reference's smoke size (``smoke_variant``, float32, on the CPU).

The same parameters (numpy, from a seed, in the reference's nested
layout), token batches and optimizer state feed both packages:

* ``configs.shapes`` field for field; ``data.tokens`` byte for byte;
* ``lm.loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(lm.loss_fn)`` on all ten architectures (MusicGen
  with ``[B, T, K]`` codebook ids, Qwen2-VL with the vision stub's
  ``embeds``, the MoE models' aux loss included); remat ``none``,
  ``dots`` and ``full`` give the same gradients;
* ``lr_at``, ``global_norm`` and ``adamw_update``; ``make_train_step``
  with 1 and 4 microbatches over 3 steps; float32 accumulation of a bf16
  model's microbatches;
* ``CheckpointManager``: atomicity, keep-K, the one-deep async write, the
  reference's file names, manifest and bytes, restores across the two
  packages (float32), the bf16 round trip and the reference's bf16 fault;
* ``ElasticRunner`` against the reference's on one scripted step
  function; ``launch.train.main`` resumed after an injected failure, and
  the reference's launcher resumed from the port's checkpoint;
* ``impl="pallas"`` refuses gradients, equals ``impl="xla"`` without them,
  and serving after training records no graph.

The reference is jitted once per architecture (module-scoped caches).
Jamba keeps one period (8 layers) of its smoke variant.  Tolerances: the
loss within 2e-5 absolute and relative; a gradient leaf within 1e-4 plus
1e-3 of its largest magnitude (float32 sums in another order: the port's
chunked SSD against the reference's ``ssd_ref``, its log-step scan
against ``associative_scan``); optimizer leaves within 1e-6.
"""
import dataclasses
import functools
import json
import os
import shutil
import threading
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as r_base
from repro.configs import get_config as r_get_config
from repro.configs import shapes as r_shapes
from repro.data import tokens as r_tokens
from repro.launch import train as r_train
from repro.models import lm as r_lm
from repro.train import checkpoint as r_ckpt
from repro.train import elastic as r_elastic
from repro.train import optimizer as r_opt
from repro.train import train_loop as r_loop
from repro_torch import interop
from repro_torch.configs import get_config, registered, smoke_variant
from repro_torch.configs import shapes as p_shapes
from repro_torch.data import tokens as p_tokens
from repro_torch.launch import train as p_train
from repro_torch.models import lm as p_lm
from repro_torch.train import checkpoint as p_ckpt
from repro_torch.train import elastic as p_elastic
from repro_torch.train import optimizer as p_opt
from repro_torch.train import train_loop as p_loop
from test_torch_batcher import _draw, one_torch_thread  # noqa: F401

ARCHS = registered()
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
B, T = 4, 24


def _cfgs(arch):
    """Both packages' smoke configurations; Jamba at one period."""
    rcfg = r_base.smoke_variant(r_get_config(arch))
    cfg = smoke_variant(get_config(arch))
    if rcfg.period > 1:
        rcfg = dataclasses.replace(rcfg, num_layers=rcfg.period)
        cfg = dataclasses.replace(cfg, num_layers=cfg.period)
    return rcfg, cfg


def _batch(cfg, seed=1, b=B, t=T):
    """Token ids ``[B, T]`` (``[B, T, K]`` for codebooks) or, for the
    vision stub's model, ``embeds [B, T, d]``, and labels: numpy."""
    rng = np.random.default_rng(seed)
    ids = (b, t, cfg.num_codebooks) if cfg.num_codebooks else (b, t)
    batch = {"labels": rng.integers(0, cfg.vocab_size, ids).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["embeds"] = (0.5 * rng.standard_normal(
            (b, t, cfg.d_model))).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, ids).astype(np.int32)
    return batch


def _tbatch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _world(arch):
    rcfg, cfg = _cfgs(arch)
    return rcfg, cfg, _draw(rcfg), _batch(cfg)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch):
    rcfg, _, params, batch = _world(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: r_lm.loss_fn(p, rcfg, b), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _port_model(arch, dtype=None):
    _, cfg, params, _ = _world(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return interop.lm_params_from_arrays(params, cfg)


def _port_only(arch):
    """The port's own seeded smoke model and batch, for checks that hold
    the port to itself (no reference run)."""
    cfg = _cfgs(arch)[1]
    return (p_lm.init_model(cfg, torch.Generator().manual_seed(0), "cpu"),
            _tbatch(_batch(cfg)))


def _leaves(tree, flatten):
    return {path: np.asarray(leaf.float() if torch.is_tensor(leaf) else leaf)
            for path, leaf in flatten(tree)}


def _close_leaves(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, what=""):
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        bound = atol + rtol * float(np.abs(w).max(initial=0.0))
        err = float(np.abs(got[path] - w).max(initial=0.0))
        assert err <= bound, (what, path, err, bound)


# --------------------------------------------------------------------------
# shapes and token data
# --------------------------------------------------------------------------

def test_shapes_field_for_field():
    assert [dataclasses.astuple(s) for s in p_shapes.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in r_shapes.ALL_SHAPES]
    for s in r_shapes.ALL_SHAPES:
        assert dataclasses.asdict(p_shapes.get_shape(s.name)) == \
            dataclasses.asdict(s)
    with pytest.raises(KeyError):
        p_shapes.get_shape("train_8k")


@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (0, 7, 0, 1), (3, 12, 1, 2), (11, 100000, 3, 4)])
def test_batch_at_step_byte_for_byte(seed, step, host, hosts):
    kw = dict(vocab_size=50280, seq_len=33, global_batch=8, seed=seed,
              num_hosts=hosts, host_id=host)
    pcfg, rcfg = p_tokens.TokenDatasetConfig(**kw), \
        r_tokens.TokenDatasetConfig(**kw)
    assert p_tokens.host_batch_shape(pcfg) == r_tokens.host_batch_shape(rcfg)
    got, want = p_tokens.batch_at_step(pcfg, step), \
        r_tokens.batch_at_step(rcfg, step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()
    # a stream resumed from a step draws what the whole stream draws there
    resumed = p_tokens.token_stream(pcfg, start_step=step)
    whole = r_tokens.token_stream(rcfg, start_step=max(0, step - 2))
    for _ in range(step - max(0, step - 2)):
        next(whole)
    for _ in range(3):
        a, b = next(resumed), next(whole)
        assert all(a[k].tobytes() == b[k].tobytes() for k in b)


# --------------------------------------------------------------------------
# loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_the_reference(arch,
                                                          one_torch_thread):
    rcfg, cfg, _, batch = _world(arch)
    r_loss, r_metrics, r_grads = _ref_value_and_grad(arch)
    model = _port_model(arch)
    loss, metrics, grads = p_loop.value_and_grad(model, _tbatch(batch))
    np.testing.assert_allclose(float(loss), r_loss, **LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), r_metrics[k],
                                   **LOSS_TOL)
    if cfg.moe is not None:
        assert r_metrics["aux"] > 0
    _close_leaves(
        _leaves(interop.to_reference_layout(grads, cfg),
                p_ckpt._flatten_with_paths),
        _leaves(r_grads, r_ckpt._flatten_with_paths), what=arch)
    # the padded vocab rows take no gradient at all
    head = (grads["embed"] if model.lm_head is None
            else grads["lm_head"].T)
    head = head.reshape(-1, cfg.padded_vocab, cfg.d_model) \
        if cfg.num_codebooks and model.lm_head is not None else head
    assert torch.count_nonzero(head[..., cfg.vocab_size:, :]) == 0
    # parameters are left without gradients, as built
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b",
                                  "mamba2-130m", "jamba-v0.1-52b"])
def test_remat_modes_give_equal_gradients(arch, one_torch_thread):
    model, batch = _port_only(arch)
    base = p_loop.value_and_grad(model, batch, remat="none")
    for remat in ("dots", "full"):
        got = p_loop.value_and_grad(model, batch, remat=remat)
        assert torch.equal(got[0], base[0])
        for name, g in base[2].items():
            torch.testing.assert_close(got[2][name], g, rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        p_lm.loss_fn(model, batch, remat="offload")


def test_router_gradient_flows_through_the_combine_weights(one_torch_thread):
    """With the aux loss weighted 0 the router's gradient comes only
    through the combine weights of the kept slots."""
    _, cfg, params, batch = _world("mixtral-8x22b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_weight=0.0))
    model = interop.lm_params_from_arrays(params, cfg)
    _, metrics, grads = p_loop.value_and_grad(model, _tbatch(batch))
    assert float(metrics["aux"]) == 0.0
    routers = [g for n, g in grads.items() if n.endswith("moe.router")]
    assert routers and all(torch.count_nonzero(g) > 0 for g in routers)


# --------------------------------------------------------------------------
# optimizer and train step
# --------------------------------------------------------------------------

def test_lr_at_over_the_schedule():
    for kw in (dict(peak_lr=1e-3, warmup_steps=10, total_steps=100),
               dict(peak_lr=3e-4, warmup_steps=2, total_steps=12),
               dict(peak_lr=0.1, warmup_steps=0, total_steps=1)):
        pc, rc = p_opt.AdamWConfig(**kw), r_opt.AdamWConfig(**kw)
        got = [float(p_opt.lr_at(pc, s)) for s in range(kw["total_steps"] + 5)]
        want = [float(r_opt.lr_at(rc, jnp.asarray(s)))
                for s in range(kw["total_steps"] + 5)]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _named(rng, shapes, dtype=torch.float32):
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for n, s in shapes.items()}


def test_global_norm_and_adamw_update_leaf_for_leaf():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 2)}
    params, grads = _named(rng, shapes), _named(rng, shapes)
    np.testing.assert_allclose(
        float(p_opt.global_norm(grads.values())),
        float(r_opt.global_norm({k: jnp.asarray(v.numpy())
                                 for k, v in grads.items()})), rtol=1e-6)
    for clip in (1.0, 100.0):          # clipped, then not
        cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                   grad_clip_norm=clip)
        pstate = p_opt.init_opt_state(params)
        rparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        rstate = r_opt.init_opt_state(rparams)
        pparams = {k: v.clone() for k, v in params.items()}
        for step in range(4):
            g = _named(rng, shapes)
            pparams, pstate, pm = p_opt.adamw_update(
                p_opt.AdamWConfig(**cfg), g, pstate, pparams)
            rparams, rstate, rm = r_opt.adamw_update(
                r_opt.AdamWConfig(**cfg),
                {k: jnp.asarray(v.numpy()) for k, v in g.items()},
                rstate, rparams)
            assert pstate.step == int(rstate.step) == step + 1
            for k in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                           rtol=1e-6)
            for name in shapes:
                for got, want in ((pparams[name], rparams[name]),
                                  (pstate.m[name], rstate.m[name]),
                                  (pstate.v[name], rstate.v[name])):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               **OPT_TOL)


@functools.lru_cache(maxsize=None)
def _ref_train(arch, microbatches, steps=3):
    rcfg, _, params, _ = _world(arch)
    tcfg = r_loop.TrainConfig(
        opt=r_opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=6),
        microbatches=microbatches, remat="none")
    step_fn = jax.jit(r_loop.make_train_step(rcfg, tcfg))
    p = jax.tree.map(jnp.asarray, params)
    opt = r_opt.init_opt_state(p)
    metrics = []
    for s in range(steps):
        batch = _batch(rcfg, seed=10 + s)
        p, opt, m = step_fn(p, opt, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, p), metrics


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_the_reference(microbatches, one_torch_thread):
    arch = "qwen2-1.5b"
    r_params, r_metrics = _ref_train(arch, microbatches)
    _, cfg, _, _ = _world(arch)
    model = _port_model(arch)
    tcfg = p_loop.TrainConfig(
        opt=p_opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=6),
        microbatches=microbatches, remat="none")
    step_fn = p_loop.make_train_step(cfg, tcfg)
    opt = p_opt.init_opt_state(dict(model.named_parameters()))
    for s, want in enumerate(r_metrics):
        model, opt, got = step_fn(model, opt,
                                  _tbatch(_batch(cfg, seed=10 + s)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                       atol=1e-5)
    assert opt.step == 3
    got = _leaves(interop.lm_params_to_arrays(model),
                  p_ckpt._flatten_with_paths)
    want = _leaves(r_params, r_ckpt._flatten_with_paths)
    assert sorted(got) == sorted(want)
    # Adam's first steps are ~sign(g): a gradient within float32 noise of
    # zero may flip an element by up to 2 lr; over all the parameters the
    # mean difference stays under 1e-6
    diffs = [np.abs(got[path] - w) for path, w in want.items()]
    assert max(d.max() for d in diffs) <= 2 * 1e-3
    mean = sum(d.sum() for d in diffs) / sum(d.size for d in diffs)
    assert mean < 1e-6


def test_train_step_accumulates_bf16_microbatches_in_float32(
        one_torch_thread):
    model = _port_model("qwen2-1.5b", dtype="bfloat16")
    cfg = model.cfg
    batch = _tbatch(_world("qwen2-1.5b")[3])
    n = 4
    want = {}
    for i in range(n):
        mb = {k: v.reshape((n, -1) + v.shape[1:])[i] for k, v in batch.items()}
        _, _, g = p_loop.value_and_grad(model, mb, remat="none")
        for name, x in g.items():
            assert x.dtype == torch.bfloat16 or name.endswith("router")
            want[name] = want.get(name, 0) + x.float()
    seen = {}

    def capture(opt_cfg, grads, state, params):
        seen.update(grads)
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}

    step_fn = p_loop.make_train_step(cfg, p_loop.TrainConfig(
        microbatches=n, remat="none"))
    with mock.patch.object(p_loop, "adamw_update", capture):
        step_fn(model, p_opt.init_opt_state(dict(model.named_parameters())),
                batch)
    assert sorted(seen) == sorted(want)
    for name, g in seen.items():
        assert g.dtype == torch.float32
        assert torch.equal(g, want[name] / n), name


def test_sharding_fields_are_not_ported():
    cfg = _world("qwen2-1.5b")[1]
    for field in p_loop.SHARDING_FIELDS:
        with pytest.raises(NotImplementedError,
                           match="LM training and sharding"):
            p_loop.make_train_step(cfg, p_loop.TrainConfig(**{field: ("data",)}))


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _trained_state(arch="qwen2-1.5b", dtype=None, steps=1):
    """A port model and optimizer state after ``steps`` train steps."""
    model = _port_model(arch, dtype)
    step_fn = p_loop.make_train_step(model.cfg, p_loop.TrainConfig(
        opt=p_opt.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4),
        remat="none"))
    opt = p_opt.init_opt_state(dict(model.named_parameters()))
    for s in range(steps):
        model, opt, _ = step_fn(model, opt,
                                _tbatch(_batch(model.cfg, seed=20 + s)))
    return model, opt


def _tree(model, opt):
    return (interop.lm_params_to_arrays(model),
            interop.opt_state_to_arrays(opt, model))


def test_checkpoint_files_and_manifest_equal_the_references(tmp_path,
                                                            one_torch_thread):
    model, opt = _trained_state()
    tree = _tree(model, opt)
    ref_tree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    ref_tree = (ref_tree[0], r_opt.OptState(*ref_tree[1]))
    shape = {"data": 1, "model": 1}
    p_ckpt.CheckpointManager(str(tmp_path / "p")).save(
        7, tree, mesh_shape=shape, blocking=True)
    r_ckpt.CheckpointManager(str(tmp_path / "r")).save(
        7, ref_tree, mesh_shape=shape, blocking=True)
    pd, rd = tmp_path / "p" / "step_00000007", tmp_path / "r" / "step_00000007"
    assert sorted(os.listdir(pd)) == sorted(os.listdir(rd))
    for name in os.listdir(rd):
        assert (pd / name).read_bytes() == (rd / name).read_bytes(), name
    # restored across the packages, float32
    got, manifest = p_ckpt.CheckpointManager(str(tmp_path / "r")).restore(tree)
    assert manifest["step"] == 7 and manifest["mesh_shape"] == shape
    for (path, a), (_, b) in zip(p_ckpt._flatten_with_paths(got),
                                 p_ckpt._flatten_with_paths(tree)):
        assert torch.equal(a, b.cpu()), path
    back, _ = r_ckpt.CheckpointManager(str(tmp_path / "p")).restore(ref_tree)
    for (path, a), (_, b) in zip(r_ckpt._flatten_with_paths(back),
                                 r_ckpt._flatten_with_paths(ref_tree)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    # and into a model and an optimizer state
    restored = interop.lm_params_from_arrays(got[0], model.cfg)
    ropt = interop.opt_state_from_arrays(got[1], restored)
    assert ropt.step == opt.step == 1
    for (n, a), (_, b) in zip(restored.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b) and torch.equal(ropt.m[n], opt.m[n]) \
            and torch.equal(ropt.v[n], opt.v[n]), n


def test_bf16_checkpoint_round_trips(tmp_path, one_torch_thread):
    model, opt = _trained_state("mamba2-130m", dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    tree = _tree(model, opt)
    mgr = p_ckpt.CheckpointManager(str(tmp_path))
    mgr.save(3, tree, blocking=True)
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["0/embed"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["1/m/embed"]["dtype"] == "float32"
    got, _ = mgr.restore(tree)
    for (path, a), (_, b) in zip(p_ckpt._flatten_with_paths(got),
                                 p_ckpt._flatten_with_paths(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_reference_bf16_checkpoint_fault_is_not_copied(tmp_path):
    """The reference writes a bfloat16 leaf as numpy ``|V2`` and cannot
    read it back; the port writes the same bytes and reads them."""
    vals = np.array([1.0, -2.5, 3e-3, 65504.0], np.float32)
    ref_tree = {"w": jnp.asarray(vals, jnp.bfloat16),
                "s": jnp.zeros((), jnp.int32)}
    port_tree = {"w": torch.from_numpy(vals).to(torch.bfloat16),
                 "s": torch.zeros((), dtype=torch.int32)}
    r_ckpt.CheckpointManager(str(tmp_path / "r")).save(1, ref_tree,
                                                       blocking=True)
    p_ckpt.CheckpointManager(str(tmp_path / "p")).save(1, port_tree,
                                                       blocking=True)
    for name in ("w.npy", "s.npy", "manifest.json"):
        assert (tmp_path / "p" / "step_00000001" / name).read_bytes() == \
            (tmp_path / "r" / "step_00000001" / name).read_bytes(), name
    with pytest.raises(TypeError, match="V2"):
        r_ckpt.CheckpointManager(str(tmp_path / "r")).restore(ref_tree)
    got, _ = p_ckpt.CheckpointManager(str(tmp_path / "r")).restore(port_tree)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], port_tree["w"])


def test_checkpoint_write_killed_midway_leaves_the_latest_intact(tmp_path):
    mgr = p_ckpt.CheckpointManager(str(tmp_path))
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 3)}}
    mgr.save(1, tree, blocking=True)
    real_save = p_ckpt._save

    def dies_on_the_second_leaf(path, arr):
        if "b__c" in str(path):
            raise OSError("killed mid-write")
        return real_save(path, arr)

    with mock.patch.object(p_ckpt, "_save", dies_on_the_second_leaf):
        mgr.save(2, {"a": torch.zeros(4), "b": {"c": torch.zeros(2, 3)}})
        with pytest.raises(OSError, match="killed"):
            mgr.wait()
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    assert mgr.steps() == [1] and mgr.latest_step() == 1
    got, manifest = mgr.restore(tree)
    assert manifest["step"] == 1 and torch.equal(got["a"], tree["a"])
    # the next save of that step clears the leftover .tmp
    mgr.save(2, tree, blocking=True)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000002"]


def test_checkpoint_keeps_k_and_writes_one_deep_async(tmp_path):
    mgr = p_ckpt.CheckpointManager(str(tmp_path), keep=2)
    gate, started, order = threading.Event(), threading.Event(), []
    real_write = mgr._write

    def slow_write(step, leaves, manifest):
        order.append(("start", step))
        if step == 1:
            started.set()
            assert gate.wait(10)
        real_write(step, leaves, manifest)
        order.append(("end", step))

    mgr._write = slow_write
    tree = {"x": torch.arange(3.0)}
    mgr.save(1, tree)               # returns while the write is held
    assert started.wait(10)
    assert order == [("start", 1)] and mgr.latest_step() is None
    threading.Timer(0.2, gate.set).start()
    mgr.save(2, tree)               # waits for step 1's write first
    assert order[:2] == [("start", 1), ("end", 1)]
    for s in (3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert [e for e in order if e[0] == "start"] == [
        ("start", s) for s in (1, 2, 3, 4)]


# --------------------------------------------------------------------------
# elastic runner and the launcher
# --------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _run_elastic(mod, clock, tmp):
    walls = {0: 1.0, 1: 1.0, 2: 5.0, 3: 1.0, 4: 1.0, 5: 9.0, 6: 1.0,
             7: 1.0}
    losses = {s: 3.0 - 0.1 * s for s in walls}
    nan_once = {4}
    saved = {}

    def step_fn(state, step):
        clock.now += walls[step]
        loss = losses[step]
        if step in nan_once:
            nan_once.discard(step)
            loss = float("nan")
        return state + (step,), {"loss": loss}

    def save_fn(state, step):
        saved[step] = state

    def restore_fn():
        step = max(saved)
        return saved[step], step

    runner = mod.ElasticRunner(
        mod.ElasticConfig(max_restarts=1, checkpoint_every=2),
        ckpt_mgr=None,
        mesh_shapes=[{"data": 4}, {"data": 2}, {"data": 1}])
    saved[0] = ()
    state, hist = runner.run((), step_fn, 0, 8, save_fn, restore_fn,
                             failure_schedule={3: RuntimeError("node lost"),
                                               6: RuntimeError("again")})
    return (state, [dataclasses.astuple(r) for r in hist], runner.mesh_index,
            runner.restart_count, runner.ewma, sorted(saved))


def test_elastic_runner_equals_the_reference(tmp_path):
    clock = _Clock()
    fake_time = types.SimpleNamespace(monotonic=clock)
    with mock.patch.object(p_elastic, "time", fake_time), \
            mock.patch.object(r_elastic, "time", fake_time):
        got = _run_elastic(p_elastic, clock, tmp_path)
        clock.now = 0.0
        want = _run_elastic(r_elastic, clock, tmp_path)
    assert got == want
    assert got[2] == 2                               # resized twice
    assert any(r[3] for r in got[1])                 # a straggler flagged


def _train_args(ckpt_dir, steps, *extra):
    return ["--arch", "qwen2-1.5b", "--smoke", "--steps", str(steps),
            "--batch", "4", "--seq", "16", "--lr", "1e-3", "--ckpt-every",
            "2", "--log-every", "1", "--ckpt-dir", str(ckpt_dir), *extra]


def test_launcher_resumes_to_the_uninterrupted_state(tmp_path, capsys,
                                                     one_torch_thread):
    whole = p_train.main(_train_args(tmp_path / "a", 7), device="cpu")
    crashed = p_train.main(_train_args(tmp_path / "b", 7, "--fail-at", "5",
                                       "--retries", "1"), device="cpu")
    out = capsys.readouterr().out
    assert "node failure injected: simulated node loss at step 5" in out
    assert "[train] restored step 4" in out
    assert crashed["steps_run"] == 2 and whole["steps_run"] == 7
    for step, loss in crashed["losses"].items():
        assert loss == whole["losses"][step], step
    a = p_ckpt.CheckpointManager(str(tmp_path / "a"))
    b = p_ckpt.CheckpointManager(str(tmp_path / "b"))
    assert a.latest_step() == b.latest_step() == 6
    ta = a.restore(_tree(*_trained_state(steps=0)))[0]
    tb = b.restore(_tree(*_trained_state(steps=0)))[0]
    for (path, x), (_, y) in zip(p_ckpt._flatten_with_paths(ta),
                                 p_ckpt._flatten_with_paths(tb)):
        assert torch.equal(x, y), path


def test_reference_launcher_resumes_from_the_ports_checkpoint(
        tmp_path, one_torch_thread):
    p_train.main(_train_args(tmp_path / "p", 4), device="cpu")
    shutil.copytree(tmp_path / "p", tmp_path / "r")
    argv = _train_args(tmp_path / "r", 8)
    want = r_train.train(_reference_args(argv))
    got = p_train.main(_train_args(tmp_path / "p", 8), device="cpu")
    assert got["steps_run"] == want["steps_run"] == 4
    for k in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[k], want[k], **LOSS_TOL)


def _reference_args(argv):
    """The reference launcher's parsed flags, as its ``main`` parses them
    (its ``main`` returns nothing)."""
    seen = {}
    with mock.patch.object(r_train, "train", lambda args: seen.update(
            args=args)):
        r_train.main(argv)
    return seen["args"]


# --------------------------------------------------------------------------
# the kernel path and serving after training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "deepseek-v2-236b"])
def test_pallas_path_refuses_gradients(arch, one_torch_thread):
    model, batch = _port_only(arch)
    with pytest.raises(RuntimeError, match="no backward"):
        p_loop.value_and_grad(model, batch, impl="pallas")
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError, match="impl"):
        p_lm.loss_fn(model, batch, impl="triton")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m",
                                  "jamba-v0.1-52b", "musicgen-large"])
def test_pallas_eval_loss_equals_the_xla_loss(arch, one_torch_thread):
    model, batch = _port_only(arch)
    with torch.no_grad():
        xla, xm = p_lm.loss_fn(model, batch, impl="xla")
        pallas, pm = p_lm.loss_fn(model, batch, impl="pallas")
    np.testing.assert_allclose(float(pallas), float(xla), **LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(xm[k]), **LOSS_TOL)


def test_serving_after_training_records_no_graph(one_torch_thread):
    model, _ = _trained_state(steps=1)
    assert not any(p.requires_grad for p in model.parameters())
    for p in model.parameters():      # even a model left trainable
        p.requires_grad_(True)
    cache = p_lm.init_cache(model.cfg, 2, 16, device="cpu", per_seq=True)
    ids = torch.tensor([[3, 5, 7], [2, 4, 6]])
    logits = p_lm.decode_step(model, ids, cache)
    logits = p_lm.decode_step(model, ids[:, :1], cache)
    assert logits.grad_fn is None and not logits.requires_grad
    for name, t in cache.items():
        if torch.is_tensor(t):
            assert t.grad_fn is None and not t.requires_grad, name
