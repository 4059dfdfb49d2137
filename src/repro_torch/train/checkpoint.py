"""Atomic, asynchronous checkpoints in the reference's on-disk layout.

* **Atomic commit**: a step is written into ``step_XXXXXXXX.tmp`` and
  renamed to ``step_XXXXXXXX`` with ``os.rename``, so a crash mid-write
  never leaves a partial checkpoint where ``steps()`` looks.
* **Manifest**: ``manifest.json`` holds ``step``, ``mesh_shape`` and each
  leaf's ``shape`` and ``dtype``, as the reference writes it.
* **Async**: :meth:`CheckpointManager.save` copies the leaves to the host
  at once and one worker thread writes them; the next save waits for the
  one before (one deep).
* **Retention**: the newest ``keep`` checkpoints stay.

A tree is nested dicts, tuples, lists and named tuples whose leaves are
tensors or numpy arrays.  Each leaf is one ``.npy`` named by its path, the
reference's ``_flatten_with_paths`` (dict keys sorted, sequence indices,
named-tuple fields; ``/`` turned into ``__``), so a checkpoint of the same
tree, ``(params, opt_state)`` in the reference's nested and period-stacked
layout (``interop.lm_params_to_arrays``, ``interop.opt_state_to_arrays``),
restores in either package.  A bfloat16 leaf is written as the reference
writes it: its bytes as numpy ``|V2`` (numpy has no bfloat16) with
``"dtype": "bfloat16"`` in the manifest; :meth:`restore` reads such a leaf
back as bfloat16 through the manifest's dtype (the reference's own restore
refuses ``|V2``).
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

BF16_BYTES = np.dtype("V2")


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in the reference's order: dict keys sorted,
    sequence items and named-tuple fields in order; None is no leaf."""
    def join(key):
        return "%s/%s" % (prefix, key) if prefix else str(key)

    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f in tree._fields
                for item in _flatten_with_paths(getattr(tree, f), join(f))]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in _flatten_with_paths(x, join(i))]
    return [(prefix, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten_with_paths` order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _leaf_filename(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """``(array to write, manifest dtype)``: a bfloat16 tensor as its
    bytes in ``|V2``."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BYTES), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save(path: str, arr: np.ndarray) -> None:
    """``np.save``, but a bfloat16 leaf's bytes go under the header the
    reference's ``np.save`` of a bfloat16 array writes (``'descr':
    '<V2'``), so the files are byte for byte the reference's."""
    if arr.dtype != BF16_BYTES:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype == BF16_BYTES and dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, mesh_shape: Optional[Dict[str, int]] = None,
             blocking: bool = False):
        """Snapshot ``tree`` at ``step``: the leaves are copied to the host
        now, written by the worker thread (after the previous save)."""
        self.wait()
        host_leaves, manifest_leaves = [], {}
        for path, leaf in _flatten_with_paths(tree):
            arr, dtype = _to_host(leaf)
            host_leaves.append((path, arr))
            manifest_leaves[path] = {"shape": list(arr.shape), "dtype": dtype}
        manifest = {"step": int(step), "mesh_shape": mesh_shape or {},
                    "leaves": manifest_leaves}
        self._pending = self._executor.submit(self._write, int(step),
                                              host_leaves, manifest)
        if blocking:
            self.wait()

    def _write(self, step: int, host_leaves, manifest):
        tmp = os.path.join(self.directory, "step_%08d.tmp" % step)
        final = os.path.join(self.directory, "step_%08d" % step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for path, arr in host_leaves:
            _save(os.path.join(tmp, _leaf_filename(path)), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic commit
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, "step_%08d" % s),
                          ignore_errors=True)

    def wait(self):
        """Block until the pending write (if any) is on disk; re-raise its
        error."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    # -- restore ------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        """``(tree, manifest)``: ``template``'s structure (its leaves give
        the shapes to check) filled with the checkpoint's leaves as CPU
        tensors, or on ``device``; the newest step unless ``step``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint found in %s"
                                    % self.directory)
        d = os.path.join(self.directory, "step_%08d" % step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = []
        for path, tmpl in _flatten_with_paths(template):
            arr = np.load(os.path.join(d, _leaf_filename(path)))
            want = tuple(tmpl.shape) if hasattr(tmpl, "shape") \
                else tuple(np.shape(tmpl))
            if want and tuple(arr.shape) != want:
                raise ValueError("shape mismatch for %s: ckpt %s vs template "
                                 "%s" % (path, arr.shape, want))
            t = _from_file(arr, manifest["leaves"][path]["dtype"])
            leaves.append(t if device is None else t.to(device))
        return _unflatten(template, iter(leaves)), manifest
