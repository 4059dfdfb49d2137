"""PyTorch port vs the JAX reference: deployment presets and the launcher.

* ``configs.dscep``: the seven presets carry the reference's values, and
  ``build_runtime`` deploys them (the reference's
  ``tests/test_dscep_config.py``, held to the reference's bytes).
* ``launch.dscep_run.main(argv, device="cpu")`` against the reference's
  ``main(argv)`` on a small world: the report lines (stream and KB sizes,
  the operator DAG and its used-KB sizes, per-chunk output and overflow
  counts, ``done:``) in the three modes, under ``--serve`` and for
  ``--explain``.  Times are left out of the comparison.
"""
import copy
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.configs import dscep as rdscep
from repro.core.session import ExecutionConfig as RConfig
from repro.launch import dscep_run as rrun
from repro_torch import interop
from repro_torch.configs import dscep
from repro_torch.core.rdf import to_host_rows
from repro_torch.core.session import ExecutionConfig
from repro_torch.launch import dscep_run
from repro_torch.launch.mesh import Mesh

from test_torch_session import _bytes, one_torch_thread, pworld  # noqa: F401

PRESETS = ("paper-eval", "paper-eval-subquery", "paper-eval-auto", "smoke",
           "monolithic", "per-query-windows", "pipelined")
SHARED_FIELDS = sorted(
    {f.name for f in dataclasses.fields(ExecutionConfig)}
    & {f.name for f in dataclasses.fields(RConfig)})


def test_presets_registered():
    assert set(dscep.deployments()) == set(rdscep.deployments()) == set(
        PRESETS)
    assert dscep.get_deployment("paper-eval").runtime.window_capacity == 1000
    assert dscep.get_deployment("paper-eval-subquery").runtime.kb_method == \
        "probe"
    assert dscep.get_deployment("paper-eval").runtime.kb_method == "scan"
    assert dscep.get_deployment("paper-eval-auto").runtime.kb_method == "auto"
    assert dscep.get_deployment("smoke").runtime.kb_method == "auto"
    assert dscep.get_deployment("pipelined").runtime.kb_method == "auto"
    assert not dscep.get_deployment("monolithic").decomposed
    assert dscep.get_deployment("pipelined").decomposed


@pytest.mark.parametrize("name", PRESETS)
def test_preset_values_equal_reference(name):
    """Every ExecutionConfig field both packages have holds the reference's
    value (``fuse_compaction`` the reference's default, False), on the
    device asked for."""
    ref = rdscep.get_deployment(name)
    got = dscep.get_deployment(name)
    cfg = got.config("cpu")
    assert cfg.device == "cpu"
    for f in SHARED_FIELDS:
        assert getattr(cfg, f) == getattr(ref.config, f), (name, f)
    assert got.decomposed == ref.decomposed
    assert got.runtime == cfg.runtime_config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            got.config()


def test_build_runtime_equals_reference(pworld):
    """``build_runtime("smoke")`` on the CPU gives the reference's bytes, and
    ``build_runtime("monolithic")`` the same result rows (the reference's
    own test); a mesh reaches the registered runtime."""
    text = pworld.texts["q15"]
    ref = rdscep.build_runtime("smoke", text, pworld.kbd.kb,
                               copy.deepcopy(pworld.vocab))
    kb = interop.kb_from_arrays(pworld.kb_arrays)
    split = dscep.build_runtime("smoke", text, kb, pworld.port_vocab(),
                                device="cpu")
    mono = dscep.build_runtime("monolithic", text, kb, pworld.port_vocab(),
                               device="cpu")
    ref_outs = ref.run(pworld.chunks)[0]
    outs = split.run(pworld.port_chunks())[0]
    for ro, po in zip(ref_outs, outs):
        for rc, pc in zip(ro, po):
            assert _bytes(rc) == _bytes(pc)

    def rows(reg):
        return sorted({r[:3] for o in reg.run(pworld.port_chunks())[0]
                       for r in to_host_rows(o)})

    assert rows(split) and rows(split) == rows(mono)
    mesh = Mesh(np.array([torch.device("cpu")] * 2, dtype=object).reshape(
        2, 1), ("data", "model"))
    sharded = dscep.build_runtime("smoke", text, kb, pworld.port_vocab(),
                                  mesh=mesh, device="cpu")
    assert sharded.runtime.mesh is mesh
    assert rows(sharded) == rows(split)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

WORLD = ["--tweets", "24", "--filler", "200", "--window-cap", "64"]
_TIME = re.compile(r" in [0-9.]+ ?m?s|[0-9.]+s total|[0-9.]+ chunks/s|"
                   r"= [0-9.]+ query-evals/s|registered in [0-9.]+s|"
                   r"streamed in [0-9.]+s|includes (compile|first-call set-up)|"
                   r"device: \S+")


def _report(main, argv, capsys):
    """``main(argv)``'s return value and its report lines with the times,
    the first-call notes and the device names taken out."""
    capsys.readouterr()
    ret = main(argv)
    lines = [_TIME.sub("", ln).rstrip()
             for ln in capsys.readouterr().out.splitlines()]
    return ret, [ln for ln in lines if ln]


@pytest.mark.parametrize("extra", [
    ["--mode", "monolithic"], ["--mode", "single_program"],
    ["--mode", "pipelined"], ["--serve", "6"], ["--explain"]],
    ids=["monolithic", "single_program", "pipelined", "serve", "explain"])
def test_main_equals_reference(extra, capsys):
    argv = WORLD + extra
    want = _report(rrun.main, argv, capsys)
    got = _report(lambda a: dscep_run.main(a, device="cpu"), argv, capsys)
    assert got == want
    ret, lines = got
    if extra[0] == "--explain":
        assert ret == 0 and lines[0].startswith("EXPLAIN")
        return
    assert ret > 0
    assert any(ln.startswith(("[dscep] done:", "[serve] done:"))
               for ln in lines)
    if extra[-1] in ("monolithic", "single_program"):
        assert any(ln.startswith("[dscep] chunk 0:") for ln in lines)


def test_main_refuses_what_the_reference_refuses(capsys):
    for argv in (["--mode", "pipelined", "--channel-capacity", "1"],
                 ["--chaos", "3"], ["--pallas"], ["--no-interpret"]):
        with pytest.raises(SystemExit):
            dscep_run.main(argv, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dscep_run.main(WORLD)
