"""The profiler symbols ``chip_smoke.py`` reads against the CUDA sources.

``chip_smoke.py`` times each kernel's launches alone by summing the device
time of the kernels whose name holds ``KERNEL_SYMBOLS[name]``; a symbol
that no ``__global__`` function holds would time nothing.  These checks run
on the CPU: they read ``src/repro_torch/kernels/csrc/*.cu`` as text and
load ``chip_smoke.py`` by path (its work runs only under ``__main__``).
"""
import glob
import importlib.util
import os
import re

import pytest

from repro_torch.kernels import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc")
GLOBAL_FN = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_symbols", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYMBOLS = _load_chip_smoke().KERNEL_SYMBOLS


def _global_functions():
    names = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        with open(path) as f:
            for fn in GLOBAL_FN.findall(f.read()):
                names[fn] = os.path.basename(path)
    return names


def test_the_sources_define_kernels():
    names = _global_functions()
    assert {"flash_attention_wgmma_kernel", "flash_attention_kernel",
            "closure_step_pack_kernel", "closure_step_kernel"} <= set(names)
    assert set(names.values()) == {s + ".cu" for s in _cuda.SOURCES}


@pytest.mark.parametrize("name", sorted(SYMBOLS))
def test_each_profiler_symbol_names_a_global_function(name):
    held = [fn for fn in _global_functions() if SYMBOLS[name] in fn]
    assert held, (name, SYMBOLS[name])


def test_every_launch_counter_has_a_profiler_symbol():
    assert set(_cuda.LAUNCHES) <= set(SYMBOLS)
