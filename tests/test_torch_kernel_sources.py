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


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _body(text, signature):
    """The brace-balanced body of the first definition that starts with
    ``signature`` (a function head up to its name)."""
    start = text.index(signature)
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError("unbalanced braces after %r" % signature)


def test_decode_attention_is_one_kernel():
    text = _source("attention.cu")
    assert "decode_combine_kernel" not in text
    # the dtype picks one of two kernels: bf16 on the tensor cores, f32 not
    assert sorted(fn for fn in _global_functions()
                  if fn.startswith("decode_")) == [
        "decode_attention_kernel", "decode_attention_mma_kernel"]
    assert "mma_16816(" in _body(text, "decode_attention_mma_kernel(")
    launcher = _body(text, "int decode_launch(")
    launches = launcher.count("<<<") + launcher.count("cudaLaunchKernelEx(")
    assert launches == 1
    assert "cudaLaunchAttributeClusterDimension" in launcher
    # the function's attributes are set once per device, not per call
    assert "static unsigned ready" in launcher


@pytest.mark.parametrize("source,launcher,kernel", [
    ("hash_join.cu", "int probe_join_launch(", "probe_join_kernel"),
    ("closure.cu", "int descendants_launch(", "descendants_kernel")])
def test_probe_join_and_descendants_are_one_cluster_launch(source, launcher,
                                                           kernel):
    """Each launcher makes one launch, of its own kernel, as a thread-block
    cluster (the blocks of a window, or of the matrix, meet through
    distributed shared memory)."""
    text = _source(source)
    body = _body(text, launcher)
    assert body.count("<<<") + body.count("cudaLaunchKernelEx(") == 1
    assert "cudaLaunchAttributeClusterDimension" in body
    assert kernel in body
    kbody = _body(text, kernel + "(")
    assert "cluster.sync()" in kbody and "map_shared_rank" in kbody


def test_the_probe_join_searches_once():
    """No upper-bound search: the fan-out flag and the candidates come from
    the keys after the lower bound, which starts from the fence table."""
    text = _source("hash_join.cu")
    assert "upper_bound" not in text
    kernel = _body(text, "probe_join_kernel(")
    assert "cp.async.bulk" in kernel          # the fence table, staged
    assert "<= q" not in text and "<=q" not in text


@pytest.mark.parametrize("kernel", ["ssd_chunk_state_wgmma_kernel",
                                    "ssd_output_wgmma_kernel"])
def test_bf16_ssd_products_run_on_the_tensor_cores(kernel):
    text = _source("ssd.cu")
    body = _body(text, kernel + "(")
    assert re.search(r"\bwgmma_(ss|rs)_n\d+", body)
    assert kernel in _body(text, "int ssd_run_bf16(")


def test_the_ssd_computes_c_bt_once_per_group():
    """The output pass multiplies C B^T (an m64n128 product from two shared
    tiles) before its loop over the group's heads, and not inside it."""
    body = _body(_source("ssd.cu"), "ssd_output_wgmma_kernel(")
    loop = body.index("for (int j = 0; j < hpg; ++j)")
    assert "wgmma_ss_n128(" in body[:loop]
    assert "wgmma_ss_n128(" not in body[loop:]


def test_a_shared_header_change_rebuilds_every_source(tmp_path, monkeypatch):
    for path in glob.glob(os.path.join(CSRC, "*")):
        with open(path, "rb") as f:
            (tmp_path / os.path.basename(path)).write_bytes(f.read())
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    before = {n: _cuda._lib_path(n) for n in _cuda.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n// changed\n")
    after = {n: _cuda._lib_path(n) for n in _cuda.SOURCES}
    assert all(before[n] != after[n] for n in _cuda.SOURCES)


@pytest.mark.parametrize("launcher", ["int flash_attention_launch(",
                                      "int decode_attention_launch("])
def test_attention_launchers_take_every_head_dim(launcher):
    """Each launcher's switch instantiates every (D, Dv) pair the wrappers
    accept (80 for H2O-Danube, MLA's (96, 64) and (192, 128) among them),
    and nothing else."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    body = _body(_source("attention.cu"), launcher)
    cases = sorted((int(d), int(dv)) for d, dv in
                   re.findall(r"case PAIR\((\d+), (\d+)\):", body))
    assert cases == sorted(fa_kernel.HEAD_DIMS)
    assert {(80, 80), (96, 64), (192, 128)} <= set(cases)
    assert "default: return kBadShape;" in body


def test_decode_kernels_take_the_window():
    text = _source("attention.cu")
    for kernel in ("decode_attention_kernel(", "decode_attention_mma_kernel("):
        assert "live_rows(lengths[b], S, window, len, lo)" in _body(text,
                                                                   kernel)
