"""Builds the port's hand-written CUDA kernels and loads them with ctypes.

All sources under paddle3d_tpu_torch/csrc/ compile with nvcc, for Hopper
(`sm_90a`), one nvcc process per source, all started together, and link
into ONE shared library with a plain C interface under build/torch_kernels/
at the repository root (git-ignored). The library's name carries a hash of
the sources, headers and flags, so an edited source builds anew on first
use and a stale library is never loaded. No PyTorch header is included, so
a build takes seconds, not the minutes of torch.utils.cpp_extension.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no CUDA toolkit.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "reset_launches", "library", "function", "check",
           "stream_ptr"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper; each wrapper adds one where it launches
LAUNCHES = {"fused_pfn_rows": 0, "fused_pfn_rows_2l": 0,
            "sorted_segment_sum": 0, "pfn_stats": 0, "pfn_bwd": 0,
            "sorted_table_gather": 0, "sorted_segment_sum_cm": 0,
            "sorted_segment_sum_dense": 0, "sparse_conv3d": 0,
            "sparse_conv3d_map": 0,
            "ball_query": 0, "farthest_point_sample": 0,
            "seg_window_max": 0, "seg_window_max_bwd": 0,
            "pairwise_intersection_area": 0, "sorted_segment_sum_rw": 0,
            "gather_rows": 0}

_vp, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
# argtypes of every exported function (pointers and the stream as void*, or
# ctypes would pass them as 32-bit ints)
_SIGNATURES = {
    "p3d_sorted_segment_sum": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp),
    "p3d_fused_pfn_rows": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                           _i, _i, _i, _f, _f, _f, _f, _i, _i, _vp),
    "p3d_fused_pfn2_rows": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _i,
                            _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f, _i,
                            _i, _vp),
    "p3d_pfn_stats": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i,
                      _i, _f, _f, _f, _f, _i, _vp),
    "p3d_pfn_bwd": (_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _ll, _ll,
                    _vp, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _f, _f, _f,
                    _i, _vp),
    "p3d_sorted_table_gather": (_vp, _vp, _ll, _ll, _ll, _vp, _ll, _ll, _vp,
                                _i, _i, _i, _i, _i, _vp),
    "p3d_sorted_segment_sum_cm": (_vp, _vp, _ll, _ll, _ll, _vp, _vp, _i, _i,
                                  _i, _i, _vp),
    "p3d_sorted_segment_sum_dense": (_vp, _vp, _vp, _vp, _i, _i, _i, _i,
                                     _vp),
    "p3d_sparse_conv_map": (_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp),
    "p3d_sparse_conv3d": (_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                          _i, _i, _i, _vp),
    "p3d_ball_query": (_vp, _vp, _vp, _vp, _vp, _vp, _f, _i, _i, _i, _i,
                       _vp),
    "p3d_farthest_point_sample": (_vp, _vp, _vp, _vp, _i, _i, _i, _vp),
    "p3d_farthest_point_sample_cluster": (_vp, _vp, _vp, _vp, _i, _i, _i, _i,
                                          _vp),
    "p3d_farthest_point_sample_plan": (_i, _i, _i, _vp),
    "p3d_seg_window_max": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp),
    "p3d_seg_window_max_bwd": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                               _vp),
    "p3d_pairwise_intersection_area": (_vp, _vp, _vp, _i, _i, _i, _vp),
    "p3d_sorted_segment_sum_rw": (_vp, _vp, _ll, _ll, _ll, _vp, _i, _i, _i,
                                  _i, _vp),
    "p3d_gather_rows": (_vp, _ll, _ll, _ll, _vp, _vp, _i, _i, _i, _i, _vp),
}

_lib = None
#: the exported functions, bound once when the library loads
_functions = {}
#: nvcc's output of the build this process ran (ptxas registers / smem)
build_log = ""


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(files) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / "libp3d_kernels_{}.so".format(h.hexdigest()[:16])


def _run(cmds):
    """Run the commands together; -> their joined output. Raises on the
    first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}".format(" ".join(cmd),
                                                               log))
    return "".join(logs)


def _build(sources, target: Path):
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile into a private directory and link to a private name, then
    # rename: concurrent builders never load a half-written library
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    tmp = work / target.name
    nvcc = _nvcc()
    objs = [work / (src.stem + ".o") for src in sources]
    try:
        build_log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                          for src, obj in zip(sources, objs)])
        build_log += _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)]])
        os.replace(tmp, target)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        sources = sorted(CSRC.glob("*.cu"))
        path = _lib_path(sources + sorted(CSRC.glob("*.cuh")))
        if not path.exists():
            _build(sources, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _functions[name] = fn
        lib.p3d_error_string.argtypes = (ctypes.c_int,)
        lib.p3d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def function(name: str):
    """The exported function `name` of the library (built and bound on
    first use): one dict lookup a call after that."""
    fn = _functions.get(name)
    if fn is None:
        library()
        fn = _functions[name]
    return fn


def check(err: int, name: str):
    """Raise if a launch reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError("CUDA kernel {} failed: {} ({})".format(
            name, library().p3d_error_string(err).decode(), err))


def stream_ptr(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on `device`. Every public
    route builds a torch.cuda.Stream; given the device index as an int,
    current_stream skips the parsing of a torch.device, the larger part of
    its host cost (chip_smoke.py phase 12 times both)."""
    return torch.cuda.current_stream(device.index).cuda_stream
