"""Dispatcher for the full-search ME kernel (``csrc/full_search.cu``), the
port of ``basic_video_codec_tpu/ops/pallas_me.py::_me_kernel``.

:func:`full_search` takes the arguments and returns the outputs of
``ops/me.full_search``.  For CUDA tensors it launches the hand-written
kernel, and raises on anything the kernel does not take.  For CPU tensors it
runs the plain PyTorch version, ``ops/me.full_search``.

The kernel is compiled with nvcc for ``sm_90a`` into the package's
``_build/`` directory at first use and called through ctypes on PyTorch's
current stream.
"""

import ctypes
import os
import shutil

import torch

from ..utils.build import build_shared
from . import me

# Kernel launches since the counter was last reset, by kernel name.  Only
# the launch below adds to it, so a run can show that it used the kernel.
LAUNCHES = {"full_search": 0}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build() -> str:
    """Compile the kernel library if it is missing or stale; return its path."""
    return build_shared(
        "csrc/full_search.cu", "libbvc_full_search.so",
        [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC"])


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        c_int, ptr = ctypes.c_int, ctypes.c_void_p
        lib.bvc_full_search.restype = c_int
        lib.bvc_full_search.argtypes = [ptr, ptr] + [c_int] * 6 + [ptr] * 4
        _lib = lib
    return _lib


def full_search(curr: torch.Tensor, refs: torch.Tensor, interp_refs,
                bs: int, search_range: int, frac: bool, n_valid: int | None = None):
    """Full search + MC prediction; see ``ops/me.full_search`` for the
    arguments and the ``(mvs, sad, pred)`` contract."""
    if curr.device.type == "cpu":
        return me.full_search(curr, refs, interp_refs, bs, search_range, frac,
                              n_valid)
    if curr.device.type != "cuda":
        raise ValueError(f"full_search runs on cuda or cpu, not {curr.device}")
    sr, planes = me.check_args(curr, refs, interp_refs, bs, search_range,
                               frac, n_valid)
    if not (curr.is_contiguous() and planes.is_contiguous()):
        raise ValueError("full_search kernel needs contiguous planes")
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    kw = dict(dtype=torch.int32, device=curr.device)
    mvs = torch.empty((nbr, nbc, 3), **kw)
    sad = torch.empty((nbr, nbc), **kw)
    pred = torch.empty((nbr, nbc, bs, bs), **kw)
    lib = _load()
    with torch.cuda.device(curr.device):
        err = lib.bvc_full_search(
            curr.data_ptr(), planes.data_ptr(),
            planes.shape[0] if n_valid is None else int(n_valid),
            h, w, bs, sr, int(frac), mvs.data_ptr(), sad.data_ptr(),
            pred.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"full_search kernel launch failed: CUDA error {err}")
    LAUNCHES["full_search"] += 1
    return mvs, sad, pred
