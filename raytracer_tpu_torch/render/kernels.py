"""Build and bind the port's CUDA kernels (``csrc/raytrace.cu``).

The kernels are compiled with ``nvcc`` straight into a shared library with
a plain C interface and bound with ``ctypes``: no PyTorch headers, so the
build takes seconds. The library is built at first use into
``raytracer_tpu_torch/_build/``, keyed by a hash of the sources and flags,
and reused while they are unchanged. A failed build, a missing library or
a non-zero launch status raises; nothing falls back to the plain versions.
Every wrapper launches through ``launch``: with the tensors' card made
current and on that card's current stream, so that tensors on any card of
a machine with several are launched from their own card's context.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded, as
the plain PyTorch versions compute them, so triangle-edge accepts and t
agree; no fast math, so division and sqrt stay IEEE (the slab test relies
on 1/0 = inf).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
SOURCES = ("raytrace.cu", "raytrace.cuh")
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TABLES = [_P] * 6 + [_I] * 3   # 6 table pointers + m, n_other, n_sph
_SIGNATURES = {
    "rt_wholeframe": _TABLES + [_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                                _I, _F, _F, _I, _I, _I, _P, _P],
    "rt_closest_hit": _TABLES + [_P, _P, _P, _I, _P, _P, _I, _I, _P, _P],
    "rt_fused": _TABLES + [_P, _P, _P, _I, _F, _P, _P, _P, _I, _P, _P],
    "rt_closest_attrs": _TABLES + [_P, _P, _I, _P, _P, _P, _I, _P, _P],
    "rt_resolve": [_P, _I, _P, _P, _I, _P, _P],
    "rt_packet": [_P] * 5 + [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P],
    "rt_brute": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P,
                 _P],
    "rt_gather_rows": [_P, _I, _I, _P, _I, _P, _P],
    "rt_row_grads": [_P, _P, _I, _P, _I, _I, _P, _P, _P],
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin)")


def _source_key(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + (nvcc,)).encode())
    return h.hexdigest()[:16]


def build(force: bool = False):
    """Compile the kernels if the library for the current sources is
    missing. Returns (library path, nvcc's log, seconds spent)."""
    nvcc = find_nvcc()
    key = _source_key(nvcc)
    lib = BUILD_DIR / f"raytrace-{key}.so"
    log = BUILD_DIR / f"raytrace-{key}.log"
    if lib.exists() and not force:
        return lib, log.read_text() if log.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / "raytrace.cu")],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    log.write_text(proc.stdout + proc.stderr)
    return lib, log.read_text(), time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {status}")


def check_tensor(name: str, x: torch.Tensor, dtype, device, shape=None):
    """Raise unless ``x`` is a contiguous tensor of ``dtype`` on ``device``
    (and of ``shape``, where a dimension of None matches any size), with
    16-byte-aligned storage."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None and (len(shape) != x.dim() or any(
            s is not None and s != d for s, d in zip(shape, x.shape))):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.numel() and x.data_ptr() % 16:
        raise ValueError(f"{name}: storage not 16-byte aligned")


def table_args(split, device):
    """The SplitScene tables as kernel arguments, after checking them."""
    m, n_other = split.m, split.n_other
    check_tensor("leaf_start", split.leaf_start, torch.int32, device, (None,))
    check_tensor("leaf_count", split.leaf_count, torch.int32, device, (None,))
    check_tensor("skip", split.skip, torch.int32, device, (None,))
    check_tensor("nodes", split.nodes, torch.float32, device, (None, 8))
    check_tensor("pre_rows", split.pre_rows, torch.float32, device,
                 (None, 40))
    check_tensor("tri_rows", split.tri_rows, torch.float32, device,
                 (None, 36))
    if min(split.leaf_start.shape[0], split.leaf_count.shape[0],
           split.skip.shape[0], split.nodes.shape[0]) < m:
        raise ValueError(f"tree tables shorter than m={m}")
    if split.pre_rows.shape[0] < n_other or not 0 <= split.n_sph <= n_other:
        raise ValueError("pre_rows do not hold n_other rows")
    if split.tri_rows.shape[0] < split.n_tri:
        raise ValueError("tri_rows do not hold n_tri rows")
    return [split.leaf_start.data_ptr(), split.leaf_count.data_ptr(),
            split.skip.data_ptr(), split.nodes.data_ptr(),
            split.pre_rows.data_ptr(), split.tri_rows.data_ptr(),
            m, n_other, split.n_sph]


def device_guard(device):
    """The context in which work for ``device`` is issued: on a CUDA
    device, that device made current (the library launches on the
    calling thread's current device); on the CPU, nothing."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def launch(name: str, fn: str, device, *args) -> None:
    """Call the library's launcher ``fn`` with ``args`` and ``device``'s
    current stream, with ``device`` current, and raise if kernel
    ``name`` did not launch. Every wrapper launches through here, so a
    tensor on any card is launched from that card's context."""
    with device_guard(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(library(), fn)(*args, stream)
    check_status(name, status)
