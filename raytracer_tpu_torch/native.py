"""ctypes bindings for the native scene-prep runtime (port of
``raytracer_tpu/native.py`` onto the same source, native/scene_prep.cpp).

The shared library is built with g++ at first use into
``raytracer_tpu_torch/_build/``, keyed by a hash of the source and flags
(a temporary file renamed into place, so concurrent processes never load
a half-written library). Where no toolchain or source is found,
``available()`` is False and callers use the pure-Python builders, whose
outputs are identical. This is host code; no device is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parent
_SOURCE = _PACKAGE_DIR.parent / "native" / "scene_prep.cpp"
_BUILD_DIR = _PACKAGE_DIR / "_build"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lib_tried = False


def _build() -> Path:
    """The library for the current source, compiled if missing."""
    key = hashlib.sha256(_SOURCE.read_bytes()
                         + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libsceneprep-{key}.so"
    if not lib.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o",
                        str(tmp), str(_SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rt_bvh_build.restype = ctypes.c_void_p
    lib.rt_bvh_build.argtypes = [f32p, f32p, f32p, ctypes.c_int, ctypes.c_int]
    lib.rt_bvh_num_nodes.restype = ctypes.c_int
    lib.rt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_num_indices.restype = ctypes.c_int
    lib.rt_bvh_num_indices.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_subtree_total.restype = ctypes.c_int64
    lib.rt_bvh_subtree_total.argtypes = [ctypes.c_void_p]
    lib.rt_bvh_get.restype = None
    lib.rt_bvh_get.argtypes = [ctypes.c_void_p, f32p, f32p, i32p, i32p, i32p,
                               i32p, i32p, i64p, i32p]
    lib.rt_bvh_linearize.restype = None
    lib.rt_bvh_linearize.argtypes = [ctypes.c_void_p, f32p, i32p, i32p, i32p,
                                     i32p]
    lib.rt_bvh_free.restype = None
    lib.rt_bvh_free.argtypes = [ctypes.c_void_p]
    lib.rt_obj_load.restype = ctypes.c_void_p
    lib.rt_obj_load.argtypes = [ctypes.c_char_p]
    lib.rt_obj_num_tris.restype = ctypes.c_int
    lib.rt_obj_num_tris.argtypes = [ctypes.c_void_p]
    lib.rt_obj_get.restype = None
    lib.rt_obj_get.argtypes = [ctypes.c_void_p, f32p]
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def build_bvh_native(mins: np.ndarray, maxs: np.ndarray, centers: np.ndarray,
                     max_depth: int):
    """Native median-split build. Returns the same tuple layout the Python
    builder produces: (bounds_min, bounds_max, left, right, start, count,
    indices, node_shapes) with root last."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scene-prep library unavailable")
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    centers = np.ascontiguousarray(centers, np.float32)
    n = mins.shape[0]
    h = lib.rt_bvh_build(_f32p(mins), _f32p(maxs), _f32p(centers), n,
                         int(max_depth))
    try:
        m = lib.rt_bvh_num_nodes(h)
        k = lib.rt_bvh_num_indices(h)
        sub_total = lib.rt_bvh_subtree_total(h)
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        left = np.empty(m, np.int32)
        right = np.empty(m, np.int32)
        start = np.empty(m, np.int32)
        count = np.empty(m, np.int32)
        indices = np.empty(k, np.int32)
        sub_ptr = np.empty(m + 1, np.int64)
        sub_idx = np.empty(sub_total, np.int32)
        lib.rt_bvh_get(h, _f32p(bmin), _f32p(bmax), _i32p(left), _i32p(right),
                       _i32p(start), _i32p(count), _i32p(indices),
                       sub_ptr.ctypes.data_as(
                           ctypes.POINTER(ctypes.c_int64)),
                       _i32p(sub_idx))
        node_shapes = [sub_idx[sub_ptr[i]:sub_ptr[i + 1]].astype(np.int64)
                       for i in range(m)]
        return bmin, bmax, left, right, start, count, indices, node_shapes
    finally:
        lib.rt_bvh_free(h)


def linearize_native(mins: np.ndarray, maxs: np.ndarray, centers: np.ndarray,
                     max_depth: int, num_shapes: int):
    """Build + DFS-linearize in one native pass. Returns (bounds6,
    leaf_start, leaf_count, skip, perm) numpy arrays."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scene-prep library unavailable")
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    centers = np.ascontiguousarray(centers, np.float32)
    h = lib.rt_bvh_build(_f32p(mins), _f32p(maxs), _f32p(centers),
                         mins.shape[0], int(max_depth))
    try:
        m = lib.rt_bvh_num_nodes(h)
        bounds6 = np.empty((m, 6), np.float32)
        leaf_start = np.empty(m, np.int32)
        leaf_count = np.empty(m, np.int32)
        skip = np.empty(m, np.int32)
        perm = np.empty(num_shapes, np.int32)
        lib.rt_bvh_linearize(h, _f32p(bounds6), _i32p(leaf_start),
                             _i32p(leaf_count), _i32p(skip), _i32p(perm))
        return bounds6, leaf_start, leaf_count, skip, perm
    finally:
        lib.rt_bvh_free(h)


def load_obj_native(path: str) -> np.ndarray:
    """Native OBJ triangle load, (T, 3, 3) f32 (all objects concatenated)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native scene-prep library unavailable")
    h = lib.rt_obj_load(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        t = lib.rt_obj_num_tris(h)
        tris = np.empty((t, 3, 3), np.float32)
        if t:
            lib.rt_obj_get(h, _f32p(tris))
        return tris
    finally:
        lib.rt_obj_free(h)
