"""ctypes bridge to the repo's optional C++ host library (native/libjetpbrt.so,
built with `make -C native`): OBJ parsing and the binned-SAH BVH build.

Counterpart of jet_pbrt_tpu/utils/native.py over the same library, so the
port builds the same BVH as the reference package wherever the library is
built. Without it both packages take their numpy paths.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "native", "libjetpbrt.so"))
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_longlong)
_LIB: list = []     # [lib or None] once tried


def _lib():
    if not _LIB:
        lib = None
        if os.path.exists(LIB_PATH):
            try:
                lib = ctypes.CDLL(LIB_PATH)
            except OSError:
                lib = None
        if lib is not None:
            lib.jp_obj_count.restype = ctypes.c_longlong
            lib.jp_obj_count.argtypes = [ctypes.c_char_p]
            lib.jp_obj_load.restype = ctypes.c_longlong
            lib.jp_obj_load.argtypes = [ctypes.c_char_p, _F32P, _F32P,
                                        ctypes.c_longlong]
            lib.jp_bvh_build.restype = ctypes.c_longlong
            lib.jp_bvh_build.argtypes = [
                _F32P, _F32P, _F32P, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, _F32P, _F32P, _I32P, _I32P, _I32P, _I64P, _I64P]
        _LIB.append(lib)
    return _LIB[0]


def native_available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def try_load_obj_native(path: str):
    """(tris [T,3,3], uvs [T,3,2]) float32, or None without the library."""
    lib = _lib()
    if lib is None:
        return None
    n = lib.jp_obj_count(path.encode())
    if n < 0:
        return None
    tris = np.zeros((n, 3, 3), np.float32)
    uvs = np.zeros((n, 3, 2), np.float32)
    if lib.jp_obj_load(path.encode(), _ptr(tris, _F32P), _ptr(uvs, _F32P),
                       n) != n:
        return None
    return tris, uvs


def try_build_bvh_native(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                         leaf_size: int, use_sah: bool):
    """Binned-SAH BVH build (native/bvh_build.cc): ((bmin, bmax, miss,
    leaf_first, leaf_count), order) as the numpy builder emits them, or
    None without the library."""
    lib = _lib()
    if lib is None:
        return None
    t = len(p0)
    cap = 2 * t + 2
    bmin = np.zeros((cap, 3), np.float32)
    bmax = np.zeros((cap, 3), np.float32)
    miss, leaf_first, leaf_count = (np.zeros((cap,), np.int32)
                                    for _ in range(3))
    order = np.zeros((4 * t + 4 * leaf_size,), np.int64)
    order_len = ctypes.c_longlong(0)
    p0, p1, p2 = (np.ascontiguousarray(p, np.float32) for p in (p0, p1, p2))
    k = int(lib.jp_bvh_build(
        _ptr(p0, _F32P), _ptr(p1, _F32P), _ptr(p2, _F32P), t, leaf_size,
        int(use_sah), _ptr(bmin, _F32P), _ptr(bmax, _F32P), _ptr(miss, _I32P),
        _ptr(leaf_first, _I32P), _ptr(leaf_count, _I32P), _ptr(order, _I64P),
        ctypes.byref(order_len)))
    if k <= 0:
        return None
    return ((bmin[:k].copy(), bmax[:k].copy(), miss[:k].copy(),
             leaf_first[:k].copy(), leaf_count[:k].copy()),
            order[:order_len.value].copy())
