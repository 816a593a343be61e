"""ctypes loader for the native host library (``native/libdsmhost.so``).

The subset of ``deepstructuredmixtures_tpu/utils/native.py`` that the
fit/predict path uses: half-open box routing of test points (≙
``getchild``, ``common.jl:101-122``), routed-index packing and the ragged
to padded leaf packer. Host C++, shared with the JAX package; each
function has a NumPy fallback for when the library is missing or does not
load.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
#: optional symbols whose argtypes registration succeeded — a symbol absent
#: from a stale library must take the NumPy fallback
_PACK_SYMS: set = set()


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.path.join(here, "native", "libdsmhost.so")
    return path if os.path.exists(path) else None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.dsm_route_box.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.dsm_route_box.restype = None
        lib.dsm_pack_routes.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.dsm_pack_routes.restype = None
        for name, valt in (("dsm_pack_leaves_f32", ctypes.c_float),
                           ("dsm_pack_leaves_f64", ctypes.c_double)):
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(valt),
                ctypes.POINTER(valt), ctypes.POINTER(ctypes.c_uint8),
            ]
            fn.restype = None
            _PACK_SYMS.add(name)
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def route_box(xt: np.ndarray, lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """Membership [T, L]: ``all(lb < x <= ub)`` per (point, leaf)."""
    xt = np.ascontiguousarray(xt, dtype=np.float64)
    lb = np.ascontiguousarray(lb, dtype=np.float64)
    ub = np.ascontiguousarray(ub, dtype=np.float64)
    T, D = xt.shape
    L = lb.shape[0]
    lib = get_lib()
    if lib is None:
        ok = (xt[:, None, :] > lb[None]) & (xt[:, None, :] <= ub[None])
        return np.all(ok, axis=-1)
    out = np.zeros((T, L), dtype=np.uint8)
    lib.dsm_route_box(_ptr(xt, ctypes.c_double), T, D,
                      _ptr(lb, ctypes.c_double), _ptr(ub, ctypes.c_double), L,
                      _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def pack_routes(member: np.ndarray, tmax: int):
    """Per-leaf padded test indices ``(tidx int32, tmask bool) [L, tmax]``
    from a [T, L] membership matrix."""
    T, L = member.shape
    lib = get_lib()
    if lib is None:
        tidx = np.zeros((L, tmax), dtype=np.int32)
        tmask = np.zeros((L, tmax), dtype=bool)
        memT = member.T
        for l in range(L):
            idx = np.where(memT[l])[0]
            tidx[l, : idx.size] = idx
            tmask[l, : idx.size] = True
        return tidx, tmask
    mem = np.ascontiguousarray(member, dtype=np.uint8)
    tidx = np.zeros((L, tmax), dtype=np.int32)
    tmask = np.zeros((L, tmax), dtype=np.uint8)
    lib.dsm_pack_routes(_ptr(mem, ctypes.c_uint8), T, L, tmax,
                        _ptr(tidx, ctypes.c_int32), _ptr(tmask, ctypes.c_uint8))
    return tidx, tmask.astype(bool)


def pack_leaves(obs_list, nmax: int, X: np.ndarray, y: np.ndarray, npdt):
    """Ragged to padded leaf packing: each leaf's training rows gathered
    into zeroed ``[Lb, nmax, D]`` / ``[Lb, nmax]`` blocks of dtype ``npdt``
    with a validity mask, parallel over leaves. Returns ``(xb, yb, mb,
    lens_i32)``, or ``None`` when the native library (or the dtype's
    variant) is unavailable — the caller then takes the NumPy path."""
    lib = get_lib()
    npdt = np.dtype(npdt)
    fname = {"float32": "dsm_pack_leaves_f32",
             "float64": "dsm_pack_leaves_f64"}.get(npdt.name)
    if lib is None or fname is None or fname not in _PACK_SYMS:
        return None
    Lb = len(obs_list)
    D = X.shape[1]
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    lens = np.fromiter((o.size for o in obs_list), dtype=np.int64, count=Lb)
    if Lb and int(lens.max()) > nmax:
        # the C++ packer would write past its row block
        raise ValueError(
            f"pack_leaves: leaf size {int(lens.max())} exceeds nmax={nmax}")
    starts = np.zeros(Lb, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    obs = (np.ascontiguousarray(np.concatenate(obs_list), dtype=np.int64)
           if Lb else np.zeros(0, dtype=np.int64))
    if y.shape[0] != X.shape[0]:
        raise ValueError(
            f"pack_leaves: y has {y.shape[0]} rows, X has {X.shape[0]}")
    if obs.size and (int(obs.min()) < 0 or int(obs.max()) >= X.shape[0]):
        raise ValueError("pack_leaves: observation index out of range")
    xb = np.zeros((Lb, nmax, D), dtype=npdt)
    yb = np.zeros((Lb, nmax), dtype=npdt)
    mb = np.zeros((Lb, nmax), dtype=np.uint8)
    valt = ctypes.c_float if npdt.name == "float32" else ctypes.c_double
    getattr(lib, fname)(
        _ptr(X, ctypes.c_double), _ptr(y, ctypes.c_double), D,
        _ptr(obs, ctypes.c_int64), _ptr(starts, ctypes.c_int64),
        _ptr(lens, ctypes.c_int64), Lb, nmax,
        _ptr(xb, valt), _ptr(yb, valt), _ptr(mb, ctypes.c_uint8),
    )
    return xb, yb, mb.view(bool), lens.astype(np.int32)
