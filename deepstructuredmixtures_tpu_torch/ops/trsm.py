"""Forward solve and moments of the float64 predicts: the CUDA kernel
``csrc/trsm_moments.cu`` and its plain PyTorch version.

The predicts solve ``Z = L^{-1} [y | K_nt]`` in float64 against float32
factors and reduce ``V = Z[:, 1:]`` against ``z = Z[:, 0]`` at once: the
mean needs ``V'z`` and the variance ``||V||²`` per test point
(``fit._moments``, ``fit.cached_leaf_predict``,
``fit.bucketed_hybrid_predict``). :func:`forward_solve_moments` does the
three for a table of leaves, given as factor and right-hand-side tensors
of any number of size buckets, in one launch: every element turned into
float64 in registers (exact), the solve and both sums in float64, with no
float64 copy of a factor. It replaces no TPU kernel (the JAX package
leaves the solve to XLA); the kernel's design note is at the top of its
source.

The kernel is built and loaded by ``ops/build.py``. On a CPU tensor
:func:`forward_solve_moments` runs :func:`forward_solve_moments_reference`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build

#: rows of a row block (and of a diagonal block) of the kernel
ROWS = 64
#: columns of a column tile of the kernel: ``y`` and up to ``TILE - 1``
#: columns of ``K_nt``
TILE = 72

#: kernel launches so far (one per call of the CUDA path)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def column_tiles(width: int):
    """``(tiles, per_tile)`` for a right-hand side of ``width`` columns
    (``y`` and ``width - 1`` columns of ``K_nt``): as few tiles of
    :data:`TILE` columns as hold them, the ``K_nt`` columns spread evenly
    over them (``per_tile`` each, the last fewer)."""
    t = width - 1
    tiles = max(1, -(-t // (TILE - 1)))
    return tiles, -(-t // tiles)


def forward_solve_moments_reference(factors, rhs, want_z: bool = False):
    """Plain PyTorch version: per entry the float64 cast, the triangular
    solve and the two reductions, as the predicts computed them before the
    kernel."""
    vz, vv, zs = [], [], []
    for Lf, B in zip(factors, rhs):
        Z = torch.linalg.solve_triangular(Lf.double(), B.double(), upper=False)
        z, V = Z[..., 0], Z[..., 1:]
        vz.append(torch.einsum("lnt,ln->lt", V, z))
        vv.append(torch.sum(V * V, dim=-2))
        zs.append(z)
    return torch.cat(vz), torch.cat(vv), (zs if want_z else None)


def _check(factors, rhs):
    if len(factors) != len(rhs) or not factors:
        raise ValueError("need one right-hand side per factor tensor, and at least one")
    F0, B0 = factors[0], rhs[0]
    if F0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"factors must be float32 or float64, got {F0.dtype}")
    width = B0.shape[-1]
    for Lf, B in zip(factors, rhs):
        if Lf.ndim != 3 or Lf.shape[1] != Lf.shape[2]:
            raise ValueError(f"a factor must be [L, n, n], got {tuple(Lf.shape)}")
        if B.shape != (Lf.shape[0], Lf.shape[1], width):
            raise ValueError(f"right-hand side {tuple(B.shape)} does not fit factor "
                             f"{tuple(Lf.shape)} with {width} columns")
        if Lf.dtype != F0.dtype or B.dtype != F0.dtype:
            raise TypeError("factors and right-hand sides must share one dtype")
        if Lf.device != F0.device or B.device != F0.device:
            raise ValueError("factors and right-hand sides must share one device")
        if not (Lf.is_contiguous() and B.is_contiguous()):
            raise ValueError("factors and right-hand sides must be contiguous")
        if (Lf.device.type == "cuda"
                and (Lf.shape[1] * Lf.element_size() % 16 or Lf.data_ptr() % 16)):
            raise ValueError("the kernel copies a factor's rows 16 bytes at a time: "
                             f"n={Lf.shape[1]} times {Lf.element_size()} bytes must be a "
                             "multiple of 16, and the factor 16-byte aligned")
    return width


class Plan(NamedTuple):
    """What one launch is handed (:func:`launch_plan`): the leaf table
    (``[leaves, 8]`` int64: factor address, right-hand-side address, n,
    workspace, flag and partial-sum offsets, z address or 0, output row),
    the ticket order (one code ``leaf << 32 | row block << 16 | tile`` per
    thread block, every producer first), the column tiling
    (:func:`column_tiles`) and the sizes of the float64 workspace and
    partial sums and of the flags."""

    table: np.ndarray
    order: np.ndarray
    tiles: int
    per_tile: int
    ws_size: int
    part_size: int
    n_flags: int


def _starts(sizes):
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)


def launch_plan(factors, rhs, zs=None) -> Plan:
    """The kernel's :class:`Plan` for the entries ``factors``, ``rhs``
    (as :func:`forward_solve_moments` takes them) and, if given, the
    float64 ``z`` outputs ``zs`` (one ``[L, n]`` per entry)."""
    width = rhs[0].shape[-1]
    size = factors[0].dtype.itemsize
    tiles, per_tile = column_tiles(width)
    counts = [Lf.shape[0] for Lf in factors]
    n = np.concatenate([np.full(c, Lf.shape[1], np.int64) for c, Lf in zip(counts, factors)])
    nb = -(-n // ROWS)
    if int(nb.max(initial=0)) >= 1 << 16 or tiles >= 1 << 16:
        raise ValueError("a leaf or the width is beyond the kernel's 16-bit block codes")
    local = np.concatenate([np.arange(c, dtype=np.int64) for c in counts])
    ws_rows = tiles * nb * ROWS * TILE
    part_rows = tiles * nb * 2 * TILE
    table = np.zeros((n.size, 8), np.int64)
    table[:, 0] = np.repeat([Lf.data_ptr() for Lf in factors], counts) + local * n * n * size
    table[:, 1] = np.repeat([B.data_ptr() for B in rhs], counts) + local * n * width * size
    table[:, 2] = n
    table[:, 3] = _starts(ws_rows)
    table[:, 4] = _starts(tiles * nb)
    table[:, 5] = _starts(part_rows)
    if zs is not None:
        table[:, 6] = np.repeat([z.data_ptr() for z in zs], counts) + local * n * 8
    table[:, 7] = np.arange(n.size)
    # row block major across the leaves: block i of every leaf, then i + 1
    leaf = np.repeat(np.arange(n.size, dtype=np.int64), nb)
    block = np.arange(leaf.size, dtype=np.int64) - np.repeat(_starts(nb), nb)
    first = np.lexsort((leaf, block))
    code = (leaf[first] << 32) | (block[first] << 16)
    order = (code[:, None] | np.arange(tiles, dtype=np.int64)[None, :]).ravel()
    return Plan(table, order, tiles, per_tile, int(ws_rows.sum()),
                int(part_rows.sum()), int(np.sum(tiles * nb)))


def forward_solve_moments(factors, rhs, want_z: bool = False):
    """Per leaf of every entry: ``Z = L^{-1} B`` in float64, ``z = Z[:,
    0]``, ``V = Z[:, 1:]``; returns ``(vz, vv, zs)`` with ``vz = V'z`` and
    ``vv = ||V||²`` (float64 ``[ΣL, width - 1]``, the entries' leaves in
    order) and, with ``want_z``, ``zs`` a list of float64 ``[L, n]`` per
    entry (else ``None``).

    ``factors``: lower factors ``[L, n, n]`` (n may differ between
    entries; identity padding allowed), ``rhs``: ``[L, n, width]``, one
    ``width`` for all, both float32 or both float64. On CUDA they must be
    contiguous, and a factor 16-byte aligned with ``n`` a multiple of 4
    (float32) or 2 (float64), as every bucket's is; the whole table is one
    launch, on the current stream."""
    global LAUNCHES
    width = _check(factors, rhs)
    dev = factors[0].device
    if dev.type == "cpu":
        return forward_solve_moments_reference(factors, rhs, want_z)
    if dev.type != "cuda":
        raise ValueError(f"forward_solve_moments: unsupported device {dev}")
    dt = factors[0].dtype
    nl = sum(Lf.shape[0] for Lf in factors)
    zs = ([torch.empty(Lf.shape[:2], dtype=torch.float64, device=dev) for Lf in factors]
          if want_z else None)
    vz = torch.empty((nl, width - 1), dtype=torch.float64, device=dev)
    vv = torch.empty_like(vz)
    if nl == 0:
        return vz, vv, zs
    plan = launch_plan(factors, rhs, zs)
    meta = torch.from_numpy(np.concatenate([plan.table.ravel(), plan.order])).to(
        dev, non_blocking=True)
    ws = torch.empty(plan.ws_size, dtype=torch.float64, device=dev)
    part = torch.empty(plan.part_size, dtype=torch.float64, device=dev)
    flags = torch.empty(plan.n_flags + 1, dtype=torch.int32, device=dev)
    fn = build.load("trsm_moments", "dsm_trsm_moments", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(meta.data_ptr(), meta.data_ptr() + plan.table.nbytes, int(plan.order.size),
                 0 if dt == torch.float32 else 1, width, width - 1, plan.per_tile,
                 ws.data_ptr(), part.data_ptr(), flags.data_ptr(),
                 plan.n_flags, vz.data_ptr(), vv.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"forward_solve_moments: CUDA error {err} at launch")
    LAUNCHES += 1
    return vz, vv, zs
