#!/usr/bin/env python3
"""The fused gram+Cholesky kernel against an earlier build of it, in turns
on one NVIDIA GPU, at the bucket shapes of ``chip_smoke.py``'s phase 2.

    python3 chip_fused_ab.py --parent DIR [--sweep]

``DIR`` holds a checkout of the commit to compare with (for example the
parent commit unpacked by ``git archive`` into a git-ignored directory of
the repo). Its ``deepstructuredmixtures_tpu_torch/csrc/fused_gram_cholesky.cu``
is built with the port's ``nvcc`` flags into ``DIR/build/kernels`` and
called through the C interface it had before the launch plan (one cluster
shape chosen inside the library, no ``cluster`` argument). Per shape, with
tied hypers, one JSON line: the times in the order earlier, this, this,
earlier (CUDA events, median of the runs), each build's max abs error
against float64 over the valid blocks, the plain version's, ``cholesky_ex``
on the ready gram (the factor alone) and the bound. ``--sweep`` also times
this kernel at every blocks-per-leaf count its launch plan could pick.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def build_earlier(root):
    """The earlier kernel's entry point, built from ``root``'s source."""
    from deepstructuredmixtures_tpu_torch.ops import build

    src = os.path.join(root, "deepstructuredmixtures_tpu_torch", "csrc",
                       "fused_gram_cholesky.cu")
    out_dir = os.path.join(root, "build", "kernels")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libfused_gram_cholesky_earlier.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib).dsm_fused_gram_cholesky
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, args, *extra):
    """``fn`` on the leaf batch ``args``: a new ``[L, N, N]`` output;
    ``extra`` goes between ``eps`` and the stream (this build's cluster)."""
    import torch

    from deepstructuredmixtures_tpu_torch.config import EPS

    x, n, logl, logsigma, noise = args
    L, N, D = x.shape
    out = torch.empty((L, N, N), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), n.data_ptr(), logl.data_ptr(), logsigma.data_ptr(),
             noise.data_ptr(), out.data_ptr(), L, N, D, EPS, *extra,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def valid_err(out, ref64, n):
    import torch

    N = out.shape[-1]
    ar = torch.arange(N, device=out.device)
    valid = ar[None, :] < torch.as_tensor(n, device=out.device)[:, None]
    v2 = valid[:, :, None] & valid[:, None, :]
    return float(torch.where(v2, (out.double() - ref64).abs(), 0.0).max())


def main():
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from deepstructuredmixtures_tpu_torch.kernels import gram
    from deepstructuredmixtures_tpu_torch.ops import build, fused_chol
    from deepstructuredmixtures_tpu_torch.ops.cholesky import masked_gram_noise

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", required=True,
                    help="checkout of the commit to compare with")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every blocks-per-leaf count")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_fused_ab.py: no CUDA device")
    card = cs.card_line()
    earlier = build_earlier(os.path.abspath(a.parent))
    this = build.load("fused_gram_cholesky", "dsm_fused_gram_cholesky",
                      fused_chol._ARGTYPES)
    sms = fused_chol.device_info("cuda")[0]
    # sums over the N=20k tree's shapes and the depth-4 tree's
    groups = {"n20000": cs.KERNEL_SHAPES[:3],
              "n100000_depth4": cs.KERNEL_SHAPES[5:13]}
    tot = {g: {"earlier_ms": 0.0, "this_ms": 0.0} for g in groups}
    for seed, (L, N) in enumerate(cs.KERNEL_SHAPES):
        n, args = cs._kernel_inputs(L, N, True, seed)
        plan = fused_chol.launch_plan(L, N, sms)
        reps = cs._reps(L, N)
        ref64 = fused_chol.fused_gram_cholesky_reference(
            *(t.double() if t.is_floating_point() else t for t in args))
        plain = fused_chol.fused_gram_cholesky_reference(*args)
        errs = {"earlier": valid_err(call(earlier, args), ref64, n),
                "this": valid_err(call(this, args, plan.blocks_per_leaf), ref64, n),
                "plain": valid_err(plain, ref64, n)}
        del ref64, plain
        runs = []
        for who in ("earlier", "this", "this", "earlier"):
            if who == "earlier":
                runs.append(cs.cuda_ms(lambda: call(earlier, args), reps=reps))
            else:
                runs.append(cs.cuda_ms(lambda: call(this, args, plan.blocks_per_leaf),
                                       reps=reps))
        x, nn, logl, logsigma, noise = args
        mask = torch.arange(N, device=x.device)[None, :] < nn[:, None]
        Kn = masked_gram_noise(gram("iso_se", logl[:, None], logsigma, x, x),
                               mask, noise, 1e-8)
        chol_ms = cs.cuda_ms(lambda: torch.linalg.cholesky_ex(Kn), reps=reps)
        del Kn
        sweep = {}
        if a.sweep:
            c = 1
            while c <= fused_chol.MAX_CLUSTER:
                sweep[str(c)] = cs.cuda_ms(lambda: call(this, args, c), reps=reps)
                c *= 2
        torch.cuda.empty_cache()
        b_ms, b_by, padded_ms = cs.fused_bounds(n, L, N)
        e_ms = (runs[0] + runs[3]) / 2
        t_ms = (runs[1] + runs[2]) / 2
        for g, shapes in groups.items():
            if (L, N) in shapes:
                tot[g]["earlier_ms"] += e_ms
                tot[g]["this_ms"] += t_ms
        print(json.dumps({
            "L": L, "N": N, "blocks_per_leaf": plan.blocks_per_leaf,
            "runs_ms_earlier_this_this_earlier": runs, "earlier_ms": e_ms,
            "this_ms": t_ms, "this_over_earlier": t_ms / e_ms,
            "max_abs_err_vs_f64": errs, "cholesky_ex_factor_only_ms": chol_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bound_padded_ms": padded_ms,
            "sweep_ms_by_blocks_per_leaf": sweep, "card": card}), flush=True)
    print(json.dumps({"sum": tot, "card": card}), flush=True)


if __name__ == "__main__":
    main()
