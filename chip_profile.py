#!/usr/bin/env python3
"""Where the device time goes in the port's cells, on one NVIDIA GPU.

    python3 chip_profile.py [--n 100000] [--depth D] [--refine-steps K]
                            [--float64] [--train] [--mesh]
                            [--family poe|mixture|config5]

Without ``--depth``: builds the headline model (V=3, K=4, M=30, depth 2,
IsoSE(0, 0), log noise -1, seed 0, float32) on ``--n`` points, fits it once
with ``fit(store='hybrid')`` (every bucket cached) to build the kernels,
then runs under ``torch.profiler`` (CPU + CUDA activities): one more hybrid
fit, and one cached ``predict`` at T=1 and T=2000.

With ``--depth D``, ``--refine-steps K`` or ``--float64``: the same model
(on a tree of depth D, default 2; in float64 with ``--float64``), and the
streamed pipeline of the benchmark (``bucketed_streamed_predict`` with K
refinement steps → ``update_weights`` → ``_routed_moment_match`` at
T=2000), run once to warm up and once under the profiler.

With ``--train``: one training gradient of the model (float64 with
``--float64``) by the route ``train`` takes (``train._train_vg``: the
per-bucket route at N=100k), run once to warm up and once under the
profiler.

With ``--mesh``: one ``fit(mesh=...)`` of the model in a world of one rank
under NCCL, with ``chip_smoke.py``'s giant-leaf budget and panel (the
leaves above the budget on the distributed Cholesky, the rest the light
fit), run once to warm up and once under the profiler.

With ``--family``: one warm call of another model family's pipeline, as
``chip_smoke.py`` builds it: ``poe`` (phase 13: ``fit_naive`` → fused
``predict`` at T=2000 of ``build_poe``, 2,048 experts at N=100k),
``mixture`` (phase 14: the streamed ``fit`` → ``update`` → routed
``predict`` of the IsoSE / ArdSE / IsoLinear mixture) or ``config5``
(phase 15: the same pipeline on the 4-D ArdSE model after its warm start).

For each profiled call, one JSON line: the wall-clock, the device time
summed over all kernels, split by what the kernels do (the fused
gram+Cholesky kernel; the blocked Cholesky kernel's four CUDA kernels,
first diagonal block of an outer panel / panel step with the next diagonal
block / lookahead update / trailing update, with the count of panel steps;
cuSOLVER's Cholesky; the triangular solves; matrix products; the rest, the
gram and masking passes and copies), and the kernels with the most device
time. The blocked kernel overlaps its serial chain with its trailing
update on two streams, so the sum of its kernels' times exceeds the time
it holds the card. Needs a CUDA device; prints nothing else.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

#: the CUDA kernels of csrc/blocked_cholesky.cu, by what they do
BLOCKED = {"diagonal": "diag_inv_kernel", "panel": "panel_kernel",
           "lookahead_update": "lookahead_update_kernel",
           "trailing_update": "trailing_update_kernel"}
#: the other groups of kernels, by a part of their names (lower case),
#: taken in this order; what matches none is "other"
GROUPS = {"fused_gram_cholesky": ("fused_gram_cholesky",),
          # cuSOLVER's potrf runs large matrices through unpivoted LU
          # kernels (getrf_wo_pivot) and cuBLAS syrk; nothing else here
          # calls an LU or a syrk
          "cholesky_cusolver": ("potrf", "chol", "getrf", "syrk"),
          "triangular_solves": ("trsm", "trsv"),
          "matrix_products": ("gemm", "cutlass", "xmma")}


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(key):
    if any(name in key for name in BLOCKED.values()):
        return "blocked_cholesky"
    low = key.lower()
    for group, parts in GROUPS.items():
        if any(p in low for p in parts):
            return group
    return "other"


def profile(label, fn, top=12, quiet=False):
    """Run ``fn`` once under ``torch.profiler``; returns (and unless
    ``quiet`` prints) the JSON record described at the top."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: not the operators around them, not the runtime
    # calls (cudaLaunchKernel, ...) the trace also gives a device time, and
    # not the runtime's "Command Buffer Full" (the host waiting to enqueue)
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()
            if _device_us(e) > 0 and not e.key.startswith(("aten::", "cuda"))
            and e.key != "Command Buffer Full"]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    blocked = {part: {"ms": sum(r[2] for r in rows if name in r[0]) / 1e3,
                      "launches": sum(r[1] for r in rows if name in r[0])}
               for part, name in BLOCKED.items()}
    split = {g: {"ms": 0.0, "launches": 0}
             for g in ("blocked_cholesky", *GROUPS, "other")}
    for key, count, us in rows:
        g = split[_group(key)]
        g["ms"] += us / 1e3
        g["launches"] += count
    rec = {
        "profile": label, "wall_s": wall, "device_kernels_ms": total / 1e3,
        "split": split, "blocked_cholesky_split": blocked,
        "panel_steps": blocked["diagonal"]["launches"] + blocked["panel"]["launches"],
        "top": [{"kernel": k[:90], "count": c, "ms": us / 1e3}
                for k, c, us in rows[:top]],
    }
    if not quiet:
        print(json.dumps(rec), flush=True)
    return rec


def profile_mesh_fit(model, card, n):
    """``--mesh``: see the module docstring."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    import chip_smoke
    from deepstructuredmixtures_tpu_torch import parallel

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=build)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()

        def fit():
            model.fit(mesh=mesh, giant_leaf_bytes=chip_smoke.MESH_GIANT_BYTES,
                      block=chip_smoke.MESH_BLOCK)

        fit()  # warms the allocator, the libraries and the collectives
        print(json.dumps({"card": card, "n": n, "leaves": model.num_leaves,
                          "giant_leaf_bytes": chip_smoke.MESH_GIANT_BYTES,
                          "block": chip_smoke.MESH_BLOCK,
                          "routed_n": sorted(int(g[4]) for g in
                                             model._giant.values())}),
              flush=True)
        profile(f"mesh_fit_n{n}", fit)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def profile_family(family, card, n):
    """``--family``: see the module docstring."""
    import torch

    import chip_smoke as cs

    xt = np.linspace(-0.05, 1.05, cs.T_TEST).reshape(-1, 1)
    if family == "poe":
        x, y = cs.make_data(n)
        model = cs.poe_model("poe", x, y, torch.float32)
        run = cs.poe_pipeline(model, xt)
    elif family == "mixture":
        model = cs.mixture_model(n, torch.float32)
        run = cs.light_pipeline(model, xt)
    else:
        x, y, idx, xt = cs.config5_data(n)
        model = cs.config5_model(x, y, torch.float32)
        msub, _ = cs.config5_warm_start(x, y, idx, torch.float32)
        model.set_params(msub.get_params())
        del msub
        run = cs.light_pipeline(model, xt)
    run()  # builds the kernels, warms the allocator
    print(json.dumps({"card": card, "family": family, "n": n,
                      "leaves": model.num_leaves,
                      "nmax": sorted(set(model.bucket_spec.nmaxs)),
                      "plan_nmax": model.plan.nmax}), flush=True)
    profile(f"{family}_n{n}", run)


def main():
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--depth", type=int, default=None,
                    help="profile the streamed pipeline on a tree this deep")
    ap.add_argument("--refine-steps", type=int, default=0,
                    help="profile the streamed pipeline with K refinement steps")
    ap.add_argument("--float64", action="store_true",
                    help="profile the streamed pipeline of the float64 model")
    ap.add_argument("--train", action="store_true",
                    help="profile one training gradient instead")
    ap.add_argument("--mesh", action="store_true",
                    help="profile one fit(mesh=...) in a world of one rank")
    ap.add_argument("--family", choices=("poe", "mixture", "config5"),
                    help="profile one warm call of that family's pipeline")
    args = ap.parse_args()
    streamed = args.depth is not None or args.refine_steps or args.float64
    depth = args.depth or 2
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if args.family:
        profile_family(args.family, card, args.n)
        return
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0.0, 1.0, args.n)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, args.n)
    model = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cuda",
                             dtype=torch.float64 if args.float64 else torch.float32,
                             do_fit=False, depth=depth)
    if args.mesh:
        profile_mesh_fit(model, card, args.n)
        return
    if args.train:
        from deepstructuredmixtures_tpu_torch.train import _train_vg

        vg = _train_vg(model)
        vg(model.theta)  # warms the allocator and the libraries
        print(json.dumps({"card": card, "n": args.n, "depth": depth,
                          "dtype": str(model.dtype), "leaves": model.num_leaves,
                          "nmax_max": max(b.nmax for b in model.bucket_batches)}),
              flush=True)
        profile(f"train_grad_n{args.n}_{str(model.dtype).split('.')[-1]}",
                lambda: vg(model.theta))
        return
    if streamed:
        import chip_smoke

        pipeline = chip_smoke.streamed_pipeline(model, args.refine_steps)
        pipeline()  # builds the kernels, warms the allocator
        from deepstructuredmixtures_tpu_torch.ops import fused_chol

        # the padded factorization work of the fused buckets and of the rest
        work = {"fused": 0.0, "cusolver": 0.0}
        for b in model.bucket_batches:
            kind = ("fused" if fused_chol.supported(b.nmax, b.x.dtype, model.layout.kinds,
                                                    model.device) else "cusolver")
            work[kind] += b.num_leaves * b.nmax**3 / 3
        print(json.dumps({"card": card, "n": args.n, "depth": depth,
                          "refine_steps": args.refine_steps,
                          "dtype": str(model.dtype), "leaves": model.num_leaves,
                          "cholesky_tflop_padded": {k: v / 1e12 for k, v in work.items()},
                          "bound_s_padded": {k: v / 67e12 for k, v in work.items()}}),
              flush=True)
        profile(f"streamed_n{args.n}_depth{depth}_refine{args.refine_steps}"
                f"_{str(model.dtype).split('.')[-1]}", pipeline)
        return
    model.fit(store="hybrid")  # builds the kernels, warms the allocator
    model.update()
    # the factorization work of the cached buckets, padded and valid, and
    # its least time at 67 TFLOP/s (float32 FMA outside the tensor cores)
    padded = sum(b.num_leaves * b.nmax**3 / 3 for b in model.bucket_batches)
    valid = sum(float((b.n.double().cpu() ** 3 / 3).sum())
                for b in model.bucket_batches)
    print(json.dumps({"card": card, "n": args.n,
                      "cached_bytes": model.last_fit_diagnostics["cached_bytes"],
                      "cholesky_tflop_padded": padded / 1e12,
                      "cholesky_tflop_valid": valid / 1e12,
                      "bound_s_padded": padded / 67e12,
                      "bound_s_valid": valid / 67e12}), flush=True)
    profile(f"hybrid_fit_n{args.n}", lambda: model.fit(store="hybrid"))
    model.update()
    xt = np.linspace(-0.05, 1.05, 2000).reshape(-1, 1)
    model.predict(xt)
    for T in (1, 2000):
        sel = np.linspace(0, 1999, T).astype(int)
        profile(f"cached_predict_n{args.n}_t{T}", lambda: model.predict(xt[sel]))


if __name__ == "__main__":
    main()
