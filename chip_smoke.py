#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the exit code is
non-zero):

0. environment: a CUDA device is required; card name and power limit,
   torch, CUDA and nvcc versions;
1. build the CUDA kernel (``deepstructuredmixtures_tpu_torch/csrc``) with
   nvcc into ``build/kernels/``;
2. the fused gram+Cholesky kernel against its plain PyTorch version in
   float32 and float64 on the card, at the bucket shapes of the fit path,
   with tied and per-leaf hypers; padding contract checked exactly; both
   timed with CUDA events;
3. the headline model (V=3, K=4, M=30, depth 2, IsoSE, log noise -1,
   seed 0) at N=20,000: ``build_dsmgp`` → ``fit`` → ``update`` →
   ``predict`` at 1, 64 and 2000 test points in float32, checked against
   the same calls in float64 on the card; the fused kernel must be
   launched on both fit and predict;
4. the same at N=100,000, where every leaf is above the kernel's domain
   (it must not launch), plus the wall-clock of the fused
   fit+update+predict pipeline at T=2000;
5. a JSON line of the kernels, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: bucket shapes (leaves, nmax) of the fused kernel: the three fused
#: buckets of the N=20k headline tree, then the domain's edges
KERNEL_SHAPES = [(16, 640), (12, 768), (16, 896), (8, 128), (4, 1024)]
PATH_SHAPES = KERNEL_SHAPES[:3]
KERNEL_TOL = 5e-4  # max abs factor error vs float64 (tests/test_pallas_chol.py:71)
# float32 slice vs the float64 slice on the card: about 5-10x the f32
# errors the JAX package records against its float64 oracle
SLICE_TOL = {"evidence_rel": 1e-3, "mean_abs": 5e-3, "var_rel": 1e-3}
REQUEST_SIZES = (1, 64, 2000)
T_TEST = 2000


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_data(n, seed=0):
    """The benchmark's 1-D data (``bench.make_data``)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, n)
    return x, y


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of ``fn`` on the card, CUDA events per run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs only on a GPU")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                        check=True, timeout=60).stdout.strip().splitlines()[-1]
    say("environment", card=card_line(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nv, python=sys.version.split()[0])


def phase_build():
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    t0 = time.perf_counter()
    lib = fused_chol.library_path()
    secs = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    report = [l.strip() for l in log.read_text().splitlines()
              if "registers" in l or "spill" in l] if log.exists() else []
    say("build", seconds=secs, library=os.path.relpath(lib, REPO), ptxas=report)


def _kernel_inputs(L, N, tied, seed):
    import torch

    rng = np.random.default_rng(seed)
    n = rng.integers(N // 2, N + 1, L).astype(np.int32)
    n[0] = N  # one full leaf: no padding
    x = np.zeros((L, N, 1), np.float32)
    for l in range(L):
        x[l, : n[l], 0] = np.sort(rng.uniform(0.0, 1.0, n[l]))
    if tied:
        logl = np.full(L, -0.5, np.float32)
        logsigma = np.full(L, 0.2, np.float32)
        noise = np.full(L, 0.05, np.float32)
    else:
        logl = np.linspace(-0.8, 0.1, L).astype(np.float32)
        logsigma = np.linspace(-0.2, 0.4, L).astype(np.float32)
        noise = np.linspace(0.03, 0.2, L).astype(np.float32)
    return n, [torch.from_numpy(a).cuda() for a in (x, n, logl, logsigma, noise)]


def phase_kernel():
    """Kernel vs plain on the card; returns (max abs err vs f64, kernel ms
    and plain ms summed over the fit path's bucket shapes)."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    worst = 0.0
    path_ms = path_plain_ms = 0.0
    card = card_line()
    for seed, (L, N) in enumerate(KERNEL_SHAPES):
        for tied in (True, False):
            n, args = _kernel_inputs(L, N, tied, seed)
            out = fused_chol.fused_gram_cholesky(*args)
            torch.cuda.synchronize()
            plain = fused_chol.fused_gram_cholesky_reference(*args)
            ref64 = fused_chol.fused_gram_cholesky_reference(
                *(a.double() if a.is_floating_point() else a for a in args))
            err64 = err32 = plain_err64 = 0.0
            for l in range(L):
                k = int(n[l])
                o = out[l, :k, :k].double()
                err64 = max(err64, float((o - ref64[l, :k, :k]).abs().max()))
                err32 = max(err32, float((o - plain[l, :k, :k].double()).abs().max()))
                plain_err64 = max(plain_err64, float(
                    (plain[l, :k, :k].double() - ref64[l, :k, :k]).abs().max()))
                eye = torch.eye(N - k, device=out.device)
                if not (torch.equal(out[l, k:, k:], eye)
                        and not out[l, k:, :k].any()):
                    raise AssertionError(f"padding contract broken ({L},{N}) leaf {l}")
            if out.triu(1).any():
                raise AssertionError(f"upper triangle not zero ({L},{N})")
            if not (err64 <= KERNEL_TOL):
                raise AssertionError(
                    f"kernel vs f64 max abs err {err64} > {KERNEL_TOL} at ({L},{N})")
            ms = cuda_ms(lambda: fused_chol.fused_gram_cholesky(*args))
            plain_ms = cuda_ms(lambda: fused_chol.fused_gram_cholesky_reference(*args))
            worst = max(worst, err64)
            if tied and (L, N) in PATH_SHAPES:
                path_ms += ms
                path_plain_ms += plain_ms
            say("kernel", L=L, N=N, hypers="tied" if tied else "per-leaf",
                max_abs_err_vs_f64=err64, max_abs_err_vs_plain_f32=err32,
                plain_f32_err_vs_f64=plain_err64, kernel_ms=ms,
                plain_ms=plain_ms, card=card)
    return worst, path_ms, path_plain_ms


def _slice(n_train, dtype):
    """build → fit → update → predict at each request size; returns the
    model, evidence, predictions and the kernel launches on fit and on
    predict."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    x, y = make_data(n_train)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    fused_chol.LAUNCHES = 0
    t0 = time.perf_counter()
    model = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                             do_fit=False, overlap=False)
    build_s = time.perf_counter() - t0
    fit_s = model.fit()
    fit_launches = fused_chol.LAUNCHES
    z = model.update()
    preds, predict_s = {}, {}
    for size in REQUEST_SIZES:
        sel = np.linspace(0, T_TEST - 1, size).astype(int)
        t0 = time.perf_counter()
        mean, var = model.predict(xt[sel])
        torch.cuda.synchronize()
        predict_s[size] = time.perf_counter() - t0
        if mean.shape != (size,) or var.shape != (size,):
            raise AssertionError(f"predict({size}) gave {mean.shape}, {var.shape}")
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()
                and (var > 0).all()):
            raise AssertionError(f"non-finite or non-positive moments at T={size}")
        preds[size] = (mean, var)
    predict_launches = fused_chol.LAUNCHES - fit_launches
    return dict(model=model, z=z, preds=preds, build_s=build_s, fit_s=fit_s,
                predict_s=predict_s, fit_launches=fit_launches,
                predict_launches=predict_launches)


def _compare(run32, run64):
    z32, z64 = run32["z"], run64["z"]
    errs = {"evidence_rel": abs(z32 - z64) / abs(z64), "mean_abs": 0.0,
            "var_rel": 0.0}
    for size in REQUEST_SIZES:
        m32, v32 = run32["preds"][size]
        m64, v64 = run64["preds"][size]
        errs["mean_abs"] = max(errs["mean_abs"], float((m32 - m64).abs().max()))
        errs["var_rel"] = max(errs["var_rel"],
                              float(((v32 - v64).abs() / v64.abs()).max()))
    for key, tol in SLICE_TOL.items():
        if not (errs[key] <= tol):
            raise AssertionError(f"f32 vs f64 {key} = {errs[key]} > {tol}")
    return errs


def phase_slice(n_train, expect_kernel):
    import torch

    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    run32 = _slice(n_train, torch.float32)
    model = run32["model"]
    fused = [(nm, len(ids)) for nm, ids in zip(model.bucket_spec.nmaxs,
                                               model.bucket_spec.leaf_ids)
             if fused_chol.supported(nm, model.dtype, model.layout.kinds,
                                     model.device)]
    if expect_kernel:
        if run32["fit_launches"] <= 0 or run32["predict_launches"] <= 0:
            raise AssertionError(
                f"fused kernel not launched: fit {run32['fit_launches']}, "
                f"predict {run32['predict_launches']}")
    elif run32["fit_launches"] or run32["predict_launches"] or fused:
        raise AssertionError("fused kernel launched outside its domain")
    run64 = _slice(n_train, torch.float64)
    errs = _compare(run32, run64)
    say(f"slice_n{n_train}", leaves=model.num_leaves,
        buckets=len(model.bucket_spec.nmaxs), fused_buckets=fused,
        launches_fit=run32["fit_launches"],
        launches_predict=run32["predict_launches"],
        build_s=run32["build_s"], fit_s=run32["fit_s"],
        predict_s={str(k): v for k, v in run32["predict_s"].items()},
        evidence_f32=run32["z"], evidence_f64=run64["z"], errors_f32_vs_f64=errs,
        tolerances=SLICE_TOL, card=card_line())
    return run32


def phase_headline(model):
    """Wall-clock of the fused fit + update + routed predict at T=2000, as
    the benchmark composes it; warm, synchronized, min of 3."""
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch import infer as inferlib
    from deepstructuredmixtures_tpu_torch.models import _routed_moment_match

    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    tidx, tmask = model._route(xt)
    ti = torch.as_tensor(tidx, dtype=torch.long, device=model.device)
    tm = torch.as_tensor(tmask, device=model.device)
    xtd = torch.as_tensor(xt, dtype=model.dtype, device=model.device)

    def pipeline():
        mu, var, mll = fitlib.bucketed_streamed_predict(
            model.layout, model.theta, model.bucket_batches,
            model.bucket_spec.leaf_ids, model.num_leaves, xtd, ti)
        lw, z = inferlib.update_weights(model.plan, mll)
        mean, v = _routed_moment_match(model.plan, mu, var, lw, ti, tm, T_TEST)
        torch.cuda.synchronize()
        return mean, v

    mean, v = pipeline()  # warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mean, v = pipeline()
        times.append(time.perf_counter() - t0)
    if not (torch.isfinite(mean).all() and torch.isfinite(v).all()):
        raise AssertionError("headline pipeline gave non-finite moments")
    say("headline", metric="dsmgp_v3k4_fit_update_predict_n100000_t2000_wallclock",
        seconds=min(times), runs=times, dtype=str(model.dtype), card=card_line())


def main():
    t_start = time.perf_counter()
    phase_environment()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    max_err, ms, plain_ms = phase_kernel()
    run20k = phase_slice(20_000, expect_kernel=True)
    run100k = phase_slice(100_000, expect_kernel=False)
    phase_headline(run100k["model"])
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "fused_gram_cholesky",
        "route": "cuda",
        "source": "deepstructuredmixtures_tpu_torch/csrc/fused_gram_cholesky.cu",
        "replaces": "deepstructuredmixtures_tpu/ops/pallas_chol.py:219",
        "launches": run20k["fit_launches"] + run20k["predict_launches"],
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
