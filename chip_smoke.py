#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the exit code is
non-zero; no phase catches its own failure or falls back to the CPU):

0. environment: a CUDA device is required; card name and power limit,
   torch, CUDA and nvcc versions;
1. build both CUDA kernels (``deepstructuredmixtures_tpu_torch/csrc``),
   one nvcc per source, in parallel, into ``build/kernels/``;
2. the fused gram+Cholesky kernel against its plain PyTorch version in
   float32 and float64 on the card, at the bucket shapes of the fit path,
   with tied and per-leaf hypers; padding contract checked exactly; both
   timed with CUDA events;
3. the blocked Cholesky kernel against its plain version, against
   ``torch.linalg.cholesky_ex`` in float32 and against float64 on the
   card, at the N=100k headline's G=1 shapes and the ragged batched
   shapes of the hybrid fit (the streamed path chunks its buckets by the
   same rule, so it has no other shapes); upper-triangle and padding
   contract checked exactly; the three timed with CUDA events, the
   kernel in place on a fresh copy whose own time (``copy_ms``) is
   subtracted; no kernel time may stand below its bound;
4. the headline model (V=3, K=4, M=30, depth 2, IsoSE, log noise -1,
   seed 0) at N=20,000: ``build_dsmgp`` → ``fit`` → ``update`` →
   ``predict`` at 1, 64 and 2000 test points in float32, checked against
   the same calls in float64 on the card; the fused kernel must be
   launched on both fit and predict, the blocked one never;
5. the same at N=100,000, where every leaf is above the fused kernel's
   domain (neither kernel may launch), plus the wall-clock of the
   streamed fit+update+predict pipeline at T=2000 (neither kernel may
   launch there either);
6. hybrid serving at N=20,000: ``fit(store='hybrid')`` caches every
   bucket, the fused kernel factors its 3 buckets and the blocked kernel
   the rest; cached predictions and the alpha-cache mean against float64
   on the card;
7. hybrid serving at N=100,000 in float32: every bucket cached (the
   blocked kernel launches once per leaf chunk, the fused one never),
   cached predictions and the alpha-cache mean against phase 5's
   streamed float64 run;
   ``Predictor`` latency of single requests and a ``MicroBatcher`` run of
   16 concurrent requests;
8. a JSON line of the kernels, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: bucket shapes (leaves, nmax) of the fused kernel: the three fused
#: buckets of the N=20k headline tree, then the domain's edges
KERNEL_SHAPES = [(16, 640), (12, 768), (16, 896), (8, 128), (4, 1024)]
PATH_SHAPES = KERNEL_SHAPES[:3]
KERNEL_TOL = 5e-4  # max abs factor error vs float64 (tests/test_pallas_chol.py:71)
#: (G, n) of the blocked kernel: the N=100k headline's G=1 shapes, then
#: the ragged batched shapes of the hybrid fit (N=100k, N=20k, N=20k)
POTRF_SHAPES = [(1, 4576), (1, 8296), (1, 16232), (13, 3176), (17, 1040),
                (5, 2224)]
# max abs factor error vs float64: the bound of tests/test_pallas_potrf.py:43,
# or 4x cholesky_ex's own float32 error on the same input where that is
# larger (float32 error grows with the condition number at n ~ 16k)
POTRF_TOL, POTRF_LIB_FACTOR = 5e-4, 4.0
# and within this multiple of the plain version's float32 error on the same
# input: the plain version shares the kernel's blocking and its product with
# the inverse, so a lost digit in the kernel shows here first
POTRF_PLAIN_FACTOR = 2.0
LOGDET_TOL = 1e-5  # relative logdet error (tests/test_pallas_potrf.py:61)
# the least time of the card for a kernel's work: float32 FMA outside the
# tensor cores and HBM bandwidth of an H100 SXM at 700 W
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
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


def bound_ms(flops, nbytes):
    """``(ms, 'operations' | 'bytes')``: the least time of the card for
    ``flops`` float32 operations moving ``nbytes``, and which bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def reset_launches():
    from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

    fused_chol.LAUNCHES = 0
    potrf.LAUNCHES = 0


def launches():
    """``(fused, blocked)`` kernel launches since the last reset."""
    from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

    return fused_chol.LAUNCHES, potrf.LAUNCHES


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
    from deepstructuredmixtures_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build(build.KERNELS)  # one nvcc per source, in parallel
    secs = time.perf_counter() - t0
    report = {}
    for name, lib in libs.items():
        log = lib.with_suffix(".log")
        report[name] = {"library": os.path.relpath(lib, REPO), "ptxas": [
            l.strip() for l in log.read_text().splitlines()
            if "registers" in l or "spill" in l] if log.exists() else []}
    say("build", seconds=secs, kernels=report)


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
    path_ms = path_plain_ms = path_bound = 0.0
    path_bound_by = set()
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
            # this input's work: the gram (2D + 6 operations per element)
            # and the Cholesky of each leaf's valid block; x and the
            # per-leaf scalars read once, the factors written once
            nv = n.astype(np.float64)
            b_ms, b_by = bound_ms(float(np.sum(nv**3 / 3 + nv**2 * (2 * 1 + 6))),
                                  4 * (L * N * 1 + 4 * L + L * N * N))
            padded_ms, _ = bound_ms(L * N**3 / 3, 4 * L * N * N)
            if tied and (L, N) in PATH_SHAPES:
                path_ms += ms
                path_plain_ms += plain_ms
                path_bound += b_ms
                path_bound_by.add(b_by)
            say("kernel", L=L, N=N, hypers="tied" if tied else "per-leaf",
                max_abs_err_vs_f64=err64, max_abs_err_vs_plain_f32=err32,
                plain_f32_err_vs_f64=plain_err64, kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_padded_ms=padded_ms, card=card)
    return worst, path_ms, path_plain_ms, path_bound, (
        "operations" if path_bound_by == {"operations"} else "bytes")


def _spd_batch(G, n, seed):
    """``(a [G, n, n] float64 on the card, valid sizes)``: IsoSE grams of
    sorted uniform points, as ``tests/test_pallas_potrf.py:15-29`` makes
    them; for G > 1 the last matrix is identity-padded beyond n - n // 4."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a = torch.zeros((G, n, n), dtype=torch.float64, device="cuda")
    valid = [n] * G
    if G > 1:
        valid[-1] = n - n // 4
    for g, nv in enumerate(valid):
        x = torch.sort(torch.rand(nv, generator=gen, device="cuda",
                                  dtype=torch.float64))[0]
        a[g, :nv, :nv] = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.02)
        a[g].diagonal().add_(0.3)
        a[g].diagonal()[nv:] = 1.0
    return a, valid


def phase_potrf():
    """Blocked kernel vs plain, cholesky_ex and float64 on the card; returns
    the kernels-line entry summed over ``POTRF_SHAPES``."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import potrf

    card = card_line()
    tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0)
    bound_kinds = set()
    for seed, (G, n) in enumerate(POTRF_SHAPES):
        a64, valid = _spd_batch(G, n, seed)
        a = a64.float()
        ref = torch.linalg.cholesky(a64)
        out = potrf.blocked_cholesky(a.clone())
        torch.cuda.synchronize()
        plain = potrf.blocked_cholesky_reference(a)
        lib = torch.linalg.cholesky_ex(a)[0]
        err64 = float((out.double() - ref).abs().max())
        lib_err64 = float((lib.double() - ref).abs().max())
        plain_err64 = float((plain.double() - ref).abs().max())
        err_plain = float((out - plain).abs().max())
        del plain, lib
        if out.triu(1).any():
            raise AssertionError(f"upper triangle not zero at ({G},{n})")
        for g, nv in enumerate(valid):
            if nv < n and not (torch.equal(out[g, nv:, nv:],
                                           torch.eye(n - nv, device="cuda"))
                               and not out[g, nv:, :nv].any()):
                raise AssertionError(f"padding contract broken at ({G},{n})")
        logdet = 2 * torch.log(torch.diagonal(out.double(), dim1=1, dim2=2)).sum(1)
        logdet_ref = 2 * torch.log(torch.diagonal(ref, dim1=1, dim2=2)).sum(1)
        logdet_rel = float(((logdet - logdet_ref).abs() / logdet_ref.abs()).max())
        tol = max(POTRF_TOL, POTRF_LIB_FACTOR * lib_err64)
        plain_tol = POTRF_PLAIN_FACTOR * plain_err64
        if not (err64 <= tol and err64 <= plain_tol and logdet_rel <= LOGDET_TOL):
            raise AssertionError(
                f"blocked kernel at ({G},{n}): max abs err {err64} (bounds {tol}"
                f" and {plain_tol}, {POTRF_PLAIN_FACTOR} x the plain version's),"
                f" logdet rel {logdet_rel} (bound {LOGDET_TOL})")
        del out, ref, a64
        reps = 5 if n > 8000 else 10
        buf = torch.empty_like(a)
        copy_ms = cuda_ms(lambda: buf.copy_(a), warmup=1, reps=reps)
        ms = cuda_ms(lambda: potrf.blocked_cholesky(buf.copy_(a)), warmup=1,
                     reps=reps) - copy_ms  # the kernel works in place
        plain_ms = cuda_ms(lambda: potrf.blocked_cholesky_reference(a),
                           warmup=1, reps=reps)
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(a), warmup=1,
                         reps=reps)
        # this input's work: the valid blocks only (identity padding costs
        # nothing); every matrix read once and written once
        b_ms, b_by = bound_ms(sum(nv**3 / 3 for nv in valid), 2 * 4 * G * n * n)
        bound_kinds.add(b_by)
        if not (ms >= b_ms):
            raise AssertionError(f"blocked kernel at ({G},{n}): {ms} ms is below "
                                 f"its bound of {b_ms} ms")
        del a, buf
        torch.cuda.empty_cache()
        tot["max_abs_err"] = max(tot["max_abs_err"], err64)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += lib_ms
        tot["bound_ms"] += b_ms
        say("potrf", G=G, n=n, valid=valid[-1], max_abs_err_vs_f64=err64,
            bound=min(tol, plain_tol), cholesky_ex_f32_err_vs_f64=lib_err64,
            plain_f32_err_vs_f64=plain_err64, max_abs_err_vs_plain=err_plain,
            logdet_rel=logdet_rel, kernel_ms=ms, copy_ms=copy_ms,
            plain_ms=plain_ms, cholesky_ex_ms=lib_ms,
            kernel_over_cholesky_ex=ms / lib_ms, bound_ms=b_ms, bound_by=b_by,
            kernel_tflops=sum(nv**3 / 3 for nv in valid) / ms / 1e9,
            card=card)
    tot["bound_by"] = "operations" if bound_kinds == {"operations"} else "bytes"
    return tot


def _slice(n_train, dtype):
    """build → fit → update → predict at each request size; returns the
    model, evidence, predictions and the kernel launches on fit and on
    predict."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    x, y = make_data(n_train)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    reset_launches()
    t0 = time.perf_counter()
    model = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                             do_fit=False, overlap=False)
    build_s = time.perf_counter() - t0
    fit_s = model.fit()
    fit_launches, blocked = launches()
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
    predict_launches = launches()[0] - fit_launches
    if blocked or launches()[1]:
        raise AssertionError("the blocked kernel launched on the streamed path")
    return dict(model=model, z=z, preds=preds, build_s=build_s, fit_s=fit_s,
                predict_s=predict_s, fit_launches=fit_launches,
                predict_launches=predict_launches)


def slice_errors(run32, run64):
    """Float32 run against float64 run: relative evidence error, max abs
    mean error and max relative variance error over the request sizes."""
    z32, z64 = run32["z"], run64["z"]
    errs = {"evidence_rel": abs(z32 - z64) / abs(z64), "mean_abs": 0.0,
            "var_rel": 0.0}
    for size in REQUEST_SIZES:
        m32, v32 = run32["preds"][size]
        m64, v64 = run64["preds"][size]
        errs["mean_abs"] = max(errs["mean_abs"], float((m32 - m64).abs().max()))
        errs["var_rel"] = max(errs["var_rel"],
                              float(((v32 - v64).abs() / v64.abs()).max()))
    return errs


def _compare(run32, run64):
    errs = slice_errors(run32, run64)
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
    return run32, run64


def headline_times(model):
    """Seconds of three warm, synchronized runs of the fused fit + update +
    routed predict at T=2000, as the benchmark composes it, and the last
    run's moments."""
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
    return times, mean, v


def phase_headline(model):
    """The headline wall-clock (min of 3); neither kernel may launch."""
    import torch

    reset_launches()
    times, mean, v = headline_times(model)
    if any(launches()):
        raise AssertionError(f"the headline launched a kernel: {launches()}")
    if not (torch.isfinite(mean).all() and torch.isfinite(v).all()):
        raise AssertionError("headline pipeline gave non-finite moments")
    say("headline", metric="dsmgp_v3k4_fit_update_predict_n100000_t2000_wallclock",
        seconds=min(times), runs=times, dtype=str(model.dtype), card=card_line())


def _expected_launches(model):
    """``(fused, blocked)`` launches of ``fit(store='hybrid')`` with every
    bucket cached: one per leaf chunk of each bucket, by the fit's own
    chunk rule."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

    fused = blocked = 0
    for b in model.bucket_batches:
        chunks = math.ceil(b.num_leaves / fitlib._bucket_chunk(
            b.nmax, b.num_leaves, b.x.dtype))
        if fused_chol.supported(b.nmax, b.x.dtype, model.layout.kinds,
                                model.device):
            fused += chunks
        elif potrf.supported(b.nmax, b.x.dtype, model.device):
            blocked += chunks
    return fused, blocked


def _hybrid_fit(model):
    """``fit(store='hybrid')`` with the full budget; checks that every
    bucket is cached and that each kernel launched once per leaf chunk of
    its buckets. Returns ``(fit_s, (fused, blocked) launches)``."""
    expected = _expected_launches(model)
    reset_launches()
    fit_s = model.fit(store="hybrid")
    got = launches()
    if not all(f is not None for f in model._bucket_factors):
        raise AssertionError("the full budget did not cache every bucket")
    if got != expected:
        raise AssertionError(f"hybrid fit launches {got}, expected {expected}")
    return fit_s, got


def _timed_predicts(model, **kw):
    import torch

    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    preds, secs = {}, {}
    before = launches()
    for size in REQUEST_SIZES:
        sel = np.linspace(0, T_TEST - 1, size).astype(int)
        t0 = time.perf_counter()
        out = model.predict(xt[sel], **kw)
        torch.cuda.synchronize()
        secs[size] = time.perf_counter() - t0
        for a in (out if isinstance(out, tuple) else (out,)):
            if a.shape != (size,) or not torch.isfinite(a).all():
                raise AssertionError(f"bad prediction at T={size}")
        preds[size] = out
    if launches() != before:
        raise AssertionError("a kernel launched on a cached predict")
    return preds, secs


def _mean_err(preds, run64):
    return max(float((preds[s] - run64["preds"][s][0]).abs().max())
               for s in REQUEST_SIZES)


def phase_hybrid_20k(run32, run64):
    """Hybrid serving at N=20k, float32 against float64 on the card."""
    m32, m64 = run32["model"], run64["model"]
    fit_s, (fused, blocked) = _hybrid_fit(m32)
    if not (fused == 3 and blocked == 15):
        raise AssertionError(f"expected 3 fused and 15 blocked launches, got "
                             f"{fused} and {blocked}")
    cached_bytes = m32.last_fit_diagnostics["cached_bytes"]
    m64.fit(store="hybrid")
    h32 = dict(z=m32.update())
    h64 = dict(z=m64.update())
    h32["preds"], predict_s = _timed_predicts(m32)
    h64["preds"], _ = _timed_predicts(m64)
    errs = _compare(h32, h64)
    # the mean-only path from the light store's alpha cache
    m32.fit(cache_alpha=True)
    m32.update()
    mean_only, mean_s = _timed_predicts(m32, return_var=False)
    mean_err = _mean_err(mean_only, h64)
    if not (mean_err <= SLICE_TOL["mean_abs"]):
        raise AssertionError(f"mean-only f32 vs f64 {mean_err}")
    say("hybrid_n20000", launches_fused=fused, launches_blocked=blocked,
        cached_bytes=cached_bytes,
        fit_s=fit_s, predict_s={str(k): v for k, v in predict_s.items()},
        errors_f32_vs_f64=errs, mean_only_predict_s={
            str(k): v for k, v in mean_s.items()},
        mean_only_abs_err_vs_f64=mean_err, card=card_line())
    return blocked


def _latency(pred, size, n_req=20):
    """p50 and max seconds of ``n_req`` single requests of ``size``
    points spread over the training box."""
    rng = np.random.default_rng(size)
    lat = []
    for _ in range(n_req):
        _, _, dt = pred.predict(rng.uniform(0.0, 1.0, (size, 1)))
        lat.append(dt)
    return {"p50_s": statistics.median(lat), "max_s": max(lat)}


def phase_hybrid_100k(run32, run64):
    """Hybrid serving at N=100k in float32: every bucket cached, cached
    predictions against phase 5's streamed float64 run, Predictor latency
    and a MicroBatcher run."""
    from deepstructuredmixtures_tpu_torch.serve import MicroBatcher, Predictor

    model = run32["model"]
    footprint = model._bucket_factor_bytes()
    default_flags = model._hybrid_cached_flags(Predictor.FACTOR_BUDGET)
    item = model.dtype.itemsize
    default_cached = sum(b.num_leaves * b.nmax * b.nmax * item
                         for c, b in zip(default_flags, model.bucket_batches) if c)
    fit_s, (fused, blocked) = _hybrid_fit(model)
    if fused or not blocked:
        raise AssertionError(f"launches fused {fused}, blocked {blocked}")
    h32 = dict(z=model.update())
    h32["preds"], predict_s = _timed_predicts(model)
    errs = _compare(h32, run64)
    # the mean-only path from the alpha cache (m + K_nt'α)
    mean_only, mean_s = _timed_predicts(model, return_var=False)
    mean_only_err = _mean_err(mean_only, run64)
    if not (mean_only_err <= SLICE_TOL["mean_abs"]):
        raise AssertionError(f"mean-only f32 vs f64 {mean_only_err}")
    del h32, mean_only

    t0 = time.perf_counter()
    pred = Predictor(model, factor_budget=footprint)  # refits: every bucket
    build_s = time.perf_counter() - t0
    latency = {str(size): _latency(pred, size) for size in (1, 64)}

    mb = MicroBatcher(pred, max_wait_ms=5.0)
    rng = np.random.default_rng(16)
    xs = [rng.uniform(0.0, 1.0, (64, 1)) for _ in range(16)]
    out = [None] * len(xs)
    barrier = threading.Barrier(len(xs))

    def request(i):
        barrier.wait()
        out[i] = mb.predict(xs[i])

    threads = [threading.Thread(target=request, args=(i,)) for i in range(len(xs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    mb.close()
    if any(o is None or o[0].shape != (64,) or not np.isfinite(o[1]).all()
           for o in out):
        raise AssertionError("a MicroBatcher request failed")
    say("hybrid_n100000", buckets=len(model.bucket_batches),
        cached_bytes=model.last_fit_diagnostics["cached_bytes"],
        footprint_bytes=footprint, launches_fused=fused,
        launches_blocked=blocked, fit_s=fit_s,
        predict_s={str(k): v for k, v in predict_s.items()},
        errors_f32_vs_streamed_f64=errs,
        mean_only_predict_s={str(k): v for k, v in mean_s.items()},
        mean_only_abs_err_vs_f64=mean_only_err, predictor_build_s=build_s,
        predictor_latency=latency,
        microbatcher={"requests": 16, "points_each": 64, "wall_s": wall,
                      "latency_s": sorted(o[2] for o in out),
                      "stats": mb.stats},
        default_budget={"bytes": Predictor.FACTOR_BUDGET,
                        "cached_buckets": int(sum(default_flags)),
                        "cached_bytes": default_cached},
        card=card_line())
    return blocked


def main():
    t_start = time.perf_counter()
    phase_environment()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    max_err, ms, plain_ms, fused_bound, fused_bound_by = phase_kernel()
    blocked_line = phase_potrf()
    run20k, run20k64 = phase_slice(20_000, expect_kernel=True)
    run100k, run100k64 = phase_slice(100_000, expect_kernel=False)
    phase_headline(run100k["model"])
    run20k_launches = run20k["fit_launches"] + run20k["predict_launches"]
    phase_hybrid_20k(run20k, run20k64)
    del run20k, run20k64
    blocked_launches = phase_hybrid_100k(run100k, run100k64)
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "fused_gram_cholesky",
        "route": "cuda",
        "source": "deepstructuredmixtures_tpu_torch/csrc/fused_gram_cholesky.cu",
        "replaces": "deepstructuredmixtures_tpu/ops/pallas_chol.py:219",
        "launches": run20k_launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": fused_bound,
        "bound_by": fused_bound_by,
        "library_ms": None,
    }, {
        "name": "blocked_cholesky",
        "route": "cuda",
        "source": "deepstructuredmixtures_tpu_torch/csrc/blocked_cholesky.cu",
        "replaces": "deepstructuredmixtures_tpu/ops/pallas_potrf.py:351",
        "launches": blocked_launches,
        "max_abs_err": blocked_line["max_abs_err"],
        "ms": blocked_line["ms"],
        "plain_ms": blocked_line["plain_ms"],
        "bound_ms": blocked_line["bound_ms"],
        "bound_by": blocked_line["bound_by"],
        "library_ms": blocked_line["library_ms"],
    }]}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
