#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the exit code is
non-zero; no phase catches its own failure or falls back to the CPU):

0. environment: a CUDA device is required; card name and power limit,
   torch, CUDA and nvcc versions;
1. build the three CUDA kernels (``deepstructuredmixtures_tpu_torch/csrc``),
   one nvcc per source, in parallel, into ``build/kernels/``;
2. the fused gram+Cholesky kernel against its plain PyTorch version in
   float32 and float64 on the card, at the bucket shapes of the fit paths
   (the N=20k tree's three buckets, the domain's edges, the leaf chunks of
   the depth-4 tree at N=100k, the full store's and the PoE family's
   monolithic batches, and the frontier's leaf chunks of phase 16), with
   tied and per-leaf hypers; padding
   contract checked exactly, the error within 5e-4 and 4x the plain
   version's; kernel, plain version and ``cholesky_ex`` on the ready gram
   (the factor alone, a yardstick) timed with CUDA events;
3. the blocked Cholesky kernel against its plain version, against
   ``torch.linalg.cholesky_ex`` in float32 and against float64 on the
   card, at the N=100k headline's G=1 shapes, the ragged batched shapes
   of the hybrid fit and the kernel-mixture model's (the streamed path
   chunks its buckets by the same rule); upper-triangle and padding
   contract checked exactly; the three timed with CUDA events, the
   kernel in place on a fresh copy whose own time (``copy_ms``) is
   subtracted; no kernel time may stand below its bound;
3b. the forward-solve-and-moments kernel (``ops/trsm.py``) against its
   plain version in float64: one leaf table that mixes buckets ((1,
   16232), (13, 3176), (17, 1040), identity-padded) at widths 1, 2, 65 and
   321 (``TRSM_TOL``), a factor with a NaN coming back non-finite on its
   leaf alone; then held to ``TRSM_TOL`` and timed with CUDA events beside
   its bound, the plain
   version and cuBLAS's ``trsm`` on a float64 copy (the library call the
   kernel replaced, per bucket, the cast untimed): one serving predict
   chunk of 256 points over all 144 cached leaves of the N=100k model
   (W = 65, one launch) and the streamed pass's two largest one-leaf
   chunks at T=2000 (W = 321);
4. the headline model (V=3, K=4, M=30, depth 2, IsoSE, log noise -1,
   seed 0) at N=20,000: ``build_dsmgp`` → ``fit`` → ``update`` →
   ``predict`` at 1, 64 and 2000 test points in float32, checked against
   the same calls in float64 on the card; the fused kernel must be
   launched on both fit and predict, the blocked one once per leaf chunk
   above nmax 1024 in the fit and in each predict (the streamed route of
   ``fit._kept_recipe``: the blocked kernel's factor, float64 solves);
   ``fit()`` must keep the light store (the monolithic factors would take
   6.4 GB, above the full store's 2 GiB);
5. the same at N=100,000, where every leaf is above the fused kernel's
   domain (the fused kernel may not launch, the blocked one 119 times a
   pass), plus the wall-clock of the streamed fit+update+predict pipeline
   at T=2000 (the same launches);
5b. the same pipeline on the depth-4 tree at N=100,000 (20,736 leaves,
   most of them in the fused kernel's domain): the fused kernel must
   launch once per leaf chunk of its buckets (36) and never on a bucket
   above 1024, the blocked kernel once per leaf chunk above it (17);
   float32 against float64 on the card; the wall-clock (min of
   3 warm runs) and the fused kernel's share of the device time
   (``chip_profile.profile``); the build's seconds with and without the
   overlap analysis and the shared schedule;
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
8. the full store and the shared schedule, at N=4,000 (the monolithic
   batch at nmax 768, factored by the fused kernel) and at N=10,000
   (nmax 1664, the blocked kernel): ``build_dsmgp(overlap=True)`` →
   ``fit()``, which must resolve to the full store, → ``update`` →
   ``predict`` at 1, 64 and 2000 test points in float32 against float64 on
   the card; ``fit(method='batched')`` against ``fit(method='shared')``
   (min of 3 warm runs each, the shared fit's schedule, fallbacks and its
   split into phases); the shared fit's root mll within 1e-8 of the
   batched one in float64 and its float32 evidence against float64; a
   full-store predict at T=2000 against a light-store streamed one;
9. refinement (``refine_steps``) against the float64 runs of phases 4-5;
   the refined path factors with the fused kernel up to nmax 1024 and the
   blocked one above: at N=20,000 ``predict(refine_steps=1)`` and
   ``refine_steps=2`` at T=2000 (3 fused and 15 blocked launches each;
   every error within the float32 bounds, the moments' no larger than the
   unrefined ones); at N=100,000 the headline pipeline with one step (119
   blocked launches; min of 2, peak memory, errors) beside the float32
   headline and the float64 pipeline (min of 3);
10. the standalone ``GaussianProcess`` at N=8,192 in float32 and float64:
   fit, predict at T=2000 and ``grad_mll`` times; float32 against float64;
   the full covariance's diagonal against the marginal variance; the
   float64 gradient against a central finite difference; an IsoLinear GP
   at n=7,600, its mll and ``grad_mll`` in float32 against float64 by
   phase 11's bounds. In float32 both GPs take the kept route of the
   training objective (the blocked kernel's factor, a float64 backward):
   one blocked launch in each fit and each ``grad_mll``;
11. training, on fresh models (the optimizer's first step, which imports
   ``torch._dynamo``, timed apart): at N=20,000 the root mll and its
   gradient at the start hypers by the route ``train`` takes (one graph
   through every bucket) in float32 against float64 (mll within 1e-3,
   gradient within 1e-2 relative in norm), and the float64 gradient
   against a central difference (1e-4); ``train`` (Adam, lr 1e-2, 5
   iterations): the mll curve ascends, and the refit launches the fused
   kernel 3 times and the blocked one 15 (119 at N=100,000). Every float32
   gradient of the phase launches the blocked kernel as the plan counts
   (the objective's kept route, ``fit._kept_recipe``: once per leaf chunk
   above nmax 1024 in each pass) and the fused one never.
   At N=100,000 ``train`` (2 iterations; the per-bucket route, nmax up to
   16,232): cold and warm seconds per iteration, peak memory, the first
   iteration's float32 gradient against float64; then ``finetune`` of the
   trained model for its two largest and two smallest leaves (one
   iteration, the sparse pair list). At N=4,000 (phase 8's full-store
   model) the candidate gradients of all 144 leaves, sparse pair list
   against every pair in float64 (1e-10) and float32 against float64, and
   one ``finetune`` iteration whose refit keeps the full store and
   launches the fused kernel once. ``train_gp`` on phase 10's GP, 5
   iterations;
12. multi-device: in a world of one rank under NCCL, at N=100,000 float32
   ``fit(mesh=..., giant_leaf_bytes=512 MiB)`` (the leaves above nmax 11585
   on the distributed Cholesky; the others on the blocked kernel, once
   per leaf chunk in the fit and in the predict) → ``update`` →
   routed and mean-only ``predict`` against phase 5's float64 run, the
   mesh fit and predict beside the light fit and streamed predict of the
   same model (in turns, min of 2), ``sharded_cholesky`` of the largest
   routed leaf against ``cholesky_ex`` and the blocked kernel (whose
   launches there are not counted) with its bound, and
   ``sharded_bucketed_streamed_predict`` against the local one; at N=20,000
   ``fit(mesh=)`` with the largest bucket routed in float32 (the fused
   kernel must launch, the blocked one as the plan counts; against phase
   4's float64)
   and in float64 (within 1e-8 of phase 4's), the sharded training
   gradient (float32 against float64 by phase 11's gates; its blocked
   launches as the plan counts) and
   ``GaussianProcess.fit(mesh=)`` at N=8,192 (float32 within the float32
   bounds, float64 within 1e-8); then two gloo ranks sharing ``cuda:0``
   repeat the float64 runs (N=20k fit and predict, the GP, 2 iterations of
   ``train(mesh=)`` and 1 of ``finetune(mesh=)`` at N=4,000) and are held
   to the world of one within 1e-8; a rank that fails fails the script;
13. the PoE family at N=100,000 (``bench.py`` ``run_poe``): ``build_poe``,
   ``build_poe(generalized=True)`` and ``build_bcm`` (K=4, depth 2, 2,048
   experts of 48-50 points, the monolithic batch at nmax 128), each
   ``fit_naive`` (one fused launch per leaf chunk, never the blocked
   kernel) → fused ``predict`` at T=2000; float32 against float64 on the
   card; four sampled leaves' mll and moments at every test point against
   a float64 NumPy oracle; the fusion against its float64 replica on the
   port's own leaf moments (1e-10 / 1e-8); warm seconds (min of 3), peak
   memory and the PoE pipeline's device time by kernel group;
14. kernel-mixture leaves (``bench.py`` ``run_mixture``: IsoSE, ArdSE and
   IsoLinear, 144 leaves each): at N=100,000 the streamed fit → update →
   routed predict (no bucket in the fused kernel's domain; the blocked
   kernel factors every bucket, with float64 solves, ``fit._kept_recipe``)
   in float32 against float64, per kind three small leaves and the largest
   of at most 6,000 points against the oracle; the training objective's
   value and tied gradient on three one-leaf batches (the worst IsoLinear
   leaf, n=7,627, and the largest ArdSE and IsoSE leaves; the kept route,
   one blocked launch each) in float32 against float64 by phase 11's
   bounds, and its leaf mll against ``fit.bucketed_leaf_mlls`` at the same
   hypers (1e-6); at N=20,000 the hybrid store (the blocked kernel on
   every bucket above nmax 1024, the fused one never) against float64,
   three tied Adam steps through ``make_value_and_grad_bucketed`` (the mll
   ascends; the objective's blocked launches, two per leaf chunk above
   nmax 1024, counted from the plan; the first gradient in float32
   against float64) and one ``finetune`` iteration over all 432
   candidates through the sparse ``MixtureOverlap`` pair list (its
   gradient's blocked launches counted from the plan);
15. BASELINE config 5 at N=100,000 (``bench.py`` ``run_config5``, 4-D
   data, additive ArdSE): the warm start (``train``, 15 Adam iterations
   on a 4,000-point V=2 K=3 model, the hypers carried by
   ``set_params(get_params())``), the light fit → update → routed predict
   (the blocked kernel on every bucket) against float64 and the three
   smallest leaves against the oracle, then one bucketed ``finetune``
   iteration of ``CONFIG5_FT_CANDIDATES`` leaves (its first evaluation, the
   candidates' own mlls and gradients, in float32 against the same
   evaluation in float64 by phase 11's bounds; its gradient's blocked
   launches counted from the plan) and predict again (finite);
   ``chip_profile.py --family poe|mixture|config5`` profiles one warm call
   of each pipeline;
16. the scale frontier (``README.md``; ``bench.py --n N --depth 4
   --no-overlap --check-mlls FILE``): the streamed pipeline of phase 5 on
   the depth-4 tree (20,736 leaves) at N=500,000 (37 buckets, leaves up to
   16,731 points) and N=1,000,000 (43 buckets, up to 33,303), built
   without the overlap analysis. Before any pass the seed file of sampled
   float64 leaf oracles (``n500k_sampled_moments.npz``,
   ``n1m_sampled_moments.npz``) is checked as ``bench.py`` checks it:
   stamp, leaf ids, shapes, and the routed test counts of its leaves
   against the port's tree. At N=500k a warm pass and a timed one, at N=1M
   one pass, cold after N=500k's: each launches the kernels exactly as the
   plan counts (the fused one up to nmax 1024, the blocked one above), and
   every fused shape is one phase 2 holds. The sampled leaves' mll, routed
   mean and variance against the seed (1e-3 relative to max(1, |mll|),
   5e-3, 1e-3 relative); the combine on all 20,736 leaves against its
   float64 NumPy replica (1e-8); at N=500k also float32 against a float64
   pass on the card. The wall-clock, the model's TFLOPs and their rate,
   peak memory;
17. a JSON line of the kernels, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``. A kernel's launches there are those
   of phases 4-16, the main path; the forward-solve kernel's are counted
   per phase (``launches_by_phase``), and the streamed slices, the
   headline, the depth-4 pipeline, every cached predict and the frontier
   hold theirs to the plan's count.
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
#: buckets of the N=20k headline tree, the domain's edges, the leaf chunks
#: of the eight fused buckets of the depth-4 tree at N=100k (the largest
#: chunk ``fit._bucket_chunk`` cuts from each bucket), the full store's
#: monolithic batch at N=4k (phase 8), the PoE family's at N=100k (phase
#: 13), then the leaf chunks of the scale frontier's depth-4 trees (phase
#: 16) that no shape before reaches: N=1M's, whose first two take clusters
#: of 4 and 8 blocks at widths 256 and 384, then N=500k's
KERNEL_SHAPES = [(16, 640), (12, 768), (16, 896), (8, 128), (4, 1024),
                 (1662, 128), (2048, 256), (910, 384), (512, 512), (327, 640),
                 (227, 768), (167, 896), (128, 1024), (144, 768), (2048, 128),
                 (1, 256), (16, 384), (51, 512), (89, 640), (170, 768),
                 (48, 896), (50, 1024), (2, 128), (65, 256), (268, 384),
                 (9, 512), (120, 640), (76, 768), (149, 896), (118, 1024)]
#: the valid leaf sizes of a shape whose leaves lie far below its nmax (else
#: N/2 to N, one leaf full): the PoE family's 48-50 points padded to 128,
#: timed beside ``cholesky_ex`` at the valid sizes' own padding, 56
KERNEL_VALID = {(2048, 128): (48, 50, 56)}
#: the shapes of the fit paths (the kernels line sums them)
PATH_SHAPES = KERNEL_SHAPES[:3] + KERNEL_SHAPES[5:]
KERNEL_TOL = 5e-4  # max abs factor error vs float64 (tests/test_pallas_chol.py:71)
# and within this multiple of the plain version's float32 error on the same
# input (cuSOLVER's float32 Cholesky of the same gram)
KERNEL_PLAIN_FACTOR = 4.0
#: (G, n) of the blocked kernel: the N=100k headline's G=1 shapes, the
#: ragged batched shapes of the hybrid fit (N=100k, N=20k, N=20k), the
#: full store's leaf chunk at N=10k (phase 8), then the kernel-mixture
#: model's: the largest and the most populous chunk of its N=20k hybrid fit
#: and its largest streamed leaf at N=100k (phase 14), then the scale
#: frontier's largest leaf, N=1M (phase 16)
POTRF_SHAPES = [(1, 4576), (1, 8296), (1, 16232), (13, 3176), (17, 1040),
                (5, 2224), (48, 1664), (6, 3024), (63, 1048), (1, 14928),
                (1, 33304)]
# max abs factor error vs float64: the bound of tests/test_pallas_potrf.py:43,
# or 4x cholesky_ex's own float32 error on the same input where that is
# larger (float32 error grows with the condition number at n ~ 16k)
# phase 3b: the leaf table, the widths, and the largest relative error of
# vz, vv and z against the plain version: both are float64 solves on the
# same float32 factor in another order, whose forward error is at most
# about n eps cond(L) (16232 x 1.1e-16 x about 250 here)
TRSM_SHAPES = [(1, 16232), (13, 3176), (17, 1040)]
TRSM_WIDTHS = (1, 2, 65, 321)
TRSM_TOL = 1e-9
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
DEPTH4_N = 100_000  # the depth-4 phase's training points
#: phase 8's training sizes and the kernel that must factor the monolithic
#: batch there: nmax 768 is in the fused kernel's domain, 1664 above it
FULL_STORE_RUNS = ((4_000, "fused"), (10_000, "blocked"))
#: float64 root mll, shared fit against batched fit (tests/test_fit.py:140-147)
SHARED_MLL_TOL = 1e-8


_T0 = time.perf_counter()


def say(phase: str, **fields):
    """One JSON line for ``phase``, with the seconds since the script
    started."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


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


def trsm_launches():
    """Forward-solve kernel launches (``ops/trsm.py``) so far."""
    from deepstructuredmixtures_tpu_torch.ops import trsm

    return trsm.LAUNCHES


#: the bytes a forward-solve launch of the predicts may take (the default
#: ``budget`` of ``fit.bucketed_hybrid_predict`` and ``cached_leaf_predict``)
PREDICT_BUDGET = 2 << 30


def _predict_trsm_launches(model, xt_np, return_var=True):
    """Forward-solve launches of one ``model.predict(xt_np)`` on the full
    or the hybrid store: the cached predict's launch groups
    (``fit._launch_groups``) at the request's routed width, and one per
    leaf chunk of an uncached bucket on the kernel's route
    (``fit._kept_recipe``); none on the mean-only path of the alpha
    cache."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    if model._giant:
        raise ValueError("the giant leaves' distributed predict is not counted here")
    if not return_var and model._alpha_cache is not None:
        return 0
    if model.posterior is None and model._bucket_factors is None:
        raise ValueError("not a model of the full or the hybrid store")
    T = model._route(xt_np)[0].shape[1]
    row = fitlib._launch_row_bytes(1 + T, model.dtype.itemsize)
    if model.posterior is not None:
        cached = [(model.batch.nmax, model.batch.num_leaves)]
        streamed = []
    else:
        pairs = list(zip(model.bucket_batches, model._bucket_factors))
        cached = [(b.nmax, b.num_leaves) for b, f in pairs if f is not None]
        streamed = [b for b, f in pairs if f is None and fitlib._kept_recipe(b)]
    return len(fitlib._launch_groups(cached, row, PREDICT_BUDGET)) + sum(
        -(-b.num_leaves // fitlib._bucket_chunk(b.nmax, b.num_leaves, b.x.dtype,
                                                PREDICT_BUDGET))
        for b in streamed)


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
    lo, hi, _ = KERNEL_VALID.get((L, N), (N // 2, N, N))
    n = rng.integers(lo, hi + 1, L).astype(np.int32)
    if (L, N) not in KERNEL_VALID:
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


def fused_check(out, args, n):
    """The fused kernel's output ``out`` on ``args``: the contract checked
    exactly (identity padding, zero strict upper triangle) and the max abs
    errors over the valid blocks against float64, against the plain
    version in float32, and of the plain version against float64. Raises
    if the contract or a bound fails."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    L, N = out.shape[:2]
    plain = fused_chol.fused_gram_cholesky_reference(*args)
    ref64 = fused_chol.fused_gram_cholesky_reference(
        *(a.double() if a.is_floating_point() else a for a in args))
    ar = torch.arange(N, device=out.device)
    valid = ar[None, :] < torch.as_tensor(n, device=out.device)[:, None]
    v2 = valid[:, :, None] & valid[:, None, :]

    def err(a, b):
        return float(torch.where(v2, (a.double() - b.double()).abs(), 0.0).max())

    errs = dict(max_abs_err_vs_f64=err(out, ref64),
                max_abs_err_vs_plain_f32=err(out, plain),
                plain_f32_err_vs_f64=err(plain, ref64))
    del plain, ref64
    eye = torch.eye(N, device=out.device).expand(L, N, N)
    if not torch.equal(out[~v2], eye[~v2]):
        raise AssertionError(f"padding contract broken at ({L},{N})")
    if out.triu(1).any():
        raise AssertionError(f"upper triangle not zero at ({L},{N})")
    bound = min(KERNEL_TOL, KERNEL_PLAIN_FACTOR * errs["plain_f32_err_vs_f64"])
    if not (errs["max_abs_err_vs_f64"] <= bound):
        raise AssertionError(
            f"fused kernel at ({L},{N}): max abs err vs f64 "
            f"{errs['max_abs_err_vs_f64']} > {bound} (the smaller of {KERNEL_TOL}"
            f" and {KERNEL_PLAIN_FACTOR} x the plain version's)")
    errs["bound"] = bound
    return errs


def fused_bounds(n, L, N):
    """``(ms, bound_by, padded ms)``: the least time of the card for one
    fused call on valid sizes ``n``: the gram (2D + 6 operations per
    element, D = 1) and each leaf's Cholesky of its valid block; x and the
    per-leaf scalars read once, the factors written once. The padded time
    counts every leaf at N."""
    nv = np.asarray(n, np.float64)
    b_ms, b_by = bound_ms(float(np.sum(nv**3 / 3 + nv**2 * (2 * 1 + 6))),
                          4 * (L * N * 1 + 4 * L + L * N * N))
    padded_ms, _ = bound_ms(L * N**3 / 3, 4 * L * N * N)
    return b_ms, b_by, padded_ms


def _reps(L, N):
    return 20 if L * N**3 < 1e11 else 10


def phase_kernel():
    """Kernel vs plain on the card at ``KERNEL_SHAPES``; returns (max abs
    err vs f64, kernel ms, plain ms and bound summed over ``PATH_SHAPES``
    with tied hypers, and what bounds most of that sum)."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import fused_chol
    from deepstructuredmixtures_tpu_torch.ops.cholesky import masked_gram_noise
    from deepstructuredmixtures_tpu_torch.kernels import gram

    worst = 0.0
    path_ms = path_plain_ms = path_bound = path_bound_ops = 0.0
    card = card_line()
    sms, per_sm, smem = fused_chol.device_info("cuda")
    if smem != fused_chol.SMEM_BYTES:
        raise AssertionError(f"the kernel has {smem} bytes of shared memory, "
                             f"the plan assumes {fused_chol.SMEM_BYTES}")
    for seed, (L, N) in enumerate(KERNEL_SHAPES):
        plan = fused_chol.launch_plan(L, N, sms)
        for tied in (True, False):
            n, args = _kernel_inputs(L, N, tied, seed)
            out = fused_chol.fused_gram_cholesky(*args)
            torch.cuda.synchronize()
            errs = fused_check(out, args, n)
            del out
            reps = _reps(L, N)
            ms = cuda_ms(lambda: fused_chol.fused_gram_cholesky(*args), reps=reps)
            plain_ms = cuda_ms(lambda: fused_chol.fused_gram_cholesky_reference(*args),
                               reps=reps)
            # a yardstick for the factor alone: cuSOLVER on the ready gram
            x, nn, logl, logsigma, noise = args
            mask = torch.arange(N, device=x.device)[None, :] < nn[:, None]
            Kn = masked_gram_noise(gram("iso_se", logl[:, None], logsigma, x, x),
                                   mask, noise, 1e-8)
            chol_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(Kn), reps=reps)
            extra = {}
            if (L, N) in KERNEL_VALID:
                pad = KERNEL_VALID[(L, N)][2]
                Kv = Kn[:, :pad, :pad].contiguous()
                extra[f"cholesky_ex_factor_only_at_{pad}_ms"] = cuda_ms(
                    lambda: torch.linalg.cholesky_ex(Kv), reps=reps)
                del Kv
            del Kn
            torch.cuda.empty_cache()
            worst = max(worst, errs["max_abs_err_vs_f64"])
            b_ms, b_by, padded_ms = fused_bounds(n, L, N)
            if tied and (L, N) in PATH_SHAPES:
                path_ms += ms
                path_plain_ms += plain_ms
                path_bound += b_ms
                path_bound_ops += b_ms if b_by == "operations" else 0.0
            say("kernel", L=L, N=N, hypers="tied" if tied else "per-leaf",
                blocks_per_leaf=plan.blocks_per_leaf, grid=plan.grid,
                blocks_per_sm=per_sm, **errs, kernel_ms=ms, plain_ms=plain_ms,
                cholesky_ex_factor_only_ms=chol_ms, **extra, bound_ms=b_ms,
                bound_by=b_by, bound_padded_ms=padded_ms,
                kernel_over_bound=ms / b_ms, card=card)
    return worst, path_ms, path_plain_ms, path_bound, (
        "operations" if 2 * path_bound_ops >= path_bound else "bytes")


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


def _trsm_rel_err(got, want):
    """Largest ``|got - want|`` over ``max |want|`` of each pair."""
    return max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-300))
               for g, w in zip(got, want) if w.numel())


def _trsm_check(factors, rhs):
    """The kernel against the plain version on one table: relative error
    of vz, vv and z, each leaf's outputs finite."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import trsm

    got = trsm.forward_solve_moments(factors, rhs, want_z=True)
    torch.cuda.synchronize()
    want = trsm.forward_solve_moments_reference(factors, rhs, want_z=True)
    return (_trsm_rel_err([got[0], got[1], *got[2]], [want[0], want[1], *want[2]]),
            got)


def _trsm_timed(factors, rhs, label, reps):
    """Kernel, plain version and cuBLAS's float64 ``trsm`` (per entry, on
    a float64 copy made outside the timed call) on one table, with its
    bound: float64 operations over the padded columns (n² per column) at
    67 TFLOP/s (the tensor cores' DMMA), or the float32 lower triangles
    and the right-hand sides read once at 3.35 TB/s."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import trsm

    width = rhs[0].shape[-1]
    err, _ = _trsm_check(factors, rhs)
    if not (err <= TRSM_TOL):
        raise AssertionError(f"trsm kernel at {label}: rel err {err} (bound {TRSM_TOL})")
    ms = cuda_ms(lambda: trsm.forward_solve_moments(factors, rhs), warmup=2, reps=reps)
    plain_ms = cuda_ms(lambda: trsm.forward_solve_moments_reference(factors, rhs),
                       warmup=1, reps=max(2, reps // 4))
    lib_ms = 0.0
    for Lf, B in zip(factors, rhs):
        L64, B64 = Lf.double(), B.double()
        lib_ms += cuda_ms(lambda: torch.linalg.solve_triangular(L64, B64, upper=False),
                          warmup=1, reps=max(2, reps // 4))
        del L64, B64
    torch.cuda.empty_cache()
    flops = sum(Lf.shape[0] * Lf.shape[1] ** 2 * width for Lf in factors)
    nbytes = sum(Lf.shape[0] * Lf.shape[1] * (Lf.shape[1] / 2 + width) * 4 for Lf in factors)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    b_ms = 1e3 * max(t_ops, t_bytes)
    if not (ms >= b_ms):
        raise AssertionError(f"trsm kernel at {label}: {ms} ms is below its bound {b_ms} ms")
    say("trsm_timed", at=label, leaves=sum(Lf.shape[0] for Lf in factors), width=width,
        rel_err_vs_plain=err, kernel_ms=ms, plain_ms=plain_ms, cublas_trsm_f64_ms=lib_ms,
        bound_ms=b_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
        kernel_tflops=flops / ms / 1e9, kernel_over_cublas=ms / lib_ms, card=card_line())
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes", err=err)


def phase_trsm():
    """Phase 3b; returns the kernels-line entry (the serving chunk's
    times, the largest error of the checked tables)."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import potrf, trsm

    factors, valid = [], []
    for k, (G, n) in enumerate(TRSM_SHAPES):
        a64, v = _spd_batch(G, n, 50 + k)
        factors.append(potrf.blocked_cholesky(a64.float().contiguous()))
        valid.append(v)
        del a64
    gen = torch.Generator(device="cuda")
    max_err = 0.0
    for width in TRSM_WIDTHS:
        gen.manual_seed(width)
        rhs = []
        for Lf, v in zip(factors, valid):
            B = torch.randn(Lf.shape[:2] + (width,), generator=gen, device="cuda")
            for g, nv in enumerate(v):
                B[g, nv:] = 0.0
            rhs.append(B)
        err, got = _trsm_check(factors, rhs)
        if not (err <= TRSM_TOL) or not all(torch.isfinite(t).all() for t in
                                            (got[0], got[1], *got[2])):
            raise AssertionError(f"trsm kernel at width {width}: rel err {err} "
                                 f"(bound {TRSM_TOL}) or non-finite output")
        max_err = max(max_err, err)
        say("trsm", width=width, tiles=trsm.column_tiles(width), rel_err_vs_plain=err,
            bound=TRSM_TOL)
    # a NaN in the second leaf of the ragged batch: that leaf alone non-finite
    bad = factors[1].clone()
    bad[1, 700, 300] = float("nan")
    vz, vv, zs = trsm.forward_solve_moments([factors[0], bad], rhs[:2], want_z=True)
    fin = torch.isfinite(vz).all(1) & torch.isfinite(vv).all(1)
    if fin[2] or not (fin[:2].all() and fin[3:].all()) or torch.isfinite(zs[1][1]).all():
        raise AssertionError("a NaN factor did not come back non-finite on its leaf alone")
    del bad, vz, vv, zs, factors, rhs
    torch.cuda.empty_cache()

    # the serving path's chunk and the pass's largest one-leaf chunks
    x, y = make_data(100_000)
    model = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cuda",
                             dtype=torch.float32, do_fit=False, overlap=False)
    model.fit(store="hybrid", factor_budget=model._bucket_factor_bytes())
    entries = model._bucket_factors
    if not all(e is not None for e in entries):
        raise AssertionError("not every bucket cached")
    rng = np.random.default_rng(7)
    line = None
    for label, xt_np, picks in (
            ("serve_chunk_256", rng.uniform(0.0, 1.0, (256, 1)), None),
            ("pass_largest_leaves_T2000", np.linspace(-0.05, 1.05, T_TEST)[:, None], 2)):
        tidx, _ = model._route(xt_np)
        ti = torch.as_tensor(tidx, dtype=torch.long, device="cuda")
        xt = torch.as_tensor(xt_np, dtype=torch.float32, device="cuda")
        order = range(len(entries)) if picks is None else sorted(
            range(len(entries)), key=lambda k: -model.bucket_batches[k].nmax)[:picks]
        facs, rhs = [], []
        for k in order:
            b, ids = model.bucket_batches[k], model.bucket_spec.leaf_ids[k]
            idx = torch.as_tensor(ids, dtype=torch.long, device="cuda")
            sl = slice(0, b.num_leaves if picks is None else 1)
            facs.append(entries[k][0][sl])
            rhs.append(fitlib._rhs(model.layout, model.theta, b.rows(sl.start, sl.stop),
                                   xt[ti[idx][sl]]))
        t = _trsm_timed(facs, rhs, label, reps=10 if picks is None else 5)
        line = t if picks is None else line
        max_err = max(max_err, t["err"])
        del facs, rhs
    del model, entries
    torch.cuda.empty_cache()
    return dict(line, max_abs_err=max_err)


def _slice(n_train, dtype):
    """build → fit → update → predict at each request size; returns the
    model, evidence, predictions, the fused kernel's launches on fit and on
    predict and the blocked kernel's in all."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    x, y = make_data(n_train)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    reset_launches()
    trsm0 = trsm_launches()
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
    # the blocked kernel once per leaf chunk above nmax 1024, in the fit and
    # in each streamed predict; the forward-solve kernel once per such chunk
    # of each predict
    per_pass = _expected_launches(model)[1]
    if (blocked, launches()[1]) != (per_pass, (1 + len(REQUEST_SIZES)) * per_pass):
        raise AssertionError(f"the blocked kernel launched {blocked} times on "
                             f"the fit and {launches()[1]} in all, {per_pass} "
                             "per pass expected")
    solves = trsm_launches() - trsm0
    if solves != len(REQUEST_SIZES) * per_pass:
        raise AssertionError(f"the forward-solve kernel launched {solves} times, "
                             f"{per_pass} per predict expected")
    if model.posterior is not None:
        raise AssertionError(f"fit() kept the full store at N={n_train}")
    return dict(model=model, z=z, preds=preds, build_s=build_s, fit_s=fit_s,
                predict_s=predict_s, fit_launches=fit_launches,
                predict_launches=predict_launches,
                blocked_launches=launches()[1], trsm_launches=solves)


def slice_errors(run32, run64, sizes=REQUEST_SIZES):
    """Float32 run against float64 run: relative evidence error, max abs
    mean error and max relative variance error over the request sizes."""
    z32, z64 = run32["z"], run64["z"]
    errs = {"evidence_rel": abs(z32 - z64) / abs(z64), "mean_abs": 0.0,
            "var_rel": 0.0}
    for size in sizes:
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
        blocked_launches=run32["blocked_launches"],
        trsm_launches=run32["trsm_launches"],
        build_s=run32["build_s"], fit_s=run32["fit_s"],
        predict_s={str(k): v for k, v in run32["predict_s"].items()},
        evidence_f32=run32["z"], evidence_f64=run64["z"], errors_f32_vs_f64=errs,
        tolerances=SLICE_TOL, card=card_line())
    return run32, run64


def streamed_pipeline(model, refine_steps=0, leaves=False):
    """The benchmark's streamed pipeline on ``model`` at the T=2000 test
    points: ``bucketed_streamed_predict`` (with ``refine_steps``) →
    ``update_weights`` → ``_routed_moment_match``. Returns a function that
    runs it once, synchronized, and gives ``(mean, var, root evidence)``,
    with ``leaves`` followed by the leaf moments and mlls ``(mu [L, tmax],
    var [L, tmax], mll [L])``."""
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
            model.bucket_spec.leaf_ids, model.num_leaves, xtd, ti,
            refine_steps=refine_steps)
        lw, z = inferlib.update_weights(model.plan, mll)
        mean, v = _routed_moment_match(model.plan, mu, var, lw, ti, tm, T_TEST)
        if torch.device(model.device).type == "cuda":
            torch.cuda.synchronize()
        return (mean, v, z, mu, var, mll) if leaves else (mean, v, z)

    return pipeline


def headline_times(model, refine_steps=0):
    """Seconds of three warm, synchronized runs of the streamed pipeline
    (:func:`streamed_pipeline`), and the last run's ``(mean, var,
    evidence)``."""
    pipeline = streamed_pipeline(model, refine_steps)
    out = pipeline()  # warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = pipeline()
        times.append(time.perf_counter() - t0)
    return times, out


def phase_headline(model):
    """The headline wall-clock (min of 3); the blocked kernel launches once
    per leaf chunk of each run (warm run included), the fused one never (no
    bucket in its domain). Returns the seconds and the launches."""
    import torch

    expected = tuple(4 * n for n in _expected_launches(model))
    reset_launches()
    trsm0 = trsm_launches()
    times, (mean, v, _) = headline_times(model)
    if launches() != expected or expected[0]:
        raise AssertionError(f"the headline launched {launches()}, expected "
                             f"{expected}")
    if trsm_launches() - trsm0 != expected[1]:
        raise AssertionError(f"the headline's forward solves launched "
                             f"{trsm_launches() - trsm0} times, expected {expected[1]}")
    if not (torch.isfinite(mean).all() and torch.isfinite(v).all()):
        raise AssertionError("headline pipeline gave non-finite moments")
    say("headline", metric="dsmgp_v3k4_fit_update_predict_n100000_t2000_wallclock",
        seconds=min(times), runs=times, dtype=str(model.dtype),
        launches=expected, card=card_line())
    return min(times), expected


def _depth4_model(dtype, overlap=True):
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(DEPTH4_N)
    return tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                            log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                            do_fit=False, depth=4, overlap=overlap)


def phase_depth4():
    """The headline pipeline on the depth-4 tree at N=100k, where most
    leaves fall in the fused kernel's domain: the kernel must launch once
    per leaf chunk of each fused bucket and never on a bucket above 1024,
    the blocked one once per leaf chunk above it; the float32 run's
    evidence and moments against float64 on the card; the wall-clock (min
    of 3 warm runs) and the fused kernel's share of the device time under
    ``torch.profiler``. Returns the ``(fused, blocked)`` launches in one
    run of the pipeline."""
    import torch

    import chip_profile
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    from deepstructuredmixtures_tpu_torch.models import FULL_STORE_BYTES

    # the build with and without the overlap analysis and the schedule
    t0 = time.perf_counter()
    _depth4_model(torch.float32, overlap=False)
    build_no_overlap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = _depth4_model(torch.float32)
    build_s = time.perf_counter() - t0
    if model._factor_bytes() <= FULL_STORE_BYTES:
        raise AssertionError("fit() would keep the full store at depth 4")
    expected = _expected_launches(model)
    fused = [(nm, len(ids)) for nm, ids in zip(model.bucket_spec.nmaxs,
                                               model.bucket_spec.leaf_ids)
             if fused_chol.supported(nm, model.dtype, model.layout.kinds,
                                     model.device)]
    # every shape the kernel is called with, for this phase only
    shapes = []
    kernel = fused_chol.fused_gram_cholesky

    def recording(x, *args, **kw):
        shapes.append(tuple(x.shape[:2]))
        return kernel(x, *args, **kw)

    pipeline = streamed_pipeline(model)
    fused_chol.fused_gram_cholesky = recording
    try:
        reset_launches()
        trsm0 = trsm_launches()
        pipeline()  # the first run builds nothing new: phase 1 built the kernels
        got, blocked = launches()
        solves = trsm_launches() - trsm0
    finally:
        fused_chol.fused_gram_cholesky = kernel
    if (got, blocked, solves) != expected + expected[1:]:
        raise AssertionError(f"depth 4: launches {(got, blocked)} and {solves} "
                             f"forward solves, expected {expected + expected[1:]}")
    if len(shapes) != got or any(N > fused_chol.MAX_N for _, N in shapes):
        raise AssertionError(f"depth 4: the fused kernel saw the shapes {shapes}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        mean, v, z = pipeline()
        times.append(time.perf_counter() - t0)
    prof = chip_profile.profile("streamed_depth4", pipeline, quiet=True)
    if not prof["device_kernels_ms"] > 0:
        raise AssertionError("depth 4: the profiler saw no device time")
    share = prof["split"]["fused_gram_cholesky"]["ms"] / prof["device_kernels_ms"]
    del pipeline
    model64 = _depth4_model(torch.float64)
    mean64, v64, z64 = streamed_pipeline(model64)()
    del model64
    run32 = {"z": float(z), "preds": {T_TEST: (mean, v)}}
    run64 = {"z": float(z64), "preds": {T_TEST: (mean64, v64)}}
    errs = slice_errors(run32, run64, sizes=(T_TEST,))
    for key, tol in SLICE_TOL.items():
        if not (errs[key] <= tol):
            raise AssertionError(f"depth 4: f32 vs f64 {key} = {errs[key]} > {tol}")
    say(f"depth4_n{DEPTH4_N}", leaves=model.num_leaves,
        buckets=len(model.bucket_spec.nmaxs), fused_buckets=fused,
        fused_launches=got, blocked_launches=blocked,
        launches_expected=expected,
        fused_shapes=shapes, build_s=build_s,
        build_s_overlap_false=build_no_overlap_s,
        metric="dsmgp_v3k4_depth4_fit_update_predict_n100000_t2000_wallclock",
        seconds=min(times), runs=times, evidence_f32=float(z),
        evidence_f64=float(z64),
        errors_f32_vs_f64=errs, tolerances=SLICE_TOL,
        fused_share_of_device_time=share, profile=prof, card=card_line())
    return got, blocked


def _launch_shapes(model):
    """The ``(kernel, (leaves, nmax))`` of each kernel launch in one pass
    over the size buckets, one per leaf chunk by the fit's own chunk rule:
    of ``fit(store='hybrid')`` with every bucket cached, of the light fit,
    and of one streamed pass, refined or not (the fused kernel where it
    applies, else the blocked one above nmax 1024: ``fit._kept_recipe``)."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

    out = []
    for b in model.bucket_batches:
        if fused_chol.supported(b.nmax, b.x.dtype, model.layout.kinds,
                                model.device):
            kernel = "fused"
        elif potrf.supported(b.nmax, b.x.dtype, model.device):
            kernel = "blocked"
        else:
            continue
        c = fitlib._bucket_chunk(b.nmax, b.num_leaves, b.x.dtype)
        out += [(kernel, (min(c, b.num_leaves - s), b.nmax))
                for s in range(0, b.num_leaves, c)]
    return out


def _expected_launches(model, max_bytes=None):
    """``(fused, blocked)`` launches of the pass of :func:`_launch_shapes`;
    with ``max_bytes`` over the buckets whose one covariance takes at most
    that many bytes (those ``fit(mesh=)`` keeps local)."""
    item = model.dtype.itemsize
    kernels = [k for k, (_, nmax) in _launch_shapes(model)
               if max_bytes is None or nmax * nmax * item <= max_bytes]
    return kernels.count("fused"), kernels.count("blocked")


def _blocked_shapes(model):
    """The distinct ``(leaves, nmax)`` the blocked kernel factors in the
    pass of :func:`_launch_shapes`."""
    return sorted({s for k, s in _launch_shapes(model) if k == "blocked"})


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
    trsm0, solves = trsm_launches(), 0
    for size in REQUEST_SIZES:
        sel = np.linspace(0, T_TEST - 1, size).astype(int)
        solves += _predict_trsm_launches(model, xt[sel], kw.get("return_var", True))
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
    if trsm_launches() - trsm0 != solves:
        raise AssertionError(f"the cached predicts launched {trsm_launches() - trsm0} "
                             f"forward solves, expected {solves}")
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


def _full_model(n_train, dtype):
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(n_train)
    return tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                            log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                            do_fit=False, overlap=True)


def _min_of_3(fn):
    """``(min, runs)`` of three synchronized calls of ``fn``, which returns
    its own seconds, after one warm call."""
    fn()
    runs = [fn() for _ in range(3)]
    return min(runs), runs


def _predict_seconds(model, xt):
    import torch

    def run():
        t0 = time.perf_counter()
        mean, var = model.predict(xt)
        torch.cuda.synchronize()
        if not (torch.isfinite(mean).all() and torch.isfinite(var).all()):
            raise AssertionError("non-finite moments")
        return time.perf_counter() - t0

    return run


def phase_full_store(n_train, kernel):
    """The full store and the shared schedule at ``n_train`` points (see the
    module docstring, phase 8). Returns the ``(fused, blocked)`` launches
    of the main path: ``fit()`` → ``update`` → ``predict``."""
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib

    t0 = time.perf_counter()
    model = _full_model(n_train, torch.float32)
    build_s = time.perf_counter() - t0
    sched, L = model.schedule, model.num_leaves
    chunks = math.ceil(L / fitlib.default_chunk(model.plan.nmax, model.dtype))
    expected = (chunks, 0) if kernel == "fused" else (0, chunks)
    reset_launches()
    fit_s = model.fit()
    if model.posterior is None:
        raise AssertionError(f"fit() did not keep the full store at N={n_train}")
    run32 = {"z": model.update()}
    run32["preds"], predict_s = _timed_predicts(model)
    path_launches = launches()
    if path_launches != expected:
        raise AssertionError(f"N={n_train}: launches {path_launches}, "
                             f"expected {expected} ({kernel})")
    model64 = _full_model(n_train, torch.float64)
    model64.fit(store="full")
    run64 = {"z": model64.update()}
    run64["preds"], _ = _timed_predicts(model64)
    errs = _compare(run32, run64)

    batched_s, batched_runs = _min_of_3(lambda: model.fit(method="batched"))
    reset_launches()
    shared_s, shared_runs = _min_of_3(lambda: model.fit(method="shared"))
    shared_launches = [n // 4 for n in launches()]  # per shared fit
    fallbacks = dict(model.last_fit_diagnostics)
    z_shared = model.update()
    split = {}
    fitlib.fit_shared(model.layout, model.theta, model.batch, sched,
                      split=split)
    evidence_rel = abs(z_shared - run64["z"]) / abs(run64["z"])
    if not (evidence_rel <= SLICE_TOL["evidence_rel"]):
        raise AssertionError(f"N={n_train}: shared f32 evidence vs f64 "
                             f"{evidence_rel} > {SLICE_TOL['evidence_rel']}")
    mll_batched64 = model64.mll()
    model64.fit(method="shared", store="full")
    mll_gap64 = abs(model64.mll() - mll_batched64)
    if not (mll_gap64 <= SHARED_MLL_TOL):
        raise AssertionError(f"N={n_train}: f64 shared vs batched root mll "
                             f"{mll_gap64} > {SHARED_MLL_TOL}")
    fallbacks64 = dict(model64.last_fit_diagnostics)
    del model64

    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    model.fit()
    full_predict_s, full_runs = _min_of_3(_predict_seconds(model, xt))
    model.fit(store="light")
    streamed_predict_s, streamed_runs = _min_of_3(_predict_seconds(model, xt))
    say(f"full_store_n{n_train}", leaves=L, nmax=model.plan.nmax,
        kernel=kernel, factor_bytes=model._factor_bytes(), build_s=build_s,
        fit_s=fit_s, launches_main_path=path_launches,
        predict_s={str(k): v for k, v in predict_s.items()},
        errors_f32_vs_f64=errs, tolerances=SLICE_TOL,
        schedule={"derived_fraction": sched.num_derived / L,
                  "full": int(sched.full_idx.size),
                  "copy": int(sched.copy_j.size),
                  "delete": int(sched.del_j.size),
                  "continue": int(sched.cont_j.size),
                  "deletions": int(sched.del_ndel.sum()
                                   + sched.cont_del_ndel.sum())},
        batched_fit_s=batched_s, batched_runs=batched_runs,
        shared_fit_s=shared_s, shared_runs=shared_runs,
        shared_over_batched=shared_s / batched_s,
        shared_launches_per_fit=shared_launches, shared_split_s=split,
        fallbacks_f32=fallbacks, fallbacks_f64=fallbacks64,
        shared_evidence_f32_rel_vs_f64=evidence_rel,
        shared_vs_batched_root_mll_f64=mll_gap64,
        predict_t2000_full_store_s=full_predict_s, full_runs=full_runs,
        predict_t2000_light_streamed_s=streamed_predict_s,
        streamed_runs=streamed_runs, card=card_line())
    return path_launches


#: the errors that refinement must not raise above the unrefined ones: the
#: moments. The evidence keeps the float32 factor's log-determinant by
#: design (``ops/refine.refined_mll``), so its error sits at that floor,
#: which the unrefined quad term's error can partly cancel: on the CPU at
#: N=2000 in float32 one step gave 8.19e-7 against 7.97e-7 unrefined
REFINE_NOT_WORSE = ("mean_abs", "var_rel")


def _refined_errors(name, errs, base):
    """Gate of phase 9: each refined error within ``SLICE_TOL``, and the
    moments' no larger than the unrefined ones ``base``."""
    for key, tol in SLICE_TOL.items():
        if not (errs[key] <= tol
                and (key not in REFINE_NOT_WORSE or errs[key] <= base[key])):
            raise AssertionError(f"{name}: refined {key} = {errs[key]}, "
                                 f"unrefined {base[key]}, bound {tol}")


def phase_refine(run20k, run20k64, run100k, run100k64, headline_s):
    """Mixed-precision refinement (``refine_steps``) against the float64
    runs of phases 4-5. The refined path factors with the fused kernel up
    to nmax 1024 and the blocked kernel above (``fit._factor``):
    each kernel launches once per leaf chunk of its buckets. N=20k:
    ``predict(xt, refine_steps=k)`` at T=2000 for k = 1, 2 (3 fused and 15
    blocked launches each) and the refined streamed pipeline's evidence;
    every refined error within ``SLICE_TOL``, the moments' no larger than
    the unrefined ones (:data:`REFINE_NOT_WORSE`). N=100k: the headline
    pipeline with one step (119 blocked launches; min of 2, peak memory,
    errors) beside the float32 headline and the float64 pipeline (min of
    3); ``chip_profile.py --refine-steps 1`` and ``--float64`` split their
    device time. Returns the ``(fused, blocked)`` launches of the two
    refined predicts and one refined headline run."""
    import torch

    card = card_line()
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    model = run20k["model"]
    base = slice_errors(run20k, run20k64, sizes=(T_TEST,))
    expected = _expected_launches(model)
    if expected != (3, 15):
        raise AssertionError(f"N=20k: {expected} launches per refined pass")
    path_launches = np.zeros(2, dtype=int)
    steps = {}
    for k in (1, 2):
        reset_launches()
        t0 = time.perf_counter()
        mean, var = model.predict(xt, refine_steps=k)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        got = launches()
        if got != expected:
            raise AssertionError(f"refined predict at N=20k: launches {got}, "
                                 f"expected {expected}")
        path_launches += got
        if mean.dtype != torch.float64 or var.dtype != torch.float64:
            raise AssertionError("refined moments are not float64")
        _, _, z = streamed_pipeline(model, k)()
        errs = slice_errors({"z": float(z), "preds": {T_TEST: (mean, var)}},
                            run20k64, sizes=(T_TEST,))
        _refined_errors(f"N=20k, {k} steps", errs, base)
        steps[str(k)] = dict(errors_f32_vs_f64=errs, predict_s=predict_s,
                             launches=got)
    say("refine_n20000", steps=steps, unrefined_errors_f32_vs_f64=base,
        tolerances=SLICE_TOL, card=card)

    model, model64 = run100k["model"], run100k64["model"]
    base = slice_errors(run100k, run100k64, sizes=(T_TEST,))
    expected = _expected_launches(model)
    pipeline = streamed_pipeline(model, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pipeline()  # the counted run warms the timed ones
    got = launches()
    peak = torch.cuda.max_memory_allocated()
    if got != expected or got[0]:
        raise AssertionError(f"the refined headline launched {got}, expected "
                             f"{expected} (no fused bucket)")
    path_launches += got
    times = []
    for _ in range(2):  # min of 2, not 3: phase 9 is the smoke's longest
        t0 = time.perf_counter()
        mean, var, z = pipeline()
        times.append(time.perf_counter() - t0)
    errs = slice_errors({"z": float(z), "preds": {T_TEST: (mean, var)}},
                        run100k64, sizes=(T_TEST,))
    for key, tol in SLICE_TOL.items():
        if not (errs[key] <= tol):
            raise AssertionError(f"refined headline: {key} = {errs[key]} > {tol}")
    times64, _ = headline_times(model64)
    say("refine_n100000",
        metric="dsmgp_v3k4_fit_update_predict_refine1_n100000_t2000_wallclock",
        seconds=min(times), runs=times, peak_memory_bytes=peak,
        errors_f32_vs_f64=errs, unrefined_errors_f32_vs_f64=base,
        tolerances=SLICE_TOL,
        headline_s={"float32": headline_s, "float32_refine1": min(times),
                    "float64": min(times64)},
        launches_fused_blocked=got, float64_runs=times64, card=card)
    return tuple(int(n) for n in path_launches)


#: phase 10's GP: training points, and its float64 gradient's bound against
#: a central difference of step GP_FD_STEP (relative, per component)
GP_N, GP_FD_STEP, GP_GRAD_TOL = 8192, 1e-4, 1e-6
#: phase 10's IsoLinear GP: the points of the mixture's worst IsoLinear leaf
GP_LINEAR_N = 7600
#: the full covariance's diagonal against the marginal variance (relative)
GP_DIAG_TOL = {"float32": 1e-4, "float64": 1e-10}


def _timed(fn):
    """``fn`` wrapped to return its own synchronized seconds."""
    import torch

    def run():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return run


def phase_gp():
    """The standalone ``GaussianProcess`` on the card at N=8192 (the
    benchmark's 1-D data, IsoSE(0, 0), log noise -1) in float32 and
    float64: fit, predict at T=2000 and ``grad_mll`` (min of 3 each); the
    float32 mll, mean and variance against float64 within ``SLICE_TOL``;
    the full covariance's diagonal against the marginal variance; the
    float64 gradient against a central finite difference; then the
    IsoLinear GP (:func:`_gp_iso_linear`). In float32 every fit and
    ``grad_mll`` takes the kept route (one blocked launch each: four fits
    and four gradients, the min of 3 after a warm call). Returns the
    ``(fused, blocked)`` launches of both GPs."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(GP_N)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(0.0, 0.0),
                                  log_noise=-1.0, device="cuda", dtype=dtype)
        reset_launches()
        fit_s, _ = _min_of_3(_timed(gp.fit))
        predict_s, _ = _min_of_3(_timed(lambda: gp.predict(xt)))
        grad_s, _ = _min_of_3(_timed(gp.grad_mll))
        mean, var = gp.predict(xt)
        _, Sigma = gp.predict(xt, full_cov=True)
        diag_rel = float(((Sigma.diagonal() - var).abs() / var.abs()).max())
        if not (diag_rel <= GP_DIAG_TOL[name]):
            raise AssertionError(f"GP {name}: full_cov diagonal vs variance "
                                 f"{diag_rel} > {GP_DIAG_TOL[name]}")
        if not (torch.isfinite(mean).all() and (var > 0).all()):
            raise AssertionError(f"GP {name}: non-finite or non-positive moments")
        out[name] = dict(gp=gp, z=gp.mll(), preds={T_TEST: (mean, var)},
                         times=dict(fit_s=fit_s, predict_t2000_s=predict_s,
                                    grad_mll_s=grad_s), diag_rel=diag_rel,
                         launches=launches())
        expected = (0, 8) if dtype == torch.float32 else (0, 0)
        if out[name]["launches"] != expected:
            raise AssertionError(f"GP {name} launched {out[name]['launches']}, "
                                 f"expected {expected}")
        del Sigma
    errs = slice_errors(out["float32"], out["float64"], sizes=(T_TEST,))
    for key, tol in SLICE_TOL.items():
        if not (errs[key] <= tol):
            raise AssertionError(f"GP f32 vs f64 {key} = {errs[key]} > {tol}")
    gp = out["float64"]["gp"]
    g = gp.grad_mll().cpu().numpy()
    theta = gp.theta.cpu().numpy()
    fd = np.zeros_like(g)
    for i in range(theta.size):
        mlls = []
        for sign in (1.0, -1.0):
            t = theta.copy()
            t[i] += sign * GP_FD_STEP
            gp.set_params(t)
            mlls.append(gp.mll())
        fd[i] = (mlls[0] - mlls[1]) / (2 * GP_FD_STEP)
    grad_rel = float(np.max(np.abs(g - fd) / np.abs(fd)))
    if not (grad_rel <= GP_GRAD_TOL):
        raise AssertionError(f"GP grad_mll vs finite difference {grad_rel}")
    say(f"gp_n{GP_N}", n=GP_N, t=T_TEST,
        times={k: v["times"] for k, v in out.items()},
        mll={k: v["z"] for k, v in out.items()}, errors_f32_vs_f64=errs,
        launches={k: v["launches"] for k, v in out.items()},
        tolerances=SLICE_TOL, full_cov_diag_rel={k: v["diag_rel"]
                                                  for k, v in out.items()},
        grad_mll_f64=g.tolist(), grad_rel_vs_finite_difference=grad_rel,
        card=card_line())
    return tuple(a + b for a, b in zip(out["float32"]["launches"],
                                       _gp_iso_linear()))


def _gp_iso_linear():
    """``GaussianProcess(kernel=IsoLinear(0))`` on the mixture's worst
    IsoLinear leaf's span (7,600 points at x in [0.75, 0.82], as
    ``tests/test_torch_cuda.py`` builds it), log noise -1: its mll and
    ``grad_mll`` in float32 against float64 by phase 11's bounds. The
    float32 fit and gradient take the kept route (one blocked launch each).
    Returns the ``(fused, blocked)`` launches."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(0.75, 0.82, GP_LINEAR_N)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, GP_LINEAR_N)
    out, secs = {}, {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoLinear(0.0),
                                  log_noise=-1.0, device="cuda", dtype=dtype)
        reset_launches()
        t0 = time.perf_counter()
        mll = gp.mll()
        t1 = time.perf_counter()
        g = gp.grad_mll().double().cpu().numpy()
        secs[name] = {"fit_s": t1 - t0, "grad_mll_s": time.perf_counter() - t1}
        out[name] = (mll, g, launches())
    got = out["float32"][2]
    if got != (0, 2) or out["float64"][2] != (0, 0):
        raise AssertionError(f"IsoLinear GP launched {got} / {out['float64'][2]}")
    mll_rel, grad_rel = _objective_gates(
        "IsoLinear GP", {"gp": out["float32"][:2]}, {"gp": out["float64"][:2]})
    say(f"gp_iso_linear_n{GP_LINEAR_N}", n=GP_LINEAR_N, times=secs,
        mll={k: v[0] for k, v in out.items()}, launches=got,
        mll_f32_rel_vs_f64=mll_rel["gp"], grad_f32_rel_vs_f64=grad_rel["gp"],
        tolerances={"mll_rel": SLICE_TOL["evidence_rel"],
                    "grad_rel": TRAIN_GRAD_TOL}, card=card_line())
    return got


#: training (phase 11): the float32 gradient against float64 on the card,
#: relative in norm: float32 Cholesky backward on leaves whose condition
#: number is about 1e5 (noise e^-2, n up to 16k); the float64 gradient
#: against a central difference of step TRAIN_FD_STEP per component,
#: |g - fd| <= TRAIN_FD_TOL * max(1, |fd|) (tests/test_train.py:68-81); the
#: fine-tune candidate gradients, sparse pair list against every pair, in
#: float64 (the bound of tests/test_train.py:242-243)
TRAIN_GRAD_TOL, TRAIN_FD_TOL, TRAIN_FD_STEP, FT_SPARSE_TOL = 1e-2, 1e-4, 1e-5, 1e-10
TRAIN_LR = 1e-2
#: train iterations at N=20k and N=100k, fine-tune iterations, train_gp
#: iterations
TRAIN_ITERS = {20_000: 5, 100_000: 2, "finetune": 1, "gp": 5}


def _train_model(n_train, dtype, overlap=False):
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(n_train)
    return tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                            log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                            do_fit=False, overlap=overlap)


def _recording(opt_cls, record, **kw):
    """A factory of ``opt_cls`` whose ``step`` first appends to ``record``
    the synchronized time, the kernel launches so far and the gradient it
    ascends (``-grad``): one entry per training iteration."""
    import torch

    class Recording(opt_cls):
        def step(self, closure=None):
            torch.cuda.synchronize()
            p = self.param_groups[0]["params"][0]
            record.append((time.perf_counter(), launches(), -p.grad.clone()))
            return super().step(closure)

    return lambda params: Recording(params, **kw)


def _iteration_seconds(t0, record):
    """Seconds of each iteration: the first from ``t0`` (cold: it builds
    the route and runs the first gradient), then step to step (warm)."""
    stamps = [t0] + [r[0] for r in record]
    return [b - a for a, b in zip(stamps, stamps[1:])]


def _rel(a, b):
    """Relative error of ``a`` against ``b`` in norm."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _train_run(model, iterations):
    """``train(model, Adam, iterations, randinit=False)`` with every
    iteration recorded; checks that each iteration's gradient launched the
    kernels as the plan counts (:func:`_train_launches`: the blocked kernel
    on the objective's kept route, the fused one never) and that the mll
    curve ascends. Returns ``(hist, record, iteration seconds, train
    seconds, refit launches)``."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    per = _train_launches(model)
    record = []
    reset_launches()
    t0 = time.perf_counter()
    hist = tdsm.train(model, _recording(torch.optim.Adam, record, lr=TRAIN_LR),
                      iterations=iterations, randinit=False, progress=False)
    train_s = time.perf_counter() - t0
    if [r[1] for r in record] != [tuple((i + 1) * v for v in per)
                                  for i in range(len(record))]:
        raise AssertionError(f"training launched {[r[1] for r in record]}, "
                             f"expected {per} an iteration")
    if not (hist.shape == (iterations,) and np.all(np.diff(hist) > 0)):
        raise AssertionError(f"the mll curve does not ascend: {hist.tolist()}")
    refit = tuple(a - b for a, b in zip(launches(), record[-1][1]))
    return hist, record, _iteration_seconds(t0, record), train_s, refit


def phase_train_20k():
    """Training at N=20k (every bucket below nmax 4096: one graph through
    all buckets): the root mll and its gradient at the start hypers in
    float32 against float64, the gradient's launches as the plan counts
    (:func:`_train_launches`: in float32 the blocked kernel once per leaf
    chunk of the 15 buckets above nmax 1024, the fused one never), the
    float64 gradient against a central difference; then ``train`` (Adam,
    lr 1e-2, 5 iterations), whose refit factors the three fused buckets
    with the fused kernel and the 15 above nmax 1024 with the blocked one.
    Returns the ``(fused, blocked)`` launches of the float32 gradient,
    the training iterations and the refit."""
    import torch

    from deepstructuredmixtures_tpu_torch.train import (_train_vg,
                                                         make_mll_fn_bucketed)

    n = 20_000
    m32, m64 = _train_model(n, torch.float32), _train_model(n, torch.float64)
    out = {}
    for name, m in (("float32", m32), ("float64", m64)):
        vg = _train_vg(m)
        reset_launches()
        t0 = time.perf_counter()
        val, g = vg(m.theta)
        torch.cuda.synchronize()
        out[name] = dict(mll=float(val), grad=g.double().cpu().numpy(),
                         grad_s=time.perf_counter() - t0, launches=launches())
        if out[name]["launches"] != _train_launches(m):
            raise AssertionError(f"N=20k {name} gradient launched "
                                 f"{out[name]['launches']}, expected "
                                 f"{_train_launches(m)}")
    mll_rel = abs(out["float32"]["mll"] - out["float64"]["mll"]) / abs(
        out["float64"]["mll"])
    grad_rel = _rel(out["float32"]["grad"], out["float64"]["grad"])
    if not (mll_rel <= SLICE_TOL["evidence_rel"] and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"N=20k f32 vs f64: mll {mll_rel}, grad {grad_rel}")
    f = make_mll_fn_bucketed(m64.layout, m64.plan, m64.bucket_batches,
                             m64.bucket_spec.leaf_ids)
    theta = m64.theta.cpu().numpy()
    fd = np.zeros_like(theta)
    with torch.no_grad():
        for i in range(theta.size):
            vals = []
            for sign in (1.0, -1.0):
                t = theta.copy()
                t[i] += sign * TRAIN_FD_STEP
                vals.append(float(f(torch.as_tensor(t, device="cuda"))))
            fd[i] = (vals[0] - vals[1]) / (2 * TRAIN_FD_STEP)
    g64 = out["float64"]["grad"]
    fd_err = np.abs(g64 - fd) / np.maximum(1.0, np.abs(fd))
    if not np.all(fd_err <= TRAIN_FD_TOL):
        raise AssertionError(f"N=20k f64 gradient {g64} vs difference {fd}")
    del m64
    hist, record, it_s, train_s, refit = _train_run(m32, TRAIN_ITERS[n])
    if refit != _expected_launches(m32) or m32.posterior is not None:
        raise AssertionError(f"N=20k refit launched {refit}, expected "
                             f"{_expected_launches(m32)}")
    say("train_n20000", route="make_mll_fn_bucketed under autograd",
        mll={k: v["mll"] for k, v in out.items()},
        grad={k: v["grad"].tolist() for k, v in out.items()},
        grad_s={k: v["grad_s"] for k, v in out.items()},
        mll_f32_rel_vs_f64=mll_rel, grad_f32_rel_vs_f64=grad_rel,
        grad_f64_vs_finite_difference=float(fd_err.max()),
        tolerances={"mll_rel": SLICE_TOL["evidence_rel"],
                    "grad_rel": TRAIN_GRAD_TOL, "fd": TRAIN_FD_TOL},
        grad_launches=out["float32"]["launches"], train_hist=hist.tolist(),
        iteration_s=it_s, train_s=train_s, train_launches=record[-1][1],
        refit_launches=refit, card=card_line())
    return tuple(a + b + c for a, b, c in zip(out["float32"]["launches"],
                                              record[-1][1], refit))


def phase_train_100k():
    """Training at the headline width, N=100k (the per-bucket route: one
    graph per leaf chunk): ``train`` (Adam, lr 1e-2, 2 iterations) with its
    cold and warm seconds per iteration, the mll curve and peak memory; the
    first iteration's float32 gradient against the float64 gradient at the
    same hypers. Returns the trained float32 model and the launches of
    its iterations and refit."""
    import torch

    from deepstructuredmixtures_tpu_torch.train import _train_vg

    n = 100_000
    m32 = _train_model(n, torch.float32, overlap=True)
    if max(b.nmax for b in m32.bucket_batches) < 4096:
        raise AssertionError("N=100k: expected buckets above nmax 4096")
    torch.cuda.reset_peak_memory_stats()
    hist, record, it_s, train_s, refit = _train_run(m32, TRAIN_ITERS[n])
    peak = torch.cuda.max_memory_allocated()
    if refit != _expected_launches(m32):
        raise AssertionError(f"N=100k refit launched {refit}, expected "
                             f"{_expected_launches(m32)}")
    m64 = _train_model(n, torch.float64)
    t0 = time.perf_counter()
    v64, g64 = _train_vg(m64)(m64.theta)
    torch.cuda.synchronize()
    grad64_s = time.perf_counter() - t0
    g64 = g64.cpu().numpy()
    del m64
    g32 = record[0][2].double().cpu().numpy()
    mll_rel = abs(hist[0] - float(v64)) / abs(float(v64))
    grad_rel = _rel(g32, g64)
    if not (mll_rel <= SLICE_TOL["evidence_rel"] and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"N=100k f32 vs f64: mll {mll_rel}, grad {grad_rel}")
    say("train_n100000", route="make_value_and_grad_bucketed",
        leaves=m32.num_leaves, nmax_max=max(b.nmax for b in m32.bucket_batches),
        train_hist=hist.tolist(), iteration_s=it_s,
        cold_iteration_s=it_s[0], warm_iteration_s=it_s[1:], train_s=train_s,
        peak_memory_bytes=peak, mll_f32_rel_vs_f64=mll_rel,
        grad_f32=g32.tolist(), grad_f64=g64.tolist(), grad_f64_s=grad64_s,
        grad_f32_rel_vs_f64=grad_rel, train_launches=record[-1][1],
        refit_launches=refit, card=card_line())
    return m32, tuple(a + b for a, b in zip(record[-1][1], refit))


def phase_finetune_4k():
    """Fine-tuning the full-store model of phase 8 at N=4k: every leaf a
    candidate (144), through the monolithic batch, as ``finetune`` routes
    it; the sparse pair-list candidate gradients against the all-pairs ones
    in float64 on the card, float32 against float64; one ``finetune``
    iteration, timed, with no kernel launched before the refit, which keeps
    the full store under per-leaf hypers and launches the fused kernel
    once. Returns the refit's launches."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.train import (
        _candidate_rows, make_finetune_vg_bucketed)

    n = 4_000
    out = {}
    for dtype in (torch.float64, torch.float32):
        m = _full_model(n, dtype)
        L = m.num_leaves
        Dd = _candidate_rows(m.plan.overlap, np.arange(L))
        np.fill_diagonal(Dd, 1.0)
        W = torch.as_tensor(Dd, dtype=dtype, device="cuda")
        H = m.theta.expand(L, -1).contiguous()
        for sparse in ((False, True) if dtype == torch.float64 else (True,)):
            vg = make_finetune_vg_bucketed(m.layout, m.plan, [m.batch],
                                           [np.arange(L)], sparse=sparse)
            reset_launches()
            t0 = time.perf_counter()
            mll, G = vg(H, W)
            torch.cuda.synchronize()
            key = f"{str(dtype).split('.')[-1]}_{'sparse' if sparse else 'dense'}"
            out[key] = dict(G=G.double().cpu().numpy(), s=time.perf_counter() - t0,
                            launches=launches())
            if out[key]["launches"] != (0, 0):
                raise AssertionError(f"N=4k {key} launched {out[key]['launches']}")
    density = float((Dd != 0).mean())
    d, sp = out["float64_dense"]["G"], out["float64_sparse"]["G"]
    sparse_err = float(np.max(np.abs(sp - d) / (1.0 + np.abs(d))))
    f32_rel = _rel(out["float32_sparse"]["G"], sp)
    if not (sparse_err <= FT_SPARSE_TOL and f32_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"N=4k candidate gradients: sparse vs dense "
                             f"{sparse_err}, f32 vs f64 {f32_rel}")
    record = []
    reset_launches()
    t0 = time.perf_counter()
    hist = tdsm.finetune(m, _recording(torch.optim.Adam, record, lr=TRAIN_LR),
                         iterations=TRAIN_ITERS["finetune"], progress=False)
    finetune_s = time.perf_counter() - t0
    refit = launches()
    if record[0][1] != (0, 0) or refit != (1, 0) or m.posterior is None:
        raise AssertionError(f"N=4k finetune: launches {record[0][1]} before "
                             f"and {refit} after the refit, full store "
                             f"{m.posterior is not None}")
    if not (m.theta.shape == (L, m.layout.total) and np.isfinite(hist).all()):
        raise AssertionError("N=4k finetune did not untie the hypers")
    say("finetune_n4000", leaves=L, candidates=L, route="monolithic batch",
        overlap_density=density,
        candidate_grad_s={k: v["s"] for k, v in out.items()},
        sparse_vs_dense_f64=sparse_err, grad_f32_rel_vs_f64=f32_rel,
        tolerances={"sparse": FT_SPARSE_TOL, "grad_rel": TRAIN_GRAD_TOL},
        finetune_hist=hist.tolist(), iteration_s=_iteration_seconds(t0, record),
        finetune_s=finetune_s, refit_launches=refit, card=card_line())
    return refit


def phase_finetune_100k(model):
    """One ``finetune`` iteration on the trained N=100k model for its two
    largest and two smallest leaves (the per-bucket route, the sparse pair
    list), timed, with peak memory; the blocked kernel launches in the
    gradient as the plan counts (:func:`_finetune_launches`) and once per
    leaf chunk in the refit, the fused one never (every bucket is above its
    domain). Returns the launches."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.train import _candidate_rows

    sizes = np.array([o.size for o in model.plan.leaf_obs])
    order = np.argsort(sizes, kind="stable")
    pick = np.concatenate([order[-2:], order[:2]])
    cand = np.unique(pick)
    W = _candidate_rows(model.plan.overlap, cand)
    W[np.arange(cand.size), cand] = 1.0
    grad_expected = _finetune_launches(model, cand, W, sparse=None)
    theta0 = model.theta.cpu().numpy()
    record = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = tdsm.finetune(model, _recording(torch.optim.Adam, record, lr=TRAIN_LR),
                         iterations=TRAIN_ITERS["finetune"], leaves=pick,
                         progress=False)
    finetune_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    H = model.theta.cpu().numpy()
    rest = np.setdiff1d(np.arange(model.num_leaves), pick)
    refit = tuple(a - b for a, b in zip(launches(), record[0][1]))
    if (record[0][1] != grad_expected or refit != _expected_launches(model)
            or not np.isfinite(hist).all()):
        raise AssertionError(f"N=100k finetune: launches {record[0][1]} in the "
                             f"gradient and {refit} in the refit, expected "
                             f"{grad_expected} and {_expected_launches(model)}, "
                             f"{hist}")
    if not (np.array_equal(H[rest], np.broadcast_to(theta0, H[rest].shape))
            and not np.allclose(H[pick], theta0)):
        raise AssertionError("N=100k finetune moved rows it does not tune")
    say("finetune_n100000", leaves=pick.tolist(), leaf_sizes=sizes[pick].tolist(),
        overlap_nonzeros=int(np.count_nonzero(_candidate_rows(model.plan.overlap,
                                                              pick))),
        finetune_hist=hist.tolist(), iteration_s=_iteration_seconds(t0, record),
        finetune_s=finetune_s, peak_memory_bytes=peak,
        gradient_launches=record[0][1], refit_launches=refit,
        card=card_line())
    return launches()


def phase_train_gp():
    """``train_gp`` on phase 10's GP (N=8192, float32), RMSprop lr 1e-3
    (decay 0.9), 5 iterations: seconds per iteration; one blocked launch
    in each iteration's gradient and one in the refit (the kept route).
    Returns the launches."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(GP_N)
    gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0,
                              device="cuda", dtype=torch.float32)
    record = []
    reset_launches()
    t0 = time.perf_counter()
    hist = tdsm.train_gp(gp, iterations=TRAIN_ITERS["gp"], randinit=False,
                         optimizer=_recording(torch.optim.RMSprop, record,
                                              lr=1e-3, alpha=0.9),
                         progress=False)
    train_s = time.perf_counter() - t0
    if not (hist.shape == (TRAIN_ITERS["gp"],) and np.isfinite(hist).all()):
        raise AssertionError(f"train_gp: {hist}")
    expected = (0, TRAIN_ITERS["gp"] + 1)
    if launches() != expected or [r[1] for r in record] != [
            (0, i + 1) for i in range(len(record))]:
        raise AssertionError(f"train_gp launched {[r[1] for r in record]} "
                             f"and {launches()} in all, expected {expected}")
    say(f"train_gp_n{GP_N}", hist=hist.tolist(),
        iteration_s=_iteration_seconds(t0, record), train_s=train_s,
        launches=launches(), card=card_line())
    return launches()


def _first_optimizer_step_s():
    """Seconds of the process's first ``torch.optim`` step, on a tiny
    tensor: it imports ``torch._dynamo``, which would otherwise land in the
    first training iteration's time."""
    import torch

    p = torch.zeros(3, device="cuda", requires_grad=True)
    p.grad = torch.ones_like(p)
    t0 = time.perf_counter()
    torch.optim.Adam([p]).step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_training():
    """Phase 11, training (see the module docstring). Returns the
    ``(fused, blocked)`` launches of its gradients and refits."""
    t0 = time.perf_counter()
    say("optimizer_import", first_step_s=_first_optimizer_step_s())
    launched = np.zeros(2, dtype=int)
    launched += phase_train_20k()
    model, refit = phase_train_100k()
    launched += refit
    launched += phase_finetune_100k(model)
    del model
    launched += phase_finetune_4k()
    launched += phase_train_gp()
    say("training", seconds=time.perf_counter() - t0,
        launches=launched.tolist())
    return tuple(int(v) for v in launched)


#: multi-device (phase 12): float32 leaves above nmax 11585 route to the
#: distributed Cholesky at N=100k (``_fit_mesh`` compares nmax² · itemsize
#: with the budget), its panel width, the float64 gate of a mesh run against
#: the unsharded one and of two ranks against one (MULTICHIP_r05.json's),
#: the two-rank world, and the N=4k model of its training runs
MESH_GIANT_BYTES = 512 << 20
MESH_BLOCK = 256
MESH_F64_TOL = 1e-8
MESH_RANKS = 2
MESH_TRAIN_N, MESH_TRAIN_ITERS = 4_000, 2


def _ref(run):
    """The evidence and T=2000 moments of a slice run, for ``slice_errors``
    after the run's model is gone."""
    return {"z": run["z"], "preds": {T_TEST: run["preds"][T_TEST]}}


def _f64_errors(a, b):
    """Float64 gate quantities of a run ``a`` against ``b`` (``z`` and
    ``preds`` as in ``slice_errors``): evidence relative to max(1, |z|),
    mean and variance absolute."""
    (ma, va), (mb, vb) = a["preds"][T_TEST], b["preds"][T_TEST]
    return {"evidence": abs(a["z"] - b["z"]) / max(1.0, abs(b["z"])),
            "mean_abs": float((ma - mb).abs().max()),
            "var_abs": float((va - vb).abs().max())}


def _gate(name, errs, tol):
    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"{name} past {tol}: {bad}")


def _mesh_slice(mesh, model, budget, xt):
    """``fit(mesh=...)`` → ``update`` → routed and mean-only ``predict`` at
    ``xt``, synchronized; returns the run (``z``, ``preds``) and its times
    and launches."""
    import torch

    reset_launches()
    fit_s = model.fit(mesh=mesh, giant_leaf_bytes=budget, block=MESH_BLOCK)
    z = model.update()
    t0 = time.perf_counter()
    mean, var = model.predict(xt)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean_only = model.predict(xt, return_var=False)
    torch.cuda.synchronize()
    mean_only_s = time.perf_counter() - t0
    if not (torch.isfinite(mean).all() and (var > 0).all()):
        raise AssertionError("mesh predict: non-finite or non-positive moments")
    routed = model.last_fit_diagnostics["distributed_leaves"]
    if routed < 1:
        raise AssertionError("fit(mesh=...) routed no leaf")
    return dict(z=z, preds={T_TEST: (mean, var)}, mean_only=mean_only,
                fit_s=fit_s, predict_s=predict_s, mean_only_s=mean_only_s,
                launches=launches(), routed=routed,
                routed_n=sorted(int(g[4]) for g in model._giant.values()))


def _mesh_cholesky(mesh, model):
    """``sharded_cholesky`` of the largest giant leaf's noisy gram (float32,
    padded to a multiple of 256 with identity) against ``cholesky_ex`` and
    the blocked kernel on the same matrix; errors against float64. The
    kernel's launches here are a yardstick, not the path's: they are taken
    off its count."""
    import torch

    from deepstructuredmixtures_tpu_torch.config import EPS
    from deepstructuredmixtures_tpu_torch.hyper import unpack
    from deepstructuredmixtures_tpu_torch.ops import potrf
    from deepstructuredmixtures_tpu_torch.parallel import comm, dist_chol

    big = max(model._giant, key=lambda l: model._giant[l][4])
    _, _, xp, _, n, kid = model._giant[big]
    logl, logsigma, lognoise = unpack(model.layout, model.theta, kid)
    A = dist_chol._gram_rows(comm.resolve(mesh), model.layout.kinds[kid], xp,
                             logl, logsigma, lognoise, n, EPS)
    npad = A.shape[0]
    before = potrf.LAUNCHES
    ref = torch.linalg.cholesky(A.double())
    err = {}
    for name, fn in (("sharded", lambda: dist_chol.sharded_cholesky(
            A, mesh, block=MESH_BLOCK)),
                     ("cholesky_ex", lambda: torch.linalg.cholesky_ex(A)[0]),
                     ("blocked", lambda: potrf.blocked_cholesky(A[None].clone())[0])):
        err[name] = float((fn().double() - ref).abs().max())
    del ref
    buf = torch.empty_like(A)[None]
    copy_ms = cuda_ms(lambda: buf.copy_(A[None]), warmup=1, reps=3)
    ms = {"sharded": cuda_ms(lambda: dist_chol.sharded_cholesky(
              A, mesh, block=MESH_BLOCK), warmup=1, reps=3),
          "cholesky_ex": cuda_ms(lambda: torch.linalg.cholesky_ex(A),
                                 warmup=1, reps=3),
          "blocked": cuda_ms(lambda: potrf.blocked_cholesky(buf.copy_(A[None])),
                             warmup=1, reps=3) - copy_ms}
    potrf.LAUNCHES = before
    b_ms, b_by = bound_ms(n ** 3 / 3, 2 * 4 * npad * npad)
    if not (ms["sharded"] >= b_ms):
        raise AssertionError(f"sharded_cholesky {ms['sharded']} ms below its "
                             f"bound {b_ms} ms")
    del A, buf
    torch.cuda.empty_cache()
    return dict(n=int(n), npad=int(npad), block=MESH_BLOCK, ms=ms,
                copy_ms=copy_ms, max_abs_err_vs_f64=err, bound_ms=b_ms,
                bound_by=b_by, sharded_over_cholesky_ex=ms["sharded"]
                / ms["cholesky_ex"])


def _mesh_streamed(mesh, model, ref):
    """``sharded_bucketed_streamed_predict`` against
    ``bucketed_streamed_predict`` on ``model`` at T=2000, each through
    ``update_weights`` and the routed moment match, in turns (sharded,
    local, sharded, local); the sharded moments against ``ref`` within the
    float32 bounds."""
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch import infer as inferlib
    from deepstructuredmixtures_tpu_torch.models import _routed_moment_match
    from deepstructuredmixtures_tpu_torch.parallel import (
        sharded_bucketed_streamed_predict)

    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    tidx, tmask = model._route(xt)
    ti = torch.as_tensor(tidx, dtype=torch.long, device="cuda")
    tm = torch.as_tensor(tmask, device="cuda")
    args = (model.layout, model.theta, model.bucket_batches,
            model.bucket_spec.leaf_ids, model.num_leaves,
            torch.as_tensor(xt, dtype=model.dtype, device="cuda"), ti)
    fns = {"sharded": lambda: sharded_bucketed_streamed_predict(*args,
                                                                mesh=mesh),
           "local": lambda: fitlib.bucketed_streamed_predict(*args)}
    times, outs = {"sharded": [], "local": []}, {}
    for name in ("sharded", "local", "sharded", "local"):
        t0 = time.perf_counter()
        mu, var, mll = fns[name]()
        lw, z = inferlib.update_weights(model.plan, mll)
        mean, v = _routed_moment_match(model.plan, mu, var, lw, ti, tm, T_TEST)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
        outs[name] = dict(z=float(z), preds={T_TEST: (mean, v)})
    errs = slice_errors(outs["sharded"], ref, sizes=(T_TEST,))
    _gate("sharded streamed predict f32 vs f64", {
        k: errs[k] / SLICE_TOL[k] for k in SLICE_TOL}, 1.0)
    return dict(seconds={k: min(v) for k, v in times.items()}, runs=times,
                errors_f32_vs_f64=errs,
                sharded_vs_local=_f64_errors(outs["sharded"], outs["local"]))


def _mesh_train(mesh):
    """The sharded training gradient at N=20k (float32, per bucket and
    leaf chunk on each rank, one psum) against the unsharded float64
    gradient: mll within 1e-3, gradient within 1e-2 relative in norm (phase
    11's gates); each run launches as the plan counts
    (:func:`_train_launches`: the objective's kept route, two passes per
    bucket in the sharded gradient); seconds against the unsharded float32
    gradient's. Returns the line and the float32 runs' launches."""
    import torch

    from deepstructuredmixtures_tpu_torch.parallel.mesh import (
        make_sharded_value_and_grad_bucketed)
    from deepstructuredmixtures_tpu_torch.train import _train_vg

    m32, m64 = _train_model(20_000, torch.float32), _train_model(20_000,
                                                                 torch.float64)
    vg = make_sharded_value_and_grad_bucketed(
        m32.layout, m32.plan, m32.bucket_batches, m32.bucket_spec.leaf_ids,
        mesh)
    out, launched = {}, np.zeros(2, dtype=int)
    for name, fn, theta, per in (
            ("sharded", vg, m32.theta, _train_launches(m32, per_bucket=True)),
            ("local", _train_vg(m32), m32.theta, _train_launches(m32)),
            ("float64", _train_vg(m64), m64.theta, (0, 0))):
        reset_launches()
        runs = []
        for _ in range(2):  # cold, warm
            t0 = time.perf_counter()
            v, g = fn(theta)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        if launches() != _twice(per):
            raise AssertionError(f"the {name} training gradient launched "
                                 f"{launches()}, expected {_twice(per)}")
        launched += launches()
        out[name] = dict(mll=float(v), grad=g.double().cpu().numpy(), s=runs,
                         launches=launches())
    mll_rel = abs(out["sharded"]["mll"] - out["float64"]["mll"]) / abs(
        out["float64"]["mll"])
    grad_rel = _rel(out["sharded"]["grad"], out["float64"]["grad"])
    if not (mll_rel <= SLICE_TOL["evidence_rel"] and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"sharded gradient f32 vs f64: mll {mll_rel}, "
                             f"grad {grad_rel}")
    return dict(seconds={k: v["s"] for k, v in out.items()},
                launches={k: v["launches"] for k, v in out.items()},
                mll_f32_rel_vs_f64=mll_rel, grad_f32_rel_vs_f64=grad_rel), \
        tuple(int(n) for n in launched)


def _mesh_gp(mesh, xt):
    """``GaussianProcess.fit(mesh=)`` + ``predict`` at N=8192 in float32
    and float64 against the unsharded float64 GP: float32 within the float32
    bounds, float64 within 1e-8; fit and predict seconds (min of 3) beside
    the unsharded ones. The unsharded float32 fits take the kept route (one
    blocked launch each, four with the warm one); the mesh fits launch no
    kernel. Returns the line, the float64 mesh run and the launches."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(GP_N)
    runs, times = {}, {}
    for name, dtype, mesh_ in (("unsharded_float64", torch.float64, None),
                               ("unsharded_float32", torch.float32, None),
                               ("mesh_float64", torch.float64, mesh),
                               ("mesh_float32", torch.float32, mesh)):
        gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(0.0, 0.0),
                                  log_noise=-1.0, device="cuda", dtype=dtype)
        reset_launches()
        fit_s, _ = _min_of_3(_timed(lambda: gp.fit(mesh=mesh_,
                                                   block=MESH_BLOCK)))
        predict_s, _ = _min_of_3(_timed(lambda: gp.predict(xt)))
        mean, var = gp.predict(xt)
        expected = (0, 4) if name == "unsharded_float32" else (0, 0)
        if launches() != expected:
            raise AssertionError(f"GP {name} launched {launches()}, "
                                 f"expected {expected}")
        runs[name] = dict(z=gp.mll(), preds={T_TEST: (mean.double(),
                                                      var.double())})
        times[name] = dict(fit_s=fit_s, predict_t2000_s=predict_s)
    base = runs["unsharded_float64"]
    errs32 = slice_errors(runs["mesh_float32"], base, sizes=(T_TEST,))
    _gate("GP mesh f32 vs f64", {k: errs32[k] / SLICE_TOL[k]
                                 for k in SLICE_TOL}, 1.0)
    errs64 = _f64_errors(runs["mesh_float64"], base)
    _gate("GP mesh f64 vs unsharded", errs64, MESH_F64_TOL)
    return dict(n=GP_N, times=times, errors_f32_vs_f64=errs32,
                errors_f64_vs_unsharded=errs64), runs["mesh_float64"], (0, 4)


def _mesh_train_refs(mesh):
    """``train(mesh=)`` (Adam lr 1e-2, 2 iterations) and ``finetune(mesh=)``
    (1 iteration, all 144 candidates) at N=4k in float64: the one-rank
    references of the two-rank run, with their seconds."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    adam = lambda params: torch.optim.Adam(params, lr=TRAIN_LR)  # noqa: E731
    m = _full_model(MESH_TRAIN_N, torch.float64)
    t0 = time.perf_counter()
    hist = tdsm.train(m, adam, iterations=MESH_TRAIN_ITERS, lam=1e-9,
                      randinit=False, progress=False, mesh=mesh)
    train_s = time.perf_counter() - t0
    theta = m.theta.cpu().numpy()
    m = _full_model(MESH_TRAIN_N, torch.float64)
    t0 = time.perf_counter()
    ft = tdsm.finetune(m, adam, iterations=1, lam=1e-9, progress=False,
                       mesh=mesh)
    finetune_s = time.perf_counter() - t0
    return dict(train_hist=hist, train_theta=theta, finetune_hist=ft,
                finetune_theta=m.theta.cpu().numpy()), dict(
                    train_s=train_s, finetune_s=finetune_s)


def _mesh_two_rank_runs(mesh, budget20k):
    """The runs of the two-rank world, in float64 (also made in the world of
    one for its references): ``fit(mesh=)`` at N=20k with the largest
    bucket routed, routed predict at T=2000, the N=8192 GP, and
    ``train``/``finetune`` at N=4k. Returns flat arrays and seconds."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    out, secs = {}, {}
    model = _train_model(20_000, torch.float64)
    run = _mesh_slice(mesh, model, budget20k, xt)
    for dev in ([model.theta] + [g[0] for g in model._giant.values()]):
        if dev.device != torch.device("cuda", 0):
            raise AssertionError(f"a tensor left cuda:0: {dev.device}")
    out.update(n20k_z=run["z"], n20k_mean=run["preds"][T_TEST][0].cpu().numpy(),
               n20k_var=run["preds"][T_TEST][1].cpu().numpy(),
               n20k_mean_only=run["mean_only"].cpu().numpy())
    secs.update(n20k_fit_s=run["fit_s"], n20k_predict_s=run["predict_s"])
    del model
    x, y = make_data(GP_N)
    gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(0.0, 0.0),
                              log_noise=-1.0, device="cuda",
                              dtype=torch.float64)
    t0 = time.perf_counter()
    gp.fit(mesh=mesh, block=MESH_BLOCK)
    mean, var = gp.predict(xt)
    torch.cuda.synchronize()
    secs["gp_fit_predict_s"] = time.perf_counter() - t0
    out.update(gp_mll=gp.mll(), gp_mean=mean.cpu().numpy(),
               gp_var=var.cpu().numpy())
    refs, s = _mesh_train_refs(mesh)
    out.update(refs)
    secs.update(s)
    return {k: np.asarray(v) for k, v in out.items()}, secs


def _mesh_rank(rank, world, store, refs_path, out_path):
    """A rank of the two-rank gloo world on the one card (``cuda:0``): the
    runs of :func:`_mesh_two_rank_runs`, rank 0 holding them to the world of
    one's within 1e-8 and writing the errors and seconds to ``out_path``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        from deepstructuredmixtures_tpu_torch import parallel

        mesh = parallel.make_mesh()
        with np.load(refs_path) as z:
            ref = {k: z[k] for k in z.files}
        t0 = time.perf_counter()
        got, secs = _mesh_two_rank_runs(mesh, int(ref["budget20k"]))
        secs["all_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    errs = {}
    for k, v in got.items():
        scale = max(1.0, float(np.abs(ref[k]).max())) if k.endswith(
            ("_z", "_mll")) else 1.0
        errs[k] = float(np.abs(v - ref[k]).max()) / scale
    _gate(f"rank {rank} of {world} vs one rank, float64", errs, MESH_F64_TOL)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({"errors_vs_one_rank": errs, "seconds": secs,
                       "backend": "gloo", "device": "cuda:0",
                       "device_name": torch.cuda.get_device_name(0)}, f)


def phase_mesh(ref20k, ref100k):
    """Phase 12, multi-device (see the module docstring). ``ref20k`` /
    ``ref100k``: the float64 slices of phases 4-5 (evidence and T=2000
    moments). Returns the ``(fused, blocked)`` launches of its counted
    float32 runs."""
    import tempfile

    import torch
    import torch.distributed as dist

    from deepstructuredmixtures_tpu_torch import parallel

    t_phase = time.perf_counter()
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="mesh_", dir=os.path.join(REPO, "build"))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        backend = str(dist.get_backend())
        # N=100k, float32: the headline model with its largest leaves routed;
        # the light fit and streamed predict of the same model in turns
        # (light, mesh, light, mesh; min of 2 each)
        model = _train_model(100_000, torch.float32)
        light = {"fit_s": [], "predict_s": []}
        mesh_runs = []
        for _ in range(2):
            light["fit_s"].append(model.fit())
            t0 = time.perf_counter()
            model.predict(xt)
            torch.cuda.synchronize()
            light["predict_s"].append(time.perf_counter() - t0)
            mesh_runs.append(_mesh_slice(mesh, model, MESH_GIANT_BYTES, xt))
        run = mesh_runs[-1]
        # the blocked kernel in the light fit and the streamed predict of
        # the buckets kept local, the fused one never (no bucket in its domain)
        local = _twice(_expected_launches(model, max_bytes=MESH_GIANT_BYTES))
        if any(r["launches"] != local for r in mesh_runs):
            raise AssertionError(f"N=100k mesh run launched {run['launches']}, "
                                 f"expected {local}")
        counted = np.array(local) * len(mesh_runs)
        errs = slice_errors(run, ref100k, sizes=(T_TEST,))
        _gate("N=100k mesh f32 vs f64", {k: errs[k] / SLICE_TOL[k]
                                          for k in SLICE_TOL}, 1.0)
        mean_only_err = float((run["mean_only"] - ref100k["preds"][T_TEST][0])
                              .abs().max())
        if not (mean_only_err <= SLICE_TOL["mean_abs"]):
            raise AssertionError(f"N=100k mesh mean-only {mean_only_err}")
        chol = _mesh_cholesky(mesh, model)
        reset_launches()
        model.fit()  # drops the giant leaves' factors
        streamed = _mesh_streamed(mesh, model, ref100k)
        # the light fit and four streamed passes over every bucket
        expected = tuple(5 * n for n in _expected_launches(model))
        if launches() != expected:
            raise AssertionError(f"N=100k launched {launches()}, expected "
                                 f"{expected}")
        counted += expected
        del model
        torch.cuda.empty_cache()
        say("mesh_n100000", backend=backend, ranks=1,
            giant_leaf_bytes=MESH_GIANT_BYTES, block=MESH_BLOCK,
            routed_leaves=run["routed"], routed_n=run["routed_n"],
            fit_mesh_s=min(r["fit_s"] for r in mesh_runs),
            predict_mesh_t2000_s=min(r["predict_s"] for r in mesh_runs),
            mean_only_mesh_s=min(r["mean_only_s"] for r in mesh_runs),
            fit_light_s=min(light["fit_s"]),
            predict_streamed_t2000_s=min(light["predict_s"]),
            runs={"mesh": [{k: r[k] for k in ("fit_s", "predict_s",
                                              "mean_only_s")}
                           for r in mesh_runs], "light": light},
            errors_f32_vs_f64=errs, mean_only_abs_err_vs_f64=mean_only_err,
            tolerances=SLICE_TOL, launches=run["launches"],
            sharded_cholesky=chol, sharded_streamed_predict=streamed,
            card=card_line())

        # N=20k: float32 (the fused kernel on the normal buckets) and
        # float64 (the gate and the two-rank world's reference)
        model = _train_model(20_000, torch.float32)
        nmaxs = sorted(model.bucket_spec.nmaxs)
        run32 = _mesh_slice(mesh, model, nmaxs[-2] ** 2 * 4, xt)
        local = _twice(_expected_launches(model, max_bytes=nmaxs[-2] ** 2 * 4))
        del model
        if run32["launches"] != local or not local[0]:
            raise AssertionError(f"N=20k mesh float32 launched "
                                 f"{run32['launches']} (fused, blocked), "
                                 f"expected {local}")
        counted += local
        errs32 = slice_errors(run32, ref20k, sizes=(T_TEST,))
        _gate("N=20k mesh f32 vs f64", {k: errs32[k] / SLICE_TOL[k]
                                         for k in SLICE_TOL}, 1.0)
        budget64 = nmaxs[-2] ** 2 * 8
        ref_runs, ref_secs = _mesh_two_rank_runs(mesh, budget64)
        run64 = {"z": float(ref_runs["n20k_z"]), "preds": {T_TEST: (
            torch.as_tensor(ref_runs["n20k_mean"]),
            torch.as_tensor(ref_runs["n20k_var"]))}}
        errs64 = _f64_errors(run64, {"z": ref20k["z"], "preds": {T_TEST: tuple(
            a.cpu() for a in ref20k["preds"][T_TEST])}})
        _gate("N=20k mesh f64 vs unsharded", errs64, MESH_F64_TOL)
        train, train_launches = _mesh_train(mesh)
        gp_line, _, gp_launches = _mesh_gp(mesh, xt)
        counted += np.array(train_launches) + gp_launches
        say("mesh_n20000", backend=backend, ranks=1, routed=run32["routed"],
            routed_n=run32["routed_n"], launches_f32=run32["launches"],
            fit_mesh_f32_s=run32["fit_s"],
            predict_mesh_f32_t2000_s=run32["predict_s"],
            errors_f32_vs_f64=errs32, errors_f64_vs_unsharded=errs64,
            f64_tol=MESH_F64_TOL, one_rank_f64_s=ref_secs,
            train_vg_n20000=train, gp=gp_line, card=card_line())
    finally:
        dist.destroy_process_group()

    # two gloo ranks on the one card, against the world of one
    refs_path = os.path.join(tmp, "one_rank.npz")
    np.savez(refs_path, budget20k=budget64, **ref_runs)
    out_path = os.path.join(tmp, "two_ranks.json")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(
        _mesh_rank, args=(MESH_RANKS, os.path.join(tmp, "gloo"), refs_path,
                          out_path),
        nprocs=MESH_RANKS, join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    with open(out_path) as f:
        two = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    say("mesh_two_ranks", ranks=MESH_RANKS,
        note="both ranks share cuda:0: the times measure a shared card, "
             "not scaling", wall_s=spawn_s, **two,
        f64_tol=MESH_F64_TOL, card=card_line())
    say("mesh", seconds=time.perf_counter() - t_phase,
        fused_launches=run32["launches"][0])
    return tuple(int(n) for n in counted)


# ---------------------------------------------------------------------------
# The other model families (phases 13-15): the PoE fusions, kernel-mixture
# leaves and BASELINE config 5, each at the benchmark's widths
# ---------------------------------------------------------------------------

#: phase 13's training points (``bench.py:1065`` ``run_poe``); its sampled
#: leaves against the float64 NumPy oracle (``bench.py:1039-1063``): leaf
#: mll relative to max(1, |mll|), mean absolute, variance relative; the
#: fusion replica on the port's own leaf moments (``bench.py:1136-1170``)
POE_N = 100_000
ORACLE_TOL = {"mll_rel": 1e-3, "mean_abs": 5e-3, "var_rel": 1e-3}
FUSION_TOL = {"mean_abs": 1e-10, "var_rel": 1e-8}
#: phase 14 (``bench.py:891`` ``run_mixture``): the leaves' kernels, the
#: streamed run's and the hybrid and training run's sizes, the tied steps
#: and their learning rate, the largest leaf the oracle factors
MIXTURE_N, MIXTURE_HYBRID_N = 100_000, 20_000
MIXTURE_STEPS, MIXTURE_LR = 3, 1e-2
ORACLE_MAX_LEAF = 6000
#: the N=100k mixture's IsoLinear leaf whose float32 factor
#: ``chip_chol_routes.py`` measures (n=7,627: cuSOLVER's float32 route
#: missed its mll by 21% on an H100); phase 14 holds the training
#: objective there and on the largest ArdSE and IsoSE leaves to float64
MIXTURE_WORST_ISO_LINEAR = 95
#: the float32 objective's leaf mll against the light fit's at the same
#: hypers (the same gram, factor and solve: equal but for the order of the
#: kernel's sums across launches)
OBJECTIVE_FIT_TOL = 1e-6
#: phase 15, BASELINE config 5 (``bench.py:580`` ``run_config5``): points,
#: dimensions, the warm start's subsample, iterations and learning rate,
#: and the finetune's learning rate
CONFIG5_N, CONFIG5_D, CONFIG5_SUB = 100_000, 4, 4000
CONFIG5_WARM_ITERS, CONFIG5_WARM_LR, CONFIG5_FT_LR = 15, 5e-2, 1e-2
#: the fine-tune's candidates, spread evenly over the leaves in size order
#: (None: every leaf). Every leaf is a candidate in ``bench.py``; on an
#: H100 four candidates' iteration took 21.8 s: a full-tree forward of
#: about 1.6 s each and about 71 ms for each of their 218 (candidate, leaf)
#: pairs' backward, so all 144 candidates (7,176 pairs) would take about
#: 12 minutes
CONFIG5_FT_CANDIDATES = 4


def np_gram(kind, logl, logsigma, x1, x2):
    """Float64 NumPy gram of one kernel kind (``bench.py``
    ``_np_gram_general``, the semantics of ``kernels.gram``)."""
    logl = np.atleast_1d(logl)
    if kind == "iso_se":
        d2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
        return np.exp(2 * logsigma) * np.exp(-0.5 * d2 * np.exp(-2 * logl[0]))
    if kind == "ard_se":
        acc = 0.0
        for k in range(x1.shape[1]):
            dk = (x1[:, k, None] - x2[None, :, k]) ** 2
            acc = acc + np.exp(-0.5 * dk * np.exp(-2.0 * logl[k]))
        return np.exp(2 * logsigma) * acc
    if kind == "iso_linear":
        return (x1 @ x2.T) * np.exp(-2 * logl[0])
    if kind == "ard_linear":
        return (x1 * np.exp(-2 * logl)) @ x2.T
    raise ValueError(kind)


def np_gram_diag(kind, logl, logsigma, x):
    """Float64 NumPy ``k(x_t, x_t)`` (``kernels.gram_diag``)."""
    logl = np.atleast_1d(logl)
    if kind == "iso_linear":
        return (x * x).sum(1) * np.exp(-2 * logl[0])
    if kind == "ard_linear":
        return (x * x * np.exp(-2 * logl)).sum(1)
    terms = logl.size if kind == "ard_se" else 1
    return np.full(x.shape[0], terms * np.exp(2 * logsigma))


def oracle_leaf(X, y, plan, layout, theta, leaf, xt=None):
    """The float64 NumPy GP of ``leaf`` under the tied hyper vector
    ``theta``, as ``bench.py`` gates the chip (``_cpu_leaf_mll_general``,
    ``_cpu_leaf_moments_f64``): its mll and, with ``xt``, its predictive
    mean and variance (noise included) at every test point."""
    import scipy.linalg as sla

    kid = int(plan.leaf_kernelid[leaf])
    kind = layout.kinds[kid]
    off, nl = layout.blocks[kid]
    theta = np.asarray(theta, np.float64)
    logl, logsigma, lognoise = theta[off:off + nl], theta[off + nl], theta[off + nl + 1]
    obs = plan.leaf_obs[leaf]
    xl = X[obs]
    yl = y[obs] - plan.leaf_mean[leaf]
    K = np_gram(kind, logl, logsigma, xl, xl)
    noise = np.exp(2 * lognoise)
    K[np.diag_indices_from(K)] += noise + 1e-8  # the port's EPS
    Lf = np.linalg.cholesky(K)
    alpha = sla.cho_solve((Lf, True), yl)
    mll = -0.5 * (yl @ alpha + 2 * np.log(np.diag(Lf)).sum()
                  + len(obs) * np.log(2 * np.pi))
    if xt is None:
        return mll
    Knt = np_gram(kind, logl, logsigma, xl, xt)
    mu = plan.leaf_mean[leaf] + Knt.T @ alpha
    V = sla.solve_triangular(Lf, Knt, lower=True)
    var = np_gram_diag(kind, logl, logsigma, xt) - (V * V).sum(0) + noise
    return mll, mu, var


def fusion_replica(name, mu, var, root_child_id, prior=None):
    """Float64 NumPy replica of the PoE (``poe``), generalized PoE
    (``gpoe``, β = 1/M over the M root children) and rBCM (``rbcm``, with
    the prior variance ``prior [T]``) fusions of per-leaf moments ``mu,
    var [L, T]`` (``bench.py:1136-1170``). Returns ``(mean [T], var
    [T])``."""
    t_leaf = 1.0 / np.asarray(var, np.float64)
    mu = np.asarray(mu, np.float64)
    if name == "poe":
        tsum = t_leaf.sum(0)
        return (t_leaf * mu).sum(0) / tsum, 1.0 / tsum
    gid = np.asarray(root_child_id)
    shape = (int(gid.max()) + 1, mu.shape[1])
    tw, mw = np.zeros(shape), np.zeros(shape)
    np.add.at(tw, gid, t_leaf)
    np.add.at(mw, gid, t_leaf * mu)
    mu_c, t_c = mw / tw, tw
    if name == "gpoe":
        beta = 1.0 / shape[0]
        tsum = (beta * t_c).sum(0)
        return (beta * t_c * mu_c).sum(0) / tsum, 1.0 / tsum
    beta = 0.5 * (np.log(prior)[None] - np.log(1.0 / t_c))
    C = 1.0 / prior + (beta * t_c - beta / prior[None]).sum(0)
    return (mu_c * beta * t_c).sum(0) / C, 1.0 / C


def _oracle_picks(sizes, leaves=None, small=3, largest_below=None):
    """Leaf indices for the oracle among ``leaves`` (default all): the
    ``small`` smallest, then the median and the largest, or with
    ``largest_below`` the largest of at most that many points."""
    leaves = np.arange(sizes.size) if leaves is None else np.asarray(leaves)
    order = leaves[np.argsort(sizes[leaves], kind="stable")]
    picks = list(order[:small])
    if largest_below is None:
        picks += [order[len(order) // 2], order[-1]]
    else:
        fit = order[sizes[order] <= largest_below]
        picks += list(fit[-1:])
    return [int(p) for p in dict.fromkeys(int(p) for p in picks)]


def _moment_errors(mean, var, mean64, var64):
    """Max abs mean and max relative variance errors (float64 tensors or
    arrays)."""
    mean, var, mean64, var64 = (np.asarray(a.cpu() if hasattr(a, "cpu") else a,
                                           np.float64)
                                for a in (mean, var, mean64, var64))
    return {"mean_abs": float(np.max(np.abs(mean - mean64))),
            "var_rel": float(np.max(np.abs(var - var64) / np.abs(var64)))}


def _finite_moments(name, mean, var, T):
    import torch

    if mean.shape != (T,) or var.shape != (T,):
        raise AssertionError(f"{name}: moments of shape {mean.shape}, {var.shape}")
    if not (torch.isfinite(mean).all() and torch.isfinite(var).all()
            and (var > 0).all()):
        raise AssertionError(f"{name}: non-finite or non-positive moments")


def poe_model(kind, x, y, dtype, device="cuda"):
    """``build_poe`` (``generalized`` for ``gpoe``) or ``build_bcm`` as
    ``bench.py`` ``run_poe`` builds them: K=4, depth 2, M=30, IsoSE(0, 0),
    log noise -1, seed 0."""
    import deepstructuredmixtures_tpu_torch as tdsm

    kw = dict(K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0, seed=0,
              device=device, dtype=dtype, do_fit=False)
    if kind == "rbcm":
        return tdsm.build_bcm(x, y, **kw)
    return tdsm.build_poe(x, y, generalized=kind == "gpoe", **kw)


def poe_pipeline(model, xt):
    """``fit_naive`` → fused ``predict`` at ``xt``, synchronized."""
    import torch

    def run():
        model.fit_naive()
        out = model.predict(xt)
        torch.cuda.synchronize()
        return out

    return run


def _rbcm_prior(model, T):
    """The rBCM prior variance as the model takes it: leaf 0's kernel,
    ``k(x, x) + noise`` (float64, host)."""
    kid = int(model.plan.leaf_kernelid[0])
    off, nl = model.layout.blocks[kid]
    th = model.theta.double().cpu().numpy()
    th = th if th.ndim == 1 else th[0]
    return (np_gram_diag(model.layout.kinds[kid], th[off:off + nl], th[off + nl],
                         np.zeros((T, model.plan.dim)))
            + np.exp(2 * th[off + nl + 1]))


def phase_poe():
    """Phase 13, the PoE family (see the module docstring). Returns the
    fused kernel's launches of the three counted runs."""
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    t_phase = time.perf_counter()
    n_train = POE_N
    x, y = make_data(n_train)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    fused_total = 0
    for kind in ("poe", "gpoe", "rbcm"):
        t0 = time.perf_counter()
        model = poe_model(kind, x, y, torch.float32)
        build_s = time.perf_counter() - t0
        L, nmax = model.num_leaves, model.plan.nmax
        chunks = math.ceil(L / fitlib.default_chunk(nmax, model.dtype))
        if not fused_chol.supported(nmax, model.dtype, model.layout.kinds,
                                    model.device):
            raise AssertionError(f"{kind}: nmax {nmax} outside the fused domain")
        expected = (chunks, 0)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        cold_fit_s = model.fit_naive()
        fit_launches = launches()
        t0 = time.perf_counter()
        mean, var = model.predict(xt)
        torch.cuda.synchronize()
        cold_predict_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if fit_launches != expected or launches() != expected:
            raise AssertionError(f"{kind}: launches {fit_launches} in the fit and "
                                 f"{launches()} with the predict, expected {expected}")
        if model.posterior is None:
            raise AssertionError(f"{kind}: fit_naive did not keep the full store")
        _finite_moments(kind, mean, var, T_TEST)
        fit_runs = [model.fit_naive() for _ in range(3)]
        predict_runs = [_timed(lambda: model.predict(xt))() for _ in range(3)]
        prof = None
        if kind == "poe":
            import chip_profile

            prof = chip_profile.profile(f"poe_n{n_train}", poe_pipeline(
                model, xt), quiet=True)
        fused_total += expected[0]
        mean, var = model.predict(xt)
        mu_l, var_l = (a.double().cpu().numpy()
                       for a in model._leaf_predict_all(model._as_test(xt)))
        leaf_mll = model.leaf_mlls().double().cpu().numpy()
        theta = model.theta.double().cpu().numpy()
        sizes = np.array([o.size for o in model.plan.leaf_obs])
        picks = _oracle_picks(sizes, small=2)
        oracle = {"mll_rel": 0.0, "mean_abs": 0.0, "var_rel": 0.0}
        for l in picks:
            mll_o, mu_o, var_o = oracle_leaf(x, y, model.plan, model.layout,
                                             theta, l, xt)
            oracle["mll_rel"] = max(oracle["mll_rel"], abs(leaf_mll[l] - mll_o)
                                    / max(1.0, abs(mll_o)))
            e = _moment_errors(mu_l[l], var_l[l], mu_o, var_o)
            oracle["mean_abs"] = max(oracle["mean_abs"], e["mean_abs"])
            oracle["var_rel"] = max(oracle["var_rel"], e["var_rel"])
        _gate(f"{kind} leaves vs the float64 oracle",
              {k: oracle[k] / ORACLE_TOL[k] for k in ORACLE_TOL}, 1.0)
        prior = _rbcm_prior(model, T_TEST) if kind == "rbcm" else None
        rep_mean, rep_var = fusion_replica(kind, mu_l, var_l,
                                           model.plan.root_child_id, prior)
        fusion = _moment_errors(mean, var, rep_mean, rep_var)
        _gate(f"{kind} fusion vs its float64 replica",
              {k: fusion[k] / FUSION_TOL[k] for k in FUSION_TOL}, 1.0)
        del mu_l, var_l, model
        model64 = poe_model(kind, x, y, torch.float64)
        model64.fit_naive()
        mean64, var64 = model64.predict(xt)
        nmax64 = model64.plan.nmax
        del model64
        errs = _moment_errors(mean, var, mean64, var64)
        _gate(f"{kind} f32 vs f64", {k: errs[k] / SLICE_TOL[k] for k in errs}, 1.0)
        torch.cuda.empty_cache()
        say(f"{kind}_n{n_train}", leaves=L, leaf_sizes=[int(sizes.min()),
                                                        int(sizes.max())],
            nmax=nmax, nmax_float64=nmax64, build_s=build_s,
            launches=expected, cold_fit_naive_s=cold_fit_s,
            cold_predict_t2000_s=cold_predict_s, fit_naive_s=min(fit_runs),
            fit_runs=fit_runs, predict_t2000_s=min(predict_runs),
            predict_runs=predict_runs, peak_memory_bytes=peak,
            errors_f32_vs_f64=errs, oracle_leaves=picks,
            oracle_leaf_sizes=sizes[picks].tolist(), errors_vs_oracle=oracle,
            fusion_vs_replica=fusion,
            tolerances={"f32": SLICE_TOL, "oracle": ORACLE_TOL,
                        "fusion": FUSION_TOL},
            profile=prof, card=card_line())
    say("poe_family", seconds=time.perf_counter() - t_phase,
        fused_launches=fused_total)
    return fused_total


def mixture_kernels():
    """The leaves' kernels of ``bench.py`` ``run_mixture``."""
    import deepstructuredmixtures_tpu_torch as tdsm

    return [tdsm.IsoSE(0.0, 0.0), tdsm.ArdSE([0.0], 0.0), tdsm.IsoLinear(0.0)]


def mixture_model(n_train, dtype, device="cuda", overlap=False):
    """The kernel-mixture DSMGP of ``bench.py`` ``run_mixture`` (V=3, K=4,
    M=30, depth 2, log noise -1, seed 0) on ``make_data``; with ``overlap``
    the sparse ``MixtureOverlap`` its fine-tune reads."""
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(n_train)
    return tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=mixture_kernels(),
                            log_noise=-1.0, seed=0, device=device, dtype=dtype,
                            do_fit=False, overlap=overlap,
                            overlap_format="sparse" if overlap else "auto")


def light_pipeline(model, xt, secs=None):
    """``fit(store='light')`` → ``update`` → routed ``predict`` at ``xt``,
    synchronized; returns ``(z, mean, var)``. ``secs``, a dict, gets the
    fit's and the predict's seconds."""
    import torch

    def run():
        fit_s = model.fit(store="light")
        z = model.update()
        t0 = time.perf_counter()
        mean, var = model.predict(xt)
        torch.cuda.synchronize()
        if secs is not None:
            secs.update(fit_s=fit_s, predict_s=time.perf_counter() - t0)
        return z, mean, var

    return run


def _no_fused_domain(model, name):
    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    if any(fused_chol.supported(b.nmax, b.x.dtype, model.layout.kinds,
                                model.device) for b in model.bucket_batches):
        raise AssertionError(f"{name}: a bucket in the fused kernel's domain")


def _refit_launches(model):
    """``(fused, blocked)`` launches of ``model.fit()``: the full store
    factors the monolithic batch chunk by chunk (``fit._factor``), the
    light store is one streamed pass."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.models import FULL_STORE_BYTES
    from deepstructuredmixtures_tpu_torch.ops import fused_chol, potrf

    nmax, dt = model.plan.nmax, model.dtype
    if model._factor_bytes() > FULL_STORE_BYTES:
        return _expected_launches(model)
    chunks = math.ceil(model.num_leaves / fitlib.default_chunk(nmax, dt))
    if fused_chol.supported(nmax, dt, model.layout.kinds, model.device):
        return (chunks, 0)
    return (0, chunks) if potrf.supported(nmax, dt, model.device) else (0, 0)


def _twice(launched):
    return tuple(2 * n for n in launched)


def _refit_and_predict_launches(model):
    """``(fused, blocked)`` launches of ``model.fit()`` and one routed
    ``predict``: the full store predicts from its factors, the light store
    streams again."""
    from deepstructuredmixtures_tpu_torch.models import FULL_STORE_BYTES

    refit = _refit_launches(model)
    if model._factor_bytes() <= FULL_STORE_BYTES:
        return refit
    streamed = _expected_launches(model)
    return tuple(a + b for a, b in zip(refit, streamed))


def _per_kind_oracle(X, y, model, leaf_mll):
    """Per kernel kind, the max relative leaf-mll error of the three
    smallest leaves and the largest of at most ``ORACLE_MAX_LEAF`` points
    against :func:`oracle_leaf`."""
    plan, layout = model.plan, model.layout
    theta = model.theta.double().cpu().numpy()
    sizes = np.array([o.size for o in plan.leaf_obs])
    worst, picked = {}, {}
    for k, kind in enumerate(layout.kinds):
        picks = _oracle_picks(sizes, np.nonzero(plan.leaf_kernelid == k)[0],
                              largest_below=ORACLE_MAX_LEAF)
        picked[kind] = sizes[picks].tolist()
        worst[kind] = max(abs(leaf_mll[l] - m) / max(1.0, abs(m)) for l, m in (
            (l, oracle_leaf(X, y, plan, layout, theta, l)) for l in picks))
    return worst, picked


def _train_launches(model, per_bucket=None):
    """``(fused, blocked)`` launches of one evaluation of the training
    objective and its gradient over ``model``'s size buckets: one blocked
    launch per leaf chunk of each bucket on the kept route
    (``fit._kept_recipe``), two where the chunk is evaluated twice (the
    no-graph and the graph pass of ``make_value_and_grad_bucketed``, taken
    where ``per_bucket`` or a bucket reaches nmax 4096 as in
    ``train._train_vg``; a checkpointed chunk recomputed in the backward).
    The fused kernel never runs in the objective."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.train import _per_bucket

    if per_bucket is None:
        per_bucket = _per_bucket(model)
    n = 0
    for b in model.bucket_batches:
        if fitlib._kept_recipe(b):
            c = fitlib._bucket_chunk(b.nmax, b.num_leaves, b.x.dtype)
            chunks = -(-b.num_leaves // c)
            n += 2 * chunks if per_bucket or c < b.num_leaves else 1
    return 0, n


def _finetune_launches(model, cand, W, cand_map=8, sparse=True):
    """``(fused, blocked)`` launches of one evaluation of the bucketed
    fine-tune engine (``train.make_finetune_vg_bucketed`` with ``sparse``:
    the nonzero pairs; ``None``, the engine's default, picks them where
    ``W`` is under 25% dense, else all) for the candidates ``cand`` under
    the weights ``W [C, L]``: per kept-route bucket, one per chunk of (candidate, leaf)
    pairs of each group of ``cand_map`` candidates in the forward (the
    chunk rule of ``fit._bucket_chunk``) and one per chunk of its listed
    pairs in the backward (``train._pair_chunk``)."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.train import _pair_chunk

    C, n = len(cand), 0
    if sparse is None:
        sparse = np.count_nonzero(W) < 0.25 * W.size
    for b, ids in zip(model.bucket_batches, model.bucket_spec.leaf_ids):
        if not fitlib._kept_recipe(b):
            continue
        for s in range(0, C, cand_map):
            pairs = (min(s + cand_map, C) - s) * b.num_leaves
            n += -(-pairs // fitlib._bucket_chunk(b.nmax, pairs, b.x.dtype))
        nz = int(np.count_nonzero(W[:, ids])) if sparse else C * len(ids)
        n += -(-nz // _pair_chunk(b.nmax, b.x.dtype))
    return 0, n


def _leaf_batch(model, leaf):
    """The one-leaf batch of ``leaf`` (a view of its bucket's rows)."""
    for b, ids in zip(model.bucket_batches, model.bucket_spec.leaf_ids):
        hit = np.nonzero(ids == leaf)[0]
        if hit.size:
            return b.rows(int(hit[0]), int(hit[0]) + 1)
    raise KeyError(leaf)


def _objective_leaves(model):
    """``{kind: leaf}``: :data:`MIXTURE_WORST_ISO_LINEAR` and the largest
    leaf of each other kind."""
    sizes = np.array([o.size for o in model.plan.leaf_obs])
    kid = model.plan.leaf_kernelid
    out = {}
    for k, kind in enumerate(model.layout.kinds):
        ids = np.nonzero(kid == k)[0]
        out[kind] = (MIXTURE_WORST_ISO_LINEAR if kind == "iso_linear"
                     else int(ids[np.argmax(sizes[ids])]))
    return out


def _leaf_objective(model, leaf):
    """``(mll, tied gradient, seconds)`` of the training objective
    (``train._chunk_leaf_mll``) on ``leaf``'s one-leaf batch at the model's
    hypers, synchronized."""
    import torch

    from deepstructuredmixtures_tpu_torch.train import (_chunk_leaf_mll,
                                                        _value_and_grad)

    one = _leaf_batch(model, leaf)
    t0 = time.perf_counter()
    val, g = _value_and_grad(
        lambda th: _chunk_leaf_mll(model.layout, th, one).sum())(model.theta)
    torch.cuda.synchronize()
    return float(val), g.double().cpu().numpy(), time.perf_counter() - t0


def _objective_gates(name, obj32, obj64):
    """Per entry, the float32 objective and gradient against float64 by
    phase 11's bounds; returns ``(mll errors, gradient errors)``."""
    mll_rel = {k: abs(obj32[k][0] - obj64[k][0]) / abs(obj64[k][0])
               for k in obj32}
    grad_rel = {k: _rel(obj32[k][1], obj64[k][1]) for k in obj32}
    _gate(f"{name} objective f32 vs f64", mll_rel, SLICE_TOL["evidence_rel"])
    _gate(f"{name} gradient f32 vs f64", grad_rel, TRAIN_GRAD_TOL)
    return mll_rel, grad_rel


def _mixture_streamed(xt):
    """Phase 14 at N=100k: the streamed pipeline in float32 (cold, then a
    warm run) and float64, the blocked kernel on every bucket, per-kind
    oracle; the training objective on three one-leaf batches. Returns the
    ``(fused, blocked)`` launches of the cold pipeline and the objective."""
    import torch

    n = MIXTURE_N
    t0 = time.perf_counter()
    m32 = mixture_model(n, torch.float32)
    build_s = time.perf_counter() - t0
    _no_fused_domain(m32, f"mixture N={n}")
    kid = m32.plan.leaf_kernelid
    sizes = np.array([o.size for o in m32.plan.leaf_obs])
    expected = _twice(_expected_launches(m32))
    if not expected[1]:
        raise AssertionError(f"mixture N={n}: no bucket on the blocked kernel")
    cold, warm = {}, {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    light_pipeline(m32, xt, cold)()
    cold_s = time.perf_counter() - t0
    got = launches()
    if got != expected:
        raise AssertionError(f"mixture N={n} launched {got}, expected {expected}")
    t0 = time.perf_counter()
    pipeline = light_pipeline(m32, xt, warm)
    z, mean, var = pipeline()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _finite_moments(f"mixture N={n}", mean, var, T_TEST)
    x, y = make_data(n)
    oracle, oracle_sizes = _per_kind_oracle(
        x, y, m32, m32.leaf_mlls().double().cpu().numpy())
    _gate(f"mixture N={n} leaves vs the float64 oracle", oracle,
          ORACLE_TOL["mll_rel"])
    # the training objective on three one-leaf batches (the kept route: one
    # blocked launch each), and the light fit's leaf mll at the same hypers
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    picks = _objective_leaves(m32)
    reset_launches()
    obj32 = {k: _leaf_objective(m32, l) for k, l in picks.items()}
    fit_mll = {k: float(fitlib.bucketed_leaf_mlls(
        m32.layout, m32.theta, [_leaf_batch(m32, l)], [[l]], m32.num_leaves)[l])
        for k, l in picks.items()}
    obj_launches = launches()
    if obj_launches != (0, 2 * len(picks)):
        raise AssertionError(f"mixture objective launched {obj_launches}")
    obj_vs_fit = {k: abs(obj32[k][0] - fit_mll[k]) / abs(fit_mll[k])
                  for k in picks}
    _gate(f"mixture N={n} objective vs the light fit", obj_vs_fit,
          OBJECTIVE_FIT_TOL)
    line = dict(leaves=m32.num_leaves, leaves_per_kind={
        k: int((kid == i).sum()) for i, k in enumerate(m32.layout.kinds)},
        leaf_sizes=[int(sizes.min()), int(sizes.max())],
        buckets=len(m32.bucket_batches),
        nmax=[min(m32.bucket_spec.nmaxs), max(m32.bucket_spec.nmaxs)],
        build_s=build_s, cold_pipeline_s=cold_s, cold=cold, pipeline_s=warm_s,
        fit_s=warm["fit_s"], predict_t2000_s=warm["predict_s"],
        peak_memory_bytes=peak, launches=got,
        blocked_shapes=_blocked_shapes(m32), errors_vs_oracle=oracle,
        oracle_leaf_sizes=oracle_sizes)
    run32 = {"z": z, "preds": {T_TEST: (mean, var)}}
    del m32, pipeline
    m64 = mixture_model(n, torch.float64)
    z64, mean64, var64 = light_pipeline(m64, xt)()
    obj64 = {k: _leaf_objective(m64, l) for k, l in picks.items()}
    del m64
    errs = slice_errors(run32, {"z": z64, "preds": {T_TEST: (mean64, var64)}},
                        sizes=(T_TEST,))
    _gate(f"mixture N={n} f32 vs f64", {k: errs[k] / SLICE_TOL[k]
                                         for k in SLICE_TOL}, 1.0)
    obj_mll_rel, obj_grad_rel = _objective_gates(f"mixture N={n}", obj32, obj64)
    say(f"mixture_n{n}", **line, evidence_f32=z, evidence_f64=z64,
        errors_f32_vs_f64=errs,
        objective_leaves={k: [l, int(sizes[l])] for k, l in picks.items()},
        objective_mll_f32_rel_vs_f64=obj_mll_rel,
        objective_grad_f32_rel_vs_f64=obj_grad_rel,
        objective_mll_rel_vs_light_fit=obj_vs_fit,
        objective_s={k: [obj32[k][2], obj64[k][2]] for k in picks},
        objective_launches=obj_launches,
        tolerances={"f32": SLICE_TOL, "oracle": ORACLE_TOL["mll_rel"],
                    "grad_rel": TRAIN_GRAD_TOL,
                    "objective_vs_fit": OBJECTIVE_FIT_TOL},
        card=card_line())
    return tuple(a + b for a, b in zip(got, obj_launches))


def _adam_steps(vg, theta0, steps, lr):
    """``steps`` tied Adam steps along ``vg``'s gradient from ``theta0``:
    the mll curve, the first gradient and each step's synchronized
    seconds."""
    import torch

    theta = theta0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr)
    curve, secs, first = [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        v, g = vg(theta.detach())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        curve.append(float(v))
        first = g.detach().clone() if first is None else first
        theta.grad = -g
        opt.step()
    return curve, first, secs


def _mixture_hybrid_train():
    """Phase 14 at N=20k: the hybrid store (the blocked kernel above nmax
    1024, the fused kernel never), tied training steps and one fine-tune
    iteration over every candidate. Returns the ``(fused, blocked)``
    launches of the hybrid fit, the tied steps' objective and the
    fine-tune (its gradient and its refit)."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.plan import MixtureOverlap
    from deepstructuredmixtures_tpu_torch.train import (
        _candidate_rows, make_value_and_grad_bucketed)

    n = MIXTURE_HYBRID_N
    t0 = time.perf_counter()
    m32 = mixture_model(n, torch.float32, overlap=True)
    build_s = time.perf_counter() - t0
    if not isinstance(m32.plan.overlap, MixtureOverlap):
        raise AssertionError("the mixture's D is not the sparse MixtureOverlap")
    expected = _expected_launches(m32)
    if expected[0] or not expected[1]:
        raise AssertionError(f"mixture N={n}: expected launches {expected}")
    fit_s, hybrid_launches = _hybrid_fit(m32)
    cached_bytes = m32.last_fit_diagnostics["cached_bytes"]
    h32 = {"z": m32.update()}
    h32["preds"], predict_s = _timed_predicts(m32)
    m64 = mixture_model(n, torch.float64, overlap=True)
    m64.fit(store="hybrid")
    h64 = {"z": m64.update()}
    h64["preds"], _ = _timed_predicts(m64)
    errs = _compare(h32, h64)

    buckets = (m32.plan, m32.bucket_batches, m32.bucket_spec.leaf_ids)
    vg = make_value_and_grad_bucketed(m32.layout, *buckets)
    step_expected = _train_launches(m32, per_bucket=True)
    reset_launches()
    curve, g32, step_s = _adam_steps(vg, m32.theta, MIXTURE_STEPS, MIXTURE_LR)
    train_launches = launches()
    if train_launches != (0, MIXTURE_STEPS * step_expected[1]):
        raise AssertionError(f"mixture training launched {train_launches}, "
                             f"expected {MIXTURE_STEPS} x {step_expected}")
    if not np.all(np.diff(curve) > 0):
        raise AssertionError(f"mixture training: the mll does not ascend {curve}")
    vg64 = make_value_and_grad_bucketed(m64.layout, m64.plan, m64.bucket_batches,
                                        m64.bucket_spec.leaf_ids)
    v64, g64 = vg64(m64.theta)
    del m64, vg64, h64
    mll_rel = abs(curve[0] - float(v64)) / abs(float(v64))
    grad_rel = _rel(g32.double().cpu().numpy(), g64.double().cpu().numpy())
    if not (mll_rel <= SLICE_TOL["evidence_rel"] and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"mixture N={n} f32 vs f64: mll {mll_rel}, "
                             f"grad {grad_rel}")

    refit_expected = _refit_launches(m32)
    L = m32.num_leaves
    W = _candidate_rows(m32.plan.overlap, np.arange(L))
    np.fill_diagonal(W, 1.0)
    ft_expected = _finetune_launches(m32, np.arange(L), W)
    record = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = tdsm.finetune(m32, _recording(torch.optim.Adam, record, lr=MIXTURE_LR),
                         iterations=1, lam=1e-9, bucketed=True, sparse=True,
                         progress=False)
    finetune_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ft_launches = launches()
    refit = tuple(a - b for a, b in zip(ft_launches, record[0][1]))
    if record[0][1] != ft_expected or refit != refit_expected:
        raise AssertionError(f"mixture finetune: launches {record[0][1]} in the "
                             f"gradient and {refit} in the refit, expected "
                             f"{ft_expected} and {refit_expected}")
    if not (np.isfinite(hist).all() and m32.theta.shape == (L, m32.layout.total)):
        raise AssertionError(f"mixture finetune: history {hist}")
    pairs = int(np.count_nonzero(W))
    say(f"mixture_n{n}", leaves=L, buckets=len(m32.bucket_batches),
        nmax=[min(m32.bucket_spec.nmaxs), max(m32.bucket_spec.nmaxs)],
        build_s=build_s, hybrid_fit_s=fit_s, launches_hybrid=hybrid_launches,
        blocked_shapes=_blocked_shapes(m32),
        cached_bytes=cached_bytes,
        predict_s={str(k): v for k, v in predict_s.items()},
        errors_f32_vs_f64=errs, train_route="make_value_and_grad_bucketed",
        train_mll=curve, train_step_s=step_s, train_launches=train_launches,
        mll_f32_rel_vs_f64=mll_rel, grad_f32_rel_vs_f64=grad_rel,
        finetune_candidates=L, finetune_pairs=pairs,
        finetune_hist=hist.tolist(),
        finetune_iteration_s=_iteration_seconds(t0, record),
        finetune_s=finetune_s, finetune_peak_memory_bytes=peak,
        finetune_gradient_launches=record[0][1], refit_launches=refit,
        tolerances={"f32": SLICE_TOL, "grad_rel": TRAIN_GRAD_TOL},
        card=card_line())
    return tuple(a + b + c for a, b, c in zip(hybrid_launches, train_launches,
                                              ft_launches))


def phase_mixture():
    """Phase 14, kernel-mixture leaves (see the module docstring). Returns
    the ``(fused, blocked)`` launches of its counted runs."""
    t0 = time.perf_counter()
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    launched = np.add(_mixture_streamed(xt), _mixture_hybrid_train())
    launched = tuple(int(v) for v in launched)
    say("mixture", seconds=time.perf_counter() - t0, launches=launched)
    return launched


def config5_data(n=CONFIG5_N, d=CONFIG5_D, sub=CONFIG5_SUB, t=T_TEST):
    """BASELINE config 5's data in ``bench.py``'s draw order (seed 1):
    ``x [n, d]`` uniform, ``y``, the warm start's sorted subsample, and the
    uniform test points ``[t, d]``."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 1.0, (n, d))
    y = (np.sin(x[:, 0] * 6.0) * np.cos(x[:, 1] * 4.0) + 0.5 * x[:, 2]
         - 0.3 * x[:, 3] ** 2 + 0.1 * rng.standard_normal(n))
    idx = np.sort(rng.choice(n, min(sub, n), replace=False))
    xt = rng.uniform(0.0, 1.0, (t, d))
    return x, y, idx, xt


def config5_model(x, y, dtype, V=3, K=4, seed=0):
    """The additive ArdSE DSMGP of config 5 (M=30, log noise -1)."""
    import deepstructuredmixtures_tpu_torch as tdsm

    return tdsm.build_dsmgp(x, y, V=V, K=K, M=30,
                            kernel=tdsm.ArdSE([0.0] * x.shape[1], 0.0),
                            log_noise=-1.0, seed=seed, device="cuda",
                            dtype=dtype, do_fit=False)


def config5_warm_start(x, y, idx, dtype):
    """The warm start of config 5: ``train`` (Adam, lr 5e-2, 15
    iterations) on the subsample model (V=2, K=3, seed 1). Returns the
    trained model, its mll history and its seconds."""
    import functools

    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    msub = config5_model(x[idx], y[idx], dtype, V=2, K=3, seed=1)
    t0 = time.perf_counter()
    hist = tdsm.train(msub, functools.partial(torch.optim.Adam,
                                              lr=CONFIG5_WARM_LR),
                      iterations=CONFIG5_WARM_ITERS, lam=1e-9, randinit=False,
                      progress=False)
    torch.cuda.synchronize()
    return msub, hist, time.perf_counter() - t0


def phase_config5():
    """Phase 15, BASELINE config 5 (see the module docstring). Returns the
    ``(fused, blocked)`` launches of the warm start (its objective and its
    refit), the main path (light fit, routed predict) and the fine-tune
    (its gradient, its refit and the predict after it)."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.train import (
        _candidate_rows, make_finetune_vg_bucketed)

    t_phase = time.perf_counter()
    n_train = CONFIG5_N
    x, y, idx, xt = config5_data(n_train)
    t0 = time.perf_counter()
    model = config5_model(x, y, torch.float32)
    build_s = time.perf_counter() - t0
    _no_fused_domain(model, "config 5")
    reset_launches()
    msub, warm_hist, warm_s = config5_warm_start(x, y, idx, torch.float32)
    warm_launches = launches()
    warm_expected = tuple(len(warm_hist) * t + r for t, r in zip(
        _train_launches(msub), _refit_launches(msub)))
    if warm_launches != warm_expected:
        raise AssertionError(f"config 5 warm start launched {warm_launches}, "
                             f"expected {warm_expected}")
    theta = msub.get_params()
    model.set_params(theta)
    if not np.array_equal(model.get_params(), theta):
        raise AssertionError("the warm start did not carry the hypers unchanged")
    del msub
    expected = _twice(_expected_launches(model))
    if not expected[1]:
        raise AssertionError("config 5: no bucket on the blocked kernel")
    secs = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    z, mean, var = light_pipeline(model, xt, secs)()
    main_launches = launches()
    if main_launches != expected:
        raise AssertionError(f"config 5 launched {main_launches}, expected "
                             f"{expected}")
    _finite_moments("config 5", mean, var, T_TEST)
    leaf_mll = model.leaf_mlls().double().cpu().numpy()
    sizes = np.array([o.size for o in model.plan.leaf_obs])
    theta64 = model.theta.double().cpu().numpy()
    picks = [int(l) for l in np.argsort(sizes, kind="stable")[:3]]
    oracle = max(abs(leaf_mll[l] - m) / max(1.0, abs(m)) for l, m in (
        (l, oracle_leaf(x, y, model.plan, model.layout, theta64, l))
        for l in picks))
    _gate("config 5 leaves vs the float64 oracle", {"mll_rel": oracle},
          ORACLE_TOL["mll_rel"])

    record = []
    cand = np.arange(sizes.size)
    if CONFIG5_FT_CANDIDATES is not None:
        order = np.argsort(sizes, kind="stable")
        cand = np.unique(order[np.linspace(0, sizes.size - 1,
                                           CONFIG5_FT_CANDIDATES).astype(int)])
    W = _candidate_rows(model.plan.overlap, cand)
    W[np.arange(cand.size), cand] = 1.0
    ft_expected = _finetune_launches(model, cand, W)
    reset_launches()
    t_ft = time.perf_counter()
    hist = tdsm.finetune(model, _recording(torch.optim.Adam, record,
                                           lr=CONFIG5_FT_LR),
                         iterations=1, lam=1e-9, bucketed=True, sparse=True,
                         leaves=cand, progress=False)
    finetune_s = time.perf_counter() - t_ft
    t0 = time.perf_counter()
    mean_ft, var_ft = model.predict(xt)
    torch.cuda.synchronize()
    predict_ft_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(hist).all():
        raise AssertionError(f"config 5 finetune: history {hist}")
    _finite_moments("config 5 after the finetune", mean_ft, var_ft, T_TEST)
    ft_launches = launches()
    after = tuple(a - b for a, b in zip(ft_launches, record[0][1]))
    if record[0][1] != ft_expected or after != _refit_and_predict_launches(
            model):
        raise AssertionError(f"config 5 finetune: launches {record[0][1]} in "
                             f"the gradient, {after} in the refit and "
                             f"predict, expected {ft_expected} and "
                             f"{_refit_and_predict_launches(model)}")
    g32 = record[0][2][torch.as_tensor(cand, device="cuda")]
    g32 = g32.double().cpu().numpy()
    pairs = int(np.count_nonzero(W))
    nmaxs = model.bucket_spec.nmaxs
    shapes = _blocked_shapes(model)
    del model
    model64 = config5_model(x, y, torch.float64)
    model64.set_params(theta)
    # the fine-tune's first evaluation (the candidates' own mlls, their
    # gradients) at the same hypers in float64
    t0 = time.perf_counter()
    H64 = model64.theta.expand(cand.size, -1).contiguous()
    mll64, G64 = make_finetune_vg_bucketed(
        model64.layout, model64.plan, model64.bucket_batches,
        model64.bucket_spec.leaf_ids, sparse=True)(
            H64, torch.as_tensor(W, device="cuda"))
    own64 = float(mll64[torch.arange(cand.size), torch.as_tensor(cand)].sum())
    ft64_s = time.perf_counter() - t0
    ft_mll_rel, ft_grad_rel = _objective_gates(
        "config 5 fine-tune", {"candidates": (hist[0], g32)},
        {"candidates": (own64, G64.cpu().numpy())})
    model64.fit(store="light")
    z64 = model64.update()
    mean64, var64 = model64.predict(xt)
    del model64
    errs = slice_errors({"z": z, "preds": {T_TEST: (mean, var)}},
                        {"z": z64, "preds": {T_TEST: (mean64, var64)}},
                        sizes=(T_TEST,))
    _gate("config 5 f32 vs f64", {k: errs[k] / SLICE_TOL[k] for k in SLICE_TOL},
          1.0)
    say(f"config5_n{n_train}", leaves=int(sizes.size),
        leaf_sizes=[int(sizes.min()), int(sizes.max())],
        buckets=len(nmaxs), nmax=[min(nmaxs), max(nmaxs)],
        build_s=build_s, warm_start_s=warm_s, warm_start_launches=warm_launches,
        hypers=theta.tolist(), fit_s=secs["fit_s"],
        predict_t2000_s=secs["predict_s"], launches=main_launches,
        blocked_shapes=shapes,
        finetune_candidates=cand.tolist(),
        finetune_candidate_sizes=sizes[cand].tolist(), finetune_pairs=pairs,
        finetune_hist=hist.tolist(),
        finetune_iteration_s=_iteration_seconds(t_ft, record),
        finetune_s=finetune_s, predict_after_finetune_s=predict_ft_s,
        finetune_gradient_launches=record[0][1],
        finetune_mll_f32_rel_vs_f64=ft_mll_rel["candidates"],
        finetune_grad_f32_rel_vs_f64=ft_grad_rel["candidates"],
        finetune_f64_evaluation_s=ft64_s,
        peak_memory_bytes=peak, evidence_f32=z, evidence_f64=z64,
        errors_f32_vs_f64=errs, oracle_leaf_sizes=sizes[picks].tolist(),
        oracle_mll_rel=oracle, finetune_launches=ft_launches,
        tolerances={"f32": SLICE_TOL, "oracle": ORACLE_TOL["mll_rel"],
                    "grad_rel": TRAIN_GRAD_TOL},
        card=card_line(),
        seconds=time.perf_counter() - t_phase)
    return tuple(int(a + b + c) for a, b, c in zip(warm_launches, main_launches,
                                                   ft_launches))


# ---------------------------------------------------------------------------
# The scale frontier (phase 16): the depth-4 streamed pipeline at N=500k and
# N=1M, held to the repo's sampled float64 leaf oracles
# ---------------------------------------------------------------------------

#: phase 16 (``README.md``'s scale frontier, ``bench.py --n N --depth 4
#: --no-overlap --check-mlls FILE``): the training points, the seed file of
#: sampled float64 leaf oracles that ``_seed_n1m_baseline.py`` wrote for
#: that tree, the passes (the wall-clock is the least after the first, or
#: the one pass: N=1M runs once, cold after N=500k's, to keep the script
#: within its time limit), and whether a float64 pass on the card follows
FRONTIER_RUNS = ((500_000, "n500k_sampled_moments.npz", 2, True),
                 (1_000_000, "n1m_sampled_moments.npz", 1, False))
FRONTIER_DEPTH, FRONTIER_M = 4, 30
#: the SPN combine against its float64 NumPy replica on the port's own leaf
#: moments at every leaf (``bench.py:1668-1688``), mean absolute and
#: variance relative
COMBINE_TOL = {"mean_abs": 1e-8, "var_rel": 1e-8}


def frontier_model(n_train, dtype, device="cuda"):
    """The model of ``bench.py:93-99`` on the depth-4 tree, built as
    ``bench.py --no-overlap`` builds it: V=3, K=4, M=30, IsoSE(0, 0), log
    noise -1, seed 0, no overlap analysis."""
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = make_data(n_train)
    return tdsm.build_dsmgp(x, y, V=3, K=4, M=FRONTIER_M,
                            kernel=tdsm.IsoSE(0.0, 0.0), log_noise=-1.0, seed=0,
                            device=device, dtype=dtype, do_fit=False,
                            depth=FRONTIER_DEPTH, overlap=False)


def load_seed(path, n_train, depth, m, num_leaves):
    """The sampled float64 leaf oracles of the seed file ``path``
    (``_seed_n1m_baseline.py``'s format), checked as ``bench.py:1348-1389``
    checks a ``--check-mlls`` file before its run: stamped with this run's
    ``(n, depth, m)``, distinct leaf ids below ``num_leaves``, and arrays
    of consistent shapes. Returns ``{leaves, mlls, mu, var, tcount}``;
    raises on any mismatch."""
    keys = ("leaves", "mlls", "mu", "var", "tcount")
    with np.load(path) as f:
        missing = sorted(set(keys + ("n", "depth", "m")) - set(f.files))
        if missing:
            raise AssertionError(f"{path}: no {missing}")
        stamp = {k: int(f[k]) for k in ("n", "depth", "m")}
        seed = {k: np.asarray(f[k]) for k in keys}
    want = {"n": n_train, "depth": depth, "m": m}
    if stamp != want:
        raise AssertionError(f"{path}: stamped {stamp}, the run is {want}")
    leaves, mu = seed["leaves"], seed["mu"]
    k = leaves.size
    if (k == 0 or leaves.shape != (k,) or seed["mlls"].shape != (k,)
            or seed["tcount"].shape != (k,) or mu.ndim != 2
            or mu.shape[0] != k or seed["var"].shape != mu.shape):
        raise AssertionError(f"{path}: arrays of inconsistent shapes "
                             f"{ {key: a.shape for key, a in seed.items()} }")
    if (leaves.min() < 0 or leaves.max() >= num_leaves
            or np.unique(leaves).size != k):
        raise AssertionError(f"{path}: leaf ids not distinct in [0, "
                             f"{num_leaves})")
    if seed["tcount"].min() < 0 or seed["tcount"].max() > mu.shape[1]:
        raise AssertionError(f"{path}: routed counts outside [0, {mu.shape[1]}]")
    return seed


def check_seed_tree(seed, tmask):
    """The tree-identity check: the routed test counts of the sampled
    leaves (``tmask [L, tmax]``) equal the seed file's."""
    got = np.asarray(tmask)[seed["leaves"]].sum(axis=1)
    if not np.array_equal(got, seed["tcount"]):
        bad = np.nonzero(got != seed["tcount"])[0]
        raise AssertionError(
            f"the seed file was written for another tree: leaves "
            f"{seed['leaves'][bad[:5]].tolist()} route {got[bad[:5]].tolist()} "
            f"test points, the file says {seed['tcount'][bad[:5]].tolist()}")


def seed_errors(seed, mll, mu, var):
    """The sampled leaves against their float64 oracles, as
    ``bench.py:1640-1666`` computes them: the leaf mll relative to max(1,
    |mll|), the mean absolute and the variance relative over each leaf's
    routed points; with the leaf of the worst mll error."""
    leaves = seed["leaves"]
    mll = np.asarray(mll, np.float64)[leaves]
    mll_rel = np.abs(mll - seed["mlls"]) / np.maximum(1.0, np.abs(seed["mlls"]))
    errs = {"mll_rel": float(mll_rel.max()), "mean_abs": 0.0, "var_rel": 0.0}
    for i, leaf in enumerate(leaves):
        nt = int(seed["tcount"][i])
        if nt == 0:
            continue
        m_l = np.asarray(mu[leaf][:nt], np.float64)
        v_l = np.asarray(var[leaf][:nt], np.float64)
        v_o = seed["var"][i][:nt]
        errs["mean_abs"] = max(errs["mean_abs"], float(np.max(
            np.abs(m_l - seed["mu"][i][:nt]))))
        errs["var_rel"] = max(errs["var_rel"], float(np.max(
            np.abs(v_l - v_o) / np.maximum(1e-12, np.abs(v_o)))))
    return errs, int(leaves[np.argmax(mll_rel)])


def np_update_weights(plan, leaf_mlls):
    """Float64 NumPy replica of ``infer.update_weights`` (``bench.py``
    ``_np_update_weights``): the posterior sum-edge log weights and the root
    log evidence."""
    vals = np.asarray(leaf_mlls, dtype=np.float64)
    lw = np.zeros(max(plan.n_sum_edges, 1))
    for g in plan.groups:
        child = vals[g.child_slots]
        if g.kind == "split":
            new = np.zeros(g.n_parents)
            np.add.at(new, g.seg, child)
        else:
            raw = child + g.neg_logk
            m = np.full(g.n_parents, -np.inf)
            np.maximum.at(m, g.seg, raw)
            e = np.zeros(g.n_parents)
            np.add.at(e, g.seg, np.exp(raw - m[g.seg]))
            z = m + np.log(e)
            lw[g.edge_ids] = raw - z[g.seg]
            new = z
        vals = np.concatenate([vals, new])
    return lw, vals[plan.root_slot]


def np_moment_match(plan, mu, var, lw, tidx, tmask, T):
    """Float64 NumPy replica of ``models._routed_moment_match``
    (``bench.py`` ``_np_moment_match``): each leaf's path weight from the
    sparse ``path_edges``, then the log-space moment matching over the
    routed (leaf, point) pairs with the ``μmin − 1`` shift. Returns
    ``(mean [T], var [T])``."""
    mu = np.asarray(mu, np.float64)
    pw = (lw[plan.path_edges] * plan.path_mask).sum(axis=1)  # [L]
    var = np.maximum(np.asarray(var, np.float64), 1e-8)
    seg = np.asarray(tidx).reshape(-1)
    msk = np.asarray(tmask).reshape(-1)
    muf = mu.reshape(-1)
    varf = var.reshape(-1)
    wf = np.broadcast_to(pw[:, None], mu.shape).reshape(-1)
    mu_min = np.full(T, np.inf)
    np.minimum.at(mu_min, seg[msk], muf[msk])
    shift = mu_min - 1.0

    def seg_lse(xv):
        m = np.full(T, -np.inf)
        np.maximum.at(m, seg[msk], xv[msk])
        m_safe = np.where(np.isfinite(m), m, 0.0)
        e = np.zeros(T)
        np.add.at(e, seg[msk], np.exp(xv[msk] - m_safe[seg[msk]]))
        return m_safe + np.log(e)

    lmu = seg_lse(wf + np.log(np.where(msk, muf - shift[seg], 1.0)))
    lmu2 = seg_lse(wf + np.log(np.maximum(muf * muf, 1e-300)))
    lvar = seg_lse(wf + np.log(varf))
    mean = np.exp(lmu) + shift
    return mean, np.exp(lvar) + (np.exp(lmu2) - mean * mean)


def model_flops(plan, tmask):
    """The model operations of one fit+update+predict pass over the true
    leaf sizes (``bench.model_flops``, ``bench.py:58-76``): per leaf the
    training gram, the Cholesky, the forward solve of ``[y | K_nt]``, the
    cross gram and the moments' reductions."""
    D = plan.dim
    n = np.array([o.size for o in plan.leaf_obs], np.float64)
    t = np.asarray(tmask).sum(axis=1).astype(np.float64)
    return float(np.sum(2.0 * n * n * D + n ** 3 / 3.0 + 2.0 * n * n * (t + 1)
                        + 2.0 * n * t * D + 4.0 * n * t))


def _frontier_run(n_train, seed_file, passes, float64):
    """One line of phase 16 at ``n_train`` points; returns the fused
    kernel's and the blocked kernel's launches in its counted passes."""
    import torch

    from deepstructuredmixtures_tpu_torch.ops import fused_chol

    t0 = time.perf_counter()
    model = frontier_model(n_train, torch.float32)
    build_s = time.perf_counter() - t0
    seed = load_seed(os.path.join(REPO, seed_file), n_train, FRONTIER_DEPTH,
                     FRONTIER_M, model.num_leaves)
    xt = np.linspace(-0.05, 1.05, T_TEST).reshape(-1, 1)
    tidx, tmask = model._route(xt)
    check_seed_tree(seed, tmask)
    shapes = _launch_shapes(model)
    expected = _expected_launches(model)
    unheld = sorted({s for k, s in shapes if k == "fused"} - set(KERNEL_SHAPES))
    if unheld:
        raise AssertionError(f"phase 2 does not hold the fused kernel at {unheld}")
    sizes = np.array([o.size for o in model.plan.leaf_obs])
    flops = model_flops(model.plan, tmask)
    pipeline = streamed_pipeline(model, leaves=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(passes):
        reset_launches()
        trsm0 = trsm_launches()
        t0 = time.perf_counter()
        out = pipeline()
        runs.append(time.perf_counter() - t0)
        if launches() != expected or trsm_launches() - trsm0 != expected[1]:
            raise AssertionError(f"N={n_train}: launches {launches()} and "
                                 f"{trsm_launches() - trsm0} forward solves, the "
                                 f"plan counts {expected} and {expected[1]}")
    peak = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved())
    mean, v, z, mu, var, mll = out
    del out, pipeline
    _finite_moments(f"frontier N={n_train}", mean, v, T_TEST)
    mu, var, mll = (a.double().cpu().numpy() for a in (mu, var, mll))
    if not (np.isfinite(mll).all() and np.isfinite(mu[tmask]).all()
            and (var[tmask] > 0).all()):
        raise AssertionError(f"N={n_train}: non-finite leaf moments or mlls")
    oracle, worst_leaf = seed_errors(seed, mll, mu, var)
    _gate(f"N={n_train} sampled leaves vs the float64 seed",
          {k: oracle[k] / ORACLE_TOL[k] for k in ORACLE_TOL}, 1.0)
    lw64, z_rep = np_update_weights(model.plan, mll)
    rep_mean, rep_var = np_moment_match(model.plan, mu, var, lw64, tidx, tmask,
                                        T_TEST)
    combine = _moment_errors(mean, v, rep_mean, rep_var)
    combine["evidence_abs"] = abs(float(z) - float(z_rep))
    _gate(f"N={n_train} combine vs its float64 replica",
          {k: combine[k] / COMBINE_TOL[k] for k in COMBINE_TOL}, 1.0)
    fused = [(nm, len(ids)) for nm, ids in zip(model.bucket_spec.nmaxs,
                                               model.bucket_spec.leaf_ids)
             if fused_chol.supported(nm, model.dtype, model.layout.kinds,
                                     model.device)]
    line = dict(
        leaves=model.num_leaves, buckets=len(model.bucket_batches),
        largest_leaf=int(sizes.max()), fused_buckets=fused,
        fused_launches=expected[0], blocked_launches=expected[1],
        fused_shapes=sorted({s for k, s in shapes if k == "fused"}),
        blocked_shapes=sorted({s for k, s in shapes if k == "blocked"}),
        sampled_leaves=int(seed["leaves"].size),
        sampled_tcount_equal=True, build_s=build_s,
        metric=f"dsmgp_v3k4_depth4_fit_update_predict_n{n_train}_t{T_TEST}"
               "_wallclock",
        seconds=min(runs[1:] or runs), runs=runs, model_tflop=flops / 1e12,
        model_tflop_per_s=flops / 1e12 / min(runs[1:] or runs),
        peak_memory_allocated_bytes=peak[0], peak_memory_reserved_bytes=peak[1],
        evidence_f32=float(z), errors_vs_seed=oracle,
        worst_mll_leaf=worst_leaf, worst_mll_leaf_size=int(sizes[worst_leaf]),
        combine_vs_replica=combine,
        tolerances={"seed": ORACLE_TOL, "combine": COMBINE_TOL})
    del model
    torch.cuda.empty_cache()
    if float64:
        t0 = time.perf_counter()
        model64 = frontier_model(n_train, torch.float64)
        reset_launches()
        trsm0 = trsm_launches()
        mean64, v64, z64 = streamed_pipeline(model64)()
        line["float64_s"] = time.perf_counter() - t0
        if any(launches()) or trsm_launches() != trsm0:
            raise AssertionError(f"the float64 pass launched {launches()} and "
                                 f"{trsm_launches() - trsm0} forward solves")
        del model64
        torch.cuda.empty_cache()
        errs = slice_errors({"z": float(z), "preds": {T_TEST: (mean, v)}},
                            {"z": float(z64), "preds": {T_TEST: (mean64, v64)}},
                            sizes=(T_TEST,))
        _gate(f"N={n_train} f32 vs f64",
              {k: errs[k] / SLICE_TOL[k] for k in SLICE_TOL}, 1.0)
        line.update(evidence_f64=float(z64), errors_f32_vs_f64=errs)
        line["tolerances"]["f32"] = SLICE_TOL
    say(f"frontier_n{n_train}", **line, card=card_line())
    return tuple(len(runs) * e for e in expected)


def phase_frontier():
    """Phase 16 (module docstring); returns the ``(fused, blocked)``
    launches of its counted passes."""
    t_phase = time.perf_counter()
    total = (0, 0)
    for n_train, seed_file, passes, float64 in FRONTIER_RUNS:
        got = _frontier_run(n_train, seed_file, passes, float64)
        total = tuple(a + b for a, b in zip(total, got))
    say("frontier", seconds=time.perf_counter() - t_phase, launches=total)
    return total


def main():
    t_start = time.perf_counter()
    phase_environment()
    sys.path.insert(0, REPO)
    import torch

    phase_build()
    from deepstructuredmixtures_tpu_torch.ops import trsm

    max_err, ms, plain_ms, fused_bound, fused_bound_by = phase_kernel()
    blocked_line = phase_potrf()
    trsm_line = phase_trsm()
    # the forward-solve kernel's launches of each main-path phase
    trsm_by_phase = {}

    def counted(name, phase, *args):
        trsm.LAUNCHES = 0
        out = phase(*args)
        trsm_by_phase[name] = trsm.LAUNCHES
        return out

    run20k, run20k64 = counted("slice_n20000", phase_slice, 20_000, True)
    run100k, run100k64 = counted("slice_n100000", phase_slice, 100_000, False)
    headline_s, headline_launches = counted("headline", phase_headline, run100k["model"])
    depth4_fused, depth4_blocked = counted("depth4", phase_depth4)
    refine_fused, refine_blocked = counted("refine", phase_refine, run20k, run20k64,
                                           run100k, run100k64, headline_s)
    fused_launches = (run20k["fit_launches"] + run20k["predict_launches"]
                      + depth4_fused + refine_fused)
    blocked_launches = (run20k["blocked_launches"] + run100k["blocked_launches"]
                        + headline_launches[1] + depth4_blocked + refine_blocked)
    counted("hybrid_n20000", phase_hybrid_20k, run20k, run20k64)
    ref20k = _ref(run20k64)
    del run20k, run20k64
    blocked_launches += counted("hybrid_n100000", phase_hybrid_100k, run100k, run100k64)
    ref100k = _ref(run100k64)
    del run100k, run100k64
    for n_train, kernel in FULL_STORE_RUNS:
        fused, blocked = counted(f"full_store_n{n_train}", phase_full_store, n_train,
                                 kernel)
        fused_launches += fused
        blocked_launches += blocked
    blocked_launches += counted("gp", phase_gp)[1]
    train_fused, train_blocked = counted("training", phase_training)
    fused_launches += train_fused
    blocked_launches += train_blocked
    mesh_fused, mesh_blocked = counted("mesh", phase_mesh, ref20k, ref100k)
    fused_launches += mesh_fused + counted("poe", phase_poe)
    blocked_launches += mesh_blocked
    for name, phase in (("mixture", phase_mixture), ("config5", phase_config5),
                        ("frontier", phase_frontier)):
        fused, blocked = counted(name, phase)
        fused_launches += fused
        blocked_launches += blocked
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [{
        "name": "fused_gram_cholesky",
        "route": "cuda",
        "source": "deepstructuredmixtures_tpu_torch/csrc/fused_gram_cholesky.cu",
        "replaces": "deepstructuredmixtures_tpu/ops/pallas_chol.py:219",
        "launches": fused_launches,
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
    }, {
        "name": "fused_trsm_moments",
        "route": "cuda",
        "source": "deepstructuredmixtures_tpu_torch/csrc/trsm_moments.cu",
        "replaces": None,
        "launches": sum(trsm_by_phase.values()),
        "launches_by_phase": trsm_by_phase,
        "max_abs_err": trsm_line["max_abs_err"],
        "ms": trsm_line["ms"],
        "plain_ms": trsm_line["plain_ms"],
        "bound_ms": trsm_line["bound_ms"],
        "bound_by": trsm_line["bound_by"],
        "library_ms": trsm_line["library_ms"],
    }]}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
