#!/usr/bin/env python3
"""Float32 factor routes of the streamed path on one NVIDIA GPU.

    python3 chip_chol_routes.py

Two measurements behind ``fit._kept_recipe`` (a single IsoSE kernel
streams with cuSOLVER and float32 solves; every other kernel set with the
blocked kernel and float64 solves):

1. ``leaves``: one large leaf of each kind, the noisy gram built by the
   port in float32 and factored by ``torch.linalg.cholesky_ex`` (the
   cuSOLVER route, as a [1, n, n] batch and as one matrix), by the blocked
   kernel and its plain version, by ``cholesky_ex`` on a batch of four
   copies (cuSOLVER's batched route) and on the CPU: each factor's leaf mll
   against float64, its backward error ``max |L L' - K|`` against the
   float64 gram and its milliseconds. The leaves: the worst IsoLinear leaf
   (n=7,627) and the largest IsoSE leaf of the kernel-mixture model at
   N=100k, the headline tree's largest leaf, and two ArdSE leaves of
   BASELINE config 5 under its warm-start hypers;
2. ``routes``: the mixture's streamed pipeline at N=100k and config 5's
   (``chip_smoke.light_pipeline``) in float32 by three routes, against the
   float64 pipeline: ``cusolver_f32_solves`` (the route before
   ``_kept_recipe``), ``blocked_f32_solves`` and ``blocked_f64_solves``
   (the route now): root evidence relative, mean absolute, variance
   relative, and the pipeline's seconds.

One JSON line each, then the card's name and power limit. Needs a CUDA
device.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

#: config 5's warm-start hypers in the runs of chip_smoke.py phase 15 on an
#: H100 (the 15 Adam iterations give these in float32)
CONFIG5_HYPERS = [-0.6845075488090515, -0.6226929426193237, 0.7125609517097473,
                  0.726530134677887, 0.2509859502315521, -1.1140953302383423]


def _leaf_gram(model, leaf):
    """``(noisy gram [1, n, n], the leaf's one-leaf batch)``."""
    import chip_smoke
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    one = chip_smoke._leaf_batch(model, leaf)
    return fitlib._noisy_gram(model.layout, model.theta, one), one


def _mll(Lf, one):
    from deepstructuredmixtures_tpu_torch import leafgp
    from deepstructuredmixtures_tpu_torch.ops import cholesky as chol

    y = leafgp.centered_y(one)[..., None].to(Lf.dtype)
    z = chol.solve_lower(Lf, y)[..., 0]
    return float(leafgp.leaf_mll_forward(Lf.double(), z.double(), one)[0])


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def leaf_routes(label, m32, m64, leaf):
    import torch

    from deepstructuredmixtures_tpu_torch.ops import potrf

    K32, one32 = _leaf_gram(m32, leaf)
    K64, one64 = _leaf_gram(m64, leaf)
    ref = _mll(torch.linalg.cholesky(K64), one64)
    ways = {
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(K32)[0],
        "cholesky_ex_one_matrix": lambda: torch.linalg.cholesky_ex(K32[0])[0][None],
        "blocked_kernel": lambda: potrf.blocked_cholesky(K32.clone()),
        "blocked_plain": lambda: potrf.blocked_cholesky_reference(K32),
        "cholesky_ex_batch_of_4": lambda: torch.linalg.cholesky_ex(
            K32.expand(4, -1, -1).contiguous())[0][:1],
        "cpu": lambda: torch.linalg.cholesky(K32.cpu()).cuda(),
    }
    rec = {"measurement": "leaves", "label": label, "leaf": int(leaf),
           "n": int(one32.n[0]), "nmax": int(K32.shape[-1]), "mll_f64": ref}
    for name, fn in ways.items():
        Lf, ms = _timed(fn)
        L64 = Lf.double()
        mll = _mll(Lf, one32)
        rec[name] = {"mll_rel": abs(mll - ref) / max(1.0, abs(ref)),
                     "backward_err_max": float((L64 @ L64.mT - K64).abs().max()),
                     "ms": ms}
    print(json.dumps(rec), flush=True)


def pipeline_routes(label, make, xt):
    """The float32 streamed pipeline by each route against float64."""
    import torch

    import chip_smoke
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    z64, mean64, var64 = chip_smoke.light_pipeline(make(torch.float64), xt)()
    ref = {"z": z64, "preds": {chip_smoke.T_TEST: (mean64, var64)}}
    kept, moments = fitlib._kept_recipe, fitlib._moments
    routes = {
        "cusolver_f32_solves": (lambda layout, batch: False, moments),
        "blocked_f32_solves": (kept, lambda *a: moments(*a[:-1], False)),
        "blocked_f64_solves": (kept, moments),
    }
    rec = {"measurement": "routes", "label": label}
    m32 = make(torch.float32)
    try:
        for name, (recipe, mom) in routes.items():
            fitlib._kept_recipe, fitlib._moments = recipe, mom
            run = chip_smoke.light_pipeline(m32, xt)
            run()  # warm
            t0 = time.perf_counter()
            z, mean, var = run()
            secs = time.perf_counter() - t0
            errs = chip_smoke.slice_errors(
                {"z": z, "preds": {chip_smoke.T_TEST: (mean, var)}}, ref,
                sizes=(chip_smoke.T_TEST,))
            rec[name] = {**errs, "pipeline_s": secs}
    finally:
        fitlib._kept_recipe, fitlib._moments = kept, moments
    rec["tolerances"] = chip_smoke.SLICE_TOL
    print(json.dumps(rec), flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_chol_routes.py: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    cs.phase_build()
    models = {dt: cs.mixture_model(100_000, dt) for dt in (torch.float32,
                                                            torch.float64)}
    leaf_routes("iso_linear", models[torch.float32], models[torch.float64],
                cs.MIXTURE_WORST_ISO_LINEAR)
    leaf_routes("iso_se_mixture", models[torch.float32], models[torch.float64],
                183)
    del models
    heads = {dt: cs._train_model(100_000, dt) for dt in (torch.float32,
                                                          torch.float64)}
    sizes = np.array([o.size for o in heads[torch.float32].plan.leaf_obs])
    leaf_routes("iso_se_headline_largest", heads[torch.float32],
                heads[torch.float64], int(np.argmax(sizes)))
    del heads
    x, y, _, xt5 = cs.config5_data()

    def config5(dt):
        m = cs.config5_model(x, y, dt)
        m.set_params(np.asarray(CONFIG5_HYPERS))
        return m

    c = {dt: config5(dt) for dt in (torch.float32, torch.float64)}
    for leaf in (10, 28):
        leaf_routes(f"ard_se_config5_leaf{leaf}", c[torch.float32],
                    c[torch.float64], leaf)
    del c
    torch.cuda.empty_cache()
    xt = np.linspace(-0.05, 1.05, cs.T_TEST).reshape(-1, 1)
    pipeline_routes("mixture_n100000", lambda dt: cs.mixture_model(100_000, dt),
                    xt)
    pipeline_routes("config5_n100000", config5, xt5)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
