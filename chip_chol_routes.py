#!/usr/bin/env python3
"""Float32 factor routes of the streamed path on one NVIDIA GPU.

    python3 chip_chol_routes.py

Measurements behind ``fit._kept_recipe`` (the streamed path factors a
float32 bucket above nmax 1024 with the blocked kernel and solves in
float64 against it, whatever the kernel set; a single IsoSE used to
keep cuSOLVER and float32 solves):

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

With ``--frontier`` instead:

3. ``frontier``: the three largest sampled leaves of the scale frontier's
   depth-4 trees at N=500k and N=1M (``chip_smoke.py`` phase 16, leaves
   up to 33,303 points), the port's float32 noisy gram factored by
   cuSOLVER (a single IsoSE's former route) and by the blocked kernel, each
   with float32 and with float64 solves (``fit._moments``), and by
   cuSOLVER in float64: the leaf mll, the routed mean and variance against
   the seed file's float64 oracle (the phase's gates), each factor's
   backward error ``max |L L' - K|`` against the float64 gram of the same
   float32 inputs and its milliseconds.

One JSON line each, then the card's name and power limit. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
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


def cusolver_factor(layout, theta, batch):
    """The streamed factor with cuSOLVER in the blocked kernel's place:
    the fused kernel where it applies, else ``cholesky_nosym``
    (``torch.linalg.cholesky_ex``) on the noisy gram."""
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import chol

    Lf = fitlib._maybe_fused_chol(layout, theta, batch)
    if Lf is not None:
        return Lf
    return chol.cholesky_nosym(fitlib._noisy_gram(layout, theta, batch))


def pipeline_routes(label, make, xt):
    """The float32 streamed pipeline by each route against float64."""
    import torch

    import chip_smoke
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    z64, mean64, var64 = chip_smoke.light_pipeline(make(torch.float64), xt)()
    ref = {"z": z64, "preds": {chip_smoke.T_TEST: (mean64, var64)}}
    factor, moments = fitlib._factor, fitlib._moments
    f32_solves = lambda *a: moments(*a[:-1], False)  # noqa: E731
    routes = {
        "cusolver_f32_solves": (cusolver_factor, f32_solves),
        "blocked_f32_solves": (factor, f32_solves),
        "blocked_f64_solves": (factor, moments),
    }
    rec = {"measurement": "routes", "label": label}
    m32 = make(torch.float32)
    try:
        for name, (fac, mom) in routes.items():
            fitlib._factor, fitlib._moments = fac, mom
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
        fitlib._factor, fitlib._moments = factor, moments
    rec["tolerances"] = chip_smoke.SLICE_TOL
    print(json.dumps(rec), flush=True)


def _backward_err(Lf, K64, rows=4096):
    """``max |L L' - K64|`` of a one-leaf factor, in row blocks (at n=33k a
    float64 product of the whole takes 9 GB)."""
    L64 = Lf[0].double()
    err = 0.0
    for s in range(0, L64.shape[0], rows):
        err = max(err, float((L64[s:s + rows] @ L64.mT - K64[0, s:s + rows])
                             .abs().max()))
    return err


def frontier_routes(n_train, seed_file, count=3):
    """``--frontier``: see the module docstring."""
    import torch

    import chip_smoke as cs
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.leafgp import LeafBatch, leaf_mll_forward
    from deepstructuredmixtures_tpu_torch.ops import cholesky as chol
    from deepstructuredmixtures_tpu_torch.ops import potrf

    model = cs.frontier_model(n_train, torch.float32)
    seed = cs.load_seed(os.path.join(cs.REPO, seed_file), n_train,
                        cs.FRONTIER_DEPTH, cs.FRONTIER_M, model.num_leaves)
    xt = np.linspace(-0.05, 1.05, cs.T_TEST).reshape(-1, 1)
    tidx, tmask = model._route(xt)
    cs.check_seed_tree(seed, tmask)
    sizes = np.array([o.size for o in model.plan.leaf_obs])
    xtd = torch.as_tensor(xt, dtype=torch.float32, device=model.device)
    theta, layout = model.theta, model.layout
    for i in np.argsort(-sizes[seed["leaves"]], kind="stable")[:count]:
        leaf, nt = int(seed["leaves"][i]), int(seed["tcount"][i])
        one = cs._leaf_batch(model, leaf)
        one64 = LeafBatch(one.x.double(), one.y.double(), one.mask, one.n,
                          one.mean.double(), one.kernelid)
        xt_leaf = xtd[torch.as_tensor(tidx[leaf][None], dtype=torch.long,
                                      device=model.device)]
        K = fitlib._noisy_gram(layout, theta, one)
        K64 = fitlib._noisy_gram(layout, theta.double(), one64)
        factors = {"cusolver": lambda: chol.cholesky_nosym(K),
                   "blocked": lambda: potrf.blocked_cholesky(K.clone()),
                   "float64": lambda: chol.cholesky_nosym(K64)}
        rec = {"measurement": "frontier", "n_train": n_train, "leaf": leaf,
               "n": int(one.n[0]), "nmax": one.nmax, "routed": nt,
               "mll_f64_seed": float(seed["mlls"][i])}
        for name, fn in factors.items():
            Lf, ms = _timed(fn)
            rec[f"{name}_factor"] = {"ms": ms, "backward_err_max":
                                     _backward_err(Lf, K64)}
            b, th = (one64, theta.double()) if name == "float64" else (one, theta)
            for solve64 in ((True,) if name == "float64" else (False, True)):
                mu, var, z = fitlib._moments(layout, th, b, Lf,
                                             xt_leaf.to(b.x.dtype), solve64)
                mll = float(leaf_mll_forward(Lf, z, b)[0])
                errs, _ = cs.seed_errors(
                    {k: seed[k][i:i + 1] for k in ("mlls", "mu", "var",
                                                    "tcount")}
                    | {"leaves": np.array([0])}, np.array([mll]),
                    mu.double().cpu().numpy(), var.double().cpu().numpy())
                rec[f"{name}_{'f64' if solve64 else 'f32'}_solves"] = errs
            del Lf
            torch.cuda.empty_cache()
        del K, K64
        torch.cuda.empty_cache()
        rec["tolerances"] = cs.ORACLE_TOL
        print(json.dumps(rec), flush=True)


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frontier", action="store_true",
                    help="measure the scale frontier's largest sampled leaves")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_chol_routes.py: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs

    cs.phase_build()
    if args.frontier:
        for n_train, seed_file, _, _ in cs.FRONTIER_RUNS:
            frontier_routes(n_train, seed_file)
        print(cs.card_line(), flush=True)
        return
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
