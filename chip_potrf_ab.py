#!/usr/bin/env python3
"""The streamed path with and without the blocked Cholesky kernel, on one
NVIDIA GPU.

    python3 chip_potrf_ab.py [--refine-steps K]

Measures what the streamed path would gain and lose with the blocked
kernel in place of cuSOLVER: the streamed path's factor (``fit._factor``,
the blocked kernel above nmax 1024) is set to
``chip_chol_routes.cusolver_factor`` (cuSOLVER above nmax 1024) and back in
turns, inside this script only; the solves are the path's own either way.
It prints the headline
pipeline (fit + update + routed predict at T=2000, min of 3) both ways in
turns at N=100k and N=20k, the float32 errors against the float64 run both
ways, and, for single leaves of the N=100k tree, the error of the
predictive mean with each factor (``cholesky_ex``, the kernel, the float64
factor rounded to float32) under a float32 and under a float64 solve.

With ``--refine-steps K`` the pipeline refines each leaf's solves K times
(``refine_steps``): the errors are those of the refined pipeline (its
evidence and its moments at T=2000) against the float64 run, the times
those of the refined pipeline, and the single-leaf probe is skipped.

One JSON object per line; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from chip_chol_routes import cusolver_factor  # noqa: E402


def say(**fields):
    print(json.dumps(fields), flush=True)


def _run(n_train, dtype):
    """build → fit → update → predict at each request size of chip_smoke."""
    import torch

    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = cs.make_data(n_train)
    xt = np.linspace(-0.05, 1.05, cs.T_TEST).reshape(-1, 1)
    model = tdsm.build_dsmgp(x, y, V=3, K=4, M=30, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, device="cuda", dtype=dtype,
                             do_fit=False, overlap=False)
    fit_s = model.fit()
    run = dict(model=model, z=model.update(), fit_s=fit_s, preds={})
    for size in cs.REQUEST_SIZES:
        sel = np.linspace(0, cs.T_TEST - 1, size).astype(int)
        run["preds"][size] = model.predict(xt[sel])
    torch.cuda.synchronize()
    return run


def _leaf_probe(model64):
    """Mean error of single leaves by factor and by solve precision."""
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.leafgp import centered_y, leaf_gram
    from deepstructuredmixtures_tpu_torch.ops import cholesky as chol
    from deepstructuredmixtures_tpu_torch.ops import potrf

    xt = torch.linspace(-0.05, 1.05, 256, dtype=torch.float64, device="cuda")[:, None]
    nb = len(model64.bucket_batches)
    for bi in (nb - 1, nb // 2, 0):
        b = model64.bucket_batches[bi].rows(0, 1)
        K64 = fitlib._noisy_gram(model64.layout, model64.theta, b)
        Knt = torch.where(b.mask[:, :, None],
                          leaf_gram(model64.layout, model64.theta, b, xt), 0.0)
        rhs64 = torch.cat([centered_y(b)[..., None], Knt], dim=-1)
        L64 = torch.linalg.cholesky(K64)
        Z = chol.solve_lower(L64, rhs64)
        ref = torch.einsum("lnt,ln->lt", Z[..., 1:], Z[..., 0])
        K32, rhs32 = K64.float(), rhs64.float()
        factors = {"cholesky_ex": torch.linalg.cholesky_ex(K32)[0],
                   "blocked_kernel": potrf.blocked_cholesky(K32.clone()),
                   "float64_rounded": L64.float()}
        out = {}
        for name, L in factors.items():
            Z32 = chol.solve_lower(L, rhs32)
            mu32 = torch.einsum("lnt,ln->lt", Z32[..., 1:], Z32[..., 0])
            Zm = chol.solve_lower(L.double(), rhs64)
            mum = torch.einsum("lnt,ln->lt", Zm[..., 1:], Zm[..., 0])
            Ld = L.double()
            out[name] = {
                "mean_abs_err_f32_solve": float((mu32.double() - ref).abs().max()),
                "mean_abs_err_f64_solve": float((mum - ref).abs().max()),
                "factor_max_abs_err": float((Ld - L64).abs().max()),
                "backward_max_abs_err": float((Ld @ Ld.mT - K32.double()).abs().max())}
        say(compare="leaf_probe", nmax=int(b.nmax), valid=int(b.n[0]), **out,
            card=cs.card_line())
        del factors, K64, K32, L64, Z
        torch.cuda.empty_cache()


def main():
    import torch

    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.ops import build

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--refine-steps", type=int, default=0,
                    help="refinement steps of the streamed pipeline")
    k = ap.parse_args().refine_steps
    if not torch.cuda.is_available():
        raise SystemExit("chip_potrf_ab.py: no CUDA device")
    build.build(build.KERNELS)
    card = cs.card_line()
    ways = {"cusolver": cusolver_factor, "blocked_kernel": fitlib._factor}
    kept = fitlib._factor
    for n_train in (100_000, 20_000):
        run64 = _run(n_train, torch.float64)
        runs = {}
        for name, fn in ways.items():
            fitlib._factor = fn
            cs.reset_launches()
            runs[name] = _run(n_train, torch.float32)
            if k:
                mean, var, z = cs.streamed_pipeline(runs[name]["model"], k)()
                errs = cs.slice_errors(
                    {"z": float(z), "preds": {cs.T_TEST: (mean, var)}}, run64,
                    sizes=(cs.T_TEST,))
            else:
                errs = cs.slice_errors(runs[name], run64)
            say(compare="streamed_errors", n=n_train, factor=name,
                refine_steps=k, fit_s=runs[name]["fit_s"],
                launches_fused_blocked=cs.launches(), errors_f32_vs_f64=errs,
                within_tolerances=all(errs[key] <= tol
                                      for key, tol in cs.SLICE_TOL.items()),
                tolerances=cs.SLICE_TOL, card=card)
        model = runs["cusolver"]["model"]
        for name in ("cusolver", "blocked_kernel", "blocked_kernel", "cusolver"):
            fitlib._factor = ways[name]
            times = cs.headline_times(model, refine_steps=k)[0]
            say(compare="headline", n=n_train, factor=name, refine_steps=k,
                seconds=min(times), runs=times, card=card)
        fitlib._factor = kept
        if n_train == 100_000 and not k:
            _leaf_probe(run64["model"])
        del run64, runs, model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
