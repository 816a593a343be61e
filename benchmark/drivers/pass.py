"""Driver of the ``pass`` traffic kind: back-to-back whole jobs of the
streamed fit-and-predict pass.

One pass, as a user runs it: route the test points to their leaves on the
host (``model._route``), then the streamed fit and predict of every leaf
(``fit.bucketed_streamed_predict``), the posterior weight update
(``infer.update_weights``) and the routed moment match
(``models._routed_moment_match``), and the moments brought to the host.
Set-up builds the model and runs ``warm_passes`` passes; the window runs
passes until ``seconds`` have passed and reports ``pass_s``, the window
over its whole passes. A traced run profiles ``traced_passes`` passes after
the first of the window and takes a synchronized span around the combine.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark import harness


def run(run):
    import torch

    from deepstructuredmixtures_tpu_torch import fit, infer
    from deepstructuredmixtures_tpu_torch.ops import build, fused_chol, potrf
    from deepstructuredmixtures_tpu_torch.models import _routed_moment_match

    cfg, tr, rec = run.cfg, run.traffic, run.rec
    if run.device != "cpu":
        build.build()  # nvcc once per checkout, then the cached libraries
    x, y = harness.make_data(cfg, run.seed)
    xt = harness.test_points(cfg, run.seed)
    T = xt.shape[0]
    with rec.span("build"):
        model = harness.build_model(cfg, x, y, run.device)
    dev = model.device
    combine_sync = run.sync if run.traced else None

    def one_pass():
        with rec.span("route"):
            tidx, tmask = model._route(xt)
            ti = torch.as_tensor(tidx, dtype=torch.long, device=dev)
            tm = torch.as_tensor(tmask, device=dev)
            xtd = torch.as_tensor(xt, dtype=model.dtype, device=dev)
        mu, var, mll = fit.bucketed_streamed_predict(
            model.layout, model.theta, model.bucket_batches,
            model.bucket_spec.leaf_ids, model.num_leaves, xtd, ti,
            refine_steps=tr["refine_steps"])
        with rec.span("combine", sync=combine_sync):
            lw, z = infer.update_weights(model.plan, mll)
            mean, v = _routed_moment_match(model.plan, mu, var, lw, ti, tm, T)
        out = (mean.cpu().numpy(), v.cpu().numpy(), float(z), lw, mll, mu, var)
        return out, tmask

    for _ in range(tr["warm_passes"]):
        out, tmask = one_pass()
    run.work = harness.work_of(model, tmask)
    rec.spans = {"build": rec.spans["build"]}
    run.mark_setup()

    last = {}

    def step():
        last["out"], _ = one_pass()
        return _finite(last["out"])

    def launches():
        return {"fused_launches": fused_chol.LAUNCHES, "blocked_launches": potrf.LAUNCHES}

    n, bad, window = harness.timed_window(run, step, tr["traced_passes"], launches, "pass")
    run.attempted, run.failed = n, bad
    run.e2e["pass_s"] = window / n
    run.read_memory_peak()
    mean, var, z, lw, mll, mu, lvar = last["out"]
    tidx, tmask = model._route(xt)
    run.outputs = {"x": x, "y": y, "xt": xt, "mean": mean, "var": var, "z": z,
                   "weights": np.exp(lw.double().cpu().numpy()),
                   "mll": mll.double().cpu().numpy(),
                   # each leaf's moments at its routed points, leaf by leaf
                   "leaf_points": tidx[tmask],
                   "leaf_mean": mu.double().cpu().numpy()[tmask],
                   "leaf_var": lvar.double().cpu().numpy()[tmask],
                   "leaf_n": np.array(run.work["leaf_n"])}
    del model, out, last, lw, mll, mu, lvar
    run.free_device()


def _finite(out):
    mean, var, z = out[0], out[1], out[2]
    return bool(np.all(np.isfinite(mean)) and np.all(np.isfinite(var)) and np.isfinite(z))
