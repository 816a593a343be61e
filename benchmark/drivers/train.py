"""Driver of the ``train`` traffic kind: tied-hyper training iterations.

One iteration, as ``train.train`` runs it: the value and gradient of the
root mll by the route ``train`` takes (``train._train_vg``), the value
brought to the host, then one step of ``train``'s default optimizer
(``train._adam``) along the gradient (``train._ascend``). Set-up builds the
model, the gradient function and the optimizer once, and drives that one
object through ``checked_steps`` iterations from the configuration's hypers
(``randinit=False``); their values, the optimizer's state after the first
and the hypers after the last are what the reference follows. The same
object then runs the window: iterations until ``seconds`` have passed,
``train_step_s`` the window over its whole iterations. ``train`` ends with
a refit, which stays out of the window. A traced run counts the blocked
kernel's launches of one light fit first, then profiles
``traced_iterations`` iterations after the first of the window.
"""
from __future__ import annotations

import importlib
import time

import numpy as np

from benchmark import harness


def run(run):
    from deepstructuredmixtures_tpu_torch import fit
    from deepstructuredmixtures_tpu_torch.ops import build, potrf

    # the package attribute ``train`` is the function; the module by name
    trainlib = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    cfg, tr, rec = run.cfg, run.traffic, run.rec
    if run.device != "cpu":
        build.build()
    x, y = harness.make_data(cfg, run.seed)
    with rec.span("build"):
        model = harness.build_model(cfg, x, y, run.device)
    run.work = harness.work_of(model)
    if run.traced:
        b0 = potrf.LAUNCHES
        fit.bucketed_leaf_mlls(model.layout, model.theta, model.bucket_batches,
                               model.bucket_spec.leaf_ids, model.num_leaves)
        run.sync()
        rec.counters["blocked_launches_per_fit"] = potrf.LAUNCHES - b0

    vg = trainlib._train_vg(model)
    theta = model.theta.detach().clone().requires_grad_(True)
    opt = trainlib._adam([theta])
    theta0 = _host(theta)

    def step():
        val, g = vg(theta)
        value = float(val)
        trainlib._ascend(opt, theta, g)
        return value

    values, first_state = [], None
    for s in range(tr["checked_steps"]):
        values.append(step())
        if s == 0:
            # an optimizer that took no step holds no state: it got nothing
            m = opt.state.get(theta, {}).get("exp_avg")
            first_state = np.zeros(theta.shape) if m is None else _host(m)
    theta_k = _host(theta)
    run.mark_setup()

    n, bad, window = harness.timed_window(
        run, lambda: bool(np.isfinite(step())), tr["traced_iterations"],
        lambda: {"blocked_launches": potrf.LAUNCHES}, "iteration")
    run.attempted, run.failed = n, bad
    run.e2e["train_step_s"] = window / n
    run.read_memory_peak()
    beta1 = opt.param_groups[0]["betas"][0]
    run.outputs = {"x": x, "y": y, "values": np.array(values),
                   # the optimizer descends -grad: its first moment after one
                   # step is (1 - beta1) times what it was given
                   "first_grad": first_state / (1.0 - beta1),
                   "theta0": theta0, "theta_k": theta_k,
                   "leaf_n": np.array(run.work["leaf_n"])}
    del model, vg, theta, opt
    run.free_device()


def _host(t):
    """A float64 copy of ``t`` on the host: the optimizer updates its
    tensors in place, and a float64 tensor on the CPU would otherwise be
    shared, not copied."""
    return t.detach().double().cpu().numpy().copy()
