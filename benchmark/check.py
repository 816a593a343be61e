"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference under ``reference/``, worked out again from
the raw data after the window has closed and the program's state is freed.

Each kind of traffic yields its numbers; each cell's file under
``limits/`` says which of them are judged and each one's limit, and
:func:`judge` holds them to it. A number that is not finite fails.

* ``pass``: the partition (leaves whose size differs from the reference's,
  limit 0), the leaf mlls (``mll_rel``: the largest gap over ``max(1,
  |mll|)``), the log evidence (``evidence_rel``), the posterior sum-edge
  weights (``weight_abs``), each leaf's moments at its routed test points
  (``leaf_mean_abs``, ``leaf_var_rel``; infinite if the routing differs)
  and the mixture's moments at the test points (``mean_abs``; ``var_rel``,
  relative to the reference's variance).
* ``serve``: the partition, and the moments the clients got, for a sample
  of the completed requests drawn from the seed.
* ``train``: the partition; each checked step's root mll (``loss_rel``);
  the norm of the first gradient as the optimizer got it against the
  reference's (``grad_gap``); the norm of the hypers' change after the
  checked steps (``change_gap``), both relative to the reference's norm.
  The hyper vector is the one leaf, so the worst leaf is that one.

The control (:func:`control_numbers`) puts the reference computed one
step below the program's float32 with TF32 off in the program's place:
float32 with TF32 allowed, and in training the grams formed by inner
products taken in TF32 (the pass's grams are elementwise, so there it is
plain float32). It reads the same numbers against the float64 reference.
"""
from __future__ import annotations

import sys

import numpy as np

from benchmark import harness


def _rel(a, b, floor=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    d = np.abs(a - b) / np.maximum(np.abs(b), floor)
    return float(np.max(d)) if d.size else 0.0


def _abs(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _norm_gap(a, b):
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    return abs(na - nb) / nb if nb > 0 else float("inf")


def numbers(kind, out, ref):
    """The numbers of ``out`` against ``ref``, two results of one kind."""
    if kind == "pass":
        same = (out["leaf_points"].shape == ref["leaf_points"].shape
                and np.array_equal(out["leaf_points"], ref["leaf_points"]))
        return {"mll_rel": _rel(out["mll"], ref["mll"], 1.0),
                "evidence_rel": _rel(out["z"], ref["z"]),
                "weight_abs": _abs(out["weights"], ref["weights"]),
                "leaf_mean_abs": _abs(out["leaf_mean"], ref["leaf_mean"]) if same
                else float("inf"),
                "leaf_var_rel": _rel(out["leaf_var"], ref["leaf_var"]) if same
                else float("inf"),
                "mean_abs": _abs(out["mean"], ref["mean"]),
                "var_rel": _rel(out["var"], ref["var"])}
    if kind == "serve":
        return {"mean_abs": _abs(out["mean"], ref["mean"]),
                "var_rel": _rel(out["var"], ref["var"])}
    if kind == "train":
        return {"loss_rel": _rel(out["values"], ref["values"]),
                "grad_gap": _norm_gap(out["first_grad"], ref["first_grad"]),
                "change_gap": _norm_gap(out["theta_k"] - out["theta0"],
                                        ref["theta_k"] - ref["theta0"])}
    raise ValueError(f"no comparison for traffic kind {kind!r}")


class Reference:
    """The reference for one run: its own tree over the run's raw data,
    and what it computes for the run's traffic in a given precision."""

    def __init__(self, run):
        import torch

        self.run = run
        self.mod = harness.load_reference(run.cfg)
        out = run.outputs
        self.model = self.mod.Model(out["x"], out["y"], run.cfg)
        self.hyp = harness.hypers(run.cfg)
        self.device = torch.device("cpu" if run.device == "cpu" else "cuda")
        n_prog = np.asarray(out["leaf_n"])
        sizes = self.model.sizes
        self.partition = float(abs(len(n_prog) - len(sizes)) if len(n_prog) != len(sizes)
                               else np.sum(n_prog != sizes))
        self._cache = {}

    def program(self):
        """The program's results in the reference's shape."""
        out, kind = self.run.outputs, self.run.traffic["kind"]
        if kind == "serve":
            reqs = [out["requests"][i] for i in self.picked()]
            return {"mean": np.concatenate([r[1] for r in reqs]),
                    "var": np.concatenate([r[2] for r in reqs])}
        return out

    def picked(self):
        """The completed requests compared, drawn from the seed."""
        reqs = self.run.outputs["requests"]
        rng = np.random.default_rng([harness.seed_key(self.run.seed), 3])
        k = min(self.run.traffic["checked_requests"], len(reqs))
        return np.sort(rng.choice(len(reqs), size=k, replace=False)) if k else []

    def results(self, dtype, half=False):
        """The reference's results in ``dtype``; ``half`` plants the fault
        of a training objective that leaves out half of the leaves and puts
        their mean over the rest in their place."""
        key = (dtype, half)
        if key in self._cache:
            return self._cache[key]
        kind, out, tr = self.run.traffic["kind"], self.run.outputs, self.run.traffic
        if kind == "pass":
            res = self.model.predict(self.hyp, out["xt"], dtype, self.device)
        elif kind == "serve":
            xq = np.concatenate([out["requests"][i][0] for i in self.picked()])
            res = self.model.predict(self.hyp, xq, dtype, self.device)
        elif kind == "train":
            vals, grads, thetas = self.mod.adam_ascent(
                lambda th: self.model.value_and_grad(th, dtype, self.device, half=half),
                self.hyp, len(out["values"]), tr["lr"], tuple(tr["betas"]), tr["eps"])
            res = {"values": np.array(vals), "first_grad": grads[0],
                   "theta_k": thetas[-1], "theta0": self.hyp}
        else:
            raise ValueError(f"no reference for traffic kind {kind!r}")
        self._cache[key] = res
        return res


def compare(run):
    """Every number of ``run``'s outputs against the float64 reference;
    keeps the reference on ``run.reference`` for the control."""
    import torch

    ref = Reference(run)
    run.reference = ref
    nums = {"partition": ref.partition}
    if ref.partition:
        return nums
    if run.traffic["kind"] == "serve" and not len(ref.picked()):
        return nums
    nums.update(numbers(run.traffic["kind"], ref.program(),
                        ref.results(torch.float64)))
    return nums


def control_numbers(run, half=False):
    """The same numbers with the control in the program's place: the
    reference computed in float32 with TF32 (or, with ``half``, the float64
    reference with half of its leaves left out)."""
    import torch

    ref = run.reference
    kind = run.traffic["kind"]
    base = ref.results(torch.float64)
    other = ref.results(torch.float64, half=True) if half else ref.results(torch.float32)
    return dict({"partition": 0.0}, **numbers(kind, other, base))


def judge(numbers, limits):
    """``{"correct", "checks"}``: every number the cell's limits name, with
    its value (None if it was not reached or not finite) and limit; correct
    if each is finite and within its limit."""
    checks, ok = {}, True
    for name, spec in limits["numbers"].items():
        v = numbers.get(name)
        good = v is not None and bool(np.isfinite(v)) and v <= spec["limit"]
        ok = ok and good
        checks[name] = {"value": float(v) if good or (v is not None and np.isfinite(v))
                        else None, "limit": spec["limit"]}
    return {"correct": ok, "checks": checks}


def print_checks(checks, stream=sys.stderr):
    for name, c in checks.items():
        print(f"check {name} = {c['value']} limit {c['limit']}", file=stream)
