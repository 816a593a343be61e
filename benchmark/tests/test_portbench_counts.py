"""The per-layer readers' operation and byte counts against hand counts,
and the trace reductions on a made-up trace."""
from __future__ import annotations

import types

import pytest

from benchmark import harness, peaks, tracing

WORK = {"dim": 1, "leaf_n": [2, 3, 1100], "routed": [1, 0, 4],
        "buckets": [{"nmax": 128, "n": [2, 3]}, {"nmax": 1104, "n": [1100]}]}


def _run(kernels=(), counters=None, spans=None, units=1, window=1.0):
    trace = {"kernels": list(kernels), "units": units, "window_s": window,
             "busy_s": tracing.union_s([(s, t) for _, s, t in kernels])}
    rec = types.SimpleNamespace(counters=counters or {}, spans=spans or {})
    return types.SimpleNamespace(trace=trace, rec=rec, work=WORK)


def test_pass_model_flops_by_hand():
    mfu = harness.load_reader("pass_mfu")
    # leaf n=2, t=1: 2*4 + 8/3 + 4*2 + 2*2 + 8; n=3, t=0: 18 + 9 + 9
    # n=1100, t=4: 2*1100^2 + 1100^3/3 + 1100^2*5 + 2*1100*4 + 4*1100*4
    want = (8 + 8 / 3 + 8 + 4 + 8) + (18 + 9 + 9) + (
        2 * 1100**2 + 1100**3 / 3 + 5 * 1100**2 + 8800 + 17600)
    assert mfu.model_flops(WORK) == pytest.approx(want, rel=1e-12)
    run = _run(spans={"pass": [0.5, 1.5]})
    assert mfu.read(run) == pytest.approx(100 * want / 1.0 / peaks.FLOPS_F32)


def test_train_model_flops_by_hand():
    mfu = harness.load_reader("train_mfu")
    want = sum(n**3 + 11 * n**2 for n in (2, 3, 1100))
    assert mfu.model_flops(WORK) == pytest.approx(want, rel=1e-12)


def test_blocked_counts_only_its_domain():
    r = harness.load_reader("blocked_chol_roofline.pass")
    flops, nbytes = r.counts(WORK["buckets"])
    assert flops == pytest.approx(1100**3 / 3) and nbytes == 8 * 1100**2
    # 1 ms of the kernel on two overlapping streams: the union, not the sum
    run = _run([("panel_kernel", 0, 600), ("trailing_update_kernel", 100, 1000)],
               counters={"blocked_launches": 1}, units=2)
    want = 100 * peaks.bound_s(2 * flops, 2 * nbytes) / 1e-3
    assert r.read(run) == pytest.approx(want)
    assert r.read(_run(counters={"blocked_launches": 0})) is None


def test_blocked_train_counts_factorizations_per_leaf():
    r = harness.load_reader("blocked_chol_roofline.train")
    run = _run([("diag_inv_kernel", 0, 1000)],
               counters={"blocked_launches": 6, "blocked_launches_per_fit": 3})
    flops, nbytes = 2 * 1100**3 / 3, 2 * 8 * 1100**2
    assert r.read(run) == pytest.approx(100 * peaks.bound_s(flops, nbytes) / 1e-3)


def test_trace_groups_union_and_idle():
    kernels = [("void trsm_left_kernel", 0, 100), ("elementwise_copy", 150, 250),
               ("sgemm_128x64", 200, 300), ("panel_kernel", 400, 500)]
    run = _run(kernels, window=1e-3, units=2)
    assert tracing.group("void trsm_left_kernel") == "triangular_solves"
    assert tracing.group("elementwise_copy") == "other"
    assert run.trace["busy_s"] == pytest.approx(350e-6)
    idle = harness.load_reader("device_idle.pass").read(run)
    assert idle == pytest.approx(65.0)
    solve = harness.load_reader("solve_ms.serve").read(run)
    assert solve == pytest.approx(0.05)
    other = harness.load_reader("elementwise_ms.pass").read(run)
    assert other == pytest.approx(0.05)
    b = tracing.breakdown(kernels, [(0, 1000, "outer"), (300, 400, "aten::copy_")])
    assert b["idle_gaps"][0] == ["aten::copy_", 100e-6]
    assert b["device_ops"][0][1] == pytest.approx(100e-6)
