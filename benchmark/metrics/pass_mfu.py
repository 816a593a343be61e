"""``pass_mfu`` (%): the whole pass's model operations over its time, as a
share of the card's float32 peak (``peaks.py``).

Model operations at the true leaf sizes n and routed test points t (the
port's ``bench.model_flops`` definition, padding excluded): per leaf the
training gram 2n²D, the Cholesky n³/3, the forward solve of ``[y | K_nt]``
n² per right-hand side, n²(t + 1) (the repo's copy counts 2n² per column;
a triangular solve is n²/2 multiply-adds), the cross gram 2ntD and the
moments' reductions 4nt. The time is the mean of the traced run's passes
that ran outside the profiler. Moves ``pass_s``."""

from benchmark import peaks


def model_flops(work):
    D = float(work["dim"])
    total = 0.0
    for n, t in zip(work["leaf_n"], work["routed"]):
        n, t = float(n), float(t)
        total += 2 * n * n * D + n ** 3 / 3 + n * n * (t + 1) + 2 * n * t * D + 4 * n * t
    return total


def read(run):
    spans = run.rec.spans.get("pass")
    if not spans or "routed" not in run.work:
        return None
    return 100.0 * model_flops(run.work) / (sum(spans) / len(spans)) / peaks.FLOPS_F32
