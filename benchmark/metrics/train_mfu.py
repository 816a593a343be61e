"""``train_mfu`` (%): a training iteration's model operations over its
time, as a share of the card's peak (67 TFLOP/s in float32 FMA, and the
same in float64 on the tensor cores, where the program runs the
backward).

Model operations per leaf at its true size n, for the value and the
gradient of the root mll in the three hypers (what the objective needs;
the program's second factorization of each leaf, to rebuild the graph, is
not counted):

* the gram, 2n²D (as ``pass_mfu`` counts it);
* the Cholesky, n³/3;
* the forward solve of the centred targets, n²; the backward solve for
  α = K⁻¹y, n²;
* the inverse K⁻¹ from the factor, 2n³/3 (L⁻¹, n³/3, and L⁻ᵀL⁻¹, n³/3);
* the gradient's contraction ½ Σ (ααᵀ − K⁻¹) ∘ ∂K/∂θ over the three hypers:
  ααᵀ n², and per hyper a product and a sum per element, 6n².

The Adam step on three numbers is nothing beside these. The time is the
mean of the traced run's iterations outside the profiler. Moves
``train_step_s``."""

from benchmark import peaks


def model_flops(work):
    D = float(work["dim"])
    return sum(float(n) ** 3 + (2 * D + 9) * float(n) ** 2 for n in work["leaf_n"])


def read(run):
    spans = run.rec.spans.get("iteration")
    if not spans:
        return None
    return 100.0 * model_flops(run.work) / (sum(spans) / len(spans)) / peaks.FLOPS_F32
