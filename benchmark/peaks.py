"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of every roofline
and utilization share. The card's power limit is printed beside each run
(``device.power_limit``); a card set below 700 W reads lower shares."""

#: float32 FMA outside the tensor cores (the port turns TF32 off); the
#: float64 tensor-core rate is the same 67 TFLOP/s
FLOPS_F32 = 67e12
#: HBM3 bandwidth
BYTES_PER_S = 3.35e12


def bound_s(flops, nbytes):
    """The least time of the card for ``flops`` operations moving
    ``nbytes``: the larger of the two bounds."""
    return max(flops / FLOPS_F32, nbytes / BYTES_PER_S)
