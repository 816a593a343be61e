"""Device idle share (%) of the traced stretch: ``1 - busy / wall``, with
busy the union of the device kernels' intervals in the profiler's trace and
wall the stretch's length on the host clock. Moves the cell's end-to-end
metric."""

from benchmark import tracing


def read(run):
    return tracing.idle_share(run)
