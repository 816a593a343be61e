"""Expensive test references, computed once per test session.

Under pytest-xdist every worker that runs a test of a module builds that
module's ``scope="module"`` fixtures again (with ``--dist load`` a module's
tests spread over several workers, and a worker may meet the same module
twice). :func:`once` computes a reference on the first worker that asks
for it and shares it with the others through a file under the session's
shared temporary directory, guarded by a lock: the pattern of
pytest-xdist's documentation ("Making session-scoped fixtures execute
only once").
"""
import os

import numpy as np
from filelock import FileLock


def once(tmp_path_factory, name: str, compute):
    """``compute()``, a dict of arrays (numbers and strings become 0-d
    arrays), computed once per test session under ``name``: the first
    worker computes it and writes ``<name>.npz`` beside the workers'
    temporary directories; the others wait on its lock and read it. Run
    without workers, it is computed (``getbasetemp().parent`` is then
    shared by every session)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return {k: np.asarray(v) for k, v in compute().items()}
    path = tmp_path_factory.getbasetemp().parent / f"{name}.npz"
    with FileLock(f"{path}.lock"):
        if not path.is_file():
            out = {k: np.asarray(v) for k, v in compute().items()}
            tmp = path.with_name(f"{name}.part.npz")
            np.savez(tmp, **out)
            tmp.rename(path)
            return out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
