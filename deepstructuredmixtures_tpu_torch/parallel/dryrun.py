"""Multi-rank dry run of the parallel surface, each piece against one
device (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m deepstructuredmixtures_tpu_torch.parallel.dryrun --nproc 4 [--device cuda|cpu]

spawns ``--nproc`` gloo ranks (a file store in a temporary directory) that
build the same toy models from the same seeds and run: one sharded
training step, a sharded fit, the sharded per-bucket training gradient, a
sharded routed predict, the sharded streamed predict, ``finetune(mesh=)``
and ``fit(mesh=)`` with the largest leaves on the distributed Cholesky.
Every result is held to the same call on one device in the same rank:
1e-3 in float32 on the card (``--device cuda``, the default; the ranks
share ``cuda:0`` when there is one card), 1e-8 in float64 with ``--device
cpu``. Exits non-zero without a card (unless ``--device cpu``), if a gate
fails or a rank dies.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _toy_model(device, n=200, v=2, k=3, seed=0, M=20):
    import deepstructuredmixtures_tpu_torch as tdsm

    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, n)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0.0, 0.2, n)
    return tdsm.build_dsmgp(x, y, V=v, K=k, M=M, kernel=tdsm.IsoSE(0.0, 0.0),
                            log_noise=-1.0, seed=seed, do_fit=False,
                            device=device)


def _err(*pairs) -> float:
    """Max abs difference over the pairs (tensors, arrays or floats), in
    float64 on the host."""
    def f64(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    return max(float((f64(a) - f64(b)).abs().max()) for a, b in pairs)


def check(mesh, device) -> dict:
    """Run every check on this rank (all ranks call it alike), on
    ``device`` (``"cuda"`` or ``"cpu"``); returns
    ``{check: max abs error against one device}`` and raises
    ``AssertionError`` past the gate."""
    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch import fit as fitlib

    from .mesh import (make_sharded_routed_predict, make_sharded_train_step,
                       make_sharded_value_and_grad_bucketed,
                       sharded_bucketed_streamed_predict, sharded_fit)

    # the module (the package attribute ``train`` is the function)
    trainlib = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    model = _toy_model(device, n=160, v=2, k=2, seed=1)
    tol = 1e-8 if model.dtype == torch.float64 else 1e-3
    layout, plan, L = model.layout, model.plan, model.num_leaves
    buckets = (layout, plan, model.bucket_batches, model.bucket_spec.leaf_ids)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    errs = {}

    # one sharded training step against the same step on one device
    step, init, _ = make_sharded_train_step(layout, plan, model.batch, mesh,
                                            adam)
    val, theta1, _ = step(model.theta, init(model.theta))
    p = model.theta.detach().clone().requires_grad_(True)
    opt = adam([p])
    val_l, g = trainlib._value_and_grad(
        trainlib.make_mll_fn(layout, plan, model.batch))(p)
    trainlib._ascend(opt, p, g)
    errs["train_step"] = _err((val, val_l), (theta1, p.detach()))

    # sharded fit: this rank's leaves against the same leaves of one fit
    post = sharded_fit(layout, model.theta, model.batch, mesh)
    whole = fitlib.fit_batched(layout, model.theta, model.batch)
    ndev, me = mesh.size(), mesh.get_local_rank()
    r = post.mll.shape[0]
    lo, hi = me * r, min((me + 1) * r, L)
    errs["sharded_fit"] = _err((post.mll[:max(hi - lo, 0)], whole.mll[lo:hi]))

    # the chunked per-bucket training gradient
    v_s, g_s = make_sharded_value_and_grad_bucketed(*buckets, mesh, chunk=1)(
        model.theta)
    v_l, g_l = trainlib.make_value_and_grad_bucketed(*buckets)(model.theta)
    errs["bucketed_grad"] = _err((v_s, v_l), (g_s, g_l))

    # routed predict: fit + update + moment match against the model's own
    xt = np.linspace(-0.05, 1.05, 33).reshape(-1, 1)
    tidx, tmask = model._route(xt)
    f, prepare = make_sharded_routed_predict(layout, plan, model.batch, mesh)
    xt_d = torch.as_tensor(xt, dtype=model.dtype, device=model.device)
    z_s, mean_s, var_s = f(model.theta, xt_d, *prepare(tidx, tmask))
    model.fit(method="batched", store="full")
    z_l = model.update()
    mean_l, var_l = model.predict(xt)
    errs["routed_predict"] = _err((z_s, z_l), (mean_s, mean_l), (var_s, var_l))

    # the streamed path, sharded, against the local one
    ti = torch.as_tensor(tidx, dtype=torch.long, device=model.device)
    args = (layout, model.theta, model.bucket_batches,
            model.bucket_spec.leaf_ids, L, xt_d, ti)
    errs["streamed_predict"] = _err(*zip(
        sharded_bucketed_streamed_predict(*args, mesh=mesh),
        fitlib.bucketed_streamed_predict(*args)))

    # finetune(mesh=): two candidate-sharded iterations
    m1 = _toy_model(device, n=160, v=2, k=2, seed=3)
    m2 = _toy_model(device, n=160, v=2, k=2, seed=3)
    h1 = tdsm.finetune(m1, adam, iterations=2, lam=1e-9, bucketed=True,
                       progress=False)
    h2 = tdsm.finetune(m2, adam, iterations=2, lam=1e-9, mesh=mesh,
                       progress=False)
    errs["finetune"] = _err((h1, h2), (m1.theta, m2.theta))

    # fit(mesh=): the largest leaf on the distributed Cholesky (12 leaves in
    # two size buckets, one in the larger)
    m3 = _toy_model(device, n=320, v=2, k=2, seed=4, M=60)
    m4 = _toy_model(device, n=320, v=2, k=2, seed=4, M=60)
    gb = max(b.nmax for b in m3.bucket_batches) ** 2 * m3.dtype.itemsize - 1
    m3.fit(mesh=mesh, giant_leaf_bytes=gb, block=64)
    if not m3._giant:
        raise AssertionError("no leaf routed to the distributed Cholesky")
    m4.fit(method="batched")
    z3, z4 = m3.update(), m4.update()
    errs["giant_fit"] = _err((z3, z4), *zip(m3.predict(xt), m4.predict(xt)))

    bad = {k: v for k, v in errs.items() if not v <= tol}
    if bad:
        raise AssertionError(f"dry run on {ndev} ranks past {tol:g}: {bad}")
    return errs


def _rank(rank, world, store, device):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        from .comm import make_mesh

        errs = check(make_mesh(world), device)
        if rank == 0:
            print(f"dryrun OK: {world} ranks, {device}, gate "
                  f"{1e-8 if device == 'cpu' else 1e-3:g}: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()),
                  flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.spawn(
            _rank, args=(a.nproc, os.path.join(tmp, "store"), a.device),
            nprocs=a.nproc)


if __name__ == "__main__":
    main()
