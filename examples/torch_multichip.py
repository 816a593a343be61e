"""Multi-device DSMGP on the PyTorch / CUDA port: expert-parallel
training, the sharded fit and routed prediction, and one giant expert
row-sharded over every rank.

Run on N cards (NCCL): ``torchrun --nproc-per-node N
examples/torch_multichip.py``; on the CPU (gloo) without torchrun:
``python examples/torch_multichip.py --device cpu --nproc 4``, which
spawns the ranks itself. ``--device`` defaults to ``cuda``.

Every rank runs this same program (``parallel.make_mesh`` spans the
world); the hypers stay replicated and the leaves shard over the ranks.
"""
import argparse
import functools
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch
import torch.distributed as dist


def run(device, steps):
    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch import parallel

    mesh = parallel.make_mesh()
    rank, ndev = dist.get_rank(), dist.get_world_size()
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"{ndev} ranks, backend {dist.get_backend()}, device {device}")

    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 2000)).reshape(-1, 1)
    y = np.sin(x[:, 0] * 4 * np.pi) + 0.2 * rng.standard_normal(2000)
    model = tdsm.build_dsmgp(x, y, V=2, K=4, M=40, kernel=tdsm.IsoSE(0.0, 0.0),
                             log_noise=-1.0, seed=0, do_fit=False, device=device)
    say(f"{model.num_leaves} experts sharded over {ndev} ranks")

    # expert-parallel training: each rank factors its share of every bucket
    hist = tdsm.train(model, functools.partial(torch.optim.Adam, lr=5e-2),
                      iterations=steps, randinit=False, mesh=mesh,
                      progress=False)
    say(f"trained {len(hist)} steps, root mll = {hist[-1]:.3f}")

    # the sharded fit, the largest bucket's leaves on the distributed
    # Cholesky, then routed prediction
    nmax = max(b.nmax for b in model.bucket_batches)
    model.fit(mesh=mesh, giant_leaf_bytes=nmax * nmax * model.dtype.itemsize - 1,
              block=64)
    z = model.update()
    xt = np.linspace(-0.05, 1.05, 200).reshape(-1, 1)
    mean, var = model.predict(xt)
    say(f"log evidence = {z:.3f}; {model.last_fit_diagnostics['distributed_leaves']}"
        f" leaves distributed; mean range [{float(mean.min()):.2f}, "
        f"{float(mean.max()):.2f}]")

    # one giant expert across the whole mesh
    gp = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(-1.5, 0.0),
                              log_noise=-1.5, device=device).fit(mesh=mesh,
                                                                  block=64)
    _, v = gp.predict(xt)
    say(f"distributed giant-GP mll = {gp.mll():.3f}, mean predictive sd = "
        f"{float(v.sqrt().mean()):.3f}")


def _spawned(rank, world, store, device, steps):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        run(device, steps)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nproc", type=int, default=4,
                    help="ranks to spawn with --device cpu outside torchrun")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    if "RANK" in os.environ:  # started by torchrun
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
        try:
            run(args.device, args.steps)
        finally:
            dist.destroy_process_group()
    elif args.device == "cuda":
        raise SystemExit("start the ranks with torchrun --nproc-per-node N, "
                         "one per card (or pass --device cpu)")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(
                _spawned, args=(args.nproc, os.path.join(tmp, "store"),
                                args.device, args.steps), nprocs=args.nproc)


if __name__ == "__main__":
    main()
