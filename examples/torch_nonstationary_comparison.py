"""The paper's toy benchmark on the PyTorch / CUDA port: DSMGP against
PoE, gPoE and rBCM on the nonstationary heteroscedastic dataset (reference
``datasets.jl:5-27``), scored with the reference metrics
(``scorefunctions.jl``).

Run: ``python examples/torch_nonstationary_comparison.py [--device
cuda|cpu] [--iterations 100]``.
"""
import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import deepstructuredmixtures_tpu_torch as tdsm


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iterations", type=int, default=100)
    args = ap.parse_args(argv)

    x, y, _noise = tdsm.nonstationary(1500, seed=0)
    x = np.asarray(x).reshape(-1, 1)
    y = np.asarray(y)
    itr = np.arange(0, len(y), 2)
    ite = np.arange(1, len(y), 2)
    kw = dict(K=4, M=40, log_noise=-1.0, seed=1, device=args.device)
    kern = functools.partial(tdsm.IsoSE, -1.0, 0.0)
    models = {
        "DSMGP": tdsm.build_dsmgp(x[itr], y[itr], V=3, kernel=kern(), **kw),
        "PoE": tdsm.build_poe(x[itr], y[itr], kernel=kern(), **kw),
        "gPoE": tdsm.build_poe(x[itr], y[itr], generalized=True, kernel=kern(),
                               **kw),
        "rBCM": tdsm.build_bcm(x[itr], y[itr], kernel=kern(), **kw),
    }

    print(f"{'model':>6s} {'RMSE':>8s} {'MAE':>8s} {'NLPD':>8s}")
    for name, m in models.items():
        if name == "DSMGP":
            tdsm.train(m, functools.partial(torch.optim.Adam, lr=1e-3),
                       iterations=args.iterations, lam=1e-3, randinit=False,
                       progress=False)
            m.update()
        mu, var = (a.cpu().numpy() for a in m.predict(x[ite]))
        rmse = float(np.sqrt(tdsm.mse(y[ite], mu)))
        mae = float(tdsm.mae(y[ite], mu))
        nlpd = float(tdsm.nlpd(y[ite], mu, var))
        print(f"{name:>6s} {rmse:8.4f} {mae:8.4f} {nlpd:8.4f}")


if __name__ == "__main__":
    main()
