"""The reference README workflow on the PyTorch / CUDA port: build a DSMGP
on a noisy sine, train tied hypers, exact posterior update, predict beyond
the data, and plot.

Run: ``python examples/torch_readme_workflow.py [--device cuda|cpu]
[--iterations 200]`` (writes dsmgp_torch_readme.png where matplotlib is
installed).
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
    ap.add_argument("--iterations", type=int, default=200)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    xtrain = np.linspace(0, 1, 100)
    ytrain = np.sin(xtrain * 4 * np.pi) + rng.normal(0, 0.2, 100)
    model = tdsm.build_dsmgp(
        xtrain.reshape(-1, 1), ytrain, V=3, K=4, M=10,
        kernel=tdsm.IsoSE(1.0, 1.0),
        mean_fun=tdsm.ConstMean(float(ytrain.mean())), seed=0,
        device=args.device)
    hist = tdsm.train(model, functools.partial(torch.optim.Adam, lr=1e-3),
                      iterations=args.iterations, lam=1e-3, progress=False)
    z = model.update()
    print(f"trained {len(hist)} iters, final mll {hist[-1]:.3f}, "
          f"log-evidence {z:.3f}")

    xtest = np.linspace(-0.2, 1.2, 200).reshape(-1, 1)
    m, s = model.predict(xtest)
    print(f"predictive mean range [{float(m.min()):.2f}, {float(m.max()):.2f}]")

    try:
        from deepstructuredmixtures_tpu_torch.plotting import plot_model

        path = os.path.join(os.path.dirname(__file__), "dsmgp_torch_readme.png")
        plot_model(model, show_splits=True, path=path)
        print(f"wrote {path}")
    except ImportError as e:  # matplotlib is optional
        print(f"plot skipped: {e}")


if __name__ == "__main__":
    main()
