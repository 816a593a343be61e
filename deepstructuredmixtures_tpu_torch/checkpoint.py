"""Checkpoints in the JAX package's ``.npz`` format (counterpart of the npz
half of ``deepstructuredmixtures_tpu/checkpoint.py``).

A file holds the tree specification (leaf observation sets, boxes, split
structure, sum weights), the kernel specs, the flat hyper vector (tied or
per-leaf), the sum-edge log-weights and the raw data. Loading rebuilds the
plan from the stored tree, with no random numbers involved. A model saved
by ``deepstructuredmixtures_tpu.checkpoint.save`` loads here and predicts
the same, and a file saved here loads in the JAX package: this is how
weights cross between the two. This module imports no JAX.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .hyper import make_layout
from .kernels import KernelSpec
from .plan import build_schedule, compile_tree
from .tree import LeafNode, SplitNode, SumNode

_TORCH_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def _tree_to_spec(node):
    if isinstance(node, LeafNode):
        return {"t": "leaf", "obs": node.obs.tolist(), "lb": node.lb.tolist(),
                "ub": node.ub.tolist(), "kernelid": int(node.kernelid),
                "mean": float(node.mean)}
    if isinstance(node, SplitNode):
        return {"t": "split", "dim": int(node.dim),
                "thresholds": [float(t) for t in node.thresholds],
                "lb": node.lb.tolist(), "ub": node.ub.tolist(),
                "children": [_tree_to_spec(c) for c in node.children]}
    return {"t": "sum", "logweights": np.asarray(node.logweights).tolist(),
            "is_leaf_sum": bool(node.is_leaf_sum),
            "children": [_tree_to_spec(c) for c in node.children]}


def _spec_to_tree(spec):
    if spec["t"] == "leaf":
        return LeafNode(obs=np.asarray(spec["obs"], dtype=np.int64),
                        lb=np.asarray(spec["lb"], dtype=np.float64),
                        ub=np.asarray(spec["ub"], dtype=np.float64),
                        kernelid=spec["kernelid"], mean=spec["mean"])
    children = [_spec_to_tree(c) for c in spec["children"]]
    if spec["t"] == "split":
        return SplitNode(children=children, dim=spec["dim"],
                         thresholds=list(spec["thresholds"]),
                         lb=np.asarray(spec["lb"], dtype=np.float64),
                         ub=np.asarray(spec["ub"], dtype=np.float64))
    return SumNode(children=children,
                   logweights=np.asarray(spec["logweights"], dtype=np.float64),
                   is_leaf_sum=spec["is_leaf_sum"])


def _kernel_specs(model):
    """Kernel specs from the model's layout and current hypers (leaf 0's
    row under per-leaf hypers), as the JAX package stores them."""
    theta = model.theta.cpu().numpy()
    tied = theta if theta.ndim == 1 else theta[0]
    specs = []
    for k, kind in enumerate(model.layout.kinds):
        off, nl = model.layout.blocks[k]
        specs.append(KernelSpec(kind, tuple(tied[off:off + nl].tolist()),
                                float(tied[off + nl])))
    return specs


def save(model, path: str):
    """Write ``model`` (any model class) to ``path`` in the JAX package's
    npz format, ``overlap`` true when the model has the overlap
    analysis."""
    meta = {
        "class": type(model).__name__,
        "tree": _tree_to_spec(model.root),
        "kernels": [{"kind": k.kind, "logl": list(k.logl),
                     "logsigma": k.logsigma} for k in _kernel_specs(model)],
        "dtype": str(model.dtype).replace("torch.", ""),
        "overlap": model.plan.overlap is not None,
        "pad_multiple": int(model.plan.pad_multiple),
    }
    np.savez_compressed(path, meta=json.dumps(meta), X=np.asarray(model.X),
                        y=np.asarray(model.y),
                        theta=model.theta.cpu().numpy(),
                        logweights=model.logweights.cpu().numpy())


def load(path: str, *, device, dtype=None):
    """Restore a model saved by :func:`save` or by the JAX package's
    ``checkpoint.save`` onto ``device``, unfitted (the first ``fit`` or
    ``predict`` fits it). ``dtype`` defaults to the stored one. The plan
    keeps the stored ``pad_multiple``, and the overlap analysis and the
    shared schedule are built when the file's ``overlap`` is true (the
    default of a file without it), as in the JAX package. The log-weights
    are kept in float64, the dtype of the port's combine."""
    from . import models as modelslib

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    root = _spec_to_tree(meta["tree"])
    kernels = tuple(KernelSpec(k["kind"], tuple(k["logl"]), k["logsigma"])
                    for k in meta["kernels"])
    dtype = dtype or _TORCH_DTYPE[meta["dtype"]]
    X = np.asarray(data["X"])
    y = np.asarray(data["y"])
    overlap = bool(meta.get("overlap", True))
    plan = compile_tree(root, X, overlap=overlap,
                        pad_multiple=int(meta.get("pad_multiple", 8)))
    cls = getattr(modelslib, meta["class"])
    model = cls(root, plan, make_layout(kernels), np.asarray(data["theta"]),
                dtype, device, X, y,
                schedule=build_schedule(plan) if overlap else None)
    model.logweights = torch.as_tensor(
        np.asarray(data["logweights"], dtype=np.float64), device=model.device)
    return model
