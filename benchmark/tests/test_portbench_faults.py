"""Runs whose timed path is broken underneath come out not correct: each
fault the cell can have, planted in the program for one small run on the
CPU (the harness's look for a card skipped), judged by the cell's own
limits. One card, so no cell has an exchange between chips to leave out."""
from __future__ import annotations

import importlib

import pytest
import torch

from portbench_small import run_small

fit = importlib.import_module("deepstructuredmixtures_tpu_torch.fit")
serve = importlib.import_module("deepstructuredmixtures_tpu_torch.serve")
train = importlib.import_module("deepstructuredmixtures_tpu_torch.train")


def _half_mean(t):
    """The second half of the leading axis left out, the mean over the
    first half in its place."""
    h = t.shape[0] - t.shape[0] // 2
    out = t.clone()
    out[h:] = t[:h].mean(dim=0)
    return out


def pass_answer_altered(monkeypatch):
    real = fit.bucketed_streamed_predict

    def wrong(*a, **k):
        mu, var, mll = real(*a, **k)
        mu = mu.clone()
        mu[0] += 0.05  # one leaf's routed means, where they are produced
        return mu, var, mll

    monkeypatch.setattr(fit, "bucketed_streamed_predict", wrong)


def pass_half_left_out(monkeypatch):
    real = fit.streamed_leaf_predict

    def half(*a, **k):
        return tuple(_half_mean(t) for t in real(*a, **k))

    monkeypatch.setattr(fit, "streamed_leaf_predict", half)


def serve_answer_altered(monkeypatch):
    real = serve.Predictor._predict

    def wrong(self, x, return_var):
        mean, var = real(self, x, return_var)
        mean = mean.copy()
        mean[0] += 0.05
        return mean, var

    monkeypatch.setattr(serve.Predictor, "_predict", wrong)


def serve_half_left_out(monkeypatch):
    real = serve.Predictor._predict

    def half(self, x, return_var):
        h = x.shape[0] - x.shape[0] // 2
        mean, var = real(self, x[:h], return_var)
        fill = lambda a: a if a is None else __import__("numpy").concatenate(  # noqa: E731
            [a, __import__("numpy").full(x.shape[0] - h, a.mean())])
        return fill(mean), fill(var)

    monkeypatch.setattr(serve.Predictor, "_predict", half)


def train_state_unchanged(monkeypatch):
    monkeypatch.setattr(train, "_ascend", lambda opt, param, g: None)


def train_half_left_out(monkeypatch):
    real = train._chunk_leaf_mll

    def half(layout, theta, batch):
        m = real(layout, theta, batch)
        h = m.shape[0] - m.shape[0] // 2
        return torch.cat([m[:h], m[:h].mean().expand(m.shape[0] - h)])

    monkeypatch.setattr(train, "_chunk_leaf_mll", half)


FAULTS = [("d2_n100k_pass", pass_answer_altered), ("d2_n100k_pass", pass_half_left_out),
          ("d2_n100k_serve", serve_answer_altered), ("d2_n100k_serve", serve_half_left_out),
          ("d2_n100k_train", train_state_unchanged), ("d2_n100k_train", train_half_left_out)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, numbers, _ = run_small(cell)
    assert result["correct"] is False, numbers
