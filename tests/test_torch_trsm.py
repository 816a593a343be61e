"""The predicts' float64 forward solve with its moments
(``ops/trsm.py``) on the CPU: the plain version and the rewired
``cached_leaf_predict``, ``bucketed_hybrid_predict`` and
``streamed_leaf_predict`` against the code they replaced (a float64 copy
of each factor, ``solve_triangular`` and an einsum per leaf chunk, copied
below), on a float32 tree of 8 leaves in 7 size buckets (523-1,584
points; four buckets above nmax 1024, where the streamed path is forced
onto the kernel's route); and the kernel's launch plan (leaf table,
ticket order, offsets, column tiles) run through a step-by-step replica
of the kernel's blocked algorithm."""
import numpy as np
import pytest
import scipy.linalg
import torch

import deepstructuredmixtures_tpu_torch as tdsm
from deepstructuredmixtures_tpu_torch import fit as tfit
from deepstructuredmixtures_tpu_torch.leafgp import (
    centered_y,
    leaf_gram,
    leaf_gram_diag,
    leaf_mll_forward,
    leaf_noise,
)
from deepstructuredmixtures_tpu_torch.ops import potrf, trsm

from .torch_threads import one_torch_thread  # noqa: F401

XT = torch.linspace(-0.05, 1.05, 24, dtype=torch.float32)[:, None]


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 4000))
    y = np.sin(6 * x) + 0.1 * rng.normal(size=4000)
    m = tdsm.build_dsmgp(x, y, V=2, K=3, M=30, depth=1, device="cpu", seed=1,
                         dtype=torch.float32, overlap=False, do_fit=False)
    assert [b.nmax for b in m.bucket_batches] == [640, 768, 1024, 1096, 1136, 1416, 1584]
    return m


@pytest.fixture(scope="module")
def factors(model):
    return [tfit.streamed_leaf_factors(model.layout, model.theta, b)[2]
            for b in model.bucket_batches]


@pytest.fixture(scope="module")
def routes(model):
    tidx, _ = model._route(XT.double().numpy())
    return torch.as_tensor(tidx, dtype=torch.long)


def _parent_moments(layout, theta, b, Lf, xt, float64=True):
    """``fit._moments`` before the kernel: with ``float64`` a float64 copy
    of the factor and of the right-hand side, else the batch's dtype."""
    Knt = torch.where(b.mask[:, :, None], leaf_gram(layout, theta, b, xt), 0.0)
    rhs = torch.cat([centered_y(b)[..., None], Knt], dim=-1)
    if float64:
        Lf, rhs = Lf.double(), rhs.double()
    Z = torch.linalg.solve_triangular(Lf, rhs, upper=False)
    z, V = Z[..., 0], Z[..., 1:]
    mu = b.mean[:, None] + torch.einsum("lnt,ln->lt", V, z)
    var = (leaf_gram_diag(layout, theta, b, xt) - torch.sum(V * V, dim=-2)
           + leaf_noise(layout, theta, b)[:, None])
    return mu.to(b.x.dtype), var.to(b.x.dtype), z


def _routed(xt, ti, s, e):
    return xt if ti is None else xt[ti[s:e]]


def _ulp(a, b):
    """Equal to one float32 rounding of the same float64 value: the solve
    is the same float64 arithmetic, batched over a bucket instead of a
    leaf chunk."""
    torch.testing.assert_close(a, b, rtol=2.4e-7, atol=1e-6)


def _case_plain(m, factors, ti):
    """The plain version on every bucket at once against the parent's
    per-leaf-chunk arithmetic: vz, vv and z at float64 rounding."""
    rhs, want = [], []
    for b, Lf, ids in zip(m.bucket_batches, factors, m.bucket_spec.leaf_ids):
        xt = XT if ti is None else XT[ti[torch.as_tensor(ids)]]
        Knt = torch.where(b.mask[:, :, None], leaf_gram(m.layout, m.theta, b, xt), 0.0)
        rhs.append(torch.cat([centered_y(b)[..., None], Knt], dim=-1))
        for l in range(b.num_leaves):
            Z = torch.linalg.solve_triangular(Lf[l].double(), rhs[-1][l].double(),
                                              upper=False)
            want.append((Z[:, 1:].mT @ Z[:, 0], (Z[:, 1:] ** 2).sum(0), Z[:, 0]))
    vz, vv, zs = trsm.forward_solve_moments(factors, rhs, want_z=True)
    z = [row for zb in zs for row in zb]
    for l, (wz, wv, wzz) in enumerate(want):
        torch.testing.assert_close(vz[l], wz, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(vv[l], wv, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(z[l], wzz, rtol=1e-12, atol=1e-12)


def _case_cached(m, factors, ti):
    """``cached_leaf_predict`` on each bucket, in one launch and in one
    launch per leaf (a budget below one leaf), against the parent's."""
    for b, Lf, ids in zip(m.bucket_batches, factors, m.bucket_spec.leaf_ids):
        tib = None if ti is None else ti[torch.as_tensor(ids)]
        want = [_parent_moments(m.layout, m.theta, b.rows(l, l + 1), Lf[l:l + 1],
                                _routed(XT, tib, l, l + 1))[:2]
                for l in range(b.num_leaves)]
        for budget in (2 << 30, 1):
            mu, var = tfit.cached_leaf_predict(m.layout, m.theta, b, Lf, XT, tib,
                                               budget=budget)
            _ulp(mu, torch.cat([w[0] for w in want]))
            _ulp(var, torch.cat([w[1] for w in want]))


def _case_hybrid(m, factors, ti):
    """``bucketed_hybrid_predict`` with buckets 1, 4 and 6 cached (two
    of them above nmax 1024) and the rest streamed, against the parent's
    per-bucket loop; the streamed buckets take the kernel's route above
    nmax 1024 (``potrf.supported`` forced), float32 solves below it."""
    entries = [(Lf, None) if k in (1, 4, 6) else None for k, Lf in enumerate(factors)]
    mu, var = tfit.bucketed_hybrid_predict(m.layout, m.theta, m.bucket_batches,
                                           m.bucket_spec.leaf_ids, m.num_leaves,
                                           entries, XT, ti)
    for b, Lf, ids, entry in zip(m.bucket_batches, factors, m.bucket_spec.leaf_ids,
                                 entries):
        tib = None if ti is None else ti[torch.as_tensor(ids)]
        if entry is None:  # streamed: its own factor, the bucket in one chunk here
            Lf = tfit._factor(m.layout, m.theta, b)
        for l, leaf in enumerate(ids):
            wmu, wvar, _ = _parent_moments(m.layout, m.theta, b.rows(l, l + 1),
                                           Lf[l:l + 1], _routed(XT, tib, l, l + 1),
                                           entry is not None or b.nmax > 1024)
            _ulp(mu[leaf], wmu[0])
            _ulp(var[leaf], wvar[0])


def _case_streamed(m, factors, ti):
    """``streamed_leaf_predict`` on every bucket above nmax 1024 (the
    kernel's route forced): moments and the leaf mll from ``z``."""
    for b, ids in zip(m.bucket_batches, m.bucket_spec.leaf_ids):
        if b.nmax <= 1024:
            continue
        tib = None if ti is None else ti[torch.as_tensor(ids)]
        mu, var, mll = tfit.streamed_leaf_predict(m.layout, m.theta, b, XT, tib)
        Lf = tfit._factor(m.layout, m.theta, b)
        wmu, wvar, z = _parent_moments(m.layout, m.theta, b, Lf, _routed(XT, tib, 0, None))
        _ulp(mu, wmu)
        _ulp(var, wvar)
        _ulp(mll, leaf_mll_forward(Lf, z, b).to(b.x.dtype))


CASES = {"plain": _case_plain, "cached": _case_cached, "hybrid": _case_hybrid,
         "streamed": _case_streamed}


@pytest.mark.parametrize("routed", [False, True], ids=["shared", "routed"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_solve_matches_parent(model, factors, routes, monkeypatch, case, routed):
    monkeypatch.setattr(potrf, "supported",
                        lambda nmax, dtype, device: dtype == torch.float32 and nmax > 1024)
    assert tfit._kept_recipe(model.bucket_batches[-1])
    CASES[case](model, factors, routes if routed else None)


# ---------------------------------------------------------------------------
# The launch plan through a replica of the kernel
# ---------------------------------------------------------------------------


def _replica(plan, tensors, width):
    """Run ``plan`` as the kernel runs it, block by block in ticket order,
    in float64 NumPy: a block reads only what earlier tickets released
    (asserted), every workspace element is written once, and what was
    never written is NaN. Returns ``(vz, vv)``; z goes to the addresses
    in the table."""
    T, CT, tc = width - 1, trsm.TILE, plan.per_tile
    spans = [(t.data_ptr(), t.numel() * t.element_size(), t) for t in tensors]

    def at(ptr, count):
        for base, nbytes, t in spans:
            if base <= ptr < base + nbytes:
                assert (ptr - base) % t.element_size() == 0
                off = (ptr - base) // t.element_size()
                assert off + count <= t.numel()
                return t.view(-1)[off:off + count]
        raise AssertionError(f"address {ptr:#x} is in no tensor")

    R = trsm.ROWS
    ws = np.full(plan.ws_size, np.nan)
    writes = np.zeros(plan.ws_size, np.int64)
    part = np.full(plan.part_size, np.nan)
    flags = np.zeros(plan.n_flags, bool)
    nl = plan.table.shape[0]
    vz, vv = np.full((nl, T), np.nan), np.full((nl, T), np.nan)
    for code in plan.order:
        li, i, c = int(code >> 32), int((code >> 16) & 0xFFFF), int(code & 0xFFFF)
        lf, rh, n, wso, flo, pao, zp, row = (int(v) for v in plan.table[li])
        nb = -(-n // R)
        L = at(lf, n * n).double().numpy().reshape(n, n)
        B = at(rh, n * width).double().numpy().reshape(n, width)
        X = ws[wso + c * nb * R * CT:wso + (c + 1) * nb * R * CT].reshape(nb * R, CT)
        fl = flags[flo + c * nb:flo + (c + 1) * nb]
        r0, rows = i * R, min(R, n - i * R)
        acc = np.zeros((R, CT))
        for j in range(i):
            assert fl[j], (li, i, c, j)
            acc[:rows] += L[r0:r0 + rows, j * R:(j + 1) * R] @ X[j * R:(j + 1) * R]
        Bt = np.zeros((R, CT))
        Bt[:rows, 0] = B[r0:r0 + rows, 0]
        for t in range(1, min(tc, width - 1 - c * tc) + 1):
            Bt[:rows, t] = B[r0:r0 + rows, c * tc + t]
        Lii = np.eye(R)
        Lii[:rows, :rows] = np.tril(L[r0:r0 + rows, r0:r0 + rows])
        Xi = scipy.linalg.solve_triangular(Lii, Bt - acc, lower=True)
        X[r0:r0 + R] = Xi
        writes[wso + c * nb * R * CT + r0 * CT:wso + c * nb * R * CT + (r0 + R) * CT] += 1
        if c == 0 and zp:
            at(zp + r0 * 8, rows).copy_(torch.from_numpy(Xi[:rows, 0]))
        p = part[pao + (c * nb + i) * 2 * CT:pao + (c * nb + i + 1) * 2 * CT]
        p[:CT], p[CT:] = Xi.T @ Xi[:, 0], (Xi * Xi).sum(0)
        fl[i] = True
        if i == nb - 1:
            sums = part[pao + c * nb * 2 * CT:pao + (c + 1) * nb * 2 * CT].reshape(nb, 2, CT)
            for t in range(1, tc + 1):
                if c * tc + t <= T:
                    vz[row, c * tc + t - 1] = sums[:, 0, t].sum()
                    vv[row, c * tc + t - 1] = sums[:, 1, t].sum()
    assert flags.all() and (writes == 1).all()
    return vz, vv


@pytest.mark.parametrize("width", [1, 2, 65, 321])
def test_launch_plan_replica_matches_plain(model, factors, width):
    """Three buckets' leaves in one plan (mixed buckets, ragged leaves,
    identity padding), at the widths of the card test: the
    replica's z, vz and vv against the plain version's, at float64
    rounding (the blocked sums run in another order than LAPACK's)."""
    tiles, per_tile = trsm.column_tiles(width)
    assert tiles * per_tile >= width - 1 and per_tile < trsm.TILE
    gen = torch.Generator().manual_seed(width)
    picks = (0, 3, 6)  # nmax 640 (two ragged leaves), 1096 and 1584
    factors = [factors[k] for k in picks]
    rhs = [torch.randn(Lf.shape[:2] + (width,), generator=gen, dtype=Lf.dtype)
           * model.bucket_batches[k].mask[..., None] for k, Lf in zip(picks, factors)]
    zs = [torch.full(Lf.shape[:2], float("nan"), dtype=torch.float64) for Lf in factors]
    plan = trsm.launch_plan(factors, rhs, zs)
    assert plan.order.size == plan.tiles * sum(
        -(-Lf.shape[1] // trsm.ROWS) * Lf.shape[0] for Lf in factors)
    vz, vv = _replica(plan, [*factors, *rhs, *zs], width)
    wz, wv, wzs = trsm.forward_solve_moments(factors, rhs, want_z=True)
    np.testing.assert_allclose(vz, wz.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(vv, wv.numpy(), rtol=1e-9, atol=1e-9)
    for z, wzz in zip(zs, wzs):
        np.testing.assert_allclose(z.numpy(), wzz.numpy(), rtol=1e-9, atol=1e-9)
