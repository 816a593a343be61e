"""The program every rank of ``tests/test_torch_mesh.py`` runs: a gloo world
on the CPU, float64, torch on one thread. It imports the port and never
JAX. Each case runs the port's multi-device function on every rank and
registers the same call on one device (:meth:`Case.later`), which one rank
makes after every collective is done, so that the four ranks share the
single-device runs out and run them side by side. Every rank writes what
it has to an ``npz`` of its own (row blocks gathered first; the
multi-device results are the same on every rank), for the test module to
hold against the JAX package and against the single-device runs.

The data and sizes are those of ``tests/test_dist_chol.py`` and
``tests/test_sharding.py``.
"""
import functools
import importlib

import numpy as np
import torch
import torch.distributed as dist

XT33 = np.linspace(-0.1, 1.1, 33).reshape(-1, 1)
XT41 = np.linspace(-0.05, 1.05, 41).reshape(-1, 1)
XT60 = np.linspace(-0.05, 1.05, 60).reshape(-1, 1)
XT73 = np.linspace(-0.05, 1.05, 73).reshape(-1, 1)
CHOL_BLOCKS = (64, 128)
#: the giant leaves' panel (the JAX tests take 16 on 8 devices): each panel
#: costs a few collectives, which the parallel suite's load makes slow
GIANT_BLOCK = 64


def spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def solve_inputs():
    """``(L, b, B, z, Z)`` of the N=512 solves; ``b`` is ``B``'s first
    column."""
    L = np.linalg.cholesky(spd(512, seed=1))
    rng = np.random.default_rng(2)
    B = rng.standard_normal((512, 9))
    return (L, B[:, 0], B, rng.standard_normal(512),
            rng.standard_normal((512, 3)))


def gp_data(n=700):
    """The N=700 GP of ``test_giant_gp_model_layer_distributed_fit_predict``:
    ``(x, y)``."""
    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(0, 1, n)).reshape(-1, 1)
    return x, np.sin(x[:, 0] * 6) + 0.1 * rng.standard_normal(n)


def data300():
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, 300)).reshape(-1, 1)
    return x, np.sin(x[:, 0] * 4 * np.pi) + rng.normal(0, 0.2, 300)


def data400():
    rng = np.random.default_rng(21)
    x = np.sort(rng.uniform(0, 1, 400)).reshape(-1, 1)
    return x, np.sin(x[:, 0] * 5) + 0.1 * rng.standard_normal(400)


#: builder and options of every tree model, shared with the JAX side
MODELS = {
    "s1": ("build_dsmgp", data300, dict(V=2, K=3, M=20, seed=1)),
    "s13": ("build_dsmgp", data300, dict(V=2, K=3, M=20, seed=13)),
    # 24 leaves, overlap 20% dense: the sparse pair list
    "ft": ("build_dsmgp", data300, dict(V=2, K=3, M=40, seed=15)),
    # 3 leaves: fewer candidates than ranks
    "few": ("build_dsmgp", data300, dict(V=1, K=3, M=80, seed=7)),
    # two size buckets, one leaf in the larger
    "giant": ("build_dsmgp", data400, dict(V=2, K=2, M=80, eps=0.5, seed=4)),
    "poe": ("build_poe", data400, dict(K=2, M=80, eps=0.5, seed=5)),
}


def build(pkg, name, **kw):
    """Model ``name`` of :data:`MODELS` from package ``pkg``, unfitted."""
    builder, data, opts = MODELS[name]
    x, y = data()
    return getattr(pkg, builder)(x, y, kernel=pkg.IsoSE(0.0, 0.0),
                                 log_noise=-1.0, do_fit=False, **opts, **kw)


#: ``(model, iterations)`` of the ``finetune(mesh=)`` runs (Adam lr 1e-2)
FINETUNES = (("ft", 3), ("few", 2))


def giant_budget(nmaxs, item=8):
    """``giant_leaf_bytes`` that routes only the largest bucket."""
    return sorted(nmaxs)[-2] ** 2 * item


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _raises(exc, fn):
    """The message of ``exc`` raised by ``fn()`` ('' if none was)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


class Case:
    """One rank's state: the mesh, its axis, the results and the
    single-device runs it owes."""

    def __init__(self, mesh):
        from deepstructuredmixtures_tpu_torch.parallel.comm import resolve

        self.mesh = mesh
        self.ax = resolve(mesh)
        self.res = {}
        self.owed = []

    def put(self, key, value):
        self.res[key] = _np(value)

    def rows(self, a):
        """This rank's row block of ``a`` as a float64 tensor."""
        r = a.shape[0] // self.ax.ndev
        return torch.as_tensor(a[self.ax.me * r:(self.ax.me + 1) * r])

    def whole(self, t):
        return self.ax.gather_rows(t)

    def later(self, share: int, fn):
        """Run ``fn()`` (single-device work, no collective) at the end, on
        the rank of ``share``."""
        if share % self.ax.ndev == self.ax.me:
            self.owed.append(fn)


def case_dist_chol(c):
    from deepstructuredmixtures_tpu_torch.parallel import dist_chol as dc
    from deepstructuredmixtures_tpu_torch.parallel import make_mesh

    A = spd(1024)
    for block in CHOL_BLOCKS:
        c.put(f"chol{block}", c.whole(dc.sharded_cholesky(c.rows(A), c.mesh,
                                                           block=block)))
    L, b, B, z, Z = solve_inputs()
    solves = (("lower_vec", dc.sharded_solve_lower, b, False),
              ("lower_mat", dc.sharded_solve_lower, B, False),
              ("lower_t_vec", dc.sharded_solve_lower_t, z, True),
              ("lower_t_mat", dc.sharded_solve_lower_t, Z, True))
    for key, fn, rhs, _ in solves:
        c.put(f"solve_{key}", c.whole(fn(c.rows(L), c.rows(rhs), c.mesh,
                                         block=64)))

    # _check_blocking's errors, through the functions that check it
    Lr = c.rows(np.linalg.cholesky(spd(1024, seed=6)))
    c.put("err_rows_block", _raises(ValueError, lambda: dc.sharded_cholesky(
        c.rows(spd(1024, seed=6)), c.mesh, block=96)))
    c.put("err_solve_block", _raises(ValueError, lambda: dc.sharded_solve_lower(
        Lr, torch.zeros(256), c.mesh, block=96)))
    c.put("err_solve_t_block", _raises(
        ValueError, lambda: dc.sharded_solve_lower_t(Lr, torch.zeros(256),
                                                     c.mesh, block=96)))
    x102 = torch.zeros((102, 1), dtype=torch.float64)
    c.put("err_mesh_size", _raises(ValueError, lambda: dc.sharded_gp_fit(
        x102, x102[:, 0], -1.0, 0.0, -1.5, c.mesh, block=32)))
    c.put("err_row_block", _raises(ValueError, lambda: dc.sharded_cholesky(
        torch.as_tensor(spd(256)), c.mesh, block=64)))
    c.put("err_make_mesh", _raises(ValueError, lambda: make_mesh(2)))

    # the giant-leaf GP at N=700, padded to the 4 x 64 tiling, its targets
    # centred as GaussianProcess centres them
    x, y = gp_data()
    m = float(y.mean())
    xp = torch.zeros((768, 1), dtype=torch.float64)
    yp = torch.zeros(768, dtype=torch.float64)
    xp[:700], yp[:700] = torch.as_tensor(x), torch.as_tensor(y - m)
    alpha, mll, Lf = dc.sharded_gp_fit(xp, yp, -1.0, 0.0, -1.5, c.mesh,
                                       block=64, valid_n=700,
                                       return_factor=True)
    mu, var = dc.sharded_gp_predict(Lf, xp, yp, -1.0, 0.0, -1.5,
                                    torch.as_tensor(XT33), c.mesh, block=64,
                                    mean=m, valid_n=700)
    c.put("gpfit_alpha", c.whole(alpha))
    c.put("gpfit_mll", mll)
    c.put("gpfit_mu", mu)
    c.put("gpfit_var", var)

    def single():
        import deepstructuredmixtures_tpu_torch as tdsm

        c.put("chol_single", torch.linalg.cholesky(torch.as_tensor(A)))
        Lt = torch.as_tensor(L)
        for key, _, rhs, upper in solves:
            r = torch.as_tensor(rhs).reshape(512, -1)
            one = torch.linalg.solve_triangular(Lt.mT if upper else Lt, r,
                                                upper=upper)
            c.put(f"solve_{key}_single", one.reshape(rhs.shape))
        g = tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(-1.0, 0.0),
                                 log_noise=-1.5, device="cpu").fit()
        c.put("gpfit_alpha_single", torch.cholesky_solve(
            torch.as_tensor(y - m)[:, None], g._state[0])[:, 0])
        c.put("gpfit_mll_single", g.mll())
        for k, v in zip(("mu", "var"), g.predict(XT33)):
            c.put(f"gpfit_{k}_single", v)

    c.later(0, single)


def case_gp(c):
    import deepstructuredmixtures_tpu_torch as tdsm

    x, y = gp_data()

    def gp():
        return tdsm.GaussianProcess(x, y, kernel=tdsm.IsoSE(-1.0, 0.0),
                                    log_noise=-1.5, device="cpu")

    gd = gp().fit(mesh=c.mesh, block=64)
    c.put("gp_mll", gd.mll())
    for k, v in zip(("mu", "var"), gd.predict(XT33)):
        c.put(f"gp_{k}", v)
    theta = _np(gd.theta) + 0.05
    gd.set_params(theta)
    for k, v in zip(("mu2", "var2"), gd.predict(XT33)):  # refits
        c.put(f"gp_{k}", v)
    c.put("gp_stays_on_mesh", gd._mesh is not None and gd._mesh[0] is c.mesh)
    c.put("gp_err_grad", _raises(NotImplementedError, gd.grad_mll))
    c.put("gp_err_full_cov", _raises(
        NotImplementedError, lambda: gd.predict(XT33, full_cov=True)))
    c.put("gp_err_train_gp", _raises(
        NotImplementedError, lambda: tdsm.train_gp(gd, iterations=1)))

    def single():
        gs = gp().fit()
        c.put("gp_mll_single", gs.mll())
        for k, v in zip(("mu", "var"), gs.predict(XT33)):
            c.put(f"gp_{k}_single", v)
        gs.set_params(theta)
        for k, v in zip(("mu2", "var2"), gs.predict(XT33)):
            c.put(f"gp_{k}_single", v)

    c.later(0, single)


def case_leaf_sharding(c):
    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch import fit as fitlib
    from deepstructuredmixtures_tpu_torch.parallel import mesh as pm

    ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    m = build(tdsm, "s1", device="cpu")
    L = m.num_leaves
    padded = pm.pad_leaves(m.batch, 4)
    c.put("pad_ok", padded.num_leaves % 4 == 0
          and not bool(padded.mask[L:].any()) and not bool(padded.n[L:].any()))
    c.put("shard_rows", pm.shard_batch(m.batch, c.mesh).num_leaves)
    f, _ = pm.make_sharded_mll_fn(m.layout, m.plan, m.batch, c.mesh)
    v, g = ttrain._value_and_grad(f)(m.theta)
    c.put("mll", v)
    c.put("grad", g)
    post = pm.sharded_fit(m.layout, m.theta, m.batch, c.mesh)
    c.put("fit_mll", c.whole(post.mll)[:L])
    tidx, tmask = m._route(XT73)
    fr, prepare = pm.make_sharded_routed_predict(m.layout, m.plan, m.batch,
                                                 c.mesh)
    for k, v in zip(("z", "mean", "var"),
                    fr(m.theta, torch.as_tensor(XT73), *prepare(tidx, tmask))):
        c.put(f"routed_{k}", v)
    # two training steps, Adam lr 5e-2
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step, init, _ = pm.make_sharded_train_step(m.layout, m.plan, m.batch,
                                               c.mesh, adam)
    theta, opt, vals = m.theta, init(m.theta), []
    for _ in range(2):
        v, theta, opt = step(theta, opt)
        vals.append(float(v))
    c.put("step_vals", vals)
    c.put("step_theta", theta)
    # the streamed path, routed and unrouted (PoE family)
    tidx60, _ = m._route(XT60)
    base = (m.layout, m.theta, m.bucket_batches, m.bucket_spec.leaf_ids, L,
            torch.as_tensor(XT60))
    routes = (("routed", torch.as_tensor(tidx60, dtype=torch.long)),
              ("all", None))
    for tag, ti in routes:
        for k, v in zip(("mu", "var", "mll"),
                        pm.sharded_bucketed_streamed_predict(*base, ti,
                                                             mesh=c.mesh)):
            c.put(f"streamed_{tag}_{k}", v)

    def single():
        fn = ttrain.make_mll_fn(m.layout, m.plan, m.batch)
        v, g = ttrain._value_and_grad(fn)(m.theta)
        c.put("mll_single", v)
        c.put("grad_single", g)
        c.put("fit_mll_single",
              fitlib.fit_batched(m.layout, m.theta, m.batch).mll)
        for tag, ti in routes:
            for k, v in zip(("mu", "var", "mll"),
                            fitlib.bucketed_streamed_predict(*base, ti)):
                c.put(f"streamed_{tag}_{k}_single", v)
        p = m.theta.clone().requires_grad_(True)
        opt, vals = adam([p]), []
        for _ in range(2):
            v, g = ttrain._value_and_grad(fn)(p)
            ttrain._ascend(opt, p, g)
            vals.append(float(v))
        c.put("step_vals_single", vals)
        c.put("step_theta_single", p)
        m.fit(method="batched", store="full")
        c.put("routed_z_single", m.update())
        for k, v in zip(("mean", "var"), m.predict(XT73)):
            c.put(f"routed_{k}_single", v)

    c.later(1, single)


def _model_moments(c, m, tag):
    c.put(f"giant_leaf_mll{tag}", m.leaf_mlls())
    c.put(f"giant_z{tag}", m.update())
    for k, v in zip(("mean", "var"), m.predict(XT41)):
        c.put(f"giant_{k}{tag}", v)
    c.put(f"giant_mean_only{tag}", m.predict(XT41, return_var=False))


def case_giant(c):
    import deepstructuredmixtures_tpu_torch as tdsm
    from torch.distributed.device_mesh import DeviceMesh

    md = build(tdsm, "giant", device="cpu")
    md.fit(mesh=c.mesh, giant_leaf_bytes=giant_budget(md.bucket_spec.nmaxs),
           block=GIANT_BLOCK)
    c.put("giant_distributed", md.last_fit_diagnostics["distributed_leaves"])
    c.put("giant_expected", len(md.bucket_spec.leaf_ids[
        int(np.argmax(md.bucket_spec.nmaxs))]))
    c.put("giant_alpha_cached", md._alpha_cache is not None)
    _model_moments(c, md, "")
    c.put("giant_err_refine", _raises(ValueError, lambda: md.predict(
        XT41, refine_steps=1)))
    for store, method in (("full", "auto"), ("auto", "shared")):
        c.put(f"giant_err_{method}_{store}", _raises(ValueError, lambda: md.fit(
            mesh=c.mesh, store=store, method=method)))
    # a 2 x 2 mesh: one axis must be named
    multi = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=("a", "b"))
    c.put("giant_err_multi", _raises(ValueError, lambda: md.fit(
        mesh=multi, giant_leaf_bytes=1, block=16)))
    x, y = gp_data()
    c.put("gp_err_multi", _raises(ValueError, lambda: tdsm.GaussianProcess(
        x, y, device="cpu").fit(mesh=multi)))
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    mf = build(tdsm, "few", device="cpu")
    c.put("finetune_err_multi", _raises(ValueError, lambda: tdsm.finetune(
        mf, adam, iterations=1, mesh=multi, progress=False)))
    # against the "few" run of case_training and JAX's
    c.put("finetune_axis_hist", tdsm.finetune(
        mf, adam, iterations=2, lam=1e-9, mesh=multi, axis="b",
        progress=False))
    c.put("finetune_axis_theta", mf.theta)
    md.set_params(_np(md.get_params()) + 0.1)
    c.put("giant_cleared", md._giant is None)

    # PoE with every leaf giant, and with the largest bucket giant
    for name, budget in (("poe_all", 1), ("poe_mix", None)):
        pd = build(tdsm, "poe", device="cpu")
        pd.fit(mesh=c.mesh, block=GIANT_BLOCK,
               giant_leaf_bytes=budget or giant_budget(pd.bucket_spec.nmaxs))
        c.put(f"{name}_distributed", pd.last_fit_diagnostics[
            "distributed_leaves"])
        c.put(f"{name}_leaves", pd.num_leaves)
        for k, v in zip(("mean", "var"), pd.predict(XT41)):
            c.put(f"{name}_{k}", v)

    def single():
        mr = build(tdsm, "giant", device="cpu")
        mr.fit()
        _model_moments(c, mr, "_single")
        pr = build(tdsm, "poe", device="cpu")
        pr.fit()
        for k, v in zip(("mean", "var"), pr.predict(XT41)):
            for name in ("poe_all", "poe_mix"):
                c.put(f"{name}_{k}_single", v)

    c.later(0, single)


def case_training(c):
    import deepstructuredmixtures_tpu_torch as tdsm
    from deepstructuredmixtures_tpu_torch.parallel import mesh as pm

    ttrain = importlib.import_module("deepstructuredmixtures_tpu_torch.train")
    m = build(tdsm, "s13", device="cpu")
    buckets = (m.layout, m.plan, m.bucket_batches, m.bucket_spec.leaf_ids)
    v, g = pm.make_sharded_value_and_grad_bucketed(*buckets, c.mesh,
                                                   chunk=1)(m.theta)
    c.put("vg_value", v)
    c.put("vg_grad", g)
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    mt = build(tdsm, "s13", device="cpu")
    c.put("train_hist", tdsm.train(mt, adam, iterations=3, lam=1e-9,
                                   randinit=False, progress=False,
                                   mesh=c.mesh, chunk=1))
    c.put("train_theta", mt.theta)
    # a randinit start is rank 0's on every rank
    mt = build(tdsm, "s13", device="cpu")
    tdsm.train(mt, adam, iterations=1, progress=False, mesh=c.mesh)
    first = c.ax.gather_rows(mt.theta[None])
    c.put("train_randinit_replicated", bool((first == first[0]).all()))
    # without bucket batches: the sharded monolithic objective
    mt = build(tdsm, "s13", device="cpu")
    mt.bucket_batches = None
    c.put("train_nobucket_hist", tdsm.train(
        mt, adam, iterations=2, lam=1e-9, randinit=False, progress=False,
        mesh=c.mesh))
    c.put("train_err_chunk", _raises(ValueError, lambda: tdsm.train(
        mt, adam, iterations=1, randinit=False, mesh=c.mesh, chunk=1)))

    def single_train():
        v, g = ttrain.make_value_and_grad_bucketed(*buckets)(m.theta)
        c.put("vg_value_single", v)
        c.put("vg_grad_single", g)
        mt = build(tdsm, "s13", device="cpu")
        c.put("train_hist_single", tdsm.train(
            mt, adam, iterations=3, lam=1e-9, randinit=False, progress=False))
        c.put("train_theta_single", mt.theta)

    c.later(2, single_train)

    adam_ft = functools.partial(torch.optim.Adam, lr=1e-2)
    for name, iters in FINETUNES:
        mf = build(tdsm, name, device="cpu")
        c.put(f"finetune_{name}_hist", tdsm.finetune(
            mf, adam_ft, iterations=iters, lam=1e-9, progress=False,
            mesh=c.mesh))
        c.put(f"finetune_{name}_theta", mf.theta)
        c.put(f"finetune_{name}_leaves", mf.num_leaves)
    c.put("train_err_untied", _raises(ValueError, lambda: tdsm.train(
        mf, adam_ft, iterations=1, randinit=False, mesh=c.mesh)))

    def single_finetune():
        for name, iters in FINETUNES:
            mf = build(tdsm, name, device="cpu")
            c.put(f"finetune_{name}_hist_single", tdsm.finetune(
                mf, adam_ft, iterations=iters, lam=1e-9, progress=False,
                bucketed=True))
            c.put(f"finetune_{name}_theta_single", mf.theta)

    c.later(3, single_finetune)


def case_dryrun(c):
    from deepstructuredmixtures_tpu_torch.parallel import dryrun

    for k, v in dryrun.check(c.mesh, "cpu").items():
        c.put(f"dryrun_{k}", v)


CASES = (case_dist_chol, case_gp, case_leaf_sharding, case_giant,
         case_training, case_dryrun)


def run(rank, world, store, out):
    """Spawn target: join the gloo world through the file ``store``, run
    every case, then this rank's single-device runs, and write its results
    to ``out.format(rank)``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        from deepstructuredmixtures_tpu_torch.parallel import make_mesh

        c = Case(make_mesh(world))
        for case in CASES:
            case(c)
    finally:
        dist.destroy_process_group()
    for fn in c.owed:
        fn()
    np.savez(out.format(rank), **c.res)
