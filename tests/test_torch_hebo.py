"""The whole slice: hebo_tpu_torch.HEBO's suggest/observe loop on CPU.

Small settings (pop 20, 5 generations, 8 pSGLD epochs) on a mixed num+cat
space.  The Sobol init phase is numpy on both sides and must equal
hebo_tpu's exactly; the model rounds then use the port's own random
numbers, so they are held to validity: in bounds, finite and
de-duplicated against the history.
"""

import numpy as np
import pandas as pd

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.optimizers.hebo import HEBO as JHEBO
from hebo_tpu_torch import HEBO, DesignSpace
from hebo_tpu_torch.models.gp import GP

SPECS = [
    {"name": "x0", "type": "num", "lb": -2.0, "ub": 2.0},
    {"name": "x1", "type": "num", "lb": -1.0, "ub": 3.0},
    {"name": "lr", "type": "pow", "lb": 1e-3, "ub": 1.0},
    {"name": "k", "type": "int", "lb": 1, "ub": 6},
    {"name": "c", "type": "cat", "categories": ["a", "b", "c"]},
]
SMALL = dict(pop=20, iters=5, model_config={"num_epochs": 8})


def _f(df):
    x = df[["x0", "x1"]].values.astype(float)
    y = ((x - 0.5) ** 2).sum(1) + np.log10(df["lr"].values.astype(float)) ** 2
    return (y + 0.1 * df["k"].values + (df["c"].values == "b")).reshape(-1, 1)


def test_sobol_init_phase_equals_hebo_tpu():
    t = HEBO(DesignSpace(SPECS), device="cpu", **SMALL)
    j = JHEBO(JSpace(SPECS), **SMALL)
    assert t.rand_sample == j.rand_sample == 6
    for n in (3, 3):
        rt, rj = t.suggest(n), j.suggest(n)
        pd.testing.assert_frame_equal(rt, rj)
        t.observe(rt, _f(rt))
        j.observe(rj, _f(rj))


def test_two_model_rounds_give_valid_batches():
    space = DesignSpace(SPECS)
    opt = HEBO(space, device="cpu", **SMALL)
    rec = opt.suggest(8)
    opt.observe(rec, _f(rec))
    for _ in range(2):
        rec = opt.suggest(4)
        assert len(rec) == 4 and list(rec.columns) == space.param_order
        X = space.transform(rec)
        assert np.isfinite(X).all()
        assert (X >= space.opt_lb - 1e-9).all() and (X <= space.opt_ub + 1e-9).all()
        hist = {tuple(np.round(r, 6)) for r in space.transform(opt.X)}
        keys = [tuple(np.round(r, 6)) for r in X]
        # the random picks are distinct; the best-σ / best-μ overrides of
        # rows 0 and 1 may repeat one of them, as in hebo_tpu (hebo.py:194-199)
        assert len(set(keys[2:])) == len(keys[2:]) and not (set(keys) & hist)
        opt.observe(rec, _f(rec))
    assert opt.num_obs == 16 and np.isfinite(opt.best_y)
    assert opt.model.caches.ok.all()


def test_gp_wrapper_fit_predict():
    space = DesignSpace(SPECS)
    X = space.transform(space.sample(20, seed=1))
    y = _f(space.inverse_transform(X))
    gp = GP(space, device="cpu", num_epochs=8, n_restarts=2)
    gp.fit(X, y)
    mu, var = gp.predict(X[:5])
    assert mu.shape == var.shape == (5, 1)
    assert np.isfinite(mu).all() and (var > 0).all()
    # interpolates its training data far better than the prior spread
    assert np.abs(mu - y[:5]).mean() < y.std()
    # above max_cholesky_size (16): the hyperparameters are fitted on the
    # same 16-row subsample as hebo_tpu's, the CG posterior keeps all 20 rows
    from hebo_tpu.models.gp.gp import GP as JGP

    conf = dict(num_epochs=8, n_restarts=2, max_cholesky_size=16, cg_rank=16, cg_iters=32)
    jgp, seen = JGP(JSpace(SPECS), **conf), {}
    big_fit = jgp._get_fit_fn_big
    jgp._get_fit_fn_big = lambda kp: (
        lambda key, fit, full: big_fit(kp)(key, seen.setdefault("fit", fit), full))
    jgp.fit(X, y)
    big = GP(space, device="cpu", **conf).fit(X, y)
    assert big.fit_data.X.shape[0] == 16 and big.data.X.shape[0] == 32
    for name in ("X", "y", "mask", "x_lb", "x_span"):
        np.testing.assert_array_equal(getattr(big.fit_data, name).numpy(),
                                      np.asarray(getattr(seen["fit"], name)))
    mu, var = big.predict(X[:5])
    assert np.isfinite(mu).all() and (var > 0).all() and big.caches.Kt is not None
    assert np.abs(mu - y[:5]).mean() < y.std()


def test_predrawn_suggest_equals_step_by_step_draws():
    """The suggest program (what the CUDA graph captures) reads every random
    number from buffers filled before it runs.  On the CPU it must equal the
    same suggest assembled step by step, as the eager path was: GPData from
    the host arrays, κ as a Python float, the column metadata made inside
    ``evolve_raw``, and each step's draws handed over as fresh tensors
    through the hooks (``init_params(draws=)``, ``fit_from_batched(noise=)``,
    MACE's z, ``evolve_raw(draws=)``)."""
    import torch

    from hebo_tpu_torch.acq_optimizers.evolution import GenDraws, _space_meta, evolve_raw
    from hebo_tpu_torch.acquisitions.acq import AcqParams
    from hebo_tpu_torch.models.gp.gp import GPData, select
    from hebo_tpu_torch.models.gp.tree import tree_map
    from hebo_tpu_torch.optimizers.hebo import _fill, _leaf_shapes
    from hebo_tpu_torch.ops.transforms import fit_power_transform, power_transform_y

    space = DesignSpace(SPECS)
    opt = HEBO(space, device="cpu", **SMALL)
    rec = opt.suggest(10)
    opt.observe(rec, _f(rec))
    opt.suggest(2)  # builds the model and the acquisition
    Xv = space.transform(opt.X).astype(np.float32)
    yt = power_transform_y(opt.y[:, 0], fit_power_transform(opt.y[:, 0])).reshape(-1, 1)
    yt = yt.astype(np.float32)
    kappa = 1.7
    n_pad, meta, host = opt._suggest_inputs(Xv, yt, kappa, None)
    dr = opt._draws(torch.device("cpu"))
    _fill(dr, torch.Generator().manual_seed(3), opt.pop)
    with torch.no_grad():
        from hebo_tpu_torch.acq_optimizers.evolution import meta_tensors

        out, _ = opt._suggest_program(n_pad, meta_tensors(meta, "cpu"), torch.as_tensor(host), dr)

    # step by step
    core, model, R, D, P = opt.model.core, opt.model, opt.model.n_restarts, space.num_cols, opt.pop
    n = len(Xv)
    y_mean, y_std = float(yt.mean()), float(yt.std())
    nd = list(core.numeric_dims)
    Xp = np.zeros((n_pad, D), np.float32)
    Xp[:n] = Xv
    yp = np.zeros((n_pad, 1), np.float32)
    yp[:n, 0] = (yt[:, 0] - y_mean) / y_std
    lb, ub = Xv[:, nd].min(0), Xv[:, nd].max(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    data = GPData(X=t(Xp), y=t(yp), mask=torch.arange(n_pad) < n, x_lb=t(lb),
                  x_span=t(np.where(ub - lb < 1e-8, 1.0, ub - lb)), y_mean=t(y_mean), y_std=t(y_std))
    E = core.emb_dim if core.total_cats else 0
    shapes = _leaf_shapes(core, R)
    normal = dr.normal.clone()
    z_emb, normal = normal[:R * core.total_cats * E].reshape(R, core.total_cats, E), normal[R * core.total_cats * E:]
    z_ls, normal = normal[:R * core.d_feat].reshape(R, core.d_feat), normal[R * core.d_feat:]
    steps = []
    for _ in range(core.n_steps):
        row = []
        for s in shapes:
            k = int(np.prod(s))
            row.append(normal[:k].reshape(s).clone())
            normal = normal[k:]
        steps.append(row)
    z = normal.reshape(P, 1).clone()
    with torch.no_grad():
        p0 = core.init_params(data, R, draws=(z_emb.clone(), z_ls.clone()))
        pf, loss, samples = core.fit_from_batched(p0, data, noise=lambda i: steps[i])
        best = torch.argmin(loss)
        pf = tree_map(lambda v: v.index_select(0, best.reshape(1)), pf)
        samples = select(samples, best, dim=1)
        caches = core.posterior_cache_batched(samples, data)
        state = (samples, caches, data)
        ym = torch.where(data.mask, data.y[:, 0], torch.full_like(data.y[:, 0], float("inf")))
        xb = data.X.index_select(0, torch.argmin(ym).reshape(1))
        mu_b, _ = model.predict_pure(state, xb)
        noise = torch.sqrt(torch.exp(pf.log_noise[0]) + core.noise_lb) * data.y_std
        pr = AcqParams(tau=mu_b[0, 0], kappa=kappa, eps=1e-4, noise=noise, z=z)
        init = torch.as_tensor(host[-P * D:].reshape(P, D)).clone()
        init[0] = xb[0]
        gens = [GenDraws(dr.sel[g].clone(), *(u.clone() for u in dr.uni[g])) for g in range(opt.iters)]
        pop_X, pop_F = evolve_raw(init, lambda Xc: opt._acq.eval_pure(model, state, pr, Xc),
                                  _space_meta(space), n_gens=opt.iters, draws=lambda g: gens[g])
        mu_pop, var_pop = model.predict_pure(state, pop_X)
    ref = torch.cat([pop_X, pop_F, mu_pop, var_pop], 1)
    assert torch.equal(out, ref)
    assert torch.isfinite(out).all()


def test_generic_route_above_max_cholesky_size():
    """``max_cholesky_size`` 64 at 100 observations (bucket 128): HEBO takes
    the generic route (no fused program: ``model.fit`` on a 64-row
    subsample, the CG posterior on all the data, ``EvolutionOpt``), and
    gives valid, de-duplicated batches over two rounds."""
    space = DesignSpace(SPECS)
    opt = HEBO(space, device="cpu", pop=16, iters=3,
               model_config={"num_epochs": 8, "max_cholesky_size": 64, "cg_rank": 32, "cg_iters": 48})
    warm = space.sample(100, seed=2)
    opt.observe(warm, _f(warm))
    for n in (8, 4):
        rec = opt.suggest(n)
        X = space.transform(rec)
        assert len(rec) == n and np.isfinite(X).all()
        assert (X >= space.opt_lb - 1e-9).all() and (X <= space.opt_ub + 1e-9).all()
        hist = {tuple(np.round(r, 6)) for r in space.transform(opt.X)}
        keys = [tuple(np.round(r, 6)) for r in X]
        assert len(set(keys[2:])) == len(keys[2:]) and not (set(keys) & hist)
        assert opt.model.fit_data.X.shape[0] == 64 and opt.model.data.X.shape[0] == 128
        assert opt.model.caches.Kt is not None and bool(opt.model.caches.ok.all())
        opt.observe(rec, _f(rec))
    assert len(opt.fit_time) == len(opt.acq_time) == 2 and opt.num_obs == 112
