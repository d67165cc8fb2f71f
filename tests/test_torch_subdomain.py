"""febo's solvers, SubDomainBO (LineBO) and SafeOpt in hebo_tpu_torch
against hebo_tpu on CPU.

Tolerances: the candidate and grid solvers identically (host numpy);
multi-start L-BFGS from the same starts within 1e-4 of the JAX package's
point and value (float32 on both sides, gradients by autograd against
``jax.grad``), on a quadratic and on the LCB of a GP carried across from
the JAX package; SafeOpt on a carried-across GP: the same picks.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acq_optimizers import solvers as jsolvers
from hebo_tpu.acquisitions import acq as jacq
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.optimizers import SafeOpt as JSafeOpt
from hebo_tpu_torch import DesignSpace
from hebo_tpu_torch.acq_optimizers import solvers as tsolvers
from hebo_tpu_torch.acquisitions import acq as tacq
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.gp import gp_from_jax
from hebo_tpu_torch.optimizers import SafeOpt
from hebo_tpu_torch.optimizers.subdomain import (AscentLineBO, CoordinateLineBO, RandomLineBO,
                                                 SubDomainBO)

TARGET = [0.3, -0.7, 0.5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX package's compiles at XLA's lowest backend optimization
    level (see tests/test_torch_mcbo.py)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _quad(X, xp):
    t = xp.asarray(TARGET[: X.shape[1]], dtype=X.dtype) if xp is jnp else \
        torch.as_tensor(TARGET[: X.shape[1]], dtype=X.dtype)
    return ((X - t[None, :]) ** 2).sum(1, keepdims=True)


def _jquad(X):
    """The JAX side's objective: a module function, because the JAX
    package holds a plain ``f(X)`` only weakly."""
    return _quad(jnp.asarray(X), jnp)


def test_candidate_and_grid_solver_are_identical():
    rng = np.random.default_rng(0)
    cands = rng.uniform(-1, 1, (256, 2))
    f = lambda X: ((np.asarray(X) - [0.3, -0.7]) ** 2).sum(1, keepdims=True)
    for got, want in ((tsolvers.candidate_solver(f, cands), jsolvers.candidate_solver(f, cands)),
                      (tsolvers.grid_solver(f, [-1, -1], [1, 1], 21),
                       jsolvers.grid_solver(f, [-1, -1], [1, 1], 21))):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert tsolvers.grid_solver(f, [-1, -1], [1, 1], 21)[1] < 0.01


@pytest.mark.parametrize("box", [1.0, 0.5])
def test_multi_start_lbfgs_on_a_quadratic(box):
    """From the same starts: the JAX package's point and value within 1e-4,
    inside the box (the box [−0.5, 0.5]³ cuts off −0.7, so the solution
    sits on the bound)."""
    X0 = np.random.default_rng(1).uniform(-box, box, (8, 3)).astype(np.float32)
    lb, ub = [-box] * 3, [box] * 3
    xj, vj = jsolvers.multi_start_lbfgs(_jquad, X0, lb, ub, n_iters=40)
    xt, vt = tsolvers.multi_start_lbfgs(lambda X: _quad(X, torch), X0, lb, ub, n_iters=40,
                                        device="cpu")
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-4, atol=1e-4)
    assert abs(vt - vj) <= 1e-4
    assert (xt >= -box).all() and (xt <= box).all()
    np.testing.assert_allclose(xt, np.clip(TARGET, -box, box), atol=5e-3)


def test_lbfgs_batch_has_a_fixed_schedule_of_evaluations():
    """Each iteration is one batched line search over the 5 trial steps of
    every start and one value-and-gradient at the accepted points; nothing
    is read back inside the loop."""
    shapes = []

    def f(args, X):
        shapes.append((tuple(X.shape), X.requires_grad))
        return _quad(X, torch)

    X0 = torch.zeros((4, 3))
    tsolvers.lbfgs_batch(f, (), X0, -torch.ones(3), torch.ones(3), n_iters=3, history=2)
    assert shapes == [((4, 3), True)] + [((20, 3), False), ((4, 3), True)] * 3


@pytest.fixture(scope="module")
def gp_pair():
    """A JAX GP fitted on 12 Sobol points of a 3-D box, and the port's GP
    carrying it (``gp_from_jax``)."""
    spec = [{"name": f"x{i}", "type": "num", "lb": -2.0, "ub": 2.0} for i in range(3)]
    js, ts = JSpace(spec), DesignSpace(spec)
    X = js.sobol_sample_opt(12, seed=2).astype(np.float32)
    y = ((X - 0.5) ** 2).sum(1, keepdims=True) + np.sin(3 * X[:, :1])
    jm = jget_model("gp", js, num_out=1, num_epochs=10)
    jm.fit(X, y)
    tm = gp_from_jax(jm, get_model("gp", ts, num_out=1, device="cpu"))
    return dict(js=js, ts=ts, X=X, y=y, jm=jm, tm=tm)


def test_multi_start_lbfgs_on_a_gp_lcb(gp_pair):
    """On the carried GP's LCB from the same 6 starts: every start's point
    within 1e-4 of the JAX package's after 3 iterations; after 15, the best
    value within 1e-4, and the port's best point scores within 1e-4 of it
    under the JAX package's LCB.  (Near the minimum the valley is flat: the
    values agree to ~2e-6 while the points drift apart by ~1e-4, because
    trial steps whose values tie in float32 are picked differently.)"""
    jm, tm = gp_pair["jm"], gp_pair["tm"]
    X0 = gp_pair["ts"].sobol_sample_opt(6, seed=9).astype(np.float32)
    lb, ub = [-2.0] * 3, [2.0] * 3
    jl, tl = jacq.LCB(), tacq.LCB()
    jargs, targs = (jm.state, jacq.AcqParams(kappa=jnp.float32(2.0))), \
        (tm.state, tacq.AcqParams(kappa=2.0))
    f_j = lambda args, X: jl.eval_pure(jm, args[0], args[1], X)
    f_t = lambda args, X: tl.eval_pure(tm, args[0], args[1], X)
    Xj, fj = jsolvers._lbfgs_batch(f_j, jargs, jnp.asarray(X0), jnp.asarray(lb), jnp.asarray(ub),
                                   3, 8)
    Xt, ft = tsolvers.lbfgs_batch(f_t, targs, torch.as_tensor(X0), torch.as_tensor(lb),
                                  torch.as_tensor(ub), 3, 8)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-4)
    xj, vj = jsolvers.multi_start_lbfgs(f_j, X0, lb, ub, n_iters=15, args=jargs)
    xt, vt = tsolvers.multi_start_lbfgs(f_t, X0, lb, ub, n_iters=15, args=targs, device="cpu")
    assert abs(vt - vj) <= 1e-4
    assert abs(float(f_j(jargs, jnp.asarray(xt[None, :]))[0, 0]) - vj) <= 1e-4
    assert (xt >= -2.0).all() and (xt <= 2.0).all()
    with torch.no_grad():
        v0 = f_t(targs, torch.as_tensor(X0))
    assert vt <= float(v0.min())


@pytest.mark.parametrize("mode", ["coordinate", "random", "ascent", "tr"])
def test_subdomain_bo_improves(mode):
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -2.0, "ub": 2.0}
                         for i in range(3)])

    def f(df):
        return np.sum((df.values.astype(float) - 0.5) ** 2, axis=1, keepdims=True)

    opt = SubDomainBO(space, mode=mode, n_init=5, model_config={"num_epochs": 20}, device="cpu")
    for i in range(14):
        rec = opt.suggest(1)
        X = space.transform(rec)
        assert len(rec) == 1 and (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        y = f(rec)
        if i == 3:
            y[0, 0] = np.inf  # robustness probe
        opt.observe(rec, y)
    init = opt.y[: opt.n_init, 0]
    assert opt.best_y <= float(np.min(init[np.isfinite(init)]))
    assert opt.best_y < 2.0
    assert len(opt.fit_time) == len(opt.acq_time) == 14 - opt.n_init
    with pytest.raises(ValueError):
        opt.suggest(2)


def test_line_bo_factories():
    space = DesignSpace([{"name": "x0", "type": "num", "lb": 0.0, "ub": 1.0},
                         {"name": "x1", "type": "num", "lb": 0.0, "ub": 1.0}])
    for fac, mode in ((CoordinateLineBO, "coordinate"), (RandomLineBO, "random"),
                      (AscentLineBO, "ascent")):
        opt = fac(space, n_init=3, model_config={"num_epochs": 6}, device="cpu")
        assert opt.mode == mode
        for _ in range(5):
            rec = opt.suggest(1)
            opt.observe(rec, np.sum(rec.values.astype(float) ** 2, axis=1, keepdims=True))
        assert np.isfinite(opt.best_y)


# ---------------------------------------------------------------- SafeOpt
SPEC2 = [{"name": f"x{i}", "type": "num", "lb": -2.0, "ub": 2.0} for i in range(2)]


def _f(df):
    return (df["x0"].values.astype(float) ** 2 + df["x1"].values.astype(float) ** 2).reshape(-1, 1)


def test_safeopt_requires_safe_seed():
    opt = SafeOpt(DesignSpace(SPEC2), safety_threshold=4.0, device="cpu")
    with pytest.raises(RuntimeError):
        opt.suggest(1)
    df = pd.DataFrame({"x0": [2.0], "x1": [2.0]})
    opt.observe(df, _f(df))
    with pytest.raises(RuntimeError):
        opt.suggest(1)


def test_safeopt_picks_as_the_jax_package_on_a_carried_gp():
    """The same 8 observations, the JAX package's fitted GP carried into
    the port (whose own fit is then skipped): the same batch of 3."""
    js, ts = JSpace(SPEC2), DesignSpace(SPEC2)
    X = js.sobol_sample_opt(8, seed=4) * 0.6
    df = js.inverse_transform(X)
    jo = JSafeOpt(js, safety_threshold=4.0, seed=0, model_config={"num_epochs": 10})
    to = SafeOpt(ts, safety_threshold=4.0, seed=0, model_config={"num_epochs": 10}, device="cpu")
    for o in (jo, to):
        o.observe(df, _f(df))
    want = jo.suggest(3)
    to.model = gp_from_jax(jo.model, get_model("gp", ts, num_out=1, device="cpu"))
    to.model.fit = lambda X, y: to.model
    got = to.suggest(3)
    pd.testing.assert_frame_equal(got, want)


def test_safeopt_stays_safe_with_the_true_lipschitz_constant():
    """With a valid Lipschitz constant (|∇f| ≤ 2·√8 on the box) the cone
    certifies only safe points, whatever the GP: no suggestion exceeds
    the threshold, and the search moves below the seed's value."""
    opt = SafeOpt(DesignSpace(SPEC2), safety_threshold=4.0, beta=2.5, lipschitz=2 * np.sqrt(8.0),
                  seed=0, model_config={"num_epochs": 30}, device="cpu")
    seed_df = pd.DataFrame({"x0": [1.0], "x1": [1.0]})
    opt.observe(seed_df, _f(seed_df))
    ys = []
    for _ in range(10):
        rec = opt.suggest(1)
        y = _f(rec)
        opt.observe(rec, y)
        ys.append(float(y[0, 0]))
    assert max(ys) <= 4.0
    assert min(ys) < 2.0
    inc_df, inc_y = opt.safe_incumbent
    assert inc_y <= 4.0 and len(inc_df) == 1


def test_safeopt_batch_suggest():
    opt = SafeOpt(DesignSpace(SPEC2), safety_threshold=4.0, model_config={"num_epochs": 10},
                  device="cpu")
    for x0, x1 in ((1.0, 0.5), (0.8, 0.6)):
        d = pd.DataFrame({"x0": [x0], "x1": [x1]})
        opt.observe(d, _f(d))
    rec = opt.suggest(3)
    assert len(rec) == 3 and len(opt.fit_time) == 1
