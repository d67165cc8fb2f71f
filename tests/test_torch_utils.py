"""The port's config tree and experiment utilities (``config.py``,
``utils/*``) against hebo_tpu on CPU.

The parsing and the host utilities are copies, so they are held equal:
the same config fields from the same string, dict or YAML, the same
``ResultsLogger`` frame, the same ``dep_round`` subset from the same
``np.random.Generator``, the same ``RuntimeEstimator`` forecasts.  Every
simple optimizer name and a BoBuilder string build the port's optimizer,
which suggests.  A checkpoint crosses between the packages in both
directions with the same observations and incumbent, and a resumed port
HEBO, and a resumed BoBuilder optimizer with a trust region, suggest
exactly what the uninterrupted ones do (no JAX compile runs here: the JAX
optimizers only observe and take Sobol suggestions).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from hebo_tpu import config as jconfig
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.optimizers.hebo import HEBO as JHEBO
from hebo_tpu.utils import checkpoint as jckpt
from hebo_tpu.utils import data_buffer as jbuf
from hebo_tpu.utils import plotting as jplot
from hebo_tpu.utils import results_logger as jlog
from hebo_tpu.utils import runtime_estimator as jrt
from hebo_tpu.utils import sampling as jsamp
from hebo_tpu_torch import DesignSpace, HEBO
from hebo_tpu_torch import config as tconfig
from hebo_tpu_torch.utils import checkpoint as tckpt
from hebo_tpu_torch.utils.data_buffer import DataBuffer
from hebo_tpu_torch.utils.experiment import BOExperiments, run_experiment
from hebo_tpu_torch.utils.metrics_logging import LocalRunTracker
from hebo_tpu_torch.utils.plotting import aggregate_curves, best_so_far, plot_convergence
from hebo_tpu_torch.utils.results_logger import ResultsLogger
from hebo_tpu_torch.utils.runtime_estimator import RuntimeEstimator
from hebo_tpu_torch.utils.sampling import dep_round

REPO = Path(__file__).resolve().parents[1]
CONT = [{"name": "x0", "type": "num", "lb": -2, "ub": 2}, {"name": "x1", "type": "num", "lb": -2, "ub": 2}]
CATSEQ = [{"name": f"c{i}", "type": "cat", "categories": list("abcd")} for i in range(5)]
SMALL = dict(model_config={"num_epochs": 8}, pop=16, iters=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quad(df):
    return np.sum(df[["x0", "x1"]].values.astype(float) ** 2, axis=1, keepdims=True)


def _cat_obj(df):
    return (df.values == "b").sum(1, keepdims=True).astype(float)


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("spec,kw", [
    ("hebo", {}), ("CMAES", {}), ("gp_to__is__ei__basic", {"n_init": 4}),
    ("gp_o__rs__lcb", {"model_kwargs": {"num_epochs": 8}}), ("a__b__c__d", {"tr_kwargs": {"succ_tol": 2}}),
])
def test_config_from_string_and_dict_match_reference(spec, kw):
    j, t = jconfig.from_string(spec, **kw), tconfig.from_string(spec, **kw)
    assert t.to_dict() == j.to_dict()
    d = dict(j.to_dict(), ignored_key=1)
    assert tconfig.from_dict(d).to_dict() == jconfig.from_dict(d).to_dict()


def test_config_bad_specs_raise_as_reference():
    for spec in ("a__b", "a__b__c__d__e", "not_a_name"):
        with pytest.raises(ValueError):
            jconfig.from_string(spec)
        with pytest.raises(ValueError):
            tconfig.from_string(spec)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tconfig.OptimizerConfig(optimizer="nope").build(DesignSpace(CONT), device="cpu")


def test_config_yaml_matches_reference(tmp_path):
    p = tmp_path / "cfg.yml"
    p.write_text(
        "optimizer: bo_builder\n"
        "model_id: gp_o\n"
        "acq_opt_id: rs\n"
        "acq_func_id: lcb\n"
        "tr_id: none\n"
        "n_init: 4\n"
        "model_kwargs:\n"
        "  num_epochs: 8\n"
        "  # a comment\n"
        "opt_kwargs:\n"
        "  seed: 3\n"
    )
    assert tconfig.from_yaml(str(p)).to_dict() == jconfig.from_yaml(str(p)).to_dict()
    assert tconfig._mini_yaml(str(p)) == jconfig._mini_yaml(str(p))
    cfg = tconfig.from_yaml(str(p))
    assert cfg.model_id == "gp_o" and cfg.model_kwargs == {"num_epochs": 8}
    opt = cfg.build(DesignSpace(CATSEQ), device="cpu")
    assert opt.n_init == 4 and opt.model.device.type == "cpu"


_SIMPLE_KW = {
    "hebo": SMALL, "bo": SMALL, "general_bo": SMALL, "noisy_opt": SMALL, "nomr": SMALL,
    "linebo": {"model_config": {"num_epochs": 8}}, "cmaes": {}, "evolution": {"pop": 16},
    "random_search": {}, "hill_climbing": {}, "simulated_annealing": {},
    "latent_bo": {"latent_dim": 2, "n_init": 4, "vae_steps": 10}, "antbo": {"seq_len": 5, "n_init": 4},
}


@pytest.mark.parametrize("name", sorted(tconfig._SIMPLE_OPTIMIZERS))
def test_config_builds_each_simple_name(name):
    assert set(_SIMPLE_KW) == tconfig._SIMPLE_OPTIMIZERS == jconfig._SIMPLE_OPTIMIZERS
    space = DesignSpace(CONT)
    opt = tconfig.from_string(name, opt_kwargs=dict(_SIMPLE_KW[name])).build(space, device="cpu")
    assert type(opt).__module__.startswith("hebo_tpu_torch.")
    if hasattr(opt, "device"):
        assert opt.device.type == "cpu"
    rec = opt.suggest() if name in ("cmaes", "evolution") else opt.suggest(2)
    assert len(rec) >= 1 and np.isfinite(opt.space.transform(rec)).all()


def test_config_builds_bo_builder_string():
    cfg = tconfig.from_string("gp_to__rs__ei__basic", model_kwargs={"num_epochs": 8}, n_init=4)
    assert cfg.optimizer == "bo_builder"
    space = DesignSpace(CATSEQ)
    opt = cfg.build(space, device="cpu")
    for _ in range(3):
        rec = opt.suggest(2)
        opt.observe(rec, _cat_obj(rec))
    assert len(rec) == 2 and opt.num_obs == 6 and len(opt.fit_time) == 1


def test_config_build_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for spec in ("hebo", "random_search", "gp_to__is__ei__basic"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tconfig.from_string(spec).build(DesignSpace(CONT))


# ------------------------------------------------------------ checkpoint
def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _port_hebo(n_rounds=4):
    opt = HEBO(DesignSpace(CONT), device="cpu", **SMALL)
    for _ in range(n_rounds):
        rec = opt.suggest(3)
        opt.observe(rec, _quad(rec))
    return opt


def test_jax_checkpoint_loads_into_port_hebo(tmp_path):
    jo = JHEBO(JSpace().parse(CONT), **SMALL)
    rec = jo.suggest(3)  # the Sobol phase: no model, no compile
    jo.observe(rec, _quad(rec))
    X = pd.DataFrame(np.random.default_rng(0).uniform(-2, 2, (9, 2)), columns=["x0", "x1"])
    jo.observe(X, _quad(X))
    p = str(tmp_path / "jax.ckpt")
    jckpt.save_optimizer(jo, p)
    to = tckpt.load_optimizer(HEBO(DesignSpace(CONT), device="cpu", **SMALL), p)
    assert to.num_obs == jo.num_obs == 12
    np.testing.assert_array_equal(to.y, jo.y)
    assert to.best_y == jo.best_y and to._sobol_count == jo._sobol_count == 1
    pd.testing.assert_frame_equal(to.X.astype(float), jo.X.astype(float))
    rec = to.suggest(2)  # the restored port optimizer goes on
    to.observe(rec, _quad(rec))
    assert to.num_obs == 14


def test_port_checkpoint_loads_into_jax_hebo(tmp_path):
    to = _port_hebo()
    p = str(tmp_path / "port.ckpt")
    tckpt.save_optimizer(to, p)
    assert not any(torch.is_tensor(v) for v in _leaves(tckpt.optimizer_state_dict(to)))
    jo = jckpt.load_optimizer(JHEBO(JSpace().parse(CONT), **SMALL), p)
    assert jo.num_obs == to.num_obs == 12
    np.testing.assert_array_equal(jo.y, to.y)
    assert jo.best_y == to.best_y and jo._sobol_count == to._sobol_count


def _mcbo(build):
    return build.from_string("gp_to__is__ei__basic", model_kwargs={"num_epochs": 8}, n_init=4)


def test_trust_region_state_crosses_both_ways(tmp_path):
    from hebo_tpu.tasks import PestControlTask as JPest
    from hebo_tpu_torch.tasks import PestControlTask

    task = PestControlTask(n_stations=6)
    to = _mcbo(tconfig).build(task.space, device="cpu")
    for _ in range(5):
        rec = to.suggest(2)
        to.observe(rec, task(rec))
    p = str(tmp_path / "port.ckpt")
    tckpt.save_optimizer(to, p)
    jo = jckpt.load_optimizer(_mcbo(jconfig).build(JPest(n_stations=6).space), p)
    for k in ("radius", "cat_radius", "succ_count", "fail_count", "restart_count"):
        assert getattr(jo.tr_manager, k) == getattr(to.tr_manager, k), k
    np.testing.assert_array_equal(jo.tr_manager.center, to.tr_manager.center)
    assert jo.num_obs == to.num_obs and jo._suggest_count == to._suggest_count
    p2 = str(tmp_path / "jax.ckpt")
    jckpt.save_optimizer(jo, p2)
    back = tckpt.load_optimizer(_mcbo(tconfig).build(task.space, device="cpu"), p2)
    np.testing.assert_array_equal(back.tr_manager.center, to.tr_manager.center)
    assert back.tr_manager.fail_count == to.tr_manager.fail_count and back.best_y == to.best_y


def test_resumed_hebo_suggests_as_uninterrupted(tmp_path):
    opt = _port_hebo()
    p = str(tmp_path / "c.ckpt")
    tckpt.save_optimizer(opt, p)
    resumed = tckpt.load_optimizer(HEBO(DesignSpace(CONT), device="cpu", **SMALL), p)
    for _ in range(2):
        a, b = opt.suggest(3), resumed.suggest(3)
        pd.testing.assert_frame_equal(a, b)
        opt.observe(a, _quad(a))
        resumed.observe(b, _quad(b))


def test_resumed_bo_builder_with_trust_region_suggests_as_uninterrupted(tmp_path):
    from hebo_tpu_torch.tasks import PestControlTask

    task = PestControlTask(n_stations=6)
    opt = _mcbo(tconfig).build(task.space, device="cpu")
    for _ in range(5):
        rec = opt.suggest(2)
        opt.observe(rec, task(rec))
    p = str(tmp_path / "m.ckpt")
    tckpt.save_optimizer(opt, p)
    d = tckpt.optimizer_state_dict(opt)
    assert set(d) == {"X", "y", "columns", "scalars", "tr"} and d["scalars"]["model._seed"] == 3
    resumed = tckpt.load_optimizer(_mcbo(tconfig).build(task.space, device="cpu"), p)
    for _ in range(3):
        a, b = opt.suggest(2), resumed.suggest(2)
        pd.testing.assert_frame_equal(a, b)
        y = task(a)
        opt.observe(a, y)
        resumed.observe(b, y)


# ------------------------------------------------------------ experiment
def test_run_experiment(tmp_path):
    opt = HEBO(DesignSpace(CONT), device="cpu", **SMALL)
    lg = run_experiment(_quad, opt, max_evals=12, batch=4, save_path=str(tmp_path / "exp.csv"),
                        checkpoint_path=str(tmp_path / "exp_ckpt.pkl"))
    assert len(lg.rows) == 12
    assert (tmp_path / "exp.csv").exists() and (tmp_path / "exp_ckpt.pkl").exists()
    assert lg.frame["Best y"].is_monotonic_decreasing


def test_run_experiment_stopping_y():
    from hebo_tpu_torch.optimizers import RandomSearch

    space = DesignSpace([{"name": "x", "type": "num", "lb": -1.0, "ub": 1.0}])
    logger = run_experiment(lambda df: df[["x"]].values.astype(float) ** 2, RandomSearch(space),
                            max_evals=64, batch=4, stopping_y=0.5)
    assert len(logger.rows) < 64 and logger._best <= 0.5


def test_bo_experiments_resume(tmp_path):
    from hebo_tpu_torch.tasks import Branin

    task = Branin()
    cfg = {"optimizer": "hebo", "opt_kwargs": {"pop": 16, "iters": 8}, "model_kwargs": {"num_epochs": 8}}
    exp = BOExperiments(cfg, task, save_dir=str(tmp_path), device="cpu")
    exp.run(max_evals=8, batch=4)
    exp2 = BOExperiments(cfg, task, save_dir=str(tmp_path), device="cpu")
    seen = []
    suggest = exp2.optimizer.suggest
    exp2.optimizer.suggest = lambda n, *a, **k: seen.append(suggest(n, *a, **k)) or seen[-1]
    log2 = exp2.run(max_evals=12, batch=4, resume=True)
    # the resumed run does only the remaining 4 evaluations, and its first
    # batch is what the uninterrupted optimizer suggests at 8 observations
    assert len(log2.rows) == 4 and exp2.optimizer.num_obs == 12
    pd.testing.assert_frame_equal(seen[0], exp.optimizer.suggest(4))
    assert len(pd.read_csv(tmp_path / "results.csv")) == 4


def test_results_logger_matches_reference(tmp_path):
    lj, lt = jlog.ResultsLogger(), ResultsLogger(save_path=str(tmp_path / "res.csv"))
    for ys, t in (([3.0, 1.0], 0.5), ([2.0], 0.1), ([np.nan, 0.5, np.inf], 0.3)):
        lj.append(ys, suggest_time=t, observe_time=t / 2, eval_time=t / 4)
        lt.append(ys, suggest_time=t, observe_time=t / 2, eval_time=t / 4)
    assert list(lt.frame.columns) == list(lj.frame.columns) == ResultsLogger.COLUMNS
    pd.testing.assert_frame_equal(lt.frame.drop(columns="Timestamp"), lj.frame.drop(columns="Timestamp"))
    back = ResultsLogger.load(str(tmp_path / "res.csv"))
    assert len(back.rows) == 6 and back._best == 0.5
    assert len(pd.read_csv(tmp_path / "res.csv")) == 6


def test_dep_round_matches_reference():
    rng = np.random.default_rng(0)
    n_cases = 0
    while n_cases < 20:
        k = int(rng.integers(1, 4))
        u = rng.random(8)
        p = u / u.sum() * k
        if np.any(p >= 1):
            continue
        seed = int(rng.integers(1 << 30))
        x = dep_round(p, np.random.default_rng(seed))
        np.testing.assert_array_equal(x, jsamp.dep_round(p, np.random.default_rng(seed)))
        assert x.sum() == k
        n_cases += 1


def test_runtime_estimator_matches_reference():
    t, j = RuntimeEstimator(stall_factor=5.0), jrt.RuntimeEstimator(stall_factor=5.0)
    assert t.estimate_remaining(10) == j.estimate_remaining(10) and not t.is_stalled(1e9)
    for s in np.linspace(0.1, 1.0, 12) + np.random.default_rng(0).normal(0, 0.02, 12):
        t.record(s)
        j.record(s)
        assert t.estimate_remaining(20) == j.estimate_remaining(20)
        assert t.is_stalled(3.0) == j.is_stalled(3.0) and t.is_stalled(10.0) == j.is_stalled(10.0)
    assert t.is_stalled(10.0) and not t.is_stalled(1.0)


def test_data_buffer_matches_reference():
    t, j = DataBuffer(num_dims=2, num_obj=1, num_constr=1), jbuf.DataBuffer(2, 1, 1)
    for buf in (t, j):
        buf.append([[0.0, 1.0]], [[2.0, -1.0]])
        buf.append([[1.0, 1.0]], [[1.0, 0.5]])  # infeasible (constraint > 0)
        buf.append([[0.5, 0.5], [0.2, 0.1]], [[np.nan, -1.0], [1.5, -0.2]])
    assert len(t) == 4
    (xt, yt), (xj, yj) = t.best(), j.best()
    np.testing.assert_array_equal(xt, xj)
    assert yt == yj == 1.5
    np.testing.assert_array_equal(t.feasible, j.feasible)
    t2 = DataBuffer(2, 1, 1)
    t2.load_state_dict(t.state_dict())
    assert len(t2) == 4 and t2.best()[1] == 1.5
    assert DataBuffer(2).best() == (None, None)


def test_local_run_tracker(tmp_path):
    tr = LocalRunTracker(str(tmp_path / "mlruns"), "exp")
    rid = tr.start_run("run0")
    tr.log_params({"lr": 0.1, "opt": "hebo"})
    for i, v in enumerate((3.0, 2.0, 1.5)):
        tr.log_metric("best_y", v, step=i)
    art = tmp_path / "a.txt"
    art.write_text("x")
    tr.log_artifact(str(art))
    tr.end_run()
    d = tmp_path / "mlruns" / "exp" / rid
    assert rid == "run0" and (d / "artifacts" / "a.txt").exists()
    assert [h["value"] for h in tr.get_metric_history("best_y")] == [3.0, 2.0, 1.5]
    assert tr.get_metric_history("missing") == []
    import json

    assert json.loads((d / "params.json").read_text()) == {"lr": 0.1, "opt": "hebo"}
    assert "end_time" in json.loads((d / "meta.json").read_text())


def test_plotting_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    runs = {"a": [rng.normal(size=20), rng.normal(size=18)], "b": [rng.normal(size=19)]}
    runs["a"][0][3] = np.nan
    np.testing.assert_array_equal(best_so_far(runs["a"][0]), jplot.best_so_far(runs["a"][0]))
    np.testing.assert_array_equal(aggregate_curves(runs["a"])[0], jplot.aggregate_curves(runs["a"])[0])
    np.testing.assert_array_equal(aggregate_curves(runs["a"])[1], jplot.aggregate_curves(runs["a"])[1])
    out = tmp_path / "conv.png"
    agg = plot_convergence(runs, fmin=-3.0, save_path=str(out), log_regret=True)
    assert set(agg) == {"a", "b"} and out.exists()


_IMPORT_CHECK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "optax", "hebo_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, _Block())
import hebo_tpu_torch.config, hebo_tpu_torch.rl, hebo_tpu_torch.po
for m in ("checkpoint", "data_buffer", "experiment", "metrics_logging", "plotting", "results_logger",
          "runtime_estimator", "sampling"):
    __import__("hebo_tpu_torch.utils." + m)
from hebo_tpu_torch.rl import SAC, Pendulum
from hebo_tpu_torch.po import TinyLM
env, agent = Pendulum(device="cpu"), SAC(3, 1, 2.0, hidden=8, device="cpu")
s, o = env.reset(u=0.25)
print(env.step(s, agent.act(agent.init(), o[None], deterministic=True)[0])[2].shape == ())
"""


def test_slice_imports_without_jax_flax_or_optax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr
