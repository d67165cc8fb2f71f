"""The task suite in hebo_tpu_torch (``tasks/*``, ``native.py``) against
hebo_tpu on CPU.

The tasks are host numpy copied from the JAX package, so the same inputs
must give the same values: exactly, or at 1e-6 where a library solver
runs (scipy's HiGHS, sklearn).  The DRiLLS agent (the one task with device
work) is held with the JAX package's network carried across and its
random draws fed: its actions exactly, one A2C update's parameters at 1e-5.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import hebo_tpu.tasks as jt
import hebo_tpu_torch.tasks as tt
from hebo_tpu.tasks import drills as jdrills
from hebo_tpu.tasks import highdim as jhd
from hebo_tpu.tasks import hpob as jhpob
from hebo_tpu.tasks import robust as jrob
from hebo_tpu.tasks import synthetic as jsyn
from hebo_tpu_torch.tasks import drills as tdrills
from hebo_tpu_torch.tasks import highdim as thd
from hebo_tpu_torch.tasks import hpob as thpob
from hebo_tpu_torch.tasks import robust as trob
from hebo_tpu_torch.tasks import synthetic as tsyn

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(task_t, task_j, df, exact=True):
    yt, yj = task_t(df), task_j(df)
    assert yt.shape == yj.shape
    if exact:
        np.testing.assert_array_equal(yt, yj)
    else:
        np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6)
    return yt


# ------------------------------------------------------------------ synthetic
@pytest.mark.parametrize("name", sorted(jsyn._TASKS))
def test_synthetic_task_values_equal_the_reference(name):
    kw = dict(noise_std=0.1, num_dummy=1, offset=0.2, rotate=True, seed=3)
    tj, tt_ = jsyn.get_task(name, **kw), tsyn.get_task(name, **kw)
    assert type(tt_).__name__ == type(tj).__name__
    df = tj.space.sample(7, seed=1)
    _same(tt_, tj, df)
    assert tt_.space.param_order == tj.space.param_order
    assert tt_.fmin == tj.fmin


# ------------------------------------------------------------------ EDA, BOiLS
def test_random_aag_and_the_aig_opt_qor_equal_the_reference():
    pj, pt = jt.random_aag(n_ands=48, seed=5), tt.random_aag(n_ands=48, seed=5)
    assert Path(pt).read_text() == Path(pj).read_text()
    ej, et = jt.EDASeqOptTask(netlist_path=pj, seq_len=4), tt.EDASeqOptTask(netlist_path=pt, seq_len=4)
    df = ej.space.sample(6, seed=2)
    y = _same(et, ej, df)
    assert np.isfinite(y).all()
    bj = jt.BoilsTask(jt.SynthesisSession(netlist_path=pj), seq_len=4)
    bt = tt.BoilsTask(tt.SynthesisSession(netlist_path=pt), seq_len=4)
    assert bt._base == bj._base
    _same(bt, bj, df)
    seqs = [["rw"], ["b", "dc", "rw"], []]
    assert bt.session.run_sequences(seqs) == bj.session.run_sequences(seqs)


def test_native_pool_runs_in_order():
    from hebo_tpu_torch.native import EvalPool, ensure_built

    ensure_built()
    out = EvalPool(n_threads=3).map([f"echo {i}; exit {i % 2}" for i in range(5)])
    assert [(c, s.strip()) for c, s in out] == [(i % 2, str(i)) for i in range(5)]


# ------------------------------------------------------------------ RNA
def test_rna_fold_and_task_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        seq = "".join(rng.choice(list("ACGU"), rng.integers(4, 30)))
        assert tt.nussinov_fold(seq) == jt.nussinov_fold(seq)
    target = "((((....))))..((...))"
    tj, tk = jt.RNAInverseFoldTask(target), tt.RNAInverseFoldTask(target)
    _same(tk, tj, tj.space.sample(8, seed=4))


# --------------------------------------------------------- high-dimensional
_MPS = """NAME t
ROWS
 N  COST
 G  C1
 L  C3
 E  C2
COLUMNS
    a         COST      1.0   C1        2.0
    a         C2        1.0   C3        1.0
    b         COST     -1.0   C1        1.0
    c         COST      0.5   C3        1.0
RHS
    RHS       C1        2.0   C2        0.5
    RHS       C3        4.0
BOUNDS
 UP BND       b         3.0
 UP BND       c         2.0
ENDATA
"""


def test_parse_mps_lp_and_nasbench_equal_the_reference(tmp_path):
    pj, pt = jhd.parse_mps(_MPS), thd.parse_mps(_MPS)
    assert pt.keys() == pj.keys()
    for k in pj:
        if isinstance(pj[k], np.ndarray):
            np.testing.assert_array_equal(pt[k], pj[k])
        else:
            assert pt[k] == pj[k]
    for kw in ({}, {"n_bin": 8, "n_cont": 0, "seed": 2}):
        lj, lt = jt.LPSolveTask(**kw), tt.LPSolveTask(**kw)
        _same(lt, lj, lj.space.sample(6, seed=3), exact=False)
    f = tmp_path / "p.mps"
    f.write_text(_MPS)
    lj, lt = jt.LPSolveTask(mps_path=str(f)), tt.LPSolveTask(mps_path=str(f))
    _same(lt, lj, pd.DataFrame({"a": [0, 1], "b": [2, 3], "c": [0, 1]})[lj.space.param_order], exact=False)
    nj, nt = jt.NASBenchTask(seed=3), tt.NASBenchTask(seed=3)
    _same(nt, nj, nj.space.sample(9, seed=0))


# ------------------------------------------------------------------ robust
def test_robust_tasks_and_corruptions_equal_the_reference():
    x = np.linspace(-1.0, 2.0, 41).reshape(-1, 1)
    np.testing.assert_array_equal(trob.rkhs_synth(x), jrob.rkhs_synth(x))
    np.testing.assert_array_equal(trob.small_corruption(x), jrob.small_corruption(x))
    np.testing.assert_array_equal(trob.large_corruption(x), jrob.large_corruption(x))
    _same(tt.RKHSTask(), jt.RKHSTask(), jt.RKHSTask().space.sample(9, seed=1))
    for dim in (3, 4):
        rj, rt = jt.RobotPushTask(dim=dim), tt.RobotPushTask(dim=dim)
        _same(rt, rj, rj.space.sample(9, seed=dim))
    for corr in ("small", "large"):
        cj = jt.CorruptedTask(jt.RKHSTask(), corruption=corr, scale=0.5)
        ct = tt.CorruptedTask(tt.RKHSTask(), corruption=corr, scale=0.5)
        _same(ct, cj, cj.space.sample(9, seed=2))
    uj = jt.UncertainEvalWrapper(jt.RobotPushTask(), input_std=0.2, seed=4)
    ut = tt.UncertainEvalWrapper(tt.RobotPushTask(), input_std=0.2, seed=4)
    df = uj.space.sample(5, seed=6)
    for _ in range(2):  # the call counter advances the common random numbers
        _same(ut, uj, df)


# ------------------------------------------------------------------ HPO-B
def _meta_file(tmp_path):
    def entry(n, d, seed):
        r = np.random.default_rng(seed)
        return {"X": r.random((n, d)).tolist(), "y": [[float(v)] for v in np.clip(r.beta(5, 2, n), 0, 1)]}

    data = {"5860": {"14965": entry(64, 3, 1), "9976": entry(48, 3, 2)}, "5906": {"3493": entry(32, 8, 3)}}
    p = tmp_path / "meta-test-dataset.json"
    p.write_text(json.dumps(data))
    return str(p)


class _Random:
    """A seeded random-search optimizer for both packages' eval harness."""

    def __init__(self, space, seed):
        self.space, self.seed, self.n = space, seed, 0

    def suggest(self, n):
        self.n += 1
        return self.space.sample(n, seed=1000 * self.seed + self.n)

    def observe(self, rec, y):
        pass


def test_hpob_tables_loader_and_eval_harness_equal_the_reference(tmp_path):
    sj, st = jt.SyntheticHPOBTask(dim=2, n_points=96, seed=1), tt.SyntheticHPOBTask(dim=2, n_points=96, seed=1)
    np.testing.assert_array_equal(st.X_table, sj.X_table)
    np.testing.assert_array_equal(st.y_table, sj.y_table)
    _same(st, sj, sj.space.sample(8, seed=0))
    assert st.regret(np.array([0.5])) == sj.regret(np.array([0.5]))
    path = _meta_file(tmp_path)
    sui_j, sui_t = jhpob.load_meta_dataset(path), thpob.load_meta_dataset(path)
    assert {s: set(d) for s, d in sui_t.items()} == {s: set(d) for s, d in sui_j.items()}
    b = thpob.TabularBenchmark.load_json(path, "5906", "3493")
    np.testing.assert_array_equal(b.y_table, sui_j["5906"]["3493"].y_table)
    kw = dict(n_seeds=2, n_trials=6, n_init=2)
    rj = jhpob.run_hpob_eval(sui_j, make_optimizer=_Random, **kw)
    rt = thpob.run_hpob_eval(sui_t, make_optimizer=_Random, device="cpu", **kw)
    assert rt == rj


def test_run_hpob_eval_with_the_ports_hebo_emits_the_reference_schema(tmp_path):
    suite = thpob.load_meta_dataset(_meta_file(tmp_path))
    res = thpob.run_hpob_eval({"5860": {"14965": suite["5860"]["14965"]}}, n_seeds=1, n_trials=5, n_init=3,
                              device="cpu")
    trace = res["5860"]["14965"]["test0"]
    assert len(trace) == 5 and all(0.0 <= v <= 1.0 for v in trace)
    assert all(b >= a for a, b in zip(trace, trace[1:]))
    assert json.loads(json.dumps(res)) == res


# -------------------------------------------------------- sklearn-backed tasks
def test_lasso_and_ml_tuning_equal_the_reference():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(1):
        lj, lt = jt.LassoBenchTask(), tt.LassoBenchTask()
        _same(lt, lj, lj.space.sample(3, seed=0), exact=False)
        for cls in ("SVMTuningTask", "XGBTuningTask"):
            tj, tk = getattr(jt, cls)(), getattr(tt, cls)()
            tj.eval_timeout_s = tk.eval_timeout_s = 600.0
            df = tj.space.sample(2, seed=1)
            if cls == "XGBTuningTask":  # few boosting rounds keep it quick
                df["max_iter"] = 20
            y = _same(tk, tj, df, exact=False)
            assert y.shape == (2, 1)


# ------------------------------------------------------------------ DRiLLS
@pytest.fixture(scope="module")
def drills_pair():
    path = jt.random_aag(seed=0)
    jd = jdrills.DrillsBaseline(jt.BoilsTask(jt.SynthesisSession(netlist_path=path), seq_len=4), seed=0)
    td = tdrills.DrillsBaseline(tt.BoilsTask(tt.SynthesisSession(netlist_path=path), seq_len=4), seed=0,
                                device="cpu")
    td.params = tdrills.policy_value_from_flax(jax.tree.map(np.asarray, jd.params), td.net)
    return jd, td


def test_drills_episode_with_the_reference_draws(drills_pair):
    jd, td = drills_pair
    key = jd._key
    seq_j, qor_j, S_j, A_j, R_j = jd.run_episode()
    gumbels = []
    for _ in range(jd.T):  # run_episode's key schedule, replayed
        key, ka = jax.random.split(key)
        gumbels.append(np.asarray(jax.random.gumbel(ka, (jd.n_actions,))))
    seq_t, qor_t, S_t, A_t, R_t = td.run_episode(gumbels=np.stack(gumbels))
    assert seq_t == seq_j and qor_t == qor_j
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(S_t, S_j)
    np.testing.assert_array_equal(R_t, R_j)


def test_drills_update_with_the_reference_draws(drills_pair):
    jd, td = drills_pair
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for _ in range(2):  # Adam's first and second step
        S = rng.standard_normal((jd.T, jd.feat_dim)).astype(np.float32)
        A = rng.integers(0, jd.n_actions, jd.T)
        R = td.returns(rng.standard_normal(jd.T))
        jd.params, jd.opt_state, lj = jd._update(jd.params, jd.opt_state, jnp.asarray(S), jnp.asarray(A),
                                                 jnp.asarray(R))
        lt = td._update(S, A, R)
        np.testing.assert_allclose(lt, float(lj), rtol=1e-5, atol=1e-6)
        want = tdrills.policy_value_from_flax(jax.tree.map(np.asarray, jd.params), td.net)
        for k in want:
            w = want[k].numpy()
            np.testing.assert_allclose(td.params[k].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


def test_drills_baseline_trains():
    task = tt.BoilsTask(seq_len=4)
    agent = tt.DrillsBaseline(task, seed=0, device="cpu")
    out = agent.train(n_episodes=4)
    assert len(out["qor_trace"]) == 4
    assert out["best_qor"] <= 2.0 + 1e-9  # never worse than doing nothing
    assert len(out["best_seq"]) == 4
    assert all(op in task.operators for op in out["best_seq"])


# ------------------------------------------------------------------ imports
_IMPORT_CHECK = """
import sys
for name in ("jax", "flax", "optax", "hebo_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import hebo_tpu_torch.latent, hebo_tpu_torch.tasks, hebo_tpu_torch.native
from hebo_tpu_torch.latent import LatentSpaceBO, ImageLatentBO
from hebo_tpu_torch.latent.chem import ChemLatentBO
from hebo_tpu_torch.tasks import DrillsBaseline, EDASeqOptTask, LassoBenchTask, SVMTuningTask
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "hebo_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""


def test_latent_and_tasks_import_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_device_work_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from hebo_tpu_torch.latent import LatentSpaceBO

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LatentSpaceBO(tt.PestControlTask(n_stations=3).space)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.DrillsBaseline(tt.BoilsTask(seq_len=2))
