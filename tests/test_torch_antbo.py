"""The AntBO slice of hebo_tpu_torch (GP cat-kernel modes, Casmopolitan TR,
constrained local search, BoBuilder, AntBO, AbsolutTool) against hebo_tpu
on CPU.

Tolerances (float32 on both sides, different summation orders and LAPACK
vs XLA factorizations), as in tests/test_torch_gp.py:
* loss, caches, predictions: rtol 1e-4 / atol 1e-4;
* loss gradient: rtol 1e-3 / atol 1e-3.
The trust region, the constrained local search from one model state and the
surrogate energies are host numpy: they must agree exactly.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acquisitions.acq import EI as JEI
from hebo_tpu.acquisitions.acq import AcqParams as JAcqParams
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.optimizers.antbo import ConstrainedLocalSearch as JCLS
from hebo_tpu.optimizers.antbo import sequence_space as jsequence_space
from hebo_tpu.tasks.antbo_tools import AbsolutTool as JAbsolut
from hebo_tpu.trust_region.casmo import CasmopolitanTrManager as JTR
from hebo_tpu_torch.acquisitions.acq import EI, AcqParams
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.gp import GPCore, GPParams, cache_from_jax, data_from_jax, params_from_jax
from hebo_tpu_torch.optimizers.antbo import (
    AA_ALPHABET,
    AntBOOptimizer,
    ConstrainedLocalSearch,
    check_cdr_constraints,
    sequence_space,
)
from hebo_tpu_torch.optimizers.bo_builder import BoBuilder
from hebo_tpu_torch.tasks import AbsolutTool, ManualTool, TableFillingTool
from hebo_tpu_torch.trust_region import CasmopolitanTrManager

REPO = Path(__file__).resolve().parent.parent
N_OBS, N_PAD = 13, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def _cores(cat_kernel, n_num, L=6, V=4):
    args = dict(numeric_dims=tuple(range(n_num)), cat_dims=tuple(range(n_num, n_num + L)),
                num_categories=(V,) * L, cat_kernel=cat_kernel, n_steps=8)
    return JCore(**args), GPCore(**args)


def _data(n_num, L=6, V=4):
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(-1, 2, (N_OBS, n_num)), rng.integers(0, V, (N_OBS, L))], 1)
    y = (np.sin(3 * X[:, :1]) + (X[:, n_num:] == 1).sum(1, keepdims=True)).astype(np.float32)
    jd = _make_data(X, y, tuple(range(n_num)), N_PAD)
    return jd, data_from_jax(_np(jd))


def _jax_p0(jcore, jd, R=2, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    return jax.vmap(lambda k: jcore.init_params(k, jd))(keys), keys


GP_CASES = [("ssk", 0), ("ssk", 2), ("transformed_overlap", 0), ("transformed_overlap", 2), ("overlap", 1)]


@pytest.mark.parametrize("cat_kernel,n_num", GP_CASES)
def test_gpcore_loss_and_gradient(cat_kernel, n_num):
    jcore, tcore = _cores(cat_kernel, n_num)
    assert (tcore.d_feat, tcore.n_feat_dims, tcore.n_cat_param) == (
        jcore.d_feat, jcore.n_feat_dims, jcore.n_cat_param)
    jd, td = _data(n_num)
    p0j, _ = _jax_p0(jcore, jd)
    lj, gj = jax.value_and_grad(lambda P: jnp.sum(jcore.loss_batched(P, jd)))(p0j)
    leaves = [None if t is None else t.requires_grad_(True) for t in params_from_jax(_np(p0j))]
    loss = tcore.loss_batched(GPParams(*leaves), td)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jcore.loss_batched(p0j, jd)),
                               rtol=1e-4, atol=1e-4)
    live = [(f, t) for f, t in zip(GPParams._fields, leaves) if t is not None]  # noise_w: None
    grads = torch.autograd.grad(loss.sum(), [t for _, t in live], allow_unused=True)
    for (name, _), g in zip(live, grads):
        want = np.asarray(getattr(gj, name))
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("cat_kernel,n_num", GP_CASES[:3])
def test_gpcore_cache_and_predict_ensemble(cat_kernel, n_num):
    jcore, tcore = _cores(cat_kernel, n_num)
    jd, td = _data(n_num)
    sj, _ = _jax_p0(jcore, jd, seed=5)  # two "samples"
    cj = jcore.posterior_cache_batched(sj, jd)
    ts = params_from_jax(_np(sj))
    ct = tcore.posterior_cache_batched(ts, td)
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    for name in ("L", "alpha", "Wf"):
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    rng = np.random.default_rng(6)
    Xs = np.concatenate([rng.uniform(-1, 2, (9, n_num)), rng.integers(0, 4, (9, 6))], 1).astype(np.float32)
    muj, varj = jcore.predict_ensemble(sj, cj, jd, jnp.asarray(Xs))
    mu, var = tcore.predict_ensemble(ts, ct, td, torch.as_tensor(Xs))
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(varj), rtol=1e-4, atol=1e-4)


def test_init_params_ssk_from_the_same_draws():
    jcore, tcore = _cores("ssk", 0)
    jd, td = _data(0)
    p0j, keys = _jax_p0(jcore, jd)
    z_emb, z_ls = [], []
    for k in keys:
        ke, kl = jax.random.split(k)
        z_emb.append(np.asarray(jax.random.normal(ke, (jcore.total_cats, jcore.emb_dim), jnp.float32)))
        z_ls.append(np.asarray(jax.random.normal(kl, (jcore.d_feat,), jnp.float32)))
    p0 = tcore.init_params(td, 2, draws=(np.stack(z_emb), np.stack(z_ls)))
    assert tcore.features(p0, td.X, td).shape == (2, N_PAD, 0)
    for k, v in _np(p0j).items():
        np.testing.assert_allclose(getattr(p0, k).numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_unported_cat_kernel_names_its_slice():
    """Every cat kernel of the JAX package is ported (diffusion, hed and
    conditional_to came last); an unknown one raises as there."""
    for name in ("diffusion", "hed", "conditional_to"):
        assert GPCore((), (0, 1), (3, 3), cat_kernel=name).cat_kernel == name
    with pytest.raises(ValueError, match="unknown cat_kernel 'walsh'"):
        GPCore((), (0, 1), (3, 3), cat_kernel="walsh")


def _tr_pair(seed=3):
    jspace, tspace = jsequence_space(6), sequence_space(6)
    return jspace, tspace, JTR(jspace, seed=seed), CasmopolitanTrManager(tspace, seed=seed)


def test_casmopolitan_tr_identical():
    jspace, tspace, jtr, ttr = _tr_pair()
    center = tspace.sobol_sample_opt(1, seed=2)[0]
    for tr in (jtr, ttr):
        tr.register_center(center)
    np.testing.assert_array_equal(ttr.sample_within_tr(20), jtr.sample_within_tr(20))
    ys = np.random.default_rng(4).standard_normal(60)
    best = np.inf
    for y in ys:
        jtr.adjust(y, best)
        ttr.adjust(y, best)
        best = min(best, y)
        assert (ttr.radius, ttr.cat_radius, ttr.succ_count, ttr.fail_count) == (
            jtr.radius, jtr.cat_radius, jtr.succ_count, jtr.fail_count)
    for seed in (5, 9):
        jtr.restart(seed=seed)
        ttr.restart(seed=seed)
        np.testing.assert_array_equal(ttr.center, jtr.center)
        assert ttr.cat_budget() == jtr.cat_budget()
        np.testing.assert_array_equal(ttr.sample_within_tr(7), jtr.sample_within_tr(7))


def test_constrained_local_search_identical():
    """One fitted JAX model state, carried over; same TR seed and search seed."""
    jspace, tspace, jtr, ttr = _tr_pair(seed=1)
    X = jspace.transform(jspace.sample(24, seed=0))
    y = ((X == 2).sum(1, keepdims=True) - 0.3 * (X[:, :1] == 0)).astype(np.float32)
    jm = jget_model("gp", jspace, cat_kernel="ssk", num_epochs=10).fit(X, y)
    tm = get_model("gp", tspace, cat_kernel="ssk", device="cpu")
    samples, caches, data = jm.state
    tm.samples, tm.caches, tm.data = (params_from_jax(_np(samples)), cache_from_jax(_np(caches)),
                                      data_from_jax(_np(data)))
    best = X[int(np.argmin(y[:, 0]))]
    jtr.register_center(best)
    ttr.register_center(best)
    tau = float(np.min((y - y.mean()) / y.std()))
    kw = dict(constraint=check_cdr_constraints, alphabet=AA_ALPHABET[:20])
    rj = JCLS(jspace, **kw).optimize(jm, JEI(), JAcqParams(tau=jnp.float32(tau)), n_suggestions=2,
                                     x_observed=X, tr_manager=jtr, seed=3)
    rt = ConstrainedLocalSearch(tspace, **kw).optimize(tm, EI(), AcqParams(tau=tau), n_suggestions=2,
                                                       x_observed=X, tr_manager=ttr, seed=3)
    np.testing.assert_array_equal(rt, rj)
    # the one-row score that the search starts each walk with (M = 1)
    s1 = ConstrainedLocalSearch(tspace)._score(tm, EI(), AcqParams(tau=tau), rt[:1])
    sj = np.asarray(JEI().eval_pure(jm, jm.state, JAcqParams(tau=jnp.float32(tau)), jnp.asarray(rt[:1], jnp.float32)))
    np.testing.assert_allclose(s1, sj[:, 0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------- tests/test_antbo.py, on CPU
def test_cdr_constraints():
    assert check_cdr_constraints("ACDEFGHIKLM")
    assert not check_cdr_constraints("AAAAAGHIKLM")  # 5-run repeat
    assert not check_cdr_constraints("ANASGHIKLMT")  # N-A-S glycosylation
    assert not check_cdr_constraints("KKKKRGHIKLM")  # charge +5 > 2
    assert check_cdr_constraints("NPSAGHIKLMT")  # N-P-S is allowed (X=P)


def _toy_binding(seqs):
    """Toy binding energy: favor 'W' at even positions, 'G' at odd."""
    out = []
    for s in seqs:
        e = sum(-1.0 if (c == "W" and i % 2 == 0) or (c == "G" and i % 2 == 1)
                else 0.1 for i, c in enumerate(s))
        out.append(e)
    return np.asarray(out).reshape(-1, 1)


@pytest.mark.parametrize("kernel", ["transformed_overlap", "ssk"])
def test_antbo_loop_improves(kernel):
    opt = AntBOOptimizer(seq_len=6, n_init=6, kernel=kernel, model_kwargs={"num_epochs": 10},
                         device="cpu")
    for it in range(8):
        rec = opt.suggest(2)
        seqs = ["".join(row) for _, row in rec.iterrows()]
        for s in seqs:
            assert check_cdr_constraints(s) or it < 3  # init may violate
        opt.observe(rec, _toy_binding(seqs))
    assert np.isfinite(opt.best_y)
    assert opt.best_y < 0.1 * 6
    assert len(opt.fit_time) == len(opt.acq_time) == 5


def test_table_of_candidates_restriction():
    space = sequence_space(4)
    table = space.transform(space.sample(32, seed=0))
    opt = AntBOOptimizer(seq_len=4, n_init=4, constraint=None, table_of_candidates=table,
                         model_kwargs={"num_epochs": 8}, device="cpu")
    for _ in range(4):
        rec = opt.suggest(2)
        opt.observe(rec, _toy_binding(["".join(row) for _, row in rec.iterrows()]))
    X = opt.space.transform(opt.X.iloc[4:])
    tab = {tuple(r) for r in table.tolist()}
    assert np.mean([tuple(r) in tab for r in X.tolist()]) >= 0.5


def test_guided_restart_path():
    opt = AntBOOptimizer(seq_len=5, n_init=4, model_kwargs={"num_epochs": 8}, device="cpu")
    opt.tr_manager.radius_min = 10.0  # force immediate restarts
    for _ in range(4):
        rec = opt.suggest(2)
        opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))
    assert opt.tr_manager.restart_count >= 1
    assert len(opt.restart_bests) >= 2  # the auxiliary GP ran


def test_guided_restart_does_not_swallow_errors(monkeypatch):
    from hebo_tpu_torch.models.gp import GP

    opt = AntBOOptimizer(seq_len=5, n_init=4, model_kwargs={"num_epochs": 4}, device="cpu")
    opt.tr_manager.radius_min = 10.0
    for _ in range(3):
        rec = opt.suggest(2)
        opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))

    def boom(self, X, y):
        raise RuntimeError("auxiliary fit failed")

    monkeypatch.setattr(GP, "fit", boom)
    opt.restart_bests = [opt.space.transform(opt.X)[0]]
    with pytest.raises(RuntimeError, match="auxiliary fit failed"):
        opt.suggest(2)


def test_cuda_default_does_not_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AntBOOptimizer(seq_len=4)


# ------------------------------------------------------------- BoBuilder
@pytest.mark.parametrize("model_id,acq_opt_id,acq", [("gp_ssk", "ls", "ei"), ("gp_to", "rs", "lcb"),
                                                     ("gp_o", "ls", "mace")])
def test_bo_builder_loop(model_id, acq_opt_id, acq):
    space = sequence_space(5)
    opt = BoBuilder(model_id, acq_opt_id, acq, "basic", model_kwargs={"num_epochs": 6},
                    acq_opt_kwargs={"n_random": 32} if acq_opt_id == "ls" else {"num_samples": 32}
                    ).build_bo(space, n_init=4, device="cpu")
    for _ in range(4):
        rec = opt.suggest(2)
        assert len(rec) == 2 and list(rec.columns) == space.param_order
        opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))
    assert opt.num_obs == 8 and np.isfinite(opt.best_y)


def test_bo_builder_kriging_believer_batch():
    space = sequence_space(4)
    opt = BoBuilder("gp_to", "rs", "ei", "none", model_kwargs={"num_epochs": 4},
                    acq_opt_kwargs={"num_samples": 16}).build_bo(space, n_init=4, device="cpu",
                                                                 batch_strategy="kb")
    rec = opt.suggest(4)
    opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))
    rec = opt.suggest(3)
    assert len(rec) == 3 and opt.model.data.mask.sum() == 4


@pytest.mark.parametrize("ids,error", [(("gbdt", "ls", "ei"), None), (("catboost", "ls", "ei"), None),
                                       (("rf", "ls", "ei"), "'RF' object has no attribute 'state'"),
                                       (("rf", "sa", "ts"), "'RF' object has no attribute 'state'"),
                                       (("deep_ensemble", "ls", "ei"), None)])
def test_bo_builder_model_ids_suggest_or_fail_as_the_reference(ids, error):
    """The ids that were slice 13's: the GBDT (both ids) and the deep
    ensemble suggest; the random forest has no ``state`` for the
    acquisition optimizers, and raises the same ``AttributeError`` in the
    JAX package (ROADMAP §3)."""
    from hebo_tpu.optimizers.bo_builder import BoBuilder as JBoBuilder

    conf = {"n_estimators": 4} if ids[0] == "rf" else {"num_epochs": 4}
    builders = [BoBuilder(*ids, model_kwargs=conf).build_bo(sequence_space(3), n_init=4,
                                                            device="cpu")]
    if error is not None:
        builders.append(JBoBuilder(*ids, model_kwargs=conf).build_bo(jsequence_space(3), n_init=4))
    for opt in builders:
        rec = opt.suggest(4)
        opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))
        if error is not None:
            with pytest.raises(AttributeError) as err:
                opt.suggest(1)
            assert str(err.value) == error
            continue
        for _ in range(2):
            rec = opt.suggest(1)
            assert len(rec) == 1 and list(rec.columns) == opt.space.param_order
            opt.observe(rec, _toy_binding(["".join(r) for _, r in rec.iterrows()]))
        assert opt.num_obs == 6 and np.isfinite(opt.best_y)


# ------------------------------------------------------------------ tools
def test_absolut_surrogate_energies_equal_with_copied_tables():
    j, t = JAbsolut("1H0D_C", seq_len=11), AbsolutTool("1H0D_C", seq_len=11)
    t._site, t._pair = j._site.copy(), j._pair.copy()
    space = sequence_space(11)
    seqs = ["".join(r) for _, r in space.sample(40, seed=3).iterrows()]
    np.testing.assert_array_equal(t(seqs), j(seqs))


def test_absolut_surrogate_is_the_same_in_every_process():
    code = ("from hebo_tpu_torch.tasks import AbsolutTool; t = AbsolutTool('1H0D_C'); "
            "print(repr(float(t._site.sum() + t._pair.sum())))")
    outs = {subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                           env={"PYTHONHASHSEED": h, "PATH": "/usr/bin:/bin"}, timeout=120).stdout
            for h in ("1", "2")}
    assert len(outs) == 1 and outs.pop().strip()


def test_table_and_manual_tools(tmp_path):
    table = {"ACDE": -3.0, "WGWG": -7.5}
    np.testing.assert_array_equal(TableFillingTool(table, fill_value=1.0)(["WGWG", "AAAA"]),
                                  [[-7.5], [1.0]])
    tool = ManualTool(str(tmp_path))
    path = tool.request(["ACDE", "WGWG"])
    assert Path(path).read_text().split() == ["ACDE", "WGWG"]
    (tmp_path / "scores.txt").write_text("1.5\n-2\n")
    np.testing.assert_array_equal(tool.collect(2), [[1.5], [-2.0]])
