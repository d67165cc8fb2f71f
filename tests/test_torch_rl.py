"""The RL subprojects in hebo_tpu_torch (``rl/*``) against hebo_tpu on CPU.

The same numpy-seeded inputs go through both packages; the flax weights and
the JAX package's ``SACState`` are carried across (``rl/convert.py``), and
the JAX package's draws (its normals, minibatch indices and member picks,
replayed from its key schedule) are fed to the port.  Tolerances (float32
both sides):
* the envs' ``step`` over 200 random states and actions: cost and done
  exactly, the states, observations and rewards within 1e-6 (XLA's CPU
  sin, cos and sqrt are not correctly rounded: they differ from PyTorch's
  by one float32 ulp in 0.7-5 % of values);
* one SAC update and one guided update from carried weights with the JAX
  package's normals: every parameter, target, Adam moment and log α within
  1e-5 of its tensor's largest |value| (most of the difference is the port's
  Adam taking its bias corrections in float64 where optax takes them in
  float32, ROADMAP §3);
* the PMDB fit (5 epochs with the JAX package's indices) and the
  pessimistic rollout with its picks: 1e-5; the drawn picks exactly
  ``jax.random.choice``'s from the same uniform.
The JAX package's own RL tests (tests/test_rl.py) run on the port at their
sizes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.rl import envs as jenvs
from hebo_tpu.rl.pmdb import DynamicsEnsemble as JDyn
from hebo_tpu.rl.pmdb import pessimistic_rollout as jrollout
from hebo_tpu.rl.rllg import GuidedSAC as JGuided
from hebo_tpu.rl.sac import SAC as JSAC
from hebo_tpu.rl.simmer import SauteWrapper as JSaute
from hebo_tpu.rl.simmer import SimmerController as JSimmer
from hebo_tpu.models.nn.deep_ensemble import _init_mlp
from hebo_tpu_torch.rl import (SAC, DynamicsEnsemble, GuidedSAC, Pendulum, PointGoal, ReplayBuffer,
                               SauteWrapper, SimmerController, dynamics_from_jax,
                               pessimistic_rollout, sac_from_flax)
from hebo_tpu_torch.rl.pmdb import pick_members

T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol, what=""):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-30), err_msg=what)


def _batch(rng, B, obs_dim, act_dim):
    return (rng.standard_normal((B, obs_dim)).astype(np.float32),
            rng.standard_normal((B, act_dim)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32),
            rng.standard_normal((B, obs_dim)).astype(np.float32),
            (rng.random(B) < 0.2).astype(np.float32), np.zeros(B, np.float32))


def _update_normals(key, B, act_dim):
    """The normals ``SAC._update_impl`` draws: k1 for the target actions,
    k2 for the actor loss."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.normal(k1, (B, act_dim))), np.array(jax.random.normal(k2, (B, act_dim))))


def _same_state(port, jax_state, sac, tol=1e-5):
    want = sac_from_flax(jax_state, sac)
    for f in ("actor", "q1", "q2", "q1_targ", "q2_targ"):
        for k, v in getattr(want, f).items():
            _close(getattr(port, f)[k], v, tol, f"{f} {k}")
    _close(port.log_alpha, want.log_alpha, tol, "log_alpha")
    for f in ("opt_actor", "opt_q", "opt_alpha"):
        got, exp = getattr(port, f), getattr(want, f)
        assert got.count == exp.count, f
        for k in exp.mu:
            _close(got.mu[k], exp.mu[k], tol, f"{f} mu {k}")
            _close(got.nu[k], exp.nu[k], tol, f"{f} nu {k}")


# ------------------------------------------------------------------ envs
@pytest.mark.parametrize("name,sd", [("Pendulum", 2), ("PointGoal", 4)])
def test_env_step_matches_reference(name, sd):
    j, t = getattr(jenvs, name)(), globals()[name](device="cpu")
    rng = np.random.default_rng(1)
    S = (rng.standard_normal((200, sd)) * 2).astype(np.float32)
    A = (rng.standard_normal((200, t.spec.act_dim)) * 1.5).astype(np.float32)
    outs = []
    for s, a in zip(S, A):
        jo = j.step(jnp.asarray(s), jnp.asarray(a))
        to = t.step(T(s), T(a))
        for x, y, what in zip(jo, to, ("state", "obs", "reward", "cost", "done")):
            x = np.asarray(x)
            assert x.dtype == y.numpy().dtype, what
            if what in ("cost", "done"):
                np.testing.assert_array_equal(y.numpy(), x, err_msg=what)
            else:
                np.testing.assert_allclose(y.numpy(), x, rtol=1e-6, atol=1e-6, err_msg=what)
        outs.append(to)
    # a batch of states steps as the states one by one
    tb = t.step(T(S), T(A))
    for i, what in enumerate(("state", "obs", "reward", "cost", "done")):
        torch.testing.assert_close(tb[i], torch.stack([o[i] for o in outs]), rtol=0, atol=0, msg=what)


@pytest.mark.parametrize("name", ["Pendulum", "PointGoal"])
def test_env_reset_with_fed_uniforms(name):
    j, t = getattr(jenvs, name)(), globals()[name](device="cpu")
    key = jax.random.PRNGKey(3)
    shape = () if name == "Pendulum" else (2,)
    u = np.asarray(jax.random.uniform(key, shape))
    js, jo = j.reset(key)
    ts, to = t.reset(u=u)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    g = torch.Generator().manual_seed(0)
    s1, _ = t.reset(g)
    assert s1.shape == ts.shape and torch.isfinite(s1).all()


# ------------------------------------------------------------------- SAC
def test_sac_update_matches_reference():
    rng = np.random.default_rng(0)
    js = JSAC(3, 1, 2.0, hidden=16)
    st = js.init(jax.random.PRNGKey(0))
    batch = _batch(rng, 32, 3, 1)
    key = jax.random.PRNGKey(5)
    ts = SAC(3, 1, 2.0, hidden=16, device="cpu")
    port = ts.update(sac_from_flax(st, ts), batch, eps=_update_normals(key, 32, 1))
    _same_state(port, js.update(st, batch, key), ts)


def test_sac_act_matches_reference():
    js = JSAC(3, 1, 2.0, hidden=16)
    st = js.init(jax.random.PRNGKey(0))
    ts = SAC(3, 1, 2.0, hidden=16, device="cpu")
    p = sac_from_flax(st, ts)
    obs = np.random.default_rng(2).standard_normal((8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (8, 1)))
    _close(ts.act(p, obs, eps=eps), js.act(st, jnp.asarray(obs), key), 1e-5)
    _close(ts.act(p, obs, deterministic=True), js.act(st, jnp.asarray(obs), key, deterministic=True), 1e-5)


def test_guided_update_matches_reference():
    rng = np.random.default_rng(4)
    kw = dict(act_limit=2.0, lambda0=1.0, hidden=16)
    j = JGuided(3, 1, lambda o: jnp.full(o.shape[:-1] + (1,), 0.5),
                lambda o: (o[..., 0] > 0).astype(jnp.float32), **kw)
    t = GuidedSAC(3, 1, lambda o: torch.full(o.shape[:-1] + (1,), 0.5),
                  lambda o: (o[..., 0] > 0).to(o.dtype), device="cpu", **kw)
    st = j.init(jax.random.PRNGKey(1))
    batch = _batch(rng, 32, 3, 1)
    key = jax.random.PRNGKey(7)
    port = t.update(sac_from_flax(st, t), batch, eps=_update_normals(key, 32, 1))
    ref = j.update(st, batch, key)
    assert port.opt_actor.count == 2  # two Adam steps on the actor per guided update
    _same_state(port, ref, t)
    assert t.lam == j.lam == pytest.approx(0.995)


# ------------------------------------------------------------------ PMDB
def _dyn_data(n=64):
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((n, 3)).astype(np.float32)
    act = rng.standard_normal((n, 1)).astype(np.float32)
    return obs, act, obs + 0.1 * act, -np.sum(obs ** 2, axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def dyn_case():
    """A JAX ensemble fitted 5 epochs, its initial weights and its
    minibatch indices (``_fit_impl``'s keys, replayed)."""
    E, epochs = 3, 5
    obs, act, nobs, rew = _dyn_data()
    je = JDyn(3, 1, n_members=E, hidden=16, epochs=epochs).fit(obs, act, nobs, rew)
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    p0 = jax.vmap(lambda k: _init_mlp(k, je.sizes))(keys)
    n = len(obs)
    idx = np.stack([np.stack([np.asarray(jax.random.randint(kk, (min(256, n),), 0, n))
                              for kk in jax.random.split(k, epochs)]) for k in keys])
    return je, p0, idx, (obs, act, nobs, rew)


def test_dynamics_fit_matches_reference(dyn_case):
    je, p0, idx, data = dyn_case
    te = DynamicsEnsemble(3, 1, n_members=3, hidden=16, epochs=5, device="cpu")
    te.fit(*data, idx=idx, init=dynamics_from_jax(p0, te))
    want = dynamics_from_jax(je.params, te)
    for a, b in zip(te.params.w + te.params.b, want.w + want.b):
        _close(a, b, 1e-5)
    obs, act = data[0][:8], data[1][:8]
    jn, jr = je.predict_members(jnp.asarray(obs), jnp.asarray(act))
    tn, tr = te.predict_members(T(obs), T(act))
    _close(tn, jn, 1e-5)
    _close(tr, jr, 1e-5)


def test_pessimistic_rollout_matches_reference(dyn_case):
    je, _, _, data = dyn_case
    te = DynamicsEnsemble(3, 1, n_members=3, hidden=16, epochs=5, device="cpu")
    te.params = dynamics_from_jax(je.params, te)
    obs0, key, H, beta = data[0][:8], jax.random.PRNGKey(11), 4, 2.0
    jpol = lambda o, k: jnp.tanh(o[:, :1])
    o_seq, a_seq, r_seq = jrollout(je, jpol, jnp.asarray(obs0), key, horizon=H, beta=beta)
    # the members the JAX rollout picked, from its key schedule
    picks, kk = [], key
    for t in range(H):
        kk, _, km = jax.random.split(kk, 3)
        o = o_seq[t]
        _, rew = je.predict_members(o, jpol(o, None))
        w = jax.nn.softmax(-beta * rew, axis=0)
        picks.append(np.asarray(jax.vmap(lambda wi, k: jax.random.choice(k, je.E, p=wi), in_axes=(1, 0))(
            w, jax.random.split(km, o.shape[0]))))
    to, ta, tr = pessimistic_rollout(te, lambda o, g: torch.tanh(o[:, :1]), T(obs0), horizon=H,
                                     beta=beta, picks=np.stack(picks))
    _close(to, o_seq, 1e-5)
    _close(ta, a_seq, 1e-5)
    _close(tr, r_seq, 1e-5)


def test_drawn_picks_match_jax_choice():
    rng = np.random.default_rng(3)
    E, B = 5, 200
    w = rng.dirichlet(np.full(E, 0.7), size=B).astype(np.float32)  # (B, E)
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    want = np.array([int(jax.random.choice(k, E, p=jnp.asarray(wi))) for k, wi in zip(keys, w)])
    u = np.array([float(jax.random.uniform(k, (), dtype=jnp.float32)) for k in keys], np.float32)
    got = pick_members(T(w.T.copy()), T(u))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ Sauté, Simmer
def test_saute_matches_reference():
    j, t = JSaute(jenvs.PointGoal(), budget=2.0), SauteWrapper(PointGoal(device="cpu"), budget=2.0)
    key = jax.random.PRNGKey(0)
    js, jo = j.reset(key)
    ts, to = t.reset(u=np.asarray(jax.random.uniform(key, (2,))))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    assert t.spec.obs_dim == j.spec.obs_dim == 7
    for _ in range(60):
        a = np.asarray([0.7, 0.7], np.float32)
        js, jo, jr, jc, jd = j.step(js, jnp.asarray(a))
        ts, to, tr, tc, td = t.step(ts, T(a))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5, atol=1e-5)
        assert float(tc) == float(jc) and bool(td) == bool(jd)
        np.testing.assert_allclose(float(ts[1]), float(js[1]), rtol=1e-6, atol=1e-6)


def test_simmer_controller_matches_reference():
    j = JSimmer(target_cost=1.0, budget_min=0.5, budget_max=5.0)
    t = SimmerController(target_cost=1.0, budget_min=0.5, budget_max=5.0)
    for c in [3.0] * 5 + [0.0] * 20 + [1.5, 0.2]:
        assert t.update(c) == j.update(c)
        assert t.integral == j.integral


# ---------------------------- the JAX package's own tests, run on the port
def _collect(env, agent, state, buf, gen, n_steps=200):
    s, obs = env.reset(gen)
    ep_cost = 0.0
    for _ in range(n_steps):
        a = agent.act(state, obs[None], gen)[0]
        s, nobs, r, c, d = env.step(s, a)
        buf.add(obs.numpy(), a.numpy(), float(r), nobs.numpy(), float(d), float(c))
        ep_cost += float(c)
        obs = nobs
        if bool(d):
            s, obs = env.reset(gen)
    return ep_cost


def test_sac_improves_pendulum():
    env = Pendulum(device="cpu")
    agent = SAC(env.spec.obs_dim, env.spec.act_dim, env.spec.act_limit, hidden=32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = agent.init(gen)
    buf = ReplayBuffer(env.spec.obs_dim, env.spec.act_dim, 20_000)
    rng = np.random.default_rng(0)

    def eval_return(state, n=100):
        s, obs = env.reset(torch.Generator().manual_seed(42))
        total = 0.0
        for _ in range(n):
            a = agent.act(state, obs[None], deterministic=True)[0]
            s, obs, r, c, d = env.step(s, a)
            total += float(r)
        return total

    r0 = eval_return(state)
    for it in range(6):
        _collect(env, agent, state, buf, torch.Generator().manual_seed(it), 150)
        for u in range(60):
            state = agent.update(state, buf.sample(rng, 128), generator=gen)
    r1 = eval_return(state)
    assert np.isfinite(r1)
    assert r1 > r0 - 50  # learning is at least not diverging; usually improves


def test_saute_budget_dynamics():
    env = SauteWrapper(PointGoal(device="cpu"), budget=2.0)
    aug_state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs.shape == (env.spec.obs_dim,)
    s, z_hist = aug_state, []
    for _ in range(60):
        s, obs, r, c, d = env.step(s, T([0.7, 0.7]))  # towards hazard then goal
        z_hist.append(float(s[1]))
    assert min(z_hist) < 1.0  # budget consumed at some point


def test_simmer_controller():
    ctl = SimmerController(target_cost=1.0, budget_min=0.5, budget_max=5.0)
    b0 = ctl.budget
    for _ in range(5):
        b = ctl.update(observed_episode_cost=3.0)  # overspending
    assert b < b0
    for _ in range(20):
        b = ctl.update(observed_episode_cost=0.0)  # very safe
    assert b > ctl.budget_min


def test_dynamics_ensemble_and_pessimism():
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((256, 3)).astype(np.float32)
    act = rng.standard_normal((256, 1)).astype(np.float32)
    next_obs = obs + 0.1 * act  # simple linear dynamics
    reward = -np.sum(obs ** 2, axis=1).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    ens = DynamicsEnsemble(3, 1, n_members=4, hidden=32, epochs=150, device="cpu")
    ens.fit(obs, act, next_obs, reward, generator=gen)
    nxt, rew = ens.predict_members(T(obs[:8]), T(act[:8]))
    assert nxt.shape == (4, 8, 3)
    assert float(torch.mean((nxt.mean(0) - T(next_obs[:8])) ** 2)) < 0.5

    policy = lambda o, g: torch.zeros((o.shape[0], 1))
    o_seq, a_seq, r_pess = pessimistic_rollout(ens, policy, T(obs[:8]), horizon=4, beta=5.0,
                                               generator=torch.Generator().manual_seed(0))
    _, _, r_mean = pessimistic_rollout(ens, policy, T(obs[:8]), horizon=4, beta=0.0,
                                       generator=torch.Generator().manual_seed(0))
    assert o_seq.shape == (4, 8, 3)
    # pessimistic belief yields lower (or equal) imagined returns
    assert float(r_pess.mean()) <= float(r_mean.mean()) + 0.1


def test_guided_sac_blends_guide():
    env = Pendulum(device="cpu")
    agent = GuidedSAC(env.spec.obs_dim, env.spec.act_dim,
                      lambda o: torch.full(o.shape[:-1] + (1,), 0.5), lambda o: torch.ones(o.shape[:-1]),
                      act_limit=env.spec.act_limit, lambda0=1.0, hidden=32, device="cpu")
    state = agent.init(torch.Generator().manual_seed(0))
    a = agent.act(state, torch.zeros((4, env.spec.obs_dim)), torch.Generator().manual_seed(1))
    # λ=1 in-region → behavior equals the guide exactly
    np.testing.assert_allclose(a.numpy(), 0.5, atol=1e-5)
    buf = ReplayBuffer(env.spec.obs_dim, env.spec.act_dim, 1000)
    rng = np.random.default_rng(0)
    for _ in range(50):
        buf.add(rng.standard_normal(3), rng.standard_normal(1), 0.0, rng.standard_normal(3), 0.0)
    state = agent.update(state, buf.sample(rng, 32), generator=torch.Generator().manual_seed(2))
    assert agent.lam < 1.0


def test_rl_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: Pendulum(), lambda: PointGoal(), lambda: SAC(3, 1),
                 lambda: DynamicsEnsemble(3, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
