"""NAP's PPO in hebo_tpu_torch (``meta/ppo.py``) against hebo_tpu, at world
sizes 1 and 2.

The port's ranks are spawned processes (gloo over a ``FileStore``, one
thread a rank; each world spawned once, with its own timeout), which
import this module: JAX and the JAX package are imported only inside the
parent's helpers.  The JAX package runs its world-2 training on a 2-device
CPU mesh (``shard_map`` with a ``pmean`` of the gradient), and its random
draws (task draws, the actions' Gumbel noise, the per-device keys) are
replayed and fed to the port.

Tolerances (float32 on both sides):
* ``filter_action_logits`` at top-k / top-p 0 / 3 / 0.7 (and k above the
  candidate count) and ``_gae``: 1e-6;
* ``rollout_episodes`` from carried-across flax params and fed draws
  (also with ``n_init``, ``span_reward`` and ``top_k``): the transitions
  within 1e-5;
* one ``ppo_train`` iteration (2 Adam steps) from the carried params, at
  world 1 and world 2: the params within 1e-4 relative (of each tensor's
  largest |value|), but the attention's key-projection biases and the logit
  head's bias, whose gradient is exactly zero (softmax is shift-invariant,
  per query and over the candidates), so that each package's Adam moves
  them by rounding only: those within Adam's reach (lr per step) of their
  start in both packages (as tests/test_torch_nap.py); the mean regret
  1e-5 absolute (it is a difference of values near 1);
* world 2's averaged gradient against the mean of world 1's gradients on
  each rank's episodes: 1e-5 relative;
* two ``pretrain_policy`` steps with fed tasks and context sizes: params
  1e-4 relative (the same exception), losses 1e-5.
"""

import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

DX, D_MODEL, HEADS, LAYERS = 2, 16, 2, 1
B, C, T = 4, 8, 3
ROLLOUT_KW = [dict(), dict(n_init=2, span_reward=True, top_k=3)]
FILTERS = [(0, 1.0), (3, 1.0), (0, 0.7), (3, 0.7), (100, 0.5)]
SPAWN_TIMEOUT = 120  # seconds per world
# parameters whose gradient is exactly zero (see above)
ZERO_GRAD = (".attn.key.bias", "logit_head.bias")


# ------------------------------------------------------------ in the ranks
def _policy(inp):
    from hebo_tpu_torch.meta.ppo import NAPPolicy

    pol = NAPPolicy(DX, D_MODEL, HEADS, LAYERS, generator=torch.Generator().manual_seed(0))
    pol.load_state_dict({k: torch.as_tensor(v) for k, v in inp["sd"].items()})
    return pol


def _case_pure(inp, mesh):
    from hebo_tpu_torch.meta.ppo import _gae, filter_action_logits

    lg = torch.as_tensor(inp["logits"])
    adv, ret = _gae(torch.as_tensor(inp["rewards"]), torch.as_tensor(inp["values"]))
    return dict(filters=[filter_action_logits(lg, k, p).numpy() for k, p in FILTERS],
                adv=adv.numpy(), ret=ret.numpy())


def _case_rollout(inp, mesh):
    from hebo_tpu_torch.meta.ppo import rollout_episodes

    pol = _policy(inp)
    out = []
    for kw, d in zip(ROLLOUT_KW, inp["rollout_draws"]):
        trans, _, regret, _ = rollout_episodes(pol, batch=B, n_cand=C, horizon=T, draws=d, **kw)
        out.append(([t.numpy() for t in trans], float(regret)))
    return out


def _case_ppo(inp, mesh):
    from hebo_tpu_torch.meta.ppo import ppo_train
    from hebo_tpu_torch.parallel.sharded import mesh_rank, mesh_size

    pol, world, r = _policy(inp), mesh_size(mesh), mesh_rank(mesh)
    trace = []
    params, regrets = ppo_train(pol, batch=B, n_cand=C, horizon=T, n_iters=1, mesh=mesh,
                                draws=lambda it: inp["ppo_draws"][world][r], trace=trace)
    out = dict(params={k: v.numpy() for k, v in params.items()}, regrets=regrets,
               grad0={k: v.numpy() for k, v in trace[0][1].items()})
    if world == 1:  # one epoch on each world-2 rank's episodes
        out["grads_by_rank"] = []
        for d in inp["ppo_draws"][2]:
            tr = []
            ppo_train(pol, batch=B, n_cand=C, horizon=T, n_iters=1, n_epochs=1, draws=lambda it: d,
                      trace=tr)
            out["grads_by_rank"].append({k: v.numpy() for k, v in tr[0][1].items()})
    return out


CASES = {"pure": _case_pure, "rollout": _case_rollout, "ppo": _case_ppo}


def _rank_main(rank, world, store, in_path, out_dir):
    """One rank: the gloo group, the mesh, every case."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        from hebo_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device="cpu", axis="dp")
        inp = torch.load(in_path, weights_only=False)
        torch.save({c: f(inp, mesh) for c, f in CASES.items()}, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(world, inputs, tmp: Path, timeout=SPAWN_TIMEOUT):
    """Every case on ``world`` spawned ranks; their results, by rank.
    Ranks still running at ``timeout`` seconds are killed and the test
    fails."""
    d = tmp / f"world{world}"
    d.mkdir()
    torch.save(inputs, d / "in.pt")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(world, str(d / "store"), str(d / "in.pt"), str(d)), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.time())):
            if time.time() >= deadline:
                pytest.fail(f"world {world}: ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------- the parent
@pytest.fixture(autouse=True, scope="module")
def _quick_jax_compiles():
    """The JAX package's compiles at XLA's lowest backend optimization level
    (as tests/test_torch_mcbo.py; restored before conftest's teardown)."""
    import jax

    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _task_draws(key, batch, n):
    """The random numbers of ``hebo_tpu.meta.nap.sample_gp_tasks(key, ...)``."""
    import jax
    import jax.numpy as jnp

    from hebo_tpu_torch.meta.nap import TaskDraws

    kx, kl, kf, kn, _ = jax.random.split(key, 5)
    t = lambda a: torch.tensor(np.asarray(a))
    return TaskDraws(X=t(jax.random.uniform(kx, (batch, n, DX), jnp.float32, -1.0, 1.0)), codes=None,
                     log_ls=t(jax.random.uniform(kl, (batch, 1, 1, 1), jnp.float32, -1.5, 0.5)),
                     z=t(jax.random.normal(kf, (batch, n), jnp.float32)),
                     eps=t(jax.random.normal(kn, (batch, n, 1), jnp.float32)))


def _rollout_draws(key):
    """``rollout_episodes(key)``'s draws (ppo.py:162, :175, :210)."""
    import jax
    import jax.numpy as jnp

    from hebo_tpu_torch.meta.ppo import RolloutDraws

    kt, kr = jax.random.split(key)
    g = [np.asarray(jax.random.gumbel(k, (B, C), jnp.float32)) for k in jax.random.split(kr, T)]
    return RolloutDraws(_task_draws(kt, B, C), torch.tensor(np.stack(g)))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's results, the ranks' inputs, and both worlds' runs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from hebo_tpu.meta import ppo as jppo
    from hebo_tpu_torch.meta.ppo import NAPPolicy, policy_from_flax

    rng = np.random.default_rng(0)
    jp = jppo.NAPPolicy(dim_x=DX, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS)
    Xd = jnp.zeros((1, C, DX))
    params = jp.init(jax.random.PRNGKey(1), Xd, jnp.zeros((1, C, 1)), Xd, jnp.ones((1, C), bool))
    # widen the init a little so that every layer's output matters
    params = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3), a.shape),
                          params)
    pol = NAPPolicy(DX, D_MODEL, HEADS, LAYERS, generator=torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in policy_from_flax(params, pol).items()}
    inputs = dict(sd=sd, logits=rng.standard_normal((3, 6)).astype(np.float32),
                  rewards=rng.uniform(0, 1, (5, 4)).astype(np.float32),
                  values=rng.standard_normal((5, 4)).astype(np.float32))
    out = dict(filters=[np.asarray(jppo.filter_action_logits(jnp.asarray(inputs["logits"]), k, p))
                        for k, p in FILTERS])
    out["adv"], out["ret"] = map(np.asarray, jppo._gae(jnp.asarray(inputs["rewards"]),
                                                       jnp.asarray(inputs["values"])))
    key = jax.random.PRNGKey(5)
    inputs["rollout_draws"] = [_rollout_draws(key) for _ in ROLLOUT_KW]
    out["rollout"] = []
    for kw in ROLLOUT_KW:
        trans, _, regret, _ = jppo.rollout_episodes(jp, params, key, batch=B, n_cand=C, horizon=T,
                                                    **kw)
        out["rollout"].append(([np.asarray(t) for t in trans], float(regret)))
    # ppo_train(key): k0 for the init, then one iteration's key (ppo.py:265, :342)
    kp = jax.random.PRNGKey(7)
    _, k_it = jax.random.split(jax.random.split(kp)[1])
    inputs["ppo_draws"] = {1: [_rollout_draws(k_it)],
                           2: [_rollout_draws(k) for k in jax.random.split(k_it, 2)]}
    out["ppo"] = {}
    for world, mesh in ((1, None), (2, Mesh(np.array(jax.devices()[:2]), ("dp",)))):
        pj, rj = jppo.ppo_train(jp, kp, n_iters=1, batch=B, n_cand=C, horizon=T, init_params=params,
                                mesh=mesh)
        out["ppo"][world] = ({k: v.numpy() for k, v in policy_from_flax(pj, pol).items()},
                             np.asarray(rj))
    tmp = tmp_path_factory.mktemp("ppo")
    return inputs, out, {1: spawn(1, inputs, tmp), 2: spawn(2, inputs, tmp)}


def _adam_reach(got, want, start, steps, lr):
    """A zero-gradient parameter: both packages within Adam's reach of its start."""
    for v in (got, want):
        assert np.abs(np.asarray(v) - np.asarray(start)).max() <= steps * lr * (1 + 1e-3)


@pytest.mark.parametrize("world", [1, 2])
def test_filter_action_logits_and_gae(ref, world):
    _, out, runs = ref
    for res in runs[world]:
        r = res["pure"]
        for got, want in zip(r["filters"], out["filters"]):
            _close(got, want, 1e-6)
        _close(r["adv"], out["adv"], 1e-6)
        _close(r["ret"], out["ret"], 1e-6)


@pytest.mark.parametrize("world", [1, 2])
def test_rollout_with_fed_draws(ref, world):
    _, out, runs = ref
    for res in runs[world]:
        for (got, g_regret), (want, w_regret) in zip(res["rollout"], out["rollout"]):
            np.testing.assert_array_equal(got[0], want[0])  # the actions
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g_regret, w_regret, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("world", [1, 2])
def test_one_ppo_update_matches(ref, world):
    inputs, out, runs = ref
    want, w_regrets = out["ppo"][world]
    for res in runs[world]:
        r = res["ppo"]
        for k, v in want.items():
            if any(z in k for z in ZERO_GRAD):
                _adam_reach(r["params"][k], v, inputs["sd"][k], 2, 3e-4)
            else:
                _close(r["params"][k], v, 1e-4)
        np.testing.assert_allclose(r["regrets"], w_regrets, rtol=1e-5, atol=1e-5)
    if world == 2:  # every rank holds the same parameters
        a, b = (res["ppo"]["params"] for res in runs[2])
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_world_2_gradient_is_the_mean_of_the_ranks_gradients(ref):
    _, _, runs = ref
    g2 = runs[2][0]["ppo"]["grad0"]
    ga, gb = runs[1][0]["ppo"]["grads_by_rank"]
    for k in g2:
        _close(g2[k], 0.5 * (ga[k] + gb[k]), 1e-5)


def test_policy_from_flax_uses_every_leaf():
    import jax
    import jax.numpy as jnp

    from hebo_tpu.meta import ppo as jppo
    from hebo_tpu_torch.meta.ppo import NAPPolicy, policy_from_flax

    for single in (False, True):
        jp = jppo.NAPPolicy(dim_x=DX, d_model=D_MODEL, n_heads=HEADS, n_layers=2,
                            single_stream=single)
        pol = NAPPolicy(DX, D_MODEL, HEADS, 2, single_stream=single)
        Xd = jnp.zeros((1, C, DX))
        args = (Xd, jnp.zeros((1, C, 1)), Xd, jnp.ones((1, C), bool))
        p = jp.init(jax.random.PRNGKey(2), *args, return_mu=True)
        sd = policy_from_flax(p, pol)
        assert set(sd) == {k for k, _ in pol.named_parameters()}
        assert len(sd) == len(jax.tree_util.tree_leaves(p))
        pol.load_state_dict(sd)
        lg, v, mu = jp.apply(p, *args, return_mu=True)
        with torch.no_grad():
            tl, tv, tmu = pol(*(torch.tensor(np.asarray(a)) for a in args), return_mu=True)
        for got, want in ((tl, lg), (tv, v), (tmu, mu)):
            _close(got.numpy(), want, 1e-5)
        # a tree made without return_mu keeps the policy's own μ head
        p0 = jp.init(jax.random.PRNGKey(2), *args)
        assert set(policy_from_flax(p0, pol)) == set(sd)
        extra = {"params": dict(p["params"], Dense_99={"kernel": np.zeros((16, 1))})}
        with pytest.raises(ValueError, match="not used"):
            policy_from_flax(extra, pol)
        missing = {"params": {k: v for k, v in p["params"].items() if k != "LayerNorm_1"}}
        with pytest.raises(KeyError):
            policy_from_flax(missing, pol)


def test_pretrain_steps_with_fed_draws():
    """Two ``pretrain_policy`` steps from the JAX package's init (its key
    k0) with its tasks and context sizes (ppo.py:394-436)."""
    import jax

    from hebo_tpu.meta import ppo as jppo
    from hebo_tpu_torch.meta.ppo import NAPPolicy, policy_from_flax, pretrain_policy

    jp = jppo.NAPPolicy(dim_x=DX, d_model=D_MODEL, n_heads=HEADS, n_layers=LAYERS)
    key, kw = jax.random.PRNGKey(9), dict(n_iters=2, batch=B, n_cand=C, n_obs_range=(2, 5))
    pj, lj = jppo.pretrain_policy(jp, key, **kw)
    k0, k = jax.random.split(key)
    Xd = jax.numpy.zeros((1, C, DX))
    p0 = jp.init(k0, Xd, jax.numpy.zeros((1, C, 1)), Xd, jax.numpy.ones((1, C), bool),
                 return_mu=True)
    fed = []
    for _ in range(2):
        k, ks = jax.random.split(k)
        k1, k2 = jax.random.split(ks)
        fed.append((_task_draws(k1, B, C), torch.tensor(np.asarray(jax.random.randint(k2, (B, 1), 2, 6)))))
    pol = NAPPolicy(DX, D_MODEL, HEADS, LAYERS)
    pol.load_state_dict(policy_from_flax(p0, pol))
    start = {k_: v.detach().clone() for k_, v in pol.named_parameters()}
    pt, lt = pretrain_policy(pol, draws=lambda s: fed[s], **kw)
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=1e-5)
    for k_, v in policy_from_flax(pj, pol).items():
        if any(z in k_ for z in ZERO_GRAD):
            _adam_reach(pt[k_].numpy(), v.numpy(), start[k_].numpy(), 2, 1e-3)
        else:
            _close(pt[k_].numpy(), v.numpy(), 1e-4)


def test_ppo_train_axis_must_name_the_mesh_axis():
    """``ppo_train``'s ``axis`` is checked against the mesh's one axis, as
    ``GP(mesh_axis=)`` is: a name the mesh lacks raises before any work."""
    from types import SimpleNamespace

    from hebo_tpu_torch.meta.ppo import NAPPolicy, ppo_train

    pol = NAPPolicy(DX, D_MODEL, HEADS, LAYERS)
    with pytest.raises(ValueError, match="'dp' is not an axis"):
        ppo_train(pol, mesh=SimpleNamespace(mesh_dim_names=("pop",)), n_iters=1)
