"""The mesh paths of hebo_tpu_torch (slice 9: ``parallel/sharded.py``,
``ops/block_chol.py``, the sharded samplers, ``GP(mesh=)`` and
``HEBO(mesh=)``) against hebo_tpu on its virtual CPU mesh.

The port's ranks are processes: each world size is spawned once
(``torch.multiprocessing``, gloo over a ``FileStore``, one thread a rank),
every rank runs every case of that world and saves its results, and the
parent compares them with the JAX package's, computed here on a mesh of as
many virtual CPU devices (tests/conftest.py makes 8).  The spawned ranks
import this module, so JAX and the JAX package are imported only inside
the parent's helpers, and each spawn has its own timeout.

Tolerances (float32 on both sides):
* block Cholesky at (N, block) = (256, 64) and (128, 32), worlds 2 and 4:
  max |ΔL| ≤ 1e-4 · max |L| against the JAX factor; the solve's residual
  max |K x − b| ≤ 1e-4 · max |b|;
* the ladder: a planted −1e-4 eigenvalue fails rung 1 and rung 2 rescues
  it, L within 2e-3 of the float64 factor at rung 2's jitter (the JAX
  test's bound); a NaN row fails both rungs: ok False, μ = 0, σ² = 1;
* ``GP(mesh=, max_cholesky_size=256)`` on 600 points with the JAX mesh
  GP's fitted samples: μ within 1e-4 relative (of the largest |μ|), σ²
  within 1e-4 relative plus 1e-4 of the prior variance k(x, x)·y_std²
  (σ² = k(x, x) − kᵀK⁻¹k loses float32 digits to that cancellation); the
  factor L within 1e-4 · max |L|;
* ``_tree_select_best`` with a planted tie: JAX's average, 1e-6;
  ``select_chain``: the first argmin; ``sharded_suggest_step``: finite
  islands in the box, the same on every rank; the fused route's fit from JAX's
  draws picks JAX's chain (its params within pSGLD's 2e-3, as
  tests/test_torch_gp.py);
* the islands at world 2 on JAX's fitted state with its per-island draws:
  JAX's packed output within 1e-5;
* SMC at worlds 2 and 4: the port's world-1 run and JAX's
  ``smc_sample_sharded`` on the same draws, 1e-5; HMC's chains equal at
  worlds 1, 2 and 4 (1e-5), R̂ JAX's formula on those chains;
* ``HEBO(mesh=)`` at world 2 on ``test_hebo_mesh_end_to_end``'s loop: the
  best y beats the init phase's, and every rank's records are equal.
"""

import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

SPACE = [{"name": f"x{i}", "type": "num", "lb": -5.0, "ub": 5.0} for i in range(3)]
BLOCKS = [(256, 64), (128, 32)]
SMC_KW = dict(n_stages=8, n_mala=2, mala_step=0.15)
N_SMC, N_HMC = 32, 8
HMC_KW = dict(n_warmup=16, n_samples=8, n_leapfrog=4)
# the fused suggest: bucket 16, 2 restarts a rank, 6 pSGLD steps, pop 16 in
# islands of 8, 4 generations in 2 rounds
FUSED = dict(n=12, n_pad=16, R=2, steps=6, pop=16, iters=4, mig=2, seed=12, kappa=2.0)
SPAWN_TIMEOUT = 150  # seconds per world


# ------------------------------------------------------------ in the ranks
def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, 24)).astype(np.float32)
    return (A @ A.T + n * np.eye(n)).astype(np.float32)


def _planted(n=256):
    """test_mesh_large_n.py:87's matrix: eigenvalues −1e-4 .. 3."""
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    K = (Q * np.linspace(-1e-4, 3.0, n)[None, :]) @ Q.T
    return np.asarray((K + K.T) / 2, np.float32)


def _target(xp):
    """test_sharded_inference.py's 2-D Gaussian, over a particle batch."""
    prec = np.linalg.inv(np.array([[0.5, 0.6], [0.6, 2.0]]))
    P = xp.asarray(prec, dtype=xp.float32)
    mu = xp.asarray([1.0, -2.0], dtype=xp.float32)

    def logp(q):
        d = q["x"] - mu
        return -0.5 * ((d @ P) * d).sum(-1)

    log_prior = lambda q: -0.5 * ((q["x"] / 3.0) ** 2).sum(-1)
    return logp, log_prior, (lambda q: logp(q) - log_prior(q))


def _case_block(inp, mesh):
    from hebo_tpu_torch.ops.block_chol import block_chol_solve_sharded, block_cholesky_sharded
    from hebo_tpu_torch.parallel.sharded import all_gather

    out = {}
    for N, block in BLOCKS:
        K = torch.as_tensor(_spd(N, seed=N + block))
        L = all_gather(block_cholesky_sharded(K, mesh, block=block, jitter=0.0), mesh)
        b = torch.as_tensor(np.random.default_rng(1).standard_normal((N, 4)).astype(np.float32))
        x = block_chol_solve_sharded(K, b, mesh, block=block, jitter=0.0)
        out[(N, block)] = (L.numpy(), (K @ x - b).abs().max().item() / b.abs().max().item())
    return out


def _case_ladder(inp, mesh):
    from hebo_tpu_torch.models.gp.gp import GPCore, make_data
    from hebo_tpu_torch.ops.block_chol import block_cholesky_sharded, block_ladder_factor
    from hebo_tpu_torch.parallel.sharded import all_gather

    K = torch.as_tensor(_planted())
    rung1 = all_gather(block_cholesky_sharded(K, mesh, block=64, jitter=1e-6), mesh)
    L, W, ok = block_ladder_factor(K, mesh, block=64)
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    core = GPCore(numeric_dims=(0, 1, 2), cat_dims=(), num_categories=(), n_steps=1,
                  max_cholesky_size=128)
    core.mesh = mesh
    data = make_data(X, X.sum(1, keepdims=True), core.numeric_dims, 512, "cpu")
    X_bad = data.X.clone()
    X_bad[5, 0] = float("nan")  # an active row, after the loader's finite-row filter
    data = data._replace(X=X_bad)
    p = core.init_params(data, 1, torch.Generator().manual_seed(0))
    cache = core.posterior_cache_batched(p, data)
    mu, var = core.predict_scaled(p, cache, data, torch.as_tensor(rng.uniform(-1, 1, (16, 3)),
                                                                  dtype=torch.float32))
    return dict(rung1_finite=bool(torch.isfinite(rung1).all()), L=L.numpy(), W=W.numpy(),
                ok=bool(ok), bad_ok=cache.ok.tolist(), mu=mu.numpy(), var=var.numpy())


def _case_gp(inp, mesh):
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp import data_from_jax, params_from_jax

    m = get_model("gp", DesignSpace(SPACE), device="cpu", mesh=mesh, max_cholesky_size=256)
    m.samples = params_from_jax(inp["gp_samples"], device="cpu")
    m.data = data_from_jax(inp["gp_data"], device="cpu")
    m.caches = m.core.posterior_cache_batched(m.samples, m.data)
    mu, var = m.predict(inp["gp_Xq"])
    return dict(mu=mu, var=var, L=m.caches.L.numpy(), ok=m.caches.ok.tolist())


def _case_select(inp, mesh):
    from hebo_tpu_torch.parallel.sharded import _tree_select_best, mesh_rank, select_chain

    r = mesh_rank(mesh)
    tree = {"a": torch.full((1, 3), float(r)), "b": torch.full((1,), 10.0 * r + 1)}
    best = _tree_select_best(tree, torch.tensor([inp["tie_losses"][r]]), mesh)
    losses = torch.as_tensor(inp["chain_losses"][r])  # (R,)
    pf = {"a": torch.arange(2.0)[:, None] + 10 * r}  # chain i of rank r: 10 r + i
    samples = {"a": (torch.arange(2.0)[None, :, None] + 10 * r).expand(3, 2, 1)}
    pf, samples = select_chain((pf, samples), losses, mesh, (0, 1))
    return dict(tie={k: v.numpy() for k, v in best.items()}, pf=pf["a"].numpy(),
                samples=samples["a"].numpy(), step=_suggest_step(mesh))


def _suggest_step(mesh):
    """``sharded_suggest_step``: one chain a rank, islands of 8, 4 generations."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.acq_optimizers.evolution import _space_meta
    from hebo_tpu_torch.acquisitions.acq import MACE, AcqParams
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp.gp import make_data
    from hebo_tpu_torch.parallel.sharded import (mesh_rank, mesh_size, rank_generator,
                                                 sharded_suggest_step)

    space = DesignSpace(SPACE)
    X = space.sobol_sample_opt(12, seed=0)
    model = get_model("gp", space, device="cpu", num_epochs=5)
    data = make_data(X, (X ** 2).sum(1, keepdims=True), (0, 1, 2), 16, "cpu")
    init = torch.as_tensor(space.sobol_sample_opt(8 * mesh_size(mesh), seed=1), dtype=torch.float32)
    r = mesh_rank(mesh)
    Xg, Fg, best = sharded_suggest_step(mesh, model, MACE(), _space_meta(space), data,
                                        AcqParams(tau=0.0, kappa=2.0), init[8 * r:8 * r + 8],
                                        n_gens=4, migrate_every=2,
                                        generator=rank_generator(0, mesh, "cpu"))
    return dict(X=Xg.numpy(), F=Fg.numpy(), log_ls=best.log_ls.numpy())


def _fused_hebo(mesh):
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.acquisitions.acq import MACE
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.optimizers import HEBO

    space = DesignSpace(SPACE)
    opt = HEBO(space, mesh=mesh, pop=FUSED["pop"], iters=FUSED["iters"],
               migrate_every=FUSED["mig"], model_config={"num_epochs": FUSED["steps"],
                                                         "n_restarts": FUSED["R"]}, device="cpu")
    opt.model = get_model("gp", space, device="cpu", **opt.model_config)
    opt._acq = MACE()
    return opt


def _case_fused(inp, mesh):
    """The fused route's fit on JAX's chain draws (this rank's chains), and
    the islands on JAX's fitted state with JAX's per-island draws."""
    from hebo_tpu_torch.acq_optimizers.evolution import GenDraws, _space_meta, meta_tensors
    from hebo_tpu_torch.models.gp import cache_from_jax, data_from_jax, params_from_jax
    from hebo_tpu_torch.parallel.sharded import all_gather, island_evolve, mesh_rank, mesh_size

    r, world = mesh_rank(mesh), mesh_size(mesh)
    opt = _fused_hebo(mesh)
    mt = meta_tensors(_space_meta(opt.space), "cpu")
    inputs = torch.as_tensor(inp["host"])
    P_loc = FUSED["pop"] // world
    z = torch.as_tensor(inp["z"])
    isl = [[GenDraws(*map(torch.as_tensor, g)) for g in rnd] for rnd in inp["islands"][r]]
    island_draws = lambda rnd, g: isl[rnd][g]
    init, steps = inp["chains"][r]
    fit_draws = ((torch.as_tensor(init[0]), torch.as_tensor(init[1])),
                 lambda i: [torch.as_tensor(t) for t in steps[i]])
    with torch.no_grad():
        packed, (_, pf, _, _) = opt._sharded_program(FUSED["n_pad"], mt, inputs, z, None, None,
                                                     fit_draws=fit_draws,
                                                     island_draws=island_draws)
        # the islands alone, on JAX's fitted state
        samples = params_from_jax(inp["j_samples"], device="cpu")
        state = (samples, cache_from_jax(inp["j_caches"], device="cpu"), data_from_jax(inp["j_data"], device="cpu"))
        data, kappa, init_pop = opt._unpack(inputs, FUSED["n_pad"], FUSED["pop"])
        xb, pr = opt._incumbent(state, params_from_jax(inp["j_pf"], device="cpu"), kappa, z, None)
        init_pop[0] = xb[0]
        X, F = island_evolve(init_pop[r * P_loc:(r + 1) * P_loc],
                             lambda Xc: opt._acq.eval_pure(opt.model, state, pr, Xc), mt,
                             FUSED["iters"], FUSED["mig"], mesh, draws=island_draws)
        mu, var = opt.model.predict_pure(state, X)
        islands = all_gather(torch.cat([X, F, mu, var], 1), mesh)
    return dict(pf={k: v.numpy() for k, v in pf._asdict().items() if v is not None},
                packed=packed.numpy(), islands=islands.numpy())


def _case_samplers(inp, mesh):
    from hebo_tpu_torch.models.gp.inference import (HMCDraws, hmc_sample_sharded,
                                                    smc_sample_sharded)
    from hebo_tpu_torch.parallel.sharded import mesh_size

    logp, log_prior, log_lik = _target(torch)
    world = mesh_size(mesh)
    u, moves = inp["smc_draws"][world]
    draws = lambda s: (u[s], moves[s])
    parts, logZ = smc_sample_sharded(log_prior, log_lik, {"x": torch.as_tensor(inp["parts0"])},
                                     None, mesh, draws=draws, **SMC_KW)
    hd = HMCDraws(*(torch.as_tensor(t) for t in inp["hmc_draws"]))
    s, acc, rhat = hmc_sample_sharded(logp, {"x": torch.as_tensor(inp["q0"])}, None, mesh,
                                      n_chains=N_HMC, draws=hd, **HMC_KW)
    return dict(parts=parts["x"].numpy(), logZ=float(logZ), hmc=s["x"].numpy(),
                acc=acc.numpy(), rhat=float(rhat))


def _case_hebo(inp, mesh):
    """test_hebo_mesh_end_to_end's loop (tests/test_mesh_hebo.py:34-47)."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.optimizers import HEBO

    opt = HEBO(DesignSpace(SPACE), mesh=mesh, pop=32, iters=12, migrate_every=4,
               model_config={"num_epochs": 15, "n_restarts": 1}, scramble_seed=3, device="cpu")
    for _ in range(10):
        rec = opt.suggest(4)
        opt.observe(rec, (rec.values.astype(float) ** 2).sum(1, keepdims=True))
    return dict(X=opt.X.values.astype(float), y=opt.y, rand_sample=opt.rand_sample,
                best_y=float(opt.best_y))


CASES = {"block": _case_block, "ladder": _case_ladder, "gp": _case_gp, "select": _case_select,
         "fused": _case_fused, "samplers": _case_samplers, "hebo": _case_hebo}


def _rank_main(rank, world, store, in_path, out_dir, cases):
    """One rank: the gloo group, the mesh, every case of ``cases``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        from hebo_tpu_torch.parallel import make_mesh

        mesh = make_mesh(device="cpu")
        inp = torch.load(in_path, weights_only=False)
        out = {c: CASES[c](inp, mesh) for c in cases}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(world, inputs, cases, tmp: Path, timeout=SPAWN_TIMEOUT, main=None):
    """Run ``cases`` on ``world`` spawned ranks; their results, by rank.
    Ranks still running at ``timeout`` seconds are killed and the test
    fails.  ``main`` (default ``_rank_main``) is the ranks' function, of
    ``_rank_main``'s arguments; it must save ``rank{r}.pt`` in its out
    directory."""
    d = tmp / f"world{world}"
    d.mkdir()
    torch.save(inputs, d / "in.pt")
    ctx = torch.multiprocessing.start_processes(
        main or _rank_main, args=(world, str(d / "store"), str(d / "in.pt"), str(d), tuple(cases)),
        nprocs=world, join=False, start_method="spawn")
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


def _jmesh(n, axis="pop"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _evo_draws(key, n_gens, P, D):
    """The random numbers of ``hebo_tpu``'s ``evolve_raw`` (evolution.py:158)."""
    import jax

    out, k = [], key
    for _ in range(n_gens):
        k, k_sel, k_sbx, k_mut, k_cat = jax.random.split(k, 5)
        u = lambda kk: np.asarray(jax.random.uniform(kk, (P, D)))
        s1, s2, s3 = jax.random.split(k_sbx, 3)
        m1, m2 = jax.random.split(k_mut)
        c1, c2, c3 = jax.random.split(k_cat, 3)
        out.append((np.asarray(jax.random.randint(k_sel, (2, P), 0, P)), u(s1), u(s2), u(s3),
                    u(m1), u(m2), u(c1), u(c2), u(c3)))
    return out


def _np(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def _fused_reference(world):
    """JAX's ``make_fused_suggest_sharded`` at FUSED's sizes on a mesh of
    ``world`` devices, the port's packed inputs, and every draw of the
    program by rank (sharded.py:236-274's key schedule)."""
    import jax
    import jax.numpy as jnp

    from hebo_tpu.acquisitions.acq import MACE as JMACE
    from hebo_tpu.acq_optimizers.evolution import _space_meta as jmeta
    from hebo_tpu.design_space import DesignSpace as JSpace
    from hebo_tpu.models.gp.gp import GPCore as JCore
    from hebo_tpu.parallel.sharded import make_fused_suggest_sharded

    f = FUSED
    space, D = JSpace().parse(SPACE), len(SPACE)
    core = JCore(numeric_dims=(0, 1, 2), cat_dims=(), num_categories=(), n_steps=f["steps"])
    fused = make_fused_suggest_sharded(_jmesh(world), core, JMACE(), jmeta(space),
                                       n_restarts=f["R"], iters=f["iters"], pop=f["pop"], n_obj=3,
                                       migrate_every=f["mig"])
    rng = np.random.default_rng(0)
    n, n_pad = f["n"], f["n_pad"]
    X = rng.uniform(-5, 5, (n, D)).astype(np.float32)
    y = (X ** 2).sum(1)
    ys = ((y - y.mean()) / y.std()).astype(np.float32)
    big = np.zeros((n_pad, D + 2), np.float32)
    big[:n, :D], big[:n, D], big[:n, D + 1] = X, ys, 1.0
    lb, span = X.min(0), X.max(0) - X.min(0)
    scal = np.concatenate([lb, span, [0.0, 1.0, f["kappa"], 1e-4, f["seed"]]]).astype(np.float32)
    init_pop = space.sobol_sample_opt(f["pop"], seed=f["seed"]).astype(np.float32)
    packed, data, pf, samples, caches = fused(jnp.asarray(big), jnp.asarray(scal),
                                              jnp.asarray(init_pop))
    host = np.concatenate([big[:, :D].ravel(), big[:, D], big[:, D + 1], lb, span,
                           [0.0, 1.0, f["kappa"]], init_pop.ravel()]).astype(np.float32)
    # the draws: chains k1 → init, k2 → pSGLD; islands fold_in(k_evo, i)
    k_fit, k_evo, k_jit = jax.random.split(jax.random.PRNGKey(int(f["seed"])), 3)
    keys = jax.random.split(k_fit, f["R"] * world)
    p0_shapes = [t.shape for t in jax.tree.leaves(core.init_params(keys[0], data))]
    chains = []
    for r in range(world):
        z_ls, steps = [], [[] for _ in range(f["steps"])]
        for c in range(r * f["R"], (r + 1) * f["R"]):
            k1, k2 = jax.random.split(keys[c])
            _, kl = jax.random.split(k1)
            z_ls.append(np.asarray(jax.random.normal(kl, (core.d_feat,), jnp.float32)))
            k = k2
            for i in range(f["steps"]):
                k, ksub = jax.random.split(k)
                ks = jax.random.split(ksub, len(p0_shapes))
                steps[i].append([np.asarray(jax.random.normal(kk, s, jnp.float32))
                                 for kk, s in zip(ks, p0_shapes)])
        steps = [[np.stack(leaf) for leaf in zip(*per_chain)] for per_chain in steps]
        chains.append(((np.zeros((f["R"], 0, 0), np.float32), np.stack(z_ls)), steps))
    P_loc = f["pop"] // world
    islands = []
    for i in range(world):
        k, rounds = jax.random.fold_in(k_evo, i), []
        for _ in range(max(1, f["iters"] // f["mig"])):
            k, k_r = jax.random.split(k)
            rounds.append(_evo_draws(k_r, f["mig"], P_loc, D))
        islands.append(rounds)
    inputs = dict(host=host, chains=chains, islands=islands,
                  z=np.asarray(jax.random.normal(k_jit, (P_loc, 1), jnp.float32)),
                  j_samples=_np(samples), j_caches=_np(caches), j_data=_np(data), j_pf=_np(pf))
    return inputs, dict(packed=np.asarray(packed), pf=_np(pf))


def _smc_draws(key, world):
    """Full-population draws of ``smc_sample_sharded`` on ``world`` devices
    (inference.py:676-713): the replicated resampling uniform, and each
    device's MALA normals and uniforms (one key per move for both)."""
    import jax
    import jax.numpy as jnp

    n_loc = N_SMC // world
    k_rep, k_loc = key, [jax.random.fold_in(key, i + 1) for i in range(world)]
    us, moves = [], []
    for _ in range(SMC_KW["n_stages"]):
        k_rep, k_res = jax.random.split(k_rep)
        us.append(np.asarray(jax.random.uniform(k_res, ())))
        per_dev = []
        for i in range(world):
            k_loc[i], k_mala = jax.random.split(k_loc[i])
            mv = []
            for _ in range(SMC_KW["n_mala"]):
                k_mala, kj = jax.random.split(k_mala)
                kk = jax.random.split(kj, 1)[0]
                mv.append((np.asarray(jax.random.normal(kk, (n_loc, 2), jnp.float32)),
                           np.asarray(jax.random.uniform(kk, (n_loc,)))))
            per_dev.append(mv)
        moves.append([(np.concatenate([d[j][0] for d in per_dev]),
                       np.concatenate([d[j][1] for d in per_dev])) for j in range(SMC_KW["n_mala"])])
    return us, moves


def _gp_reference():
    """The JAX mesh GP of test_product_gp_mesh_large_n (600 points,
    max_cholesky_size 256, 4 epochs) on 2 devices: its fitted state and
    predictions."""
    import pandas as pd

    from hebo_tpu.design_space import DesignSpace as JSpace
    from hebo_tpu.models import get_model as jget

    space = JSpace().parse(SPACE)
    rng = np.random.default_rng(1)
    Xdf = pd.DataFrame({f"x{i}": rng.uniform(-1, 1, 600) for i in range(3)})
    y = (Xdf.values ** 2).sum(1, keepdims=True).astype(np.float32)
    m = jget("gp", space, mesh=_jmesh(2, "d"), max_cholesky_size=256, num_epochs=4)
    Xv = space.transform(Xdf)
    m.fit(Xv, y)
    Xq = Xv[:50].astype(np.float32)
    mu, var = m.predict(Xq)
    return (dict(gp_samples=_np(m.samples), gp_data=_np(m.data), gp_Xq=Xq),
            dict(mu=np.asarray(mu), var=np.asarray(var), L=np.asarray(m.caches.L)))


@pytest.fixture(scope="module")
def ref():
    """Every JAX reference and the ranks' inputs (module-scoped)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from hebo_tpu.models.gp.inference import smc_sample_sharded as jsmc
    from hebo_tpu.ops.block_chol import block_cholesky_sharded as jblock
    from hebo_tpu.parallel.sharded import _tree_select_best as jselect

    inputs, out = {}, {"block": {}, "tie": {}, "smc": {}}
    for world in (2, 4):
        for N, block in BLOCKS:
            out["block"][world, N, block] = np.asarray(
                jblock(jnp.asarray(_spd(N, seed=N + block)), _jmesh(world), block=block, jitter=0.0))
    inputs["tie_losses"] = [1.0, 2.0, 1.0, 3.0]
    inputs["chain_losses"] = [np.array([3.0, 1.0], np.float32), np.array([1.0, 2.0], np.float32),
                              np.array([5.0, 0.5], np.float32), np.array([0.5, 4.0], np.float32)]
    for world in (2, 4):
        sel = jax.shard_map(lambda t, l: jselect(t, l[0], "pop"), mesh=_jmesh(world),
                            in_specs=(P("pop"), P("pop")), out_specs=P())
        r = np.arange(world, dtype=np.float32)
        tree = {"a": jnp.asarray(np.repeat(r[:, None], 3, 1)), "b": jnp.asarray(10 * r + 1)}
        out["tie"][world] = {k: np.asarray(v) for k, v in
                             sel(tree, jnp.asarray(inputs["tie_losses"][:world])).items()}
    # SMC: the same prior particles; each world's JAX draws
    logp, log_prior, log_lik = _target(jnp)
    one = lambda f: (lambda q: f({"x": q["x"][None]})[0])
    key = jax.random.PRNGKey(1)
    inputs["parts0"] = np.asarray(3.0 * jax.random.normal(key, (N_SMC, 2)), np.float32)
    inputs["smc_draws"] = {}
    for world in (2, 4):
        inputs["smc_draws"][world] = _smc_draws(key, world)
        p, z = jsmc(one(log_prior), one(log_lik), {"x": jnp.asarray(inputs["parts0"])}, key,
                    _jmesh(world), **SMC_KW)
        out["smc"][world] = (np.asarray(p["x"]), float(z))
    rng = np.random.default_rng(4)
    steps = HMC_KW["n_warmup"] + HMC_KW["n_samples"]
    inputs["q0"] = rng.standard_normal((N_HMC, 2)).astype(np.float32)
    inputs["hmc_draws"] = (rng.standard_normal((steps, N_HMC, 2)).astype(np.float32),
                           rng.uniform(size=(steps, N_HMC)).astype(np.float32),
                           rng.integers(1, HMC_KW["n_leapfrog"] + 1, (steps, N_HMC)))
    gp_in, out["gp"] = _gp_reference()
    inputs.update(gp_in)
    fused_in, out["fused"] = _fused_reference(2)
    inputs["fused"] = fused_in
    return inputs, out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    inputs, _ = ref
    tmp = tmp_path_factory.mktemp("mesh")
    w2_in = dict(inputs, **inputs["fused"])
    return {2: spawn(2, w2_in, list(CASES), tmp),
            4: spawn(4, inputs, ["block", "ladder", "gp", "select", "samplers"], tmp)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("N,block", BLOCKS)
def test_block_cholesky_and_solve(ref, runs, world, N, block):
    want = ref[1]["block"][world, N, block]
    for res in runs[world]:
        L, resid = res["block"][N, block]
        assert np.abs(L - want).max() <= 1e-4 * np.abs(want).max()
        assert np.array_equal(L, np.tril(L))
        assert resid <= 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_ladder_rescues_and_falls_back(runs, world):
    K = _planted().astype(np.float64)
    j1 = 1e-6 + 1e-3 * max(float(np.mean(np.diag(K))), 1e-12)
    Ld = np.linalg.cholesky(K + j1 * np.eye(len(K)))
    for res in runs[world]:
        r = res["ladder"]
        assert not r["rung1_finite"] and r["ok"]
        assert np.abs(r["L"] - Ld).max() < 2e-3
        assert np.abs(r["W"] @ Ld - np.eye(len(K))).max() < 1e-2
        assert r["bad_ok"] == [False]
        assert np.array_equal(r["mu"], np.zeros_like(r["mu"]))
        assert np.array_equal(r["var"], np.ones_like(r["var"]))


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_gp_predicts_as_the_jax_mesh_gp(ref, runs, world):
    inputs, out = ref
    want = out["gp"]
    # σ² = k(x, x) − kᵀK⁻¹k cancels: its float32 error scales with the
    # prior variance k(x, x) y_std², not with σ² itself
    prior_var = float(np.exp(inputs["gp_samples"]["log_sc"]).max() * inputs["gp_data"]["y_std"] ** 2)
    for res in runs[world]:
        r = res["gp"]
        assert r["ok"] == [True]
        np.testing.assert_allclose(r["mu"], want["mu"], rtol=1e-4, atol=1e-4 * np.abs(want["mu"]).max())
        np.testing.assert_allclose(r["var"], want["var"], rtol=1e-4, atol=1e-4 * prior_var)
        assert np.abs(r["L"] - want["L"]).max() <= 1e-4 * np.abs(want["L"]).max()


@pytest.mark.parametrize("world", [2, 4])
def test_best_chain_selection(ref, runs, world):
    losses = np.concatenate(ref[0]["chain_losses"][:world])
    best = int(np.argmin(losses))  # the first of the tied minima
    for res in runs[world]:
        r = res["select"]
        for k, v in ref[1]["tie"][world].items():
            np.testing.assert_allclose(r["tie"][k].reshape(v.shape), v, rtol=1e-6, err_msg=k)
        want = 10 * (best // 2) + best % 2
        assert r["pf"].tolist() == [[want]] and (r["samples"] == want).all()
    # sharded_suggest_step: the gathered islands and the best chain, the same on every rank
    steps = [res["select"]["step"] for res in runs[world]]
    assert steps[0]["X"].shape == (8 * world, 3) and steps[0]["F"].shape == (8 * world, 3)
    assert np.isfinite(steps[0]["F"]).all() and (np.abs(steps[0]["X"]) <= 5.0).all()
    for st in steps[1:]:
        assert all(np.array_equal(st[k], steps[0][k]) for k in st)


def test_fused_route_picks_jax_chain_and_islands_match(ref, runs):
    want = ref[1]["fused"]
    for res in runs[2]:
        r = res["fused"]
        for k, v in want["pf"].items():
            np.testing.assert_allclose(r["pf"][k].reshape(v.shape), v, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(r["islands"], want["packed"], rtol=1e-5, atol=1e-5)
        assert r["packed"].shape == want["packed"].shape and np.isfinite(r["packed"]).all()
    assert np.array_equal(runs[2][0]["fused"]["packed"], runs[2][1]["fused"]["packed"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_samplers(ref, runs, world):
    from hebo_tpu_torch.models.gp.inference import HMCDraws, hmc_sample, smc_sample

    inputs, out = ref
    logp, log_prior, log_lik = _target(torch)
    u, moves = inputs["smc_draws"][world]
    p1, z1 = smc_sample(log_prior, log_lik, {"x": torch.tensor(inputs["parts0"])},
                        draws=lambda s: (u[s], moves[s]), **SMC_KW)
    hd = HMCDraws(*(torch.as_tensor(t) for t in inputs["hmc_draws"]))
    h1, acc1 = hmc_sample(logp, {"x": torch.as_tensor(inputs["q0"])}, n_chains=N_HMC, draws=hd,
                          **HMC_KW)
    pj, zj = out["smc"][world]
    for res in runs[world]:
        r = res["samplers"]
        np.testing.assert_allclose(r["parts"], p1["x"].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["parts"], pj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["logZ"], [float(z1), zj], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["hmc"], h1["x"].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["acc"], acc1.numpy(), rtol=1e-5, atol=1e-5)
        # split-R̂ of inference.py:341-353 on the same chains
        s = r["hmc"].sum(-1).T  # (chains, samples)
        n, m = s.shape[1], s.shape[0]
        ch_mean, ch_var = s.mean(1), s.var(1, ddof=1)
        grand = ch_mean.sum() / m
        B = ((ch_mean - grand) ** 2).sum() * n / (m - 1)
        W = ch_var.sum() / m
        rhat = np.sqrt(((n - 1) / n * W + B / n) / max(W, 1e-12))
        np.testing.assert_allclose(r["rhat"], rhat, rtol=1e-5)


def test_hebo_mesh_end_to_end_at_world_2(runs):
    a, b = (res["hebo"] for res in runs[2])
    assert np.array_equal(a["X"], b["X"]) and np.array_equal(a["y"], b["y"])
    assert len(a["y"]) == 40 and np.isfinite(a["y"]).all()
    assert a["best_y"] < a["y"][: a["rand_sample"]].min()
