"""HMC's acceptance at a couple of hundred observations: hebo_tpu_torch's
``hmc_sample`` against the JAX package's, on the CPU.

The GP's HMC keeps one transition per chain after 64 warm-up transitions,
so the acceptance it reports per chain is one transition's (1.0, or 0.0
after a divergent trajectory).  Here both samplers run the GP's settings
(4 chains, 64 warm-up transitions, up to 8 leapfrog steps, initial step
0.02, target 0.8) on a 6-D Ackley GP at 200 observations (bucket 256) from
the same start, the port with the JAX chains' own draws, and keep 16
transitions, so that the acceptance is a mean over 64 transitions.  Float32
trajectories part after a few dozen transitions, so the two are held
statistically: both means above the target (the averaged step ε̄ that
warm-up ends on is smaller than the steps that met it), and within 0.15
of each other.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import hebo_tpu.models.gp.inference as jinf  # noqa: E402
from hebo_tpu.models.gp.gp import GPCore as JCore  # noqa: E402
from hebo_tpu.models.gp.gp import GPParams as JParams  # noqa: E402
from hebo_tpu.models.gp.gp import _make_data  # noqa: E402
from hebo_tpu_torch.models.gp import GPCore, data_from_jax  # noqa: E402
from hebo_tpu_torch.models.gp.gp import map_fit  # noqa: E402
from hebo_tpu_torch.models.gp.inference import HMCDraws, hmc_sample  # noqa: E402
from hebo_tpu_torch.models.gp.tree import tree_map  # noqa: E402

N_OBS, N_PAD, C, WARMUP, KEPT, LEAPFROG = 200, 256, 4, 64, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ackley_gp():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (N_OBS, 6))
    Z = X * 65.536 - 32.768
    y = (-20 * np.exp(-0.2 * np.sqrt((Z ** 2).mean(1))) - np.exp(np.cos(2 * np.pi * Z).mean(1))
         + 20 + math.e)[:, None]
    args = dict(numeric_dims=tuple(range(6)), cat_dims=(), num_categories=())
    jd = _make_data(X, y, tuple(range(6)), N_PAD)
    td = data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")
    return JCore(**args), GPCore(**args), jd, td


def _jax_chain_draws(key, q0):
    """inference.py:177-200's key schedule, per chain (the chains' keys as
    ``hmc_sample`` splits them)."""
    xi, u, n_lf = [], [], []
    for c, k in enumerate(jax.random.split(key, C)):
        qc = jax.tree.map(lambda t: t[c], q0)
        rows = []
        for _ in range(WARMUP + KEPT):
            k, k_mom, k_acc, k_jit = jax.random.split(k, 4)
            rows.append((np.concatenate([np.asarray(l).ravel() for l in
                                         jax.tree.leaves(jinf._tree_randn_like(k_mom, qc))]),
                         float(jax.random.uniform(k_acc, ())),
                         int(jax.random.randint(k_jit, (), 1, LEAPFROG + 1))))
        xi.append([r[0] for r in rows])
        u.append([r[1] for r in rows])
        n_lf.append([r[2] for r in rows])
    return HMCDraws(torch.as_tensor(np.swapaxes(np.asarray(xi, np.float32), 0, 1)),
                    torch.as_tensor(np.asarray(u, np.float32).T),
                    torch.as_tensor(np.asarray(n_lf).T))


def test_hmc_acceptance_at_200_observations_against_the_reference():
    jcore, tcore, jd, td = _ackley_gp()
    # the start: the port's MAP point, jittered per chain as GP._sample does
    pf, _ = map_fit(tcore, td, 2, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    chain0 = tree_map(lambda t: t.expand((C,) + t.shape[1:])
                      + 0.05 * torch.randn((C,) + t.shape[1:], generator=g), pf)
    q0 = JParams(**{k: None if v is None else jnp.asarray(v.numpy())
                    for k, v in chain0._asdict().items()})
    key = jax.random.PRNGKey(3)
    kw = dict(n_chains=C, n_warmup=WARMUP, n_samples=KEPT, n_leapfrog=LEAPFROG, init_step=0.02,
              target_accept=0.8)
    _, acc_j = jinf.hmc_sample(lambda p: -jcore.loss(p, jd), q0, key, **kw)
    acc_j = np.asarray(acc_j)
    trace = []
    _, acc_t = hmc_sample(lambda p: -tcore.loss_batched(p, td), chain0,
                          draws=_jax_chain_draws(key, q0), trace=trace, **kw)
    acc_t = acc_t.numpy()
    print(f"HMC at {N_OBS} obs, {KEPT} kept per chain: acceptance JAX {acc_j.tolist()}, "
          f"port {acc_t.tolist()}; the port's final eps_bar {torch.exp(trace[-1][2]).tolist()}")
    assert acc_j.mean() >= 0.8 and acc_t.mean() >= 0.8
    assert abs(acc_j.mean() - acc_t.mean()) <= 0.15
