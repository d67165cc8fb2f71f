"""Hyperparameter posterior inference: HMC, slice sampling, SVI and SMC.

Port of the single-device samplers of ``hebo_tpu/models/gp/inference.py``:
``_leapfrog`` (:122), the HMC chain (``_make_hmc_chain`` :136: dual
averaging, one Welford window for a diagonal mass matrix, trajectory
lengths jittered over 1..n_leapfrog, divergent trajectories rejected),
``hmc_sample`` (:265), ``slice_sample`` (:381, fixed step-out and shrink
budgets), ``svi_fit`` (:460, mean-field Gaussian by Adam) and
``smc_sample`` (:523, likelihood tempering, systematic ESS-triggered
resampling, MALA moves).

The JAX package maps one chain (or particle, or restart) over a batch axis
with ``vmap``; here the batch is the leading axis of every parameter leaf,
and the log-density ``logp(params) -> (B,)`` is called once for the whole
batch, so for the GP each evaluation is one batched NLL (kernel K1 on
CUDA).  The samplers work on the parameters flattened as ``ravel_pytree``
does (leaves in order, ``None`` skipped, each leaf's trailing axes in row
order): a state is a (B, dim) tensor.  Gradients come from
``torch.autograd.grad``; random numbers come from a ``torch.Generator`` or
are passed in (``draws=``), so that a test can feed the JAX package's own
draws.  Nothing reads a device value on the host: a chain whose trajectory
length has ended is frozen by a mask for the rest of the n_leapfrog steps,
and every accept or resample decision is a ``where``.

The sharded samplers (``hmc_sample_sharded`` :295, ``smc_sample_sharded``
:620) run the same code on each rank's block of chains or particles of a
device mesh (``parallel/sharded.py``): every rank holds the full initial
batch, runs its rows, and returns every rank's rows all-gathered.  Each
transition's random numbers are drawn for the whole batch from the shared
generator (or fed for the whole batch) and each rank takes its rows, so a
chain's or a particle's draws do not depend on the world size: the sharded
HMC's chains and the sharded SMC's population equal the unsharded
samplers' on the same draws.  SMC's normalization, evidence and ESS are
all-reduced and its systematic resampling runs over the all-gathered
population; HMC's split-R̂ comes from all-reduced moments.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ...parallel.sharded import all_gather, all_reduce, mesh_rank, mesh_size
from .tree import Flat, adam_step

__all__ = ["hmc_sample", "hmc_sample_sharded", "slice_sample", "svi_fit", "smc_sample",
           "smc_sample_sharded", "HMCDraws"]


def _value_and_grad(logp: Callable, flat: Flat, v: torch.Tensor):
    """(logp (B,), ∂ logp / ∂v (B, dim)) at the flat states v."""
    with torch.enable_grad():
        x = v.detach().requires_grad_(True)
        lp = logp(flat.unravel(x))
        (g,) = torch.autograd.grad(lp.sum(), x)
    return lp.detach(), g


def _value(logp: Callable, flat: Flat, v: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return logp(flat.unravel(v))


# -------------------------------------------------------------------- HMC
class HMCDraws(NamedTuple):
    """Every random number of ``hmc_sample``, one row per transition:
    momentum normals, accept uniforms and trajectory lengths (1..n_leapfrog)."""

    xi: torch.Tensor  # (steps, C, dim)
    u: torch.Tensor  # (steps, C)
    n_lf: torch.Tensor  # (steps, C) int


def _leapfrog(vg: Callable, q, p, eps, n_steps: int, inv_mass, n_lf=None, start=None):
    """``n_steps`` leapfrog steps with the diagonal mass M = inv_mass⁻¹:
    q̇ = inv_mass ⊙ p.  ``eps`` (C,) per chain.  Row c stops after
    ``n_lf[c]`` steps (frozen by a mask for the rest).  ``start`` = (logp,
    grad) at q, if known.  Returns (q, p, logp(q), grad(q)) at the end of
    each row's trajectory.  The gradient at the start of a step is the one
    at the end of the step before, so a trajectory of n steps evaluates
    n + 1 gradients (the JAX package's loop body evaluates 2n)."""
    lp, g = vg(q) if start is None else start
    e = eps[:, None]
    for j in range(n_steps):
        p1 = p + 0.5 * e * g
        q1 = q + e * inv_mass * p1
        lp1, g1 = vg(q1)
        p1 = p1 + 0.5 * e * g1
        if n_lf is None:
            q, p, lp, g = q1, p1, lp1, g1
            continue
        on = n_lf > j
        q, p, g = (torch.where(on[:, None], a, b) for a, b in ((q1, q), (p1, p), (g1, g)))
        lp = torch.where(on, lp1, lp)
    return q, p, lp, g


def hmc_sample(logp: Callable, init_params, generator: Optional[torch.Generator] = None, *,
               n_chains: int = 4, n_warmup: int = 64, n_samples: int = 16, n_leapfrog: int = 8,
               init_step: float = 0.02, target_accept: float = 0.8,
               draws: Optional[HMCDraws] = None, trace: Optional[list] = None):
    """``n_chains`` HMC chains in one batch (inference.py:136-292).

    ``init_params``: a tree whose leaves lead with the chain axis;
    ``logp(tree) -> (n_chains,)``.  Returns (samples, accept_rate): the
    samples' leaves lead with (n_samples, n_chains), one retained state
    per post-warmup transition; accept_rate (n_chains,) is the mean
    acceptance probability after warm-up.  ``trace``, a list, receives
    per transition (q, log ε, log ε̄, h̄, inv_mass, log u − log α) for
    tests."""
    samples, acc, _ = _hmc(logp, init_params, generator, None, n_warmup=n_warmup,
                           n_samples=n_samples, n_leapfrog=n_leapfrog, init_step=init_step,
                           target_accept=target_accept, draws=draws, trace=trace)
    return samples, acc


def hmc_sample_sharded(logp: Callable, init_params, generator: Optional[torch.Generator], mesh, *,
                       n_chains: int = 8, n_warmup: int = 64,
                       n_samples: int = 16, n_leapfrog: int = 8, init_step: float = 0.02,
                       target_accept: float = 0.8, draws: Optional[HMCDraws] = None):
    """Chain-parallel HMC over the mesh (inference.py:295-378): rank r runs
    chains [r·C/world, (r+1)·C/world) of ``init_params`` (every leaf leads
    with ``n_chains`` = C, a multiple of the mesh size, the same on every
    rank).  Returns (samples (n_samples, C, ...), accept_rate (C,), R̂) on
    every rank: the chains' draws are those of ``hmc_sample`` with the same
    generator or ``draws``, whatever the world size, and R̂ is the
    split-R̂ of the per-sample sum of every parameter over all chains,
    from all-reduced chain means and variances."""
    if n_chains % mesh_size(mesh):
        raise ValueError(f"hmc_sample_sharded: {n_chains} chains over {mesh_size(mesh)} ranks")
    return _hmc(logp, init_params, generator, mesh, n_warmup=n_warmup, n_samples=n_samples,
                n_leapfrog=n_leapfrog, init_step=init_step, target_accept=target_accept,
                draws=draws, trace=None)


def _rows(mesh, n: int) -> slice:
    """This rank's block of ``n`` chains or particles."""
    k = n // mesh_size(mesh)
    return slice(mesh_rank(mesh) * k, (mesh_rank(mesh) + 1) * k)


def _hmc(logp, init_params, generator, mesh, *, n_warmup, n_samples, n_leapfrog, init_step,
         target_accept, draws, trace):
    """This rank's chains of ``init_params``; returns every rank's samples
    and acceptance rates, and R̂ with a mesh (else None)."""
    flat = Flat(init_params)
    q_all = flat.ravel(init_params).detach()
    C_all, dim = q_all.shape
    rows = _rows(mesh, C_all)
    q = q_all[rows]
    C = q.shape[0]
    dev, f32 = q.device, q.dtype
    vg = lambda v: _value_and_grad(logp, flat, v)
    total = n_warmup + n_samples
    gamma, t0, kappa = 0.05, 10.0, 0.75
    w_lo = n_warmup // 4
    w_hi = max((3 * n_warmup) // 4, w_lo)
    full = lambda x: torch.full((C,), x, dtype=f32, device=dev)
    log_eps, log_eps_bar, h_bar = full(math.log(init_step)), full(math.log(init_step)), full(0.0)
    mu = full(math.log(10.0 * init_step))
    t = 0.0  # the averaging clock, the same for every chain
    mean, m2 = torch.zeros_like(q), torch.zeros_like(q)
    cnt = 0.0
    inv_mass = torch.ones_like(q)
    cur = vg(q)
    kept, a_probs = [], []
    for i in range(total):
        if draws is None:
            xi = torch.randn((C_all, dim), generator=generator, dtype=f32, device=dev)
            u = torch.rand((C_all,), generator=generator, dtype=f32, device=dev)
            n_lf = torch.randint(1, n_leapfrog + 1, (C_all,), generator=generator, device=dev)
        else:
            xi, u, n_lf = (torch.as_tensor(d[i], device=dev) for d in draws)
        xi, u, n_lf = xi[rows], u[rows], n_lf[rows]
        p = xi / torch.sqrt(inv_mass)
        eps = torch.exp(log_eps)
        q_new, p_new, lp_new, g_new = _leapfrog(vg, q, p, eps, n_leapfrog, inv_mass, n_lf, cur)
        kin = lambda pp: 0.5 * (inv_mass * pp ** 2).sum(-1)
        h0 = -cur[0] + kin(p)
        h1 = -lp_new + kin(p_new)
        finite = torch.isfinite(h1)
        log_alpha = torch.where(finite, torch.clamp(h0 - h1, max=0.0),
                                torch.full_like(h1, -math.inf))
        accept = torch.log(u) < log_alpha
        q = torch.where(accept[:, None], q_new, q)
        cur = (torch.where(accept, lp_new, cur[0]), torch.where(accept[:, None], g_new, cur[1]))
        a_prob = torch.where(finite, torch.exp(log_alpha), torch.zeros_like(log_alpha))

        # Welford moments of q in the window, the metric switched at its end
        w_in = 1.0 if w_lo <= i < w_hi else 0.0
        cnt2 = cnt + w_in
        delta = q - mean
        mean = mean + w_in * delta / max(cnt2, 1.0)
        m2 = m2 + w_in * delta * (q - mean)
        cnt = cnt2
        at_switch = i == w_hi and cnt2 > 2.0
        if at_switch:
            inv_mass = torch.clamp(m2 / max(cnt2 - 1.0, 1.0), 1e-4, 1e4)

        # dual averaging in warm-up (restarted and re-anchored at the
        # switch), frozen at the averaged step after it
        if i < n_warmup:
            t = 1.0 if at_switch else t + 1.0
            if at_switch:
                h_bar = torch.zeros_like(h_bar)
                mu = math.log(10.0) + log_eps_bar
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (target_accept - a_prob) / (t + t0)
            log_eps = mu - math.sqrt(t) / gamma * h_bar
            w = t ** (-kappa)
            log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        else:
            log_eps = log_eps_bar
        if trace is not None:
            trace.append((q, log_eps, log_eps_bar, h_bar, inv_mass, torch.log(u) - log_alpha))
        if i >= n_warmup:
            kept.append(q)
            a_probs.append(a_prob)
    kept = torch.stack(kept)  # (n_samples, C, dim)
    acc = torch.stack(a_probs).mean(0)
    rhat = None
    if mesh is not None:
        # split-R̂ over all chains of the summary Σ params (inference.py:341-353)
        s = kept.sum(-1).transpose(0, 1)  # (C, n_samples)
        ch_mean, ch_var = s.mean(1), s.var(1, correction=1)
        m = C_all
        grand = all_reduce(ch_mean.sum(), mesh) / m
        B = all_reduce(((ch_mean - grand) ** 2).sum(), mesh) * n_samples / (m - 1)
        W = all_reduce(ch_var.sum(), mesh) / m
        var_plus = (n_samples - 1) / n_samples * W + B / n_samples
        rhat = torch.sqrt(var_plus / torch.clamp(W, min=1e-12))
        kept = all_gather(kept.transpose(0, 1), mesh).transpose(0, 1)
        acc = all_gather(acc, mesh)
    return flat.unravel(kept), acc, rhat


# ------------------------------------------------------------------ slice
_N_SHRINK = 16  # shrink proposals per coordinate step (inference.py:440)


def slice_sample(logp: Callable, init_params, generator: Optional[torch.Generator] = None, *,
                 n_samples: int = 10, n_burnin: int = 20, thinning: int = 2,
                 width: float = 1.0, max_stepout: int = 8,
                 uniforms: Optional[torch.Tensor] = None, loop: Optional[Callable] = None):
    """Univariate slice sampling with stepping out, cycling the coordinates
    (inference.py:381-456), for a batch of independent chains (the GP's
    restarts): ``logp(tree) -> (R,)``, every coordinate step of every chain
    at once.  Each coordinate step evaluates logp once at the current state,
    twice per step-out iteration (at lo and at hi, ``max_stepout`` times)
    and once per shrink proposal (a fixed budget of 16).

    A coordinate step reads its coordinate, its uniforms and the sample
    slot it writes from one step counter on the device, and updates the
    state in place, so the same step serves every coordinate of every
    sweep: ``loop(step, n)`` runs it ``n`` times (by default a Python loop;
    HEBO's captured suggest captures it once as a CUDA graph and replays
    that).

    ``uniforms`` (sweeps, dim, 18, R) replaces the generator's draws (all
    made up front): per coordinate the slice height's, the bracket
    offset's and the shrink proposals'.  Returns the kept states, leaves
    leading with (n_samples, R): sweep n_burnin, then every ``thinning``-th."""
    flat = Flat(init_params)
    v = flat.ravel(init_params).detach().clone()
    R, dim = v.shape
    total = n_burnin + n_samples * thinning
    if uniforms is None:
        uniforms = torch.rand((total, dim, 2 + _N_SHRINK, R), generator=generator, dtype=v.dtype,
                              device=v.device)
    uni = torch.as_tensor(uniforms, device=v.device).reshape(total * dim, 2 + _N_SHRINK, R)
    col = torch.arange(dim, device=v.device)
    k = torch.zeros((), dtype=torch.int64, device=v.device)  # the step counter
    # the kept states, and a spare last row that every other step writes
    kept = v.unsqueeze(0).repeat(n_samples + 1, 1, 1)
    lp_at = lambda x: _value(logp, flat, x)

    def step():
        i, sweep = k % dim, torch.div(k, dim, rounding_mode="floor")
        at = col == i
        put = lambda x: torch.where(at, x[:, None], v)
        u = uni.index_select(0, k.reshape(1))[0]
        x0 = v.index_select(1, i.reshape(1))[:, 0]
        log_u = lp_at(v) + torch.log(u[0] + 1e-12)
        lo = x0 - u[1] * width
        hi = lo + width
        for _ in range(max_stepout):
            lo_in, hi_in = lp_at(put(lo)) > log_u, lp_at(put(hi)) > log_u
            lo = torch.where(lo_in, lo - width, lo)
            hi = torch.where(hi_in, hi + width, hi)
        x, accepted = x0, torch.zeros_like(x0, dtype=torch.bool)
        for j in range(_N_SHRINK):
            prop = lo + u[2 + j] * (hi - lo)
            ok = lp_at(put(prop)) > log_u
            x = torch.where(ok & ~accepted, prop, x)
            accepted = accepted | ok
            lo = torch.where(ok, lo, torch.where(prop < x0, prop, lo))
            hi = torch.where(ok, hi, torch.where(prop >= x0, prop, hi))
        v_new = put(x)
        # the last coordinate of sweep n_burnin + j·thinning keeps sample j
        j = sweep - n_burnin
        keep = (i == dim - 1) & (j >= 0) & (j % thinning == 0) & (j < n_samples * thinning)
        slot = torch.where(keep, torch.div(j, thinning, rounding_mode="floor"),
                           torch.full_like(j, n_samples))
        kept.index_copy_(0, slot.reshape(1), v_new[None])
        v.copy_(v_new)
        k.add_(1)

    if loop is None:
        for _ in range(total * dim):
            step()
    else:
        loop(step, total * dim)
    return flat.unravel(kept[:n_samples])


# -------------------------------------------------------------------- SVI
def svi_fit(logp: Callable, init_params, generator: Optional[torch.Generator] = None, *,
            n_steps: int = 200, n_mc: int = 4, lr: float = 0.02, init_log_scale: float = -3.0,
            n_samples: int = 16, draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            trace: Optional[list] = None):
    """Mean-field Gaussian VI on the unconstrained parameters
    (inference.py:460-519), ELBO = E_q[logp] + Σ log σ by Adam, each
    step's expectation over ``n_mc`` reparametrized draws in one batched
    ``logp`` call.

    ``init_params``: a tree with a leading axis of 1 (the variational
    mean's start).  ``draws`` = (normals (n_steps, n_mc, dim), final
    normals (n_samples, dim)) replaces the generator's.  ``trace``, a list,
    receives per step (−ELBO, its gradient in the mean, in the log-scale)
    and then the final (mean, log-scale).  Returns (samples with leading
    axis n_samples, the last step's ELBO)."""
    flat = Flat(init_params)
    loc = flat.ravel(init_params).detach()[0]
    log_scale = torch.full_like(loc, init_log_scale)
    dist = [loc, log_scale]
    mom = [torch.zeros_like(loc), torch.zeros_like(loc)]
    sec = [torch.zeros_like(loc), torch.zeros_like(loc)]
    dim, dev = loc.shape[0], loc.device
    val = None
    for i in range(n_steps):
        eps = (torch.randn((n_mc, dim), generator=generator, dtype=loc.dtype, device=dev)
               if draws is None else torch.as_tensor(draws[0][i], device=dev))
        with torch.enable_grad():
            m, s = (t.detach().requires_grad_(True) for t in dist)
            q = m + torch.exp(s) * eps
            loss = -(logp(flat.unravel(q)).mean() + s.sum())
            grads = torch.autograd.grad(loss, [m, s])
        val = loss.detach()
        if trace is not None:
            trace.append((val, *grads))
        for j in range(2):
            dist[j], mom[j], sec[j] = adam_step(dist[j], grads[j], mom[j], sec[j], i + 1, lr)
    eps = (torch.randn((n_samples, dim), generator=generator, dtype=loc.dtype, device=dev)
           if draws is None else torch.as_tensor(draws[1], device=dev))
    if trace is not None:
        trace.append(tuple(dist))
    return flat.unravel(dist[0] + torch.exp(dist[1]) * eps), -val


# -------------------------------------------------------------------- SMC
def smc_sample(log_prior: Callable, log_lik: Callable, init_particles,
               generator: Optional[torch.Generator] = None, *, n_stages: int = 16, n_mala: int = 2,
               mala_step: float = 0.01, ess_threshold: float = 0.5, draws=None,
               trace: Optional[list] = None):
    """Likelihood-tempered SMC, β from 0 to 1 over ``n_stages``
    (inference.py:523-617): importance weights from the likelihood's
    increment, systematic resampling when the ESS falls below
    ``ess_threshold``·n (weights carried in the "sum to n" convention), then
    ``n_mala`` MALA moves at the stage's temperature with the symmetric
    Metropolis correction.  ``log_prior`` and ``log_lik`` map a tree of
    particles to (n,).

    ``draws(stage) -> (u_res (), [(normals (n, dim), uniforms (n,)) per
    MALA move])`` replaces the generator's.  ``trace``, a list, receives
    per stage (particles, log-weights, log-evidence, ESS, [log u − log α
    per MALA move]).  Returns (particles, the log-evidence estimate)."""
    return _smc(log_prior, log_lik, init_particles, generator, None, n_stages=n_stages,
                n_mala=n_mala, mala_step=mala_step, ess_threshold=ess_threshold, draws=draws,
                trace=trace)


def smc_sample_sharded(log_prior: Callable, log_lik: Callable, init_particles,
                       generator: Optional[torch.Generator], mesh, *, n_stages: int = 16,
                       n_mala: int = 2, mala_step: float = 0.01, ess_threshold: float = 0.5,
                       draws=None):
    """Particle-parallel SMC over the mesh (inference.py:620-717): rank r
    holds particles [r·n/world, (r+1)·n/world) of ``init_particles`` (n a
    multiple of the mesh size, the same full batch on every rank).  Per
    stage the weights' maximum and sum, the evidence increment and the ESS
    are all-reduced, and when the ESS collapses the systematic resampling
    runs over the all-gathered weights and particles, each rank picking its
    own block of the global stratified grid with the shared uniform; the
    MALA moves stay local.  The result equals ``smc_sample`` over the full
    population with the same generator or ``draws`` (full-population
    draws; each rank takes its rows).  Returns (every rank's particles,
    the log-evidence) on every rank."""
    n = Flat(init_particles).ravel(init_particles).shape[0]
    if n % mesh_size(mesh):
        raise ValueError(f"smc_sample_sharded: {n} particles over {mesh_size(mesh)} ranks")
    return _smc(log_prior, log_lik, init_particles, generator, mesh, n_stages=n_stages,
                n_mala=n_mala, mala_step=mala_step, ess_threshold=ess_threshold, draws=draws,
                trace=None)


def _smc(log_prior, log_lik, init_particles, generator, mesh, *, n_stages, n_mala, mala_step,
         ess_threshold, draws, trace):
    flat = Flat(init_particles)
    parts_all = flat.ravel(init_particles).detach()
    n, dim = parts_all.shape
    rows = _rows(mesh, n)
    parts = parts_all[rows]
    dev, f32 = parts.device, parts.dtype
    betas = torch.linspace(0.0, 1.0, n_stages + 1, dtype=f32)
    pos0 = torch.arange(n, device=dev)[rows].to(f32)  # this rank's slots of the global grid
    logw = torch.zeros((parts.shape[0],), dtype=f32, device=dev)
    logZ = torch.zeros((), dtype=f32, device=dev)
    sq = math.sqrt(mala_step)
    for s in range(n_stages):
        b_next = float(betas[s + 1])
        db = float(betas[s + 1] - betas[s])
        if draws is None:
            u_res = torch.rand((), generator=generator, dtype=f32, device=dev)
            moves = [(torch.randn((n, dim), generator=generator, dtype=f32, device=dev),
                      torch.rand((n,), generator=generator, dtype=f32, device=dev))
                     for _ in range(n_mala)]
        else:
            u_res, moves = draws(s)
            u_res = torch.as_tensor(u_res, dtype=f32, device=dev)
            moves = [tuple(torch.as_tensor(t, dtype=f32, device=dev) for t in mv) for mv in moves]
        moves = [(z[rows], ua[rows]) for z, ua in moves]
        ll = _value(log_lik, flat, parts)
        ll = torch.where(torch.isfinite(ll), ll, torch.full_like(ll, -1e10))
        logw = logw + db * ll
        m = all_reduce(logw.max(), mesh, "max")
        w = torch.exp(logw - m)
        sw = all_reduce(w.sum(), mesh)
        logZ = logZ + m + torch.log(sw / n)
        w = w / sw
        ess = 1.0 / all_reduce((w ** 2).sum(), mesh)
        do_res = ess < ess_threshold * n
        idx = torch.clamp(torch.searchsorted(torch.cumsum(all_gather(w, mesh), 0),
                                             (pos0 + u_res) / n), max=n - 1)
        parts = torch.where(do_res, all_gather(parts, mesh).index_select(0, idx), parts)
        logw = torch.where(do_res, torch.zeros_like(logw), torch.log(w * n))

        logt = lambda tree: log_prior(tree) + b_next * log_lik(tree)
        margins = []
        for noise, ua in moves:
            lp_old, g = _value_and_grad(logt, flat, parts)
            prop = parts + 0.5 * mala_step * g + sq * noise
            lp_new = _value(logt, flat, prop)
            log_alpha = torch.where(torch.isfinite(lp_new), lp_new - lp_old,
                                    torch.full_like(lp_new, -math.inf))
            acc = torch.log(ua) < log_alpha
            parts = torch.where(acc[:, None], prop, parts)
            margins.append(torch.log(ua) - log_alpha)
        if trace is not None:
            trace.append((parts, logw, logZ, ess, margins))
    return flat.unravel(all_gather(parts, mesh)), logZ
