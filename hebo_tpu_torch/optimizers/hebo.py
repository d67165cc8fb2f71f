"""HEBO — the flagship optimizer (port of ``hebo_tpu/optimizers/hebo.py``).

* Sobol random-init phase of ``1 + D`` points, with the same seeds as the
  JAX package (identical init frames);
* power-transformed objective (Box-Cox / Yeo-Johnson, host side);
* GP surrogate fitted by pSGLD over 2 stacked restarts × 50 steps;
* the LCB κ schedule  √(2ν((2 + D/2)·ln t + ln(3π²/(3δ))));
* MACE (LCB, −log EI, −log PI) optimized by NSGA-II, pop 100 × 100 gens;
* dedupe against the history + random top-up, and the best-σ / best-μ
  elite overrides of the batch (host side).

``_fused_suggest`` is the JAX package's one device program (hebo.py:214-397):
fit, posterior caches, incumbent, MACE + NSGA-II, population posterior.  On
CUDA it is one captured CUDA graph per bucket (with the slice optimizer,
three: the slice sampler's coordinate step is one graph, replayed once per
step), replayed at every later
suggest of that bucket; its inputs go in as one packed array and one copy
comes back, as in the JAX package.  Every random number of a suggest is
drawn before the program runs, from one ``torch.Generator`` on the device
seeded by the observation count, so the graph, the eager path
(``_use_graphs = False``, kept for comparison) and the CPU give the same
suggestions from the same draws.

The fused program serves a plain ``GP`` (``type(model).__name__ ==
"GP"``) with ``inference="map"`` up to its ``max_cholesky_size``, as in the
JAX package (hebo.py:132-140), whatever its kernel, input warp,
heteroscedastic noise or optimizer (pSGLD, Adam, slice).  Every other
suggest takes the generic route (hebo.py:126-173): every other registered
model (the ``gpy_wgp`` and ``gpy_mlp`` subclasses, ``gp_rd``, ``svgp``,
``dkl``, ``uncertain_gp``, ``lin_reg``, the deep ensembles, ``eac``, ``rf``,
``gbdt`` / ``catboost`` and, once ``hebo_tpu_torch.meta`` is imported,
``nap``), a GP with a sampler over its hyperparameters
(HMC, SVI, SMC), or a bucket above ``max_cholesky_size``, where ``GP.fit``
fits on a subsample and the posterior runs through CG.  It fits the model,
takes the incumbent's posterior mean and runs ``EvolutionOpt`` with MACE's
z drawn from a generator seeded by the observation count, all launched op
by op.

``HEBO(mesh=..., migrate_every=10)`` (a 1-D device mesh,
``parallel/sharded.make_mesh``; hebo.py:56-78, :229-245) runs the fused
program's SPMD form instead (``_sharded_program``, the JAX package's
``make_fused_suggest_sharded``, sharded.py:153-278): every rank fits
``n_restarts`` chains of its own, the first argmin of all ranks' losses is
the fitted state on every rank, and each rank evolves an island of
``pop / world`` points (``pop`` rounded up to a multiple of the world
size, the incumbent in slot 0 of the first) with elite migration every
``migrate_every`` generations; the islands' packed outputs are gathered
and the host picks from them as on one card.  Every rank runs the same
host code and returns the same suggestion.  The replicated draws (MACE's
z, the acquisition's own) come from the generator seeded by the
observation count; a rank's chains and its island draw from a generator
seeded from (observation count, rank).  The route runs eagerly, op by op,
with no CUDA graph.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..acq_optimizers.evolution import (EvolutionOpt, GenDraws, MetaTensors, _space_meta,
                                        evolve_raw, meta_tensors)
from ..acquisitions.acq import MACE, AcqParams
from ..models import get_model, get_model_class
from ..models.gp.gp import GPData, map_fit
from ..ops.chol_kernel import chol_factor, chol_winv
from ..ops.gram import matern32_gram, matern32_gram_vjp
from ..ops.pareto import nsga2_rank_crowd
from ..ops.transforms import fit_power_transform, power_transform_y
from ..parallel.sharded import (all_gather, island_evolve, mesh_rank, mesh_size, rank_generator,
                                select_chain)
from ..utils.device import resolve_device
from ..utils.dtypes import pad_bucket
from .base import AbstractOptimizer

__all__ = ["HEBO"]


class HEBO(AbstractOptimizer):
    support_parallel_opt = True
    support_combinatorial = True
    support_contextual = True

    def __init__(
        self,
        space,
        model_name: str = "gp",
        rand_sample: Optional[int] = None,
        acq_cls=MACE,
        es: str = "nsga2",  # accepted and ignored, as in the JAX package
        model_config: Optional[dict] = None,
        csv_save_path: Optional[str] = None,
        scramble_seed: int = 0,
        pop: int = 100,
        iters: int = 100,
        mesh=None,
        migrate_every: int = 10,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        get_model_class(model_name)  # an unknown name raises ValueError here
        self.device = resolve_device(device)
        self.model_name = model_name
        self.rand_sample = rand_sample if rand_sample is not None else 1 + space.num_cols
        self.acq_cls = acq_cls
        defaults = {"num_epochs": 50, "n_restarts": 2} if model_name == "gp" else {}
        self.model_config = {**defaults, **(model_config or {})}
        self.scramble_seed = scramble_seed
        self.pop = pop
        self.iters = iters
        self.mesh = mesh
        self.migrate_every = migrate_every
        self._sobol_count = 0
        self.model = None
        self._acq = None
        self._use_graphs = True  # False: the eager CUDA path, for comparison
        self._graphs: dict = {}

    def quasi_sample(self, n: int, fix_input: Optional[dict] = None) -> pd.DataFrame:
        X = self.space.sobol_sample_opt(n, seed=self.scramble_seed + self._sobol_count)
        self._sobol_count += 1
        df = self.space.inverse_transform(X)
        for k, v in (fix_input or {}).items():
            df[k] = v
        return df

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.rand_sample:
            return self.quasi_sample(n_suggestions, fix_input)
        space = self.space
        X = space.transform(self.X)
        yr = self.y[:, 0].copy()
        valid = np.isfinite(yr) & np.all(np.isfinite(X), axis=1)
        Xv, yv = X[valid], yr[valid]
        if len(Xv) < 2:
            return self.quasi_sample(n_suggestions, fix_input)

        pt = fit_power_transform(yv)
        yt = power_transform_y(yv, pt).reshape(-1, 1)
        if self.model is None:
            self.model = get_model(self.model_name, space, num_out=1,
                                   device=self.device, **self.model_config)
        if self._acq is None:
            self._acq = self.acq_cls() if isinstance(self.acq_cls, type) else self.acq_cls

        t = max(1, self.num_obs // n_suggestions)
        upsi, delta = 0.5, 0.01
        D = space.num_cols
        kappa = math.sqrt(
            2.0 * upsi * ((2.0 + D / 2.0) * math.log(max(t, 1))
                          + math.log(3 * math.pi ** 2 / (3 * delta)))
        )
        use_fused = (type(self.model).__name__ == "GP"
                     and getattr(self.model, "inference", "map") == "map"
                     and pad_bucket(max(len(Xv), 2)) <= self.model.core.max_cholesky_size)
        if use_fused and self.mesh is not None:
            pop_X, pop_F, mu_pop, var_pop = self._sharded_suggest(Xv, yt, kappa, fix_input)
        elif use_fused:
            pop_X, pop_F, mu_pop, var_pop = self._fused_suggest(Xv, yt, kappa, fix_input)
        else:
            pop_X, pop_F, mu_pop, var_pop = self._generic_suggest(Xv, yt, kappa, fix_input)

        # dedupe vs history + within the population
        hist = {tuple(np.round(r, 6)) for r in X}
        seen, fresh_idx = set(), []
        for i, r in enumerate(pop_X):
            k = tuple(np.round(r, 6))
            if k not in hist and k not in seen:
                seen.add(k)
                fresh_idx.append(i)

        rng = np.random.default_rng(self.num_obs)
        if len(fresh_idx) >= n_suggestions:
            pick = rng.choice(len(fresh_idx), n_suggestions, replace=False)
            rec = pop_X[[fresh_idx[i] for i in pick]]
            # elite overrides: best-σ explorer + best-μ exploiter
            rec[0] = pop_X[fresh_idx[int(np.argmax(var_pop[fresh_idx, 0]))]]
            if n_suggestions > 1:
                rec[1] = pop_X[fresh_idx[int(np.argmin(mu_pop[fresh_idx, 0]))]]
        else:
            n_rand = n_suggestions - len(fresh_idx)
            rec = np.vstack(
                [pop_X[fresh_idx].reshape(-1, space.num_cols)]
                + [space.sobol_sample_opt(n_rand, seed=int(rng.integers(1 << 30)))]
            )
        df = space.inverse_transform(rec[:n_suggestions])
        for k, v in (fix_input or {}).items():
            df[k] = v
        return df

    def _generic_suggest(self, Xv, yt, kappa, fix_input):
        """``model.fit``, the incumbent, ``EvolutionOpt`` and the
        population's posterior, op by op (hebo.py:146-173)."""
        model, dev = self.model, self.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = time.time()
        model.fit(Xv, yt)
        sync()
        self.fit_time.append(time.time() - t0)
        best_id = int(np.argmin(yt[:, 0]))
        py, _ = model.predict(Xv[best_id : best_id + 1])
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.num_obs % (1 << 30))
        z = torch.randn((self.pop, 1), generator=gen, device=dev)
        k = self._acq.n_normals
        draw = torch.randn((1, k), generator=gen, device=dev) if k else None
        params = AcqParams(tau=float(py[0, 0]), kappa=kappa, eps=1e-4,
                           noise=float(np.sqrt(model.noise[0])), z=z, draw=draw)
        t0 = time.time()
        evo = EvolutionOpt(self.space, self._acq, pop=self.pop, iters=self.iters)
        pop_X, pop_F = evo.optimize(model=model, acq_params=params,
                                    initial_suggest=Xv[best_id : best_id + 1],
                                    fix_input=fix_input, return_pop=True, seed=self.num_obs)
        self.acq_time.append(time.time() - t0)
        mu_pop, var_pop = model.predict(pop_X)
        return pop_X, pop_F, mu_pop, var_pop

    # ------------------------------------------------------- fused suggest
    def _suggest_inputs(self, Xv, yt, kappa, fix_input, pop: Optional[int] = None):
        """Host side of one suggest: the bucket, the column metadata and
        every per-suggest input packed into one float32 array (the JAX
        package's packing, hebo.py:342-367): [X (n_pad, D) | y (n_pad) |
        mask (n_pad) | x_lb (nd) | x_span (nd) | y_mean | y_std | κ |
        init_pop (pop, D)]; ``pop`` defaults to ``self.pop``."""
        space = self.space
        n_pad = pad_bucket(max(len(Xv), 2))
        meta = _space_meta(space, fix_input)
        init_pop = space.sobol_sample_opt(pop or self.pop, seed=self.num_obs).astype(np.float32)
        for name, val in (fix_input or {}).items():
            p = space.params[name]
            c0 = space._col_of[name]
            tv = np.asarray(p.transform(np.asarray([val]))).ravel()
            init_pop[:, c0 : c0 + p.num_cols] = tv[None, :]
        D = space.num_cols
        nd = list(self.model.core.numeric_dims)
        Xv = np.asarray(Xv, np.float32)
        yt = np.asarray(yt, np.float32).reshape(-1, 1)
        n = len(Xv)
        Xp = np.zeros((n_pad, D), np.float32)
        yp = np.zeros(n_pad, np.float32)
        mask = np.zeros(n_pad, np.float32)
        Xp[:n] = Xv
        y_mean = float(yt.mean())
        y_std = float(yt.std())
        y_std = y_std if y_std > 1e-8 else 1.0
        yp[:n] = (yt[:, 0] - y_mean) / y_std
        mask[:n] = 1.0
        lb = Xv[:, nd].min(axis=0) if nd else np.zeros(0, np.float32)
        ub = Xv[:, nd].max(axis=0) if nd else np.zeros(0, np.float32)
        span = np.where(ub - lb < 1e-8, 1.0, ub - lb)
        host = np.concatenate([Xp.ravel(), yp, mask, lb, span,
                               [y_mean, y_std, kappa], init_pop.ravel()]).astype(np.float32)
        return n_pad, meta, host

    def _draws(self, device) -> SuggestDraws:
        """Empty buffers for every random number of one suggest."""
        core = self.model.core
        R, D = self.model.n_restarts, self.space.num_cols
        n_normal = R * (core.total_cats * _emb_cols(core) + core.d_feat)
        n_normal += core.n_steps * sum(math.prod(s) for s in _leaf_shapes(core, R)) + self.pop
        n_normal += self._acq.n_normals
        return SuggestDraws(
            normal=torch.empty(n_normal, device=device),
            sel=torch.empty((self.iters, 2, self.pop), dtype=torch.int64, device=device),
            uni=torch.empty((self.iters, 8, self.pop, D), device=device),
            fit_uni=torch.empty(_slice_shape(core, R), device=device),
        )

    def _suggest_program(self, n_pad, mt, inputs, dr, loop=None):
        """The device part of one suggest (the JAX package's one program,
        hebo.py:214-397): GP fit (stacked restarts, pSGLD), posterior
        caches, incumbent, MACE + NSGA-II, the population's posterior.
        Reads only ``inputs`` and the draws ``dr``, and returns the packed
        [pop_X | pop_F | μ | σ²] and (data, params, samples, caches).  On
        CUDA it holds no host sync, so it can be captured as a graph.
        ``loop(step, n)`` runs the slice optimizer's coordinate step n
        times (``inference.slice_sample``)."""
        core, model, acq = self.model.core, self.model, self._acq
        R, P = self.model.n_restarts, self.pop
        data, kappa, init = self._unpack(inputs, n_pad, P)

        shapes = _leaf_shapes(core, R)
        sizes = [R * core.total_cats * _emb_cols(core), R * core.d_feat,
                 core.n_steps * sum(math.prod(s) for s in shapes), P, acq.n_normals]
        z_emb, z_ls, psgld, z, draw = torch.split(dr.normal, sizes)
        steps = torch.split(psgld.view(core.n_steps, -1), [math.prod(s) for s in shapes], 1)
        pf, samples = map_fit(
            core, data, R,
            init_draws=(z_emb.view(R, core.total_cats, _emb_cols(core)), z_ls.view(R, core.d_feat)),
            noise=lambda i: [t[i].view(s) for t, s in zip(steps, shapes)],
            uniforms=dr.fit_uni, loop=loop,
        )
        caches = core.posterior_cache_batched(samples, data)
        state = (samples, caches, data)
        xb, pr = self._incumbent(state, pf, kappa, z.view(P, 1), draw)
        init[0] = xb[0]
        pop_X, pop_F = evolve_raw(
            init, lambda Xc: acq.eval_pure(model, state, pr, Xc), None, n_gens=self.iters,
            draws=lambda g: GenDraws(dr.sel[g], *dr.uni[g].unbind(0)), mt=mt,
        )
        mu_pop, var_pop = model.predict_pure(state, pop_X)
        out = torch.cat([pop_X, pop_F, mu_pop, var_pop], 1)
        return out, (data, pf, samples, caches)

    def _unpack(self, inputs, n_pad: int, P: int):
        """(data, κ, the initial population (P, D), a copy) from the packed
        inputs (``_suggest_inputs``)."""
        D, nd = self.space.num_cols, len(self.model.core.numeric_dims)
        parts = torch.split(inputs, [n_pad * D, n_pad, n_pad, nd, nd, 3, P * D])
        data = GPData(X=parts[0].view(n_pad, D), y=parts[1].view(n_pad, 1),
                      mask=parts[2] > 0.5, x_lb=parts[3], x_span=parts[4],
                      y_mean=parts[5][0], y_std=parts[5][1])
        return data, parts[5][2], parts[6].view(P, D).clone()

    def _incumbent(self, state, pf, kappa, z, draw):
        """The best observed point (1, D) and the acquisition's parameters:
        its posterior mean as τ (model frame), the noise scale of the
        fitted params ``pf`` (leading axis 1), MACE's z and the
        acquisition's own normals."""
        data, core = state[2], self.model.core
        y_masked = torch.where(data.mask, data.y[:, 0], torch.full_like(data.y[:, 0], float("inf")))
        xb = data.X.index_select(0, torch.argmin(y_masked).reshape(1))
        mu_b, _ = self.model.predict_pure(state, xb)
        noise_scale = torch.sqrt(torch.exp(pf.log_noise[0]) + core.noise_lb) * data.y_std
        return xb, AcqParams(tau=mu_b[0, 0], kappa=kappa, eps=1e-4, noise=noise_scale, z=z,
                             draw=draw.view(1, -1) if self._acq.n_normals else None)

    def _mesh_pop(self) -> int:
        """``pop`` rounded up to a multiple of the world size (equal islands)."""
        world = mesh_size(self.mesh)
        return -(-self.pop // world) * world

    def _sharded_program(self, n_pad, mt, inputs, z, draw, generator, fit_draws=None,
                         island_draws=None):
        """The device part of one suggest on the mesh (sharded.py:153-278):
        this rank's ``n_restarts`` chains (``GPCore.fit_from``, from
        ``generator`` or ``fit_draws`` = (init draws, pSGLD noise(step))),
        the first argmin over every rank's chains (``select_chain``), the
        caches, the incumbent, this rank's island (``island_evolve``, its
        draws from ``generator`` or ``island_draws(round, generation)``)
        and the islands' packed [pop_X | pop_F | μ | σ²] all-gathered.
        ``z`` (pop / world, 1) and ``draw`` are the replicated draws.
        Returns the packed output on every rank and (data, params,
        samples, caches)."""
        core, model, acq, mesh = self.model.core, self.model, self._acq, self.mesh
        P = self._mesh_pop()
        P_loc = P // mesh_size(mesh)
        data, kappa, init = self._unpack(inputs, n_pad, P)
        init_draws, noise = fit_draws if fit_draws is not None else (None, None)
        p0 = core.init_params(data, model.n_restarts, generator, draws=init_draws)
        pf, loss, samples = core.fit_from(p0, data, generator, noise=noise)
        pf, samples = select_chain((pf, samples), loss, mesh, (0, 1))
        caches = core.posterior_cache_batched(samples, data)
        state = (samples, caches, data)
        xb, pr = self._incumbent(state, pf, kappa, z, draw)
        init[0] = xb[0]
        r0 = mesh_rank(mesh) * P_loc
        X, F = island_evolve(init[r0:r0 + P_loc], lambda Xc: acq.eval_pure(model, state, pr, Xc), mt,
                             self.iters, self.migrate_every, mesh, generator=generator,
                             draws=island_draws)
        mu, var = model.predict_pure(state, X)
        return all_gather(torch.cat([X, F, mu, var], 1), mesh), (data, pf, samples, caches)

    @torch.no_grad()
    def _sharded_suggest(self, Xv, yt, kappa, fix_input):
        """The mesh route: inputs, draws, ``_sharded_program``, eagerly."""
        dev, P = self.device, self._mesh_pop()
        n_pad, meta, host = self._suggest_inputs(Xv, yt, kappa, fix_input, P)
        t0 = time.time()
        seed = self.num_obs % (1 << 30)
        shared = torch.Generator(device=dev).manual_seed(seed)
        z = torch.randn((P // mesh_size(self.mesh), 1), generator=shared, device=dev)
        k = self._acq.n_normals
        draw = torch.randn((1, k), generator=shared, device=dev) if k else None
        out, state = self._sharded_program(n_pad, meta_tensors(meta, dev),
                                           torch.as_tensor(host, device=dev), z, draw,
                                           rank_generator(seed, self.mesh, dev))
        return self._take(out, state, t0)

    def _device_suggest(self, n_pad, meta, host):
        """Inputs to the device, draws, the program; returns the packed
        output on the device (not yet copied back) and the fitted state.

        On CUDA (unless ``_use_graphs`` is False, the eager comparison
        path) the program is one CUDA graph per (bucket, metadata) (three
        with the slice optimizer, ``_Segments``), captured at the bucket's
        first suggest and replayed after it: the
        host copies the inputs through pinned memory, fills the draw
        buffers from a generator seeded by the observation count, and
        replays, with no host sync.  The CPU and the eager path run the
        same program on the same draws."""
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.num_obs % (1 << 30))
        if dev.type != "cuda" or not self._use_graphs:
            dr = self._draws(dev)
            _fill(dr, gen, self.pop)
            inputs = torch.as_tensor(host, device=dev)
            return self._suggest_program(n_pad, meta_tensors(meta, dev), inputs, dr)
        g = self._graphs.get((n_pad, meta))
        if g is None:
            g = self._graphs[(n_pad, meta)] = self._capture(n_pad, meta, host, gen)
        else:
            g.staging.numpy()[:] = host
            g.inputs.copy_(g.staging, non_blocking=True)
            _fill(g.draws, gen, self.pop)
        g.graphs.replay()
        for (w, f), n in g.graphs.tally.items():
            setattr(w, f, getattr(w, f) + n)
        return g.out, g.state

    def _capture(self, n_pad, meta, host, gen) -> "_SuggestGraph":
        """Static buffers for a bucket, one eager warm-up run of the
        program on a side stream (the autograd engine's and the kernels'
        one-time set-up: ``cudaFuncSetAttribute``, the SM count, cuBLAS
        workspaces; a loop runs its step once), then the capture
        (``_Segments``: one graph, or three around the slice optimizer's
        coordinate step).  The wrappers' launch counts of the captured run
        are kept as its tally, which each replay adds; a capture that
        fails raises."""
        dev = self.device
        staging = torch.from_numpy(host.copy()).pin_memory()
        inputs = torch.empty(len(host), device=dev)
        inputs.copy_(staging, non_blocking=True)
        dr = self._draws(dev)
        _fill(dr, gen, self.pop)
        mt = meta_tensors(meta, dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._suggest_program(n_pad, mt, inputs, dr, loop=lambda step, n: step())
        torch.cuda.synchronize(dev)
        graphs = _Segments()
        with torch.cuda.stream(side):
            graphs.begin()
            try:
                out, state = self._suggest_program(n_pad, mt, inputs, dr, loop=graphs.loop)
            finally:
                graphs.end()  # ends the open capture, also when the program raised
        torch.cuda.current_stream(dev).wait_stream(side)
        return _SuggestGraph(graphs, staging, inputs, dr, mt, out, state)

    @torch.no_grad()
    def _fused_suggest(self, Xv, yt, kappa, fix_input):
        n_pad, meta, host = self._suggest_inputs(Xv, yt, kappa, fix_input)
        t0 = time.time()
        return self._take(*self._device_suggest(n_pad, meta, host), t0)

    def _take(self, out, state, t0):
        """Copy the packed output back, time the suggest since ``t0``, keep
        the fitted state on the model; returns (pop_X rounded, pop_F, μ, σ²)."""
        data, pf, samples, caches = state
        out = out.cpu().numpy()
        dt = time.time() - t0
        self.fit_time.append(dt)
        self.acq_time.append(dt)
        model = self.model
        model.data, model.params, model.samples, model.caches = data, pf, samples, caches
        D = self.space.num_cols
        n_obj = self._acq.num_out
        return (self.space.round_opt(out[:, :D]), out[:, D : D + n_obj],
                out[:, D + n_obj : D + n_obj + 1], out[:, D + n_obj + 1 : D + n_obj + 2])


class SuggestDraws(NamedTuple):
    """Every random number of one suggest, drawn before the program runs:
    ``normal`` holds init_params' embedding and lengthscale normals, the
    pSGLD normals of every step (one row per step, the ``GPParams`` leaves
    in leaf order), MACE's z and the acquisition's own ``n_normals``
    (``AcqParams.draw``); ``sel`` the tournaments' indices, ``uni``
    the eight uniforms of each generation (``GenDraws`` order) and
    ``fit_uni`` the slice sampler's uniforms (empty unless the GP's
    optimizer is ``slice``)."""

    normal: torch.Tensor  # (R·cats·E + R·D_feat + steps·Σ leaf + pop + n_normals,)
    sel: torch.Tensor  # (iters, 2, pop) int64
    uni: torch.Tensor  # (iters, 8, pop, D)
    fit_uni: torch.Tensor  # (sweeps, dim, 18, R), or (0,)


def _fill(dr: SuggestDraws, gen: torch.Generator, pop: int) -> None:
    dr.normal.normal_(generator=gen)
    dr.sel.random_(0, pop, generator=gen)
    dr.uni.uniform_(generator=gen)
    if dr.fit_uni.numel():
        dr.fit_uni.uniform_(generator=gen)


def _emb_cols(core) -> int:
    return core.emb_dim if core.total_cats else 0


def _leaf_shapes(core, R: int):
    """Shapes of the ``GPParams`` leaves of R stacked restarts, in leaf
    order (``noise_w`` only with heteroscedastic noise)."""
    shapes = [(R, core.d_feat), (R,), (R,), (R,), (R, core.total_cats, _emb_cols(core)),
              (R, core.d_num), (R, core.d_num)]
    return shapes + ([(R, core.n_feat_dims + 1)] if core.heteroscedastic else [])


def _slice_shape(core, R: int):
    """The slice sampler's uniforms for R restarts (``GPCore.fit_from_batched``:
    20 burn-in sweeps, then ``n_ensemble`` kept every second sweep), or none."""
    if core.optimizer != "slice":
        return (0,)
    dim = sum(math.prod(s[1:]) for s in _leaf_shapes(core, R))
    return (20 + 2 * core.n_ensemble, dim, 18, R)


class _Segments:
    """A program captured as a chain of CUDA graphs in one memory pool: one
    graph, or, where the program calls ``loop(step, n)``, the part before
    the loop, the step (captured once, replayed n times) and the part after
    it.  Replays run in capture order, so a block that a later graph reuses
    is dead by then.  ``tally``: each wrapper's launch counts per replay of
    the chain, by (wrapper, count)."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.parts = []  # (graph, replays)
        self.tally: Dict[Tuple[Callable, str], int] = {}

    def begin(self):
        self._graph = torch.cuda.CUDAGraph()
        self._before = _counts()
        self._graph.capture_begin(pool=self.pool)

    def end(self, replays: int = 1):
        self._graph.capture_end()
        for (w, f), n in self._before.items():
            self.tally[w, f] = self.tally.get((w, f), 0) + (getattr(w, f) - n) * replays
            setattr(w, f, n)
        self.parts.append((self._graph, replays))

    def loop(self, step: Callable, n: int):
        self.end()
        self.begin()
        step()
        self.end(n)
        self.begin()

    def replay(self):
        for graph, replays in self.parts:
            for _ in range(replays):
                graph.replay()


class _SuggestGraph(NamedTuple):
    """One bucket's captured suggest: its graphs (with their launch tally),
    static inputs (and their pinned staging copy), draws and outputs."""

    graphs: _Segments
    staging: torch.Tensor
    inputs: torch.Tensor
    draws: SuggestDraws
    mt: MetaTensors
    out: torch.Tensor
    state: tuple


# the kernel wrappers of the suggest, whose ``.launches`` (and K5's
# ``.grid_launches``, past the one-CTA route's rows) a replay advances
COUNTED = (matern32_gram, matern32_gram_vjp, chol_factor, chol_winv, nsga2_rank_crowd)


def _counts() -> Dict[Tuple[Callable, str], int]:
    return {(w, f): getattr(w, f) for w in COUNTED for f in ("launches", "grid_launches")
            if hasattr(w, f)}
