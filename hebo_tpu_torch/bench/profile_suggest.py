"""Where one HEBO or AntBO suggest spends its time on a CUDA card.

    python3 -m hebo_tpu_torch.bench.profile_suggest [--obs 112 800] [--paths graph eager]
    python3 -m hebo_tpu_torch.bench.profile_suggest --antbo [--obs 28 200]
    python3 -m hebo_tpu_torch.bench.profile_suggest --large-n [--obs 3000]
    python3 -m hebo_tpu_torch.bench.profile_suggest --hmc [--obs 800]
    python3 -m hebo_tpu_torch.bench.profile_suggest --mcbo BOCS [Casmopolitan ...] [--obs 200]
    python3 -m hebo_tpu_torch.bench.profile_suggest --general zdt1 [bnh] [--obs 200]
    python3 -m hebo_tpu_torch.bench.profile_suggest --bo [--obs 200]
    python3 -m hebo_tpu_torch.bench.profile_suggest --variant svgp [dkl deep_ensemble gbdt nap] [--obs 3000]

For each observation count (and, for HEBO, each path: ``graph``, the
suggest as one captured CUDA graph per bucket, and ``eager``, the same
program launched op by op): HEBO on Ackley-6D with that many Sobol
observations (or, with ``--antbo``, AntBO's SSK GP on length-11 CDRH3
sequences drawn at random and scored by the AbsolutTool surrogate of
antigen 1H0D_C), one warm-up suggest (on the graph path it captures the
graph; its wall is reported as ``first_s``), then
* (HEBO) ``--timed`` suggests at the same observations, their walls;
* one suggest timed by phase (HEBO's eager path: fit, posterior cache,
  NSGA-II, each phase ending in ``torch.cuda.synchronize()``; a captured
  graph has no phases; AntBO: the optimizer's own fit and acquisition
  timers);
* one suggest under ``torch.profiler`` (CPU + CUDA): wall time, summed
  device kernel time (its share of the wall time is the busy share), the
  device kernels (a graph's nodes count as kernels), the host's launch
  calls (``cudaLaunchKernel`` and its kin) and graph launches apart, the
  top kernels by device time; kernel K5's launches and device ms, and the
  sort kernels' (every kernel whose name holds "sort") by name; kernel
  K1's rungs that every matrix skipped, with their device launches, apart
  from the rungs that factor; kernel K1's device kernels
  with their launches per K1 call (``chol_factor`` or, from 8 tiles, the
  fused ``chol_factor_inv``), kernel K3's ``ssk_cross`` and
  ``ssk_self`` kernels with their launches, device ms and µs per launch,
  the count of library factorization / triangular-solve kernels
  (cuSOLVER potrf, cuBLAS trsm), which no CUDA path of the port should
  launch, and (HEBO) a ``k2`` block: kernel K2's forward and VJP wrapper
  calls, the device launches, device ms and µs per launch of the forward
  and of the VJP kernels, and the device launches and µs inside one Gram
  backward at the fit's shape (B 2, the bucket, D 6), timed apart after
  the suggest with ``bench/gram_probe.device_per_call``.
With ``--large-n``, HEBO's generic route above ``max_cholesky_size``
(default 3000 Sobol observations: the fit on a 2048-point subsample, the
CG posterior at bucket 3072, ``EvolutionOpt``, all launched op by op): the
warm-up suggest, ``--timed`` suggests with the optimizer's own fit and
acquisition seconds, and one profiled suggest as above, plus the device
time of the kernels launched inside ``pcg_solve`` (its share of the
device time) and the number of PCG solves.  With ``--hmc``, the same for
HEBO with ``model_config={"inference": "hmc"}`` (default 800 observations,
bucket 1024; the generic route, eager): the MAP fit, then 4 HMC chains of
64 warm-up transitions and one kept, each transition up to 8 leapfrog
steps, every step one batched NLL at (4, bucket); with K1's calls by
batch size and the chains' acceptance rate.  With ``--mcbo PRESET ...``,
MCBO's named presets (``BO_ALGOS``) at chip_smoke phase i's setting: the
preset's defaults through ``build_bo(space, device="cuda")``, warm-started
with 200 random observations (bucket 256) of pest control with 25
stations (COMBO, BOCS, BOSS, BOiLS), of Ackley-53 (50 binary + 3
numerics; Casmopolitan, BODi, CoCaBO) or of the 60-D ``synt_simple`` box
(RDUCB), the problems of
``chip_smoke.mcbo_problems`` (the script at the repository's root, which
this mode imports), a warm-up ``suggest(1)``, one timed
with the optimizer's fit and acquisition seconds, and one profiled as
above, with K1's calls by (batch × N) and K2's forward and VJP calls,
launches and device ms.  With ``--general PROBLEM ...``, ``GeneralBO`` at
chip_smoke phase j2's setting: its defaults (one GP per output, 100
epochs; NSGA-II pop 100 × 100) on ZDT1 (30 variables, 2 objectives) or BNH
(2 variables, 2 objectives, 2 constraints), the problems of
``chip_smoke.py``, warm-started with 200 Sobol observations, a warm-up
``suggest(4)``, one timed, and one profiled as above, each with its fit,
acquisition (NSGA-II) and EHVI seconds, and K5's and K2's launches.  With
``--bo``, ``BO`` at chip_smoke phase j1's setting (Ackley-6D, 200 Sobol
observations, suggest(1), eager), timed and profiled as ``--general``.  With
``--variant MODEL ...``, HEBO's generic route as ``--large-n`` with
``HEBO(model_name=MODEL)`` (chip_smoke phase k's and l's setting: 800
Sobol observations, 3000 for ``svgp``; NAP's meta-training, in the
warm-up suggest, reported apart).
Prints one JSON line per observation count (per preset, per problem).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import DesignSpace, HEBO, meta  # noqa: F401  (meta registers "nap")
from ..optimizers import hebo as hebo_mod
from ..ops import chol as chol_mod
from ..ops import chol_kernel, gram, pareto, ssk
from ..models.gp import gp as gp_mod
from ..optimizers.antbo import AntBOOptimizer
from ..tasks import AbsolutTool, PestControlTask
from .gram_probe import device_per_call


def _ackley(df):
    X = df[[f"x{i}" for i in range(6)]].values.astype(float)
    s1 = np.sqrt((X ** 2).mean(1))
    s2 = np.cos(2 * math.pi * X).mean(1)
    return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + math.e).reshape(-1, 1)


def _timed(fn, log, name):
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        log[name] = log.get(name, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


class _RungLog:
    """Records the skip flags of every K1 call the ladder makes (on the
    graph path: the calls made while capturing, whose flags each replay
    rewrites in place), to tell the rungs that every matrix skipped from
    the rungs that factor."""

    def __init__(self):
        self.calls = []
        self._saved = chol_mod.factor_inv

        def factor(K, jitter=None, skip=None, out=None):
            capturing = torch.cuda.is_current_stream_capturing()
            nt = chol_kernel.padded_size(K.shape[-1]) // chol_kernel.TILE
            if chol_kernel.route(K.shape[-1]) == "flow":  # the fused call
                launches = 2
            else:
                launches = nt + (2 if chol_kernel.winv_route(K.shape[-1]) == "flow" else 1)
            self.calls.append((capturing, skip, launches))
            return self._saved(K, jitter, skip, out)

        chol_mod.factor_inv = factor

    def close(self):
        chol_mod.factor_inv = self._saved

    def count(self, captured: bool) -> dict:
        """Rungs skipped by every matrix and their device launches (from 8
        tiles the fused call's 2; below, K1a's nt on its step route and
        K1b's 1 on its copy route or 2 on its flow route), and the rungs
        that factor."""
        calls = [c for c in self.calls if c[0] == captured]
        skipped = [k1 for _, skip, k1 in calls if skip is not None and bool(skip.all())]
        launches = sum(skipped)
        return {"k1_rungs": len(calls), "k1_rungs_skipped": len(skipped),
                "k1_rungs_factoring": len(calls) - len(skipped),
                "k1_skipped_rung_launches": launches}


class K1Batches:
    """Counts K1 calls of the jitter ladder by (batch x size) while it is
    open (the wrappers' own ``launches`` still count every launch): wraps
    the module global that the ladder calls (``factor_inv``)."""

    def __init__(self):
        self.saved, self.by_batch = chol_mod.factor_inv, {}

        def factor(K, *a, **k):
            key = f"{K.shape[0]}x{K.shape[-1]}"
            self.by_batch[key] = self.by_batch.get(key, 0) + 1
            return self.saved(K, *a, **k)

        chol_mod.factor_inv = factor

    def take(self) -> dict:
        """The counts since the last ``take``, and a fresh start."""
        out, self.by_batch = self.by_batch, {}
        return out

    def close(self):
        chol_mod.factor_inv = self.saved


def profile(n_obs: int, path: str = "graph", n_timed: int = 3) -> dict:
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, device="cuda")
    opt._use_graphs = path == "graph"
    warm = space.inverse_transform(space.sobol_sample_opt(n_obs, seed=1))
    opt.observe(warm, _ackley(warm))
    rungs = _RungLog()
    try:
        t0 = time.perf_counter()
        opt.suggest(8)  # warm-up: builds/loads kernels, cuBLAS handles; captures the graph
        first_s = time.perf_counter() - t0
        walls = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            opt.suggest(8)
            walls.append(time.perf_counter() - t0)
        phases = {"first_s": first_s, "s_per_suggest": walls,
                  "s_median": float(np.median(walls)) if walls else None}
        if path == "eager":
            core_cls = type(opt.model.core)
            saved = (hebo_mod.map_fit, hebo_mod.evolve_raw, core_cls.posterior_cache_batched)
            hebo_mod.map_fit = _timed(saved[0], phases, "fit_s")
            hebo_mod.evolve_raw = _timed(saved[1], phases, "nsga2_s")
            core_cls.posterior_cache_batched = _timed(saved[2], phases, "cache_s")
            try:
                t0 = time.perf_counter()
                opt.suggest(8)
                phases["suggest_s"] = time.perf_counter() - t0
            finally:
                hebo_mod.map_fit, hebo_mod.evolve_raw, core_cls.posterior_cache_batched = saved

        bucket = int(opt.model.data.X.shape[0])
        calls = (gram.matern32_gram.launches, gram.matern32_gram_vjp.launches)
        if path == "eager":
            rungs.calls.clear()
        prof = _device_profile(lambda: opt.suggest(8))
        k1_rungs = rungs.count(captured=path == "graph")
    finally:
        rungs.close()
    by_name = prof.pop("by_name")
    k5 = _k5_and_sorts(by_name)
    return {"n_obs": n_obs, "bucket": bucket, "path": path, "device": torch.cuda.get_device_name(0),
            **phases, **prof, **k1_rungs, **k5,
            "k5_us_per_launch": 1e3 * k5["k5_device_ms"] / max(k5["k5_launches"], 1),
            "k2": _k2_block(by_name, calls, bucket)}


def _k5_and_sorts(by_name) -> dict:
    """Kernel K5's launches and device ms in the profiled suggest (both
    routes' kernels: every name holding "nsga2_"), and those
    of the sort kernels (every device kernel whose name holds "sort"), by
    name and summed."""
    k5 = [(n, ms) for k, (n, ms) in by_name.items() if "nsga2_" in k]
    sorts = {k: (n, ms) for k, (n, ms) in by_name.items() if "sort" in k.lower()}
    return {"k5_launches": sum(n for n, _ in k5), "k5_device_ms": sum(ms for _, ms in k5),
            "sort_launches": sum(n for n, _ in sorts.values()),
            "sort_device_ms": sum(ms for _, ms in sorts.values()),
            "sort_kernels": {k[:80]: {"n": n, "ms": ms} for k, (n, ms) in sorts.items()}}


def _k2_counts(by_name, calls) -> dict:
    """K2's forward and VJP wrapper calls since ``calls``, and their device
    launches, ms and µs per launch in the profiled suggest."""
    block = {"fwd_calls": gram.matern32_gram.launches - calls[0],
             "vjp_calls": gram.matern32_gram_vjp.launches - calls[1]}
    for part, key in (("fwd", "matern32_gram"), ("vjp", "matern32_vjp")):
        n = sum(n for k, (n, _) in by_name.items() if key in k)
        ms = sum(ms for k, (_, ms) in by_name.items() if key in k)
        block.update({f"{part}_launches": n, f"{part}_device_ms": ms,
                      f"{part}_us_per_launch": 1e3 * ms / max(n, 1)})
    return block


def _k2_block(by_name, calls, bucket) -> dict:
    """K2 in the profiled suggest, and one Gram backward at the fit's
    shape timed apart."""
    block = _k2_counts(by_name, calls)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    leaves = [torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=dev)
              .requires_grad_(True) for s in ((2, bucket, 6), (2, bucket, 6), (2,))]
    K = gram.matern32_gram(*leaves)
    g = torch.randn_like(K)
    us, n = device_per_call(torch, lambda: torch.autograd.grad(K, leaves, g, retain_graph=True), 200)
    block.update(one_backward_launches=n, one_backward_device_us=us)
    return block


def profile_generic(n_obs: int, n_timed: int = 3, model_config=None, model_name: str = "gp") -> dict:
    """HEBO's generic route at ``n_obs`` Sobol observations of Ackley-6D:
    above max_cholesky_size (subsampled fit, CG posterior), a GP with a
    hyperparameter sampler (``model_config``), or another surrogate
    (``model_name``: ``svgp``, ``dkl``, ``uncertain_gp``, ``deep_ensemble``,
    ``gbdt``, ``nap``, ...).  NAP meta-trains in the warm-up suggest: its
    seconds are reported apart (``meta_train_s``)."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, model_name=model_name, device="cuda", model_config=model_config)
    warm = opt.quasi_sample(n_obs)
    opt.observe(warm, _ackley(warm))
    t0 = time.perf_counter()
    opt.suggest(8)  # warm-up: builds/loads kernels, cuBLAS handles
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        opt.suggest(8)
        walls.append(time.perf_counter() - t0)
    saved, pcg_calls = gp_mod.pcg_solve, []

    def pcg(*a, **k):
        pcg_calls.append(1)
        with torch.profiler.record_function("pcg_solve"):
            return saved(*a, **k)

    gp_mod.pcg_solve = pcg
    calls = (gram.matern32_gram.launches, gram.matern32_gram_vjp.launches)
    k1 = K1Batches()
    try:
        prof = _device_profile(lambda: opt.suggest(8))
    finally:
        gp_mod.pcg_solve = saved
        k1.close()
    by_name = prof.pop("by_name")
    pcg_ms = prof.pop("range_device_ms").get("pcg_solve", 0.0)
    model = opt.model
    data = getattr(model, "data", None)  # None: a surrogate that is not a GP
    fit_data = getattr(model, "fit_data", None) or data
    caches = getattr(model, "caches", None)
    return {"model": model_name, "n_obs": n_obs,
            "fit_bucket": None if fit_data is None else int(fit_data.X.shape[0]),
            "bucket": None if data is None else int(data.X.shape[0]), "path": "generic",
            "device": torch.cuda.get_device_name(0), "first_s": first_s,
            "meta_train_s": getattr(model, "meta_train_s", None), "s_per_suggest": walls,
            "s_median": float(np.median(walls)) if walls else None,
            "fit_s": opt.fit_time[-n_timed - 1:-1], "acq_s": opt.acq_time[-n_timed - 1:-1],
            "cg_residual": None if caches is None or caches.res is None else float(caches.res.max()),
            "inference": getattr(model, "inference", None), "k1_calls_by_batch": k1.take(),
            "accept_rate": (None if getattr(model, "accept_rate", None) is None
                            else model.accept_rate.tolist()),
            **prof,
            "pcg_solves": len(pcg_calls), "pcg_device_ms": pcg_ms,
            "pcg_share_of_device": pcg_ms * 1e-3 / max(prof["device_kernel_s"], 1e-12),
            **_k5_and_sorts(by_name),
            "k2": None if fit_data is None else _k2_block(by_name, calls, int(fit_data.X.shape[0]))}


def profile_antbo(n_obs: int) -> dict:
    opt = AntBOOptimizer(seq_len=11, kernel="ssk", device="cuda")
    tool = AbsolutTool("1H0D_C", seq_len=11)
    warm = opt.space.sample(n_obs, seed=1)
    opt.observe(warm, tool(["".join(r) for _, r in warm.iterrows()]))
    opt.suggest(2)  # warm-up
    t0 = time.perf_counter()
    opt.suggest(2)
    torch.cuda.synchronize()
    phases = {"suggest_s": time.perf_counter() - t0, "fit_s": opt.fit_time[-1],
              "acq_s": opt.acq_time[-1]}
    prof = _device_profile(lambda: opt.suggest(2))
    prof.pop("by_name")
    return {"n_obs": n_obs, "bucket": int(opt.model.data.X.shape[0]),
            "device": torch.cuda.get_device_name(0), **phases, **prof}


def profile_mcbo(name: str, n_obs: int = 200) -> dict:
    from ..optimizers.bo_builder import BO_ALGOS

    # phase i's problems are defined once, in the repository's chip_smoke.py
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    problem = dict(chip_smoke.MCBO_PRESETS)[name]
    space, f = chip_smoke.mcbo_problems(DesignSpace, PestControlTask)[problem]
    opt = BO_ALGOS[name].build_bo(space, n_init=10, seed=0, device="cuda")
    warm = space.sample(n_obs, seed=1)
    opt.observe(warm, f(warm))

    def step():
        rec = opt.suggest(1)
        torch.cuda.synchronize()
        opt.observe(rec, f(rec))

    t0 = time.perf_counter()
    step()  # warm-up: builds/loads kernels, cuBLAS handles
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step()
    phases = {"first_s": first_s, "suggest_s": time.perf_counter() - t0,
              "fit_s": opt.fit_time[-1], "acq_s": opt.acq_time[-1]}
    calls = (gram.matern32_gram.launches, gram.matern32_gram_vjp.launches)
    k1 = K1Batches()
    try:
        prof = _device_profile(step)
    finally:
        k1.close()
    by_name = prof.pop("by_name")
    prof.pop("range_device_ms")
    model = opt.model
    return {"preset": name, "n_obs": n_obs,
            "bucket": int(model.data.X.shape[0]) if hasattr(model, "data") else None,
            "device": torch.cuda.get_device_name(0), **phases,
            "profiled_fit_s": opt.fit_time[-1], "profiled_acq_s": opt.acq_time[-1], **prof,
            "k1_calls_by_batch": k1.take(), **_k5_and_sorts(by_name),
            "k2": _k2_counts(by_name, calls)}


def profile_general(problem: str, n_obs: int = 200) -> dict:
    from ..optimizers import GeneralBO

    # phase j2's problems are defined once, in the repository's chip_smoke.py
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import chip_smoke

    if problem == "zdt1":
        space = chip_smoke.unit_space(DesignSpace, [f"x{i}" for i in range(30)])
        f, n_constr = chip_smoke.zdt1, 0
    else:
        space = DesignSpace([{"name": "x1", "type": "num", "lb": 0.0, "ub": 5.0},
                             {"name": "x2", "type": "num", "lb": 0.0, "ub": 3.0}])
        f, n_constr = chip_smoke.bnh, 2
    opt = GeneralBO(space, num_obj=2, num_constr=n_constr, device="cuda")
    chip_smoke.warm(opt, space, f, n_obs)

    def step():
        rec = opt.suggest(4)
        torch.cuda.synchronize()
        opt.observe(rec, f(rec))

    t0 = time.perf_counter()
    step()  # warm-up: builds/loads kernels, cuBLAS handles
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step()
    phases = {"first_s": first_s, "suggest_s": time.perf_counter() - t0,
              "fit_s": opt.fit_time[-1], "acq_s": opt.acq_time[-1], "ehvi_s": opt.ehvi_time[-1]}
    calls = (gram.matern32_gram.launches, gram.matern32_gram_vjp.launches)
    prof = _device_profile(step)
    by_name = prof.pop("by_name")
    prof.pop("range_device_ms")
    return {"problem": problem, "n_obs": n_obs, "gps": len(opt.model.models),
            "bucket": int(opt.model.models[0].data.X.shape[0]), "dims": space.num_cols,
            "device": torch.cuda.get_device_name(0), **phases,
            "profiled_fit_s": opt.fit_time[-1], "profiled_acq_s": opt.acq_time[-1],
            "profiled_ehvi_s": opt.ehvi_time[-1], **prof, **_k5_and_sorts(by_name),
            "k2": _k2_counts(by_name, calls)}


def profile_bo(n_obs: int = 200) -> dict:
    """``BO`` at chip_smoke phase j1's setting: its defaults (``GP.fit``,
    ``EvolutionOpt`` pop 100 × 100, eager) on Ackley-6D with ``n_obs``
    Sobol observations, a warm-up ``suggest(1)``, one timed and one
    profiled, with K5's and the sort kernels' launches and device ms."""
    from ..optimizers import BO

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = BO(space, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(n_obs, seed=1))
    opt.observe(warm, _ackley(warm))

    def step():
        rec = opt.suggest(1)
        torch.cuda.synchronize()
        opt.observe(rec, _ackley(rec))

    t0 = time.perf_counter()
    step()  # warm-up: builds/loads kernels, cuBLAS handles
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step()
    phases = {"first_s": first_s, "suggest_s": time.perf_counter() - t0,
              "fit_s": opt.fit_time[-1], "acq_s": opt.acq_time[-1]}
    prof = _device_profile(step)
    by_name = prof.pop("by_name")
    prof.pop("range_device_ms")
    return {"optimizer": "BO", "n_obs": n_obs, "device": torch.cuda.get_device_name(0), **phases,
            "profiled_fit_s": opt.fit_time[-1], "profiled_acq_s": opt.acq_time[-1], **prof,
            **_k5_and_sorts(by_name)}


_RANGES = ("pcg_solve",)


def _device_profile(suggest) -> dict:
    """One suggest under torch.profiler: wall, device time, busy share,
    launches and the top kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    k1_calls = chol_kernel.chol_factor.launches + chol_kernel.chol_factor_inv.launches
    k3_calls = {"ssk_cross": ssk.ssk_cross.launches, "ssk_self": ssk.ssk_self.launches}
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        suggest()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1_calls = chol_kernel.chol_factor.launches + chol_kernel.chol_factor_inv.launches - k1_calls
    k3_calls = {k: getattr(ssk, k).launches - n for k, n in k3_calls.items()}
    # device events, less the device side of the user ranges (record_function)
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in _RANGES]
    api = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith(("cuda", "cu")):
            api[e.name] = api.get(e.name, 0) + 1
    host_launches = sum(n for k, n in api.items() if "LaunchKernel" in k)
    graph_launches = sum(n for k, n in api.items() if "GraphLaunch" in k)
    by_name = {}
    for e in kern:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.device_time_total * 1e-3)
    dev_s = sum(ms for _, ms in by_name.values()) * 1e-3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    k1 = {k.split("::")[-1].split("(")[0]: {"n": n, "ms": ms, "per_call": n / max(k1_calls, 1)}
          for k, (n, ms) in by_name.items() if "chol_" in k or "winv_" in k}
    k3 = {}
    for mode, calls in k3_calls.items():
        n = sum(n for k, (n, _) in by_name.items() if mode in k)
        ms = sum(ms for k, (_, ms) in by_name.items() if mode in k)
        k3[mode] = {"calls": calls, "n": n, "ms": ms, "us_per_launch": 1e3 * ms / max(n, 1)}
    library = sum(n for k, (n, _) in by_name.items()
                  if any(w in k.lower() for w in ("potrf", "trsm", "trsv", "cusolver")))
    # user ranges (record_function): device time of the kernels launched inside
    ranges = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in _RANGES:
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total * 1e-3
    return {
        "profiled_wall_s": wall, "device_kernel_s": dev_s,
        "device_busy_share": dev_s / wall, "kernel_launches": len(kern),
        "host_kernel_launches": host_launches, "graph_launches": graph_launches,
        "host_api_calls": dict(sorted(api.items(), key=lambda kv: -kv[1])[:8]),
        "top_kernels_ms": {k[:80]: {"n": n, "ms": ms} for k, (n, ms) in top},
        "k1_calls": k1_calls, "k1_kernels": k1,
        "k1_device_ms": sum(v["ms"] for v in k1.values()),
        "k3_kernels": k3, "k3_device_ms": sum(v["ms"] for v in k3.values()),
        "library_linalg_launches": library, "by_name": by_name, "range_device_ms": ranges,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--antbo", action="store_true", help="profile AntBO (SSK GP) instead of HEBO")
    ap.add_argument("--large-n", action="store_true",
                    help="profile HEBO's generic route above max_cholesky_size (default 3000 obs)")
    ap.add_argument("--hmc", action="store_true",
                    help="profile HEBO with the GP's HMC posterior (default 800 obs)")
    ap.add_argument("--mcbo", nargs="+", default=None, metavar="PRESET",
                    help="profile these BO_ALGOS presets at chip_smoke phase i's setting")
    ap.add_argument("--variant", nargs="+", default=None, metavar="MODEL",
                    help="profile HEBO's generic route with these surrogates (svgp, dkl, "
                         "uncertain_gp, gp_rd, deep_ensemble, gbdt, nap, ...; default 800 obs, "
                         "svgp 3000)")
    ap.add_argument("--general", nargs="+", default=None, choices=["zdt1", "bnh"],
                    help="profile GeneralBO on these problems at chip_smoke phase j2's setting")
    ap.add_argument("--bo", action="store_true",
                    help="profile BO (GP.fit, EvolutionOpt) at chip_smoke phase j1's setting")
    ap.add_argument("--obs", type=int, nargs="+", default=None,
                    help="observation counts (default 112 800; with --antbo 28 200; with --mcbo "
                         "and --general 200)")
    ap.add_argument("--paths", nargs="+", default=["graph", "eager"], choices=["graph", "eager"],
                    help="HEBO's paths to profile (default both)")
    ap.add_argument("--timed", type=int, default=3, help="timed suggests per path (HEBO)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_suggest: needs a CUDA device")
    if args.bo:
        for n in args.obs or [200]:
            print(json.dumps(profile_bo(n)), flush=True)
        return
    if args.general:
        for problem in args.general:
            for n in args.obs or [200]:
                print(json.dumps(profile_general(problem, n)), flush=True)
        return
    if args.variant:
        for name in args.variant:
            for n in args.obs or [3000 if name == "svgp" else 800]:
                print(json.dumps(profile_generic(n, args.timed, model_name=name)), flush=True)
        return
    if args.mcbo:
        for name in args.mcbo:
            for n in args.obs or [200]:
                print(json.dumps(profile_mcbo(name, n)), flush=True)
        return
    default = [28, 200] if args.antbo else [3000] if args.large_n else [800] if args.hmc else [112, 800]
    for n in args.obs or default:
        if args.large_n or args.hmc:
            conf = {"inference": "hmc"} if args.hmc else None
            print(json.dumps(profile_generic(n, args.timed, conf)), flush=True)
            continue
        if args.antbo:
            print(json.dumps(profile_antbo(n)), flush=True)
            continue
        for path in args.paths:
            print(json.dumps(profile(n, path, args.timed)), flush=True)


if __name__ == "__main__":
    main()
