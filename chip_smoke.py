#!/usr/bin/env python3
"""Smoke run of hebo_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Builds the CUDA kernels from ``hebo_tpu_torch/csrc`` (one nvcc per source,
   all at once: gram.cu, chol.cu, ssk.cu, pareto.cu) and prints ptxas'
   registers and spills per kernel; K3's register routes (regs, regs32,
   warp) must spill nothing, and each of their instantiations must
   be reported.
2. Holds each kernel against its plain PyTorch version at the main paths'
   shapes, and times the kernel, the plain version and one PyTorch library
   call where one computes the same function (the yardstick; the port never
   calls it).  Tolerances: Gram 1e-5 absolute (values ≤ outputscale ≈ 1.5);
   its VJP (ga, gb, gsc) 1e-4 × the largest |value| of each plain gradient
   (float32 sums over M or N terms in another order); L 1e-4 and W 1e-3
   absolute on SPD inputs AAᵀ/N + 0.5·I; SSK raw totals 1e-5 and tangents
   1e-4 relative, normalised SSK Gram 1e-5 absolute.
   K2 and its VJP run at every HEBO shape (fit, cache, NSGA-II predict at
   buckets 128 and 1024; the VJP at the fit's), with device µs per call
   (``bench/gram_probe.device_per_call``, torch.profiler) beside ms per
   call, the VJP also on a self-Gram with coincident rows, and twice on the
   same inputs, which must give the same bits.
   K1 runs at every shape of the main paths and prints library_ms / ms,
   each K1a row with the route it takes (``ops/chol_kernel.route``: "step",
   a launch per panel, or "flow", the persistent left-looking launch, from
   8 tiles) and with the same bits from a second call; at each flow-route
   shape also the fused call (``chol_factor_inv``: L, Wd and W in one
   launch pair) against the plain versions, its bits against chol_factor
   then chol_winv (W = chol_winv of its own L and Wd, bit for bit), the
   same bits twice and alone = in a batch, beside cholesky_ex +
   solve_triangular;
   with the jitter ladder's arguments (jitter on the diagonal, a skipped
   matrix that keeps its outputs) against its plain version, the ladder
   (every rung launched) against the host-decided ladder at the fit's
   shape, bit for bit, and the time of a rung that every matrix skips.
   K5 (nondominated rank, crowding, NSGA-II key and survivor order) at
   NSGA-II's (100, 3) and (200, 3), the MCBO GA's single objective (64, 1)
   and (128, 1), the family's and the latent loops' shapes and chains of
   200 fronts at M = 2 and 3, with ties, duplicate rows, ±inf and NaN
   objectives and invalid rows: the same ranks, crowding bits, keys and
   order as its plain version (``nsga2_key``, a stable argsort), with
   device µs; the same past its one-CTA route, on its grid route
   (``GRID_CASES``: 1,249-4,200 rows at M = 1-4, a 4,200-front chain and
   one whose rounded keys tie past 2^24), with every survivor's place;
   the one-CTA route also timed near its edge, (700, 3) and (1200, 3).
   K3 runs at every AntBO shape, BOSS / BOiLS' shapes at L 25, the edges of
   its register routes and two shapes on its general route, with each
   launch's route and device µs per launch (torch.profiler) beside ms per
   call, twice on the same inputs, which must give the same bits.
   Checks NaN propagation of the factorization on a batch with one non-PSD
   member and on one whose first bad pivot lies in a late tile (on each of
   K1a's routes), and the
   K1-backed ``cholesky_batched`` / ``chol_inv_batched`` API at (2, 512).
3. Drives HEBO's suggest/observe loop at full default settings (pop 100 ×
   100 generations, 2 restarts × 50 pSGLD epochs, MACE) through the public
   API, on the graph path (one captured CUDA graph per bucket), with every
   kernel launch counted (a replay adds its graph's tally):
   (a) Ackley-6D, batches of 8, from the Sobol init to 120 observations
       (bucket 128); the best y must beat the init phase's;
   (b) Ackley-6D warm-started with 800 Sobol observations (bucket 1024):
       the capturing suggest, then 3 timed suggests on the graph path and
       3 on the eager CUDA path, with walls and launches per suggest; each
       suggest after the capture must add exactly 50 K2 VJP, 200 K5 and
       107 K1 launches, each one fused call (51 NLL ladders of 2 rungs and
       the cache's 5, every rung launched), and no launch of the pair.  In (a) and (b) one more suggest on the graph
       path runs under torch.profiler: its device time, K5's device ms and
       the sort kernels' (fewer sort launches than generations, as NSGA-II
       takes its keys and survivors' order from K5).
   (b2) Ackley-6D warm-started with 400, 600, 1200 and 1800 Sobol
       observations (buckets 512, 768, 1536 and 2048, whose K1a takes the
       flow route like bucket 1024's): the capturing suggest;
   (b3) ``HEBO(space, pop=700)`` at 112 warm observations: survival ranks
       1,400 rows on K5's grid route inside the graph; a profiled suggest's
       K5 launches (200, 100 of them on the grid route) and device ms.
   Each phase ends with one suggest on each path at the same seed, which
   must give the same suggestion.  Every suggestion must be finite and
   inside the box, and every pSGLD step's Gram gradient must have gone
   through K2's VJP kernel.
4. Drives AntBO (CDRH3 length 11, 20 amino acids, SSK GP with max_subseq 3
   and 50 pSGLD epochs, constrained local search 256 × 8 × 8, Casmopolitan
   TR) on the AbsolutTool surrogate energy of antigen 1H0D_C, with the
   counts reset before it:
   (c) 10 Sobol init designs, then 10 × suggest(2) to 30 observations
       (bucket 32); the best energy must beat the init phase's;
   (d) 200 random designs (AntBO's budget) warm-started (bucket 256), then
       2 × suggest(2).
   Every suggestion must be 11 letters of the alphabet and every energy
   finite; fit and acquisition seconds are reported apart.
5. Drives HEBO above ``max_cholesky_size`` (phase e, the generic route:
   subsampled fit, pivoted-Cholesky-preconditioned CG posterior,
   ``EvolutionOpt``), with the counts reset before it:
   (e1) Ackley-6D at full defaults with 3000 Sobol observations: suggest(8),
        observe, then 3 timed suggest(8) (3000-3024 points, bucket 3072;
        the fit on a 2048-point subsample, bucket 2048).  Every batch must
        be finite, in the box and new against the history; the cache
        ``ok`` with a CG residual below 0.2; no fused graph used; and each
        suggest must launch exactly 155 K2, 50 K2 VJP, 200 K5 and
        102 fused K1 calls (51 NLL ladders of 2 rungs at bucket 2048) and
        1 + 1 K1a, K1b (the CG cache's k×k Woodbury factor);
   (e2) CG against the dense K1 route on the card at N = 2048 (tests/test_cg.py's
        setup: max_cholesky_size 1024, cg_rank 96, cg_iters 128, the same
        fitted samples): posterior means within rtol / atol 2e-2 and
        variances within rtol 5e-2 / atol 2e-2 at 100 query points, and
        within 1e-3 of the largest |μ| and 1e-2 of the largest σ²;
   (e3) the GP alone at N = 3600 and 7000 (buckets 3840 and 7168; the JAX
        package's bench.py:155-181): fit and predict(512), each timed after
        a warm call, the predictions finite;
   (e4) max_cholesky_size 4096 at 3000 observations: two suggest(8) on the
        fused graph at bucket 3072, whose posterior is the K1 ladder (K1a
        on its flow route), with valid batches and α's float64 residual
        below 0.2, then one suggest on each path, which must agree.
6. Drives the GP's options and hyperparameter inference through HEBO on
   Ackley-6D, batch 8, with the counts reset before each phase:
   (f) 800 warm Sobol observations (bucket 1024) with
       ``model_config={"input_warp": True, "heteroscedastic": True}``: the
       capture, 3 suggests on the fused graph and 3 eager, each with exactly
       phase b's launches (and 155 K2), the graph's suggestion equal to the
       eager one; then ``gpy_wgp`` and ``gpy_mlp`` at the same data, 2
       suggests each, on the generic route;
   (g) ``inference="hmc"`` at 120 and 800 observations, ``"smc"`` and
       ``"svi"`` at 800 (the generic route), 2 suggests each, and
       ``optimizer="slice"`` at 120 (the fused graph: the capture and one
       replay): walls, fit and acquisition seconds, launches per
       suggest, K1's calls by batch size (on the graph: those of the
       capture), HMC's acceptance rate;
   (h) ``GP.sample_f`` at bucket 1024 with 512 queries: the joint factor
       through K1's ladder at (1, 512), K1 against its plain version on that
       covariance (1e-4), and the mean of 256 draws within 4σ/√256 of
       ``predict`` at every query.
7. Drives MCBO's named presets (``BO_ALGOS``) through
   ``BoBuilder.build_bo(space, device="cuda")`` at their default settings
   (50 fit epochs, batch 1), each warm-started with 200 random observations
   (bucket 256), then 2 timed ``suggest(1)`` + observe (phase i):
   (i1) pest control at its published size, 25 stations × 5 choices
        (COMBO: the diffusion GP + local search; BOCS: the horseshoe linear
        model, 300 Gibbs sweeps each factoring at (1, 5051) through K1, SA
        over Thompson samples; BOSS: the SSK GP at L = 25 + the GA, K5;
        BOiLS: the SSK GP + the interleaved search);
   (i2) Ackley-53, 50 binary categoricals + 3 numerics in [−1, 1]
        (Casmopolitan and CoCaBO: the transformed-overlap GP, K2 at D = 3,
        with the interleaved search's and the bandit's gradient steps
        through K2's VJP in the query points; BODi: the HED GP, K2 at
        D = 19);
   (i3) RDUCB on LassoBench ``synt_simple``'s published box [−1, 1]^60
        with a stand-in objective of 30 random pairwise terms (the random
        tree's additive GP, its fit's K1 ladder at (1, 256), the
        message-passing optimizer over each edge's 16 × 16 grid), and once
        more with ``relearn_every=1`` and the learned decomposition (the
        Gibbs structure learner: 120 moves per fit, each one K1 ladder at
        (24, 256)); the learned cliques must differ from the tree.
   Every suggestion must lie in the space, be new against the history and
   score finite; walls, fit and acquisition seconds, launches per suggest
   and K1's calls by (batch × N) per preset.  K1, K2, its VJP, K3 and K5
   must each launch on the path, and BOCS must factor at (1, 5051).  Every
   distinct shape at which the path launched any kernel (``ShapeLog``: K1a,
   K1b, K2, its VJP, K3 and K5) is then held against its plain version
   (after the path's counts are read; K5 bit for bit on tied inputs, which
   at the GA's single objective put several points in one front); the timed kernel
   rows above include the path's shapes (K2 and its VJP at D 3 and 19 and
   the descents' query shapes, K3 at L 25 on its shared-memory route, K1 at
   (1, 5051)).
8. Drives the optimizer family at its defaults (GP 100 epochs, pop 100 ×
   100 generations) through each constructor and suggest / observe
   (phase j, with the counts reset before it):
   (j1) Ackley-6D with 200 warm Sobol observations (bucket 256), 2 timed
        suggests each: ``BO`` suggest(1) (the generic route, K5 at (100, 1)
        and (200, 1)); ``NoisyOpt`` suggest(8) on the fused graph, whose
        suggestion must equal the eager path's; ``NoMR_BO`` suggest(1) with
        η between the best and second-best warm values and the best warm
        point observed after the first suggest, so that HEBO serves the
        first and the exploit-stage BO the second;
   (j2) ``GeneralBO`` with 200 warm observations, 2 × suggest(4) (EHVI
        over 4 greedy rounds) on ZDT1 at its published 30 variables and 2
        objectives (K2 at D = 30, K5 at M = 2), and on BNH (2 variables, 2
        objectives, 2 inequality constraints fed as constraint outputs,
        feasible below 0; ``num_constr=2``: four GPs, K5 at M = 4); the 4
        picks must be distinct and ``get_pf``'s front non-dominated;
   (j3) Hartmann-6 with 60 warm observations: ``SubDomainBO`` in the
        ``tr`` and ``ascent`` modes, 2 × suggest(1) each (the L-BFGS and the
        ascent direction's gradient through K2's VJP at a query shape,
        which must launch); ``SafeOpt`` with the threshold at the warm y's
        median, 2 × suggest(4), every point at most the threshold or the
        re-suggested safe incumbent;
   (j4) ``MACEBO`` on Bayesmark SVM × breast at the challenge's batch 8:
        the Sobol round and 3 model rounds, the losses finite, the points
        inside the api_config's ranges, the model rounds' best no worse
        than the Sobol round's (without sklearn on the machine, a smooth
        stand-in loss over the same api_config, ``SVMStandIn``, and the
        line says so); ``CMAES`` and ``Evolution`` (pop 100) on
        Ackley-6D for 3 generations each (survival K5 at (200, 1)).
   Every suggestion must be finite and in the space (new against the
   history where the optimizer promises it); walls, fit / acquisition
   seconds and launches per suggest per kernel are printed.  K1, K2, its
   VJP and K5 must launch on the path, and every shape it launched is held
   against its plain version, as in phase i (among them K2 at D 30 and 2,
   and K5 at (100, 4) and (200, 4)).
9. Drives the GP variants (phase k, with the counts reset before it):
   ``HEBO(space, model_name=m, device="cuda")`` on Ackley-6D at its
   defaults, 2 × suggest(8) on the generic route: ``dkl`` (K2 and its VJP
   over 8 learned features) and ``uncertain_gp`` (the expected RBF, K1) at
   800 warm Sobol observations (bucket 1024), ``svgp`` (32 inducing
   points: K2 and its VJP at (1, 32, 3072, 6), K1's differentiable ladder
   at (1, 32)) at 3000 (bucket 3072); then ``CompositionalAcqOptimizer``
   once per method (cadam, scgd, ascgd, nasa, adam) on a GP fitted at 200
   observations, each descent through K2's VJP in the query points.  Every
   suggestion must be finite, in the space and new; every shape launched
   is held against its plain version, as in phase i.
10. Drives the other surrogate families (phase l, with the counts reset
   before it): ``HEBO(space, model_name=m, device="cuda")`` on Ackley-6D at
   its defaults, 800 warm Sobol observations, 2 × suggest(8) on the generic
   route, for ``deep_ensemble``, ``mcbn``, ``conditional_deep_ensemble``,
   ``gbdt`` (``catboost`` builds the same class) and ``nap`` (its first
   suggest meta-trains 300 steps, each sampling 16 GP tasks of 32 points
   through K1 at (16, 32)); ``gumbel`` fitted on the same points
   (``sample_f`` raises the JAX package's own ``AttributeError``) and
   ``eac`` with each of its cells on pest control (25 × 5) at 200 points.
   ``rf`` is skipped: the card's machine has no sklearn.  Predictions on
   the training points must be finite with σ² > 0; K5 must launch in every
   suggest; every shape launched is held against its plain version.
11. Drives the mesh paths (phase m, with the counts reset before it) on
   one NCCL rank per card (at most 4): on one card a one-rank group over a
   ``HashStore`` in this process, on more spawned ranks over a
   ``FileStore``; the world size is printed:
   (m1) ``HEBO(mesh=...)`` at its defaults on Ackley-6D, 800 warm Sobol
        observations (bucket 1024), 3 × suggest(8) on the eager mesh route
        (2 restarts a rank, islands of pop / world with migration every 10
        generations): each suggest exactly 107 fused K1 calls, 50 VJP, 200 K5 and
        164 K2 launches; finite, in the box, new; the best beats the init;
   (m2) ``GP(mesh=...)`` at 3000 observations (bucket 3072): the fit's
        block-sharded factor (block 128, exactly 24 K1a launches) and its W
        against K1's dense ladder at (1, 3072) (relative Frobenius ≤ 1e-3),
        and the prediction at 128 points against the dense cache's (μ 1e-3
        relative, σ² 1e-3 of |σ²| + the prior variance), both timed;
   (m3) ``GP(mesh=..., inference="hmc" | "smc")`` at 800 observations, and
        the sharded samplers against the unsharded ones on the same draws
        (1e-5; HMC's against an unsharded run of each rank's block of chains,
        which at one rank is every chain), with HMC's R̂; HMC's chains also
        against one unsharded run over all of them, and, with no mesh, the
        first quarter of the chains run alone against the same chains in
        that run (the witness of how far the batch alone moves a chain);
        world-size dependence with no such batch effect fails the run;
   (m4) ``ppo_train(mesh=...)`` at its defaults (batch 16, 24 candidates,
        horizon 8, d_model 64, 4 heads, 2 layers) for 3 iterations: losses
        finite, parameters moved, K1 at (16, 24); the first iteration is
        timed apart from the next two.
   The path runs first and the phase reads its launches at its end; the
   comparisons run after it.  Every shape the phase launched is held
   against its plain version, as in phase i; the new K1 shapes are rows of
   the kernel timings.
12. Drives latent-space BO (phase n, with the counts reset before it), each
   loop at the JAX package's defaults:
   (n1) ``LatentSpaceBO`` on pest control (25 stations × 5 choices, the
        categorical VAE; latent 4, hidden 64, 200 VAE steps, retrain every
        8): 16 Sobol points, then 4 × suggest(4) (two retrains);
   (n2) ``ImageLatentBO`` at 40 × 40 (latent 8, 150 VAE steps) on
        tests/test_decoders.py's band target scaled to 40 × 40: 16 init
        suggest(1), then 4 × suggest(2) (one retrain);
   (n3) ``ChemLatentBO`` (128 initial molecules of 24 tokens, latent 8,
        300 VAE steps at construction), 3 × step(4).
   Suggestions must be valid (codes in range and new, images in [0, 1],
   molecules valence-valid and new) and the best no worse than the init
   phase's; each suggest's wall is printed with its VAE-retrain, GP-fit,
   acquisition and decode seconds and its launches per kernel.  Then each
   VAE family trains 3 steps on the card and on the CPU from the same
   weights with the same fed normals: every parameter within 1e-4 of its
   tensor's largest |value|.  K2 (D 4 and 8) and K5 at the evolution's
   (48, 1) / (96, 1), (32, 1) / (64, 1) and (64, 1) / (128, 1) must launch;
   every shape launched is held against its plain version.
13. Drives the task suite (phase o, with the counts reset before it):
   builds ``native/`` (the AIG tool and the evaluation pool) with make;
   ``run_hpob_eval`` on a ``SyntheticHPOBTask`` (3 dims, 512 rows) with the
   port's HEBO (5 random, then 3 model rounds); ``BO_ALGOS["BOiLS"]`` on
   the real ``BoilsTask`` (8 positions × 3 operators, K3's register route at
   L 8) with 20 random warm observations, 2 × suggest(1); ``DrillsBaseline``
   for 2 episodes; and one evaluation each of ``EDASeqOptTask``,
   ``RNAInverseFoldTask``, ``LPSolveTask``, ``NASBenchTask``,
   ``RobotPushTask`` and a ``CorruptedTask``, each finite of shape (1, 1).
   Every shape launched is held against its plain version.
14. Drives the config tree and the experiment runner (phase p, with the
   counts reset before it): ``BOExperiments(from_string("hebo"), Ackley-6D)``
   at HEBO's defaults and ``BOExperiments(from_string("gp_to__is__ei__basic"),
   pest control 25 × 5)`` (its trust region), batch 8 with a checkpoint
   after every round, to 48 evaluations; a second ``BOExperiments`` in the
   same directory resumes to 64 and its first batch must equal the
   uninterrupted optimizer's suggestion at 48 (on the card the resumed HEBO
   captures a fresh graph where the uninterrupted one replays its own);
   every name of ``config._SIMPLE_OPTIMIZERS`` builds through
   ``OptimizerConfig.build`` and suggests once.  Seconds per suggest, per
   save and per load and the CSV's rows are printed; K2, its VJP, K1a, K1b
   and K5 must launch, and every shape launched is held against its plain
   version.
15. Drives the RL subprojects (phase q): SAC at its defaults on ``Pendulum``
   with tests/test_rl.py's loop (6 × (150 environment steps, 60 updates of
   batch 128)), ``GuidedSAC`` for 60 updates, ``SauteWrapper(PointGoal())``
   for a 100-step episode with ``SimmerController``, ``DynamicsEnsemble`` at
   its defaults on SAC's transitions and ``pessimistic_rollout`` (horizon 5,
   256 starts) at β 2 and 0.  Every value must be finite, λ decayed, the
   Sauté budget below 1 and the β-2 return at most the β-0 return + 0.1;
   one SAC update and one guided update equal the CPU's from the same state
   and normals (float32: parameters, targets and log α within 1e-5 of each
   tensor's largest |value|, Adam's moments 1e-4).
16. Drives SparsePO (phase r): ``TinyLM`` at its defaults (vocab 32) on 256
   preference pairs of 64 tokens, ``train_sparse_po`` at its defaults for
   each mask mode: the loss must fall, the accuracy exceed 0.8 (``learned``)
   or 0.6, the mask means stay in (0, 1); the trained forward pass within
   the CPU's largest |value| × 1e-5 (logits, the learned masks) or × 2e-4
   (the MaPO statistic, a z-norm of the hidden norms), and three
   steps with fed indices: the float32 losses within 1e-5 and, in float64,
   every parameter within 1e-8 of max(its tensor's largest |value|, lr).
   Phases q and r launch none of the port's kernels.
17. Drives EM-LLM's episodic memory (phase s) at Llama-3-8B's attention
   widths (8 key-value heads of 128) with EM-LLM's settings for it (local
   window 4096, events of up to 128 tokens, 4 representatives, γ 1):
   (s1) ``masked_attention`` at (Tq, Tk) = (512, 4096 + 4·3·128) within
        1e-5 of the CPU's largest |output|, and a fully masked key set
        within 1e-5 of the mean of V (masked logits are −1e9, not −inf);
   (s2) a 256-event memory on the card and on the CPU from the same seeded
        data: ``retrieve`` in both modes gives the same ids for 16 queries
        and ``gather_kv`` the same bits;
   (s3) ``segment_events`` on 8 seeded (512, 1024) chunks: the same spans,
        but where the CPU's top-two scores of a boundary lie within 1e-6
        relative (a tie; their count is printed);
   (s4) one ``EMLLMAttention`` takes 128K tokens in 512-token chunks with a
        needle chunk at one third and must recall it (the mean output above
        3, tests/test_emllm.py's criterion); ingest ms per chunk (median,
        p90), attend ms, ``retrieve`` ms in each mode, the memory's device
        bytes and the busy share of one profiled ingest + attend;
   (s5) ``retrieve_sharded`` at (E, F) = (4096, 1024) over NCCL at world
        min(cards, 4) against the host's argsort.
   Phase s launches none of the port's kernels (no ``pallas_call`` stands
   behind the JAX package's EM-LLM).
18. Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
   last, ``{"ok": true, "device": {...}}``.  Any failed check exits 1
   without the last line; no CUDA device exits 2.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pandas as pd

ROOT = Path(__file__).resolve().parent
FP32_PEAK = 67e12  # H100 SXM, FLOP/s outside the tensor cores (data sheet, 700 W)
HBM_BW = 3.35e12  # H100 SXM, bytes/s
GRAM_TOL, VJP_TOL, L_TOL, W_TOL = 1e-5, 1e-4, 1e-4, 1e-3
SSK_RAW_TOL, SSK_TAN_TOL, SSK_K_TOL = 1e-5, 1e-4, 1e-5
# phases q and r, card against CPU in float32, relative to each tensor's
# largest |value|: SAC's parameters, targets and log α, its Adam moments;
# TinyLM's logits and learned masks, and the MaPO statistic, whose z-norm
# divides the hidden norms' float32 rounding by their spread across tokens
# (~1 % of the norm at the trained weights: 3.3e-5 and 4.7e-5 measured on
# the card, then 2.5e-5 to 6.0e-5 over eight readings); after three float32
# DPO steps, the share of TinyLM's parameter elements (leaves whose float64
# gradient is at most PO_ZERO_GRAD of the largest left out) further apart
# than PO_STEP_TOL of max(|p|, 1e-3) (the worst element 4.8e-5 on the
# card: Adam amplifies the rounding of a gradient that cancels)
SAC_TOL, SAC_MOMENT_TOL, PO_FWD_TOL, PO_ACT_TOL = 1e-5, 1e-4, 1e-5, 2e-4
PO_STEP_TOL, PO_STEP_SHARE, PO_ZERO_GRAD = 1e-5, 1e-3, 1e-10
# phase i's shapes, timed with the others: K2 and its VJP at the fits
# (bucket 256; D 3 for the transformed-overlap GP on Ackley-53, 19 for the
# HED GP) and the descents' query sets (8 interleaved starts, 16 bandit
# candidates), K3 at pest control's L = 25 (fit, one-flip neighbours, GA
# population; cross (N, M) with self sets of N)
MCBO_GRAM_SHAPES = [(1, 256, 256, 3), (1, 256, 256, 19), (1, 256, 8, 3), (1, 256, 8, 19),
                    (1, 256, 16, 3)]
# phase j's shapes, timed with the others: K2 and its VJP at GeneralBO's
# fits (bucket 256; ZDT1's D = 30, BNH's D = 2) and NSGA-II's predict, and
# SubDomainBO's query sets at bucket 64 (8 L-BFGS starts, their 5 trial
# steps, the ascent direction's one point)
FAMILY_GRAM_SHAPES = [(1, 256, 256, 30), (1, 256, 256, 2), (1, 256, 100, 30), (1, 256, 100, 2),
                      (1, 64, 8, 6), (1, 64, 40, 6)]
FAMILY_VJP_SHAPES = [(1, 256, 256, 30), (1, 256, 256, 2), (1, 64, 8, 6), (1, 64, 1, 6)]
# phase k's shapes, timed with the others: SVGP's inducing Grams at 3000
# observations (32 inducing points; Kmm, Kmn at bucket 3072, NSGA-II's
# predict) and the DKL GP's over its 8 learned features at bucket 1024 (fit
# and NSGA-II's predict)
VARIANT_GRAM_SHAPES = [(1, 32, 32, 6), (1, 32, 3072, 6), (1, 32, 100, 6), (1, 1024, 1024, 8),
                       (1, 1024, 100, 8)]
VARIANT_VJP_SHAPES = [(1, 32, 3072, 6), (1, 32, 32, 6), (1, 1024, 1024, 8)]
# phase m's new K1 shapes: the block factor at block 128 and 64 (K1a), W of
# the gathered factor at bucket 3072 (K1b); PPO's tasks at (16, 24)
MESH_K1 = {"chol_factor": {(1, 128), (1, 64), (16, 24)}, "chol_winv": {(1, 3072)}}
# phases n and o: the latent GPs (D 4 pest control, D 8 images and molecules)
# at their fit buckets and the evolution's populations, and HEBO's inside
# run_hpob_eval (D 3, bucket 8)
LATENT_GRAM_SHAPES = [(1, 32, 32, 4), (1, 32, 48, 4), (1, 32, 32, 8), (1, 16, 32, 8),
                      (1, 256, 256, 8), (1, 256, 64, 8), (1, 8, 8, 3), (1, 8, 48, 3)]
LATENT_VJP_SHAPES = [(1, 32, 32, 4), (1, 32, 32, 8), (1, 256, 256, 8), (1, 8, 8, 3)]
# phase p: HEBO's fused suggest at the campaign's smallest and largest
# buckets (8 and 64: fit, NSGA-II's predict); K1 at their fits (2, 8), (2, 64)
EXPERIMENT_GRAM_SHAPES = [(2, 8, 8, 6), (2, 64, 64, 6), (1, 64, 100, 6)]
EXPERIMENT_VJP_SHAPES = [(2, 8, 8, 6), (2, 64, 64, 6)]
# K5's grid route (P past the one-CTA route): survival at MACE's pop 625
# and 700, ZDT1's 630 and 650, BNH's 625, at pop 2,048 (M = 3), BO's M = 1
# at pop 2,100; a chain of 4,200 fronts (M = 2) and one with a crowded last
# front whose rounded keys tie past 2^24
GRID_CASES = [(1249, 3, False), (1260, 2, False), (1250, 4, False), (1400, 3, False),
              (1300, 2, False), (4096, 3, False), (4200, 1, False), (4200, 2, True),
              (4200, 2, "tail")]
# K2's VJP: the fits at buckets 1024, 128 and the large-N route's 2048, the
# samplers' (4 and 32 at bucket 1024, 4 at 128), then phases i-p's
VJP_SHAPES = [(2, 1024, 1024, 6), (2, 128, 128, 6), (2, 2048, 2048, 6), (4, 1024, 1024, 6),
              (32, 1024, 1024, 6), (4, 128, 128, 6)] + MCBO_GRAM_SHAPES + FAMILY_VJP_SHAPES \
    + VARIANT_VJP_SHAPES + LATENT_VJP_SHAPES + EXPERIMENT_VJP_SHAPES
# phase o: BOiLS on BoilsTask, 8 positions over 3 operators (the register route)
TASK_SSK_CASES = [(1, 32, 32, 8, 3, [(0.6, 0.7)]), (1, 32, 17, 8, 3, [(0.6, 0.7)])]
MCBO_SSK_CASES = [(1, 256, 256, 25, 3, [(0.6, 0.7)]), (1, 256, 101, 25, 3, [(0.6, 0.7)]),
                  (1, 256, 64, 25, 3, [(0.6, 0.7)]), (1, 101, 101, 25, 3, [(0.6, 0.7)]),
                  (1, 64, 64, 25, 3, [(0.6, 0.7)]), (1, 256, 8, 25, 3, [(0.6, 0.7)]),
                  (1, 8, 256, 25, 3, [(0.6, 0.7)])]
# K3's route edges beyond L 11: regs32's column bound (32), one column
# beyond (33: the general route), P = 5 past L 8 (general), and P = 1 on
# regs32 and the warp route (its decay gradient is identically 0)
EDGE_SSK_CASES = [(1, 256, 256, 32, 3, [(0.6, 0.7)]),
                  (1, 256, 256, 33, 3, [(0.6, 0.7)]), (1, 64, 64, 9, 5, [(0.6, 0.7)]),
                  (1, 256, 256, 20, 1, [(0.6, 0.7)])]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def whole_launches(torch, fn, reps, key="chol_", tries=3):
    """{device kernel name holding ``key``: launches per call of ``fn``}.
    The profiler drops events now and then, at times most of a kernel's
    (0.12 launches a call seen for a one-launch kernel), and never adds
    one: so each kernel's count is the most that ``tries`` profiles saw,
    rounded to a whole number."""
    from hebo_tpu_torch.bench.gram_probe import device_by_name

    most = {}
    for _ in range(tries):
        for k, (_, n) in device_by_name(torch, fn, reps).items():
            if key in k:
                most[k] = max(most.get(k, 0.0), n)
    return {k: round(n) for k, n in most.items()}


def bound(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def k1_expect(rungs, n):
    """Each K1 wrapper's launches for ``rungs`` ladder rungs at matrices of
    size n: one fused ``chol_factor_inv`` call a rung where K1a takes its
    flow route (from 8 tiles), else ``chol_factor`` then ``chol_winv``
    (None: no launch)."""
    from hebo_tpu_torch.ops import chol_kernel as ck

    fused = ck.route(n) == "flow"
    return {"chol_factor": None if fused else rungs, "chol_winv": None if fused else rungs,
            "chol_factor_inv": rungs if fused else None}


def launched(counts, k):
    """Launches of kernel k in ``counts`` (a {wrapper: launches} dict), where
    K1a's and K1b's also count the fused K1 call, which runs both."""
    n = counts.get(k) or 0
    if k in ("chol_factor", "chol_winv"):
        n += counts.get("chol_factor_inv") or 0
    return n


def check_gram(torch, gram, device_per_call, dev, gen, fails):
    """K2 at HEBO's shapes: the fit (2, bucket, bucket, 6), the cache
    (1, bucket, bucket, 6) and NSGA-II's predict (1, bucket, 100, 6) at
    buckets 1024 and 128; the large-N route's; the samplers' (4 HMC chains,
    SVI draws or gpy_wgp restarts at buckets 128 and 1024, 32 SMC
    particles); the Thompson draws' cross Gram (1, 1024, 512, 6) and joint
    Gram (1, 512, 512, 6); phase i's (``MCBO_GRAM_SHAPES``), phase j's
    (``FAMILY_GRAM_SHAPES``), phase k's (``VARIANT_GRAM_SHAPES``) and
    phases n and o's (``LATENT_GRAM_SHAPES``) and phase p's
    (``EXPERIMENT_GRAM_SHAPES``)."""
    rows = []
    for B, N, M, D in [(2, 1024, 1024, 6), (1, 1024, 1024, 6), (1, 1024, 100, 6),
                       (2, 128, 128, 6), (1, 128, 128, 6), (1, 128, 100, 6),
                       (2, 2048, 2048, 6), (1, 3072, 3072, 6), (1, 3072, 100, 6),
                       (1, 3072, 128, 6), (1, 7168, 7168, 6),
                       (4, 1024, 1024, 6), (32, 1024, 1024, 6), (1, 512, 512, 6),
                       (4, 128, 128, 6), (1, 1024, 512, 6)] + MCBO_GRAM_SHAPES + FAMILY_GRAM_SHAPES \
            + VARIANT_GRAM_SHAPES + LATENT_GRAM_SHAPES + EXPERIMENT_GRAM_SHAPES:
        a = torch.randn((B, N, D), generator=gen, device=dev)
        b = torch.randn((B, M, D), generator=gen, device=dev)
        sc = torch.rand((B,), generator=gen, device=dev) + 0.5
        err = (gram.matern32_gram(a, b, sc, 1e-3) - gram.matern32_gram_plain(a, b, sc, 1e-3)).abs().max().item()
        if not err <= GRAM_TOL:
            fails.append(f"matern32_gram {(B, N, M, D)}: max abs err {err}")
        reps = 200 if N * M > 1e5 else 1000
        bms, by = bound(B * N * M * (2 * D + 8), 4 * (B * N * D + B * M * D + B + B * N * M))
        fwd = lambda: gram.matern32_gram(a, b, sc)
        # a second profile where the profiler dropped every event of the first
        us = device_per_call(torch, fwd, 100, "matern32_gram")[0] or \
            device_per_call(torch, fwd, 100, "matern32_gram")[0]
        rows.append(dict(
            shape=[B, N, M, D], tile_rows=gram.tile_rows(B, N, M), max_abs_err=err,
            ms=cuda_ms(torch, fwd, reps), device_us=us,
            plain_ms=cuda_ms(torch, lambda: gram.matern32_gram_plain(a, b, sc), reps),
            bound_ms=bms, bound_by=by,
            # no single PyTorch call computes the Matérn Gram; torch.cdist
            # (distances only) is printed beside it as the nearest library call
            library_ms=None,
            cdist_ms=cuda_ms(torch, lambda: torch.cdist(a, b), reps),
        ))
    return rows


def check_gram_vjp(torch, gram, device_per_call, dev, gen, fails):
    """K2's VJP at the fits' shapes (2, bucket, bucket, 6), buckets 1024 and
    128 and the large-N route's subsample bucket 2048, the samplers' (4 and
    32 at bucket 1024, 4 at 128) and phase i's (the fits at bucket 256,
    D 3 and 19, and the descents' query shapes), phase j's
    (``FAMILY_VJP_SHAPES``), phase k's (``VARIANT_VJP_SHAPES``), phases n
    and o's (``LATENT_VJP_SHAPES``) and phase p's
    (``EXPERIMENT_VJP_SHAPES``), on random points and on a
    self-Gram with coincident rows (repeated rows and the zero rows of a
    padded bucket); twice on the same inputs, which must give the same
    bits.  The self-Gram's points are scaled by √(6/D) above D = 6, so
    that its pair distances spread as at D = 6, as the GP's 1/ℓ-scaled
    inputs do: with unit-variance features at D = 30 every distinct pair's
    kernel is ~e^{-13}, the gradient is the coincident pairs' cancellation,
    and the plain float32 version itself is 2.6e-4 / 4.0e-4 of max |ga| /
    |gb| off its float64 value there."""
    rows = []
    for B, N, M, D in VJP_SHAPES:
        a = torch.randn((B, N, D), generator=gen, device=dev)
        b = torch.randn((B, M, D), generator=gen, device=dev)
        sc = torch.rand((B,), generator=gen, device=dev) + 0.5
        g = torch.randn((B, N, M), generator=gen, device=dev)
        x = a * min(1.0, math.sqrt(6.0 / D))
        k = min(8, N // 4)  # 8 repeated and 16 zero rows; fewer at N < 32 (phase o's bucket 8)
        x[:, N // 2: N // 2 + k] = x[:, :k]
        x[:, -2 * k:] = 0.0
        pairs = [("random points", (a, b))] + ([("self-Gram, coincident rows", (x, x))] if N == M else [])
        for what, (p, q) in pairs:
            got, want = gram.matern32_gram_vjp(p, q, sc, g), gram.matern32_gram_vjp_plain(p, q, sc, g)
            errs = [((u - v).abs().max() / v.abs().max()).item() for u, v in zip(got, want)]
            same_bits = all(torch.equal(u, v) for u, v in zip(got, gram.matern32_gram_vjp(p, q, sc, g)))
            print(f"matern32_gram_vjp {(B, N, M, D)} {what}: errors over max |ga|, |gb|, |gsc| "
                  f"{errs}, same bits twice {same_bits}", flush=True)
            if not (max(errs) <= VJP_TOL and same_bits):
                fails.append(f"matern32_gram_vjp {(B, N, M, D)} {what}: errors {errs}, "
                             f"same bits twice {same_bits}")
        got, want = gram.matern32_gram_vjp(a, b, sc, g), gram.matern32_gram_vjp_plain(a, b, sc, g)
        vjp = lambda: gram.matern32_gram_vjp(a, b, sc, g)
        reps = 200 if N * M > 1e5 else 1000
        # bytes: a, b, sc, g read, ga, gb, gsc written; operations per pair:
        # d2 (2D), s, e^{-s}, G and gsc's term (~14), the row and column sums (4D)
        bms, by = bound(B * N * M * (6 * D + 14), 4 * (2 * B * N * D + 2 * B * M * D + 2 * B + B * N * M))
        us, launches = device_per_call(torch, vjp, 100, "matern32_vjp")
        rows.append(dict(
            shape=[B, N, M, D], tile_rows=gram.tile_rows(B, N, M),
            max_abs_err=max((u - v).abs().max().item() for u, v in zip(got, want)),
            ms=cuda_ms(torch, vjp, reps), device_us=us, device_launches_per_call=launches,
            plain_ms=cuda_ms(torch, lambda: gram.matern32_gram_vjp_plain(a, b, sc, g), reps),
            bound_ms=bms, bound_by=by, library_ms=None,
        ))
    return rows


def spd(torch, B, N, dev, gen):
    """B random SPD matrices N × N, eigenvalues ≥ 0.5."""
    A = torch.randn((B, N, N), generator=gen, device=dev)
    return (A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)).contiguous()


def check_chol(torch, ck, dev, gen, fails):
    """K1a and K1b at the main paths' shapes: AntBO's fit and cache (1, 32)
    and (1, 256), HEBO's cache (1, 128) and (1, 1024), HEBO's fit (2, 128)
    and (2, 1024), and (2, 2048); BOCS's Gibbs sweep (1, 5051); RDUCB's
    structure learner (24, 256); NAP's meta-training tasks (16, 32); phase
    m's block factor at block 64 (1, 64), W of the gathered factor
    (1, 3072) and PPO's tasks (16, 24); phases n and o's small fits (1, 16)
    and (1, 8); phase p's HEBO fits at buckets 8 and 64, (2, 8) and (2, 64);
    phase b2's caches and fits at buckets 512, 768, 1536 and 2048 on K1a's
    flow route, (1, 512), (2, 512), (1, 768), (2, 768), (1, 1536),
    (2, 1536), (1, 2048) and (2, 2048); phase e4's fit at bucket 3072,
    (2, 3072); (1, 4096), on no path, beside its library call.  Each row
    names the route its kernel takes (K1a's flow route from 8 tiles, K1b's
    from 2) and holds the same bits from a second call.
    Host dispatch is part of the time at the small shapes, for the kernels
    and the library call alike, so those get more calls per timing."""
    fac, winv, fused = [], [], []
    for B, N in [(1, 32), (1, 128), (2, 128), (1, 256), (1, 1024), (2, 1024), (1, 5051), (2, 2048),
                 (4, 1024), (32, 1024), (1, 512), (4, 128), (24, 256), (16, 32), (1, 64),
                 (1, 3072), (1, 16), (1, 8), (2, 8), (2, 64), (2, 512), (1, 768), (2, 768), (1, 1536),
                 (2, 1536), (1, 2048), (2, 3072), (1, 4096),
                 (16, 24)]:  # a batch last: the NaN case below
        K = spd(torch, B, N, dev, gen)
        L, Wd = ck.chol_factor(K)
        L2, Wd2 = ck.chol_factor(K)
        same = bool(torch.equal(L, L2) and torch.equal(Wd, Wd2))
        L0, Wd0 = ck.chol_factor_plain(K)
        err_f = max((L - L0).abs().max().item(), (Wd - Wd0).abs().max().item())
        W = ck.chol_winv(L, Wd)
        same_w = bool(torch.equal(W, ck.chol_winv(L, Wd)))
        err_w = (W - ck.chol_winv_plain(L, Wd)).abs().max().item()
        if not (err_f <= L_TOL and same):
            fails.append(f"chol_factor {(B, N)}: max abs err {err_f}, same bits twice {same}")
        if not (err_w <= W_TOL and same_w):
            fails.append(f"chol_winv {(B, N)}: max abs err {err_w}, same bits twice {same_w}")
        reps = 200 if N <= 256 else 20 if N <= 1024 else 5
        Np = L.shape[-1]
        eye = torch.eye(Np, device=dev).expand_as(L)
        bf, byf = bound(B * N ** 3 / 3, 4 * (B * N * N + B * Np * Np + Wd.numel()))
        bw, byw = bound(B * N ** 3 / 3, 4 * (2 * B * Np * Np + Wd.numel()))
        for rows, fn, plain, lib, err, bms, by in (
            (fac, lambda: ck.chol_factor(K), lambda: ck.chol_factor_plain(K),
             lambda: torch.linalg.cholesky_ex(K), err_f, bf, byf),
            (winv, lambda: ck.chol_winv(L, Wd), lambda: ck.chol_winv_plain(L, Wd),
             lambda: torch.linalg.solve_triangular(L, eye, upper=False), err_w, bw, byw),
        ):
            ms = cuda_ms(torch, fn, reps)
            library_ms = cuda_ms(torch, lib, reps)
            rows.append(dict(shape=[B, N], max_abs_err=err, ms=ms, plain_ms=cuda_ms(torch, plain, reps),
                             bound_ms=bms, bound_by=by, library_ms=library_ms,
                             library_over_ms=library_ms / ms,
                             **({"route": ck.route(N), "same_bits": same} if rows is fac else
                                {"route": ck.winv_route(N), "same_bits": same_w})))
        if ck.route(N) == "flow":
            fused.append(check_fused(torch, ck, K, L, Wd, W, reps, fails))
    # the fused call: a late-tile failure at N 1100 beside a −I member
    A = torch.randn((3, 1100, 1100), generator=gen, device=dev)
    Kf = (A @ A.transpose(1, 2) / 1100 + 0.5 * torch.eye(1100, device=dev)).contiguous()
    Kf[0] = -torch.eye(1100, device=dev)
    Kf[1, :1044, 1044:] = 0.0
    Kf[1, 1044:, :1044] = 0.0
    Kf[1, 1044:, 1044:] = -torch.eye(56, device=dev)
    Lf, Wdf, Wf = ck.chol_factor_inv(Kf)
    alone = ck.chol_factor_inv(Kf[2:3].contiguous())
    fused_nan = (all(not torch.isfinite(x[b]).all().item() for x in (Lf, Wf) for b in (0, 1))
                 and torch.isfinite(Lf[1, :1024]).all().item() and torch.isfinite(Wf[1, :1024]).all().item()
                 and all(torch.equal(x[2], y[0]) for x, y in zip((Lf, Wdf, Wf), alone)))
    # ... and the ladder's arguments: a skipped member keeps its buffers, the
    # others the bits of K + jitter·I in a call of their own
    Kf = spd(torch, 3, 1100, dev, gen)
    out = tuple(torch.full_like(x, 7.0) for x in (Lf, Wdf, Wf))
    jit = torch.tensor([1e-3, 0.5, 0.25], device=dev)
    ck.chol_factor_inv(Kf, jit, torch.tensor([0, 1, 0], dtype=torch.int32, device=dev), out=out)
    fused_skip = all(bool((x[1] == 7).all()) for x in out) and all(
        all(torch.equal(x[b], y[0]) for x, y in zip(out, ck.chol_factor_inv(
            (Kf[b:b + 1] + jit[b] * torch.eye(1100, device=dev)).contiguous())))
        for b in (0, 2))
    print(f"chol_factor_inv NaN (3, 1100): −I member and a bad pivot in the last tile stay in their "
          f"matrices, the third member = alone: {fused_nan}; skip keeps out, jitter = alone: {fused_skip}",
          flush=True)
    if not (fused_nan and fused_skip):
        fails.append(f"chol_factor_inv (3, 1100): NaN stays {fused_nan}, skip and jitter {fused_skip}")
    # NaN propagation: one non-PSD member, its neighbours untouched
    K[0] = -torch.eye(K.shape[-1], device=dev)
    L, W = ck.chol_inv(K)
    nan_ok = (not torch.isfinite(L[0]).all().item() and not torch.isfinite(W[0]).all().item()
              and torch.isfinite(L[1]).all().item() and torch.isfinite(W[1]).all().item())
    # ... and a first bad pivot in a late tile: blockdiag(SPD 200x200, -I)
    # in the middle of a batch of 3 fails in tile 3 of 4
    A = torch.randn((3, 256, 256), generator=gen, device=dev)
    K = (A @ A.transpose(1, 2) / 256 + 0.5 * torch.eye(256, device=dev)).contiguous()
    K[1, :200, 200:] = 0.0
    K[1, 200:, :200] = 0.0
    K[1, 200:, 200:] = -torch.eye(56, device=dev)
    late_ok = {}
    for r in ck.ROUTES:
        L, Wd = ck.chol_factor(K, route=r)
        W = ck.chol_winv(L, Wd)
        late_ok[r] = (not torch.isfinite(L[1]).all().item() and not torch.isfinite(W[1]).all().item()
                      and torch.isfinite(L[1, :192]).all().item()
                      and torch.isfinite(L[[0, 2]]).all().item() and torch.isfinite(W[[0, 2]]).all().item())
    print(f"chol NaN propagation (batch (2, 2048, 2048), route {ck.route(2048)}, member 0 = -I): "
          f"{'ok' if nan_ok else 'FAILED'}; late tile (batch (3, 256, 256), member 1 fails in tile 3), "
          f"by route: {late_ok}", flush=True)
    if not nan_ok:
        fails.append("chol NaN propagation")
    if not all(late_ok.values()):
        fails.append(f"chol NaN propagation from a late tile: {late_ok}")
    for name, rows in (("chol_factor vs cholesky_ex", fac), ("chol_winv vs solve_triangular", winv),
                       ("chol_factor_inv vs cholesky_ex + solve_triangular", fused)):
        print(f"{name}, library_ms / ms:",
              ", ".join(f"{tuple(r['shape'])} {r['library_over_ms']:.2f} {r['route']}" for r in rows),
              flush=True)
    return fac, winv, fused


def check_fused(torch, ck, K, L, Wd, W, reps, fails):
    """The fused call (L, Wd and W in one launch pair) at a flow-route
    shape, given the pair's (L, Wd, W) on the same K: the pair's bits, W =
    chol_winv of its own L and Wd bit for bit, the same bits twice, a batch
    member's bits equal to its own call's, the plain versions' tolerances;
    ms, device µs and launches per call, plain ms (K1a's then K1b's plain
    version), library ms (cholesky_ex then solve_triangular), bound (K1a's
    + K1b's operations, or the bytes of K, L, Wd and W)."""
    from hebo_tpu_torch.bench.gram_probe import device_per_call

    B, N, _ = K.shape
    Lf, Wdf, Wf = ck.chol_factor_inv(K)
    twice = all(torch.equal(a, b) for a, b in zip((Lf, Wdf, Wf), ck.chol_factor_inv(K)))
    pair = all(torch.equal(a, b) for a, b in zip((Lf, Wdf, Wf), (L, Wd, W)))
    w_of_l = bool(torch.equal(Wf, ck.chol_winv(Lf, Wdf)))
    alone = ck.chol_factor_inv(K[-1:].contiguous())
    batch = all(torch.equal(a[-1], b[0]) for a, b in zip((Lf, Wdf, Wf), alone))
    L0, Wd0 = ck.chol_factor_plain(K)
    W0 = ck.chol_winv_plain(L0, Wd0)
    err = max((Lf - L0).abs().max().item(), (Wdf - Wd0).abs().max().item())
    err_w = (Wf - W0).abs().max().item()
    if not (err <= L_TOL and err_w <= W_TOL and twice and pair and w_of_l and batch):
        fails.append(f"chol_factor_inv {(B, N)}: errors L/Wd {err}, W {err_w}, same bits twice {twice}, "
                     f"= the pair {pair}, W = chol_winv(L, Wd) {w_of_l}, alone = in the batch {batch}")
    Np = L.shape[-1]
    eye = torch.eye(Np, device=K.device).expand_as(L)
    bms, by = bound(2 * B * N ** 3 / 3, 4 * (B * N * N + 2 * B * Np * Np + Wd.numel()))
    fn = lambda: ck.chol_factor_inv(K)
    us, launches = device_per_call(torch, fn, 10 if N > 2048 else 50, "chol_")
    ms = cuda_ms(torch, fn, reps)
    library_ms = cuda_ms(torch, lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky_ex(K)[0], torch.eye(N, device=K.device).expand_as(K), upper=False), reps)
    return dict(shape=[B, N], max_abs_err=max(err, err_w), max_abs_err_L=err, max_abs_err_W=err_w, ms=ms,
                device_us=us, device_launches_per_call=launches,
                plain_ms=cuda_ms(torch, lambda: ck.chol_winv_plain(*ck.chol_factor_plain(K)), reps),
                bound_ms=bms, bound_by=by, library_ms=library_ms, library_over_ms=library_ms / ms,
                route="fused", same_bits=twice, same_as_pair=pair, w_equals_winv_of_l=w_of_l,
                alone_equals_batch=batch)


def ssk_flops(s1, s2, B, P, self_mode):
    """FP32 operations the SSK recursion needs on these codes over the batch
    (FMA = 2).  K_p = λ_m²^p·V_p with V_p free of λ_m², so only the value
    and the λ_g tangent of V run the recursions; the λ_m² tangent is
    Σ_p p·λ_m²^(p−1)·S_p from the per-step sums S_p = Σ V_p.  The match
    mask is a select, so V_p is summed only where codes match and it is not
    structurally zero (a, b ≥ p − 1): 1 add per match at p = 1 (the value),
    2 at p > 1 (value and gap tangent).  Transition p (p = 1..P−1) runs the
    R and T prefix recursions over the non-zero part of V_p, (L−p)(L−p−1)
    carried steps (the first step of each scan is a copy): the value one
    FMA in each recursion, the gap tangent an add and an FMA in each, 10
    per step.  The totals take 3 FMAs per step p and pair."""
    L = s1.shape[1]
    eq = (s1[:, :, None] == s1[:, None, :]) if self_mode else (s1[:, None, :, None] == s2[None, :, None, :])
    pairs = eq.numel() // (L * L)
    ops = sum((1 if p == 1 else 2) * int(eq[..., p - 1:, p - 1:].sum().item()) for p in range(1, P + 1))
    ops += sum(10 * (L - p) * max(L - p - 1, 0) * pairs for p in range(1, P))
    ops += 6 * P * pairs
    return B * ops


def check_ssk(torch, ssk, device_us, dev, fails):
    """K3 at the AntBO paths' shapes: the fit and cache at buckets 256 and
    32 (B = 1; B = 2 for two restarts), the local search's one-flip
    neighbours against the bucket (209 × bucket), M = 1, (6, 2), one
    shape just beyond the L 11 register budget (L = 12, regs32), and
    phase i's pest control at L = 25 over 5 letters (regs32 or the warp
    route by pair count): the fit at bucket 256, the interleaved search's
    one-flip neighbours (101), the GA's population (64) and the descents'
    8 queries; the route edges (``EDGE_SSK_CASES``: L 32, and 33 and (9, 5)
    on the general route); phase o's BOiLS on ``BoilsTask`` at
    L = 8 over 3 operators (``TASK_SSK_CASES``, the register route).  A
    second launch on the same inputs must give the same bits."""
    cross_rows, self_rows = [], []
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-6)).max().item()
    cases = [(1, 256, 256, 11, 3, [(0.6, 0.7)]), (2, 256, 256, 11, 3, [(0.6, 0.7), (0.35, 0.9)]),
             (1, 209, 256, 11, 3, [(0.7, 0.6)]), (1, 209, 32, 11, 3, [(0.7, 0.6)]),
             (1, 32, 32, 11, 3, [(0.55, 0.8)]), (1, 256, 1, 11, 3, [(0.5, 0.5)]),
             (1, 13, 5, 6, 2, [(0.8, 0.3)]), (1, 256, 256, 12, 3, [(0.6, 0.7)])]
    cases = [c + (20,) for c in cases] + [c + (5,) for c in MCBO_SSK_CASES + EDGE_SSK_CASES] \
        + [c + (3,) for c in TASK_SSK_CASES]
    rng = np.random.default_rng(0)
    for B, N, M, L, P, decays, letters in cases:
        s1 = torch.as_tensor(rng.integers(0, letters, (N, L)), dtype=torch.int32, device=dev)
        s2 = torch.as_tensor(rng.integers(0, letters, (M, L)), dtype=torch.int32, device=dev)
        md = torch.tensor([d[0] for d in decays], device=dev)
        gd = torch.tensor([d[1] for d in decays], device=dev)
        lam2 = md * md
        got = ssk.ssk_cross(s1, s2, lam2, gd, P) + ssk.ssk_self(s1, lam2, gd, P)
        again = ssk.ssk_cross(s1, s2, lam2, gd, P) + ssk.ssk_self(s1, lam2, gd, P)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fails.append(f"ssk {(B, N, M, L, P)}: a second launch gave other bits")
        want = ssk.ssk_cross_plain(s1, s2, lam2, gd, P) + ssk.ssk_self_plain(s1, lam2, gd, P)
        errs = [rel(a, b) for a, b in zip(got, want)]
        abs_errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        k_err = (ssk.ssk_gram(s1, s2, md, gd, P) - ssk.ssk_gram_plain(s1, s2, md, gd, P)).abs().max().item()
        for what, e, tol in zip(("cross", "cross d/dlam2", "cross d/dgap", "self", "self d/dlam2",
                                 "self d/dgap"), errs, (SSK_RAW_TOL, SSK_TAN_TOL, SSK_TAN_TOL) * 2):
            if not e <= tol:
                fails.append(f"ssk {what} {(B, N, M, L, P)}: max rel err {e}")
        if not k_err <= SSK_K_TOL:
            fails.append(f"ssk_gram {(B, N, M, L, P)}: max abs err {k_err}")
        reps = 200 if N * M > 1e4 else 1000
        bc, byc = bound(ssk_flops(s1, s2, B, P, False), 4 * ((N + M) * L + 2 * B + 3 * B * N * M))
        bs, bys = bound(ssk_flops(s1, s1, B, P, True), 4 * (N * L + 2 * B + 3 * B * N))
        cross = lambda: ssk.ssk_cross(s1, s2, lam2, gd, P)
        self_ = lambda: ssk.ssk_self(s1, lam2, gd, P)
        # no single PyTorch call computes the SSK DP: library_ms is null
        cross_rows.append(dict(
            shape=[B, N, M, L, P], route=ssk.route(L, P, B * N * M), max_abs_err=max(abs_errs[:3]),
            max_rel_err=max(errs[:3]), gram_max_abs_err=k_err, ms=cuda_ms(torch, cross, reps),
            device_us=device_us(torch, cross, 100, "ssk_cross")[0],
            plain_ms=cuda_ms(torch, lambda: ssk.ssk_cross_plain(s1, s2, lam2, gd, P), 20),
            bound_ms=bc, bound_by=byc, library_ms=None,
        ))
        if [B, N, L, P] in [r["shape"] for r in self_rows]:
            continue  # (1, 256, 1) and (1, 209, 32) repeat an earlier self set
        self_rows.append(dict(
            shape=[B, N, L, P], route=ssk.route(L, P, B * N), max_abs_err=max(abs_errs[3:]),
            max_rel_err=max(errs[3:]), ms=cuda_ms(torch, self_, reps),
            device_us=device_us(torch, self_, 100, "ssk_self")[0],
            plain_ms=cuda_ms(torch, lambda: ssk.ssk_self_plain(s1, lam2, gd, P), 20),
            bound_ms=bs, bound_by=bys, library_ms=None,
        ))
    return cross_rows, self_rows


def pareto_inputs(torch, P, M, edge, dev, seed, chain=False):
    """F (P, M) on a coarse grid (ties in every objective), with duplicate
    rows and, with ``edge``, ±inf and NaN entries; with ``chain``, row i is
    (r_i, ..., r_i) for a permutation r, so every point is its own front;
    with ``chain == "tail"`` (M = 2) the chain's last 100 points form one
    front on a line, crowded unevenly, whose keys (past 2^24 at P 4,200)
    tie after float32 rounding and sort by index, not by ordinal."""
    rng = np.random.default_rng(seed)
    if chain == "tail":
        n = P - 100
        t = rng.uniform(0, 100, 100)
        F = np.concatenate([np.repeat(rng.permutation(n)[:, None], 2, 1),
                            np.stack([n + t, n + 100 - t], 1)])[rng.permutation(P)]
        F = F.astype(np.float32)
    elif chain:
        F = np.repeat(rng.permutation(P).astype(np.float32)[:, None], M, 1)
    else:
        F = (rng.integers(0, 4 if edge else 1000, (P, M)) / 4).astype(np.float32)
        F[3] = F[4]
        F[10] = F[11] = F[12]
    if edge:
        F[20, 1 % M] = F[21, 1 % M] = np.inf
        F[22, 0] = -np.inf
        F[23] = -np.inf
        F[30, 2 % M] = np.nan
        F[31] = np.nan
        F[40] = [np.inf, -np.inf, 0.5][:M] if M <= 3 else np.inf
    return torch.as_tensor(F, device=dev)


def pareto_agrees(torch, pareto, P, M, dev, fails, what, chain=False, edges=(False, True)):
    """K5 at (P, M) against its plain version bit for bit, on tied (or
    chained) inputs with and without the edge values, with and without a
    valid mask: rank and crowding (``nsga2_rank_crowd``), and rank,
    crowding, key and the order of the first P // 2 (``nsga2_select``);
    past 256 rows also the order of all P."""
    for edge in edges if P > 40 else (False,):
        F = pareto_inputs(torch, P, M, edge, dev, P + edge, chain)
        for valid in (None, torch.as_tensor(np.random.default_rng(P).uniform(size=P) > 0.25,
                                            device=dev)):
            r, c = pareto.nsga2_rank_crowd(F, valid)
            r0, c0 = pareto.nsga2_rank_crowd_plain(F, valid)
            got, want = pareto.nsga2_select(F, P // 2, valid), pareto.nsga2_select_plain(F, P // 2, valid)
            same = {"ranks": torch.equal(r, r0) and torch.equal(got[0], want[0]),
                    "crowding bits": same_bits(torch, c, c0) and same_bits(torch, got[1], want[1]),
                    "keys": torch.equal(got[2], want[2]), "order": torch.equal(got[3], want[3])}
            if P > 256:
                same["full order"] = torch.equal(pareto.nsga2_select(F, P, valid)[3],
                                                 torch.argsort(want[2], stable=True))
            if not all(same.values()):
                fails.append(f"nsga2_rank_crowd {(P, M)}{what} chain={chain} edge={edge} "
                             f"masked={valid is not None}: equal {same}")


def same_bits(torch, a, b):
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)
                and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def check_pareto(torch, pareto, device_us, dev, fails):
    """K5 at NSGA-II's shapes, the tournament's (100, 3) and survival's
    (200, 3), at the single objective of the MCBO GA, (64, 1) and (128, 1),
    and of BO's and Evolution's NSGA-II, (100, 1) and (200, 1), and at
    GeneralBO's M = 2 (ZDT1) and M = 4 (BNH, 2 objectives + 2
    constraints), P 100 and 200, and phases n and o's evolutions, (48, 1),
    (96, 1), (32, 1), (48, 3) and (96, 3), and on chains of 200 fronts at
    M = 2 and 3 (the peel's worst case): the same ranks, crowding bits,
    keys and survivor order as the plain version (``pareto_agrees``); the
    one-CTA route near its edge, (700, 3) (HEBO(pop=700)'s tournament) and
    (1200, 3); then K5's grid route at ``GRID_CASES``.  Timed as survival
    calls it,
    ``nsga2_select(F, P // 2)``, on standard-normal objectives (a chain's
    rows on the chain); the grid route's device µs per call summed over its
    launches."""
    from hebo_tpu_torch.bench.gram_probe import device_per_call

    rows = []
    cases = [(P, M, False) for P, M in ((100, 3), (200, 3), (64, 1), (128, 1), (100, 1), (200, 1),
                                        (100, 2), (200, 2), (100, 4), (200, 4), (48, 1), (96, 1),
                                        (32, 1), (48, 3), (96, 3), (700, 3), (1200, 3))]
    for P, M, chain in cases + [(200, 2, True), (200, 3, True)] + GRID_CASES:
        large = P > 256
        # the plain version peels a 4,200-front chain in ~1 s: no edge values there
        pareto_agrees(torch, pareto, P, M, dev, fails, "", chain,
                      edges=(False,) if chain and large else (False, True))
        if chain:
            F = pareto_inputs(torch, P, M, False, dev, P, chain=chain)
        else:
            F = torch.randn((P, M), generator=torch.Generator(device=dev).manual_seed(P), device=dev)
        fn = lambda: pareto.nsga2_select(F, P // 2)
        got = fn()
        want = pareto.nsga2_select_plain(F, P // 2)
        # the function's own work on this run's fronts, whatever the route:
        # the domination compares (<= both ways, each pair once, every
        # objective), the crowding's placement within each front per
        # objective and the order's, and the ordinal's compares over every
        # pair; bytes: F in, rank, crowding, key and order out
        sizes = torch.bincount(got[0].long()).double()
        fronts = int(got[0].max().item()) + 1
        ops = P * P * M + int((sizes ** 2).sum().item()) * (M + 1) + P * P
        bms, by = bound(ops, 4 * (P * M + 3 * P) + 8 * (P // 2))
        route = pareto.route(P, M)
        if route == "grid":
            us, launches = device_per_call(torch, fn, 20, "nsga2_")
        else:
            us, launches = device_us(torch, fn, 200, "nsga2_rank_crowd")[0], 1
        rows.append(dict(
            shape=[P, M], chain=chain, fronts=fronts, route=route,
            max_abs_err=float((got[1] - want[1]).abs().nan_to_num(0.0).max().item()),
            ms=cuda_ms(torch, fn, 20 if large else 1000), device_us=us,
            device_launches_per_call=launches,
            plain_ms=cuda_ms(torch, lambda: pareto.nsga2_select_plain(F, P // 2),
                             1 if large else 50),
            bound_ms=bms, bound_by=by, library_ms=None,
        ))
    print("kernel nsga2_rank_crowd: library_ms null, no single PyTorch call computes "
          "nondominated ranks with crowding", flush=True)
    return rows


def check_ladder(torch, ck, dev, gen, fails):
    """K1 with the jitter ladder's arguments: jitter and skip against the
    plain version at (3, 256); the ladder at the fit's shape (2, 1024), one
    member first factoring at rung 2, against the ladder that forms
    K + jitter·I first and decides its retries on the host, bit for bit;
    the time of a rung that every matrix skips (its launch floors: the
    fused call, as the ladder runs it from 8 tiles), and a skipped K1b
    call's and a skipped fused call's device launches and µs at (2, 1024)
    and (1, 5051)."""
    from hebo_tpu_torch.bench.gram_probe import device_per_call
    from hebo_tpu_torch.ops import chol as tchol

    A = torch.randn((3, 256, 256), generator=gen, device=dev)
    K = (A @ A.transpose(1, 2) / 256 + 0.5 * torch.eye(256, device=dev)).contiguous()
    jitter = torch.tensor([1e-3, 0.5, 0.25], device=dev)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32, device=dev)
    out = [(torch.full((3, 256, 256), 7.0, device=dev), torch.full((3, 4, 64, 64), 7.0, device=dev),
            torch.full((3, 256, 256), 7.0, device=dev)) for _ in range(2)]
    for (L, Wd, W), (fac, winv) in zip(out, ((ck.chol_factor, ck.chol_winv),
                                             (ck.chol_factor_plain, ck.chol_winv_plain))):
        fac(K, jitter, skip, out=(L, Wd))
        winv(L, Wd, skip, out=W)
    (L, Wd, W), (L0, Wd0, W0) = out
    err = max((L - L0).abs().max().item(), (Wd - Wd0).abs().max().item())
    err_w = (W - W0).abs().max().item()
    kept = bool((L[1] == 7).all() and (Wd[1] == 7).all() and (W[1] == 7).all())
    print(f"chol skip/jitter (3, 256): L/Wd err {err}, W err {err_w}, skipped member kept {kept}",
          flush=True)
    if not (err <= L_TOL and err_w <= W_TOL and kept):
        fails.append(f"chol skip/jitter (3, 256): L/Wd err {err}, W err {err_w}, kept {kept}")

    N = 1024
    A = torch.randn((2, N, N), generator=gen, device=dev)
    K = A @ A.transpose(1, 2) / N + 0.5 * torch.eye(N, device=dev)
    Q, _ = torch.linalg.qr(torch.randn((N, N), generator=gen, device=dev))
    d = torch.rand(N, generator=gen, device=dev) * 0.5 + 0.5
    d[0] = -2e-5
    K[1] = (Q * d) @ Q.T
    K = K.contiguous()
    L, W, ok = tchol.batched_ladder_factor(K, tchol.LADDER)
    eye = torch.eye(N, device=dev)
    scale = torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), min=1e-12)[:, None, None]
    L0, W0 = ck.chol_inv((K + (1e-6 + tchol.LADDER[0] * scale) * eye).contiguous())
    ok0 = torch.isfinite(L0).all(-1).all(-1)
    first = torch.zeros(2, dtype=torch.int64, device=dev)
    for i, rung in enumerate(tchol.LADDER[1:], 1):
        if bool(ok0.all()):
            break
        L2, W2 = ck.chol_inv((K + (1e-6 + rung * scale) * eye).contiguous())
        ok2 = torch.isfinite(L2).all(-1).all(-1)
        take = (~ok0) & ok2
        first = torch.where(take, i, first)
        L0 = torch.where(take[:, None, None], L2, L0)
        W0 = torch.where(take[:, None, None], W2, W0)
        ok0 = ok0 | ok2
    same = bool(torch.equal(ok, ok0) and torch.equal(L, L0) and torch.equal(W, W0))
    print(f"chol ladder (2, 1024), every rung launched vs retries decided on the host: same bits "
          f"{same}, ok {ok.tolist()}, first rung {first.tolist()}", flush=True)
    if not (same and bool(ok.all()) and first.tolist() == [0, 2]):
        fails.append(f"chol ladder (2, 1024): same bits {same}, ok {ok.tolist()}, "
                     f"first rung {first.tolist()} (expected [0, 2])")
    Lp, Wdp = ck.chol_factor(K)
    Wp = ck.chol_winv(Lp, Wdp)
    all_skip = torch.ones(2, dtype=torch.int32, device=dev)
    jit = torch.zeros(2, device=dev)
    skipped_ms = cuda_ms(torch, lambda: ck.factor_inv(K, jit, all_skip, out=(Lp, Wdp, Wp)), 200)
    print(f"chol skipped rung (2, 1024): {skipped_ms:.4f} ms per K1 call of the ladder (the fused "
          f"call, K1a route {ck.route(N)}: launches whose CTAs return at once)", flush=True)
    skipped_winv = {"2x1024": device_per_call(torch, lambda: ck.chol_winv(Lp, Wdp, all_skip, out=Wp), 50,
                                              "winv")}
    skipped_fused = {"2x1024": device_per_call(
        torch, lambda: ck.chol_factor_inv(K, jit, all_skip, out=(Lp, Wdp, Wp)), 50, "chol_")}
    # BOCS's Gibbs sweep: a skipped K1a call at (1, 5051), and a skipped K1b call
    K2, K = K, spd(torch, 1, 5051, dev, gen)
    Lb, Wdb = ck.chol_factor(K)
    Wb = ck.chol_winv(Lb, Wdb)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    zero = torch.zeros(1, device=dev)
    skipped_5051 = cuda_ms(torch, lambda: ck.chol_factor_inv(K, zero, one, out=(Lb, Wdb, Wb)), 200)
    print(f"chol skipped rung (1, 5051): {skipped_5051:.4f} ms per fused call (K1a route "
          f"{ck.route(5051)})", flush=True)
    skipped_winv["1x5051"] = device_per_call(torch, lambda: ck.chol_winv(Lb, Wdb, one, out=Wb), 50, "winv")
    skipped_fused["1x5051"] = device_per_call(
        torch, lambda: ck.chol_factor_inv(K, zero, one, out=(Lb, Wdb, Wb)), 50, "chol_")
    for what, rows in (("chol_winv", skipped_winv), ("chol_factor_inv", skipped_fused)):
        for shape, (us, launches) in rows.items():
            print(f"{what} skipped call {shape}: {launches:g} device launches, {us:.2f} device us "
                  f"(torch.profiler)", flush=True)
    # the launches the check reads: each kernel's most per call over three
    # profiles, rounded (the profiler drops events; see whole_launches)
    launches_fused = {
        "2x1024": whole_launches(torch, lambda: ck.chol_factor_inv(K2, jit, all_skip, out=(Lp, Wdp, Wp)), 50),
        "1x5051": whole_launches(torch, lambda: ck.chol_factor_inv(K, zero, one, out=(Lb, Wdb, Wb)), 50)}
    print(f"chol_factor_inv skipped call, kernels per call (most of 3 profiles): {launches_fused}",
          flush=True)
    if any(sum(c.values()) != 2 for c in launches_fused.values()):
        fails.append(f"chol_factor_inv: a skipped call is not 2 launches: {launches_fused} "
                     f"(as counted: {skipped_fused})")
    return dict(skipped_rung_ms=skipped_ms, skipped_rung_5051_ms=skipped_5051, ladder_same_bits=same,
                skipped_winv={k: {"device_us": us, "launches": n} for k, (us, n) in skipped_winv.items()},
                skipped_fused={k: {"device_us": us, "launches": n} for k, (us, n) in skipped_fused.items()})


def check_ptxas(logs, fails):
    """Print ptxas' registers / spills per kernel; K3's register routes
    (regs, regs32, warp) and K1's flow routes must spill nothing and keep no
    stack frame, and every instantiation of K3's long routes must be
    reported."""
    for src, log in logs.items():
        name = None
        for line in log.splitlines():
            if "Function properties for" in line:
                name = line.split("Function properties for")[-1].strip()
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"ptxas {src}: {line.split('info    :')[-1].strip()}", flush=True)
            watched = name and ("_regs" in name or "_warp" in name or "chol_flow" in name
                                or "winv_flow" in name)
            if watched and "spill" in line and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
                fails.append(f"ptxas {src} {name}: {line.strip()}")
    if "_regs" not in logs.get("ssk", ""):
        fails.append("ptxas: no report of K3's register route")
    # mangled names: ssk_cross_regs<P, LMAX>, ssk_self_warp<P>
    for mode in ("cross", "self"):
        for P in (1, 2, 3):
            for inst in [f"ssk_{mode}_regsILi{P}ELi{lmax}E" for lmax in (32,)] + [f"ssk_{mode}_warpILi{P}E"]:
                if inst not in logs.get("ssk", ""):
                    fails.append(f"ptxas: no report of K3's {inst}")


def check_chol_api(torch, ck, dev, gen, fails):
    """The K1-backed API of the JAX package's resident kernel at (2, 512)."""
    A = torch.randn((2, 512, 512), generator=gen, device=dev)
    K = (A @ A.transpose(1, 2) / 512 + 0.5 * torch.eye(512, device=dev)).contiguous()
    L = ck.cholesky_batched(K)
    L2, W = ck.chol_inv_batched(K)
    L0, Wd0 = ck.chol_factor_plain(K)
    W0 = ck.chol_winv_plain(L0, Wd0)
    err_l = max((L - L0).abs().max().item(), (L2 - L0).abs().max().item())
    err_w = (W - W0).abs().max().item()
    if not (err_l <= L_TOL and err_w <= W_TOL):
        fails.append(f"cholesky_batched / chol_inv_batched (2, 512): errors L {err_l}, W {err_w}")
    bms, by = bound(2 * 512 ** 3 / 3, 4 * 2 * (2 * 512 * 512))
    row = dict(shape=[2, 512], max_abs_err_L=err_l, max_abs_err_W=err_w,
               ms=cuda_ms(torch, lambda: ck.cholesky_batched(K), 20),
               plain_ms=cuda_ms(torch, lambda: ck.chol_factor_plain(K), 20),
               bound_ms=bms, bound_by=by,
               library_ms=cuda_ms(torch, lambda: torch.linalg.cholesky_ex(K), 20))
    print("K4 API over K1 (cholesky_batched, (2,512)):", json.dumps(row), flush=True)
    return row


def ackley(df):
    X = df[[f"x{i}" for i in range(6)]].values.astype(float)
    s1 = (X ** 2).mean(1) ** 0.5
    s2 = np.cos(2 * math.pi * X).mean(1)
    return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + math.e).reshape(-1, 1)


def check_batch(space, rec, what, fails):
    X = space.transform(rec)
    if not (np.isfinite(X).all() and (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
            and len(rec) == 8):
        fails.append(f"{what}: suggestion not finite / out of bounds / wrong size")


def graph_vs_eager(torch, opt, what, fails):
    """One suggest on the graph path and one on the eager CUDA path, at the
    same observations and seed: the suggestions must be the same."""
    rec_g = opt.suggest(8)
    alpha_g = opt.model.caches.alpha.clone()
    opt._use_graphs = False
    try:
        rec_e = opt.suggest(8)
    finally:
        opt._use_graphs = True
    same = bool(rec_g.equals(rec_e) and torch.equal(alpha_g, opt.model.caches.alpha))
    print(f"{what}: graph and eager suggestions at {opt.num_obs} observations identical: {same}",
          flush=True)
    if not same:
        fails.append(f"{what}: the graph path's suggestion differs from the eager path's")


def k5_and_sorts(suggest, n_gens, what, fails):
    """One suggest on the graph path under torch.profiler: its device
    seconds, K5's and the sort kernels' device ms and launches.  NSGA-II
    takes its keys and survivor order from K5, so fewer sorts than
    generations must run."""
    from hebo_tpu_torch.bench.profile_suggest import _device_profile, _k5_and_sorts

    p = _device_profile(suggest)
    out = {"device_kernel_s": p["device_kernel_s"], "profiled_wall_s": p["profiled_wall_s"],
           **_k5_and_sorts(p["by_name"])}
    if out["sort_launches"] >= n_gens:
        fails.append(f"{what}: {out['sort_launches']} sort kernels in a suggest of {n_gens} "
                     f"NSGA-II generations")
    return out


def run_phases(torch, HEBO, DesignSpace, wrappers, fails):
    from hebo_tpu_torch.ops import chol_kernel as ck
    from hebo_tpu_torch.ops import pareto

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    # (a) Sobol init → 120 observations, bucket 128
    opt = HEBO(space, device="cuda")
    times = []
    while opt.num_obs < 120:
        model_round = opt.num_obs >= opt.rand_sample
        t0 = time.time()
        rec = opt.suggest(8)
        torch.cuda.synchronize()
        if model_round:
            times.append(time.time() - t0)
        check_batch(space, rec, f"phase a @ {opt.num_obs}", fails)
        opt.observe(rec, ackley(rec))
    init_best = float(opt.y[:8, 0].min())
    if not opt.best_y < init_best:
        fails.append(f"phase a: best {opt.best_y} does not beat the init phase's {init_best}")
    a = dict(n_obs=opt.num_obs, init_best=init_best, best=opt.best_y, suggests=len(times),
             s_per_suggest_median=float(np.median(times)), s_first=times[0], s_all=times,
             graphs=sorted(k[0] for k in opt._graphs),
             profiled_suggest=k5_and_sorts(lambda: opt.suggest(8), opt.iters, "phase a", fails))
    print("phase a (Ackley-6D b8, Sobol init -> 120 obs, bucket 128, graph path):", json.dumps(a),
          flush=True)
    graph_vs_eager(torch, opt, "phase a", fails)

    # (b) 800 Sobol observations (bucket 1024): the capture, then 3 timed
    # suggests on each path
    opt = HEBO(space, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(800, seed=1))
    opt.observe(warm, ackley(warm))
    b = {}
    # every rung of each ladder is launched: 51 NLLs (50 steps and the
    # final loss) of 2 rungs and the cache's 5
    steps = opt.model_config["num_epochs"]
    expect = {"matern32_gram_vjp": steps, "nsga2_rank_crowd": 2 * opt.iters,
              **k1_expect((steps + 1) * 2 + 5, 1024)}
    for path, use_graphs, n in (("graph", True, 4), ("eager", False, 3)):
        opt._use_graphs = use_graphs
        walls, launches = [], []
        for _ in range(n):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.time()
            rec = opt.suggest(8)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            launches.append({k: w.launches - before[k] for k, w in wrappers.items()
                             if w.launches > before[k]})
            check_batch(space, rec, f"phase b {path} @ {opt.num_obs}", fails)
            opt.observe(rec, ackley(rec))
        if use_graphs:  # the first suggest captured the graph
            b["s_capture"] = walls.pop(0)
            b["launches_capture"] = launches.pop(0)
        for got in launches:
            for k, want in expect.items():
                if got.get(k) != want:
                    fails.append(f"phase b {path}: {k} launched {got.get(k)} times in a suggest, "
                                 f"expected {want}")
        b[path] = dict(s_per_suggest=walls, s_median=float(np.median(walls)),
                       launches_per_suggest=launches[-1])
        if not bool(opt.model.caches.ok.all()):
            fails.append(f"phase b {path}: posterior factorization failed")
    opt._use_graphs = True
    b.update(n_obs=opt.num_obs, bucket=int(opt.model.data.X.shape[0]), best=opt.best_y,
             profiled_suggest=k5_and_sorts(lambda: opt.suggest(8), opt.iters, "phase b", fails))
    print("phase b (Ackley-6D b8, 800 warm obs, bucket 1024):", json.dumps(b), flush=True)
    graph_vs_eager(torch, opt, "phase b", fails)

    # (b2) buckets 512, 768, 1536 and 2048: K1a's flow route inside the fused graph
    for n_obs in (400, 600, 1200, 1800):
        opt = HEBO(space, device="cuda")
        warm = space.inverse_transform(space.sobol_sample_opt(n_obs, seed=1))
        opt.observe(warm, ackley(warm))
        t0 = time.time()
        rec = opt.suggest(8)
        torch.cuda.synchronize()
        bucket = int(opt.model.data.X.shape[0])
        graphs = sorted(k[0] for k in opt._graphs)
        print(f"phase b2 (Ackley-6D b8, {n_obs} warm obs): bucket {bucket}, graphs {graphs}, K1a route "
              f"{ck.route(bucket)}, capturing suggest {time.time() - t0:.2f} s", flush=True)
        check_batch(space, rec, f"phase b2 @ {opt.num_obs}", fails)
        if graphs != [bucket]:
            fails.append(f"phase b2 @ {n_obs}: bucket {bucket} not on the fused graph: {graphs}")
        opt.observe(rec, ackley(rec))
        graph_vs_eager(torch, opt, f"phase b2 (bucket {bucket})", fails)

    # (b3) HEBO(pop=700) at bucket 128: survival ranks 1,400 rows, on K5's
    # grid route, inside the fused graph
    opt = HEBO(space, pop=700, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(112, seed=1))
    opt.observe(warm, ackley(warm))
    t0 = time.time()
    rec = opt.suggest(8)
    torch.cuda.synchronize()
    b3 = {"s_capture": time.time() - t0, "k5_route_survival": pareto.route(2 * opt.pop, 3),
          "k5_route_tournament": pareto.route(opt.pop, 3)}
    check_batch(space, rec, "phase b3", fails)
    opt.observe(rec, ackley(rec))
    before = {k: wrappers[k].launches for k in ("nsga2_rank_crowd", "nsga2_rank_crowd_grid")}
    b3["profiled_suggest"] = k5_and_sorts(lambda: opt.suggest(8), opt.iters, "phase b3", fails)
    b3["launches"] = {k: wrappers[k].launches - n for k, n in before.items()}
    if b3["launches"] != {"nsga2_rank_crowd": 2 * opt.iters, "nsga2_rank_crowd_grid": opt.iters}:
        fails.append(f"phase b3: K5 launches in a suggest {b3['launches']}, expected "
                     f"{2 * opt.iters} of which {opt.iters} on the grid route")
    print("phase b3 (Ackley-6D b8, HEBO(pop=700), 112 warm obs, graph path):", json.dumps(b3),
          flush=True)
    graph_vs_eager(torch, opt, "phase b3", fails)
    return a, b


def large_n_phases(torch, HEBO, DesignSpace, GP, wrappers, fails):
    """Phase e: HEBO's generic route above max_cholesky_size, CG against
    dense at N = 2048, the GP alone at buckets 3840 and 7168."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    # (e1) 3000 Sobol observations (bucket 3072), as the JAX package's bench.py:183-193
    opt = HEBO(space, device="cuda")
    warm = opt.quasi_sample(3000)
    opt.observe(warm, ackley(warm))
    steps = opt.model_config["num_epochs"]
    # per suggest: the fit's 51 NLLs (2 K1 rungs each at bucket 2048, one
    # fused call a rung, a K2 forward; 50 VJPs), the CG cache's Gram and
    # Woodbury factor (K1a and K1b at (1, 128)), the incumbent's predict,
    # NSGA-II's 101 evaluations (2 K5 launches a generation) and the
    # population's predict
    expect = {"matern32_gram": (steps + 1) + 1 + 1 + (opt.iters + 1) + 1,
              "matern32_gram_vjp": steps, "nsga2_rank_crowd": 2 * opt.iters,
              "chol_factor_inv": (steps + 1) * 2, "chol_factor": 1, "chol_winv": 1}
    walls, launches, res = [], [], []
    for i in range(4):
        before = {k: w.launches for k, w in wrappers.items()}
        hist = {tuple(np.round(r, 6)) for r in space.transform(opt.X)}
        t0 = time.time()
        rec = opt.suggest(8)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        got = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
        launches.append(got)
        check_batch(space, rec, f"phase e1 @ {opt.num_obs}", fails)
        keys = [tuple(np.round(r, 6)) for r in space.transform(rec)]
        if set(keys) & hist or len(set(keys[2:])) != len(keys[2:]):
            fails.append(f"phase e1 @ {opt.num_obs}: a suggestion repeats the history or the batch")
        cache, model = opt.model.caches, opt.model
        res.append(float(cache.res.max()) if cache.res is not None else float("nan"))
        if opt._graphs or cache.Kt is None or model.fit_data is model.data:
            fails.append(f"phase e1 @ {opt.num_obs}: the generic route (subsampled fit, CG cache) "
                         f"was not taken: graphs {sorted(opt._graphs)}")
        if not (bool(cache.ok.all()) and res[-1] < 0.2):
            fails.append(f"phase e1 @ {opt.num_obs}: CG cache ok {cache.ok.tolist()}, residual {res[-1]}")
        if (model.fit_data.X.shape[0], model.data.X.shape[0]) != (2048, 3072):
            fails.append(f"phase e1: fit bucket {model.fit_data.X.shape[0]}, cache bucket "
                         f"{model.data.X.shape[0]}, expected 2048 and 3072")
        for k, want in expect.items():
            if got.get(k) != want:
                fails.append(f"phase e1 @ {opt.num_obs}: {k} launched {got.get(k)} times in a "
                             f"suggest, expected {want}")
        opt.observe(rec, ackley(rec))
    e1 = dict(n_obs=opt.num_obs, fit_bucket=int(opt.model.fit_data.X.shape[0]),
              cache_bucket=int(opt.model.data.X.shape[0]), s_first=walls[0],
              s_per_suggest=walls[1:], s_median=float(np.median(walls[1:])),
              fit_s=opt.fit_time[-4:], acq_s=opt.acq_time[-4:],
              fit_s_median=float(np.median(opt.fit_time[-3:])),
              acq_s_median=float(np.median(opt.acq_time[-3:])),
              cg_residual=res, launches_per_suggest=launches[-1], best=opt.best_y)
    print("phase e1 (Ackley-6D b8, 3000 Sobol obs, generic route, fit bucket 2048, CG cache "
          "bucket 3072):", json.dumps(e1), flush=True)

    # (e2) CG against dense at N = 2048 (tests/test_cg.py:57-89)
    sp4 = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -3.0, "ub": 3.0} for i in range(4)])
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (2048, 4)).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.1 * X[:, 1:2] ** 2).astype(np.float32)
    Xq = rng.uniform(-3, 3, (100, 4)).astype(np.float32)
    kw = dict(num_epochs=15, n_restarts=1, seed=7)
    dense = GP(sp4, device="cuda", **kw).fit(X, y)
    cg = GP(sp4, device="cuda", max_cholesky_size=1024, cg_rank=96, cg_iters=128, **kw)
    cg.data, cg.samples, cg.params = dense.data, dense.samples, dense.params
    cg.caches = cg.core.posterior_cache_batched(dense.samples, dense.data)
    mu_d, v_d = dense.predict(Xq)
    mu_c, v_c = cg.predict(Xq)
    e2 = dict(n=2048, routes=[dense.caches.Wf is not None, cg.caches.Kt is not None],
              cg_residual=float(cg.caches.res.max()), cg_ok=bool(cg.caches.ok.all()),
              mu_max_abs_err=float(np.abs(mu_c - mu_d).max()),
              var_max_abs_err=float(np.abs(v_c - v_d).max()),
              mu_ok=bool(np.allclose(mu_c, mu_d, rtol=2e-2, atol=2e-2)),
              var_ok=bool(np.allclose(v_c, v_d, rtol=5e-2, atol=2e-2)))
    # test_cg.py's atol is the size of σ² itself at N = 2048: a converged
    # solve is also held within 1e-3 of the largest |μ| and 1e-2 of the
    # largest σ²
    e2.update(mu_tight=bool(e2["mu_max_abs_err"] <= 1e-3 * float(np.abs(mu_d).max())),
              var_tight=bool(e2["var_max_abs_err"] <= 1e-2 * float(v_d.max())))
    print("phase e2 (GP N 2048, CG vs dense K1 posterior, 100 queries):", json.dumps(e2), flush=True)
    if not (all(e2["routes"]) and e2["cg_ok"] and e2["mu_ok"] and e2["var_ok"]
            and e2["mu_tight"] and e2["var_tight"]):
        fails.append(f"phase e2: CG posterior disagrees with the dense one: {e2}")

    # (e3) the GP alone at buckets 3840 and 7168 (bench.py:155-181)
    e3 = {}
    for n_obs in (3600, 7000):
        rng = np.random.default_rng(0)
        Xn = rng.uniform(-5, 5, (n_obs, 6))
        yn = (np.sum(Xn ** 2, axis=1, keepdims=True) / 10).astype(np.float32)
        Xv = space.transform(space.inverse_transform(Xn))
        gp = GP(space, device="cuda", num_epochs=50)
        for _ in range(2):  # a warm call, then the timed one
            t0 = time.time()
            gp.fit(Xv, yn)
            torch.cuda.synchronize()
            fit_s = time.time() - t0
        for _ in range(2):
            t0 = time.time()
            mu, var = gp.predict(Xv[:512])
            pred_s = time.time() - t0
        row = dict(bucket=int(gp.data.X.shape[0]), fit_bucket=int(gp.fit_data.X.shape[0]),
                   fit_s=fit_s, predict512_s=pred_s, cg_residual=float(gp.caches.res.max()),
                   ok=bool(gp.caches.ok.all()), finite=bool(np.isfinite(mu).all() and np.isfinite(var).all()
                                                        and (var > 0).all()))
        e3[f"n{n_obs}"] = row
        if not (row["finite"] and row["ok"]):
            fails.append(f"phase e3 N {n_obs}: predictions finite {row['finite']}, cache ok {row['ok']}")
    print("phase e3 (GP alone, Ackley-6D box, y = |x|^2 / 10):", json.dumps(e3), flush=True)

    # (e4) max_cholesky_size 4096 at 3000 observations: bucket 3072 stays on
    # the fused graph, whose posterior is the K1 ladder at (2, 3072)
    opt4 = HEBO(space, device="cuda", model_config={"max_cholesky_size": 4096})
    opt4.observe(warm, ackley(warm))
    e4 = dict(s_per_suggest=[], k1_launches=[])
    for i in range(2):  # the capture, then a replay
        before = wrappers["chol_factor_inv"].launches
        hist = {tuple(np.round(r, 6)) for r in space.transform(opt4.X)}
        t0 = time.time()
        rec = opt4.suggest(8)
        torch.cuda.synchronize()
        e4["s_per_suggest"].append(time.time() - t0)
        e4["k1_launches"].append(wrappers["chol_factor_inv"].launches - before)
        check_batch(space, rec, f"phase e4 @ {opt4.num_obs}", fails)
        keys = [tuple(np.round(r, 6)) for r in space.transform(rec)]
        if set(keys) & hist or len(set(keys[2:])) != len(keys[2:]):
            fails.append(f"phase e4 @ {opt4.num_obs}: a suggestion repeats the history or the batch")
        opt4.observe(rec, ackley(rec))
    m = opt4.model
    cache, data = m.caches, m.data
    # α against the train system in float64: ‖Kt α − r‖ / ‖r‖ per sample,
    # held below the CG cache's own bound (0.2)
    with torch.no_grad():
        Kt, r = m.core._train_system(m.samples, data)
    res = (torch.linalg.vector_norm(Kt.double() @ cache.alpha.double() - r.double(), dim=(-2, -1))
           / torch.linalg.vector_norm(r.double(), dim=(-2, -1)))
    e4.update(graphs=sorted(k[0] for k in opt4._graphs), cache_shape=list(cache.L.shape),
              ok=bool(cache.ok.all()), alpha_residual=res.tolist())
    print("phase e4 (Ackley-6D b8, 3000 Sobol obs, max_cholesky_size 4096, fused graph at "
          "bucket 3072):", json.dumps(e4), flush=True)
    if (e4["graphs"] != [3072] or cache.Kt is not None or cache.Wf is None
            or e4["cache_shape"][-1] != 3072 or min(e4["k1_launches"]) == 0):
        fails.append(f"phase e4: bucket 3072 did not run the K1 ladder in the fused graph: {e4}")
    if not (e4["ok"] and max(e4["alpha_residual"]) < 0.2):
        fails.append(f"phase e4: the K1 posterior at bucket 3072 is off: {e4}")
    graph_vs_eager(torch, opt4, "phase e4 (bucket 3072, K1a's flow route)", fails)
    return e1, e2, e3, e4


def timed_suggests(torch, opt, space, n, what, wrappers, fails, k1=None):
    """``n`` suggest(8) + observe; walls, the optimizer's fit / acquisition
    seconds and the launches of each suggest (and K1's calls by batch)."""
    walls, launches, batches = [], [], []
    for _ in range(n):
        before = {k: w.launches for k, w in wrappers.items()}
        if k1 is not None:
            k1.take()
        t0 = time.time()
        rec = opt.suggest(8)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        launches.append({k: w.launches - before[k] for k, w in wrappers.items()
                         if w.launches > before[k]})
        if k1 is not None:
            batches.append(k1.take())
        check_batch(space, rec, f"{what} @ {opt.num_obs}", fails)
        opt.observe(rec, ackley(rec))
    if not bool(opt.model.caches.ok.all()):
        fails.append(f"{what}: posterior factorization failed")
    return dict(s_per_suggest=walls, fit_s=opt.fit_time[-n:], acq_s=opt.acq_time[-n:],
                launches_per_suggest=launches, **({"k1_calls_by_batch": batches} if k1 else {}))


def warm_hebo(HEBO, space, n_obs, **kw):
    opt = HEBO(space, device="cuda", **kw)
    warm = space.inverse_transform(space.sobol_sample_opt(n_obs, seed=1))
    opt.observe(warm, ackley(warm))
    routes = []
    for name in ("_fused_suggest", "_generic_suggest"):
        orig = getattr(opt, name)
        setattr(opt, name, lambda *a, _o=orig, _n=name, **k: (routes.append(_n[1:-8]), _o(*a, **k))[1])
    return opt, routes


def options_phase(torch, HEBO, DesignSpace, wrappers, fails):
    """Phase f: the GP's options on the fused graph at bucket 1024 (input
    warp and heteroscedastic noise), then gpy_wgp and gpy_mlp on the generic
    route, all at 800 warm Sobol observations of Ackley-6D."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt, routes = warm_hebo(HEBO, space, 800,
                            model_config={"input_warp": True, "heteroscedastic": True})
    steps = opt.model_config["num_epochs"]
    # as phase b: 51 NLLs of 2 rungs and the cache's 5; K2 forward 51 + 1 +
    # 1 + 101 + 1 (fit, cache, incumbent, NSGA-II, population)
    expect = {"matern32_gram": (steps + 1) + 1 + 1 + (opt.iters + 1) + 1,
              "matern32_gram_vjp": steps, "nsga2_rank_crowd": 2 * opt.iters,
              **k1_expect((steps + 1) * 2 + 5, 1024)}
    f = {}
    for path, use_graphs, n in (("graph", True, 4), ("eager", False, 3)):
        opt._use_graphs = use_graphs
        f[path] = timed_suggests(torch, opt, space, n, f"phase f {path}", wrappers, fails)
        if use_graphs:
            f["s_capture"] = f[path]["s_per_suggest"].pop(0)
            f[path]["launches_per_suggest"].pop(0)
        for got in f[path]["launches_per_suggest"]:
            for k, want in expect.items():
                if got.get(k) != want:
                    fails.append(f"phase f {path}: {k} launched {got.get(k)} times in a suggest, "
                                 f"expected {want}")
        f[path]["s_median"] = float(np.median(f[path]["s_per_suggest"]))
    opt._use_graphs = True
    p = opt.model.params
    f.update(routes=routes, graphs=sorted(k[0] for k in opt._graphs),
             noise_w_shape=list(p.noise_w.shape), log_wa=p.log_wa[0].tolist())
    if set(routes) != {"fused"} or f["graphs"] != [1024] or p.noise_w is None:
        fails.append(f"phase f: warp + heteroscedastic did not run on the fused graph at 1024: {f}")
    graph_vs_eager(torch, opt, "phase f", fails)
    for name in ("gpy_wgp", "gpy_mlp"):
        o, r = warm_hebo(HEBO, space, 800, model_name=name)
        row = timed_suggests(torch, o, space, 2, f"phase f {name}", wrappers, fails)
        row.update(routes=r, n_restarts=o.model.n_restarts, kernel=o.model.core.kernel_name,
                   input_warp=o.model.core.input_warp, best=o.best_y)
        if set(r) != {"generic"} or o._graphs:
            fails.append(f"phase f {name}: not on the generic route: {r}")
        f[name] = row
    print("phase f (Ackley-6D b8, 800 warm obs, bucket 1024: warp + heteroscedastic on the graph, "
          "gpy_wgp and gpy_mlp on the generic route):", json.dumps(f), flush=True)
    return f


def inference_phase(torch, HEBO, DesignSpace, wrappers, fails):
    """Phase g: hyperparameter inference on the generic route (HMC at 120
    and 800 observations, SMC and SVI at 800) and the slice optimizer on the
    fused graph at 120, Ackley-6D, batch 8."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    g = {}
    from hebo_tpu_torch.bench.profile_suggest import K1Batches

    k1 = K1Batches()
    try:
        for name, conf, n_obs, n in (("hmc_120", {"inference": "hmc"}, 120, 2),
                                     ("hmc_800", {"inference": "hmc"}, 800, 2),
                                     ("smc_800", {"inference": "smc"}, 800, 2),
                                     ("svi_800", {"inference": "svi"}, 800, 2),
                                     # the capture, then one replay (a third suggest
                                     # would pass 128 observations: a new bucket)
                                     ("slice_120", {"optimizer": "slice"}, 120, 2)):
            opt, routes = warm_hebo(HEBO, space, n_obs, model_config=conf)
            row = timed_suggests(torch, opt, space, n, f"phase g {name}", wrappers, fails, k1)
            m = opt.model
            row.update(routes=routes, bucket=int(m.data.X.shape[0]),
                       s_median=float(np.median(row["s_per_suggest"][1:] or row["s_per_suggest"])),
                       samples=list(m.samples.log_sc.shape), best=opt.best_y)
            if m.accept_rate is not None:
                row["accept_rate"] = m.accept_rate.tolist()
            want = "fused" if "inference" not in conf else "generic"
            if set(routes) != {want}:
                fails.append(f"phase g {name}: routes {routes}, expected {want}")
            if not all(launched(r, "chol_factor") > 0 for r in row["launches_per_suggest"]):
                fails.append(f"phase g {name}: a suggest launched no K1")
            g[name] = row
    finally:
        k1.close()
    print("phase g (Ackley-6D b8: HMC at 120 and 800 obs, SMC and SVI at 800 on the generic route, "
          "slice at 120 on the fused graph):", json.dumps(g), flush=True)
    return g


def thompson_phase(torch, DesignSpace, GP, ck, wrappers, fails):
    """Phase h: GP.sample_f at bucket 1024 (800 Ackley-6D observations) with
    512 queries: K1's joint factor against its plain version, and the mean
    of 256 draws within 4σ/√256 of predict (σ² with the factor's 1e-5
    jitter)."""
    from hebo_tpu_torch.models.gp import gp as gp_mod
    from hebo_tpu_torch.ops import chol as tchol

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    X = space.sobol_sample_opt(800, seed=1)
    y = ackley(space.inverse_transform(X))
    Xq = space.sobol_sample_opt(512, seed=2)
    gp = GP(space, device="cuda", num_epochs=50, n_restarts=2).fit(X, y)
    seen, saved = [], gp_mod.batched_ladder_factor

    def ladder(K, *a, **k):
        seen.append((K.clone(), a, k))
        return saved(K, *a, **k)

    gp_mod.batched_ladder_factor = ladder
    try:
        f = gp.sample_f(n_samples=256, seed=0)
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        t0 = time.time()
        draws = f(Xq)
        wall = time.time() - t0
        launches = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
    finally:
        gp_mod.batched_ladder_factor = saved
    cov = seen[-1][0]
    mu, var = gp.predict(Xq)
    jit_raw = 1e-5 * float(gp.data.y_std) ** 2
    dev_ = np.abs(draws.mean(0) - mu)
    bound_ = 4 * np.sqrt(var + jit_raw) / math.sqrt(256)
    # K1 on the joint covariance against its plain version, at the first
    # rung's jitter (1e-5 + 0·scale), as the ladder calls it (the fused call)
    Kj = (cov + 1e-5 * torch.eye(cov.shape[-1], device=cov.device)).contiguous()
    L, Wd, W = ck.factor_inv(Kj)
    L0, Wd0, W0 = ck.chol_factor_inv_plain(Kj)
    err = max((L - L0).abs().max().item(), (Wd - Wd0).abs().max().item())
    err_w = (W - W0).abs().max().item()
    h = dict(bucket=int(gp.data.X.shape[0]), queries=512, draws=256, cov_shape=list(cov.shape),
             s_sample=wall, launches=launches, k1_vs_plain_max_abs_err=err, k1_w_vs_plain_max_abs_err=err_w,
             max_mean_dev_over_bound=float((dev_ / bound_).max()), finite=bool(np.isfinite(draws).all()))
    print("phase h (GP.sample_f, 800 Ackley-6D obs, bucket 1024, 512 queries, 256 draws):",
          json.dumps(h), flush=True)
    if list(cov.shape) != [1, 512, 512] or launches.get("chol_factor_inv") != len(tchol.LADDER):
        fails.append(f"phase h: the joint factor did not run K1's ladder at (1, 512): {h}")
    if not (h["finite"] and h["max_mean_dev_over_bound"] <= 1.0 and err <= L_TOL and err_w <= W_TOL):
        fails.append(f"phase h: Thompson draws off: {h}")
    return h


def antbo_phases(torch, AntBOOptimizer, AbsolutTool, pad_bucket, fails):
    from hebo_tpu_torch.optimizers.antbo import AA_ALPHABET, check_cdr_constraints

    tool = AbsolutTool("1H0D_C", seq_len=11)
    letters = set(AA_ALPHABET)

    def score(opt, rec, what):
        seqs = ["".join(r) for _, r in rec.iterrows()]
        if not all(len(q) == 11 and set(q) <= letters for q in seqs):
            fails.append(f"{what}: suggestion not 11 letters of the alphabet: {seqs}")
        y = tool(seqs)
        if not np.isfinite(y).all():
            fails.append(f"{what}: energy not finite")
        return seqs, y

    def timed_suggests(opt, n, what):
        walls, feasible = [], []
        for _ in range(n):
            t0 = time.time()
            rec = opt.suggest(2)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
            seqs, y = score(opt, rec, f"{what} @ {opt.num_obs}")
            feasible += [check_cdr_constraints(q) for q in seqs]
            opt.observe(rec, y)
        return dict(s_per_suggest=walls, fit_s=opt.fit_time[-n:], acq_s=opt.acq_time[-n:],
                    s_per_suggest_median=float(np.median(walls)),
                    fit_s_median=float(np.median(opt.fit_time[-n:])),
                    acq_s_median=float(np.median(opt.acq_time[-n:])),
                    feasible_share=float(np.mean(feasible)))

    # (c) 10 Sobol init designs, then 10 model suggests of 2 → 30 observations
    opt = AntBOOptimizer(seq_len=11, kernel="ssk", n_init=10, device="cuda")
    while opt.num_obs < opt.n_init:
        rec = opt.suggest(2)
        opt.observe(rec, score(opt, rec, "phase c init")[1])
    init_best = float(opt.y[:10, 0].min())
    c = timed_suggests(opt, 10, "phase c")
    bucket = int(opt.model.data.X.shape[0])
    if bucket != 32 or opt.num_obs != 30:
        fails.append(f"phase c: {opt.num_obs} observations in bucket {bucket}, expected 30 in 32")
    if not opt.best_y < init_best:
        fails.append(f"phase c: best {opt.best_y} does not beat the init phase's {init_best}")
    c.update(n_obs=opt.num_obs, bucket=bucket, init_best=init_best, best=opt.best_y,
             suggests=10, tr_restarts=opt.tr_manager.restart_count)
    print("phase c (AntBO SSK, 1H0D_C, init 10 -> 30 obs, bucket 32):", json.dumps(c), flush=True)

    # (d) AntBO's budget of 200 designs warm-started, then 2 x suggest(2)
    opt = AntBOOptimizer(seq_len=11, kernel="ssk", n_init=10, device="cuda")
    warm = opt.space.sample(200, seed=1)
    opt.observe(warm, score(opt, warm, "phase d warm")[1])
    d = timed_suggests(opt, 2, "phase d")
    bucket = int(opt.model.data.X.shape[0])
    if bucket != pad_bucket(200):
        fails.append(f"phase d: bucket {bucket}, expected {pad_bucket(200)}")
    if not bool(opt.model.caches.ok.all()):
        fails.append("phase d: posterior factorization failed")
    d.update(n_obs=opt.num_obs, bucket=bucket, best=opt.best_y, suggests=2)
    print("phase d (AntBO SSK, 1H0D_C, 200 warm obs, bucket 256):", json.dumps(d), flush=True)
    return c, d


def ackley53_space(DesignSpace):
    """Casmopolitan's Ackley-53 (Wan et al. 2021, §5): 50 binary
    categoricals and 3 numerics in [−1, 1]."""
    return DesignSpace([{"name": f"b{i}", "type": "cat", "categories": ["0", "1"]} for i in range(50)]
                       + [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)])


def ackley53(df):
    """Ackley over the 53 inputs, the binary ones as 0 / 1."""
    Z = np.concatenate([df[[f"b{i}" for i in range(50)]].values.astype(float),
                        df[[f"x{i}" for i in range(3)]].values.astype(float)], 1)
    s1 = (Z ** 2).mean(1) ** 0.5
    s2 = np.cos(2 * math.pi * Z).mean(1)
    return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + math.e).reshape(-1, 1)


class ShapeLog:
    """Records the shapes at which every kernel is launched while it is
    open, by wrapping ``native.call``, through which every wrapper launches
    (the dims are its trailing arguments; each wrapper still counts its own
    launches): K2 and its VJP (B, N, M, D), K3 cross (B, N, M, L, P) and
    self (B, N, L, P), K1a (B, n), K1b (B, padded n), the fused K1 call
    (B, n) and K5 (P, M), either route."""

    DIMS = {"hebo_matern32_gram": ("matern32_gram", -4, None),
            "hebo_matern32_gram_vjp": ("matern32_gram_vjp", -4, None),
            "hebo_ssk_cross": ("ssk_cross", -5, None), "hebo_ssk_self": ("ssk_self", -4, None),
            "hebo_chol_factor": ("chol_factor", -3, -1), "hebo_chol_winv": ("chol_winv", -2, None),
            "hebo_chol_factor_inv": ("chol_factor_inv", -3, -1),
            "hebo_nsga2_rank_crowd": ("nsga2_rank_crowd", -2, None),
            "hebo_nsga2_rank_crowd_grid": ("nsga2_rank_crowd", -2, None)}

    def __init__(self):
        from hebo_tpu_torch.ops import native

        self.seen = {name: set() for name, _, _ in self.DIMS.values()}
        self.count = collections.Counter()  # launches by (kernel, shape)
        self._native, self._saved = native, native.call

        def call(fn, device, *args):
            hit = self.DIMS.get(getattr(fn, "__name__", ""))
            if hit is not None:
                shape = tuple(int(a) for a in args[hit[1]:hit[2]])
                self.seen[hit[0]].add(shape)
                self.count[hit[0], shape] += 1
            return self._saved(fn, device, *args)

        native.call = call

    def close(self):
        self._native.call = self._saved


def synt60_space(DesignSpace):
    """LassoBench ``synt_simple``'s published box, [−1, 1]^60 (the JAX
    package's tasks/lasso.py:26-29), RDUCB's flagship width."""
    return DesignSpace([{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(60)])


def pairwise60(df):
    """A stand-in objective over the 60-D box (the card's machine has no
    sklearn for the real lasso): 30 random pairwise terms
    Σ_k a_k sin(3 x_i x_j + b_k) + 0.1 (x_i − x_j)², fixed by a seed."""
    rng = np.random.default_rng(60)
    pairs = rng.permutation(60).reshape(30, 2)
    a, b = rng.uniform(0.5, 1.5, 30), rng.uniform(0, math.pi, 30)
    X = df[[f"x{i}" for i in range(60)]].values.astype(float)
    xi, xj = X[:, pairs[:, 0]], X[:, pairs[:, 1]]
    return (a * np.sin(3 * xi * xj + b) + 0.1 * (xi - xj) ** 2).sum(1).reshape(-1, 1)


def mcbo_problems(DesignSpace, PestControlTask):
    """Phase i's problems, {name: (space, objective)}: pest control at its
    published size (25 stations × 5 choices), Ackley-53 and the 60-D
    ``synt_simple`` box with a pairwise stand-in objective."""
    pest = PestControlTask(n_stations=25)
    return {"pest": (pest.space, pest), "ackley53": (ackley53_space(DesignSpace), ackley53),
            "synt60": (synt60_space(DesignSpace), pairwise60)}


MCBO_PRESETS = (("COMBO", "pest"), ("BOCS", "pest"), ("BOSS", "pest"), ("BOiLS", "pest"),
                ("Casmopolitan", "ackley53"), ("BODi", "ackley53"), ("CoCaBO", "ackley53"),
                ("RDUCB", "synt60"))


def mcbo_phase(torch, DesignSpace, wrappers, fails):
    """Phase i: every ``BO_ALGOS`` preset through ``build_bo(space,
    device="cuda")`` at its defaults, and RDUCB once more with
    ``relearn_every=1`` and the learned decomposition; 200 random warm
    observations, then 2 × suggest(1); returns the per-preset rows and the
    shapes the kernels were called at."""
    import dataclasses

    from hebo_tpu_torch.bench.profile_suggest import K1Batches
    from hebo_tpu_torch.optimizers.bo_builder import BO_ALGOS
    from hebo_tpu_torch.tasks import PestControlTask

    problems = mcbo_problems(DesignSpace, PestControlTask)
    learn = dataclasses.replace(BO_ALGOS["RDUCB"], model_kwargs={"decomposition": "learn"})
    runs = [(name, prob, BO_ALGOS[name], {}) for name, prob in MCBO_PRESETS]
    runs.append(("RDUCB learn", "synt60", learn, {"relearn_every": 1}))
    rows = {}
    k1, shapes = K1Batches(), ShapeLog()
    try:
        for name, prob, builder, kw in runs:
            space, f = problems[prob]
            opt = builder.build_bo(space, n_init=10, seed=0, device="cuda", **kw)
            warm = space.sample(200, seed=1)
            opt.observe(warm, f(warm))
            k1.take()
            walls, launches, batches = [], [], []
            for _ in range(2):
                before = {k: w.launches for k, w in wrappers.items()}
                seen = {tuple(np.round(r, 6)) for r in space.transform(opt.X)}
                t0 = time.time()
                rec = opt.suggest(1)
                torch.cuda.synchronize()
                walls.append(time.time() - t0)
                launches.append({k: w.launches - before[k] for k, w in wrappers.items()
                                 if w.launches > before[k]})
                batches.append(k1.take())
                X = space.transform(rec)
                y = f(rec)
                what = f"phase i {name} @ {opt.num_obs}"
                if not (len(rec) == 1 and np.isfinite(X).all() and (X >= space.opt_lb).all()
                        and (X <= space.opt_ub).all() and np.array_equal(X, space.round_opt(X))):
                    fails.append(f"{what}: suggestion not in the space: {rec.values.tolist()}")
                if tuple(np.round(X[0], 6)) in seen:
                    fails.append(f"{what}: suggestion repeats an observation")
                if not np.isfinite(y).all():
                    fails.append(f"{what}: objective not finite")
                opt.observe(rec, y)
            model = opt.model
            rows[name] = dict(
                problem=prob, model=builder.model_id, acq_opt=builder.acq_opt_id,
                acq=builder.acq_func_id, n_obs=opt.num_obs,
                bucket=int(model.data.X.shape[0]) if hasattr(model, "data") else None,
                s_per_suggest=walls, fit_s=opt.fit_time[-2:], acq_s=opt.acq_time[-2:],
                launches_per_suggest=launches, k1_calls_by_batch=batches, best=opt.best_y,
                **({"cliques": [list(map(int, c)) for c in model.cliques]}
                   if hasattr(model, "cliques") else {}))
            print(f"phase i {name} ({prob}):", json.dumps(rows[name]), flush=True)
    finally:
        k1.close()
        shapes.close()
    bocs = rows["BOCS"]["k1_calls_by_batch"]
    if not all(b.get("1x5051", 0) >= 300 for b in bocs):
        fails.append(f"phase i BOCS: K1 did not factor at (1, 5051) in every Gibbs sweep: {bocs}")
    # RDUCB: the fit's ladder at (1, 256); the learner's 120 moves at (24, 256)
    for name, key, least in (("RDUCB", "1x256", 1), ("RDUCB learn", "1x256", 1),
                             ("RDUCB learn", "24x256", 120)):
        got = rows[name]["k1_calls_by_batch"]
        if not all(b.get(key, 0) >= least for b in got):
            fails.append(f"phase i {name}: K1 did not factor at {key} ({least}+ calls) in every "
                         f"suggest: {got}")
    if rows["RDUCB learn"]["cliques"] == rows["RDUCB"]["cliques"]:
        fails.append("phase i RDUCB learn: the learned decomposition equals the random tree")
    for name, kernels in (("BOSS", ("ssk_cross", "ssk_self", "nsga2_rank_crowd")),
                          ("BOiLS", ("ssk_cross", "ssk_self")),
                          ("Casmopolitan", ("matern32_gram", "matern32_gram_vjp")),
                          ("BODi", ("matern32_gram", "matern32_gram_vjp")),
                          ("CoCaBO", ("matern32_gram", "matern32_gram_vjp"))):
        for k in kernels + ("chol_factor", "chol_winv"):
            if not all(launched(r, k) > 0 for r in rows[name]["launches_per_suggest"]):
                fails.append(f"phase i {name}: a suggest launched no {k}")
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    print("phase i shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


def check_path_shapes(torch, gram, ssk, ck, pareto, shapes, dev, fails):
    """Every distinct shape at which a path launched a kernel, on random
    inputs, against the plain version at the tolerances of the timed
    checks: K2 and its VJP, K1a, K1b and the fused call on SPD matrices
    (the fused call also bit for bit against K1a then K1b), K5 bit for bit on
    tied inputs (``pareto_agrees``), K3 on codes over 5 letters."""
    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {}
    for B, N, M, D in shapes["matern32_gram"]:
        a, b = (torch.randn((B, n, D), generator=gen, device=dev) for n in (N, M))
        sc = torch.rand((B,), generator=gen, device=dev) + 0.5
        e = (gram.matern32_gram(a, b, sc) - gram.matern32_gram_plain(a, b, sc)).abs().max().item()
        errs[f"matern32_gram {(B, N, M, D)}"] = e
        if not e <= GRAM_TOL:
            fails.append(f"matern32_gram at the path's {(B, N, M, D)}: max abs err {e}")
    for B, N, M, D in shapes["matern32_gram_vjp"]:
        a, b = (torch.randn((B, n, D), generator=gen, device=dev) for n in (N, M))
        sc = torch.rand((B,), generator=gen, device=dev) + 0.5
        g = torch.randn((B, N, M), generator=gen, device=dev)
        got, want = gram.matern32_gram_vjp(a, b, sc, g), gram.matern32_gram_vjp_plain(a, b, sc, g)
        e = max(((u - v).abs().max() / v.abs().max()).item() for u, v in zip(got, want))
        errs[f"matern32_gram_vjp {(B, N, M, D)}"] = e
        if not e <= VJP_TOL:
            fails.append(f"matern32_gram_vjp at the path's {(B, N, M, D)}: error over max {e}")
        if not all(torch.equal(u, v) for u, v in zip(got, gram.matern32_gram_vjp(a, b, sc, g))):
            fails.append(f"matern32_gram_vjp at the path's {(B, N, M, D)}: a second launch gave other bits")
    # K1b's dims are the padded size, which pads to itself
    for name, (B, N) in [("chol_factor", sh) for sh in shapes["chol_factor"]] + \
            [("chol_winv", sh) for sh in shapes["chol_winv"]]:
        K = spd(torch, B, N, dev, gen)
        L, Wd = ck.chol_factor(K)
        if name == "chol_factor":
            L0, Wd0 = ck.chol_factor_plain(K)
            e, tol = max((L - L0).abs().max().item(), (Wd - Wd0).abs().max().item()), L_TOL
        else:
            e, tol = (ck.chol_winv(L, Wd) - ck.chol_winv_plain(L, Wd)).abs().max().item(), W_TOL
        errs[f"{name} {(B, N)}"] = e
        if not e <= tol:
            fails.append(f"{name} at the path's {(B, N)}: max abs err {e}")
    for B, N in shapes.get("chol_factor_inv", ()):
        K = spd(torch, B, N, dev, gen)
        got = ck.chol_factor_inv(K)
        L0, Wd0 = ck.chol_factor_plain(K)
        W0 = ck.chol_winv_plain(L0, Wd0)
        e = [(got[0] - L0).abs().max().item(), (got[1] - Wd0).abs().max().item(),
             (got[2] - W0).abs().max().item()]
        L, Wd = ck.chol_factor(K)
        pair = torch.equal(got[0], L) and torch.equal(got[1], Wd) and torch.equal(got[2], ck.chol_winv(L, Wd))
        errs[f"chol_factor_inv {(B, N)}"] = max(e)
        if not (max(e[:2]) <= L_TOL and e[2] <= W_TOL and pair):
            fails.append(f"chol_factor_inv at the path's {(B, N)}: max abs errs {e}, the pair's bits {pair}")
    for P, M in shapes["nsga2_rank_crowd"]:
        n = len(fails)
        pareto_agrees(torch, pareto, P, M, dev, fails, " at the path's shape")
        errs[f"nsga2_rank_crowd {(P, M)}"] = "same bits" if len(fails) == n else "differ"
    rel = lambda x, y: ((x - y).abs() / y.abs().clamp(min=1e-6)).max().item()
    rng = np.random.default_rng(7)
    cases = [(B, N, M, L, P, True) for B, N, M, L, P in shapes["ssk_cross"]]
    cases += [(B, N, 0, L, P, False) for B, N, L, P in shapes["ssk_self"]]
    for B, N, M, L, P, cross in cases:
        s1 = torch.as_tensor(rng.integers(0, 5, (N, L)), dtype=torch.int32, device=dev)
        s2 = torch.as_tensor(rng.integers(0, 5, (max(M, 1), L)), dtype=torch.int32, device=dev)
        lam2 = torch.as_tensor(rng.uniform(0.2, 0.8, B), dtype=torch.float32, device=dev)
        gap = torch.as_tensor(rng.uniform(0.2, 0.9, B), dtype=torch.float32, device=dev)
        launch = (lambda: ssk.ssk_cross(s1, s2, lam2, gap, P)) if cross else (lambda: ssk.ssk_self(s1, lam2, gap, P))
        got = launch()
        want = (ssk.ssk_cross_plain(s1, s2, lam2, gap, P) if cross
                else ssk.ssk_self_plain(s1, lam2, gap, P))
        e = [rel(x, y) for x, y in zip(got, want)]
        key = f"ssk_{'cross' if cross else 'self'} {(B, N, M, L, P) if cross else (B, N, L, P)}"
        errs[key] = max(e)
        r = ssk.route(L, P, B * N * max(M, 1))
        if not (e[0] <= SSK_RAW_TOL and max(e[1:]) <= SSK_TAN_TOL):
            fails.append(f"{key} at the path's shape ({r} route): max rel errs {e}")
        if not all(torch.equal(x, y) for x, y in zip(got, launch())):
            fails.append(f"{key} at the path's shape ({r} route): a second launch gave other bits")
    print(f"path shapes against their plain versions ({len(errs)} shapes):", json.dumps(errs), flush=True)
    return errs


# ---------------------------------------------------------------- phase j
def zdt1(df):
    """ZDT1 (Zitzler, Deb & Thiele 2000): 30 variables in [0, 1], two
    objectives f1 = x1, f2 = g (1 − √(f1 / g)), g = 1 + 9 Σ_{i≥2} x_i / 29."""
    X = df[[f"x{i}" for i in range(30)]].values.astype(float)
    g = 1.0 + 9.0 * X[:, 1:].sum(1) / 29.0
    return np.stack([X[:, 0], g * (1.0 - np.sqrt(X[:, 0] / g))], 1)


def bnh(df):
    """BNH (Binh & Korn 1997): x1 ∈ [0, 5], x2 ∈ [0, 3]; objectives 4x1² +
    4x2² and (x1 − 5)² + (x2 − 5)²; constraints (x1 − 5)² + x2² ≤ 25 and
    (x1 − 8)² + (x2 + 3)² ≥ 7.7, fed as outputs feasible below 0."""
    x1, x2 = df["x1"].values.astype(float), df["x2"].values.astype(float)
    return np.stack([4 * x1 ** 2 + 4 * x2 ** 2, (x1 - 5) ** 2 + (x2 - 5) ** 2,
                     (x1 - 5) ** 2 + x2 ** 2 - 25.0, 7.7 - (x1 - 8) ** 2 - (x2 + 3) ** 2], 1)


_H6_A = np.array([[10, 3, 17, 3.5, 1.7, 8], [0.05, 10, 17, 0.1, 8, 14],
                  [3, 3.5, 1.7, 10, 17, 8], [17, 8, 0.05, 10, 0.1, 14]])
_H6_P = 1e-4 * np.array([[1312, 1696, 5569, 124, 8283, 5886], [2329, 4135, 8307, 3736, 1004, 9991],
                         [2348, 1451, 3522, 2883, 3047, 6650], [4047, 8828, 8732, 5743, 1091, 381]])
_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])


def hartmann6(df):
    """Hartmann-6 on [0, 1]⁶ (minimum −3.32237)."""
    X = df[[f"x{i}" for i in range(6)]].values.astype(float)
    inner = (_H6_A[None] * (X[:, None, :] - _H6_P[None]) ** 2).sum(-1)
    return -(_H6_ALPHA[None] * np.exp(-inner)).sum(1, keepdims=True)


def unit_space(DesignSpace, names, lb=0.0, ub=1.0):
    return DesignSpace([{"name": n, "type": "num", "lb": lb, "ub": ub} for n in names])


def check_rec(space, rec, n, what, fails, hist=None):
    """``rec`` has n rows, finite and inside the space; with ``hist`` (the
    history's opt-frame rows) every row is new."""
    X = space.transform(rec)
    ok = (len(rec) == n and np.isfinite(X).all() and (X >= space.opt_lb).all()
          and (X <= space.opt_ub).all())
    if not ok:
        fails.append(f"{what}: suggestion not finite / outside the space / not {n} rows")
    if hist is not None:
        seen = {tuple(np.round(r, 6)) for r in hist}
        if any(tuple(np.round(r, 6)) in seen for r in X):
            fails.append(f"{what}: suggestion repeats an observation")


class Suggests:
    """Times ``suggest`` calls and records each one's launches per kernel."""

    def __init__(self, torch, wrappers):
        self.torch, self.wrappers = torch, wrappers

    def __call__(self, opt, n, log, **kw):
        before = {k: w.launches for k, w in self.wrappers.items()}
        t0 = time.time()
        rec = opt.suggest(n, **kw) if n is not None else opt.suggest()
        self.torch.cuda.synchronize()
        log.setdefault("s_per_suggest", []).append(time.time() - t0)
        log.setdefault("launches_per_suggest", []).append(
            {k: w.launches - before[k] for k, w in self.wrappers.items() if w.launches > before[k]})
        return rec


def warm(opt, space, f, n, seed=1):
    X = space.inverse_transform(space.sobol_sample_opt(n, seed=seed))
    opt.observe(X, f(X))
    return X


def timers(opt, k):
    return {"fit_s": opt.fit_time[-k:], "acq_s": opt.acq_time[-k:]}


class SVMStandIn:
    """Bayesmark's SVM api_config with a smooth stand-in for the SVM ×
    breast CV loss (minimum 0.03 at C = 10^1.5, γ = 10^-3, tol = 10^-3;
    γ matters most, as for an RBF SVM), for a machine without sklearn."""

    def __init__(self, api_config):
        self.api_config = api_config

    def __call__(self, df):
        c, g, t = (np.log10(df[k].values.astype(float)) for k in ("C", "gamma", "tol"))
        loss = 0.03 + 0.01 * (c - 1.5) ** 2 + 0.08 * (g + 3.0) ** 2 + 0.002 * (t + 3.0) ** 2
        return loss.reshape(-1, 1)


def svm_breast(BayesmarkTask):
    """Phase j4's task: ``BayesmarkTask("SVM", "breast")`` (sklearn's
    cross-validation on the host), or, where sklearn is not installed,
    ``SVMStandIn`` over the same api_config; and which one it is."""
    from hebo_tpu_torch.tasks.bayesmark import BAYESMARK_API_CONFIGS

    try:
        import sklearn  # noqa: F401
    except ImportError:
        return SVMStandIn(BAYESMARK_API_CONFIGS["SVM"]), "stand-in (sklearn not installed)"
    return BayesmarkTask("SVM", "breast"), "SVM x breast CV loss"


def family_phase(torch, DesignSpace, wrappers, fails):
    """Phase j: the optimizer family at its defaults, on the card; returns
    the per-optimizer rows and the shapes the kernels were launched at."""
    from hebo_tpu_torch.optimizers import (BO, CMAES, MACEBO, Evolution, GeneralBO, NoisyOpt,
                                           NoMR_BO, SafeOpt, SubDomainBO)
    from hebo_tpu_torch.tasks import BayesmarkTask

    rows, sug, shapes = {}, Suggests(torch, wrappers), ShapeLog()
    ack = unit_space(DesignSpace, [f"x{i}" for i in range(6)], -32.768, 32.768)
    try:
        # (j1) BO, NoisyOpt, NoMR_BO on Ackley-6D at 200 warm observations
        for name, make, n in (("BO", lambda: BO(ack, device="cuda"), 1),
                              ("NoisyOpt", lambda: NoisyOpt(ack, device="cuda"), 8)):
            opt, log = make(), {}
            warm(opt, ack, ackley, 200)
            for _ in range(2):
                rec = sug(opt, n, log)
                check_rec(ack, rec, n, f"phase j {name}", fails,
                          hist=ack.transform(opt.X) if name == "NoisyOpt" else None)
                opt.observe(rec, ackley(rec))
            if name == "NoisyOpt":
                log["graphs"] = sorted(k[0] for k in opt._graphs)
                graph_vs_eager(torch, opt, "phase j NoisyOpt", fails)
            rows[name] = dict(log, **timers(opt, 2), n_obs=opt.num_obs, best=opt.best_y)
            print(f"phase j {name}:", json.dumps(rows[name]), flush=True)

        Xw = ack.sobol_sample_opt(200, seed=1)
        yw = ackley(ack.inverse_transform(Xw))[:, 0]
        order = np.argsort(yw)
        eta = 0.5 * (yw[order[0]] + yw[order[1]])
        opt, log = NoMR_BO(ack, eta=float(eta), device="cuda"), {"stage": []}
        rest = np.delete(np.arange(200), order[0])
        opt.observe(ack.inverse_transform(Xw[rest]), yw[rest, None])
        for i in range(2):
            log["stage"].append("exploit (BO)" if opt.exploiting else "explore (HEBO)")
            rec = sug(opt, 1, log)
            check_rec(ack, rec, 1, "phase j NoMR_BO", fails)
            opt.observe(rec, ackley(rec))
            if i == 0:  # the held-back best warm point
                opt.observe(ack.inverse_transform(Xw[order[:1]]), yw[order[:1], None])
        if log["stage"] != ["explore (HEBO)", "exploit (BO)"]:
            fails.append(f"phase j NoMR_BO: stages {log['stage']}, expected HEBO then BO")
        rows["NoMR_BO"] = dict(log, eta=float(eta), n_obs=opt.num_obs, best=opt.best_y)
        print("phase j NoMR_BO:", json.dumps(rows["NoMR_BO"]), flush=True)

        # (j2) GeneralBO: ZDT1 (30 variables, 2 objectives), BNH (2 + 2 constraints)
        zsp = unit_space(DesignSpace, [f"x{i}" for i in range(30)])
        bsp = DesignSpace([{"name": "x1", "type": "num", "lb": 0.0, "ub": 5.0},
                           {"name": "x2", "type": "num", "lb": 0.0, "ub": 3.0}])
        for name, space, f, n_constr in (("GeneralBO ZDT1", zsp, zdt1, 0),
                                         ("GeneralBO BNH", bsp, bnh, 2)):
            opt, log = GeneralBO(space, num_obj=2, num_constr=n_constr, device="cuda"), {}
            warm(opt, space, f, 200)
            for _ in range(2):
                rec = sug(opt, 4, log)
                check_rec(space, rec, 4, f"phase j {name}", fails)
                if len({tuple(r) for r in space.transform(rec)}) != 4:
                    fails.append(f"phase j {name}: the 4 EHVI picks are not distinct")
                opt.observe(rec, f(rec))
            _, Ypf = opt.get_pf()
            dom = ((Ypf[:, None] <= Ypf[None]).all(-1) & (Ypf[:, None] < Ypf[None]).any(-1))
            if len(Ypf) == 0 or dom.any():
                fails.append(f"phase j {name}: get_pf's front is empty or dominated")
            rows[name] = dict(log, **timers(opt, 2), ehvi_s=opt.ehvi_time[-2:], n_obs=opt.num_obs,
                              front=len(Ypf), gps=len(opt.model.models))
            print(f"phase j {name}:", json.dumps(rows[name]), flush=True)

        # (j3) SubDomainBO (tr, ascent) and SafeOpt on Hartmann-6, 60 warm observations
        hsp = unit_space(DesignSpace, [f"x{i}" for i in range(6)])
        for mode in ("tr", "ascent"):
            opt, log = SubDomainBO(hsp, mode=mode, device="cuda"), {}
            warm(opt, hsp, hartmann6, 60)
            for _ in range(2):
                rec = sug(opt, 1, log)
                check_rec(hsp, rec, 1, f"phase j SubDomainBO {mode}", fails)
                opt.observe(rec, hartmann6(rec))
            rows[f"SubDomainBO {mode}"] = dict(log, **timers(opt, 2), n_obs=opt.num_obs,
                                               best=opt.best_y)
            print(f"phase j SubDomainBO {mode}:", json.dumps(rows[f"SubDomainBO {mode}"]), flush=True)
        query_vjp = [s for s in shapes.seen["matern32_gram_vjp"] if s[1] != s[2]]
        if not query_vjp:
            fails.append("phase j SubDomainBO: K2's VJP never launched at a query shape")
        Xh = hsp.inverse_transform(hsp.sobol_sample_opt(60, seed=1))
        h = float(np.median(hartmann6(Xh)))
        opt, log = SafeOpt(hsp, safety_threshold=h, device="cuda"), {"unsafe": 0, "incumbent": 0}
        opt.observe(Xh, hartmann6(Xh))
        for _ in range(2):
            rec = sug(opt, 4, log)
            check_rec(hsp, rec, 4, "phase j SafeOpt", fails)
            y = hartmann6(rec)[:, 0]
            inc = hsp.transform(opt.X.iloc[[int(np.argmin(opt.y[:, 0]))]])[0]
            is_inc = np.all(np.isclose(hsp.transform(rec), inc[None]), 1)
            log["unsafe"] += int(((y > h) & ~is_inc).sum())
            log["incumbent"] += int(is_inc.sum())
            opt.observe(rec, y[:, None])
        if log["unsafe"]:
            fails.append(f"phase j SafeOpt: {log['unsafe']} suggestions above the threshold {h}")
        rows["SafeOpt"] = dict(log, **timers(opt, 2), threshold=h, n_obs=opt.num_obs)
        print("phase j SafeOpt:", json.dumps(rows["SafeOpt"]), flush=True)

        # (j4) MACEBO on Bayesmark SVM x breast, batch 8; CMAES and Evolution
        task, kind = svm_breast(BayesmarkTask)
        opt, log, best = MACEBO(task.api_config, device="cuda"), {"objective": kind}, []
        for r in range(4):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.time()
            guesses = opt.suggest(8)
            torch.cuda.synchronize()
            log.setdefault("s_per_suggest", []).append(time.time() - t0)
            log.setdefault("launches_per_suggest", []).append(
                {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]})
            losses = task(pd.DataFrame(guesses))[:, 0]
            inside = all(c["range"][0] <= g[k] <= c["range"][1]
                         for g in guesses for k, c in task.api_config.items())
            if not (len(guesses) == 8 and inside and np.isfinite(losses).all()):
                fails.append(f"phase j MACEBO round {r}: guesses outside the api_config or "
                             "losses not finite")
            best.append(float(losses.min()))
            opt.observe(guesses, losses)
        if not min(best[1:]) <= best[0]:
            fails.append(f"phase j MACEBO: the model rounds' best {min(best[1:])} is worse than "
                         f"the Sobol round's {best[0]}")
        rows["MACEBO"] = dict(log, round_best=best, best=opt.best_y,
                              improved=bool(min(best[1:]) < best[0]))
        print("phase j MACEBO (Bayesmark SVM api_config, batch 8):", json.dumps(rows["MACEBO"]), flush=True)

        for name, opt in (("CMAES", CMAES(ack, device="cuda")),
                          ("Evolution", Evolution(ack, pop=100, device="cuda"))):
            log = {}
            for _ in range(3):
                rec = sug(opt, None, log)
                check_rec(ack, rec, opt.lam if name == "CMAES" else 100, f"phase j {name}", fails)
                opt.observe(rec, ackley(rec))
            rows[name] = dict(log, n_obs=opt.num_obs, best=opt.best_y)
            print(f"phase j {name}:", json.dumps(rows[name]), flush=True)
    finally:
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    for what, kernel, shape in (("K2 at D = 30", "matern32_gram", lambda s: s[3] == 30),
                                ("K2 at D = 2", "matern32_gram", lambda s: s[3] == 2),
                                ("K5 at M = 4", "nsga2_rank_crowd", lambda s: s[1] == 4),
                                ("K5 at M = 2", "nsga2_rank_crowd", lambda s: s[1] == 2),
                                ("K5 at (200, 1)", "nsga2_rank_crowd", lambda s: s == (200, 1))):
        if not any(shape(s) for s in shapes.seen[kernel]):
            fails.append(f"phase j: {what} never launched")
    print("phase j shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen, query_vjp=query_vjp)


# ---------------------------------------------------------------- phase k
def variants_phase(torch, HEBO, DesignSpace, wrappers, fails):
    """Phase k: the GP variants through ``HEBO(space, model_name=m,
    device="cuda")`` on Ackley-6D at their defaults, batch 8 (the generic
    route: ``model.fit``, ``EvolutionOpt``): ``dkl`` and ``uncertain_gp``
    at 800 warm Sobol observations (bucket 1024), ``svgp`` at 3000 (bucket
    3072), 2 × suggest(8) each; then ``CompositionalAcqOptimizer`` once per
    method on a GP fitted at 200 observations (16 starts × 64 steps, 32
    draws).  Returns the rows and the shapes the kernels were called at."""
    from hebo_tpu_torch.acq_optimizers.compositional import CompositionalAcqOptimizer
    from hebo_tpu_torch.acquisitions.acq import AcqParams
    from hebo_tpu_torch.models import get_model

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    rows, sug, shapes = {}, Suggests(torch, wrappers), ShapeLog()
    need = {"dkl": ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "nsga2_rank_crowd"),
            "uncertain_gp": ("chol_factor", "chol_winv", "nsga2_rank_crowd"),
            "svgp": ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "nsga2_rank_crowd")}
    try:
        for name, n_obs in (("dkl", 800), ("uncertain_gp", 800), ("svgp", 3000)):
            opt = HEBO(space, model_name=name, device="cuda")
            warm(opt, space, ackley, n_obs)
            log = {}
            for _ in range(2):
                rec = sug(opt, 8, log)
                check_rec(space, rec, 8, f"phase k {name}", fails, hist=space.transform(opt.X))
                opt.observe(rec, ackley(rec))
            rows[name] = dict(log, **timers(opt, 2), n_obs=opt.num_obs, model=type(opt.model).__name__,
                              bucket=int(opt.model.data.X.shape[0]), best=opt.best_y)
            if opt._graphs:
                fails.append(f"phase k {name}: a suggest took the fused graph")
            for k in need[name]:
                if not all(launched(r, k) > 0 for r in log["launches_per_suggest"]):
                    fails.append(f"phase k {name}: a suggest launched no {k}")
            print(f"phase k {name}:", json.dumps(rows[name]), flush=True)
        X = space.sobol_sample_opt(200, seed=2)
        y = ackley(space.inverse_transform(X))
        gp = get_model("gp", space, device="cuda").fit(X, y)
        for method in ("cadam", "scgd", "ascgd", "nasa", "adam"):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.time()
            rec = CompositionalAcqOptimizer(space, method=method).optimize(
                gp, None, AcqParams(tau=float(y.min())), n_suggestions=2, seed=0, x_observed=X)
            torch.cuda.synchronize()
            launches = {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]}
            rows[f"compbo {method}"] = dict(s=time.time() - t0, launches=launches)
            check_rec(space, space.inverse_transform(rec), 2, f"phase k compbo {method}", fails)
            if not launches.get("matern32_gram_vjp"):
                fails.append(f"phase k compbo {method}: no K2 VJP launch in the query points")
            print(f"phase k compbo {method}:", json.dumps(rows[f"compbo {method}"]), flush=True)
    finally:
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    for what, kernel, shape in (("K1 at (1, 32)", "chol_factor", lambda s: s == (1, 32)),
                                ("K2 at (1, 32, 3072, 6)", "matern32_gram", lambda s: s == (1, 32, 3072, 6)),
                                ("K2's VJP at D = 8", "matern32_gram_vjp", lambda s: s[3] == 8)):
        if not any(shape(s) for s in shapes.seen[kernel]):
            fails.append(f"phase k: {what} never launched")
    print("phase k shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


# ---------------------------------------------------------------- phase l
FAMILY_MODELS = ("deep_ensemble", "mcbn", "conditional_deep_ensemble", "gbdt", "nap")


def model_families_phase(torch, HEBO, DesignSpace, wrappers, fails):
    """Phase l: the other surrogate families at their defaults.  HEBO on
    Ackley-6D, batch 8, the generic route, 800 warm Sobol observations
    (phase k's setting), 2 × suggest(8) for each of ``FAMILY_MODELS``
    (``catboost`` builds the same ``GBDT`` and is checked, not run twice;
    NAP meta-trains 300 steps in its first suggest, K1 at (16, 32)); then
    ``gumbel`` fitted on the same 800 points, and ``eac`` with each cell on
    phase i's pest control space (25 stations × 5 choices) at 200 random
    points.  ``rf`` is not run: the card's machine has no sklearn.  Returns
    the rows and the shapes the kernels were launched at."""
    import hebo_tpu_torch.meta  # noqa: F401  (registers "nap")
    from hebo_tpu_torch.bench.profile_suggest import K1Batches
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.boosting import GBDT
    from hebo_tpu_torch.tasks import PestControlTask

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    rows, sug, shapes, k1 = {}, Suggests(torch, wrappers), ShapeLog(), K1Batches()
    print("phase l rf: skipped, the card's machine has no sklearn (the model imports it in fit)",
          flush=True)
    try:
        for name in FAMILY_MODELS:
            opt = HEBO(space, model_name=name, device="cuda")
            warm(opt, space, ackley, 800)
            log, batches = {}, []
            for _ in range(2):
                k1.take()
                rec = sug(opt, 8, log)
                batches.append(k1.take())
                check_rec(space, rec, 8, f"phase l {name}", fails, hist=space.transform(opt.X))
                opt.observe(rec, ackley(rec))
            model = opt.model
            mu, var = model.predict(space.transform(opt.X))
            if not (np.isfinite(mu).all() and np.isfinite(var).all() and (var > 0).all()):
                fails.append(f"phase l {name}: predict on the training points not finite / σ² ≤ 0")
            meta_s = getattr(model, "meta_train_s", None)
            rows[name] = dict(log, **timers(opt, 2), k1_calls_by_batch=batches, n_obs=opt.num_obs,
                              model=type(model).__name__, best=opt.best_y,
                              **({"meta_train_s": meta_s} if meta_s is not None else {}))
            if opt._graphs:
                fails.append(f"phase l {name}: a suggest took the fused graph")
            if not all(r.get("nsga2_rank_crowd", 0) > 0 for r in log["launches_per_suggest"]):
                fails.append(f"phase l {name}: a suggest launched no nsga2_rank_crowd")
            print(f"phase l {name}:", json.dumps(rows[name]), flush=True)
        if not rows["nap"]["k1_calls_by_batch"][0].get("16x32", 0) >= 300:
            fails.append(f"phase l nap: K1 did not factor at (16, 32) in each of the 300 "
                         f"meta-training steps: {rows['nap']['k1_calls_by_batch']}")
        if not isinstance(get_model("catboost", space, device="cuda"), GBDT):
            fails.append("phase l: catboost does not build a GBDT")

        X = space.sobol_sample_opt(800, seed=1)
        y = ackley(space.inverse_transform(X))
        t0 = time.time()
        m = get_model("gumbel", space, device="cuda").fit(X, y)
        mu, var = m.predict(X)
        imp = m.feature_importance()
        row = dict(fit_predict_s=time.time() - t0, importance=imp.tolist())
        try:
            m.sample_f(2)(X[:8])
            row["sample_f"] = "returned"
            fails.append("phase l gumbel: sample_f returned; the JAX package raises AttributeError")
        except AttributeError as e:  # the JAX package's own: inherited, reads params.w
            row["sample_f"] = f"AttributeError: {e} (as in the JAX package)"
        if not (np.isfinite(mu).all() and (var > 0).all() and imp.shape == (6,)
                and ((imp >= 0) & (imp <= 1)).all()):
            fails.append(f"phase l gumbel: predict / feature_importance off: {row}")
        rows["gumbel"] = row
        print("phase l gumbel (800 Ackley-6D points):", json.dumps(row), flush=True)

        pest = PestControlTask(n_stations=25)
        Xp = pest.space.sample(200, seed=1)
        Xo, yp = pest.space.transform(Xp), pest(Xp)
        for cell in ("mlp", "rnn", "transformer"):
            t0 = time.time()
            m = get_model("eac", pest.space, cell=cell, device="cuda").fit(Xo, yp)
            torch.cuda.synchronize()
            fit_s = time.time() - t0
            mu, var = m.predict(Xo)
            draws = m.sample_f(2)(Xo[:8])
            row = dict(fit_s=fit_s, rmse=float(np.sqrt(np.mean((mu - yp) ** 2))),
                       y_sd=float(yp.std()))
            if not (np.isfinite(mu).all() and (var > 0).all() and draws.shape == (2, 8, 1)
                    and np.isfinite(draws).all()):
                fails.append(f"phase l eac {cell}: predict / sample_f off: {row}")
            rows[f"eac {cell}"] = row
            print(f"phase l eac {cell} (pest control 25 x 5, 200 points):", json.dumps(row), flush=True)
    finally:
        shapes.close()
        k1.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    for what, kernel, shape in (("K1 at (16, 32)", "chol_factor", lambda s: s == (16, 32)),
                                ("K5 at (200, 3)", "nsga2_rank_crowd", lambda s: s == (200, 3))):
        if not any(shape(s) for s in shapes.seen[kernel]):
            fails.append(f"phase l: {what} never launched")
    print("phase l shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


# ---------------------------------------------------------------- phase m
class StepClock(list):
    """``ppo_train``'s ``trace``: keeps each Adam step's record and the
    time (card synchronized) at which it came."""

    def __init__(self, torch):
        super().__init__()
        self.torch, self.t = torch, []

    def append(self, item):
        self.torch.cuda.synchronize()
        self.t.append(time.time())
        super().append(item)


def rel_fro(torch, a, b):
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def mesh_phase(torch, HEBO, DesignSpace, GP, wrappers, fails, mesh):
    """Phase m: the mesh paths through their entry points, on ``mesh`` (one
    NCCL rank per card; every rank runs this).  m1 ``HEBO(mesh=...)`` at
    full defaults on Ackley-6D, 800 warm observations, 3 × suggest(8)
    (eager); m2 ``GP(mesh=...)`` at 3000 observations (the block-sharded
    posterior at bucket 3072); m3 ``GP(mesh=..., inference="hmc" | "smc")``
    at 800; m4 ``ppo_train(mesh=...)`` at its defaults for 3 iterations.
    The path runs first and its launches are read at its end; then m2's
    factor and prediction are held against K1's dense ladder, and m3's
    sharded samplers against the unsharded ones on the same draws, so these
    comparisons add to no count.  Returns the rows, the path's launches and
    the shapes the kernels were launched at."""
    from hebo_tpu_torch.meta.ppo import NAPPolicy, ppo_train
    from hebo_tpu_torch.models.gp.inference import (HMCDraws, _value_and_grad, hmc_sample,
                                                    hmc_sample_sharded, smc_sample,
                                                    smc_sample_sharded)
    from hebo_tpu_torch.models.gp.tree import Flat, tree_leaves, tree_map
    from hebo_tpu_torch.ops.block_chol import block_ladder_factor
    from hebo_tpu_torch.ops.chol import LADDER, batched_ladder_factor
    from hebo_tpu_torch.ops.gram import matern32_gram_vjp, tile_rows
    from hebo_tpu_torch.parallel.sharded import mesh_rank, mesh_size

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    world = mesh_size(mesh)
    leaf_diff = lambda a, b: max((x - y).abs().max().item()  # noqa: E731
                                 for x, y in zip(tree_leaves(a), tree_leaves(b)) if x.numel())
    rows, sug, shapes = {"world": world}, Suggests(torch, wrappers), ShapeLog()
    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731
    try:
        # (m1) HEBO on the mesh: per suggest the fit's 51 NLL ladders of 2
        # rungs and the cache's 5 (K1a, K1b), 50 VJPs, 100 generations of 2
        # K5 launches, and K2 51 + 1 + 1 + 110 + 1 (fit, cache, incumbent,
        # 10 island rounds of 1 + 10 evaluations, the population)
        opt = HEBO(space, mesh=mesh, device="cuda")
        warm(opt, space, ackley, 800)
        log = {}
        for _ in range(3):
            rec = sug(opt, 8, log)
            check_rec(space, rec, 8, "phase m1", fails, hist=space.transform(opt.X))
            opt.observe(rec, ackley(rec))
        steps = opt.model_config["num_epochs"]
        expect = {"matern32_gram_vjp": steps, "nsga2_rank_crowd": 2 * opt.iters,
                  **k1_expect((steps + 1) * 2 + 5, 1024),
                  "matern32_gram": steps + 4 + opt.iters + opt.iters // opt.migrate_every}
        for got in log["launches_per_suggest"]:
            for k, want in expect.items():
                if got.get(k) != want:
                    fails.append(f"phase m1: {k} launched {got.get(k)} times in a suggest, "
                                 f"expected {want}")
        init_best = float(opt.y[:opt.rand_sample, 0].min())
        if not opt.best_y < init_best:
            fails.append(f"phase m1: best {opt.best_y} does not beat the init phase's {init_best}")
        if opt._graphs or not bool(opt.model.caches.ok.all()):
            fails.append("phase m1: a suggest took the single-card graph or its factor failed")
        rows["m1"] = dict(log, **timers(opt, 3), route="eager (no CUDA graph)", world=world,
                          n_obs=opt.num_obs, bucket=int(opt.model.data.X.shape[0]),
                          pop=opt.pop, islands=world, init_best=init_best, best=opt.best_y)
        print("phase m1 (HEBO(mesh), Ackley-6D b8, 800 warm obs, bucket 1024):",
              json.dumps(rows["m1"]), flush=True)

        # (m2) GP(mesh) above max_cholesky_size: phase e's 3000 observations;
        # the cache's block factor is the fit's only K1a launch at (1, 128)
        # and K1b at (1, 3072) (the hyperparameters are fitted at 2048)
        X = space.sobol_sample_opt(3000, seed=1)
        y = ackley(space.inverse_transform(X))
        gp2 = GP(space, device="cuda", mesh=mesh)
        c0 = collections.Counter(shapes.count)
        t0 = time.time()
        gp2.fit(X, y)
        torch.cuda.synchronize()
        fit_s, by_shape = time.time() - t0, shapes.count - c0
        m2 = dict(fit_s=fit_s, bucket=int(gp2.data.X.shape[0]),
                  fit_bucket=int(gp2.fit_data.X.shape[0]), ok=gp2.caches.ok.tolist(),
                  launches_per_factorization={f"{k} {list(sh)}": by_shape[k, sh] for k, sh in (
                      ("chol_factor", (1, 128)), ("chol_winv", (1, 128)),
                      ("chol_winv", (1, 3072)))})
        Xq = space.sobol_sample_opt(128, seed=5)
        mu_b, var_b = gp2.predict(Xq)

        # (m3) the samplers on the mesh at 800 observations (phase g's shapes)
        X = space.sobol_sample_opt(800, seed=1)
        y = ackley(space.inverse_transform(X))
        gps = {}
        for inf in ("hmc", "smc"):
            gp = GP(space, device="cuda", mesh=mesh, inference=inf)
            t0 = time.time()
            gp.fit(X, y)
            torch.cuda.synchronize()
            gps[inf] = gp
            rows[f"m3 {inf}"] = dict(fit_s=time.time() - t0, bucket=int(gp.data.X.shape[0]),
                                     samples=list(gp.samples.log_sc.shape),
                                     ok=gp.caches.ok.tolist())

        # (m4) data-parallel PPO at its defaults; its first iteration apart
        # from the next two, whose time does not depend on what ran before
        policy = NAPPolicy(dim_x=2, d_model=64, n_heads=4, n_layers=2, generator=gen(0),
                           device="cuda")
        p0 = {k: v.detach().clone() for k, v in policy.named_parameters()}
        trace, before = StepClock(torch), {k: w.launches for k, w in wrappers.items()}
        t0 = time.time()
        params, regrets = ppo_train(policy, seed=0, n_iters=3, mesh=mesh, axis="pop", trace=trace)
        torch.cuda.synchronize()
        losses = [float(loss) for loss, _ in trace]
        moved = max((params[k] - p0[k]).abs().max().item() for k in p0)
        ends = trace.t[len(trace) // 3 - 1::len(trace) // 3]  # each iteration's last Adam step
        m4 = dict(s_per_iter=(ends[-1] - ends[0]) / 2, first_iter_s=ends[0] - t0,
                  mean_regret=regrets.tolist(), losses=losses, max_param_move=moved,
                  launches={k: w.launches - before[k] for k, w in wrappers.items()
                            if w.launches > before[k]})

        # the path ends here: its launches, and the shapes it launched at
        path_launches = {k: w.launches for k, w in wrappers.items()}
        path_seen = {k: set(v) for k, v in shapes.seen.items()}

        if not (np.isfinite(losses).all() and moved > 0 and launched(m4["launches"], "chol_factor")):
            fails.append(f"phase m4: PPO's loss not finite, params unmoved or no K1 launch: {m4}")

        # m2's block factor and prediction against K1's dense ladder
        gp = gp2
        Kt, _ = gp.core._train_system(gp.samples, gp.data)
        L, W, ok = block_ladder_factor(Kt[0], mesh)
        m2["block_ms"] = cuda_ms(torch, lambda: block_ladder_factor(Kt[0], mesh), 2)
        m2["dense_ms"] = cuda_ms(torch, lambda: batched_ladder_factor(Kt, LADDER), 2)
        Ld, Wd, okd = batched_ladder_factor(Kt, LADDER)
        dense = type(gp.core).__new__(type(gp.core))
        dense.__dict__.update(gp.core.__dict__, mesh=None, max_cholesky_size=4096)
        caches = dense.posterior_cache_batched(gp.samples, gp.data)
        mu_d, var_d = gp.predict_pure((gp.samples, caches, gp.data),
                                      torch.as_tensor(Xq, dtype=torch.float32, device="cuda"))
        mu_d, var_d = mu_d.cpu().numpy(), var_d.cpu().numpy()
        prior_var = float(torch.exp(gp.samples.log_sc).max() * gp.data.y_std ** 2)
        m2.update(L_rel_fro=rel_fro(torch, L, Ld[0]), W_rel_fro=rel_fro(torch, W, Wd[0]),
                  mu_max_rel=float(np.abs(mu_b - mu_d).max() / np.abs(mu_d).max()),
                  var_max_err_over_prior=float(np.abs(var_b - var_d).max() / prior_var),
                  var_max_rel=float((np.abs(var_b - var_d) / var_d).max()))
        if not (bool(ok) and bool(okd[0]) and m2["L_rel_fro"] <= 1e-3 and m2["W_rel_fro"] <= 1e-3):
            fails.append(f"phase m2: the block factor disagrees with K1's dense ladder: {m2}")
        if not (m2["mu_max_rel"] <= 1e-3 and np.all(np.abs(var_b - var_d)
                                                     <= 1e-3 * (np.abs(var_d) + prior_var))):
            fails.append(f"phase m2: the block posterior's predictions disagree with the dense "
                         f"one's: {m2}")
        want = {"chol_factor [1, 128]": 3072 // 128, "chol_winv [1, 3072]": 1}
        if any(m2["launches_per_factorization"][k] != n for k, n in want.items()):
            fails.append(f"phase m2: the fit's factorization launched "
                         f"{m2['launches_per_factorization']}, expected {want} at block 128")
        rows["m2"] = m2
        print("phase m2 (GP(mesh), Ackley-6D, 3000 obs, bucket 3072, block 128):", json.dumps(m2),
              flush=True)

        # m3's sharded samplers against the unsharded ones on the same draws
        for inf, gp in gps.items():
            row, core, data = rows[f"m3 {inf}"], gp.core, gp.fit_data
            if inf == "smc":
                lik = lambda p: -core.nll_batched(p, data)  # noqa: E731
                parts0 = core.init_params(data, gp.n_particles, gen(5))
                a, za = smc_sample_sharded(core.log_prior, lik, parts0, gen(6), mesh)
                b, zb = smc_sample(core.log_prior, lik, parts0, gen(6))
                row["log_evidence"] = [float(za), float(zb)]
                row["max_abs_diff"] = max(float(abs(za - zb)), leaf_diff(a, b))
            else:
                # every transition's draws for all C chains (hmc_sample's
                # stream).  This rank's block runs again unsharded on its
                # rows of them, the same batch as the sharded run's; the
                # chains also run unsharded over all C, and, with no mesh,
                # the first C/4 alone: the witness of how far the batch
                # alone moves a chain (a batched matmul's rounding follows
                # the batch count, and HMC turns rounding into another
                # accept decision)
                logp = lambda p: -core.loss_batched(p, data)  # noqa: E731
                C, n_s = gp.n_chains, 4
                g0 = gen(7)
                chain0 = tree_map(lambda t: t.expand((C,) + t.shape[1:]) + 0.05 * torch.randn(
                    (C,) + t.shape[1:], generator=g0, device="cuda"), gp.params)
                g8, dim, dr = gen(8), Flat(chain0).dim, ([], [], [])
                for _ in range(gp.n_warmup + n_s):
                    dr[0].append(torch.randn((C, dim), generator=g8, device="cuda"))
                    dr[1].append(torch.rand((C,), generator=g8, device="cuda"))
                    dr[2].append(torch.randint(1, 9, (C,), generator=g8, device="cuda"))
                draws = HMCDraws(*(torch.stack(d) for d in dr))
                run = lambda r, k: hmc_sample(  # noqa: E731
                    logp, tree_map(lambda t: t[r], chain0), None, n_chains=k,
                    n_warmup=gp.n_warmup, n_samples=n_s, draws=HMCDraws(*(d[:, r] for d in draws)))[0]
                a, acc, rhat = hmc_sample_sharded(logp, chain0, None, mesh, n_chains=C,
                                                  n_warmup=gp.n_warmup, n_samples=n_s,
                                                  draws=draws)
                k = C // world
                rows_r = slice(mesh_rank(mesh) * k, (mesh_rank(mesh) + 1) * k)
                full = run(slice(0, C), C)
                b = full if k == C else run(rows_r, k)
                kw = max(1, C // 4)
                n = int(data.X.shape[0])
                # one log-density evaluation of the first kw chains, in the
                # batch of C and alone: which part differs with the batch
                first = lambda t: t[:kw]  # noqa: E731
                Kc, _ = core._train_system(chain0, data)
                Kk, _ = core._train_system(tree_map(first, chain0), data)
                Lc, Wc, _ = batched_ladder_factor(Kc, LADDER)
                Lk, Wk, _ = batched_ladder_factor(Kc[:kw].contiguous(), LADDER)
                v = Flat(chain0).ravel(chain0)
                lpc, gc = _value_and_grad(logp, Flat(chain0), v)
                lpk, gk = _value_and_grad(logp, Flat(chain0), v[:kw])
                # the backward's parts on the same inputs: the NLL's S⁻¹ =
                # WᵀW (a batched matmul) and K2's VJP
                gv = torch.randn(Kc.shape, generator=gen(9), device="cuda")
                pts = torch.rand((C, n, 6), generator=gen(10), device="cuda")
                sc = torch.ones(C, device="cuda")
                vjp = lambda m: matern32_gram_vjp(pts[:m], pts[:m], sc[:m], gv[:m])[0]  # noqa: E731
                one_eval = {w: (x[:kw] - y).abs().max().item() for w, x, y in (
                    ("gram", Kc, Kk), ("factor_L_same_input", Lc, Lk),
                    ("factor_W_same_input", Wc, Wk), ("logp", lpc, lpk), ("grad", gc, gk),
                    ("nll_backward_WtW_same_input", Wc.transpose(-1, -2) @ Wc,
                     Wc[:kw].transpose(-1, -2) @ Wc[:kw]),
                    ("k2_vjp_same_input", vjp(C), vjp(kw)))}
                row.update(rhat=float(rhat), rhat_note=f"split-R-hat over {n_s} samples of {C} "
                           "chains: printed, not a convergence test",
                           accept_rate=acc.tolist(), fit_accept_rate=gp.accept_rate.tolist(),
                           max_abs_diff=leaf_diff(tree_map(lambda t: t[:, rows_r], a), b),
                           max_abs_diff_full=leaf_diff(a, full),
                           batch_witness=dict(batch=[C, kw], tile_rows=[tile_rows(C, n, n),
                                                                        tile_rows(kw, n, n)],
                                              one_eval=one_eval,
                                              max_abs_diff=leaf_diff(
                                                  tree_map(lambda t: t[:, :kw], full),
                                                  run(slice(0, kw), kw))))
                if row["max_abs_diff_full"] > 1e-5 and row["batch_witness"]["max_abs_diff"] <= 1e-5:
                    fails.append(f"phase m3 hmc: the chains depend on the world size, but not on "
                                 f"the batch alone: the sharding is at fault: {row}")
            if not row["max_abs_diff"] <= 1e-5 or not all(row["ok"]):
                fails.append(f"phase m3 {inf}: the sharded sampler disagrees with the unsharded "
                             f"one on the same draws, or the cache failed: {row}")
            print(f"phase m3 GP(mesh, inference={inf!r}) at 800 obs:", json.dumps(row), flush=True)
        rows["m4"] = m4
        print("phase m4 (ppo_train(mesh), batch 16, 24 candidates, horizon 8, d_model 64, "
              "4 heads, 2 layers, 3 iterations; s_per_iter over iterations 2-3):",
              json.dumps(m4), flush=True)
    finally:
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    for what, kernel, shape in (("K1a at (1, 128)", "chol_factor", (1, 128)),
                                ("K1b at (1, 3072)", "chol_winv", (1, 3072)),
                                ("K1a at (16, 24)", "chol_factor", (16, 24))):
        if shape not in path_seen[kernel]:
            fails.append(f"phase m: {what} never launched on the path")
    print("phase m shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, launches=path_launches, shapes=seen)


def _mesh_rank(rank, world, store, out):
    """One rank of phase m on a machine with several cards (spawned)."""
    import os

    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(ROOT))
    from hebo_tpu_torch import HEBO, DesignSpace
    from hebo_tpu_torch.models.gp.gp import GP
    from hebo_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        wrappers, fails = kernel_wrappers(), []
        res = mesh_phase(torch, HEBO, DesignSpace, GP, wrappers, fails, make_mesh(device="cuda"))
        Path(out, f"rank{rank}.json").write_text(json.dumps(dict(res, fails=fails)))
    finally:
        dist.destroy_process_group()


def run_mesh(torch, HEBO, DesignSpace, GP, wrappers, fails):
    """Phase m with one rank per card (at most 4): in this process on one
    card (a one-rank NCCL group over a HashStore), spawned ranks over a
    FileStore on more; rank 0's rows and path launches are kept, every
    rank's failed checks."""
    import tempfile

    import torch.distributed as dist

    world = min(torch.cuda.device_count(), 4)
    print(f"phase m: world size {world} (NCCL, one rank per card)", flush=True)
    if world == 1:
        from hebo_tpu_torch.parallel import make_mesh

        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            return mesh_phase(torch, HEBO, DesignSpace, GP, wrappers, fails,
                              make_mesh(device="cuda"))
        finally:
            dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.start_processes(_mesh_rank, args=(world, str(Path(d) / "store"), d),
                                              nprocs=world, join=True, start_method="spawn")
        ranks = [json.loads(Path(d, f"rank{r}.json").read_text()) for r in range(world)]
    for r, res in enumerate(ranks):
        fails.extend(f"rank {r}: {f}" for f in res.pop("fails"))
    return ranks[0]


# ---------------------------------------------------------------- phase n
def band_score(imgs, hw=(40, 40)):
    """tests/test_decoders.py's band target at ``hw``: the squared distance
    of the thresholded image to rows [6/16, 10/16) of the height set."""
    H, W = hw
    target = np.zeros((H, W), np.float32)
    target[H * 6 // 16:H * 10 // 16, :] = 1.0
    b = (imgs[..., 0] > 0.5).astype(np.float32)
    return np.mean((b - target[None]) ** 2, axis=(1, 2)).reshape(-1, 1)


def vae_case(kind, device, n=24, seed=5):
    """A VAE family at the latent loops' widths and its training data (as
    tests/test_torch_cuda.py's ``_vae_case``): pest control's categorical
    VAE (25 columns × 5 codes, latent 4, hidden 64), the topology VAE at
    40 × 40 (latent 8) and chem's sequence VAE (16 tokens, length 24,
    latent 8); three steps of fed normals."""
    from hebo_tpu_torch.latent import decoders, vae

    rng = np.random.default_rng(seed)
    if kind == "vae":
        model, lat, train = vae.VAE(4, 25, 64, (5,) * 25, device=device), 4, vae.train_vae
        X = rng.integers(0, 5, (n, 25)).astype(np.float32)
    elif kind == "topology":
        model, lat, train = decoders.TopologyVAE(8, (40, 40), device=device), 8, decoders.train_topology_vae
        X = (rng.random((n, 40, 40, 1)) < 0.3).astype(np.float32)
    else:
        model, lat, train = decoders.SeqVAE(16, 24, 8, device=device), 8, decoders.train_seq_vae
        X = rng.integers(0, 16, (n, 24)).astype(np.int32)
    y = X.reshape(n, -1).mean(1, keepdims=True).astype(np.float32)
    w = vae.rank_weights(y[:, 0]).astype(np.float32)
    return model, train, X, y, w, rng.standard_normal((3, n, lat)).astype(np.float32)


def vae_card_vs_cpu(torch, fails):
    """Each VAE family: 3 Adam steps on the card and on the CPU from the
    same weights with the same fed normals.  In float32 the losses must
    agree within 1e-5 (relative); the parameters are held in float64, within
    1e-4 of each tensor's largest |value|.  In float32, Adam's per-element
    step g / (√v + ε) turns the rounding of a gradient that cancels to ~ε
    (the sequence VAE's encoder GRU input weights: ~5e-9) into steps of
    different sizes (0.54 against 0.45 of the learning rate), which is
    rounding, not a difference of the computation."""
    from hebo_tpu_torch.latent.vae import init_params

    out = {}
    for kind in ("vae", "topology", "seq"):
        cpu, train, X, y, w, noise = vae_case(kind, "cpu")
        card = vae_case(kind, "cuda")[0]
        p0 = init_params(cpu)
        _, lc = train(cpu, p0, X, y, w, n_steps=3, noise=noise)
        _, lg = train(card, {k: v.cuda() for k, v in p0.items()}, X, y, w, n_steps=3, noise=noise)
        loss_err = float(np.max(np.abs(lg - lc) / np.abs(lc)))
        p64 = {k: v.double() for k, v in p0.items()}
        pc, _ = train(cpu, p64, X, y, w, n_steps=3, noise=noise)
        pg, _ = train(card, {k: v.cuda() for k, v in p64.items()}, X, y, w, n_steps=3, noise=noise)
        err = max(((pg[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-30)).item()
                  for k, v in pc.items())
        out[kind] = dict(float64_param_err_over_max=err, float32_loss_rel_err=loss_err,
                         loss_cpu=lc.tolist(), loss_card=lg.tolist())
        if not (err <= 1e-4 and loss_err <= 1e-5):
            fails.append(f"phase n {kind}: 3 VAE steps on the card differ from the CPU's: {out[kind]}")
    print("phase n VAE train, card against CPU (3 fed steps):", json.dumps(out), flush=True)
    return out


def phase_walls(opt, k):
    return {f"{name}_s": getattr(opt, f"{name}_time")[-k:] for name in ("retrain", "fit", "acq", "decode")}


def latent_phase(torch, DesignSpace, wrappers, fails):
    """Phase n: LatentSpaceBO on pest control, ImageLatentBO at 40 × 40 and
    ChemLatentBO, at the JAX package's defaults; returns the rows and the
    shapes the kernels were launched at."""
    from hebo_tpu_torch.latent import ImageLatentBO, LatentSpaceBO
    from hebo_tpu_torch.latent.chem import ChemLatentBO, canonical_string, decode_tokens
    from hebo_tpu_torch.tasks import PestControlTask

    rows, sug, shapes = {}, Suggests(torch, wrappers), ShapeLog()
    try:
        pest = PestControlTask(n_stations=25)
        opt = LatentSpaceBO(pest.space, n_init=16, device="cuda")
        rec = opt.suggest(16)
        opt.observe(rec, pest(rec))
        init_best, log = opt.best_y, {}
        for _ in range(4):
            rec = sug(opt, 4, log)
            check_rec(pest.space, rec, 4, "phase n1 LatentSpaceBO", fails, hist=pest.space.transform(opt.X))
            opt.observe(rec, pest(rec))
        rows["n1 LatentSpaceBO pest"] = dict(log, **phase_walls(opt, 4), n_retrains=opt._n_retrains,
                                             n_obs=opt.num_obs, init_best=init_best, best=opt.best_y)
        if opt._n_retrains < 2:
            fails.append(f"phase n1: {opt._n_retrains} VAE retrain(s), want one after the first")
        if not opt.best_y <= init_best:
            fails.append("phase n1: the best y is worse than the init phase's")

        bo = ImageLatentBO(device="cuda")
        for _ in range(16):
            imgs = bo.suggest(1)
            bo.observe(imgs, band_score(imgs))
        init_best, log = float(bo.y.min()), {}
        for _ in range(4):
            imgs = sug(bo, 2, log)
            if not (imgs.shape == (2, 40, 40, 1) and np.isfinite(imgs).all() and imgs.min() >= 0
                    and imgs.max() <= 1):
                fails.append(f"phase n2 ImageLatentBO: images not (2, 40, 40, 1) in [0, 1]: {imgs.shape}")
            bo.observe(imgs, band_score(imgs))
        rows["n2 ImageLatentBO 40x40"] = dict(log, **phase_walls(bo, 4), init_best=init_best,
                                              best=float(bo.y.min()), n_obs=len(bo.y))
        if len(bo.retrain_time) != 1:
            fails.append(f"phase n2: {len(bo.retrain_time)} VAE retrains, want 1")
        if not float(bo.y.min()) <= init_best:
            fails.append("phase n2: the best score is worse than the init phase's")

        t0 = time.time()
        chem = ChemLatentBO(device="cuda")
        torch.cuda.synchronize()
        init_s, init_best, n0 = time.time() - t0, chem.best_y, len(chem.tokens)
        seen0 = {canonical_string(decode_tokens(t)) for t in chem.tokens}
        log = {}
        for _ in range(3):
            before = {k: w.launches for k, w in wrappers.items()}
            t0 = time.time()
            chem.step(4)
            torch.cuda.synchronize()
            log.setdefault("s_per_step", []).append(time.time() - t0)
            log.setdefault("launches_per_step", []).append(
                {k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]})
        new = chem.tokens[n0:]
        graphs = [decode_tokens(t) for t in new]
        strs = [canonical_string(g) for g in graphs]
        if not (len(new) > 0 and all(g.free_valence(i) >= 0 for g in graphs for i in range(len(g.atoms)))
                and len(set(strs)) == len(strs) and not set(strs) & seen0):
            fails.append(f"phase n3 ChemLatentBO: new molecules not valid and new ({len(new)} added)")
        if not chem.best_y >= init_best:
            fails.append("phase n3: the best y is worse than the initial set's")
        rows["n3 ChemLatentBO"] = dict(log, init_s=init_s, **phase_walls(chem, 3), added=len(new),
                                       init_best=init_best, best=chem.best_y)
        for name, row in rows.items():
            print(f"phase {name}:", json.dumps(row), flush=True)
    finally:
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    want = [("K2 at D 4", "matern32_gram", lambda s: s[3] == 4), ("K2 at D 8", "matern32_gram", lambda s: s[3] == 8)]
    want += [(f"K5 at {sh}", "nsga2_rank_crowd", lambda s, sh=sh: s == sh)
             for sh in ((48, 1), (96, 1), (32, 1), (64, 1), (128, 1))]
    for what, kernel, hit in want:
        if not any(hit(s) for s in shapes.seen[kernel]):
            fails.append(f"phase n: {what} never launched")
    print("phase n shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


# ---------------------------------------------------------------- phase o
def tasks_phase(torch, DesignSpace, wrappers, fails):
    """Phase o: the task suite's black boxes with device work on them:
    ``run_hpob_eval`` with the port's HEBO, MCBO's BOiLS preset and the
    DRiLLS agent on the real ``BoilsTask``, and one evaluation of each
    other task; returns the rows and the shapes the kernels were launched
    at."""
    from hebo_tpu_torch import native as host_native
    from hebo_tpu_torch.ops import ssk
    from hebo_tpu_torch.optimizers.bo_builder import BO_ALGOS
    from hebo_tpu_torch.tasks import (BoilsTask, CorruptedTask, DrillsBaseline, EDASeqOptTask,
                                      LPSolveTask, NASBenchTask, RKHSTask, RNAInverseFoldTask,
                                      RobotPushTask, SyntheticHPOBTask)
    from hebo_tpu_torch.tasks.hpob import run_hpob_eval

    rows, sug, shapes = {}, Suggests(torch, wrappers), ShapeLog()
    try:
        t0 = time.time()
        host_native.ensure_built()
        rows["native build"] = dict(s=time.time() - t0)

        bench = SyntheticHPOBTask(dim=3, n_points=512, seed=0)
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.time()
        res = run_hpob_eval({"synthetic": {"gp0": bench}}, n_seeds=1, n_trials=8, n_init=5, device="cuda")
        trace = res["synthetic"]["gp0"]["test0"]
        rows["o1 run_hpob_eval"] = dict(s=time.time() - t0, trace=trace, launches={
            k: w.launches - before[k] for k, w in wrappers.items() if w.launches > before[k]})
        if not (len(trace) == 8 and all(b >= a for a, b in zip(trace, trace[1:]))
                and bench.y_table.min() <= min(trace) and max(trace) <= bench.y_table.max()):
            fails.append(f"phase o1 run_hpob_eval: trace not 8 monotone table values: {trace}")

        task = BoilsTask()
        opt = BO_ALGOS["BOiLS"].build_bo(task.space, n_init=10, seed=0, device="cuda")
        warm_df = task.space.sample(20, seed=1)
        opt.observe(warm_df, task(warm_df))
        log = {}
        for _ in range(2):
            rec = sug(opt, 1, log)
            check_rec(task.space, rec, 1, "phase o2 BOiLS", fails, hist=task.space.transform(opt.X))
            y = task(rec)
            if not np.isfinite(y).all():
                fails.append("phase o2 BOiLS: QoR not finite")
            opt.observe(rec, y)
        rows["o2 BOiLS on BoilsTask"] = dict(log, **timers(opt, 2), best=opt.best_y, k3_routes={
            str(sh): ssk.route(sh[3], sh[4], sh[0] * sh[1] * sh[2])
            for sh in sorted(shapes.seen["ssk_cross"])})
        if not all(r.get("ssk_cross", 0) > 0 and r.get("ssk_self", 0) > 0 for r in log["launches_per_suggest"]):
            fails.append("phase o2 BOiLS: a suggest launched no K3")

        t0 = time.time()
        out = DrillsBaseline(task, device="cuda").train(2)
        rows["o3 DrillsBaseline"] = dict(s=time.time() - t0, **out)
        if not (len(out["qor_trace"]) == 2 and np.isfinite(out["qor_trace"]).all()):
            fails.append(f"phase o3 DRiLLS: {out}")

        evals = {}
        for name, t in (("EDASeqOptTask", EDASeqOptTask()), ("RNAInverseFoldTask", RNAInverseFoldTask()),
                        ("LPSolveTask", LPSolveTask()), ("NASBenchTask", NASBenchTask()),
                        ("RobotPushTask", RobotPushTask()), ("CorruptedTask", CorruptedTask(RKHSTask()))):
            y = t(t.space.sample(1, seed=0))
            evals[name] = y.tolist()
            if not (y.shape == (1, 1) and np.isfinite(y).all()):
                fails.append(f"phase o4 {name}: value {y} not finite of shape (1, 1)")
        rows["o4 one evaluation each"] = evals
        for name, row in rows.items():
            print(f"phase {name}:", json.dumps(row), flush=True)
    finally:
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    print("phase o shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


# ---------------------------------------------------------------- phase p
def _timed(fn, log, key, sync):
    """``fn`` wrapped to append each call's wall seconds to ``log[key]``."""
    def wrapped(*a, **k):
        t0 = time.time()
        out = fn(*a, **k)
        sync()
        log.setdefault(key, []).append(time.time() - t0)
        return out
    return wrapped


def busy(fn):
    """``fn()`` once under torch.profiler (``bench/profile_suggest``'s
    ``_device_profile``): its wall, device kernel seconds, busy share and
    launches."""
    from hebo_tpu_torch.bench.profile_suggest import _device_profile

    p = _device_profile(fn)
    return {k: p[k] for k in ("profiled_wall_s", "device_kernel_s", "device_busy_share", "kernel_launches",
                              "host_kernel_launches", "graph_launches")}


def experiment_phase(torch, wrappers, fails):
    """Phase p: the config tree and the experiment runner on the card.
    ``BOExperiments`` runs HEBO (``from_string("hebo")``, its defaults) on
    Ackley-6D and the BoBuilder string ``gp_to__is__ei__basic`` (its trust
    region) on pest control 25 × 5, batch 8 with a checkpoint after every
    round, to 48 evaluations; a second ``BOExperiments`` in the same
    directory resumes to 64, and its first batch must equal the
    uninterrupted optimizer's at 48.  Then every simple name builds through
    ``OptimizerConfig.build`` and suggests once.  Returns the rows and the
    shapes the kernels were launched at."""
    import tempfile

    from hebo_tpu_torch.config import _SIMPLE_OPTIMIZERS, from_string
    from hebo_tpu_torch.tasks import Ackley, PestControlTask
    from hebo_tpu_torch.utils import checkpoint, experiment

    dev, sync = "cuda", torch.cuda.synchronize
    batch, stop, end = 8, 48, 64
    rows, shapes = {}, ShapeLog()
    saved = experiment.save_optimizer, checkpoint.load_optimizer
    try:
        with tempfile.TemporaryDirectory() as d:
            cases = (("p1 HEBO Ackley-6D", from_string("hebo"), Ackley()),
                     ("p2 gp_to__is__ei__basic pest 25x5", from_string("gp_to__is__ei__basic"),
                      PestControlTask(n_stations=25)))
            for name, cfg, task in cases:
                io = {}
                experiment.save_optimizer = _timed(saved[0], io, "save_s", sync)
                checkpoint.load_optimizer = _timed(saved[1], io, "load_s", sync)
                sub = str(Path(d) / name.split()[0])
                before = {k: w.launches for k, w in wrappers.items()}
                exp = experiment.BOExperiments(cfg, task, save_dir=sub, device=dev)
                exp.optimizer.suggest = _timed(exp.optimizer.suggest, io, "s_per_suggest", sync)
                log1 = exp.run(max_evals=stop, batch=batch)
                uninterrupted = exp.optimizer.suggest(batch)
                exp2 = experiment.BOExperiments(cfg, task, save_dir=sub, device=dev)
                recs, suggest = [], exp2.optimizer.suggest
                exp2.optimizer.suggest = lambda n, *a, **k: recs.append(suggest(n, *a, **k)) or recs[-1]
                exp2.optimizer.suggest = _timed(exp2.optimizer.suggest, io, "s_per_suggest_resumed", sync)
                log2 = exp2.run(max_evals=end, batch=batch, resume=True)
                csv_rows = len(pd.read_csv(Path(sub) / "results.csv"))
                same = bool(recs) and recs[0].equals(uninterrupted)
                ys = np.array([r["y"] for r in log1.rows + log2.rows])
                opt = exp2.optimizer
                prof = busy(lambda: opt.suggest(batch))
                rows[name] = dict(io, resumed_first_batch_equals_uninterrupted=same, csv_rows=csv_rows,
                                  profiled_suggest=prof,
                                  n_obs=opt.num_obs, best=opt.best_y, launches={
                                      k: w.launches - before[k] for k, w in wrappers.items()
                                      if w.launches > before[k]},
                                  tr=None if not hasattr(getattr(opt, "tr_manager", None), "radius") else dict(
                                      radius=opt.tr_manager.radius, fail_count=opt.tr_manager.fail_count,
                                      succ_count=opt.tr_manager.succ_count,
                                      center_set=opt.tr_manager.center is not None))
                if not same:
                    fails.append(f"phase {name}: the resumed optimizer's first batch differs from the "
                                 "uninterrupted optimizer's at the same observations")
                if not (len(log1.rows) == stop and len(log2.rows) == end - stop and opt.num_obs == end
                        and csv_rows == end - stop and np.isfinite(ys).all()):
                    fails.append(f"phase {name}: {len(log1.rows)} + {len(log2.rows)} evaluations, "
                                 f"{opt.num_obs} observed, {csv_rows} CSV rows, finite {np.isfinite(ys).all()}")
                X = task.space.transform(opt.X)
                if not (np.isfinite(X).all() and (X >= task.space.opt_lb).all() and (X <= task.space.opt_ub).all()):
                    fails.append(f"phase {name}: a suggestion lies outside the space")
            experiment.save_optimizer, checkpoint.load_optimizer = saved
            space = Ackley().space
            built = {}
            for n in sorted(_SIMPLE_OPTIMIZERS):
                t0 = time.time()
                opt = from_string(n).build(space, device=dev)
                rec = opt.suggest() if n in ("cmaes", "evolution") else opt.suggest(8)
                sync()
                built[n] = dict(cls=type(opt).__name__, s=time.time() - t0, rows=len(rec))
                if not (len(rec) >= 1 and np.isfinite(opt.space.transform(rec)).all()):
                    fails.append(f"phase p3 {n}: its first suggestion is not finite")
                if getattr(opt, "device", torch.device(dev)).type != torch.device(dev).type:
                    fails.append(f"phase p3 {n}: built on {opt.device}, not {dev}")
            rows["p3 every simple name, build + one suggest"] = built
        for name, row in rows.items():
            print(f"phase {name}:", json.dumps(row), flush=True)
    finally:
        experiment.save_optimizer, checkpoint.load_optimizer = saved
        shapes.close()
    seen = {k: sorted(v) for k, v in shapes.seen.items()}
    print("phase p shapes launched:", json.dumps(seen), flush=True)
    return dict(rows=rows, shapes=seen)


# ---------------------------------------------------------------- phase q
def _max_rel(a: dict, b: dict):
    """The largest |a − b| over each tensor's largest |b|, by key."""
    return max(((a[k].cpu() - v).abs().max() / v.abs().max().clamp(min=1e-30)).item() for k, v in b.items())


def sac_states_err(x, y):
    """Parameters, targets and log α; Adam's moments apart."""
    p = max(_max_rel(getattr(x, f), getattr(y, f)) for f in ("actor", "q1", "q2", "q1_targ", "q2_targ"))
    p = max(p, (x.log_alpha.cpu() - y.log_alpha).abs().item() / max(abs(y.log_alpha.item()), 1e-30))
    m = max(max(_max_rel(getattr(x, f).mu, getattr(y, f).mu), _max_rel(getattr(x, f).nu, getattr(y, f).nu))
            for f in ("opt_actor", "opt_q", "opt_alpha"))
    return p, m


def _to(state, dev):
    from hebo_tpu_torch.rl.sac import AdamState

    mv = lambda d: {k: v.to(dev) for k, v in d.items()}
    return state._replace(**{f: mv(getattr(state, f)) for f in ("actor", "q1", "q2", "q1_targ", "q2_targ")},
                          log_alpha=state.log_alpha.to(dev),
                          **{f: AdamState(getattr(state, f).count, mv(getattr(state, f).mu), mv(getattr(state, f).nu))
                             for f in ("opt_actor", "opt_q", "opt_alpha")})


def rl_phase(torch, fails):
    """Phase q: SAC at its defaults (hidden 64, lr 3e-4, γ 0.99, τ 0.005)
    on ``Pendulum`` with tests/test_rl.py's loop (6 cycles of 150
    environment steps and 60 updates of batch 128), ``GuidedSAC`` for 60
    updates, ``SauteWrapper(PointGoal())`` for a 100-step episode with
    ``SimmerController`` updated from its cost, ``DynamicsEnsemble`` at its
    defaults (5 members, hidden 64, 200 epochs) fitted on SAC's transitions
    and ``pessimistic_rollout`` (horizon 5, 256 starts) at β 2 and β 0; then
    one SAC update and one guided update on the card and on the CPU from the
    same state with the same normals."""
    from hebo_tpu_torch.rl import (SAC, DynamicsEnsemble, GuidedSAC, Pendulum, PointGoal, ReplayBuffer,
                                   SauteWrapper, SimmerController, pessimistic_rollout)

    dev, sync = "cuda", torch.cuda.synchronize
    cycles, n_env, n_upd, B = 6, 150, 60, 128
    row = {}
    env = Pendulum(device=dev)
    sac = SAC(3, 1, 2.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = sac.init(gen)
    buf = ReplayBuffer(3, 1, 20_000)
    rng = np.random.default_rng(0)

    def eval_return(state, n=100):
        s, obs = env.reset(u=0.3)
        total = torch.zeros((), device=dev)
        for _ in range(n):
            s, obs, r, _, _ = env.step(s, sac.act(state, obs[None], deterministic=True)[0])
            total = total + r
        return float(total)

    r0 = eval_return(state)
    env_s, upd_s = 0.0, 0.0
    for it in range(cycles):
        t0 = time.time()
        s, obs = env.reset(gen)
        for _ in range(n_env):
            a = sac.act(state, obs[None], gen)[0]
            s, nobs, r, c, d = env.step(s, a)
            buf.add(obs.cpu().numpy(), a.cpu().numpy(), float(r), nobs.cpu().numpy(), float(d), float(c))
            obs = nobs
        env_s += time.time() - t0
        t0 = time.time()
        for _ in range(n_upd):
            state = sac.update(state, buf.sample(rng, B), generator=gen)
        sync()
        upd_s += time.time() - t0
    r1 = eval_return(state)
    prof = busy(lambda: [sac.update(state, buf.sample(rng, B), generator=gen) for _ in range(10)])
    leaves = [v for f in ("actor", "q1", "q2") for v in getattr(state, f).values()] + [state.log_alpha]
    finite = all(bool(torch.isfinite(v).all()) for v in leaves)
    row["q1 SAC Pendulum"] = dict(return_before=r0, return_after=r1, s_per_env_step=env_s / (cycles * n_env),
                                  s_per_update=upd_s / (cycles * n_upd), alpha=math.exp(state.log_alpha.item()),
                                  transitions=buf.n, profiled_10_updates=prof)
    if not (finite and math.isfinite(r1)):
        fails.append(f"phase q1 SAC: non-finite weights or return ({r1})")

    guide = lambda o: -0.5 * o[..., 2:3]  # damp the angular velocity
    region = lambda o: (o[..., 0] < 0).to(o.dtype)  # the lower half circle
    gsac = GuidedSAC(3, 1, guide, region, act_limit=2.0, device=dev)
    gstate = gsac.init(gen)
    t0 = time.time()
    for _ in range(n_upd):
        gstate = gsac.update(gstate, buf.sample(rng, B), generator=gen)
    sync()
    a = gsac.act(gstate, torch.as_tensor(buf.obs[:B], device=dev), gen)
    row["q2 GuidedSAC"] = dict(s_per_update=(time.time() - t0) / n_upd, lam=gsac.lam,
                               actor_count=gstate.opt_actor.count)
    if not (gsac.lam < 1.0 and bool(torch.isfinite(a).all())
            and all(bool(torch.isfinite(v).all()) for v in gstate.actor.values())):
        fails.append(f"phase q2 GuidedSAC: λ {gsac.lam} did not decay or a value is not finite")

    saute = SauteWrapper(PointGoal(device=dev))
    ctl = SimmerController(target_cost=1.0, budget_min=0.5, budget_max=5.0)
    (s, z), obs = saute.reset(gen)
    ep_cost, rew = torch.zeros((), device=dev), torch.zeros((), device=dev)
    t0 = time.time()
    act = torch.tensor([0.7, 0.7], device=dev)  # through the hazard towards the goal
    for _ in range(100):
        (s, z), obs, r, c, d = saute.step((s, z), act)
        ep_cost, rew = ep_cost + c, rew + r
    sync()
    budget = ctl.update(float(ep_cost))
    row["q3 Saute PointGoal + Simmer"] = dict(s_per_env_step=(time.time() - t0) / 100, episode_cost=float(ep_cost),
                                              z_final=float(z), episode_reward=float(rew), simmer_budget=budget)
    if not (float(z) < 1.0 and math.isfinite(float(rew)) and math.isfinite(budget)):
        fails.append(f"phase q3 Sauté: budget z {float(z)} did not fall below 1, or a value is not finite")

    n = buf.n
    O, A, R, NO = buf.obs[:n], buf.act[:n], buf.rew[:n], buf.nobs[:n]
    ens = DynamicsEnsemble(3, 1, device=dev)
    t0 = time.time()
    ens.fit(O, A, NO, R, generator=gen)
    sync()
    fit_s = time.time() - t0
    nxt, rw = ens.predict_members(torch.as_tensor(O[:256], device=dev), torch.as_tensor(A[:256], device=dev))
    mse = float(((nxt.mean(0) - torch.as_tensor(NO[:256], device=dev)) ** 2).mean())
    policy = lambda o, g: sac.act(state, o, g)
    obs0 = torch.as_tensor(O[rng.choice(n, min(256, n), replace=False)], device=dev)
    t0 = time.time()
    ro = {beta: pessimistic_rollout(ens, policy, obs0, horizon=5, beta=beta,
                                    generator=torch.Generator(device=dev).manual_seed(1))
          for beta in (2.0, 0.0)}
    sync()
    r_pess, r_mean = float(ro[2.0][2].mean()), float(ro[0.0][2].mean())
    row["q4 PMDB"] = dict(fit_s=fit_s, rollout_s=(time.time() - t0) / 2, transitions=n, member_mean_mse=mse,
                          return_beta2=r_pess, return_beta0=r_mean)
    if not (all(bool(torch.isfinite(t).all()) for r in ro.values() for t in r) and math.isfinite(mse)):
        fails.append("phase q4 PMDB: a rollout or prediction is not finite")
    if not r_pess <= r_mean + 0.1:
        fails.append(f"phase q4 PMDB: the β-2 return {r_pess} exceeds the β-0 return {r_mean} + 0.1")

    # one update of each kind from the trained states, on the card and on
    # the CPU, with the same batch and normals (float32)
    batch = buf.sample(rng, B)
    eps = tuple(rng.standard_normal((B, 1)).astype(np.float32) for _ in range(2))
    errs = {}
    for what, agent, st in (("sac", sac, state), ("guided", gsac, gstate)):
        cpu = (SAC(3, 1, 2.0, device="cpu") if what == "sac" else
               GuidedSAC(3, 1, guide, region, act_limit=2.0, device="cpu"))
        cpu.lam = getattr(agent, "lam", None)
        got = agent.update(st, batch, eps=eps)
        want = cpu.update(_to(st, "cpu"), batch, eps=eps)
        errs[what] = dict(zip(("params_rel_err", "moments_rel_err"), sac_states_err(got, want)))
        if not (errs[what]["params_rel_err"] <= SAC_TOL and errs[what]["moments_rel_err"] <= SAC_MOMENT_TOL):
            fails.append(f"phase q {what} update: card against CPU {errs[what]}")
    row["q5 one update, card against CPU (float32)"] = errs
    for name, r in row.items():
        print(f"phase {name}:", json.dumps(r), flush=True)
    return row


# ---------------------------------------------------------------- phase r
def sparse_po_phase(torch, fails):
    """Phase r: ``TinyLM`` at its defaults (d_model 64, 4 heads, 2 layers,
    max_len 64), vocab 32, on 256 preference pairs of 64 tokens;
    ``train_sparse_po`` at its defaults (150 steps, batch 16, lr 1e-3, β
    0.5, mask_l1 0.05) for each mask mode; then the forward pass of the
    trained ``learned`` weights and three training steps with fed indices
    on the card and on the CPU."""
    from torch.func import functional_call

    from hebo_tpu_torch.po import (TinyLM, make_pref_data, preference_accuracy, sparse_dpo_loss,
                                   train_sparse_po)

    dev, sync = "cuda", torch.cuda.synchronize
    n_pairs, T, steps = 256, 64, 150
    chosen, rejected = make_pref_data(n_pairs, T, 32, generator=torch.Generator(device=dev).manual_seed(0),
                                      device=dev)
    rows, trained = {}, {}
    for mode in ("learned", "all_layers", "activation", "common"):
        model = TinyLM(32, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        sync()
        t0 = time.time()
        params, info = train_sparse_po(model, chosen, rejected, n_steps=steps, mask_mode=mode,
                                       generator=torch.Generator(device=dev).manual_seed(1))
        sync()
        wall = time.time() - t0
        acc = preference_accuracy(model, params, info["ref_params"], chosen, rejected, mask_mode=mode)
        loss, mm = info["loss"], info["mask_mean"]
        rows[mode] = dict(s_per_step=wall / steps, accuracy=acc, loss_first10=float(loss[:10].mean()),
                          loss_last10=float(loss[-10:].mean()), mask_mean_last=float(mm[-1]))
        trained[mode] = (model, params)
        ok = (np.isfinite(loss).all() and loss[-10:].mean() < loss[:10].mean()
              and ((mm > 0) & (mm < 1)).all())
        if not (ok and acc > (0.8 if mode == "learned" else 0.6)):
            fails.append(f"phase r {mode}: {rows[mode]}")
    model = TinyLM(32, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    rows["profiled_10_steps_learned"] = busy(
        lambda: train_sparse_po(model, chosen, rejected, n_steps=10,
                                generator=torch.Generator(device=dev).manual_seed(1)))
    out = {"r1 train_sparse_po by mask mode": rows}

    # the forward pass of every mode's trained weights on two token batches,
    # on the card and on the CPU (float32)
    cpu = TinyLM(32, device="cpu")
    rel = lambda a, b: ((a.cpu() - b).abs().max() / b.abs().max()).item()
    fwd, mapo = {}, []
    for mode, (model, params) in trained.items():
        for lo in (0, 4):
            tok = torch.cat([chosen[lo:lo + 4], rejected[lo:lo + 4]])
            with torch.no_grad():
                lg, mg = functional_call(model, params, (tok,))
                lc, mc = functional_call(cpu, {k: v.cpu() for k, v in params.items()}, (tok.cpu(),))
            for k, e in dict(logits=rel(lg, lc), **{k: rel(mg[k], mc[k]) for k in mc}).items():
                if k == "activation":
                    mapo.append(e)
                else:
                    fwd[k] = max(fwd.get(k, 0.0), e)
    if not (max(fwd.values()) <= PO_FWD_TOL and max(mapo) <= PO_ACT_TOL):
        fails.append(f"phase r forward: card against CPU {fwd}, MaPO statistic {mapo}")
    # three training steps of the trained ``learned`` weights with fed
    # indices, two index sets.  float64: every parameter within 1e-8 of
    # max(|p|, 1e-3).  float32: Adam scales each element's step to about lr
    # whatever its gradient's size, so an element whose gradient cancels to
    # its rounding takes a different step on each side.  So every element
    # stays within Adam's bound (2 × 1.06 lr a step: |m̂| ≤ 1.06 √v̂ in three
    # steps), and at most PO_STEP_SHARE of the elements exceed PO_STEP_TOL,
    # the share counted without the leaves whose gradient is zero up to
    # rounding (the CPU's float64 gradient at the first step at most
    # PO_ZERO_GRAD of the largest leaf's: the attention key biases, to which
    # the softmax is invariant, step on rounding alone).
    _, params = trained["learned"]
    m64 = TinyLM(32, device="cpu").to(torch.float64)
    steps_err = []
    for seed in (2, 3):
        idx = np.random.default_rng(seed).integers(0, n_pairs, (3, 16))
        p64 = {k: v.detach().cpu().double().requires_grad_(True) for k, v in params.items()}
        loss0, _ = sparse_dpo_loss(m64, p64, {k: v.detach() for k, v in p64.items()},
                                   chosen[idx[0]].cpu(), rejected[idx[0]].cpu())
        g64 = dict(zip(p64, torch.autograd.grad(loss0, list(p64.values()), allow_unused=True)))
        gmax = {k: None if g is None else g.abs().max().item() for k, g in g64.items()}
        top = max(v for v in gmax.values() if v is not None)
        rounding = sorted(k for k, v in gmax.items() if v is not None and v <= PO_ZERO_GRAD * top)
        row = dict(idx_seed=seed, left_out={k: gmax[k] / top for k in rounding})
        for dt in (torch.float32, torch.float64):
            res = []
            for d in (dev, "cpu"):
                m = TinyLM(32, device=d).to(dt)
                m.load_state_dict({k: v.to(d, dt) for k, v in params.items()})
                res.append(train_sparse_po(m, chosen.to(d), rejected.to(d), n_steps=3, idx=idx))
            (pg, ig), (pc, ic) = res
            diff = {k: (pg[k].cpu() - v).abs() / v.abs().max().clamp(min=1e-3) for k, v in pc.items()}
            held = [k for k in diff if k not in rounding]
            row[str(dt)] = dict(
                loss_rel_err=float(np.max(np.abs(ig["loss"] - ic["loss"]) / np.abs(ic["loss"]))),
                params_rel_err=max(float(e.max()) for e in diff.values()),
                max_abs_err=max(float((pg[k].cpu() - v).abs().max()) for k, v in pc.items()),
                share_over_tol=(sum(int((diff[k] > PO_STEP_TOL).sum()) for k in held)
                                / sum(diff[k].numel() for k in held)),
                worst_held=max(held, key=lambda k: float(diff[k].max())),
                worst_held_err=max(float(diff[k].max()) for k in held))
        f32, f64 = row["torch.float32"], row["torch.float64"]
        if not (f32["loss_rel_err"] <= 1e-5 and f32["share_over_tol"] <= PO_STEP_SHARE
                and f32["max_abs_err"] <= 2 * 1.06 * 1e-3 * 3 and f64["params_rel_err"] <= 1e-8):
            fails.append(f"phase r three steps: card against CPU {row}")
        steps_err.append(row)
    out["r2 card against CPU"] = dict(forward_rel_err=fwd, mapo_statistic_rel_err=mapo, three_steps=steps_err)
    for name, r in out.items():
        print(f"phase {name}:", json.dumps(r), flush=True)
    return out


# ---------------------------------------------------------------- phase s
# Llama-3-8B's attention widths (8 key-value heads of 128) and EM-LLM's
# settings for it (Fountas et al. 2024): a local window of 4096 tokens,
# events of up to 128 tokens, 4 representatives an event, γ = 1
EM_H, EM_DH, EM_WINDOW, EM_EVENT, EM_K_SIM, EM_K_CONTIG = 8, 128, 4096, 128, 4, 1
EM_CHUNK, EM_TOKENS = 512, 128 * 1024
EM_ATT_TOL = 1e-5  # masked_attention, card against CPU, of the largest |output|
EM_TIE = 1e-6  # segmentation: a boundary whose CPU top-two scores lie this close is a tie


def _em_surprise(rng, n):
    """Per-token surprise with a spike every 128 tokens of the chunk (at 128,
    256 and 384 of 512), so the overflow segments into events of ~128."""
    s = 0.1 * rng.random(n)
    s[np.arange(EM_EVENT, n, EM_EVENT)] = 10.0
    return s


def _seg_agrees(trace_card, trace_cpu):
    """(agree, ties): the boundaries picked on the card against the CPU's,
    in sweep order; the first pick that parts must be a tie of the CPU's
    top-two scores (then the sweeps part, and the rest is not compared)."""
    for (bi, cand, sg), (bj, cand_c, sc) in zip(trace_card, trace_cpu):
        if (bi, cand) != (bj, cand_c):
            return False, 0
        if int(np.argmax(sg)) != int(np.argmax(sc)):
            top = np.sort(sc)[-2:]
            return bool(top[1] - top[0] <= EM_TIE * abs(top[1])), 1
    return len(trace_card) == len(trace_cpu), 0


def _em_retrieve_rank(rank, world, store, out):
    """One rank of s5 on a machine with several cards (spawned)."""
    import os

    import torch
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(ROOT))
    from hebo_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        fails = []
        res = em_sharded(torch, make_mesh(axis="mem", device="cuda"), fails)
        Path(out, f"rank{rank}.json").write_text(json.dumps(dict(res, fails=fails)))
    finally:
        dist.destroy_process_group()


def em_sharded(torch, mesh, fails, E=4096, F=1024, k=EM_K_SIM):
    """s5 on one rank: ``retrieve_sharded`` over the mesh at (E, F) against
    the host argsort, with its ms per call."""
    from hebo_tpu_torch.emllm import retrieve_sharded

    rng = np.random.default_rng(7)
    reps = rng.standard_normal((E, F)).astype(np.float32)
    q = rng.standard_normal(F).astype(np.float32)
    rd, qd = torch.as_tensor(reps, device="cuda"), torch.as_tensor(q, device="cuda")
    got = retrieve_sharded(mesh, rd, qd, k_sim=k, axis="mem").cpu().numpy()
    want = np.argsort(-(reps.astype(np.float64) @ q))[:k]
    ms = cuda_ms(torch, lambda: retrieve_sharded(mesh, rd, qd, k_sim=k, axis="mem"), 20)
    if got.tolist() != want.tolist():
        fails.append(f"phase s5: retrieve_sharded {got.tolist()} against the host's {want.tolist()}")
    return dict(world=mesh.size(), E=E, F=F, ids=got.tolist(), ms=ms)


def emllm_phase(torch, fails):
    """Phase s: EM-LLM's episodic memory on the card at Llama-3-8B's
    attention widths.  s1 ``masked_attention`` at (Tq, Tk) = (512, 4096 +
    4·3·128) against the CPU, and a fully masked key set (the mean of V);
    s2 a 256-event memory on the card and on the CPU: ``retrieve`` in both
    modes for 16 queries, the same ids, ``gather_kv`` bit for bit; s3
    ``segment_events`` on 8 chunks (512, 1024) against the CPU; s4 one
    ``EMLLMAttention`` streams 128K tokens in 512-token chunks with a
    needle chunk at one third and recalls it; s5 ``retrieve_sharded`` at
    world min(cards, 4) over NCCL.  Runs none of the port's kernels."""
    import tempfile

    import torch.distributed as dist

    from hebo_tpu_torch.emllm import EMLLMAttention, EpisodicKVMemory, masked_attention, segment_events

    dev, sync = torch.device("cuda"), torch.cuda.synchronize
    H, Dh, out = EM_H, EM_DH, {}
    # s1: the attention of one 512-token query block over the window and
    # 4 · 3 retrieved events (k_sim 4 with both neighbours)
    g = torch.Generator().manual_seed(11)
    Tq, Tk = EM_CHUNK, EM_WINDOW + 4 * 3 * EM_EVENT
    q, k, v = (torch.randn((n, H, Dh), generator=g) for n in (Tq, Tk, Tk))
    mask = torch.rand(Tk, generator=g) < 0.9
    qd, kd, vd, md = (t.to(dev) for t in (q, k, v, mask))
    cpu = masked_attention(q, k, v, mask)
    card = masked_attention(qd, kd, vd, md)
    err = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    none = masked_attention(qd, kd, vd, torch.zeros_like(md))
    err_none = float((none - vd.mean(0)).abs().max() / vd.abs().max())
    flops = 2 * 2 * H * Tq * Tk * Dh
    nbytes = 4 * (2 * Tq * H * Dh + 2 * Tk * H * Dh) + Tk
    ms = cuda_ms(torch, lambda: masked_attention(qd, kd, vd, md), 20)
    out["s1 masked_attention"] = dict(shape=[Tq, Tk, H, Dh], rel_err=err, fully_masked_err=err_none, ms=ms,
                                      bound_ms=bound(flops, nbytes)[0], tflops=flops / ms * 1e-9)
    if not (err <= EM_ATT_TOL and err_none <= EM_ATT_TOL):
        fails.append(f"phase s1: masked_attention {out['s1 masked_attention']}")

    # s2: a 256-event memory from seeded data on the card and on the CPU
    rng = np.random.default_rng(12)
    mems = [EpisodicKVMemory(event_len=EM_EVENT, device=d) for d in (dev, "cpu")]
    while len(mems[1]) < 256:
        K = rng.standard_normal((EM_CHUNK, H, Dh)).astype(np.float32)
        V = rng.standard_normal((EM_CHUNK, H, Dh)).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(16, EM_CHUNK - 16), 3, replace=False))
        edges = [0, *cuts.tolist(), EM_CHUNK]
        spans = list(zip(edges[:-1], edges[1:]))[: 256 - len(mems[1])]
        for mem in mems:
            mem.add_events(K, V, spans)
    same, gaps = True, []
    for i in range(16):
        qq = rng.standard_normal((32, H, Dh)).astype(np.float32)
        for mode in ("reps", "full"):
            ids = [m.retrieve(qq, EM_K_SIM, EM_K_CONTIG, mode=mode) for m in mems]
            sc = np.sort(mems[1].scores(qq, mode).numpy())[::-1]
            gaps.append(float((sc[EM_K_SIM - 1] - sc[EM_K_SIM]) / abs(sc[EM_K_SIM - 1])))
            kv = [m.gather_kv(ids[0]) for m in mems]
            same &= ids[0] == ids[1] and all(torch.equal(a.cpu(), b) for a, b in zip(*kv))
    qq = torch.as_tensor(rng.standard_normal((EM_CHUNK, H, Dh)).astype(np.float32), device=dev)
    out["s2 memory, 256 events"] = dict(
        same_ids_and_kv=same, min_rel_gap_at_k=min(gaps),
        retrieve_ms={m: cuda_ms(torch, lambda: mems[0].retrieve(qq, EM_K_SIM, EM_K_CONTIG, mode=m), 10)
                     for m in ("reps", "full")})
    if not same:
        fails.append(f"phase s2: retrieve / gather_kv card against CPU {out['s2 memory, 256 events']}")
    del mems

    # s3: segmentation of 8 seeded (512, 1024) chunks
    spans_same, ties, n_bounds = 0, 0, 0
    for c in range(8):
        keys = rng.standard_normal((EM_CHUNK, H * Dh)).astype(np.float32)
        s = _em_surprise(rng, EM_CHUNK) + (rng.random(EM_CHUNK) > 0.98) * 5.0
        tr = [[], []]
        sp = [segment_events(torch.as_tensor(keys, device=d), s, min_event=EM_EVENT // 4, trace=t)
              for d, t in ((dev, tr[0]), ("cpu", tr[1]))]
        n_bounds += len(tr[1])
        ok, tie = _seg_agrees(*tr)
        spans_same += sp[0] == sp[1]
        ties += tie
        if not (sp[0] == sp[1] or (ok and tie)):
            fails.append(f"phase s3: chunk {c} spans {sp[0]} on the card, {sp[1]} on the CPU")
    out["s3 segment_events"] = dict(chunks=8, boundaries=n_bounds, same_spans=spans_same, ties=ties)

    # s4: the full-width stream
    att = EMLLMAttention(H, Dh, local_window=EM_WINDOW, event_len=EM_EVENT, k_sim=EM_K_SIM,
                         k_contig=EM_K_CONTIG, device=dev)
    gd = torch.Generator(device=dev).manual_seed(13)
    n_chunks, needle_at = EM_TOKENS // EM_CHUNK, EM_TOKENS // EM_CHUNK // 3
    walls = []
    sync()
    t_all = time.time()
    for c in range(n_chunks):
        K = 0.1 * torch.randn((EM_CHUNK, H, Dh), generator=gd, device=dev)
        V = 0.1 * torch.randn((EM_CHUNK, H, Dh), generator=gd, device=dev)
        if c == needle_at:
            K[:, :, 1] += 8.0
            V.fill_(7.0)
        s = _em_surprise(rng, EM_CHUNK)
        sync()
        t0 = time.time()
        att.ingest(K, V, s)
        sync()
        walls.append(time.time() - t0)
    stream_s = time.time() - t_all
    Q = torch.zeros((1, H, Dh), device=dev)
    Q[:, :, 1] = 8.0
    ids = att.memory.retrieve(Q, EM_K_SIM, EM_K_CONTIG)
    got = att.attend(Q)
    recall = float(got.mean())
    attend_ms = cuda_ms(torch, lambda: att.attend(Q), 10)
    qb = 0.1 * torch.randn((EM_CHUNK, H, Dh), generator=gd, device=dev)
    retrieve_ms = {m: cuda_ms(torch, lambda: att.memory.retrieve(qb, EM_K_SIM, EM_K_CONTIG, mode=m), 5)
                   for m in ("reps", "full")}
    kbuf = att.memory._k
    K = 0.1 * torch.randn((EM_CHUNK, H, Dh), generator=gd, device=dev)
    prof = busy(lambda: (att.ingest(K, K, _em_surprise(rng, EM_CHUNK)), att.attend(qb)))
    out["s4 EMLLMAttention, 128K tokens"] = dict(
        tokens=EM_TOKENS, chunk=EM_CHUNK, events=len(att.memory), needle_chunk=needle_at,
        retrieved_ids=ids, recall_mean=recall, stream_s=stream_s,
        ingest_ms_median=1e3 * float(np.median(walls)), ingest_ms_p90=1e3 * float(np.percentile(walls, 90)),
        attend_ms=attend_ms, retrieve_ms_512_queries=retrieve_ms,
        memory_bytes=sum(t.numel() * t.element_size() for t in (kbuf, att.memory._v, att.memory._reps)),
        memory_capacity_events=kbuf.shape[0], device_bytes_allocated=torch.cuda.memory_allocated(),
        profiled_ingest_and_attend=prof)
    if not (np.isfinite(got.cpu().numpy()).all() and recall > 3.0):
        fails.append(f"phase s4: the needle was not recalled: {out['s4 EMLLMAttention, 128K tokens']}")
    del att, kbuf

    # s5: the sharded similarity stage, one NCCL rank per card (at most 4)
    world = min(torch.cuda.device_count(), 4)
    if world == 1:
        from hebo_tpu_torch.parallel import make_mesh

        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        try:
            out["s5 retrieve_sharded"] = em_sharded(torch, make_mesh(axis="mem", device="cuda"), fails)
        finally:
            dist.destroy_process_group()
    else:
        with tempfile.TemporaryDirectory() as d:
            torch.multiprocessing.start_processes(_em_retrieve_rank, args=(world, str(Path(d) / "store"), d),
                                                  nprocs=world, join=True, start_method="spawn")
            ranks = [json.loads(Path(d, f"rank{r}.json").read_text()) for r in range(world)]
        for r, res in enumerate(ranks):
            fails.extend(f"rank {r}: {f}" for f in res.pop("fails"))
        out["s5 retrieve_sharded"] = ranks[0]
    for name, r in out.items():
        print(f"phase {name}:", json.dumps(r), flush=True)
    return out


class GridLaunches:
    """K5's grid-route launches (``nsga2_rank_crowd.grid_launches``) as a
    wrapper's ``launches``, so that they are reset and read with the rest."""

    def __init__(self, k5):
        self.k5 = k5

    launches = property(lambda self: self.k5.grid_launches,
                        lambda self, n: setattr(self.k5, "grid_launches", n))


def kernel_wrappers():
    """The kernels' wrappers, by name; each counts its launches (K5's grid
    route: those of ``nsga2_rank_crowd`` that took it)."""
    from hebo_tpu_torch.ops import chol_kernel as ck
    from hebo_tpu_torch.ops import gram, pareto, ssk

    return {"matern32_gram": gram.matern32_gram, "matern32_gram_vjp": gram.matern32_gram_vjp,
            "chol_factor": ck.chol_factor, "chol_winv": ck.chol_winv,
            "chol_factor_inv": ck.chol_factor_inv, "ssk_cross": ssk.ssk_cross,
            "ssk_self": ssk.ssk_self, "nsga2_rank_crowd": pareto.nsga2_rank_crowd,
            "nsga2_rank_crowd_grid": GridLaunches(pareto.nsga2_rank_crowd)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "hebo_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: hebo_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from hebo_tpu_torch import HEBO, DesignSpace
    from hebo_tpu_torch.bench.gram_probe import device_per_call
    from hebo_tpu_torch.bench.ssk_probe import device_us
    from hebo_tpu_torch.models.gp.gp import GP
    from hebo_tpu_torch.ops import chol_kernel as ck
    from hebo_tpu_torch.ops import gram, native, pareto, ssk
    from hebo_tpu_torch.optimizers import AntBOOptimizer
    from hebo_tpu_torch.tasks import AbsolutTool
    from hebo_tpu_torch.utils.dtypes import pad_bucket

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    t0 = time.time()
    logs = native.build()
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    fails = []
    check_ptxas(logs, fails)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g_rows = check_gram(torch, gram, device_per_call, dev, gen, fails)
    v_rows = check_gram_vjp(torch, gram, device_per_call, dev, gen, fails)
    f_rows, w_rows, fu_rows = check_chol(torch, ck, dev, gen, fails)
    ladder = check_ladder(torch, ck, dev, gen, fails)
    p_rows = check_pareto(torch, pareto, device_us, dev, fails)
    c_rows, s_rows = check_ssk(torch, ssk, device_us, dev, fails)
    check_chol_api(torch, ck, dev, gen, fails)
    for name, rows in (("matern32_gram", g_rows), ("matern32_gram_vjp", v_rows),
                       ("chol_factor", f_rows), ("chol_winv", w_rows), ("chol_factor_inv", fu_rows),
                       ("ssk_cross", c_rows), ("ssk_self", s_rows), ("nsga2_rank_crowd", p_rows)):
        for r in rows:
            print(f"kernel {name}", json.dumps(r), flush=True)
    print("kernel matern32_gram / matern32_gram_vjp / ssk_cross / ssk_self: library_ms null, "
          "no single PyTorch call computes the Matérn Gram, its VJP or the string-subsequence DP",
          flush=True)

    wrappers = kernel_wrappers()
    # each path is driven with every count at 0 and read just after
    # (K1a's and K1b's counts take the fused call's too: it runs both; the
    # paths whose buckets reach 8 tiles must launch the fused call itself)
    paths = {
        "hebo": (lambda: run_phases(torch, HEBO, DesignSpace, wrappers, fails),
                 ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                  "nsga2_rank_crowd", "nsga2_rank_crowd_grid")),
        "antbo": (lambda: antbo_phases(torch, AntBOOptimizer, AbsolutTool, pad_bucket, fails),
                  ("ssk_cross", "ssk_self", "chol_factor", "chol_winv")),
        "hebo_large_n": (lambda: large_n_phases(torch, HEBO, DesignSpace, GP, wrappers, fails),
                         ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                          "nsga2_rank_crowd")),
        "hebo_options": (lambda: options_phase(torch, HEBO, DesignSpace, wrappers, fails),
                         ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                          "nsga2_rank_crowd")),
        "hebo_inference": (lambda: inference_phase(torch, HEBO, DesignSpace, wrappers, fails),
                           ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                            "nsga2_rank_crowd")),
        "gp_thompson": (lambda: thompson_phase(torch, DesignSpace, GP, ck, wrappers, fails),
                        ("matern32_gram", "chol_factor", "chol_winv", "chol_factor_inv")),
        "mcbo_presets": (lambda: mcbo.update(mcbo_phase(torch, DesignSpace, wrappers, fails)),
                         ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                          "ssk_cross", "ssk_self", "nsga2_rank_crowd")),
        "optimizer_family": (lambda: family.update(family_phase(torch, DesignSpace, wrappers,
                                                                fails)),
                             ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv",
                              "nsga2_rank_crowd")),
        "gp_variants": (lambda: variants.update(variants_phase(torch, HEBO, DesignSpace, wrappers,
                                                               fails)),
                        ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv",
                         "nsga2_rank_crowd")),
        "model_families": (lambda: families.update(model_families_phase(torch, HEBO, DesignSpace,
                                                                        wrappers, fails)),
                           ("chol_factor", "chol_winv", "nsga2_rank_crowd")),
        "mesh": (lambda: mesh.update(run_mesh(torch, HEBO, DesignSpace, GP, wrappers, fails)),
                 ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv", "chol_factor_inv",
                  "nsga2_rank_crowd")),
        "latent": (lambda: latent.update(latent_phase(torch, DesignSpace, wrappers, fails)),
                   ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv",
                    "nsga2_rank_crowd")),
        "tasks": (lambda: tasks.update(tasks_phase(torch, DesignSpace, wrappers, fails)),
                  ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv",
                   "ssk_cross", "ssk_self", "nsga2_rank_crowd")),
        "experiment": (lambda: experiment.update(experiment_phase(torch, wrappers, fails)),
                       ("matern32_gram", "matern32_gram_vjp", "chol_factor", "chol_winv",
                        "nsga2_rank_crowd")),
        # the RL and PO training loops run no kernel of the port (plain ops,
        # as flax layers and jnp are in the JAX package)
        "rl": (lambda: rl_phase(torch, fails), ()),
        "sparse_po": (lambda: sparse_po_phase(torch, fails), ()),
        # EM-LLM's memory path is torch products (jnp and numpy in the JAX
        # package, no pallas_call behind them)
        "emllm": (lambda: emllm_phase(torch, fails), ()),
    }
    mcbo, family, variants, families, mesh, latent, tasks = {}, {}, {}, {}, {}, {}, {}
    experiment = {}
    by_path = {}
    for path, (drive, its_kernels) in paths.items():
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        drive()
        # phase m reads its path's counts itself, before its comparisons
        by_path[path] = (mesh["launches"] if path == "mesh" else
                         {k: w.launches for k, w in wrappers.items()})
        print(f"main path {path}: {time.time() - t0:.1f} s, launches {json.dumps(by_path[path])}",
              flush=True)
        for k in its_kernels:
            if launched(by_path[path], k) == 0:
                fails.append(f"{k}: no launch on the {path} path")
    for p in (mcbo, family, variants, families, mesh, latent, tasks, experiment):
        check_path_shapes(torch, gram, ssk, ck, pareto, p["shapes"], dev, fails)
    vae_card_vs_cpu(torch, fails)

    main_shape = {"matern32_gram": [2, 1024, 1024, 6], "matern32_gram_vjp": [2, 1024, 1024, 6],
                  "chol_factor": [2, 1024], "chol_winv": [2, 1024], "chol_factor_inv": [2, 1024],
                  "ssk_cross": [1, 256, 256, 11, 3], "ssk_self": [1, 256, 11, 3],
                  "nsga2_rank_crowd": [200, 3], "nsga2_rank_crowd_grid": [1400, 3]}
    meta = {
        "matern32_gram": ("hebo_tpu_torch/csrc/gram.cu", "hebo_tpu/ops/pallas_gram.py:87", g_rows),
        # the JAX package's VJP is XLA-fused jnp (no pallas_call) at :128-133
        "matern32_gram_vjp": ("hebo_tpu_torch/csrc/gram.cu", "hebo_tpu/ops/pallas_gram.py:128", v_rows),
        "chol_factor": ("hebo_tpu_torch/csrc/chol.cu", "hebo_tpu/ops/pallas_chol.py:613", f_rows),
        "chol_winv": ("hebo_tpu_torch/csrc/chol.cu", "hebo_tpu/ops/pallas_chol.py:665", w_rows),
        # one launch pair for both of chol_inv_slab's pallas_calls (:613 and :665)
        "chol_factor_inv": ("hebo_tpu_torch/csrc/chol.cu", "hebo_tpu/ops/pallas_chol.py:613", fu_rows),
        "ssk_cross": ("hebo_tpu_torch/csrc/ssk.cu", "hebo_tpu/ops/pallas_ssk.py:148", c_rows),
        "ssk_self": ("hebo_tpu_torch/csrc/ssk.cu", "hebo_tpu/ops/pallas_ssk.py:167", s_rows),
        # the JAX package peels in an XLA while_loop (no pallas_call) at :45-78
        "nsga2_rank_crowd": ("hebo_tpu_torch/csrc/pareto.cu", "hebo_tpu/ops/pareto.py:45", p_rows),
        # its grid route, past the one CTA's rows (nsga2_grid_* kernels)
        "nsga2_rank_crowd_grid": ("hebo_tpu_torch/csrc/pareto.cu", "hebo_tpu/ops/pareto.py:45",
                                  [r for r in p_rows if r["route"] == "grid"]),
    }
    kernels = []
    for name, (src, rep, rows) in meta.items():
        r = next(r for r in rows if r["shape"] == main_shape[name])
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
            **({"device_us": r["device_us"]} if "device_us" in r else {}),
            **({"k3_route": r["route"], "k3_routes": sorted({x["route"] for x in rows})}
               if name.startswith("ssk_") else {}),
            **({"tile_rows": r["tile_rows"]} if "tile_rows" in r else {}),
            **({"k5_route": r["route"], "k5_routes": sorted({x["route"] for x in rows}),
                "device_launches_per_call": r["device_launches_per_call"]}
               if name.startswith("nsga2") else {}),
            **({"smc": next(x for x in rows if x["shape"] == [32, 1024, 1024, 6])}
               if name == "matern32_gram_vjp" else {}),
            **({"skipped_rung_ms": ladder["skipped_rung_ms"],
                "skipped_rung_5051_ms": ladder["skipped_rung_5051_ms"],
                "k1a_route": r["route"], "k1a_routes": sorted({x["route"] for x in rows}),
                "bocs_5051": next(x for x in rows if x["shape"] == [1, 5051])}
               if name == "chol_factor" else {}),
            **({"also_replaces": "hebo_tpu/ops/pallas_chol.py:665", "skipped": ladder["skipped_fused"],
                "device_launches_per_call": r["device_launches_per_call"],
                "bocs_5051": next(x for x in rows if x["shape"] == [1, 5051]),
                "hebo_cache_1024": next(x for x in rows if x["shape"] == [1, 1024])}
               if name == "chol_factor_inv" else {}),
            **({"skipped": ladder["skipped_winv"], "k1b_route": r["route"],
                "k1b_routes": sorted({x["route"] for x in rows}),
                "bocs_5051": next(x for x in rows if x["shape"] == [1, 5051])}
               if name == "chol_winv" else {}),
            **({"mesh_shapes": [x for x in rows if tuple(x["shape"]) in MESH_K1[name]]}
               if name in MESH_K1 else {}),
        })
    if fails:
        print("FAILED:\n  " + "\n  ".join(fails), flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
