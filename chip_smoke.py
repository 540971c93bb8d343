#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's lane paths and its XLA engine on one NVIDIA card and
check them.

    python3 chip_smoke.py            # from the repository root, on a machine with a card

The paths are bench.py's paper workload (run_paper_closed_loop_lanes: K1-K4; also with one θ
shared by the lanes, population=True, and sharded over a one-rank NCCL device mesh), its
BENCH_MODE=coupled workload (run_generic_closed_loop_lanes with adapt_nominal: K1, K2
and the generic and coupled variants K5, K6 of the sensitivity kernels), its
BENCH_SYSTEM families, the double integrator, the planar quadrotor and the cart-pole
on the paper loop (K1-K4 built for each system; presets.family_paper_setup), and the
port's CLI (python -m tube_mpc_tpu_torch.run_experiment) on the shipped configs, the
families' in coupled mode (K1, K2 and K5/K6 built for each system), and on four configs
derived from them that take the lane engine's other branches, the exact-min obstacle
aggregation and the log barrier (MINLOG: K1-K6 built for each in a library of its own), and
the scenario layer (tube_mpc_tpu_torch.parallel: tube verification on both engines, the
population Algorithm 2 on the XLA engine, with and without a mesh). Phases, each of which fails the run (non-zero exit, no result line) if it fails:

1. device:   the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build:    nvcc builds the three kernel sources for each of the four systems (eight
             kernel variants each; float and double, each once for each obstacle count,
             1 to 8, the cart-pole's once) from csrc/, and for each MINLOG variant,
             twenty-four libraries in parallel, and prints each instantiation's registers
             and spills;
3. kernels:  each kernel variant against its plain PyTorch version on the same
             inputs, at the main paths' shapes (B=16384, N=50, n̂=4, m=2, nα=7) in
             f64 and in f32. The inputs are those of a real closed-loop step (after
             three disturbed steps, so that the lanes differ): of the paper setup for
             K1-K4, of the coupled setup for K5/K6; some ancillary controls must lie
             at a bound in each, so that the active set runs (where a family's step
             has none, K3 is also held with the controls clamped to their quartiles,
             which become the bounds). Every variant (K2 also
             at nα=1, the rollout's shape) is also held at a ragged shape, the first
             1000 lanes and 37 steps of the same inputs, and there with 1 and with 8
             obstacles (each kernel is built for each count), and with 8 obstacles at
             the main shape too. Each variant is timed with CUDA events over 20
             launches back to back, in f64 and in f32, and so are K2 at nα=1 and every
             variant with 8 obstacles at the main shape, first and with nothing else on
             the card; then CHECKERS processes hold the kernels against their plain
             versions on the card (a plain version's time: its check's one call there),
             while this one runs the loop64 and xla64 phases; a bound's operations are
             counted by a
             CPU worker;
   kernels_<family>, for each family: K1-K4 against their plain versions as in phase 3,
             on the inputs of a closed-loop step of the family's setup at B=16384, N=50
             in f64 and f32, each timed; also at B=1000, N=37, there with 1 and 8
             obstacles for the families that have obstacles; the double integrator's and
             the cart-pole's K4 (SFWD_STAGED, also in their MINLOG configurations) exactly,
             and also at B=1000 on its first 1, 2 and 4 steps and with K, kff or X not
             finite on four lanes of one warp (sfwd_edge_inputs), each check's difference
             in its kernel's max_abs_err;
   kernels_<family>_generic: the same for K5/K6 on a coupled step of the family's
             config with adaptation.adapt_nominal: true (coupled_setup); a backward
             sweep whose inputs have no control at a bound is also held with the
             controls clamped to their quartiles;
   kernels_<family>_cli: K1, K2 (also at nα=1) and K5/K6 on such a step at B=16384 and
             the N of the family's config (30, 200, 40), the shapes the cli phase
             gives them, in f32 as the CLI runs, each timed;
   kernels_<variant>, for each MINLOG configuration: its library's K1-K4 on a paper step
             and K5/K6 on a coupled step of the configuration at B=16384 and its own N
             (50, 30, 200, 40), in f64 and f32, each timed, and at B=1000, N=37, there
             with 1 and 8 obstacles where
             the system has circles; and every kernel with the branch lanes
             (branch_checks: lanes on the bisector of two equal obstacles, where the min
             chain ties, and lanes with h - tight < eps, where the log barrier's tangent
             is 0), whose counts are printed and must not be 0 where the library has the
             branch;
4. loop64:   a short f64 paper loop (B=256, N=50, H=5) through the kernels on the
             card and through the plain versions on the CPU, held at the tolerances
             of tests/test_lane_closed_loop.py:45-50;
5. loop64_coupled: the same for the coupled loop, held at the tolerances of
             tests/test_lane_generic.py:88-95, 219-225, with the final raw parameters;
   loop64_<family>: phase 4 on each family's setup. Where the card parts from the CPU
             on a chaotic loop (CHAOTIC: the cart-pole's f64 swing-up, where a 1e-15
             perturbation of its start and disturbances grows to O(1) within five steps
             on the CPU alone), the card must agree with the CPU on the steps on which
             the CPU agrees with itself under that perturbation (at least one), and the
             loop through the kernels must agree with the loop through the plain
             versions on the card on every step;
   loop64_<family>_coupled: the same for the family's coupled loop (coupled_setup),
             with the final raw parameters. The CPU's side of every loop64 phase (and
             of a chaotic one's perturbed run) runs in a worker process (cpu_loop64),
             all of them beside the card's phases;
   loop64_dubins_min_log, loop64_cartpole_log_coupled: phases 4 and 5 on the Dubins
             min + log configuration's paper loop and the cart-pole log one's coupled loop;
   loop64_population: phase 4 with population=True (one θ shared by the lanes);
   xla64_paper, xla64_coupled: the feature-major (XLA) engine (tube/closed_loop.py, batched
             PyTorch operations; the JAX package's XLA path reaches no pl.pallas_call, so it
             has no kernel here) on phases 4's and 5's setups (the coupled one with the
             gradient clip off), f64 at B=256, N=50, H=5: the card against the same loop on
             the CPU (a worker process) at tests/test_closed_loop.py:139-143's tolerances,
             and against the lane engine's loop on the card at the lane tolerances;
6. main:     the full-width paper path, B=16384, N=50, H=300 in f32, disturbances
             from a seeded torch.Generator on the card; every paper kernel must have
             launched in this run (the launch counts are set to 0 just before it), K3
             and K4 exactly H times, and at least 99% of the lanes must end with a
             finite loss;
7. coupled:  the full-width coupled path at the same B, N, H in f32 (the counts set to
             0 again just before it): K1 and K2 launched, each K5/K6 variant exactly
             H times, at least 99% of the lanes finite, and the nominal tightening
             moved on some lane (the coupled chain ran);
   compact:  straggler compaction (lane_ilqr_solve's compact_caps) on the runs of phases 6
             and 7, with bench.py's default caps (COMPACT_CAPS): every log field bitwise
             equal to the uncompacted run's, the launches of K1 and K2 by width and the
             compacted and full-width stages of each loop (at least one compacted stage in
             all), the walls of both versions, each run once more after the phase's
             first (AB_ORDER: compacted, then uncompacted); the paper loop once more through the step with
             iter_telemetry (each lane's iterations a solve); K1 and K2 timed at the
             stages' widths (COMPACT_WIDTHS);
   main_<family>: the full-width paper path of each family, B=16384, N=50, H=300 in f32
             (the counts set to 0 just before each): K1-K4 launched, K3 and K4 exactly
             H times, at least 99% of the lanes finite;
   prng:     the JAX package's threefry draws in the port (utils/prng.py; batched PyTorch
             operations, as JAX computes them with XLA operations, no kernel): (a) bench.py's
             draw, sample_disturbance(PRNGKey(0), (B, H)) in f32, of each family's setup on
             the card, bitwise the same draw on the CPU (a worker process) and the JAX
             package's (PRNG_JAX_SHA256, its SHA-256); (b) the cart-pole's paper loop on its
             draw at full width: finite_lane_frac (>= 0.99), its lanes not finite and each
             one's first step not finite; (c) the XLA engine's sequential Riccati sweep in
             f32 on the quadrotor's first nominal iteration (N=200): its gains within
             PRNG_K_TOL of the exact recursion (V_xx kept symmetric);
   population: the full-width paper path with population=True (B=16384, N=50, H=300, f32;
             the counts set to 0 just before it): K1-K4 launched from Dubins' libraries, K3
             and K4 exactly H times, at least 99% of the lanes finite, the logged θ the same
             on every lane at every step and moved from its start; wall, ms a step, solves/s;
   scenarios: parallel.tube_verification with the lane kernels (sys_c) at the same size
             (K1-K4 launched, K3/K4 H times although lr = 0), and on the XLA engine at
             XLA_H, and run_population_adaptation (mesh=None) at B=16384, XLA_H: finite
             statistics (the collision rate printed), θ frozen in the verification and moved
             in the adaptation; run_population_adaptation in f64 at POP64_B, N, POP64_H, the
             card against the CPU (a worker process) at the XLA loop's tolerances;
   sharded:  over a one-rank NCCL mesh (parallel.init_distributed on tcp://localhost,
             make_mesh): run_paper_closed_loop_lanes_sharded, independent and population, at
             B=16384, N=50, H cut to SHARD_H, bitwise the unsharded loop; the same with
             ckpt_dir at SHARD_H/2 a segment, and resumed after its last segment's files are
             deleted, bitwise; run_population_adaptation over the mesh bitwise mesh=None's;
8. cli:      the port's CLI in-process at --batch 16384 on configs/dubins.yaml and on a
             coupled copy of each family's config, at each config's own N and H
             (cli_phase: artifacts, summary keys, each run's kernels launched from its
             own system's libraries);
   cli_minlog: the same on the four MINLOG configurations, each as derived and in its
             other mode (adapt_nominal flipped), so that every kernel of each library
             runs, each run's kernels launched from its own variant's libraries only;
   cli_ckpt: the CLI with --checkpoint-every on configs/dubins.yaml and a coupled config at
             --batch 16384, and on the XLA engine for one trajectory: run, killed after a
             segment (its last files deleted) and resumed through --run-dir, its artifacts
             bitwise those of the run without checkpoints;
   cli_profile: the CLI with --profile on dubins.yaml at --batch 16384, H cut to
             PROFILE_CLI_H: its trace must name the ric and fwd device kernels;
   xla:      the XLA engine at full width in f32 (B=16384): the Dubins paper loop (N=50)
             and the cart-pole's coupled loop (its config's N=40), H cut to XLA_H (the cut is
             printed): wall, ms and iLQR iterations a step, solves/s, peak memory,
             finite_lane_frac (>= 0.99), the device's busy share over one profiled step, and
             one timed nominal solve from zero controls (its iterations);
   cli_xla:  python -m tube_mpc_tpu_torch.run_experiment --engine xla in-process on
             configs/dubins.yaml as shipped (f32, --batch 1024) and with use_float64 and
             adapt_nominal (--batch 64), H cut to XLA_CLI_H; run_nominal (H cut to
             XLA_NOMINAL_H) and gradient_check at its defaults: artifacts, summary keys, the
             f64 run's dtype;
   pscan:    the XLA engine's horizon-parallel sweep (solvers/pscan.py, ILQRConfig(
             horizon_parallel=True); batched PyTorch operations, no kernel): (a) its functions
             in f64 at PSCAN_B lanes on random LQ problems (PSCAN_SHAPES, N up to 1024) against
             the sequential sweep, the exact-elimination recursion (which holds the sequential
             sweep too) and the loop on the card, and against the same calls on the CPU; (b) the f64 nominal solves of Dubins
             (against horizon_parallel=False and the CPU) and of the quadrotor at N=200
             (against the CPU); (c) the Dubins and quadrotor nominal solves at B=16384 in f32,
             both forms (iterations, ms, peak memory, finite lanes >= 0.99, their difference);
             (d) both sweeps' wall, event and device times and device kernels a call on
             benchmarks/bench_pscan.py's points (PSCAN_TIMES), with the card's power limit;
9. profile:  torch.profiler over five full-width steps of the Dubins paths: the device's
             busy share and the device time of each kernel variant and of PyTorch's
             own kernels.

Then it prints the `kernels` JSON line (launches from the main path for K1-K4, from
the coupled path for K5/K6, from main_<family> for each family's K1-K4 and from cli for
its K5/K6, named `<kernel>_<family>`; each row's times and bound at B=16384, N=50; and
each MINLOG variant's kernels, `<kernel>_<variant>`, launched by cli_minlog, at the
configuration's N), the
card's name and power limit, and, as the last line,
{"ok": true, "device": {...}}. With no card it exits non-zero at once. It takes no
arguments: every size is fixed below, so a result line always stands for the whole
run at full width.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and float32 / float64 outside
# the tensor cores (132 SMs x 128 or 64 lanes x 2 x 1.98 GHz). count_ops counts a
# multiply and an add as one operation each, as the peak does, which pairs them into
# one fused multiply-add. The kernels are built with -fmad=false, to round as their
# plain versions do, so they issue no FMA and reach at most half that rate: the log
# line shows the time at that rate beside the bound, which stays at the card's peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

SEED = 0  # every random number here comes from torch.Generator seeded from it, but the
          # prng phase's and the CLI runs' (bench.py's and the configs' threefry keys)

B, N, H = 16384, 50, 300  # the main paths: bench.py's paper and coupled workloads, full width and depth
RAGGED_B, RAGGED_N = 1000, 37  # every kernel also here: B not a multiple of 32, N not of 3
RUNS = 20                 # timed runs per kernel (a plain version: by its check's one call)
LOOP64_B, LOOP64_H = 256, 5
PROFILE_H = 5

# bench.py's BENCH_SYSTEM families (bench.py:143-181) on the paper loop
FAMILIES = ("double_integrator", "quadrotor2d", "cartpole")
# The lane engine's other branches, the exact-min aggregation and the log barrier: four
# configurations derived from the shipped ones, each its own library variant (_build.VARIANTS):
# variant -> (file, {"section.key": value, None to delete the key}). Each runs at its file's
# N and H; the double integrator's, without the key, takes EnvironmentConfig's default, "min".
MINLOG = {
    "dubins_min_log": ("configs/dubins.yaml", {"environment.obstacle_aggregation": "min",
                                               "dbas.barrier_type": "log"}),
    "double_integrator_min": ("configs/double_integrator.yaml",
                              {"environment.obstacle_aggregation": None,
                               "adaptation.adapt_nominal": True}),
    "quadrotor2d_min_log": ("configs/quadrotor2d.yaml",
                            {"environment.obstacle_aggregation": "min",
                             "dbas.barrier_type": "log", "adaptation.adapt_nominal": True}),
    "cartpole_log": ("configs/cartpole.yaml", {"dbas.barrier_type": "log",
                                               "adaptation.adapt_nominal": True}),
}
# The obstacles of the branch checks: a lane at px = 5 lies on their bisector, where the min
# chain's two sides tie (weights 1/2); at (5, 5) also h = 0, below eps.
TIE_CENTERS = ((4.0, 5.0), (6.0, 5.0))
# the extra obstacles of the 8-obstacle instantiation checks (each system's own come first)
EXTRA_CENTERS = ((2.0, 8.0), (8.0, 2.0), (5.0, 9.0), (9.0, 5.0), (1.0, 6.5), (6.5, 1.0))

SBWD, SFWD = "tube_mpc_tpu_torch/csrc/lane_sbwd.cu", "tube_mpc_tpu_torch/csrc/lane_sfwd.cu"
KERNELS = {
    # name: (source, the Pallas kernel it replaces, the CUDA kernel and its template flags)
    "ric": ("tube_mpc_tpu_torch/csrc/lane_solver.cu", "tube_mpc_tpu/ops/pallas/lane_solver.py:78",
            "ric_kernel", ""),
    "fwd": ("tube_mpc_tpu_torch/csrc/lane_solver.cu", "tube_mpc_tpu/ops/pallas/lane_solver.py:196",
            "fwd_kernel", ""),
    "sbwd": (SBWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48", "sbwd_kernel", ", false, false"),
    "sfwd": (SFWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:172", "sfwd_kernel", ", false, false"),
    "sbwd_generic": (SBWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48", "sbwd_kernel",
                     ", true, false"),
    "sbwd_upper": (SBWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:48", "sbwd_kernel",
                   ", true, true"),
    "sfwd_generic": (SFWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:172", "sfwd_kernel",
                     ", true, false"),
    "sfwd_ref": (SFWD, "tube_mpc_tpu/ops/pallas/lane_sensitivity.py:172", "sfwd_kernel",
                 ", true, true"),
}
# Rows of the const block C [2n̂+m+3, B] that a kernel reads, where not all: K4 and the
# generic K6 read only the barrier parameters (alpha, gamma, tight); the bound counts no other.
C_ROWS_READ = {"sfwd": 3, "sfwd_generic": 3}
PAPER = ("ric", "fwd", "sbwd", "sfwd")
COUPLED = ("sbwd_generic", "sbwd_upper", "sfwd_generic", "sfwd_ref")

# Kernel against plain version: (rtol, atol as a fraction of the largest finite |value| of
# the same output row, i.e. the same component index across steps and lanes, so that the
# barrier rows, which reach 1/eps and more, set no tolerance for the position rows).
# f64: the CPU tests' tolerances (tests/test_torch_lane_solver.py, test_torch_lane_sensitivity.py;
# K5/K6 have K3/K4's).
# f32: the two run the same operations in the same order (-fmad=false), so they differ only
# where the card's math library rounds sin/cos/exp/log differently inside a kernel than in
# PyTorch's; the Riccati recursions carry such a last-bit difference over 50 steps, so 1e-4
# of the row's scale holds what f32 can promise. Where the plain output is not finite, the
# kernel's must be the same (NaN where NaN, the same infinity) in either type.
TOL = {
    "float64": {"ric": (1e-12, 1e-12), "fwd": (1e-12, 1e-12),
                **{k: (1e-9, 1e-11) for k in ("sbwd", "sfwd") + COUPLED}},
    "float32": {k: (1e-4, 1e-4) for k in KERNELS},
}
LOOP_TOL = {  # tests/test_lane_closed_loop.py:45-50
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-8), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-8, 1e-11), "R_hist": (1e-8, 1e-11), "qb_hist": (1e-8, 1e-11),
}
COUPLED_LOOP_TOL = {  # tests/test_lane_generic.py:88-95, 219-225; the final raw parameters
    "x_real": (1e-7, 1e-8), "u_real": (1e-7, 1e-8), "x_bar": (1e-7, 1e-8),
    "u_bar": (1e-7, 1e-7), "b_real": (1e-7, 1e-8), "loss": (1e-7, 1e-8),
    "Q_hist": (1e-7, 1e-10), "R_hist": (1e-7, 1e-10), "qb_hist": (1e-7, 1e-10),
    "raw_aux": (1e-7, 1e-10), "raw_nom": (1e-7, 1e-10),
}
# The feature-major (XLA) engine, tube/closed_loop.py: batched PyTorch operations, no
# kernel of its own. xla64: f64 loops at LOOP64_B, N, LOOP64_H on the card against the
# CPU (the closed-loop tolerances of tests/test_closed_loop.py:139-143) and against the lane
# engine on the card (LOOP_TOL, COUPLED_LOOP_TOL). xla: full width, f32, H cut to XLA_H so
# that both runs take about a minute (a step is ~10^5 small operations). cli_xla: the CLIs
# on the XLA engine, the experiment's H cut to XLA_CLI_H and run_nominal's to
# XLA_NOMINAL_H.
XLA_LOOP_TOL = {**{k: (1e-6, 1e-8) for k in ("x_real", "u_real", "x_bar", "u_bar", "b_real")},
                **{k: (1e-5, 1e-8) for k in ("loss", "Q_hist", "R_hist", "qb_hist",
                                              "raw_aux", "raw_nom")}}
XLA_CASES = {"paper": SEED + 90, "coupled": SEED + 91}   # xla64's loops: their draws' seeds
XLA_H = 2                      # ~2-3 s a paper step, ~0.8 s a cart-pole coupled step
XLA_FAMILY = "cartpole"        # the xla phase's coupled loop: m = 1, Jacobians by autodiff
XLA_CLI_H, XLA_NOMINAL_H = 2, 10
# The horizon-parallel sweep (phase pscan: solvers/pscan.py, ILQRConfig.horizon_parallel;
# batched PyTorch operations, no kernel, as the JAX package's reaches no pl.pallas_call).
# (a) random LQ problems (tests/test_pscan.py:22-39's recipe) at PSCAN_B lanes, f64, at
# (n̂, nu, N); tolerances of tests/test_pscan.py:47-49, 74-75, 89 and, card against CPU,
# tests/test_ilqr.py:196-197. The scan's gains and the sequential sweep's are each held
# against the exact-elimination recursion's and against each other at every N (the
# sequential sweep keeps V_xx symmetric, so at long N it stays with the exact elimination
# where the JAX package's split update parts from it; tests/test_torch_riccati_symmetry.py).
PSCAN_B = 64
PSCAN_SHAPES = ((4, 2, 17), (5, 1, 32), (7, 2, 50), (4, 2, 1024))
PSCAN_TOL = {"gains": (1e-7, 1e-8), "values": (1e-7, 1e-9), "rollout": (1e-9, 1e-10),
             "cpu": (1e-7, 1e-9), "solve": (1e-5, 1e-7)}
PSCAN_SOLVES = ("dubins", "quadrotor2d")   # (b) the f64 nominal solves, B=PSCAN_B
PSCAN_DUBINS_N = 40        # (b) tests/test_pscan.py:94-117's Dubins OCP
# (d) bench_pscan.py's points, f32, n̂ = 4, nu = 2: headline (N = 50) and latency; a point's
# wall is the median of PSCAN_CALLS calls after a profiled warm-up, the sequential sweep's
# at N >= PSCAN_LONG_N of PSCAN_CALLS_LONG (0.4-2 s a call: ~90 launches a step), to hold
# the phase to ~60 s
PSCAN_TIMES = ((50, 64), (50, 1024), (50, 16384), (64, 1), (64, 64), (256, 1), (256, 64),
               (1024, 1), (1024, 64))
PSCAN_CALLS, PSCAN_CALLS_LONG, PSCAN_LONG_N = 5, 3, 256

# Straggler compaction (phase compact): bench.py's default caps of the ancillary solves
# (bench.py:205-227), the paper loop's without a gradient clip and the coupled loop's; the
# widths at which K1 and K2 are timed (the stages' at B, lane_solver.stage_widths).
PRNG_FAMILIES = ("dubins",) + FAMILIES
# phase prng (a): bench.py:267's draw, System.sample_disturbance(PRNGKey(0), (B, H), float32),
# of each family's bench.py setup in the JAX package (presets.dubins_paper_setup; for the
# others configs/<family>.yaml built in f32): the SHA-256 of its values as little-endian
# float32 in C order, as JAX 0.9.0 draws it eagerly on the CPU
PRNG_JAX_SHA256 = {
    "dubins": "a2f062d99dae988567e367f6cf29307119510f49ff703e2548225ee79c9eae03",
    "double_integrator": "4e3002fcc727c677b50e09ce33ce77ebfc2bda3959f356a81f4c09f2336ea7cd",
    "quadrotor2d": "e6353b5768b1bc542ed09a3028ccc90ce29522dbde7fb14ac3c219c88147ff1a",
    "cartpole": "b8d4f1482f090e286224b60f0bac13745e8a057a6b6a9d22729e638cb6bd143e",
}
PRNG_LOOP = "cartpole"     # phase prng (b): the paper loop run on its bench.py draw
PRNG_LANES_SHOWN = 20      # (b): the non-finite lanes printed, at most
PRNG_K_LANES = 64          # (c): the lanes of the quadrotor's first iteration swept
PRNG_K_TOL = 1e-3          # (c): max |K - K_exact| of the f32 sequential sweep on the card

COMPACT_CAPS = {"paper": (2, 5, 8), "coupled": (1, 3, 5)}
COMPACT_WIDTHS = (8192, 4096, 2048)
# phase compact runs each loop compacted, then uncompacted again, after the phase's own
# uncompacted run: by then the process is warm (its first run of four was not the slowest)
AB_ORDER = ("compacted", "uncompacted")
# Checkpoint and resume through the CLI (phase cli_ckpt): the segment of the lane runs, the
# family whose config runs there in coupled mode, and the XLA run's H (one segment a step).
CKPT_EVERY = 100
CKPT_COUPLED = "double_integrator"
XLA_CKPT_H = 2
PROFILE_CLI_H = 3   # phase cli_profile: the traced CLI run's H (cut from 300)

# The scenario layer (parallel/, the paper lane loop's population mode; phases population,
# loop64_population, scenarios, sharded): the sharded phase's H, cut from H so that its six
# lane runs over the one-rank mesh fit the time limit; run_population_adaptation's f64 check,
# the card against the CPU, at POP64_B scenarios and POP64_H steps.
SHARD_H = 100
POP64_B, POP64_H = 64, 2

# The systems whose f64 loop is chaotic over LOOP64_H steps: the cart-pole's swing-up (a
# 1e-15 perturbation of its start and disturbances grows to O(1) within five steps on the
# CPU alone). Only these are held by hold_loop64's rule for a chaotic loop.
CHAOTIC = ("cartpole",)


_CAPTURED = None   # in a checker process (hold_group): its log lines, returned to the main one


def log(msg: str) -> None:
    if _CAPTURED is not None:
        _CAPTURED.append(msg)
    else:
        print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_label(line: str) -> str:
    """ptxas names a kernel by its mangled symbol; write it as name<type, flags, system,
    obstacles> (an older build's as name<type, flags, obstacles>)."""
    from tube_mpc_tpu_torch.ops.lanes import FAMILIES

    def label(m):
        sym = m.group(0)
        k = re.match(r"_ZN4lane\d+(\w+?_kernel)I([fd])((?:L[bi]\d+E)*)E", sym)
        if not k:
            return sym
        args = ["float" if k[2] == "f" else "double"]
        ints = []
        for kind, v in re.findall(r"L([bi])(\d+)E", k[3]):   # a bool flag or an int
            if kind == "i":
                ints.append(v)
            else:
                args.append("true" if v == "1" else "false")
        if len(ints) == 2:   # the system's id and the obstacle count
            ints[0] = FAMILIES[int(ints[0])]
        return f"{k[1]}<{', '.join(args + ints)}>"
    return re.sub(r"_ZN4lane\w+", label, line)


def is_kernel(key: str, fn: str, args: str) -> bool:
    """Whether a profiler key ("void lane::fwd_kernel<float, 5>(...)") names the kernel
    `fn` with template arguments that begin with `args` ("float" or "float, true,
    false"); the name must follow "::", so that fwd_kernel does not match sfwd_kernel."""
    return re.search(rf"::{fn}<{re.escape(args)}[,>]", key) is not None


def device_time_ms(torch, fn, runs: int, warmup: int = 2) -> float:
    """Device time per call of `runs` calls made back to back, by CUDA events around
    all of them. The device first spins for ~25 ms (torch.cuda._sleep), long enough for
    the host to queue every call of a kernel wrapper (its checks, allocations and ctypes
    call, some 0.05-0.2 ms each), so the device then runs the kernels back to back and
    the time is the device's alone, also for a kernel that takes less time than its
    wrapper. A plain version queues one small kernel per operation, more than the spin
    covers, so its time stays the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)   # cycles, ~25 ms at the H100's 1.98 GHz
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def count_ops(torch, fn, args, lanes: int) -> int:
    """Arithmetic operations of a plain version on the first `lanes` lanes of its
    inputs: every elementwise arithmetic or comparison op counts one per element."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = {"add", "sub", "rsub", "mul", "div", "neg", "exp", "log", "sin", "cos", "abs",
               "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "where", "eq", "ne",
               "ge", "gt", "le", "lt", "isfinite", "isnan", "bitwise_or", "bitwise_and",
               "logical_or", "logical_and", "bitwise_not", "logical_not", "reciprocal",
               "_to_copy"}

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            if func.overloadpacket.__name__ in counted and isinstance(out, torch.Tensor):
                Counter.ops += out.numel()
            return out

    small = [t[..., :lanes].contiguous() if isinstance(t, torch.Tensor) else t for t in args]
    with Counter():
        fn(*small)
    return Counter.ops


OPS_LANES = 8   # the lanes on which a plain version's operations are counted


def io_bytes(name, inputs, outputs, nc: int) -> int:
    """The bytes the kernel `name` must move on B lanes: each input read once (of the const
    rows C [nc, B] only those it reads) and each output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    return nbytes - (nc - C_ROWS_READ.get(name, nc)) * B * outputs[0].element_size()


def bound_ms(nbytes: int, ops: int, dname: str):
    """(ms at the card's memory rate, ms at its peak rate for dname) of that work."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dname] * 1e3


def work_bound(torch, name, plain, inputs, outputs, nc: int):
    """(bytes, operations, ms at the card's memory rate, ms at its peak rate) of the kernel
    `name`'s work on B lanes: io_bytes, and the plain version's operations, counted on
    OPS_LANES lanes."""
    nbytes = io_bytes(name, inputs, outputs, nc)
    ops = count_ops(torch, plain, inputs, OPS_LANES) * (B // OPS_LANES)
    dname = str(outputs[0].dtype).replace("torch.", "")
    return (nbytes, ops, *bound_ms(nbytes, ops, dname))


def max_err(torch, got, ref, rtol, atol_frac):
    """(max |got - ref| where ref is finite, inf if got is not finite there; whether the
    outputs agree): where ref is finite, |got - ref| <= rtol |ref| + atol_frac * (largest
    finite |ref| of the element's row, dim -2); elsewhere got equals ref, or both are NaN."""
    worst, ok = 0.0, True
    if len(got) != len(ref):
        return float("inf"), False
    for g, r in zip(got, ref):
        fin = torch.isfinite(r)
        ra = torch.where(fin, r.abs(), torch.zeros_like(r))
        scale = ra.amax(dim=[d for d in range(r.ndim) if d != r.ndim - 2], keepdim=True)
        d = torch.where(fin, (g - r).abs().nan_to_num(nan=float("inf")), torch.zeros_like(r))
        within = d <= rtol * ra + atol_frac * scale
        same = (g == r) | (torch.isnan(g) & torch.isnan(r))
        ok = ok and bool(torch.where(fin, within, same).all())
        worst = max(worst, float(d.max()))
    return worst, ok


REG_SENS, ACTIVE_TOL = 1e-9, 1e-8   # the sensitivity's reg and active-set tolerance


def minlog_raw(variant):
    """The YAML of a MINLOG configuration, as plain values."""
    from tube_mpc_tpu_torch.utils.config import read_yaml

    path, changes = MINLOG[variant]
    raw = read_yaml(path)
    for key, value in changes.items():
        section, leaf = key.split(".")
        if value is None:
            raw[section].pop(leaf)
        else:
            raw[section][leaf] = value
    return raw


def minlog_config(variant, adapt_nominal=None):
    """The ExperimentConfig of a MINLOG configuration, its adaptation.adapt_nominal set to
    `adapt_nominal` unless None."""
    from tube_mpc_tpu_torch.utils.config import parse_config

    cfg = parse_config(minlog_raw(variant))
    if adapt_nominal is None:
        return cfg
    return dataclasses.replace(cfg, adaptation=dataclasses.replace(cfg.adaptation,
                                                                   adapt_nominal=adapt_nominal))


def torch_draw(system, gen, shape, dtype):
    """Disturbances [*shape, nx], uniform within `system`'s bounds, from the seeded
    torch.Generator `gen` on its device: every phase's draw but prng's and the CLI's, so
    that those phases keep the data of the runs recorded in PERF.md, the tie-sensitive
    loop64 checks above all (the package draws from threefry keys, utils/prng.py)."""
    import torch

    low, high = system.w_low.to(dtype), system.w_high.to(dtype)
    u01 = torch.rand(tuple(shape) + (system.nx,), generator=gen, dtype=dtype,
                     device=gen.device)
    return low.to(u01.device) + (high - low).to(u01.device) * u01


def paper_setup(family, N_, H_, where, dtype):
    """The paper setup of `family` at N_, H_: Dubins' presets.dubins_paper_setup, a family's
    presets.family_paper_setup, a MINLOG configuration's in paper mode."""
    from tube_mpc_tpu_torch.presets import config_setup, dubins_paper_setup, family_paper_setup

    if family == "dubins":
        return dubins_paper_setup(N=N_, H=H_, device=where, dtype=dtype)
    if family in MINLOG:
        return config_setup(minlog_config(family, adapt_nominal=False), N=N_, H=H_,
                            device=where, dtype=dtype)
    return family_paper_setup(family, N=N_, H=H_, device=where, dtype=dtype)


def coupled_setup(torch, H_, where, dtype, family="dubins", N_=N):
    """bench.py's BENCH_MODE=coupled configuration (bench.py:229-255): the paper
    setup, the clipped adaptation, adapt_nominal, its raw parameters, eps=1e-4; for a
    family, configs/<family>.yaml with adaptation.adapt_nominal: true as the CLI runs it
    (presets.family_coupled_setup), and the same for a MINLOG configuration, at the
    horizon N_. Returns (setup, its TubeMPCConfig, raw θ̄, raw θ)."""
    from tube_mpc_tpu_torch.presets import (
        config_coupled_setup, dubins_paper_setup, family_coupled_setup)
    from tube_mpc_tpu_torch.tube.params import AdaptConfig, RawAuxTheta, RawNominalTheta

    if family in MINLOG:
        s, raw_nom, raw_aux = config_coupled_setup(minlog_config(family), N=N_, H=H_,
                                                   device=where, dtype=dtype)
        return s, s.cfg, raw_nom, raw_aux
    if family != "dubins":
        s, raw_nom, raw_aux = family_coupled_setup(family, N=N_, H=H_, device=where, dtype=dtype)
        return s, s.cfg, raw_nom, raw_aux
    s = dubins_paper_setup(N=N_, H=H_, device=where, dtype=dtype)
    cfg = dataclasses.replace(s.cfg, adapt=AdaptConfig(
        lr=5e-2, momentum=0.9, steps=1, grad_clip_norm=1.0, project=True), adapt_nominal=True)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=where)
    raw_nom = RawNominalTheta(
        Q_raw=t([1.0, 1.0, 0.0]), R_raw=t([1.0, 1.0]), Qf_raw=t([1000.0] * 3), qb_raw=t(1.0),
        alpha_raw=t(0.0), gamma_raw=t(0.0), tight_raw=t(0.0))
    raw_aux = RawAuxTheta(
        Q_raw=t([1.0, 1.0, 0.0]), R_raw=t([1.0, 1.0]), Qf_raw=t([1000.0] * 3), qb_raw=t(1.0),
        alpha_raw=t(0.0), gamma_raw=t(0.0))
    return s, cfg, raw_nom, raw_aux


def solver_inputs(pb, reg, system, C, x_hat, U_ws, X_ref, U_ref):
    """K1's and K2's inputs in the first iteration of an ancillary solve from x_hat [B, n̂]
    with the warm start U_ws toward the reference (X_ref [B, N+1, nx], U_ref), on the
    const block C: (K1's, K2's)."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import rollout
    from tube_mpc_tpu_torch.tube.lane_interface import _rows, _with_barrier_row

    x0, U0 = _rows(x_hat), _rows(system.clamp(U_ws))
    Xr, Ur = _rows(_with_barrier_row(X_ref)), _rows(U_ref)
    X0 = rollout(pb, x0, U0, Xr, Ur, C)
    nh, m = pb.n_hat, pb.m
    phix = C[nh + m:2 * nh + m] * (X0[-1] - Xr[-1])   # terminal rows of C
    k1 = (X0[:-1], U0, Xr[:-1], Ur, C, phix)
    K, kff = WRAPPERS["ric"](pb, reg, *k1)
    return k1, (x0, X0[:-1], U0, K, kff, Xr[:-1], Xr[-1], Ur, C)


def solver_fns(q, cfg):
    """{kernel: (its wrapper, its plain version)} of K1 and K2 on the problem q with the
    reg and alphas of cfg, and K2 at the rollout's nα=1 as "fwd nα=1"."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import fwd_plain, ric_plain

    return {
        "ric": (lambda *t: WRAPPERS["ric"](q, cfg.reg, *t), lambda *t: ric_plain(q, cfg.reg, *t)),
        "fwd": (lambda *t: WRAPPERS["fwd"](q, cfg.alphas, *t),
                lambda *t: fwd_plain(q, cfg.alphas, *t)),
        "fwd nα=1": (lambda *t: WRAPPERS["fwd"](q, (1.0,), *t),
                     lambda *t: fwd_plain(q, (1.0,), *t)),
    }


def paper_fns(q, cfg):
    """{kernel: (its wrapper, its plain version)} of the paper step's kernels on the problem
    q with the solver settings of cfg (K2 also at the rollout's nα=1, as "fwd nα=1")."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sfwd_plain

    return {
        **solver_fns(q, cfg),
        "sbwd": (lambda *t: WRAPPERS["sbwd"](q, REG_SENS, ACTIVE_TOL, *t),
                 lambda *t: sbwd_plain(q, REG_SENS, ACTIVE_TOL, *t)),
        "sfwd": (lambda *t: WRAPPERS["sfwd"](q, *t), lambda *t: sfwd_plain(q, *t)),
    }


def coupled_fns(q, cfg):
    """The same for the coupled step's kernels: K1, K2 and the K5/K6 variants."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda.lane_sensitivity import sbwd_plain, sbwd_upper_plain, sfwd_plain

    return {
        **solver_fns(q, cfg),
        "sbwd_generic": (lambda *t: WRAPPERS["sbwd_generic"](q, REG_SENS, ACTIVE_TOL, *t),
                         lambda *t: sbwd_plain(q, REG_SENS, ACTIVE_TOL, *t, generic=True)),
        "sbwd_upper": (lambda *t: WRAPPERS["sbwd_upper"](q, REG_SENS, ACTIVE_TOL, *t),
                       lambda *t: sbwd_upper_plain(q, REG_SENS, ACTIVE_TOL, *t)),
        "sfwd_generic": (lambda *t: WRAPPERS["sfwd_generic"](q, *t),
                         lambda *t: sfwd_plain(q, *t[:9], value=t[9:])),
        "sfwd_ref": (lambda *t: WRAPPERS["sfwd_ref"](q, *t),
                     lambda *t: sfwd_plain(q, *t[:9], value=t[9:], emit_ref_grads=True)),
    }


STEP_FNS = {"paper": paper_fns, "coupled": coupled_fns}


def step_problem(torch, kind, family, N_, dtype, where):
    """(lane problem, TubeMPCConfig) of the setup whose step `kind` ("paper": paper_step's,
    "coupled": coupled_step's) gives a kernel its inputs, without running a step."""
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

    if kind == "paper":
        s = paper_setup(family, N_, 4, where, dtype)
        cfg = s.cfg
    else:
        s, cfg, _, _ = coupled_setup(torch, 4, where, dtype, family, N_)
    return make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps), cfg


def cpu_count_ops(kind, family, N_, name, arrays):
    """The operations of the plain version of the kernel `name` of step `kind` on B lanes:
    count_ops on `arrays`, the first OPS_LANES lanes of its inputs in f32, on the CPU in a
    worker process (the plain versions take no branch by device)."""
    import torch

    torch.set_num_threads(1)
    pb, cfg = step_problem(torch, kind, family, N_, torch.float32, "cpu")
    plain = STEP_FNS[kind](pb, cfg)[name][1]
    return count_ops(torch, plain, [torch.from_numpy(a) for a in arrays], OPS_LANES) * (B // OPS_LANES)


def paper_step(torch, dev, dtype, family="dubins", N_=N):
    """The four paper kernels' inputs in one real closed-loop step of the paper setup
    (paper_setup: Dubins', a family's, a MINLOG configuration's) at full width and the
    horizon N_: three disturbed steps first, then this step's nominal solve, the first
    iteration of its ancillary solve, and the sensitivity of its solution.
    Returns (the problem, its eps, make, {kernel: inputs}, what):
    make(q) gives {kernel: (its wrapper, its plain version)} on the problem q, and K2 at
    the rollout's nα=1 as "fwd nα=1"."""
    from tube_mpc_tpu_torch.ops.costs import CostWeights
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.tube.lane_closed_loop import make_paper_lane_step, paper_lane_init_state
    from tube_mpc_tpu_torch.tube.lane_interface import (
        _build_C, _rows, _with_barrier_row, make_lane_problem, tube_ilqr_solve_lanes)

    s = paper_setup(family, N_, 4, dev, dtype)
    seed = {"dubins": SEED + 1, **{f: SEED + 10 + i for i, f in enumerate(FAMILIES)},
            **{v: SEED + 60 + i for i, v in enumerate(MINLOG)}}[family]
    nx, nu = s.system.nx, s.system.nu
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                target=s.target, B=B, dtype=dtype, device=dev)
    state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                  x0=s.x0, B=B, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch_draw(s.system, gen, (B, 3), dtype)
    for t in range(3):
        state, _ = step(state, w[:, t])
    x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
    X_ref_nom = s.target[None, None].expand(B, N_ + 1, nx)
    U_ref_nom = torch.zeros((B, N_, nu), dtype=dtype, device=dev)
    X_nom, U_nom = tube_ilqr_solve_lanes(
        pb, s.cfg.nominal_ilqr(), w=s.w_nominal, bp=s.bp, x_hat0=x_hat_bar,
        U_init=state.U_nom_ws, X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev)
    x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
    a = state.adapt
    w_aux = CostWeights(Q=a.Q, R=a.R, Qf=a.Q, qb=a.qb)
    C = _build_C(pb, w_aux, s.bp, B, dtype, dev)
    k1, k2 = solver_inputs(pb, s.cfg.reg, s.system, C, x_hat, state.U_aux_ws,
                           X_nom[..., :nx], U_nom)
    Xr, Ur = _rows(_with_barrier_row(X_nom[..., :nx])), _rows(U_nom)
    X_aux, U_aux = tube_ilqr_solve_lanes(
        pb, s.cfg.aux_ilqr(), w=w_aux, bp=s.bp, x_hat0=x_hat, U_init=state.U_aux_ws,
        X_ref=X_nom[..., :nx], U_ref=U_nom, device=dev)
    Xa, Ua = _rows(X_aux), _rows(U_aux)
    k3 = (Ua, Xa[:-1], Xr[:-1], C, Xa[-1], Xr[-1])
    Ks, kffs = WRAPPERS["sbwd"](pb, REG_SENS, ACTIVE_TOL, *k3)
    k4 = (Ks, kffs, Xa[:-1], Xr[:-1], Ua, Ur, C, Xa[-1], Xr[-1])
    torch.cuda.synchronize()
    make = lambda q: paper_fns(q, s.cfg)
    what = "paper setup" if family == "dubins" else f"{family} paper setup"
    return (pb, s.eps, make, {"ric": k1, "fwd": k2, "sbwd": k3, "sfwd": k4},
            f"{what} at B={B}, N={N_}, {len(s.cfg.alphas)} alphas")


def with_obstacles(pb, centers, eps):
    """The lane problem of pb's system, aggregation and barrier with the circle obstacles
    `centers`, radius 1."""
    from tube_mpc_tpu_torch.ops import lanes
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

    sp = pb.spec
    kw = dict(centers=centers, radii=[1.0] * len(centers), beta=sp.beta,
              aggregation=sp.aggregation)
    if sp.family == "dubins":
        sys_c = lanes.dubins_components(dt=sp.dt, v_min=pb.u_min[0], v_max=pb.u_max[0],
                                        omega_max=pb.u_max[1], **kw)
    elif sp.family == "double_integrator":
        sys_c = lanes.double_integrator_components(dt=sp.dt, a_max=pb.u_max[0], **kw)
    else:
        sys_c = lanes.quadrotor2d_components(
            dt=sp.dt, mass=sp.mass, inertia=sp.inertia, arm=sp.arm, gravity=sp.gravity,
            t_min=pb.u_min[0], t_max=pb.u_max[0], **kw)
    return make_lane_problem(sys_c, barrier_type=pb.barrier_type, eps=eps)


def run_paper_loop(s, w, where, aux_caps=(), population=False):
    """The paper loop of setup s under the disturbances w, on `where`, with the ancillary
    solves' compaction caps `aux_caps`; with `population`, one θ shared by the lanes."""
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes

    return run_paper_closed_loop_lanes(
        s.system, s.aug, s.sys_c, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init,
        bp=s.bp, x0=s.x0, target=s.target, w_seqs=w, eps=s.eps, barrier_type=s.barrier_type,
        population=population, device=where, aux_compact_caps=aux_caps)


def run_coupled(s, cfg, raw_nom, raw_aux, w, where, aux_caps=()):
    """The generic loop of coupled_setup's (s, cfg, raw θ̄, raw θ) under the disturbances w,
    on `where`, with the ancillary solves' compaction caps `aux_caps`: (log, (raw θ, raw θ̄)
    at the end)."""
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_generic_closed_loop_lanes

    return run_generic_closed_loop_lanes(
        s.system, s.aug, s.sys_c, cfg, raw_nom=raw_nom, raw_aux_init=raw_aux, x0=s.x0,
        target=s.target, w_seqs=w, eps=s.eps, barrier_type=s.barrier_type, device=where,
        aux_compact_caps=aux_caps)


# The f64 loops held on the card against the CPU (phases loop64*): (kind, family) -> the
# seed of their disturbances.
LOOP64_CASES = {("paper", "dubins"): SEED + 2, ("coupled", "dubins"): SEED + 5,
                **{("paper", f): SEED + 20 + i for i, f in enumerate(FAMILIES)},
                **{("coupled", f): SEED + 50 + i for i, f in enumerate(FAMILIES)},
                ("paper", "dubins_min_log"): SEED + 70, ("coupled", "cartpole_log"): SEED + 71,
                ("population", "dubins"): SEED + 72}


def loop64_case(torch, kind, family, where, H_=LOOP64_H, scale=1.0):
    """(setup, run, w) of the f64 loop `kind` ("paper", "population": the paper loop with one
    θ shared by the lanes, or "coupled") of `family` at B=LOOP64_B, N, H=H_ on `where`:
    run(setup, w, where) runs it under the disturbances w. With `scale`, the start x0 and the
    disturbances are multiplied by it (1 + 1e-15: a perturbation of their last bits)."""
    f64 = torch.float64
    if kind in ("paper", "population"):
        st = paper_setup(family, N, H_, where, f64)
        st = dataclasses.replace(st, x0=st.x0 * scale)
        run = lambda s_, w_, where_: run_paper_loop(s_, w_, where_,
                                                    population=kind == "population")
        s = st
    else:
        st = coupled_setup(torch, H_, where, f64, family)
        st = (dataclasses.replace(st[0], x0=st[0].x0 * scale), *st[1:])
        run, s = (lambda st_, w_, where_: run_coupled(*st_, w_, where_)), st[0]
    gen = torch.Generator().manual_seed(LOOP64_CASES[kind, family])
    w = torch_draw(s.system, gen, (LOOP64_B, H_), f64).to(where) * scale
    return st, run, w


def tree_map(fn, tree):
    """fn on every leaf of a tree of tuples and named tuples."""
    if isinstance(tree, tuple):
        leaves = [tree_map(fn, v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    return fn(tree)


def cpu_loop64(kind, family, H_=LOOP64_H, scale=1.0):
    """The CPU's f64 loop of loop64_case (the plain versions), in a worker process: (its
    result as numpy arrays, its seconds). The workers run beside the card's phases, one
    thread each."""
    import torch

    torch.set_num_threads(1)
    st, run, w = loop64_case(torch, kind, family, "cpu", H_, scale)
    t0 = time.perf_counter()
    out = run(st, w, "cpu")
    return tree_map(lambda t: t.numpy(), out), time.perf_counter() - t0


def xla64_case(torch, kind, where):
    """(run, w) of xla64's f64 loop `kind` at LOOP64_B, N, LOOP64_H on `where`: run(engine)
    runs it on the "xla" or the "lanes" engine, the generic loop's result as the lane
    loop's (log, (raw θ, raw θ̄)). The paper loop is bench.py's setup; the coupled one
    bench.py's BENCH_MODE=coupled with the gradient clip off, because the lane engine clips
    the norm over every lane at once and the XLA engine each lane's own."""
    from tube_mpc_tpu_torch.tube.closed_loop import run_generic_closed_loop, run_paper_closed_loop

    f64 = torch.float64
    gen = torch.Generator().manual_seed(XLA_CASES[kind])
    if kind == "paper":
        s = paper_setup("dubins", N, LOOP64_H, where, f64)
        w = torch_draw(s.system, gen, (LOOP64_B, LOOP64_H), f64).to(where)

        def run(engine):
            if engine == "lanes":
                return run_paper_loop(s, w, where)
            return run_paper_closed_loop(
                s.system, s.aug, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp,
                x0=s.x0, target=s.target, w_seq=w, device=where)
        return run, w
    s, cfg, raw_nom, raw_aux = coupled_setup(torch, LOOP64_H, where, f64)
    cfg = dataclasses.replace(cfg, adapt=dataclasses.replace(cfg.adapt, grad_clip_norm=0.0))
    w = torch_draw(s.system, gen, (LOOP64_B, LOOP64_H), f64).to(where)

    def run(engine):
        if engine == "lanes":
            return run_coupled(s, cfg, raw_nom, raw_aux, w, where)
        log_, (rn, ra) = run_generic_closed_loop(
            s.system, s.aug, cfg, raw_nom_init=raw_nom, raw_aux_init=raw_aux, x0=s.x0,
            target=s.target, w_seq=w, device=where)
        return log_, (ra, rn)
    return run, w


def cpu_xla64(kind):
    """The CPU's side of xla64: the XLA engine's f64 loop `kind`, in a worker process (its
    result as numpy arrays, its seconds)."""
    import torch

    torch.set_num_threads(1)
    run, _ = xla64_case(torch, kind, "cpu")
    t0 = time.perf_counter()
    out = run("xla")
    return tree_map(lambda t: t.numpy(), out), time.perf_counter() - t0


def population64_case(torch, where):
    """run() of the scenarios phase's f64 check: run_population_adaptation (the XLA engine)
    on the paper setup at POP64_B scenarios, N, POP64_H steps on `where`, the starts spread
    over ±0.5 in px and py, from the draws of seed SEED + 92."""
    from tube_mpc_tpu_torch.parallel import run_population_adaptation

    f64 = torch.float64
    s = paper_setup("dubins", N, POP64_H, where, f64)
    gen = torch.Generator().manual_seed(SEED + 92)
    w = torch_draw(s.system, gen, (POP64_B, POP64_H), f64).to(where)
    spread = torch.rand((POP64_B, 3), generator=gen, dtype=f64) - 0.5
    x0 = s.x0 + (spread * torch.tensor([1.0, 1.0, 0.0], dtype=f64)).to(where)
    return lambda: run_population_adaptation(
        s.system, s.aug, s.cfg, w_nominal=s.w_nominal, aux_init=s.aux_init, bp=s.bp,
        x0_batch=x0, target=s.target, w_seqs=w, device=where)


def cpu_population64():
    """The CPU's side of the scenarios phase's f64 check, in a worker process: (its log and
    final θ as numpy arrays, its seconds)."""
    import torch

    torch.set_num_threads(1)
    run = population64_case(torch, "cpu")
    t0 = time.perf_counter()
    out = run()
    return tree_map(lambda t: t.numpy(), out), time.perf_counter() - t0


def loop_fields(out):
    """{field: tensor} of a loop's result: a ClosedLoopLog's fields [B, H, ...] and, for
    the generic loop's (log, (raw_aux, raw_nom)), the final raw leaves too."""
    if hasattr(out, "_fields"):
        return out._asdict()
    fields = out[0]._asdict()
    for tree, raws in zip(("raw_aux", "raw_nom"), out[1]):
        fields.update({f"{tree}.{k}": v for k, v in raws._asdict().items()})
    return fields


def loop_diffs(got, ref, steps, tol):
    """{field: (max |got - ref|, within tol)}: the log fields over the first `steps`
    steps, and the final raw leaves when `steps` is the whole run."""
    a_f, b_f, out = loop_fields(got), loop_fields(ref), {}
    H_run = b_f["x_real"].shape[1]
    for field, b in b_f.items():
        rtol, atol = tol[field.split(".")[0]]
        a = a_f[field]
        if field.startswith("raw_"):
            if steps < H_run:
                continue
        else:
            a, b = a[:, :steps], b[:, :steps]
        d = (a.cpu() - b.cpu()).abs()
        out[field] = (float(d.max()), bool((d <= atol + rtol * b.cpu().abs()).all()))
    return out


@contextlib.contextmanager
def plain_on_card():
    """The kernel wrappers run their plain versions on CUDA tensors too, within: a loop
    through the plain versions on the card, with the card's math library (a check's
    reference only; the port's wrappers never do this)."""
    from tube_mpc_tpu_torch.ops.cuda import lane_sensitivity, lane_solver

    saved = lane_solver.on_cpu, lane_sensitivity.on_cpu
    lane_solver.on_cpu = lane_sensitivity.on_cpu = lambda *tensors: True
    try:
        yield
    finally:
        lane_solver.on_cpu, lane_sensitivity.on_cpu = saved


def coupled_step(torch, dev, dtype, family="dubins", N_=N, solver=False):
    """The four K5/K6 variants' inputs in one real step of the coupled setup (Dubins',
    or a family's from coupled_setup) at full width and the horizon N_: three disturbed
    steps first, then this step's two solves, the ancillary sweeps (K5 generic, K6 with
    the reference cotangents) and the nominal sweeps fed those cotangents (K5 with upper
    rows, K6 generic); with `solver`, K1's and K2's inputs too (the first iteration of
    the ancillary solve). Returns what paper_step does."""
    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.tube.lane_closed_loop import (
        _aux_params, _nom_params, generic_lane_init_state, make_generic_lane_step)
    from tube_mpc_tpu_torch.tube.lane_interface import (
        _build_C, _rows, _with_barrier_row, make_lane_problem, tube_ilqr_solve_lanes,
        tube_sensitivity_grads_lanes_generic)

    s, cfg, raw_nom, raw_aux = coupled_setup(torch, 4, dev, dtype, family, N_)
    nx, nu = s.system.nx, s.system.nu
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    step = make_generic_lane_step(s.system, s.aug, pb, cfg, target=s.target, B=B,
                                  dtype=dtype, device=dev)
    state = generic_lane_init_state(s.system, s.aug, cfg, raw_nom=raw_nom,
                                    raw_aux_init=raw_aux, x0=s.x0, B=B, dtype=dtype)
    seed = {"dubins": SEED + 4, **{f: SEED + 40 + i for i, f in enumerate(FAMILIES)},
            **{v: SEED + 80 + i for i, v in enumerate(MINLOG)}}[family]
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch_draw(s.system, gen, (B, 3), dtype)
    for t in range(3):
        state, _ = step(state, w[:, t])
    zero_t = torch.zeros((B,), dtype=dtype, device=dev)
    w_aux, bp_aux = _aux_params(state.raw_aux, zero_t)
    w_nom, bp_nom = _nom_params(state.raw_nom)
    x_hat_bar = torch.cat([state.x_bar, state.b_bar[:, None]], dim=-1)
    X_ref_nom = s.target[None, None].expand(B, N_ + 1, nx)
    U_ref_nom = torch.zeros((B, N_, nu), dtype=dtype, device=dev)
    X_nom, U_nom = tube_ilqr_solve_lanes(
        pb, cfg.nominal_ilqr(), w=w_nom, bp=bp_nom, x_hat0=x_hat_bar,
        U_init=state.U_nom_ws, X_ref=X_ref_nom, U_ref=U_ref_nom, device=dev)
    x_hat = torch.cat([state.x, state.b[:, None]], dim=-1)
    X_aux, U_aux = tube_ilqr_solve_lanes(
        pb, cfg.aux_ilqr(), w=w_aux, bp=bp_aux, x_hat0=x_hat, U_init=state.U_aux_ws,
        X_ref=X_nom[..., :nx], U_ref=U_nom, device=dev)
    Xa, Ua = _rows(X_aux), _rows(U_aux)
    Xr, Ur = _rows(_with_barrier_row(X_nom[..., :nx])), _rows(U_nom)
    Ca = _build_C(pb, w_aux, bp_aux, B, dtype, dev)
    inputs = {}
    if solver:
        inputs["ric"], inputs["fwd"] = solver_inputs(pb, cfg.reg, s.system, Ca, x_hat,
                                                     state.U_aux_ws, X_nom[..., :nx], U_nom)
    k5g = (Ua, Xa[:-1], Xr[:-1], Ca, Xa[-1], Xr[-1])
    K, kff, tVx, Vxx, LogS = WRAPPERS["sbwd_generic"](pb, REG_SENS, ACTIVE_TOL, *k5g)
    k6r = (K, kff, Xa[:-1], Xr[:-1], Ua, Ur, Ca, Xa[-1], Xr[-1], tVx, Vxx, LogS)
    _, g_Xref, g_Uref = tube_sensitivity_grads_lanes_generic(
        pb, w=w_aux, bp=bp_aux, X_hat=X_aux, U=U_aux, X_ref=X_nom[..., :nx], U_ref=U_nom,
        reg=REG_SENS, emit_ref_grads=True, device=dev)
    gX, gU = _rows(g_Xref), _rows(g_Uref)
    Xn, Un = _rows(X_nom), _rows(U_nom)
    Xrn, Urn = _rows(_with_barrier_row(X_ref_nom)), _rows(U_ref_nom)
    Cn = _build_C(pb, w_nom, bp_nom, B, dtype, dev)
    k5u = (gX[:-1].contiguous(), gU, gX[-1], Un, Xn[:-1], Cn)
    K2, kff2, tVx2, Vxx2, LogS2 = WRAPPERS["sbwd_upper"](pb, REG_SENS, ACTIVE_TOL, *k5u)
    k6g = (K2, kff2, Xn[:-1], Xrn[:-1], Un, Urn, Cn, Xn[-1], Xrn[-1], tVx2, Vxx2, LogS2)
    torch.cuda.synchronize()
    make = lambda q: coupled_fns(q, cfg)
    what = "coupled setup" if family == "dubins" else f"{family} coupled setup"
    inputs.update(sbwd_generic=k5g, sbwd_upper=k5u, sfwd_generic=k6g, sfwd_ref=k6r)
    return pb, s.eps, make, inputs, f"{what} at B={B}, N={N_}, {len(cfg.alphas)} alphas"


# the keys of the runner's summary (tube_mpc_tpu/runners.py:350-369, _finish_lanes)
SUMMARY_KEYS = {"system", "mode", "engine", "dtype", "H", "N", "batch", "final_state",
                "final_barrier_state", "final_loss", "final_loss_mean_finite",
                "final_loss_median_finite", "finite_lane_frac", "wall_time_s", "solves_per_sec"}


def config_variant(cfg):
    """The library variant (_build.VARIANTS) whose kernels a config's lane engine runs."""
    from tube_mpc_tpu_torch.ops.cuda import _build

    env, name = cfg.environment, cfg.system.name
    circles = env.obstacles and name != "cartpole"
    return _build.variant_name(name, env.obstacle_aggregation if circles else "smoothmin",
                               cfg.dbas.barrier_type)


def cli_phase(torch, dev, t_start, phase="cli", runs=None):
    """Phase 8: `python -m tube_mpc_tpu_torch.run_experiment --config <file> --batch B`,
    called in-process (main(argv)) on the card at each config's own N and H, into a
    temporary directory that it then removes. `runs` is [(the run's name, its YAML as
    plain values)]; by default configs/dubins.yaml as shipped (paper mode), and a copy of
    each family's config with adaptation.adapt_nominal: true (the coupled generic path),
    each named by its system. The run must return; every artifact must have its shape
    and the summary every key; each run must launch its kernels from its own variant's
    libraries only (config_variant; launch_counts(by_system=True)): K1 and K2, and K3/K4
    H times (a paper-mode run) or each K5/K6 variant adapt.steps times a step (a coupled
    run); solves_per_sec and finite_lane_frac, printed as records, must be finite
    numbers. Returns {name: {kernel: its launches in that run}}."""
    import math
    import os
    import shutil
    import tempfile

    import numpy as np
    import yaml

    from tube_mpc_tpu_torch.ops.cuda import KERNELS as WRAPPERS
    from tube_mpc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.run_experiment import main as cli_main
    from tube_mpc_tpu_torch.utils.config import parse_config, read_yaml

    if runs is None:
        runs = [("dubins", read_yaml("configs/dubins.yaml"))]
        for family in FAMILIES:
            raw = read_yaml(f"configs/{family}.yaml")
            raw["adaptation"]["adapt_nominal"] = True
            runs.append((family, raw))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    counts, problems = {}, []
    try:
        for name, raw in runs:
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w", encoding="utf-8") as f:
                yaml.safe_dump(raw, f)
            cfg = parse_config(read_yaml(path))
            variant = config_variant(cfg)
            Hc, Nc, steps = cfg.system.task_horizon_H, cfg.system.horizon_N, cfg.adaptation.steps
            run_dir = os.path.join(tmp, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            res = cli_main(["--config", path, "--batch", str(B), "--run-dir", run_dir])
            elapsed = time.perf_counter() - t0
            by_system = launch_counts(by_system=True)
            c = counts[name] = {k: by_system.get((k, variant), 0) for k in WRAPPERS}
            others = {f"{k}_{var}": n for (k, var), n in by_system.items() if var != variant}
            summary = res["summary"]
            nx, nu = res["log"].x_real.shape[-1], res["log"].u_real.shape[-1]
            del res
            sps, fin = summary.get("solves_per_sec"), summary.get("finite_lane_frac")
            log(f"[{phase}] {name} (mode {summary.get('mode')}): B={B}, N={Nc}, H={Hc} f32: run "
                f"{summary.get('wall_time_s')!r} s, solves_per_sec {sps!r}, finite_lane_frac "
                f"{fin!r}; the call with its artifacts {elapsed:.3f} s, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
            log(f"[{phase}] {name} launches from its libraries ({variant}): {json.dumps(c)}; "
                f"from others: "
                f"{json.dumps(others)}")
            if others:
                problems.append(f"{name}: launches from other variants' libraries {others}")
            want = {"x_real": (Hc, nx), "u_real": (Hc, nu), "x_bar": (Hc, nx), "u_bar": (Hc, nu),
                    "b_real": (Hc,), "loss": (Hc,), "Qa_history": (Hc, nx),
                    "Ra_history": (Hc, nu), "qba_history": (Hc,)}
            batch = {"x_real": nx, "u_real": nu, "x_bar": nx, "u_bar": nu, "b_real": None,
                     "loss": None, "Q_hist": nx, "R_hist": nu, "qb_hist": None}
            want.update({f"{k}_batch": (B, Hc) + ((d,) if d else ()) for k, d in batch.items()})
            for art, shape in want.items():
                f = os.path.join(run_dir, f"{art}.npy")
                got = np.load(f, mmap_mode="r") if os.path.exists(f) else None
                if got is None or got.shape != shape or got.dtype != np.float64:
                    problems.append(f"{name}: {art}.npy is "
                                    f"{None if got is None else (got.shape, got.dtype)}, "
                                    f"not {shape} float64")
            for js in ("config_used.json", "results_summary.json"):
                if not os.path.exists(os.path.join(run_dir, js)):
                    problems.append(f"{name}: no {js}")
            if set(summary) != SUMMARY_KEYS:
                problems.append(f"{name}: summary keys {sorted(set(summary) ^ SUMMARY_KEYS)}")
            if not all(isinstance(v, float) and math.isfinite(v) for v in (sps, fin)):
                problems.append(f"{name}: solves_per_sec {sps!r}, finite_lane_frac {fin!r}")
            want_n = {"ric": None, "fwd": None}
            if cfg.paper_dubins_mode and not cfg.adaptation.adapt_nominal:
                want_n.update(sbwd=Hc, sfwd=Hc)
            else:
                want_n.update({k: Hc * steps for k in COUPLED})
            for k, n in want_n.items():
                if c[k] == 0 or (n is not None and c[k] != n):
                    problems.append(f"{name}: {k} launched {c[k]} times"
                                    + ("" if n is None else f", not {n}"))
            shutil.rmtree(run_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise SystemExit(f"chip_smoke: the CLI runs failed their checks: {problems}")
    log(f"[{phase}] done at {time.perf_counter() - t_start:.0f} s")
    return counts


# the XLA runner's population summary (tube_mpc_tpu/runners.py:166-180, and the port's
# engine and dtype after mode)
XLA_SUMMARY_KEYS = ["system", "mode", "engine", "dtype", "H", "N", "batch", "final_state",
                    "final_barrier_state", "final_loss", "final_loss_mean", "final_loss_std",
                    "final_loss_max", "wall_time_s", "solves_per_sec"]


def device_rows(torch, prof):
    """(device µs, launches, name) of every device-side event of a profile, largest first:
    an aten op on the host also reports the device time of the kernels it launched, which
    would count them twice."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return sorted(rows, reverse=True)


def xla_phase(torch, dev, t_start):
    """Phase xla: the XLA engine at full width in f32, B lanes: the Dubins paper loop
    (bench.py's setup, N) and XLA_FAMILY's coupled loop (its config with adapt_nominal, its
    N), each XLA_H steps (the H cut), with its iterations a step (iLQR iterations of both
    solves, counted at ilqr._linearize), wall, solves/s, peak memory and finite_lane_frac
    (>= 0.99 required); the device's busy share and launches over one profiled paper step
    (device activity only); and one nominal solve from the paper run's last states, its
    iterations and time. Returns those states (phase pscan solves from them too)."""
    from torch.profiler import ProfilerActivity, profile

    from tube_mpc_tpu_torch.presets import dubins_paper_setup, family_coupled_setup
    from tube_mpc_tpu_torch.solvers import ilqr
    from tube_mpc_tpu_torch.tube.closed_loop import run_generic_closed_loop, run_paper_closed_loop
    from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp
    from tube_mpc_tpu_torch.utils.config import load_config

    f32 = torch.float32
    iterations = [0]
    linearize = ilqr._linearize

    def counted(*args):
        iterations[0] += 1
        return linearize(*args)

    ps = dubins_paper_setup(N=N, H=XLA_H, device=dev, dtype=f32)
    family_cfg = load_config(f"configs/{XLA_FAMILY}.yaml").system
    Nc = family_cfg.horizon_N
    fs, raw_nom, raw_aux = family_coupled_setup(XLA_FAMILY, N=Nc, H=XLA_H, device=dev, dtype=f32)

    def paper(w, H_):
        return run_paper_closed_loop(ps.system, ps.aug, dataclasses.replace(ps.cfg, H=H_),
                                     w_nominal=ps.w_nominal, aux_init=ps.aux_init, bp=ps.bp,
                                     x0=ps.x0, target=ps.target, w_seq=w, device=dev)

    def coupled(w, H_):
        return run_generic_closed_loop(fs.system, fs.aug, dataclasses.replace(fs.cfg, H=H_),
                                       raw_nom_init=raw_nom, raw_aux_init=raw_aux, x0=fs.x0,
                                       target=fs.target, w_seq=w, device=dev)[0]

    x_last = None
    for name, s, run, Nr, Hc, seed in (
            ("paper", ps, paper, N, H, SEED + 93),
            (f"{XLA_FAMILY}_coupled", fs, coupled, Nc, family_cfg.task_horizon_H, SEED + 94)):
        w = torch_draw(s.system, torch.Generator(device=dev).manual_seed(seed), (B, XLA_H),
                       f32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iterations[0] = 0
        ilqr._linearize = counted
        try:
            t0 = time.perf_counter()
            out = run(w, XLA_H)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        finally:
            ilqr._linearize = linearize
        finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
        log(f"[xla] {name}: B={B}, N={Nr}, H={XLA_H} (cut from {Hc}) f32: wall {elapsed:.3f} s, {1e3 * elapsed / XLA_H:.1f} ms a step, "
            f"{iterations[0] / XLA_H:.1f} iLQR iterations a step (both solves), "
            f"{2 * XLA_H * B / elapsed:.1f} solves/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, finite_lane_frac {finite!r}, "
            f"final loss median {float(out.loss[:, -1].nanmedian())!r}")
        nx = s.system.nx
        if tuple(out.x_real.shape) != (B, XLA_H, nx) or tuple(out.loss.shape) != (B, XLA_H):
            raise SystemExit(f"chip_smoke: xla {name}: the log has the wrong shapes")
        if finite < 0.99 or iterations[0] == 0:
            raise SystemExit(f"chip_smoke: xla {name}: finite_lane_frac {finite}, "
                             f"{iterations[0]} iterations")
        if x_last is None:
            x_last = out.x_real[:, -1]
        del out

    # the device's busy share over one paper step at full width
    w1 = torch_draw(ps.system, torch.Generator(device=dev).manual_seed(SEED + 95), (B, 1), f32)
    t0 = time.perf_counter()
    paper(w1, 1)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        paper(w1, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    if not launches:
        raise SystemExit("chip_smoke: xla: the profiler saw no device kernel")
    log(f"[xla] profile: one paper step at B={B}, N={N}, f32: {plain_wall:.3f} s unprofiled, "
        f"{wall:.3f} s profiled; device busy {busy:.3f} s ({busy / wall:.1%} of the profiled "
        f"wall, {busy / plain_wall:.1%} of the unprofiled) over {launches} device kernels "
        f"({1e6 * busy / max(launches, 1):.1f} us each on average, "
        f"{1e6 * plain_wall / max(launches, 1):.1f} us of unprofiled wall each)")
    for us, count, key in rows[:8]:
        log(f"[xla] profile   {us / 1e3:10.3f} ms  x{count:<7d} {key[:100]}")

    # a nominal solve from the lanes' last states of the paper run: its iterations, and its
    # time beside the paper steps' time per iteration
    ocp = make_nominal_ocp(ps.system, ps.aug, ps.target)
    theta = NominalTheta(expand_lanes(ps.w_nominal, B), expand_lanes(ps.bp, B))
    x_hat = torch.cat([x_last, ps.aug.init_b0(x_last, ps.bp)[:, None]], dim=-1)
    U0 = torch.zeros((B, N, ps.system.nu), dtype=f32, device=dev)
    torch.cuda.synchronize()
    iterations[0] = 0
    ilqr._linearize = counted
    try:
        t0 = time.perf_counter()
        X_sol, U_sol = ilqr.ilqr_solve(ocp, ps.cfg.nominal_ilqr(), theta, x_hat, U0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
    finally:
        ilqr._linearize = linearize
    log(f"[xla] nominal solve from zero controls, B={B}, N={N}, f32: {1e3 * elapsed:.1f} ms, "
        f"{iterations[0]} iterations (max_iter {ps.cfg.nominal_max_iter}), "
        f"{1e3 * elapsed / max(iterations[0], 1):.1f} ms an iteration")
    if iterations[0] == 0 or not (torch.isfinite(X_sol).all() and torch.isfinite(U_sol).all()):
        raise SystemExit("chip_smoke: xla: the nominal solve ran no iteration or is not finite")
    log(f"[xla] done at {time.perf_counter() - t_start:.0f} s")
    return x_last


def cli_xla_phase(torch, dev, t_start):
    """Phase cli_xla: the port's CLIs on the XLA engine, in-process (main(argv)) on the card:
    python -m tube_mpc_tpu_torch.run_experiment --engine xla on configs/dubins.yaml as
    shipped (f32, paper) at --batch 1024 and with use_float64: true and adapt_nominal:
    true at --batch 64, both at H = XLA_CLI_H; python -m tube_mpc_tpu_torch.run_nominal on
    dubins.yaml at H = XLA_NOMINAL_H (its receding horizon takes one solve a step); and
    python -m tube_mpc_tpu_torch.gradient_check at its defaults (it shrinks dubins.yaml to
    N=8, H=2, f64 itself). Artifacts, summary keys, the summary's dtype, finite numbers,
    and gradient_check's finite difference and analytic hypergradient within a factor of 2
    with the same sign (tests/test_gradient_check_cli.py's rule)."""
    import math
    import os
    import shutil
    import tempfile

    import numpy as np
    import yaml

    from tube_mpc_tpu_torch.gradient_check import main as gradient_check_main
    from tube_mpc_tpu_torch.run_experiment import main as cli_main
    from tube_mpc_tpu_torch.run_nominal import main as nominal_main
    from tube_mpc_tpu_torch.utils.config import read_yaml

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_xla_")
    problems = []
    try:
        shipped = read_yaml("configs/dubins.yaml")
        coupled64 = dict(shipped, use_float64=True,
                         adaptation=dict(shipped["adaptation"], adapt_nominal=True))
        for name, raw, Bc, dtype, mode in (("dubins", shipped, 1024, "float32", "paper"),
                                           ("dubins_f64_coupled", coupled64, 64, "float64",
                                            "generic")):
            raw = dict(raw, system=dict(raw["system"], task_horizon_H=XLA_CLI_H))
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w", encoding="utf-8") as f:
                yaml.safe_dump(raw, f)
            run_dir = os.path.join(tmp, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = cli_main(["--config", path, "--engine", "xla", "--batch", str(Bc),
                            "--run-dir", run_dir])
            elapsed = time.perf_counter() - t0
            s = res["summary"]
            log(f"[cli_xla] {name} (mode {s.get('mode')}, dtype {s.get('dtype')}): B={Bc}, "
                f"N={raw['system']['horizon_N']}, H={XLA_CLI_H} (cut from 300): run "
                f"{s.get('wall_time_s')!r} s, solves_per_sec {s.get('solves_per_sec')!r}, "
                f"final_loss_mean {s.get('final_loss_mean')!r}; the call with its artifacts "
                f"{elapsed:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
            if list(s) != XLA_SUMMARY_KEYS:
                problems.append(f"{name}: summary keys {list(s)}")
            if s.get("dtype") != dtype or s.get("mode") != mode or s.get("engine") != "xla":
                problems.append(f"{name}: dtype {s.get('dtype')}, mode {s.get('mode')}")
            if not all(math.isfinite(s[k]) for k in ("solves_per_sec", "final_loss_mean")):
                problems.append(f"{name}: {s}")
            nx, nu = 3, 2
            shapes = {"x_real": (XLA_CLI_H, nx), "u_real": (XLA_CLI_H, nu), "loss": (XLA_CLI_H,),
                      "Qa_history": (XLA_CLI_H, nx), "x_real_batch": (Bc, XLA_CLI_H, nx),
                      "loss_batch": (Bc, XLA_CLI_H)}
            for art, shape in shapes.items():
                got = np.load(os.path.join(run_dir, f"{art}.npy"))
                if got.shape != shape or got.dtype != np.float64:
                    problems.append(f"{name}: {art}.npy {got.shape} {got.dtype}")
            for js in ("config_used.json", "results_summary.json"):
                if not os.path.exists(os.path.join(run_dir, js)):
                    problems.append(f"{name}: no {js}")
            del res

        raw = dict(shipped, out_dir=os.path.join(tmp, "nominal"),
                   system=dict(shipped["system"], task_horizon_H=XLA_NOMINAL_H))
        path = os.path.join(tmp, "nominal.yaml")
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(raw, f)
        t0 = time.perf_counter()
        res = nominal_main(["--config", path])
        s = res["summary"]
        log(f"[cli_xla] run_nominal (receding): N={raw['system']['horizon_N']}, "
            f"H={XLA_NOMINAL_H} (cut from 300), {time.perf_counter() - t0:.3f} s: {json.dumps(s)}")
        if set(s) != {"system", "mode", "H_ran", "success", "success_t", "collided",
                      "final_state"} or s["H_ran"] < 1 or s["collided"]:
            problems.append(f"run_nominal: {s}")
        for art in ("x_bar", "u_bar", "x_real", "u_real", "b_real", "loss"):
            got = np.load(os.path.join(res["run_dir"], f"{art}.npy"))
            if got.shape[0] != s["H_ran"] or not np.all(np.isfinite(got)):
                problems.append(f"run_nominal: {art}.npy {got.shape}")

        t0 = time.perf_counter()
        gc_json = os.path.join(tmp, "gc.json")
        r = gradient_check_main(["--config", "configs/dubins.yaml", "--json-out", gc_json])
        log(f"[cli_xla] gradient_check (N=8, H=2, f64, 3 iterations): "
            f"{time.perf_counter() - t0:.3f} s: {json.dumps(r)}")
        fd, an = r["fd_dL_dQ0"], r["analytic_dL_dQ0"]
        with open(gc_json, encoding="utf-8") as f:
            if json.load(f) != r:
                problems.append("gradient_check: --json-out differs from the result")
        if not (all(math.isfinite(v) for v in r.values()) and fd != 0.0 and an != 0.0
                and (fd < 0) == (an < 0) and 0.5 <= abs(an / fd) <= 2.0):
            problems.append(f"gradient_check: {r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise SystemExit(f"chip_smoke: the XLA engine's CLI runs failed their checks: {problems}")
    log(f"[cli_xla] done at {time.perf_counter() - t_start:.0f} s")


def pscan_lq(torch, seed, lanes, N, n, m, dtype, bench=False):
    """A random LQ problem on the CPU, from a torch.Generator seeded with `seed`: the recipe
    of tests/test_pscan.py:22-39, or with bench=True benchmarks/bench_pscan.py's _data.
    (A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx), lanes first."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen, dtype=dtype)
    eye = lambda k: torch.eye(k, dtype=dtype)
    sA, sB, sux, sw = (0.05, 0.3, 0.05, 0.05) if bench else (0.1, 0.5, 0.1, 0.1)

    def spd(sz):
        W = r(lanes, N, sz, sz)
        return sw * (W @ W.transpose(-1, -2)) + eye(sz)

    A = eye(n) + sA * r(lanes, N, n, n)
    B = sB * r(lanes, N, n, m)
    lx, lu = r(lanes, N, n), r(lanes, N, m)
    lxx, luu = spd(n), spd(m)
    lux = sux * r(lanes, N, m, n)
    phi_x = r(lanes, n)
    W = r(lanes, n, n)
    return A, B, lx, lu, lxx, luu, lux, phi_x, 0.5 * (W @ W.transpose(-1, -2)) + eye(n)


def exact_recursion(torch, A, B, lx, lu, lxx, luu, lux, phi_x, phi_xx, reg=0.0):
    """tests/test_pscan.py:61-73's exact-elimination recursion over the lanes at once (its
    Q_uu solve regularised by reg): (V_x [B, N+1, n], V_xx [B, N+1, n, n], K, kff)."""
    mT = lambda M: M.transpose(-1, -2)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    V_x, V_xx = phi_x, phi_xx
    xs, xxs, Ks, ks = [V_x], [V_xx], [], []
    for k in reversed(range(A.shape[1])):
        A_k, B_k = A[:, k], B[:, k]
        Q_x, Q_u = lx[:, k] + mv(mT(A_k), V_x), lu[:, k] + mv(mT(B_k), V_x)
        Q_xx = lxx[:, k] + mT(A_k) @ V_xx @ A_k
        Q_ux = lux[:, k] + mT(B_k) @ V_xx @ A_k
        Q_uu = luu[:, k] + mT(B_k) @ V_xx @ B_k + reg * eye
        Kk = -torch.linalg.solve_ex(Q_uu, torch.cat([Q_ux, Q_u[..., None]], dim=-1))[0]
        K, kff = Kk[..., :-1], Kk[..., -1]
        V_x, V_xx = Q_x + mv(mT(K), Q_u), Q_xx + mT(K) @ Q_ux
        xs.insert(0, V_x)
        xxs.insert(0, V_xx)
        Ks.insert(0, K)
        ks.insert(0, kff)
    st = lambda ts: torch.stack(ts, dim=1)
    return st(xs), st(xxs), st(Ks), st(ks)


def held_close(torch, what, got, ref, tol, problems):
    """Log max |got - ref| and the worst |got - ref| / (atol + rtol |ref|); a miss (or a
    value not finite) goes to `problems`."""
    rtol, atol = tol
    got, ref = got.detach().to("cpu", torch.float64), ref.detach().to("cpu", torch.float64)
    d = (got - ref).abs()
    ok = bool(torch.isfinite(got).all() and torch.isfinite(ref).all()
              and (d <= atol + rtol * ref.abs()).all())
    log(f"[pscan] {what}: max |diff| = {float(d.max())!r}, worst share of the tolerance "
        f"{float((d / (atol + rtol * ref.abs())).max())!r} (rtol {rtol}, atol {atol}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        problems.append(what)


def pscan_agreement(torch, dev, problems):
    """Phase pscan (a): every public function of solvers/pscan.py on the card at PSCAN_B
    lanes in f64, on PSCAN_SHAPES: against the sequential forms on the card, and against
    the same call on the CPU; the sequential sweep's gains also against the exact
    recursion."""
    from tube_mpc_tpu_torch.solvers.ilqr import _backward_pass
    from tube_mpc_tpu_torch.solvers.pscan import (parallel_affine_rollout,
                                                   parallel_backward_pass, riccati_value_sweep)

    f64 = torch.float64
    for i, (n, m, Ns) in enumerate(PSCAN_SHAPES):
        t0 = time.perf_counter()
        at = f"(n̂, nu, N) = ({n}, {m}, {Ns}), B={PSCAN_B}, f64"
        cpu = pscan_lq(torch, SEED + 100 + i, PSCAN_B, Ns, n, m, f64)
        data = [t.to(dev) for t in cpu]
        K_p, k_p = parallel_backward_pass(*data, 1e-9)
        K_s, k_s = _backward_pass(*data, 1e-9)
        _, _, K_e, k_e = exact_recursion(torch, *data, reg=1e-9)
        for name, got, ref in (("K", K_p, K_s), ("kff", k_p, k_s)):
            exact = K_e if name == "K" else k_e
            held_close(torch, f"{at}: parallel_backward_pass {name} - the sequential sweep's",
                       got, ref, PSCAN_TOL["gains"], problems)
            held_close(torch, f"{at}: parallel_backward_pass {name} - the exact recursion's",
                       got, exact, PSCAN_TOL["gains"], problems)
            held_close(torch, f"{at}: the sequential sweep's {name} - the exact recursion's",
                       ref, exact, PSCAN_TOL["gains"], problems)
        V_x, V_xx = riccati_value_sweep(*data, elem_reg=0.0)
        E_x, E_xx, K0, k0 = exact_recursion(torch, *data)
        held_close(torch, f"{at}: riccati_value_sweep V_x - the exact recursion's", V_x, E_x,
                   PSCAN_TOL["values"], problems)
        held_close(torch, f"{at}: riccati_value_sweep V_xx - the exact recursion's", V_xx, E_xx,
                   PSCAN_TOL["values"], problems)
        # the closed-loop δ-rollout of the exact gains: x_{k+1} = (A + B K) x_k + B kff
        F = data[0] + data[1] @ K0
        c = (data[1] @ k0[..., None])[..., 0]
        x0 = torch.randn(PSCAN_B, n, generator=torch.Generator().manual_seed(SEED + 110 + i),
                         dtype=f64).to(dev)
        X = parallel_affine_rollout(F, c, x0)
        x, loop = x0, [x0]
        for k in range(Ns):
            x = (F[:, k] @ x[..., None])[..., 0] + c[:, k]
            loop.append(x)
        held_close(torch, f"{at}: parallel_affine_rollout - the loop", X,
                   torch.stack(loop, dim=1), PSCAN_TOL["rollout"], problems)
        on_cpu = (parallel_backward_pass(*cpu, 1e-9), riccati_value_sweep(*cpu, elem_reg=0.0),
                  parallel_affine_rollout(F.cpu(), c.cpu(), x0.cpu()))
        for name, got, ref in (("K", K_p, on_cpu[0][0]), ("kff", k_p, on_cpu[0][1]),
                               ("V_x", V_x, on_cpu[1][0]), ("V_xx", V_xx, on_cpu[1][1]),
                               ("rollout X", X, on_cpu[2])):
            held_close(torch, f"{at}: {name}, card - cpu", got, ref, PSCAN_TOL["cpu"], problems)
        torch.cuda.synchronize()
        log(f"[pscan] {at}: held in {time.perf_counter() - t0:.1f} s")


def pscan_dubins(torch, where, lanes, dtype):
    """tests/test_pscan.py:94-117's Dubins nominal OCP at PSCAN_DUBINS_N on `lanes` lanes
    whose starts differ (lane 0 the test's own start; the others moved from it by a seeded
    draw): (ocp, theta, x_hat0, U0, its ILQRConfig with horizon_parallel)."""
    import math

    from tube_mpc_tpu_torch.ops.costs import CostWeights
    from tube_mpc_tpu_torch.ops.dbas import BarrierParams, make_augmented
    from tube_mpc_tpu_torch.solvers.ilqr import ILQRConfig
    from tube_mpc_tpu_torch.systems.dubins import DubinsConfig, make_dubins
    from tube_mpc_tpu_torch.systems.obstacles import CircleField
    from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp

    t = lambda v: torch.as_tensor(v, dtype=dtype, device=where)
    system = make_dubins(DubinsConfig(dt=0.01), obstacles=CircleField(
        centers=t([[4.0, 2.0], [2.0, 4.0]]), radii=t([1.0, 1.0])), aggregation="smoothmin",
        beta=20.0, device=where, dtype=dtype)
    aug = make_augmented(system, barrier_type="inverse", eps=1e-4)
    ocp = make_nominal_ocp(system, aug, t([10.0, 10.0, math.pi / 4]))
    theta = NominalTheta(
        w=expand_lanes(CostWeights.create([1.0, 1.0, 0.0], [1.0, 1.0], [1000.0] * 3, 1.0,
                                          device=where, dtype=dtype), lanes),
        bp=expand_lanes(BarrierParams.create(0.0, 0.0, 0.0, device=where, dtype=dtype), lanes))
    move = torch.rand(lanes, 3, generator=torch.Generator().manual_seed(SEED + 120),
                      dtype=dtype) - 0.5
    move[0] = 0.0
    x_hat0 = torch.tensor([0.0, 0.0, math.pi / 4, 0.1], dtype=dtype) + torch.cat(
        [move * torch.tensor([1.0, 1.0, 0.6], dtype=dtype), torch.zeros(lanes, 1, dtype=dtype)],
        dim=-1)
    cfg = ILQRConfig(max_iter=10, tol=1e-3, reg=1e-6, alphas=(1.0, 0.5, 0.25, 0.1, 0.0),
                     horizon_parallel=True)
    U0 = torch.zeros((lanes, PSCAN_DUBINS_N, 2), dtype=dtype, device=where)
    return ocp, theta, x_hat0.to(where), U0, cfg


def pscan_quadrotor(torch, where, lanes, dtype, gen):
    """The quadrotor's nominal OCP (presets.family_paper_setup at its config's N) on `lanes`
    lanes whose positions are moved by up to ±0.2 from the setup's start by `gen`'s draw:
    (ocp, theta, x_hat0, U0 (zeros), its nominal ILQRConfig with horizon_parallel, N)."""
    from tube_mpc_tpu_torch.presets import family_paper_setup
    from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp
    from tube_mpc_tpu_torch.utils.config import load_config

    Nq = load_config("configs/quadrotor2d.yaml").system.horizon_N
    ps = family_paper_setup("quadrotor2d", N=Nq, H=1, device=where, dtype=dtype)
    ocp = make_nominal_ocp(ps.system, ps.aug, ps.target)
    theta = NominalTheta(expand_lanes(ps.w_nominal, lanes), expand_lanes(ps.bp, lanes))
    x0 = ps.x0.expand(lanes, -1).clone()
    x0[:, :2] += 0.4 * (torch.rand(lanes, 2, generator=gen, dtype=dtype,
                                   device=gen.device).to(where) - 0.5)
    x_hat0 = torch.cat([x0, ps.aug.init_b0(x0, ps.bp)[:, None]], dim=-1)
    U0 = torch.zeros((lanes, Nq, ps.system.nu), dtype=dtype, device=where)
    cfg = dataclasses.replace(ps.cfg.nominal_ilqr(), horizon_parallel=True)
    return ocp, theta, x_hat0, U0, cfg, Nq


def pscan_case64(torch, name, where):
    """Phase pscan (b)'s OCP `name` at PSCAN_B lanes in f64 on `where`, the same on every
    device: (ocp, theta, x_hat0, U0, its ILQRConfig with horizon_parallel)."""
    if name == "dubins":
        return pscan_dubins(torch, where, PSCAN_B, torch.float64)
    return pscan_quadrotor(torch, where, PSCAN_B, torch.float64,
                           torch.Generator().manual_seed(SEED + 121))[:5]


def cpu_pscan_solves():
    """Phase pscan (b)'s CPU side, in a worker process: the horizon-parallel f64 solve of each
    of PSCAN_SOLVES on the CPU -> ({name: (X, U)} as numpy, seconds)."""
    import torch

    from tube_mpc_tpu_torch.solvers.ilqr import ilqr_solve

    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    out = {}
    for name in PSCAN_SOLVES:
        ocp, theta, x_hat0, U0, cfg = pscan_case64(torch, name, "cpu")
        X, U = ilqr_solve(ocp, cfg, theta, x_hat0, U0)
        out[name] = (X.numpy(), U.numpy())
    return out, time.perf_counter() - t0


def pscan_solves64(torch, dev, problems, cpu_solves):
    """Phase pscan (b): ilqr_solve with horizon_parallel in f64 at PSCAN_B lanes, against
    the same solve on the CPU (cpu_solves: cpu_pscan_solves' job) at XLA_LOOP_TOL: Dubins
    (N=PSCAN_DUBINS_N), also against horizon_parallel=False on the card from
    tests/test_pscan.py's start at its tolerances, and the quadrotor (its config's N,
    n̂ = 7). Each lane's difference from the sequential solve is printed."""
    from tube_mpc_tpu_torch.solvers.ilqr import ilqr_solve

    xtol = XLA_LOOP_TOL["x_real"]
    on_cpu = None
    for name in PSCAN_SOLVES:
        t0 = time.perf_counter()
        ocp, theta, x_hat0, U0, cfg = pscan_case64(torch, name, dev)
        Nb = U0.shape[1]
        X_p, U_p = ilqr_solve(ocp, cfg, theta, x_hat0, U0)
        X_s, U_s = ilqr_solve(ocp, dataclasses.replace(cfg, horizon_parallel=False), theta,
                              x_hat0, U0)
        torch.cuda.synchronize()
        if on_cpu is None:
            on_cpu, cpu_s = cpu_solves.get()
            log(f"[pscan] (b) the CPU's solves took {cpu_s:.1f} s in a worker process")
        X_c, U_c = (torch.as_tensor(a) for a in on_cpu[name])
        at = f"{name} nominal solve, B={PSCAN_B}, N={Nb}, f64"
        held_close(torch, f"{at}: horizon_parallel X, card - cpu", X_p, X_c, xtol, problems)
        held_close(torch, f"{at}: horizon_parallel U, card - cpu", U_p, U_c, xtol, problems)
        # tests/test_pscan.py:120-121 holds the two forms' solves from its one start (lane 0
        # here). From other starts the O(reg) difference of the split and the exact value
        # updates moves the nonlinear iterates farther, in the JAX package too
        # (tests/test_torch_pscan_solve.py), so those lanes' difference is printed only.
        if name == "dubins":
            held_close(torch, f"{at}: U, horizon_parallel - sequential, lane 0", U_p[:1],
                       U_s[:1], PSCAN_TOL["solve"], problems)
            held_close(torch, f"{at}: X, horizon_parallel - sequential, lane 0", X_p[:1],
                       X_s[:1], PSCAN_TOL["solve"], problems)
        du = (U_p - U_s).abs().amax(dim=(1, 2))
        rtol, atol = PSCAN_TOL["solve"]
        outside = ((U_p - U_s).abs() > atol + rtol * U_s.abs()).any(dim=(1, 2))
        log(f"[pscan] {at}: horizon_parallel - sequential over the lanes (not held): max |dU| "
            f"a lane median {float(du.median())!r}, max {float(du.max())!r}; max |dX| "
            f"{float((X_p - X_s).abs().max())!r}; lanes outside rtol {rtol}, atol {atol}: "
            f"{int(outside.sum())} of {PSCAN_B}")
        log(f"[pscan] {at}: {time.perf_counter() - t0:.1f} s")


def pscan_full_width(torch, dev, x_last, problems):
    """Phase pscan (c): the Dubins nominal solve of phase xla (B lanes from the paper run's
    last states, N, zero controls) and the quadrotor's nominal solve (B lanes, its config's
    N), in f32, with horizon_parallel True and False: iterations, ms, peak memory, the share
    of lanes with X and U finite (>= 0.99 required), lanes kept at their start, and (not
    held) the lanes' max |U_par - U_seq| and the relative difference of their total cost."""
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.solvers import ilqr
    from tube_mpc_tpu_torch.solvers.ocp import total_cost
    from tube_mpc_tpu_torch.tube.problem import NominalTheta, expand_lanes, make_nominal_ocp

    f32 = torch.float32
    ps = dubins_paper_setup(N=N, H=XLA_H, device=dev, dtype=f32)
    x_hat = torch.cat([x_last, ps.aug.init_b0(x_last, ps.bp)[:, None]], dim=-1)
    cases = {"dubins": (make_nominal_ocp(ps.system, ps.aug, ps.target),
                        NominalTheta(expand_lanes(ps.w_nominal, B), expand_lanes(ps.bp, B)),
                        x_hat, torch.zeros((B, N, ps.system.nu), dtype=f32, device=dev),
                        dataclasses.replace(ps.cfg.nominal_ilqr(), horizon_parallel=True), N)}
    cases["quadrotor2d"] = pscan_quadrotor(
        torch, dev, B, f32, torch.Generator(device=dev).manual_seed(SEED + 122))
    iterations, linearize = [0], ilqr._linearize

    def counted(*args):
        iterations[0] += 1
        return linearize(*args)

    q = torch.tensor([0.5, 0.9, 0.99, 1.0], device=dev)
    for name, (ocp, theta, x0, U0, cfg, Nc) in cases.items():
        out = {}
        for par in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            iterations[0] = 0
            ilqr._linearize = counted
            try:
                t0 = time.perf_counter()
                X, U = ilqr.ilqr_solve(ocp, dataclasses.replace(cfg, horizon_parallel=par),
                                       theta, x0, U0)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            finally:
                ilqr._linearize = linearize
            finite = torch.isfinite(X).all(dim=(1, 2)) & torch.isfinite(U).all(dim=(1, 2))
            kept = (U == ocp.clamp(U0)).all(dim=(1, 2))
            out[par] = (X, U, total_cost(ocp, theta, X, U))
            form = "horizon_parallel" if par else "sequential"
            frac = float(finite.float().mean())
            log(f"[pscan] {name} nominal solve, B={B}, N={Nc}, f32, {form}: {iterations[0]} "
                f"iterations (max_iter {cfg.max_iter}), {ms:.1f} ms, "
                f"{ms / max(iterations[0], 1):.1f} ms an iteration, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, finite lanes {frac!r}, "
                f"lanes kept at their start {int(kept.sum())}")
            if frac < 0.99 or iterations[0] == 0:
                problems.append(f"{name} {form}: finite lanes {frac}, {iterations[0]} iterations")
        (X_p, U_p, J_p), (X_s, U_s, J_s) = out[True], out[False]
        du = (U_p - U_s).abs().amax(dim=(1, 2))
        dj = (J_p - J_s).abs() / J_s.abs()
        log(f"[pscan] {name}, B={B}, N={Nc}, f32, horizon_parallel - sequential (not held), "
            f"quantiles 0.5, 0.9, 0.99, 1 over the lanes: max |dU| "
            f"{[float(v) for v in torch.nanquantile(du, q)]}, |dJ| / |J| "
            f"{[float(v) for v in torch.nanquantile(dj, q)]}; total cost median "
            f"{float(J_p.nanmedian())!r} (horizon_parallel), {float(J_s.nanmedian())!r} "
            f"(sequential), their ratio {float(J_s.nanmedian() / J_p.nanmedian())!r}")
        del out, X_p, U_p, X_s, U_s


def pscan_times(torch, dev):
    """Phase pscan (d): the sequential sweep (solvers/ilqr.py::_backward_pass) and the scan
    (solvers/pscan.py::parallel_backward_pass) in f32 at n̂ = 4, nu = 2 on
    benchmarks/bench_pscan.py's points (PSCAN_TIMES, its _data recipe, reg 1e-6): the
    device's busy time and kernels in one profiled call (the warm-up), then the wall a call
    (synchronised; median) and the time between CUDA events recorded around each call
    (median)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from tube_mpc_tpu_torch.solvers.ilqr import _backward_pass
    from tube_mpc_tpu_torch.solvers.pscan import parallel_backward_pass

    def timed(fn, calls):
        # the profiled call is the warm-up; its device events are read from the raw trace
        # (key_averages would take seconds a call over the sequential sweep's 10^5 kernels)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA and e.duration_ns() > 0]
        walls, events = [], []
        for _ in range(calls):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            events.append(start.elapsed_time(end))
        return statistics.median(walls), statistics.median(events), sum(kernels) / 1e6, len(kernels)

    log(f"[pscan] times on {nvidia_smi()}: f32, n̂=4, nu=2, reg 1e-6; wall ms a call "
        f"(median of {PSCAN_CALLS} after a profiled warm-up; the sequential sweep at N >= "
        f"{PSCAN_LONG_N} of {PSCAN_CALLS_LONG}), events ms (median), device busy ms and "
        f"kernels (the profiled call)")
    rows = []
    for Nt, Bt in PSCAN_TIMES:
        t0 = time.perf_counter()
        data = [t.to(dev) for t in pscan_lq(torch, SEED + 130, Bt, Nt, 4, 2, torch.float32,
                                            bench=True)]
        seq = timed(lambda: _backward_pass(*data, 1e-6),
                    PSCAN_CALLS_LONG if Nt >= PSCAN_LONG_N else PSCAN_CALLS)
        par = timed(lambda: parallel_backward_pass(*data, 1e-6), PSCAN_CALLS)
        rows.append((Nt, Bt, seq, par))
        log(f"[pscan] times N={Nt}, B={Bt}: sequential wall {seq[0]:.2f} ms, events "
            f"{seq[1]:.2f} ms, busy {seq[2]:.3f} ms over {seq[3]} kernels; scan wall "
            f"{par[0]:.2f} ms, events {par[1]:.2f} ms, busy {par[2]:.3f} ms over {par[3]} "
            f"kernels; scan / sequential wall {par[0] / seq[0]:.3f}, busy {par[2] / seq[2]:.3f} "
            f"(the point {time.perf_counter() - t0:.1f} s)")
        del data
    return rows


def pscan_phase(torch, dev, t_start, x_last, cpu_solves):
    """Phase pscan: solvers/pscan.py and ILQRConfig.horizon_parallel on the card, (a)-(d) of
    the functions above (cpu_solves: the worker job of cpu_pscan_solves); any miss fails
    the run."""
    t0 = time.perf_counter()
    problems = []
    pscan_agreement(torch, dev, problems)
    log(f"[pscan] (a) done in {time.perf_counter() - t0:.1f} s")
    pscan_solves64(torch, dev, problems, cpu_solves)
    log(f"[pscan] (b) done at {time.perf_counter() - t0:.1f} s of the phase")
    pscan_full_width(torch, dev, x_last, problems)
    log(f"[pscan] (c) done at {time.perf_counter() - t0:.1f} s of the phase")
    pscan_times(torch, dev)
    if problems:
        raise SystemExit(f"chip_smoke: the horizon-parallel sweep failed its checks: {problems}")
    log(f"[pscan] done at {time.perf_counter() - t_start:.0f} s (the phase "
        f"{time.perf_counter() - t0:.1f} s)")


def bench_setup(family, where):
    """bench.py's paper setup of `family` in f32 at N and H: presets.dubins_paper_setup, or
    configs/<family>.yaml (presets.family_paper_setup)."""
    import torch

    from tube_mpc_tpu_torch.presets import dubins_paper_setup, family_paper_setup

    if family == "dubins":
        return dubins_paper_setup(N=N, H=H, device=where, dtype=torch.float32)
    return family_paper_setup(family, N=N, H=H, device=where, dtype=torch.float32)


def bench_draw(system, where):
    """bench.py:267's draw: system.sample_disturbance(PRNGKey(0), (B, H)) in f32 on `where`."""
    import torch

    from tube_mpc_tpu_torch.utils.prng import PRNGKey

    return system.sample_disturbance(PRNGKey(0, where), (B, H), dtype=torch.float32)


def sha256(array) -> str:
    """The SHA-256 of a float32 array's values, little-endian, in C order."""
    import hashlib

    return hashlib.sha256(array.astype("<f4").tobytes()).hexdigest()


def cpu_bench_draws():
    """Phase prng (a)'s CPU side, in a worker process: the SHA-256 of each family's
    bench_draw on the CPU -> ({family: digest}, seconds)."""
    t0 = time.perf_counter()
    out = {f: sha256(bench_draw(bench_setup(f, "cpu").system, "cpu").numpy())
           for f in PRNG_FAMILIES}
    return out, time.perf_counter() - t0


def prng_phase(torch, dev, t_start, cpu_draws):
    """Phase prng: (a) each family's bench.py draw (bench_draw) on the card, bitwise the
    CPU's (cpu_draws: cpu_bench_draws' job) and the JAX package's (PRNG_JAX_SHA256); (b)
    PRNG_LOOP's paper loop on its draw at full width: finite_lane_frac (>= 0.99), the lanes
    whose last loss is not finite and each one's first step with a logged value not
    finite; (c) the quadrotor's first nominal iteration (pscan_quadrotor, f32): the
    sequential sweep's gains on the card against the exact recursion in f64 on the CPU,
    within PRNG_K_TOL. Any miss fails the run."""
    from tube_mpc_tpu_torch.solvers import ilqr
    from tube_mpc_tpu_torch.tube.closed_loop import ClosedLoopLog

    t0 = time.perf_counter()
    problems = []
    on_cpu, cpu_s = cpu_draws.get()
    log(f"[prng] (a) the CPU's draws took {cpu_s:.1f} s in a worker process")
    for family in PRNG_FAMILIES:
        s = bench_setup(family, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w = bench_draw(s.system, dev)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        digest = sha256(w.cpu().numpy())
        same = (digest == on_cpu[family], digest == PRNG_JAX_SHA256[family])
        log(f"[prng] (a) {family}: sample_disturbance(PRNGKey(0), ({B}, {H})) f32, "
            f"{tuple(w.shape)}, in {ms:.1f} ms on the card, min {float(w.min())!r}, max "
            f"{float(w.max())!r}; SHA-256 {digest}: the CPU's {'same' if same[0] else 'DIFFERS'}"
            f", the JAX package's {'same' if same[1] else 'DIFFERS'} -> "
            f"{'ok' if all(same) else 'FAIL'}")
        if not all(same):
            problems.append(f"(a) {family}'s draw (cpu, jax: {same})")
        if family == PRNG_LOOP:
            loop = (s, w)
        del s, w
    log(f"[prng] (a) done in {time.perf_counter() - t0:.1f} s")

    s, w = loop
    t1 = time.perf_counter()
    out = run_paper_loop(s, w, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    finite = torch.isfinite(out.loss[:, -1])
    frac = float(finite.float().mean())
    # a step is finite where every logged value of the lane is
    ok = torch.stack([torch.isfinite(getattr(out, f)).reshape(B, H, -1).all(dim=-1)
                      for f in ClosedLoopLog._fields]).all(dim=0)
    lanes = (~finite).nonzero()[:, 0].tolist()
    first = (~ok).float().argmax(dim=1)
    shown = {b: int(first[b]) for b in lanes[:PRNG_LANES_SHOWN]}
    log(f"[prng] (b) {PRNG_LOOP} paper loop on its bench.py draw, B={B}, N={N}, H={H}, f32: "
        f"{wall:.3f} s, finite_lane_frac {frac!r}, {len(lanes)} lanes not finite; lane: first "
        f"step not finite {json.dumps(shown)}")
    if frac < 0.99:
        problems.append(f"(b) finite_lane_frac {frac} < 0.99")
    del out, loop, s, w

    t1 = time.perf_counter()
    ocp, theta, x0, U0, cfg, Nq = pscan_quadrotor(
        torch, dev, B, torch.float32, torch.Generator(device=dev).manual_seed(SEED + 122))
    U = ocp.clamp(U0)
    lin = [t[:PRNG_K_LANES] for t in ilqr._linearize(ocp, theta, ilqr.rollout(ocp, theta, x0, U),
                                                     U)]
    K = ilqr._backward_pass(*lin, cfg.reg)[0].cpu().double()
    exact = exact_recursion(torch, *(t.cpu().double() for t in lin), reg=cfg.reg)[2]
    err = float((K - exact).abs().max())
    ok_k = bool(torch.isfinite(K).all()) and err <= PRNG_K_TOL
    log(f"[prng] (c) quadrotor2d, first nominal iteration, N={Nq}, {PRNG_K_LANES} lanes, f32 "
        f"on the card, reg {cfg.reg}: the sequential sweep's max |K - K_exact| = {err!r} "
        f"(max |K_exact| {float(exact.abs().max())!r}; held <= {PRNG_K_TOL}) -> "
        f"{'ok' if ok_k else 'FAIL'} ({time.perf_counter() - t1:.1f} s)")
    if not ok_k:
        problems.append(f"(c) the sequential gains are {err} off")
    if problems:
        raise SystemExit(f"chip_smoke: phase prng failed: {problems}")
    log(f"[prng] done at {time.perf_counter() - t_start:.0f} s (the phase "
        f"{time.perf_counter() - t0:.1f} s)")


def bitwise(a, b) -> bool:
    """Whether two tensors hold the same values, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def scenario_phases(torch, dev, t_start, cpu_pop64):
    """The scenario layer's phases (the module's docstring): population, scenarios, sharded.
    Each lane run's launches are counted from 0 and must come from Dubins' libraries, K1-K4
    all launched and K3/K4 once a step."""
    import math
    import shutil
    import socket
    import tempfile

    import torch.distributed as dist

    from tube_mpc_tpu_torch.ops.costs import CostWeights
    from tube_mpc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.parallel import (
        init_distributed, make_mesh, run_population_adaptation, tube_verification)
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import run_paper_closed_loop_lanes_sharded

    f32 = torch.float32

    def timed(run):
        """(run's result, its wall in s, the lane kernels' launches), the counts from 0."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launch_counts()

    def lane_kernels_ran(phase, counts, steps):
        problems = [k for k in PAPER if counts[k] == 0]
        problems += [f"{k}: {counts[k]}" for k in ("sbwd", "sfwd") if counts[k] != steps]
        problems += [f"{k} from {v}" for k, v in launch_counts(by_system=True) if v != "dubins"]
        if problems:
            raise SystemExit(f"chip_smoke: {phase}: the lane kernels' launches are wrong "
                             f"(K3/K4 once a step, {steps}): {problems}")

    def rate(phase, what, wall, lanes, steps, finite):
        log(f"[{phase}] {what}: B={lanes}, N={N}, H={steps} f32: {wall:.3f} s, "
            f"{1e3 * wall / steps:.1f} ms/step, {2 * steps * lanes / wall:.1f} solves/s "
            f"(2*H*B / elapsed), finite_lane_frac {finite!r}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    def shared(out):
        return all(torch.equal(h, h[:1].expand_as(h)) for h in (out.Q_hist, out.R_hist,
                                                                  out.qb_hist))

    # ---- population: the paper lane loop, one θ shared by the lanes ---------------------
    s = dubins_paper_setup(N=N, H=H, device=dev, dtype=f32)
    w = torch_draw(s.system, torch.Generator(device=dev).manual_seed(SEED + 80), (B, H),
                   f32)
    out, wall, counts = timed(lambda: run_paper_loop(s, w, dev, population=True))
    finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
    moved = float((out.Q_hist[0, -1] - s.aux_init.Q).abs().max())
    rate("population", "the paper lane loop, population=True", wall, B, H, finite)
    log(f"[population] launches: {json.dumps(counts)}; θ the same on every lane at every step: "
        f"{shared(out)}; final Q {out.Q_hist[0, -1].tolist()}, R {out.R_hist[0, -1].tolist()}, "
        f"qb {float(out.qb_hist[0, -1])!r} (max |Q - Q0| {moved!r})")
    lane_kernels_ran("population", counts, H)
    if finite < 0.99 or not shared(out) or moved == 0.0:
        raise SystemExit(f"chip_smoke: population: finite_lane_frac {finite}, θ shared "
                         f"{shared(out)}, θ moved by {moved}")
    if tuple(out.Q_hist.shape) != (B, H, 3) or tuple(out.loss.shape) != (B, H):
        raise SystemExit("chip_smoke: population: the log has the wrong shapes")
    del out

    # ---- scenarios: tube verification on both engines, the population Algorithm 2 ------
    w_aux = CostWeights(Q=s.aux_init.Q, R=s.aux_init.R, Qf=s.aux_init.Q, qb=s.aux_init.qb)

    def verified(what, logs, stats, lanes, steps):
        nums = {k: float(v) for k, v in stats._asdict().items() if k != "deviations"}
        frozen = torch.equal(logs.Q_hist[:, 0], logs.Q_hist[:, -1])
        log(f"[scenarios] tube_verification {what}: {json.dumps(nums)}; θ frozen: {frozen}")
        if not (all(math.isfinite(v) for v in nums.values()) and frozen
                and bool(torch.isfinite(stats.deviations).all())
                and tuple(stats.deviations.shape) == (lanes, steps)):
            raise SystemExit(f"chip_smoke: scenarios: tube_verification {what} failed")

    (logs, stats), wall, counts = timed(lambda: tube_verification(
        s.system, s.aug, s.cfg, w_nominal=s.w_nominal, w_aux=w_aux, bp=s.bp, x0=s.x0,
        target=s.target, w_seqs=w, sys_c=s.sys_c, eps=s.eps, device=dev))
    rate("scenarios", "tube_verification on the lane kernels", wall, B, H,
         float(torch.isfinite(logs.loss[:, -1]).float().mean()))
    log(f"[scenarios] launches: {json.dumps(counts)}")
    lane_kernels_ran("scenarios", counts, H)
    verified("on the lane kernels", logs, stats, B, H)
    del logs, stats

    sx = dubins_paper_setup(N=N, H=XLA_H, device=dev, dtype=f32)
    wx = w[:, :XLA_H].contiguous()
    log(f"[scenarios] the XLA engine's runs at H={XLA_H} (cut from {H}: ~2-3 s a step)")
    (logs, stats), wall, _ = timed(lambda: tube_verification(
        sx.system, sx.aug, sx.cfg, w_nominal=sx.w_nominal, w_aux=w_aux, bp=sx.bp, x0=sx.x0,
        target=sx.target, w_seqs=wx, device=dev))
    rate("scenarios", "tube_verification on the XLA engine", wall, B, XLA_H,
         float(torch.isfinite(logs.loss[:, -1]).float().mean()))
    verified("on the XLA engine", logs, stats, B, XLA_H)
    del logs, stats
    x0_b = sx.x0.expand(B, 3).contiguous()

    def population_run(mesh=None):
        return run_population_adaptation(sx.system, sx.aug, sx.cfg, w_nominal=sx.w_nominal,
                                         aux_init=sx.aux_init, bp=sx.bp, x0_batch=x0_b,
                                         target=sx.target, w_seqs=wx, mesh=mesh, device=dev)

    (pop_log, pop_final), wall, _ = timed(population_run)
    ff = float(pop_log.finite_frac.min())
    moved = float((pop_final.Q - sx.aux_init.Q).abs().max())
    rate("scenarios", "run_population_adaptation (mesh=None)", wall, B, XLA_H, ff)
    log(f"[scenarios] population: loss_mean {pop_log.loss_mean.tolist()}, finite_frac "
        f"{pop_log.finite_frac.tolist()}, final Q {pop_final.Q.tolist()} (max |Q - Q0| {moved!r})")
    if not bool(torch.isfinite(pop_log.loss_mean).all()) or ff < 0.99 or moved == 0.0:
        raise SystemExit(f"chip_smoke: scenarios: run_population_adaptation: finite_frac {ff}, "
                         f"θ moved by {moved}")
    # f64, small: the card against the CPU (a worker process) at the XLA loop's tolerances
    t0 = time.perf_counter()
    card = population64_case(torch, dev)()
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    cpu_out, cpu_s = cpu_pop64.get()
    ref_log, ref_final = tree_map(torch.as_tensor, cpu_out)
    log(f"[scenarios] run_population_adaptation f64, B={POP64_B}, N={N}, H={POP64_H}: "
        f"{cpu_s:.1f} s on the cpu (a worker process), {t_card:.1f} s on {dev}")
    bad = []
    for name, got, ref in ([(f"log.{k}", v, getattr(ref_log, k))
                            for k, v in card[0]._asdict().items()]
                           + [(f"final.{k}", v, getattr(ref_final, k))
                              for k, v in card[1]._asdict().items()]):
        rtol, atol = XLA_LOOP_TOL["loss" if name == "log.loss_mean" else "Q_hist"]
        d = (got.cpu() - ref).abs()
        ok = bool((d <= atol + rtol * ref.abs()).all())
        log(f"[scenarios] f64 {name}: max |card - cpu| = {float(d.max())!r} (rtol {rtol}, "
            f"atol {atol}) -> {'ok' if ok else 'FAIL'}")
        bad += [] if ok else [name]
    if bad:
        raise SystemExit(f"chip_smoke: scenarios: run_population_adaptation f64 on the card "
                         f"disagrees with the CPU: {bad}")
    log(f"[scenarios] done at {time.perf_counter() - t_start:.0f} s")

    # ---- sharded: the sharded paths over a one-rank NCCL mesh, bitwise the unsharded ------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    init_distributed(f"tcp://localhost:{port}", world_size=1, rank=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    try:
        mesh = make_mesh(device=dev)
        log(f"[sharded] {mesh}, backend {dist.get_backend()}, H={SHARD_H} (cut from {H})")
        ss = dubins_paper_setup(N=N, H=SHARD_H, device=dev, dtype=f32)
        ws = w[:, :SHARD_H].contiguous()
        for population in (False, True):
            mode = "population" if population else "independent"
            ref, wall_ref, _ = timed(lambda: run_paper_loop(ss, ws, dev, population=population))

            def sharded(**kw):
                return run_paper_closed_loop_lanes_sharded(
                    ss.system, ss.aug, ss.sys_c, ss.cfg, w_nominal=ss.w_nominal,
                    aux_init=ss.aux_init, bp=ss.bp, x0=ss.x0, target=ss.target, w_seqs=ws,
                    mesh=mesh, eps=ss.eps, population=population, device=dev, **kw)

            out, wall, counts = timed(sharded)
            lane_kernels_ran(f"sharded {mode}", counts, SHARD_H)
            ck = os.path.join(tmp, mode)
            full, wall_ck, _ = timed(lambda: sharded(ckpt_dir=ck, segment_len=SHARD_H // 2))
            for name in (f"state_{SHARD_H}.npz", f"logs_{SHARD_H}.npz"):
                os.remove(os.path.join(ck, name))
            resumed, wall_res, _ = timed(lambda: sharded(ckpt_dir=ck, segment_len=SHARD_H // 2))
            same = {what: [f for f in ref._fields if not bitwise(getattr(o, f), getattr(ref, f))]
                    for what, o in (("sharded", out), ("checkpointed", full),
                                    ("resumed", resumed))}
            log(f"[sharded] {mode}: unsharded {wall_ref:.3f} s, sharded {wall:.3f} s, "
                f"checkpointed every {SHARD_H // 2} {wall_ck:.3f} s, resumed from step "
                f"{SHARD_H // 2} {wall_res:.3f} s; launches {json.dumps(counts)}; fields not "
                f"bitwise the unsharded run's: {json.dumps(same)}")
            if any(same.values()):
                raise SystemExit(f"chip_smoke: sharded {mode}: not bitwise the unsharded loop: "
                                 f"{same}")
            del ref, out, full, resumed
        (mesh_log, mesh_final), wall, _ = timed(lambda: population_run(mesh))
        same = [k for k in pop_log._fields if not bitwise(getattr(mesh_log, k), getattr(pop_log, k))]
        same += [k for k in pop_final._fields if not bitwise(getattr(mesh_final, k),
                                                              getattr(pop_final, k))]
        log(f"[sharded] run_population_adaptation over the mesh: {wall:.3f} s at B={B}, "
            f"H={XLA_H}; fields not bitwise mesh=None's: {same}")
        if same:
            raise SystemExit(f"chip_smoke: sharded: run_population_adaptation over the mesh is "
                             f"not bitwise mesh=None's: {same}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    log(f"[sharded] done at {time.perf_counter() - t_start:.0f} s")


def compact_phase(torch, dev, t_start, cases, paper_w):
    """Phase compact: straggler compaction at full width (B=16384, N=50, H=300, f32), on
    the paper loop with COMPACT_CAPS["paper"] and the coupled loop with
    COMPACT_CAPS["coupled"], each against its uncompacted run (phases main and coupled):
    every log field (and the coupled loop's final raw θ, θ̄) bitwise equal; the launches
    of K1 and K2 by width and the loop's compacted and full-width stages (the counts set
    to 0 just before each run); the walls of the two versions, run in the order AB_ORDER
    (every run bitwise equal to the phase's uncompacted run). The paper loop runs again
    through the step with iter_telemetry, compacted, for each lane's iterations a solve
    (bitwise too). K1 and K2 are timed at COMPACT_WIDTHS. Fails unless a loop took a
    compacted stage. `cases` is {kind: (run(caps) -> result, uncompacted result, its
    wall)}; paper_w the paper runs' disturbances."""
    from tube_mpc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.ops.cuda.lane_solver import lane_ilqr_solve, stage_widths
    from tube_mpc_tpu_torch.presets import dubins_paper_setup
    from tube_mpc_tpu_torch.tube.lane_closed_loop import (
        make_paper_lane_step, paper_lane_init_state)
    from tube_mpc_tpu_torch.tube.lane_interface import make_lane_problem

    problems, compacted = [], 0
    for kind, (run, ref, first_wall) in cases.items():
        caps = COMPACT_CAPS[kind]
        walls, stages, widths = [], None, None
        for label in AB_ORDER:
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = run(caps if label == "compacted" else ())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got = loop_fields(out)
            diffs = {f: bitwise(got[f], v) for f, v in loop_fields(ref).items()}
            problems += [f"{kind} {label} run {len(walls)}: {f} differs"
                         for f, ok in diffs.items() if not ok]
            if not all(n for k, n in launch_counts().items() if k in ("ric", "fwd")):
                problems.append(f"{kind} {label} run {len(walls)}: K1 or K2 not launched")
            if label == "compacted" and stages is None:
                stages = dict(lane_ilqr_solve.stages)
                widths = {f"{k} at {b}": n for (k, b), n
                          in sorted(launch_counts(by_width=True).items()) if k in ("ric", "fwd")}
            log(f"[compact] {kind} run {len(walls)} ({label}): {walls[-1]!r} s, bitwise equal "
                f"to phase {'main' if kind == 'paper' else kind}'s uncompacted run: "
                f"{all(diffs.values())} ({len(diffs)} fields)")
            del out, got
        compacted += stages["compacted"]
        mean = {lb: sum(t for t, o in zip(walls, AB_ORDER) if o == lb) / AB_ORDER.count(lb)
                for lb in set(AB_ORDER)}
        log(f"[compact] {kind}: B={B}, N={N}, H={H} f32, caps {caps} (stage widths "
            f"{stage_widths(B, len(caps))}); walls in the order {'/'.join(AB_ORDER)}: "
            f"{[round(t, 3) for t in walls]} s, mean {mean['compacted']!r} s compacted, "
            f"{mean['uncompacted']!r} s uncompacted ({2 * H * B / mean['compacted']:.1f} and "
            f"{2 * H * B / mean['uncompacted']:.1f} solves/s; the setup's first run, in its "
            f"own phase, {first_wall:.3f} s); stages after the first cap: {json.dumps(stages)}; "
            f"K1/K2 launches by width: {json.dumps(widths)}")

    # the paper loop once more through the step with each lane's iterations (telemetry)
    s = dubins_paper_setup(N=N, H=H, device=dev, dtype=torch.float32)
    ref = cases["paper"][1]
    pb = make_lane_problem(s.sys_c, barrier_type=s.barrier_type, eps=s.eps)
    step = make_paper_lane_step(s.system, s.aug, pb, s.cfg, w_nominal=s.w_nominal, bp=s.bp,
                                target=s.target, B=B, dtype=torch.float32, device=dev,
                                iter_telemetry=True, aux_compact_caps=COMPACT_CAPS["paper"])
    state = paper_lane_init_state(s.system, s.aug, s.cfg, aux_init=s.aux_init, bp=s.bp,
                                  x0=s.x0, B=B, dtype=torch.float32)
    logs = []
    for t in range(H):
        state, lg = step(state, paper_w[:, t])
        logs.append(lg)
    fields = [torch.stack(f, dim=1) for f in zip(*logs)]
    same = all(bitwise(a, b) for a, b in zip(fields[:9], ref))
    log(f"[compact] paper with iter_telemetry: bitwise equal to the uncompacted run: {same}")
    if not same:
        problems.append("paper with iter_telemetry differs")
    for name, it in (("nominal", fields[9]), ("ancillary", fields[10])):
        it = it.float()
        log(f"[compact] paper {name} solve: per-lane iterations a solve mean {float(it.mean())!r}, "
            f"max {int(it.max())}; the batch's iterations a solve (its most) mean "
            f"{float(it.amax(dim=0).mean())!r}")
    del logs, fields, state

    # K1 and K2 at the compaction stages' widths, on a paper step's f32 inputs
    pb, _, make, inputs, _ = paper_step(torch, dev, torch.float32)
    fns = make(pb)
    for name in ("ric", "fwd"):
        kernel = fns[name][0]
        times = {}
        for W in (B,) + COMPACT_WIDTHS:
            ins = tuple(t[..., :W].contiguous() for t in inputs[name])
            times[W] = device_time_ms(torch, lambda: kernel(*ins), RUNS)
        log(f"[compact] f32 {name} ms by width (mean of {RUNS} back to back): "
            + ", ".join(f"{W}: {ms:.4f}" for W, ms in times.items()))
    del inputs, fns
    if compacted == 0:
        problems.append("neither loop took a compacted stage")
    if problems:
        raise SystemExit(f"chip_smoke: compaction failed its checks: {problems}")
    log(f"[compact] done at {time.perf_counter() - t_start:.0f} s")


def same_artifacts(np, a, b):
    """The files of run dir `a` that differ from `b`'s (every .npy bitwise, NaN where NaN;
    the summary but for its times), or that one of them lacks."""
    npys = {f for f in os.listdir(b) if f.endswith(".npy")}
    bad = sorted(npys ^ {f for f in os.listdir(a) if f.endswith(".npy")})
    for f in sorted(npys - set(bad)):
        x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
        if x.shape != y.shape or not np.array_equal(x, y, equal_nan=True):
            bad.append(f)
    summaries = []
    for d in (a, b):
        with open(os.path.join(d, "results_summary.json"), encoding="utf-8") as fh:
            summary = json.load(fh)
        summaries.append({k: v for k, v in summary.items()
                          if k not in ("wall_time_s", "solves_per_sec")})
    if summaries[0] != summaries[1]:
        bad.append("results_summary.json")
    return bad


def cli_ckpt_phase(torch, dev, t_start):
    """Phase cli_ckpt: python -m tube_mpc_tpu_torch.run_experiment --checkpoint-every in-process
    on the card, into a temporary directory that it then removes: configs/dubins.yaml
    (paper) and CKPT_COUPLED's config with adaptation.adapt_nominal: true (coupled) at
    --batch 16384 with --checkpoint-every CKPT_EVERY, at their own N and H, and dubins.yaml
    on --engine xla for one trajectory at H = XLA_CKPT_H with a checkpoint each step. Each
    runs without checkpoints, then with them (uninterrupted), then again with --run-dir
    after its last segment is deleted (a run killed there): both checkpointed runs' artifacts
    must be bitwise those of the run without checkpoints, and the lane runs must launch
    K1 and K2, and their sensitivity kernels once a step run (the counts set to 0 just
    before each run)."""
    import shutil
    import tempfile

    import numpy as np
    import yaml

    from tube_mpc_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.run_experiment import main as cli_main
    from tube_mpc_tpu_torch.utils.checkpoint import _logs_path, latest_checkpoint
    from tube_mpc_tpu_torch.utils.config import read_yaml

    shipped = read_yaml("configs/dubins.yaml")
    coupled = read_yaml(f"configs/{CKPT_COUPLED}.yaml")
    coupled["adaptation"]["adapt_nominal"] = True
    xla = dict(shipped, system=dict(shipped["system"], task_horizon_H=XLA_CKPT_H))
    runs = [("dubins", shipped, ["--batch", str(B)], CKPT_EVERY),
            (f"{CKPT_COUPLED}_coupled", coupled, ["--batch", str(B)], CKPT_EVERY),
            ("dubins_xla", xla, ["--engine", "xla"], 1)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_ckpt_")
    problems = []
    try:
        for name, raw, argv, every in runs:
            path = os.path.join(tmp, f"{name}.yaml")
            with open(path, "w", encoding="utf-8") as f:
                yaml.safe_dump(raw, f)
            Hc = raw["system"]["task_horizon_H"]
            plain_dir, ck_dir = os.path.join(tmp, f"{name}_plain"), os.path.join(tmp, name)
            walls, counts = {}, {}
            for label, run_dir, more in (("without checkpoints", plain_dir, []),
                                         ("checkpointed", ck_dir, ["--checkpoint-every", str(every)]),
                                         ("resumed", ck_dir, ["--checkpoint-every", str(every)])):
                if label == "resumed":
                    last = latest_checkpoint(os.path.join(ck_dir, "ckpt"))
                    for f in (last, last + ".meta.json", _logs_path(last)):
                        os.remove(f)
                    start = int(re.search(r"state_(\d+)", latest_checkpoint(
                        os.path.join(ck_dir, "ckpt"))).group(1))
                torch.cuda.synchronize()
                reset_launch_counts()
                t0 = time.perf_counter()
                res = cli_main(["--config", path, "--run-dir", run_dir] + argv + more)
                walls[label] = (time.perf_counter() - t0, res["summary"]["wall_time_s"])
                counts[label] = launch_counts()
                del res
                if label != "without checkpoints":
                    bad = same_artifacts(np, run_dir, plain_dir)
                    if bad:
                        problems.append(f"{name} {label}: {bad} differ from the run without "
                                        f"checkpoints")
            ck_bytes = sum(os.path.getsize(os.path.join(ck_dir, "ckpt", f))
                           for f in os.listdir(os.path.join(ck_dir, "ckpt")))
            log(f"[cli_ckpt] {name}: N={raw['system']['horizon_N']}, H={Hc}, every {every} "
                f"steps; the call (and the summary's wall_time_s) "
                + ", ".join(f"{k} {c:.3f} s ({w!r} s)" for k, (c, w) in walls.items())
                + f"; resumed from step {start}; {ck_bytes / 2**20:.0f} MiB of checkpoints; "
                f"artifacts bitwise those without checkpoints: "
                f"{not any(p.startswith(name + ' ') for p in problems)}")
            if "xla" not in name:
                log(f"[cli_ckpt] {name} launches: "
                    + "; ".join(f"{k} {json.dumps(c)}" for k, c in counts.items()))
                sens = ("sbwd", "sfwd") if name == "dubins" else COUPLED
                for label, steps in (("checkpointed", Hc), ("resumed", Hc - start)):
                    c = counts[label]
                    if not (c["ric"] and c["fwd"]) or any(c[k] != steps for k in sens):
                        problems.append(f"{name} {label}: launches {c}, not K1 and K2 and "
                                        f"{steps} of each of {sens}")
            shutil.rmtree(plain_dir)
            shutil.rmtree(ck_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise SystemExit(f"chip_smoke: the checkpointed CLI runs failed their checks: {problems}")
    log(f"[cli_ckpt] done at {time.perf_counter() - t_start:.0f} s")


def cli_profile_phase(torch, dev, t_start):
    """Phase cli_profile: python -m tube_mpc_tpu_torch.run_experiment --profile in-process on
    the card, configs/dubins.yaml at --batch 16384 with H cut to PROFILE_CLI_H: the run
    writes one Chrome trace, whose device kernels must name K1 (ric_kernel) and K2
    (fwd_kernel)."""
    import shutil
    import tempfile

    import yaml

    from tube_mpc_tpu_torch.run_experiment import main as cli_main
    from tube_mpc_tpu_torch.utils.config import read_yaml

    shipped = read_yaml("configs/dubins.yaml")
    raw = dict(shipped, system=dict(shipped["system"], task_horizon_H=PROFILE_CLI_H))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_profile_")
    try:
        path = os.path.join(tmp, "dubins.yaml")
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(raw, f)
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        res = cli_main(["--config", path, "--batch", str(B), "--run-dir", os.path.join(tmp, "run"),
                        "--profile", trace_dir])
        elapsed = time.perf_counter() - t0
        files = os.listdir(trace_dir)
        if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
            raise SystemExit(f"chip_smoke: --profile wrote {files}, not one trace")
        trace_path = os.path.join(trace_dir, files[0])
        with open(trace_path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        named = {fn: sum(is_kernel(k, fn, "float") for k in kernels)
                 for fn in ("ric_kernel", "fwd_kernel")}
        log(f"[cli_profile] dubins.yaml at B={B}, H={PROFILE_CLI_H} (cut from 300) with --profile: "
            f"the call {elapsed:.3f} s, the summary's wall_time_s "
            f"{res['summary']['wall_time_s']!r} s; trace {os.path.getsize(trace_path) / 2**20:.1f} "
            f"MiB, {len(events)} events, {len(kernels)} device kernels, of which "
            f"{json.dumps(named)}")
        if not all(named.values()):
            raise SystemExit(f"chip_smoke: the --profile trace names no {named} kernel")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[cli_profile] done at {time.perf_counter() - t_start:.0f} s")


# ---------------------------------------------------------------------------
# Phase 3 and the kernels_* phases: each kernel against its plain version on one step's
# inputs (a check group), timed in the process that drives the card and held in CHECKERS
# processes on the same card.
# ---------------------------------------------------------------------------
RAGGED_AT = f"B={RAGGED_B}, N={RAGGED_N}"
# Where a kernel's inputs hold the states: [N, n̂, B] or [n̂, B]; and the const rows C.
STATE_ARGS = {"ric": (0,), "fwd": (0, 1), "sbwd": (1, 4), "sbwd_generic": (1, 4),
              "sbwd_upper": (4,), "sfwd": (2, 7), "sfwd_generic": (2, 7), "sfwd_ref": (2, 7)}
C_ARG = {"ric": 4, "fwd": 8, "sbwd": 3, "sbwd_generic": 3, "sbwd_upper": 5, "sfwd": 6,
         "sfwd_generic": 6, "sfwd_ref": 6}
# Processes that hold the kernels against their plain versions, beside the one that drives
# the card: a plain version queues one small PyTorch kernel per operation, so a check is
# bound by its process's host (~10^4-10^5 operations a call), and the checks of different
# groups run at once on the card. Kernel times are taken before they start.
CHECKERS = 4


def at_bound(torch, pb, U_rows):
    lo = torch.as_tensor(pb.u_min, dtype=U_rows.dtype, device=U_rows.device)[:, None]
    hi = torch.as_tensor(pb.u_max, dtype=U_rows.dtype, device=U_rows.device)[:, None]
    return int(((U_rows <= lo + ACTIVE_TOL) | (U_rows >= hi - ACTIVE_TOL)).sum())


def ragged(t):
    """The first RAGGED_N steps and RAGGED_B lanes of a [N, rows, B] or [rows, B] input."""
    return (t[:RAGGED_N, :, :RAGGED_B] if t.ndim == 3 else t[:, :RAGGED_B]).contiguous()


def held(make, pb, eps, inputs, more_shapes):
    """The checks of the kernels of `inputs` ({kernel: its inputs}) on one step's inputs:
    (calls {kernel: (wrapper, plain version, inputs)} at the step's shape, extra [(label,
    kernel, wrapper, plain version, inputs, timed)]). With `more_shapes`: every kernel
    is built for each obstacle count (the paper has 5), so the extra checks also take
    the first and the last instantiation, with the system's first obstacle alone and
    with more up to eight, at the ragged shape; Dubins' last also at the main shape,
    timed. The cart-pole has no obstacles, so only the ragged shape."""
    main = make(pb)
    calls = {k: (*main[k], t) for k, t in inputs.items()}
    if not more_shapes:
        return calls, []
    extra = [(f"{k} at {RAGGED_AT}", k, *main[k], tuple(map(ragged, t)), False)
             for k, t in inputs.items()]
    sp = pb.spec
    if not sp.centers:
        return calls, extra
    more = EXTRA_CENTERS[:8 - len(sp.centers)]
    for centers in (sp.centers[:1], sp.centers + more):
        pbn = with_obstacles(pb, centers, eps)
        n, fns = f"{len(centers)} obstacles", make(pbn)
        shapes = [(f" at {RAGGED_AT}", ragged, False)]
        if len(centers) == 8 and sp.family == "dubins":
            shapes.append((" at the main shape", lambda t: t, True))
        for where, cut, timed in shapes:
            extra += [(f"{k}, {n}{where}", k, *fns[k], tuple(map(cut, t)), timed)
                      for k, t in inputs.items()]
    return calls, extra


def branch_checks(torch, make, pb, eps, inputs, what, failed):
    """The branch checks of the exact min and the log barrier, at the ragged shape: the
    circle systems with the two obstacles TIE_CENTERS, and the first 250 lanes of every
    state moved onto their bisector (px = 5, where the min chain ties), the first 125
    of those to (5, 5), where h = 0; the cart-pole's first 125 lanes to its track
    limit, h = 0; and those lanes' gamma to 0.5, since f̂ weighs the tangent of h at
    the current state by gamma. Counts the (state, step, lane) triples on which the
    chain ties and on which h - tight < eps, and records a failure where the library's
    aggregation (min) or barrier (log) has a branch that no lane takes. Returns the
    extra checks."""
    sp = pb.spec
    circles = bool(sp.centers)
    q = with_obstacles(pb, TIE_CENTERS, eps) if circles else pb
    fns = make(q)
    extra, ties, below = [], 0, 0
    for k, t in inputs.items():
        ins = [ragged(a) for a in t]
        C = ins[C_ARG[k]].clone()
        C[2 * pb.n_hat + pb.m + 1, :250] = 0.5
        ins[C_ARG[k]] = C
        tight = C[2 * pb.n_hat + pb.m + 2]
        for i in STATE_ARGS[k]:
            x = ins[i].clone()
            if circles:
                x[..., 0, :250] = 5.0
                x[..., 1, :125] = 5.0
                hs = [(x[..., 0, :] - cx) * (x[..., 0, :] - cx)
                      + (x[..., 1, :] - cy) * (x[..., 1, :] - cy) - 1.0
                      for cx, cy in TIE_CENTERS]
                ties += int((hs[0] == hs[1]).sum())
                h = torch.minimum(hs[0], hs[1])
            else:
                x[..., 0, :125] = sp.x_lim
                h = sp.x_lim * sp.x_lim - x[..., 0, :] * x[..., 0, :]
            below += int((h - tight < eps).sum())
            ins[i] = x
        extra.append((f"{k}, the branch lanes at {RAGGED_AT}", k, *fns[k], tuple(ins), False))
    log(f"[checks] {what}, branch lanes: the min chain ties on {ties} (state, step, lane) "
        f"triples of the inputs, h - tight < eps on {below}")
    if circles and sp.aggregation == "min" and ties == 0:
        failed.append(f"{what}: no lane on the min chain's tie")
    if pb.barrier_type == "log" and below == 0:
        failed.append(f"{what}: no lane below the log barrier's eps")
    return extra


# Four lanes of one warp (a sweep block's 32 lanes are one phase-A warp) whose ω is not
# finite in nonfinite_checks.
NONFINITE_LANES = slice(64, 68)


def nonfinite_checks(torch, make, pb, inputs, cut, cut_at):
    """The cart-pole's K3/K5 (csrc/lane_sbwd.cu, CARTPOLE_COLS) on a step's inputs with ω
    inf, -inf, NaN and inf on NONFINITE_LANES at every step: phase A of that warp takes
    fhat_tan's path (its vote on the step's fields fails), every other warp the literals.
    Returns the extra checks."""
    extra = []
    for name in ("sbwd", "sbwd_generic", "sbwd_upper"):
        if name not in inputs:
            continue
        ins = list(inputs[name])
        at_x = STATE_ARGS[name][0]
        X = ins[at_x].clone()
        X[:, 3, NONFINITE_LANES] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                                                 float("inf")], dtype=X.dtype)
        ins[at_x] = X
        extra.append((f"{name}, ω not finite on four lanes of one warp{cut_at}", name,
                      *make(pb)[name], tuple(map(cut, ins)), False))
    return extra


# The systems whose K4 runs on sfwd_staged (csrc/lane_sfwd.cu: the chain's gains through
# shared memory, phase A's inputs by cp.async a chunk ahead), held bitwise, also on
# sfwd_edge_inputs: fewer steps than the two chunks its ring holds, and lanes not finite.
SFWD_STAGED = ("double_integrator", "cartpole")
SFWD_EDGE_N = (1, 2, 4)


def sfwd_edge_inputs(torch, ins, lanes=NONFINITE_LANES):
    """[(what, inputs)] of K4 (sfwd) from one step's inputs `ins` (K, kff, X, Xr, U, Ur, C,
    XN, XrN): its first n steps for n in SFWD_EDGE_N; and K, kff or X (its row 0, which h
    reads) with inf, -inf, NaN and inf on `lanes` at every step."""
    out = [(f"its first {n} steps", tuple(t[:n] if t.ndim == 3 else t for t in ins))
           for n in SFWD_EDGE_N]
    bad = [float("inf"), float("-inf"), float("nan"), float("inf")]
    for at, what, rows in ((0, "K", slice(None)), (1, "kff", slice(None)), (2, "X", 0)):
        t = ins[at].clone()
        t[:, rows, lanes] = torch.tensor(bad, dtype=t.dtype, device=t.device)
        out.append((f"{what} not finite on four lanes of one warp",
                    tuple(t if i == at else a for i, a in enumerate(ins))))
    return out


@dataclasses.dataclass(frozen=True)
class Group:
    """One check group: the kernels on the inputs of one closed-loop step, `kind` "paper"
    (paper_step) or "coupled" (coupled_step), of `family` at N_ in `dname`; with `record`
    also at held's extra shapes and obstacle counts, and the f32 results go to the
    kernels line as <kernel><suffix>; with `branches`, branch_checks too."""
    phase: str
    kind: str
    dname: str
    family: str = "dubins"
    N_: int = N
    solver: bool = False
    suffix: str = ""
    record: bool = True
    branches: bool = False


def kernel_groups():
    """Every check group, in the order of the phases: kernels (Dubins' paper and coupled
    steps in f64 and f32); for each family kernels_<family> (its paper step),
    kernels_<family>_generic (its coupled step), kernels_<family>_cli (K1, K2 and K5/K6 on a
    coupled step at the N of the family's config, which the cli phase runs, in f32 as the
    CLI does); for each MINLOG configuration kernels_<variant> (K1-K4 on a paper step and
    K5/K6 on a coupled step at its own N, with the branch lanes)."""
    from tube_mpc_tpu_torch.utils.config import load_config

    both = ("float64", "float32")
    groups = [Group("kernels", kind, d) for d in both for kind in ("paper", "coupled")]
    for family in FAMILIES:
        Nc = load_config(f"configs/{family}.yaml").system.horizon_N
        sfx = f"_{family}"
        groups += [Group(f"kernels_{family}", "paper", d, family, suffix=sfx) for d in both]
        groups += [Group(f"kernels_{family}_generic", "coupled", d, family, suffix=sfx)
                   for d in both]
        groups.append(Group(f"kernels_{family}_cli", "coupled", "float32", family, Nc, True,
                            sfx, record=False))
    for variant in MINLOG:
        Nc = minlog_config(variant).system.horizon_N
        groups += [Group(f"kernels_{variant}", kind, d, variant, Nc, suffix=f"_{variant}",
                         branches=True) for d in both for kind in ("paper", "coupled")]
    return groups


def group_checks(torch, dev, g, failed):
    """(calls, extra, controls at a bound, what, the problem) of group g's inputs; K2 also
    at the rollout's nα=1. Where no control of a backward sweep's (K3, K5) inputs lies at
    a bound (a family's step may have none), that sweep is also held on the same inputs
    with the controls clamped to their quartiles, which become the problem's bounds, so
    that the active set runs; the count returned is the least over the sweeps, and a
    failure is recorded where it is 0. With g.record, held's extra shapes and obstacle
    counts, and the clamped sweep at the ragged shape; without, at the step's own. With
    g.branches, branch_checks too. The cart-pole's backward sweeps (with g.record) are also
    held with ω not finite on four lanes of one warp (nonfinite_checks), and the K4 of
    SFWD_STAGED's systems on sfwd_edge_inputs."""
    dtype = getattr(torch, g.dname)
    more_shapes = g.record
    step = paper_step if g.kind == "paper" else coupled_step
    kw = dict(family=g.family, N_=g.N_, **({"solver": True} if g.solver else {}))
    pb, eps, make, inputs, what = step(torch, dev, dtype, **kw)
    calls, extra = held(make, pb, eps, inputs, more_shapes)
    if g.branches:
        extra += branch_checks(torch, make, pb, eps, inputs, what, failed)
    cut, cut_at = (ragged, f" at {RAGGED_AT}") if more_shapes else ((lambda t: t), "")
    if "fwd" in inputs:
        fwd1 = make(pb)["fwd nα=1"]
        head = [("fwd nα=1", "fwd", *fwd1, inputs["fwd"], True)]
        if more_shapes:
            head.append((f"fwd nα=1 at {RAGGED_AT}", "fwd", *fwd1,
                         tuple(map(ragged, inputs["fwd"])), False))
        extra = head + extra
    counts = []
    for name in ("sbwd", "sbwd_generic", "sbwd_upper"):
        if name not in inputs:
            continue
        at_u = 3 if name == "sbwd_upper" else 0   # where U lies among the sweep's inputs
        U = inputs[name][at_u]
        n_bound = at_bound(torch, pb, U)
        if n_bound == 0:
            rows = U.transpose(0, 1).reshape(pb.m, -1).float()
            lo = tuple(float(torch.quantile(r, 0.25)) for r in rows)
            hi = tuple(float(torch.quantile(r, 0.75)) for r in rows)
            pbc = dataclasses.replace(pb, u_min=lo, u_max=hi)
            U_c = torch.minimum(torch.as_tensor(hi, dtype=dtype, device=dev)[:, None],
                                torch.maximum(torch.as_tensor(lo, dtype=dtype,
                                                              device=dev)[:, None], U))
            ins = list(inputs[name])
            ins[at_u] = U_c
            n_bound = at_bound(torch, pbc, U_c)
            log(f"[checks] {what}: no control of {name}'s inputs at a bound; {name} also "
                f"with the controls clamped to their quartiles {lo}..{hi}, {n_bound} of "
                f"them at a bound")
            extra.append((f"{name}, controls clamped to their quartiles{cut_at}",
                          name, *make(pbc)[name], tuple(map(cut, ins)), False))
        counts.append(n_bound)
    if pb.spec.family == "cartpole" and more_shapes:
        extra += nonfinite_checks(torch, make, pb, inputs, cut, cut_at)
    if pb.spec.family in SFWD_STAGED and more_shapes and "sfwd" in inputs:
        extra += [(f"sfwd, {edge}{cut_at}", "sfwd", *make(pb)["sfwd"], tuple(map(cut, ins)),
                   False) for edge, ins in sfwd_edge_inputs(torch, inputs["sfwd"])]
    log(f"[{g.phase}] {g.dname}: inputs from a closed-loop step of the {what}; at least "
        f"{min(counts)} controls at a bound in every backward sweep's inputs")
    if min(counts) == 0:
        failed.append(f"{g.dname} {what}: no control at a bound, active set unchecked")
    return calls, extra, pb


def time_group(torch, dev, g, pool, results):
    """Group g's kernels timed on the card (its step's own shape, and the extras marked
    timed), in the process that drives the card while nothing else runs there; with
    g.record in f32, the kernel's ms, the bytes it must move and its plain version's
    operations (counted by a CPU worker, cpu_count_ops, read at the end) go to
    results[<kernel><suffix>]. Returns the failures found (the active set, the branches)."""
    failed = []
    calls, extra, pb = group_checks(torch, dev, g, failed)
    nc = 2 * pb.n_hat + pb.m + 3
    step_ms = {}   # kernel: ms per launch on the step's inputs
    for name, (kernel, plain, inputs) in calls.items():
        got = kernel(*inputs)
        ms = step_ms[name] = device_time_ms(torch, lambda: kernel(*inputs), RUNS)
        if not g.record or g.dname != "float32":
            log(f"[{g.phase}] {g.dname} {name}: {ms:.4f} ms (mean of {RUNS} back to back)")
            continue
        small = [t[..., :OPS_LANES].contiguous().cpu().numpy() for t in inputs]
        results[name + g.suffix] = dict(
            ms=ms, bytes=io_bytes(name, inputs, got, nc), dname=g.dname,
            ops=pool.apply_async(cpu_count_ops, (g.kind, g.family, g.N_, name, small)))
        log(f"[{g.phase}] {g.dname} {name}: {ms:.4f} ms (mean of {RUNS} back to back); "
            f"{results[name + g.suffix]['bytes']} bytes")
    for label, name, kernel, plain, inputs, timed in extra:
        if timed:
            ms = device_time_ms(torch, lambda: kernel(*inputs), RUNS)
            log(f"[{g.phase}] {g.dname} {label}: {ms:.4f} ms (mean of {RUNS} back to back), "
                f"beside {step_ms[name]:.4f} ms for {name} on the step's inputs")
    del calls, extra
    torch.cuda.empty_cache()
    return failed


def check_one(torch, g, label, name, kernel, plain, inputs, failed, exact=False):
    """Hold a kernel against its plain version at TOL[dname][name], or with `exact` at no
    difference at all; log, record a failure, and return the largest difference and the plain
    version's wall in ms."""
    got = kernel(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():   # no autograd bookkeeping on its ~10^4-10^5 operations
        ref = plain(*inputs)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    rtol, atol_frac = TOL[g.dname][name]
    err, ok = max_err(torch, got, ref, rtol, atol_frac)
    ok = ok and not (exact and err != 0.0)
    how = "exact" if exact else f"rtol {rtol}, atol {atol_frac} of the row's max|plain|"
    nonfinite = sum(int((~torch.isfinite(r)).sum()) for r in ref)
    log(f"[{g.phase}] {g.dname} {label}: max |kernel - plain| = {err!r} ({how}) -> "
        f"{'ok' if ok else 'FAIL'}; {nonfinite} non-finite values in the plain output")
    if not ok:
        failed.append(f"{g.dname} {label}")
    return err, plain_wall


def checker_init() -> None:
    """A checker process's initializer: the settings of the process that drives the card."""
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def hold_group(g):
    """Group g's checks, in a checker process on the card: every kernel of the group
    against its plain version at the step's shape and at the extra shapes (SFWD_STAGED's K4
    exactly). Returns (its log lines, its failures, {kernel: (max |kernel - plain| over its
    checks, the plain version's ms by its check's one call at the step's shape)}, its
    seconds)."""
    global _CAPTURED
    import torch

    _CAPTURED, t0 = [], time.perf_counter()
    try:
        dev = torch.device("cuda", 0)
        failed, errs = [], {}
        calls, extra, pb = group_checks(torch, dev, g, failed)
        exact = lambda name: name == "sfwd" and pb.spec.family in SFWD_STAGED
        for name, (kernel, plain, inputs) in calls.items():
            errs[name] = check_one(torch, g, name, name, kernel, plain, inputs, failed,
                                   exact(name))
        for label, name, kernel, plain, inputs, _ in extra:
            err, _ = check_one(torch, g, label, name, kernel, plain, inputs, failed, exact(name))
            if name in errs:
                errs[name] = (max(errs[name][0], err), errs[name][1])
        del calls, extra
        torch.cuda.empty_cache()
        return _CAPTURED, failed, errs, time.perf_counter() - t0
    finally:
        _CAPTURED = None


def lower_priority() -> None:
    """A worker process's initializer: it yields the CPU to the process that drives the
    card, whose host-bound phases (the plain versions' checks) set the script's wall."""
    os.nice(10)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # the CPU's f64 loops (loop64*) and the bounds' operation counts run in worker processes
    # beside the card's phases, at a lower priority; every worker is stopped on the way out,
    # whatever the phases did
    workers = max(1, min(len(LOOP64_CASES) + 2 * len(CHAOTIC) + len(XLA_CASES) + 2,
                         (os.cpu_count() or 2) - 1))
    with contextlib.ExitStack() as stack:
        pool = multiprocessing.get_context("spawn").Pool(workers, initializer=lower_priority)
        stack.callback(pool.join)
        stack.callback(pool.terminate)
        return run_phases(torch, pool, stack)


def run_phases(torch, pool, stack) -> int:
    """The phases; the worker pools they start are stopped by `stack`'s exit."""
    from tube_mpc_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
    from tube_mpc_tpu_torch.presets import dubins_paper_setup, family_paper_setup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    t_start = time.perf_counter()

    # ---- 1. device ------------------------------------------------------------
    log(f"[device] {card}")
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    siblings = "/sys/devices/system/cpu/cpu0/topology/thread_siblings_list"
    log(f"[device] host: {len(os.sched_getaffinity(0))} CPUs usable, cpu0's hardware threads "
        f"{open(siblings).read().strip() if os.path.exists(siblings) else 'unknown'}")

    # ---- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    seconds = _build.build(_build.libraries(_build.DEFAULT_VARIANTS + tuple(MINLOG)))
    log(f"[build] {len(seconds)} libraries built in {time.perf_counter() - t0:.1f} s "
        f"(per library: {json.dumps({k: round(v, 1) for k, v in seconds.items()})})")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {kernel_label(line.strip())}")
    def done(what):
        """A worker job's callback: log when it ended."""
        return lambda r: log(f"[workers] {what} done at {time.perf_counter() - t_start:.0f} s "
                             f"({r[1]:.1f} s in its worker)")

    cpu_runs = {case: pool.apply_async(cpu_loop64, case, callback=done(f"loop64 {case}"))
                for case in LOOP64_CASES}
    cpu_xla = {kind: pool.apply_async(cpu_xla64, (kind,), callback=done(f"xla64 {kind}"))
               for kind in XLA_CASES}
    cpu_pop64 = pool.apply_async(cpu_population64, callback=done("population64"))
    cpu_pscan = pool.apply_async(cpu_pscan_solves, callback=done("pscan solves"))
    cpu_draws = pool.apply_async(cpu_bench_draws, callback=done("prng draws"))
    # a chaotic loop's CPU side also with its start and disturbances times 1 + 1e-15
    cpu_perturbed = {(kind, family): pool.apply_async(
        cpu_loop64, (kind, family, LOOP64_H, 1.0 + 1e-15),
        callback=done(f"loop64 {(kind, family)} x (1 + 1e-15)"))
        for kind, family in LOOP64_CASES if family in CHAOTIC}

    def loop64_logs(phase, kind, family):
        """({"cpu": the CPU's f64 loop of loop64_case, from its worker, dev: the card's},
        the card's setup, run and w)."""
        out, cpu_s = cpu_runs[kind, family].get()
        st, run, w = loop64_case(torch, kind, family, dev)
        t0 = time.perf_counter()
        card_out = run(st, w, dev)
        torch.cuda.synchronize()
        log(f"[{phase}] B={LOOP64_B}, N={N}, H={LOOP64_H} f64: {cpu_s:.1f} s on the cpu (a "
            f"worker process), {time.perf_counter() - t0:.1f} s on {dev}")
        return {"cpu": tree_map(torch.as_tensor, out), dev: card_out}, st, run, w

    # ---- 3 and the kernels_* phases: every kernel against its plain version ------------
    results, failed = {}, []
    # First every group's kernels are timed here, with nothing else on the card; then the
    # checker processes hold them against their plain versions (hold_group), the longest
    # groups first, while this process runs the loop64 and xla64 phases; their results are
    # read after those (a check that fails fails the run there).
    t0 = time.perf_counter()
    groups = kernel_groups()
    for g in groups:
        failed += time_group(torch, dev, g, pool, results)
    if failed:
        raise SystemExit(f"chip_smoke: the kernels' inputs fail their checks: {failed}")
    log(f"[kernels] {len(groups)} groups' kernels timed in {time.perf_counter() - t0:.0f} s, "
        f"at {time.perf_counter() - t_start:.0f} s; held by {CHECKERS} checker processes")
    checker = multiprocessing.get_context("spawn").Pool(CHECKERS, initializer=checker_init)
    stack.callback(checker.join)
    stack.callback(checker.terminate)
    cost = {"quadrotor2d_min_log": 0, "quadrotor2d": 1, "dubins_min_log": 2, "dubins": 3}
    order = sorted(range(len(groups)), key=lambda i: cost.get(groups[i].family, 4))
    holding = {i: checker.apply_async(hold_group, (groups[i],)) for i in order}

    # ---- 4, 5 and the families' short f64 loops, paper and coupled: kernels on the card vs
    # plain versions on the CPU --------------------------------------------------------
    def logged(phase, what, diffs, tol):
        """Log loop_diffs' `diffs`; return the fields that fail."""
        for field, (d, ok) in diffs.items():
            rtol, atol = tol[field.split(".")[0]]
            log(f"[{phase}] {field}: max |{what}| = {d!r} (rtol {rtol}, atol {atol}) -> "
                f"{'ok' if ok else 'FAIL'}")
        return [f for f, (_, ok) in diffs.items() if not ok]

    def hold_loop64(phase, kind, family, tol):
        """The f64 loop of loop64_case on the card against the CPU's at `tol`. On a chaotic
        loop (CHAOTIC) that the card parts from the CPU on, a last-bit difference of the
        card's math library (sin, cos, exp, log) against the CPU's grows as a 1e-15
        perturbation of the start and the disturbances does on the CPU alone. So there: the
        steps T on which the CPU agrees with itself under that perturbation; the card must
        agree with the CPU on those (T >= 1), and the kernels' loop with the plain
        versions' loop on the card, on every step."""
        logs, st_dev, run, w = loop64_logs(phase, kind, family)
        bad = logged(phase, "card - cpu", loop_diffs(logs[dev], logs["cpu"], LOOP64_H, tol),
                     tol)
        if not bad:
            return
        if family not in CHAOTIC:
            raise SystemExit(f"chip_smoke: {phase}: the f64 loop on the card disagrees with "
                             f"the plain loop: {bad}")
        pert = tree_map(torch.as_tensor, cpu_perturbed[kind, family].get()[0])
        T = 0
        while T < LOOP64_H and all(
                ok for _, ok in loop_diffs(pert, logs["cpu"], T + 1, tol).values()):
            T += 1
        u_p, u_c = loop_fields(pert)["u_real"], loop_fields(logs["cpu"])["u_real"]
        log(f"[{phase}] the card parts from the CPU ({bad}); the CPU's loop with its start "
            f"and disturbances times 1 + 1e-15 stays within the tolerances of its own on {T} of "
            f"{LOOP64_H} steps: per step max |du| = "
            f"{[float((u_p - u_c)[:, t].abs().max()) for t in range(LOOP64_H)]}")
        log(f"[{phase}] the card against the CPU on the first {T} steps:")
        bad = logged(phase, "card - cpu", loop_diffs(logs[dev], logs["cpu"], T, tol),
                     tol) if T else ["the CPU agrees with itself on no step"]
        t0 = time.perf_counter()
        with plain_on_card():
            plain = run(st_dev, w, dev)
        torch.cuda.synchronize()
        log(f"[{phase}] the plain versions' loop on {dev}: {time.perf_counter() - t0:.1f} s")
        bad += logged(phase, "kernels - plain versions, on the card,",
                      loop_diffs(logs[dev], plain, LOOP64_H, tol), tol)
        if bad:
            raise SystemExit(f"chip_smoke: {phase}: the f64 loop on the card disagrees with "
                             f"the plain loop: {bad}")

    for family in ("dubins",) + FAMILIES:
        suffix = "" if family == "dubins" else f"_{family}"
        hold_loop64(f"loop64{suffix}", "paper", family, LOOP_TOL)
        hold_loop64(f"loop64{suffix}_coupled", "coupled", family, COUPLED_LOOP_TOL)
        log(f"[loop64 {family}] done at {time.perf_counter() - t_start:.0f} s")
    hold_loop64("loop64_dubins_min_log", "paper", "dubins_min_log", LOOP_TOL)
    hold_loop64("loop64_cartpole_log_coupled", "coupled", "cartpole_log", COUPLED_LOOP_TOL)
    hold_loop64("loop64_population", "population", "dubins", LOOP_TOL)
    log(f"[loop64] all done at {time.perf_counter() - t_start:.0f} s")

    # ---- xla64: the XLA engine's f64 loops on the card against the CPU and the lane engine
    torch.set_float32_matmul_precision("highest")
    for kind in XLA_CASES:
        phase = f"xla64_{kind}"
        run, _ = xla64_case(torch, kind, dev)
        cpu_out, cpu_s = cpu_xla[kind].get()
        t0 = time.perf_counter()
        card = run("xla")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        lanes = run("lanes")
        torch.cuda.synchronize()
        log(f"[{phase}] B={LOOP64_B}, N={N}, H={LOOP64_H} f64: {cpu_s:.1f} s on the cpu (a worker "
            f"process), {t_card:.1f} s on {dev}")
        lane_tol = LOOP_TOL if kind == "paper" else COUPLED_LOOP_TOL
        bad = logged(phase, "card - cpu", loop_diffs(card, tree_map(torch.as_tensor, cpu_out),
                                                     LOOP64_H, XLA_LOOP_TOL), XLA_LOOP_TOL)
        bad += logged(phase, "xla - lanes, on the card,",
                      loop_diffs(card, lanes, LOOP64_H, lane_tol), lane_tol)
        if bad:
            raise SystemExit(f"chip_smoke: {phase}: the XLA engine's f64 loop disagrees: {bad}")
        del card, lanes
    log(f"[xla64] done at {time.perf_counter() - t_start:.0f} s")

    # ---- the kernels' checks from the checker processes, in the order of the phases ------
    t0 = time.perf_counter()
    spent = {}
    for i, g in enumerate(groups):
        lines, bad, errs, seconds = holding[i].get()
        for line in lines:
            log(line)
        failed += bad
        spent[g.phase] = spent.get(g.phase, 0.0) + seconds
        if g.record and g.dname == "float32":
            for name, (err, plain_ms) in errs.items():
                results[name + g.suffix].update(max_abs_err=err, plain_ms=plain_ms)
    checker.close()
    log(f"[kernels] held in {sum(spent.values()):.0f} s of the checker processes' "
        f"({', '.join(f'{k} {v:.0f} s' for k, v in spent.items())}); read after a wait of "
        f"{time.perf_counter() - t0:.0f} s, at {time.perf_counter() - t_start:.0f} s")
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions, or a "
                         f"branch ran on no lane: {failed}")


    # ---- 6. the full-width paper path ---------------------------------------------
    s = dubins_paper_setup(N=N, H=H, device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w = torch_draw(s.system, gen, (B, H), torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run_paper_loop(s, w, dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = launch_counts()
    finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
    shapes_ok = (tuple(out.x_real.shape) == (B, H, 3) and tuple(out.u_real.shape) == (B, H, 2)
                 and tuple(out.loss.shape) == (B, H) and tuple(out.Q_hist.shape) == (B, H, 3))
    log(f"[main] B={B}, N={N}, H={H} f32: {elapsed:.3f} s, {2 * H * B / elapsed:.1f} solves/s "
        f"(2*H*B / elapsed), finite_lane_frac {finite!r}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"[main] launches: {json.dumps(counts)}; final loss median "
        f"{float(out.loss[:, -1].nanmedian())!r}")
    problems = [k for k in PAPER if counts[k] == 0]
    if problems:
        raise SystemExit(f"chip_smoke: kernels not launched on the main path: {problems}")
    if counts["sbwd"] != H or counts["sfwd"] != H:
        raise SystemExit(f"chip_smoke: K3/K4 launched {counts['sbwd']}/{counts['sfwd']} times, not H={H}")
    if finite < 0.99:
        raise SystemExit(f"chip_smoke: finite_lane_frac {finite} < 0.99")
    if not shapes_ok:
        raise SystemExit("chip_smoke: the closed-loop log has the wrong shapes")
    paper_case = (lambda caps, s=s, w=w: run_paper_loop(s, w, dev, aux_caps=caps), out, elapsed)
    paper_w = w

    # ---- 7. the full-width coupled path ---------------------------------------------
    s, cfg, raw_nom, raw_aux = coupled_setup(torch, H, dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    w = torch_draw(s.system, gen, (B, H), torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, (raw_aux_f, raw_nom_f) = run_coupled(s, cfg, raw_nom, raw_aux, w, dev)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    coupled_counts = launch_counts()
    finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
    tight_moved = int((raw_nom_f.tight_raw != raw_nom.tight_raw).sum())
    shapes_ok = (tuple(out.x_real.shape) == (B, H, 3) and tuple(out.u_bar.shape) == (B, H, 2)
                 and tuple(out.loss.shape) == (B, H) and tuple(raw_nom_f.Q_raw.shape) == (B, 3))
    log(f"[coupled] B={B}, N={N}, H={H} f32: {elapsed:.3f} s, {2 * H * B / elapsed:.1f} solves/s "
        f"(2*H*B / elapsed), finite_lane_frac {finite!r}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log(f"[coupled] launches: {json.dumps(coupled_counts)}; final loss median "
        f"{float(out.loss[:, -1].nanmedian())!r}; tight_raw moved on {tight_moved} lanes "
        f"(final median {float(raw_nom_f.tight_raw.median())!r}), alpha_raw (ancillary) final "
        f"median {float(raw_aux_f.alpha_raw.median())!r}")
    problems = [k for k in ("ric", "fwd") if coupled_counts[k] == 0]
    problems += [f"{k}: {coupled_counts[k]}" for k in COUPLED if coupled_counts[k] != H]
    if problems:
        raise SystemExit(f"chip_smoke: the coupled path's launches are wrong (K5/K6 need H={H} "
                         f"each): {problems}")
    if finite < 0.99:
        raise SystemExit(f"chip_smoke: coupled finite_lane_frac {finite} < 0.99")
    if tight_moved == 0:
        raise SystemExit("chip_smoke: the nominal tightening moved on no lane")
    if not shapes_ok:
        raise SystemExit("chip_smoke: the coupled log has the wrong shapes")
    log(f"[coupled] done at {time.perf_counter() - t_start:.0f} s")

    # ---- straggler compaction on both paths, against their uncompacted runs just above
    compact_phase(torch, dev, t_start, {
        "paper": paper_case,
        "coupled": (lambda caps, a=(s, cfg, raw_nom, raw_aux, w):
                    run_coupled(*a, dev, aux_caps=caps), (out, (raw_aux_f, raw_nom_f)), elapsed)},
        paper_w)
    del out, paper_case, paper_w

    # ---- the families' full-width paper paths -----------------------------------------
    family_counts = {}
    for family in FAMILIES:
        phase = f"main_{family}"
        s = family_paper_setup(family, N=N, H=H, device=dev, dtype=torch.float32)
        nx, nu = s.system.nx, s.system.nu
        gen = torch.Generator(device=dev).manual_seed(SEED + 30 + FAMILIES.index(family))
        w = torch_draw(s.system, gen, (B, H), torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_paper_loop(s, w, dev)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        fc = family_counts[family] = launch_counts()
        finite = float(torch.isfinite(out.loss[:, -1]).float().mean())
        shapes_ok = (tuple(out.x_real.shape) == (B, H, nx) and tuple(out.u_real.shape) == (B, H, nu)
                     and tuple(out.loss.shape) == (B, H) and tuple(out.Q_hist.shape) == (B, H, nx))
        log(f"[{phase}] B={B}, N={N}, H={H} f32: {elapsed:.3f} s, {2 * H * B / elapsed:.1f} "
            f"solves/s (2*H*B / elapsed), finite_lane_frac {finite!r}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        log(f"[{phase}] launches: {json.dumps(fc)}; final loss median "
            f"{float(out.loss[:, -1].nanmedian())!r}")
        problems = [k for k in PAPER if fc[k] == 0]
        if problems:
            raise SystemExit(f"chip_smoke: kernels not launched on {family}'s path: {problems}")
        if fc["sbwd"] != H or fc["sfwd"] != H:
            raise SystemExit(f"chip_smoke: {family}'s K3/K4 launched {fc['sbwd']}/{fc['sfwd']} "
                             f"times, not H={H}")
        if finite < 0.99:
            raise SystemExit(f"chip_smoke: {family}'s finite_lane_frac {finite} < 0.99")
        if not shapes_ok:
            raise SystemExit(f"chip_smoke: {family}'s closed-loop log has the wrong shapes")
        del out
    log(f"[main families] done at {time.perf_counter() - t_start:.0f} s")

    # ---- bench.py's threefry draws on the card, a loop on one, the repaired sequential sweep
    prng_phase(torch, dev, t_start, cpu_draws)

    # ---- the scenario layer: population mode, tube verification, population Algorithm 2,
    # and the sharded paths over a one-rank NCCL mesh -------------------------------------
    scenario_phases(torch, dev, t_start, cpu_pop64)

    # ---- 8. the CLI: the port's entry point on the shipped configs at full width, then on
    # the MINLOG configurations -------------------------------------------------------
    cli_counts = cli_phase(torch, dev, t_start)
    # each configuration as derived, and in its other mode, so that every kernel of its
    # library runs on a main path: K1-K4 in paper mode, K1, K2 and K5/K6 coupled
    runs, runs_of = [], {}
    for variant in MINLOG:
        raw = minlog_raw(variant)
        other = dict(raw, adaptation=dict(raw["adaptation"],
                                          adapt_nominal=not raw["adaptation"]["adapt_nominal"]))
        mode = "coupled" if other["adaptation"]["adapt_nominal"] else "paper"
        runs_of[variant] = [variant, f"{variant}_{mode}"]
        runs += list(zip(runs_of[variant], (raw, other)))
    minlog_counts = cli_phase(torch, dev, t_start, "cli_minlog", runs)
    # ---- the CLI's checkpoint and resume, and its trace ---------------------------------
    cli_ckpt_phase(torch, dev, t_start)
    cli_profile_phase(torch, dev, t_start)

    # ---- the XLA engine at full width, and its CLIs ------------------------------------
    x_last = xla_phase(torch, dev, t_start)
    cli_xla_phase(torch, dev, t_start)
    # ---- the XLA engine's horizon-parallel sweep (solvers/pscan.py) -----------------------
    pscan_phase(torch, dev, t_start, x_last, cpu_pscan)
    del x_last

    # ---- 9. where the time goes: torch.profiler over a few full-width steps ---------
    from torch.profiler import ProfilerActivity, profile

    def profile_phase(label, run):
        t0 = time.perf_counter()
        run()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
        rows = []
        for e in prof.key_averages():
            # device-side events only: an aten op on the host also reports the
            # device time of the kernels it launched, which would count them twice
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                rows.append((us, e.count, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows) / 1e6
        hits = {name: [r for r in rows if is_kernel(r[2], fn, f"float{flags}")]
                for name, (_, _, fn, flags) in KERNELS.items()}
        ours = sum(r[0] for hit in hits.values() for r in hit) / 1e6
        log(f"[profile] {label}: {PROFILE_H} steps at B={B}, N={N}, f32: {plain_wall:.3f} s "
            f"unprofiled, {wall:.3f} s profiled; device busy {busy:.3f} s ({busy / wall:.1%} of "
            f"the profiled wall, {busy / plain_wall:.1%} of the unprofiled), of which the lane "
            f"kernels {ours:.3f} s and PyTorch's own kernels {busy - ours:.3f} s")
        for name, hit in hits.items():
            if hit:
                fn, flags = KERNELS[name][2:]
                log(f"[profile] {label}   {name} ({fn}<float{flags}): {sum(r[0] for r in hit) / 1e3:.3f} ms "
                    f"over {sum(r[1] for r in hit)} launches")
        for us, count, key in rows[:12]:
            log(f"[profile] {label}   {us / 1e3:10.3f} ms  x{count:<6d} {key[:110]}")

    s = dubins_paper_setup(N=N, H=PROFILE_H, device=dev, dtype=torch.float32)
    w = torch_draw(s.system, torch.Generator(device=dev).manual_seed(SEED + 3), (B, PROFILE_H),
                   torch.float32)

    def paper_steps():
        run_paper_loop(s, w, dev)
        torch.cuda.synchronize()

    profile_phase("paper", paper_steps)
    sc, cfg, raw_nom, raw_aux = coupled_setup(torch, PROFILE_H, dev, torch.float32)
    wc = torch_draw(sc.system, torch.Generator(device=dev).manual_seed(SEED + 7),
                    (B, PROFILE_H), torch.float32)

    def coupled_steps():
        run_coupled(sc, cfg, raw_nom, raw_aux, wc, dev)
        torch.cuda.synchronize()

    profile_phase("coupled", coupled_steps)
    log(f"[profile] done at {time.perf_counter() - t_start:.0f} s")

    # the bounds: each kernel's bytes, and its plain version's operations from the workers
    t0 = time.perf_counter()
    for key, r in results.items():
        r["ops"] = r["ops"].get()
        t_bytes, t_ops = bound_ms(r["bytes"], r["ops"], r["dname"])
        r["bound_ms"], r["bound_by"] = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                              else "operations")
        log(f"[bounds] {r['dname']} {key}: {r['bytes']} bytes -> {t_bytes:.4f} ms, {r['ops']} ops "
            f"-> {t_ops:.4f} ms at peak ({2 * t_ops:.4f} ms without fused multiply-adds); "
            f"kernel {r['ms']:.4f} ms")
    log(f"[bounds] {len(results)} kernels' operations read from the workers in "
        f"{time.perf_counter() - t0:.1f} s")

    line = []
    for name, (source, replaces, _, _) in KERNELS.items():
        r = results[name]
        launches = counts[name] if name in PAPER else coupled_counts[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches, max_abs_err=r["max_abs_err"],
                         ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                         bound_by=r["bound_by"], library_ms=None))
    for family in FAMILIES:
        for name in PAPER + COUPLED:
            source, replaces = KERNELS[name][:2]
            r = results[f"{name}_{family}"]
            launches = (family_counts[family] if name in PAPER else cli_counts[family])[name]
            line.append(dict(name=f"{name}_{family}", route="cuda", source=source,
                             replaces=replaces, launches=launches,
                             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    # a MINLOG library's kernels, launched by its configuration's two CLI runs
    for variant in MINLOG:
        for name in PAPER + COUPLED:
            launches = sum(minlog_counts[run][name] for run in runs_of[variant])
            source, replaces = KERNELS[name][:2]
            r = results[f"{name}_{variant}"]
            line.append(dict(name=f"{name}_{variant}", route="cuda", source=source,
                             replaces=replaces, launches=launches,
                             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": line}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
