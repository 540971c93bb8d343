#!/usr/bin/env python3
"""Where the chunked sweeps' time and register spills go (K1 `ric_kernel`, K3/K5
`sbwd_kernel`, K4/K6 `sfwd_kernel`, all on lane_common.cuh's sweeps), and the quadrotor's
K2 (`fwd_kernel`, `fwd_staged_kernel`), on one NVIDIA card, in one process.

    python3 tools/ric_probe.py                           # Dubins, from the repository root
    python3 tools/ric_probe.py --family quadrotor2d      # the quadrotor's n̂ = 7 kernels
    python3 tools/ric_probe.py --family cartpole         # the cart-pole's K1 and K3/K5
    python3 tools/ric_probe.py --family cartpole_log     # its K1 with the log barrier
    python3 tools/ric_probe.py --family double_integrator   # its K1, K3/K5 and K4
    python3 tools/ric_probe.py --family double_integrator_min   # its K4 without the key
    python3 tools/ric_probe.py --family quadrotor2d --tree chip_tree/base   # another tree's
    python3 tools/ric_probe.py --family quadrotor2d --variants "A only" parts2   # some (and kept)

1. Builds variants of a tree's kernel sources (`tube_mpc_tpu_torch/csrc/`, of this tree or
   of `--tree`), each a copy of the sources with textual edits (VARIANTS[family]), all at
   once with the package's nvcc flags for the family's library, and prints each variant's
   ptxas registers and spills and SASS instruction counts of the family's f32 and f64
   instantiations (PROBED).
   Dubins (`--family dubins`):
   - kept:   the sources as they are;
   - A only: the recursion's warps skip phase B (the recursion), so phase A and the
             barriers remain;
   - B only: phase A is skipped, so phase B (over whatever shared memory holds) and the
             barriers remain;
   - kc2, kc4, kc6: SWEEP_KC steps per chunk, not 3 (f32 only; above 48 KB of
             buffers the launchers set the dynamic shared memory attribute);
   - cap3, cap2: 3 or 2 f32 blocks per SM in __launch_bounds__ (at most 168 or 255
             registers a thread), not 4 (128), for the systems with n̂ <= 5.
   The cart-pole (`--family cartpole`): kept, A only, B only, kc2/4/6, cap3, cap2 as
   Dubins', and
   - rot:    the sweep's phase-B warp is the block's slot on the SM ((%warpid / 4) mod
             SWEEP_WARPS, read by thread 0 and shared), not warp 0, which would spread an
             SM's chains over its four schedulers if a warp's scheduler were its slot mod 4;
   - rot B only: rot with phase A skipped;
   - w6, w6 cap3: six warps a block, five in phase A with a step each a chunk
             (SWEEP_WARPS 6, SWEEP_KC 5), at four or three f32 blocks an SM;
   - A only cap2, B only cap2: a phase alone at the lifted cap;
   - no lean: K1's and K3/K5's phase B without LEAN (RIC_LEAN, SBWD_LEAN);
   - lit, cols, sel: K3/K5 with one of the cart-pole's own changes alone, without LEAN
             (lane_sbwd.cu: rows 0 and 2 of f̂'s Jacobians as literals; columns 0, 1 and 4
             by a warp's vote; the balanced-equality factors by select);
   - parent: K3/K5 with none of them, the design before the cart-pole's own.
   The quadrotor (`--family quadrotor2d`; K1, K2 and K3/K5 are timed):
   kept, A only and B only as above, cap2, cap3, cap4: 2, 3 or 4 f32 blocks per SM
   for n̂ > 5 (SweepBlocksPerSM), whatever the tree's value, "parts<P> aw<W>": K3/K5's
   split sweep (sweep_split) with P threads a lane in phase B and W phase-A warps
   (SPLIT_PARTS, SPLIT_AW; a tree without the split sweep fails these), and K2's: "fwd
   cap3", "fwd cap4" (fwd_kernel, the rollout's, at 3 or 4 blocks an SM in its
   __launch_bounds__: at most 80 or 64 registers a thread), "fwd unstaged" (the parent's
   fwd_kernel at every nα), "fwd staged nα=1" (fwd_staged_kernel for the rollout too),
   "fwd kc1", "fwd kc4", "fwd bufs3" (its steps a chunk and chunks in the ring), "fwd
   unroll1", "fwd unroll4" (the rollout's step loop not unrolled, or four times) and "fwd
   lanes32" (32-lane blocks at any nα); and K4/K6's (`sfwd_kernel`, timed on the paper step
   and, K6, on the coupled step at N=200): "sfwd cap2", "sfwd cap3", "sfwd cap4" (2, 3 or 4
   f32 blocks an SM for K4 and K6 alike, SfwdBlocksPerSM), "sfwd kc2", "sfwd kc4" (SWEEP_KC,
   which K1 shares), and without one of lane_sfwd.cu's sfwd_wide changes: "sfwd no sel"
   (phase A's factors by division, SFWD_SELECT), "sfwd eager" (phase B loading every field
   of the tangent up front, SFWD_LAZY), and "sfwd parent" (sfwd_kernel's own body at two
   f32 blocks an SM, K4/K6 before sfwd_wide); A only and B only time K4's phases too.
   The cart-pole with the log barrier (`--family cartpole_log`): kept and "no lean".
   The double integrator (`--family double_integrator`; K1 and K3 on its paper step at
   N=50, K1 and the two K5 on the coupled step of configs/double_integrator.yaml at its
   N=30): kept, A only, B only, kc2/4/6, cap3, cap2 as Dubins', and
   - w3:     three warps a block, two in phase A with a step each a chunk;
   - split:  K3/K5 on the split sweep at n̂ = 5 (two threads a lane in phase B), which
             reads every row of f̂'s Jacobians, so with them all stored (as no lit);
   - no lit: every row of f̂'s Jacobians stored and loaded (LinearStep false);
   - no lean: K1 and K3/K5 without the LEAN phase B (RIC_LEAN, SBWD_LEAN);
   - no sel: phase A's balanced-equality factors by division (SelectFactors false);
   - parent: all three, the design before the double integrator's own.
   K4 of the double integrator and the cart-pole (`--family double_integrator`,
   `double_integrator_min`, `cartpole`, `cartpole_log`; timed on the paper step at N=50 and
   at the config's N): on sfwd_kernel's own body (a tree before sfwd_staged, `--tree`),
   "sfwd A only" (phase A alone), "sfwd B warm" (phase A linearises chunks 0 and 1 alone, and
   the chain runs every chunk j over the rows of chunk j & 1: its own time over real rows,
   with its gain loads), "sfwd B warm smem" (the same with the gains taken from the rows: the
   chain's arithmetic alone), "sfwd gains d2", "sfwd gains d4" (step k+2's or k+4's gains
   prefetched into L1 while step k runs), "sfwd sel" (phase A's factors by select); on
   sfwd_staged, "sfwd parent" (sfwd_kernel's own body), "sfwd no sel" (phase A's factors by
   division), "staged A only" (phase A and every copy, no chain) and "staged B warm" (phase A
   on chunks 0 and 1 alone, the chain over them, every chunk's gains and inputs copied). The
   quadrotor's `sfwd B warm` times its chain (sfwd_wide) the same way.
   The edits are to the shared sweeps (K2's to its own kernels), so each variant changes
   every kernel on them alike; an edit of a `.cu` file alone rebuilds that source alone.
2. Times every f32 kernel of the family's cases (Dubins: tools/port_kernel_ab.py's paper
   step's K1-K4 and coupled step's K5/K6 at B=16384, N=50; the cart-pole: K1 and K3 on its
   paper step at N=50, K1 and the two K5 on the coupled step of configs/cartpole.yaml at
   its N=40, with the log barrier K1 on that step of chip_smoke.MINLOG's cartpole_log; the
   quadrotor: tools/port_kernel_ab.py's cases, K1, K2 at the config's nα and
   at nα=1 and K3 on its paper step at N=50, K1, K2 and the two K5 on the coupled step of
   configs/quadrotor2d.yaml at its N=200; the double integrator and double_integrator_min:
   their f32 cases there)
   through its wrapper on every variant's build, in
   turns (every variant, then every variant in reverse order), each the device time per
   launch of RUNS launches back to back, and says whether each variant's outputs are
   bitwise those of `kept`.
3. Compiles `kept` once more to cubins with -lineinfo (which leaves the code as it
   is), disassembles them with nvdisasm -gi, and counts each instantiation's
   local-memory stores and loads (STL, LDL: the register spills) by the source line
   of the innermost frame of their line info. The register allocator's spills in a
   kernel on a shared sweep carry the line of the kernel's sweep call, whichever
   phase they serve: the phase shows in the `A only` and `B only` variants' ptxas
   lines instead. The stack frame of the math library's out-of-line paths, which every
   f64 instantiation has, shows at the kernel's last line. For the instantiations of
   PROBED it also counts the SASS instructions, all of them and those of one step of
   K1's phase A (lin_step) and of its phase B (ric_step), and of K3/K5's (sbwd_lin,
   sbwd_step), and of K4/K6's phase A (sfwd_lin, sfwd_wide_lin above n̂ = 5, sfwd_staged_lin
   for the double integrator's and the cart-pole's K4) and the
   cart-pole's K3/K5 phase A (cartpole_lin): those with a frame in the
   function's lines (one step's code, unless the compiler unrolled a step loop). The
   disassembly stays in `_build/probe/<family>/<source>_lineinfo.sass`.

A variant's edit that matches no line of the tree's sources fails the run (an edit with a
count must match exactly that often): update VARIANTS with the kernels.
The last line is one JSON object with the times and the counts.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

TOOLS = Path(__file__).resolve().parent
sys.path.insert(0, str(TOOLS))
sys.path.insert(0, str(TOOLS.parent))

import port_kernel_ab as ab  # noqa: E402

RUNS = 50
SWEEP = "lane_common.cuh"
SOLVER = "lane_solver.cu"
A_ONLY = (SWEEP, r"rec_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", None)
B_ONLY = (SWEEP, r"lin_step\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", None)
KC = {f"kc{kc}": [(SWEEP, r"constexpr int SWEEP_KC = 3;", f"constexpr int SWEEP_KC = {kc};", 1)]
      for kc in (2, 4, 6)}
CAP = {f"cap{n}": [(SWEEP, r"\) : \(sizeof\(T\) == 4 \? 4 : 1\);",
                    f") : (sizeof(T) == 4 ? {n} : 1);", 1)] for n in (3, 2)}
# The sweep's phase-B warp taken by the block's slot on the SM, (%warpid / 4) mod the warps a
# block, not always warp 0, so that the chains of an SM's blocks are spread over its four
# schedulers (a warp's scheduler is its slot mod 4); thread 0 reads its slot and the block
# shares it through shared memory.
ROT = [(SWEEP, r"  linearise\(0, warp, SWEEP_WARPS\);\n  sweep_sync\(\);\n  if \(warp == 0\) \{",
        "  __shared__ int chain_warp;\n"
        "  if (threadIdx.x == 0) {\n"
        "    unsigned slot;\n"
        "    asm volatile(\"mov.u32 %0, %%warpid;\" : \"=r\"(slot));\n"
        "    chain_warp = (slot >> 2) % SWEEP_WARPS;\n"
        "  }\n"
        "  linearise(0, warp, SWEEP_WARPS);\n  sweep_sync();\n"
        "  const int chain = chain_warp;\n  if (warp == chain) {", 1),
       (SWEEP, r"linearise\(j \+ 1, warp - 1, SWEEP_WARPS - 1\);",
        "linearise(j + 1, (warp - chain - 1 + SWEEP_WARPS) % SWEEP_WARPS, SWEEP_WARPS - 1);", 1)]
# Six warps a block, five of them phase A with a step each a chunk.
W6 = [(SWEEP, r"constexpr int SWEEP_WARPS = 4;", "constexpr int SWEEP_WARPS = 6;", 1),
      (SWEEP, r"constexpr int SWEEP_KC = 3;", "constexpr int SWEEP_KC = 5;", 1)]
# K2's blocks an SM in __launch_bounds__ (at most 65536 / (n 32 MAX_ALPHAS) registers).
FWD_CAP = {f"fwd cap{n}": [(SOLVER, r"__launch_bounds__\(32 \* MAX_ALPHAS\)",
                            f"__launch_bounds__(32 * MAX_ALPHAS, {n})", 1)] for n in (3, 4)}
# The quadrotor's K2 staged in shared memory (fwd_staged_kernel) from nα = FWD_STAGE_MIN:
# never (fwd_kernel alone, the parent's K2), or also for the rollout's nα = 1; its steps a
# chunk (FWD_KC) and chunks in the ring (FWD_BUFS).
FWD_MIN = r"constexpr int FWD_STAGE_MIN = \d+;"
FWD_STAGED = {
    "fwd unstaged": [(SOLVER, FWD_MIN, "constexpr int FWD_STAGE_MIN = 9;", 1)],
    "fwd staged nα=1": [(SOLVER, FWD_MIN, "constexpr int FWD_STAGE_MIN = 1;", 1)],
    **{f"fwd kc{kc}": [(SOLVER, r"constexpr int FWD_KC = \d+;", f"constexpr int FWD_KC = {kc};", 1)]
       for kc in (1, 4)},
    "fwd bufs3": [(SOLVER, r"constexpr int FWD_BUFS = \d+;", "constexpr int FWD_BUFS = 3;", 1)],
    # fwd_kernel (the rollout's): its step loop unrolled once (not at all) or four times,
    # not twice, or 32 lanes a block at any nα
    **{f"fwd unroll{n}": [(SOLVER, r"#pragma unroll 2\n#endif", f"#pragma unroll {n}\n#endif", 1)]
       for n in (1, 4)},
    "fwd lanes32": [(SOLVER, r"const int lanes = na >= 4 \? 32 : 32 \* \(4 / na\);",
                     "const int lanes = 32;", 1)],
}
SBWD = "lane_sbwd.cu"
SFWD = "lane_sfwd.cu"
# K4/K6's f32 blocks an SM above n̂ = 5 (SfwdBlocksPerSM), K4's and K6's alike.
SFWD_CAP = r"NH <= 5 \? SweepBlocksPerSM<T, NH>::value : \(sizeof\(T\) == 4 \? \d : 1\)"
# K4/K6 above n̂ = 5 without one of sfwd_wide's changes, or without sfwd_wide.
SFWD_OFF = {name: (SFWD, rf"constexpr bool SFWD_{name} = true;",
                   f"constexpr bool SFWD_{name} = false;", 1)
            for name in ("SELECT", "LAZY")}
LEAN_K1 = r"constexpr bool RIC_LEAN = SYS == CARTPOLE \|\| SYS == DOUBLE_INTEGRATOR;"
# The cart-pole's K1 without ric_step's LEAN phase B (RIC_LEAN), the parent's K1.
NO_LEAN = [(SOLVER, LEAN_K1, "constexpr bool RIC_LEAN = SYS == DOUBLE_INTEGRATOR;", 1)]
LEAN_K3 = r"constexpr bool SBWD_LEAN = SYS == DOUBLE_INTEGRATOR \|\| SYS == CARTPOLE;"
# The double integrator's K1 and K3/K5 without the LEAN phase B (RIC_LEAN, SBWD_LEAN).
DI_NO_LEAN = [(SOLVER, LEAN_K1, "constexpr bool RIC_LEAN = SYS == CARTPOLE;", 1),
              (SBWD, LEAN_K3, "constexpr bool SBWD_LEAN = SYS == CARTPOLE;", 1)]
# The cart-pole's K3/K5 without the LEAN phase B (SBWD_LEAN), and without each of its own
# changes (lane_sbwd.cu: CARTPOLE_LIT, CARTPOLE_COLS, CARTPOLE_SEL).
CP_NO_LEAN = [(SBWD, LEAN_K3, "constexpr bool SBWD_LEAN = SYS == DOUBLE_INTEGRATOR;", 1)]
CP_OFF = {name: (SBWD, rf"constexpr bool CARTPOLE_{name} = true;",
                 f"constexpr bool CARTPOLE_{name} = false;", 1)
          for name in ("LIT", "COLS", "SEL")}
# The double integrator's Jacobian rows all stored by phase A and loaded by phase B, as
# for the other systems, not its rows 0..n-1 taken as literals (LINEAR).
NO_LIT = [(SWEEP, r"constexpr bool LinearStep<DoubleIntegratorStep<T>> = true;",
           "constexpr bool LinearStep<DoubleIntegratorStep<T>> = false;", 1)]
# Its phase A's balanced-equality factors by IEEE division, not by select (SelectFactors).
NO_SEL = [(SWEEP, r"constexpr bool SelectFactors<DoubleIntegratorStep<T>> = true;",
           "constexpr bool SelectFactors<DoubleIntegratorStep<T>> = false;", 1)]
# K3/K5 on the split sweep (sweep_split: two threads a lane in phase B) from n̂ = 5, not
# only above it.
SPLIT5 = [(SBWD, r"NH > 5", "NH > 4", 4)]
# Three warps a block, two of them phase A with a step each a chunk.
W3 = [(SWEEP, r"constexpr int SWEEP_WARPS = 4;", "constexpr int SWEEP_WARPS = 3;", 1),
      (SWEEP, r"constexpr int SWEEP_KC = 3;", "constexpr int SWEEP_KC = 2;", 1)]
# K4's chain on sfwd_kernel's own body (and sfwd_wide's): phase A linearises chunks 0 and 1
# alone, and phase B runs every chunk j over the rows of chunk j & 1, real rows of other
# steps (B only runs over whatever shared memory holds); with it, the chain's gains taken from
# the step's rows, not loaded from device memory.
B_WARM = (SWEEP, r"if \(j \+ 1 < chunks\) linearise\(j \+ 1, warp - 1, SWEEP_WARPS - 1\);",
          "if (j + 1 < chunks && j < 1) linearise(j + 1, warp - 1, SWEEP_WARPS - 1);", 1)
LOAD_GAINS = r"load_gains<S>\(next, Kg, kff, k \+ 1 < N \? k \+ 1 : k, Bs, lane\);"
GAINS_SMEM = (SFWD, LOAD_GAINS,
              "{\n#pragma unroll\n          for (int a = 0; a < M; ++a) {\n"
              "            next.kf[a] = row[a * 32];\n#pragma unroll\n"
              "            for (int i = 0; i < NH; ++i)\n"
              "              next.K[a][i] = row[(M + a * NH + i) * 32];\n"
              "          }\n        }", 2)


def gains_ahead(d):
    """The chain's gains of step k+d prefetched into L1 while step k runs, so that the load
    of step k+1's (one step ahead, into registers) finds them there. Registers d steps ahead
    would need the chain's step loop unrolled d times: an instruction that moves a register a
    load still writes waits for the load."""
    return (SFWD, LOAD_GAINS,
            "load_gains<S>(next, Kg, kff, k + 1 < N ? k + 1 : k, Bs, lane);\n        {\n"
            f"          const size_t kp = k + {d} < N ? k + {d} : N - 1;\n#pragma unroll\n"
            "          for (int a = 0; a < M; ++a) {\n"
            "            asm volatile(\"prefetch.global.L1 [%0];\" ::\n"
            "                         \"l\"(kff + (kp * M + a) * Bs + lane));\n"
            "#pragma unroll\n            for (int i = 0; i < NH; ++i)\n"
            "              asm volatile(\"prefetch.global.L1 [%0];\" :: "
            "\"l\"(Kg + (kp * (M * NH) + a * NH + i) * Bs + lane));\n          }\n        }", 2)


# K4 on sfwd_kernel's own body (the double integrator's and the cart-pole's K4 before
# sfwd_staged): phase A alone; the chain over real rows (B_WARM), with its gains from the
# rows (its arithmetic alone); the gains prefetched 2 or 4 steps ahead; phase A's
# balanced-equality factors by select (fhat_lin_select, as sfwd_wide_lin).
SFWD_PROBES = {
    "sfwd A only": [A_ONLY],
    "sfwd B warm": [B_WARM],
    "sfwd B warm smem": [B_WARM, GAINS_SMEM],
    "sfwd gains d2": [gains_ahead(2)],
    "sfwd gains d4": [gains_ahead(4)],
    "sfwd sel": [(SFWD, r"\n  fhat_lin<S>\(p, xs, us, alpha, gamma, tight, L\);",
                  "\n  fhat_lin_select<S>(p, xs, us, alpha, gamma, tight, L);", 1)],
}
# The double integrator's and the cart-pole's K4 on sfwd_staged: without it (sfwd_kernel's own
# body), with phase A's factors by division, the chain skipped (phase A and its copies alone),
# and the chain over the real rows of chunks 0 and 1 (j & 1) with every chunk's gains and
# inputs still copied.
STAGED_PROBES = {
    "sfwd parent": [(SFWD, r"constexpr bool SFWD_STAGED = !GENERIC && \(SYS == DOUBLE_INTEGRATOR "
                           r"\|\| SYS == CARTPOLE\);", "constexpr bool SFWD_STAGED = false;", 1)],
    "sfwd no sel": [SFWD_OFF["SELECT"]],
    "staged A only": [(SFWD, r"chain\(k, buf \+ \(k - lo\) \* STEP\);", "(void)buf;", 1)],
    "staged B warm": [(SFWD, r"linearise\(j \+ 1\);", "if (j < 1) linearise(j + 1);", 1)],
}
VARIANTS = {  # family: {name: [(file, regex, replacement, matches, None for at least one)]}
    "dubins": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        **KC,
        **CAP,
    },
    "cartpole": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        "A only cap2": [A_ONLY, *CAP["cap2"]],
        "B only cap2": [B_ONLY, *CAP["cap2"]],
        **KC,
        **CAP,
        "rot": ROT,
        "rot B only": [*ROT, B_ONLY],
        "w6": W6,
        "w6 cap3": [*W6, *CAP["cap3"]],
        "no lean": [*NO_LEAN, *CP_NO_LEAN],
        # K3/K5 with one of its changes alone (without the LEAN phase B), or none
        **{name.lower(): [*CP_NO_LEAN, *(e for n, e in CP_OFF.items() if n != name)]
           for name in CP_OFF},
        "parent": [*CP_NO_LEAN, *CP_OFF.values()],
        **SFWD_PROBES,
        **STAGED_PROBES,
    },
    "cartpole_log": {
        "kept": [],
        "no lean": NO_LEAN,
        **SFWD_PROBES,
        **STAGED_PROBES,
    },
    "double_integrator": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        **KC,
        **CAP,
        "w3": W3,
        "split": [*SPLIT5, *NO_LIT],
        "no lit": NO_LIT,
        "no lean": DI_NO_LEAN,
        "no sel": NO_SEL,
        "parent": [*NO_LIT, *DI_NO_LEAN, *NO_SEL],
        **SFWD_PROBES,
        **STAGED_PROBES,
    },
    "double_integrator_min": {"kept": [], **SFWD_PROBES, **STAGED_PROBES},
    "quadrotor2d": {
        "kept": [],
        "A only": [A_ONLY],
        "B only": [B_ONLY],
        **{f"cap{n}": [(SWEEP, r"NH > 5 \? \(sizeof\(T\) == 4 \? \d+ : 1\)",
                        f"NH > 5 ? (sizeof(T) == 4 ? {n} : 1)", 1)] for n in (2, 3, 4)},
        **{name: [(SWEEP, r"constexpr int SPLIT_PARTS = \d+;", f"constexpr int SPLIT_PARTS = {n};",
                   1),
                  (SWEEP, r"constexpr int SPLIT_AW = \d+;", f"constexpr int SPLIT_AW = {aw};", 1)]
           for name, n, aw in (("parts4 aw2", 4, 2), ("parts4 aw1", 4, 1), ("parts2 aw1", 2, 1))},
        **FWD_CAP,
        **FWD_STAGED,
        **{f"sfwd cap{n}": [(SFWD, SFWD_CAP, "NH <= 5 ? SweepBlocksPerSM<T, NH>::value : "
                             f"(sizeof(T) == 4 ? {n} : 1)", 1)] for n in (2, 3, 4)},
        **{f"sfwd {kc}": edits for kc, edits in KC.items() if kc != "kc6"},
        # K4/K6 above n̂ = 5 without one of sfwd_wide's changes; without sfwd_wide (its kernel
        # body, at two f32 blocks an SM)
        "sfwd no sel": [SFWD_OFF["SELECT"]],
        "sfwd eager": [SFWD_OFF["LAZY"]],
        "sfwd parent": [(SFWD, r"constexpr bool SFWD_WIDE = NH > 5;",
                         "constexpr bool SFWD_WIDE = false;", 1),
                        (SFWD, SFWD_CAP, "NH <= 5 ? SweepBlocksPerSM<T, NH>::value : "
                         "(sizeof(T) == 4 ? 2 : 1)", 1)],
        "sfwd B warm": [B_WARM],
    },
}
SOURCES = ("lane_solver", "lane_sbwd", "lane_sfwd")   # the steps' inputs run every kernel
PROBED = {  # the instantiations whose ptxas lines are printed
    "dubins": ("ric_kernel<float, dubins, 5>", "sbwd_kernel<float, false, false, dubins, 5>",
               "sfwd_kernel<float, false, false, dubins, 5>"),   # the paper's
    "cartpole": tuple(f"{k}<{t}{flags}, cartpole, 0>" for t in ("float", "double")
                      for k, flags in (("ric_kernel", ""), ("sbwd_kernel", ", false, false"),
                                       ("sbwd_kernel", ", true, false"),
                                       ("sbwd_kernel", ", true, true"),
                                       ("sfwd_kernel", ", false, false"))),
    "cartpole_log": tuple(f"{k}<{t}{flags}, cartpole, 0>" for t in ("float", "double")
                          for k, flags in (("ric_kernel", ""), ("sfwd_kernel", ", false, false"))),
    "double_integrator": tuple(f"{k}<{t}{flags}, double_integrator, 2>"
                               for t in ("float", "double")
                               for k, flags in (("ric_kernel", ""),
                                                ("sbwd_kernel", ", false, false"),
                                                ("sbwd_kernel", ", true, false"),
                                                ("sbwd_kernel", ", true, true"),
                                                ("sfwd_kernel", ", false, false"))),
    "double_integrator_min": tuple(f"sfwd_kernel<{t}, false, false, double_integrator, 2>"
                                   for t in ("float", "double")),
    "quadrotor2d": tuple(f"{k}<{t}{flags}, quadrotor2d, 4>" for t in ("float", "double")
                         for k, flags in (("ric_kernel", ""), ("sbwd_kernel", ", false, false"),
                                          ("sbwd_kernel", ", true, false"),
                                          ("sbwd_kernel", ", true, true"), ("fwd_kernel", ""),
                                          ("fwd_staged_kernel", ""),
                                          ("sfwd_kernel", ", false, false"),
                                          ("sfwd_kernel", ", true, false"),
                                          ("sfwd_kernel", ", true, true"))),
}
CASES = {"dubins": ab.CASES["dubins"],
         "cartpole": [(" cartpole", "paper_step", {"family": "cartpole"}, ("ric", "sbwd", "sfwd")),
                      (" cartpole N=40", "coupled_step",
                       {"family": "cartpole", "N_": 40, "solver": True},
                       ("ric", "sbwd_generic", "sbwd_upper"))],
         "cartpole_log": ab.CASES["cartpole_log"],
         **{f: [c for c in ab.CASES[f] if "dtype" not in c[2]]
            for f in ("double_integrator", "double_integrator_min")},
         "quadrotor2d": [c for c in ab.CASES["quadrotor2d"] if "dtype" not in c[2]]}
# The device functions of one step of each phase of K1 (lane_solver.cu), whose SASS
# instructions are counted by their line info.
PHASES = {"phase A (lin_step)": (SOLVER, "lin_step"), "phase B (ric_step)": (SOLVER, "ric_step"),
          "phase A (sbwd_lin)": (SBWD, "sbwd_lin"), "phase B (sbwd_step)": (SBWD, "sbwd_step"),
          "phase A (sfwd_lin)": (SFWD, "sfwd_lin"),
          "phase A (sfwd_wide_lin)": (SFWD, "sfwd_wide_lin"),
          "phase A (sfwd_staged_lin)": (SFWD, "sfwd_staged_lin"),
          "phase A (cartpole_lin)": (SBWD, "cartpole_lin")}


def variant_sources(csrc: Path, edits, out: Path):
    """Copy csrc's sources into out with the edits applied; fail unless each edit matches
    as often as it says (at least once where it says None)."""
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted(csrc.glob("*.cu*")):
        text = src.read_text()
        for name, pattern, repl, count in edits:
            if name == src.name:
                text, n = re.subn(pattern, repl, text)
                if n != count and not (count is None and n > 0):
                    raise SystemExit(f"ric_probe: {pattern!r} matched {n} times in {name}")
        (out / src.name).write_text(text)


def built(edits, names):
    """The sources a variant builds: all of them where an edit is to the shared header,
    else those it edits (the others are kept's)."""
    files = {name for name, *_ in edits}
    if not files or SWEEP in files:
        return names
    return [n for n in names if f"{n}.cu" in files]


def ptxas_lines(log: str, label, kernel: str):
    """The ptxas lines of `kernel` (a label as chip_smoke.kernel_label writes it)."""
    lines = [label(x.strip()) for x in log.splitlines()]
    for i, x in enumerate(lines):
        if "Compiling entry" in x and f"'{kernel}'" in x:
            return [y for y in lines[i + 1:i + 4] if "spill" in y or "registers" in y]
    return []


def frames(sass: str):
    """(kernel symbol, line-info chain [(file name, line), innermost first], instruction)
    of each SASS instruction of nvdisasm -gi's output."""
    fn, chain, fresh = None, [], True
    for line in sass.splitlines():
        if "/*" not in line:
            m = re.search(r"\.text\.(_Z\w+)", line)
            if m:
                fn = m.group(1)
                continue
        if "//##" in line:   # one frame and its caller a line, innermost first
            frames_ = [(Path(f).name, int(n)) for f, n in re.findall(r'"([^"]+)", line (\d+)', line)]
            chain = frames_ if fresh else chain + frames_
            fresh = False
            continue
        m = re.search(r"/\*[0-9a-f]+\*/\s+(\S.*?)\s*;", line)
        if m and fn:
            fresh = True
            yield fn, chain, m.group(1)


def spill_sites(sass: str, sources):
    """{kernel symbol: Counter((STL or LDL, "<source> line N"))}: each local-memory
    instruction at the innermost frame of its line-info chain that lies in one of
    `sources` (file names)."""
    counts = {}
    for fn, chain, ins in frames(sass):
        m = re.match(r"(?:@!?U?P\w+\s+)?(STL|LDL)\b", ins)
        if not m:
            continue
        ours = [(f, ln) for f, ln in chain if f in sources]
        site = f"{ours[0][0]} line {ours[0][1]}" if ours else "unplaced"
        counts.setdefault(fn, Counter())[(m.group(1), site)] += 1
    return counts


def function_lines(text: str, name: str):
    """The lines (1-based, first and last) of the device function `name` in a source's
    text: from its declaration to the first closing brace at the start of a line."""
    lines = text.splitlines()
    first = next(i for i, x in enumerate(lines) if re.search(rf"\bvoid {name}\(", x))
    last = next(i for i in range(first, len(lines)) if lines[i].startswith("}"))
    return first + 1, last + 1


def phase_instructions(sass: str, ranges):
    """{kernel symbol: Counter(phase, "all")}: the SASS instructions of each kernel, and
    those with a frame of their line-info chain in a phase's lines (ranges: {phase: (file
    name, first line, last line)})."""
    counts = {}
    for fn, chain, _ in frames(sass):
        c = counts.setdefault(fn, Counter())
        c["all"] += 1
        for phase, (name, lo, hi) in ranges.items():
            if any(f == name and lo <= ln <= hi for f, ln in chain):
                c[phase] += 1
    return counts


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(VARIANTS), default="dubins")
    ap.add_argument("--tree", type=Path, default=TOOLS.parent,
                    help="the checkout whose kernel sources are probed (default: this one)")
    ap.add_argument("--variants", nargs="+",
                    help="the variants to build and time (default: all of the family's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ric_probe: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke
    from tube_mpc_tpu_torch.ops.cuda import _build

    label = chip_smoke.kernel_label
    card = chip_smoke.nvidia_smi()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    family, csrc = args.family, args.tree.resolve() / "tube_mpc_tpu_torch" / "csrc"
    variants = {v: e for v, e in VARIANTS[family].items()
                if v == "kept" or not args.variants or v in args.variants}
    out_dir = _build.BUILD_DIR / "probe" / family
    names = SOURCES
    flags = list(_build.flags(_build.library_name("lane_solver", family)))
    jobs, keys = [], []
    for variant, edits in variants.items():
        vdir = out_dir / variant.replace(" ", "_")
        variant_sources(csrc, edits, vdir)
        for name in built(edits, names):
            keys.append((variant, name))
            jobs.append((flags, vdir / f"{name}.cu", vdir / f"lib{name}.so"))
    cubin_flags = [f for f in flags if f not in ("-shared", "-Xcompiler", "-fPIC")]
    for name in names:
        keys.append(("kept, -lineinfo cubin", name))
        jobs.append((["-cubin", "-lineinfo", *cubin_flags], csrc / f"{name}.cu",
                     out_dir / f"{name}_lineinfo.cubin"))
    libs, paths = {}, {}
    for (variant, name), job, (rc, log) in zip(keys, jobs, ab.build_all(_build.nvcc_path(), jobs)):
        if rc != 0:
            raise SystemExit(f"ric_probe: nvcc failed on {variant} {name}:\n{log}")
        for kernel in PROBED[family]:
            found = ptxas_lines(log, label, kernel)
            if found:
                print(f"[build] {variant}: {kernel}: {' | '.join(found)}", flush=True)
        if variant in variants:
            libs.setdefault(variant, []).append(ctypes.CDLL(str(job[2])))
            paths.setdefault(variant, []).append(job[2])
    for variant in variants:   # a variant's unedited sources: kept's libraries
        libs[variant] = libs.get(variant, []) + libs["kept"]
        for so in paths.get(variant, []):
            for sym, (n, _) in sorted(ab.sass_of(so).items()):
                if label(sym) in PROBED[family]:
                    print(f"[sass] {variant}: {label(sym)}: {n} instructions", flush=True)
    builds = {variant: ab.TreeLib(found) for variant, found in libs.items()}

    result = {"card": card, "family": family, "tree": str(args.tree), "B": chip_smoke.B,
              "runs": RUNS, "ms": {}, "bitwise": {}, "spills": {}, "instructions": {}}
    dev = torch.device("cuda", 0)
    cases = ab.on_build(builds["kept"], lambda: ab.step_cases(torch, dev, CASES[family]))()
    for case, (call, _, ins, *_) in cases.items():
        runs = {v: ab.on_build(lib, lambda: call(*ins)) for v, lib in builds.items()}
        outs = {v: run() for v, run in runs.items()}
        torch.cuda.synchronize()
        times = {v: [] for v in builds}
        for order in (list(builds), list(builds)[::-1]):
            for v in order:
                times[v].append(chip_smoke.device_time_ms(torch, runs[v], RUNS))
        result["ms"][case] = times
        result["bitwise"][case] = {v: ab.bitwise_equal(torch, outs[v], outs["kept"]) for v in builds}
        for v in builds:
            print(f"[time] {case} {v}: {', '.join(f'{t!r}' for t in times[v])} ms (mean of "
                  f"{RUNS} back to back, twice); outputs bitwise those of kept: "
                  f"{result['bitwise'][case][v]}", flush=True)

    tool = shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm"
    sources = [f"{name}.cu" for name in names] + list(_build.HEADERS)
    ranges = {phase: (f, *function_lines((csrc / f).read_text(), fn))
              for phase, (f, fn) in PHASES.items()
              if re.search(rf"\bvoid {fn}\(", (csrc / f).read_text())}   # the tree's own
    probed = set(PROBED[family])
    for name in names:
        sass = subprocess.run([tool, "-gi", "-c", str(out_dir / f"{name}_lineinfo.cubin")],
                              capture_output=True, text=True, timeout=600, check=True).stdout
        (out_dir / f"{name}_lineinfo.sass").write_text(sass)
        for sym, c in sorted(spill_sites(sass, sources).items(), key=lambda kv: label(kv[0])):
            by = {f"{op} {part}": n for (op, part), n in sorted(c.items())}
            result["spills"][label(sym)] = by
            print(f"[sass] {label(sym)}: local-memory instructions {json.dumps(by)}", flush=True)
        for sym, c in sorted(phase_instructions(sass, ranges).items(), key=lambda kv: label(kv[0])):
            if label(sym) in probed:
                result["instructions"][label(sym)] = dict(c)
                print(f"[sass] {label(sym)}: SASS instructions {json.dumps(dict(c))}", flush=True)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
