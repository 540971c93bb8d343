"""Hand-written CUDA kernels of the lane engine and their launch counts.

KERNELS maps each kernel variant's name to its wrapper; a wrapper's ``launches``
counts the times it launched its CUDA kernel (plain-version calls on CPU tensors
do not count), its ``by_system`` the same for each library variant it launched
from (the system, with ``_min`` and ``_log`` for the exact-min aggregation and the log
barrier: "dubins", "quadrotor2d_min_log"), and its ``by_width`` for each lane count it
launched at (straggler compaction runs K1 and K2 on fewer lanes). K1 ``ric``, K2 ``fwd``; K3 ``sbwd`` and K4 ``sfwd`` (paper); K5
``sbwd_generic`` and ``sbwd_upper``, K6 ``sfwd_generic`` and ``sfwd_ref``
(generic and coupled). ``solve_counts`` returns the lane solver's counts of its host
reads and of the lanes that entered its iterations unconverged.
"""
from __future__ import annotations

from typing import Dict

from .lane_sensitivity import sbwd, sbwd_generic, sbwd_upper, sfwd, sfwd_generic, sfwd_ref
from .lane_solver import fwd, lane_ilqr_solve, ric

KERNELS = {
    "ric": ric, "fwd": fwd, "sbwd": sbwd, "sfwd": sfwd,
    "sbwd_generic": sbwd_generic, "sbwd_upper": sbwd_upper,
    "sfwd_generic": sfwd_generic, "sfwd_ref": sfwd_ref,
}


def launch_counts(by_system: bool = False, by_width: bool = False) -> Dict:
    """{kernel: launches}; with ``by_system`` {(kernel, variant): launches} for each
    library variant that launched the kernel (_build.VARIANTS); with ``by_width``
    {(kernel, lanes): launches} for each lane count it launched at."""
    if by_system:
        return {(name, fam): n for name, w in KERNELS.items() for fam, n in w.by_system.items()}
    if by_width:
        return {(name, b): n for name, w in KERNELS.items() for b, n in w.by_width.items()}
    return {name: w.launches for name, w in KERNELS.items()}


def solve_counts() -> Dict[str, int]:
    """{"host_reads": the lane solver's reads of the device by the host, "live_lane_iters":
    the lanes that entered its iterations unconverged, summed over the iterations}; on
    the CPU as on the card (lane_solver.lane_ilqr_solve)."""
    return dict(lane_ilqr_solve.counts)


def reset_launch_counts() -> None:
    """Set every launch count to 0, and the lane solver's counts of compaction stages,
    host reads and unconverged lane-iterations."""
    for w in KERNELS.values():
        w.launches, w.by_system, w.by_width = 0, {}, {}
    lane_ilqr_solve.stages = {"compacted": 0, "full": 0}
    lane_ilqr_solve.counts = {"host_reads": 0, "live_lane_iters": 0}
