"""PyTorch and CUDA port of tube_mpc_tpu for NVIDIA Hopper (H100).

The entry point is the lane engine's experiment runner: ``python -m
tube_mpc_tpu_torch.run_experiment --config configs/<name>.yaml`` (``runners``,
``utils.config``, ``utils.io``). Under it run two lane closed loops
(``tube.lane_closed_loop``), the paper loop (``run_paper_closed_loop_lanes``) and the
generic and coupled loop (``run_generic_closed_loop_lanes``), for each of the four
systems, each two lane iLQR solves and the lane sensitivity per step, on hand-written
CUDA kernels (``csrc/lane_solver.cu``, ``csrc/lane_sbwd.cu``, ``csrc/lane_sfwd.cu``)
built at first use by ``ops.cuda._build``. Each kernel has a plain PyTorch version
beside its wrapper, which runs for CPU tensors; the tests hold those against the JAX
package. ``parallel`` holds the scenario layer: tube verification, the population
Algorithm 2, and the device mesh over which the sharded paper loop
(``run_paper_closed_loop_lanes_sharded``) and the population gradient run.
"""
from .device import resolve_device, resolve_dtype

__all__ = ["resolve_device", "resolve_dtype"]
