"""Process groups and device meshes for scenario-parallel tube MPC (port of
tube_mpc_tpu/parallel/mesh.py).

The scaling axis of this workload is the scenarios (disturbance draws, starts, parameter
candidates): the states have 3 to 7 dimensions, so there is nothing to split inside a
scenario. The scenarios are split over the ranks of a ``torch.distributed`` process group,
one rank per card, and the population adaptation's gradients are summed over them with
``all_reduce``. Where the JAX package takes the devices of one process (or of several hosts
after ``jax.distributed.initialize``), the port takes one process per card: launch with
``torchrun --nproc-per-node=<cards>``, then ``init_distributed()`` and ``make_mesh()``.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh

SCENARIO_AXIS = "scenario"


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> int:
    """Join (or start) the process group: ``torch.distributed.init_process_group`` with
    ``init_method`` (e.g. "tcp://localhost:29500", "file:///shared/path"), ``world_size``
    and ``rank``, or else with torch's environment (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE: what torchrun sets). Neither given, or a group already there: nothing to do.
    The backend is NCCL where a card is available and gloo otherwise; with NCCL each
    process takes the card of its LOCAL_RANK (else its rank modulo the cards). Returns the
    group's world size (1 without a group)."""
    if not dist.is_initialized() and (init_method or "MASTER_ADDR" in os.environ):
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            local = os.environ.get("LOCAL_RANK")
            r = int(local) if local is not None else int(
                rank if rank is not None else os.environ.get("RANK", 0))
            torch.cuda.set_device(r % torch.cuda.device_count())
        kw = {} if init_method is None else {"init_method": init_method}
        if world_size is not None:
            kw["world_size"] = world_size
        if rank is not None:
            kw["rank"] = rank
        dist.init_process_group(backend=backend, **kw)
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = SCENARIO_AXIS,
              device: DeviceLike = None) -> DeviceMesh:
    """A 1-D DeviceMesh named ``axis_name`` over every rank of the process group, one rank
    per card: device type "cuda" unless ``device="cpu"`` (gloo), and without a card it
    raises. ``n_devices``, where given, must be the world size: a mesh over fewer ranks
    would need every rank to build it (the JAX package takes the first n devices). Needs
    the process group (init_distributed)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.mesh.init_distributed first "
                           "(under torchrun it reads the environment)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh takes every rank of the process "
                         f"group, {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def scenario_sharding(mesh: DeviceMesh, axis_name: str = SCENARIO_AXIS):
    """The DTensor placements of a tensor whose leading (scenario) dim is split over the
    mesh and everything else replicated."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh: DeviceMesh):
    """The DTensor placements of a tensor held whole on every rank."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
