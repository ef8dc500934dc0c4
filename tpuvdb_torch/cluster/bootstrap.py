"""Multi-process bootstrap: the port of tpuvdb/cluster/bootstrap.py.

The reference joins every host to one JAX runtime
(`jax.distributed.initialize`), so its mesh spans every host's devices. The
port joins a `torch.distributed` process group instead: NCCL when the
process has a CUDA card (the one it has made current), gloo on the CPU. A
mesh created after it (`mesh.create_mesh`) spans every process's slots in
rank order; each process holds and scans only its own, and a search's
(Q, k) results meet in an all_gather (mesh/sharded.py).

The HTTP frontends (one per host, api/server.py) register with the
NodeRegistry as in the reference.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _local_devices() -> int:
    """Slots this process brings by default: its CUDA cards, or the CPU."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> dict:
    """Join (or, with neither a coordinator nor a process count, skip) the
    process group. The arguments default to TPUVDB_COORDINATOR
    ("host:port" or an init URL), TPUVDB_NUM_PROCESSES and
    TPUVDB_PROCESS_ID; one process with a coordinator does join (a group
    of one). Returns the topology: process_index, process_count,
    local_devices and global_devices."""
    coordinator_address = (coordinator_address
                           or os.environ.get("TPUVDB_COORDINATOR"))
    if num_processes is None and os.environ.get("TPUVDB_NUM_PROCESSES"):
        num_processes = int(os.environ["TPUVDB_NUM_PROCESSES"])
    if process_id is None and os.environ.get("TPUVDB_PROCESS_ID"):
        process_id = int(os.environ["TPUVDB_PROCESS_ID"])

    if (coordinator_address or num_processes) and not dist.is_initialized():
        if coordinator_address is None:
            init = "env://"  # MASTER_ADDR / MASTER_PORT
        elif "://" in coordinator_address:
            init = coordinator_address
        else:
            init = f"tcp://{coordinator_address}"
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            init_method=init, world_size=num_processes or 1,
            rank=process_id or 0)
    local = _local_devices()
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1,
                "local_devices": local, "global_devices": local}
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    total = torch.tensor([local], dtype=torch.int64, device=dev)
    dist.all_reduce(total)
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": local,
            "global_devices": int(total.item())}


def shutdown_multihost():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
