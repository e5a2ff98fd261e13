"""Process initialisation and multi-host meshes on ``torch.distributed``
(counterpart of ``superbblas_tpu/parallel/multihost.py``).

The reference distributes over MPI ranks (MpiComm, dist.h:126-138).  Here
every rank is one process: ``initialize_distributed`` is the MPI_Init
analog (``dist.init_process_group``: NCCL for CUDA, gloo for the CPU,
the CPU only where the caller names it), and ``make_multihost_mesh`` lays
the ranks out so that the axis named ``dcn_axis`` crosses hosts (its
slowest factor), keeping the other axes inside a host, whose ranks are
grouped by ``LOCAL_WORLD_SIZE`` as torchrun sets it.
"""

from __future__ import annotations

import os
import socket
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["initialize_distributed", "make_multihost_mesh"]


def _default_device(device: Optional[str]) -> str:
    """The device type of a distributed entry point: "cuda" unless the
    caller names "cpu"; "cuda" without a card raises."""
    device = "cuda" if device is None else device
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the distributed layer runs NCCL on the card; "
                           "pass device='cpu' (devices='cpu' to make_mesh) for gloo")
    return device


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Bring up the process group (the MPI_Init analog).

    ``coordinator_address`` is "host:port" of rank 0's store, and
    ``num_processes``/``process_id`` the world size and this rank; where
    not given they come from ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` (as torchrun sets them), else a one-process
    group on a free localhost port.  The backend is NCCL for ``device``
    "cuda" (the default) and gloo for "cpu".  Idempotent: a second call,
    or a call in a process whose group is up, does nothing."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    device = _default_device(device)
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise ValueError("initialize_distributed: give coordinator_address for "
                             f"{num_processes} processes")
    if device == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))


def make_multihost_mesh(
    axis_sizes: Dict[str, int],
    dcn_axis: Optional[str] = None,
):
    """Global DeviceMesh over all ranks with labelled axes.

    ``axis_sizes``: label -> extent (the product equals the world size).
    ``dcn_axis`` names the axis that crosses hosts: its leading factor
    (the number of hosts) runs over hosts, so the other axes and the rest
    of it stay inside one host — the analog of the reference putting the
    outermost lattice label on the node grid (dist.h:3265-3383)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh: call initialize_distributed first")
    names = list(axis_sizes.keys())
    shape = tuple(int(axis_sizes[n]) for n in names)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh volume {int(np.prod(shape))} != world size {world}")
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nhosts = max(world // max(per_host, 1), 1)
    ranks = np.arange(world)
    if dcn_axis is not None and nhosts > 1:
        if dcn_axis not in axis_sizes:
            raise ValueError(f"dcn_axis {dcn_axis!r} not in axis_sizes")
        if axis_sizes[dcn_axis] % nhosts:
            raise ValueError(f"dcn axis {dcn_axis!r} ({axis_sizes[dcn_axis]}) must be a "
                             f"multiple of the host count ({nhosts})")
        pos = names.index(dcn_axis)
        inner = axis_sizes[dcn_axis] // nhosts
        others = [axis_sizes[n] for i, n in enumerate(names) if i != pos]
        arr = ranks.reshape((nhosts, inner) + tuple(others))
        arr = arr.reshape((nhosts * inner,) + tuple(others))
        ranks = np.moveaxis(arr, 0, pos)
    else:
        ranks = ranks.reshape(shape)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.from_numpy(np.ascontiguousarray(ranks)),
                      mesh_dim_names=tuple(names))
