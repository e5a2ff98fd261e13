"""One rank's place in a cell: its X slab of the lattice, the halo planes
beside it, the process group and mesh of a cell on several cards, and
the few collectives the harness and the reference need.

A cell on one card is one rank whose slab is the whole lattice; its
halo planes wrap around (periodic boundaries).  On several cards the
lattice is split on X, the first axis, one slab a rank: the port's
sharded stencil takes only X and Y with a radius (Z and T ride the
kernel's register tiles).
"""

from __future__ import annotations

import datetime
import time

import torch

#: seconds a collective may wait for the other ranks before it fails
COLLECTIVE_TIMEOUT = 300


class Ranks:
    """``lat``: the lattice the cell's cards hold together (X first)."""

    def __init__(self, device: str, lat, rank: int = 0, world: int = 1, port=None):
        self.device, self.rank, self.world = device, rank, world
        self.lat = tuple(int(v) for v in lat)
        X = self.lat[0]
        if X % world:
            raise ValueError(f"X = {X} does not split over {world} ranks")
        self.xl = X // world
        self.x0 = rank * self.xl
        self.planes = list(range(self.x0, self.x0 + self.xl))
        self.planes_ext = [(self.x0 + i) % X for i in range(-1, self.xl + 1)]
        self.rest = self.lat[1:]
        self.mesh = None
        if world > 1:
            import torch.distributed as dist

            from superbblas_tpu_torch import parallel

            cuda = device.startswith("cuda")
            dist.init_process_group("nccl" if cuda else "gloo",
                                    init_method=f"tcp://localhost:{port}",
                                    world_size=world, rank=rank,
                                    timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
            self.mesh = parallel.make_mesh({"X": world}, "cuda" if cuda else "cpu")

    # ---- synchronisation -------------------------------------------------
    def sync(self):
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def barrier(self):
        self.sync()
        if self.world > 1:
            self.all_sum(torch.zeros(1, dtype=torch.float64, device=self.device))
            self.sync()

    def clock(self) -> float:
        """Host seconds after the device has finished what was queued."""
        self.sync()
        return time.perf_counter()

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t)
        return t

    def all_min(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())

    def close(self):
        if self.world > 1:
            import torch.distributed as dist

            self.barrier()
            dist.destroy_process_group()

    # ---- halos -------------------------------------------------------------
    def extend(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        """``t`` with one halo plane on each side of its X ``axis``: the
        neighbouring ranks' edge planes, or this slab's own wrapped."""
        first, last = t.narrow(axis, 0, 1), t.narrow(axis, t.shape[axis] - 1, 1)
        if self.world == 1:
            return torch.cat([last, t, first], axis)
        import torch.distributed as dist

        edges = torch.stack([first, last]).contiguous()
        real = torch.view_as_real(edges) if edges.is_complex() else edges
        out = real.new_empty((self.world * 2,) + tuple(real.shape[1:]))
        dist.all_gather_into_tensor(out, real)
        out = out.reshape((self.world,) + tuple(real.shape))
        if edges.is_complex():
            out = torch.view_as_complex(out)
        left = out[(self.rank - 1) % self.world, 1]
        right = out[(self.rank + 1) % self.world, 0]
        return torch.cat([left, t, right], axis)

    # ---- sharded fields ------------------------------------------------------
    def wrap(self, parts, axis: int):
        """A CArray of this rank's slabs [*lead, xl, *rest] (re, im): plain
        on one rank, DTensors sharded on the X ``axis`` on several."""
        from superbblas_tpu_torch.cplx import CArray

        if self.world == 1:
            return CArray(*parts)
        from torch.distributed.tensor import DTensor, Shard

        shape = list(parts[0].shape)
        shape[axis] *= self.world
        shape = tuple(shape)
        stride = tuple(int(torch.Size(shape)[k + 1:].numel()) for k in range(len(shape)))
        return CArray(*(DTensor.from_local(p.contiguous(), self.mesh, [Shard(axis)],
                                           run_check=False, shape=shape, stride=stride)
                        for p in parts))


def local(t):
    """This rank's shard of a DTensor (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def lmap(fn, t):
    """``fn`` on this rank's shard, the result with ``t``'s placements: an
    elementwise map that moves nothing between ranks."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return fn(t)
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape, stride=t.stride())


class Spans:
    """The benchmark's spans around its calls into the port: CUDA events a
    call on the card (host clock on the CPU), recorded only while on."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.on = False
        self.pairs = {}

    def __call__(self, name, fn, *args):
        if not self.on:
            return fn(*args)
        if self.cuda:
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args)
            e.record()
        else:
            s = time.perf_counter()
            out = fn(*args)
            e = time.perf_counter()
        self.pairs.setdefault(name, []).append((s, e))
        return out

    def read(self) -> dict:
        """{name: [ms, ...]} of every span recorded."""
        if self.cuda:
            torch.cuda.synchronize()
            return {n: [s.elapsed_time(e) for s, e in p] for n, p in self.pairs.items()}
        return {n: [1e3 * (e - s) for s, e in p] for n, p in self.pairs.items()}
