"""Faults planted under the timed path, for test_bench_faults.py (a
module of its own so that spawned ranks can import it).  Each takes the
action's ``solve`` and returns a broken one."""

import torch

from superbblas_tpu_torch.cplx import CArray


def unchanged(solve):
    """A solve whose steps return their state unchanged: x stays x0 = 0."""
    def broken(b, **kw):
        x, rs, it = solve(b, **kw)
        return CArray(torch.zeros_like(x.re), torch.zeros_like(x.im)), rs, it

    return broken


def half_batch(solve):
    """Half the right-hand sides solved, the rest left out (x = 0 there)."""
    def broken(b, **kw):
        n = b.re.shape[0] // 2
        x, rs, it = solve(CArray(b.re[:n].contiguous(), b.im[:n].contiguous()), **kw)
        pad = torch.zeros_like(b.re[n:])
        return CArray(torch.cat([x.re, pad]), torch.cat([x.im, pad])), rs, it

    return broken


def altered(solve):
    """The answer altered where it is produced: one element set off by the
    field's largest magnitude."""
    def broken(b, **kw):
        x, rs, it = solve(b, **kw)
        re = x.re.contiguous().clone()
        re.view(-1)[0] += re.abs().max()
        return CArray(re, x.im), rs, it

    return broken


def no_exchange():
    """The halo exchange between ranks left out: each rank wraps its own
    slab where its neighbours' planes belong."""
    from superbblas_tpu_torch.parallel import halo

    def local_wrap(tensors, ax, _name, w, _mesh):
        return [torch.cat([t.narrow(ax, t.shape[ax] - w, w), t, t.narrow(ax, 0, w)], ax)
                for t in tensors]

    halo._extend_axis = local_wrap


def rank_main(rank, world, port, queue, workload, overrides, fault):
    import harness

    torch.set_num_threads(1)
    if fault == "no_exchange":
        no_exchange()
    part = harness.run_rank(workload, 987654321987, 0.5, False, rank=rank, world=world,
                            port=port, device="cpu", overrides=overrides)
    queue.put((rank, part))
