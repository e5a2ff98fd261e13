"""Cache management: the L2 cache-control surface of the reference
(counterpart of ``superbblas_tpu/utils/caches.py``).

The reference exposes ``clearCaches`` (alloc.h:440: drop the buffer cache
and the LRU metadata caches, e.g. to recover from allocation pressure)
and ``reportCacheUsage`` (performance.h:436-454).  The port's caches are:

  * K1's spin plans (``ops.stencil``: one per kron value, sum type and
    device, the most recent ``PLAN_CACHE``), with the small lru caches of
    the stencil wrappers (offsets checks, runtime-route tiles, offsets
    arguments);
  * the batched-GEMM tile choice by shape (``ops.batched_gemm._tile``)
    and the persistent grids' caps by device (``ops._cuda.grid_cap``);
  * the distributed layer's redistribution plans
    (``parallel.redistribute.make_plan``: a byte-budget LRU under
    SBT_CACHEGB, the reference's plan cache, dist.h:2303-2349), the
    sharded gather's halo plans (``parallel.gather_sharded``) and the
    halo-extended blocks of sharded SoA operators (``parallel.halo``'s
    ``extend_held``);
  * the CUDA caching allocator's reserved blocks (the reference's buffer
    cache), returned to the driver by ``torch.cuda.empty_cache``.
"""

from __future__ import annotations

import torch

__all__ = ["clear_caches", "report_cache_usage"]


def _lru_caches() -> dict:
    from ..ops import _cuda, batched_gemm, stencil

    return {"gemm_tiles": batched_gemm._tile, "grid_caps": _cuda.grid_cap,
            "stencil_offsets_ok": stencil._offsets_ok,
            "stencil_offsets_args": stencil._offsets_array,
            "stencil_rt_tiles": stencil.rt_tile}


def clear_caches() -> None:
    """Drop every library-level cache (clearCaches, alloc.h:440): the
    spin plans, the redistribution and gather halo plans, the held
    halo-extended blocks, the lru caches and the allocator's unused
    reserved blocks."""
    from ..ops import stencil
    from ..parallel import gather_sharded, halo, redistribute

    stencil.clear_plans()
    redistribute.make_plan.cache_clear()
    gather_sharded._GATHER_CACHE.clear()
    halo._HELD.clear()
    for fn in _lru_caches().values():
        fn.cache_clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def report_cache_usage(out=None) -> dict:
    """Print + return cache statistics: the spin plans kept (entries and
    the bytes of their device tables), the held halo-extended blocks
    (entries and bytes), each lru cache's entries, hits and misses, and
    the CUDA allocator's reserved bytes against the SBT_CACHEGB budget
    (reportCacheUsage, performance.h:436-454 + cache.h:238-265)."""
    from .. import flags
    from ..ops import stencil
    from ..parallel import gather_sharded, halo, redistribute

    plans = list(stencil._PLANS.values())
    stats = {
        "spin_plans": {
            "entries": len(plans),
            "max_entries": stencil.PLAN_CACHE,
            "bytes": sum(p.table.numel() * p.table.element_size()
                         for p in plans if p.table is not None),
        },
    }
    info = redistribute.make_plan.cache_info()
    stats["redistribution_plans"] = {"entries": info.currsize, "hits": info.hits,
                                     "misses": info.misses, "max_entries": info.maxsize,
                                     "bytes": info.bytes}
    stats["gather_halo_plans"] = {"entries": len(gather_sharded._GATHER_CACHE),
                                  "max_entries": gather_sharded._GATHER_CACHE_MAX}
    stats["held_halo_blocks"] = halo.held_usage()
    for name, fn in _lru_caches().items():
        info = fn.cache_info()
        stats[name] = {"entries": info.currsize, "hits": info.hits,
                       "misses": info.misses, "max_entries": info.maxsize}
    reserved = 0
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        reserved = sum(torch.cuda.memory_reserved(i)
                       for i in range(torch.cuda.device_count()))
    stats["allocator"] = {"reserved_bytes": reserved,
                          "budget_bytes": int(flags.get_cache_gb() * (1 << 30))}
    lines = ["cache usage:"]
    sp = stats["spin_plans"]
    lines.append(f"  spin plans: {sp['entries']}/{sp['max_entries']} entries, "
                 f"{sp['bytes']} bytes of device tables")
    rp = stats["redistribution_plans"]
    lines.append(f"  redistribution plans: {rp['entries']}/{rp['max_entries']} entries, "
                 f"{rp['bytes']} bytes, {rp['hits']} hits / {rp['misses']} misses")
    gp = stats["gather_halo_plans"]
    lines.append(f"  gather halo plans: {gp['entries']}/{gp['max_entries']} entries")
    hb = stats["held_halo_blocks"]
    lines.append(f"  held halo-extended blocks: {hb['entries']} entries, {hb['bytes']} bytes")
    for name in _lru_caches():
        c = stats[name]
        lines.append(f"  {name}: {c['entries']} entries, {c['hits']} hits / "
                     f"{c['misses']} misses")
    al = stats["allocator"]
    lines.append(f"  CUDA allocator: {al['reserved_bytes']}/{al['budget_bytes']} "
                 "bytes reserved")
    print("\n".join(lines), file=out)
    return stats
