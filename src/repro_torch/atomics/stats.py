"""Device-side contention statistics for the RMW tiers.

Port of `repro.atomics.stats`.  A small ``ContentionStats`` tuple of device
tensors computed from the per-slot occupancy of a batch, returned alongside
results when callers opt in with ``collect_stats=``:

* ``n_ops``          — () int32, in-range ops in the batch
* ``distinct_slots`` — () int32, slots touched at least once
* ``max_occupancy``  — () int32, writers on the hottest slot
* ``occupancy_hist`` — (HIST_BINS,) int32, occupied slots bucketed by
  ``floor(log2(occupancy))`` (bucket 0 = exactly 1 writer, bucket 1 = 2-3,
  ...; the top bucket absorbs the tail)
* ``topk_slots`` / ``topk_counts`` — (TOPK,) int32, hottest slot ids and
  their occupancy; ``-1`` slot id where fewer than TOPK slots are occupied
* ``level_ops_in`` / ``level_ops_out`` — (L,) int32: ops entering each
  exchange level of the sharded tier and the combined reps leaving it
  (``L = 0`` on the local tier)
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

Tensor = torch.Tensor

HIST_BINS = 16
TOPK = 8


class ContentionStats(NamedTuple):
    """Per-batch contention observables; every field is a device tensor."""

    n_ops: Any
    distinct_slots: Any
    max_occupancy: Any
    occupancy_hist: Any
    topk_slots: Any
    topk_counts: Any
    level_ops_in: Any
    level_ops_out: Any


def occupancy_hist(occ: Tensor) -> Tensor:
    """(HIST_BINS,) histogram of occupied slots by log2(occupancy) bucket."""
    occ = occ.to(torch.int32)
    bucket = torch.log2(occ.clamp(min=1).to(torch.float32)).to(torch.int32)
    bucket = bucket.clamp(0, HIST_BINS - 1)
    # unoccupied slots route to a sacrificial bin that is cut off
    bucket = torch.where(occ > 0, bucket, HIST_BINS)
    return torch.bincount(bucket.long(), minlength=HIST_BINS + 1
                          )[:HIST_BINS].to(torch.int32)


def topk_hot(occ: Tensor, slot_ids: Optional[Tensor] = None):
    """Hottest TOPK slots of an occupancy vector: ``(slots, counts)``.

    ``slots`` are positions in ``occ``, or taken from ``slot_ids`` when
    given (an owner shard's rows as global slot ids, say).  Ties go to the
    lowest position (the reference's repeated argmax), and ``-1`` marks a
    slot whose count is zero.
    """
    occ = occ.to(torch.int32)
    k = min(TOPK, occ.shape[0])
    # stable descending sort keeps equal counts in position order
    order = torch.sort(occ, descending=True, stable=True).indices[:k]
    counts = occ[order].clamp(min=0)
    ids = order if slot_ids is None else slot_ids[order]
    slots = torch.where(counts > 0, ids.to(torch.int32), -1)
    if k < TOPK:
        pad = torch.full((TOPK - k,), -1, dtype=torch.int32, device=occ.device)
        slots = torch.cat([slots, pad])
        counts = torch.cat([counts, torch.zeros_like(pad)])
    return slots, counts


def stats_from_occupancy(occ: Tensor, n_ops) -> ContentionStats:
    """Build ``ContentionStats`` from a per-slot occupancy vector."""
    occ = occ.to(torch.int32)
    dev = occ.device
    slots, counts = topk_hot(occ)
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    return ContentionStats(
        n_ops=torch.as_tensor(n_ops, dtype=torch.int32, device=dev),
        distinct_slots=(occ > 0).sum().to(torch.int32),
        max_occupancy=(occ.max() if occ.numel()
                       else torch.zeros((), device=dev)).to(torch.int32),
        occupancy_hist=occupancy_hist(occ),
        topk_slots=slots,
        topk_counts=counts,
        level_ops_in=empty,
        level_ops_out=empty,
    )


def stats_to_fields(stats: ContentionStats, **extra: Any) -> Dict[str, Any]:
    """Convert device stats to a flat host-side dict (forces a sync)."""
    fields: Dict[str, Any] = {
        "event": "contention.stats",
        "n_ops": int(stats.n_ops),
        "distinct_slots": int(stats.distinct_slots),
        "max_occupancy": int(stats.max_occupancy),
        "occupancy_hist": stats.occupancy_hist.tolist(),
        "topk_slots": stats.topk_slots.tolist(),
        "topk_counts": stats.topk_counts.tolist(),
        "level_ops_in": stats.level_ops_in.tolist(),
        "level_ops_out": stats.level_ops_out.tolist(),
    }
    fields.update(extra)
    return fields
