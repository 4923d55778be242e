"""Plain PyTorch oracles for the combining-RMW kernels.

Port of `repro.kernels.rmw.ref`.  Semantics contract (shared with
`kernels/rmw/kernel.py` and `csrc/rmw.cu`): given a 1-D ``table`` and
``indices``/``values`` batches, return the table after applying the whole
batch with the selected combiner:

  faa — table[i] += sum of colliding values            (order-free)
  min/max — combine with minimum / maximum             (order-free)
  swp — last collider (by batch position) wins         (order-dependent)

Indices outside ``[0, table size)`` are dropped.

`rmw_table_fetched_ref` is the serialized oracle for the fetched-value/CAS
outputs: op-at-a-time in batch order, dropped ops observing fetched = 0 /
success = False.  It is a host loop, for the tests only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def rmw_table_ref(table: Tensor, indices: Tensor, values: Tensor,
                  op: str) -> Tensor:
    m = table.shape[0]
    if op not in ("faa", "min", "max", "swp"):
        raise ValueError(f"unknown op {op!r}")
    if indices.shape[0] == 0:
        return table.clone()
    values = values.to(table.dtype)
    idx = indices.long()
    valid = (idx >= 0) & (idx < m)
    # dropped ops land on a scratch row past the table
    slot = torch.where(valid, idx, m)
    padded = torch.cat([table, table.new_zeros(1)])
    if op == "faa":
        return padded.index_add_(0, slot, values)[:m]
    if op in ("min", "max"):
        return padded.scatter_reduce_(
            0, slot, values, reduce="amin" if op == "min" else "amax")[:m]
    # swp — last-wins: the highest batch position per slot
    pos = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    last = torch.full((m + 1,), -1, dtype=torch.int32, device=idx.device)
    last.scatter_reduce_(0, slot, pos, reduce="amax")
    last = last[:m]
    return torch.where(last >= 0, values[last.clamp(min=0).long()], table)


def rmw_table_fetched_ref(table: Tensor, indices: Tensor, values: Tensor,
                          op: str, expected=None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Order-faithful (table, fetched, success) with drop semantics.

    Matches `core.rmw.rmw_serialized` for in-range ops; indices outside
    [0, table size) are skipped entirely (fetched 0, success False).
    """
    if op not in ("faa", "swp", "min", "max", "cas"):
        raise ValueError(f"unknown op {op!r}")
    tab = table.detach().cpu().numpy().copy()
    dt = tab.dtype
    m = tab.shape[0]
    idx = indices.detach().cpu().numpy().astype(np.int64)
    val = values.detach().cpu().numpy().astype(dt)
    e = np.asarray(0 if expected is None else
                   (expected.item() if isinstance(expected, Tensor)
                    else expected)).astype(dt)
    n = idx.shape[0]
    fetched = np.zeros((n,), dt)
    success = np.zeros((n,), bool)
    with np.errstate(over="ignore"):
        for k in range(n):
            i = int(idx[k])
            if not 0 <= i < m:
                continue
            old = tab[i]
            v = val[k]
            ok = True
            if op == "faa":
                new = old + v
            elif op == "swp":
                new = v
            elif op == "min":
                new = np.minimum(old, v)
            elif op == "max":
                new = np.maximum(old, v)
            else:  # cas
                ok = bool(old == e)
                new = v if ok else old
            tab[i] = new
            fetched[k] = old
            success[k] = ok
    dev = table.device
    return (torch.from_numpy(tab).to(dev), torch.from_numpy(fetched).to(dev),
            torch.from_numpy(success).to(dev))


def histogram_ref(indices: Tensor, num_bins: int) -> Tensor:
    """FAA special case: the expert-load histogram MoE routing needs."""
    return rmw_table_ref(
        torch.zeros((num_bins,), dtype=torch.float32, device=indices.device),
        indices, torch.ones(indices.shape, dtype=torch.float32,
                            device=indices.device), "faa")
