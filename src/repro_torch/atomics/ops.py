"""Typed RMW op constructors — the declarative half of the atomics API.

Port of `repro.atomics.ops`.  Each class is one *batch* of same-kind ops:
``indices[i]`` names the table slot the i-th op targets and ``values[i]``
its operand.  Semantics (all serialized-equivalent, in batch order):

``Faa``   fetched = old, slot += value
``Swp``   fetched = old, slot = value
``Min``   fetched = old, slot = min(old, value)
``Max``   fetched = old, slot = max(old, value)
``Cas``   fetched = old; slot = value iff old == expected (success), else
          unchanged (failure).  ``expected`` is either one shared scalar
          (the combinable form: BFS set-if-unvisited) or a per-op tensor
          (the paper's "wasted work" case, which executes on the serialized
          oracle).
"""

from __future__ import annotations

from typing import ClassVar, Optional

import torch

Tensor = torch.Tensor


def _as_1d(name: str, x) -> Tensor:
    x = torch.as_tensor(x)
    if x.dim() != 1:
        raise ValueError(f"{name} must be 1-D, got shape {tuple(x.shape)}")
    return x


class AtomicOp:
    """Base class: one batch of same-kind RMW ops against one table."""

    kind: ClassVar[str] = ""
    __slots__ = ("indices", "values")

    def __init__(self, indices, values):
        self.indices = _as_1d("indices", indices)
        self.values = _as_1d("values", values)
        if self.indices.shape[0] != self.values.shape[0]:
            raise ValueError(
                f"indices and values disagree on batch size: "
                f"{self.indices.shape[0]} vs {self.values.shape[0]}")

    def __repr__(self):
        return (f"{type(self).__name__}(n={self.indices.shape[0]}, "
                f"dtype={self.values.dtype})")

    @property
    def expected(self) -> Optional[Tensor]:
        return None

    @property
    def uniform_expected(self) -> bool:
        """True when the op batch is combinable (non-CAS, scalar expected)."""
        return True


class Faa(AtomicOp):
    """Fetch-and-add: slot += value, fetched = pre-op value."""

    kind: ClassVar[str] = "faa"
    __slots__ = ()


class Swp(AtomicOp):
    """Swap: slot = value, fetched = pre-op value (last collider wins)."""

    kind: ClassVar[str] = "swp"
    __slots__ = ()


class Min(AtomicOp):
    """Atomic min: slot = min(slot, value), fetched = pre-op value."""

    kind: ClassVar[str] = "min"
    __slots__ = ()


class Max(AtomicOp):
    """Atomic max: slot = max(slot, value), fetched = pre-op value."""

    kind: ClassVar[str] = "max"
    __slots__ = ()


class Cas(AtomicOp):
    """Compare-and-swap: slot = value iff slot == expected.

    ``expected`` may be a scalar (one shared expected value — the combinable
    first-wins form every backend supports) or a per-op 1-D tensor of the
    same length as ``values`` (serialized-oracle semantics).
    """

    kind: ClassVar[str] = "cas"
    __slots__ = ("_expected",)

    def __init__(self, indices, values, *, expected):
        super().__init__(indices, values)
        if expected is None:
            raise ValueError("Cas requires `expected`")
        exp = torch.as_tensor(expected)
        if exp.dim() not in (0, 1):
            raise ValueError(
                f"expected must be a scalar or 1-D, got shape "
                f"{tuple(exp.shape)}")
        if exp.dim() == 1 and exp.shape[0] != self.values.shape[0]:
            raise ValueError(
                f"per-op expected disagrees with batch size: "
                f"{exp.shape[0]} vs {self.values.shape[0]}")
        self._expected = exp

    @property
    def expected(self) -> Tensor:
        return self._expected

    @property
    def uniform_expected(self) -> bool:
        return self._expected.dim() == 0


#: canonical op-kind -> constructor map.  ``Cas`` takes its extra
#: ``expected=`` keyword; the rest are (indices, values).
OP_KINDS = {"faa": Faa, "swp": Swp, "min": Min, "max": Max, "cas": Cas}
