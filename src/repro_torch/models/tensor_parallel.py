"""Tensor-parallel compute along ``"model"`` in the sharded train and
serving steps.

The reference jits its train step with every weight placed by its
partition spec, so each rank along ``"model"`` multiplies only its
columns of ``wq`` / ``wk`` / ``wv`` / ``w1`` / ``w3`` and its rows of
``wo`` / ``w2``, and holds only its slice of the vocabulary.  The port's
sharded train step (`launch.steps.make_sharded_train_step`) selects the
same with `cuts`: each parameter whose module computes on its ``"model"``
cut (`launch.shardings.model_cuts`) maps to the rank's block of it,
gathered over the batch's axes and kept cut over ``"model"``.  The modules
read their leaves through `block` and `mesh_of`:

* `layers.mlp_apply`: the column products on ``w1`` / ``w3`` (and ``b1``),
  the row product on ``w2``, its output summed over ``"model"`` before
  ``b2`` is added once;
* `attention.gqa_forward`: the rank's query heads, beside its cut of the
  kv heads or the kv heads those query heads use;
* `attention.mla_forward`: the rank's heads' columns of ``wq_b`` and
  ``wkv_b`` (each head's latent expansion) and rows of ``wo``, the
  down-projections and norms whole on every rank;
* `attention.cross_attn_forward`: the rank's heads of ``wq`` / ``wk`` /
  ``wv`` over the encoder's output, ``wo`` a row product;
* `mamba.Mamba2.forward`: the rank's heads, ``in_proj``'s columns of
  them taken from its block at use (training) or placed (serving), the
  gated norm's sum of squares all-reduced, ``out_proj`` a row product;
* `model.LM._embed_in` and `LM.loss`: the vocab-parallel lookup and
  cross-entropy (`layers.embed_lookup`, `layers.chunked_softmax_xent`);
  `LM._logits`, the vocabulary slice's logits all-gathered.

The sharded serving steps (`launch.steps.make_sharded_prefill_step`,
`make_sharded_decode_step`) place those leaves as the rank's cut in the
model itself and select each leaf as its own block, with the batch's
axes, under which `models.moe.moe_ffn` gathers its input for the
expert-parallel layer (`batch_axes`); the same products run under
``torch.no_grad``.

A column product's input goes through `launch.mesh.sum_grad` (the
identity, its gradient summed over ``"model"``: Megatron's *f*), a row
product's output through `launch.mesh.all_reduce_grad` over ``"model"``
with no gradient axes (summed, its gradient the identity: Megatron's
*g*).  So does every other activation each rank reads for its heads
only: MLA's rotated shared key ``krope``; cross-attention's encoder
output, once for both its products.  Outside `cuts` (the local paths)
and for every leaf it does not name (MoE leaves, MLA's
down-projections, norms, and the "partial" leaves the step gathers
whole) a leaf is the module's own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Tuple

import torch

Tensor = torch.Tensor

_state = threading.local()


@contextlib.contextmanager
def cuts(mesh, blocks: Dict[int, Tensor], batch_axes: Tuple[str, ...] = ()):
    """Select the tensor-parallel products for the block: ``blocks`` maps
    ``id(parameter)`` to this rank's block of it on ``mesh`` (cut over
    ``"model"``, whole along the other axes); ``batch_axes``, the axes
    the activations' batch is cut over (serving)."""
    with restored((mesh, dict(blocks), tuple(batch_axes)) if blocks
                  else None):
        yield


def state():
    """The selection `cuts` put in force (None outside it), for a
    recomputation in backward to install again (`restored`)."""
    return getattr(_state, "selection", None)


@contextlib.contextmanager
def restored(selection):
    """Put ``selection`` (a `state`) in force for the block."""
    prev = getattr(_state, "selection", None)
    _state.selection = selection
    try:
        yield
    finally:
        _state.selection = prev


def block(p: Tensor) -> Tensor:
    """This rank's block of parameter ``p`` where `cuts` selected one,
    else ``p``."""
    sel = getattr(_state, "selection", None)
    return p if sel is None else sel[1].get(id(p), p)


def mesh_of(p: Tensor):
    """The mesh where `cuts` selected a block of ``p``, else None."""
    sel = getattr(_state, "selection", None)
    return sel[0] if sel is not None and id(p) in sel[1] else None


def batch_axes() -> Tuple[str, ...]:
    """The batch's axes `cuts` was given (() outside it)."""
    sel = getattr(_state, "selection", None)
    return sel[2] if sel is not None else ()
