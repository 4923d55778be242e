"""Parameter / batch / cache / optimizer-state partition specs (logical
axes -> mesh).

Port of `repro.launch.shardings`.  Every parameter leaf gets logical axis
names from its name; the mapping logical -> physical is divisibility-aware
(`repro_torch.sharding`), which implements the per-arch TP policy: gemma's
one KV head on a 2-way model axis stays whole while its 16384-wide d_ff
shards.  Each function returns a partition spec (`repro_torch.sharding`'s
tuples) per leaf of the port's trees: a name-keyed dict for parameters
(`LM.named_parameters()`'s names) and AdamW's ``{"step", "master", "m",
"v"}`` over it.

The reference stacks each stage's layers on a leading "layers" axis
(`DEFAULT_RULES["layers"]` is None); the port keeps one module per layer.
So the port's spec for a layer's leaf is the reference's spec for the
stacked leaf with its leading entry removed (`convert.name_map` relates
the two names): the names are resolved against the stacked shape, as the
reference resolves them, and the stacking entry is then dropped.

`model_cuts` says, for each leaf, whether the sharded train and serving
steps compute on its ``"model"`` cut (the reference's partitioned step),
hold it whole with a partial gradient, or gather it whole.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import plan_stages
from repro_torch.sharding import (DEFAULT_RULES, Spec, logical_to_physical,
                                  model_dim, use_mesh)

# logical axes per param name (applied to the trailing dims; stacked stage
# params get a leading "layers"=None axis automatically)
_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "lm_head": ("vocab", "embed"),
    "pos_embed": (None, "embed"),
    "enc_pos": (None, "embed"),
    # attention
    "wq": ("fsdp", "qkv"),
    "wk": ("fsdp", "kv_qkv"),
    "wv": ("fsdp", "kv_qkv"),
    "wo": ("qkv", "fsdp"),
    "bq": ("qkv",), "bk": ("kv_qkv",), "bv": ("kv_qkv",),
    # MLA
    "wq_a": ("fsdp", None),
    "wq_b": (None, "qkv"),
    "wkv_a": ("fsdp", None),
    "wkv_b": (None, "qkv"),
    # MLP
    "w1": ("fsdp", "ffn"),
    "w3": ("fsdp", "ffn"),
    "w2": ("ffn", "fsdp"),
    "b1": ("ffn",), "b2": (None,),
    # MoE (leading experts dim; shard_map expects P("model", fsdp, None))
    "router": ("fsdp", None),
    # mamba
    "in_proj": ("fsdp", "ffn"),
    "out_proj": ("ffn", "fsdp"),
    "conv_w": (None, None), "conv_b": (None,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,), "norm_w": (None,),
    # norms
    "w": (None,), "b": (None,),
}

_MOE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "w1": ("experts", "fsdp", None),
    "w3": ("experts", "fsdp", None),
    "w2": ("experts", "fsdp", None),
}


def _leaf_axes(names: List[str], ndim: int) -> Tuple[Optional[str], ...]:
    """Logical names of a leaf of the reference's layout: ``names`` are
    its path's keys without the list indices (``["stages", "attn",
    "wq"]``), ``ndim`` its rank there (the stacking axis included)."""
    name = names[-1] if names else None
    in_moe = "moe" in names
    in_stages = any(n in ("stages", "enc_stages") for n in names)
    if in_moe and name in _MOE_AXES:
        axes = _MOE_AXES[name]
    elif name in _PARAM_AXES:
        axes = _PARAM_AXES[name]
    else:
        axes = (None,) * ndim
    lead = ndim - len(axes)
    if in_stages and lead >= 1:
        axes = ("layers",) * lead + axes
    elif lead > 0:
        axes = (None,) * lead + axes
    if len(axes) != ndim:
        axes = (None,) * ndim
    return axes


def arch_rules(cfg: ModelConfig, mesh, shape_kind: str = "train",
               seq_shard_carry: bool = False) -> Dict[str, Any]:
    """Per-(arch, shape) logical->physical rules."""
    rules = dict(DEFAULT_RULES)
    tp = mesh.shape.get("model", 1)
    # attention TP only when head counts divide (replicated otherwise)
    if cfg.n_heads % max(tp, 1) != 0:
        rules["qkv"] = None
    if cfg.n_kv_heads % max(tp, 1) != 0:
        rules["kv_qkv"] = None
    else:
        rules["kv_qkv"] = "model"
    if cfg.mla is not None:
        # MLA q/kv up-projections are (lora, H*dim): shard over heads dim
        rules["qkv"] = "model" if cfg.n_heads % max(tp, 1) == 0 else None
    if shape_kind in ("decode", "prefill"):
        # none of the assigned archs' kv-head counts divide a 16-way model
        # axis, so the cache's big axis is SEQUENCE: shard it over model
        rules["kv_seq"] = "model"
    if shape_kind == "decode" and seq_shard_carry:
        # long-context (batch=1): data is idle too — put it on the sequence
        rules["kv_seq"] = ("data", "model")
        rules["batch"] = None
    return rules


def _stage_repeats(cfg: ModelConfig) -> List[int]:
    """The repeat count of the stage each decoder block belongs to, in the
    port's block order."""
    return [reps for sigs, reps in plan_stages(cfg)
            for _ in range(reps * len(sigs))]


def _reference_leaf(name: str, cfg: ModelConfig, reps: List[int]
                    ) -> Tuple[List[str], Optional[int]]:
    """(the reference path's keys without list indices, the stage's repeat
    count, or None where the leaf is not stacked) of a port parameter."""
    head, _, rest = name.partition(".")
    if head == "blocks":
        layer, _, rest = rest.partition(".")
        return ["stages", *rest.split(".")], reps[int(layer)]
    if head == "enc_blocks":
        _, _, rest = rest.partition(".")
        return ["enc_stages", *rest.split(".")], cfg.encoder.n_layers
    return name.split("."), None


def params_shardings(cfg: ModelConfig, params: Mapping[str, Any], mesh,
                     rules: Dict[str, Any]) -> Dict[str, Spec]:
    """{parameter name: partition spec} for a name-keyed dict of tensors
    (anything with ``.shape``; meta tensors do)."""
    reps = _stage_repeats(cfg)
    out = {}
    with use_mesh(mesh, rules):
        for name, leaf in params.items():
            shape = tuple(leaf.shape)
            keys, stacked = _reference_leaf(name, cfg, reps)
            if stacked is not None:
                shape = (stacked, *shape)
            spec = logical_to_physical(_leaf_axes(keys, len(shape)), shape)
            out[name] = spec[1:] if stacked is not None else spec
    return out


class ModelCut(NamedTuple):
    """How the sharded train and serving steps compute with a leaf along
    ``"model"`` (`model_cuts`): ``mode`` "cut" (its module computes on
    the rank's ``"model"`` cut, dim ``dim`` of the leaf), "partial"
    (whole along ``"model"`` inside a module that computes on the cut, so
    each rank's gradient is a part of the whole) or "whole" (gathered
    whole, its module computing whole on every rank)."""

    dim: Optional[int]
    mode: str


#: the leaves of each module that computes on its "model" cut, and the
#: dim "model" cuts: the column products' columns, the row products' rows
_MLP_CUT = {"w1": 1, "w3": 1, "b1": 0, "w2": 0}
_Q_CUT = {"wq": 1, "bq": 0, "wo": 0}
_KV_CUT = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}
_MLA_CUT = {"wq_b": 1, "wkv_b": 1, "wo": 0}
_VOCAB_CUT = {"embed": 0, "lm_head": 0}
_SSM_CUT = {"in_proj": 1, "out_proj": 0}
#: a Mamba-2 mixer's leaves whose specs keep them whole: each rank
#: computes on its heads' slice of them (`models.mamba`)
_SSM_WHOLE = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w")


def model_cuts(cfg: ModelConfig, specs: Mapping[str, Spec], mesh
               ) -> Dict[str, ModelCut]:
    """{parameter name: `ModelCut`} for `params_shardings`' ``specs`` on
    ``mesh``: which leaves the sharded steps compute on their ``"model"``
    cut, as the reference's partitioned step does.

    A GQA attention layer (``attn``, no MLA) and a decoder block's
    cross-attention (``cross``) compute on the cut where the query heads
    divide over ``"model"`` and ``wq`` / ``bq`` / ``wo`` are cut on their
    head dims (the reference's divisibility rule: gemma_2b's 8 heads stay
    whole on a 16-way axis); the kv leaves are then cut where the kv heads
    divide too, else "partial" (one kv head always stays whole).  An MLA
    layer computes on the cut where its heads divide and ``wq_b`` /
    ``wkv_b`` are cut on their columns (whole heads) and ``wo`` on its
    rows; its down-projections ``wq_a`` / ``wkv_a`` and norms stay
    "whole": their outputs reach the cut products through
    `launch.mesh.sum_grad`, so their gradients are whole on every rank.
    A dense MLP (``mlp``) computes on the cut where ``w1`` / ``w3`` /
    ``b1`` are cut on their columns and ``w2`` on its rows; ``b2`` is
    added after the sum, "whole".  ``embed`` and ``lm_head`` are cut where
    the vocabulary is.

    A Mamba-2 mixer (``ssm``) computes on the rank's heads where they
    divide over ``"model"``, ``out_proj`` is cut on its rows (its
    contiguous row block is the rank's heads) and ``in_proj`` on its
    columns: both "cut" (the step keeps ``in_proj``'s contiguous block,
    which does not fall on head boundaries, and the mixer takes its
    heads' columns from the gathered whole); the leaves whose specs keep
    them whole (``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
    ``norm_w``) "partial": each rank uses its heads' slice of them.

    Everything else is "whole": MoE leaves (the steps keep expert blocks
    apart), norms, learned positions, attention whose heads do not
    divide."""
    tp = mesh.shape.get("model", 1)
    out = {n: ModelCut(None, "whole") for n in specs}
    if tp <= 1:
        return out
    modules: Dict[str, Dict[str, Spec]] = {}
    for name, spec in specs.items():
        head, _, key = name.rpartition(".")
        modules.setdefault(head, {})[key] = spec

    def cut(leaves, dims) -> bool:
        named = [k for k in dims if k in leaves]
        return bool(named) and all(model_dim(leaves[k]) == dims[k]
                                   for k in named)

    def mark(head, dims, mode="cut"):
        for key in dims:
            if key in modules[head]:
                name = f"{head}.{key}" if head else key
                out[name] = ModelCut(dims[key] if mode == "cut" else None,
                                     mode)

    for head, leaves in modules.items():
        kind = head.rpartition(".")[2]
        if kind == "mlp" and cut(leaves, _MLP_CUT):
            mark(head, _MLP_CUT)
        elif kind == "attn" and cfg.mla is not None \
                and cfg.n_heads % tp == 0 and cut(leaves, _MLA_CUT):
            mark(head, _MLA_CUT)
        elif (kind == "cross" or kind == "attn" and cfg.mla is None) \
                and cfg.n_heads % tp == 0 and cut(leaves, _Q_CUT):
            mark(head, _Q_CUT)
            kv = cfg.n_kv_heads % tp == 0 and cut(leaves, _KV_CUT)
            mark(head, _KV_CUT, "cut" if kv else "partial")
        elif kind == "ssm" and cfg.ssm.n_heads(cfg.d_model) % tp == 0 \
                and cut(leaves, _SSM_CUT):
            mark(head, _SSM_CUT)
            mark(head, dict.fromkeys(_SSM_WHOLE), "partial")
        elif head == "":
            for key in _VOCAB_CUT:
                if key in leaves and cut(leaves, {key: _VOCAB_CUT[key]}):
                    mark(head, {key: _VOCAB_CUT[key]})
    return out


def batch_shardings(batch: Mapping[str, Any], mesh, rules: Dict[str, Any]
                    ) -> Dict[str, Spec]:
    """{key: partition spec}: the batch axis over "batch" (axis 1 of
    ``positions3``, (3, B, S))."""
    out = {}
    with use_mesh(mesh, rules):
        for name, leaf in batch.items():
            if name == "positions3":
                axes = (None, "batch", None)
            elif leaf.ndim == 2:
                axes = ("batch", None)
            else:
                axes = ("batch",) + (None,) * (leaf.ndim - 1)
            out[name] = logical_to_physical(axes, tuple(leaf.shape))
    return out


_CACHE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # stacked over the stage's repeat dim ("layers") by stage_cache
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "ckv": ("layers", "batch", "kv_seq", None),
    "krope": ("layers", "batch", "kv_seq", None),
    "ssm": ("layers", "batch", "heads", None, None),
    "conv": ("layers", "batch", None, None),
    "len": ("layers",),
    "enc_out": ("batch", None, None),
}


def cache_shardings(cache: Dict[str, Any], mesh, rules: Dict[str, Any]
                    ) -> Dict[str, Any]:
    """`LM.init_cache`'s structure ({"layers": [one dict per layer],
    "enc_out"}) with a partition spec at every leaf: a layer's leaf takes
    the reference's spec for the stacked leaf without its "layers" entry;
    a leaf that is no tensor (``len``) or None gets ()."""
    def one(key: str, leaf, stacked: bool) -> Spec:
        if not hasattr(leaf, "ndim"):
            return ()
        ndim = leaf.ndim + stacked
        axes = _CACHE_AXES.get(key, (None,) * ndim)
        if len(axes) != ndim:
            axes = (None,) * ndim
        return logical_to_physical(axes[stacked:], tuple(leaf.shape))

    with use_mesh(mesh, rules):
        return {"layers": [{k: one(k, x, True) for k, x in layer.items()}
                           for layer in cache["layers"]],
                "enc_out": one("enc_out", cache.get("enc_out"), False)}


def opt_state_shardings(params_specs: Mapping[str, Spec]
                        ) -> Dict[str, Any]:
    """m / v / master inherit the parameters' specs; step is replicated."""
    return {"step": (), "master": dict(params_specs),
            "m": dict(params_specs), "v": dict(params_specs)}
