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
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import plan_stages
from repro_torch.sharding import (DEFAULT_RULES, Spec, logical_to_physical,
                                  use_mesh)

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
