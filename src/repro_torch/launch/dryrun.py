"""The dry run: every (arch x shape x mesh) cell's FLOPs, peak bytes a card
and collective bytes, with nothing allocated.

Port of `repro.launch.dryrun`.  The reference lowers and compiles each cell
for 512 placeholder devices and reads XLA's memory and cost analyses and the
post-SPMD HLO (`repro.launch.hlo_stats`).  Eager torch has neither, so the
port runs the step itself under ``FakeTensorMode`` (no memory behind any
tensor) and counts while it runs:

* ``dot_flops``: ``torch.utils.flop_counter.FlopCounterMode``, per card,
  every layer, microbatch and recomputation counted as executed.  The
  reference's parser multiplies scanned layers by their trip counts for
  the same count (and `repro.models.runtime_flags` unrolls the scans to
  check it); eager execution runs every layer, so neither has a
  counterpart here;
* ``per_device_peak_bytes``: the peak of live storage bytes (`LiveBytes`):
  each new storage's bytes added when an op makes it and taken off when it
  is freed, in eager order, which is the card's;
* ``dot_bytes`` and ``result_bytes``: the matmuls' operand and result
  bytes, and the bytes every op writes (the roofline's memory term);
* ``collectives``, ``total_wire_bytes``, ``wire_bytes_by_link`` and
  ``collective_groups``: from `launch.mesh.RecordingMesh`, the production
  mesh seen from rank 0, in `hlo_stats`' conventions (its HLO parser has
  no input in torch);
* ``model_flops_global``: 6 N_active tokens for train, 2 N_active tokens
  otherwise (`ModelConfig.active_param_count`);
* ``microbatches``, ``lower_s`` (the host seconds of the fake run) and
  ``status`` (``ok``, or the error that stopped the cell).

The model is built as the reference's dry run builds it: the plain paths
(``use_kernel=False``), ``attn_impl="chunked"``, ``remat_policy="full"``,
``loss_chunk=2048``.  Where a kernel wrapper is reached all the same (MoE's
counts go through `atomics.execute`), its fake-tensor rule answers
(`kernels.build.is_fake`): outputs of the right shape, no launch, no count.

``layout`` says how the cell runs.  ``sharded_train``: train cells run
`launch.steps.make_sharded_train_step` on the recording mesh, the state
from `abstract_train_state` laid out by `params_shardings`: the
partitioned step, each GQA attention, dense MLP and vocabulary leaf the
rules cut computed on the rank's ``"model"`` cut, the other leaves
gathered whole into the model (whose whole parameters stay placed and
counted: the step's workspace); the ``partitioned`` override False runs
the unpartitioned step on the same blocks.
``sharded_serve``: prefill and decode cells of the GQA self-attention
configs (`serve_layout`) run `make_sharded_prefill_step` /
`make_sharded_decode_step` on the recording mesh with the global batch:
the rank holds only its blocks of the parameters (from the meta model,
laid out by `params_shardings` under `arch_rules(cfg, mesh, "prefill" |
"decode")`), places the leaves the rules cut over ``"model"`` as its cut
and every other leaf whole, and its KV cache blocks by `cache_shardings`
(the sequence over ``"model"``).  A decode cell's caches are full (each
attention layer's ``len`` at ``seq_len - 1``), as the reference's jitted
step attends the whole cache; the rank attends over its segment and
combines the partials.  ``serve_whole_params``: the other configs'
prefill and decode cells (the record's ``layout_reason``: MLA's latent
cache, the Mamba state or cross-attention, each a later slice) run
`make_prefill_step` / `make_decode_step` on the rank's cut of the batch
(`batch_shardings`) with whole parameters and no mesh: no collective, and
not a sharded serving path.  ``local``
(`run_local_train`): the one-card trainer's step (`make_train_step`, the
state `train` builds), for checking a prediction against a measured peak.

The fake tensors lie on the card's device type where the build has CUDA;
a build without it cannot run autograd on a fake CUDA tensor, so there
they lie on the meta device, and `atomics.execute` prices the plain
backends there (the record's ``device`` says which).

Records are written as JSON, one a cell, under ``build/repro_torch/dryrun/``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma_2b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell, cells_for,
                                 get_config)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (RecordingMesh, block_shape,
                                     make_production_mesh, use_mesh)
from repro_torch.launch.steps import (abstract_train_state, make_decode_step,
                                      make_prefill_step,
                                      make_sharded_decode_step,
                                      make_sharded_prefill_step,
                                      make_sharded_train_step,
                                      make_train_step)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_state

OUT_DIR = os.path.join("build", "repro_torch", "dryrun")

aten = torch.ops.aten
_DEVICE = torch.ops.prim.device.default
#: matmul-family ops and the positions of their two matrix operands
_DOTS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
         aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2),
         aten.convolution.default: (0, 1)}


class InputSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def input_specs(cfg: ModelConfig, shape: ShapeCell) -> Dict[str, InputSpec]:
    """Stand-ins for every model input of the global batch."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    batch: Dict[str, InputSpec] = {}
    if cfg.embeds_input:
        batch["embeds"] = InputSpec((b, s, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = InputSpec((b, s), torch.int32)
    if shape.kind == "train":
        batch["labels"] = InputSpec((b, s), torch.int32)
    if cfg.encoder is not None:
        batch["frames"] = InputSpec((b, cfg.encoder.n_frames, cfg.d_model),
                                    torch.bfloat16)
    if cfg.pos_emb == "mrope":
        batch["positions3"] = InputSpec((3, b, s), torch.int32)
    return batch


def _moment_dtype(cfg: ModelConfig) -> str:
    return "bfloat16" if cfg.param_count() > 2e11 else "float32"


def serve_layout(cfg: ModelConfig) -> Tuple[str, Optional[str]]:
    """(layout, the reason where it is not sharded) of a config's prefill
    and decode cells: ``sharded_serve`` for GQA self-attention (dense or
    MoE), else ``serve_whole_params``."""
    if cfg.mla is not None:
        return "serve_whole_params", "MLA's latent cache (a later slice)"
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.n_layers)):
        return ("serve_whole_params", "the Mamba state, cut by heads "
                "(a later slice)")
    if cfg.encoder is not None:
        return "serve_whole_params", "cross-attention (a later slice)"
    return "sharded_serve", None


def default_microbatches(cfg: ModelConfig, shape: ShapeCell,
                         n_data: int) -> int:
    """Gradient-accumulation factor sized so the per-card saved residual
    carry (L x T_mb x d x ~6 B) stays about <= 6 GB (the reference's
    rule)."""
    if shape.kind != "train":
        return 1
    t_loc = shape.global_batch * shape.seq_len // max(n_data, 1)
    batch_loc = max(1, shape.global_batch // max(n_data, 1))
    mb = 1
    while mb < batch_loc:
        carry = cfg.n_layers * (t_loc / mb) * cfg.d_model * 6
        if carry <= 6e9:
            break
        mb *= 2
    return mb


def model_flops_global(cfg: ModelConfig, shape: ShapeCell) -> float:
    """6 N_active tokens for train (forward and backward), 2 N_active
    tokens for a forward-only prefill or decode."""
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    return mult * cfg.active_param_count() * tokens


def fake_device() -> str:
    """Where the dry run's fake tensors lie: the card's device type where
    the build has CUDA, else meta (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


class LiveBytes(TorchDispatchMode):
    """Counts, for every op run under it: the bytes of live storages
    (``live``, ``peak``; a storage counts from the op that made it until
    it is freed), the matmuls' operand and result bytes (``dot_bytes``)
    and the bytes ops write (``result_bytes``: each new storage, and each
    output of an op that writes in place).  A storage made before the
    mode was entered is not counted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self.dot_bytes = self.result_bytes = 0
        self._seen: set = set()

    def _freed(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is _DEVICE:
            return out
        mutable = func._schema.is_mutable
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                if mutable:
                    self.result_bytes += t.nbytes
                continue
            nbytes = st.nbytes()
            self._seen.add(key)
            self.live += nbytes
            self.result_bytes += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, nbytes)
        if func in _DOTS:
            a, b = _DOTS[func]
            self.dot_bytes += (args[a].nbytes + args[b].nbytes
                               + sum(t.nbytes for t in tree_flatten(out)[0]
                                     if isinstance(t, torch.Tensor)))
        return out


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _batch(specs: Dict[str, InputSpec], device, cut=None, mesh=None
           ) -> Dict[str, torch.Tensor]:
    """Fake inputs of ``specs``, or of this rank's cut of them (``cut``:
    the batch's partition specs)."""
    return {k: _empty(s.shape if cut is None
                      else block_shape(s.shape, cut[k], mesh),
                      s.dtype, device) for k, s in specs.items()}


def _build(cfg: ModelConfig, overrides: Dict[str, Any]):
    """The model as the reference's dry run builds it, on meta (under
    ``FakeTensorMode``; `_Counting.place` lays it on the device)."""
    return build_model(
        cfg, device="meta", use_kernel=False,
        attn_impl=overrides.get("attn_impl", "chunked"),
        remat_policy=overrides.get("remat_policy", "full"),
        loss_chunk=overrides.get("loss_chunk", 2048))


class _Counting:
    """``FakeTensorMode``, then `LiveBytes` and ``FlopCounterMode`` inside
    it: the cell's model is built on meta under the first, and everything
    from `place` on is counted."""

    def __init__(self):
        self.fake = FakeTensorMode(allow_non_fake_inputs=True)
        self.live = LiveBytes()
        self.flops = FlopCounterMode(display=False)

    def place(self, model, device):
        """Lay the meta model's weights on ``device`` (counted): each
        parameter and buffer replaced by an empty one there, shared ones
        once (``Module.to_empty`` cannot swap a fake tensor in place)."""
        new: Dict[int, torch.Tensor] = {}
        for mod in model.modules():
            for table in (mod._parameters, mod._buffers):
                for name, t in table.items():
                    if t is None:
                        continue
                    if id(t) not in new:
                        e = _empty(t.shape, t.dtype, device)
                        new[id(t)] = (torch.nn.Parameter(
                            e, requires_grad=t.requires_grad)
                            if isinstance(t, torch.nn.Parameter) else e)
                    table[name] = new[id(t)]
        return model


def _run(counting: _Counting, fn) -> Tuple[Any, float]:
    t0 = time.perf_counter()
    with counting.live, counting.flops:
        out = fn()
    return out, time.perf_counter() - t0


def _finish(rec: Dict[str, Any], counting: _Counting, lower_s: float,
            mesh: Optional[RecordingMesh]) -> Dict[str, Any]:
    rec["lower_s"] = round(lower_s, 2)
    rec["dot_flops"] = float(counting.flops.get_total_flops())
    rec["per_device_peak_bytes"] = int(counting.live.peak)
    rec["dot_bytes"] = float(counting.live.dot_bytes)
    rec["result_bytes"] = float(counting.live.result_bytes)
    if mesh is not None:
        rec.update(mesh.summary())
    else:
        rec.update(collectives={}, total_wire_bytes=0.0,
                   wire_bytes_by_link={}, collective_groups=[])
    return rec


def run_cell(arch: str, shape: ShapeCell, multi_pod: bool,
             overrides: Optional[Dict[str, Any]] = None, *,
             cfg: Optional[ModelConfig] = None,
             mesh_shape=None) -> Dict[str, Any]:
    """One cell's record (module docstring).  ``cfg`` (default the arch's
    full config) and ``mesh_shape`` ((shape, axis names), default the
    production mesh) are for smaller cells; ``overrides``: the reference's
    ``capacity_factor``, ``microbatches``, ``attn_impl``,
    ``remat_policy``, ``loss_chunk``, ``n_layers``, a cut of the
    depth that keeps the full config's microbatches (the record says
    ``layers_run`` of ``layers_full``), and ``partitioned`` (False: a
    train cell runs the unpartitioned step on the same blocks,
    `make_sharded_train_step`'s ``partitioned=False``)."""
    overrides = dict(overrides or {})
    cfg = cfg or get_config(arch)
    if "capacity_factor" in overrides and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(overrides["capacity_factor"])))
    dims, names = mesh_shape or make_production_mesh(multi_pod=multi_pod)
    n_data = math.prod(dims) // dict(zip(names, dims)).get("model", 1)
    overrides.setdefault("microbatches",
                         default_microbatches(cfg, shape, n_data))
    layers_full = cfg.n_layers
    if "n_layers" in overrides:
        cfg = cfg.replace(n_layers=int(overrides["n_layers"]))
    mesh = RecordingMesh(dims, names)
    device = fake_device()
    rules = sh.arch_rules(cfg, mesh, shape.kind,
                          seq_shard_carry=shape.name == "long_500k")
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": "multi" if multi_pod else "single", "chips": mesh.size(
            mesh.axis_names), "mesh_shape": dict(mesh.shape),
        "device": device, "layers_run": cfg.n_layers,
        "layers_full": layers_full,
        "rules": {k: str(v) for k, v in rules.items()},
        "overrides": {k: str(v) for k, v in overrides.items()
                      if k != "microbatches"}}
    specs = input_specs(cfg, shape)
    counting = _Counting()
    with counting.fake:
        model = _build(cfg, overrides)
        if shape.kind == "train":
            rec["layout"] = "sharded_train"
            opt_cfg = AdamWConfig(moment_dtype=_moment_dtype(cfg))
            mb = int(overrides["microbatches"])
            rec["microbatches"] = mb

            # the step and the state's layout from the abstract state,
            # uncounted: only this rank's blocks of it are made
            step = make_sharded_train_step(
                model, opt_cfg, mesh, rules, microbatches=mb,
                partitioned=bool(overrides.get("partitioned", True)))
            params_abs, opt_abs = abstract_train_state(model, opt_cfg)
            lay = {n: (block_shape(p.shape, step.specs[n], mesh), p.dtype,
                       {k: opt_abs[k][n].dtype for k in ("master", "m",
                                                         "v")})
                   for n, p in params_abs.items()}
            step_dtype = opt_abs["step"].dtype
            del params_abs, opt_abs

            def body():
                counting.place(model, device)
                params = {n: _empty(b, dt, device)
                          for n, (b, dt, _) in lay.items()}
                opt = {"step": _empty((), step_dtype, device),
                       **{k: {n: _empty(b, dts[k], device)
                              for n, (b, _, dts) in lay.items()}
                          for k in ("master", "m", "v")}}
                with use_mesh(mesh, rules):
                    return step(params, opt, _batch(specs, device))
        elif serve_layout(cfg)[0] == "sharded_serve":
            rec["layout"] = "sharded_serve"
            rec["microbatches"] = 1
            if shape.kind == "prefill":
                step = make_sharded_prefill_step(model, shape.seq_len, mesh,
                                                 rules)
            else:
                step = make_sharded_decode_step(model, mesh, rules)
            lay = {n: (block_shape(p.shape, step.specs[n], mesh), p.dtype)
                   for n, p in model.named_parameters()}
            b = shape.global_batch

            def body():
                params = {n: _empty(blk, dt, device)
                          for n, (blk, dt) in lay.items()}
                batch = _batch(specs, device)
                with use_mesh(mesh, rules):
                    if shape.kind == "prefill":
                        return step(params, batch)
                    cache = model.init_cache(
                        b, shape.seq_len, device=device, mesh=mesh,
                        specs=step.cache_specs(b, shape.seq_len))
                    for layer in cache["layers"]:
                        layer["len"] = shape.seq_len - 1
                    return step(params, cache, batch)
        else:
            rec["layout"], rec["layout_reason"] = serve_layout(cfg)
            rec["microbatches"] = 1
            cut = sh.batch_shardings(specs, mesh, rules)

            def body():
                counting.place(model, device)
                params = dict(model.named_parameters())
                batch = _batch(specs, device, cut, mesh)
                b = (batch["embeds"] if "embeds" in batch
                     else batch["tokens"]).shape[0]
                if shape.kind == "prefill":
                    return make_prefill_step(model, shape.seq_len)(params,
                                                                   batch)
                cache = model.init_cache(b, shape.seq_len)
                for layer, block in zip(cache["layers"], model.blocks):
                    if block.kind == "attn":
                        layer["len"] = shape.seq_len - 1
                if cfg.encoder is not None:
                    cache["enc_out"] = _empty(
                        (b, cfg.encoder.n_frames, cfg.d_model),
                        model.dtype, device)
                return make_decode_step(model)(params, cache, batch)
        out, lower_s = _run(counting, body)
        del out
    rec["model_flops_global"] = model_flops_global(cfg, shape)
    return _finish(rec, counting, lower_s,
                   mesh if rec["layout"] != "serve_whole_params" else None)


def run_local_train(cfg: ModelConfig, seq_len: int, global_batch: int, *,
                    remat_policy: str = "none",
                    arch: str = "") -> Dict[str, Any]:
    """The one-card trainer's step (`launch.train.train`'s: the model's
    own parameters, AdamW's state from `init_state`, `make_train_step`) on
    a fake batch of ``global_batch`` x ``seq_len``: its record, layout
    ``local``."""
    device = fake_device()
    shape = ShapeCell(f"train_{global_batch}x{seq_len}", seq_len,
                      global_batch, "train")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name, "mesh": "local",
                           "chips": 1, "device": device, "layout": "local",
                           "microbatches": 1,
                           "overrides": {"remat_policy": remat_policy}}
    specs = input_specs(cfg, shape)
    counting = _Counting()
    with counting.fake:
        model = _build(cfg, {"remat_policy": remat_policy})

        def body():
            counting.place(model, device)
            opt_cfg = AdamWConfig()
            params = dict(model.named_parameters())
            step = make_train_step(model, opt_cfg)
            return step(params, init_state(params, opt_cfg),
                        _batch(specs, device))
        out, lower_s = _run(counting, body)
        del out
    rec["model_flops_global"] = model_flops_global(cfg, shape)
    return _finish(rec, counting, lower_s, None)


def record_path(out_dir: str, arch: str, shape: str, mesh: str,
                tag: str = "baseline") -> str:
    return os.path.join(out_dir, f"{arch}.{shape}.{mesh}.{tag}.json")


def run_and_write(arch: str, cell: ShapeCell, multi: bool, out_dir: str,
                  tag: str = "baseline",
                  overrides: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """`run_cell`, its record written to ``out_dir`` with ``status`` ok or
    the error that stopped it."""
    mesh_name = "multi" if multi else "single"
    try:
        rec = run_cell(arch, cell, multi, overrides)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a record too
        rec = {"arch": arch, "shape": cell.name, "mesh": mesh_name,
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    os.makedirs(out_dir, exist_ok=True)
    with open(record_path(out_dir, arch, cell.name, mesh_name, tag),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of overrides")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else {}
    if args.all:
        todo = [(a, s) for a in ARCH_IDS for s in cells_for(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        todo = [(args.arch, next(s for s in SHAPES if s.name == args.shape))]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch, cell in todo:
        for multi in meshes:
            name = f"{arch}.{cell.name}.{'multi' if multi else 'single'}"
            path = record_path(args.out, arch, cell.name,
                               "multi" if multi else "single", args.tag)
            if os.path.exists(path):
                print(f"[skip] {name} (exists)", flush=True)
                continue
            print(f"[run ] {name}", flush=True)
            rec = run_and_write(arch, cell, multi, args.out, args.tag,
                                overrides)
            if rec["status"] == "ok":
                print(f"[ ok ] {name} lower={rec['lower_s']}s "
                      f"flops={rec['dot_flops']:.3g} "
                      f"peakB={rec['per_device_peak_bytes']:.3g} "
                      f"wireB={rec['total_wire_bytes']:.3g}", flush=True)
            else:
                n_fail += 1
                print(f"[FAIL] {name}: {rec['error']}", flush=True)
    print(f"done; failures={n_fail}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
