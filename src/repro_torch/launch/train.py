"""The trainer: --arch selectable, fault-tolerant, resumable.

Port of `repro.launch.train`.  It runs real steps on one device (the card
unless asked for the CPU): the model on its plain paths (the kernels have
no backward), AdamW with f32 master weights, the deterministic data
pipeline, the async checkpointer and the recovery loop, with a state
*factory*, since the step updates its state in place (the reference's
donation).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --steps 8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma_2b \\
        --steps 8 --ckpt-dir CKPT --chaos "seed=3,step=1.0@2,ckpt_save=1.0@1"

Replay is exact: the data are a pure function of (seed, step), and a run
is made deterministic (``torch.use_deterministic_algorithms`` and
``CUBLAS_WORKSPACE_CONFIG``) unless ``deterministic=False``.  On the card
some backward ops otherwise add in atomic order (the embedding gradient,
the gathers' backward), and a replayed step would not be bit-equal.

Telemetry: each step is a ``train.step`` span (its wall seconds land in
the event stream when it is on) inside a ``train.step/<i>`` profiler range
when annotations are on.  The CLI's ``--telemetry ring|PATH`` (or
``REPRO_TELEMETRY``) turns the stream on, ``--profile-annotations`` the
ranges; render a JSONL capture with ``python -m
repro_torch.telemetry.report PATH``.

Tuning: ``tuning=`` (or ``--tuning [STATE]``, or ``REPRO_TUNING``) runs
the steps under a `repro_torch.tuning.SpecController` on the trainer's
device, stepped once per training step and stopped when `train` returns;
the spec steers dispatch selection only, so losses and gradient norms are
bit-equal to an untuned run.

Sharded training: ``mesh=`` (a `launch.mesh.Mesh`; every rank of a
`launch.ranks` world calls `train` alike) runs the step of
`launch.steps.make_sharded_train_step` under ``rules`` (default
`launch.shardings.arch_rules(cfg, mesh, "train")`): each rank holds its
blocks of the parameters, master weights and moments
(`params_shardings` / `opt_state_shardings`), gathers the whole
parameters for the forward and backward, and takes its cut of each global
batch (`batch_shardings`).  The model computes on whole leaves (no tensor-
parallel compute): ranks along axes the batch is not split on compute the
same cut, and must get the same bits of it, so a mesh needs
``deterministic``.  A save gathers every leaf and rank 0 writes the
reference's format; a restore places each rank's blocks
(`runtime.elastic.placement`), whatever mesh wrote the checkpoint.  A
config with MoE layers, or a mesh with an axis the rules do not name,
raises `NotImplementedError`: the MoE layer under a mesh takes the global
tokens on every rank and has no backward through the mesh's collectives
(ROADMAP queue 1, "sharded MoE training").

    PYTHONPATH=src python -c "from repro_torch.launch import ranks; \
        print(ranks.launch('repro_torch.launch.train:train_on_mesh', 4, \
        mesh=((2, 2), ('data', 'model')), device='cpu', \
        args=('gemma_2b', dict(steps=8, device='cpu')))[0])"
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.checkpoint.ckpt import AsyncCheckpointer
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import (DataConfig, batch_kwargs_for,
                                       synthetic_batch)
from repro_torch.launch.mesh import gather_full, shard_of, use_mesh
from repro_torch.launch.shardings import arch_rules
from repro_torch.launch.steps import (make_sharded_train_step,
                                      make_train_step)
from repro_torch.models.model import build_model
from repro_torch.models.transformer import layer_sigs
from repro_torch.optim.adamw import AdamWConfig, init_state
from repro_torch.runtime import elastic
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fault_tolerance import (FaultConfig,
                                                 StragglerMonitor,
                                                 declare_donation,
                                                 run_with_recovery)
from repro_torch.sharding import rule_axes

log = logging.getLogger("repro_torch.train")

SHARDED_MOE = "sharded MoE training (ROADMAP queue 1)"


@contextlib.contextmanager
def deterministic_algorithms(on: bool):
    """Deterministic kernels for the block (ops without one warn), with the
    cuBLAS workspace setting they need; the previous mode is restored."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def train(arch: str, *, steps: int = 100, seq_len: int = 256,
          global_batch: int = 8, reduced: bool = True,
          ckpt_dir: Optional[str] = None, checkpoint_every: int = 50,
          mesh=None, rules: Optional[Dict] = None, lr: float = 3e-4,
          microbatches: int = 1, log_every: int = 10,
          failure_injector=None, seed: int = 0,
          remat_policy: str = "none",
          chaos: Optional[FaultPlan] = None, tuning=None,
          device="cuda", deterministic: bool = True) -> Dict[str, Any]:
    """Returns the final metrics dict: ``history`` (the logged steps'
    loss, lr, grad_norm and host seconds), ``steps_done``, ``failures``,
    ``backoff_total_s`` and ``final_loss``.  Deterministic given (arch,
    seed, steps), also under an injected fault schedule (``chaos``, or the
    ``REPRO_CHAOS`` env hook when None): recovery restores the latest
    *valid* checkpoint and replays, so the final state is bit-equal to a
    fault-free run.  ``device="cuda"`` needs a card: it does not fall back
    to the CPU.

    ``tuning``: a `repro_torch.tuning.SpecController` (started or not),
    True for a default one on ``device``, or None to consult the
    ``REPRO_TUNING`` env hook.  The controller is stepped once per
    training step and stopped on exit; the result then carries its
    ``stats()`` under ``"tuning"`` (under a mesh, a controller built here
    is given it).

    ``mesh``: sharded training (module docstring), every rank of the
    mesh's world calling `train` with the same arguments; each returns
    the same metrics.  It needs ``deterministic`` (the ranks along axes
    the batch is not split on must compute the same gradient bits)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train(device='cuda') needs a CUDA card; pass "
                           "device='cpu' to train on the CPU")
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if mesh is not None:
        rules = _mesh_rules(cfg, mesh, rules)
        if not deterministic:
            raise ValueError(
                "train(mesh=...) needs deterministic=True: ranks that "
                "compute the same batch cut must get the same gradient "
                "bits, or the copies of a block they share drift apart")
    elif rules is not None:
        raise ValueError("train(rules=...) needs a mesh")
    model = build_model(cfg, device=device, seed=seed, use_kernel=False,
                        attn_impl="chunked", remat_policy=remat_policy,
                        loss_chunk=2048)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                          total_steps=steps)
    data_cfg = DataConfig(seq_len=seq_len, global_batch=global_batch,
                          vocab_size=cfg.vocab_size, seed=seed)
    bkw = batch_kwargs_for(cfg)
    if mesh is None:
        step_fn = make_train_step(model, opt_cfg, microbatches=microbatches)
    else:
        if device.type == "cuda":
            mesh.probe(device)       # what gloo refuses goes through the host
        step_fn = make_sharded_train_step(model, opt_cfg, mesh, rules,
                                          microbatches=microbatches)

    def blocks(params):
        """Under a mesh, this rank's blocks of the whole parameters."""
        if mesh is None:
            return params
        return {n: shard_of(p.detach(), step_fn.specs[n], mesh)
                for n, p in params.items()}

    # the step updates its state in place, so a post-failure restart from
    # scratch must rebuild state: the first call hands out the model's own
    # parameters, later ones redraw them from the same seed
    first_init = [True]

    def fresh_state():
        if first_init:
            first_init.pop()
        else:
            fresh = build_model(cfg, device=device, seed=seed,
                                use_kernel=False)
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(dict(fresh.named_parameters())[name])
            del fresh
        params = blocks(dict(model.named_parameters()))
        return params, init_state(params, opt_cfg)

    saver = AsyncCheckpointer(ckpt_dir, keep=3) if ckpt_dir else None
    monitor = StragglerMonitor(n_hosts=1, cfg=FaultConfig())
    history = []
    live = {}

    def one_step(step: int, state):
        params, opt_state = state
        batch = synthetic_batch(data_cfg, step, device=device, **bkw)
        t0 = time.time()
        # the span is the per-step profiler hook: wall_s lands in the event
        # stream, and under enable(annotate=True) the step is a named range
        # in a torch.profiler trace
        with telemetry.annotation(f"train.step/{step}"), \
                telemetry.span("train.step", step=step, arch=arch):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        monitor.record(0, dt)
        if step % log_every == 0 or step == steps - 1:
            log.info("step %4d loss=%.4f lr=%.2e gnorm=%.3f %.2fs",
                     step, metrics["loss"], metrics["lr"],
                     metrics["grad_norm"], dt)
            history.append({"step": step, **metrics, "sec": dt})
        live["state"] = (params, opt_state)
        return params, opt_state

    # the state argument is updated in place each call: recovery needs the
    # factory above, not the initial tensors
    one_step = declare_donation(one_step, (1,))

    controller = _resolve_tuning(tuning, device, mesh)
    if controller is not None:
        controller.start()
        # wrap_step keeps the donation metadata declared above
        one_step = controller.wrap_step(one_step)

    def save_fn(step: int, state):
        if saver is None:
            return
        tree = {"params": state[0], "opt": state[1]}
        if mesh is not None:
            tree = _gathered(tree, step_fn.specs, mesh)
        if tree is not None:
            saver.save_async(step, tree, extra={"arch": arch, "seed": seed})

    def restore_fn():
        if not ckpt_dir:
            return None
        # a save whose background thread died surfaces here; the torn step
        # is skipped by restore_latest_valid
        if saver is not None:
            try:
                saver.wait()
            except Exception as e:  # noqa: BLE001 — recovery handles it
                log.warning("async save failed (%s); restoring the newest "
                            "valid step instead", e)
        # the live state gives the structure, devices and dtypes; before a
        # first step there is none, and a fresh one stands in
        if "state" in live:
            params, opt = live["state"]
        else:
            params = blocks(dict(model.named_parameters()))
            opt = init_state(params, opt_cfg)
        like = {"params": params, "opt": opt}
        place = None
        if mesh is not None:
            dist.barrier()           # rank 0's last write has landed
            place = elastic.placement(like, mesh, cfg=cfg, rules=rules)
        got = ckpt_lib.restore_latest_valid(ckpt_dir, like,
                                            sharding_fn=place)
        if got is None:
            return None
        last, tree, _extra = got
        return last, (tree["params"], tree["opt"])

    fault_cfg = FaultConfig(checkpoint_every=checkpoint_every)
    try:
        with deterministic_algorithms(deterministic), (
                use_mesh(mesh, rules) if mesh is not None
                else contextlib.nullcontext()):
            result = run_with_recovery(one_step, fresh_state, steps,
                                       fault_cfg, save_fn, restore_fn,
                                       failure_injector=failure_injector,
                                       chaos=chaos)
    finally:
        if controller is not None:
            controller.stop()        # detach, clear the live spec, persist
    if saver is not None:
        saver.wait()
    if mesh is not None:
        dist.barrier()               # every rank returns after the last write
    out = {"history": history, "steps_done": result.steps_done,
           "failures": result.failures,
           "backoff_total_s": result.backoff_total_s,
           "final_loss": history[-1]["loss"] if history else None}
    if controller is not None:
        out["tuning"] = controller.stats()
    return out


def _resolve_tuning(tuning, device, mesh=None):
    """None → the ``REPRO_TUNING`` env hook; True → a default controller;
    a `SpecController` passes through.  A controller built here under a
    mesh is given it, so every rank installs one spec.  The tuning
    package is imported only when one is asked for."""
    if tuning is None:
        if not os.environ.get("REPRO_TUNING", "").strip():
            return None
        from repro_torch.tuning import from_env
        return from_env(device=device, mesh=mesh)
    if tuning is True:
        from repro_torch.tuning import SpecController
        return SpecController(device=device, mesh=mesh)
    return tuning


def _mesh_rules(cfg, mesh, rules: Optional[Dict]) -> Dict:
    """The rules sharded training runs under (default `arch_rules`); raises
    `NotImplementedError` for what it does not cover, before any rank
    starts work."""
    if any(is_moe for _, is_moe in layer_sigs(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: its MoE layers take the global tokens on every "
            f"rank of a mesh and have no backward through the mesh's "
            f"collectives: {SHARDED_MOE}")
    rules = arch_rules(cfg, mesh, "train") if rules is None else rules
    unknown = [a for a in mesh.axis_names if a not in rule_axes(rules)]
    if unknown:
        raise NotImplementedError(
            f"mesh axes {unknown} are named by no logical-axis rule "
            f"({sorted(rule_axes(rules))}); sharded training places "
            f"nothing on them")
    return rules


def _gathered(tree: Dict, specs: Dict, mesh) -> Optional[Dict]:
    """The whole state on the host from every rank's blocks, one leaf at
    a time; every rank calls it (one gather per sharded leaf), and only
    rank 0, the checkpoint's writer, keeps the result (None elsewhere)."""
    keep = dist.get_rank() == 0

    def full(leaves):
        out = {}
        for name, x in leaves.items():
            whole = gather_full(x, specs[name], mesh)
            if keep:
                out[name] = whole.to("cpu", copy=True)
            del whole
        return out

    opt = tree["opt"]
    out = {"params": full(tree["params"]),
           "opt": {"step": opt["step"], **{k: full(opt[k])
                                           for k in ("master", "m", "v")}}}
    return out if keep else None


def train_on_mesh(mesh, arch: str, kwargs: Optional[Dict] = None
                  ) -> Dict[str, Any]:
    """`train(arch, mesh=mesh, **kwargs)`: the target of
    `launch.ranks.launch` (``"repro_torch.launch.train:train_on_mesh"``),
    which calls it on every rank with the rank's mesh."""
    return train(arch, mesh=mesh, **(kwargs or {}))


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full-size config; default reduced")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="fault-injection spec, e.g. 'seed=7,step=0.05,"
                         "ckpt_save=0.1@2' (same syntax as REPRO_CHAOS)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; needs a card) or cpu")
    ap.add_argument("--telemetry", default=None, metavar="SINK",
                    help="'ring' or a JSONL path: enable the "
                         "repro_torch.telemetry event stream (same as "
                         "REPRO_TELEMETRY); render a capture with `python "
                         "-m repro_torch.telemetry.report`")
    ap.add_argument("--tuning", nargs="?", const="on", default=None,
                    metavar="STATE",
                    help="run under a repro_torch.tuning.SpecController "
                         "(guarded live HardwareSpec updates from the run's "
                         "own drift telemetry); optional value = state file "
                         "the tuned spec persists/restores through (same as "
                         "REPRO_TUNING)")
    ap.add_argument("--profile-annotations", action="store_true",
                    help="open torch.profiler ranges around steps, atomics "
                         "dispatch and migrations (needs --telemetry)")
    args = ap.parse_args(argv)
    if args.telemetry:
        sink = (telemetry.RingBuffer() if args.telemetry == "ring"
                else telemetry.JsonlWriter(args.telemetry))
        telemetry.enable(sink, annotate=args.profile_annotations)
    else:
        telemetry.enable_from_env()
    chaos = FaultPlan.from_spec(args.chaos) if args.chaos else None
    tuning = None
    if args.tuning is not None:
        from repro_torch.tuning import SpecController
        tuning = SpecController(
            state_path=None if args.tuning == "on" else args.tuning,
            device=args.device)
    try:
        out = train(args.arch, steps=args.steps, seq_len=args.seq_len,
                    global_batch=args.global_batch, reduced=not args.full,
                    ckpt_dir=args.ckpt_dir, lr=args.lr,
                    microbatches=args.microbatches, chaos=chaos,
                    tuning=tuning, device=args.device)
    finally:
        if telemetry.enabled():
            telemetry.disable()      # flush and close the JSONL capture
    print(json.dumps({k: v for k, v in out.items() if k != "history"}))


if __name__ == "__main__":
    main()
