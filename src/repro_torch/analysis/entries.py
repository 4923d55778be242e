"""Registered entry points for the lint sweep.

Port of `repro.analysis.entries`: the reference's nine entries on the
port's modules.  Each entry takes ``device`` ("cuda", the default, or
"cpu") and returns a findings list; the CLI (`python -m
repro_torch.analysis.lint`), the ``torch_atomics_lint`` pytest fixture and
the ``analysis`` suite sweep all of them.  Entries build their functions
from *reduced* configs with `analysis.spec` stand-ins wherever shapes
suffice; each checked function runs once.

Register new atomics-touching code paths here: an entry that exists is an
entry the linter guards.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, List

import torch

from repro_torch import analysis
from repro_torch.analysis.findings import Finding

spec = analysis.spec


# ---------------------------------------------------------------------------
# MoE dispatch (models/moe.py) — the densest atomics consumer in the repo
# ---------------------------------------------------------------------------

def check_moe_local(device="cuda") -> List[Finding]:
    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import moe_ffn, moe_init

    out: List[Finding] = []
    base = get_reduced("dbrx_132b")
    params = moe_init(torch.Generator().manual_seed(0), base,
                      torch.float32).to(device)
    x = spec((2, 8, base.d_model))
    for policy in ("cas_keep_top_gate", "swp_drop_newest"):
        cfg = dataclasses.replace(
            base, moe=dataclasses.replace(base.moe, overflow_policy=policy))
        out += analysis.check(lambda p, xx: moe_ffn(p, xx, cfg), params, x,
                              entry=f"moe.local[{policy}]", device=device)
    return out


# ---------------------------------------------------------------------------
# BFS (core/bfs.py) — bounded while+CAS loops that must NOT trip A003
# ---------------------------------------------------------------------------

def check_bfs_local(device="cuda") -> List[Finding]:
    from repro_torch.core.bfs import bfs

    out: List[Finding] = []
    src = torch.tensor([0, 0, 1, 2, 4, 5], dtype=torch.int32, device=device)
    dst = torch.tensor([1, 2, 3, 3, 5, 6], dtype=torch.int32, device=device)
    for op in ("cas", "swp", "faa"):
        out += analysis.check(
            partial(bfs, n=8, root=0, op=op, max_levels=8, device=device),
            src, dst, entry=f"bfs.local[{op}]", device=device)
    return out


# ---------------------------------------------------------------------------
# training (launch/train.py path) — donation hygiene end to end
# ---------------------------------------------------------------------------

def _reduced_model(device):
    from repro_torch.configs import get_reduced
    from repro_torch.models.model import build_model

    cfg = get_reduced("gemma_2b")
    return cfg, build_model(cfg, device=device, use_kernel=False,
                            attn_impl="ref")


def _train_args(cfg, model, device):
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.optim.adamw import AdamWConfig, init_state

    opt_cfg = AdamWConfig()
    params = dict(model.named_parameters())
    batch = synthetic_batch(
        DataConfig(seq_len=8, global_batch=2, vocab_size=cfg.vocab_size), 0,
        device=device)
    return opt_cfg, params, init_state(params, opt_cfg), batch


def _donating_step(model, opt_cfg):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.runtime.fault_tolerance import declare_donation

    # the step updates params and optimizer state in place
    return declare_donation(make_train_step(model, opt_cfg), (0, 1))


def check_train_step(device="cuda") -> List[Finding]:
    cfg, model = _reduced_model(device)
    opt_cfg, params, opt, batch = _train_args(cfg, model, device)
    return analysis.check(_donating_step(model, opt_cfg), params, opt,
                          batch, entry="train.step", device=device)


def check_train_recovery(device="cuda") -> List[Finding]:
    from repro_torch.optim.adamw import AdamWConfig

    _, model = _reduced_model(device)
    # the trainer passes a zero-arg factory (launch/train.py fresh_state);
    # this entry pins that contract so a regression to a captured value
    # fails lint before it fails a chaos run
    return analysis.check_recovery(_donating_step(model, AdamWConfig()),
                                   lambda: None, entry="train.recovery")


# ---------------------------------------------------------------------------
# serving (launch/serve.py path) — KV-cache update hygiene
# ---------------------------------------------------------------------------

def _prompt():
    return {"tokens": spec((1, 8), torch.int32)}


def _decode_args(model, device):
    """A cache filled by an 8-token prefill, and one token."""
    cache, _ = model.prefill(
        {"tokens": torch.zeros((1, 8), dtype=torch.int32, device=device)}, 16)
    return cache, {"tokens": spec((1, 1), torch.int32)}


def check_serve_prefill(device="cuda") -> List[Finding]:
    _, model = _reduced_model(device)
    return analysis.check(lambda m, b: m.prefill(b, 16), model, _prompt(),
                          entry="serve.prefill", device=device)


def check_serve_decode(device="cuda") -> List[Finding]:
    _, model = _reduced_model(device)
    cache, tok = _decode_args(model, device)
    return analysis.check(lambda c, b: model.decode_step(c, b), cache, tok,
                          entry="serve.decode", device=device)


# ---------------------------------------------------------------------------
# self-tuning (repro_torch.tuning) — controller-wrapped steps stay clean
# ---------------------------------------------------------------------------

def check_tuning_train_step(device="cuda") -> List[Finding]:
    """`SpecController.wrap_step` around the donating train step: the
    wrapper must preserve the donation contract (rule A004) and add no
    atomics hazards of its own — an unstarted controller's step() is a
    no-op, so the sweep needs no live stream."""
    from repro_torch.tuning import SpecController

    cfg, model = _reduced_model(device)
    opt_cfg, params, opt, batch = _train_args(cfg, model, device)
    step = SpecController(device=device).wrap_step(
        _donating_step(model, opt_cfg))
    out = analysis.check(step, params, opt, batch,
                         entry="tuning.train_step", device=device)
    out += analysis.check_recovery(step, lambda: None,
                                   entry="tuning.train_step")
    return out


def check_tuning_serve_decode(device="cuda") -> List[Finding]:
    from repro_torch.tuning import SpecController

    _, model = _reduced_model(device)
    cache, tok = _decode_args(model, device)
    step = SpecController(device=device).wrap_step(
        lambda c, b: model.decode_step(c, b))
    return analysis.check(step, cache, tok, entry="tuning.serve_decode",
                          device=device)


# ---------------------------------------------------------------------------
# sharded execute (examples/sharded_atomics.py pattern) — A005 coverage
# ---------------------------------------------------------------------------

def check_examples_sharded(device="cuda") -> List[Finding]:
    from repro_torch import atomics
    from repro_torch.launch.mesh import RecordingMesh

    # one rank's view of a (1,) mesh: no process group needed
    mesh = RecordingMesh((1,), ("dev",))

    def fn(t, i, v):
        tbl = atomics.AtomicTable(t, axis="dev", mesh=mesh)
        res = atomics.execute(tbl, atomics.Faa(i, v))
        return res.table.data, res.fetched

    return analysis.check(fn, spec((8,), torch.int32),
                          spec((4,), torch.int32), spec((4,), torch.int32),
                          entry="examples.sharded_atomics", device=device)


#: name -> callable(device) returning findings; ``lint.sweep`` iterates
#: this in order
ENTRY_POINTS: Dict[str, Callable[..., List[Finding]]] = {
    "moe.local": check_moe_local,
    "bfs.local": check_bfs_local,
    "train.step": check_train_step,
    "train.recovery": check_train_recovery,
    "serve.prefill": check_serve_prefill,
    "serve.decode": check_serve_decode,
    "tuning.train_step": check_tuning_train_step,
    "tuning.serve_decode": check_tuning_serve_decode,
    "examples.sharded_atomics": check_examples_sharded,
}
