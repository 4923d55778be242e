"""Batched serving driver: a loop over prefill + decode.

Port of `repro.launch.serve`.  Requests arrive with different prompt
lengths; the server fills free slots by prefilling new requests, and steps
every active slot one token at a time, greedily.  One slot per request
keeps per-request cache lengths exact, as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --full   # on a card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_780m

Besides the reference's stats dict, the server keeps host-clock totals of
its prefill and decode calls in `BatchServer.timing` (each call ends in a
host read of the next token, so the totals include the device's work).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: the prefill's last-position logits (vocab,) f32, kept for checks
    prefill_logits: Optional[torch.Tensor] = None


class BatchServer:
    """Static-batch server (slots = batch size); greedy sampling."""

    def __init__(self, arch: str, *, reduced: bool = True, slots: int = 4,
                 s_max: int = 128, seed: int = 0, device="cuda"):
        self.cfg = get_reduced(arch) if reduced else get_config(arch)
        self.model = build_model(self.cfg, device=device, seed=seed,
                                 attn_impl="ref")
        self.device = torch.device(device)
        self.slots = slots
        self.s_max = s_max
        self.active: List[Optional[Request]] = [None] * slots
        self.caches: List[Any] = [None] * slots
        self.timing = {"prefills": 0, "prefill_s": 0.0,
                       "decode_steps": 0, "decode_s": 0.0}

    def submit(self, req: Request) -> bool:
        for i in range(self.slots):
            if self.active[i] is None:
                t0 = time.perf_counter()
                prompt = torch.tensor([req.prompt], dtype=torch.long,
                                      device=self.device)
                cache, logits = self.model.prefill({"tokens": prompt},
                                                   self.s_max)
                tok = int(torch.argmax(logits, -1)[0])
                self.timing["prefill_s"] += time.perf_counter() - t0
                self.timing["prefills"] += 1
                req.out.append(tok)
                req.prefill_logits = logits[0]
                self.active[i] = req
                self.caches[i] = cache
                return True
        return False

    def step(self) -> int:
        """Advance every active request one token; returns #active."""
        n = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            n += 1
            t0 = time.perf_counter()
            tok = torch.tensor([[req.out[-1]]], dtype=torch.long,
                               device=self.device)
            self.caches[i], logits = self.model.decode_step(self.caches[i],
                                                            {"tokens": tok})
            nxt = int(torch.argmax(logits, -1)[0])
            self.timing["decode_s"] += time.perf_counter() - t0
            self.timing["decode_steps"] += 1
            req.out.append(nxt)
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None
                self.caches[i] = None
        return n

    def run(self, requests: List[Request]) -> Dict[str, Any]:
        t0 = time.time()
        pending = list(requests)
        done: List[Request] = []
        tokens = 0
        while pending or any(r is not None for r in self.active):
            while pending and self.submit(pending[0]):
                pending.pop(0)
            tokens += self.step()
            done = [r for r in requests if r.done]
        dt = time.time() - t0
        return {"requests": len(requests), "tokens": tokens,
                "wall_s": round(dt, 3),
                "tok_per_s": round(tokens / max(dt, 1e-9), 1),
                "completed": len(done)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the full-size config (default: the reduced one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    server = BatchServer(args.arch, reduced=not args.full,
                         device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, server.cfg.vocab_size,
                                        rng.integers(4, 16)).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    print(json.dumps(server.run(reqs)))


if __name__ == "__main__":
    main()
