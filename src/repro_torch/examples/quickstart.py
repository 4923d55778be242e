"""Quickstart: train a small LM, then serve it.

Port of the reference's ``examples/quickstart.py``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--arch gemma_2b] [--steps 50] [--device cuda|cpu]

Uses the public API only: the trainer (`launch.train.train`, on the arch's
reduced config) and then `launch.serve.BatchServer`, which serves 3
batched requests.  Runs on the card unless ``--device cpu``.
"""

import argparse
import logging

import numpy as np

from repro_torch.launch.serve import BatchServer, Request
from repro_torch.launch.train import train


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma_2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"== training {args.arch} (reduced config) for {args.steps} steps")
    out = train(args.arch, steps=args.steps, seq_len=64, global_batch=4,
                lr=3e-3, log_every=10, device=args.device)
    print(f"loss: {out['history'][0]['loss']:.3f} -> "
          f"{out['final_loss']:.3f} over {out['steps_done']} steps")

    print("== serving 3 batched requests")
    server = BatchServer(args.arch, slots=2, s_max=32, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, server.cfg.vocab_size, 6).tolist(), max_new=4) for i in range(3)]
    stats = server.run(reqs)
    print(stats)
    return {"train": out, "serve": stats}


if __name__ == "__main__":
    main()
