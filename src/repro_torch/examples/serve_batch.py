"""Batched serving example: continuous batching over mixed-length prompts.

Port of the reference's ``examples/serve_batch.py``::

    PYTHONPATH=src python -m repro_torch.examples.serve_batch \
        [--arch qwen2_vl_2b] [--device cuda|cpu]

Serves the arch's reduced config through `launch.serve.BatchServer` (on
the card unless ``--device cpu``) and prints the server's stats and the
first three requests' tokens.
"""

import argparse
import json

import numpy as np

from repro_torch.launch.serve import BatchServer, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_12b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    server = BatchServer(args.arch, slots=args.slots, s_max=64,
                         device=args.device)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, server.cfg.vocab_size,
                                        int(rng.integers(3, 20))).tolist(),
                    max_new=args.max_new)
            for i in range(args.requests)]
    stats = server.run(reqs)
    print(json.dumps(stats, indent=2))
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")


if __name__ == "__main__":
    main()
