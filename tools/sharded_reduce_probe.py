#!/usr/bin/env python3
"""The sharded trainer's exchanges alone, on 4 gloo ranks sharing one card.

    python3 tools/sharded_reduce_probe.py [OUT.json]

Each rank holds random f32 gradients of gemma_2b at full width cut to 2
layers (744M elements, 2.98 GB) on a 2x2 ``("data", "model")`` mesh and
times, in turns (four rounds, each in another order), what
`launch.steps.make_sharded_train_step` could do with them: ``batch``, an
all-reduce over the axes the batch is split on (``data``) and this rank's
block (`shard_of`), the step's choice; ``mesh``, the same all-reduce over
every axis of the mesh; ``scatter``, the sum over the mesh straight into
the block (one reduce-scatter over the axes the spec shards on, the leaf
laid out block by block, then an all-reduce of the block over the other
axes); and ``gather``, `gather_full` of each parameter's block, the
step's gather.  Prints one JSON line: each variant's seconds by
round, the slowest rank's (every rank waits for it), and the bytes.  Run
from the repository root on a machine with one CUDA card.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ORDERS = ("bmsg", "gsmb", "msgb", "sbgm")


def _scatter(mesh, full, spec):
    """This rank's block of the sum of ``full`` over every rank."""
    dims = [(d, (e,) if isinstance(e, str) else tuple(e))
            for d, e in enumerate(spec) if e]
    axes = tuple(a for _, names in dims for a in names)
    rest = tuple(a for a in mesh.axis_names if a not in axes)
    if not dims:
        return mesh.all_reduce(full, rest)
    count = {d: mesh.size(names) for d, names in dims}
    split, lead, tail, block = [], [], [], []
    for d, size in enumerate(full.shape):
        if d in count:
            lead.append(len(split))
            split += [count[d], size // count[d]]
        else:
            split.append(size)
        tail.append(len(split) - 1)
        block.append(split[-1])
    laid = full.reshape(split).permute(lead + tail).reshape(-1, *block)
    out = mesh.reduce_scatter(laid, axes).reshape(block)
    return mesh.all_reduce(out, rest) if rest else out


def rank(mesh):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import gather_full, shard_of
    from repro_torch.launch.shardings import arch_rules, params_shardings
    from repro_torch.models.model import LM
    dev = torch.device("cuda")
    mesh.probe(dev)
    cfg = get_config("gemma_2b").replace(n_layers=2, dtype="float32")
    meta = LM(cfg, device="meta")
    specs = params_shardings(cfg, dict(meta.named_parameters()), mesh,
                             arch_rules(cfg, mesh))
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    grads = {n: torch.randn(p.shape, generator=gen, device=dev)
             for n, p in meta.named_parameters()}
    blocks = {n: shard_of(x, specs[n], mesh) for n, x in grads.items()}

    def reduce(axes):
        return {n: shard_of(mesh.all_reduce(x, axes), specs[n], mesh)
                for n, x in grads.items()}

    variants = {
        "b": ("batch", lambda: reduce(("data",))),
        "m": ("mesh", lambda: reduce(mesh.axis_names)),
        "s": ("scatter", lambda: {n: _scatter(mesh, x, specs[n])
                                  for n, x in grads.items()}),
        "g": ("gather", lambda: {n: gather_full(x, specs[n], mesh)
                                 for n, x in blocks.items()})}
    seconds = {name: [] for name, _ in variants.values()}
    for order in ORDERS:
        for key in order:
            name, run = variants[key]
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t0)
            del out
    return {"seconds": seconds, "host_staged": sorted(mesh.host_staged),
            "grad_bytes": sum(x.numel() * 4 for x in grads.values())}


def main(argv):
    from repro_torch.launch import ranks
    out = ranks.launch(f"{os.path.abspath(__file__)}:rank", 4,
                       mesh=((2, 2), ("data", "model")), device="cuda",
                       timeout=500)
    names = out[0]["seconds"]
    line = {"orders": ORDERS, "rank0": out[0],
            "slowest_rank": {n: [max(o["seconds"][n][i] for o in out)
                                 for i in range(len(ORDERS))]
                             for n in names}}
    print(json.dumps(line), flush=True)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(line, f)


if __name__ == "__main__":
    main(sys.argv[1:])
