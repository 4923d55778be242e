"""Rank side of `tests/test_torch_serve_sharded_ssm.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (1, 4) ``("data",
"model")``.  It imports the port only: no JAX, and not the test suite's
conftest.

Each case serves a reduced Mamba-2 or hybrid config in f32 through the
sharded steps (`launch.steps.make_sharded_prefill_step` /
`make_sharded_decode_step`, the parameters from `shard_of` of a model of
seed 0, the steps' own model built on meta) and through the local path
(`LM.prefill` / `LM.decode_step` on the whole model of the same seed), on
the same seeded prompt and the tokens fed after it, and reports for this
rank's cut of the batch: each step's relative L2 error of the logits,
whether their argmax tokens agree, and each cache block's relative L2
error against the local cache's block: an attention layer's k and v by
their specs, a Mamba layer's state by its spec (its heads) and its conv
window's rows by its spec, of the channels the rank convolves (its x
channels and every B and C channel).
"""

import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_serve_sharded_worker import f32, inputs, rel  # noqa: E402
from repro_torch.launch.mesh import Mesh, shard_of  # noqa: E402
from repro_torch.launch.shardings import arch_rules  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_sharded_decode_step, make_sharded_prefill_step)
from repro_torch.models.model import LM  # noqa: E402

#: case -> (arch, mesh, global batch, prompt length, s_max, decode steps,
#: the long-context rules: batch whole, no cut of it over "data")
CASES = {
    # 8 heads, 4 a rank; the prompt over two chunks of 16 (padded)
    "mamba2_780m/2x2": ("mamba2_780m", "2x2", 4, 21, 32, 6, False),
    # 2 heads a rank, the batch whole along "data" of 1
    "mamba2_780m/1x4": ("mamba2_780m", "1x4", 2, 9, 16, 6, False),
    # the long_500k cell's rules (`arch_rules(..., seq_shard_carry=True)`)
    "mamba2_780m/2x2/long": ("mamba2_780m", "2x2", 2, 9, 16, 6, True),
    # Mamba, GQA on a sequence-cut cache, dense MLP and MoE; the decode
    # crosses the cache's segment boundary at row 8
    "jamba_1_5_large_398b/2x2": ("jamba_1_5_large_398b", "2x2", 4, 5, 16,
                                 9, False),
}


def _channels(cfg, parts, r):
    """The conv window's channels a rank of ``parts`` convolves."""
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    dr = di // parts
    return torch.cat([torch.arange(r * dr, (r + 1) * dr),
                      torch.arange(di, di + 2 * gn)])


def _cache_errors(scache, cache, cspecs, cfg, mesh):
    """{key: the largest relative L2 error of a block of that leaf}."""
    errs = {}
    for got, want, spec in zip(scache["layers"], cache["layers"],
                               cspecs["layers"]):
        for key in ("k", "v", "ssm", "conv"):
            if key not in want:
                continue
            w = shard_of(want[key], spec[key], mesh)
            if key == "conv" and got[key].shape[-1] != w.shape[-1]:
                w = w[..., _channels(cfg, mesh.size("model"),
                                     mesh.index("model"))]
            errs[key] = max(errs.get(key, 0.0), rel(got[key], w))
    return errs


def serve_case(mesh, arch, b, prompt, s_max, steps, long):
    cfg = f32(arch)
    whole = LM(cfg, device="cpu", seed=0)
    batches = inputs(cfg, b, prompt, steps)
    cache, logits = whole.prefill(batches[0], s_max)
    local = [logits]
    for bt in batches[1:]:
        cache, logits = whole.decode_step(cache, bt)
        local.append(logits)
    model = LM(cfg, device="meta", seed=0)
    rules = {kind: arch_rules(cfg, mesh, "decode" if long else kind,
                              seq_shard_carry=long)
             for kind in ("prefill", "decode")}
    prefill = make_sharded_prefill_step(model, s_max, mesh, rules["prefill"])
    decode = make_sharded_decode_step(model, mesh, rules["decode"])
    blocks = {n: shard_of(p.detach(), prefill.specs[n], mesh)
              for n, p in whole.named_parameters()}
    cspecs = decode.cache_specs(b, s_max)
    scache, logits = prefill(blocks, batches[0])
    got = [logits]
    for bt in batches[1:]:
        scache, logits = decode(blocks, scache, bt)
        got.append(logits)
    batch_spec = cspecs["layers"][0]["ssm"][:1]
    want = [shard_of(x, batch_spec, mesh) for x in local]
    full = dict(whole.named_parameters())
    placed = dict(model.named_parameters())
    cut = [n for n, c in prefill.cuts.items() if c.mode == "cut"]
    ssm = [layer for layer in scache["layers"] if "ssm" in layer]
    return dict(
        logit_rel=[rel(g, w) for g, w in zip(got, want)],
        tokens_equal=[bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                      for g, w in zip(got, want)],
        cache_rel=_cache_errors(scache, cache, cspecs, cfg, mesh),
        ssm_block=tuple(ssm[0]["ssm"].shape),
        conv_block=tuple(ssm[0]["conv"].shape),
        ssm_spec=cspecs["layers"][0]["ssm"],
        lens=sorted({layer["len"] for layer in scache["layers"]}),
        in_proj=[tuple(placed[n].shape) for n in placed
                 if n.endswith(".in_proj")][:1],
        cut_placed_whole=[n for n in cut
                          if placed[n].numel() >= full[n].numel()])


def run(mesh):
    torch.manual_seed(0)
    meshes = {"2x2": mesh, "1x4": Mesh((1, 4), ("data", "model"))}
    out = {"serve": {case: serve_case(meshes[c[1]], c[0], *c[2:])
                     for case, c in CASES.items()}}
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out
