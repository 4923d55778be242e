"""Rank side of `tests/test_torch_serve_sharded.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (1, 4) ``("data",
"model")``.  It imports the port only: no JAX, and not the test suite's
conftest.

Each case serves a reduced config in f32 through the sharded steps
(`launch.steps.make_sharded_prefill_step` / `make_sharded_decode_step`,
the rules `arch_rules(cfg, mesh, "prefill" | "decode")`, the parameters
from `shard_of` of a model of seed 0, the steps' own model built on meta)
and through the port's local serving path (`LM.prefill` /
`LM.decode_step` on the whole model of the same seed), on the same
seeded prompt and the same tokens fed after it (`STEPS` of them), and
reports, for this rank's cut of the batch: the prefill's and every decode
step's relative L2 error of the logits, whether their argmax tokens
agree, and each cache block's relative L2 error against `shard_of` of
the local cache by the step's ``.cache_specs``.  The decode runs far
enough that ``len`` crosses the segments' boundaries, starting with some
ranks' segments empty.

Beside them: `combine_partials` over the ranks against the whole cache's
attention, and the same partials averaged without their log-sum-exps
(the control, which must fail).
"""

import dataclasses
import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.mesh import (Mesh, combine_partials,  # noqa: E402
                                     merge_partials, shard_of)
from repro_torch.launch.shardings import arch_rules  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_sharded_decode_step, make_sharded_prefill_step)
from repro_torch.models.attention import _sdpa  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

#: case -> (arch, mesh, global batch, prompt length, s_max, decode steps)
CASES = {
    # 4 query heads cut, its one kv head whole; the decode crosses the
    # boundary at row 8
    "gemma_2b/2x2": ("gemma_2b", "2x2", 4, 5, 16, 9),
    # kv heads cut too, M-RoPE with three distinct position axes
    "qwen2_vl_2b/2x2": ("qwen2_vl_2b", "2x2", 4, 5, 16, 9),
    # 4 query heads over 4 ranks, its 2 kv heads whole (`_own_kv`);
    # segments of 4 rows, 2 * 4 + 1 decode steps from a prompt of 2
    "stablelm_12b/1x4": ("stablelm_12b", "1x4", 2, 2, 16, 9),
    # attention, vocabulary and the expert-parallel layer
    "dbrx_132b/2x2": ("dbrx_132b", "2x2", 4, 4, 16, 9),
    # s_max does not divide over "model": the cache stays whole along the
    # sequence (gemma: every kv head; qwen2_vl: its kv heads cut instead)
    "gemma_2b/2x2/s_max_15": ("gemma_2b", "2x2", 4, 5, 15, 9),
    "qwen2_vl_2b/2x2/s_max_15": ("qwen2_vl_2b", "2x2", 4, 5, 15, 9),
    # the batch does not divide over "data": every rank serves all 3 rows
    "gemma_2b/2x2/batch_3": ("gemma_2b", "2x2", 3, 5, 16, 9),
}


def f32(arch):
    cfg = get_reduced(arch).replace(dtype="float32")
    if cfg.moe is not None:          # no drops: the same function on a cut
        m = cfg.moe
        cfg = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    return cfg


def positions3(b, s, start):
    """Three distinct M-RoPE position axes for tokens [start, start + s)."""
    t = torch.arange(start, start + s)[None].expand(b, s)
    return torch.stack([t, t // 2, (t * 3) % 7]).to(torch.int32)


def inputs(cfg, b, prompt, steps):
    """The seeded prompt (b, prompt) and the tokens fed after it."""
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (b, prompt + steps),
                         generator=gen)
    batches = [{"tokens": toks[:, :prompt]}]
    batches += [{"tokens": toks[:, i:i + 1]}
                for i in range(prompt, prompt + steps)]
    if cfg.pos_emb == "mrope":
        batches[0]["positions3"] = positions3(b, prompt, 0)
        for i, bt in enumerate(batches[1:]):
            bt["positions3"] = positions3(b, 1, prompt + i)
    return batches


def rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.clamp(torch.linalg.vector_norm(b), min=1e-30))


def serve_case(mesh, arch, b, prompt, s_max, steps):
    cfg = f32(arch)
    whole = LM(cfg, device="cpu", seed=0)
    batches = inputs(cfg, b, prompt, steps)
    # the local path, on the whole model
    cache, logits = whole.prefill(batches[0], s_max)
    local = [logits]
    for bt in batches[1:]:
        cache, logits = whole.decode_step(cache, bt)
        local.append(logits)
    # the sharded steps, on the rank's blocks and a model on meta
    model = LM(cfg, device="meta", seed=0)
    prefill = make_sharded_prefill_step(model, s_max, mesh,
                                        arch_rules(cfg, mesh, "prefill"))
    decode = make_sharded_decode_step(model, mesh,
                                      arch_rules(cfg, mesh, "decode"))
    blocks = {n: shard_of(p.detach(), prefill.specs[n], mesh)
              for n, p in whole.named_parameters()}
    cspecs = decode.cache_specs(b, s_max)
    batch_spec = cspecs["layers"][0]["k"][:1]
    scache, logits = prefill(blocks, batches[0])
    got = [logits]
    for bt in batches[1:]:
        scache, logits = decode(blocks, scache, bt)
        got.append(logits)
    want = [shard_of(x, batch_spec, mesh) for x in local]
    cache_err = max(
        rel(scache["layers"][i][key],
            shard_of(cache["layers"][i][key], spec[key], mesh))
        for i, spec in enumerate(cspecs["layers"]) for key in ("k", "v"))
    # no whole copy of a leaf the steps compute on the cut: each such
    # parameter of the model is smaller than the whole leaf
    full = dict(whole.named_parameters())
    placed = dict(model.named_parameters())
    cut = [n for n, c in prefill.cuts.items() if c.mode == "cut"]
    return dict(
        logit_rel=[rel(g, w) for g, w in zip(got, want)],
        tokens_equal=[bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                      for g, w in zip(got, want)],
        cache_rel=cache_err, len=scache["layers"][0]["len"],
        seq=scache["layers"][0]["seq"],
        block_shape=tuple(scache["layers"][0]["k"].shape),
        cut=sorted(cut),
        cut_placed_whole=[n for n in cut
                          if placed[n].numel() >= full[n].numel()],
        metrics=sorted(decode.metrics))


def combine_case(mesh):
    """Each rank's segment of one seeded cache (4 segments of 8 rows over
    the mesh's 4 ranks), its partial through `_sdpa`'s lse path, then
    `combine_partials` over every axis, against the whole cache's
    attention; the control merges the same partials with equal weights.
    The last segment holds no valid row (kv_valid 0 there)."""
    gen = torch.Generator().manual_seed(3)
    b, h, hkv, d, s_loc = 2, 4, 2, 16, 8
    q = torch.randn((b, 1, h, d), generator=gen)
    k, v = (torch.randn((b, 4 * s_loc, hkv, d), generator=gen)
            for _ in range(2))
    kv_len = 3 * s_loc - 3
    axes = mesh.axis_names
    r = mesh.index(axes)
    seg = slice(r * s_loc, (r + 1) * s_loc)
    kw = dict(causal=True, scale=d ** -0.5, impl="ref")
    out, lse = _sdpa(q, k[:, seg], v[:, seg], return_lse=True,
                     kv_len=min(max(kv_len - r * s_loc, 0), s_loc),
                     q_offset=kv_len - 1 - r * s_loc, **kw)
    got = combine_partials(out, lse, mesh, axes)
    want = _sdpa(q, k, v, kv_len=kv_len, q_offset=kv_len - 1,
                 use_kernel=False, **kw)
    outs = mesh.all_gather(out[None], axes)
    control = merge_partials(outs, torch.zeros((4,) + lse.shape))
    return dict(err=rel(got, want), control_err=rel(control, want),
                empty_lse=float(lse.max()) if r == 3 else None,
                bits=got)


def run(mesh):
    torch.manual_seed(0)
    meshes = {"2x2": mesh, "1x4": Mesh((1, 4), ("data", "model"))}
    out = {"serve": {}}
    for case, (arch, tag, b, prompt, s_max, steps) in CASES.items():
        out["serve"][case] = serve_case(meshes[tag], arch, b, prompt, s_max,
                                        steps)
    out["combine"] = combine_case(mesh)
    out["coords"] = dict(mesh.coords)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out
