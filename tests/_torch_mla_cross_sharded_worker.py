"""Rank side of `tests/test_torch_mla_cross_sharded.py`.

Runs on every rank of a gloo group of 4 started by
`repro_torch.launch.ranks.launch` on a 2x2 ``("data", "model")`` mesh;
every rank builds a second mesh over the same ranks, (1, 4) ``("data",
"model")``.  It imports the port only: no JAX, and not the test suite's
conftest.

Training: the partitioned step (`launch.steps.make_sharded_train_step`)
runs `STEPS` steps in f32 on reduced deepseek_v3 (MLA, its MoE layers at
the no-drop factor E / k, where the sharded layer's function is the local
one's) and whisper_small (cross-attention) from the local trainer's
initial weights and batches; rank 0 gathers the parameters and AdamW's
first moments and runs the local step on a model of the same seed.  The
control marks deepseek_v3's ``wq_a`` leaves "partial" in the step's
``.cuts``, so their whole gradients are summed over "model" once more.

Serving: reduced deepseek_v3 and whisper_small in f32 through the sharded
prefill and decode steps against `LM.prefill` / `decode_step` on the
whole model of the same seed (`_torch_serve_sharded_worker.serve_case`'s
protocol, whisper's prompt with its seeded audio frames): each step's
logits, the greedy tokens, and each cache block against `shard_of` of the
local cache by the step's ``.cache_specs`` (MLA's ckv and krope, the
encoder's output).  The control expands each rank's segment of the latent
cache with its own heads' columns of ``wkv_b`` only
(`models.attention._CONTROLS` "mla_own_wkv_b").
"""

import os
import sys

import torch

# the rank loads this file by path: its siblings are found beside it
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_serve_sharded_worker as S  # noqa: E402
import _torch_train_tp_worker as T  # noqa: E402
from repro_torch.launch.mesh import (Mesh, gather_full,  # noqa: E402
                                     shard_of, use_mesh)
from repro_torch.launch.shardings import ModelCut, arch_rules  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_sharded_decode_step, make_sharded_prefill_step,
    make_sharded_train_step, make_train_step)
from repro_torch.launch.train import deterministic_algorithms  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_state  # noqa: E402

#: training case -> (arch, the leaves marked "partial" in the step's
#: cuts: the control)
TRAIN = {"deepseek_v3_671b": ("deepseek_v3_671b", ()),
         "whisper_small": ("whisper_small", ()),
         "deepseek_v3_671b/wq_a_twice": ("deepseek_v3_671b", ("wq_a",))}
#: serving case -> (arch, mesh, global batch, prompt, s_max, decode steps,
#: attention control)
SERVE = {
    # 4 heads, 2 a rank; the decode crosses the boundary at row 8
    "deepseek_v3_671b/2x2": ("deepseek_v3_671b", "2x2", 4, 5, 16, 9, None),
    # one head a rank; segments of 4 rows from a prompt of 2: len crosses
    # two boundaries, the ranks past the prompt start with empty segments
    "deepseek_v3_671b/1x4": ("deepseek_v3_671b", "1x4", 2, 2, 16, 9, None),
    # s_max does not divide over "model": the latent stays whole
    "deepseek_v3_671b/2x2/s_max_15": ("deepseek_v3_671b", "2x2", 4, 5, 15, 9,
                                      None),
    "whisper_small/2x2": ("whisper_small", "2x2", 4, 5, 16, 9, None),
    "whisper_small/1x4": ("whisper_small", "1x4", 2, 2, 16, 9, None),
    "deepseek_v3_671b/2x2/own_wkv_b": ("deepseek_v3_671b", "2x2", 4, 5, 16,
                                       9, "mla_own_wkv_b"),
}


def train_local(cfg):
    """The local trainer's `T.STEPS` steps: (history, params, m)."""
    model = T.model_of(cfg, "full")
    opt = AdamWConfig(**T.OPT)
    step = make_train_step(model, opt)
    params = dict(model.named_parameters())
    state = init_state(params, opt)
    hist = []
    with deterministic_algorithms(True):
        for i in range(T.STEPS):
            params, state, m = step(params, state, T.batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return (hist, {n: p.detach().clone() for n, p in params.items()},
            {n: x.clone() for n, x in state["m"].items()})


def train_sharded(mesh, cfg, partial):
    """The partitioned step's `T.STEPS` steps, the leaves named
    ``partial`` marked so: (history, {name: mode}, params and m gathered
    on rank 0, else None)."""
    model = T.model_of(cfg, "full")
    opt = AdamWConfig(**T.OPT)
    rules = arch_rules(cfg, mesh, "train")
    step = make_sharded_train_step(model, opt, mesh, rules)
    for name in step.cuts:
        if name.rpartition(".")[2] in partial:
            step.cuts[name] = ModelCut(None, "partial")
    specs = step.specs
    params = {n: shard_of(p.detach(), specs[n], mesh)
              for n, p in model.named_parameters()}
    state = init_state(params, opt)
    hist = []
    # under the mesh, as `train` runs it: the MoE layers expert-parallel
    with deterministic_algorithms(True), use_mesh(mesh, rules):
        for i in range(T.STEPS):
            params, state, m = step(params, state, T.batch(cfg, i))
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    whole = {key: {n: gather_full(x, specs[n], mesh) for n, x in tree.items()}
             for key, tree in (("params", params), ("m", state["m"]))}
    modes = {n: c.mode for n, c in step.cuts.items()}
    return hist, modes, (whole if mesh.rank == 0 else None)


def frames(cfg, b):
    """Whisper's seeded audio frames (b, n_frames, d)."""
    gen = torch.Generator().manual_seed(9)
    return torch.randn((b, cfg.encoder.n_frames, cfg.d_model), generator=gen)


def serve_case(mesh, arch, b, prompt, s_max, steps, control,
               device="cpu"):
    """`_torch_serve_sharded_worker.serve_case`'s comparison for a config
    with MLA or an encoder, under ``control``, on ``device``."""
    cfg = S.f32(arch)
    whole = LM(cfg, device=device, seed=0)
    batches = S.inputs(cfg, b, prompt, steps)
    if cfg.encoder is not None:
        batches[0]["frames"] = frames(cfg, b)
    batches = [{k: x.to(device) for k, x in bt.items()} for bt in batches]
    cache, logits = whole.prefill(batches[0], s_max)
    local = [logits]
    for bt in batches[1:]:
        cache, logits = whole.decode_step(cache, bt)
        local.append(logits)
    model = LM(cfg, device="meta", seed=0)
    prefill = make_sharded_prefill_step(model, s_max, mesh,
                                        arch_rules(cfg, mesh, "prefill"))
    decode = make_sharded_decode_step(model, mesh,
                                      arch_rules(cfg, mesh, "decode"))
    blocks = {n: shard_of(p.detach(), prefill.specs[n], mesh)
              for n, p in whole.named_parameters()}
    cspecs = decode.cache_specs(b, s_max)
    keys = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
    batch_spec = cspecs["layers"][0][keys[0]][:1]
    attention._CONTROLS = frozenset({control} if control else ())
    try:
        scache, logits = prefill(blocks, batches[0])
        got = [logits]
        for bt in batches[1:]:
            scache, logits = decode(blocks, scache, bt)
            got.append(logits)
    finally:
        attention._CONTROLS = frozenset()
    want = [shard_of(x, batch_spec, mesh) for x in local]
    errs = [S.rel(scache["layers"][i][key],
                  shard_of(cache["layers"][i][key], spec[key], mesh))
            for i, spec in enumerate(cspecs["layers"]) for key in keys]
    if cfg.encoder is not None:
        errs.append(S.rel(scache["enc_out"], shard_of(
            cache["enc_out"], cspecs["enc_out"], mesh)))
    full = dict(whole.named_parameters())
    placed = dict(model.named_parameters())
    cut = sorted(n for n, c in prefill.cuts.items() if c.mode == "cut")
    return dict(
        logit_rel=[S.rel(g, w) for g, w in zip(got, want)],
        tokens_equal=[bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                      for g, w in zip(got, want)],
        cache_rel=max(errs), len=scache["layers"][0]["len"],
        seq=scache["layers"][0]["seq"],
        block_shapes={k: tuple(scache["layers"][0][k].shape) for k in keys},
        enc_shape=(None if cfg.encoder is None
                   else tuple(scache["enc_out"].shape)),
        cut=cut, placed_whole=sorted(
            n for n in cut if placed[n].numel() >= full[n].numel()))


def run(mesh):
    torch.manual_seed(0)
    meshes = {"2x2": mesh, "1x4": Mesh((1, 4), ("data", "model"))}
    out = {"train": {}, "local": {}, "serve": {}}
    for case, (arch, partial) in TRAIN.items():
        cfg = S.f32(arch)
        out["train"][case] = train_sharded(mesh, cfg, partial)
        if mesh.rank == 0 and arch not in out["local"]:
            out["local"][arch] = train_local(cfg)
    for case, (arch, tag, *args) in SERVE.items():
        out["serve"][case] = serve_case(meshes[tag], arch, *args)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out


def run_card(mesh):
    """The card's case on a (1, 2) ``("data", "model")`` mesh: reduced
    deepseek_v3 served sharded on CUDA tensors in f32 (a prompt of 5 into
    two segments of 8 rows, then 4 decode steps over both) against the
    local path on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    got = serve_case(mesh, "deepseek_v3_671b", 2, 5, 16, 4, None, "cuda")
    return {k: got[k] for k in ("logit_rel", "tokens_equal", "cache_rel",
                                "seq", "block_shapes")}
