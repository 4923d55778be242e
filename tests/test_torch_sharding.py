"""The logical-axis rules and partition specs (`repro_torch.sharding`,
`repro_torch.launch.shardings`) against the reference's.

One reference subprocess (module-scoped) with 8 fake XLA devices prints
its specs on (2, 2, 2) ``("pod", "data", "model")``, (2, 2) ``("data",
"model")`` and (4,) ``("data",)``: `logical_to_physical` on hand-picked
names and shapes, `arch_rules` for every config and shape kind, and
`params_shardings` for every leaf of every config, reduced and full, from
abstract parameters (`jax.eval_shape`; no step runs), with
`batch_shardings`, `cache_shardings` and `opt_state_shardings`.  The port
computes its specs without ranks, against an object with the mesh's
``shape``; its spec for a layer's leaf is the reference's for the stacked
leaf with the leading entry removed.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import convert, sharding
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import shardings as sh
from repro_torch.models.model import LM
from repro_torch.models.transformer import plan_stages

ARCHS = ("gemma_2b", "mamba2_780m", "qwen2_vl_2b", "whisper_small",
         "deepseek_v3_671b", "jamba_1_5_large_398b", "dbrx_132b",
         "phi3_medium_14b", "stablelm_12b", "command_r_plus_104b")
MESHES = {"pdm": ((2, 2, 2), ("pod", "data", "model")),
          "dm": ((2, 2), ("data", "model")), "d": ((4,), ("data",))}
L2P_CASES = [
    (("batch", "seq", "embed"), (8, 16, 64)),
    (("batch", None), (2, 16)),
    (("fsdp", "ffn"), (64, 128)),
    (("fsdp", "ffn"), (6, 128)),
    (("ffn", "fsdp"), (128, 64)),
    (("heads", "kv_heads"), (4, 4)),
    (("vocab", "embed"), (7, 64)),
    (("experts", "fsdp", None), (8, 64, 32)),
    (("layers", "batch", "kv_seq", "kv_heads", None), (2, 8, 32, 2, 16)),
    (("no_such_rule", None, "batch"), (4, 4, 4)),
    ((), ()),
]
BATCH = {"tokens": (8, 16), "labels": (8, 16), "positions3": (3, 8, 16),
         "frames": (8, 30, 64), "embeds": (8, 16, 64)}
CACHE_ARCHS = ("gemma_2b", "mamba2_780m", "deepseek_v3_671b",
               "jamba_1_5_large_398b", "whisper_small")

SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from repro.configs import get_config, get_reduced
from repro.launch import shardings as sh
from repro.models.model import build_model
from repro.optim.adamw import AdamWConfig, init_state
from repro.sharding import DEFAULT_RULES, hint, logical_to_physical, use_mesh

ARCHS, MESHES, L2P, BATCH, CACHE_ARCHS = json.loads(sys.argv[1])
meshes = {k: jax.make_mesh(tuple(s), tuple(n),
                           devices=jax.devices()[:len(jax.devices())
                                                 if len(s) == 3 else 4])
          for k, (s, n) in MESHES.items()}

def spec(s):
    s = getattr(s, "spec", s)
    return [list(e) if isinstance(e, tuple) else e for e in s]

def key(path):
    return ".".join(str(getattr(k, "key", getattr(k, "name",
                                                   getattr(k, "idx", None))))
                    for k in path)

def flat(tree):
    return {key(p): spec(s)
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

def sds(shape, dtype=jnp.int32):
    return jax.ShapeDtypeStruct(tuple(shape), dtype)

out = {"default_rules": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in DEFAULT_RULES.items()},
       "l2p": {}, "rules": {}, "params": {}, "batch": {}, "cache": {},
       "opt": {}}
for m, mesh in meshes.items():
    with use_mesh(mesh, DEFAULT_RULES):
        out["l2p"][m] = [spec(logical_to_physical(tuple(l), tuple(s)))
                         for l, s in L2P]
        try:
            hint(jnp.zeros((2, 3)), "batch")
        except ValueError as e:
            out["hint_error"] = str(e).split(":")[0]
    out["batch"][m] = flat(sh.batch_shardings(
        {k: sds(v) for k, v in BATCH.items()}, mesh, DEFAULT_RULES))
for arch in ARCHS:
    for reduced in (True, False):
        cfg = get_reduced(arch) if reduced else get_config(arch)
        model = build_model(cfg)
        params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        for m, mesh in meshes.items():
            tag = f"{m}/{arch}/{reduced}"
            rules = sh.arch_rules(cfg, mesh, "train")
            out["params"][tag] = flat(sh.params_shardings(cfg, params, mesh,
                                                          rules))
            if not reduced:
                continue
            out["rules"][tag] = {
                f"{kind}/{carry}": sh.arch_rules(cfg, mesh, kind, carry)
                for kind in ("train", "prefill", "decode")
                for carry in (False, True)}
            if arch == "gemma_2b":
                opt = jax.eval_shape(lambda p: init_state(p, AdamWConfig()),
                                     params)
                psh = sh.params_shardings(cfg, params, mesh, rules)
                out["opt"][m] = flat(sh.opt_state_shardings(opt, psh, mesh))
            if arch in CACHE_ARCHS:
                cache = jax.eval_shape(lambda: model.init_cache(8, 32))
                if cfg.encoder is not None:
                    cache["enc_out"] = sds((8, cfg.encoder.n_frames,
                                            cfg.d_model), jnp.float32)
                out["cache"][tag] = flat(sh.cache_shardings(
                    cache, mesh, sh.arch_rules(cfg, mesh, "decode")))
print("RESULT:" + json.dumps(out))
"""


class _Mesh:
    """What the rules read of a mesh: its axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


def _lists(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = "src"
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([ARCHS, MESHES, L2P_CASES, BATCH, CACHE_ARCHS])
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, arg], env=env, capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def models():
    """{(arch, reduced): the port's LM on the meta device}."""
    return {(arch, reduced): LM(get_reduced(arch) if reduced
                                else get_config(arch), device="meta")
            for arch in ARCHS for reduced in (True, False)}


def test_default_rules_and_logical_to_physical_match_reference(reference):
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in sharding.DEFAULT_RULES.items()} \
        == reference["default_rules"]
    for m, (shape, names) in MESHES.items():
        with sharding.use_mesh(_Mesh(shape, names), sharding.DEFAULT_RULES):
            got = [_lists(sharding.logical_to_physical(l, s))
                   for l, s in L2P_CASES]
        assert got == reference["l2p"][m], m
    # no mesh: every spec is empty, every hint a no-op
    assert sharding.logical_to_physical(("batch",), (8,)) == ()


def test_hint_checks_rank_and_returns_its_input(reference):
    x = torch.zeros((2, 3))
    assert sharding.hint(x, "batch") is x           # no mesh: no check
    with sharding.use_mesh(_Mesh((2,), ("data",)), sharding.DEFAULT_RULES):
        assert sharding.hint(x, "batch", None) is x
        with pytest.raises(ValueError) as e:
            sharding.hint(x, "batch")
    assert str(e.value).split(":")[0] == reference["hint_error"]


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_rules_match_reference(reference, arch):
    cfg = get_reduced(arch)
    for m, (shape, names) in MESHES.items():
        mesh = _Mesh(shape, names)
        got = {f"{kind}/{carry}": sh.arch_rules(cfg, mesh, kind, carry)
               for kind in ("train", "prefill", "decode")
               for carry in (False, True)}
        got = json.loads(json.dumps(got))            # tuples as lists
        assert got == reference["rules"][f"{m}/{arch}/True"], m


@pytest.mark.parametrize("arch", ARCHS)
def test_params_shardings_match_reference_every_leaf(reference, models,
                                                      arch):
    for reduced in (True, False):
        model = models[(arch, reduced)]
        names = convert.name_map(model)
        params = dict(model.named_parameters())
        for m, (shape, axes) in MESHES.items():
            mesh = _Mesh(shape, axes)
            got = sh.params_shardings(model.cfg, params, mesh,
                                      sh.arch_rules(model.cfg, mesh))
            want = reference["params"][f"{m}/{arch}/{reduced}"]
            assert {path for path, _ in names.values()} == set(want)
            for name, spec in got.items():
                path, r = names[name]
                assert _lists(spec) == (want[path] if r is None
                                        else want[path][1:]), \
                    (m, reduced, name, spec, want[path])


def test_batch_and_opt_state_shardings_match_reference(reference, models):
    batch = {k: torch.empty(s, device="meta") for k, s in BATCH.items()}
    model = models[("gemma_2b", True)]
    names = convert.name_map(model)
    for m, (shape, axes) in MESHES.items():
        mesh = _Mesh(shape, axes)
        got = sh.batch_shardings(batch, mesh, sharding.DEFAULT_RULES)
        assert {k: _lists(v) for k, v in got.items()} \
            == reference["batch"][m], m
        specs = sh.params_shardings(model.cfg,
                                    dict(model.named_parameters()), mesh,
                                    sh.arch_rules(model.cfg, mesh))
        got = sh.opt_state_shardings(specs)
        want = reference["opt"][m]
        assert _lists(got["step"]) == want["step"]
        for key in ("master", "m", "v"):
            for name, spec in got[key].items():
                path, r = names[name]
                w = want[f"{key}.{path}"]
                assert _lists(spec) == (w if r is None else w[1:]), \
                    (m, key, name)


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shardings_match_reference(reference, models, arch):
    """Each layer's cache leaf against the reference's stacked leaf of its
    stage (``stages.<i>.<j>.<key>``), without the "layers" entry."""
    model = models[(arch, True)]
    cache = model.init_cache(8, 32)
    if model.cfg.encoder is not None:
        cache["enc_out"] = torch.empty(
            (8, model.cfg.encoder.n_frames, model.cfg.d_model),
            device="meta")
    layer_of = [(i, j) for i, (sigs, reps) in enumerate(plan_stages(
        model.cfg)) for _ in range(reps) for j in range(len(sigs))]
    for m, (shape, axes) in MESHES.items():
        mesh = _Mesh(shape, axes)
        got = sh.cache_shardings(cache, mesh,
                                 sh.arch_rules(model.cfg, mesh, "decode"))
        want = reference["cache"][f"{m}/{arch}/True"]
        for layer, leaves in enumerate(got["layers"]):
            i, j = layer_of[layer]
            for key, spec in leaves.items():
                w = want[f"stages.{i}.{j}.{key}"]
                assert _lists(spec) == w[1:], (m, layer, key, spec, w)
        if model.cfg.encoder is not None:
            assert _lists(got["enc_out"]) == want["enc_out"]
