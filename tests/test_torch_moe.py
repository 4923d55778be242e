"""Port parity: the MoE layer and the models that need it (dbrx, jamba).

The same numpy inputs go through the JAX package's `repro.models.moe` and
`repro_torch.models.moe`, with the reference's weights carried across.
Tolerances:
- routing: gates and mean probabilities within rtol = atol = 1e-5 (the
  softmax in another implementation) and expert ids, slot ranks and the
  top-1 counts exactly, also where every gate ties (zero router weights: the top
  k go to the lowest expert ids, as `lax.top_k` breaks ties);
- `moe_ffn` in f32: output and aux loss within rtol = atol = 1e-5 (f32
  sums in another order);
- the reduced LMs in f32: prefill and decode logits at rtol = atol = 1e-3,
  as tests/test_models.py holds the reference's own prefill and decode;
- `BatchServer.run` on the reduced f32 configs: tokens and stats equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

KEY = jax.random.PRNGKey(5)
TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-3, atol=1e-3)
ARCHS = ("dbrx_132b", "jamba_1_5_large_398b")
POLICIES = ("swp_drop_newest", "cas_keep_top_gate")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch, **moe_over):
    """(reference, port) reduced configs in f32 with MoE overrides."""
    out = []
    for get in (jget_reduced, get_reduced):
        cfg = get(arch).replace(dtype="float32")
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_over)))
    return out


def _port_moe(jp, cfg):
    """The reference's MoE tree in a port `MoE` module."""
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    for name, arr in jax.tree_util.tree_flatten_with_path(jp)[0]:
        path = [k.key for k in name]
        target = p
        for key in path[:-1]:
            target = target[key]
        target[path[-1]].data.copy_(torch.from_numpy(np.array(arr)))
    return p


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_reference(ties):
    """Gates, ids and the aux parts; with zero router weights every gate
    is 1/E and the top k are experts 0..k-1 in both packages."""
    jcfg, cfg = _cfgs("dbrx_132b")
    x = _normal(1, 40, cfg.d_model)
    w = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32) if ties \
        else _normal(2, cfg.d_model, cfg.moe.n_experts)
    jg, ji, (jmp, jc) = jmoe._route(jnp.asarray(x), jnp.asarray(w), jcfg.moe)
    g, i, (mp, c) = tmoe._route(torch.from_numpy(x), torch.from_numpy(w),
                                cfg.moe)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(mp.numpy(), np.asarray(jmp), **TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    if ties:
        assert (i.numpy() == np.arange(cfg.moe.top_k)).all()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ties", ["none", "gates", "all"])
def test_priority_rank_matches_reference(policy, ties):
    """Slot ranks over 64 tokens x top 2 of 4 experts: random gates,
    gates drawn from three values (ties within an expert), and every gate
    equal (ties broken by flat index)."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 4, (64, 2)).astype(np.int32)
    gates = {"none": rng.random((64, 2)),
             "gates": rng.choice([0.25, 0.5, 0.75], (64, 2)),
             "all": np.full((64, 2), 0.5)}[ties].astype(np.float32)
    want = jmoe._priority_rank(jnp.asarray(ids), jnp.asarray(gates), policy,
                               4)
    got = tmoe._priority_rank(torch.from_numpy(ids), torch.from_numpy(gates),
                              policy, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_priority_rank_small_cases():
    """The reference tests' two hand cases (tests/test_moe.py)."""
    ids = torch.tensor([[0, 1], [0, 1], [0, 2]], dtype=torch.int32)
    gates = torch.tensor([[0.9, 0.1], [0.5, 0.5], [0.2, 0.8]])
    assert tmoe._priority_rank(ids, gates, "swp_drop_newest", 4).tolist() \
        == [0, 0, 1, 1, 2, 0]
    ids = torch.tensor([[0], [0], [0]], dtype=torch.int32)
    gates = torch.tensor([[0.1], [0.9], [0.5]])
    assert tmoe._priority_rank(ids, gates, "cas_keep_top_gate").tolist() \
        == [2, 0, 1]


@pytest.mark.parametrize("t,ep", [(1, 1), (64, 1), (3523, 1), (1024, 2),
                                  (7, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_reference(arch, t, ep):
    jcfg, cfg = _cfgs(arch)
    assert tmoe._capacity(t, cfg.moe, ep) == jmoe._capacity(t, jcfg.moe, ep)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch,shared,cf", [
    ("dbrx_132b", 0, 1.25), ("dbrx_132b", 1, 1.25), ("dbrx_132b", 0, 0.5)])
def test_moe_ffn_matches_reference(arch, shared, cf, policy, monkeypatch):
    """f32 on the reduced MoE shapes (4 experts, top 2, d 64, d_ff 128:
    dbrx's and jamba's alike), with a shared expert, and at half
    capacity, where many drop."""
    jcfg, cfg = _cfgs(arch, n_shared_experts=shared, capacity_factor=cf,
                      overflow_policy=policy)
    jp = jmoe.moe_init(KEY, jcfg, jnp.float32)
    p = _port_moe(jp, cfg)
    assert {n for n, _ in p.named_parameters()} == {
        ".".join(k.key for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    x = _normal(4, 2, 24, cfg.d_model)
    want, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ranks = []
    real = tmoe._priority_rank
    monkeypatch.setattr(tmoe, "_priority_rank",
                        lambda *a: ranks.append(real(*a)) or ranks[-1])
    with torch.no_grad():
        got, aux = tmoe.moe_ffn(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0
    cap = tmoe._capacity(x.shape[0] * x.shape[1], cfg.moe, 1)
    assert bool((ranks[0] < cap).all()) == (cf > 1)  # half capacity drops


def test_moe_ffn_bf16_matches_reference():
    """The reduced dbrx MoE in bf16 (the served dtype): within 2e-2, one
    bf16 rounding of outputs up to about 1."""
    jcfg, cfg = _cfgs("dbrx_132b")
    jcfg, cfg = (c.replace(dtype="bfloat16") for c in (jcfg, cfg))
    jp = jmoe.moe_init(KEY, jcfg, jnp.bfloat16)
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    for name in ("router", "w1", "w3", "w2"):
        p[name].data.copy_(torch.from_numpy(np.array(
            jp[name], np.float32)).to(p[name].dtype))
    x = _normal(6, 2, 16, cfg.d_model)
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    with torch.no_grad():
        got, _ = tmoe.moe_ffn(p, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the models and the server
# ---------------------------------------------------------------------------

_REF = {}


def _ref_lm(arch):
    """(reference model, its params, the port's LM on its weights, the
    tokens, the reference's prefill and four decode logits), once per
    arch."""
    if arch not in _REF:
        jcfg, cfg = _cfgs(arch)
        jmodel = jbuild(jcfg, attn_impl="ref", remat_policy="none",
                        loss_chunk=64)
        jparams = jmodel.init(KEY)
        model = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                 (2, 24)).astype(np.int32)
        jcache, jl = jmodel.prefill(jparams, {"tokens": jnp.asarray(
            toks[:, :20])}, s_max=24)
        want = [np.asarray(jl)]
        for t in range(20, 24):
            jcache, jl = jmodel.decode_step(
                jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
            want.append(np.asarray(jl))
        _REF[arch] = (jmodel, jparams, model, toks, want)
    return _REF[arch]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_prefill_and_decode_match_reference(arch, use_kernel):
    """Reduced dbrx (2 MoE layers) and jamba (8 layers: SSD and attention
    without positions, MoE and dense channels, in a periodic super-block)
    in f32: a 20-token prompt into 24-row caches, then four decode
    steps; through the kernels' wrappers (their plain versions on the
    CPU) and the plain paths."""
    _, _, model, toks, want = _ref_lm(arch)
    cfg = model.cfg
    model.use_kernel = use_kernel
    kinds = {(b.kind, b.is_moe) for b in model.blocks}
    if arch.startswith("jamba"):
        assert cfg.pos_emb == "none"
        assert kinds == {("attn", False), ("ssm", True), ("ssm", False)}
    else:
        assert kinds == {("attn", True)}
    cache, logits = model.prefill(
        {"tokens": torch.from_numpy(toks[:, :20]).long()}, s_max=24)
    np.testing.assert_allclose(logits.numpy(), want[0], **LM_TOL)
    for t in range(20, 24):
        cache, logits = model.decode_step(
            cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(logits.numpy(), want[t - 19], **LM_TOL)


def test_backbone_sums_the_moe_aux_loss():
    """`_backbone` returns the sum of the MoE layers' aux losses, as the
    reference's (which the training slice reads)."""
    jmodel, jparams, model, _, _ = _ref_lm("dbrx_132b")
    toks = np.random.default_rng(7).integers(0, model.cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    x = jmodel._embed_in(jparams, {"tokens": jnp.asarray(toks)}, 0)
    _, _, jaux = jmodel._backbone(jparams, x, caches=None, enc_out=None,
                                  positions3=None)
    with torch.no_grad():
        _, _, aux = model._backbone(model._embed_in(
            {"tokens": torch.from_numpy(toks).long()}), caches=None)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_dense_blocks_add_no_aux_loss():
    """A model without MoE allocates no aux loss: its blocks return None
    and `_backbone` sums nothing, so serving launches nothing for it."""
    cfg = get_reduced("gemma_2b").replace(dtype="float32")
    model = tmodel.LM(cfg, device="cpu", seed=0)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        x = model._embed_in({"tokens": toks})
        assert all(b(x)[2] is None for b in model.blocks)
        _, _, aux = model._backbone(x, caches=None)
    assert aux is None


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_matches_reference(arch, monkeypatch):
    """`BatchServer.run` on the reduced f32 config with the reference's
    weights, 2 slots and 3 requests of 5 and 12 tokens (the reference
    compiles a prefill for each length): the same stats and greedy tokens
    as the reference's server; no kernel launch on the CPU."""
    jcfg, cfg = _cfgs(arch)
    monkeypatch.setattr(jserve, "get_reduced", lambda a: jcfg)
    monkeypatch.setattr(tserve, "get_reduced", lambda a: cfg)
    jsrv = jserve.BatchServer(arch, slots=2, s_max=64, seed=0)
    tsrv = tserve.BatchServer(arch, slots=2, s_max=64, seed=0, device="cpu")
    convert.lm_params_from_reference(jax.tree.map(np.asarray, jsrv.params),
                                     cfg, model=tsrv.model)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 12, 12)]
    jreqs = [jserve.Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    treqs = [tserve.Request(rid=i, prompt=p, max_new=5)
             for i, p in enumerate(prompts)]
    jstats = jsrv.run(jreqs)
    FK.reset_launches()
    SK.reset_launches()
    tstats = tsrv.run(treqs)
    assert FK.LAUNCHES == {"flash_attention": 0}
    assert set(SK.LAUNCHES.values()) == {0}
    for k in ("requests", "tokens", "completed"):
        assert tstats[k] == jstats[k], k
    assert [r.out for r in treqs] == [r.out for r in jreqs]
