"""The dry run (`repro_torch.launch.dryrun`), its recording mesh and its
roofline (`repro_torch.benchmarks.roofline`) against the reference's.

The reference's `repro.launch.dryrun` appends 512 placeholder devices to
``XLA_FLAGS`` when it is imported unless ``REPRO_DRYRUN_NO_DEVICE_OVERRIDE``
is set: the module fixture sets it for the import only, so the worker keeps
its one CPU device.  Its parts that need no lowering (`input_specs`,
`default_microbatches`, `_moment_dtype`, the model-FLOPs formula) are held
against the port's for every (arch, cell) of both production meshes; its
production mesh's shape and axes through a stand-in for ``jax.make_mesh``;
`hlo_stats.collective_bytes_from_hlo` on one HLO line of each collective
against what the port's recording mesh counts; the roofline row on the
reference's constants; and the FLOPs the port counts on a reduced config's
train step against `analyze_hlo` of the reference's compiled step.
"""

import importlib
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.benchmarks import render_experiments
from repro_torch.benchmarks import roofline as troof
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell, cells_for,
                                 get_config, get_reduced)
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import (RecordingMesh, make_production_mesh,
                                     wire_bytes)

ALL_CELLS = [(a, s) for a in ARCH_IDS for s in cells_for(a)]


@pytest.fixture(scope="module")
def ref():
    """`repro.launch.dryrun`, imported without its device override."""
    had = os.environ.get("REPRO_DRYRUN_NO_DEVICE_OVERRIDE")
    os.environ["REPRO_DRYRUN_NO_DEVICE_OVERRIDE"] = "1"
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if had is None:
            del os.environ["REPRO_DRYRUN_NO_DEVICE_OVERRIDE"]


def _jax_cell(shape):
    from repro.configs import SHAPES as JSHAPES
    return next(s for s in JSHAPES if s.name == shape.name)


@pytest.mark.parametrize("arch,shape", ALL_CELLS,
                         ids=[f"{a}.{s.name}" for a, s in ALL_CELLS])
def test_cell_arithmetic_matches_reference(ref, arch, shape):
    """Input specs (shapes and dtypes), microbatches on both production
    meshes, the moment dtype and the model FLOPs of every cell."""
    from repro.configs import get_config as jget
    jcfg, cfg = jget(arch), get_config(arch)
    jcell = _jax_cell(shape)
    want = ref.input_specs(jcfg, jcell)
    got = D.input_specs(cfg, shape)
    assert list(got) == list(want)
    for k, spec in got.items():
        assert spec.shape == tuple(want[k].shape), k
        assert str(spec.dtype).replace("torch.", "") == \
            jnp.dtype(want[k].dtype).name, k
    for n_data in (16, 32):          # single and multi: chips / "model"
        assert D.default_microbatches(cfg, shape, n_data) == \
            ref.default_microbatches(jcfg, jcell, n_data)
    assert D._moment_dtype(cfg) == ref._moment_dtype(jcfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    assert D.model_flops_global(cfg, shape) == \
        mult * jcfg.active_param_count() * tokens


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_reference(monkeypatch, multi_pod):
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    assert make_production_mesh(multi_pod=multi_pod) == \
        jmesh.make_production_mesh(multi_pod=multi_pod)


_HLO = """HloModule m

ENTRY %main (p: f32[1024]) -> f32[4096] {
  %p = f32[1024]{0} parameter(0)
  ROOT %c = LINE
}
"""
#: (port call on a 4 x 4 mesh over "model", its HLO line, group of 4)
_COLLECTIVES = {
    "all-gather": (lambda m, x: m.all_gather(x, "model"),
                   "f32[4096]{0} all-gather(f32[1024]{0} %p), "
                   "replica_groups=[4,4]<=[16], dimensions={0}"),
    "reduce-scatter": (lambda m, x: m.reduce_scatter(x, "model"),
                       "f32[256]{0} reduce-scatter(f32[1024]{0} %p), "
                       "replica_groups=[4,4]<=[16], dimensions={0}, "
                       "to_apply=%add"),
    "all-reduce": (lambda m, x: m.all_reduce(x, "model"),
                   "f32[1024]{0} all-reduce(f32[1024]{0} %p), "
                   "replica_groups=[4,4]<=[16], to_apply=%add"),
    "all-to-all": (lambda m, x: m.all_to_all(x.reshape(4, 256), "model"),
                   "f32[1024]{0} all-to-all(f32[1024]{0} %p), "
                   "replica_groups=[4,4]<=[16], dimensions={0}"),
    "collective-permute": (lambda m, x: m.broadcast(x, "model"),
                           "f32[1024]{0} collective-permute(f32[1024]{0} "
                           "%p), source_target_pairs={{0,1},{1,2}}"),
}


@pytest.mark.parametrize("kind", sorted(_COLLECTIVES))
def test_recorded_wire_bytes_match_hlo_stats(kind):
    """One collective of 1,024 f32 over a group of 4: the recording mesh's
    wire bytes equal `hlo_stats.collective_bytes_from_hlo` on the same
    collective's HLO line."""
    from repro.launch.hlo_stats import collective_bytes_from_hlo
    call, line = _COLLECTIVES[kind]
    stats = collective_bytes_from_hlo(_HLO.replace("LINE", line), world=16)
    mesh = RecordingMesh((4, 4), ("data", "model"))
    out = call(mesh, torch.zeros(1024))
    (got_kind, n, wire, link), = mesh.calls
    assert got_kind == kind
    assert wire == stats[kind]["wire_bytes"] == stats["total_wire_bytes"]
    assert (n, link) == (4, "nvlink")
    assert out.dtype == torch.float32 and out.numel() in (256, 1024, 4096)
    assert mesh.summary()["collectives"] == {
        kind: {"count": 1, "wire_bytes": wire}}


def test_recording_mesh_links_and_groups():
    """A group inside one node of 8 consecutive ranks rides NVLink, any
    other InfiniBand; the world gather counts every rank; the summary's
    totals add up."""
    mesh = RecordingMesh((16, 16), ("data", "model"), rank=17)
    assert mesh.coords == {"data": 1, "model": 1}
    x = torch.zeros(64)
    mesh.all_gather(x, "model")          # ranks 16..31: two nodes
    mesh.all_reduce(x, "data")           # ranks 1, 17, ...: sixteen nodes
    mesh.all_gather_world(x)
    small = RecordingMesh((2, 4), ("data", "model"))
    small.all_reduce(x, ("data", "model"))
    assert [c[3] for c in mesh.calls] == ["ib", "ib", "ib"]
    assert [c[1] for c in mesh.calls] == [16, 16, 256]
    assert small.calls[0][3] == "nvlink"
    s = mesh.summary()
    assert s["total_wire_bytes"] == sum(c[2] for c in mesh.calls)
    assert s["wire_bytes_by_link"] == {"ib": s["total_wire_bytes"]}
    assert wire_bytes("all-reduce", 4, 100, 100) == 150.0


def test_roofline_row_matches_reference_on_its_constants():
    """The reference's `roofline_row` on a record of its form, and the
    port's given the reference's TPU constants and its 16 GB card."""
    import benchmarks.roofline as jroof
    rec = {"arch": "a", "shape": "s", "mesh": "single", "chips": 256,
           "dot_flops": 3.0e15, "dot_bytes": 4.0e12, "result_bytes": 1e12,
           "total_wire_bytes": 6.0e10, "model_flops_global": 1e17,
           "per_device_peak_bytes": 12e9}
    for r in (rec, {**rec, "dot_bytes": 0}, {**rec, "dot_flops": 1e12},
              {**rec, "per_device_peak_bytes": 20e9}):
        want = jroof.roofline_row(r)
        got = troof.roofline_row(r, peak_flops=jroof.PEAK_FLOPS,
                                 hbm_bw=jroof.HBM_BW,
                                 links={"ib": jroof.LINK_BW},
                                 card_bytes=16e9)
        for k, v in want.items():
            assert got["fits_80g" if k == "fits_16g" else k] == v, k
    assert troof.roofline_row({"arch": "a"}) is None


def test_roofline_takes_each_link_at_its_rate(tmp_path, capsys):
    rec = {"arch": "a", "shape": "train_4k", "mesh": "single", "chips": 256,
           "status": "ok", "dot_flops": 989e12, "dot_bytes": 0,
           "result_bytes": 0, "model_flops_global": 256 * 989e12,
           "per_device_peak_bytes": 90e9, "total_wire_bytes": 500e9,
           "wire_bytes_by_link": {"nvlink": 450e9, "ib": 50e9}}
    row = troof.roofline_row(rec)
    assert row["t_compute_s"] == pytest.approx(1.0)
    assert row["t_collective_s"] == pytest.approx(2.0)
    assert (row["dominant"], row["links"]) == ("collective", "ib+nvlink")
    assert row["roofline_fraction"] == pytest.approx(0.5)
    assert not row["fits_80g"]
    import json
    (tmp_path / "a.train_4k.single.baseline.json").write_text(
        json.dumps(rec))
    (tmp_path / "b.train_4k.single.baseline.json").write_text(
        json.dumps({"status": "fail"}))
    assert [r["arch"] for r in troof.table(str(tmp_path))] == ["a"]
    render_experiments.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| a | train_4k | - | - | - | 90.0 | N |" in out
    assert "| collective |" in out


def test_live_bytes_are_exact_on_a_hand_counted_chain():
    """Every storage counts from the op that makes it until it is freed;
    a view makes none; in-place writes and matmuls count their bytes."""
    with FakeTensorMode():
        live = D.LiveBytes()
        with live:
            a = torch.empty(1024, device="meta")            # 4 KiB
            b = a * 2                                        # 8 KiB live
            c = b.view(32, 32)                               # no storage
            del b
            assert live.live == 8192                         # b via c
            del c
            assert live.live == 4096
            d = a + 1
            e = d + 1                                        # a, d, e
            del d
            f = e + 1                                        # a, e, f
            assert (live.live, live.peak) == (12288, 12288)
            f.add_(1)                                        # in place
            x = torch.empty(64, 32, device="meta")
            y = torch.empty(32, 16, device="meta")
            z = x @ y
            assert live.dot_bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)
            del a, e, f, x, y, z
            assert live.live == 0
    mats = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert live.peak == 3 * 4096 + mats                 # a, e, f, x, y, z
    # a, b, d, e, f made; f written in place; x, y, z made
    assert live.result_bytes == 5 * 4096 + 4096 + mats


def _fake_wrapper_calls(dev):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmw import kernel as RK
    from repro_torch.kernels.serial import kernel as XK
    from repro_torch.kernels.ssd import kernel as SK
    tab = torch.zeros(64, device=dev)
    idx = torch.zeros(128, dtype=torch.int32, device=dev)
    val = torch.ones(128, device=dev)
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 1, 16, 64), dtype=torch.bfloat16, device=dev)
    xdt = torch.zeros((2, 64, 64), device=dev)
    words = torch.zeros(64, dtype=torch.int32, device=dev)
    cycle = XK.Cycle(words=words, a=5, c=1)
    return {
        "rmw_table": (lambda: RK.rmw_table(tab, idx, val, "faa"), [(64,)]),
        "rmw_table_fetched": (lambda: RK.rmw_table_fetched(
            tab, idx, val, "cas", expected=0.0), [(64,), (128,), (128,)]),
        "slot_counts": (lambda: RK.slot_counts(idx, 64), [(64,)]),
        "table_combine": (lambda: RK.table_combine(
            tab.clone(), idx, val, "faa", "windows", window=40, depth=32),
            [(64,)]),
        "flash_attention": (lambda: FK.flash_attention(q, k, k),
                            [(1, 4, 8, 64)]),
        "kernel_bf16_parts": (lambda: FK.kernel_bf16_parts(
            torch.zeros((3, 5), device=dev)), [(3, 5)] * 3),
        "ssd_chunk": (lambda: SK.ssd_chunk(
            xdt, torch.zeros((2, 64), device=dev),
            torch.zeros((2, 64, 32), device=dev),
            torch.zeros((2, 64, 32), device=dev), chunk=64),
            [(2, 64, 64), (2, 1, 32, 64)]),
        "serial_rmw": (lambda: XK.serial_rmw(tab, idx, val, "faa"),
                       [(64,), (128,), (128,)]),
        "chase": (lambda: XK.chase(cycle, 10, "faa"), [(1,)]),
    }


def test_fake_tensor_call_of_every_wrapper_launches_nothing():
    """Every kernel wrapper given fake tensors (the dry run's) returns
    outputs of the right shapes, launches nothing, counts nothing and
    builds no library."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rmw import kernel as RK
    from repro_torch.kernels.serial import kernel as XK
    from repro_torch.kernels.ssd import kernel as SK
    libs = (RK.LIBRARY, FK.LIBRARY, XK.LIBRARY, SK.LIBRARY)
    for mod in (RK, FK, XK, SK):
        mod.reset_launches()
    with FakeTensorMode():
        calls = _fake_wrapper_calls("meta")
        for name, (call, shapes) in calls.items():
            out = call()
            outs = out if isinstance(out, tuple) else (out,)
            assert [tuple(t.shape) for t in outs] == shapes, name
    assert all(v == 0 for mod in (RK, FK, XK, SK)
               for v in mod.LAUNCHES.values())
    assert all(lib._built is None for lib in libs)


def test_reduced_cells_of_every_family_run():
    """Train (sharded, on a 2 x 2 recording mesh, remat ``full``),
    prefill and decode cells of reduced configs of every family: each
    counts FLOPs and a peak, train cells and the sharded serving cells
    (`serve_layout`: every config's here, whisper_small's encoder and
    cross-attention included) exchange and the whole-parameter serving
    cells do not, and a train cell's MoE layers recompute their training
    variant in backward."""
    mesh = ((2, 2), ("data", "model"))
    for arch in ("gemma_2b", "dbrx_132b", "mamba2_780m", "whisper_small"):
        cfg = get_reduced(arch)
        for cell in (ShapeCell("t", 64, 8, "train"),
                     ShapeCell("p", 64, 4, "prefill"),
                     ShapeCell("d", 64, 4, "decode")):
            rec = D.run_cell(arch, cell, False, cfg=cfg, mesh_shape=mesh)
            assert rec["dot_flops"] > 0 and rec["per_device_peak_bytes"] > 0
            layout = ("sharded_train" if cell.kind == "train"
                      else D.serve_layout(cfg)[0])
            assert rec["layout"] == layout
            assert (rec["total_wire_bytes"] > 0) == (
                layout != "serve_whole_params")
            if cell.kind == "train" and cfg.moe is not None:
                assert "all-to-all" in rec["collectives"]


def test_record_written_with_status(tmp_path, monkeypatch):
    """`run_and_write` writes a record a cell: ``ok``, or the error that
    stopped it (a depth cut keeps the full config's microbatches)."""
    import json
    monkeypatch.setattr(D, "get_config", get_reduced)
    cell = ShapeCell("train_4k", 64, 32, "train")
    ok = D.run_and_write("gemma_2b", cell, False, str(tmp_path),
                         overrides={"n_layers": 1})
    assert ok["status"] == "ok" and ok["layers_run"] == 1
    assert ok["microbatches"] == D.default_microbatches(
        get_reduced("gemma_2b"), cell, 16)
    bad = D.run_and_write("gemma_2b", cell, False, str(tmp_path),
                          overrides={"microbatches": 3})
    assert bad["status"] == "fail" and "microbatches" in bad["error"]
    with open(D.record_path(str(tmp_path), "gemma_2b", "train_4k",
                            "single")) as f:
        assert json.load(f)["status"] == "fail"


@pytest.mark.parametrize("arch", ["gemma_2b", "dbrx_132b", "mamba2_780m"])
def test_dot_flops_match_reference_compiled_step(ref, arch):
    """The FLOPs `FlopCounterMode` counts in a reduced config's train step
    on a 1-device mesh, against `analyze_hlo` of the reference's compiled
    step (both remat ``full``, chunked attention, one microbatch).  The
    port's count is within 5% above: it recomputes each loss chunk's
    logits in backward (the chunk is checkpointed), one head product, 2 B
    S d V, that XLA's compiled step does not repeat; for gemma_2b that is
    the whole gap, exactly."""
    from repro.configs import get_reduced as jred
    from repro.launch.hlo_stats import analyze_hlo
    from repro.launch.steps import abstract_train_state, make_train_step
    from repro.models.model import build_model
    from repro.optim.adamw import AdamWConfig
    s, b = 64, 4
    jcfg = jred(arch)
    model = build_model(jcfg, attn_impl="chunked", remat_policy="full",
                        loss_chunk=2048)
    opt = AdamWConfig(moment_dtype=ref._moment_dtype(jcfg))
    params, state = abstract_train_state(model, opt)
    batch = ref.input_specs(jcfg, ShapeCell("t", s, b, "train"))
    hlo = jax.jit(make_train_step(model, opt, microbatches=1)).lower(
        params, state, batch).compile().as_text()
    want = analyze_hlo(hlo, world=1)["dot_flops"]
    cfg = get_reduced(arch)
    got = D.run_cell(arch, ShapeCell("t", s, b, "train"), False, cfg=cfg,
                     mesh_shape=((1, 1), ("data", "model")),
                     overrides={"microbatches": 1})["dot_flops"]
    assert want <= got <= 1.05 * want
    if arch == "gemma_2b":
        assert got - want == 2 * b * s * cfg.d_model * cfg.vocab_size


def test_shapes_cover_the_reference():
    from repro.configs import SHAPES as JSHAPES
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in JSHAPES]
    assert math.prod(make_production_mesh()[0]) == 256


def test_remat_recompute_in_another_thread_sees_the_forwards_mesh(
        monkeypatch):
    """On the card autograd runs backward in its device thread, where no
    `use_mesh` and no `moe.training_blocks` are in force; a checkpointed
    block must recompute the expert-parallel variant its forward ran.
    Backward moved into a fresh thread stands in for that here."""
    import threading

    from repro_torch.launch import steps
    grad = torch.autograd.grad

    def in_a_thread(*args, **kwargs):
        out = {}
        t = threading.Thread(target=lambda: out.update(g=grad(*args,
                                                              **kwargs)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and "g" in out
        return out["g"]
    monkeypatch.setattr(steps.torch.autograd, "grad", in_a_thread)
    rec = D.run_cell("dbrx_132b", ShapeCell("t", 64, 8, "train"), False,
                     cfg=get_reduced("dbrx_132b"),
                     mesh_shape=((2, 2), ("data", "model")))
    assert "all-to-all" in rec["collectives"]


@pytest.mark.parametrize("arch,shape,reason", [
    ("mamba2_780m", "prefill_32k", None),
    ("mamba2_780m", "decode_32k", None),
    ("mamba2_780m", "long_500k", None),
    ("jamba_1_5_large_398b", "prefill_32k", None),
    ("jamba_1_5_large_398b", "decode_32k", None),
    ("jamba_1_5_large_398b", "long_500k", "sequence cut"),
    # refused before MLA's latent cache and cross-attention were cut
    pytest.param("deepseek_v3_671b", "decode_32k", None,
                 id="deepseek_v3_671b-decode_32k-MLA"),
    pytest.param("whisper_small", "decode_32k", None,
                 id="whisper_small-decode_32k-cross-attention"),
])
def test_serve_layout_of_mamba_hybrid_and_refused_cells(arch, shape,
                                                        reason):
    """`serve_layout` per cell: mamba2_780m and jamba served sharded (the
    state cut by heads), mamba2_780m's long_500k too (batch whole, state
    by heads), deepseek_v3 (MLA's latent cache cut by sequence) and
    whisper_small (cross-attention on the rank's heads) too; only jamba's
    long_500k waits for the KV cache's sequence cut over ("data",
    "model"), with whole parameters."""
    layout, why = D.serve_layout(get_config(arch), shape)
    if reason is None:
        assert (layout, why) == ("sharded_serve", None)
    else:
        assert layout == "serve_whole_params"
        assert reason in why and "later slice" in why


@pytest.mark.parametrize("arch", ["mamba2_780m", "jamba_1_5_large_398b"])
def test_long_500k_cells_of_reduced_ssm_configs(arch):
    """A reduced long_500k decode cell on (2, 2): mamba2_780m's runs the
    sharded decode step under the long-context rules (collectives
    recorded), jamba's whole parameters and no mesh."""
    cell = ShapeCell("long_500k", 64, 1, "decode")
    rec = D.run_cell(arch, cell, False, cfg=get_reduced(arch),
                     mesh_shape=((2, 2), ("data", "model")))
    assert rec["rules"]["batch"] == "None"
    if arch == "mamba2_780m":
        assert rec["layout"] == "sharded_serve"
        assert rec["total_wire_bytes"] > 0
    else:
        assert rec["layout"] == "serve_whole_params"
        assert rec["collectives"] == {}


@pytest.mark.parametrize("arch", ["dbrx_132b", "jamba_1_5_large_398b"])
def test_moe_train_cell_partitioned_counts_less(arch):
    """A reduced MoE config's train cell on (2, 2): partitioned (its
    attention, dense MLPs, Mamba mixers and vocabulary on the "model"
    cut), it counts fewer FLOPs, matmul bytes and peak bytes a card than
    unpartitioned on the same blocks."""
    cell = ShapeCell("t", 64, 8, "train")
    part, whole = (D.run_cell(arch, cell, False, {"partitioned": p},
                              cfg=get_reduced(arch),
                              mesh_shape=((2, 2), ("data", "model")))
                   for p in (True, False))
    for key in ("dot_flops", "dot_bytes", "per_device_peak_bytes"):
        assert part[key] < whole[key], key
