"""Port parity: the RMW kernel wrappers (`repro_torch.kernels.rmw`).

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version against the JAX package — the Pallas kernels in interpret mode
for fp32 at the reference tests' tolerance (tests/test_kernels_rmw.py:31),
the JAX oracles bit for bit for int32.  The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_gpu.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gpu import collision_heavy, same, same_bits, zeros_and_nans
from repro.core import rmw as jrmw
from repro.kernels.rmw import ops as jops
from repro.kernels.rmw import ref as jref
from repro_torch.core import rmw as trmw
from repro_torch.kernels.rmw import kernel as K
from repro_torch.kernels.rmw import ops as tops
from repro_torch.kernels.rmw import ref as tref

RNG = np.random.default_rng(7)
OPS4 = ["faa", "min", "max", "swp"]
# (table, n_ops, table_tile, block): two cases of the reference SWEEP
SWEEP = [(512, 1024, 512, 1024), (700, 3000, 512, 1024)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("op", OPS4)
@pytest.mark.parametrize("m,n,tile,block", SWEEP)
def test_rmw_apply_fp32_matches_pallas_interpret(op, m, n, tile, block):
    table = RNG.normal(size=m).astype(np.float32)
    idx = RNG.integers(0, m + 7, n).astype(np.int32)   # some dropped
    vals = RNG.normal(size=n).astype(np.float32)
    want = jops.rmw_apply(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(vals), op, table_tile=tile, block=block)
    got = tops.rmw_apply(_t(table), _t(idx), _t(vals), op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", OPS4)
def test_rmw_table_int32_matches_reference(op):
    table = RNG.integers(-9, 10, 300).astype(np.int32)
    idx = collision_heavy(RNG, 2000, 310)
    vals = RNG.integers(-9, 10, 2000).astype(np.int32)
    want = jref.rmw_table_ref(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(vals), op)
    same(K.rmw_table(_t(table), _t(idx), _t(vals), op), want)
    same(tref.rmw_table_ref(_t(table), _t(idx), _t(vals), op), want)


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_rmw_table_fetched_int32_matches_reference(op):
    """Vectorised plain version and the serialized port oracle, both
    bit-equal to the JAX drop-aware oracle."""
    m, n = 41, 600
    lo, hi = (-1, 2) if op == "cas" else (-8, 9)
    table = RNG.integers(lo, hi, m).astype(np.int32)
    idx = collision_heavy(RNG, n, m + 9)
    vals = RNG.integers(lo, hi, n).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jref.rmw_table_fetched_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        None if exp is None else jnp.int32(exp))
    for fn in (lambda *a: K.rmw_table_fetched(*a[:4], expected=a[4]),
               tref.rmw_table_fetched_ref):
        t, f, s = fn(_t(table), _t(idx), _t(vals), op, exp)
        same(t, want[0], "table")
        same(f, want[1], "fetched")
        same(s, want[2], "success")


@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_rmw_apply_fetched_fp32_matches_pallas_interpret(op):
    """Integer-valued fp32: every partial sum exact, so bit-equal."""
    m, n = 256, 384
    lo, hi = (-1, 2) if op == "cas" else (-8, 9)
    table = RNG.integers(lo, hi, m).astype(np.float32)
    idx = collision_heavy(RNG, n, m + 9)
    vals = RNG.integers(lo, hi, n).astype(np.float32)
    exp = 0.0 if op == "cas" else None
    want = jops.rmw_apply_fetched(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        expected=None if exp is None else jnp.float32(exp),
        table_tile=128, block=128)
    got = tops.rmw_apply_fetched(_t(table), _t(idx), _t(vals), op,
                                 expected=exp)
    same(got.table, want.table, "table")
    same(got.fetched, want.fetched, "fetched")
    same(got.success, want.success, "success")


def test_rmw_apply_fetched_fp32_normal_faa_close():
    m, n = 128, 1024
    table = RNG.normal(size=m).astype(np.float32)
    idx = collision_heavy(RNG, n, m)
    vals = RNG.normal(size=n).astype(np.float32)
    want = jops.rmw_apply_fetched(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(vals), "faa", table_tile=128,
                                  block=512)
    got = tops.rmw_apply_fetched(_t(table), _t(idx), _t(vals), "faa")
    for g, w in ((got.table, want.table), (got.fetched, want.fetched)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    same(got.success, want.success)


@pytest.mark.parametrize("op", ["min", "max"])
def test_plain_versions_fp32_minmax_signed_zeros_and_nan(op):
    """The plain versions of `rmw_table` and `rmw_table_fetched` (and the
    wrappers on CPU tensors, which run them) with ±0 and NaN in the table
    and the operands and repeated slots, against the reference's oracle
    on the kept ops: NaN by isnan, every other value bit for bit; dropped
    ops fetch 0 and fail."""
    rng = np.random.default_rng(17 if op == "min" else 19)
    m, n = 61, 300
    table, vals = zeros_and_nans(rng, m), zeros_and_nans(rng, n)
    idx = collision_heavy(rng, n, m + 4)
    keep = idx < m
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx[keep]),
                               jnp.asarray(vals[keep]), op)
    args = (_t(table), _t(idx), _t(vals), op)
    for name, tab in (("rmw_table_ref", tref.rmw_table_ref(*args)),
                      ("rmw_table", K.rmw_table(*args))):
        same_bits(tab, want.table, name)
    for name, fn in (("rmw_table_fetched", K.rmw_table_fetched),
                     ("rmw_table_fetched_plain", K.rmw_table_fetched_plain),
                     ("rmw_table_fetched_ref", tref.rmw_table_fetched_ref)):
        tab, fetched, success = fn(*args)
        same_bits(tab, want.table, f"{name} table")
        same_bits(fetched[_t(keep)], want.fetched, f"{name} fetched")
        same_bits(fetched[_t(~keep)], np.zeros(int((~keep).sum()),
                                               np.float32))
        same(success, keep, f"{name} success")


def test_slot_occupancy_matches_reference():
    idx = RNG.integers(-3, 1100, 5000).astype(np.int32)
    want = jops.slot_occupancy(jnp.asarray(idx), 1000)
    got = tops.slot_occupancy(_t(idx), 1000)
    assert got.dtype == torch.int32
    same(got, want)


def test_histogram_is_faa_counter():
    idx = RNG.integers(0, 64, 5000).astype(np.int32)
    got = tops.histogram(_t(idx), 64)
    same(got, jref.histogram_ref(jnp.asarray(idx), 64))
    same(tref.histogram_ref(_t(idx), 64), np.asarray(got))
    assert float(got.sum()) == 5000


def test_out_of_range_dropped():
    table = torch.zeros(128, dtype=torch.float32)
    idx = torch.tensor([0, 127, 128, 10_000], dtype=torch.int32)
    vals = torch.ones(4, dtype=torch.float32)
    assert float(tops.rmw_apply(table, idx, vals, "faa").sum()) == 2.0
    res = tops.rmw_apply_fetched(table, torch.tensor([0, 0, 127, 128, 10_000],
                                                     dtype=torch.int32),
                                 torch.arange(1, 6, dtype=torch.float32))
    assert float(res.table.sum()) == 6.0
    same(res.fetched, [0.0, 1.0, 0.0, 0.0, 0.0])
    same(res.success, [True, True, True, False, False])


def test_cpu_runs_plain_versions_and_counts_no_launch():
    K.reset_launches()
    t = torch.zeros(8, dtype=torch.int32)
    i = torch.tensor([1, 2, 2], dtype=torch.int32)
    K.rmw_table(t, i, i, "faa")
    K.rmw_table_fetched(t, i, i, "cas", expected=0)
    K.slot_counts(i, 8)
    assert K.LAUNCHES == {"rmw_table": 0, "rmw_table_fetched": 0,
                          "slot_counts": 0}


@pytest.mark.parametrize("call", ["rmw_table", "rmw_table_fetched",
                                  "slot_counts"])
def test_non_cpu_tensor_never_takes_the_plain_version(call):
    """No fallback: a tensor off the CPU launches the kernel or raises."""
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    i = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, TypeError, ValueError)):
        if call == "rmw_table":
            K.rmw_table(t, i, i, "faa")
        elif call == "rmw_table_fetched":
            K.rmw_table_fetched(t, i, i, "faa")
        else:
            K.slot_counts(i, 8)


def test_wrappers_reject_what_the_kernels_do_not_take():
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):     # int64 indices
        K.rmw_table(t, torch.zeros(3, dtype=torch.int64, device="meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):     # values of another type
        K.rmw_table(t, torch.zeros(3, dtype=torch.int32, device="meta"),
                    torch.zeros(3, dtype=torch.float32, device="meta"))
    with pytest.raises(TypeError):     # float64 table
        K.rmw_table_fetched(torch.zeros(8, dtype=torch.float64,
                                        device="meta"),
                            torch.zeros(3, dtype=torch.int32, device="meta"),
                            torch.zeros(3, dtype=torch.float64,
                                        device="meta"))
    with pytest.raises(ValueError):
        K.rmw_table(t, t, t, "cas")


# ---------------------------------------------------------------------------
# The card's table-only kernel, regime by regime, in plain torch
# ---------------------------------------------------------------------------
# `rmw_table` and `slot_counts` run on the card as one kernel in three
# regimes (csrc/rmw.cu, `kernel.table_regime`).  Every op combines 4-byte
# words: the value (FAA, int32 MIN/MAX), 1 (count), an order key (fp32
# MIN/MAX) or a batch position (SWP, into last_pos, then a gather).  `smem`
# cuts the batch into CTA shares, combines each into a private copy that
# starts at the op's identity word, and flushes every slot of each copy
# into the table; `global` and `windows` combine the words straight into
# the table, `windows` one window of slots a pass.  This mirror repeats
# that word arithmetic and is held against the JAX oracles.

# (name, op, dtype, n, m, regime): the shapes the card's tests and smoke
# run take, and each threshold from both sides
I32, F32 = torch.int32, torch.float32
REGIME_SHAPES = [("bfs_n", "faa", I32, 1 << 25, 1 << 20, "global"),
                 ("bfs_n_fp32_min", "min", F32, 1 << 25, 1 << 20, "global"),
                 ("contended", "swp", I32, 1 << 22, 1024, "smem"),
                 ("contended_fp32_max", "max", F32, 1 << 22, 1024, "smem"),
                 ("smem_full", "count", I32, 1 << 22, K.SMEM_SLOTS, "smem"),
                 ("smem_few_ops", "faa", I32, 1 << 20, K.SMEM_SLOTS,
                  "global"),
                 ("32_ops_a_slot", "min", I32, 1 << 15, 1024, "smem"),
                 ("31_ops_a_slot", "min", I32, 31 << 10, 1024, "global"),
                 ("fp32_faa_40000", "faa", F32, 1 << 25, 40_000, "smem"),
                 ("fp32_min_40000", "min", F32, 1 << 25, 40_000, "global"),
                 ("fp32_min_cas_smem", "min", F32, 1 << 25,
                  K.CAS_SMEM_SLOTS, "smem"),
                 ("fp32_min_256_a_slot", "min", F32, 1 << 22, 16_384,
                  "global"),
                 ("m1", "faa", I32, 1 << 20, 1, "smem"),
                 ("one_op", "max", I32, 1, 5, "global"),
                 ("cluster_range", "faa", I32, 1 << 25, 300_000, "global"),
                 ("1.5_windows", "faa", I32, 1 << 25,
                  3 * K.WINDOW_SLOTS // 2, "global"),
                 ("two_windows", "swp", F32, 1 << 25, 2 * K.WINDOW_SLOTS,
                  "windows"),
                 ("two_windows_fp32_min", "min", F32, 1 << 25,
                  2 * K.WINDOW_SLOTS, "global"),
                 ("fp32_min_cas_windows", "min", F32, 1 << 25,
                  K.CAS_WINDOWS_FROM, "windows"),
                 ("uniform_2pow24", "count", I32, 1 << 24, 1 << 24,
                  "windows"),
                 ("windows_ragged", "max", I32, 1 << 22,
                  2 * K.WINDOW_SLOTS + 5, "windows")]


@pytest.mark.parametrize("case,op,dtype,n,m,regime", REGIME_SHAPES,
                         ids=[c[0] for c in REGIME_SHAPES])
def test_table_regime_rule(case, op, dtype, n, m, regime):
    assert K.table_regime(op, dtype, n, m) == regime
    assert regime in K.table_regimes(m)


def _identity_word(op, dtype):
    if op == "min":
        return torch.iinfo(torch.int32).max
    if op == "max":
        return torch.iinfo(torch.int32).min
    if op == "swp":
        return -1
    if op == "faa" and dtype == torch.float32:     # the bits of −0
        return torch.iinfo(torch.int32).min
    return 0


def _combine_words(dst, slot, words, op, dtype):
    """Combine 4-byte words into ``dst`` (int32 words) at ``slot``, in
    place: what the atomics do, in any order."""
    if op == "faa" and dtype == torch.float32:
        f = dst.view(torch.float32)
        f.index_add_(0, slot, words.view(torch.float32))
    elif op in ("faa", "count"):
        dst.index_add_(0, slot, words)
    else:
        dst.scatter_reduce_(0, slot, words,
                            "amin" if op == "min" else "amax")


def _mirror_table(table, idx, vals, op, shares=0, window=None):
    """The kernel's words end to end.  ``shares`` > 0: the smem regime with
    that many CTA shares; else global, in windows of ``window`` slots."""
    m, n = table.shape[0], idx.shape[0]
    dtype = table.dtype
    pos = torch.arange(n, dtype=torch.int32)
    if op == "count":
        words = torch.ones(n, dtype=torch.int32)
    elif op == "swp":
        words = pos
    elif dtype == torch.float32 and op in ("min", "max"):
        words = trmw.order_key(vals, op)
    else:
        words = vals.view(torch.int32)
    # the output's words: last_pos for SWP, keys for fp32 MIN/MAX
    if op == "swp":
        out = torch.full((m,), -1, dtype=torch.int32)
    elif dtype == torch.float32 and op in ("min", "max"):
        out = trmw.order_key(table, op).clone()
    else:
        out = table.clone().view(torch.int32)
    keep = (idx >= 0) & (idx < m)
    if shares:
        for share in torch.tensor_split(torch.arange(n), shares):
            k = share[keep[share]]
            priv = torch.full((m,), _identity_word(op, dtype),
                              dtype=torch.int32)
            _combine_words(priv, idx[k].long(), words[k], op, dtype)
            # the flush: every slot of the copy into the output
            _combine_words(out, torch.arange(m), priv, op, dtype)
    else:
        step = window or m
        for lo in range(0, m, step):
            k = keep & (idx >= lo) & (idx < lo + step)
            _combine_words(out, idx[k].long(), words[k], op, dtype)
    if op == "swp":
        return torch.where(out >= 0, vals[out.clamp(min=0).long()], table)
    if dtype == torch.float32 and op in ("min", "max"):
        new = trmw.from_order_key(out, dtype)
        # a slot whose key did not move keeps its bits (a NaN's payload)
        return torch.where(out == trmw.order_key(table, op), table, new)
    return out.view(dtype)


# (name, CTA shares (0: global), window)
REGIME_MODELS = [("global", 0, None), ("smem_1", 1, None),
                 ("smem_4", 4, None), ("smem_13", 13, None),
                 ("windows_3", 0, 23)]


@pytest.mark.parametrize("model,shares,window", REGIME_MODELS,
                         ids=[r[0] for r in REGIME_MODELS])
@pytest.mark.parametrize("op,dtype", [(op, dt) for op in OPS4
                                      for dt in ("int32", "float32")]
                         + [("count", "int32")])
def test_table_kernel_words_match_jax_oracles(op, dtype, model, shares,
                                              window):
    """Privatise-then-flush (and the global and windowed passes) on the
    kernel's words against the JAX oracles: int32 bit for bit; fp32 with
    ±0 and NaN in the table and operands (FAA on integer values and ±0, so
    every sum is exact) NaN by isnan and every other value bit for bit;
    repeated slots (SWP's duplicates) and dropped ops."""
    rng = np.random.default_rng(zlib.crc32(f"{op}-{dtype}-{model}".encode()))
    m, n = 61, 500
    idx = collision_heavy(rng, n, m + 4)
    if op == "count":                      # onto a zero table
        table, vals = np.zeros(m, np.int32), None
    elif dtype == "int32":
        table = rng.integers(-9, 10, m).astype(np.int32)
        vals = rng.integers(-9, 10, n).astype(np.int32)
    else:
        table, vals = zeros_and_nans(rng, m), zeros_and_nans(rng, n)
        if op == "faa":                    # no NaN: its payload would differ
            table, vals = np.nan_to_num(table), np.nan_to_num(vals)
    got = _mirror_table(_t(table), _t(idx),
                        None if vals is None else _t(vals), op, shares,
                        window)
    if op == "count":
        same(got, jops.slot_occupancy(jnp.asarray(idx), m))
        return
    keep = idx < m
    want = jrmw.rmw_serialized(jnp.asarray(table), jnp.asarray(idx[keep]),
                               jnp.asarray(vals[keep]), op).table
    if dtype == "int32":
        same(got, want)
        same(got, jref.rmw_table_ref(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(vals), op))
    else:
        same_bits(got, want, f"{op} {model}")


def test_table_kernel_fp32_faa_words_within_tolerance():
    """Normal fp32 FAA summed per CTA share, then into the table: within
    the reference tests' tolerance of the Pallas kernel (interpret mode)."""
    m, n = 256, 3000
    table = RNG.normal(size=m).astype(np.float32)
    idx = collision_heavy(RNG, n, m + 5)
    vals = RNG.normal(size=n).astype(np.float32)
    want = jops.rmw_apply(jnp.asarray(table), jnp.asarray(idx),
                          jnp.asarray(vals), "faa", table_tile=256,
                          block=1024)
    occ = int(np.bincount(idx[idx < m], minlength=m).max())
    for shares, window in ((0, None), (7, None), (0, 100)):
        got = _mirror_table(_t(table), _t(idx), _t(vals), "faa", shares,
                            window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * np.sqrt(occ))


# ---------------------------------------------------------------------------
# The card's fetched kernel, stage by stage, in plain torch
# ---------------------------------------------------------------------------
# `rmw_table_fetched` runs on the card in stages (csrc/rmw.cu): compact the
# kept ops, a stable LSD radix sort by slot at the kernel's digit, a
# segmented scan whose carry crosses tiles by decoupled look-back, one more
# pass that buckets the (position, fetched) pairs by the positions' top
# digit, and the scatter.  CUDA does not run here, so this mirror repeats
# each stage's arithmetic at a small tile (the kernel: 32 lanes, 8 warps, 16
# ops a thread) and is held against the JAX oracles bit for bit.  `lag` is
# how many predecessors a tile finds with only their aggregate published, so
# the look-back walks that far.

LANES, WARPS, ITEMS = 4, 2, 4
THREADS = LANES * WARPS
TILE = THREADS * ITEMS
DIGITS = 1 << K.RADIX_BITS


def _tiled(x, fill):
    t = -(-x.shape[0] // TILE)
    out = x.new_full((t * TILE,), fill)
    out[:x.shape[0]] = x
    return out.view(t, TILE)


def _exclusive(x, dim):
    return torch.cumsum(x, dim) - x


def _pos_shift(n):
    return max((n - 1).bit_length() - K.RADIX_BITS, 0)


def _digit_hist(x, shift):
    return torch.bincount(((x >> shift) & (DIGITS - 1)).long(),
                          minlength=DIGITS)


def _mirror_compact(idx, m):
    """Stage 1: the kept ops as (slot, position) in batch order; a tile's
    offset is the kept count of the tiles before it (the look-back's sum),
    a warp's the count of the warps before it, an op's its ballot rank.
    Also each slot pass's digit histogram, and the positions' top digit's
    last."""
    n = idx.shape[0]
    keep_t = _tiled((idx >= 0) & (idx < m), False)
    per_warp = keep_t.view(-1, WARPS, TILE // WARPS).long()
    rank = _exclusive(per_warp, 2)
    warp_off = _exclusive(per_warp.sum(2), 1)
    tile_off = _exclusive(per_warp.sum((1, 2)), 0)
    dst = (tile_off[:, None, None] + warp_off[:, :, None] + rank).view(-1)[:n]
    keep = keep_t.view(-1)[:n]
    k = int(keep.sum())
    keys = torch.empty(k, dtype=torch.int32)
    pos = torch.empty(k, dtype=torch.int32)
    keys[dst[keep]] = idx[keep]
    pos[dst[keep]] = torch.arange(n, dtype=torch.int32)[keep]
    hist = [_digit_hist(idx[keep], p * K.RADIX_BITS)
            for p in range(K.radix_passes(m))]
    hist.append(_digit_hist(torch.arange(n)[keep], _pos_shift(n)))
    return keep, keys, pos, hist


def _mirror_radix_pass(keys, pos, hist, shift):
    """One radix pass (stages 2 and 4): a pair's place is its digit's start
    in the output (the histogram's exclusive scan), plus that digit's count
    in earlier tiles (the look-back), in earlier warps of its tile, and
    among earlier pairs of its warp with the same digit (`__match_any_sync`
    ranks)."""
    kt = _tiled(keys, -1).view(-1, WARPS, TILE // WARPS)
    valid = kt >= 0
    digit = torch.where(valid, (kt >> shift) & (DIGITS - 1), DIGITS).long()
    onehot = torch.nn.functional.one_hot(digit, DIGITS + 1)[..., :DIGITS]
    rank = (_exclusive(onehot, 2) * onehot).sum(-1)
    warp_counts = onehot.sum(2)
    warp_off = _exclusive(warp_counts, 1)
    earlier = _exclusive(warp_counts.sum(1), 0)
    start = _exclusive(hist, 0)
    d = digit.clamp(max=DIGITS - 1)
    t = torch.arange(kt.shape[0])[:, None, None].expand_as(d)
    w = torch.arange(WARPS)[None, :, None].expand_as(d)
    dst = (start[d] + earlier[t, d] + warp_off[t, w, d] + rank)[valid]
    out_k, out_p = torch.empty_like(keys), torch.empty_like(pos)
    out_k[dst] = kt[valid]
    out_p[dst] = _tiled(pos, 0).view_as(kt)[valid]
    return out_k, out_p


def _combiner(op, e):
    if op == "faa":
        return torch.add
    if op in ("min", "max"):
        return lambda a, b: trmw.minmax(op, a, b)
    # cas: the first value other than e (or the first value)
    return lambda a, b: torch.where((a != e) | (b == e), a, b)


def _mirror_scan(table, keys, pos, vals, op, e, lag):
    """Stage 3: fetched, success and the final table over the sorted pairs.
    Threads hold ITEMS consecutive pairs; thread aggregates are combined
    over a warp as the shuffles do (Hillis-Steele), then over the warps
    before; a tile's carry walks back over tiles combining aggregates until
    an inclusive value."""
    k = keys.shape[0]
    out = table.clone()
    fetched = vals.new_zeros(k)
    success = torch.ones(k, dtype=torch.bool)
    if k == 0:
        return out, fetched, success
    none = torch.tensor([-1], dtype=torch.int32)
    head = keys != torch.cat([none, keys[:-1]])
    last = keys != torch.cat([keys[1:], none])
    v = vals[pos.long()]
    base = torch.where(head, table[keys.long()], 0)
    if op == "swp":
        f = torch.where(head, base, torch.cat([v[:1], v[:-1]]))
        out[keys[last].long()] = v[last]
        return out, f, success
    comb = _combiner(op, e)
    shape = (-1, THREADS, ITEMS)
    kt = _tiled(keys, -1).view(shape)
    ht = _tiled(head, True).view(shape)       # ops past k count as heads
    vt = _tiled(v, 0).view(shape)
    bt = _tiled(base, 0).view(shape)
    x = torch.where(ht, comb(bt, vt), vt)
    agg_h, agg_v = ht[..., 0], x[..., 0]
    for i in range(1, ITEMS):
        agg_v = torch.where(ht[..., i], x[..., i], comb(agg_v, x[..., i]))
        agg_h = agg_h | ht[..., i]
    # inclusive over each warp, lane by lane as the shuffles
    s_h = agg_h.view(-1, WARPS, LANES).clone()
    s_v = agg_v.view(-1, WARPS, LANES).clone()
    lane = torch.arange(LANES)
    d = 1
    while d < LANES:
        o_h, o_v = torch.roll(s_h, d, 2), torch.roll(s_v, d, 2)
        take = lane >= d
        s_v = torch.where(take & ~s_h, comb(o_v, s_v), s_v)
        s_h = torch.where(take, s_h | o_h, s_h)
        d *= 2
    # the exclusive of each thread: previous lane, then the warps before
    ex_h = torch.roll(s_h, 1, 2)
    ex_v = torch.roll(s_v, 1, 2)
    has = (lane > 0).expand_as(ex_h).clone()
    wp_h, wp_v = s_h[:, 0, -1], s_v[:, 0, -1]
    tile_h, tile_v = wp_h.clone(), wp_v.clone()
    for w in range(1, WARPS):
        e_h, e_v = ex_h[:, w], ex_v[:, w]
        ex_v[:, w] = torch.where(has[:, w] & e_h, e_v,
                                 torch.where(has[:, w], comb(wp_v[:, None],
                                                             e_v),
                                             wp_v[:, None]))
        ex_h[:, w] = torch.where(has[:, w], e_h | wp_h[:, None],
                                 wp_h[:, None])
        has[:, w] = True
        w_h, w_v = s_h[:, w, -1], s_v[:, w, -1]
        wp_v = torch.where(w_h, w_v, comb(wp_v, w_v))
        wp_h = wp_h | w_h
        tile_v = torch.where(w_h, w_v, comb(tile_v, w_v))
        tile_h = tile_h | w_h
    # decoupled look-back: a tile with a head publishes its inclusive value
    # at once; the `lag` tiles before another are still at their aggregate
    tiles = kt.shape[0]
    incl = [None] * tiles
    carry = vals.new_zeros(tiles)
    for t in range(tiles):
        if not bool(ht[t, 0, 0]):
            acc = None
            for j in range(t - 1, -1, -1):
                ready = bool(tile_h[j]) or j < t - lag
                val = incl[j] if ready else tile_v[j]
                acc = val if acc is None else comb(val, acc)
                if ready:
                    break
            carry[t] = acc
        incl[t] = tile_v[t] if bool(tile_h[t]) else comb(carry[t], tile_v[t])
    ex_h, ex_v, has = ex_h.view(-1, THREADS), ex_v.view(-1, THREADS), \
        has.view(-1, THREADS)
    c = carry[:, None].expand_as(ex_v)
    prev = torch.where(has, torch.where(ex_h, ex_v, comb(c, ex_v)), c)
    ft = torch.empty_like(vt)
    after = torch.empty_like(vt)
    for i in range(ITEMS):
        ft[..., i] = torch.where(ht[..., i], bt[..., i], prev)
        prev = comb(ft[..., i], vt[..., i])
        after[..., i] = prev
    live = kt >= 0
    f = ft[live]
    if op == "cas":
        success = f == e
    out[keys[last].long()] = after[live][last]
    return out, f, success


def _mirror_fetched(table, idx, vals, op, expected=None, lag=3):
    """The stages end to end: (table, fetched, success), dropped ops
    reporting fetched 0 and success False."""
    m, n = table.shape[0], idx.shape[0]
    e = torch.tensor(0 if expected is None else expected, dtype=table.dtype)
    keep, keys, pos, hist = _mirror_compact(idx, m)
    success = keep & (op != "cas")
    for p in range(K.radix_passes(m)):
        keys, pos = _mirror_radix_pass(keys, pos, hist[p], p * K.RADIX_BITS)
    assert bool((keys[1:] >= keys[:-1]).all())
    tab, f, s = _mirror_scan(table, keys, pos, vals, op, e, lag)
    # bucket (position, fetched) by the positions' top digit, then scatter
    bpos, bf = _mirror_radix_pass(pos, f, hist[-1], _pos_shift(n))
    bucket = bpos >> _pos_shift(n)
    assert bool((bucket[1:] >= bucket[:-1]).all())
    fetched = vals.new_zeros(n)
    fetched[bpos.long()] = bf
    if op == "cas":
        success[bpos.long()] = bf == e
    return tab, fetched, success


def _kron_keys(n, m):
    from repro_torch.core import bfs as tbfs
    src, dst = tbfs.kronecker_graph(12, 16, seed=3)
    return (np.concatenate([src, dst])[:n] % m).astype(np.int32)


# (name, n, m): one slot over every tile; every op dropped; one op; one
# slot with drops; a top digit that is nearly empty; Kronecker skew
MIRROR_CASES = [("one_slot", 900, 1), ("all_dropped", 500, 64),
                ("n1", 1, 7), ("m1_drops", 700, 1),
                ("m_2pow20_plus1", 3000, (1 << 20) + 1),
                ("kronecker", 4000, 4096), ("cas_expected_in_vals", 2000, 50)]


@pytest.mark.parametrize("op", OPS4 + ["cas"])
@pytest.mark.parametrize("case,n,m", MIRROR_CASES,
                         ids=[c[0] for c in MIRROR_CASES])
def test_fetched_kernel_stages_match_jax_oracles(case, n, m, op):
    rng = np.random.default_rng(zlib.crc32(f"{case}-{op}".encode()))
    lo, hi = (-1, 2) if op == "cas" else (-8, 9)
    if case == "cas_expected_in_vals":
        lo, hi = -2, 3
    table = rng.integers(lo, hi, m).astype(np.int32)
    vals = rng.integers(lo, hi, n).astype(np.int32)
    if case == "kronecker":
        idx = _kron_keys(n, m)
    elif case == "all_dropped":
        idx = np.where(rng.random(n) < 0.5, m, -1 - rng.integers(0, 9, n))
    elif case == "m_2pow20_plus1":
        idx = rng.integers(0, m, n)
        idx[::5] = m - 1                     # the top digit's only slot
        idx[::7] = m
    else:
        idx = rng.integers(0, m + (m > 1) + 1, n)   # some dropped
    idx = idx.astype(np.int32)
    exp = (1 if case == "cas_expected_in_vals" else 0) if op == "cas" \
        else None
    got = _mirror_fetched(_t(table), _t(idx), _t(vals), op, exp)
    want = jref.rmw_table_fetched_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        None if exp is None else jnp.int32(exp))
    for g, w, what in zip(got, want, ("table", "fetched", "success")):
        same(g, w, what)
    keep = (idx >= 0) & (idx < m)
    ser = jrmw.rmw_serialized(
        jnp.asarray(table), jnp.asarray(idx[keep]), jnp.asarray(vals[keep]),
        op, None if exp is None else jnp.full(int(keep.sum()), exp,
                                              jnp.int32))
    same(got[0], ser.table, "serialized table")
    same(got[1][_t(keep)], ser.fetched, "serialized fetched")
    same(got[2][_t(keep)], ser.success, "serialized success")


@pytest.mark.parametrize("lag", [0, 1, 5])
@pytest.mark.parametrize("op", OPS4 + ["cas"])
def test_fetched_look_back_depth_changes_nothing(op, lag):
    """Hot slots whose segments span many tiles: however far the look-back
    walks before an inclusive value, int32 results are the same bits."""
    rng = np.random.default_rng(11)
    m, n = 3, 1500
    table = rng.integers(-1, 2, m).astype(np.int32)
    idx = rng.integers(0, m + 1, n).astype(np.int32)
    vals = rng.integers(-1, 2, n).astype(np.int32)
    exp = 0 if op == "cas" else None
    want = jref.rmw_table_fetched_ref(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(vals), op,
        None if exp is None else jnp.int32(exp))
    got = _mirror_fetched(_t(table), _t(idx), _t(vals), op, exp, lag=lag)
    for g, w in zip(got, want):
        same(g, w)


def test_fetched_kernel_passes_scratch_and_bytes():
    """Passes: ceil(bit_length(m - 1) / 8).  Bytes moved: 9n + (52 + 16P)k,
    8 per slot, 8m, and 9n more for CAS.  (The scratch size is the
    library's own, held on the card by tests/test_torch_gpu.py.)"""
    ms = (1, 2, 256, 257, 1 << 20, 1 << 24, (1 << 25) + 1)
    assert [K.radix_passes(m) for m in ms] == [0, 1, 1, 2, 3, 3, 4]
    assert K.fetched_design_bytes(100, 50, 1 << 20, 10, "faa") == \
        900 + 100 * 50 + 80 + (8 << 20)
    assert K.fetched_design_bytes(100, 50, 1, 1, "cas") - \
        K.fetched_design_bytes(100, 50, 1, 1, "swp") == 900
