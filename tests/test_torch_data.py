"""Port parity: the data pipeline (`repro_torch.data.pipeline`).

- `MemmapSource` draws its windows with numpy exactly as the reference
  does: its batches are identical to the reference's on the same token
  file, for several seeds and steps, and `make_iterator` resumes on it.
- `synthetic_batch` keeps the reference's contract, not its
  `jax.random` stream: a pure function of (seed, step), resumable,
  labels the tokens shifted by one with -100 last, tokens following a
  seed-fixed bigram permutation with 20% uniform noise (the share of
  transitions that follow it within 0.8 ± 0.02 over 16,384), int32 on the
  device asked for.  Batches of embeddings, frames and M-RoPE positions
  raise until their models' slices.
- `batch_kwargs_for` gives the reference's kwargs for every config.
"""

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_reduced as jget_reduced
from repro.data import pipeline as jpipe
from repro_torch.configs import get_reduced
from repro_torch.data import pipeline as tpipe


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    rng = np.random.default_rng(0)
    rng.integers(0, 50_000, 20_000).astype(np.uint16).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed", [0, 7])
def test_memmap_batches_identical_to_reference(token_file, seed):
    kw = dict(seq_len=33, global_batch=5, vocab_size=50_000, seed=seed,
              source="memmap", path=token_file)
    jsrc = jpipe.MemmapSource(jpipe.DataConfig(**kw))
    tsrc = tpipe.MemmapSource(tpipe.DataConfig(**kw), device="cpu")
    for step in (0, 1, 13, 400):
        want, got = jsrc.batch(step), tsrc.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in want:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_memmap_iterator_resumes(token_file):
    cfg = tpipe.DataConfig(seq_len=16, global_batch=2, vocab_size=50_000,
                           source="memmap", path=token_file)
    it = tpipe.make_iterator(cfg, device="cpu")
    stream = [next(it)["tokens"] for _ in range(5)]
    it2 = tpipe.make_iterator(cfg, start_step=2, device="cpu")
    for k in range(2, 5):
        assert torch.equal(next(it2)["tokens"], stream[k])
    with pytest.raises(ValueError, match="path"):
        tpipe.MemmapSource(tpipe.DataConfig(8, 2, 10, source="memmap"))


def test_synthetic_batches_are_a_function_of_seed_and_step():
    cfg = tpipe.DataConfig(seq_len=16, global_batch=4, vocab_size=100,
                           seed=7)
    a = tpipe.synthetic_batch(cfg, 5, device="cpu")
    b = tpipe.synthetic_batch(cfg, 5, device="cpu")
    c = tpipe.synthetic_batch(cfg, 6, device="cpu")
    d = tpipe.synthetic_batch(tpipe.DataConfig(16, 4, 100, seed=8), 5,
                              device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])


def test_synthetic_iterator_resumes_exactly():
    cfg = tpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=50, seed=1)
    it = tpipe.make_iterator(cfg, device="cpu")
    stream = [next(it)["tokens"] for _ in range(6)]
    it2 = tpipe.make_iterator(cfg, start_step=3, device="cpu")
    for k in range(3, 6):
        assert torch.equal(next(it2)["tokens"], stream[k])


def test_labels_are_shifted_tokens():
    cfg = tpipe.DataConfig(seq_len=8, global_batch=3, vocab_size=50)
    b = tpipe.synthetic_batch(cfg, 0, device="cpu")
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert b["tokens"].shape == b["labels"].shape == (3, 8)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -100).all()
    assert ((b["tokens"] >= 0) & (b["tokens"] < 50)).all()


def test_tokens_follow_a_noisy_bigram():
    """The reference's learnable signal: each token is the seed's
    permutation of the one before it, except where 20% noise resamples;
    the permutation is the same at every step."""
    cfg = tpipe.DataConfig(seq_len=257, global_batch=64, vocab_size=512,
                           seed=3)
    shares = []
    for step in (0, 1):
        t = tpipe.synthetic_batch(cfg, step, device="cpu")["tokens"].long()
        perm = torch.randperm(512, generator=torch.Generator().manual_seed(
            3 ^ 0x5EED))
        hit = perm[t[:, :-1]] == t[:, 1:]
        shares.append(float(hit.float().mean()))
    assert all(abs(s - 0.8) < 0.02 for s in shares), shares


def test_unported_inputs_raise():
    """The multimodal inputs, once refused, now follow the reference's
    contract: each option gives the reference's keys with the reference's
    shapes and dtypes (embeds replace tokens, labels stay), and the
    embeddings and frames are a pure function of (seed, step)."""
    cfg = tpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=50)
    jcfg = jpipe.DataConfig(seq_len=8, global_batch=2, vocab_size=50)
    for kw in (dict(with_embeds=True, d_model=4),
               dict(with_frames=3, d_model=4), dict(with_positions3=True)):
        got = tpipe.synthetic_batch(cfg, 0, device="cpu", **kw)
        want = jpipe.synthetic_batch(jcfg, 0, **kw)
        assert set(got) == set(want), kw
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, (kw, key)
            assert str(got[key].dtype).split(".")[-1] == \
                str(want[key].dtype), (kw, key)
        again = tpipe.synthetic_batch(cfg, 0, device="cpu", **kw)
        for key in got:
            assert torch.equal(got[key], again[key])
    p3 = tpipe.synthetic_batch(cfg, 1, device="cpu",
                               with_positions3=True)["positions3"]
    np.testing.assert_array_equal(
        p3.numpy(), np.asarray(jpipe.synthetic_batch(
            jcfg, 1, with_positions3=True)["positions3"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_kwargs_match_reference(arch):
    assert tpipe.batch_kwargs_for(get_reduced(arch)) == \
        jpipe.batch_kwargs_for(jget_reduced(arch))
