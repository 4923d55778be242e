"""Sharded MoE training: `launch.train.train(mesh=...)` on deepseek_v3,
jamba and dbrx (reduced, f32) on 4 gloo CPU ranks, against the local
trainer.

One world of 4 ranks (module-scoped), rank side
`tests/_torch_train_sharded_moe_worker.py` (no JAX), on a 2x2 ``("data",
"model")`` mesh (expert parallelism over "model": the training variant of
the layer, `models.moe._ep_train`) and on (4,) ``("data",)`` over the
same ranks (no expert parallelism: the local layer on each cut, the aux
loss from every cut's).  At the no-drop capacity factor E / k the sharded
step's function is the local one's: losses and gradient norms within
rtol 1e-5, every leaf of the final checkpoint within relative L2 1e-4
(the worker's bounds).  The local runs are made here.  The (2,2,2) runs
are `tests/test_torch_moe_train.py`'s.
"""

import math

import pytest

import _torch_train_sharded_moe_worker as W
from repro_torch.launch import ranks
from repro_torch.launch import train as ttrain

WORKER = W.__file__


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_sharded_moe")
    out = ranks.launch(f"{WORKER}:run", 4, mesh=((2, 2), ("data", "model")),
                       device="cpu", args=(str(tmp),), timeout=600)
    return str(tmp), out


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """The local trainer's runs at the no-drop factor, on the plain and
    the masked batches: {case: (history, failures, ckpt dir)}."""
    tmp = tmp_path_factory.mktemp("train_moe_local")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "get_reduced", W.no_drop)
        runs = [(case, arch, batch, {}) for arch in W.ARCHS
                for case, batch in ((arch, W._synthetic_batch),
                                    (f"masked/{arch}", W.masked_batch))]
        runs.append(("micro", W.ARCHS[0], W._synthetic_batch,
                     dict(microbatches=2)))
        for case, arch, batch, kw in runs:
            mp.setattr(ttrain, "synthetic_batch", batch)
            path = str(tmp / case.replace("/", "-"))
            got = ttrain.train(arch, ckpt_dir=path, checkpoint_every=3,
                               **W.TRAIN, **kw)
            out[case] = ([{k: h[k] for k in ("loss", "grad_norm", "lr")}
                          for h in got["history"]], got["failures"], path)
    return out


def _case(sharded, case, agree=True):
    tmp, out = sharded
    hist, failures = out[0][case]
    if agree:
        assert all(o[case] == out[0][case] for o in out), case
    return hist, failures, W.ckpt_dir(tmp, case)


@pytest.mark.parametrize("mesh", ["2x2", "4"])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_moe_matches_local(sharded, local, arch, mesh):
    """Each MoE config on both meshes, 3 steps at the no-drop factor: the
    losses, gradient norms and every leaf of the final checkpoint against
    the local trainer; every rank reports the same run."""
    assert W.runs_off(_case(sharded, f"{arch}/{mesh}"), local[arch],
                      arch) == []


def test_microbatches_match_local(sharded, local):
    """deepseek_v3 on 2x2 with two microbatches, each the global batch's
    cut shared among the ranks (each loss scaled by its share and by 1 /
    2 before its backward, the expert blocks' gradients summed over the
    microbatches), against the local trainer's two microbatches."""
    assert W.runs_off(_case(sharded, "micro"), local["micro"],
                      W.ARCHS[0]) == []


@pytest.mark.parametrize("arch", W.ARCHS)
def test_masked_batch_weighted_before_the_backward(sharded, local, arch):
    """Half the rows 90% masked, so one data cut holds a tenth of the
    other's valid labels: the label-count weight scales each rank's loss
    before the backward, whose collectives sum the expert blocks'
    gradients over the data cuts, and the run matches the local one."""
    assert W.runs_off(_case(sharded, f"masked/{arch}"),
                      local[f"masked/{arch}"], arch) == []


@pytest.mark.parametrize("control", W.CONTROLS)
def test_controls_fail_the_check(sharded, local, control):
    """A `reduce_scatter` backward for the output's gather (every
    upstream gradient counted once per "model" rank) and the router's
    gradient left partial over "model": each fails the check the runs
    above pass, in the gradient norm."""
    arch = W.ARCHS[0]
    bad = W.runs_off(_case(sharded, f"control/{control}", agree=False),
                     local[arch], arch)
    assert "grad_norm" in {b[1] for b in bad if isinstance(b[0], int)}


@pytest.mark.parametrize("arch", W.ARCHS)
def test_own_capacity_losses_finite_and_falling(sharded, arch):
    """At each config's own capacity factor (1.25: assignments drop), 8
    steps on 2x2 at lr 3e-3: every loss finite, the last below the first
    and the mean of the last three below the first three's."""
    hist = _case(sharded, f"own/{arch}")[0]
    losses = [h["loss"] for h in hist]
    assert len(losses) == W.FALLING["steps"]
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], losses
    assert sum(losses[-3:]) < sum(losses[:3]), losses


def test_chaos_run_is_bit_equal_to_a_clean_one(sharded):
    """deepseek_v3 on 2x2 with a step fault and a save fault on every
    rank: failures, and every leaf of the final checkpoint bit-equal to
    the clean sharded run's."""
    tmp, _ = sharded
    clean, chaos = (_case(sharded, f"recovery/{t}")
                    for t in ("clean", "chaos"))
    assert clean[1] == 0 and chaos[1] >= 2
    assert clean[0][-1]["loss"] == chaos[0][-1]["loss"]
    steps, differ = W.chaos_equal(tmp)
    assert steps == (6, 6) and differ == []
