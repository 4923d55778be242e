"""Rank side of `tests/test_torch_mamba_tp.py`.

Runs on every rank of a gloo group of 2 started by
`repro_torch.launch.ranks.launch` on a ``("model",)`` mesh.  It imports
the port only: no JAX, and not the test suite's conftest.

Each case is one Mamba-2 mixer (`models.mamba.Mamba2`, a reduced config
in f32) with the test's numpy weights, run on the rank's ``"model"`` cut
as the partitioned train step runs it: ``in_proj`` and ``out_proj``
handed in as the rank's contiguous blocks of the reference's specs
(``in_proj``'s columns, ``out_proj``'s rows) through
`models.tensor_parallel.cuts`, every other leaf whole.  The rank returns
the output, dx and every leaf's gradient reassembled: the blocks'
gathered over ``"model"``, the whole leaves' summed over it (each rank's
is the part its heads use).  The same again under each of the mixer's
controls (`models.mamba._CONTROLS`).  `run_card` runs one case on the
card (`tests/test_torch_gpu.py`: mamba2_780m's mixer at full width).
"""

import sys

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.mesh import shard_of
from repro_torch.models import mamba, tensor_parallel
from repro_torch.models.mamba import Mamba2

LEAVES = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
          "out_proj")
#: the leaves handed in as the rank's blocks, and the spec of each
BLOCKS = {"in_proj": (None, "model"), "out_proj": ("model",)}
CONTROLS = ("contiguous_in_proj", "local_norm")


def config(c):
    """A case's config in f32: the arch's reduced one, or its full one
    where ``c["full"]``."""
    return (get_config if c.get("full") else get_reduced)(
        c["arch"]).replace(dtype="float32")


def mixer(c, device="cpu"):
    """The case's mixer with its weights, on ``device``."""
    module = Mamba2(config(c), torch.Generator(device=device).manual_seed(0),
                    torch.float32)
    with torch.no_grad():
        for name in LEAVES:
            getattr(module, name).copy_(torch.from_numpy(c["params"][name]))
    return module


def mixer_case(mesh, c, control=None, device="cpu"):
    """One case (``c``: the arch, the weights, x and the output's
    cotangent, numpy) on this rank's cut: {"y", "dx", "grads"} as numpy,
    each gradient the whole leaf's."""
    module = mixer(c, device)
    blocks = {n: shard_of(getattr(module, n).detach(), spec, mesh)
              .requires_grad_() for n, spec in BLOCKS.items()}
    x = torch.from_numpy(c["x"]).to(device).requires_grad_()
    mamba._CONTROLS = frozenset({control} if control else ())
    try:
        with tensor_parallel.cuts(mesh, {id(getattr(module, n)): b
                                         for n, b in blocks.items()}):
            y, _ = module(x, use_kernel=False)
    finally:
        mamba._CONTROLS = frozenset()
    wrt = [x] + [blocks.get(n, getattr(module, n)) for n in LEAVES]
    grads = torch.autograd.grad(y, wrt, torch.from_numpy(c["ct"]).to(device))
    whole = {}
    for name, g in zip(LEAVES, grads[1:]):
        if name in BLOCKS:
            dim = BLOCKS[name].index("model")
            g = mesh.all_gather(g.movedim(dim, 0).contiguous(), "model"
                                ).movedim(0, dim)
        else:
            g = mesh.all_reduce(g, "model")
        whole[name] = g.cpu().numpy()
    return {"y": y.detach().cpu().numpy(), "dx": grads[0].cpu().numpy(),
            "grads": whole}


def run(mesh, cases):
    torch.manual_seed(0)
    out = {"cases": [mixer_case(mesh, c) for c in cases],
           "controls": {k: mixer_case(mesh, cases[0], k) for k in CONTROLS}}
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith(("jax.", "repro."))
                            or m == "repro")
    return out


def run_card(mesh, c):
    """One case on the card: `mixer_case` on CUDA tensors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return mixer_case(mesh, c, device="cuda")
