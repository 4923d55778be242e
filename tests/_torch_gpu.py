"""Shared pieces of the port's tests (`tests/test_torch_*.py`).

`cuda_device` decides inside the fixture — never at import or in a
``skipif`` — whether a card is present, so every worker collects the same
tests.  Tests that need the card carry ``@pytest.mark.gpu`` and take this
fixture.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def collision_heavy(rng, n, m):
    """Mix of hot-slot, uniform, and run-repeated indices (the reference
    tests' generator, tests/test_rmw_engine.py)."""
    hot = rng.integers(0, max(1, m // 8) or 1, n)
    uni = rng.integers(0, m, n)
    runs = np.repeat(rng.integers(0, m, n // 4 + 1), 4)[:n]
    mix = np.where(rng.random(n) < 0.5, hot, uni)
    mix = np.where(rng.random(n) < 0.25, runs, mix)
    return mix.astype(np.int32)


def same(port_tensor, ref_array, what=""):
    """Bit-equality of a port tensor and a reference (JAX/numpy) array."""
    np.testing.assert_array_equal(port_tensor.detach().cpu().numpy(),
                                  np.asarray(ref_array), err_msg=what)
