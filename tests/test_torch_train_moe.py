"""Port parity: training the MoE configs (dbrx, jamba) against the JAX
package.

The reduced f32 models with the reference's parameters and the same numpy
batches (`tests/_torch_train.py` states the tolerances): the loss (the
cross-entropy plus the MoE aux loss) and every gradient leaf against
`jax.grad` (the router's through the gates and the aux loss, the experts'
through the dispatch and the combine); three `make_train_step` steps
(params, master, m, v); each with a control that must fail.
"""

import pytest
import torch

import _torch_train as T

ARCHS = ("dbrx_132b", "jamba_1_5_large_398b")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return T.reference_run(request.param)


def test_loss_and_gradients_match_jax_grad(ref):
    T.check_loss_and_grads(ref)


def test_three_train_steps_match_reference(ref):
    T.check_three_steps(ref)
