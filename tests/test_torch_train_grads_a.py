"""``Model.loss`` and every gradient leaf against the JAX package's
``jax.value_and_grad(Model.loss)`` on the CPU, for the dense configs, tied and untied, with and without q/k/v biases; and the same
gradients under remat bit for bit."""

import pytest

pytest.importorskip("torch")

from _torch_train import (  # noqa: E402
    Reference, check_against_reference, check_remat_bit_for_bit,
)

NAMES = ["granite-3-2b", "glm4-9b", "codeqwen1.5-7b", "qwen2-72b"]


@pytest.fixture(scope="module")
def ref():
    return Reference()


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(ref, name):
    check_against_reference(ref, name)


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("name", NAMES)
def test_remat_gradients_bit_for_bit(ref, name, policy):
    check_remat_bit_for_bit(ref, name, policy)
