"""``Model.loss`` and every gradient leaf against the JAX package's
``jax.value_and_grad(Model.loss)`` on the CPU, for the MoE (with its aux loss), MLA after a dense first layer, M-RoPE and the encoder-decoder; and the same
gradients under remat bit for bit."""

import pytest

pytest.importorskip("torch")

from _torch_train import (  # noqa: E402
    Reference, check_against_reference, check_remat_bit_for_bit,
)

NAMES = ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "qwen2-vl-72b", "whisper-large-v3"]


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
