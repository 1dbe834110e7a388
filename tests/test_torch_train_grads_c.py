"""``Model.loss`` and every gradient leaf against the JAX package's
``jax.value_and_grad(Model.loss)`` on the CPU, for the scan families:
reduced mamba2-1.3b (SSD, through ``ssd_twin``) and reduced
jamba-1.5-large-398b over one period (Mamba-1 through ``SelectiveScan``,
its backward the plain reverse recurrence, and the MoE's aux loss); and
the same gradients under remat bit for bit."""

import pytest

pytest.importorskip("torch")

from _torch_lm import one_thread  # noqa: E402
from _torch_train import (  # noqa: E402
    Reference, check_against_reference, check_remat_bit_for_bit,
)

NAMES = ["mamba2-1.3b", "jamba-1.5-large-398b"]


@pytest.fixture(scope="module")
def ref():
    return Reference()


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_reference(ref, name):
    check_against_reference(ref, name)


@pytest.mark.parametrize("policy", ["nothing_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("name", NAMES)
def test_remat_gradients_bit_for_bit(ref, name, policy):
    check_remat_bit_for_bit(ref, name, policy)
