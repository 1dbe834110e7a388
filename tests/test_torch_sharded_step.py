"""The port's sharded train step on real process groups: gloo ranks on
the CPU (``torch.multiprocessing``), 4 on a (1, 2, 2) and 8 on a
(2, 2, 2) ('pod', 'data', 'model') mesh, one reduced granite f32 step of
2 accumulated microbatches and one prefill.  Loss, grad norm, every
updated weight and the prefill's logits must equal the one-process
unsharded port and the JAX package (``jax.value_and_grad`` through its
train step, on the same numpy weights) within 1e-5 relative, with no
all-gather in the step: no FSDP, kv heads that divide the model axis and
ZeRO-2 accumulators that shard no leaf this small.  A third run shards
every leaf by FSDP too, over 'data' within each pod.  Reduced qwen2-moe's
expert-parallel step and prefill on (1, 2, 2) are held the same way:
its experts' weights move by all-to-alls over 'model'."""

import dataclasses
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from _torch_lm import both_models  # noqa: E402
from _torch_sharded import rank_main  # noqa: E402

from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import adamw_init as j_init  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.interop import lm_params_to_numpy  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, TrainConfig, adamw_init, make_train_step,
)
from repro_torch.tree import leaves, rebuild  # noqa: E402

RTOL = 1e-5
ACCUM = 2


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _unsharded(name, **moe):
    """The same step and prefill in one process: the port's and the JAX
    package's (``moe``: fields of the MoE config replaced)."""
    jm, jp, tm, tp = both_models(name, moe=moe)
    batch = SyntheticDataset(vocab=tm.cfg.vocab, seq_len=32, global_batch=8,
                             seed=3).batch(0)
    tp0 = rebuild(tp, [t.clone() for t in leaves(tp)])
    p, _, m = make_train_step(tm, TrainConfig(grad_accum=ACCUM))(
        tp, adamw_init(tp, AdamWConfig()), batch)
    # the prefill runs on the updated weights, as the ranks' does
    logits = tm.prefill(p, {"tokens": torch.from_numpy(batch["tokens"])})
    jstep = jax.jit(j_make_step(jm, JTrain(grad_accum=ACCUM)))
    jnew, _, jmet = jstep(jp, j_init(jp, JAdamW()),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    jlogits = jm.prefill(jnew, {"tokens": jnp.asarray(batch["tokens"])})
    return dict(cfg=tm.cfg, start=tp0, batch=batch,
                port={"loss": m["loss"], "grad_norm": m["grad_norm"],
                      "params": lm_params_to_numpy(tm.cfg, p),
                      "logits": logits},
                jax={"loss": jmet["loss"], "grad_norm": jmet["grad_norm"],
                     "params": jax.tree.map(np.asarray, jnew),
                     "logits": np.asarray(jlogits)})


@pytest.fixture(scope="module")
def unsharded():
    return _unsharded("granite-3-2b")


@pytest.fixture(scope="module")
def unsharded_moe():
    return _unsharded("qwen2-moe-a2.7b")


@pytest.fixture(scope="module")
def unsharded_moe_five():
    """Reduced qwen2-moe with 5 experts, which split over 4 'model' ranks
    as 2, 2, 1 and 0."""
    return _unsharded("qwen2-moe-a2.7b", num_experts=5)


def _ranks(shape, fsdp, ref, cfg, tmp_path, **kw):
    """The sharded step and prefill on ``shape``'s mesh; rank 0's record."""
    world = int(np.prod(shape))
    out = str(tmp_path / "rank0.pt")
    mp.spawn(rank_main, nprocs=world, join=True,
             args=(world, shape, _free_port(), ref["start"], ref["batch"],
                   {"cfg": cfg, "accum": ACCUM, "fsdp": fsdp, **kw}, out))
    return torch.load(out, weights_only=False)


def _hold(got, ref, cfg):
    """Loss, grad norm, every updated weight and the logits within RTOL
    of the unsharded port and the JAX package."""
    got_params = lm_params_to_numpy(cfg, rebuild(ref["start"], got["params"]))
    for want in (ref["port"], ref["jax"]):
        assert _rel(got["loss"], want["loss"]) <= RTOL
        assert _rel(got["grad_norm"], want["grad_norm"]) <= RTOL
        for a, b in zip(jax.tree.leaves(got_params),
                        jax.tree.leaves(want["params"])):
            assert _rel(a, b) <= RTOL
        assert _rel(got["logits"], want["logits"]) <= RTOL


@pytest.mark.parametrize("shape,fsdp", [((1, 2, 2), False),
                                        ((2, 2, 2), False),
                                        ((2, 2, 2), True)])
def test_sharded_step_and_prefill_equal_unsharded_and_reference(
        shape, fsdp, unsharded, tmp_path):
    """And with FSDP over 'data' on every leaf (the qwen2-72b cells'
    layout at a size where it can run): the same numbers, the leaves
    gathered by all-gathers."""
    got = _ranks(shape, fsdp, unsharded, unsharded["cfg"], tmp_path)
    _hold(got, unsharded, unsharded["cfg"])
    counts = got["counts"]
    gathers = [k for k in counts if "all_gather" in k]
    assert bool(gathers) == fsdp, counts
    assert any("all_reduce" in k for k in counts), counts


@pytest.mark.parametrize("shape,fsdp", [((1, 2, 2), False),
                                        ((2, 2, 2), True)])
def test_expert_parallel_step_and_prefill_equal_unsharded_and_reference(
        shape, fsdp, unsharded_moe, tmp_path):
    """Reduced qwen2-moe, impl "ep": 4 experts a rank at full width, its
    weights moved by all-to-alls; the partial combines added over 'model'
    in another order than the unsharded sum's.  And on two pods with
    FSDP over 'data' on every leaf but the q/k/v biases (the train_4k
    cells' layout; the biases stay whole, where the reference would
    shard their stacked layer axis): each layer's experts gathered over
    'data', then moved."""
    ref = unsharded_moe
    cfg = ref["cfg"]
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep"))
    got = _ranks(shape, fsdp, ref, ep, tmp_path)
    _hold(got, ref, cfg)
    counts = got["counts"]
    assert any("all_to_all" in k for k in counts), counts
    assert bool([k for k in counts if "all_gather" in k]) == fsdp, counts


def test_expert_parallel_step_with_a_rank_of_no_experts(unsharded_moe_five,
                                                        tmp_path):
    """5 experts over 4 'model' ranks split 2, 2, 1, 0, as 60 over 16
    leaves the last rank none: that rank adds zeros to the combine and
    takes part in every all-to-all, forward and backward.  Loss, grad
    norm, every updated weight and the logits as the unsharded port's and
    the JAX package's."""
    from repro_torch.models.moe import expert_split

    ref = unsharded_moe_five
    cfg = ref["cfg"]
    assert expert_split(cfg.moe.num_experts, 4) == [2, 2, 1, 0]
    ep = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep"))
    got = _ranks((1, 4), False, ref, ep, tmp_path)
    _hold(got, ref, cfg)
    assert any("all_to_all" in k for k in got["counts"]), got["counts"]
