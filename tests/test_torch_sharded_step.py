"""The port's sharded train step on real process groups: gloo ranks on
the CPU (``torch.multiprocessing``), 4 on a (1, 2, 2) and 8 on a
(2, 2, 2) ('pod', 'data', 'model') mesh, one reduced granite f32 step of
2 accumulated microbatches and one prefill.  Loss, grad norm, every
updated weight and the prefill's logits must equal the one-process
unsharded port and the JAX package (``jax.value_and_grad`` through its
train step, on the same numpy weights) within 1e-5 relative, with no
all-gather in the step: no FSDP, kv heads that divide the model axis and
ZeRO-2 accumulators that shard no leaf this small.  A third run shards
every leaf by FSDP too."""

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


@pytest.fixture(scope="module")
def unsharded():
    """The same step and prefill in one process: the port's and the JAX
    package's."""
    jm, jp, tm, tp = both_models("granite-3-2b")
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


@pytest.mark.parametrize("shape,fsdp", [((1, 2, 2), False),
                                        ((2, 2, 2), False),
                                        ((2, 2, 2), True)])
def test_sharded_step_and_prefill_equal_unsharded_and_reference(
        shape, fsdp, unsharded, tmp_path):
    """And with FSDP over the batch axes on every leaf (the qwen2-72b
    cells' layout at a size where it can run): the same numbers, the
    leaves gathered by all-gathers."""
    world = int(np.prod(shape))
    out = str(tmp_path / "rank0.pt")
    cfg = unsharded["cfg"]
    mp.spawn(rank_main, nprocs=world, join=True,
             args=(world, shape, _free_port(), unsharded["start"],
                   unsharded["batch"],
                   {"cfg": cfg, "accum": ACCUM, "fsdp": fsdp}, out))
    got = torch.load(out, weights_only=False)
    got_params = lm_params_to_numpy(
        cfg, rebuild(unsharded["start"], got["params"]))
    for ref in (unsharded["port"], unsharded["jax"]):
        assert _rel(got["loss"], ref["loss"]) <= RTOL
        assert _rel(got["grad_norm"], ref["grad_norm"]) <= RTOL
        for a, b in zip(jax.tree.leaves(got_params),
                        jax.tree.leaves(ref["params"])):
            assert _rel(a, b) <= RTOL
        assert _rel(got["logits"], ref["logits"]) <= RTOL
    counts = got["counts"]
    gathers = [k for k in counts if "all_gather" in k]
    assert bool(gathers) == fsdp, counts
    assert any("all_reduce" in k for k in counts), counts
