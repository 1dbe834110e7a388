"""The port's AdamW, LR schedule and train step against the JAX
package's on the CPU: the update on identical gradients (f32 and bf16
state, clipping active), the schedule step by step, gradient
accumulation against the full batch (the scan families' too), and
three steps of each."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import both_models, mrope_positions, one_thread  # noqa: E402

from repro.data import SyntheticDataset as JSynthetic  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import adamw_init as j_init  # noqa: E402
from repro.train import adamw_update as j_update  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro.train import schedule as j_schedule  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.interop import lm_params_to_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, TrainConfig, adamw_init, adamw_update, init_train_state,
    make_train_step, schedule,
)

#: AdamW on identical gradients, relative to each leaf's largest |value|
ADAMW_RTOL = 1e-6
SHAPES = {"w": (48, 32), "b": (32,),
          "layers": {"a": (3, 16, 8), "n": (3, 16), "e": (2, 4, 8, 8)}}


def _draw(rng, shapes, scale=1.0):
    return {k: _draw(rng, v, scale) if isinstance(v, dict) else
            (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _grid_grads(rng, shapes):
    """Gradients on a grid of 1/8 in [-4, 4]: every square and partial
    sum of squares is exact in f32, so the global norm, and with it the
    clip factor, is the same in any summation order.  A bf16 moment then
    differs from the reference's only if the update's own arithmetic
    does, not where the two packages' sums of squares part in the last
    bit and a rounding to bf16 flips."""
    return {k: _grid_grads(rng, v) if isinstance(v, dict) else
            (rng.integers(-32, 33, v) / 8).astype(np.float32)
            for k, v in shapes.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_close(got, want, rtol):
    """Leaf by leaf (the port's tree against the reference's), each
    within ``rtol`` of the reference leaf's largest |value|."""
    want = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), want))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), got))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= rtol * float(np.abs(w).max())


@pytest.mark.parametrize("state_dtype,grads", [
    ("float32", "normal"), ("float32", "grid"), ("bfloat16", "grid")])
def test_adamw_matches_reference_on_identical_gradients(state_dtype, grads):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=3, decay_steps=10, grad_clip=1.0,
              state_dtype=state_dtype)
    jcfg, tcfg = JAdamW(**kw), AdamWConfig(**kw)
    p = _draw(rng, SHAPES)
    jp = jax.tree.map(jnp.asarray, p)
    js = j_init(jp, jcfg)
    tp = _torch_tree(p)
    ts = adamw_init(tp, tcfg)
    for _ in range(12):
        g = _draw(rng, SHAPES, 3.0) if grads == "normal" else \
            _grid_grads(rng, SHAPES)
        jp, js, jm = j_update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw_update(_torch_tree(g), ts, tp, tcfg)
        assert float(jm["grad_norm"]) > jcfg.grad_clip     # clipping acts
        for a, b in ((tm["grad_norm"], jm["grad_norm"]), (tm["lr"], jm["lr"])):
            assert abs(a.item() - float(b)) <= ADAMW_RTOL * abs(float(b))
        _assert_close(tp, jp, ADAMW_RTOL)
        for k in ("m", "v"):
            assert jax.tree.leaves(ts[k])[0].dtype == getattr(torch,
                                                              state_dtype)
            _assert_close(ts[k], js[k], ADAMW_RTOL)
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"])


def test_adamw_decays_matrices_only():
    """With a zero gradient the update is the decay alone: matrices
    shrink by lr·wd, vectors stay."""
    cfg = AdamWConfig(lr=0.5, weight_decay=0.1, warmup_steps=0,
                      decay_steps=1, min_lr_ratio=1.0)
    p = {"w": torch.ones(4, 4), "b": torch.ones(4)}
    zero = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    p, _, _ = adamw_update(zero, adamw_init(p, cfg), p, cfg)
    assert torch.equal(p["b"], torch.ones(4))
    assert torch.allclose(p["w"], torch.full((4, 4), 1 - 0.5 * 0.1))


def test_lr_schedule_matches_reference():
    """The reference's ``test_lr_schedule_shape`` on the port, and each of
    its steps against the reference's value."""
    kw = dict(lr=1.0, warmup_steps=10, decay_steps=100, min_lr_ratio=0.1)
    cfg, jcfg = AdamWConfig(**kw), JAdamW(**kw)
    lrs = []
    for s in range(0, 120, 5):
        got = schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = float(j_schedule(jcfg, jnp.int32(s)))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= ADAMW_RTOL * abs(want)
        lrs.append(got.item())
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, abs=0.01)
    assert lrs[-1] == pytest.approx(0.1, abs=0.01)


def _run_one_step(model, tc, batch, seed=0):
    params, opt = init_train_state(model, tc, seed)
    params, _, metrics = make_train_step(model, tc)(params, opt, batch)
    return params, metrics


def test_grad_accum_matches_full_batch():
    """accum=4 over one batch == a single step on the same batch, modulo
    bf16 noise (the reference's test and limits)."""
    cfg = ARCHS["granite-3-2b"].reduced()
    model = Model(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, grad_clip=0.0, weight_decay=0.0)
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=32, global_batch=8,
                             seed=1).batch(0)
    (p1, m1), (p4, m4) = (
        _run_one_step(model, TrainConfig(optimizer=opt_cfg, grad_accum=a),
                      batch) for a in (1, 4))
    assert abs(m1["loss"].item() - m4["loss"].item()) < 5e-2
    assert set(m1) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert set(m4) == {"loss", "grad_norm", "lr"}
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=2e-3)


def test_grad_accum_splits_mrope_positions_on_their_batch_axis():
    """qwen2-vl-72b in f32: the (3, B, S) M-RoPE positions split on axis
    1, so accumulating 2 microbatches gives the full batch's loss and
    update."""
    cfg = dataclasses.replace(ARCHS["qwen2-vl-72b"].reduced(),
                              dtype="float32")
    model = Model(cfg, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, grad_clip=0.0, weight_decay=0.0)
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=32, global_batch=4,
                             seed=4).batch(0)
    pos = mrope_positions(32, 4, 4, batch=4).copy()
    pos[:, 2:] += 3                   # rows 2, 3 unlike rows 0, 1
    batch["mrope_positions"] = pos
    (p1, m1), (p2, m2) = (
        _run_one_step(model, TrainConfig(optimizer=opt_cfg, grad_accum=a),
                      batch) for a in (1, 2))
    assert abs(m1["loss"].item() - m2["loss"].item()) <= \
        1e-5 * m1["loss"].item()
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_grad_accum_runs_the_scan_families(name):
    """Reduced mamba2-1.3b and jamba in f32: 2 accumulated microbatches
    give the full batch's loss and update, through SSD's and the
    selective scan's CPU paths (the MoE's aux loss, which is per
    microbatch, weighed out)."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32")
    model = Model(cfg, device="cpu", moe_aux_weight=0.0)
    opt_cfg = AdamWConfig(lr=1e-3, grad_clip=0.0, weight_decay=0.0)
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=24, global_batch=4,
                             seed=5).batch(0)
    with one_thread():
        (p1, m1), (p2, m2) = [
            _run_one_step(model, TrainConfig(optimizer=opt_cfg, grad_accum=a),
                          batch) for a in (1, 2)]
    assert abs(m1["loss"].item() - m2["loss"].item()) <= \
        1e-5 * m1["loss"].item()
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_three_steps_match_reference():
    """Three steps of the port's train step against three of the
    reference's on the same weights and data: losses within 1e-4."""
    jm, jp, tm, tp = both_models("granite-3-2b")
    kw = dict(lr=1e-3, warmup_steps=2)
    jstep = jax.jit(j_make_step(jm, JTrain(optimizer=JAdamW(**kw))))
    tstep = make_train_step(tm, TrainConfig(optimizer=AdamWConfig(**kw)))
    jo, to = j_init(jp, JAdamW(**kw)), adamw_init(tp, AdamWConfig(**kw))
    ds = JSynthetic(vocab=tm.cfg.vocab, seq_len=32, global_batch=4, seed=2)
    for i in range(3):
        b = ds.batch(i)
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = tstep(tp, to, b)
        assert abs(tmet["loss"].item() - float(jmet["loss"])) <= \
            1e-4 * float(jmet["loss"])
    # after three AdamW steps the weights are still the reference's to
    # the size of one update (lr) over their spread
    for a, b in zip(jax.tree.leaves(lm_params_to_numpy(tm.cfg, tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        assert float(np.abs(a - b).max()) <= 1e-3 * float(np.abs(b).max())
