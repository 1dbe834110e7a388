"""The port's checkpoints, data pipelines and fault tolerance: twins of
the JAX package's ``tests/test_train.py`` checkpoint tests,
``tests/test_ft.py`` and its data tests, run on the port (CPU), and the
datasets' batches equal to the reference's."""

import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _propcheck import given, settings, strategies as st  # noqa: E402

from repro.data import ByteDataset as JByteDataset  # noqa: E402
from repro.data import SyntheticDataset as JSynthetic  # noqa: E402
from repro_torch.checkpoint import latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data import ByteDataset, SyntheticDataset  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    HostFailure, StragglerDetector, plan_elastic_mesh, run_with_restarts,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig, TrainConfig, init_train_state, make_train_step,
)
from repro_torch.tree import leaves, rebuild  # noqa: E402


@pytest.fixture(scope="module")
def small_model():
    cfg = ARCHS["granite-3-2b"].reduced()
    return Model(cfg, device="cpu"), cfg


def _equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _blank(tree):
    """Zeros of ``tree``'s shapes and types: a restore template that
    carries nothing of the state it stands for."""
    return rebuild(tree, [torch.zeros_like(t) for t in leaves(tree)])


def _shares_storage(a, b) -> bool:
    live = {t.data_ptr() for t in leaves(b) if t.numel()}
    return any(t.data_ptr() in live for t in leaves(a) if t.numel())


# -- checkpoints ------------------------------------------------------------

def test_checkpoint_resume_is_exact(small_model):
    """train 3 + save + train 3  ==  restore + train 3 (bitwise)."""
    model, cfg = small_model
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=2)
    step = make_train_step(model, tc)

    def run(params, opt, start, n):
        for i in range(start, start + n):
            params, opt, _ = step(params, opt, ds.batch(i))
        return params, opt

    params, opt = init_train_state(model, tc, 0)
    params, opt = run(params, opt, 0, 3)
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, {"params": params, "opt": opt})
        template = _blank({"params": params, "opt": opt})
        pa, oa = run(params, opt, 3, 3)        # updates params in place
        restored, rstep = restore(d, template, device="cpu")
        assert rstep == 3
        assert not _shares_storage(restored, [pa, oa, template])
        pb, ob = run(restored["params"], restored["opt"], 3, 3)
    assert _equal(pa, pb) and _equal(oa, ob)


def test_checkpoint_gc_and_latest():
    with tempfile.TemporaryDirectory() as d:
        tree = {"x": torch.arange(4)}
        for s in (1, 2, 3, 4, 5):
            save(d, s, tree, keep_last=2)
        assert latest_step(d) == 5
        kept = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert kept == ["step_00000004", "step_00000005"]


def test_checkpoint_bf16_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        w = torch.randn(3, 3).to(torch.bfloat16)
        tree = {"w": w, "m": torch.zeros(2), "layers": [{"a": w[0] * 1.5}]}
        save(d, 1, tree)
        out, _ = restore(d, tree, device="cpu")
        assert out["w"].dtype == torch.bfloat16
        assert _equal(out, tree)
        assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))


def test_checkpoint_publishes_atomically(monkeypatch):
    """A write that fails leaves the last published step and LATEST as
    they were (only a ``.tmp`` directory behind), and the step directory
    and LATEST appear by ``os.replace`` alone."""
    replaced = []
    real_replace = os.replace

    def recording_replace(src, dst):
        replaced.append((os.path.basename(src), os.path.basename(dst)))
        real_replace(src, dst)

    monkeypatch.setattr(store.os, "replace", recording_replace)
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, {"x": torch.ones(2)})
        assert replaced == [("step_00000001.tmp", "step_00000001"),
                            ("LATEST.tmp", "LATEST")]

        def failing_save(obj, path):
            with open(path, "wb") as f:
                f.write(b"half")
            raise OSError("disk lost mid-write")

        monkeypatch.setattr(store.torch, "save", failing_save)
        with pytest.raises(OSError):
            save(d, 2, {"x": torch.zeros(2)})
        assert latest_step(d) == 1
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                         "step_00000002.tmp"]
        out, step = restore(d, {"x": torch.zeros(2)}, device="cpu")
        assert step == 1 and torch.equal(out["x"], torch.ones(2))
        monkeypatch.undo()
        save(d, 2, {"x": torch.zeros(2)})       # the stale .tmp is replaced
        assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                         "step_00000002"]


def test_restore_raises_without_a_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            restore(d, {"x": torch.zeros(1)}, device="cpu")


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (5, 3, 0, 1), (5, 3, 1, 2), (7, 11, 3, 4)])
def test_synthetic_dataset_equals_reference(seed, step, host, hosts):
    kw = dict(vocab=49155, seq_len=64, global_batch=8, seed=seed)
    got = SyntheticDataset(**kw).batch(step, host_index=host,
                                       num_hosts=hosts)
    want = JSynthetic(**kw).batch(step, host_index=host, num_hosts=hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (2, 5, 1, 2)])
def test_byte_dataset_equals_reference(tmp_path, seed, step, host, hosts):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"the quick brown fox jumps over the lazy dog " * 100)
    kw = dict(path=str(p), seq_len=32, global_batch=4, seed=seed)
    got = ByteDataset(**kw).batch(step, host_index=host, num_hosts=hosts)
    want = JByteDataset(**kw).batch(step, host_index=host, num_hosts=hosts)
    assert ByteDataset(**kw).vocab == 257
    for k in want:
        assert got[k].shape == (4 // hosts, 32)
        assert np.array_equal(got[k], want[k])


def test_synthetic_determinism_and_alignment():
    ds = SyntheticDataset(vocab=100, seq_len=32, global_batch=8, seed=5)
    a, b, c = ds.batch(3), ds.batch(3), ds.batch(4)
    assert (a["tokens"] == b["tokens"]).all()
    assert not (a["tokens"] == c["tokens"]).all()
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()


# -- fault tolerance --------------------------------------------------------

@given(st.integers(16, 4096), st.sampled_from([4, 8, 16]))
@settings(max_examples=100, deadline=None)
def test_elastic_plan_properties(devices, tp):
    if devices < tp:
        return
    plan = plan_elastic_mesh(devices, model_parallel=tp)
    used = plan.mesh_shape[0] * plan.mesh_shape[1]
    assert plan.mesh_shape[1] == tp          # TP degree preserved
    assert used + plan.dropped_devices == devices
    assert plan.dropped_devices < tp         # drop less than one TP group


def test_elastic_plan_preserves_global_batch():
    plan = plan_elastic_mesh(12 * 16, model_parallel=16, prefer_data=16)
    assert plan.mesh_shape == (12, 16)
    assert plan.grad_accum_multiplier == 2   # 16/12 -> ceil = 2


def test_elastic_rejects_undersized():
    with pytest.raises(ValueError):
        plan_elastic_mesh(8, model_parallel=16)


def test_straggler_detector():
    det = StragglerDetector(threshold=1.5, min_samples=3)
    for step in range(6):
        for h in range(8):
            t = 1.0 if h != 3 else 2.5       # host 3 is slow
            det.record(f"host-{h}", t + 0.01 * step)
    reports = det.check()
    assert len(reports) == 1
    assert reports[0].host == "host-3"
    assert reports[0].advice in ("trace-paths", "rebalance", "evict")


def test_straggler_needs_samples():
    det = StragglerDetector(min_samples=3)
    det.record("a", 1.0)
    det.record("b", 9.0)
    assert det.check() == []


def test_run_with_restarts_resumes_from_checkpoint(small_model):
    """A host failure mid-training: the loop restores the latest
    checkpoint and ends with the same final weights, bit for bit, as an
    uninterrupted run (the data pipeline is step-indexed)."""
    model, cfg = small_model
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    step = make_train_step(model, tc)
    total = 6

    def reference():
        params, opt = init_train_state(model, tc, 0)
        for i in range(total):
            params, opt, _ = step(params, opt, ds.batch(i))
        return params

    with tempfile.TemporaryDirectory() as d:
        state = {}

        def train_loop(start_step: int) -> int:
            if latest_step(d) is not None:
                live = {"params": state["params"], "opt": state["opt"]}
                template = _blank(live)
                restored, start = restore(d, template, device="cpu")
                assert not _shares_storage(restored, [live, template])
                params, opt = restored["params"], restored["opt"]
            else:
                params, opt = init_train_state(model, tc, 0)
                start = 0
            for i in range(start, total):
                params, opt, _ = step(params, opt, ds.batch(i))
                state["params"], state["opt"] = params, opt
                save(d, i + 1, {"params": params, "opt": opt})
                if i == 2 and not state.get("failed"):
                    state["failed"] = True
                    raise HostFailure("injected collective timeout")
            state["final"] = params
            return total

        assert run_with_restarts(train_loop, max_restarts=2) == total
        assert state["failed"]

    assert _equal(state["final"], reference())


def test_restart_limit():
    calls = {"n": 0}

    def always_fails(start):
        calls["n"] += 1
        raise HostFailure("boom")

    with pytest.raises(HostFailure):
        run_with_restarts(always_fails, max_restarts=2)
    assert calls["n"] == 3
