"""The port's M-RoPE (``models/common.py`` ``mrope_tables`` /
``apply_mrope``) and qwen2-vl-72b on the CPU against the JAX package.

Reduced qwen2-vl (``ARCHS["qwen2-vl-72b"].reduced()``: 4 layers,
d_model 128, 4 heads over 2, hd 32, sections (4, 6, 6), q/k/v biases,
vocab 512) on numpy-drawn weights with nonzero biases (``_torch_lm``).
The backbone takes patch and token embeddings (``embeds``, drawn from
a seed) and three position streams laid out as Qwen2-VL lays out an
image between two runs of text (``_torch_lm.mrope_positions``), so the
streams differ.  Tolerances relative to the reference's largest
|value|: f32 1e-5, bf16 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    B, assert_rel, both_models, cfgs, mrope_positions, numpy_params,
    to_torch,
)
from repro import configs as J  # noqa: E402
from repro.models import attention as JAtt  # noqa: E402
from repro.models import common as JCom  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models import common as TCom  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "qwen2-vl-72b"


def _embeds(S, D=128, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def test_config_fields_equal_the_jax_config():
    for j, t in ((J.ARCHS[NAME], T.ARCHS[NAME]),
                 (J.ARCHS[NAME].reduced(), T.ARCHS[NAME].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert sum(t.mrope_sections) == t.hd // 2
    assert T.ARCHS[NAME].mrope_sections == (16, 24, 24)
    assert T.ARCHS[NAME].reduced().mrope_sections == (4, 6, 6)


def test_positions_lay_an_image_between_two_text_runs():
    pos = mrope_positions(48, 8, 4)
    assert pos.shape == (3, B, 48)
    assert (pos[:, :, :8] == np.arange(8)).all()             # text: equal
    assert (pos[0, :, 8:24] == 8).all()                      # one frame
    assert (pos[1, 0, 8:24] == 8 + np.repeat(np.arange(4), 4)).all()
    assert (pos[2, 0, 8:24] == 8 + np.tile(np.arange(4), 4)).all()
    assert (pos[:, :, 24] == 12).all()                       # max + 1
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    S, hd, sections = 40, 32, (4, 6, 6)
    x = rng.standard_normal((B, S, 4, hd)).astype(np.float32)
    pos = mrope_positions(S, 6, 5)
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JCom.apply_mrope(jnp.asarray(x, jt), jnp.asarray(pos), sections,
                            1e6)
    got = TCom.apply_mrope(torch.from_numpy(x).to(tt), torch.from_numpy(pos),
                           sections, 1e6)
    assert got.dtype is tt
    assert_rel(got.float(), want.astype(jnp.float32), dtype)
    # the streams matter: 1-D RoPE at the temporal stream is well off
    flat = TCom.apply_rope(torch.from_numpy(x).to(tt),
                           torch.from_numpy(pos[0, 0]), 1e6)
    with pytest.raises(AssertionError):
        assert_rel(flat.float(), want.astype(jnp.float32), dtype)
    with pytest.raises(ValueError, match="sum"):
        TCom.mrope_tables(torch.from_numpy(pos), (4, 6, 5), hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_forward_with_mrope_matches_jax(dtype):
    jcfg, tcfg = cfgs(NAME, dtype)
    jp = {k: jnp.asarray(v[0], jcfg.param_dtype())
          for k, v in numpy_params(tcfg, 2)["layers"]["attn"].items()}
    tp = {k: to_torch(v, tcfg.param_dtype()) for k, v in jp.items()}
    S = 40
    jx = jnp.asarray(_embeds(S), jcfg.param_dtype())
    pos = mrope_positions(S, 6, 5)
    jy, _ = JAtt.gqa_forward(jp, jcfg, jx,
                             positions=jnp.broadcast_to(jnp.arange(S), (B, S)),
                             mrope_positions=jnp.asarray(pos))
    ty, _ = TAtt.gqa_forward(tp, tcfg, to_torch(jx, tcfg.param_dtype()),
                             positions=torch.arange(S),
                             mrope_positions=torch.from_numpy(pos))
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)


@pytest.mark.parametrize("S", [64, 2176])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(monkeypatch, dtype, S):
    """``embeds`` and ``mrope_positions`` through every layer; S 2,176
    positions take the flash op (its plain version on the CPU), a call a
    layer."""
    jm, jp, tm, tp = both_models(NAME, dtype)
    flash_calls = []
    real = TAtt.flash_attention
    monkeypatch.setattr(TAtt, "flash_attention", lambda *a, **kw: (
        flash_calls.append(1), real(*a, **kw))[1])
    emb = _embeds(S)
    pos = mrope_positions(S, S // 8, 4 if S < 1024 else 32)
    want = jax.jit(jm.prefill)(jp, {"embeds": jnp.asarray(emb),
                                    "mrope_positions": jnp.asarray(pos)})
    got = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                          "mrope_positions": torch.from_numpy(pos)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert got.dtype == tm.cfg.param_dtype()
    assert len(flash_calls) == (tm.cfg.num_layers if S > 2048 else 0)
    assert_rel(got.float(), want.astype(jnp.float32), dtype)


def test_generate_greedy_tokens_equal_jax():
    """``extra_batch`` joins every step unchanged: the same (3, B, 1)
    M-RoPE positions at each step, as the reference's ``generate``
    passes them."""
    jm, jp, tm, tp = both_models(NAME, "float32", seed=5)
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    pos = np.array([3, 40, 70])[:, None, None] * np.ones((3, B, 1), np.int64)
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=6,
        extra_batch={"mrope_positions": jnp.asarray(pos)})
    got = ServeEngine(tm, batch_size=B, max_len=16).generate(
        tp, torch.from_numpy(prompt), steps=6,
        extra_batch={"mrope_positions": torch.from_numpy(pos)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = ServeEngine(tm, batch_size=B, max_len=16).generate(
        tp, torch.from_numpy(prompt), steps=6)
    assert not torch.equal(plain, got)       # the positions were used


def test_without_positions_the_vlm_takes_1d_rope_as_the_reference():
    """Without ``mrope_positions`` the reference rotates by 1-D RoPE at
    the token positions; so does the port."""
    jm, jp, tm, tp = both_models(NAME, "float32")
    emb = _embeds(24)
    want = jax.jit(jm.prefill)(jp, {"embeds": jnp.asarray(emb)})
    got = tm.prefill(tp, {"embeds": torch.from_numpy(emb)})
    assert_rel(got, want, "float32")
