"""The port's encoder-decoder (layer norm, the GELU MLP, the encoder,
cross-attention and the decoder) and whisper-large-v3 on the CPU
against the JAX package.

Reduced whisper (``ARCHS["whisper-large-v3"].reduced()``: 2 encoder and
4 decoder layers, d_model 128, 4 heads over 4, hd 32, vocab 512,
encoder sequence 16) on numpy-drawn weights with every layer norm's and
MLP's bias drawn nonzero (``_torch_lm``), where the init makes them
zero.  The encoder runs on seeded frame embeddings (``enc_embeds``); a
batch that gives ``enc_memory`` skips it.  Tolerances relative to the
reference's largest |value|: f32 1e-5, bf16 5e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    B, assert_rel, both_models, cfgs, numpy_params, to_torch, tokens,
)
from repro import configs as J  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as JAtt  # noqa: E402
from repro.models import common as JCom  # noqa: E402
from repro.models import lm as JLm  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models import common as TCom  # noqa: E402
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "whisper-large-v3"
SE = 16                                      # the reduced encoder sequence


def _frames(seed=1, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, SE, 128)).astype(np.float32)


def test_config_fields_equal_the_jax_config():
    for j, t in ((J.ARCHS[NAME], T.ARCHS[NAME]),
                 (J.ARCHS[NAME].reduced(), T.ARCHS[NAME].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    full = T.ARCHS[NAME]
    assert (full.num_layers, full.encdec.num_encoder_layers,
            full.encdec.encoder_seq, full.hd) == (32, 32, 1500, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 16, 128)).astype(np.float32) * 3 + 2
    s, b = (rng.standard_normal(128).astype(np.float32) for _ in range(2))
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    T_ = [torch.from_numpy(a).to(tt) for a in (x, s, b)]
    got = TCom.layer_norm(*T_, 1e-5)
    assert got.dtype is tt
    assert_rel(got.float(), JCom.layer_norm(
        *(jnp.asarray(a, jt) for a in (x, s, b)), 1e-5).astype(jnp.float32),
        dtype)
    ws = [rng.standard_normal(sh).astype(np.float32) * std for sh, std in
          (((128, 256), 128 ** -0.5), ((256,), 0.3), ((256, 128), 256 ** -0.5),
           ((128,), 0.3))]
    got = TCom.gelu_mlp(*(torch.from_numpy(a).to(tt) for a in [x] + ws))
    want = JCom.gelu_mlp(*(jnp.asarray(a, jt) for a in [x] + ws))
    assert_rel(got.float(), want.astype(jnp.float32), dtype)


def test_layer_norm_normalises_in_the_working_type():
    """bf16: ``d = x - mu`` and the scale and bias in bf16, as the
    reference rounds; ``F.layer_norm`` (f32 throughout, one rounding)
    gives other bits."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)
                         * 3 + 5).to(torch.bfloat16)
    s, b = (torch.from_numpy(rng.standard_normal(128).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    got = TCom.layer_norm(x, s, b)
    mu = x.float().mean(-1, keepdim=True).to(torch.bfloat16)
    d = x - mu
    inv = torch.rsqrt(d.float().square().mean(-1, keepdim=True) + 1e-5)
    assert torch.equal(got, d * inv.to(torch.bfloat16) * s + b)
    fused = torch.nn.functional.layer_norm(x.float(), (128,), s.float(),
                                           b.float()).to(torch.bfloat16)
    assert not torch.equal(got, fused)


def _layer(tree, stack, part, jcfg, tcfg):
    jp = jax.tree.map(lambda a: jnp.asarray(a[0], jcfg.param_dtype()),
                      tree[stack][part])
    return jp, jax.tree.map(lambda a: to_torch(a, tcfg.param_dtype()), jp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_forward_matches_jax(dtype):
    jcfg, tcfg = cfgs(NAME, dtype)
    jp, tp = _layer(numpy_params(tcfg, 2), "layers", "cross", jcfg, tcfg)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, 12, 128)), jcfg.param_dtype())
    mem = jnp.asarray(_frames(4), jcfg.param_dtype())
    want = JAtt.cross_forward(jp, jcfg, x, mem)
    got = TAtt.cross_forward(tp, tcfg, to_torch(x, tcfg.param_dtype()),
                             to_torch(mem, tcfg.param_dtype()))
    assert_rel(got.float(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """Non-causal self-attention over the frames; the final norm takes
    the decoder's ``final_norm`` scale with ``enc_final_norm_b``, as the
    reference's does."""
    jm, jp, tm, tp = both_models(NAME, dtype)
    frames = _frames()
    want = JLm._run_encoder(jp, jm.cfg, jnp.asarray(frames),
                            JLm.RematPolicy(enabled=False))
    got = tm.encode(tp, torch.from_numpy(frames))
    assert got.shape == (B, SE, 128) and got.dtype == tm.cfg.param_dtype()
    assert_rel(got.float(), want.astype(jnp.float32), dtype)
    # the borrowed scale: the decoder's final_norm moves the memory
    moved = dict(tp, final_norm=tp["final_norm"] * 2)
    assert not torch.allclose(tm.encode(moved, torch.from_numpy(frames)), got)
    # not causal: the last frame moves the first frame's memory
    late = frames.copy()
    late[:, -1] += 1
    assert not torch.allclose(tm.encode(tp, torch.from_numpy(late))[:, 0],
                              got[:, 0])


def test_cache_holds_the_decoders_self_attention_only():
    jcfg, tcfg = cfgs(NAME, "bfloat16")
    jspec = JModel(jcfg).cache_specs(3, 10)
    assert {k: s for k, (s, _) in cache_specs(tcfg, 3, 10).items()} == \
        {k: s for k, (s, _) in jspec.items()}
    assert cache_specs(tcfg, 3, 10)["k"][0][0] == tcfg.num_layers
    params = Model(tcfg, device="cpu").init(0)
    assert len(params["encoder"]) == tcfg.encdec.num_encoder_layers
    assert len(params["layers"]) == tcfg.num_layers
    assert not bool(params["final_norm_b"].any())      # zero at init


@pytest.mark.parametrize("S", [64, 2176])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(monkeypatch, dtype, S):
    """S decoder tokens over the encoder's memory of 16 frames, once from
    ``enc_embeds`` (the encoder runs) and once from ``enc_memory``; the
    decoder's S 2,176 self-attention takes the flash op (its plain
    version on the CPU), cross-attention ``plain_attention``."""
    jm, jp, tm, tp = both_models(NAME, dtype)
    flash_calls = []
    real = TAtt.flash_attention
    monkeypatch.setattr(TAtt, "flash_attention", lambda *a, **kw: (
        flash_calls.append(1), real(*a, **kw))[1])
    toks, frames = tokens(S, tm.cfg.vocab), _frames()
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                    "enc_embeds": jnp.asarray(frames)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                          "enc_embeds": torch.from_numpy(frames)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert len(flash_calls) == (tm.cfg.num_layers if S > 2048 else 0)
    assert_rel(got.float(), want.astype(jnp.float32), dtype)
    memory = tm.encode(tp, torch.from_numpy(frames))
    again = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "enc_memory": memory}, last_only=True)
    assert torch.equal(again[:, 0], got[:, -1])


def test_generate_greedy_tokens_equal_jax():
    """``extra_batch={"enc_memory": ...}`` joins every decode step."""
    jm, jp, tm, tp = both_models(NAME, "float32", seed=5)
    frames = _frames(6)
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    jmem = JLm._run_encoder(jp, jm.cfg, jnp.asarray(frames),
                            JLm.RematPolicy(enabled=False))
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=6, extra_batch={"enc_memory": jmem})
    mem = tm.encode(tp, torch.from_numpy(frames))
    eng = ServeEngine(tm, batch_size=B, max_len=16)
    got, chosen_from = eng.generate(tp, torch.from_numpy(prompt), steps=6,
                                    extra_batch={"enc_memory": mem},
                                    return_logits=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prefill = eng.prefill_logits(tp, {"tokens": torch.from_numpy(prompt),
                                      "enc_memory": mem})
    assert_rel(chosen_from[:, 0], prefill[:, -1], "float32")
