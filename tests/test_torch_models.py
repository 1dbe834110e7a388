"""The port's granite-3-2b stack on the CPU against the JAX package.

Reduced granite (``ARCHS["granite-3-2b"].reduced()``: 4 layers, d_model
128, 4 heads over 2 kv heads, hd 32, vocab 512).  Weights are drawn with
numpy at fan-in scales and carried to both packages; the JAX package's
own init reads its fan-in from the stacked layer axis (std 1/√L), which
blows the activations up and amplifies every rounding difference, so the
parity tests do not use it.

Tolerances, relative to the largest |logit| (or |value|) of the
reference: f32 1e-5 (measured about 2.5e-6: sums in another order);
bf16 5e-2 (8 significant bits, and the two packages round at other
points: the flash op keeps f32 scores where the XLA path rounds them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    B, assert_rel, cfgs, numpy_params, tokens,
)
from _torch_lm import both_models as _both_models  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import attention as JAtt  # noqa: E402
from repro.models import common as JCom  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, MLAConfig, get_arch  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models import common as TCom  # noqa: E402
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "granite-3-2b"


def _cfgs(dtype="float32", **kw):
    return cfgs(NAME, dtype, **kw)


def both_models(dtype="float32", seed=0, **kw):
    return _both_models(NAME, dtype, seed, **kw)


# -- configs -----------------------------------------------------------------


def test_config_fields_equal_the_jax_config():
    for full in (False, True):
        j, t = J_ARCHS["granite-3-2b"], ARCHS["granite-3-2b"]
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.hd == j.hd
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert ARCHS["granite-3-2b"].param_dtype() is torch.bfloat16


def test_registry_holds_only_what_the_port_runs():
    assert sorted(ARCHS) == ["codeqwen1.5-7b", "deepseek-v2-lite-16b",
                             "glm4-9b", "granite-3-2b", "jamba-1.5-large-398b",
                             "mamba2-1.3b", "qwen2-72b", "qwen2-moe-a2.7b",
                             "qwen2-vl-72b", "whisper-large-v3"]
    assert sorted(ARCHS) == sorted({get_arch(n).name for n in ARCHS})
    with pytest.raises(KeyError):
        get_arch("jamba-1.5-mini")                  # not a config of the repo
    for bad in (dict(family="hybrid"), dict(family="encdec"),
                dict(mrope_sections=(4, 6, 6)), dict(mla=MLAConfig())):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(ARCHS["granite-3-2b"], **bad),
                  device="cpu")
    moe = ARCHS["qwen2-moe-a2.7b"]
    for bad in (dict(moe=dataclasses.replace(moe.moe, first_dense_layers=2)),
                dict(moe=dataclasses.replace(moe.moe, every_k_layers=2)),
                dict(moe=None)):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(moe, **bad), device="cpu")


# -- components --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_swiglu_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 16, 128)).astype(np.float32) * 3
    s = rng.standard_normal(128).astype(np.float32)
    jt = getattr(jnp, dtype)
    tt = getattr(torch, dtype)
    assert_rel(TCom.rms_norm(torch.from_numpy(x).to(tt),
                             torch.from_numpy(s).to(tt)).float(),
               JCom.rms_norm(jnp.asarray(x, jt), jnp.asarray(s, jt)), dtype)

    h = rng.standard_normal((B, 16, 4, 32)).astype(np.float32)
    pos = np.arange(100, 116)
    assert_rel(TCom.apply_rope(torch.from_numpy(h).to(tt),
                               torch.from_numpy(pos), 1e4).float(),
               JCom.apply_rope(jnp.asarray(h, jt), jnp.asarray(pos), 1e4),
               dtype)

    ws = [rng.standard_normal(sh).astype(np.float32) / np.sqrt(sh[0])
          for sh in ((128, 256), (128, 256), (256, 128))]
    assert_rel(TCom.swiglu(*(torch.from_numpy(a).to(tt) for a in [x] + ws))
               .float(), JCom.swiglu(*(jnp.asarray(a, jt) for a in [x] + ws)),
               dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_forward_prefill_and_cached_decode_match_jax(dtype):
    jcfg, tcfg = _cfgs(dtype)
    tree = numpy_params(tcfg, 2)
    p_np = {k: v[0] for k, v in tree["layers"]["attn"].items()}   # layer 0
    jp = {k: jnp.asarray(v, jcfg.param_dtype()) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(tcfg.param_dtype())
          for k, v in jp.items()}
    S, Smax = 12, 16
    x = np.random.default_rng(3).standard_normal((B, S, 128)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    tx = torch.from_numpy(x).to(tcfg.param_dtype())
    pos = np.arange(S)

    jy, _ = JAtt.gqa_forward(jp, jcfg, jx, positions=jnp.broadcast_to(pos, (B, S)))
    ty, none = TAtt.gqa_forward(tp, tcfg, tx, positions=torch.from_numpy(pos))
    assert none is None
    assert_rel(ty.float(), jy, dtype)

    # cached decode: the first S - 1 tokens as one write, then one token
    shape = (B, Smax, tcfg.num_kv_heads, tcfg.hd)
    jc = {n: jnp.zeros(shape, jcfg.param_dtype()) for n in "kv"}
    tc = {n: torch.zeros(shape, dtype=tcfg.param_dtype()) for n in "kv"}
    for lo, hi in ((0, S - 1), (S - 1, S)):
        jy, jc = JAtt.gqa_forward(
            jp, jcfg, jx[:, lo:hi], cache=jc, cache_index=jnp.int32(lo),
            positions=jnp.broadcast_to(jnp.arange(lo, hi), (B, hi - lo)))
        ty, tc2 = TAtt.gqa_forward(
            tp, tcfg, tx[:, lo:hi], cache=tc, cache_index=lo,
            positions=torch.arange(lo, hi))
        assert tc2 is tc                                     # written in place
        assert_rel(ty.float(), jy, dtype)
    for n in "kv":
        assert_rel(tc[n].float(), jc[n], dtype)


def test_cache_write_past_max_len_raises():
    _, tcfg = _cfgs()
    model = Model(tcfg, device="cpu")
    params = model.init(0)
    cache = model.init_cache(B, 4)
    tok = {"tokens": torch.zeros((B, 1), dtype=torch.int64)}
    model.decode_step(params, cache, tok, 3)
    with pytest.raises(ValueError, match="max_len"):
        model.decode_step(params, cache, tok, 4)
    eng = ServeEngine(model, batch_size=B, max_len=6)
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(params, torch.zeros((B, 4), dtype=torch.int64), steps=4)


def test_cache_layout_is_the_jax_layout():
    jcfg, tcfg = _cfgs("bfloat16")
    jspec = JModel(jcfg).cache_specs(3, 10)
    tspec = cache_specs(tcfg, 3, 10)
    assert {k: s for k, (s, _) in tspec.items()} == \
        {k: s for k, (s, _) in jspec.items()}
    cache = Model(tcfg, device="cpu").init_cache(3, 10)
    assert cache["k"].dtype is torch.bfloat16
    assert tuple(cache["v"].shape) == jspec["v"][0]


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 2176])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(monkeypatch, dtype, S):
    """S = 2,176 > 2,048 takes the long branch: the flash op in the port,
    the XLA chunked twin of the Pallas kernel in the JAX package."""
    jm, jp, tm, tp = both_models(dtype)
    flash_calls = []
    real = TAtt.flash_attention
    monkeypatch.setattr(TAtt, "flash_attention", lambda *a, **kw: (
        flash_calls.append(1), real(*a, **kw))[1])
    toks = tokens(S, tm.cfg.vocab)
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert got.dtype == tm.cfg.param_dtype()
    assert len(flash_calls) == (tm.cfg.num_layers if S > 2048 else 0)
    assert_rel(got.float(), want.astype(jnp.float32), dtype)
    last = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, last_only=True)
    assert_rel(last.float(), got[:, -1:].float(), dtype)


def test_decode_matches_prefill():
    """Token-by-token decode with the cache == the full forward (the
    port of the reference's cache-correctness property, granite, f32)."""
    _, _, tm, tp = both_models("float32", seed=4)
    T = 8
    toks = torch.from_numpy(tokens(T, tm.cfg.vocab, mult=11))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(B, T)
    outs = []
    for i in range(T):
        logits, cache = tm.decode_step(tp, cache, {"tokens": toks[:, i:i + 1]}, i)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((dec - full).abs().max()) < 5e-3
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_sliding_window_masks_decode():
    """With a window, decode logits ignore tokens beyond it."""
    _, _, tm, tp = both_models("bfloat16", num_layers=2)
    T = 12
    toks1 = torch.from_numpy(tokens(T, tm.cfg.vocab, mult=1))
    toks2 = toks1.clone()
    toks2[:, 0] = (toks2[:, 0] + 17) % tm.cfg.vocab            # differ at pos 0

    def run(toks, win):
        cache = tm.init_cache(B, T)
        for i in range(T):
            logits, cache = tm.decode_step(
                tp, cache, {"tokens": toks[:, i:i + 1]}, i, window=win)
        return logits.float()

    assert torch.allclose(run(toks1, 4), run(toks2, 4), atol=1e-6)
    assert not torch.allclose(run(toks1, 0), run(toks2, 0), atol=1e-6)


def test_generate_greedy_tokens_equal_jax_and_prefill_argmax():
    jm, jp, tm, tp = both_models("float32", seed=5)
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=6)
    eng = ServeEngine(tm, batch_size=B, max_len=16)
    got, chosen_from = eng.generate(tp, torch.from_numpy(prompt), steps=6,
                                    return_logits=True)
    assert got.shape == (B, 10) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prefill = eng.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)})
    assert torch.equal(got[:, 4], prefill[:, -1].argmax(-1))
    assert chosen_from.shape == (B, 6, tm.cfg.vocab)
    torch.testing.assert_close(chosen_from[:, 0], prefill[:, -1],
                               atol=5e-3, rtol=0)


def test_sampling_with_a_seeded_generator_is_deterministic():
    _, tcfg = _cfgs()
    model = Model(tcfg, device="cpu")
    params = model.init(6)
    eng = ServeEngine(model, batch_size=B, max_len=12)
    prompt = torch.from_numpy(tokens(3, tcfg.vocab))

    def sample(seed):
        g = torch.Generator().manual_seed(seed)
        return eng.generate(params, prompt, steps=8, temperature=1.0,
                            generator=g)

    a, b = sample(0), sample(0)
    assert torch.equal(a, b) and torch.equal(a[:, :3], prompt.long())
    assert not torch.equal(sample(0), sample(1))


def test_init_is_seeded_and_at_the_reference_scales():
    _, tcfg = _cfgs()
    model = Model(tcfg, device="cpu")
    p0, p1 = model.init(0), model.init(0)
    assert torch.equal(p0["layers"][3]["mlp"]["w_down"],
                       p1["layers"][3]["mlp"]["w_down"])
    assert not torch.equal(p0["layers"][0]["attn"]["wq"],
                           p0["layers"][1]["attn"]["wq"])
    ref = jax.tree.map(np.asarray, JModel(_cfgs()[0]).init(jax.random.PRNGKey(0)))
    carried = lm_params_from_numpy(tcfg, ref, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p0) == \
        jax.tree.map(lambda t: tuple(t.shape), carried)
    wq = p0["layers"][0]["attn"]["wq"]                # (d_model, H * hd)
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    assert abs(float(p0["embed"].std()) / 0.02 - 1) < 0.05


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy(tcfg, numpy_params(tcfg))
