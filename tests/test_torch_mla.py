"""The port's multi-head latent attention (``models/attention.py``
``mla_forward``) and deepseek-v2-lite-16b on the CPU against the JAX
package.

Reduced deepseek (``ARCHS["deepseek-v2-lite-16b"].reduced()``: a dense
MLA layer 0 ahead of 3 MoE layers of 8 experts, top 2, one shared
expert; 4 heads, latent 32, q/k of nope 32 + rope 16, v 32, vocab 512)
on numpy-drawn weights (``_torch_lm``).  MLA's prefill attends over q/k
of 48 and v of 32, so a long one takes ``chunked_attention`` and never
the flash op, which takes one head dim; its decode is the absorbed form
over the latent cache.  Tolerances relative to the reference's largest
|value|: f32 1e-5, bf16 5e-2.  As with qwen2-moe-a2.7b
(``tests/test_torch_moe.py``), the whole model is held in f32 and its
MLA and MoE layers alone in bf16: in bf16 a near-tie between experts
goes either way on the last bit of the router's logits.
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
from repro.models import moe as JMoE  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "deepseek-v2-lite-16b"


@pytest.fixture
def attention_calls(monkeypatch):
    """Calls of the flash op and of ``chunked_attention`` made through
    ``attention_any``."""
    calls = {"flash": 0, "chunked": 0}
    for name, key in (("flash_attention", "flash"),
                      ("chunked_attention", "chunked")):
        real = getattr(TAtt, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(TAtt, name, spy)
    return calls


def test_config_fields_equal_the_jax_config():
    for j, t in ((J.ARCHS[NAME], T.ARCHS[NAME]),
                 (J.ARCHS[NAME].reduced(), T.ARCHS[NAME].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.hd == j.hd
    full = T.ARCHS[NAME]
    assert (full.num_layers, full.moe.first_dense_layers, full.d_ff) == \
        (27, 1, 10944)
    assert full.mla.qk_nope_dim + full.mla.qk_rope_dim == 192
    assert full.mla.v_head_dim == 128


def _shapes(spec):
    """A cache spec's tree with each (shape, dtype) leaf cut to its
    shape."""
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec[0])


def test_tree_and_cache_layout_are_the_jax_layout():
    """``layer0`` (a dense SwiGLU of d_ff) ahead of a stack of L - 1 MoE
    layers; the cache is {"layer0": {"latent"}, "layers": {"latent"}}
    of latent ++ rotary key, as in the reference."""
    jcfg, tcfg = cfgs(NAME, "bfloat16")
    params = Model(tcfg, device="cpu").init(0)
    assert len(params["layers"]) == tcfg.num_layers - 1
    assert set(params["layer0"]["mlp"]) == {"w_gate", "w_up", "w_down"}
    assert tuple(params["layer0"]["mlp"]["w_up"].shape) == \
        (tcfg.d_model, tcfg.d_ff)
    assert "router" in params["layers"][0]["mlp"]
    got = cache_specs(tcfg, 2, 24)
    assert _shapes(got) == _shapes(JModel(jcfg).cache_specs(2, 24))
    assert got["layers"]["latent"][0] == (3, 2, 24, 48)
    cache = Model(tcfg, device="cpu").init_cache(2, 24)
    assert cache["layer0"]["latent"].dtype is torch.bfloat16


def _mla_case(dtype, S, seed=2):
    jcfg, tcfg = cfgs(NAME, dtype)
    tree = numpy_params(tcfg, seed)
    jp = {k: jnp.asarray(v[0], jcfg.param_dtype())
          for k, v in tree["layers"]["attn"].items()}             # layer 1
    tp = {k: to_torch(v, tcfg.param_dtype()) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    return jcfg, tcfg, jp, tp, jx, to_torch(jx, tcfg.param_dtype())


@pytest.mark.parametrize("S", [64, 2176])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_jax(attention_calls, dtype, S):
    """S 2,176 > 2,048: q/k of 48 and v of 32 go to ``chunked_attention``
    by the shape branch, not to the flash op."""
    jcfg, tcfg, jp, tp, jx, tx = _mla_case(dtype, S)
    jy, _ = JAtt.mla_forward(jp, jcfg, jx,
                             positions=jnp.broadcast_to(jnp.arange(S), (B, S)))
    ty, none = TAtt.mla_forward(tp, tcfg, tx, positions=torch.arange(S))
    assert none is None and ty.dtype == tx.dtype
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)
    assert attention_calls == {"flash": 0, "chunked": int(S > TAtt.LONG_SEQ)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_absorbed_decode_matches_jax(dtype):
    """The cache written as S - 1 tokens in one call, then one token: the
    output and the latent cache against the reference's."""
    S, Smax = 12, 16
    jcfg, tcfg, jp, tp, jx, tx = _mla_case(dtype, S)
    m = tcfg.mla
    shape = (B, Smax, m.kv_lora_rank + m.qk_rope_dim)
    jc = {"latent": jnp.zeros(shape, jcfg.param_dtype())}
    tc = {"latent": torch.zeros(shape, dtype=tcfg.param_dtype())}
    for lo, hi in ((0, S - 1), (S - 1, S)):
        jy, jc = JAtt.mla_forward(
            jp, jcfg, jx[:, lo:hi], cache=jc, cache_index=jnp.int32(lo),
            positions=jnp.broadcast_to(jnp.arange(lo, hi), (B, hi - lo)))
        ty, tc2 = TAtt.mla_forward(tp, tcfg, tx[:, lo:hi], cache=tc,
                                   cache_index=lo,
                                   positions=torch.arange(lo, hi))
        assert tc2 is tc                                     # written in place
        assert_rel(ty.float(), jy.astype(jnp.float32), dtype)
    assert_rel(tc["latent"].float(), jc["latent"].astype(jnp.float32), dtype)
    with pytest.raises(ValueError, match="max_len"):
        TAtt.mla_forward(tp, tcfg, tx[:, :1], cache=tc, cache_index=Smax,
                         positions=torch.arange(Smax, Smax + 1))


def test_absorbed_decode_equals_decompressed_prefill():
    """MLA's two algebraic forms, f32: the absorbed decode of the last
    token against the decompressed prefill's last position."""
    S = 40
    _, tcfg, _, tp, _, tx = _mla_case("float32", S, seed=4)
    full, _ = TAtt.mla_forward(tp, tcfg, tx, positions=torch.arange(S))
    m = tcfg.mla
    cache = {"latent": torch.zeros((B, S, m.kv_lora_rank + m.qk_rope_dim))}
    TAtt.mla_forward(tp, tcfg, tx[:, :-1], cache=cache, cache_index=0,
                     positions=torch.arange(S - 1))
    last, _ = TAtt.mla_forward(tp, tcfg, tx[:, -1:], cache=cache,
                               cache_index=S - 1,
                               positions=torch.arange(S - 1, S))
    assert_rel(last[:, 0], full[:, -1], "float32")


def test_mla_decode_rounds_the_summed_scores_in_the_working_type(
        monkeypatch):
    """bf16: the latent and rotary score products are added in bf16 and
    only the sum is cast to f32, as the reference does."""
    S = 6
    _, tcfg, _, tp, _, tx = _mla_case("bfloat16", S)
    m = tcfg.mla
    cache = {"latent": torch.zeros((B, S, m.kv_lora_rank + m.qk_rope_dim),
                                   dtype=torch.bfloat16)}
    seen = []
    real = torch.softmax
    monkeypatch.setattr(TAtt.torch, "softmax",
                        lambda t, **kw: seen.append(t) or real(t, **kw))
    TAtt.mla_forward(tp, tcfg, tx, cache=cache, cache_index=0,
                     positions=torch.arange(S))
    (scores,) = seen
    assert scores.dtype is torch.float32
    finite = scores[scores > -1e29] * np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    # every score was a bf16 value before the f32 scale
    assert torch.allclose(finite, finite.to(torch.bfloat16).float(),
                          rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(dtype):
    """One of deepseek's MoE layers (a shared expert of width 1 x 64 here)
    on the same input, dropping at the config's capacity factor."""
    jcfg, tcfg = cfgs(NAME, dtype)
    p = jax.tree.map(lambda a: a[0], numpy_params(tcfg, 3)["layers"]["mlp"])
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype()), p)
    tp = jax.tree.map(lambda a: to_torch(a, tcfg.param_dtype()), jp)
    x = np.random.default_rng(4).standard_normal(
        (B, 64, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    jy, _ = JMoE.moe_forward(jp, jcfg, jx)
    ty, _ = TMoE.moe_forward(tp, tcfg, to_torch(jx, tcfg.param_dtype()))
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)


@pytest.mark.parametrize("S", [64, 2176])
def test_prefill_logits_match_jax(attention_calls, S):
    jm, jp, tm, tp = both_models(NAME, "float32")
    toks = tokens(S, tm.cfg.vocab)
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert attention_calls["flash"] == 0
    assert attention_calls["chunked"] == (tm.cfg.num_layers if S > 2048
                                          else 0)
    assert_rel(got, want, "float32")


def test_generate_greedy_tokens_equal_jax():
    jm, jp, tm, tp = both_models(NAME, "float32", seed=5)
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=6)
    got = ServeEngine(tm, batch_size=B, max_len=16).generate(
        tp, torch.from_numpy(prompt), steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_prefill_drop_free():
    """Token-by-token absorbed decode == the decompressed full forward
    once nothing drops (capacity factor E)."""
    moe = cfgs(NAME)[1].moe
    _, _, tm, tp = both_models(NAME, "float32", seed=4, moe=dataclasses.replace(
        moe, capacity_factor=float(moe.num_experts)))
    T_ = 8
    toks = torch.from_numpy(tokens(T_, tm.cfg.vocab, mult=11))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(B, T_)
    outs = []
    for i in range(T_):
        logits, cache = tm.decode_step(tp, cache,
                                       {"tokens": toks[:, i:i + 1]}, i)
        outs.append(logits[:, 0])
    dec = torch.stack(outs, dim=1)
    assert_rel(dec, full, "float32")
    assert torch.equal(dec.argmax(-1), full.argmax(-1))
