"""The port's dense LMs with q/k/v biases (glm4-9b, codeqwen1.5-7b,
qwen2-72b) and its config surface, on the CPU against the JAX package.

Reduced configs (4 layers, d_model 128, hd 32, vocab 512, untied
lm_head) on numpy-drawn weights with nonzero biases (``_torch_lm``).
Tolerances relative to the reference's largest |value|: f32 1e-5, bf16
5e-2, as ``tests/test_torch_models.py``.  qwen2-moe-a2.7b (also biased)
is held in ``tests/test_torch_moe.py``.
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
from repro.models.common import count_params as j_count_params  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models.common import count_params  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

BIASED = ["glm4-9b", "codeqwen1.5-7b", "qwen2-72b"]
NEW = BIASED + ["qwen2-moe-a2.7b"]


# -- the config surface ------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_config_fields_equal_the_jax_config(name):
    for j, t in ((J.ARCHS[name], T.ARCHS[name]),
                 (J.ARCHS[name].reduced(), T.ARCHS[name].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.hd, t.attention_free, t.sub_quadratic) == \
            (j.hd, j.attention_free, j.sub_quadratic)
    assert T.ARCHS[name].qkv_bias and T.ARCHS[name].hd == 128
    assert T.ARCHS[name].param_dtype() is torch.bfloat16


def test_shapes_cells_and_lookups_equal_the_jax_package():
    for n, s in T.SHAPES.items():
        assert s.is_decode == J.SHAPES[n].is_decode
        assert dataclasses.asdict(T.get_shape(n)) == \
            dataclasses.asdict(J.get_shape(n))
    with pytest.raises(KeyError):
        T.get_shape("prefill_1m")
    for n, a in T.ARCHS.items():
        assert [s.name for s in T.applicable_shapes(a)] == \
            [s.name for s in J.applicable_shapes(J.ARCHS[n])]
    want = [(a.name, s.name) for a, s in J.all_cells() if a.name in T.ARCHS]
    assert [(a.name, s.name) for a, s in T.all_cells()] == want
    assert ("mamba2-1.3b", "long_500k") in want            # sub-quadratic
    assert ("glm4-9b", "long_500k") not in want


@pytest.mark.parametrize("name", sorted(T.ARCHS))
def test_count_params_equals_the_jax_package(name):
    cfg = T.ARCHS[name].reduced()
    want = j_count_params(jax.eval_shape(JModel(J.ARCHS[name].reduced()).init,
                                         jax.random.PRNGKey(0)))
    assert count_params(Model(cfg, device="cpu").init(0)) == want


def test_init_makes_zero_biases_like_the_reference():
    params = Model(T.ARCHS["glm4-9b"].reduced(), device="cpu").init(0)
    attn = params["layers"][0]["attn"]
    cfg = T.ARCHS["glm4-9b"].reduced()
    assert tuple(attn["bq"].shape) == (cfg.num_heads * cfg.hd,)
    assert tuple(attn["bk"].shape) == (cfg.num_kv_heads * cfg.hd,)
    assert not any(bool(attn[b].any()) for b in ("bq", "bk", "bv"))
    assert "lm_head" in params                              # untied


# -- attention with biases ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_forward_with_bias_prefill_and_cached_decode_match_jax(dtype):
    jcfg, tcfg = cfgs("glm4-9b", dtype)
    tree = numpy_params(tcfg, 2)
    jp = {k: jnp.asarray(v[0], jcfg.param_dtype())
          for k, v in tree["layers"]["attn"].items()}           # layer 0
    assert all(bool(jnp.any(jp[b] != 0)) for b in ("bq", "bk", "bv"))
    tp = {k: to_torch(v, tcfg.param_dtype()) for k, v in jp.items()}
    S, Smax = 12, 16
    x = np.random.default_rng(3).standard_normal((B, S, 128)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    tx = to_torch(jx, tcfg.param_dtype())

    jy, _ = JAtt.gqa_forward(jp, jcfg, jx,
                             positions=jnp.broadcast_to(jnp.arange(S), (B, S)))
    ty, _ = TAtt.gqa_forward(tp, tcfg, tx, positions=torch.arange(S))
    assert_rel(ty.float(), jy, dtype)
    # the biases matter: without them the output moves well past the limit
    unbiased = {k: v for k, v in tp.items() if not k.startswith("b")}
    ty0, _ = TAtt.gqa_forward(unbiased, dataclasses.replace(
        tcfg, qkv_bias=False), tx, positions=torch.arange(S))
    with pytest.raises(AssertionError):
        assert_rel(ty0.float(), jy, dtype)

    shape = (B, Smax, tcfg.num_kv_heads, tcfg.hd)
    jc = {n: jnp.zeros(shape, jcfg.param_dtype()) for n in "kv"}
    tc = {n: torch.zeros(shape, dtype=tcfg.param_dtype()) for n in "kv"}
    for lo, hi in ((0, S - 1), (S - 1, S)):
        jy, jc = JAtt.gqa_forward(
            jp, jcfg, jx[:, lo:hi], cache=jc, cache_index=jnp.int32(lo),
            positions=jnp.broadcast_to(jnp.arange(lo, hi), (B, hi - lo)))
        ty, tc = TAtt.gqa_forward(
            tp, tcfg, tx[:, lo:hi], cache=tc, cache_index=lo,
            positions=torch.arange(lo, hi))
        assert_rel(ty.float(), jy, dtype)
    for n in "kv":
        assert_rel(tc[n].float(), jc[n], dtype)


def test_bias_adds_after_the_product_rounds(monkeypatch):
    """bf16: the bias is added to the product already rounded to bf16,
    as the reference does, not inside the product in f32."""
    _, tcfg = cfgs("glm4-9b", "bfloat16", num_layers=1)
    rng = np.random.default_rng(7)
    p = {k: to_torch(v[0], torch.bfloat16)
         for k, v in numpy_params(tcfg, 7)["layers"]["attn"].items()}
    x = to_torch(rng.standard_normal((1, 3, 128)), torch.bfloat16)
    rotated = []
    monkeypatch.setattr(TAtt, "apply_rope",
                        lambda t, *a, **k: rotated.append(t) or t)
    TAtt.gqa_forward(p, tcfg, x, positions=torch.arange(3))
    q = rotated[0].reshape(1, 3, -1)
    assert torch.equal(q, (x @ p["wq"]) + p["bq"])


# -- the model -----------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 2176])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", BIASED)
def test_prefill_logits_match_jax(monkeypatch, name, dtype, S):
    """S = 2,176 > 2,048 takes the flash op (its plain version on the
    CPU) in the port, the XLA chunked twin of the Pallas kernel in the
    JAX package."""
    jm, jp, tm, tp = both_models(name, dtype)
    flash_calls = []
    real = TAtt.flash_attention
    monkeypatch.setattr(TAtt, "flash_attention", lambda *a, **kw: (
        flash_calls.append(1), real(*a, **kw))[1])
    toks = tokens(S, tm.cfg.vocab)
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert len(flash_calls) == (tm.cfg.num_layers if S > 2048 else 0)
    assert_rel(got.float(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("name", BIASED)
def test_generate_greedy_tokens_equal_jax(name):
    jm, jp, tm, tp = both_models(name, "float32", seed=5)
    prompt = np.array([[5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=6)
    eng = ServeEngine(tm, batch_size=B, max_len=16)
    got, chosen_from = eng.generate(tp, torch.from_numpy(prompt), steps=6,
                                    return_logits=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prefill = eng.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)})
    torch.testing.assert_close(chosen_from[:, 0], prefill[:, -1],
                               atol=5e-3, rtol=0)
