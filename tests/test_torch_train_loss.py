"""Training's pieces below the step, held against the JAX package on the
CPU: the cross-entropy's value and gradient, the flash op's gradient
past ``LONG_SEQ``, the refusal of the scan families, and the weight
carriers both ways."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import cfgs, hybrid_numpy_params, numpy_params  # noqa: E402

from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro.models.model import cross_entropy as j_cross_entropy  # noqa: E402
from repro.train import AdamWConfig as JAdamW  # noqa: E402
from repro.train import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    adamw_state_from_numpy, lm_params_from_numpy, lm_params_to_numpy,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    LONG_SEQ, FlashAttention, attention_any, chunked_attention,
)
from repro_torch.models.lm import RematPolicy  # noqa: E402
from repro_torch.models.model import cross_entropy  # noqa: E402

#: loss relative, gradient leaf relative to its largest |value|
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_value_and_dlogits_match_reference(dtype):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 301)) * 4).astype(np.float32)
    labels = rng.integers(0, 301, (2, 9)).astype(np.int32)
    g = 1.75
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    want, vjp = jax.vjp(lambda x: j_cross_entropy(x, jnp.asarray(labels)), jl)
    (want_d,) = vjp(jnp.float32(g))

    tl = torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_(True)
    got = cross_entropy(tl, torch.from_numpy(labels))
    (got_d,) = torch.autograd.grad(got, tl, torch.tensor(g))
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert got_d.dtype == getattr(torch, dtype)
    want_d = torch.from_numpy(np.array(want_d.astype(jnp.float32)))
    err = (got_d.float() - want_d).abs()
    if dtype == "float32":
        assert float(err.max()) <= GRAD_RTOL * float(want_d.abs().max())
    else:
        assert bool((err <= _bf16_ulp(want_d)).all()), float(err.max())


def test_cross_entropy_saves_no_f32_copy_of_the_logits():
    """The saved tensors are the logits in their own type, the labels and
    two (B, S) statistics: nothing of (tokens x vocab) in f32."""
    logits = torch.randn(2, 5, 64, dtype=torch.bfloat16, requires_grad=True)
    loss = cross_entropy(logits, torch.randint(0, 64, (2, 5)))
    saved = loss.grad_fn.saved_tensors
    big = [t for t in saved if t.numel() == logits.numel()]
    assert [t.dtype for t in big] == [torch.bfloat16]
    assert sorted(t.numel() for t in saved if t is not big[0]) == [10, 10, 10]


def _qkv(seed, S=LONG_SEQ + 64, H=4, Hkv=2, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, h, hd)).astype(np.float32)
            for h in (H, Hkv, Hkv)]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_function_gradient_is_chunked_attentions(causal):
    """Past ``LONG_SEQ`` ``attention_any`` takes the Function, whose
    gradients equal autograd through ``chunked_attention`` bit for bit and
    the reference's ``jax.grad`` of its ``chunked_attention`` within the
    gradient limit."""
    q, k, v = _qkv(5)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                        leaves)

    out, got = grads(lambda q, k, v: attention_any(q, k, v, causal=causal))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    _, plain = grads(lambda q, k, v: chunked_attention(q, k, v,
                                                       causal=causal))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    want = jax.grad(lambda *t: jnp.sum(j_chunked(*t, causal=causal) * w),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert float(np.abs(a.numpy() - b).max()) <= \
            GRAD_RTOL * float(np.abs(b).max())


def test_flash_function_takes_strided_views():
    """q, k, v as ``gqa_forward`` hands them over (reshaped projections)
    and their gradients in the same (B, S, H, hd) shapes."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7))
    xq = q.reshape(1, q.shape[1], -1).requires_grad_(True)
    qv = xq.view(q.shape)
    out = FlashAttention.apply(qv, k, v, True)
    (dx,) = torch.autograd.grad(out.square().sum(), xq)
    assert out.shape == q.shape and dx.shape == xq.shape


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_loss_refuses_the_scan_families(name):
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32")
    model = Model(cfg, device="cpu")
    toks = torch.zeros((1, 9), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="backward"):
        model.loss(model.init(0), {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]})


def test_remat_policy_names_what_it_takes():
    with pytest.raises(ValueError, match="nothing_saveable"):
        RematPolicy(policy="everything_saveable")
    assert RematPolicy().group_for(40) == 5
    assert RematPolicy(scan_group=3).group_for(40) == 1
    assert RematPolicy(enabled=False).group_for(40) == 1
    assert RematPolicy().group_for(36) == math.isqrt(36)


ROUND_TRIP = ["granite-3-2b", "glm4-9b", "codeqwen1.5-7b", "qwen2-72b",
              "qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "qwen2-vl-72b",
              "whisper-large-v3", "jamba-1.5-large-398b"]


def _equal_trees(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", ROUND_TRIP)
def test_params_round_trip_through_the_port(name):
    _, cfg = cfgs(name)
    tree = (hybrid_numpy_params(cfg) if cfg.hybrid else numpy_params(cfg))
    back = lm_params_to_numpy(cfg, lm_params_from_numpy(cfg, tree,
                                                        device="cpu"))
    _equal_trees(back, tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_state_crosses_in_its_own_dtype(state_dtype):
    """The reference's moments keep their dtype (bfloat16 bit for bit)
    and their step."""
    jcfg, cfg = cfgs("qwen2-moe-a2.7b")
    params = jax.tree.map(jnp.asarray, numpy_params(cfg))
    state = j_adamw_init(params, JAdamW(state_dtype=state_dtype))
    rng = np.random.default_rng(1)
    state["m"] = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
        state["m"])
    state["step"] = jnp.int32(17)
    got = adamw_state_from_numpy(cfg, jax.tree.map(np.asarray, state),
                                 device="cpu")
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 17
    want_dt = getattr(torch, state_dtype)
    leaf = got["m"]["layers"][0]["mlp"]["w_up"]
    assert leaf.dtype == want_dt
    back = lm_params_to_numpy(cfg, got["m"])
    _equal_trees(back, jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)) if
        a.dtype == jnp.bfloat16 else np.asarray(a), state["m"]))
