"""The port's MoE (``models/moe.py``) and qwen2-moe-a2.7b on the CPU
against the JAX package.

``moe_forward`` is held layer by layer in f32 and bf16 on the same
inputs, on three cases: router logits with exact ties across the top-k
boundary, a capacity that drops tokens, and a drop-free capacity.  The
reduced model (4 layers, 8 experts, top 2, one shared expert, q/k/v
biases) is held in f32: its prefill logits at S 64 and 2,176 and its
greedy tokens.

The whole model is not held in bf16.  There a routing decision turns on
the last bit of the router's logits: on the same bf16 weights the two
packages' SwiGLU and attention outputs differ by an ulp here and there
(each rounds at its own points), a near-tie between experts then goes
the other way, and that token takes another expert's output (measured
at S 64 and 2,176: 0.18 and 0.35 of the largest logit).  On the same
inputs the bf16 layer agrees within the bf16 tolerance, which the tests
below hold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    B, RTOL, assert_rel, both_models, cfgs, numpy_params, to_torch, tokens,
)
from repro.models import moe as JMoE  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.models import attention as TAtt  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "qwen2-moe-a2.7b"
S_LAYER = 64


def _layer_case(dtype, case, seed=0):
    """(JAX cfg, port cfg, JAX params, port params, JAX x, port x) for
    one MoE layer.  ``tied``: experts 0-2 and 3-5 share router columns,
    so a token's top 2 is cut from a three-way tie; ``drop``: the
    config's capacity factor, which drops tokens at S 64; ``dropfree``:
    capacity factor E."""
    kw = {}
    if case == "dropfree":
        moe = cfgs(NAME)[1].moe
        kw["moe"] = dataclasses.replace(moe,
                                        capacity_factor=float(moe.num_experts))
    jcfg, tcfg = cfgs(NAME, dtype, num_layers=1, **kw)
    mlp = numpy_params(tcfg, seed)["layers"]["mlp"]
    p = jax.tree.map(lambda a: a[0], mlp)
    if case == "tied":
        r = p["router"]
        r[:, 1] = r[:, 2] = r[:, 0]
        r[:, 4] = r[:, 5] = r[:, 3]
    jp = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype()), p)
    tp = jax.tree.map(lambda a: to_torch(a, tcfg.param_dtype()), jp)
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S_LAYER, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    return jcfg, tcfg, jp, tp, jx, to_torch(jx, tcfg.param_dtype())


def _routing(tcfg, tp, tx):
    """(top-k expert ids, rank of each slot within its expert,
    capacity) as the port routes ``tx``."""
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1)
    _, idx = TMoE._route(probs, tcfg.moe.top_k)
    C = TMoE.capacity(tcfg, tx.shape[1])
    _, rank = TMoE._dispatch(tx, idx, C, tcfg.moe.num_experts)
    return idx, rank, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["tied", "drop", "dropfree"])
def test_moe_forward_matches_jax(dtype, case):
    jcfg, tcfg, jp, tp, jx, tx = _layer_case(dtype, case)
    jy, jaux = JMoE.moe_forward(jp, jcfg, jx)
    ty, taux = TMoE.moe_forward(tp, tcfg, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)
    assert abs(float(taux) - float(jaux)) <= RTOL["float32"] * float(jaux)

    idx, rank, C = _routing(tcfg, tp, tx)
    dropped = int((rank >= C).sum())
    if case == "drop":
        assert dropped > 0
    if case == "dropfree":
        assert dropped == 0
    if case == "tied":
        logits = tx @ tp["router"]
        assert torch.equal(logits[..., 0], logits[..., 2])
        top = logits.float().argmax(-1)
        in_tie = (top == 0) | (top == 3)
        assert int(in_tie.sum()) > 0
        # a three-way tie cut at k = 2 keeps the two lower ids
        assert torch.equal(idx[in_tie].sort(-1).values,
                           torch.stack([top[in_tie], top[in_tie] + 1], -1))


def test_tie_order_decides_the_output():
    """The tied case would fail had the higher ids won the tie: the
    three tied experts hold different weights."""
    jcfg, tcfg, jp, tp, jx, tx = _layer_case("float32", "tied")
    jy, _ = JMoE.moe_forward(jp, jcfg, jx)
    swapped = dict(tp)
    for k in ("w_gate", "w_up", "w_down"):
        w = tp[k].clone()
        w[[0, 2, 3, 5]] = w[[2, 0, 5, 3]]
        swapped[k] = w
    ty, _ = TMoE.moe_forward(swapped, tcfg, tx)
    with pytest.raises(AssertionError):
        assert_rel(ty, jy, "float32")


def test_combine_folds_in_ascending_expert_id():
    """bf16: each token's k contributions are added in ascending expert
    id, one bf16 rounding a step, whatever order top-k gave them."""
    _, tcfg, _, tp, _, tx = _layer_case("bfloat16", "dropfree")
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1)
    w, idx = TMoE._route(probs, tcfg.moe.top_k)
    E = tcfg.moe.num_experts
    C = TMoE.capacity(tcfg, tx.shape[1])
    buf, rank = TMoE._dispatch(tx, idx, C, E)
    out = torch.randn(buf.shape, generator=torch.Generator().manual_seed(0)
                      ).to(torch.bfloat16)
    y = TMoE._combine(out, w, idx, rank, C)
    want = torch.zeros_like(y)
    for b in range(B):
        for t in range(tx.shape[1]):
            for j in sorted(range(idx.shape[-1]), key=lambda j: idx[b, t, j]):
                e = int(idx[b, t, j])
                row = out[e, b * C + int(rank[b, t, j])]
                want[b, t] = want[b, t] + row * w[b, t, j].to(torch.bfloat16)
    assert torch.equal(y, want)


@pytest.mark.parametrize("E,m", [(60, 16), (8, 2), (8, 16), (60, 1)])
def test_expert_split_is_dtensors_shard_split(E, m):
    """A rank's experts under the sharded MoE are DTensor's ``Shard``
    pieces of the expert axis: 60 over 16 is fifteen 4s and a 0."""
    from torch.distributed.tensor import Shard

    pieces, _ = Shard(0)._split_tensor(torch.arange(E), m, with_padding=False)
    assert TMoE.expert_split(E, m) == [len(p) for p in pieces]
    assert sum(TMoE.expert_split(E, m)) == E


def test_partial_combines_add_to_the_whole():
    """f32: the sharded MoE's combines, one over each rank's experts
    (``first`` on), add to the unsharded combine within a rounding."""
    _, tcfg, _, tp, _, tx = _layer_case("float32", "dropfree")
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1)
    w, idx = TMoE._route(probs, tcfg.moe.top_k)
    E = tcfg.moe.num_experts
    C = TMoE.capacity(tcfg, tx.shape[1])
    buf, rank = TMoE._dispatch(tx, idx, C, E)
    out = torch.randn(buf.shape, generator=torch.Generator().manual_seed(1))
    whole = TMoE._combine(out, w, idx, rank, C)
    counts = TMoE.expert_split(E, 3)
    starts = np.cumsum([0] + counts[:-1])
    parts = [TMoE._combine(out[f:f + n], w, idx, rank, C, int(f))
             for f, n in zip(starts, counts)]
    assert torch.equal(TMoE._combine(out, w, idx, rank, C, 0), whole)
    torch.testing.assert_close(sum(parts), whole, rtol=1e-6, atol=1e-6)


def test_a_rank_of_no_experts_adds_zeros():
    """8 experts over 16 ranks leave half the ranks none: their combines
    are zeros, still taken from their empty expert outputs (whose
    gradient, empty, flows back), and every rank's combine adds to the
    whole."""
    _, tcfg, _, tp, _, tx = _layer_case("float32", "dropfree")
    probs = torch.softmax((tx @ tp["router"]).float(), dim=-1)
    w, idx = TMoE._route(probs, tcfg.moe.top_k)
    E = tcfg.moe.num_experts
    C = TMoE.capacity(tcfg, tx.shape[1])
    buf, rank = TMoE._dispatch(tx, idx, C, E)
    out = torch.randn(buf.shape, generator=torch.Generator().manual_seed(2),
                      requires_grad=True)
    counts = TMoE.expert_split(E, 16)
    assert counts == [1] * 8 + [0] * 8
    starts = np.cumsum([0] + counts[:-1])
    parts = [TMoE._combine(out[f:f + n], w, idx, rank, C, int(f))
             for f, n in zip(starts, counts)]
    for y in parts[8:]:
        assert y.shape == tx.shape and not y.any()
    total = sum(parts)
    torch.testing.assert_close(total, TMoE._combine(out, w, idx, rank, C),
                               rtol=1e-6, atol=1e-6)
    empty = out[E:E]
    y = TMoE._combine(empty, w, idx, rank, C, E)
    (grad,) = torch.autograd.grad(y.sum(), empty)
    assert grad.shape == (0, *out.shape[1:])


def test_capacity_is_the_reference_rule():
    _, tcfg = cfgs(NAME)
    for S in (1, 7, 64, 2176, 32768):
        e = tcfg.moe
        want = max(1, int(np.ceil(S * e.top_k / e.num_experts
                                  * e.capacity_factor)))
        assert TMoE.capacity(tcfg, S) == want


@pytest.mark.parametrize("S", [64, 2176])
def test_prefill_logits_match_jax(monkeypatch, S):
    jm, jp, tm, tp = both_models(NAME, "float32")
    flash_calls = []
    real = TAtt.flash_attention
    monkeypatch.setattr(TAtt, "flash_attention", lambda *a, **kw: (
        flash_calls.append(1), real(*a, **kw))[1])
    toks = tokens(S, tm.cfg.vocab)
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert len(flash_calls) == (tm.cfg.num_layers if S > 2048 else 0)
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
    """Token-by-token decode == the full forward once nothing drops
    (capacity factor E), as the reference's own test runs it."""
    moe = cfgs(NAME)[1].moe
    _, _, tm, tp = both_models(NAME, "float32", seed=4, moe=dataclasses.replace(
        moe, capacity_factor=float(moe.num_experts)))
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


def test_routing_repeats_bit_for_bit():
    _, tcfg, _, tp, _, tx = _layer_case("bfloat16", "drop")
    a, aux_a = TMoE.moe_forward(tp, tcfg, tx)
    b, aux_b = TMoE.moe_forward(tp, tcfg, tx)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
