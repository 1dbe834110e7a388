"""The port's Jamba hybrid (``models/lm.py`` ``_jamba_period``) and
jamba-1.5-large-398b on the CPU against the JAX package.

Reduced jamba (``ARCHS["jamba-1.5-large-398b"].reduced()``: one period
of 8 sublayers, Mamba-1 at 0-6 and GQA at 7, 4 query heads over 2 at hd
32, a SwiGLU of 256 after even sublayers and a MoE of 8 experts, top 2,
after odd ones; vocab 512), and the same with two periods, so that the
period index of every weight and cache slice shows.  Every sublayer of
every period has its own numpy-drawn weights (``_torch_lm``), Mamba's dt
init among them.  The JAX package traces its hybrid slowly, so its
outputs are computed once for the module (``jax_case``).

Tolerances relative to the reference's largest |logit|: f32 1e-5.  As for
the other MoE models, the whole model is held in f32 (in bf16 a near-tie
between experts goes either way on the last bit of the router's logits);
the Mamba-1 layer is held in bf16 too (``tests/test_torch_mamba1.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_lm import (  # noqa: E402
    B, assert_rel, cfgs, hybrid_numpy_params, tokens,
)
from repro import configs as J  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.interop import F32_LEAVES, lm_params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

NAME = "jamba-1.5-large-398b"
S, SMAX, WINDOW = 24, 32, 8
PROMPT = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)


def _jax_tree(tree, cfg):
    """The numpy tree as the JAX package holds it: every leaf in the
    parameter type but its f32 constants."""
    def cast(path, a):
        f32 = path[-1].key in F32_LEAVES
        return jnp.asarray(a, jnp.float32 if f32 else cfg.param_dtype())
    return jax.tree_util.tree_map_with_path(cast, tree)


def models(periods, seed=0, **kw):
    """(JAX model, JAX params, port model, port params) of a jamba with
    ``periods`` periods on the same weights."""
    jcfg, tcfg = cfgs(NAME, "float32", num_layers=8 * periods, **kw)
    jparams = _jax_tree(hybrid_numpy_params(tcfg, seed), jcfg)
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return JModel(jcfg), jparams, Model(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's outputs, computed once: prefill logits of S
    tokens for one and two periods; two periods' decode logits for the
    same tokens fed one at a time with the config's window (4,096, the
    engine's own jitted step) and with a window override of 8; and the
    engine's greedy generate."""
    toks = tokens(S, 512)
    out = {}
    for periods in (1, 2):
        jm, jp, _, _ = models(periods)
        out[f"prefill{periods}"] = np.asarray(
            jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}))
    eng = JServe(jm, batch_size=B, max_len=SMAX)
    steps = {"default": eng._decode,
             "window": jax.jit(functools.partial(jm.decode_step,
                                                 window=WINDOW))}
    for name, step in steps.items():
        cache, logits = jm.init_cache(B, SMAX), []
        for i in range(S):
            lg, cache = step(jp, cache, {"tokens": jnp.asarray(toks[:, i:i + 1])},
                             jnp.int32(i))
            logits.append(np.asarray(lg[:, 0]))
        out[name] = np.stack(logits, axis=1)
    out["generate"] = np.asarray(eng.generate(jp, jnp.asarray(PROMPT), steps=6))
    return out


# -- config, tree, cache ---------------------------------------------------


def test_config_fields_equal_the_jax_config():
    for j, t in ((J.ARCHS[NAME], T.ARCHS[NAME]),
                 (J.ARCHS[NAME].reduced(), T.ARCHS[NAME].reduced())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    full, red = T.ARCHS[NAME], T.ARCHS[NAME].reduced()
    assert (full.num_layers, full.d_model, full.sliding_window) == \
        (72, 8192, 4096)
    assert (full.hybrid.period, full.hybrid.attn_index) == (8, 7)
    assert red.num_layers == red.hybrid.period == 8         # one whole period


def _shapes(spec):
    if isinstance(spec, dict):
        return {k: _shapes(v) for k, v in spec.items()}
    return tuple(spec[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_and_cache_layout_are_the_jax_layout(dtype):
    """Two periods: each a dict of 7 Mamba sublayers, one attention
    sublayer, 4 SwiGLUs and 4 MoEs, as many parameters as the reference's
    stacked tree; the cache is the reference's stacked {"attn": {k, v},
    "mamba": {conv, state}}, the state f32."""
    jcfg, tcfg = cfgs(NAME, dtype, num_layers=16)
    params = Model(tcfg, device="cpu").init(0)
    assert len(params["periods"]) == 2
    per = params["periods"][1]
    assert [len(per[k]) for k in ("mamba", "dense_ffn", "moe_ffn")] == \
        [7, 4, 4]
    assert set(per["attn"]) == {"attn", "ln"}
    assert set(per["moe_ffn"][0]) == {"router", "w_gate", "w_up", "w_down",
                                      "ln"}
    want = jax.tree.map(lambda a: tuple(a.shape), jax.eval_shape(
        JModel(jcfg).init, jax.random.PRNGKey(0)))
    assert sum(np.prod(s) for s in jax.tree.leaves(
        want, is_leaf=lambda x: isinstance(x, tuple))) == sum(
            t.numel() for t in jax.tree.leaves(params))
    got = cache_specs(tcfg, 3, 20)
    jspec = JModel(jcfg).cache_specs(3, 20)
    assert _shapes(got) == _shapes(jspec)
    assert got["mamba"]["state"] == ((2, 7, 3, 256, 16), torch.float32)
    assert got["mamba"]["conv"][1] is tcfg.param_dtype()
    assert got["attn"]["k"][1] is tcfg.param_dtype()
    cache = Model(tcfg, device="cpu").init_cache(3, 20)
    assert not any(bool(t.any()) for t in jax.tree.leaves(cache))


def _stacked(params):
    """The port's hybrid tree stacked back into the reference's layout."""
    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([d[k] for d in items]) for k in items[0]}
        if isinstance(items[0], list):
            return stack([stack(x) for x in items])
        return np.stack([np.asarray(t) for t in items])

    out = {k: v.numpy() for k, v in params.items() if k != "periods"}
    out["periods"] = {k: stack([p[k] for p in params["periods"]])
                      for k in params["periods"][0]}
    return out


def test_interop_round_trips_the_hybrid_tree():
    """numpy -> port -> numpy gives every leaf back in its place, the
    f32 constants as f32 in a bf16 model."""
    _, tcfg = cfgs(NAME, "bfloat16", num_layers=16)
    tree = hybrid_numpy_params(tcfg, 3)
    params = lm_params_from_numpy(tcfg, tree, device="cpu")
    mixer = params["periods"][1]["mamba"][4]["mixer"]
    assert {k for k, v in mixer.items() if v.dtype is torch.float32} == \
        set(F32_LEAVES)
    assert params["periods"][0]["moe_ffn"][2]["w_up"].dtype is torch.bfloat16
    back = _stacked(jax.tree.map(lambda t: t.float(), params))
    want = jax.tree.map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy(), tree)
    for k in F32_LEAVES:
        want["periods"]["mamba"]["mixer"][k] = tree["periods"]["mamba"][
            "mixer"][k]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)


@pytest.mark.parametrize("bad", [
    dict(ssm=dataclasses.replace(T.ARCHS[NAME].ssm, variant="ssd")),
    dict(moe=dataclasses.replace(T.ARCHS[NAME].moe, every_k_layers=1)),
    dict(moe=None),
    dict(num_layers=12),
    dict(hybrid=dataclasses.replace(T.ARCHS[NAME].hybrid, attn_index=8)),
    dict(hybrid=None),
], ids=["mamba2", "moe_every_layer", "no_moe", "partial_period",
        "attn_outside_period", "no_hybrid_config"])
def test_hybrids_the_reference_does_not_compute_are_refused(bad):
    """The reference's period hard-codes Mamba-1, a MoE after every odd
    sublayer whatever ``every_k_layers`` says, and floors the period
    count; the port refuses, naming the field, what it would not compute
    as the config says."""
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(T.ARCHS[NAME].reduced(), **bad),
              device="cpu")


# -- the model -------------------------------------------------------------


@pytest.mark.parametrize("periods", [1, 2])
def test_prefill_logits_match_jax(jax_case, monkeypatch, periods):
    _, _, tm, tp = models(periods)
    scans = []
    real = TSsm.selective_scan
    monkeypatch.setattr(TSsm, "selective_scan",
                        lambda *a: scans.append(1) or real(*a))
    toks = torch.from_numpy(tokens(S, 512))
    got = tm.prefill(tp, {"tokens": toks})
    assert got.shape == (B, S, 512)
    assert len(scans) == 7 * periods
    assert_rel(got, jax_case[f"prefill{periods}"], "float32")
    last = tm.prefill(tp, {"tokens": toks}, last_only=True)
    assert_rel(last, got[:, -1:], "float32")


@pytest.mark.parametrize("part,i,j", [("moe_ffn", 0, 1), ("mamba", 2, 5),
                                      ("dense_ffn", 1, 3)])
def test_swapping_two_sublayers_changes_the_logits(part, i, j):
    """Each sublayer reads its own weights: two of a period's MoEs (or
    Mamba sublayers, or SwiGLUs) swapped give other logits, and two
    periods swapped too."""
    _, _, tm, tp = models(2)
    toks = {"tokens": torch.from_numpy(tokens(S, 512))}
    want = tm.prefill(tp, toks)
    per = tp["periods"][1]
    per[part][i], per[part][j] = per[part][j], per[part][i]
    assert float((tm.prefill(tp, toks) - want).abs().max()) > 1e-3
    per[part][i], per[part][j] = per[part][j], per[part][i]
    assert torch.equal(tm.prefill(tp, toks), want)
    tp["periods"].reverse()
    assert float((tm.prefill(tp, toks) - want).abs().max()) > 1e-3


@pytest.mark.parametrize("window", ["default", "window"])
def test_decode_matches_jax(jax_case, window):
    """Two periods fed S tokens one at a time through the caches: every
    step's logits equal the JAX package's, with the config's sliding
    window (the default) and with an override of 8, which masks keys
    past it from step 8 on."""
    _, _, tm, tp = models(2)
    toks = torch.from_numpy(tokens(S, 512))
    cache = tm.init_cache(B, SMAX)
    kw = {} if window == "default" else {"window": WINDOW}
    got = []
    for i in range(S):
        logits, cache = tm.decode_step(tp, cache, {"tokens": toks[:, i:i + 1]},
                                       i, **kw)
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)
    assert_rel(got, jax_case[window], "float32")
    other = jax_case["window" if window == "default" else "default"]
    assert np.abs(jax_case[window][:, WINDOW + 1:] - other[:, WINDOW + 1:]
                  ).max() > 1e-3               # the window shows
    assert np.abs(jax_case[window][:, :WINDOW] - other[:, :WINDOW]
                  ).max() < 1e-5 * np.abs(other).max()


def test_default_decode_window_is_the_configs_sliding_window():
    _, _, tm, tp = models(1)
    toks = torch.from_numpy(tokens(6, 512))
    outs = []
    for kw in ({}, {"window": tm.cfg.sliding_window}):
        cache = tm.init_cache(B, 8)
        outs.append([tm.decode_step(tp, cache, {"tokens": toks[:, i:i + 1]},
                                    i, **kw)[0] for i in range(6)])
    assert tm.cfg.sliding_window == 4096
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_generate_greedy_tokens_equal_jax(jax_case):
    _, _, tm, tp = models(2)
    got = ServeEngine(tm, batch_size=B, max_len=SMAX).generate(
        tp, torch.from_numpy(PROMPT), steps=6)
    np.testing.assert_array_equal(got.numpy(), jax_case["generate"])


def test_decode_matches_prefill_drop_free():
    """Token-by-token decode through the attention, conv and state caches
    == the full forward once nothing drops (capacity factor E), f32, the
    JAX package's 5e-3 (``tests/test_models.py``)."""
    moe = T.ARCHS[NAME].reduced().moe
    _, _, tm, tp = models(2, seed=4, moe=dataclasses.replace(
        moe, capacity_factor=float(moe.num_experts)))
    toks = torch.from_numpy(tokens(S, 512, mult=11))
    full = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(B, S)
    dec = torch.stack([tm.decode_step(tp, cache, {"tokens": toks[:, i:i + 1]},
                                      i)[0][:, 0] for i in range(S)], dim=1)
    assert float((dec - full).abs().max()) < 5e-3
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_bf16_decode_parts_from_prefill_by_the_conv_rounding(monkeypatch):
    """In bf16 decode's last logits differ from the prefill's, and equal
    them bit for bit once decode's conv rounds as the prefill's does:
    each tap's product and partial sum in the working type, as the
    reference's ``_causal_conv`` (its ``_conv_step`` takes one einsum).
    On the CPU nothing else in the period parts the two."""
    moe = T.ARCHS[NAME].reduced().moe
    tcfg = dataclasses.replace(
        T.ARCHS[NAME].reduced(), dtype="bfloat16",
        moe=dataclasses.replace(moe, capacity_factor=float(moe.num_experts)))
    tm = Model(tcfg, device="cpu")
    tp = lm_params_from_numpy(tcfg, hybrid_numpy_params(tcfg, 1), device="cpu")
    toks = torch.from_numpy(tokens(S, 512, mult=11))
    want = tm.prefill(tp, {"tokens": toks})[:, -1]

    def decoded():
        cache = tm.init_cache(B, S)
        for i in range(S):
            logits, cache = tm.decode_step(
                tp, cache, {"tokens": toks[:, i:i + 1]}, i)
        return logits[:, -1]

    def conv_step(state, x_t, w, b):
        window = torch.cat([state, x_t], dim=1)                 # (B, K, C)
        y = sum(window[:, k:k + 1] * w[k] for k in range(w.shape[0]))
        return window[:, 1:], y + b

    assert not torch.equal(decoded(), want)
    monkeypatch.setattr(TSsm, "_conv_step", conv_step)
    assert torch.equal(decoded(), want)
