"""The port's mamba2-1.3b stack on the CPU against the JAX package.

Reduced mamba2 (``ARCHS["mamba2-1.3b"].reduced()``: 4 layers, d_model
128, d_inner 256, 16 SSD heads of hd 16, d_state 16, chunk 32, vocab
512).  Weights are drawn with numpy at fan-in scales and carried to both
packages; ``dt_bias`` is Mamba-2's own init, softplus⁻¹ of a log-uniform
draw in [1e-3, 1e-1] (arXiv:2405.21060), so the chunk decays carry state
across chunks (the reference's zero ``dt_bias`` makes them vanish), and
the conv biases and ``D`` are drawn too, so every parameter shows.

Tolerances, relative to the largest |logit| (or |value|) of the
reference: f32 1e-5 (measured about 1.3e-6: sums in another order);
bf16 5e-2 (measured 2.7e-2: 8 significant bits, and XLA may keep excess
precision between bf16 ops where torch rounds each).  Decode against
prefill in f32: the JAX package's own 5e-3 (``tests/test_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ssm as JSsm  # noqa: E402
from _torch_lm import mamba2_numpy_params as numpy_params  # noqa: E402

from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.interop import F32_LEAVES, lm_params_from_numpy  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
B = 2
ARCH = "mamba2-1.3b"


def _cfgs(dtype="float32", **kw):
    j = dataclasses.replace(J_ARCHS[ARCH].reduced(), dtype=dtype, **kw)
    t = dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype, **kw)
    return j, t


def _jax_tree(tree, cfg):
    """The numpy tree as the JAX package holds it: every leaf in the
    parameter type but its f32 constants."""
    def cast(path, a):
        f32 = path[-1].key in F32_LEAVES
        return jnp.asarray(a, jnp.float32 if f32 else cfg.param_dtype())
    return jax.tree_util.tree_map_with_path(cast, tree)


def both_models(dtype="float32", seed=0, **kw):
    """(JAX model, JAX params, port model, port params) on the same
    weights (rounded once to the working type, then carried across)."""
    jcfg, tcfg = _cfgs(dtype, **kw)
    jparams = _jax_tree(numpy_params(tcfg, seed), jcfg)
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return JModel(jcfg), jparams, Model(tcfg, device="cpu"), tparams


def tokens(S, vocab, mult=7):
    return (np.arange(B * S).reshape(B, S) * mult % vocab).astype(np.int32)


def assert_rel(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * float(np.abs(want).max()), err


# -- config, cache, weights ----------------------------------------------------


def test_config_fields_equal_the_jax_config():
    for full in (False, True):
        j, t = J_ARCHS[ARCH], ARCHS[ARCH]
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert not ARCHS[ARCH].tie_embeddings


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_layout_is_the_jax_layout(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jspec = JModel(jcfg).cache_specs(3, 10)
    tspec = cache_specs(tcfg, 3, 10)
    assert {k: s for k, (s, _) in tspec.items()} == \
        {k: s for k, (s, _) in jspec.items()}
    assert {k: str(d).split(".")[-1] for k, (_, d) in tspec.items()} == \
        {k: jnp.dtype(d).name for k, (_, d) in jspec.items()}
    cache = Model(tcfg, device="cpu").init_cache(3, 10)
    assert cache["state"].dtype is torch.float32
    assert cache["conv_x"].dtype is tcfg.param_dtype()
    assert all(tuple(cache[k].shape) == jspec[k][0] for k in jspec)


def test_f32_leaves_stay_f32_through_interop():
    """A_log, D and dt_bias are f32 constants in the reference; carried
    into a bf16 model they stay f32 (bf16 would move A = -exp(A_log) by up
    to 0.4 %), and every other leaf takes the parameter type."""
    _, tcfg = _cfgs("bfloat16")
    tree = numpy_params(tcfg)
    params = lm_params_from_numpy(tcfg, tree, device="cpu")
    mixer = params["layers"][1]["mixer"]
    for k in F32_LEAVES:
        assert mixer[k].dtype is torch.float32, k
        np.testing.assert_array_equal(mixer[k].numpy(),
                                      tree["layers"]["mixer"][k][1])
    assert {k for k, v in mixer.items() if v.dtype is torch.float32} == \
        set(F32_LEAVES)
    assert params["lm_head"].dtype is torch.bfloat16
    assert tuple(params["lm_head"].shape) == (tcfg.d_model, tcfg.vocab)
    own = Model(tcfg, device="cpu").init(0)["layers"][0]["mixer"]
    assert {k for k, v in own.items() if v.dtype is torch.float32} == \
        set(F32_LEAVES)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == \
        jax.tree.map(lambda t: tuple(t.shape), mixer)


def test_init_is_seeded_and_at_the_reference_scales():
    _, tcfg = _cfgs()
    model = Model(tcfg, device="cpu")
    p0, p1 = model.init(0), model.init(0)
    assert torch.equal(p0["layers"][3]["mixer"]["w_x"],
                       p1["layers"][3]["mixer"]["w_x"])
    ref = jax.tree.map(np.asarray, JModel(_cfgs()[0]).init(jax.random.PRNGKey(0)))
    carried = lm_params_from_numpy(tcfg, ref, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p0) == \
        jax.tree.map(lambda t: tuple(t.shape), carried)
    mixer = p0["layers"][0]["mixer"]
    for k in ("A_log", "D", "dt_bias", "conv_x_b"):
        np.testing.assert_allclose(mixer[k].numpy(),
                                   np.asarray(ref["layers"]["mixer"][k][0]))
    w_x = mixer["w_x"]                                  # (d_model, d_inner)
    assert abs(float(w_x.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05


# -- the layer ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_prefill_and_decode_match_jax(dtype):
    """One layer's mixer: a prefill of S 40 (a ragged second chunk), then
    a single-token decode step from a cache the two packages share."""
    jcfg, tcfg = _cfgs(dtype)
    jtree = _jax_tree(numpy_params(tcfg, 2), jcfg)
    jp = jax.tree.map(lambda a: a[0], jtree["layers"]["mixer"])
    tp = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jtree),
                              device="cpu")["layers"][0]["mixer"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 40, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jcfg.param_dtype())
    tx = torch.from_numpy(x).to(tcfg.param_dtype())

    jy, _ = JSsm.mamba2_forward(jp, jcfg, jx)
    ty, none = TSsm.mamba2_forward(tp, tcfg, tx)
    assert none is None and ty.dtype == tcfg.param_dtype()
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)

    spec = JSsm.mamba2_cache_spec(jcfg, B)
    cache_np = {k: rng.standard_normal(s).astype(np.float32) * 0.5
                for k, (s, _) in spec.items()}
    jc = {k: jnp.asarray(v, spec[k][1]) for k, v in cache_np.items()}
    tc = {k: torch.from_numpy(np.array(jc[k].astype(jnp.float32)))
          .to(d) for k, (_, d) in TSsm.mamba2_cache_spec(tcfg, B).items()}
    jy, jc = JSsm.mamba2_forward(jp, jcfg, jx[:, :1], cache=jc)
    ty, tc2 = TSsm.mamba2_forward(tp, tcfg, tx[:, :1], cache=tc)
    assert tc2 is tc                                         # written in place
    assert_rel(ty.float(), jy.astype(jnp.float32), dtype)
    for k in jc:
        assert_rel(tc[k].float(), jc[k].astype(jnp.float32), dtype)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("S", [64, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_jax(dtype, S):
    """S 64 is two whole chunks; S 77 ends in a ragged third."""
    jm, jp, tm, tp = both_models(dtype)
    toks = tokens(S, tm.cfg.vocab)
    want = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    got = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, S, tm.cfg.vocab)
    assert got.dtype == tm.cfg.param_dtype()
    assert_rel(got.float(), want.astype(jnp.float32), dtype)
    last = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, last_only=True)
    assert_rel(last.float(), got[:, -1:].float(), dtype)


def test_decode_matches_prefill():
    """Token-by-token decode through the conv and state caches == the
    full chunked forward (the reference's cache-correctness property, f32,
    its 5e-3), over 70 tokens: two chunk boundaries and a ragged end."""
    _, _, tm, tp = both_models("float32", seed=4)
    T = 70
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


def test_generate_greedy_tokens_equal_jax_and_prefill_argmax():
    jm, jp, tm, tp = both_models("float32", seed=5)
    prompt = np.array([[5, 6, 7, 8, 9], [9, 10, 11, 12, 13]], np.int32)
    want = JServe(jm, batch_size=B, max_len=16).generate(
        jp, jnp.asarray(prompt), steps=8)
    eng = ServeEngine(tm, batch_size=B, max_len=16)
    got, chosen_from = eng.generate(tp, torch.from_numpy(prompt), steps=8,
                                    return_logits=True)
    assert got.shape == (B, 13) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    prefill = eng.prefill_logits(tp, {"tokens": torch.from_numpy(prompt)})
    assert torch.equal(got[:, 5], prefill[:, -1].argmax(-1))
    torch.testing.assert_close(chosen_from[:, 0], prefill[:, -1],
                               atol=5e-3, rtol=0)


def test_ssm_configs_the_port_does_not_run_raise():
    _, tcfg = _cfgs()
    for bad in (dataclasses.replace(tcfg, tie_embeddings=True),
                dataclasses.replace(tcfg, ssm=dataclasses.replace(
                    tcfg.ssm, variant="mamba1"))):
        with pytest.raises(NotImplementedError):
            Model(bad, device="cpu")
