"""Shared set-up of the port's LM parity tests: one set of numpy-drawn
weights handed to the JAX package and to the port.

The weights are drawn at each weight's own fan-in (the JAX package's
init reads its fan-in from the stacked layer axis, std 1/√L, which blows
the activations up), and the q/k/v biases are drawn nonzero, where both
packages' inits make them zero and would leave the bias path unchecked.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import Model as JModel
from repro_torch.configs import ARCHS
from repro_torch.interop import F32_LEAVES, lm_params_from_numpy
from repro_torch.models import Model

#: relative to the reference's largest |value|: f32 sums in another
#: order; bf16 keeps 8 significant bits and the packages round at other
#: points (tests/test_torch_models.py)
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
B = 2
BIAS_STD = 0.3
#: Mamba's dt init (arXiv:2312.00752): dt log-uniform in this range
DT_RANGE = (1e-3, 1e-1)


def numpy_params(cfg, seed=0) -> dict:
    """The JAX package's parameter pytree for ``cfg`` (layer leaves
    stacked on L), drawn with numpy: the embedding, the final norm, the
    layers, then an untied lm_head.  An MLA config's unrolled dense
    ``layer0`` comes after the stack, and the encoder-decoder's encoder
    stack, its decoder's cross-attention and every layer norm's and
    GELU MLP's bias (nonzero, where the init makes them zero) after
    that."""
    rng = np.random.default_rng(seed)
    D, F = cfg.d_model, cfg.d_ff

    def n(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def attn(L, kind="self"):
        st = () if L is None else (L,)
        if cfg.mla and kind == "self":
            m, H = cfg.mla, cfg.num_heads
            qk, lora = m.qk_nope_dim + m.qk_rope_dim, m.kv_lora_rank
            return {"wq": n((*st, D, H * qk), D ** -0.5),
                    "w_dkv": n((*st, D, lora + m.qk_rope_dim), D ** -0.5),
                    "kv_norm": n((*st, lora), 1.0),
                    "w_uk": n((*st, lora, H * m.qk_nope_dim), lora ** -0.5),
                    "w_uv": n((*st, lora, H * m.v_head_dim), lora ** -0.5),
                    "wo": n((*st, H * m.v_head_dim, D),
                            (H * m.v_head_dim) ** -0.5)}
        Hq = cfg.num_heads * cfg.hd
        Hk = Hq if kind == "cross" else cfg.num_kv_heads * cfg.hd
        a = {"wq": n((*st, D, Hq), D ** -0.5), "wk": n((*st, D, Hk), D ** -0.5),
             "wv": n((*st, D, Hk), D ** -0.5), "wo": n((*st, Hq, D), Hq ** -0.5)}
        if cfg.qkv_bias and kind == "self":
            a.update(bq=n((*st, Hq), BIAS_STD), bk=n((*st, Hk), BIAS_STD),
                     bv=n((*st, Hk), BIAS_STD))
        return a

    def swiglu_mlp(L, width):
        st = () if L is None else (L,)
        return {"w_gate": n((*st, D, width), D ** -0.5),
                "w_up": n((*st, D, width), D ** -0.5),
                "w_down": n((*st, width, D), width ** -0.5)}

    def gelu(L):
        return {"w_in": n((L, D, F), D ** -0.5), "b_in": n((L, F), BIAS_STD),
                "w_out": n((L, F, D), F ** -0.5), "b_out": n((L, D), BIAS_STD)}

    def norms(L, *names):
        out = {}
        for name in names:
            out[name] = n((L, D), 1.0)
            out[name + "b"] = n((L, D), BIAS_STD)
        return out

    first = cfg.moe.first_dense_layers if cfg.moe else 0
    L = cfg.num_layers - first
    tree = {"embed": n((cfg.vocab, D), 0.02), "final_norm": n((D,), 1.0)}
    layers = {} if cfg.encdec else {"ln1": n((L, D), 1.0),
                                     "ln2": n((L, D), 1.0)}
    if cfg.moe:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        a = attn(L)
        mlp = {"router": n((L, D, E), D ** -0.5),
               "w_gate": n((L, E, D, Fe), D ** -0.5),
               "w_up": n((L, E, D, Fe), D ** -0.5),
               "w_down": n((L, E, Fe, D), Fe ** -0.5)}
        if cfg.moe.num_shared:
            mlp["shared"] = swiglu_mlp(L, cfg.moe.num_shared * Fe)
    elif cfg.encdec:
        a, mlp = attn(L), gelu(L)
    else:
        a, mlp = attn(L), swiglu_mlp(L, F)
    tree["layers"] = {**layers, "attn": a, "mlp": mlp}
    if not cfg.tie_embeddings:
        tree["lm_head"] = n((D, cfg.vocab), D ** -0.5)
    if first:
        tree["layer0"] = {"ln1": n((D,), 1.0), "ln2": n((D,), 1.0),
                          "attn": attn(None), "mlp": swiglu_mlp(None, F)}
    if cfg.encdec:
        Le = cfg.encdec.num_encoder_layers
        tree["layers"].update(cross=attn(L, "cross"),
                              **norms(L, "ln1", "lnx", "ln2"))
        tree["encoder"] = {"attn": attn(Le), "mlp": gelu(Le),
                           **norms(Le, "ln1", "ln2")}
        tree["enc_final_norm_b"] = n((D,), BIAS_STD)
        tree["final_norm_b"] = n((D,), BIAS_STD)
    return tree


def mamba2_numpy_params(cfg, seed=0) -> dict:
    """The JAX package's parameter pytree (layer leaves stacked on L),
    drawn with numpy at each weight's own fan-in; the f32 constants as
    Mamba-2 initialises them."""
    rng = np.random.default_rng(seed)
    L, D, V = cfg.num_layers, cfg.d_model, cfg.vocab
    s = cfg.ssm
    di = s.expand * D
    H, N, K = di // s.head_dim, s.d_state, s.d_conv

    def n(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (L, H)))
    return {
        "embed": n((V, D), 0.02), "final_norm": n((D,), 1.0),
        "lm_head": n((D, V), D ** -0.5),
        "layers": {
            "ln1": n((L, D), 1.0),
            "mixer": {
                "w_z": n((L, D, di), D ** -0.5), "w_x": n((L, D, di), D ** -0.5),
                "w_B": n((L, D, N), D ** -0.5), "w_C": n((L, D, N), D ** -0.5),
                "w_dt": n((L, D, H), D ** -0.5),
                "conv_x_w": n((L, K, di), 0.3), "conv_x_b": n((L, di), 0.1),
                "conv_B_w": n((L, K, N), 0.3), "conv_B_b": n((L, N), 0.1),
                "conv_C_w": n((L, K, N), 0.3), "conv_C_b": n((L, N), 0.1),
                "A_log": np.log(np.broadcast_to(np.linspace(1.0, 16.0, H),
                                                (L, H))).astype(np.float32),
                "D": 1.0 + n((L, H), 0.1),
                "dt_bias": np.log(np.expm1(dt0)).astype(np.float32),
                "norm": n((L, di), 1.0), "out_proj": n((L, di, D), di ** -0.5)}},
    }


def mamba1_mixer(cfg, rng, lead=()) -> dict:
    """A Mamba-1 mixer's leaves as the JAX package names them, drawn with
    numpy at each weight's fan-in, each with the leading axes ``lead``.
    ``dt_bias`` is Mamba's init, softplus⁻¹ of a log-uniform draw in
    ``DT_RANGE`` (the reference's zeros put dt near 0.69, where the
    carried state vanishes within a few steps), ``D`` and the conv bias
    are drawn, and ``A_log`` is the reference's log(1..N)."""
    D, N, K = cfg.d_model, cfg.ssm.d_state, cfg.ssm.d_conv
    di, R = cfg.ssm.expand * D, -(-D // 16)

    def n(shape, std):
        return (rng.standard_normal((*lead, *shape)) * std).astype(np.float32)

    dt0 = np.exp(rng.uniform(*np.log(DT_RANGE), (*lead, di)))
    a_log = np.log(np.arange(1, N + 1, dtype=np.float32))
    return {
        "w_x": n((D, di), D ** -0.5), "w_z": n((D, di), D ** -0.5),
        "conv_w": n((K, di), 0.3), "conv_b": n((di,), 0.1),
        "x_proj": n((di, R + 2 * N), di ** -0.5),
        "dt_proj": n((R, di), R ** -0.5),
        "dt_bias": np.log(np.expm1(dt0)).astype(np.float32),
        "A_log": np.ascontiguousarray(
            np.broadcast_to(a_log, (*lead, di, N))),
        "D": 1.0 + n((di,), 0.1),
        "out_proj": n((di, D), di ** -0.5)}


def hybrid_numpy_params(cfg, seed=0) -> dict:
    """The JAX package's jamba tree for ``cfg``, drawn with numpy: every
    sublayer of every period its own weights (``periods`` leaves stacked
    on the P periods, the Mamba, dense-FFN and MoE leaves on a second
    axis of their sublayers), each at its fan-in."""
    rng = np.random.default_rng(seed)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    per = cfg.hybrid.period
    P, M, Nm = cfg.num_layers // per, per - 1, per // 2
    Nd = per - Nm
    E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
    Hq, Hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd

    def n(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return {
        "embed": n((V, D), 0.02), "final_norm": n((D,), 1.0),
        "lm_head": n((D, V), D ** -0.5),
        "periods": {
            "mamba": {"mixer": mamba1_mixer(cfg, rng, (P, M)),
                      "ln": n((P, M, D), 1.0)},
            "attn": {"attn": {"wq": n((P, D, Hq), D ** -0.5),
                              "wk": n((P, D, Hk), D ** -0.5),
                              "wv": n((P, D, Hk), D ** -0.5),
                              "wo": n((P, Hq, D), Hq ** -0.5)},
                     "ln": n((P, D), 1.0)},
            "dense_ffn": {"w_gate": n((P, Nd, D, F), D ** -0.5),
                          "w_up": n((P, Nd, D, F), D ** -0.5),
                          "w_down": n((P, Nd, F, D), F ** -0.5),
                          "ln": n((P, Nd, D), 1.0)},
            "moe_ffn": {"router": n((P, Nm, D, E), D ** -0.5),
                        "w_gate": n((P, Nm, E, D, Fe), D ** -0.5),
                        "w_up": n((P, Nm, E, D, Fe), D ** -0.5),
                        "w_down": n((P, Nm, E, Fe, D), Fe ** -0.5),
                        "ln": n((P, Nm, D), 1.0)}},
    }


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread inside the block, its thread count restored
    after.  The scan families' CPU paths are step loops of thousands of
    small ops; with the suite's workers sharing the cores, each op on a
    pool of threads waits for threads that other workers hold, and a
    test that takes seconds alone took minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def cfgs(name, dtype="float32", **kw):
    """(JAX config, port config): the reduced ``name`` in ``dtype``; a
    dict ``moe`` replaces those fields of each side's MoE config."""
    moe = kw.pop("moe") if isinstance(kw.get("moe"), dict) else None
    j = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype, **kw)
    t = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype, **kw)
    if moe:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe, **moe))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe, **moe))
    return j, t


def model_tree(cfg, seed=0) -> dict:
    """The numpy tree of ``cfg``'s family: Mamba-2's, the hybrid's or the
    attention families'."""
    if cfg.family == "ssm":
        return mamba2_numpy_params(cfg, seed)
    if cfg.family == "hybrid":
        return hybrid_numpy_params(cfg, seed)
    return numpy_params(cfg, seed)


def jax_tree(tree, cfg):
    """The numpy tree as the JAX package holds it: every leaf in the
    parameter type but the f32 constants of ``F32_LEAVES``."""
    def cast(path, a):
        f32 = path[-1].key in F32_LEAVES
        return jnp.asarray(a, jnp.float32 if f32 else cfg.param_dtype())
    return jax.tree_util.tree_map_with_path(cast, tree)


def both_models(name, dtype="float32", seed=0, **kw):
    """(JAX model, JAX params, port model, port params) on the same
    weights (rounded once to the working type, then carried across)."""
    jcfg, tcfg = cfgs(name, dtype, **kw)
    jparams = jax_tree(model_tree(tcfg, seed), jcfg)
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return JModel(jcfg), jparams, Model(tcfg, device="cpu"), tparams


def tokens(S, vocab, mult=7):
    return (np.arange(B * S).reshape(B, S) * mult % vocab).astype(np.int32)


def to_torch(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def mrope_positions(S, before, side, batch=B) -> np.ndarray:
    """(3, batch, S) M-RoPE positions as Qwen2-VL lays out one image
    between two runs of text: ``before`` text positions, equal in all
    three streams; a ``side`` x ``side`` block of merged patches at
    temporal index ``before``, with its own height and width indexes
    (``before`` + row, ``before`` + column); then text again from the
    block's largest index + 1."""
    n = side * side
    pos = np.empty((3, S), np.int64)
    pos[:, :before] = np.arange(before)
    row, col = np.divmod(np.arange(n), side)
    pos[0, before:before + n] = before
    pos[1, before:before + n] = before + row
    pos[2, before:before + n] = before + col
    pos[:, before + n:] = before + side + np.arange(S - before - n)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, S)))


def assert_rel(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * float(np.abs(want).max()), err
