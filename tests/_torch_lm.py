"""Shared set-up of the port's LM parity tests: one set of numpy-drawn
weights handed to the JAX package and to the port.

The weights are drawn at each weight's own fan-in (the JAX package's
init reads its fan-in from the stacked layer axis, std 1/√L, which blows
the activations up), and the q/k/v biases are drawn nonzero, where both
packages' inits make them zero and would leave the bias path unchecked.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import Model as JModel
from repro_torch.configs import ARCHS
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import Model

#: relative to the reference's largest |value|: f32 sums in another
#: order; bf16 keeps 8 significant bits and the packages round at other
#: points (tests/test_torch_models.py)
RTOL = {"float32": 1e-5, "bfloat16": 5e-2}
B = 2
BIAS_STD = 0.3


def numpy_params(cfg, seed=0) -> dict:
    """The JAX package's parameter pytree for a dense or uniform-MoE
    config (layer leaves stacked on L), drawn with numpy: the embedding,
    the final norm, the layers, then an untied lm_head."""
    rng = np.random.default_rng(seed)
    L, D, F = cfg.num_layers, cfg.d_model, cfg.d_ff
    Hq, Hk = cfg.num_heads * cfg.hd, cfg.num_kv_heads * cfg.hd

    def n(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    tree = {"embed": n((cfg.vocab, D), 0.02), "final_norm": n((D,), 1.0)}
    layers = {"ln1": n((L, D), 1.0), "ln2": n((L, D), 1.0)}
    attn = {"wq": n((L, D, Hq), D ** -0.5), "wk": n((L, D, Hk), D ** -0.5),
            "wv": n((L, D, Hk), D ** -0.5), "wo": n((L, Hq, D), Hq ** -0.5)}
    if cfg.qkv_bias:
        attn.update(bq=n((L, Hq), BIAS_STD), bk=n((L, Hk), BIAS_STD),
                    bv=n((L, Hk), BIAS_STD))
    if cfg.moe:
        E, Fe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        mlp = {"router": n((L, D, E), D ** -0.5),
               "w_gate": n((L, E, D, Fe), D ** -0.5),
               "w_up": n((L, E, D, Fe), D ** -0.5),
               "w_down": n((L, E, Fe, D), Fe ** -0.5)}
        if cfg.moe.num_shared:
            Fs = cfg.moe.num_shared * Fe
            mlp["shared"] = {"w_gate": n((L, D, Fs), D ** -0.5),
                             "w_up": n((L, D, Fs), D ** -0.5),
                             "w_down": n((L, Fs, D), Fs ** -0.5)}
    else:
        mlp = {"w_gate": n((L, D, F), D ** -0.5),
               "w_up": n((L, D, F), D ** -0.5),
               "w_down": n((L, F, D), F ** -0.5)}
    tree["layers"] = {**layers, "attn": attn, "mlp": mlp}
    if not cfg.tie_embeddings:
        tree["lm_head"] = n((D, cfg.vocab), D ** -0.5)
    return tree


def cfgs(name, dtype="float32", **kw):
    """(JAX config, port config): the reduced ``name`` in ``dtype``."""
    j = dataclasses.replace(J_ARCHS[name].reduced(), dtype=dtype, **kw)
    t = dataclasses.replace(ARCHS[name].reduced(), dtype=dtype, **kw)
    return j, t


def both_models(name, dtype="float32", seed=0, **kw):
    """(JAX model, JAX params, port model, port params) on the same
    weights (rounded once to the working type, then carried across)."""
    jcfg, tcfg = cfgs(name, dtype, **kw)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jcfg.param_dtype()),
                           numpy_params(tcfg, seed))
    tparams = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return JModel(jcfg), jparams, Model(tcfg, device="cpu"), tparams


def tokens(S, vocab, mult=7):
    return (np.arange(B * S).reshape(B, S) * mult % vocab).astype(np.int32)


def to_torch(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def assert_rel(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= RTOL[dtype] * float(np.abs(want).max()), err
