"""Shared set-up of the port's training parity tests: ``Model.loss`` and
its gradients against ``jax.value_and_grad`` of the JAX package's, on
the same numpy-drawn weights (``tests/_torch_lm.py``) in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _torch_lm import both_models, mrope_positions

from repro_torch.interop import lm_params_to_numpy
from repro_torch.models import Model
from repro_torch.models.lm import RematPolicy
from repro_torch.train import loss_and_grads
from repro_torch.tree import leaves

#: the loss relative to itself; each gradient leaf relative to its
#: largest |value|
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
S, ENC_FRAMES = 32, 16


def train_batch(cfg, seed=0) -> dict:
    """(B 2, S 32) tokens and their next-token labels, plus the keys a
    config's forward needs: the encoder-decoder's frame embeddings, and
    M-RoPE positions of a 4 x 4 image after 4 text tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (2, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        batch["mrope_positions"] = mrope_positions(S, 4, 4)
    return batch


class Reference:
    """Each config's reference loss and gradient, compiled once."""

    def __init__(self):
        self.cache = {}

    def __call__(self, name):
        if name not in self.cache:
            jm, jp, tm, tp = both_models(name)
            batch = train_batch(tm.cfg)
            fn = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
            (loss, metrics), grads = fn(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            self.cache[name] = (tm, tp, batch, float(loss),
                                float(metrics["moe_aux"]),
                                jax.tree.map(np.asarray, grads))
        return self.cache[name]


def port_loss_and_grads(model: Model, params: dict, batch: dict):
    """(loss, metrics, gradient tree) of the port's ``Model.loss`` on a
    numpy batch."""
    return loss_and_grads(model, params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})


def check_against_reference(ref: Reference, name: str) -> None:
    tm, tp, batch, want_loss, want_aux, want = ref(name)
    loss, metrics, grads = port_loss_and_grads(tm, tp, batch)
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(metrics["moe_aux"].item() - want_aux) <= \
        LOSS_RTOL * max(abs(want_aux), 1.0)
    got = lm_params_to_numpy(tm.cfg, grads)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * float(np.abs(w).max()), \
            (jax.tree_util.keystr(path), err)


def check_remat_bit_for_bit(ref: Reference, name: str, policy: str) -> None:
    """The gradients with the layers checkpointed (sqrt groups) equal
    those without, bit for bit."""
    tm, tp, batch, *_ = ref(name)
    _, _, plain = port_loss_and_grads(
        Model(tm.cfg, device="cpu", remat=RematPolicy(enabled=False)), tp,
        batch)
    _, _, remat = port_loss_and_grads(
        Model(tm.cfg, device="cpu", remat=RematPolicy(policy=policy)), tp,
        batch)
    for a, b in zip(leaves(plain), leaves(remat)):
        assert torch.equal(a, b)
