"""Carry state into the port from plain data.

The simulator's state is the compiled fabric tables, the flow table and
a routed result, and a phased simulation's its schedule; the model
stack's is its weights.  These helpers build the port's own types from
numpy arrays and plain tuples, so another implementation's compiled
fabric (for instance the JAX package's ``CompiledFabric``, field by
field), flows, routed paths, schedules and LM parameters can be handed
to the port exactly.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

from .configs.base import ArchConfig
from .core.compile_fabric import CompiledFabric
from .core.fabric import Fabric
from .core.flows import FiveTuple, Flow
from .core.timeline import TimelineStep
from .core.vector_sim import VectorTraceResult, normalize_seeds
from .device import resolve_device
from .models.lm import check_supported

#: the array fields of a ``CompiledFabric`` and their dtypes
ARRAY_FIELDS = {
    "dev_crc": np.uint64, "is_server": np.bool_, "link_src": np.int32,
    "link_dst": np.int32, "link_layer": np.int32, "link_gbps": np.float64,
    "key_server": np.int32, "cand": np.int32, "cand_n": np.int32,
}


def compiled_from_arrays(arrays: dict[str, np.ndarray], fabric: Fabric,
                         key_of_ip: dict[str, int]) -> CompiledFabric:
    """A ``CompiledFabric`` from its tables given as numpy arrays.

    ``arrays`` holds every name of ``ARRAY_FIELDS``; ``fabric`` supplies
    the device, link and layer order the tables index, and ``key_of_ip``
    the NIC key of every NIC ip.  Shapes are checked against the fabric.
    """
    missing = sorted(set(ARRAY_FIELDS) - set(arrays))
    if missing:
        raise KeyError(f"compiled_from_arrays is missing {missing}")
    a = {k: np.ascontiguousarray(arrays[k], dt)
         for k, dt in ARRAY_FIELDS.items()}
    device_names = list(fabric.devices)
    links = list(fabric.links)
    V, L, K = len(device_names), len(links), len(key_of_ip)
    want = {"dev_crc": (V,), "is_server": (V,), "link_src": (L,),
            "link_dst": (L,), "link_layer": (L,), "link_gbps": (L,),
            "key_server": (K,), "cand_n": (V, K)}
    for k, shape in want.items():
        if a[k].shape != shape:
            raise ValueError(f"{k} has shape {a[k].shape}, expected {shape}")
    if a["cand"].ndim != 3 or a["cand"].shape[:2] != (V, K):
        raise ValueError(
            f"cand has shape {a['cand'].shape}, expected ({V}, {K}, C_max)")
    return CompiledFabric(
        fabric=fabric,
        device_names=device_names,
        device_id={name: i for i, name in enumerate(device_names)},
        links=links,
        layer_names=fabric.layers,
        key_of_ip=dict(key_of_ip),
        nic_indices=tuple(sorted({int(ip.split(".")[1]) for ip in key_of_ip})),
        **a,
    )


def flows_from_records(
    records: Iterable[tuple],
) -> list[Flow]:
    """Flows from plain tuples ``(flow_id, src, dst, src_ip, dst_ip,
    src_port, dst_port, protocol, bytes)``, optionally followed by the
    flow's ``label`` (collective-derived flows carry their channel
    there, ``#ch<N>``, which ``core.timeline`` partitions by)."""
    out = []
    for (fid, src, dst, sip, dip, sport, dport, proto, nbytes,
         *label) in records:
        (label,) = label or ("",)
        out.append(Flow(flow_id=int(fid), src=src, dst=dst,
                        tuple5=FiveTuple(sip, dip, int(sport), int(dport),
                                         int(proto)),
                        bytes=int(nbytes), label=str(label)))
    return out


def schedule_from_records(
    records: Iterable[tuple],
) -> list[TimelineStep]:
    """A phase schedule from plain tuples ``(name, channels, duration)``
    (``TimelineStep``'s fields: a step's name, its collective channel
    ids and its relative duration under static timing), validated as
    ``TimelineStep`` validates them."""
    return [TimelineStep(str(name), tuple(int(c) for c in channels),
                         float(duration))
            for name, channels, duration in records]


def trace_result_from_arrays(
    comp: CompiledFabric,
    flows: list[Flow],
    seeds,
    link_ids: np.ndarray,
    *,
    flow_index: np.ndarray | None = None,
    demand: np.ndarray | None = None,
    flow_demand: np.ndarray | None = None,
    extra_exposure: np.ndarray | None = None,
    strategy: str = "ecmp",
    device=None,
) -> VectorTraceResult:
    """The port's ``VectorTraceResult`` from a routed result given as
    numpy arrays: ``link_ids`` (H, Nf, S), and optionally the flowlet
    columns' ``flow_index`` and ``demand`` (Nf,), the per-flow
    ``flow_demand`` (N,) and a strategy's ``extra_exposure`` (N, S);
    left out, each takes the single-path default.  The tensors land on
    ``device`` (the card unless ``"cpu"``)."""
    ids = np.asarray(link_ids)
    if ids.ndim != 3:
        raise ValueError(f"link_ids must be (H, Nf, S), got {ids.shape}")
    seeds_u64 = normalize_seeds(seeds)
    if ids.shape[2] != len(seeds_u64):
        raise ValueError(f"link_ids has {ids.shape[2]} seeds, "
                         f"seeds has {len(seeds_u64)}")
    return VectorTraceResult(
        compiled=comp, flows=list(flows), seeds=seeds_u64,
        link_ids=torch.from_numpy(ids.astype(np.int32)).to(
            resolve_device(device)),
        flow_index=flow_index, demand=demand, strategy=strategy,
        flow_demand=flow_demand, extra_exposure=extra_exposure)


def _tensor(a: np.ndarray, dtype: torch.dtype | None,
            device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of ``dtype`` (None: its own); a
    bfloat16 array (numpy's ``ml_dtypes`` extension type) crosses bit
    for bit as its 16-bit pattern."""
    a = np.array(a, order="C")            # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


#: leaves the reference makes as f32 constants (``InitCtx.const``): they
#: stay f32 whatever the parameter dtype
F32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


def lm_params_from_numpy(cfg: ArchConfig, tree: dict, *,
                         device=None) -> dict:
    """The port's LM weights from the JAX package's parameter pytree as
    numpy arrays.  Top-level leaves (``embed``, ``final_norm``,
    ``lm_head`` of untied configs, the encoder-decoder's
    ``enc_final_norm_b`` and ``final_norm_b``) cross as they are, and so
    does ``layer0``, the unrolled dense first layer of an MLA config.
    ``layers`` stacks every leaf on a leading axis of the stacked layers
    (``num_layers`` less the unrolled one), nested dicts included (the
    q/k/v biases, the MLA leaves, a MoE's router, experts and shared
    expert, cross-attention and the layer norms' biases), and
    ``encoder`` on one of ``num_encoder_layers``; each stack becomes one
    dict per layer.  The hybrid's ``periods`` stacks every leaf on the
    periods, and its ``mamba``, ``dense_ffn`` and ``moe_ffn`` leaves on a
    second axis of their sublayers (``period - 1``, ``period - period //
    2``, ``period // 2``): each period becomes one dict, its ``attn`` one
    dict and each of the three a list of sublayer dicts.  Each leaf
    keeps its (in, out) layout and becomes ``cfg.param_dtype()`` on
    ``device`` (the card unless ``"cpu"``), except the f32 constants of
    ``F32_LEAVES``, which stay f32."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.param_dtype()
    return _unstack(cfg, tree, lambda k, v: _tensor(
        v, torch.float32 if k in F32_LEAVES else dt, dev))


def _unstack(cfg: ArchConfig, tree: dict, leaf) -> dict:
    """``lm_params_from_numpy``'s walk, each leaf made by ``leaf(key,
    array)``."""
    def whole(sub: dict) -> dict:
        return {k: whole(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in sub.items()}

    def pick(sub: dict, i: int, L: int, stack: str) -> dict:
        """Entry ``i`` of every leaf of ``sub``, stacked on ``L``."""
        out = {}
        for k, v in sub.items():
            if isinstance(v, dict):
                out[k] = pick(v, i, L, stack)
            elif np.shape(v)[0] != L:
                raise ValueError(f"{stack} leaf {k!r} stacks {np.shape(v)[0]} "
                                 f"layers, {cfg.name} has {L}")
            else:
                out[k] = np.asarray(v)[i]
        return out

    def period(sub: dict, i: int, P: int) -> dict:
        per = cfg.hybrid.period
        inner = {"mamba": per - 1, "dense_ffn": per - per // 2,
                 "moe_ffn": per // 2}
        out = {}
        for part, v in pick(sub, i, P, "periods").items():
            n = inner.get(part)
            out[part] = whole(v) if n is None else [
                whole(pick(v, j, n, part)) for j in range(n)]
        return out

    stacks = {"layers": cfg.num_layers - (cfg.moe.first_dense_layers
                                          if cfg.moe else 0)}
    if cfg.encdec:
        stacks["encoder"] = cfg.encdec.num_encoder_layers
    params = {}
    for k, v in tree.items():
        if k == "periods":
            P = cfg.num_layers // cfg.hybrid.period
            params[k] = [period(v, i, P) for i in range(P)]
        elif k in stacks:
            params[k] = [whole(pick(v, i, stacks[k], k))
                         for i in range(stacks[k])]
        elif isinstance(v, dict):
            params[k] = whole(v)
        else:
            params[k] = leaf(k, v)
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bfloat16 (which numpy lacks) widens
    to float32, exactly."""
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(items: list):
    """Stack a list of like trees leaf by leaf on a new leading axis; a
    list inside each item (a hybrid period's sublayers) is stacked
    first, giving two leading axes."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, list):
        return _stack([_stack(it) for it in items])
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return np.stack([_to_numpy(t) for t in items])


def lm_params_to_numpy(cfg: ArchConfig, params: dict) -> dict:
    """The inverse of ``lm_params_from_numpy``: the port's LM tree (its
    weights, or anything of their structure: gradients, AdamW moments)
    as the JAX package's pytree of numpy arrays, each list of layers
    stacked back on a leading axis (a hybrid's sublayer lists on a
    second), so that it compares leaf by leaf with the reference's.
    Leaves keep their dtype; bfloat16 comes back as float32 of the same
    values."""
    check_supported(cfg)

    def whole(sub):
        if isinstance(sub, dict):
            return {k: whole(v) for k, v in sub.items()}
        return _to_numpy(sub)

    return {k: _stack(v) if isinstance(v, list) else whole(v)
            for k, v in params.items()}


def adamw_state_from_numpy(cfg: ArchConfig, state: dict, *,
                           device=None) -> dict:
    """The port's AdamW state from the reference's ``{"m", "v",
    "step"}`` as numpy arrays: the moments laid out as the port's
    parameters (``lm_params_from_numpy``'s walk), each keeping its own
    dtype (float32, or bfloat16 for ``state_dtype="bfloat16"``, bit for
    bit), and the step an int32 scalar, on ``device`` (the card unless
    ``"cpu"``)."""
    check_supported(cfg)
    dev = resolve_device(device)

    def own(k: str, v) -> torch.Tensor:
        return _tensor(v, None, dev)

    return {"m": _unstack(cfg, state["m"], own),
            "v": _unstack(cfg, state["v"], own),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
