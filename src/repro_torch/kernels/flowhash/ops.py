"""Bulk flow hashing + vectorized paper-testbed path decisions.

The port of ``repro/kernels/flowhash/ops.py``.  One CUDA kernel
(``csrc/flowhash.cu``) serves every murmur consumer, with the JAX
package's one murmur definition — seed-as-init, fold the field columns,
fmix:

* ``murmur_hash_grid`` — the (N, S) per-(flow, seed) grid the ECMP walk
  hashes on every hop; its single-column case is ``bulk_hash_seeded``
  (the port of ``bulk_hash_seeded_kernel``);
* ``bulk_hash`` — one scalar seed broadcast over the rows (the port of
  ``bulk_hash_kernel``), so ``bulk_hash(f, s) ==
  bulk_hash_seeded(f, full(N, s))`` bit for bit by construction;
* ``bulk_ecmp_choice`` / ``simulate_paper_paths`` / ``link_loads_fim`` —
  the paper testbed's four cross-rack ECMP decisions for N flows at once.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain version in ``ref.py``.  ``LAUNCHES`` counts kernel launches per
wrapper (CPU calls never count), so a run can show that it went through
the kernel, and ``GRID_LAUNCHES_BY_FIELDS`` the grid's launches by the
width they hashed.
"""

from __future__ import annotations

import torch

from . import build
from .ref import murmur_hash_grid_ref

_MASK32 = 0xFFFFFFFF

#: kernel launches per wrapper, counted only where the kernel launches
LAUNCHES = {"murmur_hash_grid": 0, "bulk_hash": 0}
#: ``murmur_hash_grid`` launches by the number of hash fields (5 for the
#: 5-tuple, 7 for a sprayed flowlet's 5-tuple and two entropy digits)
GRID_LAUNCHES_BY_FIELDS: dict[int, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    GRID_LAUNCHES_BY_FIELDS.clear()


def _launch(fields: torch.Tensor, seeds: torch.Tensor | None, stride_n: int,
            stride_s: int, n_seeds: int, seed_value: int = 0) -> torch.Tensor:
    """Launch ``flowhash_grid`` on the current stream of ``fields``'
    device; ``seeds`` is addressed as ``seeds[n*stride_n + s*stride_s]``
    from its first element, and ``seeds=None`` hashes every cell from
    ``seed_value`` (a 32-bit int passed by value)."""
    N, F = fields.shape
    out = torch.empty((N, n_seeds), dtype=torch.int64, device=fields.device)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.load().flowhash_grid(
            fields.data_ptr(), F, None if seeds is None else seeds.data_ptr(),
            stride_n, stride_s, seed_value, out.data_ptr(), N, n_seeds,
            stream)
    if rc != 0:
        raise RuntimeError(f"flowhash_grid launch failed with CUDA error {rc}")
    return out


def _check_fields(fields: torch.Tensor) -> None:
    if fields.dtype != torch.int64 or fields.dim() != 2:
        raise TypeError(f"fields must be a 2-D int64 tensor, got "
                        f"{fields.dtype} of shape {tuple(fields.shape)}")
    if not fields.is_contiguous():
        raise ValueError("fields must be contiguous")
    if fields.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {fields.device}")


def murmur_hash_grid(fields: torch.Tensor,
                     dev_seed: torch.Tensor) -> torch.Tensor:
    """fields: (N, F) int64; dev_seed: (N, S) int64 -> (N, S) int64
    hashes in [0, 2**32).  Seeds and fields hash by their low 32 bits
    (the JAX package truncates the device seed the same way)."""
    _check_fields(fields)
    if (dev_seed.dtype != torch.int64 or dev_seed.dim() != 2
            or dev_seed.shape[0] != fields.shape[0]):
        raise TypeError(
            f"dev_seed must be a ({fields.shape[0]}, S) int64 tensor, got "
            f"{dev_seed.dtype} of shape {tuple(dev_seed.shape)}")
    if dev_seed.device != fields.device:
        raise ValueError(f"fields on {fields.device}, dev_seed on "
                         f"{dev_seed.device}")
    if fields.device.type == "cpu":
        return murmur_hash_grid_ref(fields, dev_seed)
    if not dev_seed.is_contiguous():
        raise ValueError("dev_seed must be contiguous")
    S = dev_seed.shape[1]
    out = _launch(fields, dev_seed, S, 1, S)
    LAUNCHES["murmur_hash_grid"] += 1
    F = fields.shape[1]
    GRID_LAUNCHES_BY_FIELDS[F] = GRID_LAUNCHES_BY_FIELDS.get(F, 0) + 1
    return out


def _fields64(fields) -> torch.Tensor:
    """Integer field matrix as contiguous int64 (values keep their low
    32 bits, which is all the hash reads)."""
    t = torch.as_tensor(fields)
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        raise TypeError(f"fields must be integers, got {t.dtype}")
    return t.to(torch.int64).contiguous()


def bulk_hash(fields, seed: int) -> torch.Tensor:
    """fields: (N, F) integers -> (N,) int64 hashes in [0, 2**32).
    ``seed``: any int (wrapped to 32 bits) — the hash init of every row.
    On the card the seed goes to the kernel by value: no device tensor,
    no host-to-device copy, no synchronisation."""
    f = _fields64(fields)
    _check_fields(f)
    seed = int(seed) & _MASK32
    if f.device.type == "cpu":
        init = torch.full((f.shape[0], 1), seed, dtype=torch.int64)
        return murmur_hash_grid_ref(f, init)[:, 0]
    out = _launch(f, None, 0, 0, 1, seed)
    LAUNCHES["bulk_hash"] += 1
    return out[:, 0]


def bulk_hash_seeded(fields, seeds) -> torch.Tensor:
    """fields: (N, F) integers, seeds: (N,) per-row hash init -> (N,)
    int64.  The single-column case of ``murmur_hash_grid``."""
    f = _fields64(fields)
    s = torch.as_tensor(seeds, device=f.device).to(torch.int64)
    if s.shape != (f.shape[0],):
        raise ValueError(f"seeds must be ({f.shape[0]},), got {tuple(s.shape)}")
    return murmur_hash_grid(f, s.reshape(-1, 1).contiguous())[:, 0]


def bulk_ecmp_choice(fields, seed: int, n_choices: int) -> torch.Tensor:
    return (bulk_hash(fields, seed) % n_choices).to(torch.int32)


def simulate_paper_paths(
    fields,                       # (N, 5) flow 5-tuple fields
    *,
    num_spines: int = 4,
    links_per_leaf_spine: int = 4,
    ports_per_lag: int = 2,
    seeds: tuple[int, int, int, int] = (101, 202, 303, 404),
) -> dict[str, torch.Tensor]:
    """Four-stage ECMP decision vector for every flow (paper Fig. 2).

    Returns int32 tensors: src_port (LAG), uplink (leaf->spine link index
    in [0, spines*links)), spine_link (spine->dst-leaf link in [0, links)),
    dst_port (LAG).  Stage seeds model per-switch hash seeds.
    """
    return {
        "src_port": bulk_ecmp_choice(fields, seeds[0], ports_per_lag),
        "uplink": bulk_ecmp_choice(fields, seeds[1],
                                   num_spines * links_per_leaf_spine),
        "spine_link": bulk_ecmp_choice(fields, seeds[2],
                                       links_per_leaf_spine),
        "dst_port": bulk_ecmp_choice(fields, seeds[3], ports_per_lag),
    }


def link_loads_fim(choices: torch.Tensor,
                   n_links: int) -> tuple[torch.Tensor, float]:
    """Per-link flow counts + FIM (eq. 1) from a choice vector."""
    counts = torch.bincount(choices.to(torch.int64), minlength=n_links)
    ideal = int(counts.sum()) / n_links
    if ideal <= 0:
        return counts, 0.0
    dev = (counts.to(torch.float64) - ideal).abs().sum().item()
    return counts, 100.0 / n_links * (dev / ideal)
