"""Production meshes on torch ``DeviceMesh``: the port of
``repro/launch/mesh.py``.

Defined as functions, not module constants, so that importing this module
touches no process group: a mesh needs one already started (the fake
group of the dry run, NCCL on the card, gloo on the CPU).

Topology convention (NVIDIA HGX H100):
  * a host is 8 GPUs joined by NVLink; a pod is 256 GPUs = 32 hosts;
  * single-pod mesh (data=16, model=16);
  * multi-pod mesh (pod=2, data=16, model=16): the 'pod' axis crosses the
    DCN leaf-spine fabric, where the paper's ECMP analysis applies.

The step runs on ``step_mesh`` (``parallel.sharding``): the batch axes
flattened into one mesh dim, so that a gradient reduction over ('pod', 'data') is one collective
over the rank group XLA's replica groups name (ranks 0, 2, 4, 6 on
(2, 2, 2)), not a pod stage and a data stage, which would put other ring
edges on the DCN.  The leaves FSDP and ZeRO-2 shard over 'data' live on
the production mesh itself, its root, replicated over 'pod', as the reference
shards them (``parallel.sharding.place``): their gathers and
reduce-scatters run within a pod, over 'data', and their gradients add
across the pods by an all-reduce over 'pod'.
"""

from __future__ import annotations

from ..parallel.sharding import step_mesh  # noqa: F401  (the step's mesh)

# H100 SXM5 constants used by the roofline analysis (NVIDIA's data sheet)
PEAK_FLOPS_BF16 = 989.4e12        # dense bf16 FLOP/s per GPU
HBM_BW = 3.35e12                  # HBM3 bytes/s per GPU
ICI_LINK_BW = 450e9               # NVLink 4 bytes/s per GPU, one direction
CHIPS_PER_HOST = 8
DEVICE_MEMORY = 80e9              # bytes of HBM per GPU

BATCH_AXES_MULTI = ("pod", "data")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) ('data', 'model') or (2, 16, 16) ('pod', 'data',
    'model') mesh over the current process group, whose world size must
    be 256 or 512 (the dry run's fake group)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def device_coords(mesh, chips_per_host: int = CHIPS_PER_HOST
                  ) -> dict[int, tuple[int, int, int]]:
    """rank -> (pod, global_host, chip-in-host) for ``collectives_to_flows``.

    Ranks are laid out C-order over the mesh axes; within a pod,
    consecutive ranks share a host in groups of ``chips_per_host``.
    """
    return coords_of([int(r) for r in mesh.mesh.flatten().tolist()],
                     mesh_shape(mesh).get("pod", 1), chips_per_host)


def coords_of(ids: list[int], npods: int, chips_per_host: int = CHIPS_PER_HOST
              ) -> dict[int, tuple[int, int, int]]:
    """``device_coords`` of the ranks ``ids`` in mesh order over
    ``npods`` pods (no process group needed)."""
    per_pod = len(ids) // npods
    coords = {}
    for i, dev in enumerate(ids):
        pod = i // per_pod
        within = i % per_pod
        host = pod * (per_pod // chips_per_host) + within // chips_per_host
        coords[dev] = (pod, host, within % chips_per_host)
    return coords


def batch_axes(mesh) -> tuple[str, ...]:
    return BATCH_AXES_MULTI if "pod" in mesh.mesh_dim_names else ("data",)
