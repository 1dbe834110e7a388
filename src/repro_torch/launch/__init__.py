"""Launchers of the port: production meshes, the dry run, the collective
source, the training launcher and the trace job.

Importing this package starts no process group and sets no environment
variable: ``launch.dryrun`` starts its fake group in ``main``, and the
launcher its NCCL or gloo group when it runs.
"""

from .mesh import (
    CHIPS_PER_HOST, DEVICE_MEMORY, HBM_BW, ICI_LINK_BW, PEAK_FLOPS_BF16,
    batch_axes, device_coords, make_production_mesh, step_mesh,
)

__all__ = [
    "make_production_mesh", "device_coords", "batch_axes", "step_mesh",
    "PEAK_FLOPS_BF16", "HBM_BW", "ICI_LINK_BW", "CHIPS_PER_HOST",
    "DEVICE_MEMORY",
]
