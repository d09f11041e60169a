"""Production meshes.

The JAX package's ``repro/launch/mesh.py``.  Functions, never module-level
constants, so importing this module touches no device.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh, parse_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[Any]] = None) -> Mesh:
    """16x16 single pod (256 devices) or 2x16x16 two-pod (512 devices)
    over ``devices`` (default: the visible CUDA devices); raises
    ``ValueError`` naming the count when there are fewer."""
    return parse_mesh("2x16x16" if multi_pod else "16x16", devices)


def make_local_mesh(devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Every given device (default: the visible CUDA devices) as a 1-D
    "data" mesh."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("make_local_mesh: no devices (no CUDA device is "
                         "visible; pass devices=[torch.device('cpu')])")
    return Mesh(devices, (len(devices),), ("data",))
