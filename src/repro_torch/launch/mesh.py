"""Production meshes (port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) over 256 chips; multi-pod adds a leading
pure-DP ``pod`` axis (2 x 256 = 512 chips).  With no ``devices`` named,
the shards lie on the ``meta`` device: the dry-run
(``launch/dryrun.py``) allocates nothing and needs no 512-device
process, where the reference forces 512 host devices.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from repro_torch.core.vm import resolve_device
from repro_torch.distributed.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = ["meta"] * math.prod(shape)
    return make_mesh(shape, axes, devices)


def make_host_mesh(n_data: int = 1, n_model: int = 1, *,
                   device=None) -> Mesh:
    """A small (data, model) mesh whose every shard names ``device`` (the
    card unless named) — tests and examples."""
    dev = resolve_device(device)
    return make_mesh((n_data, n_model), ("data", "model"),
                     [dev] * (n_data * n_model))


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axis bundle for batch sharding on this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    out = 1
    for a in dp_axes(mesh):
        out *= mesh.shape[a]
    return out
