"""Device mesh construction for multi-chip solving.

The reference is single-threaded C++ (SURVEY.md §2b); every scaling axis it
loops over serially is a mesh axis here:

- ``frame`` — the K low-res observations (the ``for image_index`` loop,
  ``objective_data_term.cpp:104-115``): pure data parallelism, per-iteration
  gradient/cost reduced with a psum.
- ``band``  — spectral channels / PCA components (the ``split_channels`` loop,
  ``irls_map_solver.cpp:200-229``): embarrassingly parallel band solves.
- ``row`` / ``col`` — spatial tiles of the HR estimate with halo exchange
  sized by the stencil footprint (blur radius + max shift + scale).

Multi-host: call ``jax.distributed.initialize()`` before building the mesh;
``jax.devices()`` then spans all hosts and the same NamedSharding code runs
its collectives unchanged. Cards joined all to all (NVLink) have no torus to
follow: the mesh is ``jax.devices()`` in order, shaped by the algorithm.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "FRAME_AXIS", "BAND_AXIS", "ROW_AXIS", "COL_AXIS", "named_sharding"]

FRAME_AXIS = "frame"
BAND_AXIS = "band"
ROW_AXIS = "row"
COL_AXIS = "col"


def make_mesh(
    axis_sizes: dict[str, int] | None = None,
    devices=None,
) -> Mesh:
    """Build a mesh from ``{axis_name: size}``; sizes must multiply to the
    device count (one axis may be -1 to absorb the remainder)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {FRAME_AXIS: n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if sizes.count(-1) > 1:
        raise ValueError("At most one mesh axis may be -1.")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}.")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} != {n} devices.")
    dev_array = np.asarray(devices).reshape(sizes)
    return Mesh(dev_array, axis_names=tuple(names))


def named_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec(*spec))
