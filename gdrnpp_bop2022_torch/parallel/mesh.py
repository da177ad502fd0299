"""The data mesh of data-parallel training, and the batch's slice for a rank.

Port of ``gdrnpp_bop2022_tpu/parallel/mesh.py``. The JAX package shards a
global batch over a ``jax.sharding.Mesh`` of devices and lets XLA insert
the gradient sum; here a mesh is the ranks of the process group (one per
card), and ``shard_batch`` hands each rank its equal slice of the global
batch. Only a 1-D ``"data"`` axis is taken: the JAX package builds the mesh
n-D, but every array it places is sharded over ``"data"`` or replicated,
so any other axis only replicates work; such an axis raises
NotImplementedError rather than run that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .distributed import rank, world_size


@dataclass(frozen=True)
class Mesh:
    """The 1-D "data" mesh over the world's ranks: ``size`` ranks; this
    process is ``index`` on it."""
    size: int
    index: int


def make_mesh(mesh_shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of ``cfg.train.mesh_shape`` / ``mesh_axes`` over the ranks:
    (-1,) is every rank; a fixed size must equal the world size. An axis
    other than "data", or more than one axis, raises NotImplementedError."""
    shape, names = tuple(int(s) for s in mesh_shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh_shape {shape} and mesh_axes {names} differ in length")
    if names != ("data",):
        raise NotImplementedError(
            f"mesh_axes {names}: the port runs a 1-D 'data' mesh (data parallelism); "
            "in the JAX package any other axis only replicates work")
    w = world_size()
    size = w if shape[0] == -1 else shape[0]
    if size != w:
        raise ValueError(f"mesh_shape {shape} has {size} ranks; the world has {w}")
    return Mesh(size=size, index=rank())


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """The rank's equal slice of dim 0 of every array of the global batch
    whose dim 0 is the batch size (the first array's); other entries as
    they are. The batch size must divide by the mesh size."""
    if mesh.size == 1:
        return batch
    sizes = [v.shape[0] for v in batch.values()
             if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim > 0]
    if not sizes:
        return batch
    n = sizes[0]
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not split over {mesh.size} ranks")
    k = n // mesh.size
    lo = mesh.index * k
    return {key: v[lo:lo + k] if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim > 0
            and v.shape[0] == n else v for key, v in batch.items()}
