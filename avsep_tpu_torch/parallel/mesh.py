"""The data mesh: one axis over the ranks of the process group.

Port of ``avsep_tpu/parallel/mesh.py``.  The JAX package builds a 1-axis
``jax.sharding.Mesh`` over its devices and shards the batch on dim 0.  The
port runs one rank per card, so the data axis has one position per rank
and its width is the world size: the launch's ``P * L``, P processes of L
cards each, L set by the JAX package's width rules
(``parallel/launch.py``: ``min(num_gpus, local cards)`` for ``main``,
every local card for ``sop_main``, ``--mesh_shape``, every card of every
process under ``--dist_nprocs``).  ``num_gpus`` also keeps its meaning in
the batch size, the global batch being ``num_gpus * batch_size_per_gpu``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from avsep_tpu_torch.parallel.distributed import rank, world_size


class Mesh(NamedTuple):
    """``size`` positions on the axis ``axis_name``; this process holds
    position ``rank``."""
    axis_name: str
    size: int
    rank: int


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data") -> Mesh:
    """The data axis over ``n_devices`` ranks (None: all of them)."""
    return Mesh(axis_name, world_size() if n_devices is None else n_devices,
                rank())


def mesh_from_config(cfg, n_devices: Optional[int] = None) -> Mesh:
    """The mesh of ``--mesh_shape`` (one axis; its width, no larger than
    the devices there are, and in a multi-process job all of them) and
    ``--data_axis`` (its name).  ``n_devices`` is the caller's default
    width (None: every device of the launch, one per rank).  The launcher
    checks ``--mesh_shape`` against the cards before it starts a rank
    (``launch.local_width``, the same errors); here the devices are the
    group's ranks."""
    if cfg.mesh_shape:
        if len(cfg.mesh_shape) != 1:
            raise ValueError(
                "only 1-axis (data-parallel) meshes are supported; got "
                f"mesh_shape={tuple(cfg.mesh_shape)}")
        w = int(cfg.mesh_shape[0])
        avail = world_size()
        if w > avail:
            raise ValueError(f"mesh_shape={w} exceeds the {avail} "
                             "available devices")
        if avail > 1 and w != avail:
            raise ValueError("multi-host jobs must span every device "
                             f"(mesh_shape={w}, devices={avail}): all "
                             "processes participate in every SPMD program")
        n_devices = w
    return make_mesh(n_devices, cfg.data_axis)
