"""avsep_tpu_torch.parallel: data parallelism over ranks, one card each.

Port of ``avsep_tpu/parallel/``: the data mesh (``mesh.py``), the process
group, batch rows, collectives and primary-only writes
(``distributed.py``) behind ``--mesh_shape``, ``--data_axis`` and the
``--dist_*`` flags, and the launcher that starts one rank per card a
process spans (``launch.py``, the JAX package's width rules).
"""

from avsep_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, mesh_from_config)
