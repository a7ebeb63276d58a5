"""avsep_tpu_torch.parallel: data parallelism over processes, one card each.

Port of ``avsep_tpu/parallel/``: the data mesh (``mesh.py``) and the
process group, batch rows, collectives and primary-only writes
(``distributed.py``) behind ``--mesh_shape``, ``--data_axis`` and the
``--dist_*`` flags.
"""

from avsep_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, mesh_from_config)
