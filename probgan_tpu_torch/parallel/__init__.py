"""Parallelism over ``torch.distributed``: process meshes and the sharded
form of the ranking path.

The counterpart of ``probgan_tpu/parallel/``: entity-table tensor
parallelism over a ``DeviceMesh`` with axes ("data", "model"). The
data-parallel image and training paths (``sharded_image``, ``dp_train``)
are not ported yet (ROADMAP A2.2, A2.3).
"""

from probgan_tpu_torch.parallel.mesh import make_mesh, resolve_mesh
from probgan_tpu_torch.parallel.sharded_rank import sharded_rank_topk

__all__ = ["make_mesh", "resolve_mesh", "sharded_rank_topk"]
