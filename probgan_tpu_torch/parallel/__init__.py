"""Parallelism over ``torch.distributed``: process meshes, the sharded form
of the ranking path, data parallelism for the image family and the KG
train state row-sharded.

The counterpart of ``probgan_tpu/parallel/``: entity-table tensor
parallelism over a ``DeviceMesh`` with axes ("data", "model")
(``sharded_rank``), data-parallel image generation and scoring
(``sharded_image``), data-parallel image training and the KG state's table
and moments row-sharded over "model" (``dp_train``, with the sharded pieces
of the KG step in ``sharded_kg``). ``sharded_image`` and ``dp_train``
import the engines, so they are imported from their modules, as in the JAX
package.
"""

from probgan_tpu_torch.parallel.mesh import make_mesh, mesh_group, resolve_mesh
from probgan_tpu_torch.parallel.sharded_rank import sharded_rank_topk

__all__ = ["make_mesh", "mesh_group", "resolve_mesh", "sharded_rank_topk"]
