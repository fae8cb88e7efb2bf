"""Parallelism over ``torch.distributed``: process meshes, the sharded form
of the ranking path and data parallelism for the image family.

The counterpart of ``probgan_tpu/parallel/``: entity-table tensor
parallelism over a ``DeviceMesh`` with axes ("data", "model")
(``sharded_rank``), data-parallel image generation and scoring
(``sharded_image``) and data-parallel image training (``dp_train``). The
KG half of ``dp_train`` (``shard_kg_state``, ``kg_batch_sharding``) is not
ported yet (ROADMAP A2.3). ``sharded_image`` and ``dp_train`` import the
engines, so they are imported from their modules, as in the JAX package.
"""

from probgan_tpu_torch.parallel.mesh import make_mesh, mesh_group, resolve_mesh
from probgan_tpu_torch.parallel.sharded_rank import sharded_rank_topk

__all__ = ["make_mesh", "mesh_group", "resolve_mesh", "sharded_rank_topk"]
