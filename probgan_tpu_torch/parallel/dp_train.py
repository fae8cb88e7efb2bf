"""Training over a process mesh: data-parallel progressive-GAN steps, and
the KG state row-sharded over "model" with its batch split over "data".

The counterpart of ``probgan_tpu/parallel/dp_train.py``.

**Image.** The train state is replicated, the global batch is split over
every rank of the mesh (``mesh_group``), and each rank runs the whole step
body on its rows on its own device, the packed kernels with their autograd
Functions included. Inside the step (``engine/train.py:progan_train_step``'s
``axis_names``) the discriminator's minibatch-stddev statistics are taken
over the whole batch and the gradients are averaged over the ranks, one
all-reduce of one flat buffer a network. With equal shares that is the
one-device step on the whole batch up to the order of float sums, so every
rank takes the same Adam update, the state stays replicated with no
broadcast, and checkpoints pass between one-device and mesh training.

**KG.** ``shard_kg_state`` places a ``KGTrainState``: the entity table and
its two Adam moments (inside ``g_opt``, which optimizes ``(g_params,
node_emb, rel_emb)``), 3x the table's bytes, become this rank's rows along
"model" (``parallel/sharded_rank.py:row_shard``), every other leaf is
replicated. A shard is a plain local tensor (``sharded_kg.py`` says why
not a ``DTensor``); where its rows lie is held, with the axes' groups, by
the run's ``sharded_kg.py:KGMesh`` (``kg_mesh(mesh, N)``), which
``engine/train.py:kg_train_step(mesh=)`` and ``kg_eval_hits(mesh=)`` take
to do the sharded math that GSPMD does for JAX's jitted step. The
placement is by position, where JAX's takes every leaf of shape [N, D]: a
generator weight of that shape (N = 2 D + noise) stays replicated here.
``kg_batch_sharding`` gives a rank its rows of a step's batch along "data";
``gather_kg_state`` is the way back to the one-device state (JAX's
``np.asarray`` of a sharded leaf), on the saving rank's host alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from probgan_tpu_torch.core.tree import tree_map
from probgan_tpu_torch.engine.train import KGTrainState, ProGANTrainState, progan_train_step
from probgan_tpu_torch.models.pro_gan import ProGANConfig
from probgan_tpu_torch.parallel.mesh import axis_size, mesh_group, rank_device
from probgan_tpu_torch.parallel.sharded_image import (
    broadcast_tree,
    local_rows,
    require_divisible,
)
from probgan_tpu_torch.parallel.sharded_kg import KGMesh
from probgan_tpu_torch.parallel.sharded_rank import shard_entity_table


def replicate_state(mesh: DeviceMesh, state: ProGANTrainState) -> ProGANTrainState:
    """The whole train state on this rank's device, with the mesh's first
    rank's bits on every rank (Adam's step counts stay on the CPU, as
    ``adam_init`` keeps them). Run at the start of training and after a
    resume's load; the step keeps the replicas equal."""
    state = broadcast_tree(state, mesh_group(mesh), rank_device(mesh.device_type))

    def count_on_cpu(opt):
        return (opt[0]._replace(count=opt[0].count.cpu()), *opt[1:])

    return state._replace(g_opt=count_on_cpu(state.g_opt), d_opt=count_on_cpu(state.d_opt))


def _map_table(state: KGTrainState, table_fn, other_fn) -> KGTrainState:
    """``state`` with ``table_fn`` applied to the entity table and its two
    Adam moments and ``other_fn`` to every other tensor leaf; Adam's step
    counts stay where they are (on the CPU, as ``adam_init`` keeps them)."""
    def opt(o, table_at=None):
        adam = o[0]

        def moments(tree):
            if table_at is None:
                return tree_map(other_fn, tree)
            return tuple(table_fn(x) if i == table_at else tree_map(other_fn, x)
                         for i, x in enumerate(tree))

        return (adam._replace(mu=moments(adam.mu), nu=moments(adam.nu)), *o[1:])

    return KGTrainState(table_fn(state.node_emb), other_fn(state.rel_emb),
                        tree_map(other_fn, state.g_params), tree_map(other_fn, state.d_params),
                        opt(state.g_opt, table_at=1), opt(state.d_opt))


def shard_kg_state(mesh: DeviceMesh, state: KGTrainState) -> KGTrainState:
    """This rank's part of a one-device ``KGTrainState`` on ``mesh``, on its
    device (card ``local_rank % device_count`` on CUDA): the table and its
    two moments as its rows along "model" ([ceil(N / tp), D], the last shard
    zero-padded), every other leaf whole. Every rank passes the same state
    (built from the same seed or loaded from the same file), as JAX's
    ``device_put`` places one value. Run after init and after a resume's
    load; the step keeps the layout."""
    device = rank_device(mesh.device_type)
    return _map_table(state, lambda x: shard_entity_table(x, mesh).to(device),
                      lambda x: x.to(device, copy=True))


def gather_kg_state(kg: KGMesh, state: KGTrainState, dst: int = 0) -> KGTrainState | None:
    """The one-device state (JAX's ``np.asarray`` of each leaf), padding
    dropped, on the CPU of world rank ``dst``, the rank that saves it; None
    on every other rank. The table and its two moments come to ``dst`` from
    their owners in its model group a chunk at a time
    (``sharded_kg.py:KGMesh.collect``), so no rank holds more of them on its
    device than its shard, and no rank but ``dst`` holds them whole. Every
    rank of ``dst``'s model group calls it; the other ranks may."""
    me = dist.get_rank()
    whole = _map_table(state, lambda x: kg.collect(x, dst),
                       lambda x: x.cpu() if me == dst else x)
    return whole if me == dst else None


def kg_batch_sharding(mesh: DeviceMesh):
    """The placement of a step's batch tensors (triplets, negatives): a
    function that returns this rank's contiguous rows of a global batch
    along "data" (the same rows on every rank of a model group), on its
    device: JAX's ``NamedSharding(mesh, P("data"))``. A batch that the data
    axis does not divide raises ValueError, before any collective."""
    dp, group = axis_size(mesh, "data"), mesh.get_group("data")
    device = rank_device(mesh.device_type)

    def rows(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % dp:
            raise ValueError(f"batch {x.shape[0]} must be divisible by the data axis's "
                             f"{dp} devices")
        return local_rows(x, group).to(device)

    return rows


def dp_progan_train_step(
    mesh: DeviceMesh,
    state: ProGANTrainState,
    real_images: torch.Tensor,
    z: torch.Tensor,
    alpha,
    config: ProGANConfig,
    stage: int,
    lr: float = 1e-3,
    dtype=torch.float32,
    ema_beta: float = 0.999,
    packed_fake: bool = False,
    remat: bool = True,
    packed_d: bool = False,
    packed_g: bool = False,
    packed_train_mode: str = "default",
    r1_gamma: float = 0.0,
):
    """One data-parallel G/D step: ``progan_train_step``'s contract, with
    ``real_images`` [B, R, R, 3] and ``z`` [B, latent_dim] the global batch,
    the same on every rank, of which each rank steps on its contiguous rows.
    B must be a multiple of the mesh size: unequal shares would weight the
    averaged gradients unevenly, and the minibatch stddev forbids padding.
    Returns (the new replicated state, the metrics averaged over the ranks)."""
    for batch in (real_images.shape[0], z.shape[0]):
        require_divisible(batch, mesh, " for data-parallel training")
    group = mesh_group(mesh)
    device = rank_device(mesh.device_type)
    return progan_train_step(
        state, local_rows(real_images, group).to(device), local_rows(z, group).to(device),
        alpha, config, stage, lr, dtype=dtype, ema_beta=ema_beta, packed_fake=packed_fake,
        remat=remat, packed_d=packed_d, packed_g=packed_g,
        packed_train_mode=packed_train_mode, axis_names=group, r1_gamma=r1_gamma)
