"""Data-parallel progressive-GAN training over a process mesh.

The counterpart of the image half of ``probgan_tpu/parallel/dp_train.py``.
The train state is replicated, the global batch is split over every rank of
the mesh (``mesh_group``), and each rank runs the whole step body on its rows
on its own device, the packed kernels with their autograd Functions
included. Inside the step (``engine/train.py:progan_train_step``'s
``axis_names``) the discriminator's minibatch-stddev statistics are taken
over the whole batch and the gradients are averaged over the ranks, one
all-reduce of one flat buffer a network. With equal shares that is the
one-device step on the whole batch up to the order of float sums, so every
rank takes the same Adam update, the state stays replicated with no
broadcast, and checkpoints pass between one-device and mesh training.

The KG half (``shard_kg_state``, ``kg_batch_sharding``: the entity table
and its Adam moments row-sharded) is not ported yet (ROADMAP A2.3).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from probgan_tpu_torch.engine.train import ProGANTrainState, progan_train_step
from probgan_tpu_torch.models.pro_gan import ProGANConfig
from probgan_tpu_torch.parallel.mesh import mesh_group, rank_device
from probgan_tpu_torch.parallel.sharded_image import (
    broadcast_tree,
    local_rows,
    require_divisible,
)


def replicate_state(mesh: DeviceMesh, state: ProGANTrainState) -> ProGANTrainState:
    """The whole train state on this rank's device, with the mesh's first
    rank's bits on every rank (Adam's step counts stay on the CPU, as
    ``adam_init`` keeps them). Run at the start of training and after a
    resume's load; the step keeps the replicas equal."""
    state = broadcast_tree(state, mesh_group(mesh), rank_device(mesh.device_type))

    def count_on_cpu(opt):
        return (opt[0]._replace(count=opt[0].count.cpu()), *opt[1:])

    return state._replace(g_opt=count_on_cpu(state.g_opt), d_opt=count_on_cpu(state.d_opt))


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
