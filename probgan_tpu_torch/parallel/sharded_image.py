"""Data-parallel image generation and scoring over a process mesh.

The counterpart of ``probgan_tpu/parallel/sharded_image.py``. The batch is
split over every rank of the mesh, whatever its axes (``mesh_group``), each
rank holding a contiguous block of rows in rank order; the parameters are
replicated. Each rank runs the one-device forward on its own device
(``rank_device``: card ``local_rank % device_count``), the packed late
stages on the kernels of ops/packed.py on the card, and the rows are
gathered back, so every rank returns the whole batch.

The generator's forward is embarrassingly parallel: its only collectives are
the latents' broadcast and the images' gather. The discriminator's
minibatch-stddev channel is a statistic of the whole batch, so ``dp_score``
takes it over the ranks (``models/pro_gan.py:minibatch_stddev``): the
one-device logits up to the order of float sums. The batch must be a
multiple of the mesh size, and each check that can refuse a call runs before
its first collective, so that a rank that raises leaves no other waiting.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from probgan_tpu_torch.core.tree import tree_leaves, tree_unflatten
from probgan_tpu_torch.engine.image import generate_fn, to_device
from probgan_tpu_torch.models import pro_gan
from probgan_tpu_torch.parallel.mesh import mesh_group, rank_device


def _first_rank(group) -> int:
    return dist.get_global_rank(group, 0)


def broadcast_tree(tree, group, device: torch.device):
    """A copy of ``tree`` on ``device`` with the bits of ``group``'s first
    rank on every rank: its tensor leaves in one flat buffer a dtype,
    broadcast once each."""
    leaves = tree_leaves(tree)
    out = list(leaves)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].detach().reshape(-1).to(device) for i in idx])
        dist.broadcast(flat, src=_first_rank(group), group=group)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return tree_unflatten(tree, out)


def replicate_params(mesh: DeviceMesh, params):
    """The param tree (dicts, lists, arrays or tensors) as fp32 tensors on
    this rank's device, with the mesh's first rank's bits on every rank. Run
    once (the engine keeps the result): a tree each rank built from the same
    seed is then the same bits everywhere, as JAX's one replicated tree is."""
    device = rank_device(mesh.device_type)
    return broadcast_tree(to_device(params, device), mesh_group(mesh), device)


def require_divisible(batch: int, mesh: DeviceMesh, why: str = "") -> None:
    """Raise ValueError unless ``batch`` splits evenly over the mesh; called
    before any collective, so that no other rank is left waiting."""
    if batch % mesh.size() != 0:
        raise ValueError(f"batch {batch} must be divisible by device count {mesh.size()}{why}")


def local_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s rows (ranks in order)."""
    n = x.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    return x[r * n:(r + 1) * n]


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def dp_score(mesh: DeviceMesh, d_params, images: torch.Tensor, config: pro_gan.ProGANConfig,
             stage: int, alpha: float = 1.0, dtype=torch.float32, precision=None,
             packed: bool = False) -> torch.Tensor:
    """Realness logits [B] of float images [B, R, R, 3] (the same batch on
    every rank), each rank scoring its rows with ``d_params`` replicated
    (``replicate_params``). The minibatch-stddev statistics are taken over
    the whole batch, so the logits are the one-device logits up to the order
    of float sums. B must be a multiple of the mesh size: padding would
    change the batch statistics."""
    require_divisible(images.shape[0], mesh, " (minibatch stddev forbids padding)")
    group = mesh_group(mesh)
    x = local_rows(images, group).to(rank_device(mesh.device_type), torch.float32)
    with torch.inference_mode():
        logits = pro_gan.discriminator_apply(d_params, x, config, stage, alpha, dtype,
                                             precision, packed=packed, stddev_axis=group)
    return gather_rows(logits, group)


def dp_generate(mesh: DeviceMesh, g_params, z: torch.Tensor, config: pro_gan.ProGANConfig,
                stage: int, alpha: float = 1.0, dtype=torch.float32, precision=None,
                packed: bool = False) -> torch.Tensor:
    """uint8 images [B, R, R, 3] of latents ``z`` [B, latent_dim], on every
    rank. Every rank takes the mesh's first rank's latents (a broadcast), so
    that every rank renders the same batch, and renders its rows through
    ``engine/image.py:generate_fn`` with ``g_params`` replicated; the rows
    are gathered in rank order. B must be a multiple of the mesh size."""
    require_divisible(z.shape[0], mesh)
    group = mesh_group(mesh)
    z = z.to(rank_device(mesh.device_type), torch.float32, copy=True).contiguous()
    dist.broadcast(z, src=_first_rank(group), group=group)
    img = generate_fn(g_params, local_rows(z, group), alpha, config, stage, dtype, False,
                      precision, packed)
    return gather_rows(img, group)
