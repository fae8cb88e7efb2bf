"""Process meshes for the parallel paths.

The counterpart of ``probgan_tpu/parallel/mesh.py``. The axes keep their
names:

- ``data``: batch data parallelism (queries, latents, images);
- ``model``: tensor parallelism: the entity table ``[N, D]`` is sharded
  over rows, so the ranking product's N axis splits across devices.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the launched
world: one process a device, started by a launcher such as

    torchrun --nproc-per-node N -m probgan_tpu_torch.cli.infer ... --mesh auto

Where no process group is up yet, the first mesh starts the default group
from the launcher's environment (``env://``): NCCL for CUDA devices, gloo
for the CPU, or the backend named by ``PROBGAN_DIST_BACKEND``. NCCL takes
one card a rank; more ranks than cards need ``PROBGAN_DIST_BACKEND=gloo``.
On CUDA each rank uses card ``local_rank % device_count``.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "model")


def launched_world_size() -> int:
    """The number of processes launched together: the default process
    group's size, else the launcher's ``WORLD_SIZE``, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_rank() -> int:
    """This process's rank in the launched world (0 when none was launched)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", world_rank()))


def _start_world(device_type: str) -> None:
    """Start the default process group from the launcher's environment if
    none is up yet."""
    if dist.is_initialized():
        return
    if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise ValueError(
            "no process group is launched: start one process a device with "
            "`torchrun --nproc-per-node N ...`, or call "
            "torch.distributed.init_process_group first")
    backend = os.environ.get("PROBGAN_DIST_BACKEND") or (
        "nccl" if device_type == "cuda" else "gloo")
    if (backend == "nccl" and device_type == "cuda"
            and launched_world_size() > torch.cuda.device_count()):
        raise ValueError(
            f"NCCL takes one card a rank: {launched_world_size()} ranks on "
            f"{torch.cuda.device_count()} card(s); set PROBGAN_DIST_BACKEND=gloo "
            "to share a card")
    dist.init_process_group(backend, init_method="env://")


def rank_device(device_type: str) -> torch.device:
    """This rank's device: card ``local_rank % device_count`` on CUDA."""
    if device_type == "cuda":
        return torch.device("cuda", _local_rank() % torch.cuda.device_count())
    return torch.device(device_type)


@functools.lru_cache(maxsize=None)
def mesh_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    """The process group over all of ``mesh``'s ranks, whatever its axes:
    the counterpart of the JAX package's tuple of every mesh axis, over
    which the data-parallel paths split a batch. Made once a mesh. A mesh
    over the whole launched world (every mesh ``make_mesh`` builds) gets the
    default group itself, so no group is created; another gets
    ``dist.new_group`` of its ranks in row-major order, which every rank of
    the default group must call together."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of devices along mesh axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def default_model_parallelism(n_devices: int) -> int:
    """The largest power of two <= sqrt(2 n) that divides n: the JAX
    package's balanced split for the rank product."""
    model_parallelism = 1
    while (
        model_parallelism * 2 <= n_devices
        and n_devices % (model_parallelism * 2) == 0
        and (model_parallelism * 2) ** 2 <= n_devices * 2
    ):
        model_parallelism *= 2
    return model_parallelism


def make_mesh(
    n_devices: int | None = None,
    model_parallelism: int | None = None,
    axis_names: tuple[str, str] = AXES,
    device_type: str = "cuda",
) -> DeviceMesh:
    """Build a (data, model) mesh over the launched world, one process a
    device. ``model_parallelism`` defaults to the largest power of two
    <= sqrt(2 n) that divides n; pass 1 for pure DP or n for pure TP.
    ``n_devices`` must equal the launched world's size. ``device_type`` is
    "cuda" (each rank on card ``local_rank % device_count``) unless the
    caller asks for "cpu"."""
    world = launched_world_size()
    if n_devices is None:
        n_devices = world
    if model_parallelism is None:
        model_parallelism = default_model_parallelism(n_devices)
    if n_devices % model_parallelism != 0:
        raise ValueError(
            f"model_parallelism={model_parallelism} must divide n_devices={n_devices}"
        )
    if n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes, one a device; "
            f"{world} launched: start them with `torchrun --nproc-per-node {n_devices} ...`"
        )
    _start_world(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    return init_device_mesh(device_type, (n_devices // model_parallelism, model_parallelism),
                            mesh_dim_names=tuple(axis_names))


def resolve_mesh(spec, device_type: str = "cuda") -> DeviceMesh | None:
    """User-facing mesh spec -> DeviceMesh or None (one device).

    Accepts None/""/"1"/1 (off), "auto" (the whole launched world), a device
    count (an int or a numeric string), or a prebuilt DeviceMesh. A mesh of
    one device collapses to None, so callers keep the one-device path. A
    count above 1 that no launched world of that size can give raises: there
    is no fallback to one device."""
    if isinstance(spec, DeviceMesh):
        if spec.size() <= 1:
            # a one-device mesh is "no mesh" whatever its dim names: the
            # names matter only where a mesh path will run
            return None
        if tuple(spec.mesh_dim_names or ()) != AXES:
            raise ValueError(
                "prebuilt DeviceMesh must have axis names ('data', 'model'); got "
                f"{spec.mesh_dim_names} — build one with make_mesh(n) or pass a "
                "device count"
            )
        return spec
    if spec in (None, "", "1", 1):
        return None
    if spec == "auto":
        world = launched_world_size()
        return make_mesh(world, device_type=device_type) if world > 1 else None
    n = int(spec)
    return make_mesh(n, device_type=device_type) if n > 1 else None
