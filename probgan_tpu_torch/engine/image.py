"""Image-synthesis engine: batched latent -> uint8 image generation,
discriminator scoring and latent-space walks.

The port of ``probgan_tpu/engine/image.py``. On the card the engine takes
the packed paths of G and D, whose late stages run on the CUDA kernels of
ops/packed.py, unless ``PROBGAN_PACKED=0`` (``packed_default``, the JAX
package's escape hatch); on the CPU it takes the unpacked paths, as the JAX
engine does off the TPU. ``PROBGAN_STAGE_FUSED=1`` runs each packed generator
stage as one kernel (models/pro_gan.py ``_g_late_packed``). On the packed
path the final tanh -> uint8 denorm is fused into the generator's last kernel
by default; ``use_pallas=True`` (or ``PROBGAN_PALLAS_UINT8=1``, the JAX
package's names for the switch) renders fp32 RGB instead and runs the
separate denorm kernel of ops/image.py over it. With a mesh (a launched
world of processes, ``parallel/mesh.py``) each rank serves from its own device
and ``generate``, ``score`` and ``latent_walk`` split their batch over the
ranks (``parallel/sharded_image.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from probgan_tpu_torch.core.device import resolve_device
from probgan_tpu_torch.core.rng import RngStream
from probgan_tpu_torch.models import pro_gan
from probgan_tpu_torch.ops import image as image_ops
from probgan_tpu_torch.parallel.mesh import rank_device, resolve_mesh
from probgan_tpu_torch.utils.profiling import task_trace

WALK_CHUNK = 8  # frames rendered per generator batch in a latent walk


def packed_default(device) -> bool:
    """Default of the packed late-stage path: on for a CUDA device unless
    ``PROBGAN_PACKED=0`` (the escape hatch), read at each call. The JAX
    package's gate is the same with the TPU in the card's place."""
    return (torch.device(device).type == "cuda"
            and os.environ.get("PROBGAN_PACKED", "1") != "0")


def generate_fn(g_params: dict, z: torch.Tensor, alpha,
                config: pro_gan.ProGANConfig, stage: int, dtype=torch.float32,
                use_pallas: bool = False, precision=None,
                packed: bool | None = None) -> torch.Tensor:
    """Latent [B, L] -> uint8 images [B, R, R, 3], on z's device. With
    ``packed`` (None: ``packed_default`` of z's device) the eligible late
    stages run on ops/packed.py, where the tanh->uint8 denorm is fused into
    the final kernel; fp32 ``dtype`` only (bf16 runs unpacked). With
    ``use_pallas`` the generator emits fp32 RGB and ``to_uint8_fused``
    (ops/image.py) denormalizes it in a pass of its own. ``precision``: the
    grade (models/pro_gan.py ``_PRECISIONS``): None/"default" (TF32 convs,
    the packed stages in one bf16 pass), "fast" (fp32 convs, the packed stages
    in one bf16 pass: the serving grade above the 50 dB bar), "high" and
    "highest" (fp32 throughout)."""
    if packed is None:
        packed = packed_default(z.device)
    with torch.inference_mode():
        if use_pallas:
            rgb = pro_gan.generator_rgb(g_params, z, config, stage, alpha, dtype,
                                        precision, packed=packed)
            return image_ops.to_uint8_fused(rgb.float())
        return pro_gan.generator_apply(g_params, z, config, stage, alpha, dtype,
                                       precision, packed=packed)


def score_fn(d_params: dict, images: torch.Tensor, alpha,
             config: pro_gan.ProGANConfig, stage: int, dtype=torch.float32,
             precision=None, packed: bool | None = None) -> torch.Tensor:
    """Float images [B, R, R, 3] (~[-1, 1]) -> realness logits [B] in
    ``dtype``, on the images' device; with ``packed`` (None:
    ``packed_default`` of that device) the leading discriminator stages run
    on ops/packed.py at "high" and "highest" (the fp32 kernels) and "fast"
    (kernel mode "mid", the 2-term bf16 split); the gate declines None and
    "default"."""
    if packed is None:
        packed = packed_default(images.device)
    with torch.inference_mode():
        return pro_gan.discriminator_apply(d_params, images, config, stage,
                                           alpha, dtype, precision, packed=packed)


def latent_walk_fn(g_params: dict, z0: torch.Tensor, z1: torch.Tensor, alpha,
                   config: pro_gan.ProGANConfig, stage: int, frames: int,
                   dtype=torch.float32, use_pallas: bool = False, precision=None,
                   chunk: int = WALK_CHUNK, packed: bool | None = None) -> torch.Tensor:
    """Interpolate z0 -> z1 (each [L]) linearly in ``frames`` steps and
    render each: uint8 [frames, R, R, 3]. Frames render in generator batches
    of ``chunk``, which bounds peak memory at the chunk's; the last chunk is
    zero-padded to full size and cut, so every batch has one shape."""
    t = torch.linspace(0.0, 1.0, frames, dtype=z0.dtype, device=z0.device)[:, None]
    z = z0[None, :] * (1.0 - t) + z1[None, :] * t

    def render(zc):
        return generate_fn(g_params, zc, alpha, config, stage, dtype, use_pallas,
                           precision, packed)

    if frames <= chunk:
        return render(z)
    pad = (-frames) % chunk
    z = torch.nn.functional.pad(z, (0, 0, 0, pad))
    return torch.cat([render(zc) for zc in z.split(chunk)])[:frames]


def to_device(tree, device: torch.device):
    """A copy of a param tree (dicts, lists, arrays or tensors) as fp32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


class ImageGANEngine:
    """Stateful wrapper: owns the generator and discriminator params, an RNG
    stream and the device."""

    def __init__(self, config: pro_gan.ProGANConfig, g_params: dict | None = None,
                 d_params: dict | None = None, device: str = "auto", seed: int = 0,
                 dtype=torch.float32, use_pallas: bool | None = None, mesh=None,
                 precision: str | None = "high"):
        """``device``: "auto"/"cuda"/"gpu" (the first card; raise without
        one) or "cpu" (plain twins). ``precision``: the serving grade, "high"
        (default), "highest", "fast", or None/"default" (see ``generate_fn``).
        ``dtype``: float32, or bfloat16 for the unpacked path in bf16 (the
        packed paths take fp32 only, so with bf16 the engine is unpacked).
        ``g_params`` / ``d_params``: the port's param trees (see
        core/convert.py for JAX trees); None initializes from ``seed``.
        ``use_pallas``: run the separate denorm kernel instead of the fused
        uint8 epilogue; None reads ``PROBGAN_PALLAS_UINT8`` ("1" = on).
        ``mesh``: None, "" or 1 for the one device; "auto" for the whole
        launched world, a device count, or a prebuilt DeviceMesh
        (``parallel/mesh.py``; a mesh that cannot be had raises). With a mesh
        each rank serves from its own device (card ``local_rank %
        device_count``), the params replicated from the mesh's first rank,
        and ``generate``, ``score`` and ``latent_walk`` split their batch
        over the ranks (``parallel/sharded_image.py``); every rank returns
        the whole result. ``use_pallas`` does not apply there, as in the JAX
        package."""
        pro_gan.resolve_precision(precision)  # an unknown grade raises here
        self.config = config
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(mesh, device_type=self.device.type)
        if self.mesh is not None:
            self.device = rank_device(self.device.type)
        self.dtype = dtype
        self.precision = precision
        if use_pallas is None:
            use_pallas = os.environ.get("PROBGAN_PALLAS_UINT8", "0") == "1"
        self.use_pallas = bool(use_pallas)
        # the packed paths on the card unless PROBGAN_PACKED=0, at construction
        self.packed = packed_default(self.device) and dtype == torch.float32
        self._rng = RngStream(seed)
        if g_params is None:
            g_params = pro_gan.init_generator(
                config, self._rng.next_generator("init_generator")
            )
        if d_params is None:
            d_params = pro_gan.init_discriminator(
                config, self._rng.next_generator("init_discriminator")
            )
        if self.mesh is not None:
            # replicated ONCE: every call then uses the rank's own copy
            from probgan_tpu_torch.parallel.sharded_image import replicate_params

            self.g_params = replicate_params(self.mesh, g_params)
            self.d_params = replicate_params(self.mesh, d_params)
        else:
            self.g_params = to_device(g_params, self.device)
            self.d_params = to_device(d_params, self.device)

    @property
    def final_stage(self) -> int:
        return self.config.num_stages - 1

    def sample_latents(self, n: int) -> torch.Tensor:
        gen = self._rng.next_generator("sample_latents")
        z = torch.randn((n, self.config.latent_dim), generator=gen)
        return z.to(self.device)

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def generate(self, latents, stage: int | None = None,
                 alpha: float = 1.0) -> np.ndarray:
        """Latents [B, L] (numpy or tensor) -> uint8 images [B, R, R, 3]."""
        if stage is None:
            stage = self.final_stage
        z = self._place(latents)
        if self.mesh is not None:
            with task_trace("generate_images"):
                return self._dp_generate(z, stage, alpha)
        with task_trace("generate_images"):
            img = generate_fn(self.g_params, z, alpha, self.config, stage, self.dtype,
                              self.use_pallas, self.precision, self.packed)
            return img.cpu().numpy()

    def score(self, images, stage: int | None = None,
              alpha: float = 1.0) -> np.ndarray:
        """Float images [B, R, R, 3] (~[-1, 1], numpy or tensor) at the
        stage's resolution -> realness logits [B]. The minibatch stddev makes
        the logits a function of the whole batch."""
        if stage is None:
            stage = self.final_stage
        if self.mesh is not None and len(images) % self.mesh.size() == 0:
            from probgan_tpu_torch.parallel.sharded_image import dp_score

            with task_trace("score_images"):
                # dp_score moves only this rank's rows to its device
                logits = dp_score(self.mesh, self.d_params,
                                  torch.as_tensor(images, dtype=torch.float32), self.config,
                                  stage, alpha, self.dtype, self.precision, packed=self.packed)
                return logits.float().cpu().numpy()
        # one device, or a batch that does not divide the mesh (minibatch
        # stddev forbids padding): every rank scores the whole batch
        x = self._place(images)
        with task_trace("score_images"):
            logits = score_fn(self.d_params, x, alpha, self.config, stage, self.dtype,
                              self.precision, self.packed)
            return logits.float().cpu().numpy()

    def latent_walk(self, z0, z1, frames: int = 64, stage: int | None = None,
                    alpha: float = 1.0) -> np.ndarray:
        """Latents z0, z1 [L] -> uint8 frames [frames, R, R, 3] of the linear
        walk between them, rendered 8 at a time."""
        if stage is None:
            stage = self.final_stage
        z0, z1 = self._place(z0), self._place(z1)
        if self.mesh is not None:
            # latent_walk_fn's latents, bit for bit, rendered over the ranks
            t = torch.linspace(0.0, 1.0, frames, dtype=z0.dtype, device=z0.device)[:, None]
            z = z0[None, :] * (1.0 - t) + z1[None, :] * t
            with task_trace("latent_walk"):
                return self._dp_generate(z, stage, alpha)
        with task_trace("latent_walk"):
            img = latent_walk_fn(self.g_params, z0, z1, alpha, self.config, stage,
                                 frames, self.dtype, self.use_pallas, self.precision,
                                 packed=self.packed)
            return img.cpu().numpy()

    def _dp_generate(self, z: torch.Tensor, stage: int, alpha: float) -> np.ndarray:
        """``dp_generate`` of ``z`` zero-padded to a multiple of the mesh
        size, the padding's images cut."""
        from probgan_tpu_torch.parallel.sharded_image import dp_generate

        n = z.shape[0]
        z = torch.nn.functional.pad(z, (0, 0, 0, (-n) % self.mesh.size()))
        img = dp_generate(self.mesh, self.g_params, z, self.config, stage, alpha, self.dtype,
                          self.precision, packed=self.packed)
        return img[:n].cpu().numpy()
