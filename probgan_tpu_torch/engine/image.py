"""Image-synthesis engine: batched latent -> uint8 image generation.

The port of ``probgan_tpu/engine/image.py``'s generation surface. The
late-stage kernels run whenever the tensors are on CUDA: the engine always
takes the packed path, whose wrappers launch the CUDA kernels for CUDA
tensors and use their plain twins for CPU tensors; nothing switches them off
on the card. There is no mesh (one card).
"""

from __future__ import annotations

import numpy as np
import torch

from probgan_tpu_torch.core.device import resolve_device
from probgan_tpu_torch.core.rng import RngStream
from probgan_tpu_torch.models import pro_gan
from probgan_tpu_torch.utils.profiling import task_trace


def generate_fn(g_params: dict, z: torch.Tensor, alpha,
                config: pro_gan.ProGANConfig, stage: int,
                precision="high") -> torch.Tensor:
    """Latent [B, L] -> uint8 images [B, R, R, 3], on z's device, through
    the packed path: the eligible late stages run on ops/packed.py, where
    the tanh->uint8 denorm is fused into the final kernel. ``precision``:
    "high" (the serving default) or "highest", both fp32 with TF32 off."""
    with torch.inference_mode():
        return pro_gan.generator_apply(g_params, z, config, stage, alpha,
                                       precision, packed=True)


def to_device(tree, device: torch.device):
    """A copy of a param tree (dicts, lists, arrays or tensors) as fp32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_device(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


class ImageGANEngine:
    """Stateful wrapper: owns the generator params, an RNG stream and the
    device."""

    def __init__(self, config: pro_gan.ProGANConfig, g_params: dict | None = None,
                 device: str = "auto", seed: int = 0, precision: str = "high"):
        """``device``: "auto"/"cuda"/"gpu" (the first card; raise without
        one) or "cpu" (plain twins). ``precision``: "high" (default) or
        "highest"; the bf16 grades raise NotImplementedError.
        ``g_params``: the port's param tree (see core/convert.py for JAX
        trees); None initializes from ``seed``."""
        pro_gan._require_fp32_grade(precision)
        self.config = config
        self.device = resolve_device(device)
        self.precision = precision
        self._rng = RngStream(seed)
        if g_params is None:
            g_params = pro_gan.init_generator(
                config, self._rng.next_generator("init_generator")
            )
        self.g_params = to_device(g_params, self.device)

    @property
    def final_stage(self) -> int:
        return self.config.num_stages - 1

    def sample_latents(self, n: int) -> torch.Tensor:
        gen = self._rng.next_generator("sample_latents")
        z = torch.randn((n, self.config.latent_dim), generator=gen)
        return z.to(self.device)

    def generate(self, latents, stage: int | None = None,
                 alpha: float = 1.0) -> np.ndarray:
        """Latents [B, L] (numpy or tensor) -> uint8 images [B, R, R, 3]."""
        if stage is None:
            stage = self.final_stage
        z = torch.as_tensor(latents, dtype=torch.float32).to(self.device)
        with task_trace("generate_images"):
            img = generate_fn(self.g_params, z, alpha, self.config, stage,
                              self.precision)
            return img.cpu().numpy()
