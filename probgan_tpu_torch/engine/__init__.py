"""Task engines behind the public API: image generation."""

from probgan_tpu_torch.engine.image import ImageGANEngine, generate_fn

__all__ = ["ImageGANEngine", "generate_fn"]
