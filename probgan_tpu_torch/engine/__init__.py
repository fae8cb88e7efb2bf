"""Task engines behind the public API: image generation and KG inference."""

from probgan_tpu_torch.engine.image import (
    ImageGANEngine,
    generate_fn,
    latent_walk_fn,
    score_fn,
)
from probgan_tpu_torch.engine.inference import InferenceEngine

__all__ = ["ImageGANEngine", "InferenceEngine", "generate_fn", "latent_walk_fn",
           "score_fn"]
