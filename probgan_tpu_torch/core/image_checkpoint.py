"""Checkpoint schema for the image-GAN model family.

The port of ``probgan_tpu/core/image_checkpoint.py``: a flat dict, msgpack on
disk (``core/checkpoint.py`` over ``core/_msgpack.py``).

    {
      'image_config': {'resolution', 'latent_dim', 'fmap_base', 'fmap_max',
                       'num_channels'},
      'image_generator': <generator params tree>,
      'image_generator_ema': <EMA generator params tree> (optional),
      'image_discriminator': <discriminator params tree, or {}>,
      'training_history': dict (optional),
    }

On disk the trees are in the JAX package's layout (conv weights HWIO), so a
file written by either package loads in the other. In memory the port's trees
are OIHW tensors: ``save_image_checkpoint`` takes the port's trees and
converts them back, the loaders convert at load (``core/convert.py``) and
return fp32 tensors on the CPU.

'image_generator_ema' carries a trainer's exponential moving average of the
generator; loaders prefer it for sample generation when present.
'image_generator' always holds the raw adversarial iterate (the resumable,
trainable weights).
"""

from __future__ import annotations

import dataclasses

from probgan_tpu_torch.core.checkpoint import load_checkpoint, save_checkpoint
from probgan_tpu_torch.core.convert import (
    convert_discriminator_params,
    convert_generator_params,
    discriminator_params_to_jax,
    generator_params_to_jax,
)
from probgan_tpu_torch.models.pro_gan import ProGANConfig

IMAGE_KEYS = ("image_config", "image_generator", "image_discriminator")


def is_image_checkpoint(ckpt: dict) -> bool:
    return "image_generator" in ckpt


def save_image_checkpoint(
    path: str,
    config: ProGANConfig,
    g_params: dict,
    d_params: dict | None = None,
    training_history: dict | None = None,
    g_ema: dict | None = None,
) -> None:
    """Write the port's trees (OIHW) as a native msgpack file in the JAX
    layout. ``d_params`` None or {} stores an empty discriminator."""
    ckpt = {
        "image_config": dataclasses.asdict(config),
        "image_generator": generator_params_to_jax(g_params),
        "image_discriminator": discriminator_params_to_jax(d_params) if d_params else {},
        "training_history": training_history or {},
    }
    if g_ema is not None:
        ckpt["image_generator_ema"] = generator_params_to_jax(g_ema)
    save_checkpoint(path, ckpt, format="native")


def _load(path: str) -> tuple[ProGANConfig, dict]:
    ckpt = load_checkpoint(path)
    if not is_image_checkpoint(ckpt):
        raise ValueError(
            f"Not an image-GAN checkpoint (missing 'image_generator'): {path}"
        )
    # the config's values come back as numpy scalars
    cfg = ProGANConfig(**{k: int(v) for k, v in ckpt["image_config"].items()})
    return cfg, ckpt


def _discriminator(ckpt: dict) -> dict:
    d = ckpt["image_discriminator"]
    return convert_discriminator_params(d) if d else {}


def load_image_checkpoint(
    path: str, prefer_ema: bool = True
) -> tuple[ProGANConfig, dict, dict]:
    """Returns (config, g_params, d_params) in the port's layout; d_params is
    {} when the file stores no discriminator. With ``prefer_ema`` (the
    default), g_params is the checkpoint's EMA generator when one is stored;
    pass False for the raw adversarial iterate. SERVING loader: anything that
    fine-tunes or resumes must not train from the EMA tree; use
    ``load_image_checkpoint_trees`` to get both trees by name."""
    cfg, ckpt = _load(path)
    g_key = (
        "image_generator_ema"
        if prefer_ema and "image_generator_ema" in ckpt
        else "image_generator"
    )
    return cfg, convert_generator_params(ckpt[g_key]), _discriminator(ckpt)


def load_image_checkpoint_trees(
    path: str,
) -> tuple[ProGANConfig, dict, dict | None, dict]:
    """Unambiguous loader: (config, g_raw, g_ema_or_None, d_params).
    ``g_raw`` is always the trainable adversarial iterate
    ('image_generator'); ``g_ema`` is the stored EMA tree or None."""
    cfg, ckpt = _load(path)
    ema = ckpt.get("image_generator_ema")
    return (
        cfg,
        convert_generator_params(ckpt["image_generator"]),
        convert_generator_params(ema) if ema is not None else None,
        _discriminator(ckpt),
    )
