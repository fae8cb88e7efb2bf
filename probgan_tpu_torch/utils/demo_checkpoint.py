"""Seeded checkpoints with random weights, for demos, smoke runs and
profiles (no trained checkpoint ships with the repository).

A C17 knowledge-graph checkpoint:

    python -m probgan_tpu_torch.utils.demo_checkpoint OUT.pt [--entities N]
        [--relations R] [--embed_dim D] [--noise_dim Z] [--hidden_dim H]
        [--seed S]

written with ``core/checkpoint.save_checkpoint`` (torch ``.pt`` when the path
ends in .pt, else native msgpack). An image-GAN checkpoint (config, G, D
and, with ``--ema``, an EMA generator), for ``--task generate_images``:

    python -m probgan_tpu_torch.utils.demo_checkpoint OUT.msgpack --image
        [--resolution R] [--latent_dim L] [--fmap_base F] [--fmap_max M]
        [--ema] [--seed S]

written with ``core/image_checkpoint.save_image_checkpoint`` (native msgpack).
Both kinds load in both packages.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from probgan_tpu_torch.core.checkpoint import save_checkpoint
from probgan_tpu_torch.core.image_checkpoint import save_image_checkpoint
from probgan_tpu_torch.models import pro_gan


def make_kg_checkpoint(num_entities: int = 5000, num_relations: int = 37,
                       embed_dim: int = 128, noise_dim: int = 64,
                       hidden_dim: int = 1024, seed: int = 0) -> dict:
    """The checkpoint dict, from ``numpy.random.default_rng(seed)``:
    standard-normal embedding tables, He-normal MLP weights, small biases."""
    rng = np.random.default_rng(seed)

    def dense(fan_in: int, fan_out: int) -> dict:
        w = rng.standard_normal((fan_in, fan_out), dtype=np.float32)
        return {"w": w * np.float32(math.sqrt(2.0 / fan_in)),
                "b": np.float32(0.01) * rng.standard_normal(fan_out, dtype=np.float32)}

    d, z, h = embed_dim, noise_dim, hidden_dim
    return {
        "args": {"embed_dim": d, "noise_dim": z, "hidden_dim": h},
        "node_emb": rng.standard_normal((num_entities, d), dtype=np.float32),
        "rel_emb": {"weight": rng.standard_normal((num_relations, d), dtype=np.float32)},
        "generator": {"fc1": dense(2 * d + z, 2 * d), "fc2": dense(2 * d, 2 * d),
                      "fc3": dense(2 * d, d)},
        "discriminator": {"fc1": dense(3 * d, h), "fc2": dense(h, h), "fc3": dense(h, 1)},
        "best_val_hit10": 0.7312, "best_epoch": 42, "training_history": {},
    }


def make_image_checkpoint(config: pro_gan.ProGANConfig, seed: int = 0,
                          ema: bool = False) -> dict:
    """``save_image_checkpoint``'s tree arguments (``g_params``, ``d_params``
    and, with ``ema``, ``g_ema``: another draw, so that the two generators
    render different images) for ``config``, ~N(0, 1) weights from
    ``torch.Generator().manual_seed(seed)``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    trees = {"g_params": pro_gan.init_generator(config, gen),
             "d_params": pro_gan.init_discriminator(config, gen)}
    if ema:
        trees["g_ema"] = pro_gan.init_generator(config, gen)
    return trees


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="output file (.pt: torch format, else msgpack)")
    ap.add_argument("--entities", type=int, default=5000)
    ap.add_argument("--relations", type=int, default=37)
    ap.add_argument("--embed_dim", type=int, default=128)
    ap.add_argument("--noise_dim", type=int, default=64)
    ap.add_argument("--hidden_dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image", action="store_true",
                    help="write an image-GAN checkpoint instead (msgpack)")
    ap.add_argument("--resolution", type=int, default=1024)
    ap.add_argument("--latent_dim", type=int, default=512)
    ap.add_argument("--fmap_base", type=int, default=8192)
    ap.add_argument("--fmap_max", type=int, default=512)
    ap.add_argument("--ema", action="store_true",
                    help="--image: also store an EMA generator")
    args = ap.parse_args(argv)
    if args.image:
        config = pro_gan.ProGANConfig(args.resolution, args.latent_dim,
                                      args.fmap_base, args.fmap_max)
        save_image_checkpoint(args.path, config,
                              **make_image_checkpoint(config, args.seed, args.ema))
        print(f"Checkpoint saved to: {args.path}")
        return 0
    save_checkpoint(args.path, make_kg_checkpoint(
        args.entities, args.relations, args.embed_dim, args.noise_dim,
        args.hidden_dim, args.seed))
    print(f"Checkpoint saved to: {args.path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
