"""A seeded C17 checkpoint with random weights, for demos, smoke runs and
profiles (no trained KG checkpoint ships with the repository):

    python -m probgan_tpu_torch.utils.demo_checkpoint OUT.pt [--entities N]
        [--relations R] [--embed_dim D] [--noise_dim Z] [--hidden_dim H]
        [--seed S]

The file is written with ``core/checkpoint.save_checkpoint`` (torch ``.pt``
when the path ends in .pt, else native msgpack) and loads in both packages.
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from probgan_tpu_torch.core.checkpoint import save_checkpoint


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="output file (.pt: torch format, else msgpack)")
    ap.add_argument("--entities", type=int, default=5000)
    ap.add_argument("--relations", type=int, default=37)
    ap.add_argument("--embed_dim", type=int, default=128)
    ap.add_argument("--noise_dim", type=int, default=64)
    ap.add_argument("--hidden_dim", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    save_checkpoint(args.path, make_kg_checkpoint(
        args.entities, args.relations, args.embed_dim, args.noise_dim,
        args.hidden_dim, args.seed))
    print(f"Checkpoint saved to: {args.path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
