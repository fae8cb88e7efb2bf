"""Knowledge-graph GAN: the generator and discriminator MLPs.

The port of ``probgan_tpu/models/kg_gan.py``, as plain functions over a
params dict of fp32 tensors ``{'fc1': {'w' [in, out], 'b' [out]}, ...}``
(dense weights stay ``[in, out]``: ``x @ w + b``).

Generator:     concat[h, r, z] -> Dense(2D) -> LeakyReLU(0.2)
                               -> Dense(2D) -> LeakyReLU(0.2) -> Dense(D).
Discriminator: concat[h, r, t] -> Dense(H) -> LeakyReLU(0.2)
                               -> Dense(H) -> LeakyReLU(0.2) -> Dense(1).

The products run in full fp32 (TF32 off), as the engine's rankings and the
tests against the JAX package expect.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from probgan_tpu_torch.ops.rank import full_fp32_matmul

LRELU_SLOPE = 0.2


def _dense_init(gen: torch.Generator, fan_in: int, fan_out: int) -> dict:
    """He-normal init for LeakyReLU MLPs; weight stored ``[fan_in, fan_out]``."""
    w = torch.randn((fan_in, fan_out), generator=gen) * math.sqrt(2.0 / fan_in)
    return {"w": w, "b": torch.zeros(fan_out)}


def _dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.addmm(params["b"], x, params["w"])


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def _mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    with full_fp32_matmul():
        x = _lrelu(_dense(params["fc1"], x))
        x = _lrelu(_dense(params["fc2"], x))
        return _dense(params["fc3"], x)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def init_generator(gen: torch.Generator, embed_dim: int = 128,
                   noise_dim: int = 64) -> dict:
    """Fresh generator params on the CPU, drawn from ``gen``."""
    d, z = embed_dim, noise_dim
    return {
        "fc1": _dense_init(gen, 2 * d + z, 2 * d),
        "fc2": _dense_init(gen, 2 * d, 2 * d),
        "fc3": _dense_init(gen, 2 * d, d),
    }


def generator_apply(params: dict, h_emb: torch.Tensor, r_emb: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """(h_emb [B,D], r_emb [B,D], z [B,Z]) -> predicted tail embedding [B,D]."""
    return _mlp(params, torch.cat([h_emb, r_emb, z], dim=-1))


def generator_dims(params: dict) -> tuple[int, int]:
    """Recover (embed_dim, noise_dim) from a params dict."""
    embed_dim = params["fc3"]["w"].shape[1]
    noise_dim = params["fc1"]["w"].shape[0] - 2 * embed_dim
    return embed_dim, noise_dim


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def init_discriminator(gen: torch.Generator, embed_dim: int = 128,
                       hidden_dim: int = 1024) -> dict:
    """Fresh discriminator params on the CPU, drawn from ``gen``."""
    d, hdim = embed_dim, hidden_dim
    return {
        "fc1": _dense_init(gen, 3 * d, hdim),
        "fc2": _dense_init(gen, hdim, hdim),
        "fc3": _dense_init(gen, hdim, 1),
    }


def discriminator_apply(params: dict, h_emb: torch.Tensor, r_emb: torch.Tensor,
                        t_emb: torch.Tensor) -> torch.Tensor:
    """(h, r, t embeddings [B,D] each) -> realness logit [B]."""
    return _mlp(params, torch.cat([h_emb, r_emb, t_emb], dim=-1))[..., 0]


def discriminator_score_triplets(params: dict, node_emb: torch.Tensor,
                                 rel_emb: torch.Tensor,
                                 triplets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The model-owned scoring path: gathers from the raw tables, then
    sigmoid. node_emb [N, D], rel_emb [R, D], triplets [B, 3] int ids
    (h, r, t) -> (logits [B], probs [B])."""
    h = node_emb[triplets[:, 0]]
    r = rel_emb[triplets[:, 1]]
    t = node_emb[triplets[:, 2]]
    logits = discriminator_apply(params, h, r, t)
    return logits, torch.sigmoid(logits)


def discriminator_dims(params: dict) -> tuple[int, int]:
    """Recover (embed_dim, hidden_dim) from a params dict."""
    hidden_dim = params["fc1"]["w"].shape[1]
    embed_dim = params["fc1"]["w"].shape[0] // 3
    return embed_dim, hidden_dim
