"""``ModularGenerator`` / ``ModularDiscriminator`` as ``nn.Module``s.

The reference does ``from modular_prot_b_gan import ModularGenerator,
ModularDiscriminator`` and then ``load_state_dict`` / ``.to(device)`` /
``.eval()`` / forward. The port of ``probgan_tpu/models/modular.py``: here
the classes are real modules over ``nn.Linear`` (``fcN.weight [out, in]``),
so a reference ``.pt``'s ``generator`` / ``discriminator`` state dicts load
with ``load_state_dict(strict=True)``. They compute what the functions in
``models/kg_gan.py`` compute (the engine's path) on the transposed weights.

- ``gen(h_emb [B,D], r_emb [B,D]) -> t_emb [B,D]`` draws its noise from the
  module's own ``torch.Generator`` (seeded at construction, so a given call
  sequence is deterministic); pass ``z=`` to make the noise explicit.
- ``disc(h, r, t) -> logit [B]``, and ``disc.score_triplets(node_emb,
  rel_emb, triplets) -> (logits, probs)`` with its own gathers and sigmoid.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from probgan_tpu_torch.models.kg_gan import LRELU_SLOPE
from probgan_tpu_torch.ops.rank import full_fp32_matmul

__all__ = ["ModularGenerator", "ModularDiscriminator"]


class _MLP(nn.Module):
    """fc1 -> LeakyReLU(0.2) -> fc2 -> LeakyReLU(0.2) -> fc3, He-normal
    weights and zero biases drawn from ``gen``."""

    def __init__(self, dims: tuple[int, int, int, int], gen: torch.Generator):
        super().__init__()
        self.fc1 = nn.Linear(dims[0], dims[1])
        self.fc2 = nn.Linear(dims[1], dims[2])
        self.fc3 = nn.Linear(dims[2], dims[3])
        self.act = nn.LeakyReLU(LRELU_SLOPE)
        with torch.no_grad():
            for fc in (self.fc1, self.fc2, self.fc3):
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=gen)
                                * (2.0 / fc.in_features) ** 0.5)
                fc.bias.zero_()

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32_matmul():
            return self.fc3(self.act(self.fc2(self.act(self.fc1(x)))))


class ModularGenerator(_MLP):
    """``gen(h_emb, r_emb) -> t_emb`` with internally sampled noise."""

    def __init__(self, embed_dim: int = 128, noise_dim: int = 64, seed: int = 0):
        d, z = int(embed_dim), int(noise_dim)
        super().__init__((2 * d + z, 2 * d, 2 * d, d),
                         torch.Generator().manual_seed(int(seed) + 1))
        self.embed_dim, self.noise_dim = d, z
        # The noise is drawn on the CPU generator and moved to the inputs'
        # device, so its bits do not depend on where the module lives.
        self._noise_gen = torch.Generator().manual_seed(int(seed))

    def forward(self, h_emb: torch.Tensor, r_emb: torch.Tensor,
                z: torch.Tensor | None = None) -> torch.Tensor:
        if z is None:
            z = torch.randn((h_emb.shape[0], self.noise_dim),
                            generator=self._noise_gen).to(h_emb.device)
        return self._mlp(torch.cat([h_emb, r_emb, z], dim=-1))


class ModularDiscriminator(_MLP):
    """``disc(h, r, t) -> logit [B]`` plus the model-owned ``score_triplets``
    path (gathers from the raw tables + sigmoid)."""

    def __init__(self, embed_dim: int = 128, hidden_dim: int = 1024, seed: int = 0):
        d, hdim = int(embed_dim), int(hidden_dim)
        super().__init__((3 * d, hdim, hdim, 1),
                         torch.Generator().manual_seed(int(seed) + 2))
        self.embed_dim, self.hidden_dim = d, hdim

    def forward(self, h_emb: torch.Tensor, r_emb: torch.Tensor,
                t_emb: torch.Tensor) -> torch.Tensor:
        return self._mlp(torch.cat([h_emb, r_emb, t_emb], dim=-1))[..., 0]

    def score_triplets(self, node_emb, rel_emb, triplets) -> tuple[torch.Tensor, torch.Tensor]:
        """(node_emb [N,D], rel_emb [R,D] or {'weight': [R,D]}, triplets
        [B,3] int) -> (logits [B], probs [B])."""
        if isinstance(rel_emb, dict):
            rel_emb = rel_emb["weight"]
        triplets = torch.as_tensor(triplets, dtype=torch.int64, device=node_emb.device)
        logits = self(node_emb[triplets[:, 0]], rel_emb[triplets[:, 1]],
                      node_emb[triplets[:, 2]])
        return logits, torch.sigmoid(logits)
