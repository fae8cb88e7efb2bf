"""``ModularGenerator`` / ``ModularDiscriminator`` as ``nn.Module``s.

The reference does ``from modular_prot_b_gan import ModularGenerator,
ModularDiscriminator`` and then ``load_state_dict`` / ``.to(device)`` /
``.eval()`` / forward. The port of ``probgan_tpu/models/modular.py``: here
the classes are real modules over ``nn.Linear`` (``fcN.weight [out, in]``),
so a reference ``.pt``'s ``generator`` / ``discriminator`` state dicts load
with ``load_state_dict(strict=True)``. They compute what the functions in
``models/kg_gan.py`` compute (the engine's path) on the transposed weights.

- ``load_state_dict`` takes the flat torch form (``fcN.weight`` /
  ``fcN.bias``) or the nested ``{fcN: {w [in, out], b}}`` form of
  ``core/checkpoint.py`` and the KG functions, numpy arrays or tensors; a
  strict load raises ``StateDictMismatch`` (a ``ValueError``, as the
  reference raises, and a ``RuntimeError``, as ``nn.Module`` raises) for
  missing or unexpected keys ("state dict mismatch") and wrong shapes
  ("size mismatch").
- ``to("auto" | "cuda" | "gpu" | "cpu")`` resolves the name through
  ``core/device.py`` (``auto`` is the card, and raises without one); any
  other argument goes to ``nn.Module.to``.
- Inputs may be tensors on any device, numpy arrays or lists: each goes
  through ``torch.as_tensor`` onto the module's device.
- ``gen(h_emb [B,D], r_emb [B,D]) -> t_emb [B,D]`` draws its noise from the
  module's own ``torch.Generator`` (seeded at construction, so a given call
  sequence is deterministic); pass ``z=`` to make the noise explicit.
- ``disc(h, r, t) -> logit [B]``, and ``disc.score_triplets(node_emb,
  rel_emb, triplets) -> (logits, probs)`` with its own gathers and sigmoid.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from probgan_tpu_torch.core.checkpoint import params_to_torch_state
from probgan_tpu_torch.core.device import resolve_device
from probgan_tpu_torch.models.kg_gan import LRELU_SLOPE
from probgan_tpu_torch.ops.rank import full_fp32_matmul

__all__ = ["ModularGenerator", "ModularDiscriminator", "StateDictMismatch"]

# The device names of the reference's --device that core/device.py resolves.
_DEVICE_NAMES = ("auto", "cuda", "gpu", "cpu")


class StateDictMismatch(ValueError, RuntimeError):
    """A strict ``load_state_dict`` refused the state: the reference raises
    ``ValueError``, ``nn.Module`` raises ``RuntimeError``; this is both."""


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

    def _in(self, x: Any, dtype: torch.dtype | None = None) -> torch.Tensor:
        """``x`` (tensor, numpy array or list) as a tensor on the module's
        device, in the weights' dtype unless ``dtype`` is given."""
        w = self.fc1.weight
        return torch.as_tensor(x, dtype=dtype or w.dtype, device=w.device)

    def load_state_dict(self, state_dict: dict, strict: bool = True, assign: bool = False):
        """Load the flat torch form or the nested ``{fcN: {w, b}}`` form,
        numpy arrays or tensors (weights ``[in, out]`` in the nested form,
        as ``core/checkpoint.py`` and ``models/kg_gan.py`` hold them)."""
        if state_dict and all(isinstance(v, dict) for v in state_dict.values()):
            state_dict = params_to_torch_state(state_dict)
        flat = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        if strict:
            want = {k: tuple(v.shape) for k, v in self.state_dict().items()}
            got = {k: tuple(v.shape) for k, v in flat.items()}
            if want.keys() != got.keys():
                raise StateDictMismatch(
                    f"state dict mismatch: missing={sorted(want.keys() - got.keys())} "
                    f"unexpected={sorted(got.keys() - want.keys())}")
            bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
            if bad:
                raise StateDictMismatch(
                    "state dict size mismatch (got != expected): "
                    + ", ".join(f"{k}: {g} != {w}" for k, (g, w) in sorted(bad.items())))
        return super().load_state_dict(flat, strict=strict, assign=assign)

    def to(self, *args, **kwargs):
        """``to("auto" | "cuda" | "gpu" | "cpu")`` (the reference's device
        names, ``auto`` when no argument is given) through
        ``core/device.py``; anything else as ``nn.Module.to``."""
        if not args and not kwargs:
            args = ("auto",)
        device = args[0] if args else kwargs.get("device")
        if isinstance(device, str) and device.lower() in _DEVICE_NAMES:
            if args:
                args = (resolve_device(device), *args[1:])
            else:
                kwargs["device"] = resolve_device(device)
        return super().to(*args, **kwargs)


class ModularGenerator(_MLP):
    """``gen(h_emb, r_emb) -> t_emb`` with internally sampled noise."""

    def __init__(self, embed_dim: int = 128, noise_dim: int = 64, seed: int = 0):
        d, z = int(embed_dim), int(noise_dim)
        super().__init__((2 * d + z, 2 * d, 2 * d, d),
                         torch.Generator().manual_seed(int(seed) + 1))
        self.embed_dim, self.noise_dim = d, z
        # The noise is drawn on the CPU generator and moved to the module's
        # device, so its bits do not depend on where the module lives.
        self._noise_gen = torch.Generator().manual_seed(int(seed))

    def forward(self, h_emb, r_emb, z=None) -> torch.Tensor:
        h, r = self._in(h_emb), self._in(r_emb)
        if z is None:
            z = torch.randn((h.shape[0], self.noise_dim), generator=self._noise_gen)
        return self._mlp(torch.cat([h, r, self._in(z)], dim=-1))


class ModularDiscriminator(_MLP):
    """``disc(h, r, t) -> logit [B]`` plus the model-owned ``score_triplets``
    path (gathers from the raw tables + sigmoid)."""

    def __init__(self, embed_dim: int = 128, hidden_dim: int = 1024, seed: int = 0):
        d, hdim = int(embed_dim), int(hidden_dim)
        super().__init__((3 * d, hdim, hdim, 1),
                         torch.Generator().manual_seed(int(seed) + 2))
        self.embed_dim, self.hidden_dim = d, hdim

    def forward(self, h_emb, r_emb, t_emb) -> torch.Tensor:
        return self._mlp(torch.cat([self._in(h_emb), self._in(r_emb), self._in(t_emb)],
                                   dim=-1))[..., 0]

    def score_triplets(self, node_emb, rel_emb, triplets) -> tuple[torch.Tensor, torch.Tensor]:
        """(node_emb [N,D], rel_emb [R,D] or {'weight': [R,D]}, triplets
        [B,3] int) -> (logits [B], probs [B])."""
        if isinstance(rel_emb, dict):
            rel_emb = rel_emb["weight"]
        node, rel = self._in(node_emb), self._in(rel_emb)
        triplets = self._in(triplets, torch.int64)
        logits = self(node[triplets[:, 0]], rel[triplets[:, 1]], node[triplets[:, 2]])
        return logits, torch.sigmoid(logits)
