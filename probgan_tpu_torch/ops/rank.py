"""Ranking primitives: L2-normalize, cosine-score product, top-k.

The port of ``probgan_tpu/ops/rank.py``. The entity table is normalized
once at load and cached by the engine; products run in full fp32 (TF32 is
switched off around them) so rankings do not depend on the card's matmul
defaults.

Every top-k of the port goes through ``top_k_lowest_index``: ``lax.top_k``
promises the lowest index among equal values, ``torch.topk`` does not, and
the reference's goldens and tie-break tests depend on it.
"""

from __future__ import annotations

import contextlib

import torch

# F.normalize's epsilon (denominator clamp), for score parity.
_NORM_EPS = 1e-12


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the enclosed float32 products without TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def l2_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise L2 normalization with ``F.normalize``'s eps semantics:
    ``x / max(||x||, 1e-12)``."""
    norm = torch.linalg.vector_norm(x, dim=axis, keepdim=True)
    return x / norm.clamp_min(_NORM_EPS)


def cosine_scores(query_norm: torch.Tensor, table_norm: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] cosine similarities (inputs pre-normalized),
    full fp32."""
    with full_fp32_matmul():
        return query_norm @ table_norm.T


def top_k_lowest_index(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k of [B, M] in descending value and, among equal values,
    ascending index: what ``lax.top_k`` returns. A stable descending sort
    keeps equal values in their original (index) order."""
    if not 1 <= k <= scores.shape[1]:
        raise ValueError(f"k={k} must be in 1..{scores.shape[1]}")
    values, indices = torch.sort(scores, dim=1, descending=True, stable=True)
    return values[:, :k].contiguous(), indices[:, :k].contiguous()


def rank_topk(query_norm: torch.Tensor, table_norm: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores then per-row top-k. Returns (values, indices)."""
    return top_k_lowest_index(cosine_scores(query_norm, table_norm), k)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Row-wise cosine similarity with each norm clamped at 1e-8 (the
    reference's ``F.cosine_similarity`` call)."""
    eps = 1e-8
    na = torch.linalg.vector_norm(a, dim=axis).clamp_min(eps)
    nb = torch.linalg.vector_norm(b, dim=axis).clamp_min(eps)
    return (a * b).sum(dim=axis) / (na * nb)
