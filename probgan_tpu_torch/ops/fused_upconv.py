"""Fused nearest-upsample-2x + conv3x3, as four 2x2 parity convs.

A 3x3 SAME conv applied to a nearest-2x-upsampled input is exactly a set of
four 2x2 convs on the un-upsampled input, one per output-pixel parity
(subpixel identity): for output row 2i+p,

    p=0:  rows (i-1, i)   with kernel rows (W0, W1+W2)
    p=1:  rows (i,   i+1) with kernel rows (W0+W1, W2)

and the same split over columns. The upsampled tensor is never built, and
the parity filters pre-sum the duplicated taps: 16 MACs per 4 output pixels
instead of 36. Exact up to float reassociation of the pre-summed taps.

This is the cuDNN-level op of the early generator stages (``F.conv2d``),
and ``parity_weights`` is also the weight prep of the ``packed_upconv``
CUDA kernel, so both sum the taps in the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def parity_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> [2 (row parity), 2 (col parity), Cout, Cin,
    2, 2]: the 2x2 kernel of each output parity. Rows are pre-summed first,
    then columns (the JAX reference's order)."""
    rows = (
        torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2),  # [Co,Ci,2,3]
        torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2),
    )

    def cols(r):
        return torch.stack([
            torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=-1),
            torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=-1),
        ])

    return torch.stack([cols(r) for r in rows])


# F.pad order (left, right, top, bottom) selecting input rows (i-1, i) for
# parity 0 and (i, i+1) for parity 1, per (row parity, col parity).
_PADS = {(0, 0): (1, 0, 1, 0), (0, 1): (0, 1, 1, 0),
         (1, 0): (1, 0, 0, 1), (1, 1): (0, 1, 0, 1)}


def upsample2x_conv3x3(w: torch.Tensor, b: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Equivalent to ``conv3x3_same(nearest_upsample_2x(x), w) + b``:
    w OIHW [Cout, Cin, 3, 3] (already equalized-LR scaled), b [Cout],
    x NCHW [B, Cin, H, W] -> [B, Cout, 2H, 2W], in x's dtype (the taps are
    pre-summed in w's dtype, then cast)."""
    return parity_conv(parity_weights(w).to(x.dtype), b.to(x.dtype), x)


def parity_conv(wp: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The four parity convs of ``upsample2x_conv3x3`` from ready parity
    weights ``wp`` [2, 2, Cout, Cin, 2, 2] (``parity_weights``)."""
    y = [[F.conv2d(F.pad(x, _PADS[py, px]), wp[py, px]) for px in (0, 1)]
         for py in (0, 1)]
    bsz, cout, h, wd = y[0][0].shape
    # [B, C, H, 2 (py), W, 2 (px)] -> rows 2i+py, columns 2j+px
    y = torch.stack([torch.stack(row, dim=-1) for row in y], dim=3)
    return y.reshape(bsz, cout, 2 * h, 2 * wd) + b[:, None, None]
