"""How far the train step's gradients at kernel mode "mid" lie from fp32.

For the default 1024² config at stage 8 (both packed gates, ``remat``), the
raw gradients of the two losses ``progan_train_step`` feeds to Adam
(``progan_grads``) at ``packed_train_mode="mid"`` and at "high" (the fp32
kernels), on seeded real images and latents: for each seed, batch and alpha,
the worst cosine and the least and largest norm ratio over the leaves of D
and of G, weights and biases apart, each with its leaf index. Leaves zero in
both are skipped. Prints the card's name and power limit and one JSON line:

    python3 -m probgan_tpu_torch.utils.mid_gradient_spread [--seeds 78,79,80] [--batches 2,8]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import train
from probgan_tpu_torch.models.pro_gan import ProGANConfig

STAGE = 8


def spread(got, want) -> dict:
    """{"weight" | "bias": [worst cos, its leaf, least ratio, its leaf,
    largest ratio, its leaf]} of ``got`` against ``want``, leaf by leaf."""
    out: dict = {}
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        kind = "bias" if w.dim() == 1 else "weight"
        g, w = g.double().flatten(), w.double().flatten()
        gn, wn = g.norm().item(), w.norm().item()
        if gn == 0 and wn == 0:
            continue
        cos, ratio = (g @ w).item() / (gn * wn), gn / wn
        o = out.setdefault(kind, [2.0, -1, float("inf"), -1, 0.0, -1])
        if cos < o[0]:
            o[0:2] = cos, i
        if ratio < o[2]:
            o[2:4] = ratio, i
        if ratio > o[4]:
            o[4:6] = ratio, i
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="78,79,80,81,82", help="seeds of the images and latents")
    ap.add_argument("--batches", default="2", help="batch sizes")
    ap.add_argument("--alphas", default="0.5,1.0", help="fade-in alphas")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mid_gradient_spread: no CUDA card")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = ProGANConfig()
    state = train.progan_init_state(0, cfg, device="cuda")
    kw = dict(packed_d=True, packed_g=True, remat=True)
    rows = []
    for batch in map(int, args.batches.split(",")):
        for seed in map(int, args.seeds.split(",")):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            real = torch.tanh(torch.randn((batch, cfg.resolution, cfg.resolution, 3),
                                          device="cuda", generator=gen))
            z = torch.randn((batch, cfg.latent_dim), device="cuda", generator=gen)
            for alpha in map(float, args.alphas.split(",")):
                mid = train.progan_grads(state, real, z, alpha, cfg, STAGE,
                                         packed_train_mode="mid", **kw)
                high = train.progan_grads(state, real, z, alpha, cfg, STAGE,
                                          packed_train_mode="high", **kw)
                row = {"seed": seed, "batch": batch, "alpha": alpha,
                       "d": spread(mid[0], high[0]), "g": spread(mid[1], high[1])}
                print(json.dumps(row), flush=True)
                rows.append(row)
                del mid, high
                torch.cuda.empty_cache()
    worst = {k: min(min(r[n][k][0] for n in ("d", "g") if k in r[n]) for r in rows)
             for k in ("weight", "bias")}
    ratios = {k: (min(min(r[n][k][2] for n in ("d", "g") if k in r[n]) for r in rows),
                  max(max(r[n][k][4] for n in ("d", "g") if k in r[n]) for r in rows))
              for k in ("weight", "bias")}
    print(card)
    print(json.dumps({"card": card, "stage": STAGE, "cases": len(rows), "worst_cos": worst,
                      "ratio_range": ratios}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
