"""How far the train step's gradients at a bf16 kernel mode lie from fp32.

For the default 1024² config at stage 8 (both packed gates, ``remat``), the
raw gradients of the two losses ``progan_train_step`` feeds to Adam
(``progan_grads``) at ``packed_train_mode`` ``--mode`` ("mid" by default, or
"default") and at "high" (the fp32 kernels), on seeded real images and
latents: for each seed, batch and alpha,
the worst cosine and the least and largest norm ratio over the leaves of D
and of G, weights and biases apart, each with its leaf index (leaves zero in
both are skipped); and the same step on the plain twins of the kernels
(``ops/packed.py``'s ``*_plain``) against the kernels, each network's
gradients as one vector: relative L2 distance, cosine and the worst leaf's
largest difference over its largest entry. Prints the card's name and power
limit and one JSON line:

    python3 -m probgan_tpu_torch.utils.mid_gradient_spread [--mode default] [--seeds 78,79,80]
        [--batches 2,8]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import contextlib

import torch

from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import train
from probgan_tpu_torch.models.pro_gan import ProGANConfig
from probgan_tpu_torch.ops import packed as pk

STAGE = 8
KERNELS = ("packed_upconv", "packed_conv", "packed_conv_rgb", "packed_convpool",
           "packed_conv_wgrad")


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


def vector(got, want) -> dict:
    """``got`` against ``want`` as one vector over the leaves: relative L2
    distance, cosine, and the worst leaf's max difference over its largest
    entry."""
    g = torch.cat([a.double().flatten() for a in tree_leaves(got)])
    w = torch.cat([b.double().flatten() for b in tree_leaves(want)])
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(tree_leaves(got), tree_leaves(want)) if b.abs().max() > 0)
    return {"l2": ((g - w).norm() / w.norm()).item(),
            "cos": ((g @ w) / (g.norm() * w.norm())).item(), "worst_leaf": worst}


@contextlib.contextmanager
def plain_twins():
    """Inside, each kernel wrapper of ops/packed.py is its plain twin."""
    saved = {name: getattr(pk, name) for name in KERNELS}
    try:
        for name in KERNELS:
            setattr(pk, name, getattr(pk, f"{name}_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(pk, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="78,79,80,81,82", help="seeds of the images and latents")
    ap.add_argument("--batches", default="2", help="batch sizes")
    ap.add_argument("--alphas", default="0.5,1.0", help="fade-in alphas")
    ap.add_argument("--mode", default="mid", choices=["mid", "default"],
                    help="the packed_train_mode held against \"high\"")
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
                got = train.progan_grads(state, real, z, alpha, cfg, STAGE,
                                         packed_train_mode=args.mode, **kw)
                high = train.progan_grads(state, real, z, alpha, cfg, STAGE,
                                          packed_train_mode="high", **kw)
                with plain_twins():
                    twins = train.progan_grads(state, real, z, alpha, cfg, STAGE,
                                               packed_train_mode=args.mode, **kw)
                row = {"seed": seed, "batch": batch, "alpha": alpha,
                       "d": spread(got[0], high[0]), "g": spread(got[1], high[1]),
                       "vs_twins": {"d": vector(got[0], twins[0]),
                                    "g": vector(got[1], twins[1])}}
                print(json.dumps(row), flush=True)
                rows.append(row)
                del got, high, twins
                torch.cuda.empty_cache()
    worst = {k: min(min(r[n][k][0] for n in ("d", "g") if k in r[n]) for r in rows)
             for k in ("weight", "bias")}
    ratios = {k: (min(min(r[n][k][2] for n in ("d", "g") if k in r[n]) for r in rows),
                  max(max(r[n][k][4] for n in ("d", "g") if k in r[n]) for r in rows))
              for k in ("weight", "bias")}
    print(card)
    pairs = [r["vs_twins"][n] for r in rows for n in ("d", "g")]
    vs_twins = {"l2": max(p["l2"] for p in pairs), "cos": min(p["cos"] for p in pairs),
                "worst_leaf": max(p["worst_leaf"] for p in pairs)}
    print(json.dumps({"card": card, "mode": args.mode, "stage": STAGE, "cases": len(rows),
                      "vs_twins": vs_twins, "worst_cos": worst,
                      "ratio_range": ratios}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
