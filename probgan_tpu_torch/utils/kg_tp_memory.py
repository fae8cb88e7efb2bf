"""Card memory, time and agreement of the row-sharded KG train step over a
launched world, one card a rank, against the one-process step.

    torchrun --nproc-per-node 4 -m probgan_tpu_torch.utils.kg_tp_memory \
        [--entities 10000003] [--model-parallelism 2] [--steps 3] [--device cpu]

At the KG trainer's widths (D 128, noise 64, hidden 1024, 1,000 relations),
a global batch of 64 with its corrupted negatives and 8,192 sampled
negatives, the same seeded state and inputs on every rank:

1. rank 0 runs ``--steps`` one-process ``kg_train_step``s on its own card
   and records the card memory they took at their peak and their times;
2. every rank places the state (``parallel/dp_train.py:shard_kg_state``)
   on a (world / tp, tp) mesh, runs the same steps (``kg_train_step(mesh=)``),
   evaluates Hit@10 over 512 triplets (``kg_eval_hits(mesh=)``) and records
   its peak over the placement and the steps, then what
   ``gather_kg_state`` adds on its card while it brings the state back to
   rank 0's host;
3. rank 0 holds the gathered state to the one-process one: losses within
   1e-5, every element within 2.1e-3, each Adam moment within 1e-4 of its
   leaf's largest entry, Hit@10 equal.

On CUDA the ranks talk through NCCL (``parallel/mesh.py``); ``--device cpu``
runs the same over gloo on the CPU, with no memory figures. Rank 0 prints
the card's name and power limit and one JSON line; the command exits 1 if
an agreement fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from probgan_tpu_torch.core.tree import tree_leaves, tree_map
from probgan_tpu_torch.engine import train as train_mod
from probgan_tpu_torch.parallel import make_mesh
from probgan_tpu_torch.parallel.dp_train import (
    gather_kg_state,
    kg_batch_sharding,
    shard_kg_state,
)
from probgan_tpu_torch.parallel.mesh import axis_size, rank_device
from probgan_tpu_torch.parallel.sharded_kg import kg_mesh

RELATIONS, DIM, NOISE, HIDDEN = 1_000, 128, 64, 1024
BATCH, CE_NEGATIVES, EVAL, SEED = 64, 8_192, 512, 23
LOSS_ATOL, MAX_DIFF, MOMENT_REL = 1e-5, 2.1e-3, 1e-4


def _inputs(n: int, steps: int) -> tuple[list[dict], dict]:
    """Each step's global batch (int64 triplets, negatives, sampled ids,
    noise) and an eval batch, from ``SEED``: the same on every rank."""
    rng = np.random.default_rng(SEED)

    def triplets(m):
        return torch.from_numpy(np.stack([rng.integers(0, n, m), rng.integers(0, RELATIONS, m),
                                          rng.integers(0, n, m)], axis=1))

    out = [{"triplets": triplets(BATCH),
            "negatives": torch.from_numpy(np.stack(
                [rng.integers(0, n, BATCH), rng.integers(0, RELATIONS, BATCH)], axis=1)),
            "ce": torch.from_numpy(rng.integers(0, n, CE_NEGATIVES)),
            "z": torch.from_numpy(rng.standard_normal((BATCH, NOISE)).astype(np.float32))}
           for _ in range(steps)]
    ev = {"triplets": triplets(EVAL),
          "z": torch.from_numpy(rng.standard_normal((EVAL, NOISE)).astype(np.float32))}
    return out, ev


class _Card:
    """Peak card memory and synchronized times on this rank's device (no
    memory figures on the CPU)."""

    def __init__(self, dev: torch.device):
        self.dev, self.cuda = dev, dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def peak_since_reset(self) -> int | None:
        if not self.cuda:
            return None
        peak = torch.cuda.max_memory_allocated(self.dev)
        torch.cuda.reset_peak_memory_stats(self.dev)
        return peak

    def held(self) -> int:
        return torch.cuda.memory_allocated(self.dev) if self.cuda else 0


def _steps(state, steps, card: _Card, place, **kw) -> tuple:
    """``kg_train_step`` on each step's inputs (``place`` puts a batch
    tensor where the step takes it): the state, the metrics, the seconds."""
    metrics, seconds = [], []
    for s in steps:
        trip, neg = place(s["triplets"]), place(s["negatives"])
        card.sync()
        t0 = time.perf_counter()
        state, m = train_mod.kg_train_step(state, trip, negatives=neg,
                                           ce_negatives=s["ce"].to(card.dev), z=s["z"], **kw)
        metrics.append({k: float(v) for k, v in m.items()})
        seconds.append(time.perf_counter() - t0)
    return state, metrics, seconds


def _agreement(got, want, got_m, want_m, dev: torch.device) -> dict:
    """The mesh's gathered state and metrics against one process's (both
    on the host), compared a leaf at a time on ``dev``."""
    def worst(a, b, rel=False):
        a, b = a.to(dev).double(), b.to(dev).double()
        d = float((a - b).abs().max())
        scale = float(b.abs().max()) if rel else 0.0
        return d / scale if scale else d

    moments = [worst(a, b, rel=True)
               for opt in ("g_opt", "d_opt") for m in ("mu", "nu")
               for a, b in zip(tree_leaves(getattr(getattr(got, opt)[0], m)),
                               tree_leaves(getattr(getattr(want, opt)[0], m)))]
    diff = max(worst(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    loss = max(abs(a[k] - b[k]) for a, b in zip(got_m, want_m) for k in ("d_loss", "g_loss"))
    return {"max_loss_diff": loss, "max_abs_diff": diff, "moments_rel": max(moments),
            "ok": loss <= LOSS_ATOL and diff <= MAX_DIFF and max(moments) <= MOMENT_REL}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--entities", type=int, default=10_000_003)
    parser.add_argument("--model-parallelism", type=int, default=None)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    n = args.entities
    mesh = make_mesh(model_parallelism=args.model_parallelism, device_type=args.device)
    rank, dev = dist.get_rank(), rank_device(args.device)
    card = _Card(dev)
    steps, ev = _inputs(n, args.steps)
    t0 = time.perf_counter()
    state0 = train_mod.kg_init_state(SEED, n, RELATIONS, DIM, NOISE, HIDDEN, device="cpu")
    init_s = time.perf_counter() - t0

    one = {}
    if rank == 0:
        card.peak_since_reset()
        ref = tree_map(lambda t: t if t.dim() == 0 else t.to(dev), state0)
        ref, one["metrics"], one["step_s"] = _steps(ref, steps, card, lambda x: x.to(dev))
        one["peak_bytes"] = card.peak_since_reset()
        one["hit10"] = float(train_mod.kg_eval_hits(
            ref.g_params, ref.node_emb, ref.rel_emb, ev["triplets"].to(dev), ev["z"].to(dev), 10))
        ref = tree_map(lambda t: t.cpu(), ref)
        card.sync()
        if card.cuda:
            torch.cuda.empty_cache()
    dist.barrier()

    kg = kg_mesh(mesh, n)
    dp, data_rank = axis_size(mesh, "data"), mesh.get_local_rank("data")
    card.peak_since_reset()
    st = shard_kg_state(mesh, state0)
    del state0
    st, metrics, step_s = _steps(st, steps, card, kg_batch_sharding(mesh), mesh=kg)
    mine = {"peak_bytes_steps": card.peak_since_reset(), "step_s": step_s}
    hit10 = float(train_mod.kg_eval_hits(
        st.g_params, st.node_emb, st.rel_emb,
        *(torch.tensor_split(ev[k], dp)[data_rank].to(dev) for k in ("triplets", "z")), 10,
        mesh=kg))
    card.sync()
    card.peak_since_reset()
    held = card.held()
    t0 = time.perf_counter()
    whole = gather_kg_state(kg, st)
    card.sync()
    mine["gather_s"] = time.perf_counter() - t0
    mine["gather_extra_bytes"] = None if not card.cuda else card.peak_since_reset() - held
    mine["gathered_here"] = whole is not None
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, mine)

    ok = True
    if rank == 0:
        agree = _agreement(whole, ref, metrics, one["metrics"], dev)
        placed = [r["gathered_here"] for r in ranks] == [i == 0 for i in range(len(ranks))]
        ok = agree["ok"] and placed and hit10 == one["hit10"]
        card_name = (subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines() or [""])[0] \
            if card.cuda else "cpu"
        print(card_name)
        print(json.dumps({
            "entities": n, "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "backend": dist.get_backend(), "init_s": init_s, "one_process": one,
            "ranks": ranks, "hit10": hit10, "agreement": agree,
            "gathered_on_rank_0_alone": placed,
            "peak_share": (None if not card.cuda else
                           [r["peak_bytes_steps"] / one["peak_bytes"] for r in ranks]),
            "ok": ok}))
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
