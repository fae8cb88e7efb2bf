"""KG-GAN trainer CLI, and the dispatcher of ``--model image``.

The port of ``probgan_tpu/cli/train.py``: the flags the reference advertises
(``--data_root``, ``--debug``, ``--verbose``), best-tracking of
``best_val_hit10``/``best_epoch``/``training_history`` across epochs, and the
C17 checkpoint schema, by default as a torch ``.pt``
(``<output_dir>/best_checkpoint.pt``; ``--checkpoint_format native`` writes
msgpack). Either package loads the other's checkpoints and resumes the
other's ``train_state.msgpack``.

Data format: ``train.txt`` (+ optional ``valid.txt``) under ``--data_root``,
one tab/space-separated ``head relation tail`` triplet per line. Integer ids
are used directly (``native.parse_triplets``); string names get ids from a
vocabulary built over all splits, saved as ``vocab.json``. Without
``valid.txt`` 5% of train is held out.

The step is ``engine/train.py:kg_train_step`` with host-sampled corrupted
tails and relations, and a sampled softmax of 8,192 shared negatives above
50,000 entities (``--ce_negatives``). The generator's noise for global step
``g`` comes from ``draw_noise`` and the eval's from ``draw_eval_noise``, keyed
like the JAX trainer's ``fold_in(key(seed), g)`` and ``key(seed + 1)`` with
the port's own bits; a test replays the JAX draws through them and starts
from the JAX state through ``init_state``. ``metrics.jsonl`` holds the JAX
CLI's keys; its ``seconds`` are not rounded. On the card by default;
``--device cpu`` asks for the plain path. ``--device tpu`` exits 1.
``--debug`` raises FloatingPointError at the first loss that is not finite,
naming the epoch and step.

``--mesh auto`` (or a device count) trains over a launched world of
processes, one a device (``parallel/dp_train.py``):

    torchrun --nproc-per-node N -m probgan_tpu_torch.cli.train ... --mesh auto

The entity table and its Adam moments are row-sharded over the mesh's
"model" axis after init and after a resume's load, each step's batch and
corrupted negatives split over "data" (``--batch_size`` must be a multiple
of the data axis), the sampled negatives and the noise are the same on
every rank, and the eval runs over the sharded table. Only world rank 0
prints and writes files; it saves the state gathered back to its host
(``gather_kg_state``: no rank holds more of the table on its card than its
shard), so the files are the one-process trainer's and pass both ways
between mesh and one-process runs. A count that no launched world gives
exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch


def load_triplets(data_root: str, debug: bool = False):
    """Read train/valid splits. Returns (train [n,3], valid [m,3] or None,
    num_entities, num_relations, vocab-or-None)."""
    train_path = os.path.join(data_root, "train.txt")
    if not os.path.exists(train_path):
        raise FileNotFoundError(f"Training data not found: {train_path}")
    valid_path = os.path.join(data_root, "valid.txt")

    def _is_pure_int_file(path) -> bool:
        """Cheap router: a numeric-looking prefix routes to the int parser,
        which itself rejects the WHOLE file on any non-integer token, so a
        file that turns stringy after this prefix falls back to the
        vocabulary path below instead of being silently corrupted."""
        with open(path, "rb") as f:
            chunk = f.read(65536)
        return bool(chunk) and all(c in b"0123456789-\t\n\r " for c in chunk)

    pure_int = _is_pure_int_file(train_path) and (
        not os.path.exists(valid_path) or _is_pure_int_file(valid_path)
    )

    train = vocab = None
    if pure_int:
        from probgan_tpu_torch import native

        try:
            train = native.parse_triplets(train_path)
            valid = (native.parse_triplets(valid_path)
                     if os.path.exists(valid_path) else None)
        except ValueError as e:
            if debug:
                print(f"[debug] int parse rejected ({e}); using vocab path")
            train = None
    if train is None:

        def read(path):
            rows = []
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 3:
                        rows.append(parts[:3])
            return rows

        raw_train = read(train_path)
        raw_valid = read(valid_path) if os.path.exists(valid_path) else None
        every = raw_train + (raw_valid or [])
        ents: dict[str, int] = {}
        rels: dict[str, int] = {}
        for h, r, t in every:
            ents.setdefault(h, len(ents))
            rels.setdefault(r, len(rels))
            ents.setdefault(t, len(ents))
        vocab = {"entities": ents, "relations": rels}

        def enc(rows):
            return np.asarray(
                [[ents[h], rels[r], ents[t]] for h, r, t in rows], dtype=np.int32
            )

        train = enc(raw_train)
        valid = enc(raw_valid) if raw_valid else None

    num_entities = int(max(train[:, [0, 2]].max(),
                           valid[:, [0, 2]].max() if valid is not None else 0)) + 1
    num_relations = int(max(train[:, 1].max(),
                            valid[:, 1].max() if valid is not None else 0)) + 1
    if debug:
        print(f"[debug] train={len(train)} valid={0 if valid is None else len(valid)} "
              f"entities={num_entities} relations={num_relations}")
    return train, valid, num_entities, num_relations, vocab


def draw_noise(seed: int, global_step: int, n: int, noise_dim: int) -> torch.Tensor:
    """The generator noise of one step, standard normal [n, noise_dim] on the
    CPU, keyed by (seed, global_step) like the JAX trainer's
    ``fold_in(key(seed), global_step)``."""
    from probgan_tpu_torch.core.rng import keyed_generator

    return torch.randn((n, noise_dim), generator=keyed_generator(seed, global_step))


def draw_eval_noise(seed: int, n: int, noise_dim: int) -> torch.Tensor:
    """The eval's noise, one row a validation triplet, on the CPU; the JAX
    trainer draws it from ``key(seed + 1)``."""
    from probgan_tpu_torch.core.rng import keyed_generator

    return torch.randn((n, noise_dim), generator=keyed_generator(seed + 1, 0))


def init_state(seed: int, num_entities: int, num_relations: int, embed_dim: int,
               noise_dim: int, hidden_dim: int, lr: float, device: str):
    """The fresh train state the trainer starts from (``--seed``)."""
    from probgan_tpu_torch.engine import train as train_engine

    return train_engine.kg_init_state(seed, num_entities, num_relations, embed_dim,
                                      noise_dim, hidden_dim, lr, device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Prot-B-GAN Training System")
    parser.add_argument("--model", type=str, default="kg", choices=["kg", "image"],
                        help="Model family: 'kg' (link-prediction GAN, the "
                             "reference's domain) or 'image' (progressive "
                             "image GAN; see cli/train_image.py for its flags)")
    parser.add_argument("--data_root", type=str, required=True,
                        help="Directory containing train.txt (and optional valid.txt)")
    parser.add_argument("--debug", action="store_true",
                        help="Raise at the first loss that is not finite, and "
                             "extra diagnostics")
    parser.add_argument("--verbose", action="store_true",
                        help="Per-batch progress logging")
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=1024)
    parser.add_argument("--embed_dim", type=int, default=128)
    parser.add_argument("--noise_dim", type=int, default=64)
    parser.add_argument("--hidden_dim", type=int, default=1024)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--cosine_weight", type=float, default=1.0)
    parser.add_argument("--ce_weight", type=float, default=1.0,
                        help="Weight of the full-softmax ranking loss")
    parser.add_argument("--adv_weight", type=float, default=0.1,
                        help="Weight of the adversarial fool-D term in the generator loss")
    parser.add_argument("--ce_negatives", type=int, default=-1,
                        help="Sampled-softmax size for the ranking loss: 0 = "
                             "full softmax over all entities (O(B*N) per "
                             "step), N>0 = that many shared negatives, "
                             "-1 = auto (full softmax below 50k entities, "
                             "8192 negatives above)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_dir", type=str, default="./modular_results",
                        help="Where best_checkpoint.pt is written "
                             "(the reference's default artifact path)")
    parser.add_argument("--checkpoint_format", type=str, default="torch",
                        choices=["torch", "native"])
    parser.add_argument("--resume", action="store_true",
                        help="Resume from <output_dir>/train_state.msgpack "
                             "(full state incl. optimizer; written every epoch)")
    parser.add_argument("--device", type=str, default="auto",
                        choices=["auto", "tpu", "cuda", "cpu"],
                        help="auto/cuda: the first CUDA card (an error without "
                             "one); cpu: the plain path; tpu exits 1")
    parser.add_argument("--mesh", type=str, default="",
                        help="Training over a launched world of processes, one "
                             "a device (torchrun --nproc-per-node N): 'auto' "
                             "(the whole world) or a device count. The entity "
                             "table and its Adam moments row-shard over the "
                             "mesh's model axis, batches split over its data "
                             "axis (parallel/dp_train.shard_kg_state); rank 0 "
                             "writes the one-process trainer's files")
    return parser


def split_model_flag(argv: list[str]) -> tuple[str | None, list[str]]:
    """(the value of ``--model`` / ``--model=...`` or None, argv without it)."""
    model, filtered, skip_next = None, [], False
    for i, a in enumerate(argv):
        if skip_next:
            skip_next = False
            continue
        if a == "--model":
            if i + 1 < len(argv):
                model = argv[i + 1]
                skip_next = True
            continue
        if a.startswith("--model="):
            model = a.split("=", 1)[1]
            continue
        filtered.append(a)
    return model, filtered


def _prune_metrics(metrics_path: str, start_epoch: int) -> None:
    """On resume, drop lines past the resumed epoch (a crashed run may have
    logged epochs after its last saved train state) and torn lines."""
    kept = []
    with open(metrics_path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row.get("epoch", 0) <= start_epoch:
                kept.append(line)
    with open(metrics_path, "w") as f:
        f.writelines(kept)


def main(argv: list[str] | None = None) -> int:
    """The trainer; in a launched world only world rank 0 prints and writes
    files, the other ranks train beside it in silence."""
    import sys

    raw_argv = sys.argv[1:] if argv is None else list(argv)
    model, filtered = split_model_flag(raw_argv)
    if model == "image":
        from probgan_tpu_torch.cli.train_image import main as image_main

        return image_main(filtered)

    from probgan_tpu_torch.parallel.mesh import world_rank

    if world_rank() == 0:
        return _main(raw_argv)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _main(raw_argv, write=False)


def _main(argv: list[str], write: bool = True) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "tpu":
        print("Error: --device tpu: the port runs on a CUDA card (auto, cuda) or on the CPU (cpu)")
        return 1

    from probgan_tpu_torch import native
    from probgan_tpu_torch.core.checkpoint import save_checkpoint
    from probgan_tpu_torch.core.device import device_str, resolve_device
    from probgan_tpu_torch.core.train_state import load_train_state, save_train_state
    from probgan_tpu_torch.engine import train as train_engine
    from probgan_tpu_torch.parallel.mesh import axis_size, rank_device, resolve_mesh

    mesh = None
    if args.mesh:
        try:
            mesh = resolve_mesh(args.mesh, device_type="cpu" if args.device == "cpu" else "cuda")
        except ValueError as err:
            print(f"Error: --mesh {args.mesh}: {err}")
            return 1
    device = resolve_device(args.device)
    print("Prot-B-GAN training...")
    print(f"Data root: {args.data_root}")
    print(f"Device: {device_str(device)}")
    if mesh is not None:
        dp, data_rank = axis_size(mesh, "data"), mesh.get_local_rank("data")
        if args.batch_size % dp != 0:
            print(f"Error: --batch_size {args.batch_size} must be divisible by the mesh's "
                  f"data axis of {dp} devices")
            return 1
        print(f"Mesh: {mesh.size()} devices {dict(zip(mesh.mesh_dim_names, mesh.shape))} — "
              "entity-table TP + batch DP")
        device = rank_device(device.type)

    train, valid, num_entities, num_relations, vocab = load_triplets(
        args.data_root, args.debug
    )
    if valid is None:
        # hold out 5% of train for validation (best-tracking needs a signal)
        rng = np.random.RandomState(args.seed)
        perm = rng.permutation(len(train))
        n_val = max(1, len(train) // 20)
        valid, train = train[perm[:n_val]], train[perm[n_val:]]

    print(f"  - Entities: {num_entities:,}")
    print(f"  - Relations: {num_relations:,}")
    print(f"  - Train triplets: {len(train):,}")
    print(f"  - Valid triplets: {len(valid):,}")

    # on a mesh: drawn (or loaded) on the CPU, then each rank's part placed
    # on its own device
    state = init_state(args.seed, num_entities, num_relations, args.embed_dim,
                       args.noise_dim, args.hidden_dim, args.lr,
                       "cpu" if mesh is not None else device.type)
    history: dict[str, list] = {"val_hit10": [], "d_loss": [], "g_loss": []}
    best_hit10, best_epoch, start_epoch = 0.0, 0, 0
    if write:
        os.makedirs(args.output_dir, exist_ok=True)
    train_state_path = os.path.join(args.output_dir, "train_state.msgpack")
    if args.resume and os.path.exists(train_state_path):
        state, meta = load_train_state(train_state_path, state)
        history = {k: list(v) for k, v in meta["history"].items()}
        best_hit10 = float(meta["best_hit10"])
        best_epoch = int(meta["best_epoch"])
        start_epoch = int(meta["epoch"])
        print(f"Resumed from epoch {start_epoch} "
              f"(best Hit@10 {best_hit10:.4f} at epoch {best_epoch})")
    kg = None  # on a mesh, the step's view of it (parallel/sharded_kg.py:KGMesh)
    if mesh is not None:
        from probgan_tpu_torch.parallel.dp_train import (
            gather_kg_state,
            kg_batch_sharding,
            shard_kg_state,
        )
        from probgan_tpu_torch.parallel.sharded_kg import kg_mesh

        state = shard_kg_state(mesh, state)
        batch_rows = kg_batch_sharding(mesh)
        kg = kg_mesh(mesh, num_entities)
    # One JSON line per epoch behind the reference-style prints.
    metrics_path = os.path.join(args.output_dir, "metrics.jsonl")
    if write and args.resume and os.path.exists(metrics_path):
        _prune_metrics(metrics_path, start_epoch)
    ckpt_ext = ".pt" if args.checkpoint_format == "torch" else ".msgpack"
    ckpt_path = os.path.join(args.output_dir, f"best_checkpoint{ckpt_ext}")

    valid_dev = torch.from_numpy(valid.astype(np.int64)).to(device)
    z_eval = draw_eval_noise(args.seed, len(valid), args.noise_dim).to(device)

    def checkpoint_dict(state, hit10, epoch):
        return {
            "args": {
                "embed_dim": args.embed_dim,
                "noise_dim": args.noise_dim,
                "hidden_dim": args.hidden_dim,
            },
            "node_emb": state.node_emb,
            "rel_emb": {"weight": state.rel_emb},
            "generator": state.g_params,
            "discriminator": state.d_params,
            "best_val_hit10": float(hit10),
            "best_epoch": int(epoch),
            "training_history": history,
        }

    ce_neg = args.ce_negatives
    if ce_neg < 0:
        ce_neg = 0 if num_entities <= 50_000 else 8192
    if ce_neg:
        print(f"  - Sampled-softmax ranking loss: {ce_neg} negatives")

    def on_device(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.int64)).to(device)

    def batch_on_device(a: np.ndarray) -> torch.Tensor:
        """A step's batch rows: on a mesh, this rank's share along "data"."""
        if mesh is None:
            return on_device(a)
        return batch_rows(torch.from_numpy(a.astype(np.int64)))

    steps_per_epoch = max(1, len(train) // args.batch_size)
    metrics_log = (open(metrics_path, "a" if args.resume else "w") if write
                   else open(os.devnull, "w"))
    try:
        for epoch in range(start_epoch + 1, args.epochs + 1):
            t0 = time.time()
            # Per-epoch shuffle seed: deterministic and resume-stable.
            perm = np.random.RandomState(args.seed + epoch).permutation(len(train))
            epoch_d = epoch_g = 0.0  # device tensors after the first step
            for step in range(steps_per_epoch):
                idx = perm[step * args.batch_size : (step + 1) * args.batch_size]
                batch = batch_on_device(train[idx])
                # Global-step key: unique for every (epoch, step).
                global_step = (epoch - 1) * steps_per_epoch + step
                nb = len(idx)
                z = draw_noise(args.seed, global_step, nb, args.noise_dim)
                # Host-sampled corrupted tails + relations for the discriminator.
                negatives = batch_on_device(np.stack([
                    native.sample_negatives(nb, num_entities, 2 * global_step),
                    native.sample_negatives(nb, num_relations, 2 * global_step + 1),
                ], axis=1))
                ce_ids = (on_device(native.sample_negatives(ce_neg, num_entities,
                                                            0x5EED0000 + global_step))
                          if ce_neg else None)
                state, metrics = train_engine.kg_train_step(
                    state, batch, lr=args.lr, cosine_weight=args.cosine_weight,
                    ce_weight=args.ce_weight, adv_weight=args.adv_weight,
                    negatives=negatives, ce_negatives=ce_ids, z=z,
                    mesh=kg,
                )
                if args.debug:
                    for name in ("d_loss", "g_loss"):
                        value = float(metrics[name])
                        if not np.isfinite(value):
                            raise FloatingPointError(
                                f"{name} is {value} at epoch {epoch}, step {step + 1}")
                epoch_d = epoch_d + metrics["d_loss"]
                epoch_g = epoch_g + metrics["g_loss"]
                if args.verbose:
                    print(
                        f"  epoch {epoch} step {step + 1}/{steps_per_epoch} "
                        f"d_loss={float(metrics['d_loss']):.4f} "
                        f"g_loss={float(metrics['g_loss']):.4f} "
                        f"gen_cos={float(metrics['gen_cosine']):.4f}"
                    )

            epoch_d = float(epoch_d)
            epoch_g = float(epoch_g)
            # Chunked eval: one unchunked call holds a [num_valid, num_entities]
            # score matrix; the chunk keeps it at ~2 GB. On a mesh each rank
            # ranks its share of a chunk along "data" against its rows; the
            # fraction is the whole chunk's.
            hits, seen = 0.0, 0
            eval_bs = max(64, min(4096, (1 << 29) // max(num_entities, 1)))
            for off in range(0, len(valid), eval_bs):
                vb = valid_dev[off : off + eval_bs]
                zb = z_eval[off : off + eval_bs]
                n = len(vb)
                if mesh is not None:
                    vb, zb = (torch.tensor_split(x, dp)[data_rank] for x in (vb, zb))
                frac = float(train_engine.kg_eval_hits(
                    state.g_params, state.node_emb, state.rel_emb, vb, zb, 10,
                    mesh=kg))
                hits += frac * n
                seen += n
            hit10 = hits / max(seen, 1)
            history["val_hit10"].append(hit10)
            history["d_loss"].append(epoch_d / steps_per_epoch)
            history["g_loss"].append(epoch_g / steps_per_epoch)
            print(
                f"Epoch {epoch}/{args.epochs}: val Hit@10={hit10:.4f} "
                f"d_loss={epoch_d / steps_per_epoch:.4f} "
                f"g_loss={epoch_g / steps_per_epoch:.4f} "
                f"({time.time() - t0:.1f}s)"
            )
            metrics_log.write(json.dumps({
                "epoch": epoch,
                "val_hit10": hit10,
                "d_loss": epoch_d / steps_per_epoch,
                "g_loss": epoch_g / steps_per_epoch,
                "seconds": time.time() - t0,
            }) + "\n")
            metrics_log.flush()

            # on a mesh rank 0's model group sends rank 0 the table's rows and
            # rank 0 writes; the other ranks get None
            whole = state if mesh is None else gather_kg_state(kg, state)
            if hit10 >= best_hit10:
                best_hit10, best_epoch = hit10, epoch
                if write:
                    save_checkpoint(ckpt_path, checkpoint_dict(whole, best_hit10, best_epoch))
                if args.verbose:
                    print(f"  new best; checkpoint saved to {ckpt_path}")

            if write:
                save_train_state(train_state_path, whole, {
                    "epoch": epoch,
                    "best_hit10": best_hit10,
                    "best_epoch": best_epoch,
                    "history": history,
                })
            del whole  # on a mesh: the gathered copy, on rank 0's host

    finally:
        metrics_log.close()
    if write and vocab is not None:
        with open(os.path.join(args.output_dir, "vocab.json"), "w") as f:
            json.dump(vocab, f)

    print("Training complete!")
    print(f"  - Best validation Hit@10: {best_hit10:.4f}")
    print(f"  - Achieved at epoch: {best_epoch}")
    print(f"  - Checkpoint: {ckpt_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
