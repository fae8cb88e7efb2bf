"""Progressive image-GAN trainer.

The port of ``probgan_tpu/cli/train_image.py``, with its flags, its stdout
lines and its files: ``metrics.jsonl`` (one line per epoch, the JAX keys,
``seconds`` not rounded),
``image_checkpoint.msgpack`` after every stage and ``train_state.msgpack``
(the JAX package's layouts on disk, so either package resumes or serves the
other's files). Stages grow 4² -> target resolution; within each stage the
blend alpha ramps 0 -> 1 over the first half of the stage's epochs, then
trains at alpha=1. One eager ``engine/train.py:progan_train_step`` per
optimizer step; real images are average-pooled down to the active stage's
resolution.

Data: ``--data_root`` with ``images.npy``/``images.npz`` holding uint8
[N, H, W, 3] (H = W = target resolution), or ``--synthetic N`` for a
procedural dataset (the JAX package's, bit for bit).

On the card (``--device auto``, the default, or ``cuda``) the D step renders
its fake batch through the forward-only packed kernels unless
``PROBGAN_PACKED=0`` (``engine/image.py:packed_default``); under
``PROBGAN_STAGE_FUSED=1`` each packed stage is one kernel. ``--device cpu``
runs the plain path. ``--bf16`` trains in bf16 (params, Adam and the loss
math stay fp32), as the JAX trainer does: the unpacked convs in bf16 and,
with ``--packed_d``/``--packed_g``, the packed kernels on fp32 casts of the
activations. The packed kernels train at ``--packed_mode``: ``default`` (the
default, one bf16 pass forward and backward), ``mid`` (the 2-term bf16
split; the weight gradients fp32) or ``high`` (fp32). ``--fast`` is the JAX
trainer's preset, ``--bf16 --packed_d --packed_g``. ``--device tpu`` exits 1
before the first step. ``--debug`` raises
FloatingPointError at the first loss that is not finite, naming the stage,
epoch and step (the JAX package turns on ``jax_debug_nans`` instead).

``--mesh auto`` (or a device count) trains data-parallel over a launched
world of processes, one a device (``parallel/dp_train.py``):

    torchrun --nproc-per-node N -m probgan_tpu_torch.cli.train_image ... --mesh auto

The state is replicated from world rank 0 after init and after a resume's
load; every rank draws the same global batch and latents from the same seeds
and steps on its rows, the gradients averaged over the ranks, so the run is
the one-device run on the same batches. ``--batch_size`` must be a multiple
of the mesh size, and ``--grad_accum`` does not compose with ``--mesh``.
Only world rank 0 prints and writes files.

The latents of each step come from ``draw_latents``, keyed by (seed + 1,
stage, epoch, step) as the JAX trainer's ``fold_in`` is, but with the port's
own bits; the data shuffle and the flips are the same numpy stream in both.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

_DEVICE_DATA_LIMIT = 4 * 1024**3  # bytes of uint8 images kept on the card


def synthetic_images(n: int, resolution: int, seed: int = 0) -> np.ndarray:
    """Procedural uint8 dataset: soft gaussian blobs on gradients — enough
    structure for losses to move without shipping a dataset."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:resolution, 0:resolution].astype(np.float32) / resolution
    imgs = np.empty((n, resolution, resolution, 3), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        sigma = rng.uniform(0.05, 0.3)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sigma**2))
        base = rng.uniform(0, 1, 3)[None, None, :]
        grad = (xx * rng.uniform(-1, 1) + yy * rng.uniform(-1, 1))[..., None]
        img = np.clip(base + 0.5 * grad + blob[..., None] * rng.uniform(-1, 1, 3), 0, 1)
        imgs[i] = img
    return (imgs * 255).astype(np.uint8)


def load_images(data_root: str) -> np.ndarray:
    for name in ("images.npy", "images.npz"):
        path = os.path.join(data_root, name)
        if os.path.exists(path):
            if name.endswith(".npz"):
                return np.load(path)["images"]
            return np.load(path)
    raise FileNotFoundError(
        f"No images.npy/images.npz under {data_root} "
        "(expected uint8 [N, R, R, 3])"
    )


def _downscale(images: np.ndarray, factor: int) -> np.ndarray:
    """[N, R, R, 3] float -> average-pooled by ``factor``."""
    if factor == 1:
        return images
    n, r, _, c = images.shape
    return images.reshape(n, r // factor, factor, r // factor, factor, c).mean(
        axis=(2, 4)
    )


def draw_latents(seed: int, stage: int, epoch: int, step: int, n: int,
                 latent_dim: int) -> torch.Tensor:
    """The latents of one optimizer step, standard normal [n, latent_dim] on
    the CPU, keyed by (seed + 1, stage, epoch, step) like the JAX trainer's
    ``fold_in(key(seed + 1), (stage * 1000 + epoch) * 100003 + step)``."""
    from probgan_tpu_torch.core.rng import keyed_generator

    gen = keyed_generator(seed + 1, (stage * 1000 + epoch) * 100003 + step)
    return torch.randn((n, latent_dim), generator=gen)


def init_state(seed: int, config, lr: float, device: str):
    """The fresh train state the trainer starts from (``--seed``)."""
    from probgan_tpu_torch.engine import train as train_engine

    return train_engine.progan_init_state(seed, config, lr, device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Prot-B-GAN Image Training")
    parser.add_argument("--data_root", type=str, default="",
                        help="Directory with images.npy/images.npz (uint8 [N,R,R,3])")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="Train on N procedural synthetic images instead of --data_root")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--fmap_base", type=int, default=8192)
    parser.add_argument("--fmap_max", type=int, default=512)
    parser.add_argument("--epochs_per_stage", type=int, default=4)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--debug", action="store_true",
                        help="Raise FloatingPointError at the first loss that "
                        "is not finite, naming the stage, epoch and step")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--output_dir", type=str, default="./modular_results")
    parser.add_argument("--device", type=str, default="auto",
                        choices=["auto", "tpu", "cuda", "cpu"],
                        help="auto/cuda: the first CUDA card (an error without "
                        "one); cpu: the plain path; tpu exits 1")
    parser.add_argument("--precision", type=str, default="default",
                        choices=["default", "fast", "high", "highest"],
                        help="Accepted for the JAX trainer's command lines; the "
                        "train step does not read it (as in the JAX trainer)")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from <output_dir>/train_state.msgpack")
    parser.add_argument("--grow", action="store_true",
                        help="With --resume: allow the saved state to come "
                        "from a LOWER-resolution schedule (progressive "
                        "growth). Trained params/EMA/Adam moments restore; "
                        "the new stage's start fresh and fade in as usual")
    parser.add_argument("--ema_beta", type=float, default=0.999,
                        help="Generator EMA decay (0 disables; EMA weights "
                        "are what generate_images serves by default)")
    parser.add_argument("--bf16", action="store_true",
                        help="Mixed-precision training: the convs run bfloat16 (params, "
                        "EMA, optimizer state and loss math stay fp32; the packed "
                        "kernels take fp32 casts of the activations)")
    parser.add_argument("--packed_d", action="store_true",
                        help="Run the leading D stages on the packed kernels "
                        "for forward AND backward (ops/packed_vjp.py); only "
                        "engages at stages >= 256² with nf <= 64")
    parser.add_argument("--packed_g", action="store_true",
                        help="Likewise for the generator's late-stage convs; "
                        "toRGB/blend stay torch ops")
    parser.add_argument("--packed_mode", type=str, default="default",
                        choices=["default", "mid", "high"],
                        help="Grade of the packed training kernels when "
                        "--packed_d/--packed_g engage: 'default' one bf16 pass "
                        "(forward and backward, with TF32 for the unpacked convs), "
                        "'mid' the 2-term bf16 split (weight gradients fp32), 'high' "
                        "fp32. Without them the step runs fp32")
    parser.add_argument("--fast", action="store_true",
                        help="The measured-fast production training preset of the "
                        "JAX package: implies --bf16 --packed_d --packed_g")
    parser.add_argument("--r1_gamma", type=float, default=0.0,
                        help="R1 zero-centered gradient penalty on reals "
                        "(gamma/2 * E[||grad_x D||^2]). 0 disables. Applied "
                        "lazily every --r1_every optimizer steps with gamma "
                        "pre-scaled by the interval; the penalty's D pass "
                        "runs on the unpacked path")
    parser.add_argument("--r1_every", type=int, default=16,
                        help="Lazy-R1 interval in optimizer steps")
    parser.add_argument("--mirror", action="store_true",
                        help="Horizontal-flip augmentation: each real image "
                        "in a batch is mirrored with probability 0.5")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Gradient accumulation: average N microbatches "
                        "of --batch_size under one optimizer update (one "
                        "microbatch of activations alive at a time). "
                        "Minibatch-stddev statistics are per-microbatch.")
    parser.add_argument("--checkpoint_minutes", type=float, default=10.0,
                        help="Also save the full train state mid-stage "
                        "whenever this many minutes have passed since the "
                        "last save (0 = stage-end saves only). --resume "
                        "restarts from the saved epoch. The data-shuffle RNG "
                        "stream restarts from --seed on resume; latent noise "
                        "is (stage,epoch,step)-keyed and unaffected.")
    parser.add_argument("--data_placement", type=str, default="device",
                        choices=["device", "host"],
                        help="'device' (default) keeps the dataset resident "
                        "on the device as uint8 and does the per-step batch "
                        "gather, normalization, downscaling and flips there; "
                        "'host' is the numpy pipeline. Falls back to host "
                        "when the raw dataset exceeds 4 GB.")
    parser.add_argument("--mesh", type=str, default="",
                        help="Data-parallel training over a launched world of "
                        "processes, one a device (torchrun --nproc-per-node N): "
                        "'auto' (the whole world) or a device count. The state "
                        "replicates, the batch splits over the ranks, the "
                        "gradients average over them, so --fast composes. "
                        "--batch_size must divide the device count. The math is "
                        "the one-device training on the same global batch "
                        "(parallel/dp_train.py), so checkpoints and --resume "
                        "pass between the two")
    return parser


def _unported(args) -> str | None:
    """The message for a flag that needs a piece the port does not have, or
    None."""
    if args.device == "tpu":
        return ("--device tpu: the port runs on a CUDA card (auto, cuda) or on "
                "the CPU (cpu)")
    return None


def _device_batch(raw_u8: torch.Tensor, idx: np.ndarray, flip, factor: int) -> torch.Tensor:
    """Gather -> [-1, 1] -> average-pool by ``factor`` -> x-flip, on the
    dataset's device. Pooling and flipping commute (2x2 blocks are
    contiguous), so this equals the host pipeline's flip-after-downscale."""
    x = raw_u8[torch.as_tensor(idx, dtype=torch.long, device=raw_u8.device)]
    x = x.float() / 127.5 - 1.0
    if factor > 1:
        n, r, _, c = x.shape
        x = x.reshape(n, r // factor, factor, r // factor, factor, c).mean(dim=(2, 4))
    if flip is not None:
        mask = torch.as_tensor(flip, device=x.device)[:, None, None, None]
        x = torch.where(mask, x.flip(2), x)
    return x


def _check_finite(metrics: dict, stage: int, epoch: int, step: int) -> None:
    for name in ("d_loss", "g_loss"):
        value = float(metrics[name])
        if not np.isfinite(value):
            raise FloatingPointError(
                f"{name} is {value} at stage {stage}, epoch {epoch + 1}, step {step + 1}")


def main(argv: list[str] | None = None) -> int:
    """The trainer; in a launched world only world rank 0 prints and writes
    files, the other ranks train beside it in silence."""
    from probgan_tpu_torch.parallel.mesh import world_rank

    if world_rank() == 0:
        return _main(argv)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return _main(argv, write=False)


def _main(argv: list[str] | None, write: bool = True) -> int:
    args = build_parser().parse_args(argv)
    if args.fast:
        args.bf16 = args.packed_d = args.packed_g = True
    if args.grow and not args.resume:
        # Silent-ignore would train the new resolution from scratch.
        print("Error: --grow requires --resume (it extends a saved run's "
              "train_state.msgpack to a higher resolution)")
        return 1
    message = _unported(args)
    if message is not None:
        print(f"Error: {message}")
        return 1

    from probgan_tpu_torch.core.device import device_str, resolve_device
    from probgan_tpu_torch.core.image_checkpoint import save_image_checkpoint
    from probgan_tpu_torch.core.train_state import load_train_state, save_train_state
    from probgan_tpu_torch.engine import train as train_engine
    from probgan_tpu_torch.engine.image import packed_default
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.parallel.mesh import rank_device, resolve_mesh

    device = resolve_device(args.device)
    print("Prot-B-GAN image training...")
    print(f"Device: {device_str(device)}")

    mesh = resolve_mesh(args.mesh, device_type=device.type) if args.mesh else None
    if mesh is not None:
        if args.batch_size % mesh.size() != 0:
            print(f"Error: --batch_size {args.batch_size} must be divisible "
                  f"by the mesh's {mesh.size()} devices")
            return 1
        if args.grad_accum > 1:
            print("Error: --grad_accum and --mesh are not composable yet; "
                  "use a larger per-device batch on the mesh instead")
            return 1
        print(f"Mesh: {mesh.size()} devices "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} — data-parallel training")
        device = rank_device(device.type)

    if args.synthetic > 0:
        raw = synthetic_images(args.synthetic, args.resolution, args.seed)
        print(f"  - Synthetic dataset: {len(raw)} images @ {args.resolution}²")
    else:
        if not args.data_root:
            print("Error: --data_root or --synthetic required")
            return 1
        raw = load_images(args.data_root)
        print(f"  - Dataset: {len(raw)} images {raw.shape[1:]} from {args.data_root}")
        if raw.shape[1] != args.resolution:
            raise ValueError(
                f"images are {raw.shape[1]}², --resolution is {args.resolution}"
            )

    # Device-resident data: one uint8 upload; the per-step gather, the
    # downscale and the flips run on the device.
    dev_raw = None
    if args.data_placement == "device" and raw.nbytes <= _DEVICE_DATA_LIMIT:
        dev_raw = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
    elif args.data_placement == "device":
        print("  - data_placement=device unavailable (dataset > 4 GB); using the host pipeline")
    # [-1, 1] float once; per-stage downscaled views are built lazily.
    real_full = None if dev_raw is not None else raw.astype(np.float32) / 127.5 - 1.0

    config = pro_gan.ProGANConfig(
        resolution=args.resolution,
        latent_dim=args.latent_dim,
        fmap_base=args.fmap_base,
        fmap_max=args.fmap_max,
    )
    if mesh is not None:
        # drawn on the CPU (the bits do not depend on the device), then
        # replicated onto each rank's own device from world rank 0
        from probgan_tpu_torch.parallel.dp_train import dp_progan_train_step, replicate_state

        state = replicate_state(mesh, init_state(args.seed, config, args.lr, "cpu"))
    else:
        state = init_state(args.seed, config, args.lr, device.type)

    if write:
        os.makedirs(args.output_dir, exist_ok=True)
    ckpt_path = os.path.join(args.output_dir, "image_checkpoint.msgpack")
    train_state_path = os.path.join(args.output_dir, "train_state.msgpack")
    start_stage = 0
    start_epoch = 0
    history: dict[str, list] = {"d_loss": [], "g_loss": []}
    if args.resume:
        if not os.path.exists(train_state_path):
            # A missing state file must not silently become a from-scratch run.
            print(f"Error: --resume: no train state at {train_state_path}")
            return 1
        # alias_missing: pre-EMA train_state files seed g_ema from the saved
        # raw generator (core/train_state.py).
        state, meta = load_train_state(
            train_state_path, state, alias_missing={"g_ema": "g_params"},
            grow=args.grow,
        )
        if mesh is not None:
            state = replicate_state(mesh, state)
        history = {k: list(v) for k, v in meta["history"].items()}
        # Files from before mid-stage saves carry no "epoch": the save
        # happened at a stage boundary, i.e. the stage is complete.
        done_epochs = int(meta.get("epoch", args.epochs_per_stage))
        if done_epochs < args.epochs_per_stage:
            start_stage = int(meta["stage"])
            start_epoch = done_epochs
            print(
                f"Resumed mid-stage {start_stage} "
                f"(next: epoch {start_epoch + 1}/{args.epochs_per_stage})"
            )
        else:
            start_stage = int(meta["stage"]) + 1
            print(f"Resumed after stage {meta['stage']} (next: stage {start_stage})")
    rng = np.random.RandomState(args.seed)

    # The D step's fake render may use the forward-only packed kernels (it
    # runs under no_grad, engine/train.py).
    packed_fake = packed_default(device)

    accum = max(1, args.grad_accum)
    n = len(raw)
    consume = args.batch_size * accum
    if n < consume:
        # With n < batch_size every epoch would skip its only (short) batch
        # and log losses of 0.0 as if training had happened.
        print(
            f"Error: dataset has {n} images but each optimizer step needs "
            f"{consume} (--batch_size {args.batch_size} x --grad_accum "
            f"{accum}); reduce one of them"
        )
        return 1
    steps_per_epoch = max(1, n // consume)
    fade_epochs = max(1, args.epochs_per_stage // 2)
    # Global optimizer-step counter (lazy-R1 cadence); on resume, rebuilt
    # from the resumed position so the R1 interval phase is preserved.
    opt_steps = (start_stage * args.epochs_per_stage + start_epoch) * steps_per_epoch
    last_save = time.time()
    step_kwargs = dict(
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        ema_beta=args.ema_beta,
        packed_fake=packed_fake,
        packed_d=args.packed_d,
        packed_g=args.packed_g,
        # the grade matters only where the packed training paths engage
        packed_train_mode=args.packed_mode if args.packed_d or args.packed_g else "highest",
    )

    metrics_log = (open(os.path.join(args.output_dir, "metrics.jsonl"), "a" if args.resume else "w")
                   if write else open(os.devnull, "w"))
    try:
        for stage in range(start_stage, config.num_stages):
            res = pro_gan.stage_resolution(stage)
            factor = args.resolution // res
            if dev_raw is None:
                reals = _downscale(real_full, factor)
            print(f"Stage {stage} ({res}²): {args.epochs_per_stage} epochs")
            first_epoch = start_epoch if stage == start_stage else 0
            for epoch in range(first_epoch, args.epochs_per_stage):
                # alpha ramps 0 -> 1 over the stage's first half (fade-in), then 1.
                alpha = 1.0 if stage == 0 else min(1.0, (epoch + 1) / fade_epochs)
                t0 = time.time()
                d_sum = g_sum = 0.0  # device tensors after the first step
                perm = rng.permutation(n)
                for step in range(steps_per_epoch):
                    idx = perm[step * consume : (step + 1) * consume]
                    if len(idx) < consume:
                        break
                    flip = rng.rand(len(idx)) < 0.5 if args.mirror else None
                    if dev_raw is not None:
                        batch = _device_batch(dev_raw, idx, flip, factor)
                    else:
                        batch_np = reals[idx]
                        if flip is not None:
                            batch_np = np.where(flip[:, None, None, None],
                                                batch_np[:, :, ::-1], batch_np)
                        batch = torch.from_numpy(np.ascontiguousarray(batch_np, np.float32)).to(device)
                    z = draw_latents(args.seed, stage, epoch, step, consume,
                                     config.latent_dim).to(device)
                    # Lazy R1: every r1_every-th step with gamma pre-scaled by the
                    # interval (equivalent strength, ~1/r1_every the cost).
                    r1_now = (
                        args.r1_gamma * args.r1_every
                        if args.r1_gamma > 0 and opt_steps % args.r1_every == 0
                        else 0.0
                    )
                    opt_steps += 1
                    if mesh is not None:
                        state, metrics = dp_progan_train_step(
                            mesh, state, batch, z, alpha, config, stage, args.lr,
                            r1_gamma=r1_now, **step_kwargs,
                        )
                    elif accum > 1:
                        state, metrics = train_engine.progan_train_step_accum(
                            state, batch.reshape(accum, args.batch_size, *batch.shape[1:]),
                            z.reshape(accum, args.batch_size, -1), alpha, config, stage,
                            args.lr, r1_gamma=r1_now, **step_kwargs,
                        )
                    else:
                        state, metrics = train_engine.progan_train_step(
                            state, batch, z, alpha, config, stage, args.lr,
                            r1_gamma=r1_now, **step_kwargs,
                        )
                    if args.debug:
                        _check_finite(metrics, stage, epoch, step)
                    d_sum = d_sum + metrics["d_loss"]
                    g_sum = g_sum + metrics["g_loss"]
                    if args.verbose:
                        print(
                            f"  stage {stage} epoch {epoch + 1} step {step + 1}: "
                            f"d={float(metrics['d_loss']):.4f} "
                            f"g={float(metrics['g_loss']):.4f} alpha={alpha:.2f}"
                        )
                d_avg = float(d_sum) / steps_per_epoch
                g_avg = float(g_sum) / steps_per_epoch
                history["d_loss"].append(d_avg)
                history["g_loss"].append(g_avg)
                print(
                    f"  stage {stage} epoch {epoch + 1}/{args.epochs_per_stage}: "
                    f"d_loss={d_avg:.4f} g_loss={g_avg:.4f} alpha={alpha:.2f} "
                    f"({time.time() - t0:.1f}s)"
                )
                metrics_log.write(json.dumps({
                    "stage": stage, "epoch": epoch + 1, "alpha": alpha,
                    "d_loss": d_avg, "g_loss": g_avg,
                    "seconds": time.time() - t0,
                }) + "\n")
                metrics_log.flush()
                mid_stage = epoch + 1 < args.epochs_per_stage
                if (write and args.checkpoint_minutes > 0 and mid_stage
                        and time.time() - last_save > args.checkpoint_minutes * 60):
                    save_train_state(train_state_path, state, {
                        "stage": stage, "epoch": epoch + 1, "history": history,
                    })
                    last_save = time.time()
                    if args.verbose:
                        print(f"  mid-stage train state saved (epoch {epoch + 1})")

            if write:
                save_image_checkpoint(
                    ckpt_path, config, state.g_params, state.d_params,
                    training_history=history,
                    g_ema=state.g_ema if args.ema_beta > 0 else None,
                )
                save_train_state(train_state_path, state, {
                    "stage": stage, "epoch": args.epochs_per_stage, "history": history,
                })
            last_save = time.time()
            if args.verbose:
                print(f"  checkpoint saved to {ckpt_path}")

    finally:
        metrics_log.close()
    print("Training complete!")
    print(f"  - Checkpoint: {ckpt_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
