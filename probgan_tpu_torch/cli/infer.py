"""CLI entry / task dispatch with the reference's argparse surface.

The port of ``probgan_tpu/cli/infer.py``: the same flags and defaults, the
same task dispatch and prints. Run it as

    python -m probgan_tpu_torch.cli.infer --checkpoint_path CKPT --task ...

``--device`` takes ``auto|cuda|gpu|cpu``; ``auto`` means the first CUDA card
and raises without one (pass ``cpu`` for the plain CPU path).
``--task generate_images`` serves an image-GAN checkpoint
(``core/image_checkpoint.py``; ``utils/demo_checkpoint.py --image`` writes a
seeded one).

``--mesh auto`` (or a device count) runs over a launched world of
processes, one a device: ``predict_tails`` / ``similar_entities`` rank
against the entity table row-sharded over the mesh, ``generate_images``
splits its latents over the ranks (data parallelism):

    torchrun --nproc-per-node N -m probgan_tpu_torch.cli.infer \
        --checkpoint_path CKPT --task predict_tails ... --mesh auto

Every rank runs the task; only world rank 0 prints and writes
``--output_file``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from probgan_tpu_torch.cli.repl import interactive_mode
from probgan_tpu_torch.engine import InferenceEngine
from probgan_tpu_torch.parallel.mesh import world_rank
from probgan_tpu_torch.utils.profiling import maybe_profile

TASKS = (
    "predict_tails",
    "score_triplets",
    "similar_entities",
    "analyze_relations",
    "interactive",
    "model_info",
    "generate_images",
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Prot-B-GAN Inference System")
    parser.add_argument(
        "--checkpoint_path",
        type=str,
        required=True,
        help="Path to trained model checkpoint",
    )
    parser.add_argument(
        "--task",
        type=str,
        default="interactive",
        choices=list(TASKS),
        help="Inference task to perform",
    )
    parser.add_argument(
        "--input_triplets",
        type=str,
        default="",
        help='Input triplets as JSON string (e.g., "[[0,1,2],[3,4,5]]")',
    )
    parser.add_argument(
        "--input_pairs",
        type=str,
        default="",
        help='Input head-relation pairs as JSON string (e.g., "[[0,1],[2,3]]")',
    )
    parser.add_argument(
        "--input_entities",
        type=str,
        default="",
        help='Input entity IDs as JSON string (e.g., "[0,1,2,3]")',
    )
    parser.add_argument(
        "--input_heads",
        type=str,
        default="",
        help='Head entity IDs for analyze_relations as JSON string (e.g., "[0,1]")',
    )
    parser.add_argument(
        "--input_tails",
        type=str,
        default="",
        help='Tail entity IDs for analyze_relations as JSON string (e.g., "[2,3]")',
    )
    parser.add_argument(
        "--top_k", type=int, default=10, help="Number of top results to return"
    )
    parser.add_argument(
        "--output_file",
        type=str,
        default="",
        help="Output file to save results (JSON format)",
    )
    parser.add_argument(
        "--device",
        type=str,
        default="auto",
        choices=["auto", "cuda", "gpu", "cpu"],
        help="Device to use for inference ('auto', 'cuda' and 'gpu' mean the "
        "first CUDA card and fail without one; 'cpu' runs the plain CPU path)",
    )
    parser.add_argument(
        "--seed", type=int, default=0, help="Seed for generator noise"
    )
    parser.add_argument(
        "--num_images", type=int, default=1,
        help="Number of images for the generate_images task",
    )
    parser.add_argument(
        "--stage", type=int, default=-1,
        help="Progressive stage for generate_images (-1 = final resolution)",
    )
    parser.add_argument(
        "--alpha", type=float, default=1.0,
        help="Progressive fade-in alpha for generate_images",
    )
    parser.add_argument(
        "--raw_generator", action="store_true",
        help="generate_images: use the raw adversarial iterate even when "
        "the checkpoint stores EMA generator weights (default prefers EMA)",
    )
    parser.add_argument(
        "--precision", type=str, default="high",
        choices=["default", "fast", "high", "highest"],
        help="Image-task serving grade (generate_images): 'high' and "
        "'highest' are fp32 throughout; 'fast' keeps the early stages fp32 and "
        "runs the late kernels in one bf16 pass (the cheapest grade above the "
        "50 dB bar); 'default' adds TF32 to the early stages' convs",
    )
    parser.add_argument(
        "--profile_dir",
        type=str,
        default="",
        help="If set, capture a torch.profiler trace of the task into this dir",
    )
    parser.add_argument(
        "--mesh",
        type=str,
        default="",
        help="Multi-device mesh: 'auto' (the whole launched world, one process "
        "a device: torchrun --nproc-per-node N) or a device count. "
        "predict_tails/similar_entities rank against the entity table sharded "
        "over the mesh's model axis, with the one-device results; "
        "generate_images splits its latents over every rank of the mesh",
    )
    return parser


def run_generate_images(args: argparse.Namespace, write: bool = True):
    """Image-synthesis task on an image-GAN checkpoint. The JSON result
    carries shape/checksum metadata; pass an ``--output_file`` ending in .npz
    to also save the raw uint8 images (unless ``write`` is False: a mesh's
    other ranks)."""
    import numpy as np

    from probgan_tpu_torch.core.image_checkpoint import load_image_checkpoint
    from probgan_tpu_torch.engine.image import ImageGANEngine

    config, g_params, d_params = load_image_checkpoint(
        args.checkpoint_path, prefer_ema=not args.raw_generator
    )
    engine = ImageGANEngine(
        config, g_params=g_params, d_params=d_params or None,
        device=args.device, seed=args.seed, mesh=args.mesh,
        precision=None if args.precision == "default" else args.precision,
    )
    stage = engine.final_stage if args.stage < 0 else args.stage
    print(
        f"Generating {args.num_images} images at "
        f"{4 * 2 ** stage}x{4 * 2 ** stage} (alpha={args.alpha})..."
    )
    z = engine.sample_latents(args.num_images)
    images = engine.generate(z, stage=stage, alpha=args.alpha)

    npz_path = ""
    if write and args.output_file.endswith(".npz"):
        np.savez_compressed(args.output_file, images=images)
        npz_path = args.output_file

    return {
        "images_shape": list(images.shape),
        "dtype": "uint8",
        "checksum": int(images.astype(np.int64).sum()),
        "images_file": npz_path,
        "metadata": {
            "num_images": args.num_images,
            "stage": stage,
            "alpha": args.alpha,
            "resolution": int(4 * 2 ** stage),
            "seed": args.seed,
        },
    }


def run_task(engine: InferenceEngine, args: argparse.Namespace):
    """Dispatch a non-interactive task. Returns the result dict or None (the
    caller prints nothing when results are None)."""
    if args.task == "model_info":
        return engine.get_model_info()

    if args.task == "predict_tails":
        if not args.input_pairs:
            print("Error: --input_pairs required for predict_tails task")
            return None
        pairs = json.loads(args.input_pairs)
        return engine.predict_tails(pairs, args.top_k, return_scores=True)

    if args.task == "score_triplets":
        if not args.input_triplets:
            print("Error: --input_triplets required for score_triplets task")
            return None
        triplets = json.loads(args.input_triplets)
        return engine.score_triplets(triplets, method="both")

    if args.task == "similar_entities":
        if not args.input_entities:
            print("Error: --input_entities required for similar_entities task")
            return None
        entities = json.loads(args.input_entities)
        return engine.find_similar_entities(entities, args.top_k)

    if args.task == "analyze_relations":
        if not args.input_heads or not args.input_tails:
            print(
                "Error: --input_heads and --input_tails required for "
                "analyze_relations task"
            )
            return None
        heads = json.loads(args.input_heads)
        tails = json.loads(args.input_tails)
        return engine.analyze_relations(heads, tails, args.top_k)

    return None


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if world_rank() == 0:
        _main(args)
    else:  # a launched world's other ranks run the task and say nothing
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            _main(args, write=False)


def _main(args: argparse.Namespace, write: bool = True) -> None:
    if args.task == "generate_images":
        with maybe_profile(args.profile_dir):
            results = run_generate_images(args, write)
        if not write:
            return
        if results.get("images_file"):
            print(f"Images saved to: {results['images_file']}")
            print(json.dumps(results, indent=2))
        elif args.output_file:
            with open(args.output_file, "w") as f:
                json.dump(results, f, indent=2)
            print(f"Results saved to: {args.output_file}")
        else:
            print(json.dumps(results, indent=2))
        return

    engine = InferenceEngine(
        args.checkpoint_path, args.device, seed=args.seed, mesh=args.mesh
    )

    if args.task == "interactive":
        interactive_mode(engine)
        return

    with maybe_profile(args.profile_dir):
        results = run_task(engine, args)

    if results and write:
        if args.output_file:
            with open(args.output_file, "w") as f:
                json.dump(results, f, indent=2)
            print(f"Results saved to: {args.output_file}")
        else:
            print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
