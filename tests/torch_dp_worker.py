"""One rank of ``tests/test_torch_dp.py``'s gloo world, on the CPU.

    python tests/torch_dp_worker.py RANK WORLD DIR

Joins a gloo group through the ``file://`` rendezvous ``DIR/rendezvous``,
reads the inputs that the test wrote (``DIR/inputs.npz``, ``DIR/inputs.json``
and the trees in ``DIR/trees.pt``), runs each through the port's
data-parallel paths and writes what it got to ``DIR/rank{RANK}.pt``. Imports
no JAX.
"""

from __future__ import annotations

import builtins
import contextlib
import io
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


@contextlib.contextmanager
def _writes(seen: list):
    """Record every file opened for writing (``open`` / ``io.open``) and every
    directory made, apart from the null device."""
    real_open, real_makedirs = builtins.open, os.makedirs

    def spy_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and str(file) != os.devnull:
            seen.append(str(file))
        return real_open(file, mode, *args, **kwargs)

    def spy_makedirs(name, *args, **kwargs):
        seen.append(str(name))
        return real_makedirs(name, *args, **kwargs)

    builtins.open = io.open = spy_open
    os.makedirs = spy_makedirs
    try:
        yield
    finally:
        builtins.open = io.open = real_open
        os.makedirs = real_makedirs


def main(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)  # four ranks share the cores: more threads a rank thrash
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world)
    from probgan_tpu_torch.cli import infer as cli_infer
    from probgan_tpu_torch.cli import train_image as cli_train_image
    from probgan_tpu_torch.engine.image import ImageGANEngine
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.parallel import make_mesh, mesh_group
    from probgan_tpu_torch.parallel.dp_train import dp_progan_train_step, replicate_state
    from probgan_tpu_torch.parallel.sharded_image import dp_generate, dp_score

    with open(f"{work}/inputs.json") as f:
        spec = json.load(f)
    arrays = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}
    trees = torch.load(f"{work}/trees.pt", weights_only=False)
    cfg = pro_gan.ProGANConfig(**spec["config"])
    stage = cfg.num_stages - 1
    mesh = make_mesh(world, device_type="cpu")
    out = {"group_is_world": mesh_group(mesh) is dist.group.WORLD}

    # dp_generate: rank 0's latents on every rank (the others pass other bits)
    z = arrays["z"] if rank == 0 else arrays["z"] + rank
    out["generate"] = dp_generate(mesh, trees["g"], z, cfg, stage).numpy()
    out["generate_indivisible"] = _raises(lambda: dp_generate(mesh, trees["g"], z[:6], cfg, stage))

    # dp_score at alpha 0.7, and the indivisible batch
    out["score"] = dp_score(mesh, trees["d"], arrays["images"], cfg, stage, alpha=0.7).numpy()
    out["score_indivisible"] = _raises(
        lambda: dp_score(mesh, trees["d"], arrays["images"][:6], cfg, stage))

    # the engine over the whole world
    engine = ImageGANEngine(cfg, g_params=trees["g"], d_params=trees["d"], device="cpu",
                            mesh="auto", precision=None)
    out["engine"] = {
        "mesh_size": engine.mesh.size(), "device": str(engine.device),
        "score": engine.score(arrays["images"]), "score3": engine.score(arrays["images"][:3]),
        "walk": engine.latent_walk(arrays["z0"], arrays["z1"], frames=spec["walk_frames"]),
        "generate6": engine.generate(arrays["z"][:6]),
    }

    # dp_progan_train_step without and with R1, a second step chained
    for name, r1 in (("train", 0.0), ("train_r1", spec["r1_gamma"])):
        state = replicate_state(mesh, trees["state"])
        state, m = dp_progan_train_step(mesh, state, arrays["real"], arrays["z"], 0.7, cfg,
                                        stage, 1e-3, r1_gamma=r1)
        _, m2 = dp_progan_train_step(mesh, state, arrays["real"], arrays["z"], 0.7, cfg,
                                     stage, 1e-3, r1_gamma=r1)
        out[name] = {"state": state, "metrics": {k: float(v) for k, v in m.items()},
                     "second": {k: float(v) for k, v in m2.items()}}
    out["train_indivisible"] = _raises(lambda: dp_progan_train_step(
        mesh, trees["state"], arrays["real"][:6], arrays["z"][:6], 0.7, cfg, stage))

    # the CLIs, as torchrun would run them: the same argv on every rank
    for name, argv in spec["cli"].items():
        seen, printed = [], io.StringIO()
        module = cli_infer if name == "infer" else cli_train_image
        with _writes(seen), contextlib.redirect_stdout(printed):
            rc = module.main(argv)
        out[f"cli_{name}"] = {"rc": rc, "writes": seen, "stdout": printed.getvalue()}

    torch.save(out, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
