"""One rank of ``tests/test_torch_parallel.py``'s gloo world, on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD DIR

Joins a gloo group through the ``file://`` rendezvous ``DIR/rendezvous``,
reads the cases ``DIR/inputs.npz`` and ``DIR/inputs.json`` that the test
wrote, runs each through the port's parallel path and writes what it got to
``DIR/rank{RANK}.npz`` and ``DIR/rank{RANK}.json``. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def main(rank: int, world: int, work: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world)
    from probgan_tpu_torch.cli import infer as cli_infer
    from probgan_tpu_torch.engine import InferenceEngine
    from probgan_tpu_torch.ops import rank_fused
    from probgan_tpu_torch.parallel import make_mesh, resolve_mesh, sharded_rank_topk
    from probgan_tpu_torch.parallel.sharded_rank import shard_entity_table

    with open(f"{work}/inputs.json") as f:
        spec = json.load(f)
    arrays = np.load(f"{work}/inputs.npz")
    out_arrays, out = {}, {}

    # meshes: the default split, pure DP / TP, the specs, the axis names
    shapes = {}
    for label, kwargs in (("default", {}), ("dp", {"model_parallelism": 1}),
                          ("tp", {"model_parallelism": world})):
        mesh = make_mesh(world, device_type="cpu", **kwargs)
        shapes[label] = [list(mesh.mesh_dim_names), list(mesh.shape)]
    auto = resolve_mesh("auto", device_type="cpu")
    shapes["auto"] = [list(auto.mesh_dim_names), list(auto.shape)]
    shapes["count"] = list(resolve_mesh(world, device_type="cpu").shape)
    shapes["prebuilt"] = resolve_mesh(auto) is auto
    shapes["two_of_four"] = _raises(lambda: resolve_mesh("2", device_type="cpu"))
    shapes["other_names"] = _raises(lambda: resolve_mesh(
        init_device_mesh("cpu", (world,), mesh_dim_names=("x",))))
    out["meshes"] = shapes

    # sharded_rank_topk at each case's tp; counted calls of the shard kernels
    calls = []
    real_local = rank_fused.rank_topk_local

    def spy(q, shard, k, nvalid, **kwargs):
        calls.append((k, nvalid))
        return real_local(q, shard, k, nvalid, **kwargs)

    rank_fused.rank_topk_local = spy
    for case in spec["cases"]:
        name, tp = case["name"], case["tp"]
        mesh = make_mesh(world, model_parallelism=tp, device_type="cpu")
        shard = shard_entity_table(torch.from_numpy(arrays[f"{name}.table"]), mesh)
        calls.clear()
        v, i = sharded_rank_topk(torch.from_numpy(arrays[f"{name}.query"]), shard, case["k"],
                                 mesh, num_entities=case["n"])
        out_arrays[f"{name}.values"], out_arrays[f"{name}.ids"] = v.numpy(), i.numpy()
        out[name] = {"shard_rows": shard.shape[0], "local_calls": list(calls)}
    rank_fused.rank_topk_local = real_local
    # k above the true N (9 rows over tp 2, top_k 10) is refused on every rank
    mesh = make_mesh(world, model_parallelism=2, device_type="cpu")
    shard = shard_entity_table(torch.from_numpy(arrays["uneven9_tp4.table"]), mesh)
    out["k_above_n"] = _raises(lambda: sharded_rank_topk(
        torch.from_numpy(arrays["uneven9_tp4.query"]), shard, 10, mesh, num_entities=9))

    # the engine and the CLI over the whole world, the noise replayed
    noise = [arrays[f"noise.{j}"] for j in range(spec["noise_draws"])]

    def replay(self, batch, task):
        return torch.from_numpy(noise.pop(0))

    InferenceEngine._noise = replay
    engine = InferenceEngine(spec["checkpoint"], device="cpu", seed=0, mesh="auto")
    out["engine"] = {
        "device": engine.get_model_info()["device"],
        "sharded_rows": engine.entity_norm_sharded.shape[0],
        "bf16": engine.entity_norm_bf16 is None,
        "results": [engine.predict_tails(spec["pairs"], top_k=k, return_scores=True)
                    for k in spec["top_ks"]]
        + [engine.find_similar_entities(spec["entities"], top_k=k) for k in spec["top_ks"]],
    }
    for task, argv in spec["cli"].items():
        cli_infer.main(argv + ["--output_file", f"{work}/cli_{task}.json"])
    np.savez(f"{work}/rank{rank}.npz", **out_arrays)
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.stdout = open(os.devnull, "w")  # the engines' banners
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
