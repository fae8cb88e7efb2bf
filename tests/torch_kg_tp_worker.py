"""One rank of ``tests/test_torch_kg_tp.py``'s gloo world, on the CPU.

    python tests/torch_kg_tp_worker.py RANK WORLD DIR

Joins a gloo group through the ``file://`` rendezvous ``DIR/rendezvous``,
reads the cases the test wrote (``DIR/inputs.json``, the states and batches
in ``DIR/inputs.pt``), runs each through the port's row-sharded KG path on
a (2, 2) and a (1, 4) mesh of the one world, then the trainer CLI with
``--mesh auto``, and writes what it got to ``DIR/rank{RANK}.pt``. Imports
no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import torch
import torch.distributed as dist

from tests.torch_dp_worker import _raises, _writes


def _table_at(state, tree_leaves) -> list[int]:
    """The places of the table and its two Adam moments among the leaves."""
    table = {id(state.node_emb), id(state.g_opt[0].mu[1]), id(state.g_opt[0].nu[1])}
    return [i for i, x in enumerate(tree_leaves(state)) if id(x) in table]


@contextlib.contextmanager
def _chunk_rows(rows: int, width: int):
    """``gather_kg_state`` sending ``rows`` rows of ``width`` a message."""
    from probgan_tpu_torch.parallel import sharded_kg

    saved, sharded_kg._CHUNK = sharded_kg._CHUNK, rows * width
    try:
        yield
    finally:
        sharded_kg._CHUNK = saved


def _placement(mesh, kg, state, shard_kg_state, gather_kg_state, tree_leaves) -> dict:
    """Where ``shard_kg_state`` put each leaf: the table and its two moments
    this rank's rows (zero-padded), every other leaf whole; and what
    ``gather_kg_state`` gives, three rows a message: the state bit for bit
    on the CPU of rank 0 (True), None on the other ranks."""
    rows = kg.rows
    sharded = shard_kg_state(mesh, state)

    def is_rows(got, full):
        want = torch.zeros((rows.local_n, *full.shape[1:]))
        want[:rows.nvalid] = full[rows.offset:rows.offset + rows.nvalid]
        return got.shape == want.shape and torch.equal(got, want)

    table = [(sharded.node_emb, state.node_emb)]
    table += [(getattr(sharded.g_opt[0], m)[1], getattr(state.g_opt[0], m)[1])
              for m in ("mu", "nu")]
    table_ids = {id(got) for got, _ in table}
    others = [(a, b) for a, b in zip(tree_leaves(sharded), tree_leaves(state))
              if id(a) not in table_ids]
    with _chunk_rows(3, state.node_emb.shape[1]):  # several chunks a shard, the last short
        back = gather_kg_state(kg, sharded)
    return {
        "rows": list(rows),
        "table_rows": [is_rows(got, full) for got, full in table],
        "others_whole": all(torch.equal(a, b) for a, b in others),
        "n_others": len(others),
        "gathered": None if back is None else all(
            torch.equal(a, b) and a.device.type == "cpu"
            for a, b in zip(tree_leaves(back), tree_leaves(state))),
    }


def _spy_gathers(dp_train, tree_leaves) -> list:
    """Wrap ``dp_train.gather_kg_state`` (the trainer imports it when it
    starts) to record, for each call, the rows of the table leaves a rank
    held and the rows and devices of what it got back."""
    real, calls = dp_train.gather_kg_state, []

    def spy(kg, state, dst=0):
        whole = real(kg, state, dst)
        calls.append({
            "held_rows": [tree_leaves(state)[i].shape[0] for i in _table_at(state, tree_leaves)],
            "whole_rows": None if whole is None else whole.node_emb.shape[0],
            "whole_devices": None if whole is None else sorted(
                {x.device.type for x in tree_leaves(whole)})})
        return whole

    dp_train.gather_kg_state = spy
    return calls


def main(rank: int, world: int, work: str) -> None:
    torch.set_num_threads(1)  # four ranks share the cores: more threads a rank thrash
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world)
    from probgan_tpu_torch.cli import train as cli_train
    from probgan_tpu_torch.core.tree import tree_leaves
    from probgan_tpu_torch.engine import train as train_mod
    from probgan_tpu_torch.parallel import dp_train, make_mesh
    from probgan_tpu_torch.parallel.dp_train import (
        gather_kg_state,
        kg_batch_sharding,
        shard_kg_state,
    )
    from probgan_tpu_torch.parallel.mesh import axis_size
    from probgan_tpu_torch.parallel.sharded_kg import kg_mesh

    with open(f"{work}/inputs.json") as f:
        spec = json.load(f)
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    out = {"placement": {}, "steps": {}}
    for tp in spec["tps"]:
        mesh = make_mesh(world, model_parallelism=tp, device_type="cpu")
        dp, data_rank = axis_size(mesh, "data"), mesh.get_local_rank("data")
        rows = kg_batch_sharding(mesh)
        for n in spec["entities"]:
            state, kg = inputs["states"][str(n)], kg_mesh(mesh, n)
            out["placement"][f"tp{tp}_N{n}"] = _placement(
                mesh, kg, state, shard_kg_state, gather_kg_state, tree_leaves)
            for variant in spec["variants"]:
                sharded, metrics = shard_kg_state(mesh, state), []
                for step in inputs["steps"][str(n)]:
                    sharded, m = train_mod.kg_train_step(
                        sharded, rows(step["triplets"]), lr=spec["lr"],
                        negatives=rows(step["negatives"]),
                        ce_negatives=step["ce"] if variant == "sampled" else None,
                        z=step["z"], mesh=kg)
                    metrics.append({k: float(v) for k, v in m.items()})
                ev = inputs["eval"][str(n)]
                hits = float(train_mod.kg_eval_hits(
                    sharded.g_params, sharded.node_emb, sharded.rel_emb,
                    torch.tensor_split(ev["triplets"], dp)[data_rank],
                    torch.tensor_split(ev["z"], dp)[data_rank], 10, mesh=kg))
                out["steps"][f"tp{tp}_N{n}_{variant}"] = {
                    "state": gather_kg_state(kg, sharded), "local": sharded,
                    "table_at": _table_at(sharded, tree_leaves), "metrics": metrics,
                    "hits": hits}
        step = inputs["steps"][str(spec["entities"][0])][0]
        out[f"tp{tp}_indivisible"] = _raises(lambda: rows(step["triplets"][:3]))
        out[f"tp{tp}_unplaced"] = _raises(lambda: train_mod.kg_train_step(
            state, rows(step["triplets"]), z=step["z"], mesh=kg))

    # the trainer CLI, as torchrun would run it: the same argv on every rank
    gathers = _spy_gathers(dp_train, tree_leaves)
    for name, argv in spec["cli"].items():
        seen, printed = [], io.StringIO()
        with _writes(seen), contextlib.redirect_stdout(printed):
            rc = cli_train.main(argv)
        out[f"cli_{name}"] = {"rc": rc, "writes": seen, "stdout": printed.getvalue()}
        out[f"cli_{name}_gathers"], gathers[:] = list(gathers), []

    torch.save(out, f"{work}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
