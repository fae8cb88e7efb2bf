"""The sharded pieces of the KG train step: entity-table rows over "model".

The JAX package writes none of this math itself: its
``parallel/dp_train.py:shard_kg_state`` only places the table and its Adam
moments row-sharded, and GSPMD partitions the jitted ``kg_train_step`` /
``kg_eval_hits`` by itself (it gathers the batch's rows, splits the [B, N]
softmax and sums the rows' gradient scatter). Here that math is spelled
out, so that its result is, up to the order of float sums, the one-device
step on the whole batch: the contract the tests hold it to.

Rank ``i`` of a model group holds rows ``[i * local_n, i * local_n +
nvalid)`` of the [N, D] table, ``local_n = ceil(N / tp)``, the last shard
padded with zero rows (``sharded_rank.py:row_shard``, the split of
``shard_entity_table``, so a table trained on a mesh has the layout
``InferenceEngine(mesh=)`` serves). Every other tensor of the step
is the same on every rank of the group: the batch's rows, the networks and
their outputs. A run builds its ``KGMesh`` once (``kg_mesh``): where the
rows lie and the groups of the two axes, which ``kg_train_step`` and
``kg_eval_hits`` take as ``mesh=``. Its ``collect`` is the way back to the
whole table, on the saving rank's host alone.

Two autograd Functions carry the collectives over "model":

- ``_SumOverModel``: sum forward, identity backward. It combines partial
  results (the owner's rows and zeros elsewhere; each shard's softmax sum)
  into a value whose downstream loss is the same on every rank of the
  group, so each rank's upstream gradient already is the whole gradient of
  its part. ``torch.distributed.nn.functional.all_reduce`` sums the
  upstream gradients again in its backward, which would scale every table
  row's gradient by tp.
- ``_CopyToModel``: identity forward, sum backward. A replicated input (the
  normalized prediction) that each rank multiplies by its own rows only
  gets a part of its gradient on each rank; the parts are summed.

The shard is a plain local tensor, not a ``DTensor``: indexing a
``Shard(0)`` DTensor by entity ids may redistribute it to ``Replicate``,
which would gather the whole table every step. Here a step moves the
batch's rows (B x D floats a lookup) and a few [B] vectors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from probgan_tpu_torch.ops import rank as rank_ops
from probgan_tpu_torch.parallel.mesh import axis_size
from probgan_tpu_torch.parallel.sharded_rank import RowShard, row_shard


_CHUNK = 1 << 24  # elements a message of ``KGMesh.collect``: 64 MiB of fp32


class KGMesh(NamedTuple):
    """A KG step's view of its (data, model) mesh, built once a run
    (``kg_mesh``): where this rank's rows of the N-row table lie and the
    process groups of the two axes. ``kg_train_step`` and ``kg_eval_hits``
    take it as ``mesh=``."""

    rows: RowShard
    model: dist.ProcessGroup
    data: dist.ProcessGroup
    dp: int         # the data axis's size
    data_rank: int  # this rank's index along it

    def require_shard(self, shard: torch.Tensor) -> None:
        """Raise ValueError, before any collective, unless ``shard`` has
        this rank's row count of the table."""
        if shard.shape[0] != self.rows.local_n:
            raise ValueError(f"a table of {shard.shape[0]} rows is not this rank's shard of "
                             f"{self.rows.num_entities} rows ({self.rows.local_n}): place the "
                             "state with parallel/dp_train.py:shard_kg_state")

    def take(self, shard: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return lookup(shard, ids, self.rows, self.model)

    def rank_ce(self, pred, shard, t_idx, temperature: float) -> torch.Tensor:
        return rank_ce(pred, shard, t_idx, self.rows, self.model, temperature)

    def count_above(self, pred, shard, t_idx) -> torch.Tensor:
        return count_above(pred, shard, t_idx, self.rows, self.model)

    def collect(self, shard: torch.Tensor, dst: int) -> torch.Tensor | None:
        """The whole table [N, ...] (padding dropped) on the CPU of world
        rank ``dst``, None on every other rank. Each shard's owner in
        ``dst``'s model group sends its valid rows to ``dst`` a chunk of
        ``_CHUNK`` elements at a time, and ``dst`` copies each chunk to the
        host: no rank holds more of the table on its device than its shard
        and one chunk. Over NCCL alone a chunk goes card to card; any other
        backend gets it staged through the host. Every rank of ``dst``'s
        model group calls it; the other ranks may."""
        me, tp = dist.get_rank(), dist.get_world_size(self.model)
        if dst not in dist.get_process_group_ranks(self.model):
            return None
        wire = shard.device if dist.get_backend(self.model) == "nccl" else torch.device("cpu")
        row_shape, n, local_n = shard.shape[1:], self.rows.num_entities, self.rows.local_n
        step = max(1, _CHUNK // max(1, shard[0].numel()))
        out = buf = None
        if me == dst:
            out = torch.empty((n, *row_shape), dtype=shard.dtype)
            buf = torch.empty((min(step, local_n), *row_shape), dtype=shard.dtype, device=wire)
        for i in range(tp):
            src = dist.get_global_rank(self.model, i)
            if me not in (src, dst):
                continue
            lo = i * local_n
            nvalid = min(max(n - lo, 0), local_n)  # shard i's, whichever rank this is
            for a in range(0, nvalid, step):
                b = min(a + step, nvalid)
                if me == src == dst:
                    out[lo + a:lo + b] = shard[a:b]
                elif me == src:
                    dist.send(shard[a:b].to(wire).contiguous(), dst, group=self.model)
                else:  # one receive buffer, reused: one chunk on dst's card at a time
                    dist.recv(buf[:b - a], src, group=self.model)
                    out[lo + a:lo + b] = buf[:b - a]
        return out


def kg_mesh(mesh: DeviceMesh, num_entities: int) -> KGMesh:
    """The ``KGMesh`` of a table of ``num_entities`` rows on ``mesh``."""
    return KGMesh(row_shard(mesh, int(num_entities)), mesh.get_group("model"),
                  mesh.get_group("data"), axis_size(mesh, "data"), mesh.get_local_rank("data"))


class _SumOverModel(torch.autograd.Function):
    """Sum over the group forward; the identity backward (module docstring:
    the loss downstream is the same on every rank, so each rank's upstream
    gradient is already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the sum over the group backward (module
    docstring: each rank's part of a replicated input's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _owned(ids: torch.Tensor, rows: RowShard) -> tuple[torch.Tensor, torch.Tensor]:
    """(a mask of the ids this shard owns, their local rows clamped into the
    shard for the ids it does not own)."""
    local = ids - rows.offset
    own = (local >= 0) & (local < rows.nvalid)
    return own, local.clamp(0, rows.local_n - 1)


def lookup(shard: torch.Tensor, ids: torch.Tensor, rows: RowShard, group) -> torch.Tensor:
    """``table[ids]`` [len(ids), D] on every rank of ``group``: each rank
    takes the rows it owns and zeros elsewhere, and a sum over the group
    combines them (each row comes from its owner alone: the one-device rows
    bit for bit). Backward, each row's gradient lands on its owner's shard,
    repeated ids accumulating."""
    own, local = _owned(ids, rows)
    part = torch.where(own[:, None], shard[local], torch.zeros((), dtype=shard.dtype,
                                                               device=shard.device))
    return _SumOverModel.apply(part, group)


def _local_scores(pred: torch.Tensor, shard: torch.Tensor, rows: RowShard) -> tuple:
    """(cosines [B, local_n] of the normalized ``pred`` against this shard's
    normalized rows, the mask of its valid rows [local_n])."""
    scores = rank_ops.cosine_scores(pred, rank_ops.l2_normalize(shard))
    return scores, torch.arange(rows.local_n, device=shard.device) < rows.nvalid


def rank_ce(pred: torch.Tensor, shard: torch.Tensor, t_idx: torch.Tensor, rows: RowShard,
            group, temperature: float) -> torch.Tensor:
    """``engine/train.py:_rank_ce`` over a row-sharded table: the mean over
    the batch of the full-softmax cross-entropy of ``cosine / temperature``
    against the true tail. Each rank scores its valid rows (padding -inf);
    the row maxima are taken over the group (detached: they cancel in the
    gradient), the sums of exponentials summed over it, and the true tail's
    logit comes from its owner's own score matrix."""
    pred_n = _CopyToModel.apply(rank_ops.l2_normalize(pred), group)
    scores, valid = _local_scores(pred_n, shard, rows)
    logits = (scores / temperature).masked_fill(~valid, float("-inf"))
    top = logits.detach().amax(dim=1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    total = _SumOverModel.apply(torch.exp(logits - top[:, None]).sum(dim=1), group)
    own, local = _owned(t_idx, rows)
    true = torch.where(own, logits.gather(1, local[:, None])[:, 0],
                       torch.zeros((), dtype=logits.dtype, device=logits.device))
    return (torch.log(total) + top - _SumOverModel.apply(true, group)).mean()


def count_above(pred: torch.Tensor, shard: torch.Tensor, t_idx: torch.Tensor, rows: RowShard,
                group) -> torch.Tensor:
    """For each row, the number of entities whose cosine with ``pred`` is
    strictly above the true tail's, over the whole table (int64 [B]). The
    true tail's cosine comes from its owner's own product, never from a
    second dot product that could round it another way."""
    scores, valid = _local_scores(rank_ops.l2_normalize(pred), shard, rows)
    own, local = _owned(t_idx, rows)
    true = torch.where(own, scores.gather(1, local[:, None])[:, 0],
                       torch.zeros((), dtype=scores.dtype, device=scores.device))
    dist.all_reduce(true, group=group)
    above = ((scores > true[:, None]) & valid).sum(dim=1)
    dist.all_reduce(above, group=group)
    return above
