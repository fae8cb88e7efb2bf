"""Inference engine for the KG-GAN: the five link-prediction tasks.

The port of ``probgan_tpu/engine/inference.py``. Every public method returns
a plain-dict result with the reference's keys and shapes and prints the same
progress banners. As in the JAX package:

- the normalized entity table is computed once at load and cached;
- inputs are padded to power-of-two batch buckets (padding ids are 0 and
  their rows are dropped before the result is built);
- ``analyze_relations`` is one batched discriminator evaluation over the
  (pairs x relations) grid, 256 relations at a time, with the sigmoid and
  the top-k on the device;
- generator noise comes from an explicit per-task stream (core/rng.py).

With ``use_pallas`` (the default unless ``PROBGAN_PALLAS_RANK=0``) the
ranking goes through the fused kernels of ``ops/rank_fused.py`` (top_k <=
16: ``rank_topk``; above: ``rank_scores`` and a stable sort); on the CPU
their wrappers take the plain twins. ``use_pallas=False`` ranks with the
plain ops of ``ops/rank.py`` (``cosine_scores`` then ``top_k_lowest_index``)
on the table's device and launches no kernel. With ``PROBGAN_BF16_RANK=1`` in
the environment when the engine is built, the kernels on, and a table of at
least ``rank_fused.BF16_MIN_N`` entities, the engine also caches a bf16 copy
of the normalized table and the top_k <= 16 path streams that copy
(``rank_topk_bf16``: the stream, then an exact fp32 rescore of k + 16
candidates); opt-in, as in the JAX package.

With a ``mesh`` (``parallel/mesh.py``: a launched world of processes, one a
device) the normalized table is row-sharded over the mesh's ``model`` axis
at load, and ``predict_tails`` and ``find_similar_entities`` rank through
``parallel/sharded_rank.py`` (B4 ``rank_topk_local`` a shard, B7 above
top_k 16; the plain twins on the CPU) with the one-device results; the bf16
stream is not used there, as in the JAX package. The other tasks run
replicated on every rank.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from probgan_tpu_torch.core.checkpoint import load_checkpoint
from probgan_tpu_torch.core.convert import convert_kg_params
from probgan_tpu_torch.core.device import device_str, resolve_device
from probgan_tpu_torch.core.rng import RngStream
from probgan_tpu_torch.models import kg_gan
from probgan_tpu_torch.ops import rank as rank_ops
from probgan_tpu_torch.ops import rank_fused
from probgan_tpu_torch.parallel.mesh import axis_size, rank_device, resolve_mesh
from probgan_tpu_torch.parallel.sharded_rank import shard_entity_table, sharded_rank_topk
from probgan_tpu_torch.utils.profiling import task_trace

_REL_CHUNK = 256   # relations scored per step in analyze_relations


def _rank_scores(pred: torch.Tensor, entity_norm: torch.Tensor,
                 num_entities: int, use_pallas: bool = True) -> torch.Tensor:
    """[B, D] raw predictions -> [B, N] cosine scores against the cached
    normalized table (rows past ``num_entities`` sliced off): the fused
    kernel with ``use_pallas`` (its wrapper raises on a shape it does not
    take), else the plain normalize and product."""
    if use_pallas:
        scores = rank_fused.rank_scores_fused(pred, entity_norm)
    else:
        scores = rank_ops.cosine_scores(rank_ops.l2_normalize(pred), entity_norm)
    return scores[:, :num_entities]


def _rank_topk(pred: torch.Tensor, entity_norm: torch.Tensor, k: int,
               num_entities: int, table_bf16: torch.Tensor | None = None,
               use_pallas: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused path's route with ``use_pallas`` (``rank_fused.rank_topk``:
    one fused rank + top-k within the kernel's bound on k, the [B, N] scores
    never in device memory, else the scores and the stable top k); otherwise
    the plain score + top-k. The same (values, ids) either way, lowest id
    first among ties. ``table_bf16``: the engine's cached bf16 copy of the
    table; the fused path then streams it and rescores its candidates in
    fp32."""
    if use_pallas:
        return rank_fused.rank_topk(pred, entity_norm, k, num_entities, table_bf16=table_bf16)
    return rank_ops.top_k_lowest_index(_rank_scores(pred, entity_norm, num_entities, False), k)


def _bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two batch bucket (a few kernel shapes, not one per n)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pad_ids(ids: Sequence[int], bucket: int) -> np.ndarray:
    arr = np.zeros((bucket,), dtype=np.int64)
    arr[: len(ids)] = np.asarray(ids, dtype=np.int64)
    return arr


def _check_ids(ids, bound: int, kind: str) -> None:
    """Raise on a bad index before it reaches the device, where a gather
    out of range is an asynchronous device-side assert."""
    arr = np.asarray(ids)
    if arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= bound:
        bad = lo if lo < 0 else hi
        raise IndexError(f"{kind} id {bad} out of range [0, {bound})")


# ---------------------------------------------------------------------------
# task functions (pure: tensors in, tensors out, on the inputs' device)
# ---------------------------------------------------------------------------

def _predict_tails_fn(g_params, node_emb, rel_table, heads, rels, z, top_k, rank):
    """gather -> G fwd -> ``rank`` (the engine's: fused rank -> top-k)."""
    pred = kg_gan.generator_apply(g_params, node_emb[heads], rel_table[rels], z)
    return rank(pred, top_k)


def _generator_scores_fn(g_params, node_emb, rel_table, triplets, z):
    """Generator-based triplet scoring: cosine(G(h, r), t)."""
    h = node_emb[triplets[:, 0]]
    r = rel_table[triplets[:, 1]]
    t = node_emb[triplets[:, 2]]
    pred = kg_gan.generator_apply(g_params, h, r, z)
    return rank_ops.cosine_similarity(pred, t)


def _discriminator_scores_fn(d_params, node_emb, rel_table, triplets):
    return kg_gan.discriminator_score_triplets(d_params, node_emb, rel_table, triplets)


def _similar_entities_fn(entity_norm, queries, k_query, rank):
    """Rows of the cached normalized table vs the whole table; k_query =
    min(top_k + 1, N) candidates so the caller can drop the query itself.
    The rows are normalized once more inside the rank kernel, as in the JAX
    package: its scores contain that second normalization."""
    return rank(entity_norm[queries], k_query)


def _analyze_relations_fn(d_params, node_emb, rel_table_padded, pairs, top_k,
                          num_relations):
    """Batched relation analysis.

    pairs [P, 2] int (head_id, tail_id); rel_table_padded [R_pad, D] padded
    to a _REL_CHUNK multiple; rows at or past ``num_relations`` are masked
    out of the top-k. Returns (top_logits, top_probs, top_rel_ids), each
    [P, top_k]; the [P, R_pad] logits stay on the device."""
    h = node_emb[pairs[:, 0]]  # [P, D]
    t = node_emb[pairs[:, 1]]  # [P, D]
    p, d = h.shape
    r_pad = rel_table_padded.shape[0]
    hh = h[:, None, :].expand(p, _REL_CHUNK, d).reshape(-1, d)
    tt = t[:, None, :].expand(p, _REL_CHUNK, d).reshape(-1, d)
    logit_chunks = []
    for start in range(0, r_pad, _REL_CHUNK):
        r_chunk = rel_table_padded[start:start + _REL_CHUNK]
        rr = r_chunk[None, :, :].expand(p, _REL_CHUNK, d).reshape(-1, d)
        logit_chunks.append(
            kg_gan.discriminator_apply(d_params, hh, rr, tt).reshape(p, _REL_CHUNK)
        )
    logits = torch.cat(logit_chunks, dim=1)  # [P, R_pad]
    probs = torch.sigmoid(logits)
    valid = torch.arange(r_pad, device=logits.device) < num_relations
    masked_probs = torch.where(valid, probs, float("-inf"))
    # Sigmoid saturates to exactly 1.0 for large logits, so real ties occur
    # here: the lowest relation id wins them.
    top_probs, top_idx = rank_ops.top_k_lowest_index(masked_probs, top_k)
    return torch.gather(logits, 1, top_idx), top_probs, top_idx


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class InferenceEngine:
    """Loads a checkpoint and serves the five reference inference tasks."""

    def __init__(self, checkpoint_path: str, device: str = "auto", seed: int = 0,
                 use_pallas: bool | None = None, mesh=None):
        """``device``: "auto"/"cuda"/"gpu" (the first card; raises without
        one) or "cpu" (plain twins). ``use_pallas``: rank through the fused
        kernels (True) or the plain ops (False); None means True unless
        ``PROBGAN_PALLAS_RANK=0``. ``mesh``: None, "" or 1 for the one
        device; "auto" for the whole launched world, a device count, or a
        prebuilt DeviceMesh (``parallel/mesh.py``; a mesh that cannot be had
        raises). With a mesh each rank serves from its own device (card
        ``local_rank % device_count``), predict_tails and
        find_similar_entities rank against the table row-sharded over the
        ``model`` axis, whatever ``use_pallas`` says, as in the JAX package."""
        if use_pallas is None:
            use_pallas = os.environ.get("PROBGAN_PALLAS_RANK", "1") != "0"
        self._use_pallas = bool(use_pallas)
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(mesh, device_type=self.device.type)
        if self.mesh is not None:
            self.device = rank_device(self.device.type)
        self.checkpoint_path = checkpoint_path
        self._rng = RngStream(seed)

        print("Loading Prot-B-GAN inference system...")
        print(f"Checkpoint: {checkpoint_path}")
        if self.mesh is not None:
            print(f"Device: mesh of {self.mesh.size()} (data={axis_size(self.mesh, 'data')}, "
                  f"model={axis_size(self.mesh, 'model')})")
        else:
            print(f"Device: {device_str(self.device)}")

        self._load_checkpoint()

        print("Inference ready!")
        print(f"   - Entities: {self.num_entities:,}")
        print(f"   - Relations: {self.num_relations:,}")
        print(f"   - Embedding dim: {self.embed_dim}")

    # -- load ---------------------------------------------------------------

    def _load_checkpoint(self) -> None:
        ckpt = load_checkpoint(self.checkpoint_path)

        saved_args = ckpt.get("args", {}) or {}
        # Defaults match the reference's.
        self.embed_dim = int(saved_args.get("embed_dim", 128))
        self.noise_dim = int(saved_args.get("noise_dim", 64))
        self.hidden_dim = int(saved_args.get("hidden_dim", 1024))

        self.node_emb = self._place(np.asarray(ckpt["node_emb"], np.float32))
        self.rel_table = self._place(np.asarray(ckpt["rel_emb"]["weight"], np.float32))
        self.num_entities = int(self.node_emb.shape[0])
        self.num_relations = int(self.rel_table.shape[0])

        print("Model dimensions from checkpoint:")
        print(f"  - Embed dim: {self.embed_dim}")
        print(f"  - Entities: {self.num_entities:,}")
        print(f"  - Relations: {self.num_relations:,}")

        self.generator_params = convert_kg_params(ckpt["generator"], self.device)
        self.discriminator_params = convert_kg_params(ckpt["discriminator"], self.device)

        # The normalized entity table, cached once. No zero-row padding: the
        # rank kernels take any row count.
        with torch.inference_mode():
            self.entity_norm = rank_ops.l2_normalize(self.node_emb).contiguous()

            # A bf16 copy for the streamed rank kernel (half the bytes of the
            # dominant table scan; its candidates are rescored exactly in
            # fp32). Cast once at load, cached like the normalization.
            # Opt-in, and only for tables where the read is worth halving.
            self.entity_norm_bf16 = None
            if (
                self._use_pallas
                and self.mesh is None
                and os.environ.get("PROBGAN_BF16_RANK", "0") == "1"
                and self.num_entities >= rank_fused.BF16_MIN_N
                and rank_fused.supports_topk_bf16(
                    (1, self.entity_norm.shape[1]), self.num_entities, 1)
            ):
                self.entity_norm_bf16 = self.entity_norm.to(torch.bfloat16)

            # The rank of predict_tails and find_similar_entities, chosen
            # once: the whole table on this device or, with a mesh, this
            # rank's rows of it zero-padded to a multiple of the model axis
            # (the pad rows are masked out by the true entity count).
            if self.mesh is None:
                def rank(queries, k):
                    return _rank_topk(queries, self.entity_norm, k, self.num_entities,
                                      self.entity_norm_bf16, self._use_pallas)
            else:
                self.entity_norm_sharded = shard_entity_table(self.entity_norm, self.mesh)

                def rank(queries, k):
                    return sharded_rank_topk(queries, self.entity_norm_sharded, k, self.mesh,
                                             num_entities=self.num_entities)
            self._rank = rank

            # Pre-pad the relation table for the chunked analyze loop.
            r_pad = -(-self.num_relations // _REL_CHUNK) * _REL_CHUNK
            self._rel_table_padded = torch.zeros(
                (r_pad, self.rel_table.shape[1]), device=self.device
            )
            self._rel_table_padded[: self.num_relations] = self.rel_table

        self.best_val_hit10 = float(ckpt.get("best_val_hit10", 0.0))
        self.best_epoch = int(ckpt.get("best_epoch", 0))
        self.training_history = ckpt.get("training_history", {})

        print("Model performance:")
        print(f"  - Best validation Hit@10: {self.best_val_hit10:.4f}")
        print(f"  - Achieved at epoch: {self.best_epoch}")

    def _place(self, x: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _noise(self, batch: int, task: str) -> torch.Tensor:
        return self._rng.normal(task, (batch, self.noise_dim)).to(self.device)

    # -- tasks ----------------------------------------------------------------

    def predict_tails(
        self,
        head_relation_pairs: List[Tuple[int, int]],
        top_k: int = 10,
        return_scores: bool = False,
    ) -> Dict[str, Any]:
        """Top-k tail prediction."""
        n = len(head_relation_pairs)
        print(f"Predicting top-{top_k} tails for {n} head-relation pairs...")

        if n == 0:
            return {
                "predictions": [],
                "metadata": {
                    "num_queries": 0,
                    "top_k": top_k,
                    "model_hit10": self.best_val_hit10,
                },
                **({"scores": []} if return_scores else {}),
            }

        _check_ids([p[0] for p in head_relation_pairs], self.num_entities, "entity")
        _check_ids([p[1] for p in head_relation_pairs], self.num_relations, "relation")
        bucket = _bucket(n)
        heads = _pad_ids([p[0] for p in head_relation_pairs], bucket)
        rels = _pad_ids([p[1] for p in head_relation_pairs], bucket)
        # top_k 0 gives empty rankings, as the reference's top_k does: the
        # ranking runs at k 1 (the same noise drawn) and is cut to none
        k = top_k or 1
        with task_trace("predict_tails"), torch.inference_mode():
            top_scores, top_indices = _predict_tails_fn(
                self.generator_params,
                self.node_emb,
                self.rel_table,
                self._place(heads),
                self._place(rels),
                self._noise(bucket, "predict_tails"),
                k,
                self._rank,
            )
            top_scores = top_scores[:, :top_k].cpu().numpy()
            top_indices = top_indices[:, :top_k].cpu().numpy()

        results: Dict[str, Any] = {
            "predictions": top_indices[:n].tolist(),
            "metadata": {
                "num_queries": n,
                "top_k": top_k,
                "model_hit10": self.best_val_hit10,
            },
        }
        if return_scores:
            results["scores"] = np.asarray(top_scores[:n], np.float32).tolist()
        return results

    def score_triplets(
        self, triplets: List[Tuple[int, int, int]], method: str = "both"
    ) -> Dict[str, Any]:
        """Generator/discriminator triplet scoring."""
        n = len(triplets)
        print(f"Scoring {n} triplets using {method}...")

        if n == 0:
            results: Dict[str, Any] = {
                "triplets": [],
                "metadata": {
                    "num_triplets": 0,
                    "method": method,
                    "model_hit10": self.best_val_hit10,
                },
            }
            if method in ("generator", "both"):
                results["generator_scores"] = []
            if method in ("discriminator", "both"):
                results["discriminator_logits"] = []
                results["discriminator_probabilities"] = []
            return results

        trip_np = np.asarray(triplets, dtype=np.int64).reshape(n, 3)
        _check_ids(trip_np[:, [0, 2]], self.num_entities, "entity")
        _check_ids(trip_np[:, 1], self.num_relations, "relation")
        bucket = _bucket(n)
        trip = np.zeros((bucket, 3), dtype=np.int64)
        trip[:n] = trip_np
        trip_dev = self._place(trip)

        results: Dict[str, Any] = {
            "triplets": [list(t) for t in triplets],
            "metadata": {
                "num_triplets": n,
                "method": method,
                "model_hit10": self.best_val_hit10,
            },
        }

        with task_trace("score_triplets"), torch.inference_mode():
            if method in ("generator", "both"):
                gen = _generator_scores_fn(
                    self.generator_params,
                    self.node_emb,
                    self.rel_table,
                    trip_dev,
                    self._noise(bucket, "score_triplets"),
                )
                results["generator_scores"] = np.asarray(
                    gen.cpu().numpy()[:n], np.float32
                ).tolist()

            if method in ("discriminator", "both"):
                logits, probs = _discriminator_scores_fn(
                    self.discriminator_params, self.node_emb, self.rel_table, trip_dev
                )
                both = torch.stack([logits, probs]).cpu().numpy()
                results["discriminator_logits"] = np.asarray(
                    both[0, :n], np.float32
                ).tolist()
                results["discriminator_probabilities"] = np.asarray(
                    both[1, :n], np.float32
                ).tolist()

        return results

    def find_similar_entities(
        self, entity_ids: List[int], top_k: int = 10
    ) -> Dict[str, Any]:
        """Embedding-space nearest entities."""
        n = len(entity_ids)
        print(f"Finding top-{top_k} similar entities for {n} query entities...")

        if n == 0:
            return {
                "similar_entities": [],
                "metadata": {
                    "num_queries": 0,
                    "top_k": top_k,
                    "model_hit10": self.best_val_hit10,
                },
            }

        _check_ids(entity_ids, self.num_entities, "entity")
        bucket = _bucket(n)
        queries = _pad_ids(entity_ids, bucket)
        k_query = min(top_k + 1, self.num_entities)
        with task_trace("similar_entities"), torch.inference_mode():
            top_scores, top_indices = _similar_entities_fn(
                self.entity_norm, self._place(queries), k_query, self._rank)
            top_scores = top_scores.cpu().numpy()
            top_indices = top_indices.cpu().numpy()

        results: Dict[str, Any] = {
            "similar_entities": [],
            "metadata": {
                "num_queries": n,
                "top_k": top_k,
                "model_hit10": self.best_val_hit10,
            },
        }
        for i, query_id in enumerate(entity_ids):
            # Host-side self-exclusion, keeping the reference's edge case: if
            # the query is absent from its own top-(k+1), the (k+1)-th entry
            # is dropped.
            idx = top_indices[i]
            val = np.asarray(top_scores[i], np.float32)
            mask = idx != query_id
            results["similar_entities"].append(
                {
                    "query_entity": query_id,
                    "similar_entities": idx[mask][:top_k].tolist(),
                    "similarity_scores": val[mask][:top_k].tolist(),
                }
            )
        return results

    def analyze_relations(
        self, head_ids: List[int], tail_ids: List[int], top_k: int = 5
    ) -> Dict[str, Any]:
        """Most-likely relations per (head, tail) pair, batched on the device."""
        print(
            f"Analyzing relations between {len(head_ids)} heads and "
            f"{len(tail_ids)} tails..."
        )

        pairs = [(h, t) for h in head_ids for t in tail_ids]
        if not pairs:
            return {
                "relation_analysis": [],
                "metadata": {
                    "num_head_entities": len(head_ids),
                    "num_tail_entities": len(tail_ids),
                    "top_k": top_k,
                    "model_hit10": self.best_val_hit10,
                },
            }
        _check_ids(head_ids, self.num_entities, "entity")
        _check_ids(tail_ids, self.num_entities, "entity")
        bucket = _bucket(len(pairs))
        pair_arr = np.zeros((bucket, 2), dtype=np.int64)
        pair_arr[: len(pairs)] = np.asarray(pairs, dtype=np.int64)

        k = min(top_k, self.num_relations)
        with task_trace("analyze_relations"), torch.inference_mode():
            top_logits, top_probs, top_rels = _analyze_relations_fn(
                self.discriminator_params,
                self.node_emb,
                self._rel_table_padded,
                self._place(pair_arr),
                k or 1,  # top_k 0: no relation listed, as the reference
                self.num_relations,
            )
            top_logits = top_logits.cpu().numpy()
            top_probs = top_probs.cpu().numpy()
            top_rels = top_rels.cpu().numpy()

        results: Dict[str, Any] = {
            "relation_analysis": [],
            "metadata": {
                "num_head_entities": len(head_ids),
                "num_tail_entities": len(tail_ids),
                "top_k": top_k,
                "model_hit10": self.best_val_hit10,
            },
        }
        for i, (head_id, tail_id) in enumerate(pairs):
            top_relations = [
                {
                    "relation_id": int(top_rels[i][j]),
                    "discriminator_score": float(np.float32(top_logits[i][j])),
                    "probability": float(np.float32(top_probs[i][j])),
                }
                for j in range(k)
            ]
            results["relation_analysis"].append(
                {
                    "head_entity": head_id,
                    "tail_entity": tail_id,
                    "top_relations": top_relations,
                }
            )
        return results

    def get_model_info(self) -> Dict[str, Any]:
        """Static model card. With a mesh, ``device`` gives the mesh's shape
        instead of one device."""
        if self.mesh is not None:
            device = (f"mesh(data={axis_size(self.mesh, 'data')},"
                      f"model={axis_size(self.mesh, 'model')})")
        else:
            device = device_str(self.device)
        return {
            "model_architecture": {
                "embedding_dim": self.embed_dim,
                "noise_dim": self.noise_dim,
                "hidden_dim": self.hidden_dim,
                "num_entities": self.num_entities,
                "num_relations": self.num_relations,
            },
            "training_performance": {
                "best_validation_hit10": self.best_val_hit10,
                "best_epoch": self.best_epoch,
            },
            "checkpoint_path": self.checkpoint_path,
            "device": device,
        }
