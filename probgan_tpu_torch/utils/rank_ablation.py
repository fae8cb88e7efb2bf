"""What the parts of the ``rank_topk`` kernel cost on the card.

Builds variants of ``csrc/rank_topk.cu`` (over ``csrc/rank_ring.cuh``) in a
temporary directory, each with one part of the kernel taken out by a source
substitution, and times them at the KG path's shape (N = 1,000,000 rows,
D = 128, B = 64 and 8) for k = 1, 10 and 16, beside ``rank_scores`` (B7, the
same walk storing its scores) launched alone:

    python -m probgan_tpu_torch.utils.rank_ablation

- ``base``: the kernel as shipped, at ``scores_tiling``'s tiling;
- ``tiles64x2`` / ``tiles128x1``: the same kernel at the other tiling
  (64-row tiles in 2 stages, two blocks an SM; 128-row tiles in 3 stages,
  one block an SM);
- ``no_filter``: every query of the warp takes the exact pass on every tile
  (one shared load, compare and ballot per 32 scores), as if the filter had
  found a candidate for each;
- ``no_select``: the filter finds no candidate, so the exact pass and the
  top-k insertions are gone (the filter's loads, maxima and one OR a tile
  stay);
- ``no_product``: the tensor-core product is gone (every score 0), so what
  is left is streaming the table through the ring and the selection.

The variants compute wrong results on purpose: this script measures, it
checks nothing. Then, for the bf16 stream (``rank_topk_fused(table_bf16=...)``)
as shipped, at B = 64 and B = 8 with k = 10: the ``rank_topk_bf16`` stream
alone, and built without its selection (no survivor inserted into a pool),
the plain twin's merge of the blocks' pools (a stable sort over
[B, n_blocks * 26]) and its exact rescore of the 26 survivors, the merge
kernel that replaces both, and the whole call beside the fp32 call. Prints
one line per variant and part and one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from probgan_tpu_torch.ops import _build, rank_fused
from probgan_tpu_torch.ops.rank import l2_normalize

N, D, B = 1_000_000, 128, 64
BATCHES = (64, 8)
KS = (1, 10, 16)
SOURCES = ("rank_tile.cuh", "rank_ring.cuh", "tf32x3.cuh", "rank_topk.cu")
# name -> (tiling (rows a tile, blocks per SM) or None for scores_tiling's,
# [(source text, replacement), ...])
VARIANTS = {
    "base": (None, []),
    "tiles64x2": ((64, 2), []),
    "tiles128x1": ((128, 1), []),
    "no_filter": (None, [(
        "if (best > thr[i]) hits |= 1u << i;", "hits |= 1u << i;")]),
    "no_select": (None, [(
        "if (best > thr[i]) hits |= 1u << i;", "if (best > 1e30f) hits |= 1u << i;")]),
    "no_product": (None, [(
        "for (int ks = 0; ks < nk && n_nt > 0; ks += 2) {",
        "for (int ks = 0; ks < 0; ks += 2) {")]),
}


# The bf16 stream without its selection: no survivor is ever inserted into a
# pool (thread pools at B = 64, warp pools at B = 8), the rest as shipped.
BF16_NO_SELECT = [("          while (mask) {", "          while (false) {"),
                  ("        while (any) {", "        while (false) {")]


def build_variant(name: str, subs: list, workdir: Path, source: str = "rank_topk.cu"):
    """Compile a variant of ``source`` (rank_topk.cu or rank_topk_bf16.cu);
    returns (library, registers of its last kernel as ptxas reports them)."""
    src_dir = workdir / name
    src_dir.mkdir()
    left = {old for old, _ in subs}
    for fname in (*SOURCES, "async_copy.cuh", source):
        text = (_build.CSRC / fname).read_text()
        for old, new in subs:
            if old in text:
                text = text.replace(old, new)
                left.discard(old)
        (src_dir / fname).write_text(text)
    if left:
        raise RuntimeError(f"{name}: source text not found: {sorted(left)}")
    lib_path = src_dir / f"{name}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(src_dir),
         "-o", str(lib_path), str(src_dir / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    registers = [line.split("Used")[1].split(",")[0].strip()
                 for line in proc.stderr.splitlines() if "Used" in line]
    lib = ctypes.CDLL(str(lib_path))
    kernel = source.removesuffix(".cu")
    fn = getattr(lib, f"probgan_{kernel}")
    fn.argtypes = rank_fused._ARGTYPES[kernel]
    fn.restype = ctypes.c_int
    return lib, registers[-1] if registers else "?"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_parts(table: torch.Tensor, gen: torch.Generator, workdir: Path,
               k: int = 10) -> dict:
    """Times (ms) of the parts of the bf16 path, by batch size."""
    from probgan_tpu_torch.ops.rank import top_k_lowest_index

    table_bf16 = table.to(torch.bfloat16)
    m = k + rank_fused.BF16_RESCORE_POOL
    no_select, _ = build_variant("bf16_no_select", BF16_NO_SELECT, workdir,
                                 "rank_topk_bf16.cu")
    out = {}
    for b in (B, 8):
        pred = torch.randn((b, D), device=table.device, generator=gen)
        cand_v, cand_i = rank_fused.pool_candidates_bf16(pred, table_bf16, m, N, True)
        tiles_per_block, n_blocks = rank_fused._geometry(N, table.device,
                                                         rank_fused.BF16_BLOCKS_PER_SM)
        spare_v, spare_i = torch.empty_like(cand_v), torch.empty_like(cand_i)

        def stream_without_selection():
            err = no_select.probgan_rank_topk_bf16(
                pred.data_ptr(), table_bf16.data_ptr(), table.data_ptr(), spare_v.data_ptr(),
                spare_i.data_ptr(), 0, 0, b, D, N, m, 1, 1, tiles_per_block, n_blocks, 1,
                torch.cuda.current_stream(table.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"bf16_no_select: launch failed with CUDA error {err}")

        pool_v, pos = top_k_lowest_index(cand_v, m)
        pool_ids = torch.gather(cand_i, 1, pos)
        pred_norm = l2_normalize(pred)
        row = {
            "candidates_per_query": cand_v.shape[1],
            "kernel_ms": cuda_ms(
                lambda: rank_fused.pool_candidates_bf16(pred, table_bf16, m, N, True)),
            "kernel_without_selection_ms": cuda_ms(stream_without_selection),
            "merge_sort_ms": cuda_ms(lambda: top_k_lowest_index(cand_v, m)),
            "rescore_ms": cuda_ms(
                lambda: rank_fused.rescore_pool(pred_norm, table, pool_v, pool_ids, k)),
            "merge_kernel_ms": cuda_ms(
                lambda: rank_fused.merge_rescore_bf16(cand_v, cand_i, pred, table, k, m)),
            "whole_bf16_call_ms": cuda_ms(
                lambda: rank_fused.rank_topk_fused(pred, table, k, N, table_bf16=table_bf16)),
            "whole_fp32_call_ms": cuda_ms(lambda: rank_fused.rank_topk_fused(pred, table, k, N)),
        }
        out[f"B{b}"] = row
        print(f"bf16 stream B={b:2d}: " + "  ".join(
            f"{name} {value:.3f}" if isinstance(value, float) else f"{name} {value}"
            for name, value in row.items()), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("rank_ablation: torch.cuda.is_available() is False")
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    table = l2_normalize(torch.randn((N, D), device=device, generator=gen))
    preds = {b: torch.randn((b, D), device=device, generator=gen) for b in BATCHES}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream

    results = {}
    scores_alone = {}
    for b, pred in preds.items():
        out = torch.empty((b, N), device=device)
        scores_alone[f"B{b}"] = cuda_ms(lambda: rank_fused.launch_rank_scores(pred, table, out))
        del out
    print(f"rank_scores alone: {scores_alone}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (tiling, subs) in VARIANTS.items():
            lib, registers = build_variant(name, subs, Path(tmp))
            row = {"registers": registers}
            for b, pred in preds.items():
                tile_rows, blocks_per_sm = tiling or rank_fused.scores_tiling(b, D)
                tiles_per_block, n_blocks = rank_fused.tile_runs(N, tile_rows,
                                                                 blocks_per_sm * sms)
                row[f"B{b}_tiling"] = [tile_rows, blocks_per_sm, n_blocks]
                for k in KS:
                    cand_v = torch.empty((b, n_blocks * k), device=device)
                    cand_i = torch.empty((b, n_blocks * k), device=device, dtype=torch.int32)

                    def launch():
                        err = lib.probgan_rank_topk(
                            pred.data_ptr(), table.data_ptr(), cand_v.data_ptr(),
                            cand_i.data_ptr(), b, D, N, k, 1, tile_rows, tiles_per_block,
                            n_blocks, stream)
                        if err != 0:
                            raise RuntimeError(f"{name}: launch failed with CUDA error {err}")

                    row[f"B{b}_k{k}_ms"] = cuda_ms(launch)
            results[name] = row
            print(f"{name:12s} {registers:14s} " + "  ".join(
                f"{key} {value:.3f}" if isinstance(value, float) else f"{key} {value}"
                for key, value in row.items() if key != "registers"), flush=True)
        bf16 = bf16_parts(table, gen, Path(tmp))
    print(json.dumps({"shape": {"N": N, "D": D, "B": list(BATCHES)}, "variants": results,
                      "rank_scores_alone_ms": scores_alone, "bf16_parts_ms": bf16,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
