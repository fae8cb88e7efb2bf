#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``probgan_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every kernel from ``probgan_tpu_torch/csrc`` with nvcc
   (one process per source, all at once), with ptxas's register report; the
   pipelined bf16 loop of B1/B2/B3/B5 (``csrc/bf16_ring.cuh``) as compiled:
   its stages, bytes a block and resident blocks an SM at each width and
   term count (equal to ``ops/packed.py``'s figures: one block an SM), and
   the four kernels' registers and spill bytes (B3's at each of its 16
   instantiations, none spilling), with B5's fp32 ring's (``ConvPoolRing``)
   beside them;
2. each late-stage generator kernel at the shapes the 1024² generator gives
   it (batch 2), held against its plain PyTorch twin on the card with TF32
   off: fp32 outputs to atol = rtol = 1e-4, uint8 outputs within +-1 on at
   most 0.5% of bytes; ``packed_upconv``, ``packed_conv`` and
   ``packed_conv_rgb`` (the fp32 ring kernels, one fixed order of sums)
   bit-equal over two runs on one input; ``packed_conv_rgb`` at stage 8 (32
   channels, 1024²) and stage 7 (64, 512²), uint8 and fp32 each.
   Times (CUDA events, after warm-up) of the kernel's
   wrapper, the plain twin and a cuDNN-based yardstick the port never calls,
   beside the kernel's bound on an H100 (67 TFLOP/s fp32, 3.35 TB/s);
3. the image main path: ``ImageGANEngine(ProGANConfig(), device="cuda",
   precision="high").generate`` on batches of 8 latents at 1024². The launch
   counts must move 2/1/1 per call; the output must be uint8 [8,1024,1024,3]
   and agree (PSNR >= 50 dB, +-1 on at most 0.5% of bytes) with the same
   engine run with each kernel's plain twin in its place on the card, and
   with the unpacked path on the card; so must fade-in renders at stage 7
   (alpha 0.5) and stage 8 (alpha 0.3); for one image, the output must agree
   with the plain path on the CPU (PSNR >= 50 dB). Prints img/s and p50
   ms/img;
4. the discriminator's kernels at path I's shapes (batch 2): ``packed_conv``
   with the "lrelu" epilogue at 32 channels / 1024² and 64 / 512²,
   ``packed_convpool`` 32 -> 64 at 1024² and 64 -> 128 at 512², each against
   its plain twin (atol = rtol = 1e-4) with the "none" epilogues checked
   once. ``packed_conv`` "lrelu" bit-equal over two runs, and pooled 2x2 as
   ``packed_convpool`` pools (0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 +
   a11)), torch ops) equal, bit for bit, to ``packed_convpool`` "lrelu" on
   the same x, w, b (0 differing values): at the conv1 shapes (Cout = C) and
   at the conv2 shapes, which are ``convpool_lrelu``'s mask recompute
   (``RECOMPUTE_SHAPES``, timed as calls of the "lrelu" entry);
   ``to_uint8_fused`` at [8, 1024, 1024, 3] (equal bytes, or +-1 only
   where the denorm value lies within 1e-3 of a half) and at element counts
   that are no multiple of 4. Yardsticks: ``F.conv2d`` + ``F.leaky_relu``
   (+ ``F.avg_pool2d``); ``tanh``/``round``/``clamp``;
5. path I at the default config: ``ImageGANEngine.score`` of 8 images the
   engine generated (uint8 -> [-1, 1]) at alpha 1.0 and 0.5: 2
   ``packed_conv`` and 2 ``packed_convpool`` launches per call, logits
   within 1e-4 (atol = rtol) of the same engine on the plain twins, of the
   unpacked path on the card and, for 2 images, of the engine on the CPU;
   scores/s, p50 and peak device memory. ``latent_walk`` of 64 frames at
   stage 7 (512²): 8 chunks' launches, first and last frame within +-1 of
   ``generate`` of the end points. ``use_pallas=True``: one
   ``to_uint8_fused`` launch per ``generate`` call, bytes within +-1 on at
   most 0.5% of the default path's. A seeded image checkpoint written with
   ``save_image_checkpoint`` into a temporary directory and served by the
   CLI's ``generate_images`` task in process: its checksum must equal
   ``engine.generate``'s on the same weights and seed (EMA weights; raw
   weights at stage 7, alpha 0.5);
6. the fused rank kernels at the KG path's shapes (N = 1,000,000
   entities, D = 128): ``rank_topk`` at B = 64 and B = 8 with k = 10, with
   ``nvalid`` below the row count, with planted duplicate rows, with twelve
   planted rows whose cosines with query 1 lie 1e-4 apart, and as
   ``rank_topk_local``; ``rank_topk``'s (values, ids) bit-equal to
   ``rank_scores`` followed by ``top_k_lowest_index`` (the same 3xTF32
   product and order of sums) at B = 64 and 8, k = 1, 10 and 16, with
   ``nvalid`` at and below the row count, fused and through
   ``rank_topk_local`` (``rank_scores`` launched with ``normalize=False``
   there); the kernel alone at k = 1, 10, 16 for both batches;
   ``rank_scores`` (3xTF32) at B = 64, 8 and 1 against
   that table (N not a multiple of 128) and against one of 100,003 rows at
   D = 100 (padded to 104 in the kernel): the whole [B, N] matrix within
   2e-6 of the plain twin, planted duplicate rows in other tiles and blocks
   bit-equal, a zero query row all zeros; ``rank_topk_bf16``
   (``rank_topk_fused(table_bf16=...)``) on the same cases. Values must
   agree with the plain twin to atol 2e-6 (the kernel sums a dot's 128 terms
   in another order than ``torch.matmul``: about 1 ulp); every returned id's
   plain fp32 score must equal the returned value within 2e-6, no entity
   left out may score more than 2e-6 above the k-th value, bit-equal scores
   (duplicate rows) must come in ascending id, and the rows 1e-4 apart, which
   bf16 cannot tell apart, in their fp32 order. The bf16 path's ids must equal
   the fp32 kernel's; its merge kernel alone, on the stream's candidates,
   must match ``merge_rescore_bf16_plain`` (ids equal, values to 2e-6) and
   the one-call path its two parts launched apart, bit for bit; its times
   are the wrapper's, the stream's alone and the merge's alone. The
   yardstick is ``F.normalize`` -> ``torch.matmul`` (-> ``torch.topk``), on
   bf16 operands for the bf16 kernel; ``rank_scores``' and ``rank_topk``'s
   bounds are given at both grades (TF32 x3 and fp32 CUDA cores) beside the
   bytes;
7. the KG main path: a seeded C17 checkpoint (1,000,000 entities, 1,000
   relations, embed 128, noise 64, hidden 1024) written as ``.pt`` into a
   temporary directory, then ``InferenceEngine(path, device="cuda")``:
   ``predict_tails`` on 64 pairs with top_k 10 (``rank_topk`` must launch
   exactly once per call; results must agree with the same engine run with
   the kernels' plain twins in their place under the same noise), once with
   top_k 32 (``rank_scores`` must launch once; a fresh engine's first
   top_k 32 call, under the noise of the first top_k 10 call, must return
   the same first 10 ids and scores, bit for bit), ``find_similar_entities``
   (``rank_topk`` with k = 11, the query itself excluded),
   ``score_triplets`` and ``analyze_relations`` against the engine on the
   CPU (atol 1e-5, relation ids equal). Then path II: the same file served
   by an engine built with ``PROBGAN_BF16_RANK=1``: ``predict_tails`` and
   ``find_similar_entities`` must launch ``rank_topk_bf16`` once per call
   and ``rank_topk`` not at all and return the fp32 engine's ids (scores to
   2e-6); queries/s and p50 of both engines, called in turns (the bf16
   engine against the fp32 one). Last the CLI's
   ``predict_tails`` and ``model_info`` tasks in process, and the REPL fed
   from stdin;
8. the training kernels at path III's shapes (batch 2) against their plain
   twins: ``packed_conv_wgrad`` (3xTF32) at the six distinct (C, Cout, H) of
   the 1024² train step, each entry within 1e-5 of dW's largest (sums over 2
   to 4 million pixels in another order) and two runs on one input
   bit-equal, with its bound at the TF32 rate beside the fp32 CUDA-core one;
   ``packed_upconv`` with the "lrelu" epilogue at both stages (two runs
   bit-equal), ``packed_conv``
   "none" (3xTF32) at the four (C, Cout, H) the step launches it with and at
   the two where ``convpool_lrelu``'s backward recomputes its mask on the
   fp32 "lrelu" kernel (within atol = rtol = 1e-4 and 1e-5 of the output's
   largest entry, two runs bit-equal; at the recompute shapes the count of
   lrelu masks its sign would flip against the fp32 kernel), and
   ``packed_convpool`` "none" at the upconv's dgrad shapes (atol = rtol =
   1e-4). Yardsticks: ``torch.nn.grad.conv2d_weight``; ``F.conv2d`` with
   ``F.interpolate`` / ``F.leaky_relu`` / ``F.avg_pool2d``. Each of the four
   ``ops/packed_vjp.py`` Functions: output and (dx, dw, db) on the card
   against autograd through the plain twins, each within 1e-4 of the
   tensor's largest entry (dw, which autograd takes from cuDNN: 5e-4). A
   forward wrapper given a CUDA tensor that requires grad must raise;
9. path III, training: ``progan_init_state`` at the default config, stage 8,
   batch 2, ``packed_d = packed_g = True``, ``remat=True``, seeded images and
   latents. ``progan_grads`` on the kernels against the same call on the
   plain twins and against the unpacked autograd path (losses rtol 1e-4,
   every gradient leaf within 2e-2 of its largest entry); 2 warm-up and 4
   timed ``progan_train_step`` calls at alpha 0.5 and 1.0 with the launch
   counts per step checked (12 ``packed_conv_wgrad``, 6 ``packed_upconv``,
   32 ``packed_conv``, 8 ``packed_convpool``), every loss finite; steps/s,
   p50, peak device memory with ``remat`` on and off; one
   ``progan_train_step_accum`` step (A = 2) and one step with R1; device
   milliseconds by part over 2 steps under ``torch.profiler``
   (``utils/profile_train.py``'s parts: ``packed_conv_wgrad``'s and
   ``packed_conv[none]``'s a step); one step's "none" launches by (C, Cout,
   H), which must be ``NONE_LAUNCHES_PER_STEP``; a
   train state saved, loaded and stepped against the uninterrupted run. Then
   ``kg_init_state`` at 1,000,000 entities, 1,000 relations, batch 1,024 with
   corrupted negatives and 8,192 sampled-softmax negatives: the first step's
   metrics against the same step on the CPU (rtol 1e-4), steps/s and peak
   memory;
10. the stage-fused kernels at the 1024² generator's shapes (batch 2):
    ``packed_upconv_conv`` at stage 7 (128 -> 64 -> 64, 256² -> 512²) and
    ``packed_upconv_conv_rgb`` at stage 8 (64 -> 32 -> 32, 512² -> 1024²;
    uint8 at alpha 1, fp32 at alpha 0.3) and at stage 7 (uint8, alpha 0.5);
    then the runs' boundaries: ``packed_upconv_conv_rgb`` at stage 8 uint8,
    batch 8, and ``packed_upconv_conv`` at batch 3 on a 200 x 256 input (an
    uneven split of the tiles over the blocks: runs that end mid-strip and
    strips shared by two blocks). Each within 1e-5 of its plain twin (uint8
    within +-1 on at most 0.5% of bytes) and equal, value for value, to the
    two-kernel pair it replaces (``packed_upconv`` -> ``packed_conv`` /
    ``packed_conv_rgb``) on the card.
    Times of the kernel, the twin, the pair and a cuDNN yardstick
    (``F.conv2d`` on the upsampled input with the epilogues, toRGB, blend,
    ``to_uint8``), the bound and its roofline share;
11. path IV, under ``PROBGAN_STAGE_FUSED=1``: ``generate`` at 1024², batch 8
    (one launch of each stage-fused kernel a call and none of the pair;
    images equal to the two-kernel engine's, PSNR >= 50 dB against the CPU;
    img/s, p50), ``latent_walk`` of 64 frames at stage 7 (one
    ``packed_upconv_conv_rgb`` a chunk, frames equal to the two-kernel run),
    ``PROBGAN_PACKED=0`` (no late-stage kernel launched). The image trainer
    CLI at 1024² (4 synthetic images, batch 2, 2 epochs a stage): stages
    0-7 at ``--resolution 512`` in process; ``--resume --grow`` to 1024² in a
    child process, killed once it reports its mid-stage save; ``--resume``
    from that file in process to the end. The D step's fake renders in
    process must launch ``packed_upconv_conv_rgb`` (stage 7 alone, stage 8)
    and ``packed_upconv_conv`` (stage 8) and none of the pair; the checkpoint
    serves ``--task generate_images``, fused and not, to one checksum;
    seconds per stage and steps/s over stage 8's last epoch, from the CLI's
    ``metrics.jsonl``. The KG trainer CLI at N = 1,000,000 (10,000
    numpy-written triplets, batch 1,024, two epochs with their eval,
    ``best_checkpoint.pt`` and ``train_state.msgpack``), its checkpoint
    served by ``InferenceEngine``'s ``predict_tails`` on the card; steps/s
    over the last epoch from ``metrics.jsonl``;
12. the grades: kernel mode "default" (one bf16 pass, ``csrc/*_bf16.cu``) of
    ``packed_upconv`` (stage 7, and stage 8 with toRGB), ``packed_conv``
    "lrelu_norm" (stage 7) and ``packed_conv_rgb`` (stage 8, uint8 and fp32;
    beside it stage 7 and a ragged C of 40, 40 -> 32 at 128²) at batch 2
    against their bf16 twins (fp32 outputs within 1e-5 of the
    largest entry, B3's fp32 RGB on all but 1% of values, where a feature on
    a bf16 rounding boundary rounds the other way; uint8 within +-1 on at most
    0.5% of bytes), two runs bit-equal, timed beside the bound at the bf16
    peak (989 TFLOP/s) and cuDNN on bf16 tensors with the epilogues. Then
    ``generate`` at 1024², batch 8, at "high", "fast", None and dtype bf16 on
    one set of seeded weights and latents: img/s, p50 ms/img and PSNR against
    "high" each; "fast" must reach 50 dB and launch the three bf16 kernels
    (2/1/1 a call) and none of the fp32 ones; "high" run after the others must
    equal the first "high" run bit for bit. ``score`` at None against "high":
    the largest logit difference;
13. kernel mode "mid" (the 2-term split: weights rounded to bf16,
    activations as bf16(x) + bf16(x - bf16(x)), two bf16 products a dot on
    the tensor cores) of ``packed_upconv`` ("lrelu_norm" at stages 7 and 8,
    with toRGB at batch 8, and "lrelu"), ``packed_conv`` ("lrelu_norm",
    "lrelu", "none"), ``packed_convpool`` ("lrelu", "none") and
    ``packed_conv_rgb`` (stage 8, uint8 and fp32; beside it stage 7 and a
    ragged C of 40, 40 -> 32 at 128²) at the shapes of the paths
    below (batch 2; batch 8 for score's and generate's) against their "mid"
    twins (fp32 outputs within 1e-5 of the largest entry, uint8 within +-1 on
    at most 0.01% of bytes), two runs bit-equal, timed beside the bound (the
    two passes' products at the bf16 peak, or the bytes) and ``F.conv2d`` in
    fp32 of x against the bf16-rounded weights with the epilogue ops;
    ``packed_conv`` "lrelu" at "mid" pooled in B5's order equal to
    ``packed_convpool`` "lrelu" at "mid" bit for bit. Then ``score`` at
    "fast" at 1024², batch 8 (2 "mid" B2 and 2 "mid" B5 launches a call and
    no fp32 D kernel; logits within 1e-4 of the engine on the plain twins;
    the largest difference against "high"; scores/s; "high" after it
    bit-equal to "high" before it); ``progan_train_step`` at 1024², stage 8,
    batch 2, both packed gates, ``remat``, ``packed_train_mode="mid"``: at
    two successive states the raw gradients against the plain twins (losses
    within rtol 1e-4, leaves within 2e-2 of their largest entry) and against
    the fp32 kernels at "high" (cosine and norm ratio a leaf), then timed
    steps with their launch counts (steps/s, peak device memory); and
    ``generate`` at 1024², batch 8, with G's packed mode "mid" and
    "default+mid" (``_PACKED_MODES["fast"]`` patched inside the phase)
    beside "fast" and "high" (PSNR >= 50 dB against "high", the launches of
    each mode, img/s), "high" after them bit-equal to the first;
14. kernel mode "default" of the training backward (one bf16 pass, the
    reference's training default): ``packed_upconv`` "lrelu", ``packed_conv``
    "lrelu" and "none", ``packed_convpool`` "lrelu" and "none" (one-term
    ``csrc/bf16_conv.cuh``) within 4e-6 of their twins' largest entry and
    ``packed_conv_wgrad`` (``csrc/packed_conv_wgrad_bf16.cu``) within 1e-5,
    all at the 1024² step's shapes (batch 2), two runs bit-equal, timed
    beside the bf16 bound, cuDNN in bf16 and (B6) the 3xTF32 kernel;
    ``packed_conv`` "lrelu" pooled in B5's order equal to ``packed_convpool``
    "lrelu" at "default" bit for bit; the four Functions at "default" on the
    kernels against the same Functions on the twins (1e-2 of the largest
    entry; dx on all but 0.01% of values, the LeakyReLU masks the two sums
    set apart). ``progan_train_step`` at 1024², stage 8, batch 2, both packed
    gates, ``remat``, at the default ``packed_train_mode="default"``: the
    bf16 kernels' launches a step (6, 32, 8, 12; no fp32 or "mid" packed
    launch), losses against the twins within 1e-4 and each network's
    gradients as one vector (relative L2 <= 5e-2, cosine >= 0.999; the
    twins' own spread under inputs changed by a few ulps beside them),
    each leaf's cosine and norm ratio against the fp32 kernels beside
    the unpacked bf16 step's (the packed step's worst cosine no more than
    0.01 below), steps/s and peak memory at "default" and at dtype bf16 (the
    ``--fast`` math), "highest" after them bit-equal to the first; the image
    trainer CLI with ``--fast`` at 1024² (phase 11's images and batch, one
    epoch a stage): seconds per stage, the checkpoint loaded by the port;
15. kernel modes "default" and "mid" of the stage-fused kernels
    (``csrc/fused_bf16.cuh``): B10 at stage 7 and B11 at stage 8 (uint8 at
    alpha 1, fp32 at alpha 0.3), at stage 7 (uint8) and at stage 8 uint8
    batch 8, each mode: 0 values differing from the bf16 pair at the mode,
    two runs bit-equal, within 1e-5 of the twin's largest entry on all but
    1% of values and 2e-2 on the rest (a conv1 value the twin sums in another
    order may round to the other bf16 neighbour before conv2; uint8 on 0.5%
    of bytes, >= 60 dB), conv1 pixels a conv2 output counted by the kernel, timed
    beside the pair, cuDNN on bf16 tensors with the epilogues and the bf16
    bound; under ``PROBGAN_STAGE_FUSED=1`` ``generate`` at 1024² b8 at
    "fast", None, G's "mid" and "default+mid" (one launch a call of each
    fused kernel at the grade's modes, none of the pair, images equal to the
    two-kernel engine's, >= 50 dB against "high" at "fast", img/s and p50 of
    both), ``latent_walk`` at "fast" (frames equal), ``--task
    generate_images --precision fast`` (the checksum without the variable)
    and ``progan_train_step`` at stage 8, batch 2, ``packed_fake``,
    ``packed_d``, ``packed_train_mode="default"`` (the fake render on B10/B11
    "default", no pair kernel; losses and the state after two steps equal,
    bit for bit, to the steps without the variable);
16. the narrow generator N (``ProGANConfig(resolution=1024, latent_dim=128,
    fmap_base=2048, fmap_max=256)``: nf 256 ... 128, 64, 32, 16, 8, packed
    stages 6-8 in G and D), seeded weights: ``packed_upconv`` 32 -> 16 and
    16 -> 8 (with toRGB; "lrelu_norm" and "lrelu"), ``packed_conv``
    "lrelu_norm" 16 -> 16 and 8 -> 8 and "lrelu" 8 -> 8 and 16 -> 16,
    ``packed_conv_rgb`` 8 -> 8 and 16 -> 16 (uint8 and fp32) and
    ``packed_convpool`` 8 -> 16 and 16 -> 32 at batch 8, each at "high",
    "default" and "mid"
    against its twin to the bound phases 2-4, 12 and 13 hold that kernel to
    (B3's uint8 16 -> 16 at "default" within +-2 on at most 0.5% of bytes,
    each byte more than 1 off witnessed as a bf16 rounding flip of one of
    its pixel's features: ``b3_flip_witness``), two runs bit-equal, ``packed_conv`` "lrelu" pooled in B5's order equal to
    ``packed_convpool`` bit for bit, timed beside the bound and F.conv2d with
    the epilogue; ``generate`` at N, batch 8, at "high", "fast", None and G's
    "mid" (the launches a call at 16 and 8 channels, ``ops/packed.py``
    ``narrow_launches``; "high" within +-1 on 0.5% of bytes and >= 50 dB of
    the unpacked path; the PSNR of "fast" against "high" is a reading;
    img/s, p50), ``latent_walk`` (frames equal to ``generate``'s) and
    ``score`` at "high" and "fast" (launches, logits within 1e-4 of the
    twins', scores/s, p50); Cout 4 in the stage-fused
    ``packed_upconv_conv`` and Cout 24 in ``packed_upconv_conv_rgb`` raise
    ValueError on the card naming ROADMAP.md B.a.2.4, and
    ``packed_upconv_conv`` at 16 channels launches (Cout 4 in B2 "lrelu"
    and "none", B5 and B1 "lrelu", refused before the training half of
    B.a.2.4, launch in phase 23);
17. the narrow backward at N: ``packed_conv`` "none" 8 -> 8 and 16 -> 8 at
    1024², 16 -> 16 and 32 -> 16 at 512² (slabs of 8 and 16) and
    ``packed_convpool`` "none" 8 -> 16 at 1024² (and 8 -> 8, a slab of 8 on
    no path at N), batch 2, at "high", "default" and "mid", against their
    twins (fp32 "none" within 1e-5 of the largest entry, B5 1e-4; "default"
    4e-6, "mid" 1e-5), two runs bit-equal, timed beside the bound and
    F.conv2d on the flipped, transposed weights (+ avg_pool2d);
    ``packed_conv_wgrad`` at N's nine distinct weight-gradient shapes, fp32
    and "default", within 1e-5; the four Functions at N's shapes on the
    kernels against the same Functions on the twins at "highest", "mid" and
    "default"; ``progan_train_step`` at N, stage 8, batch 2, both packed
    gates, ``remat``, at "highest", "mid", "default" and dtype bf16: the
    launches a step (phase 9's x 3/2, 18 wgrad; "none" at slabs of 16 and 8
    by slab; nothing at another mode), the gradients against the twins to
    phase 9's, 13's and 14's bounds, steps/s, p50 and peak memory, "highest"
    after the bf16 steps bit-equal to the first, the train state saved and
    resumed (bit-equal, the next step within 6e-4); the image trainer CLI
    with ``--fast --fmap_base 2048 --fmap_max 256`` (stages 0-7 at 512², a
    child at 1024² killed after its mid-stage save at stage 8, ``--resume``
    to the end): the bf16 training kernels alone, finite losses, seconds per
    stage, the checkpoint loaded at N;
18. the stage-fused kernels at N: ``packed_upconv_conv`` 32 -> 16 at 256²
    and ``packed_upconv_conv_rgb`` 16 -> 8 at 512² (N's stages 7 and 8;
    uint8 at batch 2 and 8, fp32 at batch 2), ``packed_upconv_conv_rgb``
    32 -> 16 (``latent_walk`` at stage 7) and ``packed_upconv_conv`` 16 -> 8
    (on no path at N) at batch 8, each at "high", "default" and "mid": 0
    values differing from the two-kernel pair at the mode, two runs
    bit-equal, the twin within 1e-5 ("high"; uint8 +-1 on 0.5% of bytes) or
    phase 15's bounds, timed beside the pair, the bound and F.conv2d chains;
    with ``PROBGAN_STAGE_FUSED`` at 1 and at 0, ``generate`` at N, batch 8,
    at "high", "fast", None, G's "mid" and "default+mid" (two B10 and one
    B11 launch a call, none of the pair, images equal, img/s and p50 of
    both), ``latent_walk`` at stage 7 at "high", "fast" and G's "mid" (B11 at
    16 channels, frames equal), ``--task generate_images --precision fast``
    from a seeded N checkpoint (checksums equal), ``progan_train_step`` at
    N, stage 8, batch 2, ``remat``, at "default" and "highest" with both
    packed gates (G's differentiable path renders the fake batch: the same
    launches either way) and with ``packed_fake`` and ``packed_d`` (the
    fake batch on B10/B11 at 32, 16 and 8 channels): losses and the state
    after two steps equal bit for bit; the image trainer CLI with ``--fast``
    at N, one epoch a stage at 1024², seconds per stage either way;
19. entity-table tensor parallelism (``parallel/``): B4 ``rank_topk_local``
    on one shard of the TP path (500,000 x 128 of the 1,000,000-row table)
    at B 64 and 8, k 1, 10, 16, nvalid 0, 1, k - 1, k and the shard's rows:
    values and ids bit-equal to B7's scores (``normalize=False``) masked
    past nvalid and the stable top k, the fillers -inf with id 0; against
    the plain twin finite values within 2e-6, ids equal but for near-ties;
    no launch at nvalid 0; timed as the wrapper, the launch alone and the
    wrapper's host issue time. Then two ranks on cuda:0 in a gloo group
    (NCCL refuses two ranks a card), spawned after phase 1's build:
    ``InferenceEngine(path, mesh="auto")`` on seeded checkpoints of
    1,000,000 and 1,000,003 entities (D 128): ``predict_tails`` on 64 pairs
    and ``find_similar_entities`` at top_k 10 (one B4 a rank and call) and
    20 (one B7), and on a 9-entity KG at top_k 5 (the last shard ranks at
    nvalid 4 < k 5): ids equal to the one-process engine's on the card,
    values within 1e-6, the launches a call; queries/s, p50 and p10-p90 of
    both at N over 50 calls, and on rank 0 the p50 of two parts of the TP
    call, ``sharded_rank_topk`` and its broadcast and gathers alone
    (recorded only: the ranks share one card). Then ``python -m
    torch.distributed.run --nproc-per-node 2 -m probgan_tpu_torch.cli.infer
    --mesh auto`` (``PROBGAN_DIST_BACKEND=gloo``) on the 1,000,003-entity
    checkpoint, predict_tails and similar_entities: the JSON written once,
    equal to the one-process CLI's by the same rule;
20. data parallelism for the image family (``parallel/sharded_image.py``,
    ``parallel/dp_train.py``): two ranks on cuda:0 through gloo, spawned
    after phase 1's build. ``ImageGANEngine(mesh="auto")`` at the default
    config, 1024², at "high" and "fast": ``generate`` at batch 8 (4 a rank)
    and 7 (padded), ``score`` at 8 (the minibatch stddev over both ranks)
    and 7 (replicated), ``latent_walk`` of 11 frames, each against the
    one-process engine on the same weights and inputs: images equal but for
    +-1 on at most 0.1% of bytes to the one-process renders at the ranks'
    batches (and at "high" to the one-process call at the whole batch; at
    "fast" >= 50 dB, the one process's own batch-4 against batch-8 spread
    printed beside it), logits within 1e-5, each call's launches equal to
    the one-process call's (B1-B3 in generate, B2/B5 in score); img/s and
    scores/s of both (recorded only: the ranks share one card). Then
    ``dp_progan_train_step`` at stage 8, global batch 2 (one image a rank),
    both packed gates, at "default" and "highest" (B1 "lrelu", B2
    "lrelu"/"none", B5, B6 on each rank) against ``progan_train_step`` on
    the whole batch: losses within 1e-5 at "highest" (1e-3 at "default"),
    every parameter within 2.1e-3, at most 0.05% of a tree's elements past
    JAX's tight bound at "highest", the first step's gradients as one vector
    a network within relative L2 5e-2 and cos 0.999 (``DP_LOSS_ATOL`` says
    why), the replicas equal, the step's launches equal, a second step
    finite; the gradient all-reduce alone timed at D's and G's sizes. Then
    ``torch.distributed.run --nproc-per-node 2`` (gloo): ``cli.infer --task
    generate_images --mesh auto`` (written once, the one-process CLI's
    images by the same rule) and ``cli.train_image --mesh auto`` (2 steps,
    one ``metrics.jsonl``, losses within 1e-5 of the one-process run);
21. the KG train state row-sharded (``parallel/dp_train.py``
    ``shard_kg_state``, ``parallel/sharded_kg.py``): ``torch.distributed.run
    --nproc-per-node 2 -m probgan_tpu_torch.cli.train --mesh auto`` on a
    seeded dataset of 4,096 triplets at N = 1,000,003, 1 epoch and a
    ``--resume`` to 2, against the one-process CLI (one rank 0 printing, the
    same files, losses within 1e-5, the same Hit@10), its checkpoint served
    by the one-process CLI; then two ranks on cuda:0 through gloo, mesh
    (1, 2): 3 ``kg_train_step`` at N = 1,000,003 (batch 64, corrupted
    negatives, 8,192 sampled ones colliding with true tails) and one
    full-softmax step at N = 50,001, each against the one-process step on
    the card at the same state, batch and noise (losses within 1e-5, every
    leaf of the state, the moments too, by JAX's packed rule at "highest",
    the replicas equal), ``kg_eval_hits`` over 512 triplets at k 10 and
    N / 10 equal to the one-process values, the lookups' collective and a
    bare all-reduce of its bytes timed alone, and ``cli.infer --task
    predict_tails --mesh auto`` on the mesh-trained checkpoint (B4
    ``rank_topk_local`` once a rank, the one-process CLI's JSON); then four
    ranks, mesh (2, 2), one step at N = 100,003 by the same rules. Step
    times of both recorded only: the ranks share one card;
22. the serving path's PixelNorm kernels at any width up to 64 (ROADMAP.md
    B.a.2.3): B1 "lrelu_norm" (with and without the toRGB of its input), B2
    "lrelu_norm" and B3 (fp32 and uint8) at every new (C, Cout) of the 1024²
    generators T (fmap_base 1024: stages 6-8 at 16, 8, 4 channels), T2 (512:
    8, 4, 2) and O (3072: 48, 24, 12), batch 2 and 8, at "high", "default"
    and "mid", against their twins by phase 16's rules, two runs bit-equal,
    timed beside the bound and cuDNN with the torch epilogue (entries
    "<counter>[any_width]"); ``generate`` at T and O, batch 8, at "high"
    (+-1 on at most 0.5% of bytes of the unpacked path), "fast" (>= 50 dB
    against "high") and G's "mid", the launches a call by the true Cout,
    img/s and p50; ``latent_walk`` at T (the frames of ``generate``); under
    ``PROBGAN_STAGE_FUSED=1`` ``generate`` at T raises before any launch,
    naming B.a.2.4; the image trainer CLI at 512², fmap_base 512, fmap_max 64
    (the JAX tests' configuration) trains stages 0-7, the D step's fakes of
    stage 7 through B1 8 -> 4 and B3 4 -> 4, and writes a checkpoint the port
    loads. ``python3 chip_smoke.py --phase 22`` runs phase 1 and this phase
    alone and prints its kernels line;
23. the training backward at any width (the training half of ROADMAP.md
    B.a.2.4): B1 "lrelu", B2 "lrelu" and "none", B5 "none" (and "lrelu",
    D's, on no path at these widths) and B6 at every (C, Cout) of T, T2 and
    O's packed train step that the card refused before, batch 2, at "high",
    "default" and "mid" (B6 fp32 and "default"), against their twins by
    phase 17's bounds, two runs bit-equal, timed beside the bound and the
    library call (entries "<counter>[<epilogue>,any_width]"); the
    recompute's bits at O's 48 and 24 and T's 4 ("lrelu" on its slab equal
    to "lrelu" on the forward's tile, its sign mask to the "lrelu_norm"
    forward's: 0 values differing); the four Functions at the new pairs on
    the kernels against the same Functions on the twins; ``progan_train_step
    (packed_g=True, packed_d=True)`` at T, T2 and O, 1024², stage 8, batch 2,
    remat, at "highest", "default" with dtype bf16 and (O) "mid": the
    launches a step at the new widths, finite losses, the gradients against
    the same step on the twins by phases 9, 13 and 14 beside the step's
    spread against itself (cuDNN deterministic on and off), steps/s, p50 and
    peak memory; the image trainer CLI at 512², fmap_base 512, fmap_max 64
    with ``--fast`` and with ``--packed_g --packed_mode high`` (stage 7's G
    backward at 8 -> 4), a checkpoint the port loads; under
    ``PROBGAN_STAGE_FUSED=1`` ``generate`` at T raises before any launch.
    ``python3 chip_smoke.py --phase 23`` runs phase 1 and this phase alone;
24. the last lines: the card's name and power limit, one JSON line with each
    kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores, no tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, tensor cores, dense bf16
PEAK_TF32_FLOPS = 495e12  # H100 SXM, tensor cores, dense TF32
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
BATCH_KERNELS = 2
BATCH_MAIN = 8
MAIN_BATCHES = 6  # timed generate calls on the main path
UINT8_MAX_FLIP_SHARE = 0.005
PSNR_FLOOR_DB = 50.0
KG_ENTITIES = 1_000_000  # the JAX package's own "production scale" rank size
KG_RELATIONS = 1_000
KG_DIM, KG_NOISE, KG_HIDDEN = 128, 64, 1024
KG_BATCH = 64
KG_CALLS = 6  # timed predict_tails calls
KG_TOP_K = 10
SCORE_CALLS = 6  # timed score calls on path I
WALK_FRAMES, WALK_STAGE = 64, 7  # the 512² 64-frame walk
# Logits of the 1024² discriminator (18 fp32 conv layers and two dense ones,
# summed in another order by the kernels, cuDNN and the CPU) agree to this.
LOGIT_TOL = 1e-4
# fp32 dots summed in another order than torch.matmul differ by about 1 ulp
# of a cosine near 1: the JAX package's own tolerance for its rank kernels.
RANK_ATOL = 2e-6
TRAIN_BATCH, TRAIN_STAGE = 2, 8  # the 1024² G/D step of the baseline's config 5
TRAIN_WARMUP, TRAIN_STEPS = 2, 4
# Launches of one progan_train_step with packed_d = packed_g = True at stage
# 8: two packed stages each in G and D; D runs forward and backward on the
# real and the fake batch and again under the G step, where its weights take
# no gradient (no wgrad) but its input does.
STEP_LAUNCHES = {"packed_upconv": 6, "packed_conv": 32, "packed_conv_rgb": 0,
                 "packed_convpool": 8, "packed_conv_wgrad": 12, "packed_upconv_conv": 0,
                 "packed_upconv_conv_rgb": 0, "packed_upconv_bf16": 0, "packed_conv_bf16": 0,
                 "packed_conv_rgb_bf16": 0, "packed_upconv_mid": 0, "packed_conv_mid": 0,
                 "packed_conv_rgb_mid": 0, "packed_convpool_mid": 0, "packed_convpool_bf16": 0,
                 "packed_conv_wgrad_bf16": 0, "packed_upconv_conv_bf16": 0,
                 "packed_upconv_conv_mid": 0, "packed_upconv_conv_rgb_bf16": 0,
                 "packed_upconv_conv_rgb_mid": 0}
STEP_EPILOGUE_LAUNCHES = {
    "packed_upconv[lrelu_norm]": 4, "packed_upconv[lrelu]": 2,
    "packed_conv[lrelu_norm]": 4, "packed_conv[lrelu]": 14, "packed_conv[none]": 14,
    "packed_convpool[lrelu]": 6, "packed_convpool[none]": 2,
}
PACKED_KERNELS = ("packed_upconv", "packed_conv", "packed_conv_rgb", "packed_convpool",
                  "packed_conv_wgrad")
# A gradient sums up to 4 million products in another order than cuDNN or the
# plain twin: it is held to this share of the tensor's largest entry.
GRAD_REL = 1e-4
# packed_conv_wgrad's 3xTF32 grade against its plain twin (fp32, TF32 off):
# the grade drops about 2^-22 of each product, so dW must stay within this
# share of its largest entry.
WGRAD_REL = 1e-5
# packed_conv's "none" epilogue (3xTF32) against its plain twin, as a share
# of the output's largest entry: the grade of WGRAD_REL.
NONE_REL = 1e-5
# packed_conv "none" launches of one progan_train_step at stage 8, batch 2,
# by (C, Cout, H): the input gradients of conv_lrelu and conv_lrelu_norm
# (Cout -> C) and of convpool_lrelu (Cout -> C).
NONE_LAUNCHES_PER_STEP = {(32, 32, 1024): 4, (64, 32, 1024): 3, (64, 64, 512): 4,
                          (128, 64, 512): 3}
# convpool_lrelu's backward recomputes its lrelu mask at these (C, Cout, H),
# 3 launches each a step, on the fp32 "lrelu" kernel (the forward's own
# sums): phase 8 runs "none" there too and counts the masks it would flip.
RECOMPUTE_SHAPES = ((32, 64, 1024), (64, 128, 512))
# A weight gradient that autograd takes through the plain twin comes from
# cuDNN, whose fp32 algorithm at 512² is itself about 1e-4 of the largest
# entry away from the plain correlation (packed_conv_wgrad_plain): the bound
# of the JAX package's own wgrad tests.
DW_VS_CUDNN_REL = 5e-4
# A whole step's losses: the CPU tests' bound. Its gradients, leaf by leaf, as
# a share of the leaf's largest entry: the CPU tests hold 1e-3 at 256²; at
# 1024² a bias gradient sums 2 million signed terms that nearly cancel, and
# another summation order moves the worst leaf (32 entries) by 3.1e-3 and
# others by 1.1e-3 to 1.4e-3 (measured on an H100), so the bound here is
# 2e-2. This check is of the step's wiring: a wrong tap, sign or scale moves
# a leaf by its own size, and each kernel alone is held to 1e-4 in phase 8.
STEP_GRAD_REL, STEP_LOSS_RTOL = 2e-2, 1e-4
KG_TRAIN_BATCH, KG_CE_NEGATIVES, KG_TRAIN_STEPS = 1024, 8192, 4
# The stage-fused kernels against their twins: PixelNorm'd features and fp32
# RGB to this absolute error (uint8 within +-1 on UINT8_MAX_FLIP_SHARE); they
# must equal the two-kernel pair on the card bit for bit.
FUSED_ATOL = 1e-5
FUSED_KERNELS = ("packed_upconv_conv", "packed_upconv_conv_rgb")
UNFUSED_KERNELS = ("packed_upconv", "packed_conv", "packed_conv_rgb")
# Path IV's trainer runs: the image CLI at 1024² on 4 synthetic images, batch
# 2, 2 epochs a stage; the KG CLI at N = 1,000,000 on ~10,000 triplets.
TRAINER_IMAGES, TRAINER_BATCH, TRAINER_EPOCHS = 4, 2, 2
KG_CLI_TRIPLETS, KG_CLI_EPOCHS = 10_000, 2
CHILD_TIMEOUT_S = 300  # the trainer's child process, to its mid-stage save
# The tensor-parallel phase: two ranks on one card through gloo.
TP_RANKS = 2  # ranks of the TP phase, both on cuda:0 (NCCL refuses two ranks a card)
TP_SHARD_ROWS = KG_ENTITIES // TP_RANKS  # a shard of the 1,000,000-row table
TP_UNEVEN = KG_ENTITIES + 3  # 1,000,003 rows: the last shard one row short
TP_SMALL = 9  # a 9-entity KG: shards of 5, the last at nvalid 4 < k 5
TP_TIMEOUT_S = 600  # a rank's collectives (phases 19 and 20), and each torchrun
TP_VALUE_ATOL = 1e-6  # tests/test_parallel.py's bound on values
TP_CALLS = 50  # timed predict_tails calls of the TP phase, and of each of its parts
# The data-parallel phase: two ranks on one card through gloo, the default
# config at 1024².
DP_RANKS = 2
DP_BATCH, DP_ODD_BATCH = 8, 7  # 4 images a rank; 7 does not divide (padded / replicated)
DP_WALK_FRAMES = 11  # padded to 12
DP_GRADES = ("high", "fast")
DP_UINT8_SHARE = 1e-3  # +-1 on at most 0.1% of bytes (ROADMAP §C's allowed flips)
DP_LOGIT_TOL = {"high": 1e-5, "fast": 1e-5}  # rtol = atol, tests/test_parallel.py:226
DP_CALLS = 3  # timed generate and score calls of each side
DP_SEED = 0
DP_TRAIN_MODES = ("default", "highest")
DP_TRAIN_BATCH, DP_TRAIN_ALPHA = 2, 0.7  # one image a rank
# A DP step against the one-process step on the whole batch, by JAX's rules
# (tests/test_parallel.py:384-433) where the card allows them: losses within
# 1e-5, every parameter within DP_MAX_DIFF (Adam's first update is about
# +-lr, so a near-zero gradient whose sign flips moves its element by up to
# 2 lr) and at most 0.01% of a tree's elements past DP_TIGHT_ABS +
# DP_TIGHT_REL |b|. On the card the one-process bits depend on the batch
# (cuDNN and cuBLAS may pick other kernels at another batch): G's
# differentiable render at batch 2 differs from two renders of 1 by 1.4e-5
# to 1.7e-5 at "highest" and by 0.019 at "default" (TF32 convs, rounded
# again by the bf16 kernels; ``batch_dependence``, printed each run; an
# H100). One image a rank against two in one process then gave, over four
# runs, losses within 5e-7 and G's gradient within relative L2 6.5e-4 to
# 1.1e-3 at "highest", which put 0.009-0.016% of G's elements past the tight
# bound (D's 0.00005%); at "default" the losses moved by 3.4e-5 (d) and
# 4.3e-4 (g, after the D update), G's gradient by relative L2 2.6e-2, and
# 0.6% of G's elements went past the tight bound. So the share is held to
# 5e-4 at "highest" and not at "default", the losses to 1e-3 at "default",
# and the first step's gradients (Adam's first moment: b1 = 0) as one vector
# a network to phase 14's rule for the "default" grade (relative L2 <= 5e-2,
# cos >= 0.999) at both modes.
DP_LOSS_ATOL = {"default": 1e-3, "highest": 1e-5}
DP_LOOSE_SHARE = {"default": None, "highest": 5e-4}
DP_TIGHT_ABS, DP_TIGHT_REL, DP_MAX_DIFF = 6e-4, 4e-3, 2.1e-3
DP_GRAD_L2, DP_GRAD_COS = 5e-2, 0.999
DP_CLI_LOSS_ATOL = 1e-5  # the CLI's step: fp32 (no packed gate)
DP_ALLREDUCE_CALLS = 5
DP_CLI_IMAGES = 3  # padded to 4
DP_TRAIN_CLI = ["--synthetic", "2", "--resolution", "8", "--latent_dim", "8", "--fmap_base",
                "32", "--fmap_max", "8", "--epochs_per_stage", "1", "--batch_size", "2"]
# The KG TP phase: the KG state row-sharded over ranks on one card through
# gloo, each mesh step held to the one-process step (parallel/dp_train.py).
KG_TP_SEED = 23
KG_TP_STEPS = 3  # sampled-softmax steps at N = TP_UNEVEN on the (1, 2) mesh
KG_TP_DP_RANKS = 4  # the (2, 2) mesh: the data axis too
KG_TP_LOSS_ATOL = 1e-5  # the step is fp32 (TF32 off): DP_LOSS_ATOL at "highest"
KG_TP_LOOKUP_CALLS = 20  # timed lookups and bare all_reduces
# The (1, 2) sampled steps take every row from its owner and sum nothing over
# "model" but zeros, so the one-process state comes back bit for bit: held
# to 1e-6, not to the packed rule's Adam flips. Adam's update does not change
# when a gradient is scaled, so a table gradient tp times too large shows
# only in the moments: each is held relative to its leaf's largest entry
# (the first moment is 0.1 g after one step), in every case.
KG_TP_EXACT_ATOL = 1e-6
KG_TP_MOMENT_REL = 1e-4
# The card memory a rank of the (1, 2) mesh may take over the steps at
# N = TP_UNEVEN, as a share of the one-process steps' peak (the table and its
# moments dominate both: ~1 / tp), and what gathering the state back to rank
# 0 may add to a rank's card (the chunks go through the host over gloo).
KG_TP_PEAK_SHARE = 0.75
KG_TP_GATHER_EXTRA_BYTES = 64 << 20
KG_TP_SCALE = {
    "n": TP_UNEVEN, "full_n": 50_001, "dp_n": 100_003, "relations": KG_RELATIONS,
    "dim": KG_DIM, "noise": KG_NOISE, "hidden": KG_HIDDEN, "batch": KG_BATCH,
    "ce": KG_CE_NEGATIVES, "eval": 512, "cli_triplets": 4_096, "cli_batch": KG_TRAIN_BATCH,
}
# The kernels each rank must launch in the DP phase's calls on the card.
DP_SERVING_KERNELS = {
    "high": {"generate8": ("packed_upconv", "packed_conv", "packed_conv_rgb"),
             "score8": ("packed_conv", "packed_convpool")},
    "fast": {"generate8": ("packed_upconv_bf16", "packed_conv_bf16", "packed_conv_rgb_bf16"),
             "score8": ("packed_conv_mid", "packed_convpool_mid")},
}
DP_STEP_KERNELS = {
    mode: (f"packed_upconv{sfx}[lrelu]", f"packed_conv{sfx}[lrelu]", f"packed_conv{sfx}[none]",
           f"packed_convpool{sfx}[lrelu]", f"packed_convpool{sfx}[none]", f"packed_conv_wgrad{sfx}")
    for mode, sfx in (("default", "_bf16"), ("highest", ""))
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def host_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Host wall time a call to issue ``fn``'s work, with no synchronization
    in the loop: where it comes near ``cuda_ms`` of the same calls, the card
    waits on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed * 1e3 / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def uint8_agreement(a: np.ndarray, b: np.ndarray) -> tuple[int, float, float]:
    """(max |a-b|, share of bytes that differ, PSNR dB)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    psnr = math.inf if mse == 0 else 10 * math.log10(255.0**2 / mse)
    return int(d.max()), float(np.mean(d != 0)), psnr


def finite_or_none(x: float) -> float | None:
    """JSON has no infinity: an exact match's PSNR is written as null."""
    return x if math.isfinite(x) else None


def check_uint8(label: str, got: np.ndarray, want: np.ndarray,
                max_share: float = UINT8_MAX_FLIP_SHARE) -> tuple[int, float, float]:
    worst, share, psnr = uint8_agreement(got, want)
    print(f"  {label}: max |diff| {worst}, differing bytes {share:.6%}, PSNR {psnr:.2f} dB")
    if worst > 1 or share > max_share:
        raise AssertionError(f"{label}: uint8 outputs disagree beyond +-1 on "
                             f"{max_share:.2%} of bytes")
    return worst, share, psnr


def b3_flip_witness(pk, pro_gan, label: str, got: torch.Tensor, want: torch.Tensor,
                    args: tuple, alpha: float) -> dict:
    """Each pixel where B3's "default" uint8 output ``got`` is more than 1
    level from its twin's ``want``, explained by a bf16 rounding flip, else
    an AssertionError. B3 runs packed_conv "lrelu_norm"'s bf16 ring (its
    tiles and order of sums, one slab of all Cout), so packed_conv at
    "default" on the same input gives the features B3 rounds to bf16 for
    toRGB. At each such pixel at least one of them must round to another
    bf16 value than the twin's feature (the two fp32 values on either side
    of the midpoint of the two bf16 values), and toRGB and the blend taken
    from the ring's rounded features must land within +-1 of the kernel's
    bytes."""
    x, w, b, rgb_w, rgb_b, prev = args
    far = ((got.short() - want.short()).abs() > 1).any(-1).nonzero()
    if not len(far):
        return {"pixels": 0, "features_flipped": 0}
    n, y, xc = far.unbind(1)
    ring = pk.packed_conv(x, w, b, "lrelu_norm", mode="default")[n, :, y, xc]
    twin = pk.packed_conv_plain(x, w, b, "lrelu_norm", mode="default")[n, :, y, xc]
    ring_bf, twin_bf = pk._bf16(ring), pk._bf16(twin)
    flipped = ring_bf != twin_bf
    up = prev[n, :, y // 2, xc // 2]
    redo = pro_gan.to_uint8(up + alpha * (ring_bf @ pk._bf16(rgb_w).T + rgb_b - up))
    apart = (redo.short() - got[n, y, xc].short()).abs().amax(-1)
    for i in range(len(far)):
        print(f"  {label}: pixel {tuple(far[i].tolist())} kernel {got[n[i], y[i], xc[i]].tolist()}"
              f" twin {want[n[i], y[i], xc[i]].tolist()} from the ring's features "
              f"{redo[i].tolist()}; " + ", ".join(
                  f"feature {j}: twin {twin[i, j].item():.9g} ring {ring[i, j].item():.9g} "
                  f"bf16 midpoint {((ring_bf[i, j] + twin_bf[i, j]) / 2).item():.9g}"
                  for j in flipped[i].nonzero().flatten().tolist()))
    if not bool(flipped.any(-1).all()) or int(apart.max()) > 1:
        raise AssertionError(f"{label}: a pixel more than 1 level from the twin is not "
                             "explained by a bf16 rounding flip of one of its features")
    return {"pixels": len(far), "features_flipped": int(flipped.sum())}


def differing_bits(a: torch.Tensor, b: torch.Tensor) -> int:
    """Values of two fp32 tensors whose bits differ."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum().item())


def check_two_runs(label: str, first, again) -> None:
    """B1's and B2's fp32 kernels sum every output in one fixed order: two
    runs on one input must give the same bits."""
    torch.cuda.synchronize()
    for a, b in zip(first if isinstance(first, tuple) else (first,),
                    again if isinstance(again, tuple) else (again,)):
        if differing_bits(a, b):
            raise AssertionError(f"{label}: two runs on one input differ in their bits")


def pool_in_b5_order(y: torch.Tensor) -> torch.Tensor:
    """packed_convpool.cu's 2x2 mean as torch ops, rows first, then columns:
    0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11))."""
    a00, a01 = y[..., 0::2, 0::2], y[..., 0::2, 1::2]
    a10, a11 = y[..., 1::2, 0::2], y[..., 1::2, 1::2]
    return 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11))


def ptxas_entries(log: str) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (registers a thread, spill-store bytes)} of each
    entry function in one library's ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name is None:
            continue
        elif "spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
            out[name] = (out.get(name, (0, 0))[0], spills)
        elif "Used " in line:
            out[name] = (int(line.split("Used ")[1].split()[0]), out.get(name, (0, 0))[1])
    return out


def ptxas_most(log: str) -> tuple[int | None, int | None]:
    """The most registers a thread and the spill-store bytes in all of one
    library's instantiations, from its ``nvcc -Xptxas -v`` log."""
    entries = ptxas_entries(log).values()
    if not entries:
        return None, None
    return max(r for r, _ in entries), sum(sp for _, sp in entries)


def ptxas_kernels(log: str, kernel: str) -> dict[str, tuple[int, int]]:
    """ptxas_entries of the instantiations of ``kernel``, keyed by their
    template arguments as the mangled name spells them (``64x2xtrue``)."""
    named = {}
    for mangled, v in ptxas_entries(log).items():
        if kernel not in mangled:
            continue
        args = re.findall(r"L([ib])(\d+)E", mangled.split(kernel, 1)[1])
        named["x".join(n if t == "i" else ("true" if n == "1" else "false")
                       for t, n in args)] = v
    return named


def bf16_ring_line(pk, logs: dict) -> dict:
    """The bf16 ring of B1, B2, B3 and B5 as the card's libraries were
    compiled: (stages, bytes a block, blocks an SM) at each width and term
    count, held to ops/packed.py's stages and bytes and to one block an SM;
    and the most registers and spill bytes of each kernel's instantiations
    (ptxas), B3's a instantiation (Cout x terms x uint8; no spill allowed),
    B5's fp32 ring (csrc/packed_convpool.cu) beside them."""
    out = {}
    for name, ring_bytes in (("packed_conv", pk.bf16_ring_bytes),
                             ("packed_convpool", pk.bf16_ring_bytes),
                             ("packed_conv_rgb", pk.bf16_ring_bytes),
                             ("packed_upconv", pk.bf16_upconv_ring_bytes)):
        geo = {}
        for width in (64, 32, 16, 8):
            for terms in (1, 2):
                stages, nbytes, per_sm = pk.bf16_ring_geometry(name, width, terms)
                if (stages, nbytes, per_sm) != (pk.BF16_RING_STAGES[name], ring_bytes(width), 1):
                    raise AssertionError(
                        f"{name}_bf16 at {width}, terms {terms}: compiled with {stages} "
                        f"stages, {nbytes} B a block, {per_sm} blocks an SM; ops/packed.py "
                        f"says {pk.BF16_RING_STAGES[name]}, {ring_bytes(width)}, 1")
                geo[f"{width}x{terms}"] = {"stages": stages, "bytes": nbytes,
                                           "blocks_per_sm": per_sm}
        regs, spills = ptxas_most(logs.get(f"{name}_bf16", ""))
        out[name] = {"geometry": geo, "max_registers": regs, "spill_store_bytes": spills}
    rgb = ptxas_kernels(logs.get("packed_conv_rgb_bf16", ""), "packed_conv_rgb_bf16_kernel")
    out["packed_conv_rgb"]["instantiations"] = {
        k: {"registers": r, "spill_store_bytes": sp} for k, (r, sp) in sorted(rgb.items())}
    print("  packed_conv_rgb_bf16 (ConvRgbBf16Ring<Cout, terms, uint8>) as compiled: " + ", ".join(
        f"{k} {r} registers {sp} B spilled" for k, (r, sp) in sorted(rgb.items())))
    if len(rgb) != 16 or any(sp for _, sp in rgb.values()):
        raise AssertionError(f"packed_conv_rgb_bf16: {len(rgb)} instantiations of 16 in the "
                             f"ptxas log, or one spills: {rgb}")
    print("  bf16 ring (csrc/bf16_ring.cuh) as compiled: " + "; ".join(
        f"{name} {next(iter(v['geometry'].values()))['stages']} stages, "
        + ", ".join(f"{w[:-2]} channels {g['bytes']:,} B" for w, g in v["geometry"].items()
                    if w.endswith("x1"))
        + f" a block, 1 block an SM, <= {v['max_registers']} registers, "
        f"{v['spill_store_bytes']} B spilled" for name, v in out.items()))
    regs, spills = ptxas_most(logs.get("packed_convpool", ""))
    out["packed_convpool_fp32"] = {
        "bytes": {cout: pk.conv_ring_bytes(cout) for cout in (64, 32, 16, 8)},
        "blocks_per_sm": {cout: pk.ring_blocks_per_sm(pk.conv_ring_bytes(cout))
                          for cout in (64, 32, 16, 8)},
        "max_registers": regs, "spill_store_bytes": spills}
    print(f"  packed_convpool on the fp32 ring (csrc/conv_ring.cuh ConvPoolRing): "
          f"<= {regs} registers, {spills} B spilled")
    return out


def phase_kernels(pk, pro_gan) -> list[dict]:
    """Each kernel at its main-path shapes against its plain twin."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"

    def feats(*shape):  # post-PixelNorm features, like the generator's
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t))

    B = BATCH_KERNELS
    rows = []

    # -- packed_upconv: stage 7 (128 -> 64, 256² -> 512²), stage 8 + toRGB
    up_calls = []
    for label, c, cout, h, rgb in (("stage7", 128, 64, 256, False),
                                   ("stage8+rgb", 64, 32, 512, True)):
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        kw = {}
        if rgb:
            kw = {"rgb_w": conv_w(3, c, 1, 1.0).reshape(3, c), "rgb_b": bias(3)}
        got = pk.packed_upconv(x, w, b, **kw)
        check_two_runs(f"packed_upconv[{label}]", got, pk.packed_upconv(x, w, b, **kw))
        want = pk.packed_upconv_plain(x, w, b, **kw)
        got, want = (got, want) if rgb else ((got,), (want,))
        err = 0.0
        for g, t in zip(got, want):
            torch.testing.assert_close(g, t, atol=1e-4, rtol=1e-4)
            err = max(err, (g - t).abs().max().item())

        def library():
            y = lrelu_norm(F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"),
                                    w, b, padding=1))
            if rgb:
                return y, F.conv2d(x, kw["rgb_w"][:, :, None, None], kw["rgb_b"])
            return y

        flops = 2 * 4 * c * cout * B * 4 * h * h + (2 * c * 3 * B * h * h if rgb else 0)
        nbytes = 4 * (B * c * h * h + B * cout * 4 * h * h + 9 * c * cout + cout
                      + ((3 * c + 3 + B * 3 * h * h) if rgb else 0))
        up_calls.append({
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": err, "bit_equal_runs": True,
            "ms": cuda_ms(lambda: pk.packed_upconv(x, w, b, **kw)),
            "plain_ms": cuda_ms(lambda: pk.packed_upconv_plain(x, w, b, **kw)),
            "library_ms": cuda_ms(library), "flops": flops, "bytes": nbytes,
        })
        del x, got, want
    rows.append(("packed_upconv", "packed_upconv", "probgan_tpu/ops/pallas_packed.py:832",
                 up_calls))

    # -- packed_conv: stage 7 conv2 (64 -> 64 at 512²)
    c, cout, h = 64, 64, 512
    x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
    got, want = pk.packed_conv(x, w, b), pk.packed_conv_plain(x, w, b)
    check_two_runs("packed_conv[lrelu_norm]", got, pk.packed_conv(x, w, b))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    rows.append(("packed_conv", "packed_conv", "probgan_tpu/ops/pallas_packed.py:382", [{
        "call": "stage7", "shape_in": [B, c, h, h], "bit_equal_runs": True,
        "max_abs_err": (got - want).abs().max().item(),
        "ms": cuda_ms(lambda: pk.packed_conv(x, w, b)),
        "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b)),
        "library_ms": cuda_ms(lambda: lrelu_norm(F.conv2d(x, w, b, padding=1))),
        "flops": 2 * 9 * c * cout * B * h * h,
        "bytes": 4 * (2 * B * c * h * h + 9 * c * cout + cout),
    }]))
    del x, got, want

    # -- packed_conv_rgb (the fp32 ring with the toRGB tail): stage 8 conv2
    # (32 -> 32 at 1024²) -> uint8 NHWC at the main path's alpha = 1, timed;
    # then fp32 at a fade-in alpha, and both at stage 7 (64 -> 64 at 512²),
    # where a generator of 512² ends: each two runs bit-equal
    rgb_calls = []
    for label, c, cout, h in (("stage8", 32, 32, 1024), ("stage7", 64, 64, 512)):
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
        prev = 0.5 * torch.randn((B, 3, h // 2, h // 2), device=dev, generator=gen)
        args = (x, w, b, rgb_w, rgb_b, prev)
        # fp32 emission at a fade-in alpha: the blend itself to fp32 tolerance
        got = pk.packed_conv_rgb(*args, 0.3)
        check_two_runs(f"packed_conv_rgb[{label},fp32]", got, pk.packed_conv_rgb(*args, 0.3))
        want = pk.packed_conv_rgb_plain(*args, 0.3)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        err_fp32 = (got - want).abs().max().item()
        # uint8 emission at alpha = 1
        got = pk.packed_conv_rgb(*args, 1.0, emit_uint8=True)
        again = pk.packed_conv_rgb(*args, 1.0, emit_uint8=True)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"packed_conv_rgb[{label},uint8]: two runs on one input differ")
        want = pk.packed_conv_rgb_plain(*args, 1.0, emit_uint8=True)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (B, h, h, 3)
        worst, _, psnr = check_uint8(f"packed_conv_rgb[{label}] uint8 vs plain",
                                     got.cpu().numpy(), want.cpu().numpy())

        def library(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev):
            feat = lrelu_norm(F.conv2d(x, w, b, padding=1))
            rgb = F.conv2d(feat, rgb_w[:, :, None, None], rgb_b)
            up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
            return pro_gan.to_uint8((up + 1.0 * (rgb - up)).permute(0, 2, 3, 1))

        call = {
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": float(worst),
            "max_abs_err_fp32": err_fp32, "psnr_db": finite_or_none(psnr),
            "bit_equal_runs": True,
            "ms": cuda_ms(lambda: pk.packed_conv_rgb(*args, 1.0, emit_uint8=True)),
            "fp32_ms": cuda_ms(lambda: pk.packed_conv_rgb(*args, 0.3)),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_rgb_plain(*args, 1.0, emit_uint8=True)),
            "library_ms": cuda_ms(library),
            "flops": 2 * 9 * c * cout * B * h * h + 2 * cout * 3 * B * h * h,
            "bytes": 4 * (B * c * h * h + 9 * c * cout + cout + 3 * cout + 3
                          + B * 3 * (h // 2) ** 2) + B * h * h * 3,
        }
        rgb_calls.append(call)
        del x, got, again, want, args, prev
    # the entry's own numbers are the main path's call (stage 8, uint8); the
    # stage-7 call stays beside it, checked and timed
    entries = assemble_conv_rows(
        rows + [("packed_conv_rgb", "packed_conv_rgb", "probgan_tpu/ops/pallas_packed.py:678",
                 rgb_calls[:1])], B)
    entries[-1]["beside_calls"] = [call_bound("packed_conv_rgb", rgb_calls[1])]
    return entries


def call_bound(name: str, k: dict) -> dict:
    """One call's bound and share of it, printed. A call may run more
    operations than its FLOP count ("op_flops", the three TF32 passes of
    packed_conv_wgrad) at another peak ("peak_flops")."""
    k["bound_ms"], k["bound_by"] = bound(k.pop("op_flops", k["flops"]), k["bytes"],
                                         k.pop("peak_flops", PEAK_FP32_FLOPS))
    k["roofline_share"] = k["bound_ms"] / k["ms"]
    extra = (f", fp32 CUDA-core bound {k['bound_fp32_ms']:.3f} ms"
             if "bound_fp32_ms" in k else "")
    print(f"  {name}[{k['call']}] x{k['shape_in']}: max_abs_err "
          f"{k['max_abs_err']:.3g}  kernel {k['ms']:.3f} ms  plain "
          f"{k['plain_ms']:.3f} ms  library {k['library_ms']:.3f} ms  bound "
          f"{k['bound_ms']:.3f} ms ({k['roofline_share']:.0%}, {k['bound_by']}, "
          f"{k['flops'] / 1e9:.1f} GFLOP, {k['bytes'] / 1e6:.1f} MB{extra})")
    return k


def assemble_conv_rows(rows, batch: int) -> list[dict]:
    """Kernel entries of the ``kernels`` line from per-call measurements:
    an entry's times and bound are the sums over its calls. Calls checked
    and timed at other shapes than the main path's go under the entry's
    ``beside_calls``, outside those sums."""
    out = []
    for name, source, replaces, calls in rows:
        peak = calls[0].get("peak_flops", PEAK_FP32_FLOPS)
        op_flops = sum(k.get("op_flops", k["flops"]) for k in calls)
        nbytes = sum(k["bytes"] for k in calls)
        bound_ms, bound_by = bound(op_flops, nbytes, peak)
        entry = {
            "name": name, "route": "cuda",
            "source": f"probgan_tpu_torch/csrc/{source}.cu", "replaces": replaces,
            "launches": 0,
            "max_abs_err": max(k["max_abs_err"] for k in calls),
            "ms": sum(k["ms"] for k in calls),
            "plain_ms": sum(k["plain_ms"] for k in calls),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(k["library_ms"] for k in calls),
            "batch": batch, "calls": [call_bound(name, k) for k in calls],
        }
        out.append(entry)
    return out


def phase_d_kernels(pk, image_ops, pro_gan) -> list[dict]:
    """The discriminator's kernels and the denorm kernel at path I's shapes
    (the convs at batch 2, the denorm at batch 8) against their plain twins."""
    gen = torch.Generator(device="cuda").manual_seed(2345)
    dev = "cuda"
    B = BATCH_KERNELS

    def feats(*shape):  # post-LeakyReLU features, like the discriminator's
        return pro_gan.lrelu(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin):
        w = torch.randn((cout, cin, 3, 3), device=dev, generator=gen)
        return w * (math.sqrt(2.0) / math.sqrt(cin * 9))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    conv_calls, pool_calls = [], []
    for label, c, h in (("stage8", 32, 1024), ("stage7", 64, 512)):
        x = feats(B, c, h, h)
        # conv1: C -> C, "lrelu"
        w, b = conv_w(c, c), bias(c)
        got = pk.packed_conv(x, w, b, epilogue="lrelu")
        check_two_runs(f"packed_conv[lrelu] {label}", got,
                       pk.packed_conv(x, w, b, epilogue="lrelu"))
        want = pk.packed_conv_plain(x, w, b, epilogue="lrelu")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        # B2 "lrelu" pooled in B5's order against B5 "lrelu" at the same
        # (C, Cout = C): the same sums, bit for bit
        n_b5 = differing_bits(pool_in_b5_order(got),
                              pk.packed_convpool(x, w, b, epilogue="lrelu"))
        print(f"  packed_conv[lrelu] {label} C{c}->Cout{c}: pooled in B5's order, values "
              f"differing from packed_convpool[lrelu] {n_b5}; two runs bit-equal")
        if n_b5:
            raise AssertionError(f"packed_conv[lrelu] {label}: not B5's sums")
        conv_calls.append({
            "call": label, "shape_in": [B, c, h, h], "bit_equal_runs": True,
            "differing_vs_b5_pooled": n_b5,
            "max_abs_err": (got - want).abs().max().item(),
            "ms": cuda_ms(lambda: pk.packed_conv(x, w, b, epilogue="lrelu")),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b, epilogue="lrelu")),
            "library_ms": cuda_ms(lambda: F.leaky_relu(F.conv2d(x, w, b, padding=1), 0.2)),
            "flops": 2 * 9 * c * c * B * h * h,
            "bytes": 4 * (2 * B * c * h * h + 9 * c * c + c),
        })
        del got, want
        # conv2 + pool: C -> 2C, "lrelu" before the 2x2 mean
        cout = 2 * c
        w, b = conv_w(cout, c), bias(cout)
        got = pk.packed_convpool(x, w, b, epilogue="lrelu")
        want = pk.packed_convpool_plain(x, w, b, epilogue="lrelu")
        if tuple(got.shape) != (B, cout, h // 2, h // 2):
            raise AssertionError(f"packed_convpool returned {tuple(got.shape)}")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        # convpool_lrelu's backward recomputes this conv's lrelu with B2
        # "lrelu" (RECOMPUTE_SHAPES): pooled in B5's order it must be B5's
        # output, bit for bit
        assert (c, cout, h) in RECOMPUTE_SHAPES
        u = pk.packed_conv(x, w, b, epilogue="lrelu")
        check_two_runs(f"packed_conv[lrelu] recompute C{c}->Cout{cout}@{h}", u,
                       pk.packed_conv(x, w, b, epilogue="lrelu"))
        n_b5 = differing_bits(pool_in_b5_order(u), got)
        print(f"  packed_conv[lrelu] recompute C{c}->Cout{cout}@{h}: pooled in B5's order, "
              f"values differing from packed_convpool[lrelu] {n_b5}; two runs bit-equal")
        if n_b5:
            raise AssertionError(f"packed_conv[lrelu] C{c}->Cout{cout}@{h}: the recompute "
                                 "does not give packed_convpool's sums")
        u_plain = pk.packed_conv_plain(x, w, b, epilogue="lrelu")
        conv_calls.append({
            "call": f"recompute C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h],
            "bit_equal_runs": True, "differing_vs_b5_pooled": n_b5,
            "max_abs_err": (u - u_plain).abs().max().item(),
            "ms": cuda_ms(lambda: pk.packed_conv(x, w, b, epilogue="lrelu")),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b, epilogue="lrelu")),
            "library_ms": cuda_ms(lambda: F.leaky_relu(F.conv2d(x, w, b, padding=1), 0.2)),
            "flops": 2 * 9 * c * cout * B * h * h,
            "bytes": 4 * (B * c * h * h + B * cout * h * h + 9 * c * cout + cout),
        })
        del u, u_plain
        pool_calls.append({
            "call": label, "shape_in": [B, c, h, h],
            "max_abs_err": (got - want).abs().max().item(),
            "ms": cuda_ms(lambda: pk.packed_convpool(x, w, b, epilogue="lrelu")),
            "plain_ms": cuda_ms(lambda: pk.packed_convpool_plain(x, w, b, epilogue="lrelu")),
            "library_ms": cuda_ms(lambda: F.avg_pool2d(
                F.leaky_relu(F.conv2d(x, w, b, padding=1), 0.2), 2)),
            "flops": 2 * 9 * c * cout * B * h * h + 4 * cout * B * h * h,
            "bytes": 4 * (B * c * h * h + B * cout * (h // 2) ** 2 + 9 * c * cout + cout),
        })
        del got, want
        if label == "stage7":  # the "none" epilogues (no path runs them yet), untimed
            for fn, twin, ww, bb in ((pk.packed_conv, pk.packed_conv_plain, conv_w(c, c), bias(c)),
                                     (pk.packed_convpool, pk.packed_convpool_plain, w, b)):
                torch.testing.assert_close(fn(x, ww, bb, epilogue="none"),
                                           twin(x, ww, bb, epilogue="none"),
                                           atol=1e-4, rtol=1e-4)
        del x
    rows = assemble_conv_rows([
        ("packed_conv[lrelu]", "packed_conv", "probgan_tpu/ops/pallas_packed.py:382", conv_calls),
        ("packed_convpool", "packed_convpool", "probgan_tpu/ops/pallas_packed.py:452",
         pool_calls)], B)

    # -- to_uint8_fused at the 1024² batch-8 image
    shape = (BATCH_MAIN, 1024, 1024, 3)
    x = 1.5 * torch.randn(shape, device=dev, generator=gen)
    got, want = image_ops.to_uint8_fused(x), image_ops.to_uint8_fused_plain(x)
    torch.cuda.synchronize()
    if got.dtype != torch.uint8 or tuple(got.shape) != shape:
        raise AssertionError(f"to_uint8_fused returned {got.dtype} {tuple(got.shape)}")
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    flipped = diff != 0
    # +-1 only where tanh lands on a rounding boundary: the denorm value,
    # recomputed in float64, lies within 1e-3 of a half there
    pre = (torch.tanh(x[flipped].double()) + 1.0) * 127.5
    off_half = (pre - torch.floor(pre) - 0.5).abs()
    worst = int(diff.max().item())
    print(f"  to_uint8_fused x{list(shape)}: max |diff| {worst}, differing bytes "
          f"{flipped.float().mean().item():.6%}")
    if worst > 1 or (off_half.numel() and off_half.max().item() > 1e-3):
        raise AssertionError("to_uint8_fused: differs from its twin away from a "
                             "rounding boundary")
    for odd in ((3, 5, 7), (1,), (1027,)):  # counts that are no multiple of 4
        y = 2.0 * torch.randn(odd, device=dev, generator=gen)
        if (image_ops.to_uint8_fused(y).to(torch.int16)
                - image_ops.to_uint8_fused_plain(y).to(torch.int16)).abs().max().item() > 1:
            raise AssertionError(f"to_uint8_fused: wrong at shape {odd}")
    n = x.numel()
    entry = {
        "name": "to_uint8_fused", "route": "cuda",
        "source": "probgan_tpu_torch/csrc/denorm_uint8.cu",
        "replaces": "probgan_tpu/ops/pallas_image.py:53", "launches": 0,
        "max_abs_err": float(worst),
        "differing_bytes": flipped.float().mean().item(),
        "ms": cuda_ms(lambda: image_ops.to_uint8_fused(x)),
        "plain_ms": cuda_ms(lambda: image_ops.to_uint8_fused_plain(x)),
        "library_ms": cuda_ms(lambda: torch.clamp(
            torch.round((torch.tanh(x) + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)),
        "batch": BATCH_MAIN, "shape_in": list(shape),
    }
    entry["bound_ms"], entry["bound_by"] = bound(6.0 * n, 5.0 * n)
    print(f"  to_uint8_fused: kernel {entry['ms']:.3f} ms  plain {entry['plain_ms']:.3f} ms  "
          f"library {entry['library_ms']:.3f} ms  bound {entry['bound_ms']:.3f} ms "
          f"({entry['bound_by']}, {5.0 * n / 1e6:.1f} MB)")
    return rows + [entry]


def check_topk(label: str, values, ids, plain_scores, planted=None) -> float:
    """Hold one fused top-k result against the plain scores [B, nvalid] of
    the same inputs, by the rule in the module docstring. Returns the max
    |value - plain top-k value|."""
    k = ids.shape[1]
    want_v = torch.sort(plain_scores, dim=1, descending=True, stable=True)[0][:, :k]
    err = (values - want_v).abs().max().item()
    if err > RANK_ATOL:
        raise AssertionError(f"{label}: top-k values differ from the plain twin by {err:.3g}")
    if (values[:, 1:] > values[:, :-1]).any():
        raise AssertionError(f"{label}: values are not in descending order")
    if ids.min() < 0 or ids.max() >= plain_scores.shape[1]:
        raise AssertionError(f"{label}: an id lies outside [0, nvalid)")
    if (torch.sort(ids, dim=1)[0].diff(dim=1) == 0).any():
        raise AssertionError(f"{label}: an id is returned twice")
    own = torch.gather(plain_scores, 1, ids)
    if (own - values).abs().max().item() > RANK_ATOL:
        raise AssertionError(f"{label}: a returned id's plain score is not its value")
    rest = plain_scores.clone().scatter_(1, ids, float("-inf")).max(dim=1)[0]
    if (rest > values[:, -1] + RANK_ATOL).any():
        raise AssertionError(f"{label}: an entity left out beats the k-th value")
    if planted is not None and ids[0, :len(planted)].tolist() != planted:
        raise AssertionError(f"{label}: tied rows {planted} came as "
                             f"{ids[0, :len(planted)].tolist()}, not in ascending id")
    return err


def phase_rank_kernels(rf, rank_ops) -> list[dict]:
    """The fused rank kernels at the KG path's shapes against their plain
    twins: N = 1,000,000 rows, D = 128."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    n, d, k = KG_ENTITIES, KG_DIM, KG_TOP_K
    table = rank_ops.l2_normalize(torch.randn((n, d), device="cuda", generator=gen))
    # bit-equal rows, across tile and block boundaries: their scores tie
    planted = [5, 2047, 2048, 300_000, n - 1]
    for row in planted[1:]:
        table[row] = table[5]
    preds = {b: torch.randn((b, d), device="cuda", generator=gen) for b in (KG_BATCH, 8)}
    # rows whose cosines with query 1 differ by 1e-4: distinct in fp32, ties
    # or reversed in bf16 (steps of 2**-8); the top k of them are the answer
    near = [900_000 - 7919 * j for j in range(12)]
    q1 = rank_ops.l2_normalize(preds[KG_BATCH][1:2].clone())[0]
    for j, row in enumerate(near):
        r = table[row] - (table[row] @ q1) * q1
        c = 0.9 + 1e-4 * j
        table[row] = rank_ops.l2_normalize((c * q1 + math.sqrt(1.0 - c * c)
                                            * rank_ops.l2_normalize(r[None])[0])[None])[0]
    near_order = near[::-1][:k]
    for pred in preds.values():
        pred[0] = 3.0 * table[5]  # query 0 ties on the planted rows
        pred[1] = 2.0 * q1
    table_bf16 = table.to(torch.bfloat16)
    plain_scores = {b: rf.rank_scores_fused_plain(pred, table) for b, pred in preds.items()}

    fp32_ids = {}

    def topk_call(label, b, nvalid, local=False, planted_rows=None, bf16=False):
        pred = preds[b]
        name = "rank_topk_bf16" if bf16 else "rank_topk"
        if bf16:
            def fn(p, t, kk, nv):
                return rf.rank_topk_fused(p, t, kk, nv, table_bf16=table_bf16)

            def twin(p, t, kk, nv):
                return rf.rank_topk_fused_plain(p, t, kk, nv, table_bf16=table_bf16)
        elif local:
            pred = rank_ops.l2_normalize(pred)
            fn, twin = rf.rank_topk_local, rf.rank_topk_local_plain
        else:
            fn, twin = rf.rank_topk_fused, rf.rank_topk_fused_plain
        values, ids = fn(pred, table, k, nvalid)
        torch.cuda.synchronize()
        err = check_topk(f"{name}[{label}]", values, ids,
                         plain_scores[b][:, :nvalid], planted_rows)
        if ids[1].tolist() != near_order:
            raise AssertionError(f"{name}[{label}]: query 1's rows 1e-4 apart came as "
                                 f"{ids[1].tolist()}, not {near_order}")
        twin_v, twin_i = twin(pred, table, k, nvalid)
        call = {
            "call": label, "shape_in": [b, d], "rows": n, "nvalid": nvalid, "k": k,
            "max_abs_err": err,
            "ids_equal_to_plain": (ids == twin_i).float().mean().item(),
            "ms": cuda_ms(lambda: fn(pred, table, k, nvalid)),
            "plain_ms": cuda_ms(lambda: twin(pred, table, k, nvalid), iters=3, warmup=1),
        }
        if bf16:
            # the ids of B4, the fp32 kernel (check_topk above holds both to
            # the plain fp32 scores)
            call["ids_equal_to_fp32_kernel"] = (ids == fp32_ids[label]).float().mean().item()
            if not torch.equal(ids, fp32_ids[label]):
                raise AssertionError(f"{name}[{label}]: ids differ from the fp32 kernel's")
            m = min(k + rf.BF16_RESCORE_POOL, nvalid)
            # the merge kernel alone against its plain twin on the stream's
            # candidates, and the one-call path against its two parts
            cand_v, cand_i = rf.pool_candidates_bf16(pred, table_bf16, m, nvalid, True)
            merge_v, merge_i = rf.merge_rescore_bf16(cand_v, cand_i, pred, table, k, m)
            twin_mv, twin_mi = rf.merge_rescore_bf16_plain(cand_v, cand_i, pred, table, k, m)
            torch.cuda.synchronize()
            merge_err = (merge_v - twin_mv).abs().max().item()
            if not torch.equal(merge_i, twin_mi) or merge_err > RANK_ATOL:
                raise AssertionError(f"{name}[{label}]: the merge kernel differs from its "
                                     f"plain twin (ids equal {torch.equal(merge_i, twin_mi)}, "
                                     f"values by {merge_err:.3g})")
            if not (torch.equal(merge_i, ids) and torch.equal(merge_v, values)):
                raise AssertionError(f"{name}[{label}]: the one-call path differs from its "
                                     "stream and merge launched apart")
            pred_bf16 = F.normalize(pred).to(torch.bfloat16)
            call.update({
                "merge_max_abs_err": merge_err,
                "stream_ms": cuda_ms(
                    lambda: rf.pool_candidates_bf16(pred, table_bf16, m, nvalid, True)),
                "merge_ms": cuda_ms(
                    lambda: rf.merge_rescore_bf16(cand_v, cand_i, pred, table, k, m)),
                "merge_plain_ms": cuda_ms(
                    lambda: rf.merge_rescore_bf16_plain(cand_v, cand_i, pred, table, k, m)),
                "library_ms": cuda_ms(lambda: torch.topk(
                    torch.matmul(pred_bf16, table_bf16[:nvalid].T), k)),
                "flops": 2.0 * b * nvalid * d,
                # the bf16 table once, the queries, the m fp32 rows per query
                # that the rescore gathers, the result
                "bytes": 2.0 * nvalid * d + 4.0 * b * d + 4.0 * b * m * d + b * k * (4 + 8),
                "peak_flops": PEAK_BF16_FLOPS,
            })
        else:
            fp32_ids[label] = ids
            flops, nbytes = 2.0 * b * nvalid * d, 4.0 * (b * d + nvalid * d) + b * k * (4 + 8)
            call.update({
                "kernel_only_ms": cuda_ms(
                    lambda: rf.topk_candidates(pred, table, k, nvalid, not local)),
                "library_ms": cuda_ms(lambda: torch.topk(
                    torch.matmul(F.normalize(pred), table[:nvalid].T), k)),
                "flops": flops, "bytes": nbytes,
                # B7's product: three TF32 tensor-core products per product;
                # the fp32 CUDA-core bound of the same function beside it
                "op_flops": 3 * flops, "peak_flops": PEAK_TF32_FLOPS,
                "bound_fp32_ms": bound(flops, nbytes)[0],
            })
        return call

    topk_calls = [
        topk_call(f"B{KG_BATCH}", KG_BATCH, n, planted_rows=planted),
        topk_call("B8", 8, n, planted_rows=planted),
        # rows at or past nvalid never win, the last planted row among them
        topk_call(f"B{KG_BATCH},nvalid<rows", KG_BATCH, n - 1000, planted_rows=planted[:-1]),
        topk_call(f"local,B{KG_BATCH}", KG_BATCH, n, local=True, planted_rows=planted),
    ]
    bf16_calls = [
        topk_call(f"B{KG_BATCH}", KG_BATCH, n, planted_rows=planted, bf16=True),
        topk_call("B8", 8, n, planted_rows=planted, bf16=True),
        topk_call(f"B{KG_BATCH},nvalid<rows", KG_BATCH, n - 1000, planted_rows=planted[:-1],
                  bf16=True),
    ]
    # what the k compare-and-insert passes cost: the kernel alone at k = 1 / 16
    k_sweep = {f"B{b}": {str(kk): cuda_ms(
        lambda kk=kk, pred=pred: rf.topk_candidates(pred, table, kk, n, True))
        for kk in (1, KG_TOP_K, 16)} for b, pred in preds.items()}

    # rank_topk's scores are rank_scores' (one 3xTF32 product, one order of
    # sums): its (values, ids) must equal rank_scores followed by the stable
    # top-k bit for bit, at every k, batch and nvalid, and through
    # rank_topk_local (queries normalized outside, normalize = 0 in both)
    bit_equal_cases = 0
    for b, pred in preds.items():
        pred_norm = rank_ops.l2_normalize(pred)
        scores = rf.rank_scores_fused(pred, table)
        scores_local = torch.empty_like(scores)
        rf.launch_rank_scores(pred_norm, table, scores_local, normalize=False)
        for nvalid in (n, n - 1000):
            for kk in (1, KG_TOP_K, 16):
                for how, (got_v, got_i), full in (
                        ("fused", rf.rank_topk_fused(pred, table, kk, nvalid), scores),
                        ("local", rf.rank_topk_local(pred_norm, table, kk, nvalid),
                         scores_local)):
                    want_v, want_i = rank_ops.top_k_lowest_index(full[:, :nvalid], kk)
                    torch.cuda.synchronize()
                    if differing_bits(got_v, want_v) or not torch.equal(got_i, want_i):
                        raise AssertionError(
                            f"rank_topk[{how},B{b},nvalid={nvalid},k={kk}]: not bit-equal to "
                            "rank_scores followed by top_k_lowest_index")
                    bit_equal_cases += 1
        del scores, scores_local
    print(f"  rank_topk: (values, ids) bit-equal to rank_scores + top_k_lowest_index in "
          f"{bit_equal_cases} cases (B {sorted(preds)}, nvalid {n} and {n - 1000}, "
          "k 1/10/16, fused and local)")

    # rank_scores (3xTF32): B = 64, 8 and 1 against the main table (N not a
    # multiple of 128, duplicates across tiles and blocks), and against a
    # table whose D = 100 is padded to 104 in the kernel; a zero query row in
    # each batch of 3 or more
    side_n, side_d = 100_003, 100
    side = rank_ops.l2_normalize(torch.randn((side_n, side_d), device="cuda", generator=gen))
    side_planted = [5, 127, 128, 50_000, side_n - 1]
    for row in side_planted[1:]:
        side[row] = side[5]
    scores_calls = []
    for tab, rows_planted, b in ((table, planted, KG_BATCH), (table, planted, 8),
                                 (table, planted, 1), (side, side_planted, KG_BATCH),
                                 (side, side_planted, 8), (side, side_planted, 1)):
        nn, dd = tab.shape
        pred = torch.randn((b, dd), device="cuda", generator=gen)
        pred[0] = 3.0 * tab[5]  # scores of 1 on the planted rows
        if b >= 3:
            pred[2] = 0.0
        got = rf.rank_scores_fused(pred, tab)
        want = rf.rank_scores_fused_plain(pred, tab)
        torch.cuda.synchronize()
        label = f"B{b},N{nn},D{dd}"
        err = (got - want).abs().max().item()  # over the whole [B, N] matrix
        if err > RANK_ATOL or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rank_scores[{label}]: differs from the plain twin by {err:.3g}")
        if not all(torch.equal(got[:, rows_planted[0]], got[:, r]) for r in rows_planted[1:]):
            raise AssertionError(f"rank_scores[{label}]: duplicate rows {rows_planted} got "
                                 "scores that are not bit-equal")
        if b >= 3 and got[2].abs().max().item() != 0.0:
            raise AssertionError(f"rank_scores[{label}]: a zero query row must give zeros")
        call = {"call": label, "shape_in": [b, dd], "rows": nn, "max_abs_err": err,
                "duplicates_bit_equal": True}
        if tab is table and b in (KG_BATCH, 8):
            out = torch.empty_like(got)
            flops, nbytes = 2.0 * b * nn * dd, 4.0 * (b * dd + nn * dd + b * nn)
            call.update({
                "ms": cuda_ms(lambda: rf.rank_scores_fused(pred, tab)),
                "kernel_only_ms": cuda_ms(lambda: rf.launch_rank_scores(pred, tab, out)),
                "plain_ms": cuda_ms(lambda: rf.rank_scores_fused_plain(pred, tab)),
                "library_ms": cuda_ms(lambda: torch.matmul(F.normalize(pred), tab.T)),
                "flops": flops, "bytes": nbytes,
                # three TF32 tensor-core products per product; the fp32
                # CUDA-core bound of the same function beside it
                "op_flops": 3 * flops, "peak_flops": PEAK_TF32_FLOPS,
                "bound_fp32_ms": bound(flops, nbytes)[0],
            })
            del out
        scores_calls.append(call)
        print(f"  rank_scores[{label}]: max |err| vs the twin {err:.3g} over the whole "
              f"matrix (bound {RANK_ATOL:g}); duplicate rows bit-equal")
        del got, want
    zero = rf.rank_scores_fused(torch.zeros((8, d), device="cuda"), table)
    if zero.abs().max().item() != 0.0:
        raise AssertionError("rank_scores: a zero query row must give zeros")
    del zero, side

    out = []
    for name, replaces, calls in (
            ("rank_topk", "probgan_tpu/ops/pallas_rank.py:261", topk_calls),
            ("rank_scores", "probgan_tpu/ops/pallas_rank.py:52", scores_calls),
            ("rank_topk_bf16", "probgan_tpu/ops/pallas_rank.py:211", bf16_calls)):
        calls_timed = [c for c in calls if "ms" in c]
        for c in calls_timed:
            c["bound_ms"], c["bound_by"] = bound(c.pop("op_flops", c["flops"]), c["bytes"],
                                                 c.pop("peak_flops"))
            parts = (f"  (stream alone {c['stream_ms']:.3f} ms, merge alone "
                     f"{c['merge_ms']:.3f} ms, its plain twin {c['merge_plain_ms']:.3f} ms, "
                     f"merge vs twin {c['merge_max_abs_err']:.3g})" if "stream_ms" in c else "")
            if "bound_fp32_ms" in c:
                parts += (f"  (kernel alone {c['kernel_only_ms']:.3f} ms; bound at TF32 x3 "
                          f"beside the fp32 CUDA-core bound {c['bound_fp32_ms']:.3f} ms)")
            print(f"  {name}[{c['call']}] x{c['shape_in']} vs {c['rows']} rows: max_abs_err "
                  f"{c['max_abs_err']:.3g}  kernel {c['ms']:.3f} ms  plain "
                  f"{c['plain_ms']:.3f} ms  library {c['library_ms']:.3f} ms  bound "
                  f"{c['bound_ms']:.3f} ms ({c['bound_by']}, {c['flops'] / 1e9:.1f} GFLOP, "
                  f"{c['bytes'] / 1e6:.1f} MB){parts}")
        # the entry's own numbers are those of the main path's shape: calls[0]
        head = calls_timed[0]
        entry = {
            "name": name, "route": "cuda",
            "source": f"probgan_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in calls),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "batch": head["shape_in"][0], "calls": calls,
        }
        if name == "rank_topk":
            entry["kernel_only_ms_by_k"] = k_sweep
            entry["bit_equal_to_rank_scores_topk_cases"] = bit_equal_cases
            print(f"  rank_topk kernel alone (no merge) by batch and k: {k_sweep}")
        out.append(entry)
    return out


def phase_main_path(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    assert pro_gan.packed_start_stage(cfg, stage) == 7
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    engine.generate(engine.sample_latents(BATCH_MAIN))  # warm-up (cuDNN plans)
    latents = [engine.sample_latents(BATCH_MAIN) for _ in range(MAIN_BATCHES)]
    torch.cuda.synchronize()

    pk.reset_launches()
    times, img = [], None
    for z in latents:
        t0 = time.perf_counter()
        img = engine.generate(z)  # returns host numpy: the call has finished
        times.append(time.perf_counter() - t0)
    counts = dict(pk.launches)

    per_call = {"packed_upconv": 2, "packed_conv": 1, "packed_conv_rgb": 1}
    print(f"  launch counts over {MAIN_BATCHES} generate calls: {counts}")
    for name, n in per_call.items():
        if counts[name] != n * MAIN_BATCHES:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{n} per generate call")
    if img.dtype != np.uint8 or img.shape != (BATCH_MAIN, cfg.resolution, cfg.resolution, 3):
        raise AssertionError(f"generate returned {img.dtype} {img.shape}")

    z = latents[-1]
    # The same engine with each kernel's plain twin in its place, on the card.
    with swap_in_plain_twins(pk, list(per_call)):
        twins = engine.generate(z)
    worst, share, psnr = check_uint8("main path vs its plain twins on the card", img, twins)
    # and the unpacked path (all stages through ops/fused_upconv.py + cuDNN)
    ref = pro_gan.generator_apply(engine.g_params, z, cfg, stage, 1.0, precision="high",
                                  packed=False).cpu().numpy()
    _, _, psnr_unpacked = check_uint8("main path vs the unpacked path on the card", img, ref)
    if min(psnr, psnr_unpacked) < PSNR_FLOOR_DB:
        raise AssertionError(f"PSNR {min(psnr, psnr_unpacked):.2f} dB < {PSNR_FLOOR_DB} dB")

    # fade-in renders: stage 7 alone on the kernels (Cout 64 with toRGB and
    # the fused tail) and stage 8 at alpha 0.3, against the unpacked path
    for st, alpha in ((7, 0.5), (8, 0.3)):
        got = engine.generate(z[:2], stage=st, alpha=alpha)
        want = pro_gan.generator_apply(engine.g_params, z[:2], cfg, st, alpha, precision="high",
                                       packed=False).cpu().numpy()
        _, _, p = check_uint8(f"stage {st} alpha {alpha} vs the unpacked path", got, want)
        if p < PSNR_FLOOR_DB:
            raise AssertionError(f"stage {st}: PSNR {p:.2f} dB < {PSNR_FLOOR_DB} dB")

    cpu_params = engine_mod.to_device(engine.g_params, torch.device("cpu"))
    with torch.inference_mode():
        cpu_img = pro_gan.generator_apply(cpu_params, z[:1].cpu(), cfg, stage, 1.0,
                                          precision="high", packed=True).numpy()
    _, _, psnr_cpu = uint8_agreement(img[:1], cpu_img)
    print(f"  main path image 0 vs the plain path on the CPU: PSNR {psnr_cpu:.2f} dB")
    if psnr_cpu < PSNR_FLOOR_DB:
        raise AssertionError(f"card vs CPU PSNR {psnr_cpu:.2f} dB < {PSNR_FLOOR_DB} dB")

    per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
    main = {
        "batch": BATCH_MAIN, "calls": MAIN_BATCHES,
        "img_per_s": BATCH_MAIN * MAIN_BATCHES / sum(times),
        "p50_ms_per_img": float(np.median(per_img_ms)),
        "batch_s": times, "psnr_vs_plain_twins_db": finite_or_none(psnr),
        "max_abs_diff": worst, "differing_bytes": share,
        "psnr_vs_unpacked_db": finite_or_none(psnr_unpacked),
        "psnr_vs_cpu_db": finite_or_none(psnr_cpu),
    }
    print(f"  {main['img_per_s']:.3f} img/s, p50 {main['p50_ms_per_img']:.3f} ms/img "
          f"(batch {BATCH_MAIN}, {MAIN_BATCHES} calls, host clock incl. copy to host)")
    return counts, main


def scaled_err(label: str, got: torch.Tensor, want: torch.Tensor, rel: float = GRAD_REL) -> float:
    """max |got - want| over max |want|; raises above ``rel``."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             "or a value that is not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > rel * scale:
        raise AssertionError(f"{label}: differs by {err:.3g}, more than {rel:g} of the "
                             f"largest entry {scale:.3g}")
    return err


def phase_train_kernels(pk, packed_vjp, pro_gan) -> list[dict]:
    """The backward's kernels at the 1024² train step's shapes (batch 2)
    against their plain twins, and the four Functions against autograd."""
    gen = torch.Generator(device="cuda").manual_seed(3456)
    dev = "cuda"
    B = TRAIN_BATCH

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def conv_w(cout, cin):
        return randn(cout, cin, 3, 3) * (math.sqrt(2.0) / math.sqrt(cin * 9))

    # -- packed_conv_wgrad at the six distinct (C, Cout, H) of the step
    wgrad_calls = []
    for c, cout, h in ((32, 32, 1024), (32, 64, 1024), (64, 64, 512), (64, 128, 512),
                       (128, 64, 512), (64, 32, 1024)):
        x, dpre = pro_gan.lrelu(randn(B, c, h, h)), randn(B, cout, h, h)
        got, again = pk.packed_conv_wgrad(x, dpre), pk.packed_conv_wgrad(x, dpre)
        torch.cuda.synchronize()
        if tuple(got.shape) != (cout, c, 3, 3) or not torch.equal(got, again):
            raise AssertionError(f"packed_conv_wgrad ({c}, {cout}, {h}): wrong shape, or two "
                                 "runs on one input differ in their bits")
        err = scaled_err(f"packed_conv_wgrad ({c}, {cout}, {h})", got,
                         pk.packed_conv_wgrad_plain(x, dpre), WGRAD_REL)

        def library():
            return torch.nn.grad.conv2d_weight(x, (cout, c, 3, 3), dpre, padding=1)

        flops = 2 * 9 * c * cout * B * h * h
        nbytes = 4 * (B * c * h * h + B * cout * h * h + 9 * c * cout)
        largest = got.abs().max().item()
        wgrad_calls.append({
            "call": f"C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h], "max_abs_err": err,
            "max_abs_err_share_of_largest": err / largest,
            "max_abs_err_vs_library": (got - library()).abs().max().item(),
            "largest_entry": largest, "bit_equal_runs": True,
            "ms": cuda_ms(lambda: pk.packed_conv_wgrad(x, dpre)),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_wgrad_plain(x, dpre), iters=3, warmup=1),
            "library_ms": cuda_ms(library),
            "flops": flops, "bytes": nbytes,
            # three TF32 tensor-core products per product; the fp32 CUDA-core
            # bound of the same function beside it
            "op_flops": 3 * flops, "peak_flops": PEAK_TF32_FLOPS,
            "bound_fp32_ms": bound(flops, nbytes)[0],
        })
        print(f"  packed_conv_wgrad ({c}, {cout}, {h}): max |err| vs the twin {err:.3g}, "
              f"{err / largest:.3g} of the largest entry {largest:.4g} (bound {WGRAD_REL:g}); "
              "two runs bit-equal")
        del x, dpre, got, again
    rows = [("packed_conv_wgrad", "packed_conv_wgrad",
             "probgan_tpu/ops/pallas_packed.py:558", wgrad_calls)]

    # -- packed_upconv "lrelu": the pre-norm recompute of the upconv's backward
    up_calls = []
    for label, c, cout, h in (("stage7", 128, 64, 256), ("stage8", 64, 32, 512)):
        x = pro_gan.pixel_norm(randn(B, c, h, h))
        w, b = conv_w(cout, c), 0.1 * randn(cout)
        got = pk.packed_upconv(x, w, b, epilogue="lrelu")
        check_two_runs(f"packed_upconv[lrelu] {label}", got,
                       pk.packed_upconv(x, w, b, epilogue="lrelu"))
        want = pk.packed_upconv_plain(x, w, b, epilogue="lrelu")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        up_calls.append({
            "call": label, "shape_in": [B, c, h, h], "bit_equal_runs": True,
            "max_abs_err": (got - want).abs().max().item(),
            "ms": cuda_ms(lambda: pk.packed_upconv(x, w, b, epilogue="lrelu")),
            "plain_ms": cuda_ms(lambda: pk.packed_upconv_plain(x, w, b, epilogue="lrelu")),
            "library_ms": cuda_ms(lambda: F.leaky_relu(F.conv2d(
                F.interpolate(x, scale_factor=2.0, mode="nearest"), w, b, padding=1), 0.2)),
            "flops": 2 * 4 * c * cout * B * 4 * h * h,
            "bytes": 4 * (B * c * h * h + B * cout * 4 * h * h + 9 * c * cout + cout),
        })
        del x, got, want
    rows.append(("packed_upconv[lrelu]", "packed_upconv",
                 "probgan_tpu/ops/pallas_packed.py:832", up_calls))

    # -- the "none" epilogue (3xTF32) at every (C, Cout, H) the step launches
    # it with: the dgrad convs (flipped, transposed weights, zero bias) and
    # the recompute of convpool_lrelu's pre-activation
    none_calls, pool_calls = [], []
    for c, cout, h in (*NONE_LAUNCHES_PER_STEP, *RECOMPUTE_SHAPES):
        per_step = NONE_LAUNCHES_PER_STEP.get((c, cout, h), 0)
        x, w, b = randn(B, c, h, h), conv_w(cout, c), 0.1 * randn(cout)
        got = pk.packed_conv(x, w, b, epilogue="none")
        again = pk.packed_conv(x, w, b, epilogue="none")
        want = pk.packed_conv_plain(x, w, b, epilogue="none")
        torch.cuda.synchronize()
        label = f"C{c}->Cout{cout}@{h}"
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        err = scaled_err(f"packed_conv[none] {label}", got, want, NONE_REL)
        if not torch.equal(got, again):
            raise AssertionError(f"packed_conv[none] {label}: two runs on one input differ "
                                 "in their bits")
        largest = want.abs().max().item()
        call = {
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": err,
            "max_abs_err_share_of_largest": err / largest, "bit_equal_runs": True,
            "launches_per_step": per_step,
        }
        if (c, cout, h) in RECOMPUTE_SHAPES:
            # convpool_lrelu's forward summed in fp32 on the CUDA cores in
            # packed_conv's "lrelu" order (the same as packed_convpool's): the
            # masks a recompute on "none" would flip against it
            fp32_sign = pk.packed_conv(x, w, b, epilogue="lrelu") >= 0
            call["mask_flips_vs_fp32_kernel"] = int(((got >= 0) != fp32_sign).sum().item())
            call["mask_flips_vs_plain_twin"] = int(((got >= 0) != (want >= 0)).sum().item())
            # what the step runs here instead: the fp32 "lrelu" kernel
            call["lrelu_recompute_ms"] = cuda_ms(lambda: pk.packed_conv(x, w, b, epilogue="lrelu"))
            del fp32_sign
        flops = 2 * 9 * c * cout * B * h * h
        nbytes = 4 * (B * c * h * h + B * cout * h * h + 9 * c * cout + cout)
        call.update({
            "ms": cuda_ms(lambda: pk.packed_conv(x, w, b, epilogue="none")),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b, epilogue="none")),
            "library_ms": cuda_ms(lambda: F.conv2d(x, w, b, padding=1)),
            "flops": flops, "bytes": nbytes,
            # three TF32 tensor-core products per product; the fp32 CUDA-core
            # bound of the same function beside it
            "op_flops": 3 * flops, "peak_flops": PEAK_TF32_FLOPS,
            "bound_fp32_ms": bound(flops, nbytes)[0],
        })
        none_calls.append(call)
        flips = (f"; lrelu mask flips vs the fp32 kernel {call['mask_flips_vs_fp32_kernel']}, "
                 f"vs the plain twin {call['mask_flips_vs_plain_twin']} of {got.numel()}; the "
                 f"step's fp32 \"lrelu\" recompute here {call['lrelu_recompute_ms']:.3f} ms"
                 if "mask_flips_vs_fp32_kernel" in call else "")
        print(f"  packed_conv[none] {label}: max |err| vs the twin {err:.3g}, "
              f"{err / largest:.3g} of the largest entry (bound {NONE_REL:g}); two runs "
              f"bit-equal; faster than F.conv2d: {call['ms'] < call['library_ms']}{flips}")
        del x, got, again, want
    for c, cout, h in ((32, 64, 1024), (64, 128, 512)):
        x, w, b = randn(B, c, h, h), conv_w(cout, c), 0.1 * randn(cout)
        got = pk.packed_convpool(x, w, b, epilogue="none")
        want = pk.packed_convpool_plain(x, w, b, epilogue="none")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        pool_calls.append({
            "call": f"C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h],
            "max_abs_err": (got - want).abs().max().item(),
            "ms": cuda_ms(lambda: pk.packed_convpool(x, w, b, epilogue="none")),
            "plain_ms": cuda_ms(lambda: pk.packed_convpool_plain(x, w, b, epilogue="none")),
            "library_ms": cuda_ms(lambda: F.avg_pool2d(F.conv2d(x, w, b, padding=1), 2)),
            "flops": 2 * 9 * c * cout * B * h * h + 4 * cout * B * h * h,
            "bytes": 4 * (B * c * h * h + B * cout * (h // 2) ** 2 + 9 * c * cout + cout),
        })
        del x, got, want
    rows.append(("packed_conv[none]", "packed_conv", "probgan_tpu/ops/pallas_packed.py:382",
                 none_calls))
    rows.append(("packed_convpool[none]", "packed_convpool",
                 "probgan_tpu/ops/pallas_packed.py:452", pool_calls))

    # -- the four Functions on the card against autograd through the twins
    def vjp(fn, x, w, b, cot):
        x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(x, w, b)
        return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))

    for name, twin, c, cout, h, norm_in in (
            ("conv_lrelu", lambda x, w, b: pk.packed_conv_plain(x, w, b, "lrelu"),
             32, 32, 1024, False),
            ("convpool_lrelu", lambda x, w, b: pk.packed_convpool_plain(x, w, b, "lrelu"),
             64, 128, 512, False),
            ("conv_lrelu_norm", lambda x, w, b: pk.packed_conv_plain(x, w, b, "lrelu_norm"),
             64, 64, 512, True),
            ("upconv_lrelu_norm", lambda x, w, b: pk.packed_upconv_plain(x, w, b),
             64, 32, 512, True)):
        x = randn(B, c, h, h)
        x = pro_gan.pixel_norm(x) if norm_in else pro_gan.lrelu(x)
        w, b = conv_w(cout, c), 0.1 * randn(cout)
        with torch.no_grad():
            cot = torch.randn(twin(x, w, b).shape, device=dev, generator=gen)
        pk.reset_launches()
        got = vjp(lambda *a, fn=getattr(packed_vjp, name): fn(*a, mode="highest"), x, w, b, cot)
        n_launched = dict(pk.launches)
        want = vjp(twin, x, w, b, cot)
        if pk.launches != n_launched or n_launched["packed_conv_wgrad"] != 1:
            raise AssertionError(f"{name}: launches {n_launched}, then {pk.launches} after "
                                 "the twins: expected one wgrad and none from the twins")
        errs = [scaled_err(f"packed_vjp.{name} {part}", g, t,
                           DW_VS_CUDNN_REL if part == "dw" else GRAD_REL)
                for part, g, t in zip(("y", "dx", "dw", "db"), got, want)]
        print(f"  packed_vjp.{name} C{c}->Cout{cout}@{h}: max |diff| y {errs[0]:.3g}  dx "
              f"{errs[1]:.3g}  dw {errs[2]:.3g}  db {errs[3]:.3g} vs autograd through the "
              f"plain twin (within {GRAD_REL:g} of the largest entry, dw {DW_VS_CUDNN_REL:g}); "
              f"launches "
              f"{ {k: v for k, v in n_launched.items() if v} }")
        del x, cot, got, want
    pk.reset_launches()

    # -- a forward-only kernel must not swallow a gradient
    x = randn(1, 32, 16, 32).requires_grad_(True)
    w, b = conv_w(32, 32), torch.zeros(32, device=dev)
    rgb_args = (x, w, b, torch.zeros(3, 32, device=dev), torch.zeros(3, device=dev),
                torch.zeros(1, 3, 8, 16, device=dev), 1.0)
    for fn, args in ((pk.packed_conv, (x, w, b)), (pk.packed_convpool, (x, w, b)),
                     (pk.packed_upconv, (x, w, b)), (pk.packed_conv_rgb, rgb_args)):
        try:
            fn(*args)
        except RuntimeError as e:
            if "packed_vjp" not in str(e):
                raise
        else:
            raise AssertionError(f"{fn.__name__}: launched on a tensor that requires grad")
        with torch.no_grad():
            fn(*args)  # and goes on where no gradient is recorded
    print("  the four forward wrappers raise on a CUDA tensor that requires grad")
    return assemble_conv_rows(rows, B)


def tree_rel_errs(label: str, got, want, tree_leaves, rel: float) -> float:
    """Leaf by leaf, max |got - want| over the leaf's largest |want|; raises
    above ``rel``. Returns the worst share."""
    worst = 0.0
    got, want = tree_leaves(got), tree_leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} leaves vs {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        if not bool(torch.isfinite(g).all()) or err > rel * scale + 1e-30:
            raise AssertionError(f"{label}: leaf {i} {tuple(w.shape)} differs by {err:.3g}, "
                                 f"more than {rel:g} of its largest entry {scale:.3g}")
        if scale > 0:
            worst = max(worst, err / scale)
    return worst


def check_metrics(label: str, got: dict, want: dict, rtol: float, atol: float = 1e-7) -> None:
    for name, w in want.items():
        g, w = float(got[name]), float(w)
        if not math.isfinite(g) or abs(g - w) > rtol * abs(w) + atol:
            raise AssertionError(f"{label}: {name} {g} vs {w}")


def phase_train_path(pk, pro_gan, train_mod, train_state_mod, tree_mod) -> tuple[dict, dict]:
    """Path III: progan_train_step at the default config's full width, and
    kg_train_step at 1,000,000 entities."""
    tree_leaves = tree_mod.tree_leaves
    cfg = pro_gan.ProGANConfig()
    stage, B = TRAIN_STAGE, TRAIN_BATCH
    # the fp32 kernels (phase 14 drives the default grade, "default")
    packed = dict(packed_d=True, packed_g=True, packed_train_mode="highest")
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(77)
    real = torch.tanh(torch.randn((B, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((B, cfg.latent_dim), device="cuda", generator=gen)

    # -- the gradients the step feeds to Adam: kernels vs twins vs unpacked
    pk.reset_launches()
    d_k, g_k, m_k = train_mod.progan_grads(state, real, z, 0.5, cfg, stage, **packed)
    if dict(pk.launches) != STEP_LAUNCHES:
        raise AssertionError(f"progan_grads launched {dict(pk.launches)}, expected "
                             f"{STEP_LAUNCHES}")
    with swap_in_plain_twins(pk, PACKED_KERNELS):
        d_t, g_t, m_t = train_mod.progan_grads(state, real, z, 0.5, cfg, stage, **packed)
    if dict(pk.launches) != STEP_LAUNCHES:
        raise AssertionError("the plain twins launched a kernel")
    d_u, g_u, m_u = train_mod.progan_grads(state, real, z, 0.5, cfg, stage,
                                           packed_train_mode="highest")
    grad_errs = {}
    for other, d_o, g_o, m_o in (("plain twins", d_t, g_t, m_t), ("unpacked path", d_u, g_u, m_u)):
        check_metrics(f"train step vs the {other}", m_k, m_o, STEP_LOSS_RTOL)
        grad_errs[other] = {
            "d": tree_rel_errs(f"D gradients vs the {other}", d_k, d_o, tree_leaves, STEP_GRAD_REL),
            "g": tree_rel_errs(f"G gradients vs the {other}", g_k, g_o, tree_leaves, STEP_GRAD_REL)}
        print(f"  step gradients vs the {other} on the card: worst leaf differs by "
              f"{grad_errs[other]['d']:.3g} (D) and {grad_errs[other]['g']:.3g} (G) of its "
              f"largest entry; losses within rtol {STEP_LOSS_RTOL:g}")
    del d_k, g_k, d_t, g_t, d_u, g_u
    torch.cuda.empty_cache()

    # -- the counted, timed run
    def step(st, alpha, **kw):
        return train_mod.progan_train_step(st, real, z, alpha, cfg, stage, remat=True,
                                           **packed, **kw)

    st = state
    for i in range(TRAIN_WARMUP):
        st, _ = step(st, 0.5)
    torch.cuda.synchronize()
    pk.reset_launches()
    times, losses = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        st, m = step(st, 0.5 if i % 2 == 0 else 1.0)
        losses.append({k: float(v) for k, v in m.items()})  # reads the card: the step is done
        times.append(time.perf_counter() - t0)
        want = {k: v * (i + 1) for k, v in STEP_LAUNCHES.items()}
        if dict(pk.launches) != want:
            raise AssertionError(f"train step {i}: launches {dict(pk.launches)}, expected "
                                 f"{STEP_LAUNCHES} per step")
    counts = {**pk.launches, **pk.epilogue_launches}
    for name, n in STEP_EPILOGUE_LAUNCHES.items():
        if pk.epilogue_launches[name] != n * TRAIN_STEPS:
            raise AssertionError(f"{name}: {pk.epilogue_launches[name]} launches over "
                                 f"{TRAIN_STEPS} steps, expected {n} per step")
    print(f"  launch counts over {TRAIN_STEPS} train steps: {dict(pk.launches)}; by epilogue "
          f"{dict(pk.epilogue_launches)}")
    for m in losses:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"a train step's metrics are not finite: {m}")
    if int(st.d_opt[0].count) != TRAIN_WARMUP + TRAIN_STEPS:
        raise AssertionError("the optimizer's count did not follow the steps")
    if losses[0] == losses[-1]:
        raise AssertionError("the losses did not move over the steps")

    # -- one more step with packed_conv's "none" launches counted by shape
    none_shapes: dict = {}
    launch_conv = pk.packed_conv

    def conv_spy(x, w, b, epilogue="lrelu_norm", **kw):
        if epilogue == "none":
            key = (x.shape[1], w.shape[0], x.shape[2])
            none_shapes[key] = none_shapes.get(key, 0) + 1
        return launch_conv(x, w, b, epilogue, **kw)

    pk.packed_conv = conv_spy
    try:
        _, m = step(st, 1.0)
        float(m["g_loss"])
    finally:
        pk.packed_conv = launch_conv
    if none_shapes != NONE_LAUNCHES_PER_STEP:
        raise AssertionError(f"packed_conv[none] launches by (C, Cout, H) in a step: "
                             f"{none_shapes}, expected {NONE_LAUNCHES_PER_STEP}")
    print(f"  packed_conv[none] launches by (C, Cout, H) in a step: {none_shapes}")

    # -- peak memory with remat on and off (one step each, same state)
    peaks = {}
    for remat in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, m = train_mod.progan_train_step(st, real, z, 1.0, cfg, stage, remat=remat, **packed)
        float(m["d_loss"])
        peaks[remat] = torch.cuda.max_memory_allocated() / 1e9

    # -- device time by part over 2 steps (utils/profile_train.py's parts):
    # packed_conv_wgrad's milliseconds a step
    from probgan_tpu_torch.utils import profile_train

    def profiled_step(stt):
        stt, m = step(stt, 1.0)
        float(m["g_loss"])
        return stt

    st, wall_us, by_name, _ = profile_train.profile_steps(profiled_step, st, 2)
    if not by_name:
        raise AssertionError("torch.profiler recorded no device time in the train step")
    step_parts = {k: v / 2e3 for k, v in profile_train.parts_of(by_name).items()}
    print(f"  profiled (2 steps): wall {wall_us / 2e3:.1f} ms a step, device busy "
          f"{sum(step_parts.values()):.1f} ms, packed_conv_wgrad "
          f"{step_parts.get('packed_conv_wgrad', 0.0):.2f} ms a step (12 launches), "
          f"packed_conv[none] {step_parts.get('packed_conv[none]', 0.0):.2f} ms a step "
          f"(14 launches); by part {step_parts}")

    # -- accumulation (A = 2) and R1
    real2 = torch.stack([real, real.flip(2)])
    z2 = torch.stack([z, z.flip(0)])
    _, m_acc = train_mod.progan_train_step_accum(st, real2, z2, 1.0, cfg, stage, **packed)
    _, m_r1 = step(st, 1.0, r1_gamma=100.0)
    _, m_plain = step(st, 1.0)
    for label, m in (("accumulated step", m_acc), ("step with R1", m_r1)):
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise AssertionError(f"{label}: metrics not finite: {m}")
    if not float(m_r1["d_loss"]) > float(m_plain["d_loss"]):
        raise AssertionError("R1 added nothing to the D loss")
    print(f"  accumulated step (A = 2): d_loss {float(m_acc['d_loss']):.4f}, g_loss "
          f"{float(m_acc['g_loss']):.4f}; step with R1 (gamma 100): d_loss "
          f"{float(m_r1['d_loss']):.4f} against {float(m_plain['d_loss']):.4f} without")

    # -- save -> load -> next step, against the uninterrupted run
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_state.msgpack")
        t0 = time.perf_counter()
        train_state_mod.save_train_state(path, st, {"step": TRAIN_WARMUP + TRAIN_STEPS})
        size_mb = os.path.getsize(path) / 1e6
        template = train_mod.progan_init_state(1, cfg, device="cuda")
        resumed, meta = train_state_mod.load_train_state(path, template)
        file_s = time.perf_counter() - t0
    if meta != {"step": TRAIN_WARMUP + TRAIN_STEPS}:
        raise AssertionError(f"train state meta came back as {meta}")
    if not all(torch.equal(a, b) and a.device == b.device
               for a, b in zip(tree_leaves(resumed), tree_leaves(st))):
        raise AssertionError("the loaded train state is not the saved one bit for bit")
    del template
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        next_a, m_a = step(st, 1.0)
        next_b, m_b = step(resumed, 1.0)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check_metrics("resumed step vs the uninterrupted one", m_b, m_a, 1e-6)
    resume_diff = max((a - b).abs().max().item()
                      for a, b in zip(tree_leaves(next_b), tree_leaves(next_a)))
    if resume_diff > 0.6e-3:
        raise AssertionError(f"the resumed run's next state differs by {resume_diff:.3g}")
    print(f"  train state: {size_mb:.0f} MB written and read back in {file_s:.1f} s; the "
          f"resumed run's next step differs from the uninterrupted one's by {resume_diff:.3g} "
          "at most (0 = bit-equal)")
    del resumed, next_a, next_b, st, state, real2
    torch.cuda.empty_cache()

    per_step_ms = sorted(t * 1e3 for t in times)
    train = {
        "config": "ProGANConfig() 1024², stage 8", "batch": B, "steps": TRAIN_STEPS,
        "steps_per_s": TRAIN_STEPS / sum(times), "p50_ms_per_step": float(np.median(per_step_ms)),
        "step_s": times, "losses": losses, "launches_per_step": STEP_LAUNCHES,
        "peak_device_memory_gb_remat": peaks[True],
        "peak_device_memory_gb_no_remat": peaks[False],
        "grad_share_of_largest_entry": grad_errs, "resume_max_abs_diff": resume_diff,
        "train_state_mb": size_mb,
        "profiled_wall_ms_per_step": wall_us / 2e3,
        "device_ms_per_step_by_part": step_parts,
        "wgrad_ms_per_step": step_parts.get("packed_conv_wgrad", 0.0),
        "none_ms_per_step": step_parts.get("packed_conv[none]", 0.0),
        "none_launches_per_step_by_shape": {f"C{c}->Cout{o}@{h}": n
                                            for (c, o, h), n in none_shapes.items()},
    }
    print(f"  {train['steps_per_s']:.3f} steps/s, p50 {train['p50_ms_per_step']:.1f} ms per "
          f"step (batch {B}, {TRAIN_STEPS} steps, host clock to the metrics on the host); "
          f"peak device memory {peaks[True]:.2f} GB with remat, {peaks[False]:.2f} GB without")

    # -- the KG step at 1,000,000 entities
    t0 = time.perf_counter()
    kg = train_mod.kg_init_state(0, KG_ENTITIES, KG_RELATIONS, KG_DIM, KG_NOISE, KG_HIDDEN,
                                 device="cuda")
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    n = KG_TRAIN_BATCH

    def ids(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape)).cuda()

    triplets = torch.stack([ids(KG_ENTITIES, n), ids(KG_RELATIONS, n), ids(KG_ENTITIES, n)], 1)
    negatives = torch.stack([ids(KG_ENTITIES, n), ids(KG_RELATIONS, n)], 1)
    ce_neg = ids(KG_ENTITIES, KG_CE_NEGATIVES)
    ce_neg[:4] = triplets[:4, 2]  # collisions with a true tail are masked
    noise = torch.Generator(device="cuda").manual_seed(6)
    z0 = torch.randn((n, KG_NOISE), device="cuda", generator=noise)
    torch.cuda.reset_peak_memory_stats()
    _, m_card = train_mod.kg_train_step(kg, triplets, z=z0, negatives=negatives,
                                        ce_negatives=ce_neg)
    cpu = tree_mod.tree_map(lambda t: t.cpu(), kg)
    _, m_cpu = train_mod.kg_train_step(cpu, triplets.cpu(), z=z0.cpu(),
                                       negatives=negatives.cpu(), ce_negatives=ce_neg.cpu())
    check_metrics("kg_train_step vs the same step on the CPU", m_card, m_cpu, STEP_LOSS_RTOL)
    del cpu
    kst = kg
    for _ in range(2):
        kst, _ = train_mod.kg_train_step(kst, triplets, noise, negatives=negatives,
                                         ce_negatives=ce_neg)
    torch.cuda.synchronize()
    kg_times, kg_losses = [], []
    for _ in range(KG_TRAIN_STEPS):
        t0 = time.perf_counter()
        kst, m = train_mod.kg_train_step(kst, triplets, noise, negatives=negatives,
                                         ce_negatives=ce_neg)
        kg_losses.append({k: float(v) for k, v in m.items()})
        kg_times.append(time.perf_counter() - t0)
    kg_peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for m in kg_losses for v in m.values()):
        raise AssertionError(f"kg_train_step: metrics not finite: {kg_losses}")
    # the first step's batch and noise again, after the updates
    _, m_again = train_mod.kg_train_step(kst, triplets, z=z0, negatives=negatives,
                                         ce_negatives=ce_neg)
    if not float(m_again["g_loss"]) < float(m_card["g_loss"]):
        raise AssertionError("kg_train_step: the generator loss did not fall on a repeated batch")
    hits = float(train_mod.kg_eval_hits(kst.g_params, kst.node_emb, kst.rel_emb, triplets[:64],
                                        z0[:64]))
    train["kg"] = {
        "entities": KG_ENTITIES, "relations": KG_RELATIONS, "batch": n,
        "ce_negatives": KG_CE_NEGATIVES, "steps": KG_TRAIN_STEPS,
        "steps_per_s": KG_TRAIN_STEPS / sum(kg_times),
        "p50_ms_per_step": float(np.median(sorted(t * 1e3 for t in kg_times))),
        "step_s": kg_times, "peak_device_memory_gb": kg_peak, "init_s": init_s,
        "first_step": {k: float(v) for k, v in m_card.items()},
        "same_batch_after_updates": {k: float(v) for k, v in m_again.items()},
        "hit10_on_64_training_triplets": hits,
    }
    print(f"  kg_train_step at N = {KG_ENTITIES:,}: metrics agree with the CPU step (rtol "
          f"{STEP_LOSS_RTOL:g}); {train['kg']['steps_per_s']:.2f} steps/s, p50 "
          f"{train['kg']['p50_ms_per_step']:.1f} ms per step (batch {n}, {KG_CE_NEGATIVES} "
          f"sampled negatives), peak device memory {kg_peak:.2f} GB; g_loss "
          f"{float(m_card['g_loss']):.3f} -> {float(m_again['g_loss']):.3f}, Hit@10 on 64 "
          f"training triplets {hits:.2f}")
    return counts, train


@contextlib.contextmanager
def swap_in_plain_twins(module, names):
    """Inside, ``module.<name>`` is its plain twin ``module.<name>_plain``."""
    kernels = {name: getattr(module, name) for name in names}
    try:
        for name in names:
            setattr(module, name, getattr(module, f"{name}_plain"))
        yield
    finally:
        for name, fn in kernels.items():
            setattr(module, name, fn)


def check_logits(label: str, got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    print(f"  {label}: max |logit diff| {err:.3g} (logits {np.abs(want).max():.3g} at most)")
    if (got.shape != want.shape or not np.isfinite(got).all()
            or not np.allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)):
        raise AssertionError(f"{label}: logits differ by {err:.3g}: {got} vs {want}")
    return err


def phase_score_path(pk, image_ops, pro_gan, engine_mod, image_checkpoint_mod, cli_infer,
                     make_image_checkpoint) -> tuple[dict, dict]:
    """Path I: score, latent_walk, the separate denorm and generate_images
    from a checkpoint, at the default 1024² config."""
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    if pro_gan.packed_d_stage_count(cfg, stage, "high") != 2:
        raise AssertionError("the packed discriminator gate does not take stages 8 and 7")
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    z = engine.sample_latents(BATCH_MAIN)
    u8 = engine.generate(z)
    images = u8.astype(np.float32) / 127.5 - 1.0  # [8, 1024, 1024, 3] in [-1, 1]
    engine.score(images)  # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    # -- score: the counted run
    d_per_call = {"packed_conv": 2, "packed_convpool": 2}
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times, logits = [], None
    for i in range(SCORE_CALLS):
        t0 = time.perf_counter()
        logits = engine.score(images)  # returns host numpy: the call has finished
        times.append(time.perf_counter() - t0)
        for name, n in d_per_call.items():
            if pk.launches[name] != n * (i + 1):
                raise AssertionError(f"score call {i}: {name} launched {pk.launches[name]} "
                                     f"times, expected {n} per call")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    faded = engine.score(images, alpha=0.5)
    score_counts = dict(pk.launches)
    if any(score_counts[k] for k in ("packed_upconv", "packed_conv_rgb")):
        raise AssertionError(f"score launched a generator kernel: {score_counts}")
    print(f"  launch counts over {SCORE_CALLS} + 1 score calls: {score_counts}")
    if logits.shape != (BATCH_MAIN,) or logits.dtype != np.float32:
        raise AssertionError(f"score returned {logits.dtype} {logits.shape}")

    # the same engine on the plain twins, and the unpacked path, on the card
    errs = {}
    x_dev = torch.from_numpy(images).cuda()
    for alpha, got in ((1.0, logits), (0.5, faded)):
        with swap_in_plain_twins(pk, list(d_per_call)):
            twins = engine.score(images, alpha=alpha)
        errs[f"twins_a{alpha}"] = check_logits(
            f"score alpha {alpha} vs its plain twins on the card", got, twins)
        with torch.inference_mode():
            ref = pro_gan.discriminator_apply(engine.d_params, x_dev, cfg, stage, alpha,
                                              precision="high", packed=False).cpu().numpy()
        errs[f"unpacked_a{alpha}"] = check_logits(
            f"score alpha {alpha} vs the unpacked path on the card", got, ref)
    if pk.launches != score_counts:
        raise AssertionError("the plain twins launched a kernel")
    if np.allclose(logits, faded, atol=1e-3):
        raise AssertionError("score: alpha 0.5 gave the logits of alpha 1.0")
    del x_dev
    # a batch of 2 against the engine on the CPU (a batch statistic: the same
    # 2 images on both sides)
    cpu_engine = engine_mod.ImageGANEngine(cfg, g_params=engine.g_params,
                                           d_params=engine.d_params, device="cpu")
    errs["cpu"] = check_logits("score of 2 images vs the CPU engine",
                               engine.score(images[:2]), cpu_engine.score(images[:2]))
    del cpu_engine

    # -- latent_walk: 64 frames at 512², 8 chunks of 8
    z0, z1 = z[0], z[1]
    engine.latent_walk(z0, z1, frames=WALK_FRAMES, stage=WALK_STAGE)  # warm-up
    pk.reset_launches()
    t0 = time.perf_counter()
    frames = engine.latent_walk(z0, z1, frames=WALK_FRAMES, stage=WALK_STAGE)
    walk_s = time.perf_counter() - t0
    chunks = -(-WALK_FRAMES // engine_mod.WALK_CHUNK)
    want_counts = {**{k: 0 for k in pk.launches}, "packed_upconv": chunks,
                   "packed_conv_rgb": chunks}
    if pk.launches != want_counts:
        raise AssertionError(f"latent_walk: launches {pk.launches}, expected {want_counts}")
    res = pro_gan.stage_resolution(WALK_STAGE)
    if frames.dtype != np.uint8 or frames.shape != (WALK_FRAMES, res, res, 3):
        raise AssertionError(f"latent_walk returned {frames.dtype} {frames.shape}")
    check_uint8("latent_walk frame 0 vs generate(z0)", frames[:1],
                engine.generate(z0[None], stage=WALK_STAGE))
    check_uint8("latent_walk last frame vs generate(z1)", frames[-1:],
                engine.generate(z1[None], stage=WALK_STAGE))
    print(f"  latent_walk: {WALK_FRAMES} frames at {res}² in {walk_s * 1e3:.1f} ms, "
          f"{WALK_FRAMES / walk_s:.1f} frames/s, launches {dict(pk.launches)}")

    # -- use_pallas: fp32 RGB out of the generator, then the denorm kernel
    fused = engine_mod.ImageGANEngine(cfg, g_params=engine.g_params, d_params=engine.d_params,
                                      device="cuda", use_pallas=True)
    fused.generate(z)  # warm-up of both: the first call after another workload
    engine.generate(z)  # pays cudaMalloc again (the allocator's pool has changed)
    image_ops.reset_launches()
    pk.reset_launches()
    t_default, t_fused = [], []
    for _ in range(3):  # in turns on the same latents
        t0 = time.perf_counter()
        got = fused.generate(z)
        t_fused.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        engine.generate(z)
        t_default.append(time.perf_counter() - t0)
    denorm_counts = dict(image_ops.launches)
    if denorm_counts != {"to_uint8_fused": 3} or pk.launches["packed_conv_rgb"] != 6:
        raise AssertionError(f"use_pallas: launches {denorm_counts}, {pk.launches}: expected "
                             "one to_uint8_fused per use_pallas call and none otherwise")
    _, flip_share, _ = check_uint8("generate(use_pallas=True) vs the default path", got, u8)

    # -- an image checkpoint written by the port, served by the CLI in process
    quiet = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "image_checkpoint.msgpack")
        trees = make_image_checkpoint(cfg, seed=1, ema=True)
        t0 = time.perf_counter()
        image_checkpoint_mod.save_image_checkpoint(path, cfg, **trees)
        print(f"  wrote {os.path.getsize(path) / 1e6:.0f} MB image checkpoint in "
              f"{time.perf_counter() - t0:.1f} s")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "generate_images",
                            "--num_images", str(BATCH_MAIN), "--seed", "3", "--device", "cuda"])
        cli = json_blob(out.getvalue())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "generate_images",
                            "--num_images", "2", "--seed", "3", "--device", "cuda",
                            "--raw_generator", "--stage", "7", "--alpha", "0.5"])
        cli_raw = json_blob(out.getvalue())
    want = {}
    for key, n, kw in (("g_ema", BATCH_MAIN, {}), ("g_params", 2, {"stage": 7, "alpha": 0.5})):
        ref = engine_mod.ImageGANEngine(cfg, g_params=trees[key], d_params=trees["d_params"],
                                        device="cuda", seed=3)
        img = ref.generate(ref.sample_latents(n), **kw)
        want[key] = (list(img.shape), int(img.astype(np.int64).sum()))
        del ref
    for label, res_, (shape, checksum) in (("EMA", cli, want["g_ema"]),
                                           ("raw, stage 7", cli_raw, want["g_params"])):
        if res_["images_shape"] != shape or res_["checksum"] != checksum:
            raise AssertionError(f"CLI generate_images ({label}): {res_['images_shape']} "
                                 f"checksum {res_['checksum']}, engine.generate on the same "
                                 f"weights and seed: {shape} checksum {checksum}")
    if cli["metadata"] != {"num_images": BATCH_MAIN, "stage": stage, "alpha": 1.0,
                           "resolution": cfg.resolution, "seed": 3}:
        raise AssertionError(f"CLI generate_images metadata: {cli['metadata']}")
    print(f"  CLI generate_images from the checkpoint: checksum {cli['checksum']} equals "
          "engine.generate's (EMA weights; raw weights at stage 7, alpha 0.5 too)")

    per_call_ms = sorted(t * 1e3 for t in times)
    path = {
        "batch": BATCH_MAIN, "calls": SCORE_CALLS,
        "scores_per_s": BATCH_MAIN * SCORE_CALLS / sum(times),
        "p50_ms_per_call": float(np.median(per_call_ms)), "call_s": times,
        "peak_device_memory_gb": peak_gb, "max_logit_diff": errs,
        "walk_frames": WALK_FRAMES, "walk_resolution": res, "walk_s": walk_s,
        "walk_frames_per_s": WALK_FRAMES / walk_s,
        "use_pallas_img_per_s": BATCH_MAIN * 3 / sum(t_fused),
        "default_img_per_s_same_loop": BATCH_MAIN * 3 / sum(t_default),
        "use_pallas_differing_bytes": flip_share,
    }
    print(f"  {path['scores_per_s']:.3f} scores/s, p50 {path['p50_ms_per_call']:.3f} ms per call "
          f"(batch {BATCH_MAIN}, {SCORE_CALLS} calls, host clock incl. copy of the images to "
          f"the card), peak device memory {peak_gb:.2f} GB; generate with use_pallas "
          f"{path['use_pallas_img_per_s']:.2f} img/s against {path['default_img_per_s_same_loop']:.2f} "
          "in the same loop")
    counts = {"packed_conv[lrelu]": score_counts["packed_conv"],
              "packed_convpool": score_counts["packed_convpool"], **denorm_counts}
    return counts, path


def check_same_topk(label: str, got_ids, got_vals, want_ids, want_vals) -> int:
    """Two top-k results of the same queries (lists, descending): values
    within RANK_ATOL position by position; where the ids differ, the id must
    be one the other side also returned, or sit within RANK_ATOL of the k-th
    value (two entities that close may swap). Returns the differing
    positions."""
    got_vals, want_vals = np.asarray(got_vals, np.float32), np.asarray(want_vals, np.float32)
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    if got_ids.shape != want_ids.shape or got_vals.shape != want_vals.shape:
        raise AssertionError(f"{label}: shapes differ: {got_ids.shape} vs {want_ids.shape}")
    err = float(np.abs(got_vals - want_vals).max())
    if not np.isfinite(got_vals).all() or err > RANK_ATOL:
        raise AssertionError(f"{label}: scores differ by {err:.3g}")
    swapped = 0
    for q, j in zip(*np.nonzero(got_ids != want_ids)):
        swapped += 1
        for ids, vals, other in ((got_ids, got_vals, want_ids), (want_ids, want_vals, got_ids)):
            if ids[q, j] not in other[q] and vals[q, j] - vals[q, -1] > RANK_ATOL:
                raise AssertionError(f"{label}: query {q} position {j}: id {ids[q, j]} "
                                     "is missing from the other result")
    print(f"  {label}: max |score diff| {err:.3g}, {swapped} of {got_ids.size} "
          "positions hold another id (near-ties)")
    return swapped


def assert_close_tree(label: str, got, want, atol: float) -> None:
    """Equal keys, ints and strings; floats within atol."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            raise AssertionError(f"{label}: keys differ")
        for key in want:
            assert_close_tree(f"{label}[{key!r}]", got[key], want[key], atol)
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(f"{label}[{i}]", g, w, atol)
    elif isinstance(want, float):
        if not (isinstance(got, float) and math.isfinite(got) and abs(got - want) <= atol):
            raise AssertionError(f"{label}: {got} vs {want}")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} vs {want!r}")


def json_blob(text: str) -> dict:
    """The CLI prints banners, then one indented JSON object."""
    return json.loads(text[text.index("{\n"):])


def phase_kg_path(rf, inference_mod, checkpoint_mod, cli_infer,
                  make_kg_checkpoint) -> tuple[dict, dict]:
    rng = np.random.default_rng(1)
    pairs = [(int(h), int(r)) for h, r in zip(rng.integers(0, KG_ENTITIES, KG_BATCH),
                                              rng.integers(0, KG_RELATIONS, KG_BATCH))]
    quiet = io.StringIO()  # the engine's banners
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_checkpoint.pt")
        t0 = time.perf_counter()
        checkpoint_mod.save_checkpoint(path, make_kg_checkpoint(
            KG_ENTITIES, KG_RELATIONS, KG_DIM, KG_NOISE, KG_HIDDEN, seed=0))
        print(f"  wrote {os.path.getsize(path) / 1e6:.0f} MB checkpoint in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            engine = inference_mod.InferenceEngine(path, device="cuda", seed=0)
        load_s = time.perf_counter() - t0
        if engine.num_entities != KG_ENTITIES or engine.entity_norm.device.type != "cuda":
            raise AssertionError("the engine did not load the table onto the card")

        def predict(eng, top_k=KG_TOP_K):
            with contextlib.redirect_stdout(quiet):
                return eng.predict_tails(pairs, top_k=top_k, return_scores=True)

        first = predict(engine)  # warm-up; also noise draw 0, compared below
        torch.cuda.synchronize()

        rf.reset_launches()
        times = []
        for i in range(KG_CALLS):
            t0 = time.perf_counter()
            res = predict(engine)  # returns host lists: the call has finished
            times.append(time.perf_counter() - t0)
            if rf.launches != {"rank_topk": i + 1, "rank_scores": 0, "rank_topk_bf16": 0}:
                raise AssertionError(f"predict_tails call {i}: launches {rf.launches}, "
                                     "expected one rank_topk per call")
            ids, vals = np.asarray(res["predictions"]), np.asarray(res["scores"])
            if ids.shape != (KG_BATCH, KG_TOP_K) or vals.shape != (KG_BATCH, KG_TOP_K):
                raise AssertionError(f"predict_tails returned {ids.shape} / {vals.shape}")
            if ids.min() < 0 or ids.max() >= KG_ENTITIES or not np.isfinite(vals).all():
                raise AssertionError("predict_tails: ids out of range or scores not finite")

        t0 = time.perf_counter()
        res32 = predict(engine, top_k=32)
        top32_s = time.perf_counter() - t0
        if rf.launches != {"rank_topk": KG_CALLS, "rank_scores": 1, "rank_topk_bf16": 0}:
            raise AssertionError(f"top_k 32: launches {rf.launches}, expected one rank_scores")
        vals32 = np.asarray(res32["scores"], np.float32)
        if vals32.shape != (KG_BATCH, 32) or (np.diff(vals32, axis=1) > 0).any():
            raise AssertionError("top_k 32: wrong shape or scores not descending")

        seen_k = []
        launch_topk = rf.topk_candidates

        def spy(pred, table, k, nvalid, normalize):
            seen_k.append(k)
            return launch_topk(pred, table, k, nvalid, normalize)

        rf.topk_candidates = spy
        try:
            with contextlib.redirect_stdout(quiet):
                sim = engine.find_similar_entities([0, 7, 123456], top_k=10)
        finally:
            rf.topk_candidates = launch_topk
        if seen_k != [11] or rf.launches["rank_topk"] != KG_CALLS + 1:
            raise AssertionError(f"find_similar_entities: rank_topk k {seen_k}, "
                                 f"launches {rf.launches}")
        for entry in sim["similar_entities"]:
            if (len(entry["similar_entities"]) != 10
                    or entry["query_entity"] in entry["similar_entities"]):
                raise AssertionError("find_similar_entities: the query was not excluded")
        counts = {name: rf.launches[name] for name in ("rank_topk", "rank_scores")}
        # the fp32 KG path's run ends here
        print(f"  launch counts over {KG_CALLS} predict_tails calls, one with top_k 32 "
              f"and one find_similar_entities: {counts}")

        # the same engine code with each kernel's plain twin in its place, on
        # the card, under the same noise (a fresh engine's draw 0)
        with swap_in_plain_twins(rf, ("rank_topk_fused", "rank_topk_local",
                                      "rank_scores_fused")):
            with contextlib.redirect_stdout(quiet):
                twin_engine = inference_mod.InferenceEngine(path, device="cuda", seed=0)
            twins = predict(twin_engine)
            with contextlib.redirect_stdout(quiet):
                twin_sim = twin_engine.find_similar_entities([0, 7, 123456], top_k=10)
        if {**rf.launches, **counts} != rf.launches:
            raise AssertionError("the plain twins launched a kernel")
        swapped = check_same_topk("predict_tails vs its plain twins on the card",
                                  first["predictions"], first["scores"],
                                  twins["predictions"], twins["scores"])
        for a, b in zip(sim["similar_entities"], twin_sim["similar_entities"]):
            check_same_topk(f"find_similar_entities({a['query_entity']}) vs plain twins",
                            [a["similar_entities"]], [a["similarity_scores"]],
                            [b["similar_entities"]], [b["similarity_scores"]])
        del twin_engine
        torch.cuda.empty_cache()

        # top_k 32 (rank_scores and a stable sort) against top_k 10 (rank_topk)
        # under the same noise: a fresh engine's draw 0, as `first`
        with contextlib.redirect_stdout(quiet):
            engine32 = inference_mod.InferenceEngine(path, device="cuda", seed=0)
        top32 = predict(engine32, top_k=32)
        swapped32 = check_same_topk(
            "predict_tails top_k 32 (rank_scores), first 10, vs top_k 10 (rank_topk)",
            [row[:KG_TOP_K] for row in top32["predictions"]],
            [row[:KG_TOP_K] for row in top32["scores"]], first["predictions"], first["scores"])
        # rank_topk's scores are rank_scores' bit for bit: no near-tie may swap
        if swapped32 or [row[:KG_TOP_K] for row in top32["scores"]] != first["scores"]:
            raise AssertionError("predict_tails: top_k 10 (rank_topk) is not the first 10 of "
                                 "top_k 32 (rank_scores and the stable sort) bit for bit")
        del engine32, top32
        torch.cuda.empty_cache()

        # tasks without a rank kernel, and the rank tasks again, against the
        # engine on the CPU built from the same file
        with contextlib.redirect_stdout(quiet):
            cpu_engine = inference_mod.InferenceEngine(path, device="cpu", seed=0)
            triplets = [(0, 1, 2), (123456, 999, 7), (999_999, 0, 500_000)]
            # each task has its own noise counter: both engines make draw 0
            got_scores = engine.score_triplets(triplets, method="both")
            want_scores = cpu_engine.score_triplets(triplets, method="both")
            got_rel = engine.analyze_relations([0, 123456], [7, 999_999], top_k=5)
            want_rel = cpu_engine.analyze_relations([0, 123456], [7, 999_999], top_k=5)
            cpu_sim = cpu_engine.find_similar_entities([0, 7, 123456], top_k=10)
        assert_close_tree("score_triplets vs the CPU engine", got_scores, want_scores, 1e-5)
        assert_close_tree("analyze_relations vs the CPU engine", got_rel, want_rel, 1e-5)
        if len(got_rel["relation_analysis"]) != 4 or any(
                len(e["top_relations"]) != 5
                or any(not 0 <= r["relation_id"] < KG_RELATIONS for r in e["top_relations"])
                for e in got_rel["relation_analysis"]):
            raise AssertionError("analyze_relations: wrong shape or a padded relation id")
        for a, b in zip(sim["similar_entities"], cpu_sim["similar_entities"]):
            check_same_topk(f"find_similar_entities({a['query_entity']}) vs the CPU engine",
                            [a["similar_entities"]], [a["similarity_scores"]],
                            [b["similar_entities"]], [b["similarity_scores"]])
        print("  score_triplets and analyze_relations agree with the CPU engine "
              "(atol 1e-5, relation ids equal)")
        del cpu_engine

        # path II: the same file served with the bf16 table stream switched on
        os.environ["PROBGAN_BF16_RANK"] = "1"
        try:
            with contextlib.redirect_stdout(quiet):
                bf16_engine = inference_mod.InferenceEngine(path, device="cuda", seed=0)
        finally:
            del os.environ["PROBGAN_BF16_RANK"]
        if engine.entity_norm_bf16 is not None or bf16_engine.entity_norm_bf16 is None:
            raise AssertionError("PROBGAN_BF16_RANK did not switch the bf16 table copy")
        bf16_first = predict(bf16_engine)  # warm-up; noise draw 0, as `first`
        torch.cuda.synchronize()
        rf.reset_launches()
        times_bf16, times_fp32 = [], []
        for i in range(KG_CALLS):  # in turns with the fp32 engine
            t0 = time.perf_counter()
            predict(bf16_engine)
            times_bf16.append(time.perf_counter() - t0)
            if rf.launches != {"rank_topk": i, "rank_scores": 0, "rank_topk_bf16": i + 1}:
                raise AssertionError(f"bf16 predict_tails call {i}: launches {rf.launches}, "
                                     "expected one rank_topk_bf16 and no rank_topk")
            t0 = time.perf_counter()
            predict(engine)
            times_fp32.append(time.perf_counter() - t0)
        rf.reset_launches()  # the counted run of path II: the bf16 engine alone
        predict(bf16_engine)
        with contextlib.redirect_stdout(quiet):
            bf16_sim = bf16_engine.find_similar_entities([0, 7, 123456], top_k=10)
        if rf.launches != {"rank_topk": 0, "rank_scores": 0, "rank_topk_bf16": 2}:
            raise AssertionError(f"bf16 engine: launches {rf.launches}, expected one "
                                 "rank_topk_bf16 per call and no rank_topk")
        counts["rank_topk_bf16"] = rf.launches["rank_topk_bf16"]
        bf16_swapped = check_same_topk("bf16 predict_tails vs the fp32 engine",
                                       bf16_first["predictions"], bf16_first["scores"],
                                       first["predictions"], first["scores"])
        for a, b in zip(bf16_sim["similar_entities"], sim["similar_entities"]):
            check_same_topk(f"bf16 find_similar_entities({a['query_entity']}) vs fp32",
                            [a["similar_entities"]], [a["similarity_scores"]],
                            [b["similar_entities"]], [b["similarity_scores"]])
        del bf16_engine, engine
        torch.cuda.empty_cache()

        # the CLI in process, and the REPL fed from stdin
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "predict_tails",
                            "--input_pairs", "[[0,1],[2,3]]", "--top_k", "5",
                            "--device", "cuda"])
        cli_pred = json_blob(out.getvalue())
        if (np.asarray(cli_pred["predictions"]).shape != (2, 5)
                or cli_pred["metadata"]["num_queries"] != 2):
            raise AssertionError(f"CLI predict_tails printed {cli_pred}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "model_info",
                            "--device", "cuda"])
        info = json_blob(out.getvalue())
        if info["device"] != "cuda:0" or info["model_architecture"] != {
                "embedding_dim": KG_DIM, "noise_dim": KG_NOISE, "hidden_dim": KG_HIDDEN,
                "num_entities": KG_ENTITIES, "num_relations": KG_RELATIONS}:
            raise AssertionError(f"CLI model_info printed {info}")
        out, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO("predict 0 1 3\ninfo\nquit\n")
        try:
            with contextlib.redirect_stdout(out):
                cli_infer.main(["--checkpoint_path", path, "--task", "interactive",
                                "--device", "cuda"])
        finally:
            sys.stdin = stdin
        repl_out = out.getvalue()
        for needle in ("Top 3 predictions for (0, 1):", "   3. Entity ", "Model Information:",
                       "Entities: 1,000,000", "Device: cuda:0", "done!"):
            if needle not in repl_out:
                raise AssertionError(f"REPL output lacks {needle!r}:\n{repl_out[-2000:]}")
        print("  CLI predict_tails and model_info (device cuda:0) and the piped REPL ran")

    per_call_ms = sorted(t * 1e3 for t in times)
    kg = {
        "entities": KG_ENTITIES, "relations": KG_RELATIONS, "embed_dim": KG_DIM,
        "batch": KG_BATCH, "top_k": KG_TOP_K, "calls": KG_CALLS,
        "queries_per_s": KG_BATCH * KG_CALLS / sum(times),
        "p50_ms_per_call": float(np.median(per_call_ms)), "call_s": times,
        "top_k_32_call_ms": top32_s * 1e3, "engine_load_s": load_s,
        "top_k_32_positions_with_another_id_vs_top_k_10": swapped32,
        "positions_with_another_id_vs_plain_twins": swapped,
        "bf16_queries_per_s": KG_BATCH * KG_CALLS / sum(times_bf16),
        "bf16_p50_ms_per_call": float(np.median(sorted(t * 1e3 for t in times_bf16))),
        "fp32_queries_per_s_same_loop": KG_BATCH * KG_CALLS / sum(times_fp32),
        "fp32_p50_ms_per_call_same_loop": float(np.median(sorted(t * 1e3 for t in times_fp32))),
        "bf16_positions_with_another_id_vs_fp32": bf16_swapped,
    }
    print(f"  {kg['queries_per_s']:.1f} queries/s, p50 {kg['p50_ms_per_call']:.3f} ms per "
          f"call (predict_tails, {KG_BATCH} pairs, top_k {KG_TOP_K}, {KG_CALLS} calls, host "
          f"clock incl. copy to host); top_k 32: {kg['top_k_32_call_ms']:.1f} ms per call")
    print(f"  with PROBGAN_BF16_RANK=1: {kg['bf16_queries_per_s']:.1f} queries/s, p50 "
          f"{kg['bf16_p50_ms_per_call']:.3f} ms per call, against "
          f"{kg['fp32_queries_per_s_same_loop']:.1f} queries/s, p50 "
          f"{kg['fp32_p50_ms_per_call_same_loop']:.3f} ms for the fp32 engine in the same loop")
    return counts, kg


def phase_fused_kernels(pk, pro_gan) -> list[dict]:
    """The stage-fused kernels at the 1024² generator's shapes (batch 2)
    against their plain twins and, bit for bit, against the two-kernel pair
    they replace on the card."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dev = "cuda"
    B = BATCH_KERNELS

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        return torch.randn((cout, cin, k, k), device=dev, generator=gen) * (
            gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t))

    def stage_library(x, w1, b1, w2, b2):  # cuDNN on the upsampled input
        up = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return lrelu_norm(F.conv2d(lrelu_norm(F.conv2d(up, w1, b1, padding=1)), w2, b2,
                                   padding=1))

    def differing(a, b) -> int:
        return int((a != b).sum().item())

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiling = {}  # conv1 pixels a conv2 output, from the tiling (not measured)

    rows = []
    # -- packed_upconv_conv: stage 7 (128 -> 64 -> 64, 256² -> 512²), timed;
    # and, checked but not timed (no path launches it), at batch 3 on
    # 200 x 256: 3 x 50 x 16 = 2,400 tiles, ranges of 18 or 19 over 132
    # blocks, runs that end mid-strip
    calls, b10_untimed = [], []
    for label, bsz, c, cout, h, wd in (("stage7", B, 128, 64, 256, 256),
                                       ("stage7_b3_200x256", 3, 128, 64, 200, 256)):
        x, w1, b1 = feats(bsz, c, h, wd), conv_w(cout, c), bias(cout)
        w2, b2 = conv_w(cout, cout), bias(cout)
        args = (x, w1, b1, w2, b2)
        got = pk.packed_upconv_conv(*args)
        want = pk.packed_upconv_conv_plain(*args)
        pair = pk.packed_conv(pk.packed_upconv(x, w1, b1), w2, b2)
        err = (got - want).abs().max().item()
        n_diff = differing(got, pair)
        print(f"  packed_upconv_conv[{label}]: max |err| vs twin {err:.3g}, values differing "
              f"from the pair {n_diff}")
        if err > FUSED_ATOL or n_diff:
            raise AssertionError(f"packed_upconv_conv[{label}]: off its twin or not bit-equal "
                                 "to the pair")
        del got, want, pair
        tiling[f"packed_upconv_conv[{label}]"] = pk.fused_conv1_per_output(bsz, cout, h, wd, sms)
        check = {"call": label, "shape_in": [bsz, c, h, wd], "max_abs_err": err,
                 "differing_vs_pair": n_diff}
        if label != "stage7":
            b10_untimed.append(check)
            del args, x
            continue
        pixels = bsz * 4 * h * wd
        calls.append({
            **check,
            "ms": cuda_ms(lambda args=args: pk.packed_upconv_conv(*args)),
            "plain_ms": cuda_ms(lambda args=args: pk.packed_upconv_conv_plain(*args)),
            "library_ms": cuda_ms(lambda args=args: stage_library(*args)),
            "pair_ms": cuda_ms(lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: pk.packed_conv(
                pk.packed_upconv(x, w1, b1), w2, b2)),
            # conv1 at 4 pre-summed taps per output, conv2 at 9
            "flops": 2 * 4 * c * cout * pixels + 2 * 9 * cout * cout * pixels,
            "bytes": 4 * (bsz * c * h * wd + cout * pixels + 9 * c * cout + 9 * cout * cout
                          + 2 * cout),
        })
        del args, x
    rows.append(("packed_upconv_conv", "packed_upconv_conv",
                 "probgan_tpu/ops/pallas_packed.py:973", calls))

    # -- packed_upconv_conv_rgb: stage 8 (64 -> 32 -> 32, 512² -> 1024²), uint8
    # and fp32 out, stage 7 (128 -> 64 -> 64) when it is the last stage, and
    # stage 8 uint8 at generate's batch 8
    calls = []
    for label, bsz, c, cout, h, alpha, u8 in (("stage8", B, 64, 32, 512, 1.0, True),
                                              ("stage8_fp32", B, 64, 32, 512, 0.3, False),
                                              ("stage7", B, 128, 64, 256, 0.5, True),
                                              ("stage8_b8", 8, 64, 32, 512, 1.0, True)):
        x, w1, b1, w2, b2 = (feats(bsz, c, h, h), conv_w(cout, c), bias(cout),
                             conv_w(cout, cout), bias(cout))
        rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
        prev_w, prev_b = conv_w(3, c, 1, 1.0).reshape(3, c), bias(3)
        args = (x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha)

        def fused(args=args, u8=u8):
            return pk.packed_upconv_conv_rgb(*args, emit_uint8=u8)

        def two_kernels(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b,
                        prev_w=prev_w, prev_b=prev_b, alpha=alpha, u8=u8):
            f, rp = pk.packed_upconv(x, w1, b1, rgb_w=prev_w, rgb_b=prev_b)
            return pk.packed_conv_rgb(f, w2, b2, rgb_w, rgb_b, rp, alpha, emit_uint8=u8)

        def library(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b,
                    prev_w=prev_w, prev_b=prev_b, alpha=alpha, u8=u8):
            rgb = F.conv2d(stage_library(x, w1, b1, w2, b2), rgb_w[:, :, None, None], rgb_b)
            prev = F.interpolate(F.conv2d(x, prev_w[:, :, None, None], prev_b),
                                 scale_factor=2.0, mode="nearest")
            out = (prev + alpha * (rgb - prev)).permute(0, 2, 3, 1)
            return pro_gan.to_uint8(out) if u8 else out.contiguous()

        got, want, pair = fused(), pk.packed_upconv_conv_rgb_plain(*args, emit_uint8=u8), two_kernels()
        n_diff = differing(got, pair)
        if u8:
            if got.dtype != torch.uint8 or tuple(got.shape) != (bsz, 2 * h, 2 * h, 3):
                raise AssertionError(f"packed_upconv_conv_rgb returned {got.dtype} {tuple(got.shape)}")
            err, _, _ = check_uint8(f"packed_upconv_conv_rgb[{label}] uint8 vs twin",
                                    got.cpu().numpy(), want.cpu().numpy())
            err = float(err)
        else:
            err = (got - want).abs().max().item()
            if err > FUSED_ATOL:
                raise AssertionError(f"packed_upconv_conv_rgb[{label}]: {err:.3g} off its twin")
        print(f"  packed_upconv_conv_rgb[{label}]: max |err| vs twin {err:.3g}, values "
              f"differing from the pair {n_diff}")
        if n_diff:
            raise AssertionError(f"packed_upconv_conv_rgb[{label}]: not bit-equal to the pair")
        del got, want, pair
        tiling[f"packed_upconv_conv_rgb[{label}]"] = pk.fused_conv1_per_output(
            bsz, cout, h, h, sms)
        out_bytes = bsz * 4 * h * h * 3 * (1 if u8 else 4)
        calls.append({
            "call": label, "shape_in": [bsz, c, h, h], "emit_uint8": u8, "alpha": alpha,
            "max_abs_err": err, "differing_vs_pair": n_diff,
            "ms": cuda_ms(fused), "plain_ms": cuda_ms(
                lambda args=args, u8=u8: pk.packed_upconv_conv_rgb_plain(*args, emit_uint8=u8)),
            "library_ms": cuda_ms(library), "pair_ms": cuda_ms(two_kernels),
            # conv1, conv2, toRGB of conv2's output, toRGB of the input
            "flops": (2 * 4 * c * cout * bsz * (2 * h) ** 2
                      + 2 * 9 * cout * cout * bsz * (2 * h) ** 2
                      + 2 * cout * 3 * bsz * (2 * h) ** 2 + 2 * c * 3 * bsz * h * h),
            "bytes": 4 * (bsz * c * h * h + 9 * c * cout + 9 * cout * cout + 2 * cout
                          + 3 * cout + 3 * c + 6) + out_bytes,
        })
        del args, x, fused, two_kernels, library
    rows.append(("packed_upconv_conv_rgb", "packed_upconv_conv_rgb",
                 "probgan_tpu/ops/pallas_packed.py:1058", calls))
    entries = assemble_conv_rows(rows, B)
    # a check of the bits, kept apart from the timed calls the totals sum
    entries[0]["untimed_checks"] = b10_untimed
    for e in entries:
        for k in e["calls"]:
            print(f"  {e['name']}[{k['call']}]: {k['ms']:.3f} ms against the pair's "
                  f"{k['pair_ms']:.3f} ms ({k['ms'] / k['pair_ms']:.2f}x), "
                  f"{k['roofline_share']:.0%} of the bound")
    print("  conv1 pixels a conv2 output, from the tiling (ops/packed.py "
          "fused_conv1_per_output; not measured here): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tiling.items()))
    return entries


def run_until_mid_stage_save(argv: list[str]) -> float:
    """Runs ``python -m probgan_tpu_torch.cli.train argv`` (with --verbose) in a
    child process and kills it as soon as it reports its first mid-stage save:
    a run that crashed after that epoch. Returns the child's seconds."""
    proc = subprocess.Popen([sys.executable, "-u", "-m", "probgan_tpu_torch.cli.train", *argv],
                            cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    watchdog = threading.Timer(CHILD_TIMEOUT_S, proc.kill)
    watchdog.start()
    t0, lines, saved = time.perf_counter(), [], False
    try:
        for line in proc.stdout:
            lines.append(line)
            if "mid-stage train state saved" in line:
                saved = True
                break
    finally:
        proc.kill()
        proc.wait()
        proc.stdout.close()
        watchdog.cancel()
    if not saved:
        raise AssertionError("the child trainer made no mid-stage save:\n" + "".join(lines[-40:]))
    return time.perf_counter() - t0


@contextlib.contextmanager
def env(**values):
    """Inside, the environment variables ``values`` are set (None: unset)."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def checksum_of_generate_images(cli_infer, path: str, n: int, *extra) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_infer.main(["--checkpoint_path", path, "--task", "generate_images",
                        "--num_images", str(n), "--seed", "3", "--device", "cuda", *extra])
    return json_blob(out.getvalue())


def phase_fused_path(pk, rf, pro_gan, engine_mod, cli_infer, cli_train,
                     inference_mod) -> tuple[dict, dict]:
    """Path IV, under PROBGAN_STAGE_FUSED=1: serving at 1024², the image
    trainer CLI at 1024² and the KG trainer CLI at N = 1,000,000."""
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    latents = [engine.sample_latents(BATCH_MAIN) for _ in range(MAIN_BATCHES)]
    path = {}

    # -- generate: one B10 and one B11 a call, none of B1-B3
    with env(PROBGAN_STAGE_FUSED="1"):
        engine.generate(latents[0])  # warm-up
        torch.cuda.synchronize()
        pk.reset_launches()
        times = []
        for z in latents:
            t0 = time.perf_counter()
            img = engine.generate(z)
            times.append(time.perf_counter() - t0)
        counts = dict(pk.launches)
    want = {"packed_upconv_conv": MAIN_BATCHES, "packed_upconv_conv_rgb": MAIN_BATCHES,
            "packed_upconv": 0, "packed_conv": 0, "packed_conv_rgb": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"generate under PROBGAN_STAGE_FUSED=1 launched {counts}, "
                             f"expected {want}")
    z = latents[-1]
    with env(PROBGAN_STAGE_FUSED="0"):
        unfused = engine.generate(z)
    if not np.array_equal(img, unfused):
        raise AssertionError("generate: the stage-fused images are not the two-kernel ones")
    cpu_params = engine_mod.to_device(engine.g_params, torch.device("cpu"))
    with torch.inference_mode():
        cpu_img = pro_gan.generator_apply(cpu_params, z[:1].cpu(), cfg, stage, 1.0,
                                          precision="high", packed=True).numpy()
    _, _, psnr_cpu = uint8_agreement(img[:1], cpu_img)
    if psnr_cpu < PSNR_FLOOR_DB:
        raise AssertionError(f"fused generate vs the CPU: PSNR {psnr_cpu:.2f} dB")
    del cpu_params
    per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
    path.update({
        "batch": BATCH_MAIN, "calls": MAIN_BATCHES,
        "img_per_s": BATCH_MAIN * MAIN_BATCHES / sum(times),
        "p50_ms_per_img": float(np.median(per_img_ms)), "batch_s": times,
        "bit_equal_to_two_kernel_engine": True, "psnr_vs_cpu_db": finite_or_none(psnr_cpu),
    })
    print(f"  generate: {path['img_per_s']:.3f} img/s, p50 {path['p50_ms_per_img']:.3f} ms/img "
          f"(batch {BATCH_MAIN}, {MAIN_BATCHES} calls), launches {counts}; images bit-equal to "
          f"the two-kernel engine's, PSNR {psnr_cpu:.2f} dB vs the CPU")

    # -- latent_walk at stage 7: B11 alone (s0 == stage), one a chunk
    z0, z1 = z[0], z[1]
    with env(PROBGAN_STAGE_FUSED="1"):
        engine.latent_walk(z0, z1, frames=WALK_FRAMES, stage=WALK_STAGE)  # warm-up
        pk.reset_launches()
        t0 = time.perf_counter()
        frames = engine.latent_walk(z0, z1, frames=WALK_FRAMES, stage=WALK_STAGE)
        walk_s = time.perf_counter() - t0
        walk_counts = dict(pk.launches)
    chunks = -(-WALK_FRAMES // engine_mod.WALK_CHUNK)
    if walk_counts["packed_upconv_conv_rgb"] != chunks or any(
            walk_counts[k] for k in ("packed_upconv_conv", *UNFUSED_KERNELS)):
        raise AssertionError(f"latent_walk under PROBGAN_STAGE_FUSED=1: launches {walk_counts}")
    with env(PROBGAN_STAGE_FUSED="0"):
        if not np.array_equal(frames, engine.latent_walk(z0, z1, frames=WALK_FRAMES,
                                                          stage=WALK_STAGE)):
            raise AssertionError("latent_walk: the stage-fused frames are not the two-kernel ones")
    path.update({"walk_frames": WALK_FRAMES, "walk_s": walk_s,
                 "walk_frames_per_s": WALK_FRAMES / walk_s})
    print(f"  latent_walk: {WALK_FRAMES} frames at stage {WALK_STAGE} in {walk_s * 1e3:.1f} ms "
          f"({WALK_FRAMES / walk_s:.1f} frames/s), {chunks} packed_upconv_conv_rgb launches, "
          "frames bit-equal to the two-kernel run")

    # -- PROBGAN_PACKED=0: no late-stage kernel at all
    with env(PROBGAN_STAGE_FUSED="1", PROBGAN_PACKED="0"):
        off = engine_mod.ImageGANEngine(cfg, g_params=engine.g_params, d_params=engine.d_params,
                                        device="cuda")
        pk.reset_launches()
        off_img = off.generate(z[:2])
        if any(pk.launches.values()):
            raise AssertionError(f"PROBGAN_PACKED=0 launched {dict(pk.launches)}")
    check_uint8("PROBGAN_PACKED=0 vs the fused engine", off_img, img[:2])
    print("  PROBGAN_PACKED=0: no late-stage kernel launched")
    del engine, off, img, unfused, frames
    torch.cuda.empty_cache()

    # -- the image trainer CLI at 1024²: stages 0-7 at --resolution 512 in
    # process; --resume --grow to 1024² in a child process, killed as soon as
    # it has saved mid-stage (a crash after stage 8's first epoch); --resume
    # from that file in process to the end of the schedule
    common = ["--synthetic", str(TRAINER_IMAGES), "--batch_size", str(TRAINER_BATCH),
              "--epochs_per_stage", str(TRAINER_EPOCHS), "--device", "cuda"]
    trainer = {}
    with tempfile.TemporaryDirectory() as tmp, env(PROBGAN_STAGE_FUSED="1"):
        out_dir = os.path.join(tmp, "run")
        legs = {}

        def in_process(leg, args, expect):
            pk.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_train.main(["--model", "image", *common, *args, "--output_dir", out_dir])
            if rc != 0 or expect not in out.getvalue():
                raise AssertionError(f"image trainer ({leg}) exited {rc}, lacks {expect!r}:\n"
                                     f"{out.getvalue()}")
            legs[leg] = {"s": time.perf_counter() - t0, "launches": dict(pk.launches)}

        in_process("stages 0-7", ["--resolution", "512", "--checkpoint_minutes", "0"],
                   f"Stage {stage - 1} (512²)")
        torch.cuda.empty_cache()  # room for the child on the card
        child_s = run_until_mid_stage_save(
            ["--model", "image", *common, "--resolution", "1024", "--resume", "--grow",
             "--checkpoint_minutes", "1e-9", "--verbose", "--output_dir", out_dir])
        in_process("stage 8", ["--resolution", "1024", "--resume"],
                   f"Resumed mid-stage {stage} (next: epoch 2/{TRAINER_EPOCHS})")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        # the checkpoint serves generate_images, fused and not, to equal images
        ckpt = os.path.join(out_dir, "image_checkpoint.msgpack")
        served = checksum_of_generate_images(cli_infer, ckpt, 2)
        with env(PROBGAN_STAGE_FUSED="0"):
            served_unfused = checksum_of_generate_images(cli_infer, ckpt, 2)
        if (served["images_shape"] != [2, cfg.resolution, cfg.resolution, 3]
                or served["checksum"] != served_unfused["checksum"]):
            raise AssertionError(f"generate_images from the trained checkpoint: {served} vs "
                                 f"{served_unfused} unfused")
    early, late = legs["stages 0-7"]["launches"], legs["stage 8"]["launches"]
    if (early["packed_upconv_conv_rgb"] < 1 or early["packed_upconv_conv"] != 0
            or late["packed_upconv_conv"] < 1 or late["packed_upconv_conv_rgb"] < 1
            or any(early[k] or late[k] for k in UNFUSED_KERNELS)):
        raise AssertionError(f"the trainer's fake renders launched {early} (stages 0-7) and "
                             f"{late} (stage 8)")
    if ([(m["stage"], m["epoch"]) for m in metrics]
            != [(s, e) for s in range(stage + 1) for e in range(1, TRAINER_EPOCHS + 1)]):
        raise AssertionError(f"the image trainer's metrics.jsonl: {metrics}")
    if any(not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"])) for m in metrics):
        raise AssertionError(f"the image trainer's losses are not finite: {metrics}")
    stage_s = {}
    for m in metrics:
        stage_s[m["stage"]] = stage_s.get(m["stage"], 0.0) + m["seconds"]
    steps_per_epoch = TRAINER_IMAGES // TRAINER_BATCH
    last_epoch_s = metrics[-1]["seconds"]  # stage 8's second epoch, in process
    trainer.update({
        "images": TRAINER_IMAGES, "batch": TRAINER_BATCH, "epochs_per_stage": TRAINER_EPOCHS,
        "seconds_per_stage": stage_s, "leg_s": {k: v["s"] for k, v in legs.items()},
        "child_s_to_mid_stage_save": child_s,
        "launches": {k: v["launches"] for k, v in legs.items()},
        "stage8_second_epoch_s": last_epoch_s,
        "stage8_steps_per_s": steps_per_epoch / last_epoch_s,
        "generate_images_checksum": served["checksum"],
    })
    print(f"  image trainer CLI at 1024² (stages 0-7, then --resume --grow in a child killed "
          f"after its mid-stage save, then --resume): seconds per stage "
          f"{', '.join(f'{k}: {v:.4f}' for k, v in stage_s.items())} (metrics.jsonl; stage "
          f"8's first epoch in the child, with --verbose); stage 8 "
          f"{trainer['stage8_steps_per_s']:.3f} steps/s over its second epoch; fake renders "
          f"launched B10 {late['packed_upconv_conv']} and B11 "
          f"{early['packed_upconv_conv_rgb'] + late['packed_upconv_conv_rgb']} times in process; "
          "the mid-stage file resumed and finished; its checkpoint serves generate_images, "
          "fused and not, to one checksum")
    path["image_trainer"] = trainer

    # -- the KG trainer CLI at N = 1,000,000 entities, two epochs; steps/s from
    # its own per-epoch seconds (metrics.jsonl: steps, host sampling and the
    # eval; the files are written after the line)
    rng = np.random.default_rng(11)
    trip = np.stack([rng.integers(0, KG_ENTITIES, KG_CLI_TRIPLETS),
                     rng.integers(0, KG_RELATIONS, KG_CLI_TRIPLETS),
                     rng.integers(0, KG_ENTITIES, KG_CLI_TRIPLETS)], axis=1)
    trip[0] = (KG_ENTITIES - 1, KG_RELATIONS - 1, 0)  # pins N and the relation count
    n_train = KG_CLI_TRIPLETS - KG_CLI_TRIPLETS // 20  # 5% held out
    kg_steps = n_train // KG_TRAIN_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        data, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        os.makedirs(data)
        np.savetxt(os.path.join(data, "train.txt"), trip, fmt="%d", delimiter="\t")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_train.main(["--data_root", data, "--epochs", str(KG_CLI_EPOCHS),
                                 "--batch_size", str(KG_TRAIN_BATCH), "--device", "cuda",
                                 "--output_dir", out_dir])
        run_s = time.perf_counter() - t0
        text = out.getvalue()
        if (rc != 0 or f"Entities: {KG_ENTITIES:,}" not in text or "Sampled-softmax" not in text
                or f"Train triplets: {n_train:,}" not in text):
            raise AssertionError(f"KG trainer CLI:\n{text}")
        for name in ("best_checkpoint.pt", "train_state.msgpack", "metrics.jsonl"):
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"KG trainer CLI wrote no {name}")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            kg_metrics = [json.loads(line) for line in f]
        if [m["epoch"] for m in kg_metrics] != list(range(1, KG_CLI_EPOCHS + 1)) or not all(
                math.isfinite(m[k]) for m in kg_metrics for k in ("d_loss", "g_loss")):
            raise AssertionError(f"KG trainer CLI metrics.jsonl: {kg_metrics}")
        rf.reset_launches()
        kg_engine = inference_mod.InferenceEngine(os.path.join(out_dir, "best_checkpoint.pt"),
                                                  device="cuda")
        res = kg_engine.predict_tails([(0, 1), (5, 7)], top_k=KG_TOP_K)
        if (kg_engine.num_entities != KG_ENTITIES or rf.launches["rank_topk"] != 1
                or [len(p) for p in res["predictions"]] != [KG_TOP_K, KG_TOP_K]):
            raise AssertionError(f"the KG checkpoint served {res} with launches {rf.launches}")
        del kg_engine
    epoch_s = [m["seconds"] for m in kg_metrics]
    path["kg_trainer"] = {
        "entities": KG_ENTITIES, "relations": KG_RELATIONS, "triplets": KG_CLI_TRIPLETS,
        "batch": KG_TRAIN_BATCH, "steps_per_epoch": kg_steps, "epoch_s": epoch_s,
        "steps_per_s_last_epoch_with_eval": kg_steps / epoch_s[-1], "run_s": run_s,
    }
    print(f"  KG trainer CLI at N = {KG_ENTITIES:,}: {kg_steps} steps an epoch, epochs of "
          f"{', '.join(f'{s:.4f}' for s in epoch_s)} s with their eval (metrics.jsonl): "
          f"{kg_steps / epoch_s[-1]:.2f} steps/s in the last; {run_s:.1f} s in all with the "
          "files; best_checkpoint.pt serves predict_tails on the card")
    fused_counts = {k: counts[k] for k in FUSED_KERNELS}
    return fused_counts, path


# Phase 12: the grades. Kernel mode "default" (one bf16 pass) of B1, B2
# "lrelu_norm" and B3 against their bf16 twins; a twin rounds the same operands
# and sums in fp32 in another order, so fp32 outputs agree to GRADE_REL of the
# largest entry. B3's toRGB also rounds the PixelNorm'd features, which kernel
# and twin compute in another order: a feature that lies on a bf16 rounding
# boundary rounds the other way in one of them, and its pixel's RGB moves by
# one bf16 step of the feature times |rgb_w|. So B3's fp32 RGB is held to
# GRADE_REL on all but GRADE_FLIP_SHARE of its values and to GRADE_FLIP_REL
# of the largest entry on those.
GRADE_REL, GRADE_FLIP_SHARE, GRADE_FLIP_REL = 1e-5, 1e-2, 2e-2
GRADE_CALLS = 3  # timed generate calls a grade
BF16_KERNELS = {"packed_upconv": "packed_upconv_bf16", "packed_conv": "packed_conv_bf16",
                "packed_conv_rgb": "packed_conv_rgb_bf16"}


def check_rel(label: str, got: torch.Tensor, want: torch.Tensor, flips: bool = False,
              rel: float = GRADE_REL, flip_share: float = GRADE_FLIP_SHARE,
              flip_rel: float = GRADE_FLIP_REL) -> float:
    """Max |got - want| over the largest |want|, at most ``rel``; with
    ``flips``, a share of ``flip_share`` of the values may reach
    ``flip_rel``."""
    scale = want.abs().max().item()
    d = (got - want).abs() / scale
    err = d.max().item()
    beyond = (d > rel).float().mean().item()
    if (err > rel and not flips) or beyond > flip_share or err > flip_rel:
        raise AssertionError(f"{label}: {err:.3g} of the largest entry off its twin, "
                             f"{beyond:.4%} of values beyond {rel}")
    return err


def check_pixelnorm(label: str, got: torch.Tensor, want: torch.Tensor, pre: torch.Tensor,
                    rel: float, spread: float = 1.0, flips: bool = False,
                    nhwc: bool = False) -> float:
    """A PixelNorm output against its twin, pixel by pixel. PixelNorm divides
    each pixel's pre-norm sums ``pre`` ([B, C, H, W], the twin's LeakyReLU
    output) by their RMS r; the kernel's sums differ from the twin's by
    their order, and at few channels r can be small (2 channels both near 0),
    so that difference grows by 1/r. Each value is held to ``rel`` x (the
    largest |want| + the largest |pre| x ``spread`` / r at its pixel):
    ``spread`` 1 for the features, for B3's RGB (``nhwc``) the largest sum
    of |rgb_w| over the channels. With ``flips`` GRADE_FLIP_SHARE of the values
    may reach GRADE_FLIP_REL of the largest |want| (B3 at "default", as
    check_rel). Returns the largest |got - want|."""
    r = torch.sqrt(pre.square().mean(dim=1, keepdim=True) + 1e-8)
    if nhwc:
        r = r.permute(0, 2, 3, 1)
    scale = want.abs().max().item()
    limit = rel * (scale + pre.abs().max().item() * spread / r)
    d = (got - want).abs()
    beyond = (d > limit).float().mean().item()
    worst = (d / limit).max().item()
    print(f"  {label}: {d.max().item() / scale:.3g} of the largest entry, {worst:.3g} of the "
          f"pixel's bound at most, {beyond:.4%} of values past it")
    if (beyond > 0 and not flips) or beyond > GRADE_FLIP_SHARE or d.max() > GRADE_FLIP_REL * scale:
        raise AssertionError(f"{label}: {beyond:.4%} of values past rel {rel:g} of the pixel's "
                             f"bound (the largest {worst:.3g} of it)")
    return d.max().item()


def phase_grades_kernels(pk, pro_gan) -> list[dict]:
    """B1, B2 "lrelu_norm" and B3 in kernel mode "default" at the main path's
    shapes (batch 2) against their bf16 twins, two runs bit-equal, timed beside
    the bf16 bound and cuDNN on bf16 tensors with the epilogues."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dev = "cuda"

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t.float()))

    bf = torch.bfloat16
    B = BATCH_KERNELS
    rows = []

    up_calls = []
    for label, c, cout, h, rgb in (("stage7", 128, 64, 256, False),
                                   ("stage8+rgb", 64, 32, 512, True)):
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        kw = {"rgb_w": conv_w(3, c, 1, 1.0).reshape(3, c), "rgb_b": bias(3)} if rgb else {}
        got = pk.packed_upconv(x, w, b, mode="default", **kw)
        check_two_runs(f"packed_upconv[default,{label}]", got,
                       pk.packed_upconv(x, w, b, mode="default", **kw))
        want = pk.packed_upconv_plain(x, w, b, mode="default", **kw)
        got, want = (got, want) if rgb else ((got,), (want,))
        err = max(check_rel(f"packed_upconv[default,{label}]", g, t) for g, t in zip(got, want))

        def library(x=x, w=w, b=b, kw=kw):
            xb = x.to(bf)
            y = lrelu_norm(F.conv2d(F.interpolate(xb, scale_factor=2.0, mode="nearest"),
                                    w.to(bf), b.to(bf), padding=1))
            if kw:
                return y, F.conv2d(xb, kw["rgb_w"].to(bf)[:, :, None, None], kw["rgb_b"].to(bf))
            return y

        up_calls.append({
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": err, "bit_equal_runs": True,
            "ms": cuda_ms(lambda: pk.packed_upconv(x, w, b, mode="default", **kw)),
            "plain_ms": cuda_ms(lambda: pk.packed_upconv_plain(x, w, b, mode="default", **kw)),
            "library_ms": cuda_ms(library),
            "flops": 2 * 4 * c * cout * B * 4 * h * h + (2 * c * 3 * B * h * h if rgb else 0),
            "bytes": 4 * (B * c * h * h + B * cout * 4 * h * h + cout
                          + ((3 * c + 3 + B * 3 * h * h) if rgb else 0)) + 2 * 16 * c * cout,
            "peak_flops": PEAK_BF16_FLOPS,
        })
        del x, got, want
    rows.append(("packed_upconv[default]", "packed_upconv_bf16",
                 "probgan_tpu/ops/pallas_packed.py:832", up_calls))

    c, cout, h = 64, 64, 512
    x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
    got = pk.packed_conv(x, w, b, mode="default")
    check_two_runs("packed_conv[default]", got, pk.packed_conv(x, w, b, mode="default"))
    err = check_rel("packed_conv[default]", got, pk.packed_conv_plain(x, w, b, mode="default"))
    rows.append(("packed_conv[default]", "packed_conv_bf16",
                 "probgan_tpu/ops/pallas_packed.py:382", [{
                     "call": "stage7", "shape_in": [B, c, h, h], "bit_equal_runs": True,
                     "max_abs_err": err,
                     "ms": cuda_ms(lambda: pk.packed_conv(x, w, b, mode="default")),
                     "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b, mode="default")),
                     "library_ms": cuda_ms(lambda: lrelu_norm(F.conv2d(
                         x.to(bf), w.to(bf), b.to(bf), padding=1))),
                     "flops": 2 * 9 * c * cout * B * h * h,
                     "bytes": 4 * (2 * B * c * h * h + cout) + 2 * 9 * c * cout,
                     "peak_flops": PEAK_BF16_FLOPS}]))
    del x, got

    # B3 (csrc/bf16_ring.cuh ConvRgbBf16Ring) at stage 8 (32 -> 32 at 1024²),
    # the main path's, then stage 7 (64 -> 64 at 512²) and a ragged C of 40 (a
    # partial chunk): uint8 at alpha 1 (the main path's, timed), fp32 at a
    # fade-in alpha; the entry's numbers are stage 8's, the others beside it
    rgb_calls = []
    for label, c, cout, h in (("stage8", 32, 32, 1024), ("stage7", 64, 64, 512),
                              ("ragged 40->32@128", 40, 32, 128)):
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
        prev = 0.5 * torch.randn((B, 3, h // 2, h // 2), device=dev, generator=gen)
        args = (x, w, b, rgb_w, rgb_b, prev)
        got = pk.packed_conv_rgb(*args, 0.3, mode="default")
        check_two_runs(f"packed_conv_rgb[default,fp32,{label}]", got,
                       pk.packed_conv_rgb(*args, 0.3, mode="default"))
        err_fp32 = check_rel(f"packed_conv_rgb[default,fp32,{label}]", got,
                             pk.packed_conv_rgb_plain(*args, 0.3, mode="default"), flips=True)
        got = pk.packed_conv_rgb(*args, 1.0, emit_uint8=True, mode="default")
        again = pk.packed_conv_rgb(*args, 1.0, emit_uint8=True, mode="default")
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"packed_conv_rgb[default,uint8,{label}]: two runs on one "
                                 "input differ")
        worst, _, psnr = check_uint8(
            f"packed_conv_rgb[default,{label}] uint8 vs plain", got.cpu().numpy(),
            pk.packed_conv_rgb_plain(*args, 1.0, emit_uint8=True, mode="default").cpu().numpy())

        def library(args=args):
            x, w, b, rgb_w, rgb_b, prev = args
            feat = lrelu_norm(F.conv2d(x.to(bf), w.to(bf), b.to(bf), padding=1))
            rgb = F.conv2d(feat.to(bf), rgb_w.to(bf)[:, :, None, None], rgb_b.to(bf)).float()
            up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
            return pro_gan.to_uint8((up + 1.0 * (rgb - up)).permute(0, 2, 3, 1))

        rgb_calls.append({
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": float(worst),
            "max_abs_err_fp32": err_fp32, "psnr_db": finite_or_none(psnr),
            "bit_equal_runs": True,
            "ms": cuda_ms(lambda: pk.packed_conv_rgb(*args, 1.0, emit_uint8=True,
                                                     mode="default")),
            "fp32_ms": cuda_ms(lambda: pk.packed_conv_rgb(*args, 0.3, mode="default")),
            "plain_ms": cuda_ms(lambda: pk.packed_conv_rgb_plain(
                *args, 1.0, emit_uint8=True, mode="default")),
            "library_ms": cuda_ms(library),
            "flops": 2 * 9 * c * cout * B * h * h + 2 * cout * 3 * B * h * h,
            "bytes": 4 * (B * c * h * h + cout + 3 * cout + 3 + B * 3 * (h // 2) ** 2)
            + 2 * 9 * c * cout + B * h * h * 3,
            "peak_flops": PEAK_BF16_FLOPS})
        del x, got, again, args, prev
    rows.append(("packed_conv_rgb[default]", "packed_conv_rgb_bf16",
                 "probgan_tpu/ops/pallas_packed.py:678", rgb_calls[:1]))
    entries = assemble_conv_rows(rows, B)
    entries[-1]["beside_calls"] = [call_bound("packed_conv_rgb[default]", k)
                                   for k in rgb_calls[1:]]
    return entries


def phase_grades_path(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    """``generate`` at 1024², batch 8, at "high", "fast", None and dtype bf16
    on one set of seeded weights and latents; "high" again at the end, which
    must give the first "high" images bit for bit; "fast" must reach the 50 dB
    bar against "high" and launch the "default" kernels only. ``score`` at
    None against "high"."""
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    latents = [first.sample_latents(BATCH_MAIN) for _ in range(GRADE_CALLS)]
    runs = [("high", torch.float32), ("fast", torch.float32), (None, torch.float32),
            ("high", torch.bfloat16), ("high", torch.float32)]
    path, images, counts = {"batch": BATCH_MAIN, "calls": GRADE_CALLS}, [], {}
    for grade, dtype in runs:
        engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params, d_params=first.d_params,
                                           device="cuda", precision=grade, dtype=dtype)
        engine.generate(latents[0])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        pk.reset_launches()
        times = []
        for z in latents:
            t0 = time.perf_counter()
            img = engine.generate(z)
            times.append(time.perf_counter() - t0)
        launched = dict(pk.launches)
        label = f"{grade}" + ("" if dtype == torch.float32 else " bf16")
        if grade == "fast":
            counts = launched
        images.append(img)
        _, share, psnr = uint8_agreement(img, images[0])
        per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
        path[label if label not in path else f"{label} (last)"] = {
            "img_per_s": BATCH_MAIN * GRADE_CALLS / sum(times),
            "p50_ms_per_img": float(np.median(per_img_ms)), "batch_s": times,
            "psnr_vs_high_db": finite_or_none(psnr), "differing_bytes_vs_high": share,
            "launches": launched,
        }
        print(f"  generate at {label}: {BATCH_MAIN * GRADE_CALLS / sum(times):.3f} img/s, p50 "
              f"{float(np.median(per_img_ms)):.3f} ms/img, PSNR {psnr:.2f} dB vs \"high\" "
              f"({share:.4%} of bytes differ), launches {launched}")
        del engine
    fast = path["fast"]["psnr_vs_high_db"]
    if fast is not None and fast < PSNR_FLOOR_DB:
        raise AssertionError(f"\"fast\" generate: PSNR {fast:.2f} dB < {PSNR_FLOOR_DB} dB")
    want = {**{k: 0 for k in BF16_KERNELS},
            **{v: n * GRADE_CALLS for v, n in
               (("packed_upconv_bf16", 2), ("packed_conv_bf16", 1),
                ("packed_conv_rgb_bf16", 1))}}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"\"fast\" generate launched {counts}, expected {want}")
    if not np.array_equal(images[-1], images[0]):
        raise AssertionError("\"high\" after \"fast\", None and bf16 is not \"high\" alone, "
                             "bit for bit")
    print("  \"high\" after \"fast\", None and bf16: bit-equal to the first \"high\" run")

    # score at None (D unpacked: the gate declines None, TF32 convs) against
    # "high" (D's two packed stages on the fp32 kernels)
    reals = torch.as_tensor(images[0], device="cuda").float() / 127.5 - 1.0
    logits = {}
    for grade in ("high", None):
        engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params, d_params=first.d_params,
                                           device="cuda", precision=grade)
        logits[grade] = engine.score(reals)
    diff = float(np.abs(logits[None] - logits["high"]).max())
    path["score_none_vs_high_max_abs_diff"] = diff
    path["score_logits_high"] = logits["high"].tolist()
    print(f"  score at None vs \"high\": largest |logit difference| {diff:.3g} "
          f"(logits up to {float(np.abs(logits['high']).max()):.3g})")
    del first
    # the kernel entries' launches are those of the "fast" generate calls
    return {f"{k}[default]": counts[v] for k, v in BF16_KERNELS.items()}, path


# Phase 13: kernel mode "mid" (the 2-term split: weights rounded to bf16,
# activations as bf16(x) + bf16(x - bf16(x)), two bf16 products a dot) of
# B1, B2, B3 and B5. A twin splits the same operands and sums in fp32 in
# another order: fp32 outputs agree to GRADE_REL of the largest entry, B3's
# uint8 within +-1 on MID_UINT8_FLIP_SHARE of bytes. The bound counts the two
# passes' products at the bf16 peak.
MID_UINT8_FLIP_SHARE = 1e-4
MID_PASSES = 2
MID_CALLS = 3  # timed score and generate calls a grade
MID_TRAIN_STEPS = 2  # the train step's comparisons, each at the state the step before left
MID_TIMED_STEPS = 3
# The train step at "mid" against the fp32 kernels ("high"), leaf by leaf,
# by cosine and norm ratio. The JAX package holds its "mid" step to cos >
# 0.995 and ratios within 0.95-1.05 (JAX_MID_COS, JAX_MID_NORM_RATIO;
# tests/test_packed_vjp.py, 256², one packed stage a network, batch 2; the
# port's CPU test holds them there too). At 1024² with two packed stages a
# network the mode itself spreads wider (utils/mid_gradient_spread.py): over
# the default config's step at seeds 78-82, batches 2 and 8, alphas 0.5 and
# 1 (20 cases, an H100), the worst leaf reached cos 0.9902 (a 512-entry bias
# of D's last layers; weights 0.9943) and norm ratios 0.915-1.077 (biases
# and toRGB weights of 32-96 entries: sums over every pixel of a cotangent
# that PixelNorm's backward leaves nearly cancelling), while "high" and the
# unpacked fp32 path agreed to cos 0.999997 on every leaf, and the "mid"
# kernels equal their twins. Each leaf is held to cos > 0.98 and ratios
# within 0.9-1.1 (MID_COS, MID_NORM_RATIO); the leaves outside JAX's bounds
# are listed.
JAX_MID_COS, JAX_MID_NORM_RATIO = 0.995, (0.95, 1.05)
MID_COS, MID_NORM_RATIO = 0.98, (0.9, 1.1)
# Launches of one progan_train_step at packed_train_mode "mid" (stage 8,
# packed_d = packed_g): STEP_EPILOGUE_LAUNCHES on the "mid" kernels, and
# packed_conv_wgrad's 12 on its fp32 kernel.
MID_STEP_LAUNCHES = {**{k: 0 for k in STEP_LAUNCHES}, "packed_conv_wgrad": 12,
                     "packed_upconv_mid": 6, "packed_conv_mid": 32, "packed_convpool_mid": 8}
MID_STEP_EPILOGUE_LAUNCHES = {
    "packed_upconv_mid[lrelu_norm]": 4, "packed_upconv_mid[lrelu]": 2,
    "packed_conv_mid[lrelu_norm]": 4, "packed_conv_mid[lrelu]": 14, "packed_conv_mid[none]": 14,
    "packed_convpool_mid[lrelu]": 6, "packed_convpool_mid[none]": 2,
}


def phase_mid_kernels(pk, pro_gan) -> list[dict]:
    """B1 ("lrelu_norm" with and without toRGB, "lrelu"), B2 ("lrelu_norm",
    "lrelu", "none"), B3 (uint8, fp32) and B5 ("lrelu", "none") in kernel mode
    "mid" at their paths' shapes (batch 2; batch 8 for score's and generate's)
    against their "mid" twins, two runs bit-equal, timed beside the bound and
    F.conv2d in fp32 of x against the bf16-rounded weights with the epilogue
    ops. packed_conv "lrelu" at "mid" pooled in B5's order equals
    packed_convpool "lrelu" at "mid" bit for bit (convpool_lrelu's mask
    recompute)."""
    gen = torch.Generator(device="cuda").manual_seed(5151)
    dev = "cuda"

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t))

    def epi(t, epilogue):
        if epilogue == "lrelu_norm":
            return lrelu_norm(t)
        return pro_gan.lrelu(t) if epilogue == "lrelu" else t

    def timed(call, fn, plain, library, flops, nbytes, err, **extra):
        return {"call": call, "max_abs_err": err, "bit_equal_runs": True, **extra,
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
                "flops": flops, "op_flops": MID_PASSES * flops, "bytes": nbytes,
                "peak_flops": PEAK_BF16_FLOPS}

    rows = []
    # B1: the train step's stages 7 and 8 (batch 2), generate's (batch 8; the
    # final stage with the toRGB of its input)
    s7, s8 = (128, 64, 256), (64, 32, 512)
    for epilogue, cases in (("lrelu_norm", ((2, *s7, False), (2, *s8, False), (8, *s7, False),
                                            (8, *s8, True))),
                            ("lrelu", ((2, *s7, False), (2, *s8, False)))):
        calls = []
        for B, c, cout, h, rgb in cases:
            label = f"stage{7 if c == 128 else 8}{'+rgb' if rgb else ''} b{B}"
            x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
            kw = {"rgb_w": conv_w(3, c, 1, 1.0).reshape(3, c), "rgb_b": bias(3)} if rgb else {}
            kw.update(epilogue=epilogue, mode="mid")
            got = pk.packed_upconv(x, w, b, **kw)
            check_two_runs(f"packed_upconv[mid,{epilogue},{label}]", got,
                           pk.packed_upconv(x, w, b, **kw))
            want = pk.packed_upconv_plain(x, w, b, **kw)
            got, want = (got, want) if rgb else ((got,), (want,))
            err = max(check_rel(f"packed_upconv[mid,{epilogue},{label}]", g, t)
                      for g, t in zip(got, want))

            def library(x=x, w=w, b=b, kw=kw):
                y = epi(F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"),
                                 pk._bf16(w), b, padding=1), kw["epilogue"])
                if "rgb_w" in kw:
                    return y, F.conv2d(x, pk._bf16(kw["rgb_w"])[:, :, None, None],
                                       kw["rgb_b"])
                return y

            calls.append(timed(
                label, lambda: pk.packed_upconv(x, w, b, **kw),
                lambda: pk.packed_upconv_plain(x, w, b, **kw), library,
                2 * 4 * c * cout * B * 4 * h * h + (2 * c * 3 * B * h * h if rgb else 0),
                4 * (B * c * h * h + B * cout * 4 * h * h + cout
                     + ((3 * c + 3 + B * 3 * h * h) if rgb else 0)) + 2 * 16 * c * cout,
                err, shape_in=[B, c, h, h]))
            del x, got, want
        rows.append((f"packed_upconv_mid[{epilogue}]", "packed_upconv_bf16",
                     "probgan_tpu/ops/pallas_packed.py:832", calls))

    # B2: score's conv1 (batch 8 and 2), the train step's forward, recompute
    # and input gradients (batch 2), generate's stage-7 conv2 (batch 8)
    b2_cases = {
        "lrelu_norm": ((2, 32, 32, 1024), (2, 64, 64, 512), (8, 64, 64, 512)),
        "lrelu": ((8, 32, 32, 1024), (8, 64, 64, 512), (2, 32, 32, 1024), (2, 64, 64, 512),
                  (2, 32, 64, 1024), (2, 64, 128, 512)),
        "none": ((2, 32, 32, 1024), (2, 64, 32, 1024), (2, 64, 64, 512), (2, 128, 64, 512)),
    }
    for epilogue, cases in b2_cases.items():
        calls = []
        for B, c, cout, h in cases:
            label = f"{c}->{cout}@{h} b{B}"
            x, w = feats(B, c, h, h), conv_w(cout, c)
            b = torch.zeros(cout, device=dev) if epilogue == "none" else bias(cout)
            got = pk.packed_conv(x, w, b, epilogue, mode="mid")
            check_two_runs(f"packed_conv[mid,{epilogue},{label}]", got,
                           pk.packed_conv(x, w, b, epilogue, mode="mid"))
            err = check_rel(f"packed_conv[mid,{epilogue},{label}]", got,
                            pk.packed_conv_plain(x, w, b, epilogue, mode="mid"))
            calls.append(timed(
                label, lambda: pk.packed_conv(x, w, b, epilogue, mode="mid"),
                lambda: pk.packed_conv_plain(x, w, b, epilogue, mode="mid"),
                lambda: epi(F.conv2d(x, pk._bf16(w), b, padding=1), epilogue),
                2 * 9 * c * cout * B * h * h, 4 * (B * c * h * h + B * cout * h * h + cout)
                + 2 * 9 * c * cout, err, shape_in=[B, c, h, h]))
            del x, got
        rows.append((f"packed_conv_mid[{epilogue}]", "packed_conv_bf16",
                     "probgan_tpu/ops/pallas_packed.py:382", calls))

    # B5: score's conv2 + pool (batch 8 and 2) and the upconv's input gradient
    # (batch 2); packed_conv "lrelu" pooled in B5's order on the same inputs
    pool_equal = {}
    for epilogue, cases in (("lrelu", ((8, 32, 64, 1024), (8, 64, 128, 512),
                                       (2, 32, 64, 1024), (2, 64, 128, 512))),
                            ("none", ((2, 32, 64, 1024), (2, 64, 128, 512)))):
        calls = []
        for B, c, cout, h in cases:
            label = f"{c}->{cout}@{h} b{B}"
            x, w = feats(B, c, h, h), conv_w(cout, c)
            b = torch.zeros(cout, device=dev) if epilogue == "none" else bias(cout)
            got = pk.packed_convpool(x, w, b, epilogue, mode="mid")
            check_two_runs(f"packed_convpool[mid,{epilogue},{label}]", got,
                           pk.packed_convpool(x, w, b, epilogue, mode="mid"))
            err = check_rel(f"packed_convpool[mid,{epilogue},{label}]", got,
                            pk.packed_convpool_plain(x, w, b, epilogue, mode="mid"))
            if epilogue == "lrelu" and B == BATCH_KERNELS:
                n = differing_bits(pool_in_b5_order(pk.packed_conv(x, w, b, "lrelu",
                                                                   mode="mid")), got)
                pool_equal[label] = n
                print(f"  packed_conv[mid,lrelu] pooled in B5's order vs packed_convpool[mid] "
                      f"{label}: {n} differing values")
                if n:
                    raise AssertionError("packed_conv 'lrelu' at 'mid' pooled is not "
                                         "packed_convpool 'lrelu' at 'mid' bit for bit")
            calls.append(timed(
                label, lambda: pk.packed_convpool(x, w, b, epilogue, mode="mid"),
                lambda: pk.packed_convpool_plain(x, w, b, epilogue, mode="mid"),
                lambda: F.avg_pool2d(epi(F.conv2d(x, pk._bf16(w), b, padding=1), epilogue), 2),
                2 * 9 * c * cout * B * h * h,
                4 * (B * c * h * h + B * cout * h * h // 4 + cout) + 2 * 9 * c * cout, err,
                shape_in=[B, c, h, h]))
            del x, got
        rows.append((f"packed_convpool_mid[{epilogue}]", "packed_convpool_bf16",
                     "probgan_tpu/ops/pallas_packed.py:452", calls))

    # B3 (csrc/bf16_ring.cuh ConvRgbBf16Ring) at stage 8 (32 -> 32 at 1024²):
    # uint8 at alpha 1 (generate's, batch 8 and 2), fp32 at a fade-in alpha;
    # beside them stage 7 (64 -> 64 at 512²) and a ragged C of 40 (a partial
    # chunk), uint8 and fp32
    calls = []
    for B, u8, c, cout, h, stage in (
            (8, True, 32, 32, 1024, "stage8"), (2, True, 32, 32, 1024, "stage8"),
            (2, False, 32, 32, 1024, "stage8"), (2, True, 64, 64, 512, "stage7"),
            (2, False, 64, 64, 512, "stage7"), (2, True, 40, 32, 128, "ragged 40->32@128"),
            (2, False, 40, 32, 128, "ragged 40->32@128")):
        label = f"{stage} {'uint8' if u8 else 'fp32'} b{B}"
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
        prev = 0.5 * torch.randn((B, 3, h // 2, h // 2), device=dev, generator=gen)
        args, alpha = (x, w, b, rgb_w, rgb_b, prev), 1.0 if u8 else 0.3
        kw = dict(emit_uint8=u8, mode="mid")
        got = pk.packed_conv_rgb(*args, alpha, **kw)
        again = pk.packed_conv_rgb(*args, alpha, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"packed_conv_rgb[mid,{label}]: two runs on one input differ")
        want = pk.packed_conv_rgb_plain(*args, alpha, **kw)
        extra = {}
        if u8:
            worst, _, psnr = check_uint8(f"packed_conv_rgb[mid,{label}] vs plain",
                                         got.cpu().numpy(), want.cpu().numpy(),
                                         MID_UINT8_FLIP_SHARE)
            err, extra = float(worst), {"psnr_db": finite_or_none(psnr)}
        else:
            err = check_rel(f"packed_conv_rgb[mid,{label}]", got, want)

        def library(args=args, alpha=alpha, u8=u8):
            x, w, b, rgb_w, rgb_b, prev = args
            feat = lrelu_norm(F.conv2d(x, pk._bf16(w), b, padding=1))
            rgb = F.conv2d(feat, pk._bf16(rgb_w)[:, :, None, None], rgb_b)
            up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
            out = (up + alpha * (rgb - up)).permute(0, 2, 3, 1)
            return pro_gan.to_uint8(out) if u8 else out.contiguous()

        calls.append(timed(
            label, lambda: pk.packed_conv_rgb(*args, alpha, **kw),
            lambda: pk.packed_conv_rgb_plain(*args, alpha, **kw), library,
            2 * 9 * c * cout * B * h * h + 2 * cout * 3 * B * h * h,
            4 * (B * c * h * h + cout + 3 * cout + 3 + B * 3 * (h // 2) ** 2) + 2 * 9 * c * cout
            + B * h * h * 3 * (1 if u8 else 4), err, shape_in=[B, c, h, h], **extra))
        del x, got, again, want
    rows.append(("packed_conv_rgb_mid", "packed_conv_rgb_bf16",
                 "probgan_tpu/ops/pallas_packed.py:678", calls[:3]))
    out = assemble_conv_rows(rows, BATCH_KERNELS)
    out[-1]["beside_calls"] = [call_bound("packed_conv_rgb_mid", k) for k in calls[3:]]
    for entry in out:
        entry["batch"] = sorted({k["shape_in"][0] for k in entry["calls"]})
        if entry["name"] == "packed_convpool_mid[lrelu]":
            entry["conv_lrelu_pooled_differing_values"] = pool_equal
    return out


def leaf_agreement(label: str, got, want, tree_leaves, bounded: bool = True) -> dict:
    """Leaf by leaf, the cosine and the norm ratio of ``got`` against
    ``want`` (leaves zero in both skipped); raises outside MID_COS /
    MID_NORM_RATIO when ``bounded``. Returns the worst cosine, the least and
    largest ratio, and the leaves outside the JAX package's bounds."""
    out = {"cos": 1.0, "ratio": [math.inf, 0.0], "outside_jax_bounds": []}
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        shape = tuple(w.shape)
        g, w = g.double().flatten(), w.double().flatten()
        gn, wn = g.norm().item(), w.norm().item()
        if gn == 0 and wn == 0:
            continue
        cos = (g @ w).item() / (gn * wn + 1e-300)
        ratio = gn / (wn + 1e-300)
        out["cos"] = min(out["cos"], cos)
        out["ratio"] = [min(out["ratio"][0], ratio), max(out["ratio"][1], ratio)]
        if not (cos > JAX_MID_COS and JAX_MID_NORM_RATIO[0] < ratio < JAX_MID_NORM_RATIO[1]):
            out["outside_jax_bounds"].append({"leaf": i, "shape": shape, "cos": cos,
                                              "ratio": ratio})
        if bounded and not (cos > MID_COS and MID_NORM_RATIO[0] < ratio < MID_NORM_RATIO[1]):
            raise AssertionError(f"{label}: leaf {i} {shape} cos {cos:.6f}, norm ratio "
                                 f"{ratio:.4f} (bounds {MID_COS}, {MID_NORM_RATIO})")
    return out


def phase_mid_score(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    """Path (a): ``score`` at "fast" (D's two packed stages in kernel mode
    "mid") at 1024², batch 8: logits within LOGIT_TOL of the engine on the
    plain twins, the "mid" B2 and B5 launched 2/2 a call and no fp32 D kernel,
    scores/s; the largest logit difference against "high"; "high" after it
    bit-equal to "high" before it."""
    cfg = pro_gan.ProGANConfig()
    high = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    fast = engine_mod.ImageGANEngine(cfg, g_params=high.g_params, d_params=high.d_params,
                                     device="cuda", precision="fast")
    images = high.generate(high.sample_latents(BATCH_MAIN)).astype(np.float32) / 127.5 - 1.0
    first_high = high.score(images)
    fast.score(images)  # warm-up
    torch.cuda.synchronize()
    pk.reset_launches()
    times = []
    for _ in range(MID_CALLS):
        t0 = time.perf_counter()
        logits = fast.score(images)  # host numpy: the call has finished
        times.append(time.perf_counter() - t0)
    counts = {**pk.launches, **pk.epilogue_launches}
    want = {"packed_conv_mid[lrelu]": 2 * MID_CALLS, "packed_convpool_mid[lrelu]": 2 * MID_CALLS,
            "packed_conv": 0, "packed_convpool": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"score at \"fast\" launched {counts}, expected {want}")
    with swap_in_plain_twins(pk, ["packed_conv", "packed_convpool"]):
        twins = fast.score(images)
    err_twins = check_logits("score at \"fast\" vs the plain twins", logits, twins)
    diff_high = float(np.abs(logits - first_high).max())
    again = high.score(images)
    if not np.array_equal(again, first_high):
        raise AssertionError("score at \"high\" after \"fast\" is not the first \"high\" score")
    print(f"  score at \"fast\": {BATCH_MAIN * MID_CALLS / sum(times):.3f} scores/s, largest "
          f"|logit difference| vs \"high\" {diff_high:.3g}; \"high\" after it bit-equal; "
          f"launches {want}")
    del high, fast
    return counts, {"batch": BATCH_MAIN, "calls": MID_CALLS,
                    "scores_per_s": BATCH_MAIN * MID_CALLS / sum(times), "batch_s": times,
                    "max_abs_diff_vs_twins": err_twins, "max_abs_diff_vs_high": diff_high,
                    "logits": logits.tolist(), "high_after_mid_bit_equal": True}


def phase_mid_train(pk, pro_gan, train_mod, tree_mod) -> tuple[dict, dict]:
    """Path (b): progan_train_step at 1024², stage 8, batch 2, packed_d,
    packed_g, remat, packed_train_mode "mid" (BASELINE.json config 5 at
    "mid"). At each of MID_TRAIN_STEPS states, the raw gradients on the
    kernels against the plain twins (losses within STEP_LOSS_RTOL, leaves
    within STEP_GRAD_REL of their largest entry) and against the fp32 kernels
    at "high" (MID_COS, MID_NORM_RATIO a leaf); then MID_TIMED_STEPS counted
    steps: steps/s and peak device memory."""
    tree_leaves = tree_mod.tree_leaves
    cfg = pro_gan.ProGANConfig()
    stage, B = TRAIN_STAGE, TRAIN_BATCH
    kw = dict(packed_d=True, packed_g=True, remat=True)
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(78)
    real = torch.tanh(torch.randn((B, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((B, cfg.latent_dim), device="cuda", generator=gen)
    compared = []
    for i in range(MID_TRAIN_STEPS):
        alpha = 0.5 if i % 2 == 0 else 1.0
        pk.reset_launches()
        d_k, g_k, m_k = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                               packed_train_mode="mid", **kw)
        if dict(pk.launches) != MID_STEP_LAUNCHES or any(
                pk.epilogue_launches[k] != n for k, n in MID_STEP_EPILOGUE_LAUNCHES.items()):
            raise AssertionError(f"progan_grads at \"mid\" launched {dict(pk.launches)}, "
                                 f"{dict(pk.epilogue_launches)}")
        with swap_in_plain_twins(pk, PACKED_KERNELS):
            d_t, g_t, m_t = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                   packed_train_mode="mid", **kw)
        if dict(pk.launches) != MID_STEP_LAUNCHES:
            raise AssertionError("the plain twins launched a kernel")
        check_metrics(f"step {i} at \"mid\" vs the plain twins", m_k, m_t, STEP_LOSS_RTOL)
        rec = {"alpha": alpha, "metrics": {k: float(v) for k, v in m_k.items()},
               "vs_twins": {
                   "d": tree_rel_errs(f"step {i} D gradients vs the twins", d_k, d_t,
                                      tree_leaves, STEP_GRAD_REL),
                   "g": tree_rel_errs(f"step {i} G gradients vs the twins", g_k, g_t,
                                      tree_leaves, STEP_GRAD_REL)}}
        del d_t, g_t
        d_h, g_h, m_h = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                               packed_train_mode="high", **kw)
        rec["vs_high"] = {
            "d": leaf_agreement(f"step {i} D gradients vs \"high\"", d_k, d_h, tree_leaves),
            "g": leaf_agreement(f"step {i} G gradients vs \"high\"", g_k, g_h, tree_leaves)}
        rec["metrics_high"] = {k: float(v) for k, v in m_h.items()}
        hd, hg = rec["vs_high"]["d"], rec["vs_high"]["g"]
        print(f"  step {i} at \"mid\": gradients vs the twins within {rec['vs_twins']['d']:.3g} "
              f"(D) / {rec['vs_twins']['g']:.3g} (G) of a leaf's largest entry; vs \"high\" "
              f"worst cos {hd['cos']:.6f} / {hg['cos']:.6f}, norm ratios "
              f"{hd['ratio'][0]:.4f}-{hd['ratio'][1]:.4f} / {hg['ratio'][0]:.4f}-"
              f"{hg['ratio'][1]:.4f}; leaves outside the JAX bounds "
              f"{[(o['leaf'], o['shape']) for o in hd['outside_jax_bounds']]} / "
              f"{[(o['leaf'], o['shape']) for o in hg['outside_jax_bounds']]}")
        compared.append(rec)
        del d_k, g_k, d_h, g_h
        state, _ = train_mod.progan_train_step(state, real, z, alpha, cfg, stage,
                                               packed_train_mode="mid", **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    times, losses = [], []
    for i in range(MID_TIMED_STEPS):
        t0 = time.perf_counter()
        state, m = train_mod.progan_train_step(state, real, z, 0.5 if i % 2 == 0 else 1.0, cfg,
                                               stage, packed_train_mode="mid", **kw)
        losses.append({k: float(v) for k, v in m.items()})  # reads the card: the step is done
        times.append(time.perf_counter() - t0)
    counts = {**pk.launches, **pk.epilogue_launches}
    want = {k: n * MID_TIMED_STEPS for k, n in {**MID_STEP_LAUNCHES,
                                                 **MID_STEP_EPILOGUE_LAUNCHES}.items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"the \"mid\" train steps launched {counts}, expected {want}")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"a \"mid\" train step's metrics are not finite: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  progan_train_step at \"mid\": {MID_TIMED_STEPS / sum(times):.3f} steps/s, peak "
          f"{peak_gb:.2f} GB, launches per step {MID_STEP_EPILOGUE_LAUNCHES} (+ 12 wgrad)")
    del state
    return counts, {"batch": B, "stage": stage, "remat": True, "compared": compared,
                    "steps_per_s": MID_TIMED_STEPS / sum(times), "step_s": times,
                    "losses": losses, "peak_memory_gb": peak_gb,
                    "launches_per_step": {**MID_STEP_LAUNCHES, **MID_STEP_EPILOGUE_LAUNCHES}}


def phase_mid_generate(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    """Path (c): ``generate`` at 1024², batch 8, with G's packed mode "mid"
    and "default+mid" (``_PACKED_MODES["fast"]`` patched inside the phase, as
    the reference's own test does), beside "fast" as it is and "high", on
    phase 12's weights and latents: img/s, PSNR against "high" (>= 50 dB) and
    the launches each mode must make; "high" after them bit-equal to the
    first "high" run."""
    cfg = pro_gan.ProGANConfig()
    first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    latents = [first.sample_latents(BATCH_MAIN) for _ in range(MID_CALLS)]
    per_call = {
        "mid": {"packed_upconv_mid": 2, "packed_conv_mid": 1, "packed_conv_rgb_mid": 1},
        "default+mid": {"packed_upconv_bf16": 1, "packed_conv_bf16": 1, "packed_upconv_mid": 1,
                        "packed_conv_rgb_mid": 1},
    }
    path, images, counts = {"batch": BATCH_MAIN, "calls": MID_CALLS}, [], {}
    saved = pro_gan._PACKED_MODES["fast"]
    try:
        for label, mode in (("high", None), ("fast", None), ("fast mid", "mid"),
                            ("fast default+mid", "default+mid"), ("high (last)", None)):
            pro_gan._PACKED_MODES["fast"] = mode or saved
            grade = label.split()[0]
            engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                               d_params=first.d_params, device="cuda",
                                               precision=grade)
            engine.generate(latents[0])  # warm-up
            torch.cuda.synchronize()
            pk.reset_launches()
            times = []
            for z in latents:
                t0 = time.perf_counter()
                img = engine.generate(z)
                times.append(time.perf_counter() - t0)
            launched = dict(pk.launches)
            if mode is not None:
                want = {k: 0 for k in pk.launches}
                want.update({k: n * MID_CALLS for k, n in per_call[mode].items()})
                if launched != want:
                    raise AssertionError(f"generate at {mode!r} launched {launched}, "
                                         f"expected {want}")
                counts = {**launched, **pk.epilogue_launches} if mode == "mid" else counts
            images.append(img)
            _, share, psnr = uint8_agreement(img, images[0])
            path[label] = {"img_per_s": BATCH_MAIN * MID_CALLS / sum(times), "batch_s": times,
                           "psnr_vs_high_db": finite_or_none(psnr),
                           "differing_bytes_vs_high": share, "launches": launched}
            print(f"  generate at {label}: {BATCH_MAIN * MID_CALLS / sum(times):.3f} img/s, PSNR "
                  f"{psnr:.2f} dB vs \"high\" ({share:.4%} of bytes differ)")
            if mode is not None and psnr < PSNR_FLOOR_DB:
                raise AssertionError(f"generate at {mode!r}: PSNR {psnr:.2f} dB < "
                                     f"{PSNR_FLOOR_DB} dB")
            del engine
    finally:
        pro_gan._PACKED_MODES["fast"] = saved
    if not np.array_equal(images[-1], images[0]):
        raise AssertionError("\"high\" after the \"mid\" modes is not \"high\" alone, bit for bit")
    print("  \"high\" after \"fast\", \"mid\" and \"default+mid\": bit-equal to the first \"high\"")
    del first
    return counts, path


# Phase 14: kernel mode "default" of the training backward (one bf16 pass:
# both operands of every dot rounded to bf16, the products exact in fp32,
# summed in fp32): B1 "lrelu", B2 "lrelu"/"none", B5 "lrelu"/"none" (the
# one-term instantiations of csrc/bf16_conv.cuh) and B6
# (csrc/packed_conv_wgrad_bf16.cu), then the train step at the reference's
# default grade and the image trainer's --fast. A kernel and its twin differ
# only in the order of their fp32 sums: B1/B2/B5 are held to
# DEFAULT_BWD_REL of the largest entry (the "mid" kernels reached 3.9e-6),
# B6 to WGRAD_REL.
DEFAULT_BWD_REL = 4e-6
# The step on the kernels against the plain twins: the losses within
# STEP_LOSS_RTOL, and the mean logits (near 0, where a relative bound means
# nothing) within this much. One bf16 pass turns the kernel's and the twin's
# other order of fp32 sums into a whole bf16 step of an operand wherever a
# sum lies that close to a rounding boundary, and the next layer carries it:
# the mean real logit moved by 1.2e-5 (an H100, seed 79).
DEFAULT_LOGIT_ATOL = 1e-4
# Each Function of ops/packed_vjp.py at "default" on the kernels against the
# same Function on the twins (forward, dx, dw, db), within this share of the
# largest entry. The backward rounds to bf16 cotangents that the kernels and
# the twins compute in other orders of fp32 sums, and PixelNorm's cotangent
# is a difference of near-equal terms: where one lies within that noise of a
# rounding boundary it moves by a whole bf16 step (2^-8 of itself), and a
# weight gradient sums many such steps (conv_lrelu_norm's dw at 64 channels
# and 512²: 1.56e-3 of its largest entry, on an H100). A wrong tap, sign,
# scale or mode moves a value by its own size.
DEFAULT_FN_REL = 1e-2
# ... and dx on all but DEFAULT_FN_FLIP_SHARE of its values: where the
# kernel's forward and the twin's sum a pre-activation within their order's
# noise of zero, the LeakyReLU mask differs, the cotangent there by 0.8 g,
# and dx on that pixel's 9 x C neighbours by one term 0.8 g w of its sum (at
# most DEFAULT_FN_FLIP_REL of the largest entry). conv_lrelu at 32 channels
# and 1024² had 0.0015% of dx beyond 1e-3, at most 4.7e-2 (an H100).
DEFAULT_FN_FLIP_SHARE, DEFAULT_FN_FLIP_REL = 1e-4, 0.2
# The whole step's gradients on the kernels against the twins. One bf16 pass
# makes a step's gradients depend on the order of its fp32 sums far beyond
# that order's own noise: wherever a sum lies within the noise of a bf16
# rounding boundary, the next kernel sees a whole bf16 step of it, and
# leaves that are nearly cancelling sums over 2 million pixels (D's last
# layers, where the real and the fake batch pull apart; biases) amplify it:
# the twins alone move such a leaf by a tenth of its largest entry under a
# change of the inputs by a few ulps (DEFAULT_PERTURB), so no leaf-wise
# max-entry bound holds at this grade. Each network's gradients are held as
# one vector instead, by relative L2 and cosine (over seeds 79-82 and alphas
# 0.5 and 1 on an H100 the kernels reached 2.75e-2 and 0.99962), and the
# twins' own spread under DEFAULT_PERTURB is printed beside them.
DEFAULT_GRAD_L2, DEFAULT_GRAD_COS = 5e-2, 0.999
DEFAULT_PERTURB = 2.0 ** -21
# The weight gradient's shapes in a step at stage 8, batch 2: (C, Cout, H).
WGRAD_SHAPES = ((32, 32, 1024), (32, 64, 1024), (64, 64, 512), (64, 128, 512),
                (128, 64, 512), (64, 32, 1024))
# Launches of one progan_train_step at packed_train_mode "default" (stage 8,
# packed_d = packed_g): STEP_LAUNCHES on the bf16 kernels, and no fp32 or
# "mid" packed launch.
DEFAULT_STEP_LAUNCHES = {**{k: 0 for k in STEP_LAUNCHES}, "packed_upconv_bf16": 6,
                         "packed_conv_bf16": 32, "packed_convpool_bf16": 8,
                         "packed_conv_wgrad_bf16": 12}
DEFAULT_STEP_EPILOGUE_LAUNCHES = {
    "packed_upconv_bf16[lrelu_norm]": 4, "packed_upconv_bf16[lrelu]": 2,
    "packed_conv_bf16[lrelu_norm]": 4, "packed_conv_bf16[lrelu]": 14,
    "packed_conv_bf16[none]": 14, "packed_convpool_bf16[lrelu]": 6,
    "packed_convpool_bf16[none]": 2,
}
DEFAULT_TIMED_STEPS = 3
# The packed "default" step against the fp32 kernels ("highest"), leaf by
# leaf: its worst cosine may fall below the unpacked bf16 step's (the bf16
# training the reference ships, the same grade in its docstring) by this
# much at most.
DEFAULT_COS_MARGIN = 0.01
# --fast: phase 11's trainer schedule (1024², 4 synthetic images, batch 2),
# cut to 1 epoch a stage (phase 11: 2) in one process (no resume, no grow)
# and without PROBGAN_STAGE_FUSED.
FAST_EPOCHS = 1
BF16_TRAIN_KERNELS = ("packed_upconv_bf16", "packed_conv_bf16", "packed_convpool_bf16",
                      "packed_conv_wgrad_bf16")


@contextlib.contextmanager
def deterministic_cudnn():
    """Inside, cuDNN takes only algorithms that give the same bits on every
    call (``torch.backends.cudnn.deterministic``); restored on exit."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def vector_agreement(got, want, tree_leaves) -> dict:
    """``got`` against ``want`` as one vector over the leaves: relative L2
    distance and cosine, and the worst leaf's max difference over its
    largest entry."""
    g = torch.cat([a.double().flatten() for a in tree_leaves(got)])
    w = torch.cat([b.double().flatten() for b in tree_leaves(want)])
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(tree_leaves(got), tree_leaves(want)) if b.abs().max() > 0)
    return {"l2": ((g - w).norm() / w.norm()).item(),
            "cos": ((g @ w) / (g.norm() * w.norm())).item(), "worst_leaf": worst}


def phase_default_kernels(pk, packed_vjp, pro_gan) -> list[dict]:
    """B1 "lrelu", B2 "lrelu"/"none", B5 "lrelu"/"none" and B6 in kernel mode
    "default" at the 1024² stage-8 batch-2 step's shapes against their twins
    (TF32 off), two runs bit-equal, timed beside the bf16 bound and cuDNN in
    bf16 (F.conv2d with the epilogue ops; torch.nn.grad.conv2d_weight for
    B6); packed_conv "lrelu" at "default" pooled in B5's order equals
    packed_convpool "lrelu" at "default" bit for bit (convpool_lrelu's mask
    recompute); the four Functions at "default" on the kernels against the
    same Functions on the twins (DEFAULT_FN_REL)."""
    gen = torch.Generator(device="cuda").manual_seed(6161)
    dev, bf, B = "cuda", torch.bfloat16, BATCH_KERNELS

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin):
        return torch.randn((cout, cin, 3, 3), device=dev, generator=gen) * math.sqrt(
            2.0 / (9 * cin))

    def epi(t, epilogue):
        return pro_gan.lrelu(t.float()) if epilogue == "lrelu" else t.float()

    def timed(call, fn, plain, library, flops, nbytes, err, **extra):
        return {"call": call, "max_abs_err": err, "bit_equal_runs": True, **extra,
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
                "flops": flops, "bytes": nbytes, "peak_flops": PEAK_BF16_FLOPS}

    rows, pool_equal = [], {}
    with pro_gan.precision_scope("high"):
        # B1 "lrelu": the pre-norm recompute of stages 7 and 8
        calls = []
        for label, c, cout, h in (("stage7", 128, 64, 256), ("stage8", 64, 32, 512)):
            x, w, b = feats(B, c, h, h), conv_w(cout, c), 0.1 * torch.randn(cout, device=dev,
                                                                             generator=gen)
            kw = dict(epilogue="lrelu", mode="default")
            got = pk.packed_upconv(x, w, b, **kw)
            check_two_runs(f"packed_upconv[default,lrelu,{label}]", got,
                           pk.packed_upconv(x, w, b, **kw))
            err = check_rel(f"packed_upconv[default,lrelu,{label}]", got,
                            pk.packed_upconv_plain(x, w, b, **kw), rel=DEFAULT_BWD_REL)
            calls.append(timed(
                label, lambda: pk.packed_upconv(x, w, b, **kw),
                lambda: pk.packed_upconv_plain(x, w, b, **kw),
                lambda: epi(F.conv2d(F.interpolate(x.to(bf), scale_factor=2.0, mode="nearest"),
                                     w.to(bf), b.to(bf), padding=1), "lrelu"),
                2 * 4 * c * cout * B * 4 * h * h,
                4 * (B * c * h * h + B * cout * 4 * h * h + cout) + 2 * 16 * c * cout, err,
                shape_in=[B, c, h, h]))
            del x, got
        rows.append(("packed_upconv_bf16[lrelu]", "packed_upconv_bf16",
                     "probgan_tpu/ops/pallas_packed.py:832", calls))

        # B2 "lrelu": D's conv1 and convpool_lrelu's mask recompute; "none":
        # the input gradients; B5 "lrelu": D's conv2 + pool, "none": the
        # upconv's input gradient
        cases = (("packed_conv", "lrelu", ((32, 32, 1024), (64, 64, 512), (32, 64, 1024),
                                          (64, 128, 512))),
                 ("packed_conv", "none", ((32, 32, 1024), (64, 32, 1024), (64, 64, 512),
                                         (128, 64, 512))),
                 ("packed_convpool", "lrelu", ((32, 64, 1024), (64, 128, 512))),
                 ("packed_convpool", "none", ((32, 64, 1024), (64, 128, 512))))
        for kernel, epilogue, shapes in cases:
            fn, plain = getattr(pk, kernel), getattr(pk, f"{kernel}_plain")
            pool = kernel == "packed_convpool"
            calls = []
            for c, cout, h in shapes:
                label = f"{c}->{cout}@{h}"
                x, w = feats(B, c, h, h), conv_w(cout, c)
                b = (torch.zeros(cout, device=dev) if epilogue == "none"
                     else 0.1 * torch.randn(cout, device=dev, generator=gen))
                got = fn(x, w, b, epilogue, mode="default")
                check_two_runs(f"{kernel}[default,{epilogue},{label}]", got,
                               fn(x, w, b, epilogue, mode="default"))
                err = check_rel(f"{kernel}[default,{epilogue},{label}]", got,
                                plain(x, w, b, epilogue, mode="default"), rel=DEFAULT_BWD_REL)
                if pool and epilogue == "lrelu":
                    n = differing_bits(pool_in_b5_order(pk.packed_conv(x, w, b, "lrelu",
                                                                       mode="default")), got)
                    pool_equal[label] = n
                    print(f"  packed_conv[default,lrelu] pooled in B5's order vs "
                          f"packed_convpool[default] {label}: {n} differing values")
                    if n:
                        raise AssertionError("packed_conv 'lrelu' at 'default' pooled is not "
                                             "packed_convpool 'lrelu' at 'default' bit for bit")

                def library(x=x, w=w, b=b, epilogue=epilogue, pool=pool):
                    y = epi(F.conv2d(x.to(bf), w.to(bf), b.to(bf), padding=1), epilogue)
                    return F.avg_pool2d(y, 2) if pool else y

                calls.append(timed(
                    label, lambda: fn(x, w, b, epilogue, mode="default"),
                    lambda: plain(x, w, b, epilogue, mode="default"), library,
                    2 * 9 * c * cout * B * h * h,
                    4 * (B * c * h * h + B * cout * h * h // (4 if pool else 1) + cout)
                    + 2 * 9 * c * cout, err, shape_in=[B, c, h, h]))
                del x, got
            rows.append((f"{kernel}_bf16[{epilogue}]", f"{kernel}_bf16",
                         "probgan_tpu/ops/pallas_packed.py:"
                         + ("452" if pool else "382"), calls))

        # B6: the step's six weight-gradient shapes
        calls = []
        for c, cout, h in WGRAD_SHAPES:
            label = f"{c}->{cout}@{h}"
            x = feats(B, c, h, h)
            g = 0.01 * torch.randn((B, cout, h, h), device=dev, generator=gen)
            got = pk.packed_conv_wgrad(x, g, mode="default")
            again = pk.packed_conv_wgrad(x, g, mode="default")
            torch.cuda.synchronize()
            if differing_bits(got, again):
                raise AssertionError(f"packed_conv_wgrad[default,{label}]: two runs differ")
            err = check_rel(f"packed_conv_wgrad[default,{label}]", got,
                            pk.packed_conv_wgrad_plain(x, g, mode="default"), rel=WGRAD_REL)
            calls.append(timed(
                label, lambda: pk.packed_conv_wgrad(x, g, mode="default"),
                lambda: pk.packed_conv_wgrad_plain(x, g, mode="default"),
                lambda: torch.nn.grad.conv2d_weight(x.to(bf), (cout, c, 3, 3), g.to(bf),
                                                    padding=1),
                2 * 9 * c * cout * B * h * h, 4 * (B * h * h * (c + cout) + 9 * c * cout), err,
                shape_in=[B, c, h, h], fp32_kernel_ms=cuda_ms(lambda: pk.packed_conv_wgrad(x, g))))
            del x, g, got, again
        rows.append(("packed_conv_wgrad_bf16", "packed_conv_wgrad_bf16",
                     "probgan_tpu/ops/pallas_packed.py:558", calls))

    # the four Functions at "default" (forward and backward) on the kernels
    # against the same Functions on the twins, at phase 8's shapes
    def vjp(fn, x, w, b, cot):
        x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(x, w, b, mode="default")
        return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))

    fn_errs = {}
    for name, c, cout, h, norm_in in (("conv_lrelu", 32, 32, 1024, False),
                                      ("convpool_lrelu", 64, 128, 512, False),
                                      ("conv_lrelu_norm", 64, 64, 512, True),
                                      ("upconv_lrelu_norm", 64, 32, 512, True)):
        x = torch.randn((B, c, h, h), device=dev, generator=gen)
        x = pro_gan.pixel_norm(x) if norm_in else pro_gan.lrelu(x)
        w, b = conv_w(cout, c), 0.1 * torch.randn(cout, device=dev, generator=gen)
        fn = getattr(packed_vjp, name)
        with torch.no_grad():
            cot = torch.randn(fn(x, w, b, mode="default").shape, device=dev, generator=gen)
        got = vjp(fn, x, w, b, cot)
        with swap_in_plain_twins(pk, PACKED_KERNELS):
            want = vjp(fn, x, w, b, cot)
        fn_errs[name] = [check_rel(f"packed_vjp.{name}[default] {part} vs the twins", g, t,
                                   flips=part == "dx", rel=DEFAULT_FN_REL,
                                   flip_share=DEFAULT_FN_FLIP_SHARE,
                                   flip_rel=DEFAULT_FN_FLIP_REL)
                         for part, g, t in zip(("y", "dx", "dw", "db"), got, want)]
        print(f"  packed_vjp.{name}[default] C{c}->Cout{cout}@{h} vs the same Function on the "
              f"twins: y {fn_errs[name][0]:.3g}  dx {fn_errs[name][1]:.3g}  dw "
              f"{fn_errs[name][2]:.3g}  db {fn_errs[name][3]:.3g} of the largest entry")
        del x, cot, got, want
    out = assemble_conv_rows(rows, B)
    for entry in out:
        if entry["name"] == "packed_convpool_bf16[lrelu]":
            entry["conv_lrelu_pooled_differing_values"] = pool_equal
        if entry["name"] == "packed_conv_wgrad_bf16":
            entry["functions_vs_twins_y_dx_dw_db"] = fn_errs
    return out


def phase_default_train(pk, pro_gan, train_mod, tree_mod) -> tuple[dict, dict]:
    """progan_train_step at 1024², stage 8, batch 2, packed_d, packed_g,
    remat and the default packed_train_mode, "default" (BASELINE.json config
    5 at the reference's default grade): the raw gradients on the kernels
    against the plain twins (losses within STEP_LOSS_RTOL, leaves within
    STEP_GRAD_REL of their largest entry) and, leaf by leaf, against the fp32
    kernels ("highest") beside the unpacked step at dtype bf16 against the
    same (the worst cosines within DEFAULT_COS_MARGIN); timed steps with
    their launches at "default" and at dtype bf16 (the --fast math): steps/s
    and peak device memory; "highest" after them bit-equal to the first."""
    tree_leaves = tree_mod.tree_leaves
    cfg = pro_gan.ProGANConfig()
    stage, B, alpha = TRAIN_STAGE, TRAIN_BATCH, 0.5
    kw = dict(packed_d=True, packed_g=True, remat=True)
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(79)
    real = torch.tanh(torch.randn((B, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((B, cfg.latent_dim), device="cuda", generator=gen)

    # cuDNN's fp32 backward may pick an algorithm that sums in another order
    # from call to call: the two "highest" runs take its deterministic ones
    with deterministic_cudnn():
        first_high = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                            packed_train_mode="highest", **kw)
    pk.reset_launches()
    d_k, g_k, m_k = train_mod.progan_grads(state, real, z, alpha, cfg, stage, **kw)
    if dict(pk.launches) != DEFAULT_STEP_LAUNCHES or any(
            pk.epilogue_launches[k] != n for k, n in DEFAULT_STEP_EPILOGUE_LAUNCHES.items()):
        raise AssertionError(f"progan_grads at \"default\" launched {dict(pk.launches)}, "
                             f"{dict(pk.epilogue_launches)}")
    noise = torch.Generator(device="cuda").manual_seed(80)

    def nudged(t):
        return t * (1.0 + DEFAULT_PERTURB * torch.randn(t.shape, device="cuda", generator=noise))

    with swap_in_plain_twins(pk, PACKED_KERNELS):
        d_t, g_t, m_t = train_mod.progan_grads(state, real, z, alpha, cfg, stage, **kw)
        d_p, g_p, _ = train_mod.progan_grads(state, nudged(real), nudged(z), alpha, cfg, stage,
                                             **kw)
    if dict(pk.launches) != DEFAULT_STEP_LAUNCHES:
        raise AssertionError("the plain twins launched a kernel")
    check_metrics("step at \"default\" vs the plain twins", m_k, m_t, STEP_LOSS_RTOL,
                  DEFAULT_LOGIT_ATOL)
    vs_twins = {}
    for net, got, twin, nudge in (("D", d_k, d_t, d_p), ("G", g_k, g_t, g_p)):
        vs_twins[net] = {"kernels": vector_agreement(got, twin, tree_leaves),
                         "twins_nudged": vector_agreement(nudge, twin, tree_leaves)}
        kt, tp = vs_twins[net]["kernels"], vs_twins[net]["twins_nudged"]
        print(f"  {net} gradients at \"default\", kernels vs twins: relative L2 {kt['l2']:.3g}, "
              f"cos {kt['cos']:.6f}, worst leaf {kt['worst_leaf']:.3g} of its largest entry; "
              f"the twins under inputs x (1 + {DEFAULT_PERTURB:g} N(0, 1)): {tp['l2']:.3g}, "
              f"{tp['cos']:.6f}, {tp['worst_leaf']:.3g}")
        if not (kt["l2"] <= DEFAULT_GRAD_L2 and kt["cos"] >= DEFAULT_GRAD_COS):
            raise AssertionError(f"{net} gradients at \"default\" vs the twins: {kt} (bounds "
                                 f"L2 {DEFAULT_GRAD_L2}, cos {DEFAULT_GRAD_COS})")
    del d_t, g_t, d_p, g_p
    d_b, g_b, m_b = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                           dtype=torch.bfloat16, remat=True)
    spread = {}
    for label, (d, g) in (("packed_default", (d_k, g_k)), ("unpacked_bf16", (d_b, g_b))):
        spread[label] = {
            "d": leaf_agreement(f"D {label} vs \"highest\"", d, first_high[0], tree_leaves,
                                bounded=False),
            "g": leaf_agreement(f"G {label} vs \"highest\"", g, first_high[1], tree_leaves,
                                bounded=False)}
        sd, sg = spread[label]["d"], spread[label]["g"]
        print(f"  {label} vs the fp32 kernels: worst cos {sd['cos']:.6f} (D) / {sg['cos']:.6f} "
              f"(G), norm ratios {sd['ratio'][0]:.4f}-{sd['ratio'][1]:.4f} / "
              f"{sg['ratio'][0]:.4f}-{sg['ratio'][1]:.4f}; leaves outside the JAX \"mid\" "
              f"bounds {[(o['leaf'], o['shape']) for o in sd['outside_jax_bounds']]} / "
              f"{[(o['leaf'], o['shape']) for o in sg['outside_jax_bounds']]}")
    worst = {k: min(v["d"]["cos"], v["g"]["cos"]) for k, v in spread.items()}
    if worst["packed_default"] < worst["unpacked_bf16"] - DEFAULT_COS_MARGIN:
        raise AssertionError(f"the packed \"default\" step's worst leaf cosine "
                             f"{worst['packed_default']:.6f} is below the unpacked bf16 "
                             f"step's {worst['unpacked_bf16']:.6f} by more than "
                             f"{DEFAULT_COS_MARGIN}")
    del d_k, g_k, d_b, g_b
    torch.cuda.empty_cache()

    runs, counts = {}, {}
    for label, dtype in (("default", torch.float32), ("default bf16", torch.bfloat16)):
        st, _ = train_mod.progan_train_step(state, real, z, alpha, cfg, stage, dtype=dtype, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launches()
        times, losses = [], []
        for i in range(DEFAULT_TIMED_STEPS):
            t0 = time.perf_counter()
            st, m = train_mod.progan_train_step(st, real, z, 0.5 if i % 2 == 0 else 1.0, cfg,
                                                stage, dtype=dtype, **kw)
            losses.append({k: float(v) for k, v in m.items()})  # reads the card
            times.append(time.perf_counter() - t0)
        launched = {**pk.launches, **pk.epilogue_launches}
        want = {k: n * DEFAULT_TIMED_STEPS for k, n in {**DEFAULT_STEP_LAUNCHES,
                                                        **DEFAULT_STEP_EPILOGUE_LAUNCHES}.items()}
        if any(launched[k] != n for k, n in want.items()):
            raise AssertionError(f"the train steps at {label} launched {launched}, "
                                 f"expected {want}")
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"a train step at {label} has metrics that are not finite: "
                                 f"{losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        runs[label] = {"steps_per_s": DEFAULT_TIMED_STEPS / sum(times), "step_s": times,
                       "losses": losses, "peak_memory_gb": peak_gb}
        if dtype == torch.float32:
            counts = launched
        print(f"  progan_train_step at {label}: {DEFAULT_TIMED_STEPS / sum(times):.3f} steps/s, "
              f"peak {peak_gb:.2f} GB, launches per step {DEFAULT_STEP_EPILOGUE_LAUNCHES} "
              "(+ 12 wgrad)")
        del st
        torch.cuda.empty_cache()

    with deterministic_cudnn():
        again = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                       packed_train_mode="highest", **kw)
    if any(not torch.equal(a, b) for a, b in zip(tree_leaves(again[:2]),
                                                 tree_leaves(first_high[:2]))):
        raise AssertionError("\"highest\" after \"default\" is not the first \"highest\", "
                             "bit for bit")
    print("  \"highest\" after \"default\" and bf16: bit-equal to the first \"highest\"")
    del state, first_high, again
    return counts, {"batch": B, "stage": stage, "remat": True, "alpha": alpha,
                    "vs_twins": vs_twins, "vs_highest": spread, "worst_cos": worst,
                    "metrics": {k: float(v) for k, v in m_k.items()},
                    "metrics_unpacked_bf16": {k: float(v) for k, v in m_b.items()},
                    "runs": runs, "highest_after_default_bit_equal": True,
                    "launches_per_step": {**DEFAULT_STEP_LAUNCHES,
                                          **DEFAULT_STEP_EPILOGUE_LAUNCHES}}


def phase_fast_cli(pk, cli_train, image_checkpoint_mod, tree_mod) -> dict:
    """The image trainer CLI with --fast (--bf16 --packed_d --packed_g at
    --packed_mode default) on phase 11's schedule at 1024², cut to
    FAST_EPOCHS a stage in one process: every stage trains with finite
    losses, stages 7-8 on the bf16 kernels and no fp32 or "mid" packed
    kernel; the checkpoint loads in the port. Seconds per stage from
    metrics.jsonl."""
    args = ["--model", "image", "--synthetic", str(TRAINER_IMAGES), "--batch_size",
            str(TRAINER_BATCH), "--epochs_per_stage", str(FAST_EPOCHS), "--resolution", "1024",
            "--checkpoint_minutes", "0", "--device", "cuda", "--fast"]
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "fast")
        pk.reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_train.main([*args, "--output_dir", out_dir])
        wall_s = time.perf_counter() - t0
        if rc != 0 or "Training complete!" not in out.getvalue():
            raise AssertionError(f"image trainer --fast exited {rc}:\n{out.getvalue()}")
        launched = dict(pk.launches)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        cfg, g_params, d_params = image_checkpoint_mod.load_image_checkpoint(
            os.path.join(out_dir, "image_checkpoint.msgpack"))
    if any(launched[k] < 1 for k in BF16_TRAIN_KERNELS) or any(
            n for k, n in launched.items() if k not in BF16_TRAIN_KERNELS):
        raise AssertionError(f"--fast launched {launched}: expected the bf16 training kernels "
                             "and no other packed kernel")
    stages = cfg.num_stages
    if [(m["stage"], m["epoch"]) for m in metrics] != [
            (s, e) for s in range(stages) for e in range(1, FAST_EPOCHS + 1)]:
        raise AssertionError(f"--fast metrics.jsonl: {metrics}")
    if any(not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"])) for m in metrics):
        raise AssertionError(f"--fast losses are not finite: {metrics}")
    if cfg.resolution != 1024 or not d_params or not all(
            torch.isfinite(t).all() for t in tree_mod.tree_leaves(g_params)):
        raise AssertionError("--fast wrote a checkpoint the port does not load as trained")
    stage_s = {m["stage"]: m["seconds"] for m in metrics}
    print(f"  image trainer CLI --fast at 1024² ({TRAINER_IMAGES} images, batch "
          f"{TRAINER_BATCH}, {FAST_EPOCHS} epoch a stage): seconds per stage "
          f"{', '.join(f'{k}: {v:.4f}' for k, v in stage_s.items())}; {wall_s:.1f} s in all; "
          f"launches {launched}; the checkpoint loads in the port")
    return {"images": TRAINER_IMAGES, "batch": TRAINER_BATCH, "epochs_per_stage": FAST_EPOCHS,
            "seconds_per_stage": stage_s, "wall_s": wall_s, "launches": launched,
            "losses": [(m["d_loss"], m["g_loss"]) for m in metrics]}


# Phase 15: kernel modes "default" and "mid" of the stage-fused kernels B10
# and B11 (csrc/fused_bf16.cuh). Each must equal the bf16 pair at its mode
# bit for bit. Its twin composes the pair's twins, whose conv1 sums in
# another order; a conv1 value within that noise of a bf16 rounding
# boundary then rounds the other way before conv2 (a flip that phases 12-13
# never meet: there the second kernel reads the first one's bits), so fp32
# outputs are held to GRADE_REL of the largest entry on all but
# GRADE_FLIP_SHARE of values and GRADE_FLIP_REL on the rest. A flip moves
# conv2's sums, PixelNorm's and the rounded features that toRGB reads, so a
# uint8 pixel can move by more than one level where it lands (2 levels on
# 0.033% of bytes, 83 dB, at "default" stage 8 on an H100): uint8 outputs
# are held to UINT8_MAX_FLIP_SHARE of bytes apart and FUSED_BF16_PSNR_DB.
# The bound counts the products of every bf16 pass at the bf16 peak.
FUSED_BF16_PSNR_DB = 60.0
FUSED_BF16_MODES = ("default", "mid")
FUSED_BF16_CALLS = 3  # timed generate calls a grade and variable
FUSED_BF16_WALK_FRAMES = 16
# one generate call's launches under the variable, by G's packed mode
FUSED_BF16_PER_CALL = {
    "default": {"packed_upconv_conv_bf16": 1, "packed_upconv_conv_rgb_bf16": 1},
    "mid": {"packed_upconv_conv_mid": 1, "packed_upconv_conv_rgb_mid": 1},
    "default+mid": {"packed_upconv_conv_bf16": 1, "packed_upconv_conv_rgb_mid": 1},
}
FUSED_TRAIN_STEPS = 2


def phase_fused_bf16_kernels(pk, pro_gan) -> tuple[list[dict], dict]:
    """B10 and B11 at "default" and "mid" at the 1024² generator's shapes
    against their twins, the bf16 pair on the card (bit for bit) and
    themselves (two runs), timed beside the pair, cuDNN in bf16 and the
    bound; the conv1 pixels a conv2 output that the kernel stores, counted
    (``_tally``)."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    dev = "cuda"

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    bf = torch.bfloat16

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t.float()))

    def stage_library(x, w1, b1, w2, b2):  # cuDNN on bf16 tensors, the upsampled input
        up = F.interpolate(x.to(bf), scale_factor=2.0, mode="nearest")
        f1 = lrelu_norm(F.conv2d(up, w1.to(bf), b1.to(bf), padding=1))
        return lrelu_norm(F.conv2d(f1.to(bf), w2.to(bf), b2.to(bf), padding=1))

    def counted(fn, n_out):
        """conv1 pixels the kernel stores a conv2 output, from its tally."""
        tally = torch.zeros(1, dtype=torch.int64, device=dev)
        fn(tally)
        return tally.item() / n_out

    B = BATCH_KERNELS
    rows, conv1_counted = [], {}
    for mode in FUSED_BF16_MODES:
        passes = pk.BF16_TERMS[mode]
        c, cout, h = 128, 64, 256
        x, w1, b1, w2, b2 = feats(B, c, h, h), conv_w(cout, c), bias(cout), conv_w(cout, cout), \
            bias(cout)
        args = (x, w1, b1, w2, b2)
        label = f"packed_upconv_conv[{mode},stage7]"
        got = pk.packed_upconv_conv(*args, mode=mode)
        check_two_runs(label, got, pk.packed_upconv_conv(*args, mode=mode))
        pair = pk.packed_conv(pk.packed_upconv(x, w1, b1, mode=mode), w2, b2, mode=mode)
        n_diff = differing_bits(got, pair)
        err = check_rel(label, got, pk.packed_upconv_conv_plain(*args, mode=mode), flips=True)
        print(f"  {label}: {err:.3g} of the largest entry off its twin, values differing from "
              f"the bf16 pair {n_diff}")
        if n_diff:
            raise AssertionError(f"{label}: not bit-equal to the bf16 pair")
        del got, pair
        pixels = B * 4 * h * h
        conv1_counted[label] = counted(
            lambda t: pk.packed_upconv_conv(*args, mode=mode, _tally=t), pixels)
        rows.append((f"packed_upconv_conv[{mode}]", "packed_upconv_conv_bf16",
                     "probgan_tpu/ops/pallas_packed.py:973", [{
                         "call": "stage7", "shape_in": [B, c, h, h], "max_abs_err": err,
                         "differing_vs_pair": n_diff, "bit_equal_runs": True,
                         "conv1_per_output": conv1_counted[label],
                         "ms": cuda_ms(lambda: pk.packed_upconv_conv(*args, mode=mode)),
                         "pair_ms": cuda_ms(lambda: pk.packed_conv(
                             pk.packed_upconv(x, w1, b1, mode=mode), w2, b2, mode=mode)),
                         "plain_ms": cuda_ms(lambda: pk.packed_upconv_conv_plain(*args,
                                                                                 mode=mode)),
                         "library_ms": cuda_ms(lambda: stage_library(*args)),
                         # conv1 at 4 pre-summed taps an output, conv2 at 9, each pass
                         "flops": passes * (2 * 4 * c * cout * pixels
                                            + 2 * 9 * cout * cout * pixels),
                         "bytes": 4 * (B * c * h * h + cout * pixels + 2 * cout)
                         + 2 * (16 * c * cout + 9 * cout * cout),
                         "peak_flops": PEAK_BF16_FLOPS}]))
        del args, x

        calls = []
        for call, bsz, c, cout, h, alpha, u8 in (("stage8", B, 64, 32, 512, 1.0, True),
                                                 ("stage8_fp32", B, 64, 32, 512, 0.3, False),
                                                 ("stage7", B, 128, 64, 256, 1.0, True),
                                                 ("stage8_b8", 8, 64, 32, 512, 1.0, True)):
            x, w1, b1, w2, b2 = (feats(bsz, c, h, h), conv_w(cout, c), bias(cout),
                                 conv_w(cout, cout), bias(cout))
            rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
            prev_w, prev_b = conv_w(3, c, 1, 1.0).reshape(3, c), bias(3)
            args = (x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha)
            label = f"packed_upconv_conv_rgb[{mode},{call}]"

            def fused(tally=None, args=args, u8=u8):
                return pk.packed_upconv_conv_rgb(*args, emit_uint8=u8, mode=mode, _tally=tally)

            def two_kernels(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b,
                            prev_w=prev_w, prev_b=prev_b, alpha=alpha, u8=u8):
                f, rp = pk.packed_upconv(x, w1, b1, rgb_w=prev_w, rgb_b=prev_b, mode=mode)
                return pk.packed_conv_rgb(f, w2, b2, rgb_w, rgb_b, rp, alpha, emit_uint8=u8,
                                          mode=mode)

            def library(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b,
                        prev_w=prev_w, prev_b=prev_b, alpha=alpha, u8=u8):
                feat = stage_library(x, w1, b1, w2, b2)
                rgb = F.conv2d(feat.to(bf), rgb_w.to(bf)[:, :, None, None], rgb_b.to(bf)).float()
                prev = F.interpolate(F.conv2d(x.to(bf), prev_w.to(bf)[:, :, None, None],
                                              prev_b.to(bf)).float(),
                                     scale_factor=2.0, mode="nearest")
                out = (prev + alpha * (rgb - prev)).permute(0, 2, 3, 1)
                return pro_gan.to_uint8(out) if u8 else out.contiguous()

            got, pair = fused(), two_kernels()
            again = fused()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two runs on one input differ")
            n_diff = int((got != pair).sum().item()) if u8 else differing_bits(got, pair)
            want = pk.packed_upconv_conv_rgb_plain(*args, emit_uint8=u8, mode=mode)
            if u8:
                if got.dtype != torch.uint8 or tuple(got.shape) != (bsz, 2 * h, 2 * h, 3):
                    raise AssertionError(f"{label} returned {got.dtype} {tuple(got.shape)}")
                worst, share, psnr = uint8_agreement(got.cpu().numpy(), want.cpu().numpy())
                print(f"  {label} uint8 vs twin: max |diff| {worst}, differing bytes "
                      f"{share:.6%}, PSNR {psnr:.2f} dB")
                if share > UINT8_MAX_FLIP_SHARE or psnr < FUSED_BF16_PSNR_DB:
                    raise AssertionError(f"{label}: uint8 vs twin beyond {UINT8_MAX_FLIP_SHARE:.2%}"
                                         f" of bytes or below {FUSED_BF16_PSNR_DB} dB")
                err = float(worst)
            else:
                err = check_rel(label, got, want, flips=True)
            print(f"  {label}: max err vs twin {err:.3g}, values differing from the bf16 "
                  f"pair {n_diff}")
            if n_diff:
                raise AssertionError(f"{label}: not bit-equal to the bf16 pair")
            del got, pair, again, want
            pixels = bsz * 4 * h * h
            conv1_counted[label] = counted(fused, pixels)
            calls.append({
                "call": call, "shape_in": [bsz, c, h, h], "emit_uint8": u8, "alpha": alpha,
                "max_abs_err": err, "differing_vs_pair": n_diff, "bit_equal_runs": True,
                "conv1_per_output": conv1_counted[label],
                "ms": cuda_ms(fused), "pair_ms": cuda_ms(two_kernels),
                "plain_ms": cuda_ms(lambda args=args, u8=u8: pk.packed_upconv_conv_rgb_plain(
                    *args, emit_uint8=u8, mode=mode)),
                "library_ms": cuda_ms(library),
                # conv1, conv2 and both toRGBs, each pass
                "flops": passes * (2 * 4 * c * cout * pixels + 2 * 9 * cout * cout * pixels
                                   + 2 * cout * 3 * pixels + 2 * c * 3 * bsz * h * h),
                "bytes": 4 * (bsz * c * h * h + 2 * cout + 3 * cout + 3 * c + 6)
                + 2 * (16 * c * cout + 9 * cout * cout) + pixels * 3 * (1 if u8 else 4),
                "peak_flops": PEAK_BF16_FLOPS,
            })
            del args, x, fused, two_kernels, library
        rows.append((f"packed_upconv_conv_rgb[{mode}]", "packed_upconv_conv_rgb_bf16",
                     "probgan_tpu/ops/pallas_packed.py:1058", calls))
    entries = assemble_conv_rows(rows, B)
    for e in entries:
        for k in e["calls"]:
            print(f"  {e['name']}[{k['call']}]: {k['ms']:.3f} ms against the bf16 pair's "
                  f"{k['pair_ms']:.3f} ms ({k['ms'] / k['pair_ms']:.2f}x), "
                  f"{k['roofline_share']:.0%} of the bound")
    print("  conv1 pixels a conv2 output, counted by the kernels: "
          + ", ".join(f"{k} {v:.4f}" for k, v in conv1_counted.items()))
    return entries


def phase_fused_bf16_path(pk, pro_gan, engine_mod, cli_infer, image_checkpoint_mod,
                          make_image_checkpoint, train_mod, tree_mod) -> tuple[dict, dict]:
    """Under PROBGAN_STAGE_FUSED=1 at the bf16 grades: ``generate`` (batch 8,
    1024²) at "fast", None, G's "mid" and "default+mid" beside the two-kernel
    engine, ``latent_walk`` at "fast", the CLI's ``generate_images --precision
    fast`` and the train step's fake render at packed_train_mode "default"."""
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    latents = [first.sample_latents(BATCH_MAIN) for _ in range(FUSED_BF16_CALLS)]
    high = first.generate(latents[0])
    pair_kernels = [f"{k}{suffix}" for k in UNFUSED_KERNELS for suffix in ("", "_bf16", "_mid")]
    path, counts = {"batch": BATCH_MAIN, "calls": FUSED_BF16_CALLS}, {}
    saved = pro_gan._PACKED_MODES["fast"]
    try:
        for label, grade, mode in (("fast", "fast", "default"), ("None", None, "default"),
                                   ("fast mid", "fast", "mid"),
                                   ("fast default+mid", "fast", "default+mid")):
            pro_gan._PACKED_MODES["fast"] = mode if grade == "fast" else saved
            engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                               d_params=first.d_params, device="cuda",
                                               precision=grade)
            runs = {}
            for flag in ("1", "0"):
                with env(PROBGAN_STAGE_FUSED=flag):
                    engine.generate(latents[0])  # warm-up
                    torch.cuda.synchronize()
                    pk.reset_launches()
                    times, images = [], []
                    for z in latents:
                        t0 = time.perf_counter()
                        images.append(engine.generate(z))
                        times.append(time.perf_counter() - t0)
                    runs[flag] = (times, images, dict(pk.launches))
            want = {k: 0 for k in pk.launches}
            want.update({k: n * FUSED_BF16_CALLS for k, n in FUSED_BF16_PER_CALL[mode].items()})
            if runs["1"][2] != want:
                raise AssertionError(f"generate at {label} under PROBGAN_STAGE_FUSED=1 launched "
                                     f"{runs['1'][2]}, expected {want}")
            if not all(np.array_equal(a, b) for a, b in zip(runs["1"][1], runs["0"][1])):
                raise AssertionError(f"generate at {label}: the stage-fused images are not the "
                                     "two-kernel ones")
            _, share, psnr = uint8_agreement(runs["1"][1][0], high)
            if grade == "fast" and psnr < PSNR_FLOOR_DB:
                raise AssertionError(f"generate at {label}: PSNR {psnr:.2f} dB < "
                                     f"{PSNR_FLOOR_DB} dB against \"high\"")
            if label in ("fast", "fast mid"):
                counts.update({k.replace("_bf16", "[default]").replace("_mid", "[mid]"): v
                               for k, v in runs["1"][2].items() if v})
            entry = {"psnr_vs_high_db": finite_or_none(psnr), "differing_bytes_vs_high": share,
                     "launches": {k: v for k, v in runs["1"][2].items() if v},
                     "images_equal_two_kernel": True}
            for flag, name in (("1", "stage_fused"), ("0", "two_kernel")):
                times = runs[flag][0]
                per_img = sorted(t / BATCH_MAIN * 1e3 for t in times)
                entry[name] = {"img_per_s": BATCH_MAIN * len(times) / sum(times),
                               "p50_ms_per_img": float(np.median(per_img)), "batch_s": times}
            path[f"generate {label}"] = entry
            print(f"  generate at {label}: stage-fused {entry['stage_fused']['img_per_s']:.3f} "
                  f"img/s (p50 {entry['stage_fused']['p50_ms_per_img']:.3f} ms/img), two-kernel "
                  f"{entry['two_kernel']['img_per_s']:.3f} img/s (p50 "
                  f"{entry['two_kernel']['p50_ms_per_img']:.3f}); images equal; PSNR "
                  f"{psnr:.2f} dB vs \"high\"; launches {entry['launches']}")
            del engine, runs
    finally:
        pro_gan._PACKED_MODES["fast"] = saved

    # -- latent_walk at "fast": frames equal with and without the variable
    engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params, d_params=first.d_params,
                                       device="cuda", precision="fast")
    z0, z1 = latents[0][0], latents[0][1]
    walks = {}
    for flag in ("1", "0"):
        with env(PROBGAN_STAGE_FUSED=flag):
            pk.reset_launches()
            t0 = time.perf_counter()
            walks[flag] = engine.latent_walk(z0, z1, frames=FUSED_BF16_WALK_FRAMES)
            walks[flag + "s"] = time.perf_counter() - t0
            walks[flag + "launches"] = dict(pk.launches)
    chunks = -(-FUSED_BF16_WALK_FRAMES // engine_mod.WALK_CHUNK)
    if (walks["1launches"]["packed_upconv_conv_rgb_bf16"] != chunks
            or any(walks["1launches"][k] for k in pair_kernels)
            or not np.array_equal(walks["1"], walks["0"])):
        raise AssertionError(f"latent_walk at \"fast\" under the variable: launches "
                             f"{walks['1launches']}, frames equal to the two-kernel walk: "
                             f"{np.array_equal(walks['1'], walks['0'])}")
    path["latent_walk fast"] = {"frames": FUSED_BF16_WALK_FRAMES, "frames_equal": True,
                                "frames_per_s_stage_fused": FUSED_BF16_WALK_FRAMES / walks["1s"],
                                "frames_per_s_two_kernel": FUSED_BF16_WALK_FRAMES / walks["0s"]}
    print(f"  latent_walk at \"fast\", {FUSED_BF16_WALK_FRAMES} frames: equal with and "
          f"without the variable ({FUSED_BF16_WALK_FRAMES / walks['1s']:.2f} / "
          f"{FUSED_BF16_WALK_FRAMES / walks['0s']:.2f} frames/s)")
    del engine, walks, first

    # -- the CLI's generate_images at --precision fast, from a seeded checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "image_checkpoint.msgpack")
        image_checkpoint_mod.save_image_checkpoint(ckpt, cfg,
                                                   **make_image_checkpoint(cfg, seed=1, ema=True))
        served = {}
        for flag in ("1", "0"):
            with env(PROBGAN_STAGE_FUSED=flag):
                pk.reset_launches()
                served[flag] = checksum_of_generate_images(cli_infer, ckpt, 2, "--precision",
                                                           "fast")
                served[flag + "launches"] = dict(pk.launches)
    if (served["1"]["checksum"] != served["0"]["checksum"]
            or served["1launches"]["packed_upconv_conv_rgb_bf16"] < 1
            or any(served["1launches"][k] for k in pair_kernels)):
        raise AssertionError(f"generate_images --precision fast: {served}")
    path["cli_generate_images_fast"] = {"checksum": served["1"]["checksum"],
                                        "checksum_equal_unfused": True}
    print(f"  --task generate_images --precision fast: checksum {served['1']['checksum']} with "
          "and without the variable")

    # -- the train step's fake render at packed_train_mode "default"
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(81)
    real = torch.tanh(torch.randn((TRAIN_BATCH, cfg.resolution, cfg.resolution, 3),
                                  device="cuda", generator=gen))
    zs = [torch.randn((TRAIN_BATCH, cfg.latent_dim), device="cuda", generator=gen)
          for _ in range(FUSED_TRAIN_STEPS)]
    kw = dict(packed_fake=True, packed_d=True, packed_train_mode="default")
    steps = {}
    for flag in ("1", "0"):
        # cuDNN's deterministic algorithms: the two runs differ only in the
        # fake render's kernels
        with env(PROBGAN_STAGE_FUSED=flag), deterministic_cudnn():
            s = state
            pk.reset_launches()
            metrics = []
            for z in zs:
                s, m = train_mod.progan_train_step(s, real, z, 0.5, cfg, TRAIN_STAGE, **kw)
                metrics.append({k: float(v) for k, v in m.items()})
            steps[flag] = (s, metrics, dict(pk.launches), dict(pk.epilogue_launches))
    launched, epi = steps["1"][2], steps["1"][3]
    n = FUSED_TRAIN_STEPS
    if (launched["packed_upconv_conv_bf16"] != n or launched["packed_upconv_conv_rgb_bf16"] != n
            or launched["packed_upconv_bf16"] or launched["packed_conv_rgb_bf16"]
            or epi["packed_conv_bf16[lrelu_norm]"]
            or any(launched[k] for k in ("packed_upconv_conv", "packed_upconv_conv_rgb",
                                         "packed_upconv_conv_mid", "packed_upconv_conv_rgb_mid"))):
        raise AssertionError(f"the train step's fake render under the variable launched "
                             f"{launched}, {epi}")
    if steps["1"][1] != steps["0"][1]:
        raise AssertionError(f"train step losses: {steps['1'][1]} vs {steps['0'][1]}")
    leaves = tree_mod.tree_leaves
    for field in ("g_params", "d_params", "g_opt", "d_opt", "g_ema"):
        a, b = leaves(getattr(steps["1"][0], field)), leaves(getattr(steps["0"][0], field))
        if len(a) != len(b) or not all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
                                       for u, v in zip(a, b)):
            raise AssertionError(f"train state {field} after {n} steps differs with the variable")
    path["train_step_default"] = {
        "steps": n, "metrics": steps["1"][1], "state_equal_unfused": True,
        "launches": {k: v for k, v in launched.items() if v}}
    print(f"  progan_train_step at \"default\" with packed_fake and packed_d, {n} steps: "
          f"losses and state equal with and without the variable, launches "
          f"{path['train_step_default']['launches']}")
    return counts, path


# Phase 16: the narrow generator N (fmap_base 2048, fmap_max 256 at 1024²,
# the trainer CLIs' flags; nf 256, 256, 256, 256, 128, 64, 32, 16, 8), whose
# packed stages 6-8 take the kernels at 16 and 8 channels: B1 32 -> 16 and
# 16 -> 8 (with the toRGB of its 16-channel input), B2 "lrelu_norm" 16 -> 16,
# B3 8 -> 8 in G (16 -> 16 at 512² where G ends at stage 7); B2 "lrelu" 8 -> 8
# and 16 -> 16, B5 8 -> 16 and 16 -> 32 in D. The kernels alone at N's
# batch-8 shapes against their twins at each kernel mode, to the bounds
# phases 2-4 (fp32), 12 ("default") and 13 ("mid") hold the same kernel to;
# then generate, latent_walk and score at N.
NARROW_CONFIG = {"resolution": 1024, "latent_dim": 128, "fmap_base": 2048, "fmap_max": 256}
NARROW_CALLS = 3  # timed generate and score calls a grade
NARROW_MODES = ("high", "default", "mid")
# (kernel, epilogue or emit, C, Cout, H): B1's H is its input's
NARROW_CASES = (
    ("packed_upconv", "lrelu_norm", 32, 16, 256), ("packed_upconv", "lrelu_norm+rgb", 16, 8, 512),
    ("packed_upconv", "lrelu", 32, 16, 256), ("packed_upconv", "lrelu", 16, 8, 512),
    ("packed_conv", "lrelu_norm", 16, 16, 512), ("packed_conv", "lrelu_norm", 8, 8, 1024),
    ("packed_conv", "lrelu", 8, 8, 1024), ("packed_conv", "lrelu", 16, 16, 512),
    ("packed_conv_rgb", "uint8", 8, 8, 1024), ("packed_conv_rgb", "fp32", 8, 8, 1024),
    ("packed_conv_rgb", "uint8", 16, 16, 512), ("packed_conv_rgb", "fp32", 16, 16, 512),
    ("packed_convpool", "lrelu", 8, 16, 1024), ("packed_convpool", "lrelu", 16, 32, 512),
)
NARROW_SOURCES = {"packed_upconv": "probgan_tpu/ops/pallas_packed.py:832",
                  "packed_conv": "probgan_tpu/ops/pallas_packed.py:382",
                  "packed_conv_rgb": "probgan_tpu/ops/pallas_packed.py:678",
                  "packed_convpool": "probgan_tpu/ops/pallas_packed.py:452"}
# generate's and score's launches a call at N at a slab below 32 channels
# (ops/packed.py narrow_launches), by the kernels' counter
NARROW_GENERATE = {"packed_upconv[cout16]": 1, "packed_upconv[cout8]": 1,
                   "packed_conv[cout16]": 1, "packed_conv_rgb[cout8]": 1}
NARROW_SCORE = {"packed_conv[cout8]": 1, "packed_conv[cout16]": 1,
                "packed_convpool[cout16]": 1}
# all of generate's and score's packed launches a call at N (stages 6-8)
NARROW_GENERATE_ALL = {"packed_upconv": 3, "packed_conv": 2, "packed_conv_rgb": 1}
NARROW_SCORE_ALL = {"packed_conv": 3, "packed_convpool": 3}


def _counter(kernel: str, mode: str) -> str:
    return kernel + {"high": "", "default": "_bf16", "mid": "_mid"}[mode]


def _narrow(counts: dict, mode: str) -> dict:
    """NARROW_GENERATE / NARROW_SCORE at ``mode``'s counters."""
    out = {}
    for key, n in counts.items():
        kernel, slab = key.split("[")
        out[f"{_counter(kernel, mode)}[{slab}"] = n
    return out


def phase_narrow_kernels(pk, pro_gan, cases=NARROW_CASES, batches=(BATCH_MAIN,),
                         seed: int = 1515, tag: str = "narrow", witness_couts=(16,),
                         iters: int = 10, pixel_rel: dict | None = None
                         ) -> tuple[list[dict], dict]:
    """B1, B2, B3 and B5 at 16 and 8 channels (and C 8 and 16) at N's batch-8
    shapes, at "high" (the fp32 kernels), "default" and "mid", against their
    twins: fp32 to atol = rtol = 1e-4 and uint8 +-1 on 0.5% of bytes
    (phases 2-4), "default" and "mid" to GRADE_REL of the largest entry (B3's
    fp32 RGB at "default" on all but GRADE_FLIP_SHARE of values; uint8 on
    0.5% / MID_UINT8_FLIP_SHARE of bytes +-1; phases 12 and 13; B3's uint8
    16 -> 16 at "default" +-2 on 0.5% of bytes, each byte more than 1 off
    witnessed as a bf16 rounding flip, b3_flip_witness); two runs
    bit-equal; packed_conv "lrelu" pooled in B5's order equal to B5 bit for
    bit. Timed beside the bound and F.conv2d with the torch epilogue (fp32,
    TF32 off; bf16 tensors at "default"; the bf16-rounded weights at "mid").
    Phase 22 runs the same checks on its own ``cases`` at ``batches``, its
    entries named "<counter>[<tag>]", the witness at every Cout in
    ``witness_couts``, each time the mean of ``iters`` calls, and with
    ``pixel_rel`` ({mode: rel}) holds the fp32 PixelNorm outputs (B1's and
    B2's features, B3's fp32 RGB) by check_pixelnorm instead."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    bf = torch.bfloat16

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def epi(t, epilogue):
        t = t.float()
        if epilogue == "lrelu_norm":
            return pro_gan.pixel_norm(pro_gan.lrelu(t))
        return pro_gan.lrelu(t)

    def lib_operands(mode, *ts):
        """The library call's operands: fp32, bf16 tensors ("default"), or
        the weights (the last) rounded to bf16 ("mid")."""
        if mode == "default":
            return [t.to(bf) for t in ts]
        if mode == "mid":
            return [*ts[:-1], pk._bf16(ts[-1])]
        return list(ts)

    def check(label, mode, got, want, uint8=False, b3=False, flip_args=None, pre=None,
              spread=1.0):
        if pre is not None and not uint8:
            return check_pixelnorm(label, got, want, pre, pixel_rel[mode], spread,
                                   flips=b3 and mode == "default", nhwc=b3), {}
        if uint8 and flip_args is not None:
            # B3's features are rounded to bf16 for toRGB; where one sits on a
            # rounding boundary the twin rounds it the other way (the fp32
            # RGB's flips below), moving its pixel by rgb_w x one bf16 step:
            # 2 levels at most, each such byte witnessed as a flip
            worst, share, psnr = uint8_agreement(got.cpu().numpy(), want.cpu().numpy())
            print(f"  {label}: max |diff| {worst}, differing bytes {share:.6%}, "
                  f"PSNR {psnr:.2f} dB")
            if worst > 2 or share > UINT8_MAX_FLIP_SHARE:
                raise AssertionError(f"{label}: uint8 outputs disagree beyond +-2 on "
                                     f"{UINT8_MAX_FLIP_SHARE:.2%} of bytes")
            return float(worst), {"psnr_db": finite_or_none(psnr),
                                  "flips_2_levels": b3_flip_witness(pk, pro_gan, label, got,
                                                                    want, *flip_args)}
        if uint8:
            share = MID_UINT8_FLIP_SHARE if mode == "mid" else UINT8_MAX_FLIP_SHARE
            worst, _, psnr = check_uint8(label, got.cpu().numpy(), want.cpu().numpy(), share)
            return float(worst), {"psnr_db": finite_or_none(psnr)}
        if mode == "high":
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
            return (got - want).abs().max().item(), {}
        return check_rel(label, got, want, flips=b3 and mode == "default"), {}

    rows, pool_equal = {}, {}
    for mode, (kernel, form, c, cout, h), B in (
            (m, case, b) for m in NARROW_MODES for case in cases for b in batches):
        peak = PEAK_FP32_FLOPS if mode == "high" else PEAK_BF16_FLOPS
        passes = MID_PASSES if mode == "mid" else 1
        wbytes = 4 if mode == "high" else 2  # a weight as the kernel reads it
        at = "" if len(batches) == 1 else f" b{B}"
        label = f"{kernel}[{mode},{form},{c}->{cout}@{h}{at}]"
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        if kernel == "packed_upconv":
            kw = {"epilogue": form.split("+")[0], "mode": mode}
            if form.endswith("+rgb"):
                kw.update(rgb_w=conv_w(3, c, 1, 1.0).reshape(3, c), rgb_b=bias(3))

            def fn(x=x, w=w, b=b, kw=kw):
                return pk.packed_upconv(x, w, b, **kw)

            def plain(x=x, w=w, b=b, kw=kw):
                return pk.packed_upconv_plain(x, w, b, **kw)

            def library(x=x, w=w, b=b, kw=kw, mode=mode):
                xl, bl, wl = lib_operands(mode, x, b, w)
                y = epi(F.conv2d(F.interpolate(xl, scale_factor=2.0, mode="nearest"), wl,
                                 bl, padding=1), kw["epilogue"])
                if "rgb_w" in kw:
                    xr, br, wr = lib_operands(mode, x, kw["rgb_b"], kw["rgb_w"])
                    return y, F.conv2d(xr, wr[:, :, None, None], br)
                return y

            rgb = "rgb_w" in kw
            flops = 2 * 4 * c * cout * B * 4 * h * h + (2 * c * 3 * B * h * h if rgb else 0)
            nbytes = (4 * (B * c * h * h + B * cout * 4 * h * h + cout
                           + ((3 * c + 3 + B * 3 * h * h) if rgb else 0))
                      + wbytes * (9 if mode == "high" else 16) * c * cout)
        elif kernel == "packed_conv_rgb":
            u8 = form == "uint8"
            alpha = 1.0 if u8 else 0.3
            rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
            prev = 0.5 * torch.randn((B, 3, h // 2, h // 2), device=dev, generator=gen)
            args = (x, w, b, rgb_w, rgb_b, prev)

            def fn(args=args, alpha=alpha, u8=u8, mode=mode):
                return pk.packed_conv_rgb(*args, alpha, emit_uint8=u8, mode=mode)

            def plain(args=args, alpha=alpha, u8=u8, mode=mode):
                return pk.packed_conv_rgb_plain(*args, alpha, emit_uint8=u8, mode=mode)

            def library(args=args, alpha=alpha, u8=u8, mode=mode):
                x, w, b, rgb_w, rgb_b, prev = args
                xl, bl, wl = lib_operands(mode, x, b, w)
                feat = epi(F.conv2d(xl, wl, bl, padding=1), "lrelu_norm")
                fl, rbl, rwl = lib_operands(mode, feat, rgb_b, rgb_w)
                rgb = F.conv2d(fl, rwl[:, :, None, None], rbl).float()
                up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
                out = (up + alpha * (rgb - up)).permute(0, 2, 3, 1)
                return pro_gan.to_uint8(out) if u8 else out.contiguous()

            flops = 2 * 9 * c * cout * B * h * h + 2 * cout * 3 * B * h * h
            nbytes = (4 * (B * c * h * h + cout + 3 * cout + 3 + B * 3 * (h // 2) ** 2)
                      + wbytes * 9 * c * cout + B * h * h * 3 * (1 if u8 else 4))
        else:
            pool = kernel == "packed_convpool"
            kfn, pfn = getattr(pk, kernel), getattr(pk, f"{kernel}_plain")

            def fn(x=x, w=w, b=b, kfn=kfn, form=form, mode=mode):
                return kfn(x, w, b, form, mode=mode)

            def plain(x=x, w=w, b=b, pfn=pfn, form=form, mode=mode):
                return pfn(x, w, b, form, mode=mode)

            def library(x=x, w=w, b=b, form=form, pool=pool, mode=mode):
                xl, bl, wl = lib_operands(mode, x, b, w)
                y = epi(F.conv2d(xl, wl, bl, padding=1), form)
                return F.avg_pool2d(y, 2) if pool else y

            flops = 2 * 9 * c * cout * B * h * h
            nbytes = (4 * (B * c * h * h + B * cout * h * h // (4 if pool else 1) + cout)
                      + wbytes * 9 * c * cout)
        got = fn()
        again = fn()
        if got.dtype == torch.uint8 if torch.is_tensor(got) else False:
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{label}: two runs on one input differ")
        else:
            check_two_runs(label, got, again)
        del again
        want = plain()
        got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err, extra = 0.0, {}
        pre, spread = None, 1.0
        if pixel_rel is not None and kernel != "packed_convpool":
            # the twin's pre-norm sums, for check_pixelnorm
            pre = (pk.packed_upconv_plain(x, w, b, epilogue="lrelu", mode=mode)
                   if kernel == "packed_upconv" else pk.packed_conv_plain(x, w, b, "lrelu", mode))
            if kernel == "packed_conv_rgb":
                spread = args[3].abs().sum(dim=1).max().item()
        for i, (g, t) in enumerate(zip(got_t, want_t)):
            e, more = check(label, mode, g, t, uint8=g.dtype == torch.uint8,
                            b3=kernel == "packed_conv_rgb",
                            flip_args=(args, alpha) if (kernel, mode) == (
                                "packed_conv_rgb", "default") and cout in witness_couts
                            else None, pre=pre if i == 0 else None, spread=spread)
            err, extra = max(err, e), {**extra, **more}
        del pre
        if kernel == "packed_convpool":
            n = differing_bits(pool_in_b5_order(pk.packed_conv(x, w, b, "lrelu", mode=mode)),
                               got)
            pool_equal[label] = n
            print(f"  {label}: packed_conv 'lrelu' pooled in B5's order, {n} values differ")
            if n:
                raise AssertionError(f"{label}: packed_conv 'lrelu' pooled is not "
                                     "packed_convpool 'lrelu' bit for bit")
        entry = f"{_counter(kernel, mode)}[{tag}]"
        source = kernel + ("" if mode == "high" else "_bf16")
        rows.setdefault(entry, (source, NARROW_SOURCES[kernel], []))[2].append({
            "call": f"{form} {c}->{cout}@{h}{at}", "shape_in": [B, c, h, h],
            "max_abs_err": err, "bit_equal_runs": True, **extra,
            "ms": cuda_ms(fn, iters), "plain_ms": cuda_ms(plain, iters),
            "library_ms": cuda_ms(library, iters),
            "flops": flops, "op_flops": passes * flops, "bytes": nbytes, "peak_flops": peak,
        })
        del x, got, want, got_t, want_t
        torch.cuda.empty_cache()
    entries = assemble_conv_rows([(name, src, rep, calls)
                                  for name, (src, rep, calls) in rows.items()], batches[-1])
    return entries, {"conv_lrelu_pooled_differing_values": pool_equal}


def phase_narrow_refusals(pk) -> dict:
    """What the card still refuses at N's widths, each a ValueError that
    names the Cout and ROADMAP.md B.a.2.4, before any launch: Cout 4 in the
    stage-fused B10 and Cout 24 in B11. "none" at slabs of 16 and 8 and the
    packed train step at N run: phase 17; B10 at 16 channels, refused before
    B.a.2.2, launches now (phase 18 holds its bits); B1 "lrelu_norm" at Cout
    4 and the PixelNorm B2 and B3 at Cout 24, refused before B.a.2.3, launch
    now (phase 22 holds them); Cout 4 in B2 "lrelu" and "none", B5 and B1
    "lrelu", refused before the training half of B.a.2.4, launch now (phase
    23 holds them)."""
    dev = "cuda"
    x16 = torch.randn((1, 16, 32, 32), device=dev)
    x8 = torch.randn((1, 8, 16, 32), device=dev)
    w24 = torch.randn((24, 16, 3, 3), device=dev)
    b = {n: torch.zeros(n, device=dev) for n in (4, 16, 24)}
    cases = {
        "packed_upconv_conv Cout 4": (
            lambda: pk.packed_upconv_conv(x8, torch.randn((4, 8, 3, 3), device=dev), b[4],
                                          torch.randn((4, 4, 3, 3), device=dev), b[4]),
            "Cout=4"),
        "packed_upconv_conv_rgb Cout 24": (
            lambda: pk.packed_upconv_conv_rgb(
                x16, w24, b[24], torch.randn((24, 24, 3, 3), device=dev), b[24],
                torch.zeros((3, 24), device=dev), torch.zeros(3, device=dev),
                torch.zeros((3, 16), device=dev), torch.zeros(3, device=dev), 1.0), "Cout=24"),
    }
    out = {}
    pk.reset_launches()
    for label, (call, needle) in cases.items():
        try:
            call()
        except ValueError as e:
            if needle not in str(e) or "ROADMAP.md, B.a.2.4" not in str(e):
                raise AssertionError(f"{label}: raised {e!r} without {needle!r} and "
                                     "ROADMAP.md, B.a.2.4") from e
            out[label] = str(e)
            print(f"  {label}: ValueError: {e}")
        else:
            raise AssertionError(f"{label}: the card took it")
    if any(pk.launches.values()):
        raise AssertionError(f"a refused call launched {dict(pk.launches)}")
    y = pk.packed_upconv_conv(x8, torch.randn((16, 8, 3, 3), device=dev), b[16],
                              torch.randn((16, 16, 3, 3), device=dev), b[16])
    torch.cuda.synchronize()
    if (pk.launches["packed_upconv_conv"] != 1 or tuple(y.shape) != (1, 16, 32, 64)
            or not torch.isfinite(y).all()):
        raise AssertionError(f"packed_upconv_conv at Cout 16: {dict(pk.launches)}, "
                             f"{tuple(y.shape)}")
    out["packed_upconv_conv Cout 16 launches"] = dict(pk.narrow_launches)
    print(f"  packed_upconv_conv Cout 16 (refused before B.a.2.2): launched, "
          f"{dict(pk.narrow_launches)}")
    pk.reset_launches()
    return out


def phase_narrow_path(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    """generate at N, batch 8, at "high", "fast", None and G's "mid"
    (``_PACKED_MODES["fast"]`` patched inside, as phase 13): the packed
    launches a call (NARROW_GENERATE_ALL, NARROW_GENERATE at the grade's
    counters), img/s and p50; "high" against the unpacked path on the card
    (+-1 on at most 0.5% of bytes, >= 50 dB), the PSNR of each grade
    against "high" (a reading: the 50 dB sweep of the reference covered the
    default widths only). latent_walk of 12 frames at "high": the frames of
    generate on the same latents, bit for bit. score at "high" and "fast":
    its launches a call, logits within LOGIT_TOL of the twins', scores/s and
    p50."""
    cfg = pro_gan.ProGANConfig(**NARROW_CONFIG)
    stage = cfg.num_stages - 1
    if ([cfg.nf(s) for s in range(cfg.num_stages)] != [256, 256, 256, 256, 128, 64, 32, 16, 8]
            or pro_gan.packed_start_stage(cfg, stage) != 6
            or any(pro_gan.packed_d_stage_count(cfg, stage, g) != 3
                   for g in ("high", "fast", "highest"))):
        raise AssertionError("N's widths or packed gates are not stages 6-8")
    first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=15)
    latents = [first.sample_latents(BATCH_MAIN) for _ in range(NARROW_CALLS)]
    path, images, counts = {"config": NARROW_CONFIG, "batch": BATCH_MAIN,
                            "calls": NARROW_CALLS}, {}, {}
    saved = pro_gan._PACKED_MODES["fast"]
    try:
        for label, grade, kmode in (("high", "high", "high"), ("fast", "fast", "default"),
                                    ("None", None, "default"), ("fast mid", "fast", "mid")):
            pro_gan._PACKED_MODES["fast"] = "mid" if label == "fast mid" else saved
            engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                               d_params=first.d_params, device="cuda",
                                               precision=grade)
            engine.generate(latents[0])  # warm-up (cuDNN plans)
            torch.cuda.synchronize()
            pk.reset_launches()
            times = []
            for z in latents:
                t0 = time.perf_counter()
                img = engine.generate(z)
                times.append(time.perf_counter() - t0)
            want = {k: 0 for k in pk.launches}
            want.update({_counter(k, kmode): n * NARROW_CALLS
                         for k, n in NARROW_GENERATE_ALL.items()})
            want_narrow = {k: n * NARROW_CALLS for k, n in _narrow(NARROW_GENERATE, kmode).items()}
            if dict(pk.launches) != want or dict(pk.narrow_launches) != want_narrow:
                raise AssertionError(f"generate at N, {label}: launched {pk.launches}, "
                                     f"{pk.narrow_launches}; expected {want}, {want_narrow}")
            for k, n in pk.narrow_launches.items():
                counts[k] = counts.get(k, 0) + n
            images[label] = img
            _, share, psnr = uint8_agreement(img, images["high"])
            per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
            path[f"generate {label}"] = {
                "img_per_s": BATCH_MAIN * NARROW_CALLS / sum(times),
                "p50_ms_per_img": float(np.median(per_img_ms)), "batch_s": times,
                "psnr_vs_high_db": finite_or_none(psnr), "differing_bytes_vs_high": share,
                "narrow_launches": dict(pk.narrow_launches),
            }
            print(f"  generate at N, {label}: {BATCH_MAIN * NARROW_CALLS / sum(times):.3f} "
                  f"img/s, p50 {float(np.median(per_img_ms)):.3f} ms/img, PSNR {psnr:.2f} dB vs "
                  f"\"high\", narrow launches {dict(pk.narrow_launches)}")
            del engine
    finally:
        pro_gan._PACKED_MODES["fast"] = saved

    # "high" against the unpacked path on the card (the last batch)
    unpacked = engine_mod.generate_fn(first.g_params, latents[-1], 1.0, cfg, stage,
                                      precision="high", packed=False).cpu().numpy()
    worst, share, psnr = check_uint8("generate at N, \"high\" vs unpacked", images["high"],
                                     unpacked)
    if psnr < PSNR_FLOOR_DB:
        raise AssertionError(f"generate at N, \"high\": PSNR {psnr:.2f} dB < {PSNR_FLOOR_DB} dB "
                             "against the unpacked path")
    path["high_vs_unpacked"] = {"max_abs_diff": worst, "differing_bytes": share,
                                "psnr_db": finite_or_none(psnr)}
    path["fast_psnr_vs_high_db"] = path["generate fast"]["psnr_vs_high_db"]
    path["fast_reaches_50_db"] = (path["fast_psnr_vs_high_db"] is None
                                  or path["fast_psnr_vs_high_db"] >= PSNR_FLOOR_DB)

    # latent_walk at "high": 12 frames, two chunks (the second padded)
    z0, z1 = latents[0][0], latents[0][1]
    frames = first.latent_walk(z0, z1, frames=12)
    t = torch.linspace(0.0, 1.0, 12, dtype=z0.dtype, device=z0.device)[:, None]
    z = torch.nn.functional.pad(z0[None, :] * (1.0 - t) + z1[None, :] * t, (0, 0, 0, 4))
    direct = np.concatenate([first.generate(zc) for zc in z.split(8)])[:12]
    if not np.array_equal(frames, direct):
        raise AssertionError("latent_walk at N: frames differ from generate on their latents")
    path["latent_walk_frames_equal_generate"] = True
    print("  latent_walk at N, 12 frames: equal to generate on the same latents, bit for bit")

    # score at "high" and "fast" (D's "mid") on the "high" images
    reals = torch.as_tensor(images["high"], device="cuda").float() / 127.5 - 1.0
    for grade, kmode in (("high", "high"), ("fast", "mid")):
        engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params, d_params=first.d_params,
                                           device="cuda", precision=grade)
        engine.score(reals)  # warm-up
        torch.cuda.synchronize()
        pk.reset_launches()
        times, logits = [], None
        for _ in range(NARROW_CALLS):
            t0 = time.perf_counter()
            logits = engine.score(reals)
            times.append(time.perf_counter() - t0)
        want = {k: 0 for k in pk.launches}
        want.update({_counter(k, kmode): n * NARROW_CALLS for k, n in NARROW_SCORE_ALL.items()})
        want_narrow = {k: n * NARROW_CALLS for k, n in _narrow(NARROW_SCORE, kmode).items()}
        if dict(pk.launches) != want or dict(pk.narrow_launches) != want_narrow:
            raise AssertionError(f"score at N, {grade}: launched {pk.launches}, "
                                 f"{pk.narrow_launches}; expected {want}, {want_narrow}")
        for k, n in pk.narrow_launches.items():
            counts[k] = counts.get(k, 0) + n
        with swap_in_plain_twins(pk, ["packed_conv", "packed_convpool"]):
            twins = engine.score(reals)
        err = check_logits(f"score at N, {grade}, vs the twins", logits, twins)
        per_call_ms = sorted(t * 1e3 for t in times)
        path[f"score {grade}"] = {
            "scores_per_s": BATCH_MAIN * NARROW_CALLS / sum(times),
            "p50_ms_per_call": float(np.median(per_call_ms)), "call_s": times,
            "logits_vs_twins_max_abs_diff": err, "narrow_launches": dict(pk.narrow_launches),
        }
        print(f"  score at N, {grade}: {BATCH_MAIN * NARROW_CALLS / sum(times):.3f} scores/s, "
              f"p50 {float(np.median(per_call_ms)):.3f} ms a call of {BATCH_MAIN}")
        del engine
    del first
    # each entry's launches: its counter's narrow launches in these runs
    entry_counts = {}
    for key, n in counts.items():
        name = key.split("[")[0] + "[narrow]"
        entry_counts[name] = entry_counts.get(name, 0) + n
    return entry_counts, path


# Phase 17: the narrow backward at N. N's training backward at stage 8 runs
# the input gradients ("none") at slabs of 16 and 8: B2 8 -> 8 and 16 -> 8 at
# 1024², 16 -> 16 and 32 -> 16 at 512² (conv_lrelu's, conv_lrelu_norm's and
# convpool_lrelu's), B5 8 -> 16 at 1024² (the stage-8 upconv's); B6 at N's
# twelve weight-gradient convs. Each kernel against its twin at "high",
# "default" and "mid" to the bounds phases 8 (fp32: B2 NONE_REL, B5 1e-4, B6
# WGRAD_REL), 14 ("default": DEFAULT_BWD_REL) and 13 ("mid": GRADE_REL) hold
# at the default widths; then the train step at N and the image trainer's
# --fast at N.
NARROW_BWD_MODES = ("high", "default", "mid")
# (kernel, C, Cout, H) at batch 2; B5 at a slab of 8 (8 -> 8) is on no path
# at N, built and held all the same
NARROW_NONE_CASES = (
    ("packed_conv", 8, 8, 1024), ("packed_conv", 16, 8, 1024),
    ("packed_conv", 16, 16, 512), ("packed_conv", 32, 16, 512),
    ("packed_convpool", 8, 16, 1024), ("packed_convpool", 8, 8, 1024),
)
# N's twelve weight-gradient convs (C, Cout, H): G's (8, 8), (16 upsampled,
# 8) at 1024², (16, 16), (32 up, 16) at 512², (32, 32), (64 up, 32) at 256²;
# D's (8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (32, 64); nine distinct
NARROW_WGRAD_SHAPES = ((8, 8, 1024), (16, 8, 1024), (8, 16, 1024), (16, 16, 512),
                       (32, 16, 512), (16, 32, 512), (32, 32, 256), (64, 32, 256),
                       (32, 64, 256))
# Launches of one progan_train_step at N, stage 8, both packed gates: three
# packed stages a network where the default config has two, so
# STEP_EPILOGUE_LAUNCHES x 3/2 at the step's counters and 18 weight
# gradients; by slab below 32 (narrow_launches): B1 at 16 and 8 (G's two
# forwards and the pre-norm recompute), B2 at 16 (G's stage-7 conv2 3 + its
# input gradient 1, D's stage-7 conv1 3 forwards + 3 input gradients,
# stage-7 convpool's input gradient 3, stage-8 convpool's mask recompute 3)
# and 8 (G's stage-8 conv2 3 + 1, D's stage-8 conv1 3 + 3, stage-8
# convpool's input gradient 3), B5 at 16 (D's stage-8 convpool 3, G's
# stage-8 upconv's input gradient 1)
NARROW_STEP_EPILOGUE = {k: v * 3 // 2 for k, v in STEP_EPILOGUE_LAUNCHES.items()}
NARROW_STEP_WGRAD = 18
NARROW_STEP_NARROW = {"packed_upconv[cout16]": 3, "packed_upconv[cout8]": 3,
                      "packed_conv[cout16]": 16, "packed_conv[cout8]": 13,
                      "packed_convpool[cout16]": 4}
# ... of which "none" (the input gradients), by (kernel, slab)
NARROW_STEP_NONE = {("packed_conv", 8): 7, ("packed_conv", 16): 7, ("packed_convpool", 16): 1}
NARROW_TIMED_STEPS = 3
NARROW_STEP_SUFFIX = {"highest": "", "mid": "_mid", "default": "_bf16"}
# the Functions at N's narrow shapes: (name, C, Cout, H, input PixelNorm'd)
NARROW_FUNCTIONS = (("conv_lrelu", 8, 8, 1024, False), ("convpool_lrelu", 8, 16, 1024, False),
                    ("conv_lrelu_norm", 16, 16, 512, True),
                    ("upconv_lrelu_norm", 16, 8, 512, True))


def phase_narrow_bwd_kernels(pk, packed_vjp, pro_gan) -> tuple[list[dict], dict]:
    """B2 and B5 "none" at slabs of 16 and 8 and B6 at N's shapes (batch 2)
    against their twins at each kernel mode, two runs bit-equal, timed beside
    the bound and the library call (F.conv2d on the flipped, transposed
    weights, with avg_pool2d for B5; fp32 with TF32 off, bf16 tensors at
    "default", the bf16-rounded weights at "mid"; conv2d_weight for B6); the
    four Functions at N's shapes on the kernels against the same Functions on
    the twins at "highest" (GRAD_REL), "mid" and "default" (DEFAULT_FN_REL,
    dx with DEFAULT_FN_FLIP_SHARE: a mask the two sums set apart moves a
    weight gradient summed over 2 million pixels by ~1e-3 of its largest
    entry)."""
    gen = torch.Generator(device="cuda").manual_seed(1717)
    dev, bf, B = "cuda", torch.bfloat16, TRAIN_BATCH

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def conv_w(cout, cin):
        return randn(cout, cin, 3, 3) * math.sqrt(2.0 / (9 * cin))

    rows = {}
    for mode in NARROW_BWD_MODES:
        terms = pk.BF16_TERMS.get(mode, 0)
        for kernel, c, cout, h in NARROW_NONE_CASES:
            pool = kernel == "packed_convpool"
            slab = pk._pool_slab(cout)
            label = f"{kernel}[{mode},none,{c}->{cout}@{h}]"
            x, w, b = randn(B, c, h, h), conv_w(cout, c), torch.zeros(cout, device=dev)
            kfn, pfn = getattr(pk, kernel), getattr(pk, f"{kernel}_plain")

            def fn(x=x, w=w, b=b, kfn=kfn, mode=mode):
                return kfn(x, w, b, "none", mode=mode)

            def plain(x=x, w=w, b=b, pfn=pfn, mode=mode):
                return pfn(x, w, b, "none", mode=mode)

            def library(x=x, w=w, pool=pool, mode=mode):
                xl, wl = ((x.to(bf), w.to(bf)) if mode == "default"
                          else (x, pk._bf16(w)) if mode == "mid" else (x, w))
                y = F.conv2d(xl, wl, padding=1).float()
                return F.avg_pool2d(y, 2) if pool else y

            got = fn()
            check_two_runs(label, got, fn())
            want = plain()
            if mode != "high":
                err = check_rel(label, got, want,
                                rel=DEFAULT_BWD_REL if mode == "default" else GRADE_REL)
            elif pool:
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
                err = (got - want).abs().max().item()
            else:
                err = scaled_err(label, got, want, NONE_REL)
            flops = 2 * 9 * c * cout * B * h * h
            nbytes = (4 * (B * c * h * h + B * cout * h * h // (4 if pool else 1))
                      + (4 if mode == "high" else 2) * 9 * c * cout)
            if mode == "high":  # 3xTF32 (B2) or fp32 FMAs (B5)
                peak, op_flops = (PEAK_FP32_FLOPS, flops) if pool else (PEAK_TF32_FLOPS,
                                                                         3 * flops)
            else:
                peak, op_flops = PEAK_BF16_FLOPS, terms * flops
            entry = f"{_counter(kernel, mode)}[none,{f'cout{slab}' if pool else 'narrow'}]"
            source = kernel + ("" if mode == "high" else "_bf16")
            rows.setdefault(entry, (source, NARROW_SOURCES[kernel], []))[2].append({
                "call": f"C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h], "slab": slab,
                "max_abs_err": err, "max_abs_err_share_of_largest": err / want.abs().max().item(),
                "bit_equal_runs": True, "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain),
                "library_ms": cuda_ms(library), "flops": flops, "op_flops": op_flops,
                "bytes": nbytes, "peak_flops": peak,
            })
            del x, got, want
        torch.cuda.empty_cache()

    for mode in ("high", "default"):
        calls = []
        for c, cout, h in NARROW_WGRAD_SHAPES:
            label = f"packed_conv_wgrad[{mode},{c}->{cout}@{h}]"
            x, g = pro_gan.lrelu(randn(B, c, h, h)), 0.01 * randn(B, cout, h, h)
            got = pk.packed_conv_wgrad(x, g, mode=mode)
            again = pk.packed_conv_wgrad(x, g, mode=mode)
            torch.cuda.synchronize()
            if tuple(got.shape) != (cout, c, 3, 3) or differing_bits(got, again):
                raise AssertionError(f"{label}: wrong shape, or two runs differ")
            want = pk.packed_conv_wgrad_plain(x, g, mode=mode)
            err = check_rel(label, got, want, rel=WGRAD_REL)

            def library(x=x, g=g, c=c, cout=cout, mode=mode):
                if mode == "default":
                    x, g = x.to(bf), g.to(bf)
                return torch.nn.grad.conv2d_weight(x, (cout, c, 3, 3), g, padding=1)

            flops = 2 * 9 * c * cout * B * h * h
            calls.append({
                "call": f"C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h], "max_abs_err": err,
                "max_abs_err_share_of_largest": err / want.abs().max().item(),
                "bit_equal_runs": True,
                "ms": cuda_ms(lambda x=x, g=g, mode=mode: pk.packed_conv_wgrad(x, g, mode=mode)),
                "plain_ms": cuda_ms(lambda x=x, g=g, mode=mode:
                                    pk.packed_conv_wgrad_plain(x, g, mode=mode), iters=3,
                                    warmup=1),
                "library_ms": cuda_ms(library), "flops": flops,
                "op_flops": 3 * flops if mode == "high" else flops,
                "bytes": 4 * (B * h * h * (c + cout) + 9 * c * cout),
                "peak_flops": PEAK_TF32_FLOPS if mode == "high" else PEAK_BF16_FLOPS,
            })
            del x, g, got, again, want
        name = "packed_conv_wgrad" + ("_bf16" if mode == "default" else "")
        rows[f"{name}[narrow]"] = (name, "probgan_tpu/ops/pallas_packed.py:558", calls)

    # the four Functions at N's narrow shapes, forward and backward, on the
    # kernels against the same Functions on the twins
    def vjp(fn, x, w, b, cot, mode):
        x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(x, w, b, mode=mode)
        return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))

    fn_errs = {}
    for mode in ("highest", "mid", "default"):
        for name, c, cout, h, norm_in in NARROW_FUNCTIONS:
            x = randn(B, c, h, h)
            x = pro_gan.pixel_norm(x) if norm_in else pro_gan.lrelu(x)
            w, b = conv_w(cout, c), 0.1 * randn(cout)
            fn = getattr(packed_vjp, name)
            with torch.no_grad():
                cot = torch.randn(fn(x, w, b, mode=mode).shape, device=dev, generator=gen)
            pk.reset_launches()
            got = vjp(fn, x, w, b, cot, mode)
            launched = {k: v for k, v in pk.narrow_launches.items() if v}
            with swap_in_plain_twins(pk, PACKED_KERNELS):
                want = vjp(fn, x, w, b, cot, mode)
            # at the bf16 grades the kernel and the twin sum each
            # pre-activation in other orders, so a LeakyReLU mask can differ
            # where one lies that close to zero: phase 14's bounds
            rel = GRAD_REL if mode == "highest" else DEFAULT_FN_REL
            flips = int(((got[0] >= 0) != (want[0] >= 0)).sum().item())
            fn_errs[f"{name}[{mode}]"] = errs = [
                check_rel(f"packed_vjp.{name}[{mode}] {part} vs the twins", g, t,
                          flips=part == "dx", rel=rel, flip_share=DEFAULT_FN_FLIP_SHARE,
                          flip_rel=DEFAULT_FN_FLIP_REL)
                for part, g, t in zip(("y", "dx", "dw", "db"), got, want)]
            print(f"  packed_vjp.{name}[{mode}] C{c}->Cout{cout}@{h} vs the same Function on "
                  f"the twins: y {errs[0]:.3g}  dx {errs[1]:.3g}  dw {errs[2]:.3g}  db "
                  f"{errs[3]:.3g} of the largest entry; output signs differing {flips}; "
                  f"narrow launches {launched}")
            del x, cot, got, want
    pk.reset_launches()
    entries = assemble_conv_rows([(name, src, rep, calls)
                                  for name, (src, rep, calls) in rows.items()], B)
    return entries, {"functions_vs_twins_y_dx_dw_db": fn_errs}


@contextlib.contextmanager
def narrow_none_spy(pk, seen: dict):
    """Inside, packed_conv's and packed_convpool's "none" calls at a slab
    below 32 are counted in ``seen`` by (kernel, slab)."""
    real = {name: getattr(pk, name) for name in ("packed_conv", "packed_convpool")}

    def spy_of(name):
        def spy(x, w, b, *args, **kwargs):
            epilogue = kwargs.get("epilogue", args[0] if args else None)
            slab = pk._pool_slab(w.shape[0])
            if epilogue == "none" and slab < 32:
                seen[(name, slab)] = seen.get((name, slab), 0) + 1
            return real[name](x, w, b, *args, **kwargs)
        return spy

    try:
        for name in real:
            setattr(pk, name, spy_of(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(pk, name, fn)


def narrow_step_launches(pk, mode: str, steps: int = 1) -> tuple[dict, dict]:
    """``steps`` N train steps' launches at packed_train_mode ``mode``: the
    counters with their epilogues, and narrow_launches."""
    sfx = NARROW_STEP_SUFFIX[mode]
    want = {k: 0 for k in (*pk.launches, *pk.epilogue_launches)}
    for key, n in NARROW_STEP_EPILOGUE.items():
        kernel, epilogue = key.split("[")
        want[kernel + sfx] += n * steps
        want[f"{kernel}{sfx}[{epilogue}"] = n * steps
    want["packed_conv_wgrad_bf16" if mode == "default" else "packed_conv_wgrad"] = (
        NARROW_STEP_WGRAD * steps)
    narrow = {}
    for key, n in NARROW_STEP_NARROW.items():
        kernel, slab = key.split("[")
        narrow[f"{kernel}{sfx}[{slab}"] = n * steps
    return want, narrow


def check_step_launches(pk, label: str, mode: str, steps: int = 1) -> None:
    want, narrow = narrow_step_launches(pk, mode, steps)
    got = {**pk.launches, **pk.epilogue_launches}
    if got != want or {k: v for k, v in pk.narrow_launches.items() if v} != narrow:
        raise AssertionError(f"{label}: launched {got}, narrow {dict(pk.narrow_launches)}; "
                             f"expected {want}, narrow {narrow}")


def phase_narrow_train(pk, pro_gan, train_mod, train_state_mod, tree_mod) -> tuple[dict, dict]:
    """progan_train_step at N, 1024², stage 8, batch 2, packed_d, packed_g,
    remat, at packed_train_mode "highest", "mid" and "default" and at dtype
    bf16 (the --fast math): the launches a step (NARROW_STEP_*: "none" at 16
    and 8 counted, no launch at another mode); the raw gradients on the
    kernels against the plain twins to the bounds of phases 9 ("highest"),
    13 ("mid") and 14 ("default"); timed steps (steps/s, p50, peak memory);
    "highest" after the bf16 steps bit-equal to the first; the train state
    saved, loaded back bit-equal and the resumed next step within phase 9's
    bound."""
    tree_leaves = tree_mod.tree_leaves
    cfg = pro_gan.ProGANConfig(**NARROW_CONFIG)
    stage, B, alpha = TRAIN_STAGE, TRAIN_BATCH, 0.5
    kw = dict(packed_d=True, packed_g=True, remat=True)
    if (pro_gan.packed_start_stage(cfg, stage) != 6
            or pro_gan.packed_d_stage_count(cfg, stage, "highest") != 3):
        raise AssertionError("N's packed training stages are not 6-8")
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1718)
    real = torch.tanh(torch.randn((B, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((B, cfg.latent_dim), device="cuda", generator=gen)
    out = {"config": NARROW_CONFIG, "batch": B, "stage": stage, "remat": True, "alpha": alpha,
           "launches_per_step": {m: [{k: v for k, v in counts.items() if v}
                                     for counts in narrow_step_launches(pk, m)]
                                 for m in NARROW_STEP_SUFFIX}}

    # -- the gradients on the kernels against the plain twins, each mode
    vs_twins, first_high = {}, None
    for mode in ("highest", "mid", "default"):
        pk.reset_launches()
        with deterministic_cudnn():
            d_k, g_k, m_k = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                   packed_train_mode=mode, **kw)
        check_step_launches(pk, f"progan_grads at N, {mode}", mode)
        if mode == "highest":
            first_high = (d_k, g_k)
        with swap_in_plain_twins(pk, PACKED_KERNELS):
            d_t, g_t, m_t = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                   packed_train_mode=mode, **kw)
        if mode == "default":
            check_metrics("step at N, \"default\", vs the plain twins", m_k, m_t, STEP_LOSS_RTOL,
                          DEFAULT_LOGIT_ATOL)
            rec = {"d": vector_agreement(d_k, d_t, tree_leaves),
                   "g": vector_agreement(g_k, g_t, tree_leaves)}
            for net, v in rec.items():
                if not (v["l2"] <= DEFAULT_GRAD_L2 and v["cos"] >= DEFAULT_GRAD_COS):
                    raise AssertionError(f"{net} gradients at N, \"default\", vs the twins: {v} "
                                         f"(bounds L2 {DEFAULT_GRAD_L2}, cos {DEFAULT_GRAD_COS})")
            text = (f"relative L2 {rec['d']['l2']:.3g} / {rec['g']['l2']:.3g}, cos "
                    f"{rec['d']['cos']:.6f} / {rec['g']['cos']:.6f}")
        else:
            check_metrics(f"step at N, {mode}, vs the plain twins", m_k, m_t, STEP_LOSS_RTOL)
            rec = {"d": tree_rel_errs(f"D gradients at N, {mode}, vs the twins", d_k, d_t,
                                      tree_leaves, STEP_GRAD_REL),
                   "g": tree_rel_errs(f"G gradients at N, {mode}, vs the twins", g_k, g_t,
                                      tree_leaves, STEP_GRAD_REL)}
            text = f"worst leaf {rec['d']:.3g} / {rec['g']:.3g} of its largest entry"
        rec["metrics"] = {k: float(v) for k, v in m_k.items()}
        vs_twins[mode] = rec
        print(f"  progan_grads at N, {mode}: D / G gradients vs the plain twins {text}; "
              f"losses within rtol {STEP_LOSS_RTOL:g}; launches and narrow launches as "
              "expected")
        del d_t, g_t, d_k, g_k
    out["vs_twins"] = vs_twins
    torch.cuda.empty_cache()

    # -- timed steps at each grade, "none" at 16 and 8 counted by slab
    counts, runs, st_high = {}, {}, None
    for label, mode, dtype in (("highest", "highest", torch.float32),
                               ("mid", "mid", torch.float32),
                               ("default", "default", torch.float32),
                               ("default bf16", "default", torch.bfloat16)):
        st, _ = train_mod.progan_train_step(state, real, z, alpha, cfg, stage, dtype=dtype,
                                            packed_train_mode=mode, **kw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pk.reset_launches()
        none_seen, times, losses = {}, [], []
        with narrow_none_spy(pk, none_seen):
            for i in range(NARROW_TIMED_STEPS):
                t0 = time.perf_counter()
                st, m = train_mod.progan_train_step(st, real, z, 0.5 if i % 2 == 0 else 1.0, cfg,
                                                    stage, dtype=dtype, packed_train_mode=mode,
                                                    **kw)
                losses.append({k: float(v) for k, v in m.items()})  # reads the card
                times.append(time.perf_counter() - t0)
        check_step_launches(pk, f"the train steps at N, {label}", mode, NARROW_TIMED_STEPS)
        if none_seen != {k: n * NARROW_TIMED_STEPS for k, n in NARROW_STEP_NONE.items()}:
            raise AssertionError(f"\"none\" at slabs below 32 at N, {label}: {none_seen}")
        if not all(math.isfinite(v) for m in losses for v in m.values()):
            raise AssertionError(f"a train step at N, {label}, is not finite: {losses}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step_ms = sorted(t * 1e3 for t in times)
        runs[label] = {"steps_per_s": NARROW_TIMED_STEPS / sum(times), "step_s": times,
                       "p50_ms_per_step": float(np.median(per_step_ms)), "losses": losses,
                       "peak_memory_gb": peak_gb,
                       "none_launches_by_slab": {f"{k}[cout{s}]": n
                                                 for (k, s), n in none_seen.items()}}
        sfx = NARROW_STEP_SUFFIX[mode]
        if dtype == torch.float32:
            for kernel, slab in ((k, s) for k, s in NARROW_STEP_NONE):
                tag = "narrow" if kernel == "packed_conv" else f"cout{slab}"
                name = f"{kernel}{sfx}[none,{tag}]"
                counts[name] = counts.get(name, 0) + none_seen[(kernel, slab)]
            wgrad = "packed_conv_wgrad_bf16" if mode == "default" else "packed_conv_wgrad"
            if mode != "mid":
                counts[f"{wgrad}[narrow]"] = pk.launches[wgrad]
            if mode == "default":  # B5 "default" at 16 channels (phase 16's entry)
                counts["packed_convpool_bf16[narrow]"] = pk.narrow_launches[
                    "packed_convpool_bf16[cout16]"]
        print(f"  progan_train_step at N, {label}: {NARROW_TIMED_STEPS / sum(times):.3f} steps/s, "
              f"p50 {float(np.median(per_step_ms)):.1f} ms, peak {peak_gb:.2f} GB; \"none\" at "
              f"16/8 a step {NARROW_STEP_NONE}, narrow launches "
              f"{ {k: v for k, v in pk.narrow_launches.items() if v} }")
        if label == "highest":
            st_high = st
        else:
            del st
        torch.cuda.empty_cache()
    out["runs"] = runs

    with deterministic_cudnn():
        again = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                       packed_train_mode="highest", **kw)
    if any(not torch.equal(a, b) for a, b in zip(tree_leaves(again[:2]),
                                                 tree_leaves(first_high))):
        raise AssertionError("\"highest\" at N after the bf16 steps is not the first "
                             "\"highest\", bit for bit")
    out["highest_after_bf16_bit_equal"] = True
    print("  \"highest\" at N after \"mid\", \"default\" and bf16: bit-equal to the first")
    del again, first_high

    # -- the train state: save, load, the next step against the uninterrupted run
    def step(stt):
        return train_mod.progan_train_step(stt, real, z, 1.0, cfg, stage,
                                           packed_train_mode="highest", **kw)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_state.msgpack")
        train_state_mod.save_train_state(path, st_high, {"step": NARROW_TIMED_STEPS + 1})
        size_mb = os.path.getsize(path) / 1e6
        template = train_mod.progan_init_state(1, cfg, device="cuda")
        resumed, meta = train_state_mod.load_train_state(path, template)
    if meta != {"step": NARROW_TIMED_STEPS + 1} or not all(
            torch.equal(a, b) and a.device == b.device
            for a, b in zip(tree_leaves(resumed), tree_leaves(st_high))):
        raise AssertionError("the train state at N did not come back bit for bit")
    with deterministic_cudnn():
        next_a, m_a = step(st_high)
        next_b, m_b = step(resumed)
    check_metrics("the resumed step at N vs the uninterrupted one", m_b, m_a, 1e-6)
    resume_diff = max((a - b).abs().max().item()
                      for a, b in zip(tree_leaves(next_b), tree_leaves(next_a)))
    if resume_diff > 0.6e-3:
        raise AssertionError(f"the resumed run at N differs by {resume_diff:.3g}")
    out.update({"train_state_mb": size_mb, "resume_max_abs_diff": resume_diff})
    print(f"  train state at N: {size_mb:.1f} MB written and read back bit-equal; the resumed "
          f"next step differs by {resume_diff:.3g} at most (0 = bit-equal)")
    del template, resumed, next_a, next_b, st_high, state
    return counts, out


def phase_narrow_cli(pk, cli_train, image_checkpoint_mod, tree_mod) -> dict:
    """The image trainer CLI with --fast at N (--fmap_base 2048 --fmap_max
    256) on phase 11's schedule (TRAINER_EPOCHS a stage: stage 8 needs a
    second epoch to save mid-stage): stages 0-7 at --resolution 512 in
    process; --resume --grow to 1024² in a child killed after its mid-stage
    save; --resume to the end in process. Stages 6-8 on the bf16 kernels and
    no other packed kernel, "none" at 16 and 8 among them; finite losses; the
    checkpoint loads in the port at N. Seconds per stage from metrics.jsonl."""
    common = ["--synthetic", str(TRAINER_IMAGES), "--batch_size", str(TRAINER_BATCH),
              "--epochs_per_stage", str(TRAINER_EPOCHS), "--device", "cuda", "--fast",
              "--fmap_base", str(NARROW_CONFIG["fmap_base"]),
              "--fmap_max", str(NARROW_CONFIG["fmap_max"])]
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "narrow")

        def in_process(leg, args, expect):
            pk.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_train.main(["--model", "image", *common, *args, "--output_dir", out_dir])
            if rc != 0 or expect not in out.getvalue():
                raise AssertionError(f"image trainer --fast at N ({leg}) exited {rc}, lacks "
                                     f"{expect!r}:\n{out.getvalue()}")
            legs[leg] = {"s": time.perf_counter() - t0, "launches": dict(pk.launches),
                         "narrow_launches": {k: v for k, v in pk.narrow_launches.items() if v},
                         "none_launches": {k: v for k, v in pk.epilogue_launches.items()
                                           if v and "[none]" in k}}

        in_process("stages 0-7", ["--resolution", "512", "--checkpoint_minutes", "0"],
                   "Stage 7 (512²)")
        torch.cuda.empty_cache()  # room for the child on the card
        child_s = run_until_mid_stage_save(
            ["--model", "image", *common, "--resolution", "1024", "--resume", "--grow",
             "--checkpoint_minutes", "1e-9", "--verbose", "--output_dir", out_dir])
        in_process("stage 8", ["--resolution", "1024", "--resume"],
                   f"Resumed mid-stage 8 (next: epoch 2/{TRAINER_EPOCHS})")
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        cfg, g_params, d_params = image_checkpoint_mod.load_image_checkpoint(
            os.path.join(out_dir, "image_checkpoint.msgpack"))
    for leg, rec in legs.items():
        launched = rec["launches"]
        if any(launched[k] < 1 for k in BF16_TRAIN_KERNELS) or any(
                n for k, n in launched.items() if k not in BF16_TRAIN_KERNELS):
            raise AssertionError(f"--fast at N ({leg}) launched {launched}: expected the bf16 "
                                 "training kernels and no other packed kernel")
    late = legs["stage 8"]
    if not (late["narrow_launches"].get("packed_conv_bf16[cout8]", 0) >= 1
            and late["narrow_launches"].get("packed_convpool_bf16[cout16]", 0) >= 1
            and late["none_launches"].get("packed_conv_bf16[none]", 0) >= 1):
        raise AssertionError(f"--fast at N, stage 8: narrow launches {late}")
    if [(m["stage"], m["epoch"]) for m in metrics] != [
            (s, e) for s in range(9) for e in range(1, TRAINER_EPOCHS + 1)]:
        raise AssertionError(f"--fast at N, metrics.jsonl: {metrics}")
    if any(not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"])) for m in metrics):
        raise AssertionError(f"--fast at N: losses not finite: {metrics}")
    if (cfg.resolution, cfg.fmap_base, cfg.fmap_max) != (1024, 2048, 256) or not d_params or not all(
            torch.isfinite(t).all() for t in tree_mod.tree_leaves(g_params)):
        raise AssertionError("--fast at N wrote a checkpoint the port does not load as trained")
    stage_s = {}
    for m in metrics:
        stage_s[m["stage"]] = stage_s.get(m["stage"], 0.0) + m["seconds"]
    print(f"  image trainer CLI --fast at N ({TRAINER_IMAGES} images, batch {TRAINER_BATCH}, "
          f"{TRAINER_EPOCHS} epochs a stage; stages 0-7 at 512², a child killed after its "
          f"mid-stage save at stage 8, --resume): seconds per stage "
          f"{', '.join(f'{k}: {v:.4f}' for k, v in stage_s.items())}; legs "
          f"{ {k: round(v['s'], 1) for k, v in legs.items()} } s, child {child_s:.1f} s; "
          f"stage 8 launches {late['launches']}, narrow {late['narrow_launches']}; the "
          "checkpoint loads at N")
    return {"images": TRAINER_IMAGES, "batch": TRAINER_BATCH, "epochs_per_stage": TRAINER_EPOCHS,
            "seconds_per_stage": stage_s, "leg_s": {k: v["s"] for k, v in legs.items()},
            "child_s_to_mid_stage_save": child_s, "legs": legs,
            "losses": [(m["d_loss"], m["g_loss"]) for m in metrics]}


# Phase 18: the stage-fused kernels at N. Under PROBGAN_STAGE_FUSED=1 N's
# packed stages 6-8 run B10 at 32 channels (64 -> 32), B10 at 16 (32 -> 16)
# and B11 at 8 (16 -> 8); latent_walk at stage 7 ends on B11 at 16. Each
# narrow instantiation against the two-kernel pair at its mode (0 values
# differing), its twin (phase 10's and 15's bounds) and itself (two runs),
# timed beside the pair, the bound and F.conv2d chains; then N's entry
# points with the variable at 1 and at 0.
NARROW_FUSED_MODES = ("high", "default", "mid")
# (kernel, C, Cout, input H, batch, emit_uint8): B10 32 -> 16 at 256² and B11
# 16 -> 8 at 512² (N's stages 7 and 8) at batch 2 and 8, B11 fp32 out at
# batch 2; B11 32 -> 16 (latent_walk at stage 7) and B10 16 -> 8 (on no path
# at N: its stage 8 is always the final one) at batch 8
NARROW_FUSED_CASES = (
    ("packed_upconv_conv", 32, 16, 256, 2, None), ("packed_upconv_conv", 32, 16, 256, 8, None),
    ("packed_upconv_conv_rgb", 16, 8, 512, 2, True),
    ("packed_upconv_conv_rgb", 16, 8, 512, 2, False),
    ("packed_upconv_conv_rgb", 16, 8, 512, 8, True),
    ("packed_upconv_conv_rgb", 32, 16, 256, 8, True), ("packed_upconv_conv", 16, 8, 512, 8, None),
)
FUSED_SOURCES = {"packed_upconv_conv": "probgan_tpu/ops/pallas_packed.py:973",
                 "packed_upconv_conv_rgb": "probgan_tpu/ops/pallas_packed.py:1058"}
# one generate call's launches at N under the variable, by G's packed mode:
# every packed stage fused, no kernel of the pair
NARROW_FUSED_PER_CALL = {
    "high": {"packed_upconv_conv": 2, "packed_upconv_conv_rgb": 1},
    "default": {"packed_upconv_conv_bf16": 2, "packed_upconv_conv_rgb_bf16": 1},
    "mid": {"packed_upconv_conv_mid": 2, "packed_upconv_conv_rgb_mid": 1},
    "default+mid": {"packed_upconv_conv_bf16": 2, "packed_upconv_conv_rgb_mid": 1},
}
NARROW_FUSED_WALK_FRAMES = 12  # two chunks, the second padded
NARROW_FUSED_TRAIN_STEPS = 2


def phase_narrow_fused_kernels(pk, pro_gan) -> tuple[list[dict], dict]:
    """B10 and B11 at 16 and 8 channels (NARROW_FUSED_CASES) at "high",
    "default" and "mid": 0 values differing from the pair at the mode (B1
    then B2 "lrelu_norm", or B1 with toRGB then B3), two runs bit-equal, the
    twin within FUSED_ATOL ("high"; uint8 +-1 on 0.5% of bytes) or phase
    15's bounds (bf16 modes); timed beside the pair, the bound and F.conv2d
    chains (fp32 with TF32 off; bf16 tensors at "default"; the weights
    rounded to bf16 at "mid", as phase 16 times them)."""
    gen = torch.Generator(device="cuda").manual_seed(1717)
    dev = "cuda"
    bf = torch.bfloat16

    def feats(*shape):
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lib(mode, *ts):
        """The library call's operands: fp32, bf16 tensors ("default"), or
        the weights (the last) rounded to bf16 ("mid")."""
        if mode == "default":
            return [t.to(bf) for t in ts]
        if mode == "mid":
            return [*ts[:-1], pk._bf16(ts[-1])]
        return list(ts)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t.float()))

    def conv(mode, x, w, b, padding=1):
        xl, bl, wl = lib(mode, x, b, w)
        return F.conv2d(xl, wl, bl, padding=padding)

    def stage_library(mode, x, w1, b1, w2, b2):
        up = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return lrelu_norm(conv(mode, lrelu_norm(conv(mode, up, w1, b1)), w2, b2))

    rows, printed = {}, []
    for mode in NARROW_FUSED_MODES:
        terms = pk.BF16_TERMS.get(mode, 0)
        passes, peak = max(terms, 1), PEAK_BF16_FLOPS if terms else PEAK_FP32_FLOPS
        wbytes = 2 if terms else 4  # a weight as the kernel reads it
        for kernel, c, cout, h, bsz, u8 in NARROW_FUSED_CASES:
            rgb = u8 is not None
            form = "" if not rgb else (",uint8" if u8 else ",fp32")
            label = f"{_counter(kernel, mode)}[{c}->{cout}@{h},b{bsz}{form}]"
            x, w1, b1, w2, b2 = (feats(bsz, c, h, h), conv_w(cout, c), bias(cout),
                                 conv_w(cout, cout), bias(cout))
            if rgb:
                alpha = 1.0 if u8 else 0.3
                rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
                prev_w, prev_b = conv_w(3, c, 1, 1.0).reshape(3, c), bias(3)
                args = (x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha)

                def fused(args=args, u8=u8, mode=mode):
                    return pk.packed_upconv_conv_rgb(*args, emit_uint8=u8, mode=mode)

                def plain(args=args, u8=u8, mode=mode):
                    return pk.packed_upconv_conv_rgb_plain(*args, emit_uint8=u8, mode=mode)

                def pair(args=args, u8=u8, mode=mode):
                    x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha = args
                    f, rp = pk.packed_upconv(x, w1, b1, rgb_w=prev_w, rgb_b=prev_b, mode=mode)
                    return pk.packed_conv_rgb(f, w2, b2, rgb_w, rgb_b, rp, alpha, emit_uint8=u8,
                                              mode=mode)

                def library(args=args, u8=u8, mode=mode):
                    x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha = args
                    feat = stage_library(mode, x, w1, b1, w2, b2)
                    out_rgb = conv(mode, feat, rgb_w[:, :, None, None], rgb_b, 0).float()
                    prev = F.interpolate(conv(mode, x, prev_w[:, :, None, None], prev_b,
                                              0).float(), scale_factor=2.0, mode="nearest")
                    out = (prev + alpha * (out_rgb - prev)).permute(0, 2, 3, 1)
                    return pro_gan.to_uint8(out) if u8 else out.contiguous()
            else:
                args = (x, w1, b1, w2, b2)

                def fused(args=args, mode=mode):
                    return pk.packed_upconv_conv(*args, mode=mode)

                def plain(args=args, mode=mode):
                    return pk.packed_upconv_conv_plain(*args, mode=mode)

                def pair(args=args, mode=mode):
                    x, w1, b1, w2, b2 = args
                    return pk.packed_conv(pk.packed_upconv(x, w1, b1, mode=mode), w2, b2,
                                          mode=mode)

                def library(args=args, mode=mode):
                    return stage_library(mode, *args)

            got, again, two = fused(), fused(), pair()
            torch.cuda.synchronize()
            if got.dtype == torch.uint8:
                runs = int((got != again).sum().item())
                n_diff = int((got != two).sum().item())
            else:
                runs, n_diff = differing_bits(got, again), differing_bits(got, two)
            if runs:
                raise AssertionError(f"{label}: two runs on one input differ")
            want = plain()
            extra = {}
            if got.dtype == torch.uint8:
                worst, share, psnr = uint8_agreement(got.cpu().numpy(), want.cpu().numpy())
                print(f"  {label} uint8 vs twin: max |diff| {worst}, differing bytes "
                      f"{share:.6%}, PSNR {psnr:.2f} dB")
                if terms:
                    if share > UINT8_MAX_FLIP_SHARE or psnr < FUSED_BF16_PSNR_DB:
                        raise AssertionError(f"{label}: uint8 vs twin beyond "
                                             f"{UINT8_MAX_FLIP_SHARE:.2%} of bytes or below "
                                             f"{FUSED_BF16_PSNR_DB} dB")
                elif worst > 1 or share > UINT8_MAX_FLIP_SHARE:
                    raise AssertionError(f"{label}: uint8 vs twin beyond +-1 on "
                                         f"{UINT8_MAX_FLIP_SHARE:.2%} of bytes")
                err, extra = float(worst), {"psnr_db": finite_or_none(psnr)}
            elif terms:
                err = check_rel(label, got, want, flips=True)
            else:
                err = (got - want).abs().max().item()
                if err > FUSED_ATOL:
                    raise AssertionError(f"{label}: {err:.3g} off its twin")
            print(f"  {label}: max err vs twin {err:.3g}, values differing from the pair "
                  f"{n_diff}, two runs bit-equal")
            if n_diff:
                raise AssertionError(f"{label}: not bit-equal to the pair at its mode")
            del got, again, two, want
            pixels = bsz * 4 * h * h
            flops = 2 * 4 * c * cout * pixels + 2 * 9 * cout * cout * pixels
            nbytes = 4 * (bsz * c * h * h + 2 * cout) + wbytes * (16 * c * cout + 9 * cout * cout)
            if rgb:  # both toRGBs; the RGB out
                flops += 2 * cout * 3 * pixels + 2 * c * 3 * bsz * h * h
                nbytes += 4 * (3 * cout + 3 * c + 6) + pixels * 3 * (1 if u8 else 4)
            else:
                nbytes += 4 * cout * pixels
            call = {"call": f"{c}->{cout}@{h} b{bsz}{form.replace(',', ' ')}",
                    "shape_in": [bsz, c, h, h], "max_abs_err": err, "differing_vs_pair": n_diff,
                    "bit_equal_runs": True, **extra,
                    "ms": cuda_ms(fused), "pair_ms": cuda_ms(pair), "plain_ms": cuda_ms(plain),
                    "library_ms": cuda_ms(library), "flops": flops, "op_flops": passes * flops,
                    "bytes": nbytes, "peak_flops": peak}
            name = f"{_counter(kernel, mode)}[cout{cout}]"
            source = kernel + ("_bf16" if terms else "")
            rows.setdefault(name, (source, FUSED_SOURCES[kernel], []))[2].append(call)
            printed.append((name, call))
            del x, args, fused, plain, pair, library
        torch.cuda.empty_cache()
    entries = assemble_conv_rows([(name, src, rep, calls)
                                  for name, (src, rep, calls) in rows.items()], BATCH_MAIN)
    for name, k in printed:
        print(f"  {name}[{k['call']}]: {k['ms']:.3f} ms against the pair's {k['pair_ms']:.3f} ms "
              f"({k['ms'] / k['pair_ms']:.2f}x), {k['roofline_share']:.0%} of the bound "
              f"({k['bound_ms']:.3f} ms, {k['bound_by']})")
    return entries, {"cases": len(printed)}


def phase_narrow_fused_path(pk, pro_gan, engine_mod, cli_infer, cli_train,
                            image_checkpoint_mod, make_image_checkpoint, train_mod,
                            tree_mod) -> tuple[dict, dict]:
    """N's entry points with PROBGAN_STAGE_FUSED at 1 and at 0: generate
    (batch 8) at "high", "fast", None, G's "mid" and "default+mid", images
    equal, every packed stage on B10/B11 (NARROW_FUSED_PER_CALL, no kernel
    of the pair), img/s; latent_walk at stage 7 at "high", "fast" and G's
    "mid" (B11 at 16), frames equal; the CLI's generate_images --precision
    fast, checksums equal; progan_train_step at N (stage 8, batch 2, remat)
    at "default" and "highest" with both packed gates (G's differentiable
    packed path renders the fake batch and supersedes packed_fake: the
    variable launches nothing) and with packed_fake and packed_d (the fake
    batch on B10/B11), losses and state bit-equal; the image trainer's
    --fast at N, one epoch a stage, seconds per stage with the variable at 1
    and at 0."""
    cfg = pro_gan.ProGANConfig(**NARROW_CONFIG)
    stage = cfg.num_stages - 1
    pair_kernels = [f"{k}{sfx}" for k in UNFUSED_KERNELS for sfx in ("", "_bf16", "_mid")]
    first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=18)
    latents = [first.sample_latents(BATCH_MAIN) for _ in range(NARROW_CALLS)]
    path, counts = {"config": NARROW_CONFIG, "batch": BATCH_MAIN, "calls": NARROW_CALLS}, {}

    def add_counts(narrow):
        for k, n in narrow.items():
            counts[k] = counts.get(k, 0) + n

    saved = pro_gan._PACKED_MODES["fast"]
    try:
        for label, grade, mode in (("high", "high", "high"), ("fast", "fast", "default"),
                                   ("None", None, "default"), ("fast mid", "fast", "mid"),
                                   ("fast default+mid", "fast", "default+mid")):
            pro_gan._PACKED_MODES["fast"] = mode if grade == "fast" else saved
            engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                               d_params=first.d_params, device="cuda",
                                               precision=grade)
            runs = {}
            for flag in ("1", "0"):
                with env(PROBGAN_STAGE_FUSED=flag):
                    engine.generate(latents[0])  # warm-up
                    torch.cuda.synchronize()
                    pk.reset_launches()
                    times, images = [], []
                    for z in latents:
                        t0 = time.perf_counter()
                        images.append(engine.generate(z))
                        times.append(time.perf_counter() - t0)
                    runs[flag] = (times, images, dict(pk.launches), dict(pk.narrow_launches))
            want = {k: 0 for k in pk.launches}
            want.update({k: n * NARROW_CALLS for k, n in NARROW_FUSED_PER_CALL[mode].items()})
            b10, b11 = (k for k in NARROW_FUSED_PER_CALL[mode])
            want_narrow = {f"{b10}[cout16]": NARROW_CALLS, f"{b11}[cout8]": NARROW_CALLS}
            if runs["1"][2] != want or runs["1"][3] != want_narrow:
                raise AssertionError(f"generate at N, {label}, under PROBGAN_STAGE_FUSED=1 "
                                     f"launched {runs['1'][2]}, {runs['1'][3]}; expected "
                                     f"{want}, {want_narrow}")
            if not all(np.array_equal(a, b) for a, b in zip(runs["1"][1], runs["0"][1])):
                raise AssertionError(f"generate at N, {label}: the stage-fused images are not "
                                     "the two-kernel ones")
            add_counts(runs["1"][3])
            entry = {"launches": {k: v for k, v in runs["1"][2].items() if v},
                     "narrow_launches": runs["1"][3],
                     "two_kernel_launches": {k: v for k, v in runs["0"][2].items() if v},
                     "images_equal_two_kernel": True}
            for flag, name in (("1", "stage_fused"), ("0", "two_kernel")):
                times = runs[flag][0]
                per_img = sorted(t / BATCH_MAIN * 1e3 for t in times)
                entry[name] = {"img_per_s": BATCH_MAIN * len(times) / sum(times),
                               "p50_ms_per_img": float(np.median(per_img)), "batch_s": times}
            path[f"generate {label}"] = entry
            print(f"  generate at N, {label}: stage-fused {entry['stage_fused']['img_per_s']:.3f} "
                  f"img/s (p50 {entry['stage_fused']['p50_ms_per_img']:.3f} ms/img), two-kernel "
                  f"{entry['two_kernel']['img_per_s']:.3f} img/s (p50 "
                  f"{entry['two_kernel']['p50_ms_per_img']:.3f}); images equal; launches "
                  f"{entry['launches']}, narrow {entry['narrow_launches']}")
            del engine, runs

        # -- latent_walk at stage 7: B11 at 16 channels, one launch a chunk
        z0, z1 = latents[0][0], latents[0][1]
        chunks = -(-NARROW_FUSED_WALK_FRAMES // engine_mod.WALK_CHUNK)
        for label, grade, mode in (("high", "high", "high"), ("fast", "fast", "default"),
                                   ("fast mid", "fast", "mid")):
            pro_gan._PACKED_MODES["fast"] = mode if grade == "fast" else saved
            engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                               d_params=first.d_params, device="cuda",
                                               precision=grade)
            walks = {}
            for flag in ("1", "0"):
                with env(PROBGAN_STAGE_FUSED=flag):
                    engine.latent_walk(z0, z1, frames=4, stage=7)  # warm-up
                    torch.cuda.synchronize()
                    pk.reset_launches()
                    t0 = time.perf_counter()
                    frames = engine.latent_walk(z0, z1, frames=NARROW_FUSED_WALK_FRAMES, stage=7)
                    walks[flag] = (frames, time.perf_counter() - t0, dict(pk.launches),
                                   dict(pk.narrow_launches))
            b10, b11 = (k for k in NARROW_FUSED_PER_CALL[mode])
            want = {k: 0 for k in pk.launches}
            want.update({b10: chunks, b11: chunks})  # stage 6 at 32, stage 7 at 16
            want_narrow = {f"{b11}[cout16]": chunks}
            if (walks["1"][2] != want or walks["1"][3] != want_narrow
                    or walks["1"][0].shape != (NARROW_FUSED_WALK_FRAMES, 512, 512, 3)
                    or not np.array_equal(walks["1"][0], walks["0"][0])):
                raise AssertionError(f"latent_walk at N, stage 7, {label}: launched "
                                     f"{walks['1'][2]}, {walks['1'][3]} (expected {want}, "
                                     f"{want_narrow}); frames equal to the two-kernel walk: "
                                     f"{np.array_equal(walks['1'][0], walks['0'][0])}")
            add_counts(walks["1"][3])
            path[f"latent_walk stage 7 {label}"] = {
                "frames": NARROW_FUSED_WALK_FRAMES, "frames_equal_two_kernel": True,
                "narrow_launches": walks["1"][3],
                "frames_per_s_stage_fused": NARROW_FUSED_WALK_FRAMES / walks["1"][1],
                "frames_per_s_two_kernel": NARROW_FUSED_WALK_FRAMES / walks["0"][1]}
            print(f"  latent_walk at N, stage 7, {label}, {NARROW_FUSED_WALK_FRAMES} frames: "
                  f"equal with and without the variable "
                  f"({NARROW_FUSED_WALK_FRAMES / walks['1'][1]:.2f} / "
                  f"{NARROW_FUSED_WALK_FRAMES / walks['0'][1]:.2f} frames/s), narrow launches "
                  f"{walks['1'][3]}")
            del engine, walks
    finally:
        pro_gan._PACKED_MODES["fast"] = saved
    del first

    # -- the CLI's generate_images at --precision fast, from a seeded N checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "image_checkpoint.msgpack")
        image_checkpoint_mod.save_image_checkpoint(ckpt, cfg,
                                                   **make_image_checkpoint(cfg, seed=2, ema=True))
        served = {}
        for flag in ("1", "0"):
            with env(PROBGAN_STAGE_FUSED=flag):
                pk.reset_launches()
                served[flag] = checksum_of_generate_images(cli_infer, ckpt, 2, "--precision",
                                                           "fast")
                served[flag + "launches"] = dict(pk.launches)
                served[flag + "narrow"] = dict(pk.narrow_launches)
    if (served["1"]["checksum"] != served["0"]["checksum"]
            or served["1launches"]["packed_upconv_conv_bf16"] < 1
            or served["1launches"]["packed_upconv_conv_rgb_bf16"] < 1
            or any(served["1launches"][k] for k in pair_kernels)
            or served["1narrow"].get("packed_upconv_conv_rgb_bf16[cout8]", 0) < 1):
        raise AssertionError(f"generate_images at N --precision fast: {served}")
    path["cli_generate_images_fast"] = {"checksum": served["1"]["checksum"],
                                        "checksum_equal_unfused": True,
                                        "narrow_launches": served["1narrow"]}
    print(f"  --task generate_images at N --precision fast: checksum {served['1']['checksum']} "
          f"with and without the variable; narrow launches {served['1narrow']}")

    # -- progan_train_step at N: both gates, and the fake render on B10/B11
    state = train_mod.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1818)
    real = torch.tanh(torch.randn((TRAIN_BATCH, cfg.resolution, cfg.resolution, 3),
                                  device="cuda", generator=gen))
    zs = [torch.randn((TRAIN_BATCH, cfg.latent_dim), device="cuda", generator=gen)
          for _ in range(NARROW_FUSED_TRAIN_STEPS)]
    leaves = tree_mod.tree_leaves
    n = NARROW_FUSED_TRAIN_STEPS
    train = {}
    for gates, gkw in (("both gates", dict(packed_d=True, packed_g=True)),
                       ("packed_fake, packed_d", dict(packed_d=True))):
        for mode in ("default", "highest"):
            label = f"{gates}, {mode}"
            steps = {}
            for flag in ("1", "0"):
                with env(PROBGAN_STAGE_FUSED=flag), deterministic_cudnn():
                    s = state
                    pk.reset_launches()
                    metrics, times = [], []
                    for z in zs:
                        t0 = time.perf_counter()
                        s, m = train_mod.progan_train_step(
                            s, real, z, 0.5, cfg, TRAIN_STAGE, packed_fake=True, remat=True,
                            packed_train_mode=mode, **gkw)
                        metrics.append({k: float(v) for k, v in m.items()})
                        times.append(time.perf_counter() - t0)
                    steps[flag] = (s, metrics, dict(pk.launches), dict(pk.narrow_launches),
                                   dict(pk.epilogue_launches), times)
            launched, narrow, epi = steps["1"][2], steps["1"][3], steps["1"][4]
            sfx = "_bf16" if mode == "default" else ""
            fused = {f"packed_upconv_conv{sfx}": 2 * n, f"packed_upconv_conv_rgb{sfx}": n}
            if "packed_g" in gkw:  # G's differentiable path renders the fake batch
                ok = (launched == steps["0"][2] and narrow == steps["0"][3]
                      and not any(launched[k] for k in (*fused, *FUSED_KERNELS)))
            else:
                ok = (all(launched[k] == v for k, v in fused.items())
                      and narrow.get(f"packed_upconv_conv{sfx}[cout16]") == n
                      and narrow.get(f"packed_upconv_conv_rgb{sfx}[cout8]") == n
                      and not launched[f"packed_upconv{sfx}"]
                      and not launched[f"packed_conv_rgb{sfx}"]
                      and not epi[f"packed_conv{sfx}[lrelu_norm]"])
                add_counts({k: v for k, v in narrow.items() if "upconv_conv" in k})
            if not ok:
                raise AssertionError(f"progan_train_step at N, {label}, under the variable "
                                     f"launched {launched}, {narrow}, {epi}")
            if steps["1"][1] != steps["0"][1]:
                raise AssertionError(f"train step at N, {label}: losses {steps['1'][1]} vs "
                                     f"{steps['0'][1]}")
            for field in ("g_params", "d_params", "g_opt", "d_opt", "g_ema"):
                a, b = leaves(getattr(steps["1"][0], field)), leaves(getattr(steps["0"][0], field))
                if len(a) != len(b) or not all(torch.equal(torch.as_tensor(u), torch.as_tensor(v))
                                               for u, v in zip(a, b)):
                    raise AssertionError(f"train state {field} at N, {label}, after {n} steps "
                                         "differs with the variable")
            train[label] = {"steps": n, "metrics": steps["1"][1], "state_equal_unfused": True,
                            "launches": {k: v for k, v in launched.items() if v},
                            "narrow_launches": narrow,
                            "step_s": {"stage_fused": steps["1"][5], "two_kernel": steps["0"][5]}}
            print(f"  progan_train_step at N, {label}, {n} steps: losses and state equal with "
                  f"and without the variable; launches {train[label]['launches']}, narrow "
                  f"{narrow}")
            del steps
    path["train_step"] = train
    del state, real
    torch.cuda.empty_cache()

    # -- the image trainer's --fast at N, one epoch a stage, with the variable at 1 and 0
    common = ["--model", "image", "--synthetic", str(TRAINER_IMAGES), "--batch_size",
              str(TRAINER_BATCH), "--epochs_per_stage", "1", "--device", "cuda", "--fast",
              "--resolution", str(NARROW_CONFIG["resolution"]),
              "--fmap_base", str(NARROW_CONFIG["fmap_base"]),
              "--fmap_max", str(NARROW_CONFIG["fmap_max"]), "--checkpoint_minutes", "0"]
    legs = {}
    for flag in ("1", "0"):
        with tempfile.TemporaryDirectory() as tmp, env(PROBGAN_STAGE_FUSED=flag):
            pk.reset_launches()
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_train.main([*common, "--output_dir", tmp])
            wall = time.perf_counter() - t0
            if rc != 0 or "Stage 8 (1024²)" not in out.getvalue():
                raise AssertionError(f"image trainer --fast at N, variable {flag}, exited {rc}:"
                                     f"\n{out.getvalue()}")
            with open(os.path.join(tmp, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
        stage_s = {}
        for m in metrics:
            stage_s[m["stage"]] = stage_s.get(m["stage"], 0.0) + m["seconds"]
        if [m["stage"] for m in metrics] != list(range(9)) or any(
                not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"])) for m in metrics):
            raise AssertionError(f"image trainer --fast at N, variable {flag}: {metrics}")
        legs[flag] = {"s": wall, "seconds_per_stage": stage_s,
                      "launches": {k: v for k, v in pk.launches.items() if v},
                      "losses": [(m["d_loss"], m["g_loss"]) for m in metrics]}
    if legs["1"]["launches"] != legs["0"]["launches"] or any(
            legs["1"]["launches"].get(k) for k in FUSED_KERNELS):
        raise AssertionError(f"--fast at N: launches with the variable {legs['1']['launches']}, "
                             f"without {legs['0']['launches']}")
    path["trainer_cli_fast"] = {"images": TRAINER_IMAGES, "batch": TRAINER_BATCH,
                                "epochs_per_stage": 1, "stage_fused": legs["1"],
                                "two_kernel": legs["0"]}
    for flag, name in (("1", "with"), ("0", "without")):
        print(f"  image trainer CLI --fast at N, 1 epoch a stage, {name} the variable: "
              f"{legs[flag]['s']:.1f} s, seconds per stage "
              f"{', '.join(f'{k}: {v:.4f}' for k, v in legs[flag]['seconds_per_stage'].items())}")
    print(f"  --fast launches the same kernels with and without the variable (G's "
          f"differentiable packed path renders the fake batch): {legs['1']['launches']}")
    return counts, path


_T0 = time.perf_counter()


def phase_local_kernels(rf, rank_ops) -> dict:
    """B4 ``rank_topk_local`` on one shard of the TP path (500,000 x 128) at
    B 8 and 64, k 1, 10, 16 and nvalid 0, 1, k - 1, k and the shard's rows:
    values and ids bit-equal to B7's scores of the same queries (launched
    with ``normalize=False``) masked past nvalid, the stable top k and the
    fillers' ids 0, which is the kernel's contract on its own product; and
    held to the plain twin (``rank_topk_local_plain``, torch.matmul with
    TF32 off, another order of sums): finite values within RANK_ATOL, -inf
    and id 0 at the same places, ids equal but for near-ties. nvalid 0
    launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(2121)
    rows, d = TP_SHARD_ROWS, KG_DIM
    shard = rank_ops.l2_normalize(torch.randn((rows, d), device="cuda", generator=gen))
    calls, launched_below_k = [], 0
    for b in (KG_BATCH, 8):
        q = rank_ops.l2_normalize(torch.randn((b, d), device="cuda", generator=gen))
        scores = torch.empty((b, rows), device="cuda")
        rf.launch_rank_scores(q, shard, scores, normalize=False)
        for kk in (1, KG_TOP_K, 16):
            for nvalid in sorted({0, 1, max(kk - 1, 1), kk, rows}):
                label = f"B{b},k{kk},nvalid{nvalid}"
                before = rf.launches["rank_topk"]
                v, i = rf.rank_topk_local(q, shard, kk, nvalid)
                launched = rf.launches["rank_topk"] - before
                masked = torch.where(torch.arange(rows, device="cuda") < nvalid, scores,
                                     float("-inf"))
                ev, ei = rank_ops.top_k_lowest_index(masked, kk)
                ei[:, nvalid:] = 0
                tv, ti = rf.rank_topk_local_plain(q, shard, kk, nvalid)
                torch.cuda.synchronize()
                if launched != (1 if nvalid else 0):
                    raise AssertionError(f"rank_topk_local[{label}]: {launched} launches")
                if differing_bits(v, ev) or not torch.equal(i, ei):
                    raise AssertionError(f"rank_topk_local[{label}]: not bit-equal to B7's "
                                         "scores masked and the stable top k")
                m = min(kk, nvalid)
                if not (torch.isinf(v[:, m:]).all() and (i[:, m:] == 0).all()
                        and torch.equal(torch.isinf(v), torch.isinf(tv))
                        and torch.equal(ti[:, m:], i[:, m:])):
                    raise AssertionError(f"rank_topk_local[{label}]: fillers differ from "
                                         "-inf with id 0 or from the twin's")
                err = (v[:, :m] - tv[:, :m]).abs().max().item() if m else 0.0
                if err > RANK_ATOL:
                    raise AssertionError(f"rank_topk_local[{label}]: values differ from the "
                                         f"plain twin by {err:.3g}")
                swapped = 0
                for qq, j in (i[:, :m] != ti[:, :m]).nonzero().tolist():
                    swapped += 1
                    if (i[qq, j] not in ti[qq, :m]
                            and v[qq, j].item() - v[qq, m - 1].item() > RANK_ATOL):
                        raise AssertionError(f"rank_topk_local[{label}]: query {qq} place "
                                             f"{j}: id {i[qq, j].item()} is not the twin's")
                launched_below_k += int(0 < nvalid < kk)
                flops = 2.0 * b * nvalid * d
                nbytes = 4.0 * (b * d + nvalid * d) + b * kk * (4 + 8)
                bound_ms, bound_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
                calls.append({
                    "call": label, "shape_in": [b, d], "rows": rows, "nvalid": nvalid,
                    "k": kk, "launches_in_call": launched, "max_abs_err": err,
                    "positions_with_another_id_vs_plain": swapped,
                    "ms": cuda_ms(lambda: rf.rank_topk_local(q, shard, kk, nvalid)),
                    # the launch alone (no merge), and the wrapper's host time
                    "kernel_only_ms": (cuda_ms(lambda: rf.topk_candidates(q, shard, kk, nvalid,
                                                                          False))
                                       if nvalid else None),
                    "host_ms": host_ms(lambda: rf.rank_topk_local(q, shard, kk, nvalid)),
                    "plain_ms": cuda_ms(lambda: rf.rank_topk_local_plain(q, shard, kk, nvalid),
                                        iters=3, warmup=1),
                    "library_ms": (cuda_ms(lambda: torch.topk(
                        torch.matmul(q, shard[:nvalid].T), kk)) if nvalid >= kk else None),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                })
                c = calls[-1]
                alone = (f"{c['kernel_only_ms']:.3f}" if c["kernel_only_ms"] is not None
                         else "none")
                print(f"  rank_topk_local[{label}]: bit-equal to B7 + the stable top k; vs "
                      f"the twin {err:.3g}, {swapped} near-tie swaps; {launched} launch, "
                      f"kernel {c['ms']:.3f} ms (launch alone {alone}, host {c['host_ms']:.3f})"
                      f"  plain {c['plain_ms']:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})")
        del scores
    head = next(c for c in calls if c["call"] == f"B{KG_BATCH},k{KG_TOP_K},nvalid{rows}")
    del shard
    return {
        "name": "rank_topk_local", "route": "cuda", "source": "probgan_tpu_torch/csrc/rank_topk.cu",
        "replaces": "probgan_tpu/ops/pallas_rank.py:398", "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in calls), "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "batch": KG_BATCH, "calls_below_k_launched": launched_below_k, "calls": calls,
    }


def tp_rank(rank: int, world: int, work: str, cases: list) -> None:
    """One rank of the TP phase (a child process on cuda:0): joins the gloo
    group, serves each case's checkpoint with ``InferenceEngine(mesh="auto")``
    and writes what it got and the kernels it launched to ``work``."""
    import datetime

    import torch.distributed as dist

    from probgan_tpu_torch.engine import inference as inference_mod
    from probgan_tpu_torch.ops import rank_fused as rf

    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    out = {}
    for case in cases:
        with contextlib.redirect_stdout(io.StringIO()):
            engine = inference_mod.InferenceEngine(case["path"], device="cuda", seed=0,
                                                   mesh="auto")
        seen = []
        local = rf.rank_topk_local

        def spy(q, shard, k, nvalid, **kwargs):
            seen.append([k, nvalid])
            return local(q, shard, k, nvalid, **kwargs)

        rf.rank_topk_local = spy
        rf.reset_launches()  # the TP path's run: the counts of this case's calls
        results, launches = [], []
        with contextlib.redirect_stdout(io.StringIO()):
            for task, top_k in case["calls"]:
                before = dict(rf.launches)
                if task == "predict_tails":
                    results.append(engine.predict_tails(case["pairs"], top_k=top_k,
                                                        return_scores=True))
                else:
                    results.append(engine.find_similar_entities(case["entities"], top_k=top_k))
                launches.append({name: rf.launches[name] - before[name] for name in before})
        counts = dict(rf.launches)
        rf.rank_topk_local = local
        times, parts = [], {}
        if case.get("timed"):
            from probgan_tpu_torch.parallel import sharded_rank as sr

            # the whole call, then its parts: the sharded rank of a query
            # already on the card, and its broadcast and two gathers alone
            group, dev = engine.mesh.get_group("model"), engine.device
            tp = dist.get_world_size(group)
            q = torch.randn((KG_BATCH, KG_DIM), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
            v = torch.zeros((KG_BATCH, KG_TOP_K), device=dev)
            i = torch.zeros((KG_BATCH, KG_TOP_K), dtype=torch.int64, device=dev)
            steps = {
                "predict_tails": lambda: engine.predict_tails(case["pairs"], top_k=KG_TOP_K,
                                                              return_scores=True),
                "sharded_rank_topk": lambda: sr.sharded_rank_topk(
                    q, engine.entity_norm_sharded, KG_TOP_K, engine.mesh,
                    num_entities=engine.num_entities),
                "broadcast_and_gathers": lambda: (sr._same_query(q, group),
                                                  sr._all_gather(v, group, tp),
                                                  sr._all_gather(i, group, tp)),
            }
            with contextlib.redirect_stdout(io.StringIO()):
                for part, fn in steps.items():
                    parts[part] = []
                    for _ in range(TP_CALLS):
                        dist.barrier()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fn()
                        torch.cuda.synchronize()
                        parts[part].append(time.perf_counter() - t0)
            times = parts.pop("predict_tails")
        out[case["name"]] = {
            "device": engine.get_model_info()["device"], "card": str(engine.device),
            "shard_rows": engine.entity_norm_sharded.shape[0], "results": results,
            "launches_by_call": launches, "counts": counts, "local_calls": seen,
            "call_s": times, "part_s": parts,
        }
        del engine
        torch.cuda.empty_cache()
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(module: str, argv: list[str],
             nproc: int = TP_RANKS) -> tuple[subprocess.CompletedProcess, float]:
    """``python -m torch.distributed.run --nproc-per-node <nproc> -m module``
    with gloo (the ranks share the card), from the repository's root: the run
    and its seconds; a failed run raises."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
         "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), "-m", module,
         *argv], cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=TP_TIMEOUT_S, env={**os.environ, "PROBGAN_DIST_BACKEND": "gloo"})
    if run.returncode != 0:
        raise AssertionError(f"torchrun {module}: exit {run.returncode}\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
    return run, time.perf_counter() - t0


def phase_tp_path(rf, inference_mod, checkpoint_mod, cli_infer,
                  make_kg_checkpoint) -> tuple[dict, dict]:
    """Entity-table TP on one card: two ranks through gloo serve seeded C17
    checkpoints of 1,000,000 and 1,000,003 entities (D 128) and of 9 entities
    with ``InferenceEngine(mesh="auto")``; predict_tails and
    find_similar_entities at top_k 10 (B4 ``rank_topk_local`` a shard) and 20
    (B7 masked), the 9-entity KG at top_k 5 (its last shard at nvalid 4 <
    k 5). Ids equal to the one-process engine's on the card, values within
    1e-6; queries/s of both over TP_CALLS calls and the p50 of two parts of
    the TP call (two ranks share one card: for the record).
    Then the CLI under ``torch.distributed.run --nproc-per-node 2 --mesh
    auto`` against the one-process CLI's JSON, by the same rule."""
    import torch.multiprocessing as mp

    rng = np.random.default_rng(21)
    pairs = [[int(h), int(r)] for h, r in zip(rng.integers(0, KG_ENTITIES, KG_BATCH),
                                              rng.integers(0, KG_RELATIONS, KG_BATCH))]
    entities = [0, 7, 123_456, 499_999, 500_000, 500_001, KG_ENTITIES - 1]
    big_calls = [["predict_tails", KG_TOP_K], ["predict_tails", 20],
                 ["similar_entities", KG_TOP_K], ["similar_entities", 20]]
    quiet = io.StringIO()
    with tempfile.TemporaryDirectory() as work:
        cases = []
        for name, n, rels in (("N1000000", KG_ENTITIES, KG_RELATIONS),
                              ("N1000003", TP_UNEVEN, KG_RELATIONS), ("N9", TP_SMALL, 5)):
            path = os.path.join(work, f"{name}.pt")
            checkpoint_mod.save_checkpoint(path, make_kg_checkpoint(
                n, rels, KG_DIM, KG_NOISE, KG_HIDDEN, seed=0))
            small = n == TP_SMALL
            cases.append({
                "name": name, "path": path, "n": n, "timed": n == KG_ENTITIES,
                "pairs": [[h % n, r % rels] for h, r in pairs],
                "entities": sorted({e % n for e in entities} | ({n - 1} if not small else {8})),
                "calls": ([["predict_tails", 5], ["similar_entities", 5]] if small
                          else big_calls),
            })
        # the one-process engine on the card: the reference, and its queries/s
        want, one_card_s = {}, []
        for case in cases:
            with contextlib.redirect_stdout(quiet):
                engine = inference_mod.InferenceEngine(case["path"], device="cuda", seed=0)
                want[case["name"]] = [
                    engine.predict_tails(case["pairs"], top_k=k, return_scores=True)
                    if task == "predict_tails" else
                    engine.find_similar_entities(case["entities"], top_k=k)
                    for task, k in case["calls"]]
                if case["timed"]:
                    for _ in range(TP_CALLS):
                        t0 = time.perf_counter()
                        engine.predict_tails(case["pairs"], top_k=KG_TOP_K,
                                             return_scores=True)
                        one_card_s.append(time.perf_counter() - t0)
            del engine
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(TP_RANKS, work, cases), nprocs=TP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(TP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))

        counts = {"rank_topk": 0, "rank_scores": 0, "rank_topk_bf16": 0}
        max_err, below_k = 0.0, []
        for case in cases:
            name = case["name"]
            local_n = -(-case["n"] // TP_RANKS)
            for r, got in enumerate(ranks):
                res = got[name]
                if res["device"] != f"mesh(data=1,model={TP_RANKS})" or res["card"] != "cuda:0":
                    raise AssertionError(f"TP[{name}] rank {r}: {res['device']} on {res['card']}")
                if res["shard_rows"] != local_n:
                    raise AssertionError(f"TP[{name}] rank {r}: shard of {res['shard_rows']} rows")
                nvalid = min(max(case["n"] - r * local_n, 0), local_n)
                for (task, k), got_res, want_res, launched in zip(
                        case["calls"], res["results"], want[name], res["launches_by_call"]):
                    label = f"TP[{name}] rank {r} {task} top_k {k}"
                    k_rank = k if task == "predict_tails" else min(k + 1, case["n"])
                    kernel = "rank_topk" if k_rank <= rf.MAX_K else "rank_scores"
                    if launched != {**{n_: 0 for n_ in counts}, kernel: 1}:
                        raise AssertionError(f"{label}: launches {launched}, expected one "
                                             f"{kernel}")
                    if task == "predict_tails":
                        got_pairs = [(got_res["predictions"], got_res["scores"])]
                        want_pairs = [(want_res["predictions"], want_res["scores"])]
                    else:
                        got_pairs = [([e["similar_entities"]], [e["similarity_scores"]])
                                     for e in got_res["similar_entities"]]
                        want_pairs = [([e["similar_entities"]], [e["similarity_scores"]])
                                      for e in want_res["similar_entities"]]
                    for (gi, gv), (wi, wv) in zip(got_pairs, want_pairs):
                        if gi != wi:
                            raise AssertionError(f"{label}: ids differ from the one-process "
                                                 "engine's")
                        err = float(np.abs(np.asarray(gv) - np.asarray(wv)).max())
                        if not err <= TP_VALUE_ATOL:
                            raise AssertionError(f"{label}: values differ by {err:.3g}")
                        max_err = max(max_err, err)
                    if kernel == "rank_topk" and [min(k_rank, local_n), nvalid] not in res[
                            "local_calls"]:
                        raise AssertionError(f"{label}: no rank_topk_local call at nvalid "
                                             f"{nvalid}: {res['local_calls']}")
                below_k += [c for c in res["local_calls"] if c[1] < c[0]]
                for n_ in counts:
                    counts[n_] += res["counts"][n_]
        if not below_k:
            raise AssertionError("TP: no shard ranked at nvalid below k")
        tp_s = ranks[0]["N1000000"]["call_s"]
        part_p50 = {part: float(np.median(ts) * 1e3)
                    for part, ts in ranks[0]["N1000000"]["part_s"].items()}
        print(f"  {TP_RANKS} ranks on one card (gloo), {len(cases)} checkpoints "
              f"(N {', '.join(str(c['n']) for c in cases)}): ids equal to the one-process "
              f"engine's, values within {max_err:.3g} (bound {TP_VALUE_ATOL:g}); rank_topk_local "
              f"below k at (k, nvalid) {below_k}; launches {counts}; spawn to end "
              f"{spawn_s:.1f} s")
        tp = {
            "ranks": TP_RANKS, "backend": "gloo", "entities": [c["n"] for c in cases],
            "max_abs_value_diff_vs_one_process": max_err, "local_calls_below_k": below_k,
            "launches": counts, "spawn_to_end_s": spawn_s,
            "queries_per_s": KG_BATCH * TP_CALLS / sum(tp_s), "call_s": tp_s,
            "p50_ms_per_call": float(np.median([t * 1e3 for t in tp_s])),
            "p10_p90_ms_per_call": [float(np.percentile(tp_s, q) * 1e3) for q in (10, 90)],
            "part_p50_ms": part_p50,
            "one_process_queries_per_s": KG_BATCH * TP_CALLS / sum(one_card_s),
            "one_process_p50_ms_per_call": float(np.median([t * 1e3 for t in one_card_s])),
            "one_process_p10_p90_ms_per_call": [float(np.percentile(one_card_s, q) * 1e3)
                                                for q in (10, 90)],
        }
        print(f"  predict_tails at N = {KG_ENTITIES:,}, {KG_BATCH} pairs, top_k {KG_TOP_K}, "
              f"{TP_CALLS} calls: {TP_RANKS} ranks {tp['queries_per_s']:.1f} queries/s (p50 "
              f"{tp['p50_ms_per_call']:.3f} ms, p10-p90 "
              f"{tp['p10_p90_ms_per_call'][0]:.3f}-{tp['p10_p90_ms_per_call'][1]:.3f}), one "
              f"process {tp['one_process_queries_per_s']:.1f} queries/s (p50 "
              f"{tp['one_process_p50_ms_per_call']:.3f} ms, p10-p90 "
              f"{tp['one_process_p10_p90_ms_per_call'][0]:.3f}-"
              f"{tp['one_process_p10_p90_ms_per_call'][1]:.3f}); rank 0's parts, p50: "
              + ", ".join(f"{part} {ms:.3f} ms" for part, ms in part_p50.items())
              + "; two ranks share one card: for the record only")

        # the CLI under torch.distributed.run against the CLI in this process
        cli = {}
        case = cases[1]  # the uneven table
        for task, extra in (("predict_tails", ["--input_pairs", json.dumps(case["pairs"][:8])]),
                            ("similar_entities",
                             ["--input_entities", json.dumps(case["entities"])])):
            argv = ["--checkpoint_path", case["path"], "--task", task, "--top_k",
                    str(KG_TOP_K), "--device", "cuda", *extra]
            one = os.path.join(work, f"cli_one_{task}.json")
            with contextlib.redirect_stdout(quiet):
                cli_infer.main(argv + ["--output_file", one])
            two = os.path.join(work, f"cli_tp_{task}.json")
            run, seconds = torchrun("probgan_tpu_torch.cli.infer",
                                    argv + ["--mesh", "auto", "--output_file", two])
            if run.stdout.count("Results saved to") != 1:
                raise AssertionError(f"torchrun {task}: the result was not written once:\n"
                                     f"{run.stdout[-3000:]}")
            with open(one) as f:
                want_json = json.load(f)
            with open(two) as f:
                got_json = json.load(f)
            assert_close_tree(f"CLI {task} --mesh auto vs one process", got_json, want_json,
                              TP_VALUE_ATOL)
            cli[task] = {"seconds": seconds, "json_equal": got_json == want_json}
            print(f"  torchrun --nproc-per-node {TP_RANKS} cli.infer --task {task} --mesh "
                  f"auto (N {case['n']:,}): the one-process JSON (ids equal, floats within "
                  f"{TP_VALUE_ATOL:g}; equal as JSON: {cli[task]['json_equal']}), "
                  f"{cli[task]['seconds']:.1f} s")
        tp["cli"] = cli
    return {"rank_topk_local": counts["rank_topk"]}, tp


# Phase 20: data parallelism for the image family (parallel/sharded_image.py,
# parallel/dp_train.py): two ranks on cuda:0 through gloo, each run held to
# the one-process run on the same weights, latents and batch.
def dp_serving_calls(engine, z: np.ndarray, images: np.ndarray) -> dict:
    """The serving calls of the DP phase, by name: generate and score at a
    batch the two ranks split (8) and at one they do not (7: padded for
    generate, replicated for score), and an 11-frame latent walk."""
    return {
        "generate8": lambda: engine.generate(z),
        "generate7": lambda: engine.generate(z[:DP_ODD_BATCH]),
        "score8": lambda: engine.score(images),
        "score7": lambda: engine.score(images[:DP_ODD_BATCH]),
        "walk11": lambda: engine.latent_walk(z[0], z[1], frames=DP_WALK_FRAMES),
    }


def dp_split_renders(engine, z: np.ndarray) -> dict:
    """The one-process engine's images of the DP generate calls rendered at
    the ranks' own batches: each rank's rows of the padded latents as one
    ``generate`` call, the calls' images concatenated and cut. The walk's
    latents are ``latent_walk_fn``'s expression on the engine's device."""
    z = torch.from_numpy(z).to(engine.device)
    t = torch.linspace(0.0, 1.0, DP_WALK_FRAMES, device=engine.device)[:, None]
    walk = z[0][None, :] * (1.0 - t) + z[1][None, :] * t
    out = {}
    for name, zs in (("generate8", z), ("generate7", z[:DP_ODD_BATCH]), ("walk11", walk)):
        n = zs.shape[0]
        zs = F.pad(zs, (0, 0, 0, (-n) % DP_RANKS))
        out[name] = np.concatenate([engine.generate(part)
                                    for part in zs.chunk(DP_RANKS)])[:n]
    return out


def run_counted(pk, calls: dict) -> tuple[dict, dict]:
    """Each call's result and its launches (the counts set to 0 just before
    it, read just after)."""
    results, launches = {}, {}
    for name, fn in calls.items():
        pk.reset_launches()
        results[name] = fn()
        launches[name] = {**pk.launches, **pk.epilogue_launches}
    return results, launches


def timed_s(fn, n: int, sync, barrier=lambda: None) -> list[float]:
    """Host seconds of ``n`` calls, each between a barrier and a sync."""
    times = []
    for _ in range(n):
        barrier()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return times


def step_trees(tree_mod, state) -> dict:
    """A step's parameters and gradients (Adam's first moment after one
    step: b1 = 0) on the CPU, by network."""
    cpu = lambda tree: tree_mod.tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    return {"g": cpu(state.g_params), "d": cpu(state.d_params),
            "g_grad": cpu(state.g_opt[0].mu), "d_grad": cpu(state.d_opt[0].mu)}


def dp_rank(rank: int, world: int, work: str, spec: dict) -> None:
    """One rank of the DP phase (a child process on cuda:0): joins the gloo
    group, serves with ``ImageGANEngine(mesh="auto")`` at each grade, takes
    two ``dp_progan_train_step`` steps at each mode and times the gradient
    all-reduce alone; writes what it got and the kernels it launched to
    ``work``."""
    import datetime

    import torch.distributed as dist

    from probgan_tpu_torch.core import tree as tree_mod
    from probgan_tpu_torch.engine import image as engine_mod
    from probgan_tpu_torch.engine import train as train_mod
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.ops import packed as pk
    from probgan_tpu_torch.parallel import make_mesh, mesh_group
    from probgan_tpu_torch.parallel.dp_train import dp_progan_train_step, replicate_state
    from probgan_tpu_torch.parallel.mesh import rank_device

    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    torch.backends.cudnn.allow_tf32 = False  # as in the parent
    torch.backends.cuda.matmul.allow_tf32 = False
    device = spec["device"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cfg = pro_gan.ProGANConfig(**spec["config"])
    z = np.load(f"{work}/z.npy")
    images = np.load(f"{work}/u8.npy").astype(np.float32) / 127.5 - 1.0
    out = {"serving": {}, "train": {}}
    for grade in DP_GRADES:
        engine = engine_mod.ImageGANEngine(cfg, device=device, precision=grade, seed=0,
                                           mesh="auto")
        calls = dp_serving_calls(engine, z, images)
        results, launches = run_counted(pk, calls)
        for name, value in results.items():
            np.save(f"{work}/rank{rank}_{grade}_{name}.npy", value)
        out["serving"][grade] = {
            "launches": launches, "card": str(engine.device), "mesh": engine.mesh.size(),
            "generate_s": timed_s(calls["generate8"], DP_CALLS, sync, dist.barrier),
            "score_s": timed_s(calls["score8"], DP_CALLS, sync, dist.barrier)}
        del engine, calls, results
        if device == "cuda":
            torch.cuda.empty_cache()

    mesh = make_mesh(world, device_type=device)
    group = mesh_group(mesh)
    real = torch.from_numpy(np.load(f"{work}/real.npy"))
    tz = torch.from_numpy(np.load(f"{work}/train_z.npy"))
    stage = cfg.num_stages - 1
    for mode in DP_TRAIN_MODES:
        kw = dict(packed_d=True, packed_g=True, packed_train_mode=mode)
        state = replicate_state(mesh, train_mod.progan_init_state(DP_SEED, cfg, device="cpu"))
        pk.reset_launches()
        state1, m1 = dp_progan_train_step(mesh, state, real, tz, DP_TRAIN_ALPHA, cfg, stage,
                                          1e-3, **kw)
        sync()
        launches = {**pk.launches, **pk.epilogue_launches}
        m1 = {k: float(v) for k, v in m1.items()}
        ref = torch.cat([t.reshape(-1) for t in tree_mod.tree_leaves((state1.g_params,
                                                                      state1.d_params))])
        mine = ref.clone()
        dist.broadcast(ref, src=0, group=group)
        second = {}
        step_s = timed_s(lambda: second.update(dp_progan_train_step(
            mesh, state1, real, tz, DP_TRAIN_ALPHA, cfg, stage, 1e-3, **kw)[1]), 1, sync,
            dist.barrier)
        if rank == 0:
            torch.save(step_trees(tree_mod, state1), f"{work}/state_{mode}.pt")
        out["train"][mode] = {"metrics": m1, "second": {k: float(v) for k, v in second.items()},
                              "launches": launches, "step_s": step_s,
                              "replicas_equal": bool(torch.equal(mine, ref))}
        del state, state1, ref, mine
        if device == "cuda":
            torch.cuda.empty_cache()

    # the gradient all-reduce alone: one flat buffer a network, at the step's sizes
    params = train_mod.progan_init_state(DP_SEED, cfg, device="cpu")
    allreduce = {}
    for net, tree in (("d", params.d_params), ("g", params.g_params)):
        leaves = [t.to(rank_device(device)) for t in tree_mod.tree_leaves(tree)]
        scalars = tuple(torch.zeros((), device=leaves[0].device) for _ in range(3 if net == "d"
                                                                                  else 1))
        allreduce[net] = {
            "bytes": 4 * (sum(t.numel() for t in leaves) + len(scalars)),
            "s": timed_s(lambda: train_mod._mean_over_ranks(group, leaves, scalars),
                         DP_ALLREDUCE_CALLS, sync, dist.barrier)}
    out["grad_allreduce"] = allreduce
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def packed_rule(label: str, got, want, tree_mod, loose_bound, errors: list) -> dict:
    """A parameter tree of a DP step against the one-device step's by JAX's
    packed rule (``DP_TIGHT_ABS`` ...): the share of its elements past the
    tight bound (None: not bounded) and every element's difference; what
    breaks it is added to ``errors``."""
    worst, loose, total, worst_leaf = 0.0, 0, 0, 0.0
    for a, b in zip(tree_mod.tree_leaves(got), tree_mod.tree_leaves(want)):
        diff = (a.double() - b.double()).abs()
        n = int((diff > DP_TIGHT_ABS + DP_TIGHT_REL * b.double().abs()).sum())
        worst, loose, total = max(worst, float(diff.max())), loose + n, total + b.numel()
        worst_leaf = max(worst_leaf, n / b.numel())
    share = loose / total
    if worst > DP_MAX_DIFF or (loose_bound is not None and share > loose_bound):
        errors.append(f"{label}: {share:.3g} of elements past the tight bound (worst leaf "
                      f"{worst_leaf:.3g}), max |diff| {worst:.3g}")
    return {"max_abs_diff": worst, "loose_share": share, "worst_leaf_loose_share": worst_leaf}


def vector_rule(label: str, got, want, tree_mod, errors: list) -> dict:
    """A tree as one vector against another: relative L2 and cosine, held to
    DP_GRAD_L2 and DP_GRAD_COS."""
    a = torch.cat([t.double().reshape(-1) for t in tree_mod.tree_leaves(got)])
    b = torch.cat([t.double().reshape(-1) for t in tree_mod.tree_leaves(want)])
    l2 = float((a - b).norm() / b.norm())
    cos = float(a @ b / (a.norm() * b.norm()))
    if l2 > DP_GRAD_L2 or cos < DP_GRAD_COS:
        errors.append(f"{label}: relative L2 {l2:.3g}, cos {cos:.7f}")
    return {"rel_l2": l2, "cos": cos}


def phase_dp_path(pk, pro_gan, engine_mod, train_mod, tree_mod, image_checkpoint_mod,
                  cli_infer, cli_train_image, make_image_checkpoint, device: str = "cuda",
                  config=None) -> dict:
    """Data parallelism for the image family on one card: two ranks through
    gloo. (a) ``ImageGANEngine(mesh="auto")`` at the default config, 1024²,
    grades "high" and "fast": generate at 8 and 7, score at 8 (DP) and 7
    (replicated), latent_walk of 11 frames against the one-process engine on
    the same weights and inputs (uint8 +-1 on at most 0.1% of bytes against
    its renders at the ranks' batches, logits within 1e-5), the launches of
    each call equal to the one-process call's. (b) ``dp_progan_train_step``
    at stage 8, global batch 2 (one image a rank), both packed gates, at
    "default" and "highest", against ``progan_train_step`` on the same batch
    (``DP_LOSS_ATOL`` ...), replicas equal, a second step finite. (c) The
    CLIs under ``torch.distributed.run``. img/s, scores/s and step times
    are recorded only: the two ranks share one card."""
    cfg = config or pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    quiet = io.StringIO()
    dp = {"ranks": DP_RANKS, "backend": "gloo", "grades": {}, "train": {}}
    with tempfile.TemporaryDirectory() as work:
        # (a) the one-process engine: the reference, its launches and times
        ref = {}
        for grade in DP_GRADES:
            engine = engine_mod.ImageGANEngine(cfg, device=device, precision=grade, seed=0)
            if not ref:
                z = engine.sample_latents(DP_BATCH).cpu().numpy()
                u8 = engine.generate(z)
                np.save(os.path.join(work, "z.npy"), z)
                np.save(os.path.join(work, "u8.npy"), u8)
                images = u8.astype(np.float32) / 127.5 - 1.0
            calls = dp_serving_calls(engine, z, images)
            results, launches = run_counted(pk, calls)
            split = dp_split_renders(engine, z)
            ref[grade] = {"results": results, "launches": launches, "split": split,
                          "split_vs_whole": {name: uint8_agreement(value, results[name])
                                             for name, value in split.items()},
                          "generate_s": timed_s(calls["generate8"], DP_CALLS, sync),
                          "score_s": timed_s(calls["score8"], DP_CALLS, sync)}
            del engine, calls
        # (b) the one-process step on the whole batch
        rng = np.random.default_rng(22)
        res = pro_gan.stage_resolution(stage)
        real = (rng.standard_normal((DP_TRAIN_BATCH, res, res, 3)) * 0.5).astype(np.float32)
        tz = rng.standard_normal((DP_TRAIN_BATCH, cfg.latent_dim)).astype(np.float32)
        np.save(os.path.join(work, "real.npy"), real)
        np.save(os.path.join(work, "train_z.npy"), tz)
        train_ref = {}
        for mode in DP_TRAIN_MODES:
            state0 = train_mod.progan_init_state(DP_SEED, cfg, device=device)
            args = (torch.from_numpy(real).to(device), torch.from_numpy(tz).to(device),
                    DP_TRAIN_ALPHA, cfg, stage, 1e-3)
            kw = dict(packed_d=True, packed_g=True, packed_train_mode=mode)
            pk.reset_launches()
            state1, m1 = train_mod.progan_train_step(state0, *args, **kw)
            sync()
            launches = {**pk.launches, **pk.epilogue_launches}
            step_s = timed_s(lambda: train_mod.progan_train_step(state1, *args, **kw), 1, sync)
            # G's differentiable render at the step's grade, batch 2 against
            # two calls of 1: how far the one-process bits depend on the batch
            with torch.no_grad():
                render = [pro_gan.generator_rgb(
                    state1.g_params, zz, cfg, stage, DP_TRAIN_ALPHA,
                    precision=train_mod._STEP_PRECISION[mode], packed_mode=mode)
                    for zz in (args[1], args[1][:1], args[1][1:])]
                batch_dependence = float((render[0] - torch.cat(render[1:])).abs().max())
            del render
            train_ref[mode] = {"batch_dependence": batch_dependence, **step_trees(tree_mod, state1),
                              "metrics": {k: float(v) for k, v in m1.items()},
                              "launches": launches, "step_s": step_s}
            del state0, state1, args
        if device == "cuda":
            torch.cuda.empty_cache()

        import torch.multiprocessing as mp

        spec = {"device": device, "config": dataclasses.asdict(cfg)}
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_RANKS, work, spec), nprocs=DP_RANKS, join=True)
        dp["spawn_to_end_s"] = time.perf_counter() - t0
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                ranks.append(json.load(f))

        # (a) against the one-process engine
        for grade in DP_GRADES:
            want = ref[grade]
            stats = {"max_logit_diff": 0.0, "max_uint8_share": 0.0, "vs_whole_batch": {},
                     "one_process_split_vs_whole_batch": {
                         name: {"max": a[0], "share": a[1], "psnr_db": finite_or_none(a[2])}
                         for name, a in want["split_vs_whole"].items()}}
            for r, got in enumerate(ranks):
                serving = got["serving"][grade]
                if serving["mesh"] != DP_RANKS:
                    raise AssertionError(f"DP {grade} rank {r}: a mesh of {serving['mesh']}")
                for name, value in want["results"].items():
                    label = f"DP {grade} rank {r} {name}"
                    mine = np.load(os.path.join(work, f"rank{r}_{grade}_{name}.npy"))
                    if name.startswith("score"):
                        err = float(np.abs(mine.astype(np.float64) - value).max())
                        tol = DP_LOGIT_TOL[grade]
                        if mine.shape != value.shape or not np.allclose(mine, value, rtol=tol,
                                                                         atol=tol):
                            raise AssertionError(f"{label}: logits differ by {err:.3g} "
                                                 f"(bound {tol:g})")
                        stats["max_logit_diff"] = max(stats["max_logit_diff"], err)
                    else:
                        # the same renders at the ranks' batches: rule (a)
                        worst, share, _ = uint8_agreement(mine, want["split"][name])
                        if mine.shape != value.shape or worst > 1 or share > DP_UINT8_SHARE:
                            raise AssertionError(f"{label}: uint8 max |diff| {worst} on "
                                                 f"{share:.4%} of bytes against the "
                                                 "one-process renders at the ranks' batches")
                        stats["max_uint8_share"] = max(stats["max_uint8_share"], share)
                        # the one-process call at the whole batch
                        whole = uint8_agreement(mine, value)
                        stats["vs_whole_batch"][f"rank{r}_{name}"] = {
                            "max": whole[0], "share": whole[1],
                            "psnr_db": finite_or_none(whole[2])}
                        if grade == "high" and (whole[0] > 1 or whole[1] > DP_UINT8_SHARE):
                            raise AssertionError(f"{label}: uint8 max |diff| {whole[0]} on "
                                                 f"{whole[1]:.4%} of bytes")
                        if whole[2] < PSNR_FLOOR_DB:
                            raise AssertionError(f"{label}: {whole[2]:.2f} dB against the "
                                                 "one-process call")
                    # the DP walk renders its 12 padded frames in one
                    # dp_generate call (6 a rank), the one-process walk in
                    # chunks of 8 (two generate calls): a generate's launches
                    calls = want["launches"]["generate8" if name == "walk11" else name]
                    if serving["launches"][name] != calls:
                        raise AssertionError(f"{label}: launches {serving['launches'][name]}, "
                                             f"one process {calls}")
                    missing = [k for k in DP_SERVING_KERNELS[grade].get(name, ())
                               if device == "cuda" and serving["launches"][name][k] < 1]
                    if missing:
                        raise AssertionError(f"{label}: {missing} not launched")
            g0 = ranks[0]["serving"][grade]
            stats.update({
                "launches_a_call": {name: {k: v for k, v in counts.items() if v}
                                    for name, counts in want["launches"].items()},
                "dp_img_per_s": DP_BATCH * DP_CALLS / sum(g0["generate_s"]),
                "one_process_img_per_s": DP_BATCH * DP_CALLS / sum(want["generate_s"]),
                "dp_scores_per_s": DP_BATCH * DP_CALLS / sum(g0["score_s"]),
                "one_process_scores_per_s": DP_BATCH * DP_CALLS / sum(want["score_s"]),
                "dp_generate_s": g0["generate_s"], "dp_score_s": g0["score_s"]})
            dp["grades"][grade] = stats
            whole = list(stats["vs_whole_batch"].values())
            split = list(stats["one_process_split_vs_whole_batch"].values())
            print(f"  ImageGANEngine(mesh=\"auto\") at \"{grade}\", {DP_RANKS} ranks on one card: "
                  f"generate 8 / 7, latent_walk {DP_WALK_FRAMES} equal to the one-process renders "
                  f"at the ranks' batches (uint8 +-1 on at most {stats['max_uint8_share']:.4%} of "
                  f"bytes); against the one-process calls at the whole batch max |diff| "
                  f"{max(w['max'] for w in whole)} on at most {max(w['share'] for w in whole):.4%}"
                  f" of bytes (one process, the ranks' batches against the whole: max "
                  f"{max(w['max'] for w in split)} on at most {max(w['share'] for w in split):.4%});"
                  f" score 8 / 7 within {stats['max_logit_diff']:.3g}; the same launches a call; generate "
                  f"{stats['dp_img_per_s']:.2f} img/s (one process {stats['one_process_img_per_s']:.2f}),"
                  f" score {stats['dp_scores_per_s']:.2f} scores/s (one process "
                  f"{stats['one_process_scores_per_s']:.2f}); for the record only")

        # (b) against the one-process step; every mode is printed before a
        # failure is raised
        errors = []
        for mode in DP_TRAIN_MODES:
            want = train_ref[mode]
            got_state = torch.load(os.path.join(work, f"state_{mode}.pt"))
            for r, got in enumerate(ranks):
                t = got["train"][mode]
                label = f"DP step at \"{mode}\" rank {r}"
                for key in ("d_loss", "g_loss"):
                    if abs(t["metrics"][key] - want["metrics"][key]) > DP_LOSS_ATOL[mode]:
                        errors.append(f"{label}: {key} {t['metrics'][key]} vs one process "
                                      f"{want['metrics'][key]}")
                if t["metrics"] != ranks[0]["train"][mode]["metrics"] or not t["replicas_equal"]:
                    raise AssertionError(f"{label}: the ranks' metrics or states differ")
                if not all(math.isfinite(v) for v in t["second"].values()):
                    raise AssertionError(f"{label}: a second step's losses {t['second']}")
                if t["launches"] != want["launches"]:
                    raise AssertionError(f"{label}: launches {t['launches']}, one process "
                                         f"{want['launches']}")
                missing = [k for k in DP_STEP_KERNELS[mode]
                           if device == "cuda" and t["launches"][k] < 1]
                if missing:
                    raise AssertionError(f"{label}: {missing} not launched")
            loose_bound = DP_LOOSE_SHARE[mode]
            rule = {net: packed_rule(f"DP step at \"{mode}\" {net}", got_state[net], want[net],
                                     tree_mod, loose_bound, errors) for net in ("g", "d")}
            grads = {net: vector_rule(f"DP step at \"{mode}\" {net} gradient",
                                      got_state[f"{net}_grad"], want[f"{net}_grad"], tree_mod,
                                      errors) for net in ("g", "d")}
            t0 = ranks[0]["train"][mode]
            dp["train"][mode] = {
                "metrics": t0["metrics"], "one_process_metrics": want["metrics"],
                "second_step": t0["second"], "params_vs_one_process": rule,
                "gradients_vs_one_process": grads,
                "launches_a_step": {k: v for k, v in want["launches"].items() if v},
                "dp_step_s": t0["step_s"], "one_process_step_s": want["step_s"],
                "one_process_g_render_batch_dependence": want["batch_dependence"]}
            print(f"  dp_progan_train_step at \"{mode}\", batch {DP_TRAIN_BATCH} (one image a rank), "
                  f"both packed gates: losses {t0['metrics']['d_loss']:.7f} / "
                  f"{t0['metrics']['g_loss']:.7f} against one process "
                  f"{want['metrics']['d_loss']:.7f} / {want['metrics']['g_loss']:.7f} (bound "
                  f"{DP_LOSS_ATOL[mode]:g}), params max |diff| G {rule['g']['max_abs_diff']:.3g}, "
                  f"D {rule['d']['max_abs_diff']:.3g} (bound {DP_MAX_DIFF:g}), past the tight "
                  f"bound G {rule['g']['loose_share']:.3g} (worst leaf "
                  f"{rule['g']['worst_leaf_loose_share']:.3g}), D {rule['d']['loose_share']:.3g} "
                  f"(worst leaf {rule['d']['worst_leaf_loose_share']:.3g}; bound "
                  f"{loose_bound}), gradients rel L2 / cos G {grads['g']['rel_l2']:.3g} / "
                  f"{grads['g']['cos']:.7f}, D {grads['d']['rel_l2']:.3g} / "
                  f"{grads['d']['cos']:.7f}, replicas equal, the same launches a "
                  f"step; one process, G's render at batch 2 against two of 1: max |diff| "
                  f"{want['batch_dependence']:.3g}; step {t0['step_s'][0] * 1e3:.1f} ms "
                  f"(one process {want['step_s'][0] * 1e3:.1f} ms), for the record only")
        if errors:
            raise AssertionError("; ".join(errors))
        allreduce = {net: {"bytes": v["bytes"], "p50_ms": float(np.median(v["s"]) * 1e3),
                           "s": v["s"]} for net, v in ranks[0]["grad_allreduce"].items()}
        dp["grad_allreduce"] = allreduce
        print("  the gradient all-reduce alone (gloo, rank 0, p50 of "
              f"{DP_ALLREDUCE_CALLS}): " + ", ".join(
                  f"{net.upper()} {v['bytes'] / 1e6:.1f} MB {v['p50_ms']:.2f} ms"
                  for net, v in allreduce.items()))

        # (c) the CLIs under torch.distributed.run against the CLI in this process
        ckpt = os.path.join(work, "image_checkpoint.msgpack")
        image_checkpoint_mod.save_image_checkpoint(ckpt, cfg,
                                                   **make_image_checkpoint(cfg, seed=2))
        argv = ["--checkpoint_path", ckpt, "--task", "generate_images", "--num_images",
                str(DP_CLI_IMAGES), "--seed", "3", "--device", device]
        one, two = os.path.join(work, "one.npz"), os.path.join(work, "two.npz")
        with contextlib.redirect_stdout(quiet):
            cli_infer.main(argv + ["--output_file", one])
        run, seconds = torchrun("probgan_tpu_torch.cli.infer",
                                argv + ["--mesh", "auto", "--output_file", two])
        if run.stdout.count("Images saved to") != 1:
            raise AssertionError(f"torchrun generate_images: not written once:\n{run.stdout[-3000:]}")
        worst, share, _ = uint8_agreement(np.load(two)["images"], np.load(one)["images"])
        if worst > 1 or share > DP_UINT8_SHARE:
            raise AssertionError(f"torchrun generate_images: max |diff| {worst} on {share:.4%}")
        dp["cli_generate_images"] = {"seconds": seconds, "max_uint8_diff": worst,
                                     "differing_bytes": share}
        print(f"  torchrun --nproc-per-node {DP_RANKS} cli.infer --task generate_images --mesh "
              f"auto ({DP_CLI_IMAGES} images at {cfg.resolution}²): written once, the one-process "
              f"CLI's images (max |diff| {worst}, {share:.4%} of bytes), {seconds:.1f} s")
        dirs = {label: os.path.join(work, label) for label in ("train_one", "train_two")}
        with contextlib.redirect_stdout(quiet):
            if cli_train_image.main(DP_TRAIN_CLI + ["--device", device, "--output_dir",
                                                    dirs["train_one"]]) != 0:
                raise AssertionError("the one-process image trainer failed")
        run, seconds = torchrun("probgan_tpu_torch.cli.train_image",
                                DP_TRAIN_CLI + ["--device", device, "--mesh", "auto",
                                                "--output_dir", dirs["train_two"]])
        if run.stdout.count("Training complete!") != 1:
            raise AssertionError(f"torchrun train_image: not one rank 0:\n{run.stdout[-3000:]}")
        lines = {}
        for label, path in dirs.items():
            with open(os.path.join(path, "metrics.jsonl")) as f:
                lines[label] = [json.loads(x) for x in f]
        worst = 0.0
        if len(lines["train_two"]) != len(lines["train_one"]) or not lines["train_one"]:
            raise AssertionError(f"torchrun train_image: metrics {lines}")
        for got, want in zip(lines["train_two"], lines["train_one"]):
            for key in ("d_loss", "g_loss"):
                worst = max(worst, abs(got[key] - want[key]))
        if worst > DP_CLI_LOSS_ATOL:
            raise AssertionError(f"torchrun train_image: losses differ by {worst:.3g}")
        dp["cli_train_image"] = {"seconds": seconds, "max_loss_diff": worst,
                                 "epochs": len(lines["train_two"])}
        print(f"  torchrun --nproc-per-node {DP_RANKS} cli.train_image --mesh auto (2 steps, one "
              f"image a rank): exit 0, one metrics.jsonl, losses within {worst:.3g} of the "
              f"one-process run, {seconds:.1f} s")
    return dp


# Phase 21: the KG train state row-sharded over "model" and its batch split
# over "data" (parallel/dp_train.py, parallel/sharded_kg.py): ranks on cuda:0
# through gloo, each step held on rank 0 to the one-process step on the card
# at the same state, batch and noise.
def kg_tp_inputs(scale: dict, n: int, steps: int, seed: int) -> dict:
    """Each step's global batch (triplets with ids repeated within the batch
    and the table's last row as a true tail, corrupted negatives, sampled
    ids of which four collide with true tails, noise) and an eval batch,
    numpy from a seed: the same on every rank."""
    rng = np.random.default_rng(seed)
    b, rels, noise = scale["batch"], scale["relations"], scale["noise"]

    def triplets(m):
        return np.stack([rng.integers(0, n, m), rng.integers(0, rels, m),
                         rng.integers(0, n, m)], axis=1)

    out = {"steps": []}
    for _ in range(steps):
        trip = triplets(b)
        trip[1, 0] = trip[0, 0]
        trip[2, 2] = trip[3, 2] = n - 1
        ce = rng.integers(0, n, scale["ce"])
        ce[:4] = trip[:4, 2]
        out["steps"].append({
            "triplets": trip, "ce": ce, "z": rng.standard_normal((b, noise)).astype(np.float32),
            "negatives": np.stack([rng.integers(0, n, b), rng.integers(0, rels, b)], axis=1)})
    out["eval"] = {"triplets": triplets(scale["eval"]),
                   "z": rng.standard_normal((scale["eval"], noise)).astype(np.float32)}
    return out


def kg_eval_ks(n: int) -> tuple[int, int]:
    """The Hit@k of the eval: the trainer's k = 10, and k = N / 10, where a
    random state's hit rate is ~10%, so that the ranks' counts are held
    where they decide something."""
    return KG_TOP_K, n // 10


def kg_replicas_equal(mesh, state, tree_mod) -> bool:
    """Whether the ranks that should hold the same bits do: the replicated
    leaves across "model", and every leaf of the rank's part across "data"
    (one broadcast a group from its first rank)."""
    import torch.distributed as dist

    table = {id(state.node_emb), id(state.g_opt[0].mu[1]), id(state.g_opt[0].nu[1])}
    leaves = [t for t in tree_mod.tree_leaves(state) if t.dim()]  # Adam's counts: 0-d
    same = True
    for axis, part in (("model", [t for t in leaves if id(t) not in table]), ("data", leaves)):
        group = mesh.get_group(axis)
        if dist.get_world_size(group) == 1:
            continue
        mine = torch.cat([t.reshape(-1) for t in part])
        ref = mine.clone()
        dist.broadcast(ref, src=dist.get_global_rank(group, 0), group=group)
        same = same and torch.equal(mine, ref)
    return same


def moment_rule(label: str, got, want, tree_mod, errors: list) -> float:
    """Every Adam moment leaf of a KG state against the one-process one,
    its largest difference over its largest |entry| (KG_TP_MOMENT_REL):
    the worst such ratio; what breaks it is added to ``errors``."""
    worst = 0.0
    for opt in ("g_opt", "d_opt"):
        for m in ("mu", "nu"):
            for a, b in zip(tree_mod.tree_leaves(getattr(getattr(got, opt)[0], m)),
                            tree_mod.tree_leaves(getattr(getattr(want, opt)[0], m))):
                diff = float((a.double() - b.double()).abs().max())
                scale = float(b.abs().max())
                worst = max(worst, diff / scale if scale else diff)
    if worst > KG_TP_MOMENT_REL:
        errors.append(f"{label}: an Adam moment {worst:.3g} of its leaf's largest entry off "
                      f"(bound {KG_TP_MOMENT_REL:g})")
    return worst


def kg_tp_reference(train_mod, tree_mod, state0, steps: list, use_ce: bool, full, ev,
                    got: dict, label: str, dev, sync, exact: bool) -> dict:
    """The one-process steps on ``dev`` from ``state0`` on the same batches
    and noise, against the mesh's (``got``'s metrics, ``full`` its state
    gathered back to this rank's host): losses within KG_TP_LOSS_ATOL, the
    state by ``packed_rule`` at JAX's "highest" share (``exact``: every
    element within KG_TP_EXACT_ATOL) and its Adam moments by
    ``moment_rule``; the card memory the one-process steps took at their
    peak; the one-process Hit@10 of the gathered state. Errors are
    returned, not raised: rank 0 reports them."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ref = tree_mod.tree_map(lambda t: t if t.dim() == 0 else t.to(dev), state0)
    metrics, step_s = [], []
    for s in steps:
        kw = dict(negatives=s["negatives"].to(dev), z=s["z"].to(dev),
                  ce_negatives=s["ce"].to(dev) if use_ce else None)
        trip = s["triplets"].to(dev)
        sync()
        t0 = time.perf_counter()
        ref, m = train_mod.kg_train_step(ref, trip, **kw)
        metrics.append({k: float(v) for k, v in m.items()})
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    full = tree_mod.tree_map(lambda t: t if t.dim() == 0 else t.to(dev), full)
    errors = []
    loss_diff = max(abs(a[k] - b[k]) for a, b in zip(got["metrics"], metrics)
                    for k in ("d_loss", "g_loss"))
    if loss_diff > KG_TP_LOSS_ATOL:
        errors.append(f"{label}: losses {got['metrics']} vs one process {metrics}")
    rule = packed_rule(f"{label} state", full, ref, tree_mod, DP_LOOSE_SHARE["highest"], errors)
    if exact and rule["max_abs_diff"] > KG_TP_EXACT_ATOL:
        errors.append(f"{label}: state max |diff| {rule['max_abs_diff']:.3g} (bound "
                      f"{KG_TP_EXACT_ATOL:g}: the rows come from their owners)")
    out = {"one_process_metrics": metrics, "one_process_step_s": step_s,
           "max_loss_diff": loss_diff, "errors": errors, "state_vs_one_process": rule,
           "moments_vs_one_process": moment_rule(f"{label} moments", full, ref, tree_mod,
                                                 errors),
           "one_process_peak_bytes": peak}
    if ev is not None:
        out["one_process_hits"] = {str(k): float(train_mod.kg_eval_hits(
            full.g_params, full.node_emb, full.rel_emb, ev["triplets"], ev["z"], k))
            for k in kg_eval_ks(full.node_emb.shape[0])}
    return out


def kg_tp_rank(rank: int, world: int, work: str, spec: dict) -> None:
    """One rank of the KG TP phase (a child process on cuda:0): joins the
    gloo group, trains each case on a (world / tp, tp) mesh from the state
    every rank draws from one seed, evaluates, times the lookups' collective,
    serves a checkpoint with ``cli.infer --mesh auto`` (the rank kernels'
    launches counted from 0 just before it) and writes what it got to
    ``work``; rank 0 also runs the one-process reference."""
    import datetime

    import torch.distributed as dist

    from probgan_tpu_torch.cli import infer as cli_infer
    from probgan_tpu_torch.core import tree as tree_mod
    from probgan_tpu_torch.engine import train as train_mod
    from probgan_tpu_torch.ops import rank_fused as rf
    from probgan_tpu_torch.parallel import make_mesh
    from probgan_tpu_torch.parallel.dp_train import (
        gather_kg_state,
        kg_batch_sharding,
        shard_kg_state,
    )
    from probgan_tpu_torch.parallel.mesh import axis_size, rank_device
    from probgan_tpu_torch.parallel.sharded_kg import kg_mesh

    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    device, scale = spec["device"], spec["scale"]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def peak_since_reset() -> int | None:
        """The card memory this rank's process has held at its peak since the
        last reset (the ranks share the card; each has its own allocator)."""
        if device != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return peak

    mesh = make_mesh(world, model_parallelism=spec["tp"], device_type=device)
    dev = rank_device(device)
    rows_of = kg_batch_sharding(mesh)
    dp, data_rank = axis_size(mesh, "data"), mesh.get_local_rank("data")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "card": str(dev), "cases": {}}
    for case in spec["cases"]:
        n, label = case["n"], case["label"]
        data = kg_tp_inputs(scale, n, case["steps"], KG_TP_SEED + n)
        steps = [{k: torch.from_numpy(v) for k, v in s.items()} for s in data["steps"]]
        state0 = train_mod.kg_init_state(KG_TP_SEED, n, scale["relations"], scale["dim"],
                                         scale["noise"], scale["hidden"], device="cpu")
        kg = kg_mesh(mesh, n)
        peak_since_reset()
        st = shard_kg_state(mesh, state0)
        got = {"metrics": [], "step_s": [], "shard_rows": st.node_emb.shape[0],
               "exact": case.get("exact", False), "memory": case.get("memory", False)}
        for s in steps:
            kw = dict(negatives=rows_of(s["negatives"]), z=s["z"],
                      ce_negatives=s["ce"].to(dev) if case["ce"] else None)
            trip = rows_of(s["triplets"])
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            st, m = train_mod.kg_train_step(st, trip, mesh=kg, **kw)
            got["metrics"].append({k: float(v) for k, v in m.items()})
            got["step_s"].append(time.perf_counter() - t0)
        got["peak_bytes_steps"] = peak_since_reset()
        got["replicas_equal"] = kg_replicas_equal(mesh, st, tree_mod)
        if case.get("timed"):
            # the lookup of a step's rows alone (the batch's heads, the sampled
            # ids), and a bare all_reduce of the same bytes
            got["lookup_p50_ms"] = {}
            for name, ids in (("batch", trip[:, 0]), ("sampled", steps[-1]["ce"].to(dev))):
                raw = torch.zeros((len(ids), scale["dim"]), device=dev)
                lookup_s = timed_s(lambda ids=ids: kg.take(st.node_emb, ids), KG_TP_LOOKUP_CALLS,
                                   sync, dist.barrier)
                reduce_s = timed_s(lambda raw=raw: dist.all_reduce(raw, group=kg.model),
                                   KG_TP_LOOKUP_CALLS, sync, dist.barrier)
                got["lookup_p50_ms"][name] = {
                    "rows": len(ids), "bytes": 4 * raw.numel(),
                    "lookup": float(np.median(lookup_s) * 1e3),
                    "all_reduce_alone": float(np.median(reduce_s) * 1e3)}
        ev = None
        if case["eval"]:
            ev = {k: torch.from_numpy(v).to(dev) for k, v in data["eval"].items()}
            mine = [torch.tensor_split(ev[k], dp)[data_rank] for k in ("triplets", "z")]
            got["hits"] = {str(k): float(train_mod.kg_eval_hits(
                st.g_params, st.node_emb, st.rel_emb, *mine, k, mesh=kg))
                for k in kg_eval_ks(n)}
        sync()
        peak_since_reset()
        held = torch.cuda.memory_allocated(dev) if device == "cuda" else 0
        full = gather_kg_state(kg, st)
        sync()
        got["gather_extra_bytes"] = None if device != "cuda" else peak_since_reset() - held
        got["gathered_on_this_rank"] = full is not None
        del st
        if rank == 0:
            got.update(kg_tp_reference(train_mod, tree_mod, state0, steps, case["ce"], full, ev,
                                       got, label, dev, sync, got["exact"]))
        del full, state0
        if device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        out["cases"][label] = got
    if spec.get("serve"):
        rf.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_infer.main(spec["serve"])
        out["serve_launches"] = dict(rf.launches)
    with open(f"{work}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def phase_kg_tp_path(rf, cli_train, cli_infer, device: str = "cuda",
                     scale: dict | None = None) -> tuple[dict, dict]:
    """The KG train state row-sharded on one card, ranks through gloo. (a)
    The trainer CLI at N = 1,000,003 on a seeded dataset: one process in this
    process, then ``torch.distributed.run --nproc-per-node 2 -m
    probgan_tpu_torch.cli.train --mesh auto``, 1 epoch and a ``--resume`` to
    2 each: one rank 0 printing, the same files, losses within 1e-5 and the
    same Hit@10; the mesh run's checkpoint served by the one-process CLI.
    (b) Two ranks, mesh (1, 2): 3 ``kg_train_step`` with 8,192 sampled
    negatives at N = 1,000,003 (shards of 500,002 and 500,001 rows), one
    full-softmax step at N = 50,001, each against the one-process step on
    the card (losses within 1e-5, the state by JAX's packed rule, at
    N = 1,000,003 within 1e-6, each Adam moment within 1e-4 of its leaf's
    largest entry, the replicas equal; each rank's card memory at the peak
    of the steps at most 0.75 of one process's at N = 1,000,003, and
    ``gather_kg_state`` bringing the state to rank 0's host alone, adding
    at most 64 MiB on a card), ``kg_eval_hits`` over 512 triplets at k 10
    and N / 10 equal to the one-process values on the same state, the
    lookups' collective timed alone, and ``cli.infer --mesh auto`` serving
    (a)'s checkpoint: B4 ``rank_topk_local`` launched on each rank, the
    one-process CLI's JSON.
    (c) Four ranks, mesh (2, 2): one step at N = 100,003 by the same rules.
    Step times are recorded only: the ranks share one card."""
    import torch.multiprocessing as mp

    scale = {**KG_TP_SCALE, **(scale or {})}
    n, rels = scale["n"], scale["relations"]
    quiet = io.StringIO()
    kg_tp = {"backend": "gloo"}
    with tempfile.TemporaryDirectory() as work:
        # (a) the trainer CLI, one process and two ranks
        data = os.path.join(work, "data")
        os.makedirs(data)
        rng = np.random.default_rng(KG_TP_SEED)
        t = scale["cli_triplets"]
        trip = np.stack([rng.integers(0, n, t), rng.integers(0, rels, t),
                         rng.integers(0, n, t)], axis=1)
        trip[0] = (n - 1, rels - 1, 0)  # pins N and the relation count
        np.savetxt(os.path.join(data, "train.txt"), trip, fmt="%d", delimiter="\t")
        common = ["--data_root", data, "--batch_size", str(scale["cli_batch"]), "--embed_dim",
                  str(scale["dim"]), "--noise_dim", str(scale["noise"]), "--hidden_dim",
                  str(scale["hidden"]), "--device", device, "--seed", "3"]
        dirs = {name: os.path.join(work, name) for name in ("one", "mesh")}
        runs = (["--epochs", "1"], ["--epochs", "2", "--resume"])
        with contextlib.redirect_stdout(quiet):
            for extra in runs:
                if cli_train.main(common + ["--output_dir", dirs["one"], *extra]) != 0:
                    raise AssertionError(f"the one-process KG trainer {extra} failed")
        cli_s = []
        for extra in runs:
            run, seconds = torchrun("probgan_tpu_torch.cli.train", common + [
                "--mesh", "auto", "--output_dir", dirs["mesh"], *extra])
            if (run.stdout.count("Training complete!") != 1
                    or "Mesh: 2 devices {'data': 1, 'model': 2}" not in run.stdout):
                raise AssertionError(f"torchrun cli.train {extra}: not one rank 0 on a (1, 2) "
                                     f"mesh:\n{run.stdout[-3000:]}")
            cli_s.append(seconds)
        lines = {}
        for name, path in dirs.items():
            with open(os.path.join(path, "metrics.jsonl")) as f:
                lines[name] = [json.loads(x) for x in f]
        if not [m["epoch"] for m in lines["mesh"]] == [m["epoch"] for m in lines["one"]] == [1, 2]:
            raise AssertionError(f"KG trainer --mesh metrics.jsonl: {lines}")
        loss_diff = max(abs(a[k] - b[k]) for a, b in zip(lines["mesh"], lines["one"])
                        for k in ("d_loss", "g_loss"))
        if (loss_diff > KG_TP_LOSS_ATOL or [m["val_hit10"] for m in lines["mesh"]]
                != [m["val_hit10"] for m in lines["one"]]):
            raise AssertionError(f"KG trainer --mesh against one process: {lines}")
        if sorted(os.listdir(dirs["mesh"])) != sorted(os.listdir(dirs["one"])):
            raise AssertionError(f"KG trainer --mesh wrote {sorted(os.listdir(dirs['mesh']))}")
        kg_tp["cli_train"] = {
            "entities": n, "triplets": t, "batch": scale["cli_batch"], "torchrun_s": cli_s,
            "max_loss_diff": loss_diff, "epoch_s_mesh": [m["seconds"] for m in lines["mesh"]],
            "epoch_s_one_process": [m["seconds"] for m in lines["one"]]}
        print(f"  torchrun --nproc-per-node 2 cli.train --mesh auto at N = {n:,} ({t:,} "
              f"triplets, batch {scale['cli_batch']}), 1 epoch then --resume to 2: one rank 0, "
              f"the one-process files, losses within {loss_diff:.3g} (bound "
              f"{KG_TP_LOSS_ATOL:g}), Hit@10 equal; {cli_s[0]:.1f} s and {cli_s[1]:.1f} s")
        pairs = [[int(h), int(r)] for h, r in zip(rng.integers(0, n, 8), rng.integers(0, rels, 8))]
        serve = ["--checkpoint_path", os.path.join(dirs["mesh"], "best_checkpoint.pt"), "--task",
                 "predict_tails", "--input_pairs", json.dumps(pairs), "--top_k", str(KG_TOP_K),
                 "--device", device]
        one_json, mesh_json = (os.path.join(work, f"serve_{k}.json") for k in ("one", "mesh"))
        with contextlib.redirect_stdout(quiet):
            cli_infer.main(serve + ["--output_file", one_json])

        # (b) two ranks, (1, 2); (c) four ranks, (2, 2)
        specs = {
            "tp": (TP_RANKS, {
                "device": device, "scale": scale, "tp": TP_RANKS,
                "serve": serve + ["--mesh", "auto", "--output_file", mesh_json],
                "cases": [{"label": f"N{n}", "n": n, "steps": KG_TP_STEPS, "ce": True,
                           "eval": True, "timed": True, "exact": True, "memory": True},
                          {"label": f"N{scale['full_n']}_full", "n": scale["full_n"],
                           "steps": 1, "ce": False, "eval": False}]}),
            "dp": (KG_TP_DP_RANKS, {
                "device": device, "scale": scale, "tp": 2,
                "cases": [{"label": f"N{scale['dp_n']}_dp", "n": scale["dp_n"], "steps": 1,
                           "ce": True, "eval": False}]}),
        }
        ranks, errors = {}, []
        for name, (world, spec) in specs.items():
            sub = os.path.join(work, name)
            os.makedirs(sub)
            t0 = time.perf_counter()
            mp.spawn(kg_tp_rank, args=(world, sub, spec), nprocs=world, join=True)
            kg_tp[f"{name}_spawn_to_end_s"] = time.perf_counter() - t0
            ranks[name] = []
            for r in range(world):
                with open(os.path.join(sub, f"rank{r}.json")) as f:
                    ranks[name].append(json.load(f))
        for name, got in ranks.items():
            first = got[0]
            for label, res in first["cases"].items():
                errors += res["errors"]
                for r, other in enumerate(got):
                    o = other["cases"][label]
                    if not o["replicas_equal"] or o["metrics"] != res["metrics"] or o.get(
                            "hits") != res.get("hits"):
                        raise AssertionError(f"KG TP {label} rank {r}: the replicas, metrics or "
                                             "Hit@10 differ from rank 0's")
                if "hits" in res and res["hits"] != res["one_process_hits"]:
                    errors.append(f"KG TP {label}: Hit@10 {res['hits']} vs one process "
                                  f"{res['one_process_hits']}")
                peaks = [g["cases"][label]["peak_bytes_steps"] for g in got]
                extra = [g["cases"][label]["gather_extra_bytes"] for g in got]
                one_peak = res["one_process_peak_bytes"]
                if [g["cases"][label]["gathered_on_this_rank"] for g in got] != [
                        r == 0 for r in range(len(got))]:
                    errors.append(f"KG TP {label}: the gathered state is not on rank 0 alone")
                if device == "cuda":
                    if any(x > KG_TP_GATHER_EXTRA_BYTES for x in extra):
                        errors.append(f"KG TP {label}: gathering the state added {extra} bytes "
                                      f"on the ranks' card (bound {KG_TP_GATHER_EXTRA_BYTES})")
                    shares = [p / one_peak for p in peaks]
                    if res["memory"] and max(shares) > KG_TP_PEAK_SHARE:
                        errors.append(f"KG TP {label}: a rank's peak over the steps {shares} of "
                                      f"the one-process steps' (bound {KG_TP_PEAK_SHARE:g})")
                rule = res["state_vs_one_process"]
                mesh_p50 = float(np.median(res["step_s"]) * 1e3)
                one_p50 = float(np.median(res["one_process_step_s"]) * 1e3)
                kg_tp[label] = {
                    "mesh": first["mesh"], "shard_rows": [g["cases"][label]["shard_rows"]
                                                          for g in got],
                    "metrics": res["metrics"], "one_process_metrics": res["one_process_metrics"],
                    "max_loss_diff": res["max_loss_diff"], "state_vs_one_process": rule,
                    "step_s": res["step_s"], "one_process_step_s": res["one_process_step_s"],
                    "steps_per_s": len(res["step_s"]) / sum(res["step_s"]),
                    "one_process_steps_per_s": (len(res["one_process_step_s"])
                                                / sum(res["one_process_step_s"])),
                    "hits": res.get("hits"), "one_process_hits": res.get("one_process_hits"),
                    "lookup_p50_ms": res.get("lookup_p50_ms"),
                    "moments_vs_one_process": res["moments_vs_one_process"],
                    "peak_bytes_steps_by_rank": peaks, "one_process_peak_bytes": one_peak,
                    "gather_extra_bytes_by_rank": extra}
                print(f"  {label} on mesh {first['mesh']} ({len(got)} ranks on one card, gloo), "
                      f"{len(res['step_s'])} step(s): losses within {res['max_loss_diff']:.3g} of "
                      f"one process (bound {KG_TP_LOSS_ATOL:g}), state max |diff| "
                      f"{rule['max_abs_diff']:.3g} (bound "
                      f"{KG_TP_EXACT_ATOL if res['exact'] else DP_MAX_DIFF:g}), past the tight "
                      f"bound {rule['loose_share']:.3g} (bound {DP_LOOSE_SHARE['highest']:g}), "
                      f"moments {res['moments_vs_one_process']:.3g} of their largest entries "
                      f"(bound {KG_TP_MOMENT_REL:g}), replicas equal; step p50 {mesh_p50:.1f} ms "
                      f"(one process {one_p50:.1f} ms)"
                      + (f"; Hit@k over {scale['eval']} triplets at k = " + ", ".join(
                          f"{k}: {v:.4f}" for k, v in res["hits"].items())
                         + ", equal to one process's" if "hits" in res else ""))
                if res.get("lookup_p50_ms"):
                    print("  the lookups' collective alone (rank 0, p50 of "
                          f"{KG_TP_LOOKUP_CALLS}): " + ", ".join(
                              f"{k} {v['rows']} rows {v['lookup']:.3f} ms (a bare all_reduce of "
                              f"its {v['bytes'] / 1e6:.2f} MB {v['all_reduce_alone']:.3f} ms)"
                              for k, v in res["lookup_p50_ms"].items()))
                if device == "cuda":
                    print(f"  card memory at the peak of the steps by rank "
                          f"{[round(p / 2**20, 1) for p in peaks]} MiB, one process "
                          f"{one_peak / 2**20:.1f} MiB (share {max(peaks) / one_peak:.3f}"
                          + (f", bound {KG_TP_PEAK_SHARE:g}" if res["memory"] else "")
                          + f"); gathering the state to rank 0 added "
                          f"{[round(x / 2**20, 1) for x in extra]} MiB on the card (bound "
                          f"{KG_TP_GATHER_EXTRA_BYTES / 2**20:g})")
        if errors:
            raise AssertionError("; ".join(errors))

        launches = [g["serve_launches"] for g in ranks["tp"]]
        if device == "cuda" and any(c["rank_topk"] != 1 for c in launches):
            raise AssertionError(f"cli.infer --mesh auto: rank_topk launches {launches}, one a "
                                 "rank expected")
        with open(one_json) as f:
            want_json = json.load(f)
        with open(mesh_json) as f:
            got_json = json.load(f)
        assert_close_tree("cli.infer --mesh auto on the mesh-trained checkpoint vs one process",
                          got_json, want_json, TP_VALUE_ATOL)
        kg_tp["serve"] = {"launches_by_rank": launches, "json_equal": got_json == want_json}
        print(f"  cli.infer --task predict_tails --mesh auto on the mesh-trained checkpoint: "
              f"rank_topk_local launches by rank {[c['rank_topk'] for c in launches]}, the "
              f"one-process CLI's JSON (ids equal, floats within {TP_VALUE_ATOL:g}; equal as "
              f"JSON: {kg_tp['serve']['json_equal']})")
    return {"rank_topk_local": sum(c["rank_topk"] for c in launches)}, kg_tp


# Phase 22: the serving path's PixelNorm kernels at any width up to 64
# (ROADMAP.md B.a.2.3): B1 "lrelu_norm", B2 "lrelu_norm" and B3 at the Cout
# (and C) of generators whose last stages are narrower than 8 channels or no
# power of two, at 1024² with ProGANConfig()'s latent_dim 512 and fmap_max
# 512: T (fmap_base 1024, stages 6-8 at 16, 8, 4 channels), T2 (512: 8, 4, 2)
# and O (3072: 48, 24, 12). Each width runs on the tile just above it, its
# weights zero-padded by the wrapper.
ANY_WIDTH_CONFIGS = {"T": 1024, "T2": 512, "O": 3072}
ANY_WIDTH_NF = {"T": [16, 8, 4], "T2": [8, 4, 2], "O": [48, 24, 12]}  # stages 6-8
ANY_WIDTH_COUTS = (2, 4, 12, 24, 48)  # the widths no kernel took before
# (kernel, epilogue or emit, C, Cout, H) of every new width of T, T2 and O
# (B1's H is its input's), each at batch 2 and 8
ANY_WIDTH_CASES = (
    ("packed_upconv", "lrelu_norm+rgb", 8, 4, 512),  # T, stage 8
    ("packed_upconv", "lrelu_norm", 8, 4, 256),  # T2, stage 7
    ("packed_upconv", "lrelu_norm+rgb", 4, 2, 512),  # T2, stage 8
    ("packed_upconv", "lrelu_norm", 96, 48, 128),  # O, stage 6
    ("packed_upconv", "lrelu_norm", 48, 24, 256),  # O, stage 7
    ("packed_upconv", "lrelu_norm+rgb", 24, 12, 512),  # O, stage 8
    ("packed_conv", "lrelu_norm", 4, 4, 512),  # T2, stage 7
    ("packed_conv", "lrelu_norm", 48, 48, 256),  # O, stage 6
    ("packed_conv", "lrelu_norm", 24, 24, 512),  # O, stage 7
    ("packed_conv_rgb", "uint8", 4, 4, 1024), ("packed_conv_rgb", "fp32", 4, 4, 1024),  # T
    ("packed_conv_rgb", "uint8", 2, 2, 1024), ("packed_conv_rgb", "fp32", 2, 2, 1024),  # T2
    ("packed_conv_rgb", "uint8", 12, 12, 1024),  # O
    ("packed_conv_rgb", "fp32", 12, 12, 1024),
)
ANY_WIDTH_ITERS = 5  # timed calls of each kernel, twin and library call
# check_pixelnorm's rel by kernel mode: phases 2-4's 1e-4 at "high", the CPU
# tests' 2e-5 at the bf16 modes (tests/test_torch_grades.py, test_torch_mid.py)
ANY_WIDTH_PIXEL_REL = {"high": 1e-4, "default": 2e-5, "mid": 2e-5}
ANY_WIDTH_GENERATE = ("T", "O")
ANY_WIDTH_CALLS = 2  # timed generate calls a grade
ANY_WIDTH_WALK_FRAMES = 8  # one chunk of the walk
# generate's packed launches a call at T and O (stages 6-8), and those at
# this item's widths (ops/packed.py narrow_launches, by the true Cout)
ANY_WIDTH_GENERATE_ALL = {"packed_upconv": 3, "packed_conv": 2, "packed_conv_rgb": 1}
ANY_WIDTH_GENERATE_NEW = {
    "T": {"packed_upconv[cout4]": 1, "packed_conv_rgb[cout4]": 1},
    "O": {"packed_upconv[cout48]": 1, "packed_conv[cout48]": 1, "packed_upconv[cout24]": 1,
          "packed_conv[cout24]": 1, "packed_upconv[cout12]": 1, "packed_conv_rgb[cout12]": 1},
}
# the JAX tests' own configuration at 512² (tests/test_pallas_packed.py),
# whose stage 7 is B1 8 -> 4 then B3 4 -> 4: the D step's fakes go through
# them (packed_fake, on by default on the card); 2 steps a stage
ANY_WIDTH_TRAINER = ["--model", "image", "--synthetic", "4", "--batch_size", "2",
                     "--epochs_per_stage", "1", "--resolution", "512", "--fmap_base", "512",
                     "--fmap_max", "64", "--checkpoint_minutes", "0", "--device", "cuda"]


def any_width_entry_counts(narrow: dict) -> dict:
    """narrow_launches at this item's widths, summed by phase 22's entry
    ("<counter>[any_width]")."""
    out = {}
    for key, n in narrow.items():
        counter, width = key[:-1].split("[cout")
        if int(width) in ANY_WIDTH_COUTS:
            out[f"{counter}[any_width]"] = out.get(f"{counter}[any_width]", 0) + n
    return out


def phase_any_width_kernels(pk, pro_gan) -> tuple[list[dict], dict]:
    """B1 "lrelu_norm" (with and without toRGB), B2 "lrelu_norm" and B3 (fp32
    and uint8) at every new (C, Cout) of T, T2 and O, at batch 2 and 8, at
    "high", "default" and "mid", against their twins: the fp32 PixelNorm
    outputs pixel by pixel (check_pixelnorm, ANY_WIDTH_PIXEL_REL; at 2 and 4
    channels a pixel's RMS can be small enough that the sums' order moves
    its values past a bound taken of the largest entry: 1.33e-5 of it at
    4 -> 2, b2, "default", on an H100), B1's toRGB by phase 16's rules
    (1e-4 / GRADE_REL of the largest entry), uint8 +-1 on 0.5% of bytes,
    MID_UINT8_FLIP_SHARE at "mid", and at "default" up to 2 levels, each byte
    past +-1 witnessed as a bf16 rounding flip; two runs bit-equal; timed
    beside the bound and F.conv2d with the torch epilogue."""
    return phase_narrow_kernels(pk, pro_gan, cases=ANY_WIDTH_CASES,
                                batches=(BATCH_KERNELS, BATCH_MAIN), seed=2424, tag="any_width",
                                witness_couts=ANY_WIDTH_COUTS, iters=ANY_WIDTH_ITERS,
                                pixel_rel=ANY_WIDTH_PIXEL_REL)


def phase_any_width_path(pk, pro_gan, engine_mod, cli_train,
                         image_checkpoint_mod, tree_mod) -> tuple[dict, dict]:
    """generate at T and O, batch 8, at "high", "fast" and G's "mid" (the
    packed launches a call, by width too, img/s and p50); "high" against the
    unpacked path on the card (+-1 on at most 0.5% of bytes, >= 50 dB), each
    grade's PSNR against "high" (>= 50 dB at "fast"). latent_walk of 8 frames
    at T: generate on the same latents, bit for bit. Under
    PROBGAN_STAGE_FUSED=1 generate at T raises before any launch, naming
    ROADMAP.md B.a.2.4. The image trainer CLI at 512², fmap_base 512,
    fmap_max 64: stages 0-7, the D step's fakes of stage 7 through B1 8 -> 4
    and B3 4 -> 4, finite losses, a checkpoint the port loads."""
    path, counts = {}, {}
    saved = pro_gan._PACKED_MODES["fast"]
    for name in ANY_WIDTH_GENERATE:
        cfg = pro_gan.ProGANConfig(resolution=1024, fmap_base=ANY_WIDTH_CONFIGS[name])
        stage = cfg.num_stages - 1
        if ([cfg.nf(s) for s in (6, 7, 8)] != ANY_WIDTH_NF[name]
                or pro_gan.packed_start_stage(cfg, stage) != 6):
            raise AssertionError(f"{name}: stages 6-8 are not {ANY_WIDTH_NF[name]} on the kernels")
        first = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=22)
        latents = [first.sample_latents(BATCH_MAIN) for _ in range(ANY_WIDTH_CALLS)]
        images, out = {}, {"fmap_base": ANY_WIDTH_CONFIGS[name], "widths_6_8": ANY_WIDTH_NF[name]}
        try:
            for label, grade, kmode in (("high", "high", "high"), ("fast", "fast", "default"),
                                        ("fast mid", "fast", "mid")):
                pro_gan._PACKED_MODES["fast"] = "mid" if label == "fast mid" else saved
                engine = engine_mod.ImageGANEngine(cfg, g_params=first.g_params,
                                                   d_params=first.d_params, device="cuda",
                                                   precision=grade)
                engine.generate(latents[0])  # warm-up (cuDNN plans)
                torch.cuda.synchronize()
                pk.reset_launches()
                times = []
                for z in latents:
                    t0 = time.perf_counter()
                    img = engine.generate(z)
                    times.append(time.perf_counter() - t0)
                want = {k: 0 for k in pk.launches}
                want.update({_counter(k, kmode): n * ANY_WIDTH_CALLS
                             for k, n in ANY_WIDTH_GENERATE_ALL.items()})
                got_new = {k: n for k, n in pk.narrow_launches.items()
                           if int(k[:-1].split("[cout")[1]) in ANY_WIDTH_COUTS}
                want_new = {k: n * ANY_WIDTH_CALLS
                            for k, n in _narrow(ANY_WIDTH_GENERATE_NEW[name], kmode).items()}
                if dict(pk.launches) != want or got_new != want_new:
                    raise AssertionError(f"generate at {name}, {label}: launched {pk.launches}, "
                                         f"{pk.narrow_launches}; expected {want}, {want_new}")
                for k, n in any_width_entry_counts(pk.narrow_launches).items():
                    counts[k] = counts.get(k, 0) + n
                images[label] = img
                _, share, psnr = uint8_agreement(img, images["high"])
                per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
                out[f"generate {label}"] = {
                    "img_per_s": BATCH_MAIN * ANY_WIDTH_CALLS / sum(times),
                    "p50_ms_per_img": float(np.median(per_img_ms)), "batch_s": times,
                    "psnr_vs_high_db": finite_or_none(psnr), "differing_bytes_vs_high": share,
                    "narrow_launches": dict(pk.narrow_launches),
                }
                print(f"  generate at {name}, {label}: "
                      f"{BATCH_MAIN * ANY_WIDTH_CALLS / sum(times):.3f} img/s, p50 "
                      f"{float(np.median(per_img_ms)):.3f} ms/img, PSNR {psnr:.2f} dB vs "
                      f"\"high\", narrow launches {dict(pk.narrow_launches)}")
                if label == "fast" and psnr < PSNR_FLOOR_DB:
                    raise AssertionError(f"generate at {name}, \"fast\": PSNR {psnr:.2f} dB < "
                                         f"{PSNR_FLOOR_DB} dB against \"high\"")
                del engine
        finally:
            pro_gan._PACKED_MODES["fast"] = saved
        # "high" against the unpacked path on the card (the last batch)
        unpacked = engine_mod.generate_fn(first.g_params, latents[-1], 1.0, cfg, stage,
                                          precision="high", packed=False).cpu().numpy()
        worst, share, psnr = check_uint8(f"generate at {name}, \"high\" vs unpacked",
                                         images["high"], unpacked)
        if psnr < PSNR_FLOOR_DB:
            raise AssertionError(f"generate at {name}, \"high\": PSNR {psnr:.2f} dB < "
                                 f"{PSNR_FLOOR_DB} dB against the unpacked path")
        out["high_vs_unpacked"] = {"max_abs_diff": worst, "differing_bytes": share,
                                   "psnr_db": finite_or_none(psnr)}
        if name == "T":
            # latent_walk at "high": one chunk, the frames of generate
            z0, z1 = latents[0][0], latents[0][1]
            frames = first.latent_walk(z0, z1, frames=ANY_WIDTH_WALK_FRAMES)
            t = torch.linspace(0.0, 1.0, ANY_WIDTH_WALK_FRAMES, dtype=z0.dtype,
                               device=z0.device)[:, None]
            direct = first.generate(z0[None, :] * (1.0 - t) + z1[None, :] * t)
            if not np.array_equal(frames, direct):
                raise AssertionError("latent_walk at T: frames differ from generate on their "
                                     "latents")
            out["latent_walk_frames_equal_generate"] = True
            print(f"  latent_walk at T, {ANY_WIDTH_WALK_FRAMES} frames: equal to generate on "
                  "the same latents, bit for bit")
            # the stage-fused kernels keep Cout 8-64 from C % 8: refused up front
            pk.reset_launches()
            with env(PROBGAN_STAGE_FUSED="1"):
                try:
                    first.generate(latents[0])
                except ValueError as e:
                    if "ROADMAP.md, B.a.2.4" not in str(e):
                        raise AssertionError(f"PROBGAN_STAGE_FUSED=1 at T raised {e!r}") from e
                    out["stage_fused_refusal"] = str(e)
                    print(f"  generate at T under PROBGAN_STAGE_FUSED=1: ValueError: {e}")
                else:
                    raise AssertionError("PROBGAN_STAGE_FUSED=1 at T: the card took it")
            if any(pk.launches.values()):
                raise AssertionError(f"the refused stage-fused call launched {dict(pk.launches)}")
        path[name] = out
        del first
        torch.cuda.empty_cache()

    # the image trainer at the JAX tests' 512² configuration
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = os.path.join(tmp, "any_width")
        pk.reset_launches()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = cli_train.main([*ANY_WIDTH_TRAINER, "--output_dir", out_dir])
        wall_s = time.perf_counter() - t0
        if rc != 0 or "Training complete!" not in log.getvalue():
            raise AssertionError(f"image trainer at fmap_base 512 exited {rc}:\n{log.getvalue()}")
        narrow = dict(pk.narrow_launches)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        cfg, g_params, d_params = image_checkpoint_mod.load_image_checkpoint(
            os.path.join(out_dir, "image_checkpoint.msgpack"))
    def launched(kernel, cout):  # at any kernel mode
        return sum(n for k, n in narrow.items()
                   if k.split("[")[0].removesuffix("_bf16").removesuffix("_mid") == kernel
                   and k.endswith(f"[cout{cout}]"))

    if launched("packed_upconv", 4) < 1 or launched("packed_conv_rgb", 4) < 1:
        raise AssertionError(f"the trainer's stage 7 did not run B1 8 -> 4 and B3 4 -> 4: "
                             f"{narrow}")
    if ([m["stage"] for m in metrics] != list(range(8)) or any(
            not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"])) for m in metrics)):
        raise AssertionError(f"image trainer at fmap_base 512: metrics {metrics}")
    if (cfg.resolution != 512 or cfg.nf(7) != 4 or not d_params
            or not all(torch.isfinite(t).all() for t in tree_mod.tree_leaves(g_params))):
        raise AssertionError("image trainer at fmap_base 512 wrote a checkpoint the port does "
                             "not load as trained")
    stage_s = {m["stage"]: m["seconds"] for m in metrics}
    path["trainer"] = {"argv": ANY_WIDTH_TRAINER, "seconds_per_stage": stage_s, "wall_s": wall_s,
                       "narrow_launches": narrow,
                       "losses": [(m["d_loss"], m["g_loss"]) for m in metrics]}
    print(f"  image trainer CLI at 512², fmap_base 512, fmap_max 64: stages 0-7 in "
          f"{wall_s:.1f} s, seconds per stage "
          f"{', '.join(f'{k}: {v:.4f}' for k, v in stage_s.items())}; narrow launches "
          f"{narrow}; the checkpoint loads in the port")
    return counts, path


# Phase 23: the training half of B.a.2.4: the packed train step's backward
# at the widths of T, T2 and O (phase 22's generators), whose packed stages
# 6-8 run B1 "lrelu" (the pre-norm recompute), B2 "lrelu" (the recompute)
# and "none" (conv2's input gradient), B5 "none" (the upconv's input
# gradient) and B6 (both weight gradients) at a Cout of 2, 4 or 12 or an
# input C that is no multiple of 8; B1 "lrelu" also at 48 and 24 (O's
# stages 6 and 7), on the tile of the forward's "lrelu_norm". The sliced
# kernels run the slab of Cout rounded up to 8, the weights zero-padded.
ANY_BWD_MODES = ("high", "default", "mid")
# (kernel, epilogue, C, Cout, H) of every call the card refused before this
# item at T, T2 and O, batch 2 (B1's H is its input's; B5's C its input's,
# the cotangent's channels, and its Cout the upconv's input channels)
ANY_BWD_CASES = (
    ("packed_upconv", "lrelu", 8, 4, 512),  # T, stage 8
    ("packed_upconv", "lrelu", 8, 4, 256),  # T2, stage 7
    ("packed_upconv", "lrelu", 4, 2, 512),  # T2, stage 8
    ("packed_upconv", "lrelu", 96, 48, 128),  # O, stage 6
    ("packed_upconv", "lrelu", 48, 24, 256),  # O, stage 7
    ("packed_upconv", "lrelu", 24, 12, 512),  # O, stage 8
    ("packed_conv", "lrelu", 4, 4, 1024), ("packed_conv", "none", 4, 4, 1024),  # T, stage 8
    ("packed_conv", "lrelu", 4, 4, 512), ("packed_conv", "none", 4, 4, 512),  # T2, stage 7
    ("packed_conv", "lrelu", 2, 2, 1024), ("packed_conv", "none", 2, 2, 1024),  # T2, stage 8
    ("packed_conv", "lrelu", 12, 12, 1024), ("packed_conv", "none", 12, 12, 1024),  # O, stage 8
    ("packed_convpool", "none", 4, 8, 1024),  # T, stage 8
    ("packed_convpool", "none", 4, 8, 512),  # T2, stage 7
    ("packed_convpool", "none", 2, 4, 1024),  # T2, stage 8
    ("packed_convpool", "none", 12, 24, 1024),  # O, stage 8
    # B5 "lrelu" (D's conv2): the same kernel, on no path at these widths
    ("packed_convpool", "lrelu", 4, 4, 1024), ("packed_convpool", "lrelu", 12, 12, 1024),
)
# B6's (C, Cout, H) of the same steps: each stage's (C upsampled, Cout) and
# (Cout, Cout)
ANY_BWD_WGRAD = ((8, 4, 1024), (4, 4, 1024), (8, 4, 512), (4, 4, 512), (4, 2, 1024),
                 (2, 2, 1024), (24, 12, 1024), (12, 12, 1024))
# "lrelu" recompute against the "lrelu_norm" forward: (C, Cout, H)
ANY_BWD_RECOMPUTE = ((48, 48, 256), (24, 24, 512), (4, 4, 1024))
# the four Functions at the new pairs: (name, C, Cout, H, input PixelNorm'd)
ANY_BWD_FUNCTIONS = (("upconv_lrelu_norm", 8, 4, 512, True), ("conv_lrelu_norm", 4, 4, 1024, True),
                     ("upconv_lrelu_norm", 4, 2, 512, True), ("conv_lrelu_norm", 2, 2, 1024, True),
                     ("upconv_lrelu_norm", 24, 12, 512, True),
                     ("conv_lrelu_norm", 12, 12, 1024, True),
                     ("conv_lrelu", 12, 12, 1024, False), ("convpool_lrelu", 4, 4, 1024, False))
ANY_BWD_ITERS = 5
ANY_BWD_TIMED_STEPS = 3
ANY_BWD_STEP_MODES = {"T": ("highest", "default"), "T2": ("highest", "default"),
                      "O": ("highest", "default", "mid")}
ANY_BWD_TRAINER = ["--synthetic", "4", "--batch_size", "2", "--epochs_per_stage", "1",
                   "--resolution", "512", "--fmap_base", "512", "--fmap_max", "64",
                   "--checkpoint_minutes", "0", "--device", "cuda"]


def any_width_bwd_key(pk, kernel: str, epilogue, c: int, cout: int):
    """"<kernel>[<epilogue>]" (B6: "packed_conv_wgrad") of a backward call
    that the card took only since this item, else None: B1 "lrelu" at a
    Cout that is no tile's width, B2 "lrelu"/"none", B5 and B6 at a C or
    Cout that is no multiple of 8."""
    if kernel == "packed_upconv":
        new = epilogue == "lrelu" and cout not in pk.SUPPORTED_COUT
    else:
        new = epilogue != "lrelu_norm" and (c % 8 or cout % 8)
    if not new:
        return None
    return kernel if epilogue is None else f"{kernel}[{epilogue}]"


def any_width_bwd_kind(entry: str) -> str:
    """An entry's kernel and epilogue at any mode: "packed_conv[none]", or
    "packed_conv_wgrad"."""
    base, _, rest = entry.partition("[")
    base = base.removesuffix("_bf16").removesuffix("_mid")
    return base if base == "packed_conv_wgrad" else f"{base}[{rest.split(',')[0]}]"


@contextlib.contextmanager
def any_width_bwd_spy(pk, seen: dict):
    """Inside, each call of B1 "lrelu", B2, B5 and B6 that launches at a
    width the card took only since this item is counted in ``seen`` by
    (entry name at the call's mode, (C, Cout))."""
    names = ("packed_upconv", "packed_conv", "packed_convpool", "packed_conv_wgrad")
    real = {name: getattr(pk, name) for name in names}

    defaults = {"packed_upconv": "lrelu_norm", "packed_conv": "lrelu_norm",
                "packed_convpool": "lrelu", "packed_conv_wgrad": None}

    def spy_of(name):
        def spy(x, w, *args, **kwargs):
            out = real[name](x, w, *args, **kwargs)
            if name == "packed_conv_wgrad":  # (x, dpre, mode)
                cout, mode = w.shape[1], kwargs.get("mode", args[0] if args else "highest")
                epilogue = None
            else:  # (x, w, b, epilogue, mode)
                cout, mode = w.shape[0], kwargs.get("mode", "high")
                epilogue = kwargs.get("epilogue", args[1] if len(args) > 1 else defaults[name])
            kind = any_width_bwd_key(pk, name, epilogue, x.shape[1], cout)
            if kind is not None:
                key = (any_width_bwd_entry(kind, mode), (x.shape[1], cout))
                seen[key] = seen.get(key, 0) + 1
            return out
        return spy

    try:
        for name in names:
            setattr(pk, name, spy_of(name))
        yield
    finally:
        for name, fn in real.items():
            setattr(pk, name, fn)


def any_width_bwd_entry(kernel: str, mode: str) -> str:
    """The kernels line's entry of a call at ``mode`` ("high"/"highest",
    "default", "mid"): "<counter>[<epilogue>,any_width]"; B6 at "mid" runs
    its fp32 kernel."""
    base, _, epi = kernel.partition("[")
    kmode = {"highest": "high", "high": "high"}.get(mode, mode)
    if base == "packed_conv_wgrad":
        return f"{base}{'_bf16' if kmode == 'default' else ''}[any_width]"
    return f"{_counter(base, kmode)}[{epi.rstrip(']')},any_width]"


def phase_any_width_bwd_kernels(pk, packed_vjp, pro_gan) -> tuple[list[dict], dict]:
    """B1 "lrelu", B2 "lrelu" and "none", B5 "none" (and "lrelu") and B6 at
    every (C, Cout) of T, T2 and O's backward that the card refused before,
    batch 2, at "high", "default" and "mid" (B6: its fp32 kernel and
    "default") against their twins by phase 17's bounds: fp32 "none"
    NONE_REL of the largest entry, the fp32 rings ("lrelu", B5) 1e-4,
    "default" DEFAULT_BWD_REL, "mid" GRADE_REL, B6 WGRAD_REL; two runs
    bit-equal; each timed beside the bound and the library call (F.conv2d
    with the torch epilogue, after a nearest-2x upsample for B1, with
    avg_pool2d for B5; conv2d_weight for B6). The recompute's bits: at
    O's 48 -> 48 and 24 -> 24 and T's 4 -> 4, "lrelu" on its slab against
    "lrelu" on the forward's tile (0 values differing), its sign mask
    against the "lrelu_norm" forward's (0), and pixel_norm of it against
    that forward. The four Functions at the new pairs on the kernels against
    the same Functions on the twins at "highest", "mid" and "default"."""
    gen = torch.Generator(device="cuda").manual_seed(2525)
    dev, bf, B = "cuda", torch.bfloat16, TRAIN_BATCH

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def conv_w(cout, cin):
        return randn(cout, cin, 3, 3) * math.sqrt(2.0 / (9 * cin))

    def lib_operands(mode, x, w):
        if mode == "default":
            return x.to(bf), w.to(bf)
        return (x, pk._bf16(w)) if mode == "mid" else (x, w)

    rows = {}
    for mode in ANY_BWD_MODES:
        terms = pk.BF16_TERMS.get(mode, 0)
        for kernel, epi, c, cout, h in ANY_BWD_CASES:
            pool, up = kernel == "packed_convpool", kernel == "packed_upconv"
            label = f"{kernel}[{mode},{epi},{c}->{cout}@{h}]"
            x = randn(B, c, h, h)
            x = pro_gan.pixel_norm(x) if up else x
            w = conv_w(cout, c)
            b = 0.1 * randn(cout) if epi == "lrelu" else torch.zeros(cout, device=dev)
            kfn, pfn = getattr(pk, kernel), getattr(pk, f"{kernel}_plain")
            kw = {"epilogue": epi, "mode": mode}

            def fn(x=x, w=w, b=b, kfn=kfn, kw=kw):
                return kfn(x, w, b, **kw)

            def plain(x=x, w=w, b=b, pfn=pfn, kw=kw):
                return pfn(x, w, b, **kw)

            def library(x=x, w=w, b=b, pool=pool, up=up, epi=epi, mode=mode):
                xl, wl = lib_operands(mode, x, w)
                if up:
                    xl = F.interpolate(xl, scale_factor=2.0, mode="nearest")
                y = F.conv2d(xl, wl, b.to(xl.dtype), padding=1).float()
                y = pro_gan.lrelu(y) if epi == "lrelu" else y
                return F.avg_pool2d(y, 2) if pool else y

            pk.reset_launches()
            got = fn()
            launched = {k: v for k, v in pk.narrow_launches.items() if v}
            check_two_runs(label, got, fn())
            want = plain()
            if tuple(got.shape) != tuple(want.shape) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{label}: {tuple(got.shape)} vs {tuple(want.shape)}, or "
                                     "not finite")
            if mode == "default":
                err = check_rel(label, got, want, rel=DEFAULT_BWD_REL)
            elif mode == "mid":
                err = check_rel(label, got, want, rel=GRADE_REL)
            elif epi == "none" and not pool:  # the 3xTF32 kernel
                err = scaled_err(label, got, want, NONE_REL)
            else:  # the fp32 rings
                torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
                err = (got - want).abs().max().item()
            if up:
                flops = 2 * 4 * c * cout * B * 4 * h * h
                nbytes = 4 * (B * c * h * h + B * cout * 4 * h * h + cout) + (
                    4 if mode == "high" else 2) * 16 * c * cout
            else:
                flops = 2 * 9 * c * cout * B * h * h
                nbytes = (4 * (B * c * h * h + B * cout * h * h // (4 if pool else 1) + cout)
                          + (4 if mode == "high" else 2) * 9 * c * cout)
            if mode != "high":
                peak, op_flops = PEAK_BF16_FLOPS, terms * flops
            elif epi == "none" and not pool:
                peak, op_flops = PEAK_TF32_FLOPS, 3 * flops
            else:
                peak, op_flops = PEAK_FP32_FLOPS, flops
            entry = any_width_bwd_entry(f"{kernel}[{epi}]", mode)
            source = kernel + ("" if mode == "high" else "_bf16")
            rows.setdefault(entry, (source, NARROW_SOURCES[kernel], []))[2].append({
                "call": f"{epi} C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h],
                "max_abs_err": err, "max_abs_err_share_of_largest": err / want.abs().max().item(),
                "bit_equal_runs": True, "narrow_launches": launched,
                "ms": cuda_ms(fn, ANY_BWD_ITERS), "plain_ms": cuda_ms(plain, ANY_BWD_ITERS),
                "library_ms": cuda_ms(library, ANY_BWD_ITERS), "flops": flops,
                "op_flops": op_flops, "bytes": nbytes, "peak_flops": peak,
            })
            del x, got, want
        torch.cuda.empty_cache()

    for mode in ("high", "default"):
        for c, cout, h in ANY_BWD_WGRAD:
            label = f"packed_conv_wgrad[{mode},{c}->{cout}@{h}]"
            x, g = pro_gan.lrelu(randn(B, c, h, h)), 0.01 * randn(B, cout, h, h)
            pk.reset_launches()
            got = pk.packed_conv_wgrad(x, g, mode=mode)
            launched = {k: v for k, v in pk.narrow_launches.items() if v}
            again = pk.packed_conv_wgrad(x, g, mode=mode)
            torch.cuda.synchronize()
            if tuple(got.shape) != (cout, c, 3, 3) or differing_bits(got, again):
                raise AssertionError(f"{label}: wrong shape, or two runs differ")
            want = pk.packed_conv_wgrad_plain(x, g, mode=mode)
            err = check_rel(label, got, want, rel=WGRAD_REL)

            def library(x=x, g=g, c=c, cout=cout, mode=mode):
                if mode == "default":
                    x, g = x.to(bf), g.to(bf)
                return torch.nn.grad.conv2d_weight(x, (cout, c, 3, 3), g, padding=1)

            flops = 2 * 9 * c * cout * B * h * h
            entry = any_width_bwd_entry("packed_conv_wgrad", mode)
            rows.setdefault(entry, (entry.split("[")[0], "probgan_tpu/ops/pallas_packed.py:558",
                                    []))[2].append({
                "call": f"C{c}->Cout{cout}@{h}", "shape_in": [B, c, h, h], "max_abs_err": err,
                "max_abs_err_share_of_largest": err / want.abs().max().item(),
                "bit_equal_runs": True, "narrow_launches": launched,
                "ms": cuda_ms(lambda x=x, g=g, mode=mode: pk.packed_conv_wgrad(x, g, mode=mode),
                              ANY_BWD_ITERS),
                "plain_ms": cuda_ms(lambda x=x, g=g, mode=mode:
                                    pk.packed_conv_wgrad_plain(x, g, mode=mode), iters=2,
                                    warmup=1),
                "library_ms": cuda_ms(library, ANY_BWD_ITERS), "flops": flops,
                "op_flops": 3 * flops if mode == "high" else flops,
                "bytes": 4 * (B * h * h * (c + cout) + 9 * c * cout),
                "peak_flops": PEAK_TF32_FLOPS if mode == "high" else PEAK_BF16_FLOPS,
            })
            del x, g, got, again, want
    torch.cuda.empty_cache()

    # -- the recompute's bits: "lrelu" on its slab vs the forward's tile
    recompute = {}
    for mode in ANY_BWD_MODES:
        for c, cout, h in ANY_BWD_RECOMPUTE:
            x = pro_gan.pixel_norm(randn(B, c, h, h))
            w, b = conv_w(cout, c), 0.1 * randn(cout)
            fwd = pk.packed_conv(x, w, b, "lrelu_norm", mode=mode)
            u = pk.packed_conv(x, w, b, "lrelu", mode=mode)
            tile = pk.norm_tile(cout)
            u_tile = pk.packed_conv(x, pk.pad_cout(w, tile), pk.pad_cout(b, tile), "lrelu",
                                    mode=mode)[:, :cout]
            torch.cuda.synchronize()
            rec = {"slab": pk._pool_slab(pk.sliced_cout(cout)), "forward_tile": tile,
                   "slab_vs_tile_differing": differing_bits(u, u_tile.contiguous()),
                   "sign_mask_differing": int(((u >= 0) != (fwd >= 0)).sum().item()),
                   "pixel_norm_vs_forward_differing": differing_bits(pro_gan.pixel_norm(u), fwd),
                   "pixel_norm_vs_forward_rel": ((pro_gan.pixel_norm(u) - fwd).abs().max()
                                                 / fwd.abs().max()).item()}
            recompute[f"{mode},{c}->{cout}@{h}"] = rec
            print(f"  recompute packed_conv[{mode},lrelu] {c}->{cout}@{h} on a slab of "
                  f"{rec['slab']} vs the forward's tile of {tile}: {rec['slab_vs_tile_differing']} "
                  f"values differ; sign mask vs the lrelu_norm forward: "
                  f"{rec['sign_mask_differing']} differ; torch pixel_norm of it vs the forward: "
                  f"{rec['pixel_norm_vs_forward_rel']:.3g} of the largest entry "
                  f"({rec['pixel_norm_vs_forward_differing']} values' bits differ: another "
                  "order of the sum of squares)")
            if rec["slab_vs_tile_differing"] or rec["sign_mask_differing"]:
                raise AssertionError(f"recompute at {mode}, {c}->{cout}@{h}: {rec}")
            if rec["pixel_norm_vs_forward_rel"] > (1e-4 if mode == "high" else GRADE_REL):
                raise AssertionError(f"recompute at {mode}, {c}->{cout}@{h}: pixel_norm of it "
                                     f"is not the forward: {rec}")
            del x, fwd, u, u_tile
    torch.cuda.empty_cache()

    # -- the four Functions at the new pairs, kernels vs twins
    def vjp(fn, x, w, b, cot, mode):
        x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
        y = fn(x, w, b, mode=mode)
        return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))

    fn_errs = {}
    for mode in ("highest", "mid", "default"):
        for name, c, cout, h, norm_in in ANY_BWD_FUNCTIONS:
            x = randn(B, c, h, h)
            x = pro_gan.pixel_norm(x) if norm_in else pro_gan.lrelu(x)
            w, b = conv_w(cout, c), 0.1 * randn(cout)
            fn = getattr(packed_vjp, name)
            with torch.no_grad():
                cot = torch.randn(fn(x, w, b, mode=mode).shape, device=dev, generator=gen)
            pk.reset_launches()
            got = vjp(fn, x, w, b, cot, mode)
            launched = {k: v for k, v in pk.narrow_launches.items() if v}
            with swap_in_plain_twins(pk, PACKED_KERNELS):
                want = vjp(fn, x, w, b, cot, mode)
            rel = GRAD_REL if mode == "highest" else DEFAULT_FN_REL
            flips = int(((got[0] >= 0) != (want[0] >= 0)).sum().item())
            fn_errs[f"{name}[{mode}] {c}->{cout}@{h}"] = errs = [
                check_rel(f"packed_vjp.{name}[{mode}] {c}->{cout} {part} vs the twins", g, t,
                          flips=part == "dx", rel=rel, flip_share=DEFAULT_FN_FLIP_SHARE,
                          flip_rel=DEFAULT_FN_FLIP_REL)
                for part, g, t in zip(("y", "dx", "dw", "db"), got, want)]
            print(f"  packed_vjp.{name}[{mode}] C{c}->Cout{cout}@{h} vs the same Function on "
                  f"the twins: y {errs[0]:.3g}  dx {errs[1]:.3g}  dw {errs[2]:.3g}  db "
                  f"{errs[3]:.3g} of the largest entry; output signs differing {flips}; "
                  f"narrow launches {launched}")
            del x, cot, got, want
    pk.reset_launches()
    torch.cuda.empty_cache()
    entries = assemble_conv_rows([(name, src, rep, calls)
                                  for name, (src, rep, calls) in rows.items()], B)
    return entries, {"recompute": recompute, "functions_vs_twins_y_dx_dw_db": fn_errs}


def phase_any_width_train(pk, pro_gan, train_mod, tree_mod) -> tuple[dict, dict]:
    """progan_train_step(packed_g=True, packed_d=True) at T, T2 and O, 1024²,
    stage 8, batch 2, remat: at "highest" and at "default" with dtype bf16,
    and at "mid" at O. Each run: the launches a step (the counters, and the
    calls the card took only since this item by entry and (C, Cout)); the
    raw gradients on the kernels against the same step on the plain twins
    by phases 9 and 13 (every leaf within STEP_GRAD_REL of its largest
    entry) and 14 ("default": relative L2 DEFAULT_GRAD_L2, cosine
    DEFAULT_GRAD_COS), beside the step's spread against itself (cuDNN
    deterministic on and off); finite losses; steps/s, p50 and peak memory
    over ANY_BWD_TIMED_STEPS steps."""
    tree_leaves = tree_mod.tree_leaves
    B, stage, alpha = TRAIN_BATCH, TRAIN_STAGE, 0.5
    kw = dict(packed_d=True, packed_g=True, remat=True)
    counts, out = {}, {}
    for name, modes in ANY_BWD_STEP_MODES.items():
        cfg = pro_gan.ProGANConfig(resolution=1024, fmap_base=ANY_WIDTH_CONFIGS[name])
        if ([cfg.nf(s) for s in (6, 7, 8)] != ANY_WIDTH_NF[name]
                or pro_gan.packed_start_stage(cfg, stage) != 6):
            raise AssertionError(f"{name}: stages 6-8 are not {ANY_WIDTH_NF[name]} on the kernels")
        state = train_mod.progan_init_state(0, cfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2323)
        real = torch.tanh(torch.randn((B, 1024, 1024, 3), device="cuda", generator=gen))
        z = torch.randn((B, cfg.latent_dim), device="cuda", generator=gen)
        rec = {"fmap_base": ANY_WIDTH_CONFIGS[name], "widths_6_8": ANY_WIDTH_NF[name],
               "packed_d_stages": pro_gan.packed_d_stage_count(cfg, stage, "highest")}
        for mode in modes:
            dtype = torch.bfloat16 if mode == "default" else torch.float32
            # -- the gradients on the kernels against the twins, and the spread
            seen = {}
            pk.reset_launches()
            with deterministic_cudnn(), any_width_bwd_spy(pk, seen):
                d_k, g_k, m_k = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                       packed_train_mode=mode, **kw)
            step_counts = {k: v for k, v in {**pk.launches, **pk.epilogue_launches}.items() if v}
            step_narrow = {k: v for k, v in pk.narrow_launches.items() if v}
            d_s, g_s, _ = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                 packed_train_mode=mode, **kw)
            with swap_in_plain_twins(pk, PACKED_KERNELS):
                d_t, g_t, m_t = train_mod.progan_grads(state, real, z, alpha, cfg, stage,
                                                       packed_train_mode=mode, **kw)
            spread = {"d": vector_agreement(d_s, d_k, tree_leaves),
                      "g": vector_agreement(g_s, g_k, tree_leaves)}
            if not seen:
                raise AssertionError(f"the step at {name}, {mode}: no call at this item's widths")
            if mode == "default":
                check_metrics(f"step at {name}, \"default\", vs the plain twins", m_k, m_t,
                              STEP_LOSS_RTOL, DEFAULT_LOGIT_ATOL)
                vs = {"d": vector_agreement(d_k, d_t, tree_leaves),
                      "g": vector_agreement(g_k, g_t, tree_leaves)}
                text = (f"relative L2 {vs['d']['l2']:.3g} / {vs['g']['l2']:.3g}, cos "
                        f"{vs['d']['cos']:.6f} / {vs['g']['cos']:.6f}")
                failed = [net for net, v in vs.items()
                          if not (v["l2"] <= DEFAULT_GRAD_L2 and v["cos"] >= DEFAULT_GRAD_COS)]
            else:
                check_metrics(f"step at {name}, {mode}, vs the plain twins", m_k, m_t,
                              STEP_LOSS_RTOL)
                vs = {"d": vector_agreement(d_k, d_t, tree_leaves),
                      "g": vector_agreement(g_k, g_t, tree_leaves)}
                text = (f"worst leaf {vs['d']['worst_leaf']:.3g} / {vs['g']['worst_leaf']:.3g} "
                        "of its largest entry")
                failed = [net for net, v in vs.items() if v["worst_leaf"] > STEP_GRAD_REL]
            print(f"  progan_grads at {name}, {mode}: D / G gradients on the kernels vs the "
                  f"plain twins {text}; the kernels' step against itself with cuDNN "
                  f"deterministic off: worst leaf {spread['d']['worst_leaf']:.3g} / "
                  f"{spread['g']['worst_leaf']:.3g}, relative L2 {spread['d']['l2']:.3g} / "
                  f"{spread['g']['l2']:.3g}; calls at this item's widths "
                  f"{ {f'{k[0]} {k[1]}': v for k, v in seen.items()} }")
            if failed:
                raise AssertionError(f"gradients at {name}, {mode}, vs the twins: {vs} (the "
                                     f"kernels' own spread {spread})")
            del d_k, g_k, d_s, g_s, d_t, g_t
            torch.cuda.empty_cache()
            # -- timed steps
            st, _ = train_mod.progan_train_step(state, real, z, alpha, cfg, stage, dtype=dtype,
                                                packed_train_mode=mode, **kw)
            torch.cuda.synchronize()
            del st
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            pk.reset_launches()
            timed_seen, times, losses = {}, [], []
            st = state
            with any_width_bwd_spy(pk, timed_seen):
                for i in range(ANY_BWD_TIMED_STEPS):
                    t0 = time.perf_counter()
                    st, m = train_mod.progan_train_step(st, real, z, 0.5 if i % 2 == 0 else 1.0,
                                                        cfg, stage, dtype=dtype,
                                                        packed_train_mode=mode, **kw)
                    losses.append({k: float(v) for k, v in m.items()})  # reads the card
                    times.append(time.perf_counter() - t0)
            if not all(math.isfinite(v) for m in losses for v in m.values()):
                raise AssertionError(f"a train step at {name}, {mode}, is not finite: {losses}")
            if timed_seen != {k: v * ANY_BWD_TIMED_STEPS for k, v in seen.items()}:
                raise AssertionError(f"the timed steps at {name}, {mode} launched {timed_seen} "
                                     f"at this item's widths; one step {seen}")
            for (entry, _), n in timed_seen.items():
                counts[entry] = counts.get(entry, 0) + n
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            per_step_ms = sorted(t * 1e3 for t in times)
            rec[f"{mode} {'bf16' if dtype == torch.bfloat16 else 'fp32'}"] = {
                "steps_per_s": ANY_BWD_TIMED_STEPS / sum(times), "step_s": times,
                "p50_ms_per_step": float(np.median(per_step_ms)), "peak_memory_gb": peak_gb,
                "losses": losses, "launches_per_step": step_counts,
                "narrow_launches_per_step": step_narrow,
                "new_width_calls_per_step": {f"{k[0]} {k[1]}": v for k, v in seen.items()},
                "vs_twins": vs, "spread_cudnn_deterministic_off": spread,
            }
            print(f"  progan_train_step at {name}, {mode}, "
                  f"{'bf16' if dtype == torch.bfloat16 else 'fp32'}: "
                  f"{ANY_BWD_TIMED_STEPS / sum(times):.3f} steps/s, p50 "
                  f"{float(np.median(per_step_ms)):.1f} ms, peak {peak_gb:.2f} GB; launches a "
                  f"step {step_counts}; narrow {step_narrow}")
            del st
            torch.cuda.empty_cache()
        out[name] = rec
        del state, real
        torch.cuda.empty_cache()
    return counts, out


def phase_any_width_trainer(pk, cli_train_image, image_checkpoint_mod, tree_mod) -> dict:
    """The image trainer CLI at 512², fmap_base 512, fmap_max 64 (stage 7:
    8 -> 4), with --fast (bf16 kernels, "default") and then with --packed_g
    --packed_mode high (fp32): stages 0-7, stage 7's G backward through B1
    "lrelu" 8 -> 4, B5 "none" 4 -> 8, B2 "lrelu" and "none" 4 -> 4 and B6;
    each run ends, its losses are finite and its checkpoint loads in the
    port."""
    out = {}
    for label, extra in (("--fast", ["--fast"]),
                         ("--packed_g high", ["--packed_g", "--packed_mode", "high"])):
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = os.path.join(tmp, "any_width_bwd")
            pk.reset_launches()
            seen, log = {}, io.StringIO()
            t0 = time.perf_counter()
            with any_width_bwd_spy(pk, seen), contextlib.redirect_stdout(log):
                rc = cli_train_image.main([*ANY_BWD_TRAINER, *extra, "--output_dir", out_dir])
            wall_s = time.perf_counter() - t0
            if rc != 0 or "Training complete!" not in log.getvalue():
                raise AssertionError(f"image trainer {label} at fmap_base 512 exited {rc}:\n"
                                     f"{log.getvalue()}")
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            cfg, g_params, d_params = image_checkpoint_mod.load_image_checkpoint(
                os.path.join(out_dir, "image_checkpoint.msgpack"))
        calls = {f"{k[0]} {k[1]}": v for k, v in seen.items()}
        kinds = {any_width_bwd_kind(entry) for entry, _ in seen}
        want_kinds = {"packed_upconv[lrelu]", "packed_conv[lrelu]", "packed_conv[none]",
                      "packed_convpool[none]", "packed_conv_wgrad"}
        if not want_kinds <= kinds:
            raise AssertionError(f"image trainer {label}: stage 7's backward did not reach "
                                 f"{want_kinds - kinds} at 8 -> 4: {calls}")
        if ([m["stage"] for m in metrics] != list(range(8)) or any(
                not (math.isfinite(m["d_loss"]) and math.isfinite(m["g_loss"]))
                for m in metrics)):
            raise AssertionError(f"image trainer {label} at fmap_base 512: metrics {metrics}")
        if (cfg.resolution != 512 or cfg.nf(7) != 4 or not d_params
                or not all(torch.isfinite(t).all() for t in tree_mod.tree_leaves(g_params))):
            raise AssertionError(f"image trainer {label} at fmap_base 512 wrote a checkpoint "
                                 "the port does not load as trained")
        stage_s = {m["stage"]: m["seconds"] for m in metrics}
        out[label] = {"argv": [*ANY_BWD_TRAINER, *extra], "wall_s": wall_s,
                      "seconds_per_stage": stage_s, "new_width_calls": calls,
                      "losses": [(m["d_loss"], m["g_loss"]) for m in metrics]}
        print(f"  image trainer CLI {label} at 512², fmap_base 512, fmap_max 64: stages 0-7 "
              f"in {wall_s:.1f} s (stage 7 {stage_s[7]:.3f} s); calls at this item's widths "
              f"{calls}; finite losses; the checkpoint loads in the port")
    return out


def phase_any_width_bwd(pk, packed_vjp, pro_gan, engine_mod, train_mod, cli_train_image,
                        image_checkpoint_mod, tree_mod) -> tuple[list[dict], dict]:
    """Phase 23 whole: the kernels, the recompute and the Functions at the
    new widths, then the train step at T, T2 and O and the trainer CLI; each
    kernel entry's launches those of the timed train steps; an entry that no
    step launches (B5 "lrelu", D's, at these widths) stays out of the
    kernels line, under "off_path_kernels". Last, what stays refused:
    generate at T under PROBGAN_STAGE_FUSED=1 raises before any launch,
    naming B.a.2.4."""
    entries, out = phase_any_width_bwd_kernels(pk, packed_vjp, pro_gan)
    counts, out["train"] = phase_any_width_train(pk, pro_gan, train_mod, tree_mod)
    out["trainer_cli"] = phase_any_width_trainer(pk, cli_train_image, image_checkpoint_mod,
                                                 tree_mod)
    for k in entries:
        k["launches"] = counts.get(k["name"], 0)
    out["off_path_kernels"] = [k for k in entries if not k["launches"]]
    entries = [k for k in entries if k["launches"]]
    need = {any_width_bwd_entry(f"{kernel}[{epi}]", mode) for mode in ANY_BWD_MODES
            for kernel, epi, *_ in ANY_BWD_CASES if epi != "lrelu" or kernel != "packed_convpool"}
    need |= {any_width_bwd_entry("packed_conv_wgrad", m) for m in ("high", "default")}
    missing = need - {k["name"] for k in entries}
    if missing:
        raise AssertionError(f"{sorted(missing)} were not launched on their main path")
    # the stage-fused kernels keep Cout 8-64 from C % 8: refused up front
    cfg = pro_gan.ProGANConfig(resolution=1024, fmap_base=ANY_WIDTH_CONFIGS["T"])
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=23)
    z = engine.sample_latents(2)
    pk.reset_launches()
    with env(PROBGAN_STAGE_FUSED="1"):
        try:
            engine.generate(z)
        except ValueError as e:
            if "ROADMAP.md, B.a.2.4" not in str(e):
                raise AssertionError(f"PROBGAN_STAGE_FUSED=1 at T raised {e!r}") from e
            out["stage_fused_refusal"] = str(e)
            print(f"  generate at T under PROBGAN_STAGE_FUSED=1: ValueError: {e}")
        else:
            raise AssertionError("PROBGAN_STAGE_FUSED=1 at T: the card took it")
    if any(pk.launches.values()):
        raise AssertionError(f"the refused stage-fused call launched {dict(pk.launches)}")
    del engine
    torch.cuda.empty_cache()
    return entries, out


ANY_BWD_HEADING = ("phase 23: any-width backward: B1 \"lrelu\", B2 \"lrelu\"/\"none\", B5 and B6 at "
                   "the new widths of T, T2 and O vs their twins at \"high\", \"default\" and "
                   "\"mid\", the recompute's bits, the four Functions; progan_train_step at T, "
                   "T2 and O (\"highest\", \"default\" bf16, \"mid\" at O); the image trainer "
                   "at 512² / fmap_base 512 with --fast and --packed_g; the stage-fused refusal")


def phase_line(text: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    print(f"{text} [{time.perf_counter() - _T0:.1f} s]")


def phase_any_width(pk, pro_gan, engine_mod, cli_train, image_checkpoint_mod,
                    tree_mod) -> tuple[list[dict], dict]:
    """Phase 22 whole: the kernels at the new widths, then the path, each
    kernel entry's launches those of the path's generate calls."""
    entries, out = phase_any_width_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    counts, out["path"] = phase_any_width_path(pk, pro_gan, engine_mod, cli_train,
                                               image_checkpoint_mod, tree_mod)
    for k in entries:
        k["launches"] = counts.get(k["name"], 0)
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    torch.cuda.empty_cache()
    return entries, out


ANY_WIDTH_HEADING = ("phase 22: any width up to 64: B1 \"lrelu_norm\", B2 \"lrelu_norm\" and B3 "
                     "at the new widths of T, T2 and O (fmap_base 1024, 512, 3072 at 1024²) vs "
                     "their twins at \"high\", \"default\" and \"mid\", batch 2 and 8; "
                     "generate at T and O at \"high\", \"fast\" and G's \"mid\", latent_walk, "
                     "the stage-fused refusal, the image trainer at 512² / fmap_base 512")


def main() -> int:
    args = sys.argv[1:]
    if args not in ([], ["--phase", "22"], ["--phase", "23"]):
        print("usage: python3 chip_smoke.py [--phase 22 | --phase 23]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from probgan_tpu_torch.cli import infer as cli_infer
    from probgan_tpu_torch.cli import train as cli_train
    from probgan_tpu_torch.cli import train_image as cli_train_image
    from probgan_tpu_torch.core import checkpoint as checkpoint_mod
    from probgan_tpu_torch.core import image_checkpoint as image_checkpoint_mod
    from probgan_tpu_torch.core import train_state as train_state_mod
    from probgan_tpu_torch.core import tree as tree_mod
    from probgan_tpu_torch.engine import image as engine_mod
    from probgan_tpu_torch.engine import inference as inference_mod
    from probgan_tpu_torch.engine import train as train_mod
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.ops import _build
    from probgan_tpu_torch.ops import image as image_ops
    from probgan_tpu_torch.ops import packed as pk
    from probgan_tpu_torch.ops import packed_vjp
    from probgan_tpu_torch.ops import rank as rank_ops
    from probgan_tpu_torch.ops import rank_fused as rf
    from probgan_tpu_torch.utils.demo_checkpoint import make_image_checkpoint, make_kg_checkpoint

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase_line("phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build(ptxas_info=True)
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")
    bf16_ring = bf16_ring_line(pk, logs)
    if args == ["--phase", "23"]:  # phase 23 alone, after the build
        phase_line(ANY_BWD_HEADING)
        any_bwd_kernels, any_bwd = phase_any_width_bwd(
            pk, packed_vjp, pro_gan, engine_mod, train_mod, cli_train_image,
            image_checkpoint_mod, tree_mod)
        print(card_line())
        print(json.dumps({"kernels": any_bwd_kernels, "any_width_backward": any_bwd,
                          "card": card}, allow_nan=False))
        return 0
    if args:  # phase 22 alone, after the build
        phase_line(ANY_WIDTH_HEADING)
        any_width_kernels, any_width = phase_any_width(pk, pro_gan, engine_mod, cli_train,
                                                       image_checkpoint_mod, tree_mod)
        print(card_line())
        print(json.dumps({"kernels": any_width_kernels, "any_width": any_width, "card": card},
                         allow_nan=False))
        return 0

    phase_line("phase 2: generator kernels vs plain twins (batch 2, main-path shapes)")
    kernels = phase_kernels(pk, pro_gan)
    torch.cuda.empty_cache()

    phase_line("phase 3: main path, ImageGANEngine.generate at 1024²")
    counts, main = phase_main_path(pk, pro_gan, engine_mod)
    torch.cuda.empty_cache()

    phase_line("phase 4: discriminator and denorm kernels vs plain twins (path I's shapes)")
    kernels += phase_d_kernels(pk, image_ops, pro_gan)
    torch.cuda.empty_cache()

    phase_line("phase 5: path I, ImageGANEngine.score / latent_walk / use_pallas / "
          "generate_images from a checkpoint at 1024²")
    score_counts, score_path = phase_score_path(
        pk, image_ops, pro_gan, engine_mod, image_checkpoint_mod, cli_infer,
        make_image_checkpoint)
    counts.update(score_counts)
    torch.cuda.empty_cache()

    phase_line(f"phase 6: rank kernels vs plain twins (N = {KG_ENTITIES:,}, D = {KG_DIM})")
    kernels += phase_rank_kernels(rf, rank_ops)
    torch.cuda.empty_cache()

    phase_line(f"phase 7: KG path and path II (PROBGAN_BF16_RANK=1), InferenceEngine at "
          f"N = {KG_ENTITIES:,}")
    kg_counts, kg = phase_kg_path(rf, inference_mod, checkpoint_mod, cli_infer,
                                  make_kg_checkpoint)
    counts.update(kg_counts)
    torch.cuda.empty_cache()

    phase_line("phase 8: training kernels vs plain twins (batch 2, the 1024² train step's shapes)")
    kernels += phase_train_kernels(pk, packed_vjp, pro_gan)
    torch.cuda.empty_cache()

    phase_line("phase 9: path III, progan_train_step at 1024² and kg_train_step at "
          f"N = {KG_ENTITIES:,}")
    train_counts, train = phase_train_path(pk, pro_gan, train_mod, train_state_mod, tree_mod)
    # the earlier paths' entries keep the counts of their own runs
    for name in ("packed_conv_wgrad", "packed_upconv[lrelu]", "packed_conv[none]",
                 "packed_convpool[none]"):
        counts[name] = train_counts[name]
    torch.cuda.empty_cache()

    phase_line("phase 10: stage-fused generator kernels vs plain twins and the two-kernel pair "
          "(batch 2, the 1024² generator's shapes)")
    kernels += phase_fused_kernels(pk, pro_gan)
    torch.cuda.empty_cache()

    phase_line("phase 11: path IV under PROBGAN_STAGE_FUSED=1: generate, latent_walk and "
          f"PROBGAN_PACKED=0 at 1024², the image trainer CLI at 1024², the KG trainer CLI at "
          f"N = {KG_ENTITIES:,}")
    fused_counts, fused_path = phase_fused_path(pk, rf, pro_gan, engine_mod, cli_infer,
                                                cli_train, inference_mod)
    counts.update(fused_counts)
    torch.cuda.empty_cache()

    phase_line("phase 12: the grades: kernel mode \"default\" of B1, B2 and B3 vs their bf16 twins "
          "(batch 2); generate at 1024² at \"high\", \"fast\", None and bf16; score at None")
    kernels += phase_grades_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    grade_counts, grades = phase_grades_path(pk, pro_gan, engine_mod)
    counts.update(grade_counts)
    torch.cuda.empty_cache()

    phase_line("phase 13: kernel mode \"mid\" of B1, B2, B3 and B5 vs their twins; score at "
          "\"fast\", progan_train_step at packed_train_mode \"mid\" and generate at G's "
          "\"mid\" and \"default+mid\" at 1024²")
    kernels += phase_mid_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    score_mid_counts, score_mid = phase_mid_score(pk, pro_gan, engine_mod)
    torch.cuda.empty_cache()
    train_mid_counts, train_mid = phase_mid_train(pk, pro_gan, train_mod, tree_mod)
    torch.cuda.empty_cache()
    gen_mid_counts, gen_mid = phase_mid_generate(pk, pro_gan, engine_mod)
    # each "mid" entry's launches: score's for D's forward kernels, generate's
    # for B3, the train step's for the rest
    counts.update({k: v for k, v in train_mid_counts.items() if "_mid" in k})
    counts["packed_conv_rgb_mid"] = gen_mid_counts["packed_conv_rgb_mid"]
    for k in ("packed_conv_mid[lrelu]", "packed_convpool_mid[lrelu]"):
        counts[k] = score_mid_counts[k]
    torch.cuda.empty_cache()

    phase_line("phase 14: kernel mode \"default\" of the backward (B1 \"lrelu\", B2 \"lrelu\"/"
          "\"none\", B5, B6) vs their twins; progan_train_step at packed_train_mode "
          "\"default\" and dtype bf16 at 1024²; the image trainer CLI with --fast")
    kernels += phase_default_kernels(pk, packed_vjp, pro_gan)
    torch.cuda.empty_cache()
    train_default_counts, train_default = phase_default_train(pk, pro_gan, train_mod, tree_mod)
    torch.cuda.empty_cache()
    fast_cli = phase_fast_cli(pk, cli_train, image_checkpoint_mod, tree_mod)
    # the new entries' launches: the train step's at "default"
    counts.update({k: train_default_counts[k] for k in (
        "packed_upconv_bf16[lrelu]", "packed_conv_bf16[lrelu]", "packed_conv_bf16[none]",
        "packed_convpool_bf16[lrelu]", "packed_convpool_bf16[none]", "packed_conv_wgrad_bf16")})
    torch.cuda.empty_cache()

    phase_line("phase 15: kernel modes \"default\" and \"mid\" of the stage-fused kernels B10/B11 "
          "vs their twins and the bf16 pair; under PROBGAN_STAGE_FUSED=1 generate at "
          "\"fast\", None, \"mid\" and \"default+mid\", latent_walk, generate_images and the "
          "train step at \"default\"")
    kernels += phase_fused_bf16_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    fused_bf16_counts, fused_bf16 = phase_fused_bf16_path(
        pk, pro_gan, engine_mod, cli_infer, image_checkpoint_mod, make_image_checkpoint,
        train_mod, tree_mod)
    # the entries' launches: generate's at "fast" ("default") and G's "mid"
    counts.update(fused_bf16_counts)
    torch.cuda.empty_cache()

    phase_line("phase 16: the narrow generator N (fmap_base 2048, fmap_max 256 at 1024²): B1, "
          "B2, B3 and B5 at 16 and 8 channels vs their twins at \"high\", \"default\" and "
          "\"mid\"; generate at \"high\", \"fast\", None and G's \"mid\", latent_walk, "
          "score at \"high\" and \"fast\"; what the card still refuses at N")
    narrow_kernels, narrow = phase_narrow_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    narrow_counts, narrow_path = phase_narrow_path(pk, pro_gan, engine_mod)
    narrow["path"] = narrow_path
    torch.cuda.empty_cache()
    narrow["refusals"] = phase_narrow_refusals(pk)
    torch.cuda.empty_cache()

    phase_line("phase 17: the narrow backward at N: B2 and B5 \"none\" at slabs of 16 and 8 and "
               "B6 at N's shapes vs their twins at \"high\", \"default\" and \"mid\", the four "
               "Functions; progan_train_step at N at \"highest\", \"mid\", \"default\" and "
               "bf16, save and resume; the image trainer CLI with --fast at N")
    narrow_bwd_kernels, narrow_bwd = phase_narrow_bwd_kernels(pk, packed_vjp, pro_gan)
    torch.cuda.empty_cache()
    narrow_bwd_counts, narrow_bwd["train"] = phase_narrow_train(pk, pro_gan, train_mod,
                                                                train_state_mod, tree_mod)
    torch.cuda.empty_cache()
    narrow_bwd["trainer_cli"] = phase_narrow_cli(pk, cli_train, image_checkpoint_mod, tree_mod)
    # each entry's launches: phase 16's serving runs, the N train step's for
    # the backward's entries and B5 "default" at 16 channels; an
    # instantiation no path at N launches (B5 at "default" serving, B5
    # "none" at a slab of 8) stays out of the kernels line
    counts.update(narrow_counts)
    counts.update(narrow_bwd_counts)
    narrow_all = narrow_kernels + narrow_bwd_kernels
    narrow["off_path_kernels"] = [k for k in narrow_all if k["name"] not in counts]
    kernels += [k for k in narrow_all if k["name"] in counts]
    torch.cuda.empty_cache()

    phase_line("phase 18: the stage-fused kernels at N: B10 and B11 at 16 and 8 channels vs "
               "the pair, their twins and themselves at \"high\", \"default\" and \"mid\"; "
               "under PROBGAN_STAGE_FUSED=1 and =0 generate at \"high\", \"fast\", None, "
               "G's \"mid\" and \"default+mid\", latent_walk at stage 7, generate_images, "
               "progan_train_step at \"default\" and \"highest\" and the image trainer's "
               "--fast at N")
    fused_narrow_kernels, fused_narrow = phase_narrow_fused_kernels(pk, pro_gan)
    torch.cuda.empty_cache()
    fused_narrow_counts, fused_narrow["path"] = phase_narrow_fused_path(
        pk, pro_gan, engine_mod, cli_infer, cli_train, image_checkpoint_mod,
        make_image_checkpoint, train_mod, tree_mod)
    # each entry's launches: its width's narrow launches over the path's runs;
    # B10 at 8 channels is on no path at N (its stage 8 is always the final one)
    counts.update(fused_narrow_counts)
    fused_narrow["off_path_kernels"] = [k for k in fused_narrow_kernels
                                        if k["name"] not in counts]
    kernels += [k for k in fused_narrow_kernels if k["name"] in counts]
    torch.cuda.empty_cache()

    phase_line(f"phase 19: entity-table TP: B4 rank_topk_local at nvalid 0 to a shard's "
               f"rows vs its twin; {TP_RANKS} ranks on one card (gloo) serving "
               f"InferenceEngine(mesh=\"auto\") at N = {KG_ENTITIES:,}, {TP_UNEVEN:,} and "
               f"{TP_SMALL}; the CLI under torch.distributed.run --mesh auto")
    kernels.append(phase_local_kernels(rf, rank_ops))
    torch.cuda.empty_cache()
    tp_counts, tp_path = phase_tp_path(rf, inference_mod, checkpoint_mod, cli_infer,
                                       make_kg_checkpoint)
    counts.update(tp_counts)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    torch.cuda.empty_cache()

    phase_line(f"phase 20: data parallelism for the image family: {DP_RANKS} ranks on one card "
               "(gloo) serving ImageGANEngine(mesh=\"auto\") at 1024² at \"high\" and "
               "\"fast\", dp_progan_train_step at \"default\" and \"highest\", and the CLIs "
               "under torch.distributed.run --mesh auto")
    dp_path = phase_dp_path(pk, pro_gan, engine_mod, train_mod, tree_mod, image_checkpoint_mod,
                            cli_infer, cli_train_image, make_image_checkpoint)
    torch.cuda.empty_cache()

    phase_line(f"phase 21: the KG train state row-sharded: the trainer CLI under "
               f"torch.distributed.run --mesh auto at N = {TP_UNEVEN:,}; {TP_RANKS} ranks on one "
               f"card (gloo), mesh (1, 2): kg_train_step at N = {TP_UNEVEN:,} and "
               f"{KG_TP_SCALE['full_n']:,} (full softmax), kg_eval_hits, cli.infer --mesh auto "
               f"on the trained checkpoint; {KG_TP_DP_RANKS} ranks, mesh (2, 2): a step at "
               f"N = {KG_TP_SCALE['dp_n']:,}")
    kg_tp_counts, kg_tp_path = phase_kg_tp_path(rf, cli_train, cli_infer)
    entry = next(k for k in kernels if k["name"] == "rank_topk_local")
    entry["launches_kg_tp_serving"] = kg_tp_counts["rank_topk_local"]
    if entry["launches_kg_tp_serving"] < 1:
        raise AssertionError("rank_topk_local was not launched serving the mesh-trained KG")
    torch.cuda.empty_cache()

    phase_line(ANY_WIDTH_HEADING)
    any_width_kernels, any_width = phase_any_width(pk, pro_gan, engine_mod, cli_train,
                                                   image_checkpoint_mod, tree_mod)
    kernels += any_width_kernels
    torch.cuda.empty_cache()

    phase_line(ANY_BWD_HEADING)
    any_bwd_kernels, any_bwd = phase_any_width_bwd(pk, packed_vjp, pro_gan, engine_mod,
                                                   train_mod, cli_train_image,
                                                   image_checkpoint_mod, tree_mod)
    kernels += any_bwd_kernels

    phase_line("phase 24: phases 1-23 done; the kernels line and the result:")
    print(card_line())
    print(json.dumps({"kernels": kernels, "main_path": main, "score_path": score_path,
                      "kg_path": kg, "train_path": train, "fused_path": fused_path,
                      "grades": grades, "mid": {"score": score_mid, "train": train_mid,
                                                "generate": gen_mid},
                      "default_backward": {"train": train_default, "fast_cli": fast_cli},
                      "fused_bf16": fused_bf16, "narrow": narrow,
                      "narrow_backward": narrow_bwd, "narrow_fused": fused_narrow,
                      "tp_path": tp_path, "dp_path": dp_path, "kg_tp_path": kg_tp_path,
                      "any_width": any_width, "any_width_backward": any_bwd,
                      "bf16_ring": bf16_ring,
                      "card": card},
                     allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
