#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- card name and power limit (nvidia-smi), build of every CUDA
   source in src/repro_torch/csrc with nvcc (one process per source, in
   parallel), the registers / shared memory / spills ptxas reports for
   every instantiation (and its warnings about the wgmma kernel), and the
   count of HGMMA (tensor-core wgmma) instructions in the SASS of K5's
   tensor-core library (cuobjdump; 0 fails the run);
2. kernels -- each kernel (K1-K4) against its plain PyTorch version on the
   card: a sweep of tile sizes and dim blocks on 1/64-quantized tiles
   (counts, skipped and mask must be equal); K1's own sweep (``K1_CASES``:
   K1's two epilogues of ``csrc/distance_tile_counts.cu``, per pair and the
   fused count chunk step, against their plain versions and against K1's
   earlier ``tile_eval.cuh`` kernel, all with ``==``, each on the full
   grid, on one CTA and on a grid whose CTA ranges end on run changes of
   pair_a; and K1 at T=64 x 384 dims, staged in slices, timed beside the
   earlier kernel); K2's sweep (``K2_CASES``: K1's cases and cases with
   many hits whose far pairs break SHORTC after the first block; K2 per
   pair -- counts, skipped, mask -- against its plain version and K2's
   earlier kernel, and the fused indexed pairs step from five states of
   the pair buffer against ``tile_pair_pairs_compact_plain``: the whole
   buffer, offset and max_chunk_hits, all with ``==`` on the same three
   grids); the dense sweep (``DENSE_CASES``: the three epilogues
   of ``csrc/dense_tile_fused.cu`` -- K3 / K4 per pair, the dense count
   chunk step, the dense pairs chunk step from five states of the pair
   buffer -- against their plain versions, and per pair against K3 / K4's
   earlier ``tile_eval.cuh`` kernel, all with ``==`` on the same three
   grids); then the main path's own chunks at full width (equal up to the
   stated eps-boundary tolerance), with torch.profiler device times of
   the kernel, the plain version and one PyTorch yardstick, and the bound
   the card could reach on the same work over the data's real dimensions;
   K1-K4 beside their earlier kernels on the same chunk, and the four
   fused chunk steps (K1's count, K2's indexed pairs on CoocTexture's
   indexed chunk; the dense count and pairs) beside the composed steps and
   the steps they replaced, with their hits per chunk;
3. count   -- ``SelfJoinEngine.count`` on Syn16D2M (2,000,000 x 16,
   exponential lambda=40; paper Table 1) at eps=0.03 with the default
   config, spot-checked against a float64 brute force on the card; it
   must launch K1's fused kernel once per chunk and no other kernel;
4. pairs   -- ``SelfJoinEngine.count`` / ``.pairs`` on the indexed tier and
   the dense tier (``SelfJoinEngine`` with execution="dense", its host
   plan timed apart from its device part) on CoocTexture (68,040 x 16) at
   eps=0.1: each count must launch its tier's fused count kernel once per
   chunk and nothing else, each pairs its tier's fused pairs kernel twice
   per chunk and nothing else but the result-size estimate's K1 (indexed)
   or K3 (dense); each pairs' time is split by the engine's spans into
   what precedes its chunk loops, the loops and what follows them; then the
   wide dense run, Syn64D2M (200,000 of its 2,000,000 x 64 points) at
   eps=0.1 with execution="dense" (the general path: two dim blocks),
   spot-checked against the float64 brute force and against the indexed
   tier's counts, with the cost model's choice under execution="auto";
5. attention -- ``flash_attention`` (K5), whose path is its own entry
   point (the self-join never calls it).  It has two CUDA routes: bf16 with
   head widths that are multiples of 8 up to 256 goes to the tensor-core kernel
   (``flash_attention_wgmma``), f32 and other bf16 widths to the CUDA-core
   kernel (``flash_attention``).  A sweep against the plain version (causal
   or not, Sq == Sk or not, head widths 16..256 and one outside the
   tensor-core kernel's, f32 and bf16, default and explicit scale, several
   chunk pairs; each call must count one launch of its route's kernel),
   then one call each at the full attention width of two models of the
   repo's configs (qwen3-32b, deepseek-v2-236b MLA; bf16, causal), which
   must launch the tensor-core kernel only, held against the plain
   version within one bf16 rounding of the output, and timed beside the
   CUDA-core kernel on the same inputs, the plain version,
   ``scaled_dot_product_attention`` (a yardstick only, with its own error
   against the plain version) and the bound.  Its sweep and its full-width
   part each run right after phase 2's, so a faulty kernel fails the run
   before the long phases;
6. profile -- windows of Syn16D2M count chunks, CoocTexture dense count
   chunks, CoocTexture dense pairs chunks and CoocTexture indexed pairs
   chunks, each run as the engine runs them, by the host clock, CUDA
   events and torch.profiler: the device's busy share and its kernels (the
   fused kernel of the step only).  It runs before phase 3;
7. serving -- the serving path (``repro_torch.join``: ``SimilarityIndex``
   + ``QueryService`` over combined (query | data) tables), after phase 4,
   with its own launch counters: phase 3's Syn16D2M engine wrapped as an
   index (no second build) answers range_count requests of 1, 100 and 1024
   queries, a stream of 64 x 1024 and one range_pairs of 1024, at eps
   0.03 (no index rebuild); the queries are data rows, whose counts must
   equal phase 3's for those rows (any difference within the eps boundary
   band), and jittered rows drawn from ``--seed``, held against the
   float64 brute force on a sample; pair row sums must equal the counts,
   and the chunk loops must launch K1's fused count step once per count
   chunk and K2's fused pairs step twice per pairs chunk, nothing else.
   On CoocTexture: kNN (k=16, 512 queries) over phase 4's engine against
   the float64 top-k; churn (4,096 inserts and deletes) on a 1/256-lattice
   copy, where the port's fp32 distances are exact, against the brute
   force on the live set, bit-identical across ``compact()`` with no new
   trace, and across a save / load; phase 4's dense engine as an
   index, whose requests launch only the dense fused steps.  Its line
   holds the stream's request p50 / p99 and queries/s, each request split
   by the service's spans, and the phase's peak device memory;
8. distributed -- the distributed tier (``DistributedSelfJoinEngine``,
   host-driven: DIST_WORKERS workers simulated one after another in this
   process) on phase 3-4's arrays, with its own launch counters: Syn16D2M
   cut to its first DIST_SYN_N points at 4 workers, round robin,
   ``count()``, whose counts must equal the one-card engine's count of the
   same points (made before the counters start) up to the eps boundary
   band (each shard runs its own REORDER) and which must launch only K1's
   fused count step, once per chunk; its
   time split per ring round into the blocks' host plans and chunk loops.
   CoocTexture: at 1 worker counts equal to phase 4's indexed count(); at 4
   workers round robin and dynamic counts equal to each other and to phase
   4's up to the band, ``self_join_pairs`` (row sums equal the counts, the
   pair set phase 4's up to the band; K1's fused count step once per count
   chunk and K2's fused pairs step twice per pairs chunk, nothing else),
   kNN (k=16) of every point of its first DIST_KNN_N (a cut: at all 68,040
   the host's top-k sorts ~106M candidate pairs) against the float64 top-k
   on 512 sampled rows, and a dense-tier count that launches only the
   dense fused count step.
   Then the ring transport (``ring_self_join_counts``) on a one-rank NCCL
   group the phase creates and destroys, counts equal to phase 4's up to
   the band.  Multi-GPU stays unverified (one card);
9. fused_ring -- the device-fused ring (``DistributedSelfJoinEngine(...,
   fused=True)``), after phase 8, with its own launch counters: (a) on a
   one-rank NCCL group in this process (the payload on the card),
   CoocTexture ``count()`` equal to the one-worker count (phase 4's),
   ``self_join_pairs()`` equal to the one-worker host-driven pair set, an
   eps sweep at FUSED_SWEEP_EPS that builds no new program, and kNN (k=16)
   over its first FUSED_KNN_N points against the float64 top-k; (b)
   FUSED_RANKS processes of this script (``--fused-rank``) on the one
   card, a gloo ring (the payload in host memory), each loading the
   kernels phase 1 built: phase 8's Syn16D2M cut, counts equal to phase
   8's 4-worker counts row for row, its time split by the engine's spans
   (block plans, sample, staging copies, chunk loops, exchanges);
   CoocTexture counts under both assignments equal to phase 8's, pairs
   equal to phase 8's pair set, and a forced capacity retry equal to the
   clean join.  Only K1's fused count step, K2's fused pairs step and the
   pack's hit-rate sample (K1 per pair) may launch.  Phase 8's results
   reach the processes as files, theirs come back the same way, and past
   FUSED_DEADLINE_S every rank is killed and the run fails;
10. downstream -- the legacy and downstream paths, after phase 9, with its
   own launch counters, on CoocTexture at eps=0.1 with defaults: (a)
   ``self_join_hostloop`` counts, which must launch only K1 per pair, once
   per ``ops.tile_counts`` chunk, and equal phase 4's counts and the
   engine's ``num_candidates`` / ``dim_blocks_skipped``, timed beside the
   engine's ``count()``; (b) its pairs, which must launch K2 per pair once
   per ``ops.tile_mask`` chunk of each batch plus the estimate's K1, equal
   phase 4's pair set, raise the reference's text below ``max_pairs``, and
   whose wall is split into K2's kernel time (CUDA events), the mask
   copies and the host's extraction; (c) the EGO CPU baseline
   (``ego_join_counts``) on all points against phase 4's counts up to the
   eps boundary band (paper Table 3's comparison); (d) near-duplicate
   dedup of DEDUP_EXAMPLES token examples (DEDUP_PLANTED planted
   near-copies) on the card at eps DEDUP_EPS, which must launch only the
   estimate's K1 and K2's fused pairs step (T = 32), held against a
   float64 brute force on the card and its connected components; (e) an
   obs capture of CoocTexture's ``count()`` + ``pairs()`` written as a
   Chrome trace and read by ``python -m repro_torch.obs.report`` in a
   subprocess (its dispatch spans equal the joins' dispatches; a
   truncated copy exits 1); (f) the ``torch.profiler`` bridge, run before
   phase 3 with the other profiler sessions: CoocTexture's ``count()``
   under the profiler inside ``obs.capture(torch_bridge=True)`` holds one
   ``engine.count.chunk`` range per chunk around K1's fused count kernel,
   and none without the bridge;
11. model_serve -- the model serving path (``repro_torch.models``,
   ``launch/serve``), after phase 10 and after the join's engines and
   arrays are freed, with its own launch counters: (a) all ten archs'
   reduced configs on the card against the port on the CPU with the same
   parameters, at fp32 (within 1e-4) and bf16 activations (within 2e-2):
   prefill logits and caches or recurrent states, 8 teacher-forced decode
   steps' logits and caches or states, greedy tokens (equal but on a
   near-tie of the CPU's top 2); (b) gemma3-12b at full width and depth
   (11,765,419,776 fp32 parameters drawn on the card from a
   ``torch.Generator``) serving 4 prompts of 1536 tokens and 16 new tokens,
   so the local layers' ring buffer (window 1024) wraps in prefill and in
   decode: prefill ms, decode ms per token, tokens/s, peak device memory,
   finite logits and ids below the vocab, and a split (one local and one
   global layer by part, CUDA events; a decode step by the host clock and
   replayed as a CUDA graph); (c) the same weights at batch 1 with fp32
   activations: prefill on 1039 tokens plus one decode step against
   ``forward_train`` (rel < 5e-3), ``_flash`` against ``attention_plain``
   at a local and a global layer (1e-5); (e) then, each freed before the
   next, recurrentgemma-2b (26 layers, 2,894,481,920 fp32 parameters; 4
   prompts of 2304 tokens, so its local layers' 2048-slot ring wraps),
   xlstm-125m (12 layers; 4 x 1000 tokens, the last mLSTM chunk partial),
   deepseek-v2-236b at full width cut to its dense first layer and 2 MoE
   layers (9,330,795,520 bf16 parameters; 4 x 512, prefill also absorbed)
   and arctic-480b at full width cut to 1 of 35 layers (14,069,945,344 bf16
   parameters; 4 x 512), each with 16 new tokens: prefill ms, decode ms per
   token, tokens/s, peak device memory, finite logits, ids below the vocab,
   the MoE's dropped assignments at the default capacity, and decode
   against ``forward_train`` at batch 1 with fp32 activations (rel < 5e-3,
   the MoE at capacity factor 8); (d) no kernel launches: the models call
   none.  ``--model-serve-only`` runs this phase alone;
12. model_train -- the training path (``repro_torch.train``,
   ``launch/train``), after phase 11, with its own launch counters: (a)
   all ten archs' reduced configs, one ``make_train_step`` step on the
   card against the same step on the CPU from the same weights and batch
   (2 x 40 tokens, a vocab chunk of 200), at fp32 and bf16 activations:
   loss, grad_norm, lr and the gradients within MODEL_TOL (at fp32 every
   element of its leaf's largest, at bf16 ||diff|| / ||ref|| over the
   whole gradient),
   the updated params within MODEL_TOL of their leaf's largest (2 lr more
   where the CPU's gradient is within MODEL_TOL of 0, whose sign AdamW's
   first step reads); (b) xlstm-125m uncut (12 layers, 102,425,160 fp32 parameters)
   through ``launch/train.main`` with ``--full-config --batch 8 --seq 1024
   --dedup``: 2 steps with a checkpoint after each, then 1 step in a second
   directory and a resume to 2, the final losses and the step-2 params
   within 1e-4; (c) recurrentgemma-2b uncut (26 layers, 2,894,481,920 fp32
   parameters, vocab 256,000, local MQA window 2048, remat "block" with
   flash_remat) for 3 ``make_train_step`` steps at 2 x 2048 tokens, no
   checkpoint: per step forward, backward and optimizer ms (CUDA events),
   tokens/s, peak device memory, loss and grad_norm finite, the params
   moved; (d) at recurrentgemma's widths, fp32: the streaming CE's
   gradients against the dense ``log_softmax``'s and ``_flash``'s
   (``remat_kv``) against ``attention_plain``'s, within 1e-4, each with
   its bytes saved for backward; only (b)'s dedup launches kernels: K1
   (the result-size estimate) and K2's fused pairs step at T = 32.
   ``--model-train-only`` runs this phase alone;
13. model_shard -- the sharding rules, the dry-runs and the roofline
   (``repro_torch.sharding``, ``.launch.dryrun``,
   ``.launch.selfjoin_dryrun``, ``.roofline``): (b) the dry-runs, each a
   process on fake tensors (xlstm-125m x long_500k on 2 x 16 x 16,
   gemma3-12b x decode_32k on both production meshes, deepseek-v2 and
   arctic x decode_32k on 16 x 16, and cut to one block of each kind and
   2048 tokens phi3-mini x prefill_32k, xlstm-125m x prefill_32k and
   qwen3-32b x train_4k, and recurrentgemma-2b x long_500k on both
   production meshes: one cell per fault class the DTensor seams had;
   the ring at its default 2^24 x 32 points, one process per mesh and
   variant), started together at the phase's start; phase 13 waits for
   them first and prints one line per cell with its useful FLOPs
   fraction and its FLOPs per chip over the reference's
   (``REF_FLOPS_PER_CHIP``), and fails on a model cell below 0.5 useful
   that ``LOW_USEFUL`` does not name or outside 0.5-2x of the reference,
   so that (c) times on quiet cores; (c) gemma3-12b's decode step (batch 4, context 1536) and
   recurrentgemma-2b's train step (2 x 2048) on real tensors: CUDA-event ms
   beside ``count_ops()``'s compute (fp32 products at the fp32 peak) and
   memory terms on ``H100``; (a) recurrentgemma-2b uncut served (4 prompts
   of 128, 8 greedy steps) as DTensors placed by the rules on a one-rank
   NCCL mesh, tokens equal to the plain serve's and the last logits within
   one bf16 rounding: every placement is a replica there, so it checks
   DTensor on CUDA tensors, not a shard (gloo crashes on CUDA tensors and
   NCCL takes one rank per card; the 2 x 2 mesh's values are the CPU
   tests'); (d) deepseek-v2 at full width, cut to its dense layer and one
   MoE layer, bf16, one ``make_train_step`` step at 1 x 1024 on DTensors
   on that one-rank mesh against the plain step from the same weights
   (loss, grad_norm and every param, m and v leaf within 2e-2), then the
   DTensor state through ``save_checkpoint`` and ``restore_checkpoint(...,
   shardings=)`` onto the mesh and onto plain CUDA tensors, bit for bit;
   step ms (CUDA events) and peak memory of both steps. No kernel may
   launch. ``--model-shard-only`` runs this phase alone.

K1-K4's (and the fused steps') times are torch.profiler device time per launch, the mean over the
records the profiler kept (on the card some sessions have kept fewer
records than launches, and one after phase 4 none), and every profiler
session runs before phase 3.  K5's full-width times are CUDA events around
back-to-back calls of a millisecond or more, with the profiler's reading
of the kernel beside them; each row of the kernels line names its timing.
Kernel launch counters are set to 0 just before phase 3 and read just
after phase 4 (``launches``), every kernel's (K5's too) again just before
and after phase 7 (``serving_launches``), phase 8 (``distributed_launches``), phase 9
(``fused_ring_launches``, its ranks' counters summed), phase 10
(``downstream_launches``), phase 11 (``model_serve_launches``, all 0), phase 12
(``model_train_launches``, the dedup's) and phase 13 (``model_shard_launches``,
all 0), and K5's just
before and after its two full-width calls; a kernel that its path never launched fails the run.  The line before the last lists
every kernel with its numbers; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.  The script
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_FP32_FLOPS = 67e12   # H100 SXM, fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
BOUNDARY_REL = 1e-5       # raw fp32 data: a count may differ only for pairs
                          # (a, b) whose float64 d2 lies within
                          # BOUNDARY_REL * (|a|^2 + |b|^2) of eps^2 -- the fp32
                          # rounding of |a|^2 + |b|^2 - 2 a.b scales with the
                          # norms, not with eps^2

SYN_N = 2_000_000         # Syn16D2M at full size (no cut)
SYN_EPS = 0.03
COOC_EPS = 0.1
WIDE_N = 200_000          # Syn64D2M cut from 2,000,000 points to 200,000
WIDE_EPS = (0.1, 0.2)

KERNELS = {
    # name: (module attribute, CUDA source, TPU kernel replaced, mask mode)
    "tile_pair_distance": ("distance_tile", "src/repro_torch/csrc/distance_tile_counts.cu",
                           "src/repro/kernels/distance_tile.py:111", False),
    "tile_pair_distance_mask": ("distance_tile", "src/repro_torch/csrc/distance_tile_counts.cu",
                                "src/repro/kernels/distance_tile.py:98", True),
    "dense_tile_distance": ("dense_tile", "src/repro_torch/csrc/dense_tile_fused.cu",
                            "src/repro/kernels/dense_tile.py:98", False),
    "dense_tile_distance_mask": ("dense_tile", "src/repro_torch/csrc/dense_tile_fused.cu",
                                 "src/repro/kernels/dense_tile.py:85", True),
    "flash_attention_wgmma": ("flash_attention", "src/repro_torch/csrc/flash_attention_wgmma.cu",
                              "src/repro/kernels/flash_attention.py:81", False),
}
TILE_KERNELS = [name for name, spec in KERNELS.items() if spec[0] != "flash_attention"]
# K1's fused chunk step: epilogue (b) of K1's kernel, which also does the work
# of src/repro/core/engine.py:97 count_chunk_step's scatter
SCATTER = ("tile_pair_count_scatter", "src/repro_torch/csrc/distance_tile_counts.cu",
           "src/repro/kernels/distance_tile.py:111")
# K2's fused chunk step: epilogue (c) of K1 / K2's kernel, which also does the
# work of src/repro/core/engine.py:145 pairs_chunk_step's compaction
PAIRS = ("tile_pair_pairs_compact", "src/repro_torch/csrc/distance_tile_counts.cu",
         "src/repro/kernels/distance_tile.py:98")
# the dense tier's fused chunk steps: epilogues (b) and (c) of K3 / K4's
# kernel, which also do the work of src/repro/core/engine.py:97
# count_chunk_step's scatter and :145 pairs_chunk_step's compaction
DENSE_STEPS = {
    "dense_count_scatter": ("src/repro_torch/csrc/dense_tile_fused.cu", "src/repro/kernels/dense_tile.py:98"),
    "dense_pairs_compact": ("src/repro_torch/csrc/dense_tile_fused.cu", "src/repro/kernels/dense_tile.py:85"),
}
K1_KERNEL = "k1_kernel"             # device name of K1 / K2's epilogues (distance_tile_counts.cu)
DENSE_KERNEL = "dense_kernel"       # device name of K3 / K4's epilogues (dense_tile_fused.cu)
TILE_EVAL_KERNEL = "tile_pair_kernel"  # K1-K4's earlier kernels (tile_eval.cuh)
PROFILED_KERNEL = {"tile_pair_distance": K1_KERNEL, "tile_pair_distance_mask": K1_KERNEL,
                   "dense_tile_distance": DENSE_KERNEL, "dense_tile_distance_mask": DENSE_KERNEL}

# phase 2: K1's sweep, (T, n, dim_block, pair order, C, real, shortc).  n <
# n_pad, n = 1 and n = dim_block + 1; up to 12 dim blocks (SHORTC breaks
# after the first and the second); T = 1..128, every thread-tile size (T up
# to 16, 32, 64, 128); dim blocks and pitches that are not multiples of 4
# (4-byte copies, unaligned k loops); rows too wide to stage whole (T=64
# past 300 dims, T=128 past 148, T=16 past 1204: staged in 32-dim slices,
# with dim blocks that do and do not align to them); pairs sorted by pair_a
# and unsorted; 12,000-16,000 sorted pairs, many per CTA at the full grid;
# real < C; shortc off; the T=64 fast path (one dim block of <= 16 dims) at
# 16, 13 and 10 dims.  Every case also runs on a capped grid (``k1_grids``),
# where run changes of pair_a fall inside CTAs' ranges and on their edges.
K1_CASES = [
    (1, 1, 8, "sorted", 300, 263, True), (1, 1, 8, "random", 300, 300, False),
    (16, 9, 8, "sorted", 300, 300, True), (16, 64, 16, "random", 300, 211, True),
    (16, 12, 4, "sorted", 16000, 15990, True),
    (24, 20, 8, "sorted", 12000, 11900, True), (32, 7, 8, "random", 300, 300, True),
    (33, 17, 16, "sorted", 300, 299, False), (33, 5, 4, "random", 300, 300, True),
    (64, 16, 32, "sorted", 4096, 4000, True), (64, 16, 32, "random", 300, 300, True),
    (64, 40, 8, "sorted", 300, 263, True), (64, 40, 8, "random", 300, 300, False),
    (64, 40, 8, "sorted", 12000, 11000, True), (48, 5, 3, "sorted", 12000, 12000, False),
    (64, 3, 3, "sorted", 300, 300, True), (64, 30, 6, "sorted", 300, 250, True),
    (100, 24, 8, "sorted", 300, 300, True), (100, 33, 32, "random", 300, 280, True),
    (128, 90, 32, "sorted", 300, 263, True), (128, 1, 4, "random", 300, 300, True),
    (128, 96, 48, "sorted", 4096, 4096, False),
    (48, 10, 12, "sorted", 300, 290, True), (64, 13, 16, "random", 300, 300, False),
    (64, 384, 32, "sorted", 300, 290, True), (128, 200, 40, "random", 300, 300, True),
    (100, 150, 50, "sorted", 2000, 1900, True), (16, 1210, 121, "sorted", 300, 300, True),
    (24, 700, 350, "random", 300, 280, False),
]

# phase 2: K2's sweep runs K1_CASES (the shortc flag unused: the pairs step
# drops skipped blocks) and these, where few dims make many hits per pair
# and the far tiles 0 / 1 break SHORTC after the first block: 2 dims in two
# blocks of 1, 3 in three, 4 in two at T = 128, 5 in two blocks of 4 at T = 16
K2_CASES = K1_CASES + [
    (64, 2, 1, "sorted", 1024, 1000, True), (32, 3, 1, "random", 300, 290, True),
    (128, 4, 2, "sorted", 600, 600, True), (16, 5, 4, "sorted", 2000, 1990, True),
]

# phase 2: the dense sweep (K3 / K4's three epilogues in
# csrc/dense_tile_fused.cu), (T, n, dim_block, pair order, C, real): T =
# 1..128 at every thread-tile size, n < n_pad, up to 10 dim blocks, dim blocks
# and widths that are not multiples of 4 (4-byte copies), the T=64 fast path
# (one dim block of <= 16 dims) at 16 and 13 dims, CoocTexture's chunk shape
# (T=64, 16 of 32 dims, 4096 A-major pairs), Syn64D2M's (two dim blocks),
# rows too wide to stage whole (T=64 x 384, T=128 x 200, T=16 x 1210: 32-dim
# slices), the dense plan's A-major order, sorted and random pairs, real < C.
DENSE_CASES = [
    (1, 1, 8, "dense", 300, 263), (8, 9, 8, "random", 300, 300), (16, 20, 4, "dense", 300, 290),
    (24, 20, 8, "dense", 1024, 1000), (32, 7, 8, "random", 300, 300), (33, 17, 16, "dense", 300, 299),
    (48, 5, 3, "dense", 1024, 1024), (64, 16, 32, "dense", 4096, 4000), (64, 13, 16, "random", 300, 300),
    (64, 64, 32, "dense", 1024, 1000), (64, 40, 8, "sorted", 300, 263), (100, 24, 8, "dense", 300, 300),
    (128, 90, 32, "dense", 300, 263), (128, 96, 48, "random", 300, 300), (64, 384, 32, "dense", 300, 290),
    (128, 200, 40, "dense", 300, 300), (16, 1210, 121, "dense", 300, 280),
]

# phase 5: the sweep (K5 against its plain version) and the full-width shapes
ATTN_DIMS = [(16, 16), (32, 32), (48, 16), (64, 64), (128, 128), (192, 128), (256, 256),
             (20, 12)]  # not multiples of 8: bf16 stays on the CUDA-core kernel
ATTN_LENS = [(128, 128), (96, 160), (160, 96)]    # ragged against the kernels' 64- and 128-row tiles
ATTN_CHUNKS = [(32, 32), (16, 32), (512, 512)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # the JAX tests' own; bf16: one output rounding
# full width, bf16: |got - want| <= rtol |want| + atol.  The kernel and the
# plain version agree in f32 to ~1e-5 of the output (summation order, the
# running max, exp; the tensor-core kernel carries p as bf16 hi + lo, ~16
# significant bits), then each rounds to bf16 (8 significant bits), so they
# are equal or one bf16 step apart, and a step is at most 2^-7 |want|.  The
# atol covers the f32 disagreement where |want| is near 0.  At these widths
# a typical |o| is 0.03-0.04, so 2e-2 (1 + |want|) would pass a wrong kernel;
# p rounded to bf16 alone fails this limit (tests/test_torch_flash.py).
ATTN_FULL_TOL = (2.0 ** -7, 1e-4)
ATTN_SHAPES = {
    # bf16, causal; K and V carry all BH heads (the kernel takes one BH)
    "qwen3-32b": dict(bh=64, s=8192, dh=128, dv=128, q_chunk=512, k_chunk=1024,
                      source="src/repro/configs/qwen3_32b.py:16-18 (64 heads, head_dim 128), "
                             "batch 1; chunks: ModelCfg defaults, src/repro/models/config.py:97-98"),
    "deepseek-v2-236b": dict(bh=128, s=4096, dh=192, dv=128, q_chunk=1024, k_chunk=4096,
                             source="src/repro/configs/deepseek_v2_236b.py:18,28-30,40-41 "
                                    "(128 heads, MLA qk 128+64, v 128; chunks 1024/4096), batch 1"),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# -- phase 1 -----------------------------------------------------------------


def ptxas_summary(text: str):
    """One line per compiled kernel: template args, registers, smem, spills."""
    out, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.search(r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", m.group(1))
            flash = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d)E", m.group(1))
            wgmma = re.search(r"flash_wgmma_kernelILi(\d)ELi(\d)E", m.group(1))
            k1 = re.search(r"k1_kernelILi(\d)ELi(\d)ELi(\d+)E", m.group(1))
            dense = re.search(r"dense_kernelILi(\d)ELi(\d)ELi(\d+)E", m.group(1))
            if k1:  # MODE 0: per pair, 1: count scatter, 2: pairs pass 1, 3: pairs pass 2, 4: per pair with the mask
                name = "k1_kernel<MT=%s,MODE=%s,KD=%s>" % k1.groups()
            elif dense:  # MODE as for k1_kernel
                name = "dense_kernel<MT=%s,MODE=%s,KD=%s>" % dense.groups()
            elif args:
                name = "tile_pair_kernel<R=%s,SHORTC=%s,CLAMP=%s,MASK=%s>" % args.groups()
            elif flash:
                name = "flash_fwd_kernel<%s,NV=%s>" % ("f32" if flash.group(1) == "f" else "bf16", flash.group(2))
            elif wgmma:  # 64-column blocks of dh and dv
                name = "flash_wgmma_kernel<DHB=%s,DVB=%s>" % wgmma.groups()
            else:
                name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rec = next((r for r in out if r["kernel"] == name), None)
            if rec is None:
                rec = {"kernel": name}
                out.append(rec)
            smem = re.search(r"(\d+) bytes smem", line)  # static only; none for the flash kernels
            rec.update(registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def ptxas_warnings(text: str):
    """ptxas's warnings and performance notes (ignored setmaxnreg, C7508;
    serialized wgmma), as printed."""
    return [line.strip() for line in text.splitlines()
            if re.search(r"warning|Performance Loss|setmaxnreg|C75\d\d", line)]


def hgmma_counts(path):
    """Per kernel, the HGMMA (wgmma) instructions in the SASS of the library
    ``path`` (``cuobjdump -sass``); None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.search(r"flash_wgmma_kernelILi(\d)ELi(\d)E", m.group(1))
            name = "flash_wgmma_kernel<DHB=%s,DVB=%s>" % fn.groups() if fn else m.group(1)
            counts[name] = 0
        elif name and re.search(r"\bHGMMA\b", line):
            counts[name] += 1
    return counts


def phase_device(torch, _build):
    smi = smi_name_limit()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    hgmma = hgmma_counts(_build.library_path("flash_attention_wgmma"))
    emit({
        "phase": "device", "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": build_s,
        "ptxas": {n: ptxas_summary(_build.ptxas_report(n)) for n in _build.SOURCES},
        "ptxas_warnings_wgmma": ptxas_warnings(_build.ptxas_report("flash_attention_wgmma")),
        "hgmma_per_kernel": hgmma if hgmma is not None else "cuobjdump missing",
        "hgmma_total": sum(hgmma.values()) if hgmma is not None else None,
    })
    if hgmma is not None:
        check(sum(hgmma.values()) > 0, "no HGMMA instruction in the SASS of flash_attention_wgmma")
    return smi


# -- phase 2 -----------------------------------------------------------------


def kernel_fns():
    from repro_torch.kernels import dense_tile, distance_tile

    def k(name):
        mod, _, _, mask = KERNELS[name]
        if mod == "distance_tile":
            return (lambda *a, **kw: distance_tile.tile_pair_distance(*a, return_mask=mask, **kw),
                    lambda *a, **kw: distance_tile.tile_pair_distance_plain(*a, return_mask=mask, **kw))
        return (lambda *a, **kw: dense_tile.dense_tile_distance(*a, return_mask=mask, **kw),
                lambda *a, **kw: dense_tile.dense_tile_distance_plain(*a, return_mask=mask, **kw))

    return {name: k(name) for name in TILE_KERNELS}


def sweep_case(torch, np, t, n, db, seed, far=False):
    rng = np.random.default_rng(seed)
    num_tiles = 7
    n_pad = -(-n // db) * db
    pts = np.zeros((num_tiles, t, n_pad), np.float32)
    pts[:, :, :n] = np.round(rng.random((num_tiles, t, n)) * 64) / 64
    lens = rng.integers(0, t + 1, size=num_tiles).astype(np.int32)
    lens[0] = t
    if far:  # tile 1 far from tile 0: SHORTC fires after the first block
        pts[0, :, :n] = 0.0
        pts[1, :, :n] = 0.90625
        lens[1] = t
    for i in range(num_tiles):
        pts[i, lens[i]:] = 0.0
    pairs = rng.integers(0, num_tiles, size=(40, 2)).astype(np.int32)
    pairs[:3] = [[0, 1], [1, 0], [0, 0]]
    dev = torch.device("cuda")
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(lens).to(dev),
            torch.from_numpy(pairs[:, 0].copy()).to(dev), torch.from_numpy(pairs[:, 1].copy()).to(dev))


def phase_sweep(torch, np, fns):
    cases = 0
    fired = 0
    shapes = [(t, n, db) for t in (8, 16, 32, 64) for n, db in ((8, 8), (24, 8), (64, 32))]
    shapes += [(100, 40, 40), (128, 96, 48), (5, 3, 8)]  # odd T, two-slice blocks, T < 8
    for i, (t, n, db) in enumerate(shapes):
        for far in (False, True):
            tiles, lens, pa, pb = sweep_case(torch, np, t, n, db, seed=1000 + i, far=far)
            eps = 0.05 if far else 0.3
            for name, (kern, plain) in fns.items():
                got = kern(tiles, lens, pa, pb, eps=eps, dim_block=db)
                want = plain(tiles, lens, pa, pb, eps=eps, dim_block=db)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    check(torch.equal(g, w), f"{name} != plain at T={t} n={n} db={db} far={far}")
                if name == "tile_pair_distance" and int(got[1].sum()) > 0:
                    fired += 1
                cases += 1
    check(fired > 0, "SHORTC never fired in the sweep")
    return {"cases": cases, "shortc_fired_cases": fired, "shapes": len(shapes)}


def k1_case(torch, np, t, n, db, order, c, seed, device="cuda"):
    """Inputs of one K1 / K2 sweep case on ``device``: 1/64-quantized tiles
    of 12 tiles x t rows x n dims padded to n_pad, ragged lengths,
    ``tile_start`` into a grid-sorted space of N = 12 t - 3 rows (the last
    tile's last rows drop, as the reference's mode="drop") with a random
    ``point_order`` of its 12 t positions, and c pairs.  Tiles 0 / 1 are
    far apart in every dim (SHORTC breaks after the first block); tiles 2 /
    3 agree on the first block and are far apart in the second (a break
    after the second).  ``order`` "sorted" sorts the pairs by (pair_a,
    pair_b), as the plan does; "random" leaves them unsorted."""
    rng = np.random.default_rng(seed)
    num_tiles = 12
    n_pad = -(-n // db) * db
    pts = np.zeros((num_tiles, t, n_pad), np.float32)
    pts[:, :, :n] = np.round(rng.random((num_tiles, t, n)) * 64) / 64
    lens = rng.integers(0, t + 1, size=num_tiles).astype(np.int32)
    lens[:4] = t
    pts[0, :, :n] = 0.0
    pts[1, :, :n] = 0.90625
    pts[3, :, :min(db, n)] = pts[2, :, :min(db, n)]
    pts[2, :, db:min(2 * db, n)] = 0.0
    pts[3, :, db:min(2 * db, n)] = 0.90625
    for i in range(num_tiles):
        pts[i, lens[i]:] = 0.0
    pairs = rng.integers(0, num_tiles, size=(c, 2)).astype(np.int32)
    if order == "sorted":  # runs of one pair_a of every length, some hundreds long
        pairs[:, 0] = np.sort(rng.choice(num_tiles, size=c, p=np.arange(1, num_tiles + 1) / 78.0))
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    special = np.array([[0, 1], [1, 0], [2, 3], [3, 2], [0, 0]], np.int32)
    at = rng.choice(c - len(special), size=1)[0]
    pairs[at:at + len(special)] = special
    if order == "sorted":
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    starts = (np.arange(num_tiles) * t).astype(np.int32)
    return dict(
        tiles=torch.from_numpy(pts).to(device), lens=torch.from_numpy(lens).to(device),
        starts=torch.from_numpy(starts).to(device), pa=torch.from_numpy(pairs[:, 0].copy()).to(device),
        pb=torch.from_numpy(pairs[:, 1].copy()).to(device), n=n, n_sorted=num_tiles * t - 3,
        state=torch.from_numpy(rng.integers(0, 50, size=num_tiles * t - 2).astype(np.int32)).to(device),
        point_order=torch.from_numpy(rng.permutation(num_tiles * t).astype(np.int32)).to(device),
    )


DENSE_NOISE_VAR = 2 * (2 / 3) / 4096  # per dim: the variance of a difference of two {-1, 0, 1} / 64 noises


def dense_case(torch, np, t, n, db, order, c, seed, device="cuda"):
    """Inputs of one dense sweep case on ``device``: 12 tiles x t rows x n
    dims padded to n_pad, 1/64-quantized points around 4 cluster centres
    (noise of -1, 0 or 1 / 64 per dim; each tile from one cluster, tiles 2
    and 3 equal), ragged lengths with tiles 0-3 full, ``tile_start`` into a
    grid-sorted space of N = 12 t rows with a random ``point_order``, a sink
    row at ``n_sorted`` = N - 3 for the count step (the last tile's last rows
    drop), and c pairs: "dense" lists the tile cross product in the dense
    plan's A-major order (runs of 12 equal pair_a) over and over, "sorted"
    random pairs sorted by (pair_a, pair_b), "random" unsorted.  ``eps``
    (hi, lo): squared radii of 1 and 0.4 times the mean squared distance of
    two points of one cluster, so many tile pairs have hits and some none."""
    rng = np.random.default_rng(seed)
    num_tiles = 12
    n_pad = -(-n // db) * db
    centres = np.round(rng.uniform(0.25, 0.75, size=(4, n)) * 64) / 64
    cluster = rng.integers(0, 4, size=num_tiles)
    pts = np.zeros((num_tiles, t, n_pad), np.float32)
    pts[:, :, :n] = centres[cluster][:, None, :] + rng.integers(-1, 2, size=(num_tiles, t, n)) / 64
    pts[2] = pts[3]
    lens = rng.integers(0, t + 1, size=num_tiles).astype(np.int32)
    lens[:4] = t
    for i in range(num_tiles):
        pts[i, lens[i]:] = 0.0
    if order == "dense":
        idx = np.arange(num_tiles)
        cross = np.stack([np.repeat(idx, num_tiles), np.tile(idx, num_tiles)], axis=1)
        pairs = cross[np.arange(c) % len(cross)].astype(np.int32)
    else:
        pairs = rng.integers(0, num_tiles, size=(c, 2)).astype(np.int32)
        if order == "sorted":
            pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    num_points = num_tiles * t
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        tiles=to(pts), lens=to(lens), starts=to((np.arange(num_tiles) * t).astype(np.int32)),
        pa=to(pairs[:, 0]), pb=to(pairs[:, 1]), n=n, n_sorted=num_points - 3,
        point_order=to(rng.permutation(num_points).astype(np.int32)),
        state=to(rng.integers(0, 50, size=num_points - 2).astype(np.int32)),
        eps=tuple(float(np.sqrt(f * n * DENSE_NOISE_VAR)) for f in (1.0, 0.4)),
    )


def pairs_states(nh):
    """Starting states of the pairs chunk step for a chunk of ``nh`` hits:
    (name, offset before the chunk, cap, hit_cap).  All land ("fits"); at a
    nonzero offset; fewer rank slots than hits (nh > hit_cap, the hit_cap
    retry); a chunk that straddles cap; offset past cap before the chunk
    (the capacity retry).  One cap and two hit_caps, so the reference's
    programs see two buffer shapes."""
    cap, hit_cap = nh + 47, nh + 3
    return [
        ("fits", 0, cap, hit_cap),
        ("offset", 37, cap, hit_cap),
        ("hits_past_hit_cap", 11, cap, max(1, nh // 3)),
        ("straddles_cap", cap - nh // 2, cap, hit_cap),
        ("past_cap", cap + 7, cap, hit_cap),
    ]


def pairs_state(torch, offset0, cap, hit_cap, device="cuda"):
    """buf (cap + hit_cap, 2) int32 filled with -1 (no id, so rows no hit
    lands on show), offset, and max_chunk_hits starting at 3."""
    buf = torch.full((cap + hit_cap, 2), -1, dtype=torch.int32, device=device)
    return (buf, torch.full((), offset0, dtype=torch.int32, device=device),
            torch.full((), 3, dtype=torch.int32, device=device))


def landed_rows(offset0, nh, cap, hit_cap):
    """Rows of the buffer a pairs step's result is held on: those below
    min(offset, cap) after the chunk and those its hits landed on.  Past
    them the reference writes rows of clamped garbage ranks
    (src/repro/core/engine.py:203-212)."""
    woff = min(offset0, cap)
    return max(woff + min(nh, hit_cap), min(offset0 + nh, cap))


def run_edges(pa, num_pairs, grid):
    """Where the changes of ``pa`` fall against the ranges of ``grid`` CTAs
    over ``num_pairs`` pairs (CTA b takes [P b / G, P (b + 1) / G)): changes
    inside a range, changes on a range's edge, and runs across an edge."""
    edges = {num_pairs * b // grid for b in range(1, grid)} - {0, num_pairs}
    changes = {p for p in range(1, num_pairs) if pa[p] != pa[p - 1]}
    return {"change_inside": len(changes - edges), "change_on_edge": len(changes & edges),
            "run_across_edge": len(edges - changes)}


def k1_grids(pa, num_pairs):
    """The grids each K1 sweep case runs on: the card's full grid (0), one
    CTA for all pairs, and the smallest grid of 3 or more CTAs on which a
    run change of ``pa`` falls on a range's edge and a run crosses another."""
    for g in range(3, min(num_pairs, 64) + 1):
        e = run_edges(pa, num_pairs, g)
        if e["change_on_edge"] and e["run_across_edge"]:
            return 0, 1, g
    return 0, 1, 7


def k1_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, shortc, eps, seed):
    """One K1 case on the card, on each of ``k1_grids``: epilogue (a)
    against its plain version and against K1's earlier kernel
    (tile_eval.cuh), epilogue (b) (bound as ``CountScatter``, as the engine
    binds it) against its plain version and against the earlier kernel's
    counts scattered by ``scatter_counts``; all with ``==``.  Returns
    whether SHORTC broke a pair after its first block, whether one after a
    later block, and the capped grids' ``run_edges`` summed."""
    x = k1_case(torch, np, t, n, db, order, c, seed)
    args = (x["tiles"], x["lens"], x["pa"], x["pb"])
    what = f"K1 T={t} n={n} db={db} {order} C={c} real={real} shortc={shortc} eps={eps}"
    want = distance_tile.tile_pair_distance_plain(*args, eps=eps, dim_block=db, num_dims=n)
    earlier = distance_tile.tile_pair_distance_tile_eval(*args, eps=eps, dim_block=db)
    ref = []
    for mode in ("plain", "earlier"):
        cs, sk = x["state"].clone(), torch.full((), 7, dtype=torch.int32, device=x["tiles"].device)
        if mode == "plain":
            distance_tile.tile_pair_count_scatter_plain(cs, sk, x["tiles"], x["lens"], x["starts"], x["pa"],
                                                        x["pb"], real, eps, dim_block=db, shortc=shortc,
                                                        num_dims=n)
        else:
            skipped = earlier[1] if shortc else torch.zeros_like(earlier[1])
            distance_tile.scatter_counts(cs, sk, earlier[0], skipped, x["lens"], x["starts"], x["pa"], real)
        ref.append((mode if mode == "plain" else "K1's earlier kernel + scatter_counts", cs, sk))
    pa = x["pa"].cpu().numpy()
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    for grid in k1_grids(pa[:real], real):
        on = f"{what} grid={grid or 'full'}"
        got = distance_tile.tile_pair_distance(*args, eps=eps, dim_block=db, num_dims=n, max_ctas=grid)
        cs, sk = x["state"].clone(), torch.full((), 7, dtype=torch.int32, device=x["tiles"].device)
        step = distance_tile.CountScatter(cs, sk, x["tiles"], x["lens"], x["starts"], eps, dim_block=db,
                                          shortc=shortc, num_dims=n, max_ctas=grid)
        step(x["pa"], x["pb"], real)
        torch.cuda.synchronize()
        for g, w, e, part in zip(got, want, earlier, ("counts", "skipped")):
            check(torch.equal(g, w), f"{on}: {part} of K1 != plain")
            check(torch.equal(g, e), f"{on}: {part} of K1 != K1's earlier kernel")
        for other, want_cs, want_sk in ref:
            check(torch.equal(cs, want_cs), f"{on}: counts_sorted of the fused step != {other}")
            check(torch.equal(sk, want_sk), f"{on}: skipped_tot of the fused step != {other}")
        if grid:
            for num, p in ((c, pa), (real, pa[:real])):
                for k, v in run_edges(p, num, min(grid, num)).items():
                    edges[k] += v
    blocks = x["tiles"].shape[2] // db
    sk = want[1]
    return (bool((sk == blocks - 1).any()) and blocks > 1, bool(((sk > 0) & (sk < blocks - 1)).any()),
            edges)


def phase_k1_sweep(torch, np):
    """K1_CASES at eps 0.3 and 0.05 (the far tiles break there); SHORTC must
    break after the first block and after a later one somewhere."""
    from repro_torch.kernels import distance_tile

    cases, after_first, after_later = 0, 0, 0
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    staging = set()
    before = dict(distance_tile.LAUNCHES)
    for i, (t, n, db, order, c, real, shortc) in enumerate(K1_CASES):
        staging.add((distance_tile.k1_staging(t, n), 1 if t <= 16 else 2 if t <= 32 else 4 if t <= 64 else 8))
        for eps in (0.3, 0.05):
            first, later, e = k1_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, shortc, eps,
                                            seed=3000 + i)
            after_first += first
            after_later += later
            for k, v in e.items():
                edges[k] += v
            cases += 1
    launched = {k: distance_tile.LAUNCHES[k] - before[k] for k in before}
    grids = 3  # k1_grids: the full grid, one CTA, one capped grid
    check(launched["tile_pair_count_scatter"] == grids * cases and launched["tile_pair_distance"] == grids * cases,
          f"the K1 sweep launched {launched} for {cases} cases on {grids} grids each")
    check(after_first > 0 and after_later > 0,
          f"SHORTC broke after the first block in {after_first}, after a later one in {after_later} cases")
    check(all(edges.values()), f"the capped grids put pair_a's run changes at {edges}")
    check({s for s, _ in staging} == {0, distance_tile.K1_SLAB} and {mt for s, mt in staging if s} == {1, 2, 4, 8},
          f"the K1 sweep staged (slab, MT) {sorted(staging)}")
    # rows too wide to stage whole, T=64 x 384 dims in 12 blocks: the sliced
    # path beside K1's earlier kernel (CUDA events, 20 calls each)
    x = k1_case(torch, np, 64, 384, 32, "sorted", 4096, seed=7)
    args = (x["tiles"], x["lens"], x["pa"], x["pb"])
    wide = {"T": 64, "n": 384, "dim_block": 32, "pairs": 4096, "eps": 0.3,
            "slab": distance_tile.k1_staging(64, 384),
            "ms": event_ms(torch, lambda: distance_tile.tile_pair_distance(*args, eps=0.3, num_dims=384), 20),
            "earlier_ms": event_ms(torch, lambda: distance_tile.tile_pair_distance_tile_eval(*args, eps=0.3), 20)}
    rec = {"phase": "k1_sweep", "cases": cases, "shortc_after_first_block": after_first,
           "shortc_after_later_block": after_later, "run_edges": edges,
           "staging_slab_mt": sorted(staging), "launches": launched, "wide_rows": wide}
    emit(rec)
    return rec


def k2_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, eps, seed):
    """One K2 case on the card, on each of ``k1_grids``: epilogue (a) with
    the mask (counts, skipped and mask) against its plain version and
    against K2's earlier kernel (tile_eval.cuh); epilogue (c) (bound as
    ``PairsCompact``, as the engine binds it) against
    ``tile_pair_pairs_compact_plain`` from every state of ``pairs_states``
    (the whole buffer, offset and max_chunk_hits); all with ``==``.
    Returns the chunk's hits, whether SHORTC broke a pair after its first
    block, and the capped grids' ``run_edges`` summed."""
    x = k1_case(torch, np, t, n, db, order, c, seed)
    args = (x["tiles"], x["lens"], x["pa"], x["pb"])
    tables = (x["tiles"], x["lens"], x["starts"], x["point_order"])
    what = f"K2 T={t} n={n} db={db} {order} C={c} real={real} eps={eps}"
    want = distance_tile.tile_pair_distance_plain(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n)
    earlier = distance_tile.tile_pair_distance_tile_eval(*args, eps=eps, dim_block=db, return_mask=True)
    nh = int(want[0][:real].sum())
    want_pairs = []
    for name, offset0, cap, hit_cap in pairs_states(nh):
        st = pairs_state(torch, offset0, cap, hit_cap)
        distance_tile.tile_pair_pairs_compact_plain(*st, *tables, x["pa"], x["pb"], real, eps, hit_cap=hit_cap,
                                                    dim_block=db, num_dims=n)
        want_pairs.append((name, offset0, cap, hit_cap, st))
    pa = x["pa"].cpu().numpy()
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    for grid in k1_grids(pa[:real], real):
        on = f"{what} grid={grid or 'full'}"
        got = distance_tile.tile_pair_distance(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n,
                                               max_ctas=grid)
        torch.cuda.synchronize()
        for g, w, e, part in zip(got, want, earlier, ("counts", "skipped", "mask")):
            check(torch.equal(g, w), f"{on}: {part} of K2 != plain")
            check(torch.equal(g, e), f"{on}: {part} of K2 != K2's earlier kernel")
        for name, offset0, cap, hit_cap, (w_buf, w_off, w_max) in want_pairs:
            buf, off, mx = pairs_state(torch, offset0, cap, hit_cap)
            distance_tile.PairsCompact(buf, off, mx, *tables, eps, hit_cap=hit_cap, chunk=c, dim_block=db,
                                       num_dims=n, max_ctas=grid)(x["pa"], x["pb"], real)
            torch.cuda.synchronize()
            check(int(off) == int(w_off) == offset0 + nh and int(mx) == int(w_max),
                  f"{on} {name}: offset {int(off)} / max_chunk_hits {int(mx)} != plain's {int(w_off)} / {int(w_max)}")
            check(torch.equal(buf, w_buf), f"{on} {name}: the fused pairs step's buffer != plain")
        if grid:
            for num, q in ((c, pa), (real, pa[:real])):
                for k, v in run_edges(q, num, min(grid, num)).items():
                    edges[k] += v
    blocks = x["tiles"].shape[2] // db
    return nh, bool((want[1][:real] == blocks - 1).any()) and blocks > 1, edges


def phase_k2_sweep(torch, np):
    """K2_CASES at eps 0.3 and 0.05, each on three grids: K2 per pair and
    the fused pairs step from five buffer states.  SHORTC must break after
    the first block somewhere, chunks with and without hits past a state's
    hit_cap must occur, and the capped grids must put run changes inside,
    on and across edges."""
    from repro_torch.kernels import distance_tile

    cases, hits, after_first = 0, 0, 0
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    staging = set()
    before = dict(distance_tile.LAUNCHES)
    t0 = time.perf_counter()
    for i, (t, n, db, order, c, real, _) in enumerate(K2_CASES):
        staging.add((distance_tile.k1_staging(t, n), 1 if t <= 16 else 2 if t <= 32 else 4 if t <= 64 else 8))
        for eps in (0.3, 0.05):
            nh, first, e = k2_sweep_case(torch, np, distance_tile, t, n, db, order, c, real, eps, seed=7000 + i)
            hits += nh
            after_first += first
            for k, v in e.items():
                edges[k] += v
            cases += 1
    launched = {k: distance_tile.LAUNCHES[k] - before[k] for k in before}
    grids, states = 3, len(pairs_states(0))
    expect = {"tile_pair_distance": 0, "tile_pair_count_scatter": 0, "tile_pair_distance_mask": grids * cases,
              "tile_pair_pairs_compact": 2 * states * grids * cases, "tile_pair_distance_tile_eval": cases}
    check(launched == expect, f"the K2 sweep launched {launched} for {cases} cases, expected {expect}")
    check(after_first > 0, "SHORTC never broke after the first block in the K2 sweep")
    check(all(edges.values()), f"the capped grids put pair_a's run changes at {edges}")
    check({s for s, _ in staging} == {0, distance_tile.K1_SLAB} and {mt for s, mt in staging if s} == {1, 2, 4, 8},
          f"the K2 sweep staged (slab, MT) {sorted(staging)}")
    rec = {"phase": "k2_sweep", "cases": cases, "hits": hits, "shortc_after_first_block": after_first,
           "run_edges": edges, "staging_slab_mt": sorted(staging), "launches": launched,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def dense_sweep_case(torch, np, dense_tile, t, n, db, order, c, real, eps_index, seed):
    """One dense case on the card at ``dense_case``'s ``eps[eps_index]``, on
    each of ``k1_grids``: epilogue (a) (counts, and counts with the mask)
    against its plain version and against K3 / K4's earlier kernel
    (dense_tile.cu); epilogue (b) (bound as ``DenseCountScatter``) against
    its plain step; epilogue (c) (bound as ``DensePairsCompact``) against
    its plain step from every state of ``pairs_states`` (the whole buffer,
    offset and max_chunk_hits); all with ``==``.  Returns the chunk's hits
    and the capped grids' ``run_edges`` summed."""
    x = dense_case(torch, np, t, n, db, order, c, seed)
    eps = x["eps"][eps_index]
    args = (x["tiles"], x["lens"], x["pa"], x["pb"])
    what = f"dense T={t} n={n} db={db} {order} C={c} real={real} eps={eps:.4f}"
    want = dense_tile.dense_tile_distance_plain(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n)
    earlier = dense_tile.dense_tile_distance_tile_eval(*args, eps=eps, dim_block=db, return_mask=True)
    tables = (x["tiles"], x["lens"], x["starts"])
    want_cs = x["state"].clone()
    dense_tile.dense_count_scatter_plain(want_cs, *tables, x["pa"], x["pb"], real, eps, dim_block=db, num_dims=n)
    nh = int(want[0][:real].sum())
    want_pairs = []
    for name, offset0, cap, hit_cap in pairs_states(nh):
        st = pairs_state(torch, offset0, cap, hit_cap)
        dense_tile.dense_pairs_compact_plain(*st, *tables, x["point_order"], x["pa"], x["pb"], real, eps,
                                             hit_cap=hit_cap, dim_block=db, num_dims=n)
        want_pairs.append((name, offset0, cap, hit_cap, st))
    pa = x["pa"].cpu().numpy()
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    for grid in k1_grids(pa[:real], real):
        on = f"{what} grid={grid or 'full'}"
        (counts,) = dense_tile.dense_tile_distance(*args, eps=eps, dim_block=db, num_dims=n, max_ctas=grid)
        got = dense_tile.dense_tile_distance(*args, eps=eps, dim_block=db, return_mask=True, num_dims=n,
                                             max_ctas=grid)
        cs = x["state"].clone()
        dense_tile.DenseCountScatter(cs, *tables, eps, dim_block=db, num_dims=n, max_ctas=grid)(x["pa"], x["pb"], real)
        torch.cuda.synchronize()
        check(torch.equal(counts, want[0]), f"{on}: counts of K3 != plain")
        for g, w, e, part in zip(got, want, earlier, ("counts", "mask")):
            check(torch.equal(g, w), f"{on}: {part} of K4 != plain")
            check(torch.equal(g, e), f"{on}: {part} of K4 != K3 / K4's earlier kernel")
        check(torch.equal(cs, want_cs), f"{on}: counts_sorted of the fused count step != plain")
        for name, offset0, cap, hit_cap, (w_buf, w_off, w_max) in want_pairs:
            buf, off, mx = pairs_state(torch, offset0, cap, hit_cap)
            dense_tile.DensePairsCompact(buf, off, mx, *tables, x["point_order"], eps, hit_cap=hit_cap, chunk=c,
                                         dim_block=db, num_dims=n, max_ctas=grid)(x["pa"], x["pb"], real)
            torch.cuda.synchronize()
            check(int(off) == int(w_off) == offset0 + nh and int(mx) == int(w_max),
                  f"{on} {name}: offset {int(off)} / max_chunk_hits {int(mx)} != plain's {int(w_off)} / {int(w_max)}")
            check(torch.equal(buf, w_buf), f"{on} {name}: the fused pairs step's buffer != plain")
        if grid:
            for num, q in ((c, pa), (real, pa[:real])):
                for k, v in run_edges(q, num, min(grid, num)).items():
                    edges[k] += v
    return nh, edges


def phase_dense_sweep(torch, np):
    """DENSE_CASES at both of ``dense_case``'s radii, each on three grids;
    every MT, both stagings and chunks with and without hits must occur,
    and the capped grids must put run changes inside, on and across edges."""
    from repro_torch.kernels import dense_tile

    cases, hits, empty = 0, 0, 0
    edges = {"change_inside": 0, "change_on_edge": 0, "run_across_edge": 0}
    staging = set()
    before = dict(dense_tile.LAUNCHES)
    t0 = time.perf_counter()
    for i, (t, n, db, order, c, real) in enumerate(DENSE_CASES):
        staging.add((dense_tile.dense_staging(t, n), 1 if t <= 16 else 2 if t <= 32 else 4 if t <= 64 else 8))
        for eps_index in (0, 1):
            nh, e = dense_sweep_case(torch, np, dense_tile, t, n, db, order, c, real, eps_index, seed=5000 + i)
            hits += nh
            empty += nh == 0
            for k, v in e.items():
                edges[k] += v
            cases += 1
    launched = {k: dense_tile.LAUNCHES[k] - before[k] for k in before}
    grids, states = 3, len(pairs_states(0))
    expect = {"dense_tile_distance": grids * cases, "dense_tile_distance_mask": grids * cases,
              "dense_count_scatter": grids * cases, "dense_pairs_compact": 2 * states * grids * cases,
              "dense_tile_distance_tile_eval": cases}
    check(launched == expect, f"the dense sweep launched {launched} for {cases} cases, expected {expect}")
    check(all(edges.values()), f"the capped grids put pair_a's run changes at {edges}")
    check({s for s, _ in staging} == {0, dense_tile.K1_SLAB} and {mt for _, mt in staging} == {1, 2, 4, 8},
          f"the dense sweep staged (slab, MT) {sorted(staging)}")
    rec = {"phase": "dense_sweep", "cases": cases, "hits": hits, "cases_without_hits": empty,
           "run_edges": edges, "staging_slab_mt": sorted(staging), "launches": launched,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def boundary_band(a, b):
    """float64 d2 between the rows of a (..., Ta, n) and b (..., Tb, n), and
    the band BOUNDARY_REL * (|a|^2 + |b|^2) around eps^2 inside which an fp32
    count may differ from the float64 one."""
    from repro_torch.core.brute import sqdist_f64

    a, b = a.double(), b.double()
    band = BOUNDARY_REL * ((a * a).sum(-1)[..., :, None] + (b * b).sum(-1)[..., None, :])
    return sqdist_f64(a, b), band


def boundary_slack(torch, tiles, lens, pa, pb, eps):
    """(P, T, T): valid lanes whose float64 d2 lies in the eps^2 boundary band."""
    d2, band = boundary_band(tiles[pa.long()], tiles[pb.long()])
    rows = torch.arange(tiles.shape[1], device=tiles.device)
    valid = (rows[None, :, None] < lens[pa.long()][:, None, None]) & (
        rows[None, None, :] < lens[pb.long()][:, None, None])
    return valid & ((d2 - float(eps) ** 2).abs() <= band)


def count_bounds(torch, pts, rows, eps):
    """(lo, hi): float64 neighbour counts of pts[rows] at eps^2 -/+ the band.

    A right count on raw fp32 data lies in [lo, hi]."""
    return query_count_bounds(torch, pts, pts[torch.as_tensor(rows, device=pts.device)], eps)


def query_count_bounds(torch, pts, q, eps):
    """(lo, hi): float64 counts of ``pts`` within eps of each row of ``q`` at
    eps^2 -/+ the boundary band; a right fp32 count lies in [lo, hi]."""
    e2 = float(eps) ** 2
    lo, hi = [], []
    for s in range(0, q.shape[0], 32):
        d2, band = boundary_band(q[s:s + 32], pts)
        lo.append((d2 <= e2 - band).sum(1))
        hi.append((d2 <= e2 + band).sum(1))
    return torch.cat(lo).cpu().numpy(), torch.cat(hi).cpu().numpy()


PROFILER_TRIES = 3  # profiler sessions run before a measurement fails: CUPTI drops records in some


def kernel_ms(torch, fn, iters=20, kernel=None):
    """torch.profiler over ``iters`` calls of ``fn`` (after one to warm up):
    per kernel name, (device ms per record, the mean over the records kept,
    records kept).  A session that kept no device record (of ``kernel``,
    given) is run again, up to PROFILER_TRIES sessions; then it fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            if us > 0 and evt.count:
                out[evt.key] = (us / 1e3 / evt.count, evt.count)
        if any(kernel is None or kernel in key for key in out):
            return out
    raise SmokeFailure(f"torch.profiler recorded no device time of {kernel or fn} in {PROFILER_TRIES} sessions")


def device_ms(torch, fn, iters=20, kernel=None):
    """Device time from torch.profiler over ``iters`` calls of ``fn``: per
    call, summed over every kernel it launches, or, given ``kernel`` (a name
    that ``fn`` launches once per call), per launch of that kernel, the mean
    over the records the profiler kept.  Returns (ms, records kept).

    Unlike CUDA events around back-to-back calls, this excludes the host's
    gaps between launches.  On the card the profiler has kept fewer records
    than launches in some sessions (K5: 1 and 4 of 5); a mean per kept
    record stays right where a sum over calls does not.  Fails when
    PROFILER_TRIES sessions recorded no device time, or none of ``kernel``.
    """
    picked = [(ms * n, n) for key, (ms, n) in kernel_ms(torch, fn, iters, kernel).items()
              if kernel is None or kernel in key]
    records = sum(n for _, n in picked)
    check(records, f"torch.profiler recorded no device time of {kernel or fn}")
    return sum(ms for ms, _ in picked) / (records if kernel else iters), records


def smi_sample():
    """SM clock, power draw and temperature, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def yardstick(torch, tiles, lens, pa, pb, eps2):
    """One PyTorch formulation of the same function (clamped identity via
    baddbmm, then <= and a sum); timed as library_ms, never used by the port."""
    pal, pbl = pa.long(), pb.long()
    a, b = tiles[pal], tiles[pbl]
    t = tiles.shape[1]
    rows = torch.arange(t, device=tiles.device)
    valid = (rows[None, :, None] < lens[pal][:, None, None]) & (rows[None, None, :] < lens[pbl][:, None, None])
    na = (a * a).sum(-1)
    nb = (b * b).sum(-1)
    d2 = torch.baddbmm(na[:, :, None] + nb[:, None, :], a, b.transpose(1, 2), alpha=-2.0).clamp_min_(0.0)
    within = (d2 <= eps2) & valid
    return within.sum(2, dtype=torch.int32), within


def bound(torch, tiles, pa, pb, n, db, skipped, mask):
    """Least time on the card: max(bytes / HBM rate, flop / fp32 rate), ms.

    Only the n real dimensions count, not the zero padding up to n_pad, and
    of those only the ones in dim blocks this run's data computed (SHORTC
    skips trailing blocks; ``skipped`` is None for the kernels without it).
    Bytes: each referenced tile's real dimensions and length read once, the
    pair lists read once, counts (+ skipped, + the int8 mask) written once.
    Flop per pair: 2 T^2 per computed dimension for the products, 4 T for
    the norms, and 4 T^2 per computed block for the fold.
    """
    p = pa.shape[0]
    t, n_pad = tiles.shape[1], tiles.shape[2]
    uniq = int(torch.unique(torch.cat([pa, pb])).numel())
    nbytes = (uniq * t * n * 4 + uniq * 4 + p * 8 + p * t * 4
              + (p * 4 if skipped is not None else 0) + (p * t * t if mask else 0))
    blocks = torch.full((p,), -(-n_pad // db), dtype=torch.int64, device=pa.device)
    if skipped is not None:
        blocks -= skipped.reshape(-1).long()
    dims = torch.clamp(blocks * db, max=n)
    real_blocks = -(-dims // db)
    flop = int((2 * t * t + 4 * t) * dims.sum() + 4 * t * t * real_blocks.sum())
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = flop / PEAK_FP32_FLOPS * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations"), nbytes, flop


def phase_real_width(torch, np, fns, inputs):
    """Each kernel on a main-path chunk: compare with plain, time all three."""
    from repro_torch.kernels.distance_tile import eps_squared

    from repro_torch.kernels import dense_tile, distance_tile

    rows = {}
    for name, (kern, plain) in fns.items():
        tiles, lens, pa, pb, n, eps, db, source = inputs[name]
        kw = dict(eps=eps, dim_block=db, num_dims=n)
        got = kern(tiles, lens, pa, pb, **kw)
        want = plain(tiles, lens, pa, pb, **kw)
        torch.cuda.synchronize()
        near = boundary_slack(torch, tiles, lens, pa, pb, eps)
        err = (got[0] - want[0]).abs()
        max_err = int(err.max()) if err.numel() else 0
        check(bool((err <= near.sum(2)).all()), f"{name}: counts differ beyond the eps boundary")
        mask = KERNELS[name][3]
        nb = tiles.shape[2] // db
        skipped = None
        if name.startswith("tile_pair_distance"):
            check(torch.equal(got[1], want[1]), f"{name}: skipped differs from plain")
            skipped = got[1]
        computed = pa.shape[0] * nb - (int(skipped.sum()) if skipped is not None else 0)
        if mask:
            m_err = (got[-1] != want[-1])
            check(bool((~m_err | near).all()), f"{name}: mask differs beyond the eps boundary")
            max_err = max(max_err, int(m_err.sum() > 0))
        eps2 = eps_squared(eps)
        run_k = lambda: kern(tiles, lens, pa, pb, **kw)  # noqa: E731
        run_p = lambda: plain(tiles, lens, pa, pb, **kw)  # noqa: E731
        run_l = lambda: yardstick(torch, tiles, lens, pa, pb, eps2)  # noqa: E731
        k_ms, k_records = device_ms(torch, run_k, kernel=PROFILED_KERNEL[name])
        p_ms, _ = device_ms(torch, run_p, iters=5)
        l_ms, _ = device_ms(torch, run_l, iters=5)
        b_ms, b_by, nbytes, flop = bound(torch, tiles, pa, pb, n, db, skipped, mask)
        extra = {"hits": int(got[0].sum())}
        if name.startswith("tile_pair_distance"):  # K1 / K2's earlier kernel (tile_eval.cuh) on the same inputs
            run_e = lambda: distance_tile.tile_pair_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db,  # noqa: E731
                                                                       return_mask=mask)
            e_got = run_e()
            check(torch.equal(e_got[1], got[1]), f"{name}'s earlier kernel: skipped differs")
            e_ms, _ = device_ms(torch, run_e, kernel=TILE_EVAL_KERNEL)
            extra.update(earlier_ms=e_ms, earlier_count_diffs=int((e_got[0] != got[0]).sum()),
                         earlier_mask_diffs=int((e_got[-1] != got[-1]).sum()) if mask else None,
                         earlier="K1 / K2's tile_eval.cuh kernel (src/repro_torch/csrc/distance_tile.cu, all "
                                 "n_pad dims, one block per pair) on the same inputs in this run")
        if name.startswith("dense"):  # K3 / K4's earlier kernel (tile_eval.cuh) on the same inputs
            run_e = lambda: dense_tile.dense_tile_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db,  # noqa: E731
                                                                     return_mask=mask)
            e_got = run_e()
            e_ms, _ = device_ms(torch, run_e, kernel=TILE_EVAL_KERNEL)
            extra.update(earlier_ms=e_ms, earlier_count_diffs=int((e_got[0] != got[0]).sum()),
                         earlier_mask_diffs=int((e_got[-1] != got[-1]).sum()) if mask else None,
                         earlier="K3 / K4's tile_eval.cuh kernel (src/repro_torch/csrc/dense_tile.cu, all n_pad "
                                 "dims, one block per pair) on the same inputs in this run")
        rows[name] = {
            "inputs": source, "pairs": int(pa.shape[0]), "T": int(tiles.shape[1]), "n": n,
            "n_pad": int(tiles.shape[2]), "dim_block": db, "computed_blocks": computed,
            "max_abs_err": max_err, "boundary_lanes": int(near.sum()),
            "ms": k_ms, "profiler_records": k_records, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flop": flop, **extra,
        }
    emit({"phase": "kernels_real_width", "timing": "torch.profiler device time per launch of 20 "
          "(the kernel: mean over the records kept), per call of 5 (plain, library)",
          "kernels": rows, "smi": smi_sample()})
    return rows


def phase_fused_step(torch, tiles, lens, starts, num_points, pa, pb, n, eps, db, shortc, source):
    """K1's fused chunk step (epilogue b) on a main-path chunk: held exactly
    against K1's per-pair epilogue scattered by ``scatter_counts``, and
    against its plain version up to the eps-boundary lanes; timed beside
    the plain version, the composed steps it replaced (K1's per-pair
    kernel, and K1's earlier kernel, each + ``scatter_counts``), the
    yardstick + ``scatter_counts``, and the bound."""
    from repro_torch.core.engine import count_step
    from repro_torch.kernels import distance_tile as dt

    real = pa.shape[0]

    def state():
        return (torch.zeros(num_points + 1, dtype=torch.int32, device="cuda"),
                torch.zeros((), dtype=torch.int32, device="cuda"))

    def scatter(counts, skipped, st):
        dt.scatter_counts(*st, counts, skipped if shortc else torch.zeros_like(skipped), lens, starts, pa, real)

    fused, plain, per_pair = state(), state(), state()
    dt.CountScatter(*fused, tiles, lens, starts, eps, dim_block=db, shortc=shortc, num_dims=n)(pa, pb, real)
    dt.tile_pair_count_scatter_plain(*plain, tiles, lens, starts, pa, pb, real, eps, dim_block=db,
                                     shortc=shortc, num_dims=n)
    scatter(*dt.tile_pair_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, num_dims=n), per_pair)
    near = state()
    scatter(boundary_slack(torch, tiles, lens, pa, pb, eps).sum(2, dtype=torch.int32),
            torch.zeros(real, dtype=torch.int32, device="cuda"), near)
    torch.cuda.synchronize()
    check(torch.equal(fused[0], per_pair[0]) and torch.equal(fused[1], per_pair[1]),
          "fused step != K1's per-pair epilogue + scatter_counts")
    diff = (fused[0] - plain[0]).abs()
    check(bool((diff <= near[0]).all()), "fused step: counts_sorted differs from plain beyond the eps boundary")
    check(torch.equal(fused[1], plain[1]), "fused step: skipped_tot differs from plain")

    st = state()
    with torch.cuda.device(tiles.device):
        step = count_step(*st, tiles, lens, starts, eps, dim_block=db, shortc=shortc, backend="pallas",
                          num_dims=n)
        run_k = lambda: step(pa, pb, real)  # noqa: E731
        k_ms, k_records = device_ms(torch, run_k, kernel=K1_KERNEL)
        k_event_ms = event_ms(torch, run_k, iters=50)
    run_p = lambda: dt.tile_pair_count_scatter_plain(*st, tiles, lens, starts, pa, pb, real, eps,  # noqa: E731
                                                     dim_block=db, shortc=shortc, num_dims=n)
    run_c = lambda: scatter(*dt.tile_pair_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, num_dims=n), st)  # noqa: E731
    run_e = lambda: scatter(*dt.tile_pair_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db), st)  # noqa: E731
    eps2 = dt.eps_squared(eps)
    run_l = lambda: scatter(yardstick(torch, tiles, lens, pa, pb, eps2)[0],  # noqa: E731
                            torch.zeros(real, dtype=torch.int32, device="cuda"), st)
    p_ms, _ = device_ms(torch, run_p, iters=5)
    c_ms, _ = device_ms(torch, run_c)
    e_ms, _ = device_ms(torch, run_e)
    e_event_ms = event_ms(torch, run_e, iters=50)
    l_ms, _ = device_ms(torch, run_l, iters=5)
    _, skipped = dt.tile_pair_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, num_dims=n)
    b_ms, b_by, nbytes, flop = bound(torch, tiles, pa, pb, n, db, skipped, False)
    rows_touched = int(torch.unique(pa).numel()) * tiles.shape[1]
    # no (P, T) counts or (P,) skipped written: the touched counts_sorted rows read and written
    nbytes += rows_touched * 4 * 2 - real * (tiles.shape[1] + 1) * 4
    b_ms = max(nbytes / PEAK_HBM_BYTES * 1e3, flop / PEAK_FP32_FLOPS * 1e3)
    rec = {
        "inputs": source, "pairs": real, "T": int(tiles.shape[1]), "n": n, "n_pad": int(tiles.shape[2]),
        "dim_block": db, "max_abs_err": int(diff.max()), "boundary_lanes": int(near[0].sum()),
        "ms": k_ms, "profiler_records": k_records, "event_ms": k_event_ms, "plain_ms": p_ms,
        "composed_ms": c_ms, "earlier_ms": e_ms, "earlier_event_ms": e_event_ms, "library_ms": l_ms,
        "bound_ms": b_ms, "bound_by": "bytes" if nbytes / PEAK_HBM_BYTES > flop / PEAK_FP32_FLOPS else "operations",
        "bytes": nbytes, "flop": flop,
        "composed": "K1's per-pair epilogue + scatter_counts (index_add_ and masks), device time per call",
        "earlier": "the step this kernel replaced: K1's tile_eval.cuh kernel + scatter_counts, device time "
                   "per call (earlier_event_ms: CUDA events over 50 back-to-back calls, host included)",
        "library": "the baddbmm yardstick + scatter_counts",
    }
    emit({"phase": "fused_step_real_width", "timing": "torch.profiler device time per launch of 20 (ms), "
          "per call (composed, earlier: 20; plain, library: 5); event_ms: CUDA events over 50 back-to-back "
          "bound calls, host time included", **rec, "smi": smi_sample()})
    return rec


def pairs_step_row(torch, tier, tables, point_order, pa, pb, n, eps, db, source):
    """One tier's fused pairs chunk step (epilogue c, both passes; tier
    "indexed": K2 in ``distance_tile_counts.cu``, "dense": K4 in
    ``dense_tile_fused.cu``) on a main-path chunk, at the ``hit_cap`` of
    the engine after its retry.  Held exactly against the same kernel's
    per-pair mask + ``engine.compact_mask`` (the reference's rank-select)
    and against its plain version up to the eps-boundary lanes; timed
    beside those, the step it replaced (the ``tile_eval.cuh`` kernel's mask
    + ``compact_mask``), the yardstick's mask + ``compact_mask``, and the
    bound over the real dims of the blocks this data computed, with the
    hits written."""
    from repro_torch.core.engine import compact_mask, pairs_step
    from repro_torch.kernels import dense_tile, distance_tile

    tiles, lens, starts = tables
    t = tiles.shape[1]
    real = pa.shape[0]
    eps2 = distance_tile.eps_squared(eps)
    if tier == "dense":
        def per_pair():
            return dense_tile.dense_tile_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, return_mask=True,
                                                  num_dims=n)

        def earlier_mask():
            return dense_tile.dense_tile_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db,
                                                            return_mask=True)[-1]

        plain_step, backend, kernel, k = dense_tile.dense_pairs_compact_plain, "dense", DENSE_KERNEL, "K4"
        fused_cls, file = dense_tile.DensePairsCompact, "dense_tile_fused.cu"
        earlier = "K4's tile_eval.cuh kernel (dense_tile.cu)"
    else:
        def per_pair():
            return distance_tile.tile_pair_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, return_mask=True,
                                                    num_dims=n)

        def earlier_mask():
            return distance_tile.tile_pair_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db,
                                                              return_mask=True)[-1]

        plain_step, backend, kernel, k = distance_tile.tile_pair_pairs_compact_plain, "pallas", K1_KERNEL, "K2"
        fused_cls, file = distance_tile.PairsCompact, "distance_tile_counts.cu"
        earlier = "K2's tile_eval.cuh kernel (distance_tile.cu)"
    got = per_pair()
    counts, mask = got[0], got[-1]
    skipped = got[1] if tier != "dense" else None
    nh = int(counts.sum())
    hit_cap = max(4096, -(-nh // 1024) * 1024)  # the engine's window after its hit_cap retry
    cap = nh + 8
    landed = landed_rows(0, nh, cap, hit_cap)

    def pstate():
        return pairs_state(torch, 0, cap, hit_cap)

    fused, composed, plain, replaced = pstate(), pstate(), pstate(), pstate()
    fused_cls(*fused, tiles, lens, starts, point_order, eps, hit_cap=hit_cap, chunk=real, dim_block=db,
              num_dims=n)(pa, pb, real)
    compact_mask(*composed, mask, starts, point_order, pa, pb, real, hit_cap=hit_cap)
    plain_step(*plain, tiles, lens, starts, point_order, pa, pb, real, eps, hit_cap=hit_cap, dim_block=db,
               num_dims=n)
    compact_mask(*replaced, earlier_mask(), starts, point_order, pa, pb, real, hit_cap=hit_cap)
    near_lanes = int(boundary_slack(torch, tiles, lens, pa, pb, eps).sum())
    torch.cuda.synchronize()
    check(int(fused[1]) == int(composed[1]) == nh and int(fused[2]) == int(composed[2]),
          f"the fused {tier} pairs step's offset / max {int(fused[1])} / {int(fused[2])} != composed's")
    check(torch.equal(fused[0][:landed], composed[0][:landed]),
          f"the fused {tier} pairs step's buffer != {k}'s per-pair epilogue + the PyTorch compaction")
    check(abs(int(plain[1]) - nh) <= near_lanes, f"the fused {tier} pairs step's hits differ from plain beyond "
          "the eps boundary")

    with torch.cuda.device(tiles.device):
        step = pairs_step(*pstate(), tiles, lens, starts, point_order, eps, hit_cap=hit_cap, dim_block=db,
                          backend=backend, chunk=real, num_dims=n)
        check(isinstance(step, fused_cls), f"engine.pairs_step bound {type(step).__name__} for the {tier} tier")
        run_k = lambda: step(pa, pb, real)  # noqa: E731
        means = kernel_ms(torch, run_k)
        k_event_ms = event_ms(torch, run_k, iters=50)
    check(all(kernel in key for key in means) and len(means) == 2,
          f"the fused {tier} pairs step launched {sorted(means)}, not the fused kernel's two passes")
    st = pstate()
    run_c = lambda: compact_mask(*st, per_pair()[-1], starts, point_order, pa, pb, real, hit_cap=hit_cap)  # noqa: E731
    run_e = lambda: compact_mask(*st, earlier_mask(), starts, point_order, pa, pb, real, hit_cap=hit_cap)  # noqa: E731
    run_p = lambda: plain_step(*st, tiles, lens, starts, point_order, pa, pb, real, eps,  # noqa: E731
                               hit_cap=hit_cap, dim_block=db, num_dims=n)
    run_l = lambda: compact_mask(*st, yardstick(torch, tiles, lens, pa, pb, eps2)[1].to(torch.int8),  # noqa: E731
                                 starts, point_order, pa, pb, real, hit_cap=hit_cap)
    _, _, nbytes, flop = bound(torch, tiles, pa, pb, n, db, skipped, False)
    uniq = int(torch.unique(torch.cat([pa, pb])).numel())
    # no (P, T) counts or skipped: the landed rows written (8 bytes each) and the touched point_order rows read
    nbytes += min(nh, hit_cap) * 8 + uniq * t * 4 - real * t * 4 - (real * 4 if skipped is not None else 0)
    return {
        "inputs": source, "pairs": real, "T": t, "n": n, "n_pad": int(tiles.shape[2]), "dim_block": db,
        "hits": nh, "hit_cap": hit_cap, "boundary_lanes": near_lanes,
        "max_abs_err": abs(int(plain[1]) - nh), "earlier_offset_diff": int(replaced[1]) - nh,
        "ms": sum(ms for ms, _ in means.values()), "pass_ms": {key[:70]: v for key, v in means.items()},
        "event_ms": k_event_ms,
        "composed_ms": device_ms(torch, run_c)[0], "earlier_ms": device_ms(torch, run_e)[0],
        "earlier_event_ms": event_ms(torch, run_e, iters=50),
        "plain_ms": device_ms(torch, run_p, iters=5)[0], "library_ms": device_ms(torch, run_l, iters=5)[0],
        "bound_ms": max(nbytes / PEAK_HBM_BYTES, flop / PEAK_FP32_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / PEAK_HBM_BYTES > flop / PEAK_FP32_FLOPS else "operations",
        "bytes": nbytes, "flop": flop,
        "composed": f"{k} per pair ({file} epilogue a, with the mask) + engine.compact_mask, device time per call",
        "earlier": f"the step this kernel replaced: {earlier} + engine.compact_mask, device time per call "
                   "(earlier_event_ms: CUDA events, 50 calls)",
        "library": "the baddbmm yardstick's mask + engine.compact_mask",
    }


def phase_indexed_pairs_step(torch, tables, point_order, pa, pb, n, eps, db, source):
    """K2's fused pairs chunk step on a main-path chunk (``pairs_step_row``)."""
    row = pairs_step_row(torch, "indexed", tables, point_order, pa, pb, n, eps, db, source)
    emit({"phase": "indexed_pairs_step_real_width", "timing": "torch.profiler device time (the sum of its two "
          "passes' per-launch means over 20 calls), per call (composed, earlier: 20; plain, library: 5); "
          "event_ms: CUDA events over 50 back-to-back bound calls, host time included", **row, "smi": smi_sample()})
    return row


def phase_dense_steps(torch, tables, point_order, num_points, count_chunk, pairs_chunk, n, eps, db, source):
    """The dense tier's two fused chunk steps on main-path chunks: the count
    step (epilogue b) on ``count_chunk``, the pairs step (epilogue c, both
    passes, ``pairs_step_row``) on ``pairs_chunk``.  The count step is held
    exactly against the per-pair epilogue (a) of the same kernel with
    ``scatter_counts`` around it and against its plain version up to the
    eps-boundary lanes; timed beside those, the step it replaced (K3's
    earlier kernel, dense_tile.cu, with ``scatter_counts``), the yardstick
    with ``scatter_counts``, and the bound over the real dims."""
    from repro_torch.core.engine import count_step
    from repro_torch.kernels import dense_tile as dt
    from repro_torch.kernels.distance_tile import eps_squared, scatter_counts

    tiles, lens, starts = tables
    t = tiles.shape[1]
    eps2 = eps_squared(eps)
    rows = {}

    # -- the count step
    pa, pb = count_chunk
    real = pa.shape[0]

    def state():
        return torch.zeros(num_points + 1, dtype=torch.int32, device="cuda")

    def scatter(counts, st):
        scatter_counts(st, None, counts, None, lens, starts, pa, real)

    fused, composed, plain, near, earlier = state(), state(), state(), state(), state()
    dt.DenseCountScatter(fused, tiles, lens, starts, eps, dim_block=db, num_dims=n)(pa, pb, real)
    scatter(dt.dense_tile_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, num_dims=n)[0], composed)
    dt.dense_count_scatter_plain(plain, tiles, lens, starts, pa, pb, real, eps, dim_block=db, num_dims=n)
    scatter(dt.dense_tile_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db)[0], earlier)
    scatter(boundary_slack(torch, tiles, lens, pa, pb, eps).sum(2, dtype=torch.int32), near)
    torch.cuda.synchronize()
    check(torch.equal(fused, composed), "the fused dense count step != K3's per-pair epilogue + scatter_counts")
    diff = (fused - plain).abs()
    check(bool((diff <= near).all()), "the fused dense count step differs from plain beyond the eps boundary")
    st = state()
    with torch.cuda.device(tiles.device):
        step = count_step(st, torch.zeros((), dtype=torch.int32, device="cuda"), tiles, lens, starts, eps,
                          dim_block=db, shortc=False, backend="dense", num_dims=n)
        run_k = lambda: step(pa, pb, real)  # noqa: E731
        k_ms, k_records = device_ms(torch, run_k, kernel=DENSE_KERNEL)
        k_event_ms = event_ms(torch, run_k, iters=50)
    run_c = lambda: scatter(dt.dense_tile_distance(tiles, lens, pa, pb, eps=eps, dim_block=db, num_dims=n)[0], st)  # noqa: E731
    run_e = lambda: scatter(dt.dense_tile_distance_tile_eval(tiles, lens, pa, pb, eps=eps, dim_block=db)[0], st)  # noqa: E731
    run_p = lambda: dt.dense_count_scatter_plain(st, tiles, lens, starts, pa, pb, real, eps, dim_block=db,  # noqa: E731
                                                 num_dims=n)
    run_l = lambda: scatter(yardstick(torch, tiles, lens, pa, pb, eps2)[0], st)  # noqa: E731
    b_ms, b_by, nbytes, flop = bound(torch, tiles, pa, pb, n, db, None, False)
    touched = int(torch.unique(pa).numel()) * t
    nbytes += touched * 4 * 2 - real * t * 4  # no (P, T) counts written: the touched counts rows read and written
    rows["dense_count_scatter"] = {
        "inputs": source, "pairs": real, "T": t, "n": n, "n_pad": int(tiles.shape[2]), "dim_block": db,
        "max_abs_err": int(diff.max()), "boundary_lanes": int(near.sum()),
        "earlier_count_diffs": int((earlier != fused).sum()),
        "ms": k_ms, "profiler_records": k_records, "event_ms": k_event_ms,
        "composed_ms": device_ms(torch, run_c)[0], "earlier_ms": device_ms(torch, run_e)[0],
        "earlier_event_ms": event_ms(torch, run_e, iters=50),
        "plain_ms": device_ms(torch, run_p, iters=5)[0], "library_ms": device_ms(torch, run_l, iters=5)[0],
        "bound_ms": max(nbytes / PEAK_HBM_BYTES, flop / PEAK_FP32_FLOPS) * 1e3,
        "bound_by": "bytes" if nbytes / PEAK_HBM_BYTES > flop / PEAK_FP32_FLOPS else "operations",
        "bytes": nbytes, "flop": flop,
        "composed": "K3 per pair (dense_tile_fused.cu epilogue a) + scatter_counts, device time per call",
        "earlier": "the step this kernel replaced: K3's tile_eval.cuh kernel (dense_tile.cu) + scatter_counts, "
                   "device time per call (earlier_event_ms: CUDA events over 50 back-to-back calls)",
        "library": "the baddbmm yardstick + scatter_counts",
    }

    # -- the pairs step
    rows["dense_pairs_compact"] = pairs_step_row(torch, "dense", tables, point_order, *pairs_chunk, n, eps, db,
                                                 source)
    emit({"phase": "dense_steps_real_width", "timing": "torch.profiler device time (count: per launch of 20, "
          "the mean over the records kept; pairs: the sum of its two passes' per-launch means), per call "
          "(composed, earlier: 20; plain, library: 5); event_ms: CUDA events over 50 back-to-back bound calls, "
          "host time included", "steps": rows, "smi": smi_sample()})
    return rows


# -- phase 5 -----------------------------------------------------------------


def attn_inputs(torch, np, bh, sq, sk, dh, dv, dtype, seed):
    """q, k, v on the card: standard normal f32 from a numpy seed, cast to dtype."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(dtype)
            for shape in ((bh, sq, dh), (bh, sk, dh), (bh, sk, dv))]


def attn_check(torch, got, want, rtol, atol, what):
    """Fail unless got is finite and |got - want| <= rtol |want| + atol in f32;
    returns the max abs error and the largest |got - want| / limit."""
    check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or type differs from plain")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ratio = diff / (rtol * w.abs() + atol)
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    check(bool((ratio <= 1).all()), f"{what}: differs from plain beyond {rtol} |want| + {atol}")
    return float(diff.max()), float(ratio.max())


def phase_attention_sweep(torch, np, fa):
    """K5 against its plain version over head widths, lengths, masks, scales,
    types and chunk pairs (the lengths are ragged against the kernels'
    tiles); each call must count one launch of its route's kernel.  Reports
    the cases and the largest error per route and type."""
    worst, per_route = {}, {}
    cases = 0
    for dh, dv in ATTN_DIMS:
        for sq, sk in ATTN_LENS:
            for causal in (False, True):
                for scale in (None, 0.125):
                    for dtype in ATTN_TOL:
                        qc, kc = ATTN_CHUNKS[cases % len(ATTN_CHUNKS)]
                        q, k, v = attn_inputs(torch, np, 3, sq, sk, dh, dv, getattr(torch, dtype), seed=2000 + cases)
                        kw = dict(causal=causal, q_chunk=qc, k_chunk=kc, scale=scale)
                        route = fa._route(q, v)
                        before = dict(fa.LAUNCHES)
                        got = fa.flash_attention(q, k, v, **kw)
                        want = fa.flash_attention_plain(q, k, v, **kw)
                        torch.cuda.synchronize()
                        what = (f"flash_attention ({route}) dh={dh} dv={dv} sq={sq} sk={sk} causal={causal} "
                                f"scale={scale} {dtype} chunks=({qc},{kc})")
                        expect = {key: n + (key == fa.ROUTE_KERNEL[route]) for key, n in before.items()}
                        check(fa.LAUNCHES == expect, f"{what}: launches {fa.LAUNCHES}, expected {expect}")
                        err, _ = attn_check(torch, got, want, ATTN_TOL[dtype], ATTN_TOL[dtype], what)
                        key = f"{route}/{dtype}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        per_route[key] = per_route.get(key, 0) + 1
                        cases += 1
    for key in ("wgmma/bfloat16", "cuda_core/float32", "cuda_core/bfloat16"):
        check(per_route.get(key, 0) > 0, f"the attention sweep never took route {key}")
    rec = {"phase": "attention_sweep", "cases": cases, "cases_per_route": per_route,
           "max_abs_err": worst, "tolerance": ATTN_TOL}
    emit(rec)
    return rec


def attn_bound(bh, sq, sk, dh, dv, causal, elem_bytes, peak_flops):
    """Least time on the card, ms: max(bytes / HBM rate, flop / peak).

    Bytes: q, k, v read once and o written once.  Flop: 2 (dh + dv) per live
    (row, col) pair and head, where live counts the causal pairs (top-left
    aligned: row r sees min(r + 1, sk) keys), not the masked ones.
    """
    if causal:
        n = min(sq, sk)
        live = n * (n + 1) // 2 + max(sq - sk, 0) * sk
    else:
        live = sq * sk
    flop = 2 * live * (dh + dv) * bh
    nbytes = bh * (sq * dh + sk * dh + sk * dv + sq * dv) * elem_bytes
    by_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    by_ops = flop / peak_flops * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops else "operations"), nbytes, flop


def event_ms(torch, fn, iters):
    """Time per call from CUDA events around ``iters`` back-to-back calls,
    after one call to warm up.  At phase 5's full width a call keeps the
    card busy for a millisecond or more, which hides the host's gaps between
    launches; unlike a profiler session, events miss no call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_yardstick(torch, q, k, v, scale, got, want):
    """torch's scaled_dot_product_attention on the same tensors (4-D views,
    is_causal, the same scale), timed as library_ms and never used by the
    port.  Returns (ms, max abs difference to K5, SDPA's largest
    |sdpa - plain| / (rtol |plain| + atol) under ATTN_FULL_TOL, None), or
    (None, None, None, SDPA's reason) where it refuses the shape.  SDPA
    rounds P to bf16 (cuDNN / flash backends), so its ratio may exceed 1:
    a yardstick of a less exact function, not a failure."""
    import torch.nn.functional as F

    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    run = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, scale=scale)  # noqa: E731
    try:
        out = run()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        reason = str(exc).strip().splitlines()[0][:300]
        print(f"chip_smoke: scaled_dot_product_attention refused: {reason}", flush=True)
        return None, None, None, reason
    o, w = out[0].float(), want.float()
    diff = float((o - got.float()).abs().max())
    rtol, atol = ATTN_FULL_TOL
    ratio = float(((o - w).abs() / (rtol * w.abs() + atol)).max())
    del out, o, w
    return event_ms(torch, run, iters=10), diff, ratio, None


def phase_attention(torch, np, fa):
    """K5's path at full width: one call per model shape with the launch
    counters from 0 (only the tensor-core kernel may launch), then each
    output against the plain version within ATTN_FULL_TOL, and the kernel,
    the CUDA-core kernel on the same inputs (``earlier``), plain, SDPA (CUDA
    events; the kernel also by torch.profiler), bound and design floor."""
    inputs = {name: attn_inputs(torch, np, c["bh"], c["s"], c["s"], c["dh"], c["dv"], torch.bfloat16, seed=i)
              for i, (name, c) in enumerate(ATTN_SHAPES.items())}
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    outs = {}
    t0 = time.perf_counter()
    for name, c in ATTN_SHAPES.items():
        outs[name] = fa.flash_attention(*inputs[name], causal=True, q_chunk=c["q_chunk"], k_chunk=c["k_chunk"])
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    check(launches["flash_attention_wgmma"] == len(ATTN_SHAPES),
          f"the full-width calls launched {launches}, not the tensor-core kernel once per shape")
    check(all(n == 0 for key, n in launches.items() if key != "flash_attention_wgmma"),
          f"the full-width calls launched another kernel: {launches}")

    shapes = {}
    for name, c in ATTN_SHAPES.items():
        q, k, v = inputs.pop(name)
        got = outs.pop(name)
        kw = dict(causal=True, q_chunk=c["q_chunk"], k_chunk=c["k_chunk"])
        want = fa.flash_attention_plain(q, k, v, **kw)
        err, err_share = attn_check(torch, got, want, *ATTN_FULL_TOL, f"flash_attention at {name}")
        mean_abs = float(want.float().abs().mean())
        scale = float(c["dh"]) ** -0.5
        # the CUDA-core kernel (K5's bf16 route before the tensor-core kernel) on the same inputs
        run_e = lambda: fa._launch("cuda_core", q, k, v, True, scale)  # noqa: E731
        e_err, e_share = attn_check(torch, run_e(), want, *ATTN_FULL_TOL, f"CUDA-core flash_attention at {name}")
        l_ms, l_diff, l_share, l_refused = sdpa_yardstick(torch, q, k, v, scale, got, want)
        del want
        run_k = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        run_p = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
        k_ms = event_ms(torch, run_k, iters=5)
        e_ms = event_ms(torch, run_e, iters=3)
        k_prof_ms, k_records = device_ms(torch, run_k, iters=5, kernel="flash_wgmma_kernel")
        p_ms = event_ms(torch, run_p, iters=3)
        b_ms, b_by, nbytes, flop = attn_bound(c["bh"], c["s"], c["s"], c["dh"], c["dv"], True, 2, PEAK_BF16_FLOPS)
        floor_ms = b_ms * (c["dh"] + 2 * c["dv"]) / (c["dh"] + c["dv"])  # P V twice: hi and lo
        shapes[name] = {
            "source": c["source"], "bh": c["bh"], "sq": c["s"], "sk": c["s"], "dh": c["dh"], "dv": c["dv"],
            "q_chunk": c["q_chunk"], "k_chunk": c["k_chunk"], "dtype": "bfloat16", "causal": True,
            "max_abs_err": err, "err_over_limit": err_share, "mean_abs_out": mean_abs,
            "ms": k_ms, "profiler_ms": k_prof_ms, "profiler_records": k_records,
            "earlier_ms": e_ms, "earlier_err_over_limit": e_share, "earlier_max_abs_err": e_err,
            "plain_ms": p_ms, "library_ms": l_ms, "library_refused": l_refused,
            "library_max_abs_diff": l_diff, "library_err_over_limit": l_share,
            "bound_ms": b_ms, "bound_by": b_by, "floor_ms": floor_ms, "bytes": nbytes, "flop": flop,
            "useful_tflops": flop / k_ms / 1e9,
            "executed_tflops": flop * (c["dh"] + 2 * c["dv"]) / (c["dh"] + c["dv"]) / k_ms / 1e9,
        }
    rec = {"phase": "attention", "timing": "CUDA events per call over 5 (kernel), 3 (earlier: the CUDA-core "
           "kernel; plain), 10 (library) back-to-back calls; profiler_ms: torch.profiler per launch of 5",
           "launches": launches,
           "path_s": path_s, "tolerance": {"rtol": ATTN_FULL_TOL[0], "atol": ATTN_FULL_TOL[1]},
           "shapes": shapes, "smi": smi_sample()}
    emit(rec)
    return rec


def attention_row(attn, serving, distributed, fused, downstream):
    """K5's entry of the kernels line: per call, the mean over its path's
    calls (one per full-width shape; each shape's numbers are in the
    attention line), and the largest error over them."""
    shapes = list(attn["shapes"].values())

    def mean(key):
        vals = [sh[key] for sh in shapes]
        return None if None in vals else sum(vals) / len(vals)

    return {
        "name": "flash_attention_wgmma", "route": "cuda", "source": KERNELS["flash_attention_wgmma"][1],
        "replaces": KERNELS["flash_attention_wgmma"][2], "launches": attn["launches"]["flash_attention_wgmma"],
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
        "bound_by": max(shapes, key=lambda sh: sh["bound_ms"])["bound_by"], "library_ms": mean("library_ms"),
        "floor_ms": mean("floor_ms"), "earlier_ms": mean("earlier_ms"),
        "earlier": "the CUDA-core kernel (src/repro_torch/csrc/flash_attention.cu, K5's route for bf16 "
                   "before the tensor-core kernel) on the same inputs in this run",
        "timing": "CUDA events",
        "path": "phase 5: flash_attention's own entry point, one call per full-width shape "
                "(phases 3-4 never call it); times are per call, the mean over those calls",
        "serving_launches": serving["flash_attention_wgmma"],  # phase 7 checks it is 0
        "distributed_launches": distributed["flash_attention_wgmma"],  # phase 8 checks it is 0
        "fused_ring_launches": fused["flash_attention_wgmma"],  # phase 9 checks it is 0
        "downstream_launches": downstream["flash_attention_wgmma"],  # phase 10 checks it is 0
    }


# -- phases 3 and 4 ----------------------------------------------------------


def spot_check(torch, np, d, counts, eps, n_sample=256, seed=0):
    """Sampled points' counts against a float64 brute force on the card."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(d.shape[0], size=min(n_sample, d.shape[0]), replace=False)
    lo, hi = count_bounds(torch, torch.from_numpy(d).cuda(), idx, eps)
    got = counts[idx]
    return int(idx.shape[0]), int(((got < lo) | (got > hi)).sum())


def phase_count(torch, np, engine, d, host_s):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = engine.count()
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()  # before the spot check's own buffers
    st = res.stats
    n_checked, bad = spot_check(torch, np, d, res.counts, SYN_EPS)
    check(bad == 0, f"Syn16D2M spot check: {bad} of {n_checked} sampled counts off")
    check(res.counts.shape == (d.shape[0],) and (res.counts >= 1).all(), "Syn16D2M counts malformed")
    rec = {
        "phase": "count", "dataset": "Syn16D2M", "points": int(d.shape[0]), "dims": int(d.shape[1]),
        "eps": SYN_EPS, "cut": None, "host_plan_s": host_s, "device_s": device_s,
        "results": st.num_results, "tile_pairs": st.num_tile_pairs_evaluated,
        "tile_pairs_total": st.num_tile_pairs_total, "candidates": st.num_candidates,
        "dim_blocks_skipped": st.dim_blocks_skipped, "dim_blocks_total": st.dim_blocks_total,
        "chunks": st.num_chunks, "peak_device_bytes": peak,
        "spot_checked": n_checked, "spot_bad": bad,
    }
    emit(rec)
    return rec, res.counts


def timed_pairs(obs, engine):
    """``engine.pairs()`` under an obs capture: the result, its wall time,
    the kinds of its retries, and the time split by the engine's spans into
    what runs before the first chunk loop (the result-size estimate, the
    buffer), the chunk loops (``engine.pairs`` spans: launches and the read
    of ``offset`` at each pass's end) and what follows them (the copy of the
    pairs to the host and the per-point ``bincount``)."""
    with obs.capture() as cap:
        with obs.span("smoke.pairs", "smoke"):
            res = engine.pairs()
    outer = cap.spans(name="smoke.pairs")[0]
    loops = cap.spans(name="engine.pairs")
    last = max(e.ts_us + e.dur_us for e in loops)
    split = {"before_loops_s": (min(e.ts_us for e in loops) - outer.ts_us) / 1e6,
             "loops_s": sum(e.dur_us for e in loops) / 1e6,
             "after_loops_s": (outer.ts_us + outer.dur_us - last) / 1e6}
    kinds = [e.attrs["kind"] for e in cap.spans(name="engine.pairs.retry")]
    return res, outer.dur_us / 1e6, kinds, split


def phase_pairs(torch, np, engine, d, dense_engine, dense_host_s):
    """CoocTexture: the indexed tier's count and pairs, then the dense
    tier's (``dense_engine``, built beforehand: its host plan took
    ``dense_host_s``).  Each count must launch its tier's fused count
    kernel once per chunk and nothing else, and each pairs its tier's fused
    pairs kernel twice per chunk and nothing else but the result-size
    estimate's K1 (indexed) or K3 (dense)."""
    from repro_torch import obs
    from repro_torch.kernels import dense_tile, distance_tile

    def launched(before):
        return {k: v - before[k] for k, v in {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}.items()}

    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    t0 = time.perf_counter()
    rc = engine.count()
    count_s = time.perf_counter() - t0
    grew = launched(before)
    check(grew == {k: rc.stats.num_chunks if k == SCATTER[0] else 0 for k in grew},
          f"the indexed count ran {rc.stats.num_chunks} chunks and launched {grew}")
    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    rp, pairs_s, kinds, split = timed_pairs(obs, engine)
    indexed_launches = launched(before)
    est = indexed_launches["tile_pair_distance"]  # the result-size estimate's K1 (ops.tile_counts chunks)
    check(est > 0 and indexed_launches == {
        k: 2 * rp.stats.num_device_dispatches if k == PAIRS[0] else est if k == "tile_pair_distance" else 0
        for k in indexed_launches},
        f"the indexed pairs ran {rp.stats.num_device_dispatches} chunks and launched {indexed_launches}")
    check(rp.stats.overflow_retries == len(kinds), f"retries {rp.stats.overflow_retries} != retry events {kinds}")
    check(rp.pairs.shape == (rc.stats.num_results, 2), "pairs count != count() sum")
    check(np.array_equal(rp.counts, rc.counts), "pairs() counts != count() counts")
    pr = torch.from_numpy(rp.pairs).cuda().long()
    n = d.shape[0]
    fwd = torch.sort(pr[:, 0] * n + pr[:, 1]).values
    rev = torch.sort(pr[:, 1] * n + pr[:, 0]).values
    check(torch.equal(fwd, rev), "pair set is not symmetric")
    check(int(torch.unique_consecutive(fwd).numel()) == fwd.numel(), "duplicate pairs")
    del pr, fwd, rev

    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd = dense_engine.count()
    dense_s = time.perf_counter() - t0
    count_launches = launched(before)
    check(count_launches == {k: rd.stats.num_chunks if k == "dense_count_scatter" else 0 for k in count_launches},
          f"the dense count ran {rd.stats.num_chunks} chunks and launched {count_launches}")
    before = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    rdp, dense_pairs_s, dense_kinds, dense_split = timed_pairs(obs, dense_engine)
    pairs_launches = launched(before)
    est = pairs_launches["dense_tile_distance"]  # the result-size estimate's K3 (ops.tile_counts chunks)
    check(est > 0 and pairs_launches == {
        k: 2 * rdp.stats.num_device_dispatches if k == "dense_pairs_compact" else est if k == "dense_tile_distance"
        else 0 for k in pairs_launches},
        f"the dense pairs ran {rdp.stats.num_device_dispatches} chunks and launched {pairs_launches}")
    check(np.array_equal(rdp.counts, rd.counts), "dense pairs() counts != dense count()")
    check(rdp.pairs.shape == (rd.stats.num_results, 2), "dense pairs count != dense count() sum")
    dp = torch.from_numpy(rdp.pairs).cuda().long()
    check(torch.equal(torch.sort(dp[:, 0] * n + dp[:, 1]).values, torch.sort(dp[:, 1] * n + dp[:, 0]).values),
          "the dense pair set is not symmetric")
    diff = np.nonzero(rd.counts != rc.counts)[0]
    if diff.size:  # allowed only at the eps boundary (raw fp32 data)
        lo, hi = count_bounds(torch, torch.from_numpy(d).cuda(), diff, COOC_EPS)
        for got in (rd.counts[diff], rc.counts[diff]):
            check(bool(((got >= lo) & (got <= hi)).all()),
                  "dense and indexed counts differ beyond the eps boundary")
    rec = {
        "phase": "pairs", "dataset": "CoocTexture", "points": int(n), "dims": int(d.shape[1]),
        "eps": COOC_EPS, "results": rc.stats.num_results, "tile_pairs": rc.stats.num_tile_pairs_evaluated,
        "count_s": count_s, "count_chunks": rc.stats.num_chunks, "pairs_s": pairs_s, "pairs_split": split,
        "overflow_retries": rp.stats.overflow_retries, "retry_kinds": kinds, "pairs_capacity": rp.stats.pairs_capacity,
        "pairs_chunks": rp.stats.num_chunks, "pairs_dispatches": rp.stats.num_device_dispatches,
        "pairs_launches": {k: v for k, v in indexed_launches.items() if v},
        "dense_host_plan_s": dense_host_s, "dense_count_s": dense_s, "dense_count_chunks": rd.stats.num_chunks,
        "dense_count_launches": {k: v for k, v in count_launches.items() if v},
        "dense_pairs_s": dense_pairs_s, "dense_pairs_split": dense_split,
        "dense_overflow_retries": rdp.stats.overflow_retries, "dense_retry_kinds": dense_kinds,
        "dense_pairs_capacity": rdp.stats.pairs_capacity, "dense_pairs_dispatches": rdp.stats.num_device_dispatches,
        "dense_pairs_launches": {k: v for k, v in pairs_launches.items() if v},
        "dense_tile_pairs": rd.stats.num_tile_pairs_evaluated, "dense_execution": rd.stats.execution,
        "dense_vs_indexed_boundary_diffs": int(diff.size),
    }
    emit(rec)
    return rec, rc.counts, rp.pairs


def phase_wide_dense(torch, np, SelfJoinConfig, SelfJoinEngine, paper_dataset):
    """The dense tier's general path on real work: Syn64D2M at 200,000 x 64
    (two real dim blocks), execution="dense", counts at each of WIDE_EPS
    (at 0.1 each point's only neighbour is itself; 0.2 gives thousands);
    at each, the cost model's choice under execution="auto" with both
    costs, 256 sampled counts against the float64 brute force, and the
    indexed tier's counts against the dense ones, both within the boundary
    band.  Host plans (the snapshot at each radius) are timed apart from
    the device parts."""
    from repro_torch.core import cost as cost_mod
    from repro_torch.kernels import dense_tile

    d = paper_dataset("Syn64D2M", WIDE_N / 2_000_000)
    engines = {}
    rec = {"phase": "wide_dense", "dataset": "Syn64D2M", "points": int(d.shape[0]), "dims": int(d.shape[1]),
           "cut": "200,000 of 2,000,000 points (paper_dataset scale 0.1)", "eps": {}}
    for eps in WIDE_EPS:
        out = {}
        for tier in ("dense", "indexed"):
            t0 = time.perf_counter()
            if tier not in engines:
                engines[tier] = SelfJoinEngine(d, SelfJoinConfig(eps=eps, execution=tier))
            eng = engines[tier]
            eng.resolve_execution(eps)  # the snapshot at this radius (a host plan)
            if tier == "dense":
                eng.snapshot.dense_tables().chunks(eng.engine.count_chunk)
            host_s = time.perf_counter() - t0
            before = dict(dense_tile.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.count(eps)
            torch.cuda.synchronize()
            device_s = time.perf_counter() - t0
            out[tier] = res
            st = res.stats
            rec["eps"].setdefault(str(eps), {}).update({
                f"{tier}_host_plan_s": host_s, f"{tier}_count_s": device_s,
                f"{tier}_tile_pairs": st.num_tile_pairs_evaluated, f"{tier}_chunks": st.num_chunks})
            if tier == "dense":
                grew = {k: v - before[k] for k, v in dense_tile.LAUNCHES.items()}
                check(grew == {k: st.num_chunks if k == "dense_count_scatter" else 0 for k in grew},
                      f"the Syn64D2M dense count ran {st.num_chunks} chunks and launched {grew}")
                dt = eng.snapshot.dense_tables()
                n_checked, bad = spot_check(torch, np, d, res.counts, eps)
                check(bad == 0, f"Syn64D2M eps={eps}: {bad} of {n_checked} sampled dense counts off")
                auto = cost_mod.decide(st.cost_indexed, st.cost_dense, "auto")
                rec["eps"][str(eps)].update({
                    "results": st.num_results, "mean_neighbours": st.num_results / d.shape[0],
                    "tiles": int(dt.plan.num_tiles), "real_tile_bytes": int(dt.plan.num_tiles) * 64 * int(
                        eng.n_pad) * 4, "allocated_tile_bytes": int(dt.tiles.numel() * 4),
                    "n_pad": int(eng.n_pad), "dim_blocks": int(eng.snapshot.num_dim_blocks),
                    "launches": {k: v for k, v in grew.items() if v}, "auto_execution": auto.execution,
                    "cost_indexed": st.cost_indexed, "cost_dense": st.cost_dense,
                    "spot_checked": n_checked, "spot_bad": bad})
        diff = np.nonzero(out["indexed"].counts != out["dense"].counts)[0]
        if diff.size:
            lo, hi = count_bounds(torch, torch.from_numpy(d).cuda(), diff, eps)
            for got in (out["indexed"].counts[diff], out["dense"].counts[diff]):
                check(bool(((got >= lo) & (got <= hi)).all()),
                      f"Syn64D2M eps={eps}: dense and indexed counts differ beyond the eps boundary")
        rec["eps"][str(eps)]["dense_vs_indexed_boundary_diffs"] = int(diff.size)
    emit(rec)
    return rec


# -- the serving phase -------------------------------------------------------

SERVE_SIZES = (1, 100, 1024)   # Syn16D2M: one range_count request of each size,
SERVE_STREAM = (64, 1024)      # then 64 requests of 1024 queries,
SERVE_PAIRS = 1024             # then one range_pairs request of 1024 queries
KNN_QUERIES, KNN_K = 512, 16   # CoocTexture kNN
CHURN = 4096                   # CoocTexture inserts, and deletes
CHURN_GRID = 256               # the churn index's points on a 1/256 lattice: every fp32
                               # distance of the port is exact there (DESIGN.md #6), so
                               # the answers across compact() must be equal bit for bit
SERVE_SPLIT = ("pin", "host_plan", "tables", "count_loop", "aux", "pairs", "finish")


def jittered_queries(np, rng, d, n, sigma):
    """``n`` queries: the first half are rows of ``d`` (returned with their
    row ids), the rest rows of ``d`` moved by N(0, sigma) in every dim."""
    rows = rng.choice(d.shape[0], size=n, replace=False)
    q = d[rows].copy()
    n_rows = (n + 1) // 2
    q[n_rows:] += rng.normal(0.0, sigma, size=q[n_rows:].shape).astype(np.float32)
    return q, rows[:n_rows]


def ulps_apart(np, got, want):
    """Largest distance between float64 arrays in units in the last place of
    ``want``: the square roots of one exact d2 by two libraries may differ
    by one."""
    if got.size == 0:
        return 0
    return int(np.max(np.abs(got - want) / np.spacing(np.abs(want))))


def brute_pairs_at(torch, np, pts, q, eps, ids):
    """float64 (query row, ids[row of pts]) pairs within eps, lexsorted, and
    the per-query counts: the exact answer where fp32 is exact (lattice data)."""
    from repro_torch.core.brute import sqdist_f64

    e2 = float(eps) ** 2
    ids = torch.as_tensor(ids, device=pts.device)
    pairs = []
    for s in range(0, q.shape[0], 32):
        hit = (sqdist_f64(q[s:s + 32], pts) <= e2).nonzero()
        pairs.append(torch.stack([hit[:, 0] + s, ids[hit[:, 1]]], dim=1))
    pairs = torch.cat(pairs).cpu().numpy()
    return pairs, np.bincount(pairs[:, 0], minlength=q.shape[0]).astype(np.int64)


def brute_topk(torch, pts, q, k):
    """float64 top-k of the rows of ``pts`` around each row of ``q`` on the
    card, ties by row (a stable sort): (rows, distances), both (|q|, k)."""
    from repro_torch.core.brute import sqdist_f64

    rows, dist = [], []
    for s in range(0, q.shape[0], 16):
        d2 = sqdist_f64(q[s:s + 16], pts)
        order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
        rows.append(order)
        dist.append(torch.gather(d2, 1, order))
    return torch.cat(rows).cpu().numpy(), torch.cat(dist).sqrt().cpu().numpy()


def serve_split(cap):
    """Each request of an obs capture split by the service's spans, seconds
    summed over the requests: ``pin`` (service.pin), ``host_plan``
    (engine.build_query_plan), ``tables`` (the rest of
    engine.prepare_query: query tiles, the combined (query | data) tables),
    ``count_loop`` (the rest of each service.eps_round: the count chunk
    launches, the read of the counts), ``aux`` (service.aux, the churn
    epilogue), ``pairs`` (service.epilogue: the pairs pass and the global
    ids) and ``finish`` (what follows: stats, kNN's top-k, mirroring)."""
    out = dict.fromkeys(SERVE_SPLIT, 0.0)
    reqs = cap.spans("service.request", "request")
    for r in reqs:
        end = r.ts_us + r.dur_us
        sub = [e for e in cap.events if e.ph == "X" and r.ts_us <= e.ts_us and e.ts_us + e.dur_us <= end]

        def total(name):
            return sum(e.dur_us for e in sub if e.name == name) / 1e6

        rounds, prepare, plan = total("service.eps_round"), total("engine.prepare_query"), total(
            "engine.build_query_plan")
        out["pin"] += total("service.pin")
        out["host_plan"] += plan
        out["tables"] += prepare - plan
        out["aux"] += total("service.aux")
        out["count_loop"] += rounds - prepare - total("service.aux")
        out["pairs"] += total("service.epilogue")
        out["finish"] += r.dur_us / 1e6 - total("service.pin") - rounds - total("service.epilogue")
    return out


def launched_since(before, *mods):
    return {k: v - before[k] for mod in mods for k, v in mod.LAUNCHES.items()}


def phase_serving(torch, np, syn_engine, syn, syn_counts, cooc_engine, dense_engine, seed):
    """The serving path (``repro_torch.join``): ``SimilarityIndex`` +
    ``QueryService`` over the combined (query | data) tables.

    Syn16D2M (phase 3's engine, wrapped: no second build): range_count
    requests of SERVE_SIZES queries, a stream of SERVE_STREAM, one
    range_pairs of SERVE_PAIRS; the queries are data rows and jittered rows
    drawn from ``seed``.  Data-row queries must count what phase 3 counted
    for their rows (any difference inside the boundary band), jittered ones
    the float64 brute force on a sample (within the band), pair row sums
    the counts, and the chunk loops must launch K1's fused count step once
    per count chunk and K2's fused pairs step twice per pairs chunk, nothing
    else.  CoocTexture: kNN (phase 4's engine, wrapped) against the float64
    top-k; churn on a 1/CHURN_GRID-lattice copy (inserts, deletes, answers
    equal to the brute force on the live set, compact() bit-identical with
    no new trace, a save / load round trip); phase 4's dense engine,
    wrapped, whose requests must launch only the dense fused steps."""
    from repro_torch import obs
    from repro_torch.core import SelfJoinConfig
    from repro_torch.join import QueryService, SimilarityIndex
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention

    mods = (distance_tile, dense_tile, flash_attention)  # every kernel's counters, K5's included

    def read():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    pts = torch.from_numpy(syn).cuda()
    index = SimilarityIndex._wrap(syn_engine)
    svc = QueryService(index)
    snap = syn_engine.snapshot
    rec = {"phase": "serving", "dataset": "Syn16D2M", "points": int(syn.shape[0]), "eps": SYN_EPS,
           "seed": seed, "tile_rows": snap.tile_rows, "point_rows": snap.point_rows,
           "data_tile_bytes": int(snap.tiles.numel() * 4)}
    row_diffs, row_checked, jitter_checked, jitter_bad = 0, 0, 0, 0

    def check_counts(q, rows, counts, sample=None):
        """Data-row queries against phase 3, a sample of jittered ones against the brute force."""
        nonlocal row_diffs, row_checked, jitter_checked, jitter_bad
        n_rows = rows.shape[0]
        diff = np.nonzero(counts[:n_rows] != syn_counts[rows])[0]
        if diff.size:
            lo, hi = count_bounds(torch, pts, rows[diff], SYN_EPS)
            for got in (counts[diff], syn_counts[rows[diff]]):
                check(bool(((got >= lo) & (got <= hi)).all()),
                      "Syn16D2M serving: a data-row query's count differs from phase 3 beyond the eps boundary")
        row_diffs += int(diff.size)
        row_checked += n_rows
        jit = np.arange(n_rows, q.shape[0])
        if sample is not None and jit.size > sample:
            jit = rng.choice(jit, size=sample, replace=False)
        if jit.size:
            lo, hi = query_count_bounds(torch, pts, torch.from_numpy(q[jit]).cuda(), SYN_EPS)
            bad = int(((counts[jit] < lo) | (counts[jit] > hi)).sum())
            jitter_bad += bad
            jitter_checked += int(jit.size)
            check(bad == 0, f"Syn16D2M serving: {bad} of {jit.size} jittered counts off the float64 brute force")

    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    sizes = {}
    with obs.capture(capacity=1 << 20) as cap:
        for n in SERVE_SIZES:
            q, rows = jittered_queries(np, rng, syn, n, SYN_EPS / 8)
            t0 = time.perf_counter()
            res = svc.range_count(q, SYN_EPS)
            sizes[str(n)] = {"wall_s": time.perf_counter() - t0, "traces": res.stats.num_traces,
                             "chunks": res.stats.num_device_dispatches, "results": res.stats.num_results}
            check_counts(q, rows, res.counts)
        walls, stream_results, stream_queries = [], 0, 0
        n_req, nq = SERVE_STREAM
        traces0 = svc.total.num_traces
        t_stream = time.perf_counter()
        for i in range(n_req):
            q, rows = jittered_queries(np, rng, syn, nq, SYN_EPS / 8)
            t0 = time.perf_counter()
            res = svc.range_count(q, SYN_EPS)
            walls.append(time.perf_counter() - t0)
            stream_results += res.stats.num_results
            stream_queries += nq
            check_counts(q, rows, res.counts, sample=16 if i % 8 else None)
        stream_s = time.perf_counter() - t_stream
        stream_traces = svc.total.num_traces - traces0
        q, rows = jittered_queries(np, rng, syn, SERVE_PAIRS, SYN_EPS / 8)
        t0 = time.perf_counter()
        rp = svc.range_pairs(q, SYN_EPS)
        pairs_s = time.perf_counter() - t0
        rc = svc.range_count(q, SYN_EPS)
    launches = read()  # counted from 0 above
    n_count = cap.span_count("service.count.chunk", "dispatch")
    n_pairs = cap.span_count("service.pairs.chunk", "dispatch")
    check(launches == {k: n_count if k == SCATTER[0] else 2 * n_pairs if k == PAIRS[0] else 0 for k in launches},
          f"the Syn16D2M requests ran {n_count} count and {n_pairs} pairs chunks and launched {launches}")
    check(n_count > 0 and n_pairs > 0, "the Syn16D2M requests ran no chunk")
    check(svc.total.index_rebuilds == 0, f"{svc.total.index_rebuilds} index rebuilds at eps <= the build radius")
    check(np.array_equal(np.bincount(rp.pairs[:, 0], minlength=q.shape[0]), rc.counts)
          and np.array_equal(rp.counts, rc.counts), "range_pairs' per-query row sums != range_count")
    check_counts(q, rows, rp.counts, sample=64)
    check(rp.pairs.shape[0] > 0 and int(rp.pairs[:, 1].max()) < syn.shape[0], "range_pairs ids out of range")
    walls_ms = np.sort(np.asarray(walls)) * 1e3
    split = serve_split(cap)
    n_requests = cap.span_count("service.request", "request")
    per_req = {k: v / n_requests for k, v in split.items()}
    rec.update({
        "single_requests": sizes,
        "stream": {"requests": n_req, "queries_per_request": nq, "wall_s": stream_s,
                   "p50_ms": float(np.percentile(walls_ms, 50)), "p99_ms": float(np.percentile(walls_ms, 99)),
                   "max_ms": float(walls_ms[-1]), "queries_per_s": stream_queries / sum(walls),
                   "results": stream_results, "new_traces": stream_traces},
        "range_pairs": {"queries": SERVE_PAIRS, "wall_s": pairs_s, "pairs": int(rp.pairs.shape[0]),
                        "pairs_chunks": n_pairs, "traces": rp.stats.num_traces},
        "requests": n_requests, "split_s_per_request": per_req, "split_s_total": split,
        "combined_table_bytes_1024": int((nq + snap.tile_rows) * snap.tiles.shape[1] * snap.tiles.shape[2] * 4),
        "count_chunks": n_count, "launches": {k: v for k, v in launches.items() if v},
        "index_rebuilds": svc.total.index_rebuilds, "traces": svc.total.num_traces,
        "data_row_queries": row_checked, "data_row_diffs_vs_phase3": row_diffs,
        "jittered_checked": jitter_checked, "jittered_off": jitter_bad,
    })
    qplan = syn_engine.build_query_plan(q, SYN_EPS)  # the range_pairs batch's host plan
    rec["query_plan_1024"] = {"query_tiles": qplan.num_q_tiles, "tile_pairs": qplan.num_pairs,
                              "candidates": qplan.num_candidates}
    # the copy each request's table build makes: the data tile table behind
    # 1024 query tiles (CUDA events; the rest of "tables" is host work)
    q_tiles = snap.tiles[:nq].clone()
    rec["table_copy_ms"] = event_ms(torch, lambda: torch.cat([q_tiles, snap.tiles]), 5)
    del pts, q_tiles
    serving_launches = dict(launches)

    # CoocTexture kNN over phase 4's engine
    cooc = cooc_engine.snapshot.pts
    cpts = torch.from_numpy(cooc).cuda()
    csvc = QueryService(SimilarityIndex._wrap(cooc_engine))
    q, _ = jittered_queries(np, rng, cooc, KNN_QUERIES, COOC_EPS / 8)
    before = read()
    t0 = time.perf_counter()
    kn = csvc.knn(q, KNN_K)
    knn_s = time.perf_counter() - t0
    grew = launched_since(before, *mods)
    check(set(k for k, v in grew.items() if v) <= {SCATTER[0], PAIRS[0]}, f"CoocTexture kNN launched {grew}")
    want_rows, want_dist = brute_topk(torch, cpts, torch.from_numpy(q).cuda(), KNN_K)
    bad_rows = np.nonzero((kn.indices != want_rows).any(axis=1))[0]
    for i in bad_rows:  # allowed only where the kNN's final radius cut a neighbour at the eps boundary
        miss = np.setdiff1d(want_rows[i], kn.indices[i])
        d2, band = boundary_band(torch.from_numpy(q[i:i + 1]).cuda(), cpts[torch.from_numpy(miss).cuda()])
        check(bool(((d2 - kn.stats.eps ** 2).abs() <= band).all()),
              f"CoocTexture kNN: query {i} misses neighbours {miss.tolist()} away from the eps boundary")
    ok = np.setdiff1d(np.arange(q.shape[0]), bad_rows)
    ulps = ulps_apart(np, kn.distances[ok], want_dist[ok])
    check(ulps <= 2, f"CoocTexture kNN distances {ulps} float64 ulps off the brute force")
    for k in grew:
        serving_launches[k] += grew[k]
    rec["cooc_knn"] = {"queries": KNN_QUERIES, "k": KNN_K, "wall_s": knn_s, "eps_rounds": kn.stats.eps_rounds,
                       "final_eps": kn.stats.eps, "index_rebuilds": kn.stats.index_rebuilds,
                       "traces": kn.stats.num_traces, "rows_off_at_boundary": int(bad_rows.size),
                       "max_distance_ulps": ulps, "launches": {k: v for k, v in grew.items() if v}}

    # CoocTexture churn on the lattice copy: inserts, deletes, compact, save / load
    lat = (np.round(cooc.astype(np.float64) * CHURN_GRID) / CHURN_GRID).astype(np.float32)
    t0 = time.perf_counter()
    cidx = SimilarityIndex(lat, SelfJoinConfig(eps=COOC_EPS))
    build_s = time.perf_counter() - t0
    churn_svc = QueryService(cidx)
    moved, _ = jittered_queries(np, rng, lat, CHURN, COOC_EPS / 4)
    moved = (np.round(moved.astype(np.float64) * CHURN_GRID) / CHURN_GRID).astype(np.float32)
    t0 = time.perf_counter()
    new_ids = cidx.insert(moved)
    dead = np.concatenate([rng.choice(lat.shape[0], size=CHURN - 96, replace=False),
                           rng.choice(new_ids, size=96, replace=False)])
    cidx.delete(dead)
    churn_s = time.perf_counter() - t0
    live_ids = np.setdiff1d(np.arange(lat.shape[0] + CHURN), dead)
    live = torch.from_numpy(np.concatenate([lat, moved])[live_ids]).cuda()
    cq, _ = jittered_queries(np, rng, lat, KNN_QUERIES, COOC_EPS / 8)
    cq = (np.round(cq.astype(np.float64) * CHURN_GRID) / CHURN_GRID).astype(np.float32)
    cq_t = torch.from_numpy(cq).cuda()

    def answers(service):
        return service.range_count(cq, COOC_EPS), service.range_pairs(cq, COOC_EPS), service.knn(cq, KNN_K)

    before = read()
    t0 = time.perf_counter()
    pre = answers(churn_svc)
    pre_s = time.perf_counter() - t0
    want_pairs, want_counts = brute_pairs_at(torch, np, live, cq_t, COOC_EPS, live_ids)
    check(np.array_equal(pre[0].counts, want_counts),
          "CoocTexture churn: range counts != the float64 brute force on the live set")
    check(np.array_equal(pre[1].pairs, want_pairs) and np.array_equal(pre[1].counts, pre[0].counts),
          "CoocTexture churn: range_pairs != the float64 brute force on the live set")
    want_rows, want_dist = brute_topk(torch, live, cq_t, KNN_K)
    check(np.array_equal(pre[2].indices, live_ids[want_rows]) and ulps_apart(np, pre[2].distances, want_dist) <= 2,
          "CoocTexture churn: kNN != the float64 top-k on the live set")
    traces0 = churn_svc.total.num_traces
    t0 = time.perf_counter()
    cidx.compact()
    compact_s = time.perf_counter() - t0
    post = answers(churn_svc)
    for a, b in zip(pre, post):
        for name in ("counts", "pairs", "indices", "distances"):
            if hasattr(a, name):
                check(np.array_equal(getattr(a, name), getattr(b, name)),
                      f"CoocTexture churn: {name} changed across compact()")
    check(churn_svc.total.num_traces == traces0,
          f"compact() added {churn_svc.total.num_traces - traces0} traces (buckets moved)")
    (ROOT / "build").mkdir(exist_ok=True)
    path = cidx.save(ROOT / "build" / "serving_churn_index")
    t0 = time.perf_counter()
    loaded = SimilarityIndex.load(path)
    load_s = time.perf_counter() - t0
    Path(path).unlink()
    again = answers(QueryService(loaded))
    for a, b in zip(post, again):
        for name in ("counts", "pairs", "indices", "distances"):
            if hasattr(a, name):
                check(np.array_equal(getattr(a, name), getattr(b, name)), f"CoocTexture churn: {name} changed by save / load")
    grew = launched_since(before, *mods)
    check(set(k for k, v in grew.items() if v) == {SCATTER[0], PAIRS[0]}, f"CoocTexture churn launched {grew}")
    for k in grew:
        serving_launches[k] += grew[k]
    rec["cooc_churn"] = {"lattice": f"1/{CHURN_GRID}", "build_s": build_s, "inserted": CHURN, "deleted": CHURN,
                         "mutate_s": churn_s, "live": int(live_ids.size), "requests_before_compact_s": pre_s,
                         "compact_s": compact_s, "load_s": load_s, "pairs": int(pre[1].pairs.shape[0]),
                         "aux_dispatches": pre[0].stats.num_device_dispatches, "epoch": cidx.epoch,
                         "traces_added_by_compact": churn_svc.total.num_traces - traces0,
                         "launches": {k: v for k, v in grew.items() if v}}
    del live, cq_t, cpts

    # the dense tier: phase 4's dense engine, wrapped
    dsvc = QueryService(SimilarityIndex._wrap(dense_engine))
    before = read()
    with obs.capture() as dcap:
        t0 = time.perf_counter()
        drc = dsvc.range_count(q, COOC_EPS)
        drp = dsvc.range_pairs(q, COOC_EPS)
        dense_s = time.perf_counter() - t0
    grew = launched_since(before, *mods)
    dn_count = dcap.span_count("service.count.chunk", "dispatch")
    dn_pairs = dcap.span_count("service.pairs.chunk", "dispatch")
    check(grew == {k: dn_count if k == "dense_count_scatter" else 2 * dn_pairs if k == "dense_pairs_compact" else 0
                   for k in grew}, f"the dense index ran {dn_count} / {dn_pairs} chunks and launched {grew}")
    check(drc.stats.execution == "dense" and np.array_equal(drp.counts, drc.counts),
          "the dense index's range_pairs counts != its range_count")
    lo, hi = query_count_bounds(torch, torch.from_numpy(cooc).cuda(), torch.from_numpy(q).cuda(), COOC_EPS)
    check(bool(((drc.counts >= lo) & (drc.counts <= hi)).all()), "the dense index's counts off the float64 brute force")
    for k in grew:
        serving_launches[k] += grew[k]
    rec["cooc_dense"] = {"queries": KNN_QUERIES, "wall_s": dense_s, "count_chunks": dn_count,
                         "pairs_chunks": dn_pairs, "pairs": int(drp.pairs.shape[0]),
                         "launches": {k: v for k, v in grew.items() if v}}
    torch.cuda.synchronize()
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["serving_launches"] = {k: v for k, v in serving_launches.items() if v}
    emit(rec)
    return serving_launches


# -- the distributed phase -----------------------------------------------------

DIST_WORKERS = 4            # the ring's positions (simulated workers, one card)
DIST_SYN_N = 500_000        # phases 8-9 run Syn16D2M cut to its first points: uncut, phase 8's 16 block
                            # plans and phase 9's packs were the smoke's longest host work
DIST_KNN_K = 16             # CoocTexture kNN of every point of its first DIST_KNN_N
DIST_KNN_N = 16_384         # cut from 68,040: at every point the host's top-k sorted ~106M candidate
                            # pairs, the longest wait of the smoke; the cut sorts ~6.6M
DIST_KNN_EPS0 = 0.0625      # on those points the expansion then takes 2 rounds, ending at 0.125 where
                            # every point has >= 19 candidates (the 16th neighbour lies at <= 0.1239)
DIST_KNN_SAMPLE = 512       # rows of the kNN held against the float64 top-k


def ring_rounds(cap):
    """Each ``ring.round`` of an obs capture split by the engine's spans:
    its wall time, the host plans of its blocks (``engine.prepare_query``:
    the query plan, the combined tables) and their chunk loops
    (``engine.count_query``: the launches and the read of the counts)."""
    spans = sorted((e for e in cap.events if e.ph == "X"), key=lambda e: e.ts_us)
    out = []
    for r in cap.spans("ring.round", "ring"):
        end = r.ts_us + r.dur_us

        def total(name):
            return sum(e.dur_us for e in spans if e.name == name and r.ts_us <= e.ts_us
                       and e.ts_us + e.dur_us <= end) / 1e6

        out.append({"round": r.attrs["round"], "wall_s": r.dur_us / 1e6,
                    "host_plan_s": total("engine.prepare_query"), "count_loop_s": total("engine.count_query")})
    return out


def check_knn(torch, np, pts, kn, rows, k, what):
    """Rows ``rows`` of a kNN result against the float64 top-k of ``pts``
    (on the card): a row may differ only where the final radius cut a
    neighbour at the eps boundary, and the distances of the others must lie
    within 2 float64 ulps.  Returns (rows off at the boundary, max ulps)."""
    want_rows, want_dist = brute_topk(torch, pts, pts[torch.from_numpy(rows).cuda()], k)
    got_rows, got_dist = kn.indices[rows], kn.distances[rows]
    bad = np.nonzero((got_rows != want_rows).any(axis=1))[0]
    for i in bad:
        miss = np.setdiff1d(want_rows[i], got_rows[i])
        d2, bw = boundary_band(pts[int(rows[i]):int(rows[i]) + 1], pts[torch.from_numpy(miss).cuda()])
        check(bool(((d2 - kn.eps_used ** 2).abs() <= bw).all()),
              f"{what}: row {rows[i]} misses {miss.tolist()} away from the eps boundary")
    ok = np.setdiff1d(np.arange(rows.size), bad)
    ulps = ulps_apart(np, got_dist[ok], want_dist[ok])
    check(ulps <= 2, f"{what} distances {ulps} float64 ulps off the brute force")
    return int(bad.size), ulps


def phase_distributed(torch, np, syn, cooc, cooc_counts, cooc_pairs, seed):
    """The distributed tier (``DistributedSelfJoinEngine``, host-driven,
    DIST_WORKERS simulated workers in this process) and the ring transport
    (``ring_self_join_counts`` on a one-rank NCCL group), on phase 3-4's
    arrays, with the launch counters from 0.

    Syn16D2M cut to its first DIST_SYN_N points (``syn``), round robin,
    ``count()``: counts equal the one-card engine's on the same points up to
    the boundary band (each shard runs its own REORDER); only K1's fused
    count step launches, once per chunk.  CoocTexture: at 1 worker counts
    ``==`` phase 4's indexed count(); at DIST_WORKERS workers under both
    assignments counts equal each other and phase 4's up to the band;
    ``self_join_pairs`` (row sums equal the counts, the pair set phase 4's
    up to the band; K1's fused count step once per count chunk, K2's fused
    pairs step twice per pairs chunk); kNN of every point of the first
    DIST_KNN_N from DIST_KNN_EPS0, DIST_KNN_SAMPLE rows against the float64
    top-k; a
    dense-tier count (only the dense fused count step).  Returns the
    phase's launches per kernel, and the results phase 9 is held to:
    Syn16D2M's 4-worker counts, CoocTexture's 4-worker round-robin counts
    and pairs."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import DistributedSelfJoinEngine, SelfJoinConfig, SelfJoinEngine
    from repro_torch.core.distributed import ring_self_join_counts
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention

    mods = (distance_tile, dense_tile, flash_attention)

    def read():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

    def band(pts, rows, eps, *counts):
        """Counts of ``rows`` that differ must lie within the float64 bounds."""
        if rows.size:
            lo, hi = count_bounds(torch, pts, rows, eps)
            for got in counts:
                check(bool(((got[rows] >= lo) & (got[rows] <= hi)).all()),
                      f"counts differ beyond the eps boundary at eps={eps}")
        return int(rows.size)

    # the Syn16D2M cut's yardstick, before the counters start: the one-card engine's count
    t0 = time.perf_counter()
    syn_counts = SelfJoinEngine(syn, SelfJoinConfig(eps=SYN_EPS)).count().counts
    yardstick_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rec = {"phase": "distributed", "workers": DIST_WORKERS,
           "multi_gpu": "unverified: one card; the engine's workers run one after another in one process, "
                        "and the ring transport ran on a one-rank NCCL group (no point-to-point op); the fused "
                        "ring (phase 9) likewise, its 4 ranks being gloo processes on the one card"}

    # Syn16D2M, its first DIST_SYN_N points, round robin
    t0 = time.perf_counter()
    de = DistributedSelfJoinEngine(syn, SelfJoinConfig(eps=SYN_EPS), num_workers=DIST_WORKERS)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = read()
    with obs.capture(capacity=1 << 21) as cap:
        t0 = time.perf_counter()
        res = de.count()
        count_s = time.perf_counter() - t0
    st = res.stats
    grew = launched_since(before, *mods)
    only_launched(grew, {SCATTER[0]: st.num_chunks}, f"the Syn16D2M distributed count ({st.num_chunks} chunks)")
    check(cap.dropped == 0, f"the obs capture dropped {cap.dropped} events")
    peak = torch.cuda.max_memory_allocated()
    check(res.counts.shape == (syn.shape[0],) and (res.counts >= 1).all(), "Syn16D2M distributed counts malformed")
    syn_pts = torch.from_numpy(syn).cuda()
    diffs = band(syn_pts, np.nonzero(res.counts != syn_counts)[0], SYN_EPS, res.counts, syn_counts)
    del syn_pts
    t0 = time.perf_counter()
    loads = de.worker_loads()
    loads_s = time.perf_counter() - t0
    rounds = ring_rounds(cap)
    rec["syn16d2m"] = {
        "points": int(syn.shape[0]), "eps": SYN_EPS, "cut": f"the first {syn.shape[0]:,} of 2,000,000 points",
        "assignment": de.assignment, "shard_build_s": build_s, "count_s": count_s,
        "host_plan_s": sum(r["host_plan_s"] for r in rounds), "count_loop_s": sum(r["count_loop_s"] for r in rounds),
        "rounds": rounds, "chunks": st.num_chunks, "tile_pairs": st.num_tile_pairs_evaluated,
        "candidates": st.num_candidates, "candidates_dense": st.num_candidates_dense,
        "candidate_filter_ratio": st.candidate_filter_ratio, "comm_elements": st.comm_elements,
        "results": st.num_results, "worker_loads": loads.tolist(), "worker_loads_s": loads_s,
        "one_card_yardstick_s": yardstick_s, "diffs_vs_one_card": diffs, "peak_device_bytes": peak,
        "launches": {k: v for k, v in grew.items() if v},
    }
    held = {"syn_counts": res.counts}
    del de, res
    torch.cuda.empty_cache()

    # CoocTexture: 1 worker, then DIST_WORKERS under both assignments
    n = cooc.shape[0]
    cpts = torch.from_numpy(cooc).cuda()
    cfg = SelfJoinConfig(eps=COOC_EPS)
    r1 = DistributedSelfJoinEngine(cooc, cfg, num_workers=1).count()
    check(np.array_equal(r1.counts, cooc_counts), "CoocTexture at 1 worker: counts != phase 4's indexed count()")
    engines, counts = {}, {}
    out = {"points": int(n), "eps": COOC_EPS, "one_worker_chunks": r1.stats.num_chunks}
    for assignment in ("round_robin", "dynamic"):
        t0 = time.perf_counter()
        engines[assignment] = DistributedSelfJoinEngine(cooc, cfg, num_workers=DIST_WORKERS, assignment=assignment)
        build_s = time.perf_counter() - t0
        before = read()
        t0 = time.perf_counter()
        r = engines[assignment].count()
        count_s = time.perf_counter() - t0
        only_launched(launched_since(before, *mods), {SCATTER[0]: r.stats.num_chunks}, f"the CoocTexture {assignment} count")
        counts[assignment] = r.counts
        out[assignment] = {"build_s": build_s, "count_s": count_s, "chunks": r.stats.num_chunks,
                           "candidates": r.stats.num_candidates,
                           "worker_loads": engines[assignment].worker_loads().tolist()}
    check(np.array_equal(counts["round_robin"], counts["dynamic"]),
          "CoocTexture: round-robin and dynamic counts differ")
    out["diffs_vs_phase4"] = band(cpts, np.nonzero(counts["round_robin"] != cooc_counts)[0], COOC_EPS,
                                  counts["round_robin"], cooc_counts)

    # pairs at DIST_WORKERS workers (round robin)
    de = engines["round_robin"]
    before = read()
    with obs.capture(capacity=1 << 20) as pcap:
        t0 = time.perf_counter()
        rp = de.self_join_pairs()
        pairs_s = time.perf_counter() - t0
    n_count = pcap.span_count("ring.block.count.chunk", "dispatch")
    n_pairs = pcap.span_count("ring.block.pairs.chunk", "dispatch")
    only_launched(launched_since(before, *mods), {SCATTER[0]: n_count, PAIRS[0]: 2 * n_pairs},
         f"the CoocTexture pairs ({n_count} count, {n_pairs} pairs chunks)")
    check(n_pairs == rp.stats.num_chunks and n_count + n_pairs == rp.stats.num_device_dispatches,
          "the pairs' chunk spans disagree with its stats")
    check(np.array_equal(rp.counts, counts["round_robin"])
          and np.array_equal(np.bincount(rp.pairs[:, 0], minlength=n), counts["round_robin"]),
          "CoocTexture distributed pairs: row sums != count()")
    got = torch.from_numpy(rp.pairs).cuda().long()
    want = torch.from_numpy(cooc_pairs).cuda().long()
    got_key, want_key = got[:, 0] * n + got[:, 1], want[:, 0] * n + want[:, 1]
    check(int(torch.unique(got_key).numel()) == got_key.numel(), "CoocTexture distributed pairs: duplicates")
    odd = torch.cat([got[~torch.isin(got_key, want_key)], want[~torch.isin(want_key, got_key)]])
    if odd.shape[0]:
        d2, bw = boundary_band(cpts[odd[:, 0]][:, None, :], cpts[odd[:, 1]][:, None, :])
        check(bool(((d2 - COOC_EPS ** 2).abs() <= bw).all()),
              "CoocTexture distributed pairs differ from phase 4's beyond the eps boundary")
    del got, want, got_key, want_key
    out["pairs"] = {"pairs": int(rp.pairs.shape[0]), "wall_s": pairs_s, "count_chunks": n_count,
                    "pairs_chunks": n_pairs, "diffs_vs_phase4": int(odd.shape[0])}
    held.update(cooc_counts=counts["round_robin"], cooc_pairs=rp.pairs)
    del rp, odd

    # kNN of every point of the first DIST_KNN_N
    dk = DistributedSelfJoinEngine(cooc[:DIST_KNN_N], cfg, num_workers=DIST_WORKERS)
    before = read()
    with obs.capture(capacity=1 << 20) as kcap:
        t0 = time.perf_counter()
        kn = dk.knn(DIST_KNN_K, eps0=DIST_KNN_EPS0)
        knn_s = time.perf_counter() - t0
    passes_s = sum(e.dur_us for e in kcap.spans("ring.round", "ring")) / 1e6
    plans_s = sum(e.dur_us for e in kcap.spans("engine.prepare_query")) / 1e6
    grew = launched_since(before, *mods)
    check(set(k for k, v in grew.items() if v) == {SCATTER[0], PAIRS[0]}, f"CoocTexture distributed kNN launched {grew}")
    check(kn.eps_rounds <= 3 and kn.indices.shape == (DIST_KNN_N, DIST_KNN_K) and (kn.indices >= 0).all(),
          f"CoocTexture distributed kNN: {kn.eps_rounds} rounds, indices {kn.indices.shape}")
    bad, ulps = check_knn(torch, np, cpts[:DIST_KNN_N], kn,
                          rng.choice(DIST_KNN_N, size=DIST_KNN_SAMPLE, replace=False), DIST_KNN_K,
                          "CoocTexture distributed kNN")
    out["knn"] = {"points": DIST_KNN_N, "k": DIST_KNN_K, "eps0": DIST_KNN_EPS0, "eps_used": kn.eps_used,
                  "eps_rounds": kn.eps_rounds,
                  "final_pairs": kn.stats.num_results, "wall_s": knn_s,
                  # the candidate passes' host plans, the rest of their blocks (count and pairs
                  # loops, the copies and decode of the pairs), and what follows the passes (top-k)
                  "split_s": {"host_plans": plans_s, "blocks_rest": passes_s - plans_s,
                              "after_passes": knn_s - passes_s},
                  "sampled": DIST_KNN_SAMPLE,
                  "rows_off_at_boundary": bad, "max_distance_ulps": ulps,
                  "launches": {k: v for k, v in grew.items() if v}}
    del kn, dk, engines, de

    # the dense tier
    t0 = time.perf_counter()
    dd = DistributedSelfJoinEngine(cooc, dataclasses.replace(cfg, execution="dense"), num_workers=DIST_WORKERS)
    build_s = time.perf_counter() - t0
    before = read()
    t0 = time.perf_counter()
    rd = dd.count()
    dense_s = time.perf_counter() - t0
    only_launched(launched_since(before, *mods), {"dense_count_scatter": rd.stats.num_chunks}, "the CoocTexture dense count")
    out["dense"] = {"build_s": build_s, "count_s": dense_s, "chunks": rd.stats.num_chunks,
                    "diffs_vs_phase4": band(cpts, np.nonzero(rd.counts != cooc_counts)[0], COOC_EPS,
                                            rd.counts, cooc_counts)}
    del dd
    rec["cooc"] = out

    # the ring transport: a one-rank NCCL group this phase creates and destroys
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ROOT / "build")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        before = read()
        t0 = time.perf_counter()
        rc = ring_self_join_counts(cooc, COOC_EPS, dist.group.WORLD, device="cuda")
        ring_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp)
    only_launched(launched_since(before, *mods), {}, "the ring transport (torch matmuls only)")
    rec["ring"] = {"backend": "nccl", "ranks": 1, "wall_s": ring_s,
                   "diffs_vs_phase4": band(cpts, np.nonzero(rc != cooc_counts)[0], COOC_EPS, rc, cooc_counts)}
    del cpts
    torch.cuda.synchronize()
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_phase
    launches = read()
    rec["launches"] = {k: v for k, v in launches.items() if v}
    emit(rec)
    return launches, held


# -- the fused ring phase -------------------------------------------------------

FUSED_RANKS = 4              # gloo processes on the one card, one ring position each
FUSED_DEADLINE_S = 600.0     # for the 4 processes together; past it every rank is killed
FUSED_SWEEP_EPS = 0.05       # CoocTexture's eps sweep, below the packed radius
FUSED_KNN_N = 8192           # the fused kNN runs on CoocTexture's first points
FUSED_FORCED_CAP = 1 << 16   # the forced capacity retry's packed cap (a worker holds ~11M pairs)


def pair_keys(torch, pairs, n):
    """Sorted ``a * n + b`` keys of an (R, 2) pair array, on the card."""
    p = torch.from_numpy(pairs).cuda().long()
    return torch.sort(p[:, 0] * n + p[:, 1]).values


def same_pair_set(torch, a, b, n):
    """Whether two pair arrays hold the same pairs, each once."""
    if a.shape != b.shape:
        return False
    ka = pair_keys(torch, a, n)
    return bool(torch.equal(ka, pair_keys(torch, b, n))) and bool((ka[1:] != ka[:-1]).all())


def fused_split(cap):
    """An obs capture of fused joins split by the engine's spans, seconds:
    the pack (its block plans, the hit-rate sample, the rest: the shard
    tables, the collectives), and the programs (the staging copies into
    the combined tables, the chunk loops, the exchanges, the rest: the
    gathers of the results)."""
    def total(name):
        return sum(e.dur_us for e in cap.spans(name)) / 1e6

    pack, plans, sample = total("ring.pack"), total("ring.pack.plan"), total("ring.pack.sample")
    program = total("ring.fused.count") + total("ring.fused.pairs")
    stage, chunks, exchange = total("ring.fused.stage"), total("ring.fused.chunks"), total("ring.exchange")
    return {"pack_s": pack, "block_plans_s": plans, "sample_s": sample, "pack_rest_s": pack - plans - sample,
            "program_s": program, "staging_s": stage, "chunk_loops_s": chunks, "exchange_s": exchange,
            "gather_and_rest_s": program - stage - chunks - exchange}


def fused_launches(pack, executions):
    """What one rank's fused joins launch: K1's fused count step once per
    count chunk with work, K2's fused pairs step twice per pairs chunk with
    work (per execution), and the pack's hit-rate sample (K1 per pair, one
    chunk of at most 512 pairs) on the rank that owns the heaviest block."""
    return {SCATTER[0]: int((pack["args"][6] > 0).sum()) * executions[0],
            PAIRS[0]: 2 * int((pack["pairs_args"][6] > 0).sum()) * executions[1]}


def fused_one_rank(torch, np, cooc, cooc_counts, rng, read, mods):
    """Phase 9 (a): the fused ring on a one-rank NCCL group (payload on the
    card), CoocTexture: count, pairs, the eps sweep, kNN."""
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import DistributedSelfJoinEngine, SelfJoinConfig

    n = cooc.shape[0]
    cfg = SelfJoinConfig(eps=COOC_EPS)
    group = dist.group.WORLD
    t0 = time.perf_counter()
    de = DistributedSelfJoinEngine(cooc, cfg, mesh=group, fused=True)
    build_s = time.perf_counter() - t0
    before = read()
    with obs.capture(capacity=1 << 20) as cap:
        t0 = time.perf_counter()
        rc = de.count()
        count_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rp = de.self_join_pairs()
        pairs_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    grew = launched_since(before, *mods)
    want = fused_launches(de._fused_pack, (1, rp.stats.num_device_dispatches))
    want["tile_pair_distance"] = 1
    only_launched(grew, want, "the one-rank fused count and pairs")
    check(np.array_equal(rc.counts, cooc_counts),
          "one-rank fused count != the one-worker host-driven count (== phase 4's)")
    host = de.self_join_pairs(fused=False)  # the one-worker host-driven pairs
    check(same_pair_set(torch, rp.pairs, host.pairs, n), "one-rank fused pairs != the one-worker host-driven pairs")
    check(np.array_equal(rp.counts, rc.counts) and sum(rp.stats.worker_pair_cursors) == rp.stats.num_results,
          "one-rank fused pairs: row sums or cursors disagree")
    traces = (de.fused_traces, de.fused_pairs_traces)
    t0 = time.perf_counter()
    c5 = de.count(FUSED_SWEEP_EPS)
    p5 = de.self_join_pairs(eps=FUSED_SWEEP_EPS)
    sweep_s = time.perf_counter() - t0
    check((de.fused_traces, de.fused_pairs_traces) == traces == (1, 1),
          f"the eps sweep built programs again: traces {traces} -> {(de.fused_traces, de.fused_pairs_traces)}")
    check(np.array_equal(np.bincount(p5.pairs[:, 0], minlength=n), c5.counts)
          and same_pair_set(torch, p5.pairs, de.self_join_pairs(eps=FUSED_SWEEP_EPS, fused=False).pairs, n),
          f"one-rank fused sweep at eps={FUSED_SWEEP_EPS} != the host-driven pairs")
    out = {"backend": "nccl", "ranks": 1, "points": int(n), "eps": COOC_EPS, "build_s": build_s,
           "count_s": count_s, "pairs_s": pairs_s, "split": fused_split(cap), "pairs": int(rp.stats.num_results),
           "pairs_capacity": rp.stats.pairs_capacity, "overflow_retries": rp.stats.overflow_retries,
           "count_chunks": rc.stats.num_chunks, "pairs_chunks": rp.stats.num_chunks,
           "launches": {k: v for k, v in grew.items() if v},
           "sweep": {"eps": FUSED_SWEEP_EPS, "wall_s": sweep_s, "traces": [de.fused_traces, de.fused_pairs_traces],
                     "executions": [de.fused_executions, de.fused_pairs_executions]}}
    del de, host, rp, p5

    # kNN over the first FUSED_KNN_N points: each candidate pass one fused pairs join
    pts = cooc[:FUSED_KNN_N]
    dk = DistributedSelfJoinEngine(pts, cfg, mesh=group, fused=True)
    before = read()
    t0 = time.perf_counter()
    kn = dk.knn(DIST_KNN_K)
    knn_s = time.perf_counter() - t0
    grew = launched_since(before, *mods)
    check(set(k for k, v in grew.items() if v) <= {PAIRS[0], "tile_pair_distance"},
          f"the one-rank fused kNN launched {grew}")
    bad, ulps = check_knn(torch, np, torch.from_numpy(pts).cuda(), kn,
                          rng.choice(FUSED_KNN_N, size=DIST_KNN_SAMPLE, replace=False), DIST_KNN_K,
                          "one-rank fused kNN")
    out["knn"] = {"points": FUSED_KNN_N, "k": DIST_KNN_K, "eps_used": kn.eps_used, "eps_rounds": kn.eps_rounds,
                  "wall_s": knn_s, "sampled": DIST_KNN_SAMPLE, "rows_off_at_boundary": bad,
                  "max_distance_ulps": ulps, "launches": {k: v for k, v in grew.items() if v}}
    return out


def only_launched(grew, want, what):
    check(grew == {k: want.get(k, 0) for k in grew},
          f"{what} launched {({k: v for k, v in grew.items() if v})}, expected {want}")


def fused_rank_main(rank, tmp):
    """One rank of phase 9 (b): a process of the FUSED_RANKS-rank gloo ring
    on the one card (``chip_smoke.py --fused-rank R --fused-dir DIR``).  It
    loads the kernels the parent built, joins Syn16D2M and CoocTexture
    fused, holds them to phase 8's results (files in ``tmp``) and writes
    its numbers to ``tmp/rank<R>.json``."""
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import DistributedSelfJoinEngine, SelfJoinConfig, dist_engine
    from repro_torch.kernels import _build, dense_tile, distance_tile, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    missing = [name for name in _build.SOURCES if not _build.library_path(name).exists()]
    check(not missing, f"rank {rank}: the parent did not build {missing}")
    mods = (distance_tile, dense_tile, flash_attention)

    def read():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

    dist.init_process_group("gloo", init_method=f"file://{tmp / 'rendezvous'}", rank=rank, world_size=FUSED_RANKS)
    try:
        group = dist.group.WORLD
        out = {"rank": rank}
        syn = np.load(tmp / "syn.npy")
        t0 = time.perf_counter()
        de = DistributedSelfJoinEngine(syn, SelfJoinConfig(eps=SYN_EPS), mesh=group, fused=True)
        out["shard_build_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read()
        with obs.capture(capacity=1 << 20) as cap:
            t0 = time.perf_counter()
            res = de.count()
            count_s = time.perf_counter() - t0
        grew = launched_since(before, *mods)
        pack = de._fused_pack
        want = fused_launches(pack, (1, 0))
        want["tile_pair_distance"] = int(bool(cap.span_count("ring.pack.sample")))
        only_launched(grew, want, f"rank {rank}'s Syn16D2M fused count")
        diffs = int(np.count_nonzero(res.counts != np.load(tmp / "syn_counts.npy")))
        check(diffs == 0, f"rank {rank}: the Syn16D2M fused count differs from phase 8's in {diffs} rows")

        # the same program again, the device waited on at the end of each
        # chunk loop, so the chunk-loop spans hold the kernels' time rather
        # than their launches (and the staging copies no wait for them)
        @contextlib.contextmanager
        def synced(dev):
            with torch.cuda.device(dev):
                yield
            torch.cuda.synchronize(dev)

        plain_on_card, dist_engine.on_card = dist_engine.on_card, synced
        try:
            with obs.capture(capacity=1 << 20) as scap:
                t0 = time.perf_counter()
                again = de.count()
                synced_s = time.perf_counter() - t0
        finally:
            dist_engine.on_card = plain_on_card
        check(np.array_equal(again.counts, res.counts) and de.fused_traces == 1,
              f"rank {rank}: the Syn16D2M re-run differs or built its program again")
        payload = pack["args"][7:]
        out["syn16d2m"] = {
            "points": int(syn.shape[0]), "eps": SYN_EPS, "cut": f"the first {syn.shape[0]:,} of 2,000,000 points",
            "assignment": de.assignment, "count_s": count_s, "split": fused_split(cap),
            "synced_run": {"wall_s": synced_s, **fused_split(scap)},
            "chunks_per_round": int(pack["n_chunks"]), "chunks_with_work": int((pack["args"][6] > 0).sum()),
            "tile_pairs": res.stats.num_tile_pairs_evaluated, "results": res.stats.num_results,
            "payload_bytes": sum(int(x.nelement()) * x.element_size() for x in payload),
            "rotations": FUSED_RANKS - 1, "qt_bytes": int(pack["args"][0].nelement()) * 4,
            "launches": {k: v for k, v in grew.items() if v}, "diffs_vs_phase8": diffs,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
        }
        del de, res, again, pack, payload
        torch.cuda.empty_cache()

        # CoocTexture: count under both assignments, pairs, a forced capacity retry
        cooc = np.load(tmp / "cooc.npy")
        n = cooc.shape[0]
        cfg = SelfJoinConfig(eps=COOC_EPS)
        want_counts = np.load(tmp / "cooc_counts.npy")
        cout, engines = {}, {}
        for assignment in ("round_robin", "dynamic"):
            engines[assignment] = DistributedSelfJoinEngine(cooc, cfg, mesh=group, fused=True, assignment=assignment)
            t0 = time.perf_counter()
            r = engines[assignment].count()
            cout[assignment] = {"count_s": time.perf_counter() - t0,
                                "diffs_vs_phase8": int(np.count_nonzero(r.counts != want_counts))}
            check(cout[assignment]["diffs_vs_phase8"] == 0,
                  f"rank {rank}: the CoocTexture {assignment} fused count differs from phase 8's")
        de = engines["round_robin"]
        before = read()
        with obs.capture(capacity=1 << 20) as pcap:
            t0 = time.perf_counter()
            rp = de.self_join_pairs()
            pairs_s = time.perf_counter() - t0
        grew = launched_since(before, *mods)
        only_launched(grew, fused_launches(de._fused_pack, (0, rp.stats.num_device_dispatches)),
                      f"rank {rank}'s CoocTexture fused pairs")
        check(same_pair_set(torch, rp.pairs, np.load(tmp / "cooc_pairs.npy"), n),
              f"rank {rank}: the CoocTexture fused pair set != phase 8's")
        check(sum(rp.stats.worker_pair_cursors) == rp.stats.num_results, f"rank {rank}: cursors != num_results")
        de._fused_pack["pairs_cap"] = FUSED_FORCED_CAP
        de._fused_pack.pop("pairs_warm", None)
        t0 = time.perf_counter()
        rf = de.self_join_pairs()
        forced_s = time.perf_counter() - t0
        check(rf.stats.overflow_retries >= 1 and np.array_equal(rf.pairs, rp.pairs),
              f"rank {rank}: the forced capacity retry ({rf.stats.overflow_retries} retries) != the clean join")
        out["cooc"] = {
            "points": int(n), "eps": COOC_EPS, **cout, "pairs_s": pairs_s, "pairs_split": fused_split(pcap),
            "pairs": int(rp.stats.num_results), "worker_pair_cursors": list(rp.stats.worker_pair_cursors),
            "pairs_capacity": rp.stats.pairs_capacity, "overflow_retries": rp.stats.overflow_retries,
            "forced": {"cap": FUSED_FORCED_CAP, "retries": rf.stats.overflow_retries, "wall_s": forced_s,
                       "pairs_capacity": rf.stats.pairs_capacity},
            "launches": {k: v for k, v in grew.items() if v},
        }
        out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        out["launches"] = {k: v for k, v in read().items() if v}  # the whole process's
        (tmp / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def fused_four_ranks(torch, np, syn, cooc, held, tmp):
    """Phase 9 (b): FUSED_RANKS processes of this script on the one card, a
    gloo ring with a ``file://`` init, the payload carried in host memory.
    Phase 8's results go to them as files in ``tmp`` and theirs come back
    the same way; past FUSED_DEADLINE_S every rank is killed and the run
    fails."""
    for name, arr in (("syn", syn), ("cooc", cooc), ("syn_counts", held["syn_counts"]),
                      ("cooc_counts", held["cooc_counts"]), ("cooc_pairs", held["cooc_pairs"])):
        np.save(tmp / f"{name}.npy", arr)
    t0 = time.perf_counter()
    procs = []
    for rank in range(FUSED_RANKS):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--fused-rank", str(rank), "--fused-dir", str(tmp)],
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + FUSED_DEADLINE_S
    try:
        for p, _ in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"the {FUSED_RANKS}-rank fused ring passed its {FUSED_DEADLINE_S:.0f} s deadline")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    wall_s = time.perf_counter() - t0
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            tail = (tmp / f"rank{rank}.log").read_text()[-3000:]
            raise SmokeFailure(f"fused ring rank {rank} exited {p.returncode}:\n{tail}")
    ranks = [json.loads((tmp / f"rank{rank}.json").read_text()) for rank in range(FUSED_RANKS)]
    return {"backend": "gloo", "ranks": FUSED_RANKS, "processes_wall_s": wall_s, "per_rank": ranks}


def phase_fused(torch, np, syn, cooc, cooc_counts, held, seed):
    """Phase 9, the device-fused ring (``DistributedSelfJoinEngine(...,
    fused=True)``), with its own launch counters: (a) a one-rank NCCL group
    in this process on CoocTexture (``fused_one_rank``), (b) FUSED_RANKS
    gloo processes on the one card, phase 8's Syn16D2M cut (``syn``) and
    CoocTexture (``fused_four_ranks``), held to phase 8's host-driven
    results."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.kernels import dense_tile, distance_tile, flash_attention

    mods = (distance_tile, dense_tile, flash_attention)

    def read():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    t_phase = time.perf_counter()
    rec = {"phase": "fused_ring", "card": smi_name_limit(),
           "multi_gpu": "unverified: one card; NCCL ran a one-rank ring (no point-to-point op) and the "
                        f"{FUSED_RANKS}-rank ring ran as gloo processes on the one card, the payload in host memory"}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            rec["one_rank"] = fused_one_rank(torch, np, cooc, cooc_counts, np.random.default_rng(seed), read, mods)
        finally:
            dist.destroy_process_group()
        launches = read()
        rec["four_ranks"] = fused_four_ranks(torch, np, syn, cooc, held, tmp)
    finally:
        shutil.rmtree(tmp)
    rec["phase_s"] = time.perf_counter() - t_phase
    for r in rec["four_ranks"]["per_rank"]:  # each process counts its own launches
        for k, v in r["launches"].items():
            launches[k] += v
    rec["launches"] = {k: v for k, v in launches.items() if v}
    emit(rec)
    return launches


# -- the downstream phase -------------------------------------------------------

DEDUP_EXAMPLES = 100_000     # token examples (64 tokens, vocab 1000), the last DEDUP_PLANTED of
DEDUP_PLANTED = 10_000       # them near-copies of the first (tests/test_system.py's recipe)
DEDUP_SEQ = 64
DEDUP_VOCAB = 1000
DEDUP_DIM = 16               # hashed n-gram embedding width
DEDUP_EPS = 0.15             # near-dup radius: ~1e5 pairs at this size, so the union-find stays quick
DEDUP_BLOCK = 1024           # rows per block of the float64 brute force


def chunk_default(fn):
    """The ``chunk`` default of an ops entry point (the pairs per launch)."""
    import inspect

    return inspect.signature(fn).parameters["chunk"].default


def hostloop_pairs_split(torch, ops, distance_tile, run):
    """Run ``run()`` (a host-loop pairs join) with its launches timed: CUDA
    events around each K2-per-pair launch (``distance_tile.tile_pair_distance``
    with the mask; the card is idle when each starts, so this is the wrapper's
    enqueue plus the kernel), the host clock inside ``ops.tile_mask``'s
    generator (the launch, the wait for the kernel, the copy of the mask to
    the host) and around the whole loop.  Returns (result, wall, split in
    seconds, the batches' pair counts, mask launches timed)."""
    orig_kernel, orig_mask = distance_tile.tile_pair_distance, ops.tile_mask
    events, batches, clock = [], [], {"in_mask": 0.0, "first": None}

    def kernel(*args, **kw):
        if not kw.get("return_mask"):
            return orig_kernel(*args, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig_kernel(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    def tile_mask(tiles, lens, pa, pb, **kw):
        if clock["first"] is None:
            clock["first"] = time.perf_counter()
        batches.append(int(pa.shape[0]))
        gen = orig_mask(tiles, lens, pa, pb, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                clock["in_mask"] += time.perf_counter() - t0
            yield item

    distance_tile.tile_pair_distance, ops.tile_mask = kernel, tile_mask
    try:
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
    finally:
        distance_tile.tile_pair_distance, ops.tile_mask = orig_kernel, orig_mask
    torch.cuda.synchronize()
    kernel_s = sum(s.elapsed_time(e) for s, e in events) / 1e3
    loop = t0 + wall - clock["first"]
    split = {"before_batches_s": clock["first"] - t0, "mask_launches_s": kernel_s,
             "mask_copies_s": clock["in_mask"] - kernel_s, "host_extract_s": loop - clock["in_mask"]}
    return res, wall, split, batches, len(events)


def dedup_examples(np, rng):
    """DEDUP_EXAMPLES token rows; the last DEDUP_PLANTED copy the first ones
    with every 17th token edited (tests/test_system.py's recipe)."""
    base = rng.integers(0, DEDUP_VOCAB, (DEDUP_EXAMPLES - DEDUP_PLANTED, DEDUP_SEQ))
    dups = base[:DEDUP_PLANTED].copy()
    dups[:, ::17] += 1
    return np.concatenate([base, dups])


def components(torch, edges, n):
    """Connected components of an undirected pair list on the card: each
    point's smallest reachable index (label propagation)."""
    label = torch.arange(n, device=edges.device)
    a, b = edges[:, 0], edges[:, 1]
    while True:
        nxt = label.scatter_reduce(0, a, label[b], reduce="amin")
        nxt = nxt.scatter_reduce(0, b, nxt[a], reduce="amin")
        nxt = nxt[nxt]
        if torch.equal(nxt, label):
            return label
        label = nxt


def dedup_check(torch, np, emb, res, pairs, eps):
    """``find_near_duplicates``'s result against a float64 brute force on
    the card in row blocks: its pair set (``pairs``) may differ from the
    brute force's only at the eps boundary, and its ``group_of`` / ``keep``
    / ``num_duplicate_pairs`` must equal the components of the brute-force
    pair set (the boundary pairs taken as the join decided them).  Returns
    (the boundary pairs the join decided unlike the float64 d2, the
    boundary pairs)."""
    n = emb.shape[0]
    pts = torch.from_numpy(emb).cuda()
    got = torch.from_numpy(pairs).cuda().long()
    got_key = torch.sort(got[:, 0] * n + got[:, 1]).values
    e2 = float(eps) ** 2
    sure, maybe, inside = [], [], []
    for s in range(0, n, DEDUP_BLOCK):
        d2, bw = boundary_band(pts[s:s + DEDUP_BLOCK], pts)
        i, j = torch.nonzero(d2 <= e2 - bw, as_tuple=True)
        sure.append((i + s) * n + j)
        band = (d2 - e2).abs() <= bw
        i, j = torch.nonzero(band, as_tuple=True)
        maybe.append((i + s) * n + j)
        inside.append((d2 <= e2)[band])
        del d2, bw, band
    sure, maybe, inside = torch.cat(sure), torch.cat(maybe), torch.cat(inside)
    check(bool(torch.isin(sure, got_key).all()), "dedup: the join missed pairs inside eps, away from the boundary")
    extra = got_key[~torch.isin(got_key, sure)]
    check(bool(torch.isin(extra, maybe).all()), "dedup: the join found pairs outside eps, away from the boundary")
    want = torch.cat([sure, extra])  # the brute-force set, boundary pairs as the join decided them
    edges = torch.stack([want // n, want % n], 1)
    label = components(torch, edges, n).cpu().numpy()
    check(np.array_equal(res.group_of, label), "dedup: group_of != the brute-force pair set's components")
    check(np.array_equal(res.keep, np.unique(label)), "dedup: keep != one representative per component")
    check(res.num_duplicate_pairs == int((edges[:, 0] != edges[:, 1]).sum()) // 2,
          "dedup: num_duplicate_pairs != the brute force's")
    return int((torch.isin(maybe, got_key) != inside).sum()), int(maybe.numel())


def phase_downstream(torch, np, cooc, cooc_engine, cooc_counts, cooc_pairs, profiled, seed):
    """Phase 10, the downstream and legacy paths, with the launch counters
    from 0: (a) ``self_join_hostloop`` counts on CoocTexture (K1 per pair
    only, once per ``ops.tile_counts`` chunk), held ``==`` phase 4's counts
    and the engine's work counters, timed beside the engine's ``count()``;
    (b) its pairs (K2 per pair once per ``ops.tile_mask`` chunk of each
    batch, and the estimate's K1), the pair set ``==`` phase 4's, the
    ``max_pairs`` error, the wall split into kernels, mask copies and host
    extraction; (c) the EGO CPU baseline on all of CoocTexture against phase
    4's counts up to the boundary band, timed beside the card's ``count()``;
    (d) near-duplicate dedup of DEDUP_EXAMPLES token examples on the card
    (the estimate's K1 and K2's fused pairs step at T = 32) against a float64
    brute force and its components; (e) an obs capture of CoocTexture's
    ``count()`` + ``pairs()`` written as a Chrome trace and read by
    ``python -m repro_torch.obs.report`` in a subprocess, and a truncated
    copy refused.  ``profiled`` is what ran under torch.profiler before the
    main path: (f) the bridge check and K2 per pair's device time at the
    host loop's mask chunk (``phase_bridge``)."""
    from repro_torch import obs
    from repro_torch.core import SelfJoinConfig, SelfJoinEngine, ego, self_join_hostloop
    from repro_torch.data import dedup
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention, ops

    mods = (distance_tile, dense_tile, flash_attention)

    def read():
        return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}

    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    t_phase = time.perf_counter()
    rec = {"phase": "downstream", "card": smi_name_limit(), "dataset": "CoocTexture", "points": int(cooc.shape[0]),
           "eps": COOC_EPS}
    cfg = SelfJoinConfig(eps=COOC_EPS)
    cpts = torch.from_numpy(cooc).cuda()

    def band(rows, *counts):
        if rows.size:
            lo, hi = count_bounds(torch, cpts, rows, COOC_EPS)
            for got in counts:
                check(bool(((got[rows] >= lo) & (got[rows] <= hi)).all()),
                      "counts differ from phase 4's beyond the eps boundary")
        return int(rows.size)

    # (a) the host loop's counts: K1 per pair
    torch.cuda.synchronize()
    before = read()
    t0 = time.perf_counter()
    hc = self_join_hostloop(cooc, cfg)
    host_count_s = time.perf_counter() - t0
    p = hc.stats.num_tile_pairs_evaluated
    only_launched(launched_since(before, *mods), {"tile_pair_distance": -(-p // chunk_default(ops.tile_counts))},
                  f"the host-loop count ({p} tile pairs)")
    check(p == cooc_engine.plan.num_pairs, f"the host loop planned {p} tile pairs, the engine {cooc_engine.plan.num_pairs}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ec = cooc_engine.count()
    engine_count_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    SelfJoinEngine(cooc, cfg).count()
    engine_cold_s = time.perf_counter() - t0
    check(np.array_equal(ec.counts, cooc_counts), "the engine's count() != phase 4's")
    for field in ("num_candidates", "dim_blocks_skipped", "dim_blocks_total", "num_results"):
        check(getattr(hc.stats, field) == getattr(ec.stats, field),
              f"host loop {field} {getattr(hc.stats, field)} != the engine's {getattr(ec.stats, field)}")
    rec["hostloop_count"] = {
        "wall_s": host_count_s, "engine_count_s": engine_count_s, "engine_build_and_count_s": engine_cold_s,
        "tile_pairs": p, "launches": -(-p // chunk_default(ops.tile_counts)),
        "num_candidates": hc.stats.num_candidates, "dim_blocks_skipped": hc.stats.dim_blocks_skipped,
        "rows_off_phase4": band(np.nonzero(hc.counts != cooc_counts)[0], hc.counts, cooc_counts)}

    # (b) the host loop's pairs: the estimate's K1, then K2 per pair per mask chunk of each batch
    torch.cuda.synchronize()
    before = read()
    hp, host_pairs_s, split, batches, timed = hostloop_pairs_split(
        torch, ops, distance_tile, lambda: self_join_hostloop(cooc, cfg, return_pairs=True))
    mask_chunk = chunk_default(ops.tile_mask)
    masks = sum(-(-b // mask_chunk) for b in batches)
    n_sample = max(1, min(p, int(round(p * max(cfg.sample_frac, 1e-6)))))  # batching.estimate_result_size's
    only_launched(launched_since(before, *mods),
                  {"tile_pair_distance_mask": masks, "tile_pair_distance": -(-n_sample // chunk_default(ops.tile_counts))},
                  f"the host-loop pairs ({len(batches)} batches, {masks} mask chunks)")
    check(timed == masks and sum(batches) == p, f"timed {timed} of {masks} mask launches over {sum(batches)} pairs")
    n = cooc.shape[0]
    check(np.array_equal(hp.counts, hc.counts), "host-loop pairs: counts != its count mode's")
    check(same_pair_set(torch, hp.pairs, cooc_pairs, n), "host-loop pairs != phase 4's pair set")
    total = hp.stats.num_results
    try:
        self_join_hostloop(cooc, cfg, return_pairs=True, max_pairs=total - 1)
        raise SmokeFailure(f"the host loop returned past max_pairs={total - 1}")
    except RuntimeError as exc:
        want = f"result exceeded max_pairs={total - 1}; raise the cap or lower eps"
        check(str(exc) == want, f"host-loop max_pairs error {str(exc)!r} != {want!r}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep = cooc_engine.pairs()
    engine_pairs_s = time.perf_counter() - t0
    check(same_pair_set(torch, ep.pairs, cooc_pairs, n), "the engine's pairs() != phase 4's")
    rec["hostloop_pairs"] = {
        "wall_s": host_pairs_s, "split": split, "engine_pairs_s": engine_pairs_s, "pairs": int(total),
        "n_b": len(batches), "batch_pairs": batches, "mask_chunk": mask_chunk, "mask_launches": masks,
        "mask_bytes_each": mask_chunk * cfg.tile_size ** 2,
        "mask_launch_ms_each": split["mask_launches_s"] * 1e3 / masks,
        "kernels_device_s": masks * profiled["mask_chunk"]["ms"] / 1e3,
        "estimate_sample_pairs": n_sample}
    del hp, ep

    # (c) the EGO CPU baseline, the paper's comparison target (Table 3)
    t0 = time.perf_counter()
    eg = ego.ego_join_counts(cooc, COOC_EPS)
    ego_s = time.perf_counter() - t0
    rec["ego"] = {"wall_s": ego_s, "engine_count_s": engine_count_s, "sum": int(eg.sum()),
                  "engine_sum": int(cooc_counts.sum()),
                  "rows_off_phase4": band(np.nonzero(eg != cooc_counts)[0], eg)}

    # (d) near-duplicate dedup of token examples on the card
    examples = dedup_examples(np, np.random.default_rng(seed))
    t0 = time.perf_counter()
    emb = dedup.hashed_ngram_embed(examples, dim=DEDUP_DIM)
    embed_s = time.perf_counter() - t0
    joined = {}
    self_join = dedup.self_join

    def captured(d, c, *args, **kw):  # keeps the pairs and times the join
        t = time.perf_counter()
        out = self_join(d, c, *args, **kw)
        joined.update(result=out, tile_size=c.tile_size, wall_s=time.perf_counter() - t)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # earlier phases' engines
    before = read()
    dedup.self_join = captured
    try:
        t0 = time.perf_counter()
        dd = dedup.find_near_duplicates(emb, DEDUP_EPS)
        dedup_s = time.perf_counter() - t0
    finally:
        dedup.self_join = self_join
    peak = torch.cuda.max_memory_allocated() - resident
    st = dd.stats
    grew = launched_since(before, *mods)
    est = grew["tile_pair_distance"]
    check(est > 0, "dedup ran no result-size estimate")
    only_launched(grew, {"tile_pair_distance": est, PAIRS[0]: 2 * st.num_device_dispatches},
                  f"dedup ({st.num_device_dispatches} pairs chunks)")
    check(joined["tile_size"] == 32, f"dedup joined at T = {joined['tile_size']}, not 32")
    off, band_pairs = dedup_check(torch, np, emb, dd, joined["result"].pairs, DEDUP_EPS)
    first = np.arange(DEDUP_PLANTED)
    rec["dedup"] = {
        "examples": DEDUP_EXAMPLES, "planted": DEDUP_PLANTED, "seq": DEDUP_SEQ, "vocab": DEDUP_VOCAB,
        "dim": DEDUP_DIM, "eps": DEDUP_EPS, "tile_size": joined["tile_size"],
        "embed_s": embed_s, "join_s": joined["wall_s"], "union_find_s": dedup_s - joined["wall_s"],
        "pairs": int(st.num_results), "duplicate_pairs": dd.num_duplicate_pairs, "kept": int(dd.keep.size),
        "planted_found": int((dd.group_of[DEDUP_EXAMPLES - DEDUP_PLANTED + first] == dd.group_of[first]).sum()),
        "band_pairs_off_float64": off, "band_pairs": band_pairs, "pairs_capacity": st.pairs_capacity,
        "overflow_retries": st.overflow_retries, "pairs_chunks": st.num_chunks,
        "launches": {k: v for k, v in grew.items() if v}, "peak_device_bytes_above_resident": peak}
    del examples, emb, joined, dd

    # (e) the trace report CLI on a capture of CoocTexture's count() + pairs()
    with obs.capture(capacity=1 << 20) as cap:
        rc = cooc_engine.count()
        rp = cooc_engine.pairs()
    check(cap.dropped == 0, f"the obs capture dropped {cap.dropped} events")
    (ROOT / "build").mkdir(exist_ok=True)
    path = ROOT / "build" / "downstream_trace.json"
    cap.write_chrome_trace(str(path))
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(path), "--json"], env=env,
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"the report CLI exited {out.returncode}: {out.stderr[-2000:]}")
    rep = json.loads(out.stdout)
    dispatches = sum(a["count"] for a in rep["phases"].get("dispatch", {}).values())
    want = rc.stats.num_device_dispatches + rp.stats.num_device_dispatches
    check(dispatches == want, f"the report counts {dispatches} dispatch spans, the joins {want}")
    bad = ROOT / "build" / "downstream_trace_truncated.json"
    text = path.read_text()
    bad.write_text(text[: len(text) // 2])
    cut = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", str(bad)], env=env,
                         capture_output=True, text=True, timeout=300)
    check(cut.returncode == 1 and "cannot parse trace" in cut.stderr,
          f"the report CLI read a truncated trace: exit {cut.returncode}")
    rec["trace_report"] = {"trace_bytes": len(text), "spans": rep["num_spans"], "instants": rep["num_instants"],
                           "dispatch_spans": dispatches, "truncated_exit": cut.returncode}
    path.unlink()
    bad.unlink()
    del rp

    rec["bridge"], rec["k2_per_pair_mask_chunk"] = profiled["bridge"], profiled["mask_chunk"]
    launches = read()
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return launches


# -- phase 11: the model serving path -----------------------------------------

MODEL_ARCHS = ("gemma3_12b", "phi3_mini_3p8b", "qwen3_32b", "qwen2p5_32b", "recurrentgemma_2b", "arctic_480b",
               "deepseek_v2_236b", "seamless_m4t_medium", "llama3p2_vision_11b",
               "xlstm_125m")   # (a): all ten archs of repro_torch.configs
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # card against the CPU, max|diff| / max|ref|
MODEL_PROMPT, MODEL_DECODE = 12, 8     # (a): reduced gemma3's window is 8, so its ring wraps
SERVE_ARCH = "gemma3_12b"              # (b): full width and depth, 48 layers, fp32 params
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 1536, 16   # the prompt passes the local window of 1024
SERVE_PARAMS = 11_765_419_776          # the reference's count_params_analytic at gemma3-12b
SERVE_HEADROOM = 8e9                   # device bytes (b) needs beyond the weights
CONSIST_LEN = 1040                     # (c): prefill on 1039 tokens wraps the local layers' ring
CONSIST_TOL = 5e-3                     # tests/test_archs_smoke.py's own decode / train bound
FLASH_TOL = 1e-5                       # (c): _flash against attention_plain, max|diff| / max|ref|
# (e): the archs of MLA, MoE and the recurrent mixers at full width, one after another, each
# freed before the next.  params: the reference's count_params_analytic at the
# config served (deepseek-v2 and arctic cut in depth: their 236B / 477B
# parameters do not fit one card); repeats: each layer group's repeat after the
# cut (None: full depth); prompt: tokens per prompt; consist: (d)'s length
FULL_ARCHS = {
    "recurrentgemma_2b": {"params": 2_894_481_920, "repeats": None, "prompt": 2304, "consist": 2100},
    "xlstm_125m": {"params": 102_425_160, "repeats": None, "prompt": 1000, "consist": 1000},
    "deepseek_v2_236b": {"params": 9_330_795_520, "repeats": (1, 2), "prompt": 512, "consist": 512},
    "arctic_480b": {"params": 14_069_945_344, "repeats": (1,), "prompt": 512, "consist": 512},
}
FULL_BATCH, FULL_NEW = 4, 16
FULL_HEADROOM = 12e9                   # device bytes (e) needs beyond an arch's weights
CONSIST_CAPACITY = 8.0                 # (e)'s MoE capacity factor against forward_train (test_archs_smoke.py's)


def rel_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-30))


def rel_err32(got, want):
    """``rel_err`` in fp32, for leaves of GBs."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30))


def model_twin(torch, serve, M, cfg, params, device, seed, forced=None):
    """Prefill MODEL_PROMPT tokens, then MODEL_DECODE greedy steps on ``device``
    (fed ``forced``'s tokens when given, so two devices see the same inputs)."""
    batch = serve.make_batch(cfg, 2, MODEL_PROMPT, device, seed)
    logits, caches, memory = M.prefill(params, batch, cfg, MODEL_PROMPT + MODEL_DECODE)
    out = {"logits": [logits.cpu()], "caches": M.tree_map(lambda t: t.cpu().clone(), caches)}
    toks = [torch.argmax(logits, dim=-1).to(torch.int32)]
    for i in range(MODEL_DECODE):
        feed = toks[-1] if forced is None else forced[i].to(device)
        logits, caches = M.decode_step(params, caches, feed, MODEL_PROMPT + i, cfg, memory=memory)
        out["logits"].append(logits.cpu())
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    out["tokens"] = [t.cpu() for t in toks]
    out["decoded_caches"] = M.tree_map(lambda t: t.cpu(), caches)
    return out


def tree_err(M, got, want):
    """The largest max|diff| / max|ref| over a cache tree's float leaves; its int leaves must be equal."""
    errs = []
    for g, w in zip(M.tree_leaves(got), M.tree_leaves(want)):
        check(g.shape == w.shape and g.dtype == w.dtype, f"cache leaf {tuple(g.shape)} {g.dtype} != "
              f"{tuple(w.shape)} {w.dtype}")
        if g.is_floating_point():
            errs.append(rel_err(g, w))
        else:
            check(bool((g == w).all()), "a cache's positions differ between the card and the CPU")
    return max(errs)


def model_reduced(torch, serve, M, configs, seed):
    """(a): each arch's reduced config on the card against the same
    parameters on the CPU, at fp32 and at bf16 activations."""
    out = {}
    for arch in MODEL_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype=dtype)
            params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
            want = model_twin(torch, serve, M, cfg, params, torch.device("cpu"), seed)
            got = model_twin(torch, serve, M, cfg, M.tree_map(lambda t: t.cuda(), params), torch.device("cuda"),
                             seed, forced=want["tokens"])
            tol = MODEL_TOL[dtype]
            errs = {"prefill_logits": rel_err(got["logits"][0], want["logits"][0]),
                    "decode_logits": max(rel_err(g, w) for g, w in zip(got["logits"][1:], want["logits"][1:])),
                    "prefill_caches": tree_err(M, got["caches"], want["caches"]),
                    "decoded_caches": tree_err(M, got["decoded_caches"], want["decoded_caches"])}
            for what, err in errs.items():
                check(err <= tol, f"{arch} {dtype}: {what} on the card {err:.3g} from the CPU's (> {tol})")
            # greedy tokens: equal, except where the CPU's top-2 logits lie within the tolerance
            ties = 0
            for lg, g, w in zip(want["logits"], got["tokens"], want["tokens"]):
                for b in torch.nonzero(g != w).flatten().tolist():
                    top2 = torch.topk(lg[b], 2).values
                    gap = float(top2[0] - top2[1]) / float(lg[b].abs().max())
                    check(gap <= tol, f"{arch} {dtype}: greedy token {int(g[b])} != {int(w[b])} (top-2 gap {gap:.3g})")
                    ties += 1
            out[f"{arch}/{dtype}"] = {**errs, "near_tie_tokens": ties}
    return out


def model_full_serve(torch, serve, M, A, B, L, configs, seed):
    """(b): gemma3-12b at full width and depth through ``launch/serve``'s
    ``make_batch`` / ``generate``, the weights drawn on the card."""
    free, total = torch.cuda.mem_get_info()
    need = SERVE_PARAMS * 4 + SERVE_HEADROOM
    check(free >= need, f"the card has {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; the full-width model "
          f"needs {need / 1e9:.1f} GB (allocated by this process: {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
    cfg = configs.get_config(SERVE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = M.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == SERVE_PARAMS, f"{SERVE_ARCH} has {n_params} parameters, not {SERVE_PARAMS}")
    check(all(t.dtype == torch.float32 and t.is_cuda for t in leaves), "the weights are not fp32 on the card")
    serve.generate(cfg, params, serve.make_batch(cfg, 1, 64, "cuda", seed), 2)   # warm-up: libraries, allocator
    batch = serve.make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, "cuda", seed)
    gen = serve.generate(cfg, params, batch, SERVE_NEW)
    check(bool(torch.isfinite(gen.logits).all()), "the full-width logits are not finite")
    check(gen.tokens.shape == (SERVE_BATCH, SERVE_NEW) and bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()),
          "the full-width tokens are not ids below the vocab")
    # the ring: a local layer holds the last `window` positions, a global one all of them
    window, end = cfg.groups[0][0][0].window, SERVE_PROMPT + SERVE_NEW - 1
    local, glob = (gen.caches[0][i]["pos"][0].tolist() for i in (0, 5))
    check(SERVE_PROMPT > window and sorted(local) == list(range(end - window, end)),
          f"the local layers' ring does not hold the last {window} positions")
    check(glob == list(range(end)) + [-1], "the global layers' cache does not hold every position")
    steps = SERVE_NEW - 1
    rec = {
        "arch": cfg.name, "layers": cfg.num_layers, "params": n_params, "param_bytes": n_params * 4,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW, "window": window,
        "init_s": init_s, "prefill_ms": gen.prefill_s * 1e3, "decode_ms_per_token": gen.decode_s / steps * 1e3,
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / gen.prefill_s,
        "decode_tokens_per_s": SERVE_BATCH * steps / gen.decode_s,
        "tokens_per_s": SERVE_BATCH * SERVE_NEW / (gen.prefill_s + gen.decode_s),
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "sample": gen.tokens[0].tolist(),
    }
    rec["split"] = model_serve_split(torch, M, A, B, L, cfg, params, gen, batch)
    del gen
    return rec, params


def model_serve_split(torch, M, A, B, L, cfg, params, gen, batch):
    """Where (b)'s time goes: CUDA events around one local and one global
    layer at the prefill's shape, whole and by part (the four attention
    projections, ``_flash``, the FFN), and one decode step by the host
    clock beside the same step replayed as a CUDA graph (its device time
    without the host's launches; "not measured" if the capture fails)."""
    x = M._embed_tokens(params, cfg, batch["tokens"])
    positions = torch.arange(SERVE_PROMPT, dtype=torch.int32, device="cuda")
    cache_len = SERVE_PROMPT + SERVE_NEW
    pattern = cfg.groups[0][0]
    out = {}
    for i in (0, len(pattern) - 1):
        blk, p = pattern[i], M.tree_map(lambda a: a[0], params["groups"][0][i])
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v, kpos = A.project_qkv(p["attn"], h, positions, cfg, blk)
        o = q.reshape(SERVE_BATCH, SERVE_PROMPT, -1)
        ffn_ms = event_ms(torch, lambda: L.swiglu(p["ffn"], h), 2)
        out["local" if blk.window else "global"] = {
            "layer": i,
            "block_ms": event_ms(torch, lambda: B.block_seq(p, x, positions, cfg, blk, want_cache=True,
                                                            cache_len=cache_len), 2),
            "projections_ms": event_ms(torch, lambda: [L.dense(p["attn"][w], h) for w in ("wq", "wk", "wv")]
                                       + [L.dense(p["attn"]["wo"], o)], 2),
            "flash_ms": event_ms(torch, lambda: A._flash(q, k, v, positions, kpos, causal=True, window=blk.window,
                                                         q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk), 2),
            "ffn_ms": ffn_ms,
            "ffn_tflops": 6 * SERVE_BATCH * SERVE_PROMPT * cfg.d_model * cfg.d_ff / ffn_ms / 1e9,
        }
    n_global = sum(1 for b in pattern if not b.window) * cfg.groups[0][1]
    out["layers_ms"] = (out["local"]["block_ms"] * (cfg.num_layers - n_global)
                        + out["global"]["block_ms"] * n_global)
    tok, pos = torch.from_numpy(gen.tokens[:, -1]).cuda(), SERVE_PROMPT + SERVE_NEW - 1

    def step():
        return M.decode_step(params, gen.caches, tok, pos, cfg)[0]

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    out["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        out["decode_step_graph_ms"] = event_ms(torch, graph.replay, 5)
        out["decode_host_share"] = 1 - out["decode_step_graph_ms"] / out["decode_step_ms"]
        del graph
    except RuntimeError as exc:   # a measurement, not a check: the eager step above is the path
        out["decode_step_graph_ms"] = f"not measured ({exc})"[:300]
    return out


def decode_vs_train(torch, M, MOE, cfg, params, s, seed):
    """Batch 1 with fp32 activations (an MoE at CONSIST_CAPACITY, its drops
    counted): prefill on s - 1 tokens plus one decode step against
    forward_train's logits at s - 1.  Returns (record, tokens, the caches
    after the step)."""
    overrides = {"activation_dtype": "float32"}
    if cfg.moe is not None:
        overrides["moe"] = dataclasses.replace(cfg.moe, capacity_factor=CONSIST_CAPACITY)
    cfg = dataclasses.replace(cfg, **overrides)
    dev = params["embed"]["table"].device
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=gen, device=dev, dtype=torch.int32)
    out = {"length": s}

    def train():
        return M.forward_train(params, {"tokens": tokens, "labels": tokens}, cfg)[1]

    if cfg.moe is None:
        logits = train()
    else:
        logits, out["forward_train_dropped"], _ = moe_drops(MOE, train)
        out["capacity_factor"] = CONSIST_CAPACITY
    want = logits[:, s - 1].clone()
    del logits
    ctx = {"tokens": tokens[:, : s - 1], "labels": tokens[:, : s - 1]}
    _, caches, memory = M.prefill(params, ctx, cfg, cache_len=s)
    lg, caches = M.decode_step(params, caches, tokens[:, s - 1], s - 1, cfg, memory=memory)
    rel = rel_err(lg, want)
    check(rel < CONSIST_TOL, f"{cfg.name}: decode against forward_train at full width: rel {rel:.3g}")
    out.update(decode_vs_forward_train_rel=rel, decode_tol=CONSIST_TOL)
    return out, tokens, caches


def model_consistency(torch, M, A, B, L, configs, params, seed):
    """(c): the same weights at batch 1 with fp32 activations: prefill on
    CONSIST_LEN - 1 tokens plus one decode step against forward_train's
    logits at that position (``decode_vs_train``), and one local and one
    global layer's _flash against attention_plain on that layer's own
    projections."""
    cfg = dataclasses.replace(configs.get_config(SERVE_ARCH), activation_dtype="float32")
    s, dev = CONSIST_LEN, params["embed"]["table"].device
    window = cfg.groups[0][0][0].window
    with torch.no_grad():
        out, tokens, caches = decode_vs_train(torch, M, None, cfg, params, s, seed)
        local_pos = caches[0][0]["pos"][0]
        check(s > window and sorted(local_pos.tolist()) == list(range(s - window, s)),
              f"the local layers' cache does not hold the last {window} positions")
        del caches
        # the first pattern's blocks in order: position 0 is local, position 5 global
        x = M._embed_tokens(params, cfg, tokens)
        positions = torch.arange(s, dtype=torch.int32, device=dev)
        flash = {}
        pattern = cfg.groups[0][0]
        for i, blk in enumerate(pattern):
            p = M.tree_map(lambda a: a[0], params["groups"][0][i])
            if i in (0, len(pattern) - 1):
                h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
                q, k, v, kpos = A.project_qkv(p["attn"], h, positions, cfg, blk)
                kw = dict(causal=True, window=blk.window)
                got = A._flash(q, k, v, positions, kpos, q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk, **kw)
                ref = A.attention_plain(q, k, v, positions, kpos, **kw)
                err = rel_err(got, ref)
                check(err <= FLASH_TOL, f"_flash against attention_plain at layer {i} (window {blk.window}): {err:.3g}")
                flash["local" if blk.window else "global"] = {"layer": i, "window": blk.window, "rel_err": err}
            x, _ = B.block_seq(p, x, positions, cfg, blk)
    return {**out, "flash_vs_plain": flash, "flash_tol": FLASH_TOL}


def cut_depth(cfg, repeats):
    """``cfg`` with its layer groups' repeats set to ``repeats`` (None: as is)."""
    if repeats is None:
        return cfg
    return dataclasses.replace(cfg, groups=tuple((pattern, r) for (pattern, _), r in zip(cfg.groups, repeats)))


def moe_drops(MOE, run):
    """``run()`` with every ``moe_apply`` call counting its dropped
    assignments first; returns (run's result, dropped, assignments)."""
    real, counts = MOE.moe_apply, []

    def counting(p, x, cfg):
        counts.append((MOE.dropped_assignments(p, x, cfg), x.shape[0] * x.shape[1] * cfg.moe.top_k))
        return real(p, x, cfg)

    MOE.moe_apply = counting
    try:
        out = run()
    finally:
        MOE.moe_apply = real
    return out, sum(c[0] for c in counts), sum(c[1] for c in counts)


def model_full_arch(torch, serve, M, MOE, configs, arch, seed):
    """(e): one arch of FULL_ARCHS at full width (its depth cut where
    FULL_ARCHS says), weights drawn on the card, serving FULL_BATCH prompts
    through ``launch/serve``; then the same weights at batch 1 with fp32
    activations, decode against forward_train."""
    spec = FULL_ARCHS[arch]
    full = configs.get_config(arch)
    cfg = cut_depth(full, spec["repeats"])
    elem = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    free, total = torch.cuda.mem_get_info()
    need = spec["params"] * elem + FULL_HEADROOM
    check(free >= need, f"{arch}: the card has {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; it needs "
          f"{need / 1e9:.1f} GB (allocated by this process: {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = M.tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    check(n_params == spec["params"], f"{arch} has {n_params} parameters, not {spec['params']}")
    check(n_params == M.count_params_analytic(cfg), f"{arch}: the tree and count_params_analytic differ")
    check(all(t.is_cuda for t in leaves), f"{arch}: a weight is not on the card")
    prompt, cache_len = spec["prompt"], spec["prompt"] + FULL_NEW
    serve.generate(cfg, params, serve.make_batch(cfg, 1, 64, "cuda", seed), 2)   # warm-up: libraries, allocator
    batch = serve.make_batch(cfg, FULL_BATCH, prompt, "cuda", seed)
    gen = serve.generate(cfg, params, batch, FULL_NEW)
    check(bool(torch.isfinite(gen.logits).all()), f"{arch}: the full-width logits are not finite")
    check(gen.tokens.shape == (FULL_BATCH, FULL_NEW) and bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab)).all()),
          f"{arch}: the full-width tokens are not ids below the vocab")
    steps = FULL_NEW - 1
    rec = {
        "arch": cfg.name, "layers": cfg.num_layers, "full_layers": full.num_layers,
        "depth_cut": None if spec["repeats"] is None else
        f"{cfg.num_layers} of {full.num_layers} layers: the full model's "
        f"{M.count_params_analytic(full) / 1e9:.0f}B parameters do not fit one card",
        "params": n_params, "param_dtype": cfg.param_dtype, "param_bytes": n_params * elem,
        "activation_dtype": cfg.activation_dtype, "batch": FULL_BATCH, "prompt": prompt, "new_tokens": FULL_NEW,
        "init_s": init_s, "prefill_ms": gen.prefill_s * 1e3, "decode_ms_per_token": gen.decode_s / steps * 1e3,
        "prefill_tokens_per_s": FULL_BATCH * prompt / gen.prefill_s,
        "decode_tokens_per_s": FULL_BATCH * steps / gen.decode_s,
        "tokens_per_s": FULL_BATCH * FULL_NEW / (gen.prefill_s + gen.decode_s),
        "peak_device_bytes": torch.cuda.max_memory_allocated(), "sample": gen.tokens[0].tolist(),
    }
    attn = [(gi, i, blk.window) for gi, (pattern, _) in enumerate(cfg.groups)
            for i, blk in enumerate(pattern) if blk.kind == "attn" and blk.window]
    if attn:   # recurrentgemma's local MQA layers: the ring holds the last `window` positions
        gi, i, window = attn[0]
        end = prompt + FULL_NEW - 1
        ring = gen.caches[gi][i]["pos"][0].tolist()
        check(prompt > window and sorted(ring) == list(range(end - window, end)),
              f"{arch}: the local layers' ring does not hold the last {window} positions")
        rec["window"] = window
    del gen
    if cfg.moe is not None:   # the prefill again, counting dropped assignments (decode's groups are one token)
        _, rec["dropped_assignments"], rec["assignments"] = moe_drops(
            MOE, lambda: M.prefill(params, batch, cfg, cache_len))
        rec["capacity_factor"] = cfg.moe.capacity_factor
    if cfg.mla is not None:
        rec["absorbed_vs_decompressed"] = mla_forms(torch, M, cfg, params, batch, cache_len)
    rec["consistency"] = decode_vs_train(torch, M, MOE, cfg, params, spec["consist"], seed)[0]
    rec["peak_device_bytes_with_consistency"] = torch.cuda.max_memory_allocated()
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mla_forms(torch, M, cfg, params, batch, cache_len):
    """(e): deepseek's prefill decompressed and absorbed (``mla_absorbed``),
    timed, at the served activations and at fp32; the two forms' logits
    must agree within MODEL_TOL at fp32, where they differ by fp32 rounding
    (at bf16 the absorbed form rounds its absorbed query to bf16 too, so
    that error is recorded beside its times)."""
    out = {}
    for dtype in (cfg.activation_dtype, "float32"):
        logits = {}
        for name, absorbed in (("decompressed", False), ("absorbed", True)):
            c = dataclasses.replace(cfg, activation_dtype=dtype, mla_absorbed=absorbed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[name] = M.prefill(params, batch, c, cache_len)[0]
            torch.cuda.synchronize()
            out.setdefault(dtype, {})[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[dtype]["rel_err"] = rel_err(logits["absorbed"], logits["decompressed"])
    err = out["float32"]["rel_err"]
    check(err <= MODEL_TOL["float32"], f"{cfg.name}: absorbed prefill {err:.3g} from decompressed at fp32")
    out["float32"]["tol"] = MODEL_TOL["float32"]
    return out


def phase_model_serve(torch, seed):
    """Phase 11, the model serving path, with the launch counters from 0:
    (a) all ten archs' reduced configs on the card against the port on the
    CPU with the same parameters (prefill logits and caches or states, 8
    teacher-forced decode steps' logits and caches or states, greedy
    tokens); (b) gemma3-12b at full width and depth (fp32 weights drawn on
    the card) serving SERVE_BATCH prompts of SERVE_PROMPT tokens and
    SERVE_NEW new tokens through ``launch/serve``, with the card's name and
    power limit beside its times; (c) the same weights at batch 1 with fp32
    activations: decode against forward_train, and _flash against
    attention_plain at a local and a global layer; (e) after (b)'s weights
    are freed, the four archs of FULL_ARCHS at full width (deepseek-v2 and
    arctic cut in depth), one after another: serving FULL_BATCH prompts and
    FULL_NEW new tokens (prefill, decode, tokens/s, peak device memory,
    the MoE's dropped assignments, deepseek's absorbed prefill against the
    decompressed one), then decode against forward_train at batch 1 with
    fp32 activations; (d) no kernel of ``repro_torch.kernels`` launches:
    the models call none."""
    from repro_torch import configs
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import attention as A
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    mods = (distance_tile, dense_tile, flash_attention)
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    t_phase = time.perf_counter()
    rec = {"phase": "model_serve", "card": smi_name_limit(), "tolerances": {
        "card_vs_cpu": MODEL_TOL, "decode_vs_forward_train": CONSIST_TOL, "flash_vs_plain": FLASH_TOL}}
    with torch.no_grad():
        t0 = time.perf_counter()
        rec["reduced"] = model_reduced(torch, serve, M, configs, seed)
        rec["reduced_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["serve"], params = model_full_serve(torch, serve, M, A, B, L, configs, seed)
        rec["serve"]["wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["consistency"] = model_consistency(torch, M, A, B, L, configs, params, seed)
        rec["consistency"]["wall_s"] = time.perf_counter() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()
        rec["full_width"] = {}
        for arch in FULL_ARCHS:
            t0 = time.perf_counter()
            rec["full_width"][arch] = model_full_arch(torch, serve, M, MOE, configs, arch, seed)
            rec["full_width"][arch]["wall_s"] = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    check(not any(launches.values()), f"the model path launched {({k: v for k, v in launches.items() if v})}")
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return launches


# -- phase 12: the training path ------------------------------------------------

TRAIN_HP = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 10}   # (a)'s AdamW (step 1: lr 5e-4)
TRAIN_BATCH, TRAIN_SEQ = 2, 40          # (a): three 16-row query / key chunks, the last padded
TRAIN_CE_CHUNK = 200                    # (a): the reduced vocab of 512 in three chunks, the last overlapping
XLSTM_TRAIN = ["--arch", "xlstm_125m", "--full-config", "--batch", "8", "--seq", "1024", "--dedup",
               "--device", "cuda", "--ckpt-every", "1"]   # (b): launch/train's default arch, uncut
XLSTM_PARAMS = 102_425_160              # the reference's count_params_analytic at xlstm-125m
XLSTM_STEPS = 2                         # each step host-bound by the sLSTM loop
RESUME_TOL = 1e-4                       # (b): resumed against uninterrupted, max|diff| / max|ref| (the
                                        # embedding's scatter-add on the card is not bit-deterministic)
RG_ARCH = "recurrentgemma_2b"           # (c): uncut, bf16 activations, remat="block", flash_remat
RG_BATCH, RG_SEQ, RG_STEPS = 2, 2048, 3
RG_PARAMS = 2_894_481_920               # the reference's count_params_analytic at recurrentgemma-2b
RG_HEADROOM = 6e9                       # device bytes (c) needs beyond params, grads, m and v: its peak
                                        # lies 3.1 GB past them (5.9 GB when the bf16 gradient copy was
                                        # made whole, before it was cast leaf by leaf)
BWD_TOL = 1e-4                          # (d): the rematerialized backwards against the materialized ones
CE_TOKENS = (1, 2048)                   # (d): the streaming CE's tokens at recurrentgemma's vocab


def to_device(M, tree, device):
    return M.tree_map(lambda t: t.detach().to(device).clone(), tree)


def train_twin_step(torch, M, steps, cfg, params, batch, hp, device):
    """``loss_and_grads`` and one ``make_train_step`` step from ``params`` on
    ``device``; everything returned on the CPU."""
    from repro_torch.train import adamw_init

    p = to_device(M, params, device)
    b = {k: v.to(device) for k, v in batch.items()}
    loss, grads = steps.loss_and_grads(p, b, cfg)
    p, _, met = steps.make_train_step(cfg, hp)(p, adamw_init(p, cfg.opt_state_dtype), b)
    cpu = torch.device("cpu")
    return loss.cpu(), to_device(M, grads, cpu), to_device(M, p, cpu), {k: v.cpu() for k, v in met.items()}


def updated_params_err(torch, M, got, want, grads, lr, tol):
    """Updated params, card against CPU, per leaf within ``tol`` x its
    largest, except where the CPU's gradient lies within ``tol`` of 0
    (relative to its leaf's largest): AdamW's first step moves a weight by
    about lr g / |g|, so where the two read the sign of a near-zero gradient
    apart the weight lands 2 lr apart, which such an element is allowed.
    Returns (the largest relative error elsewhere, the elements allowed 2 lr)."""
    worst, loose = 0.0, 0
    for g, w, gr in zip(M.tree_leaves(got), M.tree_leaves(want), M.tree_leaves(grads)):
        diff = (g.double() - w.double()).abs()
        scale = float(w.double().abs().max().clamp_min(1e-30))
        near0 = gr.double().abs() <= tol * gr.double().abs().max()
        bound = tol * scale + 2 * lr * near0.double()
        check(bool((diff <= bound).all()), f"an updated parameter lies {float((diff - bound).max()):.3g} past its "
              "bound")
        worst = max(worst, float((diff * ~near0).max()) / scale)
        loose += int(near0.sum())
    return worst, loose


def train_card_vs_cpu(torch, M, configs, steps, arch, dtype, seed):
    """``arch``'s reduced config at ``dtype`` activations, one train step on
    the card against the same step on the CPU from the same weights and
    batch: loss, grad_norm, lr and the gradients within MODEL_TOL (fp32:
    max|diff| / max|ref| per leaf; bf16: ||diff|| / ||ref|| over the whole
    gradient, the per-leaf figures recorded beside it), the updated params
    as ``updated_params_err`` allows.  Returns the errors."""
    from repro_torch.launch import serve
    from repro_torch.train import OptHParams

    hp = OptHParams(**TRAIN_HP)
    cfg = dataclasses.replace(configs.get_reduced_config(arch), activation_dtype=dtype, ce_chunk=TRAIN_CE_CHUNK)
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    batch = serve.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, "cpu", seed)
    want = train_twin_step(torch, M, steps, cfg, params, batch, hp, torch.device("cpu"))
    got = train_twin_step(torch, M, steps, cfg, params, batch, hp, torch.device("cuda"))
    tol = MODEL_TOL[dtype]
    errs = {name: rel_err(got[3][name], want[3][name]) for name in ("loss", "grad_norm", "lr")}
    errs["loss_and_grads_loss"] = rel_err(got[0], want[0])
    diffs = [(g.double() - w.double(), w.double()) for g, w in zip(M.tree_leaves(got[1]), M.tree_leaves(want[1]))]
    errs["grads_max"] = max(float(d.abs().max() / w.abs().max().clamp_min(1e-30)) for d, w in diffs)
    errs["grads_leaf_l2"] = max(float(d.norm() / w.norm().clamp_min(1e-30)) for d, w in diffs)
    errs["grads_l2"] = float(sum(d.square().sum() for d, _ in diffs).sqrt()
                             / sum(w.square().sum() for _, w in diffs).sqrt())
    # fp32: every gradient element within tol of its leaf's largest.  bf16: the whole
    # gradient's ||diff|| / ||ref||; per leaf, bf16 gradients are too ill-conditioned
    # for tol: on the CPU alone, weights one fp32 ulp apart move a qk-norm scale's
    # past it (tests/test_torch_train_remat.py)
    checked = [*(n for n in errs if not n.startswith("grads")), "grads_max" if dtype == "float32" else "grads_l2"]
    for what in checked:
        check(errs[what] <= tol, f"{arch} {dtype}: {what} on the card {errs[what]:.3g} from the CPU's (> {tol})")
    errs["params"], errs["params_near_zero_grads"] = updated_params_err(
        torch, M, got[2], want[2], want[1], float(want[3]["lr"]), tol)
    check(errs["params"] <= tol, f"{arch} {dtype}: updated params {errs['params']:.3g} (> {tol})")
    return errs


def model_train_reduced(torch, M, configs, steps, seed):
    """(a): ``train_card_vs_cpu`` for each arch at fp32 and bf16 activations."""
    return {f"{arch}/{dtype}": train_card_vs_cpu(torch, M, configs, steps, arch, dtype, seed)
            for arch in MODEL_ARCHS for dtype in ("float32", "bfloat16")}


def checkpoint_params(torch, M, configs, ckpt_dir, step):
    """xlstm-125m's params of ``ckpt_dir``'s checkpoint ``step``, on the CPU."""
    from repro_torch.train import adamw_init, restore_checkpoint

    cfg = configs.get_config("xlstm_125m")
    like_p = M.abstract_params(cfg)
    tree, _, extra = restore_checkpoint(str(ckpt_dir), {"params": like_p, "opt": adamw_init(like_p)}, step=step,
                                        device="cpu")
    check(extra == {"data_cursor": step}, f"checkpoint {step} holds data cursor {extra}")
    return tree["params"]


def model_train_xlstm(torch, M, configs, train):
    """(b): xlstm-125m uncut through ``launch/train.main`` with --dedup:
    XLSTM_STEPS uninterrupted steps (a checkpoint every step), then half of
    them in a second directory and a resume to XLSTM_STEPS; final losses
    and the last step's params within RESUME_TOL."""
    import contextlib
    import io

    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    check(M.count_params_analytic(configs.get_config("xlstm_125m")) == XLSTM_PARAMS,
          "xlstm-125m's parameter count moved")
    runs = {}
    for name, ckpt, n in (("whole", "whole", XLSTM_STEPS), ("first_half", "split", XLSTM_STEPS // 2),
                          ("resumed", "split", XLSTM_STEPS)):
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            loss = train.main([*XLSTM_TRAIN, "--steps", str(n), "--ckpt-dir", str(root / ckpt)])
        torch.cuda.synchronize()
        runs[name] = {"loss": loss, "wall_s": time.perf_counter() - t0, "steps": n,
                      "peak_device_bytes": torch.cuda.max_memory_allocated(), "log": buf.getvalue().splitlines()}
        check(math.isfinite(loss), f"xlstm-125m's {name} run: loss {loss}")
    half = XLSTM_STEPS // 2
    check(any(line.startswith(f"resumed from step {half} (data cursor {half})") for line in runs["resumed"]["log"]),
          f"the second xlstm-125m run did not resume from step {half}")
    for name, run in runs.items():
        check(any(line.startswith("dedup: kept ") for line in run["log"]), f"xlstm-125m's {name} run: no dedup line")
    loss_err = abs(runs["resumed"]["loss"] - runs["whole"]["loss"]) / abs(runs["whole"]["loss"])
    check(loss_err <= RESUME_TOL, f"xlstm-125m resumed: loss {loss_err:.3g} from uninterrupted (> {RESUME_TOL})")
    whole = checkpoint_params(torch, M, configs, root / "whole", XLSTM_STEPS)
    split = checkpoint_params(torch, M, configs, root / "split", XLSTM_STEPS)
    param_err = max(rel_err(a, b) for a, b in zip(M.tree_leaves(split), M.tree_leaves(whole)))
    check(param_err <= RESUME_TOL, f"xlstm-125m resumed: step-{XLSTM_STEPS} params {param_err:.3g} from "
          f"uninterrupted (> {RESUME_TOL})")
    first = checkpoint_params(torch, M, configs, root / "split", XLSTM_STEPS // 2)
    check(max(rel_err(a, b) for a, b in zip(M.tree_leaves(split), M.tree_leaves(first))) > 0,
          f"xlstm-125m's params did not move from step {XLSTM_STEPS // 2} to step {XLSTM_STEPS}")
    del whole, split, first
    shutil.rmtree(root, ignore_errors=True)
    return {"params": XLSTM_PARAMS, "argv": XLSTM_TRAIN, "runs": runs, "resume_loss_rel": loss_err,
            "resume_params_rel": param_err, "tol": RESUME_TOL,
            "step_s": runs["whole"]["wall_s"] / XLSTM_STEPS,
            "tokens_per_s": 8 * 1024 * XLSTM_STEPS / runs["whole"]["wall_s"]}


def model_train_full(torch, M, configs, steps, seed):
    """(c): recurrentgemma-2b uncut, RG_STEPS ``make_train_step`` steps at
    RG_BATCH x RG_SEQ, each split by CUDA events into forward (the loss),
    backward (the gradients and their bf16 cast) and the optimizer, with
    tokens/s and peak device memory; loss and grad_norm finite, the params
    moved."""
    from repro_torch.launch import serve
    from repro_torch.train import OptHParams, adamw_init

    cfg = configs.get_config(RG_ARCH)
    check(cfg.remat and cfg.remat_mode == "block" and cfg.flash_remat, f"{RG_ARCH}: not remat='block' + flash_remat")
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = RG_PARAMS * 16 + RG_HEADROOM
    check(free >= need, f"{RG_ARCH}: the card has {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; training needs "
          f"{need / 1e9:.1f} GB ({device_memory(torch)})")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    n_params = sum(t.numel() for t in M.tree_leaves(params))
    check(n_params == RG_PARAMS, f"{RG_ARCH} has {n_params} parameters, not {RG_PARAMS}")
    opt = adamw_init(params, cfg.opt_state_dtype)
    watch = [t.view(-1)[:4096].clone() for t in M.tree_leaves(params)]
    batch = serve.make_batch(cfg, RG_BATCH, RG_SEQ, "cuda", seed)
    step = steps.make_train_step(cfg, OptHParams(lr=3e-4, warmup_steps=1, total_steps=RG_STEPS))

    marks = []
    real_loss, real_update = steps.forward_loss, steps.adamw_update

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    def timed_loss(*a, **kw):
        mark("start")
        out = real_loss(*a, **kw)
        mark("forward")
        return out

    def timed_update(*a, **kw):
        mark("backward")
        out = real_update(*a, **kw)
        mark("optimizer")
        return out

    steps.forward_loss, steps.adamw_update = timed_loss, timed_update
    rows = []
    try:
        for i in range(RG_STEPS):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ev = dict(marks)
            row = {"step": i + 1, "wall_ms": wall * 1e3,
                   "forward_ms": ev["start"].elapsed_time(ev["forward"]),
                   "backward_ms": ev["forward"].elapsed_time(ev["backward"]),
                   "optimizer_ms": ev["backward"].elapsed_time(ev["optimizer"]),
                   "tokens_per_s": RG_BATCH * RG_SEQ / wall,
                   "loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]), "lr": float(met["lr"]),
                   "peak_device_bytes": torch.cuda.max_memory_allocated()}
            check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]),
                  f"{RG_ARCH} step {i + 1}: loss {row['loss']}, grad_norm {row['grad_norm']}")
            rows.append(row)
    finally:
        steps.forward_loss, steps.adamw_update = real_loss, real_update
    moved = sum(int(not torch.equal(a.view(-1)[:4096], b)) for a, b in zip(M.tree_leaves(params), watch))
    check(moved > 0, f"{RG_ARCH}: no parameter moved in {RG_STEPS} steps")
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "params": n_params, "batch": RG_BATCH, "seq": RG_SEQ,
           "activation_dtype": cfg.activation_dtype, "remat": cfg.remat_mode, "flash_remat": cfg.flash_remat,
           "vocab": cfg.vocab, "ce_chunk": cfg.ce_chunk, "window": cfg.groups[0][0][2].window,
           "steps": rows, "leaves_moved": moved, "leaves": len(watch),
           "state_bytes": n_params * 4 * 3, "peak_device_bytes": torch.cuda.max_memory_allocated()}
    del params, opt, batch, watch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def device_memory(torch):
    """The card's memory as this process and ``nvidia-smi`` see it."""
    free, total = torch.cuda.mem_get_info()
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return {"free": free, "total": total, "reserved": torch.cuda.memory_reserved(),
            "allocated": torch.cuda.memory_allocated(), "compute_apps": apps}


def saved_bytes(torch, fn, params=()):
    """``fn()`` under ``saved_tensors_hooks``: (its result, bytes saved for
    backward outside the storage of ``params``, their shapes)."""
    storages = {p.untyped_storage().data_ptr() for p in params}
    total, shapes = [0], []

    def pack(t):
        if t.untyped_storage().data_ptr() not in storages:
            total[0] += t.numel() * t.element_size()
            shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0], shapes


def model_train_backwards(torch, configs, seed):
    """(d): the two rematerialized backwards at recurrentgemma-2b's widths,
    fp32, against the materialized ones on the card: the streaming CE's
    gradients (x, the tied table) against the dense ``log_softmax``'s, and
    ``_flash``'s (q, k, v) against ``attention_plain``'s at its local
    attention shape; each with its bytes saved for backward (parameters
    excluded) and its time (forward + backward, CUDA events)."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    cfg = configs.get_config(RG_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    b, s = CE_TOKENS
    x = randn(b, s, cfg.d_model).requires_grad_(True)
    table = randn(cfg.vocab, cfg.d_model, std=0.02).requires_grad_(True)
    labels = torch.randint(0, cfg.vocab, (b, s), generator=gen, device="cuda", dtype=torch.int32)

    def blocked():
        return L.blocked_cross_entropy(x, labels, table=table, chunk=cfg.ce_chunk, logit_softcap=cfg.logit_softcap)

    def dense():
        logits = L.softcap(torch.matmul(x, table.T), cfg.logit_softcap)
        return -torch.gather(torch.log_softmax(logits, -1), -1, labels.long()[..., None]).mean()

    ce = {"tokens": b * s, "vocab": cfg.vocab, "chunk": cfg.ce_chunk, "chunks": -(-cfg.vocab // cfg.ce_chunk)}
    grads = {}
    for name, fn in (("blocked", blocked), ("dense", dense)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, nbytes, _ = saved_bytes(torch, fn, params=[table])
        grads[name] = torch.autograd.grad(loss, [x, table])
        end.record()
        torch.cuda.synchronize()
        ce[name] = {"loss": float(loss.detach()), "saved_bytes": nbytes, "ms": start.elapsed_time(end),
                    "peak_bytes_over_inputs": torch.cuda.max_memory_allocated() - base}
        del loss
    ce["rel_err"] = {n: rel_err(g, w) for n, g, w in zip(("x", "table"), grads["blocked"], grads["dense"])}
    ce["loss_rel_err"] = abs(ce["blocked"]["loss"] - ce["dense"]["loss"]) / abs(ce["dense"]["loss"])
    for what, err in [*ce["rel_err"].items(), ("loss", ce["loss_rel_err"])]:
        check(err <= BWD_TOL, f"the streaming CE's {what} gradient at {cfg.vocab} vocab: {err:.3g} (> {BWD_TOL})")
    # x, the labels and the online softmax's (m, z): no (B, S, chunk) logits
    ce["saved_bytes_allowed"] = x.numel() * x.element_size() + labels.numel() * labels.element_size() + 2 * b * s * 4
    check(ce["blocked"]["saved_bytes"] <= ce["saved_bytes_allowed"],
          f"the streaming CE saved {ce['blocked']['saved_bytes']} bytes for backward, more than x, the labels "
          f"and (m, z): {ce['saved_bytes_allowed']}")
    out["blocked_cross_entropy"] = ce
    del x, table, labels, grads

    blk = cfg.groups[0][0][2]
    kvh, g, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim_
    bb, ss = RG_BATCH, RG_SEQ
    qkv = [randn(bb, ss, kvh, g, dh).requires_grad_(True), randn(bb, ss, kvh, dh).requires_grad_(True),
           randn(bb, ss, kvh, dh).requires_grad_(True)]
    do = randn(bb, ss, kvh, g, dh)
    pos = torch.arange(ss, dtype=torch.int32, device="cuda")
    qc, kc = min(cfg.q_chunk, ss), min(cfg.k_chunk, ss)
    kw = dict(causal=True, window=blk.window)
    fl = {"shape": [bb, ss, kvh, g, dh], "window": blk.window, "q_chunk": qc, "k_chunk": kc}
    grads = {}
    for name, fn in (("flash_remat", lambda: A._flash(*qkv, pos, pos, q_chunk=qc, k_chunk=kc, remat_kv=True, **kw)),
                     ("plain", lambda: A.attention_plain(*qkv, pos, pos, **kw))):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        o, nbytes, shapes = saved_bytes(torch, fn)
        grads[name] = torch.autograd.grad(o, qkv, do)
        end.record()
        torch.cuda.synchronize()
        fl[name] = {"saved_bytes": nbytes, "ms": start.elapsed_time(end),
                    "score_blocks_saved": sum(1 for sh in shapes if sh[-2:] == (qc, kc))}
        del o
    fl["rel_err"] = {n: rel_err(a, w) for n, a, w in zip("qkv", grads["flash_remat"], grads["plain"])}
    for what, err in fl["rel_err"].items():
        check(err <= BWD_TOL, f"_flash's d{what} at {RG_ARCH}'s attention shape: {err:.3g} (> {BWD_TOL})")
    check(fl["flash_remat"]["score_blocks_saved"] == 0, "_flash with remat_kv saved a score block")
    out["flash"] = fl
    del qkv, do, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_model_train(torch, seed):
    """Phase 12, the training path, with the launch counters from 0: (a)
    all ten archs' reduced configs, one train step on the card against the
    CPU; (b) xlstm-125m uncut through ``launch/train`` with --dedup, a
    checkpoint, and a resume; (c) recurrentgemma-2b uncut, RG_STEPS steps
    split into forward, backward and optimizer; (d) the two rematerialized
    backwards at recurrentgemma's widths.  Only (b)'s dedup may launch a
    kernel: K1 (the join's result-size estimate) and K2's fused pairs step."""
    from repro_torch import configs
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.train import steps

    mods = (distance_tile, dense_tile, flash_attention)
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"phase": "model_train", "card": smi_name_limit(), "device_memory_at_start": device_memory(torch),
           "tolerances": {"card_vs_cpu": MODEL_TOL, "resume": RESUME_TOL, "backward_vs_materialized": BWD_TOL}}
    parts = (("reduced", lambda: model_train_reduced(torch, M, configs, steps, seed)),
             ("xlstm", lambda: model_train_xlstm(torch, M, configs, train)),
             ("full", lambda: model_train_full(torch, M, configs, steps, seed)),
             ("backwards", lambda: model_train_backwards(torch, configs, seed)))
    for name, run in parts:
        t0 = time.perf_counter()
        rec[name] = run()
        rec[f"{name}_s"] = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    launched = {k for k, v in launches.items() if v}
    check(launched <= {"tile_pair_distance", PAIRS[0]} and launches[PAIRS[0]] > 0,
          f"the training path launched {({k: v for k, v in launches.items() if v})}: not the dedup's K1 estimate "
          "and K2 fused pairs step alone")
    rec["launches"] = {k: v for k, v in launches.items() if v}
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return launches


SHARD_ARCH = "recurrentgemma_2b"          # (a): uncut, its params, caches and tokens placed by the rules
SHARD_MESH = (1, 1)                       # ("data", "model") on a one-rank NCCL group: see sharded_serve
SHARD_BATCH, SHARD_PROMPT, SHARD_NEW = 4, 128, 9   # a prefill of 4 prompts, then 8 greedy decode steps
SHARD_TOL = 2.0 ** -8                     # the last logits: one bf16 rounding, max|diff| / max|ref|
CUT = ("--cut-depth", "--seq", "2048")    # one block of each kind, two key chunks: the full cells lower for minutes
DRYRUN_CELLS = (("xlstm_125m", "long_500k", ("--multi-pod",)), ("gemma3_12b", "decode_32k", ("--both-meshes",)),
                # one cell per fault class the DTensor seams had: the experts (deepseek-v2, arctic),
                # strided head shards on both sides (phi3), the recurrent projections and the sLSTM's
                # time loop (xlstm), a train cell (qwen3: a KV head count the model axis does not
                # divide, the CE), and products at batch 1 split over the data axes (recurrentgemma)
                ("deepseek_v2_236b", "decode_32k", ()), ("arctic_480b", "decode_32k", ()),
                ("phi3_mini_3p8b", "prefill_32k", CUT), ("xlstm_125m", "prefill_32k", CUT),
                ("qwen3_32b", "train_4k", CUT), ("recurrentgemma_2b", "long_500k", ("--both-meshes",)))
DRYRUN_MODEL_CELLS = 10                   # gemma3's and recurrentgemma's cells on both meshes
DRYRUN_DEADLINE_S = 300.0                 # for the dry-runs together, from their start
# the reference's FLOPs per chip in each model cell, at the same cut: `python -m repro.launch.dryrun
# --arch A --shape S [--multi-pod]` on the CPU (jax 0.9.0), and for the cut cells its `lower_cell` with
# every layer group repeated once and the shape's sequence set to 2048 (PERF.md §6); each card cell must
# do 0.5-2x of it
REF_FLOPS_PER_CHIP = {
    "xlstm_125m__long_500k__pod2": 5811552.0,
    "gemma3_12b__decode_32k__pod1": 14248050688.0,
    "gemma3_12b__decode_32k__pod2": 7124025344.0,
    "deepseek_v2_236b__decode_32k__pod1": 731738112000.0,
    "arctic_480b__decode_32k__pod1": 969870540800.0,
    "phi3_mini_3p8b__prefill_32k-cut-s2048__pod1": 64449134592.0,
    "xlstm_125m__prefill_32k-cut-s2048__pod1": 13332602880.0,
    "qwen3_32b__train_4k-cut-s2048__pod1": 21126944129024.0,
    "recurrentgemma_2b__long_500k__pod1": 146618880.0,
    "recurrentgemma_2b__long_500k__pod2": 140536320.0,
}
# cells whose useful FLOPs fraction is below 0.5 on this tree, each with its reason (PERF.md §6 names them)
LOW_USEFUL = {
    "deepseek_v2_236b__decode_32k__pod1": "MoE decode: 128 tokens in 32 routing groups fill every expert's "
                                          "minimum capacity of 8 with padding (the reference's 0.139)",
    "arctic_480b__decode_32k__pod1": "MoE decode: the same capacity padding, 128 experts (the reference's 0.033)",
    "xlstm_125m__long_500k__pod2": "batch 1: the tied readout's 768-wide contraction is whole on every data rank, "
                                   "as in the reference, and is 83% of the reference's FLOPs (the reference's 0.069)",
    "recurrentgemma_2b__long_500k__pod1": "batch 1: the tied readout's contraction is whole on every data rank, "
                                          "as in the reference (the reference's 0.159)",
    "recurrentgemma_2b__long_500k__pod2": "batch 1: the same readout on 512 chips (the reference's 0.083)",
}
ROOF_DECODE_ITERS, ROOF_TRAIN_ITERS = 5, 2   # (c): timed calls after one warm-up


def sharded_serve(torch, configs, M, serve, tmp, seed):
    """(a): SHARD_ARCH uncut, served unsharded, then as DTensors on a
    one-rank NCCL ("data", "model") mesh, params, caches and tokens placed by
    ``param_specs`` / ``cache_specs`` / ``batch_spec``; the tokens must be
    equal and the last logits within one bf16 rounding.  On a 1 x 1 mesh
    ``to_placements`` replicates every dim, so this shows that the rules'
    placements and DTensor's dispatch run on CUDA tensors, not that a
    shard or a collective is right: gloo, the only backend that puts
    several ranks on one card, crashes on CUDA tensors (torch 2.11: a
    segfault in the all-gather DTensor issues), and NCCL takes one rank per
    card, so the 2 x 2 mesh's values are held on the CPU
    (``tests/test_torch_sharding.py``, four gloo processes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L
    from repro_torch.sharding import batch_spec, cache_specs, distribute, param_specs
    from repro_torch.train import make_prefill, make_serve_step

    cfg = configs.get_config(SHARD_ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    batch = serve.make_batch(cfg, SHARD_BATCH, SHARD_PROMPT, "cuda", seed)
    gen = serve.generate(cfg, params, batch, SHARD_NEW)
    want_tokens, want_logits = gen.tokens, gen.logits.float()
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "activation_dtype": cfg.activation_dtype,
           "mesh": dict(zip(("data", "model"), SHARD_MESH)), "backend": "nccl", "batch": SHARD_BATCH,
           "prompt": SHARD_PROMPT, "decode_steps": SHARD_NEW - 1, "unsharded_prefill_ms": gen.prefill_s * 1e3,
           "unsharded_decode_ms_per_token": gen.decode_s / (SHARD_NEW - 1) * 1e3}
    del gen
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", SHARD_MESH, mesh_dim_names=("data", "model"))
        sp = distribute(params, param_specs(params, mesh), mesh, src_data_rank=None)
        sb = distribute(batch, batch_spec(batch, mesh), mesh, src_data_rank=None)
        serve_step = make_serve_step(cfg)

        def placed_token(t):
            return distribute(t, batch_spec(t, mesh), mesh)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), implicit_replication():
            logits, caches, memory = make_prefill(cfg, SHARD_PROMPT + SHARD_NEW)(sp, sb)
            caches = distribute(caches, cache_specs(caches, mesh), mesh)
            tok = placed_token(torch.argmax(L.unshard(logits[..., : cfg.vocab], -1), dim=-1).to(torch.int32))
            torch.cuda.synchronize()
            rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            toks = [tok]
            t0 = time.perf_counter()
            for i in range(SHARD_NEW - 1):
                tok, logits, caches = serve_step(sp, caches, tok, SHARD_PROMPT + i, memory=memory)
                tok = placed_token(tok)
                toks.append(tok)
            torch.cuda.synchronize()
            rec["decode_ms_per_token"] = (time.perf_counter() - t0) / (SHARD_NEW - 1) * 1e3
        leaves = M.tree_leaves(sp)
        check(all(hasattr(t, "placements") for t in leaves + M.tree_leaves(caches) + [tok]),
              "a param, cache or token is not a DTensor")
        rec["dtensor_leaves"] = {"params": len(leaves), "caches": len(M.tree_leaves(caches))}
        got_tokens = torch.stack([t.full_tensor() for t in toks], dim=1).cpu().numpy()
        got_logits = logits.full_tensor().float()
    finally:
        dist.destroy_process_group()
    check(got_tokens.shape == want_tokens.shape and bool((got_tokens == want_tokens).all()),
          f"the sharded serve's tokens {got_tokens.tolist()} are not the unsharded {want_tokens.tolist()}")
    err = rel_err(got_logits, want_logits)
    rec["tokens_equal"], rec["logits_err"], rec["logits_tol"] = True, err, SHARD_TOL
    check(err <= SHARD_TOL, f"the sharded serve's last logits are {err:.3g} off the unsharded (tol {SHARD_TOL:.3g})")
    rec["sample"] = got_tokens[0].tolist()
    del params, batch, sp, sb, caches, logits, toks, tok
    gc.collect()
    torch.cuda.empty_cache()
    return rec


TRAIN_SHARD_ARCH = "deepseek_v2_236b"    # (d): full width, its dense layer and one MoE layer, bf16
TRAIN_SHARD_REPEATS = (1, 1)
TRAIN_SHARD_BATCH, TRAIN_SHARD_SEQ = 1, 1024
TRAIN_SHARD_TOL = 2e-2                    # bf16, as the port's train tests hold bf16 steps


def sharded_train(torch, configs, M, serve, tmp, seed):
    """(d): one ``make_train_step`` step of TRAIN_SHARD_ARCH at full width
    (cut in depth to TRAIN_SHARD_REPEATS) on DTensor params, AdamW state and
    batch on the one-rank NCCL mesh of (a), under ``implicit_replication()``,
    against the plain step from the same weights: the loss, grad_norm and
    every updated param, m and v leaf within TRAIN_SHARD_TOL.  Then the
    DTensor state through ``save_checkpoint`` and ``restore_checkpoint(...,
    shardings=)`` onto the mesh, and without ``shardings`` onto plain CUDA
    tensors, bit for bit.  As in (a), every placement is a replica on one
    rank: this checks DTensor autograd, ``_FlashRemat``, the blocked CE,
    remat and the in-place AdamW on CUDA DTensors, not a shard; the shards
    are checked on the CPU's 2 x 2 gloo mesh
    (``tests/test_torch_sharded_train.py``).  The plain step's results wait
    in host memory while the sharded step runs: two copies of the state do
    not fit the card beside a step."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding import batch_spec, distribute, named_shardings, param_specs
    from repro_torch.train import OptHParams, adamw_init, make_train_step, restore_checkpoint, save_checkpoint

    cfg = cut_depth(configs.get_config(TRAIN_SHARD_ARCH), TRAIN_SHARD_REPEATS)
    hp = OptHParams(lr=3e-4, warmup_steps=1)
    step = make_train_step(cfg, hp)
    batch = serve.make_batch(cfg, TRAIN_SHARD_BATCH, TRAIN_SHARD_SEQ, "cuda", seed)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    host0 = M.tree_map(lambda t: t.to("cpu", copy=True), params)
    opt = adamw_init(params, state_dtype=cfg.opt_state_dtype)
    start.record()
    params, opt, metrics = step(params, opt, batch)
    end.record()
    torch.cuda.synchronize()
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "params": sum(t.numel() for t in M.tree_leaves(params)),
           "param_dtype": cfg.param_dtype, "opt_state_dtype": cfg.opt_state_dtype, "batch": TRAIN_SHARD_BATCH,
           "seq": TRAIN_SHARD_SEQ, "mesh": dict(zip(("data", "model"), SHARD_MESH)), "backend": "nccl",
           "plain_step_ms": start.elapsed_time(end), "plain_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "timing": "CUDA events, one step each",
           "note": "one rank: every placement is a replica (DTensor on CUDA tensors, not a shard)"}
    want = {"loss": metrics["loss"].float().cpu(), "grad_norm": metrics["grad_norm"].float().cpu(),
            "state": M.tree_map(lambda t: t.cpu(), {"params": params, "m": opt["m"], "v": opt["v"]})}
    del params, opt, metrics
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp / "train_store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", SHARD_MESH, mesh_dim_names=("data", "model"))
        params = M.tree_map(lambda t: t.to("cuda"), host0)
        del host0
        specs = param_specs(params, mesh, fsdp=True)
        sp = distribute(params, specs, mesh, src_data_rank=None)
        sb = distribute(batch, batch_spec(batch, mesh), mesh, src_data_rank=None)
        del params
        sopt = adamw_init(sp, state_dtype=cfg.opt_state_dtype)
        start.record()
        with implicit_replication():
            sp, sopt, smetrics = step(sp, sopt, sb)
        end.record()
        torch.cuda.synchronize()
        rec["dtensor_step_ms"] = start.elapsed_time(end)
        rec["dtensor_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        got = {"params": sp, "m": sopt["m"], "v": sopt["v"]}
        check(all(hasattr(t, "placements") for t in M.tree_leaves(got)), "a param or moment is not a DTensor")
        rec["loss"] = [float(smetrics["loss"].full_tensor()), float(want["loss"])]
        rec["loss_err"] = rel_err(smetrics["loss"].full_tensor().float().cpu(), want["loss"])
        rec["grad_norm_err"] = rel_err(smetrics["grad_norm"].float().cpu(), want["grad_norm"])
        worst = {}
        for part in ("params", "m", "v"):
            errs = [rel_err32(g.full_tensor(), w.to("cuda"))
                    for g, w in zip(M.tree_leaves(got[part]), M.tree_leaves(want["state"][part]))]
            worst[part] = max(errs)
        rec["leaf_err"], rec["tol"] = worst, TRAIN_SHARD_TOL
        check(rec["loss_err"] <= TRAIN_SHARD_TOL and rec["grad_norm_err"] <= TRAIN_SHARD_TOL
              and max(worst.values()) <= TRAIN_SHARD_TOL,
              f"the DTensor train step is off the plain one: loss {rec['loss_err']:.3g}, grad_norm "
              f"{rec['grad_norm_err']:.3g}, leaves {worst} (tol {TRAIN_SHARD_TOL})")
        del want
        # the sharded state through a checkpoint, onto the mesh and onto plain tensors
        ckpt = tmp / "train_ckpt"
        state = {"params": sp, "opt": sopt}
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt), 1, state)
        rec["save_s"] = time.perf_counter() - t0
        sh = named_shardings(specs, mesh)
        restored = {}
        for how, kw in (("mesh", {"shardings": {"params": sh, "opt": {"m": sh, "v": sh, "step": None}}}),
                        ("plain", {})):
            t0 = time.perf_counter()
            tree, st, _ = restore_checkpoint(str(ckpt), state, device="cuda", **kw)
            rec[f"restore_{how}_s"] = time.perf_counter() - t0
            same = all(torch.equal(a.full_tensor() if hasattr(a, "full_tensor") else a, b.full_tensor())
                       for a, b in zip(M.tree_leaves(tree["params"]) + M.tree_leaves(tree["opt"]["m"])
                                       + M.tree_leaves(tree["opt"]["v"]),
                                       M.tree_leaves(sp) + M.tree_leaves(sopt["m"]) + M.tree_leaves(sopt["v"])))
            dtensors = sum(hasattr(t, "placements") for t in M.tree_leaves(tree["params"]))
            check(st == 1 and same, f"the checkpoint restored onto {how} is not the saved state bit for bit")
            check(dtensors == (len(M.tree_leaves(sp)) if how == "mesh" else 0),
                  f"the checkpoint restored onto {how} holds {dtensors} DTensor params")
            restored[how] = True
            del tree
        rec["restored_bit_for_bit"] = restored
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp / "train_ckpt", ignore_errors=True)
    del sp, sopt, sb, got, state
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def shard_dir():
    """Phase 13's directory under build/, emptied."""
    tmp = ROOT / "build" / "model_shard"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    return tmp


def dryruns(tmp):
    """(b): the dry-runs, each a process of its own on fake tensors (the
    host's cores, no card work): the model cells, and the ring's six cells
    one process each, started together and waited for (killed past
    DRYRUN_DEADLINE_S); prints each cell's terms on a line of its own."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, *flags,
             "--device", "cuda", "--out", str(tmp / "dryrun_torch")] for arch, shape, flags in DRYRUN_CELLS]
    from repro_torch.launch.selfjoin_dryrun import MESHES, VARIANTS

    ring_tags = [(mesh, variant) for mesh in MESHES for variant in VARIANTS]
    cmds += [[sys.executable, "-m", "repro_torch.launch.selfjoin_dryrun", "--device", "cuda", "--mesh", mesh,
              "--variant", variant, "--out", str(tmp / f"selfjoin_ring_torch__{mesh}__{variant}.json")]
             for mesh, variant in ring_tags]
    t_start = time.perf_counter()
    procs = []
    try:
        for i, cmd in enumerate(cmds):
            log = open(tmp / f"dryrun{i}.log", "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)), log))
        for p, _ in procs:
            try:
                p.wait(timeout=max(t_start + DRYRUN_DEADLINE_S - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"the dry-runs passed their {DRYRUN_DEADLINE_S:.0f} s deadline")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    for i, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise SmokeFailure(f"dry-run {i} exited {p.returncode}:\n{(tmp / f'dryrun{i}.log').read_text()[-3000:]}")
    keys = ("mesh", "chips", "flops_per_chip", "hbm_bytes_per_chip", "wire_bytes_per_chip", "compute_s",
            "memory_s", "collective_s", "dominant", "step_time_s", "model_flops", "useful_flops_fraction", "mfu",
            "temp_bytes_per_chip", "arg_bytes_per_chip", "collective_by_type", "lower_s")
    cells = []
    for path in sorted((tmp / "dryrun_torch").glob("*.json")):
        d = json.loads(path.read_text())
        cells.append({"phase": "dryrun_cell", "cell": path.stem, **{k: d.get(k) for k in keys}})
    ring = {}
    for mesh, variant in ring_tags:
        ring.update(json.loads((tmp / f"selfjoin_ring_torch__{mesh}__{variant}.json").read_text()))
    for tag, d in ring.items():
        cells.append({"phase": "dryrun_cell", "cell": f"{d['arch']}__{d['shape']}__{tag}",
                      **{k: d.get(k) for k in keys}})
    models = len(cells) - len(ring)
    check(models == DRYRUN_MODEL_CELLS and len(ring) == 6,
          f"the dry-runs wrote {models} model cells and {len(ring)} ring cells, "
          f"not {DRYRUN_MODEL_CELLS} and 6")
    for cell in cells[:models]:
        cell["flops_over_reference"] = cell["flops_per_chip"] / REF_FLOPS_PER_CHIP[cell["cell"]]
    for cell in cells:
        check(all(math.isfinite(cell[k]) and cell[k] >= 0 for k in ("compute_s", "memory_s", "collective_s")),
              f"{cell['cell']}: a roofline term is not a finite time")
        emit(cell)
    for cell in cells[:models]:
        check(cell["useful_flops_fraction"] >= 0.5 or cell["cell"] in LOW_USEFUL,
              f"{cell['cell']}: useful FLOPs fraction {cell['useful_flops_fraction']:.3f} < 0.5, "
              "and LOW_USEFUL gives no reason")
        check(0.5 <= cell["flops_over_reference"] <= 2.0,
              f"{cell['cell']}: {cell['flops_over_reference']:.3f}x the reference's FLOPs per chip, outside 0.5-2x")
    return {"cells": len(cells), "wall_s": time.perf_counter() - t_start,
            "lower_s": {c["cell"]: c["lower_s"] for c in cells[:models]}}


def roofline_case(torch, count_ops, fn, iters):
    """(ms per call by CUDA events over ``iters`` calls after a warm-up,
    the OpCosts of one more call under ``count_ops``)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    with count_ops() as counter:
        fn()
    torch.cuda.synchronize()
    return ms, counter.costs


def roofline_row(roofline_terms, arch, what, ms, costs, model_flops):
    rep = roofline_terms(arch=arch, shape=what, mesh_desc="1 card", chips=1, costs=costs, model_flops=model_flops)
    bound_ms = max(rep.compute_s, rep.memory_s) * 1e3
    return {"arch": arch, "what": what, "ms": ms, "compute_ms": rep.compute_s * 1e3, "memory_ms": rep.memory_s * 1e3,
            "bound_ms": bound_ms, "ms_over_bound": ms / bound_ms, "dominant": rep.dominant,
            "flops": costs.dot_flops, "flops_fp32": costs.dot_flops_fp32, "hbm_bytes": costs.hbm_bytes, "model_flops": model_flops,
            "temp_bytes": costs.temp_bytes, "hw": rep.hw.name, "timing": "CUDA events"}


def roofline_vs_card(torch, configs, M, serve, seed):
    """(c): gemma3-12b's decode step (phase 11's batch and prompt) and
    recurrentgemma-2b's train step (phase 12's batch and sequence), one rank,
    real tensors: CUDA-event ms beside the counter's compute and memory terms
    on ``H100``."""
    from repro_torch.roofline import count_ops, roofline_terms
    from repro_torch.roofline.analysis import model_flops_decode, model_flops_train
    from repro_torch.train import OptHParams, adamw_init, make_serve_step, make_train_step

    rows = []
    cfg = configs.get_config(SERVE_ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    batch = serve.make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, "cuda", seed)
    with torch.no_grad():
        logits, caches, memory = M.prefill(params, batch, cfg, SERVE_PROMPT + SERVE_NEW)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        step = make_serve_step(cfg)
        ms, costs = roofline_case(torch, count_ops, lambda: step(params, caches, tok, SERVE_PROMPT, memory=memory),
                                  ROOF_DECODE_ITERS)
    rows.append(roofline_row(roofline_terms, cfg.name, f"decode step, batch {SERVE_BATCH}, context {SERVE_PROMPT}",
                             ms, costs, model_flops_decode(cfg, SERVE_BATCH, SERVE_PROMPT)))
    del params, batch, logits, caches, memory, tok
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(RG_ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    opt = adamw_init(params, cfg.opt_state_dtype)
    batch = serve.make_batch(cfg, RG_BATCH, RG_SEQ, "cuda", seed)
    train_step = make_train_step(cfg, OptHParams(lr=3e-4, warmup_steps=1, total_steps=RG_STEPS))
    ms, costs = roofline_case(torch, count_ops, lambda: train_step(params, opt, batch), ROOF_TRAIN_ITERS)
    rows.append(roofline_row(roofline_terms, cfg.name, f"train step, {RG_BATCH} x {RG_SEQ}", ms, costs,
                             model_flops_train(cfg, RG_BATCH, RG_SEQ)))
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_model_shard(torch, seed):
    """Phase 13, with the launch counters from 0: (b) the dry-runs, run
    together as processes on the host's cores, waited for and their cells
    printed one per line; (c) the roofline against the card; (a) the
    sharding rules on the card (SHARD_ARCH as DTensors against the
    unsharded serve); (d) a DTensor train step at full width against the
    plain one, and its state through a checkpoint.  No kernel may launch:
    the models call none."""
    from repro_torch import configs
    from repro_torch.kernels import dense_tile, distance_tile, flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    mods = (distance_tile, dense_tile, flash_attention)
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = shard_dir()
    rec = {"phase": "model_shard", "card": smi_name_limit()}
    # the dry-runs first: (c) then times host-bound steps on quiet cores
    rec["dryrun"] = dryruns(tmp)
    t0 = time.perf_counter()
    rec["roofline"] = roofline_vs_card(torch, configs, M, serve, seed)
    rec["roofline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["sharded_serve"] = sharded_serve(torch, configs, M, serve, tmp, seed)
    rec["sharded_serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec["sharded_train"] = sharded_train(torch, configs, M, serve, tmp, seed)
    rec["sharded_train_s"] = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    check(not any(launches.values()), f"phase 13 launched {({k: v for k, v in launches.items() if v})}")
    rec["phase_s"] = time.perf_counter() - t_phase
    emit(rec)
    return launches


def ranges_on(events, names, device_type):
    """The profiler ranges named in ``names`` on one side: with CUDA activity
    the profiler mirrors each host range (CPU) on the device timeline
    (CUDA), spanning the kernels launched inside it."""
    return [e for e in events if e.name in names and e.device_type == device_type]


def kernels_within(events, name):
    """Device records (kernels, copies, fills) that run inside the
    device-side mirrors of the ranges ``name``, and the number of mirrors."""
    import bisect

    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in ranges_on(events, (name,), DeviceType.CUDA))
    starts = [a for a, _ in spans]
    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name == name:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.end <= spans[i][1]:
            out.append(e.name)
    return out, len(spans)


def phase_bridge(torch, engine):
    """Phase 10's profiler part, run before the main path (every profiler
    session does).  (f) CoocTexture's indexed ``count()`` under
    torch.profiler (CPU and CUDA) inside ``obs.capture(torch_bridge=True)``:
    the profiler must hold one host-side ``engine.count`` range and one
    ``engine.count.chunk`` range per chunk, and the device records inside
    the chunk ranges' device-side mirrors must all be K1's fused count
    kernel (the profiler drops records on this machine, PERF.md §7: at most
    one per chunk, at least one); with ``torch_bridge=False`` no obs range
    may appear.  Then K2 per pair's device time on a middle slice of the plan
    at the host loop's mask chunk (``ops.tile_mask``'s pairs per launch)."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels import distance_tile, ops

    names = ("engine.count", "engine.count.chunk")
    out = {}
    for bridge in (True, False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with obs.capture(torch_bridge=bridge) as cap:
                res = engine.count()
            torch.cuda.synchronize()
        events = prof.events()
        ranges = dict(collections.Counter(e.name for e in ranges_on(events, names, DeviceType.CPU)))
        if not bridge:
            check(not ranges, f"torch_bridge=False left obs ranges in the profile: {dict(ranges)}")
            out["ranges_without_bridge"] = 0
            continue
        chunks = res.stats.num_chunks
        check(ranges == {"engine.count": 1, "engine.count.chunk": chunks} == {
            "engine.count": cap.span_count("engine.count"), "engine.count.chunk": cap.span_count(cat="dispatch")},
            f"the profiler holds {ranges} for {chunks} chunks")
        kernels, mirrors = kernels_within(events, "engine.count.chunk")
        check(0 < len(kernels) <= chunks and mirrors <= chunks and all(K1_KERNEL in k for k in kernels),
              f"device records inside {mirrors} chunk ranges: {dict(collections.Counter(kernels))} "
              f"for {chunks} chunks")
        out.update(chunks=chunks, chunk_ranges=ranges["engine.count.chunk"], device_ranges=mirrors,
                   kernel_records=len(kernels), kernels=sorted(set(kernels)))

    snap, cfg = engine.snapshot, engine.config
    size, plan = chunk_default(ops.tile_mask), snap.plan
    mid = max(0, min(plan.num_pairs - size, plan.num_pairs // 2))
    pa = torch.from_numpy(plan.pair_a[mid:mid + size].copy()).cuda()
    pb = torch.from_numpy(plan.pair_b[mid:mid + size].copy()).cuda()
    ms, records = device_ms(torch, lambda: distance_tile.tile_pair_distance(
        snap.tiles, snap.tile_len, pa, pb, eps=cfg.eps, dim_block=cfg.dim_block, return_mask=True,
        num_dims=snap.num_dims), kernel=K1_KERNEL)
    return {"bridge": out, "mask_chunk": {"pairs": size, "ms": ms, "records": records,
                                          "timing": "torch.profiler device time per launch of 20"}}


def smi_name_limit():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def profile_window(torch, device, window, step, span, kernel, label):
    """A window of chunks run as the engine runs them (one bound step, one
    ``span`` per chunk), timed by the host clock and by CUDA events, then
    under torch.profiler (up to PROFILER_TRIES sessions, until one keeps a
    record).  Fails unless ``kernel`` (a device kernel name) is
    the only thing that ran on the card: no ``cumsum``, ``searchsorted``,
    ``index_copy_``, ``index_add_`` or mask kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        with torch.cuda.device(device):
            for pa, pb, real in window:
                with obs.span(span, "dispatch"):
                    step(pa, pb, real)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    start.record()
    run()
    end.record()
    wall_ms = (time.perf_counter() - t0) * 1e3 / len(window)
    torch.cuda.synchronize()
    events_ms = start.elapsed_time(end) / len(window)
    for _ in range(PROFILER_TRIES):  # a session that kept no device record runs again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
        by_name, records = {}, 0
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total", None)
            if us is None:
                us = evt.cuda_time_total
            if us > 0:
                key = evt.key[:80]
                by_name[key] = by_name.get(key, 0.0) + us / len(window) / 1e3
                if kernel in evt.key:
                    records += evt.count
        if by_name:
            break
    check(by_name, f"torch.profiler recorded no device time in the {label} window in {PROFILER_TRIES} sessions")
    check(all(kernel in k for k in by_name), f"the {label} step launched other kernels: {sorted(by_name)}")
    device = sum(by_name.values())
    return {
        "chunks": len(window), "wall_ms_per_chunk": wall_ms, "events_ms_per_chunk": events_ms,
        "device_ms_per_chunk": device, "device_busy_share": device / wall_ms if wall_ms else None,
        "kernel_records": records, "kernels_ms_per_chunk": by_name, "smi": smi_sample(),
    }


def phase_profile(torch, engine, dense_engine, cooc_engine, n_chunks=400):
    """Where a chunk's time goes on the main path: a window of Syn16D2M
    count chunks (K1's fused kernel only), of CoocTexture's dense count
    chunks and of its dense pairs chunks (K3 / K4's fused kernel only: one
    launch per count chunk, two per pairs chunk), and of CoocTexture's
    indexed pairs chunks (K2's fused kernel only, two launches per chunk),
    each run as the engine runs it (``profile_window``).  In the pairs
    windows every hit lands (hit_cap is the most a chunk can hold, as
    after the engine's retry); the window's first run lands below cap, the
    later ones in the padding."""
    from repro_torch.core.engine import count_step, pairs_step
    from repro_torch.kernels import ops

    def middle(chunks):
        return chunks[max(0, len(chunks) // 2 - n_chunks // 2):][:n_chunks]

    snap, cfg, eng = engine.snapshot, engine.config, engine.engine
    counts = torch.zeros(snap.num_points + 1, dtype=torch.int32, device="cuda")
    skipped = torch.zeros((), dtype=torch.int32, device="cuda")
    step = count_step(counts, skipped, snap.tiles, snap.tile_len, snap.tile_start, cfg.eps,
                      dim_block=cfg.dim_block, shortc=cfg.shortc,
                      backend=ops.backend_name("indexed", cfg.use_pallas), num_dims=snap.num_dims)
    rec = {"phase": "profile", "syn16d2m_count": profile_window(
        torch, snap.device, middle(snap.chunks(eng.count_chunk)), step, "engine.count.chunk", K1_KERNEL,
        "Syn16D2M count")}

    snap, cfg, eng = dense_engine.snapshot, dense_engine.config, dense_engine.engine
    dt = snap.dense_tables()
    counts = torch.zeros(snap.num_points + 1, dtype=torch.int32, device="cuda")
    step = count_step(counts, skipped, dt.tiles, dt.tile_len, dt.tile_start, cfg.eps, dim_block=cfg.dim_block,
                      shortc=False, backend="dense", num_dims=snap.num_dims)
    rec["cooc_dense_count"] = profile_window(torch, snap.device, middle(dt.chunks(eng.count_chunk)), step,
                                             "engine.count.chunk", DENSE_KERNEL, "CoocTexture dense count")
    # every chunk's hits land (hit_cap = the most a chunk can hold); the
    # window's first run lands below cap, the later ones in the padding
    t = dt.tiles.shape[1]
    hit_cap = eng.pairs_chunk * t * t
    buf = torch.zeros((snap.num_points * 600 + hit_cap, 2), dtype=torch.int32, device="cuda")
    offset = torch.zeros((), dtype=torch.int32, device="cuda")
    max_hits = torch.zeros((), dtype=torch.int32, device="cuda")
    step = pairs_step(buf, offset, max_hits, dt.tiles, dt.tile_len, dt.tile_start, snap.point_order, cfg.eps,
                      hit_cap=hit_cap, dim_block=cfg.dim_block, backend="dense", chunk=eng.pairs_chunk,
                      num_dims=snap.num_dims)
    window = middle(dt.chunks(eng.pairs_chunk))
    rec["cooc_dense_pairs"] = profile_window(torch, snap.device, window, step, "engine.pairs.chunk", DENSE_KERNEL,
                                             "CoocTexture dense pairs")
    rec["cooc_dense_pairs"]["hits_per_chunk"] = int(offset) / (3 * len(window))
    del buf

    snap, cfg, eng = cooc_engine.snapshot, cooc_engine.config, cooc_engine.engine
    t = snap.tiles.shape[1]
    hit_cap = eng.pairs_chunk * t * t
    buf = torch.zeros((snap.num_points * 700 + hit_cap, 2), dtype=torch.int32, device="cuda")
    offset.zero_()
    max_hits.zero_()
    step = pairs_step(buf, offset, max_hits, snap.tiles, snap.tile_len, snap.tile_start, snap.point_order, cfg.eps,
                      hit_cap=hit_cap, dim_block=cfg.dim_block, backend=ops.backend_name("indexed", cfg.use_pallas),
                      chunk=eng.pairs_chunk, num_dims=snap.num_dims)
    window = middle(snap.chunks(eng.pairs_chunk))
    rec["cooc_indexed_pairs"] = profile_window(torch, snap.device, window, step, "engine.pairs.chunk", K1_KERNEL,
                                               "CoocTexture indexed pairs")
    rec["cooc_indexed_pairs"]["hits_per_chunk"] = int(offset) / (3 * len(window))
    del buf
    emit(rec)
    return rec


def main() -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA card, end to end.")
    parser.add_argument("--seed", type=int, default=0, help="seed of the serving phase's queries and churn")
    parser.add_argument("--fused-rank", type=int, default=None,
                        help="run one rank of phase 9's gloo ring (the script starts these itself)")
    parser.add_argument("--fused-dir", type=Path, default=None, help="phase 9's exchange directory")
    parser.add_argument("--model-serve-only", action="store_true",
                        help="run phase 11 (the model serving path) alone, and print no kernels line")
    parser.add_argument("--model-train-only", action="store_true",
                        help="run phase 12 (the training path) alone, and print no kernels line")
    parser.add_argument("--model-shard-only", action="store_true",
                        help="run phase 13 (sharding, dry-runs, roofline) alone, and print no kernels line")

    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import SelfJoinConfig, SelfJoinEngine
        from repro_torch.data import paper_dataset
        from repro_torch.kernels import _build, dense_tile, distance_tile, flash_attention
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the exactness contract needs IEEE fp32
    torch.backends.cudnn.allow_tf32 = False
    if args.fused_rank is not None:
        return fused_rank_main(args.fused_rank, args.fused_dir)
    if args.model_serve_only:
        phase_model_serve(torch, args.seed)
        return 0
    if args.model_train_only:
        print(smi_name_limit(), flush=True)
        phase_model_train(torch, args.seed)
        return 0
    if args.model_shard_only:
        print(smi_name_limit(), flush=True)
        phase_model_shard(torch, args.seed)
        return 0

    t_start = time.perf_counter()
    phase_device(torch, _build)
    fns = kernel_fns()
    emit({"phase": "kernels_sweep", **phase_sweep(torch, np, fns)})
    phase_k1_sweep(torch, np)
    phase_k2_sweep(torch, np)
    phase_dense_sweep(torch, np)
    phase_attention_sweep(torch, np, flash_attention)

    # main-path inputs: build the phase-3 and phase-4 engines (host plans)
    syn = paper_dataset("Syn16D2M", SYN_N / 2_000_000)
    syn_cfg = SelfJoinConfig(eps=SYN_EPS)
    t0 = time.perf_counter()
    syn_engine = SelfJoinEngine(syn, syn_cfg)
    syn_host_s = time.perf_counter() - t0
    cooc = paper_dataset("CoocTexture", 1.0)
    cooc_cfg = SelfJoinConfig(eps=COOC_EPS)
    cooc_engine = SelfJoinEngine(cooc, cooc_cfg)
    t0 = time.perf_counter()
    dense_engine = SelfJoinEngine(cooc, dataclasses.replace(cooc_cfg, execution="dense"))
    cooc_dense = dense_engine.snapshot.dense_tables()
    for size in (dense_engine.engine.count_chunk, dense_engine.engine.pairs_chunk):
        cooc_dense.chunks(size)
    dense_host_s = time.perf_counter() - t0
    emit({"phase": "plans", "syn16d2m_host_plan_s": syn_host_s,
          "syn16d2m_tile_pairs": syn_engine.plan.num_pairs,
          "cooc_tile_pairs": cooc_engine.plan.num_pairs, "cooc_dense_host_plan_s": dense_host_s,
          "cooc_dense_tile_pairs": cooc_dense.plan.num_pairs})

    def chunk_of(snap_tables, plan, size, d):
        mid = max(0, min(plan.num_pairs - size, plan.num_pairs // 2))
        pa = torch.from_numpy(plan.pair_a[mid:mid + size].copy()).cuda()
        pb = torch.from_numpy(plan.pair_b[mid:mid + size].copy()).cuda()
        return snap_tables.tiles, snap_tables.tile_len, pa, pb, int(d.shape[1])

    syn_snap = syn_engine.snapshot
    cooc_snap = cooc_engine.snapshot
    db = syn_cfg.dim_block
    eng_cfg = syn_engine.engine
    inputs = {
        "tile_pair_distance": (*chunk_of(syn_snap, syn_snap.plan, eng_cfg.count_chunk, syn), SYN_EPS, db,
                               "Syn16D2M indexed chunk"),
        "tile_pair_distance_mask": (*chunk_of(cooc_snap, cooc_snap.plan, eng_cfg.pairs_chunk, cooc), COOC_EPS, db,
                                    "CoocTexture indexed chunk"),
        "dense_tile_distance": (*chunk_of(cooc_dense, cooc_dense.plan, eng_cfg.count_chunk, cooc), COOC_EPS, db,
                                "CoocTexture dense chunk"),
        "dense_tile_distance_mask": (*chunk_of(cooc_dense, cooc_dense.plan, eng_cfg.pairs_chunk, cooc), COOC_EPS, db,
                                     "CoocTexture dense chunk"),
    }
    real = phase_real_width(torch, np, fns, inputs)
    syn_tiles, syn_lens, syn_pa, syn_pb, syn_n = chunk_of(syn_snap, syn_snap.plan, eng_cfg.count_chunk, syn)
    fused = phase_fused_step(torch, syn_tiles, syn_lens, syn_snap.tile_start, syn_snap.num_points,
                             syn_pa, syn_pb, syn_n, SYN_EPS, db, syn_cfg.shortc, "Syn16D2M indexed chunk")
    indexed_pairs = phase_indexed_pairs_step(
        torch, (cooc_snap.tiles, cooc_snap.tile_len, cooc_snap.tile_start), cooc_snap.point_order,
        *inputs["tile_pair_distance_mask"][2:4], int(cooc.shape[1]), COOC_EPS, db, "CoocTexture indexed chunk")
    steps = phase_dense_steps(
        torch, (cooc_dense.tiles, cooc_dense.tile_len, cooc_dense.tile_start), cooc_snap.point_order,
        cooc_snap.num_points, inputs["dense_tile_distance"][2:4], inputs["dense_tile_distance_mask"][2:4],
        int(cooc.shape[1]), COOC_EPS, db, "CoocTexture dense chunk")
    attn = phase_attention(torch, np, flash_attention)
    # every profiler session runs before the main path: after phase 4 one kept no record
    phase_profile(torch, syn_engine, dense_engine, cooc_engine)
    profiled = phase_bridge(torch, cooc_engine)

    # the main path: counters from 0, phases 3 and 4, counters read after
    for mod in (distance_tile, dense_tile):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    count, syn_counts = phase_count(torch, np, syn_engine, syn, syn_host_s)
    after_count = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    check(after_count == {k: count["chunks"] if k == SCATTER[0] else 0 for k in after_count},
          f"phase 3 ran {count['chunks']} chunks and launched {after_count}: not the fused K1 once per chunk")
    _, cooc_counts, cooc_pairs = phase_pairs(torch, np, cooc_engine, cooc, dense_engine, dense_host_s)
    phase_wide_dense(torch, np, SelfJoinConfig, SelfJoinEngine, paper_dataset)
    launches = {**distance_tile.LAUNCHES, **dense_tile.LAUNCHES}
    emit({"phase": "launches", "phase_3": after_count, "phases_3_4": launches})
    for name in ("tile_pair_distance_tile_eval", "dense_tile_distance_tile_eval", "tile_pair_distance_mask",
                 "dense_tile_distance_mask"):
        # the earlier kernels, and K2 / K4 per pair: the pairs steps run epilogue (c) instead
        check(launches[name] == 0, f"the main path launched {name}")
    for name, n in launches.items():
        check(n > 0 or name.endswith(("_tile_eval", "_mask")), f"{name} was never launched on the main path")
    # the serving path: its own counters, from 0 (phase 3-4's line stays as read above)
    serving = phase_serving(torch, np, syn_engine, syn, syn_counts, cooc_engine, dense_engine, args.seed)
    # the distributed tier: its own counters, from 0
    # phases 8-9: Syn16D2M cut to its first DIST_SYN_N points
    distributed, held = phase_distributed(torch, np, syn[:DIST_SYN_N], cooc, cooc_counts, cooc_pairs, args.seed)
    for name in (SCATTER[0], PAIRS[0], "dense_count_scatter"):
        check(distributed[name] > 0, f"{name} was never launched on the distributed path")
    # the fused ring: its own counters, from 0, its ranks' summed
    fused_ring = phase_fused(torch, np, syn[:DIST_SYN_N], cooc, cooc_counts, held, args.seed)
    del held
    check({k for k, v in fused_ring.items() if v} == {SCATTER[0], PAIRS[0], "tile_pair_distance"},
          f"the fused ring launched {({k: v for k, v in fused_ring.items() if v})}: not K1's fused count step, "
          "K2's fused pairs step and the sample's K1 per pair alone")
    # the downstream and legacy paths: their own counters, from 0
    downstream = phase_downstream(torch, np, cooc, cooc_engine, cooc_counts, cooc_pairs, profiled, args.seed)
    check({k for k, v in downstream.items() if v} == {"tile_pair_distance", "tile_pair_distance_mask", SCATTER[0],
                                                      PAIRS[0]},
          f"the downstream phase launched {({k: v for k, v in downstream.items() if v})}: not K1 / K2 per pair "
          "and their fused steps alone")

    # the model serving path: its own counters, from 0, after what the
    # join's phases hold is freed (the full-width model's weights take 47 GB)
    del syn_engine, cooc_engine, dense_engine, syn, cooc, syn_counts, cooc_counts, cooc_pairs, inputs
    del syn_snap, cooc_snap, cooc_dense, syn_tiles, syn_lens, syn_pa, syn_pb
    gc.collect()
    torch.cuda.empty_cache()
    model_serve = phase_model_serve(torch, args.seed)
    # the training path: its own counters, from 0
    model_train = phase_model_train(torch, args.seed)
    # the sharding rules, the dry-runs and the roofline: their own counters, from 0
    model_shard = phase_model_shard(torch, args.seed)

    rows = [
        {"name": name, "route": "cuda", "source": KERNELS[name][1], "replaces": KERNELS[name][2],
         "launches": launches[name], "max_abs_err": real[name]["max_abs_err"],
         "ms": real[name]["ms"], "plain_ms": real[name]["plain_ms"],
         "bound_ms": real[name]["bound_ms"], "bound_by": real[name]["bound_by"],
         "library_ms": real[name]["library_ms"], "timing": "torch.profiler",
         "serving_launches": serving[name], "distributed_launches": distributed[name],
         "fused_ring_launches": fused_ring[name], "downstream_launches": downstream[name],
         **({"earlier_ms": real[name]["earlier_ms"], "earlier": real[name]["earlier"]}
            if "earlier_ms" in real[name] else {})}
        for name in ("tile_pair_distance", "tile_pair_distance_mask", "dense_tile_distance")
    ]
    rows[1]["host_loop_chunk_ms"] = profiled["mask_chunk"]["ms"]  # K2 per pair at ops.tile_mask's 512 pairs
    # K2 per pair runs on the host loop's pairs (phase 10) only; on the main
    # path its fused pairs step (epilogue (c)) runs instead
    for at, (name, source, replaces), r in ((1, SCATTER, fused), (3, PAIRS, indexed_pairs)):
        rows.insert(at, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "earlier_ms": r["earlier_ms"],
            "earlier": r["earlier"], "timing": "torch.profiler", "serving_launches": serving[name],
            "distributed_launches": distributed[name], "fused_ring_launches": fused_ring[name],
            "downstream_launches": downstream[name],
        })
    for name, (source, replaces) in DENSE_STEPS.items():
        s = steps[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"], "earlier_ms": s["earlier_ms"],
            "earlier": s["earlier"], "timing": "torch.profiler", "serving_launches": serving[name],
            "distributed_launches": distributed[name], "fused_ring_launches": fused_ring[name],
            "downstream_launches": downstream[name],
        })
    rows.append(attention_row(attn, serving, distributed, fused_ring, downstream))
    for row in rows:
        row["model_serve_launches"] = model_serve[row["name"]]   # phase 11 checks it is 0
        row["model_train_launches"] = model_train[row["name"]]   # phase 12: the dedup's K1 and K2 steps only
        row["model_shard_launches"] = model_shard[row["name"]]   # phase 13 checks it is 0
    emit({"kernels": rows, "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
