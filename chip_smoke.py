#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:
  1. the card: name and power limit (nvidia-smi), torch/CUDA versions, the
     TF32 flags (then both set to False);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     sm_90a) and print the build seconds and ptxas resource lines; then
     the ptxas lines of the ten bodies redesigned for Hopper, with counts
     of their tensor-core instructions in the library's SASS (cuobjdump):
     the flash bf16, assign_fused bf16, kernel_matrix bf16 tile and
     embed_assign bf16 bodies must issue wgmma (HGMMA); the embed_assign
     f32 body and every epilogue instantiation of the embed_assign bf16
     body (RFF and the four Mercer kinds) must fit two CTAs per SM (<= 128
     registers, no spills); the 3xTF32 bodies of assign_fused f32,
     flash_attention f32 and the kernel_matrix f32 tile, the contractions
     of assign_fused bf16 and embed_assign bf16 and sketch_assign's must
     issue mma.sync TF32 (HMMA.1688.F32.TF32); none of those nor the
     kernel_matrix column body may spill;
  3. hold each wrapper the main path calls (``ops.kernel_matrix``,
     ``ops.assign_fused``, ``ops.gram_matvec``, ``ops.embed_assign`` for
     RFF / Nystrom and for the count sketch) against its plain PyTorch
     version on the card, at the main path's shapes with the path's gamma
     and a gamma that spreads the rbf values over (0, 1), and at small
     shapes for every epilogue kind, at f32 and bf16; time kernel, plain
     version, a composite of PyTorch calls (``library_ms``, never called by
     the port) and the bound. The main shapes: the paper's Tab.1 MNIST
     setting (15,000-row batches of 784 features, C = 10, rbf; and the
     g stats' ``ops.gram_matvec`` over the 3,000 landmarks), the skinny
     ``ops.kernel_matrix`` calls of k-means++ and Eq.8 / predict in every
     run (``kernel_ab.SKINNY``: [15,000 | 10,000, 1 | 4 | 10] x 784,
     [60,000, 1 | 4] x 320, [47,000, 1 | 5] x 128; the column body, with
     x @ y.T plus the epilogue and the norms as ``library_ms``), the Fig.5
     embedded sweep at its largest m (60,000 x 784 -> 320, C = 10; RFF at
     f32 also at the sweep's m = 20, 80 and 160) and the
     Tab.2 RCV1 sketch (188,000 x 256 -> 128, C = 50); both embedded
     kernels are timed on the f32 rows the runs pass (the wrapper's cast
     to bf16 included) and, the sketch at both dtypes and embed_assign at
     bf16, as ``kernel_ms`` on rows already in the tile dtype; then
     ``ops.flash_attention`` against ``ref.flash_attention_ref`` at bf16 and
     f32 at the attention shapes of OLMo-1B's prefill (B 1, H = KH = 16,
     S 2048, dh 128, causal), gemma2-2b's global layers (H 8, KH 4, dh 256,
     softcap 50), qwen3-32b (H 64, KH 8, dh 128) and qwen3-moe-235b-a22b
     (H 64, KH 4, dh 128; run F-moe's prefill), timed, with
     ``scaled_dot_product_attention`` as ``library_ms`` (a composite of
     matmul, tanh, masked softmax and matmul for the softcap shape), and at
     ragged and small shapes (S 1, 100, 1000; dh 16 and 64; non-causal
     Sk 256); on the OLMo shape the plain output must differ from uniform
     attention (the running mean of v) by more than 10x the bf16 limit;
     and the shapes of the landmark selectors and of serving: RLS's pilot
     Gram at Fig.5's [60000, 320] x 784 rbf (tile body), and at every
     bucket M in (1, 8, 64, 512) ``ops.predict_assign`` on frozen
     artifacts (``serving.freeze_map``: embed_assign rff and Nystrom rbf
     784 -> 320, C = 10, sketch_assign 256 -> 128, C = 50, f32 and bf16)
     and the exact kind's ``ops.kernel_matrix`` column body at [M, 10] x
     784, each against its plain version with the bucket's last quarter
     filled with rows of 1e6 that must change no real label, timed;
  4. drive the exact mini-batch fit through ``fit_dataset``: run A (B=4,
     s=1, fused, f32) and its repeat (the first fit of phase 4 pays the
     process's one-time costs), run B (B=4, s=0.2, fused and materialize, f32) and
     run C (as B fused, bf16); the embedded fits D-rff, D-nystrom (Fig.5,
     B=1, m=320, f32) and D-rff-bf16, each labelling the test rows with
     ``FitResult.predict`` and the 60,000 training rows with
     ``predict_embedded``; E-sketch, its repeat (which must match it
     bitwise) and E-sketch-bf16 (Tab.2's count sketch on the dense 256-d
     RCV1 view, B=4, m=128, C=50, linear); A-rls (as B fused with
     ``selector="rls"``), D-nystrom-rls and D-nystrom-kpp (D-nystrom with
     those selectors), each at test NMI >= 0.9; the launch counters are
     zeroed before each run and read after it, and each run prints how
     many of its kernel_matrix launches took the column body (in runs A-C
     every k-means++ and Eq.8 / predict launch must; only materialize's
     Gram builds and RLS's two Grams a batch take the tile body);
     ``FitResult.predict`` labels through the serving ladder of 512-row
     buckets, and each run prints its fit and labelling seconds apart; then small fits on the card against the same fits on the
     CPU; then run G, assignment serving: the A fit (exact), D-rff,
     D-nystrom and E-sketch frozen at f32 and D-rff-bf16 at bf16, each
     served by an ``AssignService`` (one captured CUDA graph per bucket, 4
     each) on its test rows as a seeded ragged mix of requests of 1-700
     rows, labels bitwise equal to ``FitResult.predict``'s eager launches
     of the same buckets (the bf16 artifact: to the offline bucketed
     predict at bf16); then ``launch/serve_bench.py``'s open loop on the
     D-rff service (200 requests of 1 and of 64 rows at 100 and 500
     offered requests/s, the reference benchmark's rates; the eager
     offline predict in the same loop beside it), p50/p99 ms and rows/s
     printed with the card's name and power limit; then sparse rows and
     ingestion (phase 4c): E-csr, Tab.2's sparse grid at full size
     (``make_rcv1_sparse`` of 188,000 + 5,844 documents over a 47,236-term
     vocabulary, kept in CSR; count sketch m = 256, C = 50, linear, B = 4,
     16 and 64 through ``fit_dataset`` on the CSR rows, test rows labelled
     by ``FitResult.predict`` on CSR; B = 4 twice, bitwise equal), with
     the O(nnz) sketch of 4,096 test rows against the dense map on the
     densified rows (z within 1e-5 normwise) and the dense predict, which
     launches sketch_assign at the full vocabulary, against the CSR
     labels outside near-ties; E-csr-stream, the training rows as Tab.2's
     ragged chunk stream (3B cuts of
     default_rng(7)) through ``BatchSource.from_stream(prefetch=2)`` with
     the pinned stage, block sampling, B = 4, bitwise equal to the
     offline block split, and resumed after batch 2 by ``skip(2)`` with
     ``state=`` and ``fmap=``, bitwise equal again; H-stream, Tab.1's
     training rows as a ragged dense chunk stream into the exact fused
     fit (B = 4, s = 0.2, block), bitwise equal to ``fit_dataset``'s block
     split, with the consumer's seconds waiting on the loader; G-E-csr,
     E-csr's B = 4 fit frozen and served a ragged mix of 1-700-row CSR
     requests (bitwise equal to ``predict_frozen``; garbage in padded rows
     and slack slots changes no real label) and CSR requests to D-rff's
     artifact (equal to the same rows sent dense); then the mesh (phase
     4d), a world of one over NCCL (``init_process_group`` on a FileStore,
     a (1, 1) (data, model) DeviceMesh; its collectives counted by a
     wrapper around ``torch.distributed.all_gather_into_tensor`` and
     ``all_reduce``): M-B (run B-fused through
     ``DistributedMiniBatchKMeans``: test accuracy and NMI within 0.02 of
     B-fused's, one all_gather and one all_reduce a sync), M-inner (batch
     0's ``distributed_kkmeans_fit`` against the single-host
     ``kkmeans_fit``, labels equal outside near-ties), M-B-sstep
     (``s_step = 2``: M-B's labels outside near-ties, at most half of M-B's
     syncs + 2 a batch), M-D-rff (``DistributedEmbedKMeans`` with D-rff's
     map: test labels agree on >= 99.5%, one all_reduce a Lloyd sweep),
     M-E-csr-stream (E-csr-stream's rows and map through
     ``DistributedEmbedKMeans.source``: its labels outside near-ties; the
     dense predict of the test rows at the full 47,236 columns launches
     sketch_assign and labels as the CSR rows; sketch_assign held against
     its plain version and timed at that width, f32 and bf16), M-E-serve
     (that fit frozen, dense requests served by one graph a bucket) and
     M-elastic (M-B failed after batch 2, resumed by
     ``ElasticClusteringRunner`` from ``CheckpointManager``: bitwise M-B's
     state); then the flight recorder (phase 4e, ``repro_torch.obs``, in
     the same world): B-fused with a ``JsonlRecorder`` off, on, on, off
     (labels, medoids and launches equal; the fit wall's overhead), the
     hooks of one batch and of one request timed alone, a span's cost,
     D-rff (labels equal run D-rff's), M-B (each batch's recorded
     ``collectives/*`` equal the wrapper's count of its inner fit),
     E-csr-stream and H-stream with ``prefetch=2`` (equal to the
     unrecorded fits; summed stage and starve seconds), serve_bench on
     D-rff's artifact with and without a recorder (the same graphs; p50s
     and the queue / compute split) and ``launch.cluster`` at Tab.1's
     size (60,000 x 784 blobs, C = 10, B = 4, s = 0.2, fused) with
     ``--obs`` and ``--profile`` (the trace must name
     ``obs:engine_stats[fused]`` and the assign kernel); each fit prints
     its watermarks against the planner's bytes; then the program audit
     (phase 4f, ``launch.audit`` in the same world): its 26 reports at
     the reference's defaults, the five kernels' f32-accumulation probes
     at both tile dtypes among them, and the engine modes at Tab.1's batch
     width (15,000 x 784, |L| = 3,000, C = 10) beside
     ``engine_footprint_bytes``, fused and tiled below the [rows, |L|]
     Gram block in allocator peak and largest intermediate; then LM
     serving of OLMo-1B at full width
     (16 layers, d_model 2048, vocab 50,304; bf16 weights from a
     torch.Generator of seed 0) through ``get_model`` and ``ServingEngine``
     (8 slots, max_len 4096, 32 greedy tokens, 16 requests of 256-2048
     prompt tokens): run F with ``attn_impl="flash"`` (exactly 16 x 16 flash
     launches, no plain attention and no ``scaled_dot_product_attention``
     call), run F-chunked (the same weights and prompts in plain PyTorch;
     first tokens must agree outside near-ties) and run F-f32 (one 2048-token
     prompt, f32 weights and tiles, flash against chunked prefill logits);
     then LM training and the MoE family (phase 4g): T-olmo
     (``launch.train`` on OLMo-1B as published, bf16, batch 8 x 2048,
     remat, 6 steps: every loss and grad norm finite, every parameter
     leaf moved from its seed-0 draw, step times and the allocator peak;
     then microbatches 4 against 1 from the same state and batch, first
     losses within 2e-3 relative), T-olmo-cpu (OLMo-1B at full width cut
     to 2 layers, f32, 256 tokens: ``lm_loss`` and every grad on the card
     against the same call on the host CPU, loss 1e-5 relative, each grad
     leaf 1e-4 normwise), T-moe (``launch.train`` on qwen3-moe-235b-a22b
     at full width cut to 1 layer, 3.73e9 parameters, batch 2 x 2048, 3
     steps, dense dispatch; then ``moe_ep_groups=4`` against dense
     dispatch on 256 tokens at f32 with capacity_factor 100, 1e-5
     normwise), F-moe (the same config cut to 4 layers, bf16, served with
     flash and with chunked attention to 4 requests of 256-2048 prompt
     tokens: 4 x 4 flash launches, first tokens equal outside near-ties,
     last-token prefill logits within SERVE_LOGIT_TOL for the requests
     whose last token took the same experts in every layer in both runs;
     the routing flips printed) and F-moe-f32 (one 2048-token prompt, f32
     weights and tiles, flash against chunked prefill logits within
     1e-4); then the encoder-decoder, hybrid and RWKV6 families at their
     published widths (phase 4h, bf16 weights drawn on the card from seed
     0): S / S-chunked (seamless-m4t-medium, 4 requests of 512-2048 frame
     rows and 1-8 decoder tokens through ``api.prefill`` at max_len 64 and
     ``api.decode`` to 32 greedy tokens: exactly 4 x (12 + 12) flash
     launches with flash, none chunked; first tokens and prefill logits
     held as run F's over the valid vocabulary), S-f32 (one 2048-frame
     request, f32, flash against chunked prefill logits within 1e-4),
     S-cpu (2 + 2 layers, f32, 256 frames, 32 tokens: the loss and every
     grad on the card against the host CPU at T-olmo-cpu's limits), Z /
     Z-chunked (zamba2-2.7b through ``ServingEngine``, 4 slots, max_len
     8192, seven requests of 256-2048 tokens and one of 4,500 that wraps
     the shared block's 4096-row ring: exactly 8 x 9 flash launches; held
     to Z-f32's prompt's own bf16 noise, the distance of its chunked logits
     at bf16-rounded weights from the f32 ones, where that exceeds run F's
     limits), Z-f32 (flash against chunked at f32 within 1e-4), T-zamba
     (``launch.train`` at full width cut to one group of 6 layers, batch
     2 x 2048, 3 steps, remat: T-olmo's checks), T-zamba-cpu (the same
     cut, f32, 256 tokens, card against host CPU; a grad leaf that moves
     by ``floor`` when the SSD scan runs in chunks of 64 instead of 128 on
     the card is held to max(1e-4, 4 floor)), R (rwkv6-7b through
     ``ServingEngine``, 8 slots, 8 requests of 256-2048 tokens: no kernel
     launch at all), R-cpu (2 layers, f32, a 256-token prompt: prefill
     logits, the wkv state and 8 decode steps' logits on the card within
     1e-4 normwise of the host CPU's) and T-rwkv (``launch.train``, 2
     layers, batch 2 x 2048, 3 steps); the baselines and the model axis
     (phase 4i: BL-lloyd, BL-sculley, TP-1, TP-cpu over the host's gloo
     worlds (1, 2) and (2, 2) at five smoke configs); then phase 4j:
     DRY (ten ``launch.dryrun`` cells in their own processes on the
     host, the card hidden, while the card works: every cell ok, olmo-1b's
     single-pod / multi-pod train flops within 1.6-2.4, collective bytes
     in every cell), TP-1-S / TP-1-R (seamless-m4t-medium's run S
     requests through ``api.prefill`` / ``api.decode`` and 2 train steps
     at 2 + 2 layers; rwkv6-7b's ``launch.serve`` at run R's settings and
     ``launch.train`` at T-rwkv's cut; each on a mesh (1, 1) in a NCCL
     world of one against no mesh: tokens, losses and grad norms bitwise,
     no collective) and EX (the five ``examples/torch_*.py`` at their
     defaults, the MD example also at 100,000 frames x 64 atoms, 8 GB,
     on the fused engine: NMI >= 0.9, quickstart's XOR kernel accuracy
     at least its linear one, a rerun of the LM training example resumes
     from its checkpoint); DRY also runs gemma2-2b decode_32k (8 heads
     over a model axis of 16, two ranks a head) and one ``--smoke`` cell
     of each family (every head over 4-8 ranks), and TP-cpu a world
     (1, 4) of 2-head smoke configs, each head over two ranks; then
     phase 4k: GM / GM-chunked (gemma2-2b as published, bf16, through
     ``ServingEngine``, 8 slots, max_len 8192, 8 requests of 256-4096
     tokens and one of 5,000 that wraps the local layers' 4096-row ring,
     32 greedy tokens: exactly 9 x 13 flash launches on the global
     layers, none chunked; held as run F's) and TP-1-GM
     (``launch.serve --arch gemma2-2b`` at its own settings on a mesh
     (1, 1) in a NCCL world of one and without: tokens bitwise, 16 x 13
     flash launches each, no collective);
  5. print the per-kernel JSON line (one entry per kernel; assign_fused,
     embed_assign, sketch_assign and flash_attention one per tile dtype,
     since both bodies run on the main path, and kernel_matrix one for its
     column body) and, last, the ok line.

Tolerances (normwise: max |kernel - plain| <= tol * max(1, max |plain|)):
kernel_matrix 1e-5 (and the rbf diagonal of K(x, x) within 1e-5 of 1, on
both bodies), assign_fused f and mind 1e-4, embed_assign and
sketch_assign scores 1e-4, at f32 and bf16 alike. Labels must be equal
except where the plain version's top-2 gap is below 1e-4 * max(1, |min|) (a
near-tie; counted and printed). flash_attention: 2e-5 at f32 (the JAX
test's limit) and 1e-2 at bf16, against the plain version on the same bf16
inputs (the kernel rounds P to bf16 for P.V; both round the output to
bf16).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM, dense. "f32": f32-accurate products, the least time of which
# is 3xTF32 on the tensor cores (495 TFLOP/s TF32 / 3); bounds before the
# f32 bodies moved to 3xTF32 used the CUDA cores' 67 TFLOP/s, which is
# "f32_cuda"
PEAK_FLOPS = {"f32": 495e12 / 3, "bf16": 989e12, "f32_cuda": 67e12}
PEAK_BYTES = 3.35e12
# the same limits at f32 and bf16: kernel and plain version get the same
# rounded operands and both sum in f32, so only the order of the sums differs
TOL = {"kernel_matrix": 1e-5, "assign_fused": 1e-4, "embed_assign": 1e-4,
       "sketch_assign": 1e-4}
NEAR_TIE = 1e-4
FLASH_TOL = {"f32": 2e-5, "bf16": 1e-2}
# (config, B, H, KH, S, dh, softcap, causal): the attention of six configs
# the repo holds (src/repro/configs): OLMo-1B's prefill, gemma2-2b's global
# layers, qwen3-32b, qwen3-moe-235b-a22b (run F-moe's prefill), zamba2's
# shared block (dh 80: the 128 tiling with 48 padded columns) and
# seamless-m4t-medium's encoder (non-causal, 2048 frames); q is drawn with
# std 3 so the softmax is far from uniform (scores of std 3)
FLASH_MAIN = [("olmo-1b", 1, 16, 16, 2048, 128, None, True),
              ("gemma2-2b", 1, 8, 4, 2048, 256, 50.0, True),
              ("qwen3-32b", 1, 64, 8, 2048, 128, None, True),
              ("qwen3-moe-235b-a22b", 1, 64, 4, 2048, 128, None, True),
              ("zamba2-2.7b", 1, 32, 32, 2048, 80, None, True),
              ("seamless-m4t-medium-encoder", 1, 16, 16, 2048, 64, None,
               False)]
# run F (OLMo-1B serving): ServeConfig and request stream
SERVE = dict(max_batch=8, max_len=4096, eos_token=-1, max_new_tokens=32)
N_REQUESTS, PROMPT_MIN, PROMPT_MAX = 16, 256, 2048
# flash (bf16) against chunked (bf16) OLMo-1B. The two attention paths
# round at other places (the kernel's bf16 P against an f32 softmax), and
# sixteen bf16 layers carry the difference to the logits (std ~1 over
# 50,304 tokens): the last-token prefill logits must agree within
# SERVE_LOGIT_TOL normwise, and first tokens wherever run F's top-2 logit
# gap is at least SERVE_NEAR_TIE (in logits). A wrong softmax or mask moves
# the logits by O(1).
SERVE_NEAR_TIE = 0.1
SERVE_LOGIT_TOL = 0.05
# phase 4g (LM training and the MoE family). T-olmo: launch.train on
# OLMo-1B as published, batch 8 x 2048 with remat; the first step's loss at
# microbatches 4 within MB_REL of microbatches 1 (the reference's own
# limit, tests/test_data_training.py:329). T-moe: qwen3-moe-235b-a22b at
# full width cut to 1 layer, batch 2 x 2048. F-moe: the same config cut to
# 4 layers, served to 4 requests with flash and with chunked attention
T_OLMO = dict(steps=6, batch=8, seq=2048)
MB_REL = 2e-3
T_MOE = dict(layers=1, steps=3, batch=2, seq=2048)
F_MOE = dict(layers=4, requests=4)
# phase 4h (the encoder-decoder, hybrid and RWKV6 families as published).
# S: seamless-m4t-medium, one request per frame count with 1-8 decoder
# tokens, prefilled at max_len 64 and decoded to 32 greedy tokens. Z:
# zamba2-2.7b served to seven prompts of 256-2048 tokens and one of 4,500
# (past the shared block's 4096-row window: the ring wraps). R: rwkv6-7b
# served to 8 prompts of 256-2048 tokens. T-zamba / T-rwkv: launch.train
# at full width cut to one group of 6 layers / 2 layers. The *-cpu runs:
# the card against the host CPU at f32
S_FRAMES, S_PROMPT_MAX, S_MAX_LEN, S_TOKENS = (512, 1024, 1536, 2048), 8, \
    64, 32
S_CPU = dict(layers=2, frames=256, tokens=32)
Z_SERVE = dict(max_batch=4, max_len=8192, eos_token=-1, max_new_tokens=32)
Z_REQUESTS, Z_LONG = 7, 4500
R_SERVE = dict(max_batch=8, max_len=4096, eos_token=-1, max_new_tokens=32)
R_REQUESTS, R_CPU = 8, dict(layers=2, tokens=256, steps=8)
T_ZAMBA = dict(layers=6, steps=3, batch=2, seq=2048)
# T-zamba-cpu's grads against the host CPU's f64 run: each leaf of the
# card's f32 grads within F64_MULT x the CPU f32 run's own distance from
# f64 for that leaf, floored at the median leaf's distance (a leaf the CPU
# happens to round almost exactly gets its neighbours' noise). At this
# cut the card read at most 1.07x the CPU leaf by leaf
F64_MULT = 4
T_RWKV = dict(layers=2, steps=3, batch=2, seq=2048)
CPU_TOKENS = 256
# phase 4i (the linear baselines and the model axis). BL-lloyd: Tab.1's
# linear column (benchmarks/tab1_mnist.py:24-36: C = 10, n_init 3, seed
# 0); BL-sculley: Fig.8's grid (benchmarks/fig8_sculley.py:24-42); TP-1:
# T-olmo cut to TP1_STEPS steps and run F's serving settings on a mesh
# (1, 1); TP-cpu: these smoke configs on gloo worlds (1, 2) and (2, 2)
BL_C, BL_INIT, BL_BS, BL_SEEDS = 10, 3, (1, 4, 16, 64), [0, 1, 2]
TP1_STEPS = 2
TP_CPU_ARCHS = ("olmo-1b", "qwen3-moe-235b-a22b", "zamba2-2.7b",
                "seamless-m4t-medium", "rwkv6-7b")
# TP-cpu's world (1, 4): smoke configs with 2 heads, each head split over
# two ranks (mid-head): (name, arch, config changes)
TP_MID = (("olmo-h2", "olmo-1b", dict(n_heads=2, n_kv_heads=2)),
          ("gemma2-h2", "gemma2-2b", dict(n_heads=2, n_kv_heads=1)),
          ("seamless-h2", "seamless-m4t-medium",
           dict(n_heads=2, n_kv_heads=2)),
          ("zamba2-h2", "zamba2-2.7b",
           dict(n_heads=2, n_kv_heads=2, ssm_expand=1)),
          ("rwkv6-7b", "rwkv6-7b", {}))
# phase 4j (the model axis of the encdec and ssm families, the dry run and
# the examples). TP-1-S: run S's requests through api.prefill / api.decode
# on a mesh (1, 1) against no mesh, and TP1_STEPS train steps at S-cpu's
# 2 + 2 layer cut on S_TRAIN's batch; TP-1-R: launch.serve at run R's
# settings and launch.train at T-rwkv's cut, each with and without
# --mesh 1x1. DRY: these launch.dryrun cells on the host CPU (each in its
# own process: a fake world of 256 / 512 ranks). EX: the five examples at
# their defaults; the MD example also at the reference generator's
# default size on the fused engine (assign_fused in every sweep)
S_TRAIN = dict(batch=2, frames=512, tokens=128)
DRY_CELLS = (("--arch", "olmo-1b", "--shape", "train_4k", "--both-meshes"),
             ("--arch", "seamless-m4t-medium", "--shape", "prefill_32k"),
             ("--arch", "rwkv6-7b", "--shape", "long_500k"),
             ("--arch", "qwen3-moe-235b-a22b", "--shape", "train_4k",
              "--variant", "ep"),
             # gemma2-2b's 8 heads over 16 ranks, and a smoke cell of each
             # family (2-4 heads): every head split over 2-8 ranks
             ("--arch", "gemma2-2b", "--shape", "decode_32k"),
             ("--arch", "gemma2-2b", "--shape", "decode_32k", "--smoke"),
             ("--arch", "qwen3-moe-235b-a22b", "--shape", "train_4k",
              "--smoke"),
             ("--arch", "seamless-m4t-medium", "--shape", "train_4k",
              "--smoke"),
             ("--arch", "zamba2-2.7b", "--shape", "train_4k", "--smoke"),
             ("--arch", "rwkv6-7b", "--shape", "train_4k", "--smoke"))
# phase 4k (gemma2-2b as published: 26 layers, d 2304, vocabulary 256,000;
# its 8 heads are what a model axis of 16 splits mid-head). GM / GM-chunked:
# served through ServingEngine as run F is, GM_REQUESTS prompts of
# PROMPT_MIN-4096 tokens and one of GM_LONG (past the 13 local layers'
# 4096-row window: their ring wraps in prefill and decode), 32 greedy
# tokens; flash on the 13 global layers (softcap 50, dh 256). TP-1-GM:
# launch.serve --arch gemma2-2b at the launcher's own settings, on a mesh
# (1, 1) in a NCCL world of one and without
GM_SERVE = dict(max_batch=8, max_len=8192, eos_token=-1, max_new_tokens=32)
GM_REQUESTS, GM_LONG = 8, 5000
MD_FULL = ("--frames", "100000", "--atoms", "64", "--memory-gb", "8",
           "--engine", "fused")
KINDS = ("rbf", "linear", "polynomial", "cosine")
N_TRAIN, N_TEST = 60000, 10000   # paper Tab.1 (benchmarks/tab1_mnist.py)
EMBED_DIM = 320                  # Fig.5's largest m (fig5_approx_sweep.py)
SWEEP_DIMS = (20, 80, 160)       # more of its m, timed at f32 (rff)
# Tab.2 (benchmarks/tab2_rcv1.py:58-70, 176-186): RCV1, 50 classes, the
# selector column's count sketch at m = 128, B = 4
RCV1_TRAIN, RCV1_TEST, RCV1_C, SKETCH_DIM = 188000, 5844, 50, 128
# assignment serving (run G): the bucket ladder (serving.DEFAULT_BUCKETS),
# the largest request of the ragged mix, and serve_bench's open loop:
# offered rates (requests/s) and requests per cell, at 1 and 64 rows (the
# rates and count of benchmarks/serve_bench.py:86-88, full mode)
BUCKETS = (1, 8, 64, 512)
G_REQUEST_MAX = 700
BENCH_QPS, BENCH_REQUESTS = (100.0, 500.0), 200
# Tab.2's sparse grid (benchmarks/tab2_rcv1.py:58-61, 99-122): RCV1 term
# vectors kept in CSR over the full vocabulary, the count sketch at m = 256
# for B = 4, 16, 64; its streaming grid (:124-161) cuts the training rows
# at 3B points drawn from default_rng(7). The CSR sketch is held against
# the dense map on CSR_CHECK_ROWS densified test rows (z within
# CSR_Z_TOL normwise: both sum f32 values in another order)
RCV1_VOCAB, CSR_DIM, CSR_BS, STREAM_SEED = 47236, 256, (4, 16, 64), 7
CSR_CHECK_ROWS, CSR_Z_TOL = 4096, 1e-5
# the mesh phase's artifact serves this many dense test rows at the full
# vocabulary, as ragged requests
MESH_SERVE_ROWS = 1024


T_START = 0.0          # the script's start (main), for its wall time


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: list, nbytes: float):
    """The least time for the work: the larger of the bytes and the
    operations. The operations take the better of two placements: all on
    the tensor cores (bf16 and 3xTF32 f32 share them, so their times add),
    or bf16 on the tensor cores beside f32 on the CUDA cores (the times
    overlap). Work of one type always takes the first."""
    f32 = sum(f for prec, f in flops if prec == "f32")
    t_bf16 = sum(f for prec, f in flops if prec == "bf16") / PEAK_FLOPS["bf16"]
    t_ops = min(f32 / PEAK_FLOPS["f32"] + t_bf16,
                max(f32 / PEAK_FLOPS["f32_cuda"], t_bf16))
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def work_bound(mods, kind: str, **shapes):
    """``bound_ms`` of one launch's work as ``launch.hlocost.KERNEL_WORK``
    counts it (the one count of each kernel's flops and bytes)."""
    return bound_ms(*mods["hlocost"].KERNEL_WORK[kind](**shapes))


def normwise(torch, got, want) -> tuple[float, float]:
    """(max abs err, max abs err / max(1, max |want|))."""
    err = float(torch.max(torch.abs(got.float() - want.float())))
    return err, err / max(1.0, float(torch.max(torch.abs(want.float()))))


def label_mismatches(torch, got, want, dist_plain) -> tuple[int, int]:
    """(mismatches outside near-ties, near-ties among all rows)."""
    top2 = torch.topk(dist_plain, 2, dim=1, largest=False).values
    gap = top2[:, 1] - top2[:, 0]
    near = gap <= NEAR_TIE * torch.clamp(torch.abs(top2[:, 0]), min=1.0)
    bad = (got.long() != want.long()) & ~near
    return int(bad.sum()), int(near.sum())


# ---------------------------------------------------------------------------
# phase 2: the redesigned bodies as compiled
# ---------------------------------------------------------------------------

# the entry functions of the bodies redesigned for Hopper, by a part of
# their mangled names
FLASH_BF16_BODY = "flash_bf16_kernel"
EMBED_F32_BODY = "embed_assign_f32_kernel"
# rt::af::assign_f32_kernel (a bare "assign_f32_kernel" would also match
# embed_assign_f32_kernel), rt::ab::assign_bf16_kernel
ASSIGN_F32_BODY = "2af17assign_f32_kernel"
ASSIGN_BF16_BODY = "2ab18assign_bf16_kernel"
# rt::embed_bf16_kernel<KIND>, one instantiation per epilogue: RFF and
# the four Mercer kinds
EMBED_BF16_BODY = "embed_bf16_kernel"
EMBED_BF16_EPILOGUES = 5
FLASH_F32_BODY = "flash_f32_kernel"
COLUMN_BODY = "kernel_matrix_col_kernel"
# rt::tile::tile_f32_kernel, rt::tile::tile_bf16_kernel (kernel_matrix's
# tile bodies), rt::sk::sketch_kernel
TILE_F32_BODY = "tile_f32_kernel"
TILE_BF16_BODY = "tile_bf16_kernel"
SKETCH_BODY = "2sk13sketch_kernel"
REGS_PER_THREAD_2_CTAS = 128     # 65,536 registers / (2 x 256 threads)
# SASS opcodes of the tensor cores: wgmma (bf16 flash) and mma.sync
# m16n8k8 TF32 (the 3xTF32 bodies)
HGMMA, HMMA_TF32 = "HGMMA", "HMMA.1688.F32.TF32"


def ptxas_resources(log: str) -> dict:
    """{mangled entry: {"lines": [...], "registers": int, "spill_bytes":
    int}} from the -Xptxas -v lines of a build log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"lines": [], "registers": None,
                                              "spill_bytes": 0})
        if cur is None:
            continue
        cur["lines"].append(line.strip())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        for m in re.finditer(r"(\d+) bytes spill (?:stores|loads)", line):
            cur["spill_bytes"] += int(m.group(1))
    return out


def sass_opcode_counts(lib: str, opcodes: tuple) -> dict | None:
    """{opcode: {mangled function: number of its SASS instructions}} in the
    built library, by cuobjdump; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: {} for op in opcodes}
    pattern = {op: re.compile(rf"\b{re.escape(op)}\b") for op in opcodes}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            for op in opcodes:
                counts[op][cur] = 0
        elif cur is not None:
            for op in opcodes:
                if pattern[op].search(line):
                    counts[op][cur] += 1
    return counts


def redesigned_bodies(build) -> None:
    """Print the ptxas lines of the ten redesigned bodies, the wgmma
    (HGMMA) count of the four wgmma bodies' SASS (flash bf16, assign bf16,
    the kernel_matrix bf16 tile, embed bf16) and the TF32 mma count
    (HMMA.1688.F32.TF32) of the six bodies that multiply in 3xTF32 (assign
    f32, flash f32, the kernel_matrix f32 tile, the contractions of assign
    bf16 and embed bf16, and sketch_assign's); fail if the embed f32 body
    or an instantiation of the embed bf16 body (all five epilogues must be
    there) needs more registers than two CTAs per SM leave it, if any body
    but flash bf16 spills, or if a body issues none of its tensor-core
    instructions."""
    res = ptxas_resources(build.LAST_BUILD["log"])
    for body in (FLASH_BF16_BODY, EMBED_F32_BODY, ASSIGN_F32_BODY,
                 ASSIGN_BF16_BODY, FLASH_F32_BODY, COLUMN_BODY, TILE_F32_BODY,
                 TILE_BF16_BODY, SKETCH_BODY, EMBED_BF16_BODY):
        found = {k: v for k, v in res.items() if body in k}
        check(bool(found), f"ptxas printed no entry of {body}")
        if body == EMBED_BF16_BODY:
            check(len(found) == EMBED_BF16_EPILOGUES,
                  f"{body}: {len(found)} instantiations, expected one per "
                  f"epilogue ({EMBED_BF16_EPILOGUES})")
        for name, r in found.items():
            print(f"ptxas {body}: {name}")
            for line in r["lines"]:
                print(f"  {line}")
            if body in (EMBED_F32_BODY, EMBED_BF16_BODY):
                check(r["registers"] is not None
                      and r["registers"] <= REGS_PER_THREAD_2_CTAS
                      and r["spill_bytes"] == 0,
                      f"{name}: {r['registers']} registers, "
                      f"{r['spill_bytes']} spill bytes (two CTAs per SM "
                      f"need <= {REGS_PER_THREAD_2_CTAS} and no spills)")
            if body not in (FLASH_BF16_BODY, EMBED_F32_BODY):
                check(r["spill_bytes"] == 0,
                      f"{name}: {r['spill_bytes']} spill bytes")
    counts = sass_opcode_counts(build.LAST_BUILD["path"], (HGMMA, HMMA_TF32))
    check(counts is not None, "the toolkit has no cuobjdump: the tensor-core "
                              "instructions of the bodies cannot be counted")
    for body, op in ((FLASH_BF16_BODY, HGMMA), (ASSIGN_BF16_BODY, HGMMA),
                     (TILE_BF16_BODY, HGMMA), (EMBED_BF16_BODY, HGMMA),
                     (ASSIGN_BF16_BODY, HMMA_TF32),
                     (EMBED_BF16_BODY, HMMA_TF32),
                     (ASSIGN_F32_BODY, HMMA_TF32),
                     (FLASH_F32_BODY, HMMA_TF32), (TILE_F32_BODY, HMMA_TF32),
                     (SKETCH_BODY, HMMA_TF32)):
        found = {k: v for k, v in counts[op].items() if body in k}
        for name, n in found.items():
            print(f"{op} instructions in {name}: {n}")
        check(bool(found) and all(n > 0 for n in found.values()),
              f"{body} issues no {op}: {found}")


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------


def spread_gamma(torch, x, y) -> float:
    """1 / median squared distance: rbf values spread over (0, 1), so a
    wrong Gram moves them by far more than the tolerance."""
    return 1.0 / float(torch.median(torch.cdist(x[:1000].float(),
                                                y[:1000].float()).square()))


def check_kernel_matrix(torch, mods, x, y, kind, gamma, prec, *, timed):
    """ops.kernel_matrix (the wrapper the main path calls) against
    ref.kernel_matrix_ref on the same operands, already in the tile dtype
    as the main path hands them over. The record names the body the
    wrapper routed to. Timed on a skinny Y (the column body), the library
    call is x @ y.T with the epilogue and the row norms; on a wide one,
    cdist and exp. The bound counts X, Y and K once (either body's launch
    computes the norms itself)."""
    ops, ref = mods["ops"], mods["ref"]
    p = mods["precision"].resolve_precision(prec)
    x, y = p.cast_tiles(x).contiguous(), p.cast_tiles(y).contiguous()
    m, d = x.shape
    n = y.shape[0]

    def kernel():
        return ops.kernel_matrix(x, y, kind=kind, gamma=gamma, precision=prec)

    def plain():
        return ref.kernel_matrix_ref(x, y, kind=kind, gamma=gamma,
                                     precision=prec)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = normwise(torch, got, want)
    tol = TOL["kernel_matrix"]
    body = mods["kernel_matrix"].route(n, d)
    rec = {"kernel": "kernel_matrix", "body": body, "shape": [m, n, d],
           "kind": kind, "gamma": gamma, "prec": prec, "max_abs_err": err,
           "rel_err": rel, "tol": tol}
    if kind == "rbf" and m == n:
        rec["diag_err"] = float(torch.max(torch.abs(torch.diagonal(got) - 1)))
    if timed:
        xf, yf = x.float(), y.float()

        def library():
            if body == "tile":
                return torch.exp(torch.cdist(xf, yf).square_().mul_(-gamma))
            dot = xf @ yf.T
            if kind == "linear":
                return dot
            d2 = (xf * xf).sum(1)[:, None] + (yf * yf).sum(1)[None] - 2 * dot
            return torch.exp(-gamma * d2.clamp_(min=0.0))
        rec["ms"] = time_ms(torch, kernel, 10)
        rec["plain_ms"] = time_ms(torch, plain, 10)
        rec["library_ms"] = time_ms(torch, library, 10)
        rec["bound_ms"], rec["bound_by"] = work_bound(
            mods, "kernel_matrix", m=m, n=n, d=d, prec=prec)
    print("check", json.dumps(rec))
    check(rel <= tol, f"kernel_matrix {kind} {prec} {[m, n, d]}: "
                      f"rel err {rel:.3g} > {tol}")
    return rec


def check_assign(torch, mods, x, lm, labels_l, g, n_clusters, kind, gamma,
                 prec, *, timed):
    """ops.assign_fused against ref.assign_fused_ref, both fed the cluster
    operands of ops.assign_panels."""
    ops, ref = mods["ops"], mods["ref"]
    p = mods["precision"].resolve_precision(prec)
    x, lm = p.cast_tiles(x).contiguous(), p.cast_tiles(lm).contiguous()
    counts = torch.bincount(labels_l.long(), minlength=n_clusters).float()
    h, gm = ops.assign_panels(labels_l, counts, g, n_clusters)
    m, d = x.shape
    nl = lm.shape[0]

    def kernel():
        return ops.assign_fused(x, lm, labels_l, counts, g,
                                n_clusters=n_clusters, kind=kind, gamma=gamma,
                                precision=prec)

    def plain():
        return ref.assign_fused_ref(x, lm, h, gm, kind=kind, gamma=gamma,
                                    precision=prec)

    (lab, mind, f), (lab_p, mind_p, f_p) = kernel(), plain()
    torch.cuda.synchronize()
    err_f, rel_f = normwise(torch, f, f_p)
    err_m, rel_m = normwise(torch, mind, mind_p)
    bad, near = label_mismatches(torch, lab, lab_p, gm[None, :] - 2.0 * f_p)
    tol = TOL["assign_fused"]
    rec = {"kernel": "assign_fused", "shape": [m, nl, d], "C": n_clusters,
           "kind": kind, "gamma": gamma, "prec": prec,
           "max_abs_err": max(err_f, err_m), "rel_err_f": rel_f,
           "rel_err_mind": rel_m, "tol": tol, "label_mismatch": bad,
           "near_ties": near}
    if timed:
        xf, lf = x.float(), lm.float()

        def library():
            k = torch.exp(torch.cdist(xf, lf).square_().mul_(-gamma))
            dist = gm[None, :] - 2.0 * (k @ h)
            return torch.argmin(dist, dim=1), torch.amin(dist, dim=1)

        rec["ms"] = time_ms(torch, kernel, 5)
        rec["plain_ms"] = time_ms(torch, plain, 5)
        rec["library_ms"] = time_ms(torch, library, 5)
        rec["bound_ms"], rec["bound_by"] = work_bound(
            mods, "assign_fused", m=m, l=nl, d=d, c=n_clusters, prec=prec)
    print("check", json.dumps(rec))
    check(rel_f <= tol and rel_m <= tol,
          f"assign_fused {kind} {prec} {[m, nl, d]} C={n_clusters}: rel err "
          f"f {rel_f:.3g} mind {rel_m:.3g} > {tol}")
    check(bad == 0, f"assign_fused {kind} {prec} {[m, nl, d]}: {bad} labels "
                    f"differ outside near-ties")
    return rec


def check_gram_matvec(torch, mods, lm, labels_l, n_clusters, gamma, prec, *,
                      timed=False):
    """ops.gram_matvec (the g stats: K(L, L) @ H) against the plain block
    product, at the main path's landmark panel; timed, beside the composite
    of cdist + exp + matmul, at the 3000 x 3000 panel of runs B and C."""
    ops, ref = mods["ops"], mods["ref"]
    p = mods["precision"].resolve_precision(prec)
    lm = p.cast_tiles(lm).contiguous()
    h = torch.nn.functional.one_hot(labels_l.long(), n_clusters).float()
    def kernel():
        return ops.gram_matvec(lm, lm, h, kind="rbf", gamma=gamma,
                               precision=prec)

    def plain():
        return ref.kernel_matrix_ref(lm, lm, kind="rbf", gamma=gamma,
                                     precision=prec) @ h

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    # h is a plain one-hot here (sums of up to |L| values): normwise
    err, rel = normwise(torch, got, want)
    tol = TOL["assign_fused"]
    rec = {"kernel": "assign_fused", "wrapper": "gram_matvec",
           "shape": [lm.shape[0], lm.shape[0], lm.shape[1]], "C": n_clusters,
           "kind": "rbf", "gamma": gamma, "prec": prec, "max_abs_err": err,
           "rel_err": rel, "tol": tol}
    if timed:
        lf = lm.float()
        nl, d = lm.shape
        rec["ms"] = time_ms(torch, kernel, 10)
        rec["plain_ms"] = time_ms(torch, plain, 10)
        rec["library_ms"] = time_ms(
            torch, lambda: torch.exp(torch.cdist(lf, lf).square_()
                                     .mul_(-gamma)) @ h, 10)
        rec["bound_ms"], rec["bound_by"] = work_bound(
            mods, "gram_matvec", m=nl, l=nl, d=d, c=n_clusters, prec=prec,
            shared=True)
    print("check", json.dumps(rec))
    check(rel <= tol, f"gram_matvec {prec} {rec['shape']}: rel err "
                      f"{rel:.3g} > {tol}")
    return rec


def kernel_checks(torch, mods, x_b, y_b, gamma):
    """At the main path's shapes, its gamma and a gamma that spreads K, at
    f32 and bf16; then every epilogue kind at a small shape."""
    dev = x_b.device
    gen = torch.Generator().manual_seed(0)
    n = x_b.shape[0]
    l3 = torch.sort(torch.randperm(n, generator=gen)[:3000]).values.to(dev)
    wide = spread_gamma(torch, x_b, x_b[l3])
    recs = []
    for prec in ("f32", "bf16"):
        # materialize Gram build [15000 x 3000] and Eq.8 K~ [15000 x 10]
        recs.append(check_kernel_matrix(torch, mods, x_b, x_b[l3], "rbf",
                                        gamma, prec, timed=True))
        recs.append(check_kernel_matrix(torch, mods, x_b, x_b[:10], "rbf",
                                        gamma, prec, timed=False))
        # the tile body at the narrowest Y it takes (NCOL_MAX + 1 rows) and
        # at D-nystrom's K_LL [320 x 320], timed
        rec = check_kernel_matrix(torch, mods, x_b, x_b[:33], "rbf", wide,
                                  prec, timed=False)
        check(rec["body"] == "tile", f"N = 33 took the {rec['body']} body")
        recs.append(rec)
        recs.append(check_kernel_matrix(torch, mods, x_b[l3[:320]],
                                        x_b[l3[:320]], "rbf", gamma, prec,
                                        timed=True))
        for kind, gam in (("rbf", wide), ("linear", 1.0)):
            recs.append(check_kernel_matrix(torch, mods, x_b, x_b[l3], kind,
                                            gam, prec, timed=False))
        # fused assignment at |L| = 15000 (run A) and 3000 (runs B, C); the
        # landmark labels are the data's classes, g their true compactness
        for l_idx in (torch.arange(n, device=dev), l3):
            lm, labels_l = x_b[l_idx], y_b[l_idx]
            for gam, timed in ((gamma, True), (wide, False)):
                onehot = torch.nn.functional.one_hot(labels_l.long(),
                                                     10).float()
                counts = onehot.sum(dim=0)
                t = mods["ops"].gram_matvec(lm, lm, onehot, kind="rbf",
                                            gamma=gam, precision=prec)
                g = torch.sum(onehot * t, dim=0) / counts ** 2
                recs.append(check_assign(torch, mods, x_b, lm, labels_l, g,
                                         10, "rbf", gam, prec, timed=timed))
            recs.append(check_gram_matvec(torch, mods, lm, labels_l, 10, wide,
                                          prec))
            if len(lm) == len(l3):   # the g stats of runs B and C, timed
                recs.append(check_gram_matvec(torch, mods, lm, labels_l, 10,
                                              gamma, prec, timed=True))
    rng = torch.Generator().manual_seed(1)
    xs = torch.randn(300, 129, generator=rng).to(dev)
    ys = torch.randn(520, 129, generator=rng).to(dev)
    la = torch.randn(130, 40, generator=rng).to(dev)
    xa = torch.randn(300, 40, generator=rng).to(dev)
    for prec in ("f32", "bf16"):
        for kind in KINDS:
            gam = spread_gamma(torch, xs, ys) if kind == "rbf" else 0.05
            recs.append(check_kernel_matrix(torch, mods, xs, ys, kind, gam,
                                            prec, timed=False))
            gam = spread_gamma(torch, xa, la) if kind == "rbf" else 0.05
            # 300 clusters take two launches, merged by lowest index
            for c in (3, 7, 130, 300):
                lab = torch.randint(0, c, (130,), generator=rng).to(dev)
                g = torch.rand(c, generator=rng).to(dev)
                recs.append(check_assign(torch, mods, xa, la, lab, g, c, kind,
                                         gam, prec, timed=False))
        xd = torch.randn(40, 6, generator=rng).to(dev)
        # the tile body at 40 x 40, the column body at 16 x 16
        for xdiag in (xd, xd[:16]):
            rbf_diag = check_kernel_matrix(torch, mods, xdiag, xdiag, "rbf",
                                           0.7, prec, timed=False)
            check(rbf_diag["diag_err"] <= TOL["kernel_matrix"],
                  f"rbf diagonal is not 1 at {prec} ({rbf_diag['body']} "
                  f"body): {rbf_diag['diag_err']}")
    tie_and_empty_fixtures(torch, mods, dev)
    return recs


def skinny_checks(torch, mods, x_b, x_te, x_tr, x_rcv, gamma):
    """ops.kernel_matrix at the skinny shapes the runs launch
    (``kernel_ab.SKINNY``: k-means++ columns and Eq.8 / predict blocks of
    runs A-C, k-means++ of the D runs on the RFF embedding and of the E
    runs on a count-sketch batch), timed, in the tile dtypes the runs
    give them: the column body's shapes."""
    approx, core = mods["approx"], mods["core"]
    dev = x_b.device
    rows = {"batch": x_b, "test": x_te,
            "rff": approx.make_rff(
                torch.Generator().manual_seed(3), x_tr.shape[1], EMBED_DIM,
                core.KernelSpec("rbf", gamma=gamma), device=dev)(x_tr),
            "sketch": approx.make_count_sketch(
                torch.Generator().manual_seed(5), x_rcv.shape[1], SKETCH_DIM,
                core.KernelSpec("linear"), device=dev)(x_rcv[0::4])}
    recs = []
    for m, n, d, kind, src, precs in mods["kernel_ab"].SKINNY:
        x = rows[src][:m]
        check(tuple(x.shape) == (m, d), f"skinny rows {src}: {x.shape}")
        for prec in precs:
            rec = check_kernel_matrix(torch, mods, x, x[:n], kind, gamma,
                                      prec, timed=True)
            check(rec["body"] == "column",
                  f"kernel_matrix {[m, n, d]} took the {rec['body']} body")
            recs.append(rec)
    return recs


def tie_and_empty_fixtures(torch, mods, dev):
    ops = mods["ops"]
    rng = torch.Generator().manual_seed(2)
    x = torch.randn(300, 40, generator=rng).to(dev)
    a = torch.randn(128, 40, generator=rng).to(dev)
    for prec in ("f32", "bf16"):
        # two clusters over identical landmark tiles: f ties bitwise, and
        # the lowest index must win everywhere
        labels_l = torch.cat([torch.zeros(128), torch.ones(128)]).int().to(dev)
        counts = torch.tensor([128.0, 128.0], device=dev)
        g = torch.tensor([0.3, 0.3], device=dev)
        lab, _, f = ops.assign_fused(x, torch.cat([a, a]), labels_l, counts,
                                     g, n_clusters=2, gamma=0.05,
                                     precision=prec)
        check(bool(torch.equal(f[:, 0], f[:, 1])),
              f"tie fixture {prec}: f columns differ")
        check(int(lab.max()) == 0, f"tie fixture {prec}: a tie chose index 1")
        # clusters 3 and 4 hold no landmark: they must never be chosen
        labels_l = (torch.arange(20, device=dev) % 3).int()
        counts = torch.bincount(labels_l.long(), minlength=5).float()
        lab, _, _ = ops.assign_fused(x, x[:20], labels_l, counts,
                                     torch.zeros(5, device=dev), n_clusters=5,
                                     precision=prec)
        check(int(lab.max()) <= 2, f"empty-cluster fixture {prec}: chose "
                                   f"{int(lab.max())}")
    print("fixtures: bitwise tie -> lowest index, empty clusters unjoinable: ok")


def check_embedded(torch, mods, x, fmap, centroids, counts, prec, *, timed,
                   tag=""):
    """ops.embed_assign (the wrapper predict_embedded calls) against the
    plain version on the same operands: ref.embed_assign_ref on the panels
    of ops.embed_panels, or ref.sketch_assign_ref for the count sketch.
    The sketch and the bf16 embed body are also launched twice and
    compared bitwise."""
    ops, ref = mods["ops"], mods["ref"]
    p = mods["precision"].resolve_precision(prec)
    sketch = fmap.kind == "sketch"
    name = "sketch_assign" if sketch else "embed_assign"
    c32, csq = ops._masked_csq(centroids, counts)
    n, d = x.shape
    m, c = fmap.dim, centroids.shape[0]
    xc = p.cast_tiles(x)

    def kernel(rows=x):
        return ops.embed_assign(rows, fmap, centroids, counts,
                                precision=prec)

    if sketch:
        args = (xc, fmap.h, fmap.sign.to(p.sign_dtype), c32.T, csq)
        kw = dict(precision=prec)
        plain_assign, plain_score = ref.sketch_assign_ref, ref.sketch_score_ref
    else:
        w, aux, v, _, st = ops.embed_panels(fmap, centroids, counts)
        args = (xc, p.cast_tiles(w), v, csq)
        kw = dict(b=aux, precision=prec, **st)
        plain_assign, plain_score = ref.embed_assign_ref, ref.embed_score_ref

    def plain():
        return plain_assign(*args, **kw)

    (lab, score), (lab_p, score_p) = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = normwise(torch, score, score_p)
    bad, near = label_mismatches(torch, lab, lab_p, plain_score(*args, **kw))
    tol = TOL[name]
    rec = {"kernel": name, "map": fmap.kind if sketch or st["map_kind"] ==
           "rff" else f"nystrom-{st['map_kind']}", "shape": [n, d, m],
           "C": c, "prec": prec, "max_abs_err": err, "rel_err": rel,
           "tol": tol, "label_mismatch": bad, "near_ties": near, "tag": tag}
    if sketch or prec == "bf16":   # the bf16 embed body sums its splits
        lab2, score2 = kernel()
        rec["bitwise_repeat"] = bool(torch.equal(lab, lab2)
                                     and torch.equal(score, score2))
    if timed:
        xf = x.float()
        if sketch:
            h, sgn = fmap.h.long(), fmap.sign

            def library():
                z = torch.zeros(n, m, device=x.device).index_add_(
                    1, h, xf * sgn[None])
                sc = csq[None] - 2.0 * (z @ c32.T)
                return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
        else:
            wf = w.float()
            wsq = torch.sum(wf * wf, dim=1)

            def library():
                a = xf @ wf.T
                if st["map_kind"] == "rff":
                    e = st["scale"] * torch.cos(a + aux)
                else:      # nystrom rbf
                    d2 = (torch.sum(xf * xf, 1)[:, None] + wsq[None]
                          - 2.0 * a)
                    e = torch.exp(-st["gamma"] * d2.clamp_(min=0.0))
                sc = csq[None] - 2.0 * (e @ v)
                return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
        rec["ms"] = time_ms(torch, kernel, 10)
        if sketch or prec == "bf16":
            # on rows already in the tile dtype: no wrapper cast
            rec["kernel_ms"] = time_ms(torch, lambda: kernel(xc), 10)
        rec["plain_ms"] = time_ms(torch, plain, 10)
        rec["library_ms"] = time_ms(torch, library, 10)
        rec["bound_ms"], rec["bound_by"] = work_bound(
            mods, name, n=n, d=d, m=m, c=c, prec=prec)
    print("check", json.dumps(rec))
    check(rel <= tol, f"{name} {rec['map']} {prec} {[n, d, m]} C={c}: rel "
                      f"err {rel:.3g} > {tol}")
    check(bad == 0, f"{name} {rec['map']} {prec} {[n, d, m]}: {bad} labels "
                    f"differ outside near-ties")
    check(rec.get("bitwise_repeat", True),
          f"{name} {prec} {[n, d, m]}: two launches differ")
    return rec


def class_means(torch, z, y, n_classes):
    """Centroids a fit would reach: the class means of the embedded rows."""
    h = torch.nn.functional.one_hot(y.long(), n_classes).float()
    return (h.T @ z) / h.sum(dim=0).clamp(min=1.0)[:, None], h.sum(dim=0)


def embedded_checks(torch, mods, x_tr, y_tr, gamma, x_rcv, y_rcv):
    """embed_assign at the Fig.5 main shape (60,000 x 784 -> 320, C = 10,
    rff and Nystrom rbf) and sketch_assign at the Tab.2 one (188,000 x 256
    -> 128, C = 50), timed, at f32 and bf16; then the reference's test
    shapes, every Mercer kind, C = 300 (two launches) and the tie and
    empty-cluster fixtures."""
    approx, core = mods["approx"], mods["core"]
    dev = x_tr.device
    recs = []
    spec = core.KernelSpec("rbf", gamma=gamma)
    main_maps = [
        approx.make_rff(torch.Generator().manual_seed(3), x_tr.shape[1],
                        EMBED_DIM, spec, device=dev),
        approx.make_nystrom(torch.Generator().manual_seed(4), x_tr,
                            EMBED_DIM, spec),
        approx.make_count_sketch(torch.Generator().manual_seed(5),
                                 x_rcv.shape[1], SKETCH_DIM,
                                 core.KernelSpec("linear"), device=dev)]
    for fmap in main_maps:
        x, y, c = ((x_rcv, y_rcv, RCV1_C) if fmap.kind == "sketch"
                   else (x_tr, y_tr, 10))
        cents, counts = class_means(torch, fmap(x), y, c)
        for prec in ("f32", "bf16"):
            recs.append(check_embedded(torch, mods, x, fmap, cents, counts,
                                       prec, timed=True, tag="main"))
    # the rest of the Fig.5 sweep's m, whose column tiles the f32 body
    # chooses apart from m = 320's
    for m in SWEEP_DIMS:
        fmap = approx.make_rff(torch.Generator().manual_seed(3),
                               x_tr.shape[1], m, spec, device=dev)
        cents, counts = class_means(torch, fmap(x_tr), y_tr, 10)
        recs.append(check_embedded(torch, mods, x_tr, fmap, cents, counts,
                                   "f32", timed=True, tag=f"sweep-m{m}"))
    rng = torch.Generator().manual_seed(6)

    def rand(*shape):
        return torch.randn(*shape, generator=rng).to(dev)

    shapes = {"embed": [(64, 16, 32, 5), (100, 30, 77, 13),
                        (300, 40, 260, 130), (300, 40, 77, 300)],
              "sketch": [(64, 16, 32, 5), (100, 30, 77, 13),
                         (300, 520, 260, 130), (300, 520, 77, 300)]}
    kinds = {"rbf": dict(gamma=0.5), "linear": {},
             "polynomial": dict(gamma=0.05, coef0=1.0, degree=3),
             "cosine": {}}
    for prec in ("f32", "bf16"):
        for n, d, m, c in shapes["embed"]:
            x = rand(n, d)
            for fmap in (approx.make_rff(rng, d, m, core.KernelSpec(
                             "rbf", gamma=0.5), device=dev),
                         approx.make_nystrom(rng, x, m, core.KernelSpec(
                             "rbf", gamma=0.5))):
                recs.append(check_embedded(torch, mods, x, fmap, rand(c, m),
                                           torch.ones(c, device=dev), prec,
                                           timed=False))
        x = rand(300, 40)
        for kind, kw in kinds.items():
            fmap = approx.make_nystrom(rng, x, 77, core.KernelSpec(kind, **kw))
            recs.append(check_embedded(torch, mods, x, fmap, rand(13, 77),
                                       torch.ones(13, device=dev), prec,
                                       timed=False))
        for n, d, m, c in shapes["sketch"]:
            fmap = approx.make_count_sketch(rng, d, m,
                                            core.KernelSpec("linear"),
                                            device=dev)
            recs.append(check_embedded(torch, mods, rand(n, d), fmap,
                                       rand(c, m), torch.ones(c, device=dev),
                                       prec, timed=False))
        # two identical centroids tie bitwise: the lower index wins; an
        # empty cluster with a zero centroid is never chosen
        x = rand(300, 24)
        a, b = rand(40), rand(40)
        for fmap in (approx.make_rff(rng, 24, 40, core.KernelSpec("rbf"),
                                     device=dev),
                     approx.make_nystrom(rng, x, 40, core.KernelSpec("rbf")),
                     approx.make_count_sketch(rng, 24, 40,
                                              core.KernelSpec("linear"),
                                              device=dev)):
            lab, _ = mods["ops"].embed_assign(
                x, fmap, torch.stack([a, b, a]), torch.ones(3, device=dev),
                precision=prec)
            check(int(lab.max()) <= 1, f"{fmap.kind} tie fixture {prec}: a "
                                       f"tie chose the higher index")
            lab, _ = mods["ops"].embed_assign(
                x, fmap, torch.stack([a, torch.zeros_like(a), b]),
                torch.tensor([5.0, 0.0, 3.0], device=dev), precision=prec)
            check(not bool((lab == 1).any()),
                  f"{fmap.kind} empty-cluster fixture {prec}: chose it")
    print("embedded fixtures: bitwise tie -> lowest index, empty clusters "
          "unjoinable: ok")
    return recs


def check_flash(torch, mods, b, h, kh, sq, sk, dh, causal, cap, prec, *,
                timed, tag="", q_std=1.0, seed=0):
    """ops.flash_attention (the wrapper attention_block calls) against
    ref.flash_attention_ref on the same tile-dtype inputs."""
    ops, ref = mods["ops"], mods["ref"]
    p = mods["precision"].resolve_precision(prec)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, h, sq, dh), (b, kh, sk, dh), (b, kh, sk, dh)))
    q, k, v = p.cast_tiles(q * q_std), p.cast_tiles(k), p.cast_tiles(v)

    def kernel():
        return ops.flash_attention(q, k, v, causal=causal, softcap=cap,
                                   precision=prec)

    def plain():
        return ref.flash_attention_ref(q, k, v, causal=causal, softcap=cap)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err, rel = normwise(torch, got, want)
    tol = FLASH_TOL[prec]
    rec = {"kernel": "flash_attention", "shape": [b, h, kh, sq, sk, dh],
           "causal": causal, "softcap": cap, "prec": prec, "tag": tag,
           "max_abs_err": err, "rel_err": rel, "tol": tol}
    check(got.dtype == p.tile_dtype and bool(torch.isfinite(got).all()),
          f"flash_attention {tag} {prec}: wrong dtype or not finite")
    if timed:
        groups = h // kh
        F = torch.nn.functional
        if cap is None:
            rec["library"] = "scaled_dot_product_attention"

            def library():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=groups > 1)
        else:
            # SDPA applies no softcap: matmul, tanh, masked softmax, matmul
            rec["library"] = "matmul + tanh + masked softmax + matmul"
            mask = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
            if causal:
                mask = torch.tril(mask)

            def library():
                kx = k.repeat_interleave(groups, dim=1)
                vx = v.repeat_interleave(groups, dim=1)
                s = (q @ kx.transpose(-1, -2)).float() * dh ** -0.5
                s = (cap * torch.tanh(s / cap)).masked_fill(~mask, -1e30)
                return torch.softmax(s, dim=-1).to(q.dtype) @ vx
        rec["ms"] = time_ms(torch, kernel, 10)
        rec["plain_ms"] = time_ms(torch, plain, 3)
        rec["library_ms"] = time_ms(torch, library, 10)
        rec["bound_ms"], rec["bound_by"] = work_bound(
            mods, "flash_attention", b=b, h=h, kh=kh, sq=sq, sk=sk, dh=dh,
            causal=causal, prec=prec)
    print("check", json.dumps(rec))
    check(rel <= tol, f"flash_attention {tag} {prec} {rec['shape']}: rel err "
                      f"{rel:.3g} > {tol}")
    return rec, q, v, want


def flash_checks(torch, mods):
    """The FLASH_MAIN shapes at bf16 and f32, timed, and the
    uniform-attention guard on OLMo's; then ragged and small shapes."""
    recs = []
    for prec in ("bf16", "f32"):
        for i, (name, b, h, kh, s, dh, cap, causal) in enumerate(
                FLASH_MAIN):
            rec, q, v, want = check_flash(torch, mods, b, h, kh, s, s, dh,
                                          causal, cap, prec, timed=True,
                                          tag=name, q_std=3.0, seed=i)
            recs.append(rec)
            if name == "olmo-1b":
                # uniform causal attention: row i is the mean of v[:i + 1]
                n = torch.arange(1, s + 1, device="cuda", dtype=torch.float32)
                uniform = torch.cumsum(v.float(), dim=2) / n[:, None]
                _, gap = normwise(torch, uniform, want)
                print(f"uniform-attention guard ({prec}): plain output vs "
                      f"running mean of v, normwise {gap!r}")
                check(gap > 10 * FLASH_TOL["bf16"],
                      f"the OLMo inputs cannot catch a wrong softmax: "
                      f"{gap} <= {10 * FLASH_TOL['bf16']}")
            del q, v, want
        # (B, H, KH, Sq, Sk, dh, causal, softcap)
        for case in [(1, 16, 16, 1, 1, 128, True, None),
                     (1, 16, 16, 100, 100, 128, True, None),
                     (1, 16, 16, 1000, 1000, 128, True, None),
                     (2, 4, 2, 100, 100, 16, True, None),
                     (2, 4, 4, 1000, 1000, 16, True, None),
                     (1, 8, 2, 1000, 1000, 64, True, 50.0),
                     (1, 4, 4, 1, 1, 64, True, None),
                     (1, 4, 2, 100, 256, 64, False, None),
                     (1, 8, 8, 256, 256, 16, False, 30.0)]:
            recs.append(check_flash(torch, mods, *case, prec, timed=False,
                                    tag="small", seed=7)[0])
    return recs


# ---------------------------------------------------------------------------
# phase 3b: the landmark selectors' and the serving buckets' shapes
# ---------------------------------------------------------------------------


def bucket_call(mods, art, xp, *, plain=False):
    """(labels, score) of one bucket of a fused artifact, as
    ``serving.assign.run_bucket`` launches it (``ops.predict_assign``), or
    from its plain version ``ref.predict_assign_ref``."""
    a, s, rt = art.arrays, art.statics, art.runtime
    if art.kind == "sketch":
        args = (a["h"], a["sign"], a["v"], a["csq"])
        kw = dict(map_kind="sketch")
    else:
        args = (a["w"], rt.get("b", a["aux"]), a["v"], a["csq"])
        kw = {k: s[k] for k in ("map_kind", "gamma", "coef0", "degree",
                                "scale")}
    if plain:
        p = mods["precision"].resolve_precision(art.precision)
        return mods["ref"].predict_assign_ref(p.cast_tiles(xp), *args,
                                              precision=art.precision, **kw)
    return mods["ops"].predict_assign(xp, *args, precision=art.precision,
                                      tables=rt.get("tables"), **kw)


def garbage_tail(torch, x, bucket):
    """(rows of a bucket whose last quarter is rows of 1e6, the same bucket
    zero-padded, the real rows)."""
    real = max(1, bucket * 3 // 4)
    xp = x[:bucket].clone()
    xp[real:] = 1e6
    clean = x[:bucket].clone()
    clean[real:] = 0.0
    return xp, clean, real


def check_bucket(torch, mods, art, x, bucket):
    """ops.predict_assign at a bucket shape (the serving hot path) against
    its plain version on the same rows, with a garbage tail that must
    change no real label; timed on f32 rows (the wrapper's cast
    included)."""
    ref = mods["ref"]
    p = mods["precision"].resolve_precision(art.precision)
    sketch = art.kind == "sketch"
    name = "sketch_assign" if sketch else "embed_assign"
    check(x.shape[0] >= bucket, f"{x.shape[0]} rows for bucket {bucket}")
    xp, clean, real = garbage_tail(torch, x, bucket)
    (lab, score), (lab_p, score_p) = (bucket_call(mods, art, xp),
                                      bucket_call(mods, art, xp, plain=True))
    lab_clean = bucket_call(mods, art, clean)[0]
    torch.cuda.synchronize()
    a, st = art.arrays, art.statics
    xc = p.cast_tiles(xp)
    if sketch:
        full = ref.sketch_score_ref(xc, a["h"], a["sign"], a["v"], a["csq"],
                                    precision=p.tile)
    else:
        full = ref.embed_score_ref(
            xc, a["w"], a["v"], a["csq"], b=art.runtime.get("b"),
            precision=p.tile, **{k: st[k] for k in ("map_kind", "gamma",
                                                    "coef0", "degree",
                                                    "scale")})
    err, rel = normwise(torch, score[:real], score_p[:real])
    bad, near = label_mismatches(torch, lab[:real], lab_p[:real],
                                 full[:real])
    trap = bool(torch.equal(lab[:real], lab_clean[:real]))
    n, d, m, c = bucket, art.in_dim, art.dim, art.n_clusters
    xf, v, csq = xp.float(), a["v"], a["csq"]
    if sketch:
        h, sgn = a["h"].long(), a["sign"].float()

        def library():
            z = torch.zeros(n, m, device=x.device).index_add_(
                1, h, xf * sgn[None])
            sc = csq[None] - 2.0 * (z @ v)
            return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
    else:
        wf = a["w"].float()
        wsq = torch.sum(wf * wf, dim=1)
        b = art.runtime.get("b")

        def library():
            e = xf @ wf.T
            if st["map_kind"] == "rff":
                e = st["scale"] * torch.cos(e + b)
            else:      # nystrom rbf
                d2 = torch.sum(xf * xf, 1)[:, None] + wsq[None] - 2.0 * e
                e = torch.exp(-st["gamma"] * d2.clamp_(min=0.0))
            sc = csq[None] - 2.0 * (e @ v)
            return torch.argmin(sc, dim=1), torch.amin(sc, dim=1)
    rec = {"kernel": name, "map": art.kind if sketch or st["map_kind"] ==
           "rff" else f"nystrom-{st['map_kind']}", "shape": [n, d, m],
           "C": c, "prec": art.precision, "tag": f"bucket-{bucket}",
           "real_rows": real, "max_abs_err": err, "rel_err": rel,
           "tol": TOL[name], "label_mismatch": bad, "near_ties": near,
           "garbage_tail_changes_no_label": trap,
           "ms": time_ms(torch, lambda: bucket_call(mods, art, xp), 20),
           "plain_ms": time_ms(torch, lambda: bucket_call(mods, art, xp,
                                                          plain=True), 20),
           "library_ms": time_ms(torch, library, 20)}
    rec["bound_ms"], rec["bound_by"] = work_bound(
        mods, name, n=n, d=d, m=m, c=c, prec=p.tile)
    print("check", json.dumps(rec))
    what = f"{name} {rec['map']} {art.precision} bucket {bucket}"
    check(rel <= TOL[name], f"{what}: rel err {rel:.3g} > {TOL[name]}")
    check(bad == 0, f"{what}: {bad} labels differ outside near-ties")
    check(trap, f"{what}: the garbage tail changed a real label")
    return rec


def serving_checks(torch, mods, x_tr, y_tr, x_te, gamma, x_rcv, y_rcv,
                   xr_te):
    """The shapes this slice adds: RLS's tile-body Gram at Fig.5's
    [60000, 320] x 784 rbf (the pilot's K(X, S)), timed; then at every
    bucket (1, 8, 64, 512) the fused serving kernels on frozen artifacts
    (embed_assign rff and Nystrom rbf at 784 -> 320, C = 10; sketch_assign
    at Tab.2's 256 -> 128, C = 50; f32 and bf16) and the exact kind's
    kernel_matrix column body at [M, 10] x 784 rbf, each against its plain
    version with a garbage tail."""
    approx, core, serving = mods["approx"], mods["core"], mods["serving"]
    sel = mods["selectors"]
    dev = x_tr.device
    spec = core.KernelSpec("rbf", gamma=gamma)
    n = x_tr.shape[0]
    pilot = sel.RLSSelector.pilot_indices(
        sel.keyed_uniform(0, 1, torch.arange(n, device=dev)), EMBED_DIM)
    recs = [check_kernel_matrix(torch, mods, x_tr, x_tr[pilot], "rbf",
                                gamma, "f32", timed=True)]
    check(recs[0]["body"] == "tile", "the RLS Gram took the column body")
    maps = [approx.make_rff(torch.Generator().manual_seed(3), x_tr.shape[1],
                            EMBED_DIM, spec, device=dev),
            approx.make_nystrom(torch.Generator().manual_seed(4), x_tr,
                                EMBED_DIM, spec),
            approx.make_count_sketch(torch.Generator().manual_seed(5),
                                     x_rcv.shape[1], SKETCH_DIM,
                                     core.KernelSpec("linear"), device=dev)]
    for fmap in maps:
        x, y, c, rows = ((x_rcv, y_rcv, RCV1_C, xr_te) if fmap.kind ==
                         "sketch" else (x_tr, y_tr, 10, x_te))
        cents, counts = class_means(torch, fmap(x), y, c)
        for prec in ("f32", "bf16"):
            art = serving.freeze_map(fmap, cents, counts, precision=prec)
            for bucket in BUCKETS:
                recs.append(check_bucket(torch, mods, art, rows, bucket))
    medoids = x_tr[:10]
    for bucket in BUCKETS:
        xp, clean, real = garbage_tail(torch, x_te, bucket)
        rec = check_kernel_matrix(torch, mods, xp, medoids, "rbf", gamma,
                                  "f32", timed=True)
        check(rec["body"] == "column", f"bucket {bucket}: the exact kind's "
                                       f"K took the {rec['body']} body")
        diag = spec.diag(medoids)
        labs = [core.predict(z, medoids, diag, spec=spec,
                             device=z.device)[:real]
                for z in (xp, clean)]
        check(bool(torch.equal(*labs)), f"exact bucket {bucket}: the "
                                        f"garbage tail changed a real label")
        recs.append(rec)
    return recs


# ---------------------------------------------------------------------------
# phase 4b: run G, assignment serving off frozen artifacts
# ---------------------------------------------------------------------------


def ragged_requests(np, n: int, seed: int) -> list:
    """Cut n rows into requests of 1..G_REQUEST_MAX rows: [(start, rows)]."""
    rng = np.random.default_rng(seed)
    out, start = [], 0
    while start < n:
        take = min(int(rng.integers(1, G_REQUEST_MAX + 1)), n - start)
        out.append((start, take))
        start += take
    return out


def serve_requests(svc, x, requests):
    """Submit every request, drain, return (labels by request, wall s)."""
    t0 = time.perf_counter()
    uids = [svc.submit(x[a:a + k]) for a, k in requests]
    done = svc.drain()
    return [done[u] for u in uids], time.perf_counter() - t0


def run_g(torch, np, mods, fits, x_te, xr_te):
    """Freeze the A fit (exact), D-rff, D-nystrom and E-sketch at f32 and
    D-rff-bf16 at bf16; serve each fit's test rows as a seeded ragged mix
    of requests of 1-700 rows through an AssignService (one captured CUDA
    graph per bucket). Every request is in the queue before the first
    tick, so FIFO packing fills the ticks with the rows and buckets of the
    offline predict's chunks: the labels must equal FitResult.predict's
    bitwise (the bf16 artifact: the offline predict at bf16), which
    launches the same buckets eagerly. Returns {(kernel, tile dtype or
    body): launches} of the services and the D-rff service for
    serve_bench."""
    ops, ref, serving = mods["ops"], mods["ref"], mods["serving"]
    launches = {}
    keep = None
    for name, prec in (("A", "f32"), ("D-rff", "f32"), ("D-nystrom", "f32"),
                       ("E-sketch", "f32"), ("D-rff-bf16", "bf16")):
        res = fits[name]
        x = xr_te if name == "E-sketch" else x_te
        art = serving.freeze(res, precision=prec)
        requests = ragged_requests(np, len(x), seed=len(name))
        cfg = serving.AssignServeConfig(max_queue_rows=len(x))
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        for k in ref.CALLS:
            ref.CALLS[k] = 0
        torch.cuda.synchronize()
        svc = serving.AssignService(art, cfg)
        got, wall = serve_requests(svc, x, requests)
        counts, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        offline = (res.predict(x) if prec == "f32" else
                   serving.predict_frozen(art, x)).cpu().numpy()
        wall_eager = time.perf_counter() - t0
        same = np.array_equal(np.concatenate(got), offline)
        kernel = {"exact": "kernel_matrix", "sketch": "sketch_assign"}.get(
            art.kind, "embed_assign")
        body = "column" if art.kind == "exact" else prec
        launches[kernel, body] = launches.get((kernel, body), 0) + \
            counts[kernel]
        rec = {"run": f"G-{name}", "kind": art.kind, "precision": prec,
               "requests": len(requests), "rows": len(x),
               "programs": svc.compiled_programs,
               "warm_s": svc.warm_seconds, "wall_s": wall,
               "rows_per_s": len(x) / wall, "eager_wall_s": wall_eager,
               "artifact_bytes": serving.artifact_nbytes(art),
               "equal_to_predict": same,
               "launches": counts, "plain_calls": calls}
        print("run", json.dumps(rec))
        check(svc.compiled_programs == len(BUCKETS),
              f"run G-{name}: {svc.compiled_programs} graphs")
        check(same, f"run G-{name}: the graph replays' labels differ from "
                    f"FitResult.predict's eager launches")
        check(counts[kernel] > 0, f"run G-{name}: {kernel} never launched")
        check(all(v == 0 for v in calls.values()),
              f"run G-{name}: a plain version ran on the card: {calls}")
        if name == "D-rff":
            keep = svc
    return launches, keep


def serve_bench_run(torch, mods, svc):
    """serve_bench's open loop on the D-rff service: BENCH_REQUESTS
    requests of 1 and of 64 rows at each of BENCH_QPS, the reference
    benchmark's rates; then the same loop labelling each request on
    arrival with the eager offline predict, beside it."""
    bench = mods["serve_bench"].bench
    rec = bench(svc, qps_levels=BENCH_QPS, row_sizes=(1, 64),
                n_req=BENCH_REQUESTS)
    rec_eager = bench(svc, qps_levels=BENCH_QPS, row_sizes=(1, 64),
                      n_req=BENCH_REQUESTS, eager=True)
    card = card_line()
    for what, r in (("graphs", rec), ("eager", rec_eager)):
        for name, cell in r["cells"].items():
            print(f"serve_bench {what} {name}: p50 {cell['p50_ms']!r} ms, "
                  f"p99 {cell['p99_ms']!r} ms, {cell['rows_per_s']!r} "
                  f"rows/s (compute p50 {cell['compute_p50_ms']!r} ms; "
                  f"{card})")
    print("serve_bench", json.dumps(rec))
    print("serve_bench eager", json.dumps(rec_eager))
    check(rec["compiled_programs"] == len(BUCKETS),
          f"serve_bench: {rec['compiled_programs']} graphs")
    return rec


# ---------------------------------------------------------------------------
# phase 4c: sparse rows and ingestion
# ---------------------------------------------------------------------------


class Interrupted(Exception):
    """Raised by a checkpoint callback to stop a fit mid-stream."""


def zero_counters(mods) -> None:
    for k in mods["ops"].LAUNCHES:
        mods["ops"].LAUNCHES[k] = 0
    for k in mods["ref"].CALLS:
        mods["ref"].CALLS[k] = 0


def stream_cuts(np, n: int, b: int) -> list:
    """Tab.2's streaming cut of n rows for B = b: 3b cut points drawn from
    default_rng(STREAM_SEED) -> [(start, stop)] of the ragged chunks."""
    rng = np.random.default_rng(STREAM_SEED)
    cuts = np.unique(rng.integers(0, n, size=3 * b))
    bounds = np.concatenate([[0], cuts, [n]])
    return [(int(a), int(z)) for a, z in zip(bounds[:-1], bounds[1:])
            if z > a]


class WaitedSource:
    """A batch source with the consumer's seconds waiting on it summed: the
    host clock around each ``next`` of its iterator. Closing closes the
    source."""

    def __init__(self, src):
        self.src, self.wait_s, self.batches = src, 0.0, 0

    def __iter__(self):
        it = iter(self.src)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.wait_s += time.perf_counter() - t0
            self.batches += 1
            yield batch

    def close(self):
        self.src.close()


def run_sparse(torch, mods, name, cfg, fit_fn, x_te, y_te, n_train):
    """One fit of the sparse-rows phase, as a user runs it: ``fit_fn()``
    (fit_dataset or fit over a source), then the test rows labelled with
    FitResult.predict. Prints the run line; returns (record, labels,
    result)."""
    ops, ref, core = mods["ops"], mods["ref"], mods["core"]
    zero_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels = res.predict(x_te).cpu().numpy()
    t2 = time.perf_counter()
    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    state = res.state
    cents = state.centroids if res.fmap is not None else state.medoids
    check(bool(torch.isfinite(cents).all())
          and cents.shape[0] == cfg.n_clusters,
          f"run {name}: centroids not finite or of the wrong shape")
    # the embedded merge counts rows (the exact one counts landmarks)
    check(res.fmap is None or int(state.cardinalities.sum()) == n_train,
          f"run {name}: the merge did not count every row once")
    check(len(labels) == len(y_te) and labels.min() >= 0
          and labels.max() < cfg.n_clusters, f"run {name}: bad labels")
    rec = {"run": name, "method": cfg.method, "B": cfg.n_batches,
           "sampling": cfg.sampling, "precision": cfg.precision,
           "wall_s": t2 - t0, "fit_s": t1 - t0, "label_s": t2 - t1,
           "inner_iters": [h.inner_iters for h in res.history],
           "max_inner_iters": cfg.max_inner_iters,
           "acc": core.clustering_accuracy(y_te, labels),
           "nmi": core.nmi(y_te, labels), "launches": launches,
           "plain_calls": calls}
    return rec, labels, res


def print_run(rec, **extra) -> None:
    rec.update(extra)
    print("run", json.dumps(rec))
    check(all(v == 0 for v in rec["plain_calls"].values()),
          f"run {rec['run']}: a plain version ran on the card: "
          f"{rec['plain_calls']}")


def same_fit(torch, a, b) -> bool:
    """Bitwise equal states (every tensor field) and iterations."""
    return ([h.inner_iters for h in a.history]
            == [h.inner_iters for h in b.history]
            and all(torch.equal(u, v) for u, v in zip(a.state[:-1],
                                                      b.state[:-1])))


def csr_sketch_checks(torch, np, mods, res, xs_tr, xs_te):
    """On CSR_CHECK_ROWS test rows: the O(nnz) count sketch against the
    dense CountSketchMap on the densified rows (z within CSR_Z_TOL), both
    timed; then the dense predict_embedded at the full vocabulary, which
    launches sketch_assign, against the CSR labels outside near-ties. This
    check's sketch_assign launches are printed on its check line only:
    they are not launches of the main path. Returns the record."""
    sparse, approx, ops = mods["sparse"], mods["approx"], mods["ops"]
    fmap, state = res.fmap, res.state
    rows = sparse.slice_rows(xs_te, 0, CSR_CHECK_ROWS).to("cuda")
    dense = sparse.to_dense(rows)
    z_csr = fmap(rows)
    z_dense = fmap(dense)                      # x @ the signed one-hot
    err, rel = normwise(torch, z_csr, z_dense)
    check(rel <= CSR_Z_TOL, f"E-csr: the CSR sketch is {rel} from the dense "
                            f"map (tol {CSR_Z_TOL})")
    ms_csr = time_ms(torch, lambda: fmap(rows), 20)
    ms_dense = time_ms(torch, lambda: fmap(dense), 20)
    before = ops.LAUNCHES["sketch_assign"]
    lab_kernel = approx.predict_embedded(dense, state, fmap)
    launched = ops.LAUNCHES["sketch_assign"] - before
    lab_csr = approx.predict_embedded(rows, state, fmap)
    bad, near = label_mismatches(torch, lab_kernel, lab_csr,
                                 embedded_d2(torch, z_csr, state))
    rec = {"check": "E-csr sketch", "rows": CSR_CHECK_ROWS,
           "vocab": RCV1_VOCAB, "m": fmap.m, "z_max_abs_err": err,
           "z_normwise": rel, "csr_sketch_ms": ms_csr,
           "dense_map_ms": ms_dense, "sketch_assign_launches": launched,
           "label_mismatches": bad, "near_ties": near}
    print("check", json.dumps(rec))
    check(launched > 0, "E-csr: the dense predict launched no sketch_assign")
    check(bad == 0, f"E-csr: the dense sketch_assign predict differs from "
                    f"the CSR labels on {bad} rows outside near-ties")
    return rec


def embedded_d2(torch, z, state):
    """The plain squared distances [n, C] of embedded rows to a state's
    centroids, +1e30 on empty clusters (the near-tie reference)."""
    c = state.centroids
    d2 = (torch.sum(z * z, 1)[:, None] + torch.sum(c * c, 1)[None]
          - 2.0 * z @ c.T)
    return torch.where(state.cardinalities[None] > 0, d2,
                       torch.full_like(d2, 1e30))


def garbage_csr(torch, mods, piece, bucket):
    """The clean padded bucket of a CSR piece, and the same bucket with its
    padded rows holding 1e6 values and its slack slots 1e6 values in the
    last column."""
    sparse = mods["sparse"]
    clean = mods["assign"]._pad_csr(piece, bucket)
    junk_rows = bucket - len(piece)
    junk = torch.full((junk_rows, piece.shape[1]), 0.0)
    junk[:, ::997] = 1e6
    trapped = sparse.concat_csr([piece, sparse.csr_from_dense(junk)])
    trapped = sparse.pad_csr_capacity([trapped],
                                      nnz_multiple=max(clean.nnz, 1))[0]
    k = sparse.stored(trapped)
    trapped.data[k:] = 1e6
    trapped.indices[k:] = piece.shape[1] - 1
    return clean, trapped


def run_g_csr(torch, np, mods, res_csr, res_rff, xs_te, x_te):
    """Run G over CSR requests: E-csr's B = 4 fit frozen at f32 and served
    by an AssignService a seeded ragged mix of 1-700-row CSR requests
    (labels bitwise equal to predict_frozen on the same rows; padded rows
    and slack slots holding garbage change no real label); then CSR
    requests to D-rff's artifact (densified at ingestion) against the same
    rows sent dense. The counters are zeroed just before each CSR service
    and read just after it; no plain version may run in either. Returns
    the launches of embed_assign (f32) by the D-rff CSR service."""
    serving, sparse = mods["serving"], mods["sparse"]
    ops, ref = mods["ops"], mods["ref"]
    art = serving.freeze(res_csr)
    requests = ragged_requests(np, len(xs_te), seed=11)
    cfg = serving.AssignServeConfig(max_queue_rows=len(xs_te))
    zero_counters(mods)
    torch.cuda.synchronize()
    svc = serving.AssignService(art, cfg)
    got, wall = serve_requests(
        svc, _SliceRows(sparse, xs_te), requests)
    counts, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    want = serving.predict_frozen(art, xs_te).cpu().numpy()
    same = np.array_equal(np.concatenate(got), want)
    trap_ok = True
    for take in (1, 5, 8, 63, 300, 512):
        piece = sparse.slice_rows(xs_te, 100, 100 + take)
        clean, trapped = garbage_csr(
            torch, mods, piece, serving.bucket_for(take, BUCKETS))
        a = mods["assign"].run_csr_bucket(art, clean.to("cuda"))[:take]
        b = mods["assign"].run_csr_bucket(art, trapped.to("cuda"))[:take]
        trap_ok &= bool(torch.equal(a, b))
    # the O(nnz) sketch program has no kernel, as in the reference
    print_run({"run": "G-E-csr", "kind": art.kind,
               "requests": len(requests), "rows": len(xs_te), "wall_s": wall,
               "rows_per_s": len(xs_te) / wall,
               "graphs": svc.compiled_programs,
               "equal_to_predict_frozen": same,
               "garbage_padding_inert": trap_ok, "launches": counts,
               "plain_calls": calls})
    check(same, "run G-E-csr: the service's CSR labels differ from "
                "predict_frozen's")
    check(trap_ok, "run G-E-csr: garbage in the padded rows or slack slots "
                   "changed a real label")
    art = serving.freeze(res_rff)
    requests = ragged_requests(np, len(x_te), seed=12)
    cfg = serving.AssignServeConfig(max_queue_rows=len(x_te))
    dense, _ = serve_requests(serving.AssignService(art, cfg), x_te,
                              requests)
    csr_rows = _SliceRows(sparse, sparse.csr_from_dense(x_te))
    svc = serving.AssignService(art, cfg)
    zero_counters(mods)
    torch.cuda.synchronize()
    got, wall = serve_requests(svc, csr_rows, requests)
    counts, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    same = np.array_equal(np.concatenate(got), np.concatenate(dense))
    print_run({"run": "G-D-rff-csr", "kind": art.kind,
               "requests": len(requests), "rows": len(x_te), "wall_s": wall,
               "equal_to_dense_requests": same, "launches": counts,
               "plain_calls": calls})
    check(same, "run G-D-rff-csr: CSR requests label unlike the same rows "
                "sent dense")
    check(counts["embed_assign"] > 0,
          "run G-D-rff-csr: the CSR service launched no embed_assign")
    return counts["embed_assign"]


class _SliceRows:
    """Row slices ``x[a:b]`` of a CSR batch, as ``serve_requests`` takes
    them from a dense array."""

    def __init__(self, sparse, batch):
        self.sparse, self.batch = sparse, batch

    def __len__(self):
        return len(self.batch)

    def __getitem__(self, s):
        return self.sparse.slice_rows(self.batch, s.start, s.stop)


def sparse_runs(torch, np, mods, x_tr, x_te, y_te, spec, res_rff):
    """Phase 4c: E-csr (B = 4, 16, 64 and B = 4's repeat), E-csr-stream
    and its resume, H-stream, G-E-csr. Returns (totals, bodies) of the
    launches and E-csr-stream's fit, data and config (the mesh phase's
    reference)."""
    core, sparse, synth = mods["core"], mods["sparse"], mods["synthetic"]
    loader = mods["loader"]
    t0 = time.perf_counter()
    xs, ys = synth.make_rcv1_sparse(RCV1_TRAIN + RCV1_TEST,
                                    vocab=RCV1_VOCAB, n_classes=RCV1_C,
                                    seed=0)
    xs_tr = sparse.slice_rows(xs, 0, RCV1_TRAIN)
    xs_te = sparse.slice_rows(xs, RCV1_TRAIN, RCV1_TRAIN + RCV1_TEST)
    ys_te = ys[RCV1_TRAIN:]
    nnz_row = xs.nnz / len(xs)
    print(f"data: rcv1 CSR {xs.shape}, {xs.nnz} stored, {nnz_row!r} a row "
          f"(generator {time.perf_counter() - t0:.1f} s)")
    totals = {"kernel_matrix": 0, "assign_fused": 0, "embed_assign": 0}
    bodies = {("kernel_matrix", "column"): 0, ("assign_fused", "f32"): 0,
              ("embed_assign", "f32"): 0}

    def count(rec):
        for k in totals:
            totals[k] += rec["launches"][k]
        bodies["kernel_matrix", "column"] += \
            rec["launches"]["kernel_matrix_column"]
        bodies["assign_fused", "f32"] += rec["launches"]["assign_fused"]

    base = dict(n_clusters=RCV1_C, kernel=core.KernelSpec("linear"), seed=0,
                method="sketch", embed_dim=CSR_DIM)
    fits = {}
    for b in CSR_BS + (4,):
        name = f"E-csr-B{b}" + ("-repeat" if f"E-csr-B{b}" in fits else "")
        cfg = core.MiniBatchConfig(n_batches=b, **base)
        rec, labels, res = run_sparse(
            torch, mods, name, cfg, lambda: core.fit_dataset(xs_tr, cfg),
            xs_te, ys_te, RCV1_TRAIN)
        print_run(rec, nnz_per_row=nnz_row)
        count(rec)
        fits[name] = (res, labels)
    (r1, l1), (r2, l2) = fits["E-csr-B4"], fits["E-csr-B4-repeat"]
    check(same_fit(torch, r1, r2) and np.array_equal(l1, l2),
          "E-csr is not repeatable: two fits of one seed differ")
    csr_sketch_checks(torch, np, mods, r1, xs_tr, xs_te)

    # E-csr-stream: the training rows as Tab.2's ragged chunk stream
    cfg = core.MiniBatchConfig(n_batches=4, sampling="block", **base)
    cuts = stream_cuts(np, RCV1_TRAIN, 4)

    def source():
        return loader.BatchSource.from_stream(
            (sparse.slice_rows(xs_tr, a, z) for a, z in cuts),
            RCV1_TRAIN // 4, prefetch=2)

    waited = WaitedSource(source())
    rec, l_stream, r_stream = run_sparse(
        torch, mods, "E-csr-stream", cfg, lambda: core.fit(waited, cfg),
        xs_te, ys_te, RCV1_TRAIN)
    count(rec)
    r_off = core.fit_dataset(xs_tr, cfg)
    l_off = r_off.predict(xs_te).cpu().numpy()
    offline = same_fit(torch, r_stream, r_off) and np.array_equal(
        l_stream, l_off)
    saved = {}

    def crash(state, i):
        saved[i] = state
        if i == 1:
            raise Interrupted

    try:
        core.fit(source(), cfg, checkpoint_cb=crash)
    except Interrupted:
        pass
    check(saved[1].batches_done == 2, "E-csr-stream: no state after batch 2")
    resumed = core.fit(source().skip(2), cfg, state=saved[1],
                       fmap=r_stream.fmap)
    l_res = resumed.predict(xs_te).cpu().numpy()
    resume_ok = ([h.inner_iters for h in resumed.history]
                 == [h.inner_iters for h in r_stream.history][2:]
                 and all(torch.equal(u, v) for u, v in
                         zip(resumed.state[:-1], r_stream.state[:-1]))
                 and np.array_equal(l_res, l_stream))
    print_run(rec, chunks=len(cuts), nnz_per_row=nnz_row,
              wait_s=waited.wait_s, batches=waited.batches,
              equal_to_offline_block_split=offline,
              resume_after_2_equal=resume_ok)
    check(offline, "E-csr-stream: the streamed fit's labels differ from the "
                   "offline block split's")
    stream = {"cfg": cfg, "cuts": cuts, "res": r_stream, "labels": l_stream,
              "xs_tr": xs_tr, "xs_te": xs_te, "ys_te": ys_te}
    check(resume_ok, "E-csr-stream: the fit resumed by skip(2) differs from "
                     "the uninterrupted one")

    # H-stream: Tab.1's training rows as a ragged dense chunk stream into
    # the exact fused fit
    cfg = core.MiniBatchConfig(n_clusters=10, n_batches=4, s=0.2, kernel=spec,
                               seed=0, engine="fused", sampling="block")
    cuts_h = stream_cuts(np, len(x_tr), 4)
    waited = WaitedSource(loader.BatchSource.from_stream(
        (x_tr[a:z] for a, z in cuts_h), len(x_tr) // 4, prefetch=2))
    rec, l_h, r_h = run_sparse(torch, mods, "H-stream", cfg,
                               lambda: core.fit(waited, cfg), x_te, y_te,
                               len(x_tr))
    count(rec)
    r_off = core.fit_dataset(x_tr, cfg)
    l_off = r_off.predict(x_te).cpu().numpy()
    same = same_fit(torch, r_h, r_off) and np.array_equal(l_h, l_off)
    print_run(rec, chunks=len(cuts_h), wait_s=waited.wait_s,
              batches=waited.batches, equal_to_offline_block_split=same)
    check(same, "H-stream: the streamed exact fit differs from fit_dataset's "
                "block split")
    check(rec["launches"]["assign_fused"] > 0
          and rec["launches"]["kernel_matrix_column"] > 0,
          "H-stream: assign_fused or the column body never launched")

    launched = run_g_csr(torch, np, mods, r1, res_rff, xs_te, x_te)
    totals["embed_assign"] += launched
    bodies["embed_assign", "f32"] += launched
    return totals, bodies, stream


# ---------------------------------------------------------------------------
# phase 4d: the mesh (a world of one over NCCL)
# ---------------------------------------------------------------------------


class CollectiveCount:
    """Counts the mesh's collectives: a wrapper around
    ``torch.distributed.all_gather_into_tensor`` and ``all_reduce``, the two
    calls the runtime makes (``distributed/mesh.py``)."""

    def __init__(self, dist):
        self.dist = dist
        self.real = (dist.all_gather_into_tensor, dist.all_reduce)
        self.reset()

        def ag(*a, **k):
            self.n["all_gather"] += 1
            return self.real[0](*a, **k)

        def ar(*a, **k):
            self.n["all_reduce"] += 1
            return self.real[1](*a, **k)
        dist.all_gather_into_tensor, dist.all_reduce = ag, ar

    def reset(self):
        self.n = {"all_gather": 0, "all_reduce": 0}

    def close(self):
        self.dist.all_gather_into_tensor, self.dist.all_reduce = self.real


def run_mesh(torch, mods, count, name, fit_fn, x_te, y_te):
    """One fit of the mesh phase: the counters and the collective count set
    to 0 just before ``fit_fn()``, the test rows labelled by
    FitResult.predict, both read just after. -> (record, labels, result)."""
    ops, ref, core = mods["ops"], mods["ref"], mods["core"]
    zero_counters(mods)
    count.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels = res.predict(x_te).cpu().numpy()
    t2 = time.perf_counter()
    rec = {"run": name, "world": 1, "mesh": {"data": 1, "model": 1},
           "wall_s": t2 - t0, "fit_s": t1 - t0, "label_s": t2 - t1,
           "inner_iters": [h.inner_iters for h in res.history],
           "acc": core.clustering_accuracy(y_te, labels),
           "nmi": core.nmi(y_te, labels), "collectives": dict(count.n),
           "launches": dict(ops.LAUNCHES), "plain_calls": dict(ref.CALLS)}
    return rec, labels, res


def mesh_phase(torch, np, mods, x_tr, x_te, y_te, spec, runs, fits, stream):
    """Phase 4d: the mesh on the card's world of one over NCCL, a (1, 1)
    (data, model) DeviceMesh: M-B (as run B-fused, through
    DistributedMiniBatchKMeans), M-inner (batch 0 of M-B: the distributed
    inner loop against the single-host one), M-B-sstep (s_step = 2),
    M-D-rff (DistributedEmbedKMeans with D-rff's map), M-E-csr-stream
    (E-csr-stream's rows and map through DistributedEmbedKMeans.source;
    the dense predict at the full vocabulary; the frozen artifact serving
    dense requests through its graphs) and M-elastic (M-B failed after
    batch 2 and resumed by ElasticClusteringRunner from its checkpoint).
    Returns (totals, bodies, records) of the launches and checks."""
    import datetime
    import os
    import tempfile
    dist = torch.distributed
    core, dm, ft, sparse = mods["core"], mods["dmesh"], mods["ft"], \
        mods["sparse"]
    approx, serving, ops = mods["approx"], mods["serving"], mods["ops"]
    totals = {"kernel_matrix": 0, "assign_fused": 0, "embed_assign": 0,
              "sketch_assign": 0}
    bodies = {("kernel_matrix", "column"): 0, ("assign_fused", "f32"): 0,
              ("embed_assign", "f32"): 0, ("sketch_assign", "f32"): 0}
    recs = []

    def count_launches(rec, body_of=None):
        for k in totals:
            totals[k] += rec["launches"][k]
        bodies["kernel_matrix", "column"] += \
            rec["launches"]["kernel_matrix_column"]
        bodies["assign_fused", "f32"] += rec["launches"]["assign_fused"]
        bodies["embed_assign", "f32"] += rec["launches"]["embed_assign"]
        bodies["sketch_assign", "f32"] += rec["launches"]["sketch_assign"]

    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=120))
    count = CollectiveCount(dist)
    mesh = dm.make_test_mesh({"data": 1, "model": 1})
    print(f"mesh: {mesh} over {dist.get_backend()}")

    # M-B: Tab.1 as run B-fused, on the mesh
    cfg_b = core.MiniBatchConfig(n_clusters=10, n_batches=4, s=0.2,
                                 kernel=spec, seed=0, engine="fused")
    batches = mods["sampling"].split_batches(x_tr, 4, strategy="stride")
    rec, lab_b, res_b = run_mesh(
        torch, mods, count, "M-B",
        lambda: dm.DistributedMiniBatchKMeans(mesh, cfg_b).fit(batches),
        x_te, y_te)
    iters = rec["inner_iters"]
    b = len(iters)
    # a sync a loop body plus the prologue's; the argmins' gathers
    want = {"all_gather": sum(iters) + b + 1 + 2 * (b - 1),
            "all_reduce": sum(iters) + b}
    ref_b = runs["B-fused"][0]
    print_run(rec, syncs=[i + 1 for i in iters], want_collectives=want,
              b_fused_acc=ref_b["acc"], b_fused_nmi=ref_b["nmi"])
    count_launches(rec)
    check(rec["collectives"] == want, f"M-B: collectives {rec['collectives']}"
                                      f", want {want}")
    check(abs(rec["acc"] - ref_b["acc"]) <= 0.02
          and abs(rec["nmi"] - ref_b["nmi"]) <= 0.02,
          f"M-B: acc {rec['acc']} / NMI {rec['nmi']} not within 0.02 of "
          f"B-fused's {ref_b['acc']} / {ref_b['nmi']}")
    check(rec["launches"]["assign_fused"] > 0
          and rec["launches"]["kernel_matrix"] > 0,
          "M-B: assign_fused or kernel_matrix never launched")

    # M-inner: batch 0 of M-B, its landmarks and u0, the distributed inner
    # loop against the single-host kkmeans_fit
    init = mods["init"]
    km = dm.DistributedMiniBatchKMeans(mesh, cfg_b)
    x0_host = torch.as_tensor(batches[0])
    x0 = x0_host.cuda()
    gen = mods["minibatch"].batch_generator(cfg_b.seed, 0)
    l_idx, _ = km._choose_landmarks(gen, x0_host, 0)
    l_idx = l_idx.cuda()
    lm, diag = x0[l_idx], spec.diag(x0)
    seeds = init.kmeans_pp_indices(lm, spec.diag(lm), gen, n_clusters=10,
                                   spec=spec)
    u0, _ = init.assign_to_medoids(x0, diag, lm[seeds], spec.diag(lm[seeds]),
                                   spec=spec)
    zero_counters(mods)
    count.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dm.distributed_kkmeans_fit(mesh, x0, lm, l_idx, diag, u0,
                                     cfg=km.inner_cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rec = {"run": "M-inner", "world": 1, "rows": len(x0),
           "landmarks": len(l_idx), "fit_s": t1 - t0,
           "collectives": dict(count.n), "launches": dict(ops.LAUNCHES),
           "plain_calls": dict(mods["ref"].CALLS)}
    host = mods["kkmeans"].kkmeans_fit(
        x0, l_idx, diag, u0, spec=spec, n_clusters=10, max_iters=100,
        engine=core.GramEngine("fused"))
    torch.cuda.synchronize()
    d = torch.where(host.counts[None] > 0, host.g[None] - 2.0 * host.f,
                    torch.full_like(host.f, 1e30))
    bad, near = label_mismatches(torch, got.labels, host.labels, d)
    print_run(rec, syncs=got.n_iter + 1, iters=got.n_iter,
              host_iters=host.n_iter, host_s=time.perf_counter() - t1,
              label_mismatches=bad, near_ties=near,
              g_max_abs_err=float((got.g - host.g).abs().max()))
    count_launches(rec)
    check(bad == 0, f"M-inner: {bad} labels differ from the single-host "
                    f"inner loop outside near-ties")
    check(rec["collectives"] == {"all_gather": got.n_iter + 1,
                                 "all_reduce": got.n_iter + 1},
          f"M-inner: {rec['collectives']} for {got.n_iter} syncs")

    # M-B-sstep: two Lloyd steps a sync (at world 1 a refinement is global)
    cfg_s = dataclasses.replace(cfg_b, s_step=2)
    rec, lab_s, res_s = run_mesh(
        torch, mods, count, "M-B-sstep",
        lambda: dm.DistributedMiniBatchKMeans(mesh, cfg_s).fit(batches),
        x_te, y_te)
    st = res_b.state
    xt = torch.as_tensor(x_te, device="cuda")
    d2 = (spec.diag(xt)[:, None] + st.medoid_diag[None]
          - 2.0 * spec(xt, st.medoids).float())
    bad, near = label_mismatches(torch, torch.as_tensor(lab_s),
                                 torch.as_tensor(lab_b), d2.cpu())
    syncs_ok = all(s_ <= -(-i // 2) + 2 for s_, i in
                   zip(rec["inner_iters"], iters))
    print_run(rec, s_step=2, m_b_iters=iters, label_mismatches=bad,
              near_ties=near)
    count_launches(rec)
    check(bad == 0, f"M-B-sstep: {bad} test labels differ from M-B's "
                    f"outside near-ties")
    check(syncs_ok, f"M-B-sstep: syncs {rec['inner_iters']} exceed half of "
                    f"M-B's {iters} + 2")

    # M-D-rff: Fig.5 through DistributedEmbedKMeans with D-rff's map
    res_d = fits["D-rff"]
    cfg_d = core.MiniBatchConfig(n_clusters=10, n_batches=1, kernel=spec,
                                 seed=0, embed_dim=EMBED_DIM, method="rff")
    rec, lab_d, _ = run_mesh(
        torch, mods, count, "M-D-rff",
        lambda: dm.DistributedEmbedKMeans(mesh, cfg_d,
                                          fmap=res_d.fmap).fit([x_tr]),
        x_te, y_te)
    agree = float((lab_d == runs["D-rff"][1]).mean())
    iters_d = rec["inner_iters"]
    want = {"all_gather": 1, "all_reduce": sum(iters_d) + len(iters_d)}
    print_run(rec, agreement_with_d_rff=agree, want_collectives=want,
              all_reduce_per_sweep=(rec["collectives"]["all_reduce"]
                                    - len(iters_d)) / max(sum(iters_d), 1))
    count_launches(rec)
    check(agree >= 0.995, f"M-D-rff: test labels agree with D-rff's on "
                          f"{agree} < 0.995")
    check(rec["collectives"] == want,
          f"M-D-rff: collectives {rec['collectives']}, want {want} (one "
          f"all_reduce a Lloyd sweep)")

    # M-E-csr-stream: Tab.2's sparse stream on the mesh, with E-csr-stream's
    # map; the dense predict at the full vocabulary; the frozen artifact
    res_e, cfg_e = stream["res"], stream["cfg"]
    xs_tr, xs_te, ys_te = stream["xs_tr"], stream["xs_te"], stream["ys_te"]
    km_e = dm.DistributedEmbedKMeans(mesh, cfg_e, fmap=res_e.fmap)

    def fit_stream():
        chunks = (sparse.slice_rows(xs_tr, a, z) for a, z in stream["cuts"])
        return km_e.fit(km_e.source(mods["sampling"].stream_blocks(
            chunks, RCV1_TRAIN // 4), depth=2))
    rec, lab_e, res_m = run_mesh(torch, mods, count, "M-E-csr-stream",
                                 fit_stream, xs_te, ys_te)
    rows_te = xs_te.to("cuda")
    z_te = res_e.fmap(rows_te)
    bad_s, near_s = label_mismatches(
        torch, torch.as_tensor(lab_e), torch.as_tensor(stream["labels"]),
        embedded_d2(torch, z_te, res_e.state).cpu())
    dense_te = sparse.to_dense(rows_te)
    # the dense predict of the test rows at the full vocabulary: a path of
    # its own, its counters set to 0 just before it and read just after
    zero_counters(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab_dense = approx.predict_embedded(dense_te, res_m.state, res_m.fmap)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    launched = ops.LAUNCHES["sketch_assign"]
    rec["launches"]["sketch_assign"] += launched
    for k, v in mods["ref"].CALLS.items():
        rec["plain_calls"][k] += v
    lab_csr = approx.predict_embedded(rows_te, res_m.state, res_m.fmap)
    bad_d, near_d = label_mismatches(torch, lab_dense, lab_csr,
                                     embedded_d2(torch, z_te, res_m.state))
    print_run(rec, vocab=RCV1_VOCAB, m=res_m.fmap.m,
              label_mismatches_vs_e_csr_stream=bad_s, near_ties=near_s,
              dense_predict_s=dense_s, dense_sketch_assign_launches=launched,
              dense_vs_csr_mismatches=bad_d, dense_near_ties=near_d)
    count_launches(rec)
    check(bad_s == 0, f"M-E-csr-stream: {bad_s} test labels differ from "
                      f"E-csr-stream's outside near-ties")
    check(launched > 0, "M-E-csr-stream: the dense predict at the full "
                        "vocabulary launched no sketch_assign")
    check(bad_d == 0, f"M-E-csr-stream: the dense predict differs from the "
                      f"CSR labels on {bad_d} rows outside near-ties")
    check(rec["collectives"]["all_gather"] == 1,
          f"M-E-csr-stream: {rec['collectives']}")
    # sketch_assign at the full vocabulary against its plain version
    for prec in ("f32", "bf16"):
        recs.append(check_embedded(
            torch, mods, dense_te, res_m.fmap, res_m.state.centroids,
            res_m.state.cardinalities, prec, timed=True, tag="full-width"))
    # the frozen artifact serves dense requests through its graphs
    art = serving.freeze(res_m)
    dense_np = dense_te[:MESH_SERVE_ROWS].cpu().numpy()
    svc = serving.AssignService(art, serving.AssignServeConfig(
        max_queue_rows=MESH_SERVE_ROWS))
    zero_counters(mods)
    got, wall = serve_requests(svc, dense_np,
                               ragged_requests(np, MESH_SERVE_ROWS, seed=13))
    served = dict(ops.LAUNCHES)
    got = np.concatenate(got)
    want = serving.predict_frozen(art, dense_te[:MESH_SERVE_ROWS]).cpu()
    print_run({"run": "M-E-serve", "kind": art.kind, "in_dim": art.in_dim,
               "graphs": svc.compiled_programs, "rows": MESH_SERVE_ROWS,
               "wall_s": wall, "equal_to_predict_frozen":
               bool(np.array_equal(got, want.numpy())),
               "equal_to_csr_labels": bool(np.array_equal(
                   got, lab_csr[:MESH_SERVE_ROWS].cpu().numpy())),
               "launches": served, "plain_calls": dict(mods["ref"].CALLS)})
    totals["sketch_assign"] += served["sketch_assign"]
    bodies["sketch_assign", "f32"] += served["sketch_assign"]
    check(svc.compiled_programs == len(BUCKETS),
          f"M-E-serve: {svc.compiled_programs} graphs, not {len(BUCKETS)}")
    check(np.array_equal(got, want.numpy()),
          "M-E-serve: the graphs' labels differ from predict_frozen's")
    check(served["sketch_assign"] > 0, "M-E-serve: no sketch_assign replay")
    del dense_te, dense_np, svc, art

    # M-elastic: M-B failed after batch 2, resumed from its checkpoint
    ckpt = ft.CheckpointManager(os.path.join(tmp, "ckpt"))
    runner = ft.ElasticClusteringRunner(cfg_b, ckpt)
    failed = False
    try:
        runner.run(mesh, batches, fail_after=2)
    except ft.SimulatedFailure:
        failed = True
    rec, _, res_r = run_mesh(torch, mods, count, "M-elastic",
                             lambda: runner.run(mesh, batches), x_te, y_te)
    same = all(torch.equal(u, v) for u, v in zip(res_r.state[:3],
                                                 res_b.state[:3]))
    print_run(rec, failed_after=2, committed_step=ckpt.latest_step(),
              bitwise_equal_to_m_b=same)
    count_launches(rec)
    check(failed and same and res_r.state.batches_done == 4,
          "M-elastic: the resumed fit differs from M-B")
    count.close()
    # the world stays up for phase 4e's mesh runs; main destroys it
    return totals, bodies, recs


# ---------------------------------------------------------------------------
# phase 4e: the flight recorder (repro_torch.obs)
# ---------------------------------------------------------------------------


def fresh_peak(torch) -> int:
    """Reset the allocator's peak; -> the bytes allocated now, the
    baseline a fit's watermarks are read against."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def watermark_lines(export, path: str, name: str, base: int) -> list:
    """Print each batch's allocator bytes (now and the peak since the
    fit's start) beside the planner's predicted bytes from a recorder's
    log, and both less ``base``, what was allocated before the fit; ->
    the records."""
    marks = [e for e in export.read_events(path)
             if e.get("name") == "hbm_watermark"]
    for m in marks:
        print(f"obs {name} batch {m['batch']}: measured_bytes "
              f"{m['measured_bytes']} peak_bytes {m['peak_bytes']} "
              f"predicted_bytes {m['predicted_bytes']!r} ({m['source']}); "
              f"less the {base} bytes held before the fit: "
              f"{m['measured_bytes'] - base} now, "
              f"{m['peak_bytes'] - base} peak")
    check(len(marks) > 0 and all(m["source"] == "device" for m in marks),
          f"obs {name}: no watermark read the card's allocator")
    return marks


def obs_phase(torch, np, mods, x_tr, y_tr, x_te, y_te, spec, runs, fits,
              stream):
    """Phase 4e: the main path with the flight recorder on. B-fused off,
    on, on, off (labels, medoids and launches equal; the wall overhead)
    and a batch's hooks timed alone;
    D-rff on (labels equal run D-rff's); M-B on in the world phase 4d left
    up (each batch's collectives/* counters equal the wrapper's count of
    that batch's inner fit); E-csr-stream and H-stream on with prefetch=2
    (equal to the unrecorded fits; the summed stage and starve seconds);
    serve_bench on G-D-rff's artifact with and without a recorder (the
    same graphs; p50s and the queue / compute split); launch.cluster at
    Tab.1's size with --obs and --profile (the trace names
    obs:engine_stats[fused] and the assign kernel). Every fit prints its
    batches' allocator bytes beside the planner's. Returns (totals,
    bodies) of the launches."""
    import os
    import tempfile
    obs, core, loader, sparse = mods["obs"], mods["core"], mods["loader"], \
        mods["sparse"]
    dm, serving, ops, export = mods["dmesh"], mods["serving"], mods["ops"], \
        mods["obs"].export
    totals = {"kernel_matrix": 0, "assign_fused": 0, "embed_assign": 0}
    bodies = {("kernel_matrix", "column"): 0, ("assign_fused", "f32"): 0,
              ("embed_assign", "f32"): 0}

    def count(launches):
        for k in totals:
            totals[k] += launches[k]
        bodies["kernel_matrix", "column"] += launches["kernel_matrix_column"]
        bodies["assign_fused", "f32"] += launches["assign_fused"]
        bodies["embed_assign", "f32"] += launches["embed_assign"]

    tmp = tempfile.mkdtemp()

    def recorder(name):
        path = os.path.join(tmp, f"{name}.jsonl")
        return obs.JsonlRecorder(path, header=export.run_header(
            device="cuda", entry="chip_smoke", run=name)), path

    # what a span costs with no profiler running
    n_spans = 20000
    t0 = time.perf_counter()
    for _ in range(n_spans):
        with obs.span("obs:cost_probe"):
            pass
    span_us = (time.perf_counter() - t0) / n_spans * 1e6
    print(f"obs span cost: {span_us!r} us a span, no profiler "
          f"({n_spans} spans)")

    # B-fused with the recorder off and on, twice
    cfg_b = core.MiniBatchConfig(n_clusters=10, n_batches=4, s=0.2,
                                 kernel=spec, seed=0, engine="fused")
    got = []
    for k, on in enumerate((False, True, True, False)):
        name = f"O-B-fused-{'on' if on else 'off'}"
        rec, path = recorder(f"{name}-{k}") if on else (None, None)
        base = fresh_peak(torch)
        r, labels, res = run_fit(torch, mods, name, cfg_b, x_tr, x_te, y_te,
                                 recorder=rec)
        count(r["launches"])
        if rec is not None:
            rec.close()
            watermark_lines(export, path, name, base)
            costs = [e["value"] for e in export.read_events(path)
                     if e.get("name") == "inner/cost"]
            check(costs == [h.cost for h in res.history],
                  f"{name}: drained costs {costs} differ from the history")
        got.append((r, labels, res))
    (r0, l0, f0), (r1, l1, f1) = got[0], got[1]
    same = (all(np.array_equal(l0, g[1]) for g in got)
            and all(torch.equal(f0.state.medoids, g[2].state.medoids)
                    for g in got)
            and all(g[0]["launches"] == r0["launches"] for g in got))
    fits_off = [got[0][0]["fit_s"], got[3][0]["fit_s"]]
    fits_on = [got[1][0]["fit_s"], got[2][0]["fit_s"]]
    iters = sum(r0["inner_iters"])
    print(f"obs B-fused fit s off {fits_off!r} on {fits_on!r} (order off, "
          f"on, on, off): overhead {(sum(fits_on) - sum(fits_off)) / sum(fits_off)!r} "
          f"({iters} inner iterations; {card_line()})")
    check(same, "O-B-fused: the recorder changed the labels, the medoids "
                "or the launches")

    # the hooks of one exact batch alone, on a cost already on the card
    rec, path = recorder("O-hooks")
    cost = torch.ones((), device="cuda")
    n_hooks = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_hooks):
        rec.series("inner/cost", cost, batch=i)
        rec.series("inner/iters", 11, batch=i)
        rec.series("batch/wall_seconds", 0.06, batch=i, rows=15000)
        rec.gauge("clusters/empty", 0, batch=i)
        rec.gauge("medoids/mean_displacement", 0.01, batch=i)
        obs.memory.watermark(rec, batch=i, device="cuda", engine="fused",
                             predicted_bytes=1.0)
        rec.batch_boundary(i)
    hooks_ms = (time.perf_counter() - t0) / n_hooks * 1e3
    rec.close()
    t0 = time.perf_counter()
    for _ in range(n_hooks):
        obs.memory.device_memory_stats("cuda")
    stats_ms = (time.perf_counter() - t0) / n_hooks * 1e3
    print(f"obs hook cost: {hooks_ms!r} ms a batch's hooks (the exact "
          f"loop's: 3 series, 2 gauges, a watermark, the boundary's drain "
          f"and write), of which memory_stats {stats_ms!r} ms "
          f"({n_hooks} batches; {card_line()})")
    # the hooks of one served request alone (submit's and completion's)
    rec, path = recorder("O-request-hooks")
    n_req = 5000
    t0 = time.perf_counter()
    for uid in range(n_req):
        rec.counter("serve/submitted", rows=1)
        rec.gauge("serve/queue_rows", 1)
        rec.series("serve/queue_seconds", 1e-5, uid=uid)
        rec.series("serve/compute_seconds", 2e-4, uid=uid)
        rec.event("serve/request", uid=uid, rows=1, bucket=1,
                  queue_seconds=1e-5, compute_seconds=2e-4,
                  total_seconds=3e-4)
        rec.gauge("serve/queue_rows", 0)
    req_us = (time.perf_counter() - t0) / n_req * 1e6
    rec.close()
    print(f"obs request hook cost: {req_us!r} us a request's hooks "
          f"({n_req} requests, written at close; {card_line()})")

    # D-rff with the recorder on
    rec, path = recorder("O-D-rff")
    cfg_d = core.MiniBatchConfig(n_clusters=10, n_batches=1, kernel=spec,
                                 seed=0, embed_dim=EMBED_DIM, method="rff")
    base = fresh_peak(torch)
    r, labels, res = run_embedded(torch, mods, "O-D-rff", cfg_d, x_tr, y_tr,
                                  x_te, y_te, recorder=rec)
    rec.close()
    count(r["launches"])
    watermark_lines(export, path, "O-D-rff", base)
    check(np.array_equal(labels, runs["D-rff"][1]),
          "O-D-rff: the recorded fit labels differ from run D-rff's")

    # M-B with the recorder on, in the world of one phase 4d left up
    dist = torch.distributed
    outer = mods["outer"]
    count_c = CollectiveCount(dist)
    mesh = dm.make_test_mesh({"data": 1, "model": 1})
    per_batch = []
    real = outer._inner_local

    def counted(*a, **k):
        before = dict(count_c.n)
        out = real(*a, **k)
        per_batch.append({c: count_c.n[c] - before[c] for c in before})
        return out
    rec, path = recorder("O-M-B")
    base = fresh_peak(torch)
    outer._inner_local = counted
    try:
        batches = mods["sampling"].split_batches(x_tr, 4, strategy="stride")
        km = dm.DistributedMiniBatchKMeans(mesh, cfg_b, recorder=rec)
        r, _, res = run_mesh(torch, mods, count_c, "O-M-B",
                             lambda: km.fit(batches), x_te, y_te)
    finally:
        outer._inner_local = real
        count_c.close()
        rec.close()
    ev = export.read_events(path)
    bill = {n: [e["inc"] for e in ev if e.get("name") == n]
            for n in ("collectives/psum", "collectives/allgather",
                      "collectives/psum_bytes")}
    rows = [len(b) for b in batches]
    want_bytes = [mods["inner"].collectives_per_iteration(
        km.inner_cfg, n)["psum_bytes"] * (t + 1)
        for n, t in zip(rows, r["inner_iters"])]
    print_run(r, recorded=bill, wrapper_inner_fit=per_batch,
              want_psum_bytes=want_bytes)
    count(r["launches"])
    watermark_lines(export, path, "O-M-B", base)
    check(bill["collectives/psum"] == [c["all_reduce"] for c in per_batch]
          and bill["collectives/allgather"]
          == [c["all_gather"] for c in per_batch]
          and bill["collectives/psum_bytes"] == want_bytes,
          f"O-M-B: recorded collectives {bill} differ from the wrapper's "
          f"inner-fit counts {per_batch}")

    # E-csr-stream and H-stream, prefetch=2, with the recorder on
    cfg_e, cuts = stream["cfg"], stream["cuts"]
    xs_tr, xs_te, ys_te = stream["xs_tr"], stream["xs_te"], stream["ys_te"]
    cfg_h = core.MiniBatchConfig(n_clusters=10, n_batches=4, s=0.2,
                                 kernel=spec, seed=0, engine="fused",
                                 sampling="block")
    cuts_h = stream_cuts(np, len(x_tr), 4)
    r_h_off = None
    for name, cfg, chunks, n_rows, xt, yt in (
            ("O-E-csr-stream", cfg_e,
             lambda: (sparse.slice_rows(xs_tr, a, z) for a, z in cuts),
             RCV1_TRAIN, xs_te, ys_te),
            ("O-H-stream-off", cfg_h,
             lambda: (x_tr[a:z] for a, z in cuts_h), len(x_tr), x_te, y_te),
            ("O-H-stream", cfg_h,
             lambda: (x_tr[a:z] for a, z in cuts_h), len(x_tr), x_te,
             y_te)):
        on = not name.endswith("-off")
        rec, path = recorder(name) if on else (None, None)
        src = loader.BatchSource.from_stream(chunks(), n_rows // 4,
                                             prefetch=2, recorder=rec)
        base = fresh_peak(torch)
        r, labels, res = run_sparse(
            torch, mods, name, cfg,
            lambda: core.fit(src, cfg, recorder=rec), xt, yt, n_rows)
        count(r["launches"])
        if not on:
            r_h_off = (res, labels)
            print_run(r)
            continue
        rec.close()
        st = export.summarize(path)["stats"]
        ref_res, ref_lab = ((stream["res"], stream["labels"])
                            if name == "O-E-csr-stream" else r_h_off)
        same = same_fit(torch, res, ref_res) and np.array_equal(labels,
                                                                ref_lab)
        print_run(r, stage_seconds_sum=st["prefetch/stage_seconds"]["total"],
                  starve_seconds_sum=st["prefetch/starve_seconds"]["total"],
                  stage_seconds_max=st["prefetch/stage_seconds"]["max"],
                  queue_depth_mean=st["prefetch/queue_depth"]["mean"],
                  batch_wall_s=st["batch/wall_seconds"]["total"],
                  equal_unrecorded=same)
        watermark_lines(export, path, name, base)
        check(same, f"{name}: the recorded stream differs from the "
                    f"unrecorded fit")
        check(st["prefetch/stage_seconds"]["count"] == 4
              and st["prefetch/starve_seconds"]["count"] == 4,
              f"{name}: not one stage and one starve time a batch")

    # serve_bench on G-D-rff's artifact, without and with a recorder
    art = serving.freeze(fits["D-rff"])
    bench = mods["serve_bench"].bench
    rec, path = recorder("O-serve")
    zero_counters(mods)
    svc_off = serving.AssignService(art)
    svc_on = serving.AssignService(art, recorder=rec)
    # off, on, on, off: each side runs once first and once after the other
    got = [bench(svc, qps_levels=BENCH_QPS, row_sizes=(1, 64),
                 n_req=BENCH_REQUESTS)
           for svc in (svc_off, svc_on, svc_on, svc_off)]
    rec.close()
    served = dict(ops.LAUNCHES)
    count(served)
    card = card_line()
    for cell in got[0]["cells"]:
        c = [g["cells"][cell] for g in got]
        print(f"obs serve_bench {cell}: p50 ms off {c[0]['p50_ms']!r}, "
              f"{c[3]['p50_ms']!r} on {c[1]['p50_ms']!r}, "
              f"{c[2]['p50_ms']!r}; p99 ms off {c[0]['p99_ms']!r}, "
              f"{c[3]['p99_ms']!r} on {c[1]['p99_ms']!r}, "
              f"{c[2]['p99_ms']!r}; queue p50 ms {c[1]['queue_p50_ms']!r}, "
              f"{c[2]['queue_p50_ms']!r}; compute p50 ms "
              f"{c[1]['compute_p50_ms']!r}, {c[2]['compute_p50_ms']!r} "
              f"({card})")
    n_req = sum(e.get("name") == "serve/request"
                for e in export.read_events(path))
    want_req = 2 * len(got[1]["cells"]) * BENCH_REQUESTS
    check(svc_on.compiled_programs == svc_off.compiled_programs
          == len(BUCKETS), f"obs serve: {svc_on.compiled_programs} graphs "
                           f"with the recorder, {svc_off.compiled_programs} "
                           f"without")
    check(n_req == want_req,
          f"obs serve: {n_req} serve/request records, not {want_req}")
    check(served["embed_assign"] > 0
          and all(v == 0 for v in mods["ref"].CALLS.values()),
          "obs serve: no embed_assign replay, or a plain version ran")

    # launch.cluster at Tab.1's size, --obs and --profile
    path, prof = os.path.join(tmp, "cluster.jsonl"), os.path.join(tmp, "p")
    zero_counters(mods)
    base = fresh_peak(torch)
    t0 = time.perf_counter()
    acc = mods["cluster"].main([
        "--n", str(N_TRAIN), "--d", "784", "--clusters", "10", "--b", "4",
        "--s", "0.2", "--mode", "fused", "--obs", path, "--profile", prof])
    wall = time.perf_counter() - t0
    launches, calls = dict(ops.LAUNCHES), dict(mods["ref"].CALLS)
    count(launches)
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    spans = sorted(n for n in names if n.startswith("obs:"))
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    assign_dev = [e for e in kernel_events
                  if "assign_f32_kernel" in e.get("name", "")]
    print("run", json.dumps({
        "run": "O-cluster", "wall_s": wall, "acc": acc, "spans": spans,
        "trace_events": len(events), "kernel_events": len(kernel_events),
        "assign_f32_kernel_events": len(assign_dev),
        "assign_f32_kernel_us": sum(e.get("dur", 0) for e in assign_dev),
        "launches": launches, "plain_calls": calls}))
    watermark_lines(export, path, "O-cluster", base)
    check("obs:engine_stats[fused]" in names and len(assign_dev) > 0,
          f"O-cluster: the trace lacks obs:engine_stats[fused] or the "
          f"assign kernel (spans {spans})")
    check(acc >= 0.9 and all(v == 0 for v in calls.values()),
          f"O-cluster: accuracy {acc} < 0.9 or a plain version ran")
    return totals, bodies


# ---------------------------------------------------------------------------
# phase 4f: the program audit
# ---------------------------------------------------------------------------


def audit_phase(torch, mods, x_tr, gamma):
    """Phase 4f: ``launch.audit`` on the card, in the world of one phase 4d
    left up: the 26 reports at the reference's defaults (engine modes, the
    five kernel wrappers with their f32-accumulation probes at both tile
    dtypes, the mesh and embedded programs, predict, the serving buckets),
    one ``audit`` line each; then the engine modes again at Tab.1's batch
    width (15,000 x 784 rows of batch 0, |L| = 3,000, C = 10, rbf, the
    path's gamma), one ``audit-tab1`` line each beside
    ``engine_footprint_bytes`` and the [rows, |L|] f32 Gram block: fused and
    tiled must stay below the block in allocator peak and largest
    intermediate, fused launches assign_fused as often in every iteration
    and the others never, at most one host read an iteration. Any
    violation fails. Returns (totals, bodies) of the launches of the
    audited main-path programs (the wrapper audits and probes, which check
    kernels, are left out)."""
    audit, core = mods["audit"], mods["core"]
    totals: dict = {}
    bodies: dict = {}

    def count(report):
        prec = "bf16" if "bf16" in report.name else "f32"
        for k, n in report.kernel_launches.items():
            if k == "kernel_matrix_column":
                bodies["kernel_matrix", "column"] = \
                    bodies.get(("kernel_matrix", "column"), 0) + n
                continue
            totals[k] = totals.get(k, 0) + n
            if k != "kernel_matrix":
                bodies[k, prec] = bodies.get((k, prec), 0) + n

    wrappers = tuple(audit.KERNEL_WRAPPERS)
    bad = []
    results = audit.run_audits(n=512, d=16, n_landmarks=256, c=8, m=32,
                               tile_rows=64, device="cuda")
    check(len(results) == 26, f"{len(results)} audit reports, not 26")
    for report, violations in results:
        line = audit.summary(report, violations)
        if report.probe is not None:
            line["probe"] = report.probe
        else:
            count(report)
        print("audit", json.dumps(line))
        check(not report.name.startswith(wrappers) or report.probe["ok"],
              f"{report.name}: f32-accumulation probe {report.probe}")
        bad += violations

    card = card_line()
    x_b = torch.as_tensor(x_tr[0::4], device="cuda")   # batch 0 under B=4
    n, d = x_b.shape
    n_l, c, tile_rows = 3000, 10, 256
    gram = 4 * n * n_l
    for report, violations in audit.audit_engine_modes(
            n=n, d=d, n_landmarks=n_l, c=c, tile_rows=tile_rows,
            device="cuda", x=x_b, gamma=gamma):
        mode, prec = report.name[len("kkmeans_fit["):-1].split(",")
        count(report)
        line = audit.summary(report, violations)
        line.update(
            engine_footprint_bytes=core.engine_footprint_bytes(
                n, 1, c, 1, s=n_l / n, d=d, mode=mode, tile_rows=tile_rows,
                q_tile=2 if prec == "bf16" else None),
            gram_block_bytes=gram, card=card)
        print("audit-tab1", json.dumps(line))
        bad += violations
        per_iter = [loop.kernel_launches.get("assign_fused", 0)
                    for loop in report.loops]
        if mode == "fused":
            check(per_iter and per_iter[0] > 0,
                  f"{report.name}: assign_fused launches per iteration "
                  f"{per_iter}")
        else:
            check("assign_fused" not in report.kernel_launches,
                  f"{report.name}: launched assign_fused")
            if mode == "tiled":
                check(report.allocator_peak_bytes < gram
                      and report.largest_intermediate_bytes < gram,
                      f"{report.name}: peak {report.allocator_peak_bytes} "
                      f"or intermediate {report.largest_intermediate_bytes}"
                      f" reaches the Gram block {gram}")
        if mode == "fused":
            check(report.allocator_peak_bytes < gram
                  and report.largest_intermediate_bytes < gram,
                  f"{report.name}: peak {report.allocator_peak_bytes} or "
                  f"intermediate {report.largest_intermediate_bytes} "
                  f"reaches the Gram block {gram}")
        check(report.host_reads_per_iteration <= 1
              and all(loop.sync_warnings <= 1 for loop in report.loops),
              f"{report.name}: more than one host read an iteration")
    del x_b
    check(not bad, "audit violations:\n  " + "\n  ".join(bad))
    return totals, bodies


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def run_fit(torch, mods, name, cfg, x_tr, x_te, y_te, recorder=None):
    ops, ref, core = mods["ops"], mods["ref"], mods["core"]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for k in ref.CALLS:
        ref.CALLS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = core.fit_dataset(x_tr, cfg, recorder=recorder)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels = res.predict(x_te).cpu().numpy()
    t2 = time.perf_counter()
    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    # the one-launch labelling FitResult.predict made before it went
    # through the serving ladder, timed beside it (after the counters)
    t3 = time.perf_counter()
    one_call = core.predict(x_te, res.state.medoids, res.state.medoid_diag,
                            spec=cfg.kernel, device="cuda").cpu().numpy()
    one_call_s = time.perf_counter() - t3
    medoids = res.state.medoids
    check(tuple(medoids.shape) == (cfg.n_clusters, x_tr.shape[1])
          and bool(torch.isfinite(medoids).all()),
          f"run {name}: medoids not finite or of the wrong shape")
    check(len(labels) == len(y_te) and labels.min() >= 0
          and labels.max() < cfg.n_clusters, f"run {name}: bad test labels")
    iters = [h.inner_iters for h in res.history]
    rec = {"run": name, "engine": cfg.engine, "precision": cfg.precision,
           "selector": mods["selectors"].name_of(cfg.selector),
           "B": cfg.n_batches, "s": cfg.s, "wall_s": t2 - t0,
           "fit_s": t1 - t0, "label_s": t2 - t1,
           "label_one_call_s": one_call_s,
           "label_one_call_equal": bool((one_call == labels).all()),
           "inner_iters": iters, "max_inner_iters": cfg.max_inner_iters,
           "acc": core.clustering_accuracy(y_te, labels),
           "nmi": core.nmi(y_te, labels), "launches": launches,
           "plain_calls": calls}
    print("run", json.dumps(rec))
    check(all(v == 0 for v in calls.values()),
          f"run {name}: a plain version ran on the card: {calls}")
    return rec, labels, res


def run_embedded(torch, mods, name, cfg, x_tr, y_tr, x_te, y_te,
                 recorder=None):
    """An embedded fit as a user runs it: fit_dataset, label the test rows
    with FitResult.predict and the training rows with predict_embedded."""
    ops, ref, core = mods["ops"], mods["ref"], mods["core"]
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    for k in ref.CALLS:
        ref.CALLS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = core.fit_dataset(x_tr, cfg, recorder=recorder)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    labels = res.predict(x_te).cpu().numpy()     # at f32 tiles, always
    t2 = time.perf_counter()
    at_predict = dict(ops.LAUNCHES)
    labels_tr = mods["approx"].predict_embedded(
        x_tr, res.state, res.fmap, precision=cfg.precision).cpu().numpy()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    t3 = time.perf_counter()          # the one-launch labelling, as run_fit
    one_call = mods["approx"].predict_embedded(
        x_te, res.state, res.fmap, precision="f32").cpu().numpy()
    one_call_s = time.perf_counter() - t3
    kernel = "sketch_assign" if cfg.method == "sketch" else "embed_assign"
    # the launches of each body: predict's at f32, the training rows' at
    # the run's tile dtype
    by_tile = {"f32": at_predict[kernel], "bf16": 0}
    by_tile[cfg.precision] += launches[kernel] - at_predict[kernel]
    cents = res.state.centroids
    m = res.fmap.dim
    check(tuple(cents.shape) == (cfg.n_clusters, m)
          and bool(torch.isfinite(cents).all()),
          f"run {name}: centroids not finite or of the wrong shape")
    check(int(res.state.cardinalities.sum()) == len(x_tr),
          f"run {name}: the merge did not count every row once")
    for lab, ys in ((labels, y_te), (labels_tr, y_tr)):
        check(len(lab) == len(ys) and lab.min() >= 0
              and lab.max() < cfg.n_clusters, f"run {name}: bad labels")
    rec = {"run": name, "method": cfg.method, "m": m,
           "selector": mods["selectors"].name_of(cfg.selector),
           "precision": cfg.precision, "B": cfg.n_batches, "wall_s": wall,
           "fit_s": t1 - t0, "label_s": t2 - t1,
           "label_one_call_s": one_call_s,
           "label_one_call_equal": bool((one_call == labels).all()),
           "inner_iters": [h.inner_iters for h in res.history],
           "max_inner_iters": cfg.max_inner_iters,
           "acc": core.clustering_accuracy(y_te, labels),
           "nmi": core.nmi(y_te, labels),
           "train_acc": core.clustering_accuracy(y_tr, labels_tr),
           "train_nmi": core.nmi(y_tr, labels_tr), "launches": launches,
           "launches_by_tile": by_tile, "plain_calls": calls}
    print("run", json.dumps(rec))
    check(all(v == 0 for v in calls.values()),
          f"run {name}: a plain version ran on the card: {calls}")
    return rec, labels, res


def small_reference_fit(torch, mods):
    """toy2d on the card vs the same fits on the CPU (the plain path): the
    exact fused fit and two embedded ones."""
    core, synth = mods["core"], mods["synthetic"]
    x, y = synth.toy2d(500)
    for kw in (dict(s=1.0, engine="fused"),
               dict(method="rff", embed_dim=32),
               dict(method="sketch", kernel=core.KernelSpec("linear"))):
        kw = {"kernel": core.KernelSpec("rbf", gamma=4.0), **kw}
        out = {}
        for dev in ("cuda", "cpu"):
            cfg = core.MiniBatchConfig(n_clusters=4, n_batches=3, **kw)
            lab = core.fit_dataset(x, cfg, device=dev).predict(x)
            lab = lab.cpu().numpy()
            out[dev] = (core.clustering_accuracy(y, lab), core.nmi(y, lab))
        what = kw.get("method", "exact fused")
        print(f"small reference fit (toy2d, B=3, {what}):", json.dumps(out))
        check(abs(out["cuda"][0] - out["cpu"][0]) <= 0.02
              and abs(out["cuda"][1] - out["cpu"][1]) <= 0.02,
              f"toy2d {what} fit on the card strays from the CPU fit")


def olmo_prompts(np, vocab: int, n: int, lo: int, hi: int, seed: int):
    """n prompts of lengths uniform in [lo, hi], tokens uniform in
    [1, vocab), from np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(1, vocab, size=int(m)) for m in lens]


def top2_gap(torch, logits):
    top = torch.topk(logits, 2, dim=-1).values
    return float(top[..., 0] - top[..., 1])


@contextlib.contextmanager
def sdpa_counted(torch):
    """While open, ``scaled_dot_product_attention`` counts its calls into
    the yielded one-element list."""
    F = torch.nn.functional
    sdpa, calls = F.scaled_dot_product_attention, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return sdpa(*a, **kw)

    F.scaled_dot_product_attention = counted
    try:
        yield calls
    finally:
        F.scaled_dot_product_attention = sdpa


def run_serving(torch, mods, name, api, params, prompts, serve=SERVE):
    """Serve ``prompts`` through ServingEngine as a user would (``serve``
    settings, greedy); prefill is timed on the host clock around each call,
    ending in a synchronize. Counters are zeroed just before the run and
    read just after; ``scaled_dot_product_attention`` is counted too.
    Returns (record, {uid: tokens}, [first-token logits per request])."""
    ops, ref, serving = mods["ops"], mods["ref"], mods["serving"]
    firsts, clock = [], {"prefill_s": 0.0, "prefill_tokens": 0}

    def prefill(params, batch, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, logits = api.prefill(params, batch, **kw)
        torch.cuda.synchronize()
        clock["prefill_s"] += time.perf_counter() - t0
        clock["prefill_tokens"] += batch["tokens"].shape[1]
        firsts.append(logits[0].cpu())
        return cache, logits

    eng = serving.ServingEngine(dataclasses.replace(api, prefill=prefill),
                                params, serving.ServeConfig(**serve))
    for prompt in prompts:
        eng.submit(prompt)
    zero_counters(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with sdpa_counted(torch) as sdpa_calls:
        results = eng.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = dict(ops.LAUNCHES), dict(ref.CALLS)
    generated = sum(len(v) for v in results.values())
    decode_tokens = generated - len(prompts)      # first tokens: prefill
    decode_s = wall - clock["prefill_s"]
    rec = {"run": name, "attn_impl": api.cfg.attn_impl,
           "dtype": str(params["embed"].dtype), "requests": len(prompts),
           "wall_s": wall, "prefill_tokens": clock["prefill_tokens"],
           "prefill_s": clock["prefill_s"],
           "prefill_tok_per_s": clock["prefill_tokens"] / clock["prefill_s"],
           "decode_ticks": eng.ticks, "decode_tokens": decode_tokens,
           "decode_s": decode_s, "decode_tok_per_s": decode_tokens / decode_s,
           "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "plain_calls": calls,
           "sdpa_calls": sdpa_calls[0]}
    print("run", json.dumps(rec))
    check(sorted(results) == list(range(1, len(prompts) + 1))
          and all(len(v) == serve["max_new_tokens"] for v in results.values())
          and all(0 <= t < api.cfg.vocab_size
                  for v in results.values() for t in v),
          f"run {name}: missing requests, short outputs or bad token ids")
    check(all(bool(torch.isfinite(f).all()) for f in firsts),
          f"run {name}: prefill logits not finite")
    check(all(v == 0 for v in calls.values()),
          f"run {name}: a plain kernel version ran on the card: {calls}")
    check(sdpa_calls[0] == 0,
          f"run {name}: scaled_dot_product_attention was called")
    return rec, results, firsts


def flash_vs_chunked(torch, np, name, out_f, first_f, out_c, first_c,
                     held=None, tol=SERVE_LOGIT_TOL, near_tie=SERVE_NEAR_TIE):
    """Run ``name`` (flash) against its chunked twin on the same weights
    and prompts: first tokens equal wherever the flash run's top-2 logit
    gap is at least ``near_tie``, last-token prefill logits within ``tol``
    normwise for the requests ``held`` marks (default: all)."""
    near, bad, diff, agree = 0, [], 0.0, []
    for i, (lf, lc) in enumerate(zip(first_f, first_c)):
        _, rel = normwise(torch, lf, lc)
        if held is None or held[i]:
            diff = max(diff, rel)
        tied = top2_gap(torch, lf) < near_tie
        near += tied
        if out_f[i + 1][0] != out_c[i + 1][0] and not tied:
            bad.append(i + 1)
        a, b = out_f[i + 1], out_c[i + 1]
        same = next((j for j in range(len(a)) if a[j] != b[j]), len(a))
        agree.append(same / len(a))
    firsts_equal = sum(out_f[u][0] == out_c[u][0] for u in out_f)
    n_held = len(out_f) if held is None else sum(held)
    print(f"{name} vs {name}-chunked: first tokens equal {firsts_equal}/"
          f"{len(out_f)} (near-ties, top-2 gap < {near_tie}: {near}); "
          f"last-token prefill logits normwise diff {diff!r} over "
          f"{n_held} requests (limit {tol}); share of tokens equal up to "
          f"the first divergence {float(np.mean(agree))!r}")
    check(not bad, f"{name} vs {name}-chunked: first tokens differ outside "
                   f"near-ties for requests {bad}")
    check(diff <= tol, f"{name} vs {name}-chunked: prefill logits differ by "
                       f"{diff} > {tol}")


def serving_runs(torch, np, mods):
    """Runs F (bf16, flash), F-chunked and F-f32 on OLMo-1B at full width;
    returns the flash launches of run F (bf16) and of F-f32 (f32)."""
    configs, models = mods["configs"], mods["models"]
    base = configs.get_arch("olmo-1b")
    flash_cfg = dataclasses.replace(base, attn_impl="flash")
    api_f = models.get_model(flash_cfg)
    api_c = models.get_model(dataclasses.replace(base, attn_impl="chunked"))
    t0 = time.perf_counter()
    params = api_f.init(0, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for n, t in params.items() if n != "layers") + \
        sum(t.numel() for layer in params["layers"] for t in layer.values())
    print(f"OLMo-1B: {n_params} parameters, bf16, drawn on the card from "
          f"seed 0 in {time.perf_counter() - t0:.2f} s")
    prompts = olmo_prompts(np, base.vocab_size, N_REQUESTS, PROMPT_MIN,
                           PROMPT_MAX, seed=0)
    rec_f, out_f, first_f = run_serving(torch, mods, "F", api_f, params,
                                        prompts)
    want = N_REQUESTS * base.n_layers
    check(rec_f["launches"]["flash_attention"] == want,
          f"run F: {rec_f['launches']['flash_attention']} flash launches, "
          f"expected {want} (16 requests x 16 layers)")
    rec_c, out_c, first_c = run_serving(torch, mods, "F-chunked", api_c,
                                        params, prompts)
    check(rec_c["launches"]["flash_attention"] == 0,
          "run F-chunked launched the flash kernel")
    del params

    flash_vs_chunked(torch, np, "F", out_f, first_f, out_c, first_c)

    # F-f32: one 2048-token prompt, f32 weights and tiles
    params = api_f.init(0, torch.float32)
    prompt = olmo_prompts(np, base.vocab_size, 1, PROMPT_MAX, PROMPT_MAX,
                          seed=1)[0]
    tokens = torch.as_tensor(prompt[None], dtype=torch.long, device="cuda")
    mods["ops"].LAUNCHES["flash_attention"] = 0
    logits = {}
    for api in (api_f, api_c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, logits[api.cfg.attn_impl] = api.prefill(
            params, {"tokens": tokens}, max_len=PROMPT_MAX)
        torch.cuda.synchronize()
        print(f"F-f32 {api.cfg.attn_impl} prefill of {PROMPT_MAX} tokens: "
              f"{time.perf_counter() - t0:.4f} s")
    launches = mods["ops"].LAUNCHES["flash_attention"]
    _, rel = normwise(torch, logits["flash"], logits["chunked"])
    rec = {"run": "F-f32", "prompt": PROMPT_MAX, "flash_launches": launches,
           "logits_rel_diff": rel, "tol": 1e-4,
           "first_token": [int(torch.argmax(v)) for v in logits.values()]}
    print("run", json.dumps(rec))
    check(launches == base.n_layers, f"run F-f32: {launches} flash launches")
    check(rel <= 1e-4, f"run F-f32: flash and chunked prefill logits differ "
                       f"by {rel} > 1e-4")
    return rec_f["launches"]["flash_attention"], launches


# ---------------------------------------------------------------------------
# phase 4g: LM training and the MoE family
# ---------------------------------------------------------------------------


def leaves_of(mods, tree) -> list:
    return mods["training"].optim.tree_leaves(tree)


def leaf_rel(torch, got, want) -> float:
    """||got - want|| / ||want|| in f64 (0 when both are 0)."""
    g, w = got.double(), want.double()
    den = float(torch.linalg.vector_norm(w))
    num = float(torch.linalg.vector_norm(g - w))
    return num / den if den else num


def params_moved(torch, mods, api, params) -> tuple[int, int, float]:
    """(leaves that moved, leaves, smallest relative move) of ``params``
    against the seed-0 parameters ``api`` draws again."""
    fresh = api.init(0)
    moves = [leaf_rel(torch, p.detach(), q)
             for p, q in zip(leaves_of(mods, params), leaves_of(mods, fresh))]
    del fresh
    return sum(m > 0 for m in moves), len(moves), min(moves)


def train_run(torch, mods, name, argv, *, cfg=None):
    """``launch.train.run(argv)`` on the card as a user runs it, with the
    allocator peak from a reset just before; prints its run line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(mods)
    t0 = time.perf_counter()
    out = mods["train"].run(argv, cfg=cfg)
    wall = time.perf_counter() - t0
    secs = out.seconds
    rec = {"run": name, "argv": argv, "wall_s": wall, "losses": out.losses,
           "grad_norms": out.grad_norms, "step_s": secs,
           "median_step_s": (sorted(secs[1:])[len(secs[1:]) // 2]
                             if len(secs) > 1 else None),
           "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
           "launches": dict(mods["ops"].LAUNCHES),
           "plain_calls": dict(mods["ref"].CALLS)}
    check(all(math.isfinite(v) for v in out.losses + out.grad_norms),
          f"run {name}: a loss or grad norm is not finite: {rec}")
    check(all(v == 0 for v in rec["plain_calls"].values()),
          f"run {name}: a plain kernel version ran on the card")
    return out, rec


def microbatch_parity(torch, mods, api, batch, n_micro):
    """First-step loss of ``make_train_step`` at microbatches 1 and
    ``n_micro`` from the same seed-0 state and batch."""
    tr = mods["training"]
    losses = []
    for n in (1, n_micro):
        tcfg = mods["configs"].TrainConfig(remat=True, microbatches=n)
        params = api.init(0)
        opt = tr.adamw_init(params, tcfg)
        _, _, m = tr.make_train_step(api, tcfg)(params, opt, batch)
        losses.append(float(m["loss"]))
        del params, opt
    return losses


def run_t_olmo(torch, np, mods):
    """T-olmo: launch.train on OLMo-1B, the full config; microbatches 4
    against 1 on the first batch."""
    base = mods["configs"].get_arch("olmo-1b")
    argv = ["--arch", "olmo-1b", "--steps", str(T_OLMO["steps"]), "--batch",
            str(T_OLMO["batch"]), "--seq", str(T_OLMO["seq"]),
            "--log-every", "1"]
    out, rec = train_run(torch, mods, "T-olmo", argv)
    api = mods["models"].get_model(base)
    moved, n, least = params_moved(torch, mods, api, out.params)
    rec.update(leaves_moved=moved, leaves=n, least_rel_move=least)
    del out
    torch.cuda.empty_cache()
    first = next(mods["train"].synthetic_batches(
        base.vocab_size, T_OLMO["batch"], T_OLMO["seq"], 1, seed=0))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device="cuda")
             for k, v in first.items()}
    l1, l4 = microbatch_parity(torch, mods, api, batch, 4)
    rec.update(first_loss_mb1=l1, first_loss_mb4=l4,
               mb_rel=abs(l4 - l1) / abs(l1), mb_tol=MB_REL)
    print("run", json.dumps(rec))
    check(moved == n, f"run T-olmo: {n - moved} of {n} leaves did not move")
    check(rec["mb_rel"] <= MB_REL, f"run T-olmo: microbatches 4 vs 1 first "
                                   f"loss rel {rec['mb_rel']} > {MB_REL}")
    torch.cuda.empty_cache()
    return rec


def loss_card_vs_cpu(torch, mods, name, cfg, batch, params_cpu,
                     f64_oracle=False, **extra):
    """``api.loss`` (remat) and every grad on the card against the same
    call on the host CPU, both from ``params_cpu`` (f32) and ``batch``
    (host tensors): loss within 1e-5 relative, each grad leaf within 1e-4
    normwise. With ``f64_oracle`` the grads are held instead to the same
    call on the host CPU in f64 arithmetic (``f64_math``; its loss and
    every grad checked to be float64): each leaf of the card's f32 grads
    within F64_MULT x the CPU f32 run's own distance from f64 for that
    leaf (normwise, floored at the median leaf's), which is what f32
    arithmetic alone moves this model's grads; a wrong card result moves
    them by O(1). Prints and returns the run line."""
    def loss_and_grads(dev, f64=False):
        api = mods["models"].get_model(cfg, device=dev)
        cast = (lambda t: t.double()) if f64 else (lambda t: t)
        params = mods["training"].optim.tree_map(
            lambda t: cast(t.to(dev, copy=True)).requires_grad_(True),
            params_cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        with f64_math(torch) if f64 else contextlib.nullcontext():
            loss = api.loss(params, b, remat=True)
            grads = torch.autograd.grad(loss, leaves_of(mods, params))
        if f64:
            check(loss.dtype == torch.float64
                  and all(g.dtype == torch.float64 for g in grads),
                  f"run {name}: the f64 oracle ran a loss or grad below f64")
        return (float(loss.detach()), [g.cpu() for g in grads],
                time.perf_counter() - t0)

    res = {dev: loss_and_grads(dev) for dev in ("cuda", "cpu")}
    rel_loss = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    rels = [leaf_rel(torch, a, b) for a, b in zip(res["cuda"][1],
                                                  res["cpu"][1])]
    ok = all(r <= 1e-4 for r in rels)
    rec = {"run": name, **extra, "dtype": "float32",
           "loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0],
           "loss_rel": rel_loss, "grad_rel_max": max(rels),
           "leaves": len(rels), "cuda_s": res["cuda"][2],
           "cpu_s": res["cpu"][2], "tol": {"loss": 1e-5, "grad": 1e-4}}
    if f64_oracle:
        loss64, grads64, secs = loss_and_grads("cpu", f64=True)
        d_cpu = [leaf_rel(torch, a, w) for a, w in zip(res["cpu"][1],
                                                        grads64)]
        d_card = [leaf_rel(torch, a, w) for a, w in zip(res["cuda"][1],
                                                         grads64)]
        floor = statistics.median(d_cpu)
        limits = [F64_MULT * max(d, floor) for d in d_cpu]
        worst = max(range(len(d_card)), key=lambda i: d_card[i] / limits[i])
        ok = all(c <= lim for c, lim in zip(d_card, limits))
        rec.update(loss_f64=loss64, f64_s=secs, f64_mult=F64_MULT,
                   cpu_from_f64={"min": min(d_cpu), "max": max(d_cpu)},
                   card_from_f64={"min": min(d_card), "max": max(d_card)},
                   card_over_cpu_leafwise_max=max(
                       c / max(d, 1e-12) for c, d in zip(d_card, d_cpu)),
                   worst_leaf={"card": d_card[worst], "cpu": d_cpu[worst],
                               "limit": limits[worst]},
                   tol={"loss": 1e-5, "grad_floor": F64_MULT * floor,
                        "grad_rule": f"{F64_MULT} x the CPU f32 run's "
                                     f"distance from f64 leaf by leaf, "
                                     f"floored at the median leaf's"})
    print("run", json.dumps(rec))
    torch.cuda.empty_cache()
    check(rel_loss <= 1e-5, f"run {name}: loss rel {rel_loss} > 1e-5")
    check(ok, f"run {name}: a grad differs by more than its limit: "
              f"{rec.get('worst_leaf', max(rels))}")
    return rec


@contextlib.contextmanager
def f64_math(torch):
    """While open, every cast the model code makes to ``torch.float32``
    (its f32 norms, softmaxes and scans) goes to float64 instead, so a
    model whose parameters and inputs are f64 runs in f64 throughout: the
    oracle of an f32 run."""
    f32 = torch.float32
    torch.float32 = torch.float64
    try:
        yield
    finally:
        torch.float32 = f32


def token_batch(torch, np, vocab: int, n: int, seed: int) -> dict:
    """One row of n tokens uniform in [1, vocab) and its next-token labels
    (host tensors)."""
    tok = np.random.default_rng(seed).integers(1, vocab, size=(1, n))
    return {"tokens": torch.as_tensor(tok, dtype=torch.long),
            "labels": torch.as_tensor(np.roll(tok, -1, 1), dtype=torch.long)}


def run_t_olmo_cpu(torch, np, mods):
    """T-olmo-cpu: OLMo-1B at full width, 2 layers, f32: lm_loss and every
    grad on the card against the same call on the host CPU."""
    cfg = dataclasses.replace(mods["configs"].get_arch("olmo-1b"),
                              n_layers=2)
    params_cpu = mods["models"].get_model(cfg, device="cpu").init(
        0, torch.float32)
    return loss_card_vs_cpu(torch, mods, "T-olmo-cpu", cfg,
                            token_batch(torch, np, cfg.vocab_size,
                                        CPU_TOKENS, 3),
                            params_cpu, layers=2, tokens=CPU_TOKENS)


def ep_check(torch, mods, cfg):
    """moe_ep_groups=4 against dense dispatch on 256 tokens at f32 with
    capacity_factor 100 (nothing drops), one MoE layer at full width."""
    mlp, common = mods["mlp"], mods["common"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = common.ParamBuilder(gen, torch.float32, torch.device("cuda"))
    dense = dataclasses.replace(cfg, capacity_factor=100.0, moe_ep_groups=0)
    mlp.init_moe(b, dense)
    x = torch.randn((1, 256, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        want = mlp.moe_block(b.params, x, dense)
        got = mlp.moe_block(b.params, x, dataclasses.replace(
            dense, moe_ep_groups=4))
    torch.cuda.synchronize()
    err, rel = normwise(torch, got, want)
    rec = {"check": "moe_ep", "tokens": 256, "groups": 4,
           "capacity_factor": 100.0, "max_abs_err": err, "rel_err": rel,
           "tol": 1e-5}
    print("check", json.dumps(rec))
    check(rel <= 1e-5, f"moe_ep_groups=4 vs dense dispatch: {rel} > 1e-5")
    return rec


def run_t_cut(torch, mods, name, arch, cut):
    """``launch.train`` on ``arch`` at full width cut to ``cut["layers"]``
    layers (``cut``: layers, steps, batch, seq): every loss and grad norm
    finite, every parameter leaf moved from its seed-0 draw; prints the
    step times and the allocator peak."""
    full = mods["configs"].get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=cut["layers"])
    print(f"{name}: {arch} cut to n_layers={cfg.n_layers} (of "
          f"{full.n_layers}); every width as published")
    argv = ["--arch", arch, "--steps", str(cut["steps"]), "--batch",
            str(cut["batch"]), "--seq", str(cut["seq"]), "--log-every", "1"]
    out, rec = train_run(torch, mods, name, argv, cfg=cfg)
    rec["params"] = sum(t.numel() for t in leaves_of(mods, out.params))
    rec["opt_state_dtype"] = str(out.opt.m["embed"].dtype)
    out.opt = None
    api = mods["models"].get_model(cfg)
    moved, n, least = params_moved(torch, mods, api, out.params)
    rec.update(leaves_moved=moved, leaves=n, least_rel_move=least)
    print("run", json.dumps(rec))
    check(moved == n, f"run {name}: {n - moved} of {n} leaves did not move")
    del out
    torch.cuda.empty_cache()
    return rec, cfg


def run_t_moe(torch, mods):
    """T-moe: launch.train on qwen3-moe-235b-a22b at full width, 1 layer;
    then the EP check."""
    rec, cfg = run_t_cut(torch, mods, "T-moe", "qwen3-moe-235b-a22b", T_MOE)
    ep = ep_check(torch, mods, cfg)
    torch.cuda.empty_cache()
    return rec, ep


@contextlib.contextmanager
def recorded_routes(mods, log: list, min_rows: int):
    """While open, ``models.mlp.route`` also appends, for each call on more
    than ``min_rows`` tokens (a prefill's), each token's experts sorted
    ([T, k], on the host) to ``log``; it changes no result."""
    mlp, orig = mods["mlp"], mods["mlp"].route

    def route(x, router, k):
        w, e = orig(x, router, k)
        if x.shape[0] > min_rows:
            log.append(e.sort(dim=-1).values.cpu())
        return w, e

    mlp.route = route
    try:
        yield
    finally:
        mlp.route = orig


def route_flips(log_f, log_c, n_layers):
    """Per request: tokens whose experts differ between the two runs, per
    layer, and whether the last token's differ in any layer."""
    out = []
    for i in range(0, len(log_f), n_layers):
        d = [(a != b).any(-1) for a, b in zip(log_f[i:i + n_layers],
                                              log_c[i:i + n_layers])]
        out.append(([int(x.sum()) for x in d], any(bool(x[-1]) for x in d)))
    return out


def run_f_moe(torch, np, mods):
    """F-moe: qwen3-moe-235b-a22b at full width, 4 layers, served with
    flash and with chunked attention (bf16), then F-moe-f32 (one 2048-token
    prompt, f32 weights and tiles); returns the flash launches of each.

    Routing is discrete: where the two attention paths' bf16 roundings move
    a token's router logits across the gap between its k-th and (k+1)-th
    expert, the token takes another expert. The prefill logits are held to
    SERVE_LOGIT_TOL on the requests whose last token took the same experts
    in every layer in both runs (the router's near-ties, as the first
    tokens' are), and the flips are printed."""
    full = mods["configs"].get_arch("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=F_MOE["layers"])
    print(f"F-moe: {full.name} cut to n_layers={cfg.n_layers} (of "
          f"{full.n_layers}); every width as published")
    api_f = mods["models"].get_model(dataclasses.replace(cfg,
                                                         attn_impl="flash"))
    api_c = mods["models"].get_model(dataclasses.replace(cfg,
                                                         attn_impl="chunked"))
    t0 = time.perf_counter()
    params = api_f.init(0, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves_of(mods, params))
    print(f"F-moe: {n_params} parameters, bf16, drawn on the card from seed "
          f"0 in {time.perf_counter() - t0:.2f} s")
    prompts = olmo_prompts(np, cfg.vocab_size, F_MOE["requests"], PROMPT_MIN,
                           PROMPT_MAX, seed=0)
    log_f, log_c = [], []
    with recorded_routes(mods, log_f, SERVE["max_batch"]):
        rec_f, out_f, first_f = run_serving(torch, mods, "F-moe", api_f,
                                            params, prompts)
    want = F_MOE["requests"] * cfg.n_layers
    check(rec_f["launches"]["flash_attention"] == want,
          f"run F-moe: {rec_f['launches']['flash_attention']} flash "
          f"launches, expected {want} (requests x layers)")
    with recorded_routes(mods, log_c, SERVE["max_batch"]):
        rec_c, out_c, first_c = run_serving(torch, mods, "F-moe-chunked",
                                            api_c, params, prompts)
    check(rec_c["launches"]["flash_attention"] == 0,
          "run F-moe-chunked launched the flash kernel")
    del params
    torch.cuda.empty_cache()
    flips = route_flips(log_f, log_c, cfg.n_layers)
    held = [not last for _, last in flips]
    print("F-moe routing, flash vs chunked", json.dumps(
        [{"request": i + 1, "prompt": len(p), "tokens_flipped_per_layer": f,
          "last_token_flipped": last}
         for i, (p, (f, last)) in enumerate(zip(prompts, flips))]))
    check(any(held), "F-moe: every request's last token changed experts; "
                     "no prefill logits to hold")
    flash_vs_chunked(torch, np, "F-moe", out_f, first_f, out_c, first_c,
                     held=held)

    # F-moe-f32: f32 weights and tiles, one 2048-token prompt
    params = api_f.init(0, torch.float32)
    prompt = olmo_prompts(np, cfg.vocab_size, 1, PROMPT_MAX, PROMPT_MAX,
                          seed=1)[0]
    tokens = torch.as_tensor(prompt[None], dtype=torch.long, device="cuda")
    mods["ops"].LAUNCHES["flash_attention"] = 0
    logits, logs = {}, {"flash": [], "chunked": []}
    for api in (api_f, api_c):
        with recorded_routes(mods, logs[api.cfg.attn_impl], 0):
            _, logits[api.cfg.attn_impl] = api.prefill(
                params, {"tokens": tokens}, max_len=PROMPT_MAX)
    launches = mods["ops"].LAUNCHES["flash_attention"]
    _, rel = normwise(torch, logits["flash"], logits["chunked"])
    flipped = route_flips(logs["flash"], logs["chunked"], cfg.n_layers)[0][0]
    rec = {"run": "F-moe-f32", "prompt": PROMPT_MAX,
           "flash_launches": launches, "logits_rel_diff": rel, "tol": 1e-4,
           "tokens_flipped_per_layer": flipped}
    print("run", json.dumps(rec))
    del params
    torch.cuda.empty_cache()
    check(launches == cfg.n_layers, f"run F-moe-f32: {launches} flash "
                                    f"launches")
    check(rel <= 1e-4, f"run F-moe-f32: flash and chunked prefill logits "
                       f"differ by {rel} > 1e-4")
    return rec_f["launches"]["flash_attention"], launches


def train_phase(torch, np, mods):
    """Phase 4g: T-olmo, T-olmo-cpu, T-moe (with the EP check), F-moe and
    F-moe-f32; returns the flash launches of F-moe (bf16) and F-moe-f32
    (f32)."""
    t0 = time.perf_counter()
    run_t_olmo(torch, np, mods)
    print(f"T-olmo: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_t_olmo_cpu(torch, np, mods)
    print(f"T-olmo-cpu: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_t_moe(torch, mods)
    print(f"T-moe: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = run_f_moe(torch, np, mods)
    print(f"F-moe: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 4h: the encoder-decoder, hybrid and RWKV6 families
# ---------------------------------------------------------------------------


def draw_params(torch, mods, api, dtype, name):
    """The seed-0 parameters of ``api`` on the card; prints their count.
    Earlier runs' garbage is collected first, so the runs' allocator peaks
    hold only what they allocate."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = api.init(0, dtype)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves_of(mods, params))
    print(f"{name}: {n} parameters, {dtype}, drawn on the card from seed 0 "
          f"in {time.perf_counter() - t0:.2f} s")
    return params


def seamless_requests(np, cfg, frames, seed: int) -> list:
    """[(frames [1, S, D] f32 N(0, 1), decoder prompt [1, n])] for each
    frame count, n uniform in [1, S_PROMPT_MAX], from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for s_enc in frames:
        f = rng.standard_normal((1, s_enc, cfg.d_model), dtype=np.float32)
        n = int(rng.integers(1, S_PROMPT_MAX + 1))
        out.append((f, rng.integers(1, cfg.vocab_size, size=(1, n))))
    return out


def seamless_batch(torch, f, tok, dtype) -> dict:
    return {"frames": torch.as_tensor(f, device="cuda").to(dtype),
            "tokens": torch.as_tensor(tok, dtype=torch.long, device="cuda")}


def run_seamless(torch, mods, name, api, params, requests):
    """Each request through ``api.prefill`` (max_len S_MAX_LEN) and
    ``api.decode`` to S_TOKENS greedy tokens, as a user drives the
    encoder-decoder (the engine refuses it); prefill and decode timed on
    the host clock, ending in a synchronize. Counters zeroed just before,
    read just after. Returns (record, {uid: tokens}, [first-token logits
    over the valid vocabulary])."""
    v = api.cfg.vocab_size
    dtype = params["embed"].dtype
    outs, firsts = {}, []
    clock = dict(prefill_s=0.0, decode_s=0.0, frames=0, prompt_tokens=0)
    zero_counters(mods)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with sdpa_counted(torch) as sdpa_calls:
        for uid, (f, tok) in enumerate(requests, start=1):
            batch = seamless_batch(torch, f, tok, dtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, logits = api.prefill(params, batch, max_len=S_MAX_LEN)
            torch.cuda.synchronize()
            clock["prefill_s"] += time.perf_counter() - t0
            clock["frames"] += f.shape[1]
            clock["prompt_tokens"] += tok.shape[1]
            firsts.append(logits[0, :v].cpu())
            out = [int(torch.argmax(logits[0]))]
            t0 = time.perf_counter()
            while len(out) < S_TOKENS:
                logits, cache = api.decode(
                    params, cache, torch.tensor([out[-1]], device="cuda"),
                    tok.shape[1] + len(out) - 1)
                out.append(int(torch.argmax(logits[0])))    # waits
            clock["decode_s"] += time.perf_counter() - t0
            outs[uid] = out
            del cache
    launches, calls = dict(mods["ops"].LAUNCHES), dict(mods["ref"].CALLS)
    decode_tokens = sum(len(o) - 1 for o in outs.values())
    rec = {"run": name, "attn_impl": api.cfg.attn_impl, "dtype": str(dtype),
           "requests": len(requests), **clock,
           "prefill_frames_per_s": clock["frames"] / clock["prefill_s"],
           "decode_tokens": decode_tokens,
           "decode_tok_per_s": decode_tokens / clock["decode_s"],
           "peak_alloc_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches, "plain_calls": calls,
           "sdpa_calls": sdpa_calls[0]}
    print("run", json.dumps(rec))
    check(all(len(o) == S_TOKENS and all(0 <= t < v for t in o)
              for o in outs.values()),
          f"run {name}: short outputs or bad token ids (the padded "
          f"vocabulary must stay masked)")
    check(all(bool(torch.isfinite(f).all()) for f in firsts),
          f"run {name}: prefill logits not finite")
    check(all(n == 0 for n in calls.values()),
          f"run {name}: a plain kernel version ran on the card: {calls}")
    check(sdpa_calls[0] == 0,
          f"run {name}: scaled_dot_product_attention was called")
    return rec, outs, firsts


def prefill_f32(torch, mods, name, apis, params, batch, want_launches,
                valid: int, **kw):
    """One prefill at f32 weights and tiles with flash and with chunked
    attention (``apis``): flash launches and last-token logits within 1e-4
    normwise over the valid vocabulary."""
    zero_counters(mods)
    logits = {}
    for api in apis:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = api.prefill(params, batch, **kw)
        torch.cuda.synchronize()
        logits[api.cfg.attn_impl] = out[..., :valid]
        print(f"{name} {api.cfg.attn_impl} prefill: "
              f"{time.perf_counter() - t0:.4f} s")
    launches = mods["ops"].LAUNCHES["flash_attention"]
    _, rel = normwise(torch, logits["flash"], logits["chunked"])
    rec = {"run": name, "flash_launches": launches, "logits_rel_diff": rel,
           "tol": 1e-4,
           "first_token": [int(torch.argmax(v)) for v in logits.values()]}
    print("run", json.dumps(rec))
    check(launches == want_launches, f"run {name}: {launches} flash "
                                     f"launches, expected {want_launches}")
    check(rel <= 1e-4, f"run {name}: flash and chunked prefill logits "
                       f"differ by {rel} > 1e-4")
    return launches


def flash_and_chunked(mods, cfg):
    models = mods["models"]
    return (models.get_model(dataclasses.replace(cfg, attn_impl="flash")),
            models.get_model(dataclasses.replace(cfg, attn_impl="chunked")))


def run_s(torch, np, mods):
    """S, S-chunked, S-f32 and S-cpu (seamless-m4t-medium); returns the
    flash launches of S (bf16) and S-f32 (f32)."""
    full = mods["configs"].get_arch("seamless-m4t-medium")
    api_f, api_c = flash_and_chunked(mods, full)
    params = draw_params(torch, mods, api_f, torch.bfloat16, full.name)
    requests = seamless_requests(np, full, S_FRAMES, seed=0)
    rec_f, out_f, first_f = run_seamless(torch, mods, "S", api_f, params,
                                         requests)
    want = len(S_FRAMES) * (full.n_enc_layers + full.n_dec_layers)
    check(rec_f["launches"]["flash_attention"] == want,
          f"run S: {rec_f['launches']['flash_attention']} flash launches, "
          f"expected {want} (requests x (encoder + decoder layers))")
    rec_c, out_c, first_c = run_seamless(torch, mods, "S-chunked", api_c,
                                         params, requests)
    check(rec_c["launches"]["flash_attention"] == 0,
          "run S-chunked launched the flash kernel")
    del params
    torch.cuda.empty_cache()
    flash_vs_chunked(torch, np, "S", out_f, first_f, out_c, first_c)

    params = api_f.init(0, torch.float32)
    f, tok = seamless_requests(np, full, (S_FRAMES[-1],), seed=1)[0]
    f32 = prefill_f32(torch, mods, "S-f32", (api_f, api_c), params,
                      seamless_batch(torch, f, tok, torch.float32),
                      full.n_enc_layers + full.n_dec_layers,
                      full.vocab_size, max_len=S_MAX_LEN)
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(full, n_layers=2 * S_CPU["layers"],
                              n_enc_layers=S_CPU["layers"],
                              n_dec_layers=S_CPU["layers"])
    batch = token_batch(torch, np, cfg.vocab_size, S_CPU["tokens"], 4)
    batch["frames"] = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1, S_CPU["frames"], cfg.d_model), dtype=np.float32))
    loss_card_vs_cpu(torch, mods, "S-cpu", cfg, batch,
                     mods["models"].get_model(cfg, device="cpu").init(
                         0, torch.float32),
                     layers=f"{S_CPU['layers']}+{S_CPU['layers']}",
                     frames=S_CPU["frames"], tokens=S_CPU["tokens"])
    return rec_f["launches"]["flash_attention"], f32


def bf16_copy(torch, tree):
    """``tree`` with every leaf that is not f32 in the reference's init
    (the dense weights: ``convert.LM_DENSE``) rounded to bf16."""
    from repro_torch.convert import LM_DENSE

    def cast(node, name=""):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        return node.to(torch.bfloat16) if name in LM_DENSE else node
    return cast(tree)


def run_z(torch, np, mods):
    """Z, Z-chunked, Z-f32, T-zamba and T-zamba-cpu (zamba2-2.7b); returns
    the flash launches of Z (bf16) and Z-f32 (f32).

    Z against Z-chunked is held to the model's own bf16 noise: Z-f32's
    prompt also runs chunked with the f32 weights rounded to bf16, and the
    normwise distance of those logits from the f32 ones (what bf16
    arithmetic alone moves them) replaces SERVE_LOGIT_TOL where larger,
    and that distance in logits SERVE_NEAR_TIE. The flash kernel is held
    to 1e-4 at f32 (Z-f32) and at the plain version's limits in phase 3."""
    full = mods["configs"].get_arch("zamba2-2.7b")
    groups = full.n_layers // full.attn_period
    api_f, api_c = flash_and_chunked(mods, full)
    params = draw_params(torch, mods, api_f, torch.bfloat16, full.name)
    prompts = olmo_prompts(np, full.vocab_size, Z_REQUESTS, PROMPT_MIN,
                           PROMPT_MAX, seed=0) + \
        olmo_prompts(np, full.vocab_size, 1, Z_LONG, Z_LONG, seed=2)
    rec_f, out_f, first_f = run_serving(torch, mods, "Z", api_f, params,
                                        prompts, serve=Z_SERVE)
    want = len(prompts) * groups
    check(rec_f["launches"]["flash_attention"] == want,
          f"run Z: {rec_f['launches']['flash_attention']} flash launches, "
          f"expected {want} (requests x groups)")
    rec_c, out_c, first_c = run_serving(torch, mods, "Z-chunked", api_c,
                                        params, prompts, serve=Z_SERVE)
    check(rec_c["launches"]["flash_attention"] == 0,
          "run Z-chunked launched the flash kernel")
    del params
    torch.cuda.empty_cache()

    params = api_f.init(0, torch.float32)
    prompt = olmo_prompts(np, full.vocab_size, 1, PROMPT_MAX, PROMPT_MAX,
                          seed=1)[0]
    batch = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                       device="cuda")}
    f32 = prefill_f32(torch, mods, "Z-f32", (api_f, api_c), params, batch,
                      groups, full.vocab_size, max_len=PROMPT_MAX)
    _, want32 = api_c.prefill(params, batch, max_len=PROMPT_MAX)
    _, got16 = api_c.prefill(bf16_copy(torch, params), batch,
                             max_len=PROMPT_MAX)
    err, noise = normwise(torch, got16, want32)
    print("Z bf16 noise", json.dumps({
        "prompt": PROMPT_MAX, "chunked_bf16_vs_f32_normwise": noise,
        "max_abs_logit_diff": err}))
    del want32, got16
    shared_launches = shared_block_groups(torch, mods, full, params, batch)
    del params
    torch.cuda.empty_cache()
    # a smoke run at full depth: held to the model's own bf16 noise there;
    # Z-shared above discriminates group by group
    flash_vs_chunked(torch, np, "Z", out_f, first_f, out_c, first_c,
                     tol=max(SERVE_LOGIT_TOL, noise),
                     near_tie=max(SERVE_NEAR_TIE, err))

    _, cfg = run_t_cut(torch, mods, "T-zamba", full.name, T_ZAMBA)
    loss_card_vs_cpu(torch, mods, "T-zamba-cpu", cfg,
                     token_batch(torch, np, cfg.vocab_size, CPU_TOKENS, 6),
                     mods["models"].get_model(cfg, device="cpu").init(
                         0, torch.float32),
                     f64_oracle=True, layers=cfg.n_layers, tokens=CPU_TOKENS)
    return rec_f["launches"]["flash_attention"] + shared_launches, f32


def shared_block_groups(torch, mods, full, params, batch):
    """Z-shared: zamba2's shared attention block group by group at bf16,
    flash against chunked on the same input (the residual stream of a
    chunked bf16 forward of ``batch``), held to SERVE_LOGIT_TOL normwise
    at a depth whose own bf16 noise (chunked at bf16 against chunked at
    f32 weights on the same input) must be under SERVE_LOGIT_TOL too; a
    wrong flash call moves the block's output by O(1). Returns the flash
    launches (one a group)."""
    models = mods["models"]
    zamba, common = models.zamba, mods["common"]
    cfg_f = dataclasses.replace(full, attn_impl="flash")
    cfg_c = dataclasses.replace(full, attn_impl="chunked")
    p16 = bf16_copy(torch, params)
    sh16, sh32 = p16["shared"], params["shared"]
    period = full.attn_period
    zero_counters(mods)
    rows = []
    with torch.no_grad():
        x = p16["embed"][batch["tokens"]]
        for g in range(full.n_layers // period):
            for pj in p16["layers"][g * period:(g + 1) * period]:
                x = x + zamba.mamba2_block(pj, common.rms_norm(x, pj["ln"]),
                                           full)
            h = common.rms_norm(x, sh16["ln1"])
            a_f, _ = zamba.attention_block(sh16, h, cfg_f, window=None)
            a_c, _ = zamba.attention_block(sh16, h, cfg_c, window=None)
            a_32, _ = zamba.attention_block(sh32, h.float(), cfg_c,
                                            window=None)
            _, diff = normwise(torch, a_f, a_c)
            _, noise = normwise(torch, a_c, a_32)
            rows.append({"group": g, "flash_vs_chunked": diff,
                         "bf16_noise": noise})
            x = x + a_c
            x = x + zamba.mlp_block(sh16, common.rms_norm(x, sh16["ln2"]))
    launches = mods["ops"].LAUNCHES["flash_attention"]
    rec = {"run": "Z-shared", "prompt": batch["tokens"].shape[1],
           "groups": rows, "flash_launches": launches,
           "tol": SERVE_LOGIT_TOL}
    print("run", json.dumps(rec))
    del p16
    check(launches == len(rows), f"run Z-shared: {launches} flash launches, "
                                 f"expected {len(rows)}")
    check(all(r["bf16_noise"] < SERVE_LOGIT_TOL for r in rows),
          f"run Z-shared: the block's own bf16 noise reaches "
          f"{SERVE_LOGIT_TOL}: the comparison would not discriminate")
    check(all(r["flash_vs_chunked"] <= SERVE_LOGIT_TOL for r in rows),
          f"run Z-shared: flash and chunked differ by more than "
          f"{SERVE_LOGIT_TOL}: {rows}")
    return launches


def run_r(torch, np, mods):
    """R, R-cpu and T-rwkv (rwkv6-7b): no kernel on any of them."""
    full = mods["configs"].get_arch("rwkv6-7b")
    api = mods["models"].get_model(full)
    params = draw_params(torch, mods, api, torch.bfloat16, full.name)
    prompts = olmo_prompts(np, full.vocab_size, R_REQUESTS, PROMPT_MIN,
                           PROMPT_MAX, seed=0)
    rec, _, _ = run_serving(torch, mods, "R", api, params, prompts,
                            serve=R_SERVE)
    check(not any(rec["launches"].values()),
          f"run R launched a kernel: {rec['launches']} (RWKV6 attends "
          f"nothing; its scans are plain PyTorch)")
    del params
    torch.cuda.empty_cache()

    # R-cpu: the card against the host CPU, fed the CPU's greedy tokens
    cfg = dataclasses.replace(full, n_layers=R_CPU["layers"])
    params_cpu = mods["models"].get_model(cfg, device="cpu").init(
        0, torch.float32)
    tok = token_batch(torch, np, cfg.vocab_size, R_CPU["tokens"], 7)
    res, feed = {}, []
    for dev in ("cpu", "cuda"):
        api = mods["models"].get_model(cfg, device=dev)
        params = mods["training"].optim.tree_map(
            lambda t: t.to(dev, copy=True), params_cpu)
        t0 = time.perf_counter()
        cache, logits = api.prefill(params, {"tokens": tok["tokens"].to(dev)})
        # copies: on the host .cpu() aliases, and decode writes in place
        steps = [logits.to("cpu", copy=True)]
        wkv = cache["wkv"].to("cpu", copy=True)
        for i in range(R_CPU["steps"]):
            if dev == "cpu":
                feed.append(torch.argmax(steps[-1], dim=-1))
            logits, cache = api.decode(params, cache, feed[i].to(dev),
                                       R_CPU["tokens"] + i)
            steps.append(logits.to("cpu", copy=True))
        res[dev] = (steps, wkv, time.perf_counter() - t0)
        del params, cache
    rels = [leaf_rel(torch, a, b) for a, b in zip(res["cuda"][0],
                                                  res["cpu"][0])]
    wkv_rel = leaf_rel(torch, res["cuda"][1], res["cpu"][1])
    rec_cpu = {"run": "R-cpu", "layers": cfg.n_layers, "dtype": "float32",
               "prompt": R_CPU["tokens"], "decode_steps": R_CPU["steps"],
               "prefill_logits_rel": rels[0], "decode_logits_rel": rels[1:],
               "wkv_rel": wkv_rel, "cuda_s": res["cuda"][2],
               "cpu_s": res["cpu"][2], "tol": 1e-4}
    print("run", json.dumps(rec_cpu))
    check(max(rels + [wkv_rel]) <= 1e-4,
          f"run R-cpu: the card strays from the host CPU by "
          f"{max(rels + [wkv_rel])} > 1e-4 (normwise)")
    del params_cpu
    torch.cuda.empty_cache()

    rec_t, _ = run_t_cut(torch, mods, "T-rwkv", full.name, T_RWKV)
    check(not any(rec_t["launches"].values()), "run T-rwkv launched a kernel")


def families_phase(torch, np, mods):
    """Phase 4h: the seamless, zamba2 and rwkv6 runs; returns the flash
    launches at bf16 (S, Z) and f32 (S-f32, Z-f32)."""
    t0 = time.perf_counter()
    s_bf16, s_f32 = run_s(torch, np, mods)
    print(f"seamless runs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    z_bf16, z_f32 = run_z(torch, np, mods)
    print(f"zamba2 runs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_r(torch, np, mods)
    print(f"rwkv6 runs: {time.perf_counter() - t0:.1f} s")
    return s_bf16 + z_bf16, s_f32 + z_f32


# ---------------------------------------------------------------------------
# phase 4i: the linear baselines and the model axis
# ---------------------------------------------------------------------------


def nearest_centers(torch, x, centers):
    """Each row of ``x`` labelled by its nearest center (squared
    distances, the lowest index on ties), on the centers' device; also
    the distances."""
    xt = torch.as_tensor(x, device=centers.device)
    d = (torch.sum(xt * xt, 1)[:, None] - 2.0 * xt @ centers.T
         + torch.sum(centers * centers, 1)[None])
    return torch.argmin(d, 1), d


def run_bl_lloyd(torch, np, mods, x_tr, x_te, y_te):
    """BL-lloyd: ``lloyd_kmeans`` at Tab.1's size and settings (C = 10,
    n_init 3, seed 0) on the card and on the host CPU; test accuracy and
    NMI by the nearest center."""
    bl, core = mods["baselines"], mods["core"]
    out = {}
    for dev in ("cuda", "cpu"):
        bl.lloyd.HOST_READS["lloyd"] = 0
        zero_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bl.lloyd_kmeans(x_tr, BL_C, n_init=BL_INIT, seed=0, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        labels = nearest_centers(torch, x_te, res.centers)[0].cpu().numpy()
        reads = bl.lloyd.HOST_READS["lloyd"]
        out[dev] = {"wall_s": wall, "host_reads": reads,
                    "iterations": reads - (BL_INIT - 1),
                    "best_n_iter": res.n_iter, "cost": float(res.cost),
                    "acc": core.clustering_accuracy(y_te, labels),
                    "nmi": core.nmi(y_te, labels),
                    "launches": dict(mods["ops"].LAUNCHES)}
    c, h = out["cuda"], out["cpu"]
    rec = {"run": "BL-lloyd", "n": len(x_tr), "n_test": len(x_te),
           "clusters": BL_C, "n_init": BL_INIT, "card": c, "host_cpu": h,
           "iterations_per_restart": c["iterations"] / BL_INIT,
           "cost_rel": abs(c["cost"] - h["cost"]) / abs(h["cost"]),
           "device": card_line()}
    print("run", json.dumps(rec))
    check(abs(c["acc"] - h["acc"]) <= 0.02 and abs(c["nmi"] - h["nmi"])
          <= 0.02, f"run BL-lloyd: card accuracy / NMI {c['acc']} / "
                   f"{c['nmi']} against the CPU's {h['acc']} / {h['nmi']}")
    check(rec["cost_rel"] <= 1e-4,
          f"run BL-lloyd: cost rel {rec['cost_rel']} > 1e-4")
    check(all(v == 0 for v in c["launches"].values()),
          "run BL-lloyd launched a kernel (its products are plain matmuls)")
    return rec


def sculley_steps(torch, np, mods, x, xd, b, seed):
    """One Fig.8 cell stepped on the card with ``sculley._sgd_step`` on the
    numpy draws ``sgd_minibatch_kmeans`` makes, each step also run on the
    host CPU from the card's state (teacher-forced). Returns (the largest
    normwise distance of the CPU's new centers from the card's over the
    steps whose batch labels agree, batch labels differing outside
    near-ties, batch labels differing at near-ties)."""
    sc = mods["baselines"].sculley
    n = len(x)
    rng = np.random.default_rng(seed)
    init = rng.choice(n, BL_C, replace=False)
    centers = xd[torch.as_tensor(init, device="cuda")]
    counts = torch.zeros(BL_C, dtype=torch.float32, device="cuda")
    worst, bad, tied = 0.0, 0, 0
    for _ in range(max(b, 10)):
        idx = rng.integers(0, n, size=max(n // b, 100))
        xb = xd[torch.as_tensor(idx, device="cuda")]
        xb_c, c_c, n_c = torch.as_tensor(x[idx]), centers.cpu(), counts.cpu()
        d_c = sc._dists(xb_c, c_c)
        lab_g = torch.argmin(sc._dists(xb, centers), 1).cpu()
        lab_c = torch.argmin(d_c, 1)
        m, _ = label_mismatches(torch, lab_g, lab_c, d_c)
        bad, tied = bad + m, tied + int((lab_g != lab_c).sum()) - m
        centers, counts = sc._sgd_step(centers, counts, xb)
        if torch.equal(lab_g, lab_c):
            worst = max(worst, leaf_rel(torch, centers.cpu(),
                                        sc._sgd_step(c_c, n_c, xb_c)[0]))
    return worst, bad, tied


def run_bl_sculley(torch, np, mods):
    """BL-sculley: Fig.8's grid at full size (MNIST-like 60,000 rows,
    B in {1, 4, 16, 64}: batch_size max(n / B, 100), n_iters max(B, 10),
    seeds 0-2) on the card and on the host CPU, which draw the same numpy
    batches. Each cell is also stepped teacher-forced (``sculley_steps``):
    every step's new centers within 1e-5 normwise of the CPU's step from
    the card's state, and no batch label differing outside a near-tie.
    The two whole runs part where a batch label flips at a near-tie, so
    on the cells whose teacher-forced steps saw no flip the whole runs'
    centers are held within 1e-4 normwise and their final labels equal
    outside near-ties; on every cell their accuracy is held within 0.02,
    as BL-lloyd's."""
    bl, core = mods["baselines"], mods["core"]
    x, y = mods["synthetic"].make_mnist_like(N_TRAIN, seed=0)
    xd, xc = torch.as_tensor(x, device="cuda"), torch.as_tensor(x)
    n = len(x)
    table, drift, step_rel, bad, tied, acc_gap = [], 0.0, 0.0, 0, 0, 0.0
    clean, clean_rel, clean_bad = 0, 0.0, 0
    for b in BL_BS:
        kw = dict(batch_size=max(n // b, 100), n_iters=max(b, 10))
        accs, secs = [], []
        for seed in BL_SEEDS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = bl.sgd_minibatch_kmeans(x, BL_C, seed=seed, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rc = bl.sgd_minibatch_kmeans(x, BL_C, seed=seed, device="cpu",
                                         **kw)
            drift = max(drift, leaf_rel(torch, r.centers.cpu(), rc.centers))
            accs.append(core.clustering_accuracy(y, r.labels.cpu().numpy()))
            acc_gap = max(acc_gap, abs(accs[-1] - core.clustering_accuracy(
                y, rc.labels.numpy())))
            w, m, t = sculley_steps(torch, np, mods, x, xd, b, seed)
            step_rel, bad, tied = max(step_rel, w), bad + m, tied + t
            if m + t == 0:   # no batch label flipped: the runs stay together
                clean += 1
                clean_rel = max(clean_rel, leaf_rel(torch, r.centers.cpu(),
                                                    rc.centers))
                clean_bad += label_mismatches(
                    torch, r.labels.cpu(), rc.labels,
                    bl.sculley._dists(xc, rc.centers))[0]
        table.append({"B": b, **kw, "acc_mean": float(np.mean(accs)),
                      "acc_std": float(np.std(accs)),
                      "s_per_call": float(np.mean(secs))})
    rec = {"run": "BL-sculley", "n": n, "clusters": BL_C, "seeds": BL_SEEDS,
           "table": table, "step_centers_rel_max": step_rel,
           "step_label_mismatches": bad, "step_labels_flipped_at_near_ties":
           tied, "whole_run_centers_rel_max": drift,
           "whole_run_acc_gap_max": acc_gap, "cells": len(table) * len(
               BL_SEEDS), "cells_without_flips": clean,
           "unflipped_centers_rel_max": clean_rel,
           "unflipped_label_mismatches": clean_bad,
           "tol": {"step_centers": 1e-5, "unflipped_centers": 1e-4,
                   "acc": 0.02},
           "device": card_line()}
    print("run", json.dumps(rec))
    for row in table:
        print(f"  Sculley B={row['B']:3d}: accuracy {row['acc_mean']:.4f} "
              f"+- {row['acc_std']:.4f}, {row['s_per_call'] * 1e3:.1f} ms "
              f"a call")
    check(step_rel <= 1e-5, f"run BL-sculley: a step's centers differ from "
                            f"the CPU's by {step_rel} > 1e-5 normwise")
    check(bad == 0, f"run BL-sculley: {bad} batch labels differ outside "
                    f"near-ties")
    check(acc_gap <= 0.02, f"run BL-sculley: accuracy differs from the "
                           f"CPU's by {acc_gap} > 0.02")
    check(clean > 0, "run BL-sculley: a batch label flipped in every cell")
    check(clean_rel <= 1e-4, f"run BL-sculley: where no batch label flipped "
                             f"the whole runs' centers differ by {clean_rel} "
                             f"> 1e-4 normwise")
    check(clean_bad == 0, f"run BL-sculley: where no batch label flipped "
                          f"{clean_bad} final labels differ outside "
                          f"near-ties")
    return rec


def tp1_phase(torch, np, mods):
    """TP-1: ``launch.train --arch olmo-1b --mesh 1x1`` (T-olmo's settings
    cut to 2 steps) and ``launch.serve --arch olmo-1b --mesh 1x1`` (run
    F's serving settings and request count, the launcher's own request
    stream; on the card its prefill runs flash) in a world of one over
    NCCL, each against the same call without a mesh: losses, grad norms
    and tokens bitwise equal (a model axis of one is the identity), and
    the mesh runs' collective bill (``distributed.mesh.tally``) empty. Returns the
    flash launches (bf16) of the two serve runs."""
    import datetime
    import os
    import tempfile
    dist = torch.distributed
    train_argv = ["--arch", "olmo-1b", "--steps", str(TP1_STEPS), "--batch",
                  str(T_OLMO["batch"]), "--seq", str(T_OLMO["seq"]),
                  "--log-every", "1"]
    serve_argv = ["--arch", "olmo-1b", "--requests",
                  str(N_REQUESTS), "--prompt-len", str(PROMPT_MAX),
                  "--max-len", str(SERVE["max_len"]), "--max-new-tokens",
                  str(SERVE["max_new_tokens"]), "--max-batch",
                  str(SERVE["max_batch"])]

    def serve(argv):
        zero_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mods["serve"].main(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            mods["ops"].LAUNCHES["flash_attention"], dict(mods["ref"].CALLS)

    plain, rec0 = train_run(torch, mods, "TP-1-plain", train_argv)
    s0 = serve(serve_argv)
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=120))
    try:
        with mods["mesh"].tally() as bill:
            meshed, rec1 = train_run(torch, mods, "TP-1", train_argv
                                     + ["--mesh", "1x1"])
            s1 = serve(serve_argv + ["--mesh", "1x1"])
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want = N_REQUESTS * mods["configs"].get_arch("olmo-1b").n_layers
    rec = {"run": "TP-1", "backend": backend, "mesh": {"data": 1, "model": 1},
           "train": {"losses": meshed.losses, "plain_losses": plain.losses,
                     "grad_norms": meshed.grad_norms,
                     "plain_grad_norms": plain.grad_norms,
                     "median_step_s": rec1["median_step_s"],
                     "plain_median_step_s": rec0["median_step_s"]},
           "serve": {"requests": len(s1[0]),
                     "tokens": sum(len(v) for v in s1[0].values()),
                     "wall_s": s1[1], "plain_wall_s": s0[1],
                     "flash_launches": s1[2],
                     "plain_flash_launches": s0[2]},
           "bill": bill.summary(), "device": card_line()}
    print("run", json.dumps(rec))
    check(meshed.losses == plain.losses
          and meshed.grad_norms == plain.grad_norms,
          "run TP-1: the mesh 1x1 losses or grad norms differ from the "
          "plain run's")
    check(s1[0] == s0[0], "run TP-1: the mesh 1x1 tokens differ from the "
                          "plain serve run's")
    check(s0[2] == s1[2] == want, f"run TP-1: flash launches {s0[2]} / "
                                  f"{s1[2]}, expected {want}")
    check(all(v == 0 for c in (s0[3], s1[3]) for v in c.values()),
          "run TP-1: a plain kernel version ran on the card")
    check(not bill.calls,
          f"run TP-1: the model axis of one launched collectives: "
          f"{bill.calls}")
    return s0[2] + s1[2]


def tp_cpu_child(rank, world, store, axes, out_dir, cases):
    """One rank of TP-cpu (gloo, the host CPU): for each of ``cases``
    ((name, arch, config changes) of a smoke config), 8 greedy tokens and
    one train step's loss on the (data, model) mesh ``axes`` and on the
    whole model in this process."""
    import datetime
    import pickle
    import traceback
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    got = {}
    try:
        from repro_torch.configs import TrainConfig, get_arch
        from repro_torch.distributed.mesh import make_test_mesh
        from repro_torch.models import get_model
        from repro_torch.training import adamw_init, make_train_step
        mesh = make_test_mesh(axes, device="cpu")
        d, dp, tp = mesh.get_local_rank("data"), axes["data"], axes["model"]
        tok = torch.as_tensor(np.random.default_rng(5).integers(
            1, 256, size=(2, 8)))
        lab = torch.roll(tok, -1, 1)
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10)
        for name, arch, changes in cases:
            cfg = dataclasses.replace(get_arch(arch, smoke=True), **changes)
            ep = cfg.n_experts and dp > 1
            if ep:    # expert-parallel: a data rank's row, a model rank's
                cfg = dataclasses.replace(cfg, moe_ep_groups=dp * tp)
            rows = slice(d, d + 1) if ep else slice(0, 2)
            w1 = get_model(cfg, device="cpu")
            w1_dec = get_model(dataclasses.replace(cfg, moe_ep_groups=0),
                               device="cpu")
            api = get_model(cfg, tp_size=tp, dp_size=dp, mesh=mesh,
                            device="cpu")

            # seamless's encoder frames [2, 8, D]
            frames = torch.as_tensor(np.random.default_rng(6).standard_normal(
                (2, 8, cfg.d_model), dtype=np.float32))

            def inputs(batch, rows):
                if cfg.family == "encdec":
                    batch = dict(batch, frames=frames[rows])
                return batch

            def greedy(a, dec, p, t):
                with torch.no_grad():
                    cache, logits = a.prefill(
                        p, inputs({"tokens": t}, slice(0, len(t))),
                        max_len=16)
                    out = [torch.argmax(logits, -1)]
                    for i in range(7):
                        logits, cache = dec.decode(p, cache, out[-1], 8 + i)
                        out.append(torch.argmax(logits, -1))
                return torch.stack(out)

            full = w1.init(0, torch.float32)
            want = greedy(w1, w1_dec, full, tok)[:, rows]
            got_t = greedy(api, api, api.init(0, torch.float32), tok[rows])
            share = slice(d * 2 // dp, (d + 1) * 2 // dp)
            p = api.init(0, torch.float32)
            loss = float(make_train_step(api, tcfg, mesh=mesh)(
                p, adamw_init(p, tcfg),
                inputs({"tokens": tok[share], "labels": lab[share]},
                       share))[2]["loss"])
            w_loss = float(make_train_step(w1, tcfg)(
                full, adamw_init(full, tcfg),
                inputs({"tokens": tok, "labels": lab}, slice(0, 2)))[2][
                    "loss"])
            got[name] = {"ep": bool(ep), "tokens_equal":
                         bool(torch.equal(got_t, want)), "loss": loss,
                         "world1_loss": w_loss,
                         "loss_rel": abs(loss - w_loss) / abs(w_loss)}
    except Exception:
        got = {"error": traceback.format_exc()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(got, f)
    dist.destroy_process_group()


def tp_cpu_phase(torch):
    """TP-cpu: the model axis beyond one rank. The machine holds one card
    and two NCCL ranks cannot share it, so worlds (1, 2) and (2, 2) run
    over gloo on the host CPU in spawned processes at the smoke configs,
    and a world (1, 4) at TP_MID's 2-head configs, each head split over
    two ranks; the three worlds run at once (10 one-thread ranks on the
    host's cores): greedy tokens equal the world-1 run's, one train
    step's loss within 1e-5 relative. A world's ``wall_s`` runs from the
    three worlds' start to the end of its ranks."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    print("TP-cpu: one card cannot hold two NCCL ranks, so a model axis "
          "larger than 1 runs over gloo on the host CPU")
    plain = tuple((a, a, {}) for a in TP_CPU_ARCHS)
    t0 = time.perf_counter()
    worlds = []
    for axes, cases in (({"data": 1, "model": 2}, plain),
                        ({"data": 2, "model": 2}, plain),
                        ({"data": 1, "model": 4}, TP_MID)):
        world = axes["data"] * axes["model"]
        out_dir = tempfile.mkdtemp()
        worlds.append((axes, cases, world, out_dir, mp.start_processes(
            tp_cpu_child, args=(world, f"{out_dir}/store", axes, out_dir,
                                cases),
            nprocs=world, join=False, start_method="spawn")))
    recs = []
    for axes, cases, world, out_dir, ctx in worlds:
        while not ctx.join():
            pass
        ranks = []
        for r in range(world):
            with open(f"{out_dir}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        shutil.rmtree(out_dir, ignore_errors=True)
        for got in ranks:
            check("error" not in got, f"TP-cpu {axes}: {got.get('error')}")
        rec = {"run": "TP-cpu", "mesh": axes, "backend": "gloo",
               "mid_head": cases is TP_MID,
               "wall_s": time.perf_counter() - t0, "archs": ranks[0],
               "tol": {"loss": 1e-5}}
        print("run", json.dumps(rec))
        for got in ranks:
            for arch, g in got.items():
                check(g["tokens_equal"], f"TP-cpu {axes} {arch}: greedy "
                                         f"tokens differ from world 1's")
                check(g["loss_rel"] <= 1e-5, f"TP-cpu {axes} {arch}: loss "
                                             f"rel {g['loss_rel']} > 1e-5")
        recs.append(rec)
    return recs


def baselines_tp_phase(torch, np, mods, x_tr, x_te, y_te):
    """Phase 4i: BL-lloyd, BL-sculley, TP-1 and TP-cpu; returns the flash
    launches (bf16) of TP-1."""
    t0 = time.perf_counter()
    run_bl_lloyd(torch, np, mods, x_tr, x_te, y_te)
    print(f"BL-lloyd: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_bl_sculley(torch, np, mods)
    print(f"BL-sculley: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = tp1_phase(torch, np, mods)
    print(f"TP-1: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_cpu_phase(torch)
    print(f"TP-cpu: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 4j: the model axis of the encdec and ssm families, the dry run and
# the examples
# ---------------------------------------------------------------------------


def dry_start(tmp: str) -> list:
    """Start each DRY_CELLS cell of ``launch.dryrun`` in its own process on
    the host CPU (the card hidden from it); they run while the card works."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for i, cell in enumerate(DRY_CELLS):
        out = f"{tmp}/dry{i}"
        procs.append((cell, out, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out,
             *cell], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def dry_finish(procs) -> list:
    """DRY: wait for the cells, print each cell's terms and trace seconds;
    every cell ok, olmo's single-pod / multi-pod train flops within
    1.6-2.4, and collective bytes in every cell (the model axis splits
    each of them)."""
    import os
    recs = []
    for cell, out, t0, proc in procs:
        try:
            log, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - t0
        print(f"DRY {' '.join(cell)}: exit {proc.returncode}, {wall:.1f} s "
              f"after phase 4j's start")
        for line in log.splitlines()[-4:]:
            print("  dryrun", line)
        check(proc.returncode == 0, f"DRY {' '.join(cell)}: exit "
                                    f"{proc.returncode}")
        for name in sorted(os.listdir(out)):
            d = json.load(open(f"{out}/{name}"))
            rec = {"run": "DRY", "cell": name[:-5], "ok": d["ok"],
                   "smoke": "--smoke" in cell,
                   **{k: d.get(k) for k in (
                       "n_params", "n_active_params", "tokens_per_step",
                       "model_flops_total", "flops_per_device",
                       "bytes_per_device", "trace_seconds")},
                   "collective_bytes": d["collectives"]["total_bytes"],
                   "collective_counts": {k: v for k, v in d["collectives"][
                       "counts"].items() if v},
                   "memory": d["memory_analysis"]}
            print("run", json.dumps(rec))
            check(d["ok"], f"DRY {name}: not ok: {d.get('error')}")
            check(d["collectives"]["total_bytes"] > 0,
                  f"DRY {name}: no collective bytes, yet the model axis "
                  f"splits the cell")
            recs.append(rec)
    flops = {r["cell"]: r["flops_per_device"] for r in recs
             if not r["smoke"]}
    ratio = flops["olmo-1b__train_4k__sp"] / flops["olmo-1b__train_4k__mp"]
    print(f"DRY olmo-1b train_4k flops a device, single / multi-pod: "
          f"{ratio!r}")
    check(1.6 <= ratio <= 2.4, f"DRY: olmo-1b's sp / mp train flops ratio "
                               f"{ratio} outside 1.6-2.4")
    return recs


def s_train(torch, np, mods, name, cfg, mesh):
    """TP1_STEPS train steps of the seamless cut ``cfg`` (bf16, S_TRAIN's
    frames and tokens from default_rng(8)) on ``mesh`` (None: no mesh);
    returns (losses, grad norms)."""
    rng = np.random.default_rng(8)
    b = S_TRAIN["batch"]
    frames = torch.as_tensor(rng.standard_normal(
        (b, S_TRAIN["frames"], cfg.d_model), dtype=np.float32),
        device="cuda").to(torch.bfloat16)
    tok = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                       size=(b, S_TRAIN["tokens"])),
                          device="cuda")
    batch = {"frames": frames, "tokens": tok, "labels": torch.roll(tok, -1, 1)}
    kw = {} if mesh is None else dict(tp_size=1, dp_size=1, mesh=mesh)
    api = mods["models"].get_model(cfg, **kw)
    params = api.init(0, torch.bfloat16)
    tcfg = mods["configs"].TrainConfig(learning_rate=3e-4, warmup_steps=1,
                                       total_steps=10)
    step = mods["training"].make_train_step(api, tcfg, mesh=mesh)
    opt = mods["training"].adamw_init(params, tcfg)
    losses, norms = [], []
    t0 = time.perf_counter()
    for _ in range(TP1_STEPS):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    print(f"{name}: {TP1_STEPS} steps in {time.perf_counter() - t0:.2f} s, "
          f"losses {losses}")
    return losses, norms


def tp1_models_phase(torch, np, mods):
    """TP-1-S and TP-1-R: seamless-m4t-medium and rwkv6-7b at published
    widths on a mesh (1, 1) in a NCCL world of one, each against the same
    calls without a mesh (run first, with no world up): tokens, losses
    and grad norms bitwise equal, an empty collective bill. Returns the
    flash launches (bf16) of the two seamless serve runs."""
    import datetime
    import os
    import tempfile
    dist = torch.distributed
    full_s = mods["configs"].get_arch("seamless-m4t-medium")
    flash_s = dataclasses.replace(full_s, attn_impl="flash")
    cut_s = dataclasses.replace(full_s, n_layers=2 * S_CPU["layers"],
                                n_enc_layers=S_CPU["layers"],
                                n_dec_layers=S_CPU["layers"])
    full_r = mods["configs"].get_arch("rwkv6-7b")
    cut_r = dataclasses.replace(full_r, n_layers=T_RWKV["layers"])
    requests = seamless_requests(np, full_s, S_FRAMES, seed=0)
    serve_argv = ["--arch", "rwkv6-7b", "--requests", str(R_REQUESTS),
                  "--prompt-len", str(PROMPT_MAX), "--max-len",
                  str(R_SERVE["max_len"]), "--max-new-tokens",
                  str(R_SERVE["max_new_tokens"]), "--max-batch",
                  str(R_SERVE["max_batch"])]
    train_argv = ["--arch", "rwkv6-7b", "--steps", str(TP1_STEPS), "--batch",
                  str(T_RWKV["batch"]), "--seq", str(T_RWKV["seq"]),
                  "--log-every", "1"]

    def serve_r(argv):
        zero_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mods["serve"].main(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(mods["ops"].LAUNCHES)

    def runs(mesh, tag):
        kw = {} if mesh is None else dict(tp_size=1, dp_size=1, mesh=mesh)
        api = mods["models"].get_model(flash_s, **kw)
        params = draw_params(torch, mods, api, torch.bfloat16,
                             f"{full_s.name} ({tag})")
        rec, out, _ = run_seamless(torch, mods, f"TP-1-S{tag}", api, params,
                                   requests)
        del params
        torch.cuda.empty_cache()
        train = s_train(torch, np, mods, f"TP-1-S{tag} train", cut_s, mesh)
        torch.cuda.empty_cache()
        served = serve_r(serve_argv + (["--mesh", "1x1"] if mesh else []))
        torch.cuda.empty_cache()
        trained, trec = train_run(torch, mods, f"TP-1-R{tag} train",
                                  train_argv + (["--mesh", "1x1"] if mesh
                                                else []), cfg=cut_r)
        trained.params = trained.opt = None     # the losses are compared
        torch.cuda.empty_cache()
        return rec, out, train, served, trained, trec

    plain = runs(None, "-plain")
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = mods["mesh"].make_test_mesh({"data": 1, "model": 1},
                                           device="cuda")
        with mods["mesh"].tally() as bill:
            meshed = runs(mesh, "")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want = len(S_FRAMES) * (full_s.n_enc_layers + full_s.n_dec_layers)
    flash = [r[0]["launches"]["flash_attention"] for r in (plain, meshed)]
    rec = {"run": "TP-1-S/R", "backend": backend,
           "mesh": {"data": 1, "model": 1},
           "S": {"prefill_s": [r[0]["prefill_s"] for r in (plain, meshed)],
                 "decode_s": [r[0]["decode_s"] for r in (plain, meshed)],
                 "flash_launches": flash,
                 "train_losses": [r[2][0] for r in (plain, meshed)]},
           "R": {"serve_wall_s": [r[3][1] for r in (plain, meshed)],
                 "tokens": sum(len(v) for v in meshed[3][0].values()),
                 "launches": [r[3][2] for r in (plain, meshed)],
                 "train_losses": [r[4].losses for r in (plain, meshed)],
                 "median_step_s": [r[5]["median_step_s"]
                                   for r in (plain, meshed)]},
           "bill": bill.summary(), "device": card_line()}
    print("run", json.dumps(rec))
    check(plain[1] == meshed[1], "run TP-1-S: the mesh 1x1 tokens differ "
                                 "from the plain run's")
    check(plain[2] == meshed[2], "run TP-1-S: the mesh 1x1 train losses or "
                                 "grad norms differ from the plain run's")
    check(flash == [want, want], f"run TP-1-S: flash launches {flash}, "
                                 f"expected {want} each")
    check(plain[3][0] == meshed[3][0], "run TP-1-R: the mesh 1x1 tokens "
                                       "differ from the plain serve run's")
    check(not any(v for r in (plain, meshed) for v in r[3][2].values()),
          "run TP-1-R: RWKV6's serving launched a kernel")
    check(plain[4].losses == meshed[4].losses
          and plain[4].grad_norms == meshed[4].grad_norms,
          "run TP-1-R: the mesh 1x1 train losses or grad norms differ")
    check(not bill.calls,
          f"run TP-1-S/R: the model axis of one launched collectives: "
          f"{bill.calls}")
    return sum(flash)


def example(name: str):
    """The module of ``examples/<name>.py`` of this checkout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(torch, mods) -> dict:
    """EX: the five examples on the card at their defaults, the MD one also
    at MD_FULL; prints accuracy, NMI, the plan, wall and launches of each.
    Checks: the MD runs' NMI >= 0.9, quickstart's XOR kernel accuracy at
    least its linear one, and a rerun of torch_train_lm.py continuing from
    its checkpoint. Returns the launches {kernel or (kernel, body): n}."""
    import tempfile
    got = {}

    def run(label, name, argv):
        zero_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = example(name).main(list(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(mods["ops"].LAUNCHES)
        calls = dict(mods["ref"].CALLS)
        for k, v in launches.items():
            got[k] = got.get(k, 0) + v
        rec = {"run": f"EX {label}", "argv": list(argv), "wall_s": wall,
               "launches": {k: v for k, v in launches.items() if v},
               "device": card_line()}
        if isinstance(out, dict):
            rec.update({k: v for k, v in out.items() if k in (
                "acc", "nmi", "b", "s", "toy_acc", "toy_nmi", "sparse_acc",
                "sparse_nmi", "xor_linear_acc", "xor_kernel_acc",
                "seconds")})
        print("run", json.dumps(rec))
        check(not any(calls.values()), f"run EX {label}: a plain kernel "
                                       f"version ran on the card: {calls}")
        return out, rec

    q, _ = run("quickstart", "torch_quickstart", [])
    check(q["xor_kernel_acc"] >= q["xor_linear_acc"],
          f"run EX quickstart: kernel accuracy {q['xor_kernel_acc']} below "
          f"linear {q['xor_linear_acc']} on the XOR set")
    for label, argv in (("md", ()), ("md-full", MD_FULL)):
        md, _ = run(label, "torch_cluster_md_trajectory", argv)
        check(md["nmi"] >= 0.9, f"run EX {label}: NMI {md['nmi']} against "
                                f"the true states < 0.9")
    run("activations", "torch_cluster_activations", [])
    ckpt = tempfile.mkdtemp()
    first, _ = run("train_lm", "torch_train_lm", ["--ckpt-dir", ckpt])
    again, _ = run("train_lm-resume", "torch_train_lm",
                   ["--ckpt-dir", ckpt, "--steps", "150"])
    check(len(first.losses) == 100 and len(again.losses) == 50
          and all(math.isfinite(v) for v in again.losses),
          f"run EX train_lm: {len(first.losses)} steps, then "
          f"{len(again.losses)} resumed from step 100 (want 100, 50)")
    shutil.rmtree(ckpt, ignore_errors=True)
    served, _ = run("serve_lm", "torch_serve_lm", [])
    check(len(served) == 12 and all(len(v) == 12 for v in served.values()),
          "run EX serve_lm: not 12 requests of 12 tokens")
    check(got["assign_fused"] > 0 and got["kernel_matrix"] > 0
          and got["flash_attention"] > 0,
          f"run EX: a kernel of the examples never launched: {got}")
    return got


def models_examples_phase(torch, np, mods) -> dict:
    """Phase 4j: DRY (started first, on the host), TP-1-S / TP-1-R and EX;
    returns the launches {kernel or (kernel, body): n}."""
    import tempfile
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    procs = dry_start(tmp)
    try:
        t0 = time.perf_counter()
        flash_tp = tp1_models_phase(torch, np, mods)
        print(f"TP-1-S / TP-1-R: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ex = examples_phase(torch, mods)
        print(f"EX: {time.perf_counter() - t0:.1f} s")
    except BaseException:
        for _, _, _, proc in procs:
            proc.kill()
            proc.wait()
        raise
    t0 = time.perf_counter()
    dry_finish(procs)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"DRY: waited {time.perf_counter() - t0:.1f} s more")
    print(f"phase 4j: {time.perf_counter() - t_phase:.1f} s; card: "
          f"{card_line()}")
    return {"assign_fused": ex["assign_fused"],
            "kernel_matrix": ex["kernel_matrix"],
            ("assign_fused", "f32"): ex["assign_fused"],
            ("kernel_matrix", "column"): ex["kernel_matrix_column"],
            ("flash_attention", "bf16"): flash_tp + ex["flash_attention"]}


# ---------------------------------------------------------------------------
# phase 4k: gemma2-2b as published
# ---------------------------------------------------------------------------


def run_gm(torch, np, mods) -> int:
    """GM / GM-chunked: gemma2-2b as published (bf16 weights drawn on the
    card from seed 0) served through ServingEngine at GM_SERVE to
    GM_REQUESTS prompts of PROMPT_MIN-4096 tokens and one of GM_LONG,
    with flash (13 launches a request: one a global layer; the windowed
    layers chunked) and with chunked attention on the same weights and
    prompts, held as run F's (``flash_vs_chunked``, SERVE_LOGIT_TOL).
    Returns GM's flash launches."""
    configs, models = mods["configs"], mods["models"]
    base = configs.get_arch("gemma2-2b")
    api_f = models.get_model(dataclasses.replace(base, attn_impl="flash"))
    api_c = models.get_model(dataclasses.replace(base, attn_impl="chunked"))
    t0 = time.perf_counter()
    params = api_f.init(0, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves_of(mods, params))
    print(f"gemma2-2b: {n_params} parameters, bf16, drawn on the card from "
          f"seed 0 in {time.perf_counter() - t0:.2f} s")
    prompts = olmo_prompts(np, base.vocab_size, GM_REQUESTS, PROMPT_MIN,
                           base.window, seed=0) + \
        olmo_prompts(np, base.vocab_size, 1, GM_LONG, GM_LONG, seed=1)
    global_layers = base.n_layers // base.local_global_period
    rec_f, out_f, first_f = run_serving(torch, mods, "GM", api_f, params,
                                        prompts, serve=GM_SERVE)
    want = len(prompts) * global_layers
    check(rec_f["launches"]["flash_attention"] == want,
          f"run GM: {rec_f['launches']['flash_attention']} flash launches, "
          f"expected {want} ({len(prompts)} requests x {global_layers} "
          f"global layers)")
    rec_c, out_c, first_c = run_serving(torch, mods, "GM-chunked", api_c,
                                        params, prompts, serve=GM_SERVE)
    check(rec_c["launches"]["flash_attention"] == 0,
          "run GM-chunked launched the flash kernel")
    del params
    flash_vs_chunked(torch, np, "GM", out_f, first_f, out_c, first_c)
    return rec_f["launches"]["flash_attention"]


def tp1_gm(torch, mods) -> int:
    """TP-1-GM: ``launch.serve --arch gemma2-2b`` at the launcher's own
    settings (16 requests, flash on the card by rule) without a mesh, then
    with ``--mesh 1x1`` in a NCCL world of one: tokens bitwise equal, 16 x
    13 flash launches each, an empty collective bill. Returns the flash
    launches of both."""
    import datetime
    import os
    import tempfile
    dist = torch.distributed
    argv = ["--arch", "gemma2-2b"]

    def serve(a):
        zero_counters(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mods["serve"].main(a)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, \
            mods["ops"].LAUNCHES["flash_attention"], dict(mods["ref"].CALLS)

    s0 = serve(argv)
    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0),
        timeout=datetime.timedelta(seconds=120))
    try:
        with mods["mesh"].tally() as bill:
            s1 = serve(argv + ["--mesh", "1x1"])
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    cfg = mods["configs"].get_arch("gemma2-2b")
    want = len(s0[0]) * (cfg.n_layers // cfg.local_global_period)
    rec = {"run": "TP-1-GM", "backend": backend,
           "mesh": {"data": 1, "model": 1}, "requests": len(s1[0]),
           "tokens": sum(len(v) for v in s1[0].values()),
           "wall_s": s1[1], "plain_wall_s": s0[1],
           "flash_launches": s1[2], "plain_flash_launches": s0[2],
           "bill": bill.summary(), "device": card_line()}
    print("run", json.dumps(rec))
    check(len(s0[0]) == 16 and s1[0] == s0[0],
          "run TP-1-GM: the mesh 1x1 tokens differ from the plain serve "
          "run's")
    check(s0[2] == s1[2] == want, f"run TP-1-GM: flash launches {s0[2]} / "
                                  f"{s1[2]}, expected {want}")
    check(all(v == 0 for c in (s0[3], s1[3]) for v in c.values()),
          "run TP-1-GM: a plain kernel version ran on the card")
    check(not bill.calls,
          f"run TP-1-GM: the model axis of one launched collectives: "
          f"{bill.calls}")
    return s0[2] + s1[2]


def gemma_phase(torch, np, mods) -> int:
    """Phase 4k: GM, GM-chunked and TP-1-GM; returns the flash launches
    (bf16)."""
    t0 = time.perf_counter()
    launches = run_gm(torch, np, mods)
    torch.cuda.empty_cache()
    launches += tp1_gm(torch, mods)
    torch.cuda.empty_cache()
    print(f"phase 4k: {time.perf_counter() - t0:.1f} s; card: "
          f"{card_line()}")
    return launches


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    global T_START
    T_START = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import importlib
    mods = {name: importlib.import_module(f"repro_torch.{path}") for name, path
            in [("ops", "kernels.ops"), ("ref", "kernels.ref"),
                ("build", "kernels.build"), ("precision", "kernels.precision"),
                ("kernel_matrix", "kernels.kernel_matrix"),
                ("kernel_ab", "launch.kernel_ab"),
                ("core", "core"), ("synthetic", "data.synthetic"),
                ("approx", "approx"), ("configs", "configs"),
                ("models", "models"), ("serving", "serving"),
                ("selectors", "approx.selectors"),
                ("serve_bench", "launch.serve_bench"),
                ("sparse", "data.sparse"), ("loader", "data.loader"),
                ("assign", "serving.assign"), ("sampling", "data.sampling"),
                ("init", "core.init"), ("kkmeans", "core.kkmeans"),
                ("minibatch", "core.minibatch"),
                ("dmesh", "distributed"), ("ft", "ft"), ("obs", "obs"),
                ("outer", "distributed.outer"), ("inner", "distributed.inner"),
                ("cluster", "launch.cluster"), ("hlocost", "launch.hlocost"),
                ("audit", "launch.audit"), ("train", "launch.train"),
                ("training", "training"), ("mlp", "models.mlp"),
                ("common", "models.common"), ("baselines", "baselines"),
                ("serve", "launch.serve"), ("mesh", "distributed.mesh")]}
    core = mods["core"]

    # -- phase 1: the card --------------------------------------------------
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"tf32 flags: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32} -> both False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    mods["build"].load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({mods['build'].LAST_BUILD['path']})")
    for line in mods["build"].LAST_BUILD["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas", line.strip())
    redesigned_bodies(mods["build"])

    # -- phase 3: kernel checks ---------------------------------------------
    t0 = time.perf_counter()
    x, y = mods["synthetic"].make_mnist_like(N_TRAIN + N_TEST, seed=0)
    x_tr, y_tr = x[:N_TRAIN], y[:N_TRAIN]
    x_te, y_te = x[N_TRAIN:], y[N_TRAIN:]
    gamma = core.gamma_from_dmax(torch.as_tensor(x_tr[:4096], device="cuda"))
    print(f"data: {x_tr.shape} train, {x_te.shape} test, gamma {gamma!r} "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    xr, yr = mods["synthetic"].make_rcv1_like(RCV1_TRAIN + RCV1_TEST,
                                              n_classes=RCV1_C, seed=0)
    xr_tr, yr_tr = xr[:RCV1_TRAIN], yr[:RCV1_TRAIN]
    xr_te, yr_te = xr[RCV1_TRAIN:], yr[RCV1_TRAIN:]
    print(f"data: rcv1-like {xr_tr.shape} train, {xr_te.shape} test "
          f"(generator {time.perf_counter() - t0:.1f} s)")
    x_b = torch.as_tensor(x_tr[0::4], device="cuda")   # batch 0 under B=4
    y_b = torch.as_tensor(y_tr[0::4], device="cuda")
    t0 = time.perf_counter()
    recs = kernel_checks(torch, mods, x_b, y_b, gamma)
    recs += skinny_checks(torch, mods, x_b, torch.as_tensor(x_te, device="cuda"),
                          torch.as_tensor(x_tr, device="cuda"),
                          torch.as_tensor(xr_tr, device="cuda"), gamma)
    del x_b, y_b
    recs += embedded_checks(
        torch, mods, torch.as_tensor(x_tr, device="cuda"),
        torch.as_tensor(y_tr, device="cuda"), gamma,
        torch.as_tensor(xr_tr, device="cuda"),
        torch.as_tensor(yr_tr, device="cuda"))
    recs += serving_checks(
        torch, mods, torch.as_tensor(x_tr, device="cuda"),
        torch.as_tensor(y_tr, device="cuda"),
        torch.as_tensor(x_te, device="cuda"), gamma,
        torch.as_tensor(xr_tr, device="cuda"),
        torch.as_tensor(yr_tr, device="cuda"),
        torch.as_tensor(xr_te, device="cuda"))
    recs += flash_checks(torch, mods)
    torch.cuda.empty_cache()
    print(f"kernel checks: {len(recs)} passed ({time.perf_counter() - t0:.1f} s)")

    # -- phase 4: the main path ---------------------------------------------
    spec = core.KernelSpec("rbf", gamma=gamma)
    base = dict(n_clusters=10, n_batches=4, kernel=spec, seed=0)
    totals = {"kernel_matrix": 0, "assign_fused": 0}
    # launches of the bodies, (kernel, tile dtype)
    bodies = {("assign_fused", "f32"): 0, ("assign_fused", "bf16"): 0,
              ("kernel_matrix", "column"): 0}
    iters = 0
    runs, fits = {}, {}
    for name, kw in [("A", dict(s=1.0, engine="fused")),
                     ("A-repeat", dict(s=1.0, engine="fused")),
                     ("B-fused", dict(s=0.2, engine="fused")),
                     ("B-materialize", dict(s=0.2, engine="materialize")),
                     ("C", dict(s=0.2, engine="fused", precision="bf16")),
                     ("A-rls", dict(s=0.2, engine="fused", selector="rls"))]:
        rec, labels, res = run_fit(torch, mods, name,
                                   core.MiniBatchConfig(**base, **kw),
                                   x_tr, x_te, y_te)
        runs[name] = (rec, labels)
        if name == "A":
            fits[name] = res
        for k in totals:
            totals[k] += rec["launches"][k]
        bodies["assign_fused", rec["precision"]] += \
            rec["launches"]["assign_fused"]
        bodies["kernel_matrix", "column"] += \
            rec["launches"]["kernel_matrix_column"]
        iters += sum(rec["inner_iters"])
        # every k-means++ column and Eq.8 / predict block takes the column
        # body; only materialize's Gram builds (one a batch) and RLS's
        # K(X, pilot) and K_SS (two a batch) take the tile
        km, col = (rec["launches"]["kernel_matrix"],
                   rec["launches"]["kernel_matrix_column"])
        print(f"run {name}: kernel_matrix {km} launches, {col} on the "
              f"column body")
        tile = base["n_batches"] * ((kw["engine"] == "materialize")
                                    + 2 * (kw.get("selector") == "rls"))
        check(km - col == tile, f"run {name}: {km - col} kernel_matrix "
                                f"launches took the tile body, not {tile}")
    a1, a2 = runs["A"][0], runs["A-repeat"][0]
    print(f"run A then its repeat: fit {a1['fit_s']!r} / {a2['fit_s']!r} s, "
          f"labelling {a1['label_s']!r} / {a2['label_s']!r} s")
    check(runs["A-rls"][0]["nmi"] >= 0.9,
          f"run A-rls: test NMI {runs['A-rls'][0]['nmi']} < 0.9")
    wall_f = runs["B-fused"][0]["wall_s"]
    wall_m = runs["B-materialize"][0]["wall_s"]
    print(f"B-fused wall {wall_f!r} s vs B-materialize {wall_m!r} s: "
          f"ratio {wall_f / wall_m!r}")
    agree = float((runs["B-fused"][1] == runs["B-materialize"][1]).mean())
    nmi_cb = core.nmi(runs["B-fused"][1], runs["C"][1])
    print(f"B fused vs materialize test-label agreement {agree!r}; "
          f"NMI(C, B fused) {nmi_cb!r}")
    check(agree >= 0.995, f"fused and materialize disagree: {agree}")
    check(nmi_cb >= 0.95, f"bf16 run strays from f32: NMI {nmi_cb}")

    # the embedded methods: Fig.5 (MNIST, rbf) and Tab.2 (RCV1 dense view)
    totals.update(embed_assign=0, sketch_assign=0)
    fig5 = dict(n_clusters=10, n_batches=1, kernel=spec, seed=0,
                embed_dim=EMBED_DIM)
    tab2 = dict(n_clusters=RCV1_C, n_batches=4, seed=0, method="sketch",
                kernel=core.KernelSpec("linear"), embed_dim=SKETCH_DIM)
    for name, kw, data in [
            ("D-rff", dict(fig5, method="rff"), (x_tr, y_tr, x_te, y_te)),
            ("D-nystrom", dict(fig5, method="nystrom"),
             (x_tr, y_tr, x_te, y_te)),
            ("D-rff-bf16", dict(fig5, method="rff", precision="bf16"),
             (x_tr, y_tr, x_te, y_te)),
            ("D-nystrom-rls", dict(fig5, method="nystrom", selector="rls"),
             (x_tr, y_tr, x_te, y_te)),
            ("D-nystrom-kpp", dict(fig5, method="nystrom", selector="kpp"),
             (x_tr, y_tr, x_te, y_te)),
            ("E-sketch", tab2, (xr_tr, yr_tr, xr_te, yr_te)),
            ("E-sketch-repeat", tab2, (xr_tr, yr_tr, xr_te, yr_te)),
            ("E-sketch-bf16", dict(tab2, precision="bf16"),
             (xr_tr, yr_tr, xr_te, yr_te))]:
        rec, labels, res = run_embedded(torch, mods, name,
                                        core.MiniBatchConfig(**kw), *data)
        runs[name] = (rec, labels)
        fits[name] = res
        for k in totals:
            totals[k] += rec["launches"][k]
        iters += sum(rec["inner_iters"])
        bodies["kernel_matrix", "column"] += \
            rec["launches"]["kernel_matrix_column"]
        print(f"run {name}: kernel_matrix {rec['launches']['kernel_matrix']} "
              f"launches, {rec['launches']['kernel_matrix_column']} on the "
              f"column body")
        kernel = "sketch_assign" if kw["method"] == "sketch" else \
            "embed_assign"
        check(rec["launches"][kernel] > 0,
              f"run {name}: {kernel} never launched")
        for tile, n in rec["launches_by_tile"].items():
            bodies[kernel, tile] = bodies.get((kernel, tile), 0) + n
    for name in ("D-nystrom-rls", "D-nystrom-kpp"):
        check(runs[name][0]["nmi"] >= 0.9,
              f"run {name}: test NMI {runs[name][0]['nmi']} < 0.9")
    nmi_d = core.nmi(runs["D-rff"][1], runs["D-rff-bf16"][1])
    nmi_e = core.nmi(runs["E-sketch"][1], runs["E-sketch-bf16"][1])
    print(f"NMI(D-rff-bf16, D-rff) {nmi_d!r}; NMI(E-sketch-bf16, E-sketch) "
          f"{nmi_e!r}")
    check(nmi_d >= 0.95, f"bf16 D-rff strays from f32: NMI {nmi_d}")
    # one seed, one fit: the sketch sums in a fixed order on the card
    e1, e2 = runs["E-sketch"], runs["E-sketch-repeat"]
    check(e1[0]["inner_iters"] == e2[0]["inner_iters"]
          and bool((e1[1] == e2[1]).all()),
          "E-sketch is not repeatable: two runs of one seed differ")
    # the two E fits part at their seeding; bf16 tiles on one fitted state
    # move only near-tied rows
    fit_e = fits["E-sketch"]
    lab32, lab16 = (mods["approx"].predict_embedded(
        xr_tr, fit_e.state, fit_e.fmap, precision=prec)
        for prec in ("f32", "bf16"))
    agree_e = float((lab32 == lab16).float().mean())
    print(f"E-sketch repeat: equal iterations and labels; its training "
          f"labels at bf16 vs f32 tiles agree on {agree_e!r}")
    check(agree_e >= 0.99, f"bf16 sketch_assign strays from f32 on one "
                           f"fitted state: agreement {agree_e}")
    check(all(v > 0 for v in totals.values())
          and all(v > 0 for v in bodies.values()),
          f"a kernel never launched on the main path: {totals} {bodies}")
    small_reference_fit(torch, mods)
    t0 = time.perf_counter()
    served, svc = run_g(torch, np, mods, fits, x_te, xr_te)
    for (k, body), n in served.items():
        totals[k] += n
        bodies[k, body] = bodies.get((k, body), 0) + n
    serve_bench_run(torch, mods, svc)
    print(f"run G and serve_bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp_totals, sp_bodies, stream = sparse_runs(torch, np, mods, x_tr, x_te,
                                               y_te, spec, fits["D-rff"])
    for k, n in sp_totals.items():
        totals[k] += n
    for key, n in sp_bodies.items():
        bodies[key] = bodies.get(key, 0) + n
    print(f"sparse rows and ingestion: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    m_totals, m_bodies, m_recs = mesh_phase(torch, np, mods, x_tr, x_te, y_te,
                                            spec, runs, fits, stream)
    for k, n in m_totals.items():
        totals[k] += n
    for key, n in m_bodies.items():
        bodies[key] = bodies.get(key, 0) + n
    recs += m_recs
    print(f"mesh: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    o_totals, o_bodies = obs_phase(torch, np, mods, x_tr, y_tr, x_te, y_te,
                                   spec, runs, fits, stream)
    for k, n in o_totals.items():
        totals[k] += n
    for key, n in o_bodies.items():
        bodies[key] = bodies.get(key, 0) + n
    del stream
    print(f"obs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zero_counters(mods)
    a_totals, a_bodies = audit_phase(torch, mods, x_tr, gamma)
    torch.distributed.destroy_process_group()
    for k, n in a_totals.items():
        totals[k] = totals.get(k, 0) + n
    for key, n in a_bodies.items():
        bodies[key] = bodies.get(key, 0) + n
    print(f"audit: {time.perf_counter() - t0:.1f} s")
    del fits, runs, svc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_bf16, flash_f32 = serving_runs(torch, np, mods)
    print(f"serving runs: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_bf16, moe_f32 = train_phase(torch, np, mods)
    print(f"training and MoE runs: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fam_bf16, fam_f32 = families_phase(torch, np, mods)
    print(f"encoder-decoder, hybrid and RWKV6 runs: "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_bf16 = baselines_tp_phase(torch, np, mods, x_tr, x_te, y_te)
    print(f"baselines and model-axis runs: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    j = models_examples_phase(torch, np, mods)
    torch.cuda.empty_cache()
    gm_bf16 = gemma_phase(torch, np, mods)
    for key, n in j.items():
        if isinstance(key, tuple):
            if key != ("flash_attention", "bf16"):
                bodies[key] = bodies.get(key, 0) + n
        else:
            totals[key] += n
    bodies["flash_attention", "bf16"] = flash_bf16 + moe_bf16 + fam_bf16 + \
        tp_bf16 + j["flash_attention", "bf16"] + gm_bf16
    bodies["flash_attention", "f32"] = flash_f32 + moe_f32 + fam_f32
    totals["flash_attention"] = bodies["flash_attention", "bf16"] + \
        bodies["flash_attention", "f32"]
    check(all(v > 0 for v in totals.values()),
          f"a kernel never launched on the main path: {totals}")

    # -- phase 5: result lines ----------------------------------------------
    # one entry per kernel, from its first timed record, with the launches
    # of all its bodies; the kernels whose two bodies both run on the main
    # path also get one entry per body, named by its tile dtype
    src = {"kernel_matrix": ("src/repro_torch/kernels/csrc/kernel_matrix.cu",
                             "src/repro/kernels/kernel_matrix.py:78"),
           "assign_fused": ("src/repro_torch/kernels/csrc/assign.cu",
                            "src/repro/kernels/assign.py:146"),
           "embed_assign": ("src/repro_torch/kernels/csrc/embed_assign.cu",
                            "src/repro/kernels/embed_assign.py:111"),
           "sketch_assign": ("src/repro_torch/kernels/csrc/sketch_assign.cu",
                             "src/repro/kernels/sketch_assign.py:111"),
           "flash_attention": (
               "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:85")}
    # (name, kernel, the body's tile dtype or kernel_matrix's body)
    entries = [("assign_fused", "assign_fused", None),
               ("assign_fused_f32", "assign_fused", "f32"),
               ("assign_fused_bf16", "assign_fused", "bf16"),
               ("kernel_matrix", "kernel_matrix", None),
               ("kernel_matrix_column", "kernel_matrix", "column"),
               ("embed_assign", "embed_assign", None),
               ("embed_assign_f32", "embed_assign", "f32"),
               ("embed_assign_bf16", "embed_assign", "bf16"),
               ("sketch_assign", "sketch_assign", None),
               ("sketch_assign_f32", "sketch_assign", "f32"),
               ("sketch_assign_bf16", "sketch_assign", "bf16"),
               ("flash_attention", "flash_attention", None),
               ("flash_attention_bf16", "flash_attention", "bf16"),
               ("flash_attention_f32", "flash_attention", "f32")]
    kernels = []
    for name, k, body in entries:
        mine = [r for r in recs if r["kernel"] == k
                and body in (None, r["prec"], r.get("body"))]
        first = next(r for r in mine if "ms" in r)
        kernels.append({
            "name": name, "route": "cuda", "source": src[k][0],
            "replaces": src[k][1],
            "launches": totals[k] if body is None else bodies[k, body],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"]})
        if "kernel_ms" in first:   # the time on pre-cast rows
            kernels[-1]["kernel_ms"] = first["kernel_ms"]
    print(f"total inner iterations {iters}; card: {card_line()}; wall "
          f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
