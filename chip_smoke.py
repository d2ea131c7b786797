#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --seed 1 # other weights and traffic for the drives

What it does, in order (each phase prints JSON records, one per line):

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA and
   nvcc versions;
2. builds the CUDA kernels of ``sitewhere_tpu_torch/csrc`` from the checkout
   (nvcc, one process a source, into ``sitewhere_tpu_torch/_build/``);
3. kernel phases: each kernel and its plain PyTorch version called on the
   same inputs on the card, held together (KW, KH, KG, KP, KV bitwise; the
   others within the bf16 bar 2e-2, KJ's patches within one bf16 ulp) and
   timed with CUDA events, beside the least time the card could take and,
   where one PyTorch call computes the same function, that call. Shapes:
   the repo's two LSTM-AD engine configurations, ``tenants32`` (32 tenant
   slots x 2048 rows, 8192 streams a slot) and ``lstm_engine`` (1 slot x
   16384 rows, 16384 streams), and ``forecasting32`` (the shapes of
   ``tenants32`` with the ``forecasting`` tenant template's DeepAR family;
   KW, KD, KH, KG), all window 32, hidden 64, f32 params, bf16 compute, f32
   wire, K=1; ``deepar_replay`` (BASELINE config 3: 128 windows of context
   128 cut from 64 series of 256 points, 64 samples, horizon 24; KF);
   ``transformer32`` (``tenants32``'s shapes with the transformer family at
   its registry defaults: dim 128, depth 4, heads 4, context 256, bf16
   compute, f32 params; KE, KL, KA, KU, KN, plus the flush's matmuls for a
   per-stage split); ``transformer_replay`` (``deepar_replay``'s windows,
   context 128, horizon 24; KE raw mode, KA at T=128, KN forecast mode, the
   whole forecast against its plain version); ``vit_b16`` (BASELINE config
   5: 64 camera frames of 224 x 224 through ViT-B/16, bf16, top-5; KP on
   the u8 and f32 frames, KJ on their JPEG coefficients made by a numpy
   encoder here, 4:2:0 at every ladder width and 4:4:4, KV, KA on block 0,
   KT), then the ViT's whole forward held by its accuracy against an f32
   plain forward (a twin without the head bias shown failing), and in f32
   compute per logit against a float64 plain forward; the train kernels on
   the train plane (every slot x stream: 32 x 8192 rows), KB ``lstm_train``
   at ``tenants32`` and KR ``gru_train`` at ``forecasting32``, each slot
   with its scorer's weights: f32 loss and gradients per element against
   the plain version under autograd (rtol 1e-4, atol 1e-5), bf16 gradients
   by each leaf's relative-norm error against the f32 plain gradient
   (kernel and plain version each <= 2e-2), two runs bitwise; a fault probe
   (a plain twin whose backward drops the forget bias's +1, one whose NLL
   backward drops softplus' derivative) shown failing that bar; KO
   ``adam_update`` against its plain version over five steps (within one
   f32 ulp), beside ``torch.optim.Adam(fused=True)``; the recurrent
   kernels' widths and weight formats: KS and KD in their flush form at
   ``tenants32`` / ``forecasting32`` with int8 and bf16 serving weights
   (hidden 64) and at hidden 8 and 32 (config 10's widths, f32 masters),
   and at ``config8`` (BASELINE config 8: 1 slot x 4096 rows, 1024
   streams, window 16, hidden 16, int8), each against its plain version
   on the same tree at 2e-2; bf16 storage bitwise the f32 masters' scores;
   int8 shown rejecting twins whose dequant drops the per-channel or the
   per-slot scale; KB and KR at hidden 16, window 16 on the train plane
   as at hidden 64, with the fault probe; KF at hidden 16 and 32 on
   ``deepar_replay``'s windows; ``lstm_ad.score`` on CUDA tensors (KS over
   one slot) against its plain version on the CPU; Adam's bias
   corrections (a table of glibc's ``powf`` gathered on the card) bitwise
   glibc over counts 1..200,000; the transformer's train kernels at a
   train step's chunk of ``transformer32``'s train plane (7 slots x 8192
   streams x 31 tokens): KA, KL and KU backward, KE's backward and KN's
   train mode, each against its plain version at bf16 (relative norm
   within 1e-2) and f32 (per element), bitwise twice, timed beside SDPA's,
   LayerNorm's and GELU's autograd backward where one call computes the
   same function; then the transformer's train step at the full train
   plane (32 x 8192, chunks of 7 slots as the scorer runs it) against the
   plain twin on slots 0-7 (f32 loss per trained row at 2e-4, gradients
   per element and each leaf as accurate as the plain version's against a
   float64 plain run of slot 0; bf16 gradients by relative norm against
   the f32 plain gradient), four faulted plain twins rejected, two runs
   bitwise, with its time, chunk and peak memory; the ViT's train kernels
   at config 5's batch (64 frames x 197 tokens, dim 768, 12 heads, 1,000
   classes; ``vit_train_kernel_phase``): KT's train mode (forward and
   backward) on the frames' final residual stream, KV's backward, and KA
   (non-causal, T 197), KL and KU backward, each against its plain version
   at bf16 (relative norm within 1e-2) and f32 (per element), bitwise
   twice, timed beside SDPA's, LayerNorm's and GELU's autograd backward
   and ``dx.sum(0)``; the ViT's train step at full width against its plain
   twin (``vit_train_step_phase``: f32 loss within 2e-4, gradients per
   element or as accurate as the twin's against a float64 run of 8
   frames, bf16 gradients by relative norm against the f32 plain
   gradient, three faulted twins rejected, two runs bitwise, KO within one
   f32 ulp of the plain Adam; its time split forward / backward / Adam,
   peak memory and share of the bf16 peak); the per-tenant train forms
   (``per_tenant_train_phase``: LSTM-AD's and DeepAR's ``loss`` on CUDA
   tensors through KB / KR within 2e-4 of the plain composition, every
   family's ``train_step`` one KO call, KA's backward past the staged
   form's shared-memory cap sent to the tiled form); the transformer's
   weight formats at ``transformer32`` (``quant_kernel_phase``: KE and KN
   on the int8 and bf16 serving trees against their plain versions at the
   bf16 bar, bf16 storage the f32 masters' tokens, KQ ``dequant`` bitwise
   over a flush's 24 block weights, timed beside ``qw.to(bf16) *
   scale.to(bf16)``); KA's tiled forward and backward
   (``tiled_attention_phase``) at head dims 8, 16, 32, 64, 80 and 128 and
   T up to 2,047 (``TILED_SHAPES``: the reference's test widths,
   ViT-B/16 at 384, ViT-H/14, f32 hd 64 past the staged caps), f32 per
   element within 2e-4 of float64, bf16 within 1e-2 relative norm, two runs
   bitwise, timed beside SDPA (forward, and backward through autograd),
   the staged KA beside it at transformer32's and ViT-B/16-224's shapes;
   the bf16 instance (on tensor cores) at every shape also held by its
   mean error against float64 (at most 1.25x the bf16 plain version's +
   1e-3, forward, dq, dk, dv), a twin with its mask faulted on the last
   key tile shown failing that check, and every record with its achieved
   TFLOP/s and its time over the bound;
   K3'c's serving half: KW's multi-block form (``kw_multi_phase``) bitwise
   its plain version at config 1's 65,536 rows and at 262,144 rows on one
   slot of 4,096 streams (bf16 wire), and bitwise the one-block KW at
   16,384 rows (both forms forced); KS and KD in windows mode
   (``wide_window_phase``) at hidden 4, 96 and 256 (window 32, 32 x 2048
   windows; int8, bf16 and f32 trees) and at window 512 (hidden 64, the
   templated form, and 96; 8 x 2048), bf16 compute at the bf16 bar and f32
   per row at 2e-4 (DeepAR's bf16 rows past the bar held by
   ``held_or_as_accurate``: as accurate as the plain version against an
   f32 plain run); in ring mode at main path m's shapes (forecasting32
   with DeepAR at hidden 40, window 192; tenants32 with LSTM-AD at hidden
   128, window 256; the wide forms); KF at config 3's 64 series, context
   168, horizon 24 (hidden 40 at 256 and 100 paths, hidden 64 at 256: the
   wide form; hidden 64 at 100: the one-block form), with a plain forecast
   reading the noise series-major shown rejected; K3'c's training half
   (``wide_train_phase``): KB and KR by their route (``train_kernel``) at
   main path m's shapes on 2 slots of 8,192 streams (LSTM-AD hidden 128,
   window 256; DeepAR hidden 40, window 192: the wide forms), at hidden 64,
   window 256 (the templated KB) and at hidden 100 / 12, window 140 (2 x
   2,048), each against the plain version under autograd a chunk of rows
   at a time (f32 per element in ring mode, windows mode bitwise ring mode;
   bf16 gradients within ``bf16_bar``, max(2e-2, 1.25x the kernel's own
   error at window 32), relative norm of the f32 plain gradient; two runs
   bitwise), the faulted twins shown failing the f32 bar and the bf16 bar
   at main path m's shapes, each timed forward and backward apart beside
   the dWh bmm and the plain version; the per-tenant ``loss`` and
   ``train_step`` also at main path m's shapes; the attention families
   past their earlier caps: KE's raw form (``ke_raw_phase``: raw
   histories of 86,400 values for 64 series, 4,096, 4,097 and 1,000,003
   for 8, each by its route; the context, mu and sigma within 2e-4 of a
   float64 normalization, the bf16 tokens by ``held_or_as_accurate``, a KE
   normalizing over only the last 4,096 values shown failing), KA's split
   form forward and backward (``split_attention_phase``: hd 512 at main
   path p's 65,536 x 31 causal, hd 288, 300 and 512 causal at T 31 and
   non-causal at T 197; f32 per element within 2e-4 of float64, bf16 by
   ``held_or_as_accurate``, two runs bitwise, a split whose chunk blocks
   use only their own columns of q.k^T shown failing, SDPA beside with its
   backend named), KT at top-k 5, 64, 65, 100 and 1,000 on an f32 and a
   bf16-stored head with 100 tied class pairs (``kt_phase``: logits, ids by
   ``topk_ids_check``, the first 64 of a top-1,000 bitwise the top-64,
   ties lower index first with a top-k breaking them higher index first
   shown failing, the bf16 head bitwise the f32 one at bf16 compute);
   the recurrent families past their wide forms' hidden caps, the global
   forms (the block state in global memory): KS and KD alone at hidden
   1,758, 2,049, 4,096 (LSTM) and 2,232 (GRU) on 2 x 256 windows
   (``global_scan_phase``: f32 per row within 2e-4 of float64, bf16 on the
   f32, bf16 and int8 trees by ``held_or_as_accurate``, two runs bitwise, a
   recurrent dot over only the cap's units shown failing), the global form
   forced at main path m's shapes bitwise the wide form at 8 and 32 rows a
   block (``global_forced_phase``; the train forms' leaf sums per element
   at the f32 bar across R), KS and KD at main paths q's and r's flushes
   in each weight format, KB and KR at their train planes (as the wide
   train phase, the cut dot as the fault) and at hidden 785 and 1,018, KF
   at r's forecast (128 windows, 64 paths, hidden 2,304) and at hidden
   2,234 (f32 within 2e-4 of float64, the cut dot shown failing); KA's
   ring step (``ring_step_phase``: K14's block attention with the running
   softmax statistics, in place) at main path s's step (8 x 4,096 x 4 x
   32) in each mask regime of the causal ring and non-causal, at hd 64 / T
   197 and hd 256 / T 1,000 with unequal offsets, on a running state one
   step old: m, l, acc and the output within 2e-4 of the plain version, a
   fully masked block leaving the state bitwise, two runs bitwise, timed
   beside the plain version and the memory-efficient SDPA's output and
   log-sum-exp with the combine;
4. the main paths, every kernel's launch count set to 0 just before each
   and read just after:
   a. LSTM-AD scoring: tenant streams with Zipf-like repeats go through
      ``StreamRegistry`` -> ``_LaneRing`` -> rotating ``_StagingSet``s ->
      ``stage_inputs`` -> ``step_counts`` -> ``gather_rows`` -> async d2h,
      8 flushes at ``tenants32`` with all 32 slots active plus 3 on the
      bf16 wire (KW, KS, KH, KG);
   b. DeepAR scoring, the same protocol at ``forecasting32``, 4 flushes
      plus 2 on the bf16 wire (KW, KD, KH, KG);
   c. transformer scoring, the same protocol at ``transformer32``, 4
      flushes plus 2 on the bf16 wire (KW, KE, KL, KA, KU, KN, KH, KG);
   d. DeepAR forecasting: ``get_model("deepar").forecast`` on the
      ``deepar_replay`` windows with a seeded generator (KF);
   e. transformer forecasting: ``get_model("transformer").forecast`` on the
      same windows at ``transformer_replay`` (KE, KL, KA, KU, KN each step);
   f. ViT-B/16 classification: the 64 frames through ``StreamingMedia``'s
      ``classify_frames_dispatch`` and their coefficients at every ladder
      width through ``classify_coeffs_dispatch``, each read back with
      ``topk_results`` and held to one forward's launches (KP or KJ 1, KV
      1, KL 24, KA 12, KU 12, KT 1).
   g. (run after c.) the train lane, LSTM-AD, DeepAR, then the
      transformer, on a., b. and c.'s warmed rings (f32-wire scorers): 32
      slots, 4 not trainable, lr 1e-3, bf16 compute; ``prewarm_train_lane``
      and an all-False-mask step (bitwise no-ops), 5 ``train_lane_step``s
      (2 for the transformer; KB or KR, or KE, KL, KA, KU, KN's train mode
      and their backward kernels; KO), 4 replay microbatches of
      4096 rows a slot through ``train_feed_ingest`` (KW) and a replay
      step, ``commit_swap`` and one flush with the trained weights (KW,
      KS or KD, KH, KG). Checked: finite losses, the trainable slots' mean
      loss falls, the untrainable slots' params and Adam state bitwise, the
      feed rings bitwise the plain twin's, the kernel scorer's losses and
      params as close to an f32 plain scorer's as the twin's (1.25x), the
      trained flush against the twin; the kernel scorer's calls run with
      every plain version set to raise. Step time by CUDA events.
   h. each KS/KD width and format above on its main path: 2 flushes at
      ``tenants32`` (32 slots, every one active) through a scorer of that
      ``param_dtype`` and width, held against its plain twin; then config
      8 for LSTM-AD (its template) and DeepAR: 4 rounds of 4 flushes of
      4096 rows, each round followed by a 4096-row replay microbatch
      (``train_feed_ingest``) and a replay ``train_lane_step`` at lr
      1e-3, ``commit_swap`` after the 4 steps (the int8 view bitwise
      unchanged before it, bitwise the trained masters' quantization
      after), then 4 flushes served from the trained view against a twin
      given the trained masters (KW, KS or KD, KB or KR, KO, KH, KG at
      hidden 16, int8); KF at hidden 16 and 32 through ``forecast``.
   i. (run after f.) ViT-B/16 training: ``get_model("vit_b16").train_step``
      with ``ops.adam.adam(1e-3)``, 5 steps on f.'s 64 frames (normalized
      as the u8 wire does) with labels from ``--seed``, every plain
      version set to raise; each step held to its launches (KP 1, KV 1, KL
      24, KA 12, KU 12, KT's train forward and backward 1 each, KU's and
      KA's backward 12 each, KL's backward 24, KV's backward 1, KO 1 call),
      the losses finite and falling.
   j. (run after h.) ``transformer32`` served from int8 and from bf16
      weights (``quant_drive``): 2 flushes through a ``ShardedScorer`` of
      that ``param_dtype`` (KW, KE and KN in the format, KQ for int8, KL,
      KA, KU, KH, KG), held by the transformer's bf16 rule against the twin
      and an f32-compute plain scorer on the same quantized tree, int8's
      per-slot check shown rejecting dequants that drop the per-slot or
      the per-channel scale; one train-lane step on the f32 masters,
      ``commit_swap`` (the view re-derived) and a flush served from it.
   k. (run after i.) ViT-B/16 at 384 (``vit384_drive``: T 577): 64 u8
      frames classified with top-5 through KP, KV, KL, the tiled KA, KU
      and KT, held by accuracy against an f32 plain forward and by
      ``topk_ids_check``; one bf16 ``train_step`` at 16 frames with
      ``adam(1e-3)``, its gradients each within max(2e-2, 1.25x the plain
      twin's) relative norm of the f32 plain gradient.
   l. (run after j.) config 1's flush (``config1_drive``; bench.py:2033,
      :2038, :797): one slot of 4,096 streams, LSTM-AD at window 32,
      hidden 64, f32 params, bf16 compute, the bf16 wire, K = 1, 8 full
      flushes of 65,536 rows (then the carry's) with hot streams bursting
      past W through KW's
      multi-block form, KS, KH, KG (no one-block KW launch), its device ms
      a flush recorded, held against the plain twin and shown rejecting a
      twin whose wh has the i and f gate blocks swapped;
   m. the wide and long shapes: 2 flushes at forecasting32 with DeepAR at
      hidden 40, window 192 (KD's wide form; held per row by
      ``held_or_as_accurate`` against an f32 plain replay) and at
      tenants32 with LSTM-AD at hidden 128, window 256 (KS's wide form; the
      bf16 bar), each shown rejecting a twin with two gate blocks swapped;
      then each scorer's train lane (``train_drive`` without the twin's
      steps: 3 lane steps on the flushes' warmed rings through KB's and
      KR's wide forms, 5 chunks of 7 slots for LSTM-AD, one of 32 for
      DeepAR, and KO; 4 replay microbatches and a replay step; finite
      losses, the trainable slots' mean loss falling, the untrainable
      slots' params and Adam state bitwise; ``commit_swap`` and a flush
      served from the trained weights against the twin given them, DeepAR's
      by ``held_or_as_accurate``), every plain version set to raise;
      config 3's forecast at context 168 with 100 and 256 paths at hidden
      40 through ``forecast`` (KF's wide form).
   n. (run after k.) the transformer's forecast over long raw histories
      (``ke_raw_drive``): ``get_model("transformer").forecast`` at its
      registry defaults over 64 series of 86,400 points (a day at 1 Hz, 22
      MB) and 8 each of 4,096, 4,097 and 1,000,003, horizon 24 (KE's raw
      form once past 4,096, then its context mode, KL, KA, KU, KN each
      step), the first step against the plain forecast on the same noise
      and at 86,400 points every step in f32 teacher-forced at 2e-4.
   o. ViT-B/16 through ``StreamingMedia`` at top-k 65, 100 and 1,000 on the
      u8 and compressed wires (``vit_topk_drive``: KT's sort form; each
      call bitwise ``models.vit``'s, its ids by ``topk_ids_check``, its
      first 64 bitwise a top-64), then the bf16-stored tree at top-5 (KT's
      bf16-weight form; bitwise the f32 tree's outputs).
   p. the transformer at dim 512 with one head (``wide_head_drive``: hd
      512, depth 4; KA's split form): 2 flushes at transformer32's shape
      through a ``ShardedScorer`` against its plain twin by the
      transformer's bf16 rule (the f32 reference on slots 0-7), and one
      train chunk (``train_chunk_slots``: 1 slot x 8,192 streams) with KA's
      split backward, held on a chunk of random walks against the plain
      version (f32 loss at 2e-4 and f32 gradients as accurate as the plain
      version's against float64 on 1,024 streams; bf16 gradients within
      max(2e-2, 1.25x the plain bf16 version's) over the chunk).
   q, r. LSTM-AD at hidden 2,048 and DeepAR at 2,304, window 32, on 2
      slots x 2,048-row flushes over 2,048 streams (``wide_path_drive``:
      the global KS or KD): 2 flushes from the f32 masters against the
      plain twin with the cut dot shown rejected, 2 train-lane steps (the
      global KB or KR, KO) at lr 1e-3 held step by step against the plain
      twin stepping beside it (the loss rises at this width and lr, in both)
      and a flush from the trained weights, one flush each from the bf16
      and int8 views; r also forecasts config 3's 128 windows (KF's global
      form).
   s, t, u. (K14; ``k14_drive``) the multi-device paths on 4 gloo ranks
      sharing the card (``parallel.dist.run_ranks``; wall times are of 4
      ranks sharing one H100 and say nothing of a multi-GPU speed), then on
      NCCL's world of one rank: s, ``forecast_seed_sharded`` in f32 and
      bf16 on the last 16,384 points (the registry transformer's context
      cut as the reference cuts it) of 8 of path n's 86,400-point
      histories, Tl 4,096 a rank (KL, the projections, KU, KA's ring step;
      the features within 1e-3 of the single-device kernel backbone's in
      f32 and within 2e-4 of the ranks running the plain ring on 2 of the 8
      series, bf16 by the accuracy rules); t, ViT-B/16's ``apply_tp`` on
      config 5's 64 frames (3 heads a rank, the staged KA, two psums a
      block; the top-5 by ``topk_ids_check`` against ``models.vit.apply``,
      at one rank bitwise it); u, ``pipeline_apply`` over ViT-B/16's first 4
      blocks as stages (the kernel block, ``models.common.block_stage``) on
      the 64 frames' tokens at 4 and 8 microbatches (one stage at one rank),
      against the stages in sequence.
   Each scoring drive checks that every fed row resolves exactly once with
   a finite score, that the sketch equals the np.histogram oracle, and that
   window state (bitwise) and scores (bf16 bar) match a plain-version
   scorer on the card fed the same flushes. The transformer's slots carry
   their own biases and LayerNorm affines; its bf16 scores are held by
   their accuracy against an f32 plain scorer and, per slot, by their
   agreement with the plain twin (a check shown in the same run to reject
   two faulted twins), and its f32 scores per row against a float64 plain
   scorer. Then the ViT forward is timed (frames/s of device time) and run
   once under torch.profiler, and so is one transformer32 flush (device
   time by kernel, a record).

The last two lines are the ``kernels`` record (``launches`` summed over the
main-path drives, every one of which must be non-zero; the other numbers
from the kernel phases; KS, KD, KF, KB and KR also list ``variants``, one
per width and weight format, and KE and KN one per weight format, each
with its own numbers and main-path launches; the tiled KA's record is
ViT-B/16 at 384's, its other shapes under ``shapes``; KW's multi-block
form, KS's, KD's and KF's wide forms each with their own record, variants
and ``shapes``; KB's and KR's wide forms with main path m's shape's record,
their odd widths under ``shapes``; KE's raw form with main path n's shape's
record, KA's split forward and backward with main path p's, their other
shapes under ``shapes``; KT with its sort and bf16-weight forms as
``variants``; the five global forms with main paths q's and r's shapes'
records, their alone phases under ``shapes``; KA's ring step with main
path s's fully visible step's record, launched by the ranks of paths s, t,
u, its other shapes under ``shapes``) and
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; without a CUDA device, or without the repository beside it,
it exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import types

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = 2e-2  # the reference's bf16 bar (tests/test_fused_step.py:110)
TF32_TOL = 2e-4  # the reference's f32 transformer bar (tests/test_fused_step.py:144)

SHAPES = {
    # name: (slots, rows per slot, streams per slot) — bench.py:2096, :2105;
    # forecasting32: tenants32 with the forecasting template's family
    # (sitewhere_tpu/runtime/config.py:341); transformer32: tenants32 with
    # the transformer family at its registry defaults
    "tenants32": (32, 2048, 8192),
    "lstm_engine": (1, 16384, 16384),
    "forecasting32": (32, 2048, 8192),
    "transformer32": (32, 2048, 8192),
    # config 8 (bench.py:1706-1707, :1739): one tenant of 1,024 streams,
    # flushes of 4,096 rows (its largest bucket), window 16, hidden 16
    "config8": (1, 4096, 1024),
    # main paths q (LSTM-AD at hidden 2,048) and r (DeepAR at 2,304):
    # tenants32's rows a flush, its slots and streams cut to 2 and 2,048 for
    # the script's time (the width is not cut)
    "q": (2, 2048, 2048),
    "r": (2, 2048, 2048),
}
WINDOW, HIDDEN = 32, 64
WINDOWS = {"config8": 16}  # shapes whose window is not WINDOW
# deepar_replay, BASELINE config 3 as bench.py:2131-2135 runs it
REPLAY_SERIES, REPLAY_CONTEXT, REPLAY_POINTS = 64, 128, 256
REPLACES = {
    "window_update": "sitewhere_tpu/ops/windows.py:66",
    "lstm_score": "sitewhere_tpu/models/lstm_ad.py:117",
    "gru_score": "sitewhere_tpu/models/deepar.py:97",
    "deepar_forecast": "sitewhere_tpu/models/deepar.py:206",
    "score_sketch": "sitewhere_tpu/parallel/sharded.py:511",
    "gather_rows": "sitewhere_tpu/parallel/sharded.py:415",
    "tf_embed": "sitewhere_tpu/models/transformer.py:235",
    "layernorm": "sitewhere_tpu/models/common.py:295",
    "attention": "sitewhere_tpu/models/common.py:61",
    "bias_gelu": "sitewhere_tpu/models/common.py:340",
    "tf_head": "sitewhere_tpu/models/transformer.py:258",
    "frame_patches": "sitewhere_tpu/services/streaming_media.py:151",
    "dct_patches": "sitewhere_tpu/ops/dct.py:176",
    "vit_embed": "sitewhere_tpu/models/vit.py:86",
    "vit_head": "sitewhere_tpu/models/vit.py:92",
    "lstm_train": "sitewhere_tpu/models/lstm_ad.py:202",
    "gru_train": "sitewhere_tpu/models/deepar.py:165",
    "adam_update": "sitewhere_tpu/parallel/sharded.py:1168",
    # the transformer's train form: transformer.py:272 loss_stacked under
    # jax.grad, through :229 _backbone_stacked
    "attention_bwd": "sitewhere_tpu/models/common.py:61",
    "layernorm_bwd": "sitewhere_tpu/models/common.py:295",
    "bias_gelu_bwd": "sitewhere_tpu/models/common.py:340",
    "tf_embed_bwd": "sitewhere_tpu/models/transformer.py:235",
    "tf_head_train": "sitewhere_tpu/models/transformer.py:284",
    # the ViT's train form: vit.py:121 loss under jax.grad (:127 train_step)
    "vit_head_train": "sitewhere_tpu/models/vit.py:121",
    "vit_embed_bwd": "sitewhere_tpu/models/vit.py:86",
    # the transformer's bf16/int8 serving weights (dense_stacked :284 reading
    # kernel_weight :265) and attn_core at any head dim and length, forward
    # and under jax.grad
    "dequant": "sitewhere_tpu/models/common.py:265",
    "attention_tiled": "sitewhere_tpu/models/common.py:61",
    "attention_tiled_bwd": "sitewhere_tpu/models/common.py:61",
    # K3'c's serving half: the same functions past the templated kernels'
    # shapes (update_windows :131 at any rows a slot; score_stacked and the
    # forecast at any hidden, window and sample count)
    "window_update_multi": "sitewhere_tpu/ops/windows.py:66",
    "lstm_score_wide": "sitewhere_tpu/models/lstm_ad.py:117",
    "gru_score_wide": "sitewhere_tpu/models/deepar.py:97",
    "deepar_forecast_wide": "sitewhere_tpu/models/deepar.py:206",
    # K3'c's training half: loss_stacked under jax.grad past the templated
    # train forms' shapes
    "lstm_train_wide": "sitewhere_tpu/models/lstm_ad.py:202",
    "gru_train_wide": "sitewhere_tpu/models/deepar.py:165",
    # the attention families past their caps: the forecast's normalization
    # of a raw history of any length (normalize_windows, common.py:142);
    # attn_core at head dims past 256, forward and under jax.grad
    "tf_embed_raw": "sitewhere_tpu/models/transformer.py:205",
    "attention_split": "sitewhere_tpu/models/common.py:61",
    "attention_split_bwd": "sitewhere_tpu/models/common.py:61",
    # K3'c's last part: the recurrent families at hidden widths past the
    # wide forms' shared memory (score_stacked, the forecast, loss_stacked
    # under jax.grad)
    "lstm_score_global": "sitewhere_tpu/models/lstm_ad.py:117",
    "gru_score_global": "sitewhere_tpu/models/deepar.py:97",
    "deepar_forecast_global": "sitewhere_tpu/models/deepar.py:206",
    "lstm_train_global": "sitewhere_tpu/models/lstm_ad.py:202",
    "gru_train_global": "sitewhere_tpu/models/deepar.py:165",
    # K14: ring attention's block attention and running combine
    # (ring_attention.py:33 _block_attn, :81-86)
    "attention_ring": "sitewhere_tpu/ops/ring_attention.py:33",
}
# the transformer's train kernels (their records: shape transformer32_train)
TF_TRAIN_KERNELS = ("attention_bwd", "layernorm_bwd", "bias_gelu_bwd", "tf_embed_bwd",
                    "tf_head_train")
# the family's flush-form kernels
SCORER = {"lstm_ad": ("lstm_score",), "deepar": ("gru_score",),
          "transformer": ("tf_embed", "layernorm", "attention", "bias_gelu", "tf_head")}
TF_KERNELS = SCORER["transformer"]
VIT_KERNELS = ("frame_patches", "dct_patches", "vit_embed", "vit_head")
# transformer_replay: deepar_replay's windows at the forecasting template's
# context (runtime/config.py:341-345) with the transformer family
TF_REPLAY_CONTEXT = 128
# ViT-B/16 frame classification, BASELINE config 5 as bench.py:2137-2142
# runs it: a batch of 64 224x224 frames, the top-5 of each
VIT_BATCH, VIT_TOPK = 64, 5


_T0 = time.perf_counter()  # the script's start: each record's "at_s"


def emit(record: dict) -> None:
    print(json.dumps({**record, "at_s": round(time.perf_counter() - _T0, 3)}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def zipf_ids(rng, n_streams: int, size, a: float = 1.3) -> np.ndarray:
    """Stream ids with Zipf-like repeats (a few hot streams burst)."""
    perm = rng.permutation(n_streams)
    return perm[(rng.zipf(a, size) - 1) % n_streams]


# -- phase 3: each kernel against its plain version -----------------------------

def flush_plane(dev, shape: str, seed: int = 7, w: int = 0):
    """One full flush at ``shape`` on random rings (window ``w``, else the
    shape's): (rng, the rings before KW, ids as numpy and on the card (Zipf
    repeats, u16), values, lane counts, every slot active)."""
    t, b, s = SHAPES[shape]
    return ring_flush(dev, t, b, s, w or WINDOWS.get(shape, WINDOW), seed)


def ring_flush(dev, t: int, b: int, s: int, w: int, seed: int):
    """``flush_plane`` at explicit slots ``t``, rows ``b`` and streams ``s``
    a slot, window ``w``."""
    import torch

    from sitewhere_tpu_torch.ops.windows import WindowState

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = WindowState(
        torch.randn((t, s, w), generator=gen, device=dev),
        torch.randint(0, w, (t, s), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 2 * w, (t, s), generator=gen, device=dev, dtype=torch.int32),
    )
    ids_np = zipf_ids(rng, s, (t, b)).astype(np.uint16)
    ids = torch.from_numpy(ids_np.view(np.int16)).to(dev).view(torch.uint16)
    vals = torch.from_numpy(rng.normal(size=(t, b)).astype(np.float32)).to(dev)
    counts = torch.full((t, 1), b, dtype=torch.int32, device=dev)
    active = torch.ones((t,), dtype=torch.bool, device=dev)
    return rng, base, ids_np, ids, vals, counts, active


def kernel_phase(shape: str, dev, spec, cfg, params) -> dict:
    """KW, the family's scorer (KS or KD), KH and KG at ``shape``."""
    import torch

    from sitewhere_tpu_torch.models.common import sketch_edges
    from sitewhere_tpu_torch.ops.windows import (
        WindowState, window_update, window_update_plain,
    )
    from sitewhere_tpu_torch.parallel.sharded import (
        gather_rows, gather_rows_plain, score_sketch, score_sketch_plain,
    )

    t, b, s = SHAPES[shape]
    rng, base, ids_np, ids, vals, counts, active = flush_plane(dev, shape)
    edges = torch.from_numpy(sketch_edges()).to(dev)
    params_t = {k: {x: v[:t].contiguous() for x, v in n.items()} for k, n in params.items()}

    def clone(st):
        return WindowState(*(x.clone() for x in st))

    out = {}
    # KW
    st_k, st_p = clone(base), clone(base)
    later_k = window_update(st_k, ids, vals, counts=counts)
    later_p = window_update_plain(st_p, ids, vals, counts=counts)
    torch.cuda.synchronize()
    check(torch.equal(later_k, later_p), f"{shape} KW later bitwise")
    for name, a, c in zip(("values", "pos", "count"), st_k, st_p):
        check(torch.equal(a, c), f"{shape} KW {name} bitwise")
    scratch = clone(base)
    kw_ms = cuda_time_ms(lambda: window_update(scratch, ids, vals, counts=counts), 20)
    scratch = clone(base)
    kw_plain_ms = cuda_time_ms(lambda: window_update_plain(scratch, ids, vals, counts=counts), 3, 1)
    # bytes the data needs: ids, values, counts and later once; pos/count
    # read and written per touched stream; the ring words that are written
    per_stream = np.unique(
        ids_np.astype(np.int64) + np.arange(t)[:, None] * 65536, return_counts=True
    )[1]
    uniq = len(per_stream)
    ring_writes = int(np.minimum(per_stream, WINDOW).sum())
    kw_bytes = t * b * (2 + 4 + 4) + t * 4 + uniq * 16 + ring_writes * 4
    out["window_update"] = dict(
        max_abs_err=0.0, ms=kw_ms, plain_ms=kw_plain_ms,
        bound_ms=kw_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    )
    # the scorer (on the post-update state both versions agree on)
    (name,), score, score_plain = SCORER[spec.name], spec.score_flush, spec.score_flush_plain
    sc_k = score(params_t, cfg, st_k, ids, later_k, active, counts=counts)
    sc_p = score_plain(params_t, cfg, st_p, ids, later_p, active, counts=counts)
    torch.cuda.synchronize()
    err = float((sc_k - sc_p).abs().max())
    check(bool(torch.isfinite(sc_k).all()), f"{shape} {name} finite")
    check(bool(torch.allclose(sc_k, sc_p, rtol=TOL, atol=TOL)),
          f"{shape} {name} within {TOL} (max abs err {err})")
    check(bool((sc_k != 0).any()), f"{shape} {name} scored")
    ks_ms = cuda_time_ms(lambda: score(params_t, cfg, st_k, ids, later_k, active, counts=counts), 10)
    ks_plain_ms = cuda_time_ms(
        lambda: score_plain(params_t, cfg, st_p, ids, later_p, active, counts=counts), 3, 1)
    live = t * b
    ks_flops = live * spec.flops_per_row(cfg, WINDOW, k=1)
    n_params = sum(v.numel() for n in params_t.values() for v in n.values())
    ks_bytes = t * b * (2 + 4 + 4) + t * 5 + uniq * (WINDOW * 4 + 8) + n_params * 4
    peak = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    ks_bound = max(ks_flops / peak, ks_bytes / HBM_BYTES_PER_S) * 1e3
    out[name] = dict(
        max_abs_err=err, ms=ks_ms, plain_ms=ks_plain_ms, bound_ms=ks_bound,
        bound_by="operations" if ks_flops / peak > ks_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None, flops=ks_flops, negative_scores=int((sc_k < 0).sum()),
    )
    if spec.name == "deepar":
        # a measurement, not a check: the bf16 NLL's conditioning. With the
        # odd slots' sigma head biased by -2 (sigma ~0.13) a one-ulp flip of
        # the bf16 head output moves the NLL by ~3%, past the 2e-2 bar
        shifted = {k: dict(n) for k, n in params_t.items()}
        shifted["sigma"]["b"] = params_t["sigma"]["b"] - 2.0 * (torch.arange(t, device=dev) % 2)[:, None]
        a = score(shifted, cfg, st_k, ids, later_k, active, counts=counts)
        c = score_plain(shifted, cfg, st_p, ids, later_p, active, counts=counts)
        out[name]["small_sigma"] = dict(
            rows_outside_bar=int((~torch.isclose(a, c, rtol=TOL, atol=TOL)).sum()),
            max_abs_err=float((a - c).abs().max()), negative_scores=int((c < 0).sum()),
        )
    # KH (both versions on the kernel's scores)
    h_k = score_sketch(sc_k, active, edges, counts=counts)
    h_p = score_sketch_plain(sc_k, active, edges, counts=counts)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"{shape} KH bitwise")
    check(int(h_k.sum()) == t * b - int(torch.isnan(sc_k).sum()), f"{shape} KH counts every row")
    kh_ms = cuda_time_ms(lambda: score_sketch(sc_k, active, edges, counts=counts), 50)
    kh_plain_ms = cuda_time_ms(lambda: score_sketch_plain(sc_k, active, edges, counts=counts), 10)
    kh_bytes = t * b * 4 + t * 5 + edges.numel() * 4 + t * 64 * 4
    out["score_sketch"] = dict(
        max_abs_err=0.0, ms=kh_ms, plain_ms=kh_plain_ms,
        bound_ms=kh_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    )
    # KG: a partly filled plane, compacted to its ladder size
    part = torch.from_numpy(rng.integers(0, b + 1, (t, 1)).astype(np.int32)).to(dev)
    n_rows = int(part.sum())
    size = 2048  # the scorer's gather ladder: powers of two from 2048
    while size < n_rows:
        size *= 2
    size = min(size, t * b)
    g_k = gather_rows(sc_k, part, size)
    g_p = gather_rows_plain(sc_k, part, size)
    torch.cuda.synchronize()
    check(torch.equal(g_k.view(torch.int32), g_p.view(torch.int32)), f"{shape} KG bitwise")
    kg_ms = cuda_time_ms(lambda: gather_rows(sc_k, part, size), 50)
    kg_plain_ms = cuda_time_ms(lambda: gather_rows_plain(sc_k, part, size), 10)
    flat_mask = (torch.arange(b, device=dev)[None, :] < part).reshape(-1)
    flat = sc_k.reshape(-1)
    lib_ms = cuda_time_ms(lambda: flat[flat_mask], 50)
    kg_bytes = n_rows * 4 + t * 4 + size * 4
    out["gather_rows"] = dict(
        max_abs_err=0.0, ms=kg_ms, plain_ms=kg_plain_ms,
        bound_ms=kg_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=lib_ms,
    )
    for name, rec in out.items():
        emit({"phase": "kernel", "shape": shape, "name": name, **rec})
    return out


# -- phase 3b: KF at deepar_replay ----------------------------------------------

def replay_windows(context: int = REPLAY_CONTEXT) -> np.ndarray:
    """BASELINE config 3's input as bench.py:341-358 builds it: per series,
    a daily sine plus noise from RandomState(1), replayed in event-time
    order and cut into context-length windows at stride = context
    (series-major: series 0's windows first). f32[128, 128] at context 128;
    f32[64, 168] at the DeepAR paper's 168."""
    rng = np.random.RandomState(1)
    windows = []
    for s_i in range(REPLAY_SERIES):
        vals = (
            21.0
            + 4.0 * np.sin(np.arange(REPLAY_POINTS) / 24 * 2 * np.pi + s_i)
            + rng.randn(REPLAY_POINTS) * 0.2
        )
        for lo in range(0, REPLAY_POINTS - context + 1, context):
            windows.append(vals[lo: lo + context])
    return np.stack(windows).astype(np.float32)


def replay_phase(dev, spec, cfg, params, windows, shape: str = "deepar_replay",
                 fault: bool = False, iters: int = 20) -> dict:
    """KF against forecast_plain on the same noise: the first horizon step
    of every path and the mean over samples within the bf16 bar. With
    ``fault``, the check shown rejecting a plain forecast that reads the
    noise series-major (path index b * num_samples + s, a layout fault of
    a split over paths). Timed over ``iters`` calls."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models.deepar import forecast_plain

    b = windows.shape[0]
    paths = cfg.num_samples * b
    eps = torch.randn((cfg.horizon, paths), device=dev,
                      generator=torch.Generator(dev).manual_seed(5))
    kernels.reset_launches()
    samples, mean = spec.forecast(params, cfg, windows, eps=eps)
    name = next(n for n, c in kernels.launches().items() if c)
    ps, pm = forecast_plain(params, cfg, windows, eps)
    torch.cuda.synchronize()
    check(tuple(samples.shape) == (cfg.num_samples, b, cfg.horizon), "KF samples shape")
    check(bool(torch.isfinite(samples).all() and torch.isfinite(mean).all()), "KF finite")
    first = float((samples[..., 0] - ps[..., 0]).abs().max())
    mean_err = float((mean - pm).abs().max())
    path_err = float((samples - ps).abs().max())
    check(bool(torch.allclose(samples[..., 0], ps[..., 0], rtol=TOL, atol=TOL)),
          f"KF first step within {TOL} (max abs err {first})")
    check(bool(torch.allclose(mean, pm, rtol=TOL, atol=TOL)),
          f"KF mean within {TOL} (max abs err {mean_err})")
    check(bool(torch.allclose(mean, samples.mean(0), rtol=1e-5, atol=1e-5)), "KF mean of its samples")
    rec = {}
    if fault:
        by_series = eps.reshape(cfg.horizon, b, cfg.num_samples).transpose(1, 2).reshape(
            cfg.horizon, paths)
        fs, _ = forecast_plain(params, cfg, windows, by_series)
        outside = int((~torch.isclose(samples[..., 0], fs[..., 0], rtol=TOL, atol=TOL)).sum())
        check(outside > 0, f"{shape} KF: the check rejects series-major noise")
        rec["fault_series_major_eps_paths_outside_bar"] = outside
    kf_ms = cuda_time_ms(lambda: spec.forecast(params, cfg, windows, eps=eps), iters, min(2, iters))
    kf_plain_ms = cuda_time_ms(lambda: forecast_plain(params, cfg, windows, eps), 3, 1)
    h = params["wh"]["w"].shape[-2]
    step = 2.0 * 3 * h + 2.0 * h * 3 * h          # one GRU step of one row
    flops = b * windows.shape[1] * step + cfg.horizon * paths * (step + 2 * 2.0 * h)
    n_params = sum(v.numel() for n in params.values() for v in n.values())
    nbytes = 4 * (windows.numel() + eps.numel() + samples.numel() + mean.numel() + n_params)
    peak = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    rec.update(
        max_abs_err=max(first, mean_err), first_step_err=first, mean_err=mean_err,
        path_err=path_err, ms=kf_ms, plain_ms=kf_plain_ms,
        bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None, flops=flops,
    )
    emit({"phase": "kernel", "shape": shape, "name": name, **rec})
    return rec


# -- phase 3c: the transformer's kernels --------------------------------------------

def _bound(nbytes: float, flops: float, peak: float, f32_flops: float = 0.0) -> dict:
    """The least time for the work: its bytes over the memory rate, or its
    operations (``flops`` at ``peak``, plus ``f32_flops`` at the f32 rate)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak + f32_flops / F32_FLOPS
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="operations" if t_f > t_b else "bytes")


def _held(what: str, got, want, tol: float = TOL) -> float:
    """A kernel's output against its plain version's: finite and within
    ``tol``; returns the max abs error."""
    import torch

    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what} finite")
    check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
          f"{what} within {tol} (max abs err {err})")
    return err


def own_affines(tree, gen):
    """Every 1-D leaf of a transformer tree (the dense biases, LayerNorm
    scales and biases) moved off its init value (0, or 1 for a scale) by
    0.05 N(0, 1), so the slots' per-slot bias and affine work differs from
    slot to slot and is held by every check."""
    import torch

    from sitewhere_tpu_torch.models import common as tc

    return tc.tree_map(lambda x: x.add_(0.05 * torch.randn(x.shape, generator=gen).to(x.device))
                       if x.ndim == 1 else x, tree)


def _attn_phase(tag: str, q, k, v, heads: int, causal: bool, iters: int) -> dict:
    """KA against its plain version on q, k, v [N, T, D]; the library call
    is scaled_dot_product_attention on the same tensors viewed [N, heads,
    T, hd]."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc

    n, t, d = q.shape
    hd = d // heads
    o = tc.attention(q, k, v, heads, causal)
    op = tc.attention_plain(q, k, v, heads, causal)
    torch.cuda.synchronize()
    err = _held(f"{tag} KA", o, op)
    qh, kh, vh = (z.view(n, t, heads, hd).transpose(1, 2) for z in (q, k, v))
    pairs = t * (t + 1) / 2 if causal else t * t
    rec = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: tc.attention(q, k, v, heads, causal), iters),
        plain_ms=cuda_time_ms(lambda: tc.attention_plain(q, k, v, heads, causal), 2, 1),
        library_ms=cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), iters),
        **_bound(4 * q.numel() * q.element_size(), 2 * 2.0 * hd * pairs * heads * n, BF16_FLOPS),
        dims=[n, t, heads, hd], causal=causal,
    )
    emit({"phase": "kernel", "shape": tag, "name": "attention", **rec})
    return rec


def tf_plane(dev):
    """One transformer32 flush on random rings, after KW: (the rings, ids
    as numpy and on the card, lane counts, every slot active, later)."""
    import torch

    from sitewhere_tpu_torch.ops.windows import WindowState, window_update

    t, b, s = SHAPES["transformer32"]
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=dev).manual_seed(8)
    st = WindowState(
        torch.randn((t, s, WINDOW), generator=gen, device=dev),
        torch.randint(0, WINDOW, (t, s), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 2 * WINDOW, (t, s), generator=gen, device=dev, dtype=torch.int32),
    )
    ids_np = zipf_ids(rng, s, (t, b)).astype(np.uint16)
    ids = torch.from_numpy(ids_np.view(np.int16)).to(dev).view(torch.uint16)
    vals = torch.from_numpy(rng.normal(size=(t, b)).astype(np.float32)).to(dev)
    counts = torch.full((t, 1), b, dtype=torch.int32, device=dev)
    active = torch.ones((t,), dtype=torch.bool, device=dev)
    later = window_update(st, ids, vals, counts=counts)
    return st, ids_np, ids, counts, active, later


def transformer_phase(dev, cfg, params) -> dict:
    """KE, KL, KA, KU and KN at transformer32, each beside its plain version
    on the inputs the main path gives it (block 0's for KL, KA, KU; the
    last block's output for KN), timed beside its bound and, where one
    PyTorch call computes the same function, that call. Also times the
    flush's matmuls and adds for the per-stage split."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    t, b, s = SHAPES["transformer32"]
    st, ids_np, ids, counts, active, later = tf_plane(dev)
    dtype, d, tok, heads = cfg.compute_dtype, cfg.dim, WINDOW - 1, cfg.heads
    rows = b * tok
    elt = torch.finfo(dtype).bits // 8
    out = {}

    # KE, ring mode
    x, tg, nv = tt.tf_embed(params, cfg, 1, state=st, ids=ids)
    xp, tgp, nvp = tt.tf_embed_plain(params, cfg, 1, state=st, ids=ids)
    torch.cuda.synchronize()
    check(bool(torch.equal(nv, nvp)), "transformer32 KE n_valid")
    # a window with one sample (left-padded, constant) normalizes to noise:
    # its mean's rounding residue over sigma = 1e-6, different for every
    # summation order, the reference's too. Such rows score 0 (fewer than
    # 4 samples); the check holds the others and that all are finite.
    keep = nv >= 2
    check(bool(torch.isfinite(x.float()).all()), "transformer32 KE tokens finite")
    err = max(_held("transformer32 KE tokens", x[keep], xp[keep]),
              _held("transformer32 KE targets", tg[keep], tgp[keep]))
    uniq = len(np.unique(ids_np.astype(np.int64) + np.arange(t)[:, None] * 65536))
    out["tf_embed"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: tt.tf_embed(params, cfg, 1, state=st, ids=ids), 10),
        plain_ms=cuda_time_ms(lambda: tt.tf_embed_plain(params, cfg, 1, state=st, ids=ids), 2, 1),
        library_ms=None,
        **_bound(t * b * 2 + uniq * (WINDOW * 4 + 8) + x.numel() * elt + tg.numel() * 4
                 + nv.numel() * 4 + t * (2 + tok) * d * 4,
                 t * b * 4.0 * WINDOW + 3.0 * x.numel(), F32_FLOPS),
        constant_window_rows=int((~keep).sum()),
    )
    # KL: block 0's ln1 over the tokens
    blk = params["blocks"][0]
    x2 = x.reshape(-1, d)
    sc, bi = blk["ln1"]["scale"], blk["ln1"]["bias"]
    h = tc.layernorm_rows(x2, sc, bi, rows)
    hp = tc.layernorm_rows_plain(x2, sc, bi, rows)
    torch.cuda.synchronize()
    x3, sc3, bi3 = x.reshape(t, rows, d), sc[:, None].to(dtype), bi[:, None].to(dtype)
    out["layernorm"] = dict(
        max_abs_err=_held("transformer32 KL", h, hp),
        ms=cuda_time_ms(lambda: tc.layernorm_rows(x2, sc, bi, rows), 10),
        plain_ms=cuda_time_ms(lambda: tc.layernorm_rows_plain(x2, sc, bi, rows), 2, 1),
        library_ms=cuda_time_ms(lambda: torch.addcmul(bi3, F.layer_norm(x3, (d,)), sc3), 10),
        library_call="F.layer_norm + torch.addcmul (two calls)",
        **_bound(2 * x.numel() * elt + 2 * t * d * 4, 8.0 * x.numel(), F32_FLOPS),
    )
    # KA on block 0's projections
    a = blk["attn"]
    h4 = h.reshape(t, b, tok, d)
    q, k, v = (tc.dense_stacked(a[n], h4, dtype).reshape(t * b, tok, d) for n in ("wq", "wk", "wv"))
    out["attention"] = _attn_phase("transformer32", q, k, v, heads, True, 5)
    # KU on block 0's fc1 product
    fc1 = blk["mlp"]["fc1"]
    w1 = fc1["w"].to(dtype)
    f = torch.bmm(h.reshape(t, rows, d), w1).reshape(t * rows, -1)
    g = tc.bias_gelu(f, fc1["b"], rows)
    gp = tc.bias_gelu_plain(f, fc1["b"], rows)
    torch.cuda.synchronize()
    err = _held("transformer32 KU", g, gp)
    del gp
    f3, b3 = f.view(t, rows, -1), fc1["b"].to(dtype)[:, None]
    out["bias_gelu"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: tc.bias_gelu(f, fc1["b"], rows), 5),
        plain_ms=cuda_time_ms(lambda: tc.bias_gelu_plain(f, fc1["b"], rows), 2, 1),
        library_ms=cuda_time_ms(lambda: F.gelu(f3 + b3, approximate="tanh"), 5),
        library_call="F.gelu(x + b, approximate='tanh')",
        **_bound(2 * f.numel() * elt + fc1["b"].numel() * 4, 10.0 * f.numel(), F32_FLOPS),
    )
    # the rest of the flush, for the per-stage split: one projection, fc1's
    # and fc2's products, a residual add
    fc2 = blk["mlp"]["fc2"]
    g4 = g.reshape(t, b, tok, -1)
    split = dict(
        proj_ms=cuda_time_ms(lambda: tc.dense_stacked(a["wq"], h4, dtype), 5),
        fc1_ms=cuda_time_ms(lambda: torch.bmm(h.reshape(t, rows, d), w1), 5),
        fc2_ms=cuda_time_ms(lambda: tc.dense_stacked(fc2, g4, dtype), 5),
        add_ms=cuda_time_ms(lambda: x + h4, 5),
    )
    del f, g, g4, f3
    # KN on the last block's output, flush mode
    hfin = tt._blocks(params, x, cfg)
    split["blocks_ms"] = cuda_time_ms(lambda: tt._blocks(params, x, cfg), 2, 1)
    args = (params, cfg, hfin, tg, nv, 1, later, active, counts, None, torch.float32)
    sk, skp = tt.tf_head(*args), tt.tf_head_plain(*args)
    torch.cuda.synchronize()
    out["tf_head"] = dict(
        max_abs_err=_held("transformer32 KN", sk, skp),
        ms=cuda_time_ms(lambda: tt.tf_head(*args), 20),
        plain_ms=cuda_time_ms(lambda: tt.tf_head_plain(*args), 3, 1), library_ms=None,
        **_bound(t * b * d * elt + t * b * (4 + 4 + 4 + 4) + t * (3 * d + 2) * 4,
                 t * b * (10.0 * d + 40), F32_FLOPS),
        negative_scores=int((sk < 0).sum()),
    )
    split["scorer_ms"] = cuda_time_ms(
        lambda: tt.tf_score(params, cfg, st, ids, later, active, counts, None, 1), 2, 1)
    for name, rec in out.items():
        if name != "attention":  # _attn_phase printed it
            emit({"phase": "kernel", "shape": "transformer32", "name": name, **rec})
    emit({"phase": "split", "shape": "transformer32", **split})
    return out


def transformer_replay_phase(dev, cfg, params, windows) -> dict:
    """At transformer_replay: KE in raw-context mode, KA at T=128 on the
    first step's projections and KN in forecast mode on the first step's
    last block, each against its plain version; and the whole forecast,
    kernel path against the plain composition on the same noise: the
    free-running paths at their first step, and in f32 compute every step
    teacher-forced (``teacher_forced``)."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    one = tc.tree_map(lambda a: a[None], params)
    b, c, d = windows.shape[0], cfg.context, cfg.dim
    x, ctx, mu, sg = tt.tf_embed_context(one, cfg, raw=windows)
    xp, ctxp, mup, sgp = tt.tf_embed_context_plain(one, cfg, raw=windows)
    torch.cuda.synchronize()
    ke_err = max(_held("transformer_replay KE tokens", x, xp),
                 _held("transformer_replay KE context", ctx, ctxp),
                 _held("transformer_replay KE stats", torch.stack([mu, sg]), torch.stack([mup, sgp])))
    blk = one["blocks"][0]
    h = tc.layernorm_rows(x.reshape(-1, d), blk["ln1"]["scale"], blk["ln1"]["bias"], b * c)
    h4 = h.reshape(1, b, c, d)
    q, k, v = (tc.dense_stacked(blk["attn"][n], h4, cfg.compute_dtype).reshape(b, c, d)
               for n in ("wq", "wk", "wv"))
    ka = _attn_phase("transformer_replay", q, k, v, cfg.heads, True, 20)
    hfin = tt._blocks(one, x, cfg)
    eps = torch.randn((cfg.horizon, b), generator=torch.Generator(dev).manual_seed(5), device=dev)
    outs = []
    for fn in (tt.tf_head_forecast, tt.tf_head_forecast_plain):
        nxt = torch.zeros_like(ctx)
        smp = torch.zeros((b, cfg.horizon), device=dev)
        mns = torch.zeros((b, cfg.horizon), device=dev)
        fn(one, cfg, hfin, ctx, nxt, eps[0], mu, sg, smp, mns, 0)
        outs.append((nxt, smp, mns))
    torch.cuda.synchronize()
    kn_err = max(_held(f"transformer_replay KN {n}", a_, b_)
                 for n, a_, b_ in zip(("context", "samples", "means"), *outs))

    def kn_step():
        tt.tf_head_forecast(one, cfg, hfin, ctx, nxt, eps[0], mu, sg, smp, mns, 0)

    nxt, smp, mns = outs[0]
    kn = dict(max_abs_err=kn_err, ms=cuda_time_ms(kn_step, 50),
              plain_ms=cuda_time_ms(lambda: tt.tf_head_forecast_plain(
                  one, cfg, hfin, ctx, nxt, eps[0], mu, sg, smp, mns, 0), 5, 1),
              library_ms=None, **_bound(b * d * 2 + 2 * b * c * 4 + b * 16, b * 10.0 * d, F32_FLOPS))
    emit({"phase": "kernel", "shape": "transformer_replay", "name": "tf_head_forecast", **kn})
    ke = dict(max_abs_err=ke_err,
              ms=cuda_time_ms(lambda: tt.tf_embed_context(one, cfg, raw=windows), 50),
              plain_ms=cuda_time_ms(lambda: tt.tf_embed_context_plain(one, cfg, raw=windows), 5, 1),
              library_ms=None,
              **_bound(windows.numel() * 4 + x.numel() * 2 + b * c * 4 + b * 8 + (2 + c) * d * 4,
                       windows.numel() * 6.0 + 3.0 * x.numel(), F32_FLOPS))
    emit({"phase": "kernel", "shape": "transformer_replay", "name": "tf_embed",
          "mode": "raw context (csrc/tf_embed.cu mode 2)", **ke})
    # the whole forecast: kernel path against the plain composition
    samples, means = tt.forecast(params, cfg, windows, eps=eps)
    ps, pm = tt.forecast_plain(params, cfg, windows, eps)
    torch.cuda.synchronize()
    check(tuple(samples.shape) == tuple(means.shape) == (b, cfg.horizon), "forecast shapes")
    first = _held("transformer_replay forecast first step", samples[:, 0], ps[:, 0])
    # the free-running paths are held at the first step: later steps feed
    # back a sample that differs by a rounding, and the single sampled path
    # drifts (in f32 too, where the plain version in f32 and in f64 drift
    # apart over 24 steps). In f32 compute every step is held at the
    # reference's f32 bar, teacher-forced: both versions' steps on the
    # kernel path's own context.
    f32 = dataclasses.replace(cfg, dtype="float32")
    s32, m32 = tt.forecast(params, f32, windows, eps=eps)
    ps32, pm32 = tt.forecast_plain(params, f32, windows, eps)
    (ks, km), (qs, qm) = teacher_forced(params, f32, windows, eps)
    torch.cuda.synchronize()
    check(bool(torch.equal(ks, s32) and torch.equal(km, m32)),
          "transformer_replay teacher-forced kernel steps are the forecast's")
    f32_err = max(_held("transformer_replay f32 forecast, every step teacher-forced", ks, qs, TF32_TOL),
                  _held("transformer_replay f32 forecast means, every step teacher-forced", km, qm,
                        TF32_TOL))
    fc = dict(
        first_step_err=first, means_err=float((means - pm).abs().max()),
        samples_err=float((samples - ps).abs().max()), f32_teacher_forced_err=f32_err,
        f32_samples_err=float((s32 - ps32).abs().max()),
        ms=cuda_time_ms(lambda: tt.forecast(params, cfg, windows, eps=eps), 3, 1),
        plain_ms=cuda_time_ms(lambda: tt.forecast_plain(params, cfg, windows, eps), 2, 1),
    )
    emit({"phase": "forecast", "shape": "transformer_replay", **fc})
    return {"attention": ka, "tf_head_forecast": kn, "tf_embed_context_raw": ke, "forecast": fc}


def teacher_forced(params, cfg, windows, eps):
    """The forecast's kernel steps and, beside each, the plain versions'
    step (KE's context mode, the blocks, KN's forecast mode) on the same
    context, the kernel path's: ((samples, means) of the kernels, (samples,
    means) of the plain steps), each f32[B, horizon]."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    one = tc.tree_map(lambda a: a[None], params)
    x, ctx, mu, sg = tt.tf_embed_context(one, cfg, raw=windows)
    nxt, nxt_plain = torch.empty_like(ctx), torch.empty_like(ctx)
    outs = [[torch.zeros((windows.shape[0], cfg.horizon), device=windows.device)
             for _ in range(2)] for _ in range(2)]
    for step in range(cfg.horizon):
        if step:
            x = tt.tf_embed_context(one, cfg, ctx=ctx)
        xp = tt.tf_embed_context_plain(one, cfg, ctx=ctx)
        tt.tf_head_forecast(one, cfg, tt._blocks(one, x, cfg), ctx, nxt, eps[step], mu, sg,
                            *outs[0], step)
        tt.tf_head_forecast_plain(one, cfg, tt._blocks(one, xp, cfg, tt.PLAIN_OPS), ctx,
                                  nxt_plain, eps[step], mu, sg, *outs[1], step)
        ctx, nxt = nxt, ctx
    return outs


def bf16_ulps(got, want, floor: float = 2.0 ** -11):
    """How far apart two bf16 tensors are in bf16 ulps, the ulp taken at
    the larger magnitude of each pair and at least at ``floor`` (below it
    the f32 decode's own error, ~1e-6 after normalization, exceeds an
    ulp): (the largest distance, the share of elements that differ)."""
    import torch

    g, w = got.float(), want.float()
    mag = torch.clamp_min(torch.maximum(g.abs(), w.abs()), floor)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max()), float((g != w).float().mean())


def vit_wires(frames: np.ndarray):
    """The frames' compressed wire: 4:2:0 cut to every width of the ladder,
    and 4:4:4 at its own width. -> ({(sub, k): (planes, layout)}, the 4:2:0
    batch's own ladder width, its zigzag extent)."""
    from sitewhere_tpu_torch.ops.dct import COEF_BUCKETS

    planes, lay, extent = encode_frames(frames, 2)
    wires = {(2, k): truncated(planes, lay, k) for k in COEF_BUCKETS}
    p1, l1, _ = encode_frames(frames, 1)
    wires[(1, l1.k)] = (p1, l1)
    return wires, lay.k, extent


def vit_phase(dev, params, x_u8, wires, k_main: int) -> dict:
    """KP, KJ, KV, KL, KA, KU and KT at config 5's shapes, each beside its
    plain version on the inputs the main path gives it (KP and KV bitwise;
    KJ's RGB within 1e-3 of decode_frames, its bf16 patches within one
    bf16 ulp; KL on the tokens with block 0's ln1 ([12608, 768], one slot),
    KA on block 0's projections (64 frames x 197 tokens x 12 heads x hd 64,
    non-causal), KU on block 0's fc1 product ([12608, 3072]), each within
    2e-2; KT's logits within 2e-2 and its top-k by the tie-tolerant rule),
    timed beside its bound and, where one PyTorch call computes the same
    function, that call."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops import dct as td

    cfg = tv.VIT_B16
    dtype, p, d = cfg.compute_dtype, cfg.patch_size, cfg.dim
    b, h, w, _ = x_u8.shape
    n = cfg.num_patches
    out = {}
    # KP: u8 frames (normalized on the device) and pre-normalized f32 frames
    kp = tv.frame_patches(x_u8, p, dtype)
    kpp = tv.frame_patches_plain(x_u8, p, dtype)
    images = (x_u8.float() / 255.0 - 0.5) / 0.5
    kp32, kpp32 = tv.frame_patches(images, p, dtype), tv.frame_patches_plain(images, p, dtype)
    torch.cuda.synchronize()
    check(torch.equal(kp, kpp), "vit_b16 KP u8 bitwise")
    check(torch.equal(kp32, kpp32), "vit_b16 KP f32 bitwise")
    out["frame_patches"] = dict(
        max_abs_err=0.0, ms=cuda_time_ms(lambda: tv.frame_patches(x_u8, p, dtype), 50),
        plain_ms=cuda_time_ms(lambda: tv.frame_patches_plain(x_u8, p, dtype), 5, 1),
        f32_ms=cuda_time_ms(lambda: tv.frame_patches(images, p, dtype), 50), library_ms=None,
        **_bound(x_u8.numel() + kp.numel() * 2, 3.0 * kp.numel(), F32_FLOPS),
    )
    del images, kp32, kpp32
    # KJ at every wire
    kj = {}
    for (sub, k), (planes, lay) in sorted(wires.items()):
        y, cb, cr = (torch.from_numpy(a).to(dev) for a in planes)
        pk, rgbk = td.decode_rgb(y, cb, cr, lay, p, dtype)
        pp, rgbp = td.dct_patches_plain(y, cb, cr, lay, p, dtype), td.decode_frames(y, cb, cr, lay)
        torch.cuda.synchronize()
        rgb_err = _held(f"vit_b16 KJ sub {sub} k {k} rgb", rgbk, rgbp, 1e-3)
        check(rgb_err <= 1e-3, f"vit_b16 KJ sub {sub} k {k} rgb within 1e-3 ({rgb_err})")
        ulps, share = bf16_ulps(pk, pp)
        check(ulps <= 1.0, f"vit_b16 KJ sub {sub} k {k} patches within one bf16 ulp ({ulps})")
        blocks = lay.y_blocks + 2 * lay.c_blocks
        rec = dict(
            sub=sub, k=k, max_abs_err=float((pk.float() - pp.float()).abs().max()),
            rgb_max_abs_err=rgb_err, max_bf16_ulps=ulps, share_one_ulp_apart=share,
            ms=cuda_time_ms(lambda: td.dct_patches(y, cb, cr, lay, p, dtype), 20),
            plain_ms=cuda_time_ms(lambda: td.dct_patches_plain(y, cb, cr, lay, p, dtype), 3, 1),
            library_ms=None, wire_bytes=lay.wire_bytes(b),
            # separable IDCT 32 flops a block pixel; upsample, colour,
            # clamp and normalization ~45 an output pixel
            **_bound(lay.wire_bytes(b) + pk.numel() * 2,
                     b * (blocks * 64 * 32.0 + h * w * 45.0), F32_FLOPS),
        )
        emit({"phase": "kernel", "shape": "vit_b16", "name": "dct_patches", **rec})
        kj[(sub, k)] = rec
    out["dct_patches"] = kj[(2, k_main)]
    # KV on the patch projection's product
    wp = params["patch"]["w"].to(dtype)
    prod = torch.matmul(kp, wp)
    emb = (prod, params["patch"]["b"], params["cls"], params["pos"])
    x = tv.vit_embed(*emb)
    xp = tv.vit_embed_plain(*emb)
    torch.cuda.synchronize()
    check(torch.equal(x, xp), "vit_b16 KV bitwise")
    out["vit_embed"] = dict(
        max_abs_err=0.0, ms=cuda_time_ms(lambda: tv.vit_embed(*emb), 50),
        plain_ms=cuda_time_ms(lambda: tv.vit_embed_plain(*emb), 5, 1), library_ms=None,
        **_bound((prod.numel() + x.numel()) * 2 + (2 * d + (n + 1) * d) * 4, 2.0 * x.numel(),
                 F32_FLOPS),
    )
    # KL on the tokens with block 0's ln1 (the params one slot of views)
    one = tc.tree_map(lambda a: a[None], params["blocks"])
    blk = one[0]
    rows = b * (n + 1)
    x2 = x.reshape(-1, d)
    sc, bi = blk["ln1"]["scale"], blk["ln1"]["bias"]
    hn = tc.layernorm_rows(x2, sc, bi, rows)
    hp = tc.layernorm_rows_plain(x2, sc, bi, rows)
    torch.cuda.synchronize()
    x3, sc3, bi3 = x.reshape(1, rows, d), sc[:, None].to(dtype), bi[:, None].to(dtype)
    out["layernorm"] = dict(
        max_abs_err=_held("vit_b16 KL", hn, hp),
        ms=cuda_time_ms(lambda: tc.layernorm_rows(x2, sc, bi, rows), 20),
        plain_ms=cuda_time_ms(lambda: tc.layernorm_rows_plain(x2, sc, bi, rows), 3, 1),
        library_ms=cuda_time_ms(lambda: torch.addcmul(bi3, F.layer_norm(x3, (d,)), sc3), 20),
        library_call="F.layer_norm + torch.addcmul (two calls)",
        **_bound(2 * x.numel() * 2 + 2 * d * 4, 8.0 * x.numel(), F32_FLOPS),
    )
    del hp
    # KA on block 0's projections
    q, k_, v = (tc.dense_stacked(blk["attn"][nm], hn.reshape(1, b, n + 1, d), dtype)
                .reshape(b, n + 1, d) for nm in ("wq", "wk", "wv"))
    out["attention"] = _attn_phase("vit_b16", q, k_, v, cfg.heads, False, 5)
    del q, k_, v
    # KU on block 0's fc1 product
    fc1 = blk["mlp"]["fc1"]
    f = torch.bmm(hn.reshape(1, rows, d), tc.kernel_weight(fc1, dtype)).reshape(rows, -1)
    g = tc.bias_gelu(f, fc1["b"], rows)
    gp = tc.bias_gelu_plain(f, fc1["b"], rows)
    torch.cuda.synchronize()
    err = _held("vit_b16 KU", g, gp)
    del g, gp
    f3, b3 = f.view(1, rows, -1), fc1["b"].to(dtype)[:, None]
    out["bias_gelu"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: tc.bias_gelu(f, fc1["b"], rows), 20),
        plain_ms=cuda_time_ms(lambda: tc.bias_gelu_plain(f, fc1["b"], rows), 3, 1),
        library_ms=cuda_time_ms(lambda: F.gelu(f3 + b3, approximate="tanh"), 20),
        library_call="F.gelu(x + b, approximate='tanh')",
        **_bound(2 * f.numel() * 2 + fc1["b"].numel() * 4, 10.0 * f.numel(), F32_FLOPS),
    )
    del hn, f, f3
    # the blocks to KT's input
    hfin = tc.blocks_stacked(one, x[None], cfg.heads, False, dtype, tv.KERNEL_OPS)[0]
    # KT
    head = (hfin, params["ln_f"], params["head"], VIT_TOPK)
    lk, pk5, ik5 = tv.vit_head(*head)
    lp, pp5, ip5 = tv.vit_head_plain(*head)
    torch.cuda.synchronize()
    err = _held("vit_b16 KT logits", lk, lp)
    tk = topk_agreement(pk5.cpu(), ik5.cpu(), pp5.cpu(), ip5.cpu(),
                        tv.softmax_plain(lp).cpu(), TOL)
    emit({"phase": "topk", "tag": "vit_b16 KT vs plain", **tk})
    check(tk["ok"], f"vit_b16 KT top-k by the tie-tolerant rule ({tk})")
    c = cfg.num_classes
    out["vit_head"] = dict(
        max_abs_err=err, ms=cuda_time_ms(lambda: tv.vit_head(*head), 50),
        plain_ms=cuda_time_ms(lambda: tv.vit_head_plain(*head), 5, 1), library_ms=None,
        # the [CLS] rows, ln_f, the f32 head, logits, probs and ids; the
        # head's product multiplies operands rounded to the compute dtype
        # with f32 accumulation (the tensor cores' rate in bf16), ln_f, the
        # softmax and the top-k are f32
        **_bound(b * d * 2 + (2 * d + d * c + c) * 4 + b * c * 4 + b * VIT_TOPK * 8,
                 2.0 * b * d * c, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS,
                 b * (8.0 * d + 6.0 * c)),
        logit_range=[float(lk.min()), float(lk.max())],
    )
    for name in ("frame_patches", "vit_embed", "layernorm", "bias_gelu", "vit_head"):
        emit({"phase": "kernel", "shape": "vit_b16", "name": name, **out[name]})
    return out


def vit_logit_accuracy(tag: str, got, twin, ref) -> dict:
    """Logits of a path against the plain twin's and an f32 plain
    reference's: each one's mean, q99 and max abs error against the
    reference, and the share of the path's logits past 2e-2 of the twin."""
    import torch

    got, twin, ref = (a.double().cpu() for a in (got, twin, ref))
    rec = {"tag": tag, "logits": got.numel()}
    for name, a in (("kernel", got), ("plain", twin)):
        e = (a - ref).abs()
        rec.update({f"{name}_mean_abs_err": float(e.mean()),
                    f"{name}_q99_abs_err": float(e.flatten().quantile(0.99)),
                    f"{name}_max_abs_err": float(e.max())})
    rec["share_past_bar_of_twin"] = float(
        (~torch.isclose(got, twin, rtol=TOL, atol=TOL)).double().mean())
    rec["as_accurate"] = rec["kernel_mean_abs_err"] <= 1.25 * rec["plain_mean_abs_err"] + 1e-3
    return rec


def topk_ids_check(tag: str, logits, probs, ids, ref) -> dict:
    """A forward's top-k ids held two ways: (1) they are the top-k of its
    own logits (the plain softmax and stable sort of them, by the
    tie-tolerant rule at 2e-4: what the top-k itself must get right);
    (2) each id's logit in the reference ``ref`` is no further below the
    reference's k-th largest than twice the frame's largest logit error
    (+1e-5), which any top-k of the forward's own logits meets: a class
    the reference does not rank in its top k is chosen only over one it
    does, whose logit the forward did not put higher."""
    import torch

    from sitewhere_tpu_torch.models import vit as tv

    own = topk_agreement(probs.cpu(), ids.cpu(), *(a.cpu() for a in tv.softmax_topk_plain(
        logits, ids.shape[1])), tv.softmax_plain(logits).cpu(), TF32_TOL)
    got, ref = logits.double().cpu(), ref.double().cpu()
    kth = ref.sort(dim=1, descending=True).values[:, ids.shape[1] - 1:ids.shape[1]]
    short = (kth - ref.gather(1, ids.long().cpu())).clamp_min(0)
    room = 2 * (got - ref).abs().amax(1, keepdim=True) + 1e-5
    rec = {"own_topk": own, "ref_shortfall_max": float(short.max()),
           "ref_shortfall_over_room_max": float((short - room).max()),
           "ok": own["ok"] and bool((short <= room).all())}
    check(own["ok"], f"{tag}: the top-k of its own logits ({own})")
    check(bool((short <= room).all()), f"{tag}: each id's reference logit within twice the "
          f"logit error of the reference's k-th ({rec})")
    return rec


def vit_accuracy_phase(params, x_u8, wire) -> dict:
    """The whole forward, frames (u8) and the compressed wire: (1) bf16
    kernel logits against the plain twin and an f32 plain reference, the
    kernels' mean abs error no more than 1.25x the twin's + 1e-3; the top-k
    the same way, by the mean relative error of its probabilities against
    the f32 softmax at its ids; a twin whose head bias is dropped shown
    failing both. Two bf16 forwards differ past 2e-2 in a logit (ROADMAP
    queue 3), so the tie-tolerant rule against the twin is printed, not
    held, in bf16. (2) f32 compute: every kernel logit within 2e-4 of a
    float64 plain forward, and its top-k by the tie-tolerant rule at 2e-4.
    In both, the kernels' top-k ids (and in bf16 the twin's) by
    ``topk_ids_check`` against the f32 (f64) plain logits."""
    import types

    import torch

    from sitewhere_tpu_torch.models import vit as tv

    cfg = tv.VIT_B16
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cfg64 = types.SimpleNamespace(**dataclasses.asdict(cfg32), compute_dtype=torch.float64,
                                  num_patches=cfg.num_patches)
    no_bias = tv.PLAIN_OPS._replace(head=lambda h, ln, hd, k: tv.vit_head_plain(
        h, ln, {"w": hd["w"], "b": torch.zeros_like(hd["b"])}, k))
    planes, lay = wire
    planes = [torch.from_numpy(a).to(x_u8.device) for a in planes]
    runs = {
        "frames": lambda c, ops: tv._classify(params, c, x_u8, VIT_TOPK, ops),
        f"dct k{lay.k}": lambda c, ops: tv._classify_dct(params, c, *planes, lay, VIT_TOPK, ops),
    }
    out = {}
    for path, run in runs.items():
        lk, pk, ik = run(cfg, tv.KERNEL_OPS)
        lt, pt, it = run(cfg, tv.PLAIN_OPS)
        l32 = run(cfg32, tv.PLAIN_OPS)[0]
        lf, pf, i_f = run(cfg, no_bias)
        torch.cuda.synchronize()
        rec = vit_logit_accuracy(f"vit_b16 bf16 {path}", lk, lt, l32)
        fault = vit_logit_accuracy(f"vit_b16 bf16 {path}, twin without the head bias", lf, lt, l32)
        p32 = tv.softmax_plain(l32)

        def topk_err(p, i):  # mean relative error of top-k probabilities vs f32
            return float(((p - p32.gather(1, i.long())).abs() / p).mean())

        te = {name: topk_err(p, i) for name, (p, i) in
              (("kernel", (pk, ik)), ("plain", (pt, it)), ("fault", (pf, i_f)))}
        bar = 1.25 * te["plain"] + 1e-3
        rec.update(fault_mean_abs_err=fault["kernel_mean_abs_err"],
                   fault_rejected=not fault["as_accurate"],
                   topk_rel_err=te, topk_fault_rejected=te["fault"] > bar,
                   topk_rule_vs_twin=topk_agreement(pk.cpu(), ik.cpu(), pt.cpu(), it.cpu(),
                                                    tv.softmax_plain(lt).cpu(), TOL))
        rec["ids"] = topk_ids_check(f"vit_b16 bf16 {path} top-k ids vs f32", lk, pk, ik, l32)
        rec["twin_ids"] = topk_ids_check(f"vit_b16 bf16 {path} twin's top-k ids vs f32",
                                         lt, pt, it, l32)
        emit({"phase": "accuracy", **rec})
        check(rec["as_accurate"], f"vit_b16 {path}: the kernels' logits as accurate as the "
              f"plain version's ({rec['kernel_mean_abs_err']} vs {rec['plain_mean_abs_err']})")
        check(rec["fault_rejected"], f"vit_b16 {path}: the accuracy check rejects a twin "
              f"without the head bias ({fault['kernel_mean_abs_err']})")
        check(te["kernel"] <= bar, f"vit_b16 {path}: the kernels' top-k as accurate as the "
              f"plain version's ({te})")
        check(rec["topk_fault_rejected"], f"vit_b16 {path}: the top-k accuracy check rejects "
              f"a twin without the head bias ({te})")
        del lk, lt, l32, lf, p32
        # f32 compute against float64
        k32, p32, i32 = run(cfg32, tv.KERNEL_OPS)
        l64, p64, i64 = run(cfg64, tv.PLAIN_OPS)
        torch.cuda.synchronize()
        f64_err = _held(f"vit_b16 f32 {path} logits vs f64", k32, l64.float(), TF32_TOL)
        t64 = topk_agreement(p32.cpu(), i32.cpu(), p64.cpu(), i64.cpu(),
                             tv.softmax_plain(l64).cpu(), TF32_TOL)
        ids64 = topk_ids_check(f"vit_b16 f32 {path} top-k ids vs f64", k32, p32, i32, l64)
        emit({"phase": "accuracy", "tag": f"vit_b16 f32 {path} vs f64", "max_abs_err": f64_err,
              "topk": t64, "ids": ids64})
        check(t64["ok"], f"vit_b16 f32 {path}: top-k vs f64 by the tie-tolerant rule ({t64})")
        out[path] = {"bf16": rec, "f32_vs_f64_max_abs_err": f64_err, "f32_topk": t64}
    return out


VIT_EXPECTED = {"vit_embed": 1, "layernorm": 24, "attention": 12, "bias_gelu": 12, "vit_head": 1}


def vit_drive(svc, params, frames: np.ndarray, wires: dict) -> dict:
    """The main path: 64 camera frames through ``StreamingMedia`` as u8
    frames (``classify_frames_dispatch``) and as their 4:2:0 coefficients
    at every ladder width (``classify_coeffs_dispatch``), each read back
    with ``topk_results``; every kernel's count set to 0 before each call
    and read after it, and held to the forward's exact launches. Each
    call's top-k is then held bitwise to ``models.vit.classify`` /
    ``classify_dct`` with ``params`` (the service's) on the same input:
    the same kernels, so a fault in the service's transfer, readback or
    parameters shows. Returns (launches, variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import vit as tv

    dev, cfg = torch.device(svc.device), tv.VIT_B16
    calls = [("frames", "frame_patches", lambda: svc.classify_frames_dispatch(frames, VIT_TOPK),
              lambda: tv.classify(params, cfg, torch.from_numpy(frames).to(dev), VIT_TOPK))]
    for (sub, k), (planes, lay) in sorted(wires.items()):
        if sub == 2:
            calls.append((
                f"dct k{k}", "dct_patches",
                lambda pl=planes, la=lay: svc.classify_coeffs_dispatch(*pl, la, VIT_TOPK),
                lambda pl=planes, la=lay: tv.classify_dct(
                    params, cfg, *(torch.from_numpy(a).to(dev) for a in pl), la, VIT_TOPK)))
    launches = {name: 0 for name in kernels.KERNELS}
    variants: dict = {}
    recs = []
    for path, first, call, direct in calls:
        kernels.reset_launches()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        pv, iv = call()
        ev1.record()
        res = svc.topk_results(pv, iv)
        host_s = time.perf_counter() - t0
        counts, vcounts = kernels.launches(), kernels.variant_launches()
        want = {name: 0 for name in kernels.KERNELS}
        want.update(VIT_EXPECTED, **{first: 1})
        check(counts == want, f"vit_b16 {path}: launches {counts}")
        check(len(res) == frames.shape[0] and all(len(r) == VIT_TOPK for r in res),
              f"vit_b16 {path}: a top-{VIT_TOPK} a frame")
        ids = np.array([[i for i, _ in r] for r in res])
        probs = np.array([[q for _, q in r] for r in res])
        check(bool(np.isfinite(probs).all() and (probs > 0).all()
                   and (probs.sum(1) <= 1 + 1e-5).all() and (np.diff(probs, axis=1) <= 0).all()),
              f"vit_b16 {path}: finite, descending probabilities")
        check(bool(((ids >= 0) & (ids < 1000)).all())
              and all(len(set(r)) == VIT_TOPK for r in ids.tolist()),
              f"vit_b16 {path}: distinct class ids")
        _, p_direct, i_direct = direct()
        check(np.array_equal(ids, i_direct.cpu().numpy())
              and np.array_equal(probs, p_direct.cpu().numpy().astype(np.float64)),
              f"vit_b16 {path}: the service's top-k bitwise that of models.vit on the same input")
        for name, n in counts.items():
            launches[name] += n
        for key, n in vcounts.items():
            variants[key] = variants.get(key, 0) + n
        recs.append({"path": path, "device_ms": ev0.elapsed_time(ev1), "host_s": host_s,
                     "top1_ids": ids[:4, 0].tolist(), "top1_p_max": float(probs[:, 0].max())})
    emit({"phase": "main_path", "family": "vit_b16", "frames": int(frames.shape[0]),
          "calls": recs})
    return launches, variants


def device_rows(fn) -> list:
    """``fn`` once (warm) and once under torch.profiler: [kernel name, device
    ms, count] rows, the largest first (empty if the profiler sees no
    device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue  # host ops: their device time is their kernels'
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append([e.key[:80], us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_run(tag: str, fn) -> None:
    """``fn``'s device time by kernel name under torch.profiler (a record;
    the script goes on if the profiler sees no device time)."""
    rows = device_rows(fn)
    emit({"phase": "profile", "shape": tag, "device_ms": sum(r[1] for r in rows),
          "by_kernel_ms_count": rows[:16]})


def profile_flush(scorer, rng, tag: str = "transformer32") -> None:
    """One full transformer32 flush under torch.profiler."""
    t, b, s = SHAPES["transformer32"]
    ids = zipf_ids(rng, s, (t, b)).astype(np.uint16)
    vals = rng.normal(size=(t, b)).astype(np.float32)
    counts = np.full((t, 1), b, np.int32)
    profile_run(tag, lambda: np.asarray(scorer.step_counts(ids, vals, counts)))


# -- the ViT's inputs: the compressed wire, and the top-k rule --------------------------

# the JPEG standard's base quantization tables (ITU-T T.81 Annex K,
# K.1 luminance and K.2 chrominance), natural order
JPEG_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.float64).reshape(8, 8)
JPEG_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
], np.float64).reshape(8, 8)


def jpeg_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's quality scaling of a base table."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip(np.floor((base * scale + 50) / 100), 1, 255)


def encode_frames(frames: np.ndarray, sub: int, quality: int = 75):
    """The compressed wire's coefficients of u8 frames [B, H, W, 3], made
    as a JPEG encoder makes them: BT.601 YCbCr, box-averaged 4:2:0 chroma
    (sub 2), edge-padded to the MCU grid, the forward DCT C = M X M^T of
    each level-shifted 8x8 block, quantized with the standard tables at
    ``quality`` and dequantized, in zigzag order, truncated at the ladder
    width of the batch's largest extent. -> (y_z, cb_z, cr_z) int16 and
    their ``FrameLayout``, and that extent."""
    from sitewhere_tpu_torch.ops.dct import ZIGZAG, coef_bucket, idct_basis, layout_for

    b, h, w, _ = frames.shape
    lay = layout_for(w, h, sub, 64)
    f = frames.astype(np.float64)
    r, g, bl = f[..., 0], f[..., 1], f[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * bl,
           -0.168736 * r - 0.331264 * g + 0.5 * bl + 128.0,
           0.5 * r - 0.418688 * g - 0.081312 * bl + 128.0]
    pad = ((0, 0), (0, 8 * lay.y_gh - h), (0, 8 * lay.y_gw - w))
    ycc = [np.pad(p, pad, mode="edge") for p in ycc]
    if sub == 2:
        ycc[1:] = [p.reshape(b, p.shape[1] // 2, 2, p.shape[2] // 2, 2).mean((2, 4))
                   for p in ycc[1:]]
    m = idct_basis().astype(np.float64)
    planes = []
    for plane, base in zip(ycc, (JPEG_LUMA_Q, JPEG_CHROMA_Q, JPEG_CHROMA_Q)):
        gh, gw = plane.shape[1] // 8, plane.shape[2] // 8
        blocks = (plane - 128.0).reshape(b, gh, 8, gw, 8).transpose(0, 1, 3, 2, 4)
        q = jpeg_table(base, quality)
        coef = np.round((m @ blocks @ m.T) / q) * q
        planes.append(coef.reshape(b, gh * gw, 64)[..., ZIGZAG].astype(np.int16))
    nz = [np.nonzero(p.reshape(-1, 64).any(0))[0] for p in planes]
    extent = int(max((int(z.max()) + 1 if z.size else 1) for z in nz))
    k = coef_bucket(extent)
    return tuple(np.ascontiguousarray(p[..., :k]) for p in planes), lay._replace(k=k), extent


def truncated(planes, layout, k: int):
    """The coefficient planes cut (or zero-padded) to width ``k``."""
    out = []
    for p in planes:
        q = np.zeros(p.shape[:2] + (k,), np.int16)
        q[..., :min(k, p.shape[-1])] = p[..., :k]
        out.append(q)
    return tuple(out), layout._replace(k=k)


def topk_agreement(p_got, id_got, p_plain, id_plain, full_plain, bar: float) -> dict:
    """The top-k rule, tolerant of ties: at every position j,
    |p_got[j] - p_plain[j]| <= bar * p_plain[j], and the plain full softmax
    at id_got[j] is within bar * p_got[j] of p_got[j]. So two classes whose
    probabilities tie within the bar may swap places; any other difference
    in the ids fails. Arrays [B, k] (full_plain [B, classes]); returns the
    worst of each ratio to its bar, whether both hold, and the share of ids
    equal to the plain version's (id_plain)."""
    p_got, p_plain, full_plain = (np.asarray(a, np.float64) for a in (p_got, p_plain, full_plain))
    id_got = np.asarray(id_got)
    at = np.take_along_axis(full_plain, id_got.astype(np.int64), axis=1)
    first = np.abs(p_got - p_plain) / (bar * p_plain)
    second = np.abs(at - p_got) / (bar * p_got)
    worst = (float(first.max()), float(second.max()))
    return {"prob_ratio_max": worst[0], "id_ratio_max": worst[1],
            "ok": bool(worst[0] <= 1.0 and worst[1] <= 1.0),
            "ids_equal_share": float((id_got == np.asarray(id_plain)).mean())}


# -- phase 3e: the train kernels (KB, KR, KO) on the train plane --------------------

def train_rings(dev, t: int, s: int, seed: int, w: int = WINDOW):
    """The train plane's rings: every stream of every slot a random walk,
    pos random, count in [0, 2W) (most rows past the 8-sample gate)."""
    import torch

    from sitewhere_tpu_torch.ops.windows import WindowState

    gen = torch.Generator(device=dev).manual_seed(seed)
    return WindowState(
        torch.randn((t, s, w), generator=gen, device=dev).cumsum(-1),
        torch.randint(0, w, (t, s), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 2 * w, (t, s), generator=gen, device=dev, dtype=torch.int32),
    )


def train_rows(state):
    """The train step's row mask with every slot trainable: (n >= 8)."""
    import torch

    w = state.values.shape[-1]
    return (state.count.clamp(max=w) >= min(w, 8)).to(torch.float32)


def _masked_mean(per_row, rows):
    import torch

    return ((per_row * rows).sum(-1) / torch.clamp_min(rows.sum(-1), 1.0)).sum()


def kernel_train_grads(spec, params, cfg, state, rows):
    """The train form on the card (KB or KR in ring mode, the dWh bmm):
    per-row loss and the gradient of the masked per-slot mean, leaves in
    tree order."""
    from sitewhere_tpu_torch.models import common as tc

    out = {}

    def obj(p):
        out["per_row"] = spec.loss_ring(p, cfg, state)
        return _masked_mean(out["per_row"], rows)

    _, g = tc.value_and_grad(obj, params)
    return out["per_row"].detach(), tc.tree_leaves(g)


def plain_train_grads(spec, params, cfg, state, rows, loss_fn=None, chunk: int = 8):
    """The same through the plain version (``loss_fn``, default the
    family's ``loss_stacked_plain``) under autograd, ``chunk`` slots at a
    time (slots are independent; the chunks bound autograd's memory)."""
    from sitewhere_tpu_torch.models.train import ring_windows

    loss_fn = loss_fn or spec.loss_stacked_plain
    return chunked_train_grads(lambda p, c, r: loss_fn(p, c, ring_windows(r)), params, cfg,
                               state, rows, chunk)


def rel_norm(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def leaf_names(params) -> list:
    """A param tree's leaves in tree order, named by path ("wx/w",
    "blocks/0/attn/wk/b")."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return [n for k, v in node.items() for n in walk(v, f"{prefix}{k}/")]
        if isinstance(node, (list, tuple)):
            return [n for i, v in enumerate(node) for n in walk(v, f"{prefix}{i}/")]
        return [prefix[:-1]]

    return walk(params, "")


def train_phase(shape: str, dev, spec, cfg, params, seed: int = 0, w: int = WINDOW) -> dict:
    """KB or KR at the train plane of ``shape`` (every slot x every stream,
    all 32 slots trainable), held against the plain version under
    autograd: f32 compute per element (loss rtol 1e-5 / atol 1e-6, grads
    rtol 1e-4 / atol 1e-5, ``tests/test_train_lane.py:121``); bf16 compute
    by each leaf's relative-norm error against the f32 plain gradient, the
    kernel's and the plain version's each at most 2e-2."""
    import torch

    from sitewhere_tpu_torch.models import deepar as td
    from sitewhere_tpu_torch.models import lstm_ad as tl
    from sitewhere_tpu_torch.models import train as tr

    t, _, s = SHAPES[shape]
    name = "lstm_train" if spec.name == "lstm_ad" else "gru_train"
    hid = params["wh"]["w"].shape[-2]
    tag = f"{shape} {name}[h{hid}]"
    state = train_rings(dev, t, s, 31 + seed, w)
    rows = train_rows(state)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss_k, g_k = kernel_train_grads(spec, params, cfg32, state, rows)
    loss_p, g_p32 = plain_train_grads(spec, params, cfg32, state, rows)
    torch.cuda.synchronize()
    names = leaf_names(params)
    # per row on the rows the step trains on: a window of n < 8 samples is
    # left-padded with its oldest value, so with 2 to 4 samples it is
    # nearly constant and its normalization amplifies the two versions'
    # different reduction orders (ROADMAP queue 3); the row mask drops it
    live = rows > 0
    apart = ~torch.isclose(loss_k, loss_p, rtol=1e-5, atol=1e-6)
    n_of = state.count.clamp(max=w)[apart]
    emit({"phase": "train_f32_loss_rows", "shape": shape, "name": name, "variant": f"h{hid}",
          "rows_outside_bar": int(apart.sum()), "trained_rows_outside_bar": int((apart & live).sum()),
          "their_n_min_max": [int(n_of.min()), int(n_of.max())] if n_of.numel() else None,
          "max_abs_err_all_rows": float((loss_k - loss_p).abs().max())})
    loss_err = float((loss_k - loss_p)[live].abs().max())
    check(bool(torch.isfinite(loss_k).all()), f"{tag} finite loss")
    check(bool(torch.allclose(loss_k[live], loss_p[live], rtol=1e-5, atol=1e-6)),
          f"{tag} f32 loss per trained row (max abs err {loss_err})")
    grad_err = {}
    for n, a, b in zip(names, g_k, g_p32):
        grad_err[n] = float((a - b).abs().max())
        worst = float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
        check(bool(torch.isfinite(a).all()), f"{tag} f32 grad {n} finite")
        check(worst <= 1.0, f"{tag} f32 grad {n} per element at rtol 1e-4, atol 1e-5 "
                            f"(worst ratio to the bar {worst}, max abs err {grad_err[n]})")
    _, g_k16 = kernel_train_grads(spec, params, cfg, state, rows)
    _, g_p16 = plain_train_grads(spec, params, cfg, state, rows)
    bf16 = {}
    for n, a, b, want in zip(names, g_k16, g_p16, g_p32):
        bf16[n] = (rel_norm(a, want), rel_norm(b, want))
    emit({"phase": "train_bf16_grads", "shape": shape, "name": name, "variant": f"h{hid}",
          "rel_norm_vs_f32_kernel_plain": bf16})
    for n, (k_err, p_err) in bf16.items():
        check(k_err <= TOL, f"{tag} bf16 grad {n}: kernel {k_err} vs f32 within {TOL}")
        check(p_err <= TOL, f"{tag} bf16 grad {n}: plain {p_err} vs f32 within {TOL}")
    _, again = kernel_train_grads(spec, params, cfg, state, rows)
    check(all(torch.equal(a, b) for a, b in zip(g_k16, again)),
          f"{tag} deterministic (two runs, same bits)")
    # times: the train form's forward + backward (both launches, the dWh
    # bmm, autograd's glue), its forward alone, the bmm alone
    kform = tl.KB if name == "lstm_train" else td.KR
    weights = [params[a][b] for a, b in kform.leaves]
    ms = cuda_time_ms(lambda: kernel_train_grads(spec, params, cfg, state, rows), 5, 1)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: tr.TrainLoss.apply(kform, cfg, state, None, *weights), 5, 1)
    g = kform.gates * hid
    hp = torch.randn((t, w - 2, s, hid), device=dev).to(torch.bfloat16)
    dg = torch.randn((t, w - 2, s, g), device=dev).to(torch.bfloat16)
    bmm_ms = cuda_time_ms(lambda: torch.stack([
        torch.bmm(hp[i].transpose(1, 2), dg[i]).sum(0, dtype=torch.float32)
        for i in range(t)]), 10, 2)
    del hp, dg
    plain_ms = cuda_time_ms(lambda: plain_train_grads(spec, params, cfg, state, rows), 2, 1)
    flops = 3.0 * t * s * spec.flops_per_row(cfg, w)
    n_params = sum(v.numel() for n_ in params.values() for v in n_.values())
    nbytes = t * s * (w * 4 + 8) + 2 * n_params * 4
    steps = w - 1
    saves = t * steps * s * (4 * hid + (2 if kform.cell else 1) * hid + g) * 2
    rec = dict(max_abs_err=max(grad_err.values()), f32_grad_max_abs_err=grad_err,
               f32_loss_max_abs_err=loss_err, ms=ms, forward_ms=fwd_ms,
               backward_ms=ms - fwd_ms, dwh_bmm_ms=bmm_ms, plain_ms=plain_ms,
               **_bound(nbytes, flops, BF16_FLOPS), library_ms=None,
               library="none (no one call: cuDNN's LSTM/GRU has neither the forget +1 "
                       "nor per-slot weights)",
               flops=flops, rows=t * s, live_rows=int(rows.sum()),
               saved_bf16_bytes=saves)
    emit({"phase": "kernel", "shape": shape, "name": name, "variant": f"h{hid}", "window": w,
          **rec})
    return {"state": state, "rows": rows, "g_p32": g_p32, "rec": rec}


def chunked_train_grads(loss, params, cfg, state, rows, chunk: int, slots=None):
    """Per-row loss and the gradient of the masked per-slot mean on the
    rings ``state``, ``chunk`` slots at a time (slots are independent, so
    the chunks give each slot's own gradient), over ``slots`` (a range; all
    by default). ``loss(p, cfg, ring)`` is the family's ``loss_ring`` or a
    plain version on the ring slice's windows. Leaves in tree order."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.ops.windows import WindowState

    slots = range(rows.shape[0]) if slots is None else slots
    per_row, grads = [], None
    for lo in range(slots.start, slots.stop, chunk):
        sl = slice(lo, min(lo + chunk, slots.stop))
        ring = WindowState(*(x[sl] for x in state))
        out = {}

        def obj(p):
            out["per_row"] = loss(p, cfg, ring)
            return _masked_mean(out["per_row"], rows[sl])

        _, g = tc.value_and_grad(obj, tc.tree_map(lambda x: x[sl], params))
        per_row.append(out["per_row"].detach())
        parts = tc.tree_leaves(g)
        grads = [[x] for x in parts] if grads is None else [a + [x] for a, x in zip(grads, parts)]
    return torch.cat(per_row), [torch.cat(x) for x in grads]


def tf_bf16_errors(names, got, want) -> dict:
    """Each leaf's relative-norm error against the f32 gradient; attn.wk.b's
    exact gradient is 0 (softmax ignores a shift of a query's logits), so
    its error is scaled by its block's attn.wq.b gradient."""
    ref = dict(zip(names, want))
    out = {}
    for n, g, w in zip(names, got, want):
        scale = ref[n.replace("wk/b", "wq/b")] if n.endswith("wk/b") else w
        out[n] = float((g.float() - w.float()).norm() / scale.float().norm().clamp_min(1e-30))
    return out


def _f32_grad_ratio(a, b) -> float:
    """The f32 gradient bar, per element: |a - b| <= 1e-4 |b| + 1e-5 max(1,
    max |b|) (a per-slot gradient sums ~250,000 tokens' terms in another
    order, so an element that cancels to near 0 keeps their rounding).
    Returns the worst ratio to it (<= 1 passes)."""
    atol = 1e-5 * max(1.0, float(b.abs().max()))
    return float(((a - b).abs() / (atol + 1e-4 * b.abs())).max())


def tf_train_kernel_phase(dev, cfg, chunk: int) -> dict:
    """The transformer's train kernels at the shapes a train step gives them
    at transformer32 (one chunk of ``chunk`` slots x 8,192 streams x 31
    tokens, dim 128, 4 heads, fc1 512 wide): KA, KL and KU backward, KE's
    backward and KN's train mode (forward and backward), each against its
    plain version at bf16 (relative norm within 1e-2; its per-slot f32
    sums likewise) and at f32 (per element, the f32 gradient bar) on
    seeded inputs; timed at bf16 beside its bound and, where one PyTorch
    call computes the same function (SDPA's, LayerNorm's and tanh GELU's
    backward), that call."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    _, _, s = SHAPES["transformer32"]
    t, d, heads, w = chunk, cfg.dim, cfg.heads, WINDOW
    tok, f = w - 1, 4 * cfg.dim
    rows = s * tok
    n_tok = t * rows
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def held(tag, got, want, dtype):
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{tag} finite")
        if dtype == torch.float32:
            worst = _f32_grad_ratio(got, want)
            check(worst <= 1.0, f"{tag} f32 per element (worst ratio to the bar {worst})")
        else:
            err = rel_norm(got, want)
            check(err <= 1e-2, f"{tag} bf16 within 1e-2 relative norm ({err})")
        return float((got - want).abs().max())

    for dtype in (torch.float32, torch.bfloat16):
        elt = 2 if dtype == torch.bfloat16 else 4
        tag = f"transformer32_train {str(dtype)[6:]}"
        # KA backward
        q, k, v, do = (rnd((t * s, tok, d), dtype, 1.5) for _ in range(4))
        got = tc.attention_bwd(q, k, v, do, heads, True)
        want = tc.attention_bwd_plain(q, k, v, do, heads, True)
        err = max(held(f"{tag} KA backward {n}", a, b, dtype)
                  for n, a, b in zip(("dq", "dk", "dv"), got, want))
        again = tc.attention_bwd(q, k, v, do, heads, True)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{tag} KA backward bitwise twice")
        del got, want, again
        if dtype == torch.bfloat16:
            hd = d // heads
            pairs = tok * (tok + 1) / 2
            qh, kh, vh = (z.view(t * s, tok, heads, hd).transpose(1, 2).detach()
                          .requires_grad_(True) for z in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            doh = do.view(t * s, tok, heads, hd).transpose(1, 2)
            out["attention_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tc.attention_bwd(q, k, v, do, heads, True), 5),
                plain_ms=cuda_time_ms(lambda: tc.attention_bwd_plain(q, k, v, do, heads, True), 2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    o, (qh, kh, vh), doh, retain_graph=True), 5),
                library_call="scaled_dot_product_attention's backward (autograd.grad)",
                **_bound(7 * n_tok * d * elt, 5 * 2.0 * pairs * hd * heads * t * s, BF16_FLOPS),
                dims=[t * s, tok, heads, hd], p="recomputed from q, k (not saved)")
            del qh, kh, vh, o, doh
        del q, k, v, do
        # KL backward (ln1 of a block: rows of one slot's tokens)
        x, dy = rnd((n_tok, d), dtype, 2.0, 0.5), rnd((n_tok, d), dtype)
        sc = (1 + 0.2 * torch.randn((t, d), generator=gen, device=dev))
        got, want = tc.layernorm_bwd(x, sc, dy, rows), tc.layernorm_bwd_plain(x, sc, dy, rows)
        err = max([held(f"{tag} KL backward dx", got[0], want[0], dtype)]
                  + [held(f"{tag} KL backward {n}", a, b, torch.float32 if dtype ==
                          torch.float32 else dtype)
                     for n, a, b in zip(("dscale", "dbias"), got[1:], want[1:])])
        check(all(torch.equal(a, b) for a, b in zip(got, tc.layernorm_bwd(x, sc, dy, rows))),
              f"{tag} KL backward bitwise twice")
        if dtype == torch.bfloat16:
            xl = x.detach().requires_grad_(True)
            wl = sc[0].detach().requires_grad_(True)
            bl = torch.zeros_like(wl, requires_grad=True)
            yl = F.layer_norm(xl, (d,), wl.to(dtype), bl.to(dtype))
            out["layernorm_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tc.layernorm_bwd(x, sc, dy, rows), 10),
                plain_ms=cuda_time_ms(lambda: tc.layernorm_bwd_plain(x, sc, dy, rows), 2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    yl, (xl, wl, bl), dy, retain_graph=True), 10),
                library_call="F.layer_norm's backward (autograd.grad; one scale for every row)",
                **_bound(3 * n_tok * d * elt + 3 * t * d * 4, 25.0 * n_tok * d, F32_FLOPS))
            del xl, wl, bl, yl
        del x, dy, got, want
        # KU backward (fc1's product and the GELU's cotangent)
        x, dy = rnd((n_tok, f), dtype), rnd((n_tok, f), dtype, 0.1)
        b = 0.1 * torch.randn((t, f), generator=gen, device=dev)
        got, want = tc.bias_gelu_bwd(x, b, dy, rows), tc.bias_gelu_bwd_plain(x, b, dy, rows)
        err = max(held(f"{tag} KU backward dx", got[0], want[0], dtype),
                  held(f"{tag} KU backward db", got[1], want[1], dtype))
        check(all(torch.equal(a, c) for a, c in zip(got, tc.bias_gelu_bwd(x, b, dy, rows))),
              f"{tag} KU backward bitwise twice")
        del got, want
        if dtype == torch.bfloat16:
            xg = x.view(t, rows, f).detach().requires_grad_(True)
            bg = b.to(dtype)[:, None].detach().requires_grad_(True)
            yg = F.gelu(xg + bg, approximate="tanh")
            out["bias_gelu_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tc.bias_gelu_bwd(x, b, dy, rows), 5),
                plain_ms=cuda_time_ms(lambda: tc.bias_gelu_bwd_plain(x, b, dy, rows), 2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    yg, (xg, bg), dy.view(t, rows, f), retain_graph=True), 5),
                library_call="F.gelu(x + b, approximate='tanh')'s backward (autograd.grad)",
                **_bound(3 * n_tok * f * elt + 2 * t * f * 4, 35.0 * n_tok * f, F32_FLOPS))
            del xg, bg, yg
        del x, dy
        # KE backward and KN's train mode on one chunk's windows
        state = train_rings(dev, t, s, 10)
        params = tc.tree_map(lambda *xs: torch.stack(xs), *[tt.init(
            torch.Generator().manual_seed(20 + i), dataclasses.replace(cfg, depth=1), device=dev)
            for i in range(t)])
        own_affines(params, torch.Generator().manual_seed(30))
        cfg_d = dataclasses.replace(cfg, dtype="float32" if dtype == torch.float32 else "bfloat16",
                                    depth=1)
        xk, normed = tt.tf_embed_train(params, cfg_d, state=state)
        xp, normed_p = tt.tf_embed_train_plain(params, cfg_d, state=state)
        live = state.count >= 8
        err_e = max(held(f"{tag} KE train mode tokens", xk[live], xp[live], dtype)
                    if dtype == torch.bfloat16 else
                    _held(f"{tag} KE train mode tokens", xk[live], xp[live], TF32_TOL),
                    _held(f"{tag} KE train mode windows", normed[live], normed_p[live], 1e-5))
        dx = rnd(tuple(xk.shape), dtype)
        got, want = (tt.tf_embed_bwd(dx, normed, cfg.context),
                     tt.tf_embed_bwd_plain(dx, normed, cfg.context))
        err = max([err_e] + [held(f"{tag} KE backward {n}", a, c, dtype)
                             for n, a, c in zip(("dw", "db", "dpos"), got, want)])
        check(all(torch.equal(a, c) for a, c in zip(got, tt.tf_embed_bwd(dx, normed, cfg.context))),
              f"{tag} KE backward bitwise twice")
        if dtype == torch.bfloat16:
            out["tf_embed_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tt.tf_embed_bwd(dx, normed, cfg.context), 10),
                plain_ms=cuda_time_ms(lambda: tt.tf_embed_bwd_plain(dx, normed, cfg.context), 2, 1),
                library_ms=None, library="none (no one call)",
                **_bound(n_tok * d * elt + t * s * w * 4 + t * (2 + cfg.context) * d * 4,
                         3.0 * n_tok * d, F32_FLOPS))
        h = rnd(tuple(xk.shape), dtype, 2.0)
        pk, ok = tt.tf_head_train(params, cfg_d, h, normed)
        pp, op = tt.tf_head_train_plain(params, cfg_d, h, normed)
        err_h = _held(f"{tag} KN train forward (mu, raw)", ok, op,
                      TOL if dtype == torch.bfloat16 else TF32_TOL)
        err_h = max(err_h, _held(f"{tag} KN train forward loss, trained rows", pk[live], pp[live],
                                 TOL if dtype == torch.bfloat16 else TF32_TOL))
        g_row = torch.rand((t, s), generator=gen, device=dev) / s
        got = tt.tf_head_train_bwd(params, cfg_d, h, normed, op, g_row)
        want = tt.tf_head_train_bwd_plain(params, cfg_d, h, normed, op, g_row)
        err = max([err_h] + [held(f"{tag} KN train backward {n}", a.contiguous(), c, dtype)
                             for n, a, c in zip(("dfeats", "dw", "db"), got, want)])
        check(all(torch.equal(a, c) for a, c in zip(
            got, tt.tf_head_train_bwd(params, cfg_d, h, normed, op, g_row))),
            f"{tag} KN train backward bitwise twice")
        if dtype == torch.bfloat16:
            fwd_ms = cuda_time_ms(lambda: tt.tf_head_train(params, cfg_d, h, normed), 10)
            bwd_ms = cuda_time_ms(lambda: tt.tf_head_train_bwd(params, cfg_d, h, normed, op, g_row), 10)
            out["tf_head_train"] = dict(
                max_abs_err=err, ms=fwd_ms + bwd_ms, forward_ms=fwd_ms, backward_ms=bwd_ms,
                plain_ms=cuda_time_ms(lambda: tt.tf_head_train_bwd_plain(
                    params, cfg_d, h, normed, tt.tf_head_train_plain(params, cfg_d, h, normed)[1],
                    g_row), 2, 1),
                library_ms=None, library="none (no one call)",
                **_bound(2 * n_tok * d * elt + 2 * n_tok * 8 + 2 * t * s * w * 4 + t * s * 8,
                         n_tok * (30.0 * d + 80), F32_FLOPS))
        del state, params, xk, xp, normed, normed_p, dx, h, got, want
        torch.cuda.empty_cache()
    for name, rec in out.items():
        emit({"phase": "kernel", "shape": "transformer32_train", "name": name, "chunk_slots": t,
              **rec})
    return out


# head.w's gradient is the one leaf read straight off the f32 NLL's
# derivative, whose kernel and plain forwards differ at ~1e-4 relative on
# some rows (the transformer's f32 bar is 2e-4): its elements near 0 stand
# apart by more than the per-element bar (3.9x it, PERF.md), so it is held
# by its accuracy against float64 alone
F32_CANCELLING = ("head/w",)


def tf_train_phase(dev, spec, cfg, params, seed: int, plain_slots: int = 8) -> dict:
    """The transformer's train step at transformer32's full train plane
    (32 slots x 8,192 streams, window 32, every slot trainable), on rings
    filled as ``train_rings`` fills them; the kernel path a chunk of slots
    at a time as the scorer runs it (``ShardedScorer.train_chunk_slots``).
    Held against the plain twin on slots 0..``plain_slots``-1 (slots are
    independent, so the subset is exact): f32 compute, the loss of every
    trained row at rtol 1e-5 / atol 1e-5 and every gradient per element at
    the f32 gradient bar; bf16 compute, each leaf's relative-norm error
    against the f32 plain gradient within 2e-2, or 1.25x the plain bf16
    gradient's own error where that is larger; the four faulted plain
    twins (``faulted_train_ops``, f32) rejected by that bar; two kernel
    runs bitwise. Records the step's time, chunk and peak memory."""
    import torch

    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models.train import ring_windows
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    t, _, s = SHAPES["transformer32"]
    tag = "transformer32 train step"
    state = train_rings(dev, t, s, 41 + seed)
    rows = train_rows(state)
    names = leaf_names(params)
    sub = range(0, plain_slots)

    def chunk_of(c):
        return max(1, min(t, ShardedScorer.TRAIN_SAVE_BYTES // (s * tt.train_bytes_per_row(c, WINDOW))))

    def plain_loss(ops):
        return lambda p, c, r: tt._train_loss(p, c, ops, windows=ring_windows(r))

    plain_chunk = max(1, spec.plain_train_rows // s)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    loss_k, g_k = chunked_train_grads(spec.loss_ring, params, cfg32, state, rows, chunk_of(cfg32))
    loss_p, g_p = chunked_train_grads(plain_loss(tt.TRAIN_PLAIN_OPS), params, cfg32, state, rows,
                                      plain_chunk, sub)
    torch.cuda.synchronize()
    live = rows[sub] > 0
    lk = loss_k[:plain_slots]
    loss_err = float((lk - loss_p)[live].abs().max())
    loss_rel = float(((lk - loss_p).abs() / loss_p.abs().clamp_min(1e-30))[live].max())
    f32_worst = {n: _f32_grad_ratio(a[:plain_slots], b) for n, a, b in zip(names, g_k, g_p)}
    f32_rel = {n: rel_norm(a[:plain_slots], b) for n, a, b in zip(names, g_k, g_p)}
    emit({"phase": "train_f32", "shape": "transformer32", "slots_compared": plain_slots,
          "loss_max_abs_err": loss_err, "loss_max_rel_err": loss_rel,
          "grad_worst_ratio_to_bar": f32_worst, "grad_rel_norm": f32_rel})
    check(bool(torch.isfinite(loss_k).all()), f"{tag} f32 finite loss")
    # the transformer's f32 bar (2e-4, tests/test_fused_step.py:144): its
    # f32 kernels and plain versions differ at ~1e-4 relative, as its f32
    # flush does against float64
    check(bool(torch.allclose(lk[live], loss_p[live], rtol=TF32_TOL, atol=TF32_TOL)),
          f"{tag} f32 loss per trained row within 2e-4 (max abs err {loss_err})")
    # a float64 plain run of slot 0: the kernel's f32 gradient as accurate
    # as the plain version's, leaf by leaf (relative norm, 1.25x + 1e-6)
    c64 = types.SimpleNamespace(**dataclasses.asdict(cfg32), compute_dtype=torch.float64)
    _, g64 = chunked_train_grads(
        lambda p, c, r: tt._train_loss(p, c, tt.TRAIN_PLAIN_OPS, windows=ring_windows(r).double()),
        params, c64, state, rows, 1, range(0, 1))
    vs64 = {n: (rel_norm(a[:1], r), rel_norm(b[:1], r)) for n, a, b, r in zip(names, g_k, g_p, g64)}
    emit({"phase": "train_f32_vs_f64", "shape": "transformer32", "slot": 0,
          "rel_norm_kernel_plain": vs64})
    del g64
    for n, a in zip(names, g_k):
        check(bool(torch.isfinite(a).all()), f"{tag} f32 grad {n} finite")
        if n.endswith("wk/b"):  # its exact gradient is 0: held by the bf16 rule's scale
            continue
        check(vs64[n][0] <= 1.25 * vs64[n][1] + 1e-6,
              f"{tag} f32 grad {n} as accurate as the plain version's vs float64 {vs64[n]}")
        if n not in F32_CANCELLING:
            check(f32_worst[n] <= 1.0, f"{tag} f32 grad {n} per element ({f32_worst[n]})")
    _, g_k16 = chunked_train_grads(spec.loss_ring, params, cfg, state, rows, chunk_of(cfg))
    _, g_p16 = chunked_train_grads(plain_loss(tt.TRAIN_PLAIN_OPS), params, cfg, state, rows,
                                   plain_chunk, sub)
    err_k = tf_bf16_errors(names, [a[:plain_slots] for a in g_k16], g_p)
    err_p = tf_bf16_errors(names, g_p16, g_p)
    emit({"phase": "train_bf16_grads", "shape": "transformer32", "name": "transformer train",
          "slots_compared": plain_slots, "rel_norm_vs_f32_kernel_plain":
              {n: (err_k[n], err_p[n]) for n in names}})
    for n in names:
        check(err_k[n] <= max(TOL, 1.25 * err_p[n]),
              f"{tag} bf16 grad {n}: kernel {err_k[n]} vs f32 (plain bf16 {err_p[n]})")
    faults = {}
    for which in TRAIN_FAULTS:
        _, g_f = chunked_train_grads(plain_loss(faulted_train_ops(which)), params, cfg32, state,
                                     rows, plain_chunk, range(0, min(plain_chunk, plain_slots)))
        errs = tf_bf16_errors(names, g_f, [x[:g_f[0].shape[0]] for x in g_p])
        faults[which] = max(errs.values())
        check(faults[which] > TOL, f"{tag}: the {which} fault rejected (worst leaf {faults[which]})")
    emit({"phase": "train_fault_probe", "shape": "transformer32", "worst_leaf_rel_norm": faults})
    _, again = chunked_train_grads(spec.loss_ring, params, cfg, state, rows, chunk_of(cfg))
    check(all(torch.equal(a, b) for a, b in zip(g_k16, again)), f"{tag} deterministic (two runs)")
    del g_k, g_p, g_k16, g_p16, again
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms = cuda_time_ms(lambda: chunked_train_grads(spec.loss_ring, params, cfg, state, rows,
                                                  chunk_of(cfg)), 2, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: [spec.loss_ring(
            tt.tree_map(lambda x: x[lo:lo + chunk_of(cfg)], params), cfg,
            type(state)(*(x[lo:lo + chunk_of(cfg)] for x in state)))
            for lo in range(0, t, chunk_of(cfg))], 2, 1)
    plain_ms = cuda_time_ms(lambda: chunked_train_grads(
        plain_loss(tt.TRAIN_PLAIN_OPS), params, cfg, state, rows, plain_chunk, sub), 1, 1)
    flops = 3.0 * t * s * spec.flops_per_row(cfg, WINDOW)
    tokens = t * s * (WINDOW - 1)
    saved = tokens * cfg.dim * 2 * 16 * cfg.depth
    rec = dict(ms=ms, forward_ms=fwd_ms, backward_ms=ms - fwd_ms, chunk_slots=chunk_of(cfg),
               chunks=-(-t // chunk_of(cfg)), peak_bytes=peak, bytes_before=base,
               plain_ms_slots=plain_ms, plain_slots=plain_slots, flops=flops,
               **_bound(t * s * (WINDOW * 4 + 8), flops, BF16_FLOPS),
               saved_activation_bytes=saved, saved_traffic_ms=2 * saved / HBM_BYTES_PER_S * 1e3,
               share_of_bf16_peak=flops / (ms / 1e3) / BF16_FLOPS, f32_loss_max_abs_err=loss_err,
               f32_grad_worst_ratio=max(v for n, v in f32_worst.items() if not n.endswith("wk/b")),
               rows=t * s, live_rows=int(rows.sum()))
    emit({"phase": "train_step", "shape": "transformer32", "dtype": cfg.dtype, **rec})
    one = chunk_of(cfg)  # one chunk's forward and backward, by kernel
    profile_run(f"transformer32 train step, one chunk of {one} slots",
                lambda: chunked_train_grads(spec.loss_ring, params, cfg, state, rows, one,
                                            range(0, one)))
    del state, rows
    torch.cuda.empty_cache()
    return rec


def adam_phase(dev, params) -> dict:
    """KO against adam_update_plain over five steps at tenants32's LSTM-AD
    stack (32 slots, mixed masks, per-slot lr): every element within one
    f32 ulp (bitwise but for the plain version's float64 FMA emulation);
    the library yardstick is torch.optim.Adam(fused=True).step() over the
    same leaves at one lr."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.ops import adam

    t = next(iter(params.values()))["w"].shape[0]
    pk, pp = tc.tree_map(torch.clone, params), tc.tree_map(torch.clone, params)
    sk, sp = adam.init_adam(pk, t), adam.init_adam(pp, t)
    gen = torch.Generator(device=dev).manual_seed(41)
    lr = 1e-3 * (1 + torch.arange(t, device=dev, dtype=torch.float32) % 4)
    worst, differing, max_abs = 0, 0, 0.0
    for i in range(5):
        grads = tc.tree_map(lambda x: torch.randn(x.shape, generator=gen, device=dev)
                            * 10.0 ** (4 * torch.rand(x.shape, generator=gen, device=dev) - 5), pk)
        mask = (torch.arange(t, device=dev) + i) % 5 != 0
        adam.adam_update(pk, grads, sk, lr, mask)
        adam.adam_update_plain(pp, grads, sp, lr, mask)
        torch.cuda.synchronize()
        for a, b in zip(tc.tree_leaves((pk, sk.mu, sk.nu)), tc.tree_leaves((pp, sp.mu, sp.nu))):
            d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
            worst = max(worst, int(d.max()))
            differing += int((d > 0).sum())
            max_abs = max(max_abs, float((a - b).abs().max()))
        check(torch.equal(sk.count, sp.count), "KO count bitwise")
    check(worst <= 1, f"KO within one f32 ulp of its plain version (worst {worst} ulps)")
    n = sum(x.numel() for x in tc.tree_leaves(params))
    # the launch alone (the kernel's time), and the wrapper (its checks,
    # the count increment and bias corrections, the leaf table: what a
    # train step pays)
    leaves = list(zip(*(tc.tree_leaves(x) for x in (pk, grads, sk.mu, sk.nu))))
    inc = adam.safe_increment(sk.count)
    bc1, bc2 = adam.bias_corrections(inc)
    ms = cuda_time_ms(lambda: adam.launch_ko(leaves, sk.count, inc, bc1, bc2, lr, mask), 50)
    wrapper_ms = cuda_time_ms(lambda: adam.adam_update(pk, grads, sk, lr, mask), 50)
    plain_ms = cuda_time_ms(lambda: adam.adam_update_plain(pp, grads, sp, lr, mask), 5, 1)
    leaves = [x.detach().clone().requires_grad_(True) for x in tc.tree_leaves(params)]
    for x, g in zip(leaves, tc.tree_leaves(grads)):
        x.grad = g.clone()
    fused = torch.optim.Adam(leaves, lr=1e-3, fused=True)
    lib_ms = cuda_time_ms(fused.step, 50)
    rec = dict(max_abs_err=max_abs, max_ulps=worst, elements_differing=differing, ms=ms,
               wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               **_bound(n * 28, 0.0, BF16_FLOPS), library_ms=lib_ms,
               library="torch.optim.Adam(fused=True).step(), one lr", elements=n)
    emit({"phase": "kernel", "shape": "tenants32", "name": "adam_update", **rec})
    return rec


def _lstm_loss_forget_fault(params, cfg, windows):
    """LSTM-AD's plain loss with a faulted backward: the forget gate's
    derivative taken at f instead of f + 1 (the forward unchanged)."""
    import torch

    from sitewhere_tpu_torch.models import common as tc

    dtype = cfg.compute_dtype
    normed, _, _ = tc.normalize_windows(windows)
    xs = normed[..., :-1].to(dtype)
    s_, b, steps = xs.shape
    wx = tc.kernel_weight(params["wx"], dtype)
    wh = tc.kernel_weight(params["wh"], dtype)
    bias = (params["wx"]["b"] + params["wh"]["b"]).to(dtype)
    hid = params["wh"]["w"].shape[-2]
    h = torch.zeros((s_, b, hid), dtype=dtype, device=xs.device)
    c = torch.zeros_like(h)
    preds = []
    w_head = tc.kernel_weight(params["head"], dtype)
    b_head = params["head"]["b"].to(dtype)
    for step in range(steps):
        gates = xs[:, :, step, None] * wx[:, 0][:, None, :] + torch.bmm(h, wh) + bias[:, None, :]
        i, f, g, o = torch.split(gates, hid, dim=-1)
        sf = tc.sigmoid(f + 1.0).detach() + tc.sigmoid(f) - tc.sigmoid(f).detach()
        c = sf * c + tc.sigmoid(i) * torch.tanh(g)
        h = tc.sigmoid(o) * torch.tanh(c)
        preds.append((torch.bmm(h, w_head)[..., 0] + b_head).to(torch.float32))
    targets = torch.movedim(normed[..., 1:], -1, 0)
    return torch.mean((torch.stack(preds) - targets) ** 2, dim=0)


def _deepar_loss_softplus_fault(params, cfg, windows):
    """DeepAR's plain loss with a faulted backward: the NLL's gradient
    through sigma = softplus(raw) + 1e-4 without softplus' derivative."""
    from sitewhere_tpu_torch.models import deepar as td

    real = td.softplus
    td.softplus = lambda x: x + (real(x) - x).detach()
    try:
        return td.loss_stacked_plain(params, cfg, windows)
    finally:
        td.softplus = real


def train_fault_probe(spec, cfg, params, phase: dict) -> dict:
    """The bf16 gradient check's positive control: a plain twin with a
    faulted backward (LSTM-AD: the forget bias's +1 dropped from the gate's
    derivative; DeepAR: softplus' derivative dropped from the NLL's) must
    fail the 2e-2 relative-norm bar against the f32 plain gradient on some
    leaf."""
    fault = _lstm_loss_forget_fault if spec.name == "lstm_ad" else _deepar_loss_softplus_fault
    _, g = plain_train_grads(spec, params, cfg, phase["state"], phase["rows"], loss_fn=fault)
    errs = {n: rel_norm(a, want) for n, a, want in zip(leaf_names(params), g, phase["g_p32"])}
    emit({"phase": "train_fault_probe", "family": spec.name, "fault": fault.__name__,
          "rel_norm_vs_f32": errs})
    check(max(errs.values()) > TOL,
          f"the bf16 gradient check rejects {fault.__name__} ({errs})")
    return errs


# -- K3'c's training half: KB's and KR's wide forms ----------------------------------

# (family, shape, hidden, window, slots, streams a slot, fault): main path
# m's two shapes on 2 slots of their 8,192 streams (the kernels line's
# records; the plain version's autograd memory bounds the slots), a window
# past 128 at hidden 64 (the templated KB, whose tiles still hold it), and
# widths that are no multiple of 8 or 32
WIDE_TRAIN = (("lstm_ad", "tenants32", 128, 256, 2, 8192, True),
              ("deepar", "forecasting32", 40, 192, 2, 8192, True),
              ("lstm_ad", "tenants32", 64, 256, 2, 2048, False),
              ("lstm_ad", "tenants32", 100, 140, 2, 2048, False),
              ("deepar", "forecasting32", 12, 140, 2, 2048, False))
# main path m's train-lane steps (the kernel scorer at the full plane)
WIDE_LANE_STEPS = 3
# rows of every slot the plain version differentiates at once
PLAIN_ROWS = 4096


def train_kernel(family: str, hidden: int, w: int) -> str:
    """The kernel KB or KR's route sends a shape to: the templated form's
    name or its wide or global form's (``models.flush.train_route``)."""
    from sitewhere_tpu_torch.models import deepar, lstm_ad
    from sitewhere_tpu_torch.models.flush import train_route

    form = lstm_ad.KB if family == "lstm_ad" else deepar.KR
    route, _ = train_route(form, hidden, w)
    return form.name if route == "block" else f"{form.name}_{route}"


def row_chunked_grads(loss, params, cfg, state, rows, chunk: int = PLAIN_ROWS):
    """Per-row loss and the gradient of the masked per-slot mean,
    ``chunk`` streams of every slot at a time: each chunk's rows over the
    slot's whole row count, so the chunks' gradients sum to the plane's,
    and autograd holds one chunk's activations (a 256-sample window at
    8,192 streams would not fit). ``loss(p, cfg, ring)`` as
    ``chunked_train_grads``'. Leaves in tree order."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.ops.windows import WindowState

    denom = torch.clamp_min(rows.sum(-1), 1.0)
    per_row, grads = [], None
    for lo in range(0, rows.shape[1], chunk):
        sl = slice(lo, min(lo + chunk, rows.shape[1]))
        ring = WindowState(*(x[:, sl].contiguous() for x in state))
        out = {}

        def obj(p):
            out["per_row"] = loss(p, cfg, ring)
            return ((out["per_row"] * rows[:, sl]).sum(-1) / denom).sum()

        _, g = tc.value_and_grad(obj, params)
        per_row.append(out["per_row"].detach())
        parts = tc.tree_leaves(g)
        grads = parts if grads is None else [a + b for a, b in zip(grads, parts)]
    return torch.cat(per_row, 1), grads


def bf16_bar(spec, family: str, hid: int, params, dev, t: int, s: int, seed: int,
             plain_rows: int = PLAIN_ROWS):
    """The bf16 gradient bar of the train forms at any window, per leaf:
    max(2e-2, 1.25x the kernel's own relative-norm error against the f32
    plain gradient at the templated window ``WINDOW``, on the same weights
    and ``t`` x ``s`` streams of random walks; the plain version
    ``plain_rows`` streams at a time). -> (bar, that error)."""
    from sitewhere_tpu_torch.models import make_config
    from sitewhere_tpu_torch.models import train as tr

    cfg = make_config(family, {"hidden": hid, "window": WINDOW})
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    state = train_rings(dev, t, s, 43 + hid + seed, WINDOW)
    rows = train_rows(state)
    _, g16 = kernel_train_grads(spec, params, cfg, state, rows)
    _, g32 = row_chunked_grads(lambda p, c, r: spec.loss_stacked_plain(p, c, tr.ring_windows(r)),
                               params, cfg32, state, rows, plain_rows)
    err = {n: rel_norm(a, b) for n, a, b in zip(leaf_names(params), g16, g32)}
    return {n: max(TOL, 1.25 * e) for n, e in err.items()}, err


def wide_train_phase(dev, family: str, shape: str, hid: int, w: int, t: int, s: int,
                     fault: bool, seed: int, bad=None, plain_rows: int = PLAIN_ROWS,
                     iters: int = 3) -> dict:
    """KB or KR at hidden ``hid`` and window ``w``, the form its route
    gives (``train_kernel``), on ``t`` slots of ``s`` random-walk streams
    with default-init weights, held against the plain version under
    autograd (``row_chunked_grads``): f32 compute per element (loss rtol
    1e-5 / atol 1e-6 on the trained rows, gradients rtol 1e-4 / atol 1e-5,
    ``tests/test_train_lane.py:119-124``) in ring mode, windows mode on the
    same windows bitwise ring mode; bf16 compute by each leaf's
    relative-norm error against the f32 plain gradient, at most
    ``bf16_bar`` (max(2e-2, 1.25x the kernel's own error at window 32)),
    both modes; two runs bitwise. With ``fault``, the family's faulted
    plain twin (``_lstm_loss_forget_fault``, ``_deepar_loss_softplus_fault``)
    at f32 compute shown failing the f32 per-element bar and the bf16 bar
    (its relative-norm error against the f32 gradient past it on some
    leaf); ``bad``, a plain loss ``(params, cfg, windows)``, replaces that
    fault (the global forms': ``truncated_dot``). The plain version
    differentiates ``plain_rows`` streams of every slot at once. Timed with
    CUDA events over ``iters`` calls: forward and backward apart (the
    backward's time the whole step's less the forward's), the dWh bmm, the
    plain version; bound by operations (3x the forward's FLOPs at the bf16
    peak)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import deepar as td
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.models import lstm_ad as tl
    from sitewhere_tpu_torch.models import train as tr

    spec = get_model(family)
    cfg = make_config(family, {"hidden": hid, "window": w})  # bf16 compute
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    kform = tl.KB if family == "lstm_ad" else td.KR
    name = train_kernel(family, hid, w)
    tag = f"{shape} {name}[h{hid}] w{w} {t}x{s}"
    params = stacked_trees(spec, cfg, dev, t, 110 + hid + w + seed)
    state = train_rings(dev, t, s, 41 + hid + seed, w)
    rows = train_rows(state)
    live = rows > 0
    names = leaf_names(params)

    def plain(p, c, r):
        return spec.loss_stacked_plain(p, c, tr.ring_windows(r))

    def windows_mode(c):
        wins = tr.ring_windows(state)
        return tc.tree_leaves(tc.value_and_grad(
            lambda p: _masked_mean(spec.loss_stacked(p, c, wins), rows), params)[1])

    kernels.reset_launches()
    loss_k, g_k = kernel_train_grads(spec, params, cfg32, state, rows)
    torch.cuda.synchronize()
    check(kernels.variant_launches() == {f"{name}[h{hid}]": 2},
          f"{tag}: the route launched {name} (forward, backward)")
    loss_p, g_p32 = row_chunked_grads(plain, params, cfg32, state, rows, plain_rows)
    loss_err = float((loss_k - loss_p)[live].abs().max())
    check(bool(torch.isfinite(loss_k).all()), f"{tag} finite loss")
    check(bool(torch.allclose(loss_k[live], loss_p[live], rtol=1e-5, atol=1e-6)),
          f"{tag} f32 loss per trained row (max abs err {loss_err})")
    grad_err, ratio = {}, {}
    for n, a, b in zip(names, g_k, g_p32):
        grad_err[n] = float((a - b).abs().max())
        ratio[n] = float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
        check(bool(torch.isfinite(a).all()), f"{tag} f32 grad {n} finite")
        check(ratio[n] <= 1.0, f"{tag} f32 grad {n} per element at rtol 1e-4, atol 1e-5 "
                               f"(worst ratio to the bar {ratio[n]})")
    check(all(torch.equal(a, b) for a, b in zip(g_k, windows_mode(cfg32))),
          f"{tag}: windows mode bitwise ring mode on the same windows (f32)")
    _, g_k16 = kernel_train_grads(spec, params, cfg, state, rows)
    _, g_p16 = row_chunked_grads(plain, params, cfg, state, rows, plain_rows)
    bf16 = {n: (rel_norm(a, want), rel_norm(b, want))
            for n, a, b, want in zip(names, g_k16, g_p16, g_p32)}
    # the bf16 bar: max(2e-2, 1.25x the kernel's own error at the templated
    # window (WINDOW samples, the same weights, rings of the same streams).
    # The plain bf16 version's error grows with the window (its backward
    # rounds to bf16 at every one of w - 1 steps: 9-13% at 255) and would
    # pass a faulted backward; the kernels' (f32 backward on bf16 saves)
    # does not, so their error where the window is short sets the bar
    bar, short_err = bf16_bar(spec, family, hid, params, dev, t, s, seed, plain_rows)
    for n, (k_err, p_err) in bf16.items():
        check(k_err <= bar[n],
              f"{tag} bf16 grad {n}: kernel {k_err} vs f32 within max({TOL}, 1.25 x the "
              f"kernel's own {short_err[n]} at window {WINDOW}) (the plain's {p_err})")
    check(all(torch.equal(a, b) for a, b in zip(g_k16, windows_mode(cfg))),
          f"{tag}: windows mode bitwise ring mode on the same windows (bf16)")
    _, again = kernel_train_grads(spec, params, cfg, state, rows)
    check(all(torch.equal(a, b) for a, b in zip(g_k16, again)),
          f"{tag} deterministic (two runs, same bits)")
    emit({"phase": "train_bf16_grads", "shape": shape, "name": name, "variant": f"h{hid}",
          "window": w, "rel_norm_vs_f32_kernel_plain": bf16,
          "kernel_rel_norm_at_window": {WINDOW: short_err}, "bar": bar})
    rec = {"bf16_bar": bar}
    if fault:
        given = bad is not None
        bad = bad or (_lstm_loss_forget_fault if family == "lstm_ad"
                      else _deepar_loss_softplus_fault)
        _, g_f = row_chunked_grads(lambda p, c, r: bad(p, c, tr.ring_windows(r)), params,
                                   cfg32, state, rows, plain_rows)
        f_ratio = {n: float(((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
                   for n, a, b in zip(names, g_f, g_p32)}
        f_rel = {n: rel_norm(a, b) for n, a, b in zip(names, g_f, g_p32)}
        emit({"phase": "train_fault_probe", "family": family, "fault": bad.__name__,
              "shape": tag, "f32_worst_ratio_to_bar": f_ratio, "rel_norm_vs_f32": f_rel,
              "bf16_bar": bar,
              "old_bf16_bar": {n: max(TOL, 1.25 * p) for n, (_, p) in bf16.items()}})
        check(max(f_ratio.values()) > 1.0,
              f"{tag}: the f32 per-element bar rejects {bad.__name__} ({f_ratio})")
        rec["fault_f32_worst_ratio_to_bar"] = max(f_ratio.values())
        rec["fault_rejected_by_bf16_bar"] = any(f_rel[n] > bar[n] for n in names)
        rec["fault_rejected_by_old_bf16_bar"] = any(
            f_rel[n] > max(TOL, 1.25 * bf16[n][1]) for n in names)
        # the family's own faults are shown failing the bf16 bar too; a
        # truncated dot one unit past the wide cap moves one row of wh's
        # gradient, which only the f32 bar is shown to see
        check(rec["fault_rejected_by_bf16_bar"] or given,
              f"{tag}: the bf16 bar rejects {bad.__name__} ({f_rel} vs {bar})")
        del g_f
    weights = [params[a][b] for a, b in kform.leaves]
    ms = cuda_time_ms(lambda: kernel_train_grads(spec, params, cfg, state, rows), iters, 1)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: tr.TrainLoss.apply(kform, cfg, state, None, *weights),
                              iters, 1)
    g = kform.gates * hid
    hp = torch.randn((t, w - 2, s, hid), device=dev).to(torch.bfloat16)
    dg = torch.randn((t, w - 2, s, g), device=dev).to(torch.bfloat16)
    bmm_ms = cuda_time_ms(lambda: torch.stack([
        torch.bmm(hp[i].transpose(1, 2), dg[i]).sum(0, dtype=torch.float32)
        for i in range(t)]), 5, 1)
    del hp, dg
    plain_ms = cuda_time_ms(lambda: row_chunked_grads(plain, params, cfg, state, rows,
                                                      plain_rows), 1, 0)
    flops = 3.0 * t * s * spec.flops_per_row(cfg, w)
    n_params = sum(v.numel() for n_ in params.values() for v in n_.values())
    nbytes = t * s * (w * 4 + 8) + 2 * n_params * 4
    rec.update(shape=f"{shape} h{hid} w{w}, {t} x {s} rows", variant=f"h{hid}", window=w,
               max_abs_err=max(grad_err.values()), f32_grad_max_abs_err=grad_err,
               f32_loss_max_abs_err=loss_err, ms=ms, forward_ms=fwd_ms, backward_ms=ms - fwd_ms,
               dwh_bmm_ms=bmm_ms, plain_ms=plain_ms, **_bound(nbytes, flops, BF16_FLOPS),
               library_ms=None,
               library="none (no one call: cuDNN's LSTM/GRU has neither the forget +1 "
                       "nor per-slot weights)",
               flops=flops, rows=t * s, live_rows=int(rows.sum()),
               train_bytes_per_row=tr.train_bytes_per_row(kform, cfg, w),
               route=tr.train_route(kform, hid, w))
    emit({"phase": "kernel", "name": name, **rec})
    return dict(rec, name=name)


def wide_train_records(recs: list) -> dict:
    """The wide train forms' kernel-line records: main path m's shape
    first (``WIDE_TRAIN``'s order), the rest under ``shapes``; and the
    templated forms' shapes past window 128."""
    out = {}
    for rec in recs:
        name = rec["name"]
        if name in out:
            out[name]["shapes"].append(rec)
        else:
            out[name] = dict(rec, shapes=[])
    return out


# -- phase 3f: the ViT's train form (config 5's batch, full width) ------------------

# the ViT's train kernels (their records: shape vit_b16_train)
VIT_TRAIN_KERNELS = ("vit_head_train", "vit_embed_bwd")


def vit_train_inputs(dev, x_u8, seed: int):
    """Config 5's 64 camera frames normalized as the u8 wire does
    (f32[64, 224, 224, 3]) and their labels, uniform over the 1,000
    classes from ``seed``."""
    import torch

    from sitewhere_tpu_torch.models import vit as tv

    images = (x_u8.float() / 255.0 - 0.5) / 0.5
    labels = np.random.default_rng(70 + seed).integers(0, tv.VIT_B16.num_classes, x_u8.shape[0])
    labels = labels.astype(np.int32)
    return images, torch.from_numpy(labels).to(dev)


def _f32_elem_ratio(a, b) -> float:
    """The ViT's f32 gradient bar, per element: |a - b| <= 1e-4 |b| + 1e-5
    max |b|; returns the worst ratio to it (<= 1 passes)."""
    atol = 1e-5 * float(b.abs().max())
    return float(((a - b).abs() / (atol + 1e-4 * b.abs()).clamp_min(1e-30)).max())


def vit_train_kernel_phase(dev, params, images, labels) -> dict:
    """The ViT's train kernels at the shapes its train step gives them
    (config 5: 64 frames x 197 tokens, dim 768, 12 heads of 64, fc1 3,072
    wide, 1,000 classes): KT's train mode (forward and backward), KV's
    backward, and the blocks' KA, KL and KU backward kernels, each against its
    plain version at bf16 (relative norm within 1e-2) and f32 (per element,
    the f32 gradient bar) on seeded inputs (KT on the real frames' final
    residual stream), two runs bitwise; timed at bf16 beside its bound and,
    where one PyTorch call computes the same function (SDPA's, LayerNorm's
    and tanh GELU's backward, ``dx.sum(0)`` for d pos), that call."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv

    cfg = tv.VIT_B16
    b, t, d, heads, c = images.shape[0], cfg.num_patches + 1, cfg.dim, cfg.heads, cfg.num_classes
    f, rows = 4 * d, b * t
    hd = d // heads
    gen = torch.Generator(device=dev).manual_seed(19)
    out = {}

    def rnd(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def held(tag, got, want, dtype):
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{tag} finite")
        if dtype == torch.float32:
            worst = _f32_grad_ratio(got, want)
            check(worst <= 1.0, f"{tag} f32 per element (worst ratio to the bar {worst})")
        else:
            err = rel_norm(got, want)
            check(err <= 1e-2, f"{tag} bf16 within 1e-2 relative norm ({err})")
        return float((got - want).abs().max())

    def twice(tag, fn, first):
        check(all(torch.equal(a, z) for a, z in zip(first, fn())), f"{tag} bitwise twice")

    one = tc.tree_map(lambda a: a[None], params["blocks"])
    for dtype in (torch.float32, torch.bfloat16):
        elt = 2 if dtype == torch.bfloat16 else 4
        tag = f"vit_b16_train {str(dtype)[6:]}"
        cfg_d = dataclasses.replace(cfg, dtype=str(dtype)[6:])
        # KT's train mode on the real frames' final residual stream
        x = tv.vit_embed(torch.matmul(tv.frame_patches(images, cfg.patch_size, dtype),
                                      params["patch"]["w"].to(dtype)),
                         params["patch"]["b"], params["cls"], params["pos"])
        h = tc.blocks_stacked(one, x[None], heads, False, dtype, tv.KERNEL_OPS)[0]
        del x
        head = (h, params["ln_f"], params["head"], labels)
        lk, logits = tv.vit_head_train(*head)
        lp, logits_p = tv.vit_head_train_plain(*head)
        tol = TOL if dtype == torch.bfloat16 else TF32_TOL
        err_f = max(_held(f"{tag} KT train logits", logits, logits_p, tol),
                    _held(f"{tag} KT train loss", lk, lp, tol))
        g = torch.tensor(1.0, device=dev)
        got = tv.vit_head_train_bwd(*head, logits_p, g)
        want = tv.vit_head_train_bwd_plain(*head, logits_p, g)
        check(not bool(got[0][:, 1:].any()), f"{tag} KT train backward: dh 0 past the [CLS] rows")
        err = max([err_f] + [held(f"{tag} KT train backward {n}", a, w, dtype) for n, a, w in
                             zip(("dh", "dhead_w", "dhead_b", "dlnf_scale", "dlnf_bias"), got,
                                 want)])
        twice(f"{tag} KT train backward", lambda: tv.vit_head_train_bwd(*head, logits_p, g), got)
        if dtype == torch.bfloat16:
            fwd_ms = cuda_time_ms(lambda: tv.vit_head_train(*head), 20)
            bwd_ms = cuda_time_ms(lambda: tv.vit_head_train_bwd(*head, logits, g), 20)
            out["vit_head_train"] = dict(
                max_abs_err=err, ms=fwd_ms + bwd_ms, forward_ms=fwd_ms, backward_ms=bwd_ms,
                plain_ms=cuda_time_ms(lambda: tv.vit_head_train_bwd_plain(
                    *head, tv.vit_head_train_plain(*head)[1], g), 3, 1),
                library_ms=None, library="none (no one call: ln_f, the head and the NLL)",
                # forward: the [CLS] rows, the f32 head, logits out; backward:
                # the [CLS] rows, head and logits in, dh (every row) and the
                # head's gradients out; the head's products at the tensor
                # cores' rate, the rest f32
                **_bound(2 * b * d * elt + 2 * (2 * d + d * c + c) * 4 + 2 * b * c * 4
                         + b * t * d * elt + (d * c + c + 2 * d) * 4,
                         3 * 2.0 * b * d * c, BF16_FLOPS, b * (30.0 * d + 20.0 * c)))
        del head, h, got, want, logits, logits_p
        # KV's backward on the tokens' cotangent
        dx = rnd((b, t, d), dtype)
        got, want = tv.vit_embed_bwd(dx), tv.vit_embed_bwd_plain(dx)
        err = max(held(f"{tag} KV backward {n}", a, w, dtype)
                  for n, a, w in zip(("dpos", "dcls", "dpatch_b"), got, want))
        twice(f"{tag} KV backward", lambda: tv.vit_embed_bwd(dx), got)
        if dtype == torch.bfloat16:
            out["vit_embed_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tv.vit_embed_bwd(dx), 50),
                plain_ms=cuda_time_ms(lambda: tv.vit_embed_bwd_plain(dx), 5, 1),
                library_ms=cuda_time_ms(lambda: dx.sum(0), 50),
                library_call="dx.sum(0) (d pos alone)",
                **_bound(dx.numel() * elt + (t * d + 2 * d) * 4, 1.0 * dx.numel(), F32_FLOPS))
        del dx, got, want
        # KA's backward, non-causal at T 197
        q, k, v, do = (rnd((b, t, d), dtype, 1.5) for _ in range(4))
        got = tc.attention_bwd(q, k, v, do, heads, False)
        want = tc.attention_bwd_plain(q, k, v, do, heads, False)
        err = max(held(f"{tag} KA backward {n}", a, w, dtype)
                  for n, a, w in zip(("dq", "dk", "dv"), got, want))
        twice(f"{tag} KA backward", lambda: tc.attention_bwd(q, k, v, do, heads, False), got)
        del got, want
        if dtype == torch.bfloat16:
            qh, kh, vh = (z.view(b, t, heads, hd).transpose(1, 2).detach().requires_grad_(True)
                          for z in (q, k, v))
            o = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.view(b, t, heads, hd).transpose(1, 2)
            out["attention_bwd"] = dict(
                max_abs_err=err,
                ms=cuda_time_ms(lambda: tc.attention_bwd(q, k, v, do, heads, False), 5),
                plain_ms=cuda_time_ms(lambda: tc.attention_bwd_plain(q, k, v, do, heads, False),
                                      2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    o, (qh, kh, vh), doh, retain_graph=True), 5),
                library_call="scaled_dot_product_attention's backward (autograd.grad)",
                **_bound(7 * b * t * d * elt, 5 * 2.0 * t * t * hd * heads * b, BF16_FLOPS),
                dims=[b, t, heads, hd], causal=False)
            del qh, kh, vh, o, doh
        del q, k, v, do
        # KL's backward (ln1 of a block: the frames' tokens, one slot)
        x, dy = rnd((rows, d), dtype, 2.0, 0.5), rnd((rows, d), dtype)
        sc = 1 + 0.2 * torch.randn((1, d), generator=gen, device=dev)
        got, want = tc.layernorm_bwd(x, sc, dy, rows), tc.layernorm_bwd_plain(x, sc, dy, rows)
        err = max(held(f"{tag} KL backward {n}", a, w, dtype)
                  for n, a, w in zip(("dx", "dscale", "dbias"), got, want))
        twice(f"{tag} KL backward", lambda: tc.layernorm_bwd(x, sc, dy, rows), got)
        if dtype == torch.bfloat16:
            xl = x.detach().requires_grad_(True)
            wl = sc[0].detach().requires_grad_(True)
            bl = torch.zeros_like(wl, requires_grad=True)
            yl = F.layer_norm(xl, (d,), wl.to(dtype), bl.to(dtype))
            out["layernorm_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tc.layernorm_bwd(x, sc, dy, rows), 10),
                plain_ms=cuda_time_ms(lambda: tc.layernorm_bwd_plain(x, sc, dy, rows), 2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    yl, (xl, wl, bl), dy, retain_graph=True), 10),
                library_call="F.layer_norm's backward (autograd.grad)",
                **_bound(3 * rows * d * elt + 3 * d * 4, 25.0 * rows * d, F32_FLOPS))
            del xl, wl, bl, yl
        del x, dy, got, want
        # KU's backward (fc1's product and the GELU's cotangent)
        x, dy = rnd((rows, f), dtype), rnd((rows, f), dtype, 0.1)
        bb = 0.1 * torch.randn((1, f), generator=gen, device=dev)
        got, want = tc.bias_gelu_bwd(x, bb, dy, rows), tc.bias_gelu_bwd_plain(x, bb, dy, rows)
        err = max(held(f"{tag} KU backward {n}", a, w, dtype)
                  for n, a, w in zip(("dx", "db"), got, want))
        twice(f"{tag} KU backward", lambda: tc.bias_gelu_bwd(x, bb, dy, rows), got)
        del got, want
        if dtype == torch.bfloat16:
            xg = x.detach().requires_grad_(True)
            bg = bb.to(dtype).detach().requires_grad_(True)
            yg = F.gelu(xg + bg, approximate="tanh")
            out["bias_gelu_bwd"] = dict(
                max_abs_err=err, ms=cuda_time_ms(lambda: tc.bias_gelu_bwd(x, bb, dy, rows), 5),
                plain_ms=cuda_time_ms(lambda: tc.bias_gelu_bwd_plain(x, bb, dy, rows), 2, 1),
                library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    yg, (xg, bg), dy, retain_graph=True), 5),
                library_call="F.gelu(x + b, approximate='tanh')'s backward (autograd.grad)",
                **_bound(3 * rows * f * elt + 2 * f * 4, 35.0 * rows * f, F32_FLOPS))
            del xg, bg, yg
        del x, dy
        torch.cuda.empty_cache()
    for name, rec in out.items():
        emit({"phase": "kernel", "shape": "vit_b16_train", "name": name, **rec})
    return out


def _vit_grads(loss_fn, params, cfg, images, labels):
    """(loss, gradient leaves in tree order) of ``loss_fn(p, cfg, images,
    labels)``."""
    from sitewhere_tpu_torch.models import common as tc

    val, g = tc.value_and_grad(lambda p: loss_fn(p, cfg, images, labels), params)
    return val, tc.tree_leaves(g)


def vit_train_step_phase(dev, params, images, labels) -> dict:
    """The ViT's train step at full width (64 frames, bf16 and f32 compute):
    the kernel path (``models.vit.loss`` under autograd, then KO) against
    the plain twin (``loss_plain``). f32: the loss within 2e-4 relative,
    the gradients per element at rtol 1e-4 / atol 1e-5 max|g|, and where a
    leaf misses, the kernel's gradient as accurate as the twin's against a
    float64 plain run on 8 frames; bf16: each leaf's relative-norm error
    against the f32 plain gradient within 2e-2, or 1.25x the plain bf16
    gradient's own where that is larger; the three faulted plain twins
    (``faulted_vit_train_ops``, f32) rejected by that bar; two kernel runs
    bitwise; KO (one C call over the tree) within one f32 ulp of its plain
    version on the same gradients.
    Records the step's time (forward, backward, Adam), its peak memory and
    its share of the bf16 peak."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.models.common import vit_flops_per_image
    from sitewhere_tpu_torch.ops import adam

    cfg = tv.VIT_B16
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tag = "vit_b16 train step"
    names = leaf_names(params)
    lk, g_k = _vit_grads(tv.loss, params, cfg32, images, labels)
    lp, g_p = _vit_grads(tv.loss_plain, params, cfg32, images, labels)
    torch.cuda.synchronize()
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(bool(torch.isfinite(lk)), f"{tag} f32 finite loss")
    check(loss_rel <= TF32_TOL, f"{tag} f32 loss within 2e-4 of the twin ({loss_rel})")
    worst = {n: _f32_elem_ratio(a, b) for n, a, b in zip(names, g_k, g_p)}
    missed = [n for n in names if worst[n] > 1.0 and not n.endswith("wk/b")]
    # a float64 plain run of 8 frames: every leaf's accuracy, kernel and twin
    sub = (images[:8], labels[:8])
    _, g_k8 = _vit_grads(tv.loss, params, cfg32, *sub)
    _, g_p8 = _vit_grads(tv.loss_plain, params, cfg32, *sub)
    c64 = types.SimpleNamespace(**dataclasses.asdict(cfg32), compute_dtype=torch.float64,
                                num_patches=cfg.num_patches)
    _, g64 = _vit_grads(tv.loss_plain, params, c64, *sub)
    vs64 = {n: (rel_norm(a, r), rel_norm(b, r)) for n, a, b, r in zip(names, g_k8, g_p8, g64)}
    del g_k8, g_p8, g64
    emit({"phase": "train_f32", "shape": "vit_b16", "loss": float(lk), "loss_rel_err": loss_rel,
          "grad_worst_ratio_to_bar": worst, "missed_per_element": missed,
          "rel_norm_vs_f64_8_frames_kernel_plain": vs64})
    for n, a in zip(names, g_k):
        check(bool(torch.isfinite(a).all()), f"{tag} f32 grad {n} finite")
    for n in missed:
        check(vs64[n][0] <= 1.25 * vs64[n][1] + 1e-6,
              f"{tag} f32 grad {n} misses per element ({worst[n]}) and is less accurate than the "
              f"plain version's vs float64 {vs64[n]}")
    _, g_k16 = _vit_grads(tv.loss, params, cfg, images, labels)
    _, g_p16 = _vit_grads(tv.loss_plain, params, cfg, images, labels)
    err_k, err_p = tf_bf16_errors(names, g_k16, g_p), tf_bf16_errors(names, g_p16, g_p)
    emit({"phase": "train_bf16_grads", "shape": "vit_b16", "rel_norm_vs_f32_kernel_plain":
          {n: (err_k[n], err_p[n]) for n in names}})
    for n in names:
        check(err_k[n] <= max(TOL, 1.25 * err_p[n]),
              f"{tag} bf16 grad {n}: kernel {err_k[n]} vs f32 (plain bf16 {err_p[n]})")
    del g_p16
    faults = {}
    for which in VIT_TRAIN_FAULTS:
        _, g_f = _vit_grads(lambda p, c, x, y: tv._train_loss(p, c, x, y, faulted_vit_train_ops(
            which)), params, cfg32, images, labels)
        faults[which] = max(tf_bf16_errors(names, g_f, g_p).values())
        check(faults[which] > TOL, f"{tag}: the {which} fault rejected (worst leaf {faults[which]})")
        del g_f
    emit({"phase": "train_fault_probe", "shape": "vit_b16", "worst_leaf_rel_norm": faults})
    _, again = _vit_grads(tv.loss, params, cfg, images, labels)
    check(all(torch.equal(a, z) for a, z in zip(g_k16, again)), f"{tag} deterministic (two runs)")
    del again, g_k, g_p
    # KO on the single tree (one C call through train_step's apply_step)
    # against its plain version, adam_update_plain, on the same gradients:
    # the tree as one slot of [1, ...] views, lr [1e-3]
    opt = adam.adam(1e-3)
    it = iter(g_k16)  # the bf16 gradients as a tree
    grads = tc.tree_map(lambda _: next(it), params)
    pk, pp = tc.tree_map(torch.clone, params), tc.tree_map(torch.clone, params)
    sk, sp = opt.init(pk), opt.init(pp)

    def one(tree):
        return tc.tree_map(lambda x: x[None], tree)

    lr1 = torch.full((1,), 1e-3, device=dev)
    mask1 = torch.ones(1, dtype=torch.bool, device=dev)
    worst_ulps, where = 0, None
    kinds = [f"{k}/{n}" for k in ("p", "mu", "nu") for n in names]
    for step in range(2):
        pk, sk = adam.apply_step(opt, pk, grads, sk)
        adam.adam_update_plain(one(pp), one(grads), adam.AdamState(
            sp[0].count.reshape(1), one(sp[0].mu), one(sp[0].nu)), lr1, mask1)
        torch.cuda.synchronize()
        for n, a, z in zip(kinds, tc.tree_leaves((pk, sk[0].mu, sk[0].nu)),
                           tc.tree_leaves((pp, sp[0].mu, sp[0].nu))):
            ulps = (a.view(torch.int32).long() - z.view(torch.int32).long()).abs()
            if int(ulps.max()) > worst_ulps:
                i = int(ulps.argmax())
                worst_ulps = int(ulps.max())
                where = dict(step=step, leaf=n, kernel=float(a.flatten()[i]),
                             plain=float(z.flatten()[i]), n_past_1=int((ulps > 1).sum()))
    emit({"phase": "adam_single_tree", "shape": "vit_b16", "max_ulps": worst_ulps, "worst": where})
    check(worst_ulps <= 1, f"{tag}: KO within one f32 ulp of its plain version ({worst_ulps} "
                           f"ulps, {where})")
    check(int(sk[0].count) == int(sp[0].count) == 2, f"{tag}: KO's count")
    adam_ms = cuda_time_ms(lambda: adam.ko_step(pk, grads, sk[0], 1e-3), 10)
    # the launch alone (the kernel's time; the wrapper above also builds the
    # 200 leaves' views and table), and one fused PyTorch Adam step over
    # the same leaves
    leaves = [tuple(x.reshape((1,) + tuple(x.shape)) for x in leaf) for leaf in zip(
        *(tc.tree_leaves(t_) for t_ in (pk, grads, sk[0].mu, sk[0].nu)))]
    cnt = sk[0].count.reshape(1)
    inc = adam.safe_increment(cnt)
    bc1, bc2 = adam.bias_corrections(inc)
    adam_kernel_ms = cuda_time_ms(lambda: adam.launch_ko(leaves, cnt, inc, bc1, bc2, lr1, mask1),
                                  10)
    lib = [x.detach().clone().requires_grad_(True) for x in tc.tree_leaves(params)]
    for x, g_ in zip(lib, tc.tree_leaves(grads)):
        x.grad = g_.clone()
    adam_library_ms = cuda_time_ms(torch.optim.Adam(lib, lr=1e-3, fused=True).step, 10)
    del leaves, lib
    adam_plain_ms = cuda_time_ms(lambda: adam.adam_update_plain(one(pp), one(grads), adam.AdamState(
        sp[0].count.reshape(1), one(sp[0].mu), one(sp[0].nu)), lr1, mask1), 2, 1)
    del pk, pp, sk, sp, grads, g_k16
    torch.cuda.empty_cache()
    # the step's time and memory (bf16)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fb_ms = cuda_time_ms(lambda: _vit_grads(tv.loss, params, cfg, images, labels), 3, 1)
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        fwd_ms = cuda_time_ms(lambda: tv.loss(params, cfg, images, labels), 3, 1)
    plain_ms = cuda_time_ms(lambda: _vit_grads(tv.loss_plain, params, cfg, images, labels), 1, 1)
    b = images.shape[0]
    flops = 3.0 * b * vit_flops_per_image(cfg)
    ms = fb_ms + adam_ms
    n_params = sum(x.numel() for x in tc.tree_leaves(params))
    rec = dict(ms=ms, forward_ms=fwd_ms, backward_ms=fb_ms - fwd_ms, adam_ms=adam_ms,
               adam_kernel_ms=adam_kernel_ms, adam_plain_ms=adam_plain_ms,
               adam_library_ms=adam_library_ms,
               adam_bound_ms=_bound(n_params * 28, 0.0, BF16_FLOPS)["bound_ms"], plain_ms=plain_ms + adam_plain_ms, frames=b,
               peak_bytes=peak, bytes_before=base, predicted_save_bytes=tv.train_bytes(cfg, b),
               flops=flops, **_bound(images.numel() * 4 + n_params * 4 * 7, flops, BF16_FLOPS),
               share_of_bf16_peak=flops / (ms / 1e3) / BF16_FLOPS, f32_loss_rel_err=loss_rel,
               f32_missed_per_element=missed, adam_max_ulps=worst_ulps,
               fault_worst_leaf=faults, params=n_params)
    emit({"phase": "train_step", "shape": "vit_b16", "dtype": cfg.dtype, **rec})
    profile_run("vit_b16 train step (loss and gradients, bf16)",
                lambda: _vit_grads(tv.loss, params, cfg, images, labels))
    torch.cuda.empty_cache()
    return rec


# -- main path i: ViT-B/16 training -----------------------------------------------------

VIT_TRAIN_STEPS = 5
# one train step's launches: the forward (KP, KV, KL x 24, KA x 12, KU x 12,
# KT's train forward), the backward (KT's train backward with ln_f's fused,
# KU, KA and KL x 24 backward, KV's backward) and KO (one C call)
VIT_TRAIN_EXPECTED = {"frame_patches": 1, "vit_embed": 1, "layernorm": 24, "attention": 12,
                      "bias_gelu": 12, "vit_head_train": 2, "bias_gelu_bwd": 12,
                      "attention_bwd": 12, "layernorm_bwd": 24, "vit_embed_bwd": 1,
                      "adam_update": 1}


class _NoPlainViT:
    """While active, every plain version the ViT's train step could reach
    raises: KP's, KV's and its backward's, KT's train mode's, the blocks'
    forward and backward kernels' and the plain Adam's arithmetic."""

    NAMES = {"vit": ("frame_patches_plain", "vit_embed_plain", "vit_embed_bwd_plain",
                     "vit_head_train_plain", "vit_head_train_bwd_plain"),
             "common": ("layernorm_rows_plain", "layernorm_bwd_plain", "attention_plain",
                        "attention_bwd_plain", "bias_gelu_plain", "bias_gelu_bwd_plain"),
             "adam": ("adam_update_plain", "_moments", "_direction")}

    @staticmethod
    def _boom(*_a, **_k):
        raise RuntimeError("a plain version ran on the kernel path")

    def _mods(self):
        from sitewhere_tpu_torch.models import common as tc
        from sitewhere_tpu_torch.models import vit as tv
        from sitewhere_tpu_torch.ops import adam

        return {"vit": tv, "common": tc, "adam": adam}

    def __enter__(self):
        self.saved = []
        for key, mod in self._mods().items():
            for n in self.NAMES[key]:
                self.saved.append((mod, n, getattr(mod, n)))
                setattr(mod, n, self._boom)
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)
        return False


def vit_train_drive(dev, params, images, labels) -> tuple:
    """The main path: ``get_model("vit_b16").train_step`` with
    ``ops.adam.adam(1e-3)``, 5 steps on config 5's 64 frames, every plain
    version set to raise; each step's launches held to the expected counts,
    the losses finite and falling on the fixed batch. Returns the launches
    and the launches by variant, summed over the steps."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops import adam

    spec, cfg = get_model("vit_b16"), tv.VIT_B16
    opt = adam.adam(1e-3)
    p = tc.tree_map(torch.clone, params)
    state = opt.init(p)
    launches, vlaunches = {name: 0 for name in kernels.KERNELS}, {}
    losses, step_ms = [], []
    want = {name: 0 for name in kernels.KERNELS}
    want.update(VIT_TRAIN_EXPECTED)
    with _NoPlainViT():
        for i in range(VIT_TRAIN_STEPS):
            kernels.reset_launches()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            p, state, loss = spec.train_step(p, state, (images, labels), cfg, opt)
            ev1.record()
            torch.cuda.synchronize()
            counts, variants = kernels.launches(), kernels.variant_launches()
            check(counts == want, f"vit_b16 train step {i}: launches {counts}")
            check(variants.get("vit_head_train[fwd]") == 1
                  and variants.get("vit_head_train[bwd]") == 1,
                  f"vit_b16 train step {i}: KT's train forward and backward once each")
            for name, n in counts.items():
                launches[name] += n
            for key, n in variants.items():
                vlaunches[key] = vlaunches.get(key, 0) + n
            losses.append(float(loss))
            step_ms.append(ev0.elapsed_time(ev1))
    check(all(np.isfinite(losses)), f"vit_b16 train: finite losses {losses}")
    check(losses[-1] < losses[0], f"vit_b16 train: the loss falls on the fixed batch {losses}")
    check(int(state[0].count) == VIT_TRAIN_STEPS, "vit_b16 train: Adam's count")
    emit({"phase": "main_path", "family": "vit_b16", "path": "train_step",
          "frames": int(images.shape[0]), "steps": VIT_TRAIN_STEPS, "lr": 1e-3,
          "losses": losses, "step_ms": step_ms, "launches_per_step": VIT_TRAIN_EXPECTED})
    return launches, vlaunches


def per_tenant_train_phase(dev) -> dict:
    """The per-tenant train forms on the card: LSTM-AD's and DeepAR's
    ``loss`` on CUDA tensors launch KB or KR over one slot and agree with
    the plain composition on the CPU at the f32 bar (2e-4); every family's
    ``train_step`` with ``adam(1e-3)`` on CUDA tensors runs its Adam as one
    KO call; a T past the staged KA backward's cap runs tiled."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.ops import adam

    rng = np.random.default_rng(21)
    out = {}
    # (family, kernel, hidden, window): hidden 16 at window 16, and since
    # K3'c's training half main path m's wide shapes (KB's, KR's wide forms)
    for family, kern, hid, w in (("lstm_ad", "lstm_train", C8_HIDDEN, 16),
                                 ("deepar", "gru_train", C8_HIDDEN, 16),
                                 ("transformer", "tf_head_train", C8_HIDDEN, 16),
                                 *((f, train_kernel(f, h, w_), h, w_)
                                   for f, _, h, w_ in WIDE_MAIN)):
        spec = get_model(family)
        cfg = make_config(family, {"hidden": hid, "window": w, "context": 32,
                                   "dtype": "float32"})
        wins = np.cumsum(rng.normal(size=(512, w)), -1).astype(np.float32)
        params = spec.init(torch.Generator().manual_seed(22), cfg, device="cpu")
        on_dev = tc.tree_map(lambda x: x.to(dev), params)
        w_dev = torch.from_numpy(wins).to(dev)
        kernels.reset_launches()
        got = spec.loss(on_dev, cfg, w_dev)
        check(kernels.launches()[kern] >= 1, f"{family}.loss on the card launched {kern}")
        want = spec.loss(params, cfg, torch.from_numpy(wins))
        rel = abs(float(got) - float(want)) / abs(float(want))
        check(rel <= TF32_TOL, f"{family}.loss on the card within 2e-4 of the plain ({rel})")
        opt = adam.adam(1e-3)
        kernels.reset_launches()
        p2, _, l2 = spec.train_step(on_dev, opt.init(on_dev), w_dev, cfg, opt)
        torch.cuda.synchronize()
        check(kernels.launches()["adam_update"] == 1 and bool(torch.isfinite(l2)),
              f"{family}.train_step on the card: one KO call")
        check(family == "transformer" or kernels.launches()[kern] == 2,
              f"{family}.train_step on the card: {kern} forward and backward")
        out[family if hid == C8_HIDDEN else f"{family} h{hid} w{w}"] = rel
    # KA's backward past the staged form's shared memory (f32 hd 64, T 210,
    # past its 209) goes to the tiled form, decided before any launch
    gen = torch.Generator(device=dev).manual_seed(23)
    q, k, v, do = (torch.randn((1, 210, 768), generator=gen, device=dev) for _ in range(4))
    kernels.reset_launches()
    got = tc.attention_bwd(q, k, v, do, 12, False)
    want = tc.attention_bwd_plain(q, k, v, do, 12, False)
    torch.cuda.synchronize()
    routed = kernels.launches()["attention_bwd"] == 0 and \
        kernels.launches()["attention_tiled_bwd"] == 1
    check(routed, "KA's backward at f32 hd 64 T 210 (past the staged form's 209) ran tiled")
    tiled_ratio = max(_f32_elem_ratio(a, b) for a, b in zip(got, want))
    check(tiled_ratio <= 1.0, f"KA's tiled backward at T 210 within the f32 bar ({tiled_ratio})")
    emit({"phase": "per_tenant_train", "loss_rel_err": out, "ka_t210_tiled": routed,
          "ka_t210_worst_ratio_to_f32_bar": tiled_ratio})
    return out


# -- phase 4: the main path ---------------------------------------------------------

# -- the transformer's train form: faulted backward twins ------------------------
#
# Each drops one term of a backward kernel's plain version; the CPU tests
# (tests/test_torch_transformer_train.py) and the train phases here show
# the bars rejecting them.

def attention_bwd_no_sigma(q, k, v, dout, heads: int, causal: bool):
    """KA's backward without the softmax's Sigma term: dl = (dp / s) e."""
    import math

    import torch

    from sitewhere_tpu_torch.models import common as tc

    dtype, wd = q.dtype, tc.wide(q.dtype)
    n, t, d = q.shape
    qh, kh, vh, oh = (tc._split_heads(a, heads) for a in (q, k, v, dout))
    e, s, mask = tc._softmax_rows(qh, kh, causal, wd)
    dv = torch.einsum("...hqk,...qhd->...khd", (e / s).to(dtype), oh)
    dp = torch.einsum("...qhd,...khd->...hqk", oh, vh).to(wd)
    dl = (dp / s) * e
    if mask is not None:
        dl = dl.masked_fill(~mask, 0.0)
    dl = (dl * (1.0 / math.sqrt(d // heads))).to(dtype)
    dq = torch.einsum("...hqk,...khd->...qhd", dl, kh)
    dk = torch.einsum("...hqk,...qhd->...khd", dl, qh)
    return tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


def bias_gelu_bwd_no_cubic(x, b, dy, rows_per_slot: int):
    """KU's backward without the derivative of GELU's cubic term."""
    from sitewhere_tpu_torch.models import common as tc

    n, f = x.shape
    y = x.reshape(-1, rows_per_slot, f) + b.to(x.dtype)[:, None, :]
    g = dy.reshape(y.shape)
    th, cdf, c, _ = tc._gelu_parts(y)
    v4 = (0.5 * (y * g)) * (1.0 - th)
    dx = g * cdf + c * (v4 + v4 * th)
    db = dx.sum(1, dtype=tc.wide(x.dtype)).to(x.dtype).to(tc.wide(x.dtype))
    return dx.reshape(n, f), db


def layernorm_bwd_no_var(x, scale, dy, rows_per_slot: int):
    """KL's backward without the mean-of-(dy x-hat) term (the variance's
    path): dx = dcd - mean(dcd)."""
    from sitewhere_tpu_torch.models import common as tc

    n, d = x.shape
    wd = tc.wide(x.dtype)
    xf = x.to(wd).reshape(-1, rows_per_slot, d)
    g = dy.to(wd).reshape(xf.shape)
    c = xf - xf.mean(-1, keepdim=True)
    r = (c * c).mean(-1, keepdim=True).add(1e-5).rsqrt()
    dcd = g * scale.to(wd)[:, None, :] * r
    dx = (dcd - dcd.mean(-1, keepdim=True)).to(x.dtype).reshape(n, d)
    return dx, ((c * r) * g).sum(1), g.sum(1)


def embed_bwd_dpos_summed(dx, normed, context: int):
    """KE's backward with d pos summed over the positions (every row of the
    table gets d embed.b) instead of per position."""
    from sitewhere_tpu_torch.models import transformer as tt

    dw, db, dpos = tt.tf_embed_bwd_plain(dx, normed, context)
    dpos[:, :dx.shape[2]] = db[:, None, :]
    return dw, db, dpos


def faulted_train_ops(which: str):
    """The transformer's plain train ops with one backward faulted:
    ``softmax`` (KA), ``gelu`` (KU), ``layernorm`` (KL) or ``dpos`` (KE)."""
    from sitewhere_tpu_torch.models import transformer as tt

    ops = tt.TRAIN_PLAIN_OPS
    if which == "dpos":
        return ops._replace(embed_bwd=embed_bwd_dpos_summed)
    field, fn = {"softmax": ("attention_bwd", attention_bwd_no_sigma),
                 "gelu": ("bias_gelu_bwd", bias_gelu_bwd_no_cubic),
                 "layernorm": ("layernorm_bwd", layernorm_bwd_no_var)}[which]
    return ops._replace(blocks=ops.blocks._replace(**{field: fn}))


TRAIN_FAULTS = ("softmax", "gelu", "layernorm", "dpos")


# -- the ViT's train form: faulted plain twins ----------------------------------------
#
# The CPU tests (tests/test_torch_vit_train.py) and the vit_train_step phase
# show the bars rejecting each.

def dlogits_no_softmax(logits, labels, g, dtype):
    """The loss's cotangent at the logits without log_softmax's term: y only."""
    import torch

    from sitewhere_tpu_torch.models import vit as tv

    b, c = logits.shape
    idx, hit = tv._label_index(labels, c)
    v = (-g.to(logits.dtype)) / b
    y = torch.zeros_like(logits).scatter_(1, idx[:, None], torch.where(hit, v, 0.0)[:, None])
    return y.to(dtype)


def vit_head_bwd_no_softmax(x, ln_f, head, labels, logits, g):
    """KT's train backward without log_softmax's term in dlogits."""
    from sitewhere_tpu_torch.models import vit as tv

    return tv.vit_head_train_bwd_plain(x, ln_f, head, labels, logits, g,
                                       dlogits=dlogits_no_softmax)


def vit_embed_bwd_dpos_summed(dx):
    """KV's backward with d pos summed over the positions (every row of the
    table gets the whole frame-and-position sum) instead of over frames."""
    from sitewhere_tpu_torch.models import vit as tv

    dpos, dcls, db = tv.vit_embed_bwd_plain(dx)
    dpos[:] = dx.to(dpos.dtype).sum((0, 1)).to(dx.dtype).to(dpos.dtype)[None]
    return dpos, dcls, db


def faulted_vit_train_ops(which: str):
    """The ViT's plain train ops with one backward faulted: ``softmax``
    (KT's dlogits), ``dpos`` (KV) or ``sigma`` (KA's Sigma term)."""
    from sitewhere_tpu_torch.models import vit as tv

    ops = tv.TRAIN_PLAIN_OPS
    if which == "softmax":
        return ops._replace(head_bwd=vit_head_bwd_no_softmax)
    if which == "dpos":
        return ops._replace(embed_bwd=vit_embed_bwd_dpos_summed)
    return ops._replace(blocks=ops.blocks._replace(attention_bwd=attention_bwd_no_sigma))


VIT_TRAIN_FAULTS = ("softmax", "dpos", "sigma")


def _hist_oracle(edges: np.ndarray, scores: np.ndarray, counts: np.ndarray) -> np.ndarray:
    bins = np.r_[-np.inf, edges, np.inf]
    out = np.zeros((scores.shape[0], 1, len(bins) - 1), np.int64)
    for t in range(scores.shape[0]):
        out[t, 0], _ = np.histogram(scores[t, : counts[t, 0]], bins=bins)
    return out


def drive(scorer, flushes: int, rng, seq0: int, record: list, b: int = 0,
          fill: bool = False) -> dict:
    """Feed Zipf-repeating tenant traffic through the flush protocol:
    registry -> lane rings -> staging -> stage -> step -> gather -> d2h,
    then flush until the lanes are empty, so every fed row is scored.
    With ``fill`` every lane gets at least ``b`` rows a flush, so each of
    the ``flushes`` takes a full ``b`` (the carry drains after them).
    Times the host's traffic making apart from the protocol, and the
    device time of each flush (CUDA events around step and gather; the
    step's wait on its h2d copy falls inside)."""
    import torch

    from sitewhere_tpu_torch.pipeline.inference import (
        StreamRegistry, _LaneRing, _StagingSet,
    )

    t = scorer.n_slots
    b = b or SHAPES["tenants32"][1]  # rows a lane takes a flush
    regs = [StreamRegistry(1, scorer.max_streams) for _ in range(t)]
    lanes = {(slot, 0): _LaneRing(2 * b) for slot in range(t)}
    sets = [_StagingSet(scorer, b), _StagingSet(scorer, b)]
    fed, resolved, pending = set(), [], []
    n_devices = scorer.max_streams * 3 // 4  # every device gets a stream
    gen_s = proto_s = 0.0
    f = 0
    while f < flushes or any(lane.count for lane in lanes.values()):
        t_gen = time.perf_counter()
        if f < flushes:
            seq = seq0 + f
            for slot in range(t):
                n = int(rng.integers(b if fill else b - b // 4, b + b // 8 + 1))  # some overflow
                devs = zipf_ids(rng, n_devices, n)
                uniq, inv = np.unique(devs, return_inverse=True)
                local = np.array(
                    [regs[slot].lookup_or_assign(f"dev-{d}", "temperature")[1] for d in uniq],
                    np.int32,
                )
                vals = (np.sin(devs * 0.1 + f) + 0.1 * rng.normal(size=n)).astype(np.float32)
                lanes[(slot, 0)].push(local[inv], vals, seq * 1000 + slot, np.arange(n, dtype=np.int32))
                fed.update((seq * 1000 + slot, r) for r in range(n))
        t_proto = time.perf_counter()
        gen_s += t_proto - t_gen
        st = sets[f % 2]
        st.ensure_reusable()
        st.counts[:] = 0
        take = sum(min(lane.count, b) for lane in lanes.values())
        seqs = np.empty((take,), np.int64)
        rows = np.empty((take,), np.int32)
        moved = 0
        for (slot, d), lane in sorted(lanes.items()):
            k = min(lane.count, b)
            lane.pop_into(k, st.ids[slot], st.vals[slot], d * b, seqs, rows, moved)
            st.counts[slot, d] = k
            moved += k
        st.staged = scorer.stage_inputs(st.ids, st.vals, st.counts)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        scores = scorer.step_counts(*st.staged)
        gathered = scorer.gather_rows(scores, st.staged[2], moved)
        ev1.record()
        gathered.copy_to_host_async()
        scorer.last_sketch.copy_to_host_async()
        proto_s += time.perf_counter() - t_proto
        # the twin's copy of this flush (outside the timed protocol)
        record.append((st.ids.copy(), st.vals.copy(), st.counts.copy(), moved))
        pending.append((gathered, scorer.last_sketch, scores, seqs, rows, moved, ev0, ev1))
        f += 1
    host, device_ms, negative = [], [], 0
    for gathered, sketch, scores, seqs, rows, moved, ev0, ev1 in pending:
        t_reap = time.perf_counter()
        g = gathered.numpy_f32()
        proto_s += time.perf_counter() - t_reap
        device_ms.append(ev0.elapsed_time(ev1))
        check(bool(np.isfinite(g[:moved]).all()), "main path: finite scores")
        check(bool(np.isnan(g[moved:]).all()), "main path: NaN padding past the rows")
        negative += int((g[:moved] < 0).sum())
        resolved.extend(zip(seqs.tolist(), rows.tolist()))
        host.append((g, np.asarray(sketch), scores.numpy_f32()))
    check(len(resolved) == len(set(resolved)), "main path: no row resolved twice")
    check(set(resolved) == fed, "main path: every fed row scored")
    return {"host": host, "rows": len(fed), "flushes": f, "gen_s": gen_s,
            "protocol_s": proto_s, "device_ms": device_ms, "negative": negative}


def replay(scorer, record) -> list:
    """The recorded flushes through ``scorer``: each flush's gathered rows."""
    return [scorer.gather_rows(scorer.step_counts(ids, vals, counts), counts, moved)
            .numpy_f32()[:moved] for ids, vals, counts, moved in record]


def twin_check(kern, twin, record, host, tag: str, bar: bool = True):
    """Replay the recorded flushes into the plain twin; state bitwise, NaN
    layout equal, the sketch equal to its oracle and, with ``bar``, the
    gathered scores within the bf16 bar. Rows outside the bar are printed
    either way. Returns the max abs error and the twin's rows."""
    worst, rows = 0.0, []
    for (ids, vals, counts, moved), (g, sketch, plane) in zip(record, host):
        tg = twin.gather_rows(twin.step_counts(ids, vals, counts), counts, moved).numpy_f32()
        check(bool(np.array_equal(np.isnan(tg), np.isnan(g))), f"{tag}: NaN layout")
        err = float(np.max(np.abs(tg[:moved] - g[:moved])))
        worst = max(worst, err)
        rows.append(tg[:moved])
        outside = ~np.isclose(g[:moved], tg[:moved], rtol=TOL, atol=TOL)
        if outside.any():
            emit({"phase": "twin_outside_bar", "tag": tag, "rows": int(outside.sum()),
                  "of": int(moved), "kernel": g[:moved][outside][:4].tolist(),
                  "plain": tg[:moved][outside][:4].tolist()})
        if bar:
            check(not outside.any(), f"{tag}: scores vs plain twin (max abs err {err})")
        check(bool(np.array_equal(sketch, _hist_oracle(kern.sketch_edges, plane, counts))),
              f"{tag}: sketch equals the np.histogram oracle")
    import torch

    for name, a, c in zip(("values", "pos", "count"), kern.state, twin.state):
        check(torch.equal(a, c), f"{tag}: window state {name} bitwise")
    return worst, rows


# -- the recurrent kernels' widths and weight formats ----------------------------

# the variants the kernels line lists beside each kernel's own record: KS
# and KD at tenants32's shapes in int8 and bf16 (hidden 64) and at config
# 10's widths 8 and 32 (bench.py:1355, :1656; f32 masters), and at config
# 8's shape (hidden 16, int8); KF at hidden 16 and 32; KB and KR at hidden
# 16 (window 16) on the train plane
SCAN_VARIANTS = ((64, "int8"), (64, "bf16"), (8, "f32"), (32, "f32"))
C8_HIDDEN, C8_LR, C8_ROUNDS, C8_FLUSHES, C8_REPLAY = 16, 1e-3, 4, 4, 4096


def stacked_trees(spec, cfg, dev, n: int, seed: int):
    """n slots of default-init params at ``cfg``'s width, stacked."""
    import torch

    from sitewhere_tpu_torch.models import common as tc

    gen = torch.Generator().manual_seed(seed)
    return tc.tree_map(lambda *xs: torch.stack(xs),
                       *[spec.init(gen, cfg, device=dev) for _ in range(n)])


def weight_bytes(tree) -> int:
    """Bytes of a (possibly quantized) tree's leaves as stored."""
    from sitewhere_tpu_torch.models import common as tc

    return sum(x.numel() * x.element_size() for x in tc.tree_leaves(tree))


def faulted_scales(q, axis: int):
    """A faulted int8 tree (flat or nested): every slot (axis 0) or every
    output channel (axis -1) dequantized with the first one's scales, a
    dequant that drops the per-slot or the per-channel scale."""
    def walk(node):
        if isinstance(node, dict):
            if "qw" in node:
                x = node["scale"]
                return dict(node, scale=x.narrow(axis, 0, 1).expand_as(x).contiguous())
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(q)


def scan_kernel(family: str, hidden: int, w: int) -> str:
    """The kernel KS or KD's route sends a shape to: the templated form's
    name or its wide or global form's (``models.flush.scan_route``)."""
    from sitewhere_tpu_torch.models.flush import scan_route

    (name,) = SCORER[family]
    route, _ = scan_route(name, name, hidden, w)
    return name if route == "block" else f"{name}_{route}"


def scan_variant_phase(shape: str, dev, spec, cfg, masters, fmt: str, w: int = 0,
                       iters: int = 10) -> dict:
    """KS or KD in its flush form at ``shape`` on the serving tree of
    format ``fmt`` (``quantize_params`` of ``masters``; the width is the
    masters'), against its plain version on the same tree at the bf16 bar;
    bf16 storage bitwise the f32 masters' scores at bf16 compute; int8
    shown rejecting twins that dequantize every output channel with
    channel 0's scale and (with more than one slot) every slot with slot
    0's. Timed over ``iters`` calls beside its bound (int8 MACs at
    quant_mac_width)."""
    import torch

    from sitewhere_tpu_torch.models.common import quantize_params
    from sitewhere_tpu_torch.ops.windows import WindowState, window_update_plain

    t, b, s = SHAPES[shape]
    w = w or WINDOWS.get(shape, WINDOW)
    _, base, ids_np, ids, vals, counts, active = flush_plane(dev, shape, w=w)
    st = WindowState(*(x.clone() for x in base))
    later = window_update_plain(st, ids, vals, counts=counts)
    q = quantize_params(masters, fmt)
    hid = masters["wh"]["w"].shape[-2]
    name = scan_kernel(spec.name, hid, w)
    variant = f"h{hid},{fmt}"
    tag = f"{shape} {name}[{variant}]"

    def kern(tree):
        return spec.score_flush(tree, cfg, st, ids, later, active, counts=counts)

    def plain(tree):
        return spec.score_flush_plain(tree, cfg, st, ids, later, active, counts=counts)

    sc_k, sc_p = kern(q), plain(q)
    torch.cuda.synchronize()
    err = _held(tag, sc_k, sc_p)
    check(bool((sc_k != 0).any()), f"{tag} scored")
    rec = {}
    if fmt == "bf16" and cfg.dtype == "bfloat16":
        same = torch.equal(sc_k, kern(masters))
        check(same, f"{tag}: bf16 storage bitwise the f32 masters' scores at bf16 compute")
        rec["bitwise_f32_masters"] = same
    if fmt == "int8":
        for axis, what in ((-1, "channel"), (0, "slot"))[:2 if t > 1 else 1]:
            fault = plain(faulted_scales(q, axis))
            outside = int((~torch.isclose(sc_k, fault, rtol=TOL, atol=TOL)).sum())
            check(outside > 0, f"{tag}: the check rejects a dequant with {what} 0's scales "
                               f"for every {what}")
            rec[f"fault_{what}0_scales_rows_outside_bar"] = outside
    ms = cuda_time_ms(lambda: kern(q), iters, min(2, iters))
    plain_ms = cuda_time_ms(lambda: plain(q), min(3, iters), 1)
    uniq = len(np.unique(ids_np.astype(np.int64) + np.arange(t)[:, None] * 65536))
    flops = t * b * spec.flops_per_row(cfg, w, k=1, param_dtype=fmt)
    wbytes = weight_bytes(q)
    nbytes = t * b * (2 + 4 + 4) + t * 5 + uniq * (w * 4 + 8) + wbytes
    rec.update(variant=variant, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **_bound(nbytes, flops, BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS),
               library_ms=None, flops=flops, weight_bytes=wbytes, window=w,
               negative_scores=int((sc_k < 0).sum()))
    emit({"phase": "kernel", "shape": shape, "name": name, **rec})
    return rec


def variant_drive(mm, spec, cfg, masters, fmt: str, rng, seq0: int, flushes: int = 2,
                  w: int = WINDOW, fault=None, lane_steps: int = 0, shape: str = "tenants32",
                  lane_twin: bool = False, loss_must_fall: bool = True):
    """The flush main path of one width/format at ``shape`` (tenants32: 32
    slots, every one active with its own weights, window ``w``; the q and r
    planes: 2 slots x 2,048 rows over 2,048 streams): ``drive`` through
    a scorer of ``param_dtype=fmt``, held against its plain twin (state
    bitwise, scores at the bar); with ``fault`` (a serving-tree transform),
    the bar shown rejecting the recorded flushes through a plain scorer
    serving the faulted tree. With ``fault``, DeepAR in bf16 compute is
    held per row by ``held_or_as_accurate`` against an f32 plain replay,
    and that rule shown rejecting the fault too. With ``lane_steps`` the
    same kernel scorer then trains: ``train_drive`` on the flushes' warmed
    rings (``lane_steps`` lane steps and a replay step, the kernel scorer
    alone stepping unless ``lane_twin``, every plain version set to raise;
    ``loss_must_fall`` as there), then a flush served from the trained
    weights against the twin given them. Returns (launches, variant
    launches), the lane's included."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    t, b, s = SHAPES[shape]
    pair = []
    for plain in (False, True):
        sc = ShardedScorer(mm, spec, cfg, slots_per_shard=t, max_streams=s, window=w,
                           param_dtype=fmt, plain=plain)
        for slot in range(t):
            sc.activate(slot, params=tc.tree_map(lambda x: x[slot], masters))
        pair.append(sc)
    kern, twin = pair
    hid = masters["wh"]["w"].shape[-2]
    tag = f"{spec.name} h{hid} {fmt}" + (f" w{w}" if w != WINDOW else "")
    rec: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main = drive(kern, flushes, rng, seq0, rec, b=b)
    counts, variants = kernels.launches(), kernels.variant_launches()
    by_accuracy = fault is not None and spec.name == "deepar" and cfg.dtype == "bfloat16"
    err, twin_rows = twin_check(kern, twin, rec, main["host"], f"{tag} flush",
                                bar=not by_accuracy)
    extra = {}
    if fault is not None:
        extra["fault_rows_outside_bar"] = fault_rows(
            mm, spec, cfg, twin, rec, main["host"], fault, f"{tag} flush")
    if by_accuracy:
        got = np.concatenate([g[:m] for (g, _, _), (*_, m) in zip(main["host"], rec)])
        c32 = dataclasses.replace(cfg, dtype="float32")
        ref = np.concatenate(replay_as(mm, spec, c32, twin, rec))
        extra["accuracy"] = held_or_as_accurate(f"{tag} flush", got, np.concatenate(twin_rows),
                                                ref)
        faulted = np.concatenate(replay_as(mm, spec, cfg, twin, rec, slot_view=fault))
        rule = ~np.isclose(faulted, np.concatenate(twin_rows), rtol=TOL, atol=TOL) & (
            np.abs(faulted - ref) > 1.25 * np.abs(np.concatenate(twin_rows) - ref) + TOL)
        extra["fault_rows_less_accurate_than_twin"] = int(rule.sum())
        check(rule.any(), f"{tag} flush: the accuracy rule rejects the faulted twin")
    emit({"phase": "main_path", "family": spec.name, "path": "flush", "variant": f"h{hid},{fmt}",
          "window": w, "flushes": main["flushes"], "rows": main["rows"],
          "device_ms_per_flush": main["device_ms"], "twin_max_abs_err": err,
          "launches": counts, "variant_launches": variants, **extra})
    check(variants.get(f"{scan_kernel(spec.name, hid, w)}[h{hid},{fmt}]", 0) > 0,
          f"{tag}: the main path launched its variant")
    if lane_steps:
        lane, lane_variants = train_drive(
            mm, spec.name, spec, cfg, {("f32", False): kern, ("f32", True): twin}, rng,
            seq0 + 50, lane_steps, lane_twin=lane_twin, by_accuracy=by_accuracy,
            untrainable=min(UNTRAINABLE, t // 2), loss_must_fall=loss_must_fall)
        for key, n in lane.items():
            counts[key] = counts.get(key, 0) + n
        for key, n in lane_variants.items():
            variants[key] = variants.get(key, 0) + n
    del kern, twin, pair
    torch.cuda.empty_cache()
    return counts, variants


def config8_drive(mm, dev, family: str, rng, seed: int, seq0: int):
    """Config 8's serve+train shape (bench.py:1706-1707, :1739): one slot
    of 1,024 streams, flushes of 4,096 rows, window 16, hidden 16, int8
    serving weights, bf16 compute; the LSTM-AD family (the config's
    iot-temperature template) and the same shape with DeepAR. Rounds of 4
    flushes, each followed by one replay microbatch of 4,096 rows through
    ``train_feed_ingest`` and a replay ``train_lane_step`` (lr 1e-3); after
    4 train steps (swap_every 4) ``commit_swap`` re-derives the int8 view
    from the trained masters, and 4 more flushes serve from it. Every flush
    is held against a plain twin (the trained ones against a twin given
    the trained masters); the view is bitwise unchanged by the steps and
    bitwise the trained masters' quantization after the swap. Returns
    (launches, variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    spec = get_model(family)
    t, b, s = SHAPES["config8"]
    w = WINDOWS["config8"]
    cfg = make_config(family, {"hidden": C8_HIDDEN, "window": w})  # bf16 compute
    params = spec.init(torch.Generator().manual_seed(18 + seed), cfg, device=dev)
    kern, twin = (ShardedScorer(mm, spec, cfg, slots_per_shard=t, max_streams=s, window=w,
                                param_dtype="int8", plain=plain) for plain in (False, True))
    for sc in (kern, twin):
        sc.activate(0, params=params, trainable=True, lr=C8_LR)
    kern.init_optimizer()
    score_name, train_name = SCORER[family][0], TRAIN_KERNEL[family]
    kernels.reset_launches()
    with _NoPlain(kern):
        kern.prewarm_train_lane([C8_REPLAY])
    view0 = [x.clone() for x in tc.tree_leaves(kern.kernel_params())]
    flush_ms, step_ms, losses, worst = [], [], [], 0.0
    for r in range(C8_ROUNDS):
        rec: list = []
        with _NoPlain(kern):
            main = drive(kern, C8_FLUSHES, rng, seq0 + 10 * r, rec, b=b)
        err, _ = twin_check(kern, twin, rec, main["host"], f"{family} config8 int8 round {r}")
        worst, flush_ms = max(worst, err), flush_ms + main["device_ms"]
        ids = zipf_ids(rng, s, (t, C8_REPLAY)).astype(np.uint16)
        vals = np.cumsum(rng.normal(size=(t, C8_REPLAY)), -1).astype(np.float32)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with _NoPlain(kern):
            kern.train_feed_ingest(*kern.stage_inputs(ids, vals, np.full((t, 1), C8_REPLAY,
                                                                         np.int32)))
            ev0.record()
            loss = kern.train_lane_step(replay=True)
            ev1.record()
        losses.append(float(np.asarray(loss)[0]))
        step_ms.append((ev0, ev1))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(c) for a, c in step_ms]
    check(all(np.isfinite(losses)) and losses[-1] > 0,
          f"{family} config8: finite replay losses ({losses})")
    check(_same([x for x in tc.tree_leaves(kern.kernel_params())], view0),
          f"{family} config8: the int8 view unchanged by the train steps before commit_swap")
    with _NoPlain(kern):
        kern.commit_swap()
    view = tc.tree_leaves(kern.kernel_params())
    check(_same(view, tc.tree_leaves(tc.quantize_params(kern.params, "int8"))),
          f"{family} config8: commit_swap re-derives the view from the trained masters")
    check(not _same(view, view0), f"{family} config8: the trained weights reached the view")
    twin.activate(0, params=kern.slot_params(0))
    rec = []
    with _NoPlain(kern):
        main = drive(kern, C8_FLUSHES, rng, seq0 + 100, rec, b=b)
    err, _ = twin_check(kern, twin, rec, main["host"], f"{family} config8 trained-weights flush")
    counts, variants = kernels.launches(), kernels.variant_launches()
    for name in ("window_update", score_name, train_name, "adam_update", "score_sketch",
                 "gather_rows"):
        check(counts[name] > 0, f"{family} config8 launched {name}")
    for key in (f"{score_name}[h{C8_HIDDEN},int8]", f"{train_name}[h{C8_HIDDEN}]"):
        check(variants.get(key, 0) > 0, f"{family} config8 launched {key}")
    emit({"phase": "main_path", "family": family, "path": "config8 serve+train",
          "flushes": C8_ROUNDS * C8_FLUSHES + C8_FLUSHES, "rows_per_flush": b,
          "device_ms_per_flush": flush_ms + main["device_ms"], "train_step_ms": step_ms,
          "replay_losses": losses, "twin_max_abs_err": max(worst, err),
          "trained_twin_max_abs_err": err, "launches": counts, "variant_launches": variants})
    return counts, variants


def legacy_score_phase(dev) -> dict:
    """``lstm_ad.score`` (the per-tenant scorer a rules UDF calls) on CUDA
    tensors, KS in windows mode over one slot, against its plain version
    on the CPU: config 8's width and window, 4,096 rows of random walks,
    f32 compute at the reference's f32 bar 2e-4, bf16 at 2e-2."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import lstm_ad, make_config

    rng = np.random.default_rng(19)
    wins = np.cumsum(rng.normal(size=(4096, 16)), -1).astype(np.float32)
    nv = rng.integers(0, 17, 4096).astype(np.int32)
    out = {}
    for dtype, tol in (("float32", 2e-4), ("bfloat16", TOL)):
        cfg = make_config("lstm_ad", {"hidden": C8_HIDDEN, "window": 16, "dtype": dtype})
        params = lstm_ad.init(torch.Generator().manual_seed(20), cfg, device="cpu")
        on_dev = tc.tree_map(lambda x: x.to(dev), params)
        w_dev, n_dev = torch.from_numpy(wins).to(dev), torch.from_numpy(nv).to(dev)
        before = kernels.launches()["lstm_score"]
        got = lstm_ad.score(on_dev, cfg, w_dev, n_dev)
        check(kernels.launches()["lstm_score"] == before + 1,
              f"lstm_ad.score on the card launched KS ({dtype})")
        want = lstm_ad.score(params, cfg, torch.from_numpy(wins), torch.from_numpy(nv))
        out[dtype] = _held(f"lstm_ad.score on the card ({dtype})", got.cpu(), want, tol)
    emit({"phase": "legacy_score", "family": "lstm_ad", "rows": len(nv),
          "max_abs_err": out})
    return out


def adam_counts_phase(dev) -> dict:
    """The bias corrections KO reads (the table of glibc's powf gathered by
    count on the card) bitwise glibc's powf called for each count, counts
    1..200,000 (the table holds 32,768; past it both are 1.0)."""
    import torch

    from sitewhere_tpu_torch.ops import adam

    n = 200_000
    got = adam.bias_corrections(torch.arange(1, n + 1, dtype=torch.int32, device=dev))
    want = adam.glibc_bias_corrections(range(1, n + 1))
    mism = [int((g.cpu().numpy().view(np.int32) != w.view(np.int32)).sum())
            for g, w in zip(got, want)]
    emit({"phase": "adam_counts", "counts": n, "mismatches_b1_b2": mism})
    check(mism == [0, 0], f"Adam bias corrections bitwise glibc's powf ({mism})")
    return {"mismatches": mism}


def replay_as(mm, spec, cfg, like, record, plain: bool = True, view=None,
              slot_view=None) -> list:
    """The recorded flushes through a scorer of ``spec`` and ``cfg``, with
    ``like``'s slots, params, wire and ``param_dtype``; ``view(tree)``, when
    given, replaces the serving view it derives, ``slot_view(tree)`` each
    slot's params (an injected fault)."""
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    sc = ShardedScorer(mm, spec, cfg, slots_per_shard=like.n_slots,
                       max_streams=like.max_streams, window=like.window,
                       wire_dtype=like.wire_dtype, param_dtype=like.param_dtype, plain=plain)
    for slot in range(like.n_slots):
        tree = like.slot_params(slot)
        sc.activate(slot, params=tree if slot_view is None else slot_view(tree))
    if view is not None:
        sc._kernel_params = view(sc.kernel_params())
        sc._kernel_dirty = False
    return replay(sc, record)


def f64_spec(spec):
    """The transformer's spec with a plain flush in float64 throughout
    (the window normalization, the blocks, the head): the yardstick the
    f32 scorers are held to."""
    import types

    import torch

    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models.flush import gather_stacked, select_scores

    def flush(params, cfg, state, ids, later, active, counts=None, mask=None, k=1,
              out_dtype=torch.float32):
        c64 = types.SimpleNamespace(**dataclasses.asdict(cfg), compute_dtype=torch.float64)
        windows, n_valid = gather_stacked(state, ids)
        sk = tt.score_stacked_plain(params, c64, windows.double(), n_valid, k)
        return select_scores(sk, later, active, counts, mask, out_dtype)

    return dataclasses.replace(spec, score_flush_plain=flush)


def slots_of(record) -> list:
    """Each recorded flush's gathered rows' slots (KG gathers in slot
    order)."""
    return [np.repeat(np.arange(counts.shape[0]), counts.sum(1)) for _, _, counts, _ in record]


def _accuracy(tag: str, kern_rows: list, twin_rows: list, ref_rows: list, slots: list,
              tol: float) -> dict:
    """The kernel scorer's and the plain twin's scores, each against a plain
    scorer of higher precision (mean, q99 and max abs error, rows outside
    ``tol``, each slot's mean abs error), the largest share of a slot's
    rows past the bf16 bar of the twin, and, per slot, the share of the
    scored rows (the twin's score nonzero) within the f32 bar of the twin."""
    k, p, r, s = (np.concatenate(x) for x in (kern_rows, twin_rows, ref_rows, slots))
    n = int(s.max()) + 1
    rows = np.bincount(s, minlength=n)
    rec = {"rows": int(r.size), "slots": n, "tol": tol}
    for name, got in (("kernel", k), ("plain", p)):
        e = np.abs(got - r)
        rec.update({f"{name}_mean_abs_err": float(e.mean()),
                    f"{name}_q99_abs_err": float(np.quantile(e, 0.99)),
                    f"{name}_max_abs_err": float(e.max()),
                    f"{name}_rows_outside_tol": int((~np.isclose(got, r, rtol=tol, atol=tol)).sum()),
                    f"{name}_slot_mean_abs_err": (np.bincount(s, e, n) / rows).tolist()})
    ratio = np.array(rec["kernel_slot_mean_abs_err"]) / np.array(rec["plain_slot_mean_abs_err"])
    apart = ~np.isclose(k, p, rtol=TOL, atol=TOL)
    rec.update(slot_mean_ratio_min=float(ratio.min()), slot_mean_ratio_max=float(ratio.max()),
               slot_share_past_bar_of_twin_max=float((np.bincount(s, apart, n) / rows).max()),
               slot_agree_with_twin=slot_agreement(k, p, s, n).tolist())
    return rec


def slot_agreement(got: np.ndarray, twin: np.ndarray, s: np.ndarray, n: int) -> np.ndarray:
    """Per slot, the share of the rows the twin scores (nonzero) on which
    ``got`` is within the reference's f32 bar (2e-4) of the twin."""
    scored = twin != 0
    near = np.isclose(got, twin, rtol=TF32_TOL, atol=TF32_TOL) & scored
    return np.bincount(s, near, n) / np.maximum(np.bincount(s, scored, n), 1)


def accuracy_check(tag: str, kern_rows: list, twin_rows: list, ref_rows: list, slots: list,
                   factor: float = 1.25, slack: float = 1e-3) -> dict:
    """The transformer's bf16 scorer against its plain twin, two ways. Per
    row, two bf16 computations of its NLL differ past the 2e-2 bar on up to
    a few % of a slot's rows whatever their reduction orders (ROADMAP queue
    3), so: (1) accuracy, pooled: against an f32 plain scorer the kernels'
    mean abs error no more than ``factor`` x the plain version's +
    ``slack``; (2) per slot, so a fault confined to one slot fails: at
    least half of each slot's scored rows within the f32 bar (2e-4) of the
    twin. (Each slot's mean abs error is recorded too; with no fault its
    ratio to the plain version's spreads too far to gate on: PERF.md.)"""
    rec = _accuracy(tag, kern_rows, twin_rows, ref_rows, slots, TOL)
    emit({"phase": "accuracy", "tag": tag, **rec})
    check(rec["kernel_mean_abs_err"] <= factor * rec["plain_mean_abs_err"] + slack,
          f"{tag}: the kernels' scores as accurate as the plain version's "
          f"({rec['kernel_mean_abs_err']} vs {rec['plain_mean_abs_err']})")
    agree = np.array(rec["slot_agree_with_twin"])
    check(bool((agree >= 0.5).all()),
          f"{tag}: half of each slot's scored rows within 2e-4 of the twin "
          f"(slot {int(agree.argmin())}: {float(agree.min())})")
    return rec


def f64_check(tag: str, kern_rows: list, twin_rows: list, ref_rows: list, slots: list) -> dict:
    """The f32 scorers against the float64 plain scorer: every row of the
    kernel scorer within the reference's f32 bar (2e-4); the plain twin's
    rows outside it are counted beside."""
    rec = _accuracy(tag, kern_rows, twin_rows, ref_rows, slots, TF32_TOL)
    emit({"phase": "accuracy", "tag": tag, **rec})
    check(rec["kernel_rows_outside_tol"] == 0,
          f"{tag}: every row within 2e-4 ({rec['kernel_rows_outside_tol']} outside, "
          f"max abs err {rec['kernel_max_abs_err']})")
    return rec


def tf_faulted_flushes(spec) -> dict:
    """Two deliberately faulted plain transformer flushes (KL's plain
    version reading slot 0's scale and bias for every row; KU's without
    fc1's bias) as specs, each with the number of slots it spares: {name:
    (spec, spared)}."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    def faulted(**repl):
        ops = tt.PLAIN_OPS._replace(**repl)

        def flush(params, cfg, state, ids, later, active, counts=None, mask=None, k=1,
                  out_dtype=torch.float32):
            return tt._tf_score(params, cfg, state, ids, later, active, counts, mask, k,
                                out_dtype, ops)

        return dataclasses.replace(spec, score_flush_plain=flush)

    return {
        "layernorm_slot0_affine": (faulted(layernorm=lambda x, sc, bi, r: tc.layernorm_rows_plain(
            x, sc[:1].expand_as(sc), bi[:1].expand_as(bi), r)), 1),
        "bias_gelu_no_bias": (faulted(bias_gelu=lambda x, b, r: tc.bias_gelu_plain(
            x, torch.zeros_like(b), r)), 0),
    }


def fault_probe(mm, spec, cfg, like, record, twin_rows: list) -> dict:
    """The per-slot check's positive controls: the recorded flushes through
    two deliberately faulted plain flushes (KL's plain version reading slot
    0's scale and bias for every row; KU's without fc1's bias). The check
    must reject each in every slot it touches (all but slot 0, and all)."""
    faults = tf_faulted_flushes(spec)
    p, s = np.concatenate(twin_rows), np.concatenate(slots_of(record))
    rec = {}
    for name, (fs, spared) in faults.items():
        agree = slot_agreement(np.concatenate(replay_as(mm, fs, cfg, like, record)), p, s,
                               like.n_slots)
        rec[name] = agree.tolist()
        check(int((agree >= 0.5).sum()) <= spared,
              f"the per-slot check rejects the {name} fault ({agree.tolist()})")
    emit({"phase": "fault_probe", **rec})
    return rec


# -- phase 4g: the train lane ---------------------------------------------------------

TRAIN_KERNEL = {"lstm_ad": "lstm_train", "deepar": "gru_train"}
# the kernels a family's train lane launches besides KO and KW
LANE_KERNELS = {"lstm_ad": ("lstm_train",), "deepar": ("gru_train",),
                "transformer": ("tf_embed", "layernorm", "attention", "bias_gelu", "tf_head_train",
                                *TF_TRAIN_KERNELS)}
# the recurrent lanes' steps (cut from 10 for the script's time)
TRAIN_STEPS, TRAIN_LR, UNTRAINABLE = 5, 1e-3, 4
# the transformer's lane steps (its plain twin and f32 plain scorer run the
# full 32 x 8,192 plane each step too; cut from 3 for the script's time)
TF_TRAIN_STEPS = 2
REPLAY_MICROBATCHES, REPLAY_ROWS = 4, 4096


class _NoPlain:
    """While active, the plain versions a kernel scorer's train path could
    reach raise: its loss, its scorer's flush form, and the plain Adam and
    ring update the scorer module calls."""

    def __init__(self, scorer):
        self.scorer = scorer

    @staticmethod
    def _boom(*_a, **_k):
        raise RuntimeError("a plain version ran on the kernel path")

    def __enter__(self):
        from sitewhere_tpu_torch.parallel import sharded as ts

        self.spec = self.scorer.spec
        self.scorer.spec = dataclasses.replace(
            self.spec, loss_stacked_plain=self._boom, score_flush_plain=self._boom)
        self.mod = {n: getattr(ts, n) for n in ("adam_update_plain", "window_update_plain")}
        for n in self.mod:
            setattr(ts, n, self._boom)
        return self

    def __exit__(self, *exc):
        from sitewhere_tpu_torch.parallel import sharded as ts

        self.scorer.spec = self.spec
        for n, fn in self.mod.items():
            setattr(ts, n, fn)
        return False


def _train_snapshot(scorer, slots=None):
    """Params and Adam state (all slots, or ``slots``) as cloned tensors."""
    from sitewhere_tpu_torch.models import common as tc

    sel = (lambda x: x.clone()) if slots is None else (lambda x: x[slots].clone())
    return [sel(x) for x in tc.tree_leaves((scorer.params, tuple(scorer._opt_state)))]


def _same(a: list, b: list) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def _mean_abs(a: list, b: list) -> float:
    import torch

    num = sum(float((x.float() - y.float()).abs().sum()) for x, y in zip(a, b))
    return num / max(1, sum(x.numel() for x in a))


def train_drive(mm, family: str, spec, cfg, sc: dict, rng, seq0: int,
                steps: int = TRAIN_STEPS, lane_twin: bool = True,
                by_accuracy: bool = False, untrainable: int = UNTRAINABLE,
                loss_must_fall: bool = True) -> dict:
    """The train lane on the warmed rings of the f32-wire kernel scorer and
    its plain twin (``plain=True``), beside an f32-compute plain scorer on
    the same params and rings: every slot active, the first ``untrainable``
    (4 of tenants32's 32) not trainable, lr
    1e-3; ``prewarm_train_lane`` and an all-False-mask step (both must pass
    every param and Adam value through bitwise), ``steps``
    ``train_lane_step``s on the resident rings (bf16 compute), 4 replay
    microbatches of 4096 rows a slot through ``train_feed_ingest`` (rings
    bitwise the twin's) and one ``train_lane_step(replay=True)``, then
    ``commit_swap`` and one flush scored with the trained weights, held
    against the twin given the same weights (the transformer's by its flush's
    rule: accuracy against an f32 plain scorer on the same rings and
    trained weights, and per slot against the twin). The kernel scorer's
    calls run with every plain version set to raise. Without ``lane_twin``
    (main path m: the plain twin's autograd over a 256-sample window takes
    0.7 s for 2 of the 32 slots, so the twin and the f32 scorer would add
    tens of seconds a step; the kernel phases hold the train forms against
    it) only the kernel scorer steps, the twin ingests the
    replay feed and serves the trained flush. With ``by_accuracy`` the
    trained flush is held per row by ``held_or_as_accurate`` against an
    f32 plain scorer (DeepAR's bf16 NLL at the wide shapes). Without
    ``loss_must_fall`` (main paths q and r: at hidden 2,048 and 2,304
    Adam's first step at lr 1e-3 moves every one of 4H^2 recurrent weights
    by ~lr at once, which raises the loss in any implementation), the
    lane must step its twin (``lane_twin``) and the kernel scorer's mean
    loss must move as the plain twin's does, beside the accuracy checks
    against the f32 scorer. Returns the launches."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    kern, twin = sc[("f32", False)], sc[("f32", True)]
    t, s, window = kern.n_slots, kern.max_streams, kern.window
    ref = None
    if lane_twin:
        ref = ShardedScorer(mm, spec, dataclasses.replace(cfg, dtype="float32"),
                            slots_per_shard=t, max_streams=s, window=window, plain=True)
        for a, b in zip(ref.state, kern.state):
            a.copy_(b)
    check(all(torch.equal(a, b) for a, b in zip(kern.state, twin.state)),
          f"{family} train: twin rings equal the kernel scorer's")
    trainable = torch.arange(t, device=kern.device) >= untrainable
    lane = [x for x in (kern, twin, ref) if x is not None]
    for slot in range(t):
        for x in lane:
            x.activate(slot, params=kern.slot_params(slot) if x is ref else None,
                       trainable=bool(trainable[slot]), lr=TRAIN_LR)
    for x in lane:
        x.init_optimizer()
    kernels.reset_launches()
    before = _train_snapshot(kern)
    with _NoPlain(kern):
        kern.prewarm_train_lane([REPLAY_ROWS])
        none = kern.train_lane_step(slots_mask=np.zeros(t, bool))
    torch.cuda.synchronize()
    check(_same(_train_snapshot(kern), before) and not np.asarray(none).any(),
          f"{family} train: prewarm and an all-False-mask step leave params and Adam "
          "state bitwise")
    frozen = _train_snapshot(kern, slice(0, untrainable))
    losses = {"kernel": [], "plain": [], "f32": []}
    step_ms = []
    for _ in range(steps):
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with _NoPlain(kern):
            ev0.record()
            lk = kern.train_lane_step()
            ev1.record()
        losses["kernel"].append(np.asarray(lk))
        step_ms.append((ev0, ev1))
        if lane_twin:
            losses["plain"].append(np.asarray(twin.train_lane_step()))
            losses["f32"].append(np.asarray(ref.train_lane_step()))
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in step_ms]
    lk = np.stack(losses["kernel"])
    tr = trainable.cpu().numpy()
    check(bool(np.isfinite(lk).all()), f"{family} train: finite losses")
    if loss_must_fall:
        check(lk[-1][tr].mean() < lk[0][tr].mean(),
              f"{family} train: the trainable slots' mean loss fell over {steps} steps "
              f"({lk[0][tr].mean()} -> {lk[-1][tr].mean()})")
    else:
        check(lane_twin, f"{family} train: a lane whose loss need not fall steps its twin")
        lp = np.stack(losses["plain"])
        moved_k, moved_p = lk[-1][tr].mean() - lk[0][tr].mean(), lp[-1][tr].mean() - lp[0][tr].mean()
        check(moved_k * moved_p > 0 and abs(moved_k - moved_p) <= TOL * abs(moved_p) + TOL,
              f"{family} train: the mean loss moved as the plain twin's over {steps} steps "
              f"({lk[0][tr].mean()} -> {lk[-1][tr].mean()}; twin {lp[0][tr].mean()} -> "
              f"{lp[-1][tr].mean()})")
    check(not lk[:, ~tr].any(), f"{family} train: untrainable slots report loss 0")
    check(_same(_train_snapshot(kern, slice(0, untrainable)), frozen),
          f"{family} train: the {untrainable} untrainable slots' params, mu, nu, count bitwise")
    if lane_twin:
        # the bf16 accuracy rule, against the f32 plain scorer: the kernel
        # scorer's losses and params no further from it than 1.25x the twin's
        lp, lf = np.stack(losses["plain"]), np.stack(losses["f32"])
        check(bool(np.isfinite(lp).all()), f"{family} train: finite twin losses")
        loss_k = float(np.abs(lk - lf)[:, tr].mean())
        loss_p = float(np.abs(lp - lf)[:, tr].mean())
        n_leaves = len(tc.tree_leaves(kern.params))
        kp, pp, fp = (tc.tree_leaves(x.params) for x in (kern, twin, ref))
        par_k, par_p = _mean_abs(kp, fp), _mean_abs(pp, fp)
        acc = {"loss_mean_abs_err_kernel": loss_k, "loss_mean_abs_err_plain": loss_p,
               "param_mean_abs_err_kernel": par_k, "param_mean_abs_err_plain": par_p,
               "params_leaves": n_leaves}
        emit({"phase": "train_accuracy", "family": family, **acc})
        if loss_must_fall:
            check(loss_k <= 1.25 * loss_p + 1e-3,
                  f"{family} train: kernel losses as accurate as the twin's vs f32 "
                  f"({loss_k} vs {loss_p})")
        else:
            # main paths q and r: a few steps of one trainable slot are too
            # few losses for the pooled rule; each within the bf16 bar of
            # the twin's, as the replay step's are held
            check(bool(np.allclose(lk[:, tr], lp[:, tr], rtol=TOL, atol=TOL)),
                  f"{family} train: each step's losses within {TOL} of the twin's "
                  f"({lk[:, tr].tolist()} vs {lp[:, tr].tolist()})")
        check(par_k <= 1.25 * par_p + 1e-2 * TRAIN_LR,
              f"{family} train: kernel params as accurate as the twin's vs f32 "
              f"({par_k} vs {par_p})")
    # replay: 4 microbatches into the feed rings, then one replay step
    for _ in range(REPLAY_MICROBATCHES):
        ids = zipf_ids(rng, 1024, (t, REPLAY_ROWS)).astype(np.uint16)
        vals = np.cumsum(rng.normal(size=(t, REPLAY_ROWS)), -1).astype(np.float32)
        counts = np.full((t, 1), REPLAY_ROWS, np.int32)
        with _NoPlain(kern):
            kern.train_feed_ingest(*kern.stage_inputs(ids, vals, counts))
        twin.train_feed_ingest(ids, vals, counts)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(kern._train_feed_state, twin._train_feed_state)),
          f"{family} train: feed rings bitwise the twin's")
    with _NoPlain(kern):
        lr_k = np.asarray(kern.train_lane_step(replay=True))
    check(bool(np.isfinite(lr_k).all()) and bool((lr_k[tr] > 0).all()),
          f"{family} train: finite replay losses on every trainable slot")
    if lane_twin:
        lr_p = np.asarray(twin.train_lane_step(replay=True))
        check(bool(np.allclose(lr_k, lr_p, rtol=TOL, atol=TOL)),
              f"{family} train: replay losses within {TOL} of the twin's")
    with _NoPlain(kern):
        kern.commit_swap()
    counts, variants = kernels.launches(), kernels.variant_launches()
    lane_kernels = LANE_KERNELS[family] if family == "transformer" else (
        train_kernel(family, cfg.hidden, window),)
    for name in (*lane_kernels, "adam_update", "window_update"):
        check(counts[name] > 0, f"{family} train lane launched {name}")
    # one flush scored with the trained weights, the twin given them too
    # (and, for the transformer and by_accuracy, an f32 plain scorer on the
    # same rings)
    for slot in range(t):
        twin.activate(slot, params=kern.slot_params(slot))
    transformer = family == "transformer"
    if transformer or by_accuracy:
        f32 = ShardedScorer(mm, spec, dataclasses.replace(cfg, dtype="float32"), slots_per_shard=t,
                            max_streams=s, window=window, plain=True)
        for a, b in zip(f32.state, kern.state):
            a.copy_(b)
        for slot in range(t):
            f32.activate(slot, params=kern.slot_params(slot))
    del ref
    torch.cuda.empty_cache()
    rec: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main = drive(kern, 1, rng, seq0, rec)
    flush_counts = kernels.launches()
    for key, n in kernels.variant_launches().items():
        variants[key] = variants.get(key, 0) + n
    _, twin_rows = twin_check(kern, twin, rec, main["host"], f"{family} trained-weights flush",
                              not (transformer or by_accuracy))
    got = [h[0][:m] for h, (*_, m) in zip(main["host"], rec)]
    extra = {}
    if transformer:
        accuracy_check(f"{family} trained-weights flush, bf16 vs f32", got, twin_rows,
                       replay(f32, rec), slots_of(rec))
    elif by_accuracy:
        extra["trained_flush_accuracy"] = held_or_as_accurate(
            f"{family} h{cfg.hidden} w{window} trained-weights flush", np.concatenate(got),
            np.concatenate(twin_rows), np.concatenate(replay(f32, rec)))
    if transformer or by_accuracy:
        del f32
    flops = kern.train_flops_per_step()
    mean_ms = float(np.mean(step_ms))
    trained_rows = int(((kern.state.count.clamp(max=window) >= min(window, 8))
                        & trainable[:, None]).sum())
    emit({"phase": "main_path", "family": family, "path": "train", "steps": steps,
          "hidden": getattr(cfg, "hidden", None), "window": window,
          "chunk_slots": kern.train_chunk_slots(), **extra,
          "step_ms": step_ms, "flops_per_step": flops, "trained_rows": trained_rows,
          "rows": t * s,
          "bound_ms": flops / BF16_FLOPS * 1e3,
          "share_of_bf16_peak": flops / (mean_ms / 1e3) / BF16_FLOPS,
          "mean_loss_first_last": [float(lk[0][tr].mean()), float(lk[-1][tr].mean())],
          "replay_mean_loss": float(lr_k[tr].mean()), "launches": counts,
          "flush_launches": flush_counts})
    return {n: counts[n] + flush_counts[n] for n in counts}, variants


# -- KA's tiled form, the transformer's weight formats, KQ -------------------------

# (tag, N, T, heads, hd, causal, dtypes, staged): the reference's test
# widths (tests/test_fused_step.py:127-130), a long causal context, f32 hd
# 64 past the staged form's caps, ViT-B/16 at 384, ViT-H/14's heads, wide
# heads; and transformer32's and ViT-B/16-224's shapes, where the staged KA
# is timed beside the tiled one
BOTH = ("bfloat16", "float32")
TILED_SHAPES = (
    ("hd8_t11", 256, 11, 2, 8, True, BOTH, False),
    ("hd16_t15", 256, 15, 2, 16, True, BOTH, False),
    ("hd32_t2047", 8, 2047, 4, 32, True, BOTH, False),
    ("f32_hd64_t210", 32, 210, 2, 64, True, ("float32",), False),
    ("f32_hd64_t511", 32, 511, 2, 64, True, ("float32",), False),
    ("vit_b16_384", 64, 577, 12, 64, False, BOTH, False),
    ("vit_h14", 64, 257, 16, 80, False, BOTH, False),
    ("hd128_t255", 32, 255, 2, 128, True, BOTH, False),
    ("transformer32", 65536, 31, 4, 32, True, BOTH, True),
    ("vit_b16", 64, 197, 12, 64, False, BOTH, True),
)
TILED_MAIN = "vit_b16_384 bf16"  # the record the kernels line carries (main path k's shape)
TILED_KEYS = 64  # the bf16 tiled KA's key tile (csrc/attention_tiled.cu TcTiles::BK, hd <= 128)


def tiled_fault_t0(t: int, causal: bool) -> int:
    """Where ``tiled_fault_twin``'s fault starts for T = t: causal, the
    kernel's last key tile (its keys escape the mask); else the last
    ``TILED_KEYS`` keys (dropped; every key when t <= ``TILED_KEYS``)."""
    return TILED_KEYS * ((t - 1) // TILED_KEYS) if causal else max(0, t - TILED_KEYS)


def tiled_fault_twin(q, k, v, dout, heads: int, causal: bool, t0: int):
    """KA's plain forward and backward (``attention_plain``'s and
    ``attention_bwd_plain``'s arithmetic) with the mask faulted from key
    ``t0`` on: under a causal mask those keys escape it (every row sees
    them), without one they are dropped. The fault the float64 accuracy
    check must reject. Returns (out, (dq, dk, dv))."""
    import math

    import torch

    from sitewhere_tpu_torch.models import common as tc

    dtype, wd = q.dtype, tc.wide(q.dtype)
    n, t, d = q.shape
    hd = d // heads
    qh, kh, vh, oh = (x.reshape(n, t, heads, hd) for x in (q, k, v, dout))
    j = torch.arange(t, device=q.device)
    if causal:
        mask = (j[None, :] <= j[:, None]) | (j[None, :] >= t0)
    else:
        mask = (j[None, :] < t0).expand(t, t)
    logits = torch.einsum("...qhd,...khd->...hqk", qh, kh).to(wd) * (1.0 / math.sqrt(hd))
    logits = torch.where(mask, logits, -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e.sum(-1, keepdim=True)
    p = (e / s).to(dtype)
    out = torch.einsum("...hqk,...khd->...qhd", p, vh).reshape(n, t, d)
    dv = torch.einsum("...hqk,...qhd->...khd", p, oh)
    dp = torch.einsum("...qhd,...khd->...hqk", oh, vh).to(wd)
    a = ((dp * (1 / (s * s))) * e).sum(-1, keepdim=True)
    dl = (torch.where(mask, (dp / s - a) * e, 0.0) * (1.0 / math.sqrt(hd))).to(dtype)
    dq = torch.einsum("...hqk,...khd->...qhd", dl, kh)
    dk = torch.einsum("...hqk,...qhd->...khd", dl, qh)
    return out, tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


def staged_pack_fault_twin(q, k, v, dout, heads: int, causal: bool, leak: bool = True):
    """KA's plain forward and backward (``tiled_fault_twin``'s arithmetic)
    with the bf16 staged kernel's packed tile faulted (T <= 32, where a
    64-row tile packs several (sequence, head) items): with ``leak`` the
    block-diagonal mask is dropped between the two items of each pair (2m,
    2m + 1) of the items in (sequence, head) order, so each row also sees
    its partner's keys (by position, and under a causal mask those at or
    before its own); dk and dv of a key gather the partner's rows too.
    Without ``leak`` it is the plain version. The fault the float64
    accuracy check must reject. Returns (out, (dq, dk, dv))."""
    import math

    import torch

    from sitewhere_tpu_torch.models import common as tc

    dtype, wd = q.dtype, tc.wide(q.dtype)
    n, t, d = q.shape
    hd = d // heads
    items = n * heads
    qh, kh, vh, oh = (x.reshape(n, t, heads, hd) for x in (q, k, v, dout))
    i = torch.arange(t, device=q.device)
    own = (i[None, :] <= i[:, None]) if causal else torch.ones((t, t), dtype=torch.bool,
                                                               device=q.device)
    idx = torch.arange(items, device=q.device)
    part = torch.where((idx ^ 1) < items, idx ^ 1, idx)

    def flat(x):  # [n, t, heads, hd] -> [items, t, hd]
        return x.permute(0, 2, 1, 3).reshape(items, t, hd)

    def unflat(x):
        return x.reshape(n, heads, t, hd).permute(0, 2, 1, 3)

    if leak:
        has = (part != idx).reshape(n, heads, 1, 1)
        kx = torch.cat([kh, unflat(flat(kh)[part])], 1)
        vx = torch.cat([vh, unflat(flat(vh)[part])], 1)
        mask = torch.cat([own.expand(n, heads, t, t), own & has], -1)
    else:
        kx, vx, mask = kh, vh, own
    logits = torch.einsum("...qhd,...khd->...hqk", qh, kx).to(wd) * (1.0 / math.sqrt(hd))
    logits = torch.where(mask, logits, -1e30)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    s = e.sum(-1, keepdim=True)
    p = (e / s).to(dtype)
    out = torch.einsum("...hqk,...khd->...qhd", p, vx).reshape(n, t, d)
    dv = torch.einsum("...hqk,...qhd->...khd", p, oh)
    dp = torch.einsum("...qhd,...khd->...hqk", oh, vx).to(wd)
    a = ((dp * (1 / (s * s))) * e).sum(-1, keepdim=True)
    dl = (torch.where(mask, (dp / s - a) * e, 0.0) * (1.0 / math.sqrt(hd))).to(dtype)
    dq = torch.einsum("...hqk,...khd->...qhd", dl, kx)
    dk = torch.einsum("...hqk,...qhd->...khd", dl, qh)
    if leak:  # a key's gradients also gather its partner's rows
        dk = dk[:, :t] + unflat(flat(dk[:, t:])[part]) * has.reshape(n, 1, heads, 1)
        dv = dv[:, :t] + unflat(flat(dv[:, t:])[part]) * has.reshape(n, 1, heads, 1)
    return out, tuple(x.reshape(n, t, d) for x in (dq, dk, dv))


def tiled_f64_accuracy(got, plain, ref) -> dict:
    """bf16 KA outputs (out, dq, dk, dv) held by accuracy: each one's mean
    abs error against the float64 plain version at most 1.25x the bf16
    plain version's + 1e-3 (two bf16 computations differ by rounding, so
    the bar is the plain version's own error). Returns {"ok", "errors":
    {name: [kernel, plain]}}."""
    errors, ok = {}, True
    for name, g, p_, r in zip(("out", "dq", "dk", "dv"), got, plain, ref):
        ge = float((g.double() - r).abs().mean())
        pe = float((p_.double() - r).abs().mean())
        errors[name] = [ge, pe]
        ok = ok and ge <= 1.25 * pe + 1e-3
    return {"ok": ok, "errors": errors}


def _rel_norm_held(what: str, got, want, bar: float = 1e-2) -> float:
    """A bf16 kernel output within ``bar`` relative norm of its plain
    version's (the train kernels' bar); returns the error."""
    import torch

    err = rel_norm(got.float(), want.float())
    check(bool(torch.isfinite(got.float()).all()), f"{what} finite")
    check(err <= bar, f"{what} within {bar} relative norm of the plain version ({err})")
    return err


def sass_functions(kernels):
    """The built library's kernels as (mangled name, SASS body) pairs, from
    ``cuobjdump -sass`` (beside nvcc); raises OSError or SubprocessError
    when cuobjdump fails."""
    import os
    import re

    lib = kernels.build()
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    return [(body.split("\n", 1)[0], body) for body in re.split(r"\n\s+Function : ", sass)[1:]]


def _op_counts(body: str) -> dict:
    """Tensor-core instructions (HGMMA: wgmma; HMMA: mma.sync) and f32 FFMA
    in one kernel's SASS."""
    import re

    return {op: len(re.findall(rf"\b{op}[ .]", body)) for op in ("HGMMA", "HMMA", "FFMA")}


def tiled_sass_census(funcs) -> dict:
    """What the built library runs KA's tiled kernels on, from its
    ``sass_functions``: per kernel instantiation (the bf16 ones named
    ``*_tc``), its ``_op_counts``."""
    import re

    out = {}
    for name, body in funcs:
        m = re.search(r"(attention_tiled(?:_dq|_dkv)?(?:_tc|_kernel)?)I(L\w+?|f|\w+?)E", name)
        if "attention_tiled" not in name or m is None:
            continue
        out[f"{m.group(1)}<{re.sub(r'[^0-9a-z]', '', m.group(2))}>"] = _op_counts(body)
    return out


def split_sass_census(funcs) -> dict:
    """What the built library runs KA's split kernels on, from its
    ``sass_functions``: per kernel (the bf16 ones named ``*_tc``, the f32
    ones ``<float>``), its ``_op_counts``; "ok": HGMMA in every bf16
    kernel, no HMMA anywhere, none in the f32 ones."""
    import re

    out = {}
    for name, body in funcs:
        m = re.search(r"(attention_split_(?:kernel|one_tc|bwd_tc|dq_tc|dkv_tc|dq|dkv|tc))(If)?E",
                      name)
        if m is not None:
            out[m.group(1) + ("<float>" if m.group(2) else "")] = _op_counts(body)
    bf16 = [c for k, c in out.items() if k.endswith("_tc")]
    f32 = [c for k, c in out.items() if not k.endswith("_tc")]
    ok = (len(bf16) == 5 and len(f32) == 3 and all(c["HGMMA"] > 0 for c in bf16)
          and all(c["HMMA"] == 0 for c in out.values()) and all(c["HGMMA"] == 0 for c in f32))
    return {"ok": ok, "kernels": out}


def tiled_attention_phase(dev) -> dict:
    """KA's tiled forward and backward at every shape of ``TILED_SHAPES``:
    f32 per element within 2e-4 of the float64 plain version, bf16 within
    1e-2 relative norm of the plain version, two runs bitwise; timed beside
    the plain version, ``scaled_dot_product_attention`` (forward, and its
    backward through autograd) and the bound (bytes; operations: 2 products
    forward, 5 backward with the logits recomputed); at transformer32's and
    ViT-B/16-224's shapes the staged KA's times beside; bf16 also by
    ``tiled_f64_accuracy``, with ``tiled_fault_twin`` (its mask faulted
    from ``tiled_fault_t0``) shown failing it.
    Each record carries its achieved TFLOP/s (the bound's operations over
    the time) and its time over the bound. Returns the records by "tag
    dtype"."""
    import torch
    import torch.nn.functional as F

    from sitewhere_tpu_torch.models import common as tc

    gen = torch.Generator(device=dev).manual_seed(90)
    out = {}
    for tag, n, t, heads, hd, causal, dtypes, staged in TILED_SHAPES:
        for dname in dtypes:
            dtype = getattr(torch, dname)
            key = f"{tag} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            q, k, v, do = (torch.randn((n, t, heads * hd), generator=gen, device=dev)
                           .to(dtype) for _ in range(4))
            o = tc.attention_tiled(q, k, v, heads, causal)
            g = tc.attention_tiled_bwd(q, k, v, do, heads, causal)
            o2 = tc.attention_tiled(q, k, v, heads, causal)
            g2 = tc.attention_tiled_bwd(q, k, v, do, heads, causal)
            torch.cuda.synchronize()
            check(torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(g, g2)),
                  f"tiled KA {key}: two runs bitwise")
            del o2, g2
            if dtype == torch.float32:
                q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
                fwd_err = _held(f"tiled KA {key} vs f64", o, tc.attention_plain(
                    q64, k64, v64, heads, causal).float(), TF32_TOL)
                bwd_err = max(_held(f"tiled KA backward {key} {nm} vs f64", a, b.float(),
                                    TF32_TOL)
                              for nm, a, b in zip(("dq", "dk", "dv"), g, tc.attention_bwd_plain(
                                  q64, k64, v64, do64, heads, causal)))
                del q64, k64, v64, do64
                errs = dict(fwd_max_abs_err_vs_f64=fwd_err, bwd_max_abs_err_vs_f64=bwd_err)
            else:
                fwd = _rel_norm_held(f"tiled KA {key}", o, tc.attention_plain(q, k, v, heads,
                                                                             causal))
                bwd = max(_rel_norm_held(f"tiled KA backward {key} {nm}", a, b)
                          for nm, a, b in zip(("dq", "dk", "dv"), g, tc.attention_bwd_plain(
                              q, k, v, do, heads, causal)))
                errs = dict(fwd_rel_norm=fwd, bwd_rel_norm=bwd,
                            fwd_max_abs_err=float((o.float() - tc.attention_plain(
                                q, k, v, heads, causal).float()).abs().max()))
                q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
                ref = (tc.attention_plain(q64, k64, v64, heads, causal),
                       *tc.attention_bwd_plain(q64, k64, v64, do64, heads, causal))
                del q64, k64, v64, do64
                plain = (tc.attention_plain(q, k, v, heads, causal),
                         *tc.attention_bwd_plain(q, k, v, do, heads, causal))
                acc = tiled_f64_accuracy((o, *g), plain, ref)
                t0 = tiled_fault_t0(t, causal)
                fo, fg = tiled_fault_twin(q, k, v, do, heads, causal, t0)
                fault = tiled_f64_accuracy((fo, *fg), plain, ref)
                del ref, plain, fo, fg
                check(acc["ok"], f"tiled KA {key}: as accurate against float64 as the bf16 "
                      f"plain version ({acc['errors']})")
                check(not fault["ok"], f"tiled KA {key}: the float64 check rejects a twin "
                      f"faulted from key {t0} ({fault['errors']})")
                errs.update(f64_mean_abs_err_kernel_plain=acc["errors"],
                            fault_f64_mean_abs_err=fault["errors"])
            del o, g
            torch.cuda.empty_cache()
            big = n * t * t * heads > 2e8
            it = 3 if big else 10
            pairs = t * (t + 1) / 2 if causal else t * t
            elt = q.element_size()
            fwd_flops = 2 * 2.0 * hd * pairs * heads * n  # 2 products; 5 backward
            bwd_flops = 5 * 2.0 * hd * pairs * heads * n

            def bound(nbytes, flops):
                if dtype == torch.bfloat16:
                    return _bound(nbytes, flops, BF16_FLOPS)
                return _bound(nbytes, 0.0, BF16_FLOPS, f32_flops=flops)

            qh, kh, vh = (z.view(n, t, heads, hd).transpose(1, 2).detach().requires_grad_(True)
                          for z in (q, k, v))
            doh = do.view(n, t, heads, hd).transpose(1, 2)
            lib_o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
            # SDPA's backward refuses 2^18 (sequence, head) pairs and more
            # (cuDNN's backend fails, flash's grid is out of range)
            lib_bwd = n * heads < 2 ** 18
            rec = dict(
                dims=[n, t, heads, hd], causal=causal, dtype=dname, **errs,
                ms=cuda_time_ms(lambda: tc.attention_tiled(q, k, v, heads, causal), it),
                plain_ms=cuda_time_ms(lambda: tc.attention_plain(q, k, v, heads, causal), 1, 1),
                library_ms=cuda_time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), it),
                **bound(4 * q.numel() * elt, fwd_flops),
                bwd_ms=cuda_time_ms(lambda: tc.attention_tiled_bwd(q, k, v, do, heads, causal),
                                    it),
                bwd_plain_ms=cuda_time_ms(
                    lambda: tc.attention_bwd_plain(q, k, v, do, heads, causal), 1, 1),
                bwd_library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    lib_o, (qh, kh, vh), doh, retain_graph=True), it) if lib_bwd else None,
                library_call="scaled_dot_product_attention, its backward through autograd"
                             + ("" if lib_bwd else " (refused at this shape)"),
            )
            b = bound(7 * q.numel() * elt, bwd_flops)
            rec.update(bwd_bound_ms=b["bound_ms"], bwd_bound_by=b["bound_by"],
                       tflops=fwd_flops / rec["ms"] / 1e9,
                       bwd_tflops=bwd_flops / rec["bwd_ms"] / 1e9,
                       ms_over_bound=rec["ms"] / rec["bound_ms"],
                       bwd_ms_over_bound=rec["bwd_ms"] / b["bound_ms"])
            if staged:
                rec.update(
                    staged_ms=cuda_time_ms(lambda: tc.attention(q, k, v, heads, causal), it),
                    staged_bwd_ms=cuda_time_ms(
                        lambda: tc.attention_bwd(q, k, v, do, heads, causal), it))
            del qh, kh, vh, doh, lib_o, q, k, v, do
            torch.cuda.empty_cache()
            emit({"phase": "kernel", "shape": key, "name": "attention_tiled", **rec})
            out[key] = rec
    return out


def tiled_records(recs: dict) -> dict:
    """The kernels line's records of the tiled forward and backward: main
    path k's shape (ViT-B/16 at 384, bf16), with every shape's numbers
    beside under "shapes"."""
    main = recs[TILED_MAIN]
    shapes = {key: {k_: r[k_] for k_ in ("ms", "bwd_ms", "plain_ms", "bwd_plain_ms", "bound_ms",
                                         "bwd_bound_ms", "library_ms", "bwd_library_ms", "tflops",
                                         "bwd_tflops", "ms_over_bound", "bwd_ms_over_bound")}
              for key, r in recs.items()}
    f64 = main["f64_mean_abs_err_kernel_plain"]
    fwd = dict(max_abs_err=main["fwd_max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=main["library_ms"], tflops=main["tflops"],
               ms_over_bound=main["ms_over_bound"], f64_mean_abs_err_kernel_plain=f64["out"],
               shape=TILED_MAIN, shapes=shapes)
    bwd = dict(max_abs_err=main["bwd_rel_norm"], error_kind="relative norm", ms=main["bwd_ms"],
               plain_ms=main["bwd_plain_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"], library_ms=main["bwd_library_ms"],
               tflops=main["bwd_tflops"], ms_over_bound=main["bwd_ms_over_bound"],
               f64_mean_abs_err_kernel_plain={n_: f64[n_] for n_ in ("dq", "dk", "dv")},
               shape=TILED_MAIN)
    return {"attention_tiled": fwd, "attention_tiled_bwd": bwd}


def quant_kernel_phase(dev, cfg, masters) -> dict:
    """KE, KN and KQ at transformer32 on the int8 and bf16 serving trees of
    ``masters`` (``quantize_params``), each against its plain version on the
    same tree: KE's tokens and KN's scores within the bf16 bar, KQ bitwise
    (every block's six dense nodes, one flush's dequant work, timed beside
    ``qw.to(bf16) * scale.to(bf16)``); bf16 storage gives KE the f32
    masters' bits. Returns {name: {format: record}}."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models.common import quantize_params

    t, b, s = SHAPES["transformer32"]
    st, ids_np, ids, counts, active, later = tf_plane(dev)
    dtype, d, tok = cfg.compute_dtype, cfg.dim, WINDOW - 1
    uniq = len(np.unique(ids_np.astype(np.int64) + np.arange(t)[:, None] * 65536))
    out = {"tf_embed": {}, "tf_head": {}}
    x32 = tt.tf_embed(masters, cfg, 1, state=st, ids=ids)[0]
    for fmt in ("int8", "bf16"):
        q = quantize_params(masters, fmt)
        x, tg, nv = tt.tf_embed(q, cfg, 1, state=st, ids=ids)
        xp, tgp, nvp = tt.tf_embed_plain(q, cfg, 1, state=st, ids=ids)
        torch.cuda.synchronize()
        keep = nv >= 2
        err = max(_held(f"transformer32 KE[{fmt}] tokens", x[keep], xp[keep]),
                  _held(f"transformer32 KE[{fmt}] targets", tg[keep], tgp[keep]))
        rec = dict(variant=fmt, max_abs_err=err,
                   ms=cuda_time_ms(lambda: tt.tf_embed(q, cfg, 1, state=st, ids=ids), 10),
                   plain_ms=cuda_time_ms(lambda: tt.tf_embed_plain(q, cfg, 1, state=st, ids=ids),
                                         2, 1), library_ms=None,
                   **_bound(t * b * 2 + uniq * (WINDOW * 4 + 8) + x.numel() * 2 + tg.numel() * 4
                            + nv.numel() * 4 + t * (2 + tok) * d * 4, t * b * 4.0 * WINDOW
                            + 3.0 * x.numel(), F32_FLOPS))
        if fmt == "bf16":
            rec["bitwise_f32_masters"] = bool(torch.equal(x, x32))
            check(rec["bitwise_f32_masters"], "transformer32 KE[bf16]: the f32 masters' tokens")
        emit({"phase": "kernel", "shape": "transformer32", "name": "tf_embed", **rec})
        out["tf_embed"][fmt] = rec
        hfin = tt._blocks(q, x, cfg)
        args = (q, cfg, hfin, tg, nv, 1, later, active, counts, None, torch.float32)
        sk, skp = tt.tf_head(*args), tt.tf_head_plain(*args)
        torch.cuda.synchronize()
        rec = dict(variant=fmt, max_abs_err=_held(f"transformer32 KN[{fmt}]", sk, skp),
                   ms=cuda_time_ms(lambda: tt.tf_head(*args), 20),
                   plain_ms=cuda_time_ms(lambda: tt.tf_head_plain(*args), 3, 1), library_ms=None,
                   **_bound(t * b * d * 2 + t * b * 16 + t * (3 * d + 2) * 4,
                            t * b * (10.0 * d + 40), F32_FLOPS))
        emit({"phase": "kernel", "shape": "transformer32", "name": "tf_head", **rec})
        out["tf_head"][fmt] = rec
        del x, xp, hfin, sk, skp
        if fmt == "int8":
            nodes = [blk[g][n] for blk in q["blocks"] for g, names in
                     (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("fc1", "fc2"))) for n in names]
            for i, node in enumerate(nodes):
                got = tc.dequant(node["qw"], node["scale"], dtype)
                same = torch.equal(got, tc.dequant_plain(node["qw"], node["scale"], dtype))
                check(same, f"transformer32 KQ bitwise its plain version (node {i})")

            def run(fn):
                return lambda: [fn(nd["qw"], nd["scale"], dtype) for nd in nodes]

            n_w = sum(nd["qw"].numel() for nd in nodes)

            def dev_ms(fn):  # device time of the 24 calls (their launches are host-bound)
                return sum(r[1] for r in device_rows(run(fn)))

            rec = dict(max_abs_err=0.0, bitwise=True, nodes=len(nodes), weights=n_w,
                       ms=dev_ms(tc.dequant), plain_ms=dev_ms(tc.dequant_plain),
                       library_ms=dev_ms(lambda a, c, dt: a.to(dt) * c.to(dt)),
                       library_call="qw.to(bf16) * scale.to(bf16) (its plain version's ops)",
                       timing="device time under torch.profiler, 24 calls",
                       events_ms=cuda_time_ms(run(tc.dequant), 20),
                       **_bound(n_w * 3 + sum(nd["scale"].numel() * 4 for nd in nodes), n_w,
                                F32_FLOPS))
            emit({"phase": "kernel", "shape": "transformer32", "name": "dequant", **rec})
            out["dequant"] = rec
        del q
        torch.cuda.empty_cache()
    return out


QUANT_FLUSHES = 2


def quant_drive(mm, spec, cfg, masters, fmt: str, rng, seq0: int):
    """Main path j: transformer32 served from ``fmt`` ("int8" or "bf16")
    weights. A kernel scorer and its plain twin of that ``param_dtype``
    (32 slots, each its own masters), ``drive`` through step_counts,
    gather_rows and d2h (every plain version set to raise on the kernel
    scorer), held by the transformer's bf16 rule against the twin and an
    f32-compute plain scorer on the same quantized tree (accuracy pooled,
    agreement per slot); for int8 the per-slot check shown rejecting twins
    whose dequant drops the per-slot or the per-channel scale. Then one
    train-lane step (the f32 masters) and ``commit_swap``: the view
    unchanged by the step, re-derived after it, and the next flush served
    from it against a twin given the trained masters. Returns (launches,
    variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    t, _, s = SHAPES["transformer32"]
    kern, twin = (ShardedScorer(mm, spec, cfg, slots_per_shard=t, max_streams=s, window=WINDOW,
                                param_dtype=fmt, plain=plain) for plain in (False, True))
    for sc in (kern, twin):
        for slot in range(t):
            sc.activate(slot, params=tc.tree_map(lambda x: x[slot], masters), lr=TRAIN_LR)
    f32 = dataclasses.replace(cfg, dtype="float32")
    tag = f"transformer {fmt} weights"
    rec: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main = drive(kern, QUANT_FLUSHES, rng, seq0, rec)
    counts, variants = kernels.launches(), kernels.variant_launches()
    for key in (f"tf_embed[{fmt}]", f"tf_head[{fmt}]") + (
            ("dequant[int8->bfloat16]",) if fmt == "int8" else ()):
        check(variants.get(key, 0) > 0, f"{tag}: the main path launched {key}")
    _, twin_rows = twin_check(kern, twin, rec, main["host"], f"{tag} flush", False)
    kern_rows = [h[0][:m] for h, (*_, m) in zip(main["host"], rec)]
    acc = accuracy_check(f"{tag}, bf16 vs f32 on the same tree", kern_rows, twin_rows,
                         replay_as(mm, spec, f32, twin, rec), slots_of(rec))
    faults = {}
    if fmt == "int8":
        p, sl = np.concatenate(twin_rows), np.concatenate(slots_of(rec))
        for axis, what, spared in ((0, "slot", 1), (-1, "channel", 0)):
            agree = slot_agreement(np.concatenate(replay_as(
                mm, spec, cfg, twin, rec, view=lambda v, a=axis: faulted_scales(v, a))), p, sl, t)
            faults[what] = agree.tolist()
            check(int((agree >= 0.5).sum()) <= spared,
                  f"{tag}: the per-slot check rejects a dequant with {what} 0's scales "
                  f"({agree.tolist()})")
        emit({"phase": "fault_probe", "tag": tag, **faults})
    # one train-lane step on the f32 masters, then commit_swap
    kern.init_optimizer()
    view0 = [x.clone() for x in tc.tree_leaves(kern.kernel_params())]
    kernels.reset_launches()
    with _NoPlain(kern):
        loss = np.asarray(kern.train_lane_step())
    check(bool(np.isfinite(loss).all()) and bool((loss > 0).any()), f"{tag}: a finite train step")
    check(_same(tc.tree_leaves(kern.kernel_params()), view0),
          f"{tag}: the view unchanged by the train step before commit_swap")
    with _NoPlain(kern):
        kern.commit_swap()
    view = tc.tree_leaves(kern.kernel_params())
    check(_same(view, tc.tree_leaves(tc.quantize_params(kern.params, fmt))),
          f"{tag}: commit_swap re-derives the view from the trained masters")
    check(not _same(view, view0), f"{tag}: the trained weights reached the view")
    train_counts = kernels.launches()
    for slot in range(t):
        twin.activate(slot, params=kern.slot_params(slot))
    rec2: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main2 = drive(kern, 1, rng, seq0 + 50, rec2)
    for key, n in kernels.variant_launches().items():
        variants[key] = variants.get(key, 0) + n
    _, twin2 = twin_check(kern, twin, rec2, main2["host"], f"{tag} trained-weights flush", False)
    acc2 = accuracy_check(f"{tag} trained-weights flush, bf16 vs f32 on the same tree",
                          [h[0][:m] for h, (*_, m) in zip(main2["host"], rec2)], twin2,
                          replay_as(mm, spec, f32, twin, rec2), slots_of(rec2))
    flush_counts = kernels.launches()
    if fmt == "int8":
        profile_flush(kern, rng, "transformer32 int8 weights")
    emit({"phase": "main_path", "family": "transformer", "path": "flush", "variant": fmt,
          "flushes": main["flushes"] + main2["flushes"], "rows": main["rows"] + main2["rows"],
          "device_ms_per_flush": main["device_ms"] + main2["device_ms"],
          "train_loss_mean": float(loss[loss > 0].mean()),
          "kernel_mean_abs_err": [acc["kernel_mean_abs_err"], acc2["kernel_mean_abs_err"]],
          "plain_mean_abs_err": [acc["plain_mean_abs_err"], acc2["plain_mean_abs_err"]],
          "launches": counts, "variant_launches": variants})
    del kern, twin
    torch.cuda.empty_cache()
    total = {n: counts[n] + train_counts[n] + flush_counts[n] for n in counts}
    return total, variants


VIT384_BATCH, VIT384_TRAIN_BATCH = 64, 16
VIT384_EXPECTED = {"frame_patches": 1, "vit_embed": 1, "layernorm": 24, "attention_tiled": 12,
                   "bias_gelu": 12, "vit_head": 1}
VIT384_TRAIN_EXPECTED = {"frame_patches": 1, "vit_embed": 1, "layernorm": 24,
                         "attention_tiled": 12, "bias_gelu": 12, "vit_head_train": 2,
                         "bias_gelu_bwd": 12, "attention_tiled_bwd": 12, "layernorm_bwd": 24,
                         "vit_embed_bwd": 1, "adam_update": 1}


def vit384_drive(dev, seed: int) -> dict:
    """Main path k: ViT-B/16 at 384 (``ViTConfig(image_size=384)``, T 577,
    dim 768, depth 12, 12 heads, 1,000 classes, bf16, random weights from
    ``--seed``): 64 u8 frames classified with top-5 through KP, KV, the
    blocks' KL, tiled KA and KU, and KT (``models.vit.classify``), every
    plain version set to raise; held to one forward's launches, its logits
    by accuracy against an f32 plain forward (``vit_logit_accuracy``, a
    twin without the head bias shown failing) and its top-k ids by
    ``topk_ids_check``. Then one bf16 ``train_step`` at 16 frames with
    ``adam(1e-3)``: its launches held, its gradients (before the step) each
    leaf within max(2e-2, 1.25x the plain bf16 twin's) relative norm of the
    f32 plain gradient; a second step timed warm. Returns the launches."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops import adam
    from sitewhere_tpu_torch.sim.media import camera_frames

    cfg = tv.ViTConfig(image_size=384)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator().manual_seed(24 + seed)
    params = own_affines(tv.init(gen, cfg, device=dev), gen)
    x_u8 = torch.from_numpy(np.stack(camera_frames(384, VIT384_BATCH, seed=6 + seed))).to(dev)
    want = {name: 0 for name in kernels.KERNELS}
    want.update(VIT384_EXPECTED)
    launches = {name: 0 for name in kernels.KERNELS}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _NoPlainViT():
        logits, probs, ids = tv.classify(params, cfg, x_u8, VIT_TOPK)
        torch.cuda.synchronize()
    classify_s = time.perf_counter() - t0
    counts = kernels.launches()
    check(counts == want, f"vit_b16_384 classify: launches {counts}")
    for name, n in counts.items():
        launches[name] += n
    check(tuple(ids.shape) == (VIT384_BATCH, VIT_TOPK) and bool(torch.isfinite(logits).all()),
          "vit_b16_384: finite logits, top-5 ids")
    lt, pt, it = tv._classify(params, cfg, x_u8, VIT_TOPK, tv.PLAIN_OPS)
    l32 = tv._classify(params, cfg32, x_u8, VIT_TOPK, tv.PLAIN_OPS)[0]
    no_bias = tv.PLAIN_OPS._replace(head=lambda h, ln, hd, k: tv.vit_head_plain(
        h, ln, {"w": hd["w"], "b": torch.zeros_like(hd["b"])}, k))
    lf = tv._classify(params, cfg, x_u8, VIT_TOPK, no_bias)[0]
    rec = vit_logit_accuracy("vit_b16_384 bf16 frames", logits, lt, l32)
    fault = vit_logit_accuracy("vit_b16_384 twin without the head bias", lf, lt, l32)
    rec["fault_mean_abs_err"] = fault["kernel_mean_abs_err"]
    rec["ids"] = topk_ids_check("vit_b16_384 bf16 top-k ids vs f32", logits, probs, ids, l32)
    check(rec["as_accurate"], f"vit_b16_384: the kernels' logits as accurate as the plain "
          f"version's ({rec['kernel_mean_abs_err']} vs {rec['plain_mean_abs_err']})")
    check(not fault["as_accurate"], f"vit_b16_384: the accuracy check rejects a twin without the "
          f"head bias ({fault['kernel_mean_abs_err']})")
    ms = cuda_time_ms(lambda: tv.classify(params, cfg, x_u8, VIT_TOPK), 2, 1)
    profile_run("vit_b16_384 frames", lambda: tv.classify(params, cfg, x_u8, VIT_TOPK))
    emit({"phase": "main_path", "family": "vit_b16_384", "path": "classify",
          "frames": VIT384_BATCH, "tokens": cfg.num_patches + 1, "seconds": classify_s,
          "forward_ms": ms, "frames_per_s": VIT384_BATCH / ms * 1e3, "launches": counts,
          "accuracy": rec})
    del lt, pt, it, l32, lf, logits, probs
    torch.cuda.empty_cache()
    # one bf16 train step at 16 frames
    images = (x_u8[:VIT384_TRAIN_BATCH].float() / 255.0 - 0.5) / 0.5
    labels = torch.from_numpy(np.random.default_rng(71 + seed).integers(
        0, cfg.num_classes, VIT384_TRAIN_BATCH).astype(np.int32)).to(dev)
    names = leaf_names(params)
    _, g_32 = _vit_grads(tv.loss_plain, params, cfg32, images, labels)
    _, g_p = _vit_grads(tv.loss_plain, params, cfg, images, labels)
    err_p = tf_bf16_errors(names, g_p, g_32)
    del g_p
    with _NoPlainViT():
        _, g_k = _vit_grads(tv.loss, params, cfg, images, labels)
    err_k = tf_bf16_errors(names, g_k, g_32)
    del g_k, g_32
    torch.cuda.empty_cache()
    bad = [n for n in names if err_k[n] > max(TOL, 1.25 * err_p[n])]
    emit({"phase": "train_bf16_grads", "shape": "vit_b16_384", "frames": VIT384_TRAIN_BATCH,
          "worst_kernel": max(err_k.values()), "worst_plain": max(err_p.values()),
          "rel_norm_vs_f32_kernel_plain": {n: (err_k[n], err_p[n]) for n in names}})
    check(not bad, f"vit_b16_384 bf16 gradients within max(2e-2, 1.25x the twin's) of f32: {bad}")
    spec, opt = get_model("vit_b16"), adam.adam(1e-3)
    p = tc.tree_map(torch.clone, params)
    state = opt.init(p)
    want = {name: 0 for name in kernels.KERNELS}
    want.update(VIT384_TRAIN_EXPECTED)
    kernels.reset_launches()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with _NoPlainViT():
        ev0.record()
        p, state, loss = spec.train_step(p, state, (images, labels), cfg, opt)
        ev1.record()
        torch.cuda.synchronize()
    counts = kernels.launches()
    check(counts == want, f"vit_b16_384 train step: launches {counts}")
    check(bool(np.isfinite(float(loss))) and int(state[0].count) == 1,
          "vit_b16_384 train step: finite loss, one Adam step")
    for name, n in counts.items():
        launches[name] += n
    # a second step, warm (its launches are past the path's count)
    with _NoPlainViT():
        ev2, ev3 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev2.record()
        p, state, _ = spec.train_step(p, state, (images, labels), cfg, opt)
        ev3.record()
        torch.cuda.synchronize()
    emit({"phase": "main_path", "family": "vit_b16_384", "path": "train_step",
          "frames": VIT384_TRAIN_BATCH, "loss": float(loss), "step_ms": ev0.elapsed_time(ev1),
          "warm_step_ms": ev2.elapsed_time(ev3), "launches": counts})
    del p, state, params
    torch.cuda.empty_cache()
    return launches


# -- K3'c, the serving half: config 1's flush, the wide and long shapes -------------

# config 1 (bench.py:2033, :2038, :797, :2041, :2059-2060;
# sitewhere_tpu/runtime/config.py:212, :228): one slot of 4,096 streams,
# flushes of 65,536 rows (its largest bucket), LSTM-AD at window 32,
# hidden 64, f32 params, bf16 compute, the bf16 wire, K = 1
C1_STREAMS, C1_ROWS, C1_FLUSHES = 4096, 65536, 8
# the multi-block KW on one slot of config 1's streams: config 1's bucket
# and 4x it; at 16,384 rows beside the one-block form
KW_MULTI_ROWS = (65536, 262144, 16384)
# main path m's flushes: (family, shape, hidden, window): forecasting32
# with GluonTS DeepAR's num_cells=40 at a window past the DeepAR paper's
# 168-point range; tenants32 with LSTM-AD at hidden 128, window 256
WIDE_MAIN = (("deepar", "forecasting32", 40, 192), ("lstm_ad", "tenants32", 128, 256))
# the wide forms in windows mode (kernel phases): (hidden, window, served
# format, slots, rows a slot); window 512 also at hidden 64 (the templated
# form, whose tile holds it)
WIDE_WINDOWS = ((4, 32, "int8", 32, 2048), (96, 32, "bf16", 32, 2048),
                (256, 32, "f32", 32, 2048), (64, 512, "f32", 8, 2048),
                (96, 512, "f32", 8, 2048))
# config 3's forecast (64 series, horizon 24) at the DeepAR paper's 168-
# point context: (hidden, samples); GluonTS's num_cells=40 and
# num_parallel_samples=100, and 256 paths
KF_CONTEXT = 168
KF_SHAPES = ((40, 256), (40, 100), (64, 256), (64, 100))
KF_MAIN = ((40, 100), (40, 256))


def swapped_gates(q, a: int = 0, b: int = 1):
    """A faulted serving tree: the recurrent weight's gate blocks ``a`` and
    ``b`` (columns ``[a*H, (a+1)*H)``) swapped, a fault of the wide form's
    unit-to-column map (int8 scales move with their columns)."""
    import torch

    wh = q["wh"]
    key = "qw" if "qw" in wh else "w"
    h = wh[key].shape[-2]
    blocks = list(range(wh[key].shape[-1] // h))
    blocks[a], blocks[b] = blocks[b], blocks[a]
    perm = torch.cat([torch.arange(i * h, (i + 1) * h) for i in blocks]).to(wh[key].device)
    out = dict(wh, **{key: wh[key][..., perm].contiguous()})
    if "scale" in wh:
        out["scale"] = wh["scale"][..., perm].contiguous()
    return dict(q, wh=out)


def fault_rows(mm, spec, cfg, twin, record, host, view, tag: str) -> int:
    """The recorded flushes through a plain scorer whose slots serve
    ``view(tree)``: the bar must reject it (rows outside it against the
    kernel scorer's gathered rows). Returns that count."""
    got = np.concatenate([g[:m] for (g, _, _), (*_, m) in zip(host, record)])
    fault = np.concatenate(replay_as(mm, spec, cfg, twin, record, slot_view=view))
    outside = int((~np.isclose(got, fault, rtol=TOL, atol=TOL)).sum())
    check(outside > 0, f"{tag}: the bar rejects a faulted twin ({outside} rows outside)")
    return outside


def held_or_as_accurate(tag: str, got, twin, ref) -> dict:
    """DeepAR's bf16 NLL against its plain twin, per row: within the bf16
    bar of the twin or, on a row where the NLL is ill-conditioned (a small
    sigma: a one-ulp flip of a bf16 head output moves it by percents, and
    two bf16 computations in different sum orders land ulps apart), as
    accurate as the twin against an f32 plain run: |got - f32| <= 1.25
    |twin - f32| + 2e-2. A fault makes the kernel less accurate than the
    twin on many rows; the counts are recorded."""
    got, twin, ref = (np.asarray(x, np.float64) for x in (got, twin, ref))
    outside = ~np.isclose(got, twin, rtol=TOL, atol=TOL)
    worse = outside & (np.abs(got - ref) > 1.25 * np.abs(twin - ref) + TOL)
    rec = dict(rows=int(got.size), rows_outside_bar=int(outside.sum()),
               rows_less_accurate_than_twin=int(worse.sum()),
               mean_abs_err_vs_f32=float(np.abs(got - ref).mean()),
               twin_mean_abs_err_vs_f32=float(np.abs(twin - ref).mean()))
    check(bool(np.isfinite(got).all()), f"{tag} finite")
    check(not worse.any(), f"{tag}: every row within the bar of the twin or as accurate "
                           f"against f32 ({rec})")
    return rec


def kw_multi_phase(dev) -> dict:
    """The multi-block KW bitwise its plain version at config 1's 65,536
    rows and at 262,144 rows on one slot (4,096 streams, window 32, the bf16
    wire, Zipf repeats bursting past W), and bitwise the one-block KW at
    16,384 rows (both forms forced on the same flush), each timed beside
    its byte bound and its plain version. The 65,536-row record is the
    kernels line's, the others its ``shapes``."""
    import torch

    from sitewhere_tpu_torch.ops.windows import WindowState, window_update, window_update_plain

    recs = []
    for b in KW_MULTI_ROWS:
        _, base, ids_np, ids, vals, counts, _ = ring_flush(dev, 1, b, C1_STREAMS, WINDOW, b % 997)
        vals = vals.to(torch.bfloat16)

        def clone(st):
            return WindowState(*(x.clone() for x in st))

        st_k, st_p = clone(base), clone(base)
        later_k = window_update(st_k, ids, vals, counts=counts, route="multi")
        later_p = window_update_plain(st_p, ids, vals, counts=counts)
        torch.cuda.synchronize()
        tag = f"KW multi-block at {b} rows"
        check(torch.equal(later_k, later_p), f"{tag}: later bitwise")
        for name, a, c in zip(("values", "pos", "count"), st_k, st_p):
            check(torch.equal(a, c), f"{tag}: {name} bitwise")
        scratch = clone(base)
        ms = cuda_time_ms(lambda: window_update(scratch, ids, vals, counts=counts,
                                                route="multi"), 20)
        scratch = clone(base)
        plain_ms = cuda_time_ms(lambda: window_update_plain(scratch, ids, vals, counts=counts),
                                3, 1)
        per_stream = np.unique(ids_np, return_counts=True)[1]
        nbytes = b * (2 + 2 + 4) + 4 + len(per_stream) * 16 + \
            int(np.minimum(per_stream, WINDOW).sum()) * 4
        rec = dict(shape=f"1x{b} rows, {C1_STREAMS} streams", rows=b, max_abs_err=0.0, ms=ms,
                   plain_ms=plain_ms, **_bound(nbytes, 0.0, BF16_FLOPS), library_ms=None,
                   streams_touched=len(per_stream), longest_burst=int(per_stream.max()))
        if b <= 16384:
            st_b = clone(base)
            later_b = window_update(st_b, ids, vals, counts=counts, route="block")
            torch.cuda.synchronize()
            check(torch.equal(later_b, later_k) and all(
                torch.equal(a, c) for a, c in zip(st_b, st_k)),
                f"{tag}: bitwise the one-block KW")
            scratch = clone(base)
            rec["one_block_ms"] = cuda_time_ms(
                lambda: window_update(scratch, ids, vals, counts=counts, route="block"), 20)
        emit({"phase": "kernel", "name": "window_update_multi", **rec})
        recs.append(rec)
    return dict(recs[0], shapes=recs[1:])


def wide_window_phase(dev, family: str, hidden: int, w: int, fmt: str, t: int, b: int,
                      dtype: str, seed: int) -> dict:
    """KS or KD in windows mode (``score_stacked``, K = 1) at ``hidden`` and
    window ``w`` on the ``fmt`` serving tree of ``t`` default-init slots,
    ``t`` x ``b`` random-walk windows, against its plain version: bf16
    compute at the bf16 bar, f32 compute per row at 2e-4. Timed beside its
    bound."""
    import torch

    from sitewhere_tpu_torch.models import deepar, get_model, lstm_ad, make_config
    from sitewhere_tpu_torch.models.common import quantize_params

    spec = get_model(family)
    cfg = make_config(family, {"hidden": hidden, "window": w, "dtype": dtype})
    q = quantize_params(stacked_trees(spec, cfg, dev, t, seed), fmt)
    gen = torch.Generator(dev).manual_seed(seed)
    wins = torch.randn((t, b, w), generator=gen, device=dev).cumsum(-1)
    nv = torch.randint(0, w + 1, (t, b), generator=gen, device=dev, dtype=torch.int32)
    plain = (lstm_ad if family == "lstm_ad" else deepar).score_stacked_plain
    got = spec.score_stacked(q, cfg, wins, nv)
    want = plain(q, cfg, wins, nv)
    torch.cuda.synchronize()
    name = scan_kernel(family, hidden, w)
    tag = f"{name}[h{hidden},{fmt}] windows {t}x{b}x{w} {dtype}"
    extra = {}
    if family == "deepar" and dtype == "bfloat16":
        c32 = make_config(family, {"hidden": hidden, "window": w, "dtype": "float32"})
        extra = held_or_as_accurate(tag, got.cpu(), want.cpu(), plain(q, c32, wins, nv).cpu())
        err = float((got - want).abs().max())
    else:
        err = _held(tag, got, want, TOL if dtype == "bfloat16" else TF32_TOL)
    check(bool((got != 0).any()), f"{tag} scored")
    ms = cuda_time_ms(lambda: spec.score_stacked(q, cfg, wins, nv), 3, 1)
    plain_ms = cuda_time_ms(lambda: plain(q, cfg, wins, nv), 1, 1)
    flops = t * b * spec.flops_per_row(cfg, w, k=1, param_dtype=fmt)
    nbytes = t * b * (w * 4 + 4 + 4) + weight_bytes(q)
    rec = dict(shape=f"windows {t}x{b}, w{w}, {dtype}", variant=f"h{hidden},{fmt}", window=w,
               dtype=dtype, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **_bound(nbytes, flops, BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS),
               library_ms=None, flops=flops, **extra)
    emit({"phase": "kernel", "name": name, **rec})
    return dict(rec, name=name)


def config1_drive(mm, dev, rng, seed: int, seq0: int):
    """Main path l, config 1's flush: one slot of 4,096 streams, LSTM-AD at
    window 32, hidden 64, f32 params, bf16 compute, the bf16 wire, K = 1:
    8 full flushes of 65,536 rows (Zipf repeats, hot streams past W)
    through ``drive`` (KW's multi-block form, KS, KH, KG; every plain
    version set to raise), held against a plain twin (state bitwise,
    scores at the bf16 bar) and shown rejecting a twin with wh's i and f
    gate blocks swapped. Returns (launches, variant launches, device ms a
    flush)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    spec = get_model("lstm_ad")
    cfg = make_config("lstm_ad", {"window": WINDOW, "hidden": HIDDEN})
    tree = spec.init(torch.Generator().manual_seed(18 + seed), cfg, device=dev)
    kern, twin = (ShardedScorer(mm, spec, cfg, slots_per_shard=1, max_streams=C1_STREAMS,
                                window=WINDOW, wire_dtype="bf16", fuse_k=1, plain=plain)
                  for plain in (False, True))
    for sc in (kern, twin):
        sc.activate(0, params=tree)
    rec: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main = drive(kern, C1_FLUSHES, rng, seq0, rec, b=C1_ROWS, fill=True)
    counts, variants = kernels.launches(), kernels.variant_launches()
    for name in ("window_update_multi", "lstm_score", "score_sketch", "gather_rows"):
        check(counts[name] > 0, f"config 1's flush launched {name}")
    check(counts["window_update"] == 0, "config 1's flush ran no one-block KW")
    rows = [int(c.sum()) for _, _, c, _ in rec]
    check(rows[:C1_FLUSHES] == [C1_ROWS] * C1_FLUSHES, f"config 1's 8 flushes full ({rows})")
    err, _ = twin_check(kern, twin, rec, main["host"], "config 1 flush")
    outside = fault_rows(mm, spec, cfg, twin, rec, main["host"], swapped_gates,
                         "config 1 flush")
    emit({"phase": "main_path", "family": "lstm_ad", "path": "config1 flush",
          "flushes": main["flushes"], "rows": main["rows"], "rows_per_flush": rows,
          "device_ms_per_flush": main["device_ms"], "protocol_s": main["protocol_s"],
          "traffic_gen_s": main["gen_s"], "twin_max_abs_err": err,
          "fault_rows_outside_bar": outside, "launches": counts, "variant_launches": variants})
    del kern, twin
    torch.cuda.empty_cache()
    return counts, variants, main["device_ms"]


def kf_drive(dev, spec, params: dict, windows, seed: int):
    """Main path m's forecast: config 3's 64 series at context 168,
    horizon 24, through ``forecast`` with a seeded generator at each
    ``KF_MAIN`` (hidden, samples): finite, within the series' range +- 10,
    each launching its KF form's variant. Returns (launches, variant
    launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import make_config

    launches, variants = {}, {}
    lo, hi = float(windows.min()), float(windows.max())
    for hid, ns in KF_MAIN:
        cfg = make_config("deepar", {"context": KF_CONTEXT, "hidden": hid, "num_samples": ns})
        kernels.reset_launches()
        samples, mean = spec.forecast(params[hid], cfg, windows,
                                      torch.Generator(dev).manual_seed(2026 + seed))
        torch.cuda.synchronize()
        counts, vc = kernels.launches(), kernels.variant_launches()
        check(vc.get(f"deepar_forecast_wide[h{hid},s{ns}]", 0) == 1,
              f"forecast at hidden {hid}, {ns} samples launched KF's wide form")
        check(tuple(samples.shape) == (ns, windows.shape[0], cfg.horizon)
              and bool(torch.isfinite(samples).all()) and lo - 10 < float(mean.min())
              and float(mean.max()) < hi + 10,
              f"forecast at hidden {hid}, {ns} samples: finite, in range")
        emit({"phase": "main_path", "family": "deepar", "path": "forecast", "hidden": hid,
              "context": KF_CONTEXT, "samples": ns, "series": int(windows.shape[0]),
              "mean_range": [float(mean.min()), float(mean.max())], "launches": counts})
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n
        for key, n in vc.items():
            variants[key] = variants.get(key, 0) + n
    return launches, variants


# -- the attention families past their caps (KE raw, KA split, KT) --------------------

# main path n: a day of a 1 Hz sensor for each of 64 series (BASELINE config
# 3's series count), and 8 series at the route's edges and at a million points
KE_RAW_MAIN = (64, 86_400)
KE_RAW_SHAPES = (KE_RAW_MAIN, (8, 4096), (8, 4097), (8, 1_000_003))
KE_FAULT_TAIL = 4096  # the faulted KE normalizes over only the last 4,096 values


def raw_histories(dev, n: int, length: int, seed: int):
    """``n`` raw 1 Hz histories of ``length`` points, made on the card: a
    daily cycle of +-4 around a level 20 + i (a temperature sensor), a slow
    drift and N(0, 0.3) noise from ``seed``; f32[n, length]."""
    import math

    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(length, device=dev, dtype=torch.float64)
    x = (20.0 + torch.arange(n, device=dev, dtype=torch.float64)[:, None]
         + 4.0 * torch.sin(2 * math.pi * t / 86400.0)[None] + 1e-5 * t[None]
         + 0.3 * torch.randn((n, length), generator=gen, device=dev, dtype=torch.float64))
    return x.float()


def ke_raw_check(raw, context: int, ctx, mu, sigma, tol: float = TF32_TOL) -> dict:
    """KE's normalization of raw histories against a float64 one: the
    context per element within ``tol`` (abs + rel), mu within ``tol``
    sigma (its scale is the row's spread), sigma within ``tol`` relative.
    Returns each one's worst ratio to its bar and ``ok``; raises nothing."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    n64, mu64, sg64 = tc.normalize_windows(raw.double())
    c64 = tt._context(n64, context)
    mu64, sg64 = mu64[:, 0], sg64[:, 0]
    rec = dict(
        ctx_ratio_to_bar=float(((ctx.double() - c64).abs() / (tol + tol * c64.abs())).max()),
        mu_ratio_to_bar=float(((mu.double() - mu64).abs() / (tol * sg64)).max()),
        sigma_ratio_to_bar=float(((sigma.double() - sg64).abs() / (tol * sg64)).max()))
    finite = all(bool(torch.isfinite(a).all()) for a in (ctx, mu, sigma))
    rec["ok"] = finite and max(rec.values()) <= 1.0
    rec["ctx_max_abs_err"] = float((ctx.double() - c64).abs().max())
    return rec


def ke_last_4096_fault(params, cfg, raw):
    """A faulted KE (plain): the raw histories normalized over only their
    last ``KE_FAULT_TAIL`` values (the old form's row, cut) -> (tokens,
    ctx, mu, sigma)."""
    from sitewhere_tpu_torch.models import transformer as tt

    return tt.tf_embed_context_plain(params, cfg, raw=raw[:, -KE_FAULT_TAIL:])


def ke_raw_phase(dev, cfg, params, seed: int) -> dict:
    """KE over raw histories at every ``KE_RAW_SHAPES`` length by its route
    (``ke_raw_route``: the context mode up to 4,096 values, the raw form
    past): the context, mu and sigma against a float64 normalization
    (``ke_raw_check``, 2e-4), the bf16 tokens per element by
    ``held_or_as_accurate`` against the plain version and an f32 plain run,
    two runs bitwise; at main path n's shape the faulted KE
    (``ke_last_4096_fault``) shown failing the check. Timed beside the
    plain version and ``torch.std_mean(raw, dim=-1, correction=0)`` (the
    statistics alone); bound by bytes. The kernels line's record is main
    path n's shape, the others under ``shapes``."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    one = tc.tree_map(lambda a: a[None], params)
    f32 = dataclasses.replace(cfg, dtype="float32")
    c, d = cfg.context, cfg.dim
    recs = []
    for i, (b, length) in enumerate(KE_RAW_SHAPES):
        tag = f"ke_raw {b} x {length}"
        raw = raw_histories(dev, b, length, 100 + i + seed)
        route = tt.ke_raw_route(length)
        name = "tf_embed_raw" if route == "raw" else "tf_embed"
        kernels.reset_launches()
        x, ctx, mu, sg = tt.tf_embed_context(one, cfg, raw=raw)
        torch.cuda.synchronize()
        check(kernels.launches()[name] == 1 and sum(kernels.launches().values()) == 1,
              f"{tag}: the route launched {name} alone")
        again = tt.tf_embed_context(one, cfg, raw=raw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip((x, ctx, mu, sg), again)),
              f"{tag}: two runs bitwise")
        del again
        stats = ke_raw_check(raw, c, ctx, mu, sg)
        check(stats["ok"], f"{tag}: context, mu and sigma within 2e-4 of float64 ({stats})")
        xp, _, _, _ = tt.tf_embed_context_plain(one, cfg, raw=raw)
        x32 = tt.tf_embed_context_plain(one, f32, raw=raw)[0]
        tok = held_or_as_accurate(f"{tag} bf16 tokens", x.float().cpu().numpy(),
                                  xp.float().cpu().numpy(), x32.cpu().numpy())
        del xp, x32
        rec = dict(shape=tag, rows=b, length=length, route=route, name=name,
                   f64_ratio_to_bar=stats, tokens=tok, max_abs_err=stats["ctx_max_abs_err"],
                   error_kind="the normalized context vs float64")
        if i == 0:
            fault = ke_raw_check(raw, c, *ke_last_4096_fault(one, cfg, raw)[1:])
            check(not fault["ok"], f"{tag}: the check rejects KE normalizing over only the "
                                   f"last {KE_FAULT_TAIL} values ({fault})")
            rec["fault_last_4096"] = fault
        nbytes = raw.numel() * 4 + x.numel() * x.element_size() + b * c * 4 + b * 8
        rec.update(
            ms=cuda_time_ms(lambda: tt.tf_embed_context(one, cfg, raw=raw), 10, 2),
            plain_ms=cuda_time_ms(lambda: tt.tf_embed_context_plain(one, cfg, raw=raw), 3, 1),
            library_ms=cuda_time_ms(lambda: torch.std_mean(raw, dim=-1, correction=0), 10, 2),
            library="torch.std_mean(raw, dim=-1, correction=0) (the statistics alone)",
            **_bound(nbytes, 0.0, BF16_FLOPS, f32_flops=4.0 * raw.numel() + 3.0 * b * c * d))
        emit({"phase": "kernel", **rec})
        recs.append(rec)
        del raw, x, ctx, mu, sg
        torch.cuda.empty_cache()
    main = dict(recs[0])
    main["shapes"] = recs[1:]
    return main


# KA's split form alone: (tag, N, T, heads, hd, causal); the first is main
# path p's (transformer32 at dim 512, one head: 32 x 2,048 windows of 31
# tokens), the rest hd 288 (two heads), 300 (not a multiple of 32) and 512,
# causal at T 31 and non-causal at ViT-B/16's T 197
SPLIT_SHAPES = (
    ("p_hd512_t31", 65536, 31, 1, 512, True),
    ("hd288_t31", 4096, 31, 2, 288, True),
    ("hd300_t31", 4096, 31, 1, 300, True),
    ("hd512_t197", 64, 197, 1, 512, False),
    ("hd288_t197", 64, 197, 2, 288, False),
    ("hd300_t197", 64, 197, 1, 300, False),
)
SPLIT_F32_SEQS = 16384  # the f32 runs' sequences at most (main path p's in bf16: 65,536)
SPLIT_CHECK_ELEMENTS = 1_000_000  # elements of a tensor the float64 and accuracy checks read


def attention_own_columns_fault(q, k, v, heads: int, causal: bool, dout=None):
    """A faulted split KA (plain): each 256-column chunk's block forms its
    logits from its own columns of q and k only, then p.v for its columns
    (the full head dim's 1/sqrt(hd) scale kept). With ``dout``, also the
    backward such blocks would form (each chunk's dp, dq, dk, dv from its
    own columns) -> (out, (dq, dk, dv))."""
    import math

    import torch

    from sitewhere_tpu_torch.models import common as tc

    n, t, d = q.shape
    hd = d // heads
    parts, grads = [], []
    for c0 in range(0, hd, tc.ATTN_SPLIT_CHUNK):
        cols = slice(c0, min(c0 + tc.ATTN_SPLIT_CHUNK, hd))
        qh, kh, vh = (a.reshape(n, t, heads, hd)[..., cols] for a in (q, k, v))
        w = cols.stop - cols.start
        # attn_core scales by 1/sqrt(w): undo it and apply the full head's
        alpha = math.sqrt(w / hd)
        o = tc.attn_core(qh * alpha, kh, vh, causal, q.dtype)
        parts.append(o.reshape(n, t, heads, w))
        if dout is not None:
            sub = [x.reshape(n, t, heads * w) for x in (qh * alpha, kh, vh,
                                                         dout.reshape(n, t, heads, hd)[..., cols])]
            dq, dk, dv = tc.attention_bwd_plain(*sub, heads, causal)
            dq = (dq.float() * alpha).to(q.dtype)  # the gradient of q, not of q * alpha
            grads.append([x.reshape(n, t, heads, w) for x in (dq, dk, dv)])
    out = torch.cat(parts, -1).reshape(n, t, d)
    if dout is None:
        return out
    return out, tuple(torch.cat([g[i] for g in grads], -1).reshape(n, t, d) for i in range(3))


def sdpa_backend(qh, kh, vh, causal: bool):
    """The first of SDPA's fused backends (flash, memory-efficient, cuDNN)
    that takes q, k, v [N, heads, T, hd], or None."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([be]):
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
            torch.cuda.synchronize()
            return be
        except RuntimeError:
            continue
    return None


def split_attention_phase(dev) -> dict:
    """KA's split forward and backward at every ``SPLIT_SHAPES`` shape, bf16
    and f32: routed there by ``attn_route`` (``attention``,
    ``attention_bwd``); f32 per element within 2e-4 of the float64 plain
    version (the backward's atol scaled by the gradient's size), bf16 per
    element by ``held_or_as_accurate`` against the plain version and an f32
    plain run and its four outputs by ``tiled_f64_accuracy`` (on the first
    sequences, ``SPLIT_CHECK_ELEMENTS`` values), two runs bitwise (f32 on at
    most ``SPLIT_F32_SEQS`` sequences); at the first shape the faulted split
    (``attention_own_columns_fault``) shown failing the f32 bar, and in bf16
    it and ``tiled_fault_twin`` (the mask faulted from ``tiled_fault_t0``)
    failing the float64 bar. Timed beside the plain version and SDPA
    (forward, and backward through autograd) with the backend that takes
    the shape named; bound: bytes, or operations (2 products forward, 5
    backward) at the bf16 tensor or f32 rate; each record with its TFLOP/s,
    its time over the bound and (bf16) ``attn_split_plan``. Returns the
    kernels line's records of the forward and backward (main path p's
    shape, bf16), the rest under ``shapes``."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc

    gen = torch.Generator(device=dev).manual_seed(91)
    recs = {}
    for tag, n, t, heads, hd, causal in SPLIT_SHAPES:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            key = f"{tag} {'bf16' if dtype == torch.bfloat16 else 'f32'}"
            if dtype == torch.float32:
                n = min(n, SPLIT_F32_SEQS)
            q, k, v, do = (torch.randn((n, t, heads * hd), generator=gen, device=dev)
                           .to(dtype) for _ in range(4))
            kernels.reset_launches()
            o = tc.attention(q, k, v, heads, causal)
            g = tc.attention_bwd(q, k, v, do, heads, causal)
            torch.cuda.synchronize()
            counts = kernels.launches()
            check(counts["attention_split"] == 1 and counts["attention_split_bwd"] == 1
                  and sum(counts.values()) == 2, f"split KA {key}: the route launched the "
                                                 f"split forward and backward alone")
            o2 = tc.attention(q, k, v, heads, causal)
            g2 = tc.attention_bwd(q, k, v, do, heads, causal)
            torch.cuda.synchronize()
            check(torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(g, g2)),
                  f"split KA {key}: two runs bitwise")
            del o2, g2
            sub = slice(0, max(1, min(n, SPLIT_CHECK_ELEMENTS // (t * heads * hd))))
            qs_, ks_, vs_, ds_ = (a[sub] for a in (q, k, v, do))
            if dtype == torch.float32:
                q64, k64, v64, d64 = (a.double() for a in (qs_, ks_, vs_, ds_))
                want = tc.attention_plain(q64, k64, v64, heads, causal)
                fwd = _held(f"split KA {key} vs f64", o[sub], want.float(), TF32_TOL)
                bwd = {}
                for nm, a, w in zip(("dq", "dk", "dv"), g, tc.attention_bwd_plain(
                        q64, k64, v64, d64, heads, causal)):
                    bwd[nm] = _f32_grad_ratio(a[sub].double(), w)
                    check(bwd[nm] <= 1.0, f"split KA backward {key} {nm} per element vs f64 "
                                          f"(worst ratio to the bar {bwd[nm]})")
                errs = dict(fwd_max_abs_err_vs_f64=fwd, bwd_f32_worst_ratio_to_bar=bwd)
                if tag == SPLIT_SHAPES[0][0]:
                    bad = attention_own_columns_fault(qs_, ks_, vs_, heads, causal)
                    f_err = float((bad.double() - want).abs().max())
                    check(f_err > TF32_TOL, f"split KA {key}: the f32 bar rejects the chunk "
                                            f"blocks using only their own columns of q.k^T "
                                            f"(max abs err {f_err})")
                    errs["fault_own_columns_max_abs_err"] = f_err
                del q64, k64, v64, d64, want
            else:
                ref = tc.attention_plain(*(a.float() for a in (qs_, ks_, vs_)), heads, causal)
                twin = tc.attention_plain(qs_, ks_, vs_, heads, causal)
                fwd = held_or_as_accurate(f"split KA {key}", o[sub].float().cpu().numpy(),
                                          twin.float().cpu().numpy(), ref.cpu().numpy())
                bwd = {}
                for nm, a, tw, rf in zip(("dq", "dk", "dv"), g,
                                         tc.attention_bwd_plain(qs_, ks_, vs_, ds_, heads, causal),
                                         tc.attention_bwd_plain(*(x.float() for x in (
                                             qs_, ks_, vs_, ds_)), heads, causal)):
                    bwd[nm] = held_or_as_accurate(f"split KA backward {key} {nm}",
                                                  a[sub].float().cpu().numpy(),
                                                  tw.float().cpu().numpy(), rf.cpu().numpy())
                twin_g = tc.attention_bwd_plain(qs_, ks_, vs_, ds_, heads, causal)
                errs = dict(fwd=fwd, bwd=bwd, fwd_rel_norm=rel_norm(o[sub], twin),
                            fwd_max_abs_err=float((o[sub].float() - twin.float()).abs().max()),
                            bwd_rel_norm=max(rel_norm(a[sub], b) for a, b in zip(g, twin_g)))
                # held by float64 error (tensor cores sum in another order than
                # the plain version's products); at main path p's shape two
                # faulted twins shown failing the same bar
                q64, k64, v64, d64 = (a.double() for a in (qs_, ks_, vs_, ds_))
                f64 = (tc.attention_plain(q64, k64, v64, heads, causal),
                       *tc.attention_bwd_plain(q64, k64, v64, d64, heads, causal))
                del q64, k64, v64, d64
                plain = (twin, *twin_g)
                acc = tiled_f64_accuracy((o[sub], *(a[sub] for a in g)), plain, f64)
                check(acc["ok"], f"split KA {key}: as accurate against float64 as the bf16 plain "
                                 f"version ({acc['errors']})")
                errs["f64_mean_abs_err_kernel_plain"] = acc["errors"]
                if tag == SPLIT_SHAPES[0][0]:
                    t0 = tiled_fault_t0(t, causal)
                    faults = {
                        "own_columns": attention_own_columns_fault(qs_, ks_, vs_, heads, causal,
                                                                   ds_),
                        f"mask_from_key_{t0}": tiled_fault_twin(qs_, ks_, vs_, ds_, heads,
                                                                causal, t0)}
                    for fname, (fo, fg) in faults.items():
                        bad = tiled_f64_accuracy((fo, *fg), plain, f64)
                        check(not bad["ok"], f"split KA {key}: the float64 check rejects the "
                                             f"{fname} fault ({bad['errors']})")
                        errs[f"fault_{fname}_f64_mean_abs_err"] = bad["errors"]
                    del faults
                del ref, twin, twin_g, plain, f64
            del o, g, qs_, ks_, vs_, ds_
            torch.cuda.empty_cache()
            pairs = t * (t + 1) / 2 if causal else t * t
            elt = q.element_size()

            def bound(nbytes, flops):
                if dtype == torch.bfloat16:
                    return _bound(nbytes, flops, BF16_FLOPS)
                return _bound(nbytes, 0.0, BF16_FLOPS, f32_flops=flops)

            qh, kh, vh = (z.view(n, t, heads, hd).transpose(1, 2).detach().requires_grad_(True)
                          for z in (q, k, v))
            doh = do.view(n, t, heads, hd).transpose(1, 2)
            be = sdpa_backend(qh, kh, vh, causal)
            lib = [be] if be is not None else []

            def sdpa():
                if not lib:
                    return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
                with sdpa_kernel(lib):
                    return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

            lib_o = sdpa()
            rec = dict(
                shape=key, dims=[n, t, heads, hd], causal=causal, dtype=dname, **errs,
                ms=cuda_time_ms(lambda: tc.attention(q, k, v, heads, causal), 3, 1),
                plain_ms=cuda_time_ms(lambda: tc.attention_plain(q, k, v, heads, causal), 1, 1),
                library_ms=cuda_time_ms(sdpa, 5, 1),
                **bound(4 * q.numel() * elt, 2 * 2.0 * hd * pairs * heads * n),
                bwd_ms=cuda_time_ms(lambda: tc.attention_bwd(q, k, v, do, heads, causal), 2, 1),
                bwd_plain_ms=cuda_time_ms(
                    lambda: tc.attention_bwd_plain(q, k, v, do, heads, causal), 1, 1),
                bwd_library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    lib_o, (qh, kh, vh), doh, retain_graph=True), 3, 1),
                library=("scaled_dot_product_attention, backend "
                         + (be.name if be is not None else
                            "none fused (the math composition timed)")
                         + "; its backward through autograd"),
            )
            fwd_flops, bwd_flops = 2 * 2.0 * hd * pairs * heads * n, 5 * 2.0 * hd * pairs * heads * n
            b = bound(7 * q.numel() * elt, bwd_flops)
            rec.update(bwd_bound_ms=b["bound_ms"], bwd_bound_by=b["bound_by"],
                       tflops=fwd_flops / rec["ms"] / 1e9, bwd_tflops=bwd_flops / rec["bwd_ms"] / 1e9,
                       ms_over_bound=rec["ms"] / rec["bound_ms"],
                       bwd_ms_over_bound=rec["bwd_ms"] / b["bound_ms"],
                       plan=tc.attn_split_plan(t, hd) if dtype == torch.bfloat16 else None)
            del qh, kh, vh, doh, lib_o, q, k, v, do
            torch.cuda.empty_cache()
            emit({"phase": "kernel", "name": "attention_split", **rec})
            recs[key] = rec
    main = recs[f"{SPLIT_SHAPES[0][0]} bf16"]
    shapes = {key: {k_: r[k_] for k_ in ("ms", "bwd_ms", "plain_ms", "bwd_plain_ms", "bound_ms",
                                         "bwd_bound_ms", "library_ms", "bwd_library_ms",
                                         "library", "tflops", "bwd_tflops", "ms_over_bound",
                                         "bwd_ms_over_bound")}
              for key, r in recs.items()}
    f64 = main["f64_mean_abs_err_kernel_plain"]
    fwd = dict(max_abs_err=main["fwd_max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=main["library_ms"], library=main["library"], tflops=main["tflops"],
               ms_over_bound=main["ms_over_bound"], f64_mean_abs_err_kernel_plain=f64["out"],
               plan=main["plan"], shape=main["shape"], shapes=shapes)
    bwd = dict(max_abs_err=main["bwd_rel_norm"], error_kind="relative norm", ms=main["bwd_ms"],
               plain_ms=main["bwd_plain_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"], library_ms=main["bwd_library_ms"],
               library=main["library"], tflops=main["bwd_tflops"],
               ms_over_bound=main["bwd_ms_over_bound"],
               f64_mean_abs_err_kernel_plain={n_: f64[n_] for n_ in ("dq", "dk", "dv")},
               shape=main["shape"])
    return {"attention_split": fwd, "attention_split_bwd": bwd}


STAGED_MAIN = (("transformer32", 65536, 31, 4, 32, True), ("vit_b16", 64, 197, 12, 64, False),
               ("transformer_replay", 128, 128, 4, 32, True))  # K11's forecast step
STAGED_BOUNDARY_T = (1, 8, 16, 17, 31, 32, 33, 64, 65, 128, 197, 391, 416, 512)
STAGED_CHECK_ELEMENTS = 1_000_000  # elements of a tensor the float64 check reads
STAGED_TIME_ELEMENTS = 1 << 23     # elements of a tensor at a boundary T's timing


def staged_sass_census(funcs) -> dict:
    """What the built library runs the staged KA on, from its
    ``sass_functions``: per kernel (the bf16 ones ``attention_staged_*_tc``,
    the f32 ones ``attention_kernel`` / ``attention_bwd_kernel``) and head
    dim, its ``_op_counts``; "ok": HGMMA in each of the 8 bf16 kernels, none
    in the 4 f32 ones, no HMMA anywhere."""
    import re

    out = {}
    for name, body in funcs:
        m = re.search(r"(attention_(?:staged_(?:bwd_)?(?:pack_)?tc|kernel|bwd_kernel))I(f)?Li(\d+)E",
                      name)
        if m is not None:
            out[f"{m.group(1)}<{'float, ' if m.group(2) else ''}{m.group(3)}>"] = _op_counts(body)
    bf16 = [c for k, c in out.items() if "_tc<" in k]
    f32 = [c for k, c in out.items() if "_tc<" not in k]
    ok = (len(bf16) == 8 and len(f32) == 4 and all(c["HGMMA"] > 0 for c in bf16)
          and all(c["HMMA"] == 0 for c in out.values()) and all(c["HGMMA"] == 0 for c in f32))
    return {"ok": ok, "kernels": out}


def _staged_f64(tag: str, q, k, v, do, heads: int, causal: bool, got) -> dict:
    """The bf16 staged KA's outputs (out, dq, dk, dv) on the first sequences
    by ``tiled_f64_accuracy``; the twins it must reject fail it: the causal
    leak (``tiled_fault_twin`` from ``tiled_fault_t0``; without a mask, the
    last 64 keys dropped) and at T <= 32 the packed tile's leak
    (``staged_pack_fault_twin``). Returns the errors."""
    from sitewhere_tpu_torch.models import common as tc

    n, t, d = q.shape
    sub = slice(0, max(1, min(n, STAGED_CHECK_ELEMENTS // (t * d))))
    qs, ks, vs, ds = (x[sub] for x in (q, k, v, do))
    w = [x.double() for x in (qs, ks, vs, ds)]
    ref = (tc.attention_plain(*w[:3], heads, causal), *tc.attention_bwd_plain(*w, heads, causal))
    plain = (tc.attention_plain(qs, ks, vs, heads, causal),
             *tc.attention_bwd_plain(qs, ks, vs, ds, heads, causal))
    acc = tiled_f64_accuracy(tuple(x[sub] for x in got), plain, ref)
    check(acc["ok"], f"staged KA {tag}: as accurate against float64 as the bf16 plain version "
                     f"({acc['errors']})")
    out = {"f64_mean_abs_err_kernel_plain": acc["errors"],
           "max_abs_err": float((got[0][sub].float() - plain[0].float()).abs().max()),
           "bwd_rel_norm": max(rel_norm(a[sub], b) for a, b in zip(got[1:], plain[1:]))}
    if t > 1:
        faults = {"causal_leak" if causal else "last_keys_dropped": tiled_fault_twin(
            qs, ks, vs, ds, heads, causal, tiled_fault_t0(t, causal))}
        if t <= 32:
            faults["packed_leak"] = staged_pack_fault_twin(qs, ks, vs, ds, heads, causal)
        for fname, (fo, fg) in faults.items():
            bad = tiled_f64_accuracy((fo, *fg), plain, ref)
            check(not bad["ok"], f"staged KA {tag}: the float64 check rejects the {fname} "
                                 f"fault ({bad['errors']})")
            out[f"fault_{fname}_f64_mean_abs_err"] = bad["errors"]
    return out


def staged_attention_phase(dev) -> dict:
    """The bf16 staged KA (tensor cores) through ``attention`` and
    ``attention_bwd``: at every ``STAGED_BOUNDARY_T``, head dims 32 and 64,
    causal and not, and at the main paths' shapes (``STAGED_MAIN``): the
    route launched it (its backward where ``attn_route`` keeps it staged),
    two runs bitwise, ``_staged_f64`` (the float64 bar, the faults failing
    it). Timed (CUDA events) beside the tiled and split forms called
    directly on the same tensors and the bound (bytes, or operations: 2
    products forward, 5 backward); at the main shapes also beside the plain
    version and SDPA (forward, and backward through autograd, with the
    backend that takes the shape named; none past 2^18 sequence-heads,
    which SDPA's backward refuses), and the staged and tiled calls' device
    time under torch.profiler (``device_ms``: at the forecast's small shape
    the CUDA-event times are the host's launch time). Each record with its
    TFLOP/s, time over the bound and ``attn_staged_plan``. Returns {"main":
    {tag: record}, "boundary": {key: record}}."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc

    gen = torch.Generator(device=dev).manual_seed(92)
    bf16 = torch.bfloat16

    def run(tag, n, t, heads, hd, causal, main):
        q, k, v, do = (torch.randn((n, t, heads * hd), generator=gen, device=dev).to(bf16)
                       for _ in range(4))
        staged_bwd = tc.attn_route(True, bf16, hd, t) == "staged"
        kernels.reset_launches()
        o = tc.attention(q, k, v, heads, causal)
        g = tc.attention_bwd(q, k, v, do, heads, causal)
        torch.cuda.synchronize()
        counts = kernels.launches()
        check(counts["attention"] == 1 and counts["attention_bwd"] == int(staged_bwd),
              f"staged KA {tag}: the route launched the staged forward (and backward: "
              f"{staged_bwd}) ({counts})")
        o2 = tc.attention(q, k, v, heads, causal)
        g2 = tc.attention_bwd(q, k, v, do, heads, causal)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and all(torch.equal(a, b) for a, b in zip(g, g2)),
              f"staged KA {tag}: two runs bitwise")
        del o2, g2
        rec = dict(dims=[n, t, heads, hd], causal=causal, plan=tc.attn_staged_plan(t, hd),
                   variant=tc.attn_staged_variant(bf16, hd, t),
                   **_staged_f64(tag, q, k, v, do, heads, causal, (o, *g)))
        del o, g
        if not main:  # time at a size the card fills
            n = max(1, STAGED_TIME_ELEMENTS // (t * heads * hd))
            q, k, v, do = (torch.randn((n, t, heads * hd), generator=gen, device=dev).to(bf16)
                           for _ in range(4))
            rec["timed_dims"] = [n, t, heads, hd]
        it = 10
        pairs = t * (t + 1) / 2 if causal else t * t
        fwd_flops, bwd_flops = 2 * 2.0 * hd * pairs * heads * n, 5 * 2.0 * hd * pairs * heads * n
        rec.update(
            ms=cuda_time_ms(lambda: tc.attention(q, k, v, heads, causal), it),
            bwd_ms=cuda_time_ms(lambda: tc.attention_bwd(q, k, v, do, heads, causal), it),
            tiled_ms=cuda_time_ms(lambda: tc.attention_tiled(q, k, v, heads, causal), it),
            tiled_bwd_ms=cuda_time_ms(lambda: tc.attention_tiled_bwd(q, k, v, do, heads, causal),
                                      it),
            **_bound(4 * q.numel() * 2, fwd_flops, BF16_FLOPS))
        b = _bound(7 * q.numel() * 2, bwd_flops, BF16_FLOPS)
        rec.update(bwd_bound_ms=b["bound_ms"], bwd_bound_by=b["bound_by"],
                   tflops=fwd_flops / rec["ms"] / 1e9, bwd_tflops=bwd_flops / rec["bwd_ms"] / 1e9,
                   ms_over_bound=rec["ms"] / rec["bound_ms"],
                   bwd_ms_over_bound=rec["bwd_ms"] / b["bound_ms"],
                   beats_tiled=[rec["ms"] < rec["tiled_ms"], rec["bwd_ms"] < rec["tiled_bwd_ms"]])
        if main:
            qh, kh, vh = (z.view(n, t, heads, hd).transpose(1, 2).detach().requires_grad_(True)
                          for z in (q, k, v))
            doh = do.view(n, t, heads, hd).transpose(1, 2)
            be = sdpa_backend(qh, kh, vh, causal)
            lib = [be] if be is not None else []

            def sdpa():
                if not lib:
                    return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
                with sdpa_kernel(lib):
                    return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

            lib_o = sdpa()
            lib_bwd = n * heads < 2 ** 18

            def device_ms(fn, reps=5):
                # a call's device time, host launch time apart: each of its
                # kernels' mean over the launches the profiler caught (it
                # can miss the first of a window)
                rows = device_rows(lambda: [fn() for _ in range(reps)])
                return sum(ms / n for _name, ms, n in rows) if rows else None

            rec["device_ms"] = dict(
                staged=device_ms(lambda: tc.attention(q, k, v, heads, causal)),
                staged_bwd=device_ms(lambda: tc.attention_bwd(q, k, v, do, heads, causal)),
                tiled=device_ms(lambda: tc.attention_tiled(q, k, v, heads, causal)),
                tiled_bwd=device_ms(lambda: tc.attention_tiled_bwd(q, k, v, do, heads, causal)))
            rec.update(
                split_ms=cuda_time_ms(lambda: tc.attention_split(q, k, v, heads, causal), it),
                split_bwd_ms=cuda_time_ms(
                    lambda: tc.attention_split_bwd(q, k, v, do, heads, causal), it),
                plain_ms=cuda_time_ms(lambda: tc.attention_plain(q, k, v, heads, causal), 2, 1),
                bwd_plain_ms=cuda_time_ms(
                    lambda: tc.attention_bwd_plain(q, k, v, do, heads, causal), 2, 1),
                library_ms=cuda_time_ms(sdpa, it),
                bwd_library_ms=cuda_time_ms(lambda: torch.autograd.grad(
                    lib_o, (qh, kh, vh), doh, retain_graph=True), it) if lib_bwd else None,
                library=("scaled_dot_product_attention, backend "
                         + (be.name if be is not None else "none fused (the math composition)")
                         + ("; its backward through autograd" if lib_bwd else
                            "; its backward refused at this shape")))
            del qh, kh, vh, doh, lib_o
        del q, k, v, do
        torch.cuda.empty_cache()
        emit({"phase": "kernel", "name": "attention_staged", "shape": tag, **rec})
        return rec

    main = {tag: run(tag, n, t, heads, hd, causal, True)
            for tag, n, t, heads, hd, causal in STAGED_MAIN}
    boundary = {}
    for hd in (32, 64):
        heads = 4 if hd == 32 else 2
        for t in STAGED_BOUNDARY_T:
            for causal in (True, False):
                key = f"hd{hd}_t{t}{'_causal' if causal else ''}"
                n = max(1, STAGED_CHECK_ELEMENTS // (t * heads * hd))
                boundary[key] = run(key, n, t, heads, hd, causal, False)
    return {"main": main, "boundary": boundary}


def staged_records(recs: dict, results: dict) -> dict:
    """The staged phase's records onto the kernels line's ``attention`` and
    ``attention_bwd`` entries (transformer32's records, the pack form at hd
    32; every staged-phase shape under the forward's ``shapes``). Returns
    the other bf16 forms as those entries' ``variants``: ViT-B/16's staged hd
    64 and the forecast's staged hd 32 at T 128; the backward's ViT hd 64."""
    keys = ("ms", "bwd_ms", "tiled_ms", "tiled_bwd_ms", "split_ms", "split_bwd_ms", "plain_ms",
            "bwd_plain_ms", "bound_ms", "bwd_bound_ms", "library_ms", "bwd_library_ms", "tflops",
            "bwd_tflops", "ms_over_bound", "bwd_ms_over_bound", "beats_tiled", "device_ms",
            "variant")
    shapes = {tag: {k_: r[k_] for k_ in keys if k_ in r}
              for tag, r in (*recs["main"].items(), *recs["boundary"].items())}
    fwd, bwd = results["transformer32"]["attention"], results["transformer32_train"]["attention_bwd"]
    fwd.update(variant=recs["main"]["transformer32"]["variant"], shapes=shapes)
    bwd.update(variant=recs["main"]["transformer32"]["variant"])

    def variant(r, back: bool) -> dict:
        p = "bwd_" if back else ""
        return dict(variant=r["variant"], max_abs_err=r["bwd_rel_norm" if back else "max_abs_err"],
                    ms=r[f"{p}ms"], plain_ms=r[f"{p}plain_ms"], bound_ms=r[f"{p}bound_ms"],
                    bound_by=r[f"{p}bound_by"], library_ms=r[f"{p}library_ms"])

    return ({"attention": [variant(recs["main"][t], False) for t in ("vit_b16",
                                                                      "transformer_replay")],
             "attention_bwd": [variant(recs["main"]["vit_b16"], True)]})


KT_KS = (5, 64, 65, 100, 1000)  # KT's top-k alone: the argmax rounds to 64, the sort past
KT_TIE_PAIRS, KT_TIE_OFFSET = 100, 900  # classes c and c + 900 tie for c < 100


def tie_order_ok(ids, n_pairs: int = KT_TIE_PAIRS, offset: int = KT_TIE_OFFSET) -> bool:
    """Wherever both classes of a tied pair (c, c + offset), c < n_pairs,
    are among a frame's top-k ids, c comes first (``jax.lax.top_k``'s
    order on ties)."""
    import torch

    ids = ids.long().cpu()
    big = ids.shape[1] + 1
    pos = torch.full((ids.shape[0], max(int(ids.max()) + 1, offset + n_pairs)), big,
                     dtype=torch.long)
    pos.scatter_(1, ids, torch.arange(ids.shape[1]).expand_as(ids).contiguous())
    lo, hi = pos[:, :n_pairs], pos[:, offset:offset + n_pairs]
    both = (lo < big) & (hi < big)
    return bool((lo[both] < hi[both]).all())


def topk_ties_high_first(logits, k: int):
    """A faulted top-k (plain): the softmax's top ``k`` with ties broken
    higher index first -> (probs, ids int32)."""
    import torch

    from sitewhere_tpu_torch.models import vit as tv

    p = tv.softmax_plain(logits).flip(-1)
    pv, ix = torch.sort(p, dim=-1, descending=True, stable=True)
    return pv[:, :k].contiguous(), (p.shape[-1] - 1 - ix[:, :k]).to(torch.int32).contiguous()


def kt_phase(dev, params, seed: int) -> dict:
    """KT alone at config 5's batch (64 frames of ViT-B/16's final residual
    stream, 197 x 768; the head 768 x 1,000 with classes 900..999 copies of
    0..99, so 100 pairs tie exactly), at every ``KT_KS`` top-k, bf16 and f32
    compute, on the f32 head and a bf16-stored one: logits within the bar of
    the plain version (bf16) or 2e-4 of float64 (f32); the ids by
    ``topk_ids_check`` against the f32 plain logits; the first 64 of a
    top-1,000 bitwise KT's top-64; tied pairs lower index first
    (``tie_order_ok``: the fault ``topk_ties_high_first`` shown failing it);
    at bf16 compute the bf16-stored head's outputs bitwise the f32 head's.
    Timed beside the plain version and ``torch.topk(torch.softmax(logits,
    -1), k)``; bound by bytes. Returns (the kernels line's variant records:
    "sort,f32" at k 1,000, "argmax,bf16" at k 5; each k's record)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import vit as tv

    gen = torch.Generator(device=dev).manual_seed(92 + seed)
    ln_f = params["ln_f"]
    w = params["head"]["w"].clone()
    bias = params["head"]["b"].clone()
    w[:, KT_TIE_OFFSET:] = w[:, :KT_TIE_PAIRS]
    bias[KT_TIE_OFFSET:] = bias[:KT_TIE_PAIRS]
    d, c = w.shape
    recs, variants = {}, {}
    fault_done = False
    for cname in ("bfloat16", "float32"):
        cdt = getattr(torch, cname)
        x = torch.randn((VIT_BATCH, 197, d), generator=gen, device=dev).to(cdt)
        ref = tv.vit_head_plain(x.float(), ln_f, {"w": w, "b": bias}, 0)[0]
        for wname, head in (("f32", {"w": w, "b": bias}),
                            ("bf16", {"w": w.to(torch.bfloat16), "b": bias})):
            outs = {}
            for k in KT_KS:
                tag = f"KT {cname} compute, {wname} head, top-{k}"
                kernels.reset_launches()
                lg, pr, ids = tv.vit_head(x, ln_f, head, k)
                torch.cuda.synchronize()
                form = "sort" if k > tv.KT_ARGMAX_K else "argmax"
                check(kernels.variant_launches() == {f"vit_head[{form},{wname}]": 1},
                      f"{tag}: launched the {form} form")
                outs[k] = (lg, pr, ids)
                if cdt == torch.float32:
                    xd = x.double()
                    want = tv.vit_head_plain(xd, {n: a.double() for n, a in ln_f.items()},
                                             {"w": head["w"].double(), "b": bias.double()}, 0)[0]
                    lerr = _held(f"{tag} logits vs f64", lg, want.float(), TF32_TOL)
                else:
                    lerr = _held(f"{tag} logits", lg, tv.vit_head_plain(x, ln_f, head, 0)[0])
                ids_rec = topk_ids_check(tag, lg, pr, ids, ref)
                check(tie_order_ok(ids), f"{tag}: tied classes lower index first")
                check(bool((pr[:, 1:] <= pr[:, :-1]).all()), f"{tag}: descending probabilities")
                rec = dict(shape=f"vit_b16 64 x 197 x {d}, {c} classes", k=k, compute=cname,
                           head=wname, form=form, max_abs_err=lerr, ids=ids_rec)
                if k == KT_KS[-1] and not fault_done:
                    _, bad = topk_ties_high_first(lg, k)
                    check(not tie_order_ok(bad), f"{tag}: the tie check rejects a top-k "
                                                 f"breaking ties higher index first")
                    rec["fault_ties_high_first_rejected"] = True
                    fault_done = True
                nbytes = (VIT_BATCH * d * x.element_size() + w.numel() * head["w"].element_size()
                          + (2 * d + c) * 4 + VIT_BATCH * c * 4 + VIT_BATCH * k * 8)
                rec.update(
                    ms=cuda_time_ms(lambda k=k: tv.vit_head(x, ln_f, head, k), 20, 2),
                    plain_ms=cuda_time_ms(lambda k=k: tv.vit_head_plain(x, ln_f, head, k), 5, 1),
                    library_ms=cuda_time_ms(lambda k=k: torch.topk(torch.softmax(lg, -1), k),
                                            20, 2),
                    library="torch.topk(torch.softmax(logits, -1), k) (the epilogue alone)",
                    **_bound(nbytes, 2.0 * VIT_BATCH * d * c, BF16_FLOPS))
                emit({"phase": "kernel", "name": "vit_head", **rec})
                recs[(cname, wname, k)] = rec
            l64, p64, i64 = outs[64]
            lk, pk, ik = outs[KT_KS[-1]]
            check(torch.equal(pk[:, :64], p64) and torch.equal(ik[:, :64], i64)
                  and torch.equal(lk, l64),
                  f"KT {cname}, {wname} head: the first 64 of a top-1,000 bitwise the top-64")
            if wname == "bf16" and cdt == torch.bfloat16:
                f32_outs = {k: tv.vit_head(x, ln_f, {"w": w, "b": bias}, k) for k in (5, 1000)}
                check(all(torch.equal(a, b) for k in (5, 1000)
                          for a, b in zip(outs[k], f32_outs[k])),
                      "KT bf16 compute: a bf16-stored head's outputs bitwise the f32 head's")
        del x, ref
    variants["sort,f32"] = recs[("bfloat16", "f32", 1000)]
    variants["argmax,bf16"] = recs[("bfloat16", "bf16", 5)]
    return variants, recs


def ke_raw_drive(dev, spec, cfg, params, seed: int):
    """Main path n: ``get_model("transformer").forecast`` (the registry
    defaults: dim 128, depth 4, 4 heads, context 256, horizon 24, bf16) over
    the ``KE_RAW_SHAPES`` raw histories (64 series of a day at 1 Hz, 86,400
    points, 22 MB; 8 series each at 4,096, 4,097 and 1,000,003 points) with
    a seeded generator: the first step through KE's form by length (the
    raw form past 4,096), then KE's context mode, KL, KA, KU and KN each
    step. Checked: launches, shapes, finite, means within the series' range
    +- 10; on the same noise the first step against the plain forecast
    (the bf16 bar) and, at 86,400 points, every step in f32 compute
    teacher-forced at 2e-4 (``teacher_forced``). Returns (launches,
    variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import transformer as tt

    hz, depth = cfg.horizon, cfg.depth
    launches, variants, recs = {}, {}, []
    for i, (b, length) in enumerate(KE_RAW_SHAPES):
        tag = f"transformer forecast over {b} x {length} raw points"
        raw = raw_histories(dev, b, length, 200 + i + seed)
        raw_form = int(tt.ke_raw_route(length) == "raw")
        kernels.reset_launches()
        t0 = time.perf_counter()
        samples, means = spec.forecast(params, cfg, raw,
                                       torch.Generator(dev).manual_seed(2100 + i + seed))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, vc = kernels.launches(), kernels.variant_launches()
        check(counts["tf_embed_raw"] == raw_form and counts["tf_embed"] == hz - raw_form,
              f"{tag}: KE's raw form {raw_form} time(s), its context mode the other steps")
        check(counts["tf_head"] == hz and counts["layernorm"] == 2 * depth * hz
              and counts["attention"] == depth * hz and counts["bias_gelu"] == depth * hz,
              f"{tag}: KN, KL, KA, KU each step ({counts})")
        check(tuple(samples.shape) == tuple(means.shape) == (b, hz)
              and bool(torch.isfinite(samples).all() and torch.isfinite(means).all()),
              f"{tag}: finite samples and means f32[{b}, {hz}]")
        lo, hi = float(raw.min()), float(raw.max())
        check(lo - 10 < float(means.min()) and float(means.max()) < hi + 10,
              f"{tag}: means within the series' range +- 10")
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v
        for n, v in vc.items():
            variants[n] = variants.get(n, 0) + v
        eps = torch.randn((hz, b), generator=torch.Generator(dev).manual_seed(7 + i), device=dev)
        ks, km = tt.forecast(params, cfg, raw, eps=eps)
        ps, pm = tt.forecast_plain(params, cfg, raw, eps)
        rec = dict(series=b, length=length, seconds=secs, raw_bytes=raw.numel() * 4,
                   first_step_err=_held(f"{tag}: first step vs the plain forecast",
                                        ks[:, 0], ps[:, 0]),
                   means_err=float((km - pm).abs().max()),
                   mean_range=[float(means.min()), float(means.max())], launches=counts)
        if i == 0:
            f32 = dataclasses.replace(cfg, dtype="float32")
            (a, am), (p, pm2) = teacher_forced(params, f32, raw, eps)
            rec["f32_teacher_forced_err"] = max(
                _held(f"{tag}: f32 samples, every step teacher-forced", a, p, TF32_TOL),
                _held(f"{tag}: f32 means, every step teacher-forced", am, pm2, TF32_TOL))
        emit({"phase": "main_path", "family": "transformer", "path": "forecast_raw", **rec})
        recs.append(rec)
        del raw, samples, means, ks, km, ps, pm
        torch.cuda.empty_cache()
    return launches, variants


VIT_TOPK_PATH = (65, 100, 1000)  # main path o's top-k (the sort form of KT)


def vit_topk_drive(dev, svc, params, frames: np.ndarray, wire):
    """Main path o: the 64 frames through ``StreamingMedia`` as u8 frames
    and on the compressed wire (4:2:0 at the main width) at top-k 65, 100
    and 1,000 (KT's sort form), each read back with ``topk_results`` and
    held to one forward's launches; each call's top-k bitwise
    ``models.vit.classify(_dct)``'s on the same input, its ids by
    ``topk_ids_check`` against an f32 plain forward, its first 64 bitwise a
    top-64 (KT's argmax rounds). Then the bf16-stored tree
    (``quantize_params(params, "bf16")``) served at top-5 by a second
    service: KT in its bf16-weight form, the top-5 bitwise the f32 tree's
    (at bf16 compute both trees round the weights to the same values).
    Returns (launches, variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.services.streaming_media import StreamingMedia

    cfg = tv.VIT_B16
    f32 = dataclasses.replace(cfg, dtype="float32")
    planes, lay = wire
    x = torch.from_numpy(frames).to(dev)
    pt = [torch.from_numpy(a).to(dev) for a in planes]
    paths = {
        "frames": ("frame_patches", lambda p, k, s: s.classify_frames_dispatch(frames, k),
                   lambda p, k: tv.classify(p, cfg, x, k)),
        "dct": ("dct_patches", lambda p, k, s: s.classify_coeffs_dispatch(*planes, lay, k),
                lambda p, k: tv.classify_dct(p, cfg, *pt, lay, k)),
    }
    ref = {"frames": tv.classify_plain(params, f32, x, 0)[0],
           "dct": tv.classify_dct_plain(params, f32, *pt, lay, 0)[0]}
    top64 = {path: direct(params, 64) for path, (_, _, direct) in paths.items()}
    launches, variants, recs = {}, {}, []

    def call(svc_, tree, path, k, form):
        first, dispatch, direct = paths[path]
        tag = f"vit_b16 {path} top-{k} ({form})"
        kernels.reset_launches()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        pv, iv = dispatch(tree, k, svc_)
        ev1.record()
        res = svc_.topk_results(pv, iv)
        counts, vc = kernels.launches(), kernels.variant_launches()
        want = {name: 0 for name in kernels.KERNELS}
        want.update(VIT_EXPECTED, **{first: 1})
        check(counts == want, f"{tag}: launches {counts}")
        check(vc.get(f"vit_head[{form}]", 0) == 1, f"{tag}: KT's {form} form ({vc})")
        ids = np.array([[i for i, _ in r] for r in res])
        probs = np.array([[q for _, q in r] for r in res])
        check(ids.shape == (frames.shape[0], k) and bool(np.isfinite(probs).all())
              and (probs >= 0).all() and (np.diff(probs, axis=1) <= 0).all()
              and ((ids >= 0) & (ids < cfg.num_classes)).all()
              and all(len(set(r)) == k for r in ids.tolist()),
              f"{tag}: a top-{k} a frame, finite descending probabilities, distinct ids")
        lg, pd, idd = direct(tree, k)
        check(np.array_equal(ids, idd.cpu().numpy())
              and np.array_equal(probs, pd.cpu().numpy().astype(np.float64)),
              f"{tag}: the service's top-k bitwise that of models.vit on the same input")
        for n, v in counts.items():
            launches[n] = launches.get(n, 0) + v
        for n, v in vc.items():
            variants[n] = variants.get(n, 0) + v
        return tag, lg, pd, idd, ev0.elapsed_time(ev1)

    for k in VIT_TOPK_PATH:
        for path in paths:
            tag, lg, pd, idd, ms = call(svc, params, path, k, "sort,f32")
            ids_rec = topk_ids_check(tag, lg, pd, idd, ref[path])
            _, p64, i64 = top64[path]
            check(torch.equal(pd[:, :64], p64) and torch.equal(idd[:, :64], i64),
                  f"{tag}: its first 64 bitwise KT's top-64")
            recs.append({"path": path, "k": k, "device_ms": ms, "ids_ok": ids_rec["ok"]})
    svc16 = StreamingMedia(device=dev)
    tree16 = tc.quantize_params(params, "bf16")
    svc16.load_classifier_params(tree16)
    for path in paths:
        tag, lg, pd, idd, ms = call(svc16, tree16, path, VIT_TOPK, "argmax,bf16")
        l32, p32, i32 = paths[path][2](params, VIT_TOPK)
        check(torch.equal(lg, l32) and torch.equal(pd, p32) and torch.equal(idd, i32),
              f"{tag}: the bf16-stored tree's logits and top-{VIT_TOPK} bitwise the f32 tree's")
        recs.append({"path": path, "k": VIT_TOPK, "tree": "bf16", "device_ms": ms})
    emit({"phase": "main_path", "family": "vit_b16", "path": "topk_and_bf16_tree",
          "frames": int(frames.shape[0]), "calls": recs})
    del svc16, tree16
    torch.cuda.empty_cache()
    return launches, variants


WIDE_HEAD = {"dim": 512, "heads": 1}  # main path p: head dim 512 (depth 4, the default)
WIDE_HEAD_FLUSHES = 2
WIDE_HEAD_CHECK_STREAMS = 1024  # streams the f32 and float64 train checks read
WIDE_HEAD_PLAIN_STREAMS = 2048  # streams the plain train version differentiates at once
WIDE_HEAD_REF_SLOTS = 8  # slots the f32 plain reference replays


def wide_head_slot_ok(got_rows: list, twin_rows: list, ref_rows: list, slots: list):
    """Path p's per-slot rule, bool per slot: at least half of the slot's
    scored rows within the f32 bar (2e-4) of the twin (``slot_agreement``,
    the transformer32 rule) or the slot's mean abs error against the f32
    plain scorer no more than 1.25x the twin's + 1e-3. At dim 512 two bf16
    flushes agree within 2e-4 on fewer of a slot's rows than at dim 128
    (under a third of them in a slot whose NLLs are large, where kernel and
    twin are equally far from f32), so agreement alone falls below its bar;
    a fault in a slot fails both."""
    k, p, r, s = (np.concatenate(x) for x in (got_rows, twin_rows, ref_rows, slots))
    n = int(s.max()) + 1
    rows = np.maximum(np.bincount(s, minlength=n), 1)
    ek, ep = (np.bincount(s, np.abs(a - r), n) / rows for a in (k, p))
    return (slot_agreement(k, p, s, n) >= 0.5) | (ek <= 1.25 * ep + 1e-3)


def wide_head_accuracy(tag: str, kern_rows: list, twin_rows: list, ref_rows: list,
                       slots: list) -> dict:
    """Path p's bf16 rule: pooled, the kernels' mean abs error against the
    f32 plain scorer no more than 1.25x the twin's + 1e-3 (as
    ``accuracy_check``); per slot, ``wide_head_slot_ok``."""
    rec = _accuracy(tag, kern_rows, twin_rows, ref_rows, slots, TOL)
    ok = wide_head_slot_ok(kern_rows, twin_rows, ref_rows, slots)
    rec["slot_ok"] = ok.tolist()
    emit({"phase": "accuracy", "tag": tag, **rec})
    check(rec["kernel_mean_abs_err"] <= 1.25 * rec["plain_mean_abs_err"] + 1e-3,
          f"{tag}: the kernels' scores as accurate as the plain version's "
          f"({rec['kernel_mean_abs_err']} vs {rec['plain_mean_abs_err']})")
    check(bool(ok.all()), f"{tag}: every slot agrees with the twin or is as accurate ({rec})")
    return rec


def wide_head_drive(mm, dev, rng, seed: int, seq0: int):
    """Main path p: the transformer at dim 512 with one head (hd 512; depth
    4, context 256, bf16) at transformer32's shape: a kernel scorer and its
    plain twin (32 slots x 8,192 streams, window 32, each slot its own
    weights, biases and affines), ``WIDE_HEAD_FLUSHES`` flushes through
    ``drive`` with every plain version set to raise (KA in its split form),
    held against the twin and an f32 plain scorer on slots 0-7
    (``wide_head_accuracy``, its per-slot rule shown rejecting
    ``fault_probe``'s two faulted flushes); then one train chunk (``train_chunk_slots`` slots x 8,192
    streams on the flushes' warmed rings: the family's ``loss_ring`` and
    its backward, KA's split backward), finite and timed; then, on a train
    plane's chunk of random walks (``train_rings``: the warmed rings have
    few rows past the 8-sample gate), against the plain version: on
    ``WIDE_HEAD_CHECK_STREAMS`` streams the f32 loss per row at 2e-4 and
    the f32 gradients as accurate as the plain version's against float64
    leaf by leaf; over the whole chunk the bf16 gradients within max(2e-2,
    1.25x the plain bf16 version's) of the f32 plain gradient. Returns
    (launches, variant launches)."""
    import types

    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models.train import ring_windows
    from sitewhere_tpu_torch.ops.windows import WindowState
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    spec, cfg = get_model("transformer"), make_config("transformer", WIDE_HEAD)
    t, _, s = SHAPES["transformer32"]
    tag = f"transformer dim {cfg.dim}, {cfg.heads} head (hd {cfg.dim // cfg.heads})"
    kern, twin = (ShardedScorer(mm, spec, cfg, slots_per_shard=t, max_streams=s, window=WINDOW,
                                plain=plain) for plain in (False, True))
    gen = torch.Generator().manual_seed(95 + seed)
    for slot in range(t):
        tree = own_affines(spec.init(gen, cfg, device=dev), gen)
        kern.activate(slot, params=tree)
        twin.activate(slot, params=tree)
    del tree
    f32 = dataclasses.replace(cfg, dtype="float32")
    rec: list = []
    kernels.reset_launches()
    with _NoPlain(kern):
        main = drive(kern, WIDE_HEAD_FLUSHES, rng, seq0, rec)
    counts, variants = kernels.launches(), kernels.variant_launches()
    check(counts["attention_split"] == cfg.depth * counts["tf_embed"] > 0
          and counts["attention"] == counts["attention_tiled"] == 0,
          f"{tag}: KA's split form every block of every flush ({counts})")
    _, twin_rows = twin_check(kern, twin, rec, main["host"], f"{tag} flush", False)
    # the f32 plain reference on the first WIDE_HEAD_REF_SLOTS slots (slots
    # are independent; its f32 flush of all 32 x 2,048 windows at dim 512
    # would hold ~70 GB of f32 intermediates): the record cut to those
    # slots, whose gathered rows come first (KG gathers in slot order)
    n_ref = WIDE_HEAD_REF_SLOTS
    sub = [(ids[:n_ref], vals[:n_ref], c[:n_ref], int(c[:n_ref].sum()))
           for ids, vals, c, _ in rec]
    torch.cuda.empty_cache()
    ref = ShardedScorer(mm, spec, f32, slots_per_shard=n_ref, max_streams=s, window=WINDOW,
                        plain=True)
    for slot in range(n_ref):
        ref.activate(slot, params=twin.slot_params(slot))
    ref_rows = replay(ref, sub)
    kern_sub = [h[0][:m] for h, (*_, m) in zip(main["host"], sub)]
    twin_sub = [r[:m] for r, (*_, m) in zip(twin_rows, sub)]
    acc = wide_head_accuracy(f"{tag}, bf16 vs f32 (slots 0-{n_ref - 1})", kern_sub, twin_sub,
                             ref_rows, slots_of(sub))
    # the per-slot rule's positive controls (fault_probe's two faulted plain
    # flushes) on the same slots
    faults = {}
    for name, (fs, spared) in tf_faulted_flushes(spec).items():
        fsc = ShardedScorer(mm, fs, cfg, slots_per_shard=n_ref, max_streams=s, window=WINDOW,
                            plain=True)
        for slot in range(n_ref):
            fsc.activate(slot, params=twin.slot_params(slot))
        ok = wide_head_slot_ok(replay(fsc, sub), twin_sub, ref_rows, slots_of(sub))
        faults[name] = ok.tolist()
        check(int(ok.sum()) <= spared, f"{tag}: the per-slot rule rejects the {name} fault "
                                       f"({ok.tolist()})")
        del fsc
    del ref
    emit({"phase": "fault_probe", "tag": tag, **faults})
    # one train chunk on the warmed rings
    chunk = kern.train_chunk_slots()
    sl = slice(0, chunk)
    ring = WindowState(*(x[sl] for x in kern.state))
    rows = train_rows(ring)
    params = tc.tree_map(lambda x: x[sl].detach(), kern.params)
    kernels.reset_launches()
    with _NoPlain(kern):
        loss_k, g_k = kernel_train_grads(spec, params, cfg, ring, rows)
    torch.cuda.synchronize()
    train_counts = kernels.launches()
    check(train_counts["attention_split_bwd"] == cfg.depth
          and train_counts["attention_split"] == cfg.depth,
          f"{tag} train chunk: KA's split forward and backward each block ({train_counts})")
    check(bool(torch.isfinite(loss_k).all()) and all(bool(torch.isfinite(g).all()) for g in g_k),
          f"{tag} train chunk: finite loss and gradients")
    del g_k
    ms = cuda_time_ms(lambda: kernel_train_grads(spec, params, cfg, ring, rows), 2, 1)
    warm_live = int(rows.sum())
    # held against the plain version on a chunk of the train plane (every
    # stream a random walk, most past the 8-sample gate, as tf_train_phase):
    # two flushes of Zipf traffic leave few of the warmed rings' streams
    # with 8 samples, too few rows for a leaf's relative-norm error
    ring = train_rings(dev, chunk, s, 97 + seed)
    rows = train_rows(ring)
    names = leaf_names(params)
    sub = WindowState(*(x[:, :WIDE_HEAD_CHECK_STREAMS].contiguous() for x in ring))
    rs = train_rows(sub)
    live = rs > 0

    def plain(p, c, r):
        return tt._train_loss(p, c, tt.TRAIN_PLAIN_OPS, windows=ring_windows(r))

    lk, gk32 = kernel_train_grads(spec, params, f32, sub, rs)
    lp, gp32 = row_chunked_grads(plain, params, f32, sub, rs, WIDE_HEAD_CHECK_STREAMS)
    loss_err = float((lk - lp)[live].abs().max())
    check(bool(torch.allclose(lk[live], lp[live], rtol=TF32_TOL, atol=TF32_TOL)),
          f"{tag} train chunk: f32 loss per trained row within 2e-4 ({loss_err})")
    c64 = types.SimpleNamespace(**dataclasses.asdict(f32), compute_dtype=torch.float64)
    _, g64 = row_chunked_grads(
        lambda p, c, r: tt._train_loss(p, c, tt.TRAIN_PLAIN_OPS, windows=ring_windows(r).double()),
        params, c64, sub, rs, WIDE_HEAD_CHECK_STREAMS)
    vs64 = {n: (rel_norm(a, r), rel_norm(b, r)) for n, a, b, r in zip(names, gk32, gp32, g64)}
    for n in names:
        if n.endswith("wk/b"):  # its exact gradient is 0: held by the bf16 rule's scale
            continue
        check(vs64[n][0] <= 1.25 * vs64[n][1] + 1e-6,
              f"{tag} train chunk: f32 grad {n} as accurate as the plain version's vs float64 "
              f"{vs64[n]}")
    del g64, gk32, gp32
    # bf16 over the whole chunk
    _, gk16 = kernel_train_grads(spec, params, cfg, ring, rows)
    _, gp16 = row_chunked_grads(plain, params, cfg, ring, rows, WIDE_HEAD_PLAIN_STREAMS)
    _, gp32 = row_chunked_grads(plain, params, f32, ring, rows, WIDE_HEAD_PLAIN_STREAMS)
    err_k, err_p = tf_bf16_errors(names, gk16, gp32), tf_bf16_errors(names, gp16, gp32)
    for n in names:
        check(err_k[n] <= max(TOL, 1.25 * err_p[n]),
              f"{tag} train chunk: bf16 grad {n}: kernel {err_k[n]} vs f32 (plain bf16 "
              f"{err_p[n]})")
    flops = 3.0 * chunk * s * spec.flops_per_row(cfg, WINDOW)
    emit({"phase": "main_path", "family": "transformer", "path": "wide_head", "dim": cfg.dim,
          "heads": cfg.heads, "flushes": main["flushes"], "rows": main["rows"],
          "device_ms_per_flush": main["device_ms"],
          "kernel_mean_abs_err": acc["kernel_mean_abs_err"],
          "plain_mean_abs_err": acc["plain_mean_abs_err"], "train_chunk_slots": chunk,
          "train_chunk_ms": ms, "train_chunk_flops": flops, "warm_live_rows": warm_live,
          "plain_check_live_rows": int(rows.sum()),
          "train_chunk_share_of_bf16_peak": flops / (ms / 1e3) / BF16_FLOPS,
          "train_f32_loss_max_abs_err": loss_err,
          "train_f32_rel_norm_vs_f64_kernel_plain": vs64,
          "train_bf16_rel_norm_vs_f32_kernel_plain": {n: (err_k[n], err_p[n]) for n in names},
          "launches": counts, "train_launches": train_counts})
    del kern, twin, params, ring, sub, gk16, gp16, gp32
    torch.cuda.empty_cache()
    total = {n: counts[n] + train_counts[n] for n in counts}
    return total, variants


# -- K3'c's last part: the global forms (the block state in global memory) ----------

# the widest hidden each wide form holds at 8 rows a block (its block state
# in shared memory); one more takes the global form
GLOBAL_CAPS = {"lstm_score": 1757, "gru_score": 2231, "deepar_forecast": 2233,
               "lstm_train": 784, "gru_train": 1017}
# the scan forms alone, window 32 on 2 slots x 256 rows: (family, hidden),
# the first width past each cap, an odd width and 4,096
GLOBAL_SCAN = (("lstm_ad", 1758), ("lstm_ad", 2049), ("lstm_ad", 4096), ("deepar", 2232))
GLOBAL_SCAN_PLANE = (2, 256)
# the train forms alone, window 32 on 2 slots x 1,024 streams: the first
# width past each cap
GLOBAL_TRAIN = (("lstm_ad", 785), ("deepar", 1018))
GLOBAL_TRAIN_STREAMS = 1024
# KF alone: the first width past its cap on config 3's first 16 windows
GLOBAL_KF = (2234, 16)
# main paths q and r: (family, hidden, SHAPES entry), window 32
WIDE_PATHS = (("lstm_ad", 2048, "q"), ("deepar", 2304, "r"))
# the streams of every slot the plain train version differentiates at once
# at the main paths' widths (its autograd holds a chunk's activations)
WIDE_PATH_PLAIN_ROWS = 512


def truncated_dot(cap: int):
    """A faulted tree (one slot's or stacked, any storage format): every
    recurrent weight row past ``cap`` zeroed, so the recurrent dot sums only
    the first ``cap`` units of h (the fault of a global form that read h
    from a state cut at its wide form's shared memory). Differentiable: a
    plain loss over it gives those rows no gradient."""
    def view(q):
        wh = q["wh"]
        key = "qw" if "qw" in wh else "w"
        w = wh[key].clone()
        w[..., cap:, :] = 0
        return dict(q, wh=dict(wh, **{key: w}))

    view.__name__ = f"truncated_dot_{cap}"
    return view


def truncated_loss(spec, cap: int):
    """The family's plain loss over ``truncated_dot(cap)`` of the params,
    for ``wide_train_phase``'s fault probe."""
    view = truncated_dot(cap)

    def loss(params, cfg, windows):
        return spec.loss_stacked_plain(view(params), cfg, windows)

    loss.__name__ = view.__name__
    return loss


def f64_tree(tree):
    """A param tree in float64, for the plain versions' float64 runs."""
    from sitewhere_tpu_torch.models import common as tc

    return tc.tree_map(lambda x: x.double(), tree)


def f64_cfg(cfg):
    """A recurrent config whose plain versions compute in float64."""
    import torch

    return types.SimpleNamespace(**dataclasses.asdict(cfg), compute_dtype=torch.float64)


def global_scan_phase(dev, family: str, hid: int, seed: int) -> dict:
    """KS's or KD's global form alone at ``hid`` (past its wide form's
    cap), window 32, on ``GLOBAL_SCAN_PLANE`` random-walk windows of
    default-init slots (windows mode, ``score_stacked``, K = 1): f32
    compute on the f32 masters per row within 2e-4 of a float64 plain run;
    bf16 compute on the f32, bf16 and int8 trees held by
    ``held_or_as_accurate`` (against the plain bf16 run, with an f32 plain
    run as the yardstick); two runs bitwise; a plain f32 run whose
    recurrent dot sums only the wide form's cap's units (``truncated_dot``)
    shown outside the f32 bar. Timed in both compute dtypes on the f32
    masters beside the bound (the bf16 record the kernels line's)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import deepar, get_model, lstm_ad, make_config
    from sitewhere_tpu_torch.models.common import quantize_params

    spec = get_model(family)
    name = SCORER[family][0]
    cap = GLOBAL_CAPS[name]
    (t, b), w = GLOBAL_SCAN_PLANE, WINDOW
    plain = (lstm_ad if family == "lstm_ad" else deepar).score_stacked_plain
    cfg = make_config(family, {"hidden": hid, "window": w})  # bf16 compute
    c32 = dataclasses.replace(cfg, dtype="float32")
    masters = stacked_trees(spec, cfg, dev, t, 120 + hid + seed)
    gen = torch.Generator(dev).manual_seed(130 + hid + seed)
    wins = torch.randn((t, b, w), generator=gen, device=dev).cumsum(-1)
    nv = torch.randint(4, w + 1, (t, b), generator=gen, device=dev, dtype=torch.int32)
    tag = f"{name}_global[h{hid}] windows {t}x{b}x{w}"
    kernels.reset_launches()
    got32 = spec.score_stacked(masters, c32, wins, nv)
    torch.cuda.synchronize()
    check(kernels.variant_launches() == {f"{name}_global[h{hid},f32]": 1},
          f"{tag}: the route launched the global form ({kernels.variant_launches()})")
    ref64 = plain(f64_tree(masters), f64_cfg(c32), wins.double(), nv)
    err64 = _held(f"{tag} f32 vs float64", got32, ref64, TF32_TOL)
    err32 = float((got32 - plain(masters, c32, wins, nv)).abs().max())
    check(bool((got32 != 0).any()), f"{tag} scored")
    faulted = plain(truncated_dot(cap)(masters), c32, wins, nv)
    outside = int((~torch.isclose(faulted, ref64.float(), rtol=TF32_TOL, atol=TF32_TOL)).sum())
    check(outside > 0, f"{tag}: the f32 bar rejects a recurrent dot over the first {cap} units")
    rec = dict(shape=f"windows {t}x{b}, w{w}", variant=f"h{hid},f32", f32_vs_f64_max_abs_err=err64,
               f32_vs_plain_max_abs_err=err32, fault_truncated_dot_rows_outside_bar=outside)
    for fmt in ("f32", "bf16", "int8"):
        q = quantize_params(masters, fmt)
        got = spec.score_stacked(q, cfg, wins, nv)
        twin = plain(q, cfg, wins, nv)
        acc = held_or_as_accurate(f"{tag} bf16 {fmt}", got.cpu(), twin.cpu(),
                                  plain(q, c32, wins, nv).cpu())
        check(torch.equal(got, spec.score_stacked(q, cfg, wins, nv)),
              f"{tag} bf16 {fmt}: two runs bitwise")
        rec[f"bf16_{fmt}"] = dict(acc, max_abs_err_vs_twin=float((got - twin).abs().max()))
    flops = t * b * spec.flops_per_row(cfg, w, k=1, param_dtype="f32")
    nbytes = t * b * (w * 4 + 4 + 4) + weight_bytes(masters)
    ms32 = cuda_time_ms(lambda: spec.score_stacked(masters, c32, wins, nv), 1, 1)
    rec.update(
        max_abs_err=err64, dtype="bfloat16",
        ms=cuda_time_ms(lambda: spec.score_stacked(masters, cfg, wins, nv), 1, 1),
        plain_ms=cuda_time_ms(lambda: plain(masters, cfg, wins, nv), 2, 1),
        **_bound(nbytes, flops, BF16_FLOPS), library_ms=None,
        library="none (no one call: cuDNN's LSTM/GRU has neither the forget +1 nor per-slot "
                "weights)",
        f32_ms=ms32, f32_bound_ms=_bound(nbytes, flops, F32_FLOPS)["bound_ms"], flops=flops,
        tflop_per_s=flops / ms32 / 1e9)
    emit({"phase": "kernel", "name": f"{name}_global", **rec})
    return rec


def global_kf_phase(dev, spec, windows, seed: int) -> dict:
    """KF's global form alone at ``GLOBAL_KF``'s hidden (past the wide
    form's 2,233) on config 3's first windows (context 128, horizon 24, 64
    paths): ``replay_phase`` in bf16 compute (the first step and the mean
    within the bf16 bar, timed, the series-major noise fault); then f32
    compute, every sample within 2e-4 of a float64 plain run on the same
    noise, two runs bitwise, and a plain run whose recurrent dot sums only
    the first 2,233 units shown outside that bar."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import make_config
    from sitewhere_tpu_torch.models.deepar import forecast_plain

    hid, n = GLOBAL_KF
    cfg = make_config("deepar", {"context": REPLAY_CONTEXT, "hidden": hid, "num_samples": 64})
    params = spec.init(torch.Generator().manual_seed(140 + seed), cfg, device=dev)
    wins = windows[:n].contiguous()
    rec = replay_phase(dev, spec, cfg, params, wins, shape=f"deepar_replay h{hid}", fault=True,
                       iters=1)
    c32 = dataclasses.replace(cfg, dtype="float32")
    eps = torch.randn((cfg.horizon, cfg.num_samples * n), device=dev,
                      generator=torch.Generator(dev).manual_seed(6))
    kernels.reset_launches()
    samples, mean = spec.forecast(params, c32, wins, eps=eps)
    torch.cuda.synchronize()
    tag = f"deepar_forecast_global[h{hid},s64] f32, {n} series"
    check(kernels.variant_launches() == {f"deepar_forecast_global[h{hid},s64]": 1},
          f"{tag}: the route launched the global form")
    s64, m64 = forecast_plain(f64_tree(params), f64_cfg(c32), wins.double(), eps)
    err = _held(f"{tag} samples vs float64", samples, s64, TF32_TOL)
    _held(f"{tag} mean vs float64", mean, m64, TF32_TOL)
    again, _ = spec.forecast(params, c32, wins, eps=eps)
    check(torch.equal(again, samples), f"{tag}: two runs bitwise")
    cap = GLOBAL_CAPS["deepar_forecast"]
    fs, _ = forecast_plain(truncated_dot(cap)(params), c32, wins, eps)
    outside = int((~torch.isclose(fs, s64.float(), rtol=TF32_TOL, atol=TF32_TOL)).sum())
    check(outside > 0, f"{tag}: the f32 bar rejects a recurrent dot over the first {cap} units")
    rec.update(variant=f"h{hid},s64", f32_vs_f64_max_abs_err=err,
               fault_truncated_dot_samples_outside_bar=outside, series=n)
    emit({"phase": "kernel", "name": "deepar_forecast_global", **rec})
    return rec


def global_forced_phase(dev, seed: int) -> dict:
    """The global form forced (``flush.forced_route``) at main path m's
    shapes, where the wide form runs: KS at hidden 128 / window 256 and KD
    at 40 / 192 (4 slots x 1,024 windows, bf16 compute, f32 masters and
    int8), KF at hidden 40 with 256 paths (context 168, 16 series), KB and
    KR on 2 slots x 1,024 streams (bf16 compute): each bitwise the wide
    form at the same rows a block; the scan and forecast forms bitwise at 8
    rows a block against 32 too, the train forms' per-row loss and saves
    (their leaf sums follow the tiles' sum order: held per element at rtol
    1e-4 / atol 1e-5). Each timed beside the wide form: the cost of the
    state in global memory where shared memory holds it."""
    import torch

    from sitewhere_tpu_torch.models import deepar, get_model, lstm_ad, make_config
    from sitewhere_tpu_torch.models import flush as tf_
    from sitewhere_tpu_torch.models.common import quantize_params

    out = {}
    for family, _shape, hid, w in WIDE_MAIN:
        spec = get_model(family)
        name = SCORER[family][0]
        cfg = make_config(family, {"hidden": hid, "window": w})
        masters = stacked_trees(spec, cfg, dev, 4, 150 + hid + seed)
        gen = torch.Generator(dev).manual_seed(160 + hid + seed)
        wins = torch.randn((4, 1024, w), generator=gen, device=dev).cumsum(-1)
        nv = torch.randint(0, w + 1, (4, 1024), generator=gen, device=dev, dtype=torch.int32)
        _, rows = tf_.scan_route(name, name, hid, w, (4, 1024))
        rec = {"wide_rows": rows}
        for fmt in ("f32", "int8"):
            q = quantize_params(masters, fmt)
            wide = spec.score_stacked(q, cfg, wins, nv)
            for r in (8, 32):
                with tf_.forced_route("global", r):
                    glob = spec.score_stacked(q, cfg, wins, nv)
                check(torch.equal(glob, wide),
                      f"{name} h{hid} w{w} {fmt}: the global form at {r} rows a block bitwise "
                      f"the wide form at {rows}")
        rec["wide_ms"] = cuda_time_ms(lambda: spec.score_stacked(masters, cfg, wins, nv), 2, 1)
        with tf_.forced_route("global", rows):
            rec["global_ms"] = cuda_time_ms(
                lambda: spec.score_stacked(masters, cfg, wins, nv), 2, 1)
        out[f"{name} h{hid} w{w}"] = rec
        # the train form on the same width and window
        form_name = train_kernel(family, hid, w).replace("_wide", "")
        params = stacked_trees(spec, cfg, dev, 2, 170 + hid + seed)
        state = train_rings(dev, 2, 1024, 180 + hid + seed, w)
        rows_m = train_rows(state)
        loss_w, g_w = kernel_train_grads(spec, params, cfg, state, rows_m)
        form = lstm_ad.KB if family == "lstm_ad" else deepar.KR
        _, t_rows = tf_.train_route(form, hid, w, (2, 1024))
        with tf_.forced_route("global", t_rows):
            loss_g, g_g = kernel_train_grads(spec, params, cfg, state, rows_m)
        check(torch.equal(loss_w, loss_g) and all(torch.equal(a, c) for a, c in zip(g_w, g_g)),
              f"{form_name} h{hid} w{w}: the global form's loss and gradients bitwise the "
              f"wide form's at {t_rows} rows a block")
        other = 8 if t_rows != 8 else 32
        with tf_.forced_route("global", other):
            loss_o, g_o = kernel_train_grads(spec, params, cfg, state, rows_m)
        check(torch.equal(loss_w, loss_o),
              f"{form_name} h{hid} w{w}: per-row loss at {other} rows a block bitwise {t_rows}")
        ratio = max(float(((a - c).abs() / (1e-5 + 1e-4 * c.abs())).max())
                    for a, c in zip(g_o, g_w))
        check(ratio <= 1.0, f"{form_name} h{hid} w{w}: gradients at {other} rows a block "
                            f"within rtol 1e-4 / atol 1e-5 of {t_rows} ({ratio})")
        trec = {"wide_rows": t_rows, "other_rows": other, "other_rows_worst_ratio_to_bar": ratio,
                "wide_ms": cuda_time_ms(
                    lambda: kernel_train_grads(spec, params, cfg, state, rows_m), 2, 1)}
        with tf_.forced_route("global", t_rows):
            trec["global_ms"] = cuda_time_ms(
                lambda: kernel_train_grads(spec, params, cfg, state, rows_m), 2, 1)
        out[f"{form_name} h{hid} w{w}"] = trec
        del params, state, g_w, g_g, g_o
        torch.cuda.empty_cache()
    spec = get_model("deepar")
    cfg = make_config("deepar", {"context": KF_CONTEXT, "hidden": 40, "num_samples": 256})
    params = spec.init(torch.Generator().manual_seed(190 + seed), cfg, device=dev)
    wins = torch.from_numpy(replay_windows(KF_CONTEXT)[:16]).to(dev)
    eps = torch.randn((cfg.horizon, 256 * 16), device=dev,
                      generator=torch.Generator(dev).manual_seed(7))
    wide = spec.forecast(params, cfg, wins, eps=eps)
    for r in (8, 32):
        with tf_.forced_route("global", r):
            glob = spec.forecast(params, cfg, wins, eps=eps)
        check(all(torch.equal(a, c) for a, c in zip(glob, wide)),
              f"deepar_forecast h40 s256: the global form at {r} rows a block bitwise the wide")
    krec = {"wide_ms": cuda_time_ms(lambda: spec.forecast(params, cfg, wins, eps=eps), 3, 1)}
    with tf_.forced_route("global", 32):
        krec["global_ms"] = cuda_time_ms(lambda: spec.forecast(params, cfg, wins, eps=eps), 3, 1)
    out["deepar_forecast h40 s256"] = krec
    emit({"phase": "global_forced", **out})
    return out


def wide_path_drive(mm, dev, family: str, hid: int, shape: str, rng, seed: int, seq0: int,
                    windows=None):
    """Main path q (LSTM-AD at hidden 2,048) or r (DeepAR at 2,304), window
    32, on ``shape``'s plane (2 slots x 2,048-row flushes over 2,048
    streams), each slot with its own default-init weights: ``variant_drive``
    from the f32 masters (2 flushes: KW, the global KS or KD, KH, KG; held
    against the plain twin and shown rejecting ``truncated_dot`` at the wide
    form's cap), its train lane (2 steps of the global KB or KR and KO at lr
    1e-3, the first slot frozen, held against the plain twin and an f32
    plain scorer stepping beside it, since the loss rises at this width and
    lr; a replay step; a flush from the trained weights), then one flush
    each from the bf16 and int8 views; for r, the
    forecast of config 3's ``windows`` (context 128, 64 paths, horizon 24)
    through KF's global form, finite and within the series' range +- 10.
    Returns (launches, variant launches)."""
    import torch

    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import get_model, make_config

    spec = get_model(family)
    name = SCORER[family][0]
    cfg = make_config(family, {"hidden": hid, "window": WINDOW})
    t = SHAPES[shape][0]
    masters = stacked_trees(spec, cfg, dev, t, 200 + hid + seed)
    counts, variants = {}, {}

    def add(c, v):
        for key, n in c.items():
            counts[key] = counts.get(key, 0) + n
        for key, n in v.items():
            variants[key] = variants.get(key, 0) + n

    t0 = time.perf_counter()
    add(*variant_drive(mm, spec, cfg, masters, "f32", rng, seq0, flushes=2,
                       fault=truncated_dot(GLOBAL_CAPS[name]), lane_steps=2, shape=shape,
                       lane_twin=True, loss_must_fall=False))
    for i, fmt in enumerate(("bf16", "int8")):
        add(*variant_drive(mm, spec, cfg, masters, fmt, rng, seq0 + 100 * (i + 1), flushes=1,
                           shape=shape))
    train_name = train_kernel(family, hid, WINDOW)
    for key in (f"{name}_global[h{hid},f32]", f"{name}_global[h{hid},bf16]",
                f"{name}_global[h{hid},int8]", f"{train_name}[h{hid}]"):
        check(variants.get(key, 0) > 0, f"main path {shape} launched {key}")
    rec = {"phase": "main_path", "path": shape, "family": family, "hidden": hid,
           "window": WINDOW, "seconds": time.perf_counter() - t0}
    if windows is not None:
        kcfg = make_config("deepar", {"context": REPLAY_CONTEXT, "hidden": hid,
                                      "num_samples": 64})
        params = spec.init(torch.Generator().manual_seed(210 + seed), kcfg, device=dev)
        kernels.reset_launches()
        t1 = time.perf_counter()
        samples, mean = spec.forecast(params, kcfg, windows,
                                      torch.Generator(dev).manual_seed(2027 + seed))
        torch.cuda.synchronize()
        kf_s = time.perf_counter() - t1
        vc = kernels.variant_launches()
        check(vc.get(f"deepar_forecast_global[h{hid},s64]", 0) == 1,
              f"main path {shape}: the forecast launched KF's global form")
        lo, hi = float(windows.min()), float(windows.max())
        check(tuple(samples.shape) == (64, windows.shape[0], kcfg.horizon)
              and bool(torch.isfinite(samples).all()) and lo - 10 < float(mean.min())
              and float(mean.max()) < hi + 10,
              f"main path {shape}: forecast finite, within the series' range +- 10")
        rec.update(forecast_series=int(windows.shape[0]), forecast_seconds=kf_s,
                   forecast_mean_range=[float(mean.min()), float(mean.max())])
        add(kernels.launches(), vc)
    emit(dict(rec, launches={k: n for k, n in counts.items() if n}, variant_launches=variants))
    del masters
    torch.cuda.empty_cache()
    return counts, variants


# -- K14: KA's ring step alone, then the multi-device paths on ranks ------------------

# (tag, B, Tl, H, hd, q_off, k_off, causal): main path s's step (8 series, Tl
# 4,096 of the 16,384 context, 4 heads of 32) in each mask regime of the
# causal ring (a fully visible block, src < my; the diagonal; a fully masked
# one, src > my) and non-causal; ViT-B/16's heads (hd 64) at T 197 and the
# widest head the kernel takes at Tl 1,000 (neither a multiple of its 64-row
# tiles), with unequal offsets
RING_SHAPES = (
    ("s visible", 8, 4096, 4, 32, 8192, 0, True),
    ("s diagonal", 8, 4096, 4, 32, 4096, 4096, True),
    ("s masked", 8, 4096, 4, 32, 4096, 8192, True),
    ("s non-causal", 8, 4096, 4, 32, 4096, 0, False),
    ("tl197 hd64 diagonal", 64, 197, 3, 64, 197, 197, True),
    ("tl197 hd64 non-causal", 64, 197, 3, 64, 0, 197, False),
    ("tl1000 hd256 offset", 2, 1000, 2, 256, 1000, 700, True),
    ("tl1000 hd256 non-causal", 2, 1000, 2, 256, 0, 1000, False),
)
RING_MAIN = "s visible"  # the kernels line's record: the causal ring's most common step
K14_RANKS = 4  # main paths s, t, u: four gloo ranks sharing the one card
S_SERIES, S_HISTORY, S_CONTEXT = 8, 86_400, 16_384  # path n's histories, cut to the context
S_TWIN_SERIES = 2  # series the plain ring twin runs (each rank: [2, 4, 4,096, 4,096] f32 a step)
GPIPE_MICROBATCHES = (4, 8)
DRYRUN_TOL = 1e-3  # __graft_entry__.py:169


def _ring_pairs(tq: int, tk: int, q_off: int, k_off: int, causal: bool) -> int:
    """The (query, key) pairs the block attends: its data's work."""
    if not causal:
        return tq * tk
    seen = np.clip(q_off + np.arange(tq) - k_off + 1, 0, tk)
    return int(seen.sum())


def ring_library(q, k, v, m, l, acc, causal: bool):
    """One PyTorch call for the block's partial attention with its
    statistics: the memory-efficient SDPA's output and log-sum-exp, then the
    combine in torch ops (timed beside the kernel, used nowhere in the
    port). A fully visible or diagonal block only."""
    import torch

    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    o, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        qh, kh, vh, None, True, 0.0, causal)[:2]
    lse = lse[..., :q.shape[1]]
    m_new = torch.maximum(m, lse)
    r_old, r_blk = torch.exp(m - m_new), torch.exp(lse - m_new)
    return m_new, l * r_old + r_blk, acc * r_old[..., None] + o * r_blk[..., None]


def ring_step_phase(dev, seed: int) -> dict:
    """KA's ring step against its plain version on the card at each
    ``RING_SHAPES`` shape: on a running state one diagonal step old, m, l,
    acc and the last step's output in f32 within 2e-4 of the plain
    version's; a fully masked block leaves the state bitwise as it was; two
    runs bitwise. Timed beside the plain version and the memory-efficient
    SDPA with the combine; bound: the unmasked pairs' 4 hd FLOP at the f32
    rate, or the bytes; a fully masked block is the identity on the state
    and needs neither (no bound: the launch alone)."""
    import torch

    from sitewhere_tpu_torch.ops import ring_attention as tra

    gen = torch.Generator(device=dev).manual_seed(300 + seed)
    recs = {}
    for tag, b, tl, h, hd, q_off, k_off, causal in RING_SHAPES:
        q, k, v, k0, v0 = (torch.randn((b, tl, h, hd), generator=gen, device=dev)
                           for _ in range(5))
        state = [torch.full((b, h, tl), tra.NEG_INF, device=dev),
                 torch.zeros((b, h, tl), device=dev), torch.zeros((b, h, tl, hd), device=dev)]
        tra.ring_step_plain(q, k0, v0, *state, q_off, q_off, causal)  # a step's running state
        got, twice, want = ([x.clone() for x in state] + [torch.empty_like(q)] for _ in range(3))
        tra.ring_step(q, k, v, *got[:3], q_off, k_off, causal, got[3])
        tra.ring_step(q, k, v, *twice[:3], q_off, k_off, causal, twice[3])
        tra.ring_step_plain(q, k, v, *want[:3], q_off, k_off, causal, want[3])
        torch.cuda.synchronize()
        err = max(_held(f"KA ring step {tag} {name}", g, w, TF32_TOL)
                  for name, g, w in zip(("m", "l", "acc", "out"), got, want))
        check(all(torch.equal(a, c) for a, c in zip(got, twice)),
              f"KA ring step {tag}: bitwise twice")
        pairs = _ring_pairs(tl, tl, q_off, k_off, causal)
        if pairs == 0:
            check(all(torch.equal(a, s) for a, s in zip(got[:3], state)),
                  f"KA ring step {tag}: a fully masked block leaves m, l, acc bitwise")
        work = [x.clone() for x in state]
        run = lambda: tra.ring_step(q, k, v, *work, q_off, k_off, causal)  # noqa: E731
        lib_ms, lib_note = None, None
        if pairs == tl * tl or (causal and q_off == k_off):  # no mask, or the diagonal's
            lib_causal = pairs < tl * tl
            try:
                lib_ms = cuda_time_ms(lambda: ring_library(q, k, v, *work, lib_causal), 3)
            except RuntimeError as exc:  # the library's kernel refuses the shape
                lib_note = str(exc).splitlines()[0][:200]
        else:
            lib_note = "no one call takes a causal mask at these offsets"
        nbytes = 4 * (3 * q.numel() + 2 * (2 * b * h * tl + b * h * tl * hd))
        bound = (_bound(nbytes, 0.0, BF16_FLOPS, f32_flops=4.0 * b * h * hd * pairs) if pairs
                 else dict(bound_ms=None, bound_by="identity (launch only)"))
        recs[tag] = dict(
            max_abs_err=err, ms=cuda_time_ms(run, 3),
            plain_ms=cuda_time_ms(lambda: tra.ring_step_plain(q, k, v, *work, q_off, k_off, causal),
                                  1, 1),
            library_ms=lib_ms, library_note=lib_note, **bound,
            dims=[b, tl, h, hd], q_off=q_off, k_off=k_off, causal=causal, pairs=pairs)
        emit({"phase": "kernel", "shape": tag, "name": "attention_ring", **recs[tag]})
        del q, k, v, k0, v0, state, got, twice, want, work
        torch.cuda.empty_cache()
    return dict(recs[RING_MAIN], shape=RING_MAIN,
                shapes=[dict(r, shape=t) for t, r in recs.items() if t != RING_MAIN])


def tf_single_backbone(params, cfg, normed):
    """The single-device kernel backbone: the embed, the blocks over one
    slot (``transformer._blocks``: KL, KA, KU; KA's tiled form past its
    staged caps) and ln_f (KL) -> features [B, T, D]."""
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt

    dtype, t, d = cfg.compute_dtype, normed.shape[1], cfg.dim
    x = tc.dense(params["embed"], normed[..., None].to(dtype), dtype)
    x = x + params["pos"][:t].to(dtype)[None]
    h = tt._blocks(tc.tree_map(lambda a: a[None], params), x[None], cfg)[0]
    ln = params["ln_f"]
    return tc.layernorm_rows(h.reshape(-1, d), ln["scale"][None], ln["bias"][None],
                             h.numel() // d).reshape(h.shape)


def seed_from_feats(params, cfg, feats, mu_n, sigma_n):
    """``forecast_seed_sharded``'s (mu, sigma) from given features."""
    from sitewhere_tpu_torch.models import transformer as tt

    mu, sigma = tt._emit(params, feats[:, -1:], cfg)
    return mu[:, 0] * sigma_n[:, 0] + mu_n[:, 0], sigma[:, 0] * sigma_n[:, 0]


def bf16_seed_held(tag: str, got, single, ref, sigma_n) -> dict:
    """A bf16 forecast seed (mu, sigma) f32[B] each, against the bf16 and
    f32 single-device kernel backbones' seeds, in normalized units (each
    over its series' sigma_n): ``held_or_as_accurate``, within the bf16
    bar of the bf16 seed or as accurate as it against the f32 one."""
    import torch

    flat = lambda pair: torch.cat([x.float() / sigma_n for x in pair]).cpu()  # noqa: E731
    return held_or_as_accurate(tag, flat(got), flat(single), flat(ref))


def k14_inputs(dev, vit_params, cfg_v, vit_images, seed: int) -> dict:
    """Main paths s, t, u's inputs on the host (each rank moves them to its
    device): the transformer at its registry widths (dim 128, depth 4, 4
    heads) with context 16,384, f32 and bf16 compute, on the last 16,384
    points of 8 of path n's 86,400-point histories; ViT-B/16's tree sliced
    for 4 ranks and config 5's 64 frames; its first 4 blocks stacked as GPipe's
    stages over the 64 frames' embedded tokens (64 x 197 x 768, bf16)."""
    import dataclasses as dc
    import functools

    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models import vit as tv

    cfg16 = tt.TransformerForecasterConfig(context=S_CONTEXT)  # dim 128, depth 4, 4 heads, bf16
    cfg32 = dc.replace(cfg16, dtype="float32")
    gen = torch.Generator().manual_seed(310 + seed)
    tf_params = own_affines(tt.init(gen, cfg16, device="cpu"), gen)
    windows = raw_histories(dev, S_SERIES, S_HISTORY, 311 + seed).cpu()
    normed, mu_n, sigma_n = tc.normalize_windows(windows[:, -S_CONTEXT:])
    host = tc.tree_map(lambda a: a.cpu(), vit_params)
    images = vit_images.cpu()
    patches = tv.frame_patches(vit_images, cfg_v.patch_size, cfg_v.compute_dtype)
    tokens = tv.vit_embed(torch.matmul(patches, tc.kernel_weight(vit_params["patch"],
                                                                 cfg_v.compute_dtype)),
                          vit_params["patch"]["b"], vit_params["cls"], vit_params["pos"]).cpu()
    return dict(
        cfg16=cfg16, cfg32=cfg32, tf_params=tf_params, windows=windows, normed=normed,
        mu_n=mu_n, sigma_n=sigma_n, vit_cfg=cfg_v, vit_host=host, images=images,
        tp=tv.shard_params_tp(host, K14_RANKS), tp1=tv.shard_params_tp(host, 1),
        stages=tc.tree_map(lambda *xs: torch.stack(xs), *host["blocks"][:K14_RANKS]),
        tokens=tokens,
        stage_fn=functools.partial(tc.block_stage, heads=cfg_v.heads, causal=False,
                                   dtype=cfg_v.compute_dtype, ops=tv.KERNEL_OPS))


def k14_jobs(inp: dict, n: int) -> list:
    """The jobs of a world of ``n`` ranks: main paths s (``forecast_seed_
    sharded`` in f32 and bf16), t (``apply_tp``), u (``pipeline_apply`` at
    4 and 8 microbatches; at one rank one stage), and what they are held
    against (the backbone's features, kernel and plain-ring twin at more
    than one rank)."""
    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import transformer as tt
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.ops import pipeline_parallel as tpp
    from sitewhere_tpu_torch.parallel import dist as tdist

    J, p = tdist.Job, inp["tf_params"]
    jobs = [J(f"s {c}", tt.forecast_seed_sharded,
              dict(params=p, cfg=inp[f"cfg{c}"], windows=inp["windows"])) for c in (32, 16)]
    for c in (32, 16):
        jobs.append(J(f"s feats {c}", tt.backbone_sharded,
                      dict(params=p, cfg=inp[f"cfg{c}"], normed=inp["normed"]), rank0_only=True))
    if n > 1:
        for c in (32, 16):
            jobs.append(J(f"s twin {c}", tt.backbone_sharded, dict(
                params=p, cfg=inp[f"cfg{c}"], normed=inp["normed"][:S_TWIN_SERIES],
                ops=tt.PLAIN_OPS), rank0_only=True))
    blocks, rest = inp["tp"] if n > 1 else inp["tp1"]
    jobs.append(J("t", tv.apply_tp, dict(blocks_stacked=blocks, rest=rest, cfg=inp["vit_cfg"],
                                         images=inp["images"])))
    stages = inp["stages"] if n > 1 else tc.tree_map(lambda a: a[:1].clone(), inp["stages"])
    for m in GPIPE_MICROBATCHES:
        jobs.append(J(f"u m{m}", tpp.pipeline_apply, dict(
            stage_params_stacked=stages, x=inp["tokens"], stage_fn=inp["stage_fn"],
            microbatches=m), rank0_only=True))
    return jobs


K14_MAIN_JOBS = ("s 32", "s 16", "t", *(f"u m{m}" for m in GPIPE_MICROBATCHES))


def k14_refs(dev, inp: dict) -> dict:
    """What main paths s, t, u are held against, single-device on the card:
    the kernel backbone's features (f32, bf16) and their forecast seed;
    ViT-B/16's ``apply`` (bf16) and an f32 plain forward; the GPipe stages
    run in sequence on each microbatch."""
    import dataclasses as dc

    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv

    params = tc.tree_map(lambda a: a.to(dev), inp["tf_params"])
    normed = inp["normed"].to(dev)
    refs = {}
    for c in (32, 16):
        cfg = inp[f"cfg{c}"]
        refs[f"feats {c}"] = tf_single_backbone(params, cfg, normed)
        refs[f"seed {c}"] = seed_from_feats(params, cfg, refs[f"feats {c}"],
                                            inp["mu_n"].to(dev), inp["sigma_n"].to(dev))
    vp = tc.tree_map(lambda a: a.to(dev), inp["vit_host"])
    images = inp["images"].to(dev)
    refs["t"] = tv.apply(vp, inp["vit_cfg"], images)
    refs["t f32"] = tv.classify_plain(vp, dc.replace(inp["vit_cfg"], dtype="float32"),
                                      images, 0)[0]
    tokens = inp["tokens"].to(dev)
    for n in (1, K14_RANKS):
        for m in GPIPE_MICROBATCHES:
            xm = tokens.reshape(m, -1, *tokens.shape[1:])
            ys = []
            for i in range(m):
                y = xm[i]
                for blk in vp["blocks"][:n]:
                    y = inp["stage_fn"](blk, y)
                ys.append(y)
            refs[f"u {n} m{m}"] = torch.stack(ys).reshape(tokens.shape)
    return refs


def k14_bound_ms(inp: dict, n: int) -> tuple:
    """The least time of main paths s, t, u's launches in a world of ``n``
    ranks, every rank's summed: each launch at its shape, bounded as the
    kernel's own record bounds it (``_bound``: the bytes it reads and writes
    once, or its operations), enumerated from ``k14_jobs`` -> (bound ms,
    launches by kernel). A fully masked ring step is the identity: no bound.
    ``k14_drive`` records whether the counts are the ranks' own."""
    cfg, v = inp["cfg16"], inp["vit_cfg"]
    total, launches = 0.0, {}

    def add(name, count, nbytes, flops=0.0, peak=BF16_FLOPS, f32=0.0):
        nonlocal total
        launches[name] = launches.get(name, 0) + count
        if nbytes or flops or f32:
            total += count * _bound(nbytes, flops, peak, f32)["bound_ms"]

    # path s, per rank and compute dtype (f32, bf16): KL (ln1, ln2 a block,
    # then ln_f) and KU on its B x Tl tokens; the ring in f32, rank r's step
    # on rank src's block the diagonal (src = r), fully visible (src < r) or
    # fully masked
    b, tl, d, h = S_SERIES, S_CONTEXT // n, cfg.dim, cfg.heads
    rows, hd = b * tl, d // h
    for elt in (4, 2):
        add("layernorm", n * (2 * cfg.depth + 1), 2 * rows * d * elt + 2 * d * 4,
            8.0 * rows * d, F32_FLOPS)
        add("bias_gelu", n * cfg.depth, 2 * rows * 4 * d * elt + 4 * d * 4, 10.0 * rows * 4 * d,
            F32_FLOPS)
        ring_bytes = 4 * (3 * rows * d + 2 * (2 * b * h * tl + b * h * tl * hd))
        for r in range(n):
            for src in range(n):
                pairs = tl * (tl + 1) / 2 if src == r else tl * tl if src < r else 0
                add("attention_ring", cfg.depth, ring_bytes if pairs else 0,
                    f32=4.0 * b * h * hd * pairs)
    # path t on each rank: KP, KV, the blocks (KL at full width, the staged
    # KA on heads / n, KU on 4 d / n columns), KT
    fb, t, d, h = VIT_BATCH, v.num_patches + 1, v.dim, v.heads
    pix, patch = fb * v.image_size * v.image_size * v.channels, fb * (t - 1) * d
    x, hd = fb * t * d, d // h
    add("frame_patches", n, pix + patch * 2, 3.0 * patch, F32_FLOPS)
    add("vit_embed", n, (patch + x) * 2 + (2 * d + t * d) * 4, 2.0 * x, F32_FLOPS)
    add("layernorm", n * 2 * v.depth, 2 * x * 2 + 2 * d * 4, 8.0 * x, F32_FLOPS)
    add("attention", n * v.depth, 4 * x // n * 2, 2 * 2.0 * hd * t * t * h // n * fb)
    add("bias_gelu", n * v.depth, 2 * 4 * x // n * 2 + 4 * d // n * 4, 10.0 * 4 * x / n,
        F32_FLOPS)
    c = v.num_classes
    add("vit_head", n, fb * d * 2 + (2 * d + d * c + c) * 4 + fb * c * 4 + fb * VIT_TOPK * 8,
        2.0 * fb * d * c, BF16_FLOPS, fb * (8.0 * d + 6.0 * c))
    # path u: each stage (one a rank; one in all at n = 1) a ViT block on
    # every microbatch of the 64 frames' tokens
    for m in GPIPE_MICROBATCHES:
        xm = x // m
        add("layernorm", n * 2 * m, 2 * xm * 2 + 2 * d * 4, 8.0 * xm, F32_FLOPS)
        add("attention", n * m, 4 * xm * 2, 2 * 2.0 * hd * t * t * h * fb / m)
        add("bias_gelu", n * m, 2 * 4 * xm * 2 + 4 * d * 4, 10.0 * 4 * xm, F32_FLOPS)
    return total, launches


def k14_drive(dev, inp: dict, refs: dict, n: int, backend: str):
    """Main paths s, t, u on ``n`` ranks of ``backend`` sharing the card
    (``parallel.dist.run_ranks``), each rank's kernel counts set to 0 just
    before each job and read just after -> (the main-path jobs' launches
    summed over the ranks, by variant). Held: path s's features within
    1e-3 of the single-device kernel backbone's (f32; bf16 by its pooled
    error against the f32 backbone, within 1.25x the bf16 backbone's +
    1e-3) and, past one rank, with 2 of the 8 series within 2e-4 of the
    ranks running the plain ring (f32; bf16 by ``held_or_as_accurate``
    against the f32 twin); its (mu, sigma) against both in f32, and in
    bf16 by ``held_or_as_accurate`` against the single-device seeds
    (``bf16_seed_held``); path t's top-5 by ``topk_ids_check`` against ``apply`` (at one
    rank its logits bitwise ``apply``'s: the psum is the identity); path u
    against the stages in sequence (the bf16 bar; bitwise recorded). Every
    rank's copy of a global result alike."""
    import torch

    from sitewhere_tpu_torch.models import common as tc
    from sitewhere_tpu_torch.models import vit as tv
    from sitewhere_tpu_torch.parallel import dist as tdist

    t0 = time.perf_counter()
    ranks = [r["out"] for r in tdist.run_ranks(tdist.run_jobs, n, backend, dev.type,
                                               k14_jobs(inp, n))]
    wall = time.perf_counter() - t0
    out = {name: r["out"] for name, r in ranks[0].items()}
    tag = f"{n} {backend} rank{'s' if n > 1 else ''}"
    for name in ("s 32", "s 16", "t"):
        for r in ranks[1:]:
            a, b = out[name], r[name]["out"]
            check(all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple)
                  else torch.equal(a, b), f"{tag}: every rank's {name} alike")
    rec = {"ranks": n, "backend": backend, "wall_s": wall,
           "label": "ranks sharing one H100" if n > 1 else "one rank",
           "job_s": {name: [r[name]["seconds"] for r in ranks] for name in ranks[0]}}
    on = lambda x: x.to(dev)  # noqa: E731
    # path s
    feats32 = on(out["s feats 32"])
    rec["s_f32_vs_single_max_abs_err"] = _held(f"path s f32 ({tag}) vs the single-device "
                                                "backbone", feats32, refs["feats 32"], DRYRUN_TOL)
    mu, sigma = (on(x) for x in out["s 32"])
    rec["s_seed_f32_vs_single_max_abs_err"] = max(
        _held(f"path s f32 ({tag}) {nm} vs single-device", g, w, DRYRUN_TOL)
        for nm, g, w in zip(("mu", "sigma"), (mu, sigma), refs["seed 32"]))
    if n > 1:
        twin32, twin16 = on(out["s twin 32"]), on(out["s twin 16"])
        k = S_TWIN_SERIES
        rec["s_f32_vs_twin_max_abs_err"] = _held(f"path s f32 ({tag}) vs the plain ring",
                                                 feats32[:k], twin32, TF32_TOL)
        params = tc.tree_map(on, inp["tf_params"])
        tw_seed = seed_from_feats(params, inp["cfg32"], twin32, on(inp["mu_n"][:k]),
                                  on(inp["sigma_n"][:k]))
        rec["s_seed_f32_vs_twin_max_abs_err"] = max(
            _held(f"path s f32 ({tag}) {nm} vs the plain ring", g[:k], w, TF32_TOL)
            for nm, g, w in zip(("mu", "sigma"), (mu, sigma), tw_seed))
        rec["s_bf16_vs_twin"] = held_or_as_accurate(
            f"path s bf16 ({tag}) vs the plain ring",
            on(out["s feats 16"])[:k].float().flatten().cpu(),
            twin16.float().flatten().cpu(), twin32.flatten().cpu())
    # two bf16 computations that round attention apart (the ring in f32, the
    # single-device KA in bf16): pooled, as the ViT's accuracy rule
    feats16 = on(out["s feats 16"]).float()
    ring_e = float((feats16 - refs["feats 32"]).abs().mean())
    single_e = float((refs["feats 16"].float() - refs["feats 32"]).abs().mean())
    rec["s_bf16_vs_single"] = {"mean_abs_err_vs_f32": ring_e,
                               "single_mean_abs_err_vs_f32": single_e}
    check(ring_e <= 1.25 * single_e + 1e-3, f"path s bf16 ({tag}) as accurate against the "
          f"f32 single-device backbone as the bf16 one ({rec['s_bf16_vs_single']})")
    mu16, sigma16 = (on(x) for x in out["s 16"])
    rec["s_seed_bf16_vs_single"] = bf16_seed_held(
        f"path s bf16 ({tag}) (mu, sigma) vs the single-device seeds", (mu16, sigma16),
        refs["seed 16"], refs["seed 32"], on(inp["sigma_n"])[:, 0])
    lo, hi = float(inp["windows"].min()), float(inp["windows"].max())
    check(bool((sigma16 > 0).all()) and lo - 10 < float(mu16.min())
          and float(mu16.max()) < hi + 10, f"path s bf16 ({tag}): sigma > 0, raw units")
    rec["s_mu"] = {"f32": mu.tolist(), "bf16": mu16.tolist()}
    # path t
    logits = on(out["t"])
    if n == 1:
        check(torch.equal(logits, refs["t"]), f"path t ({tag}): bitwise models.vit.apply")
    probs, ids = tv.softmax_topk_plain(logits, VIT_TOPK)
    rec["t_topk"] = topk_ids_check(f"path t ({tag})", logits, probs, ids, refs["t"])
    rec["t_accuracy"] = vit_logit_accuracy(f"path t ({tag})", logits, refs["t"], refs["t f32"])
    # path u
    for m in GPIPE_MICROBATCHES:
        got, want = on(out[f"u m{m}"]), refs[f"u {n} m{m}"]
        rec[f"u_m{m}_max_abs_err"] = _held(f"path u m{m} ({tag}) vs the stages in sequence",
                                           got, want, TOL)
        rec[f"u_m{m}_bitwise"] = bool(torch.equal(got, want))
    counts = {name: sum(r[j]["launches"][name] for r in ranks for j in K14_MAIN_JOBS)
              for name in ranks[0]["t"]["launches"]}
    vcounts: dict = {}
    for r in ranks:
        for j in K14_MAIN_JOBS:
            for key, c in r[j]["variant_launches"].items():
                vcounts[key] = vcounts.get(key, 0) + c
    for name in ("attention_ring", "layernorm", "bias_gelu", "attention", "vit_head"):
        check(counts[name] > 0, f"main paths s, t, u ({tag}) launched {name}")
    rec["launches"] = {k: c for k, c in counts.items() if c}
    rec["bound_ms"], enumerated = k14_bound_ms(inp, n)
    rec["bound_launches_are_the_ranks"] = enumerated == rec["launches"]
    emit({"phase": "main_path", "path": "k14 s t u", **rec})
    return counts, vcounts




def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Drive the port's paths on one GPU and check them.")
    ap.add_argument("--seed", type=int, default=0,
                    help="added to the seeds of the scorers' and forecasts' weights and of "
                         "the main paths' traffic (default 0)")
    seed = ap.parse_args(argv).seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs on the card", file=sys.stderr)
        return 2
    try:
        from sitewhere_tpu_torch import kernels
        from sitewhere_tpu_torch.models import get_model, make_config
        from sitewhere_tpu_torch.parallel.mesh import MeshManager
        from sitewhere_tpu_torch.models import vit as tv
        from sitewhere_tpu_torch.models.common import vit_flops_per_image
        from sitewhere_tpu_torch.models.deepar import kf_route
        from sitewhere_tpu_torch.parallel.sharded import ShardedScorer
        from sitewhere_tpu_torch.services.streaming_media import StreamingMedia
        from sitewhere_tpu_torch.sim.media import camera_frames
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    kernels.load()  # builds from csrc/ with nvcc
    emit({"phase": "build", "seconds": kernels.build_seconds,
          "ptxas": [ln.strip() for ln in kernels.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    try:  # one cuobjdump pass over the library (about a minute)
        funcs = sass_functions(kernels)
    except (OSError, subprocess.SubprocessError) as exc:
        emit({"phase": "sass", "error": str(exc)})
    else:
        split_sass, staged_sass = split_sass_census(funcs), staged_sass_census(funcs)
        emit({"phase": "sass", "tiled_ka": tiled_sass_census(funcs), "split_ka": split_sass,
              "staged_ka": staged_sass})
        check(split_sass["ok"], f"split KA: HGMMA in every bf16 kernel, none in the f32 ones, "
                                f"no HMMA ({split_sass})")
        check(staged_sass["ok"], f"staged KA: HGMMA in every bf16 kernel, none in the f32 ones, "
                                 f"no HMMA ({staged_sass})")

    dev = torch.device("cuda", 0)
    # the plain versions' matmuls accumulate in full precision, as the
    # reference's do (KS and KD accumulate their dot products in f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mm = MeshManager(device=dev)
    t32, b32, s32 = SHAPES["tenants32"]

    def scorers(family: str, cfg, weight_seed: int):
        """A kernel scorer and its plain twin per wire (f32, bf16), every
        slot active with its own weights from ``weight_seed`` (the
        transformer's with its own biases and affines too)."""
        spec = get_model(family)
        gen = torch.Generator().manual_seed(weight_seed)
        trees = [spec.init(gen, cfg, device=dev) for _ in range(t32)]
        if family == "transformer":
            trees = [own_affines(tree, gen) for tree in trees]
        out = {}
        for wire in ("f32", "bf16"):
            for plain in (False, True):
                sc = ShardedScorer(mm, spec, cfg, slots_per_shard=t32, max_streams=s32,
                                   window=WINDOW, wire_dtype=wire, plain=plain)
                for slot, tree in enumerate(trees):
                    sc.activate(slot, params=tree)
                out[(wire, plain)] = sc
        return spec, out

    lstm_cfg = make_config("lstm_ad", {"window": WINDOW, "hidden": HIDDEN})  # bf16 compute
    lstm_spec, lstm = scorers("lstm_ad", lstm_cfg, 11 + seed)
    deepar_cfg = make_config("deepar", {"context": REPLAY_CONTEXT, "hidden": HIDDEN,
                                        "num_samples": 64})  # bf16 compute, horizon 24
    deepar_spec, dar = scorers("deepar", deepar_cfg, 12 + seed)

    results = {name: kernel_phase(name, dev, lstm_spec, lstm_cfg, lstm[("f32", False)].params)
               for name in ("tenants32", "lstm_engine")}
    results["forecasting32"] = kernel_phase(
        "forecasting32", dev, deepar_spec, deepar_cfg, dar[("f32", False)].params)
    # the train kernels on the train plane (every slot x stream), each slot
    # with its scorer's weights; KO on LSTM-AD's stack; the fault probe
    for family, shape, spec, cfg, sc in (("lstm_ad", "tenants32", lstm_spec, lstm_cfg, lstm),
                                         ("deepar", "forecasting32", deepar_spec, deepar_cfg, dar)):
        phase = train_phase(shape, dev, spec, cfg, sc[("f32", False)].params, seed)
        results[shape][TRAIN_KERNEL[family]] = phase["rec"]
        train_fault_probe(spec, cfg, sc[("f32", False)].params, phase)
        del phase
        torch.cuda.empty_cache()
    results["tenants32"]["adam_update"] = adam_phase(dev, lstm[("f32", False)].params)
    fc_params = deepar_spec.init(torch.Generator().manual_seed(13 + seed), deepar_cfg, device=dev)
    windows = torch.from_numpy(replay_windows()).to(dev)
    results["deepar_replay"] = {
        "deepar_forecast": replay_phase(dev, deepar_spec, deepar_cfg, fc_params, windows)}
    # the widths and weight formats of the recurrent kernels: KS and KD at
    # tenants32's shapes (int8, bf16; hidden 8, 32) and config 8's; KB and
    # KR at hidden 16, window 16 on the train plane (with the fault probe);
    # KF at hidden 16 and 32 on deepar_replay's windows
    variants = {name: [] for name in ("lstm_score", "gru_score", "deepar_forecast",
                                      "lstm_train", "gru_train")}
    masters = {}
    for family, shape, spec, cfg, sc in (("lstm_ad", "tenants32", lstm_spec, lstm_cfg, lstm),
                                         ("deepar", "forecasting32", deepar_spec, deepar_cfg,
                                          dar)):
        name = SCORER[family][0]
        for hid, fmt in SCAN_VARIANTS:
            cfg_h = dataclasses.replace(cfg, hidden=hid)
            if (family, hid) not in masters:
                masters[(family, hid)] = (sc[("f32", False)].params if hid == HIDDEN
                                          else stacked_trees(spec, cfg_h, dev, t32, 30 + hid + seed))
            variants[name].append(
                scan_variant_phase(shape, dev, spec, cfg_h, masters[(family, hid)], fmt))
        c8_cfg = make_config(family, {"hidden": C8_HIDDEN, "window": WINDOWS["config8"]})
        variants[name].append(scan_variant_phase(
            "config8", dev, spec, c8_cfg, stacked_trees(spec, c8_cfg, dev, 1, 40 + seed), "int8"))
        p16 = stacked_trees(spec, c8_cfg, dev, t32, 50 + seed)
        phase = train_phase(shape, dev, spec, c8_cfg, p16, seed, w=WINDOWS["config8"])
        variants[TRAIN_KERNEL[family]].append(dict(phase["rec"], variant=f"h{C8_HIDDEN}"))
        train_fault_probe(spec, c8_cfg, p16, phase)
        del phase, p16
        torch.cuda.empty_cache()
    kf_params = {}
    for hid in (16, 32):
        cfg_h = dataclasses.replace(deepar_cfg, hidden=hid)
        kf_params[hid] = deepar_spec.init(torch.Generator().manual_seed(60 + hid + seed), cfg_h,
                                          device=dev)
        rec = replay_phase(dev, deepar_spec, cfg_h, kf_params[hid], windows)
        variants["deepar_forecast"].append(dict(rec, variant=f"h{hid}"))
    results["legacy_score"] = legacy_score_phase(dev)
    results["adam_counts"] = adam_counts_phase(dev)
    tf_cfg = make_config("transformer", {})  # dim 128, depth 4, heads 4, context 256, bf16
    tf_spec, tfs = scorers("transformer", tf_cfg, 14 + seed)
    results["transformer32"] = transformer_phase(dev, tf_cfg, tfs[("f32", False)].params)
    # the transformer's train kernels at a train step's chunk, then the
    # step itself at the full train plane
    results["transformer32_train"] = tf_train_kernel_phase(
        dev, tf_cfg, tfs[("f32", False)].train_chunk_slots())
    tf_train_phase(dev, tf_spec, tf_cfg, tfs[("f32", False)].params, seed)
    torch.cuda.empty_cache()
    tf_replay_cfg = make_config("transformer", {"context": TF_REPLAY_CONTEXT})
    gen = torch.Generator().manual_seed(15 + seed)
    tf_fc_params = own_affines(tf_spec.init(gen, tf_replay_cfg, device=dev), gen)
    results["transformer_replay"] = transformer_replay_phase(
        dev, tf_replay_cfg, tf_fc_params, windows)
    vit_cfg = tv.VIT_B16  # 224, patch 16, dim 768, depth 12, heads 12, 1000 classes, bf16
    gen = torch.Generator().manual_seed(16 + seed)
    vit_params = own_affines(tv.init(gen, vit_cfg, device=dev), gen)
    frames = np.stack(camera_frames(vit_cfg.image_size, VIT_BATCH, seed=5 + seed))
    wires, k_main, extent = vit_wires(frames)
    emit({"phase": "vit_wire", "frames": VIT_BATCH, "extent": extent, "k": k_main,
          "raw_bytes": frames.nbytes,
          "wire_bytes": {f"sub{s_}_k{k}": lay.wire_bytes(VIT_BATCH)
                         for (s_, k), (_, lay) in sorted(wires.items())}})
    x_u8 = torch.from_numpy(frames).to(dev)
    results["vit_b16"] = vit_phase(dev, vit_params, x_u8, wires, k_main)
    vit_accuracy_phase(vit_params, x_u8, wires[(2, k_main)])
    # the ViT's train kernels and its train step at config 5's batch; the
    # per-tenant train forms of the other families on the card
    vit_images, vit_labels = vit_train_inputs(dev, x_u8, seed)
    results["vit_b16_train"] = vit_train_kernel_phase(dev, vit_params, vit_images, vit_labels)
    vit_train_step_phase(dev, vit_params, vit_images, vit_labels)
    per_tenant_train_phase(dev)
    torch.cuda.empty_cache()
    # KE, KN and KQ on the transformer's int8 and bf16 serving trees; KA's
    # tiled forward and backward at every shape it takes
    results["transformer32_quant"] = quant_kernel_phase(dev, tf_cfg, tfs[("f32", False)].params)
    results["tiled"] = tiled_records(tiled_attention_phase(dev))
    staged = staged_attention_phase(dev)
    torch.cuda.empty_cache()
    # K3'c's serving half: KW's multi-block form; KS and KD at the wide and
    # long shapes in windows mode, and in ring mode at main path m's
    # flushes; KF at config 3's 168-point context
    k3c = results["k3c"] = {"window_update_multi": kw_multi_phase(dev)}
    scan_shapes = {name: [] for name in ("lstm_score", "gru_score", "lstm_score_wide",
                                         "gru_score_wide")}
    for i, (hid, w, fmt, t, b) in enumerate(WIDE_WINDOWS):
        for family in ("lstm_ad", "deepar"):
            for dtype in ("bfloat16", "float32"):
                rec = wide_window_phase(dev, family, hid, w, fmt, t, b, dtype, 70 + i + seed)
                scan_shapes[rec.pop("name")].append(rec)
    results["tenants32"]["lstm_score"]["shapes"] = scan_shapes["lstm_score"]
    results["forecasting32"]["gru_score"]["shapes"] = scan_shapes["gru_score"]
    wide_masters = {}
    for family, shape, hid, w in WIDE_MAIN:
        spec_f = get_model(family)
        cfg_f = make_config(family, {"hidden": hid, "window": w})
        wide_masters[family] = stacked_trees(spec_f, cfg_f, dev, t32, 80 + hid + seed)
        name = scan_kernel(family, hid, w)
        rec = scan_variant_phase(shape, dev, spec_f, cfg_f, wide_masters[family], "f32", w=w)
        k3c[name] = dict(rec, shape=f"{shape} w{w}", shapes=scan_shapes[name])
        variants[name] = []
    kf_windows = torch.from_numpy(replay_windows(KF_CONTEXT)).to(dev)
    kf168 = {hid: deepar_spec.init(
        torch.Generator().manual_seed(90 + hid + seed),
        make_config("deepar", {"context": KF_CONTEXT, "hidden": hid}), device=dev)
        for hid in sorted({h for h, _ in KF_SHAPES})}
    kf_recs = {}
    for hid, ns in KF_SHAPES:
        cfg_h = make_config("deepar", {"context": KF_CONTEXT, "hidden": hid, "num_samples": ns})
        route, _ = kf_route(hid, ns, cfg_h.horizon, KF_CONTEXT)
        rec = replay_phase(dev, deepar_spec, cfg_h, kf168[hid], kf_windows,
                           shape=f"deepar_replay{KF_CONTEXT}", fault=(hid, ns) == KF_SHAPES[0])
        kf_recs[(hid, ns)] = dict(rec, shape=f"deepar_replay{KF_CONTEXT} h{hid} s{ns}", form=route,
                                  variant=f"h{hid}" if route == "block" else f"h{hid},s{ns}")
    # the kernels line: (40, 256) KF's wide record, (40, 100) its other main
    # path variant, the rest under shapes (hidden 64 at 100 paths is the
    # one-block form's)
    k3c["deepar_forecast_wide"] = dict(kf_recs[KF_SHAPES[0]], shapes=[
        r for k, r in kf_recs.items() if r["form"] == "wide" and k not in KF_MAIN])
    variants["deepar_forecast_wide"] = [kf_recs[k] for k in KF_MAIN if k != KF_SHAPES[0]]
    results["deepar_replay"]["deepar_forecast"]["shapes"] = [
        r for r in kf_recs.values() if r["form"] == "block"]
    torch.cuda.empty_cache()
    # K3'c's training half: KB and KR at main path m's shapes (their wide
    # forms), hidden 64 at window 256 (the templated KB) and odd widths,
    # each against the plain version; an injected fault a family
    wide_train = []
    for family, shape, hid, w, n_slots, n_streams, fault in WIDE_TRAIN:
        wide_train.append(wide_train_phase(dev, family, shape, hid, w, n_slots, n_streams,
                                           fault, seed))
        torch.cuda.empty_cache()
    for name, rec in wide_train_records(wide_train).items():
        if name.endswith("_wide"):
            k3c[name] = rec
        else:  # the templated forms past window 128
            shape = "tenants32" if name == "lstm_train" else "forecasting32"
            results[shape][name].setdefault("shapes", []).extend([rec] + rec.pop("shapes"))
    # the attention families past their caps, each kernel alone:
    # KE's raw form (raw histories of any length), KA's split form forward
    # and backward (head dims past 256), KT's sort and bf16-weight forms
    gen = torch.Generator().manual_seed(18 + seed)
    tf_raw_params = own_affines(tf_spec.init(gen, tf_cfg, device=dev), gen)
    k3d = results["k3d"] = {"tf_embed_raw": ke_raw_phase(dev, tf_cfg, tf_raw_params, seed)}
    k3d.update(split_attention_phase(dev))
    kt_variants, kt_recs = kt_phase(dev, vit_params, seed)
    variants["vit_head"] = [dict(r, variant=v) for v, r in kt_variants.items()]
    results["vit_b16"]["vit_head"]["shapes"] = [
        {k_: r[k_] for k_ in ("compute", "head", "k", "form", "ms", "plain_ms", "library_ms",
                              "bound_ms")} for r in kt_recs.values()]
    torch.cuda.empty_cache()
    # K3'c's last part, the global forms (the block state in global memory):
    # each alone past its wide form's cap (KS also at 2,049 and 4,096),
    # forced at main path m's shapes against the wide form, and at main
    # paths q's and r's shapes (the kernels line's records: KS and KD in
    # each weight format, KB and KR, KF on config 3's 128 windows)
    k3e = results["k3e"] = {}
    scan_recs = {"lstm_score_global": [], "gru_score_global": []}
    for family, hid in GLOBAL_SCAN:
        scan_recs[f"{SCORER[family][0]}_global"].append(global_scan_phase(dev, family, hid, seed))
        torch.cuda.empty_cache()
    k3e["global_forced"] = global_forced_phase(dev, seed)
    for family, hid, shape in WIDE_PATHS:
        spec_f = get_model(family)
        cfg_f = make_config(family, {"hidden": hid, "window": WINDOW})
        name = f"{SCORER[family][0]}_global"
        m_f = stacked_trees(spec_f, cfg_f, dev, SHAPES[shape][0], 220 + hid + seed)
        recs = [scan_variant_phase(shape, dev, spec_f, cfg_f, m_f, fmt, iters=1)
                for fmt in ("f32", "bf16", "int8")]
        k3e[name] = dict(recs[0], shape=f"{shape} h{hid}", shapes=scan_recs[name])
        variants[name] = recs[1:]
        del m_f
        torch.cuda.empty_cache()
        t_name = train_kernel(family, hid, WINDOW)
        t_s = SHAPES[shape]
        rec = wide_train_phase(dev, family, shape, hid, WINDOW, t_s[0], t_s[2], True, seed,
                               bad=truncated_loss(spec_f, GLOBAL_CAPS[t_name[:-7]]),
                               plain_rows=WIDE_PATH_PLAIN_ROWS, iters=1)
        k3e[t_name] = dict(rec, shapes=[])
        variants[t_name] = []
        torch.cuda.empty_cache()
    for family, hid in GLOBAL_TRAIN:
        t_name = train_kernel(family, hid, WINDOW)
        k3e[t_name]["shapes"].append(wide_train_phase(
            dev, family, "global", hid, WINDOW, 2, GLOBAL_TRAIN_STREAMS, True, seed,
            bad=truncated_loss(get_model(family), GLOBAL_CAPS[t_name[:-7]])))
        torch.cuda.empty_cache()
    r_hid = dict((f, h) for f, h, _ in WIDE_PATHS)["deepar"]
    r_cfg = make_config("deepar", {"context": REPLAY_CONTEXT, "hidden": r_hid, "num_samples": 64})
    r_params = deepar_spec.init(torch.Generator().manual_seed(230 + seed), r_cfg, device=dev)
    k3e["deepar_forecast_global"] = dict(
        replay_phase(dev, deepar_spec, r_cfg, r_params, windows, shape=f"r forecast h{r_hid}",
                     iters=1),
        shape=f"deepar_replay h{r_hid} s64", variant=f"h{r_hid},s64",
        shapes=[global_kf_phase(dev, deepar_spec, windows, seed)])
    variants["deepar_forecast_global"] = []
    del r_params
    torch.cuda.empty_cache()
    # K14: KA's ring step alone, at main path s's shape in each mask regime
    # and at ViT-B/16's and the widest head dims
    results["k14"] = {"attention_ring": ring_step_phase(dev, seed)}

    # the main paths, counts set to 0 just before each and read just after
    rng = np.random.default_rng(2024 + seed)
    launches = {name: 0 for name in kernels.KERNELS}
    vlaunches: dict = {}  # launches by variant, "name[variant]"

    def tally(counts, vcounts) -> None:
        for name, n in counts.items():
            launches[name] += n
        for key, n in vcounts.items():
            vlaunches[key] = vlaunches.get(key, 0) + n

    twins = {}
    for family, sc, flushes, seq0 in (("lstm_ad", lstm, (8, 3), 0),
                                      ("deepar", dar, (4, 2), 1000),
                                      ("transformer", tfs, (4, 2), 2000)):
        rec32, recbf = [], []
        kernels.reset_launches()
        main = drive(sc[("f32", False)], flushes[0], rng, seq0, rec32)
        bf = drive(sc[("bf16", False)], flushes[1], rng, seq0 + 100, recbf)
        counts = kernels.launches()
        emit({"phase": "main_path", "family": family, "flushes": main["flushes"],
              "bf16_flushes": bf["flushes"], "rows": main["rows"], "bf16_rows": bf["rows"],
              "traffic_gen_s": main["gen_s"], "protocol_s": main["protocol_s"],
              "protocol_rows_per_s": main["rows"] / main["protocol_s"],
              "device_ms_per_flush": main["device_ms"],
              "device_busy_share": sum(main["device_ms"]) / 1e3 / main["protocol_s"],
              "negative_scores": main["negative"] + bf["negative"], "launches": counts})
        for name in ("window_update", *SCORER[family], "score_sketch", "gather_rows"):
            check(counts[name] > 0, f"{family} main path launched {name}")
        tally(counts, kernels.variant_launches())
        bar = family != "transformer"
        (err32, twin32), (errbf, twinbf) = (
            twin_check(sc[("f32", False)], sc[("f32", True)], rec32, main["host"],
                       f"{family} f32 wire", bar),
            twin_check(sc[("bf16", False)], sc[("bf16", True)], recbf, bf["host"],
                       f"{family} bf16 wire", bar),
        )
        twins[family] = (err32, errbf)
        if not bar:
            # the transformer's bf16 NLL: held by its accuracy against an
            # f32 plain scorer and per slot against its twin, a check shown
            # to reject two faults; the f32 kernel path per row against a
            # float64 plain scorer on the first two f32-wire flushes
            f32 = dataclasses.replace(tf_cfg, dtype="float32")
            for wire, rec, drv, twin_rows in (("f32", rec32, main, twin32),
                                              ("bf16", recbf, bf, twinbf)):
                accuracy_check(f"transformer bf16, {wire} wire vs f32",
                               [h[0][:m] for h, (*_, m) in zip(drv["host"], rec)], twin_rows,
                               replay_as(mm, tf_spec, f32, sc[(wire, True)], rec),
                               slots_of(rec))
            fault_probe(mm, tf_spec, tf_cfg, sc[("f32", True)], rec32, twin32)
            like, two = sc[("f32", True)], rec32[:2]
            f64_check("transformer f32 vs f64",
                      replay_as(mm, tf_spec, f32, like, two, plain=False),
                      replay_as(mm, tf_spec, f32, like, two),
                      replay_as(mm, f64_spec(tf_spec), f32, like, two), slots_of(two))
    # the train lane, on the LSTM-AD, DeepAR and transformer drives' warmed
    # rings
    for family, sc, spec, cfg, seq0, steps in (
            ("lstm_ad", lstm, lstm_spec, lstm_cfg, 3000, TRAIN_STEPS),
            ("deepar", dar, deepar_spec, deepar_cfg, 4000, TRAIN_STEPS),
            ("transformer", tfs, tf_spec, tf_cfg, 3500, TF_TRAIN_STEPS)):
        tally(*train_drive(mm, family, spec, cfg, sc, rng, seq0, steps))
        torch.cuda.empty_cache()
    # the widths and formats on their main paths: tenants32 flushes of
    # each KS/KD variant, config 8 served and trained (both families)
    for family, spec, cfg, seq0 in (("lstm_ad", lstm_spec, lstm_cfg, 5000),
                                    ("deepar", deepar_spec, deepar_cfg, 6000)):
        for i, (hid, fmt) in enumerate(SCAN_VARIANTS):
            tally(*variant_drive(mm, spec, dataclasses.replace(cfg, hidden=hid),
                                 masters[(family, hid)], fmt, rng, seq0 + 100 * i))
        tally(*config8_drive(mm, dev, family, rng, seed, seq0 + 900))
        torch.cuda.empty_cache()
    del masters
    # main path j: transformer32 served from int8 and bf16 weights, then a
    # train-lane step and commit_swap
    for i, fmt in enumerate(("int8", "bf16")):
        tally(*quant_drive(mm, tf_spec, tf_cfg, tfs[("f32", False)].params, fmt, rng,
                           7000 + 100 * i))
    # main path l: config 1's flush, through KW's multi-block form
    c1_counts, c1_variants, _ = config1_drive(mm, dev, rng, seed, 8000)
    tally(c1_counts, c1_variants)
    # main path m: forecasting32 and tenants32 at wide hidden and long
    # windows (each with an injected fault shown rejected), then their train
    # lane (KB's and KR's wide forms) and a flush from the trained weights;
    # config 3's forecast at context 168 with 100 and 256 paths
    for i, (family, _shape, hid, w) in enumerate(WIDE_MAIN):
        tally(*variant_drive(mm, get_model(family), make_config(
            family, {"hidden": hid, "window": w}), wide_masters[family], "f32", rng,
            8100 + 100 * i, w=w, fault=swapped_gates, lane_steps=WIDE_LANE_STEPS))
        torch.cuda.empty_cache()
    del wide_masters
    tally(*kf_drive(dev, deepar_spec, kf168, kf_windows, seed))
    kernels.reset_launches()
    samples, mean = deepar_spec.forecast(
        fc_params, deepar_cfg, windows, torch.Generator(dev).manual_seed(2024 + seed))
    torch.cuda.synchronize()
    counts = kernels.launches()
    check(counts["deepar_forecast"] > 0, "forecast launched deepar_forecast")
    check(bool(torch.isfinite(samples).all() and torch.isfinite(mean).all()),
          "forecast: finite samples and mean")
    lo, hi = float(windows.min()), float(windows.max())
    check(lo - 10 < float(mean.min()) and float(mean.max()) < hi + 10,
          "forecast: mean within the series' range +- 10")
    emit({"phase": "main_path", "family": "deepar", "path": "forecast",
          "series": int(windows.shape[0]), "samples": int(samples.shape[0]),
          "horizon": int(samples.shape[-1]), "mean_range": [float(mean.min()), float(mean.max())],
          "launches": counts})
    tally(counts, kernels.variant_launches())
    for hid, p_h in kf_params.items():  # KF's other widths on the same windows
        kernels.reset_launches()
        samples, mean = deepar_spec.forecast(
            p_h, dataclasses.replace(deepar_cfg, hidden=hid), windows,
            torch.Generator(dev).manual_seed(2025 + seed))
        torch.cuda.synchronize()
        vcounts = kernels.variant_launches()
        check(vcounts.get(f"deepar_forecast[h{hid}]", 0) == 1,
              f"forecast at hidden {hid} launched its KF variant")
        check(bool(torch.isfinite(samples).all()) and lo - 10 < float(mean.min())
              and float(mean.max()) < hi + 10, f"forecast at hidden {hid}: finite, in range")
        tally(kernels.launches(), vcounts)
    kernels.reset_launches()
    t0 = time.perf_counter()
    samples, means = tf_spec.forecast(
        tf_fc_params, tf_replay_cfg, windows, torch.Generator(dev).manual_seed(2024 + seed))
    torch.cuda.synchronize()
    tf_forecast_s = time.perf_counter() - t0
    counts = kernels.launches()
    hz, depth = tf_replay_cfg.horizon, tf_replay_cfg.depth
    check(counts["tf_head"] == hz and counts["tf_embed"] == hz,
          f"transformer forecast launched KN and KE {hz} times each")
    check(counts["layernorm"] == 2 * depth * hz and counts["attention"] == depth * hz
          and counts["bias_gelu"] == depth * hz, "transformer forecast launched KL, KA, KU")
    check(tuple(samples.shape) == tuple(means.shape) == (windows.shape[0], hz),
          "transformer forecast: samples and means f32[B, horizon]")
    check(bool(torch.isfinite(samples).all() and torch.isfinite(means).all()),
          "transformer forecast: finite samples and means")
    check(lo - 10 < float(means.min()) and float(means.max()) < hi + 10,
          "transformer forecast: means within the series' range +- 10")
    emit({"phase": "main_path", "family": "transformer", "path": "forecast",
          "series": int(windows.shape[0]), "horizon": hz, "seconds": tf_forecast_s,
          "mean_range": [float(means.min()), float(means.max())], "launches": counts})
    tally(counts, kernels.variant_launches())
    svc = StreamingMedia(device=dev, generator=torch.Generator().manual_seed(17 + seed))
    svc.load_classifier_params(vit_params)
    tally(*vit_drive(svc, vit_params, frames, wires))
    tally(*vit_train_drive(dev, vit_params, vit_images, vit_labels))
    # main path k: ViT-B/16 at 384 through the tiled KA
    for name, n in vit384_drive(dev, seed).items():
        launches[name] += n
    torch.cuda.empty_cache()
    # main path n: the transformer's forecast over long raw histories (KE's
    # raw form); o: the ViT at top-k past 64 and on a bf16-stored tree (KT's
    # sort and bf16-weight forms); p: the transformer at head dim 512 (KA's
    # split form), 2 flushes and one train chunk
    tally(*ke_raw_drive(dev, tf_spec, tf_cfg, tf_raw_params, seed))
    tally(*vit_topk_drive(dev, svc, vit_params, frames, wires[(2, k_main)]))
    tally(*wide_head_drive(mm, dev, rng, seed, 9000))
    torch.cuda.empty_cache()
    # main paths q and r: LSTM-AD at hidden 2,048 and DeepAR at 2,304 (past
    # every wide form's cap: the global forms) served from each weight
    # format and trained; r also forecasts config 3's 128 windows
    for i, (family, hid, shape) in enumerate(WIDE_PATHS):
        tally(*wide_path_drive(mm, dev, family, hid, shape, rng, seed, 9500 + 500 * i,
                               windows=windows if family == "deepar" else None))
    # main paths s, t, u (K14): the sequence-parallel forecast seed, the
    # tensor-parallel ViT-B/16 and GPipe on 4 gloo ranks sharing the card,
    # then each on NCCL's world of one rank (no rotation, the psum the
    # identity)
    torch.cuda.empty_cache()
    k14 = k14_inputs(dev, vit_params, vit_cfg, vit_images, seed)
    k14_ref = k14_refs(dev, k14)
    for n, backend in ((K14_RANKS, "gloo"), (1, "nccl")):
        tally(*k14_drive(dev, k14, k14_ref, n, backend))
    del k14, k14_ref
    torch.cuda.empty_cache()
    # the forward's device time (CUDA events), kernel path and plain twin
    (y_m, cb_m, cr_m), lay_m = wires[(2, k_main)]
    planes_m = [torch.from_numpy(a).to(dev) for a in (y_m, cb_m, cr_m)]
    flops = VIT_BATCH * vit_flops_per_image(vit_cfg)
    fwd = {}
    for path, run in (("frames", lambda c, f: f(vit_params, c, x_u8, VIT_TOPK)),
                      (f"dct k{k_main}", lambda c, f: f(vit_params, c, *planes_m, lay_m,
                                                        VIT_TOPK))):
        kern, plain = ((tv.classify, tv.classify_plain) if path == "frames"
                       else (tv.classify_dct, tv.classify_dct_plain))
        ms = cuda_time_ms(lambda: run(vit_cfg, kern), 5, 1)
        fwd[path] = dict(ms=ms, plain_ms=cuda_time_ms(lambda: run(vit_cfg, plain), 2, 1),
                         frames_per_s=VIT_BATCH / ms * 1e3, tflop_per_s=flops / ms / 1e9,
                         share_of_bf16_peak=flops / (ms / 1e3) / BF16_FLOPS)
    emit({"phase": "forward", "shape": "vit_b16", "batch": VIT_BATCH, "flops": flops, **fwd})
    profile_run("vit_b16 frames", lambda: tv.classify(vit_params, vit_cfg, x_u8, VIT_TOPK))
    profile_flush(tfs[("f32", False)], rng)
    emit({"phase": "twin", **{f"{fam}_{wire}_wire_max_abs_err": err
                              for fam, errs in twins.items()
                              for wire, err in zip(("f32", "bf16"), errs)}})

    # KE's and KN's weight formats beside their f32 records
    for name in ("tf_embed", "tf_head"):
        variants[name] = [results["transformer32_quant"][name][f] for f in ("int8", "bf16")]
    variants.update(staged_records(staged, results))
    kernel_line = []
    for name, shape in (("window_update", "tenants32"), ("lstm_score", "tenants32"),
                        ("gru_score", "forecasting32"), ("deepar_forecast", "deepar_replay"),
                        ("lstm_train", "tenants32"), ("gru_train", "forecasting32"),
                        ("adam_update", "tenants32"),
                        ("score_sketch", "tenants32"), ("gather_rows", "tenants32"),
                        *((n, "transformer32") for n in TF_KERNELS),
                        *((n, "transformer32_train") for n in TF_TRAIN_KERNELS),
                        *((n, "vit_b16") for n in VIT_KERNELS),
                        *((n, "vit_b16_train") for n in VIT_TRAIN_KERNELS),
                        ("dequant", "transformer32_quant"), ("attention_tiled", "tiled"),
                        ("attention_tiled_bwd", "tiled"), ("window_update_multi", "k3c"),
                        ("lstm_score_wide", "k3c"), ("gru_score_wide", "k3c"),
                        ("deepar_forecast_wide", "k3c"), ("lstm_train_wide", "k3c"),
                        ("gru_train_wide", "k3c"), ("tf_embed_raw", "k3d"),
                        ("attention_split", "k3d"), ("attention_split_bwd", "k3d"),
                        ("lstm_score_global", "k3e"), ("gru_score_global", "k3e"),
                        ("deepar_forecast_global", "k3e"), ("lstm_train_global", "k3e"),
                        ("gru_train_global", "k3e"), ("attention_ring", "k14")):
        r = results[shape][name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"sitewhere_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        if name in variants:
            # the record above is hidden 64 (f32 masters for KS/KD); the
            # variants each with their own numbers and main-path launches
            own = r.get("variant") or {"lstm_score": f"h{HIDDEN},f32",
                                       "gru_score": f"h{HIDDEN},f32", "tf_embed": "f32",
                                       "tf_head": "f32",
                                       "vit_head": "argmax,f32"}.get(name, f"h{HIDDEN}")
            entry["variant"] = own
            entry["variants"] = []
            for v in [dict(r, variant=own)] + variants[name]:
                n = vlaunches.get(f"{name}[{v['variant']}]", 0)
                check(n > 0, f"{name}[{v['variant']}] launched on a main path")
                entry["variants"].append({
                    "variant": v["variant"], "launches": n,
                    **{k: v[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}})
        if "shapes" in r:
            entry["shapes"] = r["shapes"]
        check(entry["launches"] > 0, f"{name} launched on a main path")
        kernel_line.append(entry)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
