#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (Hopper, sm_90a).

Drives the port's main paths once, with random weights from a seed, through
the hand-written kernels:

* ``google_vit`` ViT-B/16 with a rank-8 LoRA merged into q/k/v/o, in bf16,
  through FGSM and PGD-10 at batch 64: the packed-attention kernel
  (``csrc/attention_packed.cu``, at this shape the wgmma core of
  ``csrc/attn_wgmma.cuh``), forward and backward; then the same with
  ``fuse_attn_block`` on (the fused attention half-block,
  ``csrc/attn_block.cu``: its wgmma + TMA per-head and row-block kernels,
  and the LN-fused MLP on a ViT path) and with
  ``use_fused_mlp`` on (the fused MLP without LayerNorm, ``csrc/ln_mlp.cu``);
* ViT-B/16 training at batch 64, f32 parameters and bf16 compute, 5 steps
  each through ``train.loop.fit``: the full fine-tune (AdamW + StepLR,
  augmentation on, ``fuse_attn_block`` on: the kernels' parameter gradients)
  and the LoRA defense (rank 8 on q/k/v/o unmerged, dropout 0.1, head
  trainable, Adam, ``use_fused_mlp`` on: the base frozen);
* the other attack families on the same ViT-B/16 and batch, labelled by
  the model's own clean predictions: the EOT patch (``PatchConfig()``: P 24,
  500 Adam iterations at B=16, circle and square) and its application, RP2
  (100 iterations on each of 3 classes) applied by label, and the AutoAttack
  standard suite at the CLI's defaults (ε 0.031, 100 iterations, 9
  targets, 5000 Square queries): the packed-attention kernel in every
  forward and backward;
* the head-major attention kernel through its entry ``attention_auto`` (no
  model path of the package calls it);
* ``swin`` Swin-B (all 24 blocks) with a rank-8 LoRA merged into qkv/proj,
  in bf16, through FGSM and PGD-10 at batch 64: the window-attention kernel
  (``csrc/window_attention.cu``, at every Swin-B stage its wgmma + TMA
  device code), forward and backward; then the same with
  ``use_fused_mlp`` on (the fused MLP at the four Swin-B stage widths);
* ``convnext`` ConvNeXt-B (all 36 blocks, dims 128-1024) with a rank-8 LoRA
  merged into every pwconv1/pwconv2, in bf16, both kernel fields on, through
  FGSM and PGD-10 at batch 64: the depthwise 7x7 kernel (``csrc/dwconv7.cu``,
  its TMA-ring device code, forward and input-gradient roles) and the
  LayerNorm-fused MLP kernels
  (``csrc/ln_mlp.cu``, forward and backward);
* the eval-compose stage for ``swin``, ``convnext`` and ``yolo11-cls`` from
  memory: two adapters with heads (YOLO11's nested conv + linear head under
  ``framework_head.*``) through the port's PEFT writer and reader, then the
  accuracy matrix over the clean batch and the FGSM/PGD batches, f32 params
  and bf16 compute;
* ``yolo11-cls`` YOLO11n (no kernel of this repo: every launch count 0) with
  a rank-8 LoRA merged into the C2PSA attention convs, in bf16, through
  FGSM and PGD-10 at batch 64;
* the pretrained-weight import through ``models.pretrained.load_pretrained``:
  ViT-B/16 written by ``hf_from_vit_params`` as a torch ``.pth`` and as an
  HF directory, a head-less DINO state dict, YOLO11-cls as an ultralytics
  ``.pth`` (also into a 1000-class config), YOLO11-s weights into the
  YOLO11-n config (which must raise);
* training of the other families at batch 64, f32 parameters and bf16
  compute, 5 steps each through ``train.loop.fit`` (TRAIN_RUNS): Swin-B
  full fine-tune (fields off) and LoRA (rank 8 on qkv/proj, dropout 0.1,
  ``use_fused_mlp``), ConvNeXt-B full fine-tune and LoRA (rank 8 on
  pwconv1/pwconv2) with both kernel fields, YOLO11-cls full fine-tune and
  LoRA on the C2PSA convs: the window kernel's bias-gradient recompute and
  dwconv7's filter gradient run in training here;
* the robustness study through the port's runner
  (``tools/run_robustness.py``) on the card: ``google_vit`` (ViT-B/16, 224
  px, 12 blocks) on the hard 12-class synthetic corpus, the eight CLI stages
  (synth-data, train, attack, patch-attack, autoattack, rp2-attack,
  train-lora over the five families, eval-compose) each in a fresh process
  over the filesystem contract (PNGs through the native codec, metadata.csv
  through the ``csv`` module; no PIL or pandas), at cut counts
  (``RUNNER_ARGS``), then the ``attack`` stage once in this process;
* the raw-corpus ETL, the ``process`` stage (``data/process.py``: host code,
  no kernel), on the card's host: over an empty corpus root, then over a
  LISA-layout fixture at LISA's size (6,610 JPEG frames of 640 x 480); it
  decodes through OpenCV or PIL, whichever imports;
* the W8A8 attack path (``ops/quant.py``: int8 weights per output channel,
  int8 activations per row, ``torch._int_mm``) on the merged ViT-B/16 through
  PGD-10 at batch 64 beside the bf16 tree, its three kernel fields bypassed,
  BiLoRA's delta through cuFFT, and the two example workflows
  (``examples/*_torch.py``) on the card.

Phases, one line each (or a few):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel source compiled with nvcc from the checkout, in
   parallel; per source nvcc's seconds, ptxas registers and spills and any
   wgmma serialisation warning, each wgmma kernel's and dwconv7's TMA-ring
   kernel's own line, and dwconv7's plan (tile, items, CTAs, ring) at the
   ConvNeXt-B stages, its launcher's held equal to the wrapper's;
3. kernels against their plain PyTorch versions on the card, forward and
   gradients: packed attention at (B, N, H, hd) = (2, 37, 3, 32),
   (64, 197, 12, 64), (bf16) (2, 300, 2, 64) and (bf16) the tile edges of
   the wgmma kernels, N = 1, 63, 64, 65, 128, 208, 256 at (2, N, 2, 64), the
   backward with the forward's output and log-sum-exp as autograd passes
   them and without (the same bits), the log-sum-exp itself; window attention at the
   four Swin-B stage shapes (B=64; the shift mask on stages 1-3, zeros on
   stage 4), at a ragged (2, 4, 16, 2), at the Hopper kernel's tile edges
   (one window of n = 16, 49, 64 tokens, random masks) and at an odd head
   count (2, 4, 49, 3), which keeps the mma.sync kernel, each line naming
   its device code, with a relative-position bias at
   the scale of a pretrained Swin's (std 1-2, another per head), and the
   kernel's change from a zero bias held against the plain version's;
   dwconv7 at the four ConvNeXt-B stage shapes (B=64) and a ragged
   (2, 10, 9, 8), f32 and bf16, forward, input gradient, and the input
   gradient equal to the forward with the flipped filter, each line naming
   its device code, bf16 equal bit for bit to the staged kernel it
   replaced; the LN-fused MLP
   at the four ConvNeXt-B (T, D) shapes, at the ViT-B shape (12608, 768,
   3072) and at a ragged (70, 128, 512), bf16, forward and dx, with LN
   scale/bias and b1/b2 at std 0.5, and the plain version without each of
   them shown to miss the limit by a factor of 5 or more (so the check sees
   every one); the fused MLP without LayerNorm at the ViT-B shape, a Swin-B
   stage shape and the ragged one, the same way; both fused MLPs at the
   edges of the wgmma kernels' 64-row tiles (T = 1, 63 ... 129 over every
   width, with and without the two-CTA cluster) and at a shape that keeps
   the mma.sync kernels; the attention half-block at
   (64, 197, 768) with 12 heads and a ragged (2, 37, 192) with 3, bf16, with
   LN scale/bias and the four biases at std 0.5 (each seen by the check) and
   q/k weights scaled up so that the softmax is far from uniform, and at the
   edges of its 64-row tiles and score widths, (3, N, 192) with 3 heads for
   N = 1, 63, 64, 65, 128, 197, 208, 256; the
   head-major attention kernel at the packed kernel's shapes, equal bit for
   bit to the packed kernel on the transposed operands; the three parameter-
   gradient functions against autograd through the plain versions; every
   backward bitwise reproducible; then dwconv7 at its TMA-ring kernel's
   edges (DW_EDGE_SHAPES: a 1 x 1 map, tiles ragged in H, W and channels, a
   persistent schedule's ragged tail), both roles, against the plain
   version and bit for bit against the staged kernel; and the LN-fused MLP
   at (50176, 256, 1024) and the ConvNeXt-B stage-1 shape under 8 input
   draws of their own (LN_SEEDS): forward and dx at MLP_TOL, the kernels'
   LayerNorm prologue (h, mean, rstd) against the plain version's and f64
   statistics, and the kernels against the plain version fed their own h;
4. model, per backbone: merged bf16 state through the port's checkpoint
   writer/reader (byte-equal), then logits of the kernel path against the
   plain path (ViT, Swin: bf16 and f32, Swin's bias tables drawn at std 1.5)
   or against the flags-off library path (ConvNeXt: bf16, layer scale drawn
   in 0.1-0.5 so that every block matters, biases at std 0.1) or against the
   f32 model (YOLO11-cls, BN statistics and affine redrawn); the merged
   weights equal to base + s*A*B; then the weight import (trees bit for bit
   the source's, bf16 logits equal, the head re-initialized for another class
   count, a wrong scale refused);
5. attack, per backbone: FGSM + PGD-10 from a uint8 batch; output range,
   eps-ball, loss increase, and the launch counts (reset just before the
   run, read just after) that prove the path ran the kernels: for Swin no
   bias gradient, for ConvNeXt 36 x 11 launches of each kernel role and no
   filter or parameter gradient, for ViT-B with ``fuse_attn_block`` 12 x 11
   launches of the half-block and of the LN-fused MLP, forward and backward,
   no packed-attention launch and no parameter gradient. Training: exact
   launch counts per step (full fine-tune: 12 parameter-gradient recomputes
   of each fused op; LoRA: none, and no half-block launch where LoRA factors
   are attached), finite gradients, every trainable leaf changed and every
   frozen leaf bitwise unchanged, the cross-entropy on the fixed batch
   falling, one step's loss and gradient norms against the fields-off model,
   the trained adapter through the PEFT writer/reader and merged into the
   base against the unmerged model; the same for each of TRAIN_RUNS (exact
   launches per step: Swin-B 24 + 24 window launches, and in the full
   fine-tune 24 bias-gradient recomputes; with ``use_fused_mlp`` 24 + 24
   fused MLP launches; ConvNeXt-B full fine-tune 36 of each dwconv7 role,
   36 filter gradients and 36 + 36 + 36 LN-fused MLP launches and
   parameter-gradient calls; ConvNeXt-B LoRA 36 + 35 dwconv7 launches, the
   first block's input asking no gradient; YOLO11 none). Then eval-compose
   for ``swin``, ``convnext`` and ``yolo11-cls`` (launch counts read the
   same way): 4 variants x 3 datasets,
   base/clean accuracy equal to a direct argmax count, a merged variant's
   weights equal to base + sum s*A*B. The attack families (each run with a
   counting ``entry.apply``; the packed-attention counts must be 12 x its
   forward calls and 12 x its gradient calls, every other count 0): the
   patch and its output in [0, 1] and finite, every pixel outside the warped
   footprint (computed here, in f64) the image's bit for bit, the mean of
   the last 25 losses (-CE) below the first 25's, 500 + 500 model calls per
   patch type and none for the application; RP2's pixels outside the sign
   mask unchanged, 3 x 100 + 3 x 100 calls; AutoAttack's output in the
   ε-ball and [0, 1], robust accuracy at most the clean accuracy of 1, a
   ``stats`` entry for each stage that ran, with its survivors and seconds;
   then APGD-T, FAB-T (10 iterations, 3 targets) and Square (100 queries)
   each alone on the batch, with their exact model calls, since the suite
   ends at the first stage that breaks every example;
6. timing with CUDA events: PGD-10 images/s of each backbone (ConvNeXt-B
   with both kernel fields on, each alone, and both off, in turns; ViT-B with
   each of its three kernel fields and none, in turns), training images/s of
   the full fine-tune and the LoRA defense with the fields off and on, the
   patch training iteration (B=16, host clock over phase 5's 500), an
   APGD-CE iteration (B=64), Square queries/s (B=64, 200 queries), the
   AutoAttack suite's wall and images/s (phase 5's run, the kernels already
   built), kernel
   vs plain times, each kernel's bound (the larger of its FLOP over the
   card's published peak and its bytes over 3.35 TB/s) and the time of the
   one PyTorch call, or library composition, that computes the same
   function (measured here only; the port never calls it in place of a
   kernel), and the eval-compose matrices' wall times. A kernel and its
   library call or composition are timed in turns (kernel, library, three
   times over) and the best of each is kept, because a library call's time
   moves between runs on one shape. Window attention (stages 1 and 3, three
   masks) and the attention half-block (ViT-B) are timed in turns with the
   mma.sync device code they replace, kept in the same sources behind
   entry points that only this script calls; so is dwconv7 (four stages,
   both roles) with the staged kernel it replaced and ``F.conv2d(groups=C)``,
   by CUDA-graph replay (device time: at stage 4 an eager call's host work
   outlasts the kernel). ViT-B, Swin-B and YOLO11-cls PGD are timed over 3
   calls, ConvNeXt-B over 2 calls per variant and turn; each of TRAIN_RUNS
   over 3 steps after a warm-up.

7. the native PNG codec (``utils/native.py``, built with g++ from
   ``native/src``): encode -> decode bit exact on random images of
   CODEC_SIZES, a PNG from a plain filter-0 writer (``plain_png``: the
   standard library's zlib) decoded bit exact, resize + center crop within 2
   LSB (mean < 0.5) of ``F.interpolate(antialias=True)`` on the card, and the
   host's one-thread encode and decode + resize rates; then the runner: the
   fresh-process start-up cost, all eight stages rc 0 (each stage's wall),
   the 27 x 6 matrix with every accuracy in [0, 1], the corpus' test PNGs
   equal to their render from the same seed, a ``--resume`` run that skips
   the seven stages before eval-compose with the same accuracies, a run with
   ``--lora_epochs`` changed that reruns train-lora and eval-compose only,
   and the ``attack`` stage through ``cli.main.main`` in this process with
   every count read around it: 12 packed-attention launches of each
   direction per FGSM or PGD step and batch, every other count 0;
8. the ``process`` stage, which needs OpenCV or PIL on this host: whether
   ``cv2`` and PIL import; the stage in a fresh process (``python -m
   <package>.cli --device cuda process``) over an empty ``--base_dir`` with
   the four image corpora (rc 0, a header-only ``metadata.csv`` for each
   split, each read by the loader as empty) and its wall; then a LISA-layout
   fixture at LISA's size (6,610 JPEG frames of 640 x 480; ETL_BOXES: three
   kept sign boxes a frame, each filled with a flat colour, one too small,
   one of an unknown class) through ``cli.main.main`` in this process with
   every kernel count read around it (all 0): its records (names, source,
   classes), every crop 224 x 224 of one colour within ETL_JPEG_TOL of its
   box's (decoded by the native decoder), crops/s and frames/s. The line
   says which decoder ran;
9. the W8A8 path and BiLoRA: ``int8_matmul`` on the card equal to the same
   inputs on the CPU bit for bit (the weight's int8 form and scales, the
   output, dx) at INT8_SHAPES (the ViT-B dense shapes at B=64 and one that
   the wrapper pads), with its times in turns beside ``torch._int_mm`` in
   both weight layouts, the layout copy, the quantizer and bf16
   ``F.linear``; PGD-10 on the ViT-B quantized over
   ``vit.QUANT_TARGETS_DEFAULT`` beside the bf16 tree on the bf16 model's own
   labels (packed-attention launches read around each, equal, every other
   count 0; output finite, in [0, 1], in the eps-ball, moved; input-gradient
   sign agreement above INT8_SIGN_AGREE; the bf16 model's accuracy on each
   attack's images; images/s of both in turns); the quantized tree with
   ``fuse_attn_block``, ``fuse_ln_mlp``, ``use_fused_mlp``: no ``attn_block``
   or fused-MLP launch, logits equal fields off bit for bit; one warm int8
   PGD-10 call inside ``utils.observability.profile_trace`` (the trace file
   and its device time by group); BiLoRA's delta at (12, 768, 768) and its
   coefficients' gradients on the card against the CPU within BILORA_RTOL;
   both example workflows' ``main`` on the card, their lines, walls and
   trends;
10. the data x model mesh (``parallel/``): (a) NCCL at world size 1, mesh
   (1, 1), ViT-B/16 + rank-8 LoRA in bf16 at B=64: a LoRA step through
   ``fit``, PGD-10 and the four-variant eval-compose, each bit for bit the
   same calls with ``mesh=None``, with both times; (b) gloo, 4 ranks sharing
   the card (``parallel.launch``; NCCL refuses two ranks on one card), mesh
   (2, 2), ViT-B/16 at full width cut to 2 blocks, bf16, B=16 (each rank 8
   rows and 6 of the 12 heads): first one all-reduce and one all-gather of
   CUDA tensors, then the forward logits, PGD-2 and a LoRA step through
   ``fit``, fields off, ``use_fused_mlp`` and ``fuse_ln_mlp``, against one
   process on the card (logits within TP_LOGIT_TOL, PGD-2 perturbation signs above
   TP_SIGN_AGREE, the loss within TP_LOSS_RTOL), every rank's packed
   attention (and fused MLP) launches non-zero; (c)
   ``parallel.dryrun.dryrun_multichip(4, device="cuda")``; then packed
   attention at the tensor-parallel shape (8, 197, 6, 64) against its plain
   version, timed beside SDPA, and the phase's wall time;
11. the measurement entry points: (a) ``python3 bench_torch.py`` from the
   checkout as a user runs it (a fresh process, the default variant): its
   card line, its JSON line (a value, ``bench.py``'s metric name, ``mfu_pct``
   in (0, 100]) and its packed-attention launches, 12 x 10 each way per call
   over 1 + 8 calls, beside phase 6's in-process ViT-B reading; (b) the other
   four ``BENCH_VARIANT``s through ``bench_torch.measure`` in this process at
   BENCH_VARIANT_ITERS timed calls, each held to its kernels' launches
   (BENCH_KERNELS: ``int8`` no fused kernel, ``fusedblock`` ``attn_block`` and
   the LN-fused MLP and no packed attention, ``lnmlp`` the LN-fused MLP); (c)
   each tool of ``<port>/tools/`` (``bench_zoo``, ``bench_train``,
   ``bench_eval``, ``bench_compose``, ``profile_pgd``, ``profile_train``,
   ``profile_eval``) once at cut counts (BENCH_TOOL_ARGS, full widths), its
   artifact read back (every record a value; each profile table with device
   time, an idle share and a kernel of this repo); the phase's wall.

The line before the last is a JSON object describing every kernel (with
``composition_ms``, the library composition's time, for the kernels whose
function no one PyTorch call computes and whose ``library_ms`` is null; window
attention's ``ms`` at the Swin-B stage-3 shape with its shift mask, which
18 of the 24 blocks run; the ConvNeXt kernels' at the stage-3 shape, which
27 of the 36 blocks run); the last line is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the rest of the repository beside it, the script
fails with a non-zero exit.

Run: ``python3 chip_smoke.py`` from the repository root. ``python3
chip_smoke.py --profile google_vit|swin|convnext`` instead builds that
backbone, traces one warm PGD-10 call with ``torch.profiler`` and prints the
device time by kernel group (``<port>/tools/trace_table.py``, the table the
port's ``profile_*`` tools print), one group per device function of this repo
(ViT-B: fields off, then ``fuse_attn_block``; ConvNeXt: kernel fields on,
then off);
``--profile yolo11-cls`` one warm YOLO11-cls PGD-10 call;
``--profile train|train_lora`` traces one warm ViT-B training step, fields
off and then on; ``--profile train_swin|train_convnext`` one warm step of
each of that backbone's TRAIN_RUNS; ``--profile patch|square`` one warm call of 20 ViT-B
patch-training iterations (B=16) or 50 Square queries (B=64), with the
top kernels by name; ``--profile int8`` one warm ViT-B PGD-10 call in bf16
and one W8A8, with the top kernels. It prints no result lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
JAX_SRC = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu/kernels"

# packed attention (B, N, H, hd): the ViT-B/16 main-path shape, a ragged
# small case (bf16: the mma.sync variant), (bf16 only) a sequence past the
# register-resident variants' N <= 256, and (bf16 only) the tile edges of the
# wgmma variant (64-row tiles, 64-key blocks)
MAIN = (64, 197, 12, 64)
EDGE_N = (1, 63, 64, 65, 128, 208, 256)
SHAPES = {"float32": ((2, 37, 3, 32), MAIN),
          "bfloat16": ((2, 37, 3, 32), (2, 300, 2, 64), *((2, n, 2, 64) for n in EDGE_N), MAIN)}
# window attention (B, nW, n, heads, mask): the four Swin-B stages at B=64
# (window 7, hd 32) and a ragged window-4 case; then the Hopper kernel's tile
# edges (n = 16, 49, 64 in one window; a batch that its chunks do not divide)
# and an odd head count, which keeps the mma.sync kernel
WIN_SHAPES = ((64, 64, 49, 4, "shift"), (64, 16, 49, 8, "shift"), (64, 4, 49, 16, "shift"),
              (64, 1, 49, 32, "zeros"), (2, 4, 16, 2, "shift"))
WIN_EDGE_SHAPES = ((3, 1, 16, 2, "random"), (5, 1, 49, 2, "random"), (3, 1, 64, 4, "random"),
                   (2, 4, 49, 3, "shift"))
WIN_TIMED = {"stage 1": WIN_SHAPES[0][:4], "stage 3": WIN_SHAPES[2][:4]}
WIN_MASKS = ("zeros", "shift", "random")
# std of the Swin-B bias tables in phase 4 (a pretrained Swin's are O(1-10))
SWIN_BIAS_STD = 1.5
# fwd (atol, rtol), grads (atol, rtol) per dtype, both kernels
TOL = {"float32": ((1e-4, 1e-3), (1e-4, 1e-3)),
       "bfloat16": ((3e-2, 3e-2), (5e-2, 5e-2))}
# dwconv7 (B, H, W, C): the four ConvNeXt-B stages at B=64 and a ragged case
DW_SHAPES = ((64, 56, 56, 128), (64, 28, 28, 256), (64, 14, 14, 512), (64, 7, 7, 1024),
             (2, 10, 9, 8))
# ... and the bf16 kernel's edges: a 1 x 1 map with one ragged chunk of 8
# channels; tiles ragged in H and W with a ragged chunk; a 15 x 13 map (one
# row past a 14-row tile); a persistent schedule whose items do not divide
# by the CTAs, with a ragged chunk; the stage-3 map with a ragged chunk
DW_EDGE_SHAPES = ((3, 1, 1, 8), (2, 57, 55, 72), (5, 15, 13, 136), (65, 7, 7, 1032),
                  (64, 14, 14, 520))
# LN-fused MLP (T, D, M): the four ConvNeXt-B stages at B=64, the ViT-B/16
# shape (64 x 197 tokens) and a ragged case
MLP_SHAPES = ((200704, 128, 512), (50176, 256, 1024), (12544, 512, 2048), (3136, 1024, 4096),
              (12608, 768, 3072), (70, 128, 512))
# ... and the edges of the wgmma kernels' 64-row tiles, without and with the
# two-CTA cluster (D >= 768), the one-buffer width (1024), a width whose
# warpgroup slice is 192 columns (384), and the shape that keeps the
# mma.sync kernels (D >= 768 with M = 128 mod 256); both fused MLPs take them
MLP_EDGE_SHAPES = ((1, 128, 512), (63, 128, 128), (64, 256, 1024), (65, 384, 1536),
                   (127, 512, 2048), (128, 768, 3072), (129, 768, 768), (65, 1024, 4096),
                   (100, 768, 384))
# fwd (atol, rtol), dx (atol, rtol) of the LN-fused MLP in bf16 (the limits of
# the JAX kernel's bf16 parity tests)
MLP_TOL = ((1e-2, 1e-2), (2e-2, 2e-2))
MLP_PARAM_STD = 0.5  # LN scale (around 1), LN bias, b1, b2
# the LN-fused MLP under several input draws, each from a generator of its own
LN_SEED_SHAPES = ((50176, 256, 1024), (200704, 128, 512))
LN_SEEDS = tuple(range(100, 108))
# the fused MLP without LayerNorm (T, D, M): the ViT-B/16 shape, Swin-B stage 1, a ragged case
FMLP_SHAPES = ((12608, 768, 3072), (200704, 128, 512), (70, 128, 512))
# the attention half-block (B, N, C, heads): ViT-B/16 and a ragged small case;
# fwd / dx limits of the JAX kernel's bf16 parity tests
AB_SHAPES = ((64, 197, 768, 12), (2, 37, 192, 3))
# ... and the edges of the Hopper kernels' 64-row tiles and of their score
# widths (64, 128, 208, 256) at C = 192 with 3 heads (a cluster's second CTA
# idle at N <= 128; a batch of 3, so that the row-block kernels' 128-row
# blocks straddle batch elements)
AB_EDGE_N = (1, 63, 64, 65, 128, 197, 208, 256)
AB_TOL = ((3e-2, 3e-2), (5e-2, 5e-2))
AB_QK_GAIN = 3.0  # on the 1/sqrt(C) init of wq and wk: at gain 1 every P is about 1/N
# a parameter gradient against autograd through the plain version: max |err|
# over the gradient's largest value
PARAM_GRAD_RTOL = 2e-2
VIT_VARIANTS = (("fields off", {}), ("use_fused_mlp", {"use_fused_mlp": True}),
                ("fuse_ln_mlp", {"fuse_ln_mlp": True}), ("fuse_attn_block", {"fuse_attn_block": True}))
TRAIN_STEPS = 5
CONVNEXT_KERNELS = {"use_dw_kernel": True, "fuse_ln_mlp": True}
CONVNEXT_VARIANTS = (("both kernels", CONVNEXT_KERNELS), ("dwconv7 only", {"use_dw_kernel": True}),
                     ("ln_mlp only", {"fuse_ln_mlp": True}), ("library", {}))
# logits, kernel path vs plain path (ConvNeXt: vs the flags-off library path;
# in f32 its kernel fields do nothing)
LOGIT_TOL = {"google_vit": {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)},
             "swin": {"float32": (1e-3, 1e-3), "bfloat16": (5e-2, 5e-2)},
             "convnext": {"bfloat16": (5e-2, 5e-2)},
             # YOLO11-cls has no kernel: bf16 compute against the f32 model (a CPU
             # run of this phase's model at B=8 is 5.7e-3 apart, max |logit| 0.45)
             "yolo11-cls": {"bfloat16": (2e-2, 2e-2)}}
# phase 5 training of the other backbones: (model, "full" or "lora", kernel fields)
TRAIN_RUNS = (("swin", "full", {}), ("swin", "lora", {"use_fused_mlp": True}),
              ("convnext", "full", CONVNEXT_KERNELS), ("convnext", "lora", CONVNEXT_KERNELS),
              ("yolo11-cls", "full", {}), ("yolo11-cls", "lora", {}))
BATCH, PGD_STEPS, EPS, ALPHA, CLASSES = 64, 10, 8 / 255, 3 / 255, 21
AA_N_ITER, AA_QUERIES = 100, 5000  # the CLI's autoattack defaults
PROFILE_PATCH_ITERS, PROFILE_SQUARE_QUERIES = 20, 50
# each later AutoAttack stage alone, at a cut budget (the suite may end before it)
STAGE_N_ITER, STAGE_TARGETS, STAGE_QUERIES = 10, 3, 100
# phase 7: the robustness study through the port's runner at ViT-B/16's full width
# (224 px, 12 blocks, the hard 12-class corpus), counts cut to keep the phase short
RUNNER_ARGS = ("--model", "google_vit", "--n_per_class", "4", "--epochs", "1",
               "--lora_epochs", "1", "--pgd_steps", "10", "--patch_iters", "20",
               "--rp2_iters", "20", "--aa_iters", "10", "--aa_queries", "100")
RUNNER_STAGE_TIMEOUT_S = 300
# phase 8: the raw-corpus ETL (the ``process`` stage) on the card's host: the four image corpora
# (CURE-TSD decodes video and needs OpenCV even where its corpus is absent), then a LISA-layout
# fixture at the LISA Traffic Sign Dataset's size (Mogelmose et al., IEEE T-ITS 13(4), 2012:
# 6,610 frames, 640 x 480 the smallest), written as JPEG, with ETL_BOXES lines a frame: (LISA
# class, YOLO x-center, y-center, width, height); the last two are dropped (too small, unknown
# class). A crop may be ETL_JPEG_TOL LSB from its box's colour: JPEG's colour conversion rounds
ETL_DATASETS = ("gtsrb-german-traffic-sign", "lisa-road-sign", "Mapillary",
                "roboflow-traffic-signs-dataset")
ETL_IMAGES, ETL_FRAME = 6610, (480, 640)
ETL_JPEG_QUALITY, ETL_JPEG_TOL = 95, 2
ETL_BOXES = ((35, 0.25, 0.3, 0.1, 0.15), (43, 0.6, 0.55, 0.2, 0.25), (13, 0.8, 0.2, 0.08, 0.1),
             (35, 0.1, 0.9, 0.02, 0.03), (99, 0.5, 0.5, 0.3, 0.3))
ETL_KEPT = {35: "stop", 43: "yield", 13: "speed_limit"}  # LISA's table for the classes used
ETL_HEADER = b"image_path,source,original_class,unified_class\r\n"
CODEC_SIZES = ((224, 224), (97, 113), (1, 1), (300, 400), (480, 640))
CODEC_RATE_N = 64
# phase 9: int8_matmul (M, K, N) at the ViT-B/16 dense shapes at B=64 (64 x 197 rows: q/k/v/o,
# fc1, fc2), then one that misses every limit of cuBLASLt's int8 GEMM (M <= 16, K and N not
# multiples of 8), which the wrapper pads; the input-gradient sign agreement of the W8A8 ViT-B
# with the bf16 one (the JAX package's tests/test_quant.py limit); BiLoRA's delta at ViT-B's
# stacked q weight (a task id whose uint32 seed wraps) against the CPU, relative to max|CPU|
INT8_SHAPES = ((12608, 768, 768), (12608, 768, 3072), (12608, 3072, 768), (16, 50, 36))
INT8_SIGN_AGREE = 0.95
# phase 10 (b): ViT-B/16 at full width, depth cut to TP_DEPTH, batch TP_BATCH over a
# TP_MESH (data, model) mesh of 4 ranks sharing the card (gloo); held against one process
TP_MESH, TP_DEPTH, TP_BATCH = (2, 2), 2, 16
TP_FIELDS = ("use_fused_mlp", "fuse_ln_mlp")  # the opt-in kernels that take a rank's slices
TP_LOGIT_TOL = (5e-2, 5e-2)  # (atol, rtol), LOGIT_TOL's bf16 bound (PR 13's card: 1.56e-2)
TP_SIGN_AGREE = 0.99  # PGD-2 perturbation signs (PR 13's card: 0.9972)
TP_LOSS_RTOL = 5e-3  # the LoRA step's loss (PR 13's card: 6.2e-4 relative)
# the LoRA step's gradients (relative to each leaf's norm) and its trained adapter and head:
# Adam's first step moves a leaf by about lr * sign(gradient), 1e-3, so a flipped sign differs
# by 2e-3 (tests/test_mesh.py's 2.5e-3); the gradients show what that update hides
TP_GRAD_RTOL, TP_TRAINED_ATOL = 5e-2, 2.5e-3
MESH_TURNS = 3  # phase 10 (a): mesh / no mesh in turns, the median of each
BILORA_SHAPE, BILORA_N_FRQ, BILORA_TASK, BILORA_RTOL = (12, 768, 768), 100, 3, 1e-5
DEMOS = ("examples/sequential_lora_demo_torch.py", "examples/bilora_fashion_demo_torch.py")
# phase 11: the bench entry (bench_torch.py) as a user runs it, its other variants in this
# process at BENCH_VARIANT_ITERS timed calls, then each tool of <port>/tools/ at cut counts
# (full widths). Launches per PGD-10 call of ViT-B: 12 blocks x 10 steps, forward and backward,
# of each kernel a variant runs (bench_torch.COUNTERS' names); every other count 0
BENCH_ENTRY_TIMEOUT_S, BENCH_VARIANT_ITERS = 900, 2
BENCH_KERNELS = {"merged": ("attention_packed",), "attached": ("attention_packed",),
                 "int8": ("attention_packed",), "fusedblock": ("attn_block", "ln_mlp"),
                 "lnmlp": ("attention_packed", "ln_mlp")}
BENCH_TOOL_ARGS = {"bench_zoo": ("--iters", "1"),
                   "bench_train": ("--modes", "full", "lora", "lora_pa", "--iters", "2"),
                   "bench_eval": ("--iters", "2", "--sweep_batch", "64"),
                   "bench_compose": ("--n_per_dataset", "64", "--datasets", "2"),
                   "profile_pgd": (), "profile_train": ("--mode", "lora"),
                   "profile_eval": ("--iters", "2")}
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound_ms(flop: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least milliseconds the card could take, and which of the two bounds it."""
    t_ops, t_bytes = flop / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def close(got, want, atol: float, rtol: float, what: str) -> float:
    """Assert allclose; returns the max abs error."""
    import torch

    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite values")
    torch.testing.assert_close(g, w, atol=atol, rtol=rtol, msg=lambda m: f"{what}: {m}")
    return float((g - w).abs().max())


def cuda_ms(fn, iters: int) -> float:
    """The package's ``tools/timing.cuda_ms``: mean device milliseconds per
    call over ``iters`` calls (after one warm-up)."""
    return importlib.import_module(f"{PKG}.tools.timing").cuda_ms(fn, iters)


def graph_ms(fn, iters: int) -> float:
    """The package's ``tools/timing.graph_ms``: device milliseconds per call
    by CUDA-graph replay, no host time."""
    return importlib.import_module(f"{PKG}.tools.timing").graph_ms(fn, iters)


def turns(kernel, plain, iters: int = 20, library=None) -> tuple:
    """(kernel ms, plain ms), each the best of two in plain-kernel-kernel-plain
    order. With ``library`` (the one PyTorch call, or the library composition,
    that computes the same function), (kernel ms, plain ms, library ms): the
    kernel and the library call take turns kernel-library three times between
    the plain runs and the best of each is kept, because a library call's time
    moves between runs on one shape."""
    fns = {"plain": plain, "kernel": kernel, "library": library}
    order = (("plain", "kernel", "kernel", "plain") if library is None else
             ("plain", "kernel", "library", "kernel", "library", "kernel", "library", "plain"))
    times = {name: [] for name in order}
    for turn in order:
        times[turn].append(cuda_ms(fns[turn], iters))
    best = (min(times["kernel"]), min(times["plain"]))
    return best if library is None else (*best, min(times["library"]))


def rivals(fns: dict, iters: int = 20, rounds: int = 3, timer=None) -> dict:
    """``{name: ms}``: the callables take turns (in the given order, ``rounds``
    times over) and the best of each is kept, so that a kernel, the kernel
    it replaces and a library call are compared in one run on one card.
    ``timer``: :func:`cuda_ms` (the default) or :func:`graph_ms`."""
    best = {}
    for _ in range(rounds):
        for name, fn in fns.items():
            ms = (timer or cuda_ms)(fn, iters)
            best[name] = min(best.get(name, ms), ms)
    return best


def footprint(eot, size: int, p: int):
    """(B, S, S) bool: pixels whose inverse-mapped patch coordinate (computed
    here in f64, apart from the package's composite) lies within a margin of
    the patch's bilinear support; outside it every weight is 0."""
    import torch

    scale, theta, tx, ty, _ = (t.reshape(-1, 1, 1).double() for t in eot)
    ar = torch.arange(size, dtype=torch.float64, device=scale.device)
    dx = ar[None, None, :] - (size - 1) / 2.0 - tx
    dy = ar[None, :, None] - (size - 1) / 2.0 - ty
    k = scale * size / p
    u = (torch.cos(-theta) * dx - torch.sin(-theta) * dy) / k + (p - 1) / 2.0
    v = (torch.sin(-theta) * dx + torch.cos(-theta) * dy) / k + (p - 1) / 2.0
    return (u > -1.01) & (u < p + 0.01) & (v > -1.01) & (v < p + 0.01)


def plain_png(img) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG with filter 0 on every row, through
    the standard library's zlib: a writer apart from the native encoder."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def plain_resize_center_crop(img, resize: int, crop: int, dev):
    """The loader's geometry (shorter side to ``resize``, the long side
    truncated, a center crop at rounded offsets) through
    ``F.interpolate(mode="bilinear", antialias=True)`` on ``dev``."""
    import torch
    import torch.nn.functional as F

    h, w = img.shape[:2]
    nw, nh = (resize, max(1, int(h * resize / w))) if w <= h else (max(1, int(w * resize / h)),
                                                                    resize)
    x = torch.from_numpy(img).to(dev).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", antialias=True, align_corners=False)
    y = y.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
    top, left = round((nh - crop) / 2), round((nw - crop) / 2)
    return y[top:top + crop, left:left + crop].cpu().numpy()


@contextlib.contextmanager
def plain_path(module, name: str, plain):
    """Route a model module's attention through the plain version."""
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


class Smoke:
    """The modules, the device and the card's label, shared by the phases."""

    def __init__(self, dev):
        import torch

        sys.path.insert(0, HERE)
        for attr, name in (("ka", "kernels.attention"), ("kw", "kernels.window_attention"),
                           ("kd", "kernels.dwconv"), ("km", "kernels.mlp"),
                           ("kb", "kernels.attn_block"), ("steps", "train.steps"),
                           ("loop", "train.loop"), ("optim", "train.optim"),
                           ("augment", "data.augment"),
                           ("build_mod", "kernels._build"), ("vit", "models.vit"),
                           ("swin", "models.swin"), ("registry", "models.registry"),
                           ("lora", "ops.lora"), ("peft_io", "ops.peft_io"),
                           ("trees", "utils.trees"), ("checkpoint", "utils.checkpoint"),
                           ("common", "attacks.common"), ("whitebox", "attacks.whitebox"),
                           ("loader", "data.loader"), ("compose_mod", "eval.compose"),
                           ("patch_mod", "attacks.patch"), ("rp2_mod", "attacks.rp2"),
                           ("aa", "attacks.autoattack"), ("hf_import", "models.hf_import"),
                           ("pretrained", "models.pretrained"), ("yolo", "models.yolo11"),
                           ("native", "utils.native"), ("synthetic", "data.synthetic"),
                           ("cli", "cli.main"), ("rr", "tools.run_robustness"),
                           ("data_io", "data.io"), ("process", "data.process"),
                           ("vocab", "utils.vocab"), ("quant", "ops.quant"),
                           ("bilora", "ops.bilora"), ("observability", "utils.observability"),
                           ("pmesh", "parallel.mesh"), ("launch", "parallel.launch"),
                           ("compare", "parallel.compare"), ("dryrun", "parallel.dryrun"),
                           ("trace_table", "tools.trace_table"), ("timing", "tools.timing")):
            setattr(self, attr, importlib.import_module(f"{PKG}.{name}"))
        self.bench = importlib.import_module("bench_torch")
        check("jax" not in sys.modules, "the port imported jax")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dev = dev
        self.gen = torch.Generator(self.dev).manual_seed(0)
        # the tile-edge checks of window attention and attn_block draw from a
        # generator of their own, so that adding one leaves the inputs of
        # every check after it as they were
        self.edge_gen = torch.Generator(self.dev).manual_seed(6)
        self.card = ""

    # 1. device
    def device(self) -> None:
        import torch

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
        self.card = f"[{smi}]"
        print(smi)
        print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
              flush=True)

    # 2. build
    def build(self) -> None:
        import torch

        sources = ("attention_packed.cu", "window_attention.cu", "dwconv7.cu", "ln_mlp.cu",
                   "attn_block.cu")
        t0 = time.perf_counter()
        self.build_mod.load_all(sources)
        for mod in (self.ka, self.kw, self.kd, self.km, self.kb):
            mod._lib()
        wall = time.perf_counter() - t0
        for src in sources:
            ptxas = self.build_mod.BUILD_LOG.get(src, "")
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas))
            serial = [ln.strip() for ln in ptxas.splitlines() if "wgmma" in ln.lower()]
            print(f"phase 2 build: {src} -> {self.build_mod.build_dir()} "
                  f"(nvcc {self.build_mod.BUILD_SECONDS.get(src, 0.0):.2f} s; all sources in "
                  f"parallel {wall:.2f} s); ptxas: {len(regs)} kernels, registers "
                  f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores {spills} bytes, "
                  f"wgmma serialisation warnings {len(serial)}", flush=True)
            for ln in serial[:4]:
                print(f"phase 2 build: {src}: {ln[:300]}", flush=True)
            # the wgmma kernels one by one: a spill in a main loop would be silent
            for fn, spill, used in re.findall(
                    r"Compiling entry function '(\w+)'(?:.*\n)+?.*?(\d+) bytes spill stores.*\n"
                    r".*Used (\d+) registers", ptxas):
                short = re.search(r"(wg_mlp_(?:fwd|bwd)ILi\d+ELb[01]|2wg\d+attn_(?:fwd|bwd)"
                                  r"(?:ILi\d+)?|3wgw7win_(?:fwd|bwd)|3wgb\d+(?:heads_fwd|"
                                  r"heads_bwd|oproj_fwd|dh_bwd)ILi\d+E(?:Li\d+E)?|"
                                  r"dwconv7_tmaILi\d+E)", fn)
                if short:
                    print(f"phase 2 build: {src}: {short.group(1)} registers {used} at entry, "
                          f"spill stores {spill} bytes", flush=True)
        # the Hopper window and half-block kernels' dynamic shared memory, as
        # their launchers pass it (the wrapper's budget must be the launcher's)
        win = [self.kw._lib().apvt_win_attn_smem(i) for i in range(2)]
        blk = [self.kb._lib().apvt_attn_block_smem(i) for i in range(4)]
        check(blk[0] == self.kb._smem_bytes(MAIN[1], 768, False)
              and blk[2] == self.kb._smem_bytes(MAIN[1], 768, True),
              f"attn_block: the wrapper's shared-memory budget is not the launcher's ({blk})")
        # the bf16 dwconv7 launcher's plan (tile, schedule, ring) is the wrapper's
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for shape in DW_SHAPES + DW_EDGE_SHAPES:
            want = {k: v for k, v in self.kd.kernel_plan(shape, sms).items()
                    if k not in ("chunks", "slot_bytes")}
            got = self.kd.launcher_plan(shape)
            check(got == want, f"dwconv7 {shape}: the launcher's plan {got} is not the "
                  f"wrapper's {want}")
        plans = [self.kd.kernel_plan(shape, sms) for shape in DW_SHAPES[:4]]
        print("phase 2 build: dwconv7.cu tma_ring plan (tile, items, CTAs, ring slots, dynamic "
              "shared memory) at the ConvNeXt-B stages: " + "; ".join(
                  f"{p['tile'][0]}x{p['tile'][1]}, {p['items']}, {p['grid']}, {p['slots']} x "
                  f"{p['slot_bytes']} B, {p['smem']} B" for p in plans)
              + f"; the launcher's plan equals the wrapper's at {len(DW_SHAPES + DW_EDGE_SHAPES)} "
              f"shapes ({sms} SMs)", flush=True)
        print(f"phase 2 build: dynamic shared memory, window_attention.cu win_fwd {win[0]} B, "
              f"win_bwd {win[1]} B; attn_block.cu heads_fwd {blk[0]} B, oproj_fwd {blk[1]} B, "
              f"heads_bwd {blk[2]} B, dh_bwd {blk[3]} B", flush=True)

    # 3. kernels against plain, on the card
    def packed_vs_plain(self) -> dict:
        import torch

        ka, err = self.ka, {"fwd": 0.0, "bwd": 0.0}  # at the main-path shape and dtype
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for (b, n, h, hd) in SHAPES[dtype_name]:
                q, k, v, do = (torch.randn(b, n, h * hd, device=self.dev, generator=self.gen)
                               .to(dtype) for _ in range(4))
                tag = f"{dtype_name} {(b, n, h, hd)}"
                o, lse = ka.fused_attention_packed_fwd(q, k, v, h, with_lse=True)
                e_f = close(o, ka.attention_packed_reference(q, k, v, h), fa, fr, f"fwd {tag}")
                if ka.kernel_variant(dtype, n, hd) == "wgmma":
                    close(lse, ka.attention_lse_reference(ka._split(q, h), ka._split(k, h)),
                          1e-4, 1e-4, f"lse {tag}")
                # as autograd calls it: with the forward's output and log-sum-exp
                got = ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse)
                want = ka.attention_packed_bwd_reference(q, k, v, do, h)
                e_b = max(close(g_, w_, ga, gr, f"d{nm} {tag}")
                          for nm, g_, w_ in zip("qkv", got, want))
                # ... and without them (the wrapper runs the forward first)
                again = ka.fused_attention_packed_bwd(q, k, v, do, h)
                check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
                      f"backward not reproducible {tag}")
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and (b, n, h, hd) == MAIN:
                    err = {"fwd": e_f, "bwd": e_b}
                print(f"phase 3 attention_packed vs plain {tag} "
                      f"[{ka.kernel_variant(dtype, n, hd)}]: fwd max|err| {e_f:.3e}, "
                      f"dq/dk/dv max|err| {e_b:.3e}, backward bitwise reproducible", flush=True)
        return err

    def window_operands(self, shape, mask_kind, dtype, gen=None):
        """qkv, bias, mask, dO and heads; the bias's std runs from 1 to 2 over
        the heads (a constant offset per head would not change the softmax).
        Drawn from ``gen``, by default ``self.gen``."""
        import torch

        gen = gen or self.gen
        b, nw, n, h = shape
        c = 32 * h
        qkv = torch.randn(b, nw, n, 3 * c, device=self.dev, generator=gen).to(dtype)
        bias = (torch.randn(h, n, n, device=self.dev, generator=gen)
                * torch.linspace(1.0, 2.0, h, device=self.dev)[:, None, None])
        if mask_kind == "shift":
            window = round(n ** 0.5)
            mask = torch.from_numpy(self.swin._shift_attn_mask(
                window * round(nw ** 0.5), window, window // 2)).to(self.dev)
        elif mask_kind == "random":
            mask = torch.where(torch.rand(nw, n, n, device=self.dev, generator=gen) < 0.3,
                               -100.0, 0.0)
        else:
            mask = torch.zeros(nw, n, n, device=self.dev)
        do = torch.randn(b, nw, n, c, device=self.dev, generator=gen).to(dtype)
        return qkv, bias, mask, do, h

    def window_vs_plain(self) -> dict:
        import torch

        kw, err = self.kw, {"fwd": 0.0, "bwd": 0.0}  # bf16, max over the Swin-B stages
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for (*shape, mask_kind), gen in ([(s, self.gen) for s in WIN_SHAPES]
                                             + [(s, self.edge_gen) for s in WIN_EDGE_SHAPES]):
                qkv, bias, mask, do, h = self.window_operands(shape, mask_kind, dtype, gen)
                tag = f"{dtype_name} {tuple(shape)} {mask_kind} mask"
                got_f = kw.fused_window_attention_fwd(qkv, bias, mask, h)
                want_f = kw.window_attention_reference(qkv, bias, mask, h)
                e_f = close(got_f, want_f, fa, fr, f"window fwd {tag}")
                got = kw.fused_window_attention_bwd(qkv, bias, mask, do, h)
                want = kw.window_attention_bwd_reference(qkv, bias, mask, do, h)
                e_b = close(got, want, ga, gr, f"window dqkv {tag}")
                check(torch.equal(got, kw.fused_window_attention_bwd(qkv, bias, mask, do, h)),
                      f"window backward not reproducible {tag}")
                # what the bias contributes: the kernel's change from a zero
                # bias against the plain version's (a kernel that drops the
                # bias, or reads another head's, fails here)
                zero = torch.zeros_like(bias)
                moved = {}
                for what, k_out, p_out, k_zero, p_zero, (a, r) in (
                        ("fwd", got_f, want_f, kw.fused_window_attention_fwd(qkv, zero, mask, h),
                         kw.window_attention_reference(qkv, zero, mask, h), (fa, fr)),
                        ("dqkv", got, want,
                         kw.fused_window_attention_bwd(qkv, zero, mask, do, h),
                         kw.window_attention_bwd_reference(qkv, zero, mask, do, h), (ga, gr))):
                    d_plain = p_out.float() - p_zero.float()
                    moved[what] = float(d_plain.abs().max())
                    check(moved[what] > 20 * a, f"window {what} {tag}: the bias moved the plain "
                          f"output by only {moved[what]:.3e}")
                    close(k_out.float() - k_zero.float(), d_plain, 2 * a, r,
                          f"window {what} bias contribution {tag}")
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and shape[0] == BATCH:
                    err = {"fwd": max(err["fwd"], e_f), "bwd": max(err["bwd"], e_b)}
                print(f"phase 3 window_attention vs plain {tag} "
                      f"[{kw.kernel_variant(dtype, shape[2], h)}]: fwd max|err| {e_f:.3e}, "
                      f"dqkv max|err| {e_b:.3e}; bias contribution (max {moved['fwd']:.3e} fwd, "
                      f"{moved['dqkv']:.3e} dqkv) matches; backward bitwise reproducible",
                      flush=True)
        return err

    def dwconv_operands(self, shape, dtype, gen=None):
        """x, the filter (7, 7, C) f32 at std 0.15 and a cotangent, drawn from
        ``gen``, by default ``self.gen``."""
        import torch

        gen = self.gen if gen is None else gen
        x = torch.randn(*shape, device=self.dev, generator=gen).to(dtype)
        w = torch.randn(7, 7, shape[-1], device=self.dev, generator=gen) * 0.15
        g = torch.randn(*shape, device=self.dev, generator=gen).to(dtype)
        return x, w, g

    def dwconv_vs_plain(self) -> dict:
        import torch

        kd, err = self.kd, {"fwd": 0.0, "dx": 0.0}  # bf16, max over the ConvNeXt-B stages
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for shape in DW_SHAPES:
                x, w, g = self.dwconv_operands(shape, dtype)
                tag = f"{dtype_name} {shape}"
                e_f = close(kd.fused_dwconv7_fwd(x, w), kd.dwconv7_reference(x, w), fa, fr,
                            f"dwconv7 fwd {tag}")
                xr = x.clone().requires_grad_(True)
                (want_dx,) = torch.autograd.grad(kd.dwconv7_reference(xr, w), xr, g)
                got_dx = kd.fused_dwconv7_dx(g, w)
                e_b = close(got_dx, want_dx, ga, gr, f"dwconv7 dx {tag}")
                check(torch.equal(got_dx, kd.fused_dwconv7_fwd(g, w.flip(0, 1))),
                      f"dwconv7 dx is not the forward with the flipped filter {tag}")
                check(torch.equal(got_dx, kd.fused_dwconv7_dx(g, w)),
                      f"dwconv7 dx not reproducible {tag}")
                same = ""
                if kd.kernel_variant(dtype, shape) == "tma_ring":
                    self.dwconv_vs_staged(x, w, g, tag)
                    same = "; equal to the staged kernel bit for bit in both roles"
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and shape[0] == BATCH:
                    err = {"fwd": max(err["fwd"], e_f), "dx": max(err["dx"], e_b)}
                print(f"phase 3 dwconv7 vs plain {tag} [{kd.kernel_variant(dtype, shape)}]: fwd "
                      f"max|err| {e_f:.3e}, dx max|err| {e_b:.3e}; dx = forward with the "
                      f"flipped filter, bitwise; reproducible{same}", flush=True)
        return err

    def dwconv_vs_staged(self, x, w, g, tag: str) -> None:
        """The bf16 kernel against the first design, which sums in the same
        order: equal bit for bit in both roles."""
        import torch

        kd = self.kd
        check(torch.equal(kd.fused_dwconv7_fwd(x, w), kd.staged_fwd(x, w)),
              f"dwconv7 fwd {tag}: not the staged kernel's bits")
        check(torch.equal(kd.fused_dwconv7_dx(g, w), kd.staged_dx(g, w)),
              f"dwconv7 dx {tag}: not the staged kernel's bits")

    def dwconv_edges(self) -> None:
        """The bf16 kernel at the edges of its tiles, chunks and persistent
        schedule (DW_EDGE_SHAPES, drawn from ``edge_gen`` after every other
        check that draws from it): both roles against the plain version at
        TOL and bit for bit against the staged kernel."""
        import torch

        kd = self.kd
        (fa, fr), (ga, gr) = TOL["bfloat16"]
        for shape in DW_EDGE_SHAPES:
            x, w, g = self.dwconv_operands(shape, torch.bfloat16, self.edge_gen)
            plan = kd.kernel_plan(shape, torch.cuda.get_device_properties(0).multi_processor_count)
            tag = f"bfloat16 {shape} [{kd.kernel_variant(x.dtype, shape)}]"
            e_f = close(kd.fused_dwconv7_fwd(x, w), kd.dwconv7_reference(x, w), fa, fr,
                        f"dwconv7 fwd {tag}")
            xr = x.clone().requires_grad_(True)
            (want_dx,) = torch.autograd.grad(kd.dwconv7_reference(xr, w), xr, g)
            got_dx = kd.fused_dwconv7_dx(g, w)
            e_b = close(got_dx, want_dx, ga, gr, f"dwconv7 dx {tag}")
            check(torch.equal(got_dx, kd.fused_dwconv7_fwd(g, w.flip(0, 1))),
                  f"dwconv7 dx is not the forward with the flipped filter {tag}")
            self.dwconv_vs_staged(x, w, g, tag)
            torch.cuda.synchronize()
            print(f"phase 3 dwconv7 vs plain {tag} (tile edge: tile {plan['tile']}, "
                  f"{plan['items']} items on {plan['grid']} CTAs): fwd max|err| {e_f:.3e}, dx "
                  f"max|err| {e_b:.3e}; dx = forward with the flipped filter, bitwise; equal to "
                  f"the staged kernel bit for bit in both roles", flush=True)

    def mlp_operands(self, shape, gen=None):
        """bf16 x and dy (T, D); LN scale/bias, b1, b2 at std MLP_PARAM_STD (the
        scale around 1), w1 and w2 at std 1/sqrt(fan-in), all f32. Drawn from
        ``gen``, by default ``self.gen``."""
        import torch

        t, d, m = shape
        gen = self.gen if gen is None else gen

        def rand(*size):
            return torch.randn(*size, device=self.dev, generator=gen)

        x = (rand(t, d) + 0.5 * rand(t, 1)).to(torch.bfloat16)
        dy = rand(t, d).to(torch.bfloat16)
        params = {"ln_scale": 1.0 + MLP_PARAM_STD * rand(d), "ln_bias": MLP_PARAM_STD * rand(d),
                  "w1": rand(d, m) * d ** -0.5, "b1": MLP_PARAM_STD * rand(m),
                  "w2": rand(m, d) * m ** -0.5, "b2": MLP_PARAM_STD * rand(d)}
        return x, dy, params

    def mlp_vs_plain(self) -> dict:
        import torch

        km, eps = self.km, 1e-6
        (fa, fr), (ga, gr) = MLP_TOL
        err = {"fwd": 0.0, "bwd": 0.0}  # max over the ConvNeXt-B stages
        for shape in MLP_SHAPES + MLP_EDGE_SHAPES:
            x, dy, p = self.mlp_operands(shape)
            tag = (f"bfloat16 {shape} [{km.kernel_variant(*shape[1:], 'ln_mlp_fwd')} / "
                   f"{km.kernel_variant(*shape[1:], 'ln_mlp_bwd')}]")

            def plain(q):
                fwd = km.ln_mlp_reference(x, q["ln_scale"], q["ln_bias"], q["w1"], q["b1"],
                                          q["w2"], q["b2"], eps)
                bwd = km.ln_mlp_bwd_reference(x, q["ln_scale"], q["ln_bias"], q["w1"], q["b1"],
                                              q["w2"], dy, eps)
                return fwd, bwd

            want_f, want_b = plain(p)
            got_f = km.fused_ln_mlp_fwd(x, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"],
                                        p["w2"], p["b2"], eps)
            got_b = km.fused_ln_mlp_bwd(x, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"],
                                        p["w2"], dy, eps)
            e_f = close(got_f, want_f, fa, fr, f"ln_mlp fwd {tag}")
            e_b = close(got_b, want_b, ga, gr, f"ln_mlp dx {tag}")
            check(torch.equal(got_b, km.fused_ln_mlp_bwd(
                x, p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"], dy, eps)),
                f"ln_mlp backward not reproducible {tag}")
            if shape in MLP_EDGE_SHAPES:
                torch.cuda.synchronize()
                print(f"phase 3 ln_mlp vs plain {tag} (tile edge): fwd max|err| {e_f:.3e}, dx "
                      f"max|err| {e_b:.3e}; backward bitwise reproducible", flush=True)
                continue
            # can the check see each row parameter? The plain version without
            # it must miss the limit by far (b2 does not enter dx)
            moved = {}
            for name, neutral in (("ln_scale", 1.0), ("ln_bias", 0.0), ("b1", 0.0), ("b2", 0.0)):
                wo_f, wo_b = plain({**p, name: torch.full_like(p[name], neutral)})
                moved[name] = (float((wo_f.float() - want_f.float()).abs().max()),
                               float((wo_b.float() - want_b.float()).abs().max()))
                for what, mv, a, r, ref in (("fwd", moved[name][0], fa, fr, want_f),
                                            ("dx", moved[name][1], ga, gr, want_b)):
                    if (name, what) == ("b2", "dx"):
                        continue
                    limit = a + r * float(ref.float().abs().max())
                    check(mv > 5 * limit, f"ln_mlp {what} {tag}: dropping {name} moves the "
                          f"plain output by only {mv:.3e} (limit {limit:.3e})")
            torch.cuda.synchronize()
            if shape in MLP_SHAPES[:4]:
                err = {"fwd": max(err["fwd"], e_f), "bwd": max(err["bwd"], e_b)}
            print(f"phase 3 ln_mlp vs plain {tag}: fwd max|err| {e_f:.3e}, dx max|err| "
                  f"{e_b:.3e}; dropping a row parameter moves plain fwd/dx by "
                  + ", ".join(f"{n} {a:.2f}/{b:.2f}" for n, (a, b) in moved.items())
                  + "; backward bitwise reproducible", flush=True)
        return err

    def ln_mlp_seeds(self) -> None:
        """The LN-fused MLP at (50176, 256, 1024) and the ConvNeXt-B stage-1
        shape under LN_SEEDS input draws, each from a generator of its own:
        forward and dx against the plain version at MLP_TOL (every row that
        misses is named before the check fails); the kernels' LayerNorm
        prologue against the plain version's: h within one bf16 rounding of
        it, mean and rstd as close to f64 statistics of the same rows as the
        plain version's are; and the kernels against the plain version fed
        the kernels' own h, at MLP_TOL."""
        import torch

        km, eps, cd = self.km, 1e-6, torch.bfloat16
        (fa, fr), (ga, gr) = MLP_TOL
        for shape in LN_SEED_SHAPES:
            t, d, m = shape
            for seed in LN_SEEDS:
                x, dy, p = self.mlp_operands(shape, torch.Generator(self.dev).manual_seed(seed))
                sc, bi, w1, b1, w2, b2 = (p[k] for k in ("ln_scale", "ln_bias", "w1", "b1",
                                                         "w2", "b2"))
                tag = (f"bfloat16 {shape} seed {seed} [{km.kernel_variant(d, m, 'ln_mlp_fwd')} / "
                       f"{km.kernel_variant(d, m, 'ln_mlp_bwd')}]")
                got = {"fwd": km.fused_ln_mlp_fwd(x, sc, bi, w1, b1, w2, b2, eps),
                       "dx": km.fused_ln_mlp_bwd(x, sc, bi, w1, b1, w2, dy, eps)}
                want = {"fwd": km.ln_mlp_reference(x, sc, bi, w1, b1, w2, b2, eps),
                        "dx": km.ln_mlp_bwd_reference(x, sc, bi, w1, b1, w2, dy, eps)}
                # the prologue: kernel, plain (f32) and f64 statistics
                h_k, mean_k, rstd_k = km.kernel_ln_rows(x, sc, bi, eps)
                normed, rstd_p, h_p = km.ln_fwd_f32(x.float(), sc, bi, eps)
                h_p, rstd_p, mean_p = h_p.to(cd), rstd_p[:, 0], x.float().mean(-1)
                xd = x.double()
                mean_d = xd.mean(-1)
                rstd_d = torch.rsqrt(((xd - mean_d[:, None]) ** 2).mean(-1) + eps)
                dev = {"mean": [float((mu - mean_d).abs().max()) for mu in (mean_k, mean_p)],
                       "rstd": [float((r / rstd_d - 1).abs().max()) for r in (rstd_k, rstd_p)]}
                flips = h_k != h_p
                step = float(((h_k.float() - h_p.float()).abs()
                              - 2 ** -7 * h_p.float().abs()).max())
                # the plain version from the kernels' h on
                pre = km._mm_f32(h_k, w1.to(cd)) + b1.float()
                given = {"fwd": (km._mm_f32(km._gelu_f32(pre).to(cd), w2.to(cd))
                                 + b2.float()).to(cd)}
                dpre = (km._mm_f32(dy, w2.to(cd).t()) * km._gelu_grad_f32(pre)).to(cd)
                given["dx"] = km.ln_bwd_f32(km._mm_f32(dpre, w1.to(cd).t()), sc, normed,
                                            rstd_p[:, None]).to(cd)
                line, missed = [f"phase 3 ln_mlp seeds {tag}:"], []
                for what, a, r in (("fwd", fa, fr), ("dx", ga, gr)):
                    err = (got[what].float() - want[what].float()).abs()
                    lim = a + r * want[what].float().abs()
                    rows = (err > lim).any(-1).nonzero().flatten().tolist()
                    e_g = (got[what].float() - given[what].float()).abs()
                    over_g = int((e_g > a + r * given[what].float().abs()).sum())
                    line.append(f"{what} max|err| {float(err.max()):.3e} ({len(rows)} rows over "
                                f"the limit), against the plain version fed the kernel's h "
                                f"{float(e_g.max()):.3e} ({over_g} over);")
                    for row in rows[:4]:
                        j = int((err[row] - lim[row]).argmax())
                        line.append(f"{what} row {row} misses: output {j} |err| "
                                    f"{float(err[row, j]):.4e}, limit {float(lim[row, j]):.4e}, h "
                                    f"differs from plain at {int(flips[row].sum())} columns;")
                    if rows:
                        missed.append(f"{what} rows {rows[:8]}")
                    if over_g:
                        missed.append(f"{what} against the plain version fed the kernel's h")
                line.append(f"prologue: h differs from plain in {int(flips.sum())} of "
                            f"{flips.numel()} values ({int(flips.any(-1).sum())} rows), by at most "
                            f"one bf16 rounding ({step:.1e} past 2^-7 |h|); max |mean - f64| "
                            f"kernel {dev['mean'][0]:.2e} plain {dev['mean'][1]:.2e}, max |rstd / "
                            f"f64 - 1| kernel {dev['rstd'][0]:.2e} plain {dev['rstd'][1]:.2e}")
                torch.cuda.synchronize()
                print(" ".join(line), flush=True)
                check(not missed, f"ln_mlp {tag}: over MLP_TOL: {'; '.join(missed)}")
                check(step <= 1e-5, f"ln_mlp {tag}: the kernel's h is more than one bf16 "
                      f"rounding from the plain version's")
                check(all(k <= 2 * pl + 1e-7 for k, pl in dev.values()),
                      f"ln_mlp {tag}: the kernel's LayerNorm statistics are further from f64 "
                      f"than the plain version's ({dev})")

    def param_grads_vs_autograd(self, got, fn, leaves, dy, what: str) -> float:
        """A ``*_param_grads`` result against autograd through the plain version
        ``fn(*leaves)``. Each gradient may differ by PARAM_GRAD_RTOL of the
        largest value among the gradients of its rank (vectors, matrices): a
        gradient that is zero in exact arithmetic (the key bias: the rows of dS
        sum to zero) is then held to the noise level of its siblings. Returns
        the largest such ratio."""
        import torch

        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        want = torch.autograd.grad(fn(*leaves), leaves, dy)
        scale = {}
        for w in want:
            scale[w.dim()] = max(scale.get(w.dim(), 0.0), float(w.float().abs().max()))
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: gradient {i} dtype/shape")
            check(bool(torch.isfinite(g).all()), f"{what}: gradient {i} non-finite")
            ratio = float((g.float() - w.float()).abs().max()) / scale[w.dim()]
            check(ratio <= PARAM_GRAD_RTOL, f"{what}: gradient {i} off by {ratio:.3e} of its scale")
            worst = max(worst, ratio)
        return worst

    def fused_mlp_vs_plain(self) -> dict:
        import torch

        km = self.km
        (fa, fr), (ga, gr) = MLP_TOL
        err = {"fwd": 0.0, "bwd": 0.0}  # at the ViT-B shape
        for shape in FMLP_SHAPES + MLP_EDGE_SHAPES:
            x, dy, p = self.mlp_operands(shape)
            tag = f"bfloat16 {shape} [{km.kernel_variant(*shape[1:])}]"

            def plain(q):
                return (km.mlp_reference(x, q["w1"], q["b1"], q["w2"], q["b2"]),
                        km.mlp_bwd_reference(x, q["w1"], q["b1"], q["w2"], dy))

            want_f, want_b = plain(p)
            got_f = km.fused_mlp_fwd(x, p["w1"], p["b1"], p["w2"], p["b2"])
            got_b = km.fused_mlp_bwd(x, p["w1"], p["b1"], p["w2"], dy)
            e_f = close(got_f, want_f, fa, fr, f"fused_mlp fwd {tag}")
            e_b = close(got_b, want_b, ga, gr, f"fused_mlp dx {tag}")
            check(torch.equal(got_b, km.fused_mlp_bwd(x, p["w1"], p["b1"], p["w2"], dy)),
                  f"fused_mlp backward not reproducible {tag}")
            if shape in MLP_EDGE_SHAPES:
                torch.cuda.synchronize()
                print(f"phase 3 fused_mlp vs plain {tag} (tile edge): fwd max|err| {e_f:.3e}, dx "
                      f"max|err| {e_b:.3e}; backward bitwise reproducible", flush=True)
                continue
            moved = {}
            for name in ("b1", "b2"):
                wo_f, wo_b = plain({**p, name: torch.zeros_like(p[name])})
                moved[name] = (float((wo_f.float() - want_f.float()).abs().max()),
                               float((wo_b.float() - want_b.float()).abs().max()))
                for what, mv, a, r, ref in (("fwd", moved[name][0], fa, fr, want_f),
                                            ("dx", moved[name][1], ga, gr, want_b)):
                    if (name, what) == ("b2", "dx"):
                        continue  # b2 does not enter dx
                    limit = a + r * float(ref.float().abs().max())
                    check(mv > 5 * limit, f"fused_mlp {what} {tag}: dropping {name} moves the "
                          f"plain output by only {mv:.3e} (limit {limit:.3e})")
            names = ("w1", "b1", "w2", "b2")
            e_p = self.param_grads_vs_autograd(
                km.mlp_param_grads(x, *(p[n] for n in names), dy, (True,) * 4),
                lambda *q: km.mlp_reference(x, *q), [p[n] for n in names], dy,
                f"mlp_param_grads {tag}")
            torch.cuda.synchronize()
            if shape == FMLP_SHAPES[0]:
                err = {"fwd": e_f, "bwd": e_b}
            print(f"phase 3 fused_mlp vs plain {tag}: fwd max|err| {e_f:.3e}, dx max|err| "
                  f"{e_b:.3e}; dropping b1 / b2 moves plain fwd/dx by "
                  + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in moved.values())
                  + f"; param grads vs autograd within {e_p:.2e} of their scale; backward "
                  f"bitwise reproducible", flush=True)
        return err

    def attn_block_operands(self, shape, gen=None):
        """bf16 x and dy (B, N, C); LN scale/bias and the four biases at std
        MLP_PARAM_STD, the weights at std 1/sqrt(C), wq and wk times AB_QK_GAIN.
        The cotangent is drawn at std 1/16: with these peaked scores dx is then
        of order 1, as in the JAX kernel's parity test whose limits are used
        (at std 1 it reaches 60, where one bf16 ulp of dq, dk or dv is 0.25).
        Drawn from ``gen``, by default ``self.gen``."""
        import torch

        b, n, c, _ = shape

        def rand(*size):
            return torch.randn(*size, device=self.dev, generator=gen or self.gen)

        x = (rand(b, n, c) + 0.5 * rand(b, n, 1)).to(torch.bfloat16)
        dy = (rand(b, n, c) / 16).to(torch.bfloat16)
        p = {"ln_scale": 1.0 + MLP_PARAM_STD * rand(c), "ln_bias": MLP_PARAM_STD * rand(c)}
        for t in "qkvo":
            gain = AB_QK_GAIN if t in "qk" else 1.0
            p[f"w{t}"], p[f"b{t}"] = rand(c, c) * c ** -0.5 * gain, MLP_PARAM_STD * rand(c)
        return x, dy, p

    AB_ORDER = ("ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")

    def attn_block_vs_plain(self) -> dict:
        import torch

        kb, eps = self.kb, 1e-6
        (fa, fr), (ga, gr) = AB_TOL
        err = {"fwd": 0.0, "bwd": 0.0}  # at the ViT-B shape
        for shape in AB_SHAPES:
            h = shape[3]
            x, dy, p = self.attn_block_operands(shape)
            tag = f"bfloat16 {shape[:3]} h{h}"

            def plain(q):
                args = [q[n] for n in self.AB_ORDER]
                return (kb.attn_block_reference(x, *args, h, eps),
                        kb.attn_block_bwd_reference(x, *args[:-1], dy, h, eps))

            args = [p[n] for n in self.AB_ORDER]
            probs = kb._forward_parts(x, *args[:8], h, eps)[-1]
            peak = float(probs.amax(dim=-1).mean())
            check(peak > 5.0 / shape[1], f"attn_block {tag}: the softmax is near uniform "
                  f"(mean row maximum {peak:.4f} against 1/N = {1 / shape[1]:.4f})")
            del probs
            want_f, want_b = plain(p)
            got_f = kb.fused_attn_block_fwd(x, *args, h, eps)
            got_b = kb.fused_attn_block_bwd(x, *args[:-1], dy, h, eps)
            e_f = close(got_f, want_f, fa, fr, f"attn_block fwd {tag}")
            e_b = close(got_b, want_b, ga, gr, f"attn_block dx {tag}")
            check(torch.equal(got_b, kb.fused_attn_block_bwd(x, *args[:-1], dy, h, eps)),
                  f"attn_block backward not reproducible {tag}")
            # can the check see each row parameter? bk is left out: a bias on
            # every key shifts a query's scores by one constant, which the
            # softmax removes; for the same reason bv does not enter dx (it
            # shifts a row of dP by one constant), and bo does not either
            moved = {}
            for name, neutral in (("ln_scale", 1.0), ("ln_bias", 0.0), ("bq", 0.0), ("bv", 0.0),
                                  ("bo", 0.0)):
                wo_f, wo_b = plain({**p, name: torch.full_like(p[name], neutral)})
                moved[name] = (float((wo_f.float() - want_f.float()).abs().max()),
                               float((wo_b.float() - want_b.float()).abs().max()))
                for what, mv, a, r, ref in (("fwd", moved[name][0], fa, fr, want_f),
                                            ("dx", moved[name][1], ga, gr, want_b)):
                    if what == "dx" and name in ("bv", "bo"):
                        continue
                    limit = a + r * float(ref.float().abs().max())
                    check(mv > 5 * limit, f"attn_block {what} {tag}: dropping {name} moves the "
                          f"plain output by only {mv:.3e} (limit {limit:.3e})")
            e_p = self.param_grads_vs_autograd(
                kb.attn_block_param_grads(x, *args, dy, h, eps, (True,) * 10),
                lambda *q: kb.attn_block_reference(x, *q, h, eps), args, dy,
                f"attn_block_param_grads {tag}")
            torch.cuda.synchronize()
            if shape == AB_SHAPES[0]:
                err = {"fwd": e_f, "bwd": e_b}
            print(f"phase 3 attn_block vs plain {tag} [{kb.kernel_variant(*shape[1:])}]: fwd "
                  f"max|err| {e_f:.3e}, dx max|err| "
                  f"{e_b:.3e}; mean row maximum of P {peak:.3f} (1/N = {1 / shape[1]:.4f}); "
                  f"dropping a row parameter moves plain fwd/dx by "
                  + ", ".join(f"{n} {a:.2f}/{b:.2f}" for n, (a, b) in moved.items())
                  + f"; param grads vs autograd within {e_p:.2e} of their scale; backward "
                  f"bitwise reproducible", flush=True)
        edges = []
        for n in AB_EDGE_N:
            shape = (3, n, 192, 3)
            x, dy, p = self.attn_block_operands(shape, self.edge_gen)
            args = [p[k] for k in self.AB_ORDER]
            tag = f"bfloat16 {shape[:3]} h3"
            got_b = kb.fused_attn_block_bwd(x, *args[:-1], dy, 3, eps)
            e_f = close(kb.fused_attn_block_fwd(x, *args, 3, eps),
                        kb.attn_block_reference(x, *args, 3, eps), fa, fr, f"attn_block fwd {tag}")
            e_b = close(got_b, kb.attn_block_bwd_reference(x, *args[:-1], dy, 3, eps), ga, gr,
                        f"attn_block dx {tag}")
            check(torch.equal(got_b, kb.fused_attn_block_bwd(x, *args[:-1], dy, 3, eps)),
                  f"attn_block backward not reproducible {tag}")
            edges.append(f"N={n} [{kb.kernel_variant(n, 192, 3)}] {e_f:.2e}/{e_b:.2e}")
        torch.cuda.synchronize()
        print("phase 3 attn_block vs plain at the tile edges, (3, N, 192) h3 bf16, fwd/dx max|err|: "
              + ", ".join(edges) + "; every backward bitwise reproducible", flush=True)
        return err

    def bhnd_vs_plain(self) -> dict:
        """The head-major kernel at the packed kernel's shapes: against its
        plain version, and bit for bit against the packed kernel on the
        transposed operands (one device code, another stride)."""
        import torch

        ka, err = self.ka, {"fwd": 0.0, "bwd": 0.0}  # at the main-path shape, bf16
        for dtype_name, ((fa, fr), (ga, gr)) in TOL.items():
            dtype = getattr(torch, dtype_name)
            for (b, n, h, hd) in SHAPES[dtype_name]:
                q, k, v, do = (torch.randn(b, h, n, hd, device=self.dev, generator=self.gen)
                               .to(dtype) for _ in range(4))
                tag = f"{dtype_name} {(b, h, n, hd)}"
                got_f = ka.fused_attention_fwd(q, k, v)
                e_f = close(got_f, ka.attention_reference(q, k, v), fa, fr, f"bhnd fwd {tag}")
                got = ka.fused_attention_bwd(q, k, v, do)
                want = ka.attention_bwd_reference(q, k, v, do)
                e_b = max(close(g_, w_, ga, gr, f"bhnd d{nm} {tag}")
                          for nm, g_, w_ in zip("qkv", got, want))
                check(all(torch.equal(a_, b_) for a_, b_ in
                          zip(got, ka.fused_attention_bwd(q, k, v, do))),
                      f"head-major backward not reproducible {tag}")
                qp, kp, vp, dop = (ka._merge(t).contiguous() for t in (q, k, v, do))
                check(torch.equal(ka._merge(got_f), ka.fused_attention_packed_fwd(qp, kp, vp, h))
                      and all(torch.equal(ka._merge(a_), b_) for a_, b_ in
                              zip(got, ka.fused_attention_packed_bwd(qp, kp, vp, dop, h))),
                      f"head-major and packed kernels differ {tag}")
                torch.cuda.synchronize()
                if dtype == torch.bfloat16 and (b, n, h, hd) == MAIN:
                    err = {"fwd": e_f, "bwd": e_b}
                print(f"phase 3 fused_attention (B,H,N,hd) vs plain {tag}: fwd max|err| "
                      f"{e_f:.3e}, dq/dk/dv max|err| {e_b:.3e}; equal bit for bit to the packed "
                      f"kernel on the transposed operands; backward bitwise reproducible",
                      flush=True)
        return err

    # 4. model
    def model(self, name: str, module=None, attn_name: str = "", plain=None, kernel_fields=None):
        """Merged rank-8 LoRA, bf16, checkpoint round trip, kernel vs plain logits.

        The plain side is the model with its attention routed through ``plain``
        (``module.attn_name``), or, with ``kernel_fields`` (config fields that
        switch kernels on), the model built without them."""
        import numpy as np
        import torch

        lora, trees, ckpt = self.lora, self.trees, self.checkpoint
        entry = self.registry.get_model(name)
        off_cfg = entry.config(CLASSES)
        cfg = dataclasses.replace(off_cfg, **(kernel_fields or {}))
        g_cpu = torch.Generator().manual_seed(0)
        tree = trees.flatten_with_paths(entry.init(cfg, g_cpu))
        for p in tree:
            if p.endswith("bias_table"):
                tree[p] = torch.randn(tree[p].shape, generator=g_cpu) * SWIN_BIAS_STD
            elif name == "convnext" and p.endswith("gamma"):
                # at the 1e-6 init every block is the identity to bf16
                tree[p] = 0.1 + 0.4 * torch.rand(tree[p].shape, generator=g_cpu)
            elif name == "convnext" and p.rsplit("/", 1)[-1] in ("b", "bias"):
                tree[p] = torch.randn(tree[p].shape, generator=g_cpu) * 0.1
            elif "/bn/" in p:
                # YOLO11's BN statistics and affine: at the init every BN is the identity
                tree[p] = (torch.randn(tree[p].shape, generator=g_cpu) * 0.1
                           if p.endswith(("mean", "bias"))
                           else 0.5 + torch.rand(tree[p].shape, generator=g_cpu))
        tree = trees.unflatten_from_paths(tree)
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg))
        adapter = lora.init(g_cpu, tree, lcfg)
        for fac in adapter.values():
            fac["b"] = torch.randn(fac["b"].shape, generator=g_cpu) * 0.02
        merged = lora.merge(tree, adapter, lcfg)
        target = lcfg.targets[0]
        check(not torch.equal(trees.get_path(merged, target)["w"],
                              trees.get_path(tree, target)["w"]),
              f"{name}: the LoRA merge left the weights unchanged")
        check(all(torch.equal(trees.get_path(merged, p)["w"], trees.get_path(tree, p)["w"]
                              + lcfg.scale * torch.matmul(adapter[p]["a"], adapter[p]["b"]))
                  for p in lcfg.targets), f"{name}: merged weights are not base + s*A*B")
        bf16_tree = trees.map_leaves(lambda t: t.to(torch.bfloat16), merged)
        path = os.path.join(self.build_mod.build_dir(), f"chip_smoke_{name}_bf16.safetensors")
        ckpt.save_pytree(bf16_tree, path, meta={"model": name, "lora_rank": 8})
        loaded, meta = ckpt.load_pytree(path)
        os.unlink(path)
        flat_a, flat_b = trees.flatten_with_paths(bf16_tree), trees.flatten_with_paths(loaded)
        check(set(flat_a) == set(flat_b) and meta == {"model": name, "lora_rank": 8},
              f"{name}: checkpoint paths or metadata changed")
        check(all(flat_b[p].dtype == torch.bfloat16 and torch.equal(
            flat_a[p].view(torch.int16), flat_b[p].view(torch.int16)) for p in flat_a),
            f"{name}: checkpoint round trip is not byte-equal")
        model_tree = trees.map_leaves(lambda t: t.to(self.dev), loaded)
        model = entry.from_tree(model_tree, cfg)
        size = cfg.image_size
        x8 = torch.from_numpy(np.random.default_rng(0).random((8, size, size, 3),
                                                               dtype=np.float32)).to(self.dev)
        normalize = self.common.Normalizer(*self.registry.get_normalization(name))
        logit_err = {}
        for dtype_name, (la, lr) in LOGIT_TOL[name].items():
            bf16 = dtype_name == "bfloat16"
            mcfg = cfg if bf16 else dataclasses.replace(cfg, compute_dtype="float32")
            dev_tree = (model_tree if bf16
                        else trees.map_leaves(lambda t: t.to(self.dev), merged))
            m = model if bf16 else entry.from_tree(dev_tree, mcfg)
            with torch.no_grad():
                got = entry.apply(mcfg, m, normalize(x8))
                if kernel_fields:
                    pcfg = dataclasses.replace(mcfg, **{f: False for f in kernel_fields})
                    want = entry.apply(pcfg, entry.from_tree(dev_tree, pcfg), normalize(x8))
                elif module is None:  # no kernel: against the f32 model
                    fcfg = dataclasses.replace(cfg, compute_dtype="float32")
                    want = entry.apply(fcfg, entry.from_tree(trees.map_leaves(
                        lambda t: t.to(self.dev), merged), fcfg), normalize(x8))
                else:
                    with plain_path(module, attn_name, plain):
                        want = entry.apply(mcfg, m, normalize(x8))
            check(got.shape == (8, CLASSES), f"{name}: logits shape {tuple(got.shape)}")
            logit_err[dtype_name] = close(got, want, la, lr, f"{name} logits {dtype_name}")
            del m
        blocks = sum(getattr(cfg, "depths", ())) or getattr(cfg, "depth", 0)
        size = (f"{blocks} blocks" if blocks else
                f"{sum(t.numel() for t in flat_a.values())} parameters")
        vs = ("kernel vs library" if kernel_fields else "kernel vs plain" if module is not None
              else "vs the f32 model")
        print(f"phase 4 model: {name} {size}, rank-8 LoRA merged (weights = base + s*A*B), "
              f"bf16 checkpoint round trip byte-equal ({len(flat_a)} tensors), logits {vs} "
              f"max|err| " + " ".join(f"{d} {e:.3e}" for d, e in logit_err.items()), flush=True)
        return entry, cfg, model, tree, normalize, model_tree

    # 5. attack
    def attack(self, name: str, entry, cfg, model, normalize, counters, expect):
        """FGSM + PGD-10 with the kernels' counts reset just before and read just after.

        ``counters``: ``{key: (module, attribute)}``; ``expect``: the count each
        must show (11 forward and 11 backward passes per block; 0 for a
        gradient the attack path must not compute)."""
        import numpy as np
        import torch

        common, whitebox = self.common, self.whitebox
        rng = np.random.default_rng(1)
        size = cfg.image_size
        images_u8 = torch.from_numpy(
            rng.integers(0, 256, (BATCH, size, size, 3), dtype=np.uint8)).to(self.dev)
        labels = torch.from_numpy(rng.integers(0, CLASSES, BATCH)).to(self.dev)
        fgsm = whitebox.make_fgsm(entry.apply, cfg, eps=EPS, normalize=normalize)
        pgd = whitebox.make_pgd(entry.apply, cfg, eps=EPS, alpha=ALPHA, steps=PGD_STEPS,
                                normalize=normalize)
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        adv_f = fgsm(model, images_u8, labels)
        adv_p = pgd(model, images_u8, labels, torch.Generator(self.dev).manual_seed(1))
        torch.cuda.synchronize()
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        check(launches == expect, f"{name}: kernel counts {launches} (want {expect})")
        clean = common.to_unit_floats(images_u8)
        for what, adv in (("fgsm", adv_f), ("pgd", adv_p)):
            check(adv.shape == clean.shape and adv.dtype == torch.float32,
                  f"{name} {what} shape/dtype")
            check(bool(torch.isfinite(adv).all()), f"{name} {what} non-finite")
            check(float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0,
                  f"{name} {what} outside [0,1]")
            check(float((adv - clean).abs().max()) <= EPS + 1e-6,
                  f"{name} {what} outside the eps-ball")
            q8 = common.uint8_quantize(adv)
            check(q8.shape == tuple(images_u8.shape) and q8.dtype == np.uint8,
                  f"{name} {what} uint8")
        with torch.no_grad():
            ce_clean = float(common.sum_cross_entropy(
                entry.apply(cfg, model, normalize(clean)), labels))
            ce_pgd = float(common.sum_cross_entropy(
                entry.apply(cfg, model, normalize(adv_p)), labels))
        check(ce_pgd > ce_clean, f"{name}: PGD did not raise the loss ({ce_clean} -> {ce_pgd})")
        print(f"phase 5 attack: {name} FGSM + PGD-{PGD_STEPS} B={BATCH} bf16, summed CE clean "
              f"{ce_clean:.4f} -> PGD {ce_pgd:.4f}, kernel launches {launches}", flush=True)
        return launches, pgd, images_u8, labels, adv_f, adv_p

    def compose(self, name, entry, cfg, base_tree, images_u8, labels, adv_f, adv_p, counters,
                per_forward):
        """eval-compose from memory; returns the matrix's wall seconds.

        ``counters`` as in :meth:`attack`; ``per_forward``: the count each must
        show per model forward (0 for a backward or gradient counter)."""
        import numpy as np
        import torch

        lora, trees, peft_io = self.lora, self.trees, self.peft_io
        g_cpu = torch.Generator().manual_seed(3)
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg))
        # the classifier: the head itself, or YOLO11's head/linear beside its head/conv
        lin = "head" if "w" in base_tree["head"] else "head/linear"
        last = trees.get_path(base_tree, lin)["w"].shape[0]
        adapters = {}
        for attack in ("fgsm", "pgd"):
            ad = lora.init(g_cpu, base_tree, lcfg)
            for fac in ad.values():
                fac["b"] = torch.randn(fac["b"].shape, generator=g_cpu) * 0.02
            head = {"w": torch.randn(last, CLASSES, generator=g_cpu) * last ** -0.5,
                    "b": torch.randn(CLASSES, generator=g_cpu) * 0.1}
            if lin != "head":
                head = {**base_tree["head"], "linear": head}
            out_dir = os.path.join(self.build_mod.build_dir(),
                                   f"chip_smoke_{name}_{attack}_adapter")
            peft_io.save_peft_adapter(ad, lcfg, out_dir, head=head)
            got, got_cfg, got_head = peft_io.load_peft_adapter(out_dir)
            check(set(got) == set(ad) and got_cfg.rank == 8 and got_cfg.alpha == 16.0,
                  f"{attack} adapter paths or config changed")
            fh, fg = trees.flatten_with_paths(head), trees.flatten_with_paths(got_head)
            check(all(torch.equal(got[p][k], ad[p][k]) for p in ad for k in ("a", "b"))
                  and set(fg) == set(fh) and all(torch.equal(fg[k], fh[k]) for k in fh),
                  f"{attack} adapter round trip is not byte-equal")
            adapters[attack] = (got, got_cfg, got_head)
        Batch = self.loader.Batch

        def batches(images):
            return [Batch(images, labels.cpu().numpy().astype(np.int32),
                          np.ones(BATCH, np.float32), [])]

        loaders = {"clean": batches(images_u8.cpu().numpy()),
                   "fgsm": batches(self.common.uint8_quantize(adv_f)),
                   "pgd": batches(self.common.uint8_quantize(adv_p))}
        normalize = self.common.Normalizer(*self.registry.get_normalization(name))
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        results = self.compose_mod.run_composability_eval(
            entry, base_tree, adapters, loaders, CLASSES, cfg=cfg, normalize=normalize,
            device=self.dev, log=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        want_variants = ["base", "lora_fgsm", "lora_pgd", "fgsm+pgd"]
        check(list(results) == want_variants
              and all(list(r) == ["clean", "fgsm", "pgd"] for r in results.values()),
              f"compose matrix {[(v, list(r)) for v, r in results.items()]}")
        forwards = len(want_variants) * len(loaders)
        check(launches == {k: n * forwards for k, n in per_forward.items()},
              f"{name} compose launches {launches} over {forwards} forwards")
        base_d = trees.map_leaves(lambda t: t.to(self.dev), base_tree)
        base_model = entry.from_tree(base_d, cfg)
        with torch.no_grad():
            logits = entry.apply(cfg, base_model, normalize(self.common.to_unit_floats(images_u8)))
        direct = float((logits.argmax(-1) == labels).float().mean())
        check(results["base"]["clean"]["accuracy"] == direct,
              f"base/clean accuracy {results['base']['clean']['accuracy']} != {direct}")
        ads_d = {k: ({p: {f: t.to(self.dev) for f, t in fac.items()} for p, fac in a.items()},
                     c, trees.map_leaves(lambda t: t.to(self.dev), h))
                 for k, (a, c, h) in adapters.items()}
        merged = self.compose_mod.build_variant_params(base_d, ("fgsm", "pgd"), ads_d)
        for path in lcfg.targets:
            want = trees.get_path(base_d, path)["w"] + sum(
                lcfg.scale * torch.matmul(ads_d[a][0][path]["a"], ads_d[a][0][path]["b"])
                for a in ("fgsm", "pgd"))
            close(trees.get_path(merged, path)["w"], want, 1e-6, 1e-5, f"merged {path}")
        check(merged["head"] is ads_d["pgd"][2], "the last merged head did not win")
        for line in self.compose_mod.format_summary_table(results).splitlines():
            print(f"phase 5 compose: {line}")
        print(f"phase 5 compose: {name} 4 variants x 3 datasets (B={BATCH} each), f32 params "
              f"bf16 compute, heads {'nested (framework_head.*)' if lin != 'head' else 'flat'}, "
              f"base/clean accuracy {direct:.4f} = direct argmax count, merged "
              f"fgsm+pgd weights = base + sum s*A*B on {len(lcfg.targets)} targets, "
              f"kernel launches {launches}, wall {wall:.3f} s", flush=True)
        return wall

    # 4/5. ViT-B with its kernel fields on, and training
    def vit_counters(self) -> dict:
        ka, km, kb = self.ka, self.km, self.kb
        return {"packed_fwd": (ka, "FWD_LAUNCHES"), "packed_bwd": (ka, "BWD_LAUNCHES"),
                "attn_block_fwd": (kb, "FWD_LAUNCHES"), "attn_block_bwd": (kb, "BWD_LAUNCHES"),
                "attn_block_param_grads": (kb, "PARAM_GRAD_CALLS"),
                "ln_mlp_fwd": (km, "FWD_LAUNCHES"), "ln_mlp_bwd": (km, "BWD_LAUNCHES"),
                "ln_mlp_param_grads": (km, "PARAM_GRAD_CALLS"),
                "mlp_fwd": (km, "MLP_FWD_LAUNCHES"), "mlp_bwd": (km, "MLP_BWD_LAUNCHES"),
                "mlp_param_grads": (km, "MLP_PARAM_GRAD_CALLS")}

    def counted(self, counters, fn):
        """Run ``fn`` with every count set to 0 just before and read just after."""
        import torch

        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def vit_fields(self, entry, cfg, model_tree, normalize, off_model) -> dict:
        """The merged bf16 ViT-B with ``fuse_attn_block`` and with
        ``use_fused_mlp``: logits against the fields-off model, then FGSM +
        PGD-10 with exact launch counts. Returns the counts per field."""
        import numpy as np
        import torch

        x8 = torch.from_numpy(np.random.default_rng(0).random(
            (8, cfg.image_size, cfg.image_size, 3), dtype=np.float32)).to(self.dev)
        per = cfg.depth * (PGD_STEPS + 1)
        zero = {k: 0 for k in self.vit_counters()}
        expect = {"fuse_attn_block": {**zero, "attn_block_fwd": per, "attn_block_bwd": per,
                                      "ln_mlp_fwd": per, "ln_mlp_bwd": per},
                  "use_fused_mlp": {**zero, "packed_fwd": per, "packed_bwd": per,
                                    "mlp_fwd": per, "mlp_bwd": per}}
        out = {}
        la, lr = LOGIT_TOL["google_vit"]["bfloat16"]
        for field, want in expect.items():
            vcfg = dataclasses.replace(cfg, **{field: True})
            model = entry.from_tree(model_tree, vcfg)
            with torch.no_grad():
                e = close(entry.apply(vcfg, model, normalize(x8)),
                          entry.apply(cfg, off_model, normalize(x8)), la, lr,
                          f"google_vit logits with {field}")
            print(f"phase 4 model: google_vit with {field}: logits vs fields off max|err| "
                  f"{e:.3e}", flush=True)
            out[field] = self.attack(f"google_vit {field}", entry, vcfg, model, normalize,
                                     self.vit_counters(), want)[0]
        return out

    def swin_fused_mlp(self, entry, cfg, model_tree, normalize, off_model, counters):
        """The merged bf16 Swin-B with ``use_fused_mlp``: logits against the
        fields-off model, then FGSM + PGD-10 with exact launch counts (the
        fused MLP at all four stage widths). Returns the PGD callable, model,
        batch and labels for the timing."""
        import numpy as np
        import torch

        vcfg = dataclasses.replace(cfg, use_fused_mlp=True)
        model = entry.from_tree(model_tree, vcfg)
        x8 = torch.from_numpy(np.random.default_rng(0).random(
            (8, cfg.image_size, cfg.image_size, 3), dtype=np.float32)).to(self.dev)
        la, lr = LOGIT_TOL["swin"]["bfloat16"]
        with torch.no_grad():
            e = close(entry.apply(vcfg, model, normalize(x8)),
                      entry.apply(cfg, off_model, normalize(x8)), la, lr,
                      "swin logits with use_fused_mlp")
        print(f"phase 4 model: swin with use_fused_mlp: logits vs fields off max|err| {e:.3e}",
              flush=True)
        per = sum(cfg.depths) * (PGD_STEPS + 1)
        km = self.km
        counters = {**counters, "mlp_fwd": (km, "MLP_FWD_LAUNCHES"),
                    "mlp_bwd": (km, "MLP_BWD_LAUNCHES"),
                    "mlp_param_grads": (km, "MLP_PARAM_GRAD_CALLS")}
        _, pgd, x, y, _, _ = self.attack(
            "swin use_fused_mlp", entry, vcfg, model, normalize, counters,
            {"fwd": per, "bwd": per, "dbias": 0, "mlp_fwd": per, "mlp_bwd": per,
             "mlp_param_grads": 0})
        return pgd, model, x, y

    def train_batch(self, size: int):
        """A uint8 batch a model can learn under augmentation: each class has
        a colour (from a numpy seed), each pixel that colour plus noise."""
        import numpy as np

        rng = np.random.default_rng(5)
        labels = rng.integers(0, CLASSES, BATCH)
        colours = rng.integers(40, 216, (CLASSES, 3))
        noise = rng.integers(-40, 41, (BATCH, size, size, 3))
        images = np.clip(colours[labels][:, None, None, :] + noise, 0, 255).astype(np.uint8)
        return self.loader.Batch(images, labels.astype(np.int32), np.ones(BATCH, np.float32), [])

    def on_device(self, batch):
        import torch

        return tuple(torch.as_tensor(a).to(self.dev)
                     for a in (batch.images, batch.labels, batch.valid))

    def fixed_ce(self, entry, cfg, model, normalize, batch) -> float:
        """Mean cross-entropy on the batch, no augmentation, eval mode."""
        step = self.steps.make_eval_step(lambda m, x: entry.apply(cfg, m, x), CLASSES,
                                         normalize=normalize)
        model.eval()
        loss, _ = step(model, *self.on_device(batch))
        return float(loss) / BATCH

    def full_trainer(self, entry, cfg, dev_tree, steps_per_epoch: int):
        """Model and state as ``train_base_model`` builds them."""
        import torch

        model = entry.from_tree(self.trees.map_leaves(torch.clone, dev_tree), cfg)
        state = self.steps.TrainState.create(model, None, lambda ps: self.optim.adamw_steplr(
            ps, 1e-4, weight_decay=1e-4, steps_per_epoch=steps_per_epoch))
        return model, state

    def fit_steps(self, entry, cfg, model, state, normalize, batch, steps, *, augment, snapshot):
        import torch

        return self.loop.fit(
            lambda m, x: entry.apply(cfg, m, x), model, state, [batch] * steps, None, epochs=1,
            num_classes=CLASSES, normalize=normalize, device=self.dev, log=lambda s: None,
            generator=torch.Generator(self.dev).manual_seed(17) if augment else None,
            augment=self.augment.train_augment if augment else None, snapshot=snapshot)

    def train_full(self, entry, tree, normalize) -> dict:
        """(a) full fine-tune, ``fuse_attn_block`` on, AdamW + StepLR, augmentation on."""
        import torch

        off = entry.config(CLASSES)
        cfg = dataclasses.replace(off, fuse_attn_block=True)
        dev_tree = self.trees.map_leaves(lambda t: t.to(self.dev), tree)
        batch = self.train_batch(cfg.image_size)

        def make(c):
            model = entry.from_tree(dev_tree, c)
            return model, [n for n, _ in model.named_parameters()]

        vs_off = self.one_step_vs_off(entry, cfg, off, make, normalize, batch,
                                      "google_vit full fine-tune")

        model, state = self.full_trainer(entry, cfg, dev_tree, TRAIN_STEPS)
        before = {n: p.detach().clone() for n, p in state.trainable.items()}
        ce0 = self.fixed_ce(entry, cfg, model, normalize, batch)
        _, launches = self.counted(self.vit_counters(), lambda: self.fit_steps(
            entry, cfg, model, state, normalize, batch, TRAIN_STEPS, augment=True,
            snapshot=lambda: None))
        per = cfg.depth * TRAIN_STEPS
        want = {k: 0 for k in launches}
        want.update({k: per for k in ("attn_block_fwd", "attn_block_bwd", "attn_block_param_grads",
                                      "ln_mlp_fwd", "ln_mlp_bwd", "ln_mlp_param_grads")})
        check(launches == want, f"full fine-tune kernel counts {launches} (want {want})")
        check(state.step == TRAIN_STEPS and len(state.trainable) == len(list(model.parameters())),
              "full fine-tune: update count or trainable set")
        for n, p_ in state.trainable.items():
            check(p_.dtype == torch.float32 and p_.grad is not None
                  and bool(torch.isfinite(p_.grad).all()), f"gradient of {n} missing or non-finite")
            check(not torch.equal(before[n], p_), f"trainable leaf {n} did not change")
        ce1 = self.fixed_ce(entry, cfg, model, normalize, batch)
        check(ce1 < ce0, f"full fine-tune: CE on the fixed batch {ce0} -> {ce1}")
        print(f"phase 5 train: google_vit full fine-tune, fuse_attn_block, AdamW + StepLR, "
              f"augmentation on, f32 params bf16 compute, B={BATCH}, {TRAIN_STEPS} steps through "
              f"fit: CE on the fixed batch {ce0:.4f} -> {ce1:.4f}; {len(before)} leaves all "
              f"changed, gradients finite; {vs_off}kernel launches {launches}", flush=True)
        return launches

    def train_lora(self, entry, tree, normalize) -> dict:
        """(b) LoRA defense: rank 8 on q/k/v/o unmerged, head trainable, dropout
        0.1 on the adapter input, Adam, ``use_fused_mlp`` on; then one step with
        ``fuse_attn_block`` instead."""
        import torch

        lora, trees = self.lora, self.trees
        off = entry.config(CLASSES)
        cfg = dataclasses.replace(off, use_fused_mlp=True)
        lcfg = lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg), dropout=0.1,
                               dropout_mode="input")
        dev_tree = trees.map_leaves(lambda t: t.to(self.dev), tree)
        batch = self.train_batch(cfg.image_size)
        model, state, snapshot = self.loop.lora_trainer(
            entry, cfg, dev_tree, lcfg, lr=1e-4, train_head=True, seed=0, device=self.dev)
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n not in state.trainable}
        check(len(state.trainable) == 2 * 4 * cfg.depth + 2
              and not any(p.requires_grad for n, p in model.named_parameters() if n in frozen),
              f"LoRA: {len(state.trainable)} trainable tensors, or a frozen one asks a gradient")
        ce0 = self.fixed_ce(entry, cfg, model, normalize, batch)
        _, launches = self.counted(self.vit_counters(), lambda: self.fit_steps(
            entry, cfg, model, state, normalize, batch, TRAIN_STEPS, augment=False,
            snapshot=snapshot))
        per = cfg.depth * TRAIN_STEPS
        want = {k: 0 for k in launches}
        want.update({k: per for k in ("packed_fwd", "packed_bwd", "mlp_fwd", "mlp_bwd")})
        check(launches == want, f"LoRA training kernel counts {launches} (want {want})")
        named = dict(model.named_parameters())
        check(all(torch.equal(t, named[n]) for n, t in frozen.items()),
              "LoRA training changed a frozen leaf")
        check(all(bool(p_.detach().abs().max() > 0) for n, p_ in state.trainable.items()
                  if n.endswith("lora_b")), "a lora_b is still zero")
        ce1 = self.fixed_ce(entry, cfg, model, normalize, batch)
        check(ce1 < ce0, f"LoRA training: CE on the fixed batch {ce0} -> {ce1}")

        e_m = self.adapter_round_trip("google_vit", entry, cfg, off, model, dev_tree, snapshot(),
                                      lcfg, batch, normalize)
        del model, state, frozen

        cfg2 = dataclasses.replace(off, fuse_attn_block=True)
        model2, state2, snap2 = self.loop.lora_trainer(
            entry, cfg2, dev_tree, lcfg, lr=1e-4, train_head=True, seed=0, device=self.dev)
        _, l2 = self.counted(self.vit_counters(), lambda: self.fit_steps(
            entry, cfg2, model2, state2, normalize, batch, 1, augment=False, snapshot=snap2))
        want2 = {k: 0 for k in l2}
        want2.update({k: cfg.depth for k in ("packed_fwd", "packed_bwd", "ln_mlp_fwd", "ln_mlp_bwd")})
        check(l2 == want2, f"LoRA with fuse_attn_block kernel counts {l2} (want {want2})")
        print(f"phase 5 train: google_vit LoRA rank 8 on q/k/v/o unmerged, dropout 0.1 (input), "
              f"head trainable, Adam, use_fused_mlp, f32 params bf16 compute, B={BATCH}, "
              f"{TRAIN_STEPS} steps through fit: CE on the fixed batch {ce0:.4f} -> {ce1:.4f}; "
              f"base leaves bitwise unchanged, every lora_b non-zero; adapter + head through the "
              f"PEFT writer/reader byte-equal, merged into the base vs the unmerged model "
              f"max|err| {e_m:.3e}; kernel launches {launches}; one step with fuse_attn_block "
              f"instead: {l2}", flush=True)
        return launches

    # 4/5. the zoo's other families: weight import, YOLO11-cls, training
    def all_counters(self) -> dict:
        """Every kernel counter of the package."""
        ka, kw, kd = self.ka, self.kw, self.kd
        return {**self.vit_counters(), "bhnd_fwd": (ka, "BHND_FWD_LAUNCHES"),
                "bhnd_bwd": (ka, "BHND_BWD_LAUNCHES"), "win_fwd": (kw, "FWD_LAUNCHES"),
                "win_bwd": (kw, "BWD_LAUNCHES"), "win_dbias": (kw, "DBIAS_CALLS"),
                "dw_fwd": (kd, "FWD_LAUNCHES"), "dw_dx": (kd, "DX_LAUNCHES"),
                "dw_dw": (kd, "DW_CALLS")}

    def imports(self, vit_tree, yolo_tree) -> None:
        """Pretrained-weight import through ``models.pretrained.load_pretrained``:
        ViT-B/16 as an HF state dict in a torch ``.pth`` and in an HF directory
        (``model.safetensors`` by the port's writer), a head-less DINO state
        dict, YOLO11-cls as an ultralytics ``.pth`` (also into 1000 classes),
        and YOLO11-s weights into the YOLO11-n config, which must raise."""
        import shutil

        import numpy as np
        import torch

        hf, pre, trees = self.hf_import, self.pretrained, self.trees
        out = os.path.join(self.build_mod.build_dir(), "chip_smoke_import")
        os.makedirs(out, exist_ok=True)
        t0 = time.perf_counter()

        def logits(name, tree):
            """bf16 logits of the model built from ``tree`` on 8 seeded images."""
            entry = self.registry.get_model(name)
            cfg = entry.config(CLASSES)
            model = entry.from_tree(trees.map_leaves(lambda t: t.to(self.dev), tree), cfg)
            normalize = self.common.Normalizer(*self.registry.get_normalization(name))
            x8 = torch.from_numpy(np.random.default_rng(0).random(
                (8, cfg.image_size, cfg.image_size, 3), dtype=np.float32)).to(self.dev)
            with torch.no_grad():
                return entry.apply(cfg, model, normalize(x8))

        def same(got, want, what):
            g, w = trees.flatten_with_paths(got), trees.flatten_with_paths(want)
            check(set(g) == set(w), f"{what}: paths {sorted(set(g) ^ set(w))[:4]}")
            check(all(g[p].dtype == torch.float32 and torch.equal(g[p].cpu(), w[p].cpu())
                      for p in w), f"{what}: the imported tree is not the source's bit for bit")
            return len(w)

        def drop(tree, prefix):
            """The tree's leaves but those under ``prefix``, flat."""
            return {p: v for p, v in trees.flatten_with_paths(tree).items()
                    if not p.startswith(prefix + "/")}

        vit_cfg = self.registry.get_model("google_vit").config(CLASSES)
        sd = hf.hf_from_vit_params(vit_tree, vit_cfg)
        pth = os.path.join(out, "google_vit_best_model_finetuned.pth")
        torch.save(sd, pth)
        hf_dir = os.path.join(out, "vit-base-patch16-224")
        self.checkpoint.save_tensors(sd, os.path.join(hf_dir, "model.safetensors"))
        want = logits("google_vit", vit_tree)
        for form, path in ((".pth", pth), ("HF directory", hf_dir)):
            _, _, tree = pre.load_pretrained("google_vit", CLASSES, path, device=self.dev)
            n_vit = same(tree, vit_tree, f"google_vit {form}")
            check(torch.equal(logits("google_vit", tree), want),
                  f"google_vit {form}: bf16 logits differ from the source's")
        mb = os.path.getsize(pth) / 2 ** 20

        dino = os.path.join(out, "dino_vitb16.pth")
        torch.save({k[len("vit."):]: v for k, v in sd.items() if k.startswith("vit.")}, dino)
        _, _, dtree = pre.load_pretrained("dinov1", CLASSES, dino)
        same(drop(dtree, "head"), drop(vit_tree, "head"), "dinov1")
        check(not dtree["head"]["w"].any() and not dtree["head"]["b"].any(), "dinov1: head not zero")
        check(not logits("dinov1", dtree).any(), "dinov1: logits of the zero head are not zero")

        ycfg = self.registry.get_model("yolo11-cls").config(CLASSES)
        ypth = os.path.join(out, "yolo11n-cls.pth")
        torch.save(hf.ultralytics_from_yolo11_params(yolo_tree, ycfg), ypth)
        _, _, ytree = pre.load_pretrained("yolo11-cls", CLASSES, ypth)
        n_yolo = same(ytree, yolo_tree, "yolo11-cls .pth")
        check(torch.equal(logits("yolo11-cls", ytree), logits("yolo11-cls", yolo_tree)),
              "yolo11-cls: bf16 logits differ from the source's")
        _, _, y1k = pre.load_pretrained("yolo11-cls", 1000, ypth)
        lin = y1k["head"]["linear"]
        check(tuple(lin["w"].shape) == (ycfg.head_width, 1000) and not lin["w"].any()
              and not lin["b"].any(), "yolo11-cls into 1000 classes: head/linear not zeroed")
        same(drop(y1k, "head/linear"), drop(yolo_tree, "head/linear"), "yolo11-cls into 1000 classes")
        s_cfg = self.yolo.YOLO11S_CLS.with_classes(CLASSES)
        spth = os.path.join(out, "yolo11s-cls.pth")
        torch.save(hf.ultralytics_from_yolo11_params(
            self.yolo.init(s_cfg, torch.Generator().manual_seed(5)), s_cfg), spth)
        try:
            pre.load_pretrained("yolo11-cls", CLASSES, spth)
        except ValueError as e:
            scale_err = str(e)
        else:
            raise RuntimeError("check failed: YOLO11-s weights loaded into the YOLO11-n config")
        shutil.rmtree(out)
        print(f"phase 4 import: google_vit as an HF state dict in a torch .pth ({mb:.1f} MiB) and "
              f"in an HF directory (model.safetensors) through load_pretrained: {n_vit} tensors "
              f"bit for bit the source's, bf16 logits equal; dinov1 head-less state dict: backbone "
              f"bit for bit, zero head, zero logits; yolo11-cls ultralytics .pth: {n_yolo} tensors "
              f"bit for bit, bf16 logits equal; into 1000 classes: head/linear zeroed, every other "
              f"leaf equal; YOLO11-s weights into YOLO11-n: ValueError ({scale_err[:80]}); "
              f"{time.perf_counter() - t0:.2f} s", flush=True)

    def one_step_vs_off(self, entry, cfg, off, make, normalize, batch, what: str) -> str:
        """One step's loss and the trainable leaves' gradient norms with the
        kernel fields of ``cfg`` on against ``off`` (eval mode: no dropout), at
        the ViT-B full fine-tune's limits. ``make(cfg) -> (model, names)``."""
        import torch
        import torch.nn.functional as F

        images, labels, _ = self.on_device(batch)

        def loss_and_norms(c):
            model, names = make(c)
            model.eval()
            loss = F.cross_entropy(entry.apply(c, model, normalize(
                self.common.to_unit_floats(images))).float(), labels.long())
            named = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, [named[n] for n in names])
            return float(loss.detach()), {n: float(g.float().norm()) for n, g in zip(names, grads)}

        (loss_on, norms_on), l_on = self.counted(self.all_counters(), lambda: loss_and_norms(cfg))
        (loss_off, norms_off), l_off = self.counted(self.all_counters(), lambda: loss_and_norms(off))
        check(l_on != l_off, f"{what}: the fields launched no other kernel ({l_on})")
        check(abs(loss_on - loss_off) <= 5e-2 * abs(loss_off),
              f"{what}: one step's loss with the fields on {loss_on} vs off {loss_off}")
        top = max(norms_off.values())
        # 5e-2 relative, plus 1e-3 of the largest norm: a key bias's gradient is
        # zero in exact arithmetic and pure rounding noise in both models
        worst = max(abs(norms_on[n] - b) / (b + 0.02 * top) for n, b in norms_off.items())
        check(worst <= 5e-2, f"{what}: gradient norms, fields on vs off: worst ratio {worst:.3e}")
        moved = {k: (l_on[k], l_off[k]) for k in l_on if l_on[k] != l_off[k]}
        return (f"one step fields on vs off: launches (on, off) {moved}, loss {loss_on:.4f} vs "
                f"{loss_off:.4f}, gradient norms within {worst:.2e}; ")

    def backbone_trainer(self, entry, cfg, dev_tree, kind: str):
        """(model, state, snapshot) as ``train_base_model`` (kind "full": AdamW +
        StepLR) or ``train_lora_adapter`` (kind "lora": rank 8 on the entry's
        targets, dropout 0.1, head trainable, Adam) build them."""
        if kind == "full":
            model, state = self.full_trainer(entry, cfg, dev_tree, TRAIN_STEPS)
            return model, state, lambda: None
        return self.loop.lora_trainer(entry, cfg, dev_tree, self.backbone_lora(entry, cfg),
                                      lr=1e-4, train_head=True, seed=0, device=self.dev)

    def backbone_lora(self, entry, cfg):
        """The LoRA of a phase 5 run: rank 8, alpha 16, dropout 0.1 on the entry's targets."""
        return self.lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg),
                                    dropout=0.1)

    def train_backbone(self, name: str, kind: str, fields: dict, tree, normalize,
                       per_step: dict) -> dict:
        """Phase 5 training of ``name`` (Swin-B, ConvNeXt-B, YOLO11-cls): a
        full fine-tune (augmentation on) or a LoRA run, with ``fields`` on,
        TRAIN_STEPS steps through ``fit``; ``per_step``: the launch count of
        every counter per step."""
        import torch

        trees = self.trees
        entry = self.registry.get_model(name)
        off = entry.config(CLASSES)
        cfg = dataclasses.replace(off, **fields)
        dev_tree = trees.map_leaves(lambda t: t.to(self.dev), tree)
        batch = self.train_batch(cfg.image_size)
        what = f"{name} {kind}" + (f" {'+'.join(fields)}" if fields else "")
        vs_off = ""
        if fields:
            def make(c):
                model, state, _ = self.backbone_trainer(entry, c, dev_tree, kind)
                return model, list(state.trainable)

            vs_off = self.one_step_vs_off(entry, cfg, off, make, normalize, batch, what)
            torch.cuda.empty_cache()
        model, state, snapshot = self.backbone_trainer(entry, cfg, dev_tree, kind)
        before = {n: p.detach().clone() for n, p in state.trainable.items()}
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if n not in state.trainable}
        check(not any(p.requires_grad for n, p in model.named_parameters() if n in frozen),
              f"{what}: a frozen parameter asks a gradient")
        ce0 = self.fixed_ce(entry, cfg, model, normalize, batch)
        _, launches = self.counted(self.all_counters(), lambda: self.fit_steps(
            entry, cfg, model, state, normalize, batch, TRAIN_STEPS, augment=kind == "full",
            snapshot=snapshot))
        want = {k: per_step.get(k, 0) * TRAIN_STEPS for k in launches}
        check(launches == want, f"{what}: kernel counts {launches} (want {want})")
        check(state.step == TRAIN_STEPS, f"{what}: update count {state.step}")
        for n, p_ in state.trainable.items():
            check(p_.dtype == torch.float32 and p_.grad is not None
                  and bool(torch.isfinite(p_.grad).all()), f"{what}: gradient of {n}")
            check(not torch.equal(before[n], p_), f"{what}: trainable leaf {n} did not change")
        named = dict(model.named_parameters())
        check(all(torch.equal(t, named[n]) for n, t in frozen.items()),
              f"{what}: training changed a frozen leaf")
        ce1 = self.fixed_ce(entry, cfg, model, normalize, batch)
        check(ce1 < ce0, f"{what}: CE on the fixed batch {ce0} -> {ce1}")
        adapter = ""
        if kind == "lora":
            trained = snapshot()
            e_m = self.adapter_round_trip(name, entry, cfg, off, model, dev_tree, trained,
                                          self.backbone_lora(entry, cfg), batch, normalize)
            nested = "w" not in trained["head"]
            adapter = (f"adapter + {'nested head (framework_head.*)' if nested else 'head'} "
                       f"through the PEFT writer/reader byte-equal, merged into the base vs the "
                       f"unmerged model max|err| {e_m:.3e}; ")
        print(f"phase 5 train: {what}, f32 params bf16 compute, B={BATCH}, {TRAIN_STEPS} steps "
              f"through fit ({'AdamW + StepLR, augmentation on' if kind == 'full' else 'rank 8, '
              'dropout 0.1, head trainable, Adam'}): CE on the fixed batch {ce0:.4f} -> "
              f"{ce1:.4f}; {len(before)} trainable leaves all changed, gradients finite, "
              f"{len(frozen)} frozen leaves bitwise unchanged; {vs_off}{adapter}kernel launches "
              f"{ {k: v for k, v in launches.items() if v} or 'none'}", flush=True)
        del model, state, frozen, before
        torch.cuda.empty_cache()
        return launches

    def train_step_call(self, name: str, kind: str, fields: dict, tree, normalize):
        """One training step of a phase 5 run on a model and state of its own."""
        import torch

        entry = self.registry.get_model(name)
        cfg = dataclasses.replace(entry.config(CLASSES), **fields)
        dev_tree = self.trees.map_leaves(lambda t: t.to(self.dev), tree)
        images, labels, valid = self.on_device(self.train_batch(cfg.image_size))
        model, state, _ = self.backbone_trainer(entry, cfg, dev_tree, kind)
        gen = torch.Generator(self.dev).manual_seed(17)
        step = self.steps.make_train_step(
            lambda m, x: entry.apply(cfg, m, x), model, normalize=normalize,
            generator=gen if kind == "full" else None,
            augment=self.augment.train_augment if kind == "full" else None)
        model.train()
        return lambda: step(state, images, labels, valid)

    def time_backbone_training(self, trees_by_name: dict, norms: dict) -> None:
        """ms per step of each phase 5 run: 3 steps after a warm-up, CUDA events."""
        import torch

        for name, kind, fields in TRAIN_RUNS:
            call = self.train_step_call(name, kind, fields, trees_by_name[name], norms[name])
            ms = cuda_ms(call, 3)
            print(f"phase 6 training {name} {kind}"
                  + (f" {'+'.join(fields)}" if fields else " fields off")
                  + f", f32 params bf16 compute B={BATCH}: {ms:.2f} ms/step, "
                  f"{BATCH * 1000 / ms:.2f} images/s {self.card}", flush=True)
            del call
            torch.cuda.empty_cache()

    def adapter_round_trip(self, name, entry, cfg, off, model, dev_tree, trained, lcfg, batch,
                           normalize) -> float:
        """The trained adapter and head (``trained``, a LoRA trainer's snapshot)
        through the PEFT writer and reader, byte-equal; merged into the base and
        built with the fields off (``off``) against the unmerged ``model``, at
        the backbone's bf16 logit limit. Returns that max |err|."""
        import torch

        trees = self.trees
        out_dir = os.path.join(self.build_mod.build_dir(), f"chip_smoke_{name}_trained_adapter")
        self.peft_io.save_peft_adapter(trained["adapter"], lcfg, out_dir, head=trained["head"])
        got, got_cfg, got_head = self.peft_io.load_peft_adapter(out_dir)
        check(set(got) == set(lcfg.targets) and got_cfg.rank == 8 and got_cfg.dropout == 0.1,
              f"{name} trained adapter: paths or config changed")
        fh, fg = trees.flatten_with_paths(trained["head"]), trees.flatten_with_paths(got_head)
        check(all(torch.equal(got[p][k], trained["adapter"][p][k]) for p in got for k in "ab")
              and set(fg) == set(fh) and all(torch.equal(fg[k], fh[k]) for k in fh),
              f"{name} trained adapter round trip is not byte-equal")
        put = lambda t: t.to(self.dev)  # noqa: E731
        merged = dict(self.lora.merge(dev_tree, {p: {k: put(v) for k, v in f.items()}
                                                 for p, f in got.items()}, got_cfg))
        merged["head"] = trees.map_leaves(put, got_head)
        x8 = normalize(self.common.to_unit_floats(self.on_device(batch)[0][:8]))
        with torch.no_grad():
            la, lr = LOGIT_TOL[name]["bfloat16"]
            return close(entry.apply(off, entry.from_tree(merged, off), x8),
                         entry.apply(cfg, model, x8), la, lr,
                         f"{name}: merged trained adapter vs the unmerged model")

    def attention_auto_entry(self) -> dict:
        """The head-major kernel through its entry point, forward and backward."""
        import torch

        ka = self.ka
        b, n, h, hd = MAIN
        q, k, v = (torch.randn(b, h, n, hd, device=self.dev, generator=self.gen)
                   .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
        do = torch.randn(b, h, n, hd, device=self.dev, generator=self.gen).to(torch.bfloat16)
        counters = {"fwd": (ka, "BHND_FWD_LAUNCHES"), "bwd": (ka, "BHND_BWD_LAUNCHES")}
        grads, launches = self.counted(counters, lambda: torch.autograd.grad(
            ka.attention_auto(q, k, v), (q, k, v), do))
        check(launches == {"fwd": 1, "bwd": 1}, f"attention_auto launches {launches}")
        check(all(torch.equal(g_, w_) for g_, w_ in
                  zip(grads, ka.fused_attention_bwd(q.detach(), k.detach(), v.detach(), do))),
              "attention_auto's gradient is not the backward kernel's")
        print(f"phase 5 attention_auto {(b, h, n, hd)} bf16: forward and backward through the "
              f"head-major kernel, launches {launches}", flush=True)
        return launches

    # 5. the other attack families on ViT-B/16
    def counting_apply(self, entry):
        """``entry.apply`` that counts its calls: every call is one forward
        pass, and a call whose input asks a gradient is one the attack
        differentiates (one backward pass follows)."""
        import torch

        def apply(cfg, model, images):
            apply.calls["fwd"] += 1
            apply.calls["grad"] += int(torch.is_grad_enabled() and images.requires_grad)
            return entry.apply(cfg, model, images)

        apply.calls = {"fwd": 0, "grad": 0}
        return apply

    def family_run(self, entry, depth: int, fn):
        """``fn(apply)`` with a counting apply and every ViT count set to 0
        just before and read just after; checks that the packed-attention
        kernel ran ``depth`` times per forward and per backward pass and no
        other kernel or parameter gradient ran. Returns (output, calls,
        seconds)."""
        apply = self.counting_apply(entry)
        t0 = time.perf_counter()
        out, launches = self.counted(self.vit_counters(), lambda: fn(apply))
        seconds = time.perf_counter() - t0
        calls = apply.calls
        want = {k: 0 for k in launches}
        want.update(packed_fwd=depth * calls["fwd"], packed_bwd=depth * calls["grad"])
        check(launches == want, f"kernel counts {launches} for {calls} model calls (want {want})")
        return out, calls, seconds

    def patch_family(self, entry, cfg, model, normalize, x_u8, labels) -> dict:
        """EOT patch at ``PatchConfig()`` (P 24, 500 iterations, B 16, lr 5),
        circle and square from one seed on a 64-image training subset, then
        applied at scale U(0.1, 0.5) to the batch."""
        import torch

        pm = self.patch_mod
        pcfg = pm.PatchConfig()
        images = self.common.to_unit_floats(x_u8)
        out = {}
        for shape in ("circle", "square"):
            mask = pm.patch_mask(dataclasses.replace(pcfg, shape=shape))
            (patch, losses), calls, secs = self.family_run(
                entry, cfg.depth, lambda a: pm.make_train_patch(a, cfg, pcfg, normalize=normalize)(
                    model, images, labels, torch.Generator(self.dev).manual_seed(0), mask))
            check(calls == {"fwd": pcfg.iters, "grad": pcfg.iters},
                  f"patch {shape}: model calls {calls}")
            check(patch.shape == (pcfg.patch_size, pcfg.patch_size, 3)
                  and bool(torch.isfinite(patch).all())
                  and float(patch.min()) >= 0 and float(patch.max()) <= 1,
                  f"patch {shape}: shape, finiteness or range")
            first, last = float(losses[:25].mean()), float(losses[-25:].mean())
            check(bool(torch.isfinite(losses).all()) and last < first,
                  f"patch {shape}: the loss (-CE) did not fall: {first} -> {last}")
            gen = torch.Generator(self.dev).manual_seed(1)
            scale = torch.empty((), device=self.dev).uniform_(0.1, 0.5, generator=gen)
            state = gen.get_state()
            adv, a_calls, _ = self.family_run(entry, cfg.depth, lambda a: pm.make_apply_patch(
                pcfg)(x_u8, patch, gen, scale, mask))
            check(a_calls == {"fwd": 0, "grad": 0}, "patch application called the model")
            check(bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                  and float(adv.max()) <= 1, f"patch {shape} application: range")
            gen.set_state(state)
            eot = pm.apply_eot(gen, BATCH, pcfg, cfg.image_size, scale, self.dev)
            foot = footprint(eot, cfg.image_size, pcfg.patch_size)
            check(torch.equal(adv[~foot], images[~foot]),
                  f"patch {shape}: a pixel outside the footprint changed")
            changed = float((adv != images).any(-1).float().mean())
            print(f"phase 5 patch: google_vit {shape} P=24, {pcfg.iters} iterations B=16 lr 5 on "
                  f"{len(labels)} images: loss (-CE) first 25 {first:.4f} -> last 25 {last:.4f}, "
                  f"{secs:.2f} s ({secs * 1000 / pcfg.iters:.2f} ms/iteration); applied at scale "
                  f"{float(scale):.3f} to B={BATCH}: {changed:.4f} of pixels changed, none outside "
                  f"the footprint; packed-attention launches {cfg.depth * calls['fwd']} + "
                  f"{cfg.depth * calls['grad']}, 0 for the application, 0 parameter gradients",
                  flush=True)
            out[shape] = secs * 1000 / pcfg.iters
        return out

    def rp2_family(self, entry, cfg, model, normalize, x_u8, logits) -> None:
        """RP2 with ``rp2_config(iters=100)`` on 3 classes (the batch's 3 most
        likely on average, each image labelled with one in turn), applied by
        label."""
        import numpy as np
        import torch

        rp2 = self.rp2_mod
        pcfg = rp2.rp2_config(iters=100)
        classes = [int(c) for c in logits.float().mean(0).argsort(descending=True)[:3]]
        labels = np.array([classes[i % 3] for i in range(BATCH)], np.int64)
        images = self.common.to_unit_floats(x_u8)
        lines = []
        patches, calls, secs = self.family_run(entry, cfg.depth, lambda a: rp2.train_rp2_patches(
            a, cfg, model, images.cpu().numpy(), labels, device=self.dev, cfg=pcfg,
            normalize=normalize, log=lines.append))
        iters = 3 * pcfg.iters
        check(sorted(patches) == sorted(classes) and calls == {"fwd": iters, "grad": iters},
              f"rp2: classes {sorted(patches)}, model calls {calls}")
        p = pcfg.patch_size
        stack = torch.zeros(logits.shape[-1], p, p, 3, device=self.dev)
        for c, patch in patches.items():
            stack[c] = torch.from_numpy(patch).to(self.dev)
        lab = torch.from_numpy(labels).to(self.dev)
        adv, a_calls, _ = self.family_run(
            entry, cfg.depth, lambda a: rp2.make_sign_constrained_apply(pcfg)(
                x_u8, stack[lab], torch.Generator(self.dev).manual_seed(2), pcfg.scale_max))
        outside = (rp2.sign_mask(cfg.image_size)[..., 0] == 0).to(self.dev)
        check(a_calls == {"fwd": 0, "grad": 0} and bool(torch.isfinite(adv).all())
              and float(adv.min()) >= 0 and float(adv.max()) <= 1,
              "rp2 application: model calls, finiteness or range")
        check(torch.equal(adv[:, outside], images[:, outside]),
              "rp2: a pixel outside the sign mask changed")
        counts = [int((labels == c).sum()) for c in classes]
        print(f"phase 5 rp2: google_vit classes {classes}, {pcfg.iters} iterations each (B=16, "
              f"lr 0.1, P={p}, {counts} images padded to {max(counts)}): {'; '.join(lines)}; "
              f"{secs:.2f} s; applied by label to B={BATCH}: no pixel outside the sign mask "
              f"changed; packed-attention launches {cfg.depth * calls['fwd']} + "
              f"{cfg.depth * calls['grad']}", flush=True)

    def autoattack_family(self, entry, cfg, model, normalize, x_u8, labels):
        """The standard suite at the CLI's defaults on the batch, labelled by
        the model's own clean predictions. Returns (stats, seconds)."""
        import torch

        aa = self.aa
        acfg = aa.AutoAttackConfig(n_iter=AA_N_ITER, square_queries=AA_QUERIES)
        images = self.common.to_unit_floats(x_u8)
        clean = aa.robust_accuracy(entry.apply, cfg, model, images, labels, normalize=normalize)
        check(clean == 1.0, f"autoattack: clean accuracy on the model's own labels {clean}")
        suite = {}

        def run(apply):
            suite["run"] = aa.make_autoattack(apply, cfg, acfg, normalize=normalize)
            return suite["run"](model, x_u8, labels, torch.Generator(self.dev).manual_seed(3))

        adv, calls, secs = self.family_run(entry, cfg.depth, run)
        stats = suite["run"].stats
        check(bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
              and float(adv.max()) <= 1, "autoattack: finiteness or range")
        check(float((adv - images).abs().max()) <= acfg.eps + 1e-6,
              "autoattack: outside the eps-ball")
        robust = aa.robust_accuracy(entry.apply, cfg, model, adv, labels, normalize=normalize)
        check(robust <= clean, f"autoattack: robust accuracy {robust} > clean {clean}")
        ran = [name for name, _ in stats]
        check(ran == list(acfg.attacks[:len(ran)]) and len(ran) >= 1
              and all(len(ts) == 1 for ts in stats.values()),
              f"autoattack: stats {stats} for the stages that ran")
        per_stage = ", ".join(f"{name} on {bucket} survivors {ts[0]:.2f} s"
                              for (name, bucket), ts in stats.items())
        print(f"phase 5 autoattack: google_vit standard suite eps {acfg.eps} n_iter {acfg.n_iter} "
              f"{acfg.n_target_classes} targets {acfg.square_queries} Square queries, B={BATCH} "
              f"on the model's own labels: clean accuracy {clean:.4f} -> robust {robust:.4f}; "
              f"{per_stage}; {secs:.2f} s; model calls {calls}, packed-attention launches "
              f"{cfg.depth * calls['fwd']} + {cfg.depth * calls['grad']}, 0 parameter gradients",
              flush=True)
        return stats, secs

    def autoattack_stages(self, entry, cfg, model, normalize, x_u8, labels) -> None:
        """APGD-T, FAB-T and Square each alone on the batch at a cut budget
        (``STAGE_N_ITER`` iterations, ``STAGE_TARGETS`` targets,
        ``STAGE_QUERIES`` queries): the suite stops at the first stage that
        breaks every example, so these run here whatever APGD-CE did."""
        import torch

        aa = self.aa
        images = self.common.to_unit_floats(x_u8)
        eps = aa.AutoAttackConfig().eps
        stages = {
            "apgd-t": (lambda a: aa.make_apgd_targeted(a, cfg, aa.APGDConfig(
                eps=eps, n_iter=STAGE_N_ITER, n_target_classes=STAGE_TARGETS),
                normalize=normalize)(model, x_u8, labels, torch.Generator(self.dev).manual_seed(6)),
                {"fwd": 1 + STAGE_TARGETS * (STAGE_N_ITER + 3),
                 "grad": STAGE_TARGETS * (STAGE_N_ITER + 2)}),
            "fab-t": (lambda a: aa.make_fab_targeted(a, cfg, aa.FABConfig(
                eps=eps, n_iter=STAGE_N_ITER, n_target_classes=STAGE_TARGETS),
                normalize=normalize)(model, x_u8, labels),
                {"fwd": 1 + 2 * STAGE_TARGETS * STAGE_N_ITER,
                 "grad": STAGE_TARGETS * STAGE_N_ITER}),
            "square": (lambda a: aa.make_square(a, cfg, aa.SquareConfig(
                eps=eps, n_queries=STAGE_QUERIES), normalize=normalize)(
                model, x_u8, labels, torch.Generator(self.dev).manual_seed(7)), None),
        }
        for name, (fn, want_calls) in stages.items():
            adv, calls, secs = self.family_run(entry, cfg.depth, fn)
            if want_calls is not None:
                check(calls == want_calls, f"{name}: model calls {calls} (want {want_calls})")
            check(calls["fwd"] >= 2 and (name != "square" or calls["grad"] == 0),
                  f"{name}: model calls {calls}")
            check(bool(torch.isfinite(adv).all()) and float(adv.min()) >= 0
                  and float(adv.max()) <= 1 and float((adv - images).abs().max()) <= eps + 1e-6,
                  f"{name}: finiteness, range or eps-ball")
            robust = aa.robust_accuracy(entry.apply, cfg, model, adv, labels, normalize=normalize)
            print(f"phase 5 autoattack stage: google_vit {name} alone, B={BATCH}, eps {eps}: "
                  f"robust accuracy {robust:.4f}, {secs:.2f} s, model calls {calls}, "
                  f"packed-attention launches {cfg.depth * calls['fwd']} + "
                  f"{cfg.depth * calls['grad']}", flush=True)

    def time_families(self, entry, cfg, model, normalize, x_u8, labels, patch_ms, aa_out) -> None:
        """Phase 6 for the attack families: the patch iteration (from phase
        5), an APGD-CE iteration and Square queries at B=64 by CUDA events,
        the suite's wall (from phase 5)."""
        import torch

        aa = self.aa
        images = self.common.to_unit_floats(x_u8)
        n_iter = 20
        apgd = aa.make_apgd(entry.apply, cfg, aa.APGDConfig(eps=0.031, n_iter=n_iter),
                            normalize=normalize)
        apgd_ms = cuda_ms(lambda: apgd(model, images, labels,
                                       torch.Generator(self.dev).manual_seed(4)), 2)
        queries = 200
        square = aa.make_square(entry.apply, cfg,
                                aa.SquareConfig(eps=0.031, n_queries=queries,
                                                exit_check_every=queries), normalize=normalize)
        sq_ms = cuda_ms(lambda: square(model, images, labels,
                                       torch.Generator(self.dev).manual_seed(5)), 2)
        stats, secs = aa_out
        print(f"phase 6 patch training google_vit+LoRA bf16 B=16 P=24: "
              + ", ".join(f"{k} {v:.2f} ms/iteration" for k, v in patch_ms.items())
              + f" (host clock over 500 iterations) {self.card}", flush=True)
        print(f"phase 6 APGD-CE google_vit+LoRA bf16 B={BATCH}: {apgd_ms / (n_iter + 2):.2f} ms "
              f"per iteration (one call of {n_iter} iterations + 2 start steps: {apgd_ms:.2f} ms) "
              f"{self.card}", flush=True)
        print(f"phase 6 Square google_vit+LoRA bf16 B={BATCH}: {queries * 1000 / sq_ms:.2f} "
              f"queries/s ({queries} queries in {sq_ms:.2f} ms) {self.card}", flush=True)
        print(f"phase 6 AutoAttack standard suite google_vit+LoRA bf16 B={BATCH}: wall {secs:.2f} "
              f"s, {BATCH / secs:.2f} images/s; kernels built in phase 2, so each stage's first "
              f"call is warm {self.card}", flush=True)

    # 6. timing
    def time_attention(self, vit_l) -> list[dict]:
        """Packed attention at the ViT-B/16 shape: kernel, plain, bound, SDPA."""
        import torch
        import torch.nn.functional as F

        ka = self.ka
        b, n, h, hd = MAIN
        q, k, v, do = (torch.randn(b, n, h * hd, device=self.dev, generator=self.gen)
                       .to(torch.bfloat16) for _ in range(4))
        # the one library call: SDPA on (B, H, N, hd) views of the packed operands
        qh, kh, vh = (t.view(b, n, h, hd).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        doh = do.view(b, n, h, hd).transpose(1, 2)
        out = F.scaled_dot_product_attention(qh, kh, vh)
        # the backward as autograd calls it: with the forward's output and log-sum-exp
        o, lse = ka.fused_attention_packed_fwd(q, k, v, h, with_lse=True)
        kf, pf, lf = turns(lambda: ka.fused_attention_packed_fwd(q, k, v, h),
                           lambda: ka.attention_packed_reference(q, k, v, h),
                           library=lambda: F.scaled_dot_product_attention(qh, kh, vh))
        kb, pb, lb = turns(lambda: ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse),
                           lambda: ka.attention_packed_bwd_reference(q, k, v, do, h),
                           library=lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                               retain_graph=True))
        unit = b * h * n * n * hd
        tensor = b * n * h * hd * 2
        bf, bf_by = bound_ms(4 * unit, 4 * tensor, PEAK_BF16)
        bb, bb_by = bound_ms(10 * unit, 7 * tensor, PEAK_BF16)
        print(f"phase 6 attention_packed {MAIN} bf16: kernel fwd {kf:.4f} ms bwd {kb:.4f} ms; "
              f"plain fwd {pf:.4f} ms bwd {pb:.4f} ms; SDPA (in turns with the kernel, best of "
              f"3) fwd {lf:.4f} ms bwd {lb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} "
              f"ms ({bb_by}) {self.card}", flush=True)
        src = f"{PKG}/csrc/attention_packed.cu"
        return [
            {"name": "attention_packed_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:230", "launches": vit_l["fwd"],
             "ms": kf, "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by, "library_ms": lf},
            {"name": "attention_packed_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:238", "launches": vit_l["bwd"],
             "ms": kb, "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by, "library_ms": lb}]

    def time_window(self, swin_l) -> list[dict]:
        """Window attention at Swin-B stages 1 and 3 under three masks: the
        kernel, the mma.sync kernel it replaces and (shift mask) SDPA with
        bias + mask as ``attn_mask``, in turns, best of 3; the plain version;
        the bound."""
        import torch
        import torch.nn.functional as F

        kw = self.kw
        rows = {}
        for label, shape in WIN_TIMED.items():
            for mask_kind in WIN_MASKS:
                qkv, bias, mask, wdo, wh = self.window_operands(shape, mask_kind, torch.bfloat16)
                b, nw, n, _ = qkv.shape
                hd, c = 32, wh * 32
                fwd = {"kernel": lambda: kw.fused_window_attention_fwd(qkv, bias, mask, wh),
                       "mma_sync": lambda: kw.mma_sync_fwd(qkv, bias, mask, wh)}
                bwd = {"kernel": lambda: kw.fused_window_attention_bwd(qkv, bias, mask, wdo, wh),
                       "mma_sync": lambda: kw.mma_sync_bwd(qkv, bias, mask, wdo, wh)}
                if mask_kind == "shift":
                    # every (window, head) pair as one SDPA head: (B, nW*h, n, hd),
                    # bias + mask as one additive mask shared by the batch
                    qh, kh, vh = (t.reshape(b, nw * wh, n, hd).detach().requires_grad_(True)
                                  for t in kw._heads(qkv, wh))
                    doh = wdo.view(b, nw, n, wh, hd).transpose(2, 3).reshape(b, nw * wh, n, hd)
                    am = (bias[None] + mask[:, None]).reshape(1, nw * wh, n, n).to(torch.bfloat16)
                    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
                    fwd["sdpa"] = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am)
                    bwd["sdpa"] = lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                              retain_graph=True)
                tf, tb = rivals(fwd), rivals(bwd)
                pf = cuda_ms(lambda: kw.window_attention_reference(qkv, bias, mask, wh), 5)
                pb = cuda_ms(lambda: kw.window_attention_bwd_reference(qkv, bias, mask, wdo, wh), 5)
                unit = b * nw * wh * n * n * hd
                side = (bias.numel() + mask.numel()) * 4
                bf, bf_by = bound_ms(4 * unit, b * nw * n * 4 * c * 2 + side, PEAK_BF16)
                bb, bb_by = bound_ms(10 * unit, b * nw * n * 7 * c * 2 + side, PEAK_BF16)
                line = (f"phase 6 window_attention {label} {tuple(qkv.shape)} h{wh} {mask_kind} "
                        f"mask bf16 [{kw.kernel_variant(qkv.dtype, n, wh)}]: kernel fwd "
                        f"{tf['kernel']:.4f} ms bwd {tb['kernel']:.4f} ms; the mma.sync kernel "
                        f"it replaces fwd {tf['mma_sync']:.4f} ms bwd {tb['mma_sync']:.4f} ms "
                        f"({tf['mma_sync'] / tf['kernel']:.2f}x / "
                        f"{tb['mma_sync'] / tb['kernel']:.2f}x); plain fwd {pf:.4f} ms bwd "
                        f"{pb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} ms ({bb_by})")
                if mask_kind == "shift":
                    rows[label] = (tf["kernel"], pf, tb["kernel"], pb, tf["sdpa"], tb["sdpa"], bf,
                                   bf_by, bb, bb_by)
                    line += f"; SDPA fwd {tf['sdpa']:.4f} ms bwd {tb['sdpa']:.4f} ms"
                print(f"{line}; in turns, best of 3 {self.card}", flush=True)
        wkf, wpf, wkb, wpb, lf, lb, bf, bf_by, bb, bb_by = rows["stage 3"]
        src = f"{PKG}/csrc/window_attention.cu"
        return [
            {"name": "window_attention_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/window_attention.py:140", "launches": swin_l["fwd"],
             "ms": wkf, "plain_ms": wpf, "bound_ms": bf, "bound_by": bf_by, "library_ms": lf},
            {"name": "window_attention_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/window_attention.py:159", "launches": swin_l["bwd"],
             "ms": wkb, "plain_ms": wpb, "bound_ms": bb, "bound_by": bb_by, "library_ms": lb}]

    def time_dwconv(self, cnx_l) -> list[dict]:
        """dwconv7 at the four ConvNeXt-B stage shapes in both roles: the
        kernel, the staged kernel it replaces and ``F.conv2d(groups=C)`` in
        bf16 on the channels-last view (for dx the same conv with the flipped
        filter), in turns, best of 3, device time by :func:`graph_ms` (at
        stage 4 an eager call's host work takes longer than the kernel); the
        plain version; the f32 FMA bound and the byte bound."""
        import torch
        import torch.nn.functional as F

        kd, rows = self.kd, {}
        for stage, shape in enumerate(DW_SHAPES[:4], 1):
            x, w, g = self.dwconv_operands(shape, torch.bfloat16)
            w = w.to(torch.bfloat16)  # as the attack path holds it; the library call gets the same
            c = shape[-1]
            wf = w.permute(2, 0, 1).reshape(c, 1, 7, 7)
            wflip = w.flip(0, 1).permute(2, 0, 1).reshape(c, 1, 7, 7)
            x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels-last NCHW views
            tf = rivals({"kernel": lambda: kd.fused_dwconv7_fwd(x, w),
                         "staged": lambda: kd.staged_fwd(x, w),
                         "library": lambda: F.conv2d(x_cl, wf, None, 1, 3, 1, c)},
                        timer=graph_ms)
            tb = rivals({"kernel": lambda: kd.fused_dwconv7_dx(g, w),
                         "staged": lambda: kd.staged_dx(g, w),
                         "library": lambda: F.conv2d(g_cl, wflip, None, 1, 3, 1, c)},
                        timer=graph_ms)
            eager = cuda_ms(lambda: kd.fused_dwconv7_fwd(x, w), 20)
            pf = cuda_ms(lambda: kd.dwconv7_reference(x, w), 5)
            n_out = x.numel()
            nbytes = 2 * n_out * x.element_size() + w.numel() * w.element_size()
            bound, by = bound_ms(2 * 49 * n_out, nbytes, PEAK_F32)
            t_ops, t_bytes = 2 * 49 * n_out / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
            rows[stage] = (tf, tb, pf, bound, by)
            variant = kd.kernel_variant(x.dtype, shape)
            print(f"phase 6 dwconv7 stage {stage} {shape} bf16 [{variant}]: kernel fwd "
                  f"{tf['kernel']:.4f} ms dx {tb['kernel']:.4f} ms; the staged "
                  f"kernel it replaces fwd {tf['staged']:.4f} ms dx {tb['staged']:.4f} ms "
                  f"({tf['staged'] / tf['kernel']:.2f}x / {tb['staged'] / tb['kernel']:.2f}x); "
                  f"library F.conv2d(groups=C) bf16 channels_last fwd {tf['library']:.4f} ms dx "
                  f"(flipped filter) {tb['library']:.4f} ms; in turns, best of 3, device time "
                  f"(CUDA-graph replay; the kernel's fwd called eagerly, host included: "
                  f"{eager:.4f} ms); plain (f32 "
                  f"F.conv2d) {pf:.4f} ms; bound {bound:.4f} ms ({by}: f32 FMA {t_ops:.4f} ms, "
                  f"bytes {t_bytes:.4f} ms); kernel at {bound / tf['kernel']:.1%} / "
                  f"{bound / tb['kernel']:.1%} of the bound {self.card}", flush=True)
        tf, tb, pf, bound, by = rows[3]
        src = f"{PKG}/csrc/dwconv7.cu"
        return [
            {"name": "dwconv7_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/dwconv.py:128", "launches": cnx_l["dw_fwd"],
             "ms": tf["kernel"], "plain_ms": pf, "bound_ms": bound, "bound_by": by,
             "library_ms": tf["library"]},
            {"name": "dwconv7_dx", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/dwconv.py:155", "launches": cnx_l["dw_dx"],
             "ms": tb["kernel"], "plain_ms": pf, "bound_ms": bound, "bound_by": by,
             "library_ms": tb["library"]}]

    def time_mlp(self, cnx_l) -> list[dict]:
        """The LN-fused MLP at the four ConvNeXt-B stage shapes and the ViT-B
        shape: kernels, plain, bound, and the bf16 library composition
        (``F.layer_norm`` -> ``F.linear`` -> ``F.gelu`` -> ``F.linear``; no one
        PyTorch call computes the function)."""
        import torch
        import torch.nn.functional as F

        km, eps, rows = self.km, 1e-6, {}
        for stage, shape in enumerate(MLP_SHAPES[:5], 1):
            t, d, m = shape
            x, dy, p = self.mlp_operands(shape)
            # weights in bf16, as the attack path holds them (no cast inside the timed calls)
            p["w1"], p["w2"] = p["w1"].to(torch.bfloat16), p["w2"].to(torch.bfloat16)
            args = (p["ln_scale"], p["ln_bias"], p["w1"], p["b1"], p["w2"])
            w1t, w2t = p["w1"].t(), p["w2"].t()
            b1h, b2h = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)

            def library(xi):
                hn = F.layer_norm(xi.float(), (d,), p["ln_scale"], p["ln_bias"], eps).to(xi.dtype)
                return F.linear(F.gelu(F.linear(hn, w1t, b1h)), w2t, b2h)

            xg = x.detach().requires_grad_(True)
            y = library(xg)
            kf, pf, cf = turns(lambda: km.fused_ln_mlp_fwd(x, *args, p["b2"], eps),
                               lambda: km.ln_mlp_reference(x, *args, p["b2"], eps), 10,
                               library=lambda: library(x))
            kb, pb, cb = turns(lambda: km.fused_ln_mlp_bwd(x, *args, dy, eps),
                               lambda: km.ln_mlp_bwd_reference(x, *args, dy, eps), 10,
                               library=lambda: torch.autograd.grad(y, xg, dy, retain_graph=True))
            del y
            weights = 2 * d * m * 2
            bf, bf_by = bound_ms(4 * t * d * m, 2 * t * d * 2 + weights, PEAK_BF16)
            bb, bb_by = bound_ms(6 * t * d * m, 3 * t * d * 2 + weights, PEAK_BF16)
            rows[stage] = (kf, kb, pf, pb, bf, bf_by, bb, bb_by, cf, cb)
            label = f"stage {stage}" if stage <= 4 else "ViT-B shape"
            print(f"phase 6 ln_mlp {label} {shape} bf16: kernel fwd {kf:.4f} ms bwd {kb:.4f} "
                  f"ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms; library composition (no single "
                  f"call; in turns with the kernel, best of 3) fwd {cf:.4f} ms bwd {cb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd "
                  f"{bb:.4f} ms ({bb_by}); kernel at {4e-9 * t * d * m / kf:.1f} / "
                  f"{6e-9 * t * d * m / kb:.1f} TFLOP/s {self.card}", flush=True)
        kf, kb, pf, pb, bf, bf_by, bb, bb_by, cf, cb = rows[3]
        src = f"{PKG}/csrc/ln_mlp.cu"
        return [
            {"name": "ln_mlp_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/mlp.py:247", "launches": cnx_l["mlp_fwd"],
             "ms": kf, "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by, "library_ms": None,
             "composition_ms": cf},
            {"name": "ln_mlp_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/mlp.py:255", "launches": cnx_l["mlp_bwd"],
             "ms": kb, "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by, "library_ms": None,
             "composition_ms": cb}]

    def time_fused_mlp(self, launches) -> list[dict]:
        """The fused MLP without LayerNorm at the ViT-B shape: kernels, plain,
        bound, and the bf16 library composition (``F.linear`` -> ``F.gelu`` ->
        ``F.linear``; no one PyTorch call computes the function)."""
        import torch
        import torch.nn.functional as F

        km = self.km
        t, d, m = shape = FMLP_SHAPES[0]
        x, dy, p = self.mlp_operands(shape)
        p["w1"], p["w2"] = p["w1"].to(torch.bfloat16), p["w2"].to(torch.bfloat16)
        w1t, w2t = p["w1"].t(), p["w2"].t()
        b1h, b2h = p["b1"].to(torch.bfloat16), p["b2"].to(torch.bfloat16)
        library = lambda xi: F.linear(F.gelu(F.linear(xi, w1t, b1h)), w2t, b2h)
        xg = x.detach().requires_grad_(True)
        y = library(xg)
        kf, pf, cf = turns(lambda: km.fused_mlp_fwd(x, p["w1"], p["b1"], p["w2"], p["b2"]),
                           lambda: km.mlp_reference(x, p["w1"], p["b1"], p["w2"], p["b2"]), 10,
                           library=lambda: library(x))
        kb_, pb, cb = turns(lambda: km.fused_mlp_bwd(x, p["w1"], p["b1"], p["w2"], dy),
                            lambda: km.mlp_bwd_reference(x, p["w1"], p["b1"], p["w2"], dy), 10,
                            library=lambda: torch.autograd.grad(y, xg, dy, retain_graph=True))
        del y
        weights = 2 * d * m * 2
        bf, bf_by = bound_ms(4 * t * d * m, 2 * t * d * 2 + weights, PEAK_BF16)
        bb, bb_by = bound_ms(6 * t * d * m, 3 * t * d * 2 + weights, PEAK_BF16)
        print(f"phase 6 fused_mlp ViT-B shape {shape} bf16: kernel fwd {kf:.4f} ms bwd {kb_:.4f} "
              f"ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms; library composition (no single call) "
              f"fwd {cf:.4f} ms bwd {cb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} ms "
              f"({bb_by}) {self.card}", flush=True)
        src = f"{PKG}/csrc/ln_mlp.cu"
        return [
            {"name": "fused_mlp_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/mlp.py:96", "launches": launches["mlp_fwd"],
             "ms": kf, "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by, "library_ms": None,
             "composition_ms": cf},
            {"name": "fused_mlp_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/mlp.py:102", "launches": launches["mlp_bwd"],
             "ms": kb_, "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by, "library_ms": None,
             "composition_ms": cb}]

    def time_attn_block(self, launches) -> list[dict]:
        """The attention half-block at the ViT-B shape: the kernels, the
        mma.sync kernels they replace and the bf16 library composition
        (``F.layer_norm`` -> 3 x ``F.linear`` -> SDPA -> ``F.linear``; no one
        PyTorch call computes the function) in turns, best of 3; the plain
        version; the bound."""
        import torch
        import torch.nn.functional as F

        kb, eps = self.kb, 1e-6
        b, n, c, h = shape = AB_SHAPES[0]
        x, dy, p = self.attn_block_operands(shape)
        for t in "qkvo":
            p[f"w{t}"] = p[f"w{t}"].to(torch.bfloat16)
        args = [p[k] for k in self.AB_ORDER]
        wt = {t: p[f"w{t}"].t() for t in "qkvo"}
        bh = {t: p[f"b{t}"].to(torch.bfloat16) for t in "qkvo"}

        def library(xi):
            hn = F.layer_norm(xi.float(), (c,), p["ln_scale"], p["ln_bias"], eps).to(xi.dtype)
            q, k, v = (F.linear(hn, wt[t], bh[t]).view(b, n, h, c // h).transpose(1, 2)
                       for t in "qkv")
            a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
            return F.linear(a, wt["o"], bh["o"])

        xg = x.detach().requires_grad_(True)
        y = library(xg)
        tf = rivals({"kernel": lambda: kb.fused_attn_block_fwd(x, *args, h, eps),
                     "mma_sync": lambda: kb.mma_sync_fwd(x, *args, h, eps),
                     "composition": lambda: library(x)}, 10)
        tb = rivals({"kernel": lambda: kb.fused_attn_block_bwd(x, *args[:-1], dy, h, eps),
                     "mma_sync": lambda: kb.mma_sync_bwd(x, *args[:-1], dy, h, eps),
                     "composition": lambda: torch.autograd.grad(y, xg, dy, retain_graph=True)}, 10)
        del y
        pf = cuda_ms(lambda: kb.attn_block_reference(x, *args, h, eps), 5)
        pb = cuda_ms(lambda: kb.attn_block_bwd_reference(x, *args[:-1], dy, h, eps), 5)
        side = 4 * c * c * 2 + 6 * c * 4
        bf, bf_by = bound_ms(b * (8 * n * c * c + 4 * n * n * c), 2 * b * n * c * 2 + side,
                             PEAK_BF16)
        bb, bb_by = bound_ms(b * (14 * n * c * c + 10 * n * n * c), 3 * b * n * c * 2 + side,
                             PEAK_BF16)
        print(f"phase 6 attn_block {shape[:3]} h{h} bf16 [{kb.kernel_variant(n, c, h)}]: kernel fwd "
              f"{tf['kernel']:.4f} ms bwd {tb['kernel']:.4f} ms; the mma.sync kernels they replace "
              f"fwd {tf['mma_sync']:.4f} ms bwd {tb['mma_sync']:.4f} ms "
              f"({tf['mma_sync'] / tf['kernel']:.2f}x / {tb['mma_sync'] / tb['kernel']:.2f}x); "
              f"library composition (no single call) fwd {tf['composition']:.4f} ms bwd "
              f"{tb['composition']:.4f} ms; in turns, best of 3; plain fwd {pf:.4f} ms bwd "
              f"{pb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} ms ({bb_by}) "
              f"{self.card}", flush=True)
        src = f"{PKG}/csrc/attn_block.cu"
        return [
            {"name": "attn_block_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attn_block.py:84", "launches": launches["attn_block_fwd"],
             "ms": tf["kernel"], "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by,
             "library_ms": None, "composition_ms": tf["composition"]},
            {"name": "attn_block_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attn_block.py:99", "launches": launches["attn_block_bwd"],
             "ms": tb["kernel"], "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by,
             "library_ms": None, "composition_ms": tb["composition"]}]

    def time_bhnd(self, launches) -> list[dict]:
        """Head-major attention at the ViT-B/16 shape: kernel, plain, bound, SDPA."""
        import torch
        import torch.nn.functional as F

        ka = self.ka
        b, n, h, hd = MAIN
        q, k, v, do = (torch.randn(b, h, n, hd, device=self.dev, generator=self.gen)
                       .to(torch.bfloat16) for _ in range(4))
        qh, kh, vh = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh)
        o, lse = ka.fused_attention_fwd(q, k, v, with_lse=True)
        kf, pf, lf = turns(lambda: ka.fused_attention_fwd(q, k, v),
                           lambda: ka.attention_reference(q, k, v),
                           library=lambda: F.scaled_dot_product_attention(qh, kh, vh))
        kb_, pb, lb = turns(lambda: ka.fused_attention_bwd(q, k, v, do, o, lse),
                            lambda: ka.attention_bwd_reference(q, k, v, do),
                            library=lambda: torch.autograd.grad(out, (qh, kh, vh), do,
                                                                retain_graph=True))
        unit, tensor = b * h * n * n * hd, b * n * h * hd * 2
        bf, bf_by = bound_ms(4 * unit, 4 * tensor, PEAK_BF16)
        bb, bb_by = bound_ms(10 * unit, 7 * tensor, PEAK_BF16)
        print(f"phase 6 fused_attention (B,H,N,hd) {(b, h, n, hd)} bf16: kernel fwd {kf:.4f} ms "
              f"bwd {kb_:.4f} ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms; SDPA fwd {lf:.4f} ms bwd "
              f"{lb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} ms ({bb_by}) "
              f"{self.card}", flush=True)
        src = f"{PKG}/csrc/attention_packed.cu"
        return [
            {"name": "fused_attention_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:85", "launches": launches["fwd"],
             "ms": kf, "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by, "library_ms": lf},
            {"name": "fused_attention_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:95", "launches": launches["bwd"],
             "ms": kb_, "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by, "library_ms": lb}]

    def time_vit_pgd(self, entry, cfg, model_tree, normalize, x, y) -> dict:
        """ViT-B PGD-10 images/s with each kernel field and none: two turns
        over the variants, the best of each; returns ``{label: ms}``."""
        import torch

        best = {}
        models = {label: (dataclasses.replace(cfg, **fields),
                          entry.from_tree(model_tree, dataclasses.replace(cfg, **fields)))
                  for label, fields in VIT_VARIANTS}
        for _ in range(2):
            for label, (vcfg, model) in models.items():
                pgd = self.make_pgd(entry, vcfg, normalize)
                ms = cuda_ms(lambda: pgd(model, x, y, torch.Generator(self.dev).manual_seed(2)), 2)
                best[label] = min(best.get(label, ms), ms)
        for label, ms in best.items():
            print(f"phase 6 PGD-{PGD_STEPS} google_vit+LoRA bf16 B={BATCH}, {label}: {ms:.2f} "
                  f"ms/batch, {BATCH * 1000 / ms:.2f} images/s {self.card}", flush=True)
        return best

    def train_callables(self, entry, tree, normalize, kind: str) -> dict:
        """``{label: one training step}`` for ``kind`` = "train" (full
        fine-tune, augmentation on; fields on = ``fuse_attn_block``) or
        "train_lora" (rank 8, dropout 0.1; fields on = ``use_fused_mlp``),
        each on a model and state of its own."""
        import torch

        off = entry.config(CLASSES)
        dev_tree = self.trees.map_leaves(lambda t: t.to(self.dev), tree)
        images, labels, valid = self.on_device(self.train_batch(off.image_size))
        on_fields = {"fuse_attn_block": True} if kind == "train" else {"use_fused_mlp": True}
        out = {}
        for label, fields in (("fields off", {}), (f"{next(iter(on_fields))} on", on_fields)):
            cfg = dataclasses.replace(off, **fields)
            if kind == "train":
                model, state = self.full_trainer(entry, cfg, dev_tree, 100)
                gen = torch.Generator(self.dev).manual_seed(17)
                step = self.steps.make_train_step(
                    lambda m, x, c=cfg: entry.apply(c, m, x), model, normalize=normalize,
                    generator=gen, augment=self.augment.train_augment)
            else:
                lcfg = self.lora.LoRAConfig(rank=8, alpha=16.0, targets=entry.lora_targets(cfg),
                                            dropout=0.1)
                model, state, _ = self.loop.lora_trainer(
                    entry, cfg, dev_tree, lcfg, lr=1e-4, train_head=True, seed=0, device=self.dev)
                step = self.steps.make_train_step(
                    lambda m, x, c=cfg: entry.apply(c, m, x), model, normalize=normalize)
            model.train()
            out[label] = lambda st=state, fn=step: fn(st, images, labels, valid)
        return out

    def time_training(self, entry, tree, normalize) -> None:
        """Training images/s, full fine-tune and LoRA, fields off and on: turns
        off-on-on-off of 3 steps after a warm-up, the best of each."""
        for kind, what in (("train", "full fine-tune, augmentation on"),
                           ("train_lora", "LoRA rank 8, dropout 0.1, head trainable")):
            calls = self.train_callables(entry, tree, normalize, kind)
            labels = list(calls)
            best = {}
            for label in (labels[0], labels[1], labels[1], labels[0]):
                ms = cuda_ms(calls[label], 3)
                best[label] = min(best.get(label, ms), ms)
            for label, ms in best.items():
                print(f"phase 6 training google_vit {what}, f32 params bf16 compute B={BATCH}, "
                      f"{label}: {ms:.2f} ms/step, {BATCH * 1000 / ms:.2f} images/s {self.card}",
                      flush=True)
            del calls

    def convnext_variants(self, entry, cfg, model_tree):
        """``{label: (cfg, model)}`` over one set of parameters: both kernel
        fields on, each alone, both off."""
        off = dataclasses.replace(cfg, **{f: False for f in CONVNEXT_KERNELS})
        out = {}
        for label, fields in CONVNEXT_VARIANTS:
            vcfg = dataclasses.replace(off, **fields)
            out[label] = (vcfg, entry.from_tree(model_tree, vcfg))
        return out

    def make_pgd(self, entry, cfg, normalize):
        return self.whitebox.make_pgd(entry.apply, cfg, eps=EPS, alpha=ALPHA, steps=PGD_STEPS,
                                      normalize=normalize)

    def time_convnext_pgd(self, entry, cfg, model_tree, normalize, x, y) -> None:
        """PGD-10 images/s with both kernel fields on, each alone, both off: two
        turns over the variants, the best of each."""
        import torch

        variants = self.convnext_variants(entry, cfg, model_tree)
        best = {}
        for _ in range(2):
            for label, (vcfg, model) in variants.items():
                pgd = self.make_pgd(entry, vcfg, normalize)
                ms = cuda_ms(lambda: pgd(model, x, y, torch.Generator(self.dev).manual_seed(2)), 2)
                best[label] = min(best.get(label, ms), ms)
        for label, ms in best.items():
            print(f"phase 6 PGD-{PGD_STEPS} convnext+LoRA bf16 B={BATCH}, {label}: {ms:.2f} "
                  f"ms/batch, {BATCH * 1000 / ms:.2f} images/s {self.card}", flush=True)

    # --profile
    # 7. the codec and the robustness study through the port's runner
    def codec(self) -> None:
        """The native PNG codec on this host: encode -> decode bit exact on
        random images, a PNG from a plain filter-0 writer decoded bit exact,
        resize + center crop within 2 LSB (mean < 0.5) of a plain version on
        the card; then the single-thread encode and fused decode rates."""
        import numpy as np

        nat = self.native
        rng = np.random.default_rng(7)
        for h, w in CODEC_SIZES:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            check(np.array_equal(nat.decode_png_rgb(nat.encode_png_rgb(img)), img),
                  f"codec: encode -> decode at {h}x{w}")
            check(np.array_equal(nat.decode_png_rgb(plain_png(img)), img),
                  f"codec: plain filter-0 PNG at {h}x{w}")
        worst = 0
        for h, w in CODEC_SIZES[:2] + CODEC_SIZES[3:]:
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for resize, crop in ((256, 224), (36, 32)):
                d = np.abs(nat.resize_center_crop(img, resize, crop).astype(int)
                           - plain_resize_center_crop(img, resize, crop, self.dev).astype(int))
                check(d.max() <= 2 and d.mean() < 0.5,
                      f"codec: resize {h}x{w} -> {resize} -> {crop}: max {d.max()}, mean {d.mean()}")
                worst = max(worst, int(d.max()))
        imgs = [self.synthetic._render_hard(i % 12, rng, 224) for i in range(CODEC_RATE_N)]
        t0 = time.perf_counter()
        pngs = [nat.encode_png_rgb(im) for im in imgs]
        enc = CODEC_RATE_N / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for data in pngs:
            nat.decode_png_resize_center_crop(data, 256, 224)
        dec = CODEC_RATE_N / (time.perf_counter() - t0)
        print(f"phase 7 codec: round trips bit exact at {len(CODEC_SIZES)} sizes, plain filter-0 "
              f"PNGs bit exact, resize vs F.interpolate(antialias) max {worst} LSB; host rates "
              f"(one thread, 224 px synthetic signs): encode {enc:.1f} images/s, decode + "
              f"resize 256 + crop 224 {dec:.1f} images/s ({np.mean([len(p) for p in pngs]):.0f} "
              f"bytes a PNG)", flush=True)

    def corpus_codec(self, data_dir: str, style: str) -> None:
        """The runner's synth-data PNGs hold the pixels rendered here again from
        the same seed (test split), and re-encode -> decode bit exact."""
        import numpy as np

        nat, synth = self.native, self.synthetic
        meta = self.data_io.read_metadata(os.path.join(data_dir, "test", "metadata.csv"))
        classes = synth.HARD_CLASSES if style == "hard" else synth.DEFAULT_CLASSES
        rng = np.random.default_rng((0, 2))  # make_synthetic_dataset's test-split stream
        size = None
        for i, path in enumerate(meta["image_path"]):
            with open(os.path.join(data_dir, "test", path), "rb") as f:
                got = nat.decode_png_rgb(f.read())
            size = got.shape[0]
            want = synth._render_hard(classes.index(meta["original_class"][i]), rng, size)
            check(np.array_equal(got, want), f"corpus PNG {path}: pixels differ from the render")
            check(np.array_equal(nat.decode_png_rgb(nat.encode_png_rgb(got)), got),
                  f"corpus PNG {path}: re-encode")
        print(f"phase 7 codec corpus: {len(meta)} test PNGs ({size} px) equal their render, "
              f"re-encoded bit exact", flush=True)

    def startup_seconds(self) -> float:
        """Wall of a fresh process that imports torch and the CLI and reaches
        the card: what each runner stage pays before its work."""
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device="
                        f"'{self.dev}'); import {PKG}.cli.main"], cwd=HERE, check=True,
                       timeout=RUNNER_STAGE_TIMEOUT_S)
        return time.perf_counter() - t0

    def runner(self, args=RUNNER_ARGS) -> None:
        """The study through ``tools/run_robustness.py`` (a fresh process per
        stage): all eight stages rc 0, the 27 x 6 matrix; a ``--resume`` run
        skips the seven stages before eval-compose with the same accuracies; a
        run with ``--lora_epochs`` changed reruns train-lora and eval-compose
        only. Then the ``attack`` stage in this process through
        ``cli.main.main`` with the packed-attention counts read around it:
        depth launches of each direction per FGSM or PGD step and batch."""
        import tempfile

        import torch

        rr = self.rr
        rr.STAGE_TIMEOUT_S = RUNNER_STAGE_TIMEOUT_S
        device = "cpu" if self.dev.type == "cpu" else "cuda"
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        startup = self.startup_seconds()
        print(f"phase 7 runner: fresh-process start-up (torch, the CLI, the card) {startup:.2f} s "
              f"{self.card}", flush=True)

        def accuracies(art):
            return {v: {d: m["accuracy"] for d, m in per.items()} for v, per in art["matrix"].items()}

        with tempfile.TemporaryDirectory(prefix="apvt_runner_") as work:
            base = ["--workdir", work, "--device", device, *args]
            first = rr.main([*base, "--out", os.path.join(work, "first.json")])
            stages = first["stages"]
            check(len(stages) == 8 and all(st["rc"] == 0 and not st.get("resumed")
                                           for st in stages), f"runner stages {stages}")
            matrix = first["matrix"]
            # base, 5 single adapters, 10 pairs, 10 triples, all five
            check(len(matrix) == 27 and all(
                list(per) == ["clean", "autoattack", "fgsm", "patch_circle", "pgd", "rp2"]
                for per in matrix.values()), f"runner matrix {len(matrix)} variants")
            check(all(0.0 <= m["accuracy"] <= 1.0 for per in matrix.values()
                      for m in per.values()), "runner matrix: an accuracy outside [0, 1]")
            cfg = first["config"]
            for st in stages:
                print(f"phase 7 runner stage {st['stage']}: rc 0, wall {st['seconds']:.1f} s "
                      f"({cfg['model']} {cfg['image_size']} px, {cfg['n_per_class']} per class) "
                      f"{self.card}", flush=True)
            print(f"phase 7 runner: {len(matrix)} x 6 matrix, base clean accuracy "
                  f"{matrix['base']['clean']['accuracy']:.4f}, total {first['total_seconds']:.1f} s",
                  flush=True)
            self.corpus_codec(os.path.join(work, "data"), cfg["style"])

            second = rr.main([*base, "--resume", "--out", os.path.join(work, "second.json")])
            check([st.get("resumed", False) for st in second["stages"]] == [True] * 7 + [False],
                  f"resume run stages {second['stages']}")
            check(accuracies(second) == accuracies(first), "resume run: accuracies moved")
            third = rr.main([*base, "--resume", "--lora_epochs", "2",
                             "--out", os.path.join(work, "third.json")])
            ran = [st["stage"] for st in third["stages"] if not st.get("resumed")]
            check(ran == ["train-lora", "eval-compose"] and len(third["stages"]) == 8
                  and "families" not in third["stages"][6], f"changed-argument run {third['stages']}")
            print(f"phase 7 runner resume: 7 stages skipped, accuracies identical, eval-compose "
                  f"{second['stages'][-1]['seconds']:.1f} s; --lora_epochs 2 reran {ran} "
                  f"({third['stages'][6]['seconds']:.1f} + {third['stages'][7]['seconds']:.1f} s)",
                  flush=True)

            data = os.path.join(work, "data")
            model = args[args.index("--model") + 1]
            ck = os.path.join(work, "train", model, "all", f"{model}_best_model_finetuned.safetensors")
            steps = int(args[args.index("--pgd_steps") + 1])
            batches = -(-len(self.data_io.read_metadata(os.path.join(data, "test", "metadata.csv")))
                        // BATCH)
            argv = ["--device", device, "attack", "--data_root", data, "--model", model,
                    "--model_path", ck, "--output_dir", os.path.join(work, "adv_in_process"),
                    "--splits", "test", "--steps", str(steps), "--batch_size", str(BATCH)]
            t0 = time.perf_counter()
            rc, counts = self.counted(self.all_counters(), lambda: self.cli.main(argv))
            wall = time.perf_counter() - t0
            depth = self.registry.get_model(model).config(12).depth
            want = {k: 0 for k in counts}
            want["packed_fwd"] = want["packed_bwd"] = depth * (1 + steps) * batches
            check(rc == 0 and counts == want, f"in-process attack stage: rc {rc}, counts {counts}, "
                  f"want {want}")
            print(f"phase 7 runner attack in process: FGSM + PGD-{steps}, {batches} batch(es) of "
                  f"{BATCH}: packed attention {counts['packed_fwd']} + {counts['packed_bwd']} "
                  f"launches (= {depth} x {1 + steps} x {batches}), every other count 0; wall "
                  f"{wall:.1f} s {self.card}", flush=True)

    # 8. the raw-corpus ETL on the card's host
    def etl_fixture(self, raw: str, cv2) -> dict:
        """A LISA-layout corpus (``lisa-road-sign/train/{images,labels}``) of
        ETL_IMAGES JPEG frames, written by OpenCV where it imports, else by
        PIL, on 8 threads: smooth noise, each kept sign box filled with a flat
        colour of its own out to the 16-pixel grid plus one 16-pixel block, so
        that every JPEG block a crop reads, and every block beside it (4:2:0
        chroma upsampling reads those), is flat. Returns the expected crops:
        file name -> (unified class, RGB colour)."""
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        h, w = ETL_FRAME
        images = os.path.join(raw, "lisa-road-sign", "train", "images")
        labels = os.path.join(raw, "lisa-road-sign", "train", "labels")
        os.makedirs(images)
        os.makedirs(labels)

        def frame(i: int) -> dict:
            rng = np.random.default_rng((8, i))
            low = rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8)
            img = np.repeat(np.repeat(low, 16, 0), 16, 1).astype(np.int16)
            img = np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)
            lines, want = [], {}
            for idx, (cls, xc, yc, bw, bh) in enumerate(ETL_BOXES):
                lines.append(f"{cls} {xc} {yc} {bw} {bh}\n")
                # the YOLO box in pixels, as the raw layout defines it
                x1, x2 = max(0, int(xc * w - bw * w / 2)), min(w, int(xc * w + bw * w / 2))
                y1, y2 = max(0, int(yc * h - bh * h / 2)), min(h, int(yc * h + bh * h / 2))
                if cls in ETL_KEPT and min(x2 - x1, y2 - y1) >= 24:
                    colour = rng.integers(0, 256, 3, dtype=np.uint8)
                    img[max(0, (y1 - 16) // 16 * 16):-(-(y2 + 16) // 16) * 16,
                        max(0, (x1 - 16) // 16 * 16):-(-(x2 + 16) // 16) * 16] = colour
                    want[f"f{i:04d}_{idx}.png"] = (ETL_KEPT[cls], colour)
            path = os.path.join(images, f"f{i:04d}.jpg")
            if cv2 is not None:
                check(cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY,
                                                         ETL_JPEG_QUALITY]), f"write {path}")
            else:
                from PIL import Image
                Image.fromarray(img).save(path, quality=ETL_JPEG_QUALITY)
            with open(os.path.join(labels, f"f{i:04d}.txt"), "w") as f:
                f.writelines(lines)
            return want

        want = {}
        with ThreadPoolExecutor(max_workers=8) as pool:
            for got in pool.map(frame, range(ETL_IMAGES)):
                want.update(got)
        return want

    def etl(self) -> None:
        """The ``process`` stage on this host, which must have OpenCV or PIL:
        which of them import; the stage in a fresh process over an empty
        corpus root (rc 0, a header-only ``metadata.csv`` a split, each read by
        the loader as empty); then over a LISA-layout JPEG fixture at LISA's
        size through ``cli.main.main`` in this process with every kernel count
        read around it (all 0): its records, every crop 224 x 224 of one colour
        within ETL_JPEG_TOL of its box's, and crops/s."""
        import tempfile
        from concurrent.futures import ThreadPoolExecutor

        import numpy as np

        cv2 = self.process._cv2()
        try:
            import PIL
            import PIL.Image  # noqa: F401
            pil = PIL.__version__
        except ImportError:
            pil = None
        print(f"phase 8 process decoders on this host: cv2 "
              f"{f'{cv2.__version__} imports' if cv2 is not None else 'absent'}, PIL "
              f"{f'{pil} imports' if pil is not None else 'absent'}", flush=True)
        check(cv2 is not None or pil is not None, "phase 8 needs OpenCV or PIL on this host")
        device = "cpu" if self.dev.type == "cpu" else "cuda"
        stage = [sys.executable, "-m", f"{PKG}.cli", "--device", device, "process"]
        with tempfile.TemporaryDirectory(prefix="apvt_etl_") as work:
            empty, out = os.path.join(work, "empty"), os.path.join(work, "out_empty")
            os.makedirs(empty)
            t0 = time.perf_counter()
            proc = subprocess.run([*stage, "--base_dir", empty, "--output_dir", out,
                                   "--datasets", *ETL_DATASETS], cwd=HERE, capture_output=True,
                                  text=True, timeout=RUNNER_STAGE_TIMEOUT_S)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0, f"process over an empty root: rc {proc.returncode}\n"
                  f"{proc.stdout}{proc.stderr}")
            vocab = self.vocab.LabelVocabulary.from_classes(sorted(set(ETL_KEPT.values())))
            for split in ("train", "val", "test"):
                meta = os.path.join(out, split, "metadata.csv")
                with open(meta, "rb") as f:
                    check(f.read() == ETL_HEADER, f"process over an empty root: {split} metadata")
                check(os.listdir(os.path.join(out, split, "images")) == [],
                      f"process over an empty root: {split} images")
                idx = self.loader.MetadataIndex(meta, vocab)
                check(len(idx) == 0 and list(self.loader.Loader(idx, batch_size=BATCH)) == [],
                      f"process over an empty root: the loader reads {split} as not empty")
            print(f"phase 8 process over an empty corpus root ({len(ETL_DATASETS)} image corpora, "
                  f"3 splits) in a fresh process: rc 0, header-only metadata.csv a split, each "
                  f"read by the loader as empty; wall {wall:.2f} s (start-up included) {self.card}",
                  flush=True)

            raw, out = os.path.join(work, "raw"), os.path.join(work, "out")
            t0 = time.perf_counter()
            want = self.etl_fixture(raw, cv2)
            setup = time.perf_counter() - t0
            jpeg_mb = sum(e.stat().st_size for e in os.scandir(
                os.path.join(raw, "lisa-road-sign", "train", "images"))) / 2 ** 20
            args = ["--base_dir", raw, "--output_dir", out, "--datasets", "lisa-road-sign"]
            branch = "cv2" if cv2 is not None else "PIL"
            t0 = time.perf_counter()
            rc, counts = self.counted(self.all_counters(),
                                      lambda: self.cli.main(["--device", device, "process", *args]))
            wall = time.perf_counter() - t0
            check(rc == 0 and not any(counts.values()), f"process: rc {rc}, kernel counts {counts}")
            meta = self.data_io.read_metadata(os.path.join(out, "train", "metadata.csv"))
            names = [os.path.basename(p) for p in meta["image_path"]]
            check(names == sorted(want) and set(meta["source"]) == {"lisa"}
                  and list(meta["unified_class"]) == [want[n][0] for n in names],
                  f"process records: {len(names)} of {len(want)}")

            def crop_err(item) -> int:
                path, name = item
                with open(path, "rb") as f:
                    crop = self.native.decode_png_rgb(f.read())
                check(crop is not None and crop.shape == (224, 224, 3)
                      and (crop == crop[0, 0]).all(), f"process crop {name}: not one colour")
                return int(np.abs(crop[0, 0].astype(np.int16) - want[name][1]).max())

            with ThreadPoolExecutor(max_workers=8) as pool:
                err = max(pool.map(crop_err, zip(meta["image_path"], names)))
            check(err <= ETL_JPEG_TOL, f"process crops: {err} LSB from their boxes' colours, "
                  f"limit {ETL_JPEG_TOL}")
            print(f"phase 8 process branch: {branch}; LISA-layout fixture of {ETL_IMAGES} JPEG "
                  f"frames of {ETL_FRAME[1]} x {ETL_FRAME[0]} (quality {ETL_JPEG_QUALITY}, "
                  f"{jpeg_mb:.1f} MiB, written in {setup:.2f} s): {len(names)} crops, every crop "
                  f"224 x 224 of one colour, at most {err} LSB from its box's (limit "
                  f"{ETL_JPEG_TOL}), every kernel count 0; wall {wall:.2f} s, "
                  f"{len(names) / wall:.1f} crops/s, {ETL_IMAGES / wall:.1f} frames/s {self.card}",
                  flush=True)

    # 9. the W8A8 attack path, BiLoRA and the example workflows
    def int8_vs_cpu(self) -> None:
        """``int8_matmul`` on the card against the same inputs on the CPU, bit
        for bit (the weight's int8 form and scales, the output, dx), at
        INT8_SHAPES; then each ViT-B shape's times in turns, best of three:
        the op forward and dx, its per-row quantizer, ``torch._int_mm`` with
        the weight column-major (the wrapper's layout) and row-major, the copy
        that makes it column-major, and bf16 ``F.linear`` forward and dx."""
        import torch
        import torch.nn.functional as F

        quant = self.quant
        gen = torch.Generator(self.dev).manual_seed(9)
        for m, k, n in INT8_SHAPES:
            x = torch.randn(m, k, generator=gen, device=self.dev).bfloat16()
            w = torch.randn(k, n, generator=gen, device=self.dev) * k ** -0.5
            g = torch.randn(m, n, generator=gen, device=self.dev)
            outs = []  # the card's, then the CPU's
            for dev in (self.dev, torch.device("cpu")):
                w_q, w_s = quant.quantize_weight(w.to(dev))
                xd = x.to(dev).requires_grad_()
                y = quant.int8_matmul(xd, w_q, w_s)
                (dx,) = torch.autograd.grad(y, xd, g.to(dev))
                outs.append([t.detach().cpu() for t in (w_q, w_s, y, dx)])
            for what, a, b in zip(("w_q", "w_s", "y", "dx"), *outs):
                check(a.dtype == b.dtype and torch.equal(a, b),
                      f"int8_matmul {m}x{k}x{n} {what}: the card's differs from the CPU's "
                      f"(max |diff| {float((a.float() - b.float()).abs().max()):.3e})")
            print(f"phase 9 int8_matmul (M, K, N) = ({m}, {k}, {n}), x bf16: w_q, w_s, y and dx "
                  f"on the card equal the CPU's bit for bit", flush=True)
            if m <= 16:
                continue
            w_q, w_s = quant.quantize_weight(w)
            q_x, _ = quant._quantize_act(x)
            w_qt, wb, gb = w_q.t().contiguous(), w.bfloat16(), g.bfloat16()
            with torch.no_grad():
                best = rivals({
                    "int8_matmul fwd": lambda: quant.int8_matmul(x, w_q, w_s),
                    "int8_matmul dx": lambda: quant._input_grad(g, w_q, w_s, x.dtype),
                    "quantize x per row": lambda: quant._quantize_act(x),
                    "_int_mm w column-major": lambda: torch._int_mm(q_x, w_qt.t()),
                    "_int_mm w row-major": lambda: torch._int_mm(q_x, w_q),
                    "copy of w_q^T": lambda: w_q.t().contiguous(),
                    "bf16 F.linear fwd": lambda: F.linear(x, wb.t()),
                    "bf16 F.linear dx": lambda: F.linear(gb, wb)})
            print(f"phase 9 int8 times ({m}, {k}, {n}) {self.card}: "
                  + ", ".join(f"{what} {ms:.4f} ms" for what, ms in best.items()), flush=True)

    def int8_pgd(self, entry, cfg, model_tree, normalize, model, x_u8, own):
        """PGD-10 on the merged bf16 ViT-B quantized over QUANT_TARGETS_DEFAULT
        (``bench.py``'s int8 unit) beside the bf16 tree, labelled by the bf16
        model's own predictions: the packed-attention launches of both (counts
        set to 0 just before, read just after) the same exact count and every
        other count 0; the int8 attack's images finite, in [0, 1], in the
        eps-ball and moved; the sign agreement of the two trees' input
        gradients above INT8_SIGN_AGREE; the bf16 model's accuracy on each
        attack's images (the attack-strength comparison); images/s of both in
        turns. Returns (quantized tree, quantized model, ``run(model)``)."""
        import torch

        common = self.common
        qtree = self.quant.quantize_dense_tree(model_tree, self.vit.QUANT_TARGETS_DEFAULT)
        qmodel = entry.from_tree(qtree, cfg)
        pgd = self.make_pgd(entry, cfg, normalize)

        def run(m):
            return pgd(m, x_u8, own, torch.Generator(self.dev).manual_seed(1))

        counters = self.vit_counters()
        adv_b, l_b = self.counted(counters, lambda: run(model))
        adv_q, l_q = self.counted(counters, lambda: run(qmodel))
        per = cfg.depth * PGD_STEPS
        want = {**{k: 0 for k in counters}, "packed_fwd": per, "packed_bwd": per}
        check(l_b == want and l_q == l_b,
              f"int8 PGD: kernel counts {l_q}, the bf16 tree's {l_b} (want {want})")
        clean = common.to_unit_floats(x_u8)
        moved = float((adv_q - clean).abs().max())
        check(bool(torch.isfinite(adv_q).all()) and adv_q.shape == clean.shape, "int8 PGD output")
        check(float(adv_q.min()) >= 0.0 and float(adv_q.max()) <= 1.0, "int8 PGD outside [0,1]")
        check(moved <= EPS + 1e-6 and moved > 1e-4, f"int8 PGD: max |adv - x| {moved}")

        def input_grad(m):
            with common.frozen(m), torch.enable_grad():
                xg = clean.clone().requires_grad_()
                loss = common.sum_cross_entropy(entry.apply(cfg, m, normalize(xg)), own)
                return torch.autograd.grad(loss, xg)[0]

        agree = float((torch.sign(input_grad(model)) == torch.sign(input_grad(qmodel)))
                      .float().mean())
        check(agree > INT8_SIGN_AGREE, f"int8 input-gradient sign agreement {agree:.4f}")
        with torch.no_grad():
            acc = [float((entry.apply(cfg, m, normalize(x)).argmax(-1) == own).float().mean())
                   for m, x in ((qmodel, clean), (model, adv_b), (model, adv_q))]
        print(f"phase 9 int8 PGD-{PGD_STEPS} google_vit+LoRA B={BATCH}, W8A8 over "
              f"{len(self.vit.QUANT_TARGETS_DEFAULT)} denses a block: launches {l_q} (the bf16 "
              f"tree's the same), sign agreement of the input gradient with the bf16 tree "
              f"{agree:.4f} (limit {INT8_SIGN_AGREE}), max |adv - x| {moved:.5f}; accuracy on "
              f"the bf16 model's own labels: int8 model clean {acc[0]:.4f}, bf16 model on the "
              f"bf16 attack's images {acc[1]:.4f}, on the int8 attack's images {acc[2]:.4f}",
              flush=True)
        best = rivals({"bf16": lambda: run(model), "int8": lambda: run(qmodel)}, iters=2)
        print(f"phase 9 PGD-{PGD_STEPS} google_vit+LoRA B={BATCH} in turns {self.card}: "
              + ", ".join(f"{label} {ms:.2f} ms/batch, {BATCH * 1000 / ms:.2f} images/s"
                          for label, ms in best.items()), flush=True)
        return qtree, qmodel, run

    def int8_gates(self, entry, cfg, qtree, qmodel, normalize, x_u8) -> None:
        """The quantized ViT-B with each kernel field on: the fused kernels
        are bypassed (attn_block and both fused MLPs launch 0 times, packed
        attention once a block) and the logits equal the fields-off ones bit
        for bit."""
        import torch

        x = normalize(self.common.to_unit_floats(x_u8))
        counters = self.vit_counters()
        want_l = {**{k: 0 for k in counters}, "packed_fwd": cfg.depth}
        with torch.no_grad():
            want = entry.apply(cfg, qmodel, x)
            for field in ("fuse_attn_block", "fuse_ln_mlp", "use_fused_mlp"):
                fcfg = dataclasses.replace(cfg, **{field: True})
                m = entry.from_tree(qtree, fcfg)
                got, launches = self.counted(counters, lambda: entry.apply(fcfg, m, x))
                check(launches == want_l, f"int8 with {field}: kernel counts {launches}")
                check(torch.equal(got, want), f"int8 with {field}: logits differ from fields off")
        print("phase 9 int8 gates: fuse_attn_block, fuse_ln_mlp, use_fused_mlp on the quantized "
              f"ViT-B: attn_block and fused-MLP launches 0, logits equal fields off bit for bit "
              f"(B={BATCH})", flush=True)

    def int8_trace(self, run, qmodel) -> None:
        """One warm int8 PGD-10 call inside ``utils.observability.profile_trace``:
        the trace file it writes, and the trace's device time by group."""
        log_dir = os.path.join(self.build_mod.build_dir(), "int8_trace")
        shutil.rmtree(log_dir, ignore_errors=True)
        wall_ms = cuda_ms(lambda: run(qmodel), 2)
        with self.observability.profile_trace(log_dir) as prof:
            run(qmodel)
        written = os.listdir(log_dir)
        check(len(written) == 1 and written[0].endswith(".pt.trace.json"),
              f"profile_trace wrote {written}")
        self.trace_summary("phase 9 trace (profile_trace)", f"int8 PGD-{PGD_STEPS} B={BATCH}",
                           prof, wall_ms, top=True)

    def bilora_vs_cpu(self) -> None:
        """BiLoRA's delta (cuFFT) and its coefficients' gradients under a
        random cotangent on the card against the CPU, within BILORA_RTOL of
        the CPU's max; then their times."""
        import torch

        bilora = self.bilora
        g = torch.Generator().manual_seed(12)
        *lead, d_in, d_out = BILORA_SHAPE
        fac = {k: torch.randn(*lead, BILORA_N_FRQ, generator=g) * 0.1 for k in ("re", "im")}
        cot = torch.randn(BILORA_SHAPE, generator=g)
        pos = bilora._positions(BILORA_TASK, BILORA_N_FRQ, d_in, d_out)
        outs = []  # the card's, then the CPU's
        for dev in (self.dev, torch.device("cpu")):
            f = {k: v.to(dev).requires_grad_() for k, v in fac.items()}
            d = bilora.delta(f, pos, BILORA_SHAPE, 1.0)
            (d * cot.to(dev)).sum().backward()
            outs.append([t.detach().cpu() for t in (d, f["re"].grad, f["im"].grad)])
        errs = []
        for what, a, b in zip(("delta", "d re", "d im"), *outs):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= BILORA_RTOL * scale, f"BiLoRA {what}: {err:.3e} against max {scale:.3e}")
            errs.append(f"{what} {err:.3e} (max {scale:.3e})")
        f = {k: v.to(self.dev).requires_grad_() for k, v in fac.items()}
        cot = cot.to(self.dev)

        def fwd_bwd():
            (bilora.delta(f, pos, BILORA_SHAPE, 1.0) * cot).sum().backward()

        best = rivals({"delta": lambda: bilora.delta(f, pos, BILORA_SHAPE, 1.0),
                       "delta + coefficient gradients": fwd_bwd})
        print(f"phase 9 BiLoRA {BILORA_SHAPE} n_frq {BILORA_N_FRQ} task {BILORA_TASK}: card vs "
              f"CPU max |err| " + ", ".join(errs) + f" (limit {BILORA_RTOL} x max); times "
              f"{self.card}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in best.items()),
              flush=True)

    def demos(self) -> None:
        """Both example workflows' ``main`` on the card: their lines, their
        walls, and the trends the CPU tests check."""
        import importlib.util
        import io

        for path in DEMOS:
            name = os.path.basename(path)[:-3]
            spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, path))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out = mod.main(["--device", str(self.dev)])
            wall = time.perf_counter() - t0
            for line in buf.getvalue().splitlines():
                print(f"phase 9 demo {name}: {line}")
            if name.startswith("sequential"):
                check(out[2]["noisy"] >= out[0]["noisy"] and out[1]["clean"] > out[0]["clean"],
                      f"{name}: accuracies {out}")
            else:
                check(out["losses"][-1] < out["losses"][0] and out["bilora"] > out["base"],
                      f"{name}: {out}")
            print(f"phase 9 demo {name}: wall {wall:.2f} s (host clock, data set-up included) "
                  f"{self.card}", flush=True)

    # 10. the data x model mesh (parallel/)
    def mesh_job(self, depth: int, batch: int, stages, workdir: str) -> dict:
        """A ``parallel.compare`` job on ViT-B/16 (cut to ``depth`` blocks): the
        tree from a seed with its biases and LayerNorm leaves moved off their
        init values (``compare.jitter_affine``: a row-split bias added on
        every rank, or a column slice from the wrong rank, changes the
        logits), a uint8 batch from a numpy seed."""
        import numpy as np
        import torch

        cfg = dataclasses.replace(self.vit.VIT_B16.with_classes(CLASSES), depth=depth)
        rng = np.random.default_rng(10)
        return {"model": "google_vit", "num_classes": CLASSES, "fields": {"depth": depth},
                "tree": self.compare.jitter_affine(
                    self.vit.init(cfg, torch.Generator().manual_seed(10)), 10),
                "images": torch.from_numpy(rng.integers(0, 256, (batch, 224, 224, 3),
                                                        dtype=np.uint8)),
                "labels": torch.from_numpy(rng.integers(0, CLASSES, batch)),
                "stages": list(stages), "workdir": workdir}

    def mesh_world1(self) -> None:
        """(a) NCCL, world size 1, mesh (1, 1), full ViT-B/16 in bf16, B=64: a
        LoRA step through ``fit``, PGD-10 and the four-variant eval-compose,
        each bit for bit the same calls without a mesh; the stage walls with
        and without the mesh in turns (MESH_TURNS each), the median of each."""
        import tempfile

        import torch
        import torch.distributed as dist

        def same(a, b) -> bool:
            if isinstance(a, dict):
                return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
            return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

        compare, pmesh, launch = self.compare, self.pmesh, self.launch
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{launch.free_port()}",
                                rank=0, world_size=1)
        mesh = pmesh.make_mesh(pmesh.MeshSpec(1, 1), device="cuda")
        with tempfile.TemporaryDirectory() as work:
            job = self.mesh_job(12, BATCH, ("lora_step", "pgd10", "compose"), work)
            walls = {"mesh": [], "none": []}
            compare.run_stages(job, self.dev, None)  # warm-up: the first call of each stage
            for turn in range(MESH_TURNS):
                for name in (("mesh", "none") if turn % 2 == 0 else ("none", "mesh")):
                    t = {}
                    out = compare.run_stages(job, self.dev, mesh if name == "mesh" else None, t)
                    walls[name].append(t)
                    if name == "mesh":
                        got = out
                    else:
                        ref = out
                for stage in job["stages"]:
                    check(same(got[stage], ref[stage]), f"phase 10 (a) {stage}: the (1, 1) "
                          f"mesh over NCCL differs from no mesh (turn {turn})")
        dist.destroy_process_group()

        t_mesh = walls["mesh"][-1]
        check(min(t_mesh["pgd10"]["attention_fwd"], t_mesh["lora_step"]["attention_bwd"]) > 0,
              f"phase 10 (a): no packed-attention launch {t_mesh}")

        def median(name, stage):
            return sorted(t[stage]["seconds"] for t in walls[name])[MESH_TURNS // 2]

        print(f"phase 10 (a) mesh (1, 1) over NCCL, world size 1, google_vit ViT-B/16 + rank-8 "
              f"LoRA bf16 B={BATCH}: LoRA step through fit, PGD-{PGD_STEPS}, 4-variant "
              f"eval-compose each bit for bit the calls with mesh=None in each of {MESH_TURNS} "
              f"turns; seconds, median of {MESH_TURNS} in turns (mesh / none): "
              + ", ".join(f"{k} {median('mesh', k):.3f} / {median('none', k):.3f}"
                          for k in job["stages"])
              + "; every reading (mesh / none): " + ", ".join(
                  f"{k} {[round(t[k]['seconds'], 3) for t in walls['mesh']]} / "
                  f"{[round(t[k]['seconds'], 3) for t in walls['none']]}" for k in job["stages"])
              + f" (after a warm-up pass, model build included) {self.card}", flush=True)

    def mesh_gloo4(self) -> tuple:
        """(b) gloo, 4 ranks sharing the card, mesh TP_MESH, ViT-B/16 at full
        width cut to TP_DEPTH blocks, bf16, B=TP_BATCH: forward logits, PGD-2
        and a LoRA step's loss, fields off and each of TP_FIELDS, against one
        process on the card; every rank's packed-attention (and fused-MLP)
        launches non-zero. Returns the packed-attention launches over the
        ranks and runs, ``{"fwd": n, "bwd": n}``."""
        import tempfile

        import torch

        compare, launch = self.compare, self.launch
        with tempfile.TemporaryDirectory() as work:
            job = self.mesh_job(TP_DEPTH, TP_BATCH, ("forward", "pgd2", "lora_step"), work)
            job["runs"] = [{"spec": TP_MESH, "stages": ["collectives", *job["stages"]]},
                           *({"spec": TP_MESH, "fields": {"depth": TP_DEPTH, field: True}}
                             for field in TP_FIELDS)]
            torch.save(job, os.path.join(work, "job.pt"))
            t0 = time.perf_counter()
            backend = launch.spawn(compare.run_rank, 4, device="cuda",
                                   args=(os.path.join(work, "job.pt"),
                                         os.path.join(work, "out.pt")),
                                   log=lambda m: print(f"phase 10 (b) {m}", flush=True))
            spawn_s = time.perf_counter() - t0
            runs = torch.load(os.path.join(work, "out.pt"), weights_only=False)
        check(backend == "gloo", f"phase 10 (b): backend {backend}")
        x = job["images"].float() / 255.0
        launches = {"fwd": 0, "bwd": 0}
        for run, res in zip(job["runs"], runs):
            name = next((f for f in TP_FIELDS if f in run.get("fields", {})), "fields off")
            ref = compare.run_stages({**job, **run, "stages": job["stages"]}, self.dev)
            got, counts = res["outputs"], res["counts"]
            if "collectives" in got:
                print(f"phase 10 (b) gloo all_reduce and all_gather on CUDA tensors over 4 ranks: "
                      f"{got['collectives']['all_reduce'].tolist()}", flush=True)
            err = close(got["forward"]["logits"], ref["forward"]["logits"], *TP_LOGIT_TOL,
                        f"phase 10 (b) {name} logits")
            d_g, d_r = (torch.sign(o["pgd2"]["adv"] - x) for o in (got, ref))
            agree = float((d_g == d_r).float().mean())
            check(agree > TP_SIGN_AGREE, f"phase 10 (b) {name} PGD-2 sign agreement {agree}")
            l_g, l_r = float(got["lora_step"]["loss"]), float(ref["lora_step"]["loss"])
            check(abs(l_g - l_r) <= TP_LOSS_RTOL * abs(l_r),
                  f"phase 10 (b) {name} LoRA loss {l_g} vs {l_r}")
            g_g, g_r = got["lora_step"]["grads"], ref["lora_step"]["grads"]
            check(g_g.keys() == g_r.keys(), f"phase 10 (b) {name}: gradient names differ")
            grad_rel = max(float((g_g[k] - g_r[k]).norm() / g_r[k].norm()) if g_r[k].norm() > 0
                           else float(g_g[k].norm()) for k in g_r)
            check(grad_rel <= TP_GRAD_RTOL,
                  f"phase 10 (b) {name} LoRA step gradients: relative error {grad_rel}")
            t_g, t_r = ({p: v.cpu() for p, v in
                         self.trees.flatten_with_paths(o["lora_step"]["trained"]).items()}
                        for o in (got, ref))
            check(t_g.keys() == t_r.keys(), f"phase 10 (b) {name}: trained adapter paths differ")
            trained_err = max(close(t_g[p], t_r[p], TP_TRAINED_ATOL, 0,
                                    f"phase 10 (b) {name} trained {p}") for p in t_r)
            keys = ["attention_fwd", "attention_bwd"] + {
                "use_fused_mlp": ["fused_mlp_fwd", "fused_mlp_bwd"],
                "fuse_ln_mlp": ["ln_mlp_fwd", "ln_mlp_bwd"]}.get(name, [])
            per_rank = [{k: sum(c[st][k] for st in job["stages"]) for k in keys}
                        for c in counts]
            check(all(v > 0 for r in per_rank for v in r.values()),
                  f"phase 10 (b) {name}: a rank launched no kernel {per_rank}")
            for k in launches:
                launches[k] += sum(r[f"attention_{k}"] for r in per_rank)
            print(f"phase 10 (b) mesh {TP_MESH} over gloo, 4 ranks on one card, google_vit "
                  f"ViT-B/16 width 768 depth {TP_DEPTH} (cut from 12) bf16 B={TP_BATCH}, {name}: "
                  f"logits max|err| {err:.3e} (limit atol/rtol {TP_LOGIT_TOL}), PGD-2 sign "
                  f"agreement {agree:.5f} (limit {TP_SIGN_AGREE}), LoRA step loss {l_g:.6f} vs "
                  f"{l_r:.6f} (rtol {TP_LOSS_RTOL}), its gradients' largest relative error "
                  f"{grad_rel:.3e} (limit {TP_GRAD_RTOL}), the trained adapter and head max|err| "
                  f"{trained_err:.3e} (limit {TP_TRAINED_ATOL}); launches per rank {per_rank}; rank 0 "
                  f"seconds " + ", ".join(f"{st} {counts[0][st]['seconds']:.2f}"
                                          for st in counts[0] if st != "foreign_modules")
                  + f" {self.card}", flush=True)
            check(all(c["foreign_modules"] == [] for c in counts), "a rank imported jax")
        print(f"phase 10 (b) spawn + both runs: {spawn_s:.1f} s {self.card}", flush=True)
        return launches

    def time_attention_tp(self, launches: dict) -> list[dict]:
        """Packed attention at the tensor-parallel shape of phase 10 (b): each
        rank's 6 of ViT-B's 12 heads on its TP_BATCH/2 rows, (8, 197, 6, 64):
        kernel against plain (forward and backward), bound, SDPA."""
        import torch
        import torch.nn.functional as F

        ka = self.ka
        b, n, h, hd = TP_BATCH // TP_MESH[0], 197, 12 // TP_MESH[1], 64
        gen = torch.Generator(self.dev).manual_seed(11)
        q, k, v, do = (torch.randn(b, n, h * hd, device=self.dev, generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        check(ka.kernel_variant(torch.bfloat16, n, hd) == "wgmma", "TP shape not on wgmma")
        (fa, fr), (ga, gr) = TOL["bfloat16"]
        o, lse = ka.fused_attention_packed_fwd(q, k, v, h, with_lse=True)
        e_f = close(o, ka.attention_packed_reference(q, k, v, h), fa, fr, "tp fwd")
        got = ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse)
        want = ka.attention_packed_bwd_reference(q, k, v, do, h)
        e_b = max(close(g_, w_, ga, gr, f"tp d{nm}") for nm, g_, w_ in zip("qkv", got, want))
        qh, kh, vh = (t.view(b, n, h, hd).transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        doh = do.view(b, n, h, hd).transpose(1, 2)
        out = F.scaled_dot_product_attention(qh, kh, vh)
        kf, pf, lf = turns(lambda: ka.fused_attention_packed_fwd(q, k, v, h),
                           lambda: ka.attention_packed_reference(q, k, v, h),
                           library=lambda: F.scaled_dot_product_attention(qh, kh, vh))
        kb, pb, lb = turns(lambda: ka.fused_attention_packed_bwd(q, k, v, do, h, o, lse),
                           lambda: ka.attention_packed_bwd_reference(q, k, v, do, h),
                           library=lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                                               retain_graph=True))
        unit, tensor = b * h * n * n * hd, b * n * h * hd * 2
        bf, bf_by = bound_ms(4 * unit, 4 * tensor, PEAK_BF16)
        bb, bb_by = bound_ms(10 * unit, 7 * tensor, PEAK_BF16)
        print(f"phase 10 attention_packed at the TP shape {(b, n, h, hd)} bf16 [wgmma]: fwd "
              f"max|err| {e_f:.3e}, dq/dk/dv max|err| {e_b:.3e}; kernel fwd {kf:.4f} ms bwd "
              f"{kb:.4f} ms; plain fwd {pf:.4f} ms bwd {pb:.4f} ms; SDPA fwd {lf:.4f} ms bwd "
              f"{lb:.4f} ms; bound fwd {bf:.4f} ms ({bf_by}) bwd {bb:.4f} ms ({bb_by}) "
              f"{self.card}", flush=True)
        src = f"{PKG}/csrc/attention_packed.cu"
        self.tp_errs = {"attention_packed_tp_fwd": e_f, "attention_packed_tp_bwd": e_b}
        return [
            {"name": "attention_packed_tp_fwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:230", "launches": launches["fwd"],
             "ms": kf, "plain_ms": pf, "bound_ms": bf, "bound_by": bf_by, "library_ms": lf},
            {"name": "attention_packed_tp_bwd", "route": "cuda", "source": src,
             "replaces": f"{JAX_SRC}/attention.py:238", "launches": launches["bwd"],
             "ms": kb, "plain_ms": pb, "bound_ms": bb, "bound_by": bb_by, "library_ms": lb}]

    def bench_expect(self, variant: str, calls: int) -> dict:
        """Each of ``bench_torch.COUNTERS`` that ``calls`` ViT-B PGD-10 calls of
        ``variant`` must show (BENCH_KERNELS)."""
        per_call = 12 * PGD_STEPS
        return {name: calls * per_call if name.rsplit("_", 1)[0] in BENCH_KERNELS[variant] else 0
                for name in self.bench.COUNTERS}

    def bench_entry(self, phase6_ms: float) -> None:
        """Phase 11 (a): ``python3 bench_torch.py`` from the checkout, as a user
        runs it (the default variant, in a fresh process): its JSON line and
        the kernel launches it printed."""
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py")], cwd=HERE,
                             capture_output=True, text=True, timeout=BENCH_ENTRY_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = out.stdout.strip().splitlines()
        check(out.returncode == 0 and lines, f"bench_torch.py: rc {out.returncode} "
              f"{out.stderr[-2000:]}")
        rec = json.loads(lines[-1])
        for line in lines[:-1]:
            print(f"phase 11 (a) bench_torch.py: {line}", flush=True)
        check(rec.get("value") is not None, f"bench_torch.py printed no value: {rec}")
        check(rec["metric"] == self.bench.metric_name(PGD_STEPS, "merged"),
              f"bench_torch.py metric {rec['metric']}")
        check(0 < rec["mfu_pct"] <= 100, f"bench_torch.py mfu_pct {rec['mfu_pct']}")
        got = next((json.loads(m.group(1)) for m in map(
            re.compile(r"^kernel launches over \d+ PGD-\d+ calls .*?: (\{.*\})$").match, lines)
            if m), None)
        want = self.bench_expect("merged", 1 + self.bench.settings()["iters"])
        check(got == want, f"bench_torch.py launches {got} (want {want})")
        print(f"phase 11 (a) bench_torch.py (fresh process, wall {wall:.1f} s): {rec['value']} "
              f"images/s, mfu {rec['mfu_pct']}% of 989.4 TFLOP/s, beside phase 6's in-process "
              f"ViT-B fields off {BATCH * 1000 / phase6_ms:.2f} images/s {self.card}", flush=True)

    def bench_variants(self) -> None:
        """Phase 11 (b): the other BENCH_VARIANTs through ``bench_torch.measure``
        in this process, each held to its kernels' launch counts."""
        for variant in self.bench.VARIANTS[1:]:
            rec, got = self.bench.measure(self.dev, variant, batch=BATCH, steps=PGD_STEPS,
                                          iters=BENCH_VARIANT_ITERS)
            want = self.bench_expect(variant, 1 + BENCH_VARIANT_ITERS)
            check(got == want, f"bench_torch {variant} launches {got} (want {want})")
            check(rec["metric"] == self.bench.metric_name(PGD_STEPS, variant) and rec["value"] > 0
                  and 0 < rec["mfu_pct"] <= 100, f"bench_torch {variant}: {rec}")
            print(f"phase 11 (b) BENCH_VARIANT={variant}: {rec['value']} images/s, mfu "
                  f"{rec['mfu_pct']}%, launches {' '.join(f'{k} {v}' for k, v in got.items() if v)}"
                  f" {self.card}", flush=True)

    def bench_tools(self) -> None:
        """Phase 11 (c): each tool of ``<port>/tools/`` once, in this process,
        at cut counts (BENCH_TOOL_ARGS), writing its artifact."""
        out_dir = os.path.join(self.build_mod.build_dir(), "phase11")
        shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir)
        for tool, args in BENCH_TOOL_ARGS.items():
            path = os.path.join(out_dir, f"{tool}.json")
            flag = "--table_json" if tool.startswith("profile") else "--json"
            extra = ("--out", os.path.join(out_dir, f"trace_{tool}")) if tool.startswith(
                "profile") else ()
            t0 = time.perf_counter()
            rc = importlib.import_module(f"{PKG}.tools.{tool}").main([*args, *extra, flag, path])
            wall = time.perf_counter() - t0
            check(rc == 0, f"tools/{tool}: rc {rc}")
            art = json.load(open(path))
            if tool.startswith("profile"):
                check(art["busy_ms"] and art["device_total_ms"] and art["idle_share"] is not None
                      and os.path.exists(art["trace"]), f"tools/{tool}: table {art}")
                groups = [g["group"] for g in art["groups"]]
                check(any("this repo" in g for g in groups), f"tools/{tool}: no kernel of this "
                      f"repo in the trace: {groups}")
                what = (f"busy {art['busy_ms']:.2f} ms, idle share {art['idle_share']:.1%}, "
                        f"first groups " + "; ".join(
                            f"{g['group']} {g['total_ms']:.2f} ms" for g in art["groups"][:3]))
            elif tool == "bench_compose":
                check(art["variants"] == 27 and art["matrix_wall_s"]["host"] > 0,
                      f"tools/{tool}: {art}")
                what = (f"{art['variants']} variants x {art['datasets']} x "
                        f"{art['n_per_dataset']}: build {art['build_wall_s']['host']} s, matrix "
                        f"{art['matrix_wall_s']['host']} s, {art['matrix_imgs_per_s']['host']} "
                        f"images/s")
            else:
                check(art["device"] == self.timing.device_kind(self.dev) and all(
                    r.get("value") for r in art["records"]), f"tools/{tool}: {art}")
                what = "; ".join(f"{r.get('backbone', r['metric'])}"
                                 + (f" B={r['batch']}" if tool == "bench_eval" else "")
                                 + (" int8" if r.get("int8") else "") + f" {r['value']}"
                                 + (f" (mfu {r['mfu_pct_analytic']}%)"
                                    if r.get("mfu_pct_analytic") else "")
                                 for r in art["records"])
            print(f"phase 11 (c) tools/{tool} {' '.join(args)} (wall {wall:.1f} s): {what} "
                  f"{self.card}", flush=True)

    def profile(self, name: str) -> None:
        """One warm PGD-10 call of ``name`` under ``torch.profiler``: device
        time by kernel group, busy time against the wall."""
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        if name in ("train", "train_lora"):
            entry, cfg, _, tree, normalize, _ = self.model(
                "google_vit", self.vit, "attention_packed", self.ka.attention_packed_reference)
            calls = self.train_callables(entry, tree, normalize, name)
            what = f"one training step B={BATCH} f32 params bf16 compute"
        elif name in ("patch", "square"):
            entry, cfg, model, _, normalize, _ = self.model(
                "google_vit", self.vit, "attention_packed", self.ka.attention_packed_reference)
            x = torch.from_numpy(np.random.default_rng(1).integers(
                0, 256, (BATCH, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).to(self.dev)
            with torch.no_grad():
                y = entry.apply(cfg, model, normalize(self.common.to_unit_floats(x))).argmax(-1)
            if name == "patch":
                pcfg = self.patch_mod.PatchConfig(iters=PROFILE_PATCH_ITERS)
                run = self.patch_mod.make_train_patch(entry.apply, cfg, pcfg, normalize=normalize)
                what = f"{pcfg.iters} patch-training iterations B={pcfg.batch_size} P=24"
            else:
                run = self.aa.make_square(entry.apply, cfg, self.aa.SquareConfig(
                    eps=0.031, n_queries=PROFILE_SQUARE_QUERIES,
                    exit_check_every=PROFILE_SQUARE_QUERIES), normalize=normalize)
                what = f"{PROFILE_SQUARE_QUERIES} Square queries B={BATCH}"
            calls = {"google_vit": lambda: run(model, x, y,
                                               torch.Generator(self.dev).manual_seed(0))}
        elif name in ("train_swin", "train_convnext"):
            family = name[len("train_"):]
            entry, cfg, _, tree, normalize, _ = (
                self.model(family, self.swin, "window_attention",
                           self.kw.window_attention_reference) if family == "swin"
                else self.model(family, kernel_fields=CONVNEXT_KERNELS))
            calls = {f"{kind}" + (f" {'+'.join(fields)}" if fields else " fields off"):
                     self.train_step_call(family, kind, fields, tree, normalize)
                     for fam, kind, fields in TRAIN_RUNS if fam == family}
            what = f"one training step B={BATCH} f32 params bf16 compute"
        elif name == "yolo11-cls":
            entry, cfg, model, _, normalize, _ = self.model(name)
            runs = {"no kernel of this repo": (cfg, model)}
        elif name == "int8":
            entry, cfg, model, _, normalize, model_tree = self.model(
                "google_vit", self.vit, "attention_packed", self.ka.attention_packed_reference)
            qtree = self.quant.quantize_dense_tree(model_tree, self.vit.QUANT_TARGETS_DEFAULT)
            runs = {"bf16, fields off": (cfg, model),
                    "W8A8 over QUANT_TARGETS_DEFAULT": (cfg, entry.from_tree(qtree, cfg))}
        elif name == "convnext":
            entry, cfg, _, _, normalize, model_tree = self.model(name, kernel_fields=CONVNEXT_KERNELS)
            runs = {label: v for label, v in self.convnext_variants(entry, cfg, model_tree).items()
                    if label in ("both kernels", "library")}
        else:
            module, attn, plain = {
                "google_vit": (self.vit, "attention_packed", self.ka.attention_packed_reference),
                "swin": (self.swin, "window_attention", self.kw.window_attention_reference)}[name]
            entry, cfg, model, _, normalize, model_tree = self.model(name, module, attn, plain)
            runs = {"kernel path": (cfg, model)}
            if name == "google_vit":
                bcfg = dataclasses.replace(cfg, fuse_attn_block=True)
                runs["fuse_attn_block"] = (bcfg, entry.from_tree(model_tree, bcfg))
        if name not in ("train", "train_lora", "train_swin", "train_convnext", "patch", "square"):
            rng = np.random.default_rng(1)
            x = torch.from_numpy(rng.integers(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3),
                                              dtype=np.uint8)).to(self.dev)
            y = torch.from_numpy(rng.integers(0, CLASSES, BATCH)).to(self.dev)
            what = f"PGD-{PGD_STEPS} B={BATCH} bf16"

            def pgd_call(vcfg, model):
                pgd = self.make_pgd(entry, vcfg, normalize)
                return lambda: pgd(model, x, y, torch.Generator(self.dev).manual_seed(2))

            calls = {label: pgd_call(vcfg, model) for label, (vcfg, model) in runs.items()}
        for label, call in calls.items():
            wall_ms = cuda_ms(call, 2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            self.trace_summary(f"profile {name} ({label})", what, prof, wall_ms,
                               top=name in ("patch", "square", "yolo11-cls", "int8"))

    def trace_summary(self, head: str, what: str, prof, wall_ms: float, top: bool) -> None:
        """Print a profiler's device time by kernel group, the union of its
        kernel intervals against the unprofiled wall (the idle share), and
        with ``top`` the ten longest kernels by name: the package's
        ``tools/trace_table`` table."""
        table = self.trace_table.summarize(prof, wall_ms=wall_ms)
        check(table["intervals"] > 0, "the profiler recorded no device activity")
        for line in self.trace_table.lines(table, head, what, self.card, top=10 if top else 0):
            print(line, flush=True)

def main(argv=None) -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", choices=("google_vit", "swin", "convnext", "yolo11-cls", "train",
                                          "train_lora", "train_swin", "train_convnext", "patch",
                                          "square", "int8"),
                    default=None,
                    help="trace one warm PGD-10 call of this backbone (or one warm ViT-B training "
                         "step, fields off and on; or one warm step of each Swin-B or ConvNeXt-B "
                         "training run; or ViT-B patch training or Square queries; or ViT-B PGD-10 "
                         "in bf16 and W8A8) instead of the smoke run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    s = Smoke(torch.device("cuda", 0))
    s.device()
    s.build()
    if args.profile:
        s.profile(args.profile)
        return
    err_p = s.packed_vs_plain()
    err_w = s.window_vs_plain()
    err_d = s.dwconv_vs_plain()
    err_m = s.mlp_vs_plain()
    err_f = s.fused_mlp_vs_plain()
    err_a = s.attn_block_vs_plain()
    err_h = s.bhnd_vs_plain()
    s.dwconv_edges()
    s.ln_mlp_seeds()

    ka, kw, kd, km = s.ka, s.kw, s.kd, s.km
    vit_entry, vit_cfg, vit_model, vit_tree, vit_norm, vit_model_tree = s.model(
        "google_vit", s.vit, "attention_packed", ka.attention_packed_reference)
    vit_l, vit_pgd, vit_x, vit_y, _, _ = s.attack(
        "google_vit", vit_entry, vit_cfg, vit_model, vit_norm,
        {"fwd": (ka, "FWD_LAUNCHES"), "bwd": (ka, "BWD_LAUNCHES")},
        {"fwd": vit_cfg.depth * (PGD_STEPS + 1), "bwd": vit_cfg.depth * (PGD_STEPS + 1)})
    s.vit_fields(vit_entry, vit_cfg, vit_model_tree, vit_norm, vit_model)
    full_l = s.train_full(vit_entry, vit_tree, vit_norm)
    lora_l = s.train_lora(vit_entry, vit_tree, vit_norm)
    bhnd_l = s.attention_auto_entry()
    # the other attack families on the same model and batch, labelled by its
    # own clean predictions so that every example starts correctly classified
    with torch.no_grad():
        vit_logits = vit_entry.apply(vit_cfg, vit_model, vit_norm(s.common.to_unit_floats(vit_x)))
    own = vit_logits.argmax(-1)
    patch_ms = s.patch_family(vit_entry, vit_cfg, vit_model, vit_norm, vit_x, own)
    s.rp2_family(vit_entry, vit_cfg, vit_model, vit_norm, vit_x, vit_logits)
    aa_out = s.autoattack_family(vit_entry, vit_cfg, vit_model, vit_norm, vit_x, own)
    s.autoattack_stages(vit_entry, vit_cfg, vit_model, vit_norm, vit_x, own)

    swin_entry, swin_cfg, swin_model, swin_tree, swin_norm, swin_model_tree = s.model(
        "swin", s.swin, "window_attention", kw.window_attention_reference)
    blocks = sum(swin_cfg.depths)
    win_counters = {"fwd": (kw, "FWD_LAUNCHES"), "bwd": (kw, "BWD_LAUNCHES"),
                    "dbias": (kw, "DBIAS_CALLS")}
    swin_l, swin_pgd, swin_x, swin_y, adv_f, adv_p = s.attack(
        "swin", swin_entry, swin_cfg, swin_model, swin_norm, win_counters,
        {"fwd": blocks * (PGD_STEPS + 1), "bwd": blocks * (PGD_STEPS + 1), "dbias": 0})
    swin_compose_s = s.compose("swin", swin_entry, swin_cfg, swin_tree, swin_x, swin_y, adv_f,
                               adv_p, win_counters, {"fwd": blocks, "bwd": 0, "dbias": 0})
    swin_fused = s.swin_fused_mlp(swin_entry, swin_cfg, swin_model_tree, swin_norm, swin_model,
                                  win_counters)
    del swin_model_tree, adv_f, adv_p

    cnx_entry, cnx_cfg, cnx_model, cnx_tree, cnx_norm, cnx_model_tree = s.model(
        "convnext", kernel_fields=CONVNEXT_KERNELS)
    blocks = sum(cnx_cfg.depths)
    cnx_counters = {"dw_fwd": (kd, "FWD_LAUNCHES"), "dw_dx": (kd, "DX_LAUNCHES"),
                    "dw_dw": (kd, "DW_CALLS"), "mlp_fwd": (km, "FWD_LAUNCHES"),
                    "mlp_bwd": (km, "BWD_LAUNCHES"), "mlp_param_grads": (km, "PARAM_GRAD_CALLS")}
    per_step = blocks * (PGD_STEPS + 1)
    cnx_l, _, cnx_x, cnx_y, adv_f, adv_p = s.attack(
        "convnext", cnx_entry, cnx_cfg, cnx_model, cnx_norm, cnx_counters,
        {"dw_fwd": per_step, "dw_dx": per_step, "dw_dw": 0, "mlp_fwd": per_step,
         "mlp_bwd": per_step, "mlp_param_grads": 0})
    cnx_compose_s = s.compose(
        "convnext", cnx_entry, cnx_cfg, cnx_tree, cnx_x, cnx_y, adv_f, adv_p, cnx_counters,
        {"dw_fwd": blocks, "dw_dx": 0, "dw_dw": 0, "mlp_fwd": blocks, "mlp_bwd": 0,
         "mlp_param_grads": 0})
    del cnx_model, adv_f, adv_p

    # the fifth family, YOLO11-cls (no kernel of this repo: every count 0), the
    # pretrained-weight import, and training of Swin-B, ConvNeXt-B and YOLO11-cls
    zero = {k: 0 for k in s.all_counters()}
    (yolo_entry, yolo_cfg, yolo_model, yolo_tree, yolo_norm, _), yolo_l = s.counted(
        s.all_counters(), lambda: s.model("yolo11-cls"))
    check(yolo_l == zero, f"yolo11-cls model phase kernel counts {yolo_l}")
    s.imports(vit_tree, yolo_tree)
    _, yolo_pgd, yolo_x, yolo_y, adv_f, adv_p = s.attack(
        "yolo11-cls", yolo_entry, yolo_cfg, yolo_model, yolo_norm, s.all_counters(), zero)
    yolo_compose_s = s.compose("yolo11-cls", yolo_entry, yolo_cfg, yolo_tree, yolo_x, yolo_y,
                               adv_f, adv_p, s.all_counters(), zero)
    del adv_f, adv_p
    train_trees = {"swin": swin_tree, "convnext": cnx_tree, "yolo11-cls": yolo_tree}
    train_norms = {"swin": swin_norm, "convnext": cnx_norm, "yolo11-cls": yolo_norm}
    sw, cx = sum(swin_cfg.depths), sum(cnx_cfg.depths)
    # launches per step: the relative-position bias is trained in a full fine-tune
    # (its gradient recomputed) and frozen in LoRA; with factors on pwconv1/2 the
    # LN-fused MLP does not apply, and the first ConvNeXt block's input (the
    # frozen stem's output) asks no gradient; YOLO11 runs no kernel
    per_step = {("swin", "full"): {"win_fwd": sw, "win_bwd": sw, "win_dbias": sw},
                ("swin", "lora"): {"win_fwd": sw, "win_bwd": sw, "mlp_fwd": sw, "mlp_bwd": sw},
                ("convnext", "full"): {"dw_fwd": cx, "dw_dx": cx, "dw_dw": cx, "ln_mlp_fwd": cx,
                                       "ln_mlp_bwd": cx, "ln_mlp_param_grads": cx},
                ("convnext", "lora"): {"dw_fwd": cx, "dw_dx": cx - 1},
                ("yolo11-cls", "full"): {}, ("yolo11-cls", "lora"): {}}
    for name, kind, fields in TRAIN_RUNS:
        s.train_backbone(name, kind, fields, train_trees[name], train_norms[name],
                         per_step[(name, kind)])

    # 6. timing on the card
    for name, pgd, model, x, y in (("google_vit", vit_pgd, vit_model, vit_x, vit_y),
                                   ("swin", swin_pgd, swin_model, swin_x, swin_y)):
        pgd_ms = cuda_ms(lambda: pgd(model, x, y, torch.Generator(s.dev).manual_seed(2)), 3)
        print(f"phase 6 PGD-{PGD_STEPS} {name}+LoRA bf16 B={BATCH}: {pgd_ms:.2f} ms/batch, "
              f"{BATCH * 1000 / pgd_ms:.2f} images/s {s.card}", flush=True)
    f_pgd, f_model, f_x, f_y = swin_fused
    pgd_ms = cuda_ms(lambda: f_pgd(f_model, f_x, f_y, torch.Generator(s.dev).manual_seed(2)), 2)
    print(f"phase 6 PGD-{PGD_STEPS} swin+LoRA bf16 B={BATCH}, use_fused_mlp: {pgd_ms:.2f} "
          f"ms/batch, {BATCH * 1000 / pgd_ms:.2f} images/s {s.card}", flush=True)
    del swin_model, swin_pgd, swin_fused, f_pgd, f_model
    vit_ms = s.time_vit_pgd(vit_entry, vit_cfg, vit_model_tree, vit_norm, vit_x, vit_y)
    s.time_families(vit_entry, vit_cfg, vit_model, vit_norm, vit_x, own, patch_ms, aa_out)
    s.time_convnext_pgd(cnx_entry, cnx_cfg, cnx_model_tree, cnx_norm, cnx_x, cnx_y)
    s.time_training(vit_entry, vit_tree, vit_norm)
    pgd_ms = cuda_ms(lambda: yolo_pgd(yolo_model, yolo_x, yolo_y,
                                      torch.Generator(s.dev).manual_seed(2)), 3)
    print(f"phase 6 PGD-{PGD_STEPS} yolo11-cls+LoRA bf16 B={BATCH}: {pgd_ms:.2f} ms/batch, "
          f"{BATCH * 1000 / pgd_ms:.2f} images/s {s.card} (host-bound: see --profile yolo11-cls)",
          flush=True)
    s.time_backbone_training(train_trees, train_norms)
    # launches: the full fine-tune's for attn_block (its parameter gradients
    # too), the LoRA run's for the fused MLP, the entry point's for the
    # head-major kernel; the attack paths' counts are in the phase 5 lines
    kernels = (s.time_attention(vit_l) + s.time_window(swin_l) + s.time_dwconv(cnx_l)
               + s.time_mlp(cnx_l) + s.time_fused_mlp(lora_l) + s.time_attn_block(full_l)
               + s.time_bhnd(bhnd_l))
    for name, wall in (("swin", swin_compose_s), ("convnext", cnx_compose_s),
                       ("yolo11-cls", yolo_compose_s)):
        print(f"phase 6 eval-compose {name} 4x3 matrix (B={BATCH} per dataset): wall "
              f"{wall:.3f} s {s.card}", flush=True)

    # 7. the native codec, and the robustness study through the runner (a
    # fresh process per stage) with the attack stage once in this process
    s.codec()
    s.runner()
    # 8. the raw-corpus ETL on the card's host (no kernel)
    s.etl()
    # 9. the W8A8 attack path, its kernel gates, BiLoRA, the two example workflows
    s.int8_vs_cpu()
    qtree, qmodel, run_q = s.int8_pgd(vit_entry, vit_cfg, vit_model_tree, vit_norm, vit_model,
                                      vit_x, own)
    s.int8_gates(vit_entry, vit_cfg, qtree, qmodel, vit_norm, vit_x)
    s.int8_trace(run_q, qmodel)
    s.bilora_vs_cpu()
    s.demos()
    # 10. the data x model mesh: NCCL at world size 1, gloo over 4 ranks on the card, the dry run
    t10 = time.perf_counter()
    s.mesh_world1()
    tp_launches = s.mesh_gloo4()
    s.dryrun.dryrun_multichip(4, device="cuda")
    print(f"phase 10 (c) dryrun_multichip(4, device='cuda'): passed (4 ranks over gloo on one "
          f"card) {s.card}", flush=True)
    kernels += s.time_attention_tp(tp_launches)
    print(f"phase 10 wall {time.perf_counter() - t10:.1f} s {s.card}", flush=True)
    # 11. the bench entry as a user runs it, its other variants, the tools of <port>/tools/
    t11 = time.perf_counter()
    s.bench_entry(vit_ms["fields off"])
    s.bench_variants()
    s.bench_tools()
    print(f"phase 11 wall {time.perf_counter() - t11:.1f} s {s.card}", flush=True)

    errs = {"attention_packed_fwd": err_p["fwd"], "attention_packed_bwd": err_p["bwd"],
            "window_attention_fwd": err_w["fwd"], "window_attention_bwd": err_w["bwd"],
            "dwconv7_fwd": err_d["fwd"], "dwconv7_dx": err_d["dx"],
            "ln_mlp_fwd": err_m["fwd"], "ln_mlp_bwd": err_m["bwd"],
            "fused_mlp_fwd": err_f["fwd"], "fused_mlp_bwd": err_f["bwd"],
            "attn_block_fwd": err_a["fwd"], "attn_block_bwd": err_a["bwd"],
            "fused_attention_fwd": err_h["fwd"], "fused_attention_bwd": err_h["bwd"],
            **s.tp_errs}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    # composition_ms: where no one PyTorch call computes the function (library_ms null),
    # the time of the library calls composed to compute it; null for the other kernels
    rows = [{"composition_ms": None, **k, "max_abs_err": errs[k["name"]]} for k in kernels]
    print(json.dumps({"kernels": [{key: row[key] for key in (*keys, "composition_ms")}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
