#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. builds the hand-written kernels from kubernetes1_tpu_torch/csrc with nvcc,
   and prints what ptxas reported for the attention kernels (registers,
   spills) beside each one's shared memory and threads, and for the batch
   norm, GELU, LayerNorm, optimizer and RMSNorm kernels (registers, spills,
   shared memory);
2. holds each kernel, forward and backward, against its plain PyTorch
   version on the card, at the main paths' shapes (the decode server's
   B=8, S=1024 for the serving kernels; the train step's B=4, S=2048 and
   8192 x 14336 / 8192 x 128256 rows for the rest) and at a few odd small
   ones; a backward also against autograd of the plain forward, with the
   same upstream gradient; the RMSNorm backward also at each of its width
   classes and at llama_bench's 8192 x 2048, which is timed on a line of
   its own, as are 2048 and 16384 rows at d = 4096 (its fixed cost a
   launch and its streaming rate from the three).  It times the kernel,
   the plain version and (as a yardstick only) the one PyTorch call that
   computes the same function;
3. holds the forward built on the kernels against the forward built on the
   plain versions, at Llama-3-8B widths with 2 layers;
4. holds a train step's loss and every gradient on the kernels against
   those on the plain versions, at Llama-3-8B widths with 2 layers;
5. serves Llama-3-8B (all 32 layers, random weights from a seed) on 8 slots
   through DecodeServer: 12 concurrent HTTP requests, one streamed, and
   checks the tokens, the /metrics surface and the kernels' launches;
6. trains Llama-3-8B widths cut to 4 layers (1.92 B parameters, f32 master
   weights and AdamW, ~31 GB of state) for 5 steps on one fixed (4, 2049)
   batch through make_train_state / make_train_step, and checks the losses
   and every kernel's forward and backward launches per step; then profiles
   3 more steps for the device time a step by part (as in 16);
7. (ResNet-50, K8) holds the batch-norm kernels (statistics, apply with and
   without residual and ReLU, its ReLU mask, the backward reading that
   mask) against their plain versions at odd shapes and at four layers of
   batch 128: the stem's (128*112*112, 64), stage 1's bn3 (128*56*56, 256),
   stage 3's bn2 (128*14*14, 256) and stage 4's bn3 (128*7*7, 2048) rows,
   where each is timed; and the backward against autograd of the plain
   forward;
8. holds ResNet-50 on the kernels against the plain versions at batch
   8 x 224^2: the loss; the logits and every gradient against an f32 run,
   as close as the plain versions come; and each of the 53 batch-norm
   layers' kernels on the inputs that layer saw;
9. trains ResNet-50 (full width and depth, random weights from a seed) at
   batch 128 x 224^2 through the bench payload resnet_bench.run, checks the
   losses and the K8 launches per step, and profiles one more step for the
   batch-norm kernels' share of it, kernel by kernel, and for who launches
   the step's largest elementwise add and strided copy;
10. (BERT, K7a non-causal attention, K7b LayerNorm, K9 tanh-GELU, K5 over
   f32 logits) holds each of those kernels, forward and backward, against
   its plain version at BERT-large's shapes (B=32, S=512 and S=200; 16384
   rows of 1024, 4096 and 30522) and at odd small ones (the LayerNorm
   backward also at each of its width classes: 16389 x 768, 37 x 1032,
   4096 x 2048), and times them; and counts K9's SASS instructions an
   element (cuobjdump) against a copy of the same bytes;
11. holds a BERT train step's loss and every gradient on the kernels
   against those on the plain versions, at BERT-large widths with 2 layers
   and batch 2 x 512;
12. trains BERT-large (all 24 layers, remat, random weights from a seed) for
   5 AdamW steps on the fixed synthetic masked batch 32 x 512 through
   make_train_state / make_train_step, checks the losses and every new
   kernel's launches per step, counts the step's FLOPs and profiles one step;
13. (ring attention, K6) holds the ring's block, merge and accumulating
   block-backward kernels against their plain versions at Llama-3-8B's
   attention widths (a 2-rank ring's second rank by hand, blocks of 2048)
   and times them at blocks of 8192; then runs the attention backward
   (each backward pass is also held to its own plain version wherever the
   backward is checked) twice on the same inputs and asserts the same bits:
   causal at the Llama train shape, non-causal at BERT-large's, and a ring
   block pair accumulating into f32 buffers; so too K8's statistics and
   backward (stem, stage 4), K9's backward (BERT's d_ff), K7b's backward
   (16384 x 1024 and 4096 x 2048: dscale and dbias too) and K2's backward
   (8192 x 4096 and 8192 x 2048: dscale too);
14. runs ring attention's own steps for 8 virtual ranks x 8192 tokens
   (65,536 causal) and 4 x 2048 (non-causal) in lockstep on the card,
   forward and backward, against the dense kernels at the whole length,
   and ring_attention itself over a 1-rank NCCL group against K1, and
   checks the K6 launches of each ring;
15. (optimizer updates, K10 AdamW, K10b Adafactor, K10c SGD with momentum)
   holds each multi-tensor kernel against its plain version (optax's
   formula) over 3 steps on the llama_bench 1b-tpu preset's 1.12 B f32
   weights at full width, plus two leaves whose sizes are not multiples of
   4, and times each against its bound and against torch.optim's fused
   AdamW and SGD (SGD at ResNet-50's 25.6 M weights, its main path);
   Adafactor also with p read every step, for the bytes its carried sum
   of p^2 saves, with its five passes' device times, and over 5 steps with p.add_(0) before each (which makes
   it read p) against 5 without, bit for bit, with p.mul_(0.5) before the
   third step in both and in the plain version, which they must match;
16. runs the Llama bench payload llama_bench on the card: main() at the
   1b-tpu preset (22 layers, 4 x 2048, Adafactor, 10 steps), a batch sweep
   over 4, 6, 8 and 3-step AdamW and SGD runs, checking the losses, the
   JAX payload's result keys and every kernel's launches per step, and
   prints the profiled step's device time and, over 3 more steps, the
   device time a step by part (K10b, attention, cuBLAS, K2, the rest).
17. (data parallelism, K8 across ranks) holds K8's split entries (bn_sums,
   bn_fold, bn_bwd_sums, bn_bwd_dx) against their plain versions at the
   odd shapes and the four layers of 7., each at one rank bit for bit the
   one-launch kernels, and two halves of the rows with their sums added
   against the one-launch kernels on all of them; times them at the stem
   (this runs after 7.);
18. over a 1-rank NCCL group (FileStore in a temp dir), trains Llama-3-8B
   widths x 4 layers (4 x 2048), BERT-large (32 x 512) and ResNet-50
   (128 x 224^2) for 3 steps each through mesh=, bit for bit the same steps
   without a mesh from the same weights and batch and with their launches
   (one data rank issues no collective); then ResNet-50 with its batch
   norm forced onto the split kernels over that group, bit for bit again,
   and prints its extra time a step, the device's share of it (profiler)
   and the gradients' all-reduce alone: a one-card floor, not a multi-card
   figure;
19. runs 2 gloo ranks of this script on the one card (NCCL takes one rank a
   card): a ResNet-50 step on 32 x 224^2 images, 16 a rank, with the split
   K8 and a real all-reduce between its launches, held to the whole batch's
   step on one process (the loss; the gradients of the leaves nearest the
   loss) and the ranks' weights to each other, bit for bit, after two
   steps;
20. (parameter sharding, K5 over a vocab block) holds K5's partial entries
   (ktpu_xent_part_bf16 at 8192 x 64128, rank 1's half of Llama-3-8B's
   vocab; ktpu_xent_part_f32 at 16384 x 15261, half of BERT-large's, and
   each at the 4096 rows the sharded steps give it) against
   their plain twins, two blocks' parts combined against K5 over the whole
   vocab, and the one-block backward fed the global lse and the targets
   shifted to the block against its plain version; times the partials;
21. runs the whole model's first step (Llama-3-8B widths x 2 layers at
   2 x 2049, 1,486,901,248 parameters; BERT-large at 8 x 512) in a process
   of its own, then 2 gloo ranks of this script on the one card at tp=2 and
   then at fsdp=2 (and Llama without remat, whose autograd keeps each
   layer's gathered weights), each model's sharded step held to it (the
   loss; the gradients of a few leaves, gathered from the ranks' blocks), with every
   kernel's launches per step, each rank's parameter and state bytes
   (asserted to be the specs' share), its peak memory and step ms (gloo
   through the host, not a multi-card figure);
22. runs entry.dryrun_multichip(1) over NCCL (the sharded Llama and BERT
   steps and the ring on a one-rank mesh; more ranks take a card each).
The optimizer kernels are also the updates of phases 6, 9 and 12 (AdamW,
SGD, AdamW), whose launches per step are checked there.  The kernels' rows
carry their launches on each main path (``launches_<path>``; ``dp`` is
18.'s runs and rank 0's steps in 19., ``shard`` rank 0's steps in 21.) and
in all.

It exits non-zero, with no result line, when there is no CUDA device or a
phase fails.  The line before the last is the kernels' JSON; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from kubernetes1_tpu_torch import optim
from kubernetes1_tpu_torch.kernels import (attention, batchnorm, build, cross_entropy, gelu,
                                           layernorm, rmsnorm, rope, swiglu)
from kubernetes1_tpu_torch.kernels import optim as optim_kernels
from kubernetes1_tpu_torch.kernels import ringattention as ring_kernels
from kubernetes1_tpu_torch.workloads import (bert, benchguard, llama, llama_bench, resnet,
                                             resnet_bench, ringattention)

# A spin of ~25 ms at the H100's 1.98 GHz boost clock (time_ms).
SPIN_CYCLES = 50_000_000
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BF16_TENSOR = 989e12   # FLOP/s
PEAK_F32 = 67e12            # FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM bytes/s

# Tolerances of kernel vs plain version on the same bf16 inputs, as
# |kernel - plain| <= atol + rtol * |plain| on every element.
# RMSNorm, RoPE: the kernel sums squares (RMSNorm) or evaluates cos/sin/pow
# (RoPE) in another order or library than the plain version, so an f32
# intermediate may round to the neighbouring bf16 value; the output rounds
# twice (RMSNorm: before and after the scale), so two bf16 steps, 2^-6.
ELEMENTWISE_TOL = (1e-6, 2.0 ** -6)
# Attention: the kernel rounds the UNNORMALISED probabilities to bf16 for
# P.V and divides by the f32 row sum at the end; the plain version (JAX's
# order) rounds the normalised ones.  Each probability then differs by up
# to one bf16 step (2^-8 relative), which moves the output by at most
# 2^-8 * max|v| (~0.02 at |v| <= 5); the output's own rounding adds one
# step, 2^-7 relative.
ATTENTION_TOL = (3e-2, 2.0 ** -7)
# SwiGLU forward and backward, RoPE backward: as ELEMENTWISE_TOL (expf in
# another library may move an f32 intermediate across a bf16 rounding).
# Cross-entropy: the loss and lse in f32 sum 128256 exps in another order
# (and __expf is within 2 ulp), ~1e-6 relative on values ~12; its gradient
# (exp(x - lse) - onehot) * g rounds once to bf16, so one step, relative
# (the values are ~1e-5 and smaller, no absolute floor).
XENT_LOSS_TOL = (1e-4, 1e-5)
XENT_GRAD_TOL = (0.0, 2.0 ** -6)
# Attention and RMSNorm backward, relative L2 over each output: f32 sums
# in another order (the tensor cores' accumulation over a pass's tiles;
# dscale over 8192 rows) and, against autograd of the plain forward,
# the kernel's bf16 rounding of P and dS before their products (autograd
# keeps dS in f32): each element a step or two of 2^-8 away, 1e-2 is ~2.5.
BWD_REL_L2_TOL = 1e-2
# The K2 backward's width classes (csrc/rmsnorm.cu), each against its plain
# version and autograd at BWD_REL_L2_TOL: one warp a row (d = 8; d = 1024
# with rows no multiple of a stage's 16), a group of 5 warps (4104: three
# groups, 15 consumer warps), 16 warps (16384) and the wide kernel above
# it; llama_bench's width, 8192 x 2048, is checked and timed apart.
RMS_WIDTH_CLASSES = ((37, 8), (16389, 1024), (37, 4104), (513, 16384), (300, 16392))
RMS_BENCH_D = 2048  # llama_bench's 1b-tpu d_model
RMS_SCALING_ROWS = (2048, 16384)  # the K2 backward timed at d = 4096 beside 8192 rows
# Forward, kernels vs plain, relative L2 error of the logits: each of the
# four kernels in each of the 2 layers may round an element one bf16 step
# (2^-8 relative) away from its plain version; 2e-2 is five such steps.
FORWARD_REL_L2_TOL = 2e-2
# Train step, kernels vs plain, 2 layers: the loss within 1e-2 (the bf16
# logits' rounding differences average out over 1026 rows); each gradient
# within 5e-2 relative L2: the backward chains ten kernels per layer, each
# a step or two of 2^-8 from its plain version.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_REL_L2_TOL = 5e-2

SERVE_SLOTS = 8
SERVE_REQUESTS = 12
SERVE_MAX_NEW = 8

TRAIN_LAYERS = 4        # Llama-3-8B widths; 32 layers of f32 + AdamW state do not fit
TRAIN_BATCH, TRAIN_SEQ = 4, 2048  # llama_bench.py's defaults; tokens are (4, 2049)
TRAIN_STEPS = 5

# Batch norm (K8), kernel vs plain on the same bf16 inputs.
# Statistics: f32 sums in another order (per-thread, per-block, then over
# the partials) and rsqrtf (2 ulp) move f32 mean/rstd/inv by ~1e-6
# relative; w and b round that to bf16, where a value next to a rounding
# boundary lands one step (at most 2^-7 relative) away; b = bias - mean*inv
# may cancel, hence the absolute floor.
BN_STATS_TOL = (1e-5, 2.0 ** -7)
# Apply, |kernel - plain| <= BN_APPLY_RTOL * (|x*w| + |b| + |r|): the plain
# version rounds three times (x*w, +b, +r; the ReLU is exact), the kernel
# once, each rounding by at most half a bf16 step, which is at most 2^-8 of
# the value rounded, itself no larger than that sum: 4 * 2^-8 = 2^-6.
BN_APPLY_RTOL = 2.0 ** -6
# Backward vs its plain version, and vs autograd of the plain forward
# (relative L2 of each output): BWD_REL_L2_TOL, as for the other backward
# kernels; autograd rounds dy*w and the bf16 sums of d_w and d_b that the
# kernel keeps in f32, each ~2^-9 relative.
# Against autograd, the plain forward runs up to the ReLU and takes dy
# masked by the kernel's output (as bwd_plain does): where the
# pre-activation is within a rounding of 0 the two forwards may disagree on
# the sign, and each such element moves dx by a whole dy*w, a difference of
# the forward's rounding that the apply check already bounds.
# Autograd of the plain forward is a reference only from a few rows up: it
# sums d_w and d_b in bf16, and d_inv = d_w - d_b*mean cancels to 0 as the
# rows shrink to one (a single row has x = mean), leaving bf16 rounding
# noise in dscale and dx; the kernel's f32 sums give the exact 0 there.
BN_AUTOGRAD_MIN_ROWS = 8
# ResNet-50, kernels vs plain (batch 8 x 224^2, random weights).  The loss
# within 5e-2 (the JAX suite's bf16 loss bar).  Logits and gradients are no
# test of the kernels one against the other: random-init ResNet-50 in bf16
# is chaotic, each path about as far from an f32 run as from the other (on
# an H100 at batch 8 x 224^2: kernels vs plain, logits 0.117 relative L2
# and gradients a median 1.32; against f32, logits 0.109 and 0.120,
# gradients a median 1.307 and 1.316).  Each bf16 rounding flips ReLU masks and batch norm's
# backward projects most of dy out, leaving rounding noise.  So each path
# is held to the f32 run of the plain versions, and the kernels must be
# within RESNET_ACCURACY_RATIO of the plain versions' distance to it; and
# each of the 53 layers' kernels is held to the plain versions on the very
# inputs and upstream gradient that layer saw (check_bn's tolerances),
# which is where a wiring fault would show.
RESNET_LOSS_TOL = 5e-2
RESNET_ACCURACY_RATIO = 1.5
RESNET_CHECK_BATCH = 8
RESNET_BATCH, RESNET_SIZE = 128, 224  # resnet_bench.py's defaults
RESNET_STEPS, RESNET_WARMUP = 20, 2  # resnet_bench.py's default --steps
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd")
# K8's split entries (data parallelism), each against its plain version on
# the same inputs: the sums (Σx, Σx²; Σdy', Σdy'·x) are f32 sums of the same
# values in another order, each channel within BN_SUMS_RTOL of the sum of
# the terms' magnitudes (a run of ~1,600 sequential f32 adds a thread, then
# fixed trees: ~√1600 · 2^-24 ≈ 2.4e-6 as a random walk); the fold as the
# statistics (BN_STATS_TOL), dscale, dbias, dx and dr as the backward
# (BWD_REL_L2_TOL).  At one rank each entry must give the one-launch
# kernels' bits (the same partials, order and per-channel code).
BN_SUMS_RTOL = 1e-5
BN_SPLIT_KERNELS = ("bn_sums", "bn_fold", "bn_bwd_sums", "bn_bwd_dx")
# Data parallelism on the card.  World 1 over NCCL: DP_STEPS steps of each
# train path at its main path's size through mesh=, bit for bit the steps
# without a mesh from the same weights and batch (and ResNet-50's again
# with its batch norm forced onto the split kernels).  Two gloo ranks on
# the one card (NCCL takes one rank a card):
# - the last batch-norm layer (stage 4's bn3, ReLU and residual, at
#   DP2_BATCH images) through batchnorm(group=), forward and backward, each
#   rank on its half of the rows: the rows' y, dx and dr and the ranks'
#   dscale and dbias summed, within BWD_REL_L2_TOL of the one-launch
#   kernels on all the rows (the sums differ only in order);
# - a ResNet-50 step on DP2_BATCH images (16 a rank) against the whole
#   batch on one process: the loss within RESNET_LOSS_TOL, and the first
#   step's gradients of the head's leaves within DP2_GRAD_TOL relative L2
#   of the whole batch's.  The two runs differ only in the order of the
#   batch statistics' sums and of the gradients' average, which bf16
#   ResNet-50 at random weights spreads through the layers (see
#   RESNET_ACCURACY_RATIO): on an H100 the head read 4.3e-2 (w) and
#   1.4e-3 (b), the last block's conv3 already 0.47 and its bn3 scale 0.14.
#   The phase also shows that rank 0's rows alone, halved gradients and
#   zero gradients each exceed DP2_GRAD_TOL.
DP_STEPS = 3
DP2_RANKS, DP2_BATCH = 2, 32
DP2_GRAD_TOL = 0.1

# Parameter sharding.  K5's partial entries hold to their plain twins at
# XENT_LOSS_TOL (the same row loop as the forward kernel); two blocks' parts
# combined (the log-sum-exp of their lse, the sum of their target logits)
# meet K5's plain version over the whole vocab at XENT_LOSS_TOL; the
# one-block backward fed the global lse and shifted targets holds to its
# plain version at XENT_GRAD_TOL (bf16) and XENT_F32_GRAD_TOL (f32).
# The gloo ranks' sharded steps against the whole model's: the first step's
# loss within TRAIN_LOSS_TOL (Llama) and BERT_LOSS_TOL, and the first
# SHARD2_HELD_NUMEL elements of each held leaf's gradient within
# SHARD2_GRAD_TOL relative L2: over tp the bf16 products are summed in
# another order (the partial sums of wo, w_down and w_out, added in bf16)
# and the vocab's lse is combined over two blocks, over fsdp the batch's
# rows are split, and 2 (Llama) or 24 (BERT) bf16 layers carry those
# roundings to the gradients; halved and zero gradients must exceed it.
SHARD_LAYERS = 2              # Llama-3-8B widths: 1,486,901,248 parameters
SHARD2_MESHES = ((1, 1, 2), (1, 2, 1))
SHARD2_STEPS = 2
SHARD2_LLAMA_BATCH, SHARD2_BERT_BATCH = 2, 8
SHARD2_GRAD_TOL = 5e-2
SHARD2_HELD_NUMEL = 1 << 22
SHARD2_HELD = {
    "llama": (("unembed",), ("final_norm",), ("layers", 0, "wq"), ("layers", 0, "attn_norm"),
              ("layers", -1, "w_down")),
    "bert": (("embed",), ("mlm_dense",), ("mlm_bias",), ("layers", 0, "wq"),
             ("layers", -1, "w_out")),
}

# BERT (K7a, K7b, K9, K5 over f32 logits), kernel vs plain on the same inputs.
# Non-causal attention: ATTENTION_TOL forward, BWD_REL_L2_TOL backward, for
# the reasons given there (the mask changes which keys count, not how).
# LayerNorm forward: the kernel and the plain version round the same f32
# value once, but take the row's sums in another order (~1e-7 relative in
# mu and r), so an output next to a rounding boundary lands one bf16 step
# away (at most 2^-7 relative); outputs near 0 (bias cancelling) get an
# absolute floor for that f32 noise.  Backward: BWD_REL_L2_TOL.
LN_TOL = (1e-5, 2.0 ** -7)
# The backward kernel's other width classes, each against the plain
# version: 3 chunks of 256 columns (BERT-base's 768, rows not a multiple
# of a block's), the shared-memory path just above 1024 and at 2048.
LN_WIDTH_CLASSES = ((16389, 768), (37, 1032), (4096, 2048))
# GELU forward and backward, kernel vs plain: both compute the same f32
# expression with the same tanhf and no FMA contraction, then round once,
# so they must be equal bit for bit (0 bf16 steps).  Backward vs autograd
# of the plain forward: autograd sums the chain rule's terms in another
# f32 order, so the rounded result may land one bf16 step away (2^-7
# relative at most), and near the derivative's zero (x ~ -0.75) the
# terms (~|dy|) cancel, leaving their f32 error: 1e-6 absolute.
GELU_TOL = (0.0, 0.0)
GELU_VJP_TOL = (1e-6, 2.0 ** -7)
# Cross-entropy over f32 logits: loss and lse as XENT_LOSS_TOL (30522 exps
# summed in another order); the f32 gradient is not rounded, so it differs
# only by __expf against expf and the lse's last bits: 1e-5 relative, with
# an absolute floor of 1e-7 for entries near 0.
XENT_F32_GRAD_TOL = (1e-7, 1e-5)
# Train step, kernels vs plain, BERT-large widths, 2 layers, batch 2 x 512:
# the loss within 1e-2 (its ~150 masked rows average the bf16 logits'
# rounding differences); each gradient within 5e-2 relative L2 (as
# TRAIN_GRAD_REL_L2_TOL: each layer's backward chains eight kernels, each a
# step or two of 2^-8 from its plain version).
BERT_LOSS_TOL = 1e-2
BERT_GRAD_REL_L2_TOL = 5e-2
BERT_CHECK_LAYERS, BERT_CHECK_BATCH = 2, 2
BERT_BATCH, BERT_SEQ = 32, 512  # 16,384 tokens; BERT pretraining phase 2's length
BERT_STEPS, BERT_LR = 5, 1e-4
# Ring attention (K6), Llama-3-8B's attention widths (H 32, Hkv 8, hd 128).
# The block kernels against block_attn_plain: ATTENTION_TOL and the lse's
# (1e-4, 1e-5), as K1 (the same kernels).  The merge against merge_plain:
# f32 arithmetic with expf/logf against torch's exp/log, so each element
# within MERGE_RTOL of the sum of the two terms' magnitudes (a relative
# bar that cancellation between the terms cannot break) and the lse within
# MERGE_RTOL relative.  The backward: BWD_REL_L2_TOL.  A whole ring against
# the dense kernel at the full length: the output within RING_OUT_TOL (max
# abs, relative L2; the bars K1 meets against its plain version), each
# gradient within RING_GRAD_REL_L2_TOL relative L2 (two backward kernels'
# bf16 roundings of P and dS, each within BWD_REL_L2_TOL of the truth).
MERGE_RTOL = 1e-6
RING_OUT_TOL = (3.2e-2, 1e-2)
RING_GRAD_REL_L2_TOL = 2e-2
RING_BLOCK = 8192            # llama_3_8b().max_seq: one rank's block in the ring phase
RING_RANKS = 8               # one 8-GPU host: 65,536 tokens of causal context
RING_NC_RANKS, RING_NC_BLOCK = 4, 2048
# Optimizer updates (K10, K10b, K10c), kernel vs plain version after
# OPTIM_STEPS steps on the same f32 weights and gradients, on every element
# |kernel - plain| <= atol + rtol |plain|: the kernels' f32 arithmetic may
# be contracted into FMAs where the plain version rounds each op (an ulp or
# two, 2^-23 relative each, per op of a step), and Adafactor's means and
# sums over up to 254 M elements run in another order (~1e-6 relative in
# its statistics and scales); the absolute floor covers values that cancel
# towards 0 (a momentum whose gradient changed sign), whose error is an ulp
# of the terms (~1e-7 at |g| ~ 1).
OPTIM_TOL = (1e-6, 1e-5)
OPTIM_STEPS = 3
# K10b's carried sum of p^2: steps of the bit check, and the step before
# which p is edited (p.mul_(0.5)) in every run of it
CARRY_STEPS, CARRY_EDIT_STEP = 5, 2
OPTIM_LR = 3e-4          # llama_bench.py's default learning rate
BENCH_PRESET, BENCH_BATCH, BENCH_SEQ, BENCH_STEPS = "1b-tpu", 4, 2048, 10  # its defaults
BENCH_WARMUP = 2         # llama_bench.run's default
BENCH_SWEEP, BENCH_PROBE_STEPS, BENCH_SWEEP_STEPS = (4, 6, 8), 3, 5
BENCH_SHORT_STEPS = 3    # the AdamW and SGD runs
# what llama_bench.run returns: the JAX payload's keys (its llama_bench.py:170-193)
BENCH_KEYS = {"workload", "device_kind", "platform", "n_devices", "device_granularity",
              "params_matmul", "batch", "seq", "steps", "optimizer", "remat", "compile_s",
              "step_time_ms", "tokens_per_sec", "tokens_per_sec_per_device",
              "model_flops_per_step", "exec_flops_per_step", "peak_flops_per_device", "mfu",
              "hfu", "final_loss", "profile"}
BERT_KERNELS = ("attention_noncausal", "attention_noncausal_bwd", "layernorm", "layernorm_bwd",
                "gelu", "gelu_bwd", "cross_entropy_f32", "cross_entropy_f32_bwd")

# Every launch counter, by name: the forward kernels, then the backward ones.
KERNELS = {
    "attention": attention.KERNEL, "rmsnorm": rmsnorm.KERNEL, "rope": rope.KERNEL,
    "swiglu": swiglu.KERNEL, "cross_entropy": cross_entropy.KERNEL,
    "attention_bwd": attention.KERNEL_BWD, "rmsnorm_bwd": rmsnorm.KERNEL_BWD,
    "rope_bwd": rope.KERNEL_BWD, "swiglu_bwd": swiglu.KERNEL_BWD,
    "cross_entropy_bwd": cross_entropy.KERNEL_BWD,
    "bn_stats": batchnorm.KERNEL_STATS, "bn_apply": batchnorm.KERNEL_APPLY,
    "bn_bwd": batchnorm.KERNEL_BWD,
    "bn_sums": batchnorm.KERNEL_SUMS, "bn_fold": batchnorm.KERNEL_FOLD,
    "bn_bwd_sums": batchnorm.KERNEL_BWD_SUMS, "bn_bwd_dx": batchnorm.KERNEL_BWD_DX,
    "attention_noncausal": attention.KERNEL_NC, "attention_noncausal_bwd": attention.KERNEL_BWD_NC,
    "layernorm": layernorm.KERNEL, "layernorm_bwd": layernorm.KERNEL_BWD,
    "gelu": gelu.KERNEL, "gelu_bwd": gelu.KERNEL_BWD,
    "cross_entropy_f32": cross_entropy.KERNEL_F32,
    "cross_entropy_f32_bwd": cross_entropy.KERNEL_BWD_F32,
    "ring_block": ring_kernels.RING_BLOCK, "ring_block_nc": ring_kernels.RING_BLOCK_NC,
    "ring_merge": ring_kernels.RING_MERGE, "ring_block_bwd": ring_kernels.RING_BLOCK_BWD,
    "ring_block_bwd_nc": ring_kernels.RING_BLOCK_BWD_NC,
    "adamw": optim_kernels.KERNEL_ADAMW, "adafactor": optim_kernels.KERNEL_ADAFACTOR,
    "sgdm": optim_kernels.KERNEL_SGDM,
    "cross_entropy_part": cross_entropy.KERNEL_PART,
    "cross_entropy_part_f32": cross_entropy.KERNEL_PART_F32,
}


def serve_launches_per_step(L: int) -> dict:
    return {"attention": L, "rmsnorm": 2 * L + 1, "rope": L, "swiglu": L}


def train_launches_per_step(L: int) -> dict:
    """One train step with L layers under remat "save_attn": each layer's
    two checkpointed halves recompute in backward until what backward
    needs exists again (RoPE's output is the attention's own saved input,
    so RoPE does not rerun); attention runs once.  tests/test_torch_train.py
    asserts the same counts on the CPU with the kernels' plain twins."""
    return {"attention": L, "attention_bwd": L, "rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1,
            "rope": L, "rope_bwd": L, "swiglu": 2 * L, "swiglu_bwd": L,
            "cross_entropy": 1, "cross_entropy_bwd": 1, "adamw": 1}


def bench_launches_per_step(L: int, optimizer: str) -> dict:
    """One llama_bench step: the Llama train step's kernels and the named
    optimizer's one update (its launch counter has the optimizer's name)."""
    per_step = {k: v for k, v in train_launches_per_step(L).items() if k != "adamw"}
    return {**per_step, optimizer: 1}


def resnet_launches_per_step(n_bn: int) -> dict:
    """One ResNet-50 step: each batch-norm kernel once per layer, the
    cross-entropy over the f32 logits forward and backward, one SGD
    update."""
    return {**{name: n_bn for name in BN_KERNELS}, "cross_entropy_f32": 1,
            "cross_entropy_f32_bwd": 1, "sgdm": 1}


def dp_resnet_launches_per_step(n_bn: int) -> dict:
    """One ResNet-50 step over a mesh: batch norm's split kernels and the
    apply once per layer, the rest as without a mesh."""
    return {**{name: n_bn for name in BN_SPLIT_KERNELS + ("bn_apply",)},
            "cross_entropy_f32": 1, "cross_entropy_f32_bwd": 1, "sgdm": 1}


def bert_launches_per_step(L: int) -> dict:
    """One BERT train step with L layers under full remat (JAX's
    jax.checkpoint on the whole layer): each layer's forward runs again in
    backward, so attention and its GELU twice and both its LayerNorms
    twice; the final LayerNorm and the head's GELU once.
    tests/test_torch_bert.py asserts the same counts on the CPU with the
    kernels' plain twins."""
    return {"attention_noncausal": 2 * L, "attention_noncausal_bwd": L,
            "layernorm": 4 * L + 1, "layernorm_bwd": 2 * L + 1,
            "gelu": 2 * L + 1, "gelu_bwd": L + 1,
            "cross_entropy_f32": 1, "cross_entropy_f32_bwd": 1, "adamw": 1}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, back_to_back: bool = True) -> float:
    """Mean time of one call, CUDA events around `iters` calls.

    back_to_back: the calls queue behind a spin kernel of ~25 ms, so the
    host has enqueued them all before the first one starts and the device
    runs them back to back: the device time, whatever the host's per-call
    cost.  Without it the events also take in the host's cost wherever it
    exceeds the device's (the bucket-8 call floor, the serving step)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if back_to_back:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name: str, got, want, tol) -> float:
    """Max abs error over all outputs; fail beyond atol + rtol*|want|."""
    atol, rtol = tol
    worst = 0.0
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        err = (g - w).abs()
        if not bool((err <= atol + rtol * w.abs()).all()):
            fail(f"{name}: max abs err {err.max().item():.3e} beyond atol {atol} rtol {rtol}")
        worst = max(worst, err.max().item())
    return worst


def check_rel_l2(name: str, got, want, tol: float) -> float:
    """Max abs error over all outputs; fail if any output's relative L2
    error exceeds tol."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        torch.cuda.synchronize()
        g, w = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            fail(f"{name}[{i}]: shape {tuple(g.shape)} vs {tuple(w.shape)} or non-finite output")
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        if not rel <= tol:
            fail(f"{name}[{i}]: relative L2 error {rel:.3e} beyond {tol}")
        worst = max(worst, (g - w).abs().max().item())
    return worst


def bf16(shape, gen, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(torch.bfloat16)


def plain_vjp(fn, inputs, cotangents):
    """Gradients of the plain forward by autograd, for the same upstream
    gradient the backward kernel gets."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, cotangents)


def library_bwd_ms(fn, inputs, cotangents=None) -> float:
    """Time of the library call's backward alone (its graph kept)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, cotangents, retain_graph=True), 5, 1)


def print_row(r):
    print(f"kernel {r['name']} ({r['shape']}): max_abs_err={r['max_abs_err']:.3e} "
          f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']} "
          f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)


def row(name, source, replaces, shape, err, ms, plain_ms, bound, library_ms,
        jax_file="llama.py"):
    return dict(name=name, route="cuda", source=f"kubernetes1_tpu_torch/csrc/{source}",
                replaces=f"kubernetes1_tpu/workloads/{jax_file}:{replaces}", shape=shape,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms)


def kernel_phase(dev, gen) -> tuple:
    """Each kernel, forward and backward, against its plain version; times
    at the main paths' shapes.  Returns the kernels' rows and the attention
    forward's time at the train step's shape."""
    cfg = llama.llama_3_8b()
    theta = cfg.rope_theta
    # small odd shapes: tails of the 64-row tiles, every head_dim, GQA 1..4
    for B, S, H, Hkv, hd in ((2, 37, 4, 2, 16), (1, 100, 8, 2, 64), (3, 130, 4, 1, 32),
                             (2, 8, 32, 8, 128), (1, 65, 8, 8, 128)):
        shape = (B, S, H, Hkv, hd)
        q, k, v = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv))
        check_close(f"attention {shape}", [attention.attention(q, k, v)],
                    [attention.attention_plain(q, k, v)], ATTENTION_TOL)
        check_close(f"rope {shape}", rope.rope(q, k, theta),
                    rope.rope_plain(q, k, theta), ELEMENTWISE_TOL)
        x, sc = bf16((B * S, H * hd), gen, dev), bf16((H * hd,), gen, dev, 0.1, 1.0)
        check_close(f"rmsnorm {B * S, H * hd}", [rmsnorm.rmsnorm(x, sc)],
                    [rmsnorm.rmsnorm_plain(x, sc)], ELEMENTWISE_TOL)
        check_attention_bwd(f"attention_bwd {shape}", q, k, v, bf16(q.shape, gen, dev))
        check_rope_bwd(f"rope_bwd {shape}", q, k, theta)
        check_rmsnorm_bwd(f"rmsnorm_bwd {B * S, H * hd}", x, sc, bf16(x.shape, gen, dev))
    for rows, d in RMS_WIDTH_CLASSES:
        x, sc = bf16((rows, d), gen, dev), bf16((d,), gen, dev, 0.1, 1.0)
        check_rmsnorm_bwd(f"rmsnorm_bwd {rows, d}", x, sc, bf16(x.shape, gen, dev))
    for rows, n in ((37, 24), (3, 40), (5, 1000)):
        g, u = bf16((rows, n), gen, dev, 2.0), bf16((rows, n), gen, dev)
        check_close(f"swiglu {rows, n}", [swiglu.swiglu(g, u)], [swiglu.swiglu_plain(g, u)],
                    ELEMENTWISE_TOL)
        check_swiglu_bwd(f"swiglu_bwd {rows, n}", g, u, bf16((rows, n), gen, dev))
    for rows, vocab in ((37, 1003), (16, 50257), (5, 1000)):  # odd vocab: scalar loads
        logits = bf16((rows, vocab), gen, dev, 3.0)
        t = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        check_xent(f"cross_entropy {rows, vocab}", logits, t,
                   torch.randn(rows, generator=gen, device=dev))

    out = []
    # ---- the serving kernels at the decode server's largest bucket (PR 1's rows)
    B, S, H, Hkv, hd = 8, 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows, d = B * S, cfg.d_model
    q, k, v = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv))
    x, sc = bf16((rows, d), gen, dev), bf16((d,), gen, dev, 0.1, 1.0)
    serve_shape = f"B={B} S={S} H={H} Hkv={Hkv} hd={hd}"

    err = check_close("attention 8B", [attention.attention(q, k, v)],
                      [attention.attention_plain(q, k, v)], ATTENTION_TOL)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pairs = S * (S + 1) / 2  # unmasked (query, key) pairs per head
    out.append(row("attention", "attention.cu", 144, serve_shape, err,
                   time_ms(lambda: attention.attention(q, k, v)),
                   time_ms(lambda: attention.attention_plain(q, k, v), iters=5),
                   bound_ms(2 * (2 * q.numel() + 2 * k.numel()), 4 * B * H * hd * pairs,
                            PEAK_BF16_TENSOR),
                   time_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True))))

    err = check_close("rmsnorm 8B", [rmsnorm.rmsnorm(x, sc)], [rmsnorm.rmsnorm_plain(x, sc)],
                      ELEMENTWISE_TOL)
    out.append(row("rmsnorm", "rmsnorm.cu", 128, f"rows={rows} d={d}", err,
                   time_ms(lambda: rmsnorm.rmsnorm(x, sc)),
                   time_ms(lambda: rmsnorm.rmsnorm_plain(x, sc)),
                   bound_ms(2 * (2 * x.numel() + sc.numel()), 4 * x.numel(), PEAK_F32),
                   time_ms(lambda: F.rms_norm(x, (d,), sc, 1e-5))))

    err = check_close("rope 8B", rope.rope(q, k, theta), rope.rope_plain(q, k, theta),
                      ELEMENTWISE_TOL)
    n = q.numel() + k.numel()
    out.append(row("rope", "rope.cu", 133, serve_shape, err,
                   time_ms(lambda: rope.rope(q, k, theta)),
                   time_ms(lambda: rope.rope_plain(q, k, theta)),
                   bound_ms(2 * 2 * n, 3 * n, PEAK_F32),  # 6 flops per rotated pair
                   None))
    # the smallest bucket the engine steps at (8 slots x 8 tokens): the
    # time per call there is the wrapper's host cost, not the kernel's
    q8, k8, x8 = q[:, :8].contiguous(), k[:, :8].contiguous(), x[:64].contiguous()
    floor = partial(time_ms, back_to_back=False)
    print("bucket-8 call floor ms: "
          f"attention={floor(lambda: attention.attention(q8, k8, k8)):.4f} "
          f"rmsnorm={floor(lambda: rmsnorm.rmsnorm(x8, sc)):.4f} "
          f"rope={floor(lambda: rope.rope(q8, k8, theta)):.4f} "
          f"swiglu={floor(lambda: swiglu.swiglu(x8, x8)):.4f}", flush=True)
    del q, k, v, qt, kt, vt, q8, k8, x8

    # ---- SwiGLU on the (8192, 14336) GEMM outputs (serving at bucket 1024 and training)
    g, u = bf16((rows, cfg.d_ff), gen, dev, 2.0), bf16((rows, cfg.d_ff), gen, dev)
    dy = bf16(g.shape, gen, dev)
    m = g.numel()
    err = check_close("swiglu 8B", [swiglu.swiglu(g, u)], [swiglu.swiglu_plain(g, u)],
                      ELEMENTWISE_TOL)
    out.append(row("swiglu", "swiglu.cu", "166-168", f"rows={rows} d_ff={cfg.d_ff}", err,
                   time_ms(lambda: swiglu.swiglu(g, u)),
                   time_ms(lambda: swiglu.swiglu_plain(g, u)),
                   bound_ms(2 * 3 * m, 5 * m, PEAK_F32), None))
    err = check_swiglu_bwd("swiglu_bwd 8B", g, u, dy)
    out.append(row("swiglu_bwd", "swiglu.cu", "166-168", f"rows={rows} d_ff={cfg.d_ff}", err,
                   time_ms(lambda: swiglu.swiglu_bwd_kernel(g, u, dy)),
                   time_ms(lambda: swiglu.swiglu_bwd_plain(g, u, dy)),
                   bound_ms(2 * 5 * m, 12 * m, PEAK_F32), None))
    del g, u, dy

    # ---- the train step's shapes: B=4, S=2048
    B, S = TRAIN_BATCH, TRAIN_SEQ
    rows = B * S
    train_shape = f"B={B} S={S} H={H} Hkv={Hkv} hd={hd}"
    q, k, v = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv))
    do = bf16(q.shape, gen, dev)
    attn_train_ms = time_ms(lambda: attention.attention_kernel(q, k, v, True))
    print(f"attention forward with lse at the train shape ({train_shape}): "
          f"ms={attn_train_ms:.4f}", flush=True)
    err = check_attention_bwd("attention_bwd 8B", q, k, v, do)
    o, lse = attention.attention_kernel(q, k, v, with_lse=True)
    pairs = S * (S + 1) / 2
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    out.append(row("attention_bwd", "attention.cu", 144, train_shape, err,
                   time_ms(lambda: attention.attention_bwd_kernel(q, k, v, o, lse, do), 10, 2),
                   time_ms(lambda: attention.attention_bwd_plain(q, k, v, o, lse, do), 3, 1),
                   bound_ms(2 * (4 * q.numel() + 4 * k.numel()), 10 * B * H * hd * pairs,
                            PEAK_BF16_TENSOR),
                   library_bwd_ms(lambda a, b, c: F.scaled_dot_product_attention(
                       a, b, c, is_causal=True, enable_gqa=True), [qt, kt, vt], [dot])))
    del o, lse, qt, kt, vt, dot

    dq, dk = bf16(q.shape, gen, dev), bf16(k.shape, gen, dev)
    err = check_rope_bwd("rope_bwd 8B", dq, dk, theta)
    n = q.numel() + k.numel()
    out.append(row("rope_bwd", "rope.cu", 133, train_shape, err,
                   time_ms(lambda: rope.rope_kernel(dq, dk, theta, inverse=True)),
                   time_ms(lambda: rope.rope_bwd_plain(dq, dk, theta)),
                   bound_ms(2 * 2 * n, 3 * n, PEAK_F32), None))
    del q, k, v, do, dq, dk

    out.append(rmsnorm_bwd_row(rows, d, gen, dev))
    print_row(rmsnorm_bwd_row(rows, RMS_BENCH_D, gen, dev))  # llama_bench's width
    rmsnorm_bwd_scaling(rows, d, out[-1]["ms"], gen, dev)

    logits = bf16((rows, cfg.vocab), gen, dev, 2.0)
    t = torch.randint(0, cfg.vocab, (rows,), generator=gen, device=dev)
    grad = torch.full((rows,), 1.0 / rows, device=dev)
    errs = check_xent("cross_entropy 8B", logits, t, torch.randn(rows, generator=gen, device=dev))
    loss, lse = cross_entropy.cross_entropy_kernel(logits, t)
    vshape = f"rows={rows} vocab={cfg.vocab}"
    m = logits.numel()
    out.append(row("cross_entropy", "cross_entropy.cu", "196-202", vshape, errs[0],
                   time_ms(lambda: cross_entropy.cross_entropy_kernel(logits, t)),
                   time_ms(lambda: cross_entropy.cross_entropy_plain(logits, t), 5, 1),
                   bound_ms(2 * m + 8 * rows + 8 * rows, 4 * m, PEAK_F32),
                   time_ms(lambda: F.cross_entropy(logits, t, reduction="none"), 5, 1)))
    scratch = torch.empty_like(logits)
    out.append(row("cross_entropy_bwd", "cross_entropy.cu", "196-202", vshape, errs[1],
                   time_ms(lambda: cross_entropy.cross_entropy_bwd_kernel(
                       logits, t, lse, grad, out=scratch)),
                   time_ms(lambda: cross_entropy.cross_entropy_bwd_plain(logits, t, lse, grad),
                           5, 1),
                   bound_ms(2 * 2 * m + 16 * rows, 4 * m, PEAK_F32),
                   library_bwd_ms(lambda a: F.cross_entropy(a, t), [logits])))
    del logits, scratch, loss, lse

    for r in out:
        print_row(r)
    return out, attn_train_ms


def check_bwd_passes(name, q, k, v, o, lse, do, got, causal) -> float:
    """Each backward pass kernel against its plain version on the same
    lse and D: the dK/dV pass's dk, dv and the dQ pass's dq (BWD_REL_L2_TOL,
    relative L2 of each, rounded as the kernels store them)."""
    delta = attention.delta_plain(o, do)
    dk, dv = attention.attention_bwd_dkdv_plain(q, k, v, do, lse, delta, causal)
    err = check_rel_l2(f"{name} dK/dV pass vs its plain version", got[1:],
                       [dk.to(k.dtype), dv.to(v.dtype)], BWD_REL_L2_TOL)
    del dk, dv
    dq = attention.attention_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    return max(err, check_rel_l2(f"{name} dQ pass vs its plain version", got[:1],
                                 [dq.to(q.dtype)], BWD_REL_L2_TOL))


def check_attention_bwd(name, q, k, v, do) -> float:
    o, lse = attention.attention_kernel(q, k, v, with_lse=True)
    check_close(f"{name} lse", [lse], [attention.attention_lse_plain(q, k)], (1e-4, 1e-5))
    got = attention.attention_bwd_kernel(q, k, v, o, lse, do)
    err = check_rel_l2(f"{name} vs bwd_plain", got,
                       attention.attention_bwd_plain(q, k, v, o, lse, do), BWD_REL_L2_TOL)
    err = max(err, check_bwd_passes(name, q, k, v, o, lse, do, got, True))
    check_rel_l2(f"{name} vs autograd", got, plain_vjp(attention.attention_plain, [q, k, v], [do]),
                 BWD_REL_L2_TOL)
    return err


def check_rope_bwd(name, dq, dk, theta) -> float:
    got = rope.rope_kernel(dq, dk, theta, inverse=True)
    err = check_close(f"{name} vs bwd_plain", got, rope.rope_bwd_plain(dq, dk, theta),
                      ELEMENTWISE_TOL)
    # the rotation is linear: its VJP does not depend on the point, so the
    # upstream gradients serve as the forward's inputs too
    check_close(f"{name} vs autograd", got,
                plain_vjp(lambda a, b: rope.rope_plain(a, b, theta), [dq, dk], [dq, dk]),
                ELEMENTWISE_TOL)
    return err


def check_rmsnorm_bwd(name, x, sc, dy) -> float:
    got = rmsnorm.rmsnorm_bwd_kernel(x, sc, dy)
    err = check_rel_l2(f"{name} vs bwd_plain", got, rmsnorm.rmsnorm_bwd_plain(x, sc, dy),
                       BWD_REL_L2_TOL)
    check_rel_l2(f"{name} vs autograd", got, plain_vjp(rmsnorm.rmsnorm_plain, [x, sc], [dy]),
                 BWD_REL_L2_TOL)
    return err


def rmsnorm_bwd_row(rows, d, gen, dev) -> dict:
    """The K2 backward at (rows, d) against its plain version and autograd,
    timed beside its bound, the plain version and F.rms_norm's backward."""
    x, dy = bf16((rows, d), gen, dev), bf16((rows, d), gen, dev)
    sc = bf16((d,), gen, dev, 0.1, 1.0)
    err = check_rmsnorm_bwd(f"rmsnorm_bwd {rows, d}", x, sc, dy)
    return row("rmsnorm_bwd", "rmsnorm.cu", 128, f"rows={rows} d={d}", err,
               time_ms(lambda: rmsnorm.rmsnorm_bwd_kernel(x, sc, dy)),
               time_ms(lambda: rmsnorm.rmsnorm_bwd_plain(x, sc, dy)),
               bound_ms(2 * (3 * x.numel() + 2 * d), 10 * x.numel(), PEAK_F32),
               library_bwd_ms(lambda a, w: F.rms_norm(a, (d,), w, 1e-5), [x, sc], [dy]))


def rmsnorm_bwd_scaling(rows, d, ms, gen, dev):
    """The K2 backward's time against rows at width d: ms at rows, its
    times at RMS_SCALING_ROWS, and the line through the fewest and the
    most rows, whose slope is the rate at which it streams x, dy and dx
    (6 bytes an element) and whose value at 0 rows its fixed cost a
    launch."""
    times = {rows: ms}
    for n in RMS_SCALING_ROWS:
        extra = rmsnorm_bwd_row(n, d, gen, dev)
        print_row(extra)
        times[n] = extra["ms"]
    lo, hi = min(times), max(times)
    per_row = (times[hi] - times[lo]) / (hi - lo)
    print(f"rmsnorm_bwd at d={d}, rows {sorted(times)}: streaming "
          f"{6 * d / (per_row * 1e-3) / 1e12:.3f} TB/s, fixed "
          f"{(times[lo] - per_row * lo) * 1e3:.2f} us a launch", flush=True)


def check_swiglu_bwd(name, g, u, dy) -> float:
    got = swiglu.swiglu_bwd_kernel(g, u, dy)
    err = check_close(f"{name} vs bwd_plain", got, swiglu.swiglu_bwd_plain(g, u, dy),
                      ELEMENTWISE_TOL)
    check_close(f"{name} vs autograd", got, plain_vjp(swiglu.swiglu_plain, [g, u], [dy]),
                ELEMENTWISE_TOL)
    return err


def check_xent(name, logits, t, grad, grad_tol=XENT_GRAD_TOL) -> tuple:
    """Forward (loss, lse) and backward, each against the plain versions;
    returns the max abs errors of the loss and of the gradient."""
    loss, lse = cross_entropy.cross_entropy_kernel(logits, t)
    err_f = check_close(f"{name} loss", [loss, lse],
                        [cross_entropy.cross_entropy_plain(logits, t),
                         cross_entropy.cross_entropy_lse_plain(logits)], XENT_LOSS_TOL)
    got = cross_entropy.cross_entropy_bwd_kernel(logits, t, lse, grad)
    err_b = check_close(f"{name} grad vs bwd_plain", [got],
                        [cross_entropy.cross_entropy_bwd_plain(logits, t, lse, grad)], grad_tol)
    check_close(f"{name} grad vs autograd", [got],
                plain_vjp(lambda a: cross_entropy.cross_entropy_plain(a, t), [logits], [grad]),
                grad_tol)
    inplace = logits.clone()  # the training path writes the gradient over the logits
    cross_entropy.cross_entropy_bwd_kernel(inplace, t, lse, grad, out=inplace)
    torch.cuda.synchronize()
    if not torch.equal(inplace, got):
        fail(f"{name}: the in-place backward differs from the out-of-place one")
    return err_f, err_b


def forward_phase(dev):
    """Kernel forward vs plain forward, Llama-3-8B widths, 2 layers."""
    cfg = dataclasses.replace(llama.llama_3_8b(), n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 1000))).to(dev)
    with torch.inference_mode():
        got = llama.forward(cfg, params, tokens, llama.KERNELS)
        want = llama.forward(cfg, params, tokens, llama.PLAIN)
        torch.cuda.synchronize()
        if got.shape != (4, 1000, cfg.vocab) or got.dtype != torch.float32:
            fail(f"forward: logits {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            fail("forward: non-finite logits")
        rel = ((got - want).norm() / want.norm()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"forward (8B widths, 2 layers, 4x1000 tokens): rel_l2={rel:.3e} "
          f"(tol {FORWARD_REL_L2_TOL}), argmax agreement={agree:.4f}", flush=True)
    if not rel <= FORWARD_REL_L2_TOL:
        fail(f"forward: relative L2 error {rel:.3e} beyond {FORWARD_REL_L2_TOL}")


def _post(url: str, body: dict, timeout: float = 600.0) -> list:
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not body.get("stream"):
            return json.loads(resp.read())["tokens"]
        toks, done = [], False
        for line in resp:
            msg = json.loads(line)
            if msg.get("done"):
                done = True
            else:
                toks.append(msg["token"])
        return toks if done else []


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def serving_phase(card: str) -> dict:
    """Llama-3-8B behind DecodeServer on the card: the main path."""
    cfg = llama.llama_3_8b()
    t0 = time.monotonic()
    srv = llama.DecodeServer(cfg=cfg, slots=SERVE_SLOTS, seed=0)  # device: the card
    try:
        srv.warmup()
        print(f"serving: 8B weights made and warmed up in {time.monotonic() - t0:.1f} s",
              flush=True)
        srv.start()
        engine = srv.engine
        rng = np.random.default_rng(0)
        lengths = np.linspace(5, 1000, SERVE_REQUESTS).astype(int)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
        results: list = [None] * SERVE_REQUESTS
        errors: list = []

        def one(i):
            try:
                results[i] = _post(srv.url, {"tokens": prompts[i], "max_new": SERVE_MAX_NEW,
                                             "stream": i == 0})
            except Exception as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(SERVE_REQUESTS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in KERNELS.values():
            kern.launches = 0
        steps0, toks0 = engine.steps, engine.tokens_out
        t0 = time.monotonic()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        wall = time.monotonic() - t0
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        steps, toks = engine.steps - steps0, engine.tokens_out - toks0
        peak = torch.cuda.max_memory_allocated()
        if errors or any(th.is_alive() for th in threads):
            fail(f"serving: {errors or 'requests did not finish'}")
        for i, out in enumerate(results):
            if (not isinstance(out, list) or len(out) != SERVE_MAX_NEW
                    or not all(0 <= t < cfg.vocab for t in out)):
                fail(f"serving: request {i} (prompt {lengths[i]}) returned {out!r}")
        per_step = serve_launches_per_step(cfg.n_layers)
        for name, n in launches.items():
            if n != per_step.get(name, 0) * steps or (name in per_step and n == 0):
                fail(f"serving: {name} launched {n} times in {steps} steps, "
                     f"want {per_step.get(name, 0)} per step")
        metrics = _get(srv.url + "/metrics")
        if f"ktpu_llama_slots_total {float(SERVE_SLOTS)}" not in metrics.splitlines():
            fail("serving: /metrics lacks ktpu_llama_slots_total 8")
        if json.loads(_get(srv.url + "/healthz")) != {"status": "ok"}:
            fail("serving: /healthz")
        # one engine step at the engine's smallest bucket and at this run's
        # largest, for the share of a step that the kernels take
        forward_ms = {}
        with torch.inference_mode():
            for bucket in (8, 1024):
                toks_b = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_SLOTS, bucket)))
                toks_b = toks_b.cuda()
                forward_ms[bucket] = time_ms(lambda: llama.forward(cfg, srv.params, toks_b),
                                             3, 1, back_to_back=False)
    finally:
        srv.stop()
    res = dict(requests=SERVE_REQUESTS, steps=steps, tokens=toks, wall_s=wall,
               step_ms=wall / steps * 1e3, tokens_per_s=toks / wall,
               peak_mem_gib=peak / 2 ** 30, launches=launches)
    print(f"serving (Llama-3-8B, {SERVE_SLOTS} slots, {SERVE_REQUESTS} requests x "
          f"{SERVE_MAX_NEW} tokens, prompts 5-1000): steps={steps} tokens={toks} "
          f"wall_s={wall:.3f} step_ms={res['step_ms']:.2f} "
          f"tokens_per_s={res['tokens_per_s']:.2f} peak_mem_gib={res['peak_mem_gib']:.2f} "
          f"forward_ms(8x8)={forward_ms[8]:.2f} forward_ms(8x1024)={forward_ms[1024]:.2f} "
          f"launches={launches} on [{card}]", flush=True)
    return res


def train_check_phase(dev):
    """A train step's loss and gradients on the kernels vs on the plain
    versions: Llama-3-8B widths, 2 layers, remat "save_attn", (2, 513)
    tokens, f32 master weights."""
    cfg = dataclasses.replace(llama.llama_3_8b(), n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                               dtype=torch.float32)
    leaves = llama.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 513))).to(dev)
    results = []
    for ops in (llama.KERNELS, llama.PLAIN):
        loss = llama.loss_fn(cfg, params, tokens, ops)
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss.item(), grads))
        del loss
    (k_loss, k_grads), (p_loss, p_grads) = results
    torch.cuda.synchronize()
    rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(k_grads, p_grads)]
    worst = int(np.argmax(rels))
    print(f"train step, kernels vs plain (8B widths, 2 layers, 2x513 tokens): loss "
          f"{k_loss:.6f} vs {p_loss:.6f} (tol {TRAIN_LOSS_TOL}), gradients: max relative L2 "
          f"{rels[worst]:.3e} at leaf {worst} of {len(rels)}, median {float(np.median(rels)):.3e} "
          f"(tol {TRAIN_GRAD_REL_L2_TOL})", flush=True)
    if not (np.isfinite(k_loss) and abs(k_loss - p_loss) <= TRAIN_LOSS_TOL):
        fail(f"train check: loss {k_loss} vs plain {p_loss}")
    if not all(np.isfinite(r) and r <= TRAIN_GRAD_REL_L2_TOL for r in rels):
        fail(f"train check: gradient {worst} relative L2 {rels[worst]:.3e}")


def train_phase(card: str, kernel_ms: dict) -> dict:
    """Llama-3-8B widths, 4 layers, trained for 5 AdamW steps on one fixed
    batch through make_train_state / make_train_step: the training path."""
    cfg = dataclasses.replace(llama.llama_3_8b(), n_layers=TRAIN_LAYERS)
    t0 = time.monotonic()
    params, opt = llama.make_train_state(cfg, seed=0)  # device: the card
    n_params = sum(p.numel() for p in llama.param_leaves(params))
    step = llama.make_train_step(cfg, params, opt)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    torch.cuda.synchronize()
    print(f"train: {n_params / 1e9:.3f} B parameters made in {time.monotonic() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t1 = time.monotonic()
        loss = step(tokens)
        losses.append(loss.item())  # synchronises
        times.append(time.monotonic() - t1)
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: losses {losses} (want finite, last below first)")
    per_step = train_launches_per_step(cfg.n_layers)
    for name, n in launches.items():
        if n != per_step.get(name, 0) * TRAIN_STEPS:
            fail(f"train: {name} launched {n} times in {TRAIN_STEPS} steps, "
                 f"want {per_step.get(name, 0)} per step")
    step_ms = float(np.mean(times[1:])) * 1e3  # the first step pays for cuBLAS's set-up
    parts = step_breakdown(cfg, params, opt, tokens)
    print(f"train step, device ms by part (3 more steps, profiler): "
          f"{step_device_parts(step, (tokens,))}", flush=True)
    parts["torch_adamw_ms"] = torch_adamw_ms(llama.param_leaves(params), 0.1)
    kernel_ms = {**kernel_ms, "adamw": parts["optimizer_ms"]}
    kern_ms = sum(per_step[name] * kernel_ms[name] for name in per_step)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    # AdamW's least traffic: p, g, m, v read and p, m, v written, f32
    opt_bound_ms = bound_ms(28 * n_params, 16 * n_params, PEAK_F32)[0]
    res = dict(losses=losses, step_ms=step_ms, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens_per_step / step_ms * 1e3,
               peak_mem_gib=peak / 2 ** 30, launches=launches,
               kernel_ms_per_step=kern_ms, kernel_share=kern_ms / step_ms,
               optimizer_bound_ms=opt_bound_ms, **parts)
    # model FLOPs: 6 per matrix weight per token (embedding gathers excluded)
    # plus attention's 4 (forward) + 8 (backward) * hd per unmasked pair;
    # the backward kernel's recompute of Q K^T is implementation work
    mm_params = n_params - params["embed"].numel() - (2 * cfg.n_layers + 1) * cfg.d_model
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) / 2
    flops = (6 * mm_params * tokens_per_step
             + 12 * cfg.n_layers * TRAIN_BATCH * cfg.n_heads * cfg.head_dim * pairs)
    res["model_tflops_per_s"] = flops / step_ms / 1e9
    print(f"train (Llama-3-8B widths, {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, "
          f"batch {TRAIN_BATCH}x{TRAIN_SEQ}, remat {cfg.remat_policy}, AdamW): "
          f"losses={[round(x, 4) for x in losses]} step_ms={step_ms:.2f} "
          f"(first {res['first_step_ms']:.1f}) tokens_per_s={res['tokens_per_s']:.1f} "
          f"model_tflops_per_s={res['model_tflops_per_s']:.1f} "
          f"(MFU {100 * res['model_tflops_per_s'] * 1e12 / PEAK_BF16_TENSOR:.1f} %) "
          f"peak_mem_gib={res['peak_mem_gib']:.2f} kernels_ms_per_step={kern_ms:.2f} "
          f"({100 * res['kernel_share']:.1f} %) forward_ms={res['forward_ms']:.2f} "
          f"backward_ms={res['backward_ms']:.2f} optimizer_ms={res['optimizer_ms']:.2f} "
          f"(K10 AdamW, bound {opt_bound_ms:.2f} ms at 28 bytes a parameter; "
          f"torch.optim.AdamW foreach on the same step {res['torch_adamw_ms']:.2f}) "
          f"launches={launches} on [{card}]", flush=True)
    del params, opt, step
    return res


def torch_adamw_ms(leaves, weight_decay: float, fused: bool = False) -> float:
    """torch.optim.AdamW in its default (foreach) form, the port's optimizer
    before K10, or fused, timed on the same weights and gradients as a
    yardstick (its first step, which makes its state, untimed)."""
    lib = torch.optim.AdamW(leaves, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, fused=fused or None)
    lib.step()
    ms = optimizer_step_ms(lib)
    del lib
    free_memory()
    return ms


def optimizer_step_ms(opt) -> float:
    """One more update on the gradients the last step left, timed with
    CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    opt.step()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1])


def step_breakdown(cfg, params, opt, tokens) -> dict:
    """One more step, its parts timed apart with CUDA events: the loss
    (forward), its backward, and the AdamW update (one K10 launch)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    loss = llama.loss_fn(cfg, params, tokens)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    torch.cuda.synchronize()
    return dict(forward_ms=ev[0].elapsed_time(ev[1]), backward_ms=ev[1].elapsed_time(ev[2]),
                optimizer_ms=ev[2].elapsed_time(ev[3]))


# ------------------------------------------------------------ ResNet-50 (K8)


def bn_inputs(M, C, gen, dev, residual):
    """A post-conv activation (mean 0.3, std 1.5), f32 scale and bias, and
    a residual where asked."""
    x = bf16((M, C), gen, dev, 1.5, 0.3)
    scale = torch.rand(C, generator=gen, device=dev) + 0.5
    bias = torch.randn(C, generator=gen, device=dev) * 0.3
    return x, scale, bias, (bf16((M, C), gen, dev) if residual else None)


def check_bn(name, x, scale, bias, r, relu, dy) -> tuple:
    """The statistics, apply and backward kernels against their plain
    versions, the apply's ReLU mask against the bits of its own y > 0, and
    the backward against autograd of the plain forward; returns the three
    max abs errors."""
    got = batchnorm.bn_stats_kernel(x, scale, bias)
    w, b, stats = batchnorm.bn_stats_plain(x, scale, bias)
    err_s = check_close(f"{name} bn_stats", got, (w, b, stats), BN_STATS_TOL)
    y, _mask = batchnorm.bn_apply_kernel(x, w, b, r, relu)  # the same w and b into both
    y_plain, _ = batchnorm.bn_apply_plain(x, w, b, r, relu)
    torch.cuda.synchronize()
    mag = (x.float() * w.float()).abs() + b.float().abs()
    if r is not None:
        mag += r.float().abs()
    err = (y.float() - y_plain.float()).abs()
    if not torch.isfinite(y.float()).all() or not bool((err <= BN_APPLY_RTOL * mag).all()):
        fail(f"{name} bn_apply: max abs err {err.max().item():.3e} beyond "
             f"{BN_APPLY_RTOL} * (|x*w| + |b| + |r|)")
    kw, kb, kstats = got
    ky, kmask = batchnorm.bn_apply_kernel(x, kw, kb, r, relu)
    if relu and not torch.equal(kmask, batchnorm.relu_mask_plain(ky)):
        fail(f"{name} bn_apply: the ReLU mask is not the bits of its own y > 0")
    if not relu and kmask is not None:
        fail(f"{name} bn_apply: a mask without a ReLU")
    res = r is not None
    gk = batchnorm.bn_bwd_kernel(x, kmask, dy, kw, scale, kstats, res)
    gp = batchnorm.bn_bwd_plain(x, kmask, dy, kw, scale, kstats, res)
    order = [0, 2, 3] + ([1] if res else [])  # dx, dscale, dbias, dr
    err_b = check_rel_l2(f"{name} bn_bwd vs bwd_plain", [gk[i] for i in order],
                         [gp[i] for i in order], BWD_REL_L2_TOL)
    if x.shape[0] >= BN_AUTOGRAD_MIN_ROWS:
        # up to the ReLU, fed dy masked by the kernel's own output
        dym = torch.where(ky > 0, dy, torch.zeros_like(dy)) if relu else dy
        auto = plain_vjp(lambda a, s, c, *rr: batchnorm.batchnorm_plain(
            a, s, c, rr[0] if rr else None), [x, scale, bias] + ([r] if res else []), [dym])
        # dx against the scale of dy'*w, which autograd's own bf16 product
        # rounds: dx cancels most of it where dy' lies near the directions
        # that the batch statistics project out
        dx_rel = ((gk[0].float() - auto[0].float()).norm()
                  / (dym.float() * kw.float()).norm().clamp_min(1e-30)).item()
        if not dx_rel <= BWD_REL_L2_TOL:
            fail(f"{name} bn_bwd vs autograd: dx error {dx_rel:.3e} of |dy' * w|, "
                 f"beyond {BWD_REL_L2_TOL}")
        check_rel_l2(f"{name} bn_bwd vs autograd", [gk[i] for i in order[1:]], auto[1:],
                     BWD_REL_L2_TOL)
    return err_s, err.max().item(), err_b


# ResNet-50's batch-norm layers that K8 is timed at, batch 128 x 224^2:
# (name, side of the feature map, C, residual); every one has a ReLU.  The
# stem is the largest (M = 1,605,632 rows), stage 1's bn3 the largest with
# a residual, stage 3's bn2 one whose x, dy and mask fit in the 50 MB L2,
# stage 4's bn3 the widest.
BN_TIMED = (("stem", 112, 64, False), ("stage1 bn3", 56, 256, True),
            ("stage3 bn2", 14, 256, False), ("stage4 bn3", 7, 2048, True))


def bn_kernel_phase(dev, gen) -> list:
    """K8 against its plain version at odd shapes and at the BN_TIMED
    layers, where each is also timed; the stem's rows go into the kernels'
    line."""
    for M, C in ((1, 64), (37, 24), (1000, 8), (3, 2048), (517, 136)):
        for relu, res in ((False, False), (True, False), (True, True)):
            x, sc, bi, r = bn_inputs(M, C, gen, dev, res)
            check_bn(f"bn {M, C} relu={relu} residual={res}", x, sc, bi, r, relu,
                     bf16((M, C), gen, dev))
    try:
        batchnorm.batchnorm(torch.zeros((10, 12), dtype=torch.bfloat16, device=dev),
                            torch.ones(12, device=dev), torch.zeros(12, device=dev))
    except ValueError:
        pass
    else:
        fail("bn: C = 12 (not a multiple of 8) was not refused")

    out = []
    for where, side, C, res in BN_TIMED:
        M, n = RESNET_BATCH * side * side, RESNET_BATCH * side * side * C
        x, sc, bi, r = bn_inputs(M, C, gen, dev, res)
        dy = bf16((M, C), gen, dev)
        errs = check_bn(f"bn {where} {M, C}", x, sc, bi, r, True, dy)
        w, b, stats = batchnorm.bn_stats_kernel(x, sc, bi)
        _y, mask = batchnorm.bn_apply_kernel(x, w, b, r, True)
        x4, dy4 = (t.view(RESNET_BATCH, side, side, C).permute(0, 3, 1, 2) for t in (x, dy))
        shape = f"M={M} C={C} ({where}, ReLU{' + residual' if res else ''})"
        resnet_rows = [
            row("bn_stats", "batchnorm.cu", "83-97", shape, errs[0],
                time_ms(lambda: batchnorm.bn_stats_kernel(x, sc, bi)),
                time_ms(lambda: batchnorm.bn_stats_plain(x, sc, bi), 5, 1),
                bound_ms(2 * n + 8 * C + 4 * C + 16 * C, 3 * n, PEAK_F32),
                # stats and apply in one library call: the pair's yardstick
                time_ms(lambda: F.batch_norm(x4, None, None, sc, bi, training=True)),
                jax_file="resnet.py"),
            # reads x (and r), writes y and the mask's 1/8 byte an element
            row("bn_apply", "batchnorm.cu", "105,110-115", shape, errs[1],
                time_ms(lambda: batchnorm.bn_apply_kernel(x, w, b, r, True)),
                time_ms(lambda: batchnorm.bn_apply_plain(x, w, b, r, True), 5, 1),
                bound_ms(2 * n * (3 if res else 2) + n / 8 + 4 * C, (4 if res else 3) * n,
                         PEAK_F32),
                None, jax_file="resnet.py"),
            # reads x, dy and the mask, writes dx (and dr)
            row("bn_bwd", "batchnorm.cu", "83-97", shape, errs[2],
                time_ms(lambda: batchnorm.bn_bwd_kernel(x, mask, dy, w, sc, stats, res)),
                time_ms(lambda: batchnorm.bn_bwd_plain(x, mask, dy, w, sc, stats, res), 5, 1),
                bound_ms(2 * n * (4 if res else 3) + n / 8 + 2 * C + 32 * C, 10 * n, PEAK_F32),
                library_bwd_ms(lambda a, s, c: F.batch_norm(a, None, None, s, c, training=True),
                               [x4, sc, bi], [dy4]), jax_file="resnet.py"),
        ]
        for rw in resnet_rows:
            print_row(rw)
        if where == "stem":
            out = resnet_rows
        del x, dy, mask, x4, dy4, r
    return out


def resnet_check_phase(dev):
    """ResNet-50 on the kernels vs on the plain versions, batch 8 x 224^2,
    random f32 weights, bf16 compute: the loss; the logits and every
    gradient against an f32 run of the plain versions, for each bf16 path
    (see RESNET_ACCURACY_RATIO); and each of the 53 batch-norm layers'
    kernels against the plain versions on the inputs and upstream
    gradient that layer saw in the kernel run."""
    cfg = resnet.ResNetConfig()
    params = resnet.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    leaves = resnet.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    images, labels = resnet.synthetic_batch(cfg, RESNET_CHECK_BATCH, RESNET_SIZE, torch.float32,
                                            dev)
    layers = []

    def recording_bn(x, scale, bias, residual=None, relu=False):
        y = batchnorm.batchnorm(x, scale, bias, residual, relu)
        rec = dict(args=(x.detach(), scale.detach(), bias.detach(),
                         None if residual is None else residual.detach(), relu))
        y.register_hook(lambda g, rec=rec: rec.__setitem__("dy", g.detach().contiguous()))
        layers.append(rec)
        return y

    results = {}
    for name, ops, dtype in (("kernels", resnet.Ops(recording_bn, cross_entropy.cross_entropy),
                              cfg.dtype),
                             ("plain", resnet.PLAIN, cfg.dtype),
                             ("f32", resnet.PLAIN, torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        with torch.no_grad():
            logits = resnet.forward(c, params, images, resnet.PLAIN if name != "kernels"
                                    else resnet.KERNELS)
        loss = resnet.loss_fn(c, params, images, labels, ops)
        results[name] = (logits, loss.item(), torch.autograd.grad(loss, leaves))
        del loss
    torch.cuda.synchronize()
    (k_logits, k_loss, k_grads), (p_logits, p_loss, p_grads), (f_logits, _f_loss, f_grads) = (
        results[n] for n in ("kernels", "plain", "f32"))
    if k_logits.shape != (RESNET_CHECK_BATCH, cfg.num_classes) or k_logits.dtype != torch.float32:
        fail(f"resnet forward: logits {tuple(k_logits.shape)} {k_logits.dtype}")
    if not torch.isfinite(k_logits).all() or not all(torch.isfinite(g).all() for g in k_grads):
        fail("resnet: non-finite logits or gradients")

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    logit_k, logit_p = rel(k_logits, f_logits), rel(p_logits, f_logits)
    grad_k = float(np.median([rel(g, f) for g, f in zip(k_grads, f_grads)]))
    grad_p = float(np.median([rel(g, f) for g, f in zip(p_grads, f_grads)]))
    grad_kp = [rel(g, w) for g, w in zip(k_grads, p_grads)]
    print(f"resnet-50 kernels vs plain (batch {RESNET_CHECK_BATCH} x {RESNET_SIZE}^2): loss "
          f"{k_loss:.6f} vs {p_loss:.6f} (tol {RESNET_LOSS_TOL}); against f32: logits rel_l2 "
          f"kernels {logit_k:.3e} plain {logit_p:.3e}, gradients median rel_l2 kernels "
          f"{grad_k:.3e} plain {grad_p:.3e} (kernels within {RESNET_ACCURACY_RATIO}x plain); "
          f"kernels vs plain: logits rel_l2 {rel(k_logits, p_logits):.3e}, gradients median "
          f"{float(np.median(grad_kp)):.3e} max {max(grad_kp):.3e}", flush=True)
    if not (np.isfinite(k_loss) and abs(k_loss - p_loss) <= RESNET_LOSS_TOL):
        fail(f"resnet train check: loss {k_loss} vs plain {p_loss}")
    if not (logit_k <= RESNET_ACCURACY_RATIO * logit_p
            and grad_k <= RESNET_ACCURACY_RATIO * grad_p):
        fail("resnet train check: the kernels are less accurate than the plain versions")
    if len(layers) != resnet.num_bn_layers(cfg) or any("dy" not in rec for rec in layers):
        fail(f"resnet train check: {len(layers)} batch-norm layers recorded")
    worst = [0.0, 0.0, 0.0]
    for i, rec in enumerate(layers):
        x, s, b, r, relu = rec["args"]
        errs = check_bn(f"resnet layer {i} {tuple(x.shape)}", x, s, b, r, relu, rec["dy"])
        worst = [max(a, e) for a, e in zip(worst, errs)]
    print(f"resnet-50: each of the {len(layers)} batch-norm layers' kernels against the plain "
          f"versions on that layer's own inputs (the backward reading the apply's ReLU mask, "
          f"each mask the bits of its own y > 0): max abs err stats {worst[0]:.3e} apply "
          f"{worst[1]:.3e} bwd {worst[2]:.3e}", flush=True)


BN_KERNEL_NAMES = ("bn_stats_kernel", "bn_apply_kernel", "bn_bwd_kernel")
# The two largest kernels outside K8 in the ResNet step's profile, an
# elementwise add and a strided copy; the profile names who launches them.
CALLER_KERNELS = {"add": "CUDAFunctor_add", "strided copy": "elementwise_kernel<128, 4"}


def kernel_callers(prof, pattern: str, top: int = 4) -> list:
    """Who launched the device kernels whose name holds ``pattern``: per
    (autograd node or Python frame of the port, aten ops from the outermost
    with its input shapes), the device ms and launches, largest first."""
    found: dict = {}
    for ev in prof.events():
        for k in getattr(ev, "kernels", []):
            if pattern not in k.name:
                continue
            ops, node, frame, e = [], None, None, ev
            while e is not None:
                if e.name.startswith("aten::"):
                    ops.append((e.name, e.input_shapes))
                if node is None and e.name.startswith("autograd::engine::evaluate_function"):
                    node = e.name.split(": ", 1)[-1]
                if frame is None:  # a Python frame of the port: in a stack, or an event
                    frame = next((f for f in list(e.stack or []) + [e.name]
                                  if "kubernetes1_tpu_torch" in f), None)
                e = e.cpu_parent
            outer = f"{ops[-1][0]}{list(ops[-1][1] or [])}" if ops else ev.name
            key = (node or frame or "forward",
                   " > ".join([outer] + [o[0] for o in ops[-2::-1]]))
            ms, count = found.get(key, (0.0, 0))
            found[key] = (ms + k.duration / 1e3, count + 1)
    rows = sorted(found.items(), key=lambda kv: -kv[1][0])[:top]
    return [(caller, ops, round(ms, 4), count) for (caller, ops), (ms, count) in rows]


def resnet_step_profile() -> dict:
    """One ResNet-50 train step at batch 128 x 224^2 under torch.profiler:
    device time by kernel, the batch-norm kernels' part of it by kernel,
    and the callers of CALLER_KERNELS."""
    from torch.profiler import ProfilerActivity, profile

    cfg = resnet.ResNetConfig()
    params, opt = resnet.make_train_state(cfg, seed=0)
    step = resnet.make_train_step(cfg, params, opt)
    images, labels = resnet.synthetic_batch(cfg, RESNET_BATCH, RESNET_SIZE, cfg.dtype,
                                            torch.device("cuda"))
    for _ in range(2):
        float(step(images, labels))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True,
                 with_stack=True) as prof:
        float(step(images, labels))
    kern: dict = {}
    for ev in prof.key_averages():
        if benchguard.is_device_op(ev):
            kern[ev.key] = kern.get(ev.key, 0.0) + benchguard.device_time_us(ev)
    total = sum(kern.values())
    bn_split = {b: sum(v for k, v in kern.items() if b in k) / 1e3 for b in BN_KERNEL_NAMES}
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms=total / 1e3, bn_ms=sum(bn_split.values()),
                bn_split={k: round(v, 4) for k, v in bn_split.items()},
                top=[(k[:80], round(v / 1e3, 4)) for k, v in top],
                callers={name: kernel_callers(prof, pat) for name, pat in CALLER_KERNELS.items()})


def resnet_phase(card: str) -> dict:
    """ResNet-50 (full width and depth) trained through the bench payload
    at batch 128 x 224^2 on the card: the third main path."""
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    res = resnet_bench.run(batch=RESNET_BATCH, steps=RESNET_STEPS, size=RESNET_SIZE,
                           warmup=RESNET_WARMUP, profile=True)  # device: the card
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print("resnet_bench result: " + json.dumps(res), flush=True)
    steps_run = RESNET_WARMUP + RESNET_STEPS + 1  # the profiled step too
    per_step = resnet_launches_per_step(resnet.num_bn_layers(resnet.ResNetConfig()))
    for name, n in launches.items():
        want = per_step.get(name, 0)
        if n != want * steps_run or (name in per_step and n == 0):
            fail(f"resnet: {name} launched {n} times in {steps_run} steps, want {want} per step")
    first, final = res["first_loss"], res["final_loss"]
    if not (np.isfinite(first) and np.isfinite(final) and final < first):
        fail(f"resnet: losses first {first} final {final} (want finite, falling)")
    free_memory()
    prof = resnet_step_profile()
    step_ms = res["step_time_ms"]
    out = dict(launches=launches, step_ms=step_ms, imgs_per_s=res["imgs_per_sec"],
               mfu=res["mfu"], peak_mem_gib=peak / 2 ** 30, **prof)
    shares = (f"bn_ms={prof['bn_ms']:.3f} ({100 * prof['bn_ms'] / step_ms:.1f} % of the step, "
              f"{100 * prof['bn_ms'] / max(prof['device_ms'], 1e-9):.1f} % of device time) "
              f"device_ms={prof['device_ms']:.3f} ({100 * prof['device_ms'] / step_ms:.1f} % "
              f"busy)" if prof["device_ms"] else "device time not measured (no device events)")
    print(f"resnet-50 (batch {RESNET_BATCH} x {RESNET_SIZE}^2, SGD momentum 0.9): "
          f"losses first={first:.4f} final={final:.4f} step_ms={step_ms:.2f} "
          f"imgs_per_s={res['imgs_per_sec']:.1f} flops_per_step={res['flops_per_step']:.4e} "
          f"MFU={res['mfu']} (of {PEAK_BF16_TENSOR:.3e}) peak_mem_gib={out['peak_mem_gib']:.2f} "
          f"{shares} launches={ {k: v for k, v in launches.items() if v} } on [{card}]",
          flush=True)
    print(f"resnet-50 step, top kernels by device ms: {prof['top']}", flush=True)
    print(f"resnet-50 step, batch norm by kernel (device ms): {prof['bn_split']}", flush=True)
    for name, rows in prof["callers"].items():
        print(f"resnet-50 step, {name} kernels by caller (caller, aten ops, device ms, "
              f"launches): {rows}", flush=True)
    return out

# ----------------------------------------------- BERT (K7a, K7b, K9, K5-f32)


def check_attention_nc(name, q, k, v, do) -> tuple:
    """Non-causal forward (o, lse) and backward against the plain versions,
    the backward also against autograd of the plain forward; returns the
    max abs errors of o and of (dq, dk, dv)."""
    o, lse = attention.attention_kernel(q, k, v, True, causal=False)
    err_f = check_close(f"{name} fwd", [o], [attention.attention_plain(q, k, v, causal=False)],
                        ATTENTION_TOL)
    check_close(f"{name} lse", [lse], [attention.attention_lse_plain(q, k, causal=False)],
                (1e-4, 1e-5))
    got = attention.attention_bwd_kernel(q, k, v, o, lse, do, causal=False)
    err_b = check_rel_l2(f"{name} bwd vs bwd_plain", got,
                         attention.attention_bwd_plain(q, k, v, o, lse, do, causal=False),
                         BWD_REL_L2_TOL)
    err_b = max(err_b, check_bwd_passes(f"{name} bwd", q, k, v, o, lse, do, got, False))
    check_rel_l2(f"{name} bwd vs autograd", got,
                 plain_vjp(partial(attention.attention_plain, causal=False), [q, k, v], [do]),
                 BWD_REL_L2_TOL)
    return err_f, err_b


def check_layernorm(name, x, sc, bi, dy) -> tuple:
    err_f = check_close(f"{name} fwd", [layernorm.layernorm_kernel(x, sc, bi)],
                        [layernorm.layernorm_plain(x, sc, bi)], LN_TOL)
    got = layernorm.layernorm_bwd_kernel(x, sc, dy)
    err_b = check_rel_l2(f"{name} bwd vs bwd_plain", got, layernorm.layernorm_bwd_plain(x, sc, dy),
                         BWD_REL_L2_TOL)
    check_rel_l2(f"{name} bwd vs autograd", got,
                 plain_vjp(layernorm.layernorm_plain, [x, sc, bi], [dy]), BWD_REL_L2_TOL)
    return err_f, err_b


def check_gelu(name, x, dy) -> tuple:
    err_f = check_close(f"{name} fwd", [gelu.gelu_kernel(x)], [gelu.gelu_plain(x)], GELU_TOL)
    got = gelu.gelu_bwd_kernel(x, dy)
    err_b = check_close(f"{name} bwd vs bwd_plain", [got], [gelu.gelu_bwd_plain(x, dy)],
                        GELU_TOL)
    check_close(f"{name} bwd vs autograd", [got], plain_vjp(gelu.gelu_plain, [x], [dy]),
                GELU_VJP_TOL)
    return err_f, err_b


def ln_inputs(rows, d, gen, dev):
    """A residual-stream activation (mean 0.3, std 1.5), f32 scale and bias."""
    return (bf16((rows, d), gen, dev, 1.5, 0.3), torch.rand(d, generator=gen, device=dev) + 0.5,
            torch.randn(d, generator=gen, device=dev) * 0.3)


def bert_kernel_phase(dev, gen) -> tuple:
    """K7a, K7b, K9 and K5-f32, forward and backward, against their plain
    versions at odd small shapes and at BERT-large's (B=32, S=512, H=16,
    hd=64; 16384 rows of d=1024, d_ff=4096, vocab=30522); timed at the
    latter.  Returns the rows and each kernel's time per call in the train
    step (the head's GELU, on 16384 x 1024, apart)."""
    cfg = bert.bert_large()
    for B, S, H, hd in ((2, 37, 4, 16), (1, 100, 8, 64), (3, 130, 4, 32), (1, 65, 8, 128),
                        (2, 64, 16, 64)):
        q, k, v, do = (bf16((B, S, H, hd), gen, dev) for _ in range(4))
        check_attention_nc(f"attention_noncausal {(B, S, H, hd)}", q, k, v, do)
    for rows, d in ((37, 64), (5, 1000), (1, 8), (300, 4096), (513, 1024)) + LN_WIDTH_CLASSES:
        x, sc, bi = ln_inputs(rows, d, gen, dev)
        check_layernorm(f"layernorm {rows, d}", x, sc, bi, bf16((rows, d), gen, dev))
    for rows, n in ((37, 24), (3, 40), (5, 1000)):
        check_gelu(f"gelu {rows, n}", bf16((rows, n), gen, dev, 3.0), bf16((rows, n), gen, dev))
    for rows, vocab in ((37, 1003), (16, 30522), (5, 1000), (3, 4097)):  # vec 1, 2, 4 and 1
        logits = torch.randn((rows, vocab), generator=gen, device=dev) * 3.0
        t = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        check_xent(f"cross_entropy_f32 {rows, vocab}", logits, t,
                   torch.randn(rows, generator=gen, device=dev), XENT_F32_GRAD_TOL)

    out, per_call = [], {}
    # ---- K7a at B=32, H=16, hd=64: S=512 (the train step's) and S=200 (a
    # length no multiple of the 64-row tiles: the padding mask)
    B, H, hd = BERT_BATCH, cfg.n_heads, cfg.head_dim
    for S in (BERT_SEQ, 200):
        q, k, v, do = (bf16((B, S, H, hd), gen, dev) for _ in range(4))
        err_f, err_b = check_attention_nc(f"attention_noncausal B={B} S={S}", q, k, v, do)
        o, lse = attention.attention_kernel(q, k, v, True, causal=False)
        qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
        shape = f"B={B} S={S} H={H} hd={hd} non-causal"
        n, stats = q.numel(), 4 * B * H * S
        rows = [
            row("attention_noncausal", "attention.cu", 129, shape, err_f,
                time_ms(lambda: attention.attention_kernel(q, k, v, True, causal=False)),
                time_ms(lambda: attention.attention_plain(q, k, v, causal=False), 5, 1),
                bound_ms(2 * 4 * n + stats, 4 * B * H * hd * S * S, PEAK_BF16_TENSOR),
                time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)), jax_file="bert.py"),
            row("attention_noncausal_bwd", "attention.cu", 129, shape, err_b,
                time_ms(lambda: attention.attention_bwd_kernel(q, k, v, o, lse, do, causal=False),
                        10, 2),
                time_ms(lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, causal=False),
                        3, 1),
                bound_ms(2 * 8 * n + stats, 10 * B * H * hd * S * S, PEAK_BF16_TENSOR),
                library_bwd_ms(F.scaled_dot_product_attention, [qt, kt, vt], [dot]),
                jax_file="bert.py"),
        ]
        for r in rows:
            print_row(r)
        if S == BERT_SEQ:
            out += rows
        del q, k, v, do, o, lse, qt, kt, vt, dot

    # ---- K7b on the (16384, 1024) residual stream
    M, d = BERT_BATCH * BERT_SEQ, cfg.d_model
    x, sc, bi = ln_inputs(M, d, gen, dev)
    dy = bf16((M, d), gen, dev)
    err_f, err_b = check_layernorm(f"layernorm {M, d}", x, sc, bi, dy)
    n = x.numel()
    scb, bib = sc.to(x.dtype), bi.to(x.dtype)  # the library call takes bf16 weights
    shape = f"rows={M} d={d}"
    ln_rows = [
        row("layernorm", "layernorm.cu", "113-118", shape, err_f,
            time_ms(lambda: layernorm.layernorm_kernel(x, sc, bi)),
            time_ms(lambda: layernorm.layernorm_plain(x, sc, bi), 5, 1),
            bound_ms(2 * 2 * n + 8 * d, 8 * n, PEAK_F32),
            time_ms(lambda: F.layer_norm(x, (d,), scb, bib, layernorm.EPS)), jax_file="bert.py"),
        row("layernorm_bwd", "layernorm.cu", "113-118", shape, err_b,
            time_ms(lambda: layernorm.layernorm_bwd_kernel(x, sc, dy)),
            time_ms(lambda: layernorm.layernorm_bwd_plain(x, sc, dy), 5, 1),
            bound_ms(2 * 3 * n + 12 * d, 16 * n, PEAK_F32),
            library_bwd_ms(lambda a, w, b: F.layer_norm(a, (d,), w, b, layernorm.EPS),
                           [x, scb, bib], [dy]), jax_file="bert.py"),
    ]
    out += ln_rows
    del x, dy

    # ---- K9 on the (16384, 4096) output of x @ w_in, and the head's (16384, 1024)
    for cols in (cfg.d_ff, d):
        x, dy = bf16((M, cols), gen, dev, 2.0), bf16((M, cols), gen, dev)
        err_f, err_b = check_gelu(f"gelu {M, cols}", x, dy)
        n = x.numel()
        shape = f"rows={M} n={cols}"
        rows = [
            row("gelu", "gelu.cu", "132,151", shape, err_f, time_ms(lambda: gelu.gelu_kernel(x)),
                time_ms(lambda: gelu.gelu_plain(x), 5, 1), bound_ms(2 * 2 * n, 10 * n, PEAK_F32),
                time_ms(lambda: F.gelu(x, approximate="tanh")), jax_file="bert.py"),
            row("gelu_bwd", "gelu.cu", "132,151", shape, err_b,
                time_ms(lambda: gelu.gelu_bwd_kernel(x, dy)),
                time_ms(lambda: gelu.gelu_bwd_plain(x, dy), 5, 1),
                bound_ms(2 * 3 * n, 18 * n, PEAK_F32),
                library_bwd_ms(lambda a: F.gelu(a, approximate="tanh"), [x], [dy]),
                jax_file="bert.py"),
        ]
        for r in rows:
            print_row(r)
        if cols == cfg.d_ff:
            out += rows
            gelu_issue_report(x, dy, rows)
        else:
            per_call["gelu_head"], per_call["gelu_head_bwd"] = rows[0]["ms"], rows[1]["ms"]
        del x, dy

    # ---- K5 over the (16384, 30522) f32 logits
    logits = torch.randn((M, cfg.vocab), generator=gen, device=dev) * 2.0
    t = torch.randint(0, cfg.vocab, (M,), generator=gen, device=dev)
    grad = torch.full((M,), 1.0 / M, device=dev)
    errs = check_xent("cross_entropy_f32 BERT", logits, t, torch.randn(M, generator=gen, device=dev),
                      XENT_F32_GRAD_TOL)
    _loss, lse = cross_entropy.cross_entropy_kernel(logits, t)
    m = logits.numel()
    shape = f"rows={M} vocab={cfg.vocab} f32"
    scratch = torch.empty_like(logits)
    xent_rows = [
        row("cross_entropy_f32", "cross_entropy.cu", "157-166", shape, errs[0],
            time_ms(lambda: cross_entropy.cross_entropy_kernel(logits, t)),
            time_ms(lambda: cross_entropy.cross_entropy_plain(logits, t), 5, 1),
            bound_ms(4 * m + 8 * M + 8 * M, 4 * m, PEAK_F32),
            time_ms(lambda: F.cross_entropy(logits, t, reduction="none"), 5, 1), jax_file="bert.py"),
        row("cross_entropy_f32_bwd", "cross_entropy.cu", "157-166", shape, errs[1],
            time_ms(lambda: cross_entropy.cross_entropy_bwd_kernel(logits, t, lse, grad,
                                                                   out=scratch)),
            time_ms(lambda: cross_entropy.cross_entropy_bwd_plain(logits, t, lse, grad), 5, 1),
            bound_ms(2 * 4 * m + 16 * M, 4 * m, PEAK_F32),
            library_bwd_ms(lambda a: F.cross_entropy(a, t), [logits]), jax_file="bert.py"),
    ]
    out += xent_rows
    del logits, scratch, lse
    for r in ln_rows + xent_rows:
        print_row(r)
    per_call.update({r["name"]: r["ms"] for r in out})
    return out, per_call


def bert_check_phase(dev):
    """A BERT train step's loss and gradients on the kernels vs on the
    plain versions: BERT-large widths, 2 layers, remat, batch 2 x 512,
    f32 master weights."""
    cfg = dataclasses.replace(bert.bert_large(), n_layers=BERT_CHECK_LAYERS)
    params = bert.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    leaves = bert.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tokens, mask = (t.to(dev) for t in bert.synthetic_batch(cfg, BERT_CHECK_BATCH, BERT_SEQ,
                                                            seed=1))
    results = []
    for ops in (bert.KERNELS, bert.PLAIN):
        loss = bert.mlm_loss_fn(cfg, params, tokens, mask, ops)
        grads = torch.autograd.grad(loss, leaves)
        results.append((loss.item(), grads))
        del loss
    (k_loss, k_grads), (p_loss, p_grads) = results
    torch.cuda.synchronize()
    rels = [((g - w).norm() / w.norm().clamp_min(1e-30)).item() for g, w in zip(k_grads, p_grads)]
    worst = int(np.argmax(rels))
    print(f"bert train step, kernels vs plain (BERT-large widths, {cfg.n_layers} layers, "
          f"{BERT_CHECK_BATCH}x{BERT_SEQ} tokens, {int(mask.sum())} masked): loss "
          f"{k_loss:.6f} vs {p_loss:.6f} (tol {BERT_LOSS_TOL}), gradients: max relative L2 "
          f"{rels[worst]:.3e} at leaf {worst} of {len(rels)}, median {float(np.median(rels)):.3e} "
          f"(tol {BERT_GRAD_REL_L2_TOL})", flush=True)
    if not (np.isfinite(k_loss) and abs(k_loss - p_loss) <= BERT_LOSS_TOL):
        fail(f"bert train check: loss {k_loss} vs plain {p_loss}")
    if not all(np.isfinite(r) and r <= BERT_GRAD_REL_L2_TOL for r in rels):
        fail(f"bert train check: gradient {worst} relative L2 {rels[worst]:.3e}")


def bert_phase(card: str, per_call: dict) -> dict:
    """BERT-large (full width and depth, remat) trained for 5 AdamW steps on
    one fixed synthetic masked batch 32 x 512 through make_train_state /
    make_train_step: the fourth main path."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = bert.bert_large()
    t0 = time.monotonic()
    params, opt = bert.make_train_state(cfg, lr=BERT_LR, seed=0)  # device: the card
    n_params = sum(p.numel() for p in bert.param_leaves(params))
    step = bert.make_train_step(cfg, params, opt)
    tokens, mask = (t.cuda() for t in bert.synthetic_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0))
    torch.cuda.synchronize()
    print(f"bert: {n_params / 1e6:.2f} M parameters made in {time.monotonic() - t0:.1f} s",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    losses, times = [], []
    counter = FlopCounterMode(display=False)
    for i in range(BERT_STEPS):
        t1 = time.monotonic()
        if i == 0:  # the first step, which the mean leaves out, counts the FLOPs
            with counter:
                loss = step(tokens, mask)
        else:
            loss = step(tokens, mask)
        losses.append(loss.item())  # synchronises
        times.append(time.monotonic() - t1)
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"bert: losses {losses} (want finite, last below first)")
    per_step = bert_launches_per_step(cfg.n_layers)
    for name, n in launches.items():
        if n != per_step.get(name, 0) * BERT_STEPS:
            fail(f"bert: {name} launched {n} times in {BERT_STEPS} steps, "
                 f"want {per_step.get(name, 0)} per step")
    step_ms = float(np.mean(times[1:])) * 1e3
    per_call = {**per_call, "adamw": optimizer_step_ms(opt)}
    lib_adamw_ms = torch_adamw_ms(bert.param_leaves(params), 0.01)
    fused_adamw_ms = torch_adamw_ms(bert.param_leaves(params), 0.01, fused=True)
    tokens_per_step = BERT_BATCH * BERT_SEQ
    L, B, S, H, hd = cfg.n_layers, BERT_BATCH, BERT_SEQ, cfg.n_heads, cfg.head_dim
    pairs = B * H * hd * S * S  # the attention kernels' (query, key) pairs times hd
    # model FLOPs: 6 per matrix weight per token (the tied decode counts
    # embed; the gathers, LayerNorms and biases do not) plus attention's
    # 4 (forward) + 8 (backward) per pair and head dim, as PaLM counts it;
    # executed FLOPs: FlopCounterMode's count of the step (its matrix
    # products, the remat's second forward included; it cannot see the
    # hand kernels) plus the attention kernels' 2 x 4 + 10 (the backward
    # kernel recomputes Q K^T)
    mm_params = sum(p.numel() for p in bert.param_leaves(params) if p.dim() == 2
                    and p is not params["pos_embed"])
    model_flops = 6 * mm_params * tokens_per_step + 12 * L * pairs
    counted = float(counter.get_total_flops())
    executed_flops = counted + 18 * L * pairs
    kern_ms = sum(per_step[name] * per_call[name] for name in per_step) + (
        per_call["gelu_head"] - per_call["gelu"]) + (per_call["gelu_head_bwd"] - per_call["gelu_bwd"])
    prof = benchguard.collect_profile(lambda: float(step(tokens, mask)), top_n=8)
    device_ms = prof.get("device_time_us", 0.0) / 1e3
    res = dict(losses=losses, step_ms=step_ms, first_step_ms=times[0] * 1e3,
               tokens_per_s=tokens_per_step / step_ms * 1e3, peak_mem_gib=peak / 2 ** 30,
               launches=launches, model_flops=model_flops, counted_flops=counted,
               executed_flops=executed_flops,
               model_tflops_per_s=model_flops / step_ms / 1e9,
               mfu=model_flops / step_ms * 1e3 / PEAK_BF16_TENSOR,
               kernel_ms_per_step=kern_ms, device_ms=device_ms,
               optimizer_ms=per_call["adamw"], torch_adamw_ms=lib_adamw_ms,
               fused_adamw_ms=fused_adamw_ms)
    busy = (f"device_ms={device_ms:.2f} ({100 * device_ms / step_ms:.1f} % busy)" if device_ms
            else f"device time not measured ({prof.get('error')})")
    print(f"bert (BERT-large, {L} layers, {n_params / 1e6:.2f} M params, batch {B}x{S}, remat, "
          f"AdamW lr {BERT_LR}): losses={[round(x, 4) for x in losses]} step_ms={step_ms:.2f} "
          f"(first {res['first_step_ms']:.1f}) tokens_per_s={res['tokens_per_s']:.1f} "
          f"model_tflop_per_step={model_flops / 1e12:.3f} "
          f"model_tflops_per_s={res['model_tflops_per_s']:.1f} (MFU {100 * res['mfu']:.2f} % "
          f"of {PEAK_BF16_TENSOR:.3e}) flop_counter_tflop_per_step={counted / 1e12:.3f} "
          f"executed_tflops_per_s={executed_flops / step_ms / 1e9:.1f} "
          f"peak_mem_gib={res['peak_mem_gib']:.2f} kernels_ms_per_step={kern_ms:.2f} "
          f"({100 * kern_ms / step_ms:.1f} %) optimizer_ms={per_call['adamw']:.2f} (K10 AdamW, "
          f"bound {bound_ms(28 * n_params, 16 * n_params, PEAK_F32)[0]:.2f} ms; torch.optim.AdamW "
          f"foreach {lib_adamw_ms:.2f}, fused {fused_adamw_ms:.2f}) {busy} "
          f"launches_per_step={ {k: v // BERT_STEPS for k, v in launches.items() if v} } "
          f"on [{card}]", flush=True)
    print(f"bert step, top kernels by device time: {prof.get('top_ops')}", flush=True)
    del params, opt, step
    return res


# ------------------------------------------------------- ring attention (K6)


def ring_launches(n: int, causal: bool) -> dict:
    """The K6 launches of one ring of n ranks (forward and backward): a
    causal ring folds n diagonal and n(n-1)/2 behind blocks (the n(n-1)/2
    ahead are skipped), with one merge fewer than blocks on each rank; a
    non-causal ring folds all n^2 blocks.  tests/test_torch_ringattention.py
    asserts the same counts on the CPU."""
    if causal:
        behind = n * (n - 1) // 2
        return {"ring_block": n, "ring_block_nc": behind, "ring_merge": behind,
                "ring_block_bwd": n, "ring_block_bwd_nc": behind}
    return {"ring_block_nc": n * n, "ring_merge": n * (n - 1), "ring_block_bwd_nc": n * n}


def ring_qkv(B, S, gen, dev, cfg):
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return [bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv, H)]  # q, k, v, dout


def check_merge(name, o_acc, lse_a, o_blk, lse_n) -> float:
    """ring_merge, the f32 accumulator and the final bf16 output, against
    merge_plain: each element within MERGE_RTOL of the sum of the two
    terms' magnitudes (f32 arithmetic, exp and log in another library),
    the final bf16 output within one more bf16 step; lse within MERGE_RTOL
    relative, -inf exactly where the plain version has it."""
    want_o, want_lse = ring_kernels.merge_plain(o_acc, lse_a, o_blk, lse_n)
    terms = ring_kernels.merge_plain(o_acc.abs(), lse_a, o_blk.abs(), lse_n)[0]
    got_o, got_lse = ring_kernels.ring_merge_kernel(o_acc.clone(), lse_a, o_blk, lse_n)
    fin_o, fin_lse = ring_kernels.ring_merge_kernel(o_acc.clone(), lse_a, o_blk, lse_n, final=True)
    torch.cuda.synchronize()
    dead = want_lse == -float("inf")
    for lse in (got_lse, fin_lse):
        if not torch.equal(lse[dead], want_lse[dead]) or not bool(
                ((lse - want_lse).abs()[~dead] <= MERGE_RTOL * want_lse.abs()[~dead]).all()):
            fail(f"{name}: lse beyond {MERGE_RTOL} relative or -inf rows differ")
    err = (got_o - want_o).abs()
    if not torch.isfinite(got_o).all() or not bool((err <= MERGE_RTOL * terms).all()):
        fail(f"{name}: f32 output max abs err {err.max().item():.3e} beyond {MERGE_RTOL} "
             f"relative to the terms")
    want_b = want_o.to(torch.bfloat16).float()
    err_b = (fin_o.float() - want_b).abs()
    if not bool((err_b <= MERGE_RTOL * terms + 2.0 ** -7 * want_b.abs()).all()):
        fail(f"{name}: final bf16 output max abs err {err_b.max().item():.3e}")
    return max(err.max().item(), err_b.max().item())


def check_ring_bwd(name, q, k, v, do, lse, delta, causal, bufs, o=None, times=1) -> float:
    """ring_block_bwd adds the block's gradients into ``bufs`` (dq, dk, dv
    f32, holding ``times - 1`` such additions already); held to ``times``
    x block_bwd_plain (relative L2 of each, BWD_REL_L2_TOL)."""
    ring_kernels.ring_block_bwd_kernel(q, k, v, do, lse, delta, causal, *bufs, o=o)
    if o is not None:
        check_close(f"{name} delta", [delta], [ring_kernels.delta_plain(o, do)], (1e-4, 1e-5))
    want = ring_kernels.block_bwd_plain(q, k, v, do, lse, delta, causal)
    err = check_rel_l2(name, bufs, [times * w for w in want], BWD_REL_L2_TOL)
    del want
    # each pass in its accumulating mode against its plain version
    dq, dk, dv = (torch.zeros_like(b) for b in bufs)
    ring_kernels.block_bwd_dkdv_op_plain(q, k, v, do, lse, delta, causal, dk, dv)
    check_rel_l2(f"{name}: dK/dV pass vs its plain version", bufs[1:], [times * dk, times * dv],
                 BWD_REL_L2_TOL)
    del dk, dv
    ring_kernels.block_bwd_dq_op_plain(q, k, v, do, lse, delta, causal, dq)
    check_rel_l2(f"{name}: dQ pass vs its plain version", bufs[:1], [times * dq], BWD_REL_L2_TOL)
    return err


def check_ring_blocks(q, k1, v1, k0, v0, do) -> dict:
    """K6 against the plain versions on a 2-rank causal ring's second rank,
    by hand: the diagonal block (k1, v1) and the one behind it (k0, v0),
    the merge of the two (the f32 accumulator and the final bf16 output),
    and each block's accumulating backward with the final lse and delta,
    the block behind adding into the diagonal's dq as the ring does; and
    rows with nothing folded in the merge, a backward added twice.
    Returns each kernel's max abs error."""
    Sb = q.shape[1]
    o_d, lse_d = ring_kernels.ring_block_kernel(q, k1, v1, Sb, Sb, True)
    want = ring_kernels.block_attn_plain(q, k1, v1, Sb, Sb, True)
    errs = {"ring_block": check_close("ring_block diagonal", [o_d], want[:1], ATTENTION_TOL)}
    check_close("ring_block diagonal lse", [lse_d], want[1:], (1e-4, 1e-5))
    o_b, lse_b = ring_kernels.ring_block_kernel(q, k0, v0, Sb, 0, True)
    want = ring_kernels.block_attn_plain(q, k0, v0, Sb, 0, True)
    errs["ring_block_nc"] = check_close("ring_block behind", [o_b], want[:1], ATTENTION_TOL)
    check_close("ring_block behind lse", [lse_b], want[1:], (1e-4, 1e-5))
    del want
    errs["ring_merge"] = check_merge("ring_merge", o_d.float(), lse_d, o_b, lse_b)
    o_a, lse_a, o_n, lse_n = o_d.float(), lse_d.clone(), o_b.clone(), lse_b.clone()
    o_a[:, :64], lse_a[..., :64] = 0, -float("inf")  # nothing folded yet in rows 0-63, and
    o_n[:, :32], lse_n[..., :32] = 0, -float("inf")  # a block with rows 0-31 fully masked
    errs["ring_merge"] = max(errs["ring_merge"], check_merge("ring_merge, dead rows", o_a, lse_a,
                                                             o_n, lse_n))
    del o_a, lse_a, o_n, lse_n
    o, lse = ring_kernels.ring_merge_kernel(o_d.float(), lse_d, o_b, lse_b, final=True)
    delta = torch.empty_like(lse)
    f32 = partial(torch.zeros, dtype=torch.float32, device=q.device)
    dq = f32(q.shape)
    errs["ring_block_bwd"] = check_ring_bwd("ring_block_bwd diagonal", q, k1, v1, do, lse, delta,
                                            True, [dq, f32(k1.shape), f32(k1.shape)], o=o)
    bufs = [f32(q.shape), f32(k0.shape), f32(k0.shape)]
    ring_kernels.ring_block_bwd_kernel(q, k0, v0, do, lse, delta, False, *bufs)
    errs["ring_block_bwd_nc"] = check_ring_bwd("ring_block_bwd behind, added twice", q, k0, v0, do,
                                               lse, delta, False, bufs, times=2)
    # and into the diagonal's dq, as the ring adds both there
    ring_kernels.ring_block_bwd_kernel(q, k0, v0, do, lse, delta, False, dq, *bufs[1:])
    check_rel_l2("ring_block_bwd dq of both blocks", [dq], [
        ring_kernels.block_bwd_plain(q, k1, v1, do, lse, delta, True)[0]
        + ring_kernels.block_bwd_plain(q, k0, v0, do, lse, delta, False)[0]], BWD_REL_L2_TOL)
    return errs


def determinism_phase(dev):
    """The backward has no atomics: two runs on the same inputs must give
    the same bits.  Causal at the Llama train shape (K1), non-causal at
    BERT-large's (K7a), and a ring block pair (diagonal, then the block
    behind) accumulating into f32 buffers (K6); K8's statistics and
    backward at the stem and stage 4; K9's backward at BERT's d_ff; K7b's
    backward at two widths; K2's backward at 8192 x 4096 and 8192 x 2048."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg, bcfg = llama.llama_3_8b(), bert.bert_large()
    cases = (("K1 causal", TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, True),
             ("K7a non-causal", BERT_BATCH, BERT_SEQ, bcfg.n_heads, bcfg.n_heads, bcfg.head_dim,
              False))
    for name, B, S, H, Hkv, hd, causal in cases:
        q, k, v, do = (bf16((B, S, h, hd), gen, dev) for h in (H, Hkv, Hkv, H))
        o, lse = attention.attention_kernel(q, k, v, with_lse=True, causal=causal)
        runs = [attention.attention_bwd_kernel(q, k, v, o, lse, do, causal) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"attention backward {name} (B={B} S={S} H={H}/{Hkv} hd={hd}): two runs differ")
        print(f"attention backward {name} B={B} S={S} H={H}/{Hkv} hd={hd}: two runs bit-identical",
              flush=True)
        del q, k, v, do, o, lse, runs
    Sb = RING_NC_BLOCK
    q, k1, v1, do = ring_qkv(1, Sb, gen, dev, cfg)
    k0, v0 = (bf16(k1.shape, gen, dev) for _ in range(2))
    o_d, lse_d = ring_kernels.ring_block_kernel(q, k1, v1, Sb, Sb, True)
    o_b, lse_b = ring_kernels.ring_block_kernel(q, k0, v0, Sb, 0, True)
    o, lse = ring_kernels.ring_merge_kernel(o_d.float(), lse_d, o_b, lse_b, final=True)
    runs = []
    for _ in range(2):
        delta = torch.empty_like(lse)
        bufs = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in (q, k1, v1)]
        ring_kernels.ring_block_bwd_kernel(q, k1, v1, do, lse, delta, True, *bufs, o=o)
        ring_kernels.ring_block_bwd_kernel(q, k0, v0, do, lse, delta, False, *bufs)
        runs.append(bufs + [delta])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        fail("ring_block_bwd pair (ACCUM): two runs differ")
    print(f"ring_block_bwd pair (diagonal then behind, accumulating, block {Sb}): two runs "
          f"bit-identical", flush=True)
    del q, k1, v1, k0, v0, do, o_d, lse_d, o_b, lse_b, o, lse, runs
    # K8: the statistics and the backward sum across blocks in a fixed order
    # (a ticket picks which block adds the partials, not their order)
    for where, side, C, res in (BN_TIMED[0], BN_TIMED[-1]):
        M = RESNET_BATCH * side * side
        x, sc, bi, r = bn_inputs(M, C, gen, dev, res)
        dy = bf16((M, C), gen, dev)
        stats_runs = [batchnorm.bn_stats_kernel(x, sc, bi) for _ in range(2)]
        w, _b, stats = stats_runs[0]
        _y, mask = batchnorm.bn_apply_kernel(x, w, _b, r, True)
        bwd_runs = [batchnorm.bn_bwd_kernel(x, mask, dy, w, sc, stats, res) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*stats_runs)):
            fail(f"bn_stats {where} (M={M} C={C}): two runs differ")
        if not all(torch.equal(a, b) for a, b in zip(*bwd_runs) if a is not None):
            fail(f"bn_bwd {where} (M={M} C={C}): two runs differ")
        print(f"bn_stats and bn_bwd {where} M={M} C={C}: two runs bit-identical", flush=True)
        del x, dy, r, mask, stats_runs, bwd_runs
    x = bf16((BERT_BATCH * BERT_SEQ, bcfg.d_ff), gen, dev, 2.0)
    dy = bf16(x.shape, gen, dev)
    if not torch.equal(gelu.gelu_bwd_kernel(x, dy), gelu.gelu_bwd_kernel(x, dy)):
        fail("gelu_bwd: two runs differ")
    print(f"gelu_bwd {tuple(x.shape)}: two runs bit-identical", flush=True)
    # K7b: dscale and dbias sum over the blocks' partials in a fixed order
    for rows, d in ((BERT_BATCH * BERT_SEQ, bcfg.d_model), LN_WIDTH_CLASSES[-1]):
        x, sc, _bi = ln_inputs(rows, d, gen, dev)
        dy = bf16(x.shape, gen, dev)
        runs = [layernorm.layernorm_bwd_kernel(x, sc, dy) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"layernorm_bwd ({rows}, {d}): two runs differ")
        print(f"layernorm_bwd ({rows}, {d}): dx, dscale and dbias of two runs bit-identical",
              flush=True)
    # K2: dscale sums over the blocks' partials in a fixed order
    rows = TRAIN_BATCH * TRAIN_SEQ
    for d in (cfg.d_model, RMS_BENCH_D):
        x, dy = bf16((rows, d), gen, dev), bf16((rows, d), gen, dev)
        sc = bf16((d,), gen, dev, 0.1, 1.0)
        runs = [rmsnorm.rmsnorm_bwd_kernel(x, sc, dy) for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"rmsnorm_bwd ({rows}, {d}): two runs differ")
        print(f"rmsnorm_bwd ({rows}, {d}): dx and dscale of two runs bit-identical", flush=True)


def attention_build_report():
    """What ptxas reported for the attention kernels (registers at entry,
    spills) and each kernel's launch shape (dynamic shared memory, threads,
    registers a consumer thread after setmaxnreg), at the main paths' head
    dims."""
    log = build.compile_log("attention")
    if not log:
        print("attention ptxas report: the library was not rebuilt in this run", flush=True)
        return
    pat = re.compile(r"Compiling entry function '\S*?(attention_(?:fwd|bwd_dkdv|bwd_dq)_kernel)"
                     r"(?:ILi(\d+)ELb([01])E(?:Lb([01])E)?)?\S*'.*?\n.*?\n\s*\d+ bytes stack "
                     r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\nptxas info\s*: "
                     r"Used (\d+) registers")
    names = {"attention_fwd_kernel": "forward", "attention_bwd_dkdv_kernel": "dK/dV pass",
             "attention_bwd_dq_kernel": "dQ pass"}
    info = {hd: attention.kernel_info(hd) for hd in (64, 128)}
    for m in pat.finditer(log):
        kern, hd, causal, accum, st, ld, regs = m.groups()
        if kern not in names or int(hd) not in info:
            continue
        smem, threads, cregs = info[int(hd)][names[kern]]
        print(f"ptxas {names[kern]} hd={hd} causal={causal}"
              f"{'' if accum is None else f' accum={accum}'}: {regs} registers at entry, "
              f"{cregs} a consumer thread after setmaxnreg, spill stores {st} B, loads {ld} B; "
              f"{threads} threads, {smem} B dynamic shared memory", flush=True)
    # wgmma serialised or fenced by the compiler (C75xx), by advisory code
    codes = {}
    for code in re.findall(r"\((C75\d\d)\)", log):
        codes[code] = codes.get(code, 0) + 1
    print(f"ptxas wgmma advisories: {codes or 'none'}", flush=True)


def ptxas_report(source: str):
    """What ptxas reported for each kernel of csrc/<source>.cu: registers,
    spills, shared memory."""
    log = build.compile_log(source)
    if not log:
        print(f"{source} ptxas report: the library was not rebuilt in this run", flush=True)
        return
    pat = re.compile(r"Compiling entry function '(\S+)'.*?\n.*?\n\s*\d+ bytes stack frame, "
                     r"(\d+) bytes spill stores, (\d+) bytes spill loads\nptxas info\s*: "
                     r"Used (\d+) registers(.*)")
    for m in pat.finditer(log):
        mangled, st, ld, regs, rest = m.groups()
        smem = re.search(r"(\d+) bytes smem", rest)
        print(f"ptxas {source} {readable_kernel(mangled)}: {regs} registers, spill stores {st} B, "
              f"loads {ld} B, {smem.group(1) if smem else 0} B static shared memory", flush=True)


def readable_kernel(mangled: str) -> str:
    """A kernel's name (lower case, ending in _kernel) from its mangled
    one, with its template argument."""
    m = re.search(r"(?<=\d)([a-z]+(?:_[a-z]+\d*)*_kernel)(ILb[01]E|IiE|IxE)?", mangled)
    if m is None:
        return mangled
    arg = {"ILb0E": "<false>", "ILb1E": "<true>", "IiE": "<int>", "IxE": "<long long>"}
    return m.group(1) + arg.get(m.group(2) or "", "")


def sass_counts(source: str) -> dict:
    """SASS instructions of each kernel of csrc/<source>.cu's library
    (cuobjdump -sass), by kind: all of them, MUFU (the special-function
    unit: tanhf's exponential and reciprocal), FP32 arithmetic, global
    loads and stores.  {} where the toolkit has no cuobjdump."""
    tool = build.toolkit_binary("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", str(build.build_all([source])[source])],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    fp32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"}
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = counts.setdefault(readable_kernel(m.group(1)), dict.fromkeys(
                ("all", "mufu", "fp32", "ldg", "stg"), 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if cur is None or m is None or m.group(1) == "NOP":
            continue
        op = m.group(1)
        cur["all"] += 1
        kind = ("mufu" if op == "MUFU" else "fp32" if op in fp32 else
                "ldg" if op == "LDG" else "stg" if op == "STG" else None)
        if kind:
            cur[kind] += 1
    return counts


def gelu_issue_report(x, dy, rows):
    """Whether K9 waits on issue or on bytes at this shape: its SASS per
    element (a thread runs the kernel once, storing one 16-byte vector of 8
    elements per STG) against what 132 SMs issue at 4 warp-instructions a
    cycle at the card's top SM clock; and, for the bytes, a torch copy (the
    forward's 4 bytes an element) and add (the backward's 6) on the same
    tensors, timed here."""
    n = x.numel()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    counts = sass_counts("gelu")
    out = torch.empty_like(x)
    floors = {"gelu_fwd_kernel<int>": time_ms(lambda: out.copy_(x)),
              "gelu_bwd_kernel<int>": time_ms(lambda: torch.add(x, dy, out=out))}
    for (kern, floor), r in zip(floors.items(), rows):
        c = counts.get(kern)
        if c is None:
            print(f"gelu {kern}: no SASS (cuobjdump not found or kernel missing)", flush=True)
            continue
        elems = 8 * c["stg"]  # a thread's elements
        per_elem = c["all"] / elems
        issue_ms = n / 32 * per_elem / (4 * 132 * mhz * 1e6) * 1e3
        print(f"gelu {kern} at n={n}: SASS {c} -> {per_elem:.1f} instructions and "
              f"{c['mufu'] / elems:.2f} MUFU an element; issue at 4 warp-instructions a cycle "
              f"on 132 SMs at {mhz:.0f} MHz: {issue_ms:.4f} ms; bytes: bound "
              f"{r['bound_ms']:.4f} ms, a torch {'copy' if 'fwd' in kern else 'add'} of the "
              f"same bytes {floor:.4f} ms; kernel {r['ms']:.4f} ms", flush=True)


def ring_kernel_phase(dev, gen) -> list:
    """K6 against the plain versions at Llama-3-8B's attention widths, at
    both of the ring phase's blocks: 2048 (the non-causal ring's) and
    8192 (the causal ring's and the NCCL entry's), where each is also timed, with
    its bound and one-call library yardstick.  The rows carry the errors
    at 8192, the shape they name."""
    cfg = llama.llama_3_8b()
    B, H, hd = 1, cfg.n_heads, cfg.head_dim
    errs = {}
    for Sb in (RING_NC_BLOCK, RING_BLOCK):
        q, k1, v1, do = ring_qkv(B, Sb, gen, dev, cfg)
        k0, v0 = (bf16(k1.shape, gen, dev) for _ in range(2))
        errs[Sb] = check_ring_blocks(q, k1, v1, k0, v0, do)
        print(f"ring kernels against their plain versions at block {Sb}: max abs err "
              f"{ {k: float(f'{e:.3e}') for k, e in errs[Sb].items()} }", flush=True)
        del q, k1, v1, do, k0, v0
        free_memory()
    errs = errs[RING_BLOCK]

    out = []
    Sb = RING_BLOCK
    q, k, v, do = ring_qkv(B, Sb, gen, dev, cfg)
    G = H // cfg.n_kv_heads
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k.repeat_interleave(G, 2),
                                                  v.repeat_interleave(G, 2), do))
    shape = f"B={B} block={Sb} H={H} Hkv={cfg.n_kv_heads} hd={hd}"
    n, nk, stats = q.numel(), k.numel(), 4 * B * H * Sb
    for name, q_off, kv_off, pairs in (("ring_block", Sb, Sb, Sb * (Sb + 1) / 2),
                                       ("ring_block_nc", Sb, 0, Sb * Sb)):
        causal = q_off == kv_off
        flash = torch.ops.aten._scaled_dot_product_flash_attention
        out.append(row(name, "attention.cu", 29, f"{shape} {'diagonal' if causal else 'behind'}",
                       errs[name],
                       time_ms(lambda: ring_kernels.ring_block_kernel(q, k, v, q_off, kv_off, True)),
                       time_ms(lambda: ring_kernels.block_attn_plain(q, k, v, q_off, kv_off, True),
                               2, 1),
                       bound_ms(2 * (2 * n + 2 * nk) + stats, 4 * B * H * hd * pairs,
                                PEAK_BF16_TENSOR),
                       time_ms(lambda: flash(qt, kt, vt, 0.0, causal)), jax_file="ringattention.py"))
    o_d, lse_d = ring_kernels.ring_block_kernel(q, k, v, Sb, Sb, True)
    o_b, lse_b = ring_kernels.ring_block_kernel(q, k, v, Sb, 0, True)
    acc = o_d.float()
    merge_bytes = 4 * n + 2 * n + 4 * n + 3 * stats  # o_acc read, o_blk read, o_acc written, lses
    out.append(row("ring_merge", "ring_merge.cu", 50, shape, errs["ring_merge"],
                   time_ms(lambda: ring_kernels.ring_merge_kernel(acc, lse_d, o_b, lse_b)),
                   time_ms(lambda: ring_kernels.merge_op_plain(acc, lse_d, o_b, lse_b), 5, 1),
                   bound_ms(merge_bytes, 3 * n + 8 * stats // 4, PEAK_F32), None,
                   jax_file="ringattention.py"))
    fin_ms = time_ms(lambda: ring_kernels.ring_merge_kernel(acc, lse_d, o_b, lse_b, final=True))
    print(f"ring_merge final (bf16 output) ms={fin_ms:.4f} bound_ms="
          f"{bound_ms(4 * n + 2 * n + 2 * n + 3 * stats, 3 * n, PEAK_F32)[0]:.4f}", flush=True)
    delta = ring_kernels.delta_plain(o_d, do).contiguous()
    bufs = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in (q, k, v)]
    for name, lse, causal, pairs in (("ring_block_bwd", lse_d, True, Sb * (Sb + 1) / 2),
                                     ("ring_block_bwd_nc", lse_b, False, Sb * Sb)):
        bwd_bytes = 2 * (2 * n + 2 * nk) + 2 * stats + 8 * n + 8 * 2 * nk
        out.append(row(name, "attention.cu", "29,50", f"{shape} {'diagonal' if causal else 'behind'}",
                       errs[name],
                       time_ms(lambda: ring_kernels.ring_block_bwd_kernel(
                           q, k, v, do, lse, delta, causal, *bufs), 10, 2),
                       time_ms(lambda: ring_kernels.block_bwd_plain(q, k, v, do, lse, delta, causal),
                               2, 1),
                       bound_ms(bwd_bytes, 10 * B * H * hd * pairs, PEAK_BF16_TENSOR),
                       library_bwd_ms(partial(F.scaled_dot_product_attention, is_causal=causal),
                                      [qt, kt, vt], [dot]), jax_file="ringattention.py"))
    for r in out:
        print_row(r)
    return out


def lockstep_ring(n, Sb, causal, gen, dev, cfg):
    """The inputs of an n-rank ring of blocks Sb (q, k, v, dout at the whole
    length) and, before it runs, the dense attention kernel's output and
    gradients on them: K1 (causal) or K7a, timed (CUDA events, the second
    of two calls each; the first pays the allocator's first requests).
    Returns (inputs, dense, dense forward ms, dense backward ms)."""
    q, k, v, do = ring_qkv(1, n * Sb, gen, dev, cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(2):
        ev[0].record()
        o, lse = attention.attention_kernel(q, k, v, with_lse=True, causal=causal)
        ev[1].record()
        grads = attention.attention_bwd_kernel(q, k, v, o, lse, do, causal=causal)
        ev[2].record()
        torch.cuda.synchronize()
    return (q, k, v, do), (o, *grads), ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def run_lockstep(inputs, n, causal, ops=ringattention.KERNELS) -> tuple:
    """The ring's steps for n virtual ranks on this card, on ``ops`` (the
    kernels, or the plain versions), timed (CUDA events, one call each):
    (outputs and gradients at the whole length, forward ms, backward ms)."""
    qs, ks, vs, dos = ([t[:, r * (t.shape[1] // n):(r + 1) * (t.shape[1] // n)].contiguous()
                        for r in range(n)] for t in inputs)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    os_, lses = ringattention.lockstep_forward(qs, ks, vs, causal, ops)
    ev[1].record()
    grads = ringattention.lockstep_backward(qs, ks, vs, os_, lses, dos, causal, ops)
    ev[2].record()
    torch.cuda.synchronize()
    got = [torch.cat(ts, 1) for ts in (os_, *grads)]
    return got, ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def ring_entry_run(q, k, v, do) -> list:
    """``ring_attention`` itself, forward and backward, over a 1-rank NCCL
    group on this card (rendezvous through a FileStore in a temp dir)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = tempfile.mkdtemp(prefix="ring_store")
    try:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("sp",))
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            o = ringattention.ring_attention(*leaves, mesh, "sp", causal=True)
            o.backward(do)
            torch.cuda.synchronize()
            return [o.detach()] + [t.grad for t in leaves]
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_ring(name, got, want) -> str:
    """A ring's output and gradients against another's (the dense kernel's,
    or the same ring on the plain versions): the output
    within RING_OUT_TOL (max abs, relative L2), each gradient within
    RING_GRAD_REL_L2_TOL.  Returns the errors, printable."""
    err_o = check_rel_l2(f"{name} output", got[:1], want[:1], RING_OUT_TOL[1])
    if err_o > RING_OUT_TOL[0]:
        fail(f"{name} output: max abs err {err_o:.3e} beyond {RING_OUT_TOL[0]}")
    err_g = check_rel_l2(f"{name} gradients", got[1:], want[1:], RING_GRAD_REL_L2_TOL)
    rels = [((g.float() - w.float()).norm() / w.float().norm()).item() for g, w in zip(got, want)]
    return (f"o max abs err {err_o:.3e}, gradients max abs err {err_g:.3e}, relative L2 of o, dq, "
            f"dk, dv {[float(f'{r:.3e}') for r in rels]} (tol {RING_OUT_TOL}, "
            f"{RING_GRAD_REL_L2_TOL})")


def ring_phase(dev, card: str) -> dict:
    """Ring attention at Llama-3-8B's attention widths: an 8-rank causal
    ring of 8192-token blocks (a 65,536-token context) and a 4-rank
    non-causal ring of 2048-token blocks, each rank's steps run in
    lockstep on this card, forward and backward, and ring_attention over a
    1-rank NCCL group.  Each lockstep ring is held to the same ring run on
    the plain versions (ringattention.PLAIN) and to the dense kernel (K1,
    K7a) at the whole length."""
    cfg = llama.llama_3_8b()
    gen = torch.Generator(device=dev).manual_seed(5)
    n, Sb = RING_RANKS, cfg.max_seq
    causal_in, causal_dense, dense_fwd_ms, dense_bwd_ms = lockstep_ring(n, Sb, True, gen, dev, cfg)
    nc_in, nc_dense, nc_dense_fwd_ms, nc_dense_bwd_ms = lockstep_ring(
        RING_NC_RANKS, RING_NC_BLOCK, False, gen, dev, cfg)
    entry_in = [t[:, :Sb].contiguous() for t in causal_in]
    o, lse = attention.attention_kernel(*entry_in[:3], with_lse=True)
    entry_dense = [o, *attention.attention_bwd_kernel(*entry_in[:3], o, lse, entry_in[3])]
    run_lockstep(causal_in, n, True)  # the allocator's first requests
    run_lockstep(nc_in, RING_NC_RANKS, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in KERNELS.values():
        kern.launches = 0
    causal_got, fwd_ms, bwd_ms = run_lockstep(causal_in, n, True)
    causal_launches = {name: kern.launches for name, kern in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    nc_got, nc_fwd_ms, nc_bwd_ms = run_lockstep(nc_in, RING_NC_RANKS, False)
    entry_got = ring_entry_run(*entry_in)
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    # the same rings on the plain versions, after the kernels' (whose times
    # they would otherwise disturb)
    causal_plain, plain_fwd_ms, plain_bwd_ms = run_lockstep(causal_in, n, True,
                                                            ringattention.PLAIN)
    nc_plain = run_lockstep(nc_in, RING_NC_RANKS, False, ringattention.PLAIN)[0]

    want = ring_launches(n, True)
    for name, cnt in causal_launches.items():
        if cnt != want.get(name, 0):
            fail(f"ring: {name} launched {cnt} times in the {n}-rank causal ring, want "
                 f"{want.get(name, 0)}")
    want_all = {k: want.get(k, 0) + ring_launches(RING_NC_RANKS, False).get(k, 0)
                + ring_launches(1, True).get(k, 0) for k in KERNELS}
    if launches != want_all:
        fail(f"ring: launches {launches}, want {want_all}")
    plain_errs = check_ring(f"ring {n}x{Sb} causal vs the plain ring", causal_got, causal_plain)
    errs = check_ring(f"ring {n}x{Sb} causal vs dense K1", causal_got, causal_dense)
    nc_plain_errs = check_ring(f"ring {RING_NC_RANKS}x{RING_NC_BLOCK} non-causal vs the plain ring",
                               nc_got, nc_plain)
    nc_errs = check_ring(f"ring {RING_NC_RANKS}x{RING_NC_BLOCK} non-causal vs dense K7a", nc_got,
                         nc_dense)
    # one rank: the ring's output is K1's block output as it stands
    if not torch.equal(entry_got[0], entry_dense[0]):
        fail("ring_attention over 1 NCCL rank: output differs from K1's")
    # dK and dV: the same pass's sums, added to 0 in f32, rounded once
    # as K1 rounds them (one bf16 step allowed); dQ: the same dQ pass, its
    # scaled sum added to 0 in f32 and rounded once (bit-equality reported)
    e_dkv = check_close("ring_attention over 1 NCCL rank dk, dv", entry_got[2:], entry_dense[2:],
                        (0.0, 2.0 ** -7))
    same = [bool(torch.equal(g, w)) for g, w in zip(entry_got[2:], entry_dense[2:])]
    e_dq = check_rel_l2("ring_attention over 1 NCCL rank dq", entry_got[1:2], entry_dense[1:2],
                        BWD_REL_L2_TOL)
    dq_same = bool(torch.equal(entry_got[1], entry_dense[1]))
    res = dict(launches=launches, fwd_ms=fwd_ms, bwd_ms=bwd_ms, peak_mem_gib=peak / 2 ** 30)
    print(f"ring (Llama-3-8B attention widths, {n} ranks x {Sb} tokens = {n * Sb} causal, "
          f"lockstep on one card): fwd_ms={fwd_ms:.2f} bwd_ms={bwd_ms:.2f} (dense K1, the same "
          f"work in one call each: fwd_ms={dense_fwd_ms:.2f} bwd_ms={dense_bwd_ms:.2f}) "
          f"peak_mem_gib={res['peak_mem_gib']:.2f} (dense references resident) "
          f"launches_per_ring={ {k: v for k, v in causal_launches.items() if v} } "
          f"vs the plain ring (fwd_ms={plain_fwd_ms:.2f} bwd_ms={plain_bwd_ms:.2f}): {plain_errs}; "
          f"vs dense K1: {errs} on [{card}]", flush=True)
    print(f"ring ({RING_NC_RANKS} ranks x {RING_NC_BLOCK} tokens, non-causal, lockstep): "
          f"fwd_ms={nc_fwd_ms:.2f} bwd_ms={nc_bwd_ms:.2f} (dense K7a: fwd_ms={nc_dense_fwd_ms:.2f} "
          f"bwd_ms={nc_dense_bwd_ms:.2f}) vs the plain ring: {nc_plain_errs}; vs dense K7a: "
          f"{nc_errs}", flush=True)
    print(f"ring_attention over a 1-rank NCCL group (1 x {Sb}): output equal to K1's bit for bit; "
          f"dk, dv bit-equal: {same}, max abs err {e_dkv:.3e} (one bf16 step allowed); dq "
          f"bit-equal: {dq_same}, max abs err {e_dq:.3e} (rel L2 tol {BWD_REL_L2_TOL})", flush=True)
    return res


# ---------------------------------------- optimizer updates (K10, K10b, K10c)


ADAFACTOR_NO_LIBRARY = ("none exists: torch.optim.Adafactor is another algorithm (no block-RMS "
                        "clip of optax's kind, no parameter-scale rule, another decay)")


def bench_weights(dev, gen) -> list:
    """The llama_bench 1b-tpu preset's f32 weights at full width as JAX
    leaf groups (embed (32000, 2048), 22 layers, final norm, unembed), and
    two more leaves whose sizes are not multiples of 4 floats: a (1001,)
    vector and a factored (129, 131) matrix."""
    cfg = llama.LlamaConfig(**llama_bench.PRESETS[BENCH_PRESET])
    params = llama.init_params(cfg, gen, dtype=torch.float32)
    odd = [("odd_vector", [torch.randn(1001, generator=gen, device=dev)]),
           ("odd_matrix", [torch.randn((129, 131), generator=gen, device=dev)])]
    return llama.leaf_groups(params) + odd


def clone_groups(groups) -> list:
    return [(name, [t.detach().clone() for t in ts]) for name, ts in groups]


def make_opt(name: str, groups):
    leaves = [t for _n, ts in groups for t in ts]
    if name == "adamw":
        return optim.AdamW(leaves, lr=OPTIM_LR, weight_decay=0.1)
    if name == "sgdm":
        return optim.SGD(leaves, lr=OPTIM_LR, momentum=0.9)
    return optim.Adafactor(groups, lr=OPTIM_LR)


def run_plain(name: str, opt):
    """The update's plain version on the optimizer's own table and count."""
    h = opt.param_groups[0]
    if name == "adamw":
        optim_kernels.adamw_plain(opt.table, opt.count, h["lr"], *h["betas"], h["eps"],
                                  h["weight_decay"])
    elif name == "sgdm":
        optim_kernels.sgdm_plain(opt.table, h["lr"], h["momentum"])
    else:
        optim_kernels.adafactor_plain(opt.table, opt.count, h["lr"])


def run_kernel(name: str, opt):
    """The update's kernel on the optimizer's own table and count: what
    opt.step() launches, without its gradient refresh."""
    h = opt.param_groups[0]
    if name == "adamw":
        optim_kernels.adamw_kernel(opt.table, opt.count, h["lr"], *h["betas"], h["eps"],
                                   h["weight_decay"])
    elif name == "sgdm":
        optim_kernels.sgdm_kernel(opt.table, h["lr"], h["momentum"])
    else:
        optim_kernels.adafactor_kernel(opt.table, opt.count, h["lr"])


def optim_bound(name: str, table) -> tuple:
    """The least an update must move (each input read once, each output
    written once) and its f32 operations, over the table's leaves."""
    nbytes = flops = 0
    for leaf in table.leaves:
        n = leaf.p.numel()
        if name == "adamw":      # p, g, m, v in; p, m, v out; ~16 flops
            nbytes, flops = nbytes + 28 * n, flops + 16 * n
        elif name == "sgdm":     # p, g, t in; p, t out; 4 flops
            nbytes, flops = nbytes + 20 * n, flops + 4 * n
        elif leaf.mode == optim_kernels.FLAT:  # p, g, v in; p, v out
            nbytes, flops = nbytes + 20 * n, flops + 14 * n
        else:                    # p, g in; p out; v_row, v_col in and out
            stats = sum(s.numel() for s in leaf.states)
            nbytes, flops = nbytes + 12 * n + 8 * stats, flops + 14 * n
    return bound_ms(nbytes, flops, PEAK_F32)


def adafactor_moved_bytes(table) -> int:
    """The bytes one K10b call moves by its own count, its sum of p^2
    carried from the last call: a factored leaf has g read by A, B and C
    and p read and written by C (20 bytes a parameter), its tile sums
    written by A and read by FA, its v_row and v_col read and written by
    FA and read by B and C; an unfactored leaf has g and v read and v
    written by B, p, g and v read and p written by C (28 bytes)."""
    total = 0
    for leaf in table.leaves:
        n = leaf.p.numel()
        if leaf.mode == optim_kernels.FLAT:
            total += 28 * n
            continue
        R, C = leaf.p.shape
        tile_sums = -(-R // optim_kernels.ROWS) * C + -(-C // optim_kernels.COLS) * R
        total += 20 * n + 8 * tile_sums + 16 * (R + C)
    return total


ADAFACTOR_PASSES = ("adafactor_a_kernel", "adafactor_fa_kernel", "adafactor_b_kernel",
                    "adafactor_fb_kernel", "adafactor_c_kernel")


def adafactor_passes_ms(opt, calls: int = 3) -> dict:
    """K10b's five launches under torch.profiler: each pass's device ms a
    call (A, FA, B, FB, C), p's sum of squares carried (one call first
    reads p, after whatever wrote it)."""
    from torch.profiler import ProfilerActivity, profile

    run_kernel("adafactor", opt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run_kernel("adafactor", opt)
        torch.cuda.synchronize()
    us, n = dict.fromkeys(ADAFACTOR_PASSES, 0.0), dict.fromkeys(ADAFACTOR_PASSES, 0)
    for ev in prof.key_averages():
        for name in ADAFACTOR_PASSES:
            if name in ev.key and benchguard.is_device_op(ev):
                us[name] += benchguard.device_time_us(ev)
                n[name] += ev.count
    # a mean over the launches the trace holds (it may miss the window's first)
    return {name: round(us[name] / max(n[name], 1) / 1e3, 4) for name in ADAFACTOR_PASSES}


def adafactor_read_p_ms(opt) -> float:
    """K10b's time when it reads p, as at a first update: the table
    forgets the parameters' versions before each call."""
    def call():
        opt.table.forget_params()
        run_kernel("adafactor", opt)
    return time_ms(call, 10, 2)


def adafactor_carry_check(groups, gen) -> float:
    """K10b's carried sum of p^2 against reading p: CARRY_STEPS updates of
    copies of the same weights with the same gradients, one run with
    p.add_(0) before each step (so every A reads p), one without (A reads
    p only where the table says so: the first step and after the edit);
    p.mul_(0.5) before step CARRY_EDIT_STEP in both and in the plain
    version.  The two kernel runs must agree bit for bit, and with the
    plain version to OPTIM_TOL.  Returns the max abs error against it."""
    opts = {k: make_opt("adafactor", clone_groups(groups)) for k in ("read", "carry", "plain")}
    leaves = {k: [p for g in o.param_groups for p in g["params"]] for k, o in opts.items()}
    reads = []
    for step in range(CARRY_STEPS):
        grads = [torch.randn(p.shape, generator=gen, device=p.device) for p in leaves["read"]]
        with torch.no_grad():
            for k, ps in leaves.items():
                for p, g in zip(ps, grads):
                    if step == CARRY_EDIT_STEP:
                        p.mul_(0.5)
                    if k == "read":
                        p.add_(0)
                    p.grad = g
        reads.append(tuple(opts[k].table.must_read_params() for k in ("read", "carry")))
        opts["read"].step()
        opts["carry"].step()
        opts["plain"].table.set_grads(grads)
        run_plain("adafactor", opts["plain"])
    want = [(True, step in (0, CARRY_EDIT_STEP)) for step in range(CARRY_STEPS)]
    if reads != want:
        fail(f"adafactor carry: the table asked for p at {reads}, want {want}")
    pairs = list(zip(leaves["read"], leaves["carry"]))
    pairs += [(opts["read"].state[a][key], opts["carry"].state[b][key])
              for a, b in zip(leaves["read"], leaves["carry"]) for key in opts["read"].state[a]]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in pairs):
        fail(f"adafactor carry: {CARRY_STEPS} steps carrying sum(p^2) differ from {CARRY_STEPS} "
             f"steps reading p")
    err = check_close("adafactor after p.mul_(0.5), kernel vs plain", leaves["carry"],
                      leaves["plain"], OPTIM_TOL)
    print(f"adafactor: {CARRY_STEPS} steps with p.add_(0) before each (A reads p) and {CARRY_STEPS} "
          f"without (A reads p at steps {[i for i, (_r, c) in enumerate(reads) if c]}) give the same "
          f"bits, p and state; with p.mul_(0.5) before step {CARRY_EDIT_STEP}, max abs err vs plain "
          f"{err:.3e}", flush=True)
    del opts, leaves, grads, pairs
    return err


def check_optimizer(name: str, groups, gen) -> tuple:
    """OPTIM_STEPS updates of the kernel (through opt.step()) and of the
    plain version on copies of the same weights, with the same random
    gradients; fails beyond OPTIM_TOL.  Returns the kernel's optimizer and
    {weights or state: max abs error}."""
    kern, plain = make_opt(name, groups), make_opt(name, clone_groups(groups))
    k_leaves = [p for g in kern.param_groups for p in g["params"]]
    p_leaves = [p for g in plain.param_groups for p in g["params"]]
    for _ in range(OPTIM_STEPS):
        for kp, pp in zip(k_leaves, p_leaves):
            kp.grad = torch.randn(kp.shape, generator=gen, device=kp.device)
            pp.grad = kp.grad
        kern.step()
        plain.table.set_grads([p.grad for p in p_leaves])
        run_plain(name, plain)
    errs = {"p": check_close(f"{name} weights", k_leaves, p_leaves, OPTIM_TOL)}
    for key in sorted({k for st in kern.state.values() for k in st}):
        pairs = [(kern.state[kp][key], plain.state[pp][key])
                 for kp, pp in zip(k_leaves, p_leaves) if key in kern.state[kp]]
        errs[key] = check_close(f"{name} {key}", *zip(*pairs), OPTIM_TOL)
    if name != "sgdm" and not int(kern.count) == int(plain.count) == OPTIM_STEPS:
        fail(f"{name}: count {int(kern.count)} (plain {int(plain.count)}) after "
             f"{OPTIM_STEPS} steps")
    del plain
    return kern, errs


def optim_kernel_phase(dev, gen) -> list:
    """K10, K10b and K10c against their plain versions at the 1b-tpu
    preset's weights, timed there (SGD also at ResNet-50's), each with its
    bound and torch.optim's fused update where one exists."""
    rows = []
    for name, replaces, jax_file in (("adafactor", "74", "llama_bench.py"),
                                     ("adamw", "210", "llama.py"),
                                     ("sgdm", "143", "resnet.py")):
        groups = bench_weights(dev, gen)
        opt, errs = check_optimizer(name, groups, gen)
        n = sum(t.numel() for _n, ts in groups for t in ts)
        shape = f"1b-tpu weights + 2 odd leaves: {n} f32 in {len(opt.table.leaves)} leaves"
        if name == "sgdm":  # timed where the main path runs it: ResNet-50
            del opt, groups
            free_memory()
            params = resnet.init_params(resnet.ResNetConfig(), torch.Generator(device=dev)
                                        .manual_seed(0))
            leaves = resnet.param_leaves(params)
            groups = [("resnet50", [p.requires_grad_(True) for p in leaves])]
            opt = make_opt(name, groups)
            for p in leaves:
                p.grad = torch.randn(p.shape, generator=gen, device=dev)
            opt.step()
            n = sum(p.numel() for p in leaves)
            shape = f"ResNet-50 weights: {n} f32 in {len(leaves)} leaves (checked at 1b-tpu)"
        kernel_ms = time_ms(lambda: run_kernel(name, opt), 10, 2)
        plain_ms = time_ms(lambda: run_plain(name, opt), 2, 1)
        library_ms = None
        if name != "adafactor":
            leaves = [p for g in opt.param_groups for p in g["params"]]
            lib = (torch.optim.AdamW(leaves, lr=OPTIM_LR, weight_decay=0.1, fused=True)
                   if name == "adamw" else
                   torch.optim.SGD(leaves, lr=OPTIM_LR, momentum=0.9, fused=True))
            library_ms = time_ms(lib.step, 10, 2)
            del lib
        bound = optim_bound(name, opt.table)
        r = row(name, "optim.cu", replaces, shape, max(errs.values()), kernel_ms, plain_ms,
                bound, library_ms, jax_file=jax_file)
        if name == "adafactor":
            moved = adafactor_moved_bytes(opt.table)
            r.update(tb_per_s=moved / kernel_ms / 1e9, passes_ms=adafactor_passes_ms(opt),
                     read_p_ms=adafactor_read_p_ms(opt))
            print(f"adafactor: {moved / n:.3f} bytes a parameter moved (20 a factored one, 28 an "
                  f"unfactored one; the bound counts 12 and 20), {r['tb_per_s']:.3f} TB/s; "
                  f"floor {moved / PEAK_BYTES * 1e3:.4f} ms at {PEAK_BYTES / 1e12} TB/s; "
                  f"reading p every call {r['read_p_ms']:.4f} ms; by pass (device ms a call, "
                  f"profiler) {r['passes_ms']}", flush=True)
            del opt
            free_memory()
            r["max_abs_err"] = max(r["max_abs_err"], adafactor_carry_check(groups, gen))
            opt = None
        rows.append(r)
        print_row(r)
        print(f"{name}: max abs err after {OPTIM_STEPS} steps vs plain by tensor {errs}; "
              f"{kernel_ms:.4f} ms is {100 * bound[0] / kernel_ms:.1f} % of the bound; library: "
              f"{'fused torch.optim, ' + format(library_ms, '.4f') + ' ms' if library_ms else ADAFACTOR_NO_LIBRARY}",
              flush=True)
        del opt, groups
        free_memory()
    return rows


# ------------------------------------------------ the Llama bench payload


def recording_train_step(losses: list, last=None):
    """llama.make_train_step, with each step's loss kept (a device tensor:
    no read-back inside the timed loop), and, where ``last`` is a dict, the
    last step made and its tokens in it."""
    make = llama.make_train_step

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(tokens):
            if last is not None:
                last.update(step=step, tokens=tokens)
            loss = step(tokens)
            losses.append(loss)
            return loss

        return recorded

    return make, wrapped


STEP_PARTS = (("adafactor", ("adafactor_",)), ("attention", ("attention_",)),
              ("gemm", ("nvjet", "gemm", "cutlass")), ("rmsnorm", ("rmsnorm_",)))


def step_device_parts(step, batch: tuple, steps: int = 3, parts=STEP_PARTS) -> dict:
    """A train step run `steps` more times on ``batch`` under
    torch.profiler: device ms a step by part (by default K10b's five
    passes, the attention kernels, cuBLAS's matrix products, K2's forward
    and backward kernels), the rest and in all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
    ms = dict.fromkeys([name for name, _ in parts] + ["other"], 0.0)
    for ev in prof.key_averages():
        if not benchguard.is_device_op(ev):
            continue
        part = next((name for name, keys in parts if any(k in ev.key for k in keys)),
                    "other")
        ms[part] += benchguard.device_time_us(ev) / 1e3 / steps
    ms["total"] = sum(ms.values())
    return {k: round(v, 3) for k, v in ms.items()}


def bench_run(card: str, optimizer: str, steps_run: int, call, last=None) -> tuple:
    """One llama_bench call with the launch counters from 0: the losses of
    every step, the result, and the launches, checked against steps_run
    steps of the named optimizer.  ``last`` gets the last step made."""
    losses: list = []
    make, llama.make_train_step = recording_train_step(losses, last)
    for kern in KERNELS.values():
        kern.launches = 0
    try:
        res = call()
    finally:
        llama.make_train_step = make
    launches = {name: kern.launches for name, kern in KERNELS.items()}
    losses = [float(x) for x in losses]
    cfg = llama.LlamaConfig(**llama_bench.PRESETS[BENCH_PRESET])
    per_step = bench_launches_per_step(cfg.n_layers, optimizer)
    for name, n in launches.items():
        if n != per_step.get(name, 0) * steps_run or (name in per_step and n == 0):
            fail(f"llama_bench {optimizer}: {name} launched {n} times in {steps_run} steps, "
                 f"want {per_step.get(name, 0)} per step")
    if len(losses) != steps_run or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"llama_bench {optimizer}: losses {losses} (want {steps_run}, finite, falling)")
    return res, losses, launches


def check_bench_result(res: dict, optimizer: str, batch: int, steps: int, sweep: bool = False):
    keys = BENCH_KEYS | ({"sweep", "sweep_winner_batch"} if sweep else set())
    if set(res) != keys:
        fail(f"llama_bench: result keys {sorted(res)}, want the JAX payload's {sorted(keys)}")
    if (res["n_devices"] != 1 or res["platform"] != "gpu" or res["optimizer"] != optimizer
            or res["batch"] != batch or res["steps"] != steps
            or res["workload"] != f"llama-{BENCH_PRESET}" or not np.isfinite(res["final_loss"])
            or not res["mfu"] or res["device_kind"] != torch.cuda.get_device_name(0)):
        fail(f"llama_bench: result {res}")


def llama_bench_phase(card: str) -> dict:
    """The Llama bench payload on the card: main() at its defaults (1b-tpu,
    4 x 2048, Adafactor, 10 steps, profiled), a batch sweep, and short
    AdamW and SGD runs: the llama_bench main path."""
    out_dir = tempfile.mkdtemp(prefix="llama-bench-")
    out = os.path.join(out_dir, "result.json")
    argv = ["--preset", BENCH_PRESET, "--batch", str(BENCH_BATCH), "--seq", str(BENCH_SEQ),
            "--steps", str(BENCH_STEPS), "--out", out]
    torch.cuda.reset_peak_memory_stats()
    last: dict = {}
    res, losses, launches = bench_run(
        card, "adafactor", BENCH_WARMUP + BENCH_STEPS + 1,  # the profiled step too
        lambda: (llama_bench.main(argv), json.load(open(out)))[1], last)
    peak = torch.cuda.max_memory_allocated()
    parts = step_device_parts(last["step"], (last["tokens"],))
    last.clear()
    check_bench_result(res, "adafactor", BENCH_BATCH, BENCH_STEPS)
    print("llama_bench result: " + json.dumps(res), flush=True)
    device_us = (res["profile"] or {}).get("device_time_us")
    print(f"llama_bench (1b-tpu, 22 layers, {BENCH_BATCH}x{BENCH_SEQ}, Adafactor): losses="
          f"{[round(x, 4) for x in losses]} step_ms={res['step_time_ms']} "
          f"device_ms={device_us / 1e3 if device_us else 'not measured'} "
          f"tokens_per_s={res['tokens_per_sec']} mfu={res['mfu']} hfu={res['hfu']} "
          f"peak_mem_gib={peak / 2 ** 30:.2f} launches_per_step="
          f"{ {k: v // (BENCH_WARMUP + BENCH_STEPS + 1) for k, v in launches.items() if v} } "
          f"on [{card}]", flush=True)
    print(f"llama_bench step, device ms by part (3 more steps, profiler): {parts}", flush=True)
    free_memory()
    n_probe = len(BENCH_SWEEP) * (1 + BENCH_PROBE_STEPS) + BENCH_WARMUP + BENCH_SWEEP_STEPS
    sweep, _sweep_losses, sweep_launches = bench_run(
        card, "adafactor", n_probe,
        lambda: llama_bench.run_sweep(list(BENCH_SWEEP), BENCH_PRESET, BENCH_SEQ,
                                      BENCH_SWEEP_STEPS, "adafactor",
                                      probe_steps=BENCH_PROBE_STEPS, profile=False))
    check_bench_result(sweep, "adafactor", sweep["batch"], BENCH_SWEEP_STEPS, sweep=True)
    print(f"llama_bench sweep {list(BENCH_SWEEP)} (probe {BENCH_PROBE_STEPS} steps): "
          f"{json.dumps(sweep['sweep'])} winner {sweep['sweep_winner_batch']} "
          f"step_ms={sweep['step_time_ms']} tokens_per_s={sweep['tokens_per_sec']} "
          f"mfu={sweep['mfu']} on [{card}]", flush=True)
    free_memory()
    runs = {"adafactor": res}
    all_launches = {k: launches[k] + sweep_launches[k] for k in launches}
    for optimizer in ("adamw", "sgdm"):
        r, ls, lc = bench_run(
            card, optimizer, BENCH_WARMUP + BENCH_SHORT_STEPS,
            lambda: llama_bench.run(BENCH_PRESET, BENCH_BATCH, BENCH_SEQ, BENCH_SHORT_STEPS,
                                    optimizer, profile=False))
        check_bench_result(r, optimizer, BENCH_BATCH, BENCH_SHORT_STEPS)
        print(f"llama_bench {optimizer} ({BENCH_SHORT_STEPS} steps): losses="
              f"{[round(x, 4) for x in ls]} step_ms={r['step_time_ms']} "
              f"tokens_per_s={r['tokens_per_sec']} mfu={r['mfu']} on [{card}]", flush=True)
        runs[optimizer] = r
        all_launches = {k: all_launches[k] + lc[k] for k in all_launches}
        free_memory()
    return dict(launches=all_launches, runs=runs, sweep=sweep, peak_mem_gib=peak / 2 ** 30)


# ------------------------------------------ data parallelism (K8 across ranks)


def check_bn_split(name, x, scale, bias, r, relu, dy) -> list:
    """K8's split entries against their plain versions on the same inputs,
    and at one rank against the one-launch kernels bit for bit; then two
    halves of the rows with their sums added (the all-reduce of two ranks)
    against the one-launch kernels on all of them.  Returns the four
    entries' max abs errors."""
    M = x.shape[0]
    sums = batchnorm.bn_sums_kernel(x)
    torch.cuda.synchronize()
    xf = x.float()
    err = (sums - batchnorm.bn_sums_plain(x)).abs()
    mag = torch.stack([xf.abs().sum(0), xf.square().sum(0)])
    if not bool((err <= BN_SUMS_RTOL * mag).all()):
        fail(f"{name} bn_sums: beyond {BN_SUMS_RTOL} of the terms' magnitudes")
    errs = [err.max().item()]
    fold = batchnorm.bn_fold_kernel(sums, M, scale, bias)
    errs.append(check_close(f"{name} bn_fold", fold, batchnorm.bn_fold_plain(sums, M, scale,
                                                                             bias),
                            BN_STATS_TOL))
    one = batchnorm.bn_stats_kernel(x, scale, bias)
    if not all(torch.equal(a, b) for a, b in zip(fold, one)):
        fail(f"{name}: bn_fold(bn_sums(x)) is not bn_stats(x) bit for bit")
    w, b, stats = one
    _y, mask = batchnorm.bn_apply_kernel(x, w, b, r, relu)
    res = r is not None
    bsums, dscale, dbias = batchnorm.bn_bwd_sums_kernel(x, mask, dy, stats)
    psums, pdscale, pdbias = batchnorm.bn_bwd_sums_plain(x, mask, dy, stats)
    errs.append(check_rel_l2(f"{name} bn_bwd_sums", [bsums, dscale, dbias],
                             [psums, pdscale, pdbias], BWD_REL_L2_TOL))
    dx, dr = batchnorm.bn_bwd_dx_kernel(x, mask, dy, w, scale, stats, bsums, M, res)
    pdx, pdr = batchnorm.bn_bwd_dx_plain(x, mask, dy, w, scale, stats, bsums, M, res)
    errs.append(check_rel_l2(f"{name} bn_bwd_dx", [dx] + ([dr] if res else []),
                             [pdx] + ([pdr] if res else []), BWD_REL_L2_TOL))
    whole = batchnorm.bn_bwd_kernel(x, mask, dy, w, scale, stats, res)
    if not all(torch.equal(a, b) for a, b in zip((dx, dscale, dbias) + ((dr,) if res else ()),
                                                  (whole[0], whole[2], whole[3])
                                                  + ((whole[1],) if res else ()))):
        fail(f"{name}: the split backward is not bn_bwd's bits at one rank")
    if M >= 2:  # two ranks' halves, their sums added as the all-reduce adds them
        h = M // 2
        parts = [slice(0, h), slice(h, 2 * h)]
        gsum = sum(batchnorm.bn_sums_kernel(x[s]) for s in parts)
        w2, b2, stats2 = batchnorm.bn_fold_kernel(gsum, 2 * h, scale, bias)
        ref = batchnorm.bn_stats_plain(x[:2 * h], scale, bias)
        check_close(f"{name} two halves' fold", (w2, b2, stats2), ref, BN_STATS_TOL)
        # each half's mask in its own (16-byte aligned) buffer, as a rank's is
        ms = [None if mask is None else mask[s].clone() for s in parts]
        bw = [batchnorm.bn_bwd_sums_kernel(x[s], m, dy[s], stats2) for s, m in zip(parts, ms)]
        gb = bw[0][0] + bw[1][0]
        dxs = [batchnorm.bn_bwd_dx_kernel(x[s], m, dy[s], w2, scale, stats2, gb, 2 * h, res)
               for s, m in zip(parts, ms)]
        ref = batchnorm.bn_bwd_plain(x[:2 * h], None if mask is None else mask[:2 * h],
                                     dy[:2 * h], w2, scale, stats2, res)
        check_rel_l2(f"{name} two halves' backward",
                     [torch.cat([d[0] for d in dxs]), bw[0][1] + bw[1][1], bw[0][2] + bw[1][2]],
                     [ref[0], ref[2], ref[3]], BWD_REL_L2_TOL)
    return errs


def bn_split_phase(dev, gen) -> list:
    """K8's split entries at bn_kernel_phase's odd shapes and at the
    BN_TIMED layers of batch 128 (check_bn_split), timed at the stem: the
    kernels' rows."""
    for M, C in ((1, 64), (37, 24), (1000, 8), (3, 2048), (517, 136)):
        for relu, res in ((False, False), (True, False), (True, True)):
            x, sc, bi, r = bn_inputs(M, C, gen, dev, res)
            check_bn_split(f"bn split {M, C} relu={relu} residual={res}", x, sc, bi, r, relu,
                           bf16((M, C), gen, dev))
    out = []
    for where, side, C, res in BN_TIMED:
        M, n = RESNET_BATCH * side * side, RESNET_BATCH * side * side * C
        x, sc, bi, r = bn_inputs(M, C, gen, dev, res)
        dy = bf16((M, C), gen, dev)
        errs = check_bn_split(f"bn split {where} {M, C}", x, sc, bi, r, True, dy)
        if where != "stem":
            continue
        sums = batchnorm.bn_sums_kernel(x)
        w, b, stats = batchnorm.bn_fold_kernel(sums, M, sc, bi)
        _y, mask = batchnorm.bn_apply_kernel(x, w, b, r, True)
        bsums = batchnorm.bn_bwd_sums_kernel(x, mask, dy, stats)[0]
        shape = f"M={M} C={C} ({where}, ReLU; split across ranks)"
        out = [
            # reads x, writes the (2, C) sums
            row("bn_sums", "batchnorm.cu", "83-97,104", shape, errs[0],
                time_ms(lambda: batchnorm.bn_sums_kernel(x)),
                time_ms(lambda: batchnorm.bn_sums_plain(x), 5, 1),
                bound_ms(2 * n + 8 * C, 3 * n, PEAK_F32), None, jax_file="resnet.py"),
            # reads the sums, scale and bias, writes w, b and stats
            row("bn_fold", "batchnorm.cu", "83-97,104", shape, errs[1],
                time_ms(lambda: batchnorm.bn_fold_kernel(sums, M, sc, bi)),
                time_ms(lambda: batchnorm.bn_fold_plain(sums, M, sc, bi), 5, 1),
                bound_ms(8 * C + 8 * C + 4 * C + 16 * C, 12 * C, PEAK_F32), None,
                jax_file="resnet.py"),
            # reads x, dy, the mask and stats, writes the sums, dscale and dbias
            row("bn_bwd_sums", "batchnorm.cu", "83-97,104", shape, errs[2],
                time_ms(lambda: batchnorm.bn_bwd_sums_kernel(x, mask, dy, stats)),
                time_ms(lambda: batchnorm.bn_bwd_sums_plain(x, mask, dy, stats), 5, 1),
                bound_ms(4 * n + n / 8 + 16 * C + 16 * C, 4 * n, PEAK_F32), None,
                jax_file="resnet.py"),
            # reads x, dy, the mask, w, scale, stats and the sums, writes dx
            row("bn_bwd_dx", "batchnorm.cu", "83-97,104", shape, errs[3],
                time_ms(lambda: batchnorm.bn_bwd_dx_kernel(x, mask, dy, w, sc, stats, bsums, M)),
                time_ms(lambda: batchnorm.bn_bwd_dx_plain(x, mask, dy, w, sc, stats, bsums, M),
                        5, 1),
                bound_ms(6 * n + n / 8 + 2 * C + 28 * C, 5 * n, PEAK_F32), None,
                jax_file="resnet.py"),
        ]
        for rw in out:
            print_row(rw)
        del x, dy, mask, r
    print("bn split: at one rank each entry gives the one-launch kernels' bits; two halves "
          "with their sums added meet the one-launch kernels on all the rows", flush=True)
    return out


def dp_models() -> list:
    """(name, module, config, make_train_state's arguments, the batch) of
    each train path at its main path's size."""
    dev = torch.device("cuda")
    lcfg = dataclasses.replace(llama.llama_3_8b(), n_layers=TRAIN_LAYERS)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, lcfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)
    bcfg = bert.bert_large()
    rcfg = resnet.ResNetConfig()
    return [("llama", llama, lcfg, dict(seed=0), (tokens,)),
            ("bert", bert, bcfg, dict(lr=BERT_LR, seed=0),
             tuple(t.to(dev) for t in bert.synthetic_batch(bcfg, BERT_BATCH, BERT_SEQ, seed=0))),
            ("resnet", resnet, rcfg, dict(seed=0),
             resnet.synthetic_batch(rcfg, RESNET_BATCH, RESNET_SIZE, rcfg.dtype, dev))]


def dp_steps(mod, cfg, kw, batch, mesh, ops=None) -> tuple:
    """DP_STEPS steps from the seed's weights (with ``ops`` in place of
    the module's kernels where given): (losses, each step's ms, the
    weights after them, the state, the step)."""
    params, opt = mod.make_train_state(cfg, mesh=mesh, **kw)
    step = mod.make_train_step(cfg, params, opt, mesh=mesh,
                               **({} if ops is None else dict(ops=ops)))
    losses, ms = [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(*batch).item())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, [p.detach().clone() for p in mod.param_leaves(params)], (params, opt), step


def dp_launches(name: str, cfg, split: bool) -> dict:
    """One step's launches on a data-parallel path: the path's own, with
    ResNet's batch norm on the split kernels where ``split``."""
    if name == "llama":
        return train_launches_per_step(cfg.n_layers)
    if name == "bert":
        return bert_launches_per_step(cfg.n_layers)
    n_bn = resnet.num_bn_layers(cfg)
    return dp_resnet_launches_per_step(n_bn) if split else resnet_launches_per_step(n_bn)


def dp_run(tag, name, mod, cfg, kw, batch, ref, total, mesh=None, ops=None, split=False):
    """DP_STEPS steps through ``mesh`` (or ``ops``) with the launch counts
    from 0, bit for bit ``ref`` (the losses and weights of the steps
    without either), and the launches per step asserted and added to
    ``total``: (mean step ms after the first, the state, the step)."""
    for kern in KERNELS.values():
        kern.launches = 0
    losses, ms, got, state, step = dp_steps(mod, cfg, kw, batch, mesh, ops)
    launches = {k: kern.launches for k, kern in KERNELS.items()}
    if losses != ref[0] or not all(torch.equal(a, b) for a, b in zip(got, ref[1])):
        fail(f"{tag} {name}: the steps are not the steps without a mesh bit for bit (losses "
             f"{losses} vs {ref[0]})")
    per_step = dp_launches(name, cfg, split)
    for k, n in launches.items():
        if n != per_step.get(k, 0) * DP_STEPS:
            fail(f"{tag} {name}: {k} launched {n} times in {DP_STEPS} steps, want "
                 f"{per_step.get(k, 0)} per step")
        total[k] += n
    return float(np.mean(ms[1:])), state, step


DP_PARTS = (("bn", ("bn_",)), ("nccl", ("nccl", "Nccl")))
# the host calls a ResNet-50 step's batch norm makes, one-launch or split
DP_HOST_CALLS = ("bn_stats_kernel", "bn_bwd_kernel", "bn_sums_kernel", "bn_fold_kernel",
                 "bn_bwd_sums_kernel", "bn_bwd_dx_kernel", "bn_apply_kernel", "all_reduce")


def host_ms_by_call(step, batch: tuple, steps: int = 3) -> dict:
    """A train step run `steps` more times under cProfile: the host's ms a
    step inside each of DP_HOST_CALLS (cumulative: a call's Python and
    what it calls) and in all, cProfile's own cost included."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(steps):
        step(*batch)
    torch.cuda.synchronize()
    prof.disable()
    ms = {"total": (time.perf_counter() - t0) * 1e3 / steps}
    for (_file, _line, func), (_cc, _nc, _tt, cum, _callers) in pstats.Stats(prof).stats.items():
        if func in DP_HOST_CALLS:
            ms[func] = ms.get(func, 0.0) + cum * 1e3 / steps
    return {k: round(v, 3) for k, v in ms.items()}


def dp_world1_phase(card: str) -> dict:
    """Each train path (Llama-3-8B widths x 4 layers at 4 x 2048, BERT-large
    at 32 x 512, ResNet-50 at 128 x 224^2) for DP_STEPS steps through
    mesh= over a 1-rank NCCL group on this card: bit for bit the same steps
    without a mesh, with the same launches (one data rank issues no
    collective and keeps the one-launch K8).  Then ResNet-50 with its batch
    norm forced onto the split kernels over that group, bit for bit the
    same again, its extra time a step and where it goes (device time by
    part under the profiler; the host's by call under cProfile), the
    gradients' all-reduce alone and one
    collective's host time: a one-card floor of what a step over more ranks
    adds, not a multi-card figure."""
    import shutil
    import torch.distributed as dist
    from kubernetes1_tpu_torch.workloads import sharding

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the same convolution algorithms in both runs
    tmp = tempfile.mkdtemp(prefix="dp_store")
    total = {name: 0 for name in KERNELS}
    out = {}
    try:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = sharding.make_mesh(dp=1, device_type="cuda")
            group = sharding.data_group(mesh)
            for name, mod, cfg, kw, batch in dp_models():
                losses, ref_ms, ref_params, state, step = dp_steps(mod, cfg, kw, batch, None)
                del state, step
                free_memory()
                ref, ref_ms = (losses, ref_params), float(np.mean(ref_ms[1:]))
                step_ms, (params, opt), step = dp_run("dp world 1", name, mod, cfg, kw, batch,
                                                      ref, total, mesh=mesh)
                res = dict(step_ms=step_ms, ref_step_ms=ref_ms, extra_ms=step_ms - ref_ms,
                           losses=losses)
                leaves = mod.param_leaves(params)
                grads = [p.grad for p in leaves]
                op = "sum" if name == "bert" else "avg"
                res["all_reduce_ms"] = time_ms(lambda: sharding.all_reduce_(grads, group, op), 5,
                                               1, back_to_back=False)
                res["grad_bytes"] = sum(p.numel() * 4 for p in leaves)
                del params, opt, leaves, grads
                print(f"dp world 1 {name}: {DP_STEPS} steps through mesh= bit for bit the steps "
                      f"without, the same launches, no collective (losses "
                      f"{[round(x, 4) for x in losses]}); step_ms {step_ms:.2f} vs "
                      f"{ref_ms:.2f} without a mesh; the gradients' all-reduce over the "
                      f"1-rank group alone ({res['grad_bytes'] / 1e9:.3f} GB) "
                      f"{res['all_reduce_ms']:.2f} ms on [{card}]", flush=True)
                if name == "resnet":
                    # the meshed step is the one without a mesh: the reference
                    parts_ref = step_device_parts(step, batch, parts=DP_PARTS)
                    host_ref = host_ms_by_call(step, batch)
                    del step
                    free_memory()
                    ops = resnet.KERNELS._replace(batchnorm=partial(batchnorm.batchnorm,
                                                                    group=group))
                    split_ms, state, step = dp_run("dp world 1 split K8", name, mod, cfg, kw,
                                                   batch, ref, total, ops=ops, split=True)
                    parts_split = step_device_parts(step, batch, parts=DP_PARTS)
                    host_split = host_ms_by_call(step, batch)
                    del state
                    res.update(split_step_ms=split_ms, split_extra_ms=split_ms - ref_ms,
                               device_ms=parts_ref, split_device_ms=parts_split,
                               host_ms=host_ref, split_host_ms=host_split)
                    dev_extra = parts_split["total"] - parts_ref["total"]
                    print(f"dp world 1 resnet, batch norm on the split kernels over the 1-rank "
                          f"group: bit for bit the steps without, launches per step "
                          f"{dp_launches(name, cfg, True)}; step_ms {split_ms:.2f} vs "
                          f"{ref_ms:.2f} (extra {split_ms - ref_ms:.2f}); device ms a step by "
                          f"part (profiler, 3 steps) {parts_split} vs {parts_ref} (extra on the "
                          f"device {dev_extra:.3f}, on the host's side "
                          f"{split_ms - ref_ms - dev_extra:.2f}); host ms a step by call "
                          f"(cProfile, 3 steps) {host_split} vs {host_ref} on [{card}]",
                          flush=True)
                del step, ref, ref_params
                free_memory()
                out[name] = res
            # the host's cost of one collective, as the split K8 issues two a
            # layer: a (2, 64) f32 all-reduce, back to back
            sums = torch.zeros((2, 64), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                dist.all_reduce(sums, group=group)
            torch.cuda.synchronize()
            out["all_reduce_call_us"] = (time.perf_counter() - t0) / 200 * 1e6
            print(f"dp world 1: one all_reduce of (2, 64) f32 {out['all_reduce_call_us']:.1f} "
                  f"us a call, host to host (200 back to back); the split K8 issues "
                  f"{2 * resnet.num_bn_layers(resnet.ResNetConfig())} a ResNet-50 step",
                  flush=True)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic = deterministic
    out["launches"] = total
    return out


def dp2_worker(rank: int, tmp: str):
    """One of DP2_RANKS gloo ranks on card 0: a ResNet-50 step on its rows
    of the DP2_BATCH images over a mesh built from the group, then one
    more; writes its loss, the first step's gradients (rank 0), a digest
    of its weights after both steps, its launches and its step time; and
    before them, the last batch-norm layer on its half of the rows
    (bn_layer_grads over the group)."""
    import hashlib
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", DP2_RANKS), rank=rank,
                            world_size=DP2_RANKS)
    try:
        mesh = DeviceMesh.from_group(dist.group.WORLD, "cuda", mesh_dim_names=("dp",))
        inputs = dp2_layer_inputs(torch.device("cuda"))
        h = inputs[0].shape[0] // DP2_RANKS
        rows = slice(rank * h, (rank + 1) * h)
        layer = bn_layer_grads(*(t[rows] if t.dim() == 2 else t for t in inputs),
                               group=dist.group.WORLD)
        cfg = resnet.ResNetConfig()
        params, opt = resnet.make_train_state(cfg, seed=0, mesh=mesh)
        step = resnet.make_train_step(cfg, params, opt, mesh=mesh)
        images, labels = resnet.synthetic_batch(cfg, DP2_BATCH, RESNET_SIZE, cfg.dtype,
                                                torch.device("cuda"))
        for kern in KERNELS.values():
            kern.launches = 0
        loss = step(images, labels).item()
        leaves = resnet.param_leaves(params)
        grads = [p.grad.cpu() for p in leaves]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(images, labels).item()
        step_ms = (time.perf_counter() - t0) * 1e3
        flat = torch.cat([p.detach().reshape(-1) for p in leaves]).cpu()
        torch.save(dict(loss=loss, grads=grads if rank == 0 else None, step_ms=step_ms,
                        layer=[t.cpu() for t in layer],
                        digest=hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
                        launches={k: kern.launches for k, kern in KERNELS.items()}),
                   f"{tmp}/out{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp2_held_leaves(params) -> dict:
    """The leaves whose gradients dp2_phase holds to the whole batch's:
    the head's, one layer from the loss, where bf16 ResNet-50 at random
    weights has not yet spread the two runs' rounding apart (see
    DP2_GRAD_TOL)."""
    return {"head.w": params["head"]["w"], "head.b": params["head"]["b"]}


def dp2_layer_inputs(dev):
    """The last batch-norm layer's inputs at DP2_BATCH images, from a fixed
    seed: (x, scale, bias, residual, dy), the same in every process."""
    _where, side, C, res = BN_TIMED[-1]
    gen = torch.Generator(device=dev).manual_seed(11)
    M = DP2_BATCH * side * side
    x, scale, bias, r = bn_inputs(M, C, gen, dev, res)
    return x, scale, bias, r, bf16((M, C), gen, dev)


def bn_layer_grads(x, scale, bias, r, dy, group=None) -> list:
    """batchnorm(x, ...) with its ReLU and residual, forward and backward:
    [y, dx, dr, dscale, dbias]."""
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, r)]
    y = batchnorm.batchnorm(*leaves, relu=True, group=group)
    y.backward(dy)
    return [y.detach()] + [leaves[i].grad for i in (0, 3, 1, 2)]


def dp2_phase(card: str) -> dict:
    """DP2_RANKS gloo ranks on this one card (processes of this script),
    the split K8 with a real all-reduce between its launches: the last
    batch-norm layer over the ranks' halves of its rows against the
    one-launch kernels on all of them, and a ResNet-50 step (full width,
    DP2_BATCH x 224^2) held to the whole batch's step on one process: the
    loss within RESNET_LOSS_TOL, and the head's gradients within
    DP2_GRAD_TOL, which rank 0's rows alone (batch norm without the other
    rank's rows, no average), halved gradients and zero gradients each
    exceed."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="dp2_")
    try:
        logs = [open(f"{tmp}/log{r}.txt", "w") for r in range(DP2_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp2-rank",
                                   str(r), tmp], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(DP2_RANKS)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if rcs != [0] * DP2_RANKS:
            text = "\n".join(open(f"{tmp}/log{r}.txt").read()[-3000:] for r in range(DP2_RANKS))
            fail(f"dp2: rank exit codes {rcs}:\n{text}")
        outs = [torch.load(f"{tmp}/out{r}.pt", weights_only=False) for r in range(DP2_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len({o["digest"] for o in outs}) != 1 or len({o["loss"] for o in outs}) != 1:
        fail("dp2: the ranks' weights or losses differ after their steps")
    cfg = resnet.ResNetConfig()
    per_step = dp_resnet_launches_per_step(resnet.num_bn_layers(cfg))
    for k, n in outs[0]["launches"].items():
        if n != per_step.get(k, 0) * 2:
            fail(f"dp2: {k} launched {n} times in 2 steps on rank 0, want {per_step.get(k, 0)}")

    dev = torch.device("cuda")
    whole = bn_layer_grads(*dp2_layer_inputs(dev))
    split = [torch.cat([o["layer"][i] for o in outs]).to(dev) for i in range(3)] + [
        sum(o["layer"][i] for o in outs).to(dev) for i in (3, 4)]
    layer_err = check_rel_l2("dp2 last batch norm over the ranks' rows", split, whole,
                             BWD_REL_L2_TOL)
    images, labels = resnet.synthetic_batch(cfg, DP2_BATCH, RESNET_SIZE, cfg.dtype, dev)
    params = resnet.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    leaves = resnet.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    index = {id(p): i for i, p in enumerate(leaves)}
    held = {k: index[id(p)] for k, p in dp2_held_leaves(params).items()}

    def grads_of(n_rows):
        loss = resnet.loss_fn(cfg, params, images[:n_rows], labels[:n_rows], resnet.KERNELS)
        return loss.item(), torch.autograd.grad(loss, leaves)

    w_loss, whole = grads_of(DP2_BATCH)
    _, own = grads_of(DP2_BATCH // DP2_RANKS)
    ranks = [g.to(dev) for g in outs[0]["grads"]]

    def errs(gs):
        return {k: ((gs[i].float() - whole[i].float()).norm()
                    / whole[i].float().norm().clamp_min(1e-30)).item() for k, i in held.items()}

    got = errs(ranks)
    wrong = {"rank 0's rows alone": errs(own), "halved": errs([g / 2 for g in ranks]),
             "zero": errs([torch.zeros_like(g) for g in ranks])}
    print(f"dp2 ({DP2_RANKS} gloo ranks on one card, ResNet-50 {DP2_BATCH} x {RESNET_SIZE}^2, "
          f"{DP2_BATCH // DP2_RANKS} a rank): the last batch norm over the ranks' rows (y, dx, "
          f"dr, summed dscale and dbias) against the one-launch kernels on all of them, max "
          f"abs err {layer_err:.3e} (relative L2 within {BWD_REL_L2_TOL}); loss {outs[0]['loss']:.6f} vs the "
          f"whole batch's "
          f"{w_loss:.6f} (tol {RESNET_LOSS_TOL}); first step's gradients' rel_l2 against the "
          f"whole batch's: { {k: f'{v:.3e}' for k, v in got.items()} } (tol {DP2_GRAD_TOL}); "
          f"the same for " + "; ".join(f"{w}: max {max(e.values()):.3e}"
                                       for w, e in wrong.items())
          + f"; the ranks' weights the same bits after 2 steps; step_ms "
          f"{[round(o['step_ms'], 2) for o in outs]} (gloo through the host) on [{card}]",
          flush=True)
    if not abs(outs[0]["loss"] - w_loss) <= RESNET_LOSS_TOL:
        fail(f"dp2: loss {outs[0]['loss']} vs the whole batch's {w_loss}")
    if not max(got.values()) <= DP2_GRAD_TOL:
        fail(f"dp2: the ranks' gradients are beyond {DP2_GRAD_TOL} of the whole batch's")
    for w, e in wrong.items():
        if max(e.values()) <= DP2_GRAD_TOL:
            fail(f"dp2: {w} passes the bar of {DP2_GRAD_TOL}: the check cannot see it")
    return dict(loss=outs[0]["loss"], whole_loss=w_loss, grad_rel=got, layer_err=layer_err,
                step_ms=[o["step_ms"] for o in outs], launches=outs[0]["launches"])


def xent_part_rows(name, logits, t, grad, grad_tol, replaces, jax_file, shard_rows) -> list:
    """K5's partial entry on the two halves of ``logits`` (rows, V): each
    half against the plain twin, at all rows and at the first
    ``shard_rows`` (the sharded step's rows); the halves combined against K5's plain
    version over the whole vocab; the one-block backward of each half fed
    the global lse and the shifted targets against its plain version.  The
    row of the second half (rank 1's block), timed."""
    rows, vocab = logits.shape
    w = vocab // 2
    blocks = [logits[:, :w].contiguous(), logits[:, w:].contiguous()]
    parts, err = [], 0.0
    for r, block in enumerate(blocks):
        got = cross_entropy.cross_entropy_part_kernel(block, t, r * w)
        err = max(err, check_close(f"{name} block {r}", got,
                                   cross_entropy.cross_entropy_part_plain(block, t, r * w),
                                   XENT_LOSS_TOL))
        parts.append(got)
        err = max(err, check_close(
            f"{name} block {r} at {shard_rows} rows",
            cross_entropy.cross_entropy_part_kernel(block[:shard_rows], t[:shard_rows], r * w),
            cross_entropy.cross_entropy_part_plain(block[:shard_rows], t[:shard_rows], r * w),
            XENT_LOSS_TOL))
    lse = torch.logsumexp(torch.stack([p[0] for p in parts]), dim=0)
    loss = lse - (parts[0][1] + parts[1][1])
    check_close(f"{name} combined over both blocks", [loss, lse],
                [cross_entropy.cross_entropy_plain(logits, t),
                 cross_entropy.cross_entropy_lse_plain(logits)], XENT_LOSS_TOL)
    bwd_err = 0.0
    for r, block in enumerate(blocks):
        local = t - r * w
        got = cross_entropy.cross_entropy_bwd_kernel(block, local, lse, grad)
        bwd_err = max(bwd_err, check_close(
            f"{name} backward, block {r}, global lse", [got],
            [cross_entropy.cross_entropy_bwd_plain(block, local, lse, grad)], grad_tol))
    block, v0 = blocks[1], w
    m = block.numel()
    out = row(name, "cross_entropy.cu", replaces,
              f"rows={rows} vocab block={w} of {vocab} {str(block.dtype)[6:]}", err,
              time_ms(lambda: cross_entropy.cross_entropy_part_kernel(block, t, v0)),
              time_ms(lambda: cross_entropy.cross_entropy_part_plain(block, t, v0), 5, 1),
              bound_ms(block.element_size() * m + 8 * rows + 8 * rows, 4 * m, PEAK_F32), None,
              jax_file=jax_file)
    print(f"{name}: two blocks' parts combined meet K5's plain version over the whole "
          f"vocab; the one-block backward with the global lse and shifted targets, max abs "
          f"err {bwd_err:.3e}", flush=True)
    return [out]


def xent_part_phase(dev, gen) -> list:
    """K5's vocab-parallel partial entries at tp = 2's blocks: Llama-3-8B's
    8192 x 128256 bf16 logits and BERT-large's 16384 x 30522 f32 ones,
    and the first 4096 rows of each, the rows ``shard2_phase`` gives them."""
    vocab, rows = llama.llama_3_8b().vocab, TRAIN_BATCH * TRAIN_SEQ
    logits = bf16((rows, vocab), gen, dev, 2.0)
    t = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
    out = xent_part_rows("cross_entropy_part", logits, t,
                         torch.randn(rows, generator=gen, device=dev), XENT_GRAD_TOL,
                         "196-202", "llama.py", SHARD2_LLAMA_BATCH * TRAIN_SEQ)
    del logits
    free_memory()
    vocab, rows = bert.bert_large().vocab, BERT_BATCH * BERT_SEQ
    logits = torch.randn((rows, vocab), generator=gen, device=dev) * 2.0
    t = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
    out += xent_part_rows("cross_entropy_part_f32", logits, t,
                          torch.randn(rows, generator=gen, device=dev), XENT_F32_GRAD_TOL,
                          "157-166", "bert.py", SHARD2_BERT_BATCH * BERT_SEQ)
    del logits
    for r in out:
        print_row(r)
    return out


def shard2_models() -> list:
    """(name, module, config, make_train_state's arguments, the batch) of
    the sharded paths on two gloo ranks; "llama_noremat" is Llama without
    remat, whose autograd keeps each layer's gathered weights (the whole
    model's step is the same values as with remat)."""
    dev = torch.device("cuda")
    lcfg = dataclasses.replace(llama.llama_3_8b(), n_layers=SHARD_LAYERS)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, lcfg.vocab, (SHARD2_LLAMA_BATCH, TRAIN_SEQ + 1))).to(dev)
    bcfg = bert.bert_large()
    return [("llama", llama, lcfg, dict(seed=0), (tokens,)),
            ("llama_noremat", llama, dataclasses.replace(lcfg, remat=False), dict(seed=0),
             (tokens,)),
            ("bert", bert, bcfg, dict(lr=BERT_LR, seed=0),
             tuple(t.to(dev) for t in bert.synthetic_batch(bcfg, SHARD2_BERT_BATCH, BERT_SEQ,
                                                           seed=0)))]


def _model(name: str) -> str:
    return name.split("_")[0]


def _leaf(params, path):
    return params[path[0]] if len(path) == 1 else params["layers"][path[1]][path[2]]


def _held(grad: torch.Tensor) -> torch.Tensor:
    return grad.detach().reshape(-1)[:SHARD2_HELD_NUMEL].float().cpu()


def shard2_ref(tmp: str):
    """The whole model's first step for each sharded path, in a process of
    its own: its loss, the held leaves' gradients, every leaf's shape."""
    out = {}
    for name, mod, cfg, kw, batch in shard2_models():
        if name != _model(name):
            continue
        params, opt = mod.make_train_state(cfg, **kw)
        step = mod.make_train_step(cfg, params, opt)
        loss = step(*batch).item()
        out[name] = dict(loss=loss, grads={p: _held(_leaf(params, p).grad)
                                           for p in SHARD2_HELD[name]},
                         shapes=[tuple(p.shape) for p in mod.param_leaves(params)])
        del params, opt, step
        free_memory()
    torch.save(out, f"{tmp}/ref.pt")


def count_collective_bytes(dist) -> dict:
    """Wrap the collectives the sharded steps call so that each adds its
    tensor's bytes: the all-gathers' outputs, the reduce-scatters' inputs,
    the all-reduces' tensors.  For this process alone (a shard2 rank)."""
    count = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}
    for name, key, arg in (("all_gather_into_tensor", "all_gather", 0),
                           ("reduce_scatter_tensor", "reduce_scatter", 1),
                           ("all_reduce", "all_reduce", 0)):
        def wrapped(*a, _orig=getattr(dist, name), _key=key, _arg=arg, **kw):
            count[_key] += a[_arg].numel() * a[_arg].element_size()
            return _orig(*a, **kw)
        setattr(dist, name, wrapped)
    return count


def shard2_worker(rank: int, tmp: str, dims: str):
    """One of 2 gloo ranks on card 0 over make_mesh(*dims): each sharded
    path's SHARD2_STEPS steps from the seed; writes the losses, the held
    gradients gathered from the ranks' blocks (rank 0), the launches, the
    elements held and the specs' share of them, the state, the peak
    memory, the steps' ms and the last step's collective bytes."""
    import torch.distributed as dist
    from kubernetes1_tpu_torch.workloads import sharding

    coll = count_collective_bytes(dist)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store-{dims}", 2), rank=rank,
                            world_size=2)
    try:
        mesh = sharding.make_mesh(*(int(x) for x in dims.split(",")), device_type="cuda")
        ref = torch.load(f"{tmp}/ref.pt", weights_only=False)
        out = {}
        for name, mod, cfg, kw, batch in shard2_models():
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            params, opt = mod.make_train_state(cfg, mesh=mesh, **kw)
            step = mod.make_train_step(cfg, params, opt, mesh=mesh)
            specs = mod.param_specs(cfg)
            for kern in KERNELS.values():
                kern.launches = 0
            losses, ms = [], []
            for i in range(SHARD2_STEPS):
                torch.cuda.synchronize()
                coll.update({k: 0 for k in coll})
                t0 = time.perf_counter()
                losses.append(step(*batch).item())
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    launches_first = {k: kern.launches for k, kern in KERNELS.items()}
                    grads = {p: _held(sharding.gather_tensor(
                        _leaf(params, p).grad, sharding.spec_of(specs, p), mesh))
                        for p in SHARD2_HELD[_model(name)]}
            leaves = mod.param_leaves(params)
            leaf_specs = sharding.spec_leaves(specs, cfg.n_layers, mod.param_leaves)
            out[name] = dict(
                losses=losses, ms=ms, grads=grads if rank == 0 else None, coll=dict(coll),
                launches_first=launches_first,
                launches={k: kern.launches for k, kern in KERNELS.items()},
                numel=sum(p.numel() for p in leaves),
                share=sharding.spec_numel(ref[_model(name)]["shapes"], leaf_specs, mesh),
                state=sum(t.numel() for p in leaves for t in opt.state[p].values()),
                peak=torch.cuda.max_memory_allocated())
            del params, opt, step, leaves, grads
        torch.save(out, f"{tmp}/out-{rank}.pt")
    finally:
        dist.destroy_process_group()


def _run_script(args: list, tmp: str, n: int, what: str):
    """n processes of this script, rank r's arguments ``args`` with r
    after the first; fail with their logs' ends unless every one exits 0."""
    logs = [open(f"{tmp}/log-{r}.txt", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), args[0], str(r),
                               *args[1:]], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(n)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if rcs != [0] * n:
        text = "\n".join(open(f"{tmp}/log-{r}.txt").read()[-3000:] for r in range(n))
        fail(f"{what}: exit codes {rcs}:\n{text}")


def shard_launches(name: str, cfg, tp: int) -> dict:
    """One sharded step's launches: the path's own, with K5's partial
    entry in place of the one-block forward over tp.  Llama without remat
    runs each layer's RMSNorms and SwiGLU once."""
    L = cfg.n_layers
    if name == "bert":
        per_step = bert_launches_per_step(L)
    elif cfg.remat:
        per_step = train_launches_per_step(L)
    else:
        per_step = {**train_launches_per_step(L), "rmsnorm": 2 * L + 1, "swiglu": L}
    if tp > 1:
        fwd = "cross_entropy" if name != "bert" else "cross_entropy_f32"
        per_step = {**per_step, fwd: 0, fwd.replace("cross_entropy", "cross_entropy_part"): 1}
    return per_step


def shard2_phase(card: str) -> dict:
    """The whole model's first step in its own process, then 2 gloo ranks
    on this card at each of SHARD2_MESHES: each sharded path held to it,
    its launches per step asserted, each rank's parameters and state the
    specs' share."""
    import shutil

    tmp = tempfile.mkdtemp(prefix="shard2_")
    total = {name: 0 for name in KERNELS}
    res = {}
    try:
        _run_script(["--shard2-ref", tmp], tmp, 1, "shard2 whole model")
        ref = torch.load(f"{tmp}/ref.pt", weights_only=False)
        for dims in SHARD2_MESHES:
            tag = "dp={} fsdp={} tp={}".format(*dims)
            _run_script(["--shard2-rank", tmp, ",".join(map(str, dims))], tmp, 2,
                        f"shard2 {tag}")
            outs = [torch.load(f"{tmp}/out-{r}.pt", weights_only=False) for r in range(2)]
            for name, _mod, cfg, _kw, _batch in shard2_models():
                got, want = outs[0][name], ref[_model(name)]
                if any(o[name]["losses"] != got["losses"] for o in outs):
                    fail(f"shard2 {tag} {name}: the ranks' losses differ")
                per_step = shard_launches(name, cfg, dims[2])
                for k, n in got["launches"].items():
                    if n != per_step.get(k, 0) * SHARD2_STEPS or \
                            got["launches_first"][k] != per_step.get(k, 0):
                        fail(f"shard2 {tag} {name}: {k} launched {got['launches_first'][k]} "
                             f"times in the first step and {n} in {SHARD2_STEPS}, want "
                             f"{per_step.get(k, 0)} a step")
                    total[k] += n
                for r, o in enumerate(outs):
                    if o[name]["numel"] != o[name]["share"] or \
                            o[name]["state"] != 2 * o[name]["share"]:
                        fail(f"shard2 {tag} {name} rank {r}: holds {o[name]['numel']} "
                             f"parameters and {o[name]['state']} of state, its specs' share "
                             f"is {o[name]['share']}")
                whole = sum(int(np.prod(s)) for s in want["shapes"])

                def rel(gs):
                    return {"/".join(map(str, p)): ((gs[p] - want["grads"][p]).norm()
                                                    / want["grads"][p].norm().clamp_min(1e-30)
                                                    ).item() for p in SHARD2_HELD[_model(name)]}

                errs = rel(got["grads"])
                wrong = {"halved": rel({p: g / 2 for p, g in got["grads"].items()}),
                         "zero": rel({p: torch.zeros_like(g) for p, g in got["grads"].items()})}
                loss_tol = BERT_LOSS_TOL if name == "bert" else TRAIN_LOSS_TOL
                numel = got["numel"]
                print(f"shard2 {tag} {name} (2 gloo ranks on one card): first loss "
                      f"{got['losses'][0]:.6f} vs the whole model's {want['loss']:.6f} (tol "
                      f"{loss_tol}); first step's gradients' rel_l2 against the whole model's "
                      f"{ {k: f'{v:.3e}' for k, v in errs.items()} } (tol {SHARD2_GRAD_TOL}; "
                      + "; ".join(f"{w}: min {min(e.values()):.3e}" for w, e in wrong.items())
                      + f"); launches per step {per_step}; per rank {numel:,} of {whole:,} "
                      f"parameters: {numel * 4 / 1e9:.2f} GB of weights, "
                      f"{numel * 16 / 1e9:.2f} GB with their gradients and AdamW's m and v "
                      f"({whole * 16 / 1e9:.2f} GB whole); peak memory GB "
                      f"{[round(o[name]['peak'] / 1e9, 2) for o in outs]}; step ms "
                      f"{[round(o[name]['ms'][-1], 1) for o in outs]} (gloo through the host, "
                      f"not a multi-card figure); collective GB a step (rank 0) "
                      f"{ {k: round(v / 1e9, 4) for k, v in got['coll'].items()} } on [{card}]",
                      flush=True)
                if not abs(got["losses"][0] - want["loss"]) <= loss_tol:
                    fail(f"shard2 {tag} {name}: loss {got['losses'][0]} vs {want['loss']}")
                if not max(errs.values()) <= SHARD2_GRAD_TOL:
                    fail(f"shard2 {tag} {name}: gradients beyond {SHARD2_GRAD_TOL}: {errs}")
                for w, e in wrong.items():
                    if min(e.values()) <= SHARD2_GRAD_TOL:
                        fail(f"shard2: {w} gradients pass the bar: the check cannot see them")
                res[tag, name] = dict(loss=got["losses"][0], whole_loss=want["loss"],
                                      grad_rel=errs, numel=numel, whole=whole,
                                      peak=[o[name]["peak"] for o in outs], coll=got["coll"],
                                      step_ms=[o[name]["ms"][-1] for o in outs])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["launches"] = total
    return res


def dryrun_phase():
    """entry.dryrun_multichip(1) over NCCL: the sharded Llama and BERT
    steps and the ring on a one-rank mesh, on this one card."""
    from kubernetes1_tpu_torch import entry

    line = entry.dryrun_multichip(1)
    print(f"entry.dryrun_multichip(1), NCCL: {line}; n > 1 takes a card a rank, and this "
          f"machine has {torch.cuda.device_count()}", flush=True)

def free_memory():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_kernel_ms(rows: list, attn_train_ms: float) -> dict:
    """Each kernel's time at the train step's shapes, for its share of a
    step: the rows' times, but attention's forward at B=4, S=2048 (the
    other serving rows, timed at B=8, S=1024, do the same work there)."""
    return {**{r["name"]: r["ms"] for r in rows}, "attention": attn_train_ms}


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    t_start = time.monotonic()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.monotonic()
    libs = build.build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.1f} s", flush=True)
    attention_build_report()
    for source in ("batchnorm", "gelu", "layernorm", "optim", "rmsnorm"):
        ptxas_report(source)

    gen = torch.Generator(device=dev).manual_seed(0)
    rows, attn_train_ms = kernel_phase(dev, gen)
    free_memory()
    bn_rows = bn_kernel_phase(dev, gen)
    free_memory()
    bn_split_rows = bn_split_phase(dev, gen)
    free_memory()
    bert_rows, bert_per_call = bert_kernel_phase(dev, gen)
    free_memory()
    part_rows = xent_part_phase(dev, gen)
    free_memory()
    ring_rows = ring_kernel_phase(dev, gen)
    free_memory()
    determinism_phase(dev)
    free_memory()
    forward_phase(dev)
    free_memory()
    train_check_phase(dev)
    free_memory()
    bert_check_phase(dev)
    free_memory()
    resnet_check_phase(dev)
    free_memory()
    serve = serving_phase(card)
    free_memory()  # the server's 16 GB of weights go before the train state comes
    train = train_phase(card, train_kernel_ms(rows, attn_train_ms))
    free_memory()
    rn = resnet_phase(card)
    free_memory()
    bt = bert_phase(card, bert_per_call)
    free_memory()
    ring = ring_phase(dev, card)
    free_memory()
    optim_rows = optim_kernel_phase(dev, gen)
    free_memory()
    bench = llama_bench_phase(card)
    free_memory()
    dp = dp_world1_phase(card)
    free_memory()
    dp2 = dp2_phase(card)
    dp["launches"] = {k: n + dp2["launches"][k] for k, n in dp["launches"].items()}
    free_memory()
    shard = shard2_phase(card)
    free_memory()
    dryrun_phase()
    rows += bn_rows + bn_split_rows + bert_rows + part_rows + ring_rows + optim_rows
    paths = {"serving": serve, "train": train, "resnet": rn, "bert": bt, "ring": ring,
             "llama_bench": bench, "dp": dp, "shard": shard}
    for r in rows:
        for path, res in paths.items():
            r[f"launches_{path}"] = res["launches"][r["name"]]
        r["launches"] = sum(r[f"launches_{path}"] for path in paths)
    print(f"chip_smoke: all phases passed in {time.monotonic() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp2-rank"]:  # one rank of dp2_phase
        dp2_worker(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--shard2-ref"]:  # shard2_phase's whole model
        shard2_ref(sys.argv[3])
    elif sys.argv[1:2] == ["--shard2-rank"]:  # one rank of shard2_phase
        shard2_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
