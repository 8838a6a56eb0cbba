#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``flowtrain_stochastic_interpolation_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on one flushed line with the seconds since start:

0. device: the card's name and power limit (nvidia-smi) and the device count;
   no CUDA device -> exit 1 with a message that says so;
1. build: one nvcc call per source (``csrc/linear_attention.cu``,
   ``csrc/flash_attention.cu``, ``csrc/tap_conv.cu`` and
   ``csrc/gemm_probes.cu``), started together; each one's seconds and the
   ``-Xptxas -v`` register / shared-memory / spill summary of every template
   (and any ptxas note on the wgmma products of P2's window path);
2. kernel check, each kernel against its plain PyTorch version on the card,
   each case held to a tolerance scaled to its own values:
   - K1 (folded context) and K2 (folded projection) at batch 8 x {262144,
     32768, 4096} tokens x 128 (the 64³, 32³ and 16³ stages), ragged 4096 +
     37 and 262144 + 37 (a last tile partly past n), a cross-head logit
     spread, a 64³ case whose memory tokens carry most of the softmax weight,
     token counts under one tile (1 and 5) at b1 and b8, b1 x 262144, and q,
     k, v as contiguous [B, N, 128] tensors (b8 x 32768, b1 x 4096 + 37, b8 x
     5) beside the column slices of a [B, N, 384] projection that the rest
     use; each launched twice with identical outputs; their general path at
     b2 x 32768 with 8 x 32, 4 x 64 and 2 x 64 heads in bf16 and 4 x 32 in
     f32;
   - K3 (flash attention), out and lse, at b8 and b4 x 4096 queries x 4100
     keys x 4 heads x 32 (the fa16 stage), a ragged 1024 + 37 queries x
     1024 + 41 keys, a peaked softmax (q x 8), at b2 x 4096 x 4100 with
     d in {8, 16, 48, 128} in bf16 and d = 32 in f32, and the bf16
     tensor-core path's edges: b2 x 1061 x 1065 at d in {8, 24, 40, 64, 128},
     b3 x 5 queries x 9 keys (under one key tile) and b1 x 4096 x 4100;
   - K4a (v1 context) and K4b (v1 projection) on 4 x 32 bf16 heads at b8 x
     {262144, 32768} queries with 4 more keys, one query (M = 5) at b1 and
     b8, a ragged b2 x 32768 + 37, b1 x 262144, a peaked k (x 8), a 64³ case
     whose 4 memory tokens carry most of the weight, and q contiguous (b8 x
     32768, b1 x 32768 + 37) beside the projection's column slice that the
     rest use, each launched twice with identical outputs; then the general
     path at b8 x 32768 in f32 and b2 x 32768 with 2 heads x 64;
3. kernel times: each kernel, its plain version and (K3) one PyTorch call of
   the same function (``scaled_dot_product_attention``) at the main paths'
   shapes (CUDA events around 20 back-to-back launches after a warm-up,
   median of 5 such rounds; 2 launches and 3 rounds for a plain version)
   beside the card's bound (bytes, products, or for K3 the exponentials);
3a. ``tools.ab_linear_attention``: K1 and K2 at the three stages, K4a and K4b
   at 64³ and 32³, beside the FP32-core kernels (K1 and K2's old ones, K4a
   and K4b's general path), another ring depth, and knock-outs of the
   exponentials, the products, all but the loads and (K4a, K4b) p's low
   terms (wrong on purpose), in turns; then ``tools.bench_folded``'s kernel
   part: each wrapper's host time per call beside its kernels' device time
   per launch;
4. backwards: the flash, folded and v1 backwards in bf16 against autograd of
   the f32 plain versions at 16³ b1 (flash, folded) and 32³ b1 (v1);
4a. wide heads, the fourth slice's repair: K1 and K2 (h = 16 at d = 136, h = 1
   at 256 and 512), K4a and K4b (4 heads) at b2 x 32³ and K3 (4 heads) at b2 x
   16³, at d in {136, 256, 512}, bf16 and f32, against their plain versions;
   then the path: ``LinearAttention`` (folded, then ``fused=True,
   fused_folded=False``) at 32³ b2 and ``Attention`` at 16³ b2 with those
   widths, bf16, each launching its kernels once, the v1 block within 1e-2 of
   the folded one;
4b. the tap-folded conv, the fourth slice's main path: K5a against its plain
   version and against ``F.conv3d`` in f32 (TF32 off) at the six cases of
   ``tools/bench_tap_conv.py``, and against its plain version on a [2, 8, 16,
   24] volume at Cin in {8, 48, 96} x Cout in {8, 48, 96, 128} bf16 (the box
   kernel) and at 18 -> 48 and 48 -> 18 bf16 and 48 -> 48 f32 (the tile
   kernel), each twice (identical outputs); the path, ``tap_conv3d`` forward and backward
   at [8, 64³, 48 -> 48] bf16 (K5a 2, K5b 1), with dx, dw and db against the
   plain backward and autograd of the f32 ``F.conv3d``; K5b against its plain
   version at [8, 64³] with Cin 48 and 18, and on a [2, 8, 16, 24] volume at
   Cin in {8, 96} x Cout in {8, 48, 128} bf16 (the box path's edges) and 18 ->
   48 f32 (the chunked kernel), each twice (identical dw); K5a and K5b times
   beside ``F.conv3d`` and
   ``torch.nn.grad.conv3d_weight``; then the tool's six cases;
4c. the GEMM probes: P1, both layouts, at its four shapes (M = 524,288)
   against its plain version, then at M = 524,288 + 37 with K in {1296, 144}
   x N in {8, 48, 128} (the streaming kernel) and K = 100 (``gemm_p1``), each
   twice (identical outputs); P2 at its ten cases at R = 40 and at the window
   path's edges (``P2_EDGE_CASES``: m_block 16, 200 and 2048 + 37; K 48, 100,
   1296 and 1600; N 8 to 1296; R 1 to 256) against its plain version, each
   twice (identical outputs); their times (P1 beside ``torch.matmul`` in the
   same layout, P2 at (2048, 1296, 48, 16) with R = 256); then the tools
   ``bench_gemm`` and ``bench_mma_shapes`` in full, every slope rate of P2 at
   most the card's 989 TF/s (a kernel that skipped products would give the
   same output, since the max is idempotent, and only its time can show it);
5. sampling, the first slice's main path: the ``unconditional_64`` UNet at
   full width, seeded random weights, bf16 compute, through
   ``sample_unconditional`` at 64³ x batch 2, RK4 with 3 frames and 1 substep
   (8 velocity evaluations); K1 and K2 launch 6 times per evaluation. Then the
   same for the fa16 configuration (full attention at 16³ and 4³) with 2 frames
   (4 evaluations): K3 2, K1 4 and K2 4 times per evaluation. Reference checks:
   a 16³ forward of the flagship and a 64³ forward of fa16 on the card (bf16,
   kernels) against the same weights in f32 on the CPU (plain path), and the
   fa16 64³ forward at ``dtype="float32"`` on the card, whose K1, K2 and K3
   must take f32 operands, against the same CPU forward;
5b. the conditional model, the tenth slice's main paths: ``conditional_64``
   (``UNet3DCond`` v3: dim 48, mults (1,2,2,3,4), 4 heads x 32, 15 data
   channels, the 5³ ``EmbedATb`` towers and time-FiLM ``MixATb`` fuses at
   every stage) at full width, seeded random weights, bf16: a 16³ b1 forward
   on the card (K1 and K2 twice each) against the same weights in f32 on the
   CPU, given the observations (``build_atb``) of a synthetic volume under the
   port's combined borehole and surface mask; ``sample_conditional`` at 64³,
   an ensemble of 8 in 2 batches of 4, RK4 with 3 frames and 1 substep (8
   evaluations a batch), K1 and K2 6 times per evaluation, finite states, and
   the ensemble maps (vote probabilities, entropy, air-masked entropy, most
   probable model, dike probability) of the 8 decoded volumes; the ATb towers
   alone (``init_conv_ATb`` and every ``EmbedATb``, which see only ATb) at b4
   beside the b4 forward (CUDA events); a ``torch.profiler`` table of one b4
   64³ forward with its convolutions and resizes by shape and the towers'
   share of the kernel time; then ``make_train_step`` on ``conditional_loss``
   at the recipe's micro-batch 8 x accumulation 4, 2 warm-up and 6 timed
   micro-steps, as phase 8 runs them: the loss and its two parts finite, K1
   and K2 6 times per micro-step;
6. forward at the benchmark's batch: b8 x 64³ UNet forwards, 1 warm-up and 3
   timed, each closed by ``torch.cuda.synchronize()``; then a
   ``torch.profiler`` breakdown of one forward by device time;
7. the v1 path, the third slice's main path: ``LinearAttention(fused=True,
   fused_folded=False)`` at the widths of the flagship's first linear
   attention (dim 48, 4 heads x 32), bf16, seeded weights: 64³ b8 forward,
   64³ b4 forward and backward, 32³ b8 forward, each 1 warm-up and 5 timed
   calls closed by ``torch.cuda.synchronize()``, with the median ms, peak
   memory and launches (K4a 1 and K4b 1 per call), and held against the same
   weights through the folded kernels (K1 + K2), timed the same way; a
   ``torch.profiler`` breakdown of one 64³ b8 forward of each block (the
   kernels, the two ``torch.cat`` of the memory tokens, the projections, the
   norms);
8. training, the second slice's main path, for the flagship and then for
   fa16: ``init_train_state`` and ``make_train_step`` at 64³, micro-batch 4 x
   accumulation 2, on synthetic batches generated on the card; 2 warm-up and 8
   timed micro-steps, each closed by ``torch.cuda.synchronize()``. Each prints
   the median ms per micro-step, peak memory, the loss and gradient norm (which
   must be finite), the launches per micro-step, and that the params changed on
   the accumulation boundaries only; fa16 adds a ``torch.profiler`` breakdown
   of one micro-step. After the flagship's steps, which leave the model in
   training mode, two samplers from the same x0 must agree exactly;
9. the app, the eleventh slice's main paths, on the trained release weights
   (``artifacts/weights/uncond_demo_64``, read by the port's msgpack reader
   without flax or msgpack; a missing file fails): their size, sha256, 299
   bf16 leaves of 22,981,474 values and empty ``ema_params`` and
   ``constants``; their bf16 forward on the card (K1 and K2) against f32 on
   the CPU at 16³ and 64³ b1; their eval loss (``make_eval_loss`` on 4
   synthetic 64³ volumes) under a tenth of seeded random weights' on the same
   volumes and draws; one update of the recipe (``make_train_step`` at 64³
   b1, accumulation 1, no dropout) from the same seeded weights and draws on
   the card in bf16 (K1 and K2 6 times, and 6 in the eval loss after it)
   against the CPU in f32: the loss before and after it, the gradient norm,
   and the cosines of the gradients (Adam's first moment) and of the
   updates; ``apps.unconditional.main`` in this process,
   ``--preset flagship --mode inference`` from the release: 8 samples at 64³
   in one batch, RK4 16 frames x 2 substeps (120 evaluations, K1 and K2 720
   times each), 8 decoded int8 files in [-1, 13], samples/min, category
   fractions and the mean prominence; then ``--mode train --steps 24`` twice
   on one root directory at the flagship's b6 x accumulation 24 (one update a
   run): the first without the pretrain smoke, the second with it (a 32-frame
   RK4 callback at b4, 248 evaluations) and resuming from step 24 to 48; K1
   and K2 6 times per micro-step, the params changed by each update,
   ``metrics.csv`` with ``train_loss``, ``grad_norm`` and ``time_to_solve``,
   checkpoints at 24 and 48, steps/s and peak memory beside the card's name
   and power limit;
10. the samplers and the conditional apps, the twelfth slice's main paths:
   a. ``apps.unconditional.main --adaptive`` from the trained release, 64³ b1,
      float32 state: dopri5 at the recipe's atol = rtol = 1e-6, its NFE
      positive, K1 and K2 exactly 6 x NFE times each, the final state finite
      and the decoded volume in [-1, 13]; its NFE and seconds, and its decode
      agreement and relative L2 against the 120-evaluation RK4 solve from the
      same state, printed with no threshold;
   b. ``sample_unconditional(method="sde")`` from the release at 64³ b8, eps
      0.5 with the linear-decay schedule, 16 frames x 2 substeps (30
      evaluations, K1 and K2 180 times each), twice from one seed (the first
      keeping its trajectory, whose last state must be finite): the decodes
      equal, and other than phase 9's RK4 decodes from the same x0; category
      fractions and samples/min beside phase 9's;
   b′. the same pair while a buffer holds all of the card's free memory but
      ``SDE_PRESSURE_MARGIN_GIB``: both decodes equal to each other and to 10b's;
   c. ``make_sampler(frame_dispatch=True)`` from the release at 64³ b2, RK4 over
      4 frames x 2 substeps (24 evaluations): its final state equal to the
      plain sampler's bit for bit;
   d. ``apps.inference_experiments.main --preset flagship`` on seeded fresh
      ``conditional_64`` weights: create-data (one scenario), populate with
      ``--method sde`` and then ``--method rk4`` (an ensemble of 4 at b4: 14
      and 56 evaluations, K1 and K2 6 times each), analyze; the files and
      maps written, the seconds per batch and the voxel accuracy;
   e. ``apps.conditional.main --preset flagship --steps 8`` (2 updates at b8 x
      4; K1 and K2 6 times per micro-step, the loss and its parts finite),
      then the repaired ``InferenceCallback.run_inference`` on that state:
      zero observations, 4 samples over 32 frames x 2 substeps (248
      evaluations, K1 and K2 6 times each); micro-steps/s, peak memory and
      ``time_to_solve``.

11. the constructor options, reference checkpoints, host-side data and 128³,
   the thirteenth slice's main paths:
   a. the flagship with RandomFourier time (``time_learned_emb=False``: frozen
      features as buffers) written as a reference Lightning ``.ckpt`` (seeded
      weights, an EMA shadow of other seeded weights) by
      ``tests/torch_lightning_layout.py``, loaded by its path; then
      ``apps.unconditional.main --mode inference --checkpoint-path`` on it at
      b8 x 120 evaluations (K1 and K2 720 times each); ``load_weights`` on the
      file holds the EMA shadow's weights, and its 16³ bf16 forward is held
      against f32 on the CPU; the same for a ``conditional_64`` ``.ckpt``, then
      one ``sample_conditional`` batch of 4 (8 evaluations);
   b. one b2 64³ bf16 forward each of the flagship with sinusoidal time, with
      self-conditioning (a non-zero ``x_self_cond``, which must change the
      output) and with ``attn_enabled=False`` (no K1 or K2), against f32 on the
      CPU;
   c. ``get_dataset(source="geogen")`` without GeoGen: the warning, then
      synthetic batches on the card; the native generator built by ``g++``
      (a failed build fails the phase) and its b4 x 64³ batches/s alone; 10
      flagship micro-steps at b4 x 2 through ``train.loop.train`` on it (host
      batches through ``prefetch``, pinned, copied without blocking) and on
      the synthetic source, micro-steps/s side by side;
   d. 128³: K1 and K2 at b1 x 2,097,152 tokens against their plain versions
      (each twice, identical) and timed beside the bound; the chunked folded
      backward at 2^21 rows against the one-shot ``closed_form_bf16`` called
      directly; flagship micro-steps at 128³ b1 x accumulation 2, 2 warm-up and
      6 timed, plain (K1 and K2 8 per micro-step), with ``remat_blocks`` and
      with ``remat`` "nothing" plus the bf16 objective (16 each: the forward
      and its recompute), with ms and peak memory; the gradients of a
      ``remat_blocks`` step against the plain step's from the same weights,
      batch and dropout generator (beside two plain steps' difference); one
      128³ b1 sample from the trained release, RK4 16 frames x 2 substeps;
12. parallelism over ``torch.distributed``, ranks started by
    ``parallel.launch.spawn`` (start method ``spawn``; a rank that raises or is
    not done within ``RANK_DEADLINE_S`` fails the run). A part with more ranks
    than the machine has cards runs them all on card 0 over gloo, their
    collectives staged through pinned host memory; otherwise NCCL, a card a
    rank. Each part prints its backend, ranks and cards.
   a. data parallel, the flagship at 64³ (EMA on, no dropout) on 2 ranks, b4 each
      x accumulation 2, 3 micro-steps: the first micro-step's loss and
      gradient against one process at b8 on the same batch and draws; each
      rank's K1 / K2 launches (6 + 6 a micro-step), micro-step times, the flat
      gradient all-reduce's time and peak memory; parameters and EMA bitwise
      equal across ranks (hashes);
   b. the trained release at 128³ b1 with X over 4 ranks: one velocity
      evaluation against the unsharded forward (bf16, and at f32 compute
      against the unsharded einsum path), the halo and collective bytes per
      evaluation; ``make_spatial_sampler`` RK4 over the recipe's frames (fewer
      where, at one evaluation's time, they would pass
      ``SPATIAL_SAMPLE_BUDGET_S``) against ``make_sampler`` from the same x0;
      peak memory per rank;
   c. 2 sharded train steps of the flagship at 128³ b1 (``make_spatial_train_step``):
      the first loss against the unsharded forward on draws rebuilt shard by
      shard, peak memory per rank, replicas bitwise equal;
   d. on two cards or more: the app with ``--train-devices 0,1`` for 4
      micro-steps, and K1, K2, K4a and K4b on a card that is not the current
      one against their plain versions; with one card, "not run: one card".
13. the 2-D family and the toys, the fifteenth slice's main paths, each timed by
   ``utils.profiling.StepTimer``:
   a. a ``UNet2D`` at 64² b8 (dim 48, mults (1, 2, 4), 4 heads x 32, full
      attention at 32² and 16², seeded weights), bf16: one forward on the card
      (K1 and K2 twice at 64², K3 twice at 32²) against the same weights in f32
      on the CPU, at ``reference_check``'s tolerance; one forward traced by
      ``utils.profiling.trace`` (its Chrome trace must be written);
   b. its RK4 sample over 16 frames x 2 substeps (120 evaluations, K1, K2 and K3
      240 times each) at b8: the final state finite, images/s;
   c. ``apps.toy2d_images.train_and_sample`` at its defaults (32², dim 16, b64,
      lr 2e-3) for ``TOY_IMAGE_STEPS`` steps on the synthetic images: the loss
      under 0.8 of its first, the 9 x 4 RK4 grid within (-4, 4); steps/s;
   d. ``apps.toy2d.train_and_sample`` at its defaults (2000 steps, b512): the
      mean of 8192 samples of the trained flow within 0.15 of the mixture's
      (-0.4, -0.4);
   e. ``utils.flops`` on the ``meta`` device: the flagship's 64³ b8 forward and
      one b4 micro-step, printed as TF/s and as a share of the 989 TF/s bf16
      peak beside phase 9's per-evaluation time and phase 8's median (a
      printed line, not a benchmark).
   ``utils.debug.check_finite`` holds every state the phase produces.
14. the demo and trace tools, the sixteenth slice's main paths, each through its
   ``main`` as a user runs it, in a temporary directory, cut (``DEMO_*``):
   a. ``tools.train_demo`` on the flagship at b4 for 20 steps, then ``--resume``
      for 5 more: the resume message, ``metrics.csv``'s rows at steps 0, 10, 19,
      20 and 24, its 4 samples (b8, 8 evaluations); K1 and K2 6 times per
      micro-step and per evaluation, as phase 8 holds them;
   b. ``tools.export_weights`` of its checkpoint, read back by
      ``load_release_weights`` (299 bf16 leaves, step 25, the run's config), the
      release's 64³ b1 forward against the trained weights rounded to bf16 as
      the release stores them, at ``FORWARD_REL_TOL`` (and, printed, against
      the unrounded weights);
   c. ``tools.sample_from_ckpt`` from that release at b8 (4 evaluations), then
      ``tools.eval_samples`` on what it wrote (its report's keys; no quality
      threshold after 25 steps);
   d. the conditional ``tools.train_demo`` for 8 micro-steps at b2 x 4 with its
      ensemble of 4 (8 evaluations), then ``tools.analyze_cond_demo``, whose
      observed-voxel accuracy from the redrawn mask must equal the demo's;
   e. ``tools.trace_forward`` (2 traced b8 forwards) and ``tools.trace_summary``:
      its buckets within 5% of the profiler's own kernel total, K1 and K2 in
      the hand-written bucket;
   f. ``tools.profile_breakdown --quick``.
15. training held over many updates, the seventeenth slice's check of the main
   path (``TRAJ_*``, ``FIXED_EVAL_*``):
   a. 20 updates of the flagship recipe at 32³ b2, accumulation 1, no dropout,
      through ``make_train_step``: the card's bf16 path (K1 and K2 4 times a
      micro-step, the folded backward) against the same weights and draws (t
      rounded to bf16) in f32 on the card through K1's and K2's plain versions,
      TF32 off. Every step's loss within 2e-2 relative, and the two total
      parameter changes at a cosine of 0.98 or more; the per-step differences
      are printed, and a miss names the first step where the paths part;
   b. ``tools.fixed_eval`` of the release on 8 batches of 8 volumes at 64³ (a
      b1 ``make_eval_loss`` a volume, K1 and K2 6 times each), on the kernel
      path and on the plain versions: the means within 1e-2 relative.

The launch counts are set to 0 just before each main-path run (phases 4a-4c,
5, 5b, 7, 8, 9, 10, 11, 12 (in each rank), 13, 14 and 15) and read just after it. Then
one JSON line per kernel (``{"kernels": [...]}``), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.apps import conditional as cond_app
from flowtrain_stochastic_interpolation_torch.apps import toy2d, toy2d_images
from flowtrain_stochastic_interpolation_torch.apps import inference_experiments as exp_app
from flowtrain_stochastic_interpolation_torch.apps import unconditional as app
from flowtrain_stochastic_interpolation_torch.config import (
    EMAConfig,
    conditional_64,
    unconditional_64,
)
from flowtrain_stochastic_interpolation_torch.data import geogen as geogen_data
from flowtrain_stochastic_interpolation_torch.data import native as native_data
from flowtrain_stochastic_interpolation_torch.data.synthetic import (
    SyntheticGeoDataset,
    synthetic_geology_batch,
)
from flowtrain_stochastic_interpolation_torch.inference import (
    build_atb,
    initial_noise,
    make_sampler,
    sample_conditional,
    sample_unconditional,
)
from flowtrain_stochastic_interpolation_torch.interpolants import LinearInterpolant
from flowtrain_stochastic_interpolation_torch.models.attention import Attention, LinearAttention
from flowtrain_stochastic_interpolation_torch.models.persistence import (
    load_release_weights,
    params_from_jax,
    state_dict_from_release,
    variables_to_jax,
)
from flowtrain_stochastic_interpolation_torch.models.unet import UNet, UNet2D
from flowtrain_stochastic_interpolation_torch.inference import make_spatial_sampler
from flowtrain_stochastic_interpolation_torch.ops import cuda_build, ensemble
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_torch.ops.embedding import decode, simplex_embedding
from flowtrain_stochastic_interpolation_torch.ops.masks import make_combined_mask
from flowtrain_stochastic_interpolation_torch.tools import ab_linear_attention as ab_la
from flowtrain_stochastic_interpolation_torch.tools import bench_folded
from flowtrain_stochastic_interpolation_torch.tools import bench_gemm as bg
from flowtrain_stochastic_interpolation_torch.tools import bench_mma_shapes as bms
from flowtrain_stochastic_interpolation_torch.tools import bench_tap_conv as btc
from flowtrain_stochastic_interpolation_torch.tools import (
    analyze_cond_demo,
    eval_samples,
    export_weights,
    fixed_eval,
    profile_breakdown,
    sample_from_ckpt,
    trace_forward,
    trace_summary,
    train_demo,
)
from flowtrain_stochastic_interpolation_torch.parallel import collectives, create_mesh, shard_batch
from flowtrain_stochastic_interpolation_torch.parallel.launch import spawn
from flowtrain_stochastic_interpolation_torch.solvers import solve_ode_final
from flowtrain_stochastic_interpolation_torch.train import loop as train_loop
from flowtrain_stochastic_interpolation_torch.train import objectives
from flowtrain_stochastic_interpolation_torch.train import steps as train_steps
from flowtrain_stochastic_interpolation_torch.train.callbacks import InferenceCallback
from flowtrain_stochastic_interpolation_torch.train.checkpoint import CheckpointManager, find_steps
from flowtrain_stochastic_interpolation_torch.train.loop import (
    build_model,
    init_model_variables,
    init_train_state,
)
from flowtrain_stochastic_interpolation_torch.train.shard_map_step import (
    apply_update,
    make_spatial_train_step,
    spatial_draws,
)
from flowtrain_stochastic_interpolation_torch.train.steps import make_eval_loss, make_train_step
from flowtrain_stochastic_interpolation_torch.utils import flops, profiling
from flowtrain_stochastic_interpolation_torch.utils.debug import check_finite
from flowtrain_stochastic_interpolation_torch.utils.msgpack_tree import Bfloat16
from flowtrain_stochastic_interpolation_torch.utils.rng import fold_seed
from flowtrain_stochastic_interpolation_torch.utils.rng import generator as folded_generator

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, bf16 tensor-core rate
# and the f32 rate of the FP32 cores (K4a and K4b compute in f32 there)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
# exponentials on the special-function units: 16 results per SM per clock x
# 132 SMs x the 1.83 GHz boost clock, the 3.9e12 per second that the
# FlashAttention-3 paper (Shah et al., 2024, section 3.3) quotes for the H100 SXM5
PEAK_EXP_PER_S = 3.9e12

BATCH = 8
STAGE_TOKENS = (262144, 32768, 4096)  # 64³, 32³, 16³
HEADS, WIDTH, N_MEM = 4, 128, 4
HEAD_DIM = WIDTH // HEADS
# the fa16 configuration: full attention at 16³ (stage 2) and at 4³ (stage 4)
FA16 = (False, False, True, False, True)
FLASH_TOKENS = (4096, 4096 + N_MEM)   # 16³ queries, and keys with the memory tokens
# the v1 path: LinearAttention(dim 48, 4 heads x 32, fused=True) at 64³ and 32³
V1_DIM = 48
# (batch, side, with the backward): 64³ at the sampler's batch, 64³ at the
# training micro-batch, 32³ at the sampler's batch
V1_CASES = ((8, 64, False), (4, 64, True), (8, 32, False))
# the widened kernels' cases: K1/K2 (heads, d, dtype) at b2 x 32³ and K3 (d, dtype)
# at b2 x 16³
WIDE_FOLDED = ((8, 32, torch.bfloat16), (4, 64, torch.bfloat16), (2, 64, torch.bfloat16),
               (4, 32, torch.float32))
WIDE_FLASH = ((8, torch.bfloat16), (16, torch.bfloat16), (48, torch.bfloat16),
              (128, torch.bfloat16), (32, torch.float32))
# K3's bf16 tensor-core path (d <= 128): (batch, queries, keys, d) at head widths
# that pad to 16 in the k-steps, fewer keys than one 64-key tile, and the fa16
# stage's M = N + 4 whose last tile holds 4 real keys
FLASH_MMA_CASES = tuple((2, 1024 + 37, 1024 + 41, d) for d in (8, 24, 40, 64, 128)) + (
    (3, 5, 9, 32), (1, 4096, 4100, 32))
# heads wider than 128 (the fourth slice's repair): d -> heads of the folded path
# (the fewest whose h·d is a multiple of 128)
WIDE_HEADS = {136: 16, 256: 1, 512: 1}
# the tap-folded conv's path: the flagship's train shape, bf16
CONV_SHAPE = (8, 64, 48, 48)
# K5b's bf16 box path: Cin x Cout on a non-cubic volume at batch 2, whose boxes
# meet every face and the batch boundary; then a shape the C entry point sends
# to the chunked kernel (f32, ragged Cin = 18)
BOX_VOLUME = (2, 8, 16, 24)
BOX_CASES = tuple((cin, cout, torch.bfloat16) for cin in (8, 96) for cout in (8, 48, 128)) + (
    (18, 48, torch.float32),)
# K5a's box path on the same volume, Cin x Cout in bf16; then the shapes that the C
# entry point sends to the tile kernel: the 18-channel input conv, its data
# gradient (48 -> 18) and f32
BOX_FORWARD_CASES = tuple((cin, cout, torch.bfloat16) for cin in (8, 48, 96)
                          for cout in (8, 48, 96, 128)) + (
    (18, 48, torch.bfloat16), (48, 18, torch.bfloat16), (48, 48, torch.float32))
# P1 past the tools' shapes: M = 524,288 + 37 (a ragged last tile) at K in {1296,
# 144} and N in {8, 48, 128} (the streaming kernel), and a K that is not a multiple
# of 8 (gemm_p1)
PROBE_CHECK_M = 524288 + 37
PROBE_CHECK_SHAPES = tuple((k, n) for k in (1296, 144) for n in (8, 48, 128)) + ((100, 48),)
# P2's checks against its plain version run this many products per grid step
# (every window of the 32, 8 of them twice); its times run the tool's R = 256
PROBE_CHECK_REPS = 40
# P2's window path at its edges, (m_block, K, N, grid, R): m_block under one
# 64-row tile, ragged against it and 2048 + 37; K under one 64-k slice, 1296
# (a last slice of 16) and 1600 (the largest, B in 48-column tiles); N under
# and at the 48-column tile, 64, 128, 130 (a ragged column tile) and 1296; R
# of one product, a pass of fewer than 8 windows, a round short of 32, one
# round, one product past it, 40 and 256. K = 100 (not a multiple of 8) takes
# the block-tile kernel.
P2_EDGE_CASES = (
    (16, 48, 48, 2, 1), (200, 1296, 40, 3, 7), (2048 + 37, 1296, 48, 2, 31),
    (200, 100, 48, 2, 32), (16, 1600, 64, 2, 33), (200, 1600, 130, 2, 40),
    (2048 + 37, 144, 8, 2, 256), (512, 48, 1296, 2, 40), (200, 432, 128, 3, 256),
    (2048 + 37, 1296, 64, 2, 40),
)
# kernel vs plain version, scaled to each case's values (they shrink as
# 1/sqrt(N) with the tokens): the same bf16 roundings, but K1 rounds exp(k - m)
# with each chunk's max where the plain version uses the global max, sums run
# in another order, and K2's bf16 output may differ by an ulp or two (2^-7
# relative each). Elementwise |kernel - plain| <= atol_frac·RMS + rtol·|plain|,
# with RMS that of the plain values on the head-diagonal blocks, and
# ||kernel - plain|| <= rel_l2·||plain||; K1 must be exactly 0 off those blocks.
# K3 is held to one bf16 ulp (2^-7·|plain|) plus 1e-3·RMS elementwise and 4e-3
# relative L2, lse (f32) within 1e-4 + 1e-5·|plain|, unchanged since the
# kernel ran on the FP32 cores. Its plain version computes in f32; the kernel's
# bf16 path sums exact bf16 products in f32 (scores in another order) and
# passes p to p·v as two bf16 terms, p_hi + p_lo, which carry p to about 2^-16
# (bf16 p alone, 2^-9, misses this tolerance); then both round out to bf16.
# K4a and K4b are held to the same rule. Their plain versions compute in f32.
# On 4 x 32 bf16 heads the kernels take each f32 product through bf16 terms on
# the tensor cores: K4a's p as p_hi + p_lo (v is bf16), K4b's p and ctx each as
# hi + lo, with p_lo·c_lo dropped; each product is within 2^-16 (K4b: 3·2^-16)
# of its f32 value (tests/test_torch_linear_attention_v1.py holds this order of
# sums against the JAX kernels). Elsewhere (f32, other heads or widths) they
# compute in f32 on the FP32 cores. Either way the kernels differ from the
# plain versions in the order of the sums and in K4a's range max.
TOL = {
    "folded_context": dict(atol_frac=3e-2, rtol=1e-2, rel_l2=1e-2),
    "folded_project": dict(atol_frac=3e-2, rtol=2e-2, rel_l2=1e-2),
    "flash_attention": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    "linear_context": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    "linear_project": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    # K5a, P1 and P2 against their plain versions: both sides sum exact products
    # of bf16 values in f32, in another order, then round once to bf16
    "tap_conv_forward": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    "gemm_probe": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    "gemm_probe_t": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    "mma_probe": dict(atol_frac=1e-3, rtol=2.0**-7, rel_l2=4e-3),
    # K5b: f32 dw on both sides, sums over 2^21 voxels in another order
    "tap_conv_weight_grad": dict(atol_frac=1e-4, rtol=1e-4, rel_l2=1e-4),
}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# the memory-heavy case: mem_k shifted up so that the 4 memory tokens outweigh
# 262,144 standard-normal keys (e^12 ≈ 1.6e5)
MEM_SHIFT = 12.0
# the bf16 forward on the card against the f32 forward on the CPU: relative L2
# error (measured ~1e-2 with the CPU's plain path in bf16)
FORWARD_REL_TOL = 3e-2
# the same forward at dtype="float32" on the card: both sides f32; K1 and K2
# round p, v and ctx to bf16 on both, with K1's chunk max against the global one
F32_FORWARD_REL_TOL = 1e-2
# a bf16 gradient through the kernels against autograd of the f32 plain version
BACKWARD_REL_TOL = 2e-2
# K5a (bf16 in and out) against F.conv3d in f32 on the same bf16 values: the
# output's bf16 rounding, 2^-9 relative at most per element
CONV_REF_REL_TOL = 1e-2
# the v1 module against the same weights through the folded kernels (which round
# p and v to bf16; about 1% of RMS): outputs and input gradients, relative L2
V1_FOLDED_REL_TOL, V1_FOLDED_GRAD_REL_TOL = 1e-2, 2e-2
TRAIN_MICRO_BATCH, TRAIN_ACCUM, TRAIN_WARMUP, TRAIN_STEPS = 4, 2, 2, 8
# the conditional model: an ensemble of 8 in batches of 4 (the recipe's
# inference.batch_size), RK4 over 3 frames (8 evaluations a batch); training at
# the recipe's micro-batch 8 x accumulation 4, 2 warm-up and 6 timed micro-steps
COND_SIDE, COND_SAMPLES, COND_BATCH, COND_FRAMES = 64, 8, 4, 3
COND_MICRO_BATCH, COND_ACCUM, COND_STEPS = 8, 4, 6
DIKE_CATEGORY = 13  # GeoGen's dikes, whose probability the ensemble analysis maps
# the app phase: the trained release weights of the flagship (3000 steps, bf16,
# EMA off, so ema_params and constants are empty), read without flax or msgpack
RELEASE_DIR = Path(__file__).resolve().parent / "artifacts" / "weights" / "uncond_demo_64"
RELEASE_LEAVES, RELEASE_VALUES = 299, 22_981_474
# the eval loss of the trained weights must be under this share of random weights'
# (the release trained from 3.84 to 0.070)
TRAINED_LOSS_SHARE = 0.1
EVAL_BATCH = 4
# the recipe's first update at b1 x accumulation 1 without dropout, bf16 on the card
# against f32 on the CPU from the same weights and draws. Loss and gradient norm
# within twice the forward's tolerance; the gradients (Adam's first moment) nearly
# parallel; Adam's first step moves each weight by about lr·sign(g), so a gradient
# component within bf16's error of 0 may flip its step: cosine 1 - 2·(the share
# flipped), at least 0.9 for a share up to 5%; the loss after the update within 10%,
# and it must move the same way on both
UPDATE_LOSS_REL_TOL = 2 * FORWARD_REL_TOL
UPDATE_GRAD_COSINE, UPDATE_STEP_COSINE, UPDATE_AFTER_REL_TOL = 0.99, 0.9, 0.1
# the app's inference: 8 samples in one batch at the flagship's RK4, 16 frames x 2
# substeps (120 evaluations, K1 and K2 6 times each); training: 24 micro-steps a
# run at the flagship's b6 x accumulation 24 (one update a run); the pretrain
# smoke samples 4 volumes with RK4 over 32 frames x 2 substeps (248 evaluations)
APP_SAMPLES, APP_STEPS = 8, 24
SMOKE_EVALUATIONS = (32 - 1) * 2 * 4
# the samplers' phase: the velocity SDE at b8 over the recipe's 16 frames x 2
# substeps (30 evaluations), eps 0.5 with the linear-decay schedule; frame
# dispatch at b2, RK4 over 4 frames x 2 substeps (24 evaluations); the
# conditional ensemble app at b4 (the recipe's 8 frames x 2 substeps: 14
# evaluations by the SDE, 56 by RK4); the conditional training app for 8
# micro-steps (2 updates at b8 x 4), then the callback's 4 samples over 32
# frames x 2 substeps (248 evaluations)
SDE_SAMPLES, SDE_EPSILON, SDE_EVALUATIONS = 8, 0.5, 15 * 2
# 10b′: the same pair while a buffer holds all of the card's free memory but this
# margin, the sampler's own need with its trajectory (about 8 GiB at b8) and room
# for the allocator
SDE_PRESSURE_MARGIN_GIB = 16.0
DISPATCH_BATCH, DISPATCH_FRAMES, DISPATCH_EVALUATIONS = 2, 4, 3 * 2 * 4
ENSEMBLE_SAMPLES, ENSEMBLE_SDE_EVALUATIONS, ENSEMBLE_RK4_EVALUATIONS = 4, 7 * 2, 7 * 2 * 4
COND_APP_STEPS, CALLBACK_SAMPLES, CALLBACK_EVALUATIONS = 8, 4, 31 * 2 * 4
# phase 11 (the thirteenth slice). 11a: reference-layout .ckpt files, written by the
# test helper that this script loads by its path, the flagship with RandomFourier time
# through the app (b8 x 120 evaluations) and conditional_64 through load_weights and one
# sample_conditional batch of 4 (8 evaluations); 11b: one b2 64³ bf16 forward per
# constructor option against f32 on the CPU, at times exact in bf16; 11c: 10 flagship
# micro-steps at b4 x 2 through the train loop per data source, and the native
# generator's batches alone; 11d: 128³ (2^21 tokens at the top stage) at b1
LAYOUT_HELPER = Path(__file__).resolve().parent / "tests" / "torch_lightning_layout.py"
OPTION_TIMES = (0.25, 0.625)
HOST_STEPS, NATIVE_BATCHES = 10, 8
SIDE_128, TOKENS_128 = 128, 128**3
# K1 and K2 launches per forward at 128³: the linear attention at 128³, 64³, 32³ and
# 16³, down and up (8³ has 512 tokens, under the folded path's 4096)
PER_FORWARD_128 = 8
# the remat_blocks step's gradients against the plain step's, relative L2 over all
# parameters: the recompute repeats the forward, but cuDNN's and the trilinear
# resize's backwards sum with atomics in no fixed order, so two plain steps already
# differ (printed beside it); both stay within the bf16 backward's tolerance
REMAT_GRAD_REL_TOL = BACKWARD_REL_TOL
# phase 12 (the fourteenth slice): parallelism over torch.distributed. 12a: the flagship
# data-parallel on 2 ranks, b4 each x accumulation 2, 3 micro-steps, no dropout (its masks
# are draws that a b8 and two b4 runs cannot share); 12b and 12c: the flagship at 128³ b1
# with X sharded over 4 ranks. With fewer cards than ranks, the ranks share card 0 over
# gloo, their collectives staged through pinned host memory.
DP_RANKS, DP_MICRO_BATCH, DP_ACCUM, DP_STEPS = 2, 4, 2, 3
SPATIAL_RANKS, SPATIAL_STEPS = 4, 2
PHASE12_SEED = 1200
RANK_DEADLINE_S = 420.0
# 12a against one process at b8 on the same batch and draws: cuDNN's convs at other batch
# shapes round other bf16 partial sums; the gradients as the bf16 backward's tolerance
DP_LOSS_REL_TOL = 1e-2
DP_GRAD_REL_TOL = BACKWARD_REL_TOL
# 12b: the sharded bf16 forward against the unsharded one (relative L2); the unsharded one
# runs K1 and K2, which round p and ctx to bf16, and the sharded linear attention (JAX's)
# computes in f32: the bf16 forward's tolerance. At f32 compute, against the unsharded
# einsum path: f32 rounding
SPATIAL_BF16_REL_TOL = FORWARD_REL_TOL
SPATIAL_F32_REL_TOL = 1e-4
# the RK4 decode against the unsharded sampler's from the same x0: the share of voxels
# that agree (the two velocity fields differ by the roundings above at every evaluation)
SPATIAL_DECODE_AGREEMENT = 0.9
# the sample's budget: fewer than the recipe's 16 frames where one evaluation's time says
# that they would pass it, so that phase 12 stays near 90 s (the rest of it takes about 65)
# and the script's last phase line, with phase 13, under half of its time limit
SPATIAL_SAMPLE_BUDGET_S = 20.0
# 12c: the first sharded step's loss against the unsharded forward's on the same draws
SPATIAL_LOSS_REL_TOL = 1e-2
# phase 13 (the fifteenth slice): the 2-D family and the toys. 13a and 13b: a UNet2D at
# 64² b8, bf16, dim 48, mults (1, 2, 4), 4 heads x 32, full attention at 32² and 16²:
# K1 and K2 at 64² (4096 tokens, down and up), K3 at 32² (1024 tokens), einsum at 16²;
# 13b samples it by RK4 over 16 frames x 2 substeps (120 evaluations)
UNET2D = dict(dim=48, dim_mults=(1, 2, 4), data_channels=3, attn_heads=4, attn_dim_head=32,
              full_attn=(False, True, True))
UNET2D_SIDE, UNET2D_BATCH = 64, 8
UNET2D_PER_FORWARD = {"folded_context": 2, "folded_project": 2, "flash_attention": 2}
# 13c: the image toy at its defaults for this many steps, its loss then under this share
# of its first; 13d: the 2-D toy at its defaults, the mean of this many samples of the
# trained flow this near the mixture's (its standard error 0.024 a coordinate; the
# app's 256 figure samples have 0.13)
TOY_IMAGE_STEPS, TOY_LOSS_SHARE = 300, 0.8
TOY2D_MEAN, TOY2D_MEAN_TOL, TOY2D_SAMPLES = (-0.4, -0.4), 0.15, 8192
# phase 14 (the sixteenth slice): the demo and trace tools through their main(), cut:
# the flagship demo for 20 steps at b4, then resumed for 5 more; the conditional demo
# for 8 micro-steps at b2 x accumulation 4 (two updates) at the JAX demo's lr 2.5e-4;
# every sampler over DEMO_FRAMES frames (the unconditional b8 and the conditional
# ensemble of 4: (2 - 1) x 2 substeps x 4 stages = 8 evaluations; sample_from_ckpt at
# 1 substep: 4); the trace over 2 forwards at b8. Its buckets must sum to the
# profiler's own kernel total within DEMO_TRACE_REL_TOL.
DEMO_STEPS, DEMO_RESUMED, DEMO_COND_STEPS, DEMO_FRAMES = 20, 25, 8, 2
DEMO_EVALUATIONS, DEMO_SAMPLE_EVALUATIONS = (DEMO_FRAMES - 1) * 2 * 4, (DEMO_FRAMES - 1) * 4
DEMO_TRACE_ITERS, DEMO_TRACE_REL_TOL = 2, 0.05
# phase 15 (the seventeenth slice): training held over many updates. 15a: the flagship
# recipe for TRAJ_STEPS updates at 32³ b2, accumulation 1, no dropout, the card's bf16 path
# (K1, K2 and the folded backward) against the same weights and draws in f32 on the card
# through K1's and K2's plain versions, TF32 off. t is rounded to bf16 on both sides: the
# bf16 model casts t before the Fourier embedding (ROADMAP, known traps). Every step's loss
# within TRAJ_LOSS_REL_TOL; the two total parameter changes at a cosine of TRAJ_COSINE or
# more. At 32³, K1 and K2 run at the 32³ and 16³ stages, down and up: 4 times a micro-step.
# 15b: tools.fixed_eval of the release on FIXED_EVAL_BATCHES batches of 8 at 64³, the
# kernel path against the plain versions: the means within FIXED_EVAL_REL_TOL.
TRAJ_STEPS, TRAJ_SIDE, TRAJ_BATCH, TRAJ_PER_STEP, TRAJ_SEED = 20, 32, 2, 4, 1500
TRAJ_LOSS_REL_TOL, TRAJ_COSINE = 2e-2, 0.98
FIXED_EVAL_BATCHES, FIXED_EVAL_BATCH, FIXED_EVAL_REL_TOL = 8, 8, 1e-2
FOLDED = ("folded_context", "folded_project")
SOURCES = {
    "folded_context": "flowtrain_stochastic_interpolation_torch/csrc/linear_attention.cu",
    "folded_project": "flowtrain_stochastic_interpolation_torch/csrc/linear_attention.cu",
    "flash_attention": "flowtrain_stochastic_interpolation_torch/csrc/flash_attention.cu",
    "linear_context": "flowtrain_stochastic_interpolation_torch/csrc/linear_attention.cu",
    "linear_project": "flowtrain_stochastic_interpolation_torch/csrc/linear_attention.cu",
    "tap_conv_forward": "flowtrain_stochastic_interpolation_torch/csrc/tap_conv.cu",
    "tap_conv_weight_grad": "flowtrain_stochastic_interpolation_torch/csrc/tap_conv.cu",
    "gemm_probe": "flowtrain_stochastic_interpolation_torch/csrc/gemm_probes.cu",
    "gemm_probe_t": "flowtrain_stochastic_interpolation_torch/csrc/gemm_probes.cu",
    "mma_probe": "flowtrain_stochastic_interpolation_torch/csrc/gemm_probes.cu",
}
REPLACES = {
    "folded_context": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:218",
    "folded_project": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:283",
    "flash_attention": "flowtrain_stochastic_interpolation_tpu/ops/flash_attention.py:33",
    "linear_context": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:36",
    "linear_project": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:75",
    "tap_conv_forward": "flowtrain_stochastic_interpolation_tpu/ops/tap_conv.py:76",
    "tap_conv_weight_grad": "flowtrain_stochastic_interpolation_tpu/ops/tap_conv.py:152",
    "gemm_probe": "tools/bench_pallas_gemm.py:53",
    "gemm_probe_t": "tools/bench_pallas_gemm.py:75",
    "mma_probe": "tools/bench_mxu_shapes.py:67",
}
KERNELS = tuple(REPLACES)

_T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {phase}: {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


COUNTED = (la, fa, tc, gp)  # the modules whose wrappers count their launches


def reset_counts() -> None:
    for module in COUNTED:
        module.reset_launch_counts()


def read_counts() -> dict:
    return {name: n for module in COUNTED for name, n in module.launch_counts.items()}


@contextlib.contextmanager
def operand_dtypes():
    """Record the dtype of the first operand of every call of the K1, K2 and K3
    wrappers (``{name: {dtype, ...}}``) while the block runs."""
    seen = {}
    targets = [(la, "folded_context"), (la, "folded_project"), (fa, "flash_attention_forward")]
    originals = [getattr(module, name) for module, name in targets]

    def spy(name, fn):
        def recorded(*args, **kwargs):
            seen.setdefault(name, set()).add(args[0].dtype)
            return fn(*args, **kwargs)
        return recorded

    for (module, name), fn in zip(targets, originals):
        setattr(module, name, spy(name.replace("_forward", ""), fn))
    try:
        yield seen
    finally:
        for (module, name), fn in zip(targets, originals):
            setattr(module, name, fn)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


# ---------------------------------------------------------------------------
# Kernel inputs, checks and times
# ---------------------------------------------------------------------------
def make_inputs(batch: int, n: int, seed: int, spread: bool = False, mem_shift: float = 0.0,
                heads: int = HEADS, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16,
                contiguous: bool = False):
    """q, k, v as column slices of one [B, N, 3·h·d] projection (as the UNet
    hands them over; as contiguous [B, N, h·d] tensors with ``contiguous``),
    and the folded memory KV [4, h·d]."""
    width = heads * d
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, n, 3 * width, generator=gen, device="cuda")
    mem = torch.randn(2, N_MEM, width, generator=gen, device="cuda")
    mem[0] += mem_shift
    if spread:
        # one head's logits far below another's, in q and in k
        for part in (0, 1):
            cols = slice(part * width, (part + 1) * width)
            block = qkv[..., cols]
            block[..., :d] -= 200.0
            block[..., (heads - 1) * d:] += 50.0
    qkv = qkv.to(dtype)
    mem = mem.to(dtype)
    q, k, v = qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]
    if contiguous:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v, mem[0].contiguous(), mem[1].contiguous()


def make_attention_inputs(batch: int, n: int, m: int, seed: int, q_scale: float = 1.0,
                          d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16):
    """q as a column slice of a [B, N, 3, h, d] projection (as the UNet hands
    it over); k and v contiguous [B, M, h, d] (the memory concatenation)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, n, 3, HEADS, d, generator=gen, device="cuda")
    qkv[:, :, 0] *= q_scale
    k = torch.randn(batch, m, HEADS, d, generator=gen, device="cuda")
    v = torch.randn(batch, m, HEADS, d, generator=gen, device="cuda")
    return qkv.to(dtype)[:, :, 0], k.to(dtype), v.to(dtype)


def make_v1_inputs(batch: int, n: int, seed: int, k_scale: float = 1.0, mem_shift: float = 0.0,
                   dtype: torch.dtype = torch.bfloat16, d: int = HEAD_DIM, heads: int = HEADS,
                   contiguous: bool = False):
    """As ``LinearAttention``'s v1 path hands them over: q a column slice of a
    [B, N, 3, h, d] projection (a contiguous [B, N, h, d] with ``contiguous``),
    and k, v [B, 4 + N, h, d] with the 4 memory tokens first (k's shifted up by
    ``mem_shift``, the keys scaled by ``k_scale``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, n, 3, heads, d, generator=gen, device="cuda")
    qkv[:, :, 1] *= k_scale
    mem = torch.randn(2, N_MEM, heads, d, generator=gen, device="cuda")
    mem[0] += mem_shift
    qkv, mem = qkv.to(dtype), mem.to(dtype)
    cat = lambda i: torch.cat([mem[i].expand(batch, -1, -1, -1), qkv[:, :, i + 1]], dim=1)
    q = qkv[:, :, 0]
    return q.contiguous() if contiguous else q, cat(0), cat(1)


def head_diagonal(width: int, heads: int, device) -> torch.Tensor:
    """[width, width] mask of the per-head diagonal blocks."""
    head = torch.arange(width, device=device) // (width // heads)
    return head[:, None] == head[None, :]


def compare(name: str, label: str, got: torch.Tensor, want: torch.Tensor,
            heads: int = HEADS) -> float:
    """Hold a kernel's output to its plain version's; returns the max abs error."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
    if name == "folded_context":
        diag = head_diagonal(want.shape[-1], heads, want.device)
        off = int(torch.count_nonzero(got[:, ~diag]).item())
        check(off == 0, f"{name} {label}: {off} nonzero entries off the head diagonal")
        rms = want[:, diag].square().mean().sqrt().item()
    else:
        rms = want.square().mean().sqrt().item()
    tol = TOL[name]
    atol = tol["atol_frac"] * rms
    diff = (got - want).abs()
    n_bad = int((diff > atol + tol["rtol"] * want.abs()).sum().item())
    max_abs = diff.max().item()
    rel = rel_l2(got, want)
    say("kernel check", f"{name} {label}: RMS {rms:.3e}, max abs err {max_abs:.3e} "
        f"({max_abs / rms:.3e} of RMS), relative L2 {rel:.3e} (limit {tol['rel_l2']:g}); "
        f"{n_bad} outside {tol['atol_frac']:g}·RMS + {tol['rtol']:g}·|plain|")
    check(n_bad == 0, f"{name} {label}: {n_bad} elements outside the tolerance")
    check(rel <= tol["rel_l2"], f"{name} {label}: relative L2 error {rel:.3e}")
    return max_abs


def check_lse(label: str, lse: torch.Tensor, want: torch.Tensor) -> None:
    """K3's lse (f32) within LSE_TOL of its plain version's."""
    err = (lse - want).abs()
    n_bad = int((err > LSE_TOL["atol"] + LSE_TOL["rtol"] * want.abs()).sum().item())
    say("kernel check", f"flash_attention {label}: lse max abs err {err.max().item():.3e}; "
        f"{n_bad} outside {LSE_TOL['atol']:g} + {LSE_TOL['rtol']:g}·|plain|")
    check(bool(torch.isfinite(lse).all()) and n_bad == 0,
          f"flash_attention {label}: lse outside the tolerance")


def check_folded(worst: dict) -> None:
    """K1 and K2 on 4 x 32 bf16 heads against their plain versions, each
    launched twice with identical outputs."""
    cases = [(f"b{BATCH} x {n}", BATCH, n, {}) for n in STAGE_TOKENS]
    cases += [(f"b{BATCH} x 4096+37 ragged", BATCH, 4096 + 37, {}),
              (f"b{BATCH} x {STAGE_TOKENS[0]}+37 ragged", BATCH, STAGE_TOKENS[0] + 37, {}),
              (f"b{BATCH} x 4096 cross-head spread", BATCH, 4096, dict(spread=True)),
              (f"b{BATCH} x {STAGE_TOKENS[0]} memory-heavy (mem_k + {MEM_SHIFT:g})", BATCH,
               STAGE_TOKENS[0], dict(mem_shift=MEM_SHIFT))]
    # the 4 x 32 kernels' edges: fewer tokens than one tile, batch 1, and
    # contiguous [B, N, 128] operands
    cases += [(f"b{b} x {n}", b, n, {}) for b in (1, BATCH) for n in (1, 5)]
    cases += [(f"b1 x {STAGE_TOKENS[0]}", 1, STAGE_TOKENS[0], {})]
    cases += [(f"b{b} x {label} contiguous", b, n, dict(contiguous=True))
              for b, n, label in ((BATCH, STAGE_TOKENS[1], STAGE_TOKENS[1]),
                                  (1, 4096 + 37, "4096+37 ragged"), (BATCH, 5, 5))]
    for i, (label, b, n, options) in enumerate(cases):
        q, k, v, mk, mv = make_inputs(b, n, seed=i, **options)
        ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
        ctx = la.folded_context(k, v, mk, mv, HEADS)
        again = la.folded_context(k, v, mk, mv, HEADS)
        out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
        out = la.folded_project(q, ctx_plain, HEADS)
        out_again = la.folded_project(q, ctx_plain, HEADS)
        torch.cuda.synchronize()
        for name, got, second, want in (("folded_context", ctx, again, ctx_plain),
                                        ("folded_project", out, out_again, out_plain)):
            worst[name] = max(worst[name], compare(name, label, got, want))
            check(torch.equal(got, second), f"{name} {label}: a second launch differs")
        del q, k, v, ctx, again, ctx_plain, out, out_again, out_plain


def phase_kernel_check():
    worst = {name: 0.0 for name in KERNELS}
    check_folded(worst)
    n, m = FLASH_TOKENS
    flash_cases = [(f"b{b} x {n} q x {m} kv", b, n, m, 1.0, HEAD_DIM)
                   for b in (BATCH, TRAIN_MICRO_BATCH)]
    flash_cases += [("b2 x 1024+37 q x 1024+41 kv ragged", 2, 1024 + 37, 1024 + 41, 1.0, HEAD_DIM),
                    (f"b{BATCH} x {n} q x {m} kv peaked (q x 8)", BATCH, n, m, 8.0, HEAD_DIM)]
    flash_cases += [(f"b{b} x {nq} q x {nk} kv x {HEADS} heads x {d}", b, nq, nk, 1.0, d)
                    for b, nq, nk, d in FLASH_MMA_CASES]
    for i, (label, b, nq, nk, q_scale, d) in enumerate(flash_cases):
        q, k, v = make_attention_inputs(b, nq, nk, seed=50 + i, q_scale=q_scale, d=d)
        out, lse = fa.flash_attention_forward(q, k, v)
        want_out, want_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        worst["flash_attention"] = max(worst["flash_attention"],
                                       compare("flash_attention", label, out, want_out))
        check_lse(label, lse, want_lse)
        del q, k, v, out, lse, want_out, want_lse

    # the widened K1/K2 (their general path) and K3, each at its own tolerance
    for i, (heads, d, dtype) in enumerate(WIDE_FOLDED):
        label = f"b2 x {STAGE_TOKENS[1]} x {heads} heads x {d} {str(dtype)[6:]}"
        q, k, v, mk, mv = make_inputs(2, STAGE_TOKENS[1], seed=20 + i, heads=heads, d=d,
                                      dtype=dtype)
        ctx_plain = la.folded_context_plain(k, v, mk, mv, heads)
        ctx = la.folded_context(k, v, mk, mv, heads)
        out_plain = la.folded_project_plain(q, ctx_plain, heads)
        out = la.folded_project(q, ctx_plain, heads)
        torch.cuda.synchronize()
        check(out.dtype == dtype, f"folded_project {label}: output {out.dtype}")
        for name, got, want in (("folded_context", ctx, ctx_plain),
                                ("folded_project", out, out_plain)):
            worst[name] = max(worst[name], compare(name, label, got, want, heads))
        del q, k, v, ctx, ctx_plain, out, out_plain
    n, m = FLASH_TOKENS
    for i, (d, dtype) in enumerate(WIDE_FLASH):
        label = f"b2 x {n} q x {m} kv x {HEADS} heads x {d} {str(dtype)[6:]}"
        q, k, v = make_attention_inputs(2, n, m, seed=70 + i, d=d, dtype=dtype)
        out, lse = fa.flash_attention_forward(q, k, v)
        want_out, want_lse = fa.flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        check(out.dtype == dtype, f"flash_attention {label}: output {out.dtype}")
        worst["flash_attention"] = max(worst["flash_attention"],
                                       compare("flash_attention", label, out, want_out))
        check_lse(label, lse, want_lse)
        del q, k, v, out, lse, want_out, want_lse

    check_v1(worst)
    return worst


def check_v1(worst: dict) -> None:
    """K4a and K4b against their plain versions: on 4 x 32 bf16 heads (the
    specialised kernels, each case launched twice with identical outputs) at
    the v1 block's shapes and edges, then one case per rule that keeps the
    general path (f32; 2 heads x 64)."""
    n0, n1 = STAGE_TOKENS[:2]
    cases = [(f"b{BATCH} x {n} q x {n + N_MEM} kv", BATCH, n, {}) for n in (n0, n1)]
    cases += [(f"b{b} x 1 q x {1 + N_MEM} kv", b, 1, {}) for b in (1, BATCH)]
    cases += [(f"b2 x {n1}+37 ragged", 2, n1 + 37, {}),
              (f"b1 x {n0}", 1, n0, {}),
              (f"b{BATCH} x {n1} peaked (k x 8)", BATCH, n1, dict(k_scale=8.0)),
              (f"b{BATCH} x {n0} memory-heavy (mem_k + {MEM_SHIFT:g})", BATCH, n0,
               dict(mem_shift=MEM_SHIFT)),
              (f"b{BATCH} x {n1} q contiguous", BATCH, n1, dict(contiguous=True)),
              (f"b1 x {n1}+37 ragged, q contiguous", 1, n1 + 37, dict(contiguous=True))]
    general = [(f"b{BATCH} x {n1} float32", BATCH, n1, dict(dtype=torch.float32)),
               (f"b2 x {n1} x 2 heads x 64", 2, n1, dict(heads=2, d=64))]
    for i, (label, b, n, options) in enumerate(cases + general):
        specialised = i < len(cases)
        q, k, v = make_v1_inputs(b, n, seed=80 + i, **options)
        check(la._v1_specialised(k, v) == la._v1_specialised(q) == specialised,
              f"v1 {label}: the dispatch does not take the "
              f"{'4 x 32 bf16' if specialised else 'general'} kernels")
        label += "" if specialised else " (general path)"
        ctx_plain = la.linear_context_plain(k, v)
        ctx, ctx_again = la.linear_context(k, v), la.linear_context(k, v)
        out_plain = la.linear_project_plain(q, ctx_plain)
        out, out_again = la.linear_project(q, ctx_plain), la.linear_project(q, ctx_plain)
        torch.cuda.synchronize()
        check(out.dtype == q.dtype and out.shape == q.shape and out.is_contiguous(),
              f"linear_project {label}: output {out.dtype} {tuple(out.shape)}")
        for name, got, again, want in (("linear_context", ctx, ctx_again, ctx_plain),
                                       ("linear_project", out, out_again, out_plain)):
            worst[name] = max(worst[name], compare(name, label, got, want))
            check(not specialised or torch.equal(got, again),
                  f"{name} {label}: a second launch differs")
        del q, k, v, ctx, ctx_again, ctx_plain, out, out_again, out_plain


def time_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 3) -> float:
    """Median over ``rounds`` of the mean device time of ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    means = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def bound(bytes_moved: float, flops: float, peak_flop_per_s: float = PEAK_BF16_FLOP_PER_S,
          exps: float = 0.0):
    """The least time in ms the card could take, and what sets it: the bytes
    over the memory rate, the products over their peak, or the exponentials
    over the special-function units' rate, whichever is largest."""
    times = ((bytes_moved / PEAK_BYTES_PER_S * 1e3, "bytes"),
             (flops / peak_flop_per_s * 1e3, "operations"),
             (exps / PEAK_EXP_PER_S * 1e3, "exponentials"))
    return max(times, key=lambda term: term[0])


def context_work(batch: int, n: int):
    """K1's bytes (k and v once each, bf16; the memory tokens; the f32 ctx),
    products (the four diagonal blocks) and exponentials (one per token and column)."""
    return (2 * batch * n * WIDTH * 2 + 2 * N_MEM * WIDTH * 2 + batch * WIDTH * WIDTH * 4,
            2.0 * batch * n * WIDTH * HEAD_DIM, batch * (n + N_MEM) * WIDTH)


def project_work(batch: int, n: int):
    """K2's bytes (q in, out, bf16; the f32 ctx), products and exponentials."""
    return (2 * batch * n * WIDTH * 2 + batch * WIDTH * WIDTH * 4,
            2.0 * batch * n * WIDTH * HEAD_DIM, batch * n * WIDTH)


def v1_context_work(batch: int, n: int):
    """K4a's bytes (k and v of n + 4 tokens once each, bf16; the f32 ctx [B, 4,
    32, 32]), f32 products and exponentials, for n queries."""
    m = n + N_MEM
    return (2 * batch * m * WIDTH * 2 + batch * WIDTH * HEAD_DIM * 4,
            2.0 * batch * m * WIDTH * HEAD_DIM, batch * m * WIDTH)


def v1_project_work(batch: int, n: int):
    """K4b's bytes (q in, out, bf16; the f32 ctx), f32 products and exponentials."""
    return (2 * batch * n * WIDTH * 2 + batch * WIDTH * HEAD_DIM * 4,
            2.0 * batch * n * WIDTH * HEAD_DIM, batch * n * WIDTH)


def probe_work(m: int, k: int, n: int):
    """P1's bytes (A, B and the output once each, bf16) and products."""
    return 2 * (m * k + k * n + m * n), 2.0 * m * k * n


def mma_probe_work(m_block: int, k: int, n: int, grid: int, reps: int):
    """P2's bytes (A [grid, m_block + 256, K], B and the output once each, bf16)
    and products (R window products of [m_block, K] @ [K, N] per grid step)."""
    return (2 * (grid * (m_block + gp.WINDOW_PAD) * k + k * n + m_block * n),
            2.0 * m_block * grid * k * n * reps)


def conv_work(voxels: int, cin: int, cout: int):
    """K5a's bytes (x and the output once each and w, bf16; the f32 bias) and products."""
    return (2 * voxels * (cin + cout) + 2 * 27 * cin * cout + 4 * cout,
            2.0 * voxels * 27 * cin * cout)


def timed_row(name: str, label: str, kernel, plain, nbytes: float, flops: float,
              peak_flop_per_s: float = PEAK_BF16_FLOP_PER_S, library=None,
              library_name: str = "", exps: float = 0.0) -> dict:
    """Time a kernel, its plain version and (where there is one) a library call
    on the same inputs, print the row beside the bound, and return it."""
    ms = time_ms(kernel)
    plain_ms = time_ms(plain, reps=2, rounds=3, warmup=1)
    library_ms = None if library is None else time_ms(library)
    bound_ms, bound_by = bound(nbytes, flops, peak_flop_per_s, exps)
    lib = "null" if library is None else f"({library_name}) {library_ms:.4f} ms"
    say("kernel times", f"{name} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library {lib}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_kernel_times():
    rows = {}
    for n in STAGE_TOKENS:
        q, k, v, mk, mv = make_inputs(BATCH, n, seed=100)
        ctx = la.folded_context_plain(k, v, mk, mv, HEADS)
        label = f"b{BATCH} x {n}"
        nbytes, flops, exps = context_work(BATCH, n)
        rows[("folded_context", BATCH, n)] = timed_row(
            "folded_context", label, lambda: la.folded_context(k, v, mk, mv, HEADS),
            lambda: la.folded_context_plain(k, v, mk, mv, HEADS), nbytes, flops, exps=exps)
        nbytes, flops, exps = project_work(BATCH, n)
        rows[("folded_project", BATCH, n)] = timed_row(
            "folded_project", label, lambda: la.folded_project(q, ctx, HEADS),
            lambda: la.folded_project_plain(q, ctx, HEADS), nbytes, flops, exps=exps)
        del q, k, v, ctx

    n, m = FLASH_TOKENS
    for b in (BATCH, TRAIN_MICRO_BATCH):
        q, k, v = make_attention_inputs(b, n, m, seed=200)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's [B, h, tokens, d]
        rows[("flash_attention", b, n)] = timed_row(
            "flash_attention", f"b{b} x {n} q x {m} kv x {HEADS} x {HEAD_DIM}",
            lambda: fa.flash_attention_forward(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
            2 * (2 * b * n + 2 * b * m) * WIDTH + 4 * b * HEADS * n,
            4.0 * b * HEADS * n * m * HEAD_DIM,
            library=lambda: F.scaled_dot_product_attention(qt, kt, vt),
            library_name="scaled_dot_product_attention", exps=b * HEADS * n * m)
        del q, k, v, qt, kt, vt

    # K4a and K4b: bf16 q, k, v in and out, f32 ctx, f32 products (counted at the
    # FP32 cores' rate, whatever units compute them)
    for n in STAGE_TOKENS[:2]:
        q, k, v = make_v1_inputs(BATCH, n, seed=110)
        ctx = la.linear_context_plain(k, v)
        label = f"b{BATCH} x {n} x {HEADS} x {HEAD_DIM}"
        nbytes, flops, exps = v1_context_work(BATCH, n)
        rows[("linear_context", BATCH, n)] = timed_row(
            "linear_context", label, lambda: la.linear_context(k, v),
            lambda: la.linear_context_plain(k, v), nbytes, flops, PEAK_F32_FLOP_PER_S, exps=exps)
        nbytes, flops, exps = v1_project_work(BATCH, n)
        rows[("linear_project", BATCH, n)] = timed_row(
            "linear_project", label, lambda: la.linear_project(q, ctx),
            lambda: la.linear_project_plain(q, ctx), nbytes, flops, PEAK_F32_FLOP_PER_S,
            exps=exps)
        del q, k, v, ctx
    return rows


def phase_backwards():
    """bf16 gradients through the kernels against autograd of the f32 plain versions, 16³ b1."""
    gen = torch.Generator(device="cuda").manual_seed(300)
    n, m = FLASH_TOKENS
    q, k, v = make_attention_inputs(1, n, m, seed=301)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*ours).backward(dout)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    fa.flash_attention_plain(*ref)[0].backward(dout.float())
    errs = [rel_l2(a.grad, b.grad) for a, b in zip(ours, ref)]
    say("backwards", f"flash b1 x {n} q x {m} kv, bf16 vs autograd of the f32 plain version: "
        f"relative L2 dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
        f"(limit {BACKWARD_REL_TOL:g})")
    check(max(errs) <= BACKWARD_REL_TOL, f"flash backward relative L2 {max(errs):.3e}")

    q, k, v, mk, mv = make_inputs(1, n, seed=302)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v, mk, mv)]
    la.linear_attention_folded(*ours, heads=HEADS).backward(dout)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v, mk, mv)]
    b = ref[0].shape[0]
    split = lambda t: t.reshape(t.shape[0], -1, HEADS, HEAD_DIM)
    kk = torch.cat([ref[3].expand(b, -1, -1), ref[1]], dim=1)
    vv = torch.cat([ref[4].expand(b, -1, -1), ref[2]], dim=1)
    ctx = torch.einsum("bnhd,bnhe->bhde", torch.softmax(split(kk), dim=1), split(vv))
    out = torch.einsum("bnhd,bhde->bnhe", torch.softmax(split(ref[0]), dim=-1) * HEAD_DIM**-0.5,
                       ctx)
    out.reshape(ref[0].shape).backward(dout.float())
    errs = [rel_l2(a.grad, r.grad) for a, r in zip(ours, ref)]
    say("backwards", f"folded (K1 + K2, closed_form_bf16) b1 x {n} x {WIDTH}, bf16 vs autograd "
        f"of the f32 einsum composition: relative L2 " +
        ", ".join(f"{g} {e:.3e}" for g, e in zip(("dq", "dk", "dv", "dmk", "dmv"), errs)) +
        f" (limit {BACKWARD_REL_TOL:g})")
    check(max(errs) <= BACKWARD_REL_TOL, f"folded backward relative L2 {max(errs):.3e}")

    n = STAGE_TOKENS[1]
    q, k, v = make_v1_inputs(1, n, seed=303)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    ours = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    la.linear_attention(*ours).backward(dout)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    la.linear_attention_reference(*ref).backward(dout.float())
    errs = [rel_l2(a.grad, r.grad) for a, r in zip(ours, ref)]
    say("backwards", f"v1 (K4a + K4b, closed form) b1 x {n} q x {n + N_MEM} kv x {HEADS} x "
        f"{HEAD_DIM}, bf16 vs autograd of the f32 plain version: relative L2 dq {errs[0]:.3e}, "
        f"dk {errs[1]:.3e}, dv {errs[2]:.3e} (limit {BACKWARD_REL_TOL:g})")
    check(max(errs) <= BACKWARD_REL_TOL, f"v1 backward relative L2 {max(errs):.3e}")


# ---------------------------------------------------------------------------
# Heads wider than 128 (the fourth slice's repair of K1-K4b)
# ---------------------------------------------------------------------------
def seed_module(module: torch.nn.Module, gen: torch.Generator) -> None:
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)


def phase_wide_heads(worst: dict) -> dict:
    """K1-K4b at d in WIDE_HEADS, bf16 and f32, against their plain versions,
    with the bf16 times; then the attention modules at those widths, the
    repair's path."""
    n, m = FLASH_TOKENS
    tokens = STAGE_TOKENS[1]
    for d, heads in WIDE_HEADS.items():
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = f"d = {d} {str(dtype)[6:]}"
            label = f"b2 x {tokens} x {heads} heads x {tag}"
            q, k, v, mk, mv = make_inputs(2, tokens, seed=400 + d, heads=heads, d=d, dtype=dtype)
            ctx_plain = la.folded_context_plain(k, v, mk, mv, heads)
            ctx = la.folded_context(k, v, mk, mv, heads)
            out_plain = la.folded_project_plain(q, ctx_plain, heads)
            out = la.folded_project(q, ctx_plain, heads)
            torch.cuda.synchronize()
            check(out.dtype == dtype, f"folded_project {label}: output {out.dtype}")
            for name, got, want in (("folded_context", ctx, ctx_plain),
                                    ("folded_project", out, out_plain)):
                worst[name] = max(worst[name], compare(name, label, got, want, heads))
            if timed:  # bytes: the [2, N, h·d] operands and the f32 ctx; products per head block
                hd, ctx_bytes = heads * d, 2 * (heads * d) ** 2 * 4
                flops = 2.0 * 2 * tokens * hd * d
                timed_row("folded_context", label, lambda: la.folded_context(k, v, mk, mv, heads),
                          lambda: la.folded_context_plain(k, v, mk, mv, heads),
                          2 * 2 * tokens * hd * 2 + ctx_bytes, flops)
                timed_row("folded_project", label, lambda: la.folded_project(q, ctx_plain, heads),
                          lambda: la.folded_project_plain(q, ctx_plain, heads),
                          2 * 2 * tokens * hd * 2 + ctx_bytes, flops)
            del q, k, v, mk, mv, ctx, ctx_plain, out, out_plain

            label = f"b2 x {STAGE_TOKENS[1]} q x {STAGE_TOKENS[1] + N_MEM} kv x {HEADS} heads x {tag}"
            q, k, v = make_v1_inputs(2, STAGE_TOKENS[1], seed=410 + d, dtype=dtype, d=d)
            ctx_plain = la.linear_context_plain(k, v)
            ctx = la.linear_context(k, v)
            out_plain = la.linear_project_plain(q, ctx_plain)
            out = la.linear_project(q, ctx_plain)
            torch.cuda.synchronize()
            check(out.dtype == dtype and out.shape == q.shape,
                  f"linear_project {label}: output {out.dtype} {tuple(out.shape)}")
            for name, got, want in (("linear_context", ctx, ctx_plain),
                                    ("linear_project", out, out_plain)):
                worst[name] = max(worst[name], compare(name, label, got, want))
            if timed:  # f32 products on the FP32 cores
                ctx_bytes = 2 * HEADS * d * d * 4
                timed_row("linear_context", label, lambda: la.linear_context(k, v),
                          lambda: la.linear_context_plain(k, v),
                          2 * 2 * (tokens + N_MEM) * HEADS * d * 2 + ctx_bytes,
                          2.0 * 2 * (tokens + N_MEM) * HEADS * d * d, PEAK_F32_FLOP_PER_S)
                timed_row("linear_project", label, lambda: la.linear_project(q, ctx_plain),
                          lambda: la.linear_project_plain(q, ctx_plain),
                          2 * 2 * tokens * HEADS * d * 2 + ctx_bytes,
                          2.0 * 2 * tokens * HEADS * d * d, PEAK_F32_FLOP_PER_S)
            del q, k, v, ctx, ctx_plain, out, out_plain

            label = f"b2 x {n} q x {m} kv x {HEADS} heads x {tag}"
            q, k, v = make_attention_inputs(2, n, m, seed=420 + d, d=d, dtype=dtype)
            out, lse = fa.flash_attention_forward(q, k, v)
            want_out, want_lse = fa.flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            check(out.dtype == dtype, f"flash_attention {label}: output {out.dtype}")
            worst["flash_attention"] = max(worst["flash_attention"],
                                           compare("flash_attention", label, out, want_out))
            check_lse(label, lse, want_lse)
            if timed:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's [B, h, tokens, d]
                timed_row("flash_attention", label, lambda: fa.flash_attention_forward(q, k, v),
                          lambda: fa.flash_attention_plain(q, k, v),
                          2 * (2 * 2 * n + 2 * 2 * m) * HEADS * d + 4 * 2 * HEADS * n,
                          4.0 * 2 * HEADS * n * m * d,
                          library=lambda: F.scaled_dot_product_attention(qt, kt, vt),
                          library_name="scaled_dot_product_attention", exps=2 * HEADS * n * m)
                del qt, kt, vt
            del q, k, v, out, lse, want_out, want_lse
    torch.cuda.empty_cache()

    # the path: the attention modules at these widths, bf16
    gen = torch.Generator(device="cuda").manual_seed(430)
    bf16 = dict(dtype=torch.bfloat16, device="cuda")
    modules = []
    for d, heads in WIDE_HEADS.items():
        folded = LinearAttention(V1_DIM, heads, d, **bf16)
        seed_module(folded, gen)
        v1 = LinearAttention(V1_DIM, heads, d, fused=True, fused_folded=False, **bf16)
        v1.load_state_dict(folded.state_dict())
        full = Attention(V1_DIM, heads, d, **bf16)
        seed_module(full, gen)
        modules.append((d, heads, folded, v1, full))
    x32 = torch.randn(2, 32, 32, 32, V1_DIM, generator=gen, device="cuda").to(torch.bfloat16)
    x16 = torch.randn(2, 16, 16, 16, V1_DIM, generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    with torch.inference_mode():
        outs = [(d, heads, folded(x32), v1(x32), full(x16)) for d, heads, folded, v1, full in modules]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = read_counts()
    for d, heads, a, b, c in outs:
        check(all(bool(torch.isfinite(t).all()) for t in (a, b, c)), f"wide heads d = {d}: non-finite")
        rel = rel_l2(b, a)
        say("wide heads", f"LinearAttention({V1_DIM}, {heads} x {d}) 32³ b2: v1 (K4a + K4b) against "
            f"folded (K1 + K2) relative L2 {rel:.3e} (limit {V1_FOLDED_REL_TOL:g}); "
            f"Attention({V1_DIM}, {heads} x {d}) 16³ b2 (K3) finite")
        check(rel <= V1_FOLDED_REL_TOL, f"wide heads d = {d}: v1 against folded {rel:.3e}")
    want = {name: len(WIDE_HEADS) if name in ("folded_context", "folded_project", "linear_context",
                                              "linear_project", "flash_attention") else 0
            for name in KERNELS}
    say("wide heads", f"the modules at d = {', '.join(map(str, WIDE_HEADS))}: {seconds:.2f} s "
        f"(first calls), launches {counts}")
    check(counts == want, f"wide heads: launches {counts}, expected {want}")
    del modules, outs
    torch.cuda.empty_cache()
    return {"wide heads": counts}


# ---------------------------------------------------------------------------
# The tap-folded conv (the fourth slice's main path)
# ---------------------------------------------------------------------------
def conv_f32(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """F.conv3d in f32 on the same values (TF32 off), channels-last in and out."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.float().permute(4, 3, 0, 1, 2),
                 None if b is None else b.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def conv_cotangent(batch: int, side: int, cout: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(batch, side, side, side, cout, generator=gen,
                       device="cuda").to(torch.bfloat16)


def phase_tap_conv(worst: dict):
    """K5a and K5b against their plain versions and F.conv3d, the custom VJP at
    the flagship's train shape (the path), their times, and the tool."""
    def forward_check(label: str, x, w, b, ref=None):
        """K5a against its plain version, the same on a second call, and against
        ``ref`` (F.conv3d in f32) where given."""
        out = tc.tap_conv_forward(x, w, b)
        again = tc.tap_conv_forward(x, w, b)
        want = tc.tap_conv_forward_plain(x, w, b)
        torch.cuda.synchronize()
        check(out.dtype == x.dtype and out.shape == want.shape,
              f"tap_conv_forward {label}: output {out.dtype} {tuple(out.shape)}")
        worst["tap_conv_forward"] = max(worst["tap_conv_forward"],
                                        compare("tap_conv_forward", label, out, want))
        check(torch.equal(out, again), f"tap_conv_forward {label}: differs from run to run")
        if ref is not None:
            rel = rel_l2(out, ref)
            say("tap conv", f"tap_conv_forward {label} against F.conv3d in f32: relative L2 "
                f"{rel:.3e} (limit {CONV_REF_REL_TOL:g})")
            check(rel <= CONV_REF_REL_TOL, f"tap_conv_forward {label}: {rel:.3e} from F.conv3d")

    for batch, side, cin, cout, _ in btc.CASES:
        x, w, b = btc.operands(batch, side, cin, cout, "cuda")
        forward_check(f"b{batch} {side}³ {cin} -> {cout} bf16", x, w, b, conv_f32(x, w, b))
        del x, w, b
    box_batch, *box_spatial = BOX_VOLUME
    for cin_x, cout_x, dtype in BOX_FORWARD_CASES:
        gen = torch.Generator(device="cuda").manual_seed(540 + cin_x + cout_x)
        x = torch.randn(*BOX_VOLUME, cin_x, generator=gen, device="cuda").to(dtype)
        w = torch.randn(3, 3, 3, cin_x, cout_x, generator=gen, device="cuda") * (27 * cin_x) ** -0.5
        b = torch.randn(cout_x, generator=gen, device="cuda") * 0.1
        forward_check(f"b{box_batch} {'x'.join(map(str, box_spatial))} {cin_x} -> {cout_x} "
                      f"{str(dtype)[6:]}", x, w.to(dtype), b)
        del x, w, b

    batch, side, cin, cout = CONV_SHAPE
    def weight_grad_cases():
        """(label, x, g): the flagship's width and a ragged K = 27·18 at its
        train shape, then the box path's edges (and the chunked kernel's f32
        shape) on a non-cubic volume at batch 2."""
        for cin_x in (cin, 18):
            x, _, _ = btc.operands(batch, side, cin_x, cout, "cuda")
            yield (f"b{batch} {side}³ {cin_x} -> {cout} bf16", x,
                   conv_cotangent(batch, side, cout, seed=500 + cin_x))
        box_batch, *box_spatial = BOX_VOLUME
        for cin_x, cout_x, dtype in BOX_CASES:
            gen = torch.Generator(device="cuda").manual_seed(520 + cin_x + cout_x)
            yield (f"b{box_batch} {'x'.join(map(str, box_spatial))} {cin_x} -> {cout_x} "
                   f"{str(dtype)[6:]}",
                   torch.randn(*BOX_VOLUME, cin_x, generator=gen, device="cuda").to(dtype),
                   torch.randn(*BOX_VOLUME, cout_x, generator=gen, device="cuda").to(dtype))

    for label, x, g in weight_grad_cases():
        dw = tc.tap_conv_weight_grad(x, g)
        again = tc.tap_conv_weight_grad(x, g)
        want = tc.tap_conv_weight_grad_plain(x, g)
        torch.cuda.synchronize()
        worst["tap_conv_weight_grad"] = max(worst["tap_conv_weight_grad"],
                                            compare("tap_conv_weight_grad", label, dw, want))
        check(torch.equal(dw, again), f"tap_conv_weight_grad {label}: differs from run to run")
        del x, g, dw, again, want

    # the path: tap_conv3d forward and backward at the flagship's train shape
    x, w, b = btc.operands(batch, side, cin, cout, "cuda")
    g = conv_cotangent(batch, side, cout, seed=510)
    ours = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    tc.tap_conv3d(*ours).backward(g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = read_counts()
    want = {name: {"tap_conv_forward": 2, "tap_conv_weight_grad": 1}.get(name, 0)
            for name in KERNELS}
    say("tap conv", f"tap_conv3d forward + backward b{batch} {side}³ {cin} -> {cout} bf16: "
        f"{seconds * 1e3:.1f} ms (first call), launches {counts}")
    check(counts == want, f"tap conv: launches {counts}, expected {want}")
    w_flip = torch.flip(w, (0, 1, 2)).transpose(3, 4)
    plain = (tc.tap_conv_forward_plain(g, w_flip),
             tc.tap_conv_weight_grad_plain(x, g).to(torch.bfloat16),
             g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(torch.bfloat16).float())
    ref = [t.detach().float().requires_grad_() for t in (x, w, b)]
    conv_f32(*ref).backward(g.float())
    for name, got, want_plain, r in zip(("dx", "dw", "db"), ours, plain, ref):
        check(got.grad.dtype == got.dtype, f"tap conv {name}: {got.grad.dtype}")
        compare("tap_conv_forward", f"VJP {name} against the plain backward", got.grad, want_plain)
        rel = rel_l2(got.grad, r.grad)
        say("tap conv", f"VJP {name} against autograd of the f32 F.conv3d: relative L2 {rel:.3e} "
            f"(limit {BACKWARD_REL_TOL:g})")
        check(rel <= BACKWARD_REL_TOL, f"tap conv VJP {name}: {rel:.3e} from autograd")
    del ours, plain, ref

    # times at the flagship's train shape, beside cuDNN
    fmt = torch.channels_last_3d
    xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
    wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=fmt)
    bc = b.to(torch.bfloat16)
    voxels = batch * side**3
    nbytes, flops = conv_work(voxels, cin, cout)
    label = f"b{batch} {side}³ {cin} -> {cout} bf16"
    rows = {
        "tap_conv_forward": timed_row(
            "tap_conv_forward", label, lambda: tc.tap_conv_forward(x, w, b),
            lambda: tc.tap_conv_forward_plain(x, w, b), nbytes, flops,
            library=lambda: F.conv3d(xc, wc, bc, padding=1),
            library_name="F.conv3d, cuDNN, channels_last_3d"),
        "tap_conv_weight_grad": timed_row(
            "tap_conv_weight_grad", label, lambda: tc.tap_conv_weight_grad(x, g),
            lambda: tc.tap_conv_weight_grad_plain(x, g),
            2 * voxels * (cin + cout) + 4 * 27 * cin * cout, flops,
            library=lambda: torch.nn.grad.conv3d_weight(xc, wc.shape, gc, padding=1),
            library_name="conv3d_weight, cuDNN, channels_last_3d"),
    }
    del x, w, b, g, xc, gc, wc, bc
    torch.cuda.empty_cache()

    # the tool, in full
    reset_counts()
    for batch, side, cin, cout, grad in btc.CASES:
        btc.check_and_bench(batch, side, cin, cout, grad=grad, device="cuda")
    launches = {"tap conv": counts, "bench_tap_conv": read_counts()}
    say("tap conv", f"bench_tap_conv launches {launches['bench_tap_conv']}")
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# The GEMM probes P1 and P2
# ---------------------------------------------------------------------------
def phase_gemm_probes(worst: dict):
    """P1 (both layouts) at its four shapes and P2 at its ten cases against
    their plain versions, their times, and the two tools (the path)."""
    rows = {}
    for k, n in bg.SHAPES:
        label = f"[{bg.M} x {k}] @ [{k} x {n}]"
        a, b, bt = bg.operands(bg.M, k, n, "cuda")
        out, out_t = gp.gemm_probe(a, b), gp.gemm_probe_t(a, bt)
        want, want_t = gp.gemm_probe_plain(a, b), gp.gemm_probe_t_plain(a, bt)
        torch.cuda.synchronize()
        check(out.shape == (bg.M, n) and out_t.shape == (n, bg.M), f"gemm_probe {label}: shapes")
        for name, got, ref in (("gemm_probe", out, want), ("gemm_probe_t", out_t, want_t)):
            worst[name] = max(worst[name], compare(name, label, got, ref))
        del out, out_t, want, want_t
        if (k, n) == bg.SHAPES[0]:  # the conv's shape: times beside torch.matmul
            nbytes, flops = probe_work(bg.M, k, n)
            rows["gemm_probe"] = timed_row(
                "gemm_probe", label, lambda: gp.gemm_probe(a, b),
                lambda: gp.gemm_probe_plain(a, b), nbytes, flops,
                library=lambda: torch.matmul(a, b), library_name="torch.matmul, [M, N]")
            rows["gemm_probe_t"] = timed_row(
                "gemm_probe_t", label, lambda: gp.gemm_probe_t(a, bt),
                lambda: gp.gemm_probe_t_plain(a, bt), nbytes, flops,
                library=lambda: torch.matmul(bt, a.T), library_name="torch.matmul, [N, M]")
        del a, b, bt

    for k, n in PROBE_CHECK_SHAPES:  # both layouts, each the same on a second call
        label = f"[{PROBE_CHECK_M} x {k}] @ [{k} x {n}]"
        a, b, bt = bg.operands(PROBE_CHECK_M, k, n, "cuda")
        outs = (gp.gemm_probe(a, b), gp.gemm_probe_t(a, bt))
        agains = (gp.gemm_probe(a, b), gp.gemm_probe_t(a, bt))
        wants = (gp.gemm_probe_plain(a, b), gp.gemm_probe_t_plain(a, bt))
        torch.cuda.synchronize()
        for name, got, again, want in zip(("gemm_probe", "gemm_probe_t"), outs, agains, wants):
            worst[name] = max(worst[name], compare(name, label, got, want))
            check(torch.equal(got, again), f"{name} {label}: differs from run to run")
        del a, b, bt, outs, agains, wants

    # P2 at the tool's ten cases, then at the window path's edges, each twice
    p2_cases = [(*case, PROBE_CHECK_REPS) for case in bms.CASES] + list(P2_EDGE_CASES)
    for m_block, k, n, grid, reps in p2_cases:
        label = f"({m_block}, {k}, {n}, {grid}) R = {reps}"
        a, b = bms.operands(m_block, k, n, grid, "cuda")
        out, again = gp.mma_probe(a, b, reps), gp.mma_probe(a, b, reps)
        want = gp.mma_probe_plain(a, b, reps)
        torch.cuda.synchronize()
        check(out.shape == (m_block, n), f"mma_probe {label}: shape {tuple(out.shape)}")
        worst["mma_probe"] = max(worst["mma_probe"], compare("mma_probe", label, out, want))
        check(torch.equal(out, again), f"mma_probe {label}: differs from run to run")
        if (m_block, k, n, grid, reps) == (2048, 1296, 48, 16, PROBE_CHECK_REPS):
            # all 27 taps folded: times at the tool's R
            rows["mma_probe"] = timed_row(
                "mma_probe", f"({m_block}, {k}, {n}, {grid}) R = {bms.R}",
                lambda: gp.mma_probe(a, b, bms.R), lambda: gp.mma_probe_plain(a, b, bms.R),
                *mma_probe_work(m_block, k, n, grid, bms.R))
        del a, b, out, again, want
    torch.cuda.empty_cache()

    # the tools, in full
    launches = {}
    reset_counts()
    for k, n in bg.SHAPES:
        bg.bench_shape(k, n, device="cuda")
    launches["bench_gemm"] = read_counts()
    torch.cuda.empty_cache()
    reset_counts()
    for case in bms.CASES:
        tflops, ms = bms.probe(*case, device="cuda")
        say("gemm probes", f"bench_mma_shapes {case}: {tflops:.1f} TF/s, {ms:.3f} ms at R = {bms.R}")
        # the max is idempotent: a kernel that skipped products would give the same
        # output, so the rate of the products is the check
        check(tflops <= PEAK_BF16_FLOP_PER_S / 1e12,
              f"mma_probe {case}: slope rate {tflops:.1f} TF/s above the card's peak")
    launches["bench_mma_shapes"] = read_counts()
    say("gemm probes", f"launches {launches}")
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# Sampling (the first slice's main path)
# ---------------------------------------------------------------------------
def seeded_model(cfg, seed: int = 0) -> UNet:
    model = build_model(cfg, device="cuda").eval()
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(seed))
    return model


def reference_check(label, model, cfg, side: int, expected: dict, f32_card: bool = False,
                    phase: str = "sampling") -> None:
    """A forward on the card (bf16, kernels) against the same weights in f32 on
    the CPU; with ``f32_card``, also the model at ``dtype="float32"`` on the card,
    whose kernels must take f32 operands."""
    expected = {name: expected.get(name, 0) for name in KERNELS}
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
    cpu = build_model(f32, device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, side, side, side, cfg.data.embedding_dim, generator=gen)
    # a conditional model also takes the observations of a synthetic volume
    cond = (observations(gen, cfg, side)[None],) if cfg.model.conditional else ()
    t = torch.full((1,), 0.5)  # exact in bf16, which the model casts time to
    reset_counts()
    with torch.inference_mode():
        ref = cpu(x, *cond, t)
        got = model(x.cuda().bfloat16(), *(a.cuda() for a in cond), t.cuda()).cpu()
    launches = read_counts()
    rel = rel_l2(got, ref)
    say(phase, f"{label} {side}³ b1 forward on the card (bf16, kernels launched {launches}) "
        f"vs f32 on the CPU: relative L2 error {rel:.3e} (tolerance {FORWARD_REL_TOL:g})")
    check(bool(torch.isfinite(got).all()), f"non-finite {label} {side}³ forward")
    check(launches == expected, f"{label} {side}³ forward launches {launches}, expected {expected}")
    check(rel < FORWARD_REL_TOL, f"{label} {side}³ forward relative error {rel:.3e}")
    if not f32_card:
        return
    card = build_model(f32, device="cuda").eval()
    card.load_state_dict(model.state_dict())
    reset_counts()
    with operand_dtypes() as dtypes, torch.inference_mode():
        got = card(x.cuda(), *(a.cuda() for a in cond), t.cuda()).cpu()
    launches = read_counts()
    rel = rel_l2(got, ref)
    say(phase, f"{label} {side}³ b1 forward on the card at dtype=float32 (kernels launched "
        f"{launches}, operand dtypes {dtypes}) vs f32 on the CPU: relative L2 error {rel:.3e} "
        f"(tolerance {F32_FORWARD_REL_TOL:g})")
    check(bool(torch.isfinite(got).all()), f"non-finite f32 {label} {side}³ forward")
    check(launches == expected, f"f32 {label} {side}³ forward launches {launches}")
    check(all(dtypes.get(name) == {torch.float32} for name in expected if expected[name]),
          f"f32 {label} {side}³ forward: kernel operand dtypes {dtypes}")
    check(rel < F32_FORWARD_REL_TOL, f"f32 {label} {side}³ forward relative error {rel:.3e}")


def sample(label, model, cfg, n_frames: int, per_evaluation: dict) -> dict:
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim))
    kwargs = dict(n_samples=2, batch_size=2, data_shape=(64, 64, 64),
                  embedding_dim=cfg.data.embedding_dim, seed=0, device="cuda",
                  state_dtype=torch.bfloat16, verbose=False, t0=cfg.inference.t0,
                  tf=cfg.inference.tf, n_frames=n_frames, substeps=1, method="rk4",
                  keep_trajectory=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = sample_unconditional(model, table, **kwargs)
    launches = read_counts()
    nfe = result.nfe
    seconds = result.seconds_per_batch[0]
    say("sampling", f"{label}: sample_unconditional 64³ b2 rk4 n_frames={n_frames} substeps=1: "
        f"nfe {nfe}, {seconds:.3f} s, {seconds / nfe * 1e3:.1f} ms per evaluation (first call, "
        f"cuDNN set-up included), launches {launches}, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(nfe == (n_frames - 1) * 4, f"{label}: {nfe} velocity evaluations")
    for name in KERNELS:
        want = per_evaluation.get(name, 0) * nfe
        check(launches[name] == want,
              f"{label}: {name} launched {launches[name]} times, expected {want}")
    check(result.decoded.shape == (2, 64, 64, 64), f"{label}: decoded shape {result.decoded.shape}")
    final = result.trajectory[-1]
    check(final.shape == (2, 64, 64, 64, 18), f"{label}: final state shape {final.shape}")
    check(bool(np.isfinite(final).all()), f"{label}: non-finite final state")
    counts = [int((result.decoded == c).sum()) for c in range(cfg.data.num_categories)]
    say("sampling", f"{label}: decoded [2, 64, 64, 64], finite final state (|x| max "
        f"{float(np.abs(final).max()):.3f}); category counts {counts}")
    return launches


def phase_sampling():
    cfg = unconditional_64()
    model = seeded_model(cfg)
    launches = {"sampling flagship": sample(
        "flagship", model, cfg, 3, {"folded_context": 6, "folded_project": 6})}
    reference_check("flagship", model, cfg, 16, {"folded_context": 2, "folded_project": 2,
                                                 "flash_attention": 0})

    fa16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, full_attn=FA16))
    fa16_model = seeded_model(fa16)
    launches["sampling fa16"] = sample("fa16", fa16_model, fa16, 2, {
        "flash_attention": 2, "folded_context": 4, "folded_project": 4})
    reference_check("fa16", fa16_model, fa16, 64, {"folded_context": 4, "folded_project": 4,
                                                   "flash_attention": 2}, f32_card=True)
    del fa16_model
    torch.cuda.empty_cache()
    return model, launches


def profile_table(phase: str, fn, label: str, wall_ms: float, record_shapes: bool = False):
    """Print the top kernels of one call of ``fn`` by device time; return the
    profile and its total kernel time in µs (0 where none was recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        say(phase, "profiler: no device time recorded (not measured)")
        return prof, 0.0
    say(phase, f"profiler: {label}, {total / 1e3:.2f} ms of kernel time in "
        f"{sum(e.count for e in kernels)} launches (unprofiled wall time {wall_ms:.1f} ms); "
        f"top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / total:5.1f}%"
              f"  x{e.count:<5d} {e.key[:100]}", flush=True)
    return prof, total


def phase_forward(model):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(BATCH, 64, 64, 64, 18, generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.full((BATCH,), 0.5, device="cuda")
    times = []
    with torch.inference_mode():
        for i in range(4):
            torch.cuda.synchronize()
            start = time.perf_counter()
            y = model(x, t)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - start) * 1e3)
    check(bool(torch.isfinite(y).all()), "non-finite b8 forward")
    fwd_ms = statistics.median(times)
    say("forward", f"UNet b{BATCH} x 64³ bf16: {', '.join(f'{t:.1f}' for t in times)} ms, "
        f"median {fwd_ms:.1f} ms")
    with torch.inference_mode():
        profile_table("forward", lambda: model(x, t), f"one b{BATCH} forward", fwd_ms)


# ---------------------------------------------------------------------------
# The conditional model (the tenth slice's main paths)
# ---------------------------------------------------------------------------
def observations(gen: torch.Generator, cfg, side: int) -> torch.Tensor:
    """ATb ``[side³, E]`` on the generator's device: ``build_atb`` of a synthetic
    categorical volume under the port's combined borehole and surface mask."""
    true = synthetic_geology_batch(gen, 1, (side, side, side))
    mask = make_combined_mask(gen, true)
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim))
    return build_atb(true[0], mask[0], table)


def tower_share(prof, total_us: float, data_channels: int) -> None:
    """The convolutions of one profiled forward by weight and input shape, with
    their rates, and the ATb towers' share of the kernel time: their 5³ convs,
    the 7³ conv at data width (``init_conv_ATb``) and the resizes of the opened
    ATb (inputs of ``data_channels`` channels)."""
    rows, tower = [], 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in ("aten::conv3d", "aten::upsample_trilinear3d") or not e.input_shapes:
            continue
        x = e.input_shapes[0]
        if e.key == "aten::conv3d":
            w = e.input_shapes[1]
            is_tower = w[2] == 5 or (w[2] == 7 and w[0] == data_channels)
            # SAME convs: 2 operations per weight per output voxel
            ops = 2.0 * e.count * float(np.prod(x[:1] + x[2:])) * float(np.prod(w))
            label = (f"conv {w[2]}³ {w[1]}->{w[0]} at {x[2]}³ b{x[0]}, "
                     f"{ops / (e.device_time_total * 1e-6) / 1e12:.1f} TF/s")
        else:
            is_tower = x[1] == data_channels
            label = f"resize of {x[1]} channels from {x[2]}³ b{x[0]}"
        rows.append((e.device_time_total, e.count, label + (" (tower)" if is_tower else "")))
        tower += e.device_time_total if is_tower else 0.0
    say("conditional", f"profiler: convolutions and resizes by shape, device time (of "
        f"{total_us / 1e3:.2f} ms of kernel time):")
    for us, count, label in sorted(rows, reverse=True)[:16]:
        print(f"    {us / 1e3:9.3f} ms {100 * us / total_us:5.1f}%  x{count:<3d} {label}", flush=True)
    say("conditional", f"profiler: the ATb towers (5³ convs, the 7³ conv at data width, "
        f"their resizes): {tower / 1e3:.3f} ms, {100 * tower / total_us:.1f}% of the forward's "
        f"kernel time")


def phase_conditional() -> dict:
    """``conditional_64`` at full width, seeded random weights, bf16: the 16³
    reference forward, ``sample_conditional`` and the ensemble maps, the ATb
    towers' cost per evaluation, a profile of one b4 forward, and training."""
    cfg = conditional_64()
    model = seeded_model(cfg)
    per_eval = {"folded_context": 6, "folded_project": 6}
    reference_check("conditional v3", model, cfg, 16,
                    {"folded_context": 2, "folded_project": 2}, phase="conditional")

    e = cfg.data.embedding_dim
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, e))
    gen = torch.Generator(device="cuda").manual_seed(3)
    atb = observations(gen, cfg, COND_SIDE)
    observed = float((atb != 0).any(dim=-1).float().mean())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = sample_conditional(
        model, table, atb, n_samples=COND_SAMPLES, batch_size=COND_BATCH, seed=0, device="cuda",
        state_dtype=torch.bfloat16, verbose=False, t0=cfg.inference.t0, tf=cfg.inference.tf,
        n_frames=COND_FRAMES, substeps=1, method="rk4", keep_trajectory=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    nfe, seconds = result.nfe, result.seconds_per_batch
    n_batches = len(seconds)
    say("conditional", f"sample_conditional {COND_SIDE}³, {n_batches} batches of {COND_BATCH}, rk4 "
        f"n_frames={COND_FRAMES} substeps=1, ATb observed on {100 * observed:.1f}% of voxels: nfe "
        f"{nfe} a batch, {', '.join(f'{x:.3f}' for x in seconds)} s per batch (the first with "
        f"cuDNN's set-up), {seconds[-1] / nfe * 1e3:.1f} ms per evaluation in the last; launches "
        f"{launches}; max_memory_allocated {peak:.2f} GiB")
    check(nfe == (COND_FRAMES - 1) * 4, f"conditional: {nfe} velocity evaluations")
    for name in KERNELS:
        want = per_eval.get(name, 0) * nfe * n_batches
        check(launches[name] == want,
              f"conditional sampling: {name} launched {launches[name]} times, expected {want}")
    final = result.trajectory[-1]
    check(result.decoded.shape == (COND_SAMPLES, *[COND_SIDE] * 3),
          f"conditional: decoded shape {result.decoded.shape}")
    check(final.shape == (COND_SAMPLES, *[COND_SIDE] * 3, e), f"conditional: final state {final.shape}")
    check(bool(np.isfinite(final).all()), "conditional: non-finite final state")

    # the ensemble maps of the decoded batch (GeoGen's convention: air = -1)
    solutions = torch.from_numpy(result.decoded).cuda() - 1
    probs = ensemble.vote_probabilities(solutions, cfg.data.num_categories)
    ent = ensemble.entropy(probs)
    masked = ensemble.air_masked_entropy(probs)
    likely = ensemble.most_probable_model(probs)
    dikes = ensemble.category_probability(probs, DIKE_CATEGORY)
    check(probs.shape == (*[COND_SIDE] * 3, cfg.data.num_categories)
          and bool(torch.allclose(probs.sum(-1), torch.ones((), device="cuda"), atol=1e-6)),
          f"conditional: vote probabilities {tuple(probs.shape)} do not sum to 1")
    check(bool(((ent >= 0) & (ent <= np.log(COND_SAMPLES) + 1e-5) & (masked <= ent)).all()),
          "conditional: entropy outside [0, log S] or the air-masked one above it")
    check(bool(((likely >= -1) & (likely <= cfg.data.num_categories - 2)).all())
          and bool(((dikes >= 0) & (dikes <= 1)).all()), "conditional: ensemble maps out of range")
    say("conditional", f"ensemble of {COND_SAMPLES}: mean entropy {float(ent.mean()):.4f} "
        f"(air-masked {float(masked.mean()):.4f}), most probable model in "
        f"[{int(likely.min())}, {int(likely.max())}], mean dike probability "
        f"{float(dikes.mean()):.4f}")

    # the towers see only ATb: their cost is the same at every evaluation
    x = initial_noise(gen, COND_BATCH, (COND_SIDE,) * 3, e, torch.bfloat16, torch.device("cuda"))
    atb_b = atb[None].expand(COND_BATCH, *atb.shape)
    t = torch.full((COND_BATCH,), 0.5, device="cuda")
    embeds = [m for name, m in model.named_children() if name.endswith("_atb_embed")]

    def towers():
        opened = model.init_conv_ATb(atb_b)
        return [m(opened) for m in embeds]

    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(x, atb_b, t), reps=3, rounds=3, warmup=1)
        tower_ms = time_ms(towers, reps=3, rounds=3, warmup=1)
        say("conditional", f"b{COND_BATCH} {COND_SIDE}³ forward {forward_ms:.2f} ms; the ATb towers alone "
            f"(init_conv_ATb and {len(embeds)} EmbedATb) {tower_ms:.2f} ms, "
            f"{100 * tower_ms / forward_ms:.1f}% of a velocity evaluation")
        prof, total = profile_table("conditional", lambda: model(x, atb_b, t),
                                    f"one b{COND_BATCH} {COND_SIDE}³ conditional forward", forward_ms,
                                    record_shapes=True)
    if total > 0:
        tower_share(prof, total, e)
    del model, x, atb_b, result, solutions, probs
    torch.cuda.empty_cache()

    train_cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=COND_MICRO_BATCH),
        training=dataclasses.replace(cfg.training, accumulate_grad_batches=COND_ACCUM))
    trained = train("conditional", train_cfg, per_eval, steps=COND_STEPS)
    check(set(trained["losses"]) == {"train_loss", "flow_loss", "reconstruct_loss"},
          f"conditional: loss metrics {sorted(trained['losses'])}")
    return {"sampling conditional": launches, "train conditional": trained["launches"]}


# ---------------------------------------------------------------------------
# The v1 linear-attention path (the third slice's main path)
# ---------------------------------------------------------------------------
def linear_attention_widths(model: UNet):
    """(dim, heads, dim_head) of the flagship's first LinearAttention (the 64³
    stage; the 32³ stage has the same widths)."""
    attn = next(m for m in model.modules() if isinstance(m, LinearAttention))
    return attn.to_out.weight.shape[0], attn.heads, attn.dim_head


def phase_v1(widths) -> dict:
    """``LinearAttention(fused=True, fused_folded=False)`` in bf16 at the flagship's
    widths: 64³ b8 forward, 64³ b4 forward and backward, 32³ b8 forward, each
    held against the same weights through the folded kernels (K1 + K2)."""
    dim, heads, dim_head = widths
    check(widths == (V1_DIM, HEADS, HEAD_DIM), f"flagship LinearAttention widths {widths}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    v1 = LinearAttention(dim, heads, dim_head, fused=True, fused_folded=False,
                         dtype=torch.bfloat16, device="cuda")
    seed_module(v1, gen)
    folded = LinearAttention(dim, heads, dim_head, dtype=torch.bfloat16, device="cuda")
    folded.load_state_dict(v1.state_dict())
    launches = {}
    for batch, side, backward in V1_CASES:
        label = f"v1 {side}³ b{batch} {'forward+backward' if backward else 'forward'}"
        x = torch.randn(batch, side, side, side, dim, generator=gen, device="cuda")
        x = x.to(torch.bfloat16)
        dout = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)

        def call(module):
            if not backward:
                with torch.inference_mode():
                    return module(x), None
            xg = x.detach().requires_grad_()
            out = module(xg)
            out.backward(dout)
            return out.detach(), xg.grad

        def timed(module):
            """1 warm-up and 5 timed calls: (last result, times in ms)."""
            call(module)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                start = time.perf_counter()
                result = call(module)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
            return result, times

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (out, grad), times = timed(v1)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[label] = counts
        ms = statistics.median(times)
        say("v1", f"{label}: {', '.join(f'{t:.2f}' for t in times)} ms, median {ms:.2f} ms per "
            f"call; peak {peak:.2f} GiB allocated; launches in 6 calls {counts}")
        per = {name: counts[name] / 6 for name in KERNELS}
        want = {name: 1 if name in ("linear_context", "linear_project") else 0
                for name in KERNELS}
        check(per == want, f"{label}: launches per call {per}, expected {want}")
        check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
        (ref, ref_grad), folded_times = timed(folded)
        rel = rel_l2(out, ref)
        msg = f"{label}: against the folded kernels (K1 + K2; median " \
              f"{statistics.median(folded_times):.2f} ms per call): output relative L2 {rel:.3e} " \
              f"(limit {V1_FOLDED_REL_TOL:g})"
        check(rel <= V1_FOLDED_REL_TOL, msg)
        if backward:
            check(bool(torch.isfinite(grad).all()), f"{label}: non-finite input gradient")
            grad_rel = rel_l2(grad, ref_grad)
            msg += f", input gradient {grad_rel:.3e} (limit {V1_FOLDED_GRAD_REL_TOL:g})"
            check(grad_rel <= V1_FOLDED_GRAD_REL_TOL, msg)
        say("v1", msg)
        if (batch, side, backward) == V1_CASES[0]:  # where the block's time goes, beside the folded one
            with torch.inference_mode():
                for name, module, wall in (("v1", v1, times), ("folded", folded, folded_times)):
                    profile_table("v1", lambda: module(x), f"one {name} {side}³ b{batch} forward",
                                  statistics.median(wall))
        del x, dout, out, grad, ref, ref_grad
    del v1, folded
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Training (this slice's main path)
# ---------------------------------------------------------------------------
def sampler_after_training(label: str, model, state, cfg, gen) -> None:
    """Two sampler calls on the model the train steps left in training mode, from
    the same x0, agree exactly: the sampler runs the model in eval mode (no
    dropout) and hands it back in training mode."""
    check(model.training, f"{label}: the train step left the model in eval mode")
    sampler = make_sampler(model, state.constants["embedding"], t0=cfg.inference.t0,
                           tf=cfg.inference.tf, n_frames=3, substeps=1, method="euler",
                           keep_trajectory=True)
    x0 = initial_noise(gen, 1, cfg.data.shape, cfg.data.embedding_dim, torch.bfloat16,
                       torch.device("cuda"))
    first, second = sampler(x0), sampler(x0)
    same = (torch.equal(first["trajectory"], second["trajectory"])
            and torch.equal(first["decoded"], second["decoded"]))
    gap = (first["trajectory"].float() - second["trajectory"].float()).abs().max().item()
    say("train", f"{label}: two euler samplers (64³ b1, 2 evaluations) from the same x0 after "
        f"training: identical {same} (max abs difference {gap:.3e}); model.training after "
        f"{model.training}")
    check(same, f"{label}: two samples from the same x0 differ by up to {gap:.3e}")
    check(model.training, f"{label}: the sampler did not hand the model back in training mode")


def flagship_train_config(full_attn):
    """``unconditional_64`` with ``full_attn`` at micro-batch 4 x accumulation 2."""
    cfg = unconditional_64()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, full_attn=full_attn),
        data=dataclasses.replace(cfg.data, batch_size=TRAIN_MICRO_BATCH),
        training=dataclasses.replace(cfg.training, accumulate_grad_batches=TRAIN_ACCUM),
    )


def train(label: str, cfg, per_step: dict, steps: int = TRAIN_STEPS, profile: bool = False,
          check_sampler: bool = False) -> dict:
    """``TRAIN_WARMUP`` + ``steps`` micro-steps of ``cfg``'s loss at its
    ``data.batch_size`` x ``training.accumulate_grad_batches``."""
    micro_batch, accum = cfg.data.batch_size, cfg.training.accumulate_grad_batches
    model, tx, state = init_train_state(cfg)
    step = make_train_step(model, tx, cfg)
    gen = torch.Generator(device="cuda").manual_seed(10)
    n_steps = TRAIN_WARMUP + steps
    batches = [synthetic_geology_batch(gen, micro_batch, cfg.data.shape)
               for _ in range(n_steps + 1)]
    check(all(int(b.min()) == -1 and int(b.max()) <= cfg.data.num_categories - 2
              for b in batches), f"{label}: synthetic batches outside [-1, n - 2]")
    params = list(state.params.values())
    snapshot = [torch.empty_like(p) for p in params]
    times, changed, norms = [], [], []
    losses = {}  # the loss and, for the conditional loss, its two parts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(n_steps):
        torch._foreach_copy_(snapshot, [p.detach() for p in params])
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = step(state, batches[i], gen)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            times.append((time.perf_counter() - start) * 1e3)
        changed.append(any(not torch.equal(a, p) for a, p in zip(snapshot, params)))
        for name, value in metrics.items():
            if name != "grad_norm":
                losses.setdefault(name, []).append(float(value))
        norms.append(float(metrics["grad_norm"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(times)
    say("train", f"{label} {cfg.data.shape[0]}³ micro-batch {micro_batch} x accumulation {accum}: "
        f"{n_steps} micro-steps ({TRAIN_WARMUP} warm-up): {', '.join(f'{t:.1f}' for t in times)} "
        f"ms, median {median:.1f} ms per micro-step; peak {peak:.2f} GiB allocated")
    for name, values in losses.items():
        say("train", f"{label}: {name} {', '.join(f'{x:.4f}' for x in values)}")
    say("train", f"{label}: grad_norm {', '.join(f'{x:.4f}' for x in norms)}")
    per = {k: v / n_steps for k, v in launches.items()}
    say("train", f"{label}: launches {launches} in {n_steps} micro-steps, {per} per micro-step; "
        f"params changed at micro-steps {[i for i, c in enumerate(changed) if c]} "
        f"(accumulation boundaries every {accum})")
    check(all(np.isfinite(v).all() for v in losses.values()) and all(np.isfinite(norms)),
          f"{label}: non-finite loss, loss part or gradient norm")
    check(changed == [i % accum == accum - 1 for i in range(n_steps)],
          f"{label}: params changed at {changed}")
    check(state.step == n_steps and state.opt_state.updates == n_steps // accum,
          f"{label}: {state.step} micro-steps, {state.opt_state.updates} updates")
    for name in KERNELS:
        check(per[name] == per_step.get(name, 0),
              f"{label}: {name} launched {per[name]} times per micro-step, "
              f"expected {per_step.get(name, 0)}")
    if profile:
        profile_table("train", lambda: step(state, batches[-1], gen),
                      f"one {label} micro-step", median)
    if check_sampler:
        sampler_after_training(label, model, state, cfg, gen)
    del model, tx, state, step, batches, snapshot
    torch.cuda.empty_cache()
    return dict(ms=median, peak_gib=peak, launches=launches, losses=losses)


# ---------------------------------------------------------------------------
# The unconditional app on the trained release weights (the eleventh slice)
# ---------------------------------------------------------------------------
def count_leaves(tree) -> tuple:
    """(leaves, values, every leaf bf16) of a nested dict tree."""
    leaves = list(_tree_leaves(tree))
    return (len(leaves), sum(int(np.prod(v.shape)) for v in leaves),
            all(isinstance(v, Bfloat16) for v in leaves))


def _tree_leaves(tree):
    for value in tree.values():
        if isinstance(value, dict):
            yield from _tree_leaves(value)
        else:
            yield value


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(a.double() @ b.double() / (a.double().norm() * b.double().norm()))


def first_update(smi: str) -> dict:
    """One update of the flagship recipe (64³ b1, accumulation 1, no dropout)
    through ``make_train_step`` from the same seeded weights and the same draws
    (t = 0.5, exact in bf16): the card (bf16, K1 and K2) against the CPU (f32).
    The loss before and after it (``make_eval_loss`` on the same draws), the
    gradient norm, the gradients' direction (Adam's first moment) and the
    update's direction must agree. Returns the card's launches."""
    base = unconditional_64()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, dropout=0.0),
        data=dataclasses.replace(base.data, batch_size=1),
        training=dataclasses.replace(base.training, accumulate_grad_batches=1))
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
    gen = torch.Generator().manual_seed(7)
    batch = synthetic_geology_batch(gen, 1, cfg.data.shape)
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim))
    _, x1, x0, _ = objectives._draw_common(gen, batch, table, cfg.training.time_range,
                                           cfg.training.x1_noise)
    draws = (x1, x0, torch.full((1,), 0.5))
    out, weights = {}, None
    for side, device, c in (("card", "cuda", cfg), ("cpu", "cpu", f32)):
        model, tx, state = init_train_state(c, device=device)
        if weights is None:
            weights = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        before = [p.detach().clone() for p in state.params.values()]
        on = tuple(a.to(device) for a in draws)
        start = time.perf_counter()
        reset_counts()
        with mock.patch.object(objectives, "_draw_common", lambda *a: (None, *on)):
            state, metrics = make_train_step(model, tx, c)(state, batch.to(device),
                                                           torch.Generator(device=device))
            after = make_eval_loss(model, c)(state, batch.to(device),
                                             torch.Generator(device=device))
        out[side] = dict(
            launches=read_counts(), seconds=time.perf_counter() - start,
            loss=float(metrics["train_loss"]), after=float(after["train_loss"]),
            grad_norm=float(metrics["grad_norm"]),
            mu=torch.cat([m.reshape(-1).float().cpu() for m in state.opt_state.mu]),
            step=torch.cat([(p.detach() - b).reshape(-1).float().cpu()
                            for p, b in zip(state.params.values(), before)]))
        check(state.opt_state.updates == 1, f"first update ({side}): no update")
        del model, tx, state
    torch.cuda.empty_cache()
    card, cpu = out["card"], out["cpu"]
    grad_cos, step_cos = cosine(card["mu"], cpu["mu"]), cosine(card["step"], cpu["step"])
    rel = {key: abs(card[key] - cpu[key]) / abs(cpu[key]) for key in ("loss", "after", "grad_norm")}
    flipped = float((card["step"] * cpu["step"] < 0).float().mean())
    say("app", f"first update of the recipe (64³ b1, accumulation 1, no dropout, lr "
        f"{cfg.training.learning_rate:g}), card bf16 ({card['seconds']:.1f} s, launches "
        f"{card['launches']}) against CPU f32 ({cpu['seconds']:.1f} s): loss {card['loss']:.4f} "
        f"-> {card['after']:.4f} on the card, {cpu['loss']:.4f} -> {cpu['after']:.4f} on the CPU "
        f"(relative differences {rel['loss']:.2e} before, {rel['after']:.2e} after); grad_norm "
        f"{card['grad_norm']:.4f} against {cpu['grad_norm']:.4f}; cosine of the gradients "
        f"{grad_cos:.6f}, of the updates {step_cos:.6f} ({flipped:.2e} of the weights stepped "
        f"the other way); mean |update| {float(card['step'].abs().mean()):.3e} against "
        f"{float(cpu['step'].abs().mean()):.3e}; {smi}")
    check(all(np.isfinite([card[k], cpu[k]]).all() for k in ("loss", "after", "grad_norm")),
          "first update: non-finite loss or gradient norm")
    check(card["launches"] == {name: (12 if name in ("folded_context", "folded_project") else 0)
                               for name in KERNELS},
          f"first update: card launches {card['launches']}")
    check(rel["loss"] < UPDATE_LOSS_REL_TOL and rel["grad_norm"] < UPDATE_LOSS_REL_TOL,
          f"first update: loss or gradient norm off by {rel}")
    check(grad_cos > UPDATE_GRAD_COSINE, f"first update: gradient cosine {grad_cos:.6f}")
    check(step_cos > UPDATE_STEP_COSINE, f"first update: update cosine {step_cos:.6f}")
    check(rel["after"] < UPDATE_AFTER_REL_TOL
          and (card["after"] > card["loss"]) == (cpu["after"] > cpu["loss"]),
          f"first update: the loss after it differs: card {card['loss']:.4f} -> "
          f"{card['after']:.4f}, CPU {cpu['loss']:.4f} -> {cpu['after']:.4f}")
    return card["launches"]


def run_app(argv: list, main=app.main) -> tuple:
    """``main(argv)`` (the unconditional app's by default) in this process, its
    standard output captured and echoed: ``(result, output)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"    | {line}", flush=True)
    return result, out


def phase_app(smi: str) -> dict:
    """The trained release weights, read by the port's msgpack reader; their
    forward on the card against the CPU; their eval loss against random
    weights'; the app's inference at the flagship preset from them; and the
    app's training twice on one root directory, the second run resuming."""
    weights = RELEASE_DIR / "weights.msgpack"
    check(weights.is_file(), f"app: {weights} is missing (the release weights must reach the card)")
    data = weights.read_bytes()
    start = time.perf_counter()
    tree, config, meta = load_release_weights(str(RELEASE_DIR), cast_to=None)
    read_s = time.perf_counter() - start
    leaves, values, all_bf16 = count_leaves(tree["params"])
    say("app", f"{weights.relative_to(RELEASE_DIR.parents[2])}: {len(data)} bytes, sha256 "
        f"{hashlib.sha256(data).hexdigest()}; read in {read_s:.3f} s by the port's reader: "
        f"{leaves} leaves, {values} values, all bf16 {all_bf16}; ema_params "
        f"{tree['ema_params']!r}, constants {tree['constants']!r}; meta {meta}")
    cfg = unconditional_64()
    check((leaves, values, all_bf16) == (RELEASE_LEAVES, RELEASE_VALUES, True),
          f"app: release params {leaves} leaves, {values} values, all bf16 {all_bf16}")
    check(tree["ema_params"] == {} and tree["constants"] == {},
          "app: the release has EMA params or constants")
    check(config is not None and config.model == cfg.model,
          "app: the release's config.json is not the flagship model's")

    # the trained forward on the card (bf16, K1 and K2) against f32 on the CPU
    model = build_model(cfg, device="cuda").eval()
    model.load_state_dict(state_dict_from_release(tree, model))
    reference_check("trained flagship", model, cfg, 16,
                    {"folded_context": 2, "folded_project": 2}, phase="app")
    reference_check("trained flagship", model, cfg, 64,
                    {"folded_context": 6, "folded_project": 6}, phase="app")

    # eval loss: the trained weights against seeded random ones, same volumes and draws
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = synthetic_geology_batch(gen, EVAL_BATCH, cfg.data.shape)
    random_model, _, state = init_train_state(cfg)
    losses = {}
    for label in ("random", "trained"):
        if label == "trained":
            random_model.load_state_dict(model.state_dict())
        metrics = make_eval_loss(random_model, cfg)(
            state, batch, torch.Generator(device="cuda").manual_seed(5))
        losses[label] = float(metrics["train_loss"])
    say("app", f"eval loss (unconditional_loss, {EVAL_BATCH} synthetic 64³ volumes, the same "
        f"draws): trained {losses['trained']:.4f}, random {losses['random']:.4f}, ratio "
        f"{losses['trained'] / losses['random']:.4f} (must be under {TRAINED_LOSS_SHARE}); {smi}")
    check(np.isfinite(list(losses.values())).all(), f"app: non-finite eval loss {losses}")
    check(losses["trained"] < TRAINED_LOSS_SHARE * losses["random"],
          f"app: trained eval loss {losses['trained']:.4f} not under a tenth of random "
          f"{losses['random']:.4f}")
    del model, random_model, state, batch
    torch.cuda.empty_cache()

    launches = {"app first update": first_update(smi)}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_app-", dir=RELEASE_DIR.parents[2]) as root:
        # inference from the release weights, as a user runs it
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result, out = run_app([
            "--preset", "flagship", "--mode", "inference", "--checkpoint-path", str(RELEASE_DIR),
            "--n-samples", str(APP_SAMPLES), "--batch-size", str(APP_SAMPLES), "--seed", "100",
            "--no-save-images", "--root-dir", root])
        launches["app inference"] = counts = read_counts()
        sampled = result["inference"]
        nfe = sampled.nfe
        seconds = sum(sampled.seconds_per_batch)
        samples_dir = Path(root) / "samples" / cfg.name
        files = sorted(samples_dir.glob("decoded_s100_*.npy"))
        vols = [np.load(f) for f in files]
        check(f"loaded release weights step {meta.get('step')}" in out,
              "app: inference did not load the release weights")
        check(len(vols) == APP_SAMPLES and all(v.shape == (64, 64, 64) and v.dtype == np.int8
                                              for v in vols),
              f"app: decoded files {[f.name for f in files]}")
        cats = np.stack(vols)
        check(int(cats.min()) >= -1 and int(cats.max()) <= cfg.data.num_categories - 2,
              f"app: categories in [{cats.min()}, {cats.max()}]")
        want = 6 * nfe
        check(nfe == 120 and all(counts[name] == (want if name in ("folded_context",
                                                                     "folded_project") else 0)
                                 for name in KERNELS),
              f"app inference: nfe {nfe}, launches {counts}")
        fractions = np.bincount(cats.ravel() + 1, minlength=cfg.data.num_categories) / cats.size
        prom = sampled.prominence
        check(prom is not None and prom.shape == (APP_SAMPLES, 64, 64, 64)
              and bool(np.isfinite(prom).all()) and float(prom.min()) >= 0.0
              and float(prom.max()) <= 1.0, "app: prominence missing or outside [0, 1]")
        say("app", f"inference: {APP_SAMPLES} samples at 64³ b{APP_SAMPLES}, rk4 16 frames x 2 "
            f"substeps, nfe {nfe}: {seconds:.3f} s, {APP_SAMPLES / seconds * 60:.2f} samples/min "
            f"(one batch, cuDNN's set-up included), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}; {smi}")
        say("app", f"inference: category fractions (air = -1 first) "
            f"{[round(float(f), 4) for f in fractions]}; mean prominence {float(prom.mean()):.4f}")
        torch.cuda.empty_cache()

        # training twice on one root directory: the second run resumes
        flagship = unconditional_64()
        init_params = {k: v.detach().clone() for k, v in
                       init_model_variables(flagship, device="cuda").named_parameters()}
        runs = []
        for i, smoke in enumerate((False, True)):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            result, out = run_app([
                "--preset", "flagship", "--mode", "train", "--steps", str(APP_STEPS),
                "--no-save-images", "--root-dir", root]
                + ([] if smoke else ["--no-pretrain-smoke"]))
            counts = read_counts()
            launches[f"app train {i + 1}"] = counts
            trained = result["train"]
            peak = torch.cuda.max_memory_allocated() / 2**30
            smoke_evals = SMOKE_EVALUATIONS if smoke else 0
            per_step = {name: (n - 6 * smoke_evals * (name in ("folded_context",
                                                                "folded_project"))) / APP_STEPS
                        for name, n in counts.items()}
            state = trained.state
            runs.append({k: v.detach().clone() for k, v in state.params.items()})
            say("app", f"train run {i + 1} (pretrain smoke {smoke}): steps {state.step - APP_STEPS * i}"
                f" -> {state.step}, {trained.steps_per_sec:.3f} micro-steps/s after the first "
                f"({trained.steps_per_sec_with_compile:.3f} with it) at b{flagship.data.batch_size} "
                f"x accumulation {flagship.training.accumulate_grad_batches}, peak {peak:.2f} GiB; "
                f"launches {counts}, per micro-step {per_step}; losses "
                f"{[round(h['train_loss'], 4) for h in trained.history]}; {smi}")
            check(state.step == APP_STEPS * (i + 1) and state.opt_state.updates == i + 1,
                  f"app train run {i + 1}: step {state.step}, updates {state.opt_state.updates}")
            check((f"[train] resumed from step {APP_STEPS}" in out) == (i == 1),
                  f"app train run {i + 1}: resume message {'missing' if i else 'unexpected'}")
            check(all(per_step[name] == (6 if name in ("folded_context", "folded_project") else 0)
                      for name in KERNELS), f"app train run {i + 1}: launches {counts}")
            check(all(np.isfinite([h["train_loss"], h["grad_norm"]]).all()
                      for h in trained.history), f"app train run {i + 1}: non-finite metrics")
            check(("[InferenceCallback] pretrain" in out) == smoke,
                  f"app train run {i + 1}: pretrain smoke ran {not smoke}")
        before = (init_params, runs[0])
        for i, (old, new) in enumerate(zip(before, runs)):
            changed = sum(not torch.equal(old[k], new[k]) for k in new)
            check(changed > 0, f"app train run {i + 1}: the update changed no parameter")
            say("app", f"train run {i + 1}: {changed} of {len(new)} parameters changed at its update")
        ckpt_dir = Path(root) / "saved_models" / flagship.name
        metrics_csv = Path(root) / "metrics" / flagship.name / "metrics.csv"
        header = metrics_csv.read_text().splitlines()[0].split(",")
        steps = find_steps(str(ckpt_dir))
        say("app", f"checkpoints at steps {steps}; metrics.csv columns {header}")
        check(steps[-1] == 2 * APP_STEPS and APP_STEPS in steps, f"app: checkpoints {steps}")
        check({"train_loss", "grad_norm", "time_to_solve"} <= set(header),
              f"app: metrics.csv columns {header}")
    torch.cuda.empty_cache()
    return launches, sampled


def folded_only(counts: dict, per_kernel: int) -> bool:
    """Whether K1 and K2 each launched ``per_kernel`` times and no other kernel ran."""
    return all(counts[name] == (per_kernel if name in FOLDED else 0) for name in KERNELS)


def release_model(cfg):
    """The trained release on the card: ``(model, table)``, eval mode, bf16 compute."""
    with contextlib.redirect_stdout(io.StringIO()):
        return app.load_weights(cfg, str(RELEASE_DIR), device="cuda")


def phase_adaptive(smi: str) -> dict:
    """10a: the app's ``--adaptive`` (dopri5 at the recipe's atol = rtol = 1e-6)
    on the trained release, 64³ b1, float32 state; then the 120-evaluation RK4
    solve from the same state, held beside it with no threshold."""
    cfg = unconditional_64()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_app-", dir=RELEASE_DIR.parents[2]) as root:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result, out = run_app([
            "--preset", "flagship", "--mode", "inference", "--adaptive", "--checkpoint-path",
            str(RELEASE_DIR), "--n-samples", "1", "--batch-size", "1", "--seed", "100",
            "--no-save-images", "--save-trajectories", "--root-dir", root])
        counts = read_counts()
    sampled = result["inference"]
    nfe, seconds = sampled.nfe, sum(sampled.seconds_per_batch)
    final = torch.from_numpy(sampled.trajectory[-1])
    decoded = sampled.decoded - 1
    say("samplers", f"10a adaptive dopri5 (atol = rtol = {cfg.inference.atol:g}) through "
        f"apps.unconditional --adaptive, trained release, 64³ b1, f32 state: nfe {nfe}, "
        f"{seconds:.3f} s ({seconds / max(abs(nfe), 1) * 1e3:.2f} ms per evaluation, the "
        f"controller's read-back included), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; launches {counts}; {smi}")
    check(nfe > 0, f"10a: nfe {nfe} (negative: a segment reached max_steps)")
    check(folded_only(counts, 6 * nfe), f"10a: launches {counts}, nfe {nfe}")
    check(bool(torch.isfinite(final).all()), "10a: non-finite final state")
    check(int(decoded.min()) >= -1 and int(decoded.max()) <= cfg.data.num_categories - 2,
          f"10a: decoded categories in [{decoded.min()}, {decoded.max()}]")

    model, table = release_model(cfg)
    ic = cfg.inference
    x0 = initial_noise(torch.Generator(device="cuda").manual_seed(100), 1, cfg.data.shape,
                       cfg.data.embedding_dim, torch.float32, torch.device("cuda"))
    start = time.perf_counter()
    with torch.inference_mode():
        ref = solve_ode_final(model, x0, t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames,
                              substeps=ic.substeps, method=ic.method)
        ref_decoded = (decode(ref, table) - 1).cpu().numpy()
    ref_s = time.perf_counter() - start
    ref = ref.cpu()
    agreement = float((ref_decoded == decoded).mean())
    say("samplers", f"10a against RK4 16 frames x 2 substeps (120 evaluations, {ref_s:.3f} s) "
        f"from the same x0: decode agreement {agreement:.6f}, final state relative L2 "
        f"{rel_l2(final, ref):.4e}; {smi}")
    del model
    torch.cuda.empty_cache()
    return {"samplers adaptive": counts}


def category_fractions(decoded: np.ndarray, n_cats: int) -> list:
    """Fractions of the voxels in each category, air (-1 after the shift) first."""
    return [round(float(f), 4) for f in np.bincount(decoded.ravel(), minlength=n_cats)
            / decoded.size]


def phase_sde_and_dispatch(smi: str, rk4) -> dict:
    """10b: ``method="sde"`` on the trained release at 64³ b8, twice from one
    seed (the first keeping its trajectory), beside phase 9's RK4 run from the
    same x0 (``rk4``, its ``SampleResult``). 10c: frame dispatch at b2 against the
    plain sampler, bit for bit."""
    cfg = unconditional_64()
    ic = cfg.inference
    model, table = release_model(cfg)
    kw = dict(n_samples=SDE_SAMPLES, batch_size=SDE_SAMPLES, data_shape=cfg.data.shape,
              embedding_dim=cfg.data.embedding_dim, seed=100, device="cuda", verbose=False,
              t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames, substeps=ic.substeps, method="sde",
              sde_epsilon=SDE_EPSILON, sde_eps_schedule="linear_decay", with_prominence=True)
    runs = []
    for keep in (True, False):
        reset_counts()
        runs.append((sample_unconditional(model, table, keep_trajectory=keep, **kw),
                     read_counts()))
    (first, counts), (second, counts2) = runs
    final = first.trajectory[-1]
    first.trajectory = None
    n_cats = cfg.data.num_categories
    rk4_rate = APP_SAMPLES / sum(rk4.seconds_per_batch) * 60
    differ = float((first.decoded != rk4.decoded).mean())
    say("samplers", f"10b velocity SDE (eps {SDE_EPSILON} linear_decay, {ic.n_frames} frames x "
        f"{ic.substeps} substeps), trained release, 64³ b{SDE_SAMPLES}: nfe {first.nfe}; "
        f"{sum(first.seconds_per_batch):.3f} s with its trajectory copied out, "
        f"{sum(second.seconds_per_batch):.3f} s without ("
        f"{SDE_SAMPLES / sum(second.seconds_per_batch) * 60:.2f} samples/min) against phase 9's "
        f"RK4 {sum(rk4.seconds_per_batch):.3f} s for 120 evaluations ({rk4_rate:.2f} "
        f"samples/min); launches {counts} and {counts2}; {smi}")
    say("samplers", f"10b category fractions (air first): SDE "
        f"{category_fractions(first.decoded, n_cats)}, RK4 {category_fractions(rk4.decoded, n_cats)}"
        f"; {differ:.4f} of the voxels decode otherwise than RK4's from the same x0; mean "
        f"prominence SDE {float(first.prominence.mean()):.4f}, RK4 {float(rk4.prominence.mean()):.4f}")
    check(first.nfe == SDE_EVALUATIONS, f"10b: nfe {first.nfe}")
    check(folded_only(counts, 6 * SDE_EVALUATIONS) and folded_only(counts2, 6 * SDE_EVALUATIONS),
          f"10b: launches {counts}, {counts2}")
    check(bool(np.isfinite(final).all()), "10b: non-finite final state")
    check(np.array_equal(first.decoded, second.decoded), "10b: one seed, two decodes")
    check(differ > 0, "10b: the SDE decodes as RK4 does")

    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.empty(max(free - int(SDE_PRESSURE_MARGIN_GIB * 2**30), 0), dtype=torch.uint8,
                       device="cuda")
    reset_counts()
    pressed = [sample_unconditional(model, table, keep_trajectory=keep, **kw)
               for keep in (True, False)]
    counts_p = read_counts()
    say("samplers", f"10b′ the same pair with {held.numel() / 2**30:.2f} GiB of the card's "
        f"{free / 2**30:.2f} GiB free held by a buffer: {sum(pressed[0].seconds_per_batch):.3f} "
        f"and {sum(pressed[1].seconds_per_batch):.3f} s; decodes equal to each other "
        f"{np.array_equal(pressed[0].decoded, pressed[1].decoded)} and to 10b's "
        f"{np.array_equal(pressed[0].decoded, first.decoded)}; launches {counts_p}")
    del held
    torch.cuda.empty_cache()
    check(folded_only(counts_p, 12 * SDE_EVALUATIONS), f"10b′: launches {counts_p}")
    check(np.array_equal(pressed[0].decoded, pressed[1].decoded),
          "10b′: one seed, two decodes under memory pressure")
    check(np.array_equal(pressed[0].decoded, first.decoded),
          "10b′: the decodes under memory pressure differ from 10b's")

    dispatch = dict(t0=ic.t0, tf=ic.tf, n_frames=DISPATCH_FRAMES, substeps=ic.substeps,
                    method=ic.method, keep_trajectory=True)
    x0 = initial_noise(torch.Generator(device="cuda").manual_seed(3), DISPATCH_BATCH,
                       cfg.data.shape, cfg.data.embedding_dim, torch.float32,
                       torch.device("cuda"))
    reset_counts()
    start = time.perf_counter()
    framed = make_sampler(model, table, frame_dispatch=True, **dispatch)(x0)
    framed_s = time.perf_counter() - start
    counts_fd = read_counts()
    start = time.perf_counter()
    plain = make_sampler(model, table, **dispatch)(x0)
    plain_final = plain["trajectory"][-1].cpu()
    plain_s = time.perf_counter() - start
    same = torch.equal(framed["trajectory"][-1], plain_final)
    say("samplers", f"10c frame dispatch, trained release, 64³ b{DISPATCH_BATCH}, rk4 "
        f"{DISPATCH_FRAMES} frames x {ic.substeps} substeps: nfe {framed['nfe']}, {framed_s:.3f} s "
        f"(each frame copied to the host) against {plain_s:.3f} s plain; final state bit for bit "
        f"{same}, decodes equal {torch.equal(framed['decoded'], plain['decoded'])}; launches "
        f"{counts_fd}; {smi}")
    check(framed["nfe"] == DISPATCH_EVALUATIONS, f"10c: nfe {framed['nfe']}")
    check(folded_only(counts_fd, 6 * DISPATCH_EVALUATIONS), f"10c: launches {counts_fd}")
    check(same and torch.equal(framed["decoded"], plain["decoded"]),
          "10c: frame dispatch differs from the plain sampler")
    del model, framed, plain
    torch.cuda.empty_cache()
    return {"samplers sde": counts, "samplers sde again": counts2,
            "samplers sde under pressure": counts_p, "samplers frame dispatch": counts_fd}


def phase_conditional_apps(smi: str) -> dict:
    """10d: ``apps.inference_experiments`` at ``conditional_64`` with seeded fresh
    weights: one scenario, an ensemble of 4 by the SDE and again by RK4, the
    analysis. 10e: ``apps.conditional`` for 8 micro-steps, then the repaired
    ``InferenceCallback`` (zero observations) on the trained state."""
    cfg = conditional_64()
    launches = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_app-", dir=RELEASE_DIR.parents[2]) as root:
        save = ["--preset", "flagship", "--save-dir", str(Path(root) / "experiments")]
        run_app(save + ["--stage", "create-data", "--n-scenarios", "1"], main=exp_app.main)
        for method, evaluations in (("sde", ENSEMBLE_SDE_EVALUATIONS),
                                    ("rk4", ENSEMBLE_RK4_EVALUATIONS)):
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out, printed = run_app(save + [
                "--stage", "populate", "--method", method, "--n-samples", str(ENSEMBLE_SAMPLES),
                "--batch-size", str(ENSEMBLE_SAMPLES)], main=exp_app.main)
            counts = read_counts()
            launches[f"conditional ensemble {method}"] = counts
            result = out["populate"]["scenario_0"]
            say("conditional apps", f"10d inference_experiments populate --method {method}, "
                f"conditional_64 (seeded fresh weights), 64³ b{ENSEMBLE_SAMPLES}: nfe "
                f"{result.nfe}, seconds per batch {[round(t, 3) for t in result.seconds_per_batch]}"
                f" ({result.seconds_per_batch[0] / result.nfe * 1e3:.1f} ms per evaluation, the "
                f"first batch), peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"launches {counts}; {smi}")
            check("WARNING: no checkpoint found" in printed, "10d: weights other than fresh ones")
            check(result.nfe == evaluations and folded_only(counts, 6 * evaluations),
                  f"10d {method}: nfe {result.nfe}, launches {counts}")
        out, _ = run_app(save + ["--stage", "analyze"], main=exp_app.main)
        scenario = Path(root) / "experiments" / "scenario_0"
        written = sorted(p.name for p in scenario.iterdir())
        want = {"true_model.npy", "boreholes.npy", "probability_tensor.npy", "entropy.npy",
                "entropy_air_masked.npy", "most_probable.npy", "dike_probability.npy",
                *(f"sol_{i}.npy" for i in range(ENSEMBLE_SAMPLES))}
        sols = [np.load(scenario / f"sol_{i}.npy") for i in range(ENSEMBLE_SAMPLES)]
        probs = np.load(scenario / "probability_tensor.npy")
        accuracy = out["analyze"]["scenario_0"]
        say("conditional apps", f"10d analyze: voxel accuracy of the most probable model "
            f"{accuracy:.4f} (random weights); files {written}")
        check(want <= set(written), f"10d: files {written}")
        check(all(s.shape == cfg.data.shape and s.dtype == np.int8 for s in sols)
              and probs.shape == (*cfg.data.shape, cfg.data.num_categories)
              and np.allclose(probs.sum(-1), 1.0), "10d: solutions or maps malformed")

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trained, printed = run_app(["--preset", "flagship", "--steps", str(COND_APP_STEPS),
                                    "--root-dir", str(Path(root) / "train")], main=cond_app.main)
        counts = read_counts()
        launches["conditional app train"] = counts
        peak = torch.cuda.max_memory_allocated() / 2**30
        last = trained.history[-1]
        say("conditional apps", f"10e apps.conditional --steps {COND_APP_STEPS} at "
            f"b{cfg.data.batch_size} x accumulation {cfg.training.accumulate_grad_batches} "
            f"({trained.state.opt_state.updates} updates): {trained.steps_per_sec:.3f} micro-steps"
            f"/s after the first ({trained.steps_per_sec_with_compile:.3f} with it), peak "
            f"{peak:.2f} GiB; losses {[(h['step'], round(h['train_loss'], 4), round(h['flow_loss'], 4), round(h['reconstruct_loss'], 4)) for h in trained.history]}; "
            f"launches {counts}; {smi}")
        check(trained.state.step == COND_APP_STEPS and trained.state.opt_state.updates == 2,
              f"10e: step {trained.state.step}, updates {trained.state.opt_state.updates}")
        check(folded_only(counts, 6 * COND_APP_STEPS), f"10e: launches {counts}")
        check(all(np.isfinite([h["train_loss"], h["flow_loss"], h["reconstruct_loss"]]).all()
                  for h in trained.history), "10e: non-finite loss or parts")
        check("(flow " in printed and "reconstruct " in printed, "10e: no closing line")

        callback = InferenceCallback(cfg, build_model(cfg, device="cuda"),
                                     str(Path(root) / "callback"), n_samples=CALLBACK_SAMPLES)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            sampled = callback.run_inference(trained.state, tag="chip")
        counts = read_counts()
        launches["conditional callback"] = counts
        say("conditional apps", f"10e InferenceCallback.run_inference on the trained "
            f"conditional_64 state (EMA weights, zero ATb): {CALLBACK_SAMPLES} samples, "
            f"{callback.n_frames} frames x {cfg.inference.substeps} substeps rk4 "
            f"({CALLBACK_EVALUATIONS} evaluations at b{CALLBACK_SAMPLES}): time_to_solve "
            f"{sampled['time_to_solve']:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB; launches {counts}; {smi}")
        check(folded_only(counts, 6 * CALLBACK_EVALUATIONS), f"10e callback: launches {counts}")
        check(sampled["decoded"].shape == (CALLBACK_SAMPLES, *cfg.data.shape)
              and bool(np.isfinite(sampled["prominence"]).all()), "10e callback: bad samples")
        del trained, callback
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the constructor options, reference .ckpt files, host-side data and 128³
# (the thirteenth slice)
# ---------------------------------------------------------------------------
def lightning_layout():
    """The test helper that writes reference-layout ``.ckpt`` files (torch and
    numpy only), loaded by its path."""
    spec = importlib.util.spec_from_file_location("torch_lightning_layout", LAYOUT_HELPER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def with_model(cfg, **options):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **options))


def write_reference_ckpt(layout, path: Path, cfg, seed: int) -> dict:
    """A reference-layout checkpoint of ``cfg``'s model with seeded weights and an
    EMA shadow of other seeded weights; returns the flax trees written."""
    variables = variables_to_jax(init_model_variables(cfg, seed=seed, device="cuda"))
    ema = variables_to_jax(init_model_variables(cfg, seed=seed + 1, device="cuda"))["params"]
    hp = dataclasses.asdict(cfg.model)
    hp.update(data_channels=cfg.data.embedding_dim, dim_mults=list(cfg.model.dim_mults))
    table = simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim)
    start = time.perf_counter()
    layout.write_checkpoint(str(path), variables, table, hp,
                            conditional=cfg.model.conditional, ema_params=ema)
    time_embedding = "LearnedFourier" if cfg.model.time_learned_emb else "RandomFourier"
    say("ckpt", f"{cfg.name} ({time_embedding}"
        f" time) written in the reference's layout: {path.stat().st_size} bytes in "
        f"{time.perf_counter() - start:.2f} s")
    return {"variables": variables, "ema": ema}


def check_ema_applied(label: str, model, written: dict) -> None:
    """The model holds the EMA shadow's weights (and the written constants), not
    the checkpoint's own weights."""
    ema = params_from_jax({"params": written["ema"],
                           "constants": written["variables"].get("constants", {})})
    own = params_from_jax(written["variables"])
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    same = all(torch.equal(state[k], ema[k]) for k in ema) and set(state) == set(ema)
    moved = sum(not torch.equal(state[k], own[k]) for k in own)
    say("ckpt", f"{label}: all {len(ema)} tensors the EMA shadow's (constants the written "
        f"ones) {same}; {moved} differ from the checkpoint's own weights; buffers "
        f"{sorted(dict(model.named_buffers()))}")
    check(same and moved > 0, f"{label}: the EMA weights were not the ones applied")


def phase_ckpt(smi: str) -> dict:
    """11a: a reference ``.ckpt`` of the flagship with RandomFourier time through
    the app's inference, and one of ``conditional_64`` through ``load_weights``
    and ``sample_conditional``."""
    layout = lightning_layout()
    launches = {}
    cfg = with_model(unconditional_64(), time_learned_emb=False)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_app-", dir=RELEASE_DIR.parents[2]) as root:
        path = Path(root) / "unconditional.ckpt"
        written = write_reference_ckpt(layout, path, cfg, seed=11)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        result, out = run_app([
            "--preset", "flagship", "--mode", "inference", "--checkpoint-path", str(path),
            "--n-samples", str(APP_SAMPLES), "--batch-size", str(APP_SAMPLES), "--seed", "100",
            "--no-save-images", "--root-dir", root])
        counts = read_counts()
        launches["ckpt app inference"] = counts
        sampled = result["inference"]
        seconds = sum(sampled.seconds_per_batch)
        check("loaded Lightning checkpoint" in out and "EMA True" in out
              and "'time_learned_emb': False" in out, "11a: the app did not load the .ckpt")
        check(sampled.nfe == 120 and folded_only(counts, 6 * sampled.nfe),
              f"11a app: nfe {sampled.nfe}, launches {counts}")
        check(sampled.decoded.shape == (APP_SAMPLES, *cfg.data.shape)
              and int(sampled.decoded.min()) >= 0
              and int(sampled.decoded.max()) <= cfg.data.num_categories - 1,
              "11a app: decoded volumes malformed")
        say("ckpt", f"apps.unconditional --mode inference --checkpoint-path unconditional.ckpt: "
            f"{APP_SAMPLES} samples at 64³ b{APP_SAMPLES}, nfe {sampled.nfe}: {seconds:.3f} s, "
            f"{APP_SAMPLES / seconds * 60:.2f} samples/min, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}; {smi}")
        with contextlib.redirect_stdout(io.StringIO()):
            model, table = app.load_weights(unconditional_64(), str(path), device="cuda")
        check_ema_applied("unconditional .ckpt", model, written)
        reference_check("ckpt flagship (RandomFourier)", model, cfg, 16,
                        {"folded_context": 2, "folded_project": 2}, phase="ckpt")
        del model, result, sampled
        torch.cuda.empty_cache()

        cond = conditional_64()
        path = Path(root) / "conditional.ckpt"
        written = write_reference_ckpt(layout, path, cond, seed=21)
        with contextlib.redirect_stdout(io.StringIO()):
            model, table = app.load_weights(cond, str(path), device="cuda")
        check(type(model).__name__ == "UNet3DCond", f"11a: {type(model).__name__} from the .ckpt")
        check_ema_applied("conditional .ckpt", model, written)
        reference_check("ckpt conditional_64", model, cond, 16,
                        {"folded_context": 2, "folded_project": 2}, phase="ckpt")
        atb = observations(torch.Generator(device="cuda").manual_seed(3), cond, COND_SIDE)
        reset_counts()
        result = sample_conditional(
            model, table, atb, n_samples=COND_BATCH, batch_size=COND_BATCH, seed=0,
            device="cuda", state_dtype=torch.bfloat16, verbose=False, t0=cond.inference.t0,
            tf=cond.inference.tf, n_frames=COND_FRAMES, substeps=1, method="rk4")
        counts = read_counts()
        launches["ckpt conditional"] = counts
        check(result.nfe == (COND_FRAMES - 1) * 4 and folded_only(counts, 6 * result.nfe)
              and result.decoded.shape == (COND_BATCH, *[COND_SIDE] * 3),
              f"11a conditional: nfe {result.nfe}, launches {counts}")
        say("ckpt", f"sample_conditional from conditional.ckpt (EMA), {COND_SIDE}³ b{COND_BATCH}, "
            f"rk4 nfe {result.nfe}: {result.seconds_per_batch[0]:.3f} s (the first batch); "
            f"launches {counts}")
        del model, result
    torch.cuda.empty_cache()
    return launches


def phase_options() -> dict:
    """11b: one b2 64³ bf16 forward on the card per constructor option of the
    flagship, against the same weights in f32 on the CPU."""
    launches = {}
    data = unconditional_64().data
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, *data.shape, data.embedding_dim, generator=gen)
    x_sc = torch.randn(x.shape, generator=gen)
    t = torch.tensor(OPTION_TIMES)
    options = (("sinusoidal time", dict(time_sin_pos=True), 6),
               ("self-conditioning", dict(self_condition=True), 6),
               ("attn_enabled=False", dict(attn_enabled=False), 0))
    for label, opts, per_forward in options:
        cfg = with_model(unconditional_64(), **opts)
        model = seeded_model(cfg, seed=31)
        cpu = build_model(with_model(cfg, dtype="float32"), device="cpu").eval()
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        extra = {"x_self_cond": x_sc} if opts.get("self_condition") else {}
        start = time.perf_counter()
        with torch.inference_mode():
            ref = cpu(x, t, **extra)
        cpu_s = time.perf_counter() - start
        reset_counts()
        with torch.inference_mode():
            got = model(x.cuda().bfloat16(), t.cuda(),
                        **{k: v.cuda().bfloat16() for k, v in extra.items()}).cpu()
        counts = read_counts()
        launches[f"options {label}"] = counts
        rel = rel_l2(got, ref)
        note = ("; no attention module, so no K1 or K2" if per_forward == 0 else "")
        say("options", f"{label}: b2 64³ forward on the card (bf16) vs f32 on the CPU "
            f"({cpu_s:.1f} s): relative L2 {rel:.3e} (tolerance {FORWARD_REL_TOL:g}); "
            f"launches {counts}{note}")
        check(bool(torch.isfinite(got).all()), f"11b {label}: non-finite forward")
        check(rel < FORWARD_REL_TOL, f"11b {label}: relative error {rel:.3e}")
        check(folded_only(counts, per_forward), f"11b {label}: launches {counts}")
        if extra:  # the input matters
            with torch.inference_mode():
                plain = model(x.cuda().bfloat16(), t.cuda()).cpu()
            check(rel_l2(plain, got) > 10 * FORWARD_REL_TOL,
                  "11b: x_self_cond left the forward unchanged")
        del model, cpu
    torch.cuda.empty_cache()
    return launches


def phase_host_data(smi: str) -> dict:
    """11c: ``source="geogen"`` without GeoGen; the native generator built on the
    card; 10 flagship micro-steps through the train loop on it (``prefetch``)
    and on the synthetic source."""
    cfg = flagship_train_config(None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fallback = geogen_data.get_dataset(dataclasses.replace(cfg.data, source="geogen"),
                                           seed=0, device="cuda")
    messages = [str(w.message) for w in caught]
    batch = next(fallback.batches(TRAIN_MICRO_BATCH))
    say("host data", f"get_dataset(source=\"geogen\") without GeoGen: warnings {messages}; "
        f"{type(fallback).__name__} batch {tuple(batch.shape)} {batch.dtype} on {batch.device}")
    check("GeoGen not installed; falling back to synthetic generator" in messages
          and isinstance(fallback, SyntheticGeoDataset) and batch.is_cuda
          and batch.dtype == torch.int32, "11c: the GeoGen fallback")

    start = time.perf_counter()
    library = native_data.build_library()  # raises where g++ fails
    build_s = time.perf_counter() - start
    check(native_data.native_available(), "11c: the native generator does not load")
    shape = cfg.data.shape
    native_data.generate_batch(TRAIN_MICRO_BATCH, shape, seed=0)
    start = time.perf_counter()
    for i in range(NATIVE_BATCHES):
        volumes = native_data.generate_batch(TRAIN_MICRO_BATCH, shape, seed=i)
    per_s = NATIVE_BATCHES / (time.perf_counter() - start)
    check(volumes.shape == (TRAIN_MICRO_BATCH, *shape) and int(volumes.min()) == -1
          and int(volumes.max()) <= cfg.data.num_categories - 2, "11c: native batches malformed")
    say("host data", f"native generator built by g++ in {build_s:.2f} s ({library.name}); "
        f"b{TRAIN_MICRO_BATCH} x {shape[0]}³ batches alone: {per_s:.1f} batches/s "
        f"({per_s * TRAIN_MICRO_BATCH:.1f} volumes/s, {os.cpu_count()} host cores)")

    launches, rates = {}, {}
    native_ds = lambda data, seed, device: native_data.NativeGeoDataset(  # noqa: E731
        data.shape, dataset_size=data.epoch_size, n_categories=data.num_categories, seed=seed)
    for source in ("native", "synthetic"):
        patch = (mock.patch.object(train_loop, "get_dataset", native_ds) if source == "native"
                 else contextlib.nullcontext())
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with patch, contextlib.redirect_stdout(io.StringIO()):
            result = train_loop.train(cfg, num_steps=HOST_STEPS, device="cuda")
        counts = read_counts()
        launches[f"host data {source}"] = counts
        rates[source] = result.steps_per_sec
        check(result.state.step == HOST_STEPS and folded_only(counts, 6 * HOST_STEPS)
              and all(np.isfinite(h["train_loss"]) for h in result.history),
              f"11c {source}: step {result.state.step}, launches {counts}")
        say("host data", f"train loop on the {source} source, flagship 64³ b{TRAIN_MICRO_BATCH} x "
            f"accumulation {TRAIN_ACCUM}, {HOST_STEPS} micro-steps: {result.steps_per_sec:.3f} "
            f"micro-steps/s after the first, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; losses "
            f"{[round(h['train_loss'], 4) for h in result.history]}; launches {counts}")
        del result
    say("host data", f"micro-steps/s: native {rates['native']:.3f} against synthetic "
        f"{rates['synthetic']:.3f} (ratio {rates['native'] / rates['synthetic']:.3f}); the "
        f"generator alone makes {per_s:.1f} batches/s; {smi}")
    torch.cuda.empty_cache()
    return launches


def grads_128(cfg, weights, batch, seed: int) -> torch.Tensor:
    """All parameters' gradients of one 128³ loss of ``cfg`` (training mode,
    dropout on) from ``weights``, flattened in f32."""
    model = build_model(cfg, device="cuda")
    model.load_state_dict(weights)
    model.train()
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories,
                                               cfg.data.embedding_dim)).cuda()
    loss, _ = train_steps._loss(cfg)(train_steps.rematerialised(model, cfg), batch, table,
                                     torch.Generator(device="cuda").manual_seed(seed))
    loss.backward()
    flat = torch.cat([p.grad.float().reshape(-1) for p in model.parameters()])
    del model
    torch.cuda.empty_cache()
    return flat


def phase_128(smi: str) -> tuple:
    """11d: K1 and K2 at b1 x 2^21 tokens against their plain versions and timed;
    the chunked backward at 2^21 rows against the one-shot bf16 form; flagship
    micro-steps at 128³ b1 plain, with remat_blocks, and with remat "nothing"
    plus the bf16 objective; the first two's gradients; one 128³ sample from
    the trained release."""
    n = TOKENS_128
    worst = {name: 0.0 for name in FOLDED}
    q, k, v, mk, mv = make_inputs(1, n, seed=400)
    ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
    ctx, again = (la.folded_context(k, v, mk, mv, HEADS) for _ in range(2))
    out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
    out, out_again = (la.folded_project(q, ctx_plain, HEADS) for _ in range(2))
    torch.cuda.synchronize()
    label = f"b1 x {n}"
    for name, got, second, want in (("folded_context", ctx, again, ctx_plain),
                                    ("folded_project", out, out_again, out_plain)):
        worst[name] = compare(name, label, got, want)
        check(torch.equal(got, second), f"{name} {label}: a second launch differs")
    rows = {}
    nbytes, flops, exps = context_work(1, n)
    rows["folded_context"] = timed_row(
        "folded_context", label, lambda: la.folded_context(k, v, mk, mv, HEADS),
        lambda: la.folded_context_plain(k, v, mk, mv, HEADS), nbytes, flops, exps=exps)
    nbytes, flops, exps = project_work(1, n)
    rows["folded_project"] = timed_row(
        "folded_project", label, lambda: la.folded_project(q, ctx_plain, HEADS),
        lambda: la.folded_project_plain(q, ctx_plain, HEADS), nbytes, flops, exps=exps)
    del ctx, again, ctx_plain, out, out_again, out_plain

    # the chunked backward at 2^21 rows against the one-shot bf16 form, called directly
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(401),
                       device="cuda").to(torch.bfloat16)
    grads, cost = {}, {}
    for form, fn in (("chunked", la.folded_backward_chunked),
                     ("closed_form_bf16", la.folded_backward_closed_form_bf16)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        grads[form] = fn(q, k, v, mk, mv, dout, HEADS)
        torch.cuda.synchronize()
        cost[form] = ((time.perf_counter() - start) * 1e3,
                      (torch.cuda.max_memory_allocated() - base) / 2**30)
    errs = [rel_l2(a, b) for a, b in zip(grads["chunked"], grads["closed_form_bf16"])]
    check(la.backward_form(None, n) == "chunked", "11d: the backward at 2^21 rows is not chunked")
    say("128", f"folded backward at b1 x {n} rows: chunked {cost['chunked'][0]:.1f} ms, "
        f"{cost['chunked'][1]:.2f} GiB above its inputs; one-shot closed_form_bf16 "
        f"{cost['closed_form_bf16'][0]:.1f} ms, {cost['closed_form_bf16'][1]:.2f} GiB (first "
        f"calls); relative L2 " + ", ".join(f"{g} {e:.3e}" for g, e in zip(
            ("dq", "dk", "dv", "dmk", "dmv"), errs)) + f" (limit {BACKWARD_REL_TOL:g})")
    check(all(bool(torch.isfinite(g).all()) for g in grads["chunked"])
          and max(errs) <= BACKWARD_REL_TOL, f"11d chunked backward: relative L2 {max(errs):.3e}")
    del q, k, v, mk, mv, dout, grads
    torch.cuda.empty_cache()

    # flagship micro-steps at 128³ b1 in three forms
    base = unconditional_64()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, shape=(SIDE_128,) * 3, batch_size=1),
        training=dataclasses.replace(base.training, accumulate_grad_batches=TRAIN_ACCUM))
    lean = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, remat=True, remat_policy="nothing", objective_dtype="bfloat16"))
    forms = (("plain", cfg, PER_FORWARD_128),
             ("remat_blocks", with_model(cfg, remat_blocks=True), 2 * PER_FORWARD_128),
             ("remat nothing + bf16 objective", lean, 2 * PER_FORWARD_128))
    launches, steps = {}, {}
    for label, form_cfg, per_step in forms:
        trained = train(f"128³ {label}", form_cfg, dict.fromkeys(FOLDED, per_step), steps=6)
        launches[f"128 train {label}"] = trained["launches"]
        steps[label] = trained
    say("128", "micro-step at 128³ b1 x accumulation 2: " + "; ".join(
        f"{label} {r['ms']:.1f} ms, peak {r['peak_gib']:.2f} GiB" for label, r in steps.items())
        + f"; {smi}")

    # the gradients of the plain and the remat_blocks step, from the same weights
    weights = {k: v.detach() for k, v in
               init_model_variables(cfg, seed=41, device="cuda").state_dict().items()}
    batch = synthetic_geology_batch(torch.Generator(device="cuda").manual_seed(42), 1,
                                    cfg.data.shape)
    plain = grads_128(cfg, weights, batch, 43)
    floor = rel_l2(grads_128(cfg, weights, batch, 43), plain)
    blocks = rel_l2(grads_128(with_model(cfg, remat_blocks=True), weights, batch, 43), plain)
    say("128", f"gradients, dropout on: remat_blocks against the plain step relative L2 "
        f"{blocks:.3e} (limit {REMAT_GRAD_REL_TOL:g}); two plain steps {floor:.3e}")
    check(blocks <= REMAT_GRAD_REL_TOL, f"11d: remat_blocks gradients {blocks:.3e} off")
    del plain, weights, batch
    torch.cuda.empty_cache()

    # one 128³ sample from the trained release
    release = unconditional_64()
    model, table = release_model(release)
    ic = release.inference
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    result = sample_unconditional(
        model, table, n_samples=1, batch_size=1, data_shape=(SIDE_128,) * 3,
        embedding_dim=release.data.embedding_dim, seed=0, device="cuda", verbose=False,
        t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames, substeps=ic.substeps, method=ic.method)
    counts = read_counts()
    launches["128 sample"] = counts
    seconds = result.seconds_per_batch[0]
    fractions = np.bincount(result.decoded.ravel(), minlength=release.data.num_categories)
    say("128", f"sample_unconditional from the trained release at 128³ b1, rk4 "
        f"{ic.n_frames} frames x {ic.substeps} substeps: nfe {result.nfe}, {seconds:.3f} s "
        f"({seconds / result.nfe * 1e3:.1f} ms per evaluation, cuDNN's set-up included), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; air "
        f"{fractions[0] / result.decoded.size:.4f} of voxels; launches {counts}; {smi}")
    check(result.nfe == 120 and folded_only(counts, PER_FORWARD_128 * result.nfe)
          and result.decoded.shape == (1, *[SIDE_128] * 3), f"11d sample: launches {counts}")
    del model, result
    torch.cuda.empty_cache()
    return launches, rows, worst, steps["plain"]["peak_gib"]


# ---------------------------------------------------------------------------
# Phase 12: data and spatial parallelism over torch.distributed
# ---------------------------------------------------------------------------
def rank_layout(n_ranks: int) -> tuple:
    """``(backend, cards)``: NCCL with a card per rank where the machine has that
    many, else gloo with every rank on card 0."""
    if torch.cuda.device_count() >= n_ranks:
        return "nccl", list(range(n_ranks))
    return "gloo", [0] * n_ranks


def describe_layout(backend: str, cards: list) -> str:
    staged = collectives.stages(backend, torch.device("cuda"))
    return (f"{len(cards)} ranks on cards {cards}, backend {backend}"
            + (" (staged through pinned host memory)" if staged else " (no staging)"))


def tensors_hash(tensors) -> str:
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().float().contiguous().cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def exact_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dp_config():
    """The flagship with the EMA shadow on (the recipe has it off), so that the
    replicas' shadows are compared too, and no dropout."""
    base = with_model(unconditional_64(), dropout=0.0)
    return dataclasses.replace(
        base, ema=EMAConfig(), data=dataclasses.replace(base.data, batch_size=DP_RANKS * DP_MICRO_BATCH),
        training=dataclasses.replace(base.training, accumulate_grad_batches=DP_ACCUM))


def dp_inputs(cfg, table: torch.Tensor) -> tuple:
    """12a's global batch and its draws ``(X1, X0, T)``, made on the card from
    ``PHASE12_SEED``: every rank and the one-process step make the same."""
    gen = torch.Generator(device="cuda").manual_seed(PHASE12_SEED)
    batch = synthetic_geology_batch(gen, cfg.data.batch_size, cfg.data.shape)
    _, x1, x0, t = objectives._draw_common(gen, batch, table, cfg.training.time_range,
                                           cfg.training.x1_noise)
    return batch, (x1, x0, t)


def dp_rank(rank: int, cfg) -> dict:
    """One rank of 12a: DP_STEPS data-parallel micro-steps of its block of the global
    batch, the first on the fed draws; what the parent checks."""
    exact_f32()
    mesh = create_mesh()
    model, tx, state = init_train_state(cfg, device="cuda", mesh=mesh)
    table = state.constants["embedding"]
    batch, draws = dp_inputs(cfg, table)
    local, local_draws = shard_batch(batch, mesh), tuple(shard_batch(d, mesh) for d in draws)
    del batch, draws
    loss_and_grads = train_steps.make_data_parallel_loss_and_grads(model, cfg, mesh)
    params = [state.params[k] for k, _ in model.named_parameters()]
    out = {"step_ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for s in range(DP_STEPS):
        start = time.perf_counter()
        gen = folded_generator("cuda", cfg.training.seed + 17, state.step, mesh.di)
        metrics, grads = loss_and_grads(state, local, gen, local_draws if s == 0 else None)
        if s == 0:
            out["loss"] = float(metrics["train_loss"])
            if rank == 0:
                out["grads"] = torch.cat([g.float().reshape(-1) for g in grads]).cpu()
        apply_update(state, tx, cfg, params, grads, metrics)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - start) * 1e3)
    out["counts"] = read_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the all-reduce of one micro-step's flat buffer alone, as the step issues it
    flat = torch.cat([p.detach().float().reshape(-1) for p in params])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        collectives.all_reduce_sum(flat, mesh.world_group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    out["all_reduce_ms"] = statistics.median(times)
    out["all_reduce_mib"] = flat.numel() * 4 / 2**20
    out["params"] = tensors_hash(params)
    out["ema"] = tensors_hash(state.ema_params.values())
    out["card"] = torch.cuda.current_device()
    return out


def phase_data_parallel(smi: str) -> dict:
    """12a: the flagship data-parallel over 2 ranks against one process at b8."""
    cfg = dp_config()
    backend, cards = rank_layout(DP_RANKS)
    say("parallel", f"12a data parallel, flagship 64³: {describe_layout(backend, cards)}; "
        f"b{DP_MICRO_BATCH} a rank x accumulation {DP_ACCUM}, {DP_STEPS} micro-steps, dropout 0, "
        "EMA on")
    # the one-process b8 micro-step on the same batch and draws
    model, _, state = init_train_state(cfg, device="cuda")
    model.train()
    batch, draws = dp_inputs(cfg, state.constants["embedding"])
    loss, _ = train_steps._loss(cfg)(model, batch, state.constants["embedding"],
                                     torch.Generator(device="cuda").manual_seed(0), draws=draws)
    loss.backward()
    want_loss = float(loss.detach())
    want = torch.cat([p.grad.float().reshape(-1) for p in model.parameters()]).cpu()
    del model, state, batch, draws, loss
    torch.cuda.empty_cache()
    start = time.perf_counter()
    ranks = spawn(dp_rank, DP_RANKS, (cfg,), backend=backend, devices=cards,
                  deadline_s=RANK_DEADLINE_S)
    wall = time.perf_counter() - start
    loss_err = abs(ranks[0]["loss"] - want_loss) / abs(want_loss)
    grad_err = rel_l2(ranks[0]["grads"], want)
    say("parallel", f"12a first micro-step: loss {ranks[0]['loss']:.6f} on 2 ranks, "
        f"{want_loss:.6f} in one process at b8 (relative {loss_err:.2e}, limit "
        f"{DP_LOSS_REL_TOL:g}); gradient relative L2 {grad_err:.3e} (limit {DP_GRAD_REL_TOL:g})")
    for r, res in enumerate(ranks):
        say("parallel", f"12a rank {r} (card {res['card']}): launches {res['counts']}; "
            f"micro-steps {', '.join(f'{t:.1f}' for t in res['step_ms'])} ms; flat gradient "
            f"all-reduce ({res['all_reduce_mib']:.1f} MiB) {res['all_reduce_ms']:.2f} ms; peak "
            f"{res['peak_gib']:.2f} GiB; params {res['params']}, EMA {res['ema']}")
    shared = " (ranks share one card: times show correctness, not scaling)" if len(
        set(cards)) < len(cards) else ""
    say("parallel", f"12a {wall:.1f} s with the ranks' start; {smi}{shared}")
    check(loss_err <= DP_LOSS_REL_TOL and grad_err <= DP_GRAD_REL_TOL,
          f"12a: the data-parallel step is off the one-process step (loss {loss_err:.2e}, "
          f"gradient {grad_err:.2e})")
    check(all(r["params"] == ranks[0]["params"] and r["ema"] == ranks[0]["ema"] for r in ranks),
          "12a: the replicas' parameters or EMA differ")
    per_rank = dict.fromkeys(FOLDED, 6 * DP_STEPS)
    for r, res in enumerate(ranks):
        check(all(res["counts"][name] == per_rank.get(name, 0) for name in KERNELS),
              f"12a rank {r}: launches {res['counts']}, expected {per_rank}")
    return {f"12a data parallel rank {r}": res["counts"] for r, res in enumerate(ranks)}


def spatial_train_config():
    """The flagship at 128³ b1, updating every step, with the EMA shadow on and no
    dropout (as 12a's)."""
    base = with_model(unconditional_64(), dropout=0.0)
    return dataclasses.replace(
        base, ema=EMAConfig(), data=dataclasses.replace(base.data, shape=(SIDE_128,) * 3, batch_size=1),
        training=dataclasses.replace(base.training, accumulate_grad_batches=1))


def spatial_inputs(release, cfg) -> tuple:
    """12b's x0 ``[1, 128³, E]`` (f32) and 12c's labels ``[1, 128³]``, on the card
    from ``PHASE12_SEED``."""
    gen = torch.Generator(device="cuda").manual_seed(PHASE12_SEED)
    x0 = initial_noise(gen, 1, (SIDE_128,) * 3, release.data.embedding_dim, torch.float32,
                       torch.device("cuda"))
    labels = synthetic_geology_batch(gen, 1, cfg.data.shape)
    return x0, labels


def release_sharded(release, group, dtype=None):
    """The trained release (EMA weights) in a model X-sharded over ``group``, or
    unsharded with None; ``dtype`` overrides the compute dtype."""
    cfg = release if dtype is None else with_model(release, dtype=dtype)
    tree, _, _ = load_release_weights(str(RELEASE_DIR))
    model = build_model(cfg, device="cuda", spatial_group=group)
    model.load_state_dict(state_dict_from_release(tree, model, use_ema=True))
    return model.eval()


def spatial_rank(rank: int) -> dict:
    """One rank of 12b and 12c (4 spatial ranks): the sharded release's velocity
    (bf16 and f32 compute) and RK4 sample at 128³, then SPATIAL_STEPS sharded
    train steps of the flagship at 128³ b1."""
    exact_f32()
    mesh = create_mesh(1, SPATIAL_RANKS)
    release, cfg = unconditional_64(), spatial_train_config()
    x0, labels = spatial_inputs(release, cfg)
    x0, labels = shard_batch(x0, mesh).contiguous(), shard_batch(labels, mesh).contiguous()
    table = torch.from_numpy(simplex_embedding(release.data.num_categories,
                                               release.data.embedding_dim)).cuda()
    t = torch.full((1,), 0.5, device="cuda")
    out = {}
    model = release_sharded(release, mesh.spatial_group)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        model(x0, t)  # cuDNN's set-up
        torch.cuda.synchronize()
        collectives.reset_traffic()
        reset_counts()
        start = time.perf_counter()
        v = model(x0, t)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - start
        out["eval_counts"] = read_counts()
        out["traffic"] = dict(collectives.traffic)
        out["v"] = v.float().cpu()
        f32 = release_sharded(release, mesh.spatial_group, dtype="float32")
        out["v32"] = f32(x0, t).cpu()
        del f32, v
    # the frame count, the same on every rank: the slowest rank's evaluation sets it
    per_eval = float(collectives.all_reduce_max(torch.tensor([eval_s], device="cuda"),
                                                mesh.world_group))
    ic = release.inference
    per_frame = ic.substeps * 4
    n_frames = max(2, min(ic.n_frames, 1 + int(SPATIAL_SAMPLE_BUDGET_S / (per_eval * per_frame))))
    sampler = make_spatial_sampler(model, table, mesh, t0=ic.t0, tf=ic.tf, n_frames=n_frames,
                                   substeps=ic.substeps, method=ic.method)
    torch.cuda.synchronize()
    reset_counts()
    start = time.perf_counter()
    res = sampler(x0)
    out["decoded"] = res["decoded"].cpu()
    out.update(eval_s=eval_s, n_frames=n_frames, nfe=res["nfe"],
               sample_s=time.perf_counter() - start, sample_counts=read_counts(),
               sample_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del model, sampler, res
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model, tx, state = init_train_state(cfg, device="cuda", mesh=mesh)
    step = make_spatial_train_step(model, tx, cfg, mesh)
    reset_counts()
    out["losses"], out["step_s"] = [], []
    for _ in range(SPATIAL_STEPS):
        start = time.perf_counter()
        state, metrics = step(state, labels, None, PHASE12_SEED)
        out["losses"].append(float(metrics["train_loss"]))
        out["step_s"].append(time.perf_counter() - start)
    out.update(train_counts=read_counts(), train_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               params=tensors_hash(state.params.values()),
               ema=tensors_hash(state.ema_params.values()), card=torch.cuda.current_device())
    return out


def phase_spatial(smi: str, peak_128=None) -> dict:
    """12b and 12c: the flagship at 128³ with X sharded over 4 ranks, against the
    unsharded model on the card; ``peak_128`` is 11d's unsharded plain
    micro-step's peak (GiB), where that ran."""
    backend, cards = rank_layout(SPATIAL_RANKS)
    say("parallel", f"12b/12c spatial, flagship 128³ b1, X over {SPATIAL_RANKS} ranks: "
        f"{describe_layout(backend, cards)}")
    start = time.perf_counter()
    ranks = spawn(spatial_rank, SPATIAL_RANKS, backend=backend, devices=cards,
                  deadline_s=RANK_DEADLINE_S)
    wall = time.perf_counter() - start
    shared = " (ranks share one card: times show correctness, not scaling)" if len(
        set(cards)) < len(cards) else ""
    r0 = ranks[0]
    n_frames = r0["n_frames"]
    check(all(r["n_frames"] == n_frames for r in ranks), "12b: the ranks chose other frame counts")
    cat = lambda key: torch.cat([r[key] for r in ranks], dim=1)

    # the unsharded references on the card, from the same x0, weights and draws
    release, cfg = unconditional_64(), spatial_train_config()
    x0, labels = spatial_inputs(release, cfg)
    t = torch.full((1,), 0.5, device="cuda")
    model, table = release_model(release)
    with torch.no_grad():
        v_err = rel_l2(cat("v"), model(x0, t).float().cpu())
        f32 = release_sharded(release, None, dtype="float32")
        for m in f32.modules():
            if isinstance(m, LinearAttention):
                m.fused_folded = False  # the einsum path: no bf16 rounding of p and ctx
        v32_err = rel_l2(cat("v32"), f32(x0, t).cpu())
        del f32
    ic = release.inference
    want = make_sampler(model, table, t0=ic.t0, tf=ic.tf, n_frames=n_frames,
                        substeps=ic.substeps, method=ic.method)(x0)["decoded"].cpu()
    agree = (cat("decoded") == want).float().mean().item()
    del model
    torch.cuda.empty_cache()
    plain, _, state = init_train_state(cfg, device="cuda")
    plain.train()
    table = state.constants["embedding"]
    tc = cfg.training
    seed = fold_seed(PHASE12_SEED, 0)
    x_loc = SIDE_128 // SPATIAL_RANKS
    parts = [spatial_draws(seed, labels[:, s * x_loc:(s + 1) * x_loc], table, tc.time_range,
                           tc.x1_noise, 0, s) for s in range(SPATIAL_RANKS)]
    _, x1, x0t = (torch.cat([p[i] for p in parts], dim=1) for i in range(3))
    xt, vt = LinearInterpolant(one_sided=True).flow_objective(parts[0][3], x0t, x1)
    with torch.no_grad():
        v_hat = plain(xt, parts[0][3])
        want_loss = float((v_hat.float() - vt).square().sum() / vt.square().sum())
    del plain, state, parts, x1, x0t, xt, vt, v_hat
    torch.cuda.empty_cache()
    loss_err = abs(r0["losses"][0] - want_loss) / abs(want_loss)

    mib = lambda n: n / 2**20
    say("parallel", f"12b one velocity evaluation at t = 0.5: bf16 relative L2 {v_err:.3e} "
        f"against the unsharded forward with K1 and K2 (limit {SPATIAL_BF16_REL_TOL:g}); f32 "
        f"compute {v32_err:.3e} against the unsharded einsum path (limit "
        f"{SPATIAL_F32_REL_TOL:g}); per rank and evaluation: ppermute (halos and ring) "
        f"{mib(r0['traffic']['ppermute']):.2f} MiB, all-reduce "
        f"{mib(r0['traffic']['all_reduce']):.4f} MiB; {r0['eval_s'] * 1e3:.1f} ms; launches "
        f"{r0['eval_counts']}")
    say("parallel", f"12b RK4 {n_frames} frames x {ic.substeps} substeps (nfe {r0['nfe']}; the "
        f"recipe's {ic.n_frames} frames unless, at one evaluation's time, they would pass "
        f"{SPATIAL_SAMPLE_BUDGET_S:g} s): {r0['sample_s']:.1f} s, decode agrees with the "
        f"unsharded sampler on {agree:.4f} of voxels (limit {SPATIAL_DECODE_AGREEMENT}); peak "
        + ", ".join(f"{r['sample_peak_gib']:.2f}" for r in ranks) + " GiB per rank")
    say("parallel", f"12c {SPATIAL_STEPS} sharded train steps at 128³ b1: losses "
        f"{r0['losses']} (first against the unsharded forward's {want_loss:.6f} on the same "
        f"draws: relative {loss_err:.2e}, limit {SPATIAL_LOSS_REL_TOL:g}); "
        f"{', '.join(f'{s:.2f}' for s in r0['step_s'])} s a step; peak "
        + ", ".join(f"{r['train_peak_gib']:.2f}" for r in ranks) + " GiB per rank (unsharded "
        "on one card, 11d's plain micro-step: "
        + ("not run" if peak_128 is None else f"{peak_128:.2f} GiB") + "); params "
        + ", ".join(r["params"] for r in ranks)
        + f"; {wall:.1f} s with the ranks' start; {smi}{shared}")
    check(v_err <= SPATIAL_BF16_REL_TOL and v32_err <= SPATIAL_F32_REL_TOL,
          f"12b: the sharded velocity is off (bf16 {v_err:.2e}, f32 {v32_err:.2e})")
    check(agree >= SPATIAL_DECODE_AGREEMENT, f"12b: decode agreement {agree:.4f}")
    check(loss_err <= SPATIAL_LOSS_REL_TOL, f"12c: the sharded loss is off ({loss_err:.2e})")
    check(all(r["params"] == r0["params"] and r["ema"] == r0["ema"] for r in ranks),
          "12c: the replicas' parameters or EMA differ")
    check(all(not any(r[k].values()) for r in ranks for k in
              ("eval_counts", "sample_counts", "train_counts")),
          "12b/12c: the sharded path launched a hand-written kernel (JAX's takes none)")
    return {f"12{part} spatial rank {i}": r[key] for i, r in enumerate(ranks)
            for part, key in (("b", "sample_counts"), ("c", "train_counts"))}


def phase_two_cards(smi: str) -> dict:
    """12d, on two cards or more: the app on cards 0 and 1, and K1, K2, K4a and K4b on
    a card that is not the current one."""
    if torch.cuda.device_count() < 2:
        say("parallel", "12d not run: one card")
        return {}
    reset_counts()
    with tempfile.TemporaryDirectory() as root:
        out, log = run_app(["--preset", "flagship", "--mode", "train", "--steps", "4",
                            "--train-devices", "0,1", "--no-save-images", "--no-pretrain-smoke",
                            "--root-dir", root])
        saved = find_steps(os.path.join(root, "saved_models", unconditional_64().name))
    losses = [h["train_loss"] for h in out["train"].history]
    say("parallel", f"12d the app with --train-devices 0,1 (NCCL, one rank a card), 4 "
        f"micro-steps: losses {losses}, checkpoints {saved}; {smi}")
    check(saved == [4] and all(np.isfinite(losses)), "12d: the two-card app run failed")
    current = torch.cuda.current_device()
    other = torch.device("cuda", 1 - current)
    worst = {}
    q, k, v, mk, mv = (t.to(other) for t in make_inputs(2, STAGE_TOKENS[1], seed=1201))
    ctx = la.folded_context(k, v, mk, mv, HEADS)
    worst["folded_context"] = compare("folded_context", "other card", ctx,
                                      la.folded_context_plain(k, v, mk, mv, HEADS))
    worst["folded_project"] = compare("folded_project", "other card",
                                      la.folded_project(q, ctx, HEADS),
                                      la.folded_project_plain(q, ctx, HEADS))
    qv, kv, vv = (t.to(other) for t in make_v1_inputs(2, STAGE_TOKENS[1], seed=1202))
    ctx = la.linear_context(kv, vv)
    worst["linear_context"] = compare("linear_context", "other card", ctx,
                                      la.linear_context_plain(kv, vv))
    worst["linear_project"] = compare("linear_project", "other card",
                                      la.linear_project(qv, ctx), la.linear_project_plain(qv, ctx))
    torch.cuda.synchronize(other)
    say("parallel", f"12d K1, K2, K4a and K4b on {other} with {current} current: max abs "
        f"errors {worst}; current device after: {torch.cuda.current_device()}")
    check(torch.cuda.current_device() == current, "12d: a wrapper changed the current device")
    return {}


def phase_parallel(smi: str, peak_128=None) -> dict:
    """Phase 12: 12a data parallel, 12b and 12c spatial, 12d two cards."""
    launches = phase_data_parallel(smi)
    launches.update(phase_spatial(smi, peak_128))
    launches.update(phase_two_cards(smi))
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the 2-D family and the toys, the FLOP count, the profiling utils
# (the fifteenth slice)
# ---------------------------------------------------------------------------
def unet2d_forward(timer) -> tuple:
    """13a: the UNet2D's b8 64² bf16 forward on the card against f32 on the CPU,
    its launches, and one forward traced by ``utils.profiling.trace``."""
    model = UNet2D(**UNET2D, dtype=torch.bfloat16, device="cuda")
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(13))
    cpu = UNet2D(**UNET2D, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(UNET2D_BATCH, UNET2D_SIDE, UNET2D_SIDE, UNET2D["data_channels"], generator=gen)
    t = torch.full((UNET2D_BATCH,), 0.5)  # exact in bf16
    reset_counts()
    with torch.inference_mode():
        got = timer(model, x.cuda().bfloat16(), t.cuda())
        launches = read_counts()
        ref = cpu(x, t)
    got = got.cpu()
    rel = rel_l2(got, ref)
    say("2d", f"13a UNet2D {UNET2D_SIDE}² b{UNET2D_BATCH} forward on the card (bf16, first call "
        f"{timer.times[-1]:.3f} s, launches {launches}) vs f32 on the CPU: relative L2 error "
        f"{rel:.3e} (tolerance {FORWARD_REL_TOL:g})")
    check_finite({"13a forward": got})
    expected = {name: UNET2D_PER_FORWARD.get(name, 0) for name in KERNELS}
    check(launches == expected, f"13a: launches {launches}, expected {expected}")
    check(rel < FORWARD_REL_TOL, f"13a: UNet2D forward relative error {rel:.3e}")
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir), torch.inference_mode():
            model(x.cuda().bfloat16(), t.cuda())
            torch.cuda.synchronize()
        trace_file = Path(log_dir) / profiling.TRACE_FILE
        size = trace_file.stat().st_size if trace_file.is_file() else 0
    say("2d", f"13a profiling.trace of one forward: {profiling.TRACE_FILE}, {size} bytes")
    check(size > 0, "13a: the trace file is missing or empty")
    return model, launches


def unet2d_sample(model, timer) -> dict:
    """13b: RK4 over 16 frames x 2 substeps (120 evaluations) at b8 64²."""
    ic = unconditional_64().inference
    x0 = torch.randn(UNET2D_BATCH, UNET2D_SIDE, UNET2D_SIDE, UNET2D["data_channels"],
                     generator=torch.Generator(device="cuda").manual_seed(14), device="cuda")
    nfe = (ic.n_frames - 1) * ic.substeps * 4
    reset_counts()
    with torch.inference_mode():
        final = timer(solve_ode_final, model, x0, t0=ic.t0, tf=ic.tf, n_frames=ic.n_frames,
                      substeps=ic.substeps, method="rk4")
    launches = read_counts()
    seconds = timer.times[-1]
    meta = UNet2D(**UNET2D, dtype=torch.bfloat16, device=flops.META).eval()
    x_meta = torch.empty(x0.shape, device=flops.META)
    with torch.no_grad():
        forward = flops.count_conv_dot_flops(meta, x_meta, torch.empty(UNET2D_BATCH,
                                                                      device=flops.META))
    say("2d", f"13b UNet2D RK4 {ic.n_frames} frames x {ic.substeps} substeps ({nfe} evaluations) "
        f"at {UNET2D_SIDE}² b{UNET2D_BATCH}: {seconds:.3f} s, "
        f"{UNET2D_BATCH / seconds:.2f} images/s, "
        f"{seconds / nfe * 1e3:.2f} ms per evaluation ({forward / 1e9:.2f} GFLOP a forward on "
        f"meta: {forward * nfe / seconds / 1e12:.2f} TF/s); |x| max "
        f"{float(final.abs().max()):.3f}; launches {launches}")
    check_finite({"13b final state": final})
    for name in KERNELS:
        want = UNET2D_PER_FORWARD.get(name, 0) * nfe
        check(launches[name] == want,
              f"13b: {name} launched {launches[name]} times, expected {want}")
    return launches


def toys(timer) -> dict:
    """13c: the image toy at its defaults for ``TOY_IMAGE_STEPS`` steps on the
    synthetic images; 13d: the 2-D toy at its defaults."""
    reset_counts()
    result = timer(toy2d_images.train_and_sample, steps=TOY_IMAGE_STEPS, use_mnist=False,
                   verbose=False, device="cuda")
    images = read_counts()
    lo, hi = result["sample_minmax"]
    say("2d", f"13c toy2d_images (size 32, dim 16, b64, lr 2e-3, {result['source']}): "
        f"{TOY_IMAGE_STEPS} steps in {result['train_seconds']} s "
        f"({TOY_IMAGE_STEPS / max(result['train_seconds'], 1e-9):.1f} steps/s), "
        f"{timer.times[-1]:.3f} s with the 9 x 4 RK4 grid; loss {result['loss_first']:.4f} -> "
        f"{result['loss_last']:.4f}; samples in [{lo:.3f}, {hi:.3f}]; launches {images}")
    check_finite({"13c samples": result["samples"]})
    check(result["loss_last"] < TOY_LOSS_SHARE * result["loss_first"],
          f"13c: loss {result['loss_first']:.4f} -> {result['loss_last']:.4f}")
    check(-4.0 < lo < hi < 4.0, f"13c: samples in [{lo}, {hi}]")

    reset_counts()
    result = timer(toy2d.train_and_sample, verbose=False, device="cuda",
                   n_samples=TOY2D_SAMPLES)
    mixture = read_counts()
    mean = result["final_mean"]
    say("2d", f"13d toy2d (2000 steps, b512, {TOY2D_SAMPLES} samples): trained in "
        f"{result['train_seconds']:.3f} s "
        f"({2000 / result['train_seconds']:.1f} steps/s), {timer.times[-1]:.3f} s with the RK4 "
        f"trajectory; loss {[round(loss, 4) for _, loss in result['losses']]}; final mean "
        f"{[round(float(m), 4) for m in mean]} (mixture {list(TOY2D_MEAN)}); launches {mixture}")
    check_finite({"13d trajectory": result["trajectory"]})
    check(np.abs(mean - np.asarray(TOY2D_MEAN)).max() < TOY2D_MEAN_TOL,
          f"13d: final mean {mean}")
    return {"2d toy images": images, "2d toy mixture": mixture}


def flop_reading(rk4, train_ms: float) -> None:
    """13e: ``utils.flops`` on ``meta`` beside phase 9's and phase 8's times."""
    cfg = unconditional_64()
    forward = flops.forward_flops(cfg, APP_SAMPLES)
    per_eval = sum(rk4.seconds_per_batch) / rk4.nfe
    rate = forward / per_eval / 1e12
    peak = PEAK_BF16_FLOP_PER_S / 1e12
    step_cfg = flagship_train_config(None)
    step = flops.micro_step_flops(step_cfg)
    step_rate = step / (train_ms / 1e3) / 1e12
    say("2d", f"13e utils.flops on meta: the flagship 64³ b{APP_SAMPLES} forward "
        f"{forward / 1e12:.4f} TFLOP (products and convolutions); phase 9's app "
        f"{per_eval * 1e3:.2f} ms per evaluation (of its {rk4.nfe}, decode included): "
        f"{rate:.2f} TF/s, {rate / peak:.4f} of the {peak:g} TF/s bf16 dense peak; one "
        f"b{step_cfg.data.batch_size} micro-step {step / 1e12:.4f} TFLOP, phase 8's median "
        f"{train_ms:.1f} ms: {step_rate:.2f} TF/s, {step_rate / peak:.4f} of the peak")


def phase_2d(rk4, train_ms: float) -> dict:
    """Phase 13: 13a-13d timed by ``utils.profiling.StepTimer``, then 13e."""
    start = time.perf_counter()
    timer = profiling.StepTimer(warmup=0, device="cuda")
    model, forward = unet2d_forward(timer)
    launches = {"2d unet forward": forward, "2d unet sample": unet2d_sample(model, timer)}
    del model
    torch.cuda.empty_cache()
    launches.update(toys(timer))
    flop_reading(rk4, train_ms)
    say("2d", f"StepTimer of 13a-13d: {[round(t, 3) for t in timer.times]} s, summary "
        f"{timer.summary()}; phase 13 {time.perf_counter() - start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the demo and trace tools (the sixteenth slice)
# ---------------------------------------------------------------------------
def demo_counts(label: str, counts: dict, forwards: int) -> None:
    """Check that K1 and K2 launched 6 times in each of ``forwards`` forwards of
    the flagship's width (a micro-step's forward, or a velocity evaluation) and
    no other kernel ran."""
    check(folded_only(counts, 6 * forwards),
          f"14 {label}: launches {counts}, expected K1 and K2 {6 * forwards} times each")


def demo_train(root: Path, smi: str) -> dict:
    """14a: ``tools.train_demo`` on the flagship at b4, then resumed; 14b:
    ``tools.export_weights`` of its checkpoint, read back by
    ``load_release_weights``, its forward against the trained model's."""
    launches = {}
    out = root / "train_demo"
    for label, steps, resumed in (("demo train", DEMO_STEPS, 0),
                                  ("demo resume", DEMO_RESUMED, DEMO_STEPS)):
        reset_counts()
        start = time.perf_counter()
        summary, text = run_app(["--steps", str(steps), "--out", str(out), "--n-frames",
                                 str(DEMO_FRAMES)] + (["--resume"] if resumed else []),
                                main=train_demo.main)
        launches[label] = counts = read_counts()
        seconds = time.perf_counter() - start
        say("demo", f"14a train_demo {resumed} -> {steps} steps at b4: {seconds:.1f} s (loop "
            f"{summary['elapsed_s']} s), loss {summary['loss_first']} -> {summary['loss_last']}, "
            f"air above / below {summary['air_frac_top']} / {summary['air_frac_bottom']}; "
            f"launches {counts}; {smi}")
        check((f"resumed from step {DEMO_STEPS}" in text) == bool(resumed),
              f"14a {label}: resume message {'missing' if resumed else 'unexpected'}")
        check(np.isfinite([summary["loss_first"], summary["loss_last"]]).all(),
              f"14a {label}: non-finite loss")
        demo_counts(label, counts, steps - resumed + DEMO_EVALUATIONS)
    rows = [line.split(",")[0] for line in (out / "metrics.csv").read_text().splitlines()]
    check(rows == ["step", "0", "10", str(DEMO_STEPS - 1), "20", str(DEMO_RESUMED - 1)],
          f"14a: metrics.csv steps {rows}")
    check(len(list(out.glob("sample_*.npy"))) == 4, "14a: sample files missing")

    release = root / "release"
    size = export_weights.export(str(out / "ckpt"), str(release), note="chip_smoke phase 14")
    tree, config, meta = load_release_weights(str(release), cast_to=None)
    leaves, values, all_bf16 = count_leaves(tree["params"])
    check((leaves, values, all_bf16) == (RELEASE_LEAVES, RELEASE_VALUES, True)
          and meta["step"] == DEMO_RESUMED and config == train_demo.demo_config(
              train_demo.parse_arguments(["--steps", str(DEMO_RESUMED)])),
          f"14b: release of {leaves} leaves, {values} values, bf16 {all_bf16}, meta {meta}")
    trained, _, state = init_train_state(config)
    CheckpointManager(str(out / "ckpt")).restore(state)
    exported = build_model(config, device="cuda")
    exported.load_state_dict(state_dict_from_release(load_release_weights(str(release))[0],
                                                     exported, use_ema=False))
    x = torch.randn(1, 64, 64, 64, config.data.embedding_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(14))
    t = torch.full((1,), 0.5, device="cuda")
    reset_counts()
    with torch.inference_mode():
        unrounded, got = trained.eval()(x, t), exported.eval()(x, t)
        # the release stores every float leaf in bf16 (the JAX format): the
        # trained weights rounded so are what its forward must reproduce
        for p in trained.parameters():
            p.copy_(p.bfloat16().float())
        want = trained(x, t)
    launches["demo export forward"] = counts = read_counts()
    rel, rel_f32 = rel_l2(got, want), rel_l2(got, unrounded)
    say("demo", f"14b export_weights: {size} bytes ({leaves} bf16 leaves, step {meta['step']}); "
        f"the release's 64³ b1 forward against the trained weights rounded to bf16: relative "
        f"L2 {rel:.3e} (tolerance {FORWARD_REL_TOL:g}); against the unrounded f32 weights "
        f"{rel_f32:.3e} (bf16 LearnedFourier frequencies move the phase of t = 0.5); launches "
        f"{counts}")
    demo_counts("export forward", counts, 3)
    check(rel < FORWARD_REL_TOL, f"14b: exported forward relative error {rel:.3e}")
    del trained, exported, state
    torch.cuda.empty_cache()
    return launches, release


def demo_sample(root: Path, release: Path, smi: str) -> dict:
    """14c: ``tools.sample_from_ckpt`` from the exported release at b8, then
    ``tools.eval_samples`` on what it wrote."""
    out = root / "samples"
    reset_counts()
    summary, _ = run_app(["--ckpt", str(release), "--out", str(out), "--n-frames",
                          str(DEMO_FRAMES), "--substeps", "1"], main=sample_from_ckpt.main)
    counts = read_counts()
    demo_counts("sample_from_ckpt", counts, DEMO_SAMPLE_EVALUATIONS)
    report, _ = run_app(["--samples", str(out / "sample_*.npy"), "--json-out",
                         str(out / "eval.json")], main=eval_samples.main)
    keys = {"n_samples", "sample_shape", "category_tv_distance", "air_fraction",
            "air_profile_mad", "air_profile_generated_bottom_mid_top",
            "air_profile_prior_bottom_mid_top", "categories_per_sample",
            "category_freq_generated", "category_freq_prior"}
    say("demo", f"14c sample_from_ckpt b8 ({DEMO_SAMPLE_EVALUATIONS} evaluations): "
        f"{summary['seconds_per_batch']} s, {summary['n_categories_used']} categories; "
        f"eval_samples: TV {report['category_tv_distance']}, air-profile MAD "
        f"{report['air_profile_mad']} (a report: no threshold after {DEMO_RESUMED} steps); "
        f"launches {counts}; {smi}")
    check(set(report) == keys and report["n_samples"] == 4, f"14c: eval report {report}")
    return {"demo sample": counts}


def demo_conditional(root: Path, smi: str) -> dict:
    """14d: the conditional ``tools.train_demo`` at b2 x 4, then
    ``tools.analyze_cond_demo`` on its ensemble."""
    out = root / "train_demo_cond"
    reset_counts()
    start = time.perf_counter()
    summary, _ = run_app(["--conditional", "--steps", str(DEMO_COND_STEPS), "--batch-size", "2",
                          "--accum", "4", "--lr", "2.5e-4", "--out", str(out), "--n-frames",
                          str(DEMO_FRAMES)], main=train_demo.main)
    counts = read_counts()
    report, _ = run_app(["--dir", str(out)], main=analyze_cond_demo.main)
    say("demo", f"14d conditional train_demo {DEMO_COND_STEPS} micro-steps at b2 x 4: "
        f"{time.perf_counter() - start:.1f} s, loss {summary['loss_first']} -> "
        f"{summary['loss_last']}; ensemble of 4 ({DEMO_EVALUATIONS} evaluations): observed-"
        f"voxel accuracy {summary['observed_voxel_accuracy']}, analyze_cond_demo "
        f"{report['obs_acc_overall']} (the same mask redrawn); launches {counts}; {smi}")
    demo_counts("conditional", counts, DEMO_COND_STEPS + DEMO_EVALUATIONS)
    check(report["obs_acc_overall"] == summary["observed_voxel_accuracy"]
          and report["n_samples"] == 4, f"14d: analysis {report} against {summary}")
    return {"demo conditional": counts}


def demo_trace(root: Path, smi: str) -> dict:
    """14e: ``tools.trace_forward`` (2 traced b8 forwards) and
    ``tools.trace_summary``; 14f: ``tools.profile_breakdown --quick``."""
    launches = {}
    reset_counts()
    traced, _ = run_app(["--iters", str(DEMO_TRACE_ITERS), "--out", str(root / "trace")],
                        main=trace_forward.main)
    launches["demo trace"] = counts = read_counts()
    demo_counts("trace_forward", counts, 3 + DEMO_TRACE_ITERS)  # 2 warm-up, 1 timed
    summary = trace_summary.summarize(traced["trace"], verbose=False)
    buckets = sum(summary["buckets"].values())
    profiler = traced["profiler_device_ms"]
    gap = abs(buckets - profiler) / profiler if profiler > 0 else float("inf")
    say("demo", f"14e trace_forward b8: {traced['forward_ms']:.1f} ms a forward; trace_summary "
        f"{summary['iterations']} iterations: buckets {buckets:.3f} ms against the profiler's "
        f"{profiler:.3f} ms of kernel time an iteration ({gap:.2e} apart); "
        + ", ".join(f"{b} {ms:.3f}" for b, ms in summary["buckets"].items())
        + f"; hand-written {({k: round(v, 3) for k, v in summary['hand_written'].items()})}; "
        f"idle share {summary['idle_share']:.4f}, largest gaps {summary['largest_gaps_ms'][:3]} ms")
    check(summary["source"] == "device" and summary["iterations"] == DEMO_TRACE_ITERS,
          f"14e: trace summary of {summary['source']}, {summary['iterations']} iterations")
    check(gap < DEMO_TRACE_REL_TOL, f"14e: buckets {buckets:.3f} ms, profiler {profiler:.3f} ms")
    check(all(summary["hand_written"].get(k, 0) > 0 for k in ("folded_context_partial",
                                                             "folded_project")),
          f"14e: the hand-written bucket holds {summary['hand_written']}")

    reset_counts()
    rows, _ = run_app(["--quick"], main=profile_breakdown.main)
    launches["demo profile"] = counts = read_counts()
    say("demo", f"14f profile_breakdown --quick: full forward {rows['full forward (bf16)']:.3f} "
        f"ms, no attention {rows['no attention']:.3f} ms at b8; launches {counts}; {smi}")
    demo_counts("profile_breakdown", counts, 2 + 5)  # best_ms: 2 warm-up, 5 tries
    return launches


def phase_demo(smi: str) -> dict:
    """Phase 14: 14a-14f in a temporary directory of the checkout."""
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_demo-",
                                     dir=RELEASE_DIR.parents[2]) as tmp:
        root = Path(tmp)
        launches, release = demo_train(root, smi)
        launches.update(demo_sample(root, release, smi))
        launches.update(demo_conditional(root, smi))
        launches.update(demo_trace(root, smi))
    torch.cuda.empty_cache()
    say("demo", f"phase 14 {time.perf_counter() - start:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Training held over many updates (the seventeenth slice)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def plain_folded():
    """K1 and K2 replaced by their plain versions, which the kernel phases hold
    them to: the model's folded attention then runs no kernel."""
    with mock.patch.object(la, "folded_context", la.folded_context_plain), \
            mock.patch.object(la, "folded_project", la.folded_project_plain):
        yield


def trajectory_feed(cfg) -> list:
    """``TRAJ_STEPS`` batches and their draws (X1, X0, T) on the card, T rounded
    to bf16; step ``s`` from a generator seeded ``(TRAJ_SEED, s)``."""
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories,
                                               cfg.data.embedding_dim)).to("cuda")
    feed = []
    for step in range(TRAJ_STEPS):
        gen = folded_generator("cuda", TRAJ_SEED, step)
        batch = synthetic_geology_batch(gen, TRAJ_BATCH, cfg.data.shape)
        _, x1, x0, t = objectives._draw_common(gen, batch, table, cfg.training.time_range,
                                               cfg.training.x1_noise)
        feed.append((batch, (x1, x0, t.bfloat16().float())))
    return feed


def held_updates(smi: str) -> dict:
    """15a: ``TRAJ_STEPS`` updates on the kernel path (bf16) and on the plain
    versions (f32), from the same weights and draws."""
    base = unconditional_64()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, dropout=0.0),
        data=dataclasses.replace(base.data, shape=(TRAJ_SIDE,) * 3, batch_size=TRAJ_BATCH),
        training=dataclasses.replace(base.training, accumulate_grad_batches=1))
    f32 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="float32"))
    feed = trajectory_feed(cfg)
    runs, weights = {}, None
    for side, c, paths in (("kernels", cfg, contextlib.nullcontext), ("plain", f32, plain_folded)):
        model, tx, state = init_train_state(c, device="cuda")
        if weights is None:
            weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(weights)
        before = torch.cat([p.detach().reshape(-1).float() for p in state.params.values()])
        train_step = make_train_step(model, tx, c)
        losses = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        reset_counts()
        with paths():
            for batch, draws in feed:
                with mock.patch.object(objectives, "_draw_common", lambda *a, d=draws: (None, *d)):
                    state, metrics = train_step(state, batch, torch.Generator(device="cuda"))
                losses.append(metrics["train_loss"])
            torch.cuda.synchronize()
        after = torch.cat([p.detach().reshape(-1).float() for p in state.params.values()])
        runs[side] = dict(losses=[float(v) for v in losses], launches=read_counts(),
                          seconds=time.perf_counter() - start, change=(after - before).cpu(),
                          updates=state.opt_state.updates)
        del model, tx, state, train_step
        torch.cuda.empty_cache()
    kernels, plain = runs["kernels"], runs["plain"]
    rel = [abs(a - b) / abs(b) for a, b in zip(kernels["losses"], plain["losses"])]
    parted = next((i for i, r in enumerate(rel) if not r <= TRAJ_LOSS_REL_TOL), None)
    change_cos = cosine(kernels["change"], plain["change"])
    say("held", f"15a {TRAJ_STEPS} updates of the recipe at {TRAJ_SIDE}³ b{TRAJ_BATCH} "
        f"(accumulation 1, no dropout, lr {cfg.training.learning_rate:g}, t rounded to bf16): "
        f"bf16 kernel path {kernels['seconds']:.1f} s, launches {kernels['launches']}; f32 plain "
        f"versions {plain['seconds']:.1f} s, launches {plain['launches']}; losses "
        f"{kernels['losses'][0]:.4f} -> {kernels['losses'][-1]:.4f} (plain "
        f"{plain['losses'][0]:.4f} -> {plain['losses'][-1]:.4f}); per-step relative "
        f"differences {[float(f'{r:.2e}') for r in rel]} (worst {max(rel):.2e}, tolerance "
        f"{TRAJ_LOSS_REL_TOL:g}); cosine of the total parameter changes {change_cos:.6f} "
        f"(mean |change| {float(kernels['change'].abs().mean()):.3e} against "
        f"{float(plain['change'].abs().mean()):.3e}); {smi}")
    check(np.isfinite(kernels["losses"] + plain["losses"]).all(), "15a: non-finite loss")
    check(kernels["updates"] == plain["updates"] == TRAJ_STEPS,
          f"15a: {kernels['updates']} and {plain['updates']} updates")
    check(folded_only(kernels["launches"], TRAJ_PER_STEP * TRAJ_STEPS),
          f"15a: kernel path launches {kernels['launches']}")
    check(not any(plain["launches"].values()), f"15a: plain path launches {plain['launches']}")
    if parted is not None:
        raise SmokeFailure(f"15a: the paths part at step {parted}: loss "
                           f"{kernels['losses'][parted]:.6f} against {plain['losses'][parted]:.6f}")
    check(change_cos >= TRAJ_COSINE, f"15a: cosine of the parameter changes {change_cos:.6f}")
    return {"held updates": kernels["launches"]}


def fixed_eval_paths(smi: str) -> dict:
    """15b: ``tools.fixed_eval`` of the release on the kernel path and on the
    plain versions."""
    out = {}
    for side, paths in (("kernels", contextlib.nullcontext), ("plain", plain_folded)):
        reset_counts()
        with paths():
            result = fixed_eval.evaluate(str(RELEASE_DIR), batches=FIXED_EVAL_BATCHES,
                                         batch_size=FIXED_EVAL_BATCH, device="cuda")
        out[side] = (result, read_counts())
    (kernels, launches), (plain, plain_launches) = out["kernels"], out["plain"]
    rel = abs(kernels["mean"] - plain["mean"]) / abs(plain["mean"])
    volumes = FIXED_EVAL_BATCHES * FIXED_EVAL_BATCH
    say("held", f"15b fixed_eval of the release (step {kernels['step']}, {kernels['storage']}) on "
        f"{FIXED_EVAL_BATCHES} batches of {FIXED_EVAL_BATCH} at {fixed_eval.SIDE}³: kernel path "
        f"{kernels['mean']:.6f} ± {kernels['se']:.6f} ({kernels['seconds']:.1f} s, launches "
        f"{launches}), plain versions {plain['mean']:.6f} ± {plain['se']:.6f} "
        f"({plain['seconds']:.1f} s); relative difference {rel:.2e} (tolerance "
        f"{FIXED_EVAL_REL_TOL:g}); {smi}")
    check(kernels["n"] == plain["n"] == volumes and np.isfinite([kernels["mean"],
                                                                  plain["mean"]]).all(),
          f"15b: {kernels['n']} and {plain['n']} volumes, means {kernels['mean']} and {plain['mean']}")
    check(folded_only(launches, 6 * volumes), f"15b: kernel path launches {launches}")
    check(not any(plain_launches.values()), f"15b: plain path launches {plain_launches}")
    check(rel <= FIXED_EVAL_REL_TOL, f"15b: fixed evaluation {kernels['mean']:.6f} against "
          f"{plain['mean']:.6f} on the plain versions")
    return {"fixed eval": launches}


def phase_held(smi: str) -> dict:
    """Phase 15: 15a and 15b."""
    start = time.perf_counter()
    launches = held_updates(smi)
    launches.update(fixed_eval_paths(smi))
    say("held", f"phase 15 {time.perf_counter() - start:.1f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false); "
              "this script runs only on a card", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say("device", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"device count {count}; {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    builds = cuda_build.load_all([la.SOURCE, fa.SOURCE, tc.SOURCE, gp.SOURCE])
    for name, build in builds.items():
        say("build", f"nvcc {build.seconds:.1f} s -> {build.path.name}")
        for line in build.log.splitlines():
            if any(word in line for word in ("registers", "spill", "Compiling entry", "wgmma")):
                print(f"    {line.strip()}", flush=True)

    worst = phase_kernel_check()
    rows = phase_kernel_times()
    say("ab_linear_attention", "K1, K2, K4a and K4b variants in turns")
    ab_la.main()
    say("bench_folded", "K1 and K2 through their wrappers: host and device time")
    bench_folded.kernels(torch.device("cuda"))
    headline = {name: rows[(name, BATCH, FLASH_TOKENS[0] if name == "flash_attention"
                            else STAGE_TOKENS[0])] for name in (*la.launch_counts, *fa.launch_counts)}
    phase_backwards()
    launches = phase_wide_heads(worst)
    for phase in (phase_tap_conv, phase_gemm_probes):
        phase_rows, phase_launches = phase(worst)
        headline.update(phase_rows)
        launches.update(phase_launches)
    model, sampling_launches = phase_sampling()
    launches.update(sampling_launches)
    launches.update(phase_conditional())
    phase_forward(model)
    widths = linear_attention_widths(model)
    del model
    torch.cuda.empty_cache()
    launches.update(phase_v1(widths))
    flagship_train = train(
        "flagship", flagship_train_config(None), {"folded_context": 6, "folded_project": 6},
        check_sampler=True)
    launches["train flagship"] = flagship_train["launches"]
    launches["train fa16"] = train(
        "fa16", flagship_train_config(FA16),
        {"flash_attention": 2, "folded_context": 4, "folded_project": 4},
        profile=True)["launches"]
    app_launches, rk4 = phase_app(smi)
    launches.update(app_launches)
    launches.update(phase_adaptive(smi))
    launches.update(phase_sde_and_dispatch(smi, rk4))
    launches.update(phase_conditional_apps(smi))
    launches.update(phase_ckpt(smi))
    launches.update(phase_options())
    launches.update(phase_host_data(smi))
    launches_128, rows_128, worst_128, peak_128 = phase_128(smi)
    launches.update(launches_128)
    launches.update(phase_parallel(smi, peak_128))
    launches.update(phase_2d(rk4, flagship_train["ms"]))
    launches.update(phase_demo(smi))
    launches.update(phase_held(smi))
    for name, err in worst_128.items():
        worst[name] = max(worst[name], err)

    kernels = []
    for name in KERNELS:
        row = headline[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        check(sum(by_path.values()) > 0, f"{name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            # exponentials are operations too, on the special-function units
            "bound_by": "bytes" if row["bound_by"] == "bytes" else "operations",
            "bound_term": row["bound_by"], "library_ms": row["library_ms"],
        })
        if name in rows_128:  # the 128³ stage: b1 x 2^21 tokens
            kernels[-1]["b1_2097152"] = {key: rows_128[name][key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        say("FAILED", str(exc))
        sys.exit(1)
