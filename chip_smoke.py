#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``flowtrain_stochastic_interpolation_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on one flushed line with the seconds since start:

0. device: the card's name and power limit (nvidia-smi) and the device count;
   no CUDA device -> exit 1 with a message that says so;
1. build: one nvcc call per source (``csrc/linear_attention.cu``,
   ``csrc/flash_attention.cu``, ``csrc/tap_conv.cu`` and
   ``csrc/gemm_probes.cu``), started together; each one's seconds and the
   ``-Xptxas -v`` register / shared-memory / spill summary of every template;
2. kernel check, each kernel against its plain PyTorch version on the card,
   each case held to a tolerance scaled to its own values:
   - K1 (folded context) and K2 (folded projection) at batch 8 x {262144,
     32768, 4096} tokens x 128 (the 64³, 32³ and 16³ stages), a ragged
     4096 + 37, a cross-head logit spread and a 64³ case whose memory tokens
     carry most of the softmax weight; their general path at b2 x 32768 with
     8 x 32, 4 x 64 and 2 x 64 heads in bf16 and 4 x 32 in f32;
   - K3 (flash attention), out and lse, at b8 and b4 x 4096 queries x 4100
     keys x 4 heads x 32 (the fa16 stage), a ragged 1024 + 37 queries x
     1024 + 41 keys, a peaked softmax (q x 8), at b2 x 4096 x 4100 with
     d in {8, 16, 48, 128} in bf16 and d = 32 in f32, and the bf16
     tensor-core path's edges: b2 x 1061 x 1065 at d in {8, 24, 40, 64, 128},
     b3 x 5 queries x 9 keys (under one key tile) and b1 x 4096 x 4100;
   - K4a (v1 context) and K4b (v1 projection) at b8 x {262144, 32768} queries
     with 4 more keys, a ragged b2 x 32768 + 37, a peaked k (x 8), a 64³ case
     whose 4 memory tokens carry most of the weight, and b8 x 32768 in f32;
3. kernel times: each kernel, its plain version and (K3) one PyTorch call of
   the same function (``scaled_dot_product_attention``) at the main paths'
   shapes (CUDA events around 20 back-to-back launches after a warm-up,
   median of 5 such rounds; 2 launches and 3 rounds for a plain version)
   beside the card's bound (bytes, products, or for K3 the exponentials);
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
   ``tools/bench_tap_conv.py``; the path, ``tap_conv3d`` forward and backward
   at [8, 64³, 48 -> 48] bf16 (K5a 2, K5b 1), with dx, dw and db against the
   plain backward and autograd of the f32 ``F.conv3d``; K5b against its plain
   version at [8, 64³] with Cin 48 and 18, and on a [2, 8, 16, 24] volume at
   Cin in {8, 96} x Cout in {8, 48, 128} bf16 (the box path's edges) and 18 ->
   48 f32 (the chunked kernel), each twice (identical dw); K5a and K5b times
   beside ``F.conv3d`` and
   ``torch.nn.grad.conv3d_weight``; then the tool's six cases;
4c. the GEMM probes: P1, both layouts, at its four shapes (M = 524,288)
   against its plain version, and P2 at its ten cases at R = 40 against its
   plain version; their times (P1 beside ``torch.matmul``, P2 at (2048, 1296,
   48, 16) with R = 256); then the tools ``bench_gemm`` and
   ``bench_mma_shapes`` in full;
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
6. forward at the benchmark's batch: b8 x 64³ UNet forwards, 1 warm-up and 3
   timed, each closed by ``torch.cuda.synchronize()``; then a
   ``torch.profiler`` breakdown of one forward by device time;
7. the v1 path, the third slice's main path: ``LinearAttention(fused=True,
   fused_folded=False)`` at the widths of the flagship's first linear
   attention (dim 48, 4 heads x 32), bf16, seeded weights: 64³ b8 forward,
   64³ b4 forward and backward, 32³ b8 forward, each 1 warm-up and 5 timed
   calls closed by ``torch.cuda.synchronize()``, with the median ms, peak
   memory and launches (K4a 1 and K4b 1 per call), and held against the same
   weights through the folded kernels (K1 + K2), timed the same way;
8. training, the second slice's main path, for the flagship and then for
   fa16: ``init_train_state`` and ``make_train_step`` at 64³, micro-batch 4 x
   accumulation 2, on synthetic batches generated on the card; 2 warm-up and 8
   timed micro-steps, each closed by ``torch.cuda.synchronize()``. Each prints
   the median ms per micro-step, peak memory, the loss and gradient norm (which
   must be finite), the launches per micro-step, and that the params changed on
   the accumulation boundaries only; fa16 adds a ``torch.profiler`` breakdown
   of one micro-step. After the flagship's steps, which leave the model in
   training mode, two samplers from the same x0 must agree exactly.

The launch counts are set to 0 just before each main-path run (phases 4a-4c,
5, 7 and 8) and read just after it. Then one JSON line per kernel (``{"kernels":
[...]}``), the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.data.synthetic import synthetic_geology_batch
from flowtrain_stochastic_interpolation_torch.inference import (
    initial_noise,
    make_sampler,
    sample_unconditional,
)
from flowtrain_stochastic_interpolation_torch.models.attention import Attention, LinearAttention
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.ops import cuda_build
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.ops import gemm_probes as gp
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops import tap_conv as tc
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding
from flowtrain_stochastic_interpolation_torch.tools import bench_gemm as bg
from flowtrain_stochastic_interpolation_torch.tools import bench_mma_shapes as bms
from flowtrain_stochastic_interpolation_torch.tools import bench_tap_conv as btc
from flowtrain_stochastic_interpolation_torch.train.loop import init_train_state
from flowtrain_stochastic_interpolation_torch.train.steps import make_train_step

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
# P2's checks against its plain version run this many products per grid step
# (every window of the 32, 8 of them twice); its times run the tool's R = 256
PROBE_CHECK_REPS = 40
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
# K4a and K4b are held to the same rule: both sides compute in f32 and differ
# only in the order of the sums and in K4a's chunk max.
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
                heads: int = HEADS, d: int = HEAD_DIM, dtype: torch.dtype = torch.bfloat16):
    """q, k, v as column slices of one [B, N, 3·h·d] projection (as the UNet
    hands them over), and the folded memory KV [4, h·d]."""
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
                   dtype: torch.dtype = torch.bfloat16, d: int = HEAD_DIM):
    """As ``LinearAttention``'s v1 path hands them over: q a column slice of a
    [B, N, 3, h, d] projection, and k, v [B, 4 + N, h, d] with the 4 memory
    tokens first (k's shifted up by ``mem_shift``, the keys scaled by ``k_scale``)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, n, 3, HEADS, d, generator=gen, device="cuda")
    qkv[:, :, 1] *= k_scale
    mem = torch.randn(2, N_MEM, HEADS, d, generator=gen, device="cuda")
    mem[0] += mem_shift
    qkv, mem = qkv.to(dtype), mem.to(dtype)
    cat = lambda i: torch.cat([mem[i].expand(batch, -1, -1, -1), qkv[:, :, i + 1]], dim=1)
    return qkv[:, :, 0], cat(0), cat(1)


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


def phase_kernel_check():
    cases = [(f"b{BATCH} x {n}", BATCH, n, {}) for n in STAGE_TOKENS]
    cases += [(f"b{BATCH} x 4096+37 ragged", BATCH, 4096 + 37, {}),
              (f"b{BATCH} x 4096 cross-head spread", BATCH, 4096, dict(spread=True)),
              (f"b{BATCH} x {STAGE_TOKENS[0]} memory-heavy (mem_k + {MEM_SHIFT:g})", BATCH,
               STAGE_TOKENS[0], dict(mem_shift=MEM_SHIFT))]
    worst = {name: 0.0 for name in KERNELS}
    for i, (label, b, n, options) in enumerate(cases):
        q, k, v, mk, mv = make_inputs(b, n, seed=i, **options)
        ctx_plain = la.folded_context_plain(k, v, mk, mv, HEADS)
        ctx = la.folded_context(k, v, mk, mv, HEADS)
        out_plain = la.folded_project_plain(q, ctx_plain, HEADS)
        out = la.folded_project(q, ctx_plain, HEADS)
        torch.cuda.synchronize()
        for name, got, want in (("folded_context", ctx, ctx_plain),
                                ("folded_project", out, out_plain)):
            worst[name] = max(worst[name], compare(name, label, got, want))
        del q, k, v, ctx, ctx_plain, out, out_plain

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

    # K4a and K4b, this slice's kernels
    v1_cases = [(f"b{BATCH} x {n} q x {n + N_MEM} kv", BATCH, n, {}) for n in STAGE_TOKENS[:2]]
    v1_cases += [
        (f"b2 x {STAGE_TOKENS[1]}+37 ragged", 2, STAGE_TOKENS[1] + 37, {}),
        (f"b{BATCH} x {STAGE_TOKENS[1]} peaked (k x 8)", BATCH, STAGE_TOKENS[1],
         dict(k_scale=8.0)),
        (f"b{BATCH} x {STAGE_TOKENS[0]} memory-heavy (mem_k + {MEM_SHIFT:g})", BATCH,
         STAGE_TOKENS[0], dict(mem_shift=MEM_SHIFT)),
        (f"b{BATCH} x {STAGE_TOKENS[1]} float32", BATCH, STAGE_TOKENS[1],
         dict(dtype=torch.float32)),
    ]
    for i, (label, b, n, options) in enumerate(v1_cases):
        q, k, v = make_v1_inputs(b, n, seed=80 + i, **options)
        ctx_plain = la.linear_context_plain(k, v)
        ctx = la.linear_context(k, v)
        out_plain = la.linear_project_plain(q, ctx_plain)
        out = la.linear_project(q, ctx_plain)
        torch.cuda.synchronize()
        check(out.dtype == q.dtype and out.shape == q.shape,
              f"linear_project {label}: output {out.dtype} {tuple(out.shape)}")
        for name, got, want in (("linear_context", ctx, ctx_plain),
                                ("linear_project", out, out_plain)):
            worst[name] = max(worst[name], compare(name, label, got, want))
        del q, k, v, ctx, ctx_plain, out, out_plain
    return worst


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
        products = 2.0 * BATCH * n * WIDTH * (WIDTH // HEADS)
        label = f"b{BATCH} x {n}"
        rows[("folded_context", BATCH, n)] = timed_row(
            "folded_context", label, lambda: la.folded_context(k, v, mk, mv, HEADS),
            lambda: la.folded_context_plain(k, v, mk, mv, HEADS),
            2 * BATCH * n * WIDTH * 2 + 2 * N_MEM * WIDTH * 2 + BATCH * WIDTH * WIDTH * 4,
            products, exps=BATCH * (n + N_MEM) * WIDTH)
        rows[("folded_project", BATCH, n)] = timed_row(
            "folded_project", label, lambda: la.folded_project(q, ctx, HEADS),
            lambda: la.folded_project_plain(q, ctx, HEADS),
            BATCH * n * WIDTH * 2 + BATCH * WIDTH * WIDTH * 4 + BATCH * n * WIDTH * 2, products,
            exps=BATCH * n * WIDTH)
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

    # K4a and K4b: bf16 q, k, v in and out, f32 ctx, f32 products on the FP32 cores
    for n in STAGE_TOKENS[:2]:
        m = n + N_MEM
        q, k, v = make_v1_inputs(BATCH, n, seed=110)
        ctx = la.linear_context_plain(k, v)
        ctx_bytes = BATCH * HEADS * HEAD_DIM * HEAD_DIM * 4
        label = f"b{BATCH} x {n} x {HEADS} x {HEAD_DIM}"
        rows[("linear_context", BATCH, n)] = timed_row(
            "linear_context", label, lambda: la.linear_context(k, v),
            lambda: la.linear_context_plain(k, v), 2 * BATCH * m * WIDTH * 2 + ctx_bytes,
            2.0 * BATCH * m * WIDTH * HEAD_DIM, PEAK_F32_FLOP_PER_S, exps=BATCH * m * WIDTH)
        rows[("linear_project", BATCH, n)] = timed_row(
            "linear_project", label, lambda: la.linear_project(q, ctx),
            lambda: la.linear_project_plain(q, ctx), 2 * BATCH * n * WIDTH * 2 + ctx_bytes,
            2.0 * BATCH * n * WIDTH * HEAD_DIM, PEAK_F32_FLOP_PER_S, exps=BATCH * n * WIDTH)
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
    for batch, side, cin, cout, _ in btc.CASES:
        label = f"b{batch} {side}³ {cin} -> {cout} bf16"
        x, w, b = btc.operands(batch, side, cin, cout, "cuda")
        out = tc.tap_conv_forward(x, w, b)
        want = tc.tap_conv_forward_plain(x, w, b)
        ref = conv_f32(x, w, b)
        torch.cuda.synchronize()
        check(out.dtype == x.dtype and out.shape == ref.shape,
              f"tap_conv_forward {label}: output {out.dtype} {tuple(out.shape)}")
        worst["tap_conv_forward"] = max(worst["tap_conv_forward"],
                                        compare("tap_conv_forward", label, out, want))
        rel = rel_l2(out, ref)
        say("tap conv", f"tap_conv_forward {label} against F.conv3d in f32: relative L2 "
            f"{rel:.3e} (limit {CONV_REF_REL_TOL:g})")
        check(rel <= CONV_REF_REL_TOL, f"tap_conv_forward {label}: {rel:.3e} from F.conv3d")
        del x, w, b, out, want, ref

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
    flops = 2.0 * voxels * 27 * cin * cout
    label = f"b{batch} {side}³ {cin} -> {cout} bf16"
    rows = {
        "tap_conv_forward": timed_row(
            "tap_conv_forward", label, lambda: tc.tap_conv_forward(x, w, b),
            lambda: tc.tap_conv_forward_plain(x, w, b),
            2 * voxels * (cin + cout) + 2 * 27 * cin * cout + 4 * cout, flops,
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
            nbytes, flops = 2 * (bg.M * k + k * n + bg.M * n), 2.0 * bg.M * k * n
            library = dict(library=lambda: torch.matmul(a, b), library_name="torch.matmul")
            rows["gemm_probe"] = timed_row(
                "gemm_probe", label, lambda: gp.gemm_probe(a, b),
                lambda: gp.gemm_probe_plain(a, b), nbytes, flops, **library)
            rows["gemm_probe_t"] = timed_row(
                "gemm_probe_t", label, lambda: gp.gemm_probe_t(a, bt),
                lambda: gp.gemm_probe_t_plain(a, bt), nbytes, flops, **library)
        del a, b, bt

    for m_block, k, n, grid in bms.CASES:
        label = f"({m_block}, {k}, {n}, {grid}) R = {PROBE_CHECK_REPS}"
        a, b = bms.operands(m_block, k, n, grid, "cuda")
        out = gp.mma_probe(a, b, PROBE_CHECK_REPS)
        want = gp.mma_probe_plain(a, b, PROBE_CHECK_REPS)
        torch.cuda.synchronize()
        check(out.shape == (m_block, n), f"mma_probe {label}: shape {tuple(out.shape)}")
        worst["mma_probe"] = max(worst["mma_probe"], compare("mma_probe", label, out, want))
        if (m_block, k, n, grid) == (2048, 1296, 48, 16):  # all 27 taps folded: times at R
            rows["mma_probe"] = timed_row(
                "mma_probe", f"({m_block}, {k}, {n}, {grid}) R = {bms.R}",
                lambda: gp.mma_probe(a, b, bms.R), lambda: gp.mma_probe_plain(a, b, bms.R),
                2 * (a.numel() + b.numel() + m_block * n), 2.0 * m_block * grid * k * n * bms.R)
        del a, b, out, want
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
    launches["bench_mma_shapes"] = read_counts()
    say("gemm probes", f"launches {launches}")
    torch.cuda.empty_cache()
    return rows, launches


# ---------------------------------------------------------------------------
# Sampling (the first slice's main path)
# ---------------------------------------------------------------------------
def seeded_model(cfg, seed: int = 0) -> UNet:
    model = UNet.from_config(cfg.model, device="cuda").eval()
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(seed))
    return model


def reference_check(label, model, cfg, side: int, expected: dict, f32_card: bool = False) -> None:
    """A forward on the card (bf16, kernels) against the same weights in f32 on
    the CPU; with ``f32_card``, also the model at ``dtype="float32"`` on the card,
    whose kernels must take f32 operands."""
    expected = {name: expected.get(name, 0) for name in KERNELS}
    cpu = UNet.from_config(dataclasses.replace(cfg.model, dtype="float32"), device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, side, side, side, cfg.data.embedding_dim, generator=gen)
    t = torch.full((1,), 0.5)  # exact in bf16, which the model casts time to
    reset_counts()
    with torch.inference_mode():
        ref = cpu(x, t)
        got = model(x.cuda().bfloat16(), t.cuda()).cpu()
    launches = read_counts()
    rel = rel_l2(got, ref)
    say("sampling", f"{label} {side}³ b1 forward on the card (bf16, kernels launched {launches}) "
        f"vs f32 on the CPU: relative L2 error {rel:.3e} (tolerance {FORWARD_REL_TOL:g})")
    check(bool(torch.isfinite(got).all()), f"non-finite {label} {side}³ forward")
    check(launches == expected, f"{label} {side}³ forward launches {launches}, expected {expected}")
    check(rel < FORWARD_REL_TOL, f"{label} {side}³ forward relative error {rel:.3e}")
    if not f32_card:
        return
    card = UNet.from_config(dataclasses.replace(cfg.model, dtype="float32"), device="cuda").eval()
    card.load_state_dict(model.state_dict())
    reset_counts()
    with operand_dtypes() as dtypes, torch.inference_mode():
        got = card(x.cuda(), t.cuda()).cpu()
    launches = read_counts()
    rel = rel_l2(got, ref)
    say("sampling", f"{label} {side}³ b1 forward on the card at dtype=float32 (kernels launched "
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


def profile_table(phase: str, fn, label: str, wall_ms: float) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        say(phase, "profiler: no device time recorded (not measured)")
        return
    say(phase, f"profiler: {label}, {total / 1e3:.2f} ms of kernel time in "
        f"{sum(e.count for e in kernels)} launches (unprofiled wall time {wall_ms:.1f} ms); "
        f"top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / total:5.1f}%"
              f"  x{e.count:<5d} {e.key[:100]}", flush=True)


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


def train(label: str, full_attn, per_step: dict, profile: bool = False,
          check_sampler: bool = False) -> dict:
    cfg = unconditional_64()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, full_attn=full_attn),
        data=dataclasses.replace(cfg.data, batch_size=TRAIN_MICRO_BATCH),
        training=dataclasses.replace(cfg.training, accumulate_grad_batches=TRAIN_ACCUM),
    )
    model, tx, state = init_train_state(cfg)
    step = make_train_step(model, tx, cfg)
    gen = torch.Generator(device="cuda").manual_seed(10)
    n_steps = TRAIN_WARMUP + TRAIN_STEPS
    batches = [synthetic_geology_batch(gen, TRAIN_MICRO_BATCH, cfg.data.shape)
               for _ in range(n_steps + 1)]
    check(all(int(b.min()) == -1 and int(b.max()) <= cfg.data.num_categories - 2
              for b in batches), f"{label}: synthetic batches outside [-1, n - 2]")
    params = list(state.params.values())
    snapshot = [torch.empty_like(p) for p in params]
    times, changed, losses, norms = [], [], [], []
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
        losses.append(float(metrics["train_loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    median = statistics.median(times)
    say("train", f"{label} 64³ micro-batch {TRAIN_MICRO_BATCH} x accumulation {TRAIN_ACCUM}: "
        f"{n_steps} micro-steps ({TRAIN_WARMUP} warm-up): {', '.join(f'{t:.1f}' for t in times)} "
        f"ms, median {median:.1f} ms per micro-step; peak {peak:.2f} GiB allocated")
    say("train", f"{label}: train_loss {', '.join(f'{x:.4f}' for x in losses)}; grad_norm "
        f"{', '.join(f'{x:.4f}' for x in norms)}")
    per = {k: v / n_steps for k, v in launches.items()}
    say("train", f"{label}: launches {launches} in {n_steps} micro-steps, {per} per micro-step; "
        f"params changed at micro-steps {[i for i, c in enumerate(changed) if c]} "
        f"(accumulation boundaries every {TRAIN_ACCUM})")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{label}: non-finite loss or gradient norm")
    check(changed == [i % TRAIN_ACCUM == TRAIN_ACCUM - 1 for i in range(n_steps)],
          f"{label}: params changed at {changed}")
    check(state.step == n_steps and state.opt_state.updates == n_steps // TRAIN_ACCUM,
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
    return dict(ms=median, peak_gib=peak, launches=launches)


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {line.strip()}", flush=True)

    worst = phase_kernel_check()
    rows = phase_kernel_times()
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
    phase_forward(model)
    widths = linear_attention_widths(model)
    del model
    torch.cuda.empty_cache()
    launches.update(phase_v1(widths))
    launches["train flagship"] = train(
        "flagship", None, {"folded_context": 6, "folded_project": 6},
        check_sampler=True)["launches"]
    launches["train fa16"] = train(
        "fa16", FA16, {"flash_attention": 2, "folded_context": 4, "folded_project": 4},
        profile=True)["launches"]

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
