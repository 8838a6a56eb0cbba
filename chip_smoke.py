#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``flowtrain_stochastic_interpolation_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on one flushed line with the seconds since start:

0. device: the card's name and power limit (nvidia-smi) and the device count;
   no CUDA device -> exit 1 with a message that says so;
1. build: the one nvcc call for ``csrc/linear_attention.cu``, its wall seconds
   and the ``-Xptxas -v`` register / shared-memory / spill summary;
2. kernel check: K1 (folded context) and K2 (folded projection) against their
   plain PyTorch versions on the card, at batch 8 x {262144, 32768, 4096}
   tokens x 128 (the 64³, 32³ and 16³ stages), a ragged 4096 + 37, a
   cross-head logit spread and a 64³ case whose memory tokens carry most
   of the softmax weight; each case is held to a tolerance scaled to
   its own values;
3. kernel times: each kernel and its plain version at the three stage shapes
   (CUDA events around 20 back-to-back launches after a warm-up, median of
   5 such rounds) beside the card's bound;
4. main path: the ``unconditional_64`` UNet at full width, seeded random
   weights, bf16 compute, through ``sample_unconditional`` at 64³ x batch 2,
   RK4 with 3 frames and 1 substep (8 velocity evaluations). The launch
   counts of K1 and K2 are set to 0 just before and read just after: each
   must be 6 stages x 8 evaluations = 48. Then a reference check: a 16³
   forward on the card (bf16, kernels) against the same weights in f32 on the
   CPU (plain path);
5. forward at the benchmark's batch: b8 x 64³ UNet forwards, 1 warm-up and 3
   timed, each closed by ``torch.cuda.synchronize()``; then a
   ``torch.profiler`` breakdown of one forward by device time.

Then one JSON line per kernel (``{"kernels": [...]}``), the nvidia-smi line,
and last ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from flowtrain_stochastic_interpolation_torch.config import unconditional_64
from flowtrain_stochastic_interpolation_torch.inference import sample_unconditional
from flowtrain_stochastic_interpolation_torch.models.unet import UNet
from flowtrain_stochastic_interpolation_torch.ops import cuda_build
from flowtrain_stochastic_interpolation_torch.ops import linear_attention as la
from flowtrain_stochastic_interpolation_torch.ops.embedding import simplex_embedding

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate and bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12

BATCH = 8
STAGE_TOKENS = (262144, 32768, 4096)  # 64³, 32³, 16³
HEADS, WIDTH, N_MEM = 4, 128, 4
# kernel vs plain version, scaled to each case's values (they shrink as
# 1/sqrt(N) with the tokens): the same bf16 roundings, but K1 rounds exp(k - m)
# with each chunk's max where the plain version uses the global max, sums run
# in another order, and K2's bf16 output may differ by an ulp or two (2^-7
# relative each). Elementwise |kernel - plain| <= atol_frac·RMS + rtol·|plain|,
# with RMS that of the plain values on the head-diagonal blocks, and
# ||kernel - plain|| <= rel_l2·||plain||; K1 must be exactly 0 off those blocks.
TOL = {
    "folded_context": dict(atol_frac=3e-2, rtol=1e-2, rel_l2=1e-2),
    "folded_project": dict(atol_frac=3e-2, rtol=2e-2, rel_l2=1e-2),
}
# the memory-heavy case: mem_k shifted up so that the 4 memory tokens outweigh
# 262,144 standard-normal keys (e^12 ≈ 1.6e5)
MEM_SHIFT = 12.0
# the bf16 forward on the card against the f32 forward on the CPU: relative L2
# error (measured ~1e-2 with the CPU's plain path in bf16)
FORWARD_REL_TOL = 3e-2
SOURCE = "flowtrain_stochastic_interpolation_torch/csrc/linear_attention.cu"
REPLACES = {
    "folded_context": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:218",
    "folded_project": "flowtrain_stochastic_interpolation_tpu/ops/linear_attention.py:283",
}

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


# ---------------------------------------------------------------------------
# Kernel inputs, checks and times
# ---------------------------------------------------------------------------
def make_inputs(batch: int, n: int, seed: int, spread: bool = False, mem_shift: float = 0.0):
    """q, k, v as column slices of one [B, N, 384] bf16 projection (as the UNet
    hands them over), and the folded memory KV [4, 128]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(batch, n, 3 * WIDTH, generator=gen, device="cuda")
    mem = torch.randn(2, N_MEM, WIDTH, generator=gen, device="cuda")
    mem[0] += mem_shift
    if spread:
        # one head's logits far below another's, in q and in k
        d = WIDTH // HEADS
        for part in (0, 1):
            cols = slice(part * WIDTH, (part + 1) * WIDTH)
            block = qkv[..., cols]
            block[..., :d] -= 200.0
            block[..., 3 * d:] += 50.0
    qkv = qkv.to(torch.bfloat16)
    mem = mem.to(torch.bfloat16)
    q, k, v = qkv[..., :WIDTH], qkv[..., WIDTH:2 * WIDTH], qkv[..., 2 * WIDTH:]
    return q, k, v, mem[0].contiguous(), mem[1].contiguous()


def head_diagonal(width: int, device) -> torch.Tensor:
    """[width, width] mask of the per-head diagonal blocks."""
    head = torch.arange(width, device=device) // (width // HEADS)
    return head[:, None] == head[None, :]


def compare(name: str, label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a kernel's output to its plain version's; returns the max abs error."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
    if name == "folded_context":
        diag = head_diagonal(want.shape[-1], want.device)
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
    rel_l2 = ((got - want).norm() / want.norm()).item()
    say("kernel check", f"{name} {label}: RMS {rms:.3e}, max abs err {max_abs:.3e} "
        f"({max_abs / rms:.3e} of RMS), relative L2 {rel_l2:.3e} (limit {tol['rel_l2']:g}); "
        f"{n_bad} outside {tol['atol_frac']:g}·RMS + {tol['rtol']:g}·|plain|")
    check(n_bad == 0, f"{name} {label}: {n_bad} elements outside the tolerance")
    check(rel_l2 <= tol["rel_l2"], f"{name} {label}: relative L2 error {rel_l2:.3e}")
    return max_abs


def phase_kernel_check():
    cases = [(f"b{BATCH} x {n}", BATCH, n, {}) for n in STAGE_TOKENS]
    cases += [(f"b{BATCH} x 4096+37 ragged", BATCH, 4096 + 37, {}),
              (f"b{BATCH} x 4096 cross-head spread", BATCH, 4096, dict(spread=True)),
              (f"b{BATCH} x {STAGE_TOKENS[0]} memory-heavy (mem_k + {MEM_SHIFT:g})", BATCH,
               STAGE_TOKENS[0], dict(mem_shift=MEM_SHIFT))]
    worst = {"folded_context": 0.0, "folded_project": 0.0}
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


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel_times():
    rows = {}
    for n in STAGE_TOKENS:
        q, k, v, mk, mv = make_inputs(BATCH, n, seed=100)
        ctx = la.folded_context_plain(k, v, mk, mv, HEADS)
        products = 2.0 * BATCH * n * WIDTH * (WIDTH // HEADS)
        work = {
            "folded_context": (
                lambda: la.folded_context(k, v, mk, mv, HEADS),
                lambda: la.folded_context_plain(k, v, mk, mv, HEADS),
                2 * BATCH * n * WIDTH * 2 + 2 * N_MEM * WIDTH * 2 + BATCH * WIDTH * WIDTH * 4,
            ),
            "folded_project": (
                lambda: la.folded_project(q, ctx, HEADS),
                lambda: la.folded_project_plain(q, ctx, HEADS),
                BATCH * n * WIDTH * 2 + BATCH * WIDTH * WIDTH * 4 + BATCH * n * WIDTH * 2,
            ),
        }
        for name, (kernel, plain, nbytes) in work.items():
            ms = time_ms(kernel)
            plain_ms = time_ms(plain)
            bound_ms, bound_by = bound(nbytes, products)
            rows[(name, n)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            say("kernel times", f"{name} b{BATCH} x {n}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), library null")
        del q, k, v, ctx
    return rows


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------
def phase_main_path():
    cfg = unconditional_64()
    model = UNet.from_config(cfg.model, device="cuda").eval()
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    table = torch.from_numpy(simplex_embedding(cfg.data.num_categories, cfg.data.embedding_dim))
    kwargs = dict(n_samples=2, batch_size=2, data_shape=(64, 64, 64),
                  embedding_dim=cfg.data.embedding_dim, seed=0, device="cuda",
                  state_dtype=torch.bfloat16, verbose=False, t0=cfg.inference.t0,
                  tf=cfg.inference.tf, n_frames=3, substeps=1, method="rk4",
                  keep_trajectory=True)
    torch.cuda.reset_peak_memory_stats()
    la.reset_launch_counts()
    result = sample_unconditional(model, table, **kwargs)
    launches = dict(la.launch_counts)
    nfe = result.nfe
    say("main path", f"sample_unconditional 64³ b2 rk4 n_frames=3 substeps=1: nfe {nfe}, "
        f"{result.seconds_per_batch[0]:.3f} s, {result.seconds_per_batch[0] / nfe * 1e3:.1f} "
        f"ms per evaluation (first call, cuDNN set-up included), launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(nfe == 8, f"expected 8 velocity evaluations, got {nfe}")
    for name, count in launches.items():
        check(count == 6 * nfe, f"{name} launched {count} times in the main path, expected {6 * nfe}")
    check(result.decoded.shape == (2, 64, 64, 64), f"decoded shape {result.decoded.shape}")
    final = result.trajectory[-1]
    check(final.shape == (2, 64, 64, 64, 18), f"final state shape {final.shape}")
    check(bool(np.isfinite(final).all()), "non-finite final state")
    counts = [int((result.decoded == c).sum()) for c in range(cfg.data.num_categories)]
    say("main path", f"decoded [2, 64, 64, 64], finite final state (|x| max "
        f"{float(np.abs(final).max()):.3f}); category counts {counts}")

    # reference: the same weights in f32 on the CPU (plain attention, CPU conv)
    cpu = UNet.from_config(dataclasses.replace(cfg.model, dtype="float32"), device="cpu").eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 16, 16, 18, generator=gen)
    t = torch.full((1,), 0.5)  # exact in bf16, which the model casts time to
    la.reset_launch_counts()
    with torch.inference_mode():
        ref = cpu(x, t)
        got = model(x.cuda().bfloat16(), t.cuda()).cpu()
    ref_launches = dict(la.launch_counts)
    rel = ((got - ref).norm() / ref.norm()).item()
    say("main path", f"16³ b1 forward on the card (bf16, kernels launched {ref_launches}) vs "
        f"f32 on the CPU: relative L2 error {rel:.3e} (tolerance {FORWARD_REL_TOL:g})")
    check(bool(torch.isfinite(got).all()), "non-finite 16³ forward")
    check(all(c == 2 for c in ref_launches.values()), f"16³ forward launches {ref_launches}")
    check(rel < FORWARD_REL_TOL, f"16³ forward relative error {rel:.3e}")
    return model, launches


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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x, t)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        say("forward", "profiler: no device time recorded (not measured)")
        return fwd_ms
    say("forward", f"profiler: one b{BATCH} forward, {total / 1e3:.2f} ms of kernel time in "
        f"{sum(e.count for e in kernels)} launches; top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {100 * e.self_device_time_total / total:5.1f}%"
              f"  x{e.count:<5d} {e.key[:100]}", flush=True)
    return fwd_ms


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

    build = cuda_build.load(la.SOURCE)
    summary = [line.strip() for line in build.log.splitlines()
               if "registers" in line or "spill" in line or "Compiling entry" in line]
    say("build", f"nvcc {build.seconds:.1f} s -> {build.path.name}")
    for line in summary:
        print(f"    {line}", flush=True)

    worst = phase_kernel_check()
    rows = phase_kernel_times()
    model, launches = phase_main_path()
    phase_forward(model)

    kernels = []
    for name in ("folded_context", "folded_project"):
        row = rows[(name, STAGE_TOKENS[0])]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
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
