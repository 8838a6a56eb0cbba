"""K3's design choices on the card: variants of ``csrc/flash_attention.cu``
timed in turns beside the kernel as it stands.

Each variant is the source with a few lines substituted, built by its own
``nvcc`` call into ``_build/`` and launched through the same C entry point.
The layout variants keep the kernel's numerics (each is checked against the
plain version): one 16-row tile per warp with 8 or 4 warps, two with 8
warps, 32 keys per tile, a launch bound of 4 blocks per SM, a ring of 2
stages. Two variants are diagnostic and give wrong outputs on purpose: one
drops the p_lo product of p·v, one drops the exponential; their gains are what
that work costs. All run on the bf16 path at the fa16 stage (b8 and b4 x 4096
queries x 4100 keys x 4 heads x 32), in the order A B ... B A, each time the
least of 5 after 2 warm-ups of 20 back-to-back launches, beside
``scaled_dot_product_attention`` on the same tensors.

    python -m flowtrain_stochastic_interpolation_torch.tools.ab_flash_attention
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops import cuda_build
from flowtrain_stochastic_interpolation_torch.ops import flash_attention as fa
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms, device_line

CALLS = 20
HEADS, D, N, M = 4, 32, 4096, 4100
_ROW_TILES = "static constexpr int MT = D <= 32 ? 2 : 1;"
_WARPS = "static constexpr int WARPS = 4;"
_LOW_PRODUCT = ("        mma(o[mt][2 * np], lo[mt], vf[0], vf[1]);\n",
                "        mma(o[mt][2 * np + 1], lo[mt], vf[2], vf[3]);\n")
# name -> (substitutions, whether the outputs are held to the plain version)
VARIANTS: Dict[str, Tuple[List[Tuple[str, str]], bool]] = {
    "1 row tile x 8 warps": ([(_ROW_TILES, "static constexpr int MT = 1;"),
                              (_WARPS, "static constexpr int WARPS = D <= 32 ? 8 : 4;")], True),
    "1 row tile x 4 warps": ([(_ROW_TILES, "static constexpr int MT = 1;")], True),
    "2 row tiles x 8 warps": ([(_WARPS, "static constexpr int WARPS = D <= 32 ? 8 : 4;")], True),
    "32 keys per tile": ([("static constexpr int KT = 64;", "static constexpr int KT = 32;")],
                         True),
    "launch bound 4 blocks": ([("__launch_bounds__(MmaShape<D>::THREADS)",
                                "__launch_bounds__(MmaShape<D>::THREADS, 4)")], True),
    "2 stages": ([("static constexpr int STAGES = D <= 64 ? 3 : 2;",
                   "static constexpr int STAGES = 2;")], True),
    "no p_lo product (wrong)": ([(line, "") for line in _LOW_PRODUCT], False),
    "no exponential (wrong)": ([("const float p = exp2_approx(fmaf(", "const float p = (fmaf(")],
                               False),
}


def variant_source(subs: List[Tuple[str, str]]) -> str:
    """The kernel source with ``subs`` applied; raises if one no longer applies."""
    text = (cuda_build.SOURCE_DIR / f"{fa.SOURCE}.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Build every variant, one nvcc each, all started together."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    jobs = {}
    for name, (subs, _) in VARIANTS.items():
        text = variant_source(subs)
        digest = hashlib.sha256(text.encode()).hexdigest()[:12]
        # beside the original source, so that its headers resolve
        source = cuda_build.SOURCE_DIR / f"_ab_{digest}.cu"
        source.write_text(text)
        library = cuda_build.BUILD_DIR / f"libab_flash-{digest}.so"
        cmd = cuda_build.build_command(source, library, nvcc)
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), source, library)
    libs = {}
    for name, (proc, source, library) in jobs.items():
        log, _ = proc.communicate()
        source.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        registers = [line.split("Used ")[1].split(",")[0] for line in log.splitlines()
                     if "Used" in line and "registers" in line]
        print(f"built {name}: registers per template {registers}", flush=True)
        lib = ctypes.CDLL(str(library))
        lib.flash_attention_forward.argtypes = fa._library().flash_attention_forward.argtypes
        lib.flash_attention_forward.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib: ctypes.CDLL, q, k, v):
    """``(out, lse)`` from a variant's C entry point, as the K3 wrapper launches it."""
    b, n, h, d = q.shape
    out = torch.empty(b, n, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device)
    code = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], out.data_ptr(), lse.data_ptr(), b, h, n, k.shape[1], d, 0, d**-0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"launch failed: CUDA error {code}")
    return out, lse


def operands(batch: int, device):
    """q a column slice of a [B, N, 3, h, d] projection, k and v [B, M, h, d], bf16; seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn(batch, N, 3, HEADS, D, generator=gen, device=device)
    k = torch.randn(batch, M, HEADS, D, generator=gen, device=device)
    v = torch.randn(batch, M, HEADS, D, generator=gen, device=device)
    return qkv.to(torch.bfloat16)[:, :, 0], k.to(torch.bfloat16), v.to(torch.bfloat16)


def main() -> None:
    device = resolve_device()
    print(device_line(), flush=True)
    libs = {"kernel": fa._library(), **build_variants()}
    for batch in (8, 4):
        q, k, v = operands(batch, device)
        want, want_lse = fa.flash_attention_plain(q, k, v)
        rms = want.float().square().mean().sqrt().item()
        times: Dict[str, List[float]] = {}
        for name in [*libs, *reversed(libs)]:
            out, lse = launch(libs[name], q, k, v)
            if name == "kernel" or VARIANTS[name][1]:  # K3's rule, as chip_smoke.py holds it
                err = (out.float() - want.float()).abs()
                bad = int((err > 1e-3 * rms + 2.0**-7 * want.float().abs()).sum())
                bad += int(((lse - want_lse).abs() > 1e-4 + 1e-5 * want_lse.abs()).sum())
                if bad:
                    raise RuntimeError(f"{name}: {bad} values outside K3's tolerance")
            times.setdefault(name, []).append(
                best_ms(lambda: launch(libs[name], q, k, v), CALLS) / CALLS)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = best_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), CALLS) / CALLS
        print(f"b{batch} x {N} q x {M} kv x {HEADS} x {D} bf16: scaled_dot_product_attention "
              f"{sdpa:.4f} ms", flush=True)
        for name, ms in times.items():
            print(f"    {name:26s} {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
        del q, k, v, want, want_lse


if __name__ == "__main__":
    main()
