"""Correctness and speed of the tap-folded conv (K5a, K5b) against cuDNN's conv.

Counterpart of the JAX package's ``tools/bench_tap_conv.py``, with its six
cases: the flagship UNet's hot convs (64³ and 32³ at 48 channels, 16³ at 96,
batch 8), the up-path concat conv (32³, 96 → 48), the 128³ sampling shape
(batch 1) and the 18-channel input class (64³, 18 → 48), bf16. For each it
prints the time per conv of :func:`~..ops.tap_conv.tap_conv3d` and of the
yardstick, with their rates and the relative error of the first against the
second; the first case also the gradients' errors and the forward + backward
time (dx, dw and db).

The yardstick is ``F.conv3d`` (cuDNN) on the ``channels_last_3d`` layout in
x's dtype with the bias, the call the port's ``Conv3d`` makes. The port's
model never calls the tap-folded conv: this is a study, as in the JAX package.

The time per conv is the slope between 12 and 4 back-to-back calls (the JAX
tool chains 12 and 4 convs in one program), each count timed with CUDA events,
the least of 5 after 2 warm-ups.

    python -m flowtrain_stochastic_interpolation_torch.tools.bench_tap_conv
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.ops.tap_conv import tap_conv3d
from flowtrain_stochastic_interpolation_torch.tools.timing import device_line, slope_ms

# (batch, side, Cin, Cout, with the gradient): the JAX tool's cases, in its order
CASES = (
    (8, 64, 48, 48, True),
    (8, 32, 48, 48, False),
    (8, 32, 96, 48, False),   # up-path concat conv
    (8, 16, 96, 96, False),
    (1, 128, 48, 48, False),  # 128³ sampling shape
    (8, 64, 18, 48, False),   # the 18-channel input class
)
R_HI, R_LO = 12, 4


def cudnn_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``F.conv3d`` of channels-last ``x`` with DHWIO ``w`` and ``b``, in x's dtype,
    as ``[B, X, Y, Z, Cout]`` (a view of cuDNN's channels_last_3d output)."""
    wc = w.to(x.dtype).permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wc, b.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 4, 1)


def operands(batch: int, side: int, cin: int, cout: int, device, dtype=torch.bfloat16):
    """The JAX tool's operands: x ~ N(0, 1), w ~ N(0, 1) / (27 Cin)^½ in x's
    dtype, b ~ 0.1 N(0, 1) in f32; seeded."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(batch, side, side, side, cin, generator=gen, device=device).to(dtype)
    w = torch.randn(3, 3, 3, cin, cout, generator=gen, device=device) * (27 * cin) ** -0.5
    b = torch.randn(cout, generator=gen, device=device) * 0.1
    return x, w.to(dtype), b


def _max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (want.abs().max() + 1e-9)).item()


def check_and_bench(batch: int, side: int, cin: int, cout: int, grad: bool = False,
                    device=None) -> Dict[str, float]:
    """One case: prints its line(s) and returns the numbers (ms per conv, TF/s,
    relative errors)."""
    device = resolve_device(device)
    x, w, b = operands(batch, side, cin, cout, device)
    flops = 2 * batch * side**3 * 27 * cin * cout
    with torch.no_grad():
        err = _max_rel(tap_conv3d(x, w, b), cudnn_conv(x, w, b))
        tap_ms = slope_ms(lambda: tap_conv3d(x, w, b), R_HI, R_LO)
        ref_ms = slope_ms(lambda: cudnn_conv(x, w, b), R_HI, R_LO)
    row = dict(tap_ms=tap_ms, cudnn_ms=ref_ms, tap_tflops=flops / tap_ms / 1e9,
               cudnn_tflops=flops / ref_ms / 1e9, rel_err=err)
    print(f"b{batch} {side}^3 {cin}->{cout} fwd : tap {tap_ms:7.3f} ms "
          f"({row['tap_tflops']:5.1f} TF/s) | cudnn {ref_ms:7.3f} ms "
          f"({row['cudnn_tflops']:5.1f} TF/s) | {ref_ms / tap_ms:4.2f}x | rel.err {err:.2e}",
          flush=True)
    if not grad:
        return row

    def gradients(conv):
        xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, b))
        torch.sum(conv(xs, ws, bs).float() ** 2).backward()
        return xs.grad, ws.grad, bs.grad

    for name, got, want in zip(("dx", "dw", "db"), gradients(tap_conv3d), gradients(cudnn_conv)):
        row[f"{name}_rel_err"] = _max_rel(got, want)
        print(f"    {name} rel.err {row[f'{name}_rel_err']:.2e}", flush=True)
    gy = torch.randn(x.shape[:4] + (cout,), generator=torch.Generator(device=device).manual_seed(3),
                     device=device).to(x.dtype)

    def forward_backward(conv):
        xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, b))
        conv(xs, ws, bs).backward(gy)

    tap_ms = slope_ms(lambda: forward_backward(tap_conv3d), R_HI, R_LO)
    ref_ms = slope_ms(lambda: forward_backward(cudnn_conv), R_HI, R_LO)
    row.update(grad_tap_ms=tap_ms, grad_cudnn_ms=ref_ms)
    print(f"    fwd+bwd/conv: tap {tap_ms:7.3f} ms ({3 * flops / tap_ms / 1e9:5.1f} TF/s) | "
          f"cudnn {ref_ms:7.3f} ms ({3 * flops / ref_ms / 1e9:5.1f} TF/s) | "
          f"{ref_ms / tap_ms:4.2f}x", flush=True)
    return row


def main() -> None:
    device = resolve_device()
    torch.backends.cudnn.allow_tf32 = False
    print(device_line(), flush=True)
    for batch, side, cin, cout, grad in CASES:
        check_and_bench(batch, side, cin, cout, grad=grad, device=device)


if __name__ == "__main__":
    main()
