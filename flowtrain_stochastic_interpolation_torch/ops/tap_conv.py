"""The tap-folded 3³ convolution: kernels K5a (forward) and K5b (weight
gradient), their plain versions, and the custom VJP.

Port of ``flowtrain_stochastic_interpolation_tpu/ops/tap_conv.py``: a 3³
stride-1 SAME convolution of channels-last ``x [B, X, Y, Z, Cin]`` with
``w [3, 3, 3, Cin, Cout]`` (DHWIO) and ``b [Cout]``, as an implicit GEMM with
the taps folded into the contraction.

* K5a (:func:`tap_conv_forward`): ``w`` rounded to x's dtype, products in
  x's dtype (bf16 or f32) accumulated in f32, the f32 bias added before one
  rounding to x's dtype.
* K5b (:func:`tap_conv_weight_grad`): ``dw``, the f32 correlation of x with
  the output's cotangent g. The C entry point picks the kernel: bf16 with Cin
  and Cout multiples of 8 up to 128 takes the box kernel, every other shape
  the chunked one, and :func:`tap_conv_weight_grad` sizes the scratch of
  per-block partial sums as the library says.
* :func:`tap_conv3d`: both as a ``torch.autograd.Function`` whose backward is
  the JAX package's ``_vjp_bwd``: dx is K5a on g with the flipped,
  channel-transposed kernel (rounded to g's dtype, no bias) cast to x's
  dtype; dw is K5b cast to w's dtype; db is the sum of g over B, X, Y, Z in
  g's dtype (a bf16 g gives a bf16-rounded sum, as ``jnp.sum``), cast to
  b's dtype.

No model calls it: the JAX package keeps it as the measured record of the
tap-folding approach, driven by its own tool, and the port does the same
(:mod:`..tools.bench_tap_conv`). :func:`use_tap_conv` gives the JAX
package's answers, and :func:`tap_conv3d` raises ``ValueError`` on every
shape it rejects. One deliberate difference: on an X that is not a multiple of 8 the
TPU kernel's grid (``xs // 8``) leaves output rows unwritten; the port
raises there, as on every other rejected shape.

Each kernel wrapper takes its plain PyTorch version for tensors on the CPU,
and only then. For CUDA tensors it launches the hand-written kernel in
``csrc/tap_conv.cu`` (built by :mod:`.cuda_build`), or raises: there is no
fallback. :data:`launch_counts` counts the launches, one per wrapper call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from flowtrain_stochastic_interpolation_torch.ops import cuda_build

SOURCE = "tap_conv"
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_COUT = 128          # the public conv's output width (the TPU kernel's lane width)
MAX_CIN = 256           # the TPU kernel's patch scratch bound
KERNEL_MAX_COUT = 256   # K5a's output width: the data gradient's is the conv's Cin
_ROWS_PER_BLOCK, _COLS_PER_BLOCK = 128, 64  # BM, BN of csrc/tile_mma.cuh

launch_counts: Dict[str, int] = {"tap_conv_forward": 0, "tap_conv_weight_grad": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def use_tap_conv(spatial: tuple, cin: int, cout: int, kernel: int, dtype=None) -> bool:
    """Eligibility, as the JAX package's: 3³ kernel, X and Y multiples of 8, Z a
    multiple of 8, Cout ≤ 128, Cin ≤ 256."""
    if kernel != 3 or len(spatial) != 3:
        return False
    xs, ys, zs = spatial
    if xs % 8 or ys % 8 or zs % 8:
        return False
    return cout <= MAX_COUT and cin <= MAX_CIN


# ---------------------------------------------------------------------------
# Plain versions: a sum over the 27 taps of shifted matmuls, in f32
# ---------------------------------------------------------------------------
def _taps(x: torch.Tensor):
    """``(w index, shifted view)`` of the zero-padded f32 x for each of the 27 taps."""
    spatial = x.shape[1:4]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                yield (dx, dy, dz), xp[:, dx:dx + spatial[0], dy:dy + spatial[1],
                                       dz:dz + spatial[2]]


def tap_conv_forward_plain(x: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5a in plain PyTorch: ``[B, X, Y, Z, Cout]`` in x's dtype."""
    wf = w.to(x.dtype).float()
    acc = torch.zeros(*x.shape[:4], w.shape[-1], dtype=torch.float32, device=x.device)
    for tap, shifted in _taps(x):
        acc += torch.matmul(shifted, wf[tap])
    if b is not None:
        acc += b.float()
    return acc.to(x.dtype)


def tap_conv_weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5b in plain PyTorch: f32 ``dw [3, 3, 3, Cin, Cout]``."""
    cin, cout = x.shape[-1], g.shape[-1]
    gf = g.float().reshape(-1, cout)
    dw = torch.empty(3, 3, 3, cin, cout, dtype=torch.float32, device=x.device)
    for tap, shifted in _taps(x):
        dw[tap] = torch.matmul(shifted.reshape(-1, cin).T, gf)
    return dw


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE).library
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tap_conv_forward.argtypes = [vp, vp, vp, vp, i32, ll, i32, i32, i32, i32, i32, vp]
    lib.tap_conv_forward.restype = i32
    lib.tap_conv_weight_grad.argtypes = [vp, vp, vp, vp, i32, ll, i32, i32, i32, i32, i32, ll, vp]
    lib.tap_conv_weight_grad.restype = i32
    lib.tap_conv_weight_grad_slots.argtypes = [i32, ll, i32, i32, i32, i32, i32, ll,
                                               ctypes.POINTER(i32)]
    lib.tap_conv_weight_grad_slots.restype = ll
    return lib


def _check_volume(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """A contiguous, 16-byte aligned bf16 or f32 CUDA ``[B, X, Y, Z, C]`` tensor of
    ``like``'s dtype and volume."""
    if t.device.type != "cuda" or t.device != like.device:
        raise ValueError(f"{name} must be a CUDA tensor on {like.device}, got {t.device}")
    if t.dtype not in KERNEL_DTYPES or t.dtype != like.dtype:
        raise ValueError(f"{name} must be bfloat16 or float32 like x, got {t.dtype}")
    if t.ndim != 5 or t.shape[:4] != like.shape[:4]:
        raise ValueError(f"{name} must be [B, X, Y, Z, C] over x's volume, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned (channels last)")


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def tap_conv_forward(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5a: the 3³ SAME conv ``[B, X, Y, Z, Cout]`` in x's dtype; ``b`` f32-added or none.

    Takes any volume and Cout up to 256 (the data gradient's width); the public
    :func:`tap_conv3d` admits only what :func:`use_tap_conv` does.
    """
    if x.device.type == "cpu":
        return tap_conv_forward_plain(x, w, b)
    _check_volume("x", x, x)
    cin = x.shape[-1]
    if w.ndim != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin) or w.device != x.device:
        raise ValueError(f"w must be [3, 3, 3, {cin}, Cout] on {x.device}, got {tuple(w.shape)}")
    cout = w.shape[-1]
    if not 1 <= cout <= KERNEL_MAX_COUT:
        raise ValueError(f"the kernel takes 1 to {KERNEL_MAX_COUT} output channels, got {cout}")
    if b is not None and (tuple(b.shape) != (cout,) or b.device != x.device):
        raise ValueError(f"b must be [{cout}] on {x.device}, got {tuple(b.shape)}")
    lib = _library()
    with torch.cuda.device(x.device):
        wk = w.to(x.dtype).contiguous()  # the rounding of w to x's dtype
        bias = None if b is None else b.float().contiguous()
        out = torch.empty(*x.shape[:4], cout, dtype=x.dtype, device=x.device)
        voxels = x.numel() // cin
        if voxels == 0:
            return out
        code = lib.tap_conv_forward(
            x.data_ptr(), wk.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), int(x.dtype == torch.float32), voxels, *x.shape[1:4], cin, cout,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(code, "tap_conv_forward")
    launch_counts["tap_conv_forward"] += 1
    return out


def _weight_chunk(voxels: int, tiles: int, device: torch.device) -> int:
    """Voxels per partial block of K5b's chunked kernel: 65,536, halved (down
    to 1024) until the grid (``tiles`` blocks per chunk) covers the SMs four
    times. A multiple of the kernel's 64-voxel slice. The box kernel ignores it."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunk = 65536
    while chunk > 1024 and tiles * -(-voxels // chunk) < 4 * sms:
        chunk //= 2
    return chunk


def tap_conv_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5b: f32 ``dw [3, 3, 3, Cin, Cout]``, the correlation of x with g."""
    if x.device.type == "cpu":
        return tap_conv_weight_grad_plain(x, g)
    _check_volume("x", x, x)
    _check_volume("g", g, x)
    cin, cout = x.shape[-1], g.shape[-1]
    lib = _library()
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        voxels = x.numel() // cin
        if voxels == 0:
            return torch.zeros(3, 3, 3, cin, cout, **f32)
        tiles = -(-27 * cin // _ROWS_PER_BLOCK) * -(-cout // _COLS_PER_BLOCK)
        chunk = _weight_chunk(voxels, tiles, x.device)
        # the scratch's slots, as the C entry point will use them (it picks the kernel)
        err = ctypes.c_int(0)
        slots = lib.tap_conv_weight_grad_slots(int(x.dtype == torch.float32), voxels,
                                               *x.shape[1:4], cin, cout, chunk, ctypes.byref(err))
        _raise_on(err.value, "tap_conv_weight_grad_slots")
        part = torch.empty(slots, 27 * cin, cout, **f32)
        dw = torch.empty(3, 3, 3, cin, cout, **f32)
        code = lib.tap_conv_weight_grad(
            x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(),
            int(x.dtype == torch.float32), voxels, *x.shape[1:4], cin, cout, chunk,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(code, "tap_conv_weight_grad")
    launch_counts["tap_conv_weight_grad"] += 1
    return dw


# ---------------------------------------------------------------------------
# The custom VJP
# ---------------------------------------------------------------------------
class _TapConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return tap_conv_forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # the SAME conv of g with the spatially flipped, channel-transposed kernel
            w_flip = torch.flip(w, (0, 1, 2)).transpose(3, 4).to(g.dtype)
            dx = tap_conv_forward(g, w_flip).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tap_conv_weight_grad(x, g).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(g.dtype).to(ctx.b_dtype)
        return dx, dw, db


def tap_conv3d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3³ stride-1 SAME conv of ``[B, X, Y, Z, Cin]`` with ``[3, 3, 3, Cin, Cout]``
    and ``[Cout]``, differentiable; ``[B, X, Y, Z, Cout]`` in x's dtype.

    Raises ``ValueError`` on every shape that :func:`use_tap_conv` rejects.
    """
    if x.ndim != 5 or w.ndim != 5 or w.shape[3] != x.shape[-1] or b.shape != w.shape[-1:]:
        raise ValueError(
            f"x [B, X, Y, Z, Cin], w [k, k, k, Cin, Cout] and b [Cout], got "
            f"{tuple(x.shape)}, {tuple(w.shape)} and {tuple(b.shape)}"
        )
    if len(set(w.shape[:3])) != 1 or not use_tap_conv(tuple(x.shape[1:4]), x.shape[-1],
                                                         w.shape[-1], w.shape[0]):
        raise ValueError(
            f"tap_conv3d takes a 3³ kernel, X, Y and Z multiples of 8, Cout <= {MAX_COUT} and "
            f"Cin <= {MAX_CIN}; got x {tuple(x.shape)} and w {tuple(w.shape)}"
        )
    return _TapConv3d.apply(x, w, b)
