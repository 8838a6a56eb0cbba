"""Where the flagship forward's time goes: ablations and the parts alone.

Port of the root ``tools/profile_breakdown.py``, with the same rows, timed
with CUDA events on the card (``tools.timing.best_ms``: the least of 5 after
2 warm-ups; the host clock on the CPU), at batch ``--batch``:

* the full b8 forward of ``unconditional_64`` (seeded weights, bf16 compute)
  and the same with ``attn_enabled=False`` (``--quick`` stops here);
* ``LinearAttention`` (4 heads × 32) at the first three stages (64³ × 48,
  32³ × 48, 16³ × 96), the four convolution shapes with their TF/s (3³
  48 → 48 at 64³, the 7³ init conv 18 → 48, 3³ 48 → 48 at 32³, 96 → 96 at
  16³), ``resize3d`` up and down, the 64³ qkv projection 48 → 384;
* a ResnetBlock at 64³ and 32³ beside its two convs alone and RMSNorm alone,
  then Downsample and Upsample;
* the attention share of the forward.

The stages follow the preset (``--preset tiny`` for a CPU drive).

    python -m flowtrain_stochastic_interpolation_torch.tools.profile_breakdown \\
        [--batch 8] [--quick] [--preset tiny --device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from flowtrain_stochastic_interpolation_torch.config import tiny_test, unconditional_64
from flowtrain_stochastic_interpolation_torch.device import resolve_device
from flowtrain_stochastic_interpolation_torch.models.attention import LinearAttention
from flowtrain_stochastic_interpolation_torch.models.layers import (
    Dense,
    Downsample,
    ResnetBlock,
    RMSNorm,
    Upsample,
    conv_nd,
)
from flowtrain_stochastic_interpolation_torch.models.resize import resize3d
from flowtrain_stochastic_interpolation_torch.tools.timing import best_ms_on
from flowtrain_stochastic_interpolation_torch.train.loop import init_model_variables

BF16 = torch.bfloat16


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--quick", action="store_true", help="skip microbenches")
    ap.add_argument("--preset", default="flagship", choices=["flagship", "tiny"])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b = args.batch
    config = tiny_test() if args.preset == "tiny" else unconditional_64()
    e = config.data.embedding_dim
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def seeded(module):
        """``module`` with every parameter drawn from one seeded generator."""
        init = torch.Generator(device=dev).manual_seed(0)
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(init)
        return module

    x = randn(b, *config.data.shape, e)
    t = torch.full((b,), 0.5, device=dev)
    results: Dict[str, float] = {}

    def row(tag: str, fn: Callable[[], object],
            per: Optional[Callable[[float], str]] = None) -> float:
        with torch.inference_mode():
            ms = best_ms_on(dev, fn)
        results[tag] = ms
        print(f"{tag:40s} {ms:8.3f} ms{per(ms) if per else ''}", flush=True)
        return ms

    def bench_model(tag: str, **overrides) -> float:
        cfg = dataclasses.replace(config, model=dataclasses.replace(config.model, **overrides))
        model = init_model_variables(cfg, device=dev).eval()
        return row(tag, lambda: model(x, t), lambda ms: f"  ({ms / b:6.3f} ms/sample)")

    full = bench_model("full forward (bf16)")
    bench_model("no attention", attn_enabled=False)
    if not args.quick:
        _microbenches(config, b, dev, randn, seeded, row)
    attn = full - results["no attention"]
    print(f"\nattention share of forward: {attn:.3f} ms ({100 * attn / full:.0f}%)")
    return results


def _microbenches(config, b: int, dev, randn, seeded, row) -> None:
    mc = config.model
    side = config.data.shape[0]
    stages = [(side >> i, mc.dim * m) for i, m in enumerate(mc.dim_mults)]
    stages += stages[-1:] * (3 - len(stages))  # a preset of fewer stages repeats its last
    heads, dh = mc.attn_heads, mc.attn_dim_head

    for res, ch in stages[:3]:
        xx = randn(b, res, res, res, ch, dtype=BF16)
        la = seeded(LinearAttention(ch, heads, dh, dtype=BF16, device=dev))
        row(f"linear_attn {res}^3 c{ch}", lambda: la(xx))

    (r0, c0), (r1, c1), (r2, c2) = stages[:3]
    for res, cin, cout, k in ((r0, c0, c0, 3), (r0, config.data.embedding_dim, c0, 7),
                              (r1, c1, c1, 3), (r2, c2, c2, 3)):
        xx = randn(b, res, res, res, cin, dtype=BF16)
        conv = seeded(conv_nd(cin, cout, k, dtype=BF16, device=dev))
        flops = 2 * b * res**3 * k**3 * cin * cout
        row(f"conv{k} {res}^3 {cin}->{cout}", lambda: conv(xx),
            lambda ms: f"  ({flops / ms / 1e9:6.1f} TFLOP/s)")

    for res, ch, scale in ((r1, c0, 2.0), (r0, c0, 0.5)):
        xx = randn(b, res, res, res, ch, dtype=BF16)
        row(f"resize3d {res}^3 x{scale}", lambda: resize3d(xx, scale))

    xx = randn(b, r0, r0, r0, c0, dtype=BF16)
    dense = seeded(Dense(c0, 3 * heads * dh, use_bias=False, dtype=BF16, device=dev))
    row(f"dense {r0}^3 {c0}->{3 * heads * dh} (qkv)", lambda: dense(xx))

    time_dim = 4 * mc.dim
    tvec = randn(b, time_dim, dtype=BF16)
    for res, ch in ((r0, c0), (r1, c1)):
        xx = randn(b, res, res, res, ch, dtype=BF16)
        rb = seeded(ResnetBlock(ch, ch, time_dim, dtype=BF16, device=dev).eval())
        conv = seeded(conv_nd(ch, ch, 3, dtype=BF16, device=dev))
        norm = RMSNorm(ch, device=dev)
        row(f"resblock {res}^3 c{ch}", lambda: rb(xx, tvec))
        row(f"  2x conv3 alone {res}^3 c{ch}", lambda: conv(conv(xx)))
        row(f"  rmsnorm alone {res}^3 c{ch}", lambda: norm(xx))

    for res, cin, cout, module in ((r0, c0, c0, Downsample), (r1, c1, c1, Upsample)):
        xx = randn(b, res, res, res, cin, dtype=BF16)
        mod = seeded(module(cin, cout, dtype=BF16, device=dev))
        row(f"{module.__name__} {res}^3 c{cin}", lambda: mod(xx))


if __name__ == "__main__":
    main()
