"""The bound that ``chip_smoke.py`` prints beside each kernel's time: the
larger of the bytes over the memory rate, the products over their peak, and
the exponentials over the special-function units' rate. Arithmetic only: no
card is needed."""

import pytest

import chip_smoke

# the fa16 stage: b8 x 4096 queries x 4100 keys (4 memory tokens) x 4 heads x 32
B, N, M, H, D = 8, 4096, 4100, 4, 32


def test_flash_attention_at_fa16_is_bound_by_its_exponentials():
    nbytes = 2 * (2 * B * N + 2 * B * M) * H * D + 4 * B * H * N
    ms, by = chip_smoke.bound(nbytes, 4.0 * B * H * N * M * D, exps=B * H * N * M)
    assert by == "exponentials"
    assert ms == pytest.approx(0.138, abs=0.01)
    # the products alone: the old bound, 0.0696 ms
    assert chip_smoke.bound(nbytes, 4.0 * B * H * N * M * D) == (
        pytest.approx(0.0696, abs=1e-4), "operations")


@pytest.mark.parametrize("exps", [0, B * (262144 + 4) * 128])
def test_linear_attention_stays_bound_by_bytes(exps):
    """K1 at b8 x 64³ x 128: its exponentials (one per token and column) take
    less time than its bytes, so it stays bound by bytes."""
    n = 262144
    nbytes = 2 * B * n * 128 * 2 + 2 * 4 * 128 * 2 + B * 128 * 128 * 4
    ms, by = chip_smoke.bound(nbytes, 2.0 * B * n * 128 * 32, exps=exps)
    assert by == "bytes"
    assert ms == pytest.approx(0.3207, abs=1e-3)


@pytest.mark.parametrize("work,n,expected", [
    (chip_smoke.context_work, 32768, 0.0402), (chip_smoke.context_work, 4096, 0.0052),
    (chip_smoke.project_work, 32768, 0.0402), (chip_smoke.project_work, 4096, 0.0052),
])
def test_linear_attention_at_32_and_16_cubed_is_bound_by_bytes(work, n, expected):
    """K1 and K2 at b8 × 32³ and 16³ × 128: k and v (K1), or q and the output
    (K2), in bf16 and the f32 ctx, over 3.35 TB/s; their products and
    exponentials take less time."""
    nbytes, flops, exps = work(B, n)
    ms, by = chip_smoke.bound(nbytes, flops, exps=exps)
    assert by == "bytes"
    assert ms == pytest.approx(expected, abs=1e-4)


def test_bound_picks_the_largest_term():
    peak = chip_smoke.PEAK_BF16_FLOP_PER_S
    assert chip_smoke.bound(0, peak * 1e-3)[1] == "operations"
    assert chip_smoke.bound(chip_smoke.PEAK_BYTES_PER_S * 1e-3, 0) == (pytest.approx(1.0), "bytes")
    assert chip_smoke.bound(1, 1, exps=chip_smoke.PEAK_EXP_PER_S * 2e-3) == (
        pytest.approx(2.0), "exponentials")


def test_gemm_probe_at_the_conv_shape_is_bound_by_bytes():
    """P1 at 524,288 x 1296 x 48: A's 1.36 GB over 3.35 TB/s, against 6.5e10 products."""
    ms, by = chip_smoke.bound(*chip_smoke.probe_work(524288, 1296, 48))
    assert by == "bytes"
    assert ms == pytest.approx(0.4207, abs=1e-4)


def test_tap_conv_forward_at_the_train_shape_is_bound_by_operations():
    """K5a at [8, 64³, 48 -> 48]: 2.61e11 products over 989 TF/s, against 0.40 GB."""
    ms, by = chip_smoke.bound(*chip_smoke.conv_work(8 * 64**3, 48, 48))
    assert by == "operations"
    assert ms == pytest.approx(0.2638, abs=1e-4)


@pytest.mark.parametrize("work,n,expected", [
    (chip_smoke.v1_context_work, 262144, 0.3206), (chip_smoke.v1_context_work, 32768, 0.0401),
    (chip_smoke.v1_project_work, 262144, 0.3206), (chip_smoke.v1_project_work, 32768, 0.0401),
])
def test_v1_linear_attention_is_bound_by_bytes(work, n, expected):
    """K4a and K4b at b8 × 64³ and 32³ × 4 heads × 32, with M = N + 4 keys (the
    memory tokens): k and v (K4a), or q and the output (K4b), in bf16 and the
    f32 [B, 4, 32, 32] ctx over 3.35 TB/s. Their f32 products, counted at the
    FP32 cores' 67 TF/s (0.2564 ms at 64³ for K4a), and their exponentials
    take less time."""
    nbytes, flops, exps = work(B, n)
    ms, by = chip_smoke.bound(nbytes, flops, chip_smoke.PEAK_F32_FLOP_PER_S, exps)
    assert by == "bytes"
    assert ms == pytest.approx(expected, abs=1e-4)
    assert flops / chip_smoke.PEAK_F32_FLOP_PER_S * 1e3 < ms


def test_mma_probe_at_the_headline_case_is_bound_by_operations():
    """P2 at (2048, 1296, 48, 16) with R = 256: 1.04e12 operations over 989 TF/s,
    against 0.1 GB of A and B read once."""
    ms, by = chip_smoke.bound(*chip_smoke.mma_probe_work(2048, 1296, 48, 16, 256))
    assert by == "operations"
    assert ms == pytest.approx(1.0553, abs=1e-4)
