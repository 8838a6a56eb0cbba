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


def test_bound_picks_the_largest_term():
    peak = chip_smoke.PEAK_BF16_FLOP_PER_S
    assert chip_smoke.bound(0, peak * 1e-3)[1] == "operations"
    assert chip_smoke.bound(chip_smoke.PEAK_BYTES_PER_S * 1e-3, 0) == (pytest.approx(1.0), "bytes")
    assert chip_smoke.bound(1, 1, exps=chip_smoke.PEAK_EXP_PER_S * 2e-3) == (
        pytest.approx(2.0), "exponentials")
