"""The port's trace and profile tools on the CPU at the tiny preset.

``tools.trace_forward`` and ``tools.trace_train`` write a Chrome trace, and
``tools.trace_summary``'s buckets sum to its total (a CPU trace is summarised
by its top-level operators). The name classifier, a plain function, sorts the
kernel names of the card's profiles (PERF.md §5: the b8 forward, the
conditional forward and the fa16 micro-step of ``chip_smoke.py``) into the
expected buckets, the port's own kernels by their launch names.
``tools.profile_breakdown --quick`` runs.
"""

import contextlib
import io
import json

import pytest
import torch

from flowtrain_stochastic_interpolation_torch.tools import (
    profile_breakdown,
    trace_forward,
    trace_summary,
    trace_train,
)

# launch names as torch.profiler reports them on the H100 (chip_smoke.py's tables)
KERNEL_NAMES = {
    "sm80_xmma_fprop_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x32x32"
    "_stage4_warpsize4x1x1_g1_tensor16x8x16": "convolution (cuDNN)",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x64x32"
    "_warpgroupsize1x1x1": "convolution (cuDNN)",
    "sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize32x128x32"
    "_stage4": "convolution (cuDNN)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna4"
    "_alignc4_execute_kernel__5x_cublas": "GEMM (cuBLAS/CUTLASS)",
    "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_TNN": "GEMM (cuBLAS/CUTLASS)",
    "nvjet_tst_48x384_64x3_1x2_h_bz_coopA_bias_TNN": "GEMM (cuBLAS/CUTLASS)",
    "(anonymous namespace)::folded_project(CUtensorMap_st, float const*, __nv_bfloat16*, int, "
    "float)": "hand-written kernels",
    "(anonymous namespace)::folded_context_partial(CUtensorMap_st, CUtensorMap_st, int, int, "
    "float*, float*)": "hand-written kernels",
    "(anonymous namespace)::folded_context_combine(float const*, float const*, float const*, "
    "__nv_bfloat16*)": "hand-written kernels",
    "(anonymous namespace)::linear_project_tiles(CUtensorMap_st, float const*, __nv_bfloat16*, "
    "int, float)": "hand-written kernels",
    "void (anonymous namespace)::flash_mma<32>(__nv_bfloat16 const*, int)": "hand-written kernels",
    "void (anonymous namespace)::conv_forward_box<4>(float const*)": "hand-written kernels",
    "void at::native::(anonymous namespace)::upsample_trilinear3d_out_frame<c10::BFloat16, "
    "float>(int, float, float)": "resize",
    "void at::native::(anonymous namespace)::upsample_trilinear3d_backward_out_frame<c10::"
    "BFloat16, float>(int)": "resize",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::NormTwoOps"
    "<float, float, float>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float>)": "reductions",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::"
    "BinaryFunctor<float, float, float, at::native::MulFunctor<float> > >(at::TensorIteratorBase&)"
    ">(int)": "normalisation and elementwise",
    "void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
    "silu_kernel(at::TensorIteratorBase&)>(int)": "normalisation and elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::"
    "TensorIteratorBase&)>(int)": "copies and memsets",
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(at::"
    "TensorIteratorBase&)>(int)": "copies and memsets",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
    "namespace)::OpaqueType<2u>, unsigned int, 4, 64, 64>(int)": "copies and memsets",
    "Memset (Device)": "copies and memsets",
    "Memcpy DtoH (Device -> Pinned)": "copies and memsets",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this file runs (several workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name, bucket", sorted(KERNEL_NAMES.items()))
def test_classifier_buckets_the_cards_kernel_names(name, bucket):
    assert trace_summary.classify(name) == bucket


def test_the_hand_written_kernels_are_read_from_the_sources():
    kernels = trace_summary.hand_written_kernels()
    assert {"folded_context_partial", "folded_context_combine", "folded_project", "flash_mma",
            "linear_context_partial", "linear_project_tiles", "conv_forward_box",
            "conv_weight_box", "gemm_stream", "probe_windows"} <= kernels
    assert trace_summary.hand_written_name(next(n for n in KERNEL_NAMES if "flash_mma" in n)) \
        == "flash_mma"
    assert trace_summary.hand_written_name("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_TNN") is None


@pytest.mark.parametrize("tool, argv", [
    (trace_forward, ["--batch", "2"]),
    (trace_train, ["--batch", "2"]),
    (trace_train, ["--batch", "2", "--conditional"]),
])
def test_traces_are_written_and_summarised(tmp_path, tool, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        result = tool.main(["--preset", "tiny", "--device", "cpu", "--iters", "2",
                            "--out", str(tmp_path), *argv])
    assert result["trace"] == str(tmp_path / "trace.json")
    assert result["profiler_device_ms"] == 0.0  # no card
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert sum(e.get("name") == "iteration" for e in events) == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = trace_summary.summarize(result["trace"])
    assert summary["source"] == "host" and summary["iterations"] == 2 and summary["events"] > 0
    assert sum(summary["buckets"].values()) == pytest.approx(summary["total_ms"], rel=1e-12)
    assert summary["buckets"]["convolution (cuDNN)"] > 0
    assert 0.0 <= summary["idle_share"] < 1.0
    assert "total host time" in buf.getvalue()


def test_profile_breakdown_quick_runs():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = profile_breakdown.main(["--quick", "--preset", "tiny", "--device", "cpu",
                                       "--batch", "2"])
    assert set(rows) == {"full forward (bf16)", "no attention"}
    assert all(ms > 0 for ms in rows.values())
    assert "attention share of forward" in buf.getvalue()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_breakdown.main(["--quick"])
