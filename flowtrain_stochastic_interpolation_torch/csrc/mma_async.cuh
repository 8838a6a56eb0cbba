// Building blocks of the redesigned kernels (K3's bf16 path in
// csrc/flash_attention.cu, the bf16 box paths of K5a and K5b in
// csrc/tap_conv.cu, P1's streaming path in csrc/gemm_probes.cu, K1 and K2 on
// 4 x 32 bf16 heads in csrc/linear_attention.cu): 16-byte cp.async copies
// into shared memory with zero-fill, 2-D and 3-D tiles copied by the Tensor
// Memory Accelerator (TMA) and counted on an mbarrier, the host's encoder of
// their tensor maps, ldmatrix fragment loads (plain and transposed) and
// mma.sync.m16n8k16 on bf16 with f32 accumulation.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, q = lane % 4), each
// 32-bit register two bf16 values, the lower index in the lower half:
//   A (16 x 16, row-major): a0 (row g, k 2q..2q+1), a1 (row g + 8, k 2q),
//                           a2 (row g, k 2q + 8),   a3 (row g + 8, k 2q + 8);
//   B (16 x 8, k-major):    b0 (k 2q..2q+1, column g), b1 (k 2q + 8, column g);
//   C (16 x 8, f32):        c0, c1 (row g, columns 2q, 2q + 1), c2, c3 (row g + 8).
// ldmatrix.x4 takes one 16-byte row address per lane (lanes 8i..8i+7 give the
// eight rows of matrix i) and hands each lane one register of each of the four
// 8 x 8 matrices: without .trans the pair (row g, columns 2q, 2q + 1) of the
// matrix as stored, with .trans the pair (rows 2q, 2q + 1, column g). So a
// stored tile whose rows run along k feeds B (and A^T) through .trans, and one
// whose rows run along m or n feeds A or B as it is.
//
// The tile design in csrc/tile_mma.cuh (the f32 and ragged shapes of K5a and
// K5b, P1's other shapes, P2) does not use this header.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, or 16 zero bytes where !valid (src
// is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the first two matrices only (lanes 0-15 give the row addresses)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// An mbarrier in shared memory that expects `count` arrivals per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// the initialised mbarriers, visible to the TMA (the async proxy)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on bar and tell it to expect `bytes` more from the TMA in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on bar
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// arrive on bar once this thread's cp.async copies so far have landed (the
// arrival is counted in bar's expected count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of bar with this parity has completed. A wait of
// 2^26 polls (seconds) means a lost copy: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int i = 0; !done; ++i) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (i == (1 << 26)) __trap();
  }
}

// The box of a 2-D tensor map (a CUtensorMap kernel parameter) at element
// coordinates (c0 innermost, c1) into shared memory at dst, its bytes counted
// on bar. Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The box of a 3-D tensor map at element coordinates (c0 innermost, c1, c2),
// as tma_load_2d.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Order this thread's generic-proxy accesses to shared memory before later
// async-proxy (TMA) accesses to it, such as a refill of a stage it wrote into.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the first `threads` threads of the block (whole warps) meet at named barrier id
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// c += a b on the tensor cores, bf16 operands, f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even) in one register, lo in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 values of a register as f32 (exact)
__device__ __forceinline__ float low_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// 2^x on the special-function unit (ex2.approx: about 2^-22 relative; 2^-inf = +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The TMA's encoder, cuTensorMapEncodeTiled, looked up through the runtime (no
// link to libcuda).
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (dims innermost first; strides in
// bytes of dimensions 1.., each a multiple of 16) in boxes of `box` elements
// with the 128-byte swizzle (box[0] is 64: one 128-byte row per box row),
// zeros outside the tensor. Returns 0, or a CUDA error code.
inline int bf16_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                           const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace mma_async
