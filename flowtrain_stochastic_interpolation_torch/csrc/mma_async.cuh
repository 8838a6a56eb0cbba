// Building blocks of the redesigned kernels (K3's bf16 path in
// csrc/flash_attention.cu, K5b's bf16 box path in csrc/tap_conv.cu): 16-byte
// cp.async copies into shared memory with zero-fill, ldmatrix fragment loads
// (plain and transposed) and mma.sync.m16n8k16 on bf16 with f32 accumulation.
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
// The tile design in csrc/tile_mma.cuh (K5a, the old K5b path, P1, P2) does
// not use this header.

#pragma once

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

}  // namespace mma_async
