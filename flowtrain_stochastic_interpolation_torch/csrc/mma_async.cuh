// Building blocks of the redesigned kernels (K3's bf16 path in
// csrc/flash_attention.cu, the bf16 box paths of K5a and K5b in
// csrc/tap_conv.cu, P1's streaming path and P2's window path in
// csrc/gemm_probes.cu, K1, K2, K4a and K4b on 4 x 32 bf16 heads in
// csrc/linear_attention.cu): 16-byte cp.async copies into shared memory with
// zero-fill, 2-D and 3-D tiles copied by the Tensor Memory Accelerator (TMA)
// and counted on an mbarrier, the host's encoder of their tensor maps,
// ldmatrix fragment loads (plain and transposed), mma.sync.m16n8k16 on bf16
// with f32 accumulation, and the warpgroup products (wgmma) with their
// shared-memory matrix descriptors (P2 only, at the end of this file).
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
// K5b, P1's and P2's other shapes) does not use this header.

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

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma, sm_90a only). Four consecutive warps (a
// warpgroup, warps 4i..4i+3) issue together one asynchronous product
// D [64, N] += A [64, 16] B [16, N], A and B read from shared memory through
// matrix descriptors, D kept in registers, N / 2 f32 values a thread: warp w of
// the group holds rows 16 w.., and value 4 i + 2 h + c of lane l (g = l / 4,
// q = l % 4) is D[16 w + g + 8 h, 8 i + 2 q + c]. The products run in the
// background until wgmma_wait: between wgmma_fence and that wait no other
// instruction may touch D's registers.
//
// Operands here are K-major (k contiguous) tiles with the 128-byte swizzle, as
// the TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B: rows of 64 bf16 (128
// bytes), the 16-byte unit u of row r at u ^ (r % 8), in atoms of 8 rows
// (1024 bytes) that start on a 1024-byte boundary. Row r of the tile is at
// 128 r; the k16 step ks is 32 ks bytes along the row.
// ---------------------------------------------------------------------------

// The descriptor of a K-major, 128-byte-swizzled operand whose rows 0..7 form
// one atom at shared address `addr` (plus 32 bytes per k16 step, which the
// hardware swizzles with the address bits): start address / 16 (bits 0-13),
// leading byte offset 1 (bits 16-29, unused by this layout), stride byte offset
// 1024 / 16 from one 8-row atom to the next (bits 32-45), base offset 0
// (bits 49-51: the atoms are 1024-byte aligned), layout 1 = 128-byte swizzle
// (bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Order this warpgroup's earlier register and shared-memory accesses before the
// wgmmas that follow (needed before the first wgmma of each batch).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the wgmmas issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still running: their shared-memory
// reads are done and their registers hold the sums.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of v across this point (used
// on the accumulators after wgmma_wait, before they are read).
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// D = A B + (accumulate ? D : 0) for bf16 A [64, 16], B [16, N] (both K-major,
// descriptors a and b) and f32 D [64, N], at the N-tile widths of P2's window
// path: 48 (N = 48) and 64.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<48>(float (&d)[24], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
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

constexpr int MAX_DEVICES = 64;

// cudaFuncSetAttribute holds for the current device only, so a kernel that
// needs more than 48 KB of dynamic shared memory is allowed it once per
// device, as the caller's `done` records. Returns 0 or a CUDA error code.
inline int allow_smem(const void* kernel, int smem, bool (&done)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < MAX_DEVICES && done[device]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < MAX_DEVICES) done[device] = true;
  return 0;
}

}  // namespace mma_async
