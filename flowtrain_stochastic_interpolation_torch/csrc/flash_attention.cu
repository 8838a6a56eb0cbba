// Flash attention, forward (K3), written by hand for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (flowtrain_stochastic_interpolation_torch/ops/flash_attention.py).
//
// Replaces flowtrain_stochastic_interpolation_tpu/ops/flash_attention.py
// _fa_kernel (called from _flash_fwd_bhnd): non-causal softmax attention with
// scale d^-1/2 over flattened voxel tokens,
//     s = q k^T * d^-1/2,   out = softmax(s) v,   lse = logsumexp(s)
// for one (batch, head) per blockIdx.y. q is [B, N, h, d] and k, v are
// [B, M, h, d], each read in place through its batch, token and head strides
// (q is a column slice of the UNet's [B, N, 3, h, d] projection; k and v are
// the caller's concatenation of the memory tokens and the keys). out is
// [B, N, h, d] bf16, contiguous; lse is [B, h, N] f32.
//
// Numerics follow the TPU kernel: q, k and v are upcast to f32, the scores,
// the probabilities p and the p.v product stay in f32 (the products of bf16
// inputs are exact in f32, so only the order of the sums differs), and the
// running max, sum and accumulator are f32. Key columns past M are masked to
// -inf and their rows are never read; query rows past N are never written.
// Every key tile the loop visits holds at least one real key, so the running
// max is finite after the first tile and exp(m_prev - m_new) never sees
// -inf - (-inf).
//
// Bound on the H100: at the fa16 stage (b8 x 4096 queries x 4100 keys x 4
// heads x 32) the two products are 4.BH.N.M.d = 6.9e10 operations, 0.07 ms at
// the bf16 tensor-core rate, against about 34 MB of q, k, v, out and lse
// (0.01 ms at 3.35 TB/s): the kernel is bound by operations.
//
// What the design does about it. This first version is the simple, exact
// one: each thread owns one query row (q and its f32 accumulator in
// registers), each block walks all key tiles of its (batch, head), staging
// KT keys and values at a time in shared memory as f32, so every staged
// element serves the block's BQ rows. Scores for a whole tile are held in
// registers, so the online-softmax rescale runs once per tile, not per key.
// The products run on the FP32 cores: tensor cores (which would round p to
// bf16 or tf32 for the p.v product) and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // query rows per block, one per thread
// keys staged in shared memory per step: the tile's scores live in registers
// beside q and the accumulator, so wider heads take shorter tiles
template <int D>
constexpr int key_tile() { return D <= 32 ? 64 : 32; }

__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int D, int KT>
__global__ void __launch_bounds__(BQ)
flash_forward(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              long long q_bs, long long q_ts, long long q_hs,
              long long k_bs, long long k_ts, long long k_hs,
              long long v_bs, long long v_ts, long long v_hs,
              __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
              int heads, int n, int m, float scale) {
  const int t = threadIdx.x;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = blockIdx.x * BQ + t;
  const bool live = row < n;

  __shared__ __align__(16) float k_s[KT][D];
  __shared__ __align__(16) float v_s[KT][D];

  float qr[D];
  if (live) {
    const __nv_bfloat16* qp = q + b * q_bs + (long long)row * q_ts + h * q_hs;
#pragma unroll
    for (int c = 0; c < D; c += 8) unpack8(*reinterpret_cast<const uint4*>(qp + c), qr + c);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = 0.f;
  }

  const __nv_bfloat16* kb = k + b * k_bs + h * k_hs;
  const __nv_bfloat16* vb = v + b * v_bs + h * v_hs;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int base = 0; base < m; base += KT) {
    const int rows = min(KT, m - base);
    __syncthreads();  // the previous tile is consumed
    // rows past M are filled with zeros and masked below; never read from memory
    for (int i = t; i < KT * D / 8; i += BQ) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      float kf[8], vf[8];
      if (r < rows) {
        unpack8(*reinterpret_cast<const uint4*>(kb + (long long)(base + r) * k_ts + c8), kf);
        unpack8(*reinterpret_cast<const uint4*>(vb + (long long)(base + r) * v_ts + c8), vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(&k_s[r][c8]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][c8]);
      kd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      kd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float s[KT];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][c]);
        dot = fmaf(qr[c], kk.x, dot);
        dot = fmaf(qr[c + 1], kk.y, dot);
        dot = fmaf(qr[c + 2], kk.z, dot);
        dot = fmaf(qr[c + 3], kk.w, dot);
      }
      s[j] = (j < rows) ? dot * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m_run, tile_max);  // finite: the tile has a real key
    const float alpha = expf(m_run - m_new);     // 0 on the first tile
    l_run *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float p = expf(s[j] - m_new);  // 0 for the masked columns
      l_run += p;
#pragma unroll
      for (int c = 0; c < D; c += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][c]);
        acc[c] = fmaf(p, vv.x, acc[c]);
        acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
        acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
        acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
      }
    }
    m_run = m_new;
  }

  if (!live) return;
  __nv_bfloat16* op = out + (((long long)b * n + row) * heads + h) * D;
#pragma unroll
  for (int c = 0; c < D; c += 8) {
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[c + 2 * i] / l_run,
                                                        acc[c + 2 * i + 1] / l_run);
      w[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(op + c) = packed;
  }
  lse[(long long)bh * n + row] = m_run + logf(l_run);
}

template <int D>
int launch(const void* q, const void* k, const void* v, long long q_bs, long long q_ts,
           long long q_hs, long long k_bs, long long k_ts, long long k_hs, long long v_bs,
           long long v_ts, long long v_hs, void* out, void* lse, int batch, int heads,
           int n, int m, float scale, cudaStream_t s) {
  const dim3 grid((n + BQ - 1) / BQ, batch * heads);
  flash_forward<D, key_tile<D>()><<<grid, BQ, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts,
      v_hs, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), heads, n, m, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3: out [batch, n, heads, d] bf16 (contiguous) and lse [batch, heads, n] f32
// from q [batch, n, heads, d] and k, v [batch, m, heads, d] bf16, each given
// by its batch, token and head strides in elements (d contiguous, every row
// 16-byte aligned). d is 32 (the configurations' heads) or 64 (the UNet's
// default head width); n >= 1 and m >= 1. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for another d.
int flash_attention_forward(const void* q, const void* k, const void* v, long long q_bs,
                            long long q_ts, long long q_hs, long long k_bs, long long k_ts,
                            long long k_hs, long long v_bs, long long v_ts, long long v_hs,
                            void* out, void* lse, int batch, int heads, int n, int m, int d,
                            float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, out,
                        lse, batch, heads, n, m, scale, s);
    case 64:
      return launch<64>(q, k, v, q_bs, q_ts, q_hs, k_bs, k_ts, k_hs, v_bs, v_ts, v_hs, out,
                        lse, batch, heads, n, m, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
