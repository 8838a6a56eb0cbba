// The 4 x 32 bf16 folded context (K1, pass 1) and projection (K2) as they ran
// on the FP32 cores before their redesign for the tensor cores and the TMA:
// the baseline of tools/ab_linear_attention.py, which appends this text to
// csrc/linear_attention.cu and builds it as one of its variants. The port
// never launches these kernels. Pass 2 of K1 is the source's own
// folded_context_combine; the partials have the same layout.

namespace {
namespace fp32_cores {

constexpr int K1_TILE = 32;  // tokens staged in shared memory per step of K1
constexpr int K2_ROWS = 32;  // rows of q per tile of K2

// ---------------------------------------------------------------------------
// K1, pass 1: per (chunk, batch) running column max, sum and diagonal blocks.
// Thread t owns rows d0..d0+3 and columns e0..e0+3 of head t/64's block, and,
// for the column reductions, column t%128 over half t/128 of each tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fp32_context_partial(const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     long long k_ld, long long v_ld, long long k_bs, long long v_bs,
                     int n, int chunk, int n_chunks,
                     float* __restrict__ part_m, float* __restrict__ part_s,
                     float* __restrict__ part_ctx) {
  const int c = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int n0 = c * chunk;
  const int n1 = min(n, n0 + chunk);
  const __nv_bfloat16* kb = k + (long long)b * k_bs;
  const __nv_bfloat16* vb = v + (long long)b * v_bs;

  __shared__ __align__(16) float p_s[K1_TILE][HD];  // k, then bf16(exp(k - m))
  __shared__ __align__(16) float v_s[K1_TILE][HD];
  __shared__ float red[2][HD];
  __shared__ float m_run[HD], s_run[HD], alpha_s[HD];

  if (t < HD) {
    m_run[t] = neg_inf();
    s_run[t] = 0.f;
  }

  const int h = t >> 6, local = t & 63;
  const int d0 = (local >> 3) * 4, e0 = (local & 7) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int col = t & (HD - 1), half = t >> 7;
  constexpr int HALF_ROWS = K1_TILE / 2;

  for (int base = n0; base < n1; base += K1_TILE) {
    const int rows = min(K1_TILE, n1 - base);
    __syncthreads();  // the previous tile is consumed
    // Rows past the chunk's end are never read: they are filled with
    // k = -inf (so exp gives 0) and v = 0.
    for (int i = t; i < K1_TILE * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (r < rows) {
        const uint4 kraw = *reinterpret_cast<const uint4*>(kb + (long long)(base + r) * k_ld + c8);
        const uint4 vraw = *reinterpret_cast<const uint4*>(vb + (long long)(base + r) * v_ld + c8);
        unpack8(kraw, kf);
        unpack8(vraw, vf);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          kf[j] = neg_inf();
          vf[j] = 0.f;
        }
      }
      float4* pd = reinterpret_cast<float4*>(&p_s[r][c8]);
      float4* vd = reinterpret_cast<float4*>(&v_s[r][c8]);
      pd[0] = make_float4(kf[0], kf[1], kf[2], kf[3]);
      pd[1] = make_float4(kf[4], kf[5], kf[6], kf[7]);
      vd[0] = make_float4(vf[0], vf[1], vf[2], vf[3]);
      vd[1] = make_float4(vf[4], vf[5], vf[6], vf[7]);
    }
    __syncthreads();

    float mx = neg_inf();
#pragma unroll
    for (int r = 0; r < HALF_ROWS; ++r) mx = fmaxf(mx, p_s[half * HALF_ROWS + r][col]);
    red[half][col] = mx;
    __syncthreads();
    if (t < HD) {
      const float m_new = fmaxf(m_run[t], fmaxf(red[0][t], red[1][t]));
      alpha_s[t] = expf(m_run[t] - m_new);  // 0 on the first tile
      m_run[t] = m_new;
    }
    __syncthreads();

    {
      const float m_new = m_run[col];
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < HALF_ROWS; ++r) {
        const int rr = half * HALF_ROWS + r;
        const float p = expf(p_s[rr][col] - m_new);
        s += p;                         // the sum takes exp in f32
        p_s[rr][col] = bf16_round(p);   // the product takes it in bf16
      }
      red[half][col] = s;
    }
    __syncthreads();
    if (t < HD) s_run[t] = s_run[t] * alpha_s[t] + red[0][t] + red[1][t];

    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = alpha_s[h * DH + d0 + i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a[i];

    for (int r = 0; r < rows; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&p_s[r][h * DH + d0]);
      const float4 vv = *reinterpret_cast<const float4*>(&v_s[r][h * DH + e0]);
      // v was bf16 in memory, so it is already a bf16 value
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }
  __syncthreads();

  const long long slot = (long long)b * n_chunks + c;
  if (t < HD) {
    part_m[slot * HD + t] = m_run[t];
    part_s[slot * HD + t] = s_run[t];
  }
  float* pc = part_ctx + (slot * NH + h) * DH * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(&pc[(d0 + i) * DH + e0]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// K2: out = groupsoftmax(q) * scale @ ctx, per (row tile, batch). The block
// stages ctx's diagonal blocks once (rounded to bf16), then walks row tiles.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
fp32_project(const __nv_bfloat16* __restrict__ q, long long q_ld, long long q_bs,
             const float* __restrict__ ctx, __nv_bfloat16* __restrict__ out,
             int n, int n_tiles, float scale) {
  const int b = blockIdx.y, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;

  __shared__ __align__(16) float ctx_s[NH][DH][DH];
  // p padded by one float per head so the four heads' reads fall in four banks
  __shared__ float p_s[K2_ROWS][NH * (DH + 1)];

  const float* cb = ctx + (long long)b * HD * HD;
  for (int i = t; i < NH * DH * DH; i += THREADS) {
    const int hh = i / (DH * DH), d = (i / DH) % DH, e = i % DH;
    ctx_s[hh][d][e] = bf16_round(cb[(hh * DH + d) * HD + hh * DH + e]);
  }

  const __nv_bfloat16* qb = q + (long long)b * q_bs;
  __nv_bfloat16* ob = out + (long long)b * n * HD;
  const int cg = t & 31, rg = t >> 5;   // output: columns cg*4.., rows rg*4..
  const int oh = cg >> 3, oe = (cg & 7) * 4;
  constexpr int ROWS_PER_WARP = K2_ROWS / (THREADS / 32);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * K2_ROWS;
    __syncthreads();  // ctx_s is staged, or the previous tile is consumed
    // group softmax: one warp per row, lane l holds columns 4l..4l+3, so the
    // eight lanes of a head group reduce among themselves
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      if (row0 + r >= n) break;
      const uint2 raw = *reinterpret_cast<const uint2*>(qb + (long long)(row0 + r) * q_ld + lane * 4);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 x01 = __bfloat1622float2(h2[0]);
      const float2 x23 = __bfloat1622float2(h2[1]);
      float x[4] = {x01.x, x01.y, x23.x, x23.y};
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = expf(x[j] - mx);
        sum += x[j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int hh = lane >> 3, dd = (lane & 7) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[r][hh * (DH + 1) + dd + j] = bf16_round((x[j] / sum) * scale);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 cv = *reinterpret_cast<const float4*>(&ctx_s[oh][d][oe]);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[rg * 4 + i][oh * (DH + 1) + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(p, ca[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + rg * 4 + i;
      if (row >= n) break;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[i][0], acc[i][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[i][2], acc[i][3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(ob + (long long)row * HD + cg * 4) = packed;
    }
  }
}

}  // namespace fp32_cores
}  // namespace

extern "C" {

// K1 as before: chunks of `chunk` tokens per (chunk, batch) block, then the
// combine; part_m, part_s [batch, n_chunks, 128] and part_ctx [batch,
// n_chunks, 4, 32, 32] f32 with n_chunks = ceil(n / chunk).
int fp32_folded_context_forward(const void* k, const void* v, long long k_ld, long long v_ld,
                                long long k_bs, long long v_bs, const void* mem_k,
                                const void* mem_v, int n_mem, int batch, int n, int chunk,
                                void* part_m, void* part_s, void* part_ctx, void* ctx,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + chunk - 1) / chunk;
  fp32_cores::fp32_context_partial<<<dim3(n_chunks, batch), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), k_ld, v_ld,
      k_bs, v_bs, n, chunk, n_chunks, static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_ctx));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  folded_context_combine<<<dim3(NH * (DH / COMBINE_ROWS), batch), THREADS, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_ctx), static_cast<const __nv_bfloat16*>(mem_k),
      static_cast<const __nv_bfloat16*>(mem_v), n_mem, n_chunks, static_cast<float*>(ctx));
  return static_cast<int>(cudaGetLastError());
}

// K2 as before: grid_x blocks per batch item walk the 32-row tiles.
int fp32_folded_project_forward(const void* q, long long q_ld, long long q_bs, const void* ctx,
                                void* out, int batch, int n, int grid_x, float scale,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + fp32_cores::K2_ROWS - 1) / fp32_cores::K2_ROWS;
  fp32_cores::fp32_project<<<dim3(grid_x, batch), THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), q_ld, q_bs, static_cast<const float*>(ctx),
      static_cast<__nv_bfloat16*>(out), n, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
