// Hand-written Hopper (sm_90a) Mamba-2 SSD (state-space duality) chunked
// scan for the model stack.
//
// Replaces _ssd_kernel (src/repro/kernels/ssd_scan.py:28, launched by
// pallas_call at :93). Inputs x (b, s, h, p), dt (b, s, h), B and C
// (b, s, n) in f32 or bf16, each with its own strides (the last dimension
// contiguous: the model hands B and C as the two halves of one (b, s, 2n)
// tensor), and a (h,) in f32; y (b, s, h, p) is written contiguous in x's
// type, and the state after the last chunk, H_final (b, h, p, n), in f32.
// Per (batch, head) and per chunk c of L positions, in f32:
//   cum = cumsum(dt·a), total = cum[L-1]
//   S_c = ((x·dt) ⊙ exp(total - cum))ᵀ·B                  (the chunk's state)
//   H_c = exp(total_c)·H_{c-1} + S_c, H_{-1} = 0           (state passing)
//   y   = (C·Bᵀ ⊙ exp(cum_i - cum_j)[i >= j])·(x·dt) + exp(cum) ⊙ (C·H_{c-1}ᵀ)
// Masked exponents (i < j) are never taken, as the reference clamps them
// before its exp (src/repro/kernels/ref.py:132-134). The plain PyTorch
// version of the same function is ssd_scan_chunked in
// src/repro_torch/kernels/ref.py, composed of the three stages below.
//
// Design: the Mamba-2 paper's chunked decomposition as three kernels that
// sc_ssd_scan launches in order on the caller's stream (one launch of the
// scan for the caller). The Pallas grid walks the chunks in order with H in
// VMEM; here only the state passing is serial, and only over chunks:
//   1. chunk state: grid (chunk, group of up to 8 heads, batch row), every
//      chunk in parallel. B is loaded once per block (f32 in shared memory)
//      for its heads, and warp w scans head w's dt·a (shuffles) and writes
//      its cum for kernel 3. Per head the block forms S_c (p x n =
//      (p x L)·(L x n)) with f32 FMAs, a 4 x 8 tile a thread, while the next
//      head's x is loaded, and stores it in f32: it becomes the decode
//      state.
//   2. state passing: one thread per four (batch, head, p, n) elements,
//      serial over the chunks, eight chunks' loads issued ahead of the FMA
//      chain. It writes H_{c-1}, the state before each chunk, for kernel 3
//      (over S_c in f32 for f32 inputs; rounded to bf16 into a buffer of
//      its own for bf16 inputs, the one rounding kernel 3 takes, at half
//      the bytes), and the state after the last chunk to H_final.
//   3. chunk output: grid (chunk, group of up to 8 heads, batch row). C·Bᵀ
//      is formed once per block and shared by its heads (B and C have no
//      head axis), then per head the masked intra-chunk product and C·Hᵀ.
//      bf16 inputs run all three products on the tensor cores (mma.sync
//      m16n8k16, f32 accumulation): C·Bᵀ is exact and stays in f32 in
//      shared memory; the intra-chunk product takes (C·Bᵀ ⊙ decay ⊙ dt_j),
//      its one f32 operand, rounded once to bf16 against x itself, and C·Hᵀ
//      takes H_{c-1} in bf16. Each head's H_{c-1} and x are copied in by
//      cp.async one head ahead, two blocks an SM. f32 inputs run all three
//      products as f32 FMAs on the CUDA cores (no TF32).
// A block takes 8 heads, or fewer (down to 1) where the grid would not fill
// the card. The chunk states live in a workspace the caller allocates
// (carve below); batch rows run in groups of group_rows (and one row's chunks in segments
// of seg_chunks, the state carried through H_final) so that the workspace
// stays bounded.
//
// Bound. Per (batch, head, chunk): L(L+1)p (the masked intra-chunk
// product), 2Lnp (C·Hᵀ) and 2Lnp (the state product); per (batch, chunk):
// L(L+1)n (C·Bᵀ, once for all heads). For bf16 inputs all but the state
// product count at the tensor cores' 989 TFLOP/s; the state product and
// every f32 product at 67 TFLOP/s. Bytes: the inputs, y and H_final; the
// chunk states are this design's own intermediate. This is chip_smoke.py's
// ssd_ops.
//
// Limits: L <= 64, p <= 64, n <= 128 (mamba2-2.7b's 64 x 64 x 128, jamba's
// n 16, the reduced configs).
//
// Interface: a plain extern "C" function loaded with ctypes. It launches on
// the caller's stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps; a 16 x 16 grid for the FMA tiles
constexpr int kMaxL = 64;       // chunk length
constexpr int kMaxP = 64;       // head dim
constexpr int kMaxN = 128;      // state dim
constexpr int kMaxHeads = 8;    // heads per block in kernels 1 and 3 (one warp each in 1)
constexpr int kLdN = kMaxN + 4; // f32 row stride of B, C and H, floats
constexpr int kLdL = kMaxL + 1; // f32 row stride of an L x L matrix
constexpr int kLdBN = kMaxN + 8;  // bf16 row stride of B, C and H (272 bytes)
constexpr int kLdBP = kMaxP + 8;  // bf16 row stride of x (144 bytes)
constexpr int kLdG = kMaxL + 8;   // f32 row stride of C·Bᵀ in kernel 3 (bf16)
constexpr int kXPerThread = kMaxL * kMaxP / kThreads;

// Shared memory of each kernel, bytes.
constexpr size_t kSmemState =
    (kMaxL * kLdN + 2 * kMaxL * kMaxP + 2 * kMaxHeads * kMaxL) * sizeof(float);
constexpr size_t kSmemOutF32 =
    (2 * kMaxL * kLdN + kMaxL * kLdL + kMaxL * kMaxP + 2 * kMaxL) * sizeof(float);

struct Strides {
  long long v[10];  // x {batch, seq, head}, dt {batch, seq, head}, B {batch, seq}, C {batch, seq}
};

// One group of the call: batch rows [b0, b0 + rows), chunks [c0, c0 + nc);
// hg heads a block in kernels 1 and 3.
struct Geometry {
  int b0, rows, c0, nc;
  int s, h, p, n, L, hg;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Workspace slots of a group: the (p x n) state of (row, chunk, head) and
// the L values of cum.
__device__ __forceinline__ long long slot(const Geometry& g, int bl, int cl, int hh) {
  return (static_cast<long long>(bl) * g.nc + cl) * g.h + hh;
}

// ---------------------------------------------------------------------------
// 1. chunk state
// ---------------------------------------------------------------------------
// Warp w scans head w of the block's group (hg <= 8 heads) up front. Then
// per head the block forms S_c from (x·dt)·w staged in shared memory, with
// the next head's x loaded into registers while the product runs (two
// buffers, one barrier a head). Three blocks an SM (80 registers, a few
// bytes spilled): the product waits on latency more than on the FMA units,
// and on the H100 this ran faster than two blocks an SM, with 109
// registers or with 8 x 8 tiles over two heads at once.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm,
                       float* __restrict__ states, float* __restrict__ cums, Geometry g,
                       Strides st) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [kMaxL][kLdN]
  float* Xs = Bs + kMaxL * kLdN;                // [2][kMaxL][kMaxP] (x·dt)·exp(total - cum)
  float* dts = Xs + 2 * kMaxL * kMaxP;          // [kMaxHeads][kMaxL]
  float* wv = dts + kMaxHeads * kMaxL;          // [kMaxHeads][kMaxL] exp(total - cum)

  const int cl = blockIdx.x, bl = blockIdx.z;
  const int bb = g.b0 + bl;
  const long long t0 = static_cast<long long>(g.c0 + cl) * g.L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const int h_begin = static_cast<int>(blockIdx.y) * g.hg;
  const int nh = min(g.h, h_begin + g.hg) - h_begin;

  const T* Bb = bm + bb * st.v[6] + t0 * st.v[7];
  for (int i = tid; i < kMaxL * kMaxN; i += kThreads) {
    const int r = i >> 7, k = i & (kMaxN - 1);
    Bs[r * kLdN + k] = (r < g.L && k < g.n) ? to_f32(Bb[r * st.v[7] + k]) : 0.f;
  }
  if (warp < nh) {  // inclusive scan of dt·a over the chunk, lanes j and j + 32
    const int hh = h_begin + warp;
    const T* db = dt + bb * st.v[3] + t0 * st.v[4] + hh * st.v[5];
    const float d0 = lane < g.L ? to_f32(db[lane * st.v[4]]) : 0.f;
    const float d1 = lane + 32 < g.L ? to_f32(db[(lane + 32) * st.v[4]]) : 0.f;
    const float av = a[hh];
    float v0 = d0 * av, v1 = d1 * av;  // 0 past L
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
      const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
      if (lane >= off) { v0 += u0; v1 += u1; }
    }
    v1 += __shfl_sync(0xffffffffu, v0, 31);
    const float total = __shfl_sync(0xffffffffu, (g.L - 1) < 32 ? v0 : v1, (g.L - 1) & 31);
    float* cw = cums + slot(g, bl, cl, hh) * g.L;
    if (lane < g.L) cw[lane] = v0;
    if (lane + 32 < g.L) cw[lane + 32] = v1;
    dts[warp * kMaxL + lane] = d0;
    dts[warp * kMaxL + lane + 32] = d1;
    wv[warp * kMaxL + lane] = lane < g.L ? expf(total - v0) : 0.f;
    wv[warp * kMaxL + lane + 32] = lane + 32 < g.L ? expf(total - v1) : 0.f;
  }
  // x of head k into registers, then as (x·dt)·w into buffer k & 1
  float xr[kXPerThread];
  auto load_x = [&](int k) {
    const T* xb = x + bb * st.v[0] + t0 * st.v[1] + (h_begin + k) * st.v[2];
#pragma unroll
    for (int u = 0; u < kXPerThread; ++u) {
      const int i = tid + u * kThreads, r = i >> 6, q = i & (kMaxP - 1);
      xr[u] = (r < g.L && q < g.p) ? to_f32(xb[r * st.v[1] + q]) : 0.f;
    }
  };
  auto stage_x = [&](int k) {
    float* xs = Xs + (k & 1) * kMaxL * kMaxP;
#pragma unroll
    for (int u = 0; u < kXPerThread; ++u) {
      const int i = tid + u * kThreads, r = i >> 6;
      xs[i] = xr[u] * dts[k * kMaxL + r] * wv[k * kMaxL + r];
    }
  };
  load_x(0);
  __syncthreads();  // B, dt and the weights are in place
  stage_x(0);
  __syncthreads();
  const bool vec = (g.n & 3) == 0;
  for (int k = 0; k < nh; ++k) {
    if (k + 1 < nh) load_x(k + 1);  // in flight during the product
    // S[q][k] = Σ_j ((x·dt)·w)[j][q]·B[j][k]: rows q = 4ty..4ty+3, columns
    // k = 4tx..4tx+3 and 64 + 4tx..64 + 4tx+3
    const float* xs = Xs + (k & 1) * kMaxL * kMaxP;
    float acc[4][8] = {};
    for (int j = 0; j < g.L; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * kMaxP + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + j * kLdN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + j * kLdN + 64 + 4 * tx);
      const float xw[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xw[r], bv[c], acc[r][c]);
    }
    float* Sb = states + slot(g, bl, cl, h_begin + k) * g.p * g.n;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = 4 * ty + r;
      if (q >= g.p) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k0 = 64 * half + 4 * tx;
        float* dst = Sb + q * g.n + k0;
        if (vec && k0 < g.n) {
          *reinterpret_cast<float4*>(dst) = make_float4(
              acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2], acc[r][4 * half + 3]);
        } else if (!vec) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + e < g.n) dst[e] = acc[r][4 * half + e];
        }
      }
    }
    if (k + 1 < nh) stage_x(k + 1);  // the other buffer: its last reader was head k - 1
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 2. state passing
// ---------------------------------------------------------------------------
__device__ __forceinline__ float fma_state(float d, float h, float s) { return fmaf(d, h, s); }
__device__ __forceinline__ float4 fma_state(float d, float4 h, float4 s) {
  return make_float4(fmaf(d, h.x, s.x), fmaf(d, h.y, s.y), fmaf(d, h.z, s.z), fmaf(d, h.w, s.w));
}

__device__ __forceinline__ void store_bf16(bf16* p, float h) { *p = __float2bfloat16_rn(h); }
__device__ __forceinline__ void store_bf16(bf16* p, float4 h) {
  uint2 v;
  v.x = sc_mma::pack_bf16(h.x, h.y);
  v.y = sc_mma::pack_bf16(h.z, h.w);
  *reinterpret_cast<uint2*>(p) = v;
}

// Row stride of the bf16 states-before-chunk that kernel 2 writes for
// kernel 3 (bf16 inputs): n rounded up to 8, so each row starts on 16 bytes.
__host__ __device__ __forceinline__ int padded_n(int n) { return (n + 7) & ~7; }

// V: float4 (four elements of one row a thread, n a multiple of 4) or
// float. kBf16: write H_{c-1} rounded to bf16 into hpre (rows of
// padded_n(n)), the operand kernel 3 takes on the tensor cores; else over
// S_c in f32.
template <typename V, bool kBf16>
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states, const float* __restrict__ cums,
                      bf16* __restrict__ hpre, float* __restrict__ h_final, Geometry g,
                      int carry) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  constexpr int kAhead = 8;
  const long long per_head = static_cast<long long>(g.p) * g.n / kVec;
  const long long lane = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (lane >= static_cast<long long>(g.rows) * g.h * per_head) return;
  const long long bh = lane / per_head;
  const long long e = lane - bh * per_head;
  const int hh = static_cast<int>(bh % g.h), bl = static_cast<int>(bh / g.h);
  V* S = reinterpret_cast<V*>(states) + slot(g, bl, 0, hh) * per_head + e;
  const long long c_step = static_cast<long long>(g.h) * per_head;  // one chunk further
  const float* tot = cums + slot(g, bl, 0, hh) * g.L + (g.L - 1);
  const long long t_step = static_cast<long long>(g.h) * g.L;
  const int n8 = padded_n(g.n);
  const int q = static_cast<int>(e * kVec / g.n), k = static_cast<int>(e * kVec - q * g.n);
  bf16* Hp = hpre + slot(g, bl, 0, hh) * g.p * n8 + q * n8 + k;
  const long long hp_step = static_cast<long long>(g.h) * g.p * n8;
  V* F = reinterpret_cast<V*>(h_final) + (static_cast<long long>(g.b0 + bl) * g.h + hh) * per_head + e;
  V H;
  if (carry) {
    H = *F;
  } else {
    H = V{};
  }
  int c = 0;
  for (; c + kAhead <= g.nc; c += kAhead) {
    V v[kAhead];
    float d[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      v[u] = S[(c + u) * c_step];
      d[u] = tot[(c + u) * t_step];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (kBf16) {
        store_bf16(Hp + (c + u) * hp_step, H);
      } else {
        S[(c + u) * c_step] = H;
      }
      H = fma_state(expf(d[u]), H, v[u]);
    }
  }
  for (; c < g.nc; ++c) {
    const V v = S[c * c_step];
    const float d = tot[c * t_step];
    if (kBf16) {
      store_bf16(Hp + c * hp_step, H);
    } else {
      S[c * c_step] = H;
    }
    H = fma_state(expf(d), H, v);
  }
  *F = H;
}

// ---------------------------------------------------------------------------
// 3. chunk output, f32 inputs: f32 FMAs
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_output_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ bm, const float* __restrict__ cm,
                            const float* __restrict__ states, const float* __restrict__ cums,
                            float* __restrict__ y, Geometry g, Strides st) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [kMaxL][kLdN]
  float* Hs = Cs + kMaxL * kLdN;                // [kMaxP][kLdN] B, then each head's H
  float* Ms = Hs + kMaxP * kLdN;                // [kMaxL][kLdL] masked C·Bᵀ ⊙ decay
  float* Xs = Ms + kMaxL * kLdL;                // [kMaxL][kMaxP] x·dt
  float* cum = Xs + kMaxL * kMaxP;              // [kMaxL]
  float* ecum = cum + kMaxL;                    // [kMaxL] exp(cum)

  const int cl = blockIdx.x, bl = blockIdx.z;
  const int bb = g.b0 + bl;
  const long long t0 = static_cast<long long>(g.c0 + cl) * g.L;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h_end = min(g.h, static_cast<int>(blockIdx.y + 1) * g.hg);

  const float* Bb = bm + bb * st.v[6] + t0 * st.v[7];
  const float* Cb = cm + bb * st.v[8] + t0 * st.v[9];
  for (int i = tid; i < kMaxL * kMaxN; i += kThreads) {
    const int r = i >> 7, k = i & (kMaxN - 1);
    const bool in = r < g.L && k < g.n;
    Hs[r * kLdN + k] = in ? Bb[r * st.v[7] + k] : 0.f;
    Cs[r * kLdN + k] = in ? Cb[r * st.v[9] + k] : 0.f;
  }
  __syncthreads();
  // G[i][j] = C_i·B_j for i = ty + 16r, j = tx + 16c, kept in registers for
  // every head of the block
  float gm[4][4] = {};
  {
    const float4* C4 = reinterpret_cast<const float4*>(Cs);
    const float4* B4 = reinterpret_cast<const float4*>(Hs);
    for (int k4 = 0; k4 < (g.n + 3) / 4; ++k4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = C4[(ty + 16 * r) * (kLdN / 4) + k4];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = B4[(tx + 16 * c) * (kLdN / 4) + k4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          gm[r][c] = fmaf(cv[r].x, bv[c].x, gm[r][c]);
          gm[r][c] = fmaf(cv[r].y, bv[c].y, gm[r][c]);
          gm[r][c] = fmaf(cv[r].z, bv[c].z, gm[r][c]);
          gm[r][c] = fmaf(cv[r].w, bv[c].w, gm[r][c]);
        }
    }
  }
  const long long y_row = static_cast<long long>(g.h) * g.p;
  const bool vec = (g.n & 3) == 0;
  for (int hh = static_cast<int>(blockIdx.y) * g.hg; hh < h_end; ++hh) {
    __syncthreads();  // B, or the previous head's H, M and x·dt, are no longer read
    const float* Sb = states + slot(g, bl, cl, hh) * g.p * g.n;
    if (vec) {
      for (int i = tid; i < kMaxP * (kMaxN / 4); i += kThreads) {
        const int q = i >> 5, k4 = i & 31;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < g.p && 4 * k4 < g.n) v = *reinterpret_cast<const float4*>(Sb + q * g.n + 4 * k4);
        *reinterpret_cast<float4*>(Hs + q * kLdN + 4 * k4) = v;
      }
    } else {
      for (int i = tid; i < kMaxP * kMaxN; i += kThreads) {
        const int q = i >> 7, k = i & (kMaxN - 1);
        Hs[q * kLdN + k] = (q < g.p && k < g.n) ? Sb[q * g.n + k] : 0.f;
      }
    }
    const float* xb = x + bb * st.v[0] + t0 * st.v[1] + hh * st.v[2];
    const float* db = dt + bb * st.v[3] + t0 * st.v[4] + hh * st.v[5];
    for (int i = tid; i < kMaxL * kMaxP; i += kThreads) {
      const int r = i >> 6, q = i & (kMaxP - 1);
      Xs[i] = (r < g.L && q < g.p) ? xb[r * st.v[1] + q] * db[r * st.v[4]] : 0.f;
    }
    if (tid < kMaxL) {
      const float v = tid < g.L ? cums[slot(g, bl, cl, hh) * g.L + tid] : 0.f;
      cum[tid] = v;
      ecum[tid] = expf(v);
    }
    __syncthreads();  // H, x·dt and cum are in place
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c;
        Ms[i * kLdL + j] = (j <= i && i < g.L) ? gm[r][c] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    __syncthreads();  // M is in place

    // y[i][q] = Σ_j M[i][j]·(x·dt)[j][q] + exp(cum_i)·Σ_k C[i][k]·H[q][k]
    float intra[4][4] = {}, inter[4][4] = {};
    for (int j = 0; j < g.L; ++j) {
      float mv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty + 16 * r) * kLdL + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = Xs[j * kMaxP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) intra[r][c] = fmaf(mv[r], xv[c], intra[r][c]);
    }
    const float4* C4 = reinterpret_cast<const float4*>(Cs);
    const float4* H4 = reinterpret_cast<const float4*>(Hs);
    for (int k4 = 0; k4 < (g.n + 3) / 4; ++k4) {
      float4 cv[4], hv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = C4[(ty + 16 * r) * (kLdN / 4) + k4];
#pragma unroll
      for (int c = 0; c < 4; ++c) hv[c] = H4[(tx + 16 * c) * (kLdN / 4) + k4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          inter[r][c] = fmaf(cv[r].x, hv[c].x, inter[r][c]);
          inter[r][c] = fmaf(cv[r].y, hv[c].y, inter[r][c]);
          inter[r][c] = fmaf(cv[r].z, hv[c].z, inter[r][c]);
          inter[r][c] = fmaf(cv[r].w, hv[c].w, inter[r][c]);
        }
    }
    float* yb = y + ((static_cast<long long>(bb) * g.s + t0) * g.h + hh) * g.p;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      if (i >= g.L) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = tx + 16 * c;
        if (q < g.p) yb[i * y_row + q] = intra[r][c] + ecum[i] * inter[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. chunk output, bf16 inputs: the tensor cores
// ---------------------------------------------------------------------------
// Warp w owns rows 16·(w / 2) .. +15 of the chunk (its m-tile) and output
// columns 32·(w % 2) .. +31. C·Bᵀ (only its 16 x 16 blocks on or below the
// diagonal) is formed once, kept in f32 in shared memory, and read by every
// head of the block. Each head's H_{c-1} (bf16, from kernel 2), x, cum and
// dt are copied in by cp.async one head ahead of the head being computed,
// into two buffers.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_output_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                            const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                            const bf16* __restrict__ hpre, const float* __restrict__ cums,
                            bf16* __restrict__ y, Geometry g, Strides st, int x_vec) {
  using namespace sc_mma;
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);  // [kMaxL][kLdBN]
  bf16* Hs = Cs + kMaxL * kLdBN;              // [2][kMaxP][kLdBN] H per head; B first
  bf16* Xs = Hs + 2 * kMaxP * kLdBN;          // [2][kMaxL][kLdBP] x per head
  float* Gs = reinterpret_cast<float*>(Xs + 2 * kMaxL * kLdBP);  // [kMaxL][kLdG] C·Bᵀ
  float* cum = Gs + kMaxL * kLdG;             // [2][kMaxL]
  float* dts = cum + 2 * kMaxL;               // [2][kMaxL]

  const int cl = blockIdx.x, bl = blockIdx.z;
  const int bb = g.b0 + bl;
  const long long t0 = static_cast<long long>(g.c0 + cl) * g.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp >> 1, half_w = warp & 1, q_base = 32 * half_w;
  const int gr = lane >> 2, t4 = lane & 3;
  const int h_begin = static_cast<int>(blockIdx.y) * g.hg;
  const int h_end = min(g.h, h_begin + g.hg);
  const int n8 = padded_n(g.n);
  const bf16 zero = __float2bfloat16_rn(0.f);

  // H_{c-1}, x, cum and dt of head hh into buffer buf: cp.async for H (and
  // x when its rows sit on 16 bytes), plain loads for the rest; the caller
  // commits the group.
  auto prefetch = [&](int hh, int buf) {
    const bf16* hp = hpre + slot(g, bl, cl, hh) * g.p * n8;
    bf16* hs = Hs + buf * kMaxP * kLdBN;
    for (int i = tid; i < kMaxP * (kMaxN / 8); i += kThreads) {
      const int q = i >> 4, k0 = 8 * (i & 15);
      const int bytes = q < g.p ? max(0, min(16, 2 * (g.n - k0))) : 0;
      cp_async_16(hs + q * kLdBN + k0, bytes ? hp + q * n8 + k0 : hp, bytes);
    }
    const bf16* xb = x + bb * st.v[0] + t0 * st.v[1] + hh * st.v[2];
    bf16* xs = Xs + buf * kMaxL * kLdBP;
    if (x_vec) {
      for (int i = tid; i < kMaxL * (kMaxP / 8); i += kThreads) {
        const int r = i >> 3, q0 = 8 * (i & 7);
        const int bytes = r < g.L ? max(0, min(16, 2 * (g.p - q0))) : 0;
        cp_async_16(xs + r * kLdBP + q0, bytes ? xb + r * st.v[1] + q0 : xb, bytes);
      }
    } else {
      for (int i = tid; i < kMaxL * kMaxP; i += kThreads) {
        const int r = i >> 6, q = i & (kMaxP - 1);
        xs[r * kLdBP + q] = (r < g.L && q < g.p) ? xb[r * st.v[1] + q] : zero;
      }
    }
    if (tid < kMaxL) {
      const bf16* db = dt + bb * st.v[3] + t0 * st.v[4] + hh * st.v[5];
      const bool in = tid < g.L;
      cum[buf * kMaxL + tid] = in ? cums[slot(g, bl, cl, hh) * g.L + tid] : 0.f;
      dts[buf * kMaxL + tid] = in ? __bfloat162float(db[tid * st.v[4]]) : 0.f;
    }
  };

  // C, and B into the second H buffer, which the first head does not use
  const bf16* Bb = bm + bb * st.v[6] + t0 * st.v[7];
  const bf16* Cb = cm + bb * st.v[8] + t0 * st.v[9];
  bf16* Bs = Hs + kMaxP * kLdBN;
  for (int i = tid; i < kMaxL * kMaxN; i += kThreads) {
    const int r = i >> 7, k = i & (kMaxN - 1);
    const bool in = r < g.L && k < g.n;
    Bs[r * kLdBN + k] = in ? Bb[r * st.v[7] + k] : zero;
    Cs[r * kLdBN + k] = in ? Cb[r * st.v[9] + k] : zero;
  }
  prefetch(h_begin, 0);
  cp_async_commit();
  __syncthreads();  // C and B are in place
  const int k_steps = (g.n + 15) / 16;
  // G = C·Bᵀ on and below the diagonal: the two warps of an m-tile take its
  // 16 x 16 column blocks jp <= mt in turn
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (jp > mt || (jp & 1) != half_w) continue;
    float gacc[2][4] = {};
    for (int ks = 0; ks < k_steps; ++ks) {
      uint32_t af[4], bf[4];
      ldmatrix_x4(af, Cs + (16 * mt + a_row(lane)) * kLdBN + 16 * ks + a_col(lane));
      ldmatrix_x4(bf, Bs + (16 * jp + b_row(lane)) * kLdBN + 16 * ks + b_col(lane));
      mma_bf16(gacc[0], af, bf[0], bf[1]);
      mma_bf16(gacc[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = 16 * jp + 8 * t + 2 * t4;
      *reinterpret_cast<float2*>(Gs + (16 * mt + gr) * kLdG + j) = make_float2(gacc[t][0], gacc[t][1]);
      *reinterpret_cast<float2*>(Gs + (16 * mt + gr + 8) * kLdG + j) =
          make_float2(gacc[t][2], gacc[t][3]);
    }
  }
  __syncthreads();  // G is in place; B is no longer read

  const int i0 = 16 * mt + gr, i1 = i0 + 8;  // this lane's two rows
  const long long y_row = static_cast<long long>(g.h) * g.p;
  const bool pairs = (g.p & 1) == 0;
  for (int hh = h_begin; hh < h_end; ++hh) {
    const int buf = (hh - h_begin) & 1;
    if (hh + 1 < h_end) {
      prefetch(hh + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this head's H, x, cum and dt are in place
    const bf16* hs = Hs + buf * kMaxP * kLdBN;
    const bf16* xs = Xs + buf * kMaxL * kLdBP;
    const float* cb = cum + buf * kMaxL;
    const float* db = dts + buf * kMaxL;
    const float c0 = cb[i0], c1 = cb[i1];

    // intra: P[i][j] = G[i][j]·exp(cum_i - cum_j)·dt_j for j <= i < L, as
    // bf16 A fragments, against x
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks > mt) break;
      float pv[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = 16 * ks + 8 * t + 2 * t4;
        const float2 g0 = *reinterpret_cast<const float2*>(Gs + i0 * kLdG + j);
        const float2 g1 = *reinterpret_cast<const float2*>(Gs + i1 * kLdG + j);
        const float gv[4] = {g0.x, g0.y, g1.x, g1.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e < 2) ? i0 : i1, jj = j + (e & 1);
          const float ci = (e < 2) ? c0 : c1;
          pv[t][e] = (jj <= i && i < g.L) ? gv[e] * expf(ci - cb[jj]) * db[jj] : 0.f;
        }
      }
      uint32_t af[4];
      af[0] = pack_bf16(pv[0][0], pv[0][1]);
      af[1] = pack_bf16(pv[0][2], pv[0][3]);
      af[2] = pack_bf16(pv[1][0], pv[1][1]);
      af[3] = pack_bf16(pv[1][2], pv[1][3]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, xs + (16 * ks + a_row(lane)) * kLdBP + q_base + 16 * np + a_col(lane));
        mma_bf16(acc[2 * np], af, bx[0], bx[1]);
        mma_bf16(acc[2 * np + 1], af, bx[2], bx[3]);
      }
    }
    // inter: C·Hᵀ
    float inter[4][4] = {};
    for (int ks = 0; ks < k_steps; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, Cs + (16 * mt + a_row(lane)) * kLdBN + 16 * ks + a_col(lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bh[4];
        ldmatrix_x4(bh, hs + (q_base + 16 * np + b_row(lane)) * kLdBN + 16 * ks + b_col(lane));
        mma_bf16(inter[2 * np], af, bh[0], bh[1]);
        mma_bf16(inter[2 * np + 1], af, bh[2], bh[3]);
      }
    }
    const float e0 = expf(c0), e1 = expf(c1);
    bf16* yb = y + ((static_cast<long long>(bb) * g.s + t0) * g.h + hh) * g.p;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int q = q_base + 8 * nt + 2 * t4;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = hr ? i1 : i0;
        const float ei = hr ? e1 : e0;
        if (i >= g.L || q >= g.p) continue;
        const float v0 = acc[nt][2 * hr] + ei * inter[nt][2 * hr];
        const float v1 = acc[nt][2 * hr + 1] + ei * inter[nt][2 * hr + 1];
        bf16* dst = yb + i * y_row + q;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (q + 1 < g.p) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
    __syncthreads();  // this buffer is free for the head after next
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
constexpr size_t kSmemOutMma =  // 90,112 bytes: two blocks an SM
    (kMaxL * kLdBN + 2 * kMaxP * kLdBN + 2 * kMaxL * kLdBP) * sizeof(bf16) +
    (kMaxL * kLdG + 4 * kMaxL) * sizeof(float);

inline long long round16(long long floats) { return (floats + 3) & ~3LL; }

// The workspace of a group of group_rows x seg_chunks chunks, in floats from
// ws: the f32 chunk states, then (bf16 inputs) the bf16 states before each
// chunk, then cum; each region on 16 bytes. Python's
// kernels/ssd_scan.py:workspace_floats computes the same size.
struct Workspace {
  float* states;
  bf16* hpre;
  float* cums;
};

inline Workspace carve(float* ws, long long slots, int p, int n, bool bf16_in) {
  Workspace w{};
  w.states = ws;
  long long off = round16(slots * p * n);
  if (bf16_in) {
    w.hpre = reinterpret_cast<bf16*>(ws + off);
    off += round16(slots * p * padded_n(n) / 2);
  }
  w.cums = ws + off;
  return w;
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           void* y, float* h_final, float* ws, int b, int s, int h, int p, int n, int L,
           int group_rows, int seg_chunks, const Strides& st, int x_vec, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemState));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = kBf16 ? cudaFuncSetAttribute(ssd_chunk_output_mma_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(kSmemOutMma))
              : cudaFuncSetAttribute(ssd_chunk_output_f32_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     static_cast<int>(kSmemOutF32));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = s / L;
  const Workspace w = carve(ws, static_cast<long long>(group_rows) * seg_chunks * h, p, n, kBf16);
  // heads a block: up to kMaxHeads, fewer where the grid would not fill
  // the card (132 SMs, a few blocks each)
  int hg = kMaxHeads;
  while (hg > 1 && static_cast<long long>(min(seg_chunks, nc)) * min(group_rows, b) *
                           ((h + hg - 1) / hg) < 1056)
    hg /= 2;
  const unsigned head_groups = static_cast<unsigned>((h + hg - 1) / hg);
  const bool vec = n % 4 == 0;
  for (int b0 = 0; b0 < b; b0 += group_rows) {
    for (int c0 = 0; c0 < nc; c0 += seg_chunks) {
      const Geometry g{b0, min(group_rows, b - b0), c0, min(seg_chunks, nc - c0),
                       s, h, p, n, L, hg};
      const dim3 grid(static_cast<unsigned>(g.nc), head_groups, static_cast<unsigned>(g.rows));
      ssd_chunk_state_kernel<T><<<grid, kThreads, kSmemState, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dt), a, static_cast<const T*>(bm),
          w.states, w.cums, g, st);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      const long long lanes = static_cast<long long>(g.rows) * h * p * n / (vec ? 4 : 1);
      const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) / kThreads);
      const int carry = c0 > 0;
      if (vec) {
        ssd_state_pass_kernel<float4, kBf16><<<blocks, kThreads, 0, stream>>>(
            w.states, w.cums, w.hpre, h_final, g, carry);
      } else {
        ssd_state_pass_kernel<float, kBf16><<<blocks, kThreads, 0, stream>>>(
            w.states, w.cums, w.hpre, h_final, g, carry);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      if (kBf16) {
        ssd_chunk_output_mma_kernel<<<grid, kThreads, kSmemOutMma, stream>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
            static_cast<const bf16*>(bm), static_cast<const bf16*>(cm), w.hpre, w.cums,
            static_cast<bf16*>(y), g, st, x_vec);
      } else {
        ssd_chunk_output_f32_kernel<<<grid, kThreads, kSmemOutF32, stream>>>(
            static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(bm), static_cast<const float*>(cm), w.states, w.cums,
            static_cast<float*>(y), g, st);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y; a is float32).
// strides = {x batch, x seq, x head, dt batch, dt seq, dt head, B batch,
// B seq, C batch, C seq}, in elements; x, B and C rows contiguous. y is
// (b, s, h, p) contiguous, h_final (b, h, p, n) f32 contiguous. ws holds
// the workspace of group_rows x seg_chunks chunks (see carve); a row is
// cut into segments (seg_chunks < s / chunk) only in groups of one row.
int sc_ssd_scan(const void* x, const void* dt, const float* a, const void* bmat,
                const void* cmat, void* y, float* h_final, float* ws, int b, int s, int h,
                int p, int n, int chunk, int group_rows, int seg_chunks,
                const long long* strides, int dtype, cudaStream_t stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (chunk < 1 || chunk > kMaxL || s % chunk != 0 || p < 1 || p > kMaxP || n < 1 ||
      n > kMaxN || b > 65535 || h > 65535 || group_rows < 1 ||
      group_rows > 65535 || seg_chunks < 1 || (seg_chunks < s / chunk && group_rows != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{};
  for (int i = 0; i < 10; ++i) st.v[i] = strides[i];
  if (dtype == 0)
    return launch<float>(x, dt, a, bmat, cmat, y, h_final, ws, b, s, h, p, n, chunk, group_rows,
                         seg_chunks, st, 0, stream);
  if (dtype == 1) {
    // x's rows on 16 bytes: kernel 3 copies them with cp.async
    const int x_vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 && st.v[0] % 8 == 0 &&
                      st.v[1] % 8 == 0 && st.v[2] % 8 == 0;
    return launch<bf16>(x, dt, a, bmat, cmat, y, h_final, ws, b, s, h, p, n, chunk, group_rows,
                        seg_chunks, st, x_vec, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
