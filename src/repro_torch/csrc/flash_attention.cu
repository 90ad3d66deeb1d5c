// Hand-written Hopper (sm_90a) flash attention for f32 inputs on the CUDA
// cores: the forward and the two backward kernels.
//
// Replaces, in src/repro/kernels/flash_attention.py:
//   _fwd_kernel     (:41,  pallas_call at :133) -> flash_fwd_kernel
//   _bwd_dq_kernel  (:167, pallas_call at :289) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:209, pallas_call at :303) -> flash_bwd_dkv_kernel
// for f32 inputs; every bf16 launch runs on the tensor cores
// (flash_attention_mma.cu), as the wrapper's variant picks, and the entry
// points here refuse bf16. Inputs q, do (b, hq, sq, d) and k, v (b, hkv,
// sk, d), each with its own batch, head and row strides (the last dimension
// contiguous); o, dq (b, hq, sq, d) and dk, dv (b, hkv, sk, d) are written
// contiguous, lse and delta (b, hq, sq) are contiguous f32. Query head h
// reads kv head h / (hq / hkv) (GQA, with no repeat). Causal masking keeps
// col <= row, counted from the top left also when sq != sk, as the Pallas
// kernels do; columns >= sk are masked by bounds. A row with no unmasked
// column gets o = 0 and lse = +inf in the forward, and p = exp(s - lse) = 0
// in the backward, so it gives dq = 0 and adds nothing to dk and dv. The
// plain PyTorch versions of the same functions are attention_with_lse and
// attention_bwd in src/repro_torch/kernels/ref.py.
//
// Bound: with b, hq, sq, sk, d and P causal (q, k) pairs, the forward does
// 4·P·d operations, dq 6·P·d (S, dP, dS·K) and dkv 8·P·d (S, dP, Pᵀ·dO,
// dSᵀ·Q). At the training shape (b 2, 32 heads, 4096 positions, d 80,
// causal) that is 172, 258 and 344 GFLOP: 2.56, 3.85 and 5.13 ms at the 67
// TFLOP/s of f32 outside the tensor cores, against 0.05-0.08 ms of bytes at
// 3.35 TB/s. Every product is an f32 FMA (the port keeps f32 in full f32,
// with no TF32), so the f32 rate bounds these kernels; an H100 SM's shared
// memory gives 32 floats a clock to 128 FMA lanes, so a kernel must do at
// least 4 FMAs for each float it reads from shared memory to reach it.
//
// - forward (flash_fwd_kernel): one block per (batch, query head, BM query
//   rows), the query tiles with the most kv tiles first (grid.y counts
//   down). TX threads share each group of 8 query rows: TX = 8 up to DP 96,
//   16 above, where the O accumulator of 8 rows x DP / TX columns must still
//   fit in registers. Up to DP 96 a block has 256 threads (BM 256: two
//   warps a scheduler, 4.91 against 5.81 ms with 128 threads at the
//   training shape on an H100), above 128 (BM 64: at DP 160, 256 threads
//   and BM 128 took 0.562 against 0.528 ms at the serving oracle's shape);
//   one block an SM either way (device time, chip_smoke.py's kernel phase).
//   A thread computes an 8 x (64 / TX) tile of S = Q·Kᵀ over a 64-row kv
//   tile from float4 reads along the depth (Q rows broadcast within a
//   quarter-warp, K rows tx + TX·j, which the 4-float row padding
//   puts in distinct banks): 8 x 8 gives 4 FMAs a float read, 8 x 4 (DP >=
//   112) 2.67. The online softmax runs in base 2 in registers (exp2f with
//   log2 e folded into the scale; lse converted back to base e), row max
//   and sum over the TX threads of a row by shuffle, the normaliser a
//   per-thread partial until the end. P goes to shared memory, and
//   O += P·V reads it as float4 along kv and V as floats at columns
//   tx + TX·c: 8 x 4 x DP / TX FMAs for 32 + 4·DP / TX floats (4.4 at d
//   80). K and V have a buffer each, filled by 16-byte cp.async straight
//   from device memory: V_i's copies run under S_i's math, K_(i+1)'s under
//   the softmax and P·V_i, three barriers a tile. The head dim is padded to
//   DP, a multiple of 16 up to 128 (d 80 runs at 80), then 160 or 256;
//   only the diagonal and ragged tiles are masked, and tiles wholly above
//   the diagonal are never loaded. Inputs whose rows are not on 16 bytes
//   take an ALIGNED = false instantiation with element loads.
// - dq: one block per (batch, query head, 64 query rows), Q and dO resident;
//   for each kv tile up to the causal end, V then K through one buffer:
//   dP = dO·Vᵀ goes to shared memory, S = Q·Kᵀ stays in registers, then
//   dS = p ⊙ (dP - delta)·scale with p = exp(S·scale - lse) overwrites dP,
//   and dq += dS·K with K still in place. dq is written once.
// - dkv: one block per (batch, kv head, 32 kv rows), K and V resident; it
//   loops over the group's query heads and, for each, over the 64-row query
//   tiles from the causal start, computing Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with
//   R = 2 rows per thread, then dv += Pᵀ·dO and dk += dSᵀ·Q. 32 kv rows keep
//   both accumulators (2 x 2 x 4·DP/32 floats) in registers at DP 256, where
//   64 rows would not fit. A kv head owns its block, so the group sum of the
//   Pallas wrapper (:343-356) needs no second pass and no float atomics:
//   the backward is deterministic.
//   dq and dkv stream 64-row tiles through shared memory with R rows and
//   4·(DP/32) output columns a thread (dot_rows and acc_rows below), the
//   head dim padded to DP in {64, 96, 128, 160, 256}.
// - delta = rowsum(do ⊙ o) is computed by the caller in PyTorch, as the
//   reference computes it in jnp outside its kernels (:272).
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py's build log), the forward with
// 16-byte copies: DP 16-80 210-254 registers and no spills (80: 254); DP 96
// 255 with 64 bytes of spill stores and DP 112 168 with 24 (no config has a
// head dim in 81-112); DP 128 226, 160 254, 256 252, no spills.
//
// Interface: plain extern "C" functions loaded with ctypes. Each launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

using sc_mma::cp_async_16;
using sc_mma::cp_async_commit;
using sc_mma::cp_async_wait;

constexpr int kBQ = 64;       // query rows per tile (dq, dkv)
constexpr int kBK = 64;       // kv rows per tile
constexpr int kBKV = 32;      // kv rows per dkv block
constexpr int kThreads = 128; // threads per block
constexpr int kLDP = kBK + 4; // row stride of a 64-column score tile, floats
constexpr int kTM = 8;        // query rows per thread in the forward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long v[12];  // {q, k, v, do} x {batch, head, row}, in elements
};

// rows [r0, r0 + nrows) of one head, columns [0, d), into a ROWS x DP f32
// tile with row stride DP + 4, by the block's NT threads; zeros outside.
template <int ROWS, int DP, int NT = kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long row_stride,
                                          int r0, int nrows, int d) {
  for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    float val = 0.f;
    if (r0 + r < nrows && c < d) val = src[static_cast<long long>(r0 + r) * row_stride + c];
    dst[r * (DP + 4) + c] = val;
  }
}

// The same tile by 16-byte cp.async copies (the caller commits and waits),
// zero-filled past nrows and d, when ALIGNED (every row on 16 bytes);
// otherwise by load_tile.
template <bool ALIGNED, int ROWS, int DP, int NT>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, long long row_stride,
                                          int r0, int nrows, int d) {
  if constexpr (ALIGNED) {
    constexpr int kChunks = DP / 4;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
      const int r = i / kChunks, c = (i - r * kChunks) * 4;
      const bool in = r0 + r < nrows && c < d;
      cp_async_16(dst + r * (DP + 4) + c, in ? src + (r0 + r) * row_stride + c : src,
                  in ? 4 * min(4, d - c) : 0);
    }
  } else {
    load_tile<ROWS, DP, NT>(dst, src, row_stride, r0, nrows, d);
  }
}

// s[i][j] = A[ty·R + i] · B[tx + 8j] over DP columns (two tiles of row
// stride DP + 4).
template <int R, int DP>
__device__ __forceinline__ void dot_rows(float (&s)[R][8], const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DP; kk += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty * R + i) * LD + kk]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 bv = *reinterpret_cast<const float4*>(&B[(tx + 8 * j) * LD + kk]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float t = s[i][j];
        t = fmaf(a[i].x, bv.x, t);
        t = fmaf(a[i].y, bv.y, t);
        t = fmaf(a[i].z, bv.z, t);
        t = fmaf(a[i].w, bv.w, t);
        s[i][j] = t;
      }
    }
  }
}

// acc[i][4·nc + e] += Σ_c P[ty·R + i][c] · B[c][tx·4 + 32·nc + e] over the
// 64 columns of a score tile P (row stride kLDP) and 64 rows of B (row
// stride DP + 4).
template <int R, int DP>
__device__ __forceinline__ void acc_rows(float (&acc)[R][DP / 8], const float* P, const float* B,
                                         int ty, int tx) {
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 32;
#pragma unroll 2
  for (int c = 0; c < kBK; c += 4) {
    float4 pa[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      pa[i] = *reinterpret_cast<const float4*>(&P[(ty * R + i) * kLDP + c]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int nc = 0; nc < NC; ++nc) {
        const float4 bv = *reinterpret_cast<const float4*>(&B[(c + cc) * LD + tx * 4 + 32 * nc]);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
          acc[i][nc * 4 + 0] = fmaf(p, bv.x, acc[i][nc * 4 + 0]);
          acc[i][nc * 4 + 1] = fmaf(p, bv.y, acc[i][nc * 4 + 1]);
          acc[i][nc * 4 + 2] = fmaf(p, bv.z, acc[i][nc * 4 + 2]);
          acc[i][nc * 4 + 3] = fmaf(p, bv.w, acc[i][nc * 4 + 3]);
        }
      }
    }
  }
}

// R output rows of a thread, columns tx·4 + 32·nc + e below d, into a
// contiguous (rows, d) output from row index row0 (rows below nrows only).
template <int R, int DP>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[R][DP / 8], long long row0,
                                           int r0, int nrows, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + ty * R + i;
    if (row >= nrows) continue;
    float* orow = out + (row0 + row) * d;
#pragma unroll
    for (int nc = 0; nc < DP / 32; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 32 * nc + e;
        if (col < d) orow[col] = acc[i][nc * 4 + e];
      }
  }
}


// The forward's geometry (see the header): NT threads a block, TX threads
// per 8 query rows, BM = 8·NT/TX query rows a block, 64 kv rows a tile.
template <int DP>
__host__ __device__ constexpr int fwd_threads() { return DP <= 96 ? 256 : 128; }
template <int DP>
__host__ __device__ constexpr int fwd_tx() { return DP <= 96 ? 8 : 16; }
template <int DP>
__host__ __device__ constexpr int fwd_rows() { return kTM * (fwd_threads<DP>() / fwd_tx<DP>()); }

template <int DP>
constexpr size_t fwd_smem_bytes() {  // Q, K, V, then P
  return sizeof(float) * (static_cast<size_t>(fwd_rows<DP>() + 2 * kBK) * (DP + 4) +
                          static_cast<size_t>(fwd_rows<DP>()) * kLDP);
}
template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(2 * kBQ + kBK) * (DP + 4) + kBQ * kLDP);
}
template <int DP>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(2 * kBKV + 2 * kBQ) * (DP + 4) +
                          2 * kBKV * kLDP + 2 * kBQ);
}

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(fwd_threads<DP>())
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int hq, int group, int sq, int sk, int d, Strides st, float scale, int causal) {
  constexpr int NT = fwd_threads<DP>();
  constexpr int TX = fwd_tx<DP>();
  constexpr int BM = fwd_rows<DP>();
  constexpr int TN = kBK / TX;  // score columns per thread: tx + TX·j
  constexpr int NA = DP / TX;   // output columns per thread: tx + TX·c
  constexpr int LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;  // BM x kLDP

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows first
  const int hk = h / group;
  const float* kb = k + b * st.v[3] + hk * st.v[4];
  const float* vb = v + b * st.v[6] + hk * st.v[7];
  const long long kss = st.v[5], vss = st.v[8];
  const int kend = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  const float scale_log2 = scale * kLog2e;  // exp(x·scale) = exp2(x·scale·log2 e)

  copy_tile<ALIGNED, BM, DP, NT>(Qs, q + b * st.v[0] + h * st.v[1], st.v[2], q0, sq, d);
  if (ntiles > 0) copy_tile<ALIGNED, kBK, DP, NT>(Ks, kb, kss, 0, sk, d);
  cp_async_commit();

  const int row0 = q0 + ty * kTM;  // the thread's first query row
  const float* Qt = Qs + ty * kTM * LD;
  float* Pt = Ps + ty * kTM * kLDP;
  float acc[kTM][NA];
  float m[kTM], l[kTM];  // running row max of s·scale·log2 e; this thread's normaliser
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<0>();  // K_it (and Q)
    __syncthreads();     // ... seen by every thread, and every thread is done with V and P
    copy_tile<ALIGNED, kBK, DP, NT>(Vs, vb, vss, k0, sk, d);  // V_it, under S_it's math
    cp_async_commit();

    float s[kTM][TN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DP; kk += 4) {  // S = Q·Kᵀ
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = *reinterpret_cast<const float4*>(Qt + i * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 bk = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * LD + kk);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float x = s[i][j];
          x = fmaf(a[i].x, bk.x, x);
          x = fmaf(a[i].y, bk.y, x);
          x = fmaf(a[i].z, bk.z, x);
          x = fmaf(a[i].w, bk.w, x);
          s[i][j] = x;
        }
      }
    }
    __syncthreads();  // every thread is done with K_it
    if (it + 1 < ntiles) {  // K_(it+1), under the softmax and P·V_it
      copy_tile<ALIGNED, kBK, DP, NT>(Ks, kb, kss, k0 + kBK, sk, d);
      cp_async_commit();
    }

    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > q0)) {  // a ragged or diagonal tile
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = k0 + tx + TX * j;
          if (col >= sk || (causal && col > row0 + i)) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {  // the online softmax of each of the thread's rows
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < TX; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
      const float corr = exp2f(m[i] - base);                 // 0 from m = -inf
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {  // a masked column gives exp2(-inf) = 0
        const float p = exp2f(fmaf(s[i][j], scale_log2, -base));
        Pt[i * kLDP + tx + TX * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < NA; ++c) acc[i][c] *= corr;
    }
    if (it + 1 < ntiles) {
      cp_async_wait<1>();  // V_it; K_(it+1) may still be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // P and V_it in place

#pragma unroll 2
    for (int j0 = 0; j0 < kBK; j0 += 4) {  // O += P·V
      float4 p[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) p[i] = *reinterpret_cast<const float4*>(Pt + i * kLDP + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = Vs + (j0 + jj) * LD + tx;
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          const float vv = vrow[TX * c];
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
            acc[i][c] = fmaf(pj, vv, acc[i][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (Q when ntiles = 0)

  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < TX; off <<= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const int row = row0 + i;
    if (row >= sq) continue;
    if (tx == 0) lse[head_row0 + row] = li > 0.f ? m[i] * kLn2 + logf(li) : INFINITY;
    const float f = li > 0.f ? 1.f / li : 0.f;
    float* orow = o + (head_row0 + row) * d;
#pragma unroll
    for (int c = 0; c < NA; ++c) {
      const int col = tx + TX * c;
      if (col < d) orow[col] = acc[i][c] * f;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int hq, int group, int sq, int sk, int d,
                    long long qsb, long long qsh, long long qss,
                    long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss,
                    long long dsb, long long dsh, long long dss,
                    float scale, int causal) {
  constexpr int LD = DP + 4;
  constexpr int NA = DP / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * LD;
  float* KV = dOs + kBQ * LD;
  float* dSs = KV + kBK * LD;  // dP, then dS in place

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;

  load_tile<kBQ, DP>(Qs, q + b * qsb + h * qsh, qss, q0, sq, d);
  load_tile<kBQ, DP>(dOs, dout + b * dsb + h * dsh, dss, q0, sq, d);
  float row_lse[4], row_delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < sq ? lse[head_row0 + row] : INFINITY;  // a padded row gives p = 0
    row_delta[i] = row < sq ? delta[head_row0 + row] : 0.f;
  }
  float acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;

  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's dS·K is done with KV and dSs
    load_tile<kBK, DP>(KV, vb, vss, k0, sk, d);
    __syncthreads();
    float s[4][8];
    dot_rows<4, DP>(s, dOs, KV, ty, tx);  // dP = dO·Vᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dSs[(ty * 4 + i) * kLDP + tx + 8 * j] = s[i][j];
    __syncthreads();  // every thread is done reading V
    load_tile<kBK, DP>(KV, kb, kss, k0, sk, d);
    __syncthreads();
    dot_rows<4, DP>(s, Qs, KV, ty, tx);   // S = Q·Kᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool keep = col < sk && (!causal || col <= row);
        const float p = keep ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        float* ds = &dSs[(ty * 4 + i) * kLDP + tx + 8 * j];
        *ds = p * (*ds - row_delta[i]) * scale;
      }
    }
    __syncthreads();  // dS is in place
    acc_rows<4, DP>(acc, dSs, KV, ty, tx);  // dq += dS·K
  }
  store_rows<4, DP>(dq, acc, head_row0, q0, sq, d, ty, tx);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                     int hq, int group, int sq, int sk, int d,
                     long long qsb, long long qsh, long long qss,
                     long long ksb, long long ksh, long long kss,
                     long long vsb, long long vsh, long long vss,
                     long long dsb, long long dsh, long long dss,
                     float scale, int causal) {
  constexpr int LD = DP + 4;
  constexpr int NA = DP / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBKV * LD;
  float* Qs = Vs + kBKV * LD;
  float* dOs = Qs + kBQ * LD;
  float* Ps = dOs + kBQ * LD;    // Pᵀ, kBKV x kLDP
  float* dSs = Ps + kBKV * kLDP; // dSᵀ
  float* Ls = dSs + kBKV * kLDP; // the query tile's lse
  float* Ds = Ls + kBQ;          // and delta

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int k0 = blockIdx.x * kBKV, hk = blockIdx.y, b = blockIdx.z;
  const int hkv = gridDim.y;
  load_tile<kBKV, DP>(Ks, k + b * ksb + hk * ksh, kss, k0, sk, d);
  load_tile<kBKV, DP>(Vs, v + b * vsb + hk * vsh, vss, k0, sk, d);

  float dka[2][NA], dva[2][NA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dka[i][c] = dva[i][c] = 0.f;

  // causal: query tiles wholly above this kv block's first row see none of it
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qb = q + b * qsb + h * qsh;
    const float* db = dout + b * dsb + h * dsh;
    const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
    for (int q0 = qstart; q0 < sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's products are done with Qs, dOs, Ps, dSs
      load_tile<kBQ, DP>(Qs, qb, qss, q0, sq, d);
      load_tile<kBQ, DP>(dOs, db, dss, q0, sq, d);
      for (int i = threadIdx.x; i < kBQ; i += kThreads) {
        const int row = q0 + i;
        Ls[i] = row < sq ? lse[head_row0 + row] : INFINITY;  // a padded row gives p = 0
        Ds[i] = row < sq ? delta[head_row0 + row] : 0.f;
      }
      __syncthreads();
      float s[2][8], dp[2][8];
      dot_rows<2, DP>(s, Ks, Qs, ty, tx);    // Sᵀ = K·Qᵀ
      dot_rows<2, DP>(dp, Vs, dOs, ty, tx);  // dPᵀ = V·dOᵀ
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = k0 + ty * 2 + i;   // the kv row is the score's column
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = tx + 8 * j;
          const bool keep = col < sk && (!causal || col <= q0 + qc);
          const float p = keep ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
          Ps[(ty * 2 + i) * kLDP + qc] = p;
          dSs[(ty * 2 + i) * kLDP + qc] = p * (dp[i][j] - Ds[qc]) * scale;
        }
      }
      __syncthreads();  // Pᵀ and dSᵀ are in place
      acc_rows<2, DP>(dva, Ps, dOs, ty, tx);  // dv += Pᵀ·dO
      acc_rows<2, DP>(dka, dSs, Qs, ty, tx);  // dk += dSᵀ·Q
    }
  }
  const long long kv_row0 = (static_cast<long long>(b) * hkv + hk) * sk;
  store_rows<2, DP>(dk, dka, kv_row0, k0, sk, d, ty, tx);
  store_rows<2, DP>(dv, dva, kv_row0, k0, sk, d, ty, tx);
}


template <int DP, bool ALIGNED>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DP>();
  const auto kernel = flash_fwd_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + fwd_rows<DP>() - 1) / fwd_rows<DP>());
  kernel<<<grid, fwd_threads<DP>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, hq, hq / hkv, sq, sk, d, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq,
              int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
              float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  const long long* s = st.v;
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), hq, hq / hkv, sq,
      sk, d, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kBKV - 1) / kBKV, hkv, b);
  const long long* s = st.v;
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), hq, hq / hkv, sq, sk, d,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The backward kernels' padded head dim: the smallest of {64, 96, 128, 160,
// 256} that holds d, or 0 when none does.
inline int padded_dim(int d) {
  if (d <= 0) return 0;
  if (d <= 64) return 64;
  if (d <= 96) return 96;
  if (d <= 128) return 128;
  if (d <= 160) return 160;
  if (d <= 256) return 256;
  return 0;
}

// The forward's: d rounded up to a multiple of 16 up to 128, then 160 or 256.
inline int forward_dim(int d) {
  if (d <= 0 || d > 256) return 0;
  if (d <= 128) return (d + 15) / 16 * 16;
  return d <= 160 ? 160 : 256;
}

bool bad_shape(int b, int hq, int hkv, int d) {
  return padded_dim(d) == 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535 ||
         hkv > 65535;
}

// Whether every row of a (batch, head, row) strided f32 tensor starts on 16
// bytes: the base address, and the strides of the dimensions longer than 1.
bool rows_aligned(const void* p, const long long* s, long long n0, long long n1, long long n2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (n0 <= 1 || s[0] % 4 == 0) &&
         (n1 <= 1 || s[1] % 4 == 0) && (n2 <= 1 || s[2] % 4 == 0);
}

template <int DP>
int fwd_at(bool aligned, const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int hkv, int sq, int sk, int d, const Strides& st, float scale,
           int causal, cudaStream_t stream) {
  return aligned ? launch_fwd<DP, true>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, st, scale,
                                        causal, stream)
                 : launch_fwd<DP, false>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, st, scale,
                                         causal, stream);
}

Strides copy_strides(const long long* s, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.v[i] = s[i];
  return st;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (1 = bfloat16 is refused: sc_flash_fwd_mma runs it).
// strides = {q batch, q head, q row, k batch, k head, k row, v batch,
// v head, v row}, in elements.
int sc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int hq, int hkv, int sq, int sk, int d,
                 const long long* strides, float scale, int causal, int dtype,
                 cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dtype != 0 || bad_shape(b, hq, hkv, d) || static_cast<long long>(b) * hq > 0x7fffffffLL ||
      (sq + 63) / 64 > 65535)
    return kInvalid;
  const Strides st = copy_strides(strides, 9);
  const bool aligned = rows_aligned(q, strides, b, hq, sq) &&
                       rows_aligned(k, strides + 3, b, hkv, sk) &&
                       rows_aligned(v, strides + 6, b, hkv, sk);
  switch (forward_dim(d)) {
#define SC_FWD(DP) \
  case DP: return fwd_at<DP>(aligned, q, k, v, o, lse, b, hq, hkv, sq, sk, d, st, scale, causal, stream);
    SC_FWD(16) SC_FWD(32) SC_FWD(48) SC_FWD(64) SC_FWD(80) SC_FWD(96) SC_FWD(112)
    SC_FWD(128) SC_FWD(160) SC_FWD(256)
#undef SC_FWD
    default: return kInvalid;
  }
}

// dq (b, hq, sq, d) from q, k, v, do, lse and delta; float32 only (dtype 1,
// bf16, is refused: sc_flash_bwd_dq_mma runs it). strides = the forward's
// nine, then {do batch, do head, do row}.
int sc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq,
                    int b, int hq, int hkv, int sq, int sk, int d,
                    const long long* strides, float scale, int causal, int dtype,
                    cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dtype != 0 || bad_shape(b, hq, hkv, d)) return kInvalid;
  const Strides st = copy_strides(strides, 12);
  switch (padded_dim(d)) {
#define SC_DQ(DP) \
  case DP: return launch_dq<DP>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, d, st, scale, causal, stream);
    SC_DQ(64) SC_DQ(96) SC_DQ(128) SC_DQ(160) SC_DQ(256)
#undef SC_DQ
    default: return kInvalid;
  }
}

// dk, dv (b, hkv, sk, d), each summed over its kv head's query heads;
// float32 only (dtype 1, bf16, is refused: sc_flash_bwd_dkv_mma runs it).
// Strides as for sc_flash_bwd_dq.
int sc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     const long long* strides, float scale, int causal, int dtype,
                     cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || sk <= 0) return 0;
  if (dtype != 0 || bad_shape(b, hq, hkv, d)) return kInvalid;
  const Strides st = copy_strides(strides, 12);
  switch (padded_dim(d)) {
#define SC_DKV(DP) \
  case DP: return launch_dkv<DP>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, d, st, scale, causal, stream);
    SC_DKV(64) SC_DKV(96) SC_DKV(128) SC_DKV(160) SC_DKV(256)
#undef SC_DKV
    default: return kInvalid;
  }
}

}  // extern "C"
