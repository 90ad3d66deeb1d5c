// Hand-written Hopper (sm_90a) flash attention for the model stack on the
// CUDA cores: the forward and the two backward kernels.
//
// Replaces, in src/repro/kernels/flash_attention.py:
//   _fwd_kernel     (:41,  pallas_call at :133) -> flash_fwd_kernel
//   _bwd_dq_kernel  (:167, pallas_call at :289) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:209, pallas_call at :303) -> flash_bwd_dkv_kernel
// The forward and dq here serve f32 inputs, and dk/dv f32 and also bf16 at
// head widths above 128 (160, 256); bf16 forwards, bf16 dq and bf16 dk/dv up
// to 128 run on the tensor cores (flash_attention_mma.cu), as the wrapper's
// variant picks, and their instantiations here are not built.
// Inputs q, do (b, hq, sq, d) and k, v (b, hkv, sk, d) in f32 or bf16, each
// with its own batch, head and row strides (the last dimension contiguous);
// o, dq (b, hq, sq, d) and dk, dv (b, hkv, sk, d) are written contiguous in
// the inputs' type, lse and delta (b, hq, sq) are contiguous f32. Query head
// h reads kv head h / (hq / hkv) (GQA, with no repeat). Causal masking keeps
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
// causal) that is 172, 258 and 344 GFLOP: 2.6, 3.9 and 5.1 ms at the 67
// TFLOP/s of f32 outside the tensor cores, 0.17-0.35 ms at the tensor
// cores' 989 TFLOP/s bf16, against 0.05-0.08 ms of bytes at 3.35 TB/s.
// These kernels compute every product in f32 FMAs on the CUDA cores, so
// the f32 rate bounds them (the port keeps f32 in full f32, with no TF32);
// bf16 runs on the tensor cores but for dk/dv above head dim 128.
//
// Design. Every kernel runs 128 threads over 64-row tiles that stream
// through shared memory, converted to f32, so the Pallas kernels' sequential
// grid axis becomes a loop in the block (H100 blocks run in no order and
// carry nothing between them). A thread owns R rows of a 64-column score
// tile (columns tx + 8j) and 4·(DP/32) columns of its output rows (dot_rows
// and acc_rows below); score tiles pass through shared memory between the
// two products. Shared rows are padded by 4 floats so the float4 reads of a
// row fall in distinct banks. The head dim is padded at compile time to DP
// in {64, 96, 128, 160, 256} (zeros in shared memory): stablelm-3b's 80
// runs at DP 96 (16.7% of the FMAs wasted), gemma-7b's 256 fits. Shared
// memory above the default 48 KB is set per launch with
// cudaFuncSetAttribute.
//
// - forward: one block per (batch, query head, 64 query rows); kv tiles of
//   64 rows stream through one buffer (K, then V); R = 4 rows per thread,
//   the online-softmax state (running max, normaliser, O accumulator) in f32
//   registers as in the Pallas kernel (:63-85); row max and row sum reduce
//   across the 8 threads of a row by shuffle; kv tiles wholly above the
//   causal diagonal are skipped.
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
// - delta = rowsum(do ⊙ o) is computed by the caller in PyTorch, as the
//   reference computes it in jnp outside its kernels (:272).
//
// Interface: plain extern "C" functions loaded with ctypes. Each launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // kv rows per tile (forward, dq)
constexpr int kBKV = 32;      // kv rows per dkv block
constexpr int kThreads = 128; // 16 row groups x 8 threads per row
constexpr int kLDP = kBK + 4; // row stride of a 64-column score tile, floats

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// rows [r0, r0 + nrows) of one head, columns [0, d), into a ROWS x DP f32
// tile with row stride DP + 4; zeros outside.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int r0, int nrows, int d) {
  for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float val = 0.f;
    if (r0 + r < nrows && c < d) val = to_f32(src[static_cast<long long>(r0 + r) * row_stride + c]);
    dst[r * (DP + 4) + c] = val;
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
template <typename T, int R, int DP>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[R][DP / 8], long long row0,
                                           int r0, int nrows, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + ty * R + i;
    if (row >= nrows) continue;
    T* orow = out + (row0 + row) * d;
#pragma unroll
    for (int nc = 0; nc < DP / 32; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 32 * nc + e;
        if (col < d) store(&orow[col], acc[i][nc * 4 + e]);
      }
  }
}

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (DP + 4) + kBQ * kLDP);
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

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 int hq, int group, int sq, int sk, int d,
                 long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss,
                 long long vsb, long long vsh, long long vss,
                 float scale, int causal) {
  static_assert(DP % 32 == 0, "O columns are spread as float4 over 8 threads");
  constexpr int LD = DP + 4;
  constexpr int NA = DP / 8;  // O columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + kBQ * LD;
  float* Ps = KV + kBK * LD;

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  load_tile<T, kBQ, DP>(Qs, qb, qss, q0, sq, d);

  float acc[4][NA];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's PV is done with KV and Ps
    load_tile<T, kBK, DP>(KV, kb, kss, k0, sk, d);
    __syncthreads();

    float s[4][8];
    dot_rows<4, DP>(s, Qs, KV, ty, tx);

    // mask, then the online-softmax update of each of the thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool keep = col < sk && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float safe = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - safe);  // a masked column gives exp(-inf) = 0
        Ps[(ty * 4 + i) * kLDP + tx + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - safe);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NA; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K
    load_tile<T, kBK, DP>(KV, vb, vss, k0, sk, d);
    __syncthreads();  // V and P are in place
    acc_rows<4, DP>(acc, Ps, KV, ty, tx);
  }

  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] /= safe_l;
    const int row = q0 + ty * 4 + i;
    if (row < sq && tx == 0) lse[head_row0 + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
  store_rows<T, 4, DP>(o, acc, head_row0, q0, sq, d, ty, tx);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
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
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;

  load_tile<T, kBQ, DP>(Qs, q + b * qsb + h * qsh, qss, q0, sq, d);
  load_tile<T, kBQ, DP>(dOs, dout + b * dsb + h * dsh, dss, q0, sq, d);
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
    load_tile<T, kBK, DP>(KV, vb, vss, k0, sk, d);
    __syncthreads();
    float s[4][8];
    dot_rows<4, DP>(s, dOs, KV, ty, tx);  // dP = dO·Vᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dSs[(ty * 4 + i) * kLDP + tx + 8 * j] = s[i][j];
    __syncthreads();  // every thread is done reading V
    load_tile<T, kBK, DP>(KV, kb, kss, k0, sk, d);
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
  store_rows<T, 4, DP>(dq, acc, head_row0, q0, sq, d, ty, tx);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
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
  load_tile<T, kBKV, DP>(Ks, k + b * ksb + hk * ksh, kss, k0, sk, d);
  load_tile<T, kBKV, DP>(Vs, v + b * vsb + hk * vsh, vss, k0, sk, d);

  float dka[2][NA], dva[2][NA];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NA; ++c) dka[i][c] = dva[i][c] = 0.f;

  // causal: query tiles wholly above this kv block's first row see none of it
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qsb + h * qsh;
    const T* db = dout + b * dsb + h * dsh;
    const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
    for (int q0 = qstart; q0 < sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's products are done with Qs, dOs, Ps, dSs
      load_tile<T, kBQ, DP>(Qs, qb, qss, q0, sq, d);
      load_tile<T, kBQ, DP>(dOs, db, dss, q0, sq, d);
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
  store_rows<T, 2, DP>(dk, dka, kv_row0, k0, sk, d, ty, tx);
  store_rows<T, 2, DP>(dv, dva, kv_row0, k0, sk, d, ty, tx);
}

struct Strides {
  long long v[12];  // {q, k, v, do} x {batch, head, row}, in elements
};

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  const long long* s = st.v;
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hq / hkv, sq, sk, d,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq,
              int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
              float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  const long long* s = st.v;
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), hq, hq / hkv, sq, sk, d,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kBKV - 1) / kBKV, hkv, b);
  const long long* s = st.v;
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hq / hkv, sq, sk, d,
      s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The head dim's padded width: the smallest of {64, 96, 128, 160, 256} that
// holds d, or 0 when none does.
inline int padded_dim(int d) {
  if (d <= 0) return 0;
  if (d <= 64) return 64;
  if (d <= 96) return 96;
  if (d <= 128) return 128;
  if (d <= 160) return 160;
  if (d <= 256) return 256;
  return 0;
}

bool bad_shape(int b, int hq, int hkv, int d) {
  return padded_dim(d) == 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535 ||
         hkv > 65535;
}

// Calls F::template run<T, DP>() for the dtype code and d's padded width.
template <typename F>
int dispatch(int dtype, int d, F f) {
  switch (dtype * 1000 + padded_dim(d)) {
    case 64: return f.template run<float, 64>();
    case 96: return f.template run<float, 96>();
    case 128: return f.template run<float, 128>();
    case 160: return f.template run<float, 160>();
    case 256: return f.template run<float, 256>();
    case 1064: return f.template run<__nv_bfloat16, 64>();
    case 1096: return f.template run<__nv_bfloat16, 96>();
    case 1128: return f.template run<__nv_bfloat16, 128>();
    case 1160: return f.template run<__nv_bfloat16, 160>();
    case 1256: return f.template run<__nv_bfloat16, 256>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 forward and dq, and bf16 dk/dv up to DP 128, run on the tensor
// cores (flash_attention_mma.cu): their CUDA-core instantiations are not
// built.
struct FwdCall {
  const void *q, *k, *v; void* o; float* lse;
  int b, hq, hkv, sq, sk, d; Strides st; float scale; int causal; cudaStream_t stream;
  template <typename T, int DP> int run() const {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch_fwd<T, DP>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, st, scale, causal,
                               stream);
    }
  }
};

struct DqCall {
  const void *q, *k, *v, *dout; const float *lse, *delta; void* dq;
  int b, hq, hkv, sq, sk, d; Strides st; float scale; int causal; cudaStream_t stream;
  template <typename T, int DP> int run() const {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch_dq<T, DP>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, d, st, scale,
                              causal, stream);
    }
  }
};

struct DkvCall {
  const void *q, *k, *v, *dout; const float *lse, *delta; void *dk, *dv;
  int b, hq, hkv, sq, sk, d; Strides st; float scale; int causal; cudaStream_t stream;
  template <typename T, int DP> int run() const {
    if constexpr (std::is_same_v<T, __nv_bfloat16> && DP <= 128) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch_dkv<T, DP>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, d, st,
                               scale, causal, stream);
    }
  }
};

Strides copy_strides(const long long* s, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.v[i] = s[i];
  return st;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (refused: sc_flash_fwd_mma runs it).
// strides = {q batch, q head, q row, k batch, k head, k row, v batch,
// v head, v row}, in elements.
int sc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int hq, int hkv, int sq, int sk, int d,
                 const long long* strides, float scale, int causal, int dtype,
                 cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, FwdCall{q, k, v, o, lse, b, hq, hkv, sq, sk, d,
                                    copy_strides(strides, 9), scale, causal, stream});
}

// dq (b, hq, sq, d) from q, k, v, do, lse and delta; float32 only (bf16
// refused: sc_flash_bwd_dq_mma runs it). strides = the forward's nine, then
// {do batch, do head, do row}.
int sc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq,
                    int b, int hq, int hkv, int sq, int sk, int d,
                    const long long* strides, float scale, int causal, int dtype,
                    cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, DqCall{q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, d,
                                   copy_strides(strides, 12), scale, causal, stream});
}

// dk, dv (b, hkv, sk, d), each summed over its kv head's query heads.
// Strides as for sc_flash_bwd_dq; bf16 only above head dim 128 (below,
// sc_flash_bwd_dkv_mma runs it).
int sc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     const long long* strides, float scale, int causal, int dtype,
                     cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || sk <= 0) return 0;
  if (bad_shape(b, hq, hkv, d)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, d, DkvCall{q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, d,
                                    copy_strides(strides, 12), scale, causal, stream});
}

}  // extern "C"
