// Hand-written Hopper (sm_90a) flash-attention forward for the model stack.
//
// Replaces _fwd_kernel (src/repro/kernels/flash_attention.py:41, launched by
// pallas_call at :133). Inputs q (b, hq, sq, d) and k, v (b, hkv, sk, d) in
// f32 or bf16, each with its own batch, head and row strides (the last
// dimension contiguous); outputs o (b, hq, sq, d) contiguous in q's type and
// lse (b, hq, sq) in f32. Query head h reads kv head h / (hq / hkv) (GQA,
// with no repeat). Causal masking keeps col <= row, counted from the top
// left also when sq != sk, as the Pallas kernel does; columns >= sk are
// masked by bounds. A row with no unmasked column gets o = 0 and
// lse = +inf. The plain PyTorch version of the same function is
// attention_with_lse in src/repro_torch/kernels/ref.py.
//
// Bound: at the serving oracle's shape (b 4, hq 32, hkv 8, s 544, d 160,
// causal) the function moves ~56 MB (0.017 ms at 3.35 TB/s) and does
// 4·b·hq·s²·d/2 ≈ 12.1 GFLOP, 0.012 ms at the tensor cores' 989 TFLOP/s
// bf16 but 0.18 ms at the 67 TFLOP/s of f32 outside them. This first
// version computes QKᵀ and PV itself in f32 FMAs on the CUDA cores, for
// both input types, so the f32 rate bounds it; tensor-core tiles (mma /
// wgmma on bf16) are later work.
//
// Design: one block of 128 threads per (batch, query head, 64 query rows).
// The block's Q tile stays in shared memory, converted to f32; K and V tiles
// of 64 rows stream through one shared buffer (K, then V into the same
// space), so the Pallas kernel's sequential kv grid axis becomes a loop in
// the block. Each thread owns 4 query rows: 8 of the tile's 64 columns of S
// and 4·(DP/32) columns of O, with the online-softmax state (running max,
// normaliser, accumulator) in f32 registers as in the Pallas kernel
// (:63-85); row max and row sum reduce across the 8 threads of a row by
// shuffle. P goes through shared memory to the PV product. kv tiles wholly
// above the causal diagonal are skipped. Shared rows are padded by 4 floats
// so the float4 reads of K rows fall in distinct banks. The head dim is
// padded at compile time to DP in {64, 128, 160, 256} (zeros in shared
// memory), so gemma-7b's 256 works; DP 160 needs 99 KB of shared memory and
// DP 256 147 KB, above the default 48 KB, set per launch with
// cudaFuncSetAttribute.
//
// Interface: a plain extern "C" function loaded with ctypes. It launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 128; // 16 row groups of 4 rows x 8 threads per row
constexpr int kLDP = kBK + 4; // row stride of the P tile, floats

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (DP + 4) + kBQ * kLDP);
}

// rows [r0, r0 + nrows) of one head, columns [0, d), into a (kBQ|kBK) x DP
// f32 tile with row stride DP + 4; zeros outside.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int r0, int nrows, int d) {
  for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float val = 0.f;
    if (r0 + r < nrows && c < d) val = to_f32(src[static_cast<long long>(r0 + r) * row_stride + c]);
    dst[r * (DP + 4) + c] = val;
  }
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
  static_assert(kBQ == kBK, "load_tile serves both tiles");
  static_assert(DP % 32 == 0, "O columns are spread as float4 over 8 threads");
  constexpr int LD = DP + 4;
  constexpr int NC = DP / 32;  // float4 groups of O columns per thread
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

  load_tile<T, DP>(Qs, qb, qss, q0, sq, d);

  float acc[4][NC * 4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.f;
  }

  const int kend = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's PV is done with KV and Ps
    load_tile<T, DP>(KV, kb, kss, k0, sk, d);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DP; kk += 4) {
      float4 qa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&KV[(tx + 8 * j) * LD + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kv.x, t);
          t = fmaf(qa[i].y, kv.y, t);
          t = fmaf(qa[i].z, kv.z, t);
          t = fmaf(qa[i].w, kv.w, t);
          s[i][j] = t;
        }
      }
    }

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
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done reading K
    load_tile<T, DP>(KV, vb, vss, k0, sk, d);
    __syncthreads();  // V and P are in place

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * kLDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int nc = 0; nc < NC; ++nc) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&KV[(c + cc) * LD + tx * 4 + 32 * nc]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][nc * 4 + 0] = fmaf(p, vv.x, acc[i][nc * 4 + 0]);
            acc[i][nc * 4 + 1] = fmaf(p, vv.y, acc[i][nc * 4 + 1]);
            acc[i][nc * 4 + 2] = fmaf(p, vv.z, acc[i][nc * 4 + 2]);
            acc[i][nc * 4 + 3] = fmaf(p, vv.w, acc[i][nc * 4 + 3]);
          }
        }
      }
    }
  }

  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + (head_row0 + row) * d;
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = tx * 4 + 32 * nc + e;
        if (col < d) store(&orow[col], acc[i][nc * 4 + e] / safe_l);
      }
    if (tx == 0) lse[head_row0 + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int hq, int hkv, int sq, int sk, int d,
           const long long* qs, const long long* ks, const long long* vs,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hq / hkv, sq, sk, d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse,
              int b, int hq, int hkv, int sq, int sk, int d,
              const long long* qs, const long long* ks, const long long* vs,
              float scale, int causal, cudaStream_t stream) {
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  if (d <= 160) return launch<T, 160>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  if (d <= 256) return launch<T, 256>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides = {q batch, q head, q row,
// k batch, k head, k row, v batch, v head, v row}, in elements.
int sc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                 int b, int hq, int hkv, int sq, int sk, int d,
                 const long long* strides, float scale, int causal, int dtype,
                 cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (d <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* qs = strides;
  const long long* ks = strides + 3;
  const long long* vs = strides + 6;
  if (dtype == 0)
    return launch_dp<float>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  if (dtype == 1)
    return launch_dp<__nv_bfloat16>(q, k, v, o, lse, b, hq, hkv, sq, sk, d, qs, ks, vs, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
