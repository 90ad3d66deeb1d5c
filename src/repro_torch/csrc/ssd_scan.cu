// Hand-written Hopper (sm_90a) Mamba-2 SSD (state-space duality) chunked
// scan for the model stack.
//
// Replaces _ssd_kernel (src/repro/kernels/ssd_scan.py:28, launched by
// pallas_call at :93). Inputs x (b, s, h, p), dt (b, s, h), B and C
// (b, s, n) in f32 or bf16, each with its own strides (the last dimension
// contiguous: the model hands B and C as the two halves of one (b, s, 2n)
// tensor), and a (h,) in f32; y (b, s, h, p) is written contiguous in x's
// type. Per (batch, head) and per chunk of L positions, in f32:
//   cum = cumsum(dt·a), total = cum[L-1]
//   y   = (C·Bᵀ ⊙ exp(cum_i - cum_j)[i >= j])·(x·dt) + exp(cum) ⊙ (C·Hᵀ)
//   H   = exp(total)·H + ((x·dt) ⊙ exp(total - cum))ᵀ·B
// with the state H (p x n) carried from chunk to chunk and zero before the
// first. Masked exponents (i < j) are never taken, as the reference clamps
// them before its exp (src/repro/kernels/ref.py:132-134). The plain PyTorch
// version of the same function is ssd_scan_chunked in
// src/repro_torch/kernels/ref.py.
//
// Bound: operations. The causal mask leaves L(L+1)/2 (i, j) pairs of a
// chunk, so a chunk does L(L+1)n (C·Bᵀ) + L(L+1)p (the masked product with
// x·dt) + 2Lnp (C·Hᵀ) + 2Lnp (the state update) operations: 2,895,872 at
// L 64, p 64, n 128, of which C·Bᵀ is 532,480. Every product but C·Bᵀ takes
// an f32 operand (x·dt, the decays, H) and counts at the 67 TFLOP/s of f32
// outside the tensor cores; C·Bᵀ multiplies the inputs themselves, so for
// bf16 inputs it counts at the tensor cores' 989 TFLOP/s (exact with f32
// accumulation). At the serving prefill (4, 512, 80, 64, 128) that is
// 7.41 GFLOP: 0.1106 ms in f32 and 0.0917 ms in bf16, against 43 MB of
// bytes (0.013 ms at 3.35 TB/s); at the long prefill (1, 32768, 80, 64,
// 128) 118.6 GFLOP, 1.4669 ms in bf16, against 0.21 ms of bytes. This is
// chip_smoke.py's ssd_ops.
//
// Design. The Pallas grid's chunk axis is sequential on the TPU, with H in
// VMEM scratch; H100 blocks run in no order, so one block of 256 threads
// owns one (batch, head) and loops over its chunks in order, H resident in
// shared memory the whole time: no second pass over the chunks. Per chunk
// the block loads dt, B, C and x·dt into shared memory (bf16 converted to
// f32 on load; rows past L and columns past p and n zero), scans dt·a with
// one warp (shuffles), then runs the four products as f32 FMAs on the CUDA
// cores, each thread owning a 4 x 4 tile (M = masked C·Bᵀ, then y) or a
// 4 x 8 tile (H) on a 16 x 16 thread grid with strided rows and columns.
// Rows of B, C and H are padded to 132 floats so the float4 walks along n
// fall in distinct banks; the L x L matrix to 65. Shared memory is 135,440
// bytes whatever the shape (one block per SM), set per launch with
// cudaFuncSetAttribute. Limits: L <= 64, p <= 64, n <= 128 (mamba2-2.7b's
// 64 x 64 x 128, jamba's n 16, the reduced configs).
//
// At (1, 32768, 80, 64, 128) the grid is 80 blocks on 132 SMs. A
// chunk-parallel design, and one C·Bᵀ shared by the heads (B and C have no
// head axis), are later work.
//
// Interface: a plain extern "C" function loaded with ctypes. It launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kMaxL = 64;       // chunk length
constexpr int kMaxP = 64;       // head dim
constexpr int kMaxN = 128;      // state dim
constexpr int kLdN = kMaxN + 4; // row stride of B, C and H, floats
constexpr int kLdL = kMaxL + 1; // row stride of the L x L matrix
constexpr size_t kSmemFloats =
    (kMaxP + 2 * kMaxL) * kLdN   // H, B, C
    + kMaxL * kMaxP              // x·dt
    + kMaxL * kLdL               // masked C·Bᵀ
    + 4 * kMaxL + 4;             // dt, cum, exp(cum), exp(total - cum), exp(total)
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

struct Strides {
  long long v[10];  // x {batch, seq, head}, dt {batch, seq, head}, B {batch, seq}, C {batch, seq}
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                int s, int h, int p, int n, int L, Strides st) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // [kMaxP][kLdN] the carried state
  float* Bs = Hs + kMaxP * kLdN;                // [kMaxL][kLdN]
  float* Cs = Bs + kMaxL * kLdN;                // [kMaxL][kLdN]
  float* Xs = Cs + kMaxL * kLdN;                // [kMaxL][kMaxP] x·dt
  float* Ms = Xs + kMaxL * kMaxP;               // [kMaxL][kLdL] masked C·Bᵀ
  float* dts = Ms + kMaxL * kLdL;               // [kMaxL]
  float* cum = dts + kMaxL;                     // [kMaxL]
  float* ecum = cum + kMaxL;                    // [kMaxL] exp(cum)
  float* wv = ecum + kMaxL;                     // [kMaxL] exp(total - cum)
  float* etot = wv + kMaxL;                     // [1] exp(total)

  const int hh = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float av = a[hh];
  const T* xb = x + bb * st.v[0] + hh * st.v[2];
  const T* db = dt + bb * st.v[3] + hh * st.v[5];
  const T* Bb = bm + bb * st.v[6];
  const T* Cb = cm + bb * st.v[8];
  T* yb = y + (static_cast<long long>(bb) * s * h + hh) * p;
  const long long y_row = static_cast<long long>(h) * p;

  for (int i = tid; i < kMaxP * kLdN; i += kThreads) Hs[i] = 0.f;

  for (int c0 = 0; c0 < s; c0 += L) {
    __syncthreads();  // the previous chunk is done with shared memory
    if (tid < kMaxL) dts[tid] = tid < L ? to_f32(db[(c0 + tid) * st.v[4]]) : 0.f;
    for (int i = tid; i < kMaxL * kMaxN; i += kThreads) {
      const int r = i >> 7, k = i & (kMaxN - 1);
      float bv = 0.f, cv = 0.f;
      if (r < L && k < n) {
        const long long t = c0 + r;
        bv = to_f32(Bb[t * st.v[7] + k]);
        cv = to_f32(Cb[t * st.v[9] + k]);
      }
      Bs[r * kLdN + k] = bv;
      Cs[r * kLdN + k] = cv;
    }
    __syncthreads();  // dt is in place
    for (int i = tid; i < kMaxL * kMaxP; i += kThreads) {
      const int r = i >> 6, q = i & (kMaxP - 1);
      Xs[i] = (r < L && q < p) ? to_f32(xb[(c0 + r) * st.v[1] + q]) * dts[r] : 0.f;
    }
    if (tid < 32) {  // inclusive scan of dt·a over the chunk, lanes j and j + 32
      float v0 = dts[tid] * av, v1 = dts[tid + 32] * av;  // 0 past L
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (tid >= off) { v0 += u0; v1 += u1; }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      cum[tid] = v0;
      cum[tid + 32] = v1;
      __syncwarp();
      const float total = cum[L - 1];
      ecum[tid] = expf(v0);
      ecum[tid + 32] = expf(v1);
      wv[tid] = tid < L ? expf(total - v0) : 0.f;
      wv[tid + 32] = tid + 32 < L ? expf(total - v1) : 0.f;
      if (tid == 0) etot[0] = expf(total);
    }
    __syncthreads();  // x·dt, cum and the weights are in place

    // M[i][j] = (C_i · B_j)·exp(cum_i - cum_j) for j <= i < L, else 0
    {
      float acc[4][4] = {};
      const float4* C4 = reinterpret_cast<const float4*>(Cs);
      const float4* B4 = reinterpret_cast<const float4*>(Bs);
      for (int k4 = 0; k4 < (n + 3) / 4; ++k4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = C4[(ty + 16 * r) * (kLdN / 4) + k4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = B4[(tx + 16 * c) * (kLdN / 4) + k4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(cv[r].x, bv[c].x, acc[r][c]);
            acc[r][c] = fmaf(cv[r].y, bv[c].y, acc[r][c]);
            acc[r][c] = fmaf(cv[r].z, bv[c].z, acc[r][c]);
            acc[r][c] = fmaf(cv[r].w, bv[c].w, acc[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          Ms[i * kLdL + j] = (j <= i && i < L) ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();  // M is in place

    // y[i][q] = Σ_j M[i][j]·(x·dt)[j][q] + exp(cum_i)·Σ_k C[i][k]·H[q][k]
    {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < L; ++j) {
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
      for (int k4 = 0; k4 < (n + 3) / 4; ++k4) {
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
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= L) continue;
        T* yrow = yb + (c0 + i) * y_row;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = tx + 16 * c;
          if (q < p) store(&yrow[q], intra[r][c] + ecum[i] * inter[r][c]);
        }
      }
    }
    __syncthreads();  // every read of H for this chunk is done

    // H[q][k] = exp(total)·H[q][k] + Σ_j (x·dt)[j][q]·exp(total - cum_j)·B[j][k]
    {
      float acc[4][8] = {};
      for (int j = 0; j < L; ++j) {
        const float w = wv[j];
        float xw[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xw[r] = Xs[j * kMaxP + ty + 16 * r] * w;
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bs[j * kLdN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xw[r], bv[c], acc[r][c]);
      }
      const float decay = etot[0];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float* hp = &Hs[(ty + 16 * r) * kLdN + tx + 16 * c];
          *hp = fmaf(decay, *hp, acc[r][c]);
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* a, const void* bm, const void* cm,
           void* y, int b, int s, int h, int p, int n, int L, const Strides& st,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T><<<dim3(h, b), kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), s, h, p, n, L, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y; a is float32).
// strides = {x batch, x seq, x head, dt batch, dt seq, dt head, B batch,
// B seq, C batch, C seq}, in elements; x, B and C rows contiguous.
int sc_ssd_scan(const void* x, const void* dt, const float* a, const void* bmat,
                const void* cmat, void* y, int b, int s, int h, int p, int n, int chunk,
                const long long* strides, int dtype, cudaStream_t stream) {
  if (b <= 0 || s <= 0 || h <= 0) return 0;
  if (chunk < 1 || chunk > kMaxL || s % chunk != 0 || p < 1 || p > kMaxP || n < 1 ||
      n > kMaxN || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{};
  for (int i = 0; i < 10; ++i) st.v[i] = strides[i];
  if (dtype == 0) return launch<float>(x, dt, a, bmat, cmat, y, b, s, h, p, n, chunk, st, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, bmat, cmat, y, b, s, h, p, n, chunk, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
