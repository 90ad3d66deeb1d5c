// Hand-written Hopper (sm_90a) RMSNorm for the model stack, with and without
// a residual added first.
//
// Replaces _rmsnorm_kernel and _rmsnorm_res_kernel
// (src/repro/kernels/rmsnorm.py:17 and :25, launched by pallas_call at :56
// and :68): one kernel, whose residual pointer may be null. It computes, in
// f32, y = (x [+ r]) * rsqrt(mean((x [+ r])^2) + eps) * w and rounds y to
// x's type, as src/repro/kernels/ref.py:165 does. Plain PyTorch versions of
// the same function live in src/repro_torch/kernels/ref.py.
//
// Bound: memory. Each element is read once (twice with the residual) and
// written once, against ~4 flops, far below the card's ridge. At the
// serving path's (2048, 5120) bf16 that is 41.9 MB (62.9 MB with the
// residual), 0.0125 ms (0.0188 ms) at 3.35 TB/s.
//
// Design. The vector kernel reads each row from device memory once, in
// 16-byte copies, and writes it once in 16-byte stores. A warp owns a row:
// its lanes copy the row's 16-byte vectors (8 bf16 or 4 f32; of r too) with
// cp.async into the warp's buffer in shared memory, sum their squares, reduce
// by shuffle (no block barrier), and write the scaled row from that buffer,
// w read from a copy staged once a block. The grid is persistent, as many
// blocks as fit on the SMs at once, and each warp walks its rows with two
// buffers: the next row's copies fly while this one is summed and written.
// Holding the row in registers instead (one block a row, 16-byte loads)
// reads it once too, but at 30-58 registers a thread an SM holds only 6-8
// rows, 2048 rows take several waves, and each row's loads wait out its
// reduction: that kernel stayed above F.rms_norm's device time in a
// throwaway comparison on one card (not kept).
// Rows that do not start on 16 bytes, a d that is not a multiple of 8, and
// rows whose two buffers and w do not fit in kMaxSmem take the scalar
// kernel: one block a row, element loads, the row read twice (the second
// time from L1/L2), the sum reduced across the block. The wrapper picks the
// kernel (kernels/rmsnorm.py) and counts the scalar one as a variant.
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py's build log): vector kernel
// 40-54 registers, scalar kernel 19-20, no spills; the vector kernel's
// dynamic shared memory is set per launch (170 KB at d = 5120 bf16: eight
// warps of two 10 KB buffers, and w).
//
// Interface: a plain extern "C" function loaded with ctypes. It launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using sc_mma::cp_async_16;
using sc_mma::cp_async_commit;
using sc_mma::cp_async_wait;

constexpr int kMaxWarps = 8;           // rows in flight (a warp each) in a vector-kernel block
constexpr int kMaxSmem = 200 << 10;    // the vector kernel's shared memory with one warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// N consecutive elements at p (aligned to their size in bytes, 16 at most),
// widened to f32.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
    o[i + 2] = v.z;
    o[i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const bf16* p, float (&o)[N]) {
  static_assert(N == 4 || N % 8 == 0, "whole 8- or 16-byte loads");
  constexpr int kWords = N == 4 ? 2 : 4;  // 32-bit words a load
#pragma unroll
  for (int i = 0; i < N; i += 2 * kWords) {
    uint32_t h[kWords];
    if constexpr (kWords == 2) {  // f32 rows' w in bf16: 8 bytes
      const uint2 u = *reinterpret_cast<const uint2*>(p + i);
      h[0] = u.x, h[1] = u.y;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      h[0] = u.x, h[1] = u.y, h[2] = u.z, h[3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h[k]));
      o[i + 2 * k] = f.x;
      o[i + 2 * k + 1] = f.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[N]) {
  static_assert(N == 8, "one 16-byte store of 8 bf16");
  uint4 u;
  u.x = sc_mma::pack_bf16(v[0], v[1]);
  u.y = sc_mma::pack_bf16(v[2], v[3]);
  u.z = sc_mma::pack_bf16(v[4], v[5]);
  u.w = sc_mma::pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Vector i of a staged row (x's nvec vectors, then r's) in f32, with the
// residual's vector added.
template <typename T, int N>
__device__ __forceinline__ void row_vec(const uint4* row, int nvec, int i, bool residual,
                                        float (&v)[N]) {
  load_vec<N>(reinterpret_cast<const T*>(row + i), v);
  if (residual) {
    float rv[N];
    load_vec<N>(reinterpret_cast<const T*>(row + nvec + i), rv);
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] += rv[e];
  }
}

// Persistent: the warps of the grid take rows warp0, warp0 + step, ...
// (step = the grid's warps), each with two buffers. Shared memory: w (staged
// once a block), then two row buffers a warp. A lane reads back only the
// vectors it copied itself, so only w needs a barrier.
template <typename T, typename W>
__global__ void __launch_bounds__(32 * kMaxWarps)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ r, const W* __restrict__ w,
                   T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);  // elements of a 16-byte vector of x
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int nvec = d / N;
  const int wvec = d * static_cast<int>(sizeof(W)) / 16;
  const int per = nvec * (r == nullptr ? 1 : 2);  // 16-byte vectors of a row buffer
  uint4* bufs = smem + wvec + warp * 2 * per;
  const long long step = static_cast<long long>(gridDim.x) * warps;
  long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  auto fetch = [&](long long at, uint4* buf) {
    for (int i = lane; i < nvec; i += 32) {
      cp_async_16(buf + i, x + at * d + i * N, 16);
      if (r != nullptr) cp_async_16(buf + nvec + i, r + at * d + i * N, 16);
    }
  };
  for (int i = threadIdx.x; i < wvec; i += blockDim.x)
    cp_async_16(smem + i, w + i * (16 / sizeof(W)), 16);
  if (row < rows) fetch(row, bufs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // w, staged by every thread, seen by every warp
  const W* ws = reinterpret_cast<const W*>(smem);
  for (int k = 0; row < rows; row += step, ++k) {
    const uint4* cur = bufs + (k & 1) * per;
    if (row + step < rows) fetch(row + step, bufs + ((k + 1) & 1) * per);
    cp_async_commit();
    cp_async_wait<1>();  // this row's copies (the next row's may still fly)
    float ss = 0.f;
    for (int i = lane; i < nvec; i += 32) {
      float v[N];
      row_vec<T, N>(cur, nvec, i, r != nullptr, v);
#pragma unroll
      for (int e = 0; e < N; ++e) ss = fmaf(v[e], v[e], ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int i = lane; i < nvec; i += 32) {
      float v[N], wv[N];
      row_vec<T, N>(cur, nvec, i, r != nullptr, v);
      load_vec<N>(ws + i * N, wv);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = v[e] * inv * wv[e];
      store_vec<N>(out + row * d + i * N, v);
    }
  }
}

// rsqrt(mean + eps) of the row from each thread's share ss of its sum of
// squares: the warp by shuffle, then the warps through shared memory.
__device__ __forceinline__ float block_inv_rms(float ss, int d, float eps) {
  __shared__ float partial[32];
  __shared__ float inv_rms;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  return inv_rms;
}

template <typename T, typename W>
__global__ void rmsnorm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                      const W* __restrict__ w, T* __restrict__ out,
                                      int d, float eps) {
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* xr = x + base;
  const T* rr = r == nullptr ? nullptr : r + base;
  T* orow = out + base;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float v = to_f32(xr[j]);
    if (rr != nullptr) v += to_f32(rr[j]);
    ss = fmaf(v, v, ss);
  }
  const float inv = block_inv_rms(ss, d, eps);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float v = to_f32(xr[j]);
    if (rr != nullptr) v += to_f32(rr[j]);
    store(&orow[j], v * inv * to_f32(w[j]));
  }
}

// The vector kernel's shared memory: w, then two row buffers for each of
// `warps` warps.
inline int vec_smem(int d, int x_size, int w_size, bool residual, int warps) {
  return d * w_size + warps * 2 * d * x_size * (residual ? 2 : 1);
}

// As many warps a block (up to kMaxWarps) as fit in one SM's shared
// memory, and as many blocks as the SMs hold at once (by shared memory, by
// threads, and by registers at 64 a thread: ptxas gives the kernel 40-54),
// or fewer when the rows run out.
template <typename T, typename W>
int launch_vec(const T* x, const T* r, const W* w, T* out, long long rows, int d, float eps,
               cudaStream_t stream) {
  const auto kernel = rmsnorm_vec_kernel<T, W>;
  const bool res = r != nullptr;
  if (d % 8 != 0 || vec_smem(d, sizeof(T), sizeof(W), res, 1) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, sm_smem = 0;  // the SMs, and a block's opt-in shared memory
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = 1;
  while (warps < kMaxWarps && vec_smem(d, sizeof(T), sizeof(W), res, warps + 1) <= sm_smem)
    ++warps;
  const int smem = vec_smem(d, sizeof(T), sizeof(W), res, warps);
  // above the default limit of dynamic shared memory: raised once a device
  // (for this instantiation) to the most a launch has asked for
  static int allowed[64];
  int& limit = allowed[device & 63];
  if (smem > (48 << 10) && smem > limit) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    limit = smem;
  }
  const int threads = 32 * warps;
  const int per_sm = std::max(1, std::min({(sm_smem + (1 << 10)) / (smem + (1 << 10)),
                                           2048 / threads, 65536 / (64 * threads)}));
  const long long blocks = std::min((rows + warps - 1) / warps,
                                    static_cast<long long>(per_sm) * sms);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(x, r, w, out, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch(const void* xv, const void* rv, const void* wv, void* ov, long long rows, int d,
           float eps, int vec, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* r = static_cast<const T*>(rv);
  const W* w = static_cast<const W*>(wv);
  T* out = static_cast<T*>(ov);
  if (vec) return launch_vec<T, W>(x, r, w, out, rows, d, eps, stream);
  // eight elements a thread, one warp at least, 1024 threads at most
  const int threads = std::min(1024, std::max(32, ((d + 7) / 8 + 31) / 32 * 32));
  rmsnorm_scalar_kernel<T, W><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      x, r, w, out, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. r may be null (no residual).
// vec = 1: the vector kernel, which needs x, r, w and out on 16 bytes, d a
// multiple of 8, and d·sizeof(w) + 2·d·sizeof(x)·(2 with r, else 1) at most
// 200 KB (refused otherwise); vec = 0: the scalar kernel, which takes any
// row.
int sc_rmsnorm(const void* x, const void* r, const void* w, void* out,
               long long rows, int d, int x_dtype, int w_dtype, float eps, int vec,
               cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, r, w, out, rows, d, eps, vec, stream);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, bf16>(x, r, w, out, rows, d, eps, vec, stream);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<bf16, float>(x, r, w, out, rows, d, eps, vec, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16>(x, r, w, out, rows, d, eps, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
