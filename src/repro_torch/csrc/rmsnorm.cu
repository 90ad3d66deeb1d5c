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
// Design: one block per row, its threads striding over the row so every warp
// access is coalesced; no padding copy (the row length is a runtime value).
// The sum of squares reduces in registers, then across the warp by shuffle,
// then across warps through 32 floats of shared memory. The second pass
// reads the row again, which the first pass left in L1/L2 (a 5120-wide bf16
// row is 10 KB). A short row gets one warp.
//
// Interface: a plain extern "C" function loaded with ctypes. It launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, typename W>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
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
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float partial[32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float v = to_f32(xr[j]);
    if (rr != nullptr) v += to_f32(rr[j]);
    store(&orow[j], v * inv * to_f32(w[j]));
  }
}

// Eight elements a thread, one warp at least, 1024 threads at most.
inline unsigned threads_for(int d) {
  int t = ((d + 7) / 8 + 31) / 32 * 32;
  return static_cast<unsigned>(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

template <typename T, typename W>
int launch(const void* x, const void* r, const void* w, void* out,
           long long rows, int d, float eps, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<static_cast<unsigned>(rows), threads_for(d), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), static_cast<const W*>(w),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. r may be null (no residual).
int sc_rmsnorm(const void* x, const void* r, const void* w, void* out,
               long long rows, int d, int x_dtype, int w_dtype, float eps,
               cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0 && w_dtype == 0) return launch<float, float>(x, r, w, out, rows, d, eps, stream);
  if (x_dtype == 0 && w_dtype == 1) return launch<float, __nv_bfloat16>(x, r, w, out, rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 0) return launch<__nv_bfloat16, float>(x, r, w, out, rows, d, eps, stream);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, r, w, out, rows, d, eps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
