// Hand-written Hopper (sm_90a) kernels for the S/C refresh data plane.
//
// Six kernels, each the counterpart of Pallas kernels in the JAX package's
// src/repro/mv/dataplane.py (inside _pk()). Each computes exactly what the
// numpy reference path of that module computes, bit for bit; none is a
// block-by-block copy of the TPU kernel. Plain PyTorch versions of the same
// functions live beside the wrappers in src/repro_torch/mv/dataplane.py.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC, with no --use_fast_math: the bitwise contract needs every rounding
// step spelled out, so floating-point arithmetic goes through the _rn
// intrinsics, which the compiler never contracts into an FMA.
//
// Interface: plain extern "C" functions, one per kernel family, loaded with
// ctypes. Each launches on the caller's stream, never synchronises, and
// returns cudaGetLastError() so a refused launch reaches the caller.
//
// The first four are memory-bound elementwise passes (a handful of
// operations per 5-20 bytes moved, far below the card's ~20 flop/byte f64
// ridge). Their bound on an H100 is the bytes each must move over 3.35 TB/s.
// The design answer is the same for all four: one thread per row in a
// grid-stride loop, neighbouring threads on neighbouring addresses so every
// warp access is a fully coalesced 128-byte line, no shared memory, no
// second pass. The two hash kernels (5, 6) keep that shape and add integer
// work: see their notes for which bound holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Enough resident blocks to fill 132 SMs several times over; the grid-stride
// loop covers any n beyond that.
constexpr long long kMaxBlocks = 132LL * 16;

inline unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

#define GRID_STRIDE_LOOP(i, n)                                           \
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;   \
       i < (n); i += (long long)gridDim.x * blockDim.x)

// Correctly rounded arithmetic in both widths (no contraction, no
// approximate division).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// ---------------------------------------------------------------------------
// 1. filter_gt: FILTER's compare, mask[i] = col[i] > thr.
//    Replaces cmp_kernel_factory.kernel (src/repro/mv/dataplane.py:364-374,
//    launched through _ew_call at :290).
//    Dtype contract (_pin_threshold): an f32 column compares in f32 against
//    the threshold rounded to f32, an f64 column in f64, an int64 column
//    converted to f64 (round to nearest, as numpy converts) against the f64
//    threshold. NaN compares false.
//    Bound: reads the column once, writes one byte per row (5n bytes for
//    f32, 9n for f64/int64).
// ---------------------------------------------------------------------------
template <typename T, typename C>
__global__ void filter_gt_kernel(const T* __restrict__ x, C thr,
                                 uint8_t* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) { out[i] = static_cast<C>(x[i]) > thr; }
}

// ---------------------------------------------------------------------------
// 2. map_derived: MAP's derived column,
//       out = a * 1.0001f + b / (1 + |b|)     (two data columns)
//       out = a / (1 + |a|)                   (one data column)
//    Replaces map_mul_kernel, map_add_softsign_kernel and softsign_kernel
//    (src/repro/mv/dataplane.py:376-385, three _ew_call launches at :290).
//    The reference splits the two-column form into two kernels only because
//    XLA contracts a*c + f(b) into an FMA inside one fusion; here every
//    multiply, add and divide is an explicit _rn intrinsic, so one fused
//    pass is bitwise the unfused numpy expression.
//    Types follow numpy's promotion: a * 1.0001f is taken in a's width (an
//    f64 column multiplies by the f32 constant widened), the softsign in b's
//    width, and the sum in the wider of the two.
//    Bound: reads a (and b), writes out: 12n bytes for two f32 columns,
//    8n for one.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T softsign(T b) {
  return div_rn(b, add_rn(T(1), abs_(b)));
}

template <typename TA, typename TB, typename TO>
__global__ void map_two_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                               TO* __restrict__ out, long long n) {
  const TA c = static_cast<TA>(1.0001f);
  GRID_STRIDE_LOOP(i, n) {
    TA p = mul_rn(a[i], c);
    TB s = softsign(b[i]);
    out[i] = add_rn(static_cast<TO>(p), static_cast<TO>(s));
  }
}

template <typename T>
__global__ void map_one_kernel(const T* __restrict__ a, T* __restrict__ out,
                               long long n) {
  GRID_STRIDE_LOOP(i, n) { out[i] = softsign(a[i]); }
}

// ---------------------------------------------------------------------------
// 3. fixed_point_encode: AGG's per-row int64 contribution,
//       out = int64(rint(f64(v) * 2^16))          (times w[i] when weighted)
//    Replaces encode_kernel and encode_w_kernel
//    (src/repro/mv/dataplane.py:395-401, launched through _ew_call at :290).
//    __double2ll_rn rounds half to even, as np.rint does; the scaling by
//    2^16 is exact. The Z-set weight multiply wraps mod 2^64 like numpy's
//    int64 multiply: it is done in unsigned 64-bit arithmetic (signed
//    overflow is undefined in C++) and reinterpreted.
//    Bound: reads v (and w), writes 8 bytes per row: 12n bytes for f32
//    values, 20n with weights.
// ---------------------------------------------------------------------------
template <typename T, bool kWeighted>
__global__ void encode_kernel(const T* __restrict__ v,
                              const long long* __restrict__ w,
                              long long* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) {
    long long q = __double2ll_rn(__dmul_rn(static_cast<double>(v[i]), 65536.0));
    if (kWeighted) {
      q = static_cast<long long>(static_cast<unsigned long long>(q) *
                                 static_cast<unsigned long long>(w[i]));
    }
    out[i] = q;
  }
}

// ---------------------------------------------------------------------------
// 4. probe_sorted: JOIN's probe of a sorted-unique key index,
//       pos[i] = min(lower_bound(uniq, probe[i]), L - 1)
//       hit[i] = uniq[pos[i]] == probe[i]
//    Replaces probe.kernel (src/repro/mv/dataplane.py:421-433, pallas_call
//    at :436).
//    The Pallas kernel pads the index to a power of two and holds it whole
//    in one VMEM block. An H100 block has at most 227 KB of shared memory,
//    ~28K int64 keys, while the main path's index holds 4.2M keys (33.5 MB).
//    So each thread binary-searches the L real keys directly in global
//    memory through the read-only path, and the 50 MB L2 holds the index:
//    the top levels of every search hit the same few lines. No padding is
//    needed, which also keeps the INT64_MAX-probe case exact: the position
//    is clipped to L - 1 and the hit test compares at the clipped position.
//    Bound: reads each probe once, writes hit and pos, reads the index once
//    (17n + 8L bytes); the log2(L) dependent loads per probe are latency
//    that enough resident warps hide.
// ---------------------------------------------------------------------------
__global__ void probe_kernel(const long long* __restrict__ uniq, long long L,
                             const long long* __restrict__ probe,
                             uint8_t* __restrict__ hit,
                             long long* __restrict__ pos, long long n) {
  GRID_STRIDE_LOOP(i, n) {
    const long long p = probe[i];
    long long lo = 0, hi = L;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (__ldg(uniq + mid) < p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long c = lo < L - 1 ? lo : L - 1;
    pos[i] = c;
    hit[i] = __ldg(uniq + c) == p;
  }
}

// ---------------------------------------------------------------------------
// 5-6. splitmix64 hashing and the fused partition histogram.
//    The splitmix64 finalizer on the int64 key's bit pattern, in unsigned
//    64-bit arithmetic: shifts are logical and multiplies wrap mod 2^64, as
//    numpy's uint64 does, so nothing needs emulating. One device function
//    serves both kernels.
//    Integer operations per row, counted as 32-bit instructions (the units
//    the card's int32 rate counts): three 64-bit shift+xor steps (2 funnel
//    shifts + 2 logic ops each) and two 64-bit multiplies by a constant (3
//    multiply-adds each): 18.
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

// 5. hash64: out[i] = splitmix64(uint64(keys[i])).
//    Replaces hash_kernel (src/repro/mv/dataplane.py:300-306, launched
//    through _ew_call at :290). Bound: reads 8 and writes 8 bytes per row
//    (16n bytes) against 18 integer operations per row; on an H100 the
//    bytes bound is the larger (see PERF.md).
__global__ void hash64_kernel(const long long* __restrict__ keys,
                              unsigned long long* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) {
    out[i] = splitmix64(static_cast<unsigned long long>(keys[i]));
  }
}

// 6. pid_hist: pid[i] = splitmix64(uint64(keys[i])) % P, and hist[p] = the
//    number of rows with pid p, in one pass.
//    Replaces pid_hist.kernel (src/repro/mv/dataplane.py:325-343,
//    pallas_call at :345). The Pallas kernel carries the histogram across
//    its sequential grid in one VMEM block; H100 blocks run in parallel and
//    in no order, so each block counts into its own histogram and adds it
//    into the int64 global one with one atomic per non-empty bucket. Counts
//    are integers, so the order of the atomics cannot change them.
//    * P <= kSharedHistMax: the block histogram is 32-bit counters in
//      shared memory (32 KB at the limit). A block counts at most
//      n / gridDim rows, far below 2^32 for any n this card can hold.
//    * larger P: each row's count goes straight to the global histogram
//      with a 64-bit atomic, inside the same kernel.
//    Skew: with Zipf-distributed keys most rows of a warp hit one bucket,
//    and their atomics on it would serialise. Lanes are grouped by bucket
//    with __match_any_sync first, and one lane per group adds the group's
//    size, so a warp issues at most one atomic per distinct bucket.
//    The loop steps whole blocks at a time (its bound is block-uniform), so
//    every warp reaches the full-mask match together; lanes past n take a
//    key no bucket can have.
//    Bound: reads 8 and writes 8 bytes per row plus 8P for the histogram,
//    against 18 hash operations, the 64-bit remainder (no divide
//    instruction: a software routine) and the match per row; PERF.md says
//    which bound holds.
constexpr unsigned long long kSharedHistMax = 8192;
// Blocks per SM for pid_hist: enough rows per block that the flush of a
// block histogram (up to P atomics) stays small next to its rows.
constexpr long long kHistMaxBlocks = 132LL * 8;

template <bool kShared>
__global__ void pid_hist_kernel(const long long* __restrict__ keys,
                                unsigned long long P,
                                long long* __restrict__ pid,
                                unsigned long long* __restrict__ hist,
                                long long n) {
  extern __shared__ unsigned int local[];
  if (kShared) {
    for (unsigned b = threadIdx.x; b < P; b += blockDim.x) local[b] = 0u;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = blockIdx.x * (long long)blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool valid = i < n;
    unsigned long long p = 0;
    if (valid) {
      p = splitmix64(static_cast<unsigned long long>(keys[i])) % P;
      pid[i] = static_cast<long long>(p);
    }
    // P < 2^31, so 0xFFFFFFFF is no bucket: idle lanes group apart.
    const unsigned tag = valid ? static_cast<unsigned>(p) : 0xFFFFFFFFu;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, tag);
    if (valid && (threadIdx.x & 31u) == static_cast<unsigned>(__ffs(peers) - 1)) {
      const unsigned c = static_cast<unsigned>(__popc(peers));
      if (kShared) {
        atomicAdd(local + p, c);
      } else {
        atomicAdd(hist + p, static_cast<unsigned long long>(c));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (unsigned b = threadIdx.x; b < P; b += blockDim.x) {
      const unsigned c = local[b];
      if (c) atomicAdd(hist + b, static_cast<unsigned long long>(c));
    }
  }
}

}  // namespace

extern "C" {

int sc_filter_gt_f32(const float* x, float thr, uint8_t* out, long long n,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  filter_gt_kernel<float, float><<<blocks_for(n), kThreads, 0, stream>>>(x, thr, out, n);
  return static_cast<int>(cudaGetLastError());
}

int sc_filter_gt_f64(const double* x, double thr, uint8_t* out, long long n,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  filter_gt_kernel<double, double><<<blocks_for(n), kThreads, 0, stream>>>(x, thr, out, n);
  return static_cast<int>(cudaGetLastError());
}

int sc_filter_gt_i64(const long long* x, double thr, uint8_t* out, long long n,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  filter_gt_kernel<long long, double><<<blocks_for(n), kThreads, 0, stream>>>(x, thr, out, n);
  return static_cast<int>(cudaGetLastError());
}

// a_f64 / b_f64 select each input's width (0 = f32, 1 = f64); b may be null
// (one-column form, out has a's width). out has the wider width otherwise.
int sc_map_derived(const void* a, int a_f64, const void* b, int b_f64,
                   void* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned g = blocks_for(n);
  if (b == nullptr) {
    if (a_f64) {
      map_one_kernel<double><<<g, kThreads, 0, stream>>>(
          static_cast<const double*>(a), static_cast<double*>(out), n);
    } else {
      map_one_kernel<float><<<g, kThreads, 0, stream>>>(
          static_cast<const float*>(a), static_cast<float*>(out), n);
    }
  } else if (!a_f64 && !b_f64) {
    map_two_kernel<float, float, float><<<g, kThreads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), n);
  } else if (!a_f64 && b_f64) {
    map_two_kernel<float, double, double><<<g, kThreads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const double*>(b),
        static_cast<double*>(out), n);
  } else if (a_f64 && !b_f64) {
    map_two_kernel<double, float, double><<<g, kThreads, 0, stream>>>(
        static_cast<const double*>(a), static_cast<const float*>(b),
        static_cast<double*>(out), n);
  } else {
    map_two_kernel<double, double, double><<<g, kThreads, 0, stream>>>(
        static_cast<const double*>(a), static_cast<const double*>(b),
        static_cast<double*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// v_f64 selects the value width (0 = f32, 1 = f64); w may be null.
int sc_fixed_point_encode(const void* v, int v_f64, const long long* w,
                          long long* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const unsigned g = blocks_for(n);
  if (v_f64) {
    if (w) {
      encode_kernel<double, true><<<g, kThreads, 0, stream>>>(
          static_cast<const double*>(v), w, out, n);
    } else {
      encode_kernel<double, false><<<g, kThreads, 0, stream>>>(
          static_cast<const double*>(v), w, out, n);
    }
  } else {
    if (w) {
      encode_kernel<float, true><<<g, kThreads, 0, stream>>>(
          static_cast<const float*>(v), w, out, n);
    } else {
      encode_kernel<float, false><<<g, kThreads, 0, stream>>>(
          static_cast<const float*>(v), w, out, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int sc_probe_sorted(const long long* uniq, long long n_uniq,
                    const long long* probe, uint8_t* hit, long long* pos,
                    long long n, cudaStream_t stream) {
  if (n <= 0 || n_uniq <= 0) return 0;
  probe_kernel<<<blocks_for(n), kThreads, 0, stream>>>(uniq, n_uniq, probe, hit,
                                                        pos, n);
  return static_cast<int>(cudaGetLastError());
}

int sc_hash64(const long long* keys, unsigned long long* out, long long n,
              cudaStream_t stream) {
  if (n <= 0) return 0;
  hash64_kernel<<<blocks_for(n), kThreads, 0, stream>>>(keys, out, n);
  return static_cast<int>(cudaGetLastError());
}

// hist holds P int64 counters; it is zeroed on the stream before the launch.
// 1 < P < 2^31 (the wrapper checks).
int sc_pid_hist(const long long* keys, long long P, long long* pid,
                long long* hist, long long n, cudaStream_t stream) {
  if (n <= 0 || P <= 1) return 0;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(long long) * P, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long p = static_cast<unsigned long long>(P);
  long long b = (n + kThreads - 1) / kThreads;
  const unsigned g = static_cast<unsigned>(b < kHistMaxBlocks ? b : kHistMaxBlocks);
  auto* h = reinterpret_cast<unsigned long long*>(hist);
  if (p <= kSharedHistMax) {
    pid_hist_kernel<true><<<g, kThreads, sizeof(unsigned int) * p, stream>>>(
        keys, p, pid, h, n);
  } else {
    pid_hist_kernel<false><<<g, kThreads, 0, stream>>>(keys, p, pid, h, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
