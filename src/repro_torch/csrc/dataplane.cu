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
// The first three are memory-bound elementwise passes (a handful of
// operations per 5-20 bytes moved, far below the card's ~20 flop/byte f64
// ridge). Their bound on an H100 is the bytes each must move over 3.35 TB/s.
// The design answer is the same for all three: a grid-stride loop,
// neighbouring threads on neighbouring addresses so every warp access is
// fully coalesced, no shared memory, no second pass; FILTER's compare reads
// 16-byte vectors (its note says why). The two hash kernels (5, 6) keep that
// shape and add integer work: see their notes for which bound holds. The
// join probe (4) is a search, not a pass: its note gives its layout.

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
//    Design: a column that starts on 16 bytes takes the vector kernel. Each
//    thread reads kFilterUnroll 16-byte vectors (4 f32 or 2 f64/int64 rows
//    each), all loads issued before the first compare, and writes each
//    vector's mask bytes as one 4- or 2-byte word; neighbouring threads take
//    neighbouring vectors, so every warp load is 512 contiguous bytes and
//    every warp store 128 (f32) or 64. Loads and stores are streaming
//    (ld/st.global.cs, evict first): each byte is touched once, and the
//    lines it would displace from L2 are worth more to the next kernel.
//    One block covers kThreads * kFilterUnroll vectors, with no grid-stride
//    loop (no second wave of a capped grid). A column off 16 bytes (a view
//    col[k:], as partition slices are) starts with a head of rows before
//    its first 16-byte boundary (1-3 for f32, 1 for f64 and int64): block
//    0 compares the head and the tail past the last vector one row at a
//    time, and the vectors start at the boundary. Their mask words land on
//    their alignment because the wrapper hands an output view whose offset
//    matches the column's (out + head on the word; faster than byte
//    stores into a fresh allocation). The scalar kernel (one row a
//    thread) takes only a column off its element size or one with fewer
//    rows after the head than a vector holds.
// ---------------------------------------------------------------------------
template <typename T, typename C>
__global__ void filter_gt_kernel(const T* __restrict__ x, C thr,
                                 uint8_t* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) { out[i] = static_cast<C>(x[i]) > thr; }
}

constexpr int kFilterUnroll = 2;

template <int kRows> struct MaskWord;
template <> struct MaskWord<4> { using type = uint32_t; };
template <> struct MaskWord<2> { using type = uint16_t; };

// The mask bytes of one 16-byte vector of rows, row k in byte k.
template <typename T, typename C>
__device__ __forceinline__ typename MaskWord<16 / sizeof(T)>::type gt_word(uint4 v, C thr) {
  constexpr int kRows = 16 / sizeof(T);
  using Word = typename MaskWord<kRows>::type;
  union {
    uint4 u;
    T e[kRows];
  } rows;
  rows.u = v;
  unsigned w = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    w |= static_cast<unsigned>(static_cast<C>(rows.e[k]) > thr) << (8 * k);
  }
  return static_cast<Word>(w);
}

template <typename T, typename C, int U>
__global__ void __launch_bounds__(kThreads)
filter_gt_vec_kernel(const T* __restrict__ x, C thr, uint8_t* __restrict__ out,
                     long long n, int head) {
  constexpr int kRows = 16 / sizeof(T);
  using Word = typename MaskWord<kRows>::type;
  const long long nv = (n - head) / kRows;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x + head);
  uint8_t* __restrict__ ob = out + head;
  const long long v0 = blockIdx.x * (long long)(kThreads * U) + threadIdx.x;
  uint4 v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (v0 + u * kThreads < nv) v[u] = __ldcs(xv + v0 + u * kThreads);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = v0 + u * kThreads;
    if (j >= nv) continue;
    __stcs(reinterpret_cast<Word*>(ob) + j, gt_word<T, C>(v[u], thr));
  }
  if (blockIdx.x == 0) {  // the head and the tail rows
    const long long r = head + nv * kRows + threadIdx.x;
    if (r < n) out[r] = static_cast<C>(x[r]) > thr;
    if (threadIdx.x < head) out[threadIdx.x] = static_cast<C>(x[threadIdx.x]) > thr;
  }
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
//    f64 column multiplies by the f32 constant widened, an int64 column is
//    converted to f64 first), the softsign in b's width, and the sum in the
//    wider of the two. An int64 column's softsign takes |x| in wrapping
//    int64 arithmetic before it converts, as numpy's np.abs does: at
//    INT64_MIN, |x| = INT64_MIN and the softsign is 1.0.
//    Bound: reads a (and b), writes out: 12n bytes for two f32 columns,
//    8n for one.
// ---------------------------------------------------------------------------
// The float type an input column computes in: its own, or f64 for int64.
template <typename T> struct Wide { using type = T; };
template <> struct Wide<long long> { using type = double; };

template <typename T>
__device__ __forceinline__ T widen(T x) { return x; }
__device__ __forceinline__ double widen(long long x) { return __ll2double_rn(x); }

template <typename T>
__device__ __forceinline__ T softsign(T b) {
  return div_rn(b, add_rn(T(1), abs_(b)));
}

__device__ __forceinline__ double softsign(long long b) {
  const unsigned long long u = static_cast<unsigned long long>(b);
  const long long mag = static_cast<long long>(b < 0 ? 0ULL - u : u);
  return __ddiv_rn(__ll2double_rn(b), __dadd_rn(1.0, __ll2double_rn(mag)));
}

// The result type of the two-column form: the wider of the two.
template <typename TA, typename TB>
using MapOut = decltype(typename Wide<TA>::type() + typename Wide<TB>::type());

template <typename TA, typename TB>
__global__ void map_two_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                               MapOut<TA, TB>* __restrict__ out, long long n) {
  using TP = typename Wide<TA>::type;
  using TS = typename Wide<TB>::type;
  using TO = MapOut<TA, TB>;
  const TP c = static_cast<TP>(1.0001f);
  GRID_STRIDE_LOOP(i, n) {
    const TP p = mul_rn(widen(a[i]), c);
    const TS s = softsign(b[i]);
    out[i] = add_rn(static_cast<TO>(p), static_cast<TO>(s));
  }
}

template <typename T>
__global__ void map_one_kernel(const T* __restrict__ a,
                               typename Wide<T>::type* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) { out[i] = softsign(a[i]); }
}

// ---------------------------------------------------------------------------
// 3. fixed_point_encode: AGG's per-row int64 contribution,
//       out = int64(rint(f64(v) * 2^16))          (times w[i] when weighted)
//    Replaces encode_kernel and encode_w_kernel
//    (src/repro/mv/dataplane.py:395-401, launched through _ew_call at :290).
//    rint rounds half to even, as np.rint does; the scaling by 2^16 is
//    exact. Where rint(v * 2^16) is NaN or lies outside [-2^63, 2^63) the
//    result is INT64_MIN, as numpy's int64 conversion gives on x86 (the
//    card's own conversion would saturate instead). The Z-set weight
//    multiply wraps mod 2^64 like numpy's int64 multiply: it is done in
//    unsigned 64-bit arithmetic (signed overflow is undefined in C++) and
//    reinterpreted.
//    Bound: reads v (and w), writes 8 bytes per row: 12n bytes for f32
//    values, 20n with weights.
// ---------------------------------------------------------------------------
constexpr long long kInt64Min = static_cast<long long>(0x8000000000000000ULL);

__device__ __forceinline__ long long fixed_point(double v) {
  const double r = rint(__dmul_rn(v, 65536.0));
  // NaN fails both compares
  return (r >= -9223372036854775808.0 && r < 9223372036854775808.0)
             ? static_cast<long long>(r)
             : kInt64Min;
}

template <typename T, bool kWeighted>
__global__ void encode_kernel(const T* __restrict__ v,
                              const long long* __restrict__ w,
                              long long* __restrict__ out, long long n) {
  GRID_STRIDE_LOOP(i, n) {
    long long q = fixed_point(static_cast<double>(v[i]));
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
//    The Pallas kernel pads the index to a power of two and binary-searches
//    it whole in one VMEM block. An H100 block has at most 227 KB of shared
//    memory, while the main path's index holds 4.2M keys (33.5 MB), and a
//    binary search over it in global memory makes ~23 dependent loads a
//    probe, the bottom ones each a full L2 or HBM round trip: latency, not
//    bandwidth, bounded the PR 11 kernel (5% of its byte bound).
//    Layout: a static B+-tree whose leaves are uniq itself, cut into
//    segments of kTreeKeys = 8 keys (64 bytes, two sectors): no copy of the
//    keys is made. Above them sit internal levels of fanout 9, each node one
//    64-byte row of 8 separators: key k of a node is the first key of its
//    child k + 1, or INT64_MAX where that child does not exist. Levels are
//    stored root first, level d holding ceil(leaves / 9^(h-d)) nodes; a
//    build kernel writes them from uniq on the device for every call (each
//    JOIN builds a fresh index, so there is nothing to cache): ~L/64 nodes,
//    ~L bytes (4.2 MB at L = 4.2M), freed with the call.
//    Descent: at a node, the child is the number of its separators that
//    are < p, counted without branches (a pad INT64_MAX is never < p, so
//    pads never move a rank, and a real INT64_MAX key stays exact). Every
//    key left of the chosen child is < p and every key right of it >= p, so
//    at the leaf lower_bound = 8 j + (keys of leaf j that are < p). The hit
//    test compares p with the leaf's keys; when all 8 are < p the lower
//    bound is the next leaf's first key, read with one more load.
//    Loads: a binary search's loads are 8 bytes each, one per lane, every
//    lane on its own line: the L1/shared data path (a line a cycle) is
//    what such a kernel waits on. Here a quad (4 neighbouring lanes) reads
//    a node together, lane r its keys 2r and 2r + 1 as one 16-byte load, so
//    a warp instruction reads 8 whole nodes, and the quad sums its counts
//    by shuffles. Each quad carries kProbeGroup probes level by level
//    together, so their loads are in flight at once.
//    Memory: each block of a persistent grid stages the top levels that fit
//    in kTreeSmemMax once (at L = 4.2M: 1 + 9 + 80 nodes, 5.8 KB). The
//    next ones go through L1, which a larger stage would take from them
//    (staging 51.8 KB, 4 levels, was slower on an H100): the 720-node level
//    (46 KB) stays there, the 6,473-node one (414 KB) in part. A probe then
//    makes 4 dependent global loads instead of ~23: three internal nodes
//    and one leaf of uniq, the bottom node (of 58,255) and the leaf from L2
//    or HBM.
//    Bound: reads each probe once, writes hit and pos, reads the index once
//    (17n + 8L bytes); the descent moves 128-192 bytes a probe through L2.
// ---------------------------------------------------------------------------
constexpr int kTreeKeys = 8;                  // keys of a node and of a leaf
constexpr int kTreeFan = kTreeKeys + 1;       // children of an internal node
constexpr int kTreeMaxLevels = 20;            // 9^19 leaves hold more than 2^63 keys
constexpr int kTreeSmemMax = 8 * 1024;        // shared memory a block gives the top levels
constexpr int kProbeThreads = 256;
constexpr int kProbeGroup = 4;                // probes a quad carries
constexpr long long kKeyMax = 0x7FFFFFFFFFFFFFFFLL;

struct ProbeTree {
  long long L;                          // keys of uniq
  int levels;                           // internal levels, root first
  int smem_levels;                      // the top ones, staged in shared memory
  int leaf_vec;                         // uniq starts on 16 bytes
  long long smem_nodes;                 // nodes of the staged levels
  long long node0[kTreeMaxLevels + 1];  // first node of each level; [levels] = all
  long long span[kTreeMaxLevels];       // keys of uniq under one child of a level's node
};

// Fills ``t`` for an index of L keys and returns its number of nodes.
long long probe_tree_geometry(long long L, ProbeTree* t) {
  long long count[kTreeMaxLevels];
  int h = 0;
  for (long long m = (L + kTreeKeys - 1) / kTreeKeys; m > 1;) {
    m = (m + kTreeFan - 1) / kTreeFan;
    count[h++] = m;  // bottom up
  }
  t->L = L;
  t->levels = h;
  long long span = kTreeKeys;
  for (int d = h - 1; d >= 0; --d) {
    t->span[d] = span;
    if (d) span *= kTreeFan;
  }
  long long nodes = 0;
  for (int d = 0; d < h; ++d) {
    t->node0[d] = nodes;
    nodes += count[h - 1 - d];
  }
  t->node0[h] = nodes;
  int s = 0;
  while (s < h && t->node0[s + 1] * kTreeKeys * (long long)sizeof(long long) <= kTreeSmemMax) ++s;
  t->smem_levels = s;
  t->smem_nodes = t->node0[s];
  return nodes;
}

// The level tables in shared memory, where a level's index is a register
// (kernel parameters take constant indices only).
__device__ __forceinline__ void load_levels(const ProbeTree& t, long long* level0,
                                            long long* span) {
#pragma unroll
  for (int d = 0; d <= kTreeMaxLevels; ++d) {
    if (threadIdx.x == d) level0[d] = t.node0[d];
    if (span != nullptr && d < kTreeMaxLevels && threadIdx.x == d) span[d] = t.span[d];
  }
}

__global__ void probe_tree_build_kernel(const long long* __restrict__ uniq,
                                        const ProbeTree t,
                                        long long* __restrict__ tree) {
  __shared__ long long level0[kTreeMaxLevels + 1], span[kTreeMaxLevels];
  load_levels(t, level0, span);
  __syncthreads();
  const long long total = t.node0[t.levels] * kTreeKeys;
  GRID_STRIDE_LOOP(i, total) {
    const long long node = i / kTreeKeys;
    int d = 0;
    while (node >= level0[d + 1]) ++d;
    const long long child = (node - level0[d]) * kTreeFan + i % kTreeKeys + 1;
    const long long first = child * span[d];
    tree[i] = first < t.L ? __ldg(uniq + first) : kKeyMax;
  }
}

// A quad (4 neighbouring lanes) reads one node together, lane r its keys 2r
// and 2r + 1 (16 bytes), and sums over the quad: how many of the node's
// keys are < p, and whether one equals p. Every lane of the warp takes part.
__device__ __forceinline__ int quad_count_below(longlong2 k, long long p) {
  int c = (k.x < p) + (k.y < p);
  c += __shfl_xor_sync(0xFFFFFFFFu, c, 1);
  return c + __shfl_xor_sync(0xFFFFFFFFu, c, 2);
}

__device__ __forceinline__ bool quad_any_equal(longlong2 k, long long p) {
  int e = (k.x == p) | (k.y == p);
  e |= __shfl_xor_sync(0xFFFFFFFFu, e, 1);
  return (e | __shfl_xor_sync(0xFFFFFFFFu, e, 2)) != 0;
}

__global__ void __launch_bounds__(kProbeThreads)
probe_tree_kernel(const long long* __restrict__ uniq,
                  const longlong2* __restrict__ tree, const ProbeTree t,
                  const long long* __restrict__ probe, uint8_t* __restrict__ hit,
                  long long* __restrict__ pos, long long n) {
  constexpr int G = kProbeGroup;
  extern __shared__ longlong2 top[];  // the staged levels, 4 vectors a node
  __shared__ long long level0[kTreeMaxLevels + 1];
  load_levels(t, level0, nullptr);
  for (long long v = threadIdx.x; v < t.smem_nodes * 4; v += blockDim.x) top[v] = tree[v];
  __syncthreads();

  const long long L = t.L;
  const int r = threadIdx.x & 3;  // this lane's 16 bytes of a node
  // neighbouring quads take neighbouring probes: loads and stores coalesce
  const long long quad = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 2;
  const long long quads = ((long long)gridDim.x * blockDim.x) >> 2;
  for (long long base = 0; base < n; base += G * quads) {
    long long p[G], q[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long i = base + g * quads + quad;
      p[g] = i < n ? probe[i] : 0;
      q[g] = 0;
    }
    // q: the node's index within its level, then the leaf's
    for (int d = 0; d < t.smem_levels; ++d) {
      const longlong2* lv = top + level0[d] * 4 + r;
      longlong2 k[G];
#pragma unroll
      for (int g = 0; g < G; ++g) k[g] = lv[q[g] * 4];
#pragma unroll
      for (int g = 0; g < G; ++g) q[g] = q[g] * kTreeFan + quad_count_below(k[g], p[g]);
    }
    for (int d = t.smem_levels; d < t.levels; ++d) {
      const longlong2* lv = tree + level0[d] * 4 + r;
      longlong2 k[G];
#pragma unroll
      for (int g = 0; g < G; ++g) k[g] = __ldg(lv + q[g] * 4);
#pragma unroll
      for (int g = 0; g < G; ++g) q[g] = q[g] * kTreeFan + quad_count_below(k[g], p[g]);
    }
    // leaves: 8 keys of uniq, INT64_MAX past its end
    longlong2 k[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long a = q[g] * kTreeKeys + 2 * r;
      if (t.leaf_vec && a + 2 <= L) {
        k[g] = __ldg(reinterpret_cast<const longlong2*>(uniq + a));
      } else {
        k[g].x = a < L ? __ldg(uniq + a) : kKeyMax;
        k[g].y = a + 1 < L ? __ldg(uniq + a + 1) : kKeyMax;
      }
    }
    long long lb[G];
    bool h[G], next[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int c = quad_count_below(k[g], p[g]);
      lb[g] = q[g] * kTreeKeys + c;
      h[g] = quad_any_equal(k[g], p[g]) && lb[g] < L;
      next[g] = c == kTreeKeys && lb[g] < L;  // the bound is the next leaf's first key
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (next[g]) h[g] = __ldg(uniq + lb[g]) == p[g];
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long i = base + g * quads + quad;
      if (r == 0 && i < n) {
        pos[i] = lb[g] < L ? lb[g] : L - 1;
        hit[i] = h[g];
      }
    }
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

// head >= 0: the vector kernel, with x + head on 16 bytes, out + head on
// the mask word and at least one vector's rows after the head (else
// refused); head < 0: the scalar kernel. The wrapper decides and counts
// which.
template <typename T, typename C>
int filter_gt(const T* x, C thr, uint8_t* out, long long n, int head,
              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (head >= 0) {
    constexpr int kRows = 16 / sizeof(T);
    if ((reinterpret_cast<uintptr_t>(x + head) & 15) ||
        (reinterpret_cast<uintptr_t>(out + head) % kRows) || head >= kRows || n - head < kRows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long per_block = static_cast<long long>(kThreads) * kFilterUnroll;
    const long long blocks = ((n - head) / kRows + per_block - 1) / per_block;
    filter_gt_vec_kernel<T, C, kFilterUnroll><<<static_cast<unsigned>(blocks), kThreads, 0,
                                                stream>>>(x, thr, out, n, head);
  } else {
    filter_gt_kernel<T, C><<<blocks_for(n), kThreads, 0, stream>>>(x, thr, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// a_type selects the input's type for a MAP column: 0 = f32, 1 = f64,
// 2 = int64.
template <typename TA>
int map_derived(const void* a, const void* b, int b_type, void* out, long long n,
                cudaStream_t stream) {
  const unsigned g = blocks_for(n);
  const TA* pa = static_cast<const TA*>(a);
  if (b == nullptr) {
    map_one_kernel<TA><<<g, kThreads, 0, stream>>>(
        pa, static_cast<typename Wide<TA>::type*>(out), n);
  } else if (b_type == 0) {
    map_two_kernel<TA, float><<<g, kThreads, 0, stream>>>(
        pa, static_cast<const float*>(b), static_cast<MapOut<TA, float>*>(out), n);
  } else if (b_type == 1) {
    map_two_kernel<TA, double><<<g, kThreads, 0, stream>>>(
        pa, static_cast<const double*>(b), static_cast<MapOut<TA, double>*>(out), n);
  } else if (b_type == 2) {
    map_two_kernel<TA, long long><<<g, kThreads, 0, stream>>>(
        pa, static_cast<const long long*>(b), static_cast<MapOut<TA, long long>*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sc_filter_gt_f32(const float* x, float thr, uint8_t* out, long long n, int head,
                     cudaStream_t stream) {
  return filter_gt<float, float>(x, thr, out, n, head, stream);
}

int sc_filter_gt_f64(const double* x, double thr, uint8_t* out, long long n, int head,
                     cudaStream_t stream) {
  return filter_gt<double, double>(x, thr, out, n, head, stream);
}

int sc_filter_gt_i64(const long long* x, double thr, uint8_t* out, long long n, int head,
                     cudaStream_t stream) {
  return filter_gt<long long, double>(x, thr, out, n, head, stream);
}

// a_type / b_type select each input's type (0 = f32, 1 = f64, 2 = int64);
// b may be null (one-column form: out has the width a computes in, f64 for
// int64). out has the wider of the two widths otherwise.
int sc_map_derived(const void* a, int a_type, const void* b, int b_type,
                   void* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (a_type) {
    case 0: return map_derived<float>(a, b, b_type, out, n, stream);
    case 1: return map_derived<double>(a, b, b_type, out, n, stream);
    case 2: return map_derived<long long>(a, b, b_type, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// tree: room for the index's internal levels, tree_nodes nodes of 8 int64
// keys (probe_tree_geometry's count, which the wrapper computes alike and
// this function checks); null when the index has none (L <= 8). The build
// kernel, when there is a tree, and the probe kernel run on the stream in
// that order.
int sc_probe_sorted(const long long* uniq, long long n_uniq,
                    const long long* probe, uint8_t* hit, long long* pos,
                    long long n, long long* tree, long long tree_nodes,
                    cudaStream_t stream) {
  if (n <= 0 || n_uniq <= 0) return 0;
  ProbeTree t;
  const long long nodes = probe_tree_geometry(n_uniq, &t);
  if (nodes != tree_nodes || (nodes > 0 && tree == nullptr) ||
      (reinterpret_cast<uintptr_t>(tree) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  t.leaf_vec = (reinterpret_cast<uintptr_t>(uniq) & 15) == 0;
  cudaError_t err;
  if (nodes > 0) {
    probe_tree_build_kernel<<<blocks_for(nodes * kTreeKeys), kThreads, 0, stream>>>(
        uniq, t, tree);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = static_cast<int>(t.smem_nodes * kTreeKeys * sizeof(long long));
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, probe_tree_kernel, kProbeThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // a persistent grid: each block stages the top levels once
  const long long per_block = static_cast<long long>(kProbeGroup) * (kProbeThreads / 4);
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  probe_tree_kernel<<<static_cast<unsigned>(blocks), kProbeThreads, smem, stream>>>(
      uniq, reinterpret_cast<const longlong2*>(tree), t, probe, hit, pos, n);
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
