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
// - The backward kernels share a thread layout: 16 threads (tx) a row group
//   of 8 rows, each thread an 8 x 4 tile of a 64-column score tile (columns
//   tx + 16·j) from float4 reads along the depth (score_tile), and an 8 x
//   DP/16 accumulator (columns tx + 16·c; acc_tile, 4 + 2.5·DP/16 floats
//   read a 32·DP/16 FMAs). A row group lies in one warp, so a score tile
//   that only its own row group reads back needs __syncwarp, not a block
//   barrier. The head dim is padded as the forward's, the mask computed on
//   diagonal and ragged tiles only, and p = exp2(s·scale·log2 e - lse·log2
//   e). Tiles arrive by 16-byte cp.async (element loads when a row is off 16
//   bytes: ALIGNED = false).
// - dq: one block per (batch, query head, BM query rows), BM = 128 with 256
//   threads up to DP 112 and 64 with 128 threads above (Q and dO resident:
//   2·BM rows), the longest query tiles first (grid.y counts down). V_i and
//   K_i arrive in turn through two 64-row buffers, each copy under the
//   other's product: dP = dO·V_iᵀ in registers while K_i lands, then S =
//   Q·K_iᵀ while V_(i+1) lands, dS = p ⊙ (dP - delta)·scale into the row
//   group's rows of a shared tile, and dq += dS·K_i; two barriers a kv tile.
//   At DP 256 one buffer (217 KB of shared memory), the copies exposed.
// - dkv: one block per (batch, kv head, 64 kv rows; 32 at DP 256), K and V
//   resident, over the group's query heads and each one's 64-row query tiles
//   from the causal start, Q and dO (with lse and delta) double-buffered up
//   to DP 112 and single above. Two accumulators of 8 x DP/16 do not fit a
//   thread beside a score tile, so the block is two halves of the same row
//   groups: the first computes Sᵀ = K·Qᵀ, writes Pᵀ and owns dv += Pᵀ·dO;
//   the second computes dPᵀ = V·dOᵀ, reads its partner's Pᵀ after a named
//   barrier of the two warps (bar.sync 1 + warp, 64), writes dSᵀ and owns dk
//   += dSᵀ·Q. One block barrier a query tile. A kv head owns its block, so
//   the group sum of the Pallas wrapper (:343-356) needs no second pass and
//   no float atomics: the backward is deterministic.
// - delta = rowsum(do ⊙ o) is computed by the caller in PyTorch, as the
//   reference computes it in jnp outside its kernels (:272).
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py's build log), the forward with
// 16-byte copies: DP 16-80 210-254 registers and no spills (80: 254); DP 96
// 255 with 64 bytes of spill stores and DP 112 168 with 24 (no config has a
// head dim in 81-112); DP 128 226, 160 254, 256 252, no spills. The
// backward, both alignments, no spills anywhere: dq 130 registers at DP 16,
// 168 at 32-80, 242-244 at 96, 252-254 above; dk/dv 128 at 16, 166-168 at
// 32-96, 254 at 112-160, 243 at 256. Device time on an H100 (700 W) at
// the training shape (2, 32/32, 4096, 80) causal: dq 7.42 ms (52% of its
// 3.85 ms bound), dk/dv 9.97 (51% of 5.13); SDPA's f32 backward 17.8.
//
// Interface: plain extern "C" functions loaded with ctypes. Each launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

#include "mma_sm90.cuh"

// Translation units: the build compiles this source as five units
// (native.PARTS), unit i with -DSC_PART=i, and links them into one library:
// 0 the forward's C entry and its head dims 16-80, 1 dq, 2 dk/dv, 3 the
// forward at 96-128, 4 the forward at 160 and 256 (the forward's
// instantiations compile longest; so split, each unit takes 27-46 s of
// nvcc on an H100's host). A unit compiles only the kernels its code
// instantiates, so the families compile side by side. Without SC_PART the
// whole source is one unit.
#ifdef SC_PART
#define SC_IN_PART(i) (SC_PART == (i))
#else
#define SC_IN_PART(i) 1
#endif

namespace {

using sc_mma::cp_async_16;
using sc_mma::cp_async_commit;
using sc_mma::cp_async_wait;

constexpr int kBQ = 64;       // query rows per dk/dv tile
constexpr int kBK = 64;       // kv rows per tile (forward, dq)
constexpr int kLDP = kBK + 4; // row stride of a 64-column score tile, floats
constexpr int kTM = 8;        // rows per thread (a row group)
constexpr int kTX = 16;       // threads per row group in the backward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long v[12];  // {q, k, v, do} x {batch, head, row}, in elements
};

// rows [r0, r0 + nrows) of one head, columns [0, d), into a ROWS x DP f32
// tile with row stride DP + 4, by the block's NT threads; zeros outside.
template <int ROWS, int DP, int NT>
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

// s[i][j] = A[i] · B[tx + 16·j] over DP columns: A the thread's kTM rows
// (broadcast within its row group), B a 64-row tile; both of row stride
// DP + 4, which puts the 16 rows a warp reads at once in distinct banks.
template <int DP>
__device__ __forceinline__ void score_tile(float (&s)[kTM][kBK / kTX], const float* A,
                                           const float* B, int tx) {
  constexpr int LD = DP + 4;
  constexpr int TN = kBK / kTX;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < DP; kk += 4) {
    float4 bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + kTX * j) * LD + kk);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + i * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = s[i][j];
        x = fmaf(a.x, bv[j].x, x);
        x = fmaf(a.y, bv[j].y, x);
        x = fmaf(a.z, bv[j].z, x);
        x = fmaf(a.w, bv[j].w, x);
        s[i][j] = x;
      }
    }
  }
}

// acc[i][c] += Σ_j P[i][j] · B[j][tx + 16·c] over the 64 columns of the
// thread's kTM rows of a score tile P (row stride kLDP) and the 64 rows of
// B (row stride DP + 4).
template <int DP>
__device__ __forceinline__ void acc_tile(float (&acc)[kTM][DP / kTX], const float* P,
                                         const float* B, int tx) {
  constexpr int LD = DP + 4;
  constexpr int NA = DP / kTX;
#pragma unroll 2
  for (int j0 = 0; j0 < kBK; j0 += 4) {
    float4 p[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) p[i] = *reinterpret_cast<const float4*>(P + i * kLDP + j0);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* brow = B + (j0 + jj) * LD + tx;
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        const float bv = brow[kTX * c];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y : jj == 2 ? p[i].z : p[i].w;
          acc[i][c] = fmaf(pj, bv, acc[i][c]);
        }
      }
    }
  }
}

// The thread's kTM accumulator rows r0 + i (those below nrows), columns
// tx + 16·c below d, into a contiguous (rows, d) output from row row0.
template <int DP>
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[kTM][DP / kTX],
                                           long long row0, int r0, int nrows, int d, int tx) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (r0 + i >= nrows) continue;
    float* orow = out + (row0 + r0 + i) * d;
#pragma unroll
    for (int c = 0; c < DP / kTX; ++c) {
      const int col = tx + kTX * c;
      if (col < d) orow[col] = acc[i][c];
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
// dq's geometry (see the header): BM query rows a block, 16 threads per 8
// of them, two 64-row kv buffers but at DP 256.
template <int DP>
__host__ __device__ constexpr int dq_rows() { return DP <= 112 ? 128 : 64; }
template <int DP>
__host__ __device__ constexpr int dq_threads() { return dq_rows<DP>() / kTM * kTX; }
template <int DP>
__host__ __device__ constexpr int dq_bufs() { return DP <= 160 ? 2 : 1; }
template <int DP>
constexpr size_t dq_smem_bytes() {  // Q, dO, the kv buffers, then dS
  return sizeof(float) * (static_cast<size_t>(2 * dq_rows<DP>() + dq_bufs<DP>() * kBK) * (DP + 4) +
                          static_cast<size_t>(dq_rows<DP>()) * kLDP);
}

// dk/dv's: BKV kv rows a block, two halves of BKV / 8 row groups of 16
// threads; Q and dO in two stages up to DP 112.
template <int DP>
__host__ __device__ constexpr int dkv_rows() { return DP <= 160 ? 64 : 32; }
template <int DP>
__host__ __device__ constexpr int dkv_threads() { return 2 * dkv_rows<DP>() / kTM * kTX; }
template <int DP>
__host__ __device__ constexpr int dkv_stages() { return DP <= 112 ? 2 : 1; }
template <int DP>
constexpr size_t dkv_smem_bytes() {  // K, V, the stages' Q and dO, Pᵀ, dSᵀ, lse, delta
  return sizeof(float) *
         (static_cast<size_t>(2 * dkv_rows<DP>() + 2 * dkv_stages<DP>() * kBQ) * (DP + 4) +
          static_cast<size_t>(2 * dkv_rows<DP>()) * kLDP + 2 * dkv_stages<DP>() * kBQ);
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

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(dq_threads<DP>(), 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int hq, int group, int sq, int sk, int d,
                    Strides st, float scale, int causal) {
  constexpr int NT = dq_threads<DP>();
  constexpr int BM = dq_rows<DP>();
  constexpr int NB = dq_bufs<DP>();
  constexpr int TN = kBK / kTX;  // score columns per thread: tx + 16·j
  constexpr int LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BM * LD;
  float* Vb = dOs + BM * LD;          // V_i (and K_i when NB = 1)
  float* Kb = Vb + (NB - 1) * kBK * LD;
  float* dSs = Vb + NB * kBK * LD;    // BM x kLDP

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows first
  const int hk = h / group;
  const float* kb = k + b * st.v[3] + hk * st.v[4];
  const float* vb = v + b * st.v[6] + hk * st.v[7];
  const long long kss = st.v[5], vss = st.v[8];
  const int kend = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kend + kBK - 1) / kBK;
  const float scale_log2 = scale * kLog2e;
  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;

  copy_tile<ALIGNED, BM, DP, NT>(Qs, q + b * st.v[0] + h * st.v[1], st.v[2], q0, sq, d);
  copy_tile<ALIGNED, BM, DP, NT>(dOs, dout + b * st.v[9] + h * st.v[10], st.v[11], q0, sq, d);
  if (ntiles > 0) copy_tile<ALIGNED, kBK, DP, NT>(Vb, vb, vss, 0, sk, d);
  cp_async_commit();

  const int row0 = q0 + ty * kTM;  // the thread's first query row
  float lse2[kTM], dlt[kTM];       // lse in base 2 (+inf on a padded row: p = 0); delta
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + i;
    lse2[i] = row < sq ? lse[head_row0 + row] * kLog2e : INFINITY;
    dlt[i] = row < sq ? delta[head_row0 + row] : 0.f;
  }
  float acc[kTM][DP / kTX];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < DP / kTX; ++c) acc[i][c] = 0.f;
  const float* Qt = Qs + ty * kTM * LD;
  const float* dOt = dOs + ty * kTM * LD;
  float* dSt = dSs + ty * kTM * kLDP;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBK;
    cp_async_wait<0>();  // V_it (and Q, dO)
    __syncthreads();     // ... seen by every thread, and every thread is done with K_(it-1)
    if constexpr (NB == 2) {  // K_it, under dP's math
      copy_tile<ALIGNED, kBK, DP, NT>(Kb, kb, kss, k0, sk, d);
      cp_async_commit();
    }
    float s[kTM][TN];
    score_tile<DP>(s, dOt, Vb, tx);  // dP = dO·V_itᵀ
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dSt[i * kLDP + tx + kTX * j] = s[i][j];
    if constexpr (NB == 1) {
      __syncthreads();  // every thread is done with V_it
      copy_tile<ALIGNED, kBK, DP, NT>(Kb, kb, kss, k0, sk, d);
      cp_async_commit();
    }
    cp_async_wait<0>();  // K_it
    __syncthreads();     // ... seen by every thread, and every thread is done with V_it
    if constexpr (NB == 2) {
      if (it + 1 < ntiles) {  // V_(it+1), under S's math and dS·K_it
        copy_tile<ALIGNED, kBK, DP, NT>(Vb, vb, vss, k0 + kBK, sk, d);
        cp_async_commit();
      }
    }
    score_tile<DP>(s, Qt, Kb, tx);  // S = Q·K_itᵀ
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0);  // ragged or diagonal
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = k0 + tx + kTX * j;
        const bool keep = !edge || (col < sk && (!causal || col <= row0 + i));
        float* ds = dSt + i * kLDP + tx + kTX * j;
        const float p = exp2f(fmaf(s[i][j], scale_log2, -lse2[i]));
        *ds = keep ? p * (*ds - dlt[i]) * scale : 0.f;
      }
    __syncwarp();  // the row group's dS, written by its own warp
    acc_tile<DP>(acc, dSt, Kb, tx);  // dq += dS·K_it
    if constexpr (NB == 1) {
      if (it + 1 < ntiles) {
        __syncthreads();  // every thread is done with K_it
        copy_tile<ALIGNED, kBK, DP, NT>(Vb, vb, vss, k0 + kBK, sk, d);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (Q, dO when ntiles = 0)
  store_tile<DP>(dq, acc, head_row0, row0, sq, d, tx);
}

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(dkv_threads<DP>(), 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int hq, int group,
                     int sq, int sk, int d, Strides st, float scale, int causal) {
  constexpr int NT = dkv_threads<DP>();
  constexpr int HALF = NT / 2;
  constexpr int BKV = dkv_rows<DP>();
  constexpr int NS = dkv_stages<DP>();
  constexpr int TN = kBQ / kTX;  // query columns per thread: tx + 16·j
  constexpr int LD = DP + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BKV * LD;
  float* Qs = Vs + BKV * LD;              // NS stages of kBQ x LD
  float* dOs = Qs + NS * kBQ * LD;
  float* Ps = dOs + NS * kBQ * LD;        // Pᵀ, BKV x kLDP
  float* dSs = Ps + BKV * kLDP;           // dSᵀ
  float* Ls = dSs + BKV * kLDP;           // NS stages of the query tile's lse
  float* Ds = Ls + NS * kBQ;              // and delta

  const bool pv = threadIdx.x < HALF;     // this half: Pᵀ and dv; the other dPᵀ, dSᵀ, dk
  const int t = threadIdx.x % HALF;
  const int tx = t % kTX, ty = t / kTX;
  const int hkv = hq / group;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * BKV;
  const long long qss = st.v[2], dss = st.v[11];
  copy_tile<ALIGNED, BKV, DP, NT>(Ks, k + b * st.v[3] + hk * st.v[4], st.v[5], k0, sk, d);
  copy_tile<ALIGNED, BKV, DP, NT>(Vs, v + b * st.v[6] + hk * st.v[7], st.v[8], k0, sk, d);

  // causal: query tiles wholly above this kv block's first row see none of it
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  const int ntq = qstart < sq ? (sq - qstart + kBQ - 1) / kBQ : 0;
  const int ntiles = group * ntq;   // tile n: query head hk·group + n / ntq
  // Q, dO, lse and delta of tile n into stage n % NS (zeros past sq)
  auto issue = [&](int n) {
    const int g = n / ntq, q0 = qstart + (n - g * ntq) * kBQ;
    const int h = hk * group + g, stage = n % NS;
    copy_tile<ALIGNED, kBQ, DP, NT>(Qs + stage * kBQ * LD, q + b * st.v[0] + h * st.v[1], qss,
                                    q0, sq, d);
    copy_tile<ALIGNED, kBQ, DP, NT>(dOs + stage * kBQ * LD, dout + b * st.v[9] + h * st.v[10],
                                    dss, q0, sq, d);
    const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
    for (int i = threadIdx.x; i < 2 * kBQ; i += NT) {
      const int r = i % kBQ, row = q0 + r;
      const float* src = (i < kBQ ? lse : delta) + head_row0;
      sc_mma::cp_async_4((i < kBQ ? Ls : Ds) + stage * kBQ + r, row < sq ? src + row : src,
                         row < sq ? 4 : 0);
    }
  };
  if (ntiles > 0) issue(0);
  cp_async_commit();

  const int row0 = ty * kTM;  // the thread's first kv row in the block
  float acc[kTM][DP / kTX];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < DP / kTX; ++c) acc[i][c] = 0.f;
  const int pair = t / 32;  // the named barrier of this warp and its partner
  const float scale_log2 = scale * kLog2e;

  for (int n = 0; n < ntiles; ++n) {
    const int g = n / ntq, q0 = qstart + (n - g * ntq) * kBQ, stage = n % NS;
    if constexpr (NS == 1) {
      if (n > 0) {
        __syncthreads();  // every thread is done with tile n - 1
        issue(n);
        cp_async_commit();
      }
    }
    cp_async_wait<0>();  // tile n (and K, V)
    __syncthreads();     // ... seen by every thread, and every thread is done with tile n - 1
    if constexpr (NS == 2) {
      if (n + 1 < ntiles) {  // tile n + 1, under tile n's math
        issue(n + 1);
        cp_async_commit();
      }
    }
    const float* Qt = Qs + stage * kBQ * LD;
    const float* dOt = dOs + stage * kBQ * LD;
    const float* Lt = Ls + stage * kBQ;
    const float* Dt = Ds + stage * kBQ;
    float* Pt = Ps + row0 * kLDP;
    float* dSt = dSs + row0 * kLDP;
    const bool edge = q0 + kBQ > sq || (causal && k0 + BKV - 1 > q0);  // ragged or diagonal
    float s[kTM][TN];
    if (pv) {
      score_tile<DP>(s, Ks + row0 * LD, Qt, tx);  // Sᵀ = K·Qᵀ
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int qc = tx + kTX * j;
        const float l2 = Lt[qc] * kLog2e;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const int kr = k0 + row0 + i;  // the kv row is the score's row
          const bool keep = !edge || (q0 + qc < sq && (!causal || kr <= q0 + qc));
          const float p = exp2f(fmaf(s[i][j], scale_log2, -l2));
          Pt[i * kLDP + qc] = keep ? p : 0.f;
        }
      }
      sc_mma::named_barrier(1 + pair, 64);  // Pᵀ to the partner
      acc_tile<DP>(acc, Pt, dOt, tx);       // dv += Pᵀ·dO
    } else {
      score_tile<DP>(s, Vs + row0 * LD, dOt, tx);  // dPᵀ = V·dOᵀ
      sc_mma::named_barrier(1 + pair, 64);         // the partner's Pᵀ
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int qc = tx + kTX * j;
        const float dl = Dt[qc];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          dSt[i * kLDP + qc] = Pt[i * kLDP + qc] * (s[i][j] - dl) * scale;
      }
      __syncwarp();                    // the row group's dSᵀ, written by its own warp
      acc_tile<DP>(acc, dSt, Qt, tx);  // dk += dSᵀ·Q
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (K, V when ntiles = 0)
  const long long kv_row0 = (static_cast<long long>(b) * hkv + hk) * sk;
  store_tile<DP>(pv ? dv : dk, acc, kv_row0, k0 + row0, sk, d, tx);
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

template <int DP, bool ALIGNED>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq,
              int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
              float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  const auto kernel = flash_bwd_dq_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + dq_rows<DP>() - 1) / dq_rows<DP>());
  kernel<<<grid, dq_threads<DP>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), hq, hq / hkv, sq,
      sk, d, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool ALIGNED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int hq, int hkv, int sq, int sk, int d, const Strides& st,
               float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  const auto kernel = flash_bwd_dkv_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hkv, (sk + dkv_rows<DP>() - 1) / dkv_rows<DP>());
  kernel<<<grid, dkv_threads<DP>(), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), hq, hq / hkv, sq, sk, d, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// Every kernel's padded head dim: d rounded up to a multiple of 16 up to
// 128, then 160 or 256; 0 when d is out of range.
inline int forward_dim(int d) {
  if (d <= 0 || d > 256) return 0;
  if (d <= 128) return (d + 15) / 16 * 16;
  return d <= 160 ? 160 : 256;
}

bool bad_shape(int b, int hq, int hkv, int d) {
  return forward_dim(d) == 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535 ||
         hkv > 65535;
}

// Whether every row of a (batch, head, row) strided f32 tensor starts on 16
// bytes: the base address, and the strides of the dimensions longer than 1.
bool rows_aligned(const void* p, const long long* s, long long n0, long long n1, long long n2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (n0 <= 1 || s[0] % 4 == 0) &&
         (n1 <= 1 || s[1] % 4 == 0) && (n2 <= 1 || s[2] % 4 == 0);
}

// The backward's inputs all on 16 bytes a row: q and do (b, hq, sq), k and
// v (b, hkv, sk), strides as the entries take them.
bool bwd_aligned(const void* q, const void* k, const void* v, const void* dout,
                 const long long* s, int b, int hq, int hkv, int sq, int sk) {
  return rows_aligned(q, s, b, hq, sq) && rows_aligned(k, s + 3, b, hkv, sk) &&
         rows_aligned(v, s + 6, b, hkv, sk) && rows_aligned(dout, s + 9, b, hq, sq);
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

// The forward's wider head dims, launched from the C entry (unit 0) and
// compiled in units 3 and 4: dp is forward_dim(d); strides as the entry's.
namespace sc_flash_units {
int fwd_mid(int dp, bool aligned, const void* q, const void* k, const void* v, void* o,
            float* lse, int b, int hq, int hkv, int sq, int sk, int d,
            const long long* strides, float scale, int causal, cudaStream_t stream);
int fwd_wide(int dp, bool aligned, const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int hq, int hkv, int sq, int sk, int d,
             const long long* strides, float scale, int causal, cudaStream_t stream);
}  // namespace sc_flash_units

#define SC_FWD(DP)                                                                       \
  case DP:                                                                               \
    return fwd_at<DP>(aligned, q, k, v, o, lse, b, hq, hkv, sq, sk, d, copy_strides(strides, 9), \
                      scale, causal, stream);

#if SC_IN_PART(3)
int sc_flash_units::fwd_mid(int dp, bool aligned, const void* q, const void* k, const void* v,
                            void* o, float* lse, int b, int hq, int hkv, int sq, int sk, int d,
                            const long long* strides, float scale, int causal,
                            cudaStream_t stream) {
  switch (dp) {
    SC_FWD(96) SC_FWD(112) SC_FWD(128)
    default: return kInvalid;
  }
}
#endif

#if SC_IN_PART(4)
int sc_flash_units::fwd_wide(int dp, bool aligned, const void* q, const void* k, const void* v,
                             void* o, float* lse, int b, int hq, int hkv, int sq, int sk, int d,
                             const long long* strides, float scale, int causal,
                             cudaStream_t stream) {
  switch (dp) {
    SC_FWD(160) SC_FWD(256)
    default: return kInvalid;
  }
}
#endif

extern "C" {

#if SC_IN_PART(0)
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
  const bool aligned = rows_aligned(q, strides, b, hq, sq) &&
                       rows_aligned(k, strides + 3, b, hkv, sk) &&
                       rows_aligned(v, strides + 6, b, hkv, sk);
  const int dp = forward_dim(d);
  switch (dp) {
    SC_FWD(16) SC_FWD(32) SC_FWD(48) SC_FWD(64) SC_FWD(80)
    case 96: case 112: case 128:
      return sc_flash_units::fwd_mid(dp, aligned, q, k, v, o, lse, b, hq, hkv, sq, sk, d,
                                     strides, scale, causal, stream);
    case 160: case 256:
      return sc_flash_units::fwd_wide(dp, aligned, q, k, v, o, lse, b, hq, hkv, sq, sk, d,
                                      strides, scale, causal, stream);
    default: return kInvalid;
  }
}
#endif
#undef SC_FWD

#if SC_IN_PART(1)
// dq (b, hq, sq, d) from q, k, v, do, lse and delta; float32 only (dtype 1,
// bf16, is refused: sc_flash_bwd_dq_mma runs it). strides = the forward's
// nine, then {do batch, do head, do row}.
int sc_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dq,
                    int b, int hq, int hkv, int sq, int sk, int d,
                    const long long* strides, float scale, int causal, int dtype,
                    cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (dtype != 0 || bad_shape(b, hq, hkv, d) || static_cast<long long>(b) * hq > 0x7fffffffLL ||
      (sq + 63) / 64 > 65535)
    return kInvalid;
  const Strides st = copy_strides(strides, 12);
  const bool aligned = bwd_aligned(q, k, v, dout, strides, b, hq, hkv, sq, sk);
  switch (forward_dim(d)) {
#define SC_DQ(DP)                                                                            \
  case DP:                                                                                   \
    return aligned ? launch_dq<DP, true>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, \
                                         d, st, scale, causal, stream)                       \
                   : launch_dq<DP, false>(q, k, v, dout, lse, delta, dq, b, hq, hkv, sq, sk, \
                                          d, st, scale, causal, stream);
    SC_DQ(16) SC_DQ(32) SC_DQ(48) SC_DQ(64) SC_DQ(80) SC_DQ(96) SC_DQ(112)
    SC_DQ(128) SC_DQ(160) SC_DQ(256)
#undef SC_DQ
    default: return kInvalid;
  }
}
#endif

#if SC_IN_PART(2)
// dk, dv (b, hkv, sk, d), each summed over its kv head's query heads;
// float32 only (dtype 1, bf16, is refused: sc_flash_bwd_dkv_mma runs it).
// Strides as for sc_flash_bwd_dq.
int sc_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     const long long* strides, float scale, int causal, int dtype,
                     cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || sk <= 0) return 0;
  if (dtype != 0 || bad_shape(b, hq, hkv, d) || static_cast<long long>(b) * hkv > 0x7fffffffLL ||
      (sk + 31) / 32 > 65535)
    return kInvalid;
  const Strides st = copy_strides(strides, 12);
  const bool aligned = bwd_aligned(q, k, v, dout, strides, b, hq, hkv, sq, sk);
  switch (forward_dim(d)) {
#define SC_DKV(DP)                                                                              \
  case DP:                                                                                      \
    return aligned ? launch_dkv<DP, true>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq, sk, \
                                          d, st, scale, causal, stream)                         \
                   : launch_dkv<DP, false>(q, k, v, dout, lse, delta, dk, dv, b, hq, hkv, sq,   \
                                           sk, d, st, scale, causal, stream);
    SC_DKV(16) SC_DKV(32) SC_DKV(48) SC_DKV(64) SC_DKV(80) SC_DKV(96) SC_DKV(112)
    SC_DKV(128) SC_DKV(160) SC_DKV(256)
#undef SC_DKV
    default: return kInvalid;
  }
}
#endif

}  // extern "C"
