// Hand-written Hopper (sm_90a) flash attention on the bf16 tensor cores:
// the forward and the two backward kernels (dq, dk/dv) for bf16 inputs.
//
// Replaces, in src/repro/kernels/flash_attention.py:
//   _fwd_kernel     (:41,  pallas_call at :133) -> flash_fwd_mma_kernel
//   _bwd_dq_kernel  (:167, pallas_call at :289) -> flash_bwd_dq_mma_kernel
//   _bwd_dkv_kernel (:209, pallas_call at :303) -> flash_bwd_dkv_mma_kernel
// for bf16 q, k, v (and do) at every head width d <= 256. f32 inputs take
// the CUDA-core kernels of flash_attention.cu; the choice is made by the
// wrapper (kernels/flash_attention.py: variant) from the dtype alone. The
// interface, the masking and the outputs are those of flash_attention.cu:
// q, do (b, hq, sq, d) and k, v (b, hkv, sk, d) with their own batch, head
// and row strides (rows contiguous); o, dq (b, hq, sq, d), dk, dv (b, hkv,
// sk, d) written contiguous in bf16; lse and delta (b, hq, sq) contiguous f32.
// Causal keeps col <= row from the top left also when sq != sk; a row with
// no key gets o = 0 and lse = +inf; lse is the natural-log log-sum-exp. The
// softmax runs in base 2, exp(x·scale) = exp2(x·scale·log2 e), with
// log2 e folded into the scale, and lse is converted back to base e. The
// dkv kernel sums each kv head's query heads in its own block: no atomics,
// deterministic. The plain versions are attention_with_lse and
// attention_bwd in src/repro_torch/kernels/ref.py.
//
// Bound: with P causal (q, k) pairs the forward does 4·P·d operations, dq
// 6·P·d (S, dP, dS·K) and dkv 8·P·d (Sᵀ, dPᵀ, Pᵀ·dO, dSᵀ·Q). At the training
// shape (b 2, 32 heads, 4096 positions, d 80, causal) that is 171.8, 257.8
// and 343.7 GFLOP: 0.1738, 0.2606 and 0.3475 ms at the tensor cores' 989
// TFLOP/s bf16 (dense), against 0.05-0.08 ms of bytes at 3.35 TB/s. mma.sync does not reach that peak on
// Hopper (wgmma does): this design is the FlashAttention-2 structure.
//
// Rounding: products take bf16 operands with f32 accumulation. P (forward
// and dkv), dSᵀ (dkv) and dS (dq) are rounded to bf16 before their second
// product, where the reference keeps them in f32; the softmax normaliser
// sums the unrounded f32 p. o, dq, dk and dv are rounded to bf16 once at the
// end.
//
// Design. 128 threads (4 warps) a block. Tiles stream from device memory
// through a two-stage cp.async ring in shared memory (16-byte copies,
// zero-filled past the last row and past d): each step waits for its own
// tile, passes one __syncthreads, then starts the next tile's copies into
// the other stage, behind its own math. Every operand reaches the tensor
// cores through ldmatrix. Shared rows are DP + 8 bf16 long, DP = d rounded
// up to a multiple of 16 (the mma depth): the row stride is then an odd
// multiple of 16 bytes, so ldmatrix's eight row addresses fall in distinct
// banks. d = 80 runs at 80. Widths: all three instantiate DP in
// {16, 32, ..., 128, 160, 256} (a d in (160, 256) runs at 256).
//
// - forward: one block per (batch, query head, BM query rows), blocks
//   ordered so that the query tiles with the most kv tiles start first
//   (grid.y counts down). A warp owns MT m-tiles of 16 query rows: MT = 2
//   up to DP 80 (BM 128), where each K and V fragment read from shared
//   memory then feeds two products (with one m-tile a warp, ldmatrix
//   traffic, one ldmatrix.x4 of 512 bytes per two mma, bounds the kernel
//   before the tensor cores do), and MT = 1 above (BM 64). Kv tiles of BN
//   rows (64; 32 at DP 256) stream through the ring. Q's fragments stay in
//   registers at MT = 1 up to DP 128 and are re-read from shared memory
//   otherwise (at DP 80 with MT = 2 they would push the kernel past 255
//   registers into spills). S = Q·Kᵀ (K row-major is mma's B operand as it
//   lies); the online-softmax state lives in the accumulator layout: a
//   thread holds rows g and g + 8 of an m-tile, so a row's max takes two
//   __shfl_xor_sync within its quad, and the normaliser stays a per-thread
//   partial sum until the end. P is packed to bf16 in registers as the A
//   operand of P·V (V through ldmatrix.trans); O accumulates in f32
//   registers. Causal: tiles wholly above the diagonal are never loaded, a
//   warp skips a tile above all its rows, and only the ragged and diagonal
//   tiles are masked.
// - dkv: one block per (batch, kv head, 64 kv rows), 16 a warp; K and V
//   stay in shared memory, and the block walks the group's query heads and,
//   for each, the 64-row query tiles from the causal start, Q, dO, lse and
//   delta through the ring. Per 32-query sub-tile a warp computes
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (Q and dO through ldmatrix), then
//   Pᵀ = exp(Sᵀ·scale − lse) and dSᵀ = Pᵀ ⊙ (dPᵀ − delta)·scale in
//   registers, and adds Pᵀ·dO to dV and dSᵀ·Q to dK (dO and Q through
//   ldmatrix.trans). dK and dV (DP/2 f32 each per thread) stay in
//   registers, 248 of them at DP 128. K's and V's fragments are re-read
//   from shared memory (kept in registers they cost occupancy and gained
//   nothing at DP 80). Above DP 128 the two accumulators would not fit, so
//   the block takes 8 warps, two per 16 kv rows, that split the work by
//   columns: per 64-query step each warp of a pair computes Sᵀ and dPᵀ for
//   32 of the query columns, writes its Pᵀ and dSᵀ (rounded to bf16, as
//   they are for their second product anyway) into the pair's 16 x 64
//   exchange tile in shared memory, meets its partner at a named barrier,
//   and then adds Pᵀ·dO and dSᵀ·Q over all 64 queries into its own DP/2
//   columns of dV and dK: DP/4 f32 each a thread, 80 / 128 for both at DP
//   160 / 256. The exchange tile is reused by the next step only after the
//   block's barrier at that step's start.
// - dq: the forward's structure with a second score product and no online
//   softmax, since lse and delta are known. One block per (batch, query
//   head, BM query rows), the longest causal rows first; Q and dO stay in
//   shared memory, K and V tiles of BN rows stream through the ring, and a
//   thread keeps its rows' lse (base 2) and delta in registers. A warp owns
//   MT m-tiles: MT = 2 up to DP 80 (BM 128), so each K fragment of dS·K
//   feeds two products; S = Q·Kᵀ and dP = dO·Vᵀ (K and V row-major, the B
//   operands as they lie) then go 32 kv columns at a time, for two score
//   tiles and two dQ accumulators of DP/2 f32 to fit in registers (236 at DP
//   80). P = exp2(S·scale·log2 e − lse·log2 e) and dS = P ⊙ (dP − delta)·scale
//   in registers, dS packed to bf16 as the A operand of dQ += dS·K (K through
//   ldmatrix.trans). MT = 1 above DP 80 (BM 64), with Q's and dO's fragments
//   in registers up to DP 128; BN 64, and 32 from DP 160 so that two blocks
//   fit on an SM. A row with no key (lse = +inf) gets p = 0 and dq = 0.
// - Inputs whose rows do not start on 16 bytes (a base address off 16
//   bytes, or a stride not a multiple of 8 elements: d = 100 contiguous)
//   take an ALIGNED = false instantiation that loads tiles element by
//   element; the wrapper chooses it from the pointers and strides.
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py's build log): registers per
// thread with 16-byte copies, no spills, no static shared memory; the
// dynamic shared memory (fwd_smem_bytes, dq_smem_bytes, dkv_smem_bytes) is
// set per launch:
//   forward DP 16: 123, 32: 139, 48: 168, 64: 204, 80: 238 (67,584 B),
//     96: 131, 112: 170, 128: 168 (87,040 B), 160: 164 (107,520 B),
//     256: 238 (101,376 B);
//   dq DP 16: 123, 32: 164, 48: 168, 64: 221, 80: 236 (90,112 B),
//     96: 168, 112: 215, 128: 231 (104,448 B), 160: 164 (86,016 B),
//     256: 246 (135,168 B);
//   dkv DP 16: 95, 32: 122, 48: 128, 64: 165, 80: 166 (68,608 B),
//     96: 171, 112: 241, 128: 248 (105,472 B); 8 warps: 160: 170
//     (148,480 B), 256: 245 (222,208 B).
//
// Interface: plain extern "C" functions loaded with ctypes. Each launches on
// the caller's stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

// Translation units: the build compiles this source as three units
// (native.PARTS), unit i with -DSC_PART=i (0: the forward, 1: dq, 2:
// dk/dv), and links them into one library. Each C entry, and the kernels
// its switch instantiates, lies in one unit, so the three families compile
// side by side. Without SC_PART the whole source is one unit.
#ifdef SC_PART
#define SC_IN_PART(i) (SC_PART == (i))
#else
#define SC_IN_PART(i) 1
#endif

namespace {

using bf16 = __nv_bfloat16;
using namespace sc_mma;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // kv rows per dkv block (16 per warp or pair of warps)
constexpr int kBQ = 64;             // query rows per streamed dkv tile
constexpr int kSub = 32;            // score columns of one dkv or dq sub-tile in registers
constexpr int kLDX = kBQ + 8;       // row stride of a dkv pair's Pᵀ / dSᵀ exchange tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long v[12];  // {q, k, v, do} x {batch, head, row}, in elements
};

// The forward's tiles: BN kv rows a tile, and MT 16-row m-tiles a warp
// (two up to DP 80, where two O accumulators and score tiles still fit in
// registers, so each K and V fragment read from shared memory serves twice
// as many products); Q's fragments stay in registers where they fit.
template <int DP>
__host__ __device__ constexpr int fwd_bn() { return DP > 160 ? 32 : 64; }
template <int DP>
__host__ __device__ constexpr int fwd_mt() { return DP <= 80 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int fwd_rows() { return 16 * fwd_mt<DP>() * kWarps; }
template <int DP>
__host__ __device__ constexpr bool fwd_q_in_regs() { return DP <= 128 && fwd_mt<DP>() == 1; }

template <int DP>
constexpr size_t fwd_smem_bytes() {  // Q, then two stages of K and of V
  return sizeof(bf16) * static_cast<size_t>(fwd_rows<DP>() + 4 * fwd_bn<DP>()) * (DP + 8);
}

// dkv's split (see the header): warps per 16 kv rows, each keeping 1 / SPLIT
// of dK's and dV's columns, and the query columns of one score sub-tile of
// a row group (all of a 64-row step when split).
template <int DP>
__host__ __device__ constexpr int dkv_split() { return DP > 128 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int dkv_threads() { return kThreads * dkv_split<DP>(); }
template <int DP>
__host__ __device__ constexpr int dkv_sub() { return dkv_split<DP>() > 1 ? kBQ : kSub; }

template <int DP>
constexpr size_t dkv_smem_bytes() {  // K, V, two stages of Q and dO, of lse and delta,
                                     // and when split each pair's Pᵀ and dSᵀ tiles
  return sizeof(bf16) * static_cast<size_t>(2 * kRows + 4 * kBQ) * (DP + 8) +
         sizeof(float) * 4 * kBQ +
         (dkv_split<DP>() > 1 ? sizeof(bf16) * static_cast<size_t>(kRows / 16) * 2 * 16 * kLDX
                              : 0);
}

// dq's tiles: MT 16-row m-tiles a warp (two up to DP 80, where two dQ
// accumulators and a 32-column sub-tile of S and dP for each still fit in
// registers, so each K fragment of dS·K feeds both), BN kv rows a tile (32
// from DP 160, so that two blocks share an SM); Q's and dO's fragments stay
// in registers where they fit.
template <int DP>
__host__ __device__ constexpr int dq_mt() { return DP <= 80 ? 2 : 1; }
template <int DP>
__host__ __device__ constexpr int dq_rows() { return 16 * dq_mt<DP>() * kWarps; }
template <int DP>
__host__ __device__ constexpr int dq_bn() { return DP >= 160 ? 32 : 64; }
template <int DP>
__host__ __device__ constexpr bool dq_frags_in_regs() { return dq_mt<DP>() == 1 && DP <= 128; }

template <int DP>
constexpr size_t dq_smem_bytes() {  // Q, dO, then two stages of K and of V
  return sizeof(bf16) * static_cast<size_t>(2 * dq_rows<DP>() + 4 * dq_bn<DP>()) * (DP + 8);
}

// Rows [r0, r0 + ROWS) of one head (row stride rs elements), columns
// [0, DP), into a ROWS x DP tile of row stride DP + 8; zeros at rows >= nrows
// and columns >= d, by the block's NT threads. ALIGNED: 16-byte cp.async
// copies (the caller commits and waits); otherwise element loads and plain
// stores.
template <bool ALIGNED, int ROWS, int DP, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long rs, int r0,
                                          int nrows, int d) {
  constexpr int LD = DP + 8;
  if constexpr (ALIGNED) {
    constexpr int kChunks = DP / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < ROWS * kChunks; i += NT) {
      const int r = i / kChunks, c = (i - r * kChunks) * 8;
      const bool in = r0 + r < nrows && c < d;
      cp_async_16(dst + r * LD + c, in ? src + (r0 + r) * rs + c : src,
                  in ? 2 * min(8, d - c) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      dst[r * LD + c] = (r0 + r < nrows && c < d) ? src[(r0 + r) * rs + c]
                                                  : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows row0 and row0 + 8 of a contiguous (rows, d) bf16 output from an
// accumulator in C layout (columns col0 + 8n + 2t, +1), each row scaled by
// its factor; rows >= nrows and columns >= d are not written.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NO][4], int row0,
                                           int nrows, int d, float f0, float f1, int t,
                                           int col0 = 0) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= nrows) continue;
    bf16* orow = out + static_cast<long long>(row) * d;
    const float f = half ? f1 : f0;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = col0 + 8 * n + 2 * t;
      const float x0 = acc[n][2 * half] * f, x1 = acc[n][2 * half + 1] * f;
      if ((d & 1) == 0 && col < d) {  // col even, d even: a 4-byte aligned pair
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// The A fragment of a 16-column slab kk of a score accumulator (two C
// tiles), rounded to bf16.
template <int NS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&s)[NS][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// One online-softmax step of a 16-row m-tile: s (its scores against one kv
// tile, masked with -inf) becomes p = exp2(s·scale·log2 e − m_new); the
// running max m (base-2 units), this thread's share l of the normaliser and
// the O accumulator are rescaled to m_new. Rows g and g + 8: index 0 and 1.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&acc)[NO][4],
                                             float (&m)[2], float (&l)[2], float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float base[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)  // the four threads of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    base[r] = m_new == -INFINITY ? 0.f : m_new;  // no inf - inf
    corr[r] = exp2f(m[r] - base[r]);             // 0 from m = -inf
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {  // a masked column gives exp2(-inf) = 0
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -base[e >> 1]));
    rs[0] += s[j][0] + s[j][1];
    rs[1] += s[j][2] + s[j][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
    acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
  }
}

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int hq, int group, int sq, int sk, int d, Strides st, float scale,
                     int causal) {
  constexpr int BN = fwd_bn<DP>();
  constexpr int MT = fwd_mt<DP>();   // 16-row m-tiles per warp
  constexpr int BM = fwd_rows<DP>();  // query rows per block
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;  // depth steps of Q·Kᵀ
  constexpr int NO = DP / 8;   // 8-column tiles of O
  constexpr int NS = BN / 8;   // 8-column tiles of S
  constexpr bool kQInRegs = fwd_q_in_regs<DP>();
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Ks = Qs + BM * LD;  // two stages of BN rows
  bf16* Vs = Ks + 2 * BN * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows first
  const int hk = h / group;
  const bf16* qb = q + b * st.v[0] + h * st.v[1];
  const bf16* kb = k + b * st.v[3] + hk * st.v[4];
  const bf16* vb = v + b * st.v[6] + hk * st.v[7];
  const long long kss = st.v[5], vss = st.v[8];

  const int kend = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kend + BN - 1) / BN;
  const float scale_log2 = scale * kLog2e;  // exp(x·scale) = exp2(x·scale·log2 e)

  load_tile<ALIGNED, BM, DP>(Qs, qb, st.v[2], q0, sq, d);
  if (ntiles > 0) {
    load_tile<ALIGNED, BN, DP>(Ks, kb, kss, 0, sk, d);
    load_tile<ALIGNED, BN, DP>(Vs, vb, vss, 0, sk, d);
  }
  cp_async_commit();

  const int wrow = warp * 16 * MT;      // the warp's first row in the tile
  const int wfirst = q0 + wrow, wlast = wfirst + 16 * MT - 1;  // its query rows
  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // running row max of s·scale·log2 e; this thread's normaliser
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  uint32_t qf[kQInRegs ? MT : 1][kQInRegs ? KD : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN, stage = it & 1;
    cp_async_wait<0>();  // this tile's copies, the only ones in flight
    __syncthreads();     // ... seen by every warp, and every warp is done with the other stage
    if (it + 1 < ntiles) {  // the next tile into the other stage, behind this one's math
      load_tile<ALIGNED, BN, DP>(Ks + (stage ^ 1) * BN * LD, kb, kss, k0 + BN, sk, d);
      load_tile<ALIGNED, BN, DP>(Vs + (stage ^ 1) * BN * LD, vb, vss, k0 + BN, sk, d);
      cp_async_commit();
    }
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            ldmatrix_x4(qf[mt][kk],
                        Qs + (wrow + 16 * mt + a_row(lane)) * LD + kk * 16 + a_col(lane));
      }
    }
    if (causal && k0 > wlast) continue;  // the tile lies wholly above this warp's rows
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {  // S = Q·Kᵀ, each K fragment used by every m-tile
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (kQInRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[mt][r] = qf[mt][kk][r];
        } else {
          ldmatrix_x4(a[mt], Qs + (wrow + 16 * mt + a_row(lane)) * LD + kk * 16 + a_col(lane));
        }
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {  // two 8-column tiles of S per ldmatrix
        uint32_t bk[4];
        ldmatrix_x4(bk, Kt + (j * 8 + b_row(lane)) * LD + kk * 16 + b_col(lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][j], a[mt], bk[0], bk[1]);
          mma_bf16(s[mt][j + 1], a[mt], bk[2], bk[3]);
        }
      }
    }
    const bool masked = k0 + BN > sk || (causal && k0 + BN - 1 > wfirst);  // ragged, diagonal
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (masked) {
        const int row0 = wfirst + 16 * mt + g;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (col >= sk || (causal && col > row0 + 8 * (e >> 1))) s[mt][j][e] = -INFINITY;
          }
      }
      softmax_step(s[mt], acc[mt], m[mt], l[mt], scale_log2);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {  // O += P·V, P in bf16 from registers
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], s[mt], kk);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, Vt + (kk * 16 + a_row(lane)) * LD + n * 8 + a_col(lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][n], a[mt], bv[0], bv[1]);
          mma_bf16(acc[mt][n + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (Q when ntiles = 0)

  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = wfirst + 16 * mt + g;
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], off);
      const float lr = l[mt][r];
      if (t == 0 && row0 + 8 * r < sq)
        lse[head_row0 + row0 + 8 * r] = lr > 0.f ? m[mt][r] * kLn2 + logf(lr) : INFINITY;
      f[r] = lr > 0.f ? 1.f / lr : 0.f;
    }
    store_rows<NO>(o + head_row0 * d, acc[mt], row0, sq, d, f[0], f[1], t);
  }
}

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(dkv_threads<DP>())
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int hq, int group, int sq, int sk, int d, Strides st, float scale,
                         int causal) {
  constexpr int SPLIT = dkv_split<DP>();  // warps per 16 kv rows
  constexpr int NT = dkv_threads<DP>();
  constexpr int SUB = dkv_sub<DP>();      // query columns of a row group's sub-tile
  constexpr int WC = SUB / SPLIT;         // ... of one warp's Sᵀ
  static_assert(SPLIT == 1 || SUB == kBQ, "a split block exchanges once per step");
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;          // depth steps of K·Qᵀ and V·dOᵀ
  constexpr int NO = DP / 8 / SPLIT;   // 8-column tiles of this warp's dK, dV columns
  constexpr int NS = WC / 8;           // 8-column tiles of this warp's Sᵀ
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + kRows * LD;
  bf16* Qs = Vs + kRows * LD;          // two stages of kBQ rows
  bf16* Os = Qs + 2 * kBQ * LD;        // dO, two stages
  float* Ls = reinterpret_cast<float*>(Os + 2 * kBQ * LD);  // lse, two stages
  float* Es = Ls + 2 * kBQ;                                  // delta, two stages

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp / SPLIT, half = warp - grp * SPLIT;  // row group; share of the columns
  // the row group's Pᵀ and dSᵀ exchange tiles, 16 x kLDX bf16 each (split only)
  bf16* Xp = reinterpret_cast<bf16*>(Es + 2 * kBQ) + grp * 2 * 16 * kLDX;
  bf16* Xd = Xp + 16 * kLDX;
  const int hkv = hq / group;
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int k0 = blockIdx.y * kRows;
  load_tile<ALIGNED, kRows, DP, NT>(Ks, k + b * st.v[3] + hk * st.v[4], st.v[5], k0, sk, d);
  load_tile<ALIGNED, kRows, DP, NT>(Vs, v + b * st.v[6] + hk * st.v[7], st.v[8], k0, sk, d);

  // causal: query tiles wholly above this block's first kv row see none of it
  const int qstart = causal ? (k0 / kBQ) * kBQ : 0;
  const int nq = sq > qstart ? (sq - qstart + kBQ - 1) / kBQ : 0;
  const int total = group * nq;  // (query head, query tile) steps
  auto load_step = [&](int i, int stage) {
    const int gi = i / nq, q0 = qstart + (i - gi * nq) * kBQ;
    const int h = hk * group + gi;
    load_tile<ALIGNED, kBQ, DP, NT>(Qs + stage * kBQ * LD, q + b * st.v[0] + h * st.v[1],
                                    st.v[2], q0, sq, d);
    load_tile<ALIGNED, kBQ, DP, NT>(Os + stage * kBQ * LD, dout + b * st.v[9] + h * st.v[10],
                                    st.v[11], q0, sq, d);
    const long long r0 = (static_cast<long long>(b) * hq + h) * sq + q0;
    for (int i2 = threadIdx.x; i2 < 2 * kBQ; i2 += NT) {
      const int r = i2 % kBQ;
      const float* src = (i2 < kBQ ? lse : delta) + r0;
      float* dst = (i2 < kBQ ? Ls : Es) + stage * kBQ + r;
      const bool in = q0 + r < sq;  // a row past sq reads as 0 and is masked below
      cp_async_4(dst, in ? src + r : src, in ? 4 : 0);
    }
  };
  if (total > 0) load_step(0, 0);
  cp_async_commit();  // K, V and the first step

  const int wrow = grp * 16;
  const int kr0 = k0 + wrow;          // this warp's first kv row
  const int col0 = half * (DP / SPLIT);  // this warp's first dK, dV column
  const float scale_log2 = scale * kLog2e;
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int stage = i & 1;
    cp_async_wait<0>();  // this step's copies, the only ones in flight
    __syncthreads();     // ... seen by every warp, and every warp is done with the other
                         // stage and with the exchange tiles
    if (i + 1 < total) {  // the next step into the other stage, behind this one's math
      load_step(i + 1, stage ^ 1);
      cp_async_commit();
    }
    const int q0 = qstart + (i % nq) * kBQ;
    const bf16* Qt = Qs + stage * kBQ * LD;
    const bf16* Ot = Os + stage * kBQ * LD;
    const float* Lt = Ls + stage * kBQ;
    const float* Et = Es + stage * kBQ;
#pragma unroll
    for (int c0 = 0; c0 < kBQ; c0 += SUB) {
      const int qa = q0 + c0;  // the sub-tile's first query row
      // no pair survives (the same for every warp of the row group)
      if (qa >= sq || (causal && qa + SUB - 1 < kr0)) continue;
      const int cw = c0 + half * WC;  // this warp's first score column in the tile
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
        uint32_t ak[4], av[4];
        ldmatrix_x4(ak, Ks + (wrow + a_row(lane)) * LD + kk * 16 + a_col(lane));
        ldmatrix_x4(av, Vs + (wrow + a_row(lane)) * LD + kk * 16 + a_col(lane));
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          const int off = (cw + j * 8 + b_row(lane)) * LD + kk * 16 + b_col(lane);
          uint32_t bq[4], bo[4];
          ldmatrix_x4(bq, Qt + off);
          ldmatrix_x4(bo, Ot + off);
          mma_bf16(s[j], ak, bq[0], bq[1]);
          mma_bf16(s[j + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[j], av, bo[0], bo[1]);
          mma_bf16(dp[j + 1], av, bo[2], bo[3]);
        }
      }
      const bool masked = (causal && kr0 + 15 > qa) || qa + SUB > sq;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cw + j * 8 + 2 * t + (e & 1);  // the query's row in the tile
          float p = exp2f(fmaf(s[j][e], scale_log2, -Lt[c] * kLog2e));  // lse = +inf: 0
          if (masked) {
            const int kv = kr0 + g + 8 * (e >> 1);
            if (q0 + c >= sq || (causal && kv > q0 + c)) p = 0.f;
          }
          dp[j][e] = p * (dp[j][e] - Et[c]) * scale;  // dSᵀ
          s[j][e] = p;                                 // Pᵀ
        }
      if constexpr (SPLIT > 1) {  // the pair's Pᵀ and dSᵀ, rounded to bf16, meet in Xp, Xd
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int col = half * WC + j * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(Xp + g * kLDX + col) = pack_bf16(s[j][0], s[j][1]);
          *reinterpret_cast<uint32_t*>(Xp + (g + 8) * kLDX + col) = pack_bf16(s[j][2], s[j][3]);
          *reinterpret_cast<uint32_t*>(Xd + g * kLDX + col) = pack_bf16(dp[j][0], dp[j][1]);
          *reinterpret_cast<uint32_t*>(Xd + (g + 8) * kLDX + col) =
              pack_bf16(dp[j][2], dp[j][3]);
        }
        named_barrier(1 + grp, 32 * SPLIT);
      }
#pragma unroll
      for (int kk = 0; kk < SUB / 16; ++kk) {  // dV += Pᵀ·dO, dK += dSᵀ·Q in bf16
        uint32_t ap[4], ad[4];
        if constexpr (SPLIT > 1) {
          ldmatrix_x4(ap, Xp + a_row(lane) * kLDX + kk * 16 + a_col(lane));
          ldmatrix_x4(ad, Xd + a_row(lane) * kLDX + kk * 16 + a_col(lane));
        } else {
          pack_a(ap, s, kk);
          pack_a(ad, dp, kk);
        }
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          const int off = (c0 + kk * 16 + a_row(lane)) * LD + col0 + n * 8 + a_col(lane);
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, Ot + off);
          ldmatrix_x4_trans(bq, Qt + off);
          mma_bf16(dva[n], ap, bo[0], bo[1]);
          mma_bf16(dva[n + 1], ap, bo[2], bo[3]);
          mma_bf16(dka[n], ad, bq[0], bq[1]);
          mma_bf16(dka[n + 1], ad, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (K and V when total = 0)
  const long long kv_row0 = (static_cast<long long>(b) * hkv + hk) * sk;
  store_rows<NO>(dk + kv_row0 * d, dka, kr0 + g, sk, d, 1.f, 1.f, t, col0);
  store_rows<NO>(dv + kv_row0 * d, dva, kr0 + g, sk, d, 1.f, 1.f, t, col0);
}

template <int DP, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int hq, int group, int sq, int sk, int d,
                        Strides st, float scale, int causal) {
  constexpr int BN = dq_bn<DP>();
  constexpr int MT = dq_mt<DP>();    // 16-row m-tiles per warp
  constexpr int BM = dq_rows<DP>();  // query rows per block
  constexpr int LD = DP + 8;
  constexpr int KD = DP / 16;   // depth steps of Q·Kᵀ and dO·Vᵀ
  constexpr int NO = DP / 8;    // 8-column tiles of dQ
  constexpr int NS = kSub / 8;  // 8-column tiles of an S or dP sub-tile
  constexpr bool kRegs = dq_frags_in_regs<DP>();
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Os = Qs + BM * LD;      // dO
  bf16* Ks = Os + BM * LD;      // two stages of BN rows
  bf16* Vs = Ks + 2 * BN * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest causal rows first
  const int hk = h / group;
  const bf16* kb = k + b * st.v[3] + hk * st.v[4];
  const bf16* vb = v + b * st.v[6] + hk * st.v[7];
  const long long kss = st.v[5], vss = st.v[8];

  const int kend = causal ? min(sk, q0 + BM) : sk;
  const int ntiles = (kend + BN - 1) / BN;
  const float scale_log2 = scale * kLog2e;

  load_tile<ALIGNED, BM, DP>(Qs, q + b * st.v[0] + h * st.v[1], st.v[2], q0, sq, d);
  load_tile<ALIGNED, BM, DP>(Os, dout + b * st.v[9] + h * st.v[10], st.v[11], q0, sq, d);
  if (ntiles > 0) {
    load_tile<ALIGNED, BN, DP>(Ks, kb, kss, 0, sk, d);
    load_tile<ALIGNED, BN, DP>(Vs, vb, vss, 0, sk, d);
  }
  cp_async_commit();

  const int wrow = warp * 16 * MT;
  const int wfirst = q0 + wrow, wlast = wfirst + 16 * MT - 1;
  const long long head_row0 = (static_cast<long long>(b) * hq + h) * sq;
  // rows g and g + 8 of each m-tile: lse in base 2 (+inf past sq, so p = 0) and delta
  float lse2[MT][2], dlt[MT][2];
  float acc[MT][NO][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wfirst + 16 * mt + g + 8 * r;
      lse2[mt][r] = row < sq ? lse[head_row0 + row] * kLog2e : INFINITY;
      dlt[mt][r] = row < sq ? delta[head_row0 + row] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  }
  uint32_t qf[kRegs ? KD : 1][4], of[kRegs ? KD : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BN, stage = it & 1;
    cp_async_wait<0>();  // this tile's copies, the only ones in flight
    __syncthreads();     // ... seen by every warp, and every warp is done with the other stage
    if (it + 1 < ntiles) {  // the next tile into the other stage, behind this one's math
      load_tile<ALIGNED, BN, DP>(Ks + (stage ^ 1) * BN * LD, kb, kss, k0 + BN, sk, d);
      load_tile<ALIGNED, BN, DP>(Vs + (stage ^ 1) * BN * LD, vb, vss, k0 + BN, sk, d);
      cp_async_commit();
    }
    if constexpr (kRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int off = (wrow + a_row(lane)) * LD + kk * 16 + a_col(lane);
          ldmatrix_x4(qf[kk], Qs + off);
          ldmatrix_x4(of[kk], Os + off);
        }
      }
    }
    if (causal && k0 > wlast) continue;  // the tile lies wholly above this warp's rows
    const bf16* Kt = Ks + stage * BN * LD;
    const bf16* Vt = Vs + stage * BN * LD;
#pragma unroll
    for (int c0 = 0; c0 < BN; c0 += kSub) {
      const int ca = k0 + c0;  // the sub-tile's first kv row
      if (ca >= sk || (causal && ca > wlast)) continue;  // no pair survives
      float s[MT][NS][4], dp[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = dp[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {  // S = Q·Kᵀ, dP = dO·Vᵀ
        uint32_t aq[MT][4], ao[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (kRegs) {
#pragma unroll
            for (int r = 0; r < 4; ++r) aq[mt][r] = qf[kk][r], ao[mt][r] = of[kk][r];
          } else {
            const int off = (wrow + 16 * mt + a_row(lane)) * LD + kk * 16 + a_col(lane);
            ldmatrix_x4(aq[mt], Qs + off);
            ldmatrix_x4(ao[mt], Os + off);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; j += 2) {  // two 8-column tiles per ldmatrix
          const int off = (c0 + j * 8 + b_row(lane)) * LD + kk * 16 + b_col(lane);
          uint32_t bk[4], bv[4];
          ldmatrix_x4(bk, Kt + off);
          ldmatrix_x4(bv, Vt + off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], aq[mt], bk[0], bk[1]);
            mma_bf16(s[mt][j + 1], aq[mt], bk[2], bk[3]);
            mma_bf16(dp[mt][j], ao[mt], bv[0], bv[1]);
            mma_bf16(dp[mt][j + 1], ao[mt], bv[2], bv[3]);
          }
        }
      }
      const bool masked = ca + kSub > sk || (causal && ca + kSub - 1 > wfirst);  // ragged, diagonal
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[mt][j][e], scale_log2, -lse2[mt][e >> 1]));  // lse = +inf: 0
            if (masked) {
              const int col = ca + j * 8 + 2 * t + (e & 1);
              const int row = wfirst + 16 * mt + g + 8 * (e >> 1);
              if (col >= sk || (causal && col > row)) p = 0.f;
            }
            dp[mt][j][e] = p * (dp[mt][j][e] - dlt[mt][e >> 1]) * scale;  // dS
          }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {  // dQ += dS·K, dS in bf16 from registers
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) pack_a(a[mt], dp[mt], kk);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, Kt + (c0 + kk * 16 + a_row(lane)) * LD + n * 8 + a_col(lane));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][n], a[mt], bk[0], bk[1]);
            mma_bf16(acc[mt][n + 1], a[mt], bk[2], bk[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (Q and dO when ntiles = 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<NO>(dq + head_row0 * d, acc[mt], wfirst + 16 * mt + g, sq, d, 1.f, 1.f, t);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int b, hq, hkv, sq, sk, d;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP, bool ALIGNED>
int launch_fwd(const Args& a) {
  constexpr size_t smem = fwd_smem_bytes<DP>();
  const auto kernel = flash_fwd_mma_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.b * a.hq, (a.sq + fwd_rows<DP>() - 1) / fwd_rows<DP>());
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse_out, a.hq, a.hq / a.hkv,
      a.sq, a.sk, a.d, a.st, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool ALIGNED>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  const auto kernel = flash_bwd_dkv_mma_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.b * a.hkv, (a.sk + kRows - 1) / kRows);
  kernel<<<grid, dkv_threads<DP>(), smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.hq, a.hq / a.hkv, a.sq, a.sk,
      a.d, a.st, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool ALIGNED>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  const auto kernel = flash_bwd_dq_mma_kernel<DP, ALIGNED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.b * a.hq, (a.sq + dq_rows<DP>() - 1) / dq_rows<DP>());
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.hq, a.hq / a.hkv, a.sq, a.sk, a.d, a.st, a.scale, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int fwd_at(const Args& a, bool aligned) {
  return aligned ? launch_fwd<DP, true>(a) : launch_fwd<DP, false>(a);
}

template <int DP>
int dkv_at(const Args& a, bool aligned) {
  return aligned ? launch_dkv<DP, true>(a) : launch_dkv<DP, false>(a);
}

template <int DP>
int dq_at(const Args& a, bool aligned) {
  return aligned ? launch_dq<DP, true>(a) : launch_dq<DP, false>(a);
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// d rounded up to a multiple of 16 (the mma depth) up to 128; above, 160
// or 256.
int forward_dim(int d) {
  if (d <= 0 || d > 256) return 0;
  if (d <= 128) return (d + 15) / 16 * 16;
  return d <= 160 ? 160 : 256;
}

#if SC_IN_PART(0)
int run_fwd(const Args& a, bool aligned) {
  switch (forward_dim(a.d)) {
    case 16: return fwd_at<16>(a, aligned);
    case 32: return fwd_at<32>(a, aligned);
    case 48: return fwd_at<48>(a, aligned);
    case 64: return fwd_at<64>(a, aligned);
    case 80: return fwd_at<80>(a, aligned);
    case 96: return fwd_at<96>(a, aligned);
    case 112: return fwd_at<112>(a, aligned);
    case 128: return fwd_at<128>(a, aligned);
    case 160: return fwd_at<160>(a, aligned);
    case 256: return fwd_at<256>(a, aligned);
    default: return kInvalid;
  }
}
#endif

#if SC_IN_PART(1)
int run_dq(const Args& a, bool aligned) {
  switch (forward_dim(a.d)) {
    case 16: return dq_at<16>(a, aligned);
    case 32: return dq_at<32>(a, aligned);
    case 48: return dq_at<48>(a, aligned);
    case 64: return dq_at<64>(a, aligned);
    case 80: return dq_at<80>(a, aligned);
    case 96: return dq_at<96>(a, aligned);
    case 112: return dq_at<112>(a, aligned);
    case 128: return dq_at<128>(a, aligned);
    case 160: return dq_at<160>(a, aligned);
    case 256: return dq_at<256>(a, aligned);
    default: return kInvalid;
  }
}
#endif

#if SC_IN_PART(2)
int run_dkv(const Args& a, bool aligned) {
  switch (forward_dim(a.d)) {
    case 16: return dkv_at<16>(a, aligned);
    case 32: return dkv_at<32>(a, aligned);
    case 48: return dkv_at<48>(a, aligned);
    case 64: return dkv_at<64>(a, aligned);
    case 80: return dkv_at<80>(a, aligned);
    case 96: return dkv_at<96>(a, aligned);
    case 112: return dkv_at<112>(a, aligned);
    case 128: return dkv_at<128>(a, aligned);
    case 160: return dkv_at<160>(a, aligned);
    case 256: return dkv_at<256>(a, aligned);
    default: return kInvalid;
  }
}
#endif

bool bad_shape(int b, int hq, int hkv, int sq, int sk) {
  return hkv <= 0 || hq % hkv != 0 || static_cast<long long>(b) * hq > 0x7fffffffLL ||
         (sq + kRows - 1) / kRows > 65535 || (sk + kRows - 1) / kRows > 65535;
}

Strides copy_strides(const long long* s, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.v[i] = s[i];
  return st;
}

}  // namespace

extern "C" {

#if SC_IN_PART(0)
// bf16 only. strides = {q batch, q head, q row, k ..., v ...}, in elements;
// aligned: every row of q, k and v starts on 16 bytes (base addresses and
// strides; see the header).
int sc_flash_fwd_mma(const void* q, const void* k, const void* v, void* o, float* lse,
                     int b, int hq, int hkv, int sq, int sk, int d,
                     const long long* strides, float scale, int causal, int aligned,
                     cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, sk)) return kInvalid;
  Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, nullptr, nullptr, lse,
         b, hq, hkv, sq, sk, d, copy_strides(strides, 9), scale, causal, stream};
  return run_fwd(a, aligned != 0);
}
#endif

#if SC_IN_PART(2)
// dk, dv (b, hkv, sk, d), each summed over its kv head's query heads, bf16
// only. strides = the forward's nine, then {do batch, do head, do row};
// aligned as for sc_flash_fwd_mma, over q, k, v and do.
int sc_flash_bwd_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         int b, int hq, int hkv, int sq, int sk, int d,
                         const long long* strides, float scale, int causal, int aligned,
                         cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || sk <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, sk)) return kInvalid;
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, nullptr,
         b, hq, hkv, sq, sk, d, copy_strides(strides, 12), scale, causal, stream};
  return run_dkv(a, aligned != 0);
}
#endif

#if SC_IN_PART(1)
// dq (b, hq, sq, d), bf16 only. Strides and aligned as for
// sc_flash_bwd_dkv_mma.
int sc_flash_bwd_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq,
                        int b, int hq, int hkv, int sq, int sk, int d,
                        const long long* strides, float scale, int causal, int aligned,
                        cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, sk)) return kInvalid;
  Args a{q, k, v, dout, lse, delta, nullptr, dq, nullptr, nullptr, nullptr,
         b, hq, hkv, sq, sk, d, copy_strides(strides, 12), scale, causal, stream};
  return run_dq(a, aligned != 0);
}
#endif

}  // extern "C"
