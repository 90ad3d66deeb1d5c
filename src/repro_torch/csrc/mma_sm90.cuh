// Inline-PTX building blocks for tensor-core kernels on Hopper (sm_90a):
// the warp-level bf16 product mma.sync m16n8k16 with f32 accumulators,
// ldmatrix (plain and transposed) for its operands, cp.async copies from
// device memory into shared memory, named barriers, and bf16 packing.
//
// Fragment layouts of m16n8k16 (lane = 4·g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major): a[0] = rows g, cols 2t..2t+1; a[1] = row g + 8,
//     the same cols; a[2], a[3] = rows g, g + 8, cols 8 + 2t..8 + 2t + 1.
//   B (16 x 8): b[0] = rows (k) 2t..2t+1 of col (n) g; b[1] = rows 8 + 2t..
//   C, D (16 x 8, f32): c[0..1] = row g, cols 2t..2t+1; c[2..3] = row g + 8.
// Each 32-bit register holds two bf16 values, the lower column in the low
// half. The accumulator of a 16 x 16 score block (two C tiles) therefore is
// an A fragment once packed (pack_bf16 below), with no trip through shared
// memory.
//
// ldmatrix .x4 loads four 8 x 8 bf16 matrices: lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of every lane receives two elements
// of matrix i (row lane / 4, cols 2·(lane % 4)..+1; transposed with .trans).
// The address patterns that make the four registers a fragment are:
//   a_row/a_col: an A fragment of a row-major tile, and also (with .trans)
//     the B fragments of two 8-column tiles of a row-major (k, n) tile;
//   b_row/b_col: the B fragments of two 8-column tiles from a row-major
//     (n, k) tile (B = Yᵀ), without .trans.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sc_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a·b: one m16n8k16 product, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Row and column offsets, within a 16 x 16 block, of the address this lane
// gives ldmatrix (see the header).
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }

// A barrier of `threads` threads (whole warps) of the block on named
// barrier `id` (1-15; __syncthreads takes 0).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// 16 bytes from global src to shared dst; only the first src_bytes are read
// and the rest of the 16 is zero-filled (src_bytes = 0 reads nothing). dst
// and src must be 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes, zero-filled where src_bytes = 0.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two floats rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace sc_mma
