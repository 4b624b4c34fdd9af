// Shared pieces of the bf16 attention kernels that run their tile products
// on the tensor cores (flash_attention.cu B4, flash_attention_bwd.cu B5
// and B6):
// bf16 tiles staged in shared memory with cp.async, fragment loads with
// ldmatrix, the mma.sync m16n8k16 bf16 x bf16 -> f32 product, and the
// split of a float32 operand into bf16 terms.
//
// Layouts (one warp, PTX ISA "mma.m16n8k16" fragments; g = lane / 4,
// t = lane % 4):
//   A [16 x 16] row-major:  a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B [16 x 8]  (k x n):    b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C [16 x 8]  f32:        c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1]
// Two C tiles side by side (n = 0..15) hold exactly the values of one A
// fragment of a following product, so a score tile computed in registers
// feeds the next product without a trip through shared memory.
//
// Tiles live in shared memory as rows of HD bf16 values padded by 8 (16
// bytes): the 8 rows an ldmatrix phase reads then start 16 bytes apart
// modulo 128 and hit distinct banks at every head dim the kernels take
// (32, 64, 80, 128; an 80-wide row is 160 bytes, which no 128-byte swizzle
// fits).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mma {

// bf16 elements per shared-memory row of a tile of head dim HD.
template <int HD>
__host__ __device__ constexpr int row_elems() {
  return HD + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory asynchronously; with
// bytes = 0 nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// The same for 4 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [0, n_rows) of a [64, HD] bf16 tile (row r at src + r *
// stride elements, 16-byte aligned) into shared memory rows of
// row_elems<HD>(); rows n_rows..63 are zero-filled, so padded keys, values
// and queries stay finite. All NT threads take part; the copies join the
// caller's current cp.async group.
template <int HD, int NT>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
    int64_t stride, int n_rows) {
  constexpr int kVecPerRow = HD / 8;
  constexpr int kTotal = 64 * kVecPerRow;
  static_assert(kTotal % NT == 0, "tile chunks must divide the threads");
#pragma unroll
  for (int i = 0; i < kTotal / NT; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * NT;
    const int r = e / kVecPerRow, c = (e % kVecPerRow) * 8;
    const bool in = r < n_rows;
    cp_async16(dst + r * row_elems<HD>() + c, in ? src + r * stride + c : src,
               in ? 16 : 0);
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the row address
// of matrix l / 8 (row l % 8). Without .trans lane l receives row l / 4,
// columns 2(l % 4), 2(l % 4) + 1 of each matrix; with .trans the same of
// the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of a row-major tile
// (ld elements per row).
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + 8 * (lane >> 4));
}

// B fragments of two neighbouring n-tiles (n0..n0+7 in b[0..1], n0+8..n0+15
// in b[2..3]) over k = c0..c0+15, from a tile stored [n][k] (k contiguous:
// keys x head dim for q k^T).
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + c0 +
                     8 * ((lane >> 3) & 1));
}

// The same from a tile stored [k][n] (n contiguous: keys x head dim for
// P v), read transposed.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                           n0 + 8 * (lane >> 4));
}

// c += a b on the tensor cores: [16 x 16] bf16 times [16 x 8] bf16 into a
// float32 [16 x 8] accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_col,
                                              __nv_bfloat16 hi_col) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_col)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_col)) << 16);
}

// The A fragments of the [16 x 16] operand whose float32 values sit in two
// neighbouring C tiles c0 (columns 0..7) and c1 (8..15), split into N bf16
// terms, each the bf16 rounding of what the earlier ones leave: hi =
// bf16(x), lo = bf16(x - hi), and so on. Each term multiplied into the same
// float32 accumulator, N terms keep x to about 2^-(9 + 8(N - 1)) of its
// value where one bf16 term keeps 2^-9.
template <int N>
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&a)[N][4]) {
  // register r of a fragment holds values 2r and 2r + 1 of x
  float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat16 e0 = __float2bfloat16_rn(x[2 * r]);
      const __nv_bfloat16 e1 = __float2bfloat16_rn(x[2 * r + 1]);
      a[n][r] = pack_bf16(e0, e1);
      x[2 * r] -= __bfloat162float(e0);
      x[2 * r + 1] -= __bfloat162float(e1);
    }
}

}  // namespace mma
