// Shared pieces of the SSD scan's tensor-core kernels (ssd_scan.cu, B8,
// and ssd_scan_bwd.cu, its backward): the split of a float32 operand into
// bf16 hi and lo tiles staged in shared memory, the three-term product on
// the tensor cores, and the chunk's cumulative sum of dtA. ssd_scan.cu's
// header gives the precision plan and its readings.
#pragma once

#include "attention_mma.cuh"

namespace ssd {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // 4 warps
constexpr int kTile = 64;        // rows of a staged tile or an output tile
constexpr int kMaxChunk = 1024;  // chunk rows the a_cum buffers hold
constexpr int kP = 64;           // head dim P of every compiled shape

// bf16 elements per shared-memory row of a staged tile of COLS columns.
template <int COLS>
__host__ __device__ constexpr int ld() {
  return COLS + 8;
}

// Bytes of a hi/lo pair of staged [64, COLS] tiles.
template <int COLS>
constexpr size_t pair_bytes() {
  return 2 * sizeof(bf16) * kTile * ld<COLS>();
}

// Q rounded up to a whole number of tiles.
__host__ __device__ inline int padded(int q) {
  return (q + kTile - 1) / kTile * kTile;
}

// Inclusive cumulative sum of dtA over rows [0, Q) of a chunk (row t at
// dtA[t * H]) into a_cum, and a_cum[Q - 1] into rows [Q, Qp). Every
// thread loads rows of the chunk into a_cum (all loads in flight at once),
// then warp 0 scans it in place, 32 rows at a time, carrying the running
// total. The caller syncs.
__device__ __forceinline__ void chunk_cumsum(float* a_cum,
                                             const float* __restrict__ dtA,
                                             int H, int Q, int Qp) {
  for (int t = threadIdx.x; t < Q; t += kThreads)
    a_cum[t] = __ldg(dtA + static_cast<int64_t>(t) * H);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int t = base + lane;
    float v = t < Q ? a_cum[t] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (t < Q) a_cum[t] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  for (int t = Q + lane; t < Qp; t += 32) a_cum[t] = carry;
}

// A thread's share of a [64, COLS] float32 tile in registers: float4 i
// holds row (threadIdx.x + 128 i) / (COLS / 4), columns 4 ((threadIdx.x +
// 128 i) % (COLS / 4)) onwards.
template <int COLS>
struct TileRegs {
  static constexpr int kVec = COLS / 4;  // float4 per row
  static constexpr int kIter = kTile * kVec / kThreads;
  static_assert(kTile * kVec % kThreads == 0, "tile chunks per thread");
  float4 r[kIter];
};

// Issue the thread's 16-byte loads of rows [0, 64) x columns [0, COLS) of a
// float32 block (row r at src + r * stride, 16-byte aligned); rows
// n_rows..63 are zero. Loads of several tiles issued one after another are
// in flight together.
template <int COLS>
__device__ __forceinline__ void tile_load(TileRegs<COLS>& t,
                                          const float* __restrict__ src,
                                          int64_t stride, int n_rows) {
  constexpr int kVec = TileRegs<COLS>::kVec;
#pragma unroll
  for (int i = 0; i < TileRegs<COLS>::kIter; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int row = e / kVec, col = (e % kVec) * 4;
    t.r[i] = row < n_rows ? __ldg(reinterpret_cast<const float4*>(
                                src + row * stride + col))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Store a loaded tile into shared memory as the bf16 tiles hi = bf16(v)
// and lo = bf16(v - hi), v = the value times scale[row] where a scale (in
// shared memory) is given.
template <int COLS>
__device__ __forceinline__ void tile_store_split(const TileRegs<COLS>& t,
                                                 bf16* hi, bf16* lo,
                                                 const float* scale) {
  constexpr int kVec = TileRegs<COLS>::kVec;
#pragma unroll
  for (int i = 0; i < TileRegs<COLS>::kIter; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int row = e / kVec, col = (e % kVec) * 4;
    float v[4] = {t.r[i].x, t.r[i].y, t.r[i].z, t.r[i].w};
    if (scale != nullptr) {
      const float s = scale[row];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] *= s;
    }
    // two values a conversion (cvt.rn.bf16x2.f32), the first in the low
    // half, as mma::pack_bf16 packs them
    __nv_bfloat162 h[2], l[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      h[u] = __floats2bfloat162_rn(v[2 * u], v[2 * u + 1]);
      const float2 f = __bfloat1622float2(h[u]);
      l[u] = __floats2bfloat162_rn(v[2 * u] - f.x, v[2 * u + 1] - f.y);
    }
    *reinterpret_cast<uint2*>(hi + row * ld<COLS>() + col) =
        *reinterpret_cast<const uint2*>(h);
    *reinterpret_cast<uint2*>(lo + row * ld<COLS>() + col) =
        *reinterpret_cast<const uint2*>(l);
  }
}

// Store a loaded [64, 64] tile into shared memory as float32, ld floats a
// row (a multiple of 4).
__device__ __forceinline__ void tile_store_f32(const TileRegs<64>& t,
                                               float* dst, int ld) {
  constexpr int kVec = TileRegs<64>::kVec;
#pragma unroll
  for (int i = 0; i < TileRegs<64>::kIter; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    *reinterpret_cast<float4*>(dst + (e / kVec) * ld + (e % kVec) * 4) =
        t.r[i];
  }
}

// Stage rows [0, 64) x columns [0, COLS) of a float32 block (row r at
// src + r * stride, 16-byte aligned) into shared memory as the bf16 tiles
// hi = bf16(v) and lo = bf16(v - hi), v = src[r][c] * scale[r] where a
// scale (in shared memory) is given. Rows n_rows..63 are zero. Every
// thread issues all its 16-byte loads before it converts any.
template <int COLS>
__device__ __forceinline__ void stage_split(bf16* hi, bf16* lo,
                                            const float* __restrict__ src,
                                            int64_t stride, int n_rows,
                                            const float* scale) {
  TileRegs<COLS> t;
  tile_load(t, src, stride, n_rows);
  tile_store_split(t, hi, lo, scale);
}

// The A fragment of rows m0..m0+15, columns k0..k0+15 of an operand stored
// transposed, [k][m] (m contiguous; ld elements per row), read with
// ldmatrix .trans: matrix l / 8 of lane l is (k0 + 8 (l / 16), m0 + 8 ((l
// / 8) % 2)), and lane (g, t) receives A[g][2t..2t+1] = tile[2t..2t+1][g]
// of each.
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4], const bf16* tile,
                                          int ld_, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  mma::ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld_ +
                                m0 + 8 * ((lane >> 3) & 1));
}

// c += (a_hi + a_lo)(b_hi + b_lo) less the lo.lo product, for one 16-deep
// k-step: the three products are summed in a zeroed fragment, smallest
// first, and the sum is added to c in float32.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma::mma_bf16(d, al, bh0, bh1);
  mma::mma_bf16(d, ah, bl0, bl1);
  mma::mma_bf16(d, ah, bh0, bh1);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += d[r];
}

// Store a warp's [16, 8 NT] float32 result (C fragments acc[nt]) at rows
// r0.., columns c0.. of a row-major array (ld floats per row), rows below
// n_rows only.
template <int NT>
__device__ __forceinline__ void store_frags(float* out, int64_t ld_, int r0,
                                            int c0, int n_rows,
                                            const float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = c0 + nt * 8 + 2 * t;
    if (r0 + g < n_rows)
      *reinterpret_cast<float2*>(out + (r0 + g) * ld_ + col) =
          make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + g + 8 < n_rows)
      *reinterpret_cast<float2*>(out + (r0 + g + 8) * ld_ + col) =
          make_float2(acc[nt][2], acc[nt][3]);
  }
}

// acc (rows 16 warp.. of a 64-row output tile, 64 columns) += A B over
// k-step kc (16 deep) of staged hi/lo pairs of [64, 64] tiles: A stored
// [m][k] (A_KM false) or transposed, [k][m]; B stored [k][n] (B_NK false)
// or [n][k].
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void mm16(float (&acc)[8][4], const bf16* a_hi,
                                     const bf16* a_lo, const bf16* b_hi,
                                     const bf16* b_lo, int kc) {
  constexpr int kLd = ld<64>();
  const int warp = threadIdx.x >> 5;
  uint32_t ah[4], al[4];
  if (A_KM) {
    load_a_km(ah, a_hi, kLd, warp * 16, kc * 16);
    load_a_km(al, a_lo, kLd, warp * 16, kc * 16);
  } else {
    mma::load_a(ah, a_hi, kLd, warp * 16, kc * 16);
    mma::load_a(al, a_lo, kLd, warp * 16, kc * 16);
  }
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    uint32_t bh[4], bl[4];
    if (B_NK) {
      mma::load_b_nk(bh, b_hi, kLd, np * 16, kc * 16);
      mma::load_b_nk(bl, b_lo, kLd, np * 16, kc * 16);
    } else {
      mma::load_b_kn(bh, b_hi, kLd, kc * 16, np * 16);
      mma::load_b_kn(bl, b_lo, kLd, kc * 16, np * 16);
    }
    mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
    mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
  }
}

// The same over the whole 64-deep k, its four k-steps unrolled (ROLLED
// false: the compiler may load every step's fragments ahead) or one after
// another (ROLLED: one step's fragments live at a time, for kernels that
// keep other tiles in registers).
template <bool A_KM, bool B_NK, bool ROLLED = false>
__device__ __forceinline__ void mm64(float (&acc)[8][4], const bf16* a_hi,
                                     const bf16* a_lo, const bf16* b_hi,
                                     const bf16* b_lo) {
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int kc = 0; kc < 4; ++kc)
      mm16<A_KM, B_NK>(acc, a_hi, a_lo, b_hi, b_lo, kc);
  } else {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      mm16<A_KM, B_NK>(acc, a_hi, a_lo, b_hi, b_lo, kc);
  }
}

// cb[b, c, q, s] = C[q] . B[s] for the 64 x 64 tile (i, j), j <= i, of
// chunk c = blockIdx.y of row b = blockIdx.z, blockIdx.x counting the tiles
// on or below the diagonal row by row, into cb [B, nc, Qp, Qp] (padded rows
// come from zero-filled tiles and are 0). The forward's and the backward's
// first launch.
template <int N>
__device__ __forceinline__ void cb_tile(const float* __restrict__ bm,
                                        const float* __restrict__ cm,
                                        float* __restrict__ cb, int L,
                                        int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* c_hi = reinterpret_cast<bf16*>(smem);
  bf16* c_lo = c_hi + kTile * ld<N>();
  bf16* b_hi = c_lo + kTile * ld<N>();
  bf16* b_lo = b_hi + kTile * ld<N>();
  int j = blockIdx.x, i = 0;  // the j-th tile of tile row i
  while (j > i) j -= ++i;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int Qp = padded(Q), q0 = i * kTile, s0 = j * kTile;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int warp = threadIdx.x >> 5;

  stage_split<N>(c_hi, c_lo, cm + (row0 + q0) * N, N, min(kTile, Q - q0),
                 nullptr);
  stage_split<N>(b_hi, b_lo, bm + (row0 + s0) * N, N, min(kTile, Q - s0),
                 nullptr);
  __syncthreads();

  float acc[8][4] = {};
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
    uint32_t ah[4], al[4];
    mma::load_a(ah, c_hi, ld<N>(), warp * 16, kc * 16);
    mma::load_a(al, c_lo, ld<N>(), warp * 16, kc * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // B^T [n][s]: B stored [s][n]
      uint32_t bh[4], bl[4];
      mma::load_b_nk(bh, b_hi, ld<N>(), np * 16, kc * 16);
      mma::load_b_nk(bl, b_lo, ld<N>(), np * 16, kc * 16);
      mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
      mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
    }
  }
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  store_frags<8>(out, Qp, q0 + warp * 16, s0, Qp, acc);
}

// acc += sum_s (v[s] f[s])^T m[s, n0..n0+63] over the Q rows of a chunk,
// for rows 16 warp.. of P: v [Q, P] (row s at v + s vrow), m [Q, N] (row s
// at m + s N), f[s] = exp(a_last - a_cum[s]) (from_last) or exp(a_cum[s]),
// with a_cum the chunk's cumulative sums of dtA (s_a, shared). v's tiles go
// to v_hi/lo, m's to m_hi/lo ([64, 64] pairs), f to s_f [64]. The forward's
// chunk states (x, B, from the last row) and the backward's state gradients
// (dy, C, from the first).
template <int N>
__device__ __forceinline__ void chunk_state_product(
    float (&acc)[8][4], bf16* v_hi, bf16* v_lo, bf16* m_hi, bf16* m_lo,
    float* s_f, const float* s_a, const float* __restrict__ v, int64_t vrow,
    const float* __restrict__ m, int n0, int Q, bool from_last) {
  const float a_last = s_a[Q - 1];
  for (int s0 = 0; s0 < Q; s0 += kTile) {
    const int ns = min(kTile, Q - s0);
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < kTile) {
      const float a = s_a[s0 + threadIdx.x];
      s_f[threadIdx.x] = static_cast<int>(threadIdx.x) < ns
                             ? expf(from_last ? a_last - a : a)
                             : 0.f;
    }
    __syncthreads();
    stage_split<kP>(v_hi, v_lo, v + s0 * vrow, vrow, ns, s_f);
    stage_split<64>(m_hi, m_lo, m + s0 * N + n0, N, ns, nullptr);
    __syncthreads();
    mm64<true, false>(acc, v_hi, v_lo, m_hi, m_lo);
  }
}

// cb[b, c, q, s] = C[q] . B[s] for s <= q < Q of chunk c = blockIdx.x of
// row b = blockIdx.y in float32 on the CUDA cores, each thread on elements
// in turn: the small heads' (P = N = 16) first launch, forward and
// backward.
template <int N>
__device__ __forceinline__ void cb_small(const float* __restrict__ bm,
                                         const float* __restrict__ cm,
                                         float* __restrict__ cb, int L,
                                         int Q) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x, Qp = padded(Q);
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
    const int q = e / Q, s = e % Q;
    if (s > q) continue;
    const float* cq = cm + (row0 + q) * N;
    const float* bs = bm + (row0 + s) * N;
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n) acc = fmaf(__ldg(cq + n), __ldg(bs + n), acc);
    out[static_cast<int64_t>(q) * Qp + s] = acc;
  }
}

}  // namespace ssd
