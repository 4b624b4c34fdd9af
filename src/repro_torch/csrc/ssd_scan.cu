// B8: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces ssd_scan / _ssd_kernel of the JAX reference
// (src/repro/kernels/ssd_scan/ssd_scan.py), and computes what it computes,
// plus an optional float32 initial state (a null pointer means zeros). For
// x [B, L, H, P] (already scaled by dt), dtA [B, L, H] (dt * A, negative),
// b, c [B, L, N] (one group shared by every head), all float32, with L a
// multiple of the chunk Q, and a_cum the cumulative sum of dtA over a
// chunk, it returns y [B, L, H, P] and the final state [B, H, P, N] of
//   y[q]  = sum_{s <= q} (C[q] . B[s]) exp(a_cum[q] - a_cum[s]) x[s]
//         + (C[q] . state^T) exp(a_cum[q])
//   state = state exp(a_cum[Q-1])
//         + sum_s x[s]^T B[s] exp(a_cum[Q-1] - a_cum[s])
// with the state entering each chunk in the second term of y.
//
// What bounds it: at the mamba2 serving shape (B = 8, L = 1024, H = 80,
// P = 64, N = 128, Q = 256) the scan needs at least about 70 float32
// operations per byte it must move, so arithmetic bounds it on the CUDA
// cores (67 TFLOP/s). This version runs its products on the tensor cores
// in bf16 (989 TFLOP/s), with each float32 operand split into two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi), and each product formed as
// lo.hi + hi.lo + hi.hi (three mma.sync; lo.lo, about 2^-18 of the
// product, is dropped). One bf16 term, or one TF32 term, reads above the
// reference's 3e-4 tolerance, the split plan about 1e-5
// (tests/test_torch_ssd.py, the CPU rehearsal of this plan). Each 16-deep
// k-step of a product is summed in a zeroed fragment and then added in
// float32, since the tensor cores' accumulation truncates. Then the work is
// about 3 x 35 GFLOP of bf16 products and about 0.9 GB moved, scratch
// included, at the mamba2 shape.
//
// Design: four launches per scan, following the chunked form of the plain
// ssd_chunked (kernels/ssd_scan/ref.py), each over many independent
// blocks and none with atomics (two calls give the same bits):
//   1. ssd_cb_kernel, per (row, chunk, 64 x 64 tile on or below the
//      diagonal): C.B^T, once for all heads (b and c are one group), into
//      the scratch cb [B, nc, Qp, Qp] (Qp: Q rounded up to 64; padded rows
//      come from zero-filled tiles and are 0).
//   2. ssd_states_kernel, per (64 columns of N, head, chunk, row): the
//      chunk's own final state sum_s (x[s] w[s])^T B[s], w = exp(a_last -
//      a_cum), into chunk_states [B, nc, H, P, N], and exp(a_last) into
//      decay [B, nc, H].
//   3. ssd_recurrence_kernel, elementwise over [P, N] per (head, row): the
//      short recurrence over chunks, state = state decay + chunk state,
//      writing the state entering each chunk (entering [B, nc, H, P, N])
//      and the final state.
//   4. ssd_output_kernel, per (64-row query tile, head, chunk and row):
//      y = (C_i entering^T) exp(a_cum) + sum_{j <= i} (cb_ij o L_ij) x_j,
//      the scores formed in registers in the A-fragment layout from cb.
//      Off the diagonal tile L = exp(a_q - a_r) exp(a_r - a_s), a_r at the
//      key tile's last row, both factors at most 1; on it exp(a_q - a_s)
//      is evaluated only where s <= q (above the diagonal the exponent is
//      positive and may overflow, and inf * 0 would be NaN).
// Every product stages its float32 operands in shared memory as hi and lo
// bf16 tiles of 64 rows (padded by 8 bf16 so ldmatrix hits distinct banks)
// and runs in 4 warps, warp w on rows 16w..16w+15 of a 64-row output tile.
// The scratch is allocated by the wrapper; the kernels allocate nothing.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;    // 4 warps
constexpr int kTile = 64;        // rows of a staged tile or an output tile
constexpr int kMaxChunk = 1024;  // chunk rows the a_cum buffers hold
constexpr int kP = 64;           // head dim P of every compiled shape
// Blocks an SM the chunk-states and output launches are compiled for (at
// most 128 registers a thread; they spill up to 96 bytes). Their staging
// waits on device memory, and more blocks in flight hide more of it: 4
// ran faster than 1-3 and no slower than 5-6 on an H100.
constexpr int kMinBlocks = 4;

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
  constexpr int kVec = COLS / 4;  // float4 per row
  constexpr int kIter = kTile * kVec / kThreads;
  static_assert(kTile * kVec % kThreads == 0, "tile chunks per thread");
  float4 r[kIter];
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int row = e / kVec, col = (e % kVec) * 4;
    r[i] = row < n_rows ? __ldg(reinterpret_cast<const float4*>(
                              src + row * stride + col))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kIter; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * kThreads;
    const int row = e / kVec, col = (e % kVec) * 4;
    float v[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
    if (scale != nullptr) {
      const float s = scale[row];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] *= s;
    }
    uint32_t h[2], l[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bf16 h0 = __float2bfloat16_rn(v[2 * u]);
      const bf16 h1 = __float2bfloat16_rn(v[2 * u + 1]);
      h[u] = mma::pack_bf16(h0, h1);
      l[u] = mma::pack_bf16(
          __float2bfloat16_rn(v[2 * u] - __bfloat162float(h0)),
          __float2bfloat16_rn(v[2 * u + 1] - __bfloat162float(h1)));
    }
    *reinterpret_cast<uint2*>(hi + row * ld<COLS>() + col) =
        make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(lo + row * ld<COLS>() + col) =
        make_uint2(l[0], l[1]);
  }
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

// 1. cb[b, c, q, s] = C[q] . B[s] for the 64 x 64 tile (i, j), j <= i, of
// chunk c of row b; grid (tiles on or below the diagonal, nc, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int L, int Q) {
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

// 2. chunk_states[b, c, h] = sum_s (x[s] w[s])^T B[s], w[s] = exp(a_last -
// a_cum[s]), and decay[b, c, h] = exp(a_last); grid (N / 64, H, nc B),
// each block 64 columns of N (the blocks of one head's columns run side
// by side and read its x tiles through L2 once).
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_states_kernel(const float* __restrict__ x,
                      const float* __restrict__ dtA,
                      const float* __restrict__ bm,
                      float* __restrict__ states, float* __restrict__ decay,
                      int L, int H, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* x_hi = reinterpret_cast<bf16*>(smem);
  bf16* x_lo = x_hi + kTile * ld<kP>();
  bf16* b_hi = x_lo + kTile * ld<kP>();
  bf16* b_lo = b_hi + kTile * ld<64>();
  float* s_w = reinterpret_cast<float*>(b_lo + kTile * ld<64>());  // [64]
  float* s_a = s_w + kTile;                                        // [Qp]
  const int n0 = blockIdx.x * 64, h = blockIdx.y;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;  // x row stride
  const int warp = threadIdx.x >> 5;

  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, padded(Q));
  __syncthreads();
  const float a_last = s_a[Q - 1];
  if (threadIdx.x == 0 && n0 == 0)
    decay[(static_cast<int64_t>(b) * nc + c) * H + h] = expf(a_last);

  float acc[8][4] = {};
  for (int s0 = 0; s0 < Q; s0 += kTile) {
    const int ns = min(kTile, Q - s0);
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < kTile)
      s_w[threadIdx.x] = static_cast<int>(threadIdx.x) < ns
                             ? expf(a_last - s_a[s0 + threadIdx.x])
                             : 0.f;
    __syncthreads();
    stage_split<kP>(x_hi, x_lo, x + (row0 + s0) * xrow + h * kP, xrow, ns,
                    s_w);
    stage_split<64>(b_hi, b_lo, bm + (row0 + s0) * N + n0, N, ns, nullptr);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t ah[4], al[4];  // (x w)^T [p][s]: x stored [s][p]
      load_a_km(ah, x_hi, ld<kP>(), warp * 16, kc * 16);
      load_a_km(al, x_lo, ld<kP>(), warp * 16, kc * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bh[4], bl[4];
        mma::load_b_kn(bh, b_hi, ld<64>(), kc * 16, np * 16);
        mma::load_b_kn(bl, b_lo, ld<64>(), kc * 16, np * 16);
        mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
  float* out = states + ((static_cast<int64_t>(b) * nc + c) * H + h) * kP * N;
  store_frags<8>(out, N, warp * 16, n0, kP, acc);
}

// 3. The recurrence over chunks, 4 elements of [P, N] a thread: entering[b,
// c, h] = state; state = state decay[b, c, h] + chunk_states[b, c, h],
// from the initial state (zeros without one) to the final state; grid
// (P N / 4 / 128, H, B).
__global__ void __launch_bounds__(kThreads)
    ssd_recurrence_kernel(const float* __restrict__ states,
                          const float* __restrict__ decay,
                          const float* __restrict__ init,
                          float* __restrict__ entering,
                          float* __restrict__ state_out, int nc, int H,
                          int PN) {
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (init != nullptr)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] = init[bh * PN + e + u];
  for (int c = 0; c < nc; ++c) {
    const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
    const float d = decay[bch];
    const float4 st =
        __ldg(reinterpret_cast<const float4*>(states + bch * PN + e));
    *reinterpret_cast<float4*>(entering + bch * PN + e) =
        make_float4(s[0], s[1], s[2], s[3]);
    s[0] = __fadd_rn(__fmul_rn(s[0], d), st.x);
    s[1] = __fadd_rn(__fmul_rn(s[1], d), st.y);
    s[2] = __fadd_rn(__fmul_rn(s[2], d), st.z);
    s[3] = __fadd_rn(__fmul_rn(s[3], d), st.w);
  }
  *reinterpret_cast<float4*>(state_out + bh * PN + e) =
      make_float4(s[0], s[1], s[2], s[3]);
}

// 4. y for the 64-row query tile i of chunk c, head h, row b; grid (tiles,
// H, nc B), the widest tile row (the most key tiles) first. The
// inter-chunk term goes first, scaled into the accumulator, and the
// intra-chunk tiles add to it. Off the diagonal (j < i) a score's
// exp(a_q - a_s) is formed as exp(a_q - a_r) exp(a_r - a_s) with a_r =
// a_cum at the key tile's last row, both factors at most 1 (a_cum falls),
// so 2 exponentials a row and one a key column replace one an element; on
// the diagonal each visible element takes its own.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_output_kernel(const float* __restrict__ x,
                      const float* __restrict__ dtA,
                      const float* __restrict__ cm,
                      const float* __restrict__ cb,
                      const float* __restrict__ entering,
                      float* __restrict__ y, int L, int H, int Q, int nc,
                      int has_init) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the C and entering-state tiles of the inter-chunk term, 64 columns of
  // N at a time, then (in the same bytes) the x tiles of the intra-chunk
  // term
  bf16* c_hi = reinterpret_cast<bf16*>(smem);
  bf16* c_lo = c_hi + kTile * ld<64>();
  bf16* e_hi = c_lo + kTile * ld<64>();
  bf16* e_lo = e_hi + kTile * ld<64>();
  bf16* x_hi = c_hi;
  bf16* x_lo = x_hi + kTile * ld<kP>();
  float* s_e = reinterpret_cast<float*>(e_lo + kTile * ld<64>());  // [64]
  float* s_a = s_e + kTile;                                        // [Qp]
  const int i = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int Qp = padded(Q), q0 = i * kTile;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, Qp);
  __syncthreads();
  const int qa = q0 + warp * 16 + g, qb = qa + 8;  // this thread's rows
  const float aqa = s_a[qa], aqb = s_a[qb];

  // (C_i . entering^T) exp(a_cum), with the state entering the chunk
  // (none: zeros)
  float acc[8][4] = {};
  if (c > 0 || has_init) {
    const float* ent =
        entering + ((static_cast<int64_t>(b) * nc + c) * H + h) * kP * N;
    for (int n0 = 0; n0 < N; n0 += 64) {
      if (n0 > 0) __syncthreads();  // the readers of these bytes are done
      stage_split<64>(c_hi, c_lo, cm + (row0 + q0) * N + n0, N,
                      min(kTile, Q - q0), nullptr);
      stage_split<64>(e_hi, e_lo, ent + n0, N, kP, nullptr);
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ah[4], al[4];
        mma::load_a(ah, c_hi, ld<64>(), warp * 16, kc * 16);
        mma::load_a(al, c_lo, ld<64>(), warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < kP / 16; ++np) {  // entering^T: stored [p][n]
          uint32_t bh[4], bl[4];
          mma::load_b_nk(bh, e_hi, ld<64>(), np * 16, kc * 16);
          mma::load_b_nk(bl, e_lo, ld<64>(), np * 16, kc * 16);
          mma3(acc[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(acc[2 * np + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    const float ea = expf(aqa), eb = expf(aqb);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= ea;
      acc[nt][1] *= ea;
      acc[nt][2] *= eb;
      acc[nt][3] *= eb;
    }
  }

  // + sum_{j <= i} (cb_ij o L_ij) x_j
  const float* cba = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp +
                     static_cast<int64_t>(qa) * Qp;
  const float* cbb = cba + 8 * static_cast<int64_t>(Qp);
  for (int j = 0; j <= i; ++j) {
    const int s0 = j * kTile;
    const bool diag = j == i;
    const float a_r = s_a[s0 + kTile - 1];
    __syncthreads();  // the previous readers of these bytes are done
    if (threadIdx.x < kTile)
      s_e[threadIdx.x] = expf(a_r - s_a[s0 + threadIdx.x]);
    stage_split<kP>(x_hi, x_lo, x + (row0 + s0) * xrow + h * kP, xrow,
                    min(kTile, Q - s0), nullptr);
    const float fa = diag ? 0.f : expf(aqa - a_r);
    const float fb = diag ? 0.f : expf(aqb - a_r);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      // scores at rows qa, qb and columns s, s + 1, s + 8, s + 9 in the A
      // fragment layout (c0: columns 0..7 of the k-step, c1: 8..15)
      const int s = s0 + kc * 16 + 2 * t;
      const float2 va0 = __ldg(reinterpret_cast<const float2*>(cba + s));
      const float2 va1 = __ldg(reinterpret_cast<const float2*>(cba + s + 8));
      const float2 vb0 = __ldg(reinterpret_cast<const float2*>(cbb + s));
      const float2 vb1 = __ldg(reinterpret_cast<const float2*>(cbb + s + 8));
      float c0[4], c1[4];
      if (!diag) {
        const float* e = s_e + kc * 16 + 2 * t;
        c0[0] = va0.x * e[0] * fa;
        c0[1] = va0.y * e[1] * fa;
        c0[2] = vb0.x * e[0] * fb;
        c0[3] = vb0.y * e[1] * fb;
        c1[0] = va1.x * e[8] * fa;
        c1[1] = va1.y * e[9] * fa;
        c1[2] = vb1.x * e[8] * fb;
        c1[3] = vb1.y * e[9] * fb;
      } else {
        const float sa0 = s_a[s], sa1 = s_a[s + 1], sa8 = s_a[s + 8],
                    sa9 = s_a[s + 9];
        c0[0] = s <= qa ? va0.x * expf(aqa - sa0) : 0.f;
        c0[1] = s + 1 <= qa ? va0.y * expf(aqa - sa1) : 0.f;
        c0[2] = s <= qb ? vb0.x * expf(aqb - sa0) : 0.f;
        c0[3] = s + 1 <= qb ? vb0.y * expf(aqb - sa1) : 0.f;
        c1[0] = s + 8 <= qa ? va1.x * expf(aqa - sa8) : 0.f;
        c1[1] = s + 9 <= qa ? va1.y * expf(aqa - sa9) : 0.f;
        c1[2] = s + 8 <= qb ? vb1.x * expf(aqb - sa8) : 0.f;
        c1[3] = s + 9 <= qb ? vb1.y * expf(aqb - sa9) : 0.f;
      }
      uint32_t a[2][4];
      mma::split_a<2>(c0, c1, a);
#pragma unroll
      for (int np = 0; np < kP / 16; ++np) {  // x [s][p]
        uint32_t bh[4], bl[4];
        mma::load_b_kn(bh, x_hi, ld<kP>(), kc * 16, np * 16);
        mma::load_b_kn(bl, x_lo, ld<kP>(), kc * 16, np * 16);
        mma3(acc[2 * np], a[0], a[1], bh[0], bh[1], bl[0], bl[1]);
        mma3(acc[2 * np + 1], a[0], a[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }
  }
  store_frags<8>(y + row0 * xrow + h * kP, xrow, q0 + warp * 16, 0, Q, acc);
}

template <int N>
int launch(const float* x, const float* dtA, const float* bm, const float* cm,
           const float* init, float* y, float* state, float* cb,
           float* states, float* entering, float* decay, int B, int L, int H,
           int Q, cudaStream_t stream) {
  const int nc = L / Q, n_sub = padded(Q) / kTile, Qp = padded(Q);
  if (static_cast<int64_t>(nc) * B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t cb_bytes = 2 * pair_bytes<N>();
  cudaError_t err = attn::allow_shared_bytes(ssd_cb_kernel<N>, cb_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<N><<<dim3(n_sub * (n_sub + 1) / 2, nc, B), kThreads,
                     cb_bytes, stream>>>(bm, cm, cb, L, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t st_bytes =
      pair_bytes<kP>() + pair_bytes<64>() + sizeof(float) * (kTile + Qp);
  err = attn::allow_shared_bytes(ssd_states_kernel<N>, st_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_states_kernel<N><<<dim3(N / 64, H, nc * B), kThreads, st_bytes,
                         stream>>>(x, dtA, bm, states, decay, L, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int PN = kP * N;
  ssd_recurrence_kernel<<<dim3((PN / 4 + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(states, decay, init,
                                                 entering, state, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t out_bytes =
      2 * pair_bytes<64>() + sizeof(float) * (kTile + Qp);
  err = attn::allow_shared_bytes(ssd_output_kernel<N>, out_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<N><<<dim3(n_sub, H, nc * B), kThreads, out_bytes,
                         stream>>>(x, dtA, cm, cb, entering, y, L, H, Q, nc,
                                   init != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (P, N) pairs compiled: zamba2's (64, 64) and mamba2's (64, 128). Keep in
// step with SHAPES in kernels/ssd_scan/ops.py. The scratch (cb [B, nc, Qp,
// Qp], chunk_states and entering [B, nc, H, P, N], decay [B, nc, H], all
// float32, nc = L / chunk, Qp = chunk rounded up to 64) comes from the
// caller.
extern "C" int ssd_scan_launch(const void* x, const void* dtA, const void* b,
                               const void* c, const void* init, void* y,
                               void* state, void* cb, void* chunk_states,
                               void* entering, void* decay, int B, int L,
                               int H, int P, int N, int chunk, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0 || P != kP)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (N == 64)
    return launch<64>(f(x), f(dtA), f(b), f(c), f(init), w(y), w(state),
                      w(cb), w(chunk_states), w(entering), w(decay), B, L, H,
                      chunk, s);
  if (N == 128)
    return launch<128>(f(x), f(dtA), f(b), f(c), f(init), w(y), w(state),
                       w(cb), w(chunk_states), w(entering), w(decay), B, L,
                       H, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
