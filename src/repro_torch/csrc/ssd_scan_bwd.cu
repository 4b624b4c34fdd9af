// The backward of the Mamba2 SSD chunked scan (B8), hand-written for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX reference differentiates its jnp
// ssd_chunked (src/repro/models/layers.py) under jax.checkpoint, and never
// its Pallas scan. The port's training path runs B8's forward on the card,
// so its gradient is a kernel too: the gradient of the same function, the
// plain version of which is ssd_chunked_bwd (kernels/ssd_scan/ref.py). For
// x [B, L, H, P], dtA [B, L, H], b, c [B, L, N], the upstream dy [B, L, H,
// P] and dfinal [B, H, P, N] (null: zeros), the forward's entering states
// [B, nc, H, P, N] and chunk decay [B, nc, H], with a the cumulative sum of
// dtA within a chunk, L[q, s] = exp(a_q - a_s) (s <= q), w[s] = exp(a_last -
// a_s) and S_c the state entering chunk c, it writes
//   dS_nc = dfinal, dS_c = sum_q exp(a_q) dy[q]^T C[q] + decay_c dS_{c+1}
//   dinit = dS_0
//   dx[s] = sum_{q >= s} (C_q . B_s) L_qs dy[q] + w[s] dS_{c+1} B[s]
//   dCB_h = L o (dy_h x_h^T), dCB = sum_h dCB_h
//   dc[q] = sum_s dCB[q, s] B[s] + sum_h exp(a_q) dy_h[q] S_c,h
//   db[s] = sum_q dCB[q, s] C[q] + sum_h w[s] x_h[s]^T dS_{c+1},h
//   da    = rowsum - colsum of (C B^T) o dCB_h + sum_p dy y_off - w dw
//           (+ sum_s w dw + decay_c sum S_c o dS_{c+1} at the last row)
//   ddtA  = the reverse cumulative sum of da within the chunk.
//
// What bounds it: at the mamba2 training shape (B = 8, L = 1024, H = 80,
// P = 64, N = 128, Q = 256) it needs about 33 G multiply-adds against
// 0.63 GB it must move, about 100 operations a byte, so arithmetic bounds
// it (0.97 ms at the float32 peak; chip_smoke.py's _ssd_bwd_work). This
// first version runs them in float32 on the CUDA cores (67 TFLOP/s): each
// product is a 64-row tile in shared memory (rows padded to an odd width,
// so a column read hits 32 banks), 128 threads a block, each thread 8 rows
// x up to 8 columns of the output in registers. The tensor-core plan of
// the forward (bf16 hi/lo terms) is left for a later version.
//
// Design: six launches, each over many independent blocks and none with
// atomics; the sums over heads that db and dc need are taken in a fixed
// order from per-head scratch, so two calls give the same bits:
//   1. ssd_bwd_cb_kernel, per (row, chunk, 64 x 64 tile on or below the
//      diagonal): C.B^T into cb [B, nc, Q, Q].
//   2. ssd_bwd_dstate_kernel, per (64 columns of N, head, chunk and row):
//      sum_q exp(a_q) dy[q]^T C[q] into dchunk [B, nc, H, P, N].
//   3. ssd_bwd_recurrence_kernel, elementwise over [P, N] per (head, row):
//      the reverse recurrence, turning dchunk[c] into dS_{c+1} in place
//      and writing dinit.
//   4. ssd_bwd_chunk_kernel, per (head, chunk and row), the chunk whole:
//      the state terms of dx (written), of db and dc per head (into part_b,
//      part_c [B, L, H, N]); then over the tile pairs (s <= q) dCB_h (into
//      part_cb [B, nc, H, Q, Q]) and the intra-chunk dx (added); da in
//      shared memory throughout, and ddtA from it.
//   5. ssd_bwd_dc_kernel, per (64-row tile, chunk and row): dCB summed over
//      heads (into dcb [B, nc, Q, Q]), dc = dCB B + sum_h part_c.
//   6. ssd_bwd_db_kernel, per (64-row tile, chunk and row): db = dCB^T C +
//      sum_h part_b.
// exp(a_q - a_s) is evaluated only where s <= q: above the diagonal the
// exponent is positive and may overflow, and inf * 0 is NaN.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing (the scratch
// comes from the caller) and returns cudaGetLastError() (0 on success).

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps; thread (ty, tx) = (t / 16, t % 16)
constexpr int kT = 64;           // rows of a position tile
constexpr int kLd = kT + 1;      // floats per shared row of a 64-wide tile
constexpr int kMaxChunk = 1024;  // chunk rows the a and da buffers hold

__host__ __device__ constexpr int ld(int w) { return w + 1; }

__host__ __device__ inline int n_tiles(int q) { return (q + kT - 1) / kT; }

// acc[i][j] += sum_{k < K} A(ty + 8 i, k) B(k, tx + 16 j) with A(m, k) =
// a[m am + k ak] and B(k, n) = b[k bk + n bn], both in shared memory.
template <int RI, int CJ>
__device__ __forceinline__ void mm(float (&acc)[RI][CJ], const float* a,
                                   int am, int ak, const float* b, int bk,
                                   int bn, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k = 0; k < K; ++k) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a[(ty + 8 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b[k * bk + (tx + 16 * j) * bn];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int RI, int CJ>
__device__ __forceinline__ void zero(float (&acc)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

// Rows [0, rows) x columns [0, W) of a float32 block (row r at src + r *
// stride) into shared memory, ld(W) floats a row; rows n_rows.. are zero.
// Row r is multiplied by scale[r] where a scale (in shared memory) is
// given.
template <int W>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int64_t stride, int rows, int n_rows,
                                      const float* scale) {
  for (int e = threadIdx.x; e < rows * W; e += kThreads) {
    const int r = e / W, col = e % W;
    float v = 0.f;
    if (r < n_rows) {
      v = __ldg(src + r * stride + col);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld(W) + col] = v;
  }
}

// The sum of v over the 16 threads of a half-warp (one output row).
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

// Inclusive cumulative sum of dtA over rows [0, Q) of a chunk (row t at
// dtA[t * H]) into a. The caller syncs.
__device__ __forceinline__ void chunk_cumsum(float* a,
                                             const float* __restrict__ dtA,
                                             int H, int Q) {
  for (int t = threadIdx.x; t < Q; t += kThreads)
    a[t] = __ldg(dtA + static_cast<int64_t>(t) * H);
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int t = base + lane;
    float v = t < Q ? a[t] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (t < Q) a[t] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// 1. cb[b, c, q, s] = C[q] . B[s] for the 64 x 64 tile (qt, st), st <= qt;
// grid (tiles, tiles, nc B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cb_kernel(const float* __restrict__ bm,
                      const float* __restrict__ cm, float* __restrict__ cb,
                      int L, int Q, int nc) {
  const int st = blockIdx.x, qt = blockIdx.y;
  if (st > qt) return;
  extern __shared__ float smem[];
  float* s_c = smem;                 // [64][N + 1]
  float* s_b = s_c + kT * ld(N);     // [64][N + 1]
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int q0 = qt * kT, s0 = st * kT;
  stage<N>(s_c, cm + (row0 + q0) * N, N, kT, min(kT, Q - q0), nullptr);
  stage<N>(s_b, bm + (row0 + s0) * N, N, kT, min(kT, Q - s0), nullptr);
  __syncthreads();
  float acc[8][4];
  zero(acc);
  mm(acc, s_c, ld(N), 1, s_b, 1, ld(N), N);  // B^T(n, s) = s_b[s][n]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = cb + (static_cast<int64_t>(b) * nc + c) * Q * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + ty + 8 * i, s = s0 + tx + 16 * j;
      if (q < Q && s < Q) out[static_cast<int64_t>(q) * Q + s] = acc[i][j];
    }
}

// 2. dchunk[b, c, h][p, n] = sum_q exp(a_q) dy[q, p] C[q, n] for 64 (or N)
// columns of N; grid (N / NW, H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                          const float* __restrict__ dtA,
                          const float* __restrict__ cm,
                          float* __restrict__ dchunk, int L, int H, int Q,
                          int nc) {
  constexpr int NW = N < 64 ? N : 64;
  extern __shared__ float smem[];
  float* s_a = smem;                  // [Q]
  float* s_e = s_a + kMaxChunk;       // [64]: exp(a_q) of the tile
  float* s_dy = s_e + kT;             // [64][P + 1]
  float* s_c = s_dy + kT * ld(P);     // [64][NW + 1]
  const int n0 = blockIdx.x * NW, h = blockIdx.y;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q);
  __syncthreads();
  float acc[P / 8][NW / 16];
  zero(acc);
  for (int q0 = 0; q0 < Q; q0 += kT) {
    const int nq = min(kT, Q - q0);
    __syncthreads();  // the previous tile's readers are done
    if (threadIdx.x < kT)
      s_e[threadIdx.x] = static_cast<int>(threadIdx.x) < nq
                             ? expf(s_a[q0 + threadIdx.x]) : 0.f;
    __syncthreads();
    stage<P>(s_dy, dy + (row0 + q0) * xrow + h * P, xrow, kT, nq, s_e);
    stage<NW>(s_c, cm + (row0 + q0) * N + n0, N, kT, nq, nullptr);
    __syncthreads();
    // rows p of dy^T: A(p, q) = s_dy[q][p]
    mm(acc, s_dy, 1, ld(P), s_c, ld(NW), 1, kT);
  }
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = dchunk + ((static_cast<int64_t>(b) * nc + c) * H + h) * P * N;
#pragma unroll
  for (int i = 0; i < P / 8; ++i)
#pragma unroll
    for (int j = 0; j < NW / 16; ++j)
      out[(ty + 8 * i) * N + n0 + tx + 16 * j] = acc[i][j];
}

// 3. The reverse recurrence over chunks, one element of [P, N] a thread:
// running = dfinal (0 without one); for c = nc - 1 .. 0: g = dchunk[c];
// dchunk[c] = running; running = g + decay[c] running; dinit = running;
// grid (P N / 128, H, B).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_recurrence_kernel(float* __restrict__ dchunk,
                              const float* __restrict__ decay,
                              const float* __restrict__ dfinal,
                              float* __restrict__ dinit, int nc, int H,
                              int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float run = dfinal != nullptr ? dfinal[bh * PN + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
    const float g = dchunk[bch * PN + e];
    dchunk[bch * PN + e] = run;
    run = fmaf(decay[bch], run, g);
  }
  dinit[bh * PN + e] = run;
}

// Shared floats of ssd_bwd_chunk_kernel<P, N>: a, da, the per-tile row
// and column sums and the reduction buffer, then the larger of the state
// phases' tiles and the diagonal phase's.
template <int P, int N>
constexpr int chunk_smem_floats() {
  constexpr int state = P * ld(N) + kT * ld(P) + kT * ld(N);
  constexpr int diag = 2 * kT * ld(P) + 3 * kT * kLd;
  return 2 * kMaxChunk + 3 * kT + kThreads + (state > diag ? state : diag);
}

// 4. One (head, chunk, row), the chunk whole; grid (H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk_kernel(const float* __restrict__ x,
                         const float* __restrict__ dtA,
                         const float* __restrict__ bm,
                         const float* __restrict__ cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ entering,
                         const float* __restrict__ decay,
                         const float* __restrict__ dchunk,
                         const float* __restrict__ cb,
                         float* __restrict__ dx, float* __restrict__ ddtA,
                         float* __restrict__ part_b,
                         float* __restrict__ part_c,
                         float* __restrict__ part_cb, int L, int H, int Q,
                         int nc) {
  extern __shared__ float smem[];
  float* s_a = smem;                  // [kMaxChunk] a
  float* s_da = s_a + kMaxChunk;      // [kMaxChunk] da
  float* s_row = s_da + kMaxChunk;    // [64]
  float* s_col = s_row + kT;          // [64]
  float* s_v = s_col + kT;            // [64] a per-row factor of a tile
  float* s_red = s_v + kT;            // [128]
  float* reg = s_red + kThreads;      // the phases' tiles
  const int h = blockIdx.x;
  const int c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int nt = n_tiles(Q);

  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q);
  for (int t = threadIdx.x; t < Q; t += kThreads) s_da[t] = 0.f;
  __syncthreads();
  const float a_last = s_a[Q - 1];

  // --- A. the terms of dS_{c+1} (dSt): dx's state term (written), part_b,
  // and -w dw into da; then decay_c sum S_c o dSt.
  float* s_ds = reg;                       // [P][N + 1]
  float* s_x = s_ds + P * ld(N);           // [64][P + 1]
  float* s_b = s_x + kT * ld(P);           // [64][N + 1]
  stage<N>(s_ds, dchunk + bch * P * N, N, P, P, nullptr);
  float sum_wdw = 0.f;                     // thread 0's
  for (int s0 = 0; s0 < Q; s0 += kT) {
    const int ns = min(kT, Q - s0);
    __syncthreads();
    if (threadIdx.x < kT)
      s_v[threadIdx.x] = static_cast<int>(threadIdx.x) < ns
                             ? expf(a_last - s_a[s0 + threadIdx.x]) : 0.f;
    stage<P>(s_x, x + (row0 + s0) * xrow + h * P, xrow, kT, ns, nullptr);
    stage<N>(s_b, bm + (row0 + s0) * N, N, kT, ns, nullptr);
    __syncthreads();
    {  // dx[s, p] = w[s] sum_n B[s, n] dSt[p, n]
      float acc[8][P / 16];
      zero(acc);
      mm(acc, s_b, ld(N), 1, s_ds, 1, ld(N), N);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 8 * i;
        if (s < ns)
#pragma unroll
          for (int j = 0; j < P / 16; ++j)
            dx[(row0 + s0 + s) * xrow + h * P + tx + 16 * j] =
                s_v[s] * acc[i][j];
      }
    }
    {  // raw[s, n] = sum_p x[s, p] dSt[p, n]; part_b = w raw; dw = B . raw
      float acc[8][N / 16];
      zero(acc);
      mm(acc, s_x, ld(P), 1, s_ds, ld(N), 1, P);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 8 * i;
        float dw = 0.f;
#pragma unroll
        for (int j = 0; j < N / 16; ++j)
          dw = fmaf(s_b[s * ld(N) + tx + 16 * j], acc[i][j], dw);
        dw = row_sum16(dw);
        if (s < ns) {
#pragma unroll
          for (int j = 0; j < N / 16; ++j)
            part_b[((row0 + s0 + s) * H + h) * N + tx + 16 * j] =
                s_v[s] * acc[i][j];
          if (tx == 0) s_row[s] = s_v[s] * dw;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < ns) s_da[s0 + threadIdx.x] -= s_row[threadIdx.x];
    if (threadIdx.x == 0)
      for (int s = 0; s < ns; ++s) sum_wdw += s_row[s];
  }
  {  // ddecay = sum S_c o dSt, reduced in a fixed order
    const float* ent = entering + bch * P * N;
    float v = 0.f;
    for (int e = threadIdx.x; e < P * N; e += kThreads)
      v = fmaf(__ldg(ent + e), s_ds[(e / N) * ld(N) + e % N], v);
    s_red[threadIdx.x] = v;
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if (static_cast<int>(threadIdx.x) < o)
        s_red[threadIdx.x] += s_red[threadIdx.x + o];
      __syncthreads();
    }
  }
  const float ddecay = s_red[0];
  __syncthreads();

  // --- B. the terms of S_c: part_c = exp(a_q) dy[q] S_c, and sum_p dy
  // y_off = C . part_c into da.
  float* s_sin = reg;                      // [P][N + 1]
  float* s_dy = s_sin + P * ld(N);         // [64][P + 1]
  float* s_c = s_dy + kT * ld(P);          // [64][N + 1]
  stage<N>(s_sin, entering + bch * P * N, N, P, P, nullptr);
  for (int q0 = 0; q0 < Q; q0 += kT) {
    const int nq = min(kT, Q - q0);
    __syncthreads();
    if (threadIdx.x < kT)
      s_v[threadIdx.x] = static_cast<int>(threadIdx.x) < nq
                             ? expf(s_a[q0 + threadIdx.x]) : 0.f;
    stage<P>(s_dy, dy + (row0 + q0) * xrow + h * P, xrow, kT, nq, nullptr);
    stage<N>(s_c, cm + (row0 + q0) * N, N, kT, nq, nullptr);
    __syncthreads();
    float acc[8][N / 16];
    zero(acc);
    mm(acc, s_dy, ld(P), 1, s_sin, ld(N), 1, P);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = ty + 8 * i;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        acc[i][j] *= s_v[q];
        v = fmaf(s_c[q * ld(N) + tx + 16 * j], acc[i][j], v);
      }
      v = row_sum16(v);
      if (q < nq) {
#pragma unroll
        for (int j = 0; j < N / 16; ++j)
          part_c[((row0 + q0 + q) * H + h) * N + tx + 16 * j] = acc[i][j];
        if (tx == 0) s_row[q] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < nq) s_da[q0 + threadIdx.x] += s_row[threadIdx.x];
  }

  // --- C. the tile pairs (st <= qt): dCB_h = L o (dy x^T) into part_cb,
  // T = cb o dCB_h's row sums into da[q] and column sums out of da[s], and
  // dx[s] += sum_q (cb o L)[q, s] dy[q].
  float* s_xs = reg;                       // [64][P + 1]: x of the s tile
  float* s_dq = s_xs + kT * ld(P);         // [64][P + 1]: dy of the q tile
  float* s_l = s_dq + kT * ld(P);          // [64][65]: L
  float* s_cb = s_l + kT * kLd;            // [64][65]: cb, then cb o L
  float* s_t = s_cb + kT * kLd;            // [64][65]: T
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Q * Q;
  float* pcb = part_cb + bch * Q * Q;
  for (int st = 0; st < nt; ++st) {
    const int s0 = st * kT, ns = min(kT, Q - s0);
    __syncthreads();
    stage<P>(s_xs, x + (row0 + s0) * xrow + h * P, xrow, kT, ns, nullptr);
    float acc_dx[8][P / 16];
    zero(acc_dx);
    for (int qt = st; qt < nt; ++qt) {
      const int q0 = qt * kT, nq = min(kT, Q - q0);
      __syncthreads();
      stage<P>(s_dq, dy + (row0 + q0) * xrow + h * P, xrow, kT, nq, nullptr);
      for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, col = e % kT;
        const int q = q0 + r, s = s0 + col;
        const bool vis = r < nq && col < ns && s <= q;
        s_l[r * kLd + col] = vis ? expf(s_a[q] - s_a[s]) : 0.f;
        s_cb[r * kLd + col] = vis ? cbc[static_cast<int64_t>(q) * Q + s] : 0.f;
      }
      __syncthreads();
      {  // M[q, s] = sum_p dy[q, p] x[s, p]
        float acc[8][4];
        zero(acc);
        mm(acc, s_dq, ld(P), 1, s_xs, 1, ld(P), P);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = ty + 8 * i, col = tx + 16 * j;
            const float d = s_l[r * kLd + col] * acc[i][j];
            s_t[r * kLd + col] = s_cb[r * kLd + col] * d;
            if (r < nq && col < ns)
              pcb[static_cast<int64_t>(q0 + r) * Q + s0 + col] = d;
          }
      }
      __syncthreads();
      {  // the row and column sums of T; cb o L in place of cb
        const int r = threadIdx.x & (kT - 1);
        float v = 0.f;
        if (threadIdx.x < kT) {
          for (int k = 0; k < kT; ++k) v += s_t[r * kLd + k];
          s_row[r] = v;
        } else {
          for (int k = 0; k < kT; ++k) v += s_t[k * kLd + r];
          s_col[r] = v;
        }
        for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
          const int rr = e / kT, col = e % kT;
          s_cb[rr * kLd + col] *= s_l[rr * kLd + col];
        }
      }
      __syncthreads();
      if (threadIdx.x < nq) s_da[q0 + threadIdx.x] += s_row[threadIdx.x];
      __syncthreads();
      if (threadIdx.x < ns) s_da[s0 + threadIdx.x] -= s_col[threadIdx.x];
      // dx[s, p] += sum_q S[q, s] dy[q, p]: A(s, q) = s_cb[q][s]
      mm(acc_dx, s_cb, 1, kLd, s_dq, ld(P), 1, kT);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 8 * i;
      if (s < ns)
#pragma unroll
        for (int j = 0; j < P / 16; ++j)
          dx[(row0 + s0 + s) * xrow + h * P + tx + 16 * j] += acc_dx[i][j];
    }
  }

  // --- D. the last row's terms, then ddtA = the reverse cumulative sum of
  // da within the chunk (warp 0, 32 rows at a time from the end).
  __syncthreads();
  if (threadIdx.x == 0) s_da[Q - 1] += sum_wdw + ddecay * decay[bch];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.f;
    for (int top = Q - 1; top >= 0; top -= 32) {
      const int t = top - lane;
      float v = t >= 0 ? s_da[t] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      if (t >= 0) ddtA[(row0 + t) * H + h] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// 5. For the 64-row tile qt of chunk c, row b: dCB = sum_h part_cb (heads
// in order) into dcb, and dc = dCB B + sum_h part_c; grid (tiles, nc B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dc_kernel(const float* __restrict__ bm,
                      const float* __restrict__ part_cb,
                      const float* __restrict__ part_c,
                      float* __restrict__ dcb, float* __restrict__ dc, int L,
                      int H, int Q, int nc) {
  extern __shared__ float smem[];
  float* s_d = smem;                 // [64][65]
  float* s_b = s_d + kT * kLd;       // [64][N + 1]
  const int qt = blockIdx.x;
  const int c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int q0 = qt * kT, nq = min(kT, Q - q0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][N / 16];
  zero(acc);
  for (int st = 0; st <= qt; ++st) {
    const int s0 = st * kT, ns = min(kT, Q - s0);
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, col = e % kT;
      const int q = q0 + r, s = s0 + col;
      float v = 0.f;
      if (r < nq && col < ns && s <= q) {
        const float* p = part_cb + bc * H * Q * Q +
                         static_cast<int64_t>(q) * Q + s;
        for (int h = 0; h < H; ++h)
          v += __ldg(p + static_cast<int64_t>(h) * Q * Q);
        dcb[bc * Q * Q + static_cast<int64_t>(q) * Q + s] = v;
      }
      s_d[r * kLd + col] = v;
    }
    stage<N>(s_b, bm + (row0 + s0) * N, N, kT, ns, nullptr);
    __syncthreads();
    mm(acc, s_d, kLd, 1, s_b, ld(N), 1, kT);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = ty + 8 * i;
    if (q >= nq) continue;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int n = tx + 16 * j;
      float v = acc[i][j];
      const float* p = part_c + (row0 + q0 + q) * H * N + n;
      for (int h = 0; h < H; ++h) v += __ldg(p + static_cast<int64_t>(h) * N);
      dc[(row0 + q0 + q) * N + n] = v;
    }
  }
}

// 6. For the 64-row tile st of chunk c, row b: db = dCB^T C + sum_h part_b;
// grid (tiles, nc B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_db_kernel(const float* __restrict__ cm,
                      const float* __restrict__ dcb,
                      const float* __restrict__ part_b,
                      float* __restrict__ db, int L, int H, int Q, int nc) {
  extern __shared__ float smem[];
  float* s_d = smem;                 // [64][65]
  float* s_c = s_d + kT * kLd;       // [64][N + 1]
  const int st = blockIdx.x, nt = n_tiles(Q);
  const int c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int s0 = st * kT, ns = min(kT, Q - s0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][N / 16];
  zero(acc);
  for (int qt = st; qt < nt; ++qt) {
    const int q0 = qt * kT, nq = min(kT, Q - q0);
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, col = e % kT;
      const int q = q0 + r, s = s0 + col;
      s_d[r * kLd + col] = r < nq && col < ns && s <= q
          ? dcb[bc * Q * Q + static_cast<int64_t>(q) * Q + s] : 0.f;
    }
    stage<N>(s_c, cm + (row0 + q0) * N, N, kT, nq, nullptr);
    __syncthreads();
    mm(acc, s_d, 1, kLd, s_c, ld(N), 1, kT);  // A(s, q) = s_d[q][s]
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = ty + 8 * i;
    if (s >= ns) continue;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int n = tx + 16 * j;
      float v = acc[i][j];
      const float* p = part_b + (row0 + s0 + s) * H * N + n;
      for (int h = 0; h < H; ++h) v += __ldg(p + static_cast<int64_t>(h) * N);
      db[(row0 + s0 + s) * N + n] = v;
    }
  }
}

template <int P, int N>
int launch(const float* x, const float* dtA, const float* bm, const float* cm,
           const float* dy, const float* dfinal, const float* entering,
           const float* decay, float* dx, float* ddtA, float* db, float* dc,
           float* dinit, float* cb, float* dchunk, float* part_cb,
           float* part_b, float* part_c, float* dcb, int B, int L, int H,
           int Q, cudaStream_t stream) {
  const int nc = L / Q, nt = n_tiles(Q);
  if (static_cast<int64_t>(nc) * B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int NW = N < 64 ? N : 64;
  cudaError_t err;

  const size_t cb_bytes = sizeof(float) * 2 * kT * ld(N);
  if ((err = attn::allow_shared_bytes(ssd_bwd_cb_kernel<N>, cb_bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_cb_kernel<N><<<dim3(nt, nt, nc * B), kThreads, cb_bytes, stream>>>(
      bm, cm, cb, L, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t ds_bytes =
      sizeof(float) * (kMaxChunk + kT + kT * ld(P) + kT * ld(NW));
  if ((err = attn::allow_shared_bytes(ssd_bwd_dstate_kernel<P, N>,
                                      ds_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dstate_kernel<P, N><<<dim3(N / NW, H, nc * B), kThreads, ds_bytes,
                                stream>>>(dy, dtA, cm, dchunk, L, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int PN = P * N;
  ssd_bwd_recurrence_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, B),
                              kThreads, 0, stream>>>(dchunk, decay, dfinal,
                                                     dinit, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t ch_bytes = sizeof(float) * chunk_smem_floats<P, N>();
  if ((err = attn::allow_shared_bytes(ssd_bwd_chunk_kernel<P, N>,
                                      ch_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_chunk_kernel<P, N><<<dim3(H, nc * B), kThreads, ch_bytes,
                               stream>>>(
      x, dtA, bm, cm, dy, entering, decay, dchunk, cb, dx, ddtA, part_b,
      part_c, part_cb, L, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t dbc_bytes = sizeof(float) * (kT * kLd + kT * ld(N));
  if ((err = attn::allow_shared_bytes(ssd_bwd_dc_kernel<N>, dbc_bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dc_kernel<N><<<dim3(nt, nc * B), kThreads, dbc_bytes, stream>>>(
      bm, part_cb, part_c, dcb, dc, L, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if ((err = attn::allow_shared_bytes(ssd_bwd_db_kernel<N>, dbc_bytes)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_db_kernel<N><<<dim3(nt, nc * B), kThreads, dbc_bytes, stream>>>(
      cm, dcb, part_b, db, L, H, Q, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (P, N) pairs compiled, as for the forward (SHAPES in
// kernels/ssd_scan/ops.py): (64, 128) mamba2, (64, 64) zamba2, (16, 16) the
// smoke configs. The scratch comes from the caller: cb and dcb [B, nc, Q,
// Q], dchunk [B, nc, H, P, N], part_cb [B, nc, H, Q, Q], part_b and part_c
// [B, L, H, N], all float32, nc = L / chunk.
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dtA, const void* b, const void* c,
    const void* dy, const void* dfinal, const void* entering,
    const void* decay, void* dx, void* ddtA, void* db, void* dc, void* dinit,
    void* cb, void* dchunk, void* part_cb, void* part_b, void* part_c,
    void* dcb, int B, int L, int H, int P, int N, int chunk, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
#define SSD_BWD_ARGS                                                      \
  f(x), f(dtA), f(b), f(c), f(dy), f(dfinal), f(entering), f(decay),      \
      w(dx), w(ddtA), w(db), w(dc), w(dinit), w(cb), w(dchunk), w(part_cb), \
      w(part_b), w(part_c), w(dcb), B, L, H, chunk, s
  if (P == 16 && N == 16) return launch<16, 16>(SSD_BWD_ARGS);
  if (P == 64 && N == 64) return launch<64, 64>(SSD_BWD_ARGS);
  if (P == 64 && N == 128) return launch<64, 128>(SSD_BWD_ARGS);
#undef SSD_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
