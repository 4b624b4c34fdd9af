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
// Small heads, (P, N) = (16, 16) (the mamba2 and zamba2 smoke configs that
// an edge cluster serves): the same four launches and the same scratch, as
// plain float32 loops on the CUDA cores (ssd_*_small_kernel), one block per
// (row, chunk) or (head, chunk and row), each thread on elements of the
// output in turn. A 64-row tile would leave three of its four warps idle
// at P = 16, and at these sizes launches, not arithmetic, set the time.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"
#include "ssd_mma.cuh"

namespace {

using namespace ssd;

// Blocks an SM the chunk-states and output launches are compiled for (at
// most 128 registers a thread; they spill up to 96 bytes). Their staging
// waits on device memory, and more blocks in flight hide more of it: 4
// ran faster than 1-3 and no slower than 5-6 on an H100.
constexpr int kMinBlocks = 4;

// 1. cb[b, c, q, s] = C[q] . B[s] for the 64 x 64 tile (i, j), j <= i, of
// chunk c of row b; grid (tiles on or below the diagonal, nc, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  float* __restrict__ cb, int L, int Q) {
  cb_tile<N>(bm, cm, cb, L, Q);
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
  if (threadIdx.x == 0 && n0 == 0)
    decay[(static_cast<int64_t>(b) * nc + c) * H + h] = expf(s_a[Q - 1]);

  float acc[8][4] = {};
  chunk_state_product<N>(acc, x_hi, x_lo, b_hi, b_lo, s_w, s_a,
                         x + row0 * xrow + h * kP, xrow, bm + row0 * N, n0, Q,
                         true);
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

// ---------------------------------------------------------------------------
// Small (P, N): plain float32 versions of the four launches.
// ---------------------------------------------------------------------------

// 1. cb[b, c, q, s] = C[q] . B[s] for s <= q < Q; grid (nc, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_cb_small_kernel(const float* __restrict__ bm,
                        const float* __restrict__ cm, float* __restrict__ cb,
                        int L, int Q) {
  cb_small<N>(bm, cm, cb, L, Q);
}

// 2. chunk_states[b, c, h] = sum_s (x[s] w[s])^T B[s], w[s] = exp(a_last -
// a_cum[s]), and decay[b, c, h] = exp(a_last); grid (H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_states_small_kernel(const float* __restrict__ x,
                            const float* __restrict__ dtA,
                            const float* __restrict__ bm,
                            float* __restrict__ states,
                            float* __restrict__ decay, int L, int H, int Q,
                            int nc) {
  __shared__ float s_a[kMaxChunk], s_w[kMaxChunk];
  const int h = blockIdx.x, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, Q);
  __syncthreads();
  const float a_last = s_a[Q - 1];
  for (int s = threadIdx.x; s < Q; s += kThreads)
    s_w[s] = expf(a_last - s_a[s]);
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  if (threadIdx.x == 0) decay[bch] = expf(a_last);
  __syncthreads();
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    const float* xs = x + row0 * xrow + h * P + p;
    const float* bs = bm + row0 * N + n;
    float acc = 0.f;
    for (int s = 0; s < Q; ++s)
      acc = fmaf(__ldg(xs + s * xrow) * s_w[s], __ldg(bs + s * N), acc);
    states[bch * P * N + e] = acc;
  }
}

// 4. y[q] for every row q of chunk c, head h, row b: (C[q] . entering^T)
// exp(a_cum[q]) + sum_{s <= q} cb[q, s] exp(a_cum[q] - a_cum[s]) x[s];
// grid (H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_output_small_kernel(const float* __restrict__ x,
                            const float* __restrict__ dtA,
                            const float* __restrict__ cm,
                            const float* __restrict__ cb,
                            const float* __restrict__ entering,
                            float* __restrict__ y, int L, int H, int Q,
                            int nc, int has_init) {
  __shared__ float s_a[kMaxChunk];
  const int h = blockIdx.x, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int Qp = padded(Q);
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  const float* ent = entering + bch * P * N;
  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, Q);
  __syncthreads();
  for (int e = threadIdx.x; e < Q * P; e += kThreads) {
    const int q = e / P, p = e % P;
    const float aq = s_a[q];
    float off = 0.f;
    if (c > 0 || has_init) {
      const float* crow = cm + (row0 + q) * N;
#pragma unroll
      for (int n = 0; n < N; ++n)
        off = fmaf(__ldg(crow + n), __ldg(ent + p * N + n), off);
      off *= expf(aq);
    }
    const float* xs = x + row0 * xrow + h * P + p;
    const float* cq = cbc + static_cast<int64_t>(q) * Qp;
    float acc = 0.f;
    for (int s = 0; s <= q; ++s)
      acc = fmaf(cq[s] * expf(aq - s_a[s]), __ldg(xs + s * xrow), acc);
    y[(row0 + q) * xrow + h * P + p] = acc + off;
  }
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

// The four small-(P, N) launches, with the scratch of launch<N>.
template <int P, int N>
int launch_small(const float* x, const float* dtA, const float* bm,
                 const float* cm, const float* init, float* y, float* state,
                 float* cb, float* states, float* entering, float* decay,
                 int B, int L, int H, int Q, cudaStream_t stream) {
  const int nc = L / Q;
  if (static_cast<int64_t>(nc) * B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_cb_small_kernel<N><<<dim3(nc, B), kThreads, 0, stream>>>(bm, cm, cb,
                                                               L, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_states_small_kernel<P, N><<<dim3(H, nc * B), kThreads, 0, stream>>>(
      x, dtA, bm, states, decay, L, H, Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int PN = P * N;
  ssd_recurrence_kernel<<<dim3((PN / 4 + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(states, decay, init,
                                                 entering, state, nc, H, PN);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_output_small_kernel<P, N><<<dim3(H, nc * B), kThreads, 0, stream>>>(
      x, dtA, cm, cb, entering, y, L, H, Q, nc, init != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (P, N) pairs compiled: zamba2's (64, 64) and mamba2's (64, 128) on the
// tensor cores, and the smoke configs' (16, 16) on the CUDA cores. Keep in
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
      L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  if (P == 16 && N == 16)
    return launch_small<16, 16>(f(x), f(dtA), f(b), f(c), f(init), w(y),
                                w(state), w(cb), w(chunk_states),
                                w(entering), w(decay), B, L, H, chunk, s);
  if (P != kP) return static_cast<int>(cudaErrorInvalidValue);
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
