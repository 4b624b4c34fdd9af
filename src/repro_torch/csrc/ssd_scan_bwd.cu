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
// P = 64, N = 128, Q = 256) the function needs 65.3 GFLOP and must move
// 0.63 GB (chip_smoke.py's _ssd_bwd_work): 0.97 ms at the float32 peak,
// 0.19 ms for its bytes at 3.35 TB/s. Every product runs on the tensor
// cores with B8's precision plan (ssd_scan.cu's header, ssd_mma.cuh): each
// float32 operand staged in shared memory as bf16 hi and lo tiles (a
// per-row factor folded in before the split), each product lo.hi + hi.lo
// + hi.hi in mma.sync m16n8k16, each 16-deep k-step summed in a zeroed
// fragment and added in float32. The CPU rehearsal of this plan
// (tests/test_torch_ssd_bwd.py) reads every gradient within about 1e-5 of
// its scale, and one bf16 term about 4e-3. The three bf16 products of each
// float32 one are 196 GFLOP (0.20 ms at 989 TFLOP/s); dy_h x_h^T, formed
// by launches 4 and 6 both, adds about a tenth. In practice neither the
// bytes nor the tensor cores set the pace but the rounds of 64 x 64 tiles:
// load, split into hi and lo, barrier, product, about 5 us a round for a
// block, which neither removing the products nor removing the loads
// shortened much on an H100.
//
// Design: six launches, each over many independent blocks and none with
// atomics. Every sum over heads is taken on chip, in head order, so two
// calls give the same bits and nothing is stored per head but the state
// gradients dchunk:
//   1. ssd_bwd_cb_kernel, per (row, chunk, 64 x 64 tile on or below the
//      diagonal): C.B^T into cb [B, nc, Qp, Qp] (Qp: Q rounded up to 64),
//      as B8's first launch.
//   2. ssd_bwd_dstate_kernel, per (64 columns of N, head, chunk and row):
//      sum_q (exp(a_q) dy[q])^T C[q] into dchunk [B, nc, H, P, N], and a
//      into acum [B, L, H].
//   3. ssd_bwd_recurrence_kernel, elementwise over [P, N] per (head, row):
//      the reverse recurrence, turning dchunk[c] into dS_{c+1} in place and
//      writing dinit.
//   4. ssd_bwd_dcb_kernel, per (row, chunk, tile pair s <= q): dCB = sum_h
//      L_h o (dy_h x_h^T), heads in order, into dcb [B, nc, Qp, Qp]; off
//      the diagonal tile L's two factors are folded into the operands and
//      the sum over heads is one product of depth H P.
//   5. ssd_bwd_dbc_kernel, per (64-row tile, 64 columns of N, dc or db,
//      chunk and row): dc = sum_h (exp(a_h) dy_h) S_h + dCB B and db =
//      sum_h (w_h x_h) dS_h + dCB^T C, the per-row, per-head factor folded
//      into the staged operand, the heads in order; a dc block forms each
//      head's product apart, adds it, and writes its row sums against C,
//      sum_p dy y_off for that head (a term of da), into da_off [N / 64, B,
//      L, H].
//   6. ssd_bwd_dx_kernel, per (head, chunk and row), the chunk whole: what
//      stays per head. da starts from da_off; U = B dS^T gives dx's state
//      term w U and -w sum_p x U; over the tile pairs (s <= q) M^T = x dy^T
//      and the scores (C B^T o L)^T are formed in registers, the row and
//      column sums of scores o M^T go into da, and the scores, as A
//      fragments, times dy add to dx; then ddtA.
// Off the diagonal tile exp(a_q - a_s) is formed as exp(a_q - a_r) exp(a_r
// - a_s), a_r at the s tile's last row, both factors at most 1; on it
// exp(a_q - a_s) is evaluated only where s <= q (above the diagonal the
// exponent is positive and may overflow, and inf * 0 is NaN). Scratch (one
// allocation of the caller's, float32): cb and dcb, dchunk, acum and
// da_off, 0.108 GB at the mamba2 shape.
//
// Small heads, (P, N) = (16, 16) (the smoke configs): the same six
// launches and scratch (no da_off: launch 6 forms that term itself) as
// plain float32 loops on the CUDA cores
// (ssd_bwd_*_small_kernel), one block per (head, chunk and row) or (chunk,
// row), each thread on elements in turn: at these sizes launches, not
// arithmetic, set the time, as for B8's small heads.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include <map>
#include <mutex>
#include <utility>

#include "attention_common.cuh"
#include "ssd_mma.cuh"

namespace {

using namespace ssd;

// Let a kernel use more than 48 KB of dynamic shared memory on a device
// (attn::allow_shared_bytes), skipped where an earlier call set as many
// bytes or more: the attribute holds for the process, and the runtime call
// is part of each backward's host time.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes, int device) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> set;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = set[{reinterpret_cast<const void*>(kernel), device}];
  if (bytes <= have || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = attn::allow_shared_bytes(kernel, bytes);
  if (err == cudaSuccess) have = bytes;
  return err;
}

// Blocks an SM the per-head and head-sum launches are compiled for (at
// most 168 registers a thread).
constexpr int kMinBlocks = 3;

// Sum over the 64 columns of a warp's C fragments (rows r and r + 8 of a
// 64-row tile, r = 16 warp + lane / 4) times v[row][col] (row at v + row
// stride, float32; rows from n_rows on count 0): the row sums, in every
// lane of the row's quad.
__device__ __forceinline__ void row_dots(const float (&acc)[8][4],
                                         const float* __restrict__ v,
                                         int64_t stride, int r, int n_rows,
                                         float& sa, float& sb) {
  const int t = threadIdx.x & 3;
  sa = 0.f;
  sb = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r < n_rows) {
      const float2 u =
          __ldg(reinterpret_cast<const float2*>(v + r * stride + col));
      sa = fmaf(u.x, acc[nt][0], fmaf(u.y, acc[nt][1], sa));
    }
    if (r + 8 < n_rows) {
      const float2 u =
          __ldg(reinterpret_cast<const float2*>(v + (r + 8) * stride + col));
      sb = fmaf(u.x, acc[nt][2], fmaf(u.y, acc[nt][3], sb));
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, o);
    sb += __shfl_xor_sync(0xffffffffu, sb, o);
  }
}

// ddtA[t] = sum_{u >= t} da[u] over the chunk's Q rows (row t at ddtA[t *
// H]), by warp 0, 32 rows at a time from the end. The caller syncs before.
__device__ __forceinline__ void reverse_cumsum(const float* s_da,
                                               float* __restrict__ ddtA,
                                               int H, int Q) {
  if (threadIdx.x >= 32) return;
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
    if (t >= 0) ddtA[static_cast<int64_t>(t) * H] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// 1. C.B^T into cb; grid (tiles on or below the diagonal, nc, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cb_kernel(const float* __restrict__ bm,
                      const float* __restrict__ cm, float* __restrict__ cb,
                      int L, int Q) {
  cb_tile<N>(bm, cm, cb, L, Q);
}

// 2. dchunk[b, c, h] = sum_q (exp(a_q) dy[q])^T C[q], 64 columns of N a
// block, and a into acum (the block of the first columns); grid (N / 64,
// H, nc B).
template <int N>
__global__ void __launch_bounds__(kThreads, 4)
    ssd_bwd_dstate_kernel(const float* __restrict__ dy,
                          const float* __restrict__ dtA,
                          const float* __restrict__ cm,
                          float* __restrict__ dchunk,
                          float* __restrict__ acum, int L, int H, int Q,
                          int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* d_hi = reinterpret_cast<bf16*>(smem);
  bf16* d_lo = d_hi + kTile * ld<kP>();
  bf16* c_hi = d_lo + kTile * ld<kP>();
  bf16* c_lo = c_hi + kTile * ld<64>();
  float* s_e = reinterpret_cast<float*>(c_lo + kTile * ld<64>());  // [64]
  float* s_a = s_e + kTile;                                        // [Qp]
  const int n0 = blockIdx.x * 64, h = blockIdx.y;
  const int c = blockIdx.z % nc, b = blockIdx.z / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;
  const int warp = threadIdx.x >> 5;

  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, padded(Q));
  __syncthreads();
  if (n0 == 0)
    for (int t = threadIdx.x; t < Q; t += kThreads)
      acum[(row0 + t) * H + h] = s_a[t];
  float acc[8][4] = {};
  chunk_state_product<N>(acc, d_hi, d_lo, c_hi, c_lo, s_e, s_a,
                         dy + row0 * xrow + h * kP, xrow, cm + row0 * N, n0,
                         Q, false);
  float* out = dchunk + ((static_cast<int64_t>(b) * nc + c) * H + h) * kP * N;
  store_frags<8>(out, N, warp * 16, n0, kP, acc);
}

// 3. The reverse recurrence over chunks, 4 elements of [P, N] a thread:
// run = dfinal (0 without one); for c = nc - 1 .. 0: g = dchunk[c];
// dchunk[c] = run; run = g + decay[c] run; dinit = run; grid (P N / 4 /
// 128, H, B).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_recurrence_kernel(float* __restrict__ dchunk,
                              const float* __restrict__ decay,
                              const float* __restrict__ dfinal,
                              float* __restrict__ dinit, int nc, int H,
                              int PN) {
  const int e = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float4 run = dfinal != nullptr
                   ? __ldg(reinterpret_cast<const float4*>(dfinal + bh * PN +
                                                           e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  const auto at = [&](int c) {  // chunk c's element
    return reinterpret_cast<float4*>(
        dchunk + ((static_cast<int64_t>(b) * nc + c) * H + h) * PN + e);
  };
  float4 next = *at(nc - 1);  // each chunk's load one step ahead
  for (int c = nc - 1; c >= 0; --c) {
    const float4 g = next;
    if (c > 0) next = *at(c - 1);
    const float d = decay[(static_cast<int64_t>(b) * nc + c) * H + h];
    *at(c) = run;
    run = make_float4(fmaf(d, run.x, g.x), fmaf(d, run.y, g.y),
                      fmaf(d, run.z, g.z), fmaf(d, run.w, g.w));
  }
  *reinterpret_cast<float4*>(dinit + bh * PN + e) = run;
}

// Floats per shared row of the float32 C.B^T tile of ssd_bwd_dx_kernel:
// a thread reads column s of rows q, 2 t apart for the four lanes t of a
// quad, and 68 puts those in distinct banks.
constexpr int kCbLd = kTile + 4;

// Shared bytes of ssd_bwd_dx_kernel: two staged hi/lo pairs of [64, 64]
// tiles, then a and da [kMaxChunk], a tile's row factor, row sums, the
// four warps' column sums, the reduction buffer and the C.B^T tile.
constexpr size_t dx_smem_bytes() {
  return 2 * pair_bytes<64>() +
         sizeof(float) * (2 * kMaxChunk + 2 * kTile + 4 * kTile + kThreads +
                          kTile * kCbLd);
}

// 6. dx and ddtA of one (head, chunk, row), the chunk whole; grid (H, nc
// B). Warp w takes rows 16 w..16 w + 15 of every 64-row tile.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_bwd_dx_kernel(const float* __restrict__ x,
                      const float* __restrict__ bm,
                      const float* __restrict__ dy,
                      const float* __restrict__ entering,
                      const float* __restrict__ decay,
                      const float* __restrict__ dst,
                      const float* __restrict__ cb,
                      const float* __restrict__ acum,
                      const float* __restrict__ da_off,
                      float* __restrict__ dx, float* __restrict__ ddtA, int L,
                      int H, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* t0_hi = reinterpret_cast<bf16*>(smem);
  bf16* t0_lo = t0_hi + kTile * ld<64>();
  bf16* t1_hi = t0_lo + kTile * ld<64>();
  bf16* t1_lo = t1_hi + kTile * ld<64>();
  float* s_a = reinterpret_cast<float*>(t1_lo + kTile * ld<64>());
  float* s_da = s_a + kMaxChunk;
  float* s_f = s_da + kMaxChunk;   // [64] exp(a_q - a_r) of a q tile
  float* s_row = s_f + kTile;      // [64] a tile's per-row sums
  float* s_col = s_row + kTile;    // [4][64] each warp's column sums
  float* s_red = s_col + 4 * kTile;  // [128]
  float* s_cb = s_red + kThreads;     // [64][kCbLd] C.B^T, rows q
  const int h = blockIdx.x;
  const int c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int Qp = padded(Q), nt = Qp / kTile;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's tile rows
  const float* ent = entering + bch * kP * N;
  const float* dsc = dst + bch * kP * N;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  const float* xh = x + row0 * xrow + h * kP;  // row s at xh + s xrow
  TileRegs<64> r0_, r1_;  // the next tiles, loaded before a barrier
  const float* dyh = dy + row0 * xrow + h * kP;

  // a (rows from Q on: a_{Q-1}, so every factor stays finite), and da
  // from sum_p dy y_off, which launch 5 wrote for each 64 columns of N
  const int64_t rows = static_cast<int64_t>(gridDim.y / nc) * L;  // B L
  for (int u = threadIdx.x; u < Qp; u += kThreads) {
    s_a[u] = __ldg(acum + (row0 + min(u, Q - 1)) * H + h);
    float v = 0.f;
    if (u < Q)
      for (int k = 0; k < N / 64; ++k)
        v += __ldg(da_off + (k * rows + row0 + u) * H + h);
    s_da[u] = v;
  }
  __syncthreads();
  const float a_last = s_a[Q - 1];

  // --- ddecay = sum S_c o dS_{c+1}, reduced in a fixed order
  {
    float v = 0.f;
    for (int e = 4 * threadIdx.x; e < kP * N; e += 4 * kThreads) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(ent + e));
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(dsc + e));
      v = fmaf(s4.x, d4.x, v);
      v = fmaf(s4.y, d4.y, v);
      v = fmaf(s4.z, d4.z, v);
      v = fmaf(s4.w, d4.w, v);
    }
    s_red[threadIdx.x] = v;
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if (static_cast<int>(threadIdx.x) < o)
        s_red[threadIdx.x] += s_red[threadIdx.x + o];
      __syncthreads();
    }
  }
  const float ddecay = s_red[0];

  float sum_wdw = 0.f;  // thread 0's
  for (int st = 0; st < nt; ++st) {
    const int s0 = st * kTile, ns = min(kTile, Q - s0);
    // U = B dS^T (rows s, columns p)
    float acc[8][4] = {};
    for (int n0 = 0; n0 < N; n0 += 64) {
      tile_load(r0_, bm + (row0 + s0) * N + n0, N, ns);
      tile_load(r1_, dsc + n0, N, kP);
      __syncthreads();  // the previous readers of the tiles are done
      tile_store_split(r0_, t0_hi, t0_lo, nullptr);
      tile_store_split(r1_, t1_hi, t1_lo, nullptr);
      __syncthreads();
      mm64<false, true>(acc, t0_hi, t0_lo, t1_hi, t1_lo);  // dS stored [p][n]
    }
    // dx's state term w U, and w sum_p x U (w dw) out of da
    {
      const float wa = expf(a_last - s_a[s0 + ra]);
      const float wb = expf(a_last - s_a[s0 + rb]);
      float pa, pb;
      row_dots(acc, xh + s0 * xrow, xrow, ra, ns, pa, pb);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= wa;
        acc[n][1] *= wa;
        acc[n][2] *= wb;
        acc[n][3] *= wb;
      }
      if (t == 0) {
        s_row[ra] = wa * pa;
        s_row[rb] = wb * pb;
      }
    }
    __syncthreads();  // s_row written; the U tiles' readers are done
    if (static_cast<int>(threadIdx.x) < ns)
      s_da[s0 + threadIdx.x] -= s_row[threadIdx.x];
    if (threadIdx.x == 0)
      for (int s = 0; s < ns; ++s) sum_wdw += s_row[s];
    stage_split<kP>(t0_hi, t0_lo, xh + s0 * xrow, xrow, ns, nullptr);

    // the tile pairs (st, qt), qt >= st
    const float a_r = s_a[s0 + kTile - 1];
    const float fa = expf(a_r - s_a[s0 + ra]), fb = expf(a_r - s_a[s0 + rb]);
    for (int qt = st; qt < nt; ++qt) {
      const int q0 = qt * kTile, nq = min(kTile, Q - q0);
      const bool diag = qt == st;
      tile_load(r0_, dyh + q0 * xrow, xrow, nq);
      tile_load(r1_, cbc + static_cast<int64_t>(q0) * Qp + s0, Qp, kTile);
      __syncthreads();  // the previous pair's readers are done
      if (threadIdx.x < kTile)
        s_f[threadIdx.x] = expf(s_a[q0 + threadIdx.x] - a_r);
      tile_store_split(r0_, t1_hi, t1_lo, nullptr);
      tile_store_f32(r1_, s_cb, kCbLd);
      __syncthreads();
      // M^T = x_s dy_q^T (rows s, columns q; dy stored [q][p])
      float m[8][4] = {};
      mm64<false, true>(m, t0_hi, t0_lo, t1_hi, t1_lo);
      // the scores (C B^T o L)^T at the same places, T = scores o M^T: its
      // sums over q (row sums here) leave da[s], over s enter da[q]
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * t, q = q0 + col;
        float l[4];
        if (diag) {
          const int sa = s0 + ra, sb = s0 + rb;
          l[0] = sa <= q ? expf(s_a[q] - s_a[sa]) : 0.f;
          l[1] = sa <= q + 1 ? expf(s_a[q + 1] - s_a[sa]) : 0.f;
          l[2] = sb <= q ? expf(s_a[q] - s_a[sb]) : 0.f;
          l[3] = sb <= q + 1 ? expf(s_a[q + 1] - s_a[sb]) : 0.f;
        } else {
          const float e0 = s_f[col], e1 = s_f[col + 1];
          l[0] = fa * e0;
          l[1] = fa * e1;
          l[2] = fb * e0;
          l[3] = fb * e1;
        }
        const float* cq = s_cb + col * kCbLd;  // C.B^T row q, then q + 1
        const float p0 = cq[ra] * l[0], p1 = cq[kCbLd + ra] * l[1];
        const float p2 = cq[rb] * l[2], p3 = cq[kCbLd + rb] * l[3];
        const float t0 = p0 * m[n][0], t1 = p1 * m[n][1];
        const float t2 = p2 * m[n][2], t3 = p3 * m[n][3];
        sum_a += t0 + t1;
        sum_b += t2 + t3;
        float c0 = t0 + t2, c1 = t1 + t3;  // this thread's two rows
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        if (g == 0) {
          s_col[warp * kTile + col] = c0;
          s_col[warp * kTile + col + 1] = c1;
        }
        m[n][0] = p0;
        m[n][1] = p1;
        m[n][2] = p2;
        m[n][3] = p3;
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
      }
      if (t == 0) {
        s_row[ra] = sum_a;
        s_row[rb] = sum_b;
      }
      __syncthreads();
      // thread u < 64 adds to da[q0 + u], thread 64 + u takes from da[s0 +
      // u]; on the diagonal tile both are one row, which thread u takes
      if (threadIdx.x < kTile) {
        const int u = threadIdx.x;
        float v = s_col[u] + s_col[kTile + u] + s_col[2 * kTile + u] +
                  s_col[3 * kTile + u];
        if (diag) v -= s_row[u];
        if (u < nq) s_da[q0 + u] += v;
      } else if (!diag && threadIdx.x < 2 * kTile) {
        const int u = threadIdx.x - kTile;
        if (u < ns) s_da[s0 + u] -= s_row[u];
      }
      // dx += scores dy_q: two C tiles side by side are one A fragment
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t a[2][4];
        mma::split_a<2>(m[2 * kc], m[2 * kc + 1], a);
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // dy [q][p]
          uint32_t bh[4], bl[4];
          mma::load_b_kn(bh, t1_hi, ld<kP>(), kc * 16, np * 16);
          mma::load_b_kn(bl, t1_lo, ld<kP>(), kc * 16, np * 16);
          mma3(acc[2 * np], a[0], a[1], bh[0], bh[1], bl[0], bl[1]);
          mma3(acc[2 * np + 1], a[0], a[1], bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
    store_frags<8>(dx + row0 * xrow + h * kP, xrow, s0 + warp * 16, 0, Q,
                   acc);
  }

  // the last row's terms, then ddtA
  __syncthreads();
  if (threadIdx.x == 0) s_da[Q - 1] += sum_wdw + ddecay * __ldg(decay + bch);
  __syncthreads();
  reverse_cumsum(s_da, ddtA + row0 * H + h, H, Q);
}

// 4. dCB = sum_h L_h o (dy_h x_h^T) for the tile pair (i, j), j <= i, of
// chunk c, row b, heads in order; grid (tiles on or below the diagonal,
// nc, B). Warp w takes rows 16 w.. of the q tile. Off the diagonal L_h =
// exp(a_q - a_r) exp(a_r - a_s) (a_r at the s tile's last row) is folded
// into the staged operands, so the sum over heads is one product of depth
// H P; on it each head's dy_h x_h^T is formed apart and multiplied by L_h
// element by element.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_bwd_dcb_kernel(const float* __restrict__ x,
                       const float* __restrict__ dy,
                       const float* __restrict__ acum,
                       float* __restrict__ dcb, int L, int H, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* d_hi = reinterpret_cast<bf16*>(smem);
  bf16* d_lo = d_hi + kTile * ld<kP>();
  bf16* x_hi = d_lo + kTile * ld<kP>();
  bf16* x_lo = x_hi + kTile * ld<kP>();
  // [64] each: the rows' factors exp(a_q - a_r), exp(a_r - a_s) off the
  // diagonal, a_q and a_s on it
  float* s_fq = reinterpret_cast<float*>(x_lo + kTile * ld<kP>());
  float* s_fs = s_fq + kTile;
  int j = blockIdx.x, i = 0;  // the j-th tile of tile row i
  while (j > i) j -= ++i;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int Qp = padded(Q), q0 = i * kTile, s0 = j * kTile;
  const int nq = min(kTile, Q - q0), ns = min(kTile, Q - s0);
  const bool diag = i == j;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's tile rows
  // rows of a (clamped to the chunk: padded rows of a ragged tile give
  // finite factors and zero terms): thread u < 64 reads q0 + u and s0 + u
  const int u = min(static_cast<int>(threadIdx.x), kTile - 1);
  const float* aq = acum + (row0 + min(q0 + u, Q - 1)) * H;
  const float* as = acum + (row0 + min(s0 + u, Q - 1)) * H;
  const float* ar = acum + (row0 + min(s0 + kTile - 1, Q - 1)) * H;

  float acc[8][4] = {};
  for (int h = 0; h < H; ++h) {
    // every load of the head in flight at once, before the barrier
    TileRegs<kP> rd, rx;
    tile_load(rd, dy + (row0 + q0) * xrow + h * kP, xrow, nq);
    tile_load(rx, x + (row0 + s0) * xrow + h * kP, xrow, ns);
    const float pq = __ldg(aq + h), ps = __ldg(as + h), pr = __ldg(ar + h);
    __syncthreads();  // the previous head's readers are done
    if (threadIdx.x < kTile) {
      s_fq[threadIdx.x] = diag ? pq : expf(pq - pr);
      s_fs[threadIdx.x] = diag ? ps : expf(pr - ps);
    }
    __syncthreads();
    tile_store_split(rd, d_hi, d_lo, diag ? nullptr : s_fq);
    tile_store_split(rx, x_hi, x_lo, diag ? nullptr : s_fs);
    __syncthreads();
    if (!diag) {
      mm64<false, true>(acc, d_hi, d_lo, x_hi, x_lo);  // x stored [s][p]
      continue;
    }
    float m[8][4] = {};
    mm64<false, true>(m, d_hi, d_lo, x_hi, x_lo);
    const float aqa = s_fq[ra], aqb = s_fq[rb];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        const float la = col <= ra ? expf(aqa - s_fs[col]) : 0.f;
        const float lb = col <= rb ? expf(aqb - s_fs[col]) : 0.f;
        acc[n][e] = fmaf(la, m[n][e], acc[n][e]);
        acc[n][2 + e] = fmaf(lb, m[n][2 + e], acc[n][2 + e]);
      }
    }
  }
  store_frags<8>(dcb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp, Qp,
                 q0 + warp * 16, s0, Qp, acc);
}

// Floats per shared row of the float32 C tile of ssd_bwd_dbc_kernel: the
// eight rows and four column pairs of a half-warp's 8-byte reads fall in
// distinct banks.
constexpr int kCLd = kTile + 8;

// 5. Columns n0..n0+63 of dc (blockIdx.z even) or db (odd) for the 64-row
// tile i of chunk c, row b: dc = sum_h (exp(a_h) dy_h) S_h + sum_{j <= i}
// dCB_ij B_j, db = sum_h (w_h x_h) dS_h + sum_{j >= i} dCB_ji^T C_j;
// grid (tiles, N / 64, 2 nc B). A dc block also writes, for each head, the
// row sums of C o ((exp(a_h) dy_h) S_h) over its columns (sum_p dy y_off,
// the term of da that needs C S_h^T) into da_off [N / 64, B, L, H], which
// launch 6 adds up.
template <int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    ssd_bwd_dbc_kernel(const float* __restrict__ x,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm,
                       const float* __restrict__ dy,
                       const float* __restrict__ entering,
                       const float* __restrict__ dst,
                       const float* __restrict__ acum,
                       const float* __restrict__ dcb, float* __restrict__ db,
                       float* __restrict__ dc, float* __restrict__ da_off,
                       int L, int H, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a_hi = reinterpret_cast<bf16*>(smem);
  bf16* a_lo = a_hi + kTile * ld<64>();
  bf16* b_hi = a_lo + kTile * ld<64>();
  bf16* b_lo = b_hi + kTile * ld<64>();
  float* s_c = reinterpret_cast<float*>(b_lo + kTile * ld<64>());  // C tile
  float* s_e = s_c + kTile * kCLd;  // [H][65] each head's row factors
  const int i = blockIdx.x, n0 = blockIdx.y * 64;
  const bool is_db = blockIdx.z & 1;
  const int c = (blockIdx.z >> 1) % nc, b = (blockIdx.z >> 1) / nc;
  const int Qp = padded(Q), nt = Qp / kTile;
  const int r0 = i * kTile, nr = min(kTile, Q - r0);
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * kP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;  // this thread's rows
  const float* v = (is_db ? x : dy) + (row0 + r0) * xrow;
  const float* state = (is_db ? dst : entering) + bc * H * kP * N + n0;
  const float* a_rows = acum + (row0 + r0) * H;
  const float* a_last = acum + (row0 + Q - 1) * H;

  // every head's factors: exp(a) (dc) or exp(a_last - a) (db) of the
  // tile's rows, read row by row (heads contiguous); a dc block's C tile
  for (int e = threadIdx.x; e < kTile * H; e += kThreads) {
    const int u = e / H, h = e % H;
    float f = 0.f;
    if (u < nr) {
      const float a = __ldg(a_rows + static_cast<int64_t>(u) * H + h);
      f = expf(is_db ? __ldg(a_last + h) - a : a);
    }
    s_e[h * (kTile + 1) + u] = f;
  }
  if (!is_db) {
    TileRegs<64> rc;
    tile_load(rc, cm + (row0 + r0) * N + n0, N, nr);
    tile_store_f32(rc, s_c, kCLd);
  }
  // the state term, one product of depth H P, heads in order; for dc each
  // head's product apart, then added
  const int64_t rows = static_cast<int64_t>(gridDim.z / (2 * nc)) * L;
  float* off = da_off + (blockIdx.y * rows + row0 + r0) * H;  // [r][h]
  float acc[8][4] = {};
  for (int h = 0; h < H; ++h) {
    TileRegs<kP> rv;
    TileRegs<64> rs;
    tile_load(rv, v + h * kP, xrow, nr);
    tile_load(rs, state + static_cast<int64_t>(h) * kP * N, N, kP);
    __syncthreads();  // the previous head's readers are done (and s_e set)
    tile_store_split(rv, a_hi, a_lo, s_e + h * (kTile + 1));
    tile_store_split(rs, b_hi, b_lo, nullptr);
    __syncthreads();
    if (is_db) {
      mm64<false, false, true>(acc, a_hi, a_lo, b_hi, b_lo);  // dS [p][n]
      continue;
    }
    float m[8][4] = {};
    mm64<false, false, true>(m, a_hi, a_lo, b_hi, b_lo);  // S stored [p][n]
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t;
      const float2 ca =
          *reinterpret_cast<const float2*>(s_c + ra * kCLd + col);
      const float2 cc =
          *reinterpret_cast<const float2*>(s_c + rb * kCLd + col);
      pa = fmaf(ca.x, m[n][0], fmaf(ca.y, m[n][1], pa));
      pb = fmaf(cc.x, m[n][2], fmaf(cc.y, m[n][3], pb));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += m[n][e];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, o);
      pb += __shfl_xor_sync(0xffffffffu, pb, o);
    }
    if (t == 0) {
      if (ra < nr) off[static_cast<int64_t>(ra) * H + h] = pa;
      if (rb < nr) off[static_cast<int64_t>(rb) * H + h] = pb;
    }
  }
  // dCB's term over the tiles on or below the diagonal
  const float* dcbc = dcb + bc * Qp * Qp;
  const float* mat = (is_db ? cm : bm) + row0 * N + n0;
  for (int k = is_db ? i : 0; k < (is_db ? nt : i + 1); ++k) {
    const int k0 = k * kTile;
    // the tile (k, i) for db: rows q = k (depth), columns s = i; (i, k)
    // for dc: rows q = i, columns s = k (depth)
    TileRegs<64> rd, rm;
    tile_load(rd, dcbc + (is_db ? static_cast<int64_t>(k0) * Qp + r0
                                : static_cast<int64_t>(r0) * Qp + k0),
              Qp, kTile);
    tile_load(rm, mat + static_cast<int64_t>(k0) * N, N, min(kTile, Q - k0));
    __syncthreads();
    tile_store_split(rd, a_hi, a_lo, nullptr);
    tile_store_split(rm, b_hi, b_lo, nullptr);
    __syncthreads();
    if (is_db)
      mm64<true, false, true>(acc, a_hi, a_lo, b_hi, b_lo);
    else
      mm64<false, false, true>(acc, a_hi, a_lo, b_hi, b_lo);
  }
  store_frags<8>((is_db ? db : dc) + row0 * N, N, r0 + warp * 16, n0, Q,
                 acc);
}

// ---------------------------------------------------------------------------
// Small (P, N): plain float32 versions of the six launches.
// ---------------------------------------------------------------------------

// 1. cb[b, c, q, s] = C[q] . B[s] for s <= q < Q; grid (nc, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_cb_small_kernel(const float* __restrict__ bm,
                            const float* __restrict__ cm,
                            float* __restrict__ cb, int L, int Q) {
  cb_small<N>(bm, cm, cb, L, Q);
}

// 2. dchunk[b, c, h][p, n] = sum_q exp(a_q) dy[q, p] C[q, n], and a into
// acum; grid (H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dstate_small_kernel(const float* __restrict__ dy,
                                const float* __restrict__ dtA,
                                const float* __restrict__ cm,
                                float* __restrict__ dchunk,
                                float* __restrict__ acum, int L, int H,
                                int Q, int nc) {
  __shared__ float s_a[kMaxChunk], s_e[kMaxChunk];
  const int h = blockIdx.x, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  chunk_cumsum(s_a, dtA + row0 * H + h, H, Q, Q);
  __syncthreads();
  for (int t = threadIdx.x; t < Q; t += kThreads) {
    acum[(row0 + t) * H + h] = s_a[t];
    s_e[t] = expf(s_a[t]);
  }
  __syncthreads();
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    const float* dq = dy + row0 * xrow + h * P + p;
    const float* cq = cm + row0 * N + n;
    float acc = 0.f;
    for (int q = 0; q < Q; ++q)
      acc = fmaf(__ldg(dq + q * xrow) * s_e[q], __ldg(cq + q * N), acc);
    dchunk[bch * P * N + e] = acc;
  }
}

// 6. dx and ddtA of one (head, chunk, row); grid (H, nc B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dx_small_kernel(const float* __restrict__ x,
                            const float* __restrict__ bm,
                            const float* __restrict__ cm,
                            const float* __restrict__ dy,
                            const float* __restrict__ entering,
                            const float* __restrict__ decay,
                            const float* __restrict__ dst,
                            const float* __restrict__ cb,
                            const float* __restrict__ acum,
                            float* __restrict__ dx, float* __restrict__ ddtA,
                            int L, int H, int Q, int nc) {
  __shared__ float s_a[kMaxChunk], s_da[kMaxChunk], s_wdw[kMaxChunk];
  __shared__ float s_ds[P * N], s_s[P * N];
  const int h = blockIdx.x, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int Qp = padded(Q);
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t bch = (static_cast<int64_t>(b) * nc + c) * H + h;
  const float* cbc = cb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  const float* xh = x + row0 * xrow + h * P;
  const float* dyh = dy + row0 * xrow + h * P;
  for (int t = threadIdx.x; t < Q; t += kThreads)
    s_a[t] = __ldg(acum + (row0 + t) * H + h);
  for (int e = threadIdx.x; e < P * N; e += kThreads) {
    s_ds[e] = __ldg(dst + bch * P * N + e);
    s_s[e] = __ldg(entering + bch * P * N + e);
  }
  __syncthreads();
  const float a_last = s_a[Q - 1];
  // dx[s, p] = w[s] sum_n B[s, n] dS[p, n] + sum_{q >= s} cb[q, s] L dy[q, p]
  for (int e = threadIdx.x; e < Q * P; e += kThreads) {
    const int s = e / P, p = e % P;
    float u = 0.f;
#pragma unroll
    for (int n = 0; n < N; ++n)
      u = fmaf(__ldg(bm + (row0 + s) * N + n), s_ds[p * N + n], u);
    float v = expf(a_last - s_a[s]) * u;
    for (int q = s; q < Q; ++q)
      v = fmaf(cbc[static_cast<int64_t>(q) * Qp + s] * expf(s_a[q] - s_a[s]),
               __ldg(dyh + q * xrow + p), v);
    dx[(row0 + s) * xrow + h * P + p] = v;
  }
  // da[t]: the row sum less the column sum of cb o L o (dy x^T), sum_p dy
  // y_off, less w dw
  for (int r = threadIdx.x; r < Q; r += kThreads) {
    const float ar = s_a[r];
    float da = 0.f;
    for (int s = 0; s <= r; ++s) {
      float m = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p)
        m = fmaf(__ldg(dyh + r * xrow + p), __ldg(xh + s * xrow + p), m);
      da = fmaf(cbc[static_cast<int64_t>(r) * Qp + s] * expf(ar - s_a[s]), m,
                da);
    }
    for (int q = r; q < Q; ++q) {
      float m = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p)
        m = fmaf(__ldg(dyh + q * xrow + p), __ldg(xh + r * xrow + p), m);
      da -= cbc[static_cast<int64_t>(q) * Qp + r] * expf(s_a[q] - ar) * m;
    }
    float off = 0.f, raw = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float vs = 0.f, vd = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        vs = fmaf(__ldg(cm + (row0 + r) * N + n), s_s[p * N + n], vs);
        vd = fmaf(__ldg(bm + (row0 + r) * N + n), s_ds[p * N + n], vd);
      }
      off = fmaf(__ldg(dyh + r * xrow + p), vs, off);
      raw = fmaf(__ldg(xh + r * xrow + p), vd, raw);
    }
    const float wdw = expf(a_last - ar) * raw;
    s_da[r] = da + expf(ar) * off - wdw;
    s_wdw[r] = wdw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum_wdw = 0.f, ddecay = 0.f;
    for (int r = 0; r < Q; ++r) sum_wdw += s_wdw[r];
    for (int e = 0; e < P * N; ++e) ddecay = fmaf(s_s[e], s_ds[e], ddecay);
    s_da[Q - 1] += sum_wdw + ddecay * __ldg(decay + bch);
  }
  __syncthreads();
  reverse_cumsum(s_da, ddtA + row0 * H + h, H, Q);
}

// 4. dcb[b, c, q, s] = sum_h exp(a_q,h - a_s,h) sum_p dy_h[q, p] x_h[s, p]
// for s <= q, heads in order; grid (nc, B).
template <int P>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dcb_small_kernel(const float* __restrict__ x,
                             const float* __restrict__ dy,
                             const float* __restrict__ acum,
                             float* __restrict__ dcb, int L, int H, int Q) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x, Qp = padded(Q);
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  float* out = dcb + (static_cast<int64_t>(b) * nc + c) * Qp * Qp;
  for (int e = threadIdx.x; e < Q * Q; e += kThreads) {
    const int q = e / Q, s = e % Q;
    if (s > q) continue;
    float v = 0.f;
    for (int h = 0; h < H; ++h) {
      const float* dq = dy + (row0 + q) * xrow + h * P;
      const float* xs = x + (row0 + s) * xrow + h * P;
      float m = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) m = fmaf(__ldg(dq + p), __ldg(xs + p), m);
      v = fmaf(expf(__ldg(acum + (row0 + q) * H + h) -
                    __ldg(acum + (row0 + s) * H + h)),
               m, v);
    }
    out[static_cast<int64_t>(q) * Qp + s] = v;
  }
}

// 5. dc[q, n] = sum_h exp(a_q,h) dy_h[q] . S_h[:, n] + sum_{s <= q} dCB[q,
// s] B[s, n] and db[s, n] = sum_h w_h[s] x_h[s] . dS_h[:, n] + sum_{q >=
// s} dCB[q, s] C[q, n], heads in order; grid (nc, B).
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_dbc_small_kernel(const float* __restrict__ x,
                             const float* __restrict__ bm,
                             const float* __restrict__ cm,
                             const float* __restrict__ dy,
                             const float* __restrict__ entering,
                             const float* __restrict__ dst,
                             const float* __restrict__ acum,
                             const float* __restrict__ dcb,
                             float* __restrict__ db, float* __restrict__ dc,
                             int L, int H, int Q) {
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x, Qp = padded(Q);
  const int64_t row0 = static_cast<int64_t>(b) * L + int64_t{c} * Q;
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t bc = static_cast<int64_t>(b) * nc + c;
  const float* dcbc = dcb + bc * Qp * Qp;
  for (int e = threadIdx.x; e < 2 * Q * N; e += kThreads) {
    const bool is_db = e >= Q * N;
    const int r = (e % (Q * N)) / N, n = e % N;
    float v = 0.f;
    for (int h = 0; h < H; ++h) {
      const float a = __ldg(acum + (row0 + r) * H + h);
      const float f =
          expf(is_db ? __ldg(acum + (row0 + Q - 1) * H + h) - a : a);
      const float* st = (is_db ? dst : entering) + (bc * H + h) * P * N + n;
      const float* vr = (is_db ? x : dy) + (row0 + r) * xrow + h * P;
      float u = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p)
        u = fmaf(__ldg(vr + p), __ldg(st + p * N), u);
      v = fmaf(f, u, v);
    }
    if (is_db) {
      for (int q = r; q < Q; ++q)
        v = fmaf(dcbc[static_cast<int64_t>(q) * Qp + r],
                 __ldg(cm + (row0 + q) * N + n), v);
      db[(row0 + r) * N + n] = v;
    } else {
      for (int s = 0; s <= r; ++s)
        v = fmaf(dcbc[static_cast<int64_t>(r) * Qp + s],
                 __ldg(bm + (row0 + s) * N + n), v);
      dc[(row0 + r) * N + n] = v;
    }
  }
}

struct Args {
  const float *x, *dtA, *bm, *cm, *dy, *dfinal, *entering, *decay;
  float *dx, *ddtA, *db, *dc, *dinit, *cb, *dcb, *dchunk, *acum, *da_off;
  int B, L, H, Q, device;
  cudaStream_t stream;
};

// The reverse recurrence (launch 3), shared by both head sizes.
int launch_recurrence(const Args& a, int PN) {
  ssd_bwd_recurrence_kernel<<<dim3((PN / 4 + kThreads - 1) / kThreads, a.H,
                                   a.B),
                              kThreads, 0, a.stream>>>(
      a.dchunk, a.decay, a.dfinal, a.dinit, a.L / a.Q, a.H, PN);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(const Args& a) {
  const int nc = a.L / a.Q, n_sub = padded(a.Q) / kTile;
  if (2 * static_cast<int64_t>(nc) * a.B > 65535 || a.H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = a.stream;
  cudaError_t err;

  const size_t cb_bytes = 2 * pair_bytes<N>();
  if ((err = allow_shared(ssd_bwd_cb_kernel<N>, cb_bytes, a.device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_cb_kernel<N><<<dim3(n_sub * (n_sub + 1) / 2, nc, a.B), kThreads,
                         cb_bytes, s>>>(a.bm, a.cm, a.cb, a.L, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t ds_bytes = pair_bytes<kP>() + pair_bytes<64>() +
                          sizeof(float) * (kTile + padded(a.Q));
  if ((err = allow_shared(ssd_bwd_dstate_kernel<N>, ds_bytes, a.device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dstate_kernel<N><<<dim3(N / 64, a.H, nc * a.B), kThreads,
                             ds_bytes, s>>>(a.dy, a.dtA, a.cm, a.dchunk,
                                            a.acum, a.L, a.H, a.Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if (const int rc = launch_recurrence(a, kP * N)) return rc;

  const size_t dcb_bytes = 2 * pair_bytes<kP>() + sizeof(float) * 2 * kTile;
  if ((err = allow_shared(ssd_bwd_dcb_kernel, dcb_bytes, a.device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dcb_kernel<<<dim3(n_sub * (n_sub + 1) / 2, nc, a.B), kThreads,
                       dcb_bytes, s>>>(a.x, a.dy, a.acum, a.dcb, a.L, a.H,
                                       a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const size_t dbc_bytes =
      2 * pair_bytes<64>() +
      sizeof(float) * (kTile * kCLd + (kTile + 1) * a.H);
  if ((err = allow_shared(ssd_bwd_dbc_kernel<N>, dbc_bytes, a.device)) !=
      cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dbc_kernel<N><<<dim3(n_sub, N / 64, 2 * nc * a.B), kThreads,
                          dbc_bytes, s>>>(a.x, a.bm, a.cm, a.dy, a.entering,
                                          a.dchunk, a.acum, a.dcb, a.db,
                                          a.dc, a.da_off, a.L, a.H, a.Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if ((err = allow_shared(ssd_bwd_dx_kernel<N>, dx_smem_bytes(),
                          a.device)) != cudaSuccess)
    return static_cast<int>(err);
  ssd_bwd_dx_kernel<N><<<dim3(a.H, nc * a.B), kThreads, dx_smem_bytes(),
                         s>>>(a.x, a.bm, a.dy, a.entering, a.decay, a.dchunk,
                              a.cb, a.acum, a.da_off, a.dx, a.ddtA, a.L, a.H,
                              a.Q, nc);
  return static_cast<int>(cudaGetLastError());
}

// The six small-(P, N) launches, with the scratch of launch<N>.
template <int P, int N>
int launch_small(const Args& a) {
  const int nc = a.L / a.Q;
  if (static_cast<int64_t>(nc) * a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = a.stream;
  ssd_bwd_cb_small_kernel<N><<<dim3(nc, a.B), kThreads, 0, s>>>(
      a.bm, a.cm, a.cb, a.L, a.Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dstate_small_kernel<P, N><<<dim3(a.H, nc * a.B), kThreads, 0, s>>>(
      a.dy, a.dtA, a.cm, a.dchunk, a.acum, a.L, a.H, a.Q, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (const int rc = launch_recurrence(a, P * N)) return rc;
  ssd_bwd_dcb_small_kernel<P><<<dim3(nc, a.B), kThreads, 0, s>>>(
      a.x, a.dy, a.acum, a.dcb, a.L, a.H, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_small_kernel<P, N><<<dim3(nc, a.B), kThreads, 0, s>>>(
      a.x, a.bm, a.cm, a.dy, a.entering, a.dchunk, a.acum, a.dcb, a.db,
      a.dc, a.L, a.H, a.Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dx_small_kernel<P, N><<<dim3(a.H, nc * a.B), kThreads, 0, s>>>(
      a.x, a.bm, a.cm, a.dy, a.entering, a.decay, a.dchunk, a.cb, a.acum,
      a.dx, a.ddtA, a.L, a.H, a.Q, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (P, N) pairs compiled, as for the forward (SHAPES in
// kernels/ssd_scan/ops.py): (64, 128) mamba2, (64, 64) zamba2 on the tensor
// cores, (16, 16) the smoke configs on the CUDA cores. The scratch comes
// from the caller, all float32, 16-byte aligned, nc = L / chunk, Qp =
// chunk rounded up to 64: cb and dcb [B, nc, Qp, Qp], dchunk [B, nc, H, P,
// N], acum [B, L, H] and da_off [N / 64, B, L, H] (unused at P = N = 16).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dtA, const void* b, const void* c,
    const void* dy, const void* dfinal, const void* entering,
    const void* decay, void* dx, void* ddtA, void* db, void* dc, void* dinit,
    void* cb, void* dcb, void* dchunk, void* acum, void* da_off, int B, int L,
    int H, int P, int N, int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto w = [](void* p) { return static_cast<float*>(p); };
  const Args a{f(x),      f(dtA),      f(b),      f(c),      f(dy),
               f(dfinal), f(entering), f(decay),  w(dx),     w(ddtA),
               w(db),     w(dc),       w(dinit),  w(cb),     w(dcb),
               w(dchunk), w(acum),     w(da_off), B,         L,
               H,         chunk,       device,
               static_cast<cudaStream_t>(stream)};
  if (P == 16 && N == 16) return launch_small<16, 16>(a);
  if (P != kP) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 64) return launch<64>(a);
  if (N == 128) return launch<128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
