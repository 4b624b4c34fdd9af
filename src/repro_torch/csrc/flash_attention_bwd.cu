// B5 and B6: the flash-attention backward, hand-written for Hopper (sm_90a).
//
// Replaces flash_attention_bwd of the JAX reference
// (src/repro/kernels/flash_attention/backward.py): _dq_kernel (B5) and
// _dkv_kernel (B6), the FlashAttention-2 split. From the forward's saved
// float32 logsumexp lse [B, Hq, Sq] and D = rowsum(dO * O) [B, Hq, Sq]
// (computed in PyTorch before the launch, as the reference computes it in
// jnp), for q, dO [B, Sq, Hq, hd] and k, v [B, Skv, Hkv, hd]:
//
//   P  = exp(scale * q k^T - lse)   only where the mask lets a key be seen
//   dV = P^T dO,  dS = P * (dO v^T - D),  dQ = scale * dS k,
//   dK = scale * dS^T q,  the G = Hq / Hkv query heads of a group summed
//   into their KV head.
//
// Visible means kpos < Skv, kpos <= qpos when causal and kpos > qpos -
// window when a window is set (positions from 0). The mask is applied to P
// itself: a query row that sees no key has a finite lse (kSafe +
// log(1e-30)) from the forward, so exp() would not underflow there.
//
// What bounds it: at the training shape (Sq = Skv = 1024, hd = 64) B5 does
// three and B6 four products per visible (query, key) pair, about 100
// operations per byte they must move, so the tensor cores are the limit.
//
// The float32 kernels run their products on the CUDA cores in float32
// (TF32 would not hold the float32 tolerance). B5
// (flash_attention_dq_kernel): one block of 256 threads per (64-query
// tile, query head, batch row) walks the 64-key tiles its masks leave
// visible, holding its dQ tile in registers. B6
// (flash_attention_dkv_kernel): one block per (64-key tile, KV head, batch
// row) loops over the G query heads of the group and the visible 64-query
// tiles and holds dK and dV in registers. Tiles are staged in shared
// memory as float32, rows padded to hd + 1 floats so the row-parallel
// reads hit distinct banks. Thread (ty, tx) of the 16 x 16 layout owns
// rows 4ty..4ty+3 of the output tile and columns tx + 16c; it computes the
// 4 x 4 scores of its rows against columns tx + 16j and hands P and dS to
// the products through shared memory rows that only its 16 lanes write
// and read.
//
// The bf16 kernels run their products on the tensor cores: mma.sync
// m16n8k16 bf16 x bf16 -> f32 with ldmatrix fragment loads
// (attention_mma.cuh; wgmma is the faster Hopper-only instruction, and
// these versions keep to mma.sync, whose register fragments carry P, dS
// and their transposes from one product into the next). The float32 P and
// dS enter the second product as bf16 terms, hi = bf16(x), lo = bf16(x -
// hi) and so on, each multiplied into the same float32 accumulator: one
// bf16 term alone would move dQ, dK and dV by thousands of bf16 ulps. The
// tensor cores' float32 accumulation truncates where a float32 add
// rounds: chained over the hundreds of chunks that one output element
// sums at the training length, it moved bf16 dV 11.5 ulps from the plain
// version on the card. So each 16-row chunk's products go into a zeroed
// fragment, and that joins the running float32 output with ordinary adds.
// The masks are applied at each element's (query, key) position from the
// fragment layout, on the tiles that straddle an edge only.
//
// The bf16 B5 (flash_attention_dq_mma_kernel): the same owner as the
// float32 one, one block per (64-query tile, query head, batch row), four
// warps of 16 query rows each. The q and dO tiles load once; the K and V
// tiles come through a two-stage cp.async ring, so key tile j + 1 loads
// while j computes. lse and D of a thread's two rows sit in registers. Per
// key tile: S = q k^T and dP = dO v^T from bf16 operands (exact products
// in the float32 accumulator); P = exp(scale S - lse) where the masks let
// a key be seen, else 0; dS = P (dP - D) in place of S; then dQ += dS k,
// the two C tiles of 16 keys forming one A fragment (the forward's P v
// with dS for P and K for V). dS takes two terms: a CPU emulation of this
// arithmetic held dQ within 1 bf16 ulp of the float32 formulas with two,
// also with q scaled by 8, since dQ's sum over keys does not cancel the
// way dK's sum over queries does. That makes four products per tile
// instead of three. A key tile is taken in two passes of 32 keys (one at
// hd = 32), and the q and dO fragments are loaded from shared memory for
// each pass, so that the float32 dQ accumulator, S and dP fit in the
// registers.
//
// The bf16 B6 (flash_attention_dkv_mma_kernel): the same owner as the
// float32 one, one block per (64-key tile, KV head, batch row), four warps
// of 16 key rows each; at hd = 128 a second group of four warps takes the
// upper half of the dK/dV columns, so that no thread holds two 64 x 128
// float32 accumulators. The K and V tiles stay in shared memory; the (q,
// dO) tiles and their lse and D rows come through a two-stage cp.async
// ring, so the next query tile loads while this one computes. Per query
// tile, in two halves of 32 queries (a thread holds 32 queries' scores at
// a time, which keeps the registers from spilling): S^T = k q^T and dP^T =
// v dO^T; P^T and dS^T = P^T (dP^T - D) in place; then dV += P^T dO and
// dK += dS^T q. P^T takes two terms. dS^T takes three: it has both signs,
// and where the scores are large (q scaled by 8) the sum over the queries
// in dK cancels so far that two terms left dK 4.5-18.5 bf16 ulps from the
// float32 formulas in a CPU emulation, three within 1. That makes seven
// products per tile instead of four.
//
// Every kernel writes each block's own rows once: no atomics, and the
// result does not depend on scheduling (the checkpoint resume check and
// the determinism tests ask for bit equality). The bf16 grids run the
// heaviest blocks first under a causal mask: B5's last query tile, which
// walks the most key tiles, and B6's first key tile, which the most query
// tiles see.
//
// Interface: plain C entry points loaded with ctypes. They launch on the
// stream they are given, do not synchronise, allocate nothing and return
// cudaGetLastError() (0 on success).

#include <type_traits>

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kPLD = 65;  // padded row of a [64, 64] score tile

template <int HD>
constexpr size_t dq_shared_bytes() {
  // q, dO, k, v tiles padded to hd + 1; dS
  return sizeof(float) * (4 * 64 * (HD + 1) + kBlockQ * kPLD);
}

template <int HD>
constexpr size_t dkv_shared_bytes() {
  // k, v, q, dO tiles padded to hd + 1; P and dS; lse and D of the q tile
  return sizeof(float) * (4 * 64 * (HD + 1) + 2 * kBlockKV * kPLD +
                          2 * kBlockQ);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Skv,
                                        int causal, int window) {
  bool ok = qpos < Sq && kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ---------------------------------------------------------------------------
// B5 in float32: dQ on the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              float* __restrict__ dq, int Sq, int Skv,
                              int Hq, int Hkv, int causal, int window,
                              float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = HD + 1;
  constexpr int OC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                  // [kBlockQ][LD]
  float* sdo = sq + kBlockQ * LD;    // [kBlockQ][LD]
  float* sk = sdo + kBlockQ * LD;    // [kBlockKV][LD]
  float* sv = sk + kBlockKV * LD;    // [kBlockKV][LD]
  float* sds = sv + kBlockKV * LD;   // [kBlockQ][kPLD]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);

  const int64_t qoff = ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * HD;
  attn::load_tiles<float, HD, kBlockQ, kThreads>(
      sq, LD, q + qoff, sdo, LD, dout + qoff, static_cast<int64_t>(Hq) * HD,
      min(kBlockQ, Sq - q0));

  const int64_t row0 = (static_cast<int64_t>(b) * Hq + h) * Sq;
  float rl[4], rd[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    rl[i] = qi < Sq ? lse[row0 + qi] : 0.f;
    rd[i] = qi < Sq ? dsum[row0 + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // The key tiles this query tile sees: up to its last row when causal,
  // from its first row's window start when windowed.
  const int kv_end = causal ? min(Skv, q0 + kBlockQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_end = (kv_end + kBlockKV - 1) / kBlockKV;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * HD;

  for (int j = kv_begin / kBlockKV; j < j_end; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's k/v and dS reads are done
    const int64_t off =
        ((static_cast<int64_t>(b) * Skv + k0) * Hkv + kvh) * HD;
    attn::load_tiles<float, HD, kBlockKV, kThreads>(
        sk, LD, k + off, sv, LD, v + off, kv_stride, min(kBlockKV, Skv - k0));
    __syncthreads();

    // S = q k^T and dP = dO v^T for rows 4ty.., keys tx + 16jj
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qa[4], oa[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sq[(ty * 4 + i) * LD + d];
        oa[i] = sdo[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        ka[jj] = sk[(tx + 16 * jj) * LD + d];
        va[jj] = sv[(tx + 16 * jj) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
          dp[i][jj] = fmaf(oa[i], va[jj], dp[i][jj]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        const float p = visible(qpos, kpos, Sq, Skv, causal, window)
                            ? expf(s[i][jj] * scale - rl[i])
                            : 0.f;
        sds[(ty * 4 + i) * kPLD + tx + 16 * jj] = p * (dp[i][jj] - rd[i]);
      }
    }
    // A row's dS was written by the 16 lanes that read it.
    __syncwarp();

    // dQ += dS k
#pragma unroll 4
    for (int kk = 0; kk < kBlockKV; ++kk) {
      float da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sds[(ty * 4 + i) * kPLD + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kb = sk[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(da[i], kb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    float* row = dq + ((static_cast<int64_t>(b) * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) row[tx + 16 * c] = acc[i][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// B5 in bf16: dQ on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarpRows = 4;  // warps of 16 rows each (query or key)
constexpr int kDqMmaThreads = 32 * kMmaWarpRows;

// Keys of a 64-key tile that one pass takes: from hd = 64 on two halves of
// 32, so that the dQ accumulator (32 floats a thread at hd = 64, 64 at
// hd = 128) and the pass's S and dP fit in the registers together; the
// whole tile at hd = 32. ptxas -v on the card: a whole tile spilled at
// hd = 128, halves spilled 16 bytes at hd = 32, and holding the q and dO
// fragments in registers spilled at hd = 64, so they are loaded from
// shared memory for each product instead.
template <int HD>
__host__ __device__ constexpr int dq_keys_per_pass() {
  return HD == 32 ? 64 : 32;
}

template <int HD>
constexpr size_t dq_mma_shared_bytes() {
  // the q and dO tiles and a two-stage ring of (K, V) tiles, bf16
  return sizeof(__nv_bfloat16) * 6 * 64 * mma::row_elems<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kDqMmaThreads)
    flash_attention_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ dsum,
                                  __nv_bfloat16* __restrict__ dq, int Sq,
                                  int Skv, int Hq, int Hkv, int causal,
                                  int window, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = mma::row_elems<HD>();
  constexpr int TILE = 64 * LD;
  constexpr int KC = HD / 16;   // k-chunks of q k^T and dO v^T
  constexpr int NO = HD / 8;    // n-tiles of dQ
  constexpr int KP = dq_keys_per_pass<HD>();
  constexpr int NS = KP / 8;    // n-tiles of a pass's S and dP
  static_assert(NO % 2 == 0, "columns come in pairs of n-tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + TILE;
  __nv_bfloat16* skv = sdo + TILE;  // stage s: K at skv + 2s TILE, then V

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;  // last tile first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // The key tiles this query tile sees: up to its last row when causal,
  // from its first row's window start when windowed.
  const int kv_end = causal ? min(Skv, q0 + kBlockQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_begin = kv_begin / kBlockKV;
  const int j_end = (kv_end + kBlockKV - 1) / kBlockKV;
  const int64_t q_stride = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Skv * kv_stride + kvh * HD;
  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kBlockKV;
    __nv_bfloat16* dst = skv + 2 * stage * TILE;
    mma::load_tile_async<HD, kDqMmaThreads>(dst, k + kv_base + k0 * kv_stride,
                                            kv_stride,
                                            min(kBlockKV, Skv - k0));
    mma::load_tile_async<HD, kDqMmaThreads>(dst + TILE,
                                            v + kv_base + k0 * kv_stride,
                                            kv_stride,
                                            min(kBlockKV, Skv - k0));
  };

  const int64_t qoff = (static_cast<int64_t>(b) * Sq + q0) * q_stride + h * HD;
  mma::load_tile_async<HD, kDqMmaThreads>(sq, q + qoff, q_stride,
                                          min(kBlockQ, Sq - q0));
  mma::load_tile_async<HD, kDqMmaThreads>(sdo, dout + qoff, q_stride,
                                          min(kBlockQ, Sq - q0));
  if (j_begin < j_end) load_kv(j_begin, 0);
  mma::cp_async_commit();

  // lse and D of rows g and g + 8 of the warp's 16, and dQ's n-tiles in
  // the C layout
  float rl[2], rd[2];
  const int64_t row0 = (static_cast<int64_t>(b) * Hq + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    rl[r] = qi < Sq ? lse[row0 + qi] : 0.f;
    rd[r] = qi < Sq ? dsum[row0 + qi] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      load_kv(j + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, the first time, q and dO) landed
    const __nv_bfloat16* sk = skv + 2 * stage * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    const int k0 = j * kBlockKV;
    const bool edge = q0 + kBlockQ > Sq || k0 + kBlockKV > Skv ||
                      (causal && k0 + kBlockKV - 1 > q0) ||
                      (window > 0 && q0 + kBlockQ - 1 - window >= k0);

#pragma unroll 1
    for (int kp = 0; kp < kBlockKV; kp += KP) {
      // S = q k^T and dP = dO v^T: the warp's 16 rows x KP keys
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t aq[4], ao[4];
        mma::load_a(aq, sq, LD, warp * 16, kc * 16);
        mma::load_a(ao, sdo, LD, warp * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4], bv[4];
          mma::load_b_nk(bk, sk, LD, kp + np * 16, kc * 16);
          mma::load_b_nk(bv, sv, LD, kp + np * 16, kc * 16);
          mma::mma_bf16(s[2 * np], aq, bk[0], bk[1]);
          mma::mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
          mma::mma_bf16(dp[2 * np], ao, bv[0], bv[1]);
          mma::mma_bf16(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }

      // P, then dS in place of S; element e of n-tile n is (row warp * 16
      // + g + 8(e / 2), key kp + 8n + 2t + e % 2)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok =
              !edge || visible(q0 + warp * 16 + g + 8 * r,
                               k0 + kp + 8 * n + 2 * t + (e & 1), Sq, Skv,
                               causal, window);
          const float p = ok ? expf(s[n][e] * scale - rl[r]) : 0.f;
          s[n][e] = p * (dp[n][e] - rd[r]);
        }

      // dQ += dS k with dS as two bf16 terms, 16 keys per k-chunk; the
      // chunk's terms go into zeroed fragments, which join the running
      // sums by float32 adds (see the note at the top)
#pragma unroll
      for (int kc = 0; kc < KP / 16; ++kc) {
        uint32_t da[2][4];
        mma::split_a<2>(s[2 * kc], s[2 * kc + 1], da);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bk[4];
          mma::load_b_kn(bk, sk, LD, kp + kc * 16, np * 16);
          float tq[2][4] = {};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            mma::mma_bf16(tq[0], da[x], bk[0], bk[1]);
            mma::mma_bf16(tq[1], da[x], bk[2], bk[3]);
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[2 * np + hh][e] += tq[hh][e];
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* row =
        dq + (static_cast<int64_t>(b) * Sq + qi) * q_stride + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r] * scale,
                                acc[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// B6 in float32: dK and dV on the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int Sq, int Skv, int Hq, int Hkv, int causal,
                               int window, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = HD + 1;
  constexpr int OC = HD / 16;
  extern __shared__ float smem[];
  float* sk = smem;                  // [kBlockKV][LD]
  float* sv = sk + kBlockKV * LD;    // [kBlockKV][LD]
  float* sq = sv + kBlockKV * LD;    // [kBlockQ][LD]
  float* sdo = sq + kBlockQ * LD;    // [kBlockQ][LD]
  float* sp = sdo + kBlockQ * LD;    // [kBlockKV][kPLD]  P^T
  float* sds = sp + kBlockKV * kPLD; // [kBlockKV][kPLD]  dS^T
  float* slse = sds + kBlockKV * kPLD;  // [kBlockQ]
  float* sd = slse + kBlockQ;           // [kBlockQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBlockKV;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int n_k = min(kBlockKV, Skv - k0);

  const int64_t kvoff =
      ((static_cast<int64_t>(b) * Skv + k0) * Hkv + kvh) * HD;
  attn::load_tiles<float, HD, kBlockKV, kThreads>(
      sk, LD, k + kvoff, sv, LD, v + kvoff, static_cast<int64_t>(Hkv) * HD,
      n_k);

  float acc_k[4][OC], acc_v[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // The query tiles that see any key of this tile: from its first key on
  // when causal, up to its last key + window - 1 when windowed.
  const int last_k = k0 + n_k - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, last_k + window) : Sq;
  const int i_begin = q_begin / kBlockQ;
  const int i_end = (q_end + kBlockQ - 1) / kBlockQ;
  const int64_t q_stride = static_cast<int64_t>(Hq) * HD;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t row0 = (static_cast<int64_t>(b) * Hq + h) * Sq;
    for (int i = i_begin; i < i_end; ++i) {
      const int q0 = i * kBlockQ;
      __syncthreads();  // the previous q tile's reads are done
      const int64_t qoff =
          ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * HD;
      attn::load_tiles<float, HD, kBlockQ, kThreads>(
          sq, LD, q + qoff, sdo, LD, dout + qoff, q_stride,
          min(kBlockQ, Sq - q0));
      if (tid < kBlockQ) {
        const int qi = q0 + tid;
        slse[tid] = qi < Sq ? lse[row0 + qi] : 0.f;
        sd[tid] = qi < Sq ? dsum[row0 + qi] : 0.f;
      }
      __syncthreads();

      // S^T = k q^T and dP^T = v dO^T for key rows 4ty.., queries tx + 16jj
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[r][jj] = dp[r][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float ka[4], va[4], qa[4], oa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = sk[(ty * 4 + r) * LD + d];
          va[r] = sv[(ty * 4 + r) * LD + d];
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          qa[jj] = sq[(tx + 16 * jj) * LD + d];
          oa[jj] = sdo[(tx + 16 * jj) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[r][jj] = fmaf(ka[r], qa[jj], s[r][jj]);
            dp[r][jj] = fmaf(va[r], oa[jj], dp[r][jj]);
          }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + ty * 4 + r;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int c = tx + 16 * jj;
          const float p = visible(q0 + c, kpos, Sq, Skv, causal, window)
                              ? expf(s[r][jj] * scale - slse[c])
                              : 0.f;
          sp[(ty * 4 + r) * kPLD + c] = p;
          sds[(ty * 4 + r) * kPLD + c] = p * (dp[r][jj] - sd[c]);
        }
      }
      // A key row's P and dS were written by the 16 lanes that read them.
      __syncwarp();

      // dV += P^T dO, dK += dS^T q
#pragma unroll 4
      for (int qq = 0; qq < kBlockQ; ++qq) {
        float pa[4], da[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[r] = sp[(ty * 4 + r) * kPLD + qq];
          da[r] = sds[(ty * 4 + r) * kPLD + qq];
        }
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const float ob = sdo[qq * LD + tx + 16 * c];
          const float qb = sq[qq * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc_v[r][c] = fmaf(pa[r], ob, acc_v[r][c]);
            acc_k[r][c] = fmaf(da[r], qb, acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kr = k0 + ty * 4 + r;
    if (kr >= Skv) continue;
    const int64_t off = ((static_cast<int64_t>(b) * Skv + kr) * Hkv + kvh) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dk[off + tx + 16 * c] = acc_k[r][c] * scale;
      dv[off + tx + 16 * c] = acc_v[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// B6 in bf16: dK and dV on the tensor cores
// ---------------------------------------------------------------------------

// Groups of four warps that share the dK/dV columns: two at hd = 128.
template <int HD>
__host__ __device__ constexpr int dkv_col_groups() {
  return HD == 128 ? 2 : 1;
}

template <int HD>
__host__ __device__ constexpr int dkv_mma_threads() {
  return 32 * kMmaWarpRows * dkv_col_groups<HD>();
}

template <int HD>
constexpr size_t dkv_mma_shared_bytes() {
  // k and v tiles and a two-stage ring of (q, dO) tiles, bf16; the lse and
  // D rows of each stage's 64 queries, float32
  return sizeof(__nv_bfloat16) * 6 * 64 * mma::row_elems<HD>() +
         sizeof(float) * 2 * 2 * kBlockQ;
}

template <int HD>
__global__ void __launch_bounds__(dkv_mma_threads<HD>())
    flash_attention_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ dsum,
                                   __nv_bfloat16* __restrict__ dk,
                                   __nv_bfloat16* __restrict__ dv, int Sq,
                                   int Skv, int Hq, int Hkv, int causal,
                                   int window, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int NT = dkv_mma_threads<HD>();
  constexpr int LD = mma::row_elems<HD>();
  constexpr int TILE = 64 * LD;
  constexpr int KC = HD / 16;                      // k-chunks of k q^T
  constexpr int CW = HD / dkv_col_groups<HD>();    // dK/dV columns a warp
  constexpr int NO = CW / 8;                       // of them, in n-tiles
  static_assert(NO % 2 == 0, "columns come in pairs of n-tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + TILE;
  __nv_bfloat16* sqd = sv + TILE;  // stage s: q at sqd + 2s TILE, then dO
  // stage s: the lse row at srow + 128 s, the D row 64 floats after it
  float* srow = reinterpret_cast<float*>(sqd + 4 * TILE);

  const int k0 = blockIdx.z * kBlockKV;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int n_k = min(kBlockKV, Skv - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % kMmaWarpRows, c0 = (warp / kMmaWarpRows) * CW;
  const int g = lane >> 2, t = lane & 3;

  // The query tiles that see any key of this tile: from its first key on
  // when causal, up to its last key + window - 1 when windowed; walked for
  // each of the G query heads in turn.
  const int last_k = k0 + n_k - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, last_k + window) : Sq;
  const int i_begin = q_begin / kBlockQ;
  const int n_i = max(0, (q_end + kBlockQ - 1) / kBlockQ - i_begin);
  const int n_iter = G * n_i;
  const int64_t q_stride = static_cast<int64_t>(Hq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * HD;

  auto load_q = [&](int it, int stage) {
    const int h = kvh * G + it / n_i;
    const int q0 = (i_begin + it % n_i) * kBlockQ;
    const int64_t off = (static_cast<int64_t>(b) * Sq + q0) * q_stride +
                        h * HD;
    __nv_bfloat16* dst = sqd + 2 * stage * TILE;
    mma::load_tile_async<HD, NT>(dst, q + off, q_stride,
                                 min(kBlockQ, Sq - q0));
    mma::load_tile_async<HD, NT>(dst + TILE, dout + off, q_stride,
                                 min(kBlockQ, Sq - q0));
    if (threadIdx.x < 2 * kBlockQ) {  // lse by threads 0..63, D by 64..127
      const int r = threadIdx.x % kBlockQ;
      const float* src = threadIdx.x < kBlockQ ? lse : dsum;
      const int64_t row = (static_cast<int64_t>(b) * Hq + h) * Sq + q0 + r;
      const bool in = q0 + r < Sq;
      mma::cp_async4(srow + 2 * kBlockQ * stage + threadIdx.x,
                     in ? src + row : src, in ? 4 : 0);
    }
  };

  if (n_iter > 0) {
    const int64_t off = (static_cast<int64_t>(b) * Skv + k0) * kv_stride +
                        kvh * HD;
    mma::load_tile_async<HD, NT>(sk, k + off, kv_stride, n_k);
    mma::load_tile_async<HD, NT>(sv, v + off, kv_stride, n_k);
    load_q(0, 0);
    mma::cp_async_commit();
  }

  // dK and dV of the warp's 16 key rows and CW columns, in the C layout
  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iter) {
      load_q(it + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and, the first time, k and v) landed
    const int q0 = (i_begin + it % n_i) * kBlockQ;
    const __nv_bfloat16* sq = sqd + 2 * stage * TILE;
    const __nv_bfloat16* sdo = sq + TILE;
    const float* slse = srow + 2 * kBlockQ * stage;
    const float* sd = slse + kBlockQ;

    const bool edge = q0 + kBlockQ > Sq || k0 + kBlockKV > Skv ||
                      (causal && q0 < k0 + kBlockKV - 1) ||
                      (window > 0 && q0 + kBlockQ - 1 - window >= k0);
    // The tile's queries in two halves of 32, one after the other, so that
    // a thread holds the scores of 32 queries at a time.
#pragma unroll 1
    for (int qh = 0; qh < kBlockQ; qh += kBlockQ / 2) {
      // S^T = k q^T and dP^T = v dO^T: the warp's 16 keys x 32 queries
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ak[4], av[4];
        mma::load_a(ak, sk, LD, wr * 16, kc * 16);
        mma::load_a(av, sv, LD, wr * 16, kc * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bq[4], bo[4];
          mma::load_b_nk(bq, sq, LD, qh + np * 16, kc * 16);
          mma::load_b_nk(bo, sdo, LD, qh + np * 16, kc * 16);
          mma::mma_bf16(st[2 * np], ak, bq[0], bq[1]);
          mma::mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
          mma::mma_bf16(dpt[2 * np], av, bo[0], bo[1]);
          mma::mma_bf16(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }

      // P^T and dS^T in place; element e of n-tile n is (key row wr * 16
      // + g + 8(e / 2), query qh + 8n + 2t + e % 2)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qh + 8 * n + 2 * t + (e & 1);
          const bool ok =
              !edge || visible(q0 + qc, k0 + wr * 16 + g + 8 * (e >> 1), Sq,
                               Skv, causal, window);
          const float p = ok ? expf(st[n][e] * scale - slse[qc]) : 0.f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - sd[qc]);
        }

      // dV += P^T dO with P^T as two bf16 terms, dK += dS^T q with dS^T
      // as three; 16 queries per k-chunk
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t pa[2][4], da[3][4];
        mma::split_a<2>(st[2 * kc], st[2 * kc + 1], pa);
        mma::split_a<3>(dpt[2 * kc], dpt[2 * kc + 1], da);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t bo[4], bq[4];
          mma::load_b_kn(bo, sdo, LD, qh + kc * 16, c0 + np * 16);
          mma::load_b_kn(bq, sq, LD, qh + kc * 16, c0 + np * 16);
          // the chunk's terms go into zeroed fragments, which join the
          // running sums by float32 adds (see the note at the top)
          float tv[2][4] = {}, tk[2][4] = {};
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            mma::mma_bf16(tv[0], pa[x], bo[0], bo[1]);
            mma::mma_bf16(tv[1], pa[x], bo[2], bo[3]);
          }
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            mma::mma_bf16(tk[0], da[x], bq[0], bq[1]);
            mma::mma_bf16(tk[1], da[x], bq[2], bq[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_v[2 * np + h][e] += tv[h][e];
              acc_k[2 * np + h][e] += tk[h][e];
            }
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = k0 + wr * 16 + g + 8 * r;
    if (kr >= Skv) continue;
    const int64_t off = (static_cast<int64_t>(b) * Skv + kr) * kv_stride +
                        kvh * HD + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(acc_k[n][2 * r] * scale,
                                acc_k[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *lse, *dsum;
  void *dq, *dk, *dv;
  int B, Sq, Skv, Hq, Hkv, causal, window;
};

// B5 at head dim HD: the tensor-core kernel for bf16, the CUDA-core kernel
// for float32.
template <typename T, int HD>
int launch_dq(const Args& a, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int n_q = (a.Sq + kBlockQ - 1) / kBlockQ;
  cudaError_t err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    auto kernel = flash_attention_dq_mma_kernel<HD>;
    constexpr size_t bytes = dq_mma_shared_bytes<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.Hq, a.B, n_q), kDqMmaThreads, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
        static_cast<T*>(a.dq), a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window,
        scale);
  } else {
    auto kernel = flash_attention_dq_kernel<HD>;
    constexpr size_t bytes = dq_shared_bytes<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_q, a.Hq, a.B), kThreads, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
        static_cast<T*>(a.dq), a.Sq, a.Skv, a.Hq, a.Hkv, a.causal, a.window,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6 at head dim HD: the tensor-core kernel for bf16, the CUDA-core kernel
// for float32.
template <typename T, int HD>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int n_k = (a.Skv + kBlockKV - 1) / kBlockKV;
  cudaError_t err;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    auto kernel = flash_attention_dkv_mma_kernel<HD>;
    constexpr size_t bytes = dkv_mma_shared_bytes<HD>();
    constexpr int threads = dkv_mma_threads<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(a.Hkv, a.B, n_k), threads, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Skv, a.Hq,
        a.Hkv, a.causal, a.window, scale);
  } else {
    auto kernel = flash_attention_dkv_kernel<HD>;
    constexpr size_t bytes = dkv_shared_bytes<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_k, a.Hkv, a.B), kThreads, bytes, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Skv, a.Hq,
        a.Hkv, a.causal, a.window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (dtype, head dim): which = 0 launches B5, 1 launches B6.
template <typename T>
int launch_hd(int which, int hd, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 32:
      return which ? launch_dkv<T, 32>(a, s) : launch_dq<T, 32>(a, s);
    case 64:
      return which ? launch_dkv<T, 64>(a, s) : launch_dq<T, 64>(a, s);
    case 80:
      return which ? launch_dkv<T, 80>(a, s) : launch_dq<T, 80>(a, s);
    case 128:
      return which ? launch_dkv<T, 128>(a, s) : launch_dq<T, 128>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_any(int which, const Args& a, int hd, int is_bf16, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.B <= 0 || a.Sq <= 0 || a.Skv <= 0 || a.Hq <= 0 || a.Hkv <= 0 ||
      a.Hq % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(which, hd, a, s)
                 : launch_hd<float>(which, hd, a, s);
}

}  // namespace

extern "C" int flash_attention_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq, int B, int Sq, int Skv,
    int Hq, int Hkv, int hd, int is_bf16, int causal, int window, int device,
    void* stream) {
  const Args a{q,  k,  v,  dout, lse, dsum, dq,     nullptr, nullptr,
               B,  Sq, Skv, Hq,  Hkv, causal, window};
  return launch_any(0, a, hd, is_bf16, device, stream);
}

extern "C" int flash_attention_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv, int B, int Sq,
    int Skv, int Hq, int Hkv, int hd, int is_bf16, int causal, int window,
    int device, void* stream) {
  const Args a{q,  k,  v,  dout, lse, dsum, nullptr, dk,     dv,
               B,  Sq, Skv, Hq,  Hkv, causal, window};
  return launch_any(1, a, hd, is_bf16, device, stream);
}
