// B4: flash-attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces flash_attention / _flash_kernel of the JAX reference
// (src/repro/kernels/flash_attention/flash_attention.py), and computes what
// it computes: for q [B, Sq, Hq, hd] and k, v [B, Skv, Hkv, hd] (query head
// h reads KV head h / G, G = Hq / Hkv), the softmax of scale * q k^T over
// the visible keys, times v, plus the float32 logsumexp [B, Hq, Sq].
// Visible means kpos < Skv, kpos <= qpos when causal, and kpos > qpos -
// window when a window is set; positions run from 0 (prefill). A tanh
// softcap applies to the scaled scores before the mask. The online softmax
// keeps the reference's float32 running (max, sum, acc) with its kNeg /
// kSafe sentinels; key tiles that are wholly masked are never visited.
//
// What bounds it: at the prefill shapes (Sq = Skv = 1024, hd = 64) it does
// about 128 operations per byte it must move, so the tensor cores are the
// limit.
//
// bfloat16 (flash_attention_fwd_mma_kernel): the tile products run on the
// tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32 with ldmatrix
// fragment loads (attention_mma.cuh). wgmma, the Hopper-only warpgroup
// product, is the faster instruction; this version keeps to mma.sync,
// whose register fragments let P go from the score accumulator into the
// next product directly. One block of four warps per (64-query tile, query
// head, batch row); each warp owns 16 query rows. The query tile and a
// two-stage ring of 64-key K/V tiles sit in shared memory as padded bf16
// rows, filled by cp.async so that tile j + 1 loads while tile j computes.
// S = q k^T takes bf16 operands whose products a float32 accumulator holds
// exactly. P = exp(S - m) is float32, and rounding it to one bf16 term
// would move the output by hundreds of bf16 ulps; so P enters P v as two
// bf16 terms, hi = bf16(P) and lo = bf16(P - hi), both multiplied into the
// same float32 accumulator (three products per key tile instead of two),
// which holds the output within 2 bf16 ulps of the float32 formulas. The
// row sum is taken from the unrounded P. Masks are applied at each
// element's (query, key) position, read from the fragment layout, on the
// tiles that straddle a mask edge only. The grid's slowest axis runs over
// the query tiles from the last one down, so that under a causal mask the
// blocks with the most key tiles start first.
//
// float32 (flash_attention_fwd_kernel): the products stay float32 FMAs on
// the CUDA cores (TF32 would not hold the float32 tolerance). One block of
// 256 threads per (64-query tile, query head, batch row); the tiles are
// staged in shared memory as float32 rows padded to hd + 1, and thread
// (ty, tx) of the 16 x 16 layout owns query rows 4ty..4ty+3, scores the
// keys tx + 16j and accumulates output columns tx + 16c in registers.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;

template <int HD>
constexpr size_t flash_shared_bytes() {
  // q and k tiles padded to hd + 1, v tile, probabilities padded to 65
  return sizeof(float) * (kBlockQ * (HD + 1) + kBlockKV * (HD + 1) +
                          kBlockKV * HD + kBlockQ * (kBlockKV + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse, int Sq, int Skv,
                               int Hq, int Hkv, int causal, int window,
                               float softcap, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = HD + 1;
  constexpr int PLD = kBlockKV + 1;
  constexpr int OC = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                  // [kBlockQ][LD]
  float* sk = sq + kBlockQ * LD;     // [kBlockKV][LD]
  float* sv = sk + kBlockKV * LD;    // [kBlockKV][HD]
  float* sp = sv + kBlockKV * HD;    // [kBlockQ][PLD]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);

  attn::load_tiles<float, HD, kBlockQ, kThreads>(
      sq, LD, q + ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * HD,
      nullptr, 0, nullptr, static_cast<int64_t>(Hq) * HD,
      min(kBlockQ, Sq - q0));

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = attn::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // The key tiles this query tile needs: up to its last row when causal,
  // from its first row's window start when windowed.
  const int kv_end = causal ? min(Skv, q0 + kBlockQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_end = (kv_end + kBlockKV - 1) / kBlockKV;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * HD;

  for (int j = kv_begin / kBlockKV; j < j_end; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's k/v reads are done
    const int64_t off = ((static_cast<int64_t>(b) * Skv + k0) * Hkv + kvh) * HD;
    attn::load_tiles<float, HD, kBlockKV, kThreads>(
        sk, LD, k + off, sv, HD, v + off, kv_stride, min(kBlockKV, Skv - k0));
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ka[jj] = sk[(tx + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = attn::kNeg;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kpos = k0 + tx + 16 * jj;
        float x = s[i][jj] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kpos < Skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][jj] = ok ? x : attn::kNeg;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, attn::kSafe);
      const float corr = m[i] > 0.5f * attn::kNeg
                             ? expf(fmaxf(m[i], attn::kSafe) - m_safe)
                             : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_safe);
        sp[(ty * 4 + i) * PLD + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    // A row's probabilities were written by the 16 lanes that read them.
    __syncwarp();

#pragma unroll 4
    for (int kk = 0; kk < kBlockKV; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty * 4 + i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vb = sv[kk * HD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    float* row = out + ((static_cast<int64_t>(b) * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) row[tx + 16 * c] = acc[i][c] / lsafe;
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * Hq + h) * Sq + qi] =
          fmaxf(m[i], attn::kSafe) + logf(lsafe);
  }
}

constexpr int kMmaThreads = 128;  // four warps, 16 query rows each

template <int HD>
constexpr size_t flash_mma_shared_bytes() {
  // the query tile and a two-stage ring of (K, V) tiles, bf16
  return sizeof(__nv_bfloat16) * 5 * 64 * mma::row_elems<HD>();
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                   const __nv_bfloat16* __restrict__ k,
                                   const __nv_bfloat16* __restrict__ v,
                                   __nv_bfloat16* __restrict__ out,
                                   float* __restrict__ lse, int Sq, int Skv,
                                   int Hq, int Hkv, int causal, int window,
                                   float softcap, float scale) {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  constexpr int LD = mma::row_elems<HD>();
  constexpr int TILE = 64 * LD;
  constexpr int KC = HD / 16;  // k-chunks of q k^T
  constexpr int NO = HD / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* skv = sq + TILE;  // stage s: K at skv + 2s TILE, then V

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;  // last tile first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // The key tiles this query tile needs: up to its last row when causal,
  // from its first row's window start when windowed.
  const int kv_end = causal ? min(Skv, q0 + kBlockQ) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j_begin = kv_begin / kBlockKV;
  const int j_end = (kv_end + kBlockKV - 1) / kBlockKV;
  const int64_t kv_stride = static_cast<int64_t>(Hkv) * HD;
  const int64_t kv_base = static_cast<int64_t>(b) * Skv * kv_stride + kvh * HD;
  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kBlockKV;
    __nv_bfloat16* dst = skv + 2 * stage * TILE;
    mma::load_tile_async<HD, kMmaThreads>(dst, k + kv_base + k0 * kv_stride,
                                          kv_stride, min(kBlockKV, Skv - k0));
    mma::load_tile_async<HD, kMmaThreads>(dst + TILE,
                                          v + kv_base + k0 * kv_stride,
                                          kv_stride, min(kBlockKV, Skv - k0));
  };

  mma::load_tile_async<HD, kMmaThreads>(
      sq, q + ((static_cast<int64_t>(b) * Sq + q0) * Hq + h) * HD,
      static_cast<int64_t>(Hq) * HD, min(kBlockQ, Sq - q0));
  if (j_begin < j_end) load_kv(j_begin, 0);
  mma::cp_async_commit();

  // Rows g and g + 8 of the warp's 16: running max, this thread's part of
  // the row sum, and the output's n-tiles in the C layout.
  float m[2] = {attn::kNeg, attn::kNeg}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KC][4];

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      load_kv(j + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and, the first time, the query tile) landed
    if (j == j_begin) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma::load_a(qf[kc], sq, LD, warp * 16, kc * 16);
    }
    const __nv_bfloat16* sk = skv + 2 * stage * TILE;
    const __nv_bfloat16* sv = sk + TILE;
    const int k0 = j * kBlockKV;

    // S = q k^T: the warp's 16 rows x 64 keys, eight n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        mma::load_b_nk(bk, sk, LD, np * 16, kc * 16);
        mma::mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }

    // scale, softcap, then the masks where the tile straddles an edge;
    // element e of n-tile n is (row g + 8(e / 2), key 8n + 2t + e % 2)
    const bool edge = k0 + kBlockKV > Skv ||
                      (causal && k0 + kBlockKV - 1 > q0) ||
                      (window > 0 && q0 + kBlockQ - 1 - window >= k0);
    float mx[2] = {attn::kNeg, attn::kNeg};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (edge) {
          const int qpos = q0 + warp * 16 + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = attn::kNeg;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_safe[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a quad hold the row's 64 keys
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = fmaxf(m_new, attn::kSafe);
      corr[r] = m[r] > 0.5f * attn::kNeg
                    ? expf(fmaxf(m[r], attn::kSafe) - m_safe[r])
                    : 0.f;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_safe[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // acc += P v, P as hi + lo bf16 terms, 16 keys per k-chunk
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[2][4];
      mma::split_a<2>(s[2 * kc], s[2 * kc + 1], pa);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        mma::load_b_kn(bv, sv, LD, kc * 16, np * 16);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mma::mma_bf16(acc[2 * np], pa[x], bv[0], bv[1]);
          mma::mma_bf16(acc[2 * np + 1], pa[x], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qi = q0 + warp * 16 + g + 8 * r;
    if (qi >= Sq) continue;
    const float lsafe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* row =
        out + ((static_cast<int64_t>(b) * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / lsafe,
                                acc[n][2 * r + 1] / lsafe);
    if (t == 0)
      lse[(static_cast<int64_t>(b) * Hq + h) * Sq + qi] =
          fmaxf(m[r], attn::kSafe) + logf(lsafe);
  }
}

// B4 at head dim HD: the tensor-core kernel for bf16, the CUDA-core kernel
// for float32.
template <int HD>
int launch(int is_bf16, const void* q, const void* k, const void* v,
           void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, int window, float softcap, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  const int n_q = (Sq + kBlockQ - 1) / kBlockQ;
  cudaError_t err;
  if (is_bf16) {
    auto kernel = flash_attention_fwd_mma_kernel<HD>;
    constexpr size_t bytes = flash_mma_shared_bytes<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(Hq, B, n_q), kMmaThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Skv,
        Hq, Hkv, causal, window, softcap, scale);
  } else {
    auto kernel = flash_attention_fwd_kernel<HD>;
    constexpr size_t bytes = flash_shared_bytes<HD>();
    err = attn::allow_shared_bytes(kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_q, Hq, B), kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), Sq, Skv, Hq, Hkv, causal, window, softcap,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int Sq, int Skv, int Hq, int Hkv,
                                      int hd, int is_bf16, int causal,
                                      int window, float softcap, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Sq <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(is_bf16, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                        causal, window, softcap, s);
    case 64:
      return launch<64>(is_bf16, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                        causal, window, softcap, s);
    case 80:
      return launch<80>(is_bf16, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                        causal, window, softcap, s);
    case 128:
      return launch<128>(is_bf16, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                         causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
