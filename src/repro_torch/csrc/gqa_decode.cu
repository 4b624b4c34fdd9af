// B7: GQA decode attention (one query token per row against a KV cache),
// hand-written for Hopper (sm_90a).
//
// Replaces gqa_decode / _decode_kernel of the JAX reference
// (src/repro/kernels/gqa_decode/gqa_decode.py). For q [B, Hq, hd] and a
// cache k, v [B, Sc, Hkv, hd] it computes, per row b and query head h (KV
// head h / G), the softmax of scale * q k^T over the valid cache slots,
// times v. Slot idx of row b is valid when idx < Sc and idx < kv_len[b];
// in ring mode also every slot once kv_len[b] > Sc; outside ring mode, with
// a window, only idx > kv_len[b] - 1 - window. This is the validity mask of
// the model layer (decode_attention_jnp), which always keeps idx < Sc; the
// Pallas kernel's ring mask lacks that term and attends its zero padding
// when Sc is not a multiple of its block. A tanh softcap applies to the
// scaled scores, and a row with no valid slot gives zeros.
//
// The valid slots of a row are one contiguous range [lo, hi): hi =
// min(kv_len, Sc), lo = kv_len - window for a window outside ring mode,
// else 0. The kernel visits only that range, which is the same function:
// a masked slot adds exactly zero to the reference's online softmax.
//
// What bounds it: decode reads the valid part of the cache once and does
// about 2 * G operations per byte it reads, against the card's balance of
// about 295, so device memory bounds it. The products stay on the CUDA
// cores in float32: at 2 * G operations a byte the tensor cores buy
// nothing. What the design does about it is keep enough loads in flight:
//
// * Split-KV over a thread block cluster. The grid is (Hkv * chunks of GC
//   query heads, B, S): the S blocks of one (KV head, row) form one
//   cluster along z, and block rank r takes the r-th of S equal parts of
//   [lo, hi) (a part may be empty). The host picks S from sizes it knows
//   (decode_splits in kernels/gqa_decode/ops.py): about two blocks an SM,
//   at most 8, the portable cluster size.
// * Loads straight from device memory, in K's and V's own dtype, 16 bytes
//   at a time. A slot's row is spread over LPS lanes of 8 columns each
//   (one 16-byte load in bf16, two in float32); each lane keeps q's 8
//   columns of its heads in registers and issues the K and V loads of
//   kUnroll slots before it uses any of them. A slot's score is a float32
//   FMA chain over the lane's columns and a shuffle sum over its LPS
//   lanes. Nothing is staged in shared memory and the loop has no
//   barrier.
// * Each group of LPS lanes is one stream with its own running (m, l,
//   acc[GC, 8 columns]) over the slots t = base + u * streams + stream.
//   At the end the streams of a warp merge by a butterfly of shuffles, the
//   warps of a block in warp order in shared memory, and, after
//   cluster.sync(), block rank 0 reads the other ranks' (m, l, acc)
//   through distributed shared memory and merges them in rank order; it
//   writes acc / max(l, 1e-30) in q's dtype. A merge weighs each side by
//   the reference's rule, exp(max(m_side, -1e20) - max(m, -1e20)) if
//   m_side > -1e30 / 2 else 0, so an empty stream or split (m = -1e30,
//   l = 0, acc = 0) adds exactly nothing. Every merge runs in a fixed
//   order, so two calls give the same bits. One launch, no workspace, no
//   atomics.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given with cudaLaunchKernelEx, does not synchronise,
// allocates nothing and returns the launch's error (0 on success).

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;       // columns of a slot's row per lane
constexpr int kUnroll = 4;     // slots per stream whose loads fly together
constexpr int kMaxSplits = 8;  // the portable cluster size

// Lanes per slot: the power of two whose lanes cover HD in kCols columns
// (at HD = 80, 10 of 16 lanes hold columns).
template <int HD>
struct LanesPerSlot {
  static constexpr int value = HD <= 32 ? 4 : HD <= 64 ? 8 : 16;
};

// One lane's kCols columns of a row of T, as 16-byte words.
template <typename T>
struct Chunk {
  static constexpr int kWords = kCols * static_cast<int>(sizeof(T)) / 16;
  uint4 w[kWords];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void to_f32(float* f) const {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      attn::Pack<T>::unpack(w[i], f + i * attn::Pack<T>::kElems);
  }
};

// The weight of a state whose running maximum is m_side in a merge whose
// floored maximum is m_safe: the reference's corr rule.
__device__ __forceinline__ float weight(float m_side, float m_safe) {
  return m_side > 0.5f * attn::kNeg
             ? expf(fmaxf(m_side, attn::kSafe) - m_safe)
             : 0.f;
}

// Fold the state (m2, l2, a2) into (m, l, a).
__device__ __forceinline__ void fold(float& m, float& l, float& a, float m2,
                                     float l2, float a2) {
  const float m_new = fmaxf(m, m2);
  const float m_safe = fmaxf(m_new, attn::kSafe);
  const float c1 = weight(m, m_safe), c2 = weight(m2, m_safe);
  l = l * c1 + l2 * c2;
  a = a * c1 + a2 * c2;
  m = m_new;
}

template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      int Sc, int Hkv, int G, int window, int ring,
                      float softcap, float scale) {
  constexpr int LPS = LanesPerSlot<HD>::value;
  constexpr int kStreams = kWarps * (32 / LPS);
  static_assert(LPS * kCols >= HD && HD % kCols == 0, "head width");
  __shared__ float w_m[kWarps][GC], w_l[kWarps][GC];
  __shared__ float w_acc[kWarps][GC][HD];
  __shared__ float b_m[GC], b_l[GC];
  __shared__ float b_acc[GC][HD];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int li = lane % LPS;  // this lane's 8 columns: li * 8 ...
  const int stream = warp * (32 / LPS) + lane / LPS;
  const bool has_cols = li * kCols < HD;
  const int n_gc = (G + GC - 1) / GC;
  const int kvh = blockIdx.x / n_gc;
  const int g0 = (blockIdx.x % n_gc) * GC;
  const int gn = min(GC, G - g0);
  const int b = blockIdx.y;
  const int Hq = Hkv * G;

  // the row's valid range [lo, hi), and this split's part [t_lo, t_hi)
  const int n = kv_len[b];
  const int hi = max(0, min(n, Sc));
  const int lo = (!ring && window > 0) ? max(0, n - window) : 0;
  const int per = (max(hi - lo, 0) + n_split - 1) / n_split;
  const int t_lo = lo + rank * per;
  const int t_hi = min(hi, t_lo + per);

  // q's columns of this lane, per head, in registers (read element by
  // element: q need not be 16-byte aligned)
  float qf[GC][kCols];
  const T* qrow = q + (static_cast<int64_t>(b) * Hq + kvh * G + g0) * HD;
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      qf[g][i] = (g < gn && has_cols)
                     ? attn::Pack<T>::to_f32(qrow[g * HD + li * kCols + i])
                     : 0.f;

  float m[GC], l[GC], acc[GC][kCols];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = attn::kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[g][i] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(Hkv) * HD;
  const int64_t base = (static_cast<int64_t>(b) * Sc * Hkv + kvh) * HD +
                       li * kCols;
  for (int t0 = t_lo; t0 < t_hi; t0 += kStreams * kUnroll) {
    Chunk<T> kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kStreams + stream;
      ok[u] = t < t_hi;
      if (ok[u] && has_cols) {
        kr[u].load(kc + base + t * row_stride);
        vr[u].load(vc + base + t * row_stride);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
    float s[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kCols];
      kr[u].to_f32(kf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < kCols; ++i) a = fmaf(qf[g][i], kf[i], a);
#pragma unroll
        for (int o = LPS / 2; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        float x = a * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u][g] = ok[u] ? x : attn::kNeg;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u][g]);
      const float m_safe = fmaxf(m_new, attn::kSafe);
      const float corr = weight(m[g], m_safe);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][g] = expf(s[u][g] - m_safe);  // now p
        sum += s[u][g];
      }
      l[g] = l[g] * corr + sum;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kCols; ++i) acc[g][i] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[kCols];
      vr[u].to_f32(vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          acc[g][i] = fmaf(s[u][g], vf[i], acc[g][i]);
    }
  }

  // merge the streams of the warp: a butterfly over the lane groups
#pragma unroll
  for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float m_new = fmaxf(m[g], m2);
      const float m_safe = fmaxf(m_new, attn::kSafe);
      const float c1 = weight(m[g], m_safe), c2 = weight(m2, m_safe);
      l[g] = l[g] * c1 + l2 * c2;
      m[g] = m_new;
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        acc[g][i] = acc[g][i] * c1 +
                    __shfl_xor_sync(0xffffffffu, acc[g][i], o) * c2;
    }
  }
  if (lane < LPS) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (has_cols)
#pragma unroll
        for (int i = 0; i < kCols; ++i)
          w_acc[warp][g][li * kCols + i] = acc[g][i];
      if (lane == 0) {
        w_m[warp][g] = m[g];
        w_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps of the block, in warp order
  for (int e = tid; e < GC * HD; e += kThreads) {
    const int g = e / HD, c = e % HD;
    float mm = attn::kNeg, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      fold(mm, ll, aa, w_m[w][g], w_l[w][g], w_acc[w][g][c]);
    b_acc[g][c] = aa;
    if (c == 0) {
      b_m[g] = mm;
      b_l[g] = ll;
    }
  }
  cluster.sync();  // every block's (m, l, acc) is in its shared memory

  // rank 0 merges the splits in rank order and writes the output
  if (rank == 0) {
    T* orow = out + (static_cast<int64_t>(b) * Hq + kvh * G + g0) * HD;
    for (int e = tid; e < gn * HD; e += kThreads) {
      const int g = e / HD;
      float rm[kMaxSplits], rl[kMaxSplits], ra[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {  // every read issued first
        if (r < n_split) {
          rm[r] = cluster.map_shared_rank(&b_m[0], r)[g];
          rl[r] = cluster.map_shared_rank(&b_l[0], r)[g];
          ra[r] = cluster.map_shared_rank(&b_acc[0][0], r)[e];
        }
      }
      float mm = attn::kNeg, ll = 0.f, aa = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < n_split) fold(mm, ll, aa, rm[r], rl[r], ra[r]);
      orow[e] = attn::Pack<T>::from_f32(aa / fmaxf(ll, 1e-30f));
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

template <typename T, int HD, int GC>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* kv_len, void* out, int B, int Sc, int Hkv,
                   int G, int window, int ring, int splits, float softcap,
                   cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Hkv * ((G + GC - 1) / GC), B, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, gqa_decode_kernel<T, HD, GC>, static_cast<const T*>(q),
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(kv_len), static_cast<T*>(out), Sc, Hkv, G,
      window, ring, softcap, 1.0f / sqrtf(static_cast<float>(HD)));
}

// The heads a block takes: one where G is 1 (its 128 registers, against
// 168 for 4 heads, keep zamba2's 512 blocks in one wave), else chunks of 4
// (G = 2 and 3 run one chunk with heads idle).
template <typename T, int HD>
cudaError_t launch_gc(const void* q, const void* kc, const void* vc,
                      const void* kv_len, void* out, int B, int Sc, int Hkv,
                      int G, int window, int ring, int splits, float softcap,
                      cudaStream_t stream) {
  if (G == 1)
    return launch<T, HD, 1>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                            ring, splits, softcap, stream);
  return launch<T, HD, 4>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                          ring, splits, softcap, stream);
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc,
                      const void* kv_len, void* out, int B, int Sc, int Hkv,
                      int G, int window, int ring, int splits, float softcap,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_gc<T, 32>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                              ring, splits, softcap, stream);
    case 64:
      return launch_gc<T, 64>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                              ring, splits, softcap, stream);
    case 80:
      return launch_gc<T, 80>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                              ring, splits, softcap, stream);
    case 128:
      return launch_gc<T, 128>(q, kc, vc, kv_len, out, B, Sc, Hkv, G,
                               window, ring, splits, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int gqa_decode_launch(const void* q, const void* k_cache,
                                 const void* v_cache, const void* kv_len,
                                 void* out, int B, int Sc, int Hkv, int G,
                                 int hd, int is_bf16, int window, int ring,
                                 int splits, float softcap, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || B > 65535 || Hkv <= 0 || G <= 0 || splits < 1 ||
      splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kv_len,
                                           out, B, Sc, Hkv, G, window, ring,
                                           splits, softcap, s)
                : launch_hd<float>(hd, q, k_cache, v_cache, kv_len, out, B,
                                   Sc, Hkv, G, window, ring, splits, softcap,
                                   s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
