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
// scaled scores.
//
// The valid slots of a row are one contiguous range [lo, hi): hi =
// min(kv_len, Sc), lo = kv_len - window for a window outside ring mode,
// else 0. The kernel visits only that range, which is the same function:
// a masked slot adds exactly zero to the reference's online softmax.
//
// What bounds it: decode reads the valid part of the cache once and does
// about 2 * G operations per element read, far below the card's balance,
// so device memory bounds it. Design: one block of 128 threads per (KV
// head, batch row), so the G query heads of a group share each K/V tile.
// The block streams the range in 128-slot tiles through float32 shared
// memory (16-byte loads, several in flight per thread); thread t scores
// slot t for every head of the group, one warp per head updates that
// head's running max and sum, and the threads share the G x hd output
// accumulators, kept in shared memory.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockKV = 128;  // one slot per thread when scoring

template <int HD>
size_t decode_shared_bytes(int G) {
  // k tile padded to hd + 1, v tile, then per head: q, scores, accumulator,
  // running max, running sum, rescale factor
  return sizeof(float) *
         (kBlockKV * (HD + 1) + kBlockKV * HD +
          static_cast<size_t>(G) * (HD + kBlockKV + HD + 3));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    gqa_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      int Sc, int Hkv, int G, int window, int ring,
                      float softcap, float scale) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* sk = smem;                   // [kBlockKV][LD]
  float* sv = sk + kBlockKV * LD;     // [kBlockKV][HD]
  float* sq = sv + kBlockKV * HD;     // [G][HD]
  float* ss = sq + G * HD;            // [G][kBlockKV]
  float* sacc = ss + G * kBlockKV;    // [G][HD]
  float* sm = sacc + G * HD;          // [G]
  float* sl = sm + G;                 // [G]
  float* scorr = sl + G;              // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int Hq = Hkv * G;
  const int n = kv_len[b];
  const int hi = max(0, min(n, Sc));
  const int lo = (!ring && window > 0) ? max(0, n - window) : 0;

  const T* qrow = q + (static_cast<int64_t>(b) * Hq + kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads) {
    sq[e] = attn::Pack<T>::to_f32(qrow[e]);
    sacc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sm[g] = attn::kNeg;
    sl[g] = 0.f;
  }

  const int64_t stride = static_cast<int64_t>(Hkv) * HD;
  for (int t0 = lo; t0 < hi; t0 += kBlockKV) {
    const int nt = min(kBlockKV, hi - t0);
    __syncthreads();  // the previous tile is consumed (and q is staged)
    const int64_t off = ((static_cast<int64_t>(b) * Sc + t0) * Hkv + kvh) * HD;
    attn::load_tiles<T, HD, kBlockKV, kThreads>(sk, LD, kc + off, sv, HD,
                                                vc + off, stride, nt);
    __syncthreads();

    if (tid < nt) {
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) a = fmaf(sq[g * HD + d], sk[tid * LD + d], a);
        float x = a * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ss[g * kBlockKV + tid] = x;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kThreads / 32) {
      float mx = attn::kNeg;
      for (int r = lane; r < nt; r += 32) mx = fmaxf(mx, ss[g * kBlockKV + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = fmaxf(m_new, attn::kSafe);
      float sum = 0.f;
      for (int r = lane; r < nt; r += 32) {
        const float p = expf(ss[g * kBlockKV + r] - m_safe);
        ss[g * kBlockKV + r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = m_prev > 0.5f * attn::kNeg
                               ? expf(fmaxf(m_prev, attn::kSafe) - m_safe)
                               : 0.f;
        sl[g] = sl[g] * corr + sum;
        sm[g] = m_new;
        scorr[g] = corr;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, c = e % HD;
      const float* p = ss + g * kBlockKV;
      float a = 0.f;
      for (int r = 0; r < nt; ++r) a = fmaf(p[r], sv[r * HD + c], a);
      sacc[e] = sacc[e] * scorr[g] + a;
    }
  }
  __syncthreads();

  T* orow = out + (static_cast<int64_t>(b) * Hq + kvh * G) * HD;
  for (int e = tid; e < G * HD; e += kThreads)
    orow[e] = attn::Pack<T>::from_f32(sacc[e] / fmaxf(sl[e / HD], 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* kc, const void* vc, const void* kv_len,
           void* out, int B, int Sc, int Hkv, int G, int window, int ring,
           float softcap, cudaStream_t stream) {
  auto kernel = gqa_decode_kernel<T, HD>;
  const size_t bytes = decode_shared_bytes<HD>(G);
  cudaError_t err = attn::allow_shared_bytes(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(Hkv, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(kv_len),
      static_cast<T*>(out), Sc, Hkv, G, window, ring, softcap,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* kc, const void* vc,
              const void* kv_len, void* out, int B, int Sc, int Hkv, int G,
              int window, int ring, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                           ring, softcap, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                           ring, softcap, stream);
    case 80:
      return launch<T, 80>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                           ring, softcap, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, kv_len, out, B, Sc, Hkv, G, window,
                            ring, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gqa_decode_launch(const void* q, const void* k_cache,
                                 const void* v_cache, const void* kv_len,
                                 void* out, int B, int Sc, int Hkv, int G,
                                 int hd, int is_bf16, int window, int ring,
                                 float softcap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || Hkv <= 0 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kv_len,
                                            out, B, Sc, Hkv, G, window, ring,
                                            softcap, s)
                 : launch_hd<float>(hd, q, k_cache, v_cache, kv_len, out, B,
                                    Sc, Hkv, G, window, ring, softcap, s);
}
