// B4: flash-attention forward for prefill, hand-written for Hopper (sm_90a).
//
// Replaces flash_attention / _flash_kernel of the JAX reference
// (src/repro/kernels/flash_attention/flash_attention.py), and computes what
// it computes: for q [B, Sq, Hq, hd] and k, v [B, Skv, Hkv, hd] (query head
// h reads KV head h / G, G = Hq / Hkv), the softmax of scale * q k^T over
// the visible keys, times v, plus the float32 logsumexp [B, Hq, Sq].
// Visible means kpos < Skv, kpos <= qpos when causal, and kpos > qpos -
// window when a window is set; positions run from 0 (prefill). A tanh
// softcap applies to the scaled scores. The online softmax keeps the
// reference's float32 running (max, sum, acc) with its kNeg / kSafe
// sentinels; key tiles that are wholly masked are never visited.
//
// What bounds it: at the prefill shapes (Sq = Skv = 1024, hd = 64) it does
// about 128 operations per byte it must move, so tensor cores would be the
// limit. This first version runs the two products on the CUDA cores in
// float32 (no mma.sync / wgmma yet), so its floating-point rate bounds it.
// Design: one block of 256 threads per (64-query tile, query head, batch
// row). The query tile and each 64-key K/V tile are staged in shared memory
// as float32 (rows padded to hd + 1 floats, so the key-parallel reads hit
// distinct banks). Thread (ty, tx) of the 16 x 16 layout owns query rows
// 4ty..4ty+3: it scores the keys tx + 16j, reduces the row max and sum
// across the 16 lanes that share those rows with shuffles, and accumulates
// output columns tx + 16c in registers.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
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

  attn::load_tiles<T, HD, kBlockQ, kThreads>(
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
    attn::load_tiles<T, HD, kBlockKV, kThreads>(
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
    T* row = out + ((static_cast<int64_t>(b) * Sq + qi) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c)
      row[tx + 16 * c] = attn::Pack<T>::from_f32(acc[i][c] / lsafe);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * Hq + h) * Sq + qi] =
          fmaxf(m[i], attn::kSafe) + logf(lsafe);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float softcap, cudaStream_t stream) {
  auto kernel = flash_attention_fwd_kernel<T, HD>;
  constexpr size_t bytes = flash_shared_bytes<HD>();
  cudaError_t err = attn::allow_shared_bytes(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
              int window, float softcap, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, softcap, stream);
    case 80:
      return launch<T, 80>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                            window, softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, out, lse, B, Sq, Skv,
                                            Hq, Hkv, causal, window, softcap,
                                            s)
                 : launch_hd<float>(hd, q, k, v, out, lse, B, Sq, Skv, Hq, Hkv,
                                    causal, window, softcap, s);
}
