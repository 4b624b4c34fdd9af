// B8: the Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces ssd_scan / _ssd_kernel of the JAX reference
// (src/repro/kernels/ssd_scan/ssd_scan.py), and computes what it computes,
// plus an optional float32 initial state (a null pointer means zeros). For
// x [B, L, H, P] (already scaled by dt), dtA [B, L, H] (dt * A, negative),
// b, c [B, L, N] (one group shared by every head), all float32, with L a
// multiple of the chunk Q, it walks the chunks in order and, for each
// chunk, with a_cum the cumulative sum of dtA over the chunk:
//   y[q]  = sum_{s <= q} (C[q] . B[s]) exp(a_cum[q] - a_cum[s]) x[s]
//         + (C[q] . state^T) exp(a_cum[q])
//   state = state exp(a_cum[Q-1]) + sum_s x[s]^T B[s] exp(a_cum[Q-1] - a_cum[s])
// and returns y [B, L, H, P] and the final state [B, H, P, N], float32.
//
// What bounds it: at the mamba2 serving shape (B = 8, L = 1024, H = 80,
// P = 64, N = 128, Q = 256) the scan needs at least about 70 operations per
// byte it must move (the sequential recurrence's 5 P N per step; this
// kernel, which forms C B^T once per head, does about twice that), so
// arithmetic bounds it. It runs in float32 on the CUDA cores (the
// reference's 3e-4 tolerance rules out TF32 tensor cores), so the 67
// TFLOP/s FMA peak is its bound.
//
// Design: one block of 256 threads per (head, batch row). The [P, N] state
// stays in shared memory for the whole sequence (the sequential chunk axis
// of the TPU grid becomes the block's own loop). Inside a chunk the block
// tiles like the flash-attention forward without the softmax: for each
// 64-row query sub-tile i it keeps Y_i [64, P] in registers (thread (ty, tx)
// of the 16 x 16 layout owns rows 4ty..4ty+3 and columns tx + 16c), and for
// each key sub-tile j <= i it forms the 64 x 64 scores C_i B_j^T in
// registers, scales each visible (s <= q) score by exp(a_cum[q] - a_cum[s])
// (exp is evaluated only there: above the diagonal the exponent is positive
// and may overflow, and inf * 0 would be NaN), stages them in shared memory
// and adds scores . X_j to Y_i. Then Y_i += (C_i state^T) exp(a_cum[q]). The
// chunk's state contribution X_j^T (B_j exp(a_last - a_cum)) is summed in
// registers while the diagonal sub-tile (j = i) is staged, and added to the
// state after every sub-tile has read the old state. x and y are read and
// written in their [B, L, H, P] layout, rows H * P apart.
//
// Interface: a plain C entry point loaded with ctypes. It launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows of a query or key sub-tile
constexpr int kMaxChunk = 1024;  // chunk rows the a_cum buffer holds

template <int P, int N>
size_t ssd_shared_bytes(int chunk) {
  // state [P][N+1], C and B sub-tiles [64][N+1], X sub-tile [64][P],
  // scores [64][65], a_cum [chunk]
  return sizeof(float) *
         (static_cast<size_t>(P) * (N + 1) + 2 * kTile * (N + 1) + kTile * P +
          kTile * (kTile + 1) + chunk);
}

// Inclusive cumulative sum of dtA over rows [0, Q) of a chunk into a_cum;
// warp 0 scans 32 rows at a time and carries the running total.
__device__ __forceinline__ void chunk_cumsum(float* a_cum,
                                             const float* __restrict__ dtA,
                                             int64_t row0, int H, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int t = base + lane;
    float v = t < Q ? dtA[(row0 + t) * H] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (t < Q) a_cum[t] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dtA,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ init, float* __restrict__ y,
                    float* __restrict__ state_out, int L, int H, int Q) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N: multiples of 16");
  constexpr int LDN = N + 1;
  constexpr int LDS = kTile + 1;
  constexpr int PC = P / 16;  // Y columns per thread (tx + 16c)
  constexpr int PR = P / 16;  // state rows per thread (ty * PR + r)
  constexpr int NC = N / 16;  // state columns per thread (tx + 16c)
  extern __shared__ float smem[];
  float* s_state = smem;                 // [P][LDN]
  float* s_c = s_state + P * LDN;        // [64][LDN]
  float* s_b = s_c + kTile * LDN;        // [64][LDN]
  float* s_x = s_b + kTile * LDN;        // [64][P]
  float* s_s = s_x + kTile * P;          // [64][LDS]
  float* s_a = s_s + kTile * LDS;        // [Q]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t xrow = static_cast<int64_t>(H) * P;  // x / y row stride

  for (int e = tid; e < P * N; e += kThreads)
    s_state[(e / N) * LDN + e % N] = init ? init[bh * P * N + e] : 0.f;

  const int n_sub = (Q + kTile - 1) / kTile;
  for (int c0 = 0; c0 < L; c0 += Q) {
    const int64_t row0 = static_cast<int64_t>(b) * L + c0;  // [B*L] row
    __syncthreads();  // the previous chunk's state update and a_cum reads
    chunk_cumsum(s_a, dtA + h, row0, H, Q);
    __syncthreads();
    const float a_last = s_a[Q - 1];

    float st[PR][NC];
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int k = 0; k < NC; ++k) st[r][k] = 0.f;

    for (int i = 0; i < n_sub; ++i) {
      const int q0 = i * kTile, nq = min(kTile, Q - q0);
      __syncthreads();  // the previous sub-tile's readers of s_c are done
      attn::load_tiles<float, N, kTile, kThreads>(
          s_c, LDN, cm + (row0 + q0) * N, nullptr, 0, nullptr, N, nq);

      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

      for (int j = 0; j <= i; ++j) {
        const int s0 = j * kTile, ns = min(kTile, Q - s0);
        __syncthreads();  // readers of s_b, s_x and s_s are done
        attn::load_tiles<float, N, kTile, kThreads>(
            s_b, LDN, bm + (row0 + s0) * N, nullptr, 0, nullptr, N, ns);
        attn::load_tiles<float, P, kTile, kThreads>(
            s_x, P, x + (row0 + s0) * xrow + h * P, nullptr, 0, nullptr,
            xrow, ns);
        __syncthreads();

        // scores[q][s] = C_i[q] . B_j[s], q = 4ty + r, s = tx + 16k
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          float ca[4], ba[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) ca[r] = s_c[(ty * 4 + r) * LDN + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) ba[k] = s_b[(tx + 16 * k) * LDN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) sc[r][k] = fmaf(ca[r], ba[k], sc[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = q0 + ty * 4 + r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int s = s0 + tx + 16 * k;
            const bool ok = s <= q && q < Q && s < Q;
            s_s[(ty * 4 + r) * LDS + tx + 16 * k] =
                ok ? sc[r][k] * expf(s_a[q] - s_a[s]) : 0.f;
          }
        }

        if (j == i) {
          // the chunk's state contribution from this key sub-tile:
          // st[p][n] += x[s][p] exp(a_last - a_cum[s]) B[s][n]
          for (int s = 0; s < ns; ++s) {
            const float w = expf(a_last - s_a[s0 + s]);
            float xw[PR];
#pragma unroll
            for (int r = 0; r < PR; ++r) xw[r] = s_x[s * P + ty * PR + r] * w;
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const float bv = s_b[s * LDN + tx + 16 * k];
#pragma unroll
              for (int r = 0; r < PR; ++r) st[r][k] = fmaf(xw[r], bv, st[r][k]);
            }
          }
        }
        __syncthreads();

        // Y_i += scores . X_j
#pragma unroll 4
        for (int s = 0; s < kTile; ++s) {
          float sa[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sa[r] = s_s[(ty * 4 + r) * LDS + s];
#pragma unroll
          for (int k = 0; k < PC; ++k) {
            const float xv = s_x[s * P + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(sa[r], xv, acc[r][k]);
          }
        }
      }

      // Y_i += (C_i . state^T) exp(a_cum[q]), with the state entering the
      // chunk
      float off[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PC; ++k) off[r][k] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float ca[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ca[r] = s_c[(ty * 4 + r) * LDN + n];
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const float sv = s_state[(tx + 16 * k) * LDN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r) off[r][k] = fmaf(ca[r], sv, off[r][k]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int q = q0 + ty * 4 + r;
        if (q >= Q) continue;
        const float e = expf(s_a[q]);
        float* yrow = y + (row0 + q) * xrow + h * P;
#pragma unroll
        for (int k = 0; k < PC; ++k)
          yrow[tx + 16 * k] = acc[r][k] + off[r][k] * e;
      }
    }

    __syncthreads();  // every sub-tile has read the state entering the chunk
    const float decay = expf(a_last);
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        float* sp = s_state + (ty * PR + r) * LDN + tx + 16 * k;
        *sp = *sp * decay + st[r][k];
      }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads)
    state_out[bh * P * N + e] = s_state[(e / N) * LDN + e % N];
}

template <int P, int N>
int launch(const void* x, const void* dtA, const void* b, const void* c,
           const void* init, void* y, void* state, int B, int L, int H,
           int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<P, N>;
  const size_t bytes = ssd_shared_bytes<P, N>(chunk);
  cudaError_t err = attn::allow_shared_bytes(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dtA),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<const float*>(init), static_cast<float*>(y),
      static_cast<float*>(state), L, H, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (P, N) pairs compiled: zamba2's (64, 64) and mamba2's (64, 128). Keep in
// step with SHAPES in kernels/ssd_scan/ops.py.
extern "C" int ssd_scan_launch(const void* x, const void* dtA, const void* b,
                               const void* c, const void* init, void* y,
                               void* state, int B, int L, int H, int P, int N,
                               int chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxChunk ||
      L % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 64)
    return launch<64, 64>(x, dtA, b, c, init, y, state, B, L, H, chunk, s);
  if (P == 64 && N == 128)
    return launch<64, 128>(x, dtA, b, c, init, y, state, B, L, H, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
