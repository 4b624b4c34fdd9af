// Hand-written Hopper (sm_90a) kernels for the PIES placement hot path.
//
// Three kernels, each replacing one Pallas TPU kernel of the JAX reference
// (src/repro/kernels/qos_matrix/qos_matrix.py):
//
//   qos_matrix_kernel      <- qos_matrix_pallas / _qos_kernel
//   qos_candidates_kernel  <- qos_candidates_pallas / _qos_cand_kernel
//   greedy_argmax_kernel   <- greedy_argmax_pallas / _greedy_argmax_kernel
//
// All three do a few float32 compares, selects and multiply-adds per byte
// they move, far below the card's operations-per-byte balance, so device
// memory bounds them; greedy_argmax is small enough ([E, P] = [1000, 537])
// that its launch, not its bytes, is what it costs.
//
// Numerics: every kernel repeats the plain PyTorch version's float32
// arithmetic operation for operation (repro_torch/kernels/qos_matrix/ref.py).
// The delay k*share_k + w*share_w is written with __fmul_rn/__fadd_rn so
// that the compiler cannot fuse it into an FMA, and the division by
// delta_max is the correctly rounded __fdiv_rn. Kernel and plain version
// then agree bit for bit, which keeps the greedy's near-tie picks equal.
//
// Interface: plain C entry points loaded with ctypes. Each launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;  // greedy mask sentinel (benefits may be < 0)

// 0.5 * (a_hat + d_hat) of Eqs. (2)-(6) for one (user, model) pair.
__device__ __forceinline__ float qos_pair(float alpha, float delta,
                                          float share_k, float share_w,
                                          float acc, float kcost, float wcost,
                                          float delta_max) {
  const float adiff = alpha - acc;                          // Eq. (2)
  const float a_hat = adiff <= 0.0f ? 1.0f : fmaxf(1.0f - adiff, 0.0f);
  const float d = __fadd_rn(__fmul_rn(kcost, share_k),      // Eqs. (4)-(6)
                            __fmul_rn(wcost, share_w));
  const float over = d - delta;
  const float d_hat = over <= 0.0f                          // Eq. (3)
                          ? 1.0f
                          : fmaxf(1.0f - __fdiv_rn(over, delta_max), 0.0f);
  return 0.5f * (a_hat + d_hat);
}

// ---------------------------------------------------------------------------
// B1 qos_matrix: Q[u, p] = qos_pair(u, p) * [u_service[u] == sm_service[p]].
//
// Replaces _qos_kernel (qos_matrix.py), which tiles (users x models) into
// (256, 256) VMEM blocks. Bound: the U*P*4 output bytes (2.15 GB at
// U = 1e6, P = 537); the inputs are a few MB. Design: a block owns kRows
// consecutive users and its threads walk the row with p fastest, so each
// warp's stores are 128 contiguous bytes. The per-model rows (P floats) are
// re-read by every block and stay in L1/L2; no division by P is needed.
// ---------------------------------------------------------------------------
constexpr int kRows = 4;
constexpr int kMatrixThreads = 256;

__global__ void qos_matrix_kernel(
    const float* __restrict__ u_alpha, const float* __restrict__ u_delta,
    const float* __restrict__ u_share_k, const float* __restrict__ u_share_w,
    const int* __restrict__ u_service, const float* __restrict__ sm_acc,
    const float* __restrict__ sm_k, const float* __restrict__ sm_w,
    const int* __restrict__ sm_service, float* __restrict__ out, int64_t U,
    int64_t P, float delta_max) {
  const int64_t u0 = static_cast<int64_t>(blockIdx.x) * kRows;
  for (int r = 0; r < kRows; ++r) {
    const int64_t u = u0 + r;
    if (u >= U) return;
    const float alpha = u_alpha[u], delta = u_delta[u];
    const float sk = u_share_k[u], sw = u_share_w[u];
    const int svc = u_service[u];
    float* row = out + u * P;
    for (int64_t p = threadIdx.x; p < P; p += blockDim.x) {
      const float q = qos_pair(alpha, delta, sk, sw, sm_acc[p], sm_k[p],
                               sm_w[p], delta_max);
      row[p] = q * (svc == sm_service[p] ? 1.0f : 0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// B2 qos_candidates: Q[u, c] = qos_pair over pre-gathered candidate
// attributes [U, K], times valid[u, c]; no id compare.
//
// Replaces _qos_cand_kernel (qos_matrix.py), which pads K up to a 128-lane
// tile. Bound: 16 B per user + 20 B per pair (about 216 MB at U = 1e6,
// K = 10). Design: one thread per (u, c) pair over the flat [U, K] layout,
// so the four [U, K] reads and the store are fully coalesced and no lane
// is spent on padding; the per-user scalars are re-read by the K threads
// of a row from L1.
// ---------------------------------------------------------------------------
constexpr int kPairThreads = 256;

__global__ void qos_candidates_kernel(
    const float* __restrict__ u_alpha, const float* __restrict__ u_delta,
    const float* __restrict__ u_share_k, const float* __restrict__ u_share_w,
    const float* __restrict__ cand_acc, const float* __restrict__ cand_k,
    const float* __restrict__ cand_w, const float* __restrict__ cand_valid,
    float* __restrict__ out, int64_t n_pairs, int K, float delta_max) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_pairs; i += stride) {
    const int64_t u = i / K;
    const float q = qos_pair(u_alpha[u], u_delta[u], u_share_k[u],
                             u_share_w[u], cand_acc[i], cand_k[i], cand_w[i],
                             delta_max);
    out[i] = q * cand_valid[i];
  }
}

// ---------------------------------------------------------------------------
// B3 greedy_argmax: per row e of the benefit map v [E, P], the first column
// holding max_p (mask[e, p] ? v[e, p] : -1e30); a row whose mask is empty
// gives (-1e30, -1), decided from the mask and not from the value.
//
// Replaces _greedy_argmax_kernel (qos_matrix.py), which loads 8 full rows
// per grid step and reduces with max + min-index. Bound: launch latency at
// the main path's [1000, 537] (2.7 MB moved, one launch per greedy
// iteration). Design: one warp per row; lane l scans columns l, l+32, ...
// in increasing order, so a strict '>' keeps its first maximum; a shuffle
// reduction then merges lanes under the same first-maximum rule (greater
// value, or equal value at a smaller column). Every column takes part with
// its masked value, exactly as the reference's where/argmax does.
// ---------------------------------------------------------------------------
constexpr int kArgmaxThreads = 256;  // 8 rows per block

__global__ void greedy_argmax_kernel(const float* __restrict__ v,
                                     const uint8_t* __restrict__ mask,
                                     float* __restrict__ best,
                                     int* __restrict__ idx, int E, int P) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= E) return;  // uniform across the warp
  const float* vr = v + static_cast<int64_t>(row) * P;
  const uint8_t* mr = mask + static_cast<int64_t>(row) * P;
  float b = -FLT_MAX;
  int bi = INT_MAX;
  bool has = false;
  for (int p = lane; p < P; p += 32) {
    const bool m = mr[p] != 0;
    has |= m;
    const float val = m ? vr[p] : kNeg;
    if (bi == INT_MAX || val > b) {
      b = val;
      bi = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, b, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oi != INT_MAX && (bi == INT_MAX || ob > b || (ob == b && oi < bi))) {
      b = ob;
      bi = oi;
    }
  }
  has = __any_sync(0xffffffffu, has);
  if (lane == 0) {
    best[row] = has ? b : kNeg;
    idx[row] = has ? bi : -1;
  }
}

inline unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

const char* qos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int qos_matrix_launch(const void* u_alpha, const void* u_delta,
                      const void* u_share_k, const void* u_share_w,
                      const void* u_service, const void* sm_acc,
                      const void* sm_k, const void* sm_w,
                      const void* sm_service, void* out, long long U,
                      long long P, float delta_max, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  qos_matrix_kernel<<<blocks_for(U, kRows), kMatrixThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_alpha), static_cast<const float*>(u_delta),
      static_cast<const float*>(u_share_k),
      static_cast<const float*>(u_share_w),
      static_cast<const int*>(u_service), static_cast<const float*>(sm_acc),
      static_cast<const float*>(sm_k), static_cast<const float*>(sm_w),
      static_cast<const int*>(sm_service), static_cast<float*>(out), U, P,
      delta_max);
  return static_cast<int>(cudaGetLastError());
}

int qos_candidates_launch(const void* u_alpha, const void* u_delta,
                          const void* u_share_k, const void* u_share_w,
                          const void* cand_acc, const void* cand_k,
                          const void* cand_w, const void* cand_valid,
                          void* out, long long U, int K, float delta_max,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_pairs = static_cast<int64_t>(U) * K;
  const int64_t blocks = blocks_for(n_pairs, kPairThreads);
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks
                                                                   : (1LL << 30));
  qos_candidates_kernel<<<grid, kPairThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_alpha), static_cast<const float*>(u_delta),
      static_cast<const float*>(u_share_k),
      static_cast<const float*>(u_share_w),
      static_cast<const float*>(cand_acc), static_cast<const float*>(cand_k),
      static_cast<const float*>(cand_w),
      static_cast<const float*>(cand_valid), static_cast<float*>(out),
      n_pairs, K, delta_max);
  return static_cast<int>(cudaGetLastError());
}

int greedy_argmax_launch(const void* v, const void* mask, void* best,
                         void* idx, int E, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_argmax_kernel<<<blocks_for(static_cast<int64_t>(E) * 32,
                                    kArgmaxThreads),
                         kArgmaxThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(best), static_cast<int*>(idx), E, P);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
