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
// U = 1e6, P = 537); the inputs are a few MB. Design: a persistent grid of
// as many 256-thread blocks as fit on the card, each of which first stages
// the P per-model attributes into shared memory as one 16-byte record a
// model (acc, k, w, the service id's bits), then strides over the output
// as the flat [U * P] array in groups of 4 consecutive elements. The
// records are skewed by one slot every 8 (model_slot), so the 8 lanes of
// a quarter warp, whose groups start 4 models apart, read 8 different
// 16-byte bank groups instead of 2 (a 4-way conflict). A thread works out
// its first group's (u, p) with one division and steps it by the grid's
// stride with a wrap, loading the next group's user attributes while it
// works on the current one; inside a group p steps by one and the user's
// 5 attributes are read again only where a row ends. The arithmetic is
// what bounds the kernel once the stores are vectors (a store-only
// stream of the same bytes takes half its time), and only pairs of one
// service need it: the others are exactly 0 (qos_entry). Each group is one
// 16-byte streaming store (__stcs: the output does not fit in L2), so a
// warp writes 512 contiguous bytes (the output must start on a 16-byte
// boundary, as the wrapper's always does; the launch refuses any other),
// and the elements after the last whole group take scalar stores. A pair
// of one service is qos_pair
// on the same operands as before, any other pair +0 as before, so the
// output keeps equal bits.
// ---------------------------------------------------------------------------
constexpr int kMatrixThreads = 256;

struct UserAttrs {
  float alpha, delta, share_k, share_w;
  int service;
};

__device__ __forceinline__ UserAttrs user_attrs(
    const float* __restrict__ u_alpha, const float* __restrict__ u_delta,
    const float* __restrict__ u_share_k, const float* __restrict__ u_share_w,
    const int* __restrict__ u_service, int64_t u) {
  return {__ldg(u_alpha + u), __ldg(u_delta + u), __ldg(u_share_k + u),
          __ldg(u_share_w + u), __ldg(u_service + u)};
}

// Shared-memory slot of model p's record (see the skew above).
__device__ __forceinline__ int model_slot(int p) { return p + (p >> 3); }

// qos_pair times [the services match]. qos_pair is finite and >= 0 for any
// operands (each fmaxf drops a NaN), so its product with 0 is +0 and with 1
// is itself: a pair of different services skips the arithmetic and keeps
// the same bits.
__device__ __forceinline__ float qos_entry(const UserAttrs& a,
                                           const float4& model,
                                           float delta_max) {
  if (a.service != __float_as_int(model.w)) return 0.0f;
  return qos_pair(a.alpha, a.delta, a.share_k, a.share_w, model.x, model.y,
                  model.z, delta_max);
}

__global__ void __launch_bounds__(kMatrixThreads) qos_matrix_kernel(
    const float* __restrict__ u_alpha, const float* __restrict__ u_delta,
    const float* __restrict__ u_share_k, const float* __restrict__ u_share_w,
    const int* __restrict__ u_service, const float* __restrict__ sm_acc,
    const float* __restrict__ sm_k, const float* __restrict__ sm_w,
    const int* __restrict__ sm_service, float* __restrict__ out, int64_t U,
    int P, float delta_max) {
  extern __shared__ float4 models[];  // acc, k, w, service bits; skewed
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    models[model_slot(p)] = make_float4(sm_acc[p], sm_k[p], sm_w[p],
                                        __int_as_float(sm_service[p]));
  __syncthreads();

  const int64_t n = U * P;
  const int64_t groups = n / 4;
  const int64_t gt = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * blockDim.x;

  // the scalar tail after the last whole group, at most 3 elements
  if (gt < n - 4 * groups) {
    const int64_t e = 4 * groups + gt;
    const int64_t u = e / P;
    const UserAttrs a = user_attrs(u_alpha, u_delta, u_share_k, u_share_w,
                                   u_service, u);
    out[e] = qos_entry(a, models[model_slot(static_cast<int>(e - u * P))],
                       delta_max);
  }

  if (gt >= groups) return;
  int64_t u = 4 * gt / P;
  int p = static_cast<int>(4 * gt - u * P);
  const int64_t du = 4 * threads / P;
  const int dp = static_cast<int>(4 * threads - du * P);
  float4* out4 = reinterpret_cast<float4*>(out);
  UserAttrs a = user_attrs(u_alpha, u_delta, u_share_k, u_share_w, u_service,
                           u);
  for (int64_t g = gt; g < groups; g += threads) {
    // the next group's (u, p), and its user's attributes, requested now so
    // that their latency hides behind this group's work
    int64_t u_next = u + du;
    int p_next = p + dp;
    if (p_next >= P) {
      p_next -= P;
      ++u_next;
    }
    const UserAttrs a_next =
        g + threads < groups ? user_attrs(u_alpha, u_delta, u_share_k,
                                          u_share_w, u_service, u_next)
                             : a;
    float v[4];
    int pp = p;
    int64_t uu = u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = qos_entry(a, models[model_slot(pp)], delta_max);
      if (++pp == P) {  // the row ends inside the group
        pp = 0;
        ++uu;
        if (i < 3)
          a = user_attrs(u_alpha, u_delta, u_share_k, u_share_w, u_service,
                         uu);
      }
    }
    __stcs(out4 + g, make_float4(v[0], v[1], v[2], v[3]));
    u = u_next;
    p = p_next;
    a = a_next;
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

const char* cuda_error_string(int code) {
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
  if (U <= 0 || P <= 0 || P > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = static_cast<size_t>(P + P / 8 + 1) * sizeof(float4);
  int smem_max = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(qos_matrix_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qos_matrix_kernel, kMatrixThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = static_cast<int64_t>(U) * P / 4;
  const int64_t grid = blocks_for(groups > 0 ? groups : 1, kMatrixThreads);
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) *
                           sms;
  qos_matrix_kernel<<<static_cast<unsigned>(grid < resident ? grid
                                                            : resident),
                      kMatrixThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_alpha), static_cast<const float*>(u_delta),
      static_cast<const float*>(u_share_k),
      static_cast<const float*>(u_share_w),
      static_cast<const int*>(u_service), static_cast<const float*>(sm_acc),
      static_cast<const float*>(sm_k), static_cast<const float*>(sm_w),
      static_cast<const int*>(sm_service), static_cast<float*>(out), U,
      static_cast<int>(P), delta_max);
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
