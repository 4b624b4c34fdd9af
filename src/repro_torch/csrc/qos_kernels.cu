// Hand-written Hopper (sm_90a) kernels for the PIES placement hot path.
//
// Four kernels for the three Pallas TPU kernels of the JAX reference
// (src/repro/kernels/qos_matrix/qos_matrix.py):
//
//   qos_matrix_kernel      <- qos_matrix_pallas / _qos_kernel
//   qos_candidates_kernel  <- qos_candidates_pallas / _qos_cand_kernel
//   topk_candidates_kernel <- qos_candidates_pallas with the candidate
//                             build around it (topk_candidates_jnp)
//   greedy_argmax_kernel   <- greedy_argmax_pallas / _greedy_argmax_kernel
//
// All of them do a few float32 compares, selects and multiply-adds per byte
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
// B2 on the main path, topk_candidates: the whole top-k candidate build of
// topk_candidates_jnp (src/repro/core/candidates.py) in one launch.
//
// Per user u: the row table[u_service[u]] of the impl table [S, M] (model
// indices, -1 padded), qos_pair for each model in it, and either the row
// in table order (k == M) or its k best by a stable descending selection
// (k < M): only a strictly greater value moves ahead, so among equal QoS
// the lower table position, and so the lower model index, comes first,
// which is lax.top_k's order. A padded slot, an entry outside [0, P) and
// every slot of a service outside [0, S) count -1 and sort last; a kept
// slot whose value is -1 is written as (-1, 0). A value is qos_pair's
// bits, as in the plain version (topk_candidates_ref), whose QoS is
// qos_pair times a valid flag of 1.
//
// Replaces, on the main path, the torch sequence around
// qos_candidates_kernel (gathers, casts, the segmented QoS, the sort, the
// selects: about 14 launches moving 1.26 GB at U = 1e6, M = 10). Bound:
// 20 B read per user (service and four attributes) and 8 B written per
// kept slot, 0.0299 ms at U = 1e6, k = 10. Design: a persistent grid;
// each block stages the table and the P model records (acc, k, w) in
// shared memory once (12.6 KB at S = 100, M = 10, P = 537) and walks tiles
// of kTopkThreads users, one thread a user, so the attribute loads are
// coalesced; the selection lives in registers (kTopkMax slots, unrolled);
// a tile's [users, k] outputs, contiguous in both outputs, are staged in
// shared memory and written as 16-byte streaming stores. A table and
// records larger than a block's shared memory are read through L1/L2
// instead (kStaged = false); the outputs are staged either way.
// ---------------------------------------------------------------------------
constexpr int kTopkThreads = 256;
constexpr int kTopkMax = 16;  // the widest impl table the selection holds
constexpr float kSlotEmpty = -2.0f;  // below every slot's value (>= -1)

template <bool kStaged>
__global__ void __launch_bounds__(kTopkThreads) topk_candidates_kernel(
    const int* __restrict__ u_service, const float* __restrict__ u_alpha,
    const float* __restrict__ u_delta, const float* __restrict__ u_share_k,
    const float* __restrict__ u_share_w, const int* __restrict__ table,
    const float* __restrict__ sm_acc, const float* __restrict__ sm_k,
    const float* __restrict__ sm_w, int* __restrict__ cand_idx,
    float* __restrict__ cand_q, int64_t U, int S, int M, int P, int k,
    float delta_max) {
  // shared layout: the staged outputs (kTopkThreads * k ints, then as many
  // floats), then, when kStaged, the model records and the table; every
  // part starts on a 16-byte boundary
  extern __shared__ float4 smem4[];
  int* st_idx = reinterpret_cast<int*>(smem4);
  float* st_q = reinterpret_cast<float*>(st_idx + kTopkThreads * k);
  float4* models = reinterpret_cast<float4*>(st_q + kTopkThreads * k);
  const int* tab = table;
  if (kStaged) {
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      models[p] = make_float4(sm_acc[p], sm_k[p], sm_w[p], 0.0f);
    int* t = reinterpret_cast<int*>(models + P);
    for (int i = threadIdx.x; i < S * M; i += blockDim.x) t[i] = table[i];
    tab = t;
    __syncthreads();
  }

  const int64_t n_tiles = (U + kTopkThreads - 1) / kTopkThreads;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t u0 = tile * kTopkThreads;
    const int64_t u = u0 + threadIdx.x;
    if (u < U) {
      const int s = u_service[u];
      const float alpha = u_alpha[u], delta = u_delta[u];
      const float share_k = u_share_k[u], share_w = u_share_w[u];
      const bool has_row = s >= 0 && s < S;
      const int* row = tab + static_cast<int64_t>(has_row ? s : 0) * M;
      int* oi = st_idx + threadIdx.x * k;
      float* oq = st_q + threadIdx.x * k;
      // -1 for a slot without a model, else qos_pair (finite and >= 0)
      auto slot = [&](int j, int& p) -> float {
        p = has_row ? (kStaged ? row[j] : __ldg(row + j)) : -1;
        if (p < 0 || p >= P) return -1.0f;
        float acc, kc, wc;
        if (kStaged) {
          const float4 m = models[p];
          acc = m.x, kc = m.y, wc = m.z;
        } else {
          acc = __ldg(sm_acc + p), kc = __ldg(sm_k + p),
          wc = __ldg(sm_w + p);
        }
        return qos_pair(alpha, delta, share_k, share_w, acc, kc, wc,
                        delta_max);
      };
      if (k == M) {  // every slot, in table order
        for (int j = 0; j < M; ++j) {
          int p;
          const float q = slot(j, p);
          oi[j] = q >= 0.0f ? p : -1;
          oq[j] = q >= 0.0f ? q : 0.0f;
        }
      } else {  // stable descending insertion into k register slots
        float val[kTopkMax];
        int idx[kTopkMax];
#pragma unroll
        for (int i = 0; i < kTopkMax; ++i) {
          val[i] = kSlotEmpty;
          idx[i] = -1;
        }
        for (int j = 0; j < M; ++j) {
          int cp;
          float cv = slot(j, cp);
          bool moved = false;  // once placed, the rest shift down by one
#pragma unroll
          for (int i = 0; i < kTopkMax; ++i) {
            if (i < k && (moved || cv > val[i])) {
              const float tv = val[i];
              const int tp = idx[i];
              val[i] = cv;
              idx[i] = cp;
              cv = tv;
              cp = tp;
              moved = true;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTopkMax; ++i) {
          if (i < k) {
            oi[i] = val[i] >= 0.0f ? idx[i] : -1;
            oq[i] = val[i] >= 0.0f ? val[i] : 0.0f;
          }
        }
      }
    }
    __syncthreads();
    // the tile's rows are contiguous in both outputs and start on a
    // 16-byte boundary (u0 * k * 4 is a multiple of 1024)
    const int n = static_cast<int>(
        (U - u0 < kTopkThreads ? U - u0 : kTopkThreads) * k);
    const int n4 = n / 4;
    int4* gi = reinterpret_cast<int4*>(cand_idx + u0 * k);
    float4* gq = reinterpret_cast<float4*>(cand_q + u0 * k);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      __stcs(gi + i, reinterpret_cast<const int4*>(st_idx)[i]);
      __stcs(gq + i, reinterpret_cast<const float4*>(st_q)[i]);
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
      cand_idx[u0 * k + i] = st_idx[i];
      cand_q[u0 * k + i] = st_q[i];
    }
    __syncthreads();  // the staging is free again
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

int topk_candidates_launch(const void* u_service, const void* u_alpha,
                           const void* u_delta, const void* u_share_k,
                           const void* u_share_w, const void* table,
                           const void* sm_acc, const void* sm_k,
                           const void* sm_w, void* cand_idx, void* cand_q,
                           long long U, int S, int M, int P, int k,
                           float delta_max, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (U <= 0 || S < 0 || P < 0 || M < 1 || M > kTopkMax || k < 1 || k > M ||
      static_cast<long long>(S) * M > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(cand_idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cand_q) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int smem_max = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem_out = 2 * static_cast<size_t>(kTopkThreads) * k * 4;
  const size_t smem_staged = smem_out + static_cast<size_t>(P) * 16 +
                             static_cast<size_t>(S) * M * 4;
  const bool staged = smem_staged <= static_cast<size_t>(smem_max);
  const size_t smem = staged ? smem_staged : smem_out;
  auto kernel = staged ? topk_candidates_kernel<true>
                       : topk_candidates_kernel<false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTopkThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = blocks_for(U, kTopkThreads);
  const int64_t resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) *
                           sms;
  kernel<<<static_cast<unsigned>(tiles < resident ? tiles : resident),
           kTopkThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(u_service), static_cast<const float*>(u_alpha),
      static_cast<const float*>(u_delta),
      static_cast<const float*>(u_share_k),
      static_cast<const float*>(u_share_w), static_cast<const int*>(table),
      static_cast<const float*>(sm_acc), static_cast<const float*>(sm_k),
      static_cast<const float*>(sm_w), static_cast<int*>(cand_idx),
      static_cast<float*>(cand_q), U, S, M, P, k, delta_max);
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
