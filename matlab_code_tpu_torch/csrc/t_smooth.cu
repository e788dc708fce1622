// Kernel C: the tPARAFAC2 temporal-smoothness prox of a stack of PARAFAC2
// slices, for Hopper (sm_90a), bound by matlab_code_tpu_torch/ops/
// prox_cuda.py (a plain C entry, ctypes).
//
// Replaces the two lax.scans of matlab_code_tpu/ops/prox.py:144-188
// (t_smoothness_prox; functions/t_smoothness_prox.m:23-56).  For Bs
// (K, J, R) and rho (K,) it solves the block-tridiagonal system whose
// diagonal is 4 eta + rho_k (2 eta + rho_k at k = 0 and k = K - 1), whose
// off-diagonal is -2 eta and whose right-hand side is rho_k B_k, by the
// Thomas algorithm.  The system is the same for every one of the E = J R
// elements: only the right-hand side differs.  So the scalar recurrence
//   m_k = off / d'_{k-1},  d'_k = d_k - m_k off
// is computed once a block, by one thread, into shared memory, and each
// thread then walks one element (j, r) forward over k,
//   r'_k = rho_k B_k[e] - m_k r'_{k-1},
// and back,
//   x_{K-1} = r'_{K-1} / d'_{K-1},  x_k = (r'_k - off x_{k+1}) / d'_k.
// Neighbouring threads take neighbouring elements, so every load and store
// of a step is coalesced (slice k of the stack is E contiguous elements).
//
// Two routes, chosen by the wrapper before the launch
// (prox_cuda.plan_t_smooth):
//
//   staged  (the second design) a block of kStageThreads threads takes a
//           tile of kTile consecutive elements over all K slices: every
//           thread stages rho_k B_k of the tile into shared memory (a
//           coalesced row of the tile a warp, many loads in flight while
//           thread 0 walks the recurrence), one warp walks the kTile
//           elements forward and back in shared memory, and every thread
//           writes the tile out.  Device memory is read once and written
//           once.  It holds (2 + kTile) K values a block, so K <= 1701 in
//           float32 and K <= 850 in float64.
//   stream  (the first design) for longer K: a block of kThreads threads,
//           one element a thread, r'_k kept in the output buffer between
//           the two passes (about twice the bytes), the loads of later
//           steps unrolled into flight.
//
// What bounds it: the bytes (B read once, X written once: 33.6 MB at K =
// 512, J = 256, R = 32 in float32, 10.0 us at 3.35 TB/s); the dependent
// steps (2K a walk, one of them a division on the way back, and the
// recurrence's K divisions) come close to that, so the staged route
// overlaps the recurrence with the staging.
//
// Arithmetic: in the storage type T, in the JAX module's order of
// operations (m = off / d', d - m off, r - m r', (r' - off x) / d', no
// reciprocal), with every product and sum written as an _rn intrinsic so
// that nvcc contracts nothing into a fused multiply-add: the result is the
// plain version's (ops/prox.t_smoothness_reference) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;        // stream route: threads a block, an element each
constexpr int kTile = 32;           // staged route: elements a block, one warp walks them
constexpr int kStageThreads = 128;  // staged route: threads a block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }

// The k-th diagonal entry: 4 eta + rho_k, plus -2 eta at k = 0 and then at
// k = K - 1 (both at k = 0 when K = 1), in the JAX module's order.
template <typename T>
__device__ __forceinline__ T diag_at(int k, int K, T four_eta, T neg_two_eta,
                                     const T* rho) {
  T d = add(four_eta, rho[k]);
  if (k == 0) d = add(d, neg_two_eta);
  if (k == K - 1) d = add(d, neg_two_eta);
  return d;
}

// The scalar recurrence into shared memory, by the calling thread:
// d'_0 = d_0, m_k = off / d'_{k-1}, d'_k = d_k - m_k off.
template <typename T>
__device__ __forceinline__ void recurrence(const T* __restrict__ rho, int K,
                                           T eta, T off, T* dmod, T* mk) {
  const T four_eta = mul(static_cast<T>(4.0), eta);
  T d = diag_at(0, K, four_eta, off, rho);
  dmod[0] = d;
  for (int k = 1; k < K; ++k) {
    const T m = quot(off, d);
    mk[k] = m;
    d = sub(diag_at(k, K, four_eta, off, rho), mul(m, off));
    dmod[k] = d;
  }
}

// The staged route: a tile of kTile elements a block.
template <typename T>
__global__ void __launch_bounds__(kStageThreads)
t_smooth_staged(const T* __restrict__ B, const T* __restrict__ rho,
                T* __restrict__ X, int K, long E, double eta_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* dmod = reinterpret_cast<T*>(smem);   // d'_k, k = 0 .. K - 1
  T* mk = dmod + K;                        // m_k, k = 1 .. K - 1
  T* tile = mk + K;                        // K x kTile: rho_k B_k, then r', then x
  const T eta = static_cast<T>(eta_in);
  const T off = mul(static_cast<T>(-2.0), eta);
  const long e0 = static_cast<long>(blockIdx.x) * kTile;
  const int n = static_cast<int>(E - e0 < kTile ? E - e0 : kTile);
  if (threadIdx.x == 0) recurrence(rho, K, eta, off, dmod, mk);
#pragma unroll 8
  for (int i = threadIdx.x; i < K * kTile; i += kStageThreads) {
    const int k = i / kTile, w = i % kTile;
    if (w < n) tile[i] = mul(rho[k], B[static_cast<long>(k) * E + e0 + w]);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    const int w = threadIdx.x;
    T r = tile[w];
    for (int k = 1; k < K; ++k) {
      r = sub(tile[k * kTile + w], mul(mk[k], r));
      tile[k * kTile + w] = r;
    }
    T x = quot(r, dmod[K - 1]);
    tile[(K - 1) * kTile + w] = x;
    for (int k = K - 2; k >= 0; --k) {
      x = quot(sub(tile[k * kTile + w], mul(off, x)), dmod[k]);
      tile[k * kTile + w] = x;
    }
  }
  __syncthreads();
#pragma unroll 8
  for (int i = threadIdx.x; i < K * kTile; i += kStageThreads) {
    const int k = i / kTile, w = i % kTile;
    if (w < n) X[static_cast<long>(k) * E + e0 + w] = tile[i];
  }
}

// The stream route: an element a thread, r' kept in X.
template <typename T>
__global__ void __launch_bounds__(kThreads)
t_smooth_cols(const T* __restrict__ B, const T* __restrict__ rho,
              T* __restrict__ X, int K, long E, double eta_in) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* dmod = reinterpret_cast<T*>(smem);   // d'_k, k = 0 .. K - 1
  T* mk = dmod + K;                        // m_k, k = 1 .. K - 1
  const T eta = static_cast<T>(eta_in);
  const T off = mul(static_cast<T>(-2.0), eta);
  if (threadIdx.x == 0) recurrence(rho, K, eta, off, dmod, mk);
  __syncthreads();
  const long e = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= E) return;
  T r = mul(rho[0], B[e]);
  X[e] = r;
  // unrolled so that the loads of later steps, which do not wait on the
  // chain, are in flight while it runs: a block holds few warps to hide
  // their latency otherwise
#pragma unroll 8
  for (int k = 1; k < K; ++k) {
    const long i = static_cast<long>(k) * E + e;
    r = sub(mul(rho[k], B[i]), mul(mk[k], r));
    X[i] = r;
  }
  T x = quot(r, dmod[K - 1]);
  X[static_cast<long>(K - 1) * E + e] = x;
#pragma unroll 8
  for (int k = K - 2; k >= 0; --k) {
    const long i = static_cast<long>(k) * E + e;
    x = quot(sub(X[i], mul(off, x)), dmod[k]);
    X[i] = x;
  }
}

template <typename K_>
cudaError_t allow_smem(K_* kernel, long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <typename T>
int t_smooth_launch(int staged, const void* B, const void* rho, void* X, int K,
                    long E, double eta, long smem, cudaStream_t st) {
  const T* b = static_cast<const T*>(B);
  const T* r = static_cast<const T*>(rho);
  T* x = static_cast<T*>(X);
  cudaError_t e;
  if (staged) {
    auto* k = t_smooth_staged<T>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<(E + kTile - 1) / kTile, kStageThreads, smem, st>>>(b, r, x, K, E, eta);
  } else {
    auto* k = t_smooth_cols<T>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<(E + kThreads - 1) / kThreads, kThreads, smem, st>>>(b, r, x, K, E, eta);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  is_double selects float64 (else float32); staged
// the staged route (else the stream route).  B and X: (K, E) contiguous
// (E = J R elements a slice); rho: K values of the same type on the
// device; smem: the route's bytes of shared memory a block, (2 + kTile) K
// values staged, 2 K streamed (prox_cuda.plan_t_smooth).  Returns the
// launch's CUDA error.
extern "C" int t_smooth_run(int is_double, int staged, const void* B,
                            const void* rho, void* X, int K, long E,
                            double eta, long smem, void* stream) {
  const long item = is_double ? 8 : 4;
  if (K < 1 || E < 1 || smem < (staged ? 2 + kTile : 2) * item * K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? t_smooth_launch<double>(staged, B, rho, X, K, E, eta, smem, st)
                   : t_smooth_launch<float>(staged, B, rho, X, K, E, eta, smem, st);
}
