// Dense 3-way MTTKRP for Hopper (sm_90a), modes 0, 1 and 2.
//
//   mode 0: out[i,r] = sum_{j,k} X[i,j,k] B[j,r] C[k,r]
//   mode 1: out[j,r] = sum_{i,k} X[i,j,k] A[i,r] C[k,r]
//   mode 2: out[k,r] = sum_{i,j} X[i,j,k] A[i,r] B[j,r]
//
// Replaces matlab_code_tpu/ops/mttkrp_pallas.py::mttkrp3_mode0 (the Pallas
// kernel for mode 0) and extends it to modes 1 and 2, which the AO sweep
// also runs.  X is row-major (I, J, K) and contiguous; factors are
// row-major (n, R) and contiguous; everything is float32 or float64.
//
// What bounds it: about 2R flops per element of X (8-15 flop/byte at
// R = 16-20 in float32), far below the card's float32 ridge, so the roof is
// X's bytes over HBM bandwidth.  The design therefore reads X exactly once,
// coalesced along the contiguous k axis, and keeps everything else in
// registers and shared memory:
//
// * Every thread owns one k (threads of a warp own consecutive k, so each
//   load of X is one 128-byte line per warp) and walks a range of rows s of
//   X, accumulating acc[r] += X[.., s, k] * F[s, r] in registers.  The rows
//   F[s, :] of the walked factor sit in shared memory, zero-padded to RM
//   columns, and are read as 16-byte broadcasts.
// * Modes 0 and 1 (kernel mttkrp3_rows): a block owns one output row o and a
//   split of the walked axis (j for mode 0, i for mode 1).  After the walk
//   each thread scales by C[k, :] and the block reduces over k into one
//   partial row.  Mode 2 (kernel mttkrp3_mode2): a block owns a tile of k,
//   a split of i and a split of j; each thread walks j for each of its i,
//   scales by A[i, :] and keeps its own output row, so no cross-thread
//   reduction is needed.
// * No sequential grid: the TPU kernel carried out[i] across its sequential
//   j axis, but blocks here run in no order.  Splits write partial results
//   to a scratch buffer and reduce_splits sums them in a fixed order, so
//   repeated calls give the same bits (no atomics).
// * Ragged edges are masked: any I, J, K >= 1, and 1 <= R <= 32 (R is
//   padded to RM in {8, 16, 24, 32} in registers and shared memory).
//
// The launch plan (block shape, splits, rows per split) is computed by the
// Python wrapper, matlab_code_tpu_torch/ops/mttkrp_cuda.py.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsThreads = 256;

template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int n = 2; };

__device__ __forceinline__ void fma_vec(float* acc, float x, float4 v) {
  acc[0] = fmaf(x, v.x, acc[0]);
  acc[1] = fmaf(x, v.y, acc[1]);
  acc[2] = fmaf(x, v.z, acc[2]);
  acc[3] = fmaf(x, v.w, acc[3]);
}

__device__ __forceinline__ void fma_vec(double* acc, double x, double2 v) {
  acc[0] = fma(x, v.x, acc[0]);
  acc[1] = fma(x, v.y, acc[1]);
}

// acc[r] += sum over s = first, first + step, ... < n of xp[s * stride] * tile[s * RM + r]
template <typename T, int RM>
__device__ __forceinline__ void fiber_dot(T (&acc)[RM], const T* __restrict__ xp,
                                          long long stride, int first, int n,
                                          int step, const T* tile) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll 4
  for (int s = first; s < n; s += step) {
    const T x = __ldg(xp + s * stride);
    const VT* row = reinterpret_cast<const VT*>(tile + s * RM);
#pragma unroll
    for (int q = 0; q < RM / VN; ++q) fma_vec(acc + q * VN, x, row[q]);
  }
}

// tile[s * RM + r] = F[row0 + s, r] for r < R, 0 for R <= r < RM
template <typename T, int RM>
__device__ void load_tile(T* tile, const T* __restrict__ F, int row0, int nrows,
                          int R) {
  const int nthreads = blockDim.x * blockDim.y;
  for (int idx = threadIdx.x + threadIdx.y * blockDim.x; idx < nrows * RM;
       idx += nthreads) {
    const int s = idx / RM;
    const int r = idx - s * RM;
    tile[idx] = r < R ? F[(long long)(row0 + s) * R + r] : T(0);
  }
}

template <typename T, int RM>
__global__ void __launch_bounds__(kRowsThreads)
mttkrp3_rows(const T* __restrict__ X, const T* __restrict__ S,
             const T* __restrict__ C, T* __restrict__ out, int O, int Sn,
             int K, int R, long long stride_o, long long stride_s,
             int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  T* red = tile + (long long)per_split * RM;
  const int o = blockIdx.x;
  const int split = blockIdx.y;
  const int s0 = split * per_split;
  const int ns = max(0, min(per_split, Sn - s0));
  load_tile<T, RM>(tile, S, s0, ns, R);
  __syncthreads();

  T res[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) res[r] = T(0);
  const T* xo = X + o * stride_o + s0 * stride_s;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    T acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = T(0);
    fiber_dot<T, RM>(acc, xo + k, stride_s, threadIdx.y, ns, blockDim.y, tile);
#pragma unroll
    for (int r = 0; r < RM; ++r)
      res[r] += acc[r] * (r < R ? __ldg(C + (long long)k * R + r) : T(0));
  }

  // block reduction over every thread (k and the row phase), fixed order
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    T v = res[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * RM + r] = v;
  }
  __syncthreads();
  if (tid < R) {
    T v = T(0);
    for (int w = 0; w < kRowsThreads / 32; ++w) v += red[w * RM + tid];
    out[((long long)split * O + o) * R + tid] = v;
  }
}

template <typename T, int RM>
__global__ void mttkrp3_mode2(const T* __restrict__ X, const T* __restrict__ A,
                              const T* __restrict__ B, T* __restrict__ out,
                              int I, int J, int K, int R, int i_per, int j_per,
                              int n_jsplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int jsplit = blockIdx.y;
  const int isplit = blockIdx.z;
  const int i0 = isplit * i_per;
  const int ni = max(0, min(i_per, I - i0));
  const int j0 = jsplit * j_per;
  const int nj = max(0, min(j_per, J - j0));
  load_tile<T, RM>(tile, B, j0, nj, R);
  __syncthreads();
  if (k >= K) return;

  T res[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) res[r] = T(0);
  for (int i = i0; i < i0 + ni; ++i) {
    T acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = T(0);
    fiber_dot<T, RM>(acc, X + ((long long)i * J + j0) * K + k, K, 0, nj, 1, tile);
#pragma unroll
    for (int r = 0; r < RM; ++r)
      res[r] += acc[r] * (r < R ? __ldg(A + (long long)i * R + r) : T(0));
  }
  T* dst = out + ((long long)(isplit * n_jsplit + jsplit) * K + k) * R;
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (r < R) dst[r] = res[r];
}

// out[idx] = sum_{s < nsplit} part[s * n + idx], summed in split order
template <typename T>
__global__ void reduce_splits(const T* __restrict__ part, T* __restrict__ out,
                              long long n, int nsplit) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    T v = T(0);
    for (int s = 0; s < nsplit; ++s) v += part[s * n + idx];
    out[idx] = v;
  }
}

template <typename T, int RM>
cudaError_t launch(int mode, const T* X, const T* F0, const T* F1, T* part,
                   T* out, int I, int J, int K, int R, int tk, int ns_a,
                   int ns_b, int per_a, int per_b, cudaStream_t stream) {
  const int nsplit = mode == 2 ? ns_a * ns_b : ns_a;
  T* dst = nsplit > 1 ? part : out;
  if (mode < 2) {
    const int O = mode == 0 ? I : J;
    const int Sn = mode == 0 ? J : I;
    const long long stride_o = mode == 0 ? (long long)J * K : K;
    const long long stride_s = mode == 0 ? K : (long long)J * K;
    const dim3 block(tk, kRowsThreads / tk);
    const dim3 grid(O, ns_a);
    const size_t smem = ((size_t)per_a * RM + (kRowsThreads / 32) * RM) * sizeof(T);
    mttkrp3_rows<T, RM><<<grid, block, smem, stream>>>(
        X, F0, F1, dst, O, Sn, K, R, stride_o, stride_s, per_a);
  } else {
    const dim3 block(tk);
    const dim3 grid((K + tk - 1) / tk, ns_b, ns_a);
    const size_t smem = (size_t)per_b * RM * sizeof(T);
    mttkrp3_mode2<T, RM><<<grid, block, smem, stream>>>(
        X, F0, F1, dst, I, J, K, R, per_a, per_b, ns_b);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const long long n = (long long)(mode == 0 ? I : mode == 1 ? J : K) * R;
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  reduce_splits<T><<<(unsigned)blocks, 256, 0, stream>>>(part, out, n, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int rm, int mode, const void* X, const void* F0,
                     const void* F1, void* part, void* out, int I, int J, int K,
                     int R, int tk, int ns_a, int ns_b, int per_a, int per_b,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(X);
  const T* f0 = static_cast<const T*>(F0);
  const T* f1 = static_cast<const T*>(F1);
  T* p = static_cast<T*>(part);
  T* o = static_cast<T*>(out);
  switch (rm) {
    case 8: return launch<T, 8>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 16: return launch<T, 16>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 24: return launch<T, 24>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 32: return launch<T, 32>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry for ctypes.  Modes 0/1: F0 is the walked factor (B for mode 0, A
// for mode 1) and F1 = C; ns_a/per_a are the splits of the walked axis.
// Mode 2: F0 = A, F1 = B; ns_a/per_a split i and ns_b/per_b split j.  part
// holds the split partials when there is more than one split.  Returns
// cudaGetLastError() after the launches.
extern "C" int mttkrp3_run(int is_double, int rm, int mode, const void* X,
                           const void* F0, const void* F1, void* part,
                           void* out, int I, int J, int K, int R, int tk,
                           int ns_a, int ns_b, int per_a, int per_b,
                           void* stream) {
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_double
      ? dispatch<double>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, st)
      : dispatch<float>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, st);
  return (int)err;
}
