// Sparse COO MTTKRP for Hopper (sm_90a).
//
//   out[i, r] = sum over the nonzeros n with idx[n, mode] = i of
//               v[n] * F_0[c_0(n), r] * ... * F_{NG-1}[c_{NG-1}(n), r]
//
// F_g are the factors of the gathered modes (every mode but `mode`, in
// ascending order: two for a 3-way tensor) and c_g(n) the nonzero's
// coordinates in them.  Duplicate coordinates are summed; rows with no
// nonzero are 0.  float32 or float64, int32 coordinates, 1 <= NG <= 4.
//
// Replaces matlab_code_tpu/ops/sparse_pallas.py::mttkrp_sparse_pallas (the
// pallas_call at sparse_pallas.py:300, body _kernel at :181-230).  The TPU
// kernel buckets nonzeros by 128-row factor tiles and turns the gathers and
// the scatter into one-hot matmuls on the MXU, fed as bf16 splits.  None of
// that applies here: a lane loads a factor entry exactly from memory.
//
// What bounds it: the plan stream, 12 bytes a nonzero in float32 (two int32
// coordinates and the value), read once from HBM: about 36 us at 1e7
// nonzeros and 3.35 TB/s.  The factor gathers are 4R bytes a row each, ten
// times that traffic at R = 16, but the factors (2 x 2048 x 16 x 4 bytes at
// the sparse workload) sit in the 50 MB L2, so they are L2 traffic.  About
// 3R flops a nonzero are far below any compute roof.  The design:
//
// * The plan (ops/sparse_cuda.build_plan) sorts the nonzeros by the target
//   mode's index and cuts every row into chunks of at most CHUNK nonzeros;
//   chunk c holds the sorted nonzeros chunk_start[c] .. chunk_start[c+1]-1
//   and row i's chunks are chunk_ptr[i] .. chunk_ptr[i+1]-1.  Chunks keep
//   the card busy even when a row holds thousands of nonzeros (1e7 over
//   2048 rows is ~4,900 a row: one warp a row would be 2,048 warps).
// * chunk_partials: one warp a chunk.  The warp reads 32 nonzeros at a time
//   coalesced, one a lane, and broadcasts them with __shfl_sync.  The warp
//   is cut into 32/P groups of P lanes (P = 8, 16 or 32, the smallest that
//   covers R, or 32); each group takes its own nonzero of the 32 while its
//   lanes run over P columns r, so at R = 16 no lane idles.  grid.y walks
//   R in tiles of P, so any R >= 1 is taken.  Each lane sums in registers,
//   in the working type; the groups are then summed by a fixed xor
//   butterfly and the warp writes one partial row per chunk.
// * row_sums: out[i, r] is the sum of row i's chunk partials in chunk
//   order, 0 for a row with no chunk.
// * No atomics anywhere, so repeated calls give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGathered = 4;
constexpr int kWarps = 8;   // warps (chunks) per block of chunk_partials
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Factors {
  const T* f[kMaxGathered];
};

template <typename T, int NG, int P>
__global__ void __launch_bounds__(kWarps * 32)
chunk_partials(const int* __restrict__ coords, const T* __restrict__ vals,
               const long long* __restrict__ chunk_start, Factors<T> F,
               T* __restrict__ partial, long long nchunks, int R) {
  constexpr int G = 32 / P;   // nonzeros taken per step, one per group
  const int lane = threadIdx.x & 31;
  const long long chunk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= nchunks) return;   // the whole warp leaves together
  const int grp = lane / P;
  const int r = blockIdx.y * P + (lane - grp * P);
  const bool active = r < R;
  const long long lo = chunk_start[chunk];
  const long long hi = chunk_start[chunk + 1];

  T acc = T(0);
  for (long long base = lo; base < hi; base += 32) {
    const int n = (int)min(32LL, hi - base);
    T v = T(0);
    int c[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) c[g] = 0;
    if (lane < n) {
      v = vals[base + lane];
#pragma unroll
      for (int g = 0; g < NG; ++g) c[g] = coords[(base + lane) * NG + g];
    }
#pragma unroll
    for (int s = 0; s < 32; s += G) {
      const int t = s + grp;
      const T vt = __shfl_sync(kFull, v, t);
      int ct[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) ct[g] = __shfl_sync(kFull, c[g], t);
      if (active && t < n) {
        T prod = vt;
#pragma unroll
        for (int g = 0; g < NG; ++g) prod *= __ldg(F.f[g] + (long long)ct[g] * R + r);
        acc += prod;
      }
    }
  }
#pragma unroll
  for (int off = P; off < 32; off <<= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (grp == 0 && active) partial[chunk * R + r] = acc;
}

// out[i, r] = sum of partial[c, r] over row i's chunks, in chunk order
template <typename T>
__global__ void row_sums(const T* __restrict__ partial,
                         const long long* __restrict__ chunk_ptr,
                         T* __restrict__ out, long long n, int R) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / R;
    const long long r = idx - row * R;
    T s = T(0);
    for (long long c = chunk_ptr[row]; c < chunk_ptr[row + 1]; ++c) s += partial[c * R + r];
    out[idx] = s;
  }
}

template <typename T, int NG, int P>
cudaError_t launch(const int* coords, const T* vals, const long long* chunk_start,
                   const long long* chunk_ptr, Factors<T> F, T* partial, T* out,
                   long long nchunks, int D, int R, cudaStream_t stream) {
  if (nchunks > 0) {
    const dim3 grid((unsigned)((nchunks + kWarps - 1) / kWarps), (R + P - 1) / P);
    chunk_partials<T, NG, P><<<grid, kWarps * 32, 0, stream>>>(
        coords, vals, chunk_start, F, partial, nchunks, R);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n = (long long)D * R;
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    row_sums<T><<<(unsigned)blocks, 256, 0, stream>>>(partial, chunk_ptr, out, n, R);
  }
  return cudaGetLastError();
}

template <typename T, int NG>
cudaError_t by_lanes(int lanes, const int* coords, const T* vals,
                     const long long* chunk_start, const long long* chunk_ptr,
                     Factors<T> F, T* partial, T* out, long long nchunks, int D,
                     int R, cudaStream_t stream) {
  switch (lanes) {
    case 8: return launch<T, NG, 8>(coords, vals, chunk_start, chunk_ptr, F, partial, out, nchunks, D, R, stream);
    case 16: return launch<T, NG, 16>(coords, vals, chunk_start, chunk_ptr, F, partial, out, nchunks, D, R, stream);
    case 32: return launch<T, NG, 32>(coords, vals, chunk_start, chunk_ptr, F, partial, out, nchunks, D, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int ng, int lanes, const void* coords, const void* vals,
                     const void* chunk_start, const void* chunk_ptr,
                     const void* const* factors, void* partial, void* out,
                     long long nchunks, int D, int R, cudaStream_t stream) {
  Factors<T> F;
  for (int g = 0; g < kMaxGathered; ++g)
    F.f[g] = g < ng ? static_cast<const T*>(factors[g]) : nullptr;
  const int* c = static_cast<const int*>(coords);
  const T* v = static_cast<const T*>(vals);
  const long long* cs = static_cast<const long long*>(chunk_start);
  const long long* cp = static_cast<const long long*>(chunk_ptr);
  T* p = static_cast<T*>(partial);
  T* o = static_cast<T*>(out);
  switch (ng) {
    case 1: return by_lanes<T, 1>(lanes, c, v, cs, cp, F, p, o, nchunks, D, R, stream);
    case 2: return by_lanes<T, 2>(lanes, c, v, cs, cp, F, p, o, nchunks, D, R, stream);
    case 3: return by_lanes<T, 3>(lanes, c, v, cs, cp, F, p, o, nchunks, D, R, stream);
    case 4: return by_lanes<T, 4>(lanes, c, v, cs, cp, F, p, o, nchunks, D, R, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry for ctypes.  coords (nnz, ng) int32, vals (nnz,), chunk_start
// (nchunks + 1,) and chunk_ptr (D + 1,) int64 come from the plan; f0..f3 are
// the gathered factors, (rows, R) row-major, NULL past ng.  partial holds
// nchunks x R scratch, out is (D, R).  lanes is P above (8, 16 or 32).
// Returns cudaGetLastError() after the launches.
extern "C" int mttkrp_sparse_run(int is_double, int ng, int lanes,
                                 const void* coords, const void* vals,
                                 const void* chunk_start, const void* chunk_ptr,
                                 const void* f0, const void* f1, const void* f2,
                                 const void* f3, void* partial, void* out,
                                 long long nchunks, int D, int R, void* stream) {
  if (R < 1 || D < 0 || nchunks < 0) return (int)cudaErrorInvalidValue;
  const void* factors[kMaxGathered] = {f0, f1, f2, f3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double
      ? dispatch<double>(ng, lanes, coords, vals, chunk_start, chunk_ptr, factors, partial, out, nchunks, D, R, st)
      : dispatch<float>(ng, lanes, coords, vals, chunk_start, chunk_ptr, factors, partial, out, nchunks, D, R, st);
  return (int)err;
}
