// Sparse COO MTTKRP for Hopper (sm_90a).
//
//   out[i, r] = sum over the nonzeros n with idx[n, mode] = i of
//               v[n] * F_0[c_0(n), r] * ... * F_{NG-1}[c_{NG-1}(n), r]
//
// F_g are the factors of the gathered modes (every mode but `mode`: two for
// a 3-way tensor) and c_g(n) the nonzero's coordinates in them.  Duplicate
// coordinates are summed; rows with no nonzero are 0.  float32 or float64,
// int32 coordinates, 1 <= NG <= 4.
//
// Replaces matlab_code_tpu/ops/sparse_pallas.py::mttkrp_sparse_pallas (the
// pallas_call at sparse_pallas.py:300, body _kernel at :181-230).  The TPU
// kernel buckets nonzeros by 128-row factor tiles so that it works against
// factor tiles resident in VMEM, and turns the gathers and the scatter into
// one-hot matmuls on the MXU, fed as bf16 splits.  The matmuls do not apply
// here (a lane loads a factor entry exactly); the resident tile does, in
// shared memory (fiber_partials).
//
// What bounds it: the plan stream, 12 bytes a nonzero in float32 (two int32
// coordinates and the value), read once from HBM: about 36 us at 1e7
// nonzeros and 3.35 TB/s.  Gathering both factor rows for every nonzero
// (4R bytes each, ten times the stream at R = 16) is L2 traffic, since the
// factors (2048 x 16 x 4 bytes each at the sparse workload) sit in the
// 50 MB L2, and that traffic, not the stream, set the pace of
// chunk_partials.  About 3R flops a nonzero are far below any compute roof.
//
// Common to both kernels:
//
// * The plan (ops/sparse_cuda.build_plan) sorts the nonzeros by the target
//   mode's index and cuts every row into chunks of at most CHUNK nonzeros;
//   chunk c holds the sorted nonzeros chunk_start[c] .. chunk_start[c+1]-1
//   and row i's chunks are chunk_ptr[i] .. chunk_ptr[i+1]-1.  Chunks keep
//   the card busy even when a row holds thousands of nonzeros (1e7 over
//   2048 rows is ~4,900 a row: one warp a row would be 2,048 warps).
// * A warp sums a chunk into one partial row of a column tile [r0, r0 + P);
//   grid.y walks R in tiles of P, so any R >= 1 is taken.  The warp is cut
//   into groups of lanes, each summing its own nonzeros; the groups are
//   summed by a fixed xor butterfly.
// * row_sums: out[i, r] is the sum of row i's chunk partials in chunk
//   order, 0 for a row with no chunk.
// * No atomics anywhere, so repeated calls give the same bits.
//
// chunk_partials (any order; the plan's "chunk" variant): one warp a chunk,
// cut into 32/P groups of P lanes (P = 8, 16 or 32, the smallest that covers
// R, or 32); lane c of a group owns column r0 + c.  The warp reads 32
// nonzeros at a time coalesced, one a lane, and broadcasts them with
// __shfl_sync; each group takes its own nonzero of the 32 and multiplies the
// gathered rows of every factor, so at R = 16 no lane idles.
//
// fiber_partials (3-way tensors; the plan's "fiber" variant) takes half of
// the gathers off the L2 and most of the other half:
//
// * The resident factor's column tile [r0, r0 + P) for all its rows sits in
//   dynamic shared memory (2048 x 16 x 4 = 128 KB at the sparse workload,
//   under the 227 KB a block may use).  One persistent block of 32 warps an
//   SM copies it once and then walks chunks c = warp, warp + warps, ...
// * The plan also sorts each row's nonzeros by the fiber mode's coordinate
//   j (coords[:, 0]; the resident coordinate k is coords[:, 1]), so
//   out[i] += F_fib[j] * sum over the fiber's nonzeros of v * F_res[k]
//   needs one F_fib row a fiber (~2.6 nonzeros at the sparse workload).
// * A lane holds 16 bytes of a row (W = 4 floats or 2 doubles), so a
//   nonzero takes Q = P / W lanes and a warp is cut into 32 / Q groups (8 at
//   R 16 in float32): one shuffle round serves 8 nonzeros.  Lane q of a
//   group owns columns r0 + qW .. r0 + qW + W - 1.
// * The warp reads its chunk 32 nonzeros a step, one a lane, coalesced (the
//   next step ahead); group g takes nonzeros g*Q .. g*Q + Q - 1 of each step,
//   broadcast with __shfl_sync of width Q, and walks them in order.  One
//   __ballot_sync marks the group's nonzeros that start a fiber (their
//   fiber coordinate differs from the group's previous one), and each lane
//   loads its 16 bytes of those fibers' F_fib rows into registers, all in
//   flight at once, so a step waits for the L2 once and not once a fiber.
//   Then the lane keeps seg += v * tile[k][its columns] (one 16-byte
//   shared-memory load) and, at each fiber start, adds seg times the last
//   fiber's row into acc.  A fiber that a step or a group boundary cuts is
//   gathered again, which is still right (chip_smoke.py phase 6 counts the
//   rows gathered a nonzero).  P is at most 16, so a step's fiber
//   rows take P registers a lane; a larger R takes more column tiles, each
//   a pass over the stream.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxGathered = 4;
constexpr int kWarps = 8;   // warps (chunks) per block of chunk_partials
constexpr int kFiberWarps = 32;   // warps per block of fiber_partials (one block an SM)
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

// 16 bytes of a row a lane: 4 floats or 2 doubles
template <typename T> struct Row16;
template <> struct Row16<float> {
  static constexpr int W = 4;
  __device__ static void load(const float* p, float (&o)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static void ldg(const float* p, float (&o)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <> struct Row16<double> {
  static constexpr int W = 2;
  __device__ static void load(const double* p, double (&o)[2]) {
    const double2 x = *reinterpret_cast<const double2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
  __device__ static void ldg(const double* p, double (&o)[2]) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = x.x; o[1] = x.y;
  }
};

template <typename T, int P>   // P = 8 or 16 columns a tile
__global__ void __launch_bounds__(kFiberWarps * 32, 1)
fiber_partials(const int* __restrict__ coords, const T* __restrict__ vals,
               const long long* __restrict__ chunk_start,
               const T* __restrict__ f_fib, const T* __restrict__ f_res, int d_res,
               bool rows16, T* __restrict__ partial, long long nchunks, int R) {
  constexpr int W = Row16<T>::W;   // columns a lane
  constexpr int Q = P / W;         // lanes a nonzero
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);   // tile[k * P + c] = F_res[k, r0 + c]
  const int r0 = blockIdx.y * P;
  for (int e = threadIdx.x; e < d_res * P; e += blockDim.x) {
    const int c = e % P;
    tile[e] = r0 + c < R ? f_res[(long long)(e / P) * R + r0 + c] : T(0);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / Q;
  const int q = lane % Q;
  const int r = r0 + q * W;   // this lane's columns r .. r + W - 1
  const bool whole = rows16 && r + W <= R;   // one 16-byte load a fiber row
  const int2* jk = reinterpret_cast<const int2*>(coords);   // (fiber j, resident k)
  const long long stride = (long long)gridDim.x * kFiberWarps;
  for (long long chunk = (long long)blockIdx.x * kFiberWarps + (threadIdx.x >> 5);
       chunk < nchunks; chunk += stride) {   // the whole warp takes one chunk
    const long long lo = chunk_start[chunk];
    const int n = (int)(chunk_start[chunk + 1] - lo);
    T acc[W], seg[W], fcur[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = seg[w] = fcur[w] = T(0);
    int cur = -1;   // fiber coordinate of the group's last nonzero walked
    // step `base`: lane l holds nonzero lo + base + l (the next step's ahead)
    T v = T(0);
    int2 c2 = make_int2(0, 0);
    if (lane < n) {
      v = vals[lo + lane];
      c2 = jk[lo + lane];
    }
    for (int base = 0; base < n; base += 32) {
      T vn = T(0);
      int2 cn = make_int2(0, 0);
      if (base + 32 + lane < n) {
        vn = vals[lo + base + 32 + lane];
        cn = jk[lo + base + 32 + lane];
      }
      // the group's nonzeros of this step that start a fiber: bit t
      int before = __shfl_up_sync(kFull, c2.x, 1, Q);
      if (q == 0) before = cur;
      const unsigned starts =
          (__ballot_sync(kFull, base + lane < n && c2.x != before) >> (grp * Q)) &
          ((1u << Q) - 1u);
      // this lane's 16 bytes of their F_fib rows, all loads in flight before
      // the walk needs the first
      T f[Q][W];
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        const T* row = f_fib + (long long)__shfl_sync(kFull, c2.x, t, Q) * R + r;
        if (whole && (starts >> t & 1u)) {
          Row16<T>::ldg(row, f[t]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w)
            f[t][w] = (starts >> t & 1u) && r + w < R ? __ldg(row + w) : T(0);
        }
      }
      cur = __shfl_sync(kFull, c2.x, max(1, min(Q, n - base - grp * Q)) - 1, Q);
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        const T vt = __shfl_sync(kFull, v, t, Q);
        const int kt = __shfl_sync(kFull, c2.y, t, Q);
        if (base + grp * Q + t < n) {
          if (starts >> t & 1u) {   // close the last fiber, open this one
#pragma unroll
            for (int w = 0; w < W; ++w) {
              acc[w] += seg[w] * fcur[w];
              seg[w] = T(0);
              fcur[w] = f[t][w];
            }
          }
          T x[W];
          Row16<T>::load(tile + kt * P + q * W, x);
#pragma unroll
          for (int w = 0; w < W; ++w) seg[w] += vt * x[w];
        }
      }
      v = vn;
      c2 = cn;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      acc[w] += seg[w] * fcur[w];
#pragma unroll
      for (int off = Q; off < 32; off <<= 1) acc[w] += __shfl_xor_sync(kFull, acc[w], off);
      if (grp == 0 && r + w < R) partial[chunk * R + r + w] = acc[w];
    }
  }
}

template <typename T>
cudaError_t launch_row_sums(const T* partial, const long long* chunk_ptr, T* out,
                            int D, int R, cudaStream_t stream) {
  const long long n = (long long)D * R;
  if (n > 0) {
    long long blocks = (n + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    row_sums<T><<<(unsigned)blocks, 256, 0, stream>>>(partial, chunk_ptr, out, n, R);
  }
  return cudaGetLastError();
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
  return launch_row_sums<T>(partial, chunk_ptr, out, D, R, stream);
}

template <typename T, int P>
cudaError_t launch_fiber(const int* coords, const T* vals, const long long* chunk_start,
                         const long long* chunk_ptr, const T* f_fib, const T* f_res,
                         int d_res, T* partial, T* out, long long nchunks, int D,
                         int R, int blocks, cudaStream_t stream) {
  if (nchunks > 0) {
    const int smem = d_res * P * (int)sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(
        fiber_partials<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const bool rows16 = reinterpret_cast<unsigned long long>(f_fib) % 16 == 0 &&
                        R % Row16<T>::W == 0;
    const dim3 grid((unsigned)blocks, (R + P - 1) / P);
    fiber_partials<T, P><<<grid, kFiberWarps * 32, smem, stream>>>(
        coords, vals, chunk_start, f_fib, f_res, d_res, rows16, partial, nchunks, R);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_row_sums<T>(partial, chunk_ptr, out, D, R, stream);
}

template <typename T>
cudaError_t fiber_dispatch(int lanes, const void* coords, const void* vals,
                           const void* chunk_start, const void* chunk_ptr,
                           const void* f_fib, const void* f_res, int d_res,
                           void* partial, void* out, long long nchunks, int D,
                           int R, int blocks, cudaStream_t stream) {
  const int* c = static_cast<const int*>(coords);
  const T* v = static_cast<const T*>(vals);
  const long long* cs = static_cast<const long long*>(chunk_start);
  const long long* cp = static_cast<const long long*>(chunk_ptr);
  const T* fj = static_cast<const T*>(f_fib);
  const T* fk = static_cast<const T*>(f_res);
  T* p = static_cast<T*>(partial);
  T* o = static_cast<T*>(out);
  switch (lanes) {
    case 8: return launch_fiber<T, 8>(c, v, cs, cp, fj, fk, d_res, p, o, nchunks, D, R, blocks, stream);
    case 16: return launch_fiber<T, 16>(c, v, cs, cp, fj, fk, d_res, p, o, nchunks, D, R, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
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

// C entry for ctypes, the fiber kernel of a 3-way tensor.  coords (nnz, 2)
// int32 holds (fiber j, resident k) a nonzero; vals, chunk_start and
// chunk_ptr as above.  f_fib and f_res are the fiber and resident factors,
// (rows, R) row-major, f_res with d_res rows; lanes is P (8 or 16) and
// d_res * P values must fit the block's shared memory.  blocks is the
// persistent grid (one block an SM).  Returns the first CUDA error.
extern "C" int mttkrp_sparse_fiber_run(int is_double, int lanes, const void* coords,
                                       const void* vals, const void* chunk_start,
                                       const void* chunk_ptr, const void* f_fib,
                                       const void* f_res, void* partial, void* out,
                                       long long nchunks, int D, int R, int d_res,
                                       int blocks, void* stream) {
  if (R < 1 || D < 0 || nchunks < 0 || d_res < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_double
      ? fiber_dispatch<double>(lanes, coords, vals, chunk_start, chunk_ptr, f_fib, f_res, d_res, partial, out, nchunks, D, R, blocks, st)
      : fiber_dispatch<float>(lanes, coords, vals, chunk_start, chunk_ptr, f_fib, f_res, d_res, partial, out, nchunks, D, R, blocks, st);
  return (int)err;
}
