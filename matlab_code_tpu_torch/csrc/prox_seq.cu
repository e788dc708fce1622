// Sequential per-column proxes of a factor matrix, for Hopper (sm_90a).
//
// Two kernels, bound by matlab_code_tpu_torch/ops/prox_cuda.py (plain C
// entries, ctypes):
//
//   kernel A: isotonic regression of each column, non-decreasing or
//     non-increasing, and unimodal regression with or without
//     non-negativity.  Replaces the lax loops of
//     matlab_code_tpu/ops/isotonic.py:23-147 (_prefix_isotonic,
//     _reconstruct, isotonic_vector, unimodal_vector under vmap).
//   kernel B: the exact 1-D total-variation prox of each column, Condat's
//     direct algorithm.  Replaces the lax loop of
//     matlab_code_tpu/ops/tv.py:23-126.
//
// The factor is an (n, R) row-major matrix (a column has stride R), or a
// stack of K such slices (K, n, R), slice after slice (the PARAFAC2 Bk
// mode: K R columns, a slice n R elements apart), float or double; the
// kernels write a new stack of the same type.  Kernel B takes one lam a
// slice.  Both compute
// in double whatever the storage type, in the order of operations of the
// plain versions (ops/isotonic.py, ops/tv.py) and of the JAX module, so a
// float64 result agrees with them to rounding and a float32 result is the
// float64 result rounded once.  Products that feed a sum are written with
// __dmul_rn so that nvcc does not contract them into a fused multiply-add
// the plain versions do not have.
//
// What bounds them: each column is a chain of dependent steps (a slot of
// the scan and each merge, or a state of Condat's machine), so a call takes
// at least a column's n steps at one step a clock; the bytes (the matrix
// read once and written once) are far below that.  So the design shortens
// each step of the chain, and does everything that is not the chain with
// all the threads of a block.  One block of kThreads threads takes a scan
// side of a column: the threads stage the column as doubles, one thread
// walks the recurrence, and the threads then write the output in parallel.
// Kernel A keeps sumwy, sumwy2, level, err (double) and idxr (int32) for
// slots 0..n, 36 bytes a slot, the column staged in the sumwy slots (the
// walk reads slot i's y just before it overwrites it).  A unimodal column
// is a 2-block thread-block cluster, the forward scan in rank 0 and the
// flipped scan in rank 1; after the scans each block reads its partner's
// err and reduces err_L(i) + err_R(n - i + 1) over i with all its threads
// to the same peak (the first NaN, else the first minimum: jnp.argmin's
// rule); each block then writes its half of the fit.  Kernel B stages y as
// doubles and the output column in the storage type, 8 + sizeof(T) bytes a
// row.
//
// Where a block keeps that state is the only difference between the two
// routes, which the wrapper chooses from n and the dtype before the launch
// (prox_cuda.plan_isotonic, plan_tv): the shared route (InShared) carves it
// from dynamic shared memory (~30 clocks a load), as far as the 227 KB a
// block may hold; the global route, for longer columns, from the block's
// own slice of a workspace in device memory that the wrapper allocates.
// Both instantiate the same kernel bodies, so they give the same bits.  No
// atomics; the same inputs give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads a block (a scan side of a column)

template <typename T>
__device__ __forceinline__ double ld(const T* p) { return static_cast<double>(*p); }

// The bytes of a block's state: kernel A's scan side, kernel B's column.
constexpr long isotonic_state_bytes(int n) { return 36L * (n + 1); }
constexpr long tv_state_bytes(int n, int itemsize) {
  return static_cast<long>(8 + itemsize) * n;
}

// Where column c of a (K, n, R) stack starts: slice c / R, column c % R.
__device__ __forceinline__ long col_offset(long c, int n, int R) {
  return (c / R) * static_cast<long>(n) * R + c % R;
}

// Block `block`'s state: dynamic shared memory on the shared route, its
// `stride`-byte slice of the workspace on the global route.
template <bool InShared>
__device__ __forceinline__ unsigned char* block_state(unsigned char* smem,
                                                      unsigned char* ws,
                                                      long stride, long block) {
  return InShared ? smem : ws + block * stride;
}

// Kernel A's scan state, slots 0..n: the summed y and y^2 of slot i's level
// set, its level (mean), the fit's total squared error, and the set's
// leftmost slot.
struct Scan {
  double* sumwy;
  double* sumwy2;
  double* level;
  double* err;
  int* idxr;
};

__device__ __forceinline__ Scan carve(unsigned char* base, int n) {
  Scan w;
  double* d = reinterpret_cast<double*>(base);
  w.sumwy = d;
  w.sumwy2 = d + (n + 1);
  w.level = d + 2 * (n + 1);
  w.err = d + 3 * (n + 1);
  w.idxr = reinterpret_cast<int*>(d + 4 * (n + 1));
  return w;
}

// Slot i (1..n) of `slots` = sign * y at row i - 1, or n - i where the scan
// runs flipped: the column in the walk's order, loaded by every thread.
template <typename T>
__device__ __forceinline__ void stage_scan(const T* y, long R, int n, bool flip,
                                           double sign, double* slots) {
  for (int i = threadIdx.x + 1; i <= n; i += blockDim.x)
    slots[i] = sign * ld(y + static_cast<long>(flip ? n - i : i - 1) * R);
}

// Prefix isotonic regression of the staged column (project_unimodal_vector.m
// :43-88; matlab_code_tpu/ops/isotonic.py::_prefix_isotonic), by one
// thread.  Slot 0 is a sentinel whose level is NaN: `lev <= NaN` is false,
// so no merge reaches past slot 0 (the plain walk stops there too) and a
// column holding -inf ends.  The levels are left unclamped: where nonneg, a
// negative level's error is the sum of squares before the slot, and
// fill_fit writes it as 0.
__device__ __forceinline__ void scan_walk(int n, bool nonneg, const Scan& w) {
  double* __restrict__ sumwy = w.sumwy;
  double* __restrict__ sumwy2 = w.sumwy2;
  double* __restrict__ level = w.level;
  double* __restrict__ err = w.err;
  int* __restrict__ idxr = w.idxr;
  sumwy[0] = 0.0;
  sumwy2[0] = 0.0;
  level[0] = NAN;
  err[0] = 0.0;
  idxr[0] = 0;
  double cum = 0.0;        // sum of y^2 over the slots before i
  double top = NAN;        // level of slot i - 1
  double top_err = 0.0;    // err of slot i - 1
  for (int i = 1; i <= n; ++i) {
    const double yi = sumwy[i];   // the staged y, overwritten below
    double swy = yi;
    double swy2 = __dmul_rn(yi, yi);
    double sw = 1.0;
    double lev = yi;
    int left = i;
    double prev = top;
    while (lev <= prev) {
      const int mg = left - 1;
      const int mg_left = idxr[mg];
      swy += sumwy[mg];
      swy2 += sumwy2[mg];
      sw += static_cast<double>(mg - mg_left + 1);
      lev = swy / sw;
      left = mg_left;
      prev = level[left - 1];
    }
    sumwy[i] = swy;
    sumwy2[i] = swy2;
    level[i] = lev;
    idxr[i] = left;
    const double levelerror = swy2 - __dmul_rn(swy, swy) / sw;
    const double below = left == i ? top_err : err[left - 1];
    top_err = (nonneg && lev < 0.0) ? cum : levelerror + below;
    err[i] = top_err;
    cum += __dmul_rn(yi, yi);
    top = lev;
  }
}

// Write the fit of the prefix of length m (project_unimodal_vector.m
// :34-41), times sign, into out (stride R), slot j at row j - 1, or n - j
// where the scan ran flipped.  One thread walks the level-set pointers from
// m, a step a set, and lists the sets' right ends (descending) in `ends`;
// then every thread takes rows and finds its row's set by a binary search.
// Reads level and idxr; `ends` may alias sumwy (no longer read).
template <typename T>
__device__ __forceinline__ void fill_fit(T* out, long R, int n, int m, bool flip,
                                         double sign, bool nonneg, const Scan& w,
                                         int* ends, int* n_sets) {
  if (threadIdx.x == 0) {
    int k = 0;
    for (int idx = m; idx >= 1; idx = w.idxr[idx] - 1) ends[k++] = idx;
    *n_sets = k;
  }
  __syncthreads();
  const int sets = *n_sets;
  for (int j = threadIdx.x + 1; j <= m; j += blockDim.x) {
    int lo = 0, hi = sets - 1;   // the last set whose right end is >= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ends[mid] >= j) lo = mid; else hi = mid - 1;
    }
    double v = w.level[ends[lo]];
    if (nonneg && v < 0.0) v = 0.0;
    out[static_cast<long>(flip ? n - j : j - 1) * R] = static_cast<T>(sign * v);
  }
}

// Kernel A, kinds 0 and 1: one block a column.
template <typename T, bool InShared>
__global__ void __launch_bounds__(kThreads)
isotonic_cols(const T* __restrict__ Y, T* __restrict__ X, int n, int R,
              double sign, unsigned char* ws, long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_sets;
  const Scan w = carve(block_state<InShared>(smem, ws, stride, blockIdx.x), n);
  const long c = col_offset(blockIdx.x, n, R);
  stage_scan(Y + c, R, n, false, sign, w.sumwy);
  __syncthreads();
  if (threadIdx.x == 0) scan_walk(n, false, w);
  __syncthreads();
  fill_fit(X + c, R, n, n, false, sign, false, w,
           reinterpret_cast<int*>(w.sumwy), &n_sets);
}

// A candidate peak: the entry's value, whether it is NaN, and its index.
// Order: a NaN before any number, then the smaller value, then the smaller
// index, so the least candidate of all is jnp.argmin's (the first NaN, else
// the first minimum) whatever the order of the reduction.  The start value
// (a number, +inf, INT_MAX) loses to every entry.
struct Peak {
  double v;
  int nan;
  int i;
};

__device__ __forceinline__ bool before(const Peak& a, const Peak& b) {
  if (a.nan != b.nan) return a.nan > b.nan;
  if (!a.nan && a.v != b.v) return a.v < b.v;
  return a.i < b.i;
}

// Kernel A, kind 2: a column is a cluster of two blocks, the forward scan
// in rank 0 (rows 0 .. best - 1 of the fit) and the flipped scan in rank 1
// (rows best .. n - 1).  Each reads its partner's err through distributed
// shared memory on the shared route, in the partner's workspace slice on
// the global route; cluster.sync() orders both (its arrive releases and its
// wait acquires at cluster scope, global memory included).
template <typename T, bool InShared>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
unimodal_cluster(const T* __restrict__ Y, T* __restrict__ X, int n, int R,
                 int nonneg, unsigned char* ws, long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Peak warp_peak[kThreads / 32];
  __shared__ int best_s, n_sets;
  cg::cluster_group cluster = cg::this_cluster();
  const int side = static_cast<int>(cluster.block_rank());
  const long c = col_offset(blockIdx.x / 2, n, R);
  const Scan w = carve(block_state<InShared>(smem, ws, stride, blockIdx.x), n);
  stage_scan(Y + c, R, n, side == 1, 1.0, w.sumwy);
  __syncthreads();
  if (threadIdx.x == 0) scan_walk(n, nonneg != 0, w);
  // both scans' err complete, and visible to the partner block
  cluster.sync();
  const double* other =
      InShared ? cluster.map_shared_rank(w.err, side ^ 1)
               : carve(block_state<InShared>(smem, ws, stride, blockIdx.x ^ 1), n).err;
  const double* errL = side == 0 ? w.err : other;
  const double* errR = side == 1 ? w.err : other;
  Peak p{INFINITY, 0, INT_MAX};
  for (int i = threadIdx.x + 1; i <= n; i += blockDim.x) {
    const double e = errL[i] + errR[n - i + 1];
    const Peak q{e, isnan(e) ? 1 : 0, i};
    if (before(q, p)) p = q;
  }
  // the partner's state is read no more: either block may go on to
  // overwrite its own and exit
  cluster.sync();
  for (int off = 16; off >= 1; off >>= 1) {
    const Peak q{__shfl_down_sync(0xffffffffu, p.v, off),
                 __shfl_down_sync(0xffffffffu, p.nan, off),
                 __shfl_down_sync(0xffffffffu, p.i, off)};
    if (before(q, p)) p = q;
  }
  if ((threadIdx.x & 31) == 0) warp_peak[threadIdx.x >> 5] = p;
  __syncthreads();
  if (threadIdx.x == 0) {
    Peak b = warp_peak[0];
    for (int k = 1; k < kThreads / 32; ++k)
      if (before(warp_peak[k], b)) b = warp_peak[k];
    best_s = b.i;
  }
  __syncthreads();
  const int best = best_s;
  int* ends = reinterpret_cast<int*>(w.sumwy);
  if (side == 0)
    fill_fit(X + c, R, n, best, false, 1.0, nonneg != 0, w, ends, &n_sets);
  else
    fill_fit(X + c, R, n, n - best, true, 1.0, nonneg != 0, w, ends, &n_sets);
}

// Condat's direct algorithm on a staged column ys (matlab_code_tpu/ops/tv.py
// :23-126, the same states: 1-based k, `fresh` after a jump), by one
// thread, the output into xs.
template <typename T>
__device__ __forceinline__ void condat_walk(const double* __restrict__ ys,
                                            T* __restrict__ xs, int n,
                                            double lam) {
  auto seg = [&](int lo, int hi, double v) {
    const T t = static_cast<T>(v);
    for (int i = lo; i <= hi; ++i) xs[i - 1] = t;
  };
  int k = 1, k0 = 1, km = 1, kp = 1;
  double vmin = ys[0] - lam, vmax = ys[0] + lam, umin = lam, umax = -lam;
  bool fresh = true;
  for (;;) {
    if (k == n) {
      if (fresh) {
        xs[n - 1] = static_cast<T>(vmin + umin);
        return;
      }
      if (umin < 0.0) {
        seg(k0, km, vmin);
        k = k0 = km = km + 1;
        vmin = ys[k - 1];
        umin = lam;
        umax = ys[k - 1] + lam - vmax;
      } else if (umax > 0.0) {
        seg(k0, kp, vmax);
        k = k0 = kp = kp + 1;
        vmax = ys[k - 1];
        umax = -lam;
        umin = ys[k - 1] - lam - vmin;
      } else {
        seg(k0, k, vmin + umin / static_cast<double>(k - k0 + 1));
        return;
      }
      fresh = true;
      continue;
    }
    const double ynext = ys[k];
    if (ynext + umin < vmin - lam) {           // negative jump
      seg(k0, km, vmin);
      k = k0 = km = kp = km + 1;
      vmin = ys[k - 1];
      vmax = ys[k - 1] + 2.0 * lam;
      umin = lam;
      umax = -lam;
      fresh = true;
    } else if (ynext + umax > vmax + lam) {    // positive jump
      seg(k0, kp, vmax);
      k = k0 = km = kp = kp + 1;
      vmin = ys[k - 1] - 2.0 * lam;
      vmax = ys[k - 1];
      umin = lam;
      umax = -lam;
      fresh = true;
    } else {                                   // extend the segment
      k += 1;
      umin = umin + ynext - vmin;
      umax = umax + ynext - vmax;
      const double denom = static_cast<double>(k - k0 + 1);
      if (umin >= lam) {
        vmin = vmin + (umin - lam) / denom;
        km = k;
        umin = lam;
      }
      if (umax <= -lam) {
        vmax = vmax + (umax + lam) / denom;
        kp = k;
        umax = -lam;
      }
      fresh = false;
    }
  }
}

// Kernel B: one block a column; its slice's lam read from the device
// (eta / rho_k, never copied to the host); lam <= 0, a NaN lam and n == 1
// copy the column.
template <typename T, bool InShared>
__global__ void __launch_bounds__(kThreads)
tv_cols(const T* __restrict__ Y, T* __restrict__ X, int n, int R,
        const double* __restrict__ lam_p, unsigned char* ws, long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ys = reinterpret_cast<double*>(
      block_state<InShared>(smem, ws, stride, blockIdx.x));
  T* xs = reinterpret_cast<T*>(ys + n);
  const long c = col_offset(blockIdx.x, n, R);
  const double lam = lam_p[blockIdx.x / R];
  const T* y = Y + c;
  T* x = X + c;
  if (n == 1 || !(lam > 0.0)) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      x[static_cast<long>(i) * R] = y[static_cast<long>(i) * R];
    return;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ys[i] = ld(y + static_cast<long>(i) * R);
  __syncthreads();
  if (threadIdx.x == 0) condat_walk(ys, xs, n, lam);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    x[static_cast<long>(i) * R] = xs[i];
}

// Let `kernel` take `bytes` of dynamic shared memory (above the default 48 KB
// only after this call).  A refusal is returned, and cleared from the
// runtime's last error so that no later launch reports it.
template <typename K>
cudaError_t allow_smem(K* kernel, long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

template <typename T, bool InShared>
int isotonic_launch(int kind, int nonneg, const void* Y, void* X, int K, int n,
                    int R, long smem, unsigned char* ws, long stride,
                    cudaStream_t st) {
  const T* y = static_cast<const T*>(Y);
  T* x = static_cast<T*>(X);
  const long cols = static_cast<long>(K) * R;
  cudaError_t e;
  if (kind == 2) {
    auto* k = unimodal_cluster<T, InShared>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<2 * cols, kThreads, smem, st>>>(y, x, n, R, nonneg, ws, stride);
  } else {
    auto* k = isotonic_cols<T, InShared>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<cols, kThreads, smem, st>>>(y, x, n, R, kind == 1 ? -1.0 : 1.0, ws,
                                    stride);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool InShared>
int tv_launch(const void* Y, void* X, int K, int n, int R, const double* lam,
              long smem, unsigned char* ws, long stride, cudaStream_t st) {
  cudaError_t e;
  auto* k = tv_cols<T, InShared>;
  if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
  k<<<static_cast<long>(K) * R, kThreads, smem, st>>>(
      static_cast<const T*>(Y), static_cast<T*>(X), n, R, lam, ws, stride);
  return (int)cudaGetLastError();
}

// Whether a launch's state fits where it is asked to go: `smem` bytes of
// shared memory a block (ws null), or a workspace of `stride` bytes a block
// (a multiple of 16, so the doubles of every slice stay aligned).
bool state_fits(long bytes, long smem, const void* ws, long stride) {
  return ws == nullptr ? smem >= bytes : (stride >= bytes && stride % 16 == 0);
}

}  // namespace

// C entries for ctypes.  is_double selects float64 (else float32); Y and X
// are (K, n, R) stacks (K = 1 for a matrix).  ws null takes the shared
// route with `smem` bytes of dynamic shared memory a block
// (prox_cuda.plan_isotonic, plan_tv); else the global route, block b's state
// at ws + b * stride (K R blocks, 2 K R for a unimodal kernel A).  Each
// returns the launch's CUDA error.

// Kernel A: kind 0 non-decreasing, 1 non-increasing, 2 unimodal.  A block's
// state is 36 * (n + 1) bytes.
extern "C" int isotonic_run(int is_double, int kind, int nonneg, const void* Y,
                            void* X, int K, int n, int R, long smem, void* ws,
                            long stride, void* stream) {
  if (K < 1 || n < 1 || R < 1 || kind < 0 || kind > 2 ||
      !state_fits(isotonic_state_bytes(n), smem, ws, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (w == nullptr)
    return is_double
        ? isotonic_launch<double, true>(kind, nonneg, Y, X, K, n, R, smem, w, 0, st)
        : isotonic_launch<float, true>(kind, nonneg, Y, X, K, n, R, smem, w, 0, st);
  return is_double
      ? isotonic_launch<double, false>(kind, nonneg, Y, X, K, n, R, 0, w, stride, st)
      : isotonic_launch<float, false>(kind, nonneg, Y, X, K, n, R, 0, w, stride, st);
}

// Kernel B.  lam: K float64 values on the device, one a slice.  A block's
// state is (8 + itemsize) * n bytes.
extern "C" int tv_run(int is_double, const void* Y, void* X, int K, int n, int R,
                      const void* lam, long smem, void* ws, long stride,
                      void* stream) {
  if (K < 1 || n < 1 || R < 1 ||
      !state_fits(tv_state_bytes(n, is_double ? 8 : 4), smem, ws, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double* l = static_cast<const double*>(lam);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (w == nullptr)
    return is_double ? tv_launch<double, true>(Y, X, K, n, R, l, smem, w, 0, st)
                     : tv_launch<float, true>(Y, X, K, n, R, l, smem, w, 0, st);
  return is_double ? tv_launch<double, false>(Y, X, K, n, R, l, 0, w, stride, st)
                   : tv_launch<float, false>(Y, X, K, n, R, l, 0, w, stride, st);
}
