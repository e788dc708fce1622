// Sequential per-column proxes of a factor matrix, for Hopper (sm_90a).
//
// Two kernels, bound by matlab_code_tpu_torch/ops/prox_cuda.py (plain C
// entries, ctypes):
//
//   project_isotonic_cols (kernel A): isotonic regression of each column,
//     non-decreasing or non-increasing, and unimodal regression with or
//     without non-negativity.  Replaces the lax loops of
//     matlab_code_tpu/ops/isotonic.py:23-147 (_prefix_isotonic,
//     _reconstruct, isotonic_vector, unimodal_vector under vmap).
//   prox_tv_cols (kernel B): the exact 1-D total-variation prox of each
//     column, Condat's direct algorithm.  Replaces the lax loop of
//     matlab_code_tpu/ops/tv.py:23-126.
//
// The factor is an (n, R) row-major matrix (a column has stride R), float
// or double; the kernels write a new matrix of the same type.  Both compute
// in double whatever the storage type, in the order of operations of the
// plain versions (ops/isotonic.py, ops/tv.py) and of the JAX module, so a
// float64 result agrees with them to rounding and a float32 result is the
// float64 result rounded once.  Products that feed a sum are written with
// __dmul_rn so that nvcc does not contract them into a fused multiply-add
// the plain versions do not have.
//
// What bounds them: each column is a chain of dependent steps (a slot of
// the scan and each merge, or a state of Condat's machine), one thread a
// column, so a call takes at least the longest column's steps at one step a
// clock; the bytes (the matrix read once and written once) are far below
// that.  The design is the simple one: one thread walks a column's
// recurrence, a second thread the flipped scan of a unimodal column, the
// scan's per-slot state in a workspace in device memory that the wrapper
// allocates; each thread first prefetches its column into L1, so the
// walk's loads of y do not wait on device memory one at a time.  A merge
// reloads workspace slots the same thread has just stored, one load
// waiting on the next, and no run has shown where those loads are served
// from.  No atomics; the same inputs give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 32;   // columns a block (one warp a scan side)

template <typename T>
__device__ __forceinline__ double ld(const T* p) { return static_cast<double>(*p); }

// Ask for rows 0..n-1 of a column (stride R) to be brought into L1 ahead of
// the walk: n prefetches in flight at once instead of one miss a step of
// the dependent chain.
template <typename T>
__device__ __forceinline__ void prefetch_column(const T* y, long R, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(y + static_cast<long>(i) * R));
}

// One prefix-isotonic scan's state, slot i (0..n) of this column at
// [i * stride]: the summed y and y^2 of slot i's level set, its level
// (mean), the fit's total squared error, and the set's leftmost slot.
struct Scan {
  double* sumwy;
  double* sumwy2;
  double* level;
  double* err;
  int* idxr;
  long stride;
};

// Prefix isotonic regression of column y (n values, stride R), read
// forwards or flipped and multiplied by sign (project_unimodal_vector.m
// :43-88; matlab_code_tpu/ops/isotonic.py::_prefix_isotonic).  Slot 0 is a
// sentinel at level -inf.  Levels that are negative are set to 0 at the
// end where nonneg (their error is the sum of squares before the slot).
template <typename T>
__device__ void prefix_isotonic(const T* y, long R, int n, bool flip,
                                double sign, bool nonneg, const Scan& w) {
  const long s = w.stride;
  w.sumwy[0] = 0.0;
  w.sumwy2[0] = 0.0;
  w.level[0] = -INFINITY;
  w.err[0] = 0.0;
  w.idxr[0] = 0;
  double cum = 0.0;        // sum of y^2 over the slots before i
  double top = -INFINITY;  // level of slot i - 1
  double top_err = 0.0;    // err of slot i - 1
  for (int i = 1; i <= n; ++i) {
    const double yi = sign * ld(y + static_cast<long>(flip ? n - i : i - 1) * R);
    double swy = yi;
    double swy2 = __dmul_rn(yi, yi);
    double sw = 1.0;
    double lev = yi;
    int left = i;
    double prev = top;
    while (lev <= prev) {
      const int mg = left - 1;
      swy += w.sumwy[mg * s];
      swy2 += w.sumwy2[mg * s];
      sw += static_cast<double>(mg - w.idxr[mg * s] + 1);
      lev = swy / sw;
      left = w.idxr[mg * s];
      prev = w.level[(left - 1) * s];
    }
    w.sumwy[i * s] = swy;
    w.sumwy2[i * s] = swy2;
    w.level[i * s] = lev;
    w.idxr[i * s] = left;
    const double levelerror = swy2 - __dmul_rn(swy, swy) / sw;
    const double below = left == i ? top_err : w.err[(left - 1) * s];
    top_err = (nonneg && lev < 0.0) ? cum : levelerror + below;
    w.err[i * s] = top_err;
    cum += __dmul_rn(yi, yi);
    top = lev;
  }
  if (nonneg)
    for (int i = 1; i <= n; ++i)
      if (w.level[i * s] < 0.0) w.level[i * s] = 0.0;
}

// Write the fit of the prefix of length mode_idx by walking the level-set
// pointers (project_unimodal_vector.m:34-41), times sign, into out (stride
// R), at slot j's row j - 1, or n - j where the scan ran flipped.
template <typename T>
__device__ void reconstruct(T* out, long R, int n, int mode_idx, bool flip,
                            double sign, const Scan& w) {
  const long s = w.stride;
  int idx = mode_idx;
  while (idx >= 1) {
    const int left = w.idxr[idx * s];
    const T v = static_cast<T>(sign * w.level[idx * s]);
    for (int j = left; j <= idx; ++j)
      out[static_cast<long>(flip ? n - j : j - 1) * R] = v;
    idx = left - 1;
  }
}

// kind 0 non-decreasing, 1 non-increasing (negated in and out), 2 unimodal.
// A block holds kCols columns; unimodal blocks have a second warp for the
// flipped scan.  ws_d: 4 * sides * (n + 1) * R doubles, ws_i: sides * (n +
// 1) * R ints, slot i of column c at i * R + c.
template <typename T>
__global__ void __launch_bounds__(2 * kCols)
project_isotonic_cols(const T* __restrict__ Y, T* __restrict__ X, int n, int R,
                      int kind, int nonneg, double* ws_d, int* ws_i) {
  const int side = threadIdx.x / kCols;
  const int c = blockIdx.x * kCols + threadIdx.x % kCols;
  const bool active = c < R;
  const int sides = kind == 2 ? 2 : 1;
  const long plane = static_cast<long>(n + 1) * R;
  Scan w;
  w.stride = R;
  w.sumwy = ws_d + (0 * sides + side) * plane + c;
  w.sumwy2 = ws_d + (1 * sides + side) * plane + c;
  w.level = ws_d + (2 * sides + side) * plane + c;
  w.err = ws_d + (3 * sides + side) * plane + c;
  w.idxr = ws_i + side * plane + c;
  const T* y = Y + c;
  T* x = X + c;
  if (active && side == 0) prefetch_column(y, R, n);
  if (kind != 2) {
    if (!active) return;
    const double sign = kind == 1 ? -1.0 : 1.0;
    prefix_isotonic(y, R, n, false, sign, false, w);
    reconstruct(x, R, n, n, false, sign, w);
    return;
  }
  if (active) prefix_isotonic(y, R, n, side == 1, 1.0, nonneg != 0, w);
  __syncthreads();
  if (!active) return;
  // the peak: the first minimum (or the first NaN, as jnp.argmin) of
  // err_left(i) + err_right(n - i + 1), i = 1..n; both sides find it
  const double* errL = ws_d + (3 * sides + 0) * plane + c;
  const double* errR = ws_d + (3 * sides + 1) * plane + c;
  int best = 1;
  double be = errL[1L * R] + errR[static_cast<long>(n) * R];
  if (!isnan(be)) {
    for (int i = 2; i <= n; ++i) {
      const double e = errL[static_cast<long>(i) * R] + errR[static_cast<long>(n - i + 1) * R];
      if (isnan(e)) { best = i; break; }
      if (e < be) { be = e; best = i; }
    }
  }
  if (side == 0)
    reconstruct(x, R, n, best, false, 1.0, w);       // rows 0 .. best - 1
  else
    reconstruct(x, R, n, n - best, true, 1.0, w);    // rows best .. n - 1
}

// Condat's direct algorithm on each column (matlab_code_tpu/ops/tv.py
// :23-126, the same states: 1-based k, `fresh` after a jump).  lam is read
// from the device (eta / rho, never copied to the host); lam <= 0, a NaN
// lam and n == 1 copy the column.
template <typename T>
__global__ void __launch_bounds__(kCols)
prox_tv_cols(const T* __restrict__ Y, T* __restrict__ X, int n, int R,
             const double* __restrict__ lam_p) {
  const int c = blockIdx.x * kCols + threadIdx.x;
  if (c >= R) return;
  const double lam = *lam_p;
  const T* y = Y + c;
  T* x = X + c;
  auto yk = [&](int k) { return ld(y + static_cast<long>(k - 1) * R); };
  auto seg = [&](int lo, int hi, double v) {
    const T t = static_cast<T>(v);
    for (int i = lo; i <= hi; ++i) x[static_cast<long>(i - 1) * R] = t;
  };
  if (n == 1 || !(lam > 0.0)) {
    for (int i = 0; i < n; ++i) x[static_cast<long>(i) * R] = y[static_cast<long>(i) * R];
    return;
  }
  prefetch_column(y, R, n);
  int k = 1, k0 = 1, km = 1, kp = 1;
  double vmin = yk(1) - lam, vmax = yk(1) + lam, umin = lam, umax = -lam;
  bool fresh = true;
  for (;;) {
    if (k == n) {
      if (fresh) {
        x[static_cast<long>(n - 1) * R] = static_cast<T>(vmin + umin);
        return;
      }
      if (umin < 0.0) {
        seg(k0, km, vmin);
        k = k0 = km = km + 1;
        vmin = yk(k);
        umin = lam;
        umax = yk(k) + lam - vmax;
      } else if (umax > 0.0) {
        seg(k0, kp, vmax);
        k = k0 = kp = kp + 1;
        vmax = yk(k);
        umax = -lam;
        umin = yk(k) - lam - vmin;
      } else {
        seg(k0, k, vmin + umin / static_cast<double>(k - k0 + 1));
        return;
      }
      fresh = true;
      continue;
    }
    const double ynext = yk(k + 1);
    if (ynext + umin < vmin - lam) {           // negative jump
      seg(k0, km, vmin);
      k = k0 = km = kp = km + 1;
      vmin = yk(k);
      vmax = yk(k) + 2.0 * lam;
      umin = lam;
      umax = -lam;
      fresh = true;
    } else if (ynext + umax > vmax + lam) {    // positive jump
      seg(k0, kp, vmax);
      k = k0 = km = kp = kp + 1;
      vmin = yk(k) - 2.0 * lam;
      vmax = yk(k);
      umin = lam;
      umax = -lam;
      fresh = true;
    } else {                                   // extend the segment
      k += 1;
      umin = umin + yk(k) - vmin;
      umax = umax + yk(k) - vmax;
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

int blocks_for(int R) { return (R + kCols - 1) / kCols; }

}  // namespace

// C entry for ctypes, kernel A.  is_double selects float64 (else float32);
// kind 0/1/2 as above; ws_d and ws_i as above (sides = 2 for kind 2).
// Returns the launch's CUDA error.
extern "C" int project_isotonic_cols_run(int is_double, int kind, int nonneg,
                                         const void* Y, void* X, int n, int R,
                                         void* ws_d, void* ws_i, void* stream) {
  if (n < 1 || R < 1 || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(R)), block(kind == 2 ? 2 * kCols : kCols);
  if (is_double)
    project_isotonic_cols<double><<<grid, block, 0, st>>>(
        static_cast<const double*>(Y), static_cast<double*>(X), n, R, kind, nonneg,
        static_cast<double*>(ws_d), static_cast<int*>(ws_i));
  else
    project_isotonic_cols<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(Y), static_cast<float*>(X), n, R, kind, nonneg,
        static_cast<double*>(ws_d), static_cast<int*>(ws_i));
  return (int)cudaGetLastError();
}

// C entry for ctypes, kernel B.  lam: a float64 scalar on the device.
extern "C" int prox_tv_cols_run(int is_double, const void* Y, void* X, int n,
                                int R, const void* lam, void* stream) {
  if (n < 1 || R < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double)
    prox_tv_cols<double><<<blocks_for(R), kCols, 0, st>>>(
        static_cast<const double*>(Y), static_cast<double*>(X), n, R,
        static_cast<const double*>(lam));
  else
    prox_tv_cols<float><<<blocks_for(R), kCols, 0, st>>>(
        static_cast<const float*>(Y), static_cast<float*>(X), n, R,
        static_cast<const double*>(lam));
  return (int)cudaGetLastError();
}
