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
// block routes, which the wrapper chooses from n and the dtype before the
// launch (prox_cuda.plan_isotonic, plan_tv): the shared route (InShared)
// carves it from dynamic shared memory (~30 clocks a load), as far as the
// 227 KB a block may hold; the global route, for longer columns, from the
// block's own slice of a workspace in device memory that the wrapper
// allocates.  Both instantiate the same kernel bodies, so they give the
// same bits.
//
// A block a column leaves the card idle where there are many short
// columns (the PARAFAC2 Bk mode, 16,384 columns of 256 rows): ~8 blocks an
// SM, each with one thread walking, run them in tens of waves.  The third
// route, "lanes" (for K R >= prox_cuda.LANES_MIN_COLS columns, and every
// ragged stack), gives each thread a walk: a warp takes 32 adjacent
// columns, so every column of the stack walks at once, at the cost of a
// walk's steps taken by the warp's slowest lane and a fill and peak search
// by one thread a column.  Its state is described at isotonic_lanes.  No
// atomics; the same inputs give the same bits on every route.

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
// leftmost slot.  The lanes route keeps, in place of the level, blev and
// berr: the level and err of the slot just before the set (see scan_step).
struct Scan {
  double* sumwy;
  double* sumwy2;
  double* level;
  double* err;
  int* idxr;
  double* blev;
  double* berr;
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

// Prefix isotonic regression (project_unimodal_vector.m:43-88;
// matlab_code_tpu/ops/isotonic.py::_prefix_isotonic), one walker a scan.
// Slot 0 is a sentinel whose level is NaN: `lev <= NaN` is false, so no
// merge reaches past slot 0 (the plain walk stops there too) and a column
// holding -inf ends.  The levels are left unclamped: where nonneg, a
// negative level's error is the sum of squares before the slot, and the
// fill writes it as 0.  Slot i of an array is at i * S: S = 1 for a
// block's own state, kLanes for a lane of a warp's interleaved state.
// Without Err (kinds 0 and 1, which never read them) sumwy2 and err are
// neither kept nor computed; the levels and sets are the same.
template <bool Err, bool Lanes>
__device__ __forceinline__ void scan_start(const Scan& w) {
  w.sumwy[0] = 0.0;
  w.idxr[0] = 0;
  if (Lanes)
    w.blev[0] = NAN;
  else
    w.level[0] = NAN;
  if (Err) {
    w.sumwy2[0] = 0.0;
    w.err[0] = 0.0;
    if (Lanes) w.berr[0] = 0.0;
  }
}

// What a walker carries from slot to slot: cum, the sum of y^2 over the
// slots before i; top and top_err, slot i - 1's level and err.  On the
// lanes route (Lanes) also slot i - 1's sumwy, sumwy2 and idxr and the
// level and err of the slot just before its set (below_lev, below_err), so
// a step that merges at most once reads nothing back from the state.
struct Carry {
  double cum = 0.0, top = NAN, top_err = 0.0;
  double top_swy = 0.0, top_swy2 = 0.0, below_lev = NAN, below_err = 0.0;
  int top_left = 0;
};

// Slot i's step, y_i = yi: merge the new set into the sets before it while
// its level is not above theirs.  The same operations on the same values
// in the same order on both routes.  On the lanes route the state is in
// device memory, written by the steps just before, so where the values
// come from is what a step costs: the first merge takes them from `c`, and
// every slot keeps the level and err just before its set (blev, berr, in
// place of its level), so a later merge reads one slot's values, all at
// once, where the block route reads idxr and then level[left - 1].
template <int S, bool Err, bool Lanes>
__device__ __forceinline__ void scan_step(int i, double yi, bool nonneg,
                                          const Scan& w, Carry& c) {
  double* __restrict__ sumwy = w.sumwy;
  double* __restrict__ sumwy2 = w.sumwy2;
  double* __restrict__ level = w.level;
  double* __restrict__ err = w.err;
  int* __restrict__ idxr = w.idxr;
  double swy = yi;
  double swy2 = Err ? __dmul_rn(yi, yi) : 0.0;
  double sw = 1.0;
  double lev = yi;
  int left = i;
  double prev = c.top;
  double below = c.top_err;    // err[left - 1]
  if (Lanes && lev <= prev) {  // the merge into slot i - 1's set
    swy += c.top_swy;
    if (Err) swy2 += c.top_swy2;
    sw += static_cast<double>(i - 1 - c.top_left + 1);
    lev = swy / sw;
    left = c.top_left;
    prev = c.below_lev;
    below = c.below_err;
  }
  const int reached = left;
  while (lev <= prev) {
    const int mg = left - 1;
    const int mg_left = idxr[mg * S];
    // on the lanes route the next comparison's operands are loaded with
    // the merge's, before the division (whose slow path is a call the
    // compiler does not move loads across)
    const double next_prev = Lanes ? w.blev[mg * S] : 0.0;
    const double next_below = Lanes && Err ? w.berr[mg * S] : 0.0;
    swy += sumwy[mg * S];
    if (Err) swy2 += sumwy2[mg * S];
    sw += static_cast<double>(mg - mg_left + 1);
    lev = swy / sw;
    left = mg_left;
    if (Lanes) {
      prev = next_prev;
      if (Err) below = next_below;
    } else {
      prev = level[(left - 1) * S];
    }
  }
  sumwy[i * S] = swy;
  idxr[i * S] = left;
  if (Lanes)
    w.blev[i * S] = prev;
  else
    level[i * S] = lev;
  if (Err) {
    sumwy2[i * S] = swy2;
    const double levelerror = swy2 - __dmul_rn(swy, swy) / sw;
    if (!Lanes && left != reached) below = err[(left - 1) * S];
    c.top_err = (nonneg && lev < 0.0) ? c.cum : levelerror + below;
    err[i * S] = c.top_err;
    if (Lanes) w.berr[i * S] = below;
    c.cum += __dmul_rn(yi, yi);
  }
  if (Lanes) {
    c.top_swy = swy;
    c.top_swy2 = swy2;
    c.top_left = left;
    c.below_lev = prev;
    c.below_err = below;
  }
  c.top = lev;
}

// The scan of a column staged in the sumwy slots, by one thread of the
// block (slot i's y is read just before the step overwrites it).
__device__ __forceinline__ void scan_walk(int n, bool nonneg, const Scan& w) {
  scan_start<true, false>(w);
  Carry c;
  for (int i = 1; i <= n; ++i)
    scan_step<1, true, false>(i, w.sumwy[i], nonneg, w, c);
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
// thread, the output into xs; row i of either at i * S.  Every read is of
// a row at or past the segment being built (k0), every write of a row
// before it, so xs may be ys itself: the lanes route walks in place.
template <int S, typename Ys, typename T>
__device__ __forceinline__ void condat_walk(const Ys* ys, T* xs, int n,
                                            double lam) {
  auto y = [&](int i) { return static_cast<double>(ys[i * S]); };
  auto seg = [&](int lo, int hi, double v) {
    const T t = static_cast<T>(v);
    for (int i = lo; i <= hi; ++i) xs[(i - 1) * S] = t;
  };
  int k = 1, k0 = 1, km = 1, kp = 1;
  double vmin = y(0) - lam, vmax = y(0) + lam, umin = lam, umax = -lam;
  bool fresh = true;
  for (;;) {
    if (k == n) {
      if (fresh) {
        xs[(n - 1) * S] = static_cast<T>(vmin + umin);
        return;
      }
      if (umin < 0.0) {
        seg(k0, km, vmin);
        k = k0 = km = km + 1;
        vmin = y(k - 1);
        umin = lam;
        umax = y(k - 1) + lam - vmax;
      } else if (umax > 0.0) {
        seg(k0, kp, vmax);
        k = k0 = kp = kp + 1;
        vmax = y(k - 1);
        umax = -lam;
        umin = y(k - 1) - lam - vmin;
      } else {
        seg(k0, k, vmin + umin / static_cast<double>(k - k0 + 1));
        return;
      }
      fresh = true;
      continue;
    }
    const double ynext = y(k);
    if (ynext + umin < vmin - lam) {           // negative jump
      seg(k0, km, vmin);
      k = k0 = km = kp = km + 1;
      vmin = y(k - 1);
      vmax = y(k - 1) + 2.0 * lam;
      umin = lam;
      umax = -lam;
      fresh = true;
    } else if (ynext + umax > vmax + lam) {    // positive jump
      seg(k0, kp, vmax);
      k = k0 = km = kp = kp + 1;
      vmin = y(k - 1) - 2.0 * lam;
      vmax = y(k - 1);
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
  if (threadIdx.x == 0) condat_walk<1>(ys, xs, n, lam);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    x[static_cast<long>(i) * R] = xs[i];
}

// ---------------------------------------------------------------------------
// The lanes route: stacks of many short columns (the PARAFAC2 Bk mode).
// A thread walks one scan side of one column, and a warp takes 32 adjacent
// flat columns (lane l column c0 + l), so at R = 32 a row of the warp's
// columns is one 128-byte line.  Each lane's state is interleaved with its
// warp's: slot i of lane l at i * kLanes + l, so lanes at the same step
// touch one line and distinct banks.  A ragged stack gives each slice's
// J_k (`sizes`, K int32 on the device): column c walks the J_k rows of
// slice c / R and writes rows J_k .. n - 1 as exact zeros.
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;   // columns a warp
constexpr int kAhead = 8;    // rows of y a lane loads ahead of its walk

// A warp's scan state, slots 0..n of its 32 lanes, in its slice of the
// workspace (in device memory: a block's shared memory holds too few
// lanes' state to fill the card): sumwy, blev and idxr, 20 bytes a slot a
// lane, for kinds 0 and 1; 44 with sumwy2, err and berr for kind 2.
__host__ __device__ constexpr long lanes_state_bytes(int n, bool err) {
  return (err ? 44L : 20L) * (n + 1) * kLanes;
}

// Lane `lane`'s view of a warp's interleaved scan state at `base`.
__device__ __forceinline__ Scan carve_lanes(unsigned char* base, int n,
                                            int lane, bool err) {
  const long slots = static_cast<long>(n + 1) * kLanes;
  double* d = reinterpret_cast<double*>(base);
  Scan w;
  w.sumwy = d + lane;
  w.blev = d + slots + lane;
  w.level = nullptr;
  w.sumwy2 = err ? d + 2 * slots + lane : nullptr;
  w.err = err ? d + 3 * slots + lane : nullptr;
  w.berr = err ? d + 4 * slots + lane : nullptr;
  w.idxr = reinterpret_cast<int*>(d + (err ? 5 : 2) * slots) + lane;
  return w;
}

// The lane's column and its true length: col_offset of flat column c, and
// J_k (n for a regular stack; 0 past the last column, whose lanes walk
// nothing and write nothing).
struct LaneCol {
  long off;
  int m;
  bool live;
};

__device__ __forceinline__ LaneCol lane_col(long c, int K, int n, int R,
                                            const int* sizes) {
  const bool live = c < static_cast<long>(K) * R;
  return {live ? col_offset(c, n, R) : 0,
          live ? (sizes ? sizes[c / R] : n) : 0, live};
}

// A lane's scan of the m rows of its column (flipped: from row m - 1 up),
// times sign, read straight from Y kAhead rows ahead of the walk.  The
// rows are kept as loaded, in the storage type, and widened where the step
// uses them, so nothing waits on a load until a whole group of steps has
// run.
template <bool Err, typename T>
__device__ __forceinline__ void lanes_walk(const T* __restrict__ y, long R,
                                           int m, bool flip, double sign,
                                           bool nonneg, const Scan& w) {
  scan_start<Err, true>(w);
  Carry c;
  auto load = [&](int i) {
    return i <= m ? y[static_cast<long>(flip ? m - i : i - 1) * R] : T(0);
  };
  T cur[kAhead], nxt[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) cur[u] = load(1 + u);
  for (int i0 = 1; i0 <= m; i0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) nxt[u] = load(i0 + kAhead + u);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (i0 + u <= m)
        scan_step<kLanes, Err, true>(i0 + u, sign * static_cast<double>(cur[u]),
                                     nonneg, w, c);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }
}

// Write a lane's fit of the prefix of length len of its m-row scan, times
// sign: slot j at row j - 1, or m - j where the scan ran flipped.  Slots
// are taken from len down; slot j < left starts the next set (its right
// end is j), whose left end is then slot j's and whose level is
// sumwy[j] / (j - left + 1), the walk's own division (its sw counted the
// set's slots exactly).  The loop runs
// the padded n rows in every lane, so the lanes of a warp write one row
// together, and loads kAhead slots before it writes their rows, so the
// loads' latency is paid once a group.
template <typename T>
__device__ __forceinline__ void fill_lanes(T* out, long R, int n, int m,
                                           int len, bool flip, double sign,
                                           bool nonneg, const Scan& w) {
  int left = INT_MAX;
  double v = 0.0;
  for (int j0 = n; j0 >= 1; j0 -= kAhead) {
    int lj[kAhead];
    double sj[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 - u;
      const bool in = j >= 1 && j <= len;
      lj[u] = in ? w.idxr[j * kLanes] : 0;
      sj[u] = in ? w.sumwy[j * kLanes] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int j = j0 - u;
      if (j < 1 || j > len) continue;
      if (j < left) {
        left = lj[u];
        v = sj[u] / static_cast<double>(j - left + 1);
        if (nonneg && v < 0.0) v = 0.0;
      }
      out[static_cast<long>(flip ? m - j : j - 1) * R] = static_cast<T>(sign * v);
    }
  }
}

template <typename T>
__device__ __forceinline__ void zero_rows(T* out, long R, int from, int n) {
  for (int r = from; r < n; ++r) out[static_cast<long>(r) * R] = T(0);
}

// Kernel A, kinds 0 and 1, lanes route: a block is a warp of 32 columns.
template <typename T>
__global__ void __launch_bounds__(kLanes)
isotonic_lanes(const T* __restrict__ Y, T* __restrict__ X, int K, int n,
               int R, const int* __restrict__ sizes, double sign,
               unsigned char* ws, long stride) {
  const int l = threadIdx.x;
  const LaneCol col = lane_col(static_cast<long>(blockIdx.x) * kLanes + l,
                               K, n, R, sizes);
  const Scan w = carve_lanes(ws + blockIdx.x * stride, n, l, false);
  lanes_walk<false>(Y + col.off, R, col.m, false, sign, false, w);
  if (!col.live) return;
  fill_lanes(X + col.off, R, n, col.m, col.m, false, sign, false, w);
  zero_rows(X + col.off, R, col.m, n);
}

// Kernel A, kind 2, lanes route: a block of two warps takes 32 columns,
// warp 0 their forward scans and warp 1 their flipped scans, each in its
// own workspace slice (block b's warps at slices 2 b and 2 b + 1).  After
// the scans (__syncthreads orders the warps' writes to device memory for
// the block) lane l of both warps reduces column l's err_L(i) + err_R(m - i +
// 1), warp 0 over the first half of i and warp 1 the second, to the peak
// by before()'s rule (the first NaN, else the first minimum); then warp 0
// writes rows 0 .. best - 1 and warp 1 rows best .. m - 1 and the padding.
template <typename T>
__global__ void __launch_bounds__(2 * kLanes)
unimodal_lanes(const T* __restrict__ Y, T* __restrict__ X, int K, int n,
               int R, const int* __restrict__ sizes, int nonneg,
               unsigned char* ws, long stride) {
  __shared__ Peak part[kLanes];
  __shared__ int best_s[kLanes];
  const int l = threadIdx.x % kLanes;
  const int side = threadIdx.x / kLanes;
  const LaneCol col = lane_col(static_cast<long>(blockIdx.x) * kLanes + l,
                               K, n, R, sizes);
  const int m = col.m;
  auto state = [&](int s) {
    return carve_lanes(ws + (2L * blockIdx.x + s) * stride, n, l, true);
  };
  const Scan w = state(side);
  lanes_walk<true>(Y + col.off, R, m, side == 1, 1.0, nonneg != 0, w);
  __syncthreads();
  const double* errL = state(0).err;
  const double* errR = state(1).err;
  const int half = (m + 1) / 2;
  const int lo = side == 0 ? 1 : half + 1, hi = side == 0 ? half : m;
  Peak p{INFINITY, 0, INT_MAX};
  for (int i0 = lo; i0 <= hi; i0 += kAhead) {
    double e[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u;
      e[u] = i <= hi ? errL[i * kLanes] + errR[(m - i + 1) * kLanes] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const Peak q{e[u], isnan(e[u]) ? 1 : 0, i0 + u};
      if (i0 + u <= hi && before(q, p)) p = q;
    }
  }
  if (side == 1) part[l] = p;
  __syncthreads();
  if (side == 0) {
    if (before(part[l], p)) p = part[l];
    best_s[l] = p.i;
  }
  __syncthreads();
  if (!col.live) return;
  const int best = best_s[l];
  T* out = X + col.off;
  if (side == 0) {
    fill_lanes(out, R, n, m, best, false, 1.0, nonneg != 0, w);
  } else {
    fill_lanes(out, R, n, m, m - best, true, 1.0, nonneg != 0, w);
    zero_rows(out, R, m, n);
  }
}

// Kernel B, lanes route: a block is a warp of 32 columns; a lane stages its
// column's m rows in the storage type (lane-interleaved, in shared memory
// or in the warp's workspace slice), walks Condat's algorithm on them in
// place, and writes them out with the padding; lam <= 0, a NaN lam and
// m == 1 leave the column as it is.
template <typename T, bool InShared>
__global__ void __launch_bounds__(kLanes)
tv_lanes(const T* __restrict__ Y, T* __restrict__ X, int K, int n, int R,
         const int* __restrict__ sizes, const double* __restrict__ lam_p,
         unsigned char* ws, long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int l = threadIdx.x;
  const long c = static_cast<long>(blockIdx.x) * kLanes + l;
  const LaneCol col = lane_col(c, K, n, R, sizes);
  if (!col.live) return;
  T* buf = reinterpret_cast<T*>(InShared ? smem : ws + blockIdx.x * stride) + l;
  const T* y = Y + col.off;
  for (int i = 0; i < col.m; ++i) buf[i * kLanes] = y[static_cast<long>(i) * R];
  const double lam = lam_p[c / R];
  if (col.m > 1 && lam > 0.0) condat_walk<kLanes>(buf, buf, col.m, lam);
  T* x = X + col.off;
  for (int i = 0; i < n; ++i)
    x[static_cast<long>(i) * R] = i < col.m ? buf[i * kLanes] : T(0);
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

template <typename T>
int isotonic_lanes_launch(int kind, int nonneg, const void* Y, void* X, int K,
                          int n, int R, const int* sizes, unsigned char* ws,
                          long stride, cudaStream_t st) {
  const T* y = static_cast<const T*>(Y);
  T* x = static_cast<T*>(X);
  const long warps = (static_cast<long>(K) * R + kLanes - 1) / kLanes;
  if (kind == 2)
    unimodal_lanes<T><<<warps, 2 * kLanes, 0, st>>>(y, x, K, n, R, sizes,
                                                    nonneg, ws, stride);
  else
    isotonic_lanes<T><<<warps, kLanes, 0, st>>>(
        y, x, K, n, R, sizes, kind == 1 ? -1.0 : 1.0, ws, stride);
  return (int)cudaGetLastError();
}

template <typename T, bool InShared>
int tv_lanes_launch(const void* Y, void* X, int K, int n, int R,
                    const int* sizes, const double* lam, long smem,
                    unsigned char* ws, long stride, cudaStream_t st) {
  cudaError_t e;
  auto* k = tv_lanes<T, InShared>;
  if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
  k<<<(static_cast<long>(K) * R + kLanes - 1) / kLanes, kLanes, smem, st>>>(
      static_cast<const T*>(Y), static_cast<T*>(X), K, n, R, sizes, lam, ws,
      stride);
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

// Kernel A, lanes route: ceil(K R / 32) blocks, a warp a scan side of 32
// columns (two warps a block for kind 2).  sizes: null for a regular
// stack, else K int32 J_k in 1..n on the device.  Warp w's state is at ws
// + w * stride (a multiple of 16 bytes, at least lanes_state_bytes: 20 (n
// + 1) bytes a lane for kinds 0 and 1, 44 (n + 1) for kind 2).
extern "C" int isotonic_lanes_run(int is_double, int kind, int nonneg,
                                  const void* Y, void* X, int K, int n, int R,
                                  const void* sizes, void* ws, long stride,
                                  void* stream) {
  if (K < 1 || n < 1 || R < 1 || kind < 0 || kind > 2 ||
      !state_fits(lanes_state_bytes(n, kind == 2), 0, ws, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  unsigned char* w = static_cast<unsigned char*>(ws);
  return is_double
      ? isotonic_lanes_launch<double>(kind, nonneg, Y, X, K, n, R, sz, w, stride, st)
      : isotonic_lanes_launch<float>(kind, nonneg, Y, X, K, n, R, sz, w, stride, st);
}

// Kernel B, lanes route: ceil(K R / 32) blocks of one warp.  A lane's state
// is its column in the storage type, itemsize * n bytes: in `smem` bytes
// of shared memory a block (ws null), or in ws + block * stride.
extern "C" int tv_lanes_run(int is_double, const void* Y, void* X, int K, int n,
                            int R, const void* sizes, const void* lam, long smem,
                            void* ws, long stride, void* stream) {
  const long bytes = static_cast<long>(is_double ? 8 : 4) * n * kLanes;
  if (K < 1 || n < 1 || R < 1 || !state_fits(bytes, smem, ws, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(sizes);
  const double* l = static_cast<const double*>(lam);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (w == nullptr)
    return is_double ? tv_lanes_launch<double, true>(Y, X, K, n, R, sz, l, smem, w, 0, st)
                     : tv_lanes_launch<float, true>(Y, X, K, n, R, sz, l, smem, w, 0, st);
  return is_double ? tv_lanes_launch<double, false>(Y, X, K, n, R, sz, l, 0, w, stride, st)
                   : tv_lanes_launch<float, false>(Y, X, K, n, R, sz, l, 0, w, stride, st);
}
