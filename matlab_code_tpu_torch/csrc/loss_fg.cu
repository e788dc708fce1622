// Kernel D: the loss pass of the non-Frobenius losses (KL, Itakura-Saito,
// beta divergence), for Hopper (sm_90a), bound by matlab_code_tpu_torch/
// ops/loss_cuda.py (plain C entries, ctypes).  Two kernels share the loss
// formulas (fg below):
//   * the fused evaluation (loss_fg_fused, entry loss_fg_fused_run): from a
//     dense 3-way X and its three factors, f = sum fh(X, M) and the
//     MTTKRP G of gh(X, M) into mode 0, 1 or 2, with the CP model M formed
//     element by element in registers and never written to device memory;
//   * the old pass (loss_fg_pass, entry loss_fg_run): (sum fh(X, M),
//     gh(X, M)) from X and a given M, kept for the datasets the fused
//     kernel does not take (a 2-way dataset, order above 3, a block of a
//     dataset cut over a mesh).
//
// Neither replaces a Pallas kernel: the JAX package leaves this evaluation
// to XLA, which fuses it inside the L-BFGS-B value and gradient
// (matlab_code_tpu/models/lbfgs_bridge.py:41-49: M = ktensor_full(facs),
// sum fh, Y = gh, mttkrp(Y, facs, mode)) and the objective
// (matlab_code_tpu/models/objective.py:84-87).  The formulas are those of
// ops/losses.py (cmtf_AOADMM.m:168-186):
//   KL    fh = M - X log(M + eps)             gh = 1 - X / (M + eps)
//   IS    fh = X / (M + eps) + log(M + eps)   gh = -X / (M + eps)^2 + 1 / (M + eps)
//   beta  fh = (1/b) M^b - ((1/(b-1)) X) M^(b-1)
//         gh = M^(b-1) - X M^(b-2)
//
// Arithmetic of both: each elementwise fh and gh is that of the plain
// version (ops/losses.loss_fg_reference, one torch operation at a time):
// every product, sum and quotient is an _rn intrinsic in the storage type,
// in the plain version's order, so nvcc contracts nothing into a fused
// multiply-add; log, pow, sqrt and rsqrt are the device functions torch's
// own kernels call, and a power takes the shortcuts torch.pow takes for a
// scalar exponent (0, 1, 0.5, 2, 3, -0.5, -1, -2).  The sums are
// deterministic: fixed orders, float64 for f, no atomics, so two calls on
// the same inputs give the same bits (the L-BFGS-B line search and its stop
// tests branch on f).
//
// The fused evaluation.  What bounds it: X, read once, is its only large
// operand (33.5 MB, 10.0 us at 3.35 TB/s, for the 128 x 256 x 256 KL
// workload in float32); per element it does ~4R + 10 floating-point
// operations (the model 2R without fused multiply-adds, the MTTKRP R
// multiply-adds), ~5 us at R 8 on the float32 units.  On the card
// (PERF.md) it takes ~7x that bound at R 8: X.sum() alone takes twice the
// bound, the f-only pass (X, the model, fh) twice X.sum(), and the
// MTTKRP's accumulation half as much again.  The division and log of fh
// and gh are not what sets it (the beta-2 call, which has neither, is
// slower); the index arithmetic and the shared-memory reads of the staged
// rows are the candidates, not yet told apart by a measurement.  Its work
// grows 3R an element, and most float64 instances and the wide float32
// ones spill registers (ptxas): past R 16 in float32 and R 8 in float64 it
// takes more device time than the three-call evaluation it replaces
// (ops/losses.FUSED_MAX_RANK routes those ranks there), which wrote M
// (torch.einsum), read X and M and wrote Y (the old pass) and read Y back
// (mttkrp3): three times X's bytes more.
//   * A block (256 threads) takes one unit: a k tile of kw * KPT
//     consecutive k and a range of rows (i, j).  Thread (rl, kl) owns the
//     KPT consecutive k = tile start + kl * KPT .. + KPT - 1 and keeps
//     their C rows in registers (KPT * RM values; RM is R padded to 4, 8,
//     16, 32, 48 or 64; KPT 2 where those take at most 32 registers, else
//     1); the P = 256 / kw row lanes rl take rows rl, rl + P, ... of each
//     chunk of P * 8 rows.
//   * X is streamed once: each thread loads its KPT elements of a row as
//     one vector load (8 bytes in float32, 16 in float64), neighbouring
//     threads on neighbouring addresses; plain loads where K or the pointer
//     is off that alignment.  The loads of chunk c + 1 (X and the factor
//     rows) are issued before chunk c is computed, so their latency hides
//     behind its arithmetic; one barrier a chunk.
//   * The chunk's factor rows sit in shared memory (two buffers), staged
//     once a chunk:
//     AB[row, r] = A[i, r] B[j, r] (one rounded product) and, for modes 0
//     and 1, the walked factor's row.  Each element's model value is
//     m = sum_r AB[row, r] C[k, r], formed in registers in ascending r with
//     _rn intrinsics ((A B) C, then left to right, as torch.einsum
//     contracts A with B first), and fh, gh follow as in the old pass.
//   * Modes 0 and 1 (the rows kind): a unit is one output row o (i in mode
//     0, j in mode 1), a range of walked rows s (j, or i) and a k tile.  A
//     thread adds t[r] = sum_kk gh[kk] C[k_kk, r] times the walked
//     factor's row into R accumulators; at the unit's end the block sums
//     them in a fixed tree (warp shuffles, then the warps in order) into
//     the unit's partial row.
//   * Mode 2 (the stream kind, also the f-only pass of the objective): a
//     unit is a range of rows (i, j) in X's order (one contiguous slab) and
//     a k tile; each thread accumulates gh[kk] AB[row, :] for each of its
//     k, and at the unit's end the row lanes' sums are added in lane order
//     through shared memory into the unit's partial K-tile x R.
//   * f: each thread adds fh of its elements in float64 in a fixed order,
//     the block reduces them into the unit's partial.  A second launch
//     (fused_reduce) sums the partials of G (8 warps splitting the slices,
//     their sums in warp order) and of f in a fixed order, and writes G
//     and f in the storage type.
//   * Several problems in one launch (fit_multistart's starts): grid.y is
//     the start s, whose factors are at s n R, whose X is at s x_stride (0
//     where the starts share X), and whose partials, G and f are its own.
//     Each start's blocks do exactly what a launch of that start alone
//     does, so every start's f and G carry the bits of its own launch.
//   The launch plan (kw, the units, the partials, the shared memory) is
//   computed by ops/loss_cuda.plan_fused from the shape alone.
//
// The old pass reads X and M and writes Y: a plain grid-stride pass,
// neighbouring threads on neighbouring elements, each thread keeping its
// running sum of fh in float64; a second launch sums the blocks' partials.
// On the start axis grid.y is the start, as above.

#include <cuda_runtime.h>

#include <cstring>

namespace loss_fg {

constexpr int kThreads = 256;      // threads a block of the pass
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rroot(float a) { return rsqrtf(a); }
__device__ __forceinline__ double rroot(double a) { return rsqrt(a); }
__device__ __forceinline__ float logt(float a) { return logf(a); }
__device__ __forceinline__ double logt(double a) { return log(a); }
__device__ __forceinline__ float powt(float a, float e) { return powf(a, e); }
__device__ __forceinline__ double powt(double a, double e) { return pow(a, e); }

// The shortcuts torch.pow(tensor, e) takes for a scalar exponent e, tested
// on e as a double as torch tests its Scalar; kGeneral is pow(x, e).
enum PowCode { kZero, kOne, kSqrt, kSquare, kCube, kRsqrt, kRecip, kRecipSquare,
               kGeneral };

inline int pow_code(double e) {
  if (e == 0.0) return kZero;
  if (e == 1.0) return kOne;
  if (e == 0.5) return kSqrt;
  if (e == 2.0) return kSquare;
  if (e == 3.0) return kCube;
  if (e == -0.5) return kRsqrt;
  if (e == -1.0) return kRecip;
  if (e == -2.0) return kRecipSquare;
  return kGeneral;
}

// x ** e as torch.pow(tensor, e) computes it, e's shortcut given as code.
template <typename T>
__device__ __forceinline__ T power(T x, T e, int code) {
  switch (code) {
    case kZero: return T(1);
    case kOne: return x;
    case kSqrt: return root(x);
    case kSquare: return mul(x, x);
    case kCube: return mul(mul(x, x), x);
    case kRsqrt: return rroot(x);
    case kRecip: return quot(T(1), x);
    case kRecipSquare: return quot(T(1), mul(x, x));
    default: return powt(x, e);
  }
}

enum Loss { kKL = 0, kIS = 1, kBeta = 2 };

// The loss's constants in the storage type, as torch casts Python scalars.
template <typename T>
struct Consts {
  T eps, b, b1, b2, inv_b, inv_b1;
  int code_b, code_b1, code_b2;   // pow_code of b, b - 1 and b - 2
};

// fh of one element; writes gh to *g.
template <typename T, int L>
__device__ __forceinline__ T fg(T x, T m, const Consts<T>& c, T* g) {
  if (L == kKL) {
    const T me = add(m, c.eps);
    *g = sub(T(1), quot(x, me));
    return sub(m, mul(x, logt(me)));
  } else if (L == kIS) {
    const T me = add(m, c.eps);
    *g = add(quot(-x, mul(me, me)), quot(T(1), me));
    return add(quot(x, me), logt(me));
  } else {
    const T m1 = power(m, c.b1, c.code_b1);
    *g = sub(m1, mul(x, power(m, c.b2, c.code_b2)));
    return sub(mul(c.inv_b, power(m, c.b, c.code_b)), mul(mul(c.inv_b1, x), m1));
  }
}

// Sum of v over the block's threads, in a fixed order; the result is
// valid in thread 0.
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (warp == 0) {
    v = lane < nwarps ? warp_sums[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}


template <typename T>
Consts<T> make_consts(double eps, double beta) {
  Consts<T> c;
  c.eps = static_cast<T>(eps);
  c.b = static_cast<T>(beta);
  c.b1 = static_cast<T>(beta - 1.0);
  c.b2 = static_cast<T>(beta - 2.0);
  c.inv_b = static_cast<T>(1.0 / beta);
  c.inv_b1 = static_cast<T>(1.0 / (beta - 1.0));
  c.code_b = pow_code(beta);
  c.code_b1 = pow_code(beta - 1.0);
  c.code_b2 = pow_code(beta - 2.0);
  return c;
}

// ---- the fused evaluation -------------------------------------------------

constexpr int kFusedThreads = 256;
constexpr int kFusedRows = 8;      // rows a thread takes of each chunk
// factor-row entries a thread stages a chunk: a chunk's nr x RM table is
// at most 256 kFusedStage entries (ops/loss_cuda.plan_fused)
constexpr int kFusedStage = 4;
// dynamic shared memory of a block, within the 48 KB a launch may take
// without opting in (the static arrays beside it take at most 4.1 KB)
constexpr int kFusedSmemMax = 40960;

// k a thread owns: two where their C rows (2 RM values) take at most 32
// registers, else one.  Not four (16-byte loads in float32): four double
// the registers of C and of the mode-2 accumulators, and the kernel is
// bound by the issue of its instructions, not by the width of its loads.
// ops/loss_cuda.fused_kpt mirrors it.
template <typename T, int RM>
__host__ __device__ constexpr int fused_kpt() {
  return RM * static_cast<int>(sizeof(T)) <= 64 ? 2 : 1;
}

// The launch plan (ops/loss_cuda.plan_fused) and the problem.
struct FusedArgs {
  int I, J, K, R;
  int mode;        // output mode: 0, 1 (rows kind) or 2 (stream kind)
  int grad;        // 0: f alone (no G)
  int kw_log2;     // threads along k: kw = 1 << kw_log2, P = 256 / kw row lanes
  int nsplit;      // rows kind: ranges an output row; stream kind: row ranges
  long span;       // rows a range: walked rows (rows kind) or rows (i, j)
  int nslices;     // partial slices of G
  int vec;         // X's runs load as vectors (K % KPT == 0, aligned)
  long x_stride;   // elements between the starts' X (0: shared)
};

// N elements of X from p as one vector load (p aligned to their bytes:
// 16, 8 or 4).
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* __restrict__ p, T (&v)[N]) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  static_assert(bytes == 16 || bytes == 8 || bytes == 4, "one vector load");
  if constexpr (bytes == 16) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    memcpy(&v[0], &w, 16);
  } else if constexpr (bytes == 8) {
    const float2 w = __ldg(reinterpret_cast<const float2*>(p));
    memcpy(&v[0], &w, 8);
  } else {
    v[0] = __ldg(p);
  }
}

template <typename T, int L, int RM, bool ROWS>
__global__ void __launch_bounds__(kFusedThreads,
                                  RM * sizeof(T) <= 64 ? 2 : 1)
loss_fg_fused(const T* __restrict__ X, const T* __restrict__ A,
              const T* __restrict__ B, const T* __restrict__ C, FusedArgs a,
              Consts<T> c, T* __restrict__ gpart, double* __restrict__ fpart) {
  constexpr int KPT = fused_kpt<T, RM>();
  constexpr int NACC = ROWS ? RM : KPT * RM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double warp_f[kFusedThreads / 32];
  __shared__ T warp_g[ROWS ? kFusedThreads / 32 : 1][RM];
  // two buffers, each [nr][RM] rows A[i] B[j] (and, rows kind, [nr][RM]
  // rows of the walked factor)
  T* ab = reinterpret_cast<T*>(smem_raw);
  const int I = a.I, J = a.J, K = a.K, R = a.R;
  const int s = blockIdx.y, u = blockIdx.x, tid = threadIdx.x;
  X += s * a.x_stride;
  A += static_cast<long>(s) * I * R;
  B += static_cast<long>(s) * J * R;
  C += static_cast<long>(s) * K * R;
  const int kw = 1 << a.kw_log2;
  const int P = kFusedThreads >> a.kw_log2;
  const int nr = P * kFusedRows;
  const int kl = tid & (kw - 1), rl = tid >> a.kw_log2;

  // the unit: k tile kt, output row o (rows kind), range g of rows
  int kt, g, o = 0;
  long row0, row1;
  const T* orow = nullptr;                   // rows kind: the output row
  const T* walked = nullptr;                 // rows kind: the walked factor
  if (ROWS) {
    const int O = a.mode == 0 ? I : J;
    const long S = a.mode == 0 ? J : I;
    kt = u / (O * a.nsplit);
    const int rest = u - kt * O * a.nsplit;
    o = rest / a.nsplit;
    g = rest - o * a.nsplit;
    row0 = static_cast<long>(g) * a.span;
    row1 = row0 + a.span < S ? row0 + a.span : S;
    orow = (a.mode == 0 ? A : B) + static_cast<long>(o) * R;
    walked = a.mode == 0 ? B : A;
  } else {
    kt = u / a.nsplit;
    g = u - kt * a.nsplit;
    row0 = static_cast<long>(g) * a.span;
    const long rows = static_cast<long>(I) * J;
    row1 = row0 + a.span < rows ? row0 + a.span : rows;
  }
  const int kb = (kt * kw + kl) * KPT;      // the thread's first k

  T cr[KPT][RM];
#pragma unroll
  for (int kk = 0; kk < KPT; ++kk)
#pragma unroll
    for (int r = 0; r < RM; ++r)
      cr[kk][r] = (kb + kk < K && r < R)
          ? C[static_cast<long>(kb + kk) * R + r] : T(0);
  T acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = T(0);
  double facc = 0.0;

  // the thread's loads of a chunk: its rows of X, and its share of the
  // chunk's factor rows (entries tid + 256 e of the nr x RM table)
  auto load_x = [&](long base, T (&xv)[kFusedRows][KPT]) {
#pragma unroll
    for (int t = 0; t < kFusedRows; ++t) {
      const long q = base + rl + t * P;
      if (q < row1 && kb < K) {
        const long rowk = ROWS ? (a.mode == 0
            ? static_cast<long>(o) * J + q : q * J + o) : q;
        const T* p = X + rowk * K + kb;
        if (a.vec) {
          load_run<T, KPT>(p, xv[t]);
        } else {
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk)
            xv[t][kk] = kb + kk < K ? __ldg(p + kk) : T(0);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KPT; ++kk) xv[t][kk] = T(0);
      }
    }
  };
  auto load_rows = [&](long base, T (&sv)[kFusedStage], T (&fv)[kFusedStage]) {
#pragma unroll
    for (int e = 0; e < kFusedStage; ++e) {
      const int idx = tid + e * kFusedThreads;
      const int lr = idx / RM, r = idx - lr * RM;
      const long q = base + lr;
      sv[e] = fv[e] = T(0);
      if (lr < nr && q < row1 && r < R) {
        if (ROWS) {
          fv[e] = __ldg(walked + q * R + r);
          sv[e] = mul(__ldg(orow + r), fv[e]);
        } else {
          const long i = q / J, j = q - i * J;
          sv[e] = mul(__ldg(A + i * R + r), __ldg(B + j * R + r));
        }
      }
    }
  };
  auto store_rows = [&](T* buf, const T (&sv)[kFusedStage],
                        const T (&fv)[kFusedStage]) {
#pragma unroll
    for (int e = 0; e < kFusedStage; ++e) {
      const int idx = tid + e * kFusedThreads;
      if (idx < nr * RM) {
        buf[idx] = sv[e];
        if (ROWS) buf[nr * RM + idx] = fv[e];
      }
    }
  };

  // two buffers of staged rows; chunk c + 1's loads are in flight while
  // chunk c is computed, and one barrier a chunk
  const int stage = nr * RM * (ROWS ? 2 : 1);
  T xv[kFusedRows][KPT], xn[kFusedRows][KPT];
  T sv[kFusedStage], fv[kFusedStage];
  load_x(row0, xv);
  load_rows(row0, sv, fv);
  store_rows(ab, sv, fv);
  __syncthreads();
  int cur = 0;
  for (long base = row0; base < row1; base += nr) {
    const bool more = base + nr < row1;
    if (more) {
      load_x(base + nr, xn);
      load_rows(base + nr, sv, fv);
    }
    const T* abuf = ab + cur * stage;
    const T* fbuf = abuf + nr * RM;
#pragma unroll
    for (int t = 0; t < kFusedRows; ++t) {
      const int lr = rl + t * P;
      if (base + lr >= row1 || kb >= K) continue;
      const T* abr = abuf + lr * RM;
      T m[KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) m[kk] = mul(abr[0], cr[kk][0]);
#pragma unroll
      for (int r = 1; r < RM; ++r) {
        if (r < R) {
          const T w = abr[r];
#pragma unroll
          for (int kk = 0; kk < KPT; ++kk) m[kk] = add(m[kk], mul(w, cr[kk][r]));
        }
      }
      T gk[KPT];
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) {
        gk[kk] = T(0);
        if (kb + kk < K)
          facc += static_cast<double>(fg<T, L>(xv[t][kk], m[kk], c, &gk[kk]));
      }
      if (a.grad) {
        if (ROWS) {
          const T* fr = fbuf + lr * RM;
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            T tr = gk[0] * cr[0][r];
#pragma unroll
            for (int kk = 1; kk < KPT; ++kk) tr = fma(gk[kk], cr[kk][r], tr);
            acc[r] = fma(tr, fr[r], acc[r]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            const T w = abr[r];
#pragma unroll
            for (int kk = 0; kk < KPT; ++kk)
              acc[kk * RM + r] = fma(gk[kk], w, acc[kk * RM + r]);
          }
        }
      }
    }
    if (more) {
      store_rows(ab + (cur ^ 1) * stage, sv, fv);
#pragma unroll
      for (int t = 0; t < kFusedRows; ++t)
#pragma unroll
        for (int kk = 0; kk < KPT; ++kk) xv[t][kk] = xn[t][kk];
    }
    __syncthreads();
    cur ^= 1;
  }

  const double fsum = block_sum(facc, warp_f);
  if (tid == 0) fpart[static_cast<long>(s) * gridDim.x + u] = fsum;
  if (!a.grad) return;
  const int lane = tid & 31, warp = tid >> 5;
  if (ROWS) {
    // the block's sum of acc, a fixed tree, into the unit's partial row
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      T v = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_g[warp][r] = v;
    }
    __syncthreads();
    if (tid < R) {
      T v = warp_g[0][tid];
#pragma unroll
      for (int w = 1; w < kFusedThreads / 32; ++w) v += warp_g[w][tid];
      const int O = a.mode == 0 ? I : J;
      const long slice = static_cast<long>(kt) * a.nsplit + g;
      gpart[((static_cast<long>(s) * a.nslices + slice) * O + o) * R + tid] = v;
    }
  } else {
    // the row lanes' sums of each (k, r), in lane order, 8 columns a pass
    T* buf = reinterpret_cast<T*>(smem_raw);   // [8][256], the staging's room
    T* out = gpart + (static_cast<long>(s) * a.nslices + g) * K * R;
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
#pragma unroll
      for (int r0 = 0; r0 < RM; r0 += 8) {
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 8; ++q)
          buf[q * kFusedThreads + tid] = r0 + q < RM ? acc[kk * RM + r0 + q] : T(0);
        __syncthreads();
        for (int e = tid; e < 8 * kw; e += kFusedThreads) {
          const int q = e >> a.kw_log2, l = e & (kw - 1);
          T v = buf[q * kFusedThreads + l];
          for (int p = 1; p < P; ++p) v += buf[q * kFusedThreads + p * kw + l];
          const int k = (kt * kw + l) * KPT + kk, r = r0 + q;
          if (k < K && r < R) out[static_cast<long>(k) * R + r] = v;
        }
      }
    }
  }
}

// G[s, idx] = sum over the slices of gpart[s, slice, idx] in a fixed order
// (warp w of a block takes slices w, w + 8, ... of 32 outputs, the block
// adds the 8 warp sums in warp order); the last block of each start sums
// its units' f partials.
template <typename T>
__global__ void __launch_bounds__(256)
fused_reduce(const T* __restrict__ gpart, int nslices, long nout,
             T* __restrict__ G, const double* __restrict__ fpart, int units,
             T* __restrict__ f) {
  __shared__ double warp_f[8];
  __shared__ T red[8][32];
  const int s = blockIdx.y, tid = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {
    fpart += static_cast<long>(s) * units;
    double v = 0.0;
    for (int i = tid; i < units; i += 256) v += fpart[i];
    v = block_sum(v, warp_f);
    if (tid == 0) f[s] = static_cast<T>(v);
    return;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const long idx = blockIdx.x * 32L + lane;
  const T* part = gpart + static_cast<long>(s) * nslices * nout;
  T v = T(0);
  if (idx < nout)
    for (int sl = warp; sl < nslices; sl += 8) v += part[sl * nout + idx];
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && idx < nout) {
    T t = red[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][lane];
    G[s * nout + idx] = t;
  }
}

template <typename T, int L, int RM, bool ROWS>
int fused_launch(const T* X, const T* A, const T* B, const T* C,
                 const FusedArgs& a, const Consts<T>& c, int units, int starts,
                 int smem, T* gpart, double* fpart, cudaStream_t st) {
  loss_fg_fused<T, L, RM, ROWS><<<dim3(units, starts), kFusedThreads, smem,
                                  st>>>(X, A, B, C, a, c, gpart, fpart);
  return (int)cudaGetLastError();
}

template <typename T, int L, bool ROWS>
int fused_launch_rm(int rm, const T* X, const T* A, const T* B, const T* C,
                    const FusedArgs& a, const Consts<T>& c, int units,
                    int starts, int smem, T* gpart, double* fpart,
                    cudaStream_t st) {
  switch (rm) {
#define LOSS_FG_RM(n) \
    case n: return fused_launch<T, L, n, ROWS>(X, A, B, C, a, c, units, \
                                               starts, smem, gpart, fpart, st);
    LOSS_FG_RM(4) LOSS_FG_RM(8) LOSS_FG_RM(16) LOSS_FG_RM(32) LOSS_FG_RM(48)
    LOSS_FG_RM(64)
#undef LOSS_FG_RM
    default: return (int)cudaErrorInvalidValue;
  }
}

// The fused evaluation of loss L in storage type T: its pass, then
// fused_reduce.
template <typename T, int L>
int fused_run(int rm, const void* X, const void* A, const void* B,
              const void* C, const FusedArgs& a, int units, int starts,
              int smem, double eps, double beta, void* gpart, double* fpart,
              void* G, void* f, cudaStream_t st) {
  const Consts<T> c = make_consts<T>(eps, beta);
  const T* x = static_cast<const T*>(X);
  const T* fa = static_cast<const T*>(A);
  const T* fb = static_cast<const T*>(B);
  const T* fc = static_cast<const T*>(C);
  T* gp = static_cast<T*>(gpart);
  int e = a.mode < 2
      ? fused_launch_rm<T, L, true>(rm, x, fa, fb, fc, a, c, units, starts,
                                    smem, gp, fpart, st)
      : fused_launch_rm<T, L, false>(rm, x, fa, fb, fc, a, c, units, starts,
                                     smem, gp, fpart, st);
  if (e != 0) return e;
  const long nout = static_cast<long>(a.mode == 0 ? a.I : a.mode == 1 ? a.J : a.K) * a.R;
  const int gblocks = a.grad ? static_cast<int>((nout + 31) / 32) : 0;
  fused_reduce<T><<<dim3(gblocks + 1, starts), 256, 0, st>>>(
      gp, a.nslices, nout, static_cast<T*>(G), fpart, units, static_cast<T*>(f));
  return (int)cudaGetLastError();
}

// ---- the old pass ----------------------------------------------------------


template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
loss_fg_pass(const T* __restrict__ X, long x_stride, const T* __restrict__ M,
             T* __restrict__ Y, long n, Consts<T> c,
             double* __restrict__ partials) {
  __shared__ double warp_sums[kThreads / 32];
  const long s = blockIdx.y;
  X += s * x_stride;
  M += s * n;
  Y += s * n;
  partials += s * gridDim.x;
  const long stride = static_cast<long>(gridDim.x) * kThreads;
  double acc = 0.0;
  for (long i = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    T g;
    acc += static_cast<double>(fg<T, L>(X[i], M[i], c, &g));
    Y[i] = g;
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
loss_fg_reduce(const double* __restrict__ partials, int count, T* __restrict__ f) {
  __shared__ double warp_sums[kReduceThreads / 32];
  partials += static_cast<long>(blockIdx.x) * count;
  f += blockIdx.x;
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kReduceThreads) acc += partials[i];
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) *f = static_cast<T>(acc);
}


template <typename T>
int loss_fg_launch(int loss, const void* X, long x_stride, const void* M,
                   void* Y, long n, int starts, double eps, double beta,
                   double* partials, int blocks, void* f, cudaStream_t st) {
  const Consts<T> c = make_consts<T>(eps, beta);
  const T* x = static_cast<const T*>(X);
  const T* m = static_cast<const T*>(M);
  T* y = static_cast<T*>(Y);
  const dim3 grid(blocks, starts);
  switch (loss) {
    case kKL: loss_fg_pass<T, kKL><<<grid, kThreads, 0, st>>>(x, x_stride, m, y, n, c, partials); break;
    case kIS: loss_fg_pass<T, kIS><<<grid, kThreads, 0, st>>>(x, x_stride, m, y, n, c, partials); break;
    case kBeta: loss_fg_pass<T, kBeta><<<grid, kThreads, 0, st>>>(x, x_stride, m, y, n, c, partials); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  loss_fg_reduce<T><<<starts, kReduceThreads, 0, st>>>(partials, blocks, static_cast<T*>(f));
  return (int)cudaGetLastError();
}

}  // namespace loss_fg

using namespace loss_fg;

// C entry for ctypes.  is_double selects float64 (else float32); loss is
// 0 KL, 1 IS, 2 beta.  `starts` problems of n contiguous elements each: M
// and Y hold starts x n on the device (Y is written), X the same with
// start s at s x_stride (x_stride 0: one X for every start).  partials:
// starts x `blocks` doubles of scratch on the device; f: `starts` elements
// of the storage type on the device, written with each start's sum fh.
// Returns the CUDA error of the two launches.
extern "C" int loss_fg_run(int is_double, int loss, const void* X, long x_stride,
                           const void* M, void* Y, long n, int starts,
                           double eps, double beta, void* partials, int blocks,
                           void* f, void* stream) {
  if (n < 1 || blocks < 1 || starts < 1 || starts > 65535 || x_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* p = static_cast<double*>(partials);
  return is_double
      ? loss_fg_launch<double>(loss, X, x_stride, M, Y, n, starts, eps, beta, p,
                               blocks, f, st)
      : loss_fg_launch<float>(loss, X, x_stride, M, Y, n, starts, eps, beta, p,
                              blocks, f, st);
}

// C entry of the fused evaluation, for ctypes.  is_double selects float64
// (else float32); loss is 0 KL, 1 IS, 2 beta; rm is R padded (4, 8, 16, 32,
// 48 or 64).  `starts` problems: factors A (starts, I, R), B (starts, J, R),
// C (starts, K, R) on the device, row-major; X (I, J, K) row-major with
// start s at s x_stride (0: one X for every start).  The plan (kw_log2,
// nsplit, span, units, nslices, vec, smem) is ops/loss_cuda.plan_fused's.
// gpart: starts x nslices x (n_mode R) elements of scratch (unused where
// grad is 0), fpart: starts x units doubles of scratch; G: starts x n_mode
// x R, written where grad is 1; f: `starts` elements, each start's sum fh.
// Returns the CUDA error of the launches.
extern "C" int loss_fg_fused_run(int is_double, int loss, int rm,
                                 const void* X, long x_stride, const void* A,
                                 const void* B, const void* C, int I, int J,
                                 int K, int R, int mode, int grad, int kw_log2,
                                 int nsplit, long span, int units, int nslices,
                                 int vec, int smem, int starts, double eps,
                                 double beta, void* gpart, void* fpart,
                                 void* G, void* f, void* stream) {
  if (I < 1 || J < 1 || K < 1 || R < 1 || R > rm || mode < 0 || mode > 2 ||
      kw_log2 < 0 || kw_log2 > 8 || nsplit < 1 || span < 1 || units < 1 ||
      nslices < 1 || starts < 1 || starts > 65535 || x_stride < 0 || smem < 0 ||
      smem > kFusedSmemMax)
    return (int)cudaErrorInvalidValue;
  FusedArgs a;
  a.I = I; a.J = J; a.K = K; a.R = R;
  a.mode = mode; a.grad = grad != 0; a.kw_log2 = kw_log2; a.nsplit = nsplit;
  a.span = span; a.nslices = nslices; a.vec = vec != 0; a.x_stride = x_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* fp = static_cast<double*>(fpart);
#define LOSS_FG_CALL(T, L) \
  fused_run<T, L>(rm, X, A, B, C, a, units, starts, smem, eps, beta, gpart, \
                  fp, G, f, st)
  switch (loss * 2 + (is_double != 0)) {
    case kKL * 2: return LOSS_FG_CALL(float, kKL);
    case kKL * 2 + 1: return LOSS_FG_CALL(double, kKL);
    case kIS * 2: return LOSS_FG_CALL(float, kIS);
    case kIS * 2 + 1: return LOSS_FG_CALL(double, kIS);
    case kBeta * 2: return LOSS_FG_CALL(float, kBeta);
    case kBeta * 2 + 1: return LOSS_FG_CALL(double, kBeta);
    default: return (int)cudaErrorInvalidValue;
  }
#undef LOSS_FG_CALL
}
