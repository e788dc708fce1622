// Kernel D: the loss pass of the non-Frobenius losses (KL, Itakura-Saito,
// beta divergence), for Hopper (sm_90a), bound by matlab_code_tpu_torch/
// ops/loss_cuda.py (a plain C entry, ctypes).
//
// It replaces no Pallas kernel: the JAX package leaves this pass to XLA,
// which fuses it inside the L-BFGS-B value and gradient
// (matlab_code_tpu/models/lbfgs_bridge.py:45-47) and the objective
// (matlab_code_tpu/models/objective.py:84-87).  In eager PyTorch the same
// formulas are ~10 elementwise launches, each a pass over the tensor.  In
// one pass over the data X and the model M (the same shape, contiguous) it
// computes
//   f = sum fh(X, M)   one scalar, and
//   Y = gh(X, M)       of X's shape and type,
// with the formulas of ops/losses.py (cmtf_AOADMM.m:168-186):
//   KL    fh = M - X log(M + eps)             gh = 1 - X / (M + eps)
//   IS    fh = X / (M + eps) + log(M + eps)   gh = -X / (M + eps)^2 + 1 / (M + eps)
//   beta  fh = (1/b) M^b - ((1/(b-1)) X) M^(b-1)
//         gh = M^(b-1) - X M^(b-2)
//
// What bounds it: the bytes.  Per element it reads X and M and writes Y
// (12 bytes in float32) against ~10-40 operations, far below the card's
// ridge: 100.7 MB, 30.0 us at 3.35 TB/s, for the 128 x 256 x 256 KL
// workload.  The design is a plain grid-stride pass: neighbouring threads
// take neighbouring elements (coalesced), about eight blocks an SM, and
// each thread keeps its running sum of fh in a register.
//
// The sum is deterministic: each thread adds its elements in a fixed
// order, in float64; a block reduces its threads' sums in a fixed tree
// (warp shuffles, then one warp over the warps) into its partial; a second
// launch of one block sums the partials in a fixed order and writes f in
// the storage type.  No atomics, so two calls on the same inputs give the
// same bits (the L-BFGS-B line search and its stop tests branch on f).
//
// Several problems in one launch (fit_multistart's starts): grid.y is the
// start s, which takes M, Y and its partials at offset s n (s blocks) and X
// at s x_stride (0 where the starts share X).  Each start's blocks walk
// its elements exactly as a launch of that start alone does, and the
// second launch has one block a start, so every start's f and Y carry the
// bits of its own single-start launch.
//
// Arithmetic: each elementwise result is that of the plain version
// (ops/losses.loss_fg_reference, one torch operation at a time): every
// product, sum and quotient is an _rn intrinsic in the storage type, in the
// plain version's order, so nvcc contracts nothing into a fused
// multiply-add; log, pow, sqrt and rsqrt are the device functions torch's
// own kernels call, and a power takes the shortcuts torch.pow takes for a
// scalar exponent (0, 1, 0.5, 2, 3, -0.5, -1, -2).  Only f's summation
// order differs from torch.sum.

#include <cuda_runtime.h>

namespace {

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

int pow_code(double e) {
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

}  // namespace

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
