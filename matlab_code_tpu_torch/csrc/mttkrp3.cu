// Dense 3-way MTTKRP for Hopper (sm_90a), modes 0, 1 and 2.
//
//   mode 0: out[i,r] = sum_{j,k} X[i,j,k] B[j,r] C[k,r]
//   mode 1: out[j,r] = sum_{i,k} X[i,j,k] A[i,r] C[k,r]
//   mode 2: out[k,r] = sum_{i,j} X[i,j,k] A[i,r] B[j,r]
//
// Replaces matlab_code_tpu/ops/mttkrp_pallas.py::mttkrp3_mode0 (the Pallas
// kernel for mode 0) and extends it to modes 1 and 2, which the AO sweep
// also runs.  X is row-major (I, J, K) and contiguous; factors are
// row-major (n, R) and contiguous.  X is float32, float64, float16 or
// bfloat16 (TX); the factors, the accumulators and the output are T, the
// promotion of TX with float32, as in the Pallas kernel: a 16-bit X is
// widened to float32 as it is loaded.
//
// What bounds it: about 2R flops per element of X (8-15 flop/byte at
// R = 16-20 in float32), far below the card's float32 ridge, so the roof is
// X's bytes over HBM bandwidth.  The design therefore reads X exactly once,
// coalesced along the contiguous k axis, and keeps everything else in
// registers and shared memory.  R is padded to RM in {8, 16, 24, 32} in
// registers and shared memory; ragged edges are masked (any I, J, K >= 1,
// 1 <= R <= 32).  No atomics: split partials are summed by a second pass
// (reduce_splits) in a fixed order, so repeated calls give the same bits.
// The TPU kernel carried out[i] across its sequential j axis; blocks here
// run in no order.
//
// Modes 0 and 1 (mttkrp3_rows): a block owns one output row o and a split
// of the walked axis (j for mode 0, i for mode 1).  Every thread owns one k
// (a warp's loads of X are one line) and walks rows of X against the
// walked factor's rows, held in shared memory and read as 16-byte
// broadcasts; then it scales by C[k, :] and the block reduces over k.
//
// Mode 2 (mttkrp3_mode2_stream) is a split-K product: X is the (I*J) x K
// row-major matrix it already is, and out = X^T KR with KR row s = (i, j)
// equal to A[i, :] * B[j, :].
// * A persistent grid of about one block an SM: block (b, t) owns a
//   contiguous run of stages (stage_rows rows each) of the I*J rows and k
//   tile t (k is tiled only where the block's threads cannot hold all of
//   K).  Consecutive rows are one contiguous slab of X.
// * One producer warp streams the block's stages through a ring of
//   `stages` slots in shared memory (the plan takes 4): X's slab, the
//   stage's A rows (one per i value) and its B rows (one run of j per i
//   value).  Where every row starts on 16 bytes the copies are TMA bulk
//   copies (cp.async.bulk) issued by one lane; otherwise its 32 lanes issue
//   16-, 8- or 4-byte cp.async, or, where a 16-bit X is only 2-byte
//   aligned, plain loads and stores (the plan chooses from the shape and
//   the pointers).  A slot's "full" mbarrier completes when its bytes have
//   landed, its "empty" mbarrier when every consumer warp is done with it,
//   so copies are issued as soon as a slot frees, with no block-wide
//   barrier in the loop.  Bulk copies and not 16-byte cp.async for the
//   aligned case, and 4 slots of at most 32 KB of X: the choice against 3,
//   6 and 8 slots, 16 KB stages and 16-byte cp.async is timed by
//   chip_smoke.py phase 2 ("design probe"), and PERF.md keeps the times.
// * The KR rows are formed in shared memory, never in HBM: each consumer
//   warp multiplies the A and B rows of the rows it takes into its own
//   rows of shared memory.  i and j are taken per row, so a block and a
//   stage may start mid-i.
// * A consumer thread owns KPT consecutive k and all RM columns in
//   registers; per row it reads KPT values of X (one read of KPT elements)
//   and the KR row as 16-byte broadcasts.  Where K is small the block's
//   threads split the rows into phases (thread phase p takes rows p,
//   p + phases, ... of each stage), reduced in shared memory in phase
//   order at the end.
// * Each block writes one K-tile x R partial (~132 partials, 4-6 % of X's
//   bytes at the flagship shapes); reduce_splits sums them.
// mttkrp3_mode2 is the earlier mode-2 kernel (a block owns a tile of k and
// splits of i and j), float32 and float64 only, kept for comparison and
// reached only through mttkrp3_split_run.
//
// The launch plans are computed by the Python wrapper,
// matlab_code_tpu_torch/ops/mttkrp_cuda.py (plan_mttkrp3).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// a 16-bit element of X, given as its bits, widened to float32
template <typename TX> __device__ __forceinline__ float widen(unsigned short b);
template <> __device__ __forceinline__ float widen<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// one element of X from global memory, in the accumulator type T
template <typename TX, typename T>
__device__ __forceinline__ T load_x(const TX* p) {
  if constexpr (sizeof(TX) == 2) {
    return widen<TX>(__ldg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return __ldg(p);
  }
}

// acc[r] += sum over s = first, first + step, ... < n of xp[s * stride] * tile[s * RM + r]
template <typename TX, typename T, int RM>
__device__ __forceinline__ void fiber_dot(T (&acc)[RM], const TX* __restrict__ xp,
                                          long long stride, int first, int n,
                                          int step, const T* tile) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
#pragma unroll 4
  for (int s = first; s < n; s += step) {
    const T x = load_x<TX, T>(xp + s * stride);
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

template <typename TX, typename T, int RM>
__global__ void __launch_bounds__(kRowsThreads)
mttkrp3_rows(const TX* __restrict__ X, const T* __restrict__ S,
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
  const TX* xo = X + o * stride_o + s0 * stride_s;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    T acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = T(0);
    fiber_dot<TX, T, RM>(acc, xo + k, stride_s, threadIdx.y, ns, blockDim.y, tile);
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
    fiber_dot<T, T, RM>(acc, X + ((long long)i * J + j0) * K + k, K, 0, nj, 1, tile);
#pragma unroll
    for (int r = 0; r < RM; ++r)
      res[r] += acc[r] * (r < R ? __ldg(A + (long long)i * R + r) : T(0));
  }
  T* dst = out + ((long long)(isplit * n_jsplit + jsplit) * K + k) * R;
#pragma unroll
  for (int r = 0; r < RM; ++r)
    if (r < R) dst[r] = res[r];
}

// out[idx] = sum over s < nsplit of part[s * n + idx], in a fixed order:
// warp w of block b sums splits w, w + 8, ... of outputs 32b .. 32b + 31,
// then the block adds the 8 warp sums in warp order.  Eight warps an
// output column keep many loads in flight where there are few outputs and
// many splits (mode 2's K * R outputs from ~132 partials).
template <typename T>
__global__ void __launch_bounds__(256)
reduce_splits(const T* __restrict__ part, T* __restrict__ out, long long n,
              int nsplit) {
  __shared__ T red[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long idx = blockIdx.x * 32LL + lane;
  T v = T(0);
  if (idx < n) {
#pragma unroll 4
    for (int s = warp; s < nsplit; s += 8) v += __ldg(part + s * n + idx);
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && idx < n) {
    T t = red[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += red[w][lane];
    out[idx] = t;
  }
}

template <typename T>
cudaError_t launch_reduce(const T* part, T* out, long long n, int nsplit,
                          cudaStream_t stream) {
  reduce_splits<T><<<(unsigned)((n + 31) / 32), 256, 0, stream>>>(part, out, n,
                                                                   nsplit);
  return cudaGetLastError();
}

constexpr int kStreamThreads = 256;  // consumer threads of a block at most
constexpr int kPlainCopy = 1;        // `copy` of plain loads and stores

// KPT consecutive elements of X from shared memory in one read, in T
template <typename TX, typename T, int KPT>
__device__ __forceinline__ void load_k(T (&x)[KPT], const TX* p) {
  if constexpr (sizeof(TX) == 2) {
    using Bits = std::conditional_t<KPT == 4, uint2,
                                    std::conditional_t<KPT == 2, unsigned, unsigned short>>;
    union { Bits b; unsigned short h[KPT]; } u;
    u.b = *reinterpret_cast<const Bits*>(p);
#pragma unroll
    for (int q = 0; q < KPT; ++q) x[q] = widen<TX>(u.h[q]);
  } else if constexpr (KPT == 1) {
    x[0] = *p;
  } else {
    using V = std::conditional_t<std::is_same_v<T, double>, double2,
                                 std::conditional_t<KPT == 2, float2, float4>>;
    const V v = *reinterpret_cast<const V*>(p);
    if constexpr (KPT == 2) {
      x[0] = v.x; x[1] = v.y;
    } else {
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    }
  }
}

template <typename T, int KPT>
__device__ __forceinline__ void store_k(T* p, const T (&x)[KPT]) {
  if constexpr (KPT == 1) {
    *p = x[0];
  } else {
    using V = std::conditional_t<std::is_same_v<T, double>, double2,
                                 std::conditional_t<KPT == 2, float2, float4>>;
    V v;
    if constexpr (KPT == 2) {
      v.x = x[0]; v.y = x[1];
    } else {
      v.x = x[0]; v.y = x[1]; v.z = x[2]; v.w = x[3];
    }
    *reinterpret_cast<V*>(p) = v;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(smem_u32(dst)), "l"(src), "n"(W) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarriers of the ring's slots: "full" completes when a stage's copies
// have landed, "empty" when its consumers are done with it
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// The producer warp's copies of n contiguous elements from src to dst:
// cp.async of W (16, 8 or 4) bytes by its lanes, one bulk copy by lane 0
// (w == 0), or plain loads and stores by its lanes (w == kPlainCopy).
template <typename E, int W>
__device__ __forceinline__ void copy_flat_w(E* dst, const E* __restrict__ src,
                                            int n, int lane) {
  constexpr int C = W / (int)sizeof(E);
  for (int c = lane; c < n / C; c += 32)
    cp_async<W>(dst + c * C, src + (long long)c * C);
}

template <typename E>
__device__ __forceinline__ void copy_flat(int w, E* dst,
                                          const E* __restrict__ src, int n,
                                          int lane, unsigned long long* bar) {
  if (w == 0) {
    if (lane == 0) bulk_copy(dst, src, (unsigned)(n * sizeof(E)), bar);
  } else if (w == 16) {
    copy_flat_w<E, 16>(dst, src, n, lane);
  } else if (w == 8) {
    copy_flat_w<E, 8>(dst, src, n, lane);
  } else if (w == 4) {
    if constexpr (sizeof(E) <= 4) copy_flat_w<E, 4>(dst, src, n, lane);
  } else {
    for (int c = lane; c < n; c += 32) dst[c] = src[c];
  }
}

// Shared memory of the stream kernel, in bytes from the start: the ring of
// X (TX), the ring of A/B rows and each consumer warp's KR rows (T), then
// the full and empty mbarriers of the slots past the larger of those and
// the phase sums (which reuse the start at the end).
struct StreamSmem {
  size_t ab, kw, bars;
  __device__ StreamSmem(int stages, int stage_rows, int tk, int rm,
                        int nphase, int nwarps, int R, int xsize, int tsize) {
    const size_t ring =
        ((size_t)stages * stage_rows * tk * xsize + 15) & ~(size_t)15;
    ab = ring;
    kw = ab + (size_t)stages * (2 * stage_rows + 1) * rm * tsize;
    const int rows_w = (stage_rows + nphase - 1) / nphase;
    const size_t body = kw + (size_t)nwarps * rows_w * rm * tsize;
    const size_t red = (size_t)nphase * R * (tk + 16 / tsize) * tsize;
    bars = ((body > red ? body : red) + 15) & ~(size_t)15;
  }
};

template <typename TX, typename T, int RM, int KPT>
__global__ void __launch_bounds__(kStreamThreads + 32, 1)
mttkrp3_mode2_stream(const TX* __restrict__ X, const T* __restrict__ A,
                     const T* __restrict__ B, T* __restrict__ out, int I,
                     int J, int K, int R, int tk, int kthreads, int spb,
                     int stage_rows, int stages, int copy, int abw) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nconsumer = blockDim.x - 32;   // the last warp is the producer
  const int nphase = nconsumer / kthreads;
  const int lane = threadIdx.x & 31;
  const StreamSmem lay(stages, stage_rows, tk, RM, nphase, nconsumer / 32, R,
                       (int)sizeof(TX), (int)sizeof(T));
  TX* ring = reinterpret_cast<TX*>(smem_raw);
  T* ab = reinterpret_cast<T*>(smem_raw + lay.ab);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem_raw + lay.bars);
  unsigned long long* empty = full + stages;
  const int stage_elems = stage_rows * tk;
  const int ab_elems = (2 * stage_rows + 1) * RM;   // A rows, then B rows

  // block b takes stages b * spb .. (b + 1) * spb - 1 of stage_rows rows
  const long long S = (long long)I * J;
  const long long G = (S + stage_rows - 1) / stage_rows;
  const long long s_first = (long long)blockIdx.x * spb;
  const int nstage = (int)max(0LL, min((long long)spb, G - s_first));
  const int k0 = blockIdx.y * tk;
  const int cols = min(tk, K - k0);

  if (threadIdx.x == 0) {
    for (int q = 0; q < stages; ++q) {
      mbar_init(full + q, 33);              // 32 producer lanes + expect_tx
      mbar_init(empty + q, nconsumer / 32);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= nconsumer) {
    // producer: fills slot st % stages with stage st once its consumers are
    // done with stage st - stages: X rows, the A rows of the stage's i
    // values, and its B rows, one segment a run of j that does not wrap
    int slot = 0;
    unsigned parity = 1;   // the empty barriers' phase to wait for, once
    for (int st = 0; st < nstage; ++st) {
      if (st >= stages) mbar_wait(empty + slot, parity);
      const long long r0 = (s_first + st) * stage_rows;
      const int nr = (int)min((long long)stage_rows, S - r0);
      const long long i0 = r0 / J;
      const int j0 = (int)(r0 - i0 * J);
      const int ni = (j0 + nr - 1) / J + 1;
      unsigned long long* bar = full + slot;
      if (lane == 0) {
        unsigned tx = 0;
        if (copy == 0) tx += (unsigned)(nr * cols * sizeof(TX));
        if (abw == 0) tx += (unsigned)((ni + nr) * R * sizeof(T));
        mbar_expect_tx(bar, tx);
      }
      TX* dst = ring + slot * stage_elems;
      if (cols == K) {
        copy_flat<TX>(copy, dst, X + r0 * K, nr * K, lane, bar);
      } else {
        for (int row = 0; row < nr; ++row)
          copy_flat<TX>(copy, dst + row * cols, X + (r0 + row) * K + k0, cols,
                        lane, bar);
      }
      T* a = ab + slot * ab_elems;
      T* bs = a + (stage_rows + 1) * RM;
      copy_flat<T>(abw, a, A + i0 * R, ni * R, lane, bar);
      for (int row = 0, j = j0; row < nr; j = 0) {
        const int n = min(nr - row, J - j);
        copy_flat<T>(abw, bs + row * R, B + (long long)j * R, n * R, lane, bar);
        row += n;
      }
      if (copy == kPlainCopy) {
        // this lane's stores, and its cp.async of A and B rows, are done
        cp_async_wait_all();
        mbar_arrive(bar);
      } else {
        cp_async_arrive(bar);
      }
      if (++slot == stages) {
        slot = 0;
        parity ^= 1u;
      }
    }
  }

  // consumers: thread (phase, kt) owns k = k0 + kt * KPT .. + KPT - 1 and
  // takes rows phase, phase + nphase, ... of every stage; each warp forms
  // the KR rows it takes in its own shared-memory rows
  const int kt = threadIdx.x % kthreads;
  const int phase = threadIdx.x / kthreads;
  const int kk = kt * KPT;
  const bool active = threadIdx.x < nconsumer && kk < cols;
  T acc[KPT][RM];
#pragma unroll
  for (int p = 0; p < KPT; ++p)
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[p][r] = T(0);
  if (threadIdx.x < nconsumer) {
    const int rows_w = (stage_rows + nphase - 1) / nphase;
    T* kw = reinterpret_cast<T*>(smem_raw + lay.kw) +
            (threadIdx.x >> 5) * rows_w * RM;
    int slot = 0;
    unsigned parity = 0;   // the full barriers' phase to wait for
    for (int st = 0; st < nstage; ++st) {
      const long long r0 = (s_first + st) * stage_rows;
      const int nr = (int)min((long long)stage_rows, S - r0);
      const int j0 = (int)(r0 - (r0 / J) * J);
      const int mine = nr > phase ? (nr - phase + nphase - 1) / nphase : 0;
      mbar_wait(full + slot, parity);
      const T* a = ab + slot * ab_elems;
      const T* bs = a + (stage_rows + 1) * RM;
      for (int e = lane; e < mine * RM; e += 32) {
        const int m = e / RM;
        const int r = e - m * RM;
        const int row = phase + m * nphase;
        T v = T(0);
        if (r < R) {
          const int q = j0 + row < J ? 0 : (j0 + row) / J;
          v = a[q * R + r] * bs[row * R + r];
        }
        kw[e] = v;
      }
      __syncwarp();
      if (active) {
        const TX* xs = ring + slot * stage_elems + kk;
#pragma unroll 2
        for (int m = 0; m < mine; ++m) {
          T x[KPT];
          load_k<TX, T, KPT>(x, xs + (phase + m * nphase) * cols);
          const VT* kv = reinterpret_cast<const VT*>(kw + m * RM);
#pragma unroll
          for (int q = 0; q < RM / VN; ++q) {
            const VT v = kv[q];
#pragma unroll
            for (int p = 0; p < KPT; ++p) fma_vec(acc[p] + q * VN, x[p], v);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      if (++slot == stages) {
        slot = 0;
        parity ^= 1u;
      }
    }
  }
  __syncthreads();   // every stage consumed: the ring is free

  // phase sums in phase order; red[(phase * R + r) * pitch + k], the pitch
  // padded by 16 bytes against bank conflicts on the reads below
  T* red = reinterpret_cast<T*>(smem_raw);
  const int pitch = cols + 16 / (int)sizeof(T);
  if (active) {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      if (r < R) {
        T v[KPT];
#pragma unroll
        for (int p = 0; p < KPT; ++p) v[p] = acc[p][r];
        store_k<T, KPT>(red + (phase * R + r) * pitch + kk, v);
      }
    }
  }
  __syncthreads();
  T* dst = out + ((long long)blockIdx.x * K + k0) * R;
  for (int e = threadIdx.x; e < cols * R; e += blockDim.x) {
    const int k = e / R;
    const int r = e - k * R;
    T v = red[r * pitch + k];
    for (int ph = 1; ph < nphase; ++ph) v += red[(ph * R + r) * pitch + k];
    dst[e] = v;
  }
}

struct StreamArgs {
  int I, J, K, R, tk, kthreads, phases, nsplit, ktiles, spb, stage_rows,
      stages, copy, abw, smem;
};

template <typename TX, typename T, int RM, int KPT>
cudaError_t launch_stream(const TX* X, const T* A, const T* B, T* part, T* out,
                          const StreamArgs& g, cudaStream_t stream) {
  auto kern = mttkrp3_mode2_stream<TX, T, RM, KPT>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  T* dst = g.nsplit > 1 ? part : out;
  kern<<<dim3(g.nsplit, g.ktiles), g.kthreads * g.phases + 32, g.smem, stream>>>(
      X, A, B, dst, g.I, g.J, g.K, g.R, g.tk, g.kthreads, g.spb, g.stage_rows,
      g.stages, g.copy, g.abw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.nsplit == 1) return err;
  return launch_reduce<T>(part, out, (long long)g.K * g.R, g.nsplit, stream);
}

template <typename TX, typename T>
cudaError_t dispatch_stream(int rm, int kpt, const void* X, const void* A,
                            const void* B, void* part, void* out,
                            const StreamArgs& g, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(X);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* p = static_cast<T*>(part);
  T* o = static_cast<T*>(out);
#define MTTKRP3_STREAM(RM_, KPT_)                                              \
  if (rm == RM_ && kpt == KPT_)                                                \
    return launch_stream<TX, T, RM_, KPT_>(x, a, b, p, o, g, stream);
  // the (RM, KPT) the plan can pick: KPT * RM * sizeof(T) <= 256 bytes
  MTTKRP3_STREAM(8, 1) MTTKRP3_STREAM(16, 1) MTTKRP3_STREAM(24, 1) MTTKRP3_STREAM(32, 1)
  MTTKRP3_STREAM(8, 2) MTTKRP3_STREAM(16, 2)
  if constexpr (sizeof(T) == 4) {
    MTTKRP3_STREAM(24, 2) MTTKRP3_STREAM(32, 2)
    MTTKRP3_STREAM(8, 4) MTTKRP3_STREAM(16, 4)
  }
#undef MTTKRP3_STREAM
  return cudaErrorInvalidValue;
}

template <typename TX, typename T, int RM>
cudaError_t launch_rows(int mode, const TX* X, const T* F0, const T* F1,
                        T* part, T* out, int I, int J, int K, int R, int tk,
                        int ns, int per, cudaStream_t stream) {
  T* dst = ns > 1 ? part : out;
  const int O = mode == 0 ? I : J;
  const int Sn = mode == 0 ? J : I;
  const long long stride_o = mode == 0 ? (long long)J * K : K;
  const long long stride_s = mode == 0 ? K : (long long)J * K;
  const dim3 block(tk, kRowsThreads / tk);
  const dim3 grid(O, ns);
  const size_t smem = ((size_t)per * RM + (kRowsThreads / 32) * RM) * sizeof(T);
  mttkrp3_rows<TX, T, RM><<<grid, block, smem, stream>>>(
      X, F0, F1, dst, O, Sn, K, R, stride_o, stride_s, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ns == 1) return err;
  return launch_reduce<T>(part, out, (long long)O * R, ns, stream);
}

template <typename TX, typename T>
cudaError_t dispatch_rows(int rm, int mode, const void* X, const void* F0,
                          const void* F1, void* part, void* out, int I, int J,
                          int K, int R, int tk, int ns, int per,
                          cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(X);
  const T* f0 = static_cast<const T*>(F0);
  const T* f1 = static_cast<const T*>(F1);
  T* p = static_cast<T*>(part);
  T* o = static_cast<T*>(out);
  switch (rm) {
    case 8: return launch_rows<TX, T, 8>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns, per, stream);
    case 16: return launch_rows<TX, T, 16>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns, per, stream);
    case 24: return launch_rows<TX, T, 24>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns, per, stream);
    case 32: return launch_rows<TX, T, 32>(mode, x, f0, f1, p, o, I, J, K, R, tk, ns, per, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int RM>
cudaError_t launch_split(const T* X, const T* A, const T* B, T* part, T* out,
                         int I, int J, int K, int R, int tk, int ns_a,
                         int ns_b, int per_a, int per_b, cudaStream_t stream) {
  const int nsplit = ns_a * ns_b;
  T* dst = nsplit > 1 ? part : out;
  const dim3 grid((K + tk - 1) / tk, ns_b, ns_a);
  const size_t smem = (size_t)per_b * RM * sizeof(T);
  mttkrp3_mode2<T, RM><<<grid, tk, smem, stream>>>(X, A, B, dst, I, J, K, R,
                                                   per_a, per_b, ns_b);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_reduce<T>(part, out, (long long)K * R, nsplit, stream);
}

template <typename T>
cudaError_t dispatch_split(int rm, const void* X, const void* A, const void* B,
                           void* part, void* out, int I, int J, int K, int R,
                           int tk, int ns_a, int ns_b, int per_a, int per_b,
                           cudaStream_t stream) {
  const T* x = static_cast<const T*>(X);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  T* p = static_cast<T*>(part);
  T* o = static_cast<T*>(out);
  switch (rm) {
    case 8: return launch_split<T, 8>(x, a, b, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 16: return launch_split<T, 16>(x, a, b, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 24: return launch_split<T, 24>(x, a, b, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    case 32: return launch_split<T, 32>(x, a, b, p, o, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes of X (the wrapper's DTYPE_CODES): 0 float32, 1 float64,
// 2 float16, 3 bfloat16; T is float64 for 1, float32 otherwise
enum XDtype { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

}  // namespace

// C entries for ctypes.  Each returns cudaGetLastError() after its
// launches; part holds the split partials when there is more than one.
//
// Modes 0/1 (plan_mttkrp3's Plan): F0 is the walked factor (B for mode 0,
// A for mode 1) and F1 = C; ns/per are the splits of the walked axis.
extern "C" int mttkrp3_run(int dtype, int rm, int mode, const void* X,
                           const void* F0, const void* F1, void* part,
                           void* out, int I, int J, int K, int R, int tk,
                           int ns, int per, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)dispatch_rows<float, float>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns, per, st);
    case kF64: return (int)dispatch_rows<double, double>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns, per, st);
    case kF16: return (int)dispatch_rows<__half, float>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns, per, st);
    case kBF16: return (int)dispatch_rows<__nv_bfloat16, float>(rm, mode, X, F0, F1, part, out, I, J, K, R, tk, ns, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Mode 2, the stream kernel (plan_mttkrp3's StreamPlan).
extern "C" int mttkrp3_stream_run(int dtype, int rm, int kpt, const void* X,
                                  const void* A, const void* B, void* part,
                                  void* out, int I, int J, int K, int R,
                                  int tk, int kthreads, int phases,
                                  int nsplit, int ktiles, int spb,
                                  int stage_rows, int stages, int copy,
                                  int abw, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StreamArgs g{I, J, K, R, tk, kthreads, phases, nsplit, ktiles, spb,
                     stage_rows, stages, copy, abw, smem};
  switch (dtype) {
    case kF32: return (int)dispatch_stream<float, float>(rm, kpt, X, A, B, part, out, g, st);
    case kF64: return (int)dispatch_stream<double, double>(rm, kpt, X, A, B, part, out, g, st);
    case kF16: return (int)dispatch_stream<__half, float>(rm, kpt, X, A, B, part, out, g, st);
    case kBF16: return (int)dispatch_stream<__nv_bfloat16, float>(rm, kpt, X, A, B, part, out, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Mode 2, the earlier kernel (the wrapper's _plan_split), float32 (0) and
// float64 (1) only: ns_a/per_a split i and ns_b/per_b split j.
extern "C" int mttkrp3_split_run(int dtype, int rm, const void* X,
                                 const void* A, const void* B, void* part,
                                 void* out, int I, int J, int K, int R, int tk,
                                 int ns_a, int ns_b, int per_a, int per_b,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)dispatch_split<float>(rm, X, A, B, part, out, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, st);
    case kF64: return (int)dispatch_split<double>(rm, X, A, B, part, out, I, J, K, R, tk, ns_a, ns_b, per_a, per_b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
