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
// widened to float32 as it is read.
//
// What bounds it: about 2R flops per element of X (8-15 flop/byte at
// R = 16-20 in float32), far below the card's float32 ridge, so the roof is
// X's bytes over HBM bandwidth.  Both kernels therefore read X exactly once,
// as the contiguous runs it holds, through a ring of asynchronous copies,
// and keep everything else in registers and shared memory.  R is padded to
// RM in {8, 16, 24, 32} in registers and shared memory; ragged edges are
// masked (any I, J, K >= 1, 1 <= R <= 32).  No atomics: split partials are
// summed by a second pass (reduce_splits) in a fixed order, so repeated
// calls give the same bits.  The TPU kernel carried out[i] across its
// sequential j axis; blocks here run in no order.
//
// The ring, shared by both kernels:
// * A persistent grid of about one block an SM.  One producer warp streams
//   the block's stages through a ring of `stages` slots in shared memory
//   (the plans take 4).  Where every row starts on 16 bytes the copies are
//   TMA bulk copies (cp.async.bulk); otherwise modes 0/1 copy each run as
//   one bulk copy of its 16-byte-aligned envelope in X and read the run at
//   its offset in it (the "envelope route", where k is not tiled), and
//   else the 32 lanes issue 16-, 8- or 4-byte cp.async, or, where a 16-bit
//   X is only 2-byte aligned, plain loads and stores (the plan chooses from
//   the shape and the pointers).  A slot's "full" mbarrier completes when
//   its bytes have landed, its "empty" mbarrier when every consumer warp is
//   done with it, so copies are issued as soon as a slot frees, with no
//   block-wide barrier in the loop.  The envelope route reads at most 15
//   bytes on either side of a run, within the 16 bytes that hold its ends.  Bulk copies and 4 slots of at most 32 KB of X:
//   the choice against other slot counts, stage sizes and 16-byte cp.async
//   is timed by chip_smoke.py phase 2 ("design probe"), and PERF.md keeps
//   the times.
// * A consumer thread owns KPT consecutive k (1, 2 or 4) and all RM
//   columns, KPT * RM accumulators of at most 64 registers; it reads KPT
//   values of X in one read and a factor row as 16-byte broadcasts.
//
// Modes 0 and 1 (mttkrp3_rows_stream) contract the walked axis first, in
// registers, and apply C once, at the end of a block's work.  Call the
// output axis o and the walked axis s (mode 0: o = i, s = j, F = B; mode 1:
// o = j, s = i, F = A).
// * A unit of work is a tile of `ob` consecutive output rows, one range of
//   walked rows and one k tile.  Block (b, t) of an (nblk, ktiles) grid
//   takes units b, b + nblk, ... of k tile t in turn (blocks at work
//   together read neighbouring tiles); its ring streams on across the
//   units, so one unit's epilogue overlaps the next one's copies.  Where
//   there are fewer o tiles than SMs, the walked axis is split into ranges
//   and reduce_splits sums their partials.
// * A stage holds stage_rows walked rows of the tile: in mode 1 one run
//   X[s, o0:o0+ob, :] of ob * K elements a walked row, in mode 0 one run
//   X[o, s0:s0+n, :] of n * K elements an output row (each run padded by 16
//   bytes against bank conflicts), and the stage's F rows at pitch RM.
//   The runs' bulk copies are issued by the producer's lanes in parallel:
//   issued by one lane in turn, a stage of many short runs (mode 1 at
//   small ob * K) held the kernel back (PERF.md keeps the times).
// * Consumer thread (o, kt) owns output row o of the tile and k = kt * KPT
//   .. + KPT - 1; per walked row s it adds X[o, s, k] * F[s, :] to its
//   accumulators, the F row a broadcast shared by the tile's rows.  At the
//   end of a unit it multiplies by C[k, :] (the block's k tile of C, staged
//   once in shared memory) and the threads of o sum over k in a fixed
//   order: a shuffle butterfly within the warp, then warp sums in warp
//   order.
//
// Mode 2 (mttkrp3_mode2_stream) is a split-K product: X is the (I*J) x K
// row-major matrix it already is, and out = X^T KR with KR row s = (i, j)
// equal to A[i, :] * B[j, :].
// * Block (b, t) owns a contiguous run of stages (stage_rows rows each) of
//   the I*J rows and k tile t (k is tiled only where the block's threads
//   cannot hold all of K).  Consecutive rows are one contiguous slab of X.
//   A stage holds X's slab, the stage's A rows (one per i value) and its B
//   rows (one run of j per i value).
// * The KR rows are formed in shared memory, never in HBM: each consumer
//   warp multiplies the A and B rows of the rows it takes into its own
//   rows of shared memory.  i and j are taken per row, so a block and a
//   stage may start mid-i.
// * Where K is small the block's threads split the rows into phases
//   (thread phase p takes rows p, p + phases, ... of each stage), reduced
//   in shared memory in phase order at the end.
// * Each block writes one K-tile x R partial (~132 partials, 4-6 % of X's
//   bytes at the flagship shapes); reduce_splits sums them.
//
// The launch plans are computed by the Python wrapper,
// matlab_code_tpu_torch/ops/mttkrp_cuda.py (plan_mttkrp3).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

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
constexpr int kEnvelope = 2;         // `copy` of bulk copies of each run's
                                     // 16-byte-aligned envelope

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

// the same from an address aligned to one element only
template <typename TX, typename T, int KPT>
__device__ __forceinline__ void load_k_each(T (&x)[KPT], const TX* p) {
#pragma unroll
  for (int q = 0; q < KPT; ++q) {
    if constexpr (sizeof(TX) == 2) {
      x[q] = widen<TX>(*reinterpret_cast<const unsigned short*>(p + q));
    } else {
      x[q] = p[q];
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

// Waits for phase `parity` of bar to complete.  A fault in a ring's
// protocol would otherwise hang the card: past 2^34 cycles (about 10 s) of
// waiting the kernel traps, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  long long t0 = -1;
  while (true) {
    unsigned done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 < 0) {
      t0 = t;
    } else if (t - t0 > (1LL << 34)) {
      __trap();
    }
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

// Lane `lane`'s chunks of n rows of `per` chunks, chunk c = lane, lane +
// 32, ... as (row, q): stepped by 32 chunks without a division a chunk.
template <typename Fn>
__device__ __forceinline__ void for_lane_chunks(int n, int per, int lane,
                                                Fn&& f) {
  const int drow = 32 / per;
  const int dq = 32 - drow * per;
  int row = lane / per;
  int q = lane - row * per;
  while (row < n) {
    f(row, q);
    row += drow;
    q += dq;
    if (q >= per) {
      q -= per;
      ++row;
    }
  }
}

template <typename E, int W>
__device__ __forceinline__ void copy_short_rows(E* dst, int dpitch,
                                                const E* __restrict__ src,
                                                long long spitch, int n,
                                                int len, int lane) {
  constexpr int C = W / (int)sizeof(E);
  for_lane_chunks(n, len / C, lane, [&](int row, int q) {
    cp_async<W>(dst + row * dpitch + q * C, src + row * spitch + q * C);
  });
}

// The producer warp's copies of n rows of len elements, src rows spitch
// and dst rows dpitch elements apart: one flat copy where they are
// contiguous; else one bulk copy a row, the rows spread over the lanes
// (w == 0); else copy_flat a row, or, where a row has fewer chunks of w
// bytes than the warp has lanes, the lanes' chunks spread over every row.
template <typename E>
__device__ __forceinline__ void copy_rows(int w, E* dst, int dpitch,
                                          const E* __restrict__ src,
                                          long long spitch, int n, int len,
                                          int lane, unsigned long long* bar) {
  if (dpitch == len && spitch == len) {
    copy_flat<E>(w, dst, src, n * len, lane, bar);
  } else if (w == 0) {
    for (int row = lane; row < n; row += 32)
      bulk_copy(dst + row * dpitch, src + row * spitch,
                (unsigned)(len * sizeof(E)), bar);
  } else if (len * (int)sizeof(E) >=
             32 * (w == kPlainCopy ? (int)sizeof(E) : w)) {
    for (int row = 0; row < n; ++row)
      copy_flat<E>(w, dst + row * dpitch, src + row * spitch, len, lane, bar);
  } else if (w == 16) {
    copy_short_rows<E, 16>(dst, dpitch, src, spitch, n, len, lane);
  } else if (w == 8) {
    copy_short_rows<E, 8>(dst, dpitch, src, spitch, n, len, lane);
  } else if (w == 4) {
    if constexpr (sizeof(E) <= 4)
      copy_short_rows<E, 4>(dst, dpitch, src, spitch, n, len, lane);
  } else {
    for_lane_chunks(n, len, lane, [&](int row, int q) {
      dst[row * dpitch + q] = src[row * spitch + q];
    });
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
      __syncwarp();   // the bytes are expected before any lane's copy
      copy_rows<TX>(copy, ring + slot * stage_elems, cols, X + r0 * K + k0, K,
                    nr, cols, lane, bar);
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

// acc[r] += a[r] * v[r] over one vector of columns
__device__ __forceinline__ void fma_vec(float* acc, const float* a, float4 v) {
  acc[0] = fmaf(a[0], v.x, acc[0]);
  acc[1] = fmaf(a[1], v.y, acc[1]);
  acc[2] = fmaf(a[2], v.z, acc[2]);
  acc[3] = fmaf(a[3], v.w, acc[3]);
}

__device__ __forceinline__ void fma_vec(double* acc, const double* a,
                                        double2 v) {
  acc[0] = fma(a[0], v.x, acc[0]);
  acc[1] = fma(a[1], v.y, acc[1]);
}

// a barrier of the consumer warps alone (the producer warp runs on)
__device__ __forceinline__ void consumer_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(nthreads) : "memory");
}

// Shared memory of the rows-stream kernel, in bytes from the start: the
// ring of X (TX, xstage elements a slot), the ring of F rows and the
// block's C tile, both at pitch RM (T), a sum a consumer warp, then the
// full and empty mbarriers of the slots.
struct RowsSmem {
  size_t f, c, red, bars;
  __device__ RowsSmem(int stages, int xstage, int stage_rows, int tk, int rm,
                      int nwarps, int xsize, int tsize) {
    f = ((size_t)stages * xstage * xsize + 15) & ~(size_t)15;
    c = f + (size_t)stages * stage_rows * rm * tsize;
    red = c + (size_t)tk * rm * tsize;
    bars = (red + (size_t)nwarps * rm * tsize + 15) & ~(size_t)15;
  }
};

// A consumer thread's walk over one stage: acc[p][:] += X[o, s, k + p] *
// F[s, :] for its o and k, the stage's walked row s at xs + s * ss.  With
// SHIFT (the envelope route) row s lies (e0 + s * de) % 16 bytes into
// its 16-byte-aligned place, and is read an element at a time where that
// offset breaks the KPT-element read.
template <bool SHIFT, typename TX, typename T, int RM, int KPT>
__device__ __forceinline__ void walk_stage(T (&acc)[KPT][RM], const TX* xs,
                                           int ss, const T* fs, int n,
                                           unsigned e0, unsigned de) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
  const VT* fv = reinterpret_cast<const VT*>(fs);
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    T x[KPT];
    if constexpr (SHIFT) {
      const int e = (int)(((e0 + (unsigned)s * de) & 15u) / sizeof(TX));
      const TX* p = xs + s * ss + e;
      if (e % KPT == 0) {
        load_k<TX, T, KPT>(x, p);
      } else {
        load_k_each<TX, T, KPT>(x, p);
      }
    } else {
      load_k<TX, T, KPT>(x, xs + s * ss);
    }
#pragma unroll
    for (int c = 0; c < RM / VN; ++c) {
      const VT v = fv[s * (RM / VN) + c];
#pragma unroll
      for (int p = 0; p < KPT; ++p) fma_vec(acc[p] + c * VN, x[p], v);
    }
  }
}

template <typename TX, typename T, int RM, int KPT>
__global__ void __launch_bounds__(kStreamThreads + 32, 1)
mttkrp3_rows_stream(const TX* __restrict__ X, const T* __restrict__ F,
                    const T* __restrict__ C, T* __restrict__ out, int mode,
                    int I, int J, int K, int R, int ob, int kthreads, int tk,
                    int ns, int per, int stage_rows, int stages, int copy,
                    int fcopy) {
  using VT = typename Vec<T>::type;
  constexpr int VN = Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nconsumer = blockDim.x - 32;   // the last warp is the producer
  const int lane = threadIdx.x & 31;
  const int O = mode == 0 ? I : J;         // output rows
  const int Sn = mode == 0 ? J : I;        // walked rows
  // a slot of X: mode 0 [o][s][k], each o's rows padded by 16 bytes;
  // mode 1 [s][o][k]; k at pitch tk.  On the envelope route (one k tile)
  // a run is copied as its 16-byte-aligned envelope in X, the run at its
  // offset in it, and runs lie on 16 bytes, 16 bytes more apart.
  const bool env = copy == kEnvelope;
  constexpr int kPad = 16 / (int)sizeof(TX);   // 16 bytes of X
  const int opitch = env ? (stage_rows * tk + kPad - 1) / kPad * kPad + 2 * kPad
                         : stage_rows * tk + kPad;
  const int mpitch = env ? (ob * tk + kPad - 1) / kPad * kPad + kPad : ob * tk;
  const int xstage = mode == 0 ? ob * opitch : stage_rows * mpitch;
  const int drun = mode == 0 ? opitch : mpitch;   // runs apart in a slot
  const int fstage = stage_rows * RM;
  const RowsSmem lay(stages, xstage, stage_rows, tk, RM, nconsumer / 32,
                     (int)sizeof(TX), (int)sizeof(T));
  TX* ring = reinterpret_cast<TX*>(smem_raw);
  T* fring = reinterpret_cast<T*>(smem_raw + lay.f);
  T* ct = reinterpret_cast<T*>(smem_raw + lay.c);
  T* red = reinterpret_cast<T*>(smem_raw + lay.red);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem_raw + lay.bars);
  unsigned long long* empty = full + stages;

  // units blockIdx.x, blockIdx.x + gridDim.x, ... of k tile blockIdx.y;
  // unit u is walked range u / n_ot, o tile u % n_ot
  const int n_ot = (O + ob - 1) / ob;
  const int units = ns * n_ot;
  const int k0 = blockIdx.y * tk;
  const int cols = min(tk, K - k0);

  // the block's C tile, and the pad columns of the F ring, zero past R
  for (int e = threadIdx.x; e < cols * RM; e += blockDim.x) {
    const int k = e / RM;
    const int r = e - k * RM;
    ct[e] = r < R ? C[(long long)(k0 + k) * R + r] : T(0);
  }
  if (R < RM) {
    for (int e = threadIdx.x; e < stages * fstage; e += blockDim.x)
      if (e % RM >= R) fring[e] = T(0);
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < stages; ++q) {
      mbar_init(full + q, 33);              // 32 producer lanes + expect_tx
      mbar_init(empty + q, nconsumer / 32);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= nconsumer) {
    // producer: fills slot st % stages with the block's stage st once its
    // consumers are done with stage st - stages: the stage's runs of X
    // and its F rows
    int slot = 0;
    int st = 0;
    unsigned parity = 1;   // the empty barriers' phase to wait for, once
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int q = u / n_ot;
      const int o0 = (u - q * n_ot) * ob;
      const int no = min(ob, O - o0);
      const int s_end = min(Sn, (q + 1) * per);
      for (int s0 = q * per; s0 < s_end; s0 += stage_rows, ++st) {
        const int n = min(stage_rows, s_end - s0);
        if (st >= stages) mbar_wait(empty + slot, parity);
        unsigned long long* bar = full + slot;
        // one run an output row o, X[o, s0:s0+n, k0:k0+cols] (mode 0), or
        // a walked row s, X[s, o0:o0+no, k0:k0+cols] (mode 1); runs are
        // J*K elements apart in X, each `rows` rows of cols
        const int nrun = mode == 0 ? no : n;
        const int rows = mode == 0 ? n : no;
        const long long jk = (long long)J * K;
        const TX* src = X + (mode == 0 ? (long long)o0 * J + s0
                                       : (long long)s0 * J + o0) * K + k0;
        TX* dst = ring + slot * xstage;
        // the envelope route's bytes: a run's, from the 16 bytes it starts
        // in to the end of the 16 bytes it ends in
        const unsigned run_bytes = (unsigned)(rows * K * sizeof(TX));
        unsigned env_tx = 0;
        if (env) {
          for (int r = lane; r < nrun; r += 32) {
            const unsigned e = (unsigned)(
                reinterpret_cast<unsigned long long>(src + r * jk) & 15);
            env_tx += (e + run_bytes + 15) & ~15u;
          }
          env_tx = __reduce_add_sync(0xffffffffu, env_tx);
        }
        if (lane == 0) {
          unsigned tx = env_tx;
          if (copy == 0) tx += (unsigned)(no * n * cols * sizeof(TX));
          if (fcopy == 0) tx += (unsigned)(n * R * sizeof(T));
          mbar_expect_tx(bar, tx);
        }
        __syncwarp();   // the bytes are expected before any lane's copy
        if (env) {
          for (int r = lane; r < nrun; r += 32) {
            const unsigned char* run =
                reinterpret_cast<const unsigned char*>(src + r * jk);
            const unsigned e = (unsigned)(
                reinterpret_cast<unsigned long long>(run) & 15);
            bulk_copy(dst + r * drun, run - e, (e + run_bytes + 15) & ~15u,
                      bar);
          }
        } else if (cols == K) {
          copy_rows<TX>(copy, dst, drun, src, (long long)J * K, nrun,
                        rows * K, lane, bar);
        } else {
          for (int r = 0; r < nrun; ++r)
            copy_rows<TX>(copy, dst + r * drun, tk, src + (long long)r * J * K,
                          K, rows, cols, lane, bar);
        }
        copy_rows<T>(fcopy, fring + slot * fstage, RM, F + (long long)s0 * R,
                     R, n, R, lane, bar);
        if (copy == kPlainCopy) {
          // this lane's stores, and its cp.async of F rows, are done
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
  } else {
    // consumer thread (ol, kt) owns output row ol of the tile and
    // k = k0 + kt * KPT .. + KPT - 1
    const int ol = threadIdx.x / kthreads;
    const int kk = (threadIdx.x - ol * kthreads) * KPT;
    const bool mine = ol < ob && kk < cols;
    const TX* xo = ring + (mode == 0 ? ol * opitch : ol * tk) + kk;
    const int ss = mode == 0 ? tk : mpitch;    // walked rows apart in a slot
    // the envelope route: X's address and a walked row's step, mod 16
    const unsigned xb = (unsigned)(reinterpret_cast<unsigned long long>(X) & 15);
    const unsigned de = mode == 0 ? 0u : (unsigned)((long long)J * K) * sizeof(TX);
    const int gw = min(kthreads, 32);          // lanes of one o in a warp
    int slot = 0;
    unsigned parity = 0;   // the full barriers' phase to wait for
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int q = u / n_ot;
      const int o0 = (u - q * n_ot) * ob;
      const int no = min(ob, O - o0);
      const int s_end = min(Sn, (q + 1) * per);
      const bool active = mine && ol < no;
      T acc[KPT][RM];
#pragma unroll
      for (int p = 0; p < KPT; ++p)
#pragma unroll
        for (int r = 0; r < RM; ++r) acc[p][r] = T(0);
      for (int s0 = q * per; s0 < s_end; s0 += stage_rows) {
        const int n = min(stage_rows, s_end - s0);
        mbar_wait(full + slot, parity);
        if (active) {
          const TX* xs = xo + slot * xstage;
          const T* fs = fring + slot * fstage;
          if (env) {
            // where the stage's first run starts in its 16 bytes of X
            const long long first = mode == 0 ? ((long long)(o0 + ol) * J + s0) * K
                                              : ((long long)s0 * J + o0) * K;
            walk_stage<true, TX, T, RM, KPT>(
                acc, xs, ss, fs, n, xb + (unsigned)first * sizeof(TX), de);
          } else {
            walk_stage<false, TX, T, RM, KPT>(acc, xs, ss, fs, n, 0u, 0u);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
        if (++slot == stages) {
          slot = 0;
          parity ^= 1u;
        }
      }

      // epilogue: times C[k, :], summed over the thread's k, then over the
      // threads of o in a fixed order: a butterfly over the warp's lanes
      // of o, then the warp sums in warp order
      T res[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) res[r] = T(0);
      if (active) {
#pragma unroll
        for (int p = 0; p < KPT; ++p) {
          const VT* cv = reinterpret_cast<const VT*>(ct + (kk + p) * RM);
#pragma unroll
          for (int c = 0; c < RM / VN; ++c)
            fma_vec(res + c * VN, acc[p] + c * VN, cv[c]);
        }
      }
      for (int off = gw >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          res[r] += __shfl_xor_sync(0xffffffffu, res[r], off);
      }
      T* dst = out + ((long long)(q * gridDim.y + blockIdx.y) * O + o0) * R;
      if (kthreads <= 32) {
        if (active && kk == 0) {
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < R) dst[ol * R + r] = res[r];
        }
      } else {
        const int warp = threadIdx.x >> 5;
        const int wpo = kthreads >> 5;   // warps an o
        consumer_sync(nconsumer);   // the last unit's warp sums are read
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < RM; ++r) red[warp * RM + r] = res[r];
        }
        consumer_sync(nconsumer);
        for (int e = threadIdx.x; e < no * R; e += nconsumer) {
          const int o = e / R;
          const int r = e - o * R;
          T v = red[o * wpo * RM + r];
          for (int w = 1; w < wpo; ++w) v += red[(o * wpo + w) * RM + r];
          dst[e] = v;
        }
      }
    }
  }
}

struct RowsArgs {
  int mode, I, J, K, R, ob, kthreads, tk, ktiles, ns, per, nblk,
      stage_rows, stages, copy, fcopy, smem;
};

template <typename TX, typename T, int RM, int KPT>
cudaError_t launch_rows_stream(const TX* X, const T* F, const T* C, T* part,
                               T* out, const RowsArgs& g,
                               cudaStream_t stream) {
  auto kern = mttkrp3_rows_stream<TX, T, RM, KPT>;
  if (g.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return e;
  }
  const int nsplit = g.ns * g.ktiles;
  T* dst = nsplit > 1 ? part : out;
  const int consumers = (g.ob * g.kthreads + 31) / 32 * 32;
  kern<<<dim3(g.nblk, g.ktiles), consumers + 32, g.smem, stream>>>(
      X, F, C, dst, g.mode, g.I, g.J, g.K, g.R, g.ob, g.kthreads, g.tk, g.ns,
      g.per, g.stage_rows, g.stages, g.copy, g.fcopy);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const int O = g.mode == 0 ? g.I : g.J;
  return launch_reduce<T>(part, out, (long long)O * g.R, nsplit, stream);
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

// f(RM, KPT) as std::integral_constants, for the (RM, KPT) the plans can
// pick: KPT * RM * sizeof(T) <= 256 bytes (64 accumulator registers)
template <typename T, typename Fn>
cudaError_t dispatch_rm_kpt(int rm, int kpt, Fn&& f) {
#define MTTKRP3_CASE(RM_, KPT_)                                                \
  if (rm == RM_ && kpt == KPT_)                                                \
    return f(std::integral_constant<int, RM_>(),                               \
             std::integral_constant<int, KPT_>());
  MTTKRP3_CASE(8, 1) MTTKRP3_CASE(16, 1) MTTKRP3_CASE(24, 1) MTTKRP3_CASE(32, 1)
  MTTKRP3_CASE(8, 2) MTTKRP3_CASE(16, 2)
  if constexpr (sizeof(T) == 4) {
    MTTKRP3_CASE(24, 2) MTTKRP3_CASE(32, 2)
    MTTKRP3_CASE(8, 4) MTTKRP3_CASE(16, 4)
  }
#undef MTTKRP3_CASE
  return cudaErrorInvalidValue;
}

// dtype codes of X (the wrapper's DTYPE_CODES): 0 float32, 1 float64,
// 2 float16, 3 bfloat16; T is float64 for 1, float32 otherwise
enum XDtype { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

template <typename TX_, typename T_> struct Types {
  using TX = TX_;
  using T = T_;
};

// f(Types<TX, T>) for the dtype code of X
template <typename Fn>
int with_dtype(int dtype, Fn&& f) {
  switch (dtype) {
    case kF32: return (int)f(Types<float, float>());
    case kF64: return (int)f(Types<double, double>());
    case kF16: return (int)f(Types<__half, float>());
    case kBF16: return (int)f(Types<__nv_bfloat16, float>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entries for ctypes.  Each returns cudaGetLastError() after its
// launches; part holds the split partials when there is more than one.
//
// Modes 0/1, the rows-stream kernel (plan_mttkrp3's RowsStreamPlan): F is
// the walked factor (B for mode 0, A for mode 1).
extern "C" int mttkrp3_rows_run(int dtype, int rm, int kpt, const void* X,
                                const void* F, const void* C, void* part,
                                void* out, int mode, int I, int J, int K,
                                int R, int ob, int kthreads, int tk,
                                int ktiles, int ns, int per, int nblk, int stage_rows, int stages,
                                int copy, int fcopy, int smem, void* stream) {
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RowsArgs g{mode, I, J, K, R, ob, kthreads, tk, ktiles, ns, per,
                   nblk, stage_rows, stages, copy, fcopy, smem};
  return with_dtype(dtype, [&](auto ty) {
    using TX = typename decltype(ty)::TX;
    using T = typename decltype(ty)::T;
    return dispatch_rm_kpt<T>(rm, kpt, [&](auto rm_c, auto kpt_c) {
      return launch_rows_stream<TX, T, decltype(rm_c)::value,
                                decltype(kpt_c)::value>(
          static_cast<const TX*>(X), static_cast<const T*>(F),
          static_cast<const T*>(C), static_cast<T*>(part),
          static_cast<T*>(out), g, st);
    });
  });
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
  return with_dtype(dtype, [&](auto ty) {
    using TX = typename decltype(ty)::TX;
    using T = typename decltype(ty)::T;
    return dispatch_rm_kpt<T>(rm, kpt, [&](auto rm_c, auto kpt_c) {
      return launch_stream<TX, T, decltype(rm_c)::value,
                           decltype(kpt_c)::value>(
          static_cast<const TX*>(X), static_cast<const T*>(A),
          static_cast<const T*>(B), static_cast<T*>(part),
          static_cast<T*>(out), g, st);
    });
  });
}
