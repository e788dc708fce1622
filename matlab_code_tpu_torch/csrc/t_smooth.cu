// Kernel C: the tPARAFAC2 temporal-smoothness prox of a stack of PARAFAC2
// slices, for Hopper (sm_90a), bound by matlab_code_tpu_torch/ops/
// prox_cuda.py (a plain C entry, ctypes).
//
// Replaces the two lax.scans of matlab_code_tpu/ops/prox.py:144-188
// (t_smoothness_prox; functions/t_smoothness_prox.m:23-56).  For Bs
// (K, J, R) and rho (K,) it solves the block-tridiagonal system whose
// diagonal is 4 eta + rho_k (2 eta + rho_k at k = 0 and k = K - 1), whose
// off-diagonal is off = -2 eta and whose right-hand side is rho_k B_k, by
// the Thomas algorithm.  The system is the same for every one of the
// E = J R elements: only the right-hand side differs.  So the scalar
// recurrence
//   m_k = off / d'_{k-1},  d'_k = d_k - m_k off
// is computed once a block, and each walking thread takes one element
// (j, r) forward over k,
//   r'_k = rho_k B_k[e] - m_k r'_{k-1},
// and back,
//   x_{K-1} = r'_{K-1} / d'_{K-1},  x_k = (r'_k - off x_{k+1}) / d'_k.
// Neighbouring lanes take neighbouring elements, so every load and store
// of a step is coalesced (slice k of the stack is E contiguous elements).
//
// What bounds it, and what the design does about each:
//   the bytes: B read once and X written once (33.6 MB at K = 512, J = 256,
//     R = 32 in float32, 10.0 us at 3.35 TB/s).  The staged route copies
//     each tile into shared memory once, with cp.async, while the
//     recurrence runs, and writes each x_k row once, as the walk back makes
//     it.
//   the recurrence floor: the K - 1 steps of the d' chain are dependent,
//     and each holds a full IEEE division, off / d'_{k-1}, whose divisor
//     comes out of the chain itself; nothing that keeps the plain version's
//     bits runs them in parallel.  A step is the division's MUFU.RCP and
//     five FFMAs, then a multiply and a subtract, all dependent: the
//     recurrence warp alone takes 19.9 us at K = 512 on an H100 at 1.99
//     GHz, ~77 clocks a step (utils/time_prox_seq.py --phases, from the
//     kernel's clock stamps), the floor every route sits on.  So one
//     "recurrence warp" walks the chain (all 32 lanes in step, each lane
//     holding the diagonal of one step of the chunk, rho loaded a chunk
//     ahead, no branch a step) and publishes rho_k, m_k and d'_k in chunks
//     of 32 steps (through an mbarrier a chunk on the staged route, a count
//     of chunks on the stream route); the walkers run the forward
//     walk (a multiply and a subtract a step) as soon as a chunk is
//     published, in the recurrence's shadow, and compute the chunk's
//     correctly rounded reciprocals y_k = 1 / d'_k off the chain.  The back
//     substitution, which needs the whole chain, is the only tail.
//   the back substitution's divisions: their divisors d'_k are known before
//     the walk back starts, so each step divides through y_k instead of a
//     full division: q0 = n y, then twice r = d q - n (fma), q = q - r y
//     (fma).  q0 can be more than an ulp from n / d, so one correction is
//     not covered by Markstein's theorem (y within half an ulp of 1 / d and
//     q within one ulp of n / d give RN(q - r y) = RN(n / d), r exact:
//     P. Markstein, IBM J. Res. Dev. 34(1), 1990; Cornea-Hasegan, Golliver
//     and Markstein, ARITH-14, 1999, theorem 1).  The first correction,
//     even from such a q0 (and with its r rounded), leaves q within half an
//     ulp and a few 2^-p ulps of n / d, so the second is covered by the
//     theorem and gives IEEE's n / d.  tests/test_torch_prox_cuda.py
//     holds the step over 10^7 pairs a dtype, near-midpoint quotients among
//     them, against __fdiv_rn / __ddiv_rn (t_smooth_div_run), and
//     tests/test_torch_t_smooth_division.py emulates it exactly.  The
//     correction is exact only away from overflow and underflow: a group of
//     steps in which a numerator is not zero or normal within [2^-60, 2^60]
//     ([2^-500, 2^500] in float64), or a d'_k is not within that window
//     (y_k is then 0), runs again with the full division on those steps.
//     Every step, load and store of a group is straight-line code (a
//     branch a step costs more than the division it saves).
//
// Two routes, chosen by the wrapper before the launch
// (prox_cuda.plan_t_smooth):
//
//   staged  a block takes a tile of 32 elements (one walker warp) over all
//           K slices: one recurrence warp, the walker warp, and
//           kStageWarps warps that bring B's rows of the tile into shared
//           memory with cp.async, a chunk of 32 rows an mbarrier, in the
//           order the walk needs them.  The walker keeps r' in the tile and
//           writes each x_k row to X.  Shared memory: the chunks'
//           mbarriers, {rho, m, d', y} a slice and the tile, 16 ceil(K /
//           32) + (4 + 32) K itemsize bytes: K <= 1601 in float32, K <= 802
//           in float64; 74 KB a block in float32 at the PAR2 shape, three
//           an SM, its 256 blocks in one wave.  (A 64-element tile, two
//           walker warps a block, measured within 2 % of this one at the
//           PAR2 shape, the chain being the same, and would stop the route
//           at K = 850.)
//   stream  for longer K, or where the staged grid would need a second
//           wave (each wave walks the whole recurrence again): a block of
//           one recurrence warp and kStreamWalkers walker warps, an element
//           a walker thread; B is read straight from device memory a chunk
//           ahead, r' is kept in X between the two walks (about twice the
//           bytes) and read back two groups ahead, and y_k is computed by
//           the whole block in place of m_k once the forward walk is done.
//           The recurrence is published through one count of chunks done
//           (a release store, acquire loads), so shared memory stays 2 K
//           itemsize bytes: K <= 28928 in float32, K <= 14464 in float64.

// Arithmetic: in the storage type T, in the JAX module's order of
// operations (m = off / d', d - m off, r - m r', (r' - off x) / d'), with
// every product and sum written as an _rn intrinsic so that nvcc contracts
// nothing into a fused multiply-add: the result is the plain version's
// (ops/prox.t_smoothness_reference) bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kStageWarps = 2;       // staged route: warps staging the tile
constexpr int kStreamWalkers = 2;    // stream route: walker warps a block
constexpr int kChunk = 32;           // steps of the recurrence a published chunk
constexpr int kGroup = 8;            // forward steps whose operands are loaded together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }
__device__ __forceinline__ float abs_(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_(double a) { return fabs(a); }

// The window in which the reciprocal correction is exact: numerators and
// divisors within it keep every intermediate (y, q0, the residual, q) a
// normal number far from overflow.
template <typename T> struct Window;
template <> struct Window<float> {
  static constexpr float lo = 0x1p-60f, hi = 0x1p60f;
};
template <> struct Window<double> {
  static constexpr double lo = 0x1p-500, hi = 0x1p500;
};

// y_k: the correctly rounded reciprocal of d'_k, or 0 where d'_k is not a
// positive number within the window (its steps then take the division).
template <typename T>
__device__ __forceinline__ T recip_or_zero(T d) {
  return (d >= Window<T>::lo && d <= Window<T>::hi) ? rcp(d) : static_cast<T>(0);
}

// The full division where the correction does not hold, as a call (the
// rare steps outside the window; inline, it would be computed and selected
// on every step).
__device__ __noinline__ float quot_call(float a, float b) { return __fdiv_rn(a, b); }
__device__ __noinline__ double quot_call(double a, double b) { return __ddiv_rn(a, b); }

// The correction's window: n zero or normal within it, and y not 0.
template <typename T>
__device__ __forceinline__ bool in_window(T n, T y) {
  const T a = abs_(n);
  return y != static_cast<T>(0) && a <= Window<T>::hi &&
         (a >= Window<T>::lo || n == static_cast<T>(0));
}

// n / d rounded to nearest even, from y = recip_or_zero(d), where
// in_window(n, y): five dependent operations, q0 and two corrections (see
// the header).  With d > 0, r = d q - n and q - r y also give a zero
// numerator's quotient its sign.
template <typename T>
__device__ __forceinline__ T qdiv_fast(T n, T d, T y) {
  const T q0 = mul(n, y);
  const T q1 = fma_(-fma_(d, q0, -n), y, q0);
  return fma_(-fma_(d, q1, -n), y, q1);
}

// One step, guarded: the correction inside the window, else the division.
template <typename T>
__device__ __forceinline__ T qdiv(T n, T d, T y) {
  return in_window(n, y) ? qdiv_fast(n, d, y) : quot_call(n, d);
}

// G steps of the back substitution, x_k = (t_k - off x_{k+1}) / d'_k for
// the G slices of t, d, y (in walk order), into xs.  A branch a step would
// cost more than the division it saves, so the steps run the correction
// unguarded while the window's verdicts are gathered off the chain, and
// the group runs again, guarded, where any lane of the warp left the
// window (zero, subnormal, huge or non-finite numerators, d' outside it).
template <int G, typename T>
__device__ __forceinline__ void back_steps(T& x, const T (&t)[G], const T (&d)[G],
                                           const T (&y)[G], T off, T (&xs)[G]) {
  const T x0 = x;
  bool out = false;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const T n = sub(t[i], mul(off, x));
    out |= !in_window(n, y[i]);
    x = qdiv_fast(n, d[i], y[i]);
    xs[i] = x;
  }
  if (__any_sync(kFull, out)) {
    x = x0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      x = qdiv(sub(t[i], mul(off, x)), d[i], y[i]);
      xs[i] = x;
    }
  }
}

// A store to device memory predicated on `on`: written in PTX, as the
// compiler would branch (and put a convergence barrier) around a plain
// conditional store.
__device__ __forceinline__ void st_if(float* p, float v, bool on) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}\n"
               :: "l"(p), "f"(v), "r"(static_cast<unsigned>(on)));
}
__device__ __forceinline__ void st_if(double* p, double v, bool on) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.f64 [%0], %1;\n}\n"
               :: "l"(p), "d"(v), "r"(static_cast<unsigned>(on)));
}

// Stores a group's x rows where `on`, steps g, g - 1, ... (rows g - i of X
// from p at row g, E elements apart; in the last group, g < G - 1, only
// its steps >= 0): straight-line code, a predicated store and two adds a
// row, so the stores can share a basic block with the next group's steps.
template <int G, typename T>
__device__ __forceinline__ void store_group(T* p, long E, int g, const T (&xs)[G],
                                            bool on) {
  const long step = E * static_cast<long>(sizeof(T));
  char* b = reinterpret_cast<char*>(p);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    st_if(reinterpret_cast<T*>(b), xs[i], on && (g >= G - 1 || i <= g));
    b -= step;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// arrive on bar once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_u32(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" :: "r"(smem_u32(dst)), "l"(src), "n"(W) : "memory");
  }
}

// Waits for the first phase of a one-shot mbarrier.  A fault in the
// protocol would otherwise hang the card: past 2^34 cycles (about 10 s) of
// waiting the kernel traps, and the launch reports an error.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
  long long t0 = -1;
  while (true) {
    unsigned done;
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 < 0) {
      t0 = t;
    } else if (t - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

// The stream route's published chunks: a count that one lane of the
// recurrence warp raises with a release store once the warp's values of a
// chunk are written, and that the walkers read with acquire loads until it
// reaches theirs (trapping past 2^34 cycles, as mbar_wait).
__device__ __forceinline__ void publish_count(unsigned* count, unsigned v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" :: "r"(smem_u32(count)), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_count(const unsigned* count, unsigned v) {
  long long t0 = -1;
  while (true) {
    unsigned c;
    asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n" : "=r"(c) : "r"(smem_u32(count)) : "memory");
    if (c >= v) return;
    __nanosleep(64);
    const long long t = clock64();
    if (t0 < 0) {
      t0 = t;
    } else if (t - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

// The phase breakdown's stamps (t_smooth_phase_run only): slots of a block
// in stamps[kStamps blockIdx.x ...], SM clocks and the global timer.
constexpr int kStamps = 8;
enum Stamp { kStart = 0, kRecEnd = 1, kStageEnd = 2, kForwardEnd = 3,
             kBackEnd = 4, kStartNs = 5, kBackEndNs = 6 };

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(long long* stamps, int slot, bool ns = false) {
  if (stamps != nullptr) stamps[kStamps * blockIdx.x + slot] = ns ? global_ns() : clock64();
}

// The k-th diagonal entry: 4 eta + rho_k, plus off = -2 eta at k = 0 and
// then at k = K - 1 (both at k = 0 when K = 1), in the JAX module's order.
template <typename T>
__device__ __forceinline__ T diag_at(int k, int K, T four_eta, T off, T rho_k) {
  T d = add(four_eta, rho_k);
  if (k == 0) d = add(d, off);
  if (k == K - 1) d = add(d, off);
  return d;
}

// One chunk of the recurrence, by a whole warp in step: each lane holds the
// diagonal entry of its step k0 + lane (dk) and gets back that step's m and
// d'.  dprev carries d'_{k0-1} in (+inf before step 0: m_0 = off / inf is
// a zero and d'_0 = d_0 - (+0) = d_0, bit for bit; the caller sets m_0 to
// +0) and d'_{k0+31} out.  No branch a step: only the division, one
// multiply and one subtract are on the chain.  Steps past K - 1 in the last
// chunk are walked on a zero rho and never published.
template <typename T>
__device__ __forceinline__ void chain_chunk(T dk, T off, int lane, T& dprev,
                                            T& my_m, T& my_d) {
  T dv[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk; ++i) dv[i] = __shfl_sync(kFull, dk, i);
  my_m = static_cast<T>(0);
  my_d = static_cast<T>(0);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const T m = quot(off, dprev);
    dprev = sub(dv[i], mul(m, off));
    my_m = lane == i ? m : my_m;
    my_d = lane == i ? dprev : my_d;
  }
}

// The recurrence warp's loop: chunk by chunk, rho one chunk ahead, each
// lane's step k = 32 c + lane handed to publish(c, k, rho_k, m_k, d'_k).
template <typename T, typename P>
__device__ __forceinline__ void walk_recurrence(const T* __restrict__ rho, int K,
                                                T eta, T off, int lane,
                                                P publish) {
  const T four_eta = mul(static_cast<T>(4.0), eta);
  const int nch = (K + kChunk - 1) / kChunk;
  T dprev = static_cast<T>(__int_as_float(0x7f800000));   // +inf
  T rv = lane < K ? rho[lane] : static_cast<T>(0);
  for (int c = 0; c < nch; ++c) {
    const int k = c * kChunk + lane;
    const T rnext = k + kChunk < K ? rho[k + kChunk] : static_cast<T>(0);
    T my_m, my_d;
    chain_chunk(diag_at(k, K, four_eta, off, rv), off, lane, dprev, my_m, my_d);
    publish(c, k, rv, k == 0 ? static_cast<T>(0) : my_m, my_d);
    rv = rnext;
  }
}

template <bool V> struct Bool { static constexpr bool value = V; };

template <typename T>
struct alignas(4 * sizeof(T)) Coef {
  T rho, m, d, y;   // rho_k, m_k, d'_k, y_k
};

// What a launch of the staged kernel runs: the whole kernel, or one of its
// phases alone, for the phase breakdown (t_smooth_phase_run).
enum Mode { kAll = 0, kRecurrence = 1, kStaging = 2, kWalk = 3 };

// The staged route: a tile of 32 elements a block.  Warp 0 walks the
// recurrence, warp 1 walks the tile, warps 2 .. 1 + kStageWarps stage it.
// dbg (the phase breakdown only): kRecurrence writes block 0's
// {rho, m, d', 0} there, kWalk publishes them from there instead of walking
// the recurrence; stamps (or null): the phase breakdown's clock stamps.
template <typename T, int MODE>
__global__ void __launch_bounds__(32 * (2 + kStageWarps))
t_smooth_staged(const T* __restrict__ B, const T* __restrict__ rho,
                T* __restrict__ X, Coef<T>* __restrict__ dbg,
                long long* __restrict__ stamps, int K, long E, double eta_in,
                int vec) {
  constexpr int tile_w = 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (K + kChunk - 1) / kChunk;
  unsigned long long* staged = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* rec = staged + nch;
  Coef<T>* coef = reinterpret_cast<Coef<T>*>(smem + 16 * nch);
  T* tile = reinterpret_cast<T*>(coef + K);   // K x tile_w: B, then r'
  const T eta = static_cast<T>(eta_in);
  const T off = mul(static_cast<T>(-2.0), eta);
  const long e0 = static_cast<long>(blockIdx.x) * tile_w;
  const int nvalid = static_cast<int>(E - e0 < tile_w ? E - e0 : tile_w);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int c = 0; c < nch; ++c) {
      mbar_init(staged + c, 32 * kStageWarps);
      mbar_init(rec + c, 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    stamp(stamps, kStart);
    stamp(stamps, kStartNs, true);
  }

  if (warp == 0) {
    // ---- the recurrence warp ----
    if (MODE == kStaging) return;
    if (MODE == kWalk) {
      for (int k = lane; k < K; k += 32) coef[k] = dbg[k];
      for (int c = 0; c < nch; ++c) mbar_arrive(rec + c);
      return;
    }
    walk_recurrence(rho, K, eta, off, lane, [&](int c, int k, T rk, T mk, T dk) {
      if (k < K) {
        const Coef<T> cf{rk, mk, dk, static_cast<T>(0)};   // y: the walker's
        coef[k] = cf;
        if (MODE == kRecurrence && blockIdx.x == 0) dbg[k] = cf;
      }
      mbar_arrive(rec + c);
    });
    if (lane == 0) stamp(stamps, kRecEnd);
    return;
  }

  if (warp > 1) {
    // ---- the staging warps: chunk c's rows, then an arrival on staged[c]
    // once this thread's copies have landed ----
    if (MODE == kRecurrence) return;
    const int t = threadIdx.x - 64;
    constexpr int nt = 32 * kStageWarps;
    const T* src = B + e0;
    for (int c = 0; c < nch; ++c) {
      const int k0 = c * kChunk;
      const int rows = K - k0 < kChunk ? K - k0 : kChunk;
      if (vec) {
        constexpr int per = 16 / sizeof(T);         // elements a copy
        const int vrow = nvalid / per;              // copies a row
        for (int v = t; v < rows * vrow; v += nt) {
          const int k = k0 + v / vrow, w = (v % vrow) * per;
          cp_async<16>(tile + k * tile_w + w, src + static_cast<long>(k) * E + w);
        }
      } else {
        for (int v = t; v < rows * nvalid; v += nt) {
          const int k = k0 + v / nvalid, w = v % nvalid;
          cp_async<sizeof(T)>(tile + k * tile_w + w, src + static_cast<long>(k) * E + w);
        }
      }
      cp_async_arrive(staged + c);
    }
    cp_async_wait_all();
    if (t == 0) stamp(stamps, kStageEnd);
    return;
  }

  // ---- the walker warp: column w of the tile ----
  if (MODE == kRecurrence) return;
  const int w = lane;
  const bool valid = w < nvalid;
  T* col = tile + w;
  if (MODE == kStaging) {
    for (int c = 0; c < nch; ++c) mbar_wait(staged + c);
    return;
  }
  // forward, chunk by chunk as the staging and the recurrence publish
  // them; a lane past the tile's edge walks zeros
  T r = static_cast<T>(0);
  auto forward = [&](int g, auto guard) {
    T b[kGroup], rh[kGroup], mm[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k = g + i;
      if (!decltype(guard)::value || k < K) {
        b[i] = valid ? col[k * tile_w] : static_cast<T>(0);
        rh[i] = coef[k].rho;
        mm[i] = coef[k].m;
      }
    }
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k = g + i;
      if (!decltype(guard)::value || k < K) {
        r = sub(mul(rh[i], b[i]), mul(mm[i], r));   // m_0 = 0: r'_0 = rho_0 B_0
        col[k * tile_w] = r;
      }
    }
  };
  for (int c = 0; c < nch; ++c) {
    mbar_wait(rec + c);
    const int k0 = c * kChunk;
    // y_k of the chunk, one a lane, off the recurrence warp's chain (this
    // warp waits on the chain anyway)
    if (k0 + lane < K) coef[k0 + lane].y = recip_or_zero(coef[k0 + lane].d);
    mbar_wait(staged + c);
    if (k0 + kChunk <= K) {
#pragma unroll
      for (int g = 0; g < kChunk; g += kGroup) forward(k0 + g, Bool<false>());
    } else {
      for (int g = k0; g < K; g += kGroup) forward(g, Bool<true>());
    }
  }
  __syncwarp();   // the warp's y_k seen by all its lanes
  if (w == 0) stamp(stamps, kForwardEnd);
  // back: groups of G steps whose operands are loaded one group ahead, each
  // group's x_k rows written to X with the next group's steps
  constexpr int G = 64 / sizeof(T);
  T* out = X + e0 + w;
  T x = qdiv(r, coef[K - 1].d, coef[K - 1].y);
  if (valid) out[static_cast<long>(K - 1) * E] = x;
  // the full groups: operands from a group base clamped to rows >= 0 (a
  // prefetch past the last full group reads rows it never uses), so no
  // test a load; each group's stores issued, predicated, with the next
  // group's chain, so loads, stores and steps share one basic block
  auto load = [&](int g, T (&t)[G], T (&d)[G], T (&y)[G]) {
    const int base = g > G - 1 ? g : G - 1;
    const T* c = col + base * tile_w;
    const Coef<T>* f = coef + base;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      t[i] = c[-i * tile_w];
      d[i] = f[-i].d;
      y[i] = f[-i].y;
    }
  };
  const int nfull = (K - 1) / G;
  T ta[G], da[G], ya[G], tb[G], db[G], yb[G], xa[G], xb[G];
  int g = K - 2, j = 0;
  if (nfull > 0) load(g, ta, da, ya);   // (clamped loads need a full group)
  for (; j + 1 < nfull; j += 2, g -= 2 * G) {
    load(g - G, tb, db, yb);
    store_group<G>(out + static_cast<long>(g + G) * E, E, g + G, xb, valid && j > 0);
    back_steps<G>(x, ta, da, ya, off, xa);
    load(g - 2 * G, ta, da, ya);
    store_group<G>(out + static_cast<long>(g) * E, E, g, xa, valid);
    back_steps<G>(x, tb, db, yb, off, xb);
  }
  if (j > 0) store_group<G>(out + static_cast<long>(g + G) * E, E, g + G, xb, valid);
  if (j < nfull) {   // one full group left, loaded in ta
    back_steps<G>(x, ta, da, ya, off, xa);
    store_group<G>(out + static_cast<long>(g) * E, E, g, xa, valid);
    g -= G;
  }
  if (g >= 0) {      // the last steps, fewer than a group; k < 0 padded
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = g - i;
      ta[i] = k >= 0 ? col[k * tile_w] : static_cast<T>(0);
      da[i] = k >= 0 ? coef[k].d : static_cast<T>(1);
      ya[i] = k >= 0 ? coef[k].y : static_cast<T>(1);
    }
    back_steps<G>(x, ta, da, ya, off, xa);
    store_group<G>(out + static_cast<long>(g) * E, E, g, xa, valid);
  }
  if (w == 0) {
    stamp(stamps, kBackEnd);
    stamp(stamps, kBackEndNs, true);
  }
}

// The stream route: warp 0 walks the recurrence (m_k and d'_k published in
// chunks through `done`), warps 1 .. kStreamWalkers an element a thread, r'
// kept in X.
template <typename T>
__global__ void __launch_bounds__(32 * (1 + kStreamWalkers))
t_smooth_stream(const T* __restrict__ B, const T* __restrict__ rho,
                T* __restrict__ X, int K, long E, double eta_in) {
  constexpr int G = 128 / sizeof(T);       // back steps a group
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned done;                         // chunks published
  const int nch = (K + kChunk - 1) / kChunk;
  T* dmod = reinterpret_cast<T*>(smem);             // d'_k
  T* my = dmod + K;                                 // m_k, then y_k
  const T eta = static_cast<T>(eta_in);
  const T off = mul(static_cast<T>(-2.0), eta);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) done = 0;
  __syncthreads();
  const long e = (static_cast<long>(blockIdx.x) * kStreamWalkers + warp - 1) * 32 + lane;
  const bool valid = warp > 0 && e < E;
  T r = static_cast<T>(0);
  if (warp == 0) {
    walk_recurrence(rho, K, eta, off, lane, [&](int c, int k, T, T mk, T dk) {
      if (k < K) {
        my[k] = mk;
        dmod[k] = dk;
      }
      __syncwarp();
      if (lane == 0) publish_count(&done, c + 1);
    });
  } else {
    // forward: a chunk's B rows and rho loaded before its wait
    auto forward = [&](int k0, auto guard) {
      const T rh = k0 + lane < K ? rho[k0 + lane] : static_cast<T>(0);
      T b[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        b[i] = valid && (!decltype(guard)::value || k0 + i < K)
                   ? B[static_cast<long>(k0 + i) * E + e] : static_cast<T>(0);
      wait_count(&done, k0 / kChunk + 1);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int k = k0 + i;
        const T rho_k = __shfl_sync(kFull, rh, i);
        if (!decltype(guard)::value || k < K) {
          r = sub(mul(rho_k, b[i]), mul(my[k], r));
          b[i] = r;
        }
      }
      if (valid) {   // the chunk's r' rows, one test for all
        T* p = X + static_cast<long>(k0) * E + e;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          if (!decltype(guard)::value || k0 + i < K) *p = b[i];
          p += E;
        }
      }
    };
    for (int c = 0; c < nch; ++c) {
      if ((c + 1) * kChunk <= K) forward(c * kChunk, Bool<false>());
      else forward(c * kChunk, Bool<true>());
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) my[k] = recip_or_zero(dmod[k]);
  __syncthreads();
  if (warp == 0) return;
  // back: r'_k read back from X one group ahead
  T x = qdiv(r, dmod[K - 1], my[K - 1]);
  if (valid) X[static_cast<long>(K - 1) * E + e] = x;
  // r' rows of steps g .. g - G + 1 from X into t, and their d', y; k < 0
  // padded
  auto load = [&](int g, T (&t)[G]) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = g - i;
      t[i] = valid && k >= 0 ? X[static_cast<long>(k) * E + e] : static_cast<T>(0);
    }
  };
  auto coefs = [&](int g, T (&d)[G], T (&y)[G]) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = g - i;
      d[i] = k >= 0 ? dmod[k] : static_cast<T>(1);
      y[i] = k >= 0 ? my[k] : static_cast<T>(1);
    }
  };
  // two groups an iteration; r' rows loaded two groups ahead of their use
  // (they come back from the L2 or device memory)
  T ta[G], tb[G], dc[G], yc[G], xs[G];
  load(K - 2, ta);
  load(K - 2 - G, tb);
  for (int g = K - 2; g >= 0; g -= 2 * G) {
    coefs(g, dc, yc);
    back_steps<G>(x, ta, dc, yc, off, xs);
    load(g - 2 * G, ta);
    store_group<G>(X + static_cast<long>(g) * E + e, E, g, xs, valid);
    if (g - G < 0) break;
    coefs(g - G, dc, yc);
    back_steps<G>(x, tb, dc, yc, off, xs);
    load(g - 3 * G, tb);
    store_group<G>(X + static_cast<long>(g - G) * E + e, E, g - G, xs, valid);
  }
}

// The division step alone: q = qdiv(n, d, recip_or_zero(d)) beside
// ref = the full division, for the card test of the correction.
template <typename T>
__global__ void div_check(const T* __restrict__ n, const T* __restrict__ d,
                          T* __restrict__ q, T* __restrict__ ref, long count) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const T a = n[i], b = d[i];
  q[i] = qdiv(a, b, recip_or_zero(b));
  ref[i] = quot(a, b);
}

// Opts `kernel` into `bytes` of dynamic shared memory where they and its
// static shared memory (the stream route's count, a few bytes) could pass
// 48 KB, on the current device, once a size: a cudaFuncSetAttribute on every launch
// costs host time, which a short kernel's time on the card then shows.
// granted: the size this kernel was given so far, by device (the caller's
// own, one a kernel: kernels of one signature share a K_).
template <typename K_>
cudaError_t allow_smem(K_* kernel, long bytes, long (&granted)[64]) {
  int dev = 0;
  if (bytes <= 48 * 1024 - 64 || (cudaGetDevice(&dev) == cudaSuccess && dev < 64 &&
                             bytes <= granted[dev]))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  else if (dev < 64) granted[dev] = bytes;
  return e;
}

long staged_smem(int K, long item) {
  return 16L * ((K + kChunk - 1) / kChunk) + 36L * K * item;
}

long stream_smem(int K, long item) { return 2L * K * item; }

template <typename T, int MODE>
int launch_staged(const void* B, const void* rho, void* X, void* dbg,
                  void* stamps, int K, long E, double eta, long smem,
                  cudaStream_t st) {
  static long granted[64] = {};
  auto* k = t_smooth_staged<T, MODE>;
  cudaError_t e;
  if ((e = allow_smem(k, smem, granted)) != cudaSuccess) return (int)e;
  const int vec = reinterpret_cast<unsigned long long>(B) % 16 == 0 &&
                  (E * static_cast<long>(sizeof(T))) % 16 == 0;
  k<<<(E + 31) / 32, 32 * (2 + kStageWarps), smem, st>>>(
      static_cast<const T*>(B), static_cast<const T*>(rho), static_cast<T*>(X),
      static_cast<Coef<T>*>(dbg), static_cast<long long*>(stamps), K, E, eta, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stream(const void* B, const void* rho, void* X, int K, long E,
                  double eta, long smem, cudaStream_t st) {
  static long granted[64] = {};
  auto* k = t_smooth_stream<T>;
  cudaError_t e;
  if ((e = allow_smem(k, smem, granted)) != cudaSuccess) return (int)e;
  constexpr int per = 32 * kStreamWalkers;
  k<<<(E + per - 1) / per, 32 * (1 + kStreamWalkers), smem, st>>>(
      static_cast<const T*>(B), static_cast<const T*>(rho), static_cast<T*>(X),
      K, E, eta);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  is_double selects float64 (else float32); staged
// the staged route (else the stream route).  B and X: (K, E) contiguous
// (E = J R elements a slice); rho: K values of the same type on the device;
// smem: the route's bytes of shared memory a block
// (prox_cuda.t_smooth_smem: 16 ceil(K / 32) + 36 K itemsize staged, 2 K
// itemsize streamed).  Returns the launch's CUDA error.
extern "C" int t_smooth_run(int is_double, int staged, const void* B,
                            const void* rho, void* X, int K, long E,
                            double eta, long smem, void* stream) {
  const long item = is_double ? 8 : 4;
  if (K < 1 || E < 1 ||
      smem < (staged ? staged_smem(K, item) : stream_smem(K, item)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!staged)
    return is_double ? launch_stream<double>(B, rho, X, K, E, eta, smem, st)
                     : launch_stream<float>(B, rho, X, K, E, eta, smem, st);
  return is_double
             ? launch_staged<double, kAll>(B, rho, X, nullptr, nullptr, K, E, eta, smem, st)
             : launch_staged<float, kAll>(B, rho, X, nullptr, nullptr, K, E, eta, smem, st);
}

// The staged route's phases alone, for the phase breakdown
// (utils/time_prox_seq.py --phases): mode 0 the whole kernel, 1 the
// recurrence warps alone (block 0 writes its {rho, m, d', 0} a slice to
// dbg, 4 K values), 2 the staging alone (the walkers wait for every
// chunk), 3 the staging and the walks with the recurrence read from dbg and
// published at once.  X is written by modes 0 and 3.  stamps (or null):
// kStamps int64 a block, the SM clock at the start (after the barriers'
// set-up), at the recurrence's end, at the end of this block's copies (its
// first staging thread's), at the end of the forward walk and of the back
// substitution (its first walker), and the global timer (ns) at the start
// and at the back substitution's end.
extern "C" int t_smooth_phase_run(int mode, int is_double, const void* B,
                                  const void* rho, void* X, void* dbg,
                                  void* stamps, int K, long E, double eta,
                                  long smem, void* stream) {
  const long item = is_double ? 8 : 4;
  if (K < 1 || E < 1 ||
      (dbg == nullptr && mode != kAll) || smem < staged_smem(K, item) ||
      mode < kAll || mode > kWalk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_double) {
    switch (mode) {
      case kAll: return launch_staged<double, kAll>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
      case kRecurrence: return launch_staged<double, kRecurrence>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
      case kStaging: return launch_staged<double, kStaging>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
      default: return launch_staged<double, kWalk>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
    }
  }
  switch (mode) {
    case kAll: return launch_staged<float, kAll>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
    case kRecurrence: return launch_staged<float, kRecurrence>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
    case kStaging: return launch_staged<float, kStaging>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
    default: return launch_staged<float, kWalk>(B, rho, X, dbg, stamps, K, E, eta, smem, st);
  }
}

// The back substitution's division step on count pairs (n, d): q from the
// reciprocal correction as the kernel takes it, ref = __fdiv_rn /
// __ddiv_rn, for the card test that holds the two equal bit for bit.
extern "C" int t_smooth_div_run(int is_double, const void* n, const void* d,
                                void* q, void* ref, long count, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long blocks = (count + 255) / 256;
  if (is_double)
    div_check<double><<<blocks, 256, 0, st>>>(
        static_cast<const double*>(n), static_cast<const double*>(d),
        static_cast<double*>(q), static_cast<double*>(ref), count);
  else
    div_check<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(n), static_cast<const float*>(d),
        static_cast<float*>(q), static_cast<float*>(ref), count);
  return (int)cudaGetLastError();
}
