"""MATLAB-compatible random streams and exact reference replay (counterpart
of matlab_code_tpu/utils/matlab_rng.py, whose numpy twister, ziggurat randn,
randi, randperm and orth are copied here unchanged: the same seed gives the
same draws bit for bit).

MATLAB's default generator ('twister') is the reference mt19937ar: 32-bit
Mersenne-Twister words turned into doubles by genrand_res53 (two words per
double).  `rng("default")` -- the seeding every reference example script
uses (example_script1:13, example_script11:10, ...) -- resets it to the
mt19937ar default seed 5489; the first draw is the canonical
0.814723686393179.  `MatlabRNG.rand(m, n)` reproduces MATLAB `rand(m,n)`,
column-major fill order included.

MATLAB `randn` (the 'Ziggurat' NormalTransform on the twister stream) is
reproduced by `MatlabRNG.randn`: each draw consumes two 32-bit twister words
(wA, wB) and uses a 256-region ziggurat with an increasing x-table
x[0]=0 .. x[255]=r=3.6541528853610088:

    idx = wB >> 24                                  (top 8 bits of wB)
    U   = ((wA >> 3) << 24 | (wB & 0xFFFFFF)) - 2^52   (signed 53-bit)
    u   = U / 2^52                                  in (-1, 1)
    x   = u * W[idx]   with W[i] = x[i+1] (i<255),  W[255] = v/f(r)
    accept iff |x| <= A[idx]  with A[i] = x[i] (i<255), A[255] = r

The rejection paths (edge wedge and tail, ~1-2% of draws) take one
genrand_res53 uniform for the wedge test f1 + u*(f0-f1) < exp(-r^2/2), and
tail attempts x = -log(u1)*(1/r) accepted when -2*log(u2) >= x^2;
`slowpath_edge`/`slowpath_tail` count how often a sequence hit them.  The
construction was reverse-engineered from MathWorks' published anchor draws
(rng('default') then 0.537667139546100, 1.833885014595086, ...); the JAX
package's tests/test_fixture_parity.py and tests/test_native.py hold it to
those anchors and to an independent C++ reconstruction.

matlab_create_coupled_data and matlab_init_coupled replay the draw order of
create_coupled_data.m and init_coupled_AOADMM_CMTF.m on that stream and hand
the result over as the port's ProblemData and SolverState, on `device` (the
card unless the caller asks for the CPU) in `dtype` (float64 on the CPU,
float32 on the card).  `poissrnd`/`gamrnd` are not reproduced, so KL/IS
noisy-data flows are outside exact replay.
"""
from __future__ import annotations

import numpy as np

_N = 624
_MATAG = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


class MatlabRNG:
    """mt19937ar with MATLAB's rand() semantics.

    seed: "default" (MATLAB rng("default"), mt19937ar seed 5489) or an int
    passed to init_genrand (matches MATLAB rng(seed,'twister') for the
    anchors tested: seed 0 -> 0.548813503927325, default -> 0.814723686393179).
    """

    def __init__(self, seed="default"):
        s = 5489 if seed == "default" else int(seed)
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = s & 0xFFFFFFFF
        for i in range(1, _N):  # init_genrand (mt19937ar.c)
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) \
                & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._pos = _N
        # randn rejection-path events on this stream (see module docstring)
        self.slowpath_edge = 0
        self.slowpath_tail = 0

    def _twist(self):
        """The mt19937ar generate-block loop.  It is SEQUENTIAL: entries
        kk >= 227 read mt[kk-227] which was already updated this block, and
        the final entry reads the new mt[0]/mt[396] — vectorized here as
        the three dependency-free chunks + the final element."""
        mt = self._mt
        new = np.empty_like(mt)

        def step(y, src):
            mag = np.where(y & np.uint32(1), _MATAG, np.uint32(0))
            return src ^ (y >> np.uint32(1)) ^ mag

        y = (mt[0:227] & _UPPER) | (mt[1:228] & _LOWER)      # kk 0..226
        new[0:227] = step(y, mt[397:624])
        y = (mt[227:454] & _UPPER) | (mt[228:455] & _LOWER)  # kk 227..453
        new[227:454] = step(y, new[0:227])
        y = (mt[454:623] & _UPPER) | (mt[455:624] & _LOWER)  # kk 454..622
        new[454:623] = step(y, new[227:396])
        y = (mt[623] & _UPPER) | (new[0] & _LOWER)           # kk 623
        new[623] = step(y, new[396])
        self._mt = new
        self._pos = 0

    def _words(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        got = 0
        while got < n:
            if self._pos >= _N:
                self._twist()
            take = min(n - got, _N - self._pos)
            out[got:got + take] = self._mt[self._pos:self._pos + take]
            self._pos += take
            got += take
        # tempering
        y = out
        y = y ^ (y >> np.uint32(11))
        y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
        y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
        y = y ^ (y >> np.uint32(18))
        return y

    def rand(self, m: int, n: int | None = None):
        """MATLAB rand(m[,n]): genrand_res53 doubles, column-major fill."""
        cnt = m if n is None else m * n
        w = self._words(2 * cnt).astype(np.float64)
        a = np.floor(w[0::2] / 32.0)             # >> 5
        b = np.floor(w[1::2] / 64.0)             # >> 6
        vals = (a * 67108864.0 + b) / 9007199254740992.0
        if n is None:
            return vals
        return vals.reshape((m, n), order="F")

    def randi(self, imax: int, m: int, n: int | None = None):
        """MATLAB randi(imax, m[, n]): 1 + floor(imax*rand), column-major.

        The scaling construction is pinned by the randi doc anchor
        (rng default, randi(10,1,5) -> 9 10 2 10 7 = the canonical rand
        stream 0.8147... scaled).  Validated-scope note: the anchor covers
        small imax only; floor-scaling of one double is MATLAB's known
        behavior for imax << 2^53 but large imax (where MATLAB may switch
        to a bias-free integer construction) has no anchor — assert the
        known-good range rather than guessing there."""
        if imax > 1 << 20:
            raise NotImplementedError(
                "MatlabRNG.randi is anchor-validated for small imax only "
                "(floor-scaling construction); the replayed scripts use "
                "imax <= 60")
        v = np.floor(imax * self.rand(m, n)).astype(np.int64) + 1
        return np.minimum(v, imax)      # guard the rand()==1-ulp edge

    # -- randn: the 'Ziggurat' NormalTransform (see module docstring) -------

    def _randn1(self) -> float:
        """One normal draw, sequential, including the rejection paths."""
        W, A, F = _zig_tables()
        while True:
            wA, wB = (int(t) for t in self._words(2))
            idx = wB >> 24
            u = (((wA >> 3) << 24 | (wB & 0xFFFFFF)) - (1 << 52)) * 2.0**-52
            x = u * W[idx]
            if abs(x) <= A[idx]:
                return x
            if idx == 255:                      # tail: x beyond r
                self.slowpath_tail += 1
                r = A[255]
                while True:
                    xx = -np.log(self.rand(1)[0]) * _ZIG_INV_R
                    yy = -np.log(self.rand(1)[0])
                    # accept-on->= follows Marsaglia's published nfix
                    # (while -2*log(U) < x*x); the exact-equality boundary
                    # is measure-zero and has no published anchor either way
                    if yy + yy >= xx * xx:
                        return (r + xx) if x > 0 else -(r + xx)
            else:                               # edge wedge of region idx
                self.slowpath_edge += 1
                y = self.rand(1)[0]
                if F[idx + 1] + y * (F[idx] - F[idx + 1]) \
                        < np.exp(-0.5 * x * x):
                    return x
                # rejected: fall through to a fresh (wA, wB) attempt

    def randperm(self, n: int, k: int | None = None):
        """MATLAB randperm(n[,k]): indices 1..n in random order (first k).

        Construction: full sort of n fresh rand() draws ([~,p]=sort(rand
        (1,n))), truncated to the first k — pinned by the two doc anchors
        rng default -> randperm(6) = [6 3 5 1 2 4] and randperm(8,4) =
        [6 3 7 8], both exactly the sort order of the canonical
        0.8147... stream.  Validated-scope note: the anchors cover
        k = n and k = n/2; whether MATLAB switches to a cheaper partial
        algorithm (different stream consumption) for k << n has no anchor
        — the replayed script (12) uses k = n/5, between the anchors.
        Consumes n draws regardless of k.  Returns 1-based indices."""
        vals = self.rand(n)
        p = np.argsort(vals, kind="stable") + 1
        return p if k is None else p[:k]

    def randn(self, m: int, n: int | None = None):
        """MATLAB randn(m[,n]) on the twister stream, column-major fill.

        Vectorized over the fast path (bit-validated against the ten
        documented anchor draws); the rare rejection paths are handled
        sequentially and counted in slowpath_edge/slowpath_tail.
        """
        cnt = m if n is None else m * n
        W, A, _ = _zig_tables()
        vals = np.empty(cnt)
        i = 0
        while i < cnt:
            # ~1.5% of draws reject, so the expected first rejection sits
            # near draw 65 — a large chunk would be recomputed almost
            # entirely after every rewind.  256 keeps the vector work ~4x
            # the accepted draws while amortizing the python overhead.
            take = min(cnt - i, 256)
            snap = (self._mt.copy(), self._pos)
            w = self._words(2 * take).astype(np.uint64)
            wA, wB = w[0::2], w[1::2]
            idx = (wB >> np.uint64(24)).astype(np.int64)
            U = (((wA >> np.uint64(3)) << np.uint64(24))
                 | (wB & np.uint64(0xFFFFFF))).astype(np.int64) - (1 << 52)
            x = U.astype(np.float64) * 2.0**-52 * W[idx]
            bad = np.nonzero(~(np.abs(x) <= A[idx]))[0]
            if bad.size == 0:
                vals[i:i + take] = x
                i += take
                continue
            j = int(bad[0])
            vals[i:i + j] = x[:j]
            i += j
            self._mt, self._pos = snap           # rewind, then skip the
            self._words(2 * j)                   # j accepted fast pairs
            vals[i] = self._randn1()
            i += 1
        if n is None:
            return vals
        return vals.reshape((m, n), order="F")



# --- MATLAB randn (ziggurat) tables -----------------------------------------
# x[0..255] of the 256-region ziggurat (increasing; x[255] = r), solved to
# 60 digits with the closure v/x[1] + f(x[1]) = 1 and rounded to float64;
# r = 3.65415288536100877... matches the published ZIGGURAT_NOR_R constant.
_ZIG_XS_HEX = (
    "000000000000000002f7fde30b8dcb3fc65b2c3caf50d23f713b4438b97cd53f1aa72fe8fc01d83fcbd04c2e0c23da3f"
    "0762382f4d00dc3f8172745a2facdd3fd0d54c2d4832df3fb4bb8e27324de03f4a5d023b05f5e03f7d364197a692e13f"
    "fa1a7a8fa227e23f85d863382eb5e23ffa9157c03f3ce33f34b1a2c19ebde33f5a9bff8def39e43fadfe3d36bbb1e43f"
    "79d31a627525e53f9cce07a78095e53ff17ed9cf3102e63f447ca361d26be63f76050092a2d2e63fadf846d3da36e73f"
    "7e2ab310ad98e73f49f546ad45f8e73f7d0a4353cc55e83f9f767b9e64b1e83f9ecf4ea92e0be93ff01e2c824763e93f"
    "4dc5388ec9b9e93f31a7a4dccc0eea3f5fcd776d6762ea3f3616106eadb4ea3fa26c136db105eb3f2f7a42878455eb3f"
    "409f528e36a4eb3f3982bf2ad6f1eb3ff84e59f9703eec3f663b32a5138aec3f8f2672fec9d4ec3f4bb7800e9f1eed3f"
    "141fe4299d67ed3fc8b82300ceafed3f5676f1a93af7ed3f02eed2b5eb3dee3f046f7a33e983ee3fd282f9bd3ac9ee3f"
    "2a62f084e70def3f8cf6d854f651ef3fb2d7879e6d95ef3fb12efa7d53d8ef3fee3442e0560df03f9d8f39f5402ef03f"
    "ffa5169eea4ef03f14a0725b566ff03f0ff47190868ff03f1661bc847daff03f83cc4b663dcff03f6f08164bc8eef03f"
    "f1159532200ef13fc10f3107472df13f43918e9f3e4cf13f2020c4bf086bf13f37da781aa789f13f8b6dee511ba8f13f"
    "cf2af8f866c6f13f31d4e0938be4f13fa3a040998a02f23fecc6c4726520f23f22c3e97d1d3ef23ffe6ba90cb45bf23f"
    "81d31d662a79f23f1dd719c78196f23fdb2eb862bbb3f23f55b8e162d8d0f23f90a9cbe8d9edf23fda486e0dc10af33f"
    "33b9f4e18e27f33fa45e26704444f33fd752cabae260f33f6c5805be6a7df33f67b2b26fdd99f33f063db8bf3bb6f33f"
    "e31d569886d2f33f855a72debeeef33f769ee071e50af43f5f74a62dfb26f43fa6303ce80043f43f5ec7ca73f75ef43f"
    "38c3669edf7af43f308f4832ba96f43f5e4102f687b2f43fdd11b3ac49cef43f06a6381600eaf43f63555eefab05f53f"
    "5c8b0af24d21f53f50666ad5e63cf53fc9b21b4e7758f53f795f550e0074f53f15850ec6818ff53f5a1b2423fdaaf53f"
    "3f737dd172c6f53fd48c2f7be3e1f53f395e9fc84ffdf53fc51fa360b818f63fa4b0a2e81d34f63f0d26b704814ff63f"
    "7496c957e26af63f3931b1834286f63fb3b25029a2a1f63fbd43b3e801bdf63f54d3286162d8f63f56f86131c4f3f63f"
    "ec688bf7270ff73fc71469518e2af73fddee70dcf745f73f2073e5356561f73f4af4effad67cf73f94bdbac84d98f73f"
    "0a148b3ccab3f73ffc22dbf34ccff73fe7de738cd6eaf73f1fea86a46706f83f7786c8da0022f83f169f89cea23df83f"
    "bef5d11f4e59f83fc77e7a6f0375f83f2ef7475fc390f83f44c005928eacf83f9d0ca1ab65c8f83f286a445149e4f83f"
    "91b573293a00f93f498328dc381cf93ffe0aef124638f93f8ba203796254f93fefd570bb8e70f93f332a2e89cb8cf93f"
    "c1993f9319a9f93f2ed9d58c79c5f93f14746f2bece1f93f4dd2fa2672fef93f9636f9390c1bfa3f5ec8a221bb37fa3f"
    "8bbb0b9e7f54fa3fa7a94a725a71fa3f3f31a0644c8efa3f0af19f3e56abfa3fcff55acd78c8fa3f38b38be1b4e5fa3f"
    "1ba1c34f0b03fb3f5c989af07c20fb3f010ce0a00a3efb3f043dce41b55bfb3f28893fb97d79fb3f3df7e5f16497fb3f"
    "6e2585db6bb5fb3fa2c02e6b93d3fb3f82ae819bdcf1fb3fa016ec6c4810fc3f2d7af0e5d72efc3f1d0d6e138c4dfc3f"
    "0587ec08666cfc3f17a6ebe0668bfc3faba236bd8faafc3f90d63bc7e1c9fc3f37e068305ee9fc3f6e8f8b320609fd3f"
    "20ef3710db28fd3f47c63315de48fd3f23f1e7961069fd3fa4fbd7f47389fd3f6e6e209909aafd3f0c49fcf8d2cafd3f"
    "342e5295d1ebfd3f19d249fb060dfe3ff346eac4742efe3f86d1c1991c50fe3f23fe972f0072fe3f09bf2a4b2194fe3f"
    "086ff7c081b6fe3f3aa7107623d9fe3fa9ec016108fcfe3f2153c28a321fff3f6d4db70fa442ff3f6801c9205f66ff3f"
    "82978904668aff3fbf227118bbaeff3f85e72fd260d3ff3f0bf618c159f8ff3f75a0d347d40e004047c98f02a8210040"
    "ab02a983a9340040c7f53e4eda4700407eb3adf63b5b00406926a723d06e0040182e638f9882004055a2e80897960040"
    "c5c07175cdaa004049d4eed13dbf0040323daa34ead30040946511cfd4e80040b89fa6effffd0040437020046e130140"
    "375dbb9b212901406f09c4691d3f01403d2e604864550140f5ee9d3bf96b01406212d274df820140adeb4e561a9a0140"
    "8f2f7f77adb1014095a671a99cc9014039aee4fbebe1014001d9e2c29ffa014082cc049dbc130240efd36f7a472d0240"
    "249caca445470240e05876c7bc6102402e59a8fab27c0240780e77cd2e980240530a2a5337b4024097db9631d4d00240"
    "f578a9b10dee0240eeae56d2ec0b0340a3a4685e7b2a0340a312ae05c449034040a8337ad26903400a415692b38a0340"
    "fa88ae7075ac0340a60417b327cf034075f460aadbf20340dbe5b99ca4170440945e5415983d0440163aa744ce640440"
    "bd439c75628d0440285a6b9d73b704400389cd0d25e3044042ace9539f100540437e3a52114005401ce44aa9b1710540"
    "d98d718bc0a50540fed03a248adc05404b1e86cf69160640ea6a007bce530640c2e59fbe4095064031e2098d6bdb0640"
    "337a5ff02827074072060956957907408bced6f42dd4074033f2290503390840147caabf0fab084096446f94e02e0940"
    "aa574001eecb094059779478dc8f0a40b0fd78381f980b4033ad0982b43b0d40"
)
_ZIG_WI255 = 3.910757959524916   # v / f(r): base-strip width multiplier
_ZIG_INV_R = 0.27366123732975828  # 1/r: tail sampling multiplier constant


def _zig_tables():
    """(W, A, F): per-index multiplier, accept bound, and f(x[i]) table."""
    global _ZIG_CACHE
    try:
        return _ZIG_CACHE
    except NameError:
        pass
    xs = np.frombuffer(bytes.fromhex("".join(_ZIG_XS_HEX.split())),
                       dtype="<f8").copy()
    W = np.empty(256)
    W[:255] = xs[1:256]
    W[255] = _ZIG_WI255
    A = np.empty(256)
    A[:255] = xs[:255]
    A[255] = xs[255]                  # r: beyond it -> tail sample
    F = np.exp(-0.5 * xs * xs)        # f at x[i] (edge-wedge test)
    _ZIG_CACHE = (W, A, F)
    return _ZIG_CACHE

def _draw(rng: MatlabRNG, distr, m, n):
    """Reference distr handles: 'rand', 'rand+c' (e.g. example_script11:66
    @(x,y) rand(x,y); script-8 style rand+0.1), or 'randn'
    (e.g. example_script1:47 @(x,y) randn(x,y))."""
    if distr == "rand":
        return rng.rand(m, n)
    if distr == "randn":
        return rng.randn(m, n)
    if isinstance(distr, str) and distr.startswith("rand+"):
        return rng.rand(m, n) + float(distr[5:])
    raise ValueError(
        f"matlab_init_coupled can only replay rand/randn-family draws, "
        f"got {distr!r}")


def _matlab_orth(A):
    """MATLAB orth(A): left singular vectors up to the rank cutoff
    tol = max(size(A)) * eps(max(s)) (orth doc; SVD-based)."""
    U, s, _ = np.linalg.svd(A, full_matrices=False)
    if s.size == 0:
        return U[:, :0]
    tol = max(A.shape) * np.spacing(s[0])
    return U[:, : int(np.sum(s > tol))]


def matlab_create_coupled_data(spec, distr, lambdas, noise=0.0,
                               normalize_columns=False, rng=None,
                               seed="default", post_uncoupled=None,
                               coupl_trafo=None, coupl_trafo2=None,
                               bk_style="shift", case1_max_override=True,
                               device=None, dtype=None):
    """Replay of create_coupled_data.m's random draws, in the reference
    factory's order on a MATLAB twister stream: uncoupled factor matrices in
    dataset/mode order with the PAR2 Bk built per `bk_style`
    (create_coupled_data.m:55-75 and the specialized generators), coupled
    factors in coupling-id order for types 0-5 (:78-150,
    create_coupled_data_example13.m:137-151), then the data blocks with
    their noise tensors: the CP noise randn(size(X)) and the per-slice PAR2
    randn(size(Xk)) are drawn column-major and consumed even at noise level
    0, as MATLAB does (:160-162, :175-181), so the stream position after
    this call is the reference's when init_coupled_AOADMM_CMTF runs next
    (pass the returned rng to matlab_init_coupled).

    Every draw is MATLAB's bit for bit; the linear algebra the coupled and
    orth paths route them through (pinv/lstsq for types 1/2/5, SVD-based
    orth, economy qr + svd for the smooth Bk) matches MATLAB's LAPACK to
    rounding.

    bk_style: 'shift' (one draw + circshift per slice, equal sizes),
    'orth' (per-slice orth(distr(J_k, R)) after one consumed-and-discarded
    sz(1) x R draw, create_irregularPARAFAC2_...m:63-70) or 'smooth' (one
    discarded draw, B = randn(R,R), per slice [Pk,~] = qr(randn(4,R),0);
    Bk = Morth @ Pk @ B, create_coupled_data_smoothBks.m:66-84).
    case1_max_override: the main factory and example13 re-pick mode1 as the
    largest coupled mode for types 1/5 (create_coupled_data.m:96-97); the
    specialized generators keep cp_modes(1)
    (create_coupled_data_example5simplex.m:100-110): False for those.
    post_uncoupled(A, rng): an optional draw-consuming hook between the
    uncoupled and coupled phases (e.g. the piecewise-constant overwrite of
    create_CP_data_example10piecewiseconstant.m:78-89).
    Frobenius losses only.  Returns (data: ProblemData on `device` in
    `dtype`, Atrue (numpy), Delta: dict per cid, rng).
    """
    from matlab_code_tpu_torch.problem import PAR2
    from matlab_code_tpu_torch.utils.datagen import (
        resolve_device, to_problem_data)

    device, dtype = resolve_device(device, dtype)
    rng = MatlabRNG(seed) if rng is None else rng
    nb = spec.nb_modes
    P = len(spec.datasets)
    noise = [noise] * P if np.isscalar(noise) else list(noise)
    A = [None] * nb
    Delta = {}
    H = list(coupl_trafo) if coupl_trafo is not None else [None] * nb
    H2 = list(coupl_trafo2) if coupl_trafo2 is not None else [None] * nb
    H = [None if h is None else np.asarray(h, float) for h in H]
    H2 = [None if h is None else np.asarray(h, float) for h in H2]

    def norm_cols(M):
        return M / np.linalg.norm(M, axis=0, keepdims=True)

    # uncoupled factor matrices (create_coupled_data.m:55-75)
    for p, ds in enumerate(spec.datasets):
        if ds.loss != "Frobenius":
            raise NotImplementedError(
                "matlab_create_coupled_data replays Frobenius flows only "
                "(poissrnd/gamrnd are not reproduced)")
        R = len(lambdas[p])
        for n in ds.modes:
            if spec.coupling_id(n) != 0:
                continue
            if ds.model == PAR2 and ds.modes.index(n) == 1:
                sizes = spec.par2_slice_sizes(p)
                # the reference draws distr(sz{n}(1), R) first for every
                # style; shift uses it, orth/smooth discard it
                AA = _draw(rng, distr[n], sizes[0], R)
                if normalize_columns:
                    AA = norm_cols(AA)
                if bk_style == "shift":
                    if len(set(sizes)) > 1:
                        raise NotImplementedError(
                            "shift-PARAFAC replay needs equal slice sizes "
                            "(create_coupled_data.m:64-72)")
                    A[n] = [np.roll(AA, k, axis=0)
                            for k in range(len(sizes))]
                elif bk_style == "orth":
                    A[n] = [_matlab_orth(_draw(rng, distr[n], J, R))
                            for J in sizes]
                elif bk_style == "smooth":
                    if len(set(sizes)) > 1:
                        raise NotImplementedError(
                            "smooth Bk replay needs equal slice sizes "
                            "(create_coupled_data_smoothBks.m:70-77)")
                    B = rng.randn(R, R)
                    szBk = sizes[0]
                    x = np.linspace(-1.0, 1.0, szBk)
                    M = np.stack([np.ones(szBk), x, x ** 2, x ** 3],
                                 axis=1)
                    Morth = np.linalg.svd(M, full_matrices=False)[0]
                    Bks = []
                    for _J in sizes:
                        Pk = np.linalg.qr(rng.randn(4, R),
                                          mode="reduced")[0]
                        Bk = Morth @ (Pk @ B)
                        if normalize_columns:
                            Bk = norm_cols(Bk)
                        Bks.append(Bk)
                    A[n] = Bks
                else:
                    raise ValueError(f"unknown bk_style {bk_style!r}")
            else:
                An = _draw(rng, distr[n], spec.mode_sizes[n], R)
                if normalize_columns:
                    An = norm_cols(An)
                A[n] = An

    if post_uncoupled is not None:
        post_uncoupled(A, rng)

    # coupled modes (create_coupled_data.m:78-150; type 5 per
    # create_coupled_data_example13.m:137-151)
    for cid in range(1, spec.coupling.n_couplings + 1):
        ctype = spec.coupling.coupling_type[cid - 1]
        cmodes = list(spec.coupled_modes_of(cid))
        mode1 = cmodes[0]
        # p_mode1 is resolved before the case-1/5 max override and not
        # recomputed after it (create_coupled_data.m:83,96-98)
        R1 = len(lambdas[spec.which_p(mode1)])
        if ctype == 0:
            A[mode1] = _draw(rng, distr[mode1], spec.mode_sizes[mode1], R1)
            if normalize_columns:
                A[mode1] = norm_cols(A[mode1])
            for j in cmodes[1:]:
                A[j] = A[mode1].copy()
        elif ctype in (1, 5):
            if case1_max_override:   # :96-97, the largest coupled mode
                mode1 = cmodes[int(np.argmax(
                    [spec.mode_sizes[m] for m in cmodes]))]
            A[mode1] = _draw(rng, distr[mode1], spec.mode_sizes[mode1], R1)
            if normalize_columns:
                A[mode1] = norm_cols(A[mode1])
            Delta[cid] = H[mode1] @ A[mode1]
            for j in cmodes:
                if j != mode1:
                    A[j] = np.linalg.pinv(H[j]) @ Delta[cid]
            if ctype == 5:           # example13:150
                A[mode1] = A[mode1] @ H2[mode1]
        elif ctype == 2:
            Delta[cid] = _draw(rng, distr[mode1], spec.mode_sizes[mode1],
                               H[mode1].shape[1])
            if normalize_columns:
                Delta[cid] = norm_cols(Delta[cid])
            for j in cmodes:
                # lsqminnorm(H', Delta')' (create_coupled_data.m:117-119):
                # the min-norm solve, lstsq's up to LAPACK roundoff
                A[j] = np.linalg.lstsq(H[j].T, Delta[cid].T,
                                       rcond=None)[0].T
                zerocols = np.flatnonzero(np.abs(A[j]).sum(axis=0) == 0)
                if zerocols.size:    # :120-126 refill all-zero columns
                    fill = _draw(rng, distr[j], spec.mode_sizes[j],
                                 zerocols.size)
                    if normalize_columns:
                        fill = norm_cols(fill)
                    A[j][:, zerocols] = fill
        elif ctype == 3:
            Delta[cid] = _draw(rng, distr[mode1], H[mode1].shape[1], R1)
            if normalize_columns:
                Delta[cid] = norm_cols(Delta[cid])
            for j in cmodes:
                A[j] = H[j] @ Delta[cid]
        elif ctype == 4:
            Delta[cid] = _draw(rng, distr[mode1], spec.mode_sizes[mode1],
                               H[mode1].shape[0])
            if normalize_columns:
                Delta[cid] = norm_cols(Delta[cid])
            for j in cmodes:
                A[j] = Delta[cid] @ H[j]

    # data blocks + noise (create_coupled_data.m:152-183); MATLAB randn(sz)
    # fills column-major and is drawn even when the noise level is 0
    X = [None] * P
    for p, ds in enumerate(spec.datasets):
        lam = np.asarray(lambdas[p], dtype=float)
        if ds.model == PAR2:
            C = A[ds.modes[2]]
            Bks = A[ds.modes[1]]
            slices = []
            for k in range(C.shape[0]):
                Mk = A[ds.modes[0]] @ np.diag(lam * C[k]) @ Bks[k].T
                Nk = rng.randn(Mk.size).reshape(Mk.shape, order="F")
                s = noise[p] * np.linalg.norm(Mk) / np.linalg.norm(Nk)
                slices.append(Mk + s * Nk)
            X[p] = slices
        else:
            facs = [A[n] for n in ds.modes]
            subs = "abcdef"[: len(facs)]
            eq = ",".join(f"{s}r" for s in subs) + ",r->" + subs
            M = np.einsum(eq, *facs, lam)
            N = rng.randn(M.size).reshape(M.shape, order="F")
            s = noise[p] * np.linalg.norm(M) / np.linalg.norm(N)
            X[p] = M + s * N

    data = to_problem_data(spec, X, H, H2, device, dtype)
    return data, A, Delta, rng


def matlab_init_coupled(spec, distr, normalize=False, delta_shapes=None,
                        seed="default", rng=None, coupl_trafo=None,
                        device=None, dtype=None):
    """Replay of init_coupled_AOADMM_CMTF.m's random draws, in the
    reference's order (init:46-96 factor matrices with PAR2 DeltaB/mu
    interleaved, :99-129 constraint aux Z = prox(draw, 1) and duals,
    :132-169 coupling Delta and duals), packaged as the port's SolverState
    on `device` in `dtype` (PAR2 Bk stacks padded to (K, Jmax, R)).  The
    constraint auxiliaries go through the port's proxes
    (models/solver.build_proxes), so on the card a unimodal, TV or other
    sequential prox runs its kernel.  distr: per-mode 'rand' / 'randn' /
    'rand+c'.  coupl_trafo: per-mode H matrices, needed for coupling types
    1-4, whose Delta/dual shapes derive from size(H{mode1}) (init:143-162).
    delta_shapes: {cid: (rows, cols)}, needed for type 5, whose Delta size
    comes from the explicit 'Delta' argument (init:163-167,
    example_script13:120).
    """
    import torch

    from matlab_code_tpu_torch.models.solver import build_proxes
    from matlab_code_tpu_torch.problem import PAR2
    from matlab_code_tpu_torch.state import SolverState
    from matlab_code_tpu_torch.utils.datagen import resolve_device

    device, dtype = resolve_device(device, dtype)
    rng = MatlabRNG(seed) if rng is None else rng
    nb = spec.nb_modes
    P = len(spec.datasets)
    ncpl = len(spec.coupling.coupling_type)
    fac = [None] * nb
    Pfac = [None] * P
    DeltaB = [None] * P
    mu_DeltaB = [None] * P

    def t(a):      # row-major, as jnp arrays are (MATLAB draws fill by column)
        return torch.tensor(np.ascontiguousarray(a, np.float64), dtype=dtype,
                            device=device)

    def norm_cols(A):
        return A / np.linalg.norm(A, axis=0, keepdims=True)

    # factor matrices (init:46-96)
    for p, ds in enumerate(spec.datasets):
        R = ds.rank
        for n in ds.modes:
            if ds.model == PAR2 and ds.modes.index(n) == 1:
                K = spec.par2_K(p)
                Jmax = spec.par2_Jmax(p)
                sizes = spec.par2_slice_sizes(p)
                DeltaB[p] = t(rng.rand(R, R))               # init:76
                Bs = np.zeros((K, Jmax, R))
                Ps = np.zeros((K, Jmax, R))
                mus = np.zeros((K, Jmax, R))
                for k, J in enumerate(sizes):               # init:77-87
                    Bk = _draw(rng, distr[n], J, R)
                    mus[k, :J] = rng.rand(J, R)
                    if normalize:
                        Bk = norm_cols(Bk)
                    Bs[k, :J] = Bk
                    Ps[k, :J] = np.eye(J, R)
                fac[n] = t(Bs)
                Pfac[p] = t(Ps)
                mu_DeltaB[p] = t(mus)
            else:
                A = _draw(rng, distr[n], spec.mode_sizes[n], R)
                if normalize:                               # init:89-93
                    A = norm_cols(A)
                fac[n] = t(A)

    # constraint auxiliaries (init:99-129)
    proxes, _ = build_proxes(spec)
    constraint_fac = [None] * nb
    constraint_dual = [None] * nb
    for p, ds in enumerate(spec.datasets):
        R = ds.rank
        for n in ds.modes:
            if not spec.is_constrained(n):
                continue
            if ds.model == PAR2 and ds.modes.index(n) == 1:
                is_tpar2 = spec.constraints[n].kind == "tPARAFAC2"
                Zs = torch.zeros(fac[n].shape, dtype=dtype, device=device)
                duals = np.zeros(fac[n].shape)
                for k, J in enumerate(spec.par2_slice_sizes(p)):  # :105-114
                    z = t(_draw(rng, distr[n], J, R))
                    Zs[k, :J] = z if is_tpar2 else proxes[n](z, 1.0)
                    duals[k, :J] = rng.rand(J, R)
                constraint_fac[n] = Zs
                constraint_dual[n] = t(duals)
            else:                                           # init:116-125
                z = _draw(rng, distr[n], *fac[n].shape)
                constraint_fac[n] = proxes[n](t(z), 1.0)
                constraint_dual[n] = t(rng.rand(*fac[n].shape))

    # coupling Delta + duals (init:132-169); mode1 = first coupled mode in
    # all cases here (init has no case-1 max override)
    coupling_fac = [None] * ncpl
    coupling_dual = [None] * nb
    for cid in range(1, ncpl + 1):
        cmodes = spec.coupled_modes_of(cid)
        m1 = cmodes[0]
        ctype = spec.coupling.coupling_type[cid - 1]
        H1 = None if coupl_trafo is None else coupl_trafo[m1]
        if ctype == 0:
            shape = tuple(fac[m1].shape)
            dual = lambda m: shape
        elif ctype == 1:                                # init:143-147
            shape = (np.asarray(H1).shape[0], fac[m1].shape[-1])
            dual = lambda m: shape
        elif ctype == 2:                                # init:148-152
            shape = (fac[m1].shape[0], np.asarray(H1).shape[1])
            dual = lambda m: shape
        elif ctype == 3:                                # init:153-157
            shape = (np.asarray(H1).shape[1], fac[m1].shape[-1])
            dual = lambda m: tuple(fac[m].shape)
        elif ctype == 4:                                # init:158-162
            shape = (fac[m1].shape[0], np.asarray(H1).shape[0])
            dual = lambda m: tuple(fac[m].shape)
        else:                                           # 5, init:163-167
            if delta_shapes is None or cid not in delta_shapes:
                raise ValueError(
                    "coupling type 5 replay needs delta_shapes={cid: "
                    "(rows, cols)} (the reference passes the true Delta, "
                    "example_script13:120)")
            shape = tuple(delta_shapes[cid])
            dual = lambda m: (shape[0], fac[m].shape[-1])
        coupling_fac[cid - 1] = t(rng.rand(*shape))
        for m in cmodes:
            coupling_dual[m] = t(rng.rand(*dual(m)))
    return SolverState(
        fac=tuple(fac), constraint_fac=tuple(constraint_fac),
        constraint_dual_fac=tuple(constraint_dual),
        coupling_fac=tuple(coupling_fac),
        coupling_dual_fac=tuple(coupling_dual),
        P=tuple(Pfac), DeltaB=tuple(DeltaB), mu_DeltaB=tuple(mu_DeltaB))
