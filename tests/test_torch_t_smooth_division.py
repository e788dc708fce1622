"""Kernel C's back-substitution division step (csrc/t_smooth.cu, qdiv),
emulated exactly on the CPU.

The kernel divides n by d'_k through d'_k's correctly rounded reciprocal
y with two corrections,

    q0 = RN(n y),  then twice  r = RN(d q - n),  q = RN(q - r y)  (fmas),

where n is zero or normal within a window and d within it, and takes the
full IEEE division on every other step.  q0 can be more than an ulp off,
outside the premise of Markstein's theorem; the first correction brings
q within an ulp, so the second is covered by it.  Here each operation is
carried out in exact rationals (fractions.Fraction) and rounded to
nearest even by hand, with IEEE's rules for the sign of a zero, and the
result is held to numpy's IEEE division on the operand classes the
kernel meets and the correction's hard cases (quotients next to a
rounding midpoint, built on purpose).  The window is read from the
kernel's source, and pairs just outside it show why the guard is there.
The card test (tests/test_torch_prox_cuda.py) holds the compiled step to
__fdiv_rn and __ddiv_rn on 10^7 pairs a dtype.
"""
import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

SOURCE = (Path(__file__).resolve().parent.parent / "matlab_code_tpu_torch"
          / "csrc" / "t_smooth.cu")
# (significand bits, smallest normal exponent, largest exponent, numpy type)
FORMATS = {"float32": (24, -126, 127, np.float32),
           "float64": (53, -1022, 1023, np.float64)}


def window(fmt):
    """(lo, hi) of the correction's window as csrc/t_smooth.cu states it."""
    text = SOURCE.read_text()
    name = {"float32": "float", "float64": "double"}[fmt]
    m = re.search(r"struct Window<" + name + r"> \{\s*static constexpr " + name
                  + r" lo = (0x1p-?\d+)f?, hi = (0x1p-?\d+)f?;", text)
    assert m, "the Window constants of csrc/t_smooth.cu"
    return float.fromhex(m.group(1)), float.fromhex(m.group(2))


def rne(x, fmt):
    """Fraction x rounded to nearest even in fmt, as a Python float
    (subnormals kept, overflow to inf); 0 for x = 0 (the caller signs it)."""
    p, emin, emax, _ = FORMATS[fmt]
    if x == 0:
        return 0.0
    sign = -1.0 if x < 0 else 1.0
    num, den = abs(x.numerator), x.denominator
    e = num.bit_length() - den.bit_length()
    if (num < den << e) if e >= 0 else (num << -e < den):
        e -= 1
    qe = max(e, emin) - (p - 1)
    if qe >= 0:
        den <<= qe
    else:
        num <<= -qe
    fl, rem = divmod(num, den)
    if 2 * rem > den or (2 * rem == den and fl & 1):
        fl += 1
    if fl == 2 ** p:
        fl, qe = fl >> 1, qe + 1
    if qe + p - 1 > emax:
        return sign * math.inf
    return sign * math.ldexp(fl, qe)


def mul(a, b, fmt):
    if not (math.isfinite(a) and math.isfinite(b)):
        return a * b          # inf or NaN, as in every format
    exact = Fraction(a) * Fraction(b)
    return rne(exact, fmt) if exact else math.copysign(0.0, a) * math.copysign(1.0, b)


def fma(a, b, c, fmt):
    """RN(a b + c) once; an exact zero takes IEEE's sign (the common sign
    of two zero terms, else +0)."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return a * b + c      # inf or NaN, as in every format
    if not math.isfinite(c):
        return c
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact:
        return rne(exact, fmt)
    prod_zero = a == 0 or b == 0
    prod_neg = (math.copysign(1.0, a) * math.copysign(1.0, b)) < 0
    if prod_zero and c == 0 and prod_neg and math.copysign(1.0, c) < 0:
        return -0.0
    return 0.0


def recip_or_zero(d, fmt):
    lo, hi = window(fmt)
    return rne(1 / Fraction(d), fmt) if lo <= d <= hi else 0.0


def fast_path(n, d, fmt):
    """The kernel's guard: the correction's result is taken where y is not
    0 (d within the window) and n is zero or normal within the window."""
    lo, hi = window(fmt)
    a = abs(n)
    return recip_or_zero(d, fmt) != 0.0 and a <= hi and (a >= lo or n == 0)


def corrected(n, d, fmt):
    """The five operations of the fast path, as the kernel runs them."""
    y = recip_or_zero(d, fmt)
    q = mul(n, y, fmt)
    for _ in range(2):
        q = fma(-fma(d, q, -n, fmt), y, q, fmt)
    return q


def near_midpoint(p, count, rng):
    """count (A, B) integer significand pairs of precision p whose quotient
    lies within |t| / B of a rounding midpoint, t in {+-1, +-3, +-5}
    (in units where the midpoints are the odd integers M of p + 1 bits):
    B odd, M = t / B modulo 2^(p + 1), A = (B M - t) / 2^(p + 1), so that
    A / B = (M - t / B) / 2^(p + 1).  The quotients of two p-bit numbers
    come no closer to a midpoint than this."""
    out = []
    mod = 2 ** (p + 1)
    while len(out) < count:
        B = int(rng.integers(2 ** (p - 2), 2 ** (p - 1))) * 2 + 1
        t = int(rng.choice([-5, -3, -1, 1, 3, 5]))
        M = t * pow(B, -1, mod) % mod
        if M >= 2 ** p:
            out.append(((B * M - t) // mod, B))
    return out


def bits(x, fmt):
    npdt = FORMATS[fmt][3]
    return np.array([x], dtype=npdt).view(np.int32 if fmt == "float32" else np.int64)[0]


def ieee(n, d, fmt):
    npdt = FORMATS[fmt][3]
    with np.errstate(all="ignore"):
        return float(npdt(n) / npdt(d))


def operand_pairs(cls, fmt, count, seed):
    """count (n, d) pairs of one class, as Python floats exact in fmt."""
    p, _, _, npdt = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(count) < 0.5, -1.0, 1.0)
    if cls == "random":
        n = sign * rng.uniform(1, 2, count) * 2.0 ** rng.integers(-40, 41, count)
        d = rng.uniform(1.0, 4000.0, count)
    elif cls == "all_ones_divisor":
        n = sign * rng.uniform(1, 2, count) * 2.0 ** rng.integers(-20, 21, count)
        d = (2.0 ** p - 1) * 2.0 ** rng.integers(-p - 20, -p + 22, count)
    elif cls == "eta_range":
        # d'_k for rho in [1e-6, 1e6] and eta in [1e-3, 1e6]: about 1e-6 to
        # 5e6; numerators r'_k - off x_{k+1} across the same scales
        d = 10.0 ** rng.uniform(-6.0, 6.7, count)
        n = sign * 10.0 ** rng.uniform(-12.0, 12.0, count)
    elif cls == "wide_numerators":
        n = sign * rng.uniform(1, 2, count) * 2.0 ** rng.integers(-60, 60, count)
        d = rng.uniform(1, 2, count) * 2.0 ** rng.integers(-60, 60, count)
    elif cls == "near_power_of_two":
        d = rng.uniform(1.0, 4000.0, count).astype(npdt)
        n = (d * 2.0 ** rng.integers(-30, 31, count)).astype(npdt)
        steps = rng.integers(-3, 4, count)
        for i, s in enumerate(steps):
            for _ in range(abs(int(s))):
                n[i] = np.nextafter(n[i], npdt(np.inf) if s > 0 else npdt(0))
        n = n * sign.astype(npdt)
    elif cls == "significands":
        n = sign * rng.uniform(1, 2, count)
        d = rng.uniform(1, 2, count)
    elif cls == "near_midpoint":
        AB = np.array(near_midpoint(p, count, rng), dtype=np.float64)
        n = sign * AB[:, 0] * 2.0 ** (rng.integers(-30, 31, count) - p)
        d = AB[:, 1] * 2.0 ** (rng.integers(-30, 31, count) - p)
    elif cls == "zeros":
        n = np.where(rng.random(count) < 0.5, 0.0, -0.0)
        d = rng.uniform(1, 2, count) * 2.0 ** rng.integers(-60, 60, count)
    else:
        raise ValueError(cls)
    n, d = np.asarray(n).astype(npdt), np.asarray(d).astype(npdt)
    return [(float(a), float(b)) for a, b in zip(n, d)]


CLASSES = ("random", "all_ones_divisor", "eta_range", "wide_numerators",
           "near_power_of_two", "significands", "zeros", "near_midpoint")


@pytest.mark.parametrize("cls", CLASSES)
def test_torch_t_smooth_correction_float32_is_ieee_division(cls):
    """Inside the window the two corrections give numpy's float32 n / d,
    the sign of a zero included, on 5000 pairs of each class."""
    checked = 0
    for n, d in operand_pairs(cls, "float32", 5000, CLASSES.index(cls) + 1):
        assert fast_path(n, d, "float32"), (n, d)
        assert bits(corrected(n, d, "float32"), "float32") == \
            bits(ieee(n, d, "float32"), "float32"), (cls, n, d)
        checked += 1
    assert checked == 5000


@pytest.mark.parametrize("cls", ("random", "all_ones_divisor",
                                 "near_power_of_two", "zeros",
                                 "near_midpoint"))
def test_torch_t_smooth_correction_float64_is_ieee_division(cls):
    """The same in float64 (window [2^-500, 2^500]), 1500 pairs a class."""
    for n, d in operand_pairs(cls, "float64", 1500, 40 + CLASSES.index(cls)):
        assert fast_path(n, d, "float64"), (n, d)
        assert bits(corrected(n, d, "float64"), "float64") == \
            bits(ieee(n, d, "float64"), "float64"), (cls, n, d)


def test_torch_t_smooth_correction_small_precision_exhaustive():
    """Every pair of 8-bit significands (a binary format of precision 8,
    no exponent limits), the hardest cases of the wider formats in
    miniature: q0 = RN(a y) is more than an ulp from a / b for some of
    them (so Markstein's premise fails for the first correction), the
    first correction leaves every quotient within an ulp (the premise of
    the second), and the second gives the correctly rounded quotient for
    all 16,384."""
    p = 8
    half = 2 ** (p - 1)

    def rnd(x):   # precision p, unbounded exponent
        num, den = x.numerator, x.denominator
        e = num.bit_length() - den.bit_length()
        if (num < den << e) if e >= 0 else (num << -e < den):
            e -= 1
        qe = e - (p - 1)
        num, den = (num, den << qe) if qe >= 0 else (num << -qe, den)
        fl, rem = divmod(num, den)
        if 2 * rem > den or (2 * rem == den and fl & 1):
            fl += 1
        return Fraction(fl) * Fraction(2) ** qe

    def ulp(x):   # of a / b in (1/2, 2)
        return Fraction(1, half) if x >= 1 else Fraction(1, 2 * half)

    worst_q0 = worst_q1 = Fraction(0)
    wrong = 0
    for ia in range(half, 2 * half):
        a = Fraction(ia, half)
        for ib in range(half, 2 * half):
            b = Fraction(ib, half)
            y = rnd(1 / b)
            q0 = rnd(a * y)
            q1 = rnd(q0 - rnd(b * q0 - a) * y)
            q2 = rnd(q1 - rnd(b * q1 - a) * y)
            worst_q0 = max(worst_q0, abs(q0 - a / b) / ulp(a / b))
            worst_q1 = max(worst_q1, abs(q1 - a / b) / ulp(a / b))
            wrong += q2 != rnd(a / b)
    assert worst_q0 > 1 and worst_q1 < 1
    assert wrong == 0


@pytest.mark.parametrize("fmt", ("float32", "float64"))
def test_torch_t_smooth_guard_excludes_what_the_correction_cannot_hold(fmt):
    """The guard sends to the full division every operand the correction
    cannot hold: subnormal, infinite and NaN numerators, numerators and
    divisors past the window, zero, negative and subnormal divisors.  Just
    past the window the correction does give wrong quotients (an
    intermediate overflows or underflows), so the guard is needed; inside
    it, at its edges, the correction holds."""
    p, emin, emax, npdt = FORMATS[fmt]
    lo, hi = window(fmt)
    tiny = float(np.finfo(npdt).smallest_subnormal)
    for n in (tiny, -tiny * 5, math.ldexp(1.0, emin) / 2, math.inf, -math.inf,
              math.nan, hi * 2, -hi * 2, lo / 2):
        assert not fast_path(n, 1.5, fmt), n
    for d in (0.0, -0.0, -1.5, tiny, math.inf, math.nan, hi * 2, lo / 2):
        assert not fast_path(1.5, d, fmt), d
    # the edges themselves are inside and hold
    for n, d in ((lo, hi), (hi, lo), (-lo, lo), (hi, hi), (lo * 1.5, hi / 1.25)):
        n, d = float(npdt(n)), float(npdt(d))
        assert fast_path(n, d, fmt)
        assert bits(corrected(n, d, fmt), fmt) == bits(ieee(n, d, fmt), fmt)
    # past the window: quotients that overflow in q0 (n / d too, where
    # the corrections turn q0's inf into a NaN), numerators so small that
    # the residual loses bits
    big = float(np.finfo(npdt).max)
    wrong = []
    for n, d in ((big, float(npdt(1.0 + 2.0 ** (1 - p)))),
                 (big * 0.75, float(npdt(0.9))), (big, 0.5)):
        if bits(corrected(n, d, fmt), fmt) != bits(ieee(n, d, fmt), fmt):
            wrong.append((n, d))
    rng = np.random.default_rng(3)
    for _ in range(400):
        n = float(npdt(rng.integers(1, 2 ** 20) * tiny))
        d = float(npdt(rng.uniform(1.0, 2.0)))
        if bits(corrected(n, d, fmt), fmt) != bits(ieee(n, d, fmt), fmt):
            wrong.append((n, d))
    assert wrong, "the correction outside its window was never wrong"
