"""Fixed-point big-number arithmetic on 16-bit digit arrays (device).

Counterpart of ``HpSharkFloat``
(``HpSharkFloatLib/HpSharkFloat.h:243-321``) specialized to the z←z²+c
iteration: numbers are **sign-magnitude fixed point**

    value = sign · Σ d_i·2^(16·i) / 2^(16·FRAC)   (digits uint32 < 2^16)

with INT_DIGITS = 2 integer digits (|z| bounded by the escape radius) —
the reference instead carries a per-number exponent; a fixed exponent
removes all normalization shifts from the hot loop (the reference's
``FinalizeNormalize``/funnel-shift machinery, ``MultiplyNTT.cu:47-153``,
``Add.cu:50``) at the cost of fixed precision, which is exactly what a
reference orbit needs.

Multiplication: 3-way shared-transform NTT (x², y², x·y from two forward
transforms — mirrors ``RunNTT_3Way_Multiply``, ``MultiplyNTT.cu:2943``),
CRT over two 31-bit primes, parallel carry propagation via a
fixed-point-free while loop (the reference uses grid-wide sync passes).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.ops.bignum import ntt as N
from fractalshark_tpu.ops.bignum.u32 import add_carry, mul_full, sub_borrow

INT_DIGITS = 2          # 32 integer bits: |z²+c| < 256 plus headroom
DIGIT_BITS = 16
DIGIT_MASK = np.uint32(0xFFFF)

_INV_P1_MOD_P2 = pow(N.P1, -1, N.P2)


@dataclass(frozen=True)
class FixedSpec:
    """Shape/precision of one fixed-point format."""
    digits: int              # D: total 16-bit digits
    nfft: int                # transform size ≥ 2D

    @property
    def frac_digits(self) -> int:
        return self.digits - INT_DIGITS

    @property
    def frac_bits(self) -> int:
        return DIGIT_BITS * self.frac_digits

    @staticmethod
    def for_limbs(limbs32: int) -> "FixedSpec":
        d = 2 * limbs32
        nfft = 1 << (2 * d - 1).bit_length()
        return FixedSpec(digits=d, nfft=nfft)


# ----------------------------------------------------------- host converts


def hp_to_digits(x: HighPrecision, spec: FixedSpec) -> tuple[int, np.ndarray]:
    """(sign, digit array) of round(x · 2^frac_bits)."""
    sh = x.exp + spec.frac_bits
    mant = x.mant << sh if sh >= 0 else _round_shift(x.mant, -sh)
    sign = -1 if mant < 0 else 1
    mant = abs(mant)
    out = np.zeros(spec.digits, np.uint32)
    i = 0
    while mant and i < spec.digits:
        out[i] = mant & 0xFFFF
        mant >>= 16
        i += 1
    if mant:
        raise OverflowError("value exceeds fixed-point range")
    return sign, out


def _round_shift(m: int, s: int) -> int:
    if s == 0:
        return m
    half = 1 << (s - 1)
    return (m + half) >> s if m >= 0 else -((-m + half) >> s)


def digits_to_int(digits: np.ndarray) -> int:
    v = 0
    for i, d in enumerate(np.asarray(digits).tolist()):
        v += int(d) << (16 * i)
    return v


def digits_to_float(sign: int, digits: np.ndarray, spec: FixedSpec) -> float:
    import math
    v = digits_to_int(digits)
    if v == 0:
        return 0.0
    nb = v.bit_length()
    top = v >> max(0, nb - 56)
    return sign * math.ldexp(top, max(0, nb - 56) - spec.frac_bits)


# ------------------------------------------------------------ carry/borrow


# Carry/borrow resolution is CARRY-LOOKAHEAD, not a ripple: a data-
# dependent while-loop moves a carry ONE digit per trip, and real
# operands hit the pathological case — View #30's center is -2+eps,
# whose magnitude is ~380,000 consecutive 1-bits (all-0xFFFF digits),
# so every +c would ripple across ~23k digits one trip at a time.  One
# bulk trip reduces all carries to <=1, then a Kogge-Stone (generate,
# propagate) prefix scan resolves every chain in log2(L) passes,
# data-independent (the reference bounds its grid carry passes the same
# way, Add.cu).


def _shift_up(a):
    return jnp.concatenate(
        [jnp.zeros(a.shape[:-1] + (1,), jnp.uint32), a[..., :-1]],
        axis=-1)


def _ks_prefix(g, p):
    """Inclusive Kogge-Stone/Hillis-Steele prefix of the carry monoid
    (g, p) along the last axis: G_i = OR over j<=i of (g_j AND p_{j+1}
    .. p_i).  Hand-rolled doubling — log2(L) fused pad+elementwise
    passes instead of jax.lax.associative_scan's gather-based
    lowering."""
    L = g.shape[-1]
    nd = g.ndim
    k = 1
    while k < L:
        padg = [(0, 0)] * (nd - 1) + [(k, 0)]
        gs = jnp.pad(g, padg)[..., :L]
        ps = jnp.pad(p, padg, constant_values=1)[..., :L]
        g = g | (p & gs)
        p = p & ps
        k <<= 1
    return g


def carry_propagate(acc):
    """Normalize an array of per-digit sums (each < 2^32) into
    canonical 16-bit digits along the LAST axis (carry-lookahead; cost
    is data-INDEPENDENT — a ripple loop hits pathological operands:
    View #30's center is -2+eps, i.e. ~23k consecutive 0xFFFF digits,
    and rippled one digit per trip)."""
    low = acc & DIGIT_MASK
    a = low + _shift_up(acc >> DIGIT_BITS)      # bulk trip: carries <= 1
    d = a & DIGIT_MASK
    g = a >> DIGIT_BITS                          # in {0, 1}
    prop = (d == DIGIT_MASK).astype(jnp.uint32)
    G = _ks_prefix(g, prop)
    return (d + _shift_up(G)) & DIGIT_MASK


def borrow_propagate(acc):
    """acc holds per-digit signed values as uint32 with wraparound
    (a_i − b_i, borrows in {0,1}); canonicalize along the last axis
    (borrow-lookahead)."""
    d0 = acc & DIGIT_MASK
    b0 = (acc >> DIGIT_BITS) & np.uint32(1)
    t = d0 - _shift_up(b0)                       # in [-1, 0xFFFF]
    d = t & DIGIT_MASK
    g = (t >> DIGIT_BITS) & np.uint32(1)
    prop = (d == 0).astype(jnp.uint32)
    G = _ks_prefix(g, prop)
    return (d - _shift_up(G)) & DIGIT_MASK


def add_mag(a, b):
    return carry_propagate(a + b)


def sub_mag(a, b):
    """|a| − |b| assuming a ≥ b (digitwise wraparound + borrow ripple)."""
    return borrow_propagate(a - b)


def cmp_mag(a, b):
    """-1 / 0 / +1 comparison of magnitudes."""
    diff = a != b
    idx = jnp.where(diff, jnp.arange(a.shape[0], dtype=jnp.int32),
                    -1).max()
    safe = jnp.maximum(idx, 0)
    av = a[safe]
    bv = b[safe]
    return jnp.where(idx < 0, 0,
                     jnp.where(av > bv, 1, -1)).astype(jnp.int32)


def signed_add(sa, a, sb, b):
    """(sign, digits) of sa·a + sb·b (signs are ±1 int32)."""
    same = sa == sb
    c = cmp_mag(a, b)
    big_a = c >= 0
    mag_same = add_mag(a, b)
    mag_diff = jnp.where(big_a, sub_mag(a, b), sub_mag(b, a))
    mag = jnp.where(same, mag_same, mag_diff)
    sign = jnp.where(same, sa, jnp.where(big_a, sa, sb))
    is_zero = jnp.max(mag) == 0
    return jnp.where(is_zero, 1, sign).astype(jnp.int32), mag


def shift_left_one_bit(a):
    """Multiply magnitude by 2."""
    return carry_propagate(a << 1)


# --------------------------------------------------------------- multiply


def _pointwise(fa, fb, prime_idx):
    p = (N.P1, N.P2)[prime_idx]
    pprime, _, _ = N._MONT[p]
    return N.mont_mul(fa, fb, p, pprime)


def _crt_rec(r1, r2):
    """(hi, lo) u32 pair of rec = CRT(r1 mod p1, r2 mod p2) ∈ [0, p1·p2):
    rec = r1 + p1·((r2 − r1)·p1^-1 mod p2) < p1·p2 ≈ 2^62."""
    p2 = np.uint32(N.P2)
    pprime2, _, _ = N._MONT[N.P2]
    # t = (r2 - r1) * inv_p1 mod p2 — via Montgomery: first reduce r1 mod p2
    r1m = jnp.where(r1 >= p2, r1 - p2, r1)
    diff = jnp.where(r2 >= r1m, r2 - r1m, r2 + p2 - r1m)
    inv_mont = np.uint32((_INV_P1_MOD_P2 << 32) % N.P2)
    t = N.mont_mul(diff, jnp.asarray(inv_mont), N.P2, pprime2)
    hi, lo = mul_full(t, jnp.asarray(np.uint32(N.P1)))
    lo2, c = add_carry(lo, r1)
    return hi + c, lo2


def _parts_acc(hi, lo, out_digits: int):
    """Scatter each 64-bit coefficient's four 16-bit parts into digit
    positions k..k+3 and sum (≤ 4 contributions per position)."""
    d0 = lo & DIGIT_MASK
    d1 = lo >> 16
    d2 = hi & DIGIT_MASK
    d3 = hi >> 16
    L = out_digits

    def shifted(part, k):
        return jnp.concatenate(
            [jnp.zeros((k,), jnp.uint32), part[:max(0, L - k)]])[:L]

    return (shifted(d0, 0) + shifted(d1, 1) +
            shifted(d2, 2) + shifted(d3, 3))


def _crt_to_digit_sums(r1, r2, out_digits: int, nfft: int, round_digit: int):
    """CRT-reconstruct convolution coefficients (mod p1, mod p2) into
    per-digit accumulator sums, then carry-propagate to canonical
    digits (coefficients are known non-negative)."""
    hi, lo = _crt_rec(r1, r2)
    acc = _parts_acc(hi, lo, out_digits)
    if round_digit >= 0:
        acc = acc.at[round_digit].add(np.uint32(1 << 15))
    return carry_propagate(acc)


_P1P2 = N.P1 * N.P2
_P1P2_HI = np.uint32(_P1P2 >> 32)
_P1P2_LO = np.uint32(_P1P2 & 0xFFFFFFFF)
_HALF_HI = np.uint32((_P1P2 >> 1) >> 32)
_HALF_LO = np.uint32((_P1P2 >> 1) & 0xFFFFFFFF)


def _crt_to_digit_sums_signed(r1, r2, out_digits: int, round_digit: int):
    """Signed CRT: coefficients are residues of a SIGNED value |v| ≪
    p1·p2/2 (e.g. x² − y² combined in the frequency domain). Splits
    each coefficient into a positive or negative magnitude (rec vs
    p1·p2 − rec), accumulates the two digit streams separately, and
    returns (sign, magnitude) via one signed subtract.

    Rounding adds the half-ulp to the positive stream, i.e.
    round-half-up on the signed value (≤ 1 ulp from the magnitude
    rounding used elsewhere — far below the f64 shadow precision)."""
    hi, lo = _crt_rec(r1, r2)
    neg = (hi > _HALF_HI) | ((hi == _HALF_HI) & (lo > _HALF_LO))
    # magnitude of the negative branch: p1·p2 − rec
    nlo, bb = sub_borrow(jnp.broadcast_to(_P1P2_LO, lo.shape), lo)
    nhi = _P1P2_HI - hi - bb
    zero = np.uint32(0)
    acc_p = _parts_acc(jnp.where(neg, zero, hi),
                       jnp.where(neg, zero, lo), out_digits)
    acc_n = _parts_acc(jnp.where(neg, nhi, zero),
                       jnp.where(neg, nlo, zero), out_digits)
    if round_digit >= 0:
        acc_p = acc_p.at[round_digit].add(np.uint32(1 << 15))
    pos = carry_propagate(acc_p)
    negd = carry_propagate(acc_n)
    return signed_add(jnp.int32(1), pos, jnp.int32(-1), negd)


def multiply_nr(ax, ay, adx, ady, spec: FixedSpec):
    """NR-mode multiply: alongside (x², y², x·y), the four cross
    products with the derivative (x·dx, x·dy, y·dx, y·dy — the
    reference's W0..W3, ``MultiplyNTT.cu:3536-3543``), all sharing ONE
    [8, n] forward and ONE [14, n] inverse pass."""
    nf = spec.nfft
    D = spec.digits
    pad = nf - D

    def padv(v):
        return jnp.concatenate([v, jnp.zeros((pad,), jnp.uint32)])

    vx, vy, vdx, vdy = padv(ax), padv(ay), padv(adx), padv(ady)
    stacked = jnp.stack([vx, vx, vy, vy, vdx, vdx, vdy, vdy])
    four_step = nf >= 8192
    f = (N.fourstep_forward(stacked, nf) if four_step
         else N.shoup_forward(stacked, nf))
    fx = (f[0], f[1])
    fy = (f[2], f[3])
    fdx = (f[4], f[5])
    fdy = (f[6], f[7])
    pairs = [(fx, fx), (fy, fy), (fx, fy),           # xx, yy, xy
             (fx, fdx), (fx, fdy), (fy, fdx), (fy, fdy)]  # W0..W3
    a_ops = jnp.stack([a[pi] for (a, b) in pairs for pi in range(2)])
    b_ops = jnp.stack([b[pi] for (a, b) in pairs for pi in range(2)])
    p_col, pp_col = N._row_consts(14)
    prod = N._mont_mul_rows(a_ops, b_ops, p_col, pp_col)
    inv = (N.fourstep_inverse_scaled(prod, nf, extra_scale_r=True)
           if four_step
           else N.shoup_inverse_scaled(prod, nf, extra_scale_r=True))
    F = spec.frac_digits
    out = []
    for k in range(7):
        digits2d = _crt_to_digit_sums(inv[2 * k], inv[2 * k + 1],
                                      out_digits=2 * D, nfft=nf,
                                      round_digit=F - 1)
        out.append(digits2d[F:F + D])
    return tuple(out)


def _iter_products(vx, vy, nf: int):
    """[4, nf] inverse-transformed rows (x² − y², x·y) per prime from
    zero-padded magnitudes: one [4]-row forward, the difference taken
    in the frequency domain, one [4]-row scaled inverse."""
    stacked = jnp.stack([vx, vx, vy, vy])
    four_step = nf >= 8192
    f = (N.fourstep_forward(stacked, nf) if four_step
         else N.shoup_forward(stacked, nf))
    p2c, pp2c = N._row_consts(2)
    sq = N._mont_mul_rows(f, f, *N._row_consts(4))    # xx, yy
    d = N._mod_sub_rows(sq[0:2], sq[2:4], p2c)
    xy = N._mont_mul_rows(f[0:2], f[2:4], p2c, pp2c)
    prod = jnp.concatenate([d, xy])                   # [4, n]
    return (N.fourstep_inverse_scaled(prod, nf, extra_scale_r=True)
            if four_step
            else N.shoup_inverse_scaled(prod, nf, extra_scale_r=True))


def _nr_iter_products(vals, signs, nf: int):
    """[8, nf] rows (x² − y², x·y, x·dx − y·dy, x·dy + y·dx) per prime
    from the padded magnitudes (x, y, dx, dy) and their signs, folded
    into the spectra: NTT(−a) = p − NTT(a) pointwise."""
    stacked = jnp.stack([v for v in vals for _ in range(2)])
    four_step = nf >= 8192
    f = (N.fourstep_forward(stacked, nf) if four_step
         else N.shoup_forward(stacked, nf))
    p8c, _ = N._row_consts(8)
    # fold signs: rows 0,1 ← sx; 2,3 ← sy; 4,5 ← sdx; 6,7 ← sdy
    sg = jnp.stack([s for s in signs for _ in range(2)])
    fneg = jnp.where(f == 0, f, p8c - f)
    f = jnp.where((sg < 0)[:, None], fneg, f)
    p2c, pp2c = N._row_consts(2)

    def mul2(a2, b2):
        return N._mont_mul_rows(a2, b2, p2c, pp2c)

    fx, fy, fdx, fdy = f[0:2], f[2:4], f[4:6], f[6:8]
    d = N._mod_sub_rows(mul2(fx, fx), mul2(fy, fy), p2c)
    xy = mul2(fx, fy)
    u = N._mod_sub_rows(mul2(fx, fdx), mul2(fy, fdy), p2c)
    v = N._mod_add_rows(mul2(fx, fdy), mul2(fy, fdx), p2c)
    prod = jnp.concatenate([d, xy, u, v])             # [8, n]
    return (N.fourstep_inverse_scaled(prod, nf, extra_scale_r=True)
            if four_step
            else N.shoup_inverse_scaled(prod, nf, extra_scale_r=True))


def multiply_iter(ax, ay, spec: FixedSpec):
    """Orbit-iteration multiply: ((sign_d, d), xy) with
    sign_d·d = x² − y² and xy = x·y (magnitudes in, fixed-point
    scaled out).

    The x² − y² combine happens in the FREQUENCY domain (NTT
    linearity): the inverse pass shrinks from 6 rows to 4 and the
    digit-domain magnitude subtract (cmp + borrow ripple) disappears.
    The reference inverse-transforms all three products and subtracts
    in carry-sync passes (``MultiplyNTT.cu:2943``, ``Add.cu``);
    exactness of the signed result is guaranteed by |x²−y²| ≪ p1·p2/2
    via the signed CRT split (_crt_to_digit_sums_signed)."""
    nf = spec.nfft
    D = spec.digits
    pad = nf - D
    F = spec.frac_digits
    vx = jnp.concatenate([ax, jnp.zeros((pad,), jnp.uint32)])
    vy = jnp.concatenate([ay, jnp.zeros((pad,), jnp.uint32)])
    inv = _iter_products(vx, vy, nf)

    sd, dd = _crt_to_digit_sums_signed(inv[0], inv[1],
                                       out_digits=2 * D,
                                       round_digit=F - 1)
    xyd = _crt_to_digit_sums(inv[2], inv[3], out_digits=2 * D,
                             nfft=nf, round_digit=F - 1)
    return (sd, dd[F:F + D]), xyd[F:F + D]


def _signed_streams(r1, r2, double: bool, out_digits: int):
    """CRT a signed-residue row pair into (pos, neg) digit-sum
    accumulators (optionally doubling the coefficient first — exact,
    2·rec < 2^63)."""
    hi, lo = _crt_rec(r1, r2)
    neg = (hi > _HALF_HI) | ((hi == _HALF_HI) & (lo > _HALF_LO))
    nlo, bb = sub_borrow(jnp.broadcast_to(_P1P2_LO, lo.shape), lo)
    nhi = _P1P2_HI - hi - bb
    if double:
        hi = (hi << 1) | (lo >> 31)
        lo = lo << 1
        nhi = (nhi << 1) | (nlo >> 31)
        nlo = nlo << 1
    zero = np.uint32(0)
    acc_p = _parts_acc(jnp.where(neg, zero, hi),
                       jnp.where(neg, zero, lo), out_digits)
    acc_n = _parts_acc(jnp.where(neg, nhi, zero),
                       jnp.where(neg, nlo, zero), out_digits)
    return acc_p, acc_n


def _unsigned_stream(r1, r2, s_all, double: bool, out_digits: int):
    """CRT a non-negative row pair carrying one GLOBAL sign s_all into
    (pos, neg) accumulators."""
    hi, lo = _crt_rec(r1, r2)
    if double:
        hi = (hi << 1) | (lo >> 31)
        lo = lo << 1
    parts = _parts_acc(hi, lo, out_digits)
    zero = jnp.zeros_like(parts)
    return (jnp.where(s_all > 0, parts, zero),
            jnp.where(s_all > 0, zero, parts))


def _fold_addend(acc_p, acc_n, s_c, c, at_digit: int):
    """Accumulate a signed digit-array addend at a digit offset (the
    +c / +1 of the orbit update, folded before the single carry)."""
    zero = jnp.zeros_like(c)
    acc_p = acc_p.at[at_digit:at_digit + c.shape[0]].add(
        jnp.where(s_c > 0, c, zero))
    acc_n = acc_n.at[at_digit:at_digit + c.shape[0]].add(
        jnp.where(s_c > 0, zero, c))
    return acc_p, acc_n


def _finish_signed(acc_p, acc_n, F: int, D: int, round_digit: int):
    acc_p = acc_p.at[round_digit].add(np.uint32(1 << 15))
    s, m = signed_add(jnp.int32(1), carry_propagate(acc_p),
                      jnp.int32(-1), carry_propagate(acc_n))
    return s, m[F:F + D]


def _carry_rows(acc):
    """carry_propagate over the last axis of [K, L] (one lookahead
    pass covers all K streams)."""
    return carry_propagate(acc)


def _borrow_rows(acc):
    return borrow_propagate(acc)


def _finish_signed_rows(acc_p, acc_n, F: int, D: int, round_digit: int):
    """Batched (sign, digits) of pos − neg per row: acc_p/acc_n are
    [K, 2D] digit sums. Two batched carry ripples + one batched borrow
    ripple replace 3K sequential ones."""
    K, L = acc_p.shape
    acc_p = acc_p.at[:, round_digit].add(np.uint32(1 << 15))
    both = _carry_rows(jnp.concatenate([acc_p, acc_n], axis=0))
    pos = both[:K]
    neg = both[K:]
    # per-row magnitude compare (top differing digit)
    diff = pos != neg
    idx = jnp.where(diff, jnp.arange(L, dtype=jnp.int32)[None, :],
                    -1).max(axis=1)                        # [K]
    safe = jnp.maximum(idx, 0)
    rows = jnp.arange(K, dtype=jnp.int32)
    av = pos[rows, safe]
    bv = neg[rows, safe]
    big_p = jnp.where(idx < 0, True, av >= bv)[:, None]     # [K, 1]
    hi = jnp.where(big_p, pos, neg)
    lo = jnp.where(big_p, neg, pos)
    mag = _borrow_rows(hi - lo)
    is_zero = jnp.max(mag, axis=1) == 0
    sign = jnp.where(is_zero | big_p[:, 0], 1, -1).astype(jnp.int32)
    return sign, mag[:, F:F + D]


def iterate_z(sx, x, sy, y, scx, cx, scy, cy, spec: FixedSpec):
    """ONE full z ← z² + c update on sign-magnitude digits:
    (nsx, nx, nsy, ny). Beyond multiply_iter's frequency-domain x²−y²,
    the +c adds and the ×2 of the imaginary part fold into the CRT
    accumulation — each component runs exactly one carry ripple and
    one signed subtract per iteration (the reference instead chains
    separate grid-sync add passes, ``Add.cu``)."""
    nf = spec.nfft
    D = spec.digits
    F = spec.frac_digits
    pad = nf - D
    vx = jnp.concatenate([x, jnp.zeros((pad,), jnp.uint32)])
    vy = jnp.concatenate([y, jnp.zeros((pad,), jnp.uint32)])
    inv = _iter_products(vx, vy, nf)
    L = 2 * D
    px, nx_ = _signed_streams(inv[0], inv[1], False, L)
    px, nx_ = _fold_addend(px, nx_, scx, cx, F)
    py, ny_ = _unsigned_stream(inv[2], inv[3], sx * sy, True, L)
    py, ny_ = _fold_addend(py, ny_, scy, cy, F)
    signs, mags = _finish_signed_rows(jnp.stack([px, py]),
                                      jnp.stack([nx_, ny_]),
                                      F, D, F - 1)
    return signs[0], mags[0], signs[1], mags[1]


def iterate_z_nr(sx, x, sy, y, sdx, dx, sdy, dy,
                 scx, cx, scy, cy, spec: FixedSpec):
    """Fused NR update: z ← z² + c and dzdc ← 2·z·dzdc + 1 — all adds,
    doublings and the +1 folded into four CRT accumulations (see
    iterate_z). Returns (nsx, nx, nsy, ny, nsdx, ndx, nsdy, ndy) with
    dzdc' computed from the PRE-update z (MpirOrbitEval order)."""
    nf = spec.nfft
    D = spec.digits
    F = spec.frac_digits
    pad = nf - D

    def padv(v):
        return jnp.concatenate([v, jnp.zeros((pad,), jnp.uint32)])

    inv = _nr_iter_products(
        [padv(x), padv(y), padv(dx), padv(dy)], [sx, sy, sdx, sdy], nf)

    L = 2 * D
    one = jnp.ones((1,), jnp.uint32)
    # z real: d + cx ; z imag: 2·xy + cy (xy row is spectrum-signed);
    # dzdc real: 2·u + 1 ; dzdc imag: 2·v — all four streams finish in
    # ONE batched carry/borrow ripple
    p0, n0 = _signed_streams(inv[0], inv[1], False, L)
    p0, n0 = _fold_addend(p0, n0, scx, cx, F)
    p1, n1 = _signed_streams(inv[2], inv[3], True, L)
    p1, n1 = _fold_addend(p1, n1, scy, cy, F)
    p2, n2 = _signed_streams(inv[4], inv[5], True, L)
    p2, n2 = _fold_addend(p2, n2, jnp.int32(1), one, 2 * F)
    p3, n3 = _signed_streams(inv[6], inv[7], True, L)
    signs, mags = _finish_signed_rows(jnp.stack([p0, p1, p2, p3]),
                                      jnp.stack([n0, n1, n2, n3]),
                                      F, D, F - 1)
    return (signs[0], mags[0], signs[1], mags[1],
            signs[2], mags[2], signs[3], mags[3])


def multiply_nr_iter(sx, ax, sy, ay, sdx, adx, sdy, ady,
                     spec: FixedSpec):
    """NR-iteration multiply with frequency-domain sign folding:
    returns ((s_d, d), (s_xy, xy), (s_u, u), (s_v, v)) where

        d  = x² − y²          xy = x·y
        u  = x·dx − y·dy      v  = x·dy + y·dx

    — the four signed combinations one z/dzdc update needs, from ONE
    [4-value] forward and ONE [8-row] inverse (the plain NR path
    inverse-transforms 14 rows, multiply_nr).

    Signs fold into the spectra: NTT(−a) = p − NTT(a) pointwise, so
    each value's spectrum is conditionally negated by its sign flag
    and every downstream product/sum is automatically signed; the
    signed CRT recovers (sign, magnitude) digits."""
    nf = spec.nfft
    D = spec.digits
    pad = nf - D

    def padv(v):
        return jnp.concatenate([v, jnp.zeros((pad,), jnp.uint32)])

    F = spec.frac_digits
    inv = _nr_iter_products(
        [padv(ax), padv(ay), padv(adx), padv(ady)], [sx, sy, sdx, sdy], nf)

    out = []
    for k in range(4):
        s, m = _crt_to_digit_sums_signed(inv[2 * k], inv[2 * k + 1],
                                         out_digits=2 * D,
                                         round_digit=F - 1)
        out.append((s, m[F:F + D]))
    return tuple(out)


def multiply_3way(ax, ay, spec: FixedSpec):
    """Given magnitudes x, y (digit arrays of length spec.digits), return
    the fixed-point-scaled magnitudes of (x², y², x·y) — two forward
    transforms feed all three products (MultiplyNTT.cu:2943 3-way).

    All residue systems and all products ride batched whole-array
    passes: ONE [4, n] forward (x, y × two primes) and ONE [6, n]
    inverse (xx, yy, xy × two primes)."""
    plan = N.make_plan(spec.nfft)
    nf = spec.nfft
    D = spec.digits
    pad = nf - D

    v = jnp.concatenate([ax, jnp.zeros((pad,), jnp.uint32)])
    w = jnp.concatenate([ay, jnp.zeros((pad,), jnp.uint32)])
    # rows: [x@p1, x@p2, y@p1, y@p2] — digits < 2^16 < p, no reduction.
    # Plain-domain Shoup transforms (6 mults/butterfly); the pointwise
    # Montgomery REDC's R^-1 is cancelled in the inverse's scaling.
    stacked = jnp.stack([v, v, w, w])
    # four-step from nfft 8192 up, the flat form below (crossover not
    # measured on the H100)
    four_step = nf >= 8192
    f = (N.fourstep_forward(stacked, nf) if four_step
         else N.shoup_forward(stacked, nf))
    fx1, fx2, fy1, fy2 = f[0], f[1], f[2], f[3]
    # rows: [xx@p1, xx@p2, yy@p1, yy@p2, xy@p1, xy@p2]
    a_ops = jnp.stack([fx1, fx2, fy1, fy2, fx1, fx2])
    b_ops = jnp.stack([fx1, fx2, fy1, fy2, fy1, fy2])
    p_col, pp_col = N._row_consts(6)
    prod = N._mont_mul_rows(a_ops, b_ops, p_col, pp_col)
    inv = (N.fourstep_inverse_scaled(prod, nf, extra_scale_r=True)
           if four_step
           else N.shoup_inverse_scaled(prod, nf, extra_scale_r=True))

    out = []
    # product has 2D digits; the fixed-point result drops the low
    # frac_digits (with round-to-nearest at the boundary) and keeps D.
    F = spec.frac_digits
    for k in range(3):
        digits2d = _crt_to_digit_sums(inv[2 * k], inv[2 * k + 1],
                                      out_digits=2 * D, nfft=nf,
                                      round_digit=F - 1)
        out.append(digits2d[F:F + D])
    return tuple(out)
