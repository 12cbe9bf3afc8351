"""Number-theoretic transform over two 31-bit primes, uint32-only.

Counterpart of the reference NTT engine
(``HpSharkFloatLib/MultiplyNTT.cu``, plan builder
``MultiplyNTTPlanBuilder.h:50-110``, Montgomery core
``MontgomeryCoreConstexpr.h``). Differences by design:

* the reference uses ONE 64-bit prime; here TWO 31-bit NTT primes +
  CRT, so all arithmetic decomposes into exact u32/16-bit-half
  operations (u32.py);
* transforms are iterative radix-2 Cooley–Tukey expressed as whole-array
  reshapes/butterflies — each stage is a handful of elementwise vector
  ops over the full coefficient array, which XLA fuses into
  elementwise kernels (the reference instead hand-schedules shared-memory tiles);
* Montgomery domain (R = 2^32) throughout; root tables are precomputed
  host-side with Python ints and shipped as constants.

Primes: p1 = 15·2^27 + 1, p2 = 27·2^26 + 1 — both support transform
sizes to 2^26, far beyond the 2^17 needed for 16384-limb operands.
CRT capacity p1·p2 ≈ 2^61.9 against worst-case convolution coefficients
of 2·Nfft·(2^16-1)^2 < 2^50 at Nfft = 2^17.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from fractalshark_tpu.ops.bignum.u32 import mul_full, mul_lo

P1 = 2013265921  # 15 * 2^27 + 1
P2 = 1811939329  # 27 * 2^26 + 1
G1 = 31          # primitive root mod P1
G2 = 13          # primitive root mod P2

DIGIT_BITS = 16


def _mont_const(p: int) -> tuple[int, int, int]:
    """(p' = -p^-1 mod 2^32, R mod p, R^2 mod p)."""
    pinv = pow(p, -1, 1 << 32)
    pprime = ((1 << 32) - pinv) % (1 << 32)
    r = (1 << 32) % p
    r2 = (r * r) % p
    return pprime, r, r2


@dataclass(frozen=True)
class NTTPlan:
    """Host-precomputed plan for one transform size."""
    n: int                   # transform size (power of 2)
    stages: int
    # per prime: twiddle tables in Montgomery form, bit-rev permutation
    tw_fwd: tuple            # (np.uint32[n//2], np.uint32[n//2])
    tw_inv: tuple
    n_inv_mont: tuple        # montgomery form of n^-1, per prime
    perm: np.ndarray         # bit-reversal permutation [n]


def _build_tables(p: int, g: int, n: int):
    """Twiddles w^k (forward) and w^-k (inverse), Montgomery form,
    grouped per stage in the layout the vectorized butterflies use."""
    pprime, r, r2 = _mont_const(p)
    w = pow(g, (p - 1) // n, p)
    winv = pow(w, p - 2, p)

    def mont(x):
        return (x << 32) % p

    fwd = np.zeros(n // 2, np.uint32)
    inv = np.zeros(n // 2, np.uint32)
    wk, wik = 1, 1
    for k in range(n // 2):
        fwd[k] = mont(wk)
        inv[k] = mont(wik)
        wk = wk * w % p
        wik = wik * winv % p
    n_inv = pow(n, p - 2, p)
    return fwd, inv, np.uint32(mont(n_inv))


@functools.lru_cache(maxsize=16)
def make_plan(n: int) -> NTTPlan:
    assert n & (n - 1) == 0, "transform size must be a power of two"
    stages = n.bit_length() - 1
    f1, i1, ninv1 = _build_tables(P1, G1, n)
    f2, i2, ninv2 = _build_tables(P2, G2, n)
    idx = np.arange(n)
    rev = np.zeros(n, np.int32)
    for i in range(n):
        rev[i] = int(format(i, f"0{stages}b")[::-1], 2)
    return NTTPlan(n=n, stages=stages,
                   tw_fwd=(f1, f2), tw_inv=(i1, i2),
                   n_inv_mont=(ninv1, ninv2), perm=rev)


# ------------------------------------------------------------ modular ops


def mont_redc(hi, lo, p: int, pprime: int):
    """Montgomery reduction of the 64-bit value (hi,lo) < p·2^32:
    returns (hi·2^32 + lo)·2^-32 mod p, in [0, p)."""
    m = mul_lo(lo, np.uint32(pprime))
    mp_hi, mp_lo = mul_full(m, np.uint32(p))
    # lo + mp_lo ≡ 0 (mod 2^32); carry out iff lo != 0
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mp_hi + carry
    return jnp.where(t >= np.uint32(p), t - np.uint32(p), t)


def mont_mul(a, b, p: int, pprime: int):
    hi, lo = mul_full(a, b)
    return mont_redc(hi, lo, p, pprime)


def mod_add(a, b, p: int):
    s = a + b
    return jnp.where(s >= np.uint32(p), s - np.uint32(p), s)


def mod_sub(a, b, p: int):
    return jnp.where(a >= b, a - b, a + np.uint32(p) - b)


_MONT = {P1: _mont_const(P1), P2: _mont_const(P2)}


def to_mont(x, p: int):
    pprime, _, r2 = _MONT[p]
    return mont_mul(x, jnp.asarray(np.uint32(r2)), p, pprime)


def from_mont(x, p: int):
    pprime, _, _ = _MONT[p]
    return mont_redc(jnp.zeros_like(x), x, p, pprime)


# ------------------------------------------------------------- transforms


def _dif_forward(x, tw, p: int):
    """Radix-2 decimation-in-frequency NTT: natural-order input →
    BIT-REVERSED output (no permutation pass; the convolution's
    pointwise product is order-agnostic).

    Stage s ∈ [0, stages): blocks of bs = n>>s, halves hm = bs/2,
    butterfly (a, b) → (a+b, (a−b)·w^(k·2^s)).
    Each stage is a reshape + elementwise vector math.
    """
    pprime, _, _ = _MONT[p]
    n = x.shape[-1]
    stages = n.bit_length() - 1
    tw_j = jnp.asarray(tw)
    y = x
    for s in range(stages):
        hm = n >> (s + 1)
        k = jnp.arange(hm, dtype=jnp.int32)
        w = tw_j[k << s]                     # w^(k·2^s), Montgomery
        y2 = y.reshape(y.shape[:-1] + (1 << s, 2, hm))
        a = y2[..., 0, :]
        b = y2[..., 1, :]
        t = mod_add(a, b, p)
        u = mont_mul(mod_sub(a, b, p), w, p, pprime)
        y = jnp.stack([t, u], axis=-2).reshape(x.shape)
    return y


def _dit_inverse(x, tw, p: int):
    """Radix-2 decimation-in-time inverse NTT: BIT-REVERSED input →
    natural-order output. Stage s: blocks of bs = 2^(s+1), butterfly
    (a, b·w^(-k·2^(stages-1-s))) → (a+u, a−u). Unscaled (no n^-1)."""
    pprime, _, _ = _MONT[p]
    n = x.shape[-1]
    stages = n.bit_length() - 1
    tw_j = jnp.asarray(tw)
    y = x
    for s in range(stages):
        hm = 1 << s
        k = jnp.arange(hm, dtype=jnp.int32)
        w = tw_j[k << (stages - 1 - s)]
        y2 = y.reshape(y.shape[:-1] + (n >> (s + 1), 2, hm))
        a = y2[..., 0, :]
        b = y2[..., 1, :]
        u = mont_mul(b, w, p, pprime)
        t0 = mod_add(a, u, p)
        t1 = mod_sub(a, u, p)
        y = jnp.stack([t0, t1], axis=-2).reshape(x.shape)
    return y


def ntt_forward(x, plan: NTTPlan, prime_idx: int):
    """Forward NTT (output bit-reversed, Montgomery form)."""
    p = (P1, P2)[prime_idx]
    return _dif_forward(x, plan.tw_fwd[prime_idx], p)


def ntt_inverse(x, plan: NTTPlan, prime_idx: int):
    """Inverse NTT of a bit-reversed-order spectrum; scaled by n^-1."""
    p = (P1, P2)[prime_idx]
    pprime, _, _ = _MONT[p]
    y = _dit_inverse(x, plan.tw_inv[prime_idx], p)
    ninv = jnp.asarray(plan.n_inv_mont[prime_idx])
    return mont_mul(y, ninv, p, pprime)


# ----------------------------------------------- prime-batched transforms
# All rows transform in ONE whole-array pass: row r uses prime r % 2.
# Per-prime constants broadcast as [R, 1] columns — one elementwise pass
# covers both residue systems (and, for the inverse, all three
# products).


def _row_consts(rows: int):
    ps = np.empty((rows, 1), np.uint32)
    pps = np.empty((rows, 1), np.uint32)
    for r in range(rows):
        p = (P1, P2)[r % 2]
        ps[r, 0] = p
        pps[r, 0] = _MONT[p][0]
    return jnp.asarray(ps), jnp.asarray(pps)


def _mont_mul_rows(a, b, p_col, pp_col):
    hi, lo = mul_full(a, b)
    m = mul_lo(lo, pp_col)
    mp_hi, mp_lo = mul_full(m, p_col)
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mp_hi + carry
    return jnp.where(t >= p_col, t - p_col, t)


def _mod_add_rows(a, b, p_col):
    s = a + b
    return jnp.where(s >= p_col, s - p_col, s)


def _mod_sub_rows(a, b, p_col):
    return jnp.where(a >= b, a - b, a + p_col - b)


def _stack_tw(plan: NTTPlan, rows: int, inverse: bool) -> np.ndarray:
    tw = plan.tw_inv if inverse else plan.tw_fwd
    return np.stack([tw[r % 2] for r in range(rows)])


@functools.lru_cache(maxsize=64)
def _stage_tw(n: int, rows: int, inverse: bool):
    """Per-stage twiddle vectors, precomputed on host so no device
    gathers happen inside the stage loop. Returns a tuple of NUMPY
    uint32[rows, hm] arrays, one per stage (numpy, not jnp: jnp
    constants created under one trace must not be cached across
    traces)."""
    plan = make_plan(n)
    stages = n.bit_length() - 1
    tw = plan.tw_inv if inverse else plan.tw_fwd
    out = []
    for s in range(stages):
        if inverse:
            hm = 1 << s
            idx = (np.arange(hm) << (stages - 1 - s))
        else:
            hm = n >> (s + 1)
            idx = (np.arange(hm) << s)
        out.append(np.stack([tw[r % 2][idx] for r in range(rows)]))
    return tuple(out)


def batched_forward(x, plan: NTTPlan):
    """x: uint32[R, n] Montgomery, row r in prime r%2's field.
    One DIF pass over all rows; twiddles are per-stage constants."""
    rows, n = x.shape
    p_col, pp_col = _row_consts(rows)
    tws = _stage_tw(n, rows, inverse=False)
    stages = n.bit_length() - 1
    y = x
    for s in range(stages):
        w = jnp.asarray(tws[s])                         # [R, hm]
        hm = w.shape[1]
        y2 = y.reshape(rows, 1 << s, 2, hm)
        a = y2[:, :, 0, :]
        b = y2[:, :, 1, :]
        t = _mod_add_rows(a, b, p_col[:, :, None])
        u = _mont_mul_rows(_mod_sub_rows(a, b, p_col[:, :, None]),
                           w[:, None, :], p_col[:, :, None],
                           pp_col[:, :, None])
        y = jnp.stack([t, u], axis=-2).reshape(rows, n)
    return y


def batched_inverse(x, plan: NTTPlan):
    rows, n = x.shape
    p_col, pp_col = _row_consts(rows)
    tws = _stage_tw(n, rows, inverse=True)
    stages = n.bit_length() - 1
    y = x
    for s in range(stages):
        w = jnp.asarray(tws[s])                         # [R, hm]
        hm = w.shape[1]
        y2 = y.reshape(rows, n >> (s + 1), 2, hm)
        a = y2[:, :, 0, :]
        b = y2[:, :, 1, :]
        u = _mont_mul_rows(b, w[:, None, :], p_col[:, :, None],
                           pp_col[:, :, None])
        t0 = _mod_add_rows(a, u, p_col[:, :, None])
        t1 = _mod_sub_rows(a, u, p_col[:, :, None])
        y = jnp.stack([t0, t1], axis=-2).reshape(rows, n)
    ninv = jnp.asarray(np.stack(
        [np.full(1, plan.n_inv_mont[r % 2], np.uint32)
         for r in range(rows)]))
    return _mont_mul_rows(y, ninv, p_col, pp_col)


# --------------------------------------------------- Shoup-form transforms
# Plain-domain data with Shoup-precomputed twiddles: the butterfly's
# twiddle multiply costs 6 u32 mults instead of Montgomery's 9
# (w' = floor(w·2^32/p); q = mulhi(w', t); r = w·t − q·p (mod 2^32),
# r ∈ [0, 2p) then one conditional subtract). The pointwise product uses
# one Montgomery REDC per element (its R^-1 factor is cancelled by
# folding R into the inverse transform's n^-1 scaling).


@functools.lru_cache(maxsize=64)
def _stage_tw_shoup(n: int, rows: int, inverse: bool):
    """Per-stage (w, w') numpy pairs in PLAIN domain."""
    stages = n.bit_length() - 1
    out = []
    ws_all = []
    for r in range(rows):
        p = (P1, P2)[r % 2]
        g = (G1, G2)[r % 2]
        w = pow(g, (p - 1) // n, p)
        if inverse:
            w = pow(w, p - 2, p)
        tw = np.empty(n // 2, np.uint32)
        wk = 1
        for k in range(n // 2):
            tw[k] = wk
            wk = wk * w % p
        ws_all.append(tw)
    for s in range(stages):
        if inverse:
            hm = 1 << s
            idx = (np.arange(hm) << (stages - 1 - s))
        else:
            hm = n >> (s + 1)
            idx = (np.arange(hm) << s)
        w_rows = np.stack([ws_all[r][idx] for r in range(rows)])
        wp_rows = np.empty_like(w_rows)
        for r in range(rows):
            p = (P1, P2)[r % 2]
            wp_rows[r] = ((w_rows[r].astype(object) << 32) // p
                          ).astype(np.uint64).astype(np.uint32)
        out.append((w_rows, wp_rows))
    return tuple(out)


def _shoup_mul(t, w, wp, p_col):
    """t·w mod p with Shoup precomputation; t ∈ [0,p), w < p."""
    q = mul_full(wp, t)[0]
    r = mul_lo(w, t) - mul_lo(q, p_col)
    return jnp.where(r >= p_col, r - p_col, r)


def shoup_forward(x, n: int):
    """Plain-domain DIF forward, rows r in prime r%2."""
    rows = x.shape[0]
    p_col, _ = _row_consts(rows)
    tws = _stage_tw_shoup(n, rows, inverse=False)
    stages = n.bit_length() - 1
    y = x
    for s in range(stages):
        w = jnp.asarray(tws[s][0])[:, None, :]
        wp = jnp.asarray(tws[s][1])[:, None, :]
        hm = w.shape[-1]
        y2 = y.reshape(rows, 1 << s, 2, hm)
        a = y2[:, :, 0, :]
        b = y2[:, :, 1, :]
        pc = p_col[:, :, None]
        t = _mod_add_rows(a, b, pc)
        u = _shoup_mul(_mod_sub_rows(a, b, pc), w, wp, pc)
        y = jnp.stack([t, u], axis=-2).reshape(rows, n)
    return y


def shoup_inverse_scaled(x, n: int, extra_scale_r: bool = True):
    """Plain-domain DIT inverse; final scaling by n^-1 (·R when
    cancelling a Montgomery pointwise)."""
    rows = x.shape[0]
    p_col, _ = _row_consts(rows)
    tws = _stage_tw_shoup(n, rows, inverse=True)
    stages = n.bit_length() - 1
    y = x
    for s in range(stages):
        w = jnp.asarray(tws[s][0])[:, None, :]
        wp = jnp.asarray(tws[s][1])[:, None, :]
        hm = w.shape[-1]
        y2 = y.reshape(rows, n >> (s + 1), 2, hm)
        a = y2[:, :, 0, :]
        b = y2[:, :, 1, :]
        pc = p_col[:, :, None]
        u = _shoup_mul(b, w, wp, pc)
        t0 = _mod_add_rows(a, u, pc)
        t1 = _mod_sub_rows(a, u, pc)
        y = jnp.stack([t0, t1], axis=-2).reshape(rows, n)
    # scale by n^-1 (· R to cancel the pointwise REDC's R^-1)
    sc = np.empty((rows, 1), np.uint32)
    scp = np.empty((rows, 1), np.uint32)
    for r in range(rows):
        p = (P1, P2)[r % 2]
        v = pow(n, p - 2, p)
        if extra_scale_r:
            v = (v << 32) % p
        sc[r, 0] = v
        scp[r, 0] = (v << 32) // p
    return _shoup_mul(y, jnp.asarray(sc), jnp.asarray(scp), p_col)


# ------------------------------------------------- four-step transforms
# Bailey's four-step factorization n = n1·n2: two batches of SHORT
# axis-0 transforms around a twiddle-matrix multiply and a transpose.
# Every butterfly pairs rows of [.., n1, n2] arrays (the minor dim is
# never subdivided), so all stage reshapes are free leading-dim views —
# unlike the flat radix-2 form whose last stages shuffle within rows.
# Output order is "scrambled" (bit-reversed k1/k2, transposed), which
# the convolution's pointwise product doesn't care about as long as the
# inverse mirrors the exact chain.


def _split_n(n: int) -> tuple[int, int]:
    s = n.bit_length() - 1
    n1 = 1 << (s // 2)
    return n1, n // n1


def _bitrev(k: int, bits: int) -> int:
    return int(format(k, f"0{bits}b")[::-1], 2)


@functools.lru_cache(maxsize=64)
def _fourstep_consts(n: int, rows: int):
    """Per-row constants for the four-step transform of size n:
    inner-stage twiddles (lengths n1 and n2) and the rev-aware twiddle
    matrices T1 / T1inv, all as (value, shoup) numpy pairs."""
    n1, n2 = _split_n(n)

    def stage_tws(m: int, inverse: bool):
        stages = m.bit_length() - 1
        per_stage = []
        roots = []
        for r in range(rows):
            p = (P1, P2)[r % 2]
            g = (G1, G2)[r % 2]
            wm = pow(g, (p - 1) // m, p)
            if inverse:
                wm = pow(wm, p - 2, p)
            tw = np.empty(m // 2, np.uint64)
            wk = 1
            for k in range(m // 2):
                tw[k] = wk
                wk = wk * wm % p
            roots.append(tw)
        for s in range(stages):
            if inverse:
                hm = 1 << s
                idx = (np.arange(hm) << (stages - 1 - s))
            else:
                hm = m >> (s + 1)
                idx = (np.arange(hm) << s)
            w_rows = np.stack([roots[r][idx] for r in range(rows)])
            wp_rows = np.empty_like(w_rows)
            for r in range(rows):
                p = (P1, P2)[r % 2]
                wp_rows[r] = (w_rows[r].astype(object) << 32) // p
            per_stage.append((w_rows.astype(np.uint32),
                              wp_rows.astype(np.uint32)))
        return tuple(per_stage)

    bits1 = n1.bit_length() - 1
    rev1 = np.array([_bitrev(k, bits1) for k in range(n1)])
    t1 = np.empty((rows, n1, n2), np.uint32)
    t1p = np.empty((rows, n1, n2), np.uint32)
    t1i = np.empty((rows, n1, n2), np.uint32)
    t1ip = np.empty((rows, n1, n2), np.uint32)
    for r in range(rows):
        p = (P1, P2)[r % 2]
        g = (G1, G2)[r % 2]
        wn = pow(g, (p - 1) // n, p)
        wni = pow(wn, p - 2, p)
        for row in range(n1):
            k1 = int(rev1[row])
            base = pow(wn, k1, p)
            basei = pow(wni, k1, p)
            v = 1
            vi = 1
            for i2 in range(n2):
                t1[r, row, i2] = v
                t1p[r, row, i2] = (v << 32) // p
                t1i[r, row, i2] = vi
                t1ip[r, row, i2] = (vi << 32) // p
                v = v * base % p
                vi = vi * basei % p
    # final scaling constant: n^-1 (·R) per row
    return {
        "n1": n1, "n2": n2,
        "tw1_f": stage_tws(n1, False), "tw1_i": stage_tws(n1, True),
        "tw2_f": stage_tws(n2, False), "tw2_i": stage_tws(n2, True),
        "t1": (t1, t1p), "t1i": (t1i, t1ip),
    }


def _axis0_dif(y, tws, p_col):
    """DIF over axis 1 of [R, m, n2] (natural → bit-reversed rows)."""
    rows, m, lanes = y.shape
    stages = m.bit_length() - 1
    for s in range(stages):
        hm = m >> (s + 1)
        w = jnp.asarray(tws[s][0]).reshape(rows, 1, hm, 1)
        wp = jnp.asarray(tws[s][1]).reshape(rows, 1, hm, 1)
        y4 = y.reshape(rows, 1 << s, 2, hm, lanes)
        a = y4[:, :, 0]
        b = y4[:, :, 1]
        pc = p_col[:, :, None, None]
        t = _mod_add_rows(a, b, pc)
        u = _shoup_mul(_mod_sub_rows(a, b, pc), w, wp, pc)
        y = jnp.stack([t, u], axis=2).reshape(rows, m, lanes)
    return y


def _axis0_dit(y, tws, p_col):
    """DIT over axis 1 of [R, m, n2] (bit-reversed rows → natural)."""
    rows, m, lanes = y.shape
    stages = m.bit_length() - 1
    for s in range(stages):
        hm = 1 << s
        w = jnp.asarray(tws[s][0]).reshape(rows, 1, hm, 1)
        wp = jnp.asarray(tws[s][1]).reshape(rows, 1, hm, 1)
        y4 = y.reshape(rows, m >> (s + 1), 2, hm, lanes)
        a = y4[:, :, 0]
        b = y4[:, :, 1]
        pc = p_col[:, :, None, None]
        u = _shoup_mul(b, w, wp, pc)
        t0 = _mod_add_rows(a, u, pc)
        t1 = _mod_sub_rows(a, u, pc)
        y = jnp.stack([t0, t1], axis=2).reshape(rows, m, lanes)
    return y


def fourstep_forward(x, n: int):
    """Plain-domain four-step forward: [R, n] → scrambled spectra
    [R, n] (internally [R, n2, n1])."""
    rows = x.shape[0]
    c = _fourstep_consts(n, rows)
    n1, n2 = c["n1"], c["n2"]
    p_col, _ = _row_consts(rows)
    a = x.reshape(rows, n1, n2)
    b = _axis0_dif(a, c["tw1_f"], p_col)
    t1, t1p = c["t1"]
    b = _shoup_mul(b, jnp.asarray(t1), jnp.asarray(t1p),
                   p_col[:, :, None])
    bt = jnp.transpose(b, (0, 2, 1))          # [R, n2, n1]
    e = _axis0_dif(bt, c["tw2_f"], p_col)
    return e.reshape(rows, n)


def fourstep_inverse_scaled(x, n: int, extra_scale_r: bool = True):
    """Inverse of fourstep_forward, scaled by n^-1 (·R optionally)."""
    rows = x.shape[0]
    c = _fourstep_consts(n, rows)
    n1, n2 = c["n1"], c["n2"]
    p_col, _ = _row_consts(rows)
    e = x.reshape(rows, n2, n1)
    bt = _axis0_dit(e, c["tw2_i"], p_col)
    b = jnp.transpose(bt, (0, 2, 1))          # [R, n1, n2]
    t1i, t1ip = c["t1i"]
    b = _shoup_mul(b, jnp.asarray(t1i), jnp.asarray(t1ip),
                   p_col[:, :, None])
    a = _axis0_dit(b, c["tw1_i"], p_col)
    y = a.reshape(rows, n)
    sc = np.empty((rows, 1), np.uint32)
    scp = np.empty((rows, 1), np.uint32)
    for r in range(rows):
        p = (P1, P2)[r % 2]
        v = pow(n, p - 2, p)
        if extra_scale_r:
            v = (v << 32) % p
        sc[r, 0] = v
        scp[r, 0] = (v << 32) // p
    return _shoup_mul(y, jnp.asarray(sc), jnp.asarray(scp), p_col)


def batched_to_mont(x, rows: int):
    p_col, pp_col = _row_consts(rows)
    r2 = jnp.asarray(np.stack(
        [np.full(1, np.uint32(_MONT[(P1, P2)[r % 2]][2]), np.uint32)
         for r in range(rows)]))
    return _mont_mul_rows(x, r2, p_col, pp_col)


def batched_from_mont(x, rows: int):
    p_col, pp_col = _row_consts(rows)
    m = mul_lo(x, pp_col)
    mp_hi, _ = mul_full(m, p_col)
    carry = (x != 0).astype(jnp.uint32)
    t = mp_hi + carry
    return jnp.where(t >= p_col, t - p_col, t)
