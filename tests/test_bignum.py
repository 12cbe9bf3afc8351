"""Big-number device pipeline tests — differential testing against Python
ints as the oracle, mirroring the reference's strategy of checking GPU
HpSharkFloat results against MPIR (``HpSharkFloatTest``,
``Tests.cpp:312 DiffAgainstHost``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.ops.bignum import fixedpoint as FP
from fractalshark_tpu.ops.bignum import ntt as N


# ------------------------------------------------------------------ u32


def test_mul_full_exact():
    from fractalshark_tpu.ops.bignum.u32 import mul_full
    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 256, dtype=np.uint64).astype(np.uint32)
    hi, lo = mul_full(jnp.asarray(a), jnp.asarray(b))
    want = a.astype(object) * b.astype(object)
    got = (np.asarray(hi).astype(object) << 32) + np.asarray(lo).astype(object)
    assert (got == want).all()


# ------------------------------------------------------------------ NTT


@pytest.mark.parametrize("prime_idx,p", [(0, N.P1), (1, N.P2)])
def test_ntt_round_trip(prime_idx, p):
    n = 128
    plan = N.make_plan(n)
    rng = np.random.default_rng(p)
    a = rng.integers(0, p, n, dtype=np.uint64).astype(np.uint32)
    am = N.to_mont(jnp.asarray(a), p)
    back = np.asarray(N.from_mont(
        N.ntt_inverse(N.ntt_forward(am, plan, prime_idx), plan, prime_idx),
        p))
    np.testing.assert_array_equal(back, a)


def test_mont_mul_exact():
    rng = np.random.default_rng(3)
    for p in (N.P1, N.P2):
        pprime, _, _ = N._MONT[p]
        a = rng.integers(0, p, 512, dtype=np.uint64)
        b = rng.integers(0, p, 512, dtype=np.uint64)
        got = np.asarray(N.mont_mul(jnp.asarray(a.astype(np.uint32)),
                                    jnp.asarray(b.astype(np.uint32)),
                                    p, pprime)).astype(np.uint64)
        # mont_mul(a,b) = a·b·R^-1 mod p
        rinv = pow(1 << 32, -1, p)
        want = (a.astype(object) * b.astype(object) * rinv) % p
        assert (got.astype(object) == want).all()


# ------------------------------------------------------------ fixed point


@pytest.mark.parametrize("limbs", [8, 32, 128])
def test_multiply_3way_vs_python_int(limbs):
    spec = FP.FixedSpec.for_limbs(limbs)
    rng = np.random.default_rng(limbs)
    prec = spec.frac_bits + 30
    x = HighPrecision(rng.uniform(-2, 2), prec=prec)
    y = HighPrecision(rng.uniform(-2, 2), prec=prec)
    _, dx = FP.hp_to_digits(x, spec)
    _, dy = FP.hp_to_digits(y, spec)
    xx, yy, xy = FP.multiply_3way(jnp.asarray(dx), jnp.asarray(dy), spec)
    ix = FP.digits_to_int(dx)
    iy = FP.digits_to_int(dy)
    half = 1 << (spec.frac_bits - 1)

    def rs(v):
        return (v + half) >> spec.frac_bits

    assert FP.digits_to_int(np.asarray(xx)) == rs(ix * ix)
    assert FP.digits_to_int(np.asarray(yy)) == rs(iy * iy)
    assert FP.digits_to_int(np.asarray(xy)) == rs(ix * iy)


def test_signed_add_cases():
    spec = FP.FixedSpec.for_limbs(8)

    def mk(v):
        s, d = FP.hp_to_digits(HighPrecision(v, prec=260), spec)
        return jnp.int32(s), jnp.asarray(d)

    cases = [("1.5", "2.25"), ("1.5", "-2.25"), ("-1.5", "2.25"),
             ("-1.5", "-2.25"), ("3.0", "-3.0"), ("0.0001", "-0.00005")]
    for a, b in cases:
        sa, da = mk(a)
        sb, db = mk(b)
        s, m = FP.signed_add(sa, da, sb, db)
        got = FP.digits_to_float(int(s), np.asarray(m), spec)
        want = float(a) + float(b)
        assert abs(got - want) < 1e-12, (a, b, got, want)


def test_carry_borrow_ripple():
    # adversarial long carry chain: 0xFFFF everywhere + 1
    D = 32
    a = np.full(D, 0xFFFF, np.uint32)
    b = np.zeros(D, np.uint32)
    b[0] = 1
    s = np.asarray(FP.add_mag(jnp.asarray(a), jnp.asarray(b)))
    assert s[0] == 0 and (s[1:-1] == 0).all()  # all carried away
    # subtraction borrowing across the whole number
    x = np.zeros(D, np.uint32)
    x[-1] = 1
    y = np.zeros(D, np.uint32)
    y[0] = 1
    d = np.asarray(FP.sub_mag(jnp.asarray(x), jnp.asarray(y)))
    assert d[0] == 0xFFFF and (d[1:-1] == 0xFFFF).all() and d[-1] == 0


# ------------------------------------------------------------ device orbit


def test_device_orbit_matches_host():
    from fractalshark_tpu.engine.reforbit import compute_reference_orbit
    from fractalshark_tpu.ops.bignum.orbit import (
        compute_reference_orbit_device)
    cx = HighPrecision("-0.743643887037158704752191506114774", prec=256)
    cy = HighPrecision("0.131825904205311970493132056385139", prec=256)
    rad = HighPrecision("1e-9", prec=64)
    dev = compute_reference_orbit_device(cx, cy, 1200, rad, limbs32=16,
                                         chunk_steps=128)
    host = compute_reference_orbit(cx, cy, 1200, rad, periodicity=True,
                                   precision_bits=16 * 32 - 64)
    assert dev.count_orbit_entries() == host.count_orbit_entries()
    assert dev.period == host.period
    n = dev.count_orbit_entries()
    assert np.abs(dev.orbit_x[:n] - host.orbit_x[:n]).max() < 1e-13
    assert np.abs(dev.orbit_y[:n] - host.orbit_y[:n]).max() < 1e-13


def test_device_orbit_escape():
    from fractalshark_tpu.ops.bignum.orbit import (
        compute_reference_orbit_device)
    dev = compute_reference_orbit_device(
        HighPrecision("3.0", prec=128), HighPrecision("0", prec=128),
        50, HighPrecision("0.01"), limbs32=8, chunk_steps=16)
    assert dev.escaped_at > 0
    assert dev.count_orbit_entries() <= 5


@pytest.mark.slow
def test_view32_iterate_32768_limbs_exact():
    """View #32-scale proof (VERDICT r2 #4): one full z <- z^2 + c
    update at 32768 limbs (nfft 131072) on the REAL View #32 center
    (zoom 1.6e244240, Notes/FractalShark-07-GpuArithmetic.tex:33-40),
    checked against exact Python-int arithmetic."""
    from fractalshark_tpu.core.views import get_view_preset

    spec = FP.FixedSpec.for_limbs(32768)
    assert spec.nfft == 131072
    F = spec.frac_digits
    v32 = get_view_preset(32).ptz
    prec = spec.frac_bits - 64
    cx = v32.pt_x.with_precision(prec)
    cy = v32.pt_y.with_precision(prec)
    scx, dcx = FP.hp_to_digits(cx, spec)
    scy, dcy = FP.hp_to_digits(cy, spec)
    # z starts at c; one update
    nsx, nx, nsy, ny = FP.iterate_z(
        jnp.int32(scx), jnp.asarray(dcx), jnp.int32(scy),
        jnp.asarray(dcy), jnp.int32(scx), jnp.asarray(dcx),
        jnp.int32(scy), jnp.asarray(dcy), spec)
    x_i = scx * FP.digits_to_int(dcx)
    y_i = scy * FP.digits_to_int(dcy)
    half = 1 << (16 * F - 1)
    shift = 16 * F

    def rhu(v):
        t = v + half
        return (1 if t >= 0 else -1) * (abs(t) >> shift)

    want_x = rhu(x_i * x_i - y_i * y_i + (x_i << shift))
    want_y = rhu(2 * x_i * y_i + (y_i << shift))
    got_x = int(np.asarray(nsx)) * FP.digits_to_int(np.asarray(nx))
    got_y = int(np.asarray(nsy)) * FP.digits_to_int(np.asarray(ny))
    assert got_x == want_x
    assert got_y == want_y
