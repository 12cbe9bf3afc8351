"""Frequency-domain-combined (iteration-fused) NTT multiplies:
multiply_iter / multiply_nr_iter against exact Python-int arithmetic.

The reference inverse-transforms every product separately and combines
in carry-sync passes (MultiplyNTT.cu:2943, Add.cu); here x²−y² (and the
NR combinations) merge in the frequency domain via NTT linearity, with
a signed CRT recovering sign-magnitude digits."""

import numpy as np
import pytest

import jax.numpy as jnp

from fractalshark_tpu.core.highprecision import HighPrecision
from fractalshark_tpu.ops.bignum import fixedpoint as FP


def _rand_mag(rng, spec):
    v = HighPrecision(rng.uniform(-2, 2), prec=spec.frac_bits + 20)
    return FP.hp_to_digits(v, spec)


def _exact_iter(x, y, F):
    """Reference semantics of multiply_iter on Python ints."""
    half = 1 << (16 * F - 1)
    d = x * x - y * y + half          # round-half-up on the signed value
    sd = 1 if d >= 0 else -1
    dmag = abs(d) >> (16 * F)
    xy = (x * y + half) >> (16 * F)
    return sd, dmag, xy


class TestMultiplyIter:
    # 8, 32: flat transforms; 2048, 4096: the four-step butterfly route
    @pytest.mark.parametrize("limbs", [8, 32, 2048, 4096])
    def test_matches_ints(self, limbs):
        spec = FP.FixedSpec.for_limbs(limbs)
        rng = np.random.default_rng(11)
        F = spec.frac_digits
        for _ in range(4):
            (sx, ax), (sy, ay) = _rand_mag(rng, spec), _rand_mag(rng, spec)
            (sd, d), xy = FP.multiply_iter(jnp.asarray(ax),
                                           jnp.asarray(ay), spec)
            x_i, y_i = FP.digits_to_int(ax), FP.digits_to_int(ay)
            esd, ed, exy = _exact_iter(x_i, y_i, F)
            assert FP.digits_to_int(np.asarray(xy)) == exy
            got = int(np.asarray(sd)) * FP.digits_to_int(np.asarray(d))
            assert got == esd * ed

    def test_zero_difference(self):
        spec = FP.FixedSpec.for_limbs(8)
        rng = np.random.default_rng(3)
        _, ax = _rand_mag(rng, spec)
        (sd, d), _ = FP.multiply_iter(jnp.asarray(ax), jnp.asarray(ax),
                                      spec)
        # x² − x² + half rounds to 0 magnitude, sign normalizes to +1
        assert FP.digits_to_int(np.asarray(d)) == 0
        assert int(np.asarray(sd)) == 1


class TestMultiplyNRIter:
    def test_matches_ints(self):
        spec = FP.FixedSpec.for_limbs(16)
        rng = np.random.default_rng(12)
        F = spec.frac_digits
        half = 1 << (16 * F - 1)
        vals = [_rand_mag(rng, spec) for _ in range(4)]
        (sx, ax), (sy, ay), (sdx, adx), (sdy, ady) = vals
        outs = FP.multiply_nr_iter(
            jnp.int32(sx), jnp.asarray(ax), jnp.int32(sy), jnp.asarray(ay),
            jnp.int32(sdx), jnp.asarray(adx), jnp.int32(sdy),
            jnp.asarray(ady), spec)
        x = sx * FP.digits_to_int(ax)
        y = sy * FP.digits_to_int(ay)
        dx = sdx * FP.digits_to_int(adx)
        dy = sdy * FP.digits_to_int(ady)

        def rhu(v):                   # impl semantics: |v+half| >> 16F
            t = v + half
            return (1 if t >= 0 else -1) * (abs(t) >> (16 * F))

        want = [rhu(x * x - y * y), rhu(x * y),
                rhu(x * dx - y * dy), rhu(x * dy + y * dx)]
        for (s, m), w in zip(outs, want):
            got = int(np.asarray(s)) * FP.digits_to_int(np.asarray(m))
            assert got == w


def test_iterate_z_16384_limbs_exact():
    """One full z <- z^2 + c update at the View #30 operand size (16384
    limbs, nfft 65536 — the four-step butterfly route the device orbit
    runs) on the real View #30 center, against Python ints."""
    from fractalshark_tpu.core.views import get_view_preset

    spec = FP.FixedSpec.for_limbs(16384)
    F = spec.frac_digits
    v30 = get_view_preset(30).ptz
    prec = spec.frac_bits - 20
    scx, dcx = FP.hp_to_digits(v30.pt_x.with_precision(prec), spec)
    scy, dcy = FP.hp_to_digits(v30.pt_y.with_precision(prec), spec)
    nsx, nx, nsy, ny = FP.iterate_z(
        jnp.int32(scx), jnp.asarray(dcx), jnp.int32(scy),
        jnp.asarray(dcy), jnp.int32(scx), jnp.asarray(dcx),
        jnp.int32(scy), jnp.asarray(dcy), spec)
    x = scx * FP.digits_to_int(dcx)
    y = scy * FP.digits_to_int(dcy)
    half, shift = 1 << (16 * F - 1), 16 * F

    def rhu(v):
        t = v + half
        return (1 if t >= 0 else -1) * (abs(t) >> shift)

    assert int(nsx) * FP.digits_to_int(np.asarray(nx)) == \
        rhu(x * x - y * y + (x << shift))
    assert int(nsy) * FP.digits_to_int(np.asarray(ny)) == \
        rhu(2 * x * y + (y << shift))
