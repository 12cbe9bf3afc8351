"""Mesh-wired reference-orbit iteration — the whole mesh computes ONE
bignum.

The reference's premise for big operands is a grid-wide cooperative
kernel: every block participates in one NTT multiply with grid syncs
between passes (``HpSharkFloatLib/KernelHpSharkReferenceOrbit_cu.h:255``).
Here the digit axis of the z ← z² + c update is sharded over a 1-D
``jax.sharding.Mesh`` and the exchanges ride collectives:

* **transforms**: the limb-sharded four-step (parallel/ntt_sharded.py
  layout) with the butterfly stages inside the per-device blocks —
  ONE all_to_all per transform direction replaces the grid-wide
  transpose barrier;
* **pointwise + frequency combines**: fully local;
* **CRT/carry tail sharded over digits**: each device reconstructs and
  accumulates its contiguous digit block; cross-shard carry resolution
  is hierarchical Kogge-Stone — local prefix, then an all_gather of
  per-shard (generate, propagate) aggregates (M tiny values), then one
  combine — the analogue of the reference's grid-sync carry passes
  (``Add.cu``).

Outputs are BIT-IDENTICAL to the single-device ``fixedpoint.iterate_z``
(tests/test_parallel_orbit.py proves it on the 8-virtual-device CPU
mesh at the View-#30 operand size).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from fractalshark_tpu.ops.bignum import fixedpoint as FP
from fractalshark_tpu.ops.bignum import ntt as N
from fractalshark_tpu.parallel.ntt_sharded import AXIS, make_limb_mesh

__all__ = ["iterate_z_sharded", "make_limb_mesh"]

MASK = np.uint32(0xFFFF)


def _ks_gp(g, p):
    """Inclusive Kogge-Stone prefix of the carry monoid along the last
    axis; returns (G, P_prefix) — the doubling loop's final p IS the
    running AND-prefix of propagate."""
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
    return g, p


def _from_prev(tail, M: int):
    """ppermute a boundary slice one shard forward (shard s → s + 1);
    shard 0 receives zeros."""
    perm = [(i, (i + 1) % M) for i in range(M)]
    prev = jax.lax.ppermute(tail, AXIS, perm)
    idx = jax.lax.axis_index(AXIS)
    return jnp.where(idx == 0, jnp.zeros_like(prev), prev)


def _pshift(a, k: int, M: int):
    """Global flat shift by k digits across the sharded digit order:
    out[i] = a[i - k] (zeros shifted in at the global bottom)."""
    if k == 0:
        return a
    L = a.shape[-1]
    head = _from_prev(a[..., L - k:], M)
    return jnp.concatenate([head, a[..., :L - k]], axis=-1)


def _pcarry(acc, M: int, ret_cout: bool = False):
    """Sharded carry_propagate (bit-identical to the single-chip
    fixedpoint.carry_propagate): canonicalize per-digit sums < 2^32 to
    16-bit digits across the global sharded digit order.

    With ret_cout, also returns the carry OUT of the global top digit
    (u32 [K] replicated) — the two's-complement finish's sign bit."""
    hi = acc >> 16
    a = (acc & MASK) + _pshift(hi, 1, M)
    d = a & MASK
    g = a >> 16
    prop = jnp.where(d == MASK, jnp.uint32(1), jnp.uint32(0))
    G, Pp = _ks_gp(g, prop)
    allG = jax.lax.all_gather(G[..., -1], AXIS)      # [M, K]
    allP = jax.lax.all_gather(Pp[..., -1], AXIS)
    idx = jax.lax.axis_index(AXIS)
    C = jnp.zeros_like(G[..., -1])
    for j in range(M):
        Cj = allG[j] | (allP[j] & C)
        C = jnp.where(j < idx, Cj, C)
    # carry into local digit 0 is C; into digit i > 0 it is Gtot[i-1]
    Gtot = G | (Pp & C[..., None])
    sh = jnp.concatenate([C[..., None], Gtot[..., :-1]], axis=-1)
    out = (d + sh) & MASK
    if not ret_cout:
        return out
    couts = jax.lax.all_gather(hi[..., -1] | Gtot[..., -1], AXIS)
    return out, couts[M - 1]


def _psigned_finish(acc_p, acc_n, M: int):
    """(sign i32 [K] replicated, canonical digits [K, Lloc] sharded) of
    pos − neg; two's-complement subtract with global carry-out as the
    sign (⟺ pos ≥ neg, ties +1 — fixedpoint.signed_add semantics)."""
    Pd = _pcarry(acc_p, M)
    Nd = _pcarry(acc_n, M)
    idx = jax.lax.axis_index(AXIS)
    one_head = jnp.where(
        (jnp.arange(Pd.shape[-1], dtype=jnp.int32) == 0) & (idx == 0),
        jnp.uint32(1), jnp.uint32(0))
    u, cout = _pcarry(Pd + (MASK - Nd) + one_head, M, ret_cout=True)
    v = _pcarry((MASK - u) + one_head, M)
    pos = cout > 0
    mag = jnp.where(pos[..., None], u, v)
    nz = jax.lax.pmax(jnp.max(mag, axis=-1), AXIS) > 0
    sign = jnp.where(pos | ~nz, jnp.int32(1), jnp.int32(-1))
    return sign, mag


def _pparts_acc(hi, lo, M: int):
    """Scatter each 64-bit coefficient's four 16-bit parts into digit
    positions k..k+3 across shard boundaries and sum."""
    acc = lo & MASK
    for k, part in ((1, lo >> 16), (2, hi & MASK), (3, hi >> 16)):
        acc = acc + _pshift(part, k, M)
    return acc


def _pstreams(r1, r2, M: int, signed: bool, double: bool, gsign=None):
    """(acc_p, acc_n) digit-sum accumulators of one CRT'd product row
    pair (fixedpoint._signed_streams/_unsigned_stream, sharded)."""
    hi, lo = FP._crt_rec(r1, r2)
    if signed:
        neg = (hi > FP._HALF_HI) | ((hi == FP._HALF_HI) &
                                    (lo > FP._HALF_LO))
        nlo = FP._P1P2_LO - lo
        bb = jnp.where(FP._P1P2_LO < lo, jnp.uint32(1), jnp.uint32(0))
        nhi = FP._P1P2_HI - hi - bb
        if double:
            hi = (hi << 1) | (lo >> 31)
            lo = lo << 1
            nhi = (nhi << 1) | (nlo >> 31)
            nlo = nlo << 1
        z = jnp.uint32(0)
        acc_p = _pparts_acc(jnp.where(neg, z, hi),
                            jnp.where(neg, z, lo), M)
        acc_n = _pparts_acc(jnp.where(neg, nhi, z),
                            jnp.where(neg, nlo, z), M)
        return acc_p, acc_n
    if double:
        hi = (hi << 1) | (lo >> 31)
        lo = lo << 1
    parts = _pparts_acc(hi, lo, M)
    z = jnp.zeros_like(parts)
    return (jnp.where(gsign > 0, parts, z),
            jnp.where(gsign > 0, z, parts))


@functools.partial(jax.jit, static_argnames=("spec", "mesh"))
def iterate_z_sharded(sx, x, sy, y, scx, cx, scy, cy, *,
                      spec: FP.FixedSpec, mesh):
    """ONE full z ← z² + c update with every heavy axis sharded over
    the mesh — drop-in replacement for fixedpoint.iterate_z (same
    signature semantics, bit-identical results)."""
    nf = spec.nfft
    D = spec.digits
    F = spec.frac_digits
    M = int(np.prod(mesh.devices.shape))
    rows = 4
    c = N._fourstep_consts(nf, rows)
    n1, n2 = c["n1"], c["n2"]
    assert 2 * D == nf, "sharded tail needs the flat digit layout"
    p_col, _ = N._row_consts(rows)
    p2c, pp2c = N._row_consts(2)
    Lloc = nf // M

    pad = nf - D
    vx = jnp.concatenate([x, jnp.zeros((pad,), jnp.uint32)])
    vy = jnp.concatenate([y, jnp.zeros((pad,), jnp.uint32)])
    stacked = jnp.stack([vx, vx, vy, vy]).reshape(rows, n1, n2)

    zfull = jnp.zeros((nf,), jnp.uint32)
    cfx = zfull.at[F:F + D].set(cx)
    cfy = zfull.at[F:F + D].set(cy)
    rnd = zfull.at[F - 1].set(jnp.uint32(1 << 15))
    sgs = jnp.stack([scx, scy, sx * sy]).astype(jnp.int32)

    # inverse scaling constants (n^-1 · R per row)
    sc = np.empty((rows, 1, 1), np.uint32)
    scp = np.empty((rows, 1, 1), np.uint32)
    for r in range(rows):
        p = (N.P1, N.P2)[r % 2]
        v = (pow(nf, p - 2, p) << 32) % p
        sc[r, 0, 0] = v
        scp[r, 0, 0] = (v << 32) // p

    t1, t1p = (jnp.asarray(a) for a in c["t1"])
    t1i, t1ip = (jnp.asarray(a) for a in c["t1i"])

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None, AXIS), P(None, None, AXIS),
                  P(None, None, AXIS), P(None, None, AXIS),
                  P(None, None, AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(), P(None, AXIS)),
        check_vma=False)
    def body(a, t1_, t1p_, t1i_, t1ip_, cfx_, cfy_, rnd_, sgs_):
        pc3 = p_col[:, :, None]
        # ---- forward four-step: local phases + ONE all_to_all ----
        b = N._axis0_dif(a, c["tw1_f"], p_col)
        b = N._shoup_mul(b, t1_, t1p_, pc3)
        bt = jax.lax.all_to_all(b, AXIS, split_axis=1, concat_axis=2,
                                tiled=True)
        bt = jnp.transpose(bt, (0, 2, 1))
        f = N._axis0_dif(bt, c["tw2_f"], p_col)     # [4, n2, n1/M]

        # ---- pointwise + frequency combines (local) ----
        fx, fy = f[0:2], f[2:4]
        pcl = p2c[:, :, None]
        ppl = pp2c[:, :, None]
        d = N._mod_sub_rows(N._mont_mul_rows(fx, fx, pcl, ppl),
                            N._mont_mul_rows(fy, fy, pcl, ppl), pcl)
        xy = N._mont_mul_rows(fx, fy, pcl, ppl)
        e = jnp.concatenate([d, xy], axis=0)            # [4, n2, n1/M]

        # ---- inverse four-step ----
        bt2 = N._axis0_dit(e, c["tw2_i"], p_col)
        b2 = jnp.transpose(bt2, (0, 2, 1))
        b2 = jax.lax.all_to_all(b2, AXIS, split_axis=2, concat_axis=1,
                                tiled=True)
        b2 = N._shoup_mul(b2, t1i_, t1ip_, pc3)
        yv = N._axis0_dit(b2, c["tw1_i"], p_col)
        inv_loc = N._shoup_mul(yv, jnp.asarray(sc), jnp.asarray(scp),
                               pc3)                     # [4, n1, n2/M]

        # ---- reshard to contiguous digit blocks (one small a2a) ----
        blk = jax.lax.all_to_all(inv_loc, AXIS, split_axis=1,
                                 concat_axis=2, tiled=True)
        r = blk.reshape(rows, Lloc)

        # ---- CRT/carry tail, sharded over digits ----
        px, nx_ = _pstreams(r[0], r[1], M, signed=True, double=False)
        py, ny_ = _pstreams(r[2], r[3], M, signed=False, double=True,
                            gsign=sgs_[2])
        z = jnp.zeros_like(cfx_)
        px = px + jnp.where(sgs_[0] > 0, cfx_, z) + rnd_
        nx_ = nx_ + jnp.where(sgs_[0] > 0, z, cfx_)
        py = py + jnp.where(sgs_[1] > 0, cfy_, z) + rnd_
        ny_ = ny_ + jnp.where(sgs_[1] > 0, z, cfy_)
        sign, mag = _psigned_finish(jnp.stack([px, py]),
                                    jnp.stack([nx_, ny_]), M)
        return sign, mag

    signs, dig = body(stacked, t1, t1p, t1i, t1ip, cfx, cfy, rnd, sgs)
    return (signs[0], dig[0, F:F + D], signs[1], dig[1, F:F + D])
