"""Limb-sharded multi-device NTT — one bignum spread over the mesh.

The reference scales one high-precision multiply across the whole GPU
with a grid-wide cooperative kernel
(``HpSharkFloatLib/KernelHpSharkReferenceOrbit_cu.h:255``: every block
participates in one NTT, grid-sync between passes). The equivalent
here shards the *digit axis* over a 1-D ``jax.sharding.Mesh`` and rides
collectives (NCCL over NVLink on a GPU host) instead of grid syncs:

* Bailey four-step factorisation n = n1·n2 (ops/bignum/ntt.py): with the
  coefficient tensor laid out ``[R, n1, n2]`` and sharded over n2, the
  stage-1 butterflies pair elements along n1 — fully LOCAL on every
  device.  The twiddle-matrix multiply is elementwise (its table is
  sharded the same way).
* The four-step transpose is the ONLY cross-device exchange: a single
  ``jax.lax.all_to_all`` over the mesh axis (the analogue of the
  reference's grid-wide barrier + shared-memory transpose).
* Stage-2 butterflies pair along n2 — local again after the exchange.

One forward transform therefore costs exactly one all-to-all of the
coefficient tensor; a full bignum multiply costs 4 (two forward, two
inverse... shared-transform tricks reduce the forward count exactly as
in the single-device pipeline).

Numerically this is the *same* chain as ``ntt.fourstep_forward`` /
``fourstep_inverse_scaled`` — outputs are bit-identical to the
single-device transforms (tests/test_parallel_ntt.py proves it on an
8-virtual-device CPU mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fractalshark_tpu.ops.bignum import ntt as N

AXIS = "limbs"


def make_limb_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=(AXIS,))


def _shard_last(mesh: Mesh, a):
    spec = P(*([None] * (a.ndim - 1) + [AXIS]))
    return jax.device_put(a, NamedSharding(mesh, spec))


@functools.partial(jax.jit, static_argnames=("n", "mesh"))
def _fwd_impl(a, t1, t1p, n, mesh):
    rows = a.shape[0]
    c = N._fourstep_consts(n, rows)
    p_col, _ = N._row_consts(rows)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None, AXIS), P(None, None, AXIS),
                  P(None, None, AXIS)),
        out_specs=P(None, None, AXIS))
    def fwd(a, t1, t1p):
        b = N._axis0_dif(a, c["tw1_f"], p_col)
        b = N._shoup_mul(b, t1, t1p, p_col[:, :, None])
        # four-step transpose = ONE all-to-all over the limb axis
        bt = jax.lax.all_to_all(b, AXIS, split_axis=1, concat_axis=2,
                                tiled=True)
        bt = jnp.transpose(bt, (0, 2, 1))
        return N._axis0_dif(bt, c["tw2_f"], p_col)

    return fwd(a, t1, t1p)


@functools.partial(jax.jit, static_argnames=("n", "mesh", "extra_scale_r"))
def _inv_impl(e, t1i, t1ip, n, mesh, extra_scale_r):
    rows = e.shape[0]
    c = N._fourstep_consts(n, rows)
    p_col, _ = N._row_consts(rows)
    sc = np.empty((rows, 1), np.uint32)
    scp = np.empty((rows, 1), np.uint32)
    for r in range(rows):
        p = (N.P1, N.P2)[r % 2]
        v = pow(n, p - 2, p)
        if extra_scale_r:
            v = (v << 32) % p
        sc[r, 0] = v
        scp[r, 0] = (v << 32) // p

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, None, AXIS), P(None, None, AXIS),
                  P(None, None, AXIS)),
        out_specs=P(None, None, AXIS))
    def inv(e, t1i, t1ip):
        bt = N._axis0_dit(e, c["tw2_i"], p_col)
        b = jnp.transpose(bt, (0, 2, 1))
        b = jax.lax.all_to_all(b, AXIS, split_axis=2, concat_axis=1,
                               tiled=True)
        b = N._shoup_mul(b, t1i, t1ip, p_col[:, :, None])
        y = N._axis0_dit(b, c["tw1_i"], p_col)
        return N._shoup_mul(y, jnp.asarray(sc)[:, :, None],
                            jnp.asarray(scp)[:, :, None], p_col[:, :, None])

    return inv(e, t1i, t1ip)


def fourstep_forward_sharded(x, n: int, mesh: Mesh):
    """[R, n] plain-domain rows → scrambled spectra [R, n2, n1] sharded
    over the last axis; bit-identical to ntt.fourstep_forward."""
    rows = x.shape[0]
    c = N._fourstep_consts(n, rows)
    n1, n2 = c["n1"], c["n2"]
    t1, t1p = c["t1"]
    a = _shard_last(mesh, jnp.reshape(x, (rows, n1, n2)))
    t1s = _shard_last(mesh, jnp.asarray(t1))
    t1ps = _shard_last(mesh, jnp.asarray(t1p))
    return _fwd_impl(a, t1s, t1ps, n, mesh)


def fourstep_inverse_sharded(e, n: int, mesh: Mesh,
                             extra_scale_r: bool = True):
    """Inverse of fourstep_forward_sharded; returns [R, n1, n2] sharded
    over the last axis (flatten for digits)."""
    rows = e.shape[0]
    c = N._fourstep_consts(n, rows)
    t1i, t1ip = c["t1i"]
    t1is = _shard_last(mesh, jnp.asarray(t1i))
    t1ips = _shard_last(mesh, jnp.asarray(t1ip))
    return _inv_impl(e, t1is, t1ips, n, mesh, extra_scale_r)


@functools.partial(jax.jit, static_argnames=("mesh",))
def _pointwise_sq3(f, mesh):
    """Frequency-domain x², y², x·y from stacked spectra
    f = [4, ...] rows (x@p1, x@p2, y@p1, y@p2) — Montgomery pointwise
    (REDC's R⁻¹ cancelled by the inverse scaling), sharded elementwise."""
    p_col, pp_col = N._row_consts(4)

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P(None, None, AXIS),),
                       out_specs=P(None, None, AXIS))
    def pw(f):
        fx = f[:2]
        fy = f[2:]
        pc = p_col[:2, :, None]
        ppc = pp_col[:2, :, None]
        xx = N._mont_mul_rows(fx, fx, pc, ppc)
        yy = N._mont_mul_rows(fy, fy, pc, ppc)
        xy = N._mont_mul_rows(fx, fy, pc, ppc)
        return jnp.concatenate([xx, yy, xy], axis=0)

    return pw(f)


def multiply_3way_sharded(ax_digits: np.ndarray, ay_digits: np.ndarray,
                          mesh: Mesh):
    """x², y², x·y exact convolutions of two digit vectors with every
    transform limb-sharded over the mesh. Returns three [2, n] spectra-
    domain... no — returns the three convolution digit rows [6, n]
    (u32, CRT residue pairs), gathered, ready for the existing CRT/carry
    (fixedpoint).  The single-chip counterpart is ntt.multiply-style
    3-way sharing: two forward transforms serve all three products."""
    n = int(len(ax_digits))
    x = np.zeros((4, n), np.uint32)
    x[0] = x[1] = ax_digits
    x[2] = x[3] = ay_digits
    f = fourstep_forward_sharded(jnp.asarray(x), n, mesh)
    prod = _pointwise_sq3(f, mesh)
    inv = fourstep_inverse_sharded(prod, n, mesh)
    rows = inv.shape[0]
    return jnp.reshape(inv, (rows, n))
