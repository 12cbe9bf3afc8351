"""Multi-device rendering: pixel-row data parallelism over a device mesh.

The reference is single-GPU; its pixel-grid parallelism (CUDA grid,
``GPU_Render.h:116-120``) maps to sharding the pixel rows of the delta
grid across a 1-D ``jax.sharding.Mesh`` axis ("pixels"):

* per-pixel state (dz, counters) is row-sharded — pure data parallel,
  zero communication in the hot loop except the tiny all-reduce XLA
  inserts for the "any pixel live?" loop condition;
* the reference orbit and LA tables are small and replicated to every
  device (the analogue of the orbit/LA upload to the single GPU,
  ``GPU_Render.cu:432 InitializePerturb``);
* iteration statistics reduce with psum (``ReductionKernels.cuh``).

No shard_map is needed: the kernels are already pure array programs, so
NamedSharding annotations on inputs let XLA partition the masked while
loops (GSPMD), inserting collectives only where semantics require.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fractalshark_tpu.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu.ops import perturb
from fractalshark_tpu.ops.escape import PlainParams


def make_mesh(devices=None, axis: str = "pixels") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=(axis,))


def _shard_rows(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P("pixels", None))
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def _replicate(mesh: Mesh, tree):
    sh = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def sharded_perturb_render_hdr(results, ptz: PointZoomBBConverter,
                               width: int, height: int, max_iter: int,
                               mesh: Mesh, sub_dtype=np.float32):
    """Perturbation render with rows sharded across the mesh.

    height must be a multiple of the mesh size."""
    import jax.numpy as jnp

    n_dev = mesh.devices.size
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by mesh size {n_dev}")
    ox, oy = results.device_orbit(sub_dtype)
    dx, dy, cxo, cyo = perturb.delta_params(
        ptz, results.center_x, results.center_y, width, height)
    dc = perturb._dc_grids_hdr(dx, dy, cxo, cyo, width, height, sub_dtype)
    dc_re, dc_im, dc_e = _shard_rows(mesh, (dc.re, dc.im, dc.e))
    ox, oy = _replicate(mesh, (jnp.asarray(ox), jnp.asarray(oy)))
    return perturb._perturb_hdr_impl(
        ox, oy, dc_re, dc_im, dc_e, int(max_iter),
        jnp.int32(results.max_ref_iteration()))


def sharded_escape_render(params: PlainParams, width: int, height: int,
                          max_iter: int, mesh: Mesh, dtype=np.float64):
    """Plain escape render sharded by rows (coordinate grids are
    generated sharded via with_sharding_constraint inside the jit)."""
    import functools

    import jax.numpy as jnp

    n_dev = mesh.devices.size
    if height % n_dev:
        raise ValueError(f"height {height} not divisible by mesh size {n_dev}")
    sh = NamedSharding(mesh, P("pixels", None))

    @functools.partial(jax.jit, static_argnames=("w", "h"))
    def run(scalars, w, h):
        min_x, max_y, dx, dy, mi = (scalars[i] for i in range(5))
        xs = jnp.arange(w, dtype=scalars.dtype)
        ys = jnp.arange(h, dtype=scalars.dtype)
        cx = jax.lax.with_sharding_constraint(
            jnp.broadcast_to((min_x + xs * dx)[None, :], (h, w)), sh)
        cy = jax.lax.with_sharding_constraint(
            jnp.broadcast_to((max_y - ys * dy)[:, None], (h, w)), sh)
        max_it = mi.astype(jnp.int32)

        def step(_, s):
            k, zx, zy, it = s
            zx2 = zx * zx
            zy2 = zy * zy
            cont = (it == k) & ((zx2 + zy2) <= 4.0) & (k < max_it)
            nzy = 2.0 * zx * zy + cy
            nzx = zx2 - zy2 + cx
            zx = jnp.where(cont, nzx, zx)
            zy = jnp.where(cont, nzy, zy)
            return k + 1, zx, zy, it + cont.astype(jnp.int32)

        def cond(s):
            return jnp.logical_and(
                s[0] < max_it,
                jnp.max((s[3] == s[0]).astype(jnp.int32)) > 0)

        def chunk(s):
            return jax.lax.fori_loop(jnp.int32(0), jnp.int32(8), step, s)

        init = (jnp.int32(0), cx, cy, jnp.zeros((h, w), jnp.int32))
        _, _, _, it = jax.lax.while_loop(cond, chunk, init)
        return it.astype(jnp.uint32)

    import jax.numpy as jnp
    scal = jnp.asarray([params.min_x, params.max_y, params.dx, params.dy,
                        float(max_iter)], jnp.dtype(dtype))
    return run(scal, width, height)


def sharded_stats(iters, mesh: Mesh):
    """Min/Max/Sum of a sharded iteration buffer — XLA lowers these to
    psum/pmax collectives (ReductionKernels.cuh analogue)."""
    import jax.numpy as jnp

    return {
        "min": jnp.min(iters),
        "max": jnp.max(iters),
        "sum": jnp.sum(iters.astype(jnp.uint64)),
    }
