"""Iteration→color mapping + box antialiasing + iteration statistics.

Device-side equivalents of the reference kernels:

* ``antialiasing_kernel`` (FractalSharkGpuLib/AntialiasingKernel.cuh:3-71):
  per output pixel, average ``palette[(iters >> aux_depth) % num_colors]``
  over the aa×aa input box; interior pixels (iters == max) contribute
  black; alpha = 65535.
* ``ReductionKernels.cuh``: Min/Max/Sum of iteration counts (here plain
  jnp reductions — XLA emits the optimal tree; under shard_map these
  become psum/pmin/pmax collectives).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("antialiasing",))
def color_from_iters(iters, palette, n_iterations, aux_depth, antialiasing=1):
    """Map iteration counts to RGBA16.

    iters: [H*aa, W*aa] uint32/uint64; palette: [C, 3] uint16 (device);
    returns [H, W, 4] uint16.
    """
    num_colors = palette.shape[0]
    idx = (iters >> aux_depth.astype(iters.dtype)) % jnp.asarray(
        num_colors, iters.dtype)
    # NOTE: an unrolled 256-way select ladder in place of this gather
    # was tried on an earlier accelerator and rejected for its compile
    # time; not measured on the H100.
    rgb = palette[idx.astype(jnp.int32)]  # [Haa, Waa, 3]
    interior = (iters >= n_iterations.astype(iters.dtype))[..., None]
    rgb = jnp.where(interior, jnp.zeros_like(rgb), rgb)
    if antialiasing > 1:
        h, w, _ = rgb.shape
        rgb = rgb.reshape(h // antialiasing, antialiasing,
                          w // antialiasing, antialiasing, 3)
        rgb = rgb.astype(jnp.uint32).sum(axis=(1, 3)) // (antialiasing ** 2)
        rgb = rgb.astype(jnp.uint16)
    alpha = jnp.full(rgb.shape[:2] + (1,), 65535, jnp.uint16)
    return jnp.concatenate([rgb, alpha], axis=-1)


@jax.jit
def iteration_stats(iters):
    """{min, max, sum} of iteration counts (ReductionResults,
    GPU_Types.h:40-50). Runs on device; one scalar readback."""
    return {
        "min": jnp.min(iters),
        "max": jnp.max(iters),
        "sum": jnp.sum(iters.astype(jnp.uint64)),
    }


def rgba16_to_rgba8(rgba16) -> np.ndarray:
    """Convert device RGBA16 to host uint8 for 8-bit PNG output."""
    arr = np.asarray(rgba16)
    return (arr >> 8).astype(np.uint8)
