"""Multi-host tile farming (DCN) with checkpointed tile queues.

The reference is single-node; its scale-out analogue in SURVEY.md §2.5
is farming pixel TILES of one huge render across hosts: device
parallelism stays *inside* a host (sharded render over the local mesh,
parallel/render.py), while hosts coordinate over DCN.  Design:

* a render is cut into fixed tiles (row bands by default);
* each process claims the tiles with ``index % num_processes ==
  process_index`` (static partition — no cross-host scheduler chatter;
  DCN is for bulk results, not fine-grained work stealing);
* finished tiles land in a *checkpoint directory* (one ``.npy`` per
  tile + a done-marker) so a preempted host resumes without recompute —
  the reference's save-as-you-go orbit files (``Vectors.h``
  AddPointOptions) applied to tiles;
* ``gather()`` assembles the full image: in a ``jax.distributed``
  session the tile results ride DCN via
  ``multihost_utils.process_allgather``; standalone it reads the
  checkpoint directory.

Single-process use degenerates to a resumable tiled renderer (used by
the tray queue for poster-size renders).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Tile:
    index: int
    y0: int
    h: int


def make_tiles(height: int, tile_h: int) -> list[Tile]:
    tiles = []
    y = 0
    i = 0
    while y < height:
        h = min(tile_h, height - y)
        tiles.append(Tile(i, y, h))
        y += h
        i += 1
    return tiles


class TileFarm:
    """Checkpointed tile queue for one render.

    ``render_tile(ptz, width, height, y0, h) -> np.ndarray[h, width]``
    is supplied by the caller (typically a closure over
    Fractal/renderers so any registered algorithm can be farmed)."""

    def __init__(self, ptz, width: int, height: int, tile_h: int,
                 ckpt_dir: str, process_index: int = 0,
                 process_count: int = 1):
        self.ptz = ptz
        self.width = width
        self.height = height
        self.tiles = make_tiles(height, tile_h)
        self.ckpt_dir = ckpt_dir
        self.process_index = process_index
        self.process_count = process_count
        os.makedirs(ckpt_dir, exist_ok=True)
        meta = os.path.join(ckpt_dir, "farm.json")
        if not os.path.exists(meta):
            with open(meta, "w") as f:
                json.dump({"width": width, "height": height,
                           "tile_h": tile_h,
                           "tiles": len(self.tiles)}, f)

    # ------------------------------------------------------------ queue

    def my_tiles(self) -> list[Tile]:
        return [t for t in self.tiles
                if t.index % self.process_count == self.process_index]

    def _tile_path(self, t: Tile) -> str:
        return os.path.join(self.ckpt_dir, f"tile_{t.index:05d}.npy")

    def is_done(self, t: Tile) -> bool:
        return os.path.exists(self._tile_path(t))

    def pending(self) -> list[Tile]:
        return [t for t in self.my_tiles() if not self.is_done(t)]

    def run(self, render_tile, progress=None, abort_monitor=None) -> int:
        """Render this process's pending tiles; returns tiles rendered.
        Already-checkpointed tiles are skipped (resume)."""
        n = 0
        for t in self.pending():
            if abort_monitor is not None and abort_monitor.aborted():
                break
            out = np.asarray(render_tile(self.ptz, self.width,
                                         self.height, t.y0, t.h))
            assert out.shape == (t.h, self.width), out.shape
            tmp = self._tile_path(t) + ".tmp.npy"
            np.save(tmp, out)
            os.replace(tmp, self._tile_path(t))
            n += 1
            if progress is not None:
                progress(t, out)
        return n

    # ----------------------------------------------------------- gather

    def gather_local(self, dtype=np.uint32) -> np.ndarray:
        """Assemble from the checkpoint directory (all tiles must be
        done — by this or other processes sharing the directory)."""
        img = np.zeros((self.height, self.width), dtype)
        for t in self.tiles:
            p = self._tile_path(t)
            if not os.path.exists(p):
                raise FileNotFoundError(f"tile {t.index} missing: {p}")
            img[t.y0:t.y0 + t.h] = np.load(p)
        return img

    def gather_dcn(self, dtype=np.uint32) -> np.ndarray:
        """Assemble over DCN in a jax.distributed session: each host
        contributes its own tiles (zeros elsewhere) and the full image
        is summed across processes with a global collective — bulk
        results ride the data-center network, no shared filesystem
        needed."""
        import jax
        from jax.experimental import multihost_utils

        part = np.zeros((self.height, self.width), np.uint32)
        for t in self.my_tiles():
            p = self._tile_path(t)
            part[t.y0:t.y0 + t.h] = np.load(p)
        if jax.process_count() == 1:
            return part.astype(dtype)
        # process_allgather stacks per-process arrays: [P, H, W]
        allp = multihost_utils.process_allgather(part)
        return np.asarray(allp).sum(axis=0).astype(dtype)


def render_tile_escape(alg_dtype=np.float32, max_iter: int = 512):
    """A render_tile closure over the plain escape kernel (row-band
    crops share the full view's pixel grid exactly)."""
    import jax.numpy as jnp

    from fractalshark_tpu.ops import escape

    def fn(ptz, width, height, y0, h):
        p = escape.PlainParams.from_view(ptz, width, height)
        dt = jnp.float32 if alg_dtype == np.float32 else jnp.float64
        return np.asarray(
            escape.escape_jax(p, width, h, max_iter, dtype=dt, y0=y0))

    return fn
