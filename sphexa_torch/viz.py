"""In-situ visualization hook (sphexa_tpu/viz.py, copied: numpy and zlib
only): per-iteration slice / column-projection renders, written as PNG
next to the run output.

The role of the reference's Ascent/Catalyst adaptors
(main/src/ascent_adaptor.h:1-156, catalyst_adaptor.h:1-135,
insitu_viz.h): an adaptor object with init / execute / finalize hooks
called around the main loop. Where the reference hands the mesh to an
external in-situ library, this renders directly — a mass-weighted 2D
histogram (column density) or a thin z-slice of it — with a small
stdlib-only PNG encoder, so the hook has zero optional dependencies and
works on any machine the simulation runs on.

Select from the CLI with ``--insitu slice|projection`` and
``--insitu-every N``: the CLI renders the deposited snapshot grids
(``execute_grid``), and the mode only names the frames.
"""

import os
import struct
import zlib
from typing import Optional

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    return np.asarray(a.cpu()) if hasattr(a, "cpu") else np.asarray(a)


def _png_bytes(img: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG (stdlib zlib/struct only)."""
    h, w, _ = img.shape
    raw = b"".join(
        b"\x00" + img[row].astype(np.uint8).tobytes() for row in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _colormap(v: np.ndarray) -> np.ndarray:
    """[0,1] -> inferno-like RGB ramp (piecewise-linear, (H,W,3) uint8)."""
    stops = np.array(
        [(0.00, (0, 0, 4)), (0.25, (87, 16, 110)), (0.50, (188, 55, 84)),
         (0.75, (249, 142, 9)), (1.00, (252, 255, 164))],
        dtype=object,
    )
    xs = np.array([s[0] for s in stops], np.float64)
    cs = np.array([s[1] for s in stops], np.float64)  # (5, 3)
    out = np.empty(v.shape + (3,), np.float64)
    for c in range(3):
        out[..., c] = np.interp(v, xs, cs[:, c])
    return np.clip(out, 0, 255).astype(np.uint8)


def render_field(
    x, y, weights, extent, resolution: int = 512, log_scale: bool = True
) -> np.ndarray:
    """Mass-weighted 2D histogram -> color image ((res, res, 3) uint8).

    ``extent`` = (xmin, xmax, ymin, ymax). The render is deliberately a
    deposit (not an SPH re-smoothing): at viz resolutions the histogram
    is indistinguishable and costs O(N).
    """
    xmin, xmax, ymin, ymax = extent
    img, _, _ = np.histogram2d(
        np.asarray(y), np.asarray(x), bins=resolution,
        range=[[ymin, ymax], [xmin, xmax]], weights=np.asarray(weights),
    )
    if log_scale:
        img = np.log10(img + 1e-12)
    finite = img[np.isfinite(img)]
    lo = np.percentile(finite, 1.0) if finite.size else 0.0
    hi = np.percentile(finite, 99.9) if finite.size else 1.0
    v = np.clip((img - lo) / max(hi - lo, 1e-30), 0.0, 1.0)
    return _colormap(v[::-1])  # image row 0 = top = ymax


def render_grid(grid, log_scale: bool = True,
                upsample: int = 16) -> np.ndarray:
    """Pre-deposited (G, G) field grid -> color image, same log/clip/
    colormap treatment as ``render_field``. This is the snapshot-ring
    consumer path (observables/snapshot.py frames): the deposit already
    happened in-graph, so rendering is pure host pixel work. Grid row 0
    is the low-coordinate row; the image flips so row 0 = top."""
    img = np.asarray(grid, np.float64)
    if log_scale:
        img = np.log10(np.abs(img) + 1e-12)
    finite = img[np.isfinite(img)]
    lo = np.percentile(finite, 1.0) if finite.size else 0.0
    hi = np.percentile(finite, 99.9) if finite.size else 1.0
    v = np.clip((img - lo) / max(hi - lo, 1e-30), 0.0, 1.0)
    if upsample > 1:
        v = np.repeat(np.repeat(v, upsample, axis=0), upsample, axis=1)
    return _colormap(v[::-1])


class InsituViz:
    """Per-iteration render hook (the Ascent-adaptor role).

    mode "projection": column density over (x, y).
    mode "slice": particles within a half-thickness of the z mid-plane.
    """

    def __init__(self, out_dir: str, mode: str = "projection",
                 every: int = 1, resolution: int = 512,
                 slice_rel_thickness: float = 0.05,
                 writer=None):
        if mode not in ("projection", "slice"):
            raise ValueError("insitu mode must be 'projection' or 'slice'")
        self.out_dir = out_dir
        self.mode = mode
        self.every = max(1, int(every))
        self.resolution = resolution
        self.slice_rel_thickness = slice_rel_thickness
        # test seam / alternate sink (the Catalyst-vs-Ascent choice):
        # writer(path, png_bytes) defaults to a plain file write
        self._writer = writer or self._write_file
        self.rendered = 0

    @staticmethod
    def _write_file(path: str, data: bytes):
        with open(path, "wb") as f:
            f.write(data)

    def init(self):
        os.makedirs(self.out_dir, exist_ok=True)

    def execute(self, state, box, iteration: int) -> Optional[str]:
        """Render one frame if due; returns the written path or None."""
        if iteration % self.every:
            return None
        x = _host(state.x)
        y = _host(state.y)
        z = _host(state.z)
        m = _host(state.m)
        lo = _host(box.lo).astype(np.float64)
        lengths = _host(box.lengths).astype(np.float64)
        extent = (lo[0], lo[0] + lengths[0], lo[1], lo[1] + lengths[1])
        if self.mode == "slice":
            z0 = lo[2] + 0.5 * lengths[2]
            half = self.slice_rel_thickness * lengths[2]
            keep = np.abs(z - z0) <= half
            x, y, m = x[keep], y[keep], m[keep]
        img = render_field(x, y, m, extent, self.resolution)
        path = os.path.join(
            self.out_dir, f"insitu_{self.mode}_{iteration:06d}.png"
        )
        self._writer(path, _png_bytes(img))
        self.rendered += 1
        return path

    def execute_grid(self, grid, iteration: int) -> Optional[str]:
        """Render one frame from a deposited snapshot grid (the ring
        consumer: sim.drain_snapshots() frames instead of the particles'
        state: host pixel work only, no read of the card). Frame naming
        and the rendered counter match execute(); a multi-field (F, G,
        G) grid renders its first field."""
        if iteration % self.every:
            return None
        g = np.asarray(grid, np.float64)
        if g.ndim == 3:
            g = g[0]
        upsample = max(1, self.resolution // max(1, g.shape[0]))
        img = render_grid(g, upsample=upsample)
        path = os.path.join(
            self.out_dir, f"insitu_{self.mode}_{iteration:06d}.png"
        )
        self._writer(path, _png_bytes(img))
        self.rendered += 1
        return path

    def finalize(self):
        return self.rendered
