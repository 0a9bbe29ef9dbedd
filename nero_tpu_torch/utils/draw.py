"""Debug drawing helpers: colormaps, point overlays, epipolar lines.

The counterpart of nero_tpu/utils/draw.py in numpy alone: the jet colormap
is matplotlib's (its segment data and 256-entry lookup table, rebuilt here)
so that the images are the same without matplotlib. No training path calls
these, here as in nero_tpu.
"""
from __future__ import annotations

import numpy as np

from nero_tpu_torch.utils.image import concat_images

# matplotlib's jet: (x, y0, y1) breakpoints per channel
_JET = {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
                  (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0))}
_N = 256


def _lookup_table(data) -> np.ndarray:
    """The N-entry table of one channel, as matplotlib interpolates it."""
    a = np.asarray(data, np.float64)
    x, y0, y1 = a[:, 0] * (_N - 1), a[:, 1], a[:, 2]
    xind = (_N - 1) * np.linspace(0, 1, _N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


_JET_LUT = np.stack([_lookup_table(_JET[c]) for c in ("red", "green", "blue")], -1)


def jet_colormap(vals: np.ndarray) -> np.ndarray:
    """[N] values in [0,1] -> [N,3] uint8 jet colors (NaN -> black)."""
    x = np.clip(np.asarray(vals, np.float64), 0, 1) * _N
    bad = np.isnan(x)
    x[x == _N] = _N - 1
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    rgb = _JET_LUT.take(np.where(bad, 0, idx), axis=0, mode="clip")
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def depth_to_color(depth: np.ndarray, mask: np.ndarray | None = None) -> np.ndarray:
    """Depth map -> jet-colored uint8 image (normalised over the mask)."""
    d = np.asarray(depth, np.float64)
    m = np.ones_like(d, bool) if mask is None else mask
    if m.any():
        lo, hi = d[m].min(), d[m].max()
        d = (d - lo) / max(hi - lo, 1e-9)
    img = jet_colormap(d.reshape(-1)).reshape(*d.shape, 3)
    img[~m] = 0
    return img


def draw_points(img: np.ndarray, points: np.ndarray, color=(0, 255, 0),
                radius: int = 1) -> np.ndarray:
    """Overlay 2D points on an image (pure numpy stamping)."""
    out = img.copy()
    h, w = img.shape[:2]
    for x, y in np.asarray(points, np.int64):
        x0, x1 = max(x - radius, 0), min(x + radius + 1, w)
        y0, y1 = max(y - radius, 0), min(y + radius + 1, h)
        if x0 < x1 and y0 < y1:
            out[y0:y1, x0:x1] = color
    return out


def draw_line(img: np.ndarray, p0, p1, color=(255, 0, 0)) -> np.ndarray:
    """Rasterise a line segment with dense sampling (debug-quality)."""
    out = img.copy()
    h, w = img.shape[:2]
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    n = int(np.linalg.norm(p1 - p0)) * 2 + 2
    ts = np.linspace(0, 1, n)
    pts = p0[None] * (1 - ts[:, None]) + p1[None] * ts[:, None]
    pts = np.round(pts).astype(np.int64)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    out[pts[ok, 1], pts[ok, 0]] = color
    return out


def draw_epipolar_line(img: np.ndarray, F: np.ndarray, point: np.ndarray,
                       color=(255, 0, 0)) -> np.ndarray:
    """Draw the epipolar line of `point` (in the other view) given F."""
    h, w = img.shape[:2]
    l = F @ np.asarray([point[0], point[1], 1.0])
    a, b, c = l
    if abs(b) > abs(a):
        p0 = (0.0, -c / b)
        p1 = (w - 1.0, -(c + a * (w - 1)) / b)
    else:
        p0 = (-c / a, 0.0)
        p1 = (-(c + b * (h - 1)) / a, h - 1.0)
    return draw_line(img, p0, p1, color)


def draw_correspondences(img0: np.ndarray, img1: np.ndarray,
                         pts0: np.ndarray, pts1: np.ndarray) -> np.ndarray:
    """Side-by-side match visualisation (colours from numpy's global
    generator, as nero_tpu draws them)."""
    out = concat_images(img0, img1)
    off = img0.shape[1]
    for (x0, y0), (x1, y1) in zip(np.asarray(pts0), np.asarray(pts1)):
        out = draw_line(out, (x0, y0), (x1 + off, y1),
                        color=tuple(np.random.randint(0, 255, 3).tolist()))
    return out
