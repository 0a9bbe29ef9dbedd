"""Host-side image utilities (numpy/scipy/PIL): PSNR, SSIM, gaussian-
prefiltered downsample and resize, bilinear resize, homography warp, grid
concat, read and save. The port's own copy of nero_tpu/utils/image.py.

Files go through PIL, where nero_tpu goes through imageio (whose PNG and
JPEG plugin is PIL): `imread` returns what imageio returns, uint8 for 8-bit
images and uint16 for 16-bit grayscale PNGs (the GlossySynthetic depth
maps), so both packages read each other's files to the bit."""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def compute_psnr(img_gt: np.ndarray, img_pr: np.ndarray) -> float:
    gt = img_gt.reshape(-1, 3).astype(np.float32)
    pr = img_pr.reshape(-1, 3).astype(np.float32)
    mse = float(np.mean((gt - pr) ** 2))
    return 10.0 * np.log10(255.0 * 255.0 / max(mse, 1e-12))


def compute_ssim(img_gt: np.ndarray, img_pr: np.ndarray, win_size: int = 11,
                 data_range: float = 255.0) -> float:
    gt = img_gt.astype(np.float64)
    pr = img_pr.astype(np.float64)
    if gt.ndim == 2:
        gt, pr = gt[..., None], pr[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    npix = win_size ** 2
    cov_norm = npix / (npix - 1)
    pad = (win_size - 1) // 2
    vals = []
    for c in range(gt.shape[-1]):
        x, y = gt[..., c], pr[..., c]
        ux, uy = uniform_filter(x, win_size), uniform_filter(y, win_size)
        uxx = uniform_filter(x * x, win_size)
        uyy = uniform_filter(y * y, win_size)
        uxy = uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def _gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    r = (ksize - 1) // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable gaussian blur with reflect-101 borders (cv2-compatible)."""
    k = _gaussian_kernel1d(sigma, ksize)
    r = (ksize - 1) // 2
    out = np.pad(img.astype(np.float64), [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2),
                 mode="reflect")
    out = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 0, out)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, mode="valid"), 1, out)
    return out.astype(img.dtype) if np.issubdtype(img.dtype, np.floating) else \
        np.clip(out + 0.5, 0, 255).astype(img.dtype)


def downsample_gaussian_blur(img: np.ndarray, ratio: float) -> np.ndarray:
    sigma = (1.0 / ratio) / 3.0
    ksize = int(np.ceil(((sigma - 0.8) / 0.3 + 1) * 2 + 1))
    ksize = ksize + 1 if ksize % 2 == 0 else ksize
    return gaussian_blur(img, ksize, sigma)


def resize_bilinear(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    from PIL import Image
    h, w = out_hw
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    img2 = img[..., None] if img.ndim == 2 else img
    chans = [np.asarray(Image.fromarray(img2[..., c].astype(np.float32), mode="F")
                        .resize((w, h), Image.BILINEAR)) for c in range(img2.shape[2])]
    out = np.stack(chans, axis=-1).astype(img.dtype)
    return out[..., 0] if img.ndim == 2 else out


def resize_img(img: np.ndarray, ratio: float) -> np.ndarray:
    """Gaussian-prefiltered resize by a scale ratio."""
    h, w = img.shape[:2]
    hn, wn = int(round(h * ratio)), int(round(w * ratio))
    src = downsample_gaussian_blur(img, ratio) if ratio < 1.0 else img
    return resize_bilinear(src, (hn, wn))


def warp_perspective(img: np.ndarray, H: np.ndarray, out_wh: tuple[int, int]) -> np.ndarray:
    """Homography warp (dst(x,y) = src(H^-1 [x,y,1])), bilinear, zeros outside.

    cv2.warpPerspective-compatible pixel-grid convention (no half-pixel shift).
    """
    from scipy.ndimage import map_coordinates
    w, h = out_wh
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    denom = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
    sx = (Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]) / denom
    sy = (Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]) / denom
    img2 = img[..., None] if img.ndim == 2 else img
    out = np.stack([map_coordinates(img2[..., c].astype(np.float64),
                                    [sy, sx], order=1, mode="constant", cval=0.0)
                    for c in range(img2.shape[2])], axis=-1)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(out + 0.5, 0, np.iinfo(img.dtype).max).astype(img.dtype)
    else:
        out = out.astype(img.dtype)
    return out[..., 0] if img.ndim == 2 else out


def concat_images(img0: np.ndarray, img1: np.ndarray, vert: bool = False) -> np.ndarray:
    if not vert:
        h0, h1 = img0.shape[0], img1.shape[0]
        if h0 < h1:
            img0 = np.pad(img0, [(0, h1 - h0)] + [(0, 0)] * (img0.ndim - 1))
        if h1 < h0:
            img1 = np.pad(img1, [(0, h0 - h1)] + [(0, 0)] * (img1.ndim - 1))
        return np.concatenate([img0, img1], axis=1)
    w0, w1 = img0.shape[1], img1.shape[1]
    if w0 < w1:
        img0 = np.pad(img0, [(0, 0), (0, w1 - w0)] + [(0, 0)] * (img0.ndim - 2))
    if w1 < w0:
        img1 = np.pad(img1, [(0, 0), (0, w0 - w1)] + [(0, 0)] * (img1.ndim - 2))
    return np.concatenate([img0, img1], axis=0)


def concat_images_list(*imgs, vert: bool = False) -> np.ndarray:
    out = imgs[0]
    for img in imgs[1:]:
        out = concat_images(out, img, vert)
    return out


def imread(path: str) -> np.ndarray:
    """The image as imageio reads it: palette images expanded to RGB(A),
    16-bit grayscale PNGs as uint16 (PIL opens them as mode I;16 or, in
    older versions, as 32-bit I)."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        arr = np.asarray(im)
        if im.mode.startswith("I;16") or (im.mode == "I" and im.format == "PNG"):
            arr = arr.astype(np.uint16)
    return arr


def imsave(path: str, img: np.ndarray):
    """PNG, JPEG, ... by the file's suffix; a uint16 2-D array becomes a
    16-bit grayscale PNG."""
    from PIL import Image
    Image.fromarray(img).save(path)
