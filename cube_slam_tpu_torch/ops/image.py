"""Image kernels: Sobel, Canny edge detection, blurs, resizes and crops.

PyTorch counterpart of cube_slam_tpu/ops/image.py, the replacements for the
OpenCV kernels the reference calls in its detector hot path
(detect_3d_cuboid/src/box_proposal_detail.cpp:195-199: cv::Canny(gray(bbox),
80, 200) then cv::distanceTransform). Every function takes (H, W) or a batch
(B, H, W) of float32 images / bool maps.

Canny follows OpenCV semantics: 3x3 Sobel with replicate border, L1 gradient
magnitude against the thresholds, 4-sector non-maximum suppression, and
8-connected hysteresis (a dilation run to its fixpoint). The Gaussian blur,
pyrDown and the linear resize feed the ORB pyramid (ops/orb.py); they sum
their taps in the JAX package's order so the levels match it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import table

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_TG22 = 0.4142135623730951  # tan(22.5 deg)

# hysteresis steps between two host reads of the "anything changed?" flag
HYSTERESIS_CHECK_EVERY = 16


def _batched(x):
    return x if x.ndim == 3 else x[None]


def _conv3x3_replicate(img, kernel):
    """3x3 correlation with replicate border on (B, H, W) float32, summed in
    the JAX package's order (row-major taps)."""
    B, H, W = img.shape
    padded = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    out = torch.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            out = out + kernel[dy][dx] * padded[:, dy:dy + H, dx:dx + W]
    return out


def sobel(img):
    """(…, H, W) float32 -> (dx, dy) gradients, OpenCV 3x3 Sobel, replicate
    border."""
    x = _batched(img)
    dx, dy = _conv3x3_replicate(x, _SOBEL_X), _conv3x3_replicate(x, _SOBEL_Y)
    return dx.reshape(img.shape), dy.reshape(img.shape)


def _shift(img, dy, dx, fill=0):
    """Shift with constant fill over the last two dims;
    shifted[..., y, x] = img[..., y+dy, x+dx]."""
    H, W = img.shape[-2:]
    out = torch.full_like(img, fill)
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else (slice(0, W + dx), slice(-dx, W))
    out[..., yd, xd] = img[..., ys, xs]
    return out


def canny_nms(img, low=80.0, high=200.0, valid_mask=None):
    """Sobel + L1 magnitude + 4-sector non-max suppression.

    Returns (strong, weak) bool maps (weak includes strong). Split from the
    hysteresis stage so a frame's NMS can be shared across many bbox crops
    (the reference recomputes Canny per crop, box_proposal_detail.cpp:195-199;
    hysteresis is re-run per crop region). With `valid_mask`, gradients
    computed from any pixel outside it are zeroed (the mask eroded by 1)."""
    dx, dy = sobel(img)
    if valid_mask is not None:
        m = valid_mask
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                m = m & _shift(valid_mask, sy, sx, fill=False)
        dx = torch.where(m, dx, 0.0)
        dy = torch.where(m, dy, 0.0)
    mag = torch.abs(dx) + torch.abs(dy)

    adx = torch.abs(dx)
    ady = torch.abs(dy)
    # sector selection (OpenCV canny integer arithmetic equivalent)
    horiz = ady < _TG22 * adx  # gradient ~ horizontal -> compare x neighbors
    vert = ady > (adx / _TG22)  # gradient ~ vertical -> compare y neighbors
    diag_sign = torch.sign(dx) * torch.sign(dy)  # >0: 135 deg, <0: 45 deg

    m_l = _shift(mag, 0, -1)
    m_r = _shift(mag, 0, 1)
    m_u = _shift(mag, -1, 0)
    m_d = _shift(mag, 1, 0)
    m_ul = _shift(mag, -1, -1)
    m_dr = _shift(mag, 1, 1)
    m_ur = _shift(mag, -1, 1)
    m_dl = _shift(mag, 1, -1)

    keep_h = (mag > m_l) & (mag >= m_r)
    keep_v = (mag > m_u) & (mag >= m_d)
    keep_d135 = (mag > m_ul) & (mag >= m_dr)
    keep_d45 = (mag > m_ur) & (mag >= m_dl)
    keep_diag = torch.where(diag_sign > 0, keep_d135, keep_d45)
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_diag))

    strong = keep & (mag > high)
    weak = keep & (mag > low)
    return strong, weak


def _dilate8(x):
    """8-connected binary dilation (the pixel itself included) of (B, H, W)
    bool maps, zero outside the image."""
    return F.max_pool2d(x[:, None].to(torch.float32), 3, stride=1, padding=1)[:, 0] > 0.5


def canny_hysteresis(strong, weak, max_iters=512):
    """8-connected hysteresis: grow strong edges through weak pixels to a
    fixpoint, at most `max_iters` growth steps (as the JAX while_loop).

    The JAX loop tests `any(grown != edges)` after every step; here that test
    is a host read, so it runs once every HYSTERESIS_CHECK_EVERY steps. Steps
    past the fixpoint change nothing, so the result is identical. For a
    batch, steps run until every map is at its fixpoint (or the cap)."""
    edges = _batched(strong)
    weak_b = _batched(weak)
    it = 0
    while it < max_iters:
        n = min(HYSTERESIS_CHECK_EVERY, max_iters - it)
        for _ in range(n):
            prev = edges
            edges = (weak_b & _dilate8(prev)) | prev
        it += n
        if torch.equal(edges, prev):
            break
    return edges.reshape(strong.shape)


def canny(img, low=80.0, high=200.0, valid_mask=None, max_hysteresis_iters=512):
    """OpenCV-style Canny on (H, W) float32 grayscale -> (H, W) bool edge map:
    L1 gradient magnitude, 4-sector NMS, 8-connected hysteresis grown to a
    fixpoint."""
    strong, weak = canny_nms(img, low=low, high=high, valid_mask=valid_mask)
    return canny_hysteresis(strong, weak, max_iters=max_hysteresis_iters)


def extract_crop(img, y0, x0, crop_h, crop_w):
    """Fixed-size crop with clamping; returns (crop, valid_mask).

    (y0, x0) is clamped so the window stays inside the image; valid_mask is
    all-True then (clamping, not padding). For crops larger than the image
    the window starts at 0 and the mask marks the in-image region."""
    H, W = img.shape
    y0 = int(min(max(int(y0), 0), max(H - crop_h, 0)))
    x0 = int(min(max(int(x0), 0), max(W - crop_w, 0)))
    if crop_h <= H and crop_w <= W:
        crop = img[y0:y0 + crop_h, x0:x0 + crop_w]
        return crop, torch.ones((crop_h, crop_w), dtype=torch.bool, device=img.device)
    padded = torch.zeros((max(H, crop_h), max(W, crop_w)), dtype=img.dtype, device=img.device)
    padded[:H, :W] = img
    crop = padded[y0:y0 + crop_h, x0:x0 + crop_w]
    yy = torch.arange(crop_h, device=img.device)[:, None] + y0
    xx = torch.arange(crop_w, device=img.device)[None, :] + x0
    return crop, (yy < H) & (xx < W)


def gaussian_kernel1d(sigma, radius, device=None):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _separable(img, k, radius):
    """Correlate the rows, then the columns, of (B, H, W) with the 1D taps
    `k` (replicate border), each pass summed as sum_i k[i] * slice_i."""
    B, H, W = img.shape
    n = 2 * radius + 1
    p = F.pad(img[:, None], (0, 0, radius, radius), mode="replicate")[:, 0]
    acc = 0
    for i in range(n):
        acc = acc + k[i] * p[:, i:i + H, :]
    p = F.pad(acc[:, None], (radius, radius, 0, 0), mode="replicate")[:, 0]
    out = 0
    for i in range(n):
        out = out + k[i] * p[:, :, i:i + W]
    return out


def gaussian_blur(img, sigma, radius=None):
    """Separable Gaussian blur, replicate border, (H, W) or (..., H, W)."""
    if radius is None:
        radius = int(3.0 * float(sigma) + 0.5)
    k = gaussian_kernel1d(sigma, radius, device=img.device)
    flat = img.reshape((-1,) + img.shape[-2:])
    return _separable(flat, k, radius).reshape(img.shape)


def pyr_down(img):
    """OpenCV pyrDown-style: 5x5 Gaussian blur then 2x decimation."""
    k = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=torch.float32, device=img.device) / 16.0
    flat = img.reshape((-1,) + img.shape[-2:])
    out = _separable(flat, k, 2)[:, ::2, ::2]
    return out.reshape(img.shape[:-2] + out.shape[-2:])


@functools.lru_cache(maxsize=None)
def _linear_weights(n_in, n_out):
    """(n_in, n_out) float32 weights of jax.image.resize(method="linear",
    antialias=True) along one axis (jax/_src/image/scale.py
    compute_weight_mat): a triangle kernel widened by the downscale factor,
    normalised per output sample, zero where the sample lies outside."""
    f32 = np.float32
    scale = f32(n_out / n_in)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_linear(img, hw):
    """(H, W) float32 -> (h, w): the counterpart of jax.image.resize(img,
    (h, w), method="linear") that the ORB pyramid calls. The weights are
    JAX's antialiased triangle weights (not F.interpolate's, whose edge
    handling and normalisation follow PIL), applied as Wh^T @ img @ Ww."""
    H, W = img.shape
    h, w = int(hw[0]), int(hw[1])
    out = img
    if h != H:
        out = table(_linear_weights(H, h), img.device).T @ out
    if w != W:
        out = out @ table(_linear_weights(W, w), img.device)
    return out
