"""Pyramidal Lucas-Kanade optical flow + Harris corners.

PyTorch counterpart of cube_slam_tpu/ops/klt.py, the replacements for
cv::calcOpticalFlowPyrLK and cv::goodFeaturesToTrack as used for
dynamic-object point tracking (ORBmatcher::SearchByTracking[Harris],
ORBmatcher.cc:1524-1722; Harris corner spawning, Tracking.cc:2258-2338).
All keypoints iterate in lockstep: each LK iteration is one batched gather
+ 2x2 solve over the whole point set, levels walk coarse-to-fine. Plain
tensor ops on the inputs' device; nothing is read back to the host.

The bilinear patch sums its four terms in the JAX package's order; the
21x21 window sums are torch reductions, whose order differs from XLA's in
the last bits, so tracks agree with the JAX package to a fraction of a
pixel, not bit for bit.
"""

from __future__ import annotations

import torch

from . import image as im_ops
from .orb import top_k_stable

WIN = 10  # half window (21 x 21 like OpenCV default)


def _scharr(img):
    """OpenCV LK uses Scharr-like derivatives; Sobel is adequate here."""
    return im_ops.sobel(img)


def _gather_patch(img, cx, cy, half):
    """Bilinear patches (N, 2h+1, 2h+1) around float centres cx, cy (N,):
    floor, clip the corner to W-2 / H-2, fractions clipped to [0, 1]."""
    H, W = img.shape
    off = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    xs = cx[:, None, None] + off[None, None, :]
    ys = cy[:, None, None] + off[None, :, None]
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, H - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    flat = img.reshape(-1)
    i00 = y0 * W + x0
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + W]
    v11 = flat[i00 + W + 1]
    return v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy) + v10 * (1 - fx) * fy + v11 * fx * fy


def _lk_level(img0, img1, gx0, gy0, pts0, guess, iters=10):
    """One pyramid level of LK for all points: pts0 (N, 2) in this level's
    coords; guess (N, 2) current flow estimate. Returns refined flow."""
    px, py = pts0[:, 0], pts0[:, 1]
    patch0 = _gather_patch(img0, px, py, WIN)
    ix = _gather_patch(gx0, px, py, WIN)
    iy = _gather_patch(gy0, px, py, WIN)
    a11 = torch.sum(ix * ix, dim=(1, 2))
    a12 = torch.sum(ix * iy, dim=(1, 2))
    a22 = torch.sum(iy * iy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-6, 1e-6, det)
    g = guess
    for _ in range(iters):
        patch1 = _gather_patch(img1, px + g[:, 0], py + g[:, 1], WIN)
        it = patch1 - patch0
        b1 = torch.sum(it * ix, dim=(1, 2))
        b2 = torch.sum(it * iy, dim=(1, 2))
        dx = (a22 * b1 - a12 * b2) / det
        dy = (a11 * b2 - a12 * b1) / det
        g = g - torch.stack([dx, dy], dim=-1)
    return g


def pyr_lk(img0, img1, pts0, valid, n_levels=3, iters=10, max_err=25.0, init_flow=None):
    """Track pts0 (N, 2) from img0 to img1 (H, W) through an n_levels
    pyramid; tensors on one device.

    init_flow (N, 2) seeds the coarse level (the reference seeds KLT from
    predicted object motion, ORBmatcher::SearchByTracking) — essential when
    the true motion exceeds the pyramid capture range or the texture
    aliases. Returns (pts1 (N, 2), status (N,) bool)."""
    img0 = img0.to(torch.float32)
    img1 = img1.to(torch.float32)
    pts0 = pts0.to(torch.float32)
    pyr0 = [img0]
    pyr1 = [img1]
    for _ in range(n_levels - 1):
        pyr0.append(im_ops.pyr_down(pyr0[-1]))
        pyr1.append(im_ops.pyr_down(pyr1[-1]))

    if init_flow is None:
        flow = torch.zeros_like(pts0)
    else:
        flow = torch.as_tensor(init_flow, dtype=torch.float32, device=pts0.device) / (2.0 ** (n_levels - 1))
    for lvl in range(n_levels - 1, -1, -1):
        s = 2.0**lvl
        g0x, g0y = _scharr(pyr0[lvl])
        flow = _lk_level(pyr0[lvl], pyr1[lvl], g0x, g0y, pts0 / s, flow, iters=iters)
        if lvl > 0:
            flow = flow * 2.0

    pts1 = pts0 + flow * 1.0
    H, W = img0.shape
    patch0 = _gather_patch(img0, pts0[:, 0], pts0[:, 1], 3)
    patch1 = _gather_patch(img1, pts1[:, 0], pts1[:, 1], 3)
    err = torch.mean(torch.abs(patch1 - patch0), dim=(1, 2))
    x1, y1 = pts1[:, 0], pts1[:, 1]
    inb = (x1 >= WIN) & (x1 < W - WIN) & (y1 >= WIN) & (y1 < H - WIN)
    status = (err < max_err) & inb & valid.to(torch.bool)
    return pts1, status


def harris_corners(img, max_corners=256, k=0.04, quality=0.01, min_dist=8, mask=None):
    """goodFeaturesToTrack-style Harris corners: structure tensor + response
    + grid-based minimum-distance suppression + top-k. Every pixel that
    ties its cell's maximum is kept; top-k ties go to the lower index.
    Returns (xy (max_corners, 2) float32, valid (max_corners,) bool)."""
    img = img.to(torch.float32)
    gx, gy = _scharr(img)
    gxx = im_ops.gaussian_blur(gx * gx, sigma=1.5, radius=2)
    gyy = im_ops.gaussian_blur(gy * gy, sigma=1.5, radius=2)
    gxy = im_ops.gaussian_blur(gx * gy, sigma=1.5, radius=2)
    resp = gxx * gyy - gxy * gxy - k * (gxx + gyy) ** 2
    if mask is not None:
        resp = torch.where(mask.to(torch.bool), resp, -1e9)
    # threshold relative to max response
    resp = torch.where(resp > quality * torch.max(resp), resp, -1e9)
    # min-distance: strongest per (min_dist x min_dist) cell
    H, W = img.shape
    dev = img.device
    cell_r = torch.arange(H, device=dev)[:, None] // min_dist
    cell_c = torch.arange(W, device=dev)[None, :] // min_dist
    n_cc = (W + min_dist - 1) // min_dist
    cid = (cell_r * n_cc + cell_c).reshape(-1)
    n_cells = ((H + min_dist - 1) // min_dist) * n_cc
    flat = resp.reshape(-1)
    best = torch.full((n_cells,), -torch.inf, dtype=torch.float32, device=dev)
    best = best.scatter_reduce(0, cid, flat, reduce="amax", include_self=True)
    bc = best[cid]
    iswin = flat >= torch.where(bc > -1e9, bc, 1e9)
    score = torch.where(iswin, flat, -1e9)
    top_s, top_i = top_k_stable(score, max_corners)
    xy = torch.stack([(top_i % W).to(torch.float32), (top_i // W).to(torch.float32)], dim=-1)
    return xy, top_s > -1e8
