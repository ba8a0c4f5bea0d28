"""A plain PyTorch reference of the line detector the configuration states:
LSD's 2x2 gradients and level-line angles, support regions grown over
8-neighbours whose level-line angles agree within 22.5 degrees (32 sweeps of
min-label propagation with pointer jumping), a weighted PCA fit of each
region, LSD's density, length and aspect filters, and the 128 longest
segments [x1 y1 x2 y2] with x1 <= x2.

It imports nothing of the port. It runs in any floating dtype: float64 is
the reference, and bfloat16 is the control (the precision a faster
detector would be tempted to drop to).
"""

from __future__ import annotations

import math

import torch

MAG_THRESHOLD = 5.22      # LSD's rho for q = 2 and the 22.5 degree tolerance
ANGLE_TOL_DEG = 22.5
MIN_PIXELS = 20
MIN_DENSITY = 0.5
MAX_WIDTH_RATIO = 0.25
PROPAGATION_SWEEPS = 32


def _shift(x, dy, dx, fill):
    """out[y, x] = x[y + dy, x + dx], `fill` outside the image."""
    H, W = x.shape
    p = torch.full((H + 2, W + 2), fill, dtype=x.dtype, device=x.device)
    p[1:H + 1, 1:W + 1] = x
    return p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def gradients(img):
    """LSD's 2x2 gradients on the cell right and below each pixel (the last
    row and column repeated): (gx, gy, magnitude, level-line angle)."""
    H, W = img.shape
    ip = torch.cat([img, img[:, -1:]], dim=1)
    ip = torch.cat([ip, ip[-1:]], dim=0)
    a, b, c, d = ip[:H, :W], ip[:H, 1:], ip[1:, :W], ip[1:, 1:]
    gx = (b + d - a - c) * 0.5
    gy = (c + d - a - b) * 0.5
    return gx, gy, torch.sqrt(gx * gx + gy * gy), torch.atan2(gx, -gy)


def _close(a1, a2):
    d = torch.abs(a1 - a2)
    d = torch.minimum(d, 2 * math.pi - d)
    return d < math.radians(ANGLE_TOL_DEG)


def regions(active, angle):
    """Per pixel the smallest flat index reachable through angle-compatible
    active 8-neighbours within the sweeps; H*W + 1 off the support."""
    H, W = active.shape
    big = H * W + 1
    idx = torch.arange(H * W, device=active.device).reshape(H, W)
    lab = torch.where(active, idx, torch.full_like(idx, big))
    nbrs = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                ok = _shift(active, dy, dx, False) & _close(angle, _shift(angle, dy, dx, 1e9))
                nbrs.append((dy, dx, ok))
    for _ in range(PROPAGATION_SWEEPS):
        best = lab
        for dy, dx, ok in nbrs:
            nl = _shift(lab, dy, dx, big)
            best = torch.where(ok & (nl < best), nl, best)
        flat = best.reshape(-1)
        rep = flat[torch.clamp(flat, 0, H * W - 1)].reshape(H, W)
        best = torch.minimum(best, torch.where(best < big, rep, torch.full_like(rep, big)))
        lab = torch.where(active, best, torch.full_like(best, big))
    return lab


def detect_lines(img, min_length=15.0, max_lines=128, dtype=torch.float64):
    """(H, W) grey image -> (n, 4) segments [x1 y1 x2 y2], longest first,
    computed in `dtype`."""
    img = torch.as_tensor(img).to(dtype)
    H, W = img.shape
    N = H * W
    _, _, mag, angle = gradients(img)
    active = mag > MAG_THRESHOLD
    lab = regions(active, angle)
    act = active.reshape(-1)
    seg = torch.where(act, lab.reshape(-1), torch.full_like(lab.reshape(-1), N))
    ar = torch.arange(N, device=img.device)
    xs = (ar % W).to(dtype)
    ys = (ar // W).to(dtype)
    w = torch.where(act, mag.reshape(-1), torch.zeros((), dtype=dtype, device=img.device))

    def ssum(v):
        return torch.zeros(N + 1, dtype=dtype, device=img.device).index_add_(0, seg, v)

    s_w, s_x, s_y = ssum(w), ssum(w * xs), ssum(w * ys)
    s_xx, s_yy, s_xy = ssum(w * xs * xs), ssum(w * ys * ys), ssum(w * xs * ys)
    s_n = ssum(act.to(dtype))
    s_w = torch.where(s_w > 0, s_w, torch.ones_like(s_w))
    cx, cy = s_x / s_w, s_y / s_w
    vxx = s_xx / s_w - cx * cx
    vyy = s_yy / s_w - cy * cy
    vxy = s_xy / s_w - cx * cy
    tr = vxx + vyy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - (vxx * vyy - vxy * vxy), min=0))
    lam1, lam2 = tr / 2 + disc, tr / 2 - disc
    one, zero = torch.ones_like(vxx), torch.zeros_like(vxx)
    axis_x = vxx >= vyy
    ex = torch.where(torch.abs(vxy) > 1e-9, lam1 - vyy, torch.where(axis_x, one, zero))
    ey = torch.where(torch.abs(vxy) > 1e-9, vxy, torch.where(axis_x, zero, one))
    en = torch.sqrt(ex * ex + ey * ey)
    en = torch.where(en > 1e-9, en, one)
    ex, ey = ex / en, ey / en
    proj = (xs - cx[seg]) * ex[seg] + (ys - cy[seg]) * ey[seg]
    lo = torch.full((N + 1,), 1e9, dtype=dtype, device=img.device).scatter_reduce_(
        0, seg, torch.where(act, proj, torch.full_like(proj, 1e9)), "amin", include_self=False)
    hi = torch.full((N + 1,), -1e9, dtype=dtype, device=img.device).scatter_reduce_(
        0, seg, torch.where(act, proj, torch.full_like(proj, -1e9)), "amax", include_self=False)
    length = hi - lo
    width = torch.sqrt(torch.clamp(lam2, min=0)) * 3.46  # full width, 2 sqrt(3) std
    density = s_n / torch.clamp(length * torch.clamp(width, min=1.0), min=1.0)
    good = ((s_n >= MIN_PIXELS) & (length >= min_length)
            & (width <= torch.clamp(MAX_WIDTH_RATIO * length, min=3.0)) & (density >= MIN_DENSITY))
    good[N:] = False
    x1, y1 = cx + lo * ex, cy + lo * ey
    x2, y2 = cx + hi * ex, cy + hi * ey
    flip = x2 < x1
    seg4 = torch.stack([torch.where(flip, x2, x1), torch.where(flip, y2, y1),
                        torch.where(flip, x1, x2), torch.where(flip, y1, y2)], dim=-1)
    ids = torch.nonzero(good).reshape(-1)
    order = torch.argsort(length[ids].to(torch.float64), descending=True, stable=True)[:max_lines]
    return seg4[ids[order]].to(torch.float64).cpu().numpy()
