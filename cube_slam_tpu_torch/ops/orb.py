"""ORB feature extraction — batched tensor ops.

PyTorch counterpart of cube_slam_tpu/ops/orb.py, the re-design of
ORBextractor (orb_object_slam/src/ORBextractor.cc:1036 operator(), :766
ComputeKeyPointsOctTree, :540 DistributeOctTree, :74 IC_Angle, :1027
computeDescriptors):

* 8-level pyramid (scale 1.2), each level a light Gaussian pre-blur + a
  linear resize of the previous one (ops/image.resize_linear, JAX's weights),
* FAST-9 segment test evaluated densely for the whole level at two
  thresholds, corner score = max-min arc contrast,
* best-corner-per-grid-cell + global top-k in place of the quadtree,
* orientation by intensity centroid over the radius-15 circular patch,
* rotated-BRIEF 256-bit descriptors over the Gaussian-blurred level, with
  the same seeded sampling pattern as the JAX package.

Descriptors are (N, 8) int32 tensors that share the bits of the JAX
package's uint32 words (numpy `.view(np.uint32)` gives them back): torch's
uint32 lacks shifts and most CUDA ops. Top-k is a stable descending sort, so
ties go to the lower index as with `lax.top_k`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import table
from . import image as im_ops

# FAST circle of 16 offsets (radius 3), OpenCV order, as (x, y)
_FAST_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)
# stored as (dy, dx) for row-major shifts
_FAST_DYDX = np.array([(-p[1], p[0]) for p in _FAST_OFFSETS], dtype=np.int32)


def _edge_padded(img, r):
    return F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]


def fast_corner_score(img):
    """Dense FAST-9 arc-contrast score for every pixel of (H, W) float32.

    score(p) = max over the 16 contiguous 9-arcs of the minimum signed
    center difference (brighter arcs) or its negation (darker arcs);
    `score > t` is exactly the FAST-9 corner test at threshold t. The
    windowed min over each 9-arc is built by doubling (2 -> 4 -> 8 -> 9)."""
    H, W = img.shape
    p = _edge_padded(img, 3)
    ring = torch.stack([p[3 + int(dy):3 + int(dy) + H, 3 + int(dx):3 + int(dx) + W]
                        for dy, dx in _FAST_DYDX])  # (16, H, W)
    diff = ring - img[None]

    def w9(x):
        m2 = torch.minimum(x, torch.roll(x, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        return torch.minimum(m8, torch.roll(x, -8, dims=0))

    score_b = torch.amax(w9(diff), dim=0)
    score_d = torch.amax(w9(-diff), dim=0)
    return torch.maximum(score_b, score_d)


def fast_score(img, threshold):
    """(is_corner bool (H, W), score (H, W)); score is 0 where the corner
    test fails at `threshold`."""
    s = fast_corner_score(img)
    hit = s > threshold
    return hit, torch.where(hit, s, 0.0)


def _nms3x3(score):
    H, W = score.shape
    p = _edge_padded(score, 1)
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.maximum(m, p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return score >= m


def top_k_stable(x, k):
    """(values, indices) of the k largest entries along the last dim; ties
    go to the lower index (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_level(img, max_kp, ini_threshold=20.0, min_threshold=7.0,
                 cell_size=30, border=16):
    """FAST keypoints for one pyramid level with spatial distribution.

    Dual-threshold: prefer ini_threshold corners; cells without any fall
    back to min_threshold (ComputeKeyPointsOctTree's per-cell retry,
    ORBextractor.cc:790-830). Then best-per-cell + top-k stands in for
    DistributeOctTree. Returns (xy (max_kp, 2) float32, score, valid)."""
    H, W = img.shape
    dev = img.device
    raw = fast_corner_score(img)

    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)

    nms = _nms3x3(raw) & inb
    hi = nms & (raw > ini_threshold)
    lo = nms & (raw > min_threshold)

    n_cr = (H + cell_size - 1) // cell_size
    n_cc = (W + cell_size - 1) // cell_size
    Hp, Wp = n_cr * cell_size, n_cc * cell_size

    def cells(a, fill):
        p = F.pad(a, (0, Wp - W, 0, Hp - H), value=fill)
        return p.reshape(n_cr, cell_size, n_cc, cell_size)

    hi_any = cells(hi, False).any(dim=3).any(dim=1)  # (n_cr, n_cc)
    use_hi = hi_any[:, None, :, None].expand(n_cr, cell_size, n_cc, cell_size)
    use_hi = use_hi.reshape(Hp, Wp)[:H, :W]
    corner = torch.where(use_hi, hi, lo)
    flat_score = torch.where(corner, raw, -1.0).reshape(-1)

    # best corner per cell (first index on ties, as jnp.argmax)
    score_c = torch.where(cells(corner, False), cells(raw, 0.0), -1.0)
    sc_rows = score_c.permute(0, 2, 1, 3).reshape(n_cr * n_cc, cell_size * cell_size)
    win = torch.argmax(sc_rows, dim=1)
    win_val = torch.gather(sc_rows, 1, win[:, None])[:, 0]
    ci = torch.arange(n_cr * n_cc, device=dev)
    wy = (ci // n_cc) * cell_size + win // cell_size
    wx = (ci % n_cc) * cell_size + win % cell_size
    win_ok = (win_val > 0) & (wy < H) & (wx < W)
    keep1 = torch.zeros((H * W + 1,), dtype=torch.bool, device=dev)
    keep1[torch.where(win_ok, wy * W + wx, H * W)] = True
    keep1 = keep1[:H * W]

    # remaining capacity filled by global top-k of the rest
    primary = torch.where(keep1, flat_score + 1e6, flat_score)  # cell winners first
    top_s, top_i = top_k_stable(primary, max_kp)
    valid = top_s > 0
    ky = (top_i // W).to(torch.float32)
    kx = (top_i % W).to(torch.float32)
    kscore = torch.where(top_s > 1e5, top_s - 1e6, top_s)
    return torch.stack([kx, ky], dim=-1), kscore, valid


# ---------------------------------------------------------------------------
# orientation + descriptors
# ---------------------------------------------------------------------------

_PATCH_R = 15  # HALF_PATCH_SIZE (ORBextractor.cc:57)
# per-row max column offset of the circular patch (u_max table, :1052-1065)
_UMAX = np.array([int(math.floor(math.sqrt(_PATCH_R**2 - v**2) + 0.5)) for v in range(_PATCH_R + 1)])

_PATCH_MASK = np.zeros((2 * _PATCH_R + 1, 2 * _PATCH_R + 1), dtype=np.float32)
for _v in range(-_PATCH_R, _PATCH_R + 1):
    _u = _UMAX[abs(_v)]
    _PATCH_MASK[_v + _PATCH_R, _PATCH_R - _u: _PATCH_R + _u + 1] = 1.0

_VGRID = np.arange(-_PATCH_R, _PATCH_R + 1, dtype=np.float32)


def ic_angle(img, xy, valid):
    """Intensity-centroid orientation (IC_Angle, ORBextractor.cc:74-113).

    img: (H, W); xy: (N, 2) float pixel coords; returns angle (N,) radians.
    The patch origin is clamped into the image, as lax.dynamic_slice does."""
    H, W = img.shape
    P = 2 * _PATCH_R + 1
    dev = img.device
    ar = torch.arange(P, device=dev)
    y0 = torch.clamp(xy[:, 1].to(torch.int64) - _PATCH_R, 0, H - P)
    x0 = torch.clamp(xy[:, 0].to(torch.int64) - _PATCH_R, 0, W - P)
    rows = y0[:, None, None] + ar[None, :, None]
    cols = x0[:, None, None] + ar[None, None, :]
    patch = img[rows, cols] * table(_PATCH_MASK, dev)
    vg = table(_VGRID, dev)
    m10 = torch.sum(patch * vg[None, None, :], dim=(1, 2))
    m01 = torch.sum(patch * vg[None, :, None], dim=(1, 2))
    return torch.where(valid, torch.atan2(m01, m10), 0.0)


def _make_brief_pattern(seed=42, n_pairs=256, sigma=_PATCH_R / 2.0, bound=_PATCH_R - 2):
    """Deterministic Gaussian BRIEF pattern (stand-in for the learned OpenCV
    table); the same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    pts = np.clip(rng.normal(0.0, sigma, size=(n_pairs, 2, 2)), -bound, bound)
    return pts.astype(np.float32)  # (256, 2 [a,b], 2 [x,y])


_BRIEF_PATTERN = _make_brief_pattern()


def words_to_int32(w):
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def brief_descriptors(img_blurred, xy, angle, valid):
    """Rotated-BRIEF (computeOrbDescriptor): rotate the 256 sampling pairs
    by the keypoint angle, compare intensities on the blurred level, pack
    to (N, 8) int32 words (bit b of word w is pair 32 w + b)."""
    H, W = img_blurred.shape
    dev = img_blurred.device
    pat = table(_BRIEF_PATTERN, dev)  # (256, 2, 2)
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    # pattern @ rot.T with rot = [[c, -s], [s, c]]
    rx = pat[None, :, :, 0] * c + pat[None, :, :, 1] * (-s)
    ry = pat[None, :, :, 0] * s + pat[None, :, :, 1] * c
    px = torch.clamp(torch.round(xy[:, 0, None, None] + rx).to(torch.int64), 0, W - 1)
    py = torch.clamp(torch.round(xy[:, 1, None, None] + ry).to(torch.int64), 0, H - 1)
    v = img_blurred[py, px]  # (N, 256, 2)
    bits = (v[..., 0] < v[..., 1]).to(torch.int64).reshape(-1, 8, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = torch.sum(bits << shifts, dim=-1)
    return torch.where(valid[:, None], words_to_int32(words), 0)


class OrbPyramidConfig:
    """Mirror of the ORB settings block (Examples/Monocular/*.yaml:
    nFeatures, scaleFactor 1.2, nLevels 8, iniThFAST 20, minThFAST 7)."""

    def __init__(self, n_features=1000, scale_factor=1.2, n_levels=8,
                 ini_th=20.0, min_th=7.0):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th
        self.min_th = min_th
        # per-level feature quota (ORBextractor.cc ctor: geometric split)
        factor = 1.0 / scale_factor
        n_desired = n_features * (1 - factor) / (1 - factor**n_levels)
        self.per_level = []
        acc = 0
        for i in range(n_levels - 1):
            k = int(round(n_desired))
            self.per_level.append(k)
            acc += k
            n_desired *= factor
        self.per_level.append(max(n_features - acc, 0))
        self.scales = [scale_factor**i for i in range(n_levels)]


def pack_features(xy, level, angle, valid, desc):
    """Pack the feature fields into ONE (N, 13) float32 tensor so the host
    needs a single download: xy/level/angle/valid, then the descriptor
    words' raw bits as 8 float columns."""
    return torch.cat([xy, level[:, None].to(torch.float32), angle[:, None],
                      valid[:, None].to(torch.float32), desc.contiguous().view(torch.float32)], dim=1)


def extract_orb(gray, cfg: OrbPyramidConfig):
    """Full ORB extraction. gray: (H, W) tensor. Returns a dict of padded
    tensors: xy (N, 2) level-0 coords, level (N,), angle (N,), score (N,),
    desc (N, 8) int32, valid (N,); N = sum of the per-level quotas. Each
    level is a light Gaussian pre-blur + 1.2x linear resize of the previous
    level, the reference's ComputePyramid scheme (ORBextractor.cc:1106-1130)."""
    gray = gray.to(torch.float32)
    H0, W0 = gray.shape
    out_xy, out_lvl, out_ang, out_sc, out_desc, out_valid = [], [], [], [], [], []
    level_img = gray
    for lvl in range(cfg.n_levels):
        h = int(round(H0 / cfg.scales[lvl]))
        w = int(round(W0 / cfg.scales[lvl]))
        quota = cfg.per_level[lvl]
        if lvl > 0:
            src = im_ops.gaussian_blur(level_img, sigma=0.8, radius=2)
            level_img = im_ops.resize_linear(src, (h, w))
        xy, score, valid = detect_level(level_img, max_kp=quota, ini_threshold=cfg.ini_th,
                                        min_threshold=cfg.min_th)
        ang = ic_angle(level_img, xy, valid)
        blurred = im_ops.gaussian_blur(level_img, sigma=2.0, radius=3)
        desc = brief_descriptors(blurred, xy, ang, valid)
        out_xy.append(xy * cfg.scales[lvl])
        out_lvl.append(torch.full((quota,), lvl, dtype=torch.int32, device=gray.device))
        out_ang.append(ang)
        out_sc.append(score)
        out_desc.append(desc)
        out_valid.append(valid)
    return {
        "xy": torch.cat(out_xy),
        "level": torch.cat(out_lvl),
        "angle": torch.cat(out_ang),
        "score": torch.cat(out_sc),
        "desc": torch.cat(out_desc),
        "valid": torch.cat(out_valid),
    }


def extract_orb_fused(gray, cfg: OrbPyramidConfig):
    """Whole-pyramid ORB extraction; returns the extract_orb dict plus
    "packed" (the (N, 13) bundle for a single host download)."""
    out = extract_orb(gray, cfg)
    out["packed"] = pack_features(out["xy"], out["level"], out["angle"], out["valid"], out["desc"])
    return out
