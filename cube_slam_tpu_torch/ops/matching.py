"""Descriptor matching — Hamming distances as dense batched ops.

PyTorch counterpart of cube_slam_tpu/ops/matching.py, the replacement for
ORBmatcher's per-feature loops (orb_object_slam/src/ORBmatcher.cc:
DescriptorDistance popcount :1905, SearchByProjection :50/:1373,
SearchForInitialization :429, rotation-histogram consistency :50-160): whole
(N, M) distance matrices, masked by search windows, then mutual-best / ratio
/ rotation-histogram filters as array reductions.

Descriptors are (N, 8) int32 tensors sharing the bits of the uint32 words.
Every function also takes a leading batch dimension on its per-set inputs
where the JAX package vmaps it (the tracker's multi-keyframe searches).
"""

from __future__ import annotations

import torch

from .orb import top_k_stable

TH_LOW = 50      # ORBmatcher.cc:46 TH_LOW
TH_HIGH = 100    # ORBmatcher.cc:45 TH_HIGH
HISTO_LENGTH = 30  # rotation histogram bins (ORBmatcher.cc:47)
BIG = 10_000


def _popcount16(v):
    """Bit count of int32 values in [0, 2^16)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount32(x):
    """Bit count of each int32 word, read as 32 unsigned bits. The word is
    split into 16-bit halves first: masking after the arithmetic shift drops
    the smeared sign bits, and the halves cannot overflow."""
    return _popcount16(x & 0xFFFF) + _popcount16((x >> 16) & 0xFFFF)


def hamming_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """(..., N, 8) x (..., M, 8) int32 words -> (..., N, M) int32 Hamming
    distances; invalid rows/cols get BIG. Accumulated one word at a time,
    so the (N, M, 8) XOR tensor never exists."""
    d = None
    for w in range(desc_a.shape[-1]):
        x = torch.bitwise_xor(desc_a[..., :, None, w], desc_b[..., None, :, w])
        c = popcount32(x)
        d = c if d is None else d + c
    if valid_a is not None:
        d = torch.where(valid_a[..., :, None], d, BIG)
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, BIG)
    return d


def match_mutual_ratio(dist, max_dist=TH_LOW, ratio=0.9, mutual=True):
    """Best match per row with Lowe ratio vs second best + optional mutual
    check (SearchForInitialization semantics, ORBmatcher.cc:429-540).

    dist: (..., N, M). Returns (match_idx (..., N) int32 — M index or -1,
    match_dist). argmin keeps the first index on ties, as jnp.argmin."""
    N = dist.shape[-2]
    best = torch.amin(dist, dim=-1)
    best_idx = torch.argmin(dist, dim=-1)
    masked = dist.scatter(-1, best_idx[..., None], BIG)
    second = torch.amin(masked, dim=-1)
    ok = (best <= max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        best_col = torch.argmin(dist, dim=-2)  # (..., M)
        ar = torch.arange(N, device=dist.device)
        ok = ok & (torch.gather(best_col, -1, best_idx) == ar)
    return torch.where(ok, best_idx, -1).to(torch.int32), best


def rotation_consistency(angles_a, angles_b, match_idx, n_keep=3):
    """Keep matches whose angle difference falls in the top-n_keep histogram
    bins (ComputeThreeMaxima, ORBmatcher.cc:1870-1903). Batched over
    leading dims of match_idx / angles_b."""
    matched = match_idx >= 0
    sel = torch.clamp(match_idx, min=0).to(torch.int64)
    rot = angles_a - torch.gather(angles_b, -1, sel)
    deg = torch.rad2deg(rot)
    deg = torch.where(deg < 0, deg + 360.0, deg)
    bins = torch.clamp((deg * HISTO_LENGTH / 360.0).to(torch.int32), 0, HISTO_LENGTH - 1)
    counts = torch.zeros(matched.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int32,
                         device=match_idx.device)
    counts = counts.scatter_add(-1, bins.to(torch.int64), matched.to(torch.int32))
    top_vals, top_bins = top_k_stable(counts, n_keep)
    top_vals = top_vals.to(torch.float32)
    keep_bin2 = top_vals[..., 1:2] > 0.1 * top_vals[..., 0:1]
    keep_bin3 = top_vals[..., 2:3] > 0.1 * top_vals[..., 0:1]
    in_top = (bins == top_bins[..., 0:1]) \
        | ((bins == top_bins[..., 1:2]) & keep_bin2) \
        | ((bins == top_bins[..., 2:3]) & keep_bin3)
    return torch.where(matched & in_top, match_idx, -1)


def window_mask(xy_a, xy_b, radius, level_a=None, level_b=None, level_slack=1):
    """(..., N, M) bool: candidate b within a square search window of a's
    position (SearchByProjection windowing), optionally same-ish level.
    radius: a number or (..., N) per-row radii."""
    dx = torch.abs(xy_a[..., :, None, 0] - xy_b[..., None, :, 0])
    dy = torch.abs(xy_a[..., :, None, 1] - xy_b[..., None, :, 1])
    r = radius[..., None] if torch.is_tensor(radius) and radius.ndim > 0 else radius
    m = (dx < r) & (dy < r)
    if level_a is not None and level_b is not None:
        dl = torch.abs(level_a[..., :, None] - level_b[..., None, :])
        m = m & (dl <= level_slack)
    return m


def search_by_projection(proj_xy, proj_valid, desc_map, level_map,
                         kp_xy, kp_desc, kp_level, kp_valid,
                         radius=15.0, max_dist=TH_HIGH, ratio=0.9):
    """Project map points and match to frame keypoints inside a window
    (SearchByProjection, ORBmatcher.cc:1373-1521 last-frame variant).
    proj_xy: (P, 2) projected map points; returns (match (P,) kp index or
    -1, dist)."""
    d = hamming_matrix(desc_map, kp_desc, proj_valid, kp_valid)
    wm = window_mask(proj_xy, kp_xy, radius, level_map, kp_level)
    d = torch.where(wm, d, BIG)
    return match_mutual_ratio(d, max_dist=max_dist, ratio=ratio, mutual=False)
