"""Exact Euclidean distance transform of edge maps — the plain PyTorch version.

PyTorch counterpart of cube_slam_tpu/ops/distance_transform.py (`edt_l2`,
which replaces cv::distanceTransform(255 - canny, CV_DIST_L2, 3),
detect_3d_cuboid/src/box_proposal_detail.cpp:199). The detector reaches it
through ops/hopper_kernels.edt_l2, which runs the CUDA kernel for CUDA
tensors; this module is the reference that kernel is held against, and the
path CPU tensors take.

Two passes, both exact in float32:

1. `vertical_dist`: per column, the distance to the nearest edge row, or
   1e9 when the column has none. Vectorised with cummax over the row index
   of the last edge seen (down the column, and up the flipped column) in
   place of the JAX package's two sequential scans; the values are the same.
2. the row pass D[i, x] = min_u g²[i, u] + (x - u)², evaluated as a
   broadcast min-plus over chunks of rows so the (rows, W, W) intermediate
   stays bounded.

Every candidate is a float32 sum of two exact integers (or of 1e18 and an
integer); `min` is exact, so any evaluation order — the Pallas kernel's, the
XLA loop's, this one's or the CUDA kernel's — gives the same bits.
"""

from __future__ import annotations

import torch

_INF = 1e9
# elements of one row-pass chunk: (rows, W, W) float32 stays under 64 MiB
_CHUNK_ELEMS = 1 << 24


def _last_edge_row(edges):
    """(B, H, W) bool -> (B, H, W) int64: index of the last edge row at or
    above each row of its column, -1 when there is none."""
    H = edges.shape[1]
    rows = torch.arange(H, device=edges.device)[None, :, None]
    return torch.cummax(torch.where(edges, rows, -1), dim=1).values


def vertical_dist(edges):
    """Exact per-column vertical distance to the nearest edge pixel.

    (B, H, W) bool -> (B, H, W) float32: d[b, i, x] = min_j |i - j| over
    edges[b, j, x], or 1e9 for a column without edges."""
    H = edges.shape[1]
    rows = torch.arange(H, device=edges.device)[None, :, None]
    above = _last_edge_row(edges)
    below = (H - 1) - _last_edge_row(edges.flip(1)).flip(1)  # first edge at or below
    down = torch.where(above >= 0, rows - above, -1)
    up = torch.where(below <= H - 1, below - rows, -1)
    d = torch.where(down < 0, up, torch.where(up < 0, down, torch.minimum(down, up)))
    return torch.where(d < 0, _INF, d.to(torch.float32))


def edt_l2(edges):
    """Exact L2 EDT: (B, H, W) or (H, W) bool edge mask -> float32 distances
    of the same shape (sqrt(1e9) where the map has no edge at all)."""
    e = edges if edges.ndim == 3 else edges[None]
    B, H, W = e.shape
    g = vertical_dist(e)
    g2 = (g * g).reshape(B * H, W)
    xx = torch.arange(W, dtype=torch.float32, device=e.device)
    sq = (xx[:, None] - xx[None, :]) ** 2  # (W_out, W_src)
    rows = max(1, _CHUNK_ELEMS // (W * W))
    out = torch.empty_like(g2)
    for r0 in range(0, B * H, rows):
        blk = g2[r0:r0 + rows]
        out[r0:r0 + rows] = torch.amin(blk[:, None, :] + sq[None, :, :], dim=-1)
    return torch.sqrt(torch.clamp(out, max=_INF)).reshape(edges.shape)


# OpenCV DIST_L2 / DIST_MASK_3 weights (opencv modules/imgproc/src/distransform.cpp)
_CHAMFER_A = 0.955
_CHAMFER_B = 1.3693


def chamfer_l2_3x3(edge_mask):
    """OpenCV's 3x3 chamfer DT (approximate L2) of an (H, W) bool mask: two
    raster scans, for parity experiments against the C++ outputs.

    Rows run forward, then backward (the JAX package's two lax.scan passes).
    Within a row the recurrence r[j] = min(v[j], r[j-1] + a) is the min-plus
    running reduction a*j + cummin(v - a*k), one torch.cummin per row."""
    H, W = edge_mask.shape
    dev = edge_mask.device
    start = torch.where(edge_mask, 0.0, _INF)
    ramp = _CHAMFER_A * torch.arange(W, dtype=torch.float32, device=dev)
    inf1 = torch.full((1,), _INF, device=dev)

    def lr_pass(v):
        return ramp + torch.cummin(v - ramp, dim=0).values

    def relax(prev, cur, in_row):
        # relax from the neighbouring row (vertical + diagonals), then in-row
        vert = prev + _CHAMFER_A
        left = torch.cat([inf1, prev[:-1] + _CHAMFER_B])
        right = torch.cat([prev[1:] + _CHAMFER_B, inf1])
        return in_row(torch.minimum(torch.minimum(cur, vert), torch.minimum(left, right)))

    fwd = torch.empty_like(start)
    prev = torch.full((W,), _INF, device=dev)
    for i in range(H):
        prev = fwd[i] = relax(prev, start[i], lr_pass)
    out = torch.empty_like(start)
    prev = torch.full((W,), _INF, device=dev)
    for i in range(H - 1, -1, -1):
        prev = out[i] = relax(prev, fwd[i], lambda v: lr_pass(v.flip(0)).flip(0))
    return torch.clamp(out, max=_INF)
