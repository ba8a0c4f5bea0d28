"""Single-image 3D cuboid detection — the batched proposal lattice.

PyTorch counterpart of cube_slam_tpu/models/detector.py, the re-design of the
reference detector (detect_3d_cuboid/src/box_proposal_detail.cpp:56-557
`detect_cuboid` and object_3d_util.cpp). The reference walks a deep loop nest

    bbox -> height-sample -> (cam_roll x cam_pitch x obj_yaw) -> top-pt -> config

with early-`continue`s. Here the lattice is tensors whose dims are written
out where the JAX package used nested vmaps:

    (BH, NRP, NY, NT, 2)   BH = bbox x height samples, NRP = roll/pitch
                           samples, NY = yaw samples, NT = top-edge points,
                           2 = the two corner configurations

* Canny NMS once per frame, then hysteresis + the exact L2 distance
  transform per (bbox, height) region (ops/image.py; the EDT is the CUDA
  kernel of csrc/edt.cu on a CUDA device, ops/hopper_kernels.py),
* vanishing-point support angles per (roll, pitch, yaw) as masked
  reductions over the padded line set,
* the 8-corner ray chain (seg_hit_boundary / lineSegmentIntersect,
  object_3d_util.cpp:194-252) for every lattice point at once, with
  validity masks replacing `continue`; `config_id` stays a static Python
  int, so the two configurations are two code paths,
* distance scoring as one gather from each region's distance map
  (box_edge_sum_dists, object_3d_util.cpp:427-453) and angle scoring from
  the VP-support table (:455-492),
* the 2/3-keep score fusion (fuse_normalize_scores_v2, :495-565) as masked
  rank arithmetic with stable sorts,
* 2D->3D lifting (change_2d_corner_to_3d_object, :610-648),

then the best `top_k` of the skew-penalized score per bbox
(box_proposal_detail.cpp:517-536). Host code prepares padded inputs in
numpy (the line merge is exact-greedy and order-dependent -> ops/lines.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve, table
from ..ops import hopper_kernels
from ..ops import image as im_ops
from ..ops import lines as line_ops
from ..utils import geometry as geo
from ..utils import io as io_utils
from ..utils import np_geometry as np_geo
from ..utils import profiler

BIG = 1e8

# ---------------------------------------------------------------------------
# static tables (box_proposal_detail.cpp:429-446), 0-indexed corner ids
# ---------------------------------------------------------------------------

# config 1: 9 visible edges
_VISIBLE_EDGES_C1 = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0], [1, 5], [2, 4], [3, 7], [4, 7], [4, 5]], dtype=np.int32
)
# config 2: 7 visible edges
_VISIBLE_EDGES_C2 = np.array(
    [[0, 1], [1, 2], [2, 3], [3, 0], [1, 5], [2, 4], [4, 5]], dtype=np.int32
)
# per-VP pairs of box edges for angle alignment (3 VPs x [e1_1 e1_2 e2_1 e2_2])
_VP_BOX_EDGES_C1 = np.array([[0, 1, 7, 4], [3, 0, 4, 5], [3, 7, 1, 5]], dtype=np.int32)
_VP_BOX_EDGES_C2 = np.array([[0, 1, 2, 3], [3, 0, 4, 5], [2, 4, 1, 5]], dtype=np.int32)
# config-2 distance reweighting (object_3d_util.cpp:442-448)
_EDGE_WEIGHT_C2 = np.array([1.0, 1.0, 1.0, 1.0, 1.5, 1.5, 2.0], dtype=np.float32)
_EDGE_WEIGHT_C1 = np.ones(9, dtype=np.float32)

# corner remap for the final cuboid struct (object_3d_util.cpp:637-640), 0-idx
_CUBOID_REMAP_VP_LEFT = np.array([5, 4, 7, 6, 1, 2, 3, 0], dtype=np.int32)
_CUBOID_REMAP_VP_RIGHT = np.array([4, 5, 6, 7, 2, 1, 0, 3], dtype=np.int32)

_EDGE_TABLES = {
    1: (_VISIBLE_EDGES_C1, _EDGE_WEIGHT_C1, _VP_BOX_EDGES_C1),
    2: (_VISIBLE_EDGES_C2, _EDGE_WEIGHT_C2, _VP_BOX_EDGES_C2),
}

# proposal-generation constants (box_proposal_detail.cpp:79-88)
VP12_EDGE_ANGLE_THRE = 15.0
VP3_EDGE_ANGLE_THRE = 10.0
SHORTED_EDGE_THRE = 20.0
WEIGHT_VP_ANGLE = 0.8
WEIGHT_SKEW_ERROR = 1.5

# VP support thresholds in radians, rounded as jnp.deg2rad rounds them
_VP_THRES = (np.array([VP12_EDGE_ANGLE_THRE, VP12_EDGE_ANGLE_THRE, VP3_EDGE_ANGLE_THRE],
                      dtype=np.float32) * np.float32(np.pi / 180)).astype(np.float32)


def linespace_cpp(start, end, step):
    """Literal port of the accumulating linespace (matrix_utils.cpp:350-364)
    so sample counts/values match the C++ double accumulation exactly."""
    res = []
    x = float(start)
    while x <= end:
        res.append(x)
        x += step
        if len(res) > 1000:
            break
    return np.asarray(res, dtype=np.float64)


# ---------------------------------------------------------------------------
# geometric primitives of the corner chain; points are (..., 2) tensors and
# bounds broadcast against their leading dims
# ---------------------------------------------------------------------------

def _nonzero(v):
    return torch.where(torch.abs(v) < 1e-12, torch.where(v < 0, -1e-12, 1e-12), v)


def _hit_vertical(vp, pt, x_bound, y0, y1):
    """Ray vp->pt extended to the vertical segment x=x_bound, y in [y0, y1]
    (seg_hit_boundary, object_3d_util.cpp:216-228). Returns (hit (..., 2), ok)."""
    d = pt - vp
    lam = (x_bound - vp[..., 0]) / _nonzero(d[..., 0])
    hit_y = vp[..., 1] + lam * d[..., 1]
    ok = (lam >= 0) & (y0 <= hit_y) & (hit_y <= y1)
    return torch.stack(torch.broadcast_tensors(x_bound, hit_y), dim=-1), ok


def _hit_horizontal(vp, pt, y_bound, x0, x1):
    """Ray vp->pt to the horizontal segment y=y_bound, x in [x0, x1]
    (seg_hit_boundary, object_3d_util.cpp:203-215)."""
    d = pt - vp
    lam = (y_bound - vp[..., 1]) / _nonzero(d[..., 1])
    hit_x = vp[..., 0] + lam * d[..., 0]
    ok = (lam >= 0) & (x0 <= hit_x) & (hit_x <= x1)
    return torch.stack(torch.broadcast_tensors(hit_x, y_bound), dim=-1), ok


def _line_intersect(p1, p2, p3, p4):
    """Infinite-line intersection of (p1,p2) and (p3,p4)
    (lineSegmentIntersect, object_3d_util.cpp:233-252, infinite_line=true).
    Parallel lines yield non-finite values; callers' inside-box checks
    reject them."""
    x21 = p2[..., 0] - p1[..., 0]
    y21 = p2[..., 1] - p1[..., 1]
    x43 = p4[..., 0] - p3[..., 0]
    y43 = p4[..., 1] - p3[..., 1]
    x13 = p1[..., 0] - p3[..., 0]
    y13 = p1[..., 1] - p3[..., 1]
    denom = y43 * x21 - x43 * y21
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    ua = (x43 * y13 - y43 * x13) / denom
    return torch.stack([p1[..., 0] + x21 * ua, p1[..., 1] + y21 * ua], dim=-1)


def _inside(pt, lt, rb):
    return ((lt[..., 0] <= pt[..., 0]) & (pt[..., 0] <= rb[..., 0])
            & (lt[..., 1] <= pt[..., 1]) & (pt[..., 1] <= rb[..., 1]))


def _norm_ok(a, b):
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) >= SHORTED_EDGE_THRE


def corner_chain(vp1, vp2, vp3, corner1, config_id: int, bx):
    """Build the 8-corner 2D chain for a lattice of proposals; returns
    (corners (..., 8, 2), valid (...), vp1_position (...)). config_id is a
    static Python int (1 or 2).

    bx: dict of bbox bounds broadcastable against the lattice (left_x, top_y,
    right_x, down_y_expan, expan_lt (..., 2), expan_rb (..., 2)). Mirrors
    box_proposal_detail.cpp:254-418."""
    left_x, top_y = bx["left_x"], bx["top_y"]
    right_x, down_y = bx["right_x"], bx["down_y_expan"]
    expan_lt, expan_rb = bx["expan_lt"], bx["expan_rb"]
    box_lt = torch.stack([left_x, top_y], dim=-1)
    box_rb = torch.stack([right_x, down_y], dim=-1)

    c2_r, ok_r = _hit_vertical(vp1, corner1, right_x, top_y, down_y)
    c2_l, ok_l = _hit_vertical(vp1, corner1, left_x, top_y, down_y)
    vp1_pos = torch.where(ok_r, 1, torch.where(ok_l, 2, 0))
    c2 = torch.where(ok_r[..., None], c2_r, c2_l)
    valid = (vp1_pos > 0) & _norm_ok(corner1, c2)

    x_opp = torch.where(vp1_pos == 1, left_x, right_x)
    if config_id == 1:
        c4, ok4 = _hit_vertical(vp2, corner1, x_opp, top_y, down_y)
        valid = valid & ok4 & _norm_ok(corner1, c4)
        c3 = _line_intersect(vp2, c2, vp1, c4)
        valid = valid & _inside(c3, box_lt, box_rb)
        valid = valid & _norm_ok(c3, c4) & _norm_ok(c3, c2)
    else:
        c3, ok3 = _hit_vertical(vp2, c2, x_opp, top_y, down_y)
        valid = valid & ok3 & _norm_ok(c2, c3)
        c4 = _line_intersect(vp1, c3, vp2, corner1)
        # note: the reference checks this corner against the raw x-range but
        # the distmap-expanded y-range (box_proposal_detail.cpp:347)
        valid = valid & _inside(c4, torch.stack([left_x, expan_lt[..., 1]], dim=-1),
                                torch.stack([right_x, expan_rb[..., 1]], dim=-1))
        valid = valid & _norm_ok(c3, c4) & _norm_ok(c4, corner1)

    c5, ok5 = _hit_horizontal(vp3, c3, down_y, left_x, right_x)
    valid = valid & ok5 & _norm_ok(c3, c5)
    c6 = _line_intersect(vp2, c5, vp3, c2)
    valid = valid & _inside(c6, expan_lt, expan_rb) & _norm_ok(c6, c2) & _norm_ok(c6, c5)
    c7 = _line_intersect(vp1, c6, vp3, corner1)
    valid = valid & _inside(c7, expan_lt, expan_rb) & _norm_ok(c7, corner1) & _norm_ok(c7, c6)
    c8 = _line_intersect(vp1, c5, vp2, c7)
    valid = (valid & _inside(c8, expan_lt, expan_rb) & _norm_ok(c8, c4) & _norm_ok(c8, c5)
             & _norm_ok(c8, c7))

    corners = torch.stack(torch.broadcast_tensors(corner1, c2, c3, c4, c5, c6, c7, c8), dim=-2)
    corners = torch.where(valid[..., None, None], corners, 0.0)
    return corners, valid, vp1_pos


# ---------------------------------------------------------------------------
# per-(roll, pitch, yaw) VP support angles
# ---------------------------------------------------------------------------

def vp_support_edge_infos(vps, edge_angles, edge_mids, line_mask):
    """Boundary supported-edge angles per VP (object_3d_util.cpp:380-425).

    vps: (..., 3, 2); edge_angles: (..., L); edge_mids: (..., L, 2);
    line_mask: (..., L) bool, the line tensors broadcastable against vps'
    leading dims. Returns (bound_angles (..., 3, 2), has_support (..., 3))."""
    thres = table(_VP_THRES, vps.device)
    bounds, hass = [], []
    for k, swap in ((0, False), (1, True), (2, True)):
        vp = vps[..., k, :]
        raw = torch.atan2(edge_mids[..., 1] - vp[..., 1, None], edge_mids[..., 0] - vp[..., 0, None])
        norm = geo.normalize_to_pi(raw)
        diff = geo.angle_diff_undirected(edge_angles, norm)
        inlier = (diff < thres[k]) & line_mask
        has = torch.any(inlier, dim=-1)
        # smooth_jump_angles (object_3d_util.cpp:175-189): base = first inlier
        first = torch.argmax(inlier.to(torch.uint8), dim=-1, keepdim=True)
        base = torch.take_along_dim(raw, first, dim=-1)
        shifted = torch.where(raw - base < -math.pi, raw + 2 * math.pi,
                              torch.where(raw - base > math.pi, raw - 2 * math.pi, raw))
        low_idx = torch.argmax(torch.where(inlier, shifted, -BIG), dim=-1, keepdim=True)
        top_idx = torch.argmin(torch.where(inlier, shifted, BIG), dim=-1, keepdim=True)
        ang = edge_angles.expand(raw.shape)
        top_a = torch.take_along_dim(ang, top_idx, dim=-1)[..., 0]
        low_a = torch.take_along_dim(ang, low_idx, dim=-1)[..., 0]
        a0, a1 = (top_a, low_a) if swap else (low_a, top_a)
        bounds.append(torch.stack([a0, a1], dim=-1))
        hass.append(has)
    return torch.stack(bounds, dim=-2), torch.stack(hass, dim=-1)


def box_edge_angle_error(bound_angles, has_support, vp_box_edges, corners):
    """Angle alignment error (object_3d_util.cpp:455-492).

    bound_angles (..., 3, 2), has_support (..., 3), vp_box_edges (3, 4)
    numpy int, corners (..., 8, 2). Returns (...) total angle diff."""
    not_found_penalty = np.deg2rad(30.0) * 2.0
    total = 0.0
    for vp_id in range(3):
        per_vp = 0.0
        for ee in range(2):
            p1 = corners[..., int(vp_box_edges[vp_id, 2 * ee]), :]
            p2 = corners[..., int(vp_box_edges[vp_id, 2 * ee + 1]), :]
            ang = geo.normalize_to_pi(torch.atan2(p2[..., 1] - p1[..., 1], p2[..., 0] - p1[..., 0]))
            diffs = geo.angle_diff_undirected(ang[..., None], bound_angles[..., vp_id, :])  # (..., 2)
            per_vp = per_vp + torch.amin(diffs, dim=-1)
        total = total + torch.where(has_support[..., vp_id], per_vp, not_found_penalty)
    return total


def box_edge_sum_dists(dist_maps, corners, edge_ids, edge_weights):
    """Summed distance-map values along 11 samples per visible edge
    (object_3d_util.cpp:427-453).

    dist_maps (BH, H, W), one per (bbox, height) region; corners
    (BH, ..., 8, 2) full-image coordinates, each proposal reading its own
    region's map; edge_ids (E, 2) numpy; edge_weights (E,) tensor.
    Returns (BH, ...)."""
    BH, H, W = dist_maps.shape
    p1 = corners[..., edge_ids[:, 0].tolist(), :]  # (BH, ..., E, 2)
    p2 = corners[..., edge_ids[:, 1].tolist(), :]
    # i * 0.1f, not i / 10: XLA compiles the JAX package's `/ 10.0` to a
    # multiply by the float32 constant 0.1, and the samples are truncated to
    # pixels, so the last bit decides which pixel is read
    s = torch.arange(11, dtype=torch.float32, device=corners.device)[:, None, None] * 0.1  # (11, 1, 1)
    pts = s * p1[..., None, :, :] + (1.0 - s) * p2[..., None, :, :]  # (BH, ..., 11, E, 2)
    xi = torch.clamp(pts[..., 0].to(torch.int32), 0, W - 1)  # truncation, as astype(int32)
    yi = torch.clamp(pts[..., 1].to(torch.int32), 0, H - 1)
    flat = (yi.to(torch.int64) * W + xi).reshape(BH, -1)
    vals = torch.gather(dist_maps.reshape(BH, H * W), 1, flat).reshape(yi.shape)  # (BH, ..., 11, E)
    return torch.sum(vals * edge_weights, dim=(-2, -1))


# ---------------------------------------------------------------------------
# score fusion (fuse_normalize_scores_v2, object_3d_util.cpp:495-565)
# ---------------------------------------------------------------------------

def fuse_normalize_scores(dist_err, angle_err, valid, weight_vp_angle=WEIGHT_VP_ANGLE):
    """Masked port of fuse_normalize_scores_v2 over the last dim (leading
    dims are independent groups). Returns (scores, keep_mask): scores are the
    normalized combined errors for kept proposals (BIG elsewhere)."""
    Lp = dist_err.shape[-1]
    n = torch.sum(valid, dim=-1, keepdim=True)
    d = torch.where(valid, dist_err, BIG)
    a = torch.where(valid, angle_err, BIG)

    order_d = torch.argsort(d, dim=-1, stable=True)
    order_a = torch.argsort(a, dim=-1, stable=True)
    ar = torch.arange(Lp, device=d.device).expand(order_d.shape)
    rank_d = torch.empty_like(order_d).scatter_(-1, order_d, ar)
    rank_a = torch.empty_like(order_a).scatter_(-1, order_a, ar)

    bn = torch.round(n.to(torch.float32) / 3.0 * 2.0).to(torch.int64)
    a_sorted = torch.take_along_dim(a, order_a, dim=-1)
    idx1 = torch.clamp(bn - 1, 0, Lp - 1)
    idx2 = torch.clamp(bn - 2, 0, Lp - 1)
    consider_angle = (torch.take_along_dim(a_sorted, idx1, dim=-1)
                      > torch.take_along_dim(a_sorted, idx2, dim=-1))

    keep_small = valid  # n <= 4: keep everything
    keep_d = valid & (rank_d < bn - 1)
    keep_da = keep_d & (rank_a < bn - 1)
    keep = torch.where(n > 4, torch.where(consider_angle, keep_da, keep_d), keep_small)

    kd_min = torch.amin(torch.where(keep, d, BIG), dim=-1, keepdim=True)
    kd_max = torch.amax(torch.where(keep, d, -BIG), dim=-1, keepdim=True)
    ka_min = torch.amin(torch.where(keep, a, BIG), dim=-1, keepdim=True)
    ka_max = torch.amax(torch.where(keep, a, -BIG), dim=-1, keepdim=True)
    n_keep = torch.sum(keep, dim=-1, keepdim=True)

    d_span = kd_max - kd_min
    a_span = ka_max - ka_min
    nd = (d - kd_min) / torch.where(d_span > 0, d_span, 1.0)
    na_norm = (a - ka_min) / torch.where(a_span > 0, a_span, 1.0)
    # reference quirk: if angle span == 0, the *raw* angles enter the blend
    na = torch.where(a_span > 0, na_norm, a)
    combined_norm = (nd + weight_vp_angle * na) / (1.0 + weight_vp_angle)
    combined_raw = (d + weight_vp_angle * a) / (1.0 + weight_vp_angle)
    scores = torch.where(n_keep > 1, combined_norm, combined_raw)
    return torch.where(keep, scores, BIG), keep


# ---------------------------------------------------------------------------
# 2D -> 3D lifting (object_3d_util.cpp:568-648)
# ---------------------------------------------------------------------------

def ray_plane_interact(rays, plane):
    """rays (..., N, 3) from origin; plane (..., 4). -> intersections (..., N, 3)."""
    denom = torch.einsum("...k,...nk->...n", plane[..., :3], rays)
    denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
    frac = -plane[..., 3:4] / denom
    return frac[..., None] * rays


def plane_hits_3d(Twc, invK, plane_sensor, pixels):
    """Ray-cast pixels (..., N, 2) onto a plane (sensor frame), world output
    (plane_hits_3d, object_3d_util.cpp:574-585)."""
    ph = torch.cat([pixels, torch.ones(pixels.shape[:-1] + (1,), dtype=pixels.dtype,
                                       device=pixels.device)], dim=-1)
    rays = ph @ invK.transpose(-1, -2)
    pts_sensor = ray_plane_interact(rays, plane_sensor)
    return geo.transform_points(Twc, pts_sensor)


def get_wall_plane_equation(g1, g2):
    """World wall plane through ground segment g1-g2 (z=0)
    (object_3d_util.cpp:587-600). g1, g2: (..., 3)."""
    up = torch.tensor([0.0, 0.0, 1.0], dtype=g1.dtype, device=g1.device).expand(g1.shape)
    n = torch.linalg.cross(g1 - g2, up, dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    n = n / torch.where(nn < 1e-12, 1e-12, nn)
    dist = -torch.sum(n * g1, dim=-1, keepdim=True)
    plane = torch.cat([n, dist], dim=-1)
    return torch.where(dist < 0, -plane, plane)


def lift_to_3d(corners2d, yaw, vp1_pos, Twc, invK, ground_plane_sensor):
    """change_2d_corner_to_3d_object (object_3d_util.cpp:610-648), batched
    over leading dims. corners2d: (..., 8, 2) in chain order; returns
    (pos (..., 3), scale (..., 3), corners2d_struct (..., 8, 2))."""
    gnd_px = corners2d[..., 4:8, :]  # corners 5-8
    gnd_w = plane_hits_3d(Twc, invK, ground_plane_sensor, gnd_px)  # (..., 4, 3)
    length_half = torch.linalg.vector_norm(gnd_w[..., 0, :] - gnd_w[..., 3, :], dim=-1) / 2
    width_half = torch.linalg.vector_norm(gnd_w[..., 0, :] - gnd_w[..., 1, :], dim=-1) / 2

    wall_world = get_wall_plane_equation(gnd_w[..., 0, :], gnd_w[..., 1, :])
    wall_sensor = torch.einsum("...ji,...j->...i", Twc, wall_world)
    top_w = plane_hits_3d(Twc, invK, wall_sensor, corners2d[..., 1:2, :])  # corner 2
    height_half = top_w[..., 0, 2] / 2

    mean_x = torch.mean(gnd_w[..., :, 0], dim=-1)
    mean_y = torch.mean(gnd_w[..., :, 1], dim=-1)
    pos = torch.stack([mean_x, mean_y, height_half], dim=-1)
    scale = torch.stack([length_half, width_half, height_half], dim=-1)

    remap_l = table(_CUBOID_REMAP_VP_LEFT, corners2d.device, torch.int64)
    remap_r = table(_CUBOID_REMAP_VP_RIGHT, corners2d.device, torch.int64)
    remap = torch.where((vp1_pos == 1)[..., None], remap_l, remap_r)  # (..., 8)
    corners_struct = torch.take_along_dim(corners2d, remap[..., None].expand(remap.shape + (2,)), dim=-2)
    return pos, scale, corners_struct


# ---------------------------------------------------------------------------
# the lattice: all (bbox, height-sample) regions -> scored proposals
# ---------------------------------------------------------------------------

class LatticeResult(NamedTuple):
    """Flat per-proposal tensors of shape (..., L) / (..., L, k)."""

    valid: torch.Tensor
    keep: torch.Tensor          # survived fuse_normalize 2/3 cut
    norm_score: torch.Tensor    # normalized combined error (BIG if not kept)
    dist_err: torch.Tensor
    angle_err: torch.Tensor
    config_id: torch.Tensor
    vp1_pos: torch.Tensor
    yaw: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    pos: torch.Tensor           # (..., L, 3)
    scale: torch.Tensor         # (..., L, 3)
    corners2d: torch.Tensor     # (..., L, 8, 2) struct order
    down_expand: torch.Tensor


def _distance_maps(gray, bh, edt):
    """The (BH, H, W) distance maps of every (bbox, height) region: the
    frame's Canny NMS once, then hysteresis and the exact EDT confined to
    each region's expanded rect. `edt` computes the maps
    (ops/hopper_kernels.edt_l2 on the main path)."""
    H, W = gray.shape
    dev = gray.device
    lt, rb = bh["expan_lt"], bh["expan_rb"]  # (BH, 2)
    with profiler.span("detect.edges"):
        strong, weak = im_ops.canny_nms(gray)
        yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
        rect = ((xx >= lt[:, 0, None, None]) & (xx <= rb[:, 0, None, None])
                & (yy >= lt[:, 1, None, None]) & (yy <= rb[:, 1, None, None]))  # (BH, H, W)
        edges = im_ops.canny_hysteresis(strong & rect, weak & rect)
    with profiler.span("detect.edt"):
        return edt(edges)


def _lattice(dist_maps, bh, K, invK, Twc_raw, cam_yaw, sample_roll_pitch: bool):
    """Evaluate the full proposal lattice of every (bbox, height) region.

    dist_maps: the regions' (BH, H, W) distance maps (_distance_maps).
    bh: dict of padded per-region inputs with leading dim BH (see unpack_bh).
    Returns LatticeResult with (BH, L) leading dims, L = NRP * NY * NT * 2."""
    dev = dist_maps.device
    lt, rb = bh["expan_lt"], bh["expan_rb"]  # (BH, 2)
    BH = lt.shape[0]

    # --- per (roll, pitch): sampled camera pose
    rolls, pitchs, rp_mask = bh["rolls"], bh["pitchs"], bh["rp_mask"]  # (BH, NRP)
    NRP = rolls.shape[1]
    if sample_roll_pitch:
        R_new = geo.euler_zyx_to_rot(rolls, pitchs, cam_yaw.expand(rolls.shape))
    else:
        R_new = Twc_raw[:3, :3].expand(rolls.shape + (3, 3))
    Twc_new = geo.make_T(R_new, Twc_raw[:3, 3].expand(rolls.shape + (3,)))  # (BH, NRP, 4, 4)
    gplane_world = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    gplane_sensor = torch.einsum("...ji,j->...i", Twc_new, gplane_world)  # (BH, NRP, 4)
    KinvR = K @ R_new.transpose(-1, -2)  # (BH, NRP, 3, 3)

    # --- per (rp, yaw): vanishing points + VP-support angles
    yaws, yaw_mask = bh["yaws"], bh["yaw_mask"]  # (BH, NY)
    NY = yaws.shape[1]
    cy, sy, zy = torch.cos(yaws), torch.sin(yaws), 0.0 * yaws
    dirs = torch.stack([torch.stack([cy, sy, zy], -1), torch.stack([-sy, cy, zy], -1),
                        torch.stack([zy, zy, 1.0 + zy], -1)], dim=-2)  # (BH, NY, 3, 3) rows d_k
    vs = dirs[:, None] @ KinvR[:, :, None].transpose(-1, -2)  # (BH, NRP, NY, 3, 3)
    w = _nonzero(vs[..., 2:3])
    vps = vs[..., :2] / w  # (BH, NRP, NY, 3, 2)

    line_angles = bh["line_angles"][:, None, None, :]  # (BH, 1, 1, L)
    line_mids = bh["line_mids"][:, None, None]
    line_mask = bh["line_mask"][:, None, None, :]
    bound, has = vp_support_edge_infos(vps, line_angles, line_mids, line_mask)

    # --- corner chains + scoring over (rp, yaw, top, config)
    top_pts, top_mask = bh["top_pts"], bh["top_mask"]  # (BH, NT, 2), (BH, NT)
    NT = top_pts.shape[1]

    def lat(x):  # per-region scalar/pair -> broadcastable over (NRP, NY, NT)
        return x.reshape((BH, 1, 1, 1) + x.shape[1:])

    bx = {"left_x": lat(bh["left_x"]), "top_y": lat(bh["top_y"]), "right_x": lat(bh["right_x"]),
          "down_y_expan": lat(bh["down_y_expan"]), "expan_lt": lat(lt), "expan_rb": lat(rb)}
    vp_l = vps[:, :, :, None]           # (BH, NRP, NY, 1, 3, 2)
    corner1 = top_pts[:, None, None]    # (BH, 1, 1, NT, 2)
    bound_l, has_l = bound[:, :, :, None], has[:, :, :, None]
    diag = lat(bh["diag"])

    outs = []
    for cid in (1, 2):
        ids, wts, vpbox = _EDGE_TABLES[cid]
        corners, ok, vp1_pos = corner_chain(vp_l[..., 0, :], vp_l[..., 1, :], vp_l[..., 2, :],
                                            corner1, cid, bx)
        sdist = box_edge_sum_dists(dist_maps, corners, ids, table(wts, dev))
        aerr = box_edge_angle_error(bound_l, has_l, vpbox, corners)
        outs.append((corners, ok, vp1_pos, sdist / diag, aerr))
    corners_l, ok_l, vp1_l, dist_l, ang_l = (torch.stack([o[i] for o in outs], dim=4) for i in range(5))
    # (BH, NRP, NY, NT, 2, ...)

    full_mask = (rp_mask[:, :, None, None, None] & yaw_mask[:, None, :, None, None]
                 & top_mask[:, None, None, :, None] & bh["config_mask"][:, None, None, None, :])
    valid = ok_l & full_mask

    L = NRP * NY * NT * 2

    def flat(x):
        return x.reshape((BH, L) + x.shape[5:])

    valid_f = flat(valid)
    dist_f = flat(dist_l)
    ang_f = flat(ang_l)
    corners_f = flat(corners_l)  # (BH, L, 8, 2)
    vp1_f = flat(vp1_l)

    # lattice coordinates of each flat proposal
    shape5 = (BH, NRP, NY, NT, 2)
    rp_f = flat(torch.arange(NRP, device=dev)[None, :, None, None, None].expand(shape5))
    y_f = flat(torch.arange(NY, device=dev)[None, None, :, None, None].expand(shape5))
    cfg_f = flat(torch.arange(1, 3, device=dev)[None, None, None, None, :].expand(shape5))
    roll_f = torch.gather(rolls, 1, rp_f)
    pitch_f = torch.gather(pitchs, 1, rp_f)
    yaw_f = torch.gather(yaws, 1, y_f)

    # --- fuse/normalize within each (bbox, height) region
    norm_score, keep = fuse_normalize_scores(dist_f, ang_f, valid_f)

    # --- lift all proposals to 3D
    b_idx = torch.arange(BH, device=dev)[:, None]
    Twc_p = Twc_new[b_idx, rp_f]            # (BH, L, 4, 4)
    gplane_p = gplane_sensor[b_idx, rp_f]   # (BH, L, 4)
    pos, scale, corners_struct = lift_to_3d(corners_f, yaw_f, vp1_f, Twc_p, invK, gplane_p)
    good_scale = (torch.all(scale > 0, dim=-1) & torch.all(torch.isfinite(scale), dim=-1)
                  & torch.all(torch.isfinite(pos), dim=-1))
    keep = keep & good_scale

    return LatticeResult(
        valid=valid_f, keep=keep, norm_score=torch.where(keep, norm_score, BIG),
        dist_err=dist_f, angle_err=ang_f, config_id=cfg_f, vp1_pos=vp1_f,
        yaw=yaw_f, roll=roll_f, pitch=pitch_f, pos=pos, scale=scale,
        corners2d=corners_struct, down_expand=bh["down_expand"][:, None].expand(keep.shape),
    )


def unpack_bh(packA, packTop, packLines, packYaw, packRP):
    """Expand the 5 packed input arrays into the per-(bbox, height) input
    dict consumed by the lattice (same layout as the JAX package)."""
    return {
        "left_x": packA[..., 0], "top_y": packA[..., 1],
        "right_x": packA[..., 2], "down_y_expan": packA[..., 3],
        "expan_lt": packA[..., 4:6], "expan_rb": packA[..., 6:8],
        "diag": packA[..., 8], "down_expand": packA[..., 9],
        "config_mask": packA[..., 10:12] > 0.5,
        "bh_mask": packA[..., 12] > 0.5,
        "top_pts": packTop[..., :2], "top_mask": packTop[..., 2] > 0.5,
        "line_angles": packLines[..., 0], "line_mids": packLines[..., 1:3],
        "line_mask": packLines[..., 3] > 0.5,
        "yaws": packYaw[..., 0], "yaw_mask": packYaw[..., 1] > 0.5,
        "rolls": packRP[..., 0], "pitchs": packRP[..., 1],
        "rp_mask": packRP[..., 2] > 0.5,
    }


def _detect_lattice(gray, bh_batch, K, invK, Twc_raw, cam_yaw, sample_roll_pitch: bool,
                    top_k: int, nominal_skew_ratio: float, max_cut_skew: float, edt):
    """detect_lattice_batch with the distance transform as an argument (the
    main path passes the kernel dispatch; the kernel-vs-plain comparison in
    chip_smoke.py and the tests pass the plain version)."""
    bh = unpack_bh(*bh_batch)
    NB, NH = bh["left_x"].shape
    bh_flat = {k: v.reshape((NB * NH,) + v.shape[2:]) for k, v in bh.items()}
    dist_maps = _distance_maps(gray, bh_flat, edt)
    with profiler.span("detect.proposals"):
        res = _lattice(dist_maps, bh_flat, K, invK, Twc_raw, cam_yaw, sample_roll_pitch)
    with profiler.span("detect.scoring"):
        return _top_k(res, bh, NB, NH, top_k, nominal_skew_ratio, max_cut_skew)


def _top_k(res, bh, NB, NH, top_k, nominal_skew_ratio, max_cut_skew):
    """The k best proposals of each bbox by the skew-penalized score, their
    fields packed (NB, top_k, 33)."""
    # flatten the height dim into the proposal dim
    res = LatticeResult(*[x.reshape((NB, -1) + x.shape[2:]) for x in res])
    L = res.keep.shape[1] // NH
    keep = res.keep & torch.repeat_interleave(bh["bh_mask"], L, dim=1)

    skew = torch.amax(res.scale[..., :2], dim=-1) / torch.clamp(
        torch.amin(res.scale[..., :2], dim=-1), min=1e-12)
    skew_err = WEIGHT_SKEW_ERROR * torch.clamp(skew - nominal_skew_ratio, min=0.0)
    skew_err = torch.where(skew > max_cut_skew, 100.0, skew_err)
    combined = res.norm_score + WEIGHT_SKEW_ERROR * skew_err
    combined = torch.where(keep, combined, BIG)

    # the k smallest, ties to the lower index (lax.top_k of -combined)
    order = torch.sort(combined, dim=1, stable=True).indices
    top_idx = order[:, :top_k]
    top_scores = torch.gather(combined, 1, top_idx)
    top_valid = torch.gather(keep, 1, top_idx)

    def take(x):
        idx = top_idx
        while idx.ndim < x.ndim:
            idx = idx[..., None]
        return torch.take_along_dim(x, idx, dim=1)

    packed_f = torch.cat(
        [
            take(res.pos), take(res.scale),
            take(res.corners2d).reshape(NB, top_k, 16),
            take(res.yaw)[..., None], take(res.roll)[..., None],
            take(res.pitch)[..., None], take(res.dist_err)[..., None],
            take(res.angle_err)[..., None], take(res.norm_score)[..., None],
            take(res.down_expand)[..., None],
            take(res.config_id).to(torch.float32)[..., None],
            take(res.vp1_pos).to(torch.float32)[..., None],
            top_scores[..., None],
            top_valid.to(torch.float32)[..., None],
        ],
        dim=-1,
    )  # (NB, top_k, 33)
    return res, top_idx, top_scores, top_valid, packed_f


def detect_lattice_batch(gray, bh_batch, K, invK, Twc_raw, cam_yaw, sample_roll_pitch: bool,
                         top_k: int, nominal_skew_ratio: float, max_cut_skew: float):
    """Full-frame fused detection: Canny NMS once, then the lattice over all
    (bbox, height) samples, then per-bbox top-k over the skew-penalized
    combined score (box_proposal_detail.cpp:517-536).

    bh_batch: the 5 packed arrays with leading dims (NB, NH) (see unpack_bh).
    Returns (LatticeResult reshaped (NB, NH*L), top-k indices, top-k score,
    top-k valid, packed top-k fields (NB, top_k, 33))."""
    return _detect_lattice(gray, bh_batch, K, invK, Twc_raw, cam_yaw, sample_roll_pitch,
                           top_k, nominal_skew_ratio, max_cut_skew, hopper_kernels.edt_l2)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@dataclass
class CuboidProposal:
    """Host-side view of one detected cuboid (parity with the reference's
    `cuboid` struct, detect_3d_cuboid.h:15-36)."""

    pos: np.ndarray            # (3,)
    rotY: float
    scale: np.ndarray          # (3,) half extents
    box_config_type: np.ndarray  # [config_id, vp1_position]
    box_corners_2d: np.ndarray   # (2, 8) int, struct corner order
    rect_detect_2d: np.ndarray   # (4,) [x y w h]
    edge_distance_error: float
    edge_angle_error: float
    normalized_error: float
    skew_ratio: float
    down_expand_height: float
    camera_roll_delta: float
    camera_pitch_delta: float


@dataclass
class CuboidDetector:
    """Mirror of the reference detector's mode flags
    (detect_3d_cuboid.h:53-80) over the batched lattice; `device` is where
    the lattice runs (default: the card)."""

    consider_config_1: bool = True
    consider_config_2: bool = True
    whether_sample_cam_roll_pitch: bool = False
    whether_sample_bbox_height: bool = False
    max_cuboid_num: int = 1
    nominal_skew_ratio: float = 1.0
    max_cut_skew: float = 3.0

    # static padding capacities (lattice shape)
    max_lines: int = 80
    max_top_samples: int = 32
    num_yaw_pad: int = 16
    num_rp_pad: int = 25  # 5 x 5 when sampling roll/pitch
    max_height_samples: int = 3
    top_k: int = 16

    K: np.ndarray | None = None
    device: torch.device | None = None

    def __post_init__(self):
        self.device = resolve(self.device)
        if self.K is not None:
            self.set_calibration(self.K)

    @classmethod
    def from_config(cls, d: dict, device=None):
        """Build from `dataclasses.asdict` of a cube_slam_tpu CuboidDetector
        (numpy values)."""
        return cls(**d, device=device)

    def set_calibration(self, K):
        self.K = np.asarray(K, dtype=np.float64)

    # -- host prep ---------------------------------------------------------
    def _prepare_bh(self, bbox, down_expand_sample, lines_aligned, img_hw, cam_euler_raw,
                    cam_yaw_raw):
        """Per-(bbox, height-sample) padded inputs
        (box_proposal_detail.cpp:107-191 integer bookkeeping, exact)."""
        img_h, img_w = img_hw
        left_x_raw = int(bbox[0])
        top_y_raw = int(bbox[1])
        obj_width_raw = int(bbox[2])
        obj_height_raw = int(bbox[3])
        right_x_raw = left_x_raw + obj_width_raw

        obj_height_expan = obj_height_raw + down_expand_sample
        down_y_expan = top_y_raw + obj_height_expan
        diag = np.sqrt(obj_width_raw**2 + obj_height_expan**2)

        # top-edge x samples (integer linespace, :144-152)
        step = min(20, obj_width_raw // 10)
        step = max(step, 1)
        top_xs = linespace_cpp(left_x_raw + 5, right_x_raw - 5, step).astype(np.int64)
        top_pts = np.zeros((self.max_top_samples, 2), dtype=np.float32)
        top_mask = np.zeros(self.max_top_samples, dtype=bool)
        nt = min(len(top_xs), self.max_top_samples)
        top_pts[:nt, 0] = top_xs[:nt]
        top_pts[:nt, 1] = top_y_raw
        top_mask[:nt] = True

        # distance-map expansion margin (:155-163)
        wid = min(max(min(20, obj_width_raw - 100), 10), max(min(20, obj_height_expan - 100), 10))
        left_e = max(0, left_x_raw - wid)
        right_e = min(img_w - 1, right_x_raw + wid)
        top_e = max(0, top_y_raw - wid)
        down_e = min(img_h - 1, down_y_expan + wid)

        # lines inside expanded box, greedy-merged (:165-182)
        inside = line_ops.filter_inside_box(lines_aligned, (left_e, top_e), (right_e, down_e))
        merged = line_ops.merge_break_lines(inside, 20.0, 5.0, 30.0)
        angles, mids = line_ops.line_angles_midpoints(merged)
        nl = min(merged.shape[0], self.max_lines)
        line_angles = np.zeros(self.max_lines, dtype=np.float32)
        line_mids = np.zeros((self.max_lines, 2), dtype=np.float32)
        line_mask = np.zeros(self.max_lines, dtype=bool)
        line_angles[:nl] = angles[:nl]
        line_mids[:nl] = mids[:nl]
        line_mask[:nl] = True

        # object yaw samples (:126-128)
        yaw_init = cam_yaw_raw - np.pi / 2.0
        yaw_s = linespace_cpp(yaw_init - np.deg2rad(45.0), yaw_init + np.deg2rad(45.0),
                              np.deg2rad(6.0))
        yaws = np.zeros(self.num_yaw_pad, dtype=np.float32)
        yaw_mask = np.zeros(self.num_yaw_pad, dtype=bool)
        ny = min(len(yaw_s), self.num_yaw_pad)
        yaws[:ny] = yaw_s[:ny]
        yaw_mask[:ny] = True

        # camera roll/pitch samples (:215-226)
        if self.whether_sample_cam_roll_pitch:
            roll_s = linespace_cpp(cam_euler_raw[0] - np.deg2rad(6.0),
                                   cam_euler_raw[0] + np.deg2rad(6.0), np.deg2rad(3.0))
            pitch_s = linespace_cpp(cam_euler_raw[1] - np.deg2rad(6.0),
                                    cam_euler_raw[1] + np.deg2rad(6.0), np.deg2rad(3.0))
        else:
            roll_s = np.array([cam_euler_raw[0]])
            pitch_s = np.array([cam_euler_raw[1]])
        rp = np.array([(r, p) for r in roll_s for p in pitch_s])
        nrp_pad = self.num_rp_pad if self.whether_sample_cam_roll_pitch else 1
        rolls = np.zeros(nrp_pad, dtype=np.float32)
        pitchs = np.zeros(nrp_pad, dtype=np.float32)
        rp_mask = np.zeros(nrp_pad, dtype=bool)
        nrp = min(len(rp), nrp_pad)
        rolls[:nrp] = rp[:nrp, 0]
        pitchs[:nrp] = rp[:nrp, 1]
        rp_mask[:nrp] = True

        return {
            "left_x": np.float32(left_x_raw), "top_y": np.float32(top_y_raw),
            "right_x": np.float32(right_x_raw), "down_y_expan": np.float32(down_y_expan),
            "expan_lt": np.array([left_e, top_e], dtype=np.float32),
            "expan_rb": np.array([right_e, down_e], dtype=np.float32),
            "diag": np.float32(diag),
            "down_expand": np.float32(down_expand_sample),
            "top_pts": top_pts, "top_mask": top_mask,
            "line_angles": line_angles, "line_mids": line_mids, "line_mask": line_mask,
            "yaws": yaws, "yaw_mask": yaw_mask,
            "rolls": rolls, "pitchs": pitchs, "rp_mask": rp_mask,
            "config_mask": np.array([self.consider_config_1, self.consider_config_2]),
            "bh_mask": np.asarray(True),
        }

    def prepare_batch(self, rgb_or_gray, transToWorld, obj_bboxes, lines_raw):
        """Host-side prep: padded (bbox, height) batch + device args for
        detect_lattice_batch. Returns (kernel_args dict, aux dict)."""
        if self.K is None:
            raise ValueError("call set_calibration first")
        gray = rgb_or_gray if rgb_or_gray.ndim == 2 else io_utils.rgb_to_gray(rgb_or_gray)
        img_h, img_w = gray.shape
        Twc = np.asarray(transToWorld, dtype=np.float64)
        roll, pitch, yaw = np_geo.rot_to_euler_zyx(Twc[:3, :3])
        cam_euler_raw = (roll, pitch, yaw)

        lines_aligned = line_ops.align_left_right_edges(np.asarray(lines_raw, dtype=np.float64))

        bboxes = np.asarray(obj_bboxes, dtype=np.float64)
        num_obj = bboxes.shape[0]

        # height expansion samples (box_proposal_detail.cpp:114-123)
        def height_samples(bbox):
            samples = [0]
            if self.whether_sample_bbox_height:
                h = int(bbox[3])
                rng = max(min(20, h - 90), 20)
                rng = min(rng, img_h - int(bbox[1]) - h - 1)
                if rng > 10:
                    samples.append(int(round(rng / 2)))
                samples.append(rng)
            return samples[: self.max_height_samples]

        NH = self.max_height_samples if self.whether_sample_bbox_height else 1
        bh_list = []
        for b in range(num_obj):
            hs = height_samples(bboxes[b])
            row = []
            for hi in range(NH):
                if hi < len(hs):
                    d = self._prepare_bh(bboxes[b], hs[hi], lines_aligned, (img_h, img_w),
                                         cam_euler_raw, yaw)
                else:
                    d = self._prepare_bh(bboxes[b], 0, lines_aligned, (img_h, img_w),
                                         cam_euler_raw, yaw)
                    d["bh_mask"] = np.asarray(False)
                row.append(d)
            bh_list.append(row)

        # the ~20 per-bh fields in 5 arrays (one upload each)
        NT = self.max_top_samples
        L = self.max_lines
        NY = self.num_yaw_pad
        NRP = len(bh_list[0][0]["rolls"])
        packA = np.zeros((num_obj, NH, 13), dtype=np.float32)
        packTop = np.zeros((num_obj, NH, NT, 3), dtype=np.float32)
        packLines = np.zeros((num_obj, NH, L, 4), dtype=np.float32)
        packYaw = np.zeros((num_obj, NH, NY, 2), dtype=np.float32)
        packRP = np.zeros((num_obj, NH, NRP, 3), dtype=np.float32)
        for b in range(num_obj):
            for h in range(NH):
                d = bh_list[b][h]
                packA[b, h, 0:4] = [d["left_x"], d["top_y"], d["right_x"], d["down_y_expan"]]
                packA[b, h, 4:6] = d["expan_lt"]
                packA[b, h, 6:8] = d["expan_rb"]
                packA[b, h, 8] = d["diag"]
                packA[b, h, 9] = d["down_expand"]
                packA[b, h, 10:12] = d["config_mask"]
                packA[b, h, 12] = d["bh_mask"]
                packTop[b, h, :, :2] = d["top_pts"]
                packTop[b, h, :, 2] = d["top_mask"]
                packLines[b, h, :, 0] = d["line_angles"]
                packLines[b, h, :, 1:3] = d["line_mids"]
                packLines[b, h, :, 3] = d["line_mask"]
                packYaw[b, h, :, 0] = d["yaws"]
                packYaw[b, h, :, 1] = d["yaw_mask"]
                packRP[b, h, :, 0] = d["rolls"]
                packRP[b, h, :, 1] = d["pitchs"]
                packRP[b, h, :, 2] = d["rp_mask"]

        def dev(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32, device=self.device)

        kernel_args = dict(
            gray=dev(gray),
            bh_batch=tuple(dev(p) for p in (packA, packTop, packLines, packYaw, packRP)),
            K=dev(self.K), invK=dev(np.linalg.inv(self.K)), Twc_raw=dev(Twc),
            cam_yaw=dev(np.float32(yaw)),
            sample_roll_pitch=self.whether_sample_cam_roll_pitch,
            top_k=self.top_k,
            nominal_skew_ratio=float(self.nominal_skew_ratio),
            max_cut_skew=float(self.max_cut_skew),
        )
        aux = dict(bboxes=bboxes, cam_euler_raw=cam_euler_raw, num_obj=num_obj)
        return kernel_args, aux

    def detect_cuboid(self, rgb_or_gray, transToWorld, obj_bboxes, lines_raw):
        """Reference-equivalent entry point (box_proposal_detail.cpp:56).

        rgb_or_gray: (H, W[, 3]) image; transToWorld: (4, 4) camera-to-world;
        obj_bboxes: (N, >=4) rows [x y w h ...]; lines_raw: (M, 4).
        Returns list (per bbox) of lists of CuboidProposal, best first.
        """
        with profiler.span("detect.prepare"):
            kernel_args, aux = self.prepare_batch(rgb_or_gray, transToWorld, obj_bboxes, lines_raw)
        _, _, _, _, packed = detect_lattice_batch(**kernel_args)
        with profiler.span("detect.unpack"):
            return self.unpack_proposals(packed, aux)

    def unpack_proposals(self, packed, aux):
        """Packed top-k fields (NB, top_k, 33) -> per-bbox CuboidProposal lists."""
        bboxes = aux["bboxes"]
        cam_euler_raw = aux["cam_euler_raw"]
        packed = packed.cpu().numpy()   # ONE device-to-host read
        top_valid = packed[..., 32] > 0.5
        out = []
        for b in range(aux["num_obj"]):
            props = []
            for k in range(min(self.max_cuboid_num, self.top_k)):
                if not top_valid[b, k]:
                    continue
                row = packed[b, k]
                pos = row[0:3]
                scale = row[3:6]
                corners = row[6:22].reshape(8, 2)
                skew = max(scale[0], scale[1]) / max(min(scale[0], scale[1]), 1e-12)
                props.append(CuboidProposal(
                    pos=pos,
                    rotY=float(row[22]),
                    scale=scale,
                    box_config_type=np.array([int(row[29]), int(row[30])]),
                    box_corners_2d=corners.T.astype(np.int32),
                    rect_detect_2d=bboxes[b, :4].copy(),
                    edge_distance_error=float(row[25]),
                    edge_angle_error=float(row[26]),
                    normalized_error=float(row[27]),
                    skew_ratio=float(skew),
                    down_expand_height=float(row[28]),
                    camera_roll_delta=float(row[23] - cam_euler_raw[0]),
                    camera_pitch_delta=float(row[24] - cam_euler_raw[1]),
                ))
            out.append(props)
        return out
