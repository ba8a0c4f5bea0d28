"""Stereo depth from rectified pairs.

PyTorch counterpart of cube_slam_tpu/ops/stereo.py, the stereo input path
of the reference (System::TrackStereo, Frame.cc ComputeStereoMatches: a
per-keypoint 1D search along the same row of the right image). Here every
left keypoint is matched at once: right keypoints in the same row band, at
a positive disparity and an adjacent pyramid level, are scored by Hamming
distance, and the mutual best under the ratio test wins.
"""

from __future__ import annotations

import torch

from . import matching


def stereo_match_keypoints(
    kp_xy_l, kp_desc_l, kp_level_l, kp_valid_l,
    kp_xy_r, kp_desc_r, kp_level_r, kp_valid_r,
    fx, baseline,
    min_disp=0.5, max_disp=256.0, row_band=2.0, max_dist=50,
):
    """Match left keypoints to right keypoints along epipolar rows and
    return per-left-keypoint depth (0 where unmatched).

    Descriptors are (N, 8) int32 words, levels integers; `fx` and
    `baseline` are float32 scalars (0-dim tensors or Python floats read as
    float32), and depth = (fx * baseline) / max(disparity, 1e-3) in that
    order, as the JAX package computes it.

    Returns (depth (N,), disparity (N,), matched (N,)) on the inputs'
    device."""
    dev = kp_xy_l.device
    fx = torch.as_tensor(fx, dtype=torch.float32, device=dev)
    baseline = torch.as_tensor(baseline, dtype=torch.float32, device=dev)
    d = matching.hamming_matrix(kp_desc_l, kp_desc_r, kp_valid_l, kp_valid_r)
    dy = torch.abs(kp_xy_l[:, None, 1] - kp_xy_r[None, :, 1])
    disp = kp_xy_l[:, None, 0] - kp_xy_r[None, :, 0]
    lvl_ok = torch.abs(kp_level_l[:, None] - kp_level_r[None, :]) <= 1
    ok = (dy <= row_band) & (disp >= min_disp) & (disp <= max_disp) & lvl_ok
    d = torch.where(ok, d, matching.BIG)
    idx, _ = matching.match_mutual_ratio(d, max_dist=max_dist, ratio=0.9, mutual=True)
    matched = idx >= 0
    best_disp = torch.where(
        matched,
        kp_xy_l[:, 0] - kp_xy_r[torch.clamp(idx, min=0).to(torch.int64), 0],
        0.0,
    )
    depth = torch.where(matched & (best_disp > 1e-3),
                        (fx * baseline) / torch.clamp(best_disp, min=1e-3), 0.0)
    return depth, best_disp, matched
