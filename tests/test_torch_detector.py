"""cube_slam_tpu_torch models/detector.py against the JAX package on one
320x240 synthetic frame with a box, without and with camera roll/pitch
sampling."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import synth_sequence

from cube_slam_tpu.models import detector as jdet
from cube_slam_tpu.ops import lsd as jlsd
from cube_slam_tpu_torch.models import detector as tdet
from cube_slam_tpu_torch.ops import distance_transform as tdt

# Canny, the EDT and the line inputs are identical on both sides, but the
# vanishing points are not bit-identical: XLA's 3x3 products use FMA and its
# sin/cos round differently, and far-away vanishing points stretch those last
# bits to ~1e-3 px at the corners. Continuous outputs agree to 1e-4; the
# distance score reads pixels (truncated sample points), so a sample within a
# rounding of a pixel border may read the neighbour pixel, which moves the
# map value by at most sqrt(2) (the exact EDT is 1-Lipschitz).
SCORE_TOL = 1e-4
CORNER_TOL = 1e-2        # px
BORDER = 0.02            # px: samples this close to a pixel border may flip
MAX_MISMATCH = 1e-3      # share of proposals whose valid/keep bits may differ
RESULT_TOL = 1e-3        # top-1 pos (m), scale (m), rotY (rad)


@pytest.fixture(scope="module")
def frame():
    seq = synth_sequence(3)
    f = 1
    gray = seq.gray(f)
    lj, vj = jlsd.detect_lines(jnp.asarray(gray), min_length=15.0, max_lines=128)
    return gray, seq.yolo_boxes(f)[:, :4], seq.truth_Twc(0), np.asarray(lj)[np.asarray(vj)], seq.K


def _sample_points(struct, vp1, cfg):
    """Float sample points of box_edge_sum_dists, recomputed from the
    struct-order corners each side returned: (P, 11, 9, 2), NaN-padded."""
    remap = np.where((vp1 == 1)[:, None], tdet._CUBOID_REMAP_VP_LEFT, tdet._CUBOID_REMAP_VP_RIGHT)
    inv = np.argsort(remap, axis=1)
    chain = np.take_along_axis(struct, inv[..., None].repeat(2, -1), axis=1)
    s = (np.arange(11, dtype=np.float32) * np.float32(0.1))[None, :, None, None]
    pts = np.full((len(struct), 11, 9, 2), np.nan, dtype=np.float32)
    for c, ids in ((1, tdet._VISIBLE_EDGES_C1), (2, tdet._VISIBLE_EDGES_C2)):
        m = cfg == c
        p1 = chain[m][:, ids[:, 0]][:, None]
        p2 = chain[m][:, ids[:, 1]][:, None]
        pts[m, :, : len(ids)] = s * p1 + (np.float32(1) - s) * p2
    return pts


def _risky_samples(pa, pb):
    """Samples that may read another pixel on the two sides."""
    def near_border(p):
        f = p - np.floor(p)
        return (f < BORDER) | (f > 1 - BORDER)

    flip = np.trunc(pa) != np.trunc(pb)
    risky = (flip | near_border(pa) | near_border(pb)).any(-1) & np.isfinite(pa).all(-1)
    return risky.sum(axis=(1, 2))


@pytest.mark.parametrize("sample_rp", [False, True])
def test_lattice_matches_jax(frame, sample_rp):
    gray, box, Twc, lines, K = frame
    dj = jdet.CuboidDetector()
    dj.set_calibration(K)
    dj.nominal_skew_ratio = 2.0
    dj.whether_sample_cam_roll_pitch = sample_rp
    dt_ = tdet.CuboidDetector.from_config(dataclasses.asdict(dj), device="cpu")
    ka, _ = dj.prepare_batch(gray, Twc, box, lines)
    kt, _ = dt_.prepare_batch(gray, Twc, box, lines)
    rj = jdet.detect_lattice_batch(**ka)[0]
    rt = tdet._detect_lattice(**kt, edt=tdt.edt_l2)[0]
    j = {k: np.asarray(v)[0] for k, v in rj._asdict().items()}
    t = {k: v.numpy()[0] for k, v in rt._asdict().items()}

    n = j["valid"].size
    assert j["valid"].sum() > 20
    assert (j["valid"] != t["valid"]).sum() <= MAX_MISMATCH * n
    assert (j["keep"] != t["keep"]).sum() <= MAX_MISMATCH * n
    both = j["valid"] & t["valid"]
    assert np.abs(j["angle_err"][both] - t["angle_err"][both]).max() < SCORE_TOL
    assert np.abs(j["corners2d"][both] - t["corners2d"][both]).max() < CORNER_TOL
    assert np.array_equal(j["config_id"][both], t["config_id"][both])
    assert np.array_equal(j["vp1_pos"][both], t["vp1_pos"][both])

    diag = float(np.hypot(int(box[0, 2]), int(box[0, 3])))
    risky = _risky_samples(
        _sample_points(j["corners2d"][both], j["vp1_pos"][both], j["config_id"][both]),
        _sample_points(t["corners2d"][both], t["vp1_pos"][both], t["config_id"][both]))
    bound = SCORE_TOL + risky * 2.0 * np.sqrt(2.0) / diag  # edge weights are at most 2
    gap = np.abs(j["dist_err"][both] - t["dist_err"][both])
    assert (gap <= bound).all(), (gap - bound).max()
    assert (gap[risky == 0] < SCORE_TOL).all()


def test_detect_cuboid_top1_matches_jax(frame):
    gray, box, Twc, lines, K = frame
    out = []
    for mod in (jdet, tdet):
        d = mod.CuboidDetector() if mod is jdet else mod.CuboidDetector(device="cpu")
        d.set_calibration(K)
        d.nominal_skew_ratio = 2.0
        d.whether_sample_cam_roll_pitch = True
        out.append(d.detect_cuboid(gray, Twc, box, lines)[0][0])
    pj, pt = out
    assert np.abs(pj.pos - pt.pos).max() < RESULT_TOL
    assert np.abs(pj.scale - pt.scale).max() < RESULT_TOL
    assert abs(pj.rotY - pt.rotY) < RESULT_TOL
    assert np.array_equal(pj.box_config_type, pt.box_config_type)
    assert abs(pj.normalized_error - pt.normalized_error) < RESULT_TOL
