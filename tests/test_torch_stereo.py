"""cube_slam_tpu_torch ops/stereo.py against the JAX package: row-band
Hamming matching of left and right keypoints and depth = fx * b / disparity.

Inputs: ORB features that the JAX package extracts from stereo pairs of
tests/test_rgbd_stereo.py::test_stereo_tracker_metric's scene (RoomScene
seed 4, baseline 0.12, 320x240, 600 features x 3 levels), and seeded random
keypoints whose descriptors repeat, so that Hamming rows hold ties."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import to_np

from cube_slam_tpu.ops import orb as jorb
from cube_slam_tpu.ops import stereo as jstereo
from cube_slam_tpu.utils import synth
from cube_slam_tpu_torch.ops import matching as tmatching
from cube_slam_tpu_torch.ops import stereo as tstereo

K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
WH = (320, 240)
BASELINE = 0.12


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _stereo_features(frame):
    """JAX ORB features (xy, desc, level, valid) of the left and right
    images of the stereo test's frame, as numpy."""
    scene = synth.RoomScene(seed=4)
    Twc_l = synth.camera_path(40)[frame]
    Twc_r = Twc_l.copy()
    Twc_r[:3, 3] = Twc_l[:3, 3] + Twc_l[:3, :3] @ np.array([BASELINE, 0.0, 0.0])
    cfg = jorb.OrbPyramidConfig(600, n_levels=3)
    out = []
    for Twc in (Twc_l, Twc_r):
        f = jorb.extract_orb_fused(jnp.asarray(scene.render(Twc, K, wh=WH), dtype=jnp.float32), cfg)
        out.append(tuple(np.array(f[k]) for k in ("xy", "desc", "level", "valid")))
    return out


def _both(left, right, fx, baseline):
    j = jstereo.stereo_match_keypoints(*[jnp.asarray(a) for a in left + right],
                                       jnp.float32(fx), jnp.float32(baseline))
    p = tstereo.stereo_match_keypoints(*[_t(a) for a in left + right], np.float32(fx), np.float32(baseline))
    return to_np(j), to_np(p)


@pytest.mark.parametrize("frame", [0, 3, 7])
def test_stereo_match_on_the_stereo_scene_matches_jax(frame):
    """The same matched keypoints, and disparity and depth equal to float
    rounding (bound: 1 ulp of float32, i.e. rtol 2.4e-7; measured equal).
    Hundreds of keypoints match, at positive disparities."""
    left, right = _stereo_features(frame)
    (jd, jdisp, jm), (pd, pdisp, pm) = _both(left, right, K[0, 0], BASELINE)
    np.testing.assert_array_equal(pm, jm)
    assert jm.sum() > 100, int(jm.sum())
    np.testing.assert_allclose(pdisp, jdisp, rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(pd, jd, rtol=2.4e-7, atol=0)
    assert (jdisp[jm] >= 0.5).all() and (jd[~jm] == 0).all()


def _tied_keypoints(seed, n=160, m=180):
    """Random keypoints in a few rows, descriptors drawn from a small pool
    so that several right keypoints sit at the same Hamming distance."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(12, 8), dtype=np.uint64).astype(np.uint32)
    rows = rng.integers(20, 220, size=6).astype(np.float32)

    def side(k, shift):
        xy = np.stack([rng.uniform(40, 300, k), rows[rng.integers(0, 6, k)] + rng.uniform(-1.5, 1.5, k)], 1)
        xy[:, 0] -= shift
        desc = pool[rng.integers(0, len(pool), k)].copy()
        flip = rng.uniform(size=k) < 0.3  # one bit off here and there
        desc[flip, 0] ^= np.uint32(1) << rng.integers(0, 32, flip.sum()).astype(np.uint32)
        level = rng.integers(0, 4, k).astype(np.int32)
        valid = rng.uniform(size=k) < 0.95
        return xy.astype(np.float32), desc, level, valid

    return side(n, 0.0), side(m, 8.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_match_with_tied_hamming_rows_matches_jax(seed):
    """Ties in the masked Hamming rows go to the first index in both
    packages: the same matches, disparity and depth equal to float rounding
    (bound 1 ulp; measured equal). The case must hold ties and matches."""
    left, right = _tied_keypoints(seed)
    fx, b = 718.856, 0.537150588
    (jd, jdisp, jm), (pd, pdisp, pm) = _both(left, right, fx, b)
    # ties: a row whose masked minimum is taken by more than one column
    d = tmatching.hamming_matrix(_t(left[1]), _t(right[1]), _t(left[3]), _t(right[3])).numpy()
    ok = ((np.abs(left[0][:, None, 1] - right[0][None, :, 1]) <= 2.0)
          & (left[0][:, None, 0] - right[0][None, :, 0] >= 0.5)
          & (np.abs(left[2][:, None] - right[2][None, :]) <= 1))
    d = np.where(ok, d, tmatching.BIG)
    best = d.min(1)
    assert ((d == best[:, None]).sum(1)[best < 50] > 1).any()
    np.testing.assert_array_equal(pm, jm)
    assert jm.sum() > 0
    np.testing.assert_allclose(pdisp, jdisp, rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(pd, jd, rtol=2.4e-7, atol=0)


def test_stereo_depth_takes_the_float32_product_first():
    """depth = (fx * b) / disparity with fx and b rounded to float32 first,
    bit for bit, and the outputs stay on the inputs' device."""
    left, right = _stereo_features(0)
    fx, b = 718.856, 0.537150588
    (jd, _, jm), (pd, pdisp, pm) = _both(left, right, fx, b)
    want = np.where(pm, np.float32(np.float32(fx) * np.float32(b)) / np.maximum(pdisp, np.float32(1e-3)),
                    np.float32(0)).astype(np.float32)
    np.testing.assert_array_equal(pd, want)
    np.testing.assert_array_equal(pd, jd)
    out = tstereo.stereo_match_keypoints(*[_t(a) for a in left + right], np.float32(fx), np.float32(b))
    assert all(x.device.type == "cpu" for x in out) and out[0].dtype == torch.float32
