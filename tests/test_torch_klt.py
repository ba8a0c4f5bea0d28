"""ops/klt.py of cube_slam_tpu_torch (pyramidal LK, Harris corners) against
the JAX package on the CPU, on the same numpy inputs.

tests/test_klt.py reads the detector fixture, which is absent here; these
tests use the squares image of its Harris test and 320x240 renders of the
room scene (utils/synth.py). Harris' response is a 3x3 Sobel and 5-tap
blurs summed in the JAX package's order, and the per-cell maximum keeps
every pixel that ties it; the corners must be the same pixels in the same
order (on the symmetric squares image, where corners tie, the same set).
LK's 21x21 window sums are torch reductions in another order than XLA's,
so tracks are held in pixels: TRACK_TOL per point."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_utils as tpu

from cube_slam_tpu.ops import klt as jklt
from cube_slam_tpu_torch.ops import klt as tklt

K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
WH = (320, 240)
# LK tracks, port against JAX (pixels, per point); measured <= 3.1e-5 on the
# shift and the moving box (the sums' order)
TRACK_TOL = tpu.cs.KLT_TRACK_TOL


def _squares():
    img = np.full((96, 96), 20.0, dtype=np.float32)
    img[30:50, 30:50] = 200.0
    return img


def _moving_box(dx=0.12):
    """Two renders of the room scene's box moved by dx m along world +x,
    one camera; with the second frame's instance mask."""
    from cube_slam_tpu_torch.utils import synth

    half = np.array([0.5, 0.35, 0.35])
    scene = synth.RoomScene(seed=3, box_center=[-1.0, 3.5, 0.35], box_half=half)
    Twc = synth.camera_path(40)[0]
    out = []
    for c in (-1.0, -1.0 + dx):
        scene.set_box_pose(np.array([c, 3.5, 0.35]), yaw=0.0)
        img, mask = scene.render(Twc, K, wh=WH, return_mask=True)
        out.append((img.astype(np.float32), mask, scene.box_bbox_2d(Twc, K, wh=WH)))
    return out


def _harris_both(img, mask=None, **kw):
    j = jklt.harris_corners(jnp.asarray(img), mask=None if mask is None else jnp.asarray(mask), **kw)
    t = tklt.harris_corners(torch.as_tensor(img), mask=None if mask is None else torch.as_tensor(mask), **kw)
    return tpu.to_np(j), tpu.to_np(t)


@pytest.mark.parametrize("case", ["squares", "masked_room", "room"])
def test_harris_corners_same_pixels(case):
    """The same corners, valid flags and order as the JAX package (exact:
    corners are integer pixels)."""
    if case == "squares":
        (jxy, jv), (txy, tv) = _harris_both(_squares(), max_corners=16, min_dist=5)
        assert jv.sum() >= 4
    else:
        img, mask, _ = _moving_box()[0]
        (jxy, jv), (txy, tv) = _harris_both(img, mask=None if case == "room" else mask, max_corners=48)
        assert jv.sum() >= 10
        if case == "masked_room":
            assert mask[txy[tv][:, 1].astype(int), txy[tv][:, 0].astype(int)].all()
    assert np.array_equal(tv, jv)
    if case == "squares":
        # the square is symmetric: its mirrored corners tie in exact
        # arithmetic, and XLA's fused blur breaks the ties in other last
        # bits than torch's (unjitted, the JAX response equals the port's
        # bit for bit), so the tied corners come in another order
        assert np.array_equal(np.unique(txy[tv], axis=0), np.unique(jxy[jv], axis=0))
    else:
        assert np.array_equal(txy[tv], jxy[jv])


def test_harris_max_corners_varies():
    """max_corners is the call's (the manager asks for len(free) corners):
    each length gives the JAX package's prefix."""
    img, mask, _ = _moving_box()[0]
    for n in (1, 7, 33):
        (jxy, jv), (txy, tv) = _harris_both(img, mask=mask, max_corners=n)
        assert txy.shape == (n, 2) and np.array_equal(tv, jv) and np.array_equal(txy[tv], jxy[jv])


def _lk_both(img0, img1, pts, valid, **kw):
    j = jklt.pyr_lk(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts), jnp.asarray(valid), **kw)
    t = tklt.pyr_lk(torch.as_tensor(img0), torch.as_tensor(img1), torch.tensor(pts), torch.tensor(valid), **kw)
    return tpu.to_np(j), tpu.to_np(t)


def test_pyr_lk_on_a_shift():
    """A render shifted by (6, 4) px: the same status, tracks within
    TRACK_TOL of JAX's, and both on the shift."""
    from cube_slam_tpu_torch.utils import synth

    scene = synth.RoomScene(seed=2)
    img0 = scene.render(synth.camera_path(14)[3], K, wh=WH).astype(np.float32)
    img1 = np.roll(np.roll(img0, 4, axis=0), 6, axis=1)
    (jxy, jv), _ = _harris_both(img0, max_corners=64)
    xy = jxy[jv]
    keep = (xy[:, 0] > 30) & (xy[:, 0] < 290) & (xy[:, 1] > 30) & (xy[:, 1] < 210)
    xy = xy[keep][:32].astype(np.float32)
    valid = np.ones(len(xy), dtype=bool)
    valid[-1] = False
    (jp, js), (tp, ts) = _lk_both(img0, img1, xy, valid)
    assert np.array_equal(ts, js) and not ts[-1]
    assert np.abs(tp - jp).max() <= TRACK_TOL, np.abs(tp - jp).max()
    assert ts.sum() >= 0.6 * len(xy)
    assert np.median(np.abs(tp[ts] - xy[ts] - [6.0, 4.0])) < 0.5


@pytest.mark.parametrize("seeded", [False, True])
def test_pyr_lk_on_a_moving_box(seeded):
    """Harris corners on the box tracked into the next frame, with and
    without the projected-centre flow as init_flow (as the manager seeds
    it) and a mean-abs-error gate tighter than the default; then the
    backward pass from the forward tracks: the same status and tracks
    within TRACK_TOL."""
    (img0, mask0, bb0), (img1, _, bb1) = _moving_box()
    (jxy, jv), _ = _harris_both(img0, mask=mask0, max_corners=48)
    guess = ((bb1[:2] + bb1[2:] / 2.0) - (bb0[:2] + bb0[2:] / 2.0)).astype(np.float32) if seeded \
        else np.zeros(2, np.float32)
    init = np.broadcast_to(guess, (48, 2)).copy()
    (jp, js), (tp, ts) = _lk_both(img0, img1, jxy, jv, init_flow=init, max_err=45.0)
    assert np.array_equal(ts, js) and ts.sum() >= 10
    assert np.abs(tp - jp).max() <= TRACK_TOL
    (jb, jbs), (tb, tbs) = _lk_both(img1, img0, jp, js, init_flow=-init, max_err=45.0)
    assert np.array_equal(tbs, jbs)
    assert np.abs(tb - jb).max() <= TRACK_TOL


def test_gather_patch_bit_for_bit():
    """The bilinear patch at float centres near and past the borders sums
    in the JAX package's order: equal bit for bit."""
    r = tpu.rng(0)
    img = r.uniform(0, 255, (40, 50)).astype(np.float32)
    cx = r.uniform(-5, 55, 16).astype(np.float32)
    cy = r.uniform(-5, 45, 16).astype(np.float32)
    import jax

    j = np.array(jax.vmap(lambda x, y: jklt._gather_patch(jnp.asarray(img), x, y, 3))(jnp.asarray(cx),
                                                                                     jnp.asarray(cy)))
    t = tklt._gather_patch(torch.as_tensor(img), torch.as_tensor(cx), torch.as_tensor(cy), 3).numpy()
    assert np.array_equal(t, j)
