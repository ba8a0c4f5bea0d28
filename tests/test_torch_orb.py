"""cube_slam_tpu_torch ops/orb.py and the blur / resize / crop ops of
ops/image.py that feed it, against the JAX package on a 320x240 render of
the tracker's test scene."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_close, rng, to_np

from cube_slam_tpu.ops import image as jim
from cube_slam_tpu.ops import orb as jorb
from cube_slam_tpu_torch.ops import image as tim
from cube_slam_tpu_torch.ops import orb as torb
from cube_slam_tpu_torch.utils import synth

K_TRACK = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)


def _frame(i=3):
    """Frame i of the tracker gate's sequence: RoomScene(seed=2) along
    camera_path(14), 320x240, uint8 grey levels (as float32)."""
    poses = synth.camera_path(14)
    img = synth.RoomScene(seed=2).render(poses[i], K_TRACK, wh=(320, 240))
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("sigma,radius", [(0.8, 2), (2.0, 3)])
def test_gaussian_blur_bit_identical(sigma, radius):
    """The two blurs of the pyramid sum their taps in JAX's order: equal."""
    img = _frame()
    j = np.asarray(jim.gaussian_blur(jnp.asarray(img), sigma, radius))
    t = tim.gaussian_blur(torch.as_tensor(img), sigma, radius).numpy()
    np.testing.assert_array_equal(t, j)


def test_pyr_down_and_crop():
    img = _frame()
    np.testing.assert_array_equal(tim.pyr_down(torch.as_tensor(img)).numpy(),
                                  np.asarray(jim.pyr_down(jnp.asarray(img))))
    for y0, x0, h, w in ((230, 5, 64, 64), (-4, 300, 40, 50), (3, 5, 300, 64)):
        cj, mj = jim.extract_crop(jnp.asarray(img), jnp.int32(y0), jnp.int32(x0), h, w)
        ct, mt = tim.extract_crop(torch.as_tensor(img), y0, x0, h, w)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_canny_one_call_with_valid_mask():
    img = _frame()
    vm = np.zeros(img.shape, dtype=bool)
    vm[10:200, 20:300] = True
    for mask in (None, vm):
        j = np.asarray(jim.canny(jnp.asarray(img), valid_mask=None if mask is None else jnp.asarray(mask)))
        t = tim.canny(torch.as_tensor(img), valid_mask=None if mask is None else torch.as_tensor(mask)).numpy()
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("hw", [(200, 267), (167, 222), (139, 185)])
def test_resize_linear_matches_jax(hw):
    """jax.image.resize(method="linear"): the weight matrices are JAX's
    exactly; the products sum in another order (measured max gap 6.1e-4 /
    1.6e-3 grey levels of 255 on chained levels)."""
    img = tim.gaussian_blur(torch.as_tensor(_frame()), 0.8, 2).numpy()
    j = np.asarray(jax.image.resize(jnp.asarray(img), hw, method="linear"))
    t = tim.resize_linear(torch.as_tensor(img), hw).numpy()
    assert_close(t, j, atol=2e-3)


def test_fast_and_detect_level_exact():
    img = _frame()
    np.testing.assert_array_equal(torb.fast_corner_score(torch.as_tensor(img)).numpy(),
                                  np.asarray(jorb.fast_corner_score(jnp.asarray(img))))
    hj, sj = jorb.fast_score(jnp.asarray(img), 20.0)
    ht, st = torb.fast_score(torch.as_tensor(img), 20.0)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # integer-valued scores tie everywhere: the stable top-k keeps JAX's order
    for max_kp in (50, 300, 2000):
        j = to_np(jorb.detect_level(jnp.asarray(img), max_kp))
        t = to_np(torb.detect_level(torch.as_tensor(img), max_kp))
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_top_k_stable_ties_like_lax():
    x = rng(0).integers(0, 5, (3, 400)).astype(np.float32)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 57)
    vt, it = torb.top_k_stable(torch.as_tensor(x), 57)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def _keypoints(img):
    xy, _, valid = torb.detect_level(torch.as_tensor(img), 300)
    return xy, valid


def test_ic_angle_close():
    """Intensity-centroid angles within 1e-5 rad (measured 2.4e-7): the
    31x31 moment sums reduce in another order."""
    img = _frame()
    xy, valid = _keypoints(img)
    j = np.asarray(jorb.ic_angle(jnp.asarray(img), jnp.asarray(xy.numpy()), jnp.asarray(valid.numpy())))
    t = torb.ic_angle(torch.as_tensor(img), xy, valid).numpy()
    assert_close(t, j, atol=1e-5)


def test_brief_bit_exact_on_same_angles():
    """Given the same angles, the rotated pattern rounds to the same pixels:
    the descriptors are bit-identical (measured 0 of 76,800 bits)."""
    img = _frame()
    xy, valid = _keypoints(img)
    blurred = np.array(jim.gaussian_blur(jnp.asarray(img), 2.0, 3))
    ang = np.asarray(jorb.ic_angle(jnp.asarray(img), jnp.asarray(xy.numpy()), jnp.asarray(valid.numpy())))
    dj = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(xy.numpy()),
                                           jnp.asarray(ang), jnp.asarray(valid.numpy())))
    dt = torb.brief_descriptors(torch.as_tensor(blurred), xy, torch.as_tensor(ang), valid)
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy().view(np.uint32), dj)
    np.testing.assert_array_equal(torb._BRIEF_PATTERN, jorb._BRIEF_PATTERN)


def _bit_diff(a, b):
    return int(np.unpackbits((a ^ b).view(np.uint8)).sum())


@pytest.mark.parametrize("frame", [3, 9])
def test_extract_orb_matches_jax(frame):
    """extract_orb at 600 features x 3 levels. Level 0 is exact. Higher
    levels start from the resize, whose sums differ in the last bits, so
    keypoints may differ there (measured: none on these frames; bound 3 per
    level), angles by an ulp-driven amount (measured 6.5e-5 rad; bound
    1e-3), and descriptor bits flip where a rotated sample sits at .5 or
    two blurred values nearly tie (measured 1 bit; bound 0.1% of bits)."""
    img = _frame(frame)
    cfg_j = jorb.OrbPyramidConfig(600, n_levels=3)
    cfg_t = torb.OrbPyramidConfig(600, n_levels=3)
    assert cfg_t.per_level == cfg_j.per_level
    j = {k: np.asarray(v) for k, v in jorb.extract_orb_fused(jnp.asarray(img), cfg_j).items()}
    t = {k: to_np(v) for k, v in torb.extract_orb_fused(torch.as_tensor(img), cfg_t).items()}
    lvl = j["level"]
    np.testing.assert_array_equal(t["level"], lvl)
    dj, dt = j["desc"], t["desc"].view(np.uint32)
    for level in range(3):
        s = lvl == level
        same = np.all(t["xy"][s] == j["xy"][s], axis=1) & (t["valid"][s] == j["valid"][s])
        if level == 0:
            assert same.all()
            np.testing.assert_array_equal(t["score"][s], j["score"][s])
            np.testing.assert_array_equal(dt[s], dj[s])
            assert_close(t["angle"][s], j["angle"][s], atol=1e-5)
            continue
        assert (~same).sum() <= 3, f"level {level}: {(~same).sum()} keypoints differ"
        sel = np.where(s)[0][same]
        assert_close(t["angle"][sel], j["angle"][sel], atol=1e-3)
        assert _bit_diff(dt[sel], dj[sel]) <= 0.001 * 256 * len(sel)
    plain = {k: to_np(v) for k, v in torb.extract_orb(torch.as_tensor(img), cfg_t).items()}
    assert sorted(plain) == sorted(k for k in t if k != "packed")
    for k, v in plain.items():
        np.testing.assert_array_equal(v, t[k])
    # the packed bundle carries the same fields, descriptor bits included
    np.testing.assert_array_equal(t["packed"][:, 5:].copy().view(np.int32),
                                  t["desc"])
    assert_close(t["packed"][:, :5], j["packed"][:, :5], atol=1e-3)
