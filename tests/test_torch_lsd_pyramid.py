"""cube_slam_tpu_torch ops/lsd.py's EDLine flavor and octave pyramid against
the JAX package, on 320x240 renders of the box scene and on the rectangle
and circle images of tests/test_lsd.py."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lsd_lines import ENDPOINT_TOL, _frame, _match

from cube_slam_tpu.ops import lsd as jlsd
from cube_slam_tpu_torch.ops import lsd as tlsd


def _rectangle():
    img = np.zeros((120, 160), dtype=np.float32)
    img[30:90, 40:130] = 200.0
    return img


def _circle():
    yy, xx = np.mgrid[0:128, 0:128]
    return np.where(np.hypot(xx - 64, yy - 64) < 40, 200.0, 0.0).astype(np.float32)


IMAGES = {"render0": lambda: _frame(0), "render3": lambda: _frame(3), "rectangle": _rectangle, "circle": _circle}
# the circle with tests/test_lsd.py's tight bound (no long segment survives)
KWARGS = {"circle": dict(min_length=30.0, max_fit_width=1.5, max_lines=32)}


def _same_set(a, b, min_count=0):
    assert len(a) == len(b) >= min_count, (len(a), len(b))
    if len(a):
        assert _match(a, b) < ENDPOINT_TOL


@pytest.mark.parametrize("name", list(IMAGES))
def test_detect_edlines_matches_jax_as_sets(name):
    """The same valid segments (as sets, within ENDPOINT_TOL px), the zeroed
    padding and the left-to-right convention."""
    img = IMAGES[name]()
    kw = KWARGS.get(name, {})
    lj, vj = jlsd.detect_edlines(jnp.asarray(img), **kw)
    lt, vt = tlsd.detect_edlines(torch.as_tensor(img), **kw)
    a, b = np.asarray(lj)[np.asarray(vj)], lt.numpy()[vt.numpy()]
    _same_set(a, b, min_count=4 if name == "rectangle" else 0)
    assert (b[:, 0] <= b[:, 2]).all() and (lt.numpy()[~vt.numpy()] == 0).all()
    if name == "circle":  # the straightness bound rejects the curve
        assert len(b) == 0 or np.hypot(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]).max() < 45.0


@pytest.mark.parametrize("detector", ["lsd", "edline"])
@pytest.mark.parametrize("name", ["render0", "render3", "rectangle"])
def test_detect_lines_pyramid_matches_jax(name, detector):
    """Per octave: the same pyramid image bit for bit, the same count, the
    octave-pixel lines as sets within ENDPOINT_TOL and the base-pixel lines
    their 2**o multiples; octave 0 is the single-scale detector's output
    bit for bit (tests/test_lsd.py's contract)."""
    img = IMAGES[name]()
    pj = jlsd.detect_lines_pyramid(jnp.asarray(img), n_octaves=2, detector=detector, max_lines=64)
    pt = tlsd.detect_lines_pyramid(torch.as_tensor(img), n_octaves=2, detector=detector, max_lines=64)
    assert set(pt) == set(pj)
    np.testing.assert_array_equal(pt["octave"].numpy(), np.asarray(pj["octave"]))
    n_valid = []
    for o in range(2):
        sl = slice(o * 64, (o + 1) * 64)
        np.testing.assert_array_equal(pt["octave_images"][o].numpy(), np.asarray(pj["octave_images"][o]))
        vj, vt = np.asarray(pj["valid"])[sl], pt["valid"][sl].numpy()
        _same_set(np.asarray(pj["lines_octave"])[sl][vj], pt["lines_octave"][sl].numpy()[vt])
        assert torch.equal(pt["lines_base"][sl], pt["lines_octave"][sl] * 2.0 ** o)
        n_valid.append(int(vt.sum()))
    assert n_valid[0] > 0
    single = (tlsd.detect_lines if detector == "lsd" else tlsd.detect_edlines)(
        torch.as_tensor(img), min_length=15.0, max_lines=64)
    assert torch.equal(pt["lines_base"][:64], single[0]) and torch.equal(pt["valid"][:64], single[1])


# sha256 of detect_lines' (lines, valid) bytes on _frame(0) and _frame(3)
# before the EDLine width bound existed
LSD_BEFORE_EDLINE = {
    0: "8790dcbefe64e959397d0a1b78cf053e9b16b2d2e0316ef98fa564ecfebfb871",
    3: "92b0157dfce0233244a816b5f37866d9f0d629588ef59c87f2eec267a9d5d0c5",
}


@pytest.mark.parametrize("i", sorted(LSD_BEFORE_EDLINE))
def test_lsd_unchanged_by_the_width_bound(i):
    """max_abs_width=None leaves the LSD path as it was, bit for bit; an
    infinite bound selects the same segments."""
    img = torch.as_tensor(_frame(i))
    lines, valid = tlsd.detect_lines(img, min_length=15.0, max_lines=128)
    digest = hashlib.sha256(lines.numpy().tobytes() + valid.numpy().tobytes()).hexdigest()
    assert digest == LSD_BEFORE_EDLINE[i]
    gx, gy, mag, angle = tlsd._lsd_gradients(img)
    args = (mag > 5.22, angle, mag, 20, 15.0, 0.5, 0.25, 128, 32)
    open_bound = tlsd._fit_lines_from_support(*args, max_abs_width=float("inf"))
    assert torch.equal(open_bound[0], lines) and torch.equal(open_bound[1], valid)
