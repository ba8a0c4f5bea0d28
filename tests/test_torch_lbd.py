"""cube_slam_tpu_torch ops/lbd.py (LBD descriptors, the octave pyramid's
descriptors and line matching) against the JAX package, on 320x240 renders
of the box scene. Descriptors and matches are compared on the same line
array fed to both packages (the detectors' top-k may order equal-length
segments differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lsd_lines import _frame
from torch_parity_utils import cs

from cube_slam_tpu.ops import lbd as jlbd
from cube_slam_tpu.ops import lsd as jlsd
from cube_slam_tpu_torch.ops import lbd as tlbd

# float descriptors: both packages sum the band statistics in their own
# order (measured 4.3e-7 on these frames)
FDESC_TOL = cs.FDESC_TOL


def _lines(img, max_lines=128):
    lines, valid = jlsd.detect_lines(jnp.asarray(img), min_length=15.0, max_lines=max_lines)
    return np.asarray(lines), np.asarray(valid)


def _both(img, lines, valid):
    fj, bj = jlbd.lbd_descriptors(jnp.asarray(img), jnp.asarray(lines), jnp.asarray(valid))
    ft, bt = tlbd.lbd_descriptors(torch.as_tensor(img), torch.as_tensor(lines), torch.as_tensor(valid))
    return np.asarray(fj), np.asarray(bj).view(np.int32), ft.numpy(), bt.numpy()


def test_tables_are_jax_bit_for_bit():
    """The comparison pairs and the sample grid along the line."""
    np.testing.assert_array_equal(tlbd._PAIR_A, jlbd._PAIR_A)
    np.testing.assert_array_equal(tlbd._PAIR_B, jlbd._PAIR_B)
    np.testing.assert_array_equal(tlbd._SAMPLES, np.asarray(jnp.linspace(0.0, 1.0, tlbd.N_SAMPLES)))


@pytest.mark.parametrize("i", [0, 3])
def test_lbd_descriptors_match_jax(i):
    """fdesc within FDESC_TOL; a bit may differ only where its two compared
    entries lie within FDESC_TOL of each other (a near-tie); the words hold
    JAX's uint32 bits, bit 31 included; the valid mask zeroes both."""
    img = _frame(i)
    lines, valid = _lines(img)
    valid = valid.copy()
    valid[1] = False  # a masked real line
    fj, bj, ft, bt = _both(img, lines, valid)
    assert valid.sum() > 10
    np.testing.assert_allclose(ft, fj, atol=FDESC_TOL, rtol=0)
    near_tie = np.abs(fj[:, tlbd._PAIR_A] - fj[:, tlbd._PAIR_B]) <= FDESC_TOL
    flipped = cs._bits(bt) != cs._bits(bj)
    assert not (flipped & ~near_tie).any()
    assert (bj[:, :] < 0).any() and np.array_equal(bt < 0, bj < 0)  # bit 31 set in both
    assert not ft[~valid].any() and not bt[~valid].any()
    np.testing.assert_allclose(np.linalg.norm(ft[valid], axis=1), 1.0, atol=1e-5)


def test_lbd_shape_and_masking():
    """tests/test_lbd.py's shape/mask case through both packages."""
    img = np.random.default_rng(0).uniform(0, 255, (64, 96)).astype(np.float32)
    lines = np.array([[10.0, 10.0, 50.0, 12.0], [0.0, 0.0, 0.0, 0.0]], np.float32)
    valid = np.array([True, False])
    fj, bj, ft, bt = _both(img, lines, valid)
    assert ft.shape == (2, 72) and bt.shape == (2, 8) and bt.dtype == np.int32
    assert not ft[1].any() and not bt[1].any()
    np.testing.assert_allclose(ft, fj, atol=FDESC_TOL, rtol=0)
    np.testing.assert_array_equal(bt, bj)


def test_match_lines_on_jax_words():
    """On JAX's own words (frames 0 and 1), the same match indices and
    Hamming distances."""
    d = []
    for i in (0, 1):
        img = _frame(i)
        lines, valid = _lines(img)
        fj, bj = jlbd.lbd_descriptors(jnp.asarray(img), jnp.asarray(lines), jnp.asarray(valid))
        d.append((np.asarray(bj), valid))
    (b1, v1), (b2, v2) = d
    mj, dj = jlbd.match_lines(jnp.asarray(b1), jnp.asarray(v1), jnp.asarray(b2), jnp.asarray(v2))
    mt, dt = tlbd.match_lines(*[torch.as_tensor(x) for x in (b1.view(np.int32), v1, b2.view(np.int32), v2)])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert (mt.numpy() >= 0).sum() >= 5


def _shift_contract(d1, d2, m):
    """tests/test_lsd.py's cross-octave contract on a (2, 3)-px roll: at
    least 8 matches, over 60% of them moved by (3, 2) within 12 px."""
    v1 = np.asarray(d1["valid"])
    matched = np.where((m >= 0) & v1)[0]
    L1, L2 = np.asarray(d1["lines"]), np.asarray(d2["lines"])
    mid = lambda L: (L[:, :2] + L[:, 2:]) / 2  # noqa: E731
    good = np.linalg.norm(mid(L2[m[matched]]) - mid(L1[matched]) - np.array([3.0, 2.0]), axis=1) < 12.0
    return len(matched), float(good.mean()) if len(matched) else 0.0


def test_describe_pyramid_cross_octave_match_in_both():
    """describe_lines_pyramid + match_lines on a render and its shift: the
    same contract holds in both packages, with the same valid lines per
    octave, and the port's descriptors of its own lines are finite and
    unit-norm."""
    img = _frame(1)
    img2 = np.roll(img, shift=(2, 3), axis=(0, 1))
    out = {}
    for name, lbd, arr in (("jax", jlbd, jnp.asarray), ("torch", tlbd, torch.as_tensor)):
        d1 = lbd.describe_lines_pyramid(arr(img), n_octaves=2, max_lines=64, min_pixels=15)
        d2 = lbd.describe_lines_pyramid(arr(img2), n_octaves=2, max_lines=64, min_pixels=15)
        m, _ = lbd.match_lines(d1["bdesc"], d1["valid"], d2["bdesc"], d2["valid"])
        d1 = {k: np.asarray(v) if name == "jax" else v.numpy() for k, v in d1.items()}
        d2 = {k: np.asarray(v) if name == "jax" else v.numpy() for k, v in d2.items()}
        n, share = _shift_contract(d1, d2, np.asarray(m) if name == "jax" else m.numpy())
        assert n >= 8 and share > 0.6, (name, n, share)
        out[name] = d1
    for o in range(2):
        sel = lambda d: d["valid"] & (d["octave"] == o)  # noqa: E731
        assert sel(out["jax"]).sum() == sel(out["torch"]).sum() > 0
    v = out["torch"]["valid"]
    np.testing.assert_allclose(np.linalg.norm(out["torch"]["fdesc"][v], axis=1), 1.0, atol=1e-5)
    assert out["torch"]["bdesc"].dtype == np.int32
