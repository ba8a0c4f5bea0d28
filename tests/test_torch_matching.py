"""cube_slam_tpu_torch ops/matching.py against the JAX package. Every output
is an integer or a mask, so every comparison is exact — including the
tie-heavy cases, where argmin's first index and the stable top-k decide."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import rng

from cube_slam_tpu.ops import matching as jm
from cube_slam_tpu_torch.ops import matching as tm

t = torch.as_tensor


def _descs(seed, n_a=300, n_b=250):
    """uint32 descriptor words with near-duplicates, sign bits set (the
    words are int32 in the port) and invalid rows/cols."""
    r = rng(seed)
    a = r.integers(0, 2**32, (n_a, 8), dtype=np.uint64).astype(np.uint32)
    b = a[r.permutation(n_a)[:n_b]].copy()
    flips = (r.uniform(size=b.shape + (32,)) < 0.05) << np.arange(32, dtype=np.uint64)
    b ^= flips.sum(-1).astype(np.uint32)
    b[::3] ^= np.uint32(0x80000001)
    va = r.uniform(size=n_a) < 0.9
    vb = r.uniform(size=n_b) < 0.9
    return a, b, va, vb


def _i32(x):
    return t(np.ascontiguousarray(x).view(np.int32))


def test_hamming_matrix_exact():
    a, b, va, vb = _descs(0)
    for valid in ((None, None), (va, vb)):
        j = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b),
                                         *[None if v is None else jnp.asarray(v) for v in valid]))
        p = tm.hamming_matrix(_i32(a), _i32(b), *[None if v is None else t(v) for v in valid]).numpy()
        np.testing.assert_array_equal(p, j)
    # batched over a leading dim of the second set
    p2 = tm.hamming_matrix(_i32(a), _i32(np.stack([b, b[::-1]])), t(va), t(np.stack([vb, vb[::-1]])))
    j2 = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b[::-1]), jnp.asarray(va),
                                      jnp.asarray(vb[::-1])))
    np.testing.assert_array_equal(p2[1].numpy(), j2)


def test_popcount_extremes():
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xAAAAAAAA], dtype=np.uint32)
    expect = [bin(int(v)).count("1") for v in w]
    np.testing.assert_array_equal(tm.popcount32(_i32(w)).numpy(), expect)


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("case", ["ties", "descriptors"])
def test_match_mutual_ratio_exact(mutual, case):
    if case == "ties":
        # small integer distances: row best/second and column minima tie
        d = rng(1).integers(0, 100, (200, 40)).astype(np.int32)
        d[rng(2).uniform(size=d.shape) < 0.3] = jm.BIG
        d[:, 7] = jm.BIG  # an invalid column
        d[11] = jm.BIG    # an invalid row
        kw = dict(max_dist=30, ratio=1.5)
    else:
        a, b, va, vb = _descs(3)
        d = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb)))
        kw = dict(max_dist=jm.TH_HIGH, ratio=0.9)
    j = jm.match_mutual_ratio(jnp.asarray(d), mutual=mutual, **kw)
    p = tm.match_mutual_ratio(t(d), mutual=mutual, **kw)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert (p[0].numpy() >= 0).sum() > 10
    if case == "ties":
        assert p[0][11] == -1 and not (p[0] == 7).any()


def test_rotation_consistency_exact():
    r = rng(4)
    ang_a = r.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ang_b = r.uniform(-np.pi, np.pi, 250).astype(np.float32)
    m = r.integers(-1, 250, 300).astype(np.int32)
    # a dominant rotation so bins 2 and 3 face the 0.1x gate
    m[:150] = np.arange(150)
    ang_b[:150] = ang_a[:150] - 0.3 + r.normal(0, 0.05, 150).astype(np.float32)
    j = np.asarray(jm.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), jnp.asarray(m)))
    p = tm.rotation_consistency(t(ang_a), t(ang_b), t(m)).numpy()
    np.testing.assert_array_equal(p, j)
    assert 100 < (p >= 0).sum() < (m >= 0).sum()
    # tied bin counts: top-k keeps the lower bin, as lax.top_k
    m2 = np.arange(60, dtype=np.int32)
    ang2 = (np.repeat(np.arange(6), 10) * (2 * np.pi / 30) + 0.01).astype(np.float32)
    j = np.asarray(jm.rotation_consistency(jnp.zeros(60), jnp.asarray(-ang2), jnp.asarray(m2)))
    p = tm.rotation_consistency(torch.zeros(60), t(-ang2), t(m2)).numpy()
    np.testing.assert_array_equal(p, j)


def test_window_mask_and_search_by_projection_exact():
    r = rng(5)
    a, b, va, vb = _descs(6, 200, 180)
    xa = r.uniform(0, 100, (200, 2)).astype(np.float32)
    xb = np.concatenate([xa[:120] + r.normal(0, 2, (120, 2)), r.uniform(0, 100, (60, 2))]).astype(np.float32)
    b[:120] = a[:120]
    la = r.integers(0, 4, 200).astype(np.int32)
    lb = r.integers(0, 4, 180).astype(np.int32)
    radius = r.uniform(3, 20, 200).astype(np.float32)
    for rad_j, rad_t in ((jnp.asarray(radius), t(radius)), (7.5, 7.5)):
        j = np.asarray(jm.window_mask(jnp.asarray(xa), jnp.asarray(xb), rad_j, jnp.asarray(la), jnp.asarray(lb)))
        p = tm.window_mask(t(xa), t(xb), rad_t, t(la), t(lb)).numpy()
        np.testing.assert_array_equal(p, j)
    args = (xa, va, a, la, xb, b, lb, vb)
    j = jm.search_by_projection(*[jnp.asarray(x) for x in args], radius=10.0)
    p = tm.search_by_projection(*[_i32(x) if x.dtype == np.uint32 else t(x) for x in args], radius=10.0)
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(j[1]))
    assert (p[0].numpy() >= 0).sum() > 50
