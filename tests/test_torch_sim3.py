"""cube_slam_tpu_torch slam/sim3.py against the JAX package on the CPU.

Tolerances: the similarities come out of a float32 3x3 SVD (LAPACK's gesdd
in torch, XLA's own SVD in JAX) and float32 sums in another order, so s, R
and t agree to ~1e-6 of their size; SIM3_TOL leaves an order of magnitude.
Inlier masks, counts and the chosen hypothesis must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import assert_close, rng, to_np

from cube_slam_tpu.slam import sim3 as js
from cube_slam_tpu_torch.slam import sim3 as ts
from cube_slam_tpu_torch.utils import geometry as tgeo

SIM3_TOL = 2e-5
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=np.float32)


def _rot(w):
    return tgeo.so3_exp(torch.tensor(w, dtype=torch.float32)).numpy()


def _pair(seed, n=60, n_out=15, noise=0.005, s=0.8):
    """Matched point sets p2 = s R p1 + t (+ noise), the first n_out rows
    gross outliers (tests/test_loop_closing.py's case, with noise)."""
    r = rng(seed)
    p1 = r.uniform(-2, 2, (n, 3)).astype(np.float32)
    R = _rot([0.1, 0.3, -0.2])
    t = np.array([1.0, 0.2, -0.5], dtype=np.float32)
    p2 = (s * p1 @ R.T + t + r.normal(0, noise, (n, 3))).astype(np.float32)
    p2[:n_out] += r.uniform(1, 3, (n_out, 3)).astype(np.float32)
    samples = np.stack([r.choice(n, 3, replace=False) for _ in range(128)]).astype(np.int32)
    return p1, p2, samples


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def _same_ransac(a, b):
    """(s, R, t, inlier, n) of both packages: equal masks and counts,
    s/R/t within SIM3_TOL."""
    a, b = to_np(a), to_np(b)
    assert np.array_equal(a[3], b[3]) and int(a[4]) == int(b[4])
    for x, y in zip(a[:3], b[:3]):
        assert_close(x, y, SIM3_TOL, rtol=SIM3_TOL)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_batched_and_weighted(fix_scale):
    r = rng(0)
    p1 = r.uniform(-2, 2, (5, 30, 3)).astype(np.float32)
    p2 = (1.7 * p1 @ _rot([0.2, -0.4, 0.6]).T + np.array([0.5, -1.0, 2.0])
          + r.normal(0, 0.01, p1.shape)).astype(np.float32)
    w = (r.uniform(size=(5, 30)) > 0.3).astype(np.float32)
    for args in ((p1, p2), (p1, p2, w)):
        a = js.horn_sim3(*_j(*args), fix_scale=fix_scale)
        b = ts.horn_sim3(*_t(*args), fix_scale=fix_scale)
        for x, y in zip(to_np(a), to_np(b)):
            assert x.shape == y.shape
            assert_close(x, y, SIM3_TOL, rtol=SIM3_TOL)
    s, R, t = to_np(ts.horn_sim3(*_t(p1[0], (1.7 * p1[0] @ _rot([0.2, -0.4, 0.6]).T).astype(np.float32))))
    assert_close(R, _rot([0.2, -0.4, 0.6]), 1e-5)
    assert_close(s, 1.7, 1e-5)


def test_median_is_jnp_median():
    """Even lengths average the two middle values (torch.median would take
    the lower one)."""
    r = rng(3)
    for n in (1, 2, 7, 60):
        x = r.uniform(size=n).astype(np.float32)
        assert float(ts._median(torch.as_tensor(x))) == float(jnp.median(jnp.asarray(x)))


@pytest.mark.parametrize("seed", [1, 2])
def test_sim3_ransac_with_outliers(seed):
    p1, p2, samples = _pair(seed)
    valid = np.ones(len(p1), dtype=bool)
    valid[-3:] = False
    a = js.sim3_ransac(*_j(p1, p2, valid, samples), jnp.float32(0.1))
    b = ts.sim3_ransac(*_t(p1, p2, valid, samples), 0.1)
    _same_ransac(a, b)
    assert not to_np(b)[3][:15].any() and int(b[4]) >= 40
    # the same hypothesis wins: both packages' per-hypothesis counts
    sj = js.horn_sim3(jnp.asarray(p1)[samples], jnp.asarray(p2)[samples])
    st = ts.horn_sim3(torch.as_tensor(p1)[samples.astype(np.int64)], torch.as_tensor(p2)[samples.astype(np.int64)])

    def counts(s, R, t):
        pred = s[:, None, None] * np.einsum("nj,sij->sni", p1, R) + t[:, None, :]
        return ((np.linalg.norm(pred - p2[None], axis=-1) < 0.1) & valid).sum(1)

    cj, ct = counts(*to_np(sj)), counts(*to_np(st))
    assert np.array_equal(cj, ct) and int(np.argmax(cj)) == int(np.argmax(ct))


def test_sim3_ransac_px_with_outliers():
    """Both-way pixel scoring on two camera views of the matched points."""
    r = rng(4)
    n = 50
    p1 = np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n), r.uniform(4, 8, n)], 1).astype(np.float32)
    s, R, t = 1.1, _rot([0.02, -0.05, 0.03]), np.array([0.1, -0.05, 0.2], dtype=np.float32)
    p2 = (s * p1 @ R.T + t).astype(np.float32)
    p2[:10] += r.uniform(0.5, 1.0, (10, 3)).astype(np.float32)
    Tcw1 = np.eye(4, dtype=np.float32)
    Tcw2 = np.eye(4, dtype=np.float32)
    Tcw2[:3, 3] = [0.1, 0.0, 0.0]

    def project(Tcw, pw):
        pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
        return ((pc @ K.T)[:, :2] / pc[:, 2:3]).astype(np.float32)

    uv1 = project(Tcw1, p1)
    uv2 = project(Tcw2, (s * p1 @ R.T + t).astype(np.float32)) + r.normal(0, 0.5, (n, 2)).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    samples = np.stack([r.choice(n, 3, replace=False) for _ in range(64)]).astype(np.int32)
    args = (p1, p2, uv1, uv2, Tcw1, Tcw2, K, valid, samples)
    a = js.sim3_ransac_px(*_j(*args))
    b = ts.sim3_ransac_px(*_t(*args))
    _same_ransac(a, b)
    assert not to_np(b)[3][:10].any() and int(b[4]) >= 30


@pytest.mark.parametrize("n,n_invalid", [(60, 0), (61, 0), (60, 5)])
def test_sim3_ransac_trimmed_with_outliers(n, n_invalid):
    """Even and odd lengths (the scene median), and invalid rows, whose
    zeros the median includes as in JAX."""
    valid = np.ones(n, dtype=bool)
    valid[len(valid) - n_invalid:] = False
    for fix_scale in (False, True):
        p1, p2, samples = _pair(5, n=n, s=1.0 if fix_scale else 0.8)
        a = js.sim3_ransac_trimmed(*_j(p1, p2, valid, samples), fix_scale=fix_scale)
        b = ts.sim3_ransac_trimmed(*_t(p1, p2, valid, samples), fix_scale=fix_scale)
        _same_ransac(a, b)
    assert not to_np(b)[3][:15].any()


def test_optimize_sim3_relative():
    """OptimizeSim3: refine a perturbed relative Sim3 from two-way
    reprojections (tests/test_loop_closing.py:144-176's case)."""
    r = rng(5)
    n = 60
    pts1 = np.stack([r.uniform(-2, 2, n), r.uniform(-1.5, 1.5, n), r.uniform(3, 8, n)], 1).astype(np.float32)
    R_true = _rot([0.05, -0.2, 0.1])
    t_true = np.array([0.4, -0.1, 0.6], dtype=np.float32)
    pts2 = (1.3 * pts1 @ R_true.T + t_true).astype(np.float32)
    uv1 = ((pts1 @ K.T)[:, :2] / (pts1 @ K.T)[:, 2:3]).astype(np.float32)
    uv2 = ((pts2 @ K.T)[:, :2] / (pts2 @ K.T)[:, 2:3]).astype(np.float32)
    uv2[:5] += 20.0  # outliers for the Huber kernel and the gate
    R0 = (R_true @ _rot([0.03, 0.02, -0.04])).astype(np.float32)
    t0 = (t_true + np.array([0.1, -0.05, 0.08])).astype(np.float32)
    valid = np.ones(n, dtype=bool)
    for fix_scale in (False, True):
        a = js.optimize_sim3_relative(jnp.asarray(1.0), *_j(R0, t0, pts1, pts2, uv1, uv2, K, valid),
                                      num_iters=15, fix_scale=fix_scale)
        b = ts.optimize_sim3_relative(1.0, *_t(R0, t0, pts1, pts2, uv1, uv2, K, valid),
                                      num_iters=15, fix_scale=fix_scale)
        a, b = to_np(a), to_np(b)
        assert np.array_equal(a[3], b[3]) and int(a[4]) == int(b[4])
        for x, y in zip(a[:3], b[:3]):
            assert_close(x, y, 1e-4, rtol=1e-4)
    assert_close(b[0], 1.0, 0)  # fix_scale keeps s
    s, R, t, inl, n_in = to_np(ts.optimize_sim3_relative(1.0, *_t(R0, t0, pts1, pts2, uv1, uv2, K, valid),
                                                         num_iters=15))
    # the five 20 px outliers still pull the Huber fit by ~0.4% of s
    assert not inl[:5].any() and n_in == n - 5
    assert_close(s, 1.3, 1e-2)


def test_sim3_apply_inverse_compose():
    r = rng(6)
    s = r.uniform(0.5, 2.0, 4).astype(np.float32)
    R = np.stack([_rot(w) for w in r.normal(0, 0.5, (4, 3))])
    t = r.normal(0, 1, (4, 3)).astype(np.float32)
    pts = r.normal(0, 2, (4, 9, 3)).astype(np.float32)
    assert_close(to_np(js.sim3_apply(*_j(s, R, t, pts))), to_np(ts.sim3_apply(*_t(s, R, t, pts))), 1e-5)
    inv_j, inv_t = js.sim3_inverse(*_j(s, R, t)), ts.sim3_inverse(*_t(s, R, t))
    for x, y in zip(to_np(inv_j), to_np(inv_t)):
        assert_close(x, y, 1e-6, rtol=1e-6)
    cj = js.sim3_compose(*_j(s, R, t), *inv_j)
    ct = ts.sim3_compose(*_t(s, R, t), *inv_t)
    for x, y in zip(to_np(cj), to_np(ct)):
        assert_close(x, y, 1e-6)
    # S o S^-1 is the identity; a Python float scale broadcasts
    assert_close(to_np(ct[0]), 1.0, 1e-6)
    assert_close(to_np(ct[1]), np.broadcast_to(np.eye(3), (4, 3, 3)), 1e-5)
    assert_close(to_np(ts.sim3_compose(2.0, *_t(R[0], t[0]), *_t(s[0], R[1], t[1]))[0]), 2.0 * s[0], 1e-6)
