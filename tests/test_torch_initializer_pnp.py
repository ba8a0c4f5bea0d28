"""cube_slam_tpu_torch slam/initializer.py and slam/pnp.py (two-view init,
EPnP-RANSAC) against the JAX package, on the scenes of
tests/test_initializer.py and tests/test_loop_closing.py. Singular and
eigen vectors carry arbitrary signs in both packages, so the tests compare
results: success, model, pose and inliers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_initializer import K as K_INI
from test_initializer import _make_two_view
from torch_parity_utils import assert_close, to_np

from cube_slam_tpu.slam import initializer as jini
from cube_slam_tpu.slam import pnp as jpnp
from cube_slam_tpu.utils import geometry as jgeo
from cube_slam_tpu_torch.slam import initializer as tini
from cube_slam_tpu_torch.slam import pnp as tpnp

t = torch.as_tensor


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_two_view_matches_jax(planar):
    """General scene (F) and planar scene (H): the same success, model and
    good-point mask; Tcw2 within 1e-3 (measured 2.3e-5), points within
    1e-3 + 1e-4 relative (measured 6.5e-4 at depths of 4-9)."""
    X, R, tt, p1, p2 = _make_two_view(planar)
    valid = np.ones(len(p1), dtype=bool)
    valid[::11] = False
    p2 = p2.copy()
    p2[3::13] += 25.0  # a few outliers
    samples = jini.make_sample_indices(valid, n_ransac=200, seed=1)
    np.testing.assert_array_equal(samples, tini.make_sample_indices(valid, n_ransac=200, seed=1))
    args = (p1, p2, valid, K_INI, samples)
    j = {k: np.asarray(v) for k, v in jini.initialize_two_view(*[jnp.asarray(a) for a in args]).items()}
    p = {k: to_np(v) for k, v in tini.initialize_two_view(*[t(a) for a in args]).items()}
    assert bool(j["success"]) and bool(p["success"])
    assert bool(p["used_H"]) == bool(j["used_H"]) == planar
    np.testing.assert_array_equal(p["point_good"], j["point_good"])
    assert int(p["n_good"]) == int(j["n_good"])
    assert_close(p["Tcw2"], j["Tcw2"], atol=1e-3, what="Tcw2")
    good = j["point_good"]
    assert_close(p["points3d"][good], j["points3d"][good], atol=1e-3, rtol=1e-4, what="points")


def test_initialize_two_view_rejects_low_parallax():
    """A pure-rotation pair fails in both packages (the 2.5-degree gate)."""
    X, R, tt, p1, _ = _make_two_view(False)
    Xc = X @ R.T
    uv = Xc @ K_INI.T
    p2 = (uv[:, :2] / uv[:, 2:3]).astype(np.float32)
    valid = np.ones(len(p1), dtype=bool)
    samples = jini.make_sample_indices(valid, n_ransac=200, seed=4)
    args = (p1, p2, valid, K_INI, samples)
    j = jini.initialize_two_view(*[jnp.asarray(a) for a in args])
    p = tini.initialize_two_view(*[t(a) for a in args])
    assert not bool(j["success"]) and not bool(p["success"])


def test_triangulate_matches_jax():
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50), rng.uniform(4, 9, 50)], 1)
    R = np.asarray(jgeo.so3_exp(jnp.asarray([0.0, -0.1, 0.02], dtype=jnp.float32)))
    tt = np.array([0.5, 0.0, 0.1], dtype=np.float32)
    P1 = (K_INI @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
    P2 = (K_INI @ np.hstack([R, tt[:, None]])).astype(np.float32)
    p1 = X @ P1[:, :3].T + P1[:, 3]
    p2 = X @ P2[:, :3].T + P2[:, 3]
    p1 = (p1[:, :2] / p1[:, 2:]).astype(np.float32)
    p2 = (p2[:, :2] / p2[:, 2:] + rng.normal(0, 0.5, (50, 2))).astype(np.float32)
    j = np.asarray(jini.triangulate(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(p1), jnp.asarray(p2)))
    p = to_np(tini.triangulate(t(P1), t(P2), t(p1), t(p2)))
    assert_close(p, j, atol=1e-4, rtol=1e-5)


def _pnp_problem(seed=0, n=80, n_out=12):
    """tests/test_loop_closing.py::test_pnp_ransac's kind of problem."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    T = np.asarray(jgeo.se3_exp(jnp.asarray([0.05, -0.1, 0.02, 0.3, -0.1, 0.2], jnp.float32)))
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = Xc @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.3, (n, 2))
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return Xw.astype(np.float32), uv.astype(np.float32), valid, K, T


def test_pnp_ransac_matches_jax():
    """EPnP-RANSAC with the same numpy samples: pose within 1e-4 (measured
    6.9e-7), the same inlier mask; outliers rejected."""
    Xw, uv, valid, K, T = _pnp_problem()
    samples = jpnp.make_pnp_samples(valid, n_ransac=128, seed=3)
    np.testing.assert_array_equal(samples, tpnp.make_pnp_samples(valid, n_ransac=128, seed=3))
    args = (Xw, uv, valid, K, samples)
    j = to_np(jpnp.pnp_ransac(*[jnp.asarray(a) for a in args]))
    p = to_np(tpnp.pnp_ransac(*[t(a) for a in args]))
    assert_close(p[0], j[0], atol=1e-4, what="Tcw")
    np.testing.assert_array_equal(p[1], j[1])
    assert int(p[2]) == int(j[2]) and not p[1][:12].any()
    assert_close(p[0], T, atol=2e-2, what="Tcw vs truth")


def test_epnp_single_solve_matches_jax():
    """One weighted EPnP solve (the refine step): R, t within 1e-4."""
    Xw, uv, valid, K, _ = _pnp_problem(n_out=0)
    xn = np.concatenate([uv, np.ones((len(uv), 1), np.float32)], 1) @ np.linalg.inv(K).T
    xn = xn[:, :2].astype(np.float32)
    w = valid.astype(np.float32)
    Rj, tj, okj = jpnp._epnp_rt(jnp.asarray(Xw), jnp.asarray(xn), jnp.asarray(w))
    Rt, tt, okt = tpnp._epnp_rt(t(Xw)[None], t(xn)[None], t(w)[None])
    assert bool(okj) and bool(okt[0])
    assert_close(to_np(Rt[0]), np.asarray(Rj), atol=1e-4)
    assert_close(to_np(tt[0]), np.asarray(tj), atol=1e-4)


@pytest.mark.parametrize("case", ["singular", "regular"])
def test_small_solve_gives_nan_for_a_singular_system_as_jax(case):
    """The EPnP beta solves on a singular system (a degenerate RANSAC
    sample: two equal columns) give NaN as jnp.linalg.solve does, and raise
    nothing; a regular system is solved to float rounding (1e-6)."""
    if case == "singular":
        A = np.array([[3, 0, 3], [0, 1e-9, 0], [3, 0, 3]], np.float32)
        b = np.array([5e-8, 0, 5e-8], np.float32)
    else:
        A = np.array([[2, 1, 0], [1, 3, 1], [0, 1, 4]], np.float32)
        b = np.array([1, 2, 3], np.float32)
    j = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)))
    p = to_np(tpnp._solve_sym(t(A)[None], t(b)[None])[0])
    if case == "singular":
        assert np.isnan(j).all() and np.isnan(p).all()
    else:
        assert_close(p, j, atol=1e-6)


def test_pnp_ransac_dlt_matches_jax():
    """The 6-point DLT-RANSAC with the same numpy samples (k=6): the same
    inlier mask and count, Tcw within 1e-4 of JAX's; outliers rejected."""
    Xw, uv, valid, K, T = _pnp_problem(seed=1)
    samples = jpnp.make_pnp_samples(valid, n_ransac=128, seed=5, k=6)
    np.testing.assert_array_equal(samples, tpnp.make_pnp_samples(valid, n_ransac=128, seed=5, k=6))
    args = (Xw, uv, valid, K, samples)
    j = to_np(jpnp.pnp_ransac_dlt(*[jnp.asarray(a) for a in args]))
    p = to_np(tpnp.pnp_ransac_dlt(*[t(a) for a in args]))
    assert_close(p[0], j[0], atol=1e-4, what="Tcw")
    np.testing.assert_array_equal(p[1], j[1])
    assert int(p[2]) == int(j[2]) and not p[1][:12].any()
    assert_close(p[0], T, atol=2e-2, what="Tcw vs truth")


def test_dlt_batch_matches_jax_and_degenerate_samples_score_lower():
    """Each 6-point DLT on non-degenerate, outlier-free samples: R within
    1e-4 of JAX's (cuSOLVER's and LAPACK's singular vectors may
    differ in sign; the determinant fixes it). A degenerate sample (six
    collinear points) gives no more inliers than the best of 16 sound ones
    (a minimal DLT on 0.3-px noise is often far off: RANSAC's reason). t is held to
    5e-4 (measured 1.3e-4 at depths of 4-8): it is the null vector of a
    float32 12x12 system scaled by the cube root of its determinant."""
    Xw, uv, valid, K, _ = _pnp_problem(seed=2, n_out=0)
    xn = np.concatenate([uv, np.ones((len(uv), 1), np.float32)], 1) @ np.linalg.inv(K).T
    xn = xn[:, :2].astype(np.float32)
    samples = jpnp.make_pnp_samples(valid, n_ransac=16, seed=7, k=6)
    Rj, tj = jpnp._dlt_batch(jnp.asarray(Xw[samples]), jnp.asarray(xn[samples]))
    Rt, tt = tpnp._dlt_batch(t(Xw[samples]), t(xn[samples]))
    assert_close(to_np(Rt), np.asarray(Rj), atol=1e-4, what="R")
    assert_close(to_np(tt), np.asarray(tj), atol=5e-4, what="t")

    line = np.linspace(0.0, 1.0, 6, dtype=np.float32)[:, None] * np.array([1.0, 0.5, 2.0], np.float32) + Xw[0]
    Xs = np.concatenate([Xw[samples], line[None]]).astype(np.float32)
    us = np.concatenate([xn[samples], xn[samples[:1]]])
    R, tr = tpnp._dlt_batch(t(Xs), t(us))
    pc = t(Xw)[None] @ R.transpose(-1, -2) + tr[:, None, :]
    proj = (pc @ t(K).T)[..., :2] / pc[..., 2:3]
    inl = ((torch.linalg.norm(proj - t(uv)[None], dim=-1) < 5.0) & (pc[..., 2] > 0)).sum(1).numpy()
    assert inl[:-1].max() >= 0.9 * valid.sum() and inl[-1] <= inl[:-1].max()
