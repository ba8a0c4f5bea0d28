"""cube_slam_tpu_torch graph/ba.py (pose-only LM, Schur local BA) against
the JAX package on the problems of tests/test_ba.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ba import K as K_BA
from test_ba import _scene
from torch.func import jacfwd
from torch_parity_utils import assert_close, to_np

from cube_slam_tpu.graph import ba as jba
from cube_slam_tpu.utils import geometry as jgeo
from cube_slam_tpu_torch.graph import ba as tba
from cube_slam_tpu_torch.utils import geometry as tgeo

t = torch.as_tensor


def _pose_problem(n_out=5, seed=1):
    tcw, pts, okf, opt, ouv = _scene(n_kf=1)
    sel = okf == 0
    uv = ouv[sel].astype(np.float32)
    pw = pts[opt[sel]]
    rng = np.random.default_rng(seed)
    T0 = np.asarray(jgeo.se3_exp(jnp.asarray(0.1 * rng.normal(size=6), dtype=jnp.float32))) @ tcw[0]
    uv[:n_out] += 80.0
    si = (1.0 / 1.2 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    return T0.astype(np.float32), pw, uv, si, np.ones(len(uv), dtype=bool)


def test_pose_jacobian_closed_form_equals_jacfwd():
    """The closed-form 2x6 Jacobian equals torch.func.jacfwd of the JAX
    package's residual (se3_exp(dx) @ Tcw, Huber weight frozen) to float
    rounding (measured max gap 1.5e-5 on entries up to ~160; bound 5e-7 of
    the largest entry)."""
    T0, pw, uv, si, valid = _pose_problem()
    K = t(K_BA)
    active = t(valid).float()
    r, J = tba.pose_residual_jacobian(t(T0), K, t(pw), t(uv), t(si), active)

    def residual(dx):
        uvp, _ = tba.project(tgeo.se3_exp(dx) @ t(T0), K, t(pw))
        rr = (uvp - t(uv)) * t(si)[:, None]
        chi2 = torch.sum(rr * rr, dim=-1)
        w = tba.huber_weight(chi2).detach()[:, None]
        return (rr * w * active[:, None]).reshape(-1)

    J_ad = jacfwd(residual)(torch.zeros(6))
    assert_close(r.reshape(-1), residual(torch.zeros(6)), atol=0.0)
    scale = float(J_ad.abs().max())
    assert_close(J.reshape(-1, 6), J_ad, atol=5e-7 * scale, what="pose Jacobian")


def test_pose_optimization_matches_jax():
    """Pose within 1e-4 of JAX (measured 6.7e-7) and the same inlier mask."""
    T0, pw, uv, si, valid = _pose_problem()
    j = to_np(jba.pose_optimization(jnp.asarray(T0), jnp.asarray(K_BA), jnp.asarray(pw),
                                    jnp.asarray(uv), jnp.asarray(si), jnp.asarray(valid)))
    p = to_np(tba.pose_optimization(t(T0), t(K_BA), t(pw), t(uv), t(si), t(valid)))
    assert_close(p[0], j[0], atol=1e-4, what="Tcw")
    np.testing.assert_array_equal(p[1], j[1])
    assert int(p[2]) == int(j[2]) and not p[1][:5].any()


@pytest.mark.parametrize("seed", [1, 2])
def test_pose_optimization_linearizes_once_per_round_as_jax(seed):
    """One round from a start 0.1 off in each tangent coordinate, no
    outliers and exact measurements: the JAX package's round linearizes
    once, at its first pose (its residual closes over that pose), so its ten
    damped steps stop 0.02-0.03 short of the true pose, where an LM that
    relinearizes converges. The port within 1e-4 of JAX (measured 1.3e-6 /
    3.2e-6), JAX at least 0.01 from the truth, the same inlier count."""
    tcw, pts, okf, opt, ouv = _scene(n_kf=1)
    sel = okf == 0
    uv, pw = ouv[sel].astype(np.float32), pts[opt[sel]]
    rng = np.random.default_rng(seed)
    T0 = (np.asarray(jgeo.se3_exp(jnp.asarray(0.1 * rng.normal(size=6), dtype=jnp.float32))) @ tcw[0])
    si = (1.0 / 1.2 ** rng.integers(0, 3, len(uv))).astype(np.float32)
    args = (T0.astype(np.float32), K_BA, pw, uv, si, np.ones(len(uv), dtype=bool))
    j = to_np(jba.pose_optimization(*[jnp.asarray(a) for a in args], num_rounds=1))
    p = to_np(tba.pose_optimization(*[t(a) for a in args], num_rounds=1))
    assert np.abs(j[0] - tcw[0]).max() >= 0.01
    assert_close(p[0], j[0], atol=1e-4, what="Tcw")
    assert int(p[2]) == int(j[2]) == len(uv)


def test_pose_optimization_batched_seeds_match_single():
    """Two seeds as a leading batch give each seed's single solve."""
    T0, pw, uv, si, valid = _pose_problem()
    T1 = T0.copy()
    T1[:3, 3] += 0.05
    Tb, ib, nb = tba.pose_optimization(t(np.stack([T0, T1])), t(K_BA), t(pw), t(uv), t(si), t(valid))
    for k, T in enumerate((T0, T1)):
        Ts, is_, ns = tba.pose_optimization(t(T), t(K_BA), t(pw), t(uv), t(si), t(valid))
        assert_close(Tb[k], Ts, atol=1e-6)
        assert torch.equal(ib[k], is_) and int(nb[k]) == int(ns)


def _unique_edges_problem():
    """One observation per (kf, point): the window branch is exact for it."""
    kf_tcw, pts, okf, opt, ouv = _scene()
    E = len(okf)
    rng = np.random.default_rng(3)
    pts0 = pts + 0.05 * rng.normal(size=pts.shape).astype(np.float32)
    n_kf = len(kf_tcw)
    return (kf_tcw, pts0, K_BA, okf.astype(np.int32), opt.astype(np.int32),
            ouv.astype(np.float32), np.ones(E, np.float32), np.ones(E, bool),
            np.array([True, True] + [False] * (n_kf - 2)), np.ones(len(pts), bool))


@pytest.mark.parametrize("branch", ["dense", "pairs", "window"])
def test_local_ba_points_branch_matches_jax(branch):
    """Each reduced-camera branch against the same JAX branch: poses and
    points within 1e-3 (measured <= 1.6e-5), cost within 1e-3 relative, the
    same inlier mask; the cost falls to ~1e-7, within 1e-5)."""
    args = _unique_edges_problem()
    kw_j, kw_t = {}, {}
    if branch == "pairs":
        e1, e2 = jba.make_schur_pairs(args[4], args[7])
        kw_j = dict(pair_e1=jnp.asarray(e1), pair_e2=jnp.asarray(e2))
        kw_t = dict(pair_e1=t(e1), pair_e2=t(e2))
    elif branch == "window":
        kw_j = kw_t = dict(schur_window=len(args[0]))
    j = to_np(jba.local_ba_points(*[jnp.asarray(a) for a in args], num_iters=6, **kw_j))
    p = to_np(tba.local_ba_points(*[t(a) for a in args], num_iters=6, **kw_t))
    assert_close(p[0], j[0], atol=1e-3, what="kf_tcw")
    assert_close(p[1], j[1], atol=1e-3, what="pts")
    assert_close(p[2], j[2], atol=1e-5, what="cost")
    np.testing.assert_array_equal(p[3], j[3])


def test_local_ba_points_branches_agree():
    """The three branches give one answer in the port (one LM step: within
    1e-5; six steps: within 2e-3, as tests/test_ba.py holds JAX's)."""
    args = [t(a) for a in _unique_edges_problem()]
    e1, e2 = tba.make_schur_pairs(args[4].numpy(), args[7].numpy())
    for iters, tol in ((1, 1e-5), (6, 2e-3)):
        d = tba.local_ba_points(*args, num_iters=iters)
        s = tba.local_ba_points(*args, pair_e1=t(e1), pair_e2=t(e2), num_iters=iters)
        w = tba.local_ba_points(*args, schur_window=len(args[0]), num_iters=iters)
        for other in (s, w):
            assert_close(other[0], d[0], atol=tol)
            assert_close(other[1], d[1], atol=tol)


@pytest.mark.parametrize("branch", ["dense", "pairs"])
def test_local_ba_points_depth_rows_and_invalid_edges(branch):
    """Depth rows on a third of the edges, and every seventh edge invalid
    (the RGBD channel and padding): within 1e-3 of JAX (measured 2.3e-5),
    the same inlier mask."""
    args = list(_unique_edges_problem())
    E = len(args[3])
    rng = np.random.default_rng(11)
    kf_tcw, pts = args[0], args[1]
    T_e = kf_tcw[args[3]]
    z_true = np.einsum("ej,ej->e", T_e[:, 2, :3], pts[args[4]]) + T_e[:, 2, 3]
    z = np.where(rng.uniform(size=E) < 0.3, z_true + rng.normal(0, 0.02, E), 0.0).astype(np.float32)
    z_si = np.where(z > 0, 2.0, 0.0).astype(np.float32)
    args[7] = np.arange(E) % 7 != 3
    kw_j, kw_t = {}, {}
    if branch == "pairs":
        e1, e2 = jba.make_schur_pairs(args[4], args[7])
        kw_j = dict(pair_e1=jnp.asarray(e1), pair_e2=jnp.asarray(e2))
        kw_t = dict(pair_e1=t(e1), pair_e2=t(e2))
    j = to_np(jba.local_ba_points(*[jnp.asarray(a) for a in args], obs_z=jnp.asarray(z),
                                  obs_z_si=jnp.asarray(z_si), num_iters=4, **kw_j))
    p = to_np(tba.local_ba_points(*[t(a) for a in args], obs_z=t(z), obs_z_si=t(z_si),
                                  num_iters=4, **kw_t))
    assert_close(p[0], j[0], atol=1e-3)
    assert_close(p[1], j[1], atol=1e-3)
    np.testing.assert_array_equal(p[3], j[3])


@pytest.mark.parametrize("seed,n_kf", [(0, 4), (1, 4), (2, 3)])
def test_local_ba_points_rejects_the_step_of_a_failed_factor(seed, n_kf):
    """Every camera free, so the reduced camera system carries the 7-DoF
    gauge: with lam = 1e-4 against entries ~1e6 it is not positive definite
    in float32, and the factor fails in both packages. JAX's cho_solve
    then gives NaN and its LM rejects the step; torch's partial factor gives
    a finite step, which on these problems lowers the cost ~20x-3600x, so a
    port that kept it would move every camera. One LM step: both must
    return their inputs bit for bit, with the same cost (within 1e-3
    relative) and inlier mask."""
    tcw, pts, okf, opt, ouv = _scene(n_kf=n_kf, seed=seed)
    rng = np.random.default_rng(100 + seed)
    pts0 = (pts + 0.05 * rng.normal(size=pts.shape)).astype(np.float32)
    E = len(okf)
    args = (tcw, pts0, K_BA, okf.astype(np.int32), opt.astype(np.int32), ouv.astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool), np.zeros(n_kf, bool), np.ones(len(pts), bool))
    j = to_np(jba.local_ba_points(*[jnp.asarray(a) for a in args], num_iters=1))
    p = to_np(tba.local_ba_points(*[t(a) for a in args], num_iters=1))
    assert np.array_equal(j[0], tcw) and np.array_equal(j[1], pts0)
    assert np.array_equal(p[0], tcw) and np.array_equal(p[1], pts0)
    assert_close(p[2], j[2], atol=1e-3 * float(j[2]), what="cost")
    np.testing.assert_array_equal(p[3], j[3])


def test_make_schur_pairs_and_inv3():
    rng = np.random.default_rng(0)
    obs_pt = rng.integers(0, 20, 90)
    valid = rng.uniform(size=90) < 0.8
    for bucket in (True, False):
        a = jba.make_schur_pairs(obs_pt, valid, bucket=bucket)
        b = tba.make_schur_pairs(obs_pt, valid, bucket=bucket)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    assert_close(to_np(tba.inv3_sym(t(A))), np.asarray(jba.inv3_sym(jnp.asarray(A))), atol=1e-4)
    chi2 = rng.uniform(0, 20, 100).astype(np.float32)
    assert_close(to_np(tba.huber_weight(t(chi2))), np.asarray(jba.huber_weight(jnp.asarray(chi2))),
                 atol=1e-7)
