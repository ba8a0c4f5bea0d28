"""cube_slam_tpu_torch slam/loop_closing.py (Sim3 verification, the Sim3
pose graph, loop correction) against the JAX package on the CPU, on the
constructed drifted loop of tests/test_loop_system.py (built by
torch_parity_utils.build_drifted_loop into a tracker of each package).

Tolerances: verification and correction run float32 on the device side and
float64 on the host side in both packages; their results agree to ~1e-6
(s, R, t, poses) and ~5e-6 m (points, up to ~10 m from the origin).
VERIFY_TOL and MAP_TOL leave an order of magnitude. Match sets, inlier
counts and the keys of the corrections are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_utils import LOOP_CONFIG, LOOP_K, LOOP_N_KF, assert_close, build_drifted_loop, to_np

from cube_slam_tpu.slam import loop_closing as jlc
from cube_slam_tpu.slam import system as jsys
from cube_slam_tpu_torch.slam import loop_closing as tlc
from cube_slam_tpu_torch.slam import system as tsys
from cube_slam_tpu_torch.utils import geometry as tgeo

VERIFY_TOL = 2e-5
MAP_TOL = 1e-4
K_LAST = LOOP_N_KF - 1


def _maps():
    """The drifted loop in a JAX tracker and in a port tracker (CPU)."""
    J = jsys.MonocularTracker(LOOP_K, (640, 480), jsys.TrackerConfig(**LOOP_CONFIG))
    P = tsys.MonocularTracker(LOOP_K, (640, 480), tsys.TrackerConfig(**LOOP_CONFIG), device="cpu")
    for tr in (J, P):
        build_drifted_loop(tr)
    return J, P


@pytest.fixture(scope="module")
def maps():
    return _maps()


def test_sim3_guided_matches(maps):
    """With the loop's own Sim3 (JAX's RANSAC estimate) and with a
    perturbed one and a narrower radius: the same agreed pairs."""
    J, P = maps
    s, R, t, _ = jlc.verify_loop_sim3(J.map, K_LAST, 0, K=None, seed=LOOP_N_KF)
    dR = tgeo.so3_exp(torch.tensor([0.002, -0.001, 0.003])).numpy().astype(np.float64)
    sizes = []
    for S, radius in (((s, R, t), 0.3), ((1.01 * s, dR @ R, t + 0.01), 0.15)):
        a = jlc._sim3_guided_matches(J.map, K_LAST, 0, *S, radius)
        b = tlc._sim3_guided_matches(P.map, K_LAST, 0, *S, radius, device="cpu")
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        sizes.append(len(b[0]))
    assert sizes[0] >= 40 and 0 < sizes[1] <= sizes[0], sizes


@pytest.mark.parametrize("K", [None, LOOP_K])
def test_verify_loop_sim3_both_branches(maps, K):
    """K=None: the thresholded RANSAC at 0.3 m; K given: trimmed RANSAC,
    guided re-match, trimmed re-fit, the min_total=40 gate."""
    J, P = maps
    for seed in (LOOP_N_KF, 3):
        a = jlc.verify_loop_sim3(J.map, K_LAST, 0, K=K, seed=seed)
        b = tlc.verify_loop_sim3(P.map, K_LAST, 0, K=K, seed=seed, device="cpu")
        assert a is not None and b is not None
        assert a[3] == b[3] and b[3] >= 40
        for x, y in zip(a[:3], b[:3]):
            assert_close(x, y, VERIFY_TOL, rtol=VERIFY_TOL)


def test_verify_loop_sim3_rejects(maps):
    """A non-loop pair (two keyframes with unrelated points) and a too-high
    min_total are rejected by both packages."""
    J, P = maps
    for args in (dict(kf_a=5, kf_b=1, K=LOOP_K), dict(kf_a=K_LAST, kf_b=0, K=LOOP_K, min_total=200),
                 dict(kf_a=K_LAST, kf_b=0, K=None, min_inliers=100)):
        assert jlc.verify_loop_sim3(J.map, seed=1, **args) is None
        assert tlc.verify_loop_sim3(P.map, seed=1, device="cpu", **args) is None


def _closed_loop_graph():
    """tests/test_loop_closing.py:81-142: a drifted 12-keyframe circle,
    odometry edges from the drifted estimates and one strong true loop edge."""
    n = 12
    se3 = lambda xi: tgeo.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()  # noqa: E731
    step = se3([0.0, 0.0, 2 * np.pi / n, 0.5, 0.0, 0.0])
    drift = se3([0.0, 0.0, 0.015, 0.02, 0.0, 0.0])
    T_true, T_est = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    true_tcw, est_tcw = [], []
    for _ in range(n):
        true_tcw.append(T_true.copy())
        est_tcw.append(T_est.copy())
        T_true = (step @ T_true).astype(np.float32)
        T_est = ((drift @ step) @ T_est).astype(np.float32)
    ei, ej, es, eR, et, ew = [], [], [], [], [], []
    for i in range(n - 1):
        rel = est_tcw[i] @ np.linalg.inv(est_tcw[i + 1])
        ei.append(i); ej.append(i + 1); es.append(1.0); eR.append(rel[:3, :3]); et.append(rel[:3, 3]); ew.append(1.0)
    rel_true = true_tcw[0] @ np.linalg.inv(true_tcw[n - 1])
    ei.append(0); ej.append(n - 1); es.append(1.0); eR.append(rel_true[:3, :3]); et.append(rel_true[:3, 3])
    ew.append(10.0)
    fixed = np.zeros(n, dtype=bool)
    fixed[0] = True
    args = (np.ones(n, np.float32), np.stack([T[:3, :3] for T in est_tcw]).astype(np.float32),
            np.stack([T[:3, 3] for T in est_tcw]).astype(np.float32),
            np.asarray(ei, np.int32), np.asarray(ej, np.int32), np.asarray(es, np.float32),
            np.stack(eR).astype(np.float32), np.stack(et).astype(np.float32), np.ones(n, bool),
            np.asarray(ew, np.float32), fixed, np.ones(n, bool))
    return args, rel_true, est_tcw


def test_relative_sim3_batch():
    args, _, _ = _closed_loop_graph()
    s = np.linspace(0.8, 1.2, 12).astype(np.float32)
    ei, ej = args[3], args[4]
    a = jlc._relative_sim3_batch(jnp.asarray(s), jnp.asarray(args[1]), jnp.asarray(args[2]),
                                 jnp.asarray(ei), jnp.asarray(ej))
    b = tlc._relative_sim3_batch(torch.as_tensor(s), torch.as_tensor(args[1]), torch.as_tensor(args[2]),
                                 torch.as_tensor(ei), torch.as_tensor(ej))
    for x, y in zip(to_np(a), to_np(b)):
        assert x.shape == y.shape
        assert_close(x, y, 1e-6, rtol=1e-6)


def test_optimize_sim3_pose_graph_closes_loop():
    """The same optimum as JAX (poses within 2e-4 after 30 LM steps over 84
    unknowns; measured 1e-6), and the loop closes (gap < 0.25 of before)."""
    args, rel_true, est_tcw = _closed_loop_graph()
    a = jlc.optimize_sim3_pose_graph(*[jnp.asarray(x) for x in args], num_iters=30, n_kf=12)
    b = tlc.optimize_sim3_pose_graph(*[torch.as_tensor(x) for x in args], num_iters=30, n_kf=12)
    a, b = to_np(a), to_np(b)
    for x, y in zip(a, b):
        assert np.isfinite(y).all()
        assert_close(x, y, 2e-4, rtol=2e-4)
    s2, R2, t2 = b
    last = np.eye(4)
    last[:3, :3] = R2[11]
    last[:3, 3] = t2[11] / s2[11]
    log = lambda T: float(np.linalg.norm(tgeo.se3_log(torch.tensor(T.astype(np.float32))).numpy()))  # noqa: E731
    gap = log(rel_true @ last @ np.linalg.inv(est_tcw[0]))
    gap0 = log(rel_true @ est_tcw[11] @ np.linalg.inv(est_tcw[0]))
    assert gap < 0.25 * gap0, (gap, gap0)


def test_correct_loop_on_drifted_map():
    """correct_loop on the drifted map with JAX's verified Sim3: the same
    corrections (keys, new and old poses, scales), keyframe poses and map
    points. Residuals at the LM's optimum are ~0: no NaN from so3_log's
    Jacobian there."""
    J, P = _maps()
    ver = jlc.verify_loop_sim3(J.map, K_LAST, 0, K=LOOP_K, seed=LOOP_N_KF)
    cj = jlc.correct_loop(J.map, loop_kf=K_LAST, matched_kf=0, sim3_correction=ver[:3], covis_theta=30,
                          extra_loop_edges=[(0, 5)])
    ct = tlc.correct_loop(P.map, loop_kf=K_LAST, matched_kf=0, sim3_correction=ver[:3], covis_theta=30,
                          extra_loop_edges=[(0, 5)], device="cpu")
    assert sorted(cj) == sorted(ct) == list(range(LOOP_N_KF))
    for k in cj:
        for x, y in zip(cj[k], ct[k]):
            assert np.isfinite(y).all()
            assert_close(x, y, MAP_TOL)
    assert_close(J.map.kf_tcw, P.map.kf_tcw, MAP_TOL)
    live = J.map.mp_valid
    assert np.array_equal(live, P.map.mp_valid)
    assert_close(J.map.mp_pos[live], P.map.mp_pos[live], MAP_TOL)
    # the correction moved the loop keyframe by more than the tolerance
    assert np.abs(ct[K_LAST][0] - ct[K_LAST][1]).max() > 100 * MAP_TOL


def test_failed_cholesky_factor_gives_a_rejected_step_as_in_jax():
    """XLA's cho_factor fills a failed factor with NaN, so JAX's LMs reject
    that step; torch.linalg.cholesky_ex leaves finite entries. The port's
    solves (graph/lm.py, the pose, local, global and object BAs) return NaN
    there too."""
    import jax.scipy.linalg as jsl

    from cube_slam_tpu_torch.graph import ba as tba
    from cube_slam_tpu_torch.graph import lm as tlm

    A = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=np.float32)
    b = np.ones(3, dtype=np.float32)
    assert not np.isfinite(np.asarray(jsl.cho_factor(jnp.asarray(A), lower=True)[0])).all()
    assert torch.isnan(tlm._cholesky_solve(torch.as_tensor(A), torch.as_tensor(b))).all()
    assert torch.isnan(tba._cholesky_solve(torch.as_tensor(A), torch.as_tensor(b))).all()
    # the partial factor itself is finite: only the status marks it failed
    L, info = torch.linalg.cholesky_ex(torch.as_tensor(A))
    assert torch.isfinite(L).all() and int(info) != 0
    # a batch keeps its good members
    Ab = torch.stack([torch.as_tensor(A), torch.eye(3)])
    x = tba._cholesky_solve(Ab, torch.ones(2, 3))
    assert torch.isnan(x[0]).all() and torch.equal(x[1], torch.ones(3))
