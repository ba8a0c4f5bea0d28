"""cube_slam_tpu_torch graph/lm.py and slam/object_slam.py (the LM graph
solve and the incremental demo) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_utils import assert_close, to_np

from cube_slam_tpu.models import cuboid as jcb
from cube_slam_tpu.slam import object_slam as jos
from cube_slam_tpu.utils import geometry as jgeo
from cube_slam_tpu_torch.graph.lm import gauss_newton_step, lm_optimize
from cube_slam_tpu_torch.slam import object_slam as tos

# Cholesky and the 3x3 products come from different LAPACK/BLAS builds, so
# float32 solves agree to ~1e-4 after several iterations; 1e-3 is the bound.
TOL = 1e-3


def _circular_sequence(n, radius=2.5):
    """The exact-measurement orbit of tests/test_graph.py."""
    cube_world = jcb.from_minimal_vector(
        jnp.asarray([0.0, 0.0, 0.4, 0.0, 0.0, 0.3, 0.5, 0.3, 0.4], dtype=jnp.float32))
    poses = []
    for i in range(n):
        ang = 0.12 * i
        t = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.2])
        R = np.asarray(jgeo.euler_zyx_to_rot(jnp.float32(-1.4), jnp.float32(0.05), jnp.float32(ang)))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T)
    poses = np.stack(poses).astype(np.float32)
    meas = []
    for i in range(n):
        local = jcb.transform_to(cube_world, jnp.asarray(poses[i]))
        meas.append((np.array(local.pose), np.array(local.scale), 0.8))
    return poses, meas, cube_world


def test_lm_quadratic_and_mask():
    # one-element slices, not 0-dim tensors: under torch.func a 0-dim tensor
    # meeting a Python float gets a float64 tangent (see utils/geometry.py)
    def residual(p):
        x, y = p
        return torch.cat([10.0 * (y - x * x), 1.0 - x])

    res = lm_optimize(residual, lambda p, dx: (p[0] + dx[0:1], p[1] + dx[1:2]),
                      (torch.tensor([-1.2]), torch.tensor([1.0])), dim=2, num_iters=60)
    assert abs(float(res.params[0]) - 1.0) < 1e-3 and abs(float(res.params[1]) - 1.0) < 1e-3
    assert float(res.chi2) < 1e-8
    target = torch.tensor([1.0, 2.0, 3.0])
    res = lm_optimize(lambda p: p - target, lambda p, dx: p + dx, torch.zeros(3), dim=3,
                      num_iters=10, param_mask=torch.tensor([True, False, True]))
    assert_close(res.params.numpy(), [1.0, 0.0, 3.0], 1e-4)
    p, chi2 = gauss_newton_step(lambda p: p - target, lambda p, dx: p + dx, torch.zeros(3), dim=3)
    assert_close(p.numpy(), target.numpy(), 1e-4)
    assert abs(float(chi2) - 14.0) < 1e-5


def test_optimize_graph_exact_recovery_matches_jax():
    n, F = 8, 8
    poses, meas, cube_world = _circular_sequence(n)
    tcw_true = np.stack([np.linalg.inv(p) for p in poses]).astype(np.float32)
    rng = np.random.default_rng(0)
    tcw_init = tcw_true.copy()
    for f in range(1, n):
        noise = 0.05 * rng.normal(size=6).astype(np.float32)
        tcw_init[f] = np.asarray(jgeo.se3_exp(jnp.asarray(noise))) @ tcw_init[f]
    meas_pose = np.stack([m[0] for m in meas])
    meas_scale = np.stack([m[1] for m in meas])
    quality = np.full(n, 0.8, dtype=np.float32)
    has = np.ones(n, dtype=bool)
    odom = np.stack([np.eye(4, dtype=np.float32)]
                    + [tcw_true[f] @ np.linalg.inv(tcw_true[f - 1]) for f in range(1, n)])
    cube_init = jcb.exp_update(cube_world, jnp.asarray(0.05 * rng.normal(size=9), dtype=jnp.float32))
    cpose, cscale = np.asarray(cube_init.pose), np.asarray(cube_init.scale)

    args = (tcw_init, cpose, cscale, meas_pose, meas_scale, quality, has, odom)
    j = jos.optimize_graph(*[jnp.asarray(a) for a in args], jnp.asarray(n), num_iters=20, max_frames=F)
    t = tos.optimize_graph(*args, n, num_iters=20, max_frames=F, device="cpu")
    j, t = to_np(j), to_np(t)
    assert float(t[3]) < 1e-3  # the f32 convergence floor, as tests/test_graph.py
    for a, b, what in zip(j, t, ["tcw", "cube_pose", "cube_scale"]):
        assert_close(a, b, TOL, what=what)
    est = np.stack([np.linalg.inv(T) for T in t[0][:n]])
    assert tos.evaluate_ate(est, poses) < 5e-3


def test_demo_run_with_measurements_matches_jax():
    poses, meas, _ = _circular_sequence(12)
    rj = jos.ObjectSlamDemo(max_frames=16, num_lm_iters=5).run_with_measurements(meas, poses[0])
    rt = tos.ObjectSlamDemo(max_frames=16, num_lm_iters=5, device="cpu").run_with_measurements(meas, poses[0])
    assert np.isfinite(rt.chi2_history).all()
    assert np.array_equal(rj.raw_cube_valid, rt.raw_cube_valid)
    assert_close(rj.est_Twc, rt.est_Twc, TOL, what="est_Twc")
    assert_close(rj.cube_pose_history, rt.cube_pose_history, TOL, what="cube pose")
    assert_close(rj.cube_scale_history, rt.cube_scale_history, TOL, what="cube scale")
    # chi2 spans decades: relative, with an absolute floor at the f32 noise
    assert_close(rj.chi2_history, rt.chi2_history, 1e-5, rtol=TOL, what="chi2")
    assert abs(tos.evaluate_ate(rt.est_Twc, poses) - jos.evaluate_ate(rj.est_Twc, poses)) < TOL
