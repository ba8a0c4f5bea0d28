"""graph/dynamic_ba.py of cube_slam_tpu_torch (dynamic_object_ba) against
the JAX package on the CPU, on the scene of tests/test_dynamic_ba.py (a
car-like cuboid driving straight past a camera rig, 5 keyframes, 24 surface
points) with numpy inputs made from seeds.

Each case runs both LMs from the same perturbed start: the starting cost
(num_iters=0: every residual family at once), then the solve. The port's
Jacobians are torch.func.jacfwd's, JAX's jax.jacfwd's; the normal equations
and the float32 Cholesky sum in other orders, so the solves agree to
SOLVE_TOL, not bit for bit. The JAX package pads every edge family to a
fixed capacity with invalid edges; the port takes the problem's own size,
so the empty point family (the KITTI default, ba_pt_obj_cam=False) is a
1,024-edge padded family in JAX and a zero-edge one in the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_utils as tpu
from test_dynamic_ba import _dynamic_scene

from cube_slam_tpu.graph import dynamic_ba as jdba
from cube_slam_tpu.utils import geometry as jgeo
from cube_slam_tpu_torch.graph import dynamic_ba as tdba

# starting cost, relative (the residuals' float32 rounding; measured
# <= 2.3e-7)
COST_REL = 1e-5
# solved state, port against JAX: pose, point and velocity entries, and
# the final cost relative (absolute below a cost of 1e-3). Measured on the
# four cases: object poses <= 9.5e-4, points <= 7.8e-4, velocity <= 1.2e-3
# (no_points, where only the bbox and motion edges pin it), cameras
# <= 2.3e-6, cost <= 1e-6 relative.
SOLVE_TOL = tpu.cs.DYNAMIC_BA_TOL
CHI2_REL = 2e-2


K = tpu.cs.DYNAMIC_BA_K


def test_scene_is_the_jax_tests():
    """chip_smoke.dynamic_ba_scene (13C's copy, which imports no JAX) is
    tests/test_dynamic_ba.py's scene bit for bit."""
    from test_dynamic_ba import K as jK

    assert np.array_equal(K, jK)
    for a, b in zip(tpu.cs.dynamic_ba_scene(), _dynamic_scene()):
        assert np.array_equal(a, b) and np.asarray(a).dtype == np.asarray(b).dtype


def _problem(case):
    """The numpy arguments and keywords of one call."""
    (tcw, stamps, obj_pose_true, scale, v_true, lp_true,
     dp_kf, dp_obj, dp_pt, dp_uv) = tpu.cs.dynamic_ba_scene()
    r = tpu.rng(1)
    n_kf, Q = len(tcw), len(lp_true)
    obj0 = obj_pose_true.copy()
    for i in range(n_kf):
        xi = 0.05 * r.normal(size=6).astype(np.float32)
        obj0[i] = obj0[i] @ np.asarray(jgeo.se3_exp(jnp.asarray(xi)))
    lp0 = (lp_true + 0.05 * r.normal(size=lp_true.shape)).astype(np.float32)
    tcw0 = tcw.copy()
    kf_fixed = np.ones(n_kf, dtype=bool)
    kw = dict(num_iters=25)
    if case in ("all_families", "fix_rotation", "no_points"):
        # free cameras (the oldest fixed), perturbed; bbox edges per
        # keyframe from the true projection; static anchors on world points
        kf_fixed[1:] = False
        for i in range(1, n_kf):
            xi = 0.01 * r.normal(size=6).astype(np.float32)
            tcw0[i] = np.asarray(jgeo.se3_exp(jnp.asarray(xi))) @ tcw0[i]
        from cube_slam_tpu.models import cuboid as jcb

        bo_meas = np.stack([np.array(jcb.project_onto_image_bbox(
            jcb.Cuboid(jnp.asarray(obj_pose_true[i]), jnp.asarray(scale)), jnp.asarray(tcw[i]), jnp.asarray(K)))
            for i in range(n_kf)]).astype(np.float32)
        S = 40
        sp_pts = np.stack([r.uniform(-6, 10, S), r.uniform(2, 8, S), r.uniform(0, 3, S)], 1).astype(np.float32)
        sp_kf = (np.arange(S) % n_kf).astype(np.int32)
        pc = np.einsum("sij,sj->si", tcw[sp_kf][:, :3, :3], sp_pts) + tcw[sp_kf][:, :3, 3]
        uv = pc @ K.T
        sp_uv = (uv[:, :2] / uv[:, 2:3] + 0.5 * r.normal(size=(S, 2))).astype(np.float32)
        sp_valid = pc[:, 2] > 0.5
        kw.update(bo_kf=np.arange(n_kf, dtype=np.int32), bo_obj=np.zeros(n_kf, np.int32), bo_meas=bo_meas,
                  bo_si=np.full(n_kf, 0.5, np.float32), bo_valid=np.ones(n_kf, bool),
                  sp_kf=sp_kf, sp_pts=sp_pts, sp_uv=sp_uv, sp_si=np.ones(S, np.float32), sp_valid=sp_valid,
                  motion_weight=1.5, num_iters=15)
        if case == "fix_rotation":
            kw["fix_rotation"] = True
    pt_valid = np.ones(Q, dtype=bool)
    if case == "no_points":
        dp_kf = dp_obj = dp_pt = np.zeros(0, np.int32)
        dp_uv = np.zeros((0, 2), np.float32)
        pt_valid[:] = False
        kw["fix_rotation"] = True
    E = len(dp_kf)
    args = [tcw0, stamps, obj0[None], scale[None], np.array([[0.5, 0.1]], np.float32), lp0, K,
            np.asarray(dp_kf, np.int32), np.asarray(dp_obj, np.int32), np.asarray(dp_pt, np.int32),
            np.asarray(dp_uv, np.float32), np.ones(E, np.float32), np.ones(E, bool),
            np.zeros(n_kf - 1, np.int32), np.arange(n_kf - 1, dtype=np.int32), np.arange(1, n_kf, dtype=np.int32),
            np.ones(n_kf - 1, bool), kf_fixed, np.ones((1, n_kf), bool), np.ones(1, bool), pt_valid]
    return args, kw


def _pad_for_jax(args):
    """The JAX manager's padding of the point family: 1,024 invalid edges."""
    args = list(args)
    cap = 1024
    for i, w in ((7, None), (8, None), (9, None), (10, 2), (11, None), (12, None)):
        a = args[i]
        out = np.zeros((cap,) + (() if w is None else (w,)), a.dtype)
        out[:len(a)] = a
        args[i] = out
    args[11][:] = 1.0
    return args


def _run(args, kw, **over):
    kw = dict(kw, **over)
    jargs = _pad_for_jax(args) if len(args[7]) == 0 else args
    j = jdba.dynamic_object_ba(*[jnp.asarray(a) for a in jargs],
                               **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    t = tdba.dynamic_object_ba(*[torch.as_tensor(a) for a in args],
                               **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    return tpu.to_np(j), tpu.to_np(t)


CASES = ["points_and_motion", "all_families", "fix_rotation", "no_points"]


@pytest.mark.parametrize("case", CASES)
def test_starting_cost_matches_jax(case):
    """num_iters=0: the inputs come back unchanged and the cost of every
    residual family together agrees within COST_REL."""
    args, kw = _problem(case)
    (jt, jo, jv, jp, jc), (tt, to, tv, tp, tc) = _run(args, kw, num_iters=0)
    assert np.array_equal(tt, args[0]) and np.array_equal(to, args[2]) and np.array_equal(tp, args[5])
    assert abs(float(tc) / float(jc) - 1.0) <= COST_REL, (float(tc), float(jc))


@pytest.mark.parametrize("case", CASES)
def test_dynamic_object_ba_matches_jax(case):
    """The solve from the same start: cameras, per-keyframe object poses
    and local points within SOLVE_TOL (entries), the velocity within
    SOLVE_TOL, the final cost within CHI2_REL relative; fixed cameras and
    frozen points unchanged exactly, and with fix_rotation the object
    rotations within 1e-6. Both recover the scene's motion where the points shape it."""
    args, kw = _problem(case)
    (jt, jo, jv, jp, jc), (tt, to, tv, tp, tc) = _run(args, kw)
    fixed = args[17]
    assert np.array_equal(tt[fixed], args[0][fixed])
    if not args[20].any():
        assert np.array_equal(tp, args[5]) and np.array_equal(jp, args[5])
    if kw.get("fix_rotation"):
        assert np.abs(to[..., :3, :3] - args[2][..., :3, :3]).max() <= 1e-6
    gaps = dict(cam=np.abs(tt - jt).max(), obj=np.abs(to - jo).max(), vel=np.abs(tv - jv).max(),
                pts=np.abs(tp - jp).max())
    assert max(gaps.values()) <= SOLVE_TOL, gaps
    assert abs(float(tc) - float(jc)) <= CHI2_REL * max(float(jc), 1e-3), (float(tc), float(jc))
    if case == "points_and_motion":
        v_true = tpu.cs.dynamic_ba_scene()[4]
        assert abs(tv[0, 0] - v_true) < 0.1 and float(tc) < 1e-2
