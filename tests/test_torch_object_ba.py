"""cube_slam_tpu_torch/graph/object_ba.py against cube_slam_tpu/graph/object_ba.py
on the CPU: the edge families, the robust cost, the normal blocks and the
LM (single and two-stage) on the cuboid scene of tests/test_object_ba.py,
with unary and binary point-object hinges, with and without the 9-DoF
measurement edges. The port is also held to those tests' own assertions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_object_ba import K, _object_scene
from torch_parity_utils import assert_close, to_np

from cube_slam_tpu.graph import object_ba as jba
from cube_slam_tpu.models import cuboid as jcb
from cube_slam_tpu.utils import geometry as jgeo
from cube_slam_tpu_torch.graph import object_ba as tba
from cube_slam_tpu_torch.models import cuboid as tcb


def _perturb(cube, rng, s6, s3):
    return jcb.exp_update(cube, jnp.asarray(
        np.concatenate([s6 * rng.normal(size=6), s3 * rng.normal(size=3)]), dtype=jnp.float32))


def _se3(rng, s):
    return np.asarray(jgeo.se3_exp(jnp.asarray(s * rng.normal(size=6), dtype=jnp.float32)))


def _problem(case):
    """The numpy inputs of local_ba_objects for one configuration of
    tests/test_object_ba.py (`recover`, `joint`, `binary`, `two_stage`), as
    (positional args, keyword args)."""
    seed = dict(recover=0, joint=2, binary=4, two_stage=6, meas=2)[case]
    cube, pts, tcw, (okf, opt, ouv), boxes = _object_scene(seed=seed)
    rng = np.random.default_rng(seed + 1)
    n_kf, n_pt, E, B = len(tcw), len(pts), len(okf), len(tcw)
    tcw0, pts0, po_si, kw = tcw.copy(), pts.copy(), 2.0, {}
    fixed = np.array([True, True, False, False])
    obj_valid, obj_fix = np.array([True]), np.array([False])
    if case == "recover":
        c0 = _perturb(cube, rng, 0.1, 0.08)
        obj_pose = np.stack([np.asarray(c0.pose), np.eye(4, dtype=np.float32)])
        obj_scale = np.stack([np.asarray(c0.scale), np.ones(3, dtype=np.float32)])
        fixed = np.ones(n_kf, bool)
        obj_valid, obj_fix = np.array([True, False]), np.array([False, False])
        kw = dict(num_iters=25)
    else:
        if case in ("joint", "meas", "two_stage"):
            for i in range(2, n_kf):
                tcw0[i] = _se3(rng, 0.02) @ tcw0[i]
        noise = dict(joint=0.03, meas=0.03, binary=0.05, two_stage=0.02)[case]
        if case == "two_stage":
            bad = rng.choice(E, E // 10, replace=False)
            ouv = ouv.copy()
            ouv[bad] += rng.uniform(60, 120, size=(len(bad), 2))
            kw = dict(bad=bad)
        pts0 = pts + noise * rng.normal(size=pts.shape).astype(np.float32)
        c0 = cube if case == "two_stage" else _perturb(cube, rng, *dict(joint=(0.05, 0.05), meas=(0.05, 0.05),
                                                                            binary=(0.08, 0.06))[case])
        obj_pose, obj_scale = np.asarray(c0.pose)[None], np.asarray(c0.scale)[None]
        if case == "binary":
            fixed, po_si = np.ones(n_kf, bool), 0.5
            kw = dict(num_iters=25, po_binary=True)
        elif case != "two_stage":
            kw = dict(num_iters=25)
        if case == "meas":
            # detector-like camera-frame cuboids: the truth seen from each
            # true camera, perturbed
            kw = dict(num_iters=10)
            meas_pose = np.stack([tcw[i] @ np.asarray(cube.pose) @ _se3(rng, 0.03) for i in range(B)])
            kw.update(meas_kf=np.arange(B, dtype=np.int32), meas_obj=np.zeros(B, np.int32),
                      meas_pose=meas_pose.astype(np.float32),
                      meas_scale=(np.asarray(cube.scale) * rng.uniform(0.9, 1.1, (B, 3))).astype(np.float32),
                      meas_si=np.full(B, 0.8, np.float32), meas_valid=np.array([True, True, True, False]))
    args = (tcw0.astype(np.float32), pts0.astype(np.float32), obj_pose.astype(np.float32),
            obj_scale.astype(np.float32), K,
            okf.astype(np.int32), opt.astype(np.int32), ouv.astype(np.float32), np.ones(E, np.float32),
            np.ones(E, bool),
            np.arange(B, dtype=np.int32), np.zeros(B, np.int32), boxes.astype(np.float32),
            np.full(B, 0.1, np.float32), np.ones(B, bool),
            np.zeros(n_pt, np.int32), np.arange(n_pt, dtype=np.int32), np.full(n_pt, po_si, np.float32),
            np.ones(n_pt, bool),
            fixed, np.ones(n_pt, bool), obj_valid, obj_fix)
    return cube, pts, tcw, args, kw


def _split(args, kw):
    """(state, K, edge tuples, masks, meas edges, po_binary) of a problem."""
    state, Kq = args[:4], args[4]
    meas = None
    if "meas_kf" in kw:
        meas = tuple(kw[k] for k in ("meas_kf", "meas_obj", "meas_pose", "meas_scale", "meas_si", "meas_valid"))
    return state, Kq, (args[5:10], args[10:15], args[15:19]), args[19:23], meas, kw.get("po_binary", False)


def _j(x):
    return None if x is None else tuple(jnp.asarray(a) for a in x)


def _t(x):
    return None if x is None else tuple(torch.as_tensor(np.asarray(a)) for a in x)


CASES = [("recover", False), ("joint", False), ("binary", False), ("meas", False), ("meas", True),
         ("binary", True)]


@pytest.mark.parametrize("case,flip_binary", CASES)
def test_residuals_cost_and_normal_blocks(case, flip_binary):
    """residual_families, total_robust_cost (with the shape prior and, where
    given, the measurement edges) and assemble_normal_blocks at the initial
    state. Tolerances: residuals 2e-4 (pixels ~1e2), blocks 1e-4 relative
    to the largest entry of each (float32 products in other orders)."""
    _, _, _, args, kw = _problem(case)
    state, Kq, (obs, box, po), masks, meas, binary = _split(args, kw)
    binary = binary != flip_binary
    flags = masks[2:]
    Kf, P, O = len(state[0]), len(state[1]), len(state[2])

    jr = jba.residual_families(_j(state), jnp.asarray(Kq), *_j(obs), *_j(box), *_j(po), po_binary=binary)
    tr = tba.residual_families(_t(state), torch.as_tensor(Kq), *_t(obs), *_t(box), *_t(po), po_binary=binary)
    for name, a, b in zip(("reproj", "bbox", "point-object"), to_np(jr), to_np(tr)):
        assert_close(b, a, atol=2e-4, rtol=1e-5, what=name)

    jc = jba.total_robust_cost(_j(state), jnp.asarray(Kq), _j(obs), _j(box), _j(po), po_binary=binary,
                               obj_flags=_j(flags), meas_edges=_j(meas))
    tc = tba.total_robust_cost(_t(state), torch.as_tensor(Kq), _t(obs), _t(box), _t(po), po_binary=binary,
                               obj_flags=_t(flags), meas_edges=_t(meas))
    assert_close(to_np(tc), to_np(jc), atol=1e-3, rtol=2e-5, what="cost")

    jb = jba.assemble_normal_blocks(_j(state), jnp.asarray(Kq), Kf, P, O, _j(obs), _j(box), _j(po),
                                    po_binary=binary, obj_flags=_j(flags), meas_edges=_j(meas))
    tb = tba.assemble_normal_blocks(_t(state), torch.as_tensor(Kq), Kf, P, O, _t(obs), _t(box), _t(po),
                                    po_binary=binary, obj_flags=_t(flags), meas_edges=_t(meas))
    h_max = float(np.abs(to_np(jb)[0]).max())
    for name, a, b in zip(("H_C", "b_C", "Hpp", "bp", "W"), to_np(jb), to_np(tb)):
        assert b.shape == a.shape, name
        atol = 1e-4 * float(np.abs(a).max())
        if name in ("b_C", "bp"):
            # the reprojection residuals of an exact scene are float32
            # rounding (~3e-5 px, exactly 0 in JAX), which J^T multiplies:
            # measured at most 0.04 where max |H_C| is 1.3e7
            atol += 1e-8 * h_max
        assert_close(b, a, atol=atol, what=name)
    if not binary:
        assert not to_np(tb)[4][Kf * 6:].any()


def _run(fn_j, fn_t, args, kw):
    kw = {k: v for k, v in kw.items() if k != "bad"}
    num = {k: v for k, v in kw.items() if not k.startswith("meas_")}
    meas = {k: v for k, v in kw.items() if k.startswith("meas_")}
    j = fn_j(*[jnp.asarray(a) for a in args], **num, **{k: jnp.asarray(v) for k, v in meas.items()})
    t = fn_t(*[torch.as_tensor(np.asarray(a)) for a in args], **num,
             **{k: torch.as_tensor(v) for k, v in meas.items()})
    return to_np(j), to_np(t)


def _cube_err(pose, scale, cube):
    return float(np.linalg.norm(to_np(tcb.min_log_error(
        tcb.Cuboid(torch.as_tensor(pose), torch.as_tensor(scale)),
        tcb.Cuboid(torch.as_tensor(np.array(cube.pose)), torch.as_tensor(np.array(cube.scale)))))))


def _pose_errs(kf_out, tcw):
    return [float(np.linalg.norm(np.asarray(jgeo.se3_log(jnp.asarray(np.linalg.inv(tcw[i]) @ kf_out[i])))))
            for i in range(len(tcw))]


@pytest.mark.parametrize("case", ["recover", "joint", "binary", "meas", "two_stage"])
def test_local_ba_objects_matches_jax(case):
    """local_ba_objects (local_ba_objects_two_stage for `two_stage`) through
    both packages: cameras, points and the cuboid within 2e-3, the final
    cost within 1e-3 relative, the same inlier masks; then the port alone
    passes tests/test_object_ba.py's assertions for the configuration."""
    cube, pts, tcw, args, kw = _problem(case)
    if case == "two_stage":
        j, t = _run(jba.local_ba_objects_two_stage, tba.local_ba_objects_two_stage, args, kw)
    else:
        j, t = _run(jba.local_ba_objects, tba.local_ba_objects, args, kw)
    for name, a, b in zip(("kf_tcw", "pts", "obj_pose", "obj_scale"), j[:4], t[:4]):
        assert_close(b, a, atol=2e-3, what=name)
    assert_close(t[4], j[4], atol=1e-6, rtol=1e-3, what="cost")
    assert np.array_equal(t[5], j[5]) and np.array_equal(t[6], j[6])

    kf_out, pts_out, op_out, os_out = t[:4]
    if case == "recover":
        init = _cube_err(args[2][0], args[3][0], cube)
        assert _cube_err(op_out[0], os_out[0], cube) < 0.3 * init
        np.testing.assert_allclose(kf_out, tcw, atol=1e-6)
        np.testing.assert_allclose(op_out[1], np.eye(4), atol=1e-6)
    elif case in ("joint", "meas"):
        assert max(_pose_errs(kf_out, tcw)) < 0.02
        assert _cube_err(op_out[0], os_out[0], cube) < 0.08
    elif case == "binary":
        err0 = float(np.linalg.norm(args[1] - pts, axis=1).mean())
        assert float(np.linalg.norm(pts_out - pts, axis=1).mean()) < 0.6 * err0
        assert _cube_err(op_out[0], os_out[0], cube) < 0.6 * _cube_err(args[2][0], args[3][0], cube)
    else:
        assert not t[5][kw["bad"]].any()
        assert max(_pose_errs(kf_out, tcw)) < 0.02


def test_camera_object_mask_matches_jax():
    kf_fixed = np.array([True, False, False])
    obj_valid = np.array([True, False, True, True])
    fix_scale = np.array([False, False, True, False])
    j = jba.camera_object_mask(jnp.asarray(kf_fixed), jnp.asarray(obj_valid), jnp.asarray(fix_scale), 4)
    t = tba.camera_object_mask(torch.as_tensor(kf_fixed), torch.as_tensor(obj_valid),
                               torch.as_tensor(fix_scale), 4)
    assert np.array_equal(to_np(t), np.asarray(j))
