"""Dynamic-object bundle adjustment.

PyTorch counterpart of cube_slam_tpu/graph/dynamic_ba.py, the re-design of
Optimizer::LocalBACameraPointObjectsDynamic
(orb_object_slam/src/Optimizer.cc:1537-2573): moving objects get a cuboid
pose PER KEYFRAME (`bundle_vertex_ids`, :1726-1786), their points live in
the OBJECT frame (UnaryLocalPoint keeps them inside the box,
g2o_Object.h:435-448), observations reproject through camera o objectPose
o localPoint (EdgeDynamicPointCuboidCamera, g2o_Object.cpp:155-239), and a
per-object planar-bicycle velocity ties consecutive keyframe poses together
(VelocityPlanarVelocity + EdgeObjectMotion, g2o_Object.cpp:241-278,
wheelbase 2.71 m).

The whole problem is small and dense (a handful of keyframes x objects), so
it runs on the generic dense LM (graph/lm.py) with one combined retract and
forward-mode Jacobians. Edge families take the problem's own sizes (the
JAX package pads them to fixed capacities; its callers clip to those
capacities, and so do the port's); an empty family contributes no rows.
"""

from __future__ import annotations

import torch

from ..models import cuboid as cb
from ..utils import geometry as geo
from . import factors
from .ba import HUBER_MONO, huber_weight, project
from .lm import lm_optimize


def _proj(T, K, p):
    """(E, 4, 4) poses, (E, 3) world points -> (E, 2) pixels (ba._project)."""
    uv, _ = project(T, K, p[:, None, :])
    return uv[:, 0]


def dynamic_object_ba(
    kf_tcw,          # (Kf, 4, 4)
    kf_stamps,       # (Kf,) timestamps (for motion-model dt)
    obj_pose_kf,     # (O, Kf, 4, 4) object pose per keyframe
    obj_scale,       # (O, 3) FIXED scale (KITTI prior)
    velocity,        # (O, 2) [v, steer]
    local_pts,       # (Q, 3) dynamic points in object frame
    K,               # (3, 3)
    # dynamic point reprojection edges
    dp_kf, dp_obj, dp_pt, dp_uv, dp_si, dp_valid,
    # motion edges: consecutive keyframe pairs per object
    mo_obj, mo_k0, mo_k1, mo_valid,
    # masks
    kf_fixed, obj_kf_valid, obj_valid, pt_valid,
    # camera-object bbox edges (ba_dyna_obj_cam, Optimizer.cc:2232): optional
    bo_kf=None, bo_obj=None, bo_meas=None, bo_si=None, bo_valid=None,
    # static-map reprojection edges (optional): anchor FREE cameras to the
    # static map while the dynamic residuals shape the object trajectory;
    # the static points enter as constants (they were just optimized by the
    # static local BA in the same keyframe step)
    sp_kf=None, sp_pts=None, sp_uv=None, sp_si=None, sp_valid=None,
    num_iters: int = 12,
    motion_weight: float = 1.0,
    inbox_weight: float = 1.0,
    fix_rotation: bool = False,
):
    """Tensors on one device (indices int64 or int32, masks bool). Returns
    (kf_tcw, obj_pose_kf, velocity, local_pts, chi2)."""
    Kf = kf_tcw.shape[0]
    O = obj_pose_kf.shape[0]
    Q = local_pts.shape[0]
    dev = kf_tcw.device
    L = lambda i: i.to(torch.int64)  # noqa: E731
    dp_kf, dp_obj, dp_pt = L(dp_kf), L(dp_obj), L(dp_pt)
    mo_obj, mo_k0, mo_k1 = L(mo_obj), L(mo_k0), L(mo_k1)
    dp_w = dp_valid.to(torch.float32)
    mo_w = mo_valid.to(torch.float32)

    n_cam = Kf * 6
    n_obj = O * Kf * 6
    n_vel = O * 2
    n_pts = Q * 3
    dim = n_cam + n_obj + n_vel + n_pts

    def split(dx):
        dc = dx[:n_cam].reshape(Kf, 6)
        do = dx[n_cam:n_cam + n_obj].reshape(O, Kf, 6)
        dv = dx[n_cam + n_obj:n_cam + n_obj + n_vel].reshape(O, 2)
        dp = dx[n_cam + n_obj + n_vel:].reshape(Q, 3)
        return dc, do, dv, dp

    def retract(params, dx):
        kf_tcw, obj_pose_kf, velocity, local_pts = params
        dc, do, dv, dp = split(dx)
        new_tcw = geo.se3_exp(dc) @ kf_tcw
        new_obj = obj_pose_kf @ geo.se3_exp(do)  # right-mult (VertexCuboid)
        return (new_tcw, new_obj, velocity + dv, local_pts + dp)

    def residual(params):
        kf_tcw, obj_pose_kf, velocity, local_pts = params

        # --- dynamic point reprojection (EdgeDynamicPointCuboidCamera)
        T_e = kf_tcw[dp_kf]                       # (E, 4, 4)
        P_e = obj_pose_kf[dp_obj, dp_kf]          # (E, 4, 4)
        lp = local_pts[dp_pt]                     # (E, 3)
        world = (P_e[:, :3, :3] @ lp[..., None])[..., 0] + P_e[:, :3, 3]
        uv = _proj(T_e, K, world)
        r_dp = (uv - dp_uv) * dp_si[:, None]
        chi2 = torch.sum(r_dp * r_dp, dim=-1)
        w = huber_weight(chi2, HUBER_MONO).detach()
        r_dp = r_dp * (w * dp_w)[:, None]

        # --- in-box prior (UnaryLocalPoint): local points inside half-scale
        sc = obj_scale[dp_obj]  # (E, 3) — per-edge object scale
        outside = torch.abs(lp) - sc
        r_box = torch.clamp(outside, min=0.0) * inbox_weight * dp_w[:, None]

        # --- motion model (EdgeObjectMotion)
        P0 = obj_pose_kf[mo_obj, mo_k0]
        P1 = obj_pose_kf[mo_obj, mo_k1]
        dt = kf_stamps[mo_k1] - kf_stamps[mo_k0]
        r_mo = factors.object_motion_error(
            cb.Cuboid(P0, obj_scale[mo_obj]), cb.Cuboid(P1, obj_scale[mo_obj]),
            velocity[mo_obj], dt, motion_weight, mo_w,
        )
        parts = [r_dp.reshape(-1), r_box.reshape(-1), r_mo.reshape(-1)]

        # --- camera-object bbox edges (EdgeSE3CuboidFixScaleProj per-KF)
        if bo_kf is not None:
            bk, bobj = L(bo_kf), L(bo_obj)
            T_b = kf_tcw[bk]
            P_b = obj_pose_kf[bobj, bk]
            rect = cb.project_onto_image_bbox(cb.Cuboid(P_b, obj_scale[bobj]), T_b, K)
            r_bo = (rect - bo_meas) * bo_si[:, None]
            chi2_b = torch.sum(r_bo * r_bo, dim=-1)
            wb = huber_weight(chi2_b, 30.0).detach()
            parts.append((r_bo * (wb * bo_valid.to(torch.float32))[:, None]).reshape(-1))

        # --- static anchor edges: camera vs fixed static map points
        if sp_kf is not None:
            uv_s = _proj(kf_tcw[L(sp_kf)], K, sp_pts)
            r_sp = (uv_s - sp_uv) * sp_si[:, None]
            chi2_s = torch.sum(r_sp * r_sp, dim=-1)
            ws = huber_weight(chi2_s, HUBER_MONO).detach()
            parts.append((r_sp * (ws * sp_valid.to(torch.float32))[:, None]).reshape(-1))
        return torch.cat(parts)

    cam_mask = torch.repeat_interleave(~kf_fixed, 6)
    # fix-rotation mode (the reference's dynamic config): per-KF cuboid
    # vertices optimize TRANSLATION ONLY — rotation stays at the measured
    # yaw (`whether_fixrotation = true`, Optimizer.cc:1778; the tangent is
    # [omega, upsilon])
    comp = torch.tensor([False, False, False, True, True, True] if fix_rotation else [True] * 6, device=dev)
    obj_mask = ((obj_valid[:, None] & obj_kf_valid).reshape(-1)[:, None] & comp[None, :]).reshape(-1)
    vel_mask = torch.repeat_interleave(obj_valid, 2)
    pts_mask = torch.repeat_interleave(pt_valid, 3)
    param_mask = torch.cat([cam_mask, obj_mask, vel_mask, pts_mask])

    res = lm_optimize(residual, retract, (kf_tcw, obj_pose_kf, velocity, local_pts),
                      dim=dim, num_iters=num_iters, param_mask=param_mask)
    new_tcw, new_obj, new_vel, new_pts = res.params
    return new_tcw, new_obj, new_vel, new_pts, res.chi2
