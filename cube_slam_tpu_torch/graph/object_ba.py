"""Camera + point + cuboid-object bundle adjustment.

PyTorch counterpart of cube_slam_tpu/graph/object_ba.py, the re-design of
Optimizer::LocalBACameraPointObjects (orb_object_slam/src/Optimizer.cc:
826-1534). Edge families over one reduced system:

* point reprojection (camera <-> point), Schur-eliminated points,
* camera-object 2D bbox projection (EdgeSE3CuboidProj, g2o_Object.cpp:
  118-153): the cuboid's 8 projected corners bounded to [cx cy w h] against
  the detected box; Huber delta 30 px, sqrt-information
  sqrt(camera_object_BA_weight) * quality (Optimizer.cc:1279-1366),
* object-point hinge, unary (EdgePointCuboidOnlyObject, points constant;
  the default) or binary (EdgePointCuboid, `po_binary=True`: points move
  too and enter the Schur system through the generalized coupling W),
* optional 9-DoF camera-cuboid measurements (EdgeSE3Cuboid, `meas_*`) and
  the reference's 0.2 * scale shape prior per free-scale object.

Cameras and objects form the reduced block (D = Kf*6 + O*9); points are
eliminated as in graph/ba.py. The reprojection Jacobians are closed form
(pinhole + left SE3 tangent, as ba.local_ba_points); the bbox, hinge and
measurement families take theirs from torch.func.jacfwd over the port's
models/cuboid.py at the zero tangent, as the JAX package takes them from
jax.jacfwd. Segment sums go through ba._accumulate (a fixed order on the
card); the LM accepts or rejects each step with torch.where, so nothing is
read back inside a solve.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..models import cuboid as cb
from ..utils import geometry as geo
from ..utils import profiler
from .ba import (CHI2_MONO, HUBER_MONO, _cholesky_solve, _neg_hat, _segment_sum, huber_weight,
                 inv3_sym, project)

HUBER_BBOX = 30.0
# effectively quadratic: the reference's point-cuboid edge has identity
# information and no robust kernel (Optimizer.cc:1245-1247); the
# scale-normalized truncated hinge is already bounded per axis
HUBER_PT_OBJ = 10.0
# weak shape prior of the reference's indoor branch (g2o_Object.cpp:318-327)
PRIOR_SHAPE_W = 0.2
HUBER_MEAS = 1.0  # the 9-DoF measurement log error is in meters/radians


def _robust_cost(r, delta, valid):
    chi2 = torch.sum(r * r, dim=-1)
    e = torch.sqrt(torch.clamp(chi2, min=1e-18))
    rho = torch.where(e <= delta, chi2, 2 * delta * e - delta * delta)
    return torch.sum(rho * valid)


def _reproj(kf_tcw, pts, K, obs_kf, obs_pt):
    """Per-edge projection: (uv (E, 2), camera-frame point (E, 3))."""
    uv, pc = project(kf_tcw[obs_kf], K, pts[obs_pt][:, None, :])
    return uv[:, 0], pc[:, 0]


def _hinge(cub, p, binary):
    """Point-object hinge per axis, scale-normalized as the reference
    (g2o_Object.cpp:300-327, 356-369): unary err/scale, binary
    |err|/scale + 0.2*scale. p: (..., 3)."""
    err = cb.point_boundary_error(cub, p[..., None, :])[..., 0, :]
    if binary:
        return torch.abs(err) / torch.clamp(cub.scale, min=1e-6) + 0.2 * cub.scale
    return err / torch.clamp(cub.scale, min=1e-6)


def _meas_residuals(state, K, meas_kf, meas_obj, meas_pose, meas_scale, meas_si, meas_valid):
    """Camera-cuboid 9-DoF measurement edges (EdgeSE3Cuboid): the detector's
    camera-frame cuboid lifted into the world through the camera pose, vs
    the landmark (min_log_error over the 4 yaw re-representations)."""
    kf_tcw, _, obj_pose, obj_scale = state
    lifted = cb.transform_from(cb.Cuboid(meas_pose, meas_scale), geo.inv_T(kf_tcw[meas_kf]))
    landmark = cb.Cuboid(obj_pose[meas_obj], obj_scale[meas_obj])
    err = cb.min_log_error(landmark, lifted)
    return err * meas_si[:, None] * meas_valid.to(err.dtype)[:, None]


def _shape_prior_residual(obj_scale, obj_valid, obj_fix_scale):
    """Per-object 0.2 * scale residual (zero for invalid / fixed-scale
    objects)."""
    on = (obj_valid & ~obj_fix_scale).to(obj_scale.dtype)
    return PRIOR_SHAPE_W * obj_scale * on[:, None]


def residual_families(state, K, obs_kf, obs_pt, obs_uv, obs_si, obs_valid,
                      box_kf, box_obj, box_meas, box_si, box_valid,
                      po_obj, po_pt, po_si, po_valid, po_binary=False):
    """Raw (un-robustified) residuals of the reprojection, bbox and
    point-object families."""
    kf_tcw, pts, obj_pose, obj_scale = state
    uv, _ = _reproj(kf_tcw, pts, K, obs_kf, obs_pt)
    r_r = (uv - obs_uv) * obs_si[:, None]
    cub_b = cb.Cuboid(obj_pose[box_obj], obj_scale[box_obj])
    rect = cb.project_onto_image_bbox(cub_b, kf_tcw[box_kf], K)
    r_b = (rect - box_meas) * box_si[:, None]
    cub_p = cb.Cuboid(obj_pose[po_obj], obj_scale[po_obj])
    r_p = _hinge(cub_p, pts[po_pt], po_binary) * po_si[:, None]
    return r_r, r_b, r_p


def total_robust_cost(state, K, obs_edges, box_edges, po_edges,
                      po_binary=False, obj_flags=None, prior_factor=1.0,
                      meas_edges=None):
    """Sum of robustified costs. obj_flags = (obj_valid, obj_fix_scale)
    adds the 0.2*scale shape prior (plain quadratic, one per object)."""
    obs_valid, box_valid, po_valid = obs_edges[-1], box_edges[-1], po_edges[-1]
    r_r, r_b, r_p = residual_families(state, K, *obs_edges, *box_edges, *po_edges,
                                      po_binary=po_binary)
    cost = (_robust_cost(r_r, HUBER_MONO, obs_valid)
            + _robust_cost(r_b, HUBER_BBOX, box_valid)
            + _robust_cost(r_p, HUBER_PT_OBJ, po_valid))
    if obj_flags is not None:
        r_s = _shape_prior_residual(state[3], *obj_flags)
        cost = cost + torch.sum((prior_factor * r_s) ** 2)
    if meas_edges is not None:
        r_m = _meas_residuals(state, K, *meas_edges)
        cost = cost + _robust_cost(r_m, HUBER_MEAS, meas_edges[-1])
    return cost


def _reproj_jacobians(kf_tcw, pts, K, obs_kf, obs_pt, obs_si, w):
    """Closed-form blocks of the weighted reprojection residual
    (uv - meas) * si * w with respect to the left camera tangent (E, 2, 6)
    and the point (E, 2, 3); the robust weight w is held constant."""
    uv, pc = _reproj(kf_tcw, pts, K, obs_kf, obs_pt)
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])[:, None, None]
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=pc.dtype, device=pc.device)
    # d uv_i / d pc = (K_i - uv_i e3) / z
    J_pc = (K[:2] - uv[:, :, None] * e3) / z * (obs_si * w)[:, None, None]  # (E, 2, 3)
    Jc = torch.cat([J_pc @ _neg_hat(pc), J_pc], dim=-1)
    Jp = J_pc @ kf_tcw[obs_kf][:, :3, :3]
    return Jc, Jp


def _jac(fn, m, n, *args):
    """Per-edge Jacobian (E, m, n) of fn(dx, *edge_args) (m residuals) at
    dx = 0 (n entries), batched over the E edges (vmap needs E > 0)."""
    x0 = torch.zeros(n, dtype=torch.float32, device=args[0].device)
    if args[0].shape[0] == 0:
        return torch.zeros((0, m, n), dtype=torch.float32, device=x0.device)
    return vmap(lambda *a: jacfwd(lambda dx: fn(dx, *a))(x0))(*args)


def _blocks(Jc, Jo, r_w, seg_c, seg_o, Kf, O):
    """Segment-summed camera, object and cross blocks of one family:
    (Hcc (Kf, 6, 6), Hoo (O, 9, 9), Hco (Kf, O, 6, 9), bc (Kf, 6),
    bo (O, 9))."""
    Hcc = _segment_sum(torch.einsum("eai,eaj->eij", Jc, Jc), seg_c, Kf)
    Hoo = _segment_sum(torch.einsum("eai,eaj->eij", Jo, Jo), seg_o, O)
    Hco = _segment_sum(torch.einsum("eai,eaj->eij", Jc, Jo), seg_c * O + seg_o, Kf * O)
    bc = _segment_sum(torch.einsum("eai,ea->ei", Jc, r_w), seg_c, Kf)
    bo = _segment_sum(torch.einsum("eai,ea->ei", Jo, r_w), seg_o, O)
    return Hcc, Hoo, Hco.reshape(Kf, O, 6, 9), bc, bo


def _block_diag(blocks):
    """(n, b, b) -> (n*b, n*b) block-diagonal matrix."""
    n, b, _ = blocks.shape
    out = torch.zeros((n, b, n, b), dtype=blocks.dtype, device=blocks.device)
    ar = torch.arange(n, device=blocks.device)
    out[ar, :, ar, :] = blocks
    return out.reshape(n * b, n * b)


def assemble_normal_blocks(state, K, Kf, P, O,
                           obs_edges, box_edges, po_edges, po_binary=False,
                           obj_flags=None, prior_factor=1.0, meas_edges=None):
    """Per-edge Jacobians -> summed normal-equation blocks.

    Returns (H_C, b_C, Hpp, bp, W): the camera+object system (D = Kf*6 +
    O*9), the point diagonal blocks and gradient, and the generalized
    coupling W (D, P, 3): camera rows from the reprojection family, object
    rows from the binary point-cuboid family (zero when po_binary=False)."""
    (obs_kf, obs_pt, obs_uv, obs_si, obs_valid) = obs_edges
    (box_kf, box_obj, box_meas, box_si, box_valid) = box_edges
    (po_obj, po_pt, po_si, po_valid) = po_edges
    kf_tcw, pts, obj_pose, obj_scale = state
    obs_kf, obs_pt = obs_kf.long(), obs_pt.long()
    box_kf, box_obj = box_kf.long(), box_obj.long()
    po_obj, po_pt = po_obj.long(), po_pt.long()
    f32 = torch.float32

    r_r, r_b, r_p = residual_families(state, K, obs_kf, obs_pt, obs_uv, obs_si, obs_valid,
                                      box_kf, box_obj, box_meas, box_si, box_valid,
                                      po_obj, po_pt, po_si, po_valid, po_binary=po_binary)

    # reprojection family: camera (2, 6) and point (2, 3) blocks
    w_r = huber_weight(torch.sum(r_r * r_r, dim=-1), HUBER_MONO) * obs_valid.to(f32)
    Jc_r, Jp_r = _reproj_jacobians(kf_tcw, pts, K, obs_kf, obs_pt, obs_si, w_r)
    rr_w = r_r * w_r[:, None]
    Hcc = _segment_sum(torch.einsum("eai,eaj->eij", Jc_r, Jc_r), obs_kf, Kf)
    Hpp = _segment_sum(torch.einsum("eai,eaj->eij", Jp_r, Jp_r), obs_pt, P)
    bc = _segment_sum(torch.einsum("eai,ea->ei", Jc_r, rr_w), obs_kf, Kf)
    bp = _segment_sum(torch.einsum("eai,ea->ei", Jp_r, rr_w), obs_pt, P)
    W_cam = _segment_sum(torch.einsum("eai,eaj->eij", Jc_r, Jp_r), obs_kf * P + obs_pt, Kf * P)
    W = W_cam.reshape(Kf, P, 6, 3).permute(0, 2, 1, 3).reshape(Kf * 6, P, 3)

    # bbox family: camera (4, 6) and object (4, 9) blocks
    def bbox_local(dx, T, opose, oscale, meas, si, w):
        T2 = geo.se3_exp(dx[:6]) @ T
        cub = cb.exp_update(cb.Cuboid(opose, oscale), dx[6:])
        return (cb.project_onto_image_bbox(cub, T2, K) - meas) * si * w

    w_b = huber_weight(torch.sum(r_b * r_b, dim=-1), HUBER_BBOX) * box_valid.to(f32)
    J_b = _jac(bbox_local, 4, 15, kf_tcw[box_kf], obj_pose[box_obj], obj_scale[box_obj],
               box_meas, box_si, w_b)
    Hcc_b, Hoo_b, Hco_b, bc_b, bo_b = _blocks(J_b[..., :6], J_b[..., 6:], r_b * w_b[:, None],
                                              box_kf, box_obj, Kf, O)

    # point-object family: object (3, 9) blocks and, binary, point (3, 3).
    # As in the JAX package, the unary Jacobian is that of the hinge before
    # its division by the scale (the residual itself is divided).
    def po_local(dx, opose, oscale, p, si, w):
        cub = cb.exp_update(cb.Cuboid(opose, oscale), dx[:9])
        if po_binary:
            return _hinge(cub, p + dx[9:], True) * si * w
        return cb.point_boundary_error(cub, p[None, :])[0] * si * w

    w_p = huber_weight(torch.sum(r_p * r_p, dim=-1), HUBER_PT_OBJ) * po_valid.to(f32)
    rp_w = r_p * w_p[:, None]
    J_po = _jac(po_local, 3, 12 if po_binary else 9, obj_pose[po_obj], obj_scale[po_obj],
                pts[po_pt], po_si, w_p)
    Jo_p = J_po[..., :9]
    Hoo_p = _segment_sum(torch.einsum("eai,eaj->eij", Jo_p, Jo_p), po_obj, O)
    bo_p = _segment_sum(torch.einsum("eai,ea->ei", Jo_p, rp_w), po_obj, O)

    Hcc = Hcc + Hcc_b
    Hoo = Hoo_b + Hoo_p
    Hco = Hco_b
    bc = bc + bc_b
    bo = bo_b + bo_p

    # 9-DoF camera-cuboid measurement family: camera (9, 6), object (9, 9)
    if meas_edges is not None:
        (meas_kf, meas_obj, meas_pose, meas_scale, meas_si, meas_valid) = meas_edges
        meas_kf, meas_obj = meas_kf.long(), meas_obj.long()

        def meas_local(dx, T, mpose, mscale, opose, oscale, si, w):
            T2 = geo.se3_exp(dx[:6]) @ T
            lifted = cb.transform_from(cb.Cuboid(mpose, mscale), geo.inv_T(T2))
            cub = cb.exp_update(cb.Cuboid(opose, oscale), dx[6:])
            return cb.min_log_error(cub, lifted) * si * w

        r_m = _meas_residuals(state, K, meas_kf, meas_obj, meas_pose, meas_scale, meas_si, meas_valid)
        w_m = huber_weight(torch.sum(r_m * r_m, dim=-1), HUBER_MEAS) * meas_valid.to(f32)
        J_m = _jac(meas_local, 9, 15, kf_tcw[meas_kf], meas_pose, meas_scale, obj_pose[meas_obj],
                   obj_scale[meas_obj], meas_si, w_m)
        Hcc_m, Hoo_m, Hco_m, bc_m, bo_m = _blocks(J_m[..., :6], J_m[..., 6:], r_m * w_m[:, None],
                                                  meas_kf, meas_obj, Kf, O)
        Hcc, Hoo, Hco = Hcc + Hcc_m, Hoo + Hoo_m, Hco + Hco_m
        bc, bo = bc + bc_m, bo + bo_m

    cross = Hco.permute(0, 2, 1, 3).reshape(Kf * 6, O * 9)
    H_C = torch.cat([torch.cat([_block_diag(Hcc), cross], dim=1),
                     torch.cat([cross.T, _block_diag(Hoo)], dim=1)], dim=0)
    b_C = torch.cat([bc.reshape(-1), bo.reshape(-1)])

    # shape prior 0.2*scale: scale updates are additive (exp_update), so
    # J = f*0.2*I on each free object's scale sub-block
    if obj_flags is not None:
        r_s = prior_factor * _shape_prior_residual(obj_scale, *obj_flags)  # (O, 3)
        on = (obj_flags[0] & ~obj_flags[1]).to(f32)
        oidx = (Kf * 6 + torch.arange(O, device=on.device)[:, None] * 9
                + torch.arange(6, 9, device=on.device)[None, :]).reshape(-1)
        H_C[oidx, oidx] = H_C[oidx, oidx] + torch.repeat_interleave(
            (prior_factor * PRIOR_SHAPE_W) ** 2 * on, 3)
        b_C[oidx] = b_C[oidx] + (prior_factor * PRIOR_SHAPE_W) * r_s.reshape(-1)

    if po_binary:
        Jp_po = J_po[..., 9:]
        Hpp = Hpp + _segment_sum(torch.einsum("eai,eaj->eij", Jp_po, Jp_po), po_pt, P)
        bp = bp + _segment_sum(torch.einsum("eai,ea->ei", Jp_po, rp_w), po_pt, P)
        W_obj = _segment_sum(torch.einsum("eai,eaj->eij", Jo_p, Jp_po), po_obj * P + po_pt, O * P)
        W_obj = W_obj.reshape(O, P, 9, 3).permute(0, 2, 1, 3).reshape(O * 9, P, 3)
    else:
        W_obj = torch.zeros((O * 9, P, 3), dtype=f32, device=W.device)
    return H_C, b_C, Hpp, bp, torch.cat([W, W_obj], dim=0)


def schur_reduce_solve(H_C, b_C, Hpp, bp, W, lam, C_mask, pt_mask, Kf, D):
    """Schur-eliminate points, solve the reduced camera+object system by
    Cholesky, and back-substitute the point updates. W (D, P, 3) is
    contracted as one (D, P*3) matrix."""
    P = Hpp.shape[0]
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_d = Hpp + (lam + 1e-6) * eye3 + (1.0 - pt_mask)[:, None, None] * eye3
    Hpp_inv = inv3_sym(Hpp_d) * pt_mask[:, None, None]
    Wm = W.reshape(D, P * 3)
    Ym = torch.einsum("dpi,pij->dpj", W, Hpp_inv).reshape(D, P * 3)
    H_red = H_C - Ym @ Wm.T
    rhs = -b_C + Ym @ bp.reshape(-1)

    A = H_red + lam * torch.eye(D, dtype=H_C.dtype, device=H_C.device)
    A = C_mask[:, None] * A * C_mask[None, :] + torch.diag(1.0 - C_mask)
    dC = _cholesky_solve(A, rhs * C_mask) * C_mask

    WT_dc = (Wm.T @ dC).reshape(P, 3)
    dp = torch.einsum("pij,pj->pi", Hpp_inv, -bp - WT_dc) * pt_mask[:, None]
    return dC, dp


def retract_state(state, dC, dp, Kf, O):
    kf_tcw, pts, obj_pose, obj_scale = state
    dc = dC[: Kf * 6].reshape(Kf, 6)
    do = dC[Kf * 6:].reshape(O, 9)
    cub = cb.exp_update(cb.Cuboid(obj_pose, obj_scale), do)
    return (geo.se3_exp(dc) @ kf_tcw, pts + dp, cub.pose, cub.scale)


def camera_object_mask(kf_fixed, obj_valid, obj_fix_scale, O):
    cam_mask = torch.repeat_interleave((~kf_fixed).to(torch.float32), 6)
    scale_keep = torch.cat([
        torch.ones((O, 6), dtype=torch.float32, device=kf_fixed.device),
        torch.where(obj_fix_scale[:, None], 0.0, 1.0).expand(O, 3)], dim=1)  # (O, 9)
    obj_mask = (obj_valid[:, None].to(torch.float32) * scale_keep).reshape(-1)
    return torch.cat([cam_mask, obj_mask])


def local_ba_objects(
    kf_tcw,          # (Kf, 4, 4)
    pts,             # (P, 3)
    obj_pose,        # (O, 4, 4) object->world
    obj_scale,       # (O, 3)
    K,               # (3, 3)
    # point reprojection edges
    obs_kf, obs_pt, obs_uv, obs_si, obs_valid,
    # camera-object bbox edges
    box_kf, box_obj, box_meas, box_si, box_valid,
    # object-point hinge edges
    po_obj, po_pt, po_si, po_valid,
    # masks
    kf_fixed, pt_valid, obj_valid, obj_fix_scale,
    num_iters: int = 10,
    po_binary: bool = False,
    meas_kf=None, meas_obj=None, meas_pose=None, meas_scale=None,
    meas_si=None, meas_valid=None,
):
    """Returns (kf_tcw, pts, obj_pose, obj_scale, cost, reproj_inlier,
    box_inlier). The optional meas_* tensors add 9-DoF camera-cuboid
    measurement edges (EdgeSE3Cuboid)."""
    Kf = kf_tcw.shape[0]
    P = pts.shape[0]
    O = obj_pose.shape[0]
    D = Kf * 6 + O * 9

    C_mask = camera_object_mask(kf_fixed, obj_valid, obj_fix_scale, O)
    pt_mask = pt_valid.to(torch.float32)
    obs_edges = (obs_kf.long(), obs_pt.long(), obs_uv, obs_si, obs_valid)
    box_edges = (box_kf.long(), box_obj.long(), box_meas, box_si, box_valid)
    po_edges = (po_obj.long(), po_pt.long(), po_si, po_valid)
    meas_edges = (None if meas_kf is None else
                  (meas_kf.long(), meas_obj.long(), meas_pose, meas_scale, meas_si, meas_valid))
    obj_flags = (obj_valid, obj_fix_scale)

    def total_cost(state):
        return total_robust_cost(state, K, obs_edges, box_edges, po_edges,
                                 po_binary=po_binary, obj_flags=obj_flags,
                                 meas_edges=meas_edges)

    state = (kf_tcw, pts, obj_pose, obj_scale)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=pts.device)
    cost = total_cost(state)
    profiler.count("lm_iters", num_iters)
    for _ in range(num_iters):
        with profiler.span("obj.ba.iter"):
            with profiler.span("obj.ba.assemble"):
                H_C, b_C, Hpp, bp, W = assemble_normal_blocks(
                    state, K, Kf, P, O, obs_edges, box_edges, po_edges,
                    po_binary=po_binary, obj_flags=obj_flags, meas_edges=meas_edges)
            with profiler.span("obj.ba.schur"):
                dC, dp = schur_reduce_solve(H_C, b_C, Hpp, bp, W, lam, C_mask, pt_mask, Kf, D)
            new_state = retract_state(state, dC, dp, Kf, O)
            new_cost = total_cost(new_state)
            accept = (new_cost < cost) & torch.isfinite(new_cost)
            state = tuple(torch.where(accept, a, b) for a, b in zip(new_state, state))
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            cost = torch.where(accept, new_cost, cost)

    raw_r, raw_b, _ = residual_families(state, K, *obs_edges, *box_edges, *po_edges,
                                        po_binary=po_binary)
    kf_tcw, pts, obj_pose, obj_scale = state
    return (
        kf_tcw, pts, obj_pose, obj_scale, cost,
        obs_valid & (torch.sum(raw_r * raw_r, dim=-1) <= CHI2_MONO),
        box_valid & (torch.sum(raw_b * raw_b, dim=-1) <= 900.0),
    )


def local_ba_objects_two_stage(
    kf_tcw, pts, obj_pose, obj_scale, K,
    obs_kf, obs_pt, obs_uv, obs_si, obs_valid,
    box_kf, box_obj, box_meas, box_si, box_valid,
    po_obj, po_pt, po_si, po_valid,
    kf_fixed, pt_valid, obj_valid, obj_fix_scale,
    po_binary: bool = False,
    meas_kf=None, meas_obj=None, meas_pose=None, meas_scale=None,
    meas_si=None, meas_valid=None,
):
    """The reference's optimize(5) -> prune outliers -> optimize(10)
    schedule (Optimizer.cc:1389-1444): reprojection edges with chi2 > 5.991
    and bbox edges with error norm > 80 px are dropped after the first
    stage, then the survivors are re-optimized. Returns the same tuple as
    local_ba_objects (inlier masks reflect the pruned sets). Spans:
    obj.ba.stage1, obj.ba.gate, obj.ba.stage2, each LM iteration an
    obj.ba.iter inside its stage."""
    meas_kw = dict(meas_kf=meas_kf, meas_obj=meas_obj, meas_pose=meas_pose,
                   meas_scale=meas_scale, meas_si=meas_si, meas_valid=meas_valid)
    masks = (kf_fixed, pt_valid, obj_valid, obj_fix_scale)
    with profiler.span("obj.ba.stage1"):
        kf1, pts1, op1, os1 = local_ba_objects(
            kf_tcw, pts, obj_pose, obj_scale, K,
            obs_kf, obs_pt, obs_uv, obs_si, obs_valid,
            box_kf, box_obj, box_meas, box_si, box_valid,
            po_obj, po_pt, po_si, po_valid, *masks,
            num_iters=5, po_binary=po_binary, **meas_kw)[:4]
    with profiler.span("obj.ba.gate"):
        # chi2 gates on the stage-1 state; the bbox gate is the raw pixel error
        raw_r, raw_b, _ = residual_families(
            (kf1, pts1, op1, os1), K,
            obs_kf.long(), obs_pt.long(), obs_uv, obs_si, obs_valid,
            box_kf.long(), box_obj.long(), box_meas, box_si, box_valid,
            po_obj.long(), po_pt.long(), po_si, po_valid, po_binary=po_binary)
        obs_keep = obs_valid & (torch.sum(raw_r * raw_r, dim=-1) <= CHI2_MONO)
        box_err = torch.linalg.vector_norm(raw_b / torch.clamp(box_si, min=1e-9)[:, None], dim=-1)
        box_keep = box_valid & (box_err <= 80.0)
    with profiler.span("obj.ba.stage2"):
        return local_ba_objects(
            kf1, pts1, op1, os1, K,
            obs_kf, obs_pt, obs_uv, obs_si, obs_keep,
            box_kf, box_obj, box_meas, box_si, box_keep,
            po_obj, po_pt, po_si, po_valid, *masks,
            num_iters=10, po_binary=po_binary, **meas_kw)
