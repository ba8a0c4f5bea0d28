"""Sim3 solvers: Horn closed-form similarity + batched RANSAC.

PyTorch counterpart of cube_slam_tpu/slam/sim3.py, the re-design of
Sim3Solver (orb_object_slam/src/Sim3Solver.cc:224 ComputeSim3, :138
iterate): the loop-closing scale-aware alignment between two matched 3D
point sets. Every hypothesis (3-point minimal sample -> Horn) is solved and
scored at once, batched over a leading hypothesis dimension.

The 3x3 SVD is torch.linalg.svd: LAPACK's gesdd on the CPU, cuSOLVER's
batched Jacobi (`driver="gesvdj"`, one launch for all hypotheses) on the
card. R = V diag(1, 1, +-1) U^T is unique for distinct singular values, so
both agree with XLA's SVD up to rounding. cuSOLVER checks its info flag on
the host: a sync per call, a few per loop candidate. A degenerate fit (no
weight left) yields NaN, as in JAX, and the caller's inlier count rejects it.
"""

from __future__ import annotations

import torch

from ..graph.lm import lm_optimize
from ..utils import geometry as geo


def _svd(H):
    """torch.linalg.svd of (..., 3, 3) that returns NaN factors for a
    non-finite H (an empty weight set), as XLA's SVD does, where torch's
    would raise."""
    bad = ~torch.isfinite(H).all(dim=-1).all(dim=-1)
    H = torch.where(bad[..., None, None], 0.0, H)
    U, D, Vt = torch.linalg.svd(H, driver="gesvdj") if H.is_cuda else torch.linalg.svd(H)
    nan = torch.tensor(float("nan"), dtype=H.dtype, device=H.device)
    return (torch.where(bad[..., None, None], nan, U), torch.where(bad[..., None], nan, D),
            torch.where(bad[..., None, None], nan, Vt))


def _median(x):
    """jnp.median of a 1-D tensor: the mean of the two middle values when
    the length is even (torch.median returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * s[n // 2 - 1] + 0.5 * s[n // 2]


def horn_sim3(p1, p2, weights=None, fix_scale=False):
    """Closed-form similarity aligning p1 -> p2 (Horn 1987, as in
    Sim3Solver::ComputeSim3). p1, p2: (..., N, 3).

    Returns (s, R (..., 3, 3), t): p2 ~ s R p1 + t."""
    if weights is None:
        weights = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    w = weights[..., None]
    wsum = torch.sum(w, dim=-2, keepdim=True)
    c1 = torch.sum(p1 * w, dim=-2, keepdim=True) / wsum
    c2 = torch.sum(p2 * w, dim=-2, keepdim=True) / wsum
    q1 = (p1 - c1) * torch.sqrt(w)
    q2 = (p2 - c2) * torch.sqrt(w)
    H = q1.transpose(-1, -2) @ q2  # (..., 3, 3) cross-covariance
    U, D, Vt = _svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    S = torch.eye(3, dtype=H.dtype, device=H.device).expand(H.shape).clone()
    S[..., 2, 2] = torch.sign(det)
    R = V @ S @ Ut
    if fix_scale:
        s = torch.ones(H.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        num = torch.sum(D * torch.cat([torch.ones_like(D[..., :2]), torch.sign(det)[..., None]], dim=-1),
                        dim=-1)
        den = torch.sum(q1 * q1, dim=(-1, -2))
        s = num / torch.where(den > 1e-12, den, 1e-12)
    t = c2[..., 0, :] - s[..., None] * (R @ c1[..., 0, :, None])[..., 0]
    return s, R, t


def sim3_ransac(p1, p2, valid, sample_idx, inlier_thresh, fix_scale=False):
    """Batched Sim3 RANSAC between matched 3D point sets.

    p1, p2: (N, 3); sample_idx: (S, 3). Returns (s, R, t, inlier (N,),
    n_inlier) refined by Horn on the best hypothesis's inliers."""
    sample_idx = sample_idx.long()
    s, R, t = horn_sim3(p1[sample_idx], p2[sample_idx], fix_scale=fix_scale)  # batched over S
    pred = s[:, None, None] * (p1 @ R.transpose(-1, -2)) + t[:, None, :]
    err = torch.linalg.vector_norm(pred - p2[None], dim=-1)  # (S, N)
    inl = (err < inlier_thresh) & valid[None]
    best = torch.argmax(torch.sum(inl, dim=1))
    w = inl[best].to(torch.float32)
    s_f, R_f, t_f = horn_sim3(p1, p2, weights=w, fix_scale=fix_scale)
    pred_f = s_f * (p1 @ R_f.T) + t_f
    inlier = (torch.linalg.vector_norm(pred_f - p2, dim=-1) < inlier_thresh) & valid
    return s_f, R_f, t_f, inlier, torch.sum(inlier)


def sim3_ransac_px(p1, p2, uv1, uv2, Tcw1, Tcw2, K, valid, sample_idx,
                   max_err2_px=9.21 * 2.0, fix_scale=False):
    """Sim3 RANSAC scored by both-way pixel reprojection, the reference's
    acceptance rule (Sim3Solver::CheckInliers, Sim3Solver.cc:~296-330: an
    inlier must reproject within chi2 in both images).

    p1, p2: (N, 3) matched world points of the two keyframes; uv1, uv2
    their pixel observations; Tcw1/Tcw2 the keyframes' world->camera poses.
    The returned Sim3 maps p1's world onto p2's world.
    Returns (s, R, t, inlier (N,), n_inlier)."""
    sample_idx = sample_idx.long()
    s, R, t = horn_sim3(p1[sample_idx], p2[sample_idx], fix_scale=fix_scale)  # (S,), (S,3,3), (S,3)

    def project(Tcw, pw):
        pc = pw @ Tcw[:3, :3].T + Tcw[:3, 3]
        z = torch.where(torch.abs(pc[..., 2:3]) < 1e-9, 1e-9, pc[..., 2:3])
        return (pc @ K.T)[..., :2] / z, pc[..., 2]

    def score(si, Ri, ti):
        """Inlier mask of each hypothesis: si (...,), Ri (..., 3, 3)."""
        # p1 -> p2's world -> image 2
        uvh2, z2 = project(Tcw2, sim3_apply(si, Ri, ti, p1))
        e2 = torch.sum((uvh2 - uv2) ** 2, dim=-1)
        # p2 -> p1's world -> image 1
        uvh1, z1 = project(Tcw1, sim3_apply(*sim3_inverse(si, Ri, ti), p2))
        e1 = torch.sum((uvh1 - uv1) ** 2, dim=-1)
        return (e1 < max_err2_px) & (e2 < max_err2_px) & (z1 > 0) & (z2 > 0) & valid

    inl = score(s, R, t)  # (S, N)
    best = torch.argmax(torch.sum(inl, dim=1))
    w = inl[best].to(torch.float32)
    s_f, R_f, t_f = horn_sim3(p1, p2, weights=w, fix_scale=fix_scale)
    inlier = score(s_f, R_f, t_f)
    return s_f, R_f, t_f, inlier, torch.sum(inlier)


def sim3_ransac_trimmed(p1, p2, valid, sample_idx, fix_scale=False,
                        refine_iters=4, rel_floor=0.01, rel_ceil=0.05):
    """Least-trimmed-squares Sim3 RANSAC on matched 3D map positions
    (the rationale against a pixel score is in the JAX package's docstring:
    old keyframes' stored poses are stale against the final map, while the
    map positions are the state the correction transforms).

    Per-hypothesis Horn (3-point minimal samples), scored by the sum of the
    smallest half of the residuals, then re-fit `refine_iters` times on the
    current best half. Inliers are reported against max(2.5 * h-th error,
    rel_floor * scene) capped at rel_ceil * scene.

    Returns (s, R, t, inlier (N,), n_inlier)."""
    N = p1.shape[0]
    h = max(4, N // 2)
    BIG = 1e9

    def errs(s, R, t):
        e = torch.linalg.vector_norm(s * (p1 @ R.T) + t - p2, dim=-1)
        return torch.where(valid, e, BIG)

    sample_idx = sample_idx.long()
    s, R, t = horn_sim3(p1[sample_idx], p2[sample_idx], fix_scale=fix_scale)  # batched over S
    pred = s[:, None, None] * (p1 @ R.transpose(-1, -2)) + t[:, None, :]
    err = torch.where(valid[None], torch.linalg.vector_norm(pred - p2[None], dim=-1), BIG)
    trimmed_cost = torch.sum(torch.sort(err, dim=1).values[:, :h], dim=1)
    best = torch.argmin(trimmed_cost)

    s_f, R_f, t_f = s[best], R[best], t[best]
    for _ in range(refine_iters):
        e = errs(s_f, R_f, t_f)
        tau = torch.sort(e).values[h - 1]
        w = ((e <= tau) & valid).to(torch.float32)
        s_f, R_f, t_f = horn_sim3(p1, p2, weights=w, fix_scale=fix_scale)
    e = errs(s_f, R_f, t_f)
    # the median includes the zeros written for invalid rows, as in JAX
    scene = _median(torch.where(valid, torch.linalg.vector_norm(p2 - torch.mean(p2, dim=0), dim=-1), 0.0))
    kth = torch.sort(e).values[h - 1]
    tau = torch.minimum(torch.maximum(2.5 * kth, rel_floor * scene), rel_ceil * scene)
    inlier = (e < tau) & valid
    # final fit on the reported inliers
    s_f, R_f, t_f = horn_sim3(p1, p2, weights=inlier.to(torch.float32), fix_scale=fix_scale)
    inlier = (errs(s_f, R_f, t_f) < tau) & valid
    return s_f, R_f, t_f, inlier, torch.sum(inlier)


# ---------------------------------------------------------------------------
# Sim3 pose-graph pieces (OptimizeEssentialGraph, Optimizer.cc:2575)
# ---------------------------------------------------------------------------

def optimize_sim3_relative(
    s0, R0, t0,          # initial Sim3: cam1-frame points -> cam2 frame
    pts1_cam, pts2_cam,  # (N, 3) matched map points in each camera frame
    uv1, uv2,            # (N, 2) their pixel observations in each image
    K, valid,
    num_iters: int = 10,
    fix_scale: bool = False,
    huber_px: float = 3.0,
):
    """Optimizer::OptimizeSim3 (Optimizer.cc:2838-3035): refine a relative
    Sim3 between two keyframes by reprojecting each one's matched map points
    into the other image (both directions), robust kernel, inliers gated at
    chi2 9.21 (2 dof, 99%). Returns (s, R, t, inlier, n_inlier)."""
    s0 = torch.as_tensor(s0, dtype=torch.float32, device=R0.device)

    def project(pc):
        z = torch.where(torch.abs(pc[:, 2:3]) < 1e-9, 1e-9, pc[:, 2:3])
        return (pc @ K.T)[:, :2] / z

    v2 = torch.cat([valid, valid]).to(torch.float32)

    def residual(params):
        s, R, t = params
        # direction 1: cam1 points through the Sim3 into image 2
        r1 = project(sim3_apply(s, R, t, pts1_cam)) - uv2
        # direction 2: cam2 points through the inverse into image 1
        r2 = project(sim3_apply(*sim3_inverse(s, R, t), pts2_cam)) - uv1
        r = torch.cat([r1, r2], dim=0)
        chi2 = torch.sum(r * r, dim=-1)
        e = torch.sqrt(torch.clamp(chi2, min=1e-18))
        w = torch.where(e <= huber_px, 1.0, torch.sqrt(huber_px / e))
        return (r * (w.detach() * v2)[:, None]).reshape(-1)

    def retract(params, dx):
        s, R, t = params
        ds = torch.ones_like(dx[0]) if fix_scale else torch.exp(dx[0])
        return sim3_compose(ds, geo.so3_exp(dx[1:4]), dx[4:7], s, R, t)

    mask = torch.ones((7,), dtype=torch.bool, device=R0.device)
    if fix_scale:
        mask[0] = False
    res = lm_optimize(residual, retract, (s0, R0, t0), dim=7, num_iters=num_iters, param_mask=mask)
    s, R, t = res.params
    e1 = torch.sum((project(sim3_apply(s, R, t, pts1_cam)) - uv2) ** 2, dim=-1)
    e2 = torch.sum((project(sim3_apply(*sim3_inverse(s, R, t), pts2_cam)) - uv1) ** 2, dim=-1)
    inlier = valid & (e1 < 9.21) & (e2 < 9.21)
    return s, R, t, inlier, torch.sum(inlier)


def sim3_apply(s, R, t, pts):
    """pts (..., N, 3); s (...,); R (..., 3, 3); t (..., 3)."""
    return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]


def sim3_inverse(s, R, t):
    # reciprocal, not 1.0 / s: under torch.func a 0-dim tensor divided into
    # a Python float gets a float64 tangent
    Rinv = R.transpose(-1, -2)
    return torch.reciprocal(s), Rinv, -(Rinv @ t[..., None])[..., 0] / s[..., None]


def sim3_compose(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1) o (s2,R2,t2): apply 2 then 1. All broadcast-batched."""
    s1 = torch.as_tensor(s1, dtype=R1.dtype, device=R1.device)
    return s1 * s2, R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1
