"""Monocular two-view initialization — batched RANSAC.

PyTorch counterpart of cube_slam_tpu/slam/initializer.py, the re-design of
Initializer.cc (orb_object_slam/src/Initializer.cc:45 Initialize, :131
FindHomography, :181 FindFundamental, :474 ReconstructF, :579 ReconstructH,
:739 Triangulate): ALL RANSAC hypotheses for BOTH models are solved and
scored at once — 200 8-point SVDs are a (200, 9, 9) batch, symmetric-
transfer scoring is a (200, N) array — and model selection /
reconstruction follow the same chi-square gating and cheirality counting.

Singular vectors are defined up to sign, and LAPACK / cuSOLVER / XLA pick
different ones. Every score and test here is sign-invariant, and the F and
H hypothesis sets are closed under the sign flips, so results (success,
model, pose, inliers) agree with the JAX package, not the vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import geometry as geo

SIGMA = 1.0
TH_H = 5.991   # chi-square 2dof (Initializer.cc CheckHomography)
TH_F = 3.841   # chi-square 1dof (CheckFundamental)
TH_SCORE = 5.991


def _normalize_pts(pts, valid):
    """Hartley normalization (mean-center, mean-abs-deviation scale)."""
    n = torch.clamp(torch.sum(valid), min=1)
    mean = torch.sum(torch.where(valid[:, None], pts, 0.0), dim=0) / n
    d = torch.where(valid[:, None], pts - mean, 0.0)
    mdev = torch.sum(torch.abs(d), dim=0) / n
    s = 1.0 / torch.where(mdev > 1e-9, mdev, 1.0)
    pn = d * s
    z = torch.zeros((), dtype=pts.dtype, device=pts.device)
    o = torch.ones((), dtype=pts.dtype, device=pts.device)
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return pn, T


def _null_vectors(A):
    """Right singular vector of the smallest singular value of each (S, m, 9)
    system (full SVD: m may be < 9)."""
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[:, -1]


def _solve_h_batch(p1, p2):
    """DLT homographies from 8-point samples: p1, p2 (S, 8, 2) -> (S, 3, 3)."""
    S = p1.shape[0]
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (S, 16, 9)
    return _null_vectors(A).reshape(S, 3, 3)


def _solve_f_batch(p1, p2):
    """8-point fundamental matrices with rank-2 projection: (S, 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)  # (S, 8, 9)
    F = _null_vectors(A).reshape(-1, 3, 3)
    u, s, vt2 = torch.linalg.svd(F)
    s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=1)
    return u @ (s[..., None] * vt2)


def _homog(p):
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=1)


def _score_h(H, H_inv, p1, p2, valid, sigma=SIGMA):
    """Symmetric transfer error score (CheckHomography). H: (S, 3, 3);
    p1, p2: (N, 2). Returns (score (S,), inliers (S, N))."""
    ph1, ph2 = _homog(p1), _homog(p2)

    def transfer(M, src_h, dst):
        q = src_h @ M.transpose(-1, -2)  # (S, N, 3)
        w = q[..., 2:3]
        w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
        uv = q[..., :2] / w
        return torch.sum((uv - dst[None]) ** 2, dim=-1)  # (S, N)

    e12 = transfer(H, ph1[None], p2) / (sigma * sigma)
    e21 = transfer(H_inv, ph2[None], p1) / (sigma * sigma)
    ok = (e12 < TH_H) & (e21 < TH_H) & valid[None]
    sc = torch.where(e12 < TH_H, TH_SCORE - e12, 0.0) + torch.where(e21 < TH_H, TH_SCORE - e21, 0.0)
    return torch.sum(torch.where(valid[None], sc, 0.0), dim=1), ok


def _score_f(F, p1, p2, valid, sigma=SIGMA):
    """Epipolar distance score (CheckFundamental)."""
    ph1, ph2 = _homog(p1), _homog(p2)
    l2 = ph1[None] @ F.transpose(-1, -2)  # (S, N, 3) lines in img2
    num2 = torch.sum(l2 * ph2[None], dim=-1) ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    e2 = num2 / torch.where(den2 > 1e-12, den2, 1e-12) / (sigma * sigma)
    l1 = ph2[None] @ F  # lines in img1
    num1 = torch.sum(l1 * ph1[None], dim=-1) ** 2
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    e1 = num1 / torch.where(den1 > 1e-12, den1, 1e-12) / (sigma * sigma)
    ok = (e1 < TH_F) & (e2 < TH_F) & valid[None]
    sc = torch.where(e1 < TH_F, TH_SCORE - e1, 0.0) + torch.where(e2 < TH_F, TH_SCORE - e2, 0.0)
    return torch.sum(torch.where(valid[None], sc, 0.0), dim=1), ok


def triangulate(P1, P2, p1, p2):
    """Linear DLT triangulation (Initializer.cc:739-770) in the w=1 gauge:
    closed-form 3x3 normal equations. P1, P2: (..., 3, 4) projection
    matrices; p1, p2: (..., N, 2). -> (..., N, 3)."""
    rows = torch.stack(torch.broadcast_tensors(
        p1[..., 0, None] * P1[..., None, 2, :] - P1[..., None, 0, :],
        p1[..., 1, None] * P1[..., None, 2, :] - P1[..., None, 1, :],
        p2[..., 0, None] * P2[..., None, 2, :] - P2[..., None, 0, :],
        p2[..., 1, None] * P2[..., None, 2, :] - P2[..., None, 1, :],
    ), dim=-2)  # (..., N, 4, 4)
    rows = rows / (torch.linalg.norm(rows, dim=-1, keepdim=True) + 1e-12)
    M = rows[..., :3]
    b = -rows[..., 3]
    S = torch.einsum("...ij,...ik->...jk", M, M)
    y = torch.einsum("...ij,...i->...j", M, b)
    a, bb, c = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    d, e = S[..., 1, 1], S[..., 1, 2]
    f = S[..., 2, 2]
    A00 = d * f - e * e
    A01 = c * e - bb * f
    A02 = bb * e - c * d
    A11 = a * f - c * c
    A12 = bb * c - a * e
    A22 = a * d - bb * bb
    det = a * A00 + bb * A01 + c * A02
    det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    X = torch.stack(
        [
            A00 * y[..., 0] + A01 * y[..., 1] + A02 * y[..., 2],
            A01 * y[..., 0] + A11 * y[..., 1] + A12 * y[..., 2],
            A02 * y[..., 0] + A12 * y[..., 1] + A22 * y[..., 2],
        ],
        dim=-1,
    ) / det[..., None]
    return X


def _cheirality(R, t, K, p1, p2, inlier, sigma=SIGMA):
    """For a batch of (R, t) hypotheses (H, 3, 3)/(H, 3): count points in
    front of both cameras with finite depth & low reprojection error
    (CheckRT) and the 50th-largest triangulation parallax in degrees.
    Returns (n_good (H,), good (H, N), X (H, N, 3), parallax (H,))."""
    Hn = R.shape[0]
    dev = R.device
    P1 = K @ torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], dim=1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = triangulate(P1.expand(Hn, 3, 4), P2, p1.expand(Hn, -1, -1), p2.expand(Hn, -1, -1))
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = X2[..., 2]
    uv1 = X @ K.T
    uv1 = uv1[..., :2] / torch.where(torch.abs(uv1[..., 2:3]) < 1e-12, 1e-12, uv1[..., 2:3])
    uv2 = X2 @ K.T
    uv2 = uv2[..., :2] / torch.where(torch.abs(uv2[..., 2:3]) < 1e-12, 1e-12, uv2[..., 2:3])
    e1 = torch.sum((uv1 - p1) ** 2, dim=-1)
    e2 = torch.sum((uv2 - p2) ** 2, dim=-1)
    s2 = sigma * sigma
    good = (inlier & (z1 > 0) & (z2 > 0) & (e1 < 4.0 * TH_H * s2) & (e2 < 4.0 * TH_H * s2)
            & torch.isfinite(X).all(dim=-1))
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]  # camera-2 center in cam1 frame
    v2 = X - O2[:, None, :]
    n1 = torch.linalg.norm(X, dim=-1)
    n2 = torch.linalg.norm(v2, dim=-1)
    cospar = torch.sum(X * v2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)
    cos_sorted = torch.sort(torch.where(good, cospar, 1.0), dim=-1).values  # ascending cos
    n_good = torch.sum(good, dim=-1)
    idx = torch.clamp(torch.clamp(n_good - 1, max=50), 0, X.shape[1] - 1)
    c = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))
    return n_good, good, X, parallax_deg


def decompose_e(E):
    """E -> (R1, R2, t) (DecomposeE, Initializer.cc:913-940)."""
    u, _, vt = torch.linalg.svd(E)
    t = u[:, 2]
    t = t / torch.linalg.norm(t)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = torch.where(torch.linalg.det(R1) < 0, -R1, R1)
    R2 = torch.where(torch.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _h_hypotheses(H, K):
    """The 8 (R, t) motions of a homography (ReconstructH, Initializer.cc:
    579-737, Faugeras' decomposition) -> (8, 3, 3), (8, 3)."""
    dev = H.device
    A = torch.linalg.inv(K) @ H @ K
    U, dvec, Vt = torch.linalg.svd(A)
    s_det = torch.linalg.det(U) * torch.linalg.det(Vt.T)
    d1, d2, d3 = dvec[0], dvec[1], dvec[2]
    eps_h = 1e-9
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3 + eps_h), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3 + eps_h), min=0.0))
    aux_stheta = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / ((d1 + d3) * d2 + eps_h)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2 + eps_h)
    aux_sphi = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0)) \
        / (torch.abs(d1 - d3) * d2 + eps_h)
    cphi = (d1 * d3 - d2 * d2) / (torch.abs(d1 - d3) * d2 + eps_h)
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)

    def unit(v):
        n = torch.linalg.norm(v)
        return v / torch.where(n > 1e-9, n, 1.0)

    Rs, ts = [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            # case d' = +d2
            stheta = e1 * e3 * aux_stheta
            Rp = torch.stack([torch.stack([ctheta, zero, -stheta]),
                              torch.stack([zero, one, zero]),
                              torch.stack([stheta, zero, ctheta])])
            tp = (d1 - d3) * torch.stack([e1 * aux1, zero, -e3 * aux3])
            Rs.append(s_det * U @ Rp @ Vt)
            ts.append(unit(U @ tp))
            # case d' = -d2
            sphi = e1 * e3 * aux_sphi
            Rp2 = torch.stack([torch.stack([cphi, zero, sphi]),
                               torch.stack([zero, -one, zero]),
                               torch.stack([sphi, zero, -cphi])])
            tp2 = (d1 + d3) * torch.stack([e1 * aux1, zero, e3 * aux3])
            Rs.append(s_det * U @ Rp2 @ Vt)
            ts.append(unit(U @ tp2))
    return torch.stack(Rs), torch.stack(ts)


def initialize_two_view(p1, p2, valid, K, sample_idx, sigma=1.0):
    """Full two-view init: H & F RANSAC, model selection, reconstruction.

    p1, p2: (N, 2) matched keypoints (frame1 -> frame2); valid: (N,) bool;
    sample_idx: (n_ransac, 8) precomputed sample indices (host RNG).

    Returns dict: success, Tcw2 (4, 4) world->cam2 with cam1 = identity,
    points3d (N, 3), point_good (N,), used_H (bool), n_good."""
    sample_idx = sample_idx.to(torch.int64)
    p1n_all, T1 = _normalize_pts(p1, valid)
    p2n_all, T2 = _normalize_pts(p2, valid)
    s1 = p1n_all[sample_idx]  # (S, 8, 2)
    s2 = p2n_all[sample_idx]

    Hn = _solve_h_batch(s1, s2)
    H = torch.linalg.inv(T2) @ Hn @ T1            # denormalize (x2 = H x1)
    Fn = _solve_f_batch(s1, s2)
    F = T2.T @ Fn @ T1

    score_h, inl_h = _score_h(H, torch.linalg.inv(H), p1, p2, valid, sigma=sigma)
    score_f, inl_f = _score_f(F, p1, p2, valid, sigma=sigma)

    best_h = torch.argmax(score_h)
    best_f = torch.argmax(score_f)
    SH = score_h[best_h]
    SF = score_f[best_f]
    RH = SH / torch.where(SH + SF > 0, SH + SF, 1.0)
    use_H = RH > 0.40  # Initializer.cc:120

    # reconstruct from F (E-decomposition, 4 hypotheses)
    E = K.T @ F[best_f] @ K
    R1, R2, t = decompose_e(E)
    Rs_f = torch.stack([R1, R1, R2, R2])
    ts_f = torch.stack([t, -t, t, -t])
    # reconstruct from H: full Faugeras 8-motion decomposition
    Rs_h, ts_h = _h_hypotheses(H[best_h], K)

    # cheirality is scored on ALL matches, not only the model's inliers (see
    # initializer.py: only the off-plane minority can vote the wrong branch
    # of the planar two-fold ambiguity down)
    counts_f, goods_f, Xs_f, pars_f = _cheirality(Rs_f, ts_f, K, p1, p2, inl_f[best_f] | valid,
                                                  sigma=sigma)
    counts_h, goods_h, Xs_h, pars_h = _cheirality(Rs_h, ts_h, K, p1, p2, inl_h[best_h] | valid,
                                                  sigma=sigma)
    best_hyp_f = torch.argmax(counts_f)
    best_hyp_h = torch.argmax(counts_h)

    R_sel = torch.where(use_H, Rs_h[best_hyp_h], Rs_f[best_hyp_f])
    t_sel = torch.where(use_H, ts_h[best_hyp_h], ts_f[best_hyp_f])
    good_sel = torch.where(use_H, goods_h[best_hyp_h], goods_f[best_hyp_f])
    X_sel = torch.where(use_H, Xs_h[best_hyp_h], Xs_f[best_hyp_f])
    par_sel = torch.where(use_H, pars_h[best_hyp_h], pars_f[best_hyp_f])
    n_good = torch.sum(good_sel)

    # the winner must clearly dominate and carry real parallax (2.5 deg;
    # initializer.py explains both gates)
    n_inlier = torch.where(use_H, torch.sum(inl_h[best_h]), torch.sum(inl_f[best_f]))
    second_h = torch.sort(counts_h).values[-2]
    dominant_h = second_h.to(torch.float32) < 0.75 * counts_h[best_hyp_h].to(torch.float32)
    nsim_f = torch.sum(counts_f.to(torch.float32) > 0.7 * counts_f[best_hyp_f].to(torch.float32))
    dominant = torch.where(use_H, dominant_h, nsim_f == 1)
    success = ((n_good >= 30)
               & (n_good.to(torch.float32) > 0.5 * n_inlier.to(torch.float32))
               & (par_sel >= 2.5)
               & dominant)

    return {
        "success": success,
        "Tcw2": geo.make_T(R_sel, t_sel),
        "points3d": X_sel,
        "point_good": good_sel,
        "used_H": use_H,
        "n_good": n_good,
    }


def make_sample_indices(n_matches_valid_mask, n_ransac=200, n_sample=8, seed=0):
    """Host-side RANSAC sample indices over valid matches (the JAX
    package's numpy draws, so both packages see the same samples)."""
    rng = np.random.default_rng(seed)
    valid_idx = np.where(np.asarray(n_matches_valid_mask))[0]
    if len(valid_idx) < n_sample:
        return np.zeros((n_ransac, n_sample), dtype=np.int32)
    out = np.stack(
        [rng.choice(valid_idx, size=n_sample, replace=False) for _ in range(n_ransac)]
    )
    return out.astype(np.int32)
