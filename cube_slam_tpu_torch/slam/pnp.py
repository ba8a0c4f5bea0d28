"""PnP relocalization — batched EPnP-RANSAC + robust refinement.

PyTorch counterpart of cube_slam_tpu/slam/pnp.py's EPnP path, the
re-design of PnPsolver (orb_object_slam/src/PnPsolver.cc:338-1068: EPnP
control points + beta Gauss-Newton, RANSAC loop :164): every RANSAC
hypothesis is a 4-point EPnP solve — control-point barycentric lift, 12x12
null-space eigendecomposition, the three beta approximations each polished
by Gauss-Newton on the inter-control-point distance system, Horn alignment
— evaluated as one batch over all hypotheses, scored in parallel, and the
winner re-solved on its full inlier set, then polished by the robust pose
LM (graph/ba.pose_optimization). The JAX package's 6-point DLT variant is
`pnp_ransac_dlt` (1.5x larger minimal samples than EPnP's 4, and it fails
on near-planar 6-tuples the EPnP null-space handles).

Eigenvectors are defined up to sign; the beta seeds absorb the sign of
each null-space vector, so the recovered pose does not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import table
from ..graph import ba
from ..utils import geometry as geo

# the 6 unordered control-point pairs and the 10 beta-product monomials
_PAIR_I = np.array([0, 0, 0, 1, 1, 2])
_PAIR_J = np.array([1, 2, 3, 2, 3, 3])
_PROD_K = np.array([0, 0, 1, 0, 1, 2, 0, 1, 2, 3])
_PROD_L = np.array([0, 1, 1, 2, 2, 2, 3, 3, 3, 3])


def make_pnp_samples(valid_mask, n_ransac=128, seed=0, k=4):
    """Host-side RANSAC samples (the JAX package's numpy draws)."""
    rng = np.random.default_rng(seed)
    idx = np.where(np.asarray(valid_mask))[0]
    if len(idx) < k:
        return np.zeros((n_ransac, k), dtype=np.int32)
    return np.stack(
        [rng.choice(idx, size=k, replace=False) for _ in range(n_ransac)]
    ).astype(np.int32)


def _dlt_batch(Xw, uv):
    """Batched DLT: Xw (S, 6, 3), uv (S, 6, 2) NORMALIZED camera coords
    (K already removed) -> (R (S, 3, 3), t (S, 3)). The null vector's sign
    and scale are fixed through the determinant of its 3x3 block, then the
    rotation is orthonormalized by SVD (polar factor, sign-free)."""
    S = Xw.shape[0]
    X = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)  # (S, 6, 4)
    zeros = torch.zeros_like(X)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r1 = torch.cat([X, zeros, -u * X], dim=-1)  # (S, 6, 12)
    r2 = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (S, 12, 12)
    _, _, vt = torch.linalg.svd(A)
    P = vt[:, -1].reshape(S, 3, 4)
    # fix scale/sign: |det(P[:, :3])| = 1, det > 0
    scale = torch.abs(torch.linalg.det(P[:, :, :3])) ** (1.0 / 3.0)
    P = P / torch.where(scale > 1e-12, scale, 1e-12)[:, None, None]
    P = P * torch.sign(torch.linalg.det(P[:, :, :3]))[:, None, None]
    U, _, Vt = torch.linalg.svd(P[:, :, :3])
    return U @ Vt, P[:, :, 3]


def _horn_rt(A, B, w):
    """Weighted rigid alignment B ~ R @ A + t (compute_R_and_t,
    PnPsolver.cc:836-886), batched: A, B (S, n, 3), w (S, n)."""
    sw = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[:, None]
    ca = torch.sum(A * w[..., None], dim=1) / sw
    cb = torch.sum(B * w[..., None], dim=1) / sw
    H = ((A - ca[:, None]) * w[..., None]).transpose(1, 2) @ (B - cb[:, None])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.transpose(1, 2) @ U.transpose(1, 2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = Vt.transpose(1, 2) @ D @ U.transpose(1, 2)
    t = cb - (R @ ca[..., None])[..., 0]
    return R, t


def _solve_sym(A, b):
    """Batched solve; NaN for a singular system (a degenerate sample), as
    XLA's LU gives, where torch.linalg.solve would raise."""
    x, info = torch.linalg.solve_ex(A, b[..., None])
    return torch.where((info == 0)[..., None], x[..., 0], torch.nan)


def _gauss_newton_betas(L, rho, betas, iters=5):
    """Refine betas on the distance system (gauss_newton,
    PnPsolver.cc:929-1023): r = rho - L @ products(betas). Batched over
    leading dims of L (..., 6, 10), rho (..., 6), betas (..., 4)."""
    dev = L.device
    pk = torch.as_tensor(_PROD_K, device=dev)
    pl = torch.as_tensor(_PROD_L, device=dev)
    onehot_k = table(np.eye(4, dtype=np.float32)[_PROD_K], dev)  # (10, 4)
    onehot_l = table(np.eye(4, dtype=np.float32)[_PROD_L], dev)
    eye4 = torch.eye(4, device=dev)
    for _ in range(iters):
        prods = betas[..., pk] * betas[..., pl]
        r = rho - (L @ prods[..., None])[..., 0]
        # dp[m, n] = d prods_m / d b_n
        dp = onehot_k * betas[..., pl, None] + onehot_l * betas[..., pk, None]
        J = L @ dp  # (..., 6, 4)
        JtJ = J.transpose(-1, -2) @ J + 1e-9 * eye4
        betas = betas + _solve_sym(JtJ, (J.transpose(-1, -2) @ r[..., None])[..., 0])
    return betas


def _epnp_case_betas(L, rho):
    """The reference's three closed-form beta seeds (find_betas_approx_1/2/3,
    PnPsolver.cc:680-772) -> (..., 3, 4)."""
    def lsq(cols):
        A = L[..., cols]
        AtA = A.transpose(-1, -2) @ A + 1e-9 * torch.eye(len(cols), device=L.device)
        return _solve_sym(AtA, (A.transpose(-1, -2) @ rho[..., None])[..., 0])

    zero = torch.zeros_like(rho[..., 0])
    # approx_1: [b11 b12 b13 b14]
    b = lsq([0, 1, 3, 6])
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    s = torch.where(b[..., 0] < 0, -1.0, 1.0)
    b1c = torch.clamp(b1, min=1e-9)
    beta_a = torch.stack([b1, s * b[..., 1] / b1c, s * b[..., 2] / b1c, s * b[..., 3] / b1c], dim=-1)
    # approx_2: [b11 b12 b22]
    b = lsq([0, 1, 2])
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    b2 = torch.sqrt(torch.abs(b[..., 2])) * torch.where(b[..., 1] < 0, -1.0, 1.0)
    beta_b = torch.stack([b1, b2, zero, zero], dim=-1)
    beta_b = torch.where((b[..., 0] < 0)[..., None], -beta_b, beta_b)
    # approx_3: [b11 b12 b22 b13 b23]
    b = lsq([0, 1, 2, 3, 4])
    b1 = torch.sqrt(torch.abs(b[..., 0]))
    b2 = torch.sqrt(torch.abs(b[..., 2])) * torch.where(b[..., 1] < 0, -1.0, 1.0)
    b3 = b[..., 3] / torch.clamp(b1, min=1e-9)
    beta_c = torch.stack([b1, b2, b3, zero], dim=-1)
    beta_c = torch.where((b[..., 0] < 0)[..., None], -beta_c, beta_c)
    return torch.stack([beta_a, beta_b, beta_c], dim=-2)


def _epnp_rt(Xw, xn, w):
    """EPnP solves, batched: Xw (S, n, 3) world points, xn (S, n, 2)
    normalized image coords, w (S, n) weights (0 rows are padding).
    Returns (R (S, 3, 3), t (S, 3), ok (S,))."""
    S, n, _ = Xw.shape
    dev = Xw.device
    sw = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c0 = torch.sum(Xw * w[..., None], dim=1) / sw[:, None]
    Ac = Xw - c0[:, None]
    cov = (Ac * w[..., None]).transpose(1, 2) @ Ac / sw[:, None, None]
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    # floor the spread so planar/collinear sets still give a full basis
    sdev = torch.sqrt(torch.clamp(evals, min=1e-8))
    cw = torch.stack([
        c0,
        c0 + sdev[:, 2:3] * evecs[:, :, 2],
        c0 + sdev[:, 1:2] * evecs[:, :, 1],
        c0 + sdev[:, 0:1] * evecs[:, :, 0],
    ], dim=1)  # (S, 4, 3)
    # barycentric coordinates (compute_barycentric_coordinates, :382-404)
    C = (cw[:, 1:] - c0[:, None]).transpose(1, 2)  # (S, 3, 3)
    a123 = Ac @ torch.linalg.inv(C).transpose(1, 2)  # (S, n, 3)
    alphas = torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)  # (S, n, 4)

    # M matrix rows (fill_M, :406-427) in normalized intrinsics
    ones = torch.ones_like(xn[..., 0])
    zer = torch.zeros_like(xn[..., 0])
    gx = torch.stack([ones, zer, -xn[..., 0]], dim=-1)  # (S, n, 3)
    gy = torch.stack([zer, ones, -xn[..., 1]], dim=-1)
    sqw = torch.sqrt(w)[..., None, None]
    Mx = (alphas[..., :, None] * gx[..., None, :] * sqw).reshape(S, n, 12)
    My = (alphas[..., :, None] * gy[..., None, :] * sqw).reshape(S, n, 12)
    MtM = Mx.transpose(1, 2) @ Mx + My.transpose(1, 2) @ My
    _, V = torch.linalg.eigh(MtM)
    vs = V[:, :, :4].transpose(1, 2).reshape(S, 4, 4, 3)  # 4 null-space candidates

    # distance system L @ beta_products = rho (compute_L_6x10 / rho)
    dv = vs[:, :, _PAIR_I, :] - vs[:, :, _PAIR_J, :]            # (S, 4, 6, 3)
    rho = torch.sum((cw[:, _PAIR_I] - cw[:, _PAIR_J]) ** 2, dim=-1)  # (S, 6)
    L = torch.einsum("skpx,slpx->spkl", dv, dv)[:, :, _PROD_K, _PROD_L]  # (S, 6, 10)
    sym = table((_PROD_K != _PROD_L).astype(np.float32), dev)
    L = L * (1.0 + sym)

    betas0 = _epnp_case_betas(L, rho)  # (S, 3, 4)
    betas = _gauss_newton_betas(L[:, None], rho[:, None], betas0)

    # camera control points, then camera-frame points, per beta case
    cc = torch.einsum("sck,skpx->scpx", betas, vs)  # (S, 3, 4, 3)
    pc = alphas[:, None] @ cc  # (S, 3, n, 3)
    wc = w[:, None].expand(S, 3, n)
    # depth sign fix (compute_ccs/solve_for_sign, :774-812)
    flip = torch.sum(wc * torch.sign(pc[..., 2]), dim=-1) < 0
    pc = torch.where(flip[..., None, None], -pc, pc)
    Xw3 = Xw[:, None].expand(S, 3, n, 3)
    R, t = _horn_rt(Xw3.reshape(S * 3, n, 3), pc.reshape(S * 3, n, 3), wc.reshape(S * 3, n))
    R = R.reshape(S, 3, 3, 3)
    t = t.reshape(S, 3, 3)
    pc2 = Xw3 @ R.transpose(-1, -2) + t[:, :, None, :]
    z = torch.where(torch.abs(pc2[..., 2:3]) < 1e-9, 1e-9, pc2[..., 2:3])
    err = torch.sum((pc2[..., :2] / z - xn[:, None]) ** 2, dim=-1)
    errs = torch.sum(err * wc, dim=-1) / sw[:, None]  # (S, 3)
    best = torch.argmin(errs, dim=1)
    ar = torch.arange(S, device=dev)
    return R[ar, best], t[ar, best], torch.isfinite(errs[ar, best])


def pnp_ransac(pts_world, uv, valid, K, sample_idx, inlier_thresh_px=5.0):
    """EPnP-RANSAC (PnPsolver::iterate, :164-252): pts_world (N, 3), uv (N, 2)
    pixels, sample_idx (S, k>=4).

    Every hypothesis is a full EPnP solve on its k-point sample; the best by
    inlier count is re-solved by EPnP on ALL its inliers and then polished
    by the robust pose LM. Returns (Tcw (4, 4), inlier (N,), n_inlier)."""
    sample_idx = sample_idx.to(torch.int64)
    Kinv = torch.linalg.inv(K)
    uv_h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    xn = (uv_h @ Kinv.T)[:, :2]

    Xs = pts_world[sample_idx]              # (S, k, 3)
    us = xn[sample_idx]                     # (S, k, 2)
    ws = torch.ones(sample_idx.shape, dtype=pts_world.dtype, device=pts_world.device)
    R, t, ok = _epnp_rt(Xs, us, ws)

    pc = pts_world @ R.transpose(-1, -2) + t[:, None, :]  # (S, N, 3)
    z = torch.where(torch.abs(pc[..., 2:3]) < 1e-9, 1e-9, pc[..., 2:3])
    proj = (pc @ K.T)[..., :2] / z
    err = torch.linalg.norm(proj - uv[None], dim=-1)
    inl = (err < inlier_thresh_px) & (pc[..., 2] > 0) & valid[None]
    counts = torch.sum(inl, dim=1) * ok.to(torch.int64)
    best = torch.argmax(counts)

    # refine on the full inlier set (weights = mask; fixed shape)
    w_all = inl[best].to(pts_world.dtype)
    R2, t2, ok2 = _epnp_rt(pts_world[None], xn[None], w_all[None])
    use2 = ok2[0] & (torch.sum(w_all) >= 4)
    Tcw0 = geo.make_T(torch.where(use2, R2[0], R[best]), torch.where(use2, t2[0], t[best]))
    sqrt_info = torch.ones(uv.shape[0], dtype=torch.float32, device=uv.device)
    return ba.pose_optimization(Tcw0, K, pts_world, uv, sqrt_info, inl[best])


def pnp_ransac_dlt(pts_world, uv, valid, K, sample_idx, inlier_thresh_px=5.0):
    """6-point DLT-RANSAC, kept for comparison/fallback: pts_world (N, 3),
    uv (N, 2) pixels, sample_idx (S, 6). The best hypothesis by inlier count
    is polished by the robust pose LM. Returns (Tcw (4, 4), inlier (N,),
    n_inlier)."""
    sample_idx = sample_idx.to(torch.int64)
    Kinv = torch.linalg.inv(K)
    uv_h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    xn = (uv_h @ Kinv.T)[:, :2]
    R, t = _dlt_batch(pts_world[sample_idx], xn[sample_idx])

    pc = pts_world @ R.transpose(-1, -2) + t[:, None, :]
    z = torch.where(torch.abs(pc[..., 2:3]) < 1e-9, 1e-9, pc[..., 2:3])
    proj = (pc @ K.T)[..., :2] / z
    err = torch.linalg.norm(proj - uv[None], dim=-1)
    inl = (err < inlier_thresh_px) & (pc[..., 2] > 0) & valid[None]
    best = torch.argmax(torch.sum(inl, dim=1))

    Tcw0 = geo.make_T(R[best], t[best])
    sqrt_info = torch.ones(uv.shape[0], dtype=torch.float32, device=uv.device)
    return ba.pose_optimization(Tcw0, K, pts_world, uv, sqrt_info, inl[best])
