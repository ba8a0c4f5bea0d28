"""Bundle adjustment: pose-only LM and point BA with blocked Schur.

PyTorch counterpart of cube_slam_tpu/graph/ba.py, the re-design of
Optimizer.cc:

* `pose_optimization` — per-frame pose-only LM with Huber kernel and the
  4-round chi-square outlier re-leveling (Optimizer::PoseOptimization,
  Optimizer.cc:253-472: 4 x 10 iterations, outliers at 5.991 excluded
  between rounds), linearized once per round as in the JAX package.
  Several seeds solve at once as a leading batch dim.
* `local_ba_points` — camera+point BA (Optimizer::LocalBundleAdjustment,
  :474-824) as a dense-blocked Schur solver: closed-form 2x6/2x3 Jacobian
  blocks, segment-sum assembly of Hcc/Hpp/W, the reduced camera system
  S = Hcc - W Hpp^-1 W^T (dense grid, edge-pair list or device window),
  Cholesky on S, back-substitution for points.

Both Jacobians are the closed-form pinhole + left-SE3 derivative (the one
g2o's types hand-derive, types_six_dof_expmap.h). The JAX package forms the
pose Jacobian by jax.jacfwd; tests/test_torch_ba.py holds the closed form
equal to torch.func.jacfwd of the same residual to float rounding.

LM iterations are Python loops whose accept/reject goes through
torch.where; nothing is read back to the host inside a solve, and the
Cholesky factors come from torch.linalg.cholesky_ex (no error sync).
Segment sums add in the same order on every run (`_accumulate`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import geometry as geo

CHI2_MONO = 5.991
HUBER_MONO = float(np.sqrt(5.991))


def inv3_sym(A):
    """Closed-form inverse of a batch of symmetric positive-definite 3x3
    blocks (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    co_d = a * f - c * c
    co_e = b * c - a * e
    co_f = a * d - b * b
    row0 = torch.stack([co_a, co_b, co_c], dim=-1)
    row1 = torch.stack([co_b, co_d, co_e], dim=-1)
    row2 = torch.stack([co_c, co_e, co_f], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def huber_weight(chi2, delta=HUBER_MONO):
    """sqrt of the IRLS weight for the Huber kernel."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-18))
    return torch.where(e <= delta, 1.0, torch.sqrt(delta / e))


def robust_rho(chi2):
    """Huber-robustified cost of each squared error."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-18))
    return torch.where(e <= HUBER_MONO, chi2, 2 * HUBER_MONO * e - HUBER_MONO**2)


def _cholesky_solve(A, b):
    """Batched solve; NaN where the factor failed (graph/lm.py explains).
    torch leaves the unfactored block of L as it was, so the step of a
    failed factor would be finite; XLA's NaN factor makes every LM of the
    JAX package reject it, and the NaN here does the same."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where((info == 0)[..., None], x, torch.nan)


def project(Tcw, K, pts):
    """(..., 4, 4) poses, (..., N, 3) world points -> (uv (..., N, 2),
    camera-frame points (..., N, 3)); depth clamped away from 0 as
    ba._project."""
    pc = pts @ Tcw[..., :3, :3].transpose(-1, -2) + Tcw[..., None, :3, 3]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])
    uv = (pc @ K.T)[..., :2] / z[..., None]
    return uv, pc


def _neg_hat(pc):
    """-[pc]x: d(exp(dx) pc)/d omega at dx = 0, per point (..., 3, 3)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    O = torch.zeros_like(x)
    return torch.stack([
        torch.stack([O, z, -y], -1),
        torch.stack([-z, O, x], -1),
        torch.stack([y, -x, O], -1),
    ], dim=-2)


def pose_residual_jacobian(Tcw, K, pts_world, uv_meas, sqrt_info, active):
    """IRLS-weighted residual r (..., N, 2) and its Jacobian J (..., N, 2, 6)
    with respect to the left tangent dx of se3_exp(dx) @ Tcw at dx = 0, the
    robust weight frozen at Tcw (ba.pose_optimization's `residual`)."""
    uv, pc = project(Tcw, K, pts_world)
    r = (uv - uv_meas) * sqrt_info[..., None]
    chi2 = torch.sum(r * r, dim=-1)
    w = (huber_weight(chi2) * active)[..., None]
    z = torch.where(torch.abs(pc[..., 2]) < 1e-9, 1e-9, pc[..., 2])[..., None, None]
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=pc.dtype, device=pc.device)
    # d uv_i / d pc = (K_i - uv_i e3) / z
    J_pc = (K[:2] - uv[..., :, None] * e3) / z                    # (..., N, 2, 3)
    J_pc = J_pc * (sqrt_info[..., None] * w)[..., None]
    J = torch.cat([J_pc @ _neg_hat(pc), J_pc], dim=-1)             # (..., N, 2, 6)
    return r * w, J


def pose_optimization(Tcw0, K, pts_world, uv_meas, sqrt_info, valid,
                      num_rounds: int = 4, iters_per_round: int = 10):
    """Optimize camera poses against fixed map points.

    Tcw0 (4, 4) or a batch of seeds (B, 4, 4); pts_world (N, 3); uv_meas
    (N, 2); sqrt_info (N,) = 1/sigma per observation; valid (N,) — or each
    with the same leading batch dim as Tcw0.

    Returns (Tcw, inlier_mask, n_inliers), batched like Tcw0. Mirrors
    PoseOptimization's round structure: optimize, re-classify outliers at
    chi2 > 5.991, repeat with outliers excluded (they may return).

    Each round linearizes once, at the pose it starts from, as the JAX
    package does (its residual closes over the round's first pose, not the
    iterate): every iteration solves those normal equations with its own
    damping and applies the step to the current pose, and the robust cost
    at the new pose decides. On a weak frame this lands on another pose
    than an LM that relinearizes."""
    single = Tcw0.ndim == 2
    T = Tcw0[None] if single else Tcw0
    B = T.shape[0]
    dev = T.device
    eye6 = torch.eye(6, dtype=T.dtype, device=dev)

    def chi2_edges(T):
        uv, _ = project(T, K, pts_world)
        r = (uv - uv_meas) * sqrt_info[..., None]
        return torch.sum(r * r, dim=-1)

    def cost(T, active):
        return torch.sum(robust_rho(chi2_edges(T)) * active, dim=-1)

    active = valid.to(torch.float32).expand(B, -1) if valid.ndim == 1 else valid.to(torch.float32)
    for _ in range(num_rounds):
        lam = torch.full((B,), 1e-3, dtype=T.dtype, device=dev)
        chi = cost(T, active)
        r0, J = pose_residual_jacobian(T, K, pts_world, uv_meas, sqrt_info, active)
        J = J.reshape(B, -1, 6)
        r0 = r0.reshape(B, -1)
        # sums over the edges in a fixed order: a GEMM splits them by thread
        # count, and the round's accept decisions turn on the last bits
        H = torch.sum(J[..., :, None] * J[..., None, :], dim=1)
        g = torch.sum(J * r0[..., None], dim=1)
        for _ in range(iters_per_round):
            dx = _cholesky_solve(H + lam[:, None, None] * eye6, -g)
            T_new = geo.se3_exp(dx) @ T
            c_new = cost(T_new, active)
            accept = (c_new < chi) & torch.isfinite(c_new)
            T = torch.where(accept[:, None, None], T_new, T)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
            chi = torch.where(accept, c_new, chi)
        active = (valid & (chi2_edges(T) <= CHI2_MONO)).to(torch.float32)
    inlier = active > 0
    n_in = torch.sum(inlier, dim=-1)
    if single:
        return T[0], inlier[0], n_in[0]
    return T, inlier, n_in


# ---------------------------------------------------------------------------
# camera + point BA with blocked Schur complement
# ---------------------------------------------------------------------------

def make_schur_pairs(obs_pt, obs_valid, bucket=True):
    """Host-side edge-pair list for the SPARSE reduced-camera assembly:
    all ordered pairs (e1, e2) of valid edges observing the SAME point.
    Returns (pair_e1, pair_e2) int32, zero-padded to a pow2 bucket (padding
    pairs have e2 = -1 and are masked out)."""
    idx = np.where(np.asarray(obs_valid))[0].astype(np.int32)
    pts = np.asarray(obs_pt)[idx]
    order = np.argsort(pts, kind="stable")
    idx = idx[order]
    pts = pts[order]
    e1_list, e2_list = [], []
    start = 0
    n = len(idx)
    for i in range(1, n + 1):
        if i == n or pts[i] != pts[start]:
            seg = idx[start:i]
            if len(seg) >= 1:
                a, b = np.meshgrid(seg, seg, indexing="ij")
                e1_list.append(a.reshape(-1))
                e2_list.append(b.reshape(-1))
            start = i
    if e1_list:
        e1 = np.concatenate(e1_list)
        e2 = np.concatenate(e2_list)
    else:
        e1 = np.zeros(1, dtype=np.int32)
        e2 = np.zeros(1, dtype=np.int32)
    if bucket:
        Q = 1 << int(np.ceil(np.log2(max(len(e1), 64))))
        pad = Q - len(e1)
        if pad:
            e1 = np.concatenate([e1, np.zeros(pad, dtype=np.int32)])
            e2 = np.concatenate([e2, np.full(pad, -1, dtype=np.int32)])
    return e1.astype(np.int32), e2.astype(np.int32)


def _accumulate(out, idx, x):
    """out[idx[i]] += x[i], summed in the same order on every run. On CUDA
    index_add_ adds with atomics, whose run-to-run rounding flipped the
    tracker's discrete decisions (map points kept) between two runs on the
    card; index_put_(accumulate=True) sorts by index there instead. On the
    CPU index_add_ is the ordered one (index_put_ adds in parallel)."""
    if out.is_cuda:
        return out.index_put_((idx,), x, accumulate=True)
    return out.index_add_(0, idx, x)


def _segment_sum(x, seg, n):
    return _accumulate(torch.zeros((n,) + x.shape[1:], dtype=x.dtype, device=x.device), seg, x)


def local_ba_points(
    kf_tcw,        # (Kf, 4, 4)
    pts,           # (P, 3)
    K,             # (3, 3)
    obs_kf,        # (E,) int
    obs_pt,        # (E,) int
    obs_uv,        # (E, 2)
    obs_sqrt_info, # (E,)
    obs_valid,     # (E,) bool
    kf_fixed,      # (Kf,) bool — fixed camera vertices
    pt_valid,      # (P,) bool
    obs_z=None,    # (E,) optional metric depth measurements (0 = none)
    obs_z_si=None, # (E,) sqrt-info of the depth residual (0 disables)
    pair_e1=None,  # (Q,) edge-pair lists (make_schur_pairs): the reduced
    pair_e2=None,  # system then assembles sparsely; e2 < 0 is padding
    num_iters: int = 5,
    schur_window: int = 0,
):
    """Joint camera-point BA: monocular reprojection edges, plus an
    optional per-edge depth residual row (z_pred - z_meas) * z_si. The step
    of a failed Cholesky factor of the reduced camera system is rejected,
    as XLA's NaN factor makes JAX's LM do.

    The reduced camera system assembles from the dense (Kf, P) W grid by
    default (the tracker's), from an edge-pair list when `pair_e1/e2` are
    given, or by pairing each edge with the next `schur_window - 1` edges of
    the same point in point-sorted order when `schur_window > 0` (exact when
    no point has more observations than the window).

    Returns (kf_tcw, pts, chi2_final, edge_inlier)."""
    Kf = kf_tcw.shape[0]
    P = pts.shape[0]
    E = obs_kf.shape[0]
    dev, dt = pts.device, pts.dtype
    obs_kf = obs_kf.to(torch.int64)
    obs_pt = obs_pt.to(torch.int64)
    if obs_z is None:
        obs_z = torch.zeros((E,), dtype=dt, device=dev)
    if obs_z_si is None:
        obs_z_si = torch.zeros((E,), dtype=dt, device=dev)
    valid_f = obs_valid.to(dt)

    cam_mask = (~kf_fixed).to(dt)  # (Kf,)
    pt_mask = pt_valid.to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    if schur_window > 0 and pair_e1 is None:
        sort_key = torch.where(obs_valid, obs_pt, P)
        sched_order = torch.argsort(sort_key, stable=True)
        sched_pt = sort_key[sched_order]
    else:
        sched_order = sched_pt = None
    if pair_e1 is not None:
        pair_e1 = pair_e1.to(torch.int64)
        pair_e2 = pair_e2.to(torch.int64)

    def all_residuals(kf_tcw, pts):
        T_e = kf_tcw[obs_kf]
        p_e = pts[obs_pt]
        pc = (T_e[:, :3, :3] @ p_e[:, :, None])[..., 0] + T_e[:, :3, 3]
        z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        uv = (pc @ K.T)[:, :2] / z[:, None]
        r_uv = (uv - obs_uv) * obs_sqrt_info[:, None]
        r_z = (pc[:, 2] - obs_z) * obs_z_si
        r = torch.cat([r_uv, r_z[:, None]], dim=1)
        chi2 = torch.sum(r * r, dim=-1)
        w = huber_weight(chi2)
        return r * (w * valid_f)[:, None], chi2

    def robust_cost(kf_tcw, pts):
        _, chi2 = all_residuals(kf_tcw, pts)
        return torch.sum(robust_rho(chi2) * valid_f)

    def edge_jacobians(kf_tcw, pts):
        """Per-edge (r (3,), Jc (3,6), Jp (3,3)) at the zero local tangent,
        in closed form (ba.local_ba_points.edge_jacobians)."""
        T_e = kf_tcw[obs_kf]
        p_e = pts[obs_pt]
        r, chi2 = all_residuals(kf_tcw, pts)
        w = huber_weight(chi2) * valid_f
        R = T_e[:, :3, :3]
        pc = torch.einsum("eij,ej->ei", R, p_e) + T_e[:, :3, 3]
        x, y = pc[:, 0], pc[:, 1]
        z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
        zi = 1.0 / z
        zi2 = zi * zi
        fx, fy = K[0, 0], K[1, 1]
        O = torch.zeros_like(zi)
        I1 = torch.ones_like(zi)
        J_pc = torch.stack([
            torch.stack([fx * zi, O, -fx * x * zi2], -1) * obs_sqrt_info[:, None],
            torch.stack([O, fy * zi, -fy * y * zi2], -1) * obs_sqrt_info[:, None],
            torch.stack([O, O, I1], -1) * obs_z_si[:, None],
        ], dim=-2) * w[:, None, None]                            # (E, 3, 3)
        Jc = torch.cat([J_pc @ _neg_hat(pc), J_pc], dim=-1)      # (E, 3, 6)
        Jp = J_pc @ R                                            # (E, 3, 3)
        return r, Jc, Jp

    def lm_step(kf_tcw, pts, lam):
        r, Jc, Jp = edge_jacobians(kf_tcw, pts)
        Hcc = _segment_sum(torch.einsum("eai,eaj->eij", Jc, Jc), obs_kf, Kf)
        Hpp = _segment_sum(torch.einsum("eai,eaj->eij", Jp, Jp), obs_pt, P)
        bc = _segment_sum(torch.einsum("eai,ea->ei", Jc, r), obs_kf, Kf)
        bp = _segment_sum(torch.einsum("eai,ea->ei", Jp, r), obs_pt, P)
        W_blocks = torch.einsum("eai,eaj->eij", Jc, Jp)  # (E, 6, 3)

        Hpp_d = Hpp + (lam + 1e-6) * eye3 + (1.0 - pt_mask)[:, None, None] * eye3
        Hpp_inv = inv3_sym(Hpp_d) * pt_mask[:, None, None]

        if sched_order is not None:
            Hinv_e = Hpp_inv[obs_pt[sched_order]]           # (E, 3, 3)
            WH = W_blocks[sched_order] @ Hinv_e             # (E, 6, 3)
            k1 = obs_kf[sched_order]
            idxs = torch.arange(E, device=dev)
            S_flat = torch.zeros((Kf * Kf, 6, 6), dtype=dt, device=dev)
            for d in range(schur_window):
                j = torch.clamp(idxs + d, 0, E - 1)
                same = (sched_pt == sched_pt[j]) & (sched_pt < P) & (idxs + d < E)
                e2 = sched_order[j]
                contrib = (WH @ W_blocks[e2].transpose(-1, -2)) * same[:, None, None]
                k2 = obs_kf[e2]
                _accumulate(S_flat, k1 * Kf + k2, contrib)
                if d > 0:
                    _accumulate(S_flat, k2 * Kf + k1, contrib.transpose(-1, -2))
            S_off = S_flat.reshape(Kf, Kf, 6, 6)
            ypt = torch.einsum("pij,pj->pi", Hpp_inv, bp)
            z_e = torch.einsum("eij,ej->ei", W_blocks, ypt[obs_pt])
            rhs = -(bc - _segment_sum(z_e, obs_kf, Kf))
        elif pair_e1 is not None:
            pv = pair_e2 >= 0
            p2 = torch.clamp(pair_e2, min=0)
            Hinv_pair = Hpp_inv[obs_pt[pair_e1]]            # (Q, 3, 3)
            contrib = W_blocks[pair_e1] @ Hinv_pair @ W_blocks[p2].transpose(-1, -2)
            contrib = contrib * pv[:, None, None]
            seg = obs_kf[pair_e1] * Kf + obs_kf[p2]
            S_off = _segment_sum(contrib, seg, Kf * Kf).reshape(Kf, Kf, 6, 6)
            ypt = torch.einsum("pij,pj->pi", Hpp_inv, bp)
            z_e = torch.einsum("eij,ej->ei", W_blocks, ypt[obs_pt])
            rhs = -(bc - _segment_sum(z_e, obs_kf, Kf))
        else:
            # dense (Kf, P) block grid of W, contracted as one
            # (Kf*6, P*3) @ (P*3, Kf*6) matmul
            W = _segment_sum(W_blocks, obs_kf * P + obs_pt, Kf * P).reshape(Kf, P, 6, 3)
            Y = torch.einsum("kpij,pjl->kpil", W, Hpp_inv)  # (Kf, P, 6, 3)
            Ym = Y.permute(0, 2, 1, 3).reshape(Kf * 6, P * 3)
            Wm = W.permute(0, 2, 1, 3).reshape(Kf * 6, P * 3)
            S_off = (Ym @ Wm.T).reshape(Kf, 6, Kf, 6).permute(0, 2, 1, 3)
            rhs = -(bc - (Ym @ bp.reshape(-1)).reshape(Kf, 6))

        ar = torch.arange(Kf, device=dev)
        S = -S_off
        S[ar, ar] = S[ar, ar] + (Hcc + lam * eye6)

        cm = torch.repeat_interleave(cam_mask, 6)
        S_f = (S.permute(0, 2, 1, 3).reshape(Kf * 6, Kf * 6) * cm[:, None] * cm[None, :]
               + torch.diag(1.0 - cm))
        rhs_f = rhs.reshape(-1) * cm
        dc = _cholesky_solve(S_f, rhs_f) * cm
        dc_b = dc.reshape(Kf, 6)

        # back-substitute points: dp = Hpp^-1 (-bp - W^T dc)
        wtd_e = torch.einsum("eij,ei->ej", W_blocks, dc_b[obs_kf])
        WT_dc = _segment_sum(wtd_e, obs_pt, P)
        dp = torch.einsum("pij,pj->pi", Hpp_inv, -bp - WT_dc) * pt_mask[:, None]
        return geo.se3_exp(dc_b) @ kf_tcw, pts + dp

    lam = torch.tensor(1e-4, dtype=dt, device=dev)
    cost = robust_cost(kf_tcw, pts)
    for _ in range(num_iters):
        new_tcw, new_pts = lm_step(kf_tcw, pts, lam)
        new_cost = robust_cost(new_tcw, new_pts)
        accept = (new_cost < cost) & torch.isfinite(new_cost)
        kf_tcw = torch.where(accept, new_tcw, kf_tcw)
        pts = torch.where(accept, new_pts, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)
        cost = torch.where(accept, new_cost, cost)
    _, chi2 = all_residuals(kf_tcw, pts)
    chi2_th = torch.where(obs_z_si > 0, 7.815, CHI2_MONO)  # 3-dof vs 2-dof
    edge_inlier = obs_valid & (chi2 <= chi2_th)
    return kf_tcw, pts, cost, edge_inlier
