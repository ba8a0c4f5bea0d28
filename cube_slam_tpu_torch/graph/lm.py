"""Dense Levenberg-Marquardt on manifolds — the factor-graph solver.

PyTorch counterpart of cube_slam_tpu/graph/lm.py (itself the replacement
for the vendored g2o SparseOptimizer + BlockSolverX + LinearSolverDense +
OptimizationAlgorithmLevenberg). A problem is:

  * `params`        — a tuple of state tensors (poses, cuboids, points),
  * `retract_fn`    — params x flat tangent (D,) -> params (manifold update;
                      fixed/padded coordinates are masked out),
  * `residual_fn`   — params -> whitened residual vector (R,)
                      (sqrt-information already applied; padded residuals 0).

One LM iteration builds J by forward-mode differentiation of the residual at
the zero tangent (torch.func.jacfwd), forms the normal equations densely,
solves by Cholesky with g2o's Levenberg damping policy (tau * max diag init,
rho-gated lambda updates — g2o/core/optimization_algorithm_levenberg.cpp),
and accepts or rejects the step with torch.where. The loop never reads a
value back to the host, so a CUDA solve queues all iterations without a
sync.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd


class LMResult(NamedTuple):
    params: object
    chi2: torch.Tensor          # final cost
    chi2_history: torch.Tensor  # (num_iters + 1,)
    lam_final: torch.Tensor


def _cholesky_solve(A, b):
    # cholesky_ex reports failure in a tensor instead of syncing to raise.
    # A failed factor leaves finite entries in L, so the step is set to NaN
    # there, as XLA's cho_factor fills a failed factor with NaN: the accept
    # test then rejects it
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.nan)


def lm_optimize(
    residual_fn: Callable,
    retract_fn: Callable,
    params,
    dim: int,
    num_iters: int = 10,
    tau: float = 1e-5,
    param_mask=None,
    diag_damping: bool = False,
):
    """Run LM. dim = tangent dimension D. param_mask: (D,) bool — False
    coordinates are frozen (fixed vertices / padding). Returns LMResult."""
    leaf = params[0] if isinstance(params, (tuple, list)) else params
    dtype, device = torch.float32, leaf.device
    if param_mask is None:
        param_mask = torch.ones((dim,), dtype=torch.bool, device=device)
    mask_f = param_mask.to(dtype)

    def whitened(params, dx):
        return residual_fn(retract_fn(params, dx * mask_f))

    zero_dx = torch.zeros((dim,), dtype=dtype, device=device)

    def chi2_of(params):
        r = residual_fn(params)
        return torch.sum(r * r)

    def build_normal_eqs(params):
        r = whitened(params, zero_dx)
        J = jacfwd(lambda dx: whitened(params, dx))(zero_dx)  # (R, D)
        g = J.T @ r
        H = J.T @ J
        return g, H

    def solve(H, g, lam):
        if diag_damping:
            damp = lam * torch.diagonal(H)
        else:
            damp = lam * torch.ones((dim,), dtype=H.dtype, device=device)
        # freeze masked-out coordinates with a unit diagonal
        A = H + torch.diag(damp + (1.0 - mask_f))
        A = mask_f[:, None] * A * mask_f[None, :] + torch.diag(1.0 - mask_f)
        return _cholesky_solve(A, -g * mask_f) * mask_f

    def select(accept, new, old):
        if isinstance(new, (tuple, list)):
            return type(new)(select(accept, n, o) for n, o in zip(new, old))
        return torch.where(accept, new, old)

    chi2 = chi2_of(params)
    hist = torch.zeros((num_iters + 1,), dtype=dtype, device=device)
    hist[0] = chi2
    lam = torch.tensor(tau, dtype=dtype, device=device)
    ni = torch.tensor(2.0, dtype=dtype, device=device)
    for i in range(num_iters):
        g, H = build_normal_eqs(params)
        if i == 0:
            # initial lambda: tau * max diag(H) at the initial params (g2o
            # computeLambdaInit)
            lam0 = tau * torch.max(torch.diagonal(H) * mask_f)
            lam = torch.where(lam0 > 0, lam0, tau)
        dx = solve(H, g, lam)
        new_params = retract_fn(params, dx)
        new_chi2 = chi2_of(new_params)
        # g2o rho gain: (chi2 - new) / (dx^T (lam dx - g))
        denom = torch.dot(dx, lam * dx - g) + 1e-12
        rho = (chi2 - new_chi2) / denom
        accept = (new_chi2 < chi2) & torch.isfinite(new_chi2)

        lam_acc = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam_rej = lam * ni
        lam = torch.where(accept, lam_acc, lam_rej)
        ni = torch.where(accept, 2.0, ni * 2.0)
        params = select(accept, new_params, params)
        chi2 = torch.where(accept, new_chi2, chi2)
        hist[i + 1] = chi2
    return LMResult(params=params, chi2=chi2, chi2_history=hist, lam_final=lam)


def gauss_newton_step(residual_fn, retract_fn, params, dim, param_mask=None, damping=1e-6):
    """Single damped GN step (for well-conditioned inner loops)."""
    leaf = params[0] if isinstance(params, (tuple, list)) else params
    device = leaf.device
    if param_mask is None:
        param_mask = torch.ones((dim,), dtype=torch.bool, device=device)
    mask_f = param_mask.to(torch.float32)
    zero_dx = torch.zeros((dim,), dtype=torch.float32, device=device)

    def whitened(dx):
        return residual_fn(retract_fn(params, dx * mask_f))

    r = whitened(zero_dx)
    J = jacfwd(whitened)(zero_dx)
    g = J.T @ r
    H = J.T @ J + damping * torch.eye(dim, device=device) + torch.diag(1.0 - mask_f)
    dx = _cholesky_solve(H, -g * mask_f) * mask_f
    return retract_fn(params, dx), torch.sum(r * r)
