"""A plain camera + point + cuboid bundle adjustment: the judge of the
port's object BA (`graph/object_ba.py::local_ba_objects_two_stage`).

CubeSLAM's LocalBACameraPointObjects (orb_object_slam/src/Optimizer.cc:
826-1534) with the semantics the port states for it:
- point reprojection, Huber delta sqrt(5.991), residual (uv - meas) * si;
- camera-object 2D box edges: the cuboid's 8 projected corners bounded to
  [cx cy w h] against the measured box, Huber delta 30 px;
- unary point-cuboid hinges (points constant in the family), the hinge
  divided by the scale in the residual and undivided in its Jacobian, as the
  port and the JAX package take it, Huber delta 10;
- the 0.2 x scale shape prior of each free-scale object, plain quadratic;
- 9-DoF camera-cuboid measurements (the smallest log error over the four
  yaw re-representations), Huber delta 1.
Cameras move on the left SE3 tangent [omega, v], cuboids on the right, with
additive half extents floored at 1 cm, points additively. Levenberg-
Marquardt with square-root IRLS robust weights: lambda 1e-4 (1e-4 + 1e-6 on
points), halved on an accepted step and quadrupled on a rejected one; 5
iterations, then reprojection edges over chi2 5.991 and box edges over 80 px
dropped, then 10 iterations.

Written apart from the port: every unknown in one dense system, assembled
from Jacobians that forward-mode differentiation takes of plain residual
functions, solved by one Cholesky factor, in float64. `precision` "tf32" or
"bfloat16" computes in float32 and rounds the operands of every product of
matrices to 10 or 7 mantissa bits (the control).
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap

CHI2_MONO = 5.991
HUBER_MONO = math.sqrt(CHI2_MONO)
HUBER_BBOX = 30.0
HUBER_PT_OBJ = 10.0
HUBER_MEAS = 1.0
PRIOR_SHAPE_W = 0.2
BOX_GATE_PX = 80.0
SCALE_FLOOR = 0.01
STAGES = (5, 10)

# the cuboid's unit corners, one per column (g2o_Object.h:164-168)
_CORNERS = ((1, 1, -1, -1, 1, 1, -1, -1), (1, -1, -1, 1, 1, -1, -1, 1), (-1, -1, -1, -1, 1, 1, 1, 1))


class Arith:
    """The dtype of a solve and the rounding of the operands of its
    products of matrices."""

    def __init__(self, precision="float64", exact=False):
        if precision not in ("float64", "float32", "tf32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.bits = None if exact else {"tf32": 10, "bfloat16": 7}.get(precision)

    def exact(self):
        """The same dtype without rounding (for the Jacobians)."""
        return Arith(self.precision, exact=True)

    def rnd(self, x):
        if self.bits is None:
            return x
        if self.bits == 7:
            return x.to(torch.bfloat16).to(torch.float32)
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & -0x2000).view(torch.float32)  # nearest, 10 mantissa bits

    def mm(self, a, b):
        return torch.matmul(self.rnd(a), self.rnd(b))


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def make_T(R, t):
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inv_T(T, ar):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_T(Rt, -ar.mm(Rt, T[..., :3, 3:4])[..., 0])


def _first_order(xi):
    """exp of an se3 tangent [omega, v] to first order: all that a Jacobian
    at zero needs."""
    top = torch.cat([hat(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    bottom = torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype, device=xi.device)
    eye = torch.eye(4, dtype=xi.dtype, device=xi.device)
    return eye + torch.cat([top, bottom], dim=-2)


def se3_exp(xi, ar):
    """[omega, v] (..., 6) -> (..., 4, 4) (g2o::SE3Quat::exp)."""
    w, v = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th * th * th))
    W = hat(w)
    WW = ar.mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * W + b * WW
    V = eye + b * W + c * WW
    return make_T(R, ar.mm(V, v[..., None])[..., 0])


def so3_log(R):
    """Rotation -> axis-angle through the unit quaternion (qw >= 0), safe
    for forward-mode differentiation away from a half turn. No 0-d
    intermediate: with a Python number, forward mode gives one a float64
    tangent."""
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    qw = 0.5 * torch.sqrt(torch.maximum(1.0 + tr, torch.full_like(tr, 1e-12)))
    qv = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1]], -1) / (4.0 * qw)
    n2 = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = n2 < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    f = torch.where(small, 2.0 / qw, 2.0 * torch.atan2(n, qw) / n)
    return f * qv


def se3_log(T, ar):
    """(..., 4, 4) -> [omega, v] (g2o::SE3Quat::log)."""
    w = so3_log(T[..., :3, :3])
    th2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = th2 < 1e-10
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    coef = torch.where(small, 1.0 / 12.0 + th2 / 720.0,
                       (1.0 - th * torch.sin(th) / (2.0 * (1.0 - torch.cos(th)))) / (th * th))
    W = hat(w)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef * ar.mm(W, W)
    return torch.cat([w, ar.mm(Vinv, T[..., :3, 3:4])[..., 0]], dim=-1)


def corners(pose, scale, ar):
    body = torch.tensor(_CORNERS, dtype=pose.dtype, device=pose.device).T  # (8, 3)
    return ar.mm(body * scale[..., None, :], pose[..., :3, :3].transpose(-1, -2)) + pose[..., None, :3, 3]


def to_camera(Tcw, p, ar):
    """World points (..., N, 3) into the camera of Tcw (..., 4, 4)."""
    return ar.mm(p, Tcw[..., :3, :3].transpose(-1, -2)) + Tcw[..., None, :3, 3]


def pixels(pc, K, ar, clamp):
    z = pc[..., 2:3]
    if clamp:
        z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return ar.mm(pc, K.T)[..., :2] / z


def box_of(pose, scale, Tcw, K, ar):
    """[cx cy w h] of the cuboid's projected corners."""
    uv = pixels(to_camera(Tcw, corners(pose, scale, ar), ar), K, ar, clamp=False)
    lo, hi = torch.amin(uv, dim=-2), torch.amax(uv, dim=-2)
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def hinge(pose, scale, p, ar):
    """Truncated hinge of world points p (..., 3) outside the cuboid, per
    body axis (orb g2o_Object.cpp:280-298)."""
    local = to_camera(inv_T(pose, ar), p[..., None, :], ar)[..., 0, :]
    out = torch.relu(torch.abs(local) - scale)
    return torch.minimum(out, scale)


def rotz(a, like):
    c, s = math.cos(a), math.sin(a)
    R = torch.tensor(((c, -s, 0.0), (s, c, 0.0), (0.0, 0.0, 1.0)), dtype=like.dtype, device=like.device)
    return make_T(R, torch.zeros(3, dtype=like.dtype, device=like.device))


def min_log_error(pose, scale, other_pose, other_scale, ar):
    """The 9-vector log error of a cuboid against the nearest of the four
    yaw re-representations of `other` (g2o_Object.h:76-102)."""
    errs = []
    for k, swap in zip((-1, 0, 1, 2), (True, False, True, False)):
        rp = ar.mm(other_pose, rotz(k * math.pi / 2.0, other_pose))
        rs = other_scale[..., [1, 0, 2]] if swap else other_scale
        errs.append(torch.cat([se3_log(ar.mm(inv_T(rp, ar), pose), ar), scale - rs], dim=-1))
    errs = torch.stack(errs, dim=-2)
    best = torch.argmin(torch.linalg.vector_norm(errs, dim=-1), dim=-1)
    return torch.take_along_dim(errs, best[..., None, None].expand(best.shape + (1, 9)), dim=-2)[..., 0, :]


def rho(r, delta, valid):
    """The Huber cost of each residual row, summed over the valid ones."""
    chi2 = torch.sum(r * r, dim=-1)
    e = torch.sqrt(torch.clamp(chi2, min=1e-300 if r.dtype == torch.float64 else 1e-30))
    return torch.sum(torch.where(e <= delta, chi2, 2.0 * delta * e - delta * delta) * valid)


def irls_weight(r, delta):
    """Square root of the Huber IRLS weight of each residual row."""
    e = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=1e-30))
    return torch.where(e <= delta, torch.ones_like(e), torch.sqrt(delta / e))


class Problem:
    """One object BA's inputs, as the port's call received them (a dict by
    the names of `local_ba_objects_two_stage`), in the solve's dtype."""

    def __init__(self, args, ar, device):
        if args.get("po_binary"):
            raise NotImplementedError("the reference solves the unary point-cuboid family only")
        self.ar = ar

        def f(name):
            return torch.as_tensor(args[name], device=device).to(ar.dtype)

        def i(name):
            return torch.as_tensor(args[name], device=device).long()

        def b(name):
            return torch.as_tensor(args[name], device=device).bool()

        self.state0 = (f("kf_tcw"), f("pts"), f("obj_pose"), f("obj_scale"))
        self.K = f("K")
        self.obs = (i("obs_kf"), i("obs_pt"), f("obs_uv"), f("obs_si"))
        self.obs_valid = b("obs_valid")
        self.box = (i("box_kf"), i("box_obj"), f("box_meas"), f("box_si"))
        self.box_valid = b("box_valid")
        self.po = (i("po_obj"), i("po_pt"), f("po_si"))
        self.po_valid = b("po_valid")
        self.meas = None
        if args.get("meas_kf") is not None and len(args["meas_kf"]):
            self.meas = (i("meas_kf"), i("meas_obj"), f("meas_pose"), f("meas_scale"), f("meas_si"))
            self.meas_valid = b("meas_valid")
        self.kf_fixed, self.pt_valid = b("kf_fixed"), b("pt_valid")
        self.obj_valid, self.obj_fix = b("obj_valid"), b("obj_fix_scale")
        self.Kf, self.P, self.O = self.state0[0].shape[0], self.state0[1].shape[0], self.state0[2].shape[0]
        self.N = 6 * self.Kf + 9 * self.O + 3 * self.P
        self.device = device

    # residuals of the current state -----------------------------------------

    def residuals(self, state, obs_valid, box_valid, ar=None):
        ar = ar or self.ar
        T, p, op, os_ = state
        ok, oj, ouv, osi = self.obs
        r_r = (pixels(to_camera(T[ok], p[oj][:, None, :], ar)[:, 0], self.K, ar, clamp=True) - ouv) * osi[:, None]
        bk, bo, bm, bsi = self.box
        r_b = (box_of(op[bo], os_[bo], T[bk], self.K, ar) - bm) * bsi[:, None]
        po, pj, psi = self.po
        r_p = hinge(op[po], os_[po], p[pj], ar) / torch.clamp(os_[po], min=1e-6) * psi[:, None]
        r_m = None
        if self.meas is not None:
            mk, mo, mp, ms, msi = self.meas
            lifted = ar.mm(inv_T(T[mk], ar), mp)
            r_m = min_log_error(op[mo], os_[mo], lifted, ms, ar) * msi[:, None]
        return r_r, r_b, r_p, r_m

    def prior_on(self):
        return (self.obj_valid & ~self.obj_fix).to(self.ar.dtype)

    def cost_parts(self, state, obs_valid, box_valid, ar=None):
        """The cost of each family: reprojection, box, point-cuboid, shape
        prior, measurement."""
        r_r, r_b, r_p, r_m = self.residuals(state, obs_valid, box_valid, ar)
        dt = r_r.dtype
        parts = {"reproj": rho(r_r, HUBER_MONO, obs_valid.to(dt)), "box": rho(r_b, HUBER_BBOX, box_valid.to(dt)),
                 "point_cuboid": rho(r_p, HUBER_PT_OBJ, self.po_valid.to(dt)),
                 "prior": torch.sum((PRIOR_SHAPE_W * state[3] * self.prior_on()[:, None]) ** 2)}
        if r_m is not None:
            parts["meas"] = rho(r_m, HUBER_MEAS, self.meas_valid.to(dt))
        return parts

    def cost(self, state, obs_valid, box_valid, ar=None):
        return sum(self.cost_parts(state, obs_valid, box_valid, ar).values())

    # normal equations ---------------------------------------------------------

    def _jacobians(self, state, obs_valid, box_valid):
        """Per family: (weighted Jacobian (E, m, n), weighted residual (E, m),
        the columns of the n local unknowns (E, n))."""
        ar, ex = self.ar, self.ar.exact()
        T, p, op, os_ = state
        K = self.K
        r_r, r_b, r_p, r_m = self.residuals(state, obs_valid, box_valid)
        cam = lambda k: 6 * k[:, None] + torch.arange(6, device=k.device)  # noqa: E731
        obj = lambda o: 6 * self.Kf + 9 * o[:, None] + torch.arange(9, device=o.device)  # noqa: E731
        pt = lambda j: 6 * self.Kf + 9 * self.O + 3 * j[:, None] + torch.arange(3, device=j.device)  # noqa: E731

        def jac(fn, n, *args):
            x0 = torch.zeros(n, dtype=ar.dtype, device=self.device)
            return vmap(lambda *a: jacfwd(lambda dx: fn(dx, *a))(x0))(*args)

        fams = []
        ok, oj, ouv, osi = self.obs
        if len(ok):
            def f_r(dx, Tk, pj, si):
                T2 = ex.mm(_first_order(dx[:6]), Tk)
                pc = to_camera(T2, (pj + dx[6:])[None, :], ex)[0]
                return pixels(pc, K, ex, clamp=True) * si
            w = irls_weight(r_r, HUBER_MONO) * obs_valid.to(ar.dtype)
            J = jac(f_r, 9, T[ok], p[oj], osi) * w[:, None, None]
            fams.append((J, r_r * w[:, None], torch.cat([cam(ok), pt(oj)], dim=1)))
        bk, bo, bm, bsi = self.box
        if len(bk):
            def f_b(dx, Tk, P_, S_, si):
                T2 = ex.mm(_first_order(dx[:6]), Tk)
                return box_of(ex.mm(P_, _first_order(dx[6:12])), S_ + dx[12:], T2, K, ex) * si
            w = irls_weight(r_b, HUBER_BBOX) * box_valid.to(ar.dtype)
            J = jac(f_b, 15, T[bk], op[bo], os_[bo], bsi) * w[:, None, None]
            fams.append((J, r_b * w[:, None], torch.cat([cam(bk), obj(bo)], dim=1)))
        po, pj, psi = self.po
        if len(po):
            def f_p(dx, P_, S_, q, si):
                return hinge(ex.mm(P_, _first_order(dx[:6])), S_ + dx[6:], q, ex) * si
            w = irls_weight(r_p, HUBER_PT_OBJ) * self.po_valid.to(ar.dtype)
            J = jac(f_p, 9, op[po], os_[po], p[pj], psi) * w[:, None, None]
            fams.append((J, r_p * w[:, None], obj(po)))
        if self.meas is not None:
            mk, mo, mp, ms, msi = self.meas

            def f_m(dx, Tk, MP, MS, P_, S_, si):
                T2 = ex.mm(_first_order(dx[:6]), Tk)
                lifted = ex.mm(inv_T(T2, ex), MP)
                return min_log_error(ex.mm(P_, _first_order(dx[6:12])), S_ + dx[12:], lifted, MS, ex) * si
            w = irls_weight(r_m, HUBER_MEAS) * self.meas_valid.to(ar.dtype)
            J = jac(f_m, 15, T[mk], mp, ms, op[mo], os_[mo], msi) * w[:, None, None]
            fams.append((J, r_m * w[:, None], torch.cat([cam(mk), obj(mo)], dim=1)))
        return fams

    def normal_equations(self, state, obs_valid, box_valid):
        ar = self.ar
        N = self.N
        H = torch.zeros((N, N), dtype=ar.dtype, device=self.device)
        b = torch.zeros(N, dtype=ar.dtype, device=self.device)
        for J, r, cols in self._jacobians(state, obs_valid, box_valid):
            Jt = J.transpose(-1, -2)
            Hl = ar.mm(Jt, J)
            bl = ar.mm(Jt, r[..., None])[..., 0]
            n = cols.shape[1]
            H.index_put_((cols[:, :, None].expand(-1, n, n).reshape(-1), cols[:, None, :].expand(-1, n, n).reshape(-1)),
                         Hl.reshape(-1), accumulate=True)
            b.index_put_((cols.reshape(-1),), bl.reshape(-1), accumulate=True)
        on = self.prior_on()
        sidx = (6 * self.Kf + 9 * torch.arange(self.O, device=self.device)[:, None]
                + torch.arange(6, 9, device=self.device)).reshape(-1)
        H[sidx, sidx] += torch.repeat_interleave(PRIOR_SHAPE_W ** 2 * on, 3)
        b[sidx] += (PRIOR_SHAPE_W * (PRIOR_SHAPE_W * state[3] * on[:, None])).reshape(-1)
        return H, b

    def free_mask(self):
        """1 on every unknown the solve moves: cameras not fixed, valid
        objects (their scale only where it is free) and valid points."""
        dt = self.ar.dtype
        cam = torch.repeat_interleave((~self.kf_fixed).to(dt), 6)
        keep_s = torch.where(self.obj_fix[:, None], 0.0, 1.0).to(dt).expand(self.O, 3)
        obj = (self.obj_valid.to(dt)[:, None] * torch.cat([torch.ones((self.O, 6), dtype=dt, device=self.device),
                                                            keep_s], dim=1)).reshape(-1)
        pts = torch.repeat_interleave(self.pt_valid.to(dt), 3)
        return torch.cat([cam, obj, pts])

    def step(self, state, lam, obs_valid, box_valid):
        ar = self.ar
        H, b = self.normal_equations(state, obs_valid, box_valid)
        m = self.free_mask()
        damp = torch.full((self.N,), float(lam), dtype=ar.dtype, device=self.device)
        damp[6 * self.Kf + 9 * self.O:] += 1e-6
        A = m[:, None] * (H + torch.diag(damp)) * m[None, :] + torch.diag(1.0 - m)
        L, info = torch.linalg.cholesky_ex(A)
        dx = torch.cholesky_solve((-b * m)[:, None], L)[:, 0] * m
        if int(info) != 0:
            dx = torch.full_like(dx, float("nan"))
        return self.retract(state, dx)

    def retract(self, state, dx):
        ar = self.ar
        T, p, op, os_ = state
        Kf, O = self.Kf, self.O
        dc = dx[:6 * Kf].reshape(Kf, 6)
        do = dx[6 * Kf:6 * Kf + 9 * O].reshape(O, 9)
        dp = dx[6 * Kf + 9 * O:].reshape(-1, 3)
        return (ar.mm(se3_exp(dc, ar), T), p + dp, ar.mm(op, se3_exp(do[:, :6], ar)),
                torch.clamp(os_ + do[:, 6:], min=SCALE_FLOOR))

    def lm(self, state, iters, obs_valid, box_valid):
        lam = 1e-4
        cost = self.cost(state, obs_valid, box_valid)
        for _ in range(iters):
            new = self.step(state, lam, obs_valid, box_valid)
            new_cost = self.cost(new, obs_valid, box_valid)
            if bool(torch.isfinite(new_cost)) and bool(new_cost < cost):
                state, cost, lam = new, new_cost, lam * 0.5
            else:
                lam *= 4.0
        return state, cost

    def gates(self, state):
        """The edge sets of the second stage: reprojection edges within chi2
        5.991 and box edges within 80 px, on the first stage's state."""
        r_r, r_b, _, _ = self.residuals(state, self.obs_valid, self.box_valid)
        obs_keep = self.obs_valid & (torch.sum(r_r * r_r, dim=-1) <= CHI2_MONO)
        si = torch.clamp(self.box[3], min=1e-9)[:, None]
        box_keep = self.box_valid & (torch.linalg.vector_norm(r_b / si, dim=-1) <= BOX_GATE_PX)
        return obs_keep, box_keep


def solve(args, precision="float64", device=None):
    """The two-stage solve of one object BA's inputs `args`. Returns (the
    Problem in float64, the final state, its cost, the second stage's edge
    sets (obs, box))."""
    device = device if device is not None else torch.as_tensor(args["pts"]).device
    pr = Problem(args, Arith(precision), device)
    state, _ = pr.lm(pr.state0, STAGES[0], pr.obs_valid, pr.box_valid)
    obs_keep, box_keep = pr.gates(state)
    state, cost = pr.lm(state, STAGES[1], obs_keep, box_keep)
    return pr, state, cost, (obs_keep, box_keep)


def costs(args, program_state, optimum=None, device=None):
    """Float64 costs per family, on the float64 solve's second-stage edges,
    of the state the call started from (`start`), of the float64 optimum
    (`optimum`) and of the program's final state (`program`). `optimum` is
    solve()'s float64 result for `args`, where the caller has it."""
    pr, state, _, (obs_keep, box_keep) = optimum if optimum is not None else solve(args, "float64", device)
    prog = tuple(torch.as_tensor(x, device=pr.device).to(torch.float64) for x in program_state)
    return {k: {n: float(v) for n, v in pr.cost_parts(st, obs_keep, box_keep).items()}
            for k, st in (("start", pr.state0), ("optimum", state), ("program", prog))}
