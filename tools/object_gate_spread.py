"""The object gate's landmark and the inline local BA's factor status, in
the JAX package under 1-ulp perturbations and in the port.

    JAX_PLATFORMS=cpu python tools/object_gate_spread.py

The object gate (tests/torch_parity_utils.py: 24 frames 320x240, one
landmark whose object BA is rank deficient) runs through the JAX
ObjectSlamTracker with its local-BA fold forced synchronous: once as it is,
and once for each of 12 1-ulp perturbations of its state after the
initialization (frame 9, PERTURBATIONS): every map point up or down, every
keyframe translation up or down, one map point up, and seven seeded draws
moving each map point coordinate up, down or not. A port
ObjectSlamTracker carried from the
unperturbed JAX state at frame 9 runs the same frames. For each run it
prints, per local-BA call after frame 9, which LM steps had a failed
Cholesky factor of the reduced camera system (NaN in JAX's factor,
`info != 0` from torch.linalg.cholesky_ex in the port), and the landmark's
centre and its distance from the unperturbed JAX landmark.

Then, on the first LM step of each of JAX's local BAs after frame 9, it
builds both packages' reduced camera system from the same inputs, in
float32 and in float64, and factors each package's float32 matrix with
each package's Cholesky. The two float64 builds agree when both packages
assemble the same terms (the padding of JAX's point bucket and the robust
weights included); each float32 build's distance from them is its own
rounding; the least float64 eigenvalue says how far that rounding is from
deciding the factor's status.

Runs on the CPU in ~4 minutes.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import jax.scipy.linalg as jsl  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_parity_utils import carry_object_tracker, object_gate_sequence, sync_fold_jax_object_tracker  # noqa: E402

from cube_slam_tpu.graph import ba as jba  # noqa: E402
from cube_slam_tpu.slam import system as jsys  # noqa: E402
from cube_slam_tpu_torch.graph import ba as tba  # noqa: E402

CARRY_AFTER = 9
PERTURBATIONS = ["map points +1 ulp", "map points -1 ulp", "keyframe translations +1 ulp",
                 "keyframe translations -1 ulp", "one map point +1 ulp",
                 *(f"random map point coordinates, seed {s}" for s in range(7))]
RECORD = []      # ("call" | "end" | "step", failed) in order
PROBLEMS = []    # JAX's local-BA inputs after CARRY_AFTER (padded), with their real sizes
_cho_factor = jsl.cho_factor
_local_ba_packed = jsys._local_ba_packed
_cholesky_solve = tba._cholesky_solve


def _jax_cho_factor(a, lower=False, **kw):
    L, low = _cho_factor(a, lower=lower, **kw)
    if a.ndim == 2:
        jax.debug.callback(lambda bad: RECORD.append(("step", bool(bad))), jnp.isnan(L).any(), ordered=True)
    return L, low


def _jax_local_ba_packed(buf, K, E, KF, PT, num_iters):
    RECORD.append(("call", None))
    out = _local_ba_packed(buf, K, E=E, KF=KF, PT=PT, num_iters=num_iters)
    out.block_until_ready()
    jax.effects_barrier()
    RECORD.append(("end", None))
    PROBLEMS.append(dict(buf=np.array(buf), K=np.array(K), E=E, KF=KF, PT=PT))
    return out


def _port_cholesky_solve(A, b):
    if A.dim() == 2:  # the reduced camera system (the pose LM's are batched 6x6)
        RECORD.append(("step", int(torch.linalg.cholesky_ex(A)[1]) != 0))
    return _cholesky_solve(A, b)


def _patterns(rec):
    """Per local-BA call, the failed steps as a string ("F" failed)."""
    out, cur = [], None
    for kind, bad in rec:
        if kind == "call":
            cur = []
        elif kind == "end":
            out.append("".join("F" if b else "." for b in cur))
            cur = None
        elif cur is not None:
            cur.append(bad)
    return out


def _perturb(m, variant):
    up, down = np.float32(np.inf), np.float32(-np.inf)
    mp = np.where(m.mp_valid)[0]
    k = [int(i) for i in m.kf_ids()]
    if variant == "map points +1 ulp":
        m.mp_pos[:] = np.nextafter(m.mp_pos, up)
    elif variant == "map points -1 ulp":
        m.mp_pos[:] = np.nextafter(m.mp_pos, down)
    elif variant == "keyframe translations +1 ulp":
        m.kf_tcw[k, :3, 3] = np.nextafter(m.kf_tcw[k, :3, 3], up)
    elif variant == "keyframe translations -1 ulp":
        m.kf_tcw[k, :3, 3] = np.nextafter(m.kf_tcw[k, :3, 3], down)
    elif variant == "one map point +1 ulp":
        m.mp_pos[mp[0]] = np.nextafter(m.mp_pos[mp[0]], up)
    elif variant.startswith("random map point coordinates"):
        # each coordinate of each valid map point up, down or kept, seeded
        rng = np.random.default_rng(int(variant.rsplit(" ", 1)[1]))
        step = rng.integers(-1, 2, size=(len(mp), 3))
        pos = m.mp_pos[mp]
        m.mp_pos[mp] = np.where(step > 0, np.nextafter(pos, up), np.where(step < 0, np.nextafter(pos, down), pos))
    elif variant != "none":
        raise ValueError(variant)


def _landmark(trk):
    st = trk.objects.store
    o = np.where(st.valid)[0]
    return (st.pose[o[0]][:3, 3].astype(np.float64), float(st.scale[o[0]].min())) if len(o) else (None, None)


def run_jax(frames, boxes, lines, poses, variant):
    carried = {}

    class Hooked(jsys.ObjectSlamTracker):
        def track(self, gray, bboxes_2d=None, lines=None):
            out = super().track(gray, bboxes_2d, lines)
            if self.frame_id == CARRY_AFTER:
                if variant == "none":
                    carried["port"] = carry_object_tracker(self)
                _perturb(self.map, variant)
                self._bump_map()
                RECORD.clear()
                PROBLEMS.clear()
            return out

        def _local_ba_dispatch(self, *a, **k):
            p = super()._local_ba_dispatch(*a, **k)
            if p is not None and self.frame_id > CARRY_AFTER:
                PROBLEMS[-1].update(nk=p["nk"], npt=p["npt"], n_e=len(p["kf_idx"]), fid=self.frame_id)
            return p

    J = sync_fold_jax_object_tracker(poses[0], base=Hooked)
    for f in range(len(frames)):
        J.track(frames[f], bboxes_2d=boxes[f], lines=lines[f])
    kf = sorted(int(J.map.kf_frame_id[k]) for k in J.map.kf_ids())
    return _patterns(RECORD), _landmark(J), kf, carried.get("port"), list(PROBLEMS)


def run_port(P, frames, boxes, lines):
    RECORD.clear()
    disp = P._local_ba_dispatch

    def marked(*a, **k):
        RECORD.append(("call", None))
        p = disp(*a, **k)
        RECORD.append(("end", None))
        return p

    P._local_ba_dispatch = marked
    tba._cholesky_solve = _port_cholesky_solve
    try:
        for f in range(CARRY_AFTER + 1, len(frames)):
            P.track(frames[f], bboxes_2d=boxes[f], lines=lines[f])
    finally:
        tba._cholesky_solve = _cholesky_solve
        P._local_ba_dispatch = disp
    kf = sorted(int(P.map.kf_frame_id[k]) for k in P.map.kf_ids())
    return _patterns(RECORD), _landmark(P), kf


def _unpack(p):
    KF, PT, E = p["KF"], p["PT"], p["E"]
    specs = [((KF, 4, 4), np.float32), ((PT, 3), np.float32), ((E,), np.int32), ((E,), np.int32),
             ((E, 2), np.float32), ((E,), np.float32), ((E,), bool), ((KF,), bool), ((PT,), bool),
             ((E,), np.float32), ((E,), np.float32)]
    out, off = [], 0
    for shape, dt in specs:
        n = int(np.prod(shape))
        seg = p["buf"][off:off + n].reshape(shape)
        off += n
        out.append(seg > 0.5 if dt is bool else seg.view(dt).copy())
    return out


def first_step_systems(problems, dtype):
    """The reduced camera system of the first LM step of each captured JAX
    problem as each package assembles it from the same inputs, cast to
    `dtype` (float64 needs jax_enable_x64): [(S_jax, S_port)], cameras only
    (JAX's own padding of points and edges kept, the port's inputs unpadded
    as the tracker gives them)."""
    grab_j, grab_p = [], []

    def cf(a, lower=False, **kw):
        jax.debug.callback(lambda A: grab_j.append(np.array(A)), a, ordered=True)
        return _cho_factor(a, lower=lower, **kw)

    def cs(A, b):
        grab_p.append(A.numpy().copy())
        return _cholesky_solve(A, b)

    def cast(x):
        return x.astype(dtype) if x.dtype == np.float32 else x

    jax.scipy.linalg.cho_factor = cf
    tba._cholesky_solve = cs
    t = torch.as_tensor
    out = []
    try:
        for p in problems:
            a = [cast(x) for x in _unpack(p)]
            K = cast(p["K"])
            nk, npt, ne = p["nk"], p["npt"], p["n_e"]
            grab_j.clear()
            grab_p.clear()
            jba.local_ba_points(*[jnp.asarray(x) for x in a[:2]], jnp.asarray(K),
                                *[jnp.asarray(x) for x in a[2:9]], obs_z=jnp.asarray(a[9]),
                                obs_z_si=jnp.asarray(a[10]), num_iters=1)
            jax.effects_barrier()
            tba.local_ba_points(t(a[0][:nk]), t(a[1][:npt]), t(K), t(a[2][:ne]), t(a[3][:ne]),
                                t(a[4][:ne]), t(a[5][:ne]), t(a[6][:ne]), t(a[7][:nk]), t(a[8][:npt]),
                                obs_z=t(a[9][:ne]), obs_z_si=t(a[10][:ne]), num_iters=1)
            assert grab_j[0].dtype == grab_p[0].dtype == dtype
            out.append((grab_j[0][:nk * 6, :nk * 6], grab_p[0]))
    finally:
        jax.scipy.linalg.cho_factor = _cho_factor
        tba._cholesky_solve = _cholesky_solve
    return out


def compare_systems(problems):
    """Rows of: frame, cameras, max |S| (float64), the gaps between the
    float32 and float64 builds over max |S|, the least eigenvalue of the
    float64 free-camera block, and whether each package's Cholesky fails on
    each package's float32 matrix."""
    s32 = first_step_systems(problems, np.float32)
    jax.config.update("jax_enable_x64", True)
    s64 = first_step_systems(problems, np.float64)
    jfail = lambda S: not np.isfinite(np.asarray(_cho_factor(jnp.asarray(S), lower=True)[0])).all()  # noqa: E731
    tfail = lambda S: int(torch.linalg.cholesky_ex(torch.as_tensor(S))[1]) != 0  # noqa: E731
    rows = []
    for p, (SJ, SP), (SJ64, SP64) in zip(problems, s32, s64):
        free = np.repeat(~_unpack(p)[7][:p["nk"]], 6)
        big = float(np.abs(SJ64).max())
        gap = lambda A, B: float(np.abs(A.astype(np.float64) - B).max() / big)  # noqa: E731
        rows.append((p["fid"], p["nk"], big, gap(SJ, SP), gap(SJ64, SP64), gap(SJ, SJ64), gap(SP, SJ64),
                     float(np.linalg.eigvalsh(SJ64[free][:, free])[0]),
                     jfail(SJ), tfail(SJ), jfail(SP), tfail(SP)))
    return rows


def main():
    jax.scipy.linalg.cho_factor = _jax_cho_factor
    jsys._local_ba_packed = _jax_local_ba_packed
    frames, boxes, lines, poses, _ = object_gate_sequence()
    variants = ["none", *PERTURBATIONS]
    ref = None
    print("run | keyframe frames | failed LM steps per local BA after frame 9 | landmark centre (m) | "
          "scale | off the unperturbed JAX landmark (m)")
    for v in variants:
        pat, (c, s), kf, port, problems = run_jax(frames, boxes, lines, poses, v)
        if v == "none":
            ref, P, ref_problems = c, port, problems
        print(f"JAX, {v} | {kf} | {' '.join(pat)} | {np.round(c, 4).tolist()} | {s:.5f} | "
              f"{np.linalg.norm(c - ref):.4f}")
    jax.scipy.linalg.cho_factor = _cho_factor
    jsys._local_ba_packed = _local_ba_packed
    pat, (c, s), kf = run_port(P, frames, boxes, lines)
    print(f"port, carried from JAX at frame {CARRY_AFTER} | {kf} | {' '.join(pat)} | {np.round(c, 4).tolist()} | "
          f"{s:.5f} | {np.linalg.norm(c - ref):.4f}")
    print("first LM step of JAX's local BAs after frame 9, both packages' reduced camera system S from the "
          "same inputs: frame | cameras | max |S| (float64) | gaps over max |S|: JAX32-port32, JAX64-port64, "
          "JAX32-exact, port32-exact (exact = JAX64) | least eigenvalue of the float64 free-camera block | "
          "failed: JAX(S_jax32) torch(S_jax32) JAX(S_port32) torch(S_port32)")
    for row in compare_systems(ref_problems):
        fid, nk, big, g, g64, gj, gp, ev, *fails = row
        print(f"  {fid} | {nk} | {big:.4g} | {g:.2e} {g64:.2e} {gj:.2e} {gp:.2e} | {ev:.4g} | "
              f"{' '.join(str(f) for f in fails)}")

if __name__ == "__main__":
    main()
