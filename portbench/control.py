"""The controls and the planted faults: runs of the timed path broken on
purpose, which the comparison that decides `correct` has to call wrong.
The benchmark's own runs never use them; tools/sweep.py and
tests/test_portbench_faults.py do.

The controls put a reference in the port's place, one precision below the
configuration's float32, or break a guarantee it states:
- the object BA: reference/object_ba.py's solve in TF32 (float32 with the
  operands of every product of matrices rounded to 10 mantissa bits);
- the EDT: reference/edt.py's transform in bfloat16;
- the lines: the plain reference detector in bfloat16 (bfloat16 is the
  precision a faster detector would drop to; the lines are a deterministic
  function of the image);
- the tracker breaks the guarantee `pose_refined`: the motion-only BA
  returns the pose it starts from, so every frame keeps its predicted pose
  (the tracker's answers are judged against the scene's truth, where the
  rounding of a lower precision vanishes in the tracking error).
"""

from __future__ import annotations

import contextlib
import functools
import inspect

import numpy as np


def reference_lines_fn(cfg, dtype_name="bfloat16"):
    """A FrameFeed lines_fn: the reference detector in `dtype_name` on the
    frame's device."""
    import torch

    from .reference import lsd

    lc = cfg["lines"]
    dtype = getattr(torch, dtype_name)

    def lines_fn(g):
        return lsd.detect_lines(g, min_length=float(lc["min_length"]), max_lines=int(lc["max_lines"]), dtype=dtype)

    return lines_fn


@contextlib.contextmanager
def pose_refinement_cut():
    """The port's motion-only BA returns its starting pose with every valid
    match an inlier."""
    from cube_slam_tpu_torch.graph import ba

    orig = ba.pose_optimization

    def unrefined(Tcw0, K, pts_world, uv_meas, sqrt_info, valid, num_rounds=4, iters_per_round=10):
        inlier = valid.bool()
        if Tcw0.ndim == 3 and inlier.ndim == 1:
            inlier = inlier.expand(Tcw0.shape[0], -1)
        return Tcw0.clone(), inlier.clone(), inlier.sum(dim=-1)

    ba.pose_optimization = unrefined
    try:
        yield
    finally:
        ba.pose_optimization = orig


@contextlib.contextmanager
def port_function(module, name, make):
    """Replace `module.name` by make(original) for the block."""
    orig = getattr(module, name)
    setattr(module, name, functools.wraps(orig)(make(orig)))
    try:
        yield
    finally:
        setattr(module, name, orig)


def reference_object_ba(precision="tf32"):
    """The reference solve in `precision` in the port's place."""
    import torch

    from cube_slam_tpu_torch.graph import object_ba

    from .reference import object_ba as ref

    def make(orig):
        sig = inspect.signature(orig)

        def solve(*a, **k):
            args = dict(sig.bind(*a, **k).arguments)
            _, state, cost, (obs_keep, box_keep) = ref.solve(args, precision)
            return tuple(x.to(torch.float32) for x in state) + (cost.to(torch.float32), obs_keep, box_keep)
        return solve

    return port_function(object_ba, "local_ba_objects_two_stage", make)


def reference_edt(dtype_name="bfloat16"):
    """The reference transform, its distances in `dtype_name`, in the port's
    place."""
    import torch

    from cube_slam_tpu_torch.ops import hopper_kernels

    from .reference import edt

    def make(orig):
        def transform(edges):
            sq = edt.squared(edges, getattr(torch, dtype_name))
            return torch.sqrt(sq.to(torch.float32)).reshape(edges.shape)
        return transform

    return port_function(hopper_kernels, "edt_l2", make)


# planted faults: tracker hooks, wrappers of the port's functions, and a
# wrapper of the feed's lines_fn


def object_ba_unchanged():
    """The object BA returns the state it was handed."""
    from cube_slam_tpu_torch.graph import object_ba

    def make(orig):
        def unchanged(kf_tcw, pts, obj_pose, obj_scale, *a, **k):
            out = orig(kf_tcw, pts, obj_pose, obj_scale, *a, **k)
            return (kf_tcw.clone(), pts.clone(), obj_pose.clone(), obj_scale.clone()) + tuple(out[4:])
        return unchanged

    return port_function(object_ba, "local_ba_objects_two_stage", make)


def object_ba_half_edges():
    """The object BA solves over every other reprojection edge (half of its
    batch left out)."""
    from cube_slam_tpu_torch.graph import object_ba

    def make(orig):
        sig = inspect.signature(orig)

        def half(*a, **k):
            args = dict(sig.bind(*a, **k).arguments)
            keep = args["obs_valid"].clone()
            keep[1::2] = False
            args["obs_valid"] = keep
            return orig(**args)
        return half

    return port_function(object_ba, "local_ba_objects_two_stage", make)


def object_ba_altered(metres=0.01):
    """An answer altered where it is produced: the object BA's points moved
    by `metres` along x."""
    from cube_slam_tpu_torch.graph import object_ba

    def make(orig):
        def moved(*a, **k):
            out = list(orig(*a, **k))
            out[1] = out[1].clone()
            out[1][:, 0] += metres
            return tuple(out)
        return moved

    return port_function(object_ba, "local_ba_objects_two_stage", make)


def edt_altered():
    """An answer altered where it is produced: each distance map's first
    pixel one pixel farther."""
    from cube_slam_tpu_torch.ops import hopper_kernels

    def make(orig):
        def altered(edges):
            out = orig(edges).clone()
            out.view(-1, out.shape[-2] * out.shape[-1])[:, 0] += 1.0
            return out
        return altered

    return port_function(hopper_kernels, "edt_l2", make)


def state_unchanged(trk):
    """A step that returns its state unchanged: every frame's pose is the
    one the tracker held before the frame (its trajectory too)."""
    step = trk._record_pose

    def frozen(Tcw, fid=None):
        prev = [T for _, T in trk.trajectory[:-1] if T is not None]
        if prev:
            Tcw = prev[0].copy()
            trk.trajectory[-1] = (trk.trajectory[-1][0], Tcw)
        return step(Tcw, fid)

    trk._record_pose = frozen
    return trk


def pose_altered(trk, metres=0.5):
    """An answer altered where it is produced: every recorded pose moved by
    `metres` along its camera's x axis on every other frame."""
    step = trk._record_pose

    def moved(Tcw, fid=None):
        fid = trk.frame_id if fid is None else fid
        if fid % 2:
            Tcw = np.array(Tcw, dtype=np.float64)
            Tcw[0, 3] += metres
            trk.trajectory[-1] = (trk.trajectory[-1][0], Tcw.astype(np.float32))
        return step(Tcw, fid)

    trk._record_pose = moved
    return trk


def lines_altered(lines_fn, px=3.0):
    """An answer altered where it is produced: every segment shifted by
    `px` pixels across the image."""
    def shifted(g):
        out = np.array(lines_fn(g), dtype=np.float64)
        out[:, [0, 2]] += px
        return out

    return shifted
