"""The system under test: a cell's tracker of cube_slam_tpu_torch, built and
handed one frame at a time, as a user's loop over a camera does.

A configuration's `runs` entry names the entry that a traffic mix drives
(`portbench/entries/<entry>.py`, found by that name): the entry builds the
tracker and gives `track()` its arguments per frame. A tracker is held to
the configuration's `orb` where it states one; where it states none, as
CubeSLAM's cube-only mode, which predicts each pose at constant velocity,
the tracker must run no ORB. Everything here imports the port lazily,
inside the functions, so the benchmark's modules import without it.
"""

from __future__ import annotations

import importlib

import numpy as np


def port_modules():
    """The port's modules every cell reads (imported here, once per process,
    and counted in set-up)."""
    from cube_slam_tpu_torch.ops import _build, hopper_kernels, lsd
    from cube_slam_tpu_torch.utils import profiler

    return dict(build=_build, hopper_kernels=hopper_kernels, lsd=lsd, profiler=profiler)


def entry(name):
    """The module of the entry `name`."""
    return importlib.import_module(f"portbench.entries.{name}")


def build_tracker(port, cfg, run, ep, device):
    """A fresh tracker of the run's entry for episode `ep` on `device`.
    Where the configuration states `orb`, the tracker's `orb_cfg` must hold
    every stated key; where it states none, the tracker must have no
    `orb_cfg` (or None). Either failing raises RuntimeError."""
    trk = entry(run["entry"]).build(port, cfg, ep, device)
    orb, want = getattr(trk, "orb_cfg", None), cfg.get("orb")
    if want is None:
        if orb is not None:
            raise RuntimeError("the tracker runs ORB; the configuration states none")
        return trk
    if orb is None:
        raise RuntimeError(f"the tracker runs no ORB; the configuration states {want}")
    got = dict(n_features=orb.n_features, n_levels=orb.n_levels, scale_factor=orb.scale_factor,
               ini_th_fast=orb.ini_th, min_th_fast=orb.min_th)
    if any(abs(float(got[k]) - float(want[k])) > 1e-9 for k in want):
        raise RuntimeError(f"the tracker runs ORB {got}, the configuration states {want}")
    return trk


def make_feed(port, cfg, run, ep, device, lines_fn=None):
    return entry(run["entry"]).Feed(port, cfg, ep, device, lines_fn=lines_fn)


def port_lines_fn(port, cfg):
    """The port's LSD at the configuration's settings: (H, W) float32
    tensor -> (M, 4) numpy segments, read back to the host."""
    detect, lc = port["lsd"].detect_lines, cfg["lines"]

    def lines_fn(g):
        lines, valid = detect(g, min_length=float(lc["min_length"]), max_lines=int(lc["max_lines"]))
        return lines.cpu().numpy()[valid.cpu().numpy()]

    return lines_fn


class GrayFeed:
    """Per frame the grey image, float32 grey levels as every gate of the
    port feeds it. `args(f)` returns (track() arguments, what the feed made
    for the checks: a dict)."""

    def __init__(self, port, cfg, ep, device, lines_fn=None):
        self.device = device
        self.gray = [f.astype(np.float32) for f in ep.frames]

    def args(self, f):
        return (self.gray[f],), {}
