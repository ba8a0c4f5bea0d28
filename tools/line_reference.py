#!/usr/bin/env python3
"""Run the JAX package's line features over the frames that chip_smoke.py's
phase 14A gives the port, on the CPU, and print the same figures, one JSON
line per detector: the reference for the port's numbers there.

    JAX_PLATFORMS=cpu python tools/line_reference.py

Setup as phase 14A: phase 6's 58-frame 640x480 orbit with each frame's
rendered depth (chip_smoke.rgbd_sequence), describe_lines_pyramid with
the JAX defaults (2 octaves, 128 lines per octave) and detector "lsd" or
"edline", match_lines between consecutive frames; chip_smoke.line_figures
turns them into the median valid lines per octave, the median matches per
pair and the share of matches that agree with the truth motion. Times are
host seconds on the CPU and say nothing of any device.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cube_slam_tpu.ops import lbd

    rgbd = cs.rgbd_sequence()
    frames = rgbd[0]
    H, W = frames[0][0].shape
    for detector in cs.LINE_DETECTORS:
        descs, matches = [], []
        t0 = time.perf_counter()
        for f, (g, _) in enumerate(frames):
            d = lbd.describe_lines_pyramid(jnp.asarray(g), n_octaves=cs.LINE_OCTAVES, detector=detector,
                                           max_lines=cs.LINE_MAX)
            descs.append({k: np.asarray(d[k]) for k in ("lines", "valid", "octave", "bdesc")})
            if f:
                m, dist = lbd.match_lines(jnp.asarray(descs[f - 1]["bdesc"]), jnp.asarray(descs[f - 1]["valid"]),
                                          d["bdesc"], d["valid"])
                matches.append((np.asarray(m), np.asarray(dist)))
        wall = time.perf_counter() - t0
        fig = cs.line_figures(descs, matches, rgbd)
        print(json.dumps(dict(detector=f"{detector} (JAX, CPU)", frames=len(frames), wh=[W, H],
                              octaves=cs.LINE_OCTAVES, max_lines=cs.LINE_MAX, agree_px=cs.LINE_AGREE_PX,
                              cpu_seconds=wall, **fig)), flush=True)


if __name__ == "__main__":
    main()
