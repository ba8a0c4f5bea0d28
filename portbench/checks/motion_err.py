"""motion_err (degrees): the tracker's frame-to-frame motion against the
true orbit. For each pair of consecutive frames posed in an episode's final
trajectory (System::SaveTrajectoryTUM's poses), the angle between the
estimated camera displacement and the true one, both in the first camera's
frame: free of the monocular scale and of the world's gauge, and of the
drift that makes the trajectory's absolute error fork from one noise draw
to the next. The 75th percentile over the episode's pairs; the worst
episode. An episode that raised, or whose pairs cover fewer than half of
the frames it ran after its first pose, reads inf; one that the window's
close cut before its first pose has nothing to judge."""

import numpy as np

from ..reference import truth

PERCENTILE = 75


def read(run):
    worst = 0.0
    for e in run.episodes:
        if e.raised:
            return float("inf")
        cut = e.frames_run < len(run.eps[e.pool].frames)
        if cut and not any(T is not None for _, T in e.final_Twc):
            continue
        errs = truth.motion_errors(e.final_Twc, run.ep.truth_Twc, n_frames=e.frames_run)
        worst = max(worst, float(np.percentile(errs, PERCENTILE)) if errs is not None else float("inf"))
    return worst
