"""motion_err (degrees): the tracker's frame-to-frame motion against the
true orbit. For each pair of consecutive frames posed in an episode's final
trajectory (System::SaveTrajectoryTUM's poses), the angle between the
estimated camera displacement and the true one, both in the first camera's
frame: free of the monocular scale and of the world's gauge, and of the
drift that makes the trajectory's absolute error fork from one noise draw
to the next. The 75th percentile over the episode's pairs; the worst
episode. An episode that raised, or whose pairs cover fewer than half of
the frames it ran after its first pose, reads inf. An episode that the
window's close cut is judged from its initialization on (the monocular
initializer's reference pose lies frames before it, and the frames between
are never posed); one cut before a frame was tracked after its
initialization has nothing to judge."""

import numpy as np

from ..reference import truth

PERCENTILE = 75


def read(run):
    worst = 0.0
    for e in run.episodes:
        if e.raised:
            return float("inf")
        Twc = e.final_Twc
        if e.frames_run < len(run.eps[e.pool].frames):
            if not any(T is not None for _, T in Twc):
                continue
            if e.init_frame is not None:
                if e.frames_run < e.init_frame + 2:
                    continue
                Twc = [(f, T) for f, T in Twc if f >= e.init_frame]
        errs = truth.motion_errors(Twc, run.ep.truth_Twc, n_frames=e.frames_run)
        worst = max(worst, float(np.percentile(errs, PERCENTILE)) if errs is not None else float("inf"))
    return worst
