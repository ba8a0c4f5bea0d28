"""frames_per_s: frames completed in the window over the window's seconds
(tracker construction and every frame's work included)."""


def read(run):
    done = sum(1 for r in run.frames if r.kind != "raised")
    return done / run.window_s if run.window_s > 0 else None
