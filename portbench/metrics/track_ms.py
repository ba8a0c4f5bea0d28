"""track_ms (ms/frame): the tracker's per-frame step, the port's spans
track.dispatch + track.result_read + track.rescue, per frame."""

from ._spans import per_frame


def read(run):
    return per_frame(run, ("track.dispatch", "track.result_read", "track.rescue"))
