"""keyframe_ms (ms/keyframe): the keyframe step with its local BA dispatch,
the port's span kf.total, per keyframe (the local BA itself is folded on a
later frame and is not in it)."""

from ._spans import per_call


def read(run):
    return per_call(run, ("kf.total",))
