"""object_ba_ms (ms/call): the joint camera-point-object BA, the port's
span obj.ba, per call."""

from ._spans import per_call


def read(run):
    return per_call(run, ("obj.ba",))
