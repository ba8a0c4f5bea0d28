"""detect_ms (ms/call): the cuboid detector through
ObjectManager.detect_on_keyframe, the port's span obj.detect, per call."""

from ._spans import per_call


def read(run):
    return per_call(run, ("obj.detect",))
