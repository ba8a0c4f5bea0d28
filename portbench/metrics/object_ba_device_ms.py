"""object_ba_device_ms (ms/call): device busy time of the kernels, copies and
sets launched inside the port's span obj.ba (the joint camera-point-object
BA, its descendants included), per call in the profiled stretch."""

from .. import spans


def read(run):
    return spans.device_ms_per_call(run, "obj.ba")
