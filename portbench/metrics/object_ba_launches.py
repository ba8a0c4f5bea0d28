"""object_ba_launches (launches/call): the CUDA runtime's launch records (a
kernel, copy or set each) made inside the port's span obj.ba, per call in
the profiled stretch."""

from .. import spans


def read(run):
    return spans.launches_per_call(run, "obj.ba")
