"""Per-call means of the port's spans over the window's frames outside the
profiled stretch."""


def per_call(run, names):
    """Total ms of `names` over their calls (the first name's calls), or
    None where none was recorded."""
    total, calls = 0.0, 0
    for r in run.frames:
        if r.traced:
            continue
        for i, n in enumerate(names):
            ms, c = r.spans.get(n, (0.0, 0))
            total += ms
            if i == 0:
                calls += c
    return total / calls if calls else None


def per_frame(run, names):
    """Total ms of `names` over the frames outside the stretch."""
    frames = [r for r in run.frames if not r.traced and r.kind != "raised"]
    if not frames:
        return None
    return sum(r.spans.get(n, (0.0, 0))[0] for r in frames for n in names) / len(frames)
