"""lines_ms (ms/frame): the feed's call of the port's LSD (detect_lines on
the card, the segments read back to the host), host clock, per frame
outside the profiled stretch."""


def read(run):
    frames = [r for r in run.frames if "lines" in r.made and not r.traced]
    return sum(r.feed_ms for r in frames) / len(frames) if frames else None
