"""The whole frame's share of the card's peak: the frozen work count's
bound (reference/work.py) over the traced window's ms a frame, in %."""


def read(ctx):
    if ctx["kind"] != "fly":
        return None
    return ctx["work"]["bound_ms"] / ctx["res"]["frame_ms"] * 100.0
