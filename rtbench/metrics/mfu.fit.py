"""The whole step's share of the card's peak: the frozen work count's
bound of its frame (reference/work.py) over the traced window's ms a
step, in %."""


def read(ctx):
    if ctx["kind"] != "fit":
        return None
    return ctx["work"]["bound_ms"] / ctx["res"]["step_ms"] * 100.0
