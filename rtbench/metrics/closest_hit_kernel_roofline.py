"""The frozen work count's bound of the step's frame (reference/work.py)
over the device ms a step of ``closest_hit_kernel`` (its closest and
occlusion launches), in %."""

from rtbench.trace import device_seconds


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "fit" or red is None:
        return None
    got = device_seconds(red, "closest_hit_kernel")
    if got is None or got[0] <= 0:
        return None
    ms = got[0] / ctx["res"]["units"] * 1e3
    return ctx["work"]["bound_ms"] / ms * 100.0
