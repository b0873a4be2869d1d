"""The frozen work count's bound (reference/work.py) over the device ms a
frame of ``wholeframe_kernel``, in %."""

from rtbench.trace import device_seconds


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "fly" or red is None:
        return None
    got = device_seconds(red, "wholeframe_kernel")
    if got is None or got[0] <= 0:
        return None
    ms = got[0] / ctx["res"]["units"] * 1e3
    return ctx["work"]["bound_ms"] / ms * 100.0
