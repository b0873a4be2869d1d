"""Device ms a frame of the kernels whose name holds
``wholeframe_kernel`` (csrc/raytrace.cu), from the profiler's trace of
the window."""

from rtbench.trace import device_seconds


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "fly" or red is None:
        return None
    got = device_seconds(red, "wholeframe_kernel")
    return None if got is None else got[0] / ctx["res"]["units"] * 1e3
