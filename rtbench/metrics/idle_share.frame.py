"""1 - (the union of the device operations' intervals) / (the traced
window), over a fly window."""


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "fly" or red is None or not red["busy_s"]:
        return None
    return 1.0 - red["busy_s"] / ctx["window_s"]
