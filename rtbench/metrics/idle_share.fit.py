"""1 - (the union of the device operations' intervals) / (the traced
window), over a fit window."""


def read(ctx):
    red = ctx["trace"]
    if ctx["kind"] != "fit" or red is None or not red["busy_s"]:
        return None
    return 1.0 - red["busy_s"] / ctx["window_s"]
