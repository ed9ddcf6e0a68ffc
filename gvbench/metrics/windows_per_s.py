"""windows_per_s: windows optimized per second of wall: the batch size
times the calls completed in the window (each ending in a host read), over
the window's wall."""


def read(ctx):
    w = ctx["window"]
    if "calls" not in w:
        return None
    return w["batch"] * w["calls"] / w["wall_s"]
