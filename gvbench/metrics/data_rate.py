"""data_rate: seconds of sensor data fed per second of wall over the whole
window: the stamp of the last frame fed less that of the last frame before
the window, over the window's wall."""


def read(ctx):
    w = ctx["window"]
    if "data_s" not in w or w["wall_s"] <= 0:
        return None
    return w["data_s"] / w["wall_s"]
