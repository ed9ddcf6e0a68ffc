"""feed_ms: the mean over the window's frames of ``Estimator.feed_ms``, the
program's host wall ms of each ``add_frame_observations`` call less the
synchronized stages it ran (preintegrate, optimize, marginalize); None
where the program has no such span."""


def read(ctx):
    x = ctx["window"].get("feed_ms")
    return sum(x) / len(x) if x else None
