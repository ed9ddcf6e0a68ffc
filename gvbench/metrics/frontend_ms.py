"""frontend_ms: the front end's wall ms per frame (``Pipeline.frame_ms``,
the program's own timer, which ends in a host read), over every frame of
the window."""


def read(ctx):
    w = ctx["window"]
    fe = w.get("frontend_ms")
    return sum(fe) / len(fe) if fe else None
