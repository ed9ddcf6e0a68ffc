"""lm_launches: CUDA kernel launches per ``optimize`` call in the traced
frames (the runtime's launch calls inside the calls' spans)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["span_calls"].get("optimize"):
        return None
    return tr["span_launches"]["optimize"] / tr["span_calls"]["optimize"]
