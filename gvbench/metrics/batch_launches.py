"""batch_launches: CUDA kernel launches per ``optimize_batch`` call in the
traced calls."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["span_calls"].get("batch"):
        return None
    return tr["span_launches"]["batch"] / tr["span_calls"]["batch"]
