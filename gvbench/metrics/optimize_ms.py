"""optimize_ms: the mean of ``Estimator.stage_ms["optimize"]`` (the
program's synchronized timer) over every round of the window."""


def read(ctx):
    x = ctx["window"].get("stage_ms", {}).get("optimize")
    return sum(x) / len(x) if x else None
