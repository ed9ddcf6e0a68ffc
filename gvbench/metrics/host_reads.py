"""host_reads: the window's tensors read to the host by the estimator's
``_host`` (``Estimator.counters["host_reads"]`` over the window), per frame
fed; None where the program keeps no such counter."""


def read(ctx):
    c = ctx["window"].get("counters")
    if not c or not c.get("frames"):
        return None
    return c["host_reads"] / c["frames"]
