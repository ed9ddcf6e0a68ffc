"""klt_roofline: % of its roofline bound that the KLT kernel reached over
the traced frames: the bound of the work the frozen plain tracker counts
on the same inputs (``gvbench/klt_work.py``), over the kernel's device
time by name."""

KERNEL = "klt_bidirectional_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr.get("klt_bound_s") or not tr["kernel_s"].get(KERNEL):
        return None
    return 100.0 * tr["klt_bound_s"] / tr["kernel_s"][KERNEL]
