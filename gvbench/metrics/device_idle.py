"""device_idle.<kind>: % of the traced stretch in which no operation ran
on the card (one less the union of the device's operation intervals over
the stretch's wall)."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
