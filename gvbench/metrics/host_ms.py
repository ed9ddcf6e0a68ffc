"""host_ms: ms of wall per second of data that the pipeline's calls spent
outside the front end and the estimator's timed stages (preintegrate,
optimize, marginalize): the estimator's host bookkeeping and the feed."""


def read(ctx):
    w = ctx["window"]
    if "stage_ms" not in w or w.get("data_s", 0) <= 0:
        return None
    inside = sum(w["frontend_ms"]) + sum(sum(v) for v in w["stage_ms"].values())
    return (sum(w["frame_ms"]) - inside) / w["data_s"]
