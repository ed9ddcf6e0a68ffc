"""The batched solver in a closed loop: ``parallel.multi_seq.optimize_batch``
over batches of sliding windows, one call after another, each ending in a
read of its results on the host.

Set-up makes ``pool`` distinct batches from the seed and calls each once.
The window calls them in turn for ``--seconds`` of wall. With ``--trace 1``
the profiler covers ``trace_calls`` calls from the window's
``trace_from``-th.

Correctness: after the window the frozen reference solves, alone, a
sample drawn from the seed of the members of a sample of the window's
calls (one member from each stratum of the batch, and the member that ran
the most iterations), from the same inputs, and the program's windows,
costs, culls and iterations are compared with its.
"""

import gc
import math
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import harness
from ..gen import batch as gen_batch
from ..reference.solver import lm as ref_lm


def run(spec, cell, config, traffic, seed, seconds, trace, device, t_start, dtype=torch.float64):
    from ic_gvins_tpu_torch.parallel import multi_seq

    pool, cfg, params = gen_batch.make_pool(config, traffic, seed, device)
    cast = lambda t: pytree.tree_map(  # noqa: E731
        lambda x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x, t)
    stack = lambda xs: pytree.tree_map(lambda *a: torch.stack(a), *xs)  # noqa: E731
    B = int(traffic["batch"])
    inputs = [(cast(stack(members)), cast(stack(priors))) for members, priors in pool]
    p_cfg, p_params = cast(cfg), cast(params)
    iters = int(config["engine"]["optimize_num_iterations"])
    rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 11]))
    seams = harness.Seams()
    seams.wrap(multi_seq, "optimize_batch", "batch",
               harness.Sampler(int(traffic["sample"]["calls"]), rng),
               keep=lambda a, k, out: (out[0].nodes, out[0].lm_invdepth, out[0].obs_valid,
                                       out[1]))
    failed = [0]

    def call(i):
        wins, priors = inputs[i % len(inputs)]
        out, stats = multi_seq.optimize_batch(wins, priors, p_cfg, p_params, iters=iters)
        host = [x.cpu() for x in stats]  # the host reads the results
        if seams.on:  # a window whose costs are not finite has failed
            failed[0] += int((~(torch.isfinite(host[0]) & torch.isfinite(host[1]))).sum())
        return host

    try:
        for i in range(len(inputs)):
            call(i)
        _sync(device)
        setup_s = time.perf_counter() - t_start

        trace_from, trace_calls = int(traffic["trace_from"]), int(traffic["trace_calls"])
        prof, n = None, 0
        seams.on = True
        w0 = time.perf_counter()
        while True:
            if trace and n == trace_from:
                from ..trace import Profile

                prof = Profile(device)
                seams.spans = True
                prof.start()
            seams.context["pool"] = n % len(inputs)
            call(n)
            n += 1
            if prof is not None and seams.spans and n == trace_from + trace_calls:
                prof.stop()
                seams.spans = False
            if time.perf_counter() - w0 >= seconds:
                break
        wall = time.perf_counter() - w0
        seams.on = False
        if prof is not None and seams.spans:
            prof.stop()
            seams.spans = False
        _sync(device)
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        seams.on = False
        seams.restore()
    calls = seams.records("batch")
    del inputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    limits = spec.limits(traffic["kind"])
    t_ref = time.perf_counter()
    numbers = compare(calls, pool, cfg, params, iters, rng, traffic["sample"])
    failed = failed[0]
    ref_s = time.perf_counter() - t_ref
    checks = [(k, numbers[k], limits[k]) for k in limits]
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    traced = prof.reduce() if prof is not None else None
    return dict(correct=correct, attempted=n * B, failed=failed, checks=checks,
                setup_s=setup_s, memory_peak=memory_peak,
                window=dict(wall_s=wall, calls=n, batch=B), trace=traced,
                notes=dict(reference_s=ref_s, pool=len(pool)))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compare(calls, pool, cfg, params, iters, rng, sample):
    """The numbers over the window's sampled calls: ``batch_err``, the worst
    gap of a sampled member's nodes, inverse depths and observation flags
    (1 where its iterations, accepted steps or culls differ), and
    ``batch_cost``, the worst relative gap of its costs."""
    if not calls:
        return {"batch_err": math.inf, "batch_cost": math.inf}
    gap_w = gap_c = 0.0
    for ctx, (nodes, invd, obs, (c0, c1, ncull, iters_run, acc)) in calls:
        members, priors = pool[ctx["pool"]]
        B = len(members)
        # one member from each of ``members`` equal strata of the batch, and
        # the member that ran the most iterations
        k = min(int(sample["members"]), B)
        edges = np.linspace(0, B, k + 1).astype(int)
        pick = {int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])}
        pick.add(int(torch.argmax(iters_run)))
        for b in sorted(pick):
            ref_w, (r1, r2, rn) = ref_lm.optimize(members[b], priors[b], cfg, params,
                                                  iters=iters)
            got = (pytree.tree_map(lambda x: x[b], nodes), invd[b], obs[b])
            gap_w = max(gap_w, harness.tree_gap(got, (ref_w.nodes, ref_w.lm_invdepth,
                                                      ref_w.obs_valid)))
            if (int(ncull[b]), int(iters_run[b]), int(acc[b])) != (
                    int(rn), r1.iters_run + r2.iters_run, r1.accepted + r2.accepted):
                gap_w = max(gap_w, 1.0)
            gap_c = max(gap_c, harness.rel_scalar(c0[b], r1.cost0),
                        harness.rel_scalar(c1[b], r2.cost1))
    return {"batch_err": gap_w, "batch_cost": gap_c}
