"""One driver per kind of traffic (``kind`` in ``gvbench/traffic/<mix>.json``):
``run(spec, cell, config, traffic, seed, seconds, trace, device, t_start,
dtype)`` sets up, measures the window, compares with the reference and
returns the record the metric readers read."""
