"""The benchmark's general code: one driver per kind of traffic (serving,
training), the state dict made from the seed, the recorder of the program's
choices, the trace's reduction and the checks.  Nothing here names a cell:
configurations, traffic mixes, limits and per-layer metrics are files found
by the names in ``BENCHMARK.json``."""
