"""Device allocations (``cudaMalloc`` by the caching allocator) per round
in the traced pass: the program's counter ``cuda.device_allocs``, which
each root span adds to while tracing is on (the rounds and the driver's
``stack_workloads`` before each), over the pass's ``gsampler.round``
spans.  A steady closed loop should allocate nothing; moves ``cond_s``."""

from perfbench.harness.program_spans import obs


def read(ctx):
    mod = obs()
    if mod is None:
        return None
    rounds = sum(1 for s in mod.spans() if s.name == "gsampler.round")
    allocs = mod.counters(traced=True).get("cuda.device_allocs")
    if not rounds or allocs is None:
        return None
    return allocs / rounds
