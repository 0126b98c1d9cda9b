"""``fusion_eval``'s share of its roofline over the traced rounds, in %:
the least time of every call (``harness.peaks.fe_bound_ms`` of the call's
form, shape and live positions, as the driver records them around the cost
model's grid evaluators) over the device time of the kernel's launches in
the trace.  Nothing to read when the kernel did not run or the calls and
launches do not pair up one to one; moves ``cond_s``."""

from perfbench.harness.peaks import fe_bound_ms

KERNEL = r"fusion_eval_kernel"


def read(ctx):
    times = ctx.trace.durations(KERNEL)
    calls = ctx.window.get("fe_calls", [])
    if not times or len(times) != len(calls):
        return None
    bound_s = sum(fe_bound_ms(C, POP, P, live, form)[0]
                  for form, C, POP, P, live in calls) * 1e-3
    return 100.0 * bound_s / sum(times)
