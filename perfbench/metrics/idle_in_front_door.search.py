"""The share of the traced rounds' device idle time (the gaps between the
device operations of the profiled pass) that falls while the host is
inside the program's front door: ``cost_model.stack_workloads``,
``gsampler.prepare`` (the hardware rows, batches and budgets to the
device, the generator) and ``gsampler.to_host`` (the answers' copy to the
host).  In %; moves ``cond_s``."""

from perfbench.harness.program_spans import idle_share

NAMES = ("cost_model.stack_workloads", "gsampler.prepare",
         "gsampler.to_host")


def read(ctx):
    return idle_share(ctx, NAMES, "gsampler.round")
