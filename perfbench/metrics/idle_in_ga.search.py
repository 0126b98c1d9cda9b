"""The share of the traced rounds' device idle time (the gaps between the
device operations of the profiled pass) that falls while the host is
inside the program's ``ga.generation`` span: the GA's launches of one
generation, which a graph of a generation would take off the host.  In %;
moves ``cond_s``."""

from perfbench.harness.program_spans import idle_share

NAMES = ("ga.generation",)


def read(ctx):
    return idle_share(ctx, NAMES, "gsampler.round")
