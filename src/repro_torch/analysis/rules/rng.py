"""RNG-discipline rules (TRNG family).

Contract (``repro_torch/__init__.py``, "Randomness"): every random draw
takes an explicit ``torch.Generator`` seeded from a config (or a numpy
``default_rng``, which the reference linter's RNG rules already check in
these files).  Torch's process-global generator is never seeded nor
drawn from: one ambient draw shifts every later one, and the bit-exact
training, resume and serving contracts break silently.
"""
from __future__ import annotations

import ast

from ..framework import (FileContext, Rule, calls, dotted_name, method_name,
                         register)

_CONTRACT = "every random draw takes a seeded torch.Generator"

_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.initial_seed",
                 "torch.random.manual_seed", "torch.random.seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "torch.cuda.seed", "torch.cuda.seed_all"}

# torch.<fn>(...) factories that draw
_FACTORIES = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
              "multinomial", "poisson", "rand_like", "randn_like",
              "randint_like"}
# Tensor.<fn>_(...) in-place draws
_INPLACE = {"uniform_", "normal_", "bernoulli_", "exponential_", "random_",
            "cauchy_", "log_normal_", "geometric_"}
# nn.init.<fn>_(...) initialisers that draw
_INIT = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
         "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
         "orthogonal_", "sparse_"}

_TIME_CALLS = {"time.time", "time.time_ns", "time.perf_counter",
               "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
               "time.process_time", "datetime.now", "datetime.utcnow",
               "datetime.datetime.now", "datetime.datetime.utcnow",
               "os.urandom", "os.getpid", "uuid.uuid1", "uuid.uuid4",
               "random.random", "random.randint", "secrets.randbits"}
_SEEDING = {"manual_seed", "default_rng", "SeedSequence"}


def _draw(call: ast.Call) -> str | None:
    """What ``call`` draws from, when it is a torch draw: ``torch.randn``,
    ``nn.init.normal_``, ``Tensor.uniform_``."""
    name = dotted_name(call.func)
    parts = name.split(".")
    if name.startswith("torch.") and len(parts) == 2 \
            and parts[1] in _FACTORIES:
        return name
    if len(parts) >= 2 and parts[-2] == "init" and parts[-1] in _INIT:
        return "nn.init." + parts[-1]
    m = method_name(call)
    if m in _INPLACE and not (len(parts) >= 2 and parts[-2] == "init"):
        return f"Tensor.{m}"
    return None


@register
class GlobalSeed(Rule):
    id = "TRNG001"
    severity = "error"
    description = ("torch.manual_seed / torch.cuda.manual_seed[_all] / "
                   "torch.seed(): seeds or reads the process-global RNG")
    contract = _CONTRACT

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            name = dotted_name(node.func)
            if name in _GLOBAL_SEEDS:
                yield self.finding(
                    ctx, node, f"{name}() touches torch's process-global "
                    "generator; seed a torch.Generator and pass it as "
                    "generator=")


@register
class DrawWithoutGenerator(Rule):
    id = "TRNG002"
    severity = "error"
    description = ("torch random draw (factory, in-place Tensor draw or "
                   "nn.init) without generator=")
    contract = _CONTRACT

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            what = _draw(node)
            if what and not any(kw.arg == "generator"
                                for kw in node.keywords):
                yield self.finding(
                    ctx, node, f"{what}() without generator= draws from "
                    "the process-global generator; pass a seeded "
                    "torch.Generator")


@register
class UnseededGenerator(Rule):
    id = "TRNG003"
    severity = "error"
    description = ("torch.Generator(...) not followed at once by "
                   ".manual_seed(<expr>): its seed is the default one")
    contract = _CONTRACT

    def check_file(self, ctx: FileContext):
        seeded = set()
        for node in calls(ctx.tree):
            if method_name(node) == "manual_seed" and node.args \
                    and isinstance(node.func.value, ast.Call):
                seeded.add(id(node.func.value))
        for node in calls(ctx.tree):
            if dotted_name(node.func) == "torch.Generator" \
                    and id(node) not in seeded:
                yield self.finding(
                    ctx, node, "torch.Generator(...) without an immediate "
                    ".manual_seed(<seed>); write torch.Generator(device)"
                    ".manual_seed(seed)")


@register
class WallClockSeed(Rule):
    id = "TRNG004"
    severity = "error"
    description = ("seed from the wall clock or OS entropy (time.*, "
                   "datetime.now, os.urandom, uuid), or <gen>.seed()")
    contract = _CONTRACT

    def check_file(self, ctx: FileContext):
        for node in calls(ctx.tree):
            m = method_name(node) or dotted_name(node.func)
            if m == "seed" and not node.args and not node.keywords \
                    and isinstance(node.func, ast.Attribute) \
                    and dotted_name(node.func) not in _GLOBAL_SEEDS:
                yield self.finding(
                    ctx, node, ".seed() seeds from OS entropy; use "
                    ".manual_seed(<seed from config>)")
                continue
            exprs = list(node.args) if m.rsplit(".", 1)[-1] in _SEEDING \
                else []
            exprs += [kw.value for kw in node.keywords if kw.arg == "seed"]
            for expr in exprs:
                bad = next((s for s in ast.walk(expr)
                            if isinstance(s, ast.Call)
                            and dotted_name(s.func) in _TIME_CALLS), None)
                if bad is not None:
                    yield self.finding(
                        ctx, node, f"seed derived from "
                        f"{dotted_name(bad.func)}() is nondeterministic; "
                        "seeds are explicit or come from a config")
                    break
