"""Driver of the G-Sampler grid search: a closed loop of rounds, each one
``gsampler_search_grid`` call over a round of conditions drawn from the
seed, the (network, accelerator) pairs packed once in set-up and stacked
for each round (``cost_model.stack_workloads``), as a sweep over fixed
networks and parts does.

The mix's keys: ``conditions_per_round`` (C), ``budget_mb`` and ``batch``
(distribution specs, ``harness.traffic``), ``check_answers`` (how many
answers the reference re-derives after the window), ``trace_rounds`` (the
rounds a ``--trace 1`` run profiles).

What ``correct`` compares, per answer (the best strategy of a condition):
its format, and the latency, peak memory and validity the program reports
against the reference cost model (``reference/fusion_cost.py``, float64);
and the answers' quality against the reference's own naive strategy.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import traffic
from perfbench.reference import fusion_cost as ref

MB = float(2 ** 20)
# The numbers compared and their limits (PERF.md gives the readings each
# was set from).  lat_gap, peak_gap: the largest relative gap of an
# answer's reported latency and peak memory to the reference's; flips:
# answers whose reported validity the reference contradicts, outside a
# band of VALID_BAND x budget where the two precisions may round apart;
# malformed: conditions of a completed round without a well-formed answer;
# lat_vs_naive: the geometric mean of an answer's reference latency over
# the reference's naive strategy's (a search that does not search reads
# near 1).
LIMITS = {"malformed": 0, "flips": 0, "lat_gap": 2e-4, "peak_gap": 2e-4,
          "lat_vs_naive": 0.8}
VALID_BAND = 1e-6


class Run:
    """One run of a ``search_grid`` cell: ``setup``, ``window``,
    ``release``, ``check``."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.C = int(mix["conditions_per_round"])
        self.rounds: list[dict] = []
        self.fe_calls: list[tuple] = []
        self.live_of: dict[int, int] = {}
        self.stages: dict[str, float] = {}

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import cost_model as cm, gsampler as gs
        from repro_torch.core.accel import AccelConfig
        from repro_torch.workloads.layer import Layer, Workload
        self.cm, self.gs = cm, gs
        cfg = self.config
        self.net_names = sorted(cfg["networks"])
        self.part_names = sorted(cfg["parts"])
        cols = ref.COLUMNS
        self.nets, self.n_of = [], []
        for name in self.net_names:
            net = cfg["networks"][name]
            layers = []
            for row in net["layers"]:
                r = dict(zip(cols, row))
                layers.append(Layer(
                    r["name"], r["K"], r["C"], r["Y"], r["X"], r["R"], r["S"],
                    r["stride"], r["groups"], r["skip_src"],
                    macs_override=r["macs"], out_elems_override=r["out_elems"],
                    w_elems_override=r["w_elems"]))
            self.nets.append(Workload(name, layers, net["input_elems"],
                                      tuple(net["input_shape6"])))
            self.n_of.append(len(layers))
        self.parts = [AccelConfig(name=p, **cfg["parts"][p])
                      for p in self.part_names]
        nmax = int(cfg["nmax"])
        self.packs = [[cm.pack_workload(w, h, nmax, device=self.device)
                       for h in self.parts] for w in self.nets]
        self.gcfg = dict(cfg["gsampler"])
        self.draws = traffic.rng_for(self.seed, 1)
        warm = traffic.rng_for(self.seed, 0)
        t = time.perf_counter()
        for _ in range(2):          # the second finds the allocator grown
            self._round(self._draw(warm))
        self._sync()
        self.stages["warm_s"] = time.perf_counter() - t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _draw(self, rng) -> dict:
        C = self.C
        net = rng.integers(0, len(self.nets), C)
        part = rng.integers(0, len(self.parts), C)
        budget = (traffic.draw(self.mix["budget_mb"], rng, C) * MB).astype(
            np.float32)
        batch = traffic.draw(self.mix["batch"], rng, C).astype(np.int64)
        gseed = int(rng.integers(0, 2 ** 62))
        return dict(net=net, part=part, budget=budget, batch=batch,
                    gseed=gseed)

    def _round(self, r: dict):
        """One ``gsampler_search_grid`` call; returns its result (the
        program copies its answers to the host, so the round has ended on
        the card when this returns)."""
        packed = self.cm.stack_workloads([self.packs[a][b] for a, b in
                                          zip(r["net"], r["part"])])
        self.live_of[id(packed)] = int(sum(self.n_of[a] for a in r["net"]))
        cfg = self.gs.GSamplerConfig(seed=r["gseed"], **self.gcfg)
        out = self.gs.gsampler_search_grid(
            [self.nets[a] for a in r["net"]],
            [self.parts[b] for b in r["part"]], r["batch"], r["budget"],
            nmax=int(self.config["nmax"]), cfg=cfg,
            top_k=int(self.config["top_k"]), packed=packed,
            device=self.device)
        return out

    # -- the window --------------------------------------------------------
    def window(self, seconds: float) -> dict:
        """Rounds back to back until ``seconds`` have passed; the window
        ends with the last round."""
        t0 = time.perf_counter()
        while True:
            self._answer(self._draw(self.draws))
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        n = self.C * len(self.rounds)
        return {"attempted": n, "failed": 0, "e2e": {"cond_s": n / wall},
                "conditions": n}

    def _answer(self, r: dict) -> None:
        out = self._round(r)
        r.update(strategy=out.strategies[:, 0], latency=out.latency[:, 0],
                 peak=out.peak_mem[:, 0], valid=out.valid[:, 0])
        self.rounds.append(r)

    def traced_window(self) -> dict:
        """The mix's ``trace_rounds`` rounds (the caller times them once
        without its profiler, then profiles them once more), with every
        fusion_eval call's (form, C, POP, P, live positions)
        recorded around the cost model's two grid evaluators."""
        cm = self.cm
        grid, stats = cm.evaluate_grid, cm.evaluate_grid_stats
        start, self.fe_calls = len(self.rounds), []

        def rec(form, fn):
            def call(wls, strategies, *a, **k):
                C, POP, P = strategies.shape
                self.fe_calls.append((form, C, POP, P, self.live_of[id(wls)]))
                return fn(wls, strategies, *a, **k)
            return call
        cm.evaluate_grid, cm.evaluate_grid_stats = rec(0, grid), rec(1, stats)
        try:
            for _ in range(int(self.mix["trace_rounds"])):
                self._answer(self._draw(self.draws))
        finally:
            cm.evaluate_grid, cm.evaluate_grid_stats = grid, stats
        n = self.C * (len(self.rounds) - start)
        return {"attempted": n, "failed": 0, "conditions": n,
                "fe_calls": self.fe_calls}

    def release(self) -> None:
        self.packs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------
    def check(self, costs=None) -> dict:
        """The numbers compared, each with its limit.  ``costs`` stands in
        for the program's reported (latency, peak, valid) of an answer:
        the control passes the reference's own, computed in bfloat16."""
        cfg = self.config
        nmax = int(cfg["nmax"])
        malformed = 0
        for r in self.rounds:
            for c in range(len(r["net"])):
                s = r["strategy"][c]
                if s.shape != (nmax,) or not ref.well_formed(
                        s, self.n_of[r["net"][c]], int(r["batch"][c])):
                    malformed += 1
        pairs = [(i, c) for i, r in enumerate(self.rounds)
                 for c in range(len(r["net"]))]
        k = min(int(self.mix["check_answers"]), len(pairs))
        pick = traffic.rng_for(self.seed, 2).choice(len(pairs), k,
                                                    replace=False)
        packs = {}
        lat_gap = peak_gap = 0.0
        flips = 0
        logs = []
        for j in sorted(pick):
            i, c = pairs[j]
            r = self.rounds[i]
            a, b = int(r["net"][c]), int(r["part"][c])
            part = cfg["parts"][self.part_names[b]]
            key = (a, b)
            if key not in packs:
                packs[key] = ref.pack(cfg["networks"][self.net_names[a]],
                                      nmax, part["bytes_per_elem"])
            wl = packs[key]
            B, bud = float(r["batch"][c]), float(r["budget"][c])
            want = ref.evaluate(wl, r["strategy"][c], B, bud, part)
            if costs is None:
                got = (float(r["latency"][c]), float(r["peak"][c]),
                       bool(r["valid"][c]))
            else:
                got = costs(wl, r["strategy"][c], B, bud, part)
            lat_gap = max(lat_gap, abs(got[0] / want["latency"] - 1.0))
            peak_gap = max(peak_gap, abs(got[1] / want["peak_mem"] - 1.0))
            if (got[2] != want["valid"]
                    and abs(want["peak_mem"] / bud - 1.0) > VALID_BAND):
                flips += 1
            naive = ref.naive_uniform(wl, B, bud, part)
            ratio = (want["latency"] / naive["latency"] if want["valid"]
                     else 1e3)
            logs.append(math.log(ratio))
        lat_vs_naive = math.exp(sum(logs) / len(logs)) if logs else 1e3
        got = {"malformed": malformed, "flips": flips, "lat_gap": lat_gap,
               "peak_gap": peak_gap, "lat_vs_naive": lat_vs_naive}
        return {k: (v, LIMITS[k]) for k, v in got.items()}


def bf16_costs(wl, strategy, batch, budget, hw):
    """The control: the reference computed in bfloat16, in the program's
    place."""
    out = ref.evaluate(wl, strategy, batch, budget, hw, q=ref.bf16)
    return out["latency"], out["peak_mem"], out["peak_mem"] <= budget


CONTROL = bf16_costs
