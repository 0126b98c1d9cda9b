"""Background refresh: drift report -> teacher corpus -> fine-tune -> gated
hot swap.

Port of ``repro.serving.refresh``, the ACT half of the closed loop.  When
``drift.DriftMonitor`` fires a ``DriftReport``, the
:class:`RefreshWorker`, on the engine's device:

 1. **G-Samples a fresh teacher corpus for the drifted region** --
    ``dataset.generate_teacher_corpus`` over the report's (workloads x
    accels x budgets) grid;
 2. **fine-tunes off the serving path** -- ``core.train.fine_tune``
    warm-starts a COPY of the live model (the serving model is never
    mutated) and checkpoints to ``ckpt_dir``;
 3. **restores the candidate through the checkpoint upgrade path** --
    ``checkpoint.upgrade_pytree(prefix="params")`` on the written
    checkpoint, asserting zero missing leaves;
 4. **quality-gates** the candidate on a held-out probe grid -- drifted
    conditions at budgets the fine-tune corpus did NOT train on, plus
    retained (non-drifted) conditions sampled from the replay buffer.
    The candidate must match or beat the live model's probe score (mean
    of valid x speedup, one ``dnnfuser_infer_batch`` call per model --
    off the engine's signature/serving counters), within ``gate_tol``;
 5. on accept, **hot-swaps** via ``MapperEngine.swap_params`` with a
    region-scoped cache invalidation predicate and marks the region's
    conditions known (so the monitor stops re-firing on them).

``poll()`` is the serving loop's hook: it drains pending reports, merges
their regions, and runs ONE refresh -- a cheap no-op when nothing fired.
Everything here is synchronous host code; "background" means off the
request path (between ticks), not a thread.
"""
from __future__ import annotations

import copy
import tempfile

import numpy as np

from ..checkpoint import Checkpointer, upgrade_pytree
from ..core import cost_model as cm
from ..core.dataset import generate_teacher_corpus
from ..core.gsampler import GSamplerConfig
from ..core.infer import dnnfuser_infer_batch
from ..core.model import DTConfig, dt_loss, load_param_tree, param_tree
from ..core.train import TrainConfig, fine_tune
from .drift import region_key_predicate
from .engine import _accel_key

__all__ = ["RefreshWorker", "probe_score"]

MB = float(2 ** 20)


def _loss_for(cfg):
    """Imitation loss for a mapper config: the decision transformer's
    ``dt_loss``.  The seq2seq baseline is not ported."""
    if isinstance(cfg, DTConfig):
        return dt_loss
    raise TypeError(
        f"no imitation loss registered for {type(cfg).__name__}: the port "
        f"has only the decision transformer; the seq2seq baseline "
        f"(S2SConfig, core/seq2seq.py) is ROADMAP queue 1 item 5")


def probe_score(model, conds, *, repair: bool = True) -> float:
    """Mean quality of ``model`` over probe conditions ``(workload, batch,
    budget_bytes, accel)``: ``mean(valid * speedup)`` from one batched
    episode on the model's device, through the public batch API -- probe
    traffic never touches an engine's signature or cache accounting."""
    if not conds:
        return 0.0
    dev = next(model.parameters()).device
    nmax = max(w.n + 1 for w, _, _, _ in conds)
    rows = [cm.pack_workload(w, a, nmax, device=dev) for w, _, _, a in conds]
    out = dnnfuser_infer_batch(
        model, cm.stack_workloads(rows),
        np.asarray([b for _, b, _, _ in conds], np.float32),
        np.asarray([bb for _, _, bb, _ in conds], np.float32),
        hw=[a for _, _, _, a in conds], repair=repair, device=dev)
    q = (out["valid"].float() * out["speedup"]).cpu().numpy()
    return float(np.mean(q))


class RefreshWorker:
    """Owns the corpus -> fine-tune -> gate -> swap pipeline for one engine.

    Knobs: ``train`` / ``ga`` -- fine-tune and teacher budgets (defaults
    are refresh-sized); ``batch`` / ``top_k`` -- teacher corpus shape
    (``top_k`` defaults LOW, 2: the conditioning return is the memory
    fraction, not the achieved speedup, so deep elite lists of mixed
    quality dilute the refresh policy); ``gate_tol`` -- how much probe
    quality the candidate may give up and still swap (0 = must match or
    beat); ``probe_shift`` -- relative budget shift for held-out probe
    conditions; ``max_probe`` -- probe-grid cap per side (drifted /
    retained); ``ckpt_dir`` -- where fine-tune checkpoints land (a temp
    dir per refresh when None)."""

    def __init__(self, engine, *, train: TrainConfig | None = None,
                 ga: GSamplerConfig | None = None, batch: int = 64,
                 top_k: int = 2, loss_fn=None, ckpt_dir=None,
                 seed: int = 0, gate_tol: float = 0.0,
                 probe_shift: float = 0.15, max_probe: int = 8):
        self.engine = engine
        self.train = train or TrainConfig(steps=200, batch_size=16,
                                          lr=1e-4, warmup=20)
        self.ga = ga or GSamplerConfig(population=24, generations=16)
        self.batch = int(batch)
        self.top_k = int(top_k)
        self.loss_fn = loss_fn
        self.ckpt_dir = ckpt_dir
        self.seed = int(seed)
        self.gate_tol = float(gate_tol)
        self.probe_shift = float(probe_shift)
        self.max_probe = int(max_probe)
        self.refreshes = 0
        self.last_result: dict | None = None

    # -- serving-loop hook ---------------------------------------------------

    def poll(self) -> dict | None:
        """Drain pending drift reports; if any fired, merge their regions
        and run one refresh.  Returns the refresh summary, or None when
        nothing fired."""
        reports = self.engine.monitor.pop_reports()
        if not reports:
            return None
        accels, wls, budgets = {}, {}, set()
        for r in reports:
            accels.update({a.name: a for a in r.accels})
            wls.update({w.name: w for w in r.workloads})
            budgets.update(r.budgets_mb)
        return self.refresh(list(wls.values()), list(accels.values()),
                            sorted(budgets))

    # -- the pipeline --------------------------------------------------------

    def refresh(self, workloads: list, accels: list,
                budgets_mb: list) -> dict:
        """Run corpus -> fine-tune -> gate -> (maybe) swap for one drifted
        region.  Returns a summary dict (``accepted``, scores, corpus
        size, ...)."""
        engine = self.engine
        if not (workloads and accels and budgets_mb):
            raise ValueError("refresh needs a non-empty region: got "
                             f"{len(workloads)} workloads, {len(accels)} "
                             f"accels, {len(budgets_mb)} budgets")
        loss = self.loss_fn or _loss_for(engine.cfg)
        # canonical region order: the grid teacher's random draws depend on
        # grid POSITION, so the corpus (and the candidate) must not depend
        # on which condition arrived more often in the drifted window
        workloads = sorted(workloads, key=lambda w: w.name)
        accels = sorted(accels, key=lambda a: a.name)
        budgets_mb = sorted(budgets_mb)
        self.refreshes += 1
        extra = self._harvest_extra(workloads, accels, budgets_mb)
        corpus = generate_teacher_corpus(
            workloads, accels, batch=self.batch, budgets_mb=list(budgets_mb),
            max_steps=engine.cfg.max_steps, top_k=self.top_k,
            ga_cfg=self.ga, seed=self.seed + self.refreshes,
            extra_elites=extra or None, device=engine.device)
        ckpt_dir = self.ckpt_dir or tempfile.mkdtemp(prefix="repro_refresh_")
        _, log = fine_tune(loss, engine.model, corpus, self.train,
                           ckpt_dir=ckpt_dir, device=engine.device)
        # the candidate that swaps is the one read back through the
        # checkpoint upgrade path -- what a restarted process would serve --
        # not the in-memory model the trainer returned
        tree, missing = upgrade_pytree(
            Checkpointer(ckpt_dir).path(), param_tree(engine.model),
            prefix="params")
        if missing:
            raise RuntimeError(
                f"refresh checkpoint is missing {len(missing)} leaves "
                f"({missing[:3]}...): fine-tune must preserve the live "
                f"architecture")
        candidate = load_param_tree(copy.deepcopy(engine.model), tree)

        conds = self._probe_conds(workloads, accels, budgets_mb)
        live = probe_score(engine.model, conds, repair=engine.repair)
        cand = probe_score(candidate, conds, repair=engine.repair)
        accepted = cand >= live - self.gate_tol
        if accepted:
            # invalidation scope: strictly-UNSEEN conditions (a known
            # workload appearing in drifted records only because it rode
            # an unseen accel keeps its known-accel cache entries).  A
            # report with no unseen conditions at all (pure hit-decay /
            # violation drift) invalidates the whole region: those entries
            # are the stale ones that fired it.
            unseen_w = [w for w in workloads
                        if w.name not in engine.monitor.known_workloads]
            unseen_a = [a for a in accels
                        if a.name not in engine.monitor.known_accels]
            if not (unseen_w or unseen_a):
                unseen_w, unseen_a = workloads, accels
            pred = region_key_predicate(unseen_w, unseen_a, _accel_key)
            invalidated = engine.swap_params(candidate, invalidate=pred)
            engine.mark_known(accels=accels, workloads=workloads)
        else:
            invalidated = 0
            engine.swaps_rejected += 1
        self.last_result = {
            "accepted": bool(accepted),
            "live_score": live, "candidate_score": cand,
            "probe_conds": len(conds), "corpus_size": len(corpus),
            "fine_tune_loss": log["final_loss"],
            "cache_invalidated": invalidated,
            "extra_elites": sum(len(v) for v in extra.values()),
            "region": {"workloads": [w.name for w in workloads],
                       "accels": [a.name for a in accels],
                       "budgets_mb": list(budgets_mb)},
        }
        return self.last_result

    def _harvest_extra(self, workloads, accels, budgets_mb) -> dict:
        """Drain the engine's region-matched refinement wins into the
        ``generate_teacher_corpus(extra_elites=...)`` shape:
        ``(workload_name, accel_name, budget_mb)`` -> list of strategies.
        Wins at budgets outside the refresh grid stay in the engine's log
        (a later refresh over their region can still use them)."""
        grid = {round(float(b), 6) for b in budgets_mb}
        wins = self.engine.harvest_wins(workloads=workloads, accels=accels,
                                        drain=False)
        extra: dict = {}
        taken = []
        for w in wins:
            bmb = round(w["budget_bytes"] / MB, 6)
            if bmb not in grid:
                continue
            key = (w["workload"].name, w["accel"].name, bmb)
            extra.setdefault(key, []).append(w["strategy"])
            taken.append(w)
        for w in taken:                      # drain only what we consumed
            self.engine.wins.remove(w)
        return extra

    def _probe_conds(self, workloads, accels, budgets_mb) -> list:
        """Held-out probe grid: drifted (workload x accel) pairs at budgets
        shifted AWAY from the fine-tune corpus (x(1 +/- shift), never
        trained on), plus retained conditions sampled from the replay
        buffer OUTSIDE the drifted region (the gate must see that the
        candidate didn't rot the old regime)."""
        shift = self.probe_shift
        held = [b * (1.0 + s) for b in budgets_mb for s in (-shift, shift)]
        drifted = [(w, self.batch, b * MB, a)
                   for w in workloads for a in accels for b in held]
        rng = np.random.default_rng(self.seed + self.refreshes)
        if len(drifted) > self.max_probe:
            idx = rng.choice(len(drifted), self.max_probe, replace=False)
            drifted = [drifted[i] for i in sorted(idx)]
        wl_names = {w.name for w in workloads}
        accel_names = {a.name for a in accels}
        retained, seen = [], set()
        for rec in self.engine.monitor.replay:
            if (rec.workload.name in wl_names
                    or rec.accel.name in accel_names):
                continue
            key = (rec.workload.name, rec.batch,
                   float(rec.budget_bytes), rec.accel.name)
            if key in seen:
                continue
            seen.add(key)
            retained.append((rec.workload, rec.batch,
                             float(rec.budget_bytes), rec.accel))
        if len(retained) > self.max_probe:
            idx = rng.choice(len(retained), self.max_probe, replace=False)
            retained = [retained[i] for i in sorted(idx)]
        return drifted + retained

    def stats(self) -> dict:
        return {"refreshes": self.refreshes, "last_result": self.last_result}
