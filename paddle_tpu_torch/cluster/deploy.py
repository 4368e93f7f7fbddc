"""Versioned deployments — canary traffic shifting, numerics-gated
promotion, instant zero-compile rollback.

The serving tier can cold-start any replica with zero step builds
from the artifact store (io/artifact_store.py) and restart replicas
under load without losing a request (pool.rolling_restart), but those
are mechanisms; this module is the POLICY that closes the deployment
loop: *ship, observe, revert*.

A **version** is an immutable, nameable deployment unit — a
``save_inference_model`` directory plus everything embedded in it:
the ``__artifacts__`` compiled-executable snapshot, the params
manifest sha256, and the monotonically stamped ``model_version`` from
``__meta__.json``. :class:`DeploymentManager` lets one
:class:`~paddle_tpu_torch.cluster.pool.ReplicaPool` serve two versions side
by side and walks a candidate through the production gauntlet:

1. **dark deploy** — k replicas are drained and converted to the
   canary's factory (the pool's zero-loss restart choreography, so no
   request is dropped by the conversion itself) while the router's
   version weights keep the canary at exactly zero traffic;
2. **numerics gate** — the canary replays a recorded golden-request
   set and its outputs are tolerance-compared against the incumbent's
   recorded references (optcheck-style ``|a-b| <= atol + rtol*|b|``,
   the TPU-MLIR verify-before-deploy discipline, arXiv:2210.15016)
   BEFORE any traffic touches it, and re-sampled at every ramp stage;
3. **staged ramp** — ``promote()`` walks the weight schedule
   (1% → 50% → 100% by default) and at each stage compares the
   canary's error rate and p99 against the incumbent's through the
   pool's per-version merged metrics, with configured guardrail
   margins;
4. **auto-reject + instant rollback** — any gate failure repoints the
   router weights to the incumbent (instant: the very next request
   draw cannot pick the canary) and rolls the canary replicas back to
   the incumbent's factory; with an artifact store behind the
   factories the re-warm builds no step, and the drain-based restart
   guarantees zero lost requests.

Chaos coverage: the ``serving_canary_regression`` fault point
(resilience/faultinject.py) perturbs the canary's golden-set outputs
past any sane tolerance, so the auto-reject path is drillable —
``chip_smoke.py``'s ``cluster_remote`` phase runs two canaries under
load on the card. (Port of ``paddle_tpu/cluster/deploy.py``.)
"""
import os
import time

import numpy as np

from ..resilience import faultinject as _faultinject
from ..serving.metrics import ServingMetrics

__all__ = ["DeploymentError", "Guardrails", "ModelVersion",
           "DeploymentManager", "check_numerics",
           "evaluate_guardrails"]

# how hard the serving_canary_regression fault shoves the canary's
# outputs — far past any plausible promotion tolerance
_FAULT_PERTURBATION = 1.0


class DeploymentError(RuntimeError):
    """A deployment operation was impossible (no golden set, unknown
    version, canary already active, ...) — distinct from a REJECTED
    promotion, which is a normal, reported outcome."""


def check_numerics(reference, candidate, rtol=1e-5, atol=1e-7):
    """Tolerance-compare a candidate's golden-set outputs against the
    recorded references: every array must satisfy
    ``|got - ref| <= atol + rtol * |ref|`` elementwise (optcheck's
    comparison, applied to deployments). Returns a plain-dict report;
    shape/arity mismatches and non-finite drift fail loudly — a
    canary that changed its output contract must never promote."""
    report = {"ok": True, "n_requests": len(reference),
              "max_abs_err": 0.0, "max_rel_err": 0.0,
              "rtol": float(rtol), "atol": float(atol), "worst": None}
    if len(reference) != len(candidate):
        report["ok"] = False
        report["worst"] = (f"golden-set arity mismatch: "
                           f"{len(reference)} reference requests vs "
                           f"{len(candidate)} candidate")
        return report
    for i, (refs, gots) in enumerate(zip(reference, candidate)):
        if len(refs) != len(gots):
            report["ok"] = False
            report["worst"] = (f"request {i}: {len(refs)} reference "
                               f"fetches vs {len(gots)} candidate")
            return report
        for j, (ref, got) in enumerate(zip(refs, gots)):
            ref = np.asarray(ref, dtype=np.float64)
            got = np.asarray(got, dtype=np.float64)
            if ref.shape != got.shape:
                report["ok"] = False
                report["worst"] = (f"request {i} fetch {j}: shape "
                                   f"{got.shape} vs reference "
                                   f"{ref.shape}")
                return report
            abs_err = np.abs(got - ref)
            bound = atol + rtol * np.abs(ref)
            max_abs = float(abs_err.max()) if abs_err.size else 0.0
            denom = np.maximum(np.abs(ref), atol)
            max_rel = (float((abs_err / denom).max())
                       if abs_err.size else 0.0)
            report["max_abs_err"] = max(report["max_abs_err"], max_abs)
            report["max_rel_err"] = max(report["max_rel_err"], max_rel)
            bad = ~np.isfinite(got) | (abs_err > bound)
            if bad.any():
                report["ok"] = False
                if report["worst"] is None:
                    report["worst"] = (
                        f"request {i} fetch {j}: max |err| "
                        f"{max_abs:.3e} exceeds "
                        f"{atol:.1e} + {rtol:.1e}*|ref|")
    return report


class Guardrails:
    """The knobs a promotion must stay inside (the reference's
    docs/SERVING.md "Deploying a new version" documents each):

    - ``rtol``/``atol`` — numerics-gate tolerance for the golden-set
      comparison;
    - ``max_error_rate_delta`` — the canary's error rate (errors +
      timeouts over requests) may exceed the incumbent's by at most
      this absolute fraction;
    - ``max_p99_ratio``/``p99_floor_ms`` — the canary's request p99
      must stay under ``max(incumbent_p99 * ratio, floor)``; the
      floor keeps microsecond-noise from failing an idle canary;
    - ``min_canary_requests`` — error/latency guardrails only judge
      once the canary has answered this many requests at the current
      stage (the numerics gate needs no traffic and always runs).
    """

    def __init__(self, rtol=1e-5, atol=1e-7, max_error_rate_delta=0.02,
                 max_p99_ratio=3.0, p99_floor_ms=50.0,
                 min_canary_requests=20):
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.max_error_rate_delta = float(max_error_rate_delta)
        self.max_p99_ratio = float(max_p99_ratio)
        self.p99_floor_ms = float(p99_floor_ms)
        self.min_canary_requests = int(min_canary_requests)

    def to_dict(self):
        return {"rtol": self.rtol, "atol": self.atol,
                "max_error_rate_delta": self.max_error_rate_delta,
                "max_p99_ratio": self.max_p99_ratio,
                "p99_floor_ms": self.p99_floor_ms,
                "min_canary_requests": self.min_canary_requests}


def _error_rate(stats, baseline=None):
    """(errors + timeouts) / requests over the window since
    ``baseline`` (a previous per-version stats snapshot), or over all
    time when no baseline. Returns (rate, n_requests)."""
    baseline = baseline or {}

    def delta(name):
        return (stats.get(name, 0) or 0) - (baseline.get(name, 0) or 0)

    requests = delta("requests_total")
    errors = delta("errors_total") + delta("timeouts_total")
    return ((errors / requests) if requests > 0 else 0.0,
            requests)


def evaluate_guardrails(canary_stats, incumbent_stats, guardrails,
                        canary_baseline=None, incumbent_baseline=None):
    """Pure guardrail check over two per-version merged stats
    snapshots (``pool.stats()["versions"][...]`` shape). Returns the
    list of violation strings — empty means the canary is inside the
    rails. Insufficient canary traffic (< ``min_canary_requests``
    since the baseline) returns no violations: an unjudgeable stage
    is not a failing stage (the numerics gate still guards it)."""
    violations = []
    can_rate, can_n = _error_rate(canary_stats, canary_baseline)
    if can_n < guardrails.min_canary_requests:
        return violations
    inc_rate, _ = _error_rate(incumbent_stats, incumbent_baseline)
    if can_rate > inc_rate + guardrails.max_error_rate_delta:
        violations.append(
            f"error-rate regression: canary {can_rate:.4f} vs "
            f"incumbent {inc_rate:.4f} "
            f"(+{guardrails.max_error_rate_delta} allowed)")
    can_lat = (canary_stats.get("request_latency") or {})
    inc_lat = (incumbent_stats.get("request_latency") or {})
    can_p99 = can_lat.get("p99_ms")
    inc_p99 = inc_lat.get("p99_ms")
    if (can_p99 is not None
            and can_lat.get("count", 0)
            >= guardrails.min_canary_requests):
        bound = guardrails.p99_floor_ms
        if inc_p99 is not None:
            bound = max(bound, inc_p99 * guardrails.max_p99_ratio)
        if can_p99 > bound:
            violations.append(
                f"p99 regression: canary {can_p99:.1f}ms vs bound "
                f"{bound:.1f}ms (incumbent p99 "
                f"{'n/a' if inc_p99 is None else f'{inc_p99:.1f}ms'}, "
                f"ratio {guardrails.max_p99_ratio}, floor "
                f"{guardrails.p99_floor_ms}ms)")
    return violations


class ModelVersion:
    """One immutable, nameable deployment unit.

    ``factory`` is the zero-arg engine factory the pool rebuilds
    replicas from; ``model_dir`` (optional but recommended) pins the
    identity — the params-manifest sha256, the ``__artifacts__``
    snapshot, and the export's ``model_version`` stamp are read from
    it. ``eval_fn`` (feed-dict → list of fetch arrays) overrides the
    default golden-set evaluation path — scriptable fakes use it to
    unit-test the gate without real engines."""

    def __init__(self, name, factory, model_dir=None, eval_fn=None,
                 golden=None):
        self.name = str(name)
        self.factory = factory
        self.model_dir = (None if model_dir is None
                          else os.path.abspath(model_dir))
        self.eval_fn = eval_fn
        self._golden = golden
        self.params_sha = None
        self.model_version = None
        self.has_artifacts = False
        if self.model_dir is not None:
            import json
            from ..io import PARAMS_MANIFEST
            from ..io.artifact_store import EMBEDDED_DIRNAME
            try:
                with open(os.path.join(self.model_dir,
                                       PARAMS_MANIFEST)) as f:
                    self.params_sha = json.load(f).get("sha256")
            except (OSError, ValueError):
                pass
            try:
                with open(os.path.join(self.model_dir,
                                       "__meta__.json")) as f:
                    self.model_version = json.load(f).get(
                        "model_version")
            except (OSError, ValueError):
                pass
            self.has_artifacts = os.path.isdir(
                os.path.join(self.model_dir, EMBEDDED_DIRNAME))

    def golden(self):
        """The recorded golden-request set ``(feeds, outputs)`` —
        explicit beats on-disk (``__golden__.npz`` next to the saved
        model), None when neither exists."""
        if self._golden is not None:
            return self._golden
        if self.model_dir is not None:
            from .. import io as fluid_io
            return fluid_io.load_golden_set(self.model_dir)
        return None

    def set_golden(self, feeds, outputs):
        self._golden = (list(feeds), [list(o) for o in outputs])
        return self

    def snapshot(self):
        return {"name": self.name, "model_dir": self.model_dir,
                "params_sha": self.params_sha,
                "model_version": self.model_version,
                "has_artifacts": self.has_artifacts}

    def __repr__(self):
        return (f"ModelVersion({self.name!r}, "
                f"model_version={self.model_version}, "
                f"sha={(self.params_sha or '?')[:12]})")


class DeploymentManager:
    """Versioned deployments over one Router + ReplicaPool.

    ::

        mgr = DeploymentManager(router)
        mgr.register("v1", model_dir=v1_dir)
        mgr.register("v2", model_dir=v2_dir)
        mgr.set_incumbent("v1")
        mgr.record_golden(sample_feeds)      # pin the references
        report = mgr.deploy_canary("v2")     # dark + numerics-gated
        if report["accepted"]:
            report = mgr.promote()           # 1% → 50% → 100%, gated

    Every gate failure auto-rolls-back; ``rollback()`` is also the
    operator's big red button. All traffic keeps flowing throughout —
    conversions ride the pool's drain-based restart, and the router's
    weighted candidate ordering keeps every weight>0 version available
    as a failover target."""

    def __init__(self, router, guardrails=None, drain_timeout=None):
        self.router = router
        self.pool = router.pool
        self.guardrails = guardrails or Guardrails()
        self.drain_timeout = drain_timeout
        self._versions = {}
        self._incumbent = None
        self._canary = None
        self.history = []           # every deploy/promote/rollback report

    # -- registry --------------------------------------------------------
    def register(self, name, model_dir=None, factory=None,
                 eval_fn=None, golden=None, **engine_kw):
        """Name a version. Either ``factory`` (zero-arg → started
        engine) or ``model_dir`` (a ``save_inference_model`` export —
        the factory becomes ``ServingEngine.from_saved_model`` over
        it, picking up embedded buckets; its artifact store only with
        ``compile_store=True`` in ``engine_kw``, ROADMAP.md §3 F6)."""
        if factory is None:
            if model_dir is None:
                raise DeploymentError(
                    f"version {name!r} needs a factory or a model_dir")
            from ..serving.engine import ServingEngine
            the_dir = os.path.abspath(model_dir)

            def factory(_dir=the_dir, _kw=dict(engine_kw)):
                return ServingEngine.from_saved_model(_dir, **_kw)
        version = ModelVersion(name, factory, model_dir=model_dir,
                               eval_fn=eval_fn, golden=golden)
        self._versions[version.name] = version
        return version

    def version(self, name):
        try:
            return self._versions[name]
        except KeyError:
            raise DeploymentError(
                f"unknown version {name!r}; registered: "
                f"{sorted(self._versions)}") from None

    @property
    def incumbent(self):
        return self._incumbent

    @property
    def canary(self):
        return self._canary

    def set_incumbent(self, name):
        """Declare the version the pool is CURRENTLY serving: every
        replica is labeled with it and the router routes to it alone
        (weight 1.0). The starting state of every deployment."""
        version = self.version(name)
        if self._canary is not None:
            raise DeploymentError(
                f"cannot repoint incumbent while canary "
                f"{self._canary!r} is active — promote or roll back "
                "first")
        for r in self.pool.replicas():
            r.version = version.name
        self.router.set_weights({version.name: 1.0})
        self._incumbent = version.name
        return version

    # -- golden set ------------------------------------------------------
    def record_golden(self, feeds, save=True):
        """Record the incumbent's outputs on ``feeds`` as the pinned
        references every candidate must reproduce; persisted next to
        the incumbent's saved model (``__golden__.npz``) when it has
        one, so the references survive the process."""
        incumbent = self.version(self._require_incumbent())
        feeds = list(feeds)
        outputs = self._eval_version(incumbent, feeds, canary=False)
        incumbent.set_golden(feeds, outputs)
        if save and incumbent.model_dir is not None:
            from .. import io as fluid_io
            fluid_io.save_golden_set(incumbent.model_dir, feeds,
                                     outputs)
        return outputs

    # -- the gauntlet ----------------------------------------------------
    def deploy_canary(self, name, replicas=1):
        """Dark-deploy ``name`` onto ``replicas`` pool members and run
        the pre-traffic numerics gate. The canary carries ZERO traffic
        until :meth:`promote` ramps it (the conversion happens behind
        an incumbent-only weight map, and the drain-based restart
        loses no in-flight request). A numerics failure auto-rolls
        back and returns the rejected report."""
        incumbent = self.version(self._require_incumbent())
        canary = self.version(name)
        if canary.name == incumbent.name:
            raise DeploymentError(
                f"{name!r} is already the incumbent")
        if self._canary is not None:
            raise DeploymentError(
                f"canary {self._canary!r} already active — promote "
                "or roll back first")
        pool_size = len(self.pool.replicas())
        replicas = int(replicas)
        if not 1 <= replicas < pool_size:
            raise DeploymentError(
                f"canary size {replicas} must leave at least one "
                f"incumbent replica (pool has {pool_size})")
        t0 = time.monotonic()
        # 1. the canary is dark: only the incumbent can win the draw
        self.router.set_weights({incumbent.name: 1.0})
        # 2. convert the newest k replicas (drain → rebuild → warm)
        targets = [r for r in self.pool.replicas()
                   if r.version == incumbent.name][-replicas:]
        convert = self.pool.restart_replicas(
            targets, factory=canary.factory, version=canary.name,
            drain_timeout=self.drain_timeout)
        self._canary = canary.name
        report = {"action": "deploy_canary", "canary": canary.snapshot(),
                  "incumbent": incumbent.snapshot(),
                  "replicas": convert["restarted"],
                  "rewarm": convert["rewarm"],
                  "rewarm_compiles": _sum_compiles(convert["rewarm"])}
        # 3. numerics gate BEFORE any traffic
        numerics = self._numerics_gate(canary)
        report["numerics"] = numerics
        if not numerics["ok"]:
            rollback = self.rollback(
                reason=f"numerics gate failed before traffic: "
                       f"{numerics.get('worst')}")
            report.update(accepted=False, rejected="numerics",
                          rollback=rollback)
        else:
            report.update(accepted=True,
                          wall_s=round(time.monotonic() - t0, 3))
        self.history.append(report)
        return report

    def promote(self, stages=(0.01, 0.5, 1.0), stage_s=2.0,
                poll_s=0.05, observe=None):
        """Walk the canary up the weight schedule, gated at every
        stage. Each sub-1.0 stage holds its weights for ``stage_s``
        seconds (polling every ``poll_s``; ``observe``, if given, is
        called once per stage as ``observe(stage_weight)`` and may
        drive traffic — tests and servebench use it), then judges:

        - **numerics re-sample** — the golden set replays through the
          canary again (in-flight regressions, e.g. a replica serving
          from corrupt memory, are caught mid-ramp, not just at t=0);
        - **guardrails** — the canary's error rate and p99 since the
          stage began, against the incumbent's, within
          ``Guardrails`` margins.

        Any violation auto-rejects: instant rollback, report says
        which gate and at which stage. The final 1.0 stage converts
        the remaining incumbent replicas to the canary (same
        zero-loss restart), makes the canary the new incumbent, and
        leaves the pool's factory pointing at it."""
        incumbent = self.version(self._require_incumbent())
        if self._canary is None:
            raise DeploymentError("no active canary to promote — "
                                  "deploy_canary() first")
        canary = self.version(self._canary)
        t0 = time.monotonic()
        timeline = []
        for stage in stages:
            stage = float(stage)
            if stage >= 1.0:
                break
            self.router.set_weights({incumbent.name: 1.0 - stage,
                                     canary.name: stage})
            baseline = self._version_stats()
            if observe is not None:
                observe(stage)
            deadline = time.monotonic() + float(stage_s)
            while time.monotonic() < deadline:
                time.sleep(poll_s)
            numerics = self._numerics_gate(canary)
            now = self._version_stats()
            violations = evaluate_guardrails(
                now.get(canary.name) or {},
                now.get(incumbent.name) or {},
                self.guardrails,
                canary_baseline=baseline.get(canary.name),
                incumbent_baseline=baseline.get(incumbent.name))
            entry = {"stage": stage, "numerics": numerics,
                     "violations": violations}
            timeline.append(entry)
            if not numerics["ok"] or violations:
                reason = ("numerics re-sample failed at stage "
                          f"{stage:g}: {numerics.get('worst')}"
                          if not numerics["ok"] else
                          f"guardrails at stage {stage:g}: "
                          + "; ".join(violations))
                rollback = self.rollback(reason=reason)
                report = {"action": "promote", "accepted": False,
                          "rejected": ("numerics"
                                       if not numerics["ok"]
                                       else "guardrails"),
                          "stage": stage, "timeline": timeline,
                          "reason": reason, "rollback": rollback,
                          "wall_s": round(time.monotonic() - t0, 3)}
                self.history.append(report)
                return report
        # final stage: the canary won — convert the rest of the pool
        numerics = self._numerics_gate(canary)
        if not numerics["ok"]:
            reason = ("numerics re-sample failed before full "
                      f"conversion: {numerics.get('worst')}")
            rollback = self.rollback(reason=reason)
            report = {"action": "promote", "accepted": False,
                      "rejected": "numerics", "stage": 1.0,
                      "timeline": timeline, "reason": reason,
                      "rollback": rollback,
                      "wall_s": round(time.monotonic() - t0, 3)}
            self.history.append(report)
            return report
        convert = self.pool.restart_replicas(
            None, factory=canary.factory, version=canary.name,
            drain_timeout=self.drain_timeout)
        self.router.set_weights({canary.name: 1.0})
        self._incumbent = canary.name
        self._canary = None
        report = {"action": "promote", "accepted": True,
                  "new_incumbent": canary.snapshot(),
                  "timeline": timeline,
                  "final_convert": convert["restarted"],
                  "rewarm_compiles": _sum_compiles(convert["rewarm"]),
                  "wall_s": round(time.monotonic() - t0, 3)}
        self.history.append(report)
        return report

    def rollback(self, reason="operator"):
        """Instant revert to the incumbent: the weight map repoints
        FIRST (the next candidate draw cannot pick the canary — the
        data-plane rollback is one dict swap), then the canary
        replicas drain and rebuild back onto the incumbent's factory.
        With the incumbent's artifact store embedded in its saved
        model, the re-warm performs zero step builds
        (``rewarm_compiles`` in the report is the proof), and the
        drain guarantees the canary's in-flight requests finish —
        rollback loses nothing."""
        incumbent = self.version(self._require_incumbent())
        t0 = time.monotonic()
        self.router.set_weights({incumbent.name: 1.0})
        repoint_s = time.monotonic() - t0
        targets = [r for r in self.pool.replicas()
                   if r.version not in (None, incumbent.name)]
        convert = (self.pool.restart_replicas(
            targets, factory=incumbent.factory,
            version=incumbent.name,
            drain_timeout=self.drain_timeout)
            if targets else {"restarted": [], "rewarm": {}})
        self._canary = None
        report = {"action": "rollback", "reason": reason,
                  "incumbent": incumbent.snapshot(),
                  "replicas": convert["restarted"],
                  "rewarm": convert["rewarm"],
                  "rewarm_compiles": _sum_compiles(convert["rewarm"]),
                  "repoint_s": round(repoint_s, 6),
                  "serving_rollback_s": round(
                      time.monotonic() - t0, 3)}
        self.history.append(report)
        return report

    # -- gates -----------------------------------------------------------
    def _numerics_gate(self, canary):
        """Replay the incumbent's golden set through the canary and
        tolerance-compare. No golden set is a hard error — promoting
        unverified would defeat the whole subsystem."""
        incumbent = self.version(self._require_incumbent())
        golden = incumbent.golden()
        if golden is None:
            raise DeploymentError(
                f"incumbent {incumbent.name!r} has no recorded "
                "golden-request set — record_golden() (or export one "
                "with io.save_golden_set) before deploying a canary")
        feeds, reference = golden
        candidate = self._eval_version(canary, feeds, canary=True)
        return check_numerics(reference, candidate,
                              rtol=self.guardrails.rtol,
                              atol=self.guardrails.atol)

    def _eval_version(self, version, feeds, canary):
        """A version's outputs on the golden feeds, via its
        ``eval_fn`` when given (scriptable fakes), else by running
        the feeds through one of its live pool replicas' engines
        (or a throwaway engine when it has no replica yet). The
        ``serving_canary_regression`` fault point perturbs CANARY
        evaluations only — the incumbent's references stay honest."""
        if version.eval_fn is not None:
            outs = [list(version.eval_fn(feed)) for feed in feeds]
        else:
            eng, throwaway = self._eval_engine(version)
            try:
                outs = [_run_golden(eng, feed) for feed in feeds]
            finally:
                if throwaway:
                    eng.close()
        if canary and _faultinject.fires("serving_canary_regression"):
            outs = [[np.asarray(o, dtype=np.float64)
                     + _FAULT_PERTURBATION for o in row]
                    for row in outs]
        return outs

    def _eval_engine(self, version):
        for r in self.pool.replicas():
            if (r.version == version.name and not r.restarting
                    and hasattr(r, "engine")):
                return r.engine, False
        return version.factory(), True

    # -- introspection ---------------------------------------------------
    def _require_incumbent(self):
        if self._incumbent is None:
            raise DeploymentError(
                "no incumbent declared — set_incumbent() first")
        return self._incumbent

    def _version_stats(self):
        return self.pool.stats().get("versions") or {}

    def status(self):
        """Operator snapshot: live weights, per-version merged
        metrics, and the label-namespaced combined registry (every
        version's counters side by side under ``"<version>/..."``
        keys — nothing collides)."""
        by_version = {}
        for r in self.pool.replicas():
            m = r.metrics_obj()
            if m is not None and r.version is not None:
                by_version.setdefault(r.version, []).append(m)
        labeled = [ServingMetrics.merge(*ms, label=v)
                   for v, ms in sorted(by_version.items())]
        return {"incumbent": self._incumbent,
                "canary": self._canary,
                "weights": self.router.weights(),
                "versions": self._version_stats(),
                "combined": (ServingMetrics.merge(*labeled).stats()
                             if labeled else None),
                "guardrails": self.guardrails.to_dict(),
                "registered": {n: v.snapshot()
                               for n, v in self._versions.items()}}


def _sum_compiles(rewarm):
    """Total compiles across a restart report's rewarm entries — the
    number the zero-compile rollback guarantee pins to 0."""
    total = 0
    for rep in (rewarm or {}).values():
        if isinstance(rep, dict):
            total += int(rep.get("compiles") or 0)
    return total


def _run_golden(engine, feed):
    """One golden feed through an engine's executor, off the batching
    path (deterministic, single-row — the same shapes warmup pinned,
    so this compiles nothing new). The scope is passed explicitly:
    swapping the process-global scope would race the live engines'
    worker threads."""
    out = engine.exe.run(engine.program, feed=feed,
                         fetch_list=engine.fetch_list, mode="test",
                         scope=engine.scope)
    return [np.asarray(o) for o in out]
