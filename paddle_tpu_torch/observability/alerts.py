"""Rule-based alerting over the serving time-series history
(counterpart of ``paddle_tpu/observability/alerts.py``: the same rules,
defaults and transitions).

Detectors evaluate the :class:`~.timeseries.TimeSeriesStore` windows
once per closed window, entirely on tick-derived data — same
determinism contract as the store itself, so a seeded fault storm
fires the same alerts at the same ticks every run (pinned by test).

Every rule carries HYSTERESIS: it must observe ``fire_for`` consecutive
bad windows before firing and ``clear_for`` consecutive healthy windows
before clearing, so a metric oscillating around a threshold can never
flap the alert. A firing transition:

* increments ``pt_serve_alerts_fired_total{engine,rule}`` and sets the
  ``pt_serve_alert_active{engine,rule}`` gauge;
* emits a structured ``alert`` tracer event (``alert_clear`` on the way
  back) — forced past the tracer's sample thinning, an alert is never
  dropped by rate-gating;
* (telemetry on) dumps a FlightRecorder artifact carrying the
  TRIGGERING WINDOW of series samples — the postmortem shows the burn
  building, not just that it fired.

``ALERT_RULES`` is the canonical rule registry: every implemented rule
must appear here, and :class:`AlertManager` enforces that at runtime.

The read-only hook the degradation ladder consumes
(``PT_FLAGS_slo_degradation``, default off): the engine's health tick
reads :meth:`AlertManager.is_active`\\("slo_burn_rate") and treats an
active burn as saturation pressure — capacity rungs only (shed batch /
throttle), never the fault jump; with the flag off the ladder's inputs
are untouched and outputs are pinned identical.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import flags
from .registry import get_registry

# ---------------------------------------------------------------------------
# the canonical rule registry: every AlertRule implementation's
# ``name`` must appear here — a detector cannot ship invisibly to the
# operator surface
# ---------------------------------------------------------------------------
ALERT_RULES: Dict[str, str] = {
    "slo_burn_rate": "multi-window SLO burn: TTFT/TPOT attainment "
                     "violations per class are eating error budget at "
                     ">= threshold x in BOTH the fast and slow windows",
    "queue_depth_growth": "admission queue depth grew monotonically "
                          "across the last windows and sits above the "
                          "floor — demand is outrunning service",
    "prefix_hit_collapse": "prefix-cache token hit-rate collapsed "
                           "below the floor after a healthy baseline "
                           "(eviction storm / working-set shift)",
    "spec_accept_collapse": "speculative-decode acceptance collapsed "
                            "below the floor after a healthy baseline "
                            "— verify passes are burning weight "
                            "streams for nothing",
    "recompile_post_seal": "a compiled serving program re-specialized "
                           "after the recompile watchdog sealed the "
                           "program set",
    "hbm_residency": "KV pool residency is pinned against pool "
                     "capacity — admission is about to block on pages",
}


class AlertRule:
    """Base detector: subclasses implement :meth:`check` over the
    store's sample list; :meth:`update` wraps it in the hysteresis
    state machine shared by every rule."""

    name = ""

    def __init__(self, fire_for: int = 2, clear_for: int = 3):
        if int(fire_for) < 1 or int(clear_for) < 1:
            raise ValueError(
                f"fire_for/clear_for must be >= 1; got "
                f"({fire_for}, {clear_for})")
        self.fire_for = int(fire_for)
        self.clear_for = int(clear_for)
        # trailing samples check() actually reads — the manager hands
        # every rule max(window_need) samples instead of copying the
        # whole retained ring each window
        self.window_need = 1
        self.active = False
        self.fired = 0
        self.value: Optional[float] = None  # last computed scalar
        self.peak = 0.0  # max scalar this measurement window
        self.detail: dict = {}
        self._bad_streak = 0
        self._good_streak = 0

    # -- subclass contract --
    def check(self, samples: List[dict]) -> Tuple[bool, dict]:
        """(condition_bad, detail) for the CURRENT window; ``detail``
        should carry a ``"value"`` scalar (the rule's headline
        number)."""
        raise NotImplementedError

    # -- hysteresis --
    def update(self, samples: List[dict]) -> Optional[str]:
        """One closed window: returns ``"fire"`` / ``"clear"`` on a
        state transition, else None."""
        if not samples:
            return None
        bad, detail = self.check(samples)
        self.detail = detail
        v = detail.get("value")
        if isinstance(v, (int, float)):
            self.value = float(v)
            if self.value > self.peak:
                self.peak = self.value
        if bad:
            self._bad_streak += 1
            self._good_streak = 0
            if not self.active and self._bad_streak >= self.fire_for:
                self.active = True
                self.fired += 1
                return "fire"
        else:
            self._good_streak += 1
            self._bad_streak = 0
            if self.active and self._good_streak >= self.clear_for:
                self.active = False
                return "clear"
        return None


def _sum_deltas(samples: List[dict], key: str) -> float:
    return sum(s["deltas"].get(key, 0.0) for s in samples)


class SLOBurnRate(AlertRule):
    """Multi-window burn-rate over TTFT/TPOT attainment: per SLO class,
    ``burn = (violated / tracked) / budget`` aggregated over a FAST and
    a SLOW window; the rule is bad when any class with enough tracked
    finishes burns >= ``threshold`` in BOTH windows (the classic
    fast-and-slow pairing: the slow window proves it's sustained, the
    fast window proves it's still happening)."""

    name = "slo_burn_rate"

    def __init__(self, budget: float = 0.1, threshold: float = 2.0,
                 fast_windows: int = 1, slow_windows: int = 4,
                 min_tracked: int = 2, **kw):
        super().__init__(**kw)
        if not 0 < budget <= 1:
            raise ValueError(f"budget must be in (0, 1]; got {budget}")
        self.budget = float(budget)
        self.threshold = float(threshold)
        self.fast_windows = max(int(fast_windows), 1)
        self.slow_windows = max(int(slow_windows), self.fast_windows)
        self.min_tracked = max(int(min_tracked), 1)
        self.window_need = self.slow_windows

    @staticmethod
    def _burns(samples, budget):
        agg: Dict[str, float] = {}
        for s in samples:
            for k, d in s["deltas"].items():
                if k.startswith(("slo_met:", "slo_violated:")):
                    agg[k] = agg.get(k, 0.0) + d
        out = {}
        for k in agg:
            if not k.startswith("slo_met:"):
                continue
            cls = k.split(":", 1)[1]
            met = agg.get(f"slo_met:{cls}", 0.0)
            vio = agg.get(f"slo_violated:{cls}", 0.0)
            tracked = met + vio
            if tracked > 0:
                out[cls] = ((vio / tracked) / budget, tracked)
        return out

    def check(self, samples):
        fast = self._burns(samples[-self.fast_windows:], self.budget)
        slow = self._burns(samples[-self.slow_windows:], self.budget)
        worst, worst_cls = 0.0, None
        for cls, (b_slow, tracked) in slow.items():
            if tracked < self.min_tracked or cls not in fast:
                continue
            b = min(fast[cls][0], b_slow)  # BOTH windows must burn
            if b > worst:
                worst, worst_cls = b, cls
        return worst >= self.threshold, {
            "value": round(worst, 4), "slo": worst_cls,
            "budget": self.budget, "threshold": self.threshold}


class QueueDepthGrowth(AlertRule):
    """Queue depth grew strictly across the last ``windows`` samples
    and ends >= ``min_depth`` — sustained demand the engine is not
    absorbing (the time-series view of saturation, vs backpressure()'s
    instantaneous verdict)."""

    name = "queue_depth_growth"

    def __init__(self, windows: int = 3, min_depth: int = 2, **kw):
        super().__init__(**kw)
        self.windows = max(int(windows), 2)
        self.min_depth = int(min_depth)
        self.window_need = self.windows

    def check(self, samples):
        win = samples[-self.windows:]
        depths = [s["gauges"].get("queue_depth", 0.0) for s in win]
        growing = (len(win) >= self.windows
                   and all(b > a for a, b in zip(depths, depths[1:]))
                   and depths[-1] >= self.min_depth)
        return growing, {"value": depths[-1] if depths else 0.0,
                         "depths": depths}


class _RatioCollapse(AlertRule):
    """Shared shape for hit-rate / acceptance collapse: the CURRENT
    window's ratio fell below ``floor`` while the BASELINE windows
    (the preceding ones) were healthy (>= ``healthy``) — a rule that
    only ever knew a cold cache must not page anyone."""

    _num = ""
    _den = ""

    def __init__(self, floor: float = 0.2, healthy: float = 0.4,
                 baseline_windows: int = 4, min_den: float = 4.0, **kw):
        super().__init__(**kw)
        self.floor = float(floor)
        self.healthy = float(healthy)
        self.baseline_windows = max(int(baseline_windows), 1)
        self.min_den = float(min_den)
        self.window_need = self.baseline_windows + 1

    def _ratio(self, samples):
        num = _sum_deltas(samples, self._num)
        den = _sum_deltas(samples, self._den)
        return (num / den if den > 0 else None), den

    def check(self, samples):
        cur, den = self._ratio(samples[-1:])
        base, base_den = self._ratio(
            samples[-1 - self.baseline_windows:-1])
        bad = (cur is not None and den >= self.min_den
               and cur < self.floor
               and base is not None and base_den >= self.min_den
               and base >= self.healthy)
        return bad, {"value": (round(cur, 4) if cur is not None
                               else None),
                     "baseline": (round(base, 4) if base is not None
                                  else None),
                     "floor": self.floor}


class PrefixHitCollapse(_RatioCollapse):
    name = "prefix_hit_collapse"
    _num = "prefix_hit_tokens"
    _den = "prefix_prompt_tokens"


class SpecAcceptCollapse(_RatioCollapse):
    name = "spec_accept_collapse"
    _num = "spec_accepted"
    _den = "spec_proposed"

    def __init__(self, floor: float = 0.15, healthy: float = 0.3,
                 **kw):
        super().__init__(floor=floor, healthy=healthy, **kw)


class RecompilePostSeal(AlertRule):
    """Any post-seal recompile counted by the watchdog inside the
    window is an incident on its own — ``fire_for`` defaults to 1
    (hysteresis still prevents re-firing while it stays active)."""

    name = "recompile_post_seal"

    def __init__(self, fire_for: int = 1, **kw):
        super().__init__(fire_for=fire_for, **kw)

    def check(self, samples):
        d = samples[-1]["deltas"].get("recompiles", 0.0)
        return d > 0, {"value": d}


class HbmResidency(AlertRule):
    """KV pool residency vs pool capacity: utilization pinned at
    >= ``threshold`` — the next admission wave blocks on pages."""

    name = "hbm_residency"

    def __init__(self, threshold: float = 0.97, **kw):
        super().__init__(**kw)
        self.threshold = float(threshold)

    def check(self, samples):
        util = samples[-1]["gauges"].get("kv_utilization", 0.0)
        return util >= self.threshold, {
            "value": round(util, 4), "threshold": self.threshold}


def default_rules() -> List[AlertRule]:
    """One instance of every registered rule, default tuning."""
    return [SLOBurnRate(), QueueDepthGrowth(), PrefixHitCollapse(),
            SpecAcceptCollapse(), RecompilePostSeal(), HbmResidency()]


class AlertManager:
    """Per-engine detector set evaluated once per closed time-series
    window (the engine calls :meth:`evaluate` from its scheduler tick
    — single-threaded writes; :meth:`snapshot` is copy-on-read for the
    scrape thread, the SAFE_READS contract)."""

    def __init__(self, label: str = "0",
                 rules: Optional[List[AlertRule]] = None,
                 tracer=None):
        self.label = str(label)
        self._rules = list(rules) if rules is not None \
            else default_rules()
        seen = set()
        for r in self._rules:
            if r.name not in ALERT_RULES:
                raise ValueError(
                    f"unknown alert rule {r.name!r} — register it in "
                    "observability.alerts.ALERT_RULES")
            if r.name in seen:
                raise ValueError(f"duplicate alert rule {r.name!r}")
            seen.add(r.name)
        self._window_need = max(
            (r.window_need for r in self._rules), default=1)
        self._tracer = tracer
        self._recorder = None
        reg = get_registry()
        L = ("engine", "rule")
        self._fired_c = reg.counter(
            "pt_serve_alerts_fired_total",
            "alert-rule firing transitions (hysteresis-gated: "
            "fire_for consecutive bad windows to fire, clear_for "
            "healthy ones to clear — no flapping)", L)
        self._active_g = reg.gauge(
            "pt_serve_alert_active",
            "1 while the alert rule is in its fired state", L)
        # host counters (available with telemetry off, like every
        # other serving stat surface)
        self.alert_stats = {"evaluated": 0, "fired": 0, "cleared": 0}
        # bounded transition log — a plain list (list() copies are
        # GIL-atomic for the scrape thread, the DegradationController
        # pattern), trimmed to the cap on append
        self.transitions: list = []
        self._max_transitions = 128

    # ---------------- evaluation (scheduler thread) ----------------
    def evaluate(self, store) -> List[dict]:
        """Run every rule over the store's trailing windows (only as
        many as the widest rule reads — not the whole retained ring);
        returns the transitions this window produced (usually [])."""
        samples = store.last(self._window_need)
        if not samples:
            return []
        self.alert_stats["evaluated"] += 1
        out: List[dict] = []
        for rule in self._rules:
            tr = rule.update(samples)
            if tr is None:
                continue
            lab = {"engine": self.label, "rule": rule.name}
            if tr == "fire":
                self.alert_stats["fired"] += 1
                self._fired_c.inc(**lab)
                self._active_g.set(1, **lab)
                self._artifact(rule, samples)
            else:
                self.alert_stats["cleared"] += 1
                self._active_g.set(0, **lab)
            if self._tracer is not None:
                # _force: an alert transition must never be dropped by
                # the tracer's deterministic sample thinning
                self._tracer.engine_event(
                    "alert" if tr == "fire" else "alert_clear",
                    _force=True, rule=rule.name,
                    detail=dict(rule.detail))
            ev = {"rule": rule.name, "event": tr,
                  "tick": samples[-1]["tick"],
                  "detail": dict(rule.detail)}
            self.transitions.append(ev)
            if len(self.transitions) > self._max_transitions:
                del self.transitions[
                    :len(self.transitions) - self._max_transitions]
            out.append(ev)
        return out

    def _artifact(self, rule: AlertRule, samples: List[dict]):
        """FlightRecorder postmortem for a firing: the rule, its
        detail, and the TRIGGERING WINDOW of series samples. Telemetry
        off = host counters only (the NaN-dump / watchdog gate)."""
        from .registry import enabled

        if not enabled():
            return
        if self._recorder is None:
            from .recorder import FlightRecorder

            self._recorder = FlightRecorder(
                capacity=int(flags.flag("telemetry_flight_window")),
                dump_dir=str(flags.flag("telemetry_dump_dir")))
        self._recorder.record(
            kind="alert", rule=rule.name, engine=self.label,
            detail=dict(rule.detail), window=samples[-8:])
        self._recorder.dump(
            f"serving alert {rule.name!r} fired (engine "
            f"{self.label}) — triggering series window attached")

    # ---------------- read side ----------------
    def is_active(self, name: str) -> bool:
        """Read-only signal hook (documented consumer: the degradation
        ladder under ``PT_FLAGS_slo_degradation``). Never mutates rule
        state — safe to poll every tick."""
        return any(r.active for r in self._rules if r.name == name)

    def snapshot(self) -> dict:
        """Copy-on-read view for the scrape thread: per-rule state,
        the active set, cumulative fire counts and the bounded
        transition log."""
        rules = {}
        for r in list(self._rules):
            rules[r.name] = {
                "active": r.active,
                "fired": r.fired,
                "value": r.value,
                "peak": r.peak,
                "detail": {k: v for k, v in list(r.detail.items())},
            }
        st = {k: v for k, v in list(self.alert_stats.items())}
        return {
            "label": self.label,
            "rules": rules,
            "active": sorted(n for n, d in rules.items()
                             if d["active"]),
            "fired_total": sum(d["fired"] for d in rules.values()),
            "stats": st,
            "transitions": list(self.transitions),
        }

    def window_reset(self):
        """Zero the per-rule peak trackers — one measurement window
        per bench sweep step (fire counts, hysteresis state and the
        registry totals keep running, the metrics_window_reset
        contract)."""
        for r in self._rules:
            r.peak = 0.0
