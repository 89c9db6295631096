"""Generation-diff regression sentry: refuse to promote slower records.

A port of ``repro.tunedb.obs.sentry``.  A retune *replaces* the serving
record of a ``(backend, space, shape)`` slot with whatever newer
measurement arrives, and ``install_serving`` freezes the result into the
next dispatch plan; nothing else asks whether the replacement is faster.
:class:`RegressionSentry` asks at two promotion edges:

* ``tunedb diff <old> <new>``: record by record over two store files (or
  coverage over two plan snapshots); exits non-zero on a regression.
* ``install_serving(sentry=...)``: the swap gate.  A new store is diffed
  against the serving one; an in-place retune (the same store object)
  replays the store's supersession log since the serving plan's
  ``store_version``.  A regressed generation is warned about, counted
  (``tunedb_sentry_*``) and refused: the previous serving state stays and
  the caller sees its generation unchanged.

A record counts as a regression only when the newer one is slower than
the one it replaces by more than ``noise_margin`` (10% by default):
repeated measurements of one config jitter.  The third edge is the fleet
coordinator's merge gate (``Coordinator(sentry_margin=...)``): a worker's
shard record that would replace a faster serving record is refused
before it reaches the parent store (:meth:`RegressionSentry.regresses`).
A fourth is the plan follower's: a published plan whose coverage drops
planned shapes is refused (:meth:`RegressionSentry.diff_plans`).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

from ..store import SAMPLE_SOURCE, shape_key
from .metrics import get_registry

__all__ = [
    "DEFAULT_NOISE_MARGIN", "Regression", "SentryReport", "RegressionSentry",
    "last_report",
]

DEFAULT_NOISE_MARGIN = 0.10


@dataclasses.dataclass(frozen=True)
class Regression:
    """One slot whose replacement record is slower beyond the margin."""

    space: str
    backend: str
    inputs: Dict[str, int]
    old_tflops: float
    new_tflops: float
    old_config: Dict[str, int]
    new_config: Dict[str, int]

    @property
    def drop(self) -> float:
        """Fractional slowdown: 0.25 means the new record is 25% slower."""
        if self.old_tflops <= 0:
            return 0.0
        return 1.0 - self.new_tflops / self.old_tflops

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["drop"] = self.drop
        return d


@dataclasses.dataclass
class SentryReport:
    """Outcome of one sentry pass over a pair of generations."""

    checked: int = 0
    improved: int = 0
    unchanged: int = 0
    added: int = 0
    removed: int = 0
    noise_margin: float = DEFAULT_NOISE_MARGIN
    regressions: List[Regression] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.regressions

    def to_dict(self) -> Dict[str, object]:
        return {
            "checked": self.checked,
            "improved": self.improved,
            "unchanged": self.unchanged,
            "added": self.added,
            "removed": self.removed,
            "noise_margin": self.noise_margin,
            "ok": self.ok,
            "regressions": [r.to_dict() for r in self.regressions],
        }


_LAST_REPORT: Optional[SentryReport] = None


def last_report() -> Optional[SentryReport]:
    """The latest report an install gate produced: a refused
    ``install_serving`` returns the old state, so the reason is here."""
    return _LAST_REPORT


def _slot(rec) -> Tuple[str, str, tuple]:
    return (rec.backend, rec.space, shape_key(rec.inputs))


class RegressionSentry:
    """Compares record generations and gates promotions: a replacement
    regresses when ``new < old * (1 - noise_margin)``."""

    def __init__(self, noise_margin: float = DEFAULT_NOISE_MARGIN) -> None:
        if not 0.0 <= noise_margin < 1.0:
            raise ValueError(f"noise_margin must be in [0, 1), "
                             f"got {noise_margin}")
        self.noise_margin = float(noise_margin)

    def regresses(self, old_tflops: float, new_tflops: float) -> bool:
        return new_tflops < old_tflops * (1.0 - self.noise_margin)

    def check_record(self, old, new) -> Optional[Regression]:
        """``old`` and ``new`` are records of the same slot."""
        if not self.regresses(old.tflops, new.tflops):
            return None
        return Regression(
            space=new.space, backend=new.backend, inputs=dict(new.inputs),
            old_tflops=old.tflops, new_tflops=new.tflops,
            old_config=dict(old.config), new_config=dict(new.config))

    def diff_stores(self, old_store, new_store) -> SentryReport:
        """Record by record over the slots both stores serve.  A slot on
        one side only counts as added or removed, never as a regression:
        the sentry guards replacements, not coverage."""
        report = SentryReport(noise_margin=self.noise_margin)
        old_index = _serving_index(old_store)
        new_index = _serving_index(new_store)
        for key, new_rec in new_index.items():
            old_rec = old_index.get(key)
            if old_rec is None:
                report.added += 1
                continue
            report.checked += 1
            reg = self.check_record(old_rec, new_rec)
            if reg is not None:
                report.regressions.append(reg)
            elif new_rec.tflops > old_rec.tflops:
                report.improved += 1
            else:
                report.unchanged += 1
        report.removed = sum(1 for key in old_index if key not in new_index)
        return report

    def check_supersessions(self, store, since_version: int) -> SentryReport:
        """Replay the store's supersession log after ``since_version``:
        the replacements the next install of this store would freeze in.
        A later good replacement of a slot clears its earlier
        regression."""
        report = SentryReport(noise_margin=self.noise_margin)
        seen: Dict[Tuple, Regression] = {}
        for sup in list(getattr(store, "supersessions", ())):
            if sup.version <= since_version:
                continue
            report.checked += 1
            reg = self.check_record(sup.old, sup.new)
            key = _slot(sup.new)
            if reg is not None:
                seen[key] = reg
            else:
                seen.pop(key, None)
                if sup.new.tflops > sup.old.tflops:
                    report.improved += 1
                else:
                    report.unchanged += 1
        report.regressions = list(seen.values())
        return report

    def check_install(self, cur_state, new_store) -> Optional[SentryReport]:
        """The report for swapping ``new_store`` in over ``cur_state``,
        or ``None`` when there is nothing to compare against."""
        global _LAST_REPORT
        if new_store is None or cur_state.store is None:
            return None
        if new_store is cur_state.store:
            plan = cur_state.plan
            if plan is None:
                return None
            report = self.check_supersessions(
                new_store, since_version=plan.store_version)
        else:
            report = self.diff_stores(cur_state.store, new_store)
        _LAST_REPORT = report
        return report

    def blocks_install(self, cur_state, new_store) -> bool:
        """True when the swap must be refused; then it warns and counts
        ``tunedb_sentry_regressions_total`` / ``tunedb_sentry_blocked_total``
        (``where="install"``)."""
        report = self.check_install(cur_state, new_store)
        if report is None or report.ok:
            return False
        reg = get_registry()
        reg.counter("tunedb_sentry_regressions_total",
                    "records flagged as regressed by the sentry").inc(
                        len(report.regressions), where="install")
        reg.counter("tunedb_sentry_blocked_total",
                    "generation promotions refused by the sentry").inc(
                        where="install")
        worst = max(report.regressions, key=lambda r: r.drop)
        warnings.warn(
            f"regression sentry refused serving swap: "
            f"{len(report.regressions)} regressed record(s) beyond "
            f"{self.noise_margin:.0%} noise margin (worst: {worst.space} "
            f"{worst.inputs} {worst.old_tflops:.1f}->{worst.new_tflops:.1f} "
            f"TFLOP/s, -{worst.drop:.0%}); keeping previous generation",
            RuntimeWarning, stacklevel=3)
        return True

    def diff_plans(self, old_plan: Dict, new_plan: Dict) -> SentryReport:
        """Coverage diff of two plan snapshots (``{"fingerprint",
        "entries": [{"space", "inputs", "config", ...}]}``): entries carry
        no measured TFLOP/s, so a shape planned in ``old`` and gone from
        ``new`` (it falls to a slower tier) is the regression, with zero
        rates; a changed config counts as improved (unknowable offline)."""
        report = SentryReport(noise_margin=self.noise_margin)
        old_entries = {_plan_key(e): e for e in old_plan.get("entries", [])}
        new_entries = {_plan_key(e): e for e in new_plan.get("entries", [])}
        for key, entry in old_entries.items():
            new_entry = new_entries.get(key)
            if new_entry is None:
                report.removed += 1
                report.regressions.append(Regression(
                    space=entry.get("space", "?"),
                    backend=old_plan.get("fingerprint", "?"),
                    inputs=dict(entry.get("inputs", {})),
                    old_tflops=0.0, new_tflops=0.0,
                    old_config=dict(entry.get("config", {})),
                    new_config={}))
                continue
            report.checked += 1
            if new_entry.get("config") == entry.get("config"):
                report.unchanged += 1
            else:
                report.improved += 1
        report.added = sum(1 for k in new_entries if k not in old_entries)
        return report


def _serving_index(store) -> Dict[Tuple, object]:
    """``(backend, space, shape) -> latest served record`` of a store."""
    index: Dict[Tuple, object] = {}
    for rec in store.records():         # newest first: the first one wins
        if rec.source == SAMPLE_SOURCE:
            continue
        index.setdefault(_slot(rec), rec)
    return index


def _plan_key(entry: Dict) -> Tuple:
    return (entry.get("space"),
            tuple(sorted((entry.get("inputs") or {}).items())))
