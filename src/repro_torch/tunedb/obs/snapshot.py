"""One serializer for every status surface.

A port of ``repro.tunedb.obs.snapshot``.  ``/status`` (HTTP),
``tunedb stats --json`` and ``tunedb fleet status --json`` all call
:func:`status_snapshot`, so the schema lives in one place.  Every section
is present in every snapshot; a subsystem that is not running serializes
to ``None``.

Schema (version 1)::

    {
      "schema": 1,
      "serving":  {generation, fingerprint, store, models, plan},
      "tiers":    {counts per tier, "rates" per tier, "total"},
      "telemetry": ShapeTelemetry.stats() | null,
      "retune":   RetuneController.stats() (incl. "history") | null,
      "fleet":    {FleetDir.status(), "telemetry_replicas", "report"}
                  | null,
      "follower": PlanFollower.stats() | null,
      "router":   Router.stats() | null,
      "trace":    Tracer.stats() | null,
      "metrics":  MetricsRegistry.snapshot(),
    }

The follower, when none is passed, is the process's first live one
(``tunedb.plans.active_followers``).

Every read is of host state: a snapshot (built on the status server's
thread while the serving thread may be capturing a CUDA graph) makes no
device call, no copy from the card and no synchronise, and takes no
``core.backend.DEVICE_LOCK``.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

__all__ = ["SCHEMA_VERSION", "status_snapshot", "plan_snapshot"]

SCHEMA_VERSION = 1

PLAN_SNAPSHOT_CAP = 2000    # /plan entry cap: a plan can hold thousands


def status_snapshot(*, store=None, telemetry=None, controller=None,
                    fleet: Optional[str] = None, models=None, registry=None,
                    follower=None, router=None,
                    tracer=None) -> Dict[str, object]:
    """Build the shared status document.

    With no arguments, reads the process's live serving state (what the
    HTTP endpoint inside an engine does); an explicit ``store``,
    ``telemetry`` or ``fleet`` overrides it for the offline CLIs that
    inspect files or a fleet bus.
    """
    from ..store import serving_state
    from ..telemetry import get_telemetry
    from .metrics import get_registry
    from .trace import get_tracer

    state = serving_state()
    if store is None:
        store = state.store
    if models is None:
        models = state.models
    if telemetry is None:
        telemetry = get_telemetry()
    if registry is None:
        registry = get_registry()
    if tracer is None:
        tracer = get_tracer()
    if follower is None:
        from ..plans import active_followers
        live = active_followers()
        follower = live[0] if live else None
    plan = state.plan

    store_stats = store.stats() if store is not None else None
    model_stats = models.stats() if models is not None else None
    plan_stats = None
    if plan is not None:
        plan_stats = dict(plan.stats())
        plan_stats["fingerprint"] = plan.fingerprint
        plan_stats["store_version"] = plan.store_version

    # fold the dispatchers' pending ring entries first, so the snapshot
    # counts every call recorded so far
    telemetry.drain_pending()

    return {
        "schema": SCHEMA_VERSION,
        "serving": {
            "generation": state.generation,
            "fingerprint": state.fingerprint,
            "store": store_stats,
            "models": model_stats,
            "plan": plan_stats,
        },
        "tiers": _tier_rates(store, models, plan),
        "telemetry": telemetry.stats(),
        "retune": controller.stats() if controller is not None else None,
        "fleet": _fleet_section(fleet) if fleet else None,
        "follower": follower.stats() if follower is not None else None,
        "router": router.stats() if router is not None else None,
        "trace": tracer.stats() if tracer is not None else None,
        "metrics": registry.snapshot(),
    }


def _tier_rates(store, models, plan) -> Dict[str, object]:
    """Per-tier resolution counts and hit-rate fractions.

    The counts are the counters each tier keeps (a plan hit credits its
    entry's originating tier on the store's and the model set's counters
    too), so they are the per-tier totals; the plan's own hits are
    reported apart.
    """
    counts = {
        "exact": getattr(store, "hits", 0) if store is not None else 0,
        "nearest": getattr(store, "nearest_hits", 0)
        if store is not None else 0,
        "model": getattr(models, "hits", 0) if models is not None else 0,
        "model_gated": getattr(models, "gated", 0)
        if models is not None else 0,
        "miss": getattr(store, "misses", 0) if store is not None else 0,
    }
    total = counts["exact"] + counts["nearest"] + counts["model"] \
        + counts["miss"]
    rates = {tier: (counts[tier] / total if total else 0.0)
             for tier in ("exact", "nearest", "model", "miss")}
    out: Dict[str, object] = {"counts": counts, "rates": rates,
                              "total": total}
    if plan is not None:
        out["plan"] = {"hits": plan.hits, "misses": plan.misses}
    return out


def _fleet_section(fleet: str) -> Optional[Dict[str, object]]:
    """The fleet bus's status, its telemetry replicas and its last
    report; None when the directory does not exist."""
    from ..fleet.lease import REPORT, FleetDir

    root = pathlib.Path(fleet)
    if not root.exists():
        return None
    fd = FleetDir(root)
    try:
        section: Dict[str, object] = dict(fd.status())
    except FileNotFoundError:
        # a telemetry-only bus: exporters may dump before any coordinator
        # writes the manifest
        section = {"root": str(root), "store": None, "counts": None,
                   "draining": False, "lease_age_s": {},
                   "shard_records": {}}
    tel_dir = fd.telemetry_dir()
    if tel_dir.is_dir():
        from ..telemetry import FleetTelemetryView, ShapeTelemetry
        section["telemetry_replicas"] = FleetTelemetryView(
            tel_dir, local=ShapeTelemetry(), refresh_s=0.0).replicas()
    report = None
    if (root / REPORT).exists():
        try:
            report = json.loads((root / REPORT).read_text())
        except (OSError, ValueError):
            report = None
    section["report"] = report
    return section


def plan_snapshot(plan=None, *, cap: int = PLAN_SNAPSHOT_CAP
                  ) -> Dict[str, object]:
    """The active :class:`~repro_torch.tunedb.store.DispatchPlan` as a JSON
    table (``/plan``): each entry's shape, config, resolving tier and
    whether it was compiled in (``built``) or promoted while serving
    (``promoted``), at most ``cap`` of them.  ``tunedb diff`` compares two
    such snapshots."""
    from ..store import serving_state

    if plan is None:
        plan = serving_state().plan
    if plan is None:
        return {"generation": None, "fingerprint": None,
                "store_version": None, "source": None, "digest": None,
                "entries": [], "truncated": False}

    entries: List[Dict[str, object]] = []
    truncated = False
    for origin, table in (("built", plan._table),
                          ("promoted", plan._overlay)):
        for (space, key), (config, tier) in list(table.items()):
            if len(entries) >= cap:
                truncated = True
                break
            entries.append({
                "space": space,
                "inputs": {k: v for k, v in key},
                "config": dict(config),
                "tier": tier,
                "origin": origin,
            })
    return {
        "generation": plan.generation,
        "fingerprint": plan.fingerprint,
        "store_version": plan.store_version,
        "source": plan.source,
        "digest": plan.digest,
        "entries": entries,
        "truncated": truncated,
    }
