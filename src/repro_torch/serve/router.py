"""Shape-affinity request routing across serving replicas.

A port of ``repro.serve.router``.  The coordinator publishes one small
plan per replica, each covering one affinity class of the fleet's hot set
(``Coordinator.publish_replica_plans``); this module sends each request
to the replica whose plan covers its shapes.

:class:`Router` holds :class:`Replica` handles (a name and live plan and
load probes) and answers ``route(shapes) -> Replica`` per pending request.
Three policies:

``ShapeAffinityRouter``
    Scores each replica by :func:`plan_coverage` (the fraction of the
    request's (space, inputs) shapes its installed plan resolves: the
    ``plan.lookup`` probe store-aware admission scores with) and takes the
    best-covering replica within a load bound: a replica more than
    ``max_imbalance`` requests above the least-loaded one is ineligible.
    A request no plan covers takes the escape: the least-loaded replica.
    Outcomes: ``affinity`` (the best-covering replica won), ``balanced``
    (the load bound excluded it and an eligible one was taken),
    ``escape`` (no coverage anywhere).
``RoundRobinRouter`` / ``RandomRouter`` (a seeded ``random.Random``)
    The baselines (outcome ``baseline``).

Wired through ``ServeConfig(router=...)``, ``launch.serve --router`` and
``tunedb fleet route``; decisions count in
``tunedb_router_decisions_total{policy,outcome}`` and show in the
``/status`` router section.  With tracing on each decision is a
``request.route`` span.  The router reads host state only.
"""

from __future__ import annotations

import contextlib
import random
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.tunedb.obs import trace as _trace
from repro_torch.tunedb.obs.metrics import get_registry
from repro_torch.tunedb.store import shape_key

_NULL_CTX = contextlib.nullcontext()

__all__ = [
    "ROUTER_POLICIES", "Replica", "Router", "RoundRobinRouter",
    "RandomRouter", "ShapeAffinityRouter", "make_router", "plan_coverage",
]

Shape = Tuple[str, Dict[str, int]]          # (space, inputs)


def plan_coverage(plan, shapes: Iterable[Shape]) -> float:
    """The fraction of ``(space, inputs)`` shapes ``plan`` resolves (0.0
    without a plan or shapes)."""
    shapes = list(shapes)
    if plan is None or not shapes:
        return 0.0
    hits = sum(1 for space, inputs in shapes
               if plan.lookup(space, shape_key(inputs)) is not None)
    return hits / len(shapes)


class Replica:
    """One routable replica: a name and live plan and load probes, each a
    value or a zero-argument callable (an engine passes ``lambda:
    serving_state().plan`` and its active-slot count)."""

    __slots__ = ("name", "_plan", "_load", "assigned")

    def __init__(self, name: str, *,
                 plan: Union[object, Callable[[], object], None] = None,
                 load: Union[float, Callable[[], float], None] = None):
        self.name = name
        self._plan = plan
        self._load = load
        self.assigned = 0               # requests the router sent here

    def current_plan(self):
        return self._plan() if callable(self._plan) else self._plan

    def current_load(self) -> float:
        if callable(self._load):
            return float(self._load())
        if self._load is not None:
            return float(self._load)
        return float(self.assigned)

    def stats(self) -> Dict[str, object]:
        plan = self.current_plan()
        return {"name": self.name, "assigned": self.assigned,
                "load": self.current_load(),
                "plan_entries": (len(plan) if plan is not None else 0)}


class Router:
    """The policy-agnostic part: replicas, accounting, metrics."""

    policy = "base"

    def __init__(self, replicas: Optional[Iterable[Replica]] = None):
        self._lock = threading.Lock()
        self.replicas: List[Replica] = list(replicas or [])
        self.decisions = 0
        self.outcomes: Dict[str, int] = {}

    def add_replica(self, name: str, *, plan=None, load=None) -> Replica:
        r = Replica(name, plan=plan, load=load)
        with self._lock:
            self.replicas.append(r)
        return r

    def route(self, shapes: Iterable[Shape] = ()) -> Replica:
        """Assign one pending request (its shapes) to a replica; a policy
        biases the choice, it never refuses a request."""
        tr = _trace._TRACER
        with (tr.span("request.route", policy=self.policy)
              if tr is not None else _NULL_CTX) as sp:
            with self._lock:
                if not self.replicas:
                    raise RuntimeError("router has no replicas to route to")
                replica, outcome = self._pick(list(shapes))
                replica.assigned += 1
                self.decisions += 1
                self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            if sp is not None:
                sp.attrs["outcome"] = outcome
                sp.attrs["replica"] = replica.name
        get_registry().counter(
            "tunedb_router_decisions_total",
            "request routing decisions by policy and outcome").inc(
                policy=self.policy, outcome=outcome)
        return replica

    def _pick(self, shapes: List[Shape]) -> Tuple[Replica, str]:
        raise NotImplementedError

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"policy": self.policy, "decisions": self.decisions,
                    "outcomes": dict(self.outcomes),
                    "replicas": [r.stats() for r in self.replicas]}


class RoundRobinRouter(Router):
    """Baseline: the replicas in turn, whatever the shapes or the load."""

    policy = "round_robin"

    def __init__(self, replicas: Optional[Iterable[Replica]] = None):
        super().__init__(replicas)
        self._next = 0

    def _pick(self, shapes: List[Shape]) -> Tuple[Replica, str]:
        r = self.replicas[self._next % len(self.replicas)]
        self._next += 1
        return r, "baseline"


class RandomRouter(Router):
    """Baseline: a uniform random replica (seeded, reproducible)."""

    policy = "random"

    def __init__(self, replicas: Optional[Iterable[Replica]] = None, *,
                 seed: int = 0):
        super().__init__(replicas)
        self._rng = random.Random(seed)

    def _pick(self, shapes: List[Shape]) -> Tuple[Replica, str]:
        return self._rng.choice(self.replicas), "baseline"


class ShapeAffinityRouter(Router):
    """Route to the replica whose plan covers the request's shapes, within
    the load bound ``max_imbalance``; coverage ties go to the less-loaded
    replica, then to the earlier one."""

    policy = "affinity"

    def __init__(self, replicas: Optional[Iterable[Replica]] = None, *,
                 max_imbalance: float = 4.0):
        super().__init__(replicas)
        self.max_imbalance = float(max_imbalance)

    def _pick(self, shapes: List[Shape]) -> Tuple[Replica, str]:
        loads = [r.current_load() for r in self.replicas]
        floor = min(loads)
        coverage = [plan_coverage(r.current_plan(), shapes)
                    for r in self.replicas]
        eligible = [i for i, load in enumerate(loads)
                    if load - floor <= self.max_imbalance]
        best = max(eligible, key=lambda i: (coverage[i], -loads[i], -i))
        if coverage[best] <= 0.0:
            # no plan covers it: served now by load alone, and its shapes
            # enter that replica's telemetry
            idx = min(range(len(self.replicas)), key=lambda i: loads[i])
            return self.replicas[idx], "escape"
        if max(coverage) > coverage[best]:
            return self.replicas[best], "balanced"
        return self.replicas[best], "affinity"


ROUTER_POLICIES: Dict[str, type] = {
    "affinity": ShapeAffinityRouter,
    "round_robin": RoundRobinRouter,
    "random": RandomRouter,
}


def make_router(policy: str, **kwargs) -> Router:
    """A router by policy name (``ServeConfig.router``, ``--router``,
    ``fleet route --policy``)."""
    try:
        cls = ROUTER_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown router policy {policy!r}; "
            f"choose from {sorted(ROUTER_POLICIES)}") from None
    return cls(**kwargs)
