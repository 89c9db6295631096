"""Deterministic fault injection for the tunedb filesystem-bus protocols.

The port's copy of ``repro.tunedb.chaos``: the same classes, the same
rule order and the same draws from one ``random.Random(seed)``, so one
plan over one sequence of operations injects the same faults in either
package (the port also takes them under a lock, since worker threads
share one shim).  The tuning database runs six protocols over plain
files (store JSONL append, fleet lease claim by rename, the
coordinator's shard merge, plan registry publish and follow, telemetry
dumps, trace dumps), and each has a story for crashes, torn writes and
transient I/O errors.  A seeded :class:`FaultPlan` arms one
process-global :class:`FaultyIO` shim, and every bus touch point routes
its filesystem operations through it, so a chaos harness can inject

* **torn writes**: part of the bytes land, then a simulated crash;
* **failed or duplicated renames**: the atomic step refused, or made and
  then reported failed (the caller retries and duplicates it);
* **ENOSPC / EIO** on a write or an fsync;
* **stale or truncated reads**: a reader sees a path's previous content,
  or a prefix of the current one;
* **stalls** on any operation;
* **kill-points**: :class:`KillPoint` aborting a protocol of several steps
  between two of them, where a SIGKILL would land.

Disarmed it costs one attribute read: the shim is a module-level nullable
(``chaos._IO``, the pattern of ``obs.trace._TRACER``); every call site
reads it once and, when it is ``None``, runs its plain code.

:class:`KillPoint` derives from ``BaseException`` on purpose: the
``except Exception`` job isolation and observability guards must not
absorb a simulated crash; it unwinds to the harness as a real kill takes
the process.

:func:`retry_io` is the shared retry policy for transient errors
(bounded exponential backoff with jitter, a metric per call site) of the
lease, registry and telemetry paths.
"""

from __future__ import annotations

import contextlib
import dataclasses
import errno as _errno_mod
import fnmatch
import os
import pathlib
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

__all__ = [
    "KillPoint", "FaultRule", "FaultPlan", "FaultyIO",
    "arm", "disarm", "active", "armed",
    "retry_io", "TRANSIENT_ERRNOS",
]


class KillPoint(BaseException):
    """A simulated hard crash injected inside or between protocol steps."""

    def __init__(self, site: str):
        super().__init__(f"simulated crash at {site}")
        self.site = site


# fault kinds each primitive consults (a rule whose kind does not apply to
# the operation simply never matches it)
_READ_KINDS = ("stale_read", "truncated_read", "errno", "stall", "kill")
_WRITE_KINDS = ("torn_write", "errno", "stall", "kill")
_RENAME_KINDS = ("rename_fail", "rename_dup", "errno", "stall", "kill")
_META_KINDS = ("errno", "stall", "kill")

KINDS = ("torn_write", "errno", "rename_fail", "rename_dup",
         "stale_read", "truncated_read", "stall", "kill")


@dataclasses.dataclass
class FaultRule:
    """One injectable fault: *which* sites, *what* fault, *how often*.

    ``site`` is an ``fnmatch`` pattern over call-site names (e.g.
    ``"lease.*"`` or ``"store.append"``); ``p`` is the per-matching-op
    injection probability; ``after`` skips the first N matching ops (let a
    protocol make progress before hurting it) and ``max_count`` bounds the
    total injections (0 = unlimited)."""

    site: str = "*"
    kind: str = "errno"
    p: float = 1.0
    errno: int = _errno_mod.EIO
    max_count: int = 0
    after: int = 0
    stall_s: float = 0.0
    # runtime counters — FaultyIO mutates these; reports read them
    seen: int = 0
    fired: int = 0


@dataclasses.dataclass
class FaultPlan:
    """A seeded schedule of :class:`FaultRule` entries."""

    seed: int = 0
    rules: List[FaultRule] = dataclasses.field(default_factory=list)


class FaultyIO:
    """The injectable I/O shim every filesystem-bus touch point routes
    through *when armed*.  Each primitive consults the plan's rules in
    order; the first applicable rule that fires decides the fault."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.calls = 0
        self.injected: Dict[Tuple[str, str], int] = {}
        self._read_cache: Dict[str, str] = {}
        # worker threads share one shim: the counters and the draws
        self._lock = threading.Lock()

    # -- rule selection -----------------------------------------------------
    def _pick(self, site: str, kinds: Tuple[str, ...]) -> Optional[FaultRule]:
        """Count one operation at ``site``; the rule that fires on it."""
        with self._lock:
            self.calls += 1
            return self._fire(site, kinds)

    def _fire(self, site: str, kinds: Tuple[str, ...]) -> Optional[FaultRule]:
        for rule in self.plan.rules:
            if rule.kind not in kinds:
                continue
            if not fnmatch.fnmatch(site, rule.site):
                continue
            rule.seen += 1
            if rule.seen <= rule.after:
                continue
            if rule.max_count and rule.fired >= rule.max_count:
                continue
            if self.rng.random() >= rule.p:
                continue
            rule.fired += 1
            key = (site, rule.kind)
            self.injected[key] = self.injected.get(key, 0) + 1
            return rule
        return None

    def _meta(self, rule: FaultRule, site: str) -> None:
        """Apply an errno/stall/kill rule (stall returns; the rest raise)."""
        if rule.kind == "stall":
            time.sleep(rule.stall_s)
            return
        if rule.kind == "kill":
            raise KillPoint(site)
        raise OSError(rule.errno, os.strerror(rule.errno), site)

    # -- primitives ---------------------------------------------------------
    def probe(self, site: str) -> None:
        """A kill-point / errno / stall checkpoint between protocol steps."""
        rule = self._pick(site, _META_KINDS)
        if rule is not None:
            self._meta(rule, site)

    def read_text(self, path, site: str, *, encoding: str = "utf-8") -> str:
        spath = os.fspath(path)
        rule = self._pick(site, _READ_KINDS)
        if rule is not None:
            if rule.kind == "stale_read":
                cached = self._read_cache.get(spath)
                if cached is not None:
                    return cached
            elif rule.kind == "truncated_read":
                text = pathlib.Path(path).read_text(encoding=encoding)
                cut = self.rng.randrange(len(text)) if text else 0
                return text[:cut]
            else:
                self._meta(rule, site)
        text = pathlib.Path(path).read_text(encoding=encoding)
        self._read_cache[spath] = text
        return text

    def read_bytes(self, path, site: str) -> bytes:
        rule = self._pick(site, _READ_KINDS)
        if rule is not None:
            if rule.kind == "truncated_read":
                blob = pathlib.Path(path).read_bytes()
                cut = self.rng.randrange(len(blob)) if blob else 0
                return blob[:cut]
            if rule.kind != "stale_read":    # no byte-level stale cache
                self._meta(rule, site)
        return pathlib.Path(path).read_bytes()

    def write_text(self, path, text: str, site: str, *,
                   encoding: str = "utf-8") -> None:
        rule = self._pick(site, _WRITE_KINDS)
        if rule is not None:
            if rule.kind == "torn_write":
                cut = self.rng.randrange(len(text)) if text else 0
                pathlib.Path(path).write_text(text[:cut], encoding=encoding)
                raise KillPoint(site)
            self._meta(rule, site)
        pathlib.Path(path).write_text(text, encoding=encoding)

    def write_bytes(self, path, blob: bytes, site: str) -> None:
        rule = self._pick(site, _WRITE_KINDS)
        if rule is not None:
            if rule.kind == "torn_write":
                cut = self.rng.randrange(len(blob)) if blob else 0
                pathlib.Path(path).write_bytes(blob[:cut])
                raise KillPoint(site)
            self._meta(rule, site)
        pathlib.Path(path).write_bytes(blob)

    def file_write(self, fh, data: str, site: str) -> None:
        """Write to an already-open handle (the store's append handle):
        a torn write lands a prefix, flushes it to the OS, then crashes."""
        rule = self._pick(site, _WRITE_KINDS)
        if rule is not None:
            if rule.kind == "torn_write":
                cut = self.rng.randrange(len(data)) if data else 0
                fh.write(data[:cut])
                fh.flush()
                raise KillPoint(site)
            self._meta(rule, site)
        fh.write(data)

    def replace(self, src, dst, site: str) -> None:
        self._rename(os.replace, src, dst, site)

    def rename(self, src, dst, site: str) -> None:
        self._rename(os.rename, src, dst, site)

    def _rename(self, op: Callable, src, dst, site: str) -> None:
        rule = self._pick(site, _RENAME_KINDS)
        if rule is not None:
            if rule.kind == "rename_fail":
                raise OSError(rule.errno, os.strerror(rule.errno),
                              os.fspath(src))
            if rule.kind == "rename_dup":
                # the rename HAPPENED but the caller sees failure — a retry
                # duplicates the effect, the race the protocols must absorb
                op(src, dst)
                raise OSError(rule.errno, os.strerror(rule.errno),
                              os.fspath(src))
            self._meta(rule, site)
        op(src, dst)

    def fsync(self, fd: Union[int, object], site: str) -> None:
        rule = self._pick(site, _META_KINDS)
        if rule is not None:
            self._meta(rule, site)
        os.fsync(fd if isinstance(fd, int) else fd.fileno())

    def utime(self, path, site: str) -> None:
        rule = self._pick(site, _META_KINDS)
        if rule is not None:
            self._meta(rule, site)
        os.utime(path)

    def unlink(self, path, site: str, *, missing_ok: bool = False) -> None:
        rule = self._pick(site, _META_KINDS)
        if rule is not None:
            self._meta(rule, site)
        pathlib.Path(path).unlink(missing_ok=missing_ok)

    # -- reporting ----------------------------------------------------------
    def report(self) -> Dict[str, object]:
        with self._lock:
            calls, injected = self.calls, dict(self.injected)
        by_kind: Dict[str, int] = {}
        for (_, kind), n in injected.items():
            by_kind[kind] = by_kind.get(kind, 0) + n
        return {
            "seed": self.plan.seed,
            "calls": calls,
            "injected_total": sum(injected.values()),
            "by_kind": by_kind,
            "by_site": {f"{site}|{kind}": n
                        for (site, kind), n in sorted(injected.items())},
        }


# ---------------------------------------------------------------------------
# the process-global shim (None = disarmed, the production state)
# ---------------------------------------------------------------------------

_IO: Optional[FaultyIO] = None


def arm(plan: FaultPlan) -> FaultyIO:
    """Install a :class:`FaultyIO` for ``plan`` as the process-global shim."""
    global _IO
    _IO = FaultyIO(plan)
    return _IO


def disarm() -> Optional[FaultyIO]:
    """Remove the shim; returns it so harnesses can read its report."""
    global _IO
    io, _IO = _IO, None
    return io


def active() -> Optional[FaultyIO]:
    return _IO


@contextlib.contextmanager
def armed(plan: FaultPlan):
    """``with chaos.armed(FaultPlan(...)) as io:`` — scoped arming."""
    io = arm(plan)
    try:
        yield io
    finally:
        disarm()


# ---------------------------------------------------------------------------
# shared transient-error retry policy
# ---------------------------------------------------------------------------

# errnos worth retrying: transient device/contention conditions.  ENOSPC is
# deliberately NOT here (retrying a full disk burns the budget for nothing)
# and FileNotFoundError never retries (a vanished path is a genuine race —
# somebody else won it).
TRANSIENT_ERRNOS = frozenset({
    _errno_mod.EIO, _errno_mod.EAGAIN, _errno_mod.EBUSY,
})


def _count_retry(site: str, err: Optional[int]) -> None:
    try:
        from .obs.metrics import get_registry
        get_registry().counter(
            "tunedb_io_retries_total",
            "transient I/O errors retried by retry_io, per call site",
        ).inc(site=site, errno=str(err))
    except Exception:
        pass            # observability never blocks the retry itself


def retry_io(fn: Callable, *, site: str, attempts: int = 3,
             base_delay_s: float = 0.005, max_delay_s: float = 0.25,
             transient: frozenset = TRANSIENT_ERRNOS):
    """Run ``fn()`` retrying *transient* OSErrors with bounded exponential
    backoff + jitter.  Non-transient errors (ENOSPC, ENOENT, ValueError,
    ...) propagate immediately; the final transient failure re-raises after
    the attempt budget.  Every retried error counts in
    ``tunedb_io_retries_total{site,errno}``."""
    last: Optional[OSError] = None
    for i in range(max(int(attempts), 1)):
        try:
            return fn()
        except FileNotFoundError:
            raise               # a lost race, not a flaky device
        except OSError as e:
            if e.errno not in transient:
                raise
            last = e
            _count_retry(site, e.errno)
            if i + 1 < max(int(attempts), 1):
                delay = min(base_delay_s * (2.0 ** i), max_delay_s)
                time.sleep(delay * (0.5 + 0.5 * random.random()))
    assert last is not None
    raise last
