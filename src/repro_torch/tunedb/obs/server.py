"""``serve-status``: a stdlib HTTP endpoint over the observability layer.

A port of ``repro.tunedb.obs.server``.  The routes, all read-only:

* ``/metrics`` — Prometheus text exposition (scrape target).
* ``/status``  — the JSON document from :func:`~.snapshot.status_snapshot`.
* ``/plan``    — the active dispatch plan's table
  (:func:`~.snapshot.plan_snapshot`), diffable with ``tunedb diff``.
* ``/trace``   — the tracer's retained spans as Chrome trace-event JSON
  (:func:`~.trace.chrome_trace`); 404 while tracing is off.
* ``/healthz`` — liveness and readiness: ``200 ok`` without a ``health``
  callable; with one (the engine passes its shedding state) ``503`` and
  the reason while the process is degraded.

The server is a ``ThreadingHTTPServer`` on a daemon thread: scrapes run on
their own threads and never block serving.  ``port=0`` binds an ephemeral
port (``.port`` after :meth:`StatusServer.start` says which).

A scrape reads host state only.  The serving thread may be capturing a
CUDA graph (the engine's captures run in the global capture mode) while
a scrape runs, and a device synchronise from another thread then fails
(ROADMAP C11), so no route copies a tensor from the card, synchronises or
takes ``core.backend.DEVICE_LOCK``.

Run standalone against a store file::

    python -m repro_torch.tunedb serve-status --store tunedb.jsonl --port 9177

or inside a serving process via ``ServeConfig(status_port=...)``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import get_registry
from .snapshot import plan_snapshot, status_snapshot

__all__ = ["StatusServer"]


class StatusServer:
    """Owns the HTTP server's lifetime and the snapshot context.

    ``controller`` / ``fleet`` / ``store`` / ``telemetry`` / ``models`` /
    ``follower`` / ``router`` / ``tracer`` are optional handles passed into
    every ``/status`` build; whatever is omitted falls back to the
    process's live serving state, so an engine passes its controller, its
    fleet directory, follower and router.
    """

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 controller=None, fleet: Optional[str] = None, store=None,
                 telemetry=None, models=None, follower=None, router=None,
                 tracer=None, health=None) -> None:
        self.host = host
        self.port = port
        self.controller = controller
        self.fleet = fleet
        self.follower = follower
        self.router = router
        self.store = store
        self.telemetry = telemetry
        self.models = models
        self.tracer = tracer
        # health() -> truthy (healthy) | falsy | (False, "reason"); exceptions
        # count as unhealthy — a probe must never report ok by accident
        self.health = health
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- the payloads (also called directly by tests) ----------------------
    def metrics_text(self) -> str:
        return get_registry().render_prometheus()

    def status_json(self) -> dict:
        return status_snapshot(store=self.store, telemetry=self.telemetry,
                               controller=self.controller, fleet=self.fleet,
                               models=self.models, follower=self.follower,
                               router=self.router, tracer=self.tracer)

    def plan_json(self) -> dict:
        return plan_snapshot()

    def health_check(self) -> tuple:
        """(ok, reason) from the ``health`` callable; no callable = ok."""
        if self.health is None:
            return True, "ok"
        try:
            out = self.health()
        except Exception as exc:    # noqa: BLE001 — a failed probe is unhealthy
            return False, f"health probe failed: {exc}"
        if isinstance(out, tuple):
            ok = bool(out[0])
            reason = str(out[1]) if len(out) > 1 else "degraded"
            return ok, reason
        return (True, "ok") if out else (False, "degraded")

    def trace_json(self) -> Optional[dict]:
        """Retained spans as a Chrome trace-event document, or None while
        tracing is disabled (the route turns that into a 404)."""
        from .trace import chrome_trace, get_tracer
        tracer = self.tracer if self.tracer is not None else get_tracer()
        if tracer is None:
            return None
        return chrome_trace(tracer.spans())

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StatusServer":
        if self._httpd is not None:
            return self
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:       # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                try:
                    if path == "/metrics":
                        body = server.metrics_text().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path in ("/status", "/"):
                        body = (json.dumps(server.status_json(), indent=1,
                                           sort_keys=True, default=str)
                                + "\n").encode()
                        ctype = "application/json"
                    elif path == "/plan":
                        body = (json.dumps(server.plan_json(), indent=1,
                                           sort_keys=True, default=str)
                                + "\n").encode()
                        ctype = "application/json"
                    elif path == "/trace":
                        doc = server.trace_json()
                        if doc is None:
                            self.send_error(404, "tracing disabled")
                            return
                        body = (json.dumps(doc) + "\n").encode()
                        ctype = "application/json"
                    elif path == "/healthz":
                        ok, reason = server.health_check()
                        if not ok:
                            self.send_error(503, reason)
                            return
                        body, ctype = b"ok\n", "text/plain"
                    else:
                        self.send_error(404, "unknown route")
                        return
                except Exception as exc:    # noqa: BLE001 — a 500, not a dead thread
                    self.send_error(500, f"snapshot failed: {exc}")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:   # quiet by default
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tunedb-status",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
