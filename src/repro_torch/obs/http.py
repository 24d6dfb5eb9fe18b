"""Live exposition endpoint (port of repro.obs.http): the obs layer over
plain HTTP.

One stdlib `http.server` on a daemon thread serving:

    /metrics   MetricsRegistry.to_prometheus()  (text/plain; scrapable)
    /healthz   the bound health callable's JSON (MicroNN.stats());
               200 always -- the endpoint fails only if the process is
               gone
    /traces    the TraceRing's QueryTraces as JSON
    /slow      the slow-query log as JSON
    /events    the maintenance MaintEvents as JSON

Non-perturbation contract: every data source is lock-free or takes only
its own short internal lock -- registry metric locks, the TraceRing deque
lock -- never the engine write mutex, so a scrape cannot stall queries,
writers or the maintenance daemon, and answers taken during a scrape equal
those taken without one.

The server binds 127.0.0.1 by default and port=0 picks an ephemeral port
(`server.port` after start()).

    srv = ExpositionServer.for_target(engine).start()
    urllib.request.urlopen(srv.url + "/healthz")
    srv.stop()
"""
from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import metrics as obs_metrics
from . import trace as obs_trace

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _jsonable(obj):
    """Best-effort JSON coercion for trace/event payloads (numpy
    scalars, dataclasses, tuples-as-keys never reach here; anything
    exotic degrades to repr instead of 500ing the scrape)."""
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        if dataclasses.is_dataclass(obj):
            return _jsonable(dataclasses.asdict(obj))
        if isinstance(obj, dict):
            return {str(k): _jsonable(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_jsonable(v) for v in obj]
        if hasattr(obj, "item"):        # numpy scalar
            return obj.item()
        return repr(obj)


class ExpositionServer:
    """Daemon-thread HTTP server over a registry + health fn + ring."""

    def __init__(self, *, registry: Optional[
            obs_metrics.MetricsRegistry] = None,
            health: Optional[Callable[[], dict]] = None,
            ring: Optional[obs_trace.TraceRing] = None,
            host: str = "127.0.0.1", port: int = 0):
        self.registry = registry or obs_metrics.default_registry()
        self.health = health
        self.ring = ring
        self.host = host
        self._port_req = int(port)
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def for_target(cls, target, **kwargs) -> "ExpositionServer":
        """Wire the endpoint to a target by duck-typing: its `health()`
        when it has one, else its `stats()` (a MicroNN); its `traces`
        ring when present."""
        health = getattr(target, "health", None) or \
            getattr(target, "stats", None)
        ring = getattr(target, "traces", None)
        if not isinstance(ring, obs_trace.TraceRing):
            ring = None
        return cls(health=health, ring=ring, **kwargs)

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        assert self._server is not None, "start() first"
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ExpositionServer":
        if self._server is not None:
            return self
        srv = self  # captured by the handler closure below

        class Handler(BaseHTTPRequestHandler):
            # observability must not spam stderr per scrape
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0].rstrip("/") or "/"
                    if path == "/metrics":
                        body = srv.registry.to_prometheus().encode()
                        ctype = PROM_CONTENT_TYPE
                    elif path in ("/healthz", "/"):
                        doc = srv.health() if srv.health is not None \
                            else {"status": "ok"}
                        body = json.dumps(_jsonable(doc)).encode()
                        ctype = "application/json"
                    elif path in ("/traces", "/slow", "/events"):
                        ring = srv.ring
                        if ring is None:
                            items = []
                        elif path == "/traces":
                            items = [t.to_dict() for t in ring.traces()]
                        elif path == "/slow":
                            items = [t.to_dict() for t in ring.slow()]
                        else:
                            items = [e.to_dict() for e in ring.events()]
                        body = json.dumps(_jsonable(items)).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:   # a scrape must never kill us
                    self.send_error(500, type(e).__name__)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self._port_req),
                                           Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="micronn-exposition", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
        self._server = None
        self._thread = None

    def __enter__(self) -> "ExpositionServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False
