"""Live telemetry endpoint: a stdlib ``http.server`` thread exposing the
metrics, the tracer's spans, and a health summary.

The port of ``quiver_tpu/obs/endpoint.py``. Three routes, all read-only
snapshots of host-side state:

* ``/metrics``: Prometheus exposition text
  (:func:`~.export.to_prometheus` over the attached registry's
  snapshots);
* ``/traces``: the tracer's retained spans as Chrome trace-event JSON
  (save the body to a file, open it in Perfetto);
* ``/healthz``: JSON summary from the owner's ``health`` callable
  (breaker states, queue depth) merged over ``{"status": "ok"}``.

Nothing here runs unless the caller starts it. The server thread is a
daemon bound to ``127.0.0.1`` on an ephemeral port by default:
observability never holds a process alive or accepts off-host traffic by
accident. The handlers read the same locked snapshots tests read.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .export import to_prometheus
from .registry import MetricsRegistry
from .tracing import to_chrome_trace

__all__ = ["TelemetryEndpoint"]


class TelemetryEndpoint:
    """Background HTTP server over a (metrics, tracer, health) triple.

    Args:
      metrics: optional :class:`MetricsRegistry` backing ``/metrics``
        (absent → empty exposition body).
      tracer: optional :class:`~.tracing.Tracer` backing
        ``/traces`` (absent → empty ``traceEvents``).
      health: optional zero-arg callable returning a JSON-able dict
        merged into the ``/healthz`` body.
      host / port: bind address; ``port=0`` (default) picks an ephemeral
        port, read it back from :attr:`port` / :attr:`url` after
        :meth:`start`.

    Usable as a context manager (``with TelemetryEndpoint(...) as ep:``)
    — stops the server thread on exit.
    """

    def __init__(self, metrics: MetricsRegistry | None = None, tracer=None,
                 health=None, host: str = "127.0.0.1", port: int = 0):
        self.metrics = metrics
        self.tracer = tracer
        self.health = health
        self._host = host
        self._port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "TelemetryEndpoint":
        """Bind and serve on a daemon thread; idempotent."""
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self._host, self._port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="quiver-telemetry",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down and join its thread; idempotent."""
        httpd, thread = self._httpd, self._thread
        self._httpd = None
        self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "TelemetryEndpoint":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int:
        """The bound port (the ephemeral one when constructed with 0)."""
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    # -- route bodies --------------------------------------------------------

    def metrics_text(self) -> str:
        if self.metrics is None:
            return ""
        return to_prometheus(self.metrics.snapshots())

    def traces_json(self) -> dict:
        spans = self.tracer.spans() if self.tracer is not None else []
        return to_chrome_trace(spans)

    def healthz_json(self) -> dict:
        body = {"status": "ok"}
        if self.health is not None:
            body.update(self.health())
        return body


def _make_handler(endpoint: TelemetryEndpoint):
    """Handler class closed over ``endpoint`` — BaseHTTPRequestHandler's
    API forces per-class (not per-instance) configuration."""

    class _Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):  # noqa: N802 (http.server API name)
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    body = endpoint.metrics_text().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/traces":
                    body = json.dumps(endpoint.traces_json()).encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    body = json.dumps(endpoint.healthz_json()).encode("utf-8")
                    ctype = "application/json"
                else:
                    self._reply(404, "application/json",
                                b'{"error": "not found"}')
                    return
            except Exception as e:  # surface, don't kill the thread
                msg = json.dumps({"error": f"{type(e).__name__}: {e}"})
                self._reply(500, "application/json", msg.encode("utf-8"))
                return
            self._reply(200, ctype, body)

        def _reply(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet: telemetry, not access logs
            pass

    return _Handler
