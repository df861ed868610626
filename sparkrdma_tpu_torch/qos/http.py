"""Live metrics scrape endpoint (conf ``metricsHttpPort``).

The observability plane dumped the registry ONCE, at manager stop
(``metricsPromPath``/``metricsJsonPath``) — useless for watching a
live node's tenants contend.  This module serves the same exporters
over HTTP for the node's lifetime:

- ``GET /metrics``       — Prometheus text exposition (the scrape
  target; ``metrics/export.to_prometheus``), per-tenant labels on the
  brokered instruments included,
- ``GET /metrics.json``  — the registry snapshot as JSON (what
  ``tools/metrics_report.py`` renders),
- ``GET /tenants``       — the QoS tenant registry snapshot (weights,
  priorities, quotas, degraded flags),
- ``GET /health``        — liveness probe: 200 with uptime/pid JSON,
- ``GET /flightrecorder`` — on-demand flight-recorder snapshot
  (obs/recorder.py), the same JSON shape the automatic failure dumps
  write.

One daemon thread (``metrics-http-<port>``) runs a plain
``http.server`` loop — scrapes serialize, which is exactly right for
an exposition endpoint; the server binds in the constructor (port 0 =
ephemeral, for tests and one-off runs) and ``stop()`` shuts it down
synchronously so ``transport_census`` sees no leaked thread after
manager teardown.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional, Tuple

from sparkrdma_tpu_torch.metrics import get_registry
from sparkrdma_tpu_torch.metrics.export import to_prometheus
from sparkrdma_tpu_torch.obs import RECORDER
from sparkrdma_tpu_torch.qos.registry import get_qos

logger = logging.getLogger(__name__)


class _ScrapeHandler(BaseHTTPRequestHandler):
    # close per request: a scraper holding keep-alive open would pin
    # the single serving thread and starve the next scrape
    protocol_version = "HTTP/1.0"

    def do_GET(self) -> None:  # noqa: N802 - http.server contract
        path = self.path.split("?", 1)[0]
        try:
            if path in ("/metrics", "/"):
                body = to_prometheus(get_registry()).encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(
                    get_registry().snapshot(), indent=1
                ).encode("utf-8")
                ctype = "application/json"
            elif path == "/tenants":
                body = json.dumps(
                    get_qos().snapshot(), indent=1
                ).encode("utf-8")
                ctype = "application/json"
            elif path == "/health":
                started = getattr(self.server, "started_at", None)
                body = json.dumps({
                    "status": "ok",
                    "pid": os.getpid(),
                    "uptime_s": round(
                        time.time() - started, 3
                    ) if started is not None else None,
                }).encode("utf-8")
                ctype = "application/json"
            elif path == "/flightrecorder":
                snap = RECORDER.snapshot() if RECORDER.enabled else {
                    "enabled": False, "planes": {},
                }
                body = json.dumps(snap).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404, "unknown path")
                return
        except BaseException:
            logger.exception("metrics scrape failed")
            self.send_error(500, "scrape failed")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args) -> None:
        logger.debug("metrics-http: " + fmt, *args)


class MetricsHttpServer:
    """Always-on scrape endpoint over the process-global registries.
    Binds in the constructor (raises ``OSError`` on a taken port so
    the caller can log-and-continue); ``stop()`` is synchronous and
    idempotent."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._server = HTTPServer((host, port), _ScrapeHandler)
        self._server.started_at = time.time()  # /health uptime anchor
        self.address: Tuple[str, int] = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.2},
            daemon=True,
            name=f"metrics-http-{self.address[1]}",
        )
        self._thread.start()
        logger.info(
            "metrics scrape endpoint on http://%s:%d/metrics",
            self.address[0], self.address[1],
        )

    @property
    def port(self) -> int:
        return self.address[1]

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.address[0]}:{self.address[1]}{path}"

    def stop(self) -> None:
        t, self._thread = self._thread, None
        if t is None:
            return
        self._server.shutdown()
        t.join(timeout=5.0)
        self._server.server_close()


__all__ = ["MetricsHttpServer"]
