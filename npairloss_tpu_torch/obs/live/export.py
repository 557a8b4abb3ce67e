"""Surfaces: Prometheus text exposition + the localhost HTTP exporter.
Port of ``npairloss_tpu/obs/live/export.py`` (a copy: the same text,
byte for byte, for the same registry).

``prometheus_text`` renders a registry snapshot in the Prometheus
text-based exposition format (version 0.0.4 — the format every scraper
accepts): counters as ``<name>_total``, gauges plain, histograms as
cumulative ``_bucket{le=...}`` series with ``_sum``/``_count``.  The
serve front end mounts it at ``GET /metrics`` on its EXISTING HTTP
server (serve/server.py); the train side gets its own opt-in localhost
port via :func:`start_http_exporter` (CLI ``--metrics-port``) because
training has no HTTP surface otherwise.

Stdlib only, like the whole package.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from typing import Any, Callable, Dict, Optional

log = logging.getLogger("npairloss_tpu_torch.obs.live")

PROM_PREFIX = "npairloss_"


def _prom_name(name: str) -> str:
    out = "".join(ch if ch.isalnum() or ch == "_" else "_"
                  for ch in name)
    if out and out[0].isdigit():
        out = "_" + out
    return PROM_PREFIX + out


def _fmt(v: float) -> str:
    """Prometheus sample values: shortest exact-ish float repr; +Inf
    spelled the Prometheus way."""
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def prometheus_text(registry) -> str:
    """Render every metric in the exposition format, sorted by name so
    scrapes (and tests) are deterministic.

    Labeled registry keys (``serve_rows{tenant="a"}`` — see
    ``registry.labeled_name``) render as real Prometheus labels, with
    the family's ``# TYPE`` header emitted once across all label sets.
    A registry with no labeled series renders byte-identically to the
    pre-label format."""
    from npairloss_tpu_torch.obs.live.registry import split_labels

    lines = []
    snap = registry.snapshot()
    entries = sorted(
        (split_labels(key) + (key,)) for key in snap)
    typed = set()
    for base, labels, key in entries:
        m = snap[key]
        pname = _prom_name(base)
        kind = m["kind"]
        lab = "{" + labels + "}" if labels else ""
        if kind == "counter":
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname}_total counter")
            lines.append(f"{pname}_total{lab} {_fmt(m['value'])}")
        elif kind == "gauge":
            if m["value"] is None:
                continue  # a gauge never set exposes nothing
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname}{lab} {_fmt(m['value'])}")
        else:
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} histogram")
            # ``le`` composes with (goes after) the series labels.
            pre = labels + "," if labels else ""
            cum = m["cumulative_counts"]
            for bound, count in zip(m["bounds"], cum):
                lines.append(
                    f'{pname}_bucket{{{pre}le="{_fmt(bound)}"}} {count}')
            lines.append(f'{pname}_bucket{{{pre}le="+Inf"}} {cum[-1]}')
            lines.append(f"{pname}_sum{lab} {_fmt(m['sum'])}")
            lines.append(f"{pname}_count{lab} {m['count']}")
    return "\n".join(lines) + "\n"


def start_http_exporter(
    registry,
    port: int,
    host: str = "127.0.0.1",
    health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
):
    """Serve ``GET /metrics`` (+ ``/healthz`` when ``health_fn`` is
    given) on a localhost port from a daemon thread — the train-side
    surface (CLI ``--metrics-port``).  Returns the ``HTTPServer``;
    call ``.shutdown()`` then ``.server_close()`` to stop.  Localhost
    by default on purpose: this exposes run internals, a reverse proxy
    decides what leaves the box."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            log.debug("exporter: " + fmt, *args)

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                self._send(200, prometheus_text(registry).encode(),
                           "text/plain; version=0.0.4")
            elif self.path == "/healthz" and health_fn is not None:
                try:
                    payload = health_fn()
                except Exception as e:  # noqa: BLE001 — health must answer
                    payload = {"ok": False, "error": str(e)}
                self._send(200, (json.dumps(payload) + "\n").encode(),
                           "application/json")
            else:
                self._send(404, b'{"error": "unknown path"}\n',
                           "application/json")

    httpd = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(
        target=httpd.serve_forever, name="live-obs-exporter", daemon=True)
    thread.start()
    log.info("live-obs exporter on http://%s:%d/metrics",
             host, httpd.server_address[1])
    return httpd
