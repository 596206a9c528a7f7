"""HTTP front for the serving daemon (stdlib ``http.server``).

Counterpart of ``disentagled_multimodal_fusion_tpu/core/http_front.py``.
Every connection gets a handler thread; every request funnels into the
daemon's one dispatcher, so concurrent clients become batch size.

Protocol:

- ``POST /v1/infer`` body ``{"views": [[row...], ...per view]}`` (each view
  a (rows, dim) nested list; row counts agree across views), optionally
  ``"fields": ["pred", "probs", ...]``. Response
  ``{"rows": N, "outputs": {<field>: nested lists...}}``: the outputs sit
  in their own object, so no output key can collide with ``rows``.
- ``GET /v1/stats``: daemon counters, latency percentiles, bucket ladder.
- ``GET /healthz``: 200 while the dispatcher runs.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .daemon import QueueFullError

__all__ = ["start_http_server", "serve_forever"]

_MAX_BODY = 256 * 1024 * 1024  # refuse loudly rather than run out of memory
_RESULT_TIMEOUT_S = 600.0  # a wedged device becomes 504, not a leaked thread


class _Handler(BaseHTTPRequestHandler):
    # set by start_http_server on the class the server instantiates
    daemon = None
    quiet = True

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str) -> None:
        # An error path may leave the body unread; under keep-alive those
        # bytes would parse as the next request, so close the connection.
        self.close_connection = True
        self._json(code, {"error": msg})

    def do_GET(self):
        if self.path == "/healthz":
            alive = self.daemon is not None and self.daemon._thread.is_alive()
            self._json(200 if alive else 503, {"ok": alive})
        elif self.path == "/v1/stats":
            st = self.daemon.stats()
            buckets = getattr(self.daemon.engine, "buckets", None)
            if buckets is not None:
                st["buckets"] = list(buckets)
            self._json(200, st)
        else:
            self._error(404, f"unknown path {self.path!r}")

    def do_POST(self):
        if self.path != "/v1/infer":
            return self._error(404, f"unknown path {self.path!r}")
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return self._error(400, "missing request body")
            if length > _MAX_BODY:
                return self._error(413, f"body over {_MAX_BODY} bytes")
            req = json.loads(self.rfile.read(length))
            views = req["views"]
            if not isinstance(views, list) or not views:
                raise ValueError("'views' must be a non-empty list of per-view row lists")
            xs = tuple(np.asarray(v, dtype=np.float32) for v in views)
            for i, x in enumerate(xs):
                if x.ndim != 2:
                    raise ValueError(
                        f"view {i} must be a (rows, dim) nested list; got shape {x.shape}"
                    )
            fields = req.get("fields")
            if fields is not None and not isinstance(fields, list):
                raise ValueError("'fields' must be a list of output keys")
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            return self._error(400, f"bad request: {e}")

        # Client errors (the daemon's validation) are 400, backpressure 503;
        # only a failure while running the engine is 500.
        try:
            future = self.daemon.submit(xs)
        except QueueFullError as e:
            return self._error(503, f"overloaded: {e}")
        except ValueError as e:
            return self._error(400, f"bad request: {e}")
        except RuntimeError as e:  # "daemon is closed": shutting down
            return self._error(503, f"unavailable: {e}")
        try:
            out = future.result(timeout=_RESULT_TIMEOUT_S)
        except (FuturesTimeout, TimeoutError):
            future.cancel()  # a no-op once running; bounds queued waits
            return self._error(504, f"inference timed out after {_RESULT_TIMEOUT_S:.0f}s")
        except Exception as e:  # noqa: BLE001 - daemon/engine failure
            return self._error(500, f"inference failed: {e}")

        if fields is not None:
            missing = [f for f in fields if f not in out]
            if missing:
                return self._error(400, f"unknown fields {missing}; available: {sorted(out)}")
            out = {k: out[k] for k in fields}
        self._json(200, {
            "rows": int(xs[0].shape[0]),
            "outputs": {k: np.asarray(v).tolist() for k, v in out.items()},
        })


def start_http_server(daemon, host: str = "127.0.0.1", port: int = 0, quiet: bool = True):
    """Start the HTTP front on a background thread; returns (server, port).

    ``port=0`` binds an ephemeral port. Stop it with ``server.shutdown()``
    and ``server.server_close()``; the daemon is the caller's to close.
    """
    handler = type("Handler", (_Handler,), {"daemon": daemon, "quiet": quiet})
    server = ThreadingHTTPServer((host, port), handler)
    threading.Thread(target=server.serve_forever, name="serving-http", daemon=True).start()
    return server, int(server.server_address[1])


def serve_forever(daemon, host: str = "127.0.0.1", port: int = 8000, quiet: bool = False) -> None:
    """Blocking variant for the CLI: serve until KeyboardInterrupt."""
    server, bound = start_http_server(daemon, host, port, quiet=quiet)
    print(f"serving on http://{host}:{bound}  (POST /v1/infer, GET /v1/stats, /healthz)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
