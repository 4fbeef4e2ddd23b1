"""Background HTTP serving on the standard library.

Counterpart of ``veles_tpu/http_util.py``.  The JAX package runs a
tornado application on a loop thread; the port runs
``http.server.ThreadingHTTPServer`` on a background thread, one thread a
connection, so a handler may block on a batcher without holding up the
other requests.  :class:`BackgroundHTTPServer` binds in ``start()``
(raising a bind error, e.g. EADDRINUSE, in the caller's thread) and
``stop()`` shuts the server down and joins its thread.

An application is a callable ``app(method, path, headers, body) ->
(status, headers, payload)``; ``path`` leaves the query string out
unless the server is made with ``with_query=True``.  A request whose
``Content-Length`` passes the server's ``max_body`` (tornado's
``max_buffer_size``) is refused with ``400`` before its body is read,
as tornado refuses it.  A payload that is not bytes is sent as
JSON the way tornado's ``RequestHandler.write(dict)`` sends it (same
text, ``application/json; charset=UTF-8``).  Each request's wall time
(``time.perf_counter``) lands in the ``http.request_s`` histogram, as
the JAX package's ``RequestTimer`` puts it, and while the tracer
records, an ``http.request`` span tagged with method, path and status.
"""

import http.server
import json
import threading
import time

from veles_tpu_torch.observe.metrics import registry as _registry
from veles_tpu_torch.observe.trace import tracer as _tracer

__all__ = ["BackgroundHTTPServer", "json_body"]


def json_body(obj):
    """``obj`` as tornado writes a dict: ``json.dumps`` with ``</``
    escaped."""
    return json.dumps(obj).replace("</", "<\\/").encode("utf-8")


class _Handler(http.server.BaseHTTPRequestHandler):
    #: set per server class (see BackgroundHTTPServer.start)
    app = None
    max_body = None
    with_query = False

    def _serve(self, method):
        started = time.perf_counter()
        status = 500
        try:
            length = int(self.headers.get("Content-Length") or 0)
            if self.max_body is not None and length > self.max_body:
                status = 400
                self.close_connection = True
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            body = self.rfile.read(length) if length else b""
            status, headers, payload = self.app(
                method, self.path if self.with_query
                else self.path.split("?", 1)[0], self.headers, body)
            if not isinstance(payload, bytes):
                payload = json_body(payload)
                headers = dict(headers or {})
                headers.setdefault("Content-Type",
                                   "application/json; charset=UTF-8")
            self.send_response(status)
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
        finally:
            elapsed = time.perf_counter() - started
            _registry.histogram("http.request_s").observe(elapsed)
            if _tracer.active:
                _tracer.complete(
                    "http.request", started, elapsed, cat="http",
                    args={"method": method,
                          "path": self.path.split("?", 1)[0],
                          "status": status})

    def do_GET(self):
        self._serve("GET")

    def do_POST(self):
        self._serve("POST")

    def log_message(self, fmt, *args):
        pass  # the service logs what matters; no line a request


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    # stop() does not wait for handlers blocked on a batcher: they end
    # when the service stops its batcher, which fails what is pending
    block_on_close = False
    # a restarted service rebinds its port at once
    allow_reuse_address = True


class BackgroundHTTPServer(object):
    """Serves ``app`` on a background thread."""

    def __init__(self, app, port=0, address="127.0.0.1", max_body=None,
                 with_query=False):
        self.app = app
        self.port = port
        self.address = address
        self.max_body = max_body
        self.with_query = with_query
        self._server = None
        self._thread = None

    def start(self):
        handler = type("Handler", (_Handler,),
                       {"app": staticmethod(self.app),
                        "max_body": self.max_body,
                        "with_query": self.with_query})
        self._server = _Server((self.address, self.port), handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval":
                                                       0.1},
            name="http-server")
        self._thread.start()
        return self._thread

    def stop(self):
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
