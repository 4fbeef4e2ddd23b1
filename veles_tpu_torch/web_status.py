"""The web-status service: collects a run's status posts and events,
serves a dashboard.

Counterpart of ``veles_tpu/web_status.py``, with its routes, JSON bodies
and sqlite tables.  A master or standalone run started with
``--web-status URL`` posts its status there periodically
(:class:`StatusReporter`, driven by the launcher) and forwards its
``Logger.event`` records; the dashboard lists every known session, each
with a history page.  Persistence is sqlite (tables ``status`` and
``events``, columns ``sid``, ``ts``, ``body``).  The HTTP surface:

- ``POST /update`` (a status snapshot) and ``POST /event`` (``{"id",
  "event"}``), each answered ``{"result": "ok"}``;
- ``GET /status.json`` (the latest post of each session),
  ``/session/<id>.json`` (its history), ``/events/<id>.json`` (its
  events as ``[time, text]`` pairs);
- ``GET /`` (the dashboard, its table refreshed from ``/table``),
  ``/session/<id>`` (a session's page, with a sparkline of its first
  metric) and ``/static/live.js`` (the page's live chart, the port's
  copy in ``veles_tpu_torch/web/``).

The JAX package serves it with tornado; the port serves it on the
standard library's ``http.server`` through
:class:`~veles_tpu_torch.http_util.BackgroundHTTPServer` (the card's
machine has no tornado), with the same paths, status codes and bodies.

The reporter's snapshot carries ``id``, ``workflow``, ``mode``,
``epoch``, ``metrics``, ``slaves`` and the process's blocks: ``health``
(``observe.metrics.health_snapshot``), ``serve`` (the serve tier),
``fleet`` (a master's elastic fleet), ``mesh`` (an elastic device mesh)
and ``alerts``; while a fused trainer publishes its step flops, each
snapshot first refreshes the live MFU from the device-timed steps
(``observe/introspect.py``'s ``mfu_snapshot``).
"""

import html
import json
import mimetypes
import os
import sqlite3
import threading
import time
from collections import OrderedDict
from urllib.parse import quote, unquote

from veles_tpu_torch.logger import Logger

__all__ = ["WebStatusServer", "StatusReporter"]

#: the dashboard's static files (live.js)
WEB_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "web")

# Categorical series palette in fixed order, validated per mode with
# the dataviz six-checks validator (lightness band, chroma floor, CVD
# ΔE >= 8 adjacent, normal-vision floor, contrast vs surface); text in
# text tokens, light/dark selected (not auto-flipped).
_STYLE = """
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --text-primary: #0b0b0b;
  --text-secondary: #52514e; --grid: #e4e3df;
  --series-1: #2a78d6; --series-2: #d97706;
  --series-3: #0f8a6d; --series-4: #9d5ad1;
}
@media (prefers-color-scheme: dark) {
  :root { color-scheme: dark;
    --surface-1: #1a1a19; --text-primary: #ffffff;
    --text-secondary: #c3c2b7; --grid: #3a3936;
    --series-1: #3987e5; --series-2: #c98000;
    --series-3: #18a383; --series-4: #a368d6; }
}
body { background: var(--surface-1); color: var(--text-primary);
       font: 14px system-ui, sans-serif; margin: 24px; }
h1 { font-size: 18px; } a { color: var(--series-1); }
table { border-collapse: collapse; }
th, td { border: 1px solid var(--grid); padding: 4px 10px;
         text-align: left; }
th { color: var(--text-secondary); font-weight: 600; }
.num { font-variant-numeric: tabular-nums; }
svg.spark polyline { fill: none; stroke: var(--series-1);
                     stroke-width: 2; }
svg.spark text { fill: var(--text-secondary); font-size: 10px; }
svg.chart { display: block; margin: 8px 0; }
svg.chart line.grid { stroke: var(--grid); stroke-width: 1; }
svg.chart line.cross { stroke: var(--text-secondary);
                       stroke-width: 1; stroke-dasharray: 3 3; }
svg.chart text.axis { fill: var(--text-secondary); font-size: 10px; }
.legend { color: var(--text-secondary); font-size: 12px; }
.legend span { margin-right: 14px; }
.swatch { display: inline-block; width: 10px; height: 10px;
          border-radius: 2px; margin-right: 4px; }
#tip { visibility: hidden; border: 1px solid var(--grid);
       background: var(--surface-1); padding: 6px 10px;
       font-size: 12px; max-width: 420px; }
"""

_INDEX = """<!DOCTYPE html>
<html><head><title>veles-tpu status</title><style>%s</style></head>
<body><h1>veles-tpu sessions</h1>
<div id="tbl">%s</div>
<script>
setInterval(function () {
  fetch("/table").then(function (r) { return r.text(); })
    .then(function (t) { document.getElementById("tbl").innerHTML = t; });
}, 5000);
</script></body></html>
"""

_DETAIL = """<!DOCTYPE html>
<html><head><title>%(sid)s — veles-tpu</title><style>%(style)s</style>
</head><body data-sid="%(sid)s"><h1>session %(sid)s</h1>
<p><a href="/">&larr; all sessions</a></p>
<div id="chart">%(spark)s</div>
<div id="tip"></div>
<table id="posts"><tr><th>time</th><th>epoch</th><th>metrics</th>
<th>slaves</th></tr>%(rows)s</table>
<h1>events</h1>
<table id="events"><tr><th>time</th><th>event</th></tr>%(events)s
</table>
<script src="/static/live.js"></script>
</body></html>
"""


def _metric_history(history):
    """Extract a numeric series for ONE metric key — the first numeric
    key of the earliest post, tracked by name thereafter so a metrics
    dict that gains keys mid-run can't splice two different series."""
    def numeric(value):
        # bool is an int subclass; a {"converged": false} key must not
        # hijack the series
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)

    def items(metrics):
        # dict posts keep their keys; list posts (StatusReporter ships
        # decision.epoch_metrics = [test, validation, train]) key by
        # index
        if isinstance(metrics, dict):
            return list(metrics.items())
        if isinstance(metrics, (list, tuple)):
            return list(enumerate(metrics))
        return []

    key = None
    for post in history:
        for k, value in items(post.get("metrics")):
            if numeric(value):
                key = k
                break
        if key is not None:
            break
    if key is None:
        return []
    points = []
    for post in history:
        for k, value in items(post.get("metrics")):
            if k == key and numeric(value):
                points.append(float(value))
    return points


def _sparkline(points, width=220, height=48, label=True):
    """Inline-SVG sparkline: 2px line, last-value direct label, hover
    title with the range (single series — no legend)."""
    if len(points) < 2:
        return ""
    lo, hi = min(points), max(points)
    span = (hi - lo) or 1.0
    pad = 4
    w, h = width - 2 * pad - (46 if label else 0), height - 2 * pad
    coords = " ".join(
        "%.1f,%.1f" % (pad + w * i / (len(points) - 1),
                       pad + h * (1.0 - (p - lo) / span))
        for i, p in enumerate(points))
    tail = ("<text x='%d' y='%d'>%.4g</text>"
            % (width - 44, height // 2 + 4, points[-1]) if label else "")
    return ("<svg class='spark' width='%d' height='%d' role='img'>"
            "<title>%d points, min %.4g, max %.4g</title>"
            "<polyline points='%s'/>%s</svg>"
            % (width, height, len(points), lo, hi, coords, tail))


class _Store(object):
    """Session status + event retention: in-memory ring backed by an
    optional sqlite file (reference kept these in MongoDB)."""

    def __init__(self, db_path=None, max_sessions=100, max_history=500):
        self.sessions = OrderedDict()   # sid -> latest post, LRU order
        self.history = {}               # sid -> [posts]
        self.events = {}                # sid -> [(ts, text)]
        self.max_sessions = max_sessions
        self.max_history = max_history
        self._lock = threading.Lock()
        self._conn = None
        if db_path:
            self._conn = sqlite3.connect(
                db_path, check_same_thread=False)
            db = self._conn
            with db:
                db.execute("CREATE TABLE IF NOT EXISTS status ("
                           "sid TEXT, ts REAL, body TEXT)")
                db.execute("CREATE TABLE IF NOT EXISTS events ("
                           "sid TEXT, ts REAL, body TEXT)")
            # reload the most recently active sessions only, in recency
            # order so the LRU ring evicts the genuinely oldest first,
            # bounded per session by max_history
            recent = list(db.execute(
                "SELECT sid, MAX(ts) m FROM status GROUP BY sid "
                "ORDER BY m DESC LIMIT ?", (max_sessions,)))
            for sid, _ in reversed(recent):
                posts = [json.loads(body) for (body,) in db.execute(
                    "SELECT body FROM status WHERE sid = ? "
                    "ORDER BY ts DESC LIMIT ?", (sid, max_history))]
                posts.reverse()
                self.history[sid] = posts
                self.sessions[sid] = posts[-1]
                self.events[sid] = self._load_events(db, sid)
            # sessions that only posted events so far (a reporter may
            # post_event before its first status) keep their events too
            for (sid,) in db.execute(
                    "SELECT DISTINCT sid FROM events"):
                if sid not in self.events:
                    self.events[sid] = self._load_events(db, sid)

    def _load_events(self, db, sid):
        return [
            (time.strftime("%H:%M:%S", time.localtime(ts)), body)
            for ts, body in reversed(list(db.execute(
                "SELECT ts, body FROM events WHERE sid = ? "
                "ORDER BY ts DESC LIMIT ?", (sid, self.max_history))))]

    def list_sessions(self):
        with self._lock:
            return list(self.sessions.values())

    def get_history(self, sid):
        with self._lock:
            return list(self.history.get(sid, []))

    def get_events(self, sid):
        with self._lock:
            return list(self.events.get(sid, []))

    def close(self):
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

    def _prune(self, db, table, sid):
        db.execute(
            "DELETE FROM %s WHERE sid = ? AND ts NOT IN (SELECT ts "
            "FROM %s WHERE sid = ? ORDER BY ts DESC LIMIT ?)"
            % (table, table), (sid, sid, self.max_history))

    def record(self, data):
        data = dict(data)
        data["updated"] = time.strftime("%H:%M:%S")
        sid = str(data.get("id", "?"))
        with self._lock:
            self.sessions[sid] = data
            self.sessions.move_to_end(sid)
            hist = self.history.setdefault(sid, [])
            hist.append(data)
            del hist[:-self.max_history]
            while len(self.sessions) > self.max_sessions:
                old, _ = self.sessions.popitem(last=False)
                self.history.pop(old, None)
                self.events.pop(old, None)
                if self._conn is not None:
                    with self._conn as db:
                        db.execute("DELETE FROM status WHERE sid = ?",
                                   (old,))
                        db.execute("DELETE FROM events WHERE sid = ?",
                                   (old,))
            if self._conn is not None:
                with self._conn as db:
                    db.execute("INSERT INTO status VALUES (?, ?, ?)",
                               (sid, time.time(), json.dumps(data)))
                    self._prune(db, "status", sid)
        return data

    def record_event(self, sid, text):
        sid = str(sid)
        with self._lock:
            if sid not in self.events and \
                    len(self.events) >= 2 * self.max_sessions:
                # event-only ids (no status post yet) are bounded too:
                # evict the first sid outside the session ring
                for old in list(self.events):
                    if old not in self.sessions:
                        del self.events[old]
                        if self._conn is not None:
                            with self._conn as db:
                                db.execute(
                                    "DELETE FROM events WHERE sid = ?",
                                    (old,))
                        break
            events = self.events.setdefault(sid, [])
            events.append((time.strftime("%H:%M:%S"), text))
            del events[:-self.max_history]
            if self._conn is not None:
                with self._conn as db:
                    db.execute("INSERT INTO events VALUES (?, ?, ?)",
                               (sid, time.time(), text))
                    self._prune(db, "events", sid)


class WebStatusServer(Logger):
    """The HTTP service over a :class:`_Store`."""

    def __init__(self, port=0, persist_path=None, max_sessions=100,
                 db_path=None):
        super(WebStatusServer, self).__init__()
        from veles_tpu_torch.http_util import BackgroundHTTPServer
        self.store = _Store(db_path=db_path, max_sessions=max_sessions)
        #: kept from the JAX package: each stamped post is appended here
        #: as a JSON line too
        self.persist_path = persist_path
        self._server = BackgroundHTTPServer(self._app, port=port)

    @property
    def port(self):
        return self._server.port

    @property
    def sessions(self):
        return self.store.sessions

    # -- routes ------------------------------------------------------------

    def _app(self, method, path, headers, body):
        if method == "POST":
            data = json.loads(body or b"{}")
            if path == "/update":
                self.record(data)
                return 200, None, {"result": "ok"}
            if path == "/event":
                self.store.record_event(data.get("id", "?"),
                                        str(data.get("event", "")))
                return 200, None, {"result": "ok"}
            return _not_found()
        if path == "/":
            return _html(_INDEX % (_STYLE, self._table_html()))
        if path == "/table":
            return _html(self._table_html())
        if path == "/status.json":
            return _json(self.store.list_sessions())
        if path.startswith("/static/"):
            return _static(path[len("/static/"):])
        if path.startswith("/session/") and path.endswith(".json"):
            return _json(self.store.get_history(
                unquote(path[len("/session/"):-len(".json")])))
        if path.startswith("/events/") and path.endswith(".json"):
            return _json(self.store.get_events(
                unquote(path[len("/events/"):-len(".json")])))
        if path.startswith("/session/"):
            return self._detail(unquote(path[len("/session/"):]))
        return _not_found()

    def _detail(self, sid):
        if not sid or "/" in sid:
            return _not_found()
        store = self.store
        history = store.get_history(sid)
        if not history:
            return _not_found()
        rows = "".join(
            "<tr><td>%s</td><td class='num'>%s</td>"
            "<td>%s</td><td class='num'>%s</td></tr>"
            % tuple(html.escape(str(v)) for v in (
                p.get("updated", ""), p.get("epoch", ""),
                json.dumps(p.get("metrics")), p.get("slaves", "")))
            for p in history[-100:])
        events = "".join(
            "<tr><td>%s</td><td>%s</td></tr>"
            % (html.escape(str(ts)), html.escape(str(text)))
            for ts, text in store.get_events(sid)[-100:])
        return _html(_DETAIL % {
            "sid": html.escape(sid), "style": _STYLE,
            "spark": _sparkline(_metric_history(history), width=420,
                                height=64),
            "rows": rows, "events": events})

    def _table_html(self):
        rows = []
        for s in self.store.list_sessions():
            sid = str(s.get("id", "?"))
            spark = _sparkline(
                _metric_history(self.store.get_history(sid)), label=False)
            cells = "".join(
                "<td>%s</td>" % html.escape(_cell(s, k))
                for k in ("workflow", "mode", "epoch", "metrics",
                          "health", "serve", "fleet", "alerts",
                          "slaves", "updated"))
            rows.append(
                "<tr><td><a href='/session/%s'>%s</a></td>%s<td>%s</td>"
                "</tr>" % (quote(sid, safe=""), html.escape(sid), cells,
                           spark))
        return ("<table><tr><th>id</th><th>workflow</th><th>mode</th>"
                "<th>epoch</th><th>metrics</th><th>health</th>"
                "<th>serve</th><th>fleet</th><th>alerts</th>"
                "<th>slaves</th><th>updated</th><th>trend</th></tr>"
                "%s</table>" % "\n".join(rows))

    def record(self, data):
        stamped = self.store.record(data)
        if self.persist_path:
            with open(self.persist_path, "a") as fout:
                fout.write(json.dumps(stamped) + "\n")

    def start_background(self):
        thread = self._server.start()
        self.info("web status on http://127.0.0.1:%d/", self.port)
        return thread

    def stop(self):
        # stop() joins the serving thread before the database closes
        self._server.stop()
        self.store.close()


def _cell(session, key):
    """One dashboard cell: the serve block's segments folded into their
    p99s, the alerts block as FIRING or ok, the other blocks as JSON."""
    value = session.get(key)
    if value is None:
        return ""
    if key == "serve" and isinstance(value, dict) and \
            isinstance(value.get("segments"), dict):
        value = dict(value)
        segments = value.pop("segments")
        value["segments_p99_ms"] = {name: row.get("p99_ms")
                                    for name, row in segments.items()}
        return json.dumps(value)
    if key == "alerts" and isinstance(value, dict):
        active = value.get("active") or []
        if active:
            return "FIRING: " + ", ".join(active)
        fired = value.get("fired_total") or 0
        return "ok (%d fired)" % fired if fired else "ok"
    if key in ("metrics", "health", "serve", "fleet"):
        return json.dumps(value)
    return str(value)


def _html(text):
    return 200, {"Content-Type": "text/html; charset=UTF-8"}, \
        text.encode("utf-8")


def _json(obj):
    return 200, {"Content-Type": "application/json"}, \
        json.dumps(obj).encode("utf-8")


def _not_found():
    return 404, {"Content-Type": "text/html; charset=UTF-8"}, \
        b"<html><title>404: Not Found</title>" \
        b"<body>404: Not Found</body></html>"


def _static(name):
    """A file of :data:`WEB_DIR`; nothing outside it."""
    path = os.path.realpath(os.path.join(WEB_DIR, unquote(name)))
    if not path.startswith(os.path.realpath(WEB_DIR) + os.sep) or \
            not os.path.isfile(path):
        return _not_found()
    with open(path, "rb") as fin:
        data = fin.read()
    kind = mimetypes.guess_type(path)[0] or "application/octet-stream"
    return 200, {"Content-Type": kind}, data


class StatusReporter(object):
    """Posts a session's status to a web-status service (the launcher's
    half)."""

    def __init__(self, url, session_id, workflow):
        self.url = url.rstrip("/")
        self.session_id = session_id
        self.workflow = workflow

    def snapshot(self):
        from veles_tpu_torch.elastic import fleet_snapshot
        from veles_tpu_torch.observe.metrics import health_snapshot
        from veles_tpu_torch.observe.metrics import registry as _registry
        from veles_tpu_torch.parallel.mesh import mesh_snapshot
        from veles_tpu_torch.serve.batcher import serve_snapshot
        decision = getattr(self.workflow, "decision", None)
        launcher = self.workflow.launcher
        if _registry.peek("xla.step_flops") is not None:
            # refresh the live MFU gauge from the device-timed step
            # window, so the health block carries it (the reporter's
            # thread: off the step's path)
            try:
                from veles_tpu_torch.observe import introspect
                introspect.mfu_snapshot()
            except Exception:
                pass
        return {
            "id": self.session_id,
            "workflow": type(self.workflow).__name__,
            "mode": getattr(launcher, "workflow_mode", "standalone"),
            "epoch": getattr(decision, "epoch_number", None),
            "metrics": getattr(decision, "epoch_metrics", None),
            "slaves": len(getattr(
                getattr(launcher, "_agent", None), "slaves", {}) or {}),
            # the numerics-health counters (skips, rollbacks, blacklist,
            # quarantine), read without a device sync
            "health": health_snapshot(),
            # the serve tier's health, on processes that serve
            "serve": serve_snapshot() or None,
            # a master's elastic fleet: membership epoch, live,
            # blacklisted and quarantined counts, speculative jobs
            "fleet": fleet_snapshot() or None,
            # an elastic device mesh's size, epoch and reshards
            "mesh": mesh_snapshot() or None,
            # the process's active and recently fired alerts
            "alerts": self._alerts_block(),
        }

    @staticmethod
    def _alerts_block():
        try:
            from veles_tpu_torch.observe.alerts import alerts
            if not alerts.rules and not alerts.history(last=1):
                return None  # nothing configured, nothing ever fired
            return alerts.snapshot(history=4)
        except Exception:
            return None

    def _post_json(self, path, payload):
        import urllib.request
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return json.loads(resp.read())

    def post(self):
        return self._post_json("/update", self.snapshot())

    def post_event(self, event):
        """Forward one structured event record (a JSON text)."""
        return self._post_json(
            "/event", {"id": self.session_id, "event": event})
