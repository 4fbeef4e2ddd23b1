"""The port's web-status service (veles_tpu_torch/web_status.py), the
launcher's ``--web-status`` reporter and the logger's event hooks, on
the CPU, against the JAX package's.

- tests/test_services.py's web-status tests on the port: the round
  trip (``/status.json``, ``/``, ``/session/<id>``, ``/static/live.js``),
  history, events and the sqlite file surviving a restart, the
  sparkline, and the launcher's periodic posts with the run's events.
- Either package's reporter posting to either package's server: the
  two servers keep the same session rows, history and events, and their
  sqlite files the same tables; the port's reporter sends the JAX
  reporter's snapshot keys.
- ``_metric_history`` and ``_sparkline`` equal the JAX package's on the
  same inputs.
- A slave's launcher posts nothing; the event hooks are added and
  removed as the JAX package's are (a failing hook never breaks the
  emitter).
"""

import json
import sqlite3
import time
import urllib.error
import urllib.request

import pytest

from tests.torch_master_slave import LAYERS, Blobs, build
from veles_tpu_torch import logger as port_logger
from veles_tpu_torch.web_status import (StatusReporter, WebStatusServer,
                                        _metric_history, _sparkline)


@pytest.fixture(scope="module")
def trained():
    sw = build("standalone", "svc", max_epochs=3)
    sw.run()
    return sw


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as resp:
        return resp.read().decode(), resp.headers.get("Content-Type")


def test_web_status_roundtrip(trained):
    server = WebStatusServer()
    server.start_background()
    try:
        base = "http://127.0.0.1:%d" % server.port
        reporter = StatusReporter(base, "sess1", trained)
        assert reporter.post()["result"] == "ok"
        sessions = json.loads(_get(base, "/status.json")[0])
        assert len(sessions) == 1
        assert sessions[0]["id"] == "sess1"
        assert sessions[0]["epoch"] == 3
        assert sessions[0]["workflow"] == "StandardWorkflow"
        page, kind = _get(base, "/")
        assert "sess1" in page and kind.startswith("text/html")
        detail = _get(base, "/session/sess1")[0]
        assert 'data-sid="sess1"' in detail
        assert "/static/live.js" in detail
        js, kind = _get(base, "/static/live.js")
        assert "extractSeries" in js and "crosshair" in js
        assert "javascript" in kind
        for missing in ("/session/nobody", "/static/../web_status.py",
                        "/nowhere"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(base, missing)
            assert err.value.code == 404
    finally:
        server.stop()


def test_web_status_history_events_and_sqlite(tmp_path, trained):
    db = str(tmp_path / "status.sqlite")
    server = WebStatusServer(db_path=db)
    server.start_background()
    try:
        base = "http://127.0.0.1:%d" % server.port
        reporter = StatusReporter(base, "sess-h", trained)
        for _ in range(3):
            assert reporter.post()["result"] == "ok"
        assert reporter.post_event("epoch 1 done")["result"] == "ok"
        assert len(json.loads(_get(base, "/session/sess-h.json")[0])) == 3
        events = json.loads(_get(base, "/events/sess-h.json")[0])
        assert events and events[0][1] == "epoch 1 done"
        assert "epoch 1 done" in _get(base, "/session/sess-h")[0]
    finally:
        server.stop()
    # a restart on the same sqlite file: the sessions and events return
    server2 = WebStatusServer(db_path=db)
    server2.start_background()
    try:
        base = "http://127.0.0.1:%d" % server2.port
        sessions = json.loads(_get(base, "/status.json")[0])
        assert [s["id"] for s in sessions] == ["sess-h"]
        assert len(json.loads(_get(base, "/session/sess-h.json")[0])) == 3
        events = json.loads(_get(base, "/events/sess-h.json")[0])
        assert events[0][1] == "epoch 1 done"
    finally:
        server2.stop()


_HISTORIES = [
    [{"metrics": {"err_pct": v}} for v in (9.0, 5.0, 3.0, 2.5)],
    [{"metrics": [None, v, v + 1]} for v in (4.0, 2.0)],
    [{"metrics": {"done": False, "err": v}} for v in (3.0, 1.0)],
    [{"metrics": {"a": 1}}, {"metrics": {"a": 2, "b": 7}},
     {"metrics": {"b": 3}}, {"metrics": None}, {}],
    [{"metrics": "text"}, {"metrics": [True, 0.5]}],
    [],
]


@pytest.mark.parametrize("history", _HISTORIES)
def test_metric_history_and_sparkline_equal_jax(history):
    from veles_tpu import web_status as jax_ws
    points = _metric_history(history)
    assert points == jax_ws._metric_history(history)
    for kwargs in ({}, {"width": 420, "height": 64},
                   {"label": False}):
        assert _sparkline(points, **kwargs) == \
            jax_ws._sparkline(points, **kwargs)


def test_sparkline_rendering():
    points = _metric_history(_HISTORIES[0])
    assert points == [9.0, 5.0, 3.0, 2.5]
    svg = _sparkline(points)
    assert svg.startswith("<svg") and "polyline" in svg and "2.5" in svg
    assert _sparkline([1.0]) == ""


class _Decision(object):
    epoch_number = 4
    epoch_metrics = [None, 2.5, 1.25]


class _Launcher(object):
    workflow_mode = "master"

    class _agent(object):
        slaves = {"a": 1, "b": 2}


class ProbeWorkflow(object):
    """What a reporter reads of a workflow."""
    decision = _Decision()
    launcher = _Launcher()


def _strip(rows):
    return [{k: v for k, v in row.items() if k != "updated"}
            for row in rows]


@pytest.mark.parametrize("reporter_package", ["port", "jax"])
def test_servers_and_reporters_interoperate(reporter_package, tmp_path):
    """One package's reporter posts to both packages' servers: the two
    keep the same session rows, history and events, and the same sqlite
    tables."""
    from veles_tpu import web_status as jax_ws
    reporter_cls = {"port": StatusReporter,
                    "jax": jax_ws.StatusReporter}[reporter_package]
    servers = {"port": WebStatusServer(db_path=str(tmp_path / "p.db")),
               "jax": jax_ws.WebStatusServer(db_path=str(tmp_path / "j.db"))}
    seen = {}
    try:
        for name, server in servers.items():
            server.start_background()
            base = "http://127.0.0.1:%d" % server.port
            reporter = reporter_cls(base, "sess/x y", ProbeWorkflow())
            for i in range(3):
                assert reporter.post() == {"result": "ok"}
                assert reporter.post_event(json.dumps({"n": i})) == \
                    {"result": "ok"}
            quoted = urllib.request.quote("sess/x y", safe="")
            seen[name] = (
                _strip(json.loads(_get(base, "/status.json")[0])),
                _strip(json.loads(
                    _get(base, "/session/%s.json" % quoted)[0])),
                [text for _, text in json.loads(
                    _get(base, "/events/%s.json" % quoted)[0])])
            assert "sess/x y" in _get(base, "/")[0]
    finally:
        for server in servers.values():
            server.stop()
    assert seen["port"] == seen["jax"]
    rows, history, events = seen["port"]
    assert rows[0]["epoch"] == 4 and rows[0]["slaves"] == 2
    assert rows[0]["metrics"] == [None, 2.5, 1.25]
    assert rows[0]["mode"] == "master" and len(history) == 3
    assert events == ['{"n": 0}', '{"n": 1}', '{"n": 2}']
    tables = []
    for name in ("p.db", "j.db"):
        db = sqlite3.connect(str(tmp_path / name))
        tables.append(sorted(db.execute(
            "SELECT name, sql FROM sqlite_master")))
        db.close()
    assert tables[0] == tables[1]


def test_reporter_snapshot_has_the_jax_keys():
    from veles_tpu import web_status as jax_ws
    ours = StatusReporter("http://x", "s", ProbeWorkflow()).snapshot()
    theirs = jax_ws.StatusReporter("http://x", "s",
                                   ProbeWorkflow()).snapshot()
    assert sorted(ours) == sorted(theirs)
    for key in ("id", "workflow", "mode", "epoch", "metrics", "slaves"):
        assert ours[key] == theirs[key], key


def test_launcher_posts_status_periodically():
    """With ``web_status`` set, a standalone session posts while it
    runs and once after the run, and forwards its event records."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.models.nn_workflow import StandardWorkflow
    from veles_tpu_torch.prng import RandomGenerator
    server = WebStatusServer()
    server.start_background()
    try:
        launcher = Launcher(
            web_status="http://127.0.0.1:%d" % server.port,
            notification_interval=0.02)
        StandardWorkflow(
            launcher, layers=[dict(s) for s in LAYERS],
            loader_factory=lambda w: Blobs(
                w, minibatch_size=64, prng=RandomGenerator("wsl", seed=7)),
            decision_config=dict(max_epochs=3))
        launcher.initialize(device=Device("cpu"))

        def hold_the_end(record):
            # the run ends only after a periodic post has landed, so
            # the final post is never the only one
            if record["name"] == "run" and record["kind"] == "end":
                deadline = time.monotonic() + 30
                while not server.store.list_sessions() and \
                        time.monotonic() < deadline:
                    time.sleep(0.01)

        port_logger.add_event_hook(hold_the_end)
        try:
            launcher.run()
        finally:
            port_logger.remove_event_hook(hold_the_end)
        sessions = server.store.list_sessions()
        assert len(sessions) == 1
        post = sessions[0]
        assert post["workflow"] == "StandardWorkflow"
        assert post["epoch"] == 3 and post["mode"] == "standalone"
        assert post["metrics"] == list(
            launcher.workflow.decision.epoch_metrics)
        assert len(server.store.get_history(post["id"])) > 1
        events = server.store.get_events(post["id"])
        assert any('"name": "run"' in text for _, text in events), events
        assert launcher._reporter_thread is None
    finally:
        server.stop()
    assert not port_logger._event_hooks  # the reporter's hook is gone


def test_a_slave_posts_nothing():
    from veles_tpu_torch.launcher import Launcher
    server = WebStatusServer()
    server.start_background()
    try:
        launcher = Launcher(master_address="127.0.0.1:1",
                            web_status="http://127.0.0.1:%d" % server.port)
        assert launcher.is_slave
        launcher._start_status_reporter()
        assert launcher._reporter_thread is None
        assert not port_logger._event_hooks
        assert server.store.list_sessions() == []
    finally:
        server.stop()


def test_web_status_flag_reaches_the_launcher():
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.cmdline import apply_parsed_args
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    saved = root.common.launcher.get("web_status", "")
    try:
        args = Main().init_parser().parse_args(
            ["wf.py", "--web-status", "http://127.0.0.1:9"])
        apply_parsed_args(args)
        launcher = Launcher()
        assert launcher.web_status_url == "http://127.0.0.1:9"
        assert launcher.notification_interval == 1.0
    finally:
        root.common.launcher.web_status = saved


class _Emitter(port_logger.Logger):
    pass


def test_event_hooks_added_and_removed_as_jax():
    from veles_tpu import logger as jax_logger
    records = {"port": [], "jax": []}
    hooks = {"port": records["port"].append,
             "jax": records["jax"].append}

    def broken(record):
        raise RuntimeError("observers never break the emitter")

    class JaxEmitter(jax_logger.Logger):
        pass

    emitters = {"port": _Emitter(), "jax": JaxEmitter()}
    modules = {"port": port_logger, "jax": jax_logger}
    for name, module in modules.items():
        module.add_event_hook(hooks[name])
        module.add_event_hook(broken)
        try:
            emitters[name].event("probe", "begin", step=1)
            emitters[name].event("probe", "end", step=1)
            with pytest.raises(ValueError):
                emitters[name].event("probe", "sideways")
        finally:
            module.remove_event_hook(hooks[name])
            module.remove_event_hook(broken)
            module.remove_event_hook(broken)  # twice: no error
        emitters[name].event("probe", "single")
    keys = {"session", "instance", "name", "kind", "time", "iso", "step"}
    for name in ("port", "jax"):
        assert [(r["name"], r["kind"], r["step"]) for r in records[name]] \
            == [("probe", "begin", 1), ("probe", "end", 1)]
        assert set(records[name][0]) == keys
    assert records["port"][0]["instance"] == "_Emitter"
    assert not port_logger._event_hooks
