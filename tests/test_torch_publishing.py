"""The port's report publisher (veles_tpu_torch/publishing/) against the
JAX package's (veles_tpu/publishing/).

- for one info dict, the Markdown and HTML reports are byte for byte
  the JAX package's;
- ``gather_info`` of two workflows trained alike (the blobs MLP, 2
  epochs per unit, the same seeds) has the JAX package's keys, and
  equal values where they hold no time: the error percentages to the
  JAX package's float32 (rel 1e-6), the unit names and runs, the
  dataset, the graph, the results; the checksum is each workflow's own;
- the PDF is a valid file (tests/test_service_depth.py);
- the Confluence backend, against the mock server of
  tests/test_service_depth.py, makes the JAX backend's requests in the
  JAX backend's order: create, de-duplicated title, version, the
  attachments versioned, not duplicated.
"""

import http.server
import json
import os
import threading

import numpy
import pytest

from veles_tpu.publishing import (ConfluenceBackend as JaxConfluence,
                                  HTMLBackend as JaxHTML,
                                  MarkdownBackend as JaxMarkdown,
                                  Publisher as JaxPublisher)
from veles_tpu_torch.publishing import (ConfluenceBackend, HTMLBackend,
                                        MarkdownBackend, PDFBackend,
                                        Publisher)

from test_torch_workflow import blobs, build_jax, build_torch

INFO = {
    "name": "StandardWorkflow", "checksum": "0123abcd",
    "date": "2026-01-02 03:04:05", "epochs": 7,
    "metrics": {"test": None, "validation": 2.5, "train": 1.25,
                "best": 2.25},
    "dataset": {"test": 0, "validation": 360, "train": 1437},
    "units": [{"name": "DigitsLoader", "runs": 120, "time": 0.25},
              {"name": "FusedTrainer", "runs": 120, "time": 1.5}],
    "graph_dot": "digraph {}", "plots_dir": None,
    "results": {"Total epochs": 7, "Errors": {"validation": 2.5}},
}


@pytest.fixture(scope="module")
def trained():
    arrays = blobs()
    jsw = build_jax(arrays, epochs=2)
    jsw.run()
    tsw = build_torch(arrays, epochs=2)
    tsw.run()
    return jsw, tsw


@pytest.mark.parametrize("backends", [(MarkdownBackend, JaxMarkdown),
                                      (HTMLBackend, JaxHTML)],
                         ids=["markdown", "html"])
def test_reports_byte_equal_to_jax(backends, tmp_path):
    ours, theirs = backends
    got = ours(str(tmp_path / "port")).render(dict(INFO))
    want = theirs(str(tmp_path / "jax")).render(dict(INFO))
    assert os.path.basename(got) == os.path.basename(want)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_gather_info_matches_jax(trained):
    jsw, tsw = trained
    got = Publisher(tsw).gather_info()
    want = JaxPublisher(jsw).gather_info()
    assert sorted(got) == sorted(want)
    for key in ("name", "epochs", "dataset", "graph_dot", "plots_dir"):
        assert got[key] == want[key], key
    assert got["checksum"] == tsw.checksum
    for split in ("test", "validation", "train", "best"):
        if want["metrics"][split] is None:
            assert got["metrics"][split] is None
        else:
            numpy.testing.assert_allclose(got["metrics"][split],
                                          want["metrics"][split], rtol=1e-6)
    assert [(u["name"], u["runs"]) for u in got["units"]] == \
        [(u["name"], u["runs"]) for u in want["units"]]
    assert all(isinstance(u["time"], float) for u in got["units"])
    assert got["results"]["Total epochs"] == want["results"]["Total epochs"]
    assert got["results"]["Best epoch"] == want["results"]["Best epoch"]


def test_publisher_writes_reports(trained, tmp_path):
    _, tsw = trained
    pub = Publisher(tsw, backends=[MarkdownBackend(str(tmp_path)),
                                   HTMLBackend(str(tmp_path))])
    pub.initialize()
    pub.run()
    assert len(pub.reports) == 2
    md = open(os.path.join(str(tmp_path), "report.md")).read()
    assert "Training report: StandardWorkflow" in md
    assert "| ArraysLoader | 16 |" in md
    assert "StandardWorkflow" in open(
        os.path.join(str(tmp_path), "report.html")).read()


def test_pdf_report(trained, tmp_path):
    pytest.importorskip("matplotlib")
    _, tsw = trained
    Publisher(tsw, backends=[PDFBackend(str(tmp_path))]).run()
    pdf = tmp_path / "report.pdf"
    assert pdf.read_bytes()[:5] == b"%PDF-"
    assert pdf.stat().st_size > 1000


class _Confluence(http.server.BaseHTTPRequestHandler):
    """tests/test_service_depth.py's mock of the Confluence REST API,
    recording each request and serving an attachment search."""

    def log_message(self, *args):
        pass

    def _json(self, payload):
        body = json.dumps(payload).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _record(self, body=None):
        state = self.server.state
        state["log"].append((self.command, self.path,
                             self.headers.get("Authorization"), body))
        return state

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse
        state = self._record()
        parsed = urlparse(self.path)
        query = parse_qs(parsed.query)
        if parsed.path.endswith("/child/attachment"):
            pid = parsed.path.split("/")[-3]
            name = query.get("filename", [""])[0]
            hits = [{"id": "att-%s-%s" % (pid, name)}
                    for fname in state["attachments"].get(pid, [])
                    if fname == name]
            self._json({"results": hits})
            return
        title = query.get("title", [""])[0]
        self._json({"results": [
            {"id": pid, "title": p["title"],
             "version": {"number": p["version"]}}
            for pid, p in state["pages"].items() if p["title"] == title]})

    def do_POST(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if "/child/attachment" in self.path:
            fname = raw.split(b'filename="', 1)[1].split(b'"', 1)[0]
            state = self._record(fname.decode())
            pid = self.path.split("/")[4]
            if not self.path.endswith("/data"):
                state["attachments"].setdefault(pid, []).append(
                    fname.decode())
            self._json({"results": [{"title": fname.decode()}]})
            return
        payload = json.loads(raw)
        state = self._record(payload["title"])
        pid = str(state["next_id"])
        state["next_id"] += 1
        state["pages"][pid] = {"title": payload["title"], "version": 1,
                               "body": payload["body"]["storage"]["value"]}
        self._json({"id": pid})

    def do_PUT(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        payload = json.loads(raw)
        state = self._record((payload["title"],
                              payload["version"]["number"]))
        pid = self.path.rsplit("/", 1)[1]
        state["pages"][pid].update(version=payload["version"]["number"])
        self._json({"id": pid})


def _confluence_log(publisher_cls, backend_cls, workflow, plots_dir):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Confluence)
    server.state = {"pages": {}, "attachments": {}, "next_id": 1000,
                    "log": []}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        urls = []
        for page in (None, None, "StandardWorkflow"):
            backend = backend_cls(base, space="ML", token="sekret",
                                  page=page)
            pub = publisher_cls(workflow, backends=[backend],
                                plots_dir=plots_dir)
            pub.run()
            urls.append(backend.url[len(base):])
        return server.state, urls
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_confluence_requests_match_jax(trained, tmp_path):
    jsw, tsw = trained
    plots = tmp_path / "plots"
    plots.mkdir()
    (plots / "EpochCurve.png").write_bytes(b"\x89PNG fake")
    got, got_urls = _confluence_log(Publisher, ConfluenceBackend, tsw,
                                    str(plots))
    want, want_urls = _confluence_log(JaxPublisher, JaxConfluence, jsw,
                                      str(plots))
    assert got["log"] == want["log"]
    assert got_urls == want_urls == ["/pages/1000", "/pages/1001",
                                     "/pages/1000"]
    assert sorted(p["title"] for p in got["pages"].values()) == [
        "StandardWorkflow", "StandardWorkflow (1)"]
    assert got["pages"]["1000"]["version"] == 2
    # each page holds one of each attachment: the re-publish versioned them
    assert {pid: sorted(names) for pid, names in
            got["attachments"].items()} == {
        "1000": ["EpochCurve.png", "workflow.dot"],
        "1001": ["EpochCurve.png", "workflow.dot"]}
    assert any(method == "POST" and path.endswith("/data")
               for method, path, _, _ in got["log"])
    assert {auth for _, _, auth, _ in got["log"]} == {"Bearer sekret"}
    assert "<h2>Metrics</h2>" in got["pages"]["1000"]["body"]
