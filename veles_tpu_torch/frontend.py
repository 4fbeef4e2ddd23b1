"""Web command composer: ``python -m veles_tpu_torch --frontend [PORT]``.

Counterpart of ``veles_tpu/frontend.py``.  The page's form is generated
from the port's own argparse parser (:meth:`veles_tpu_torch.__main__.
Main.init_parser`, which aggregates every registered flag), so a unit or
service that contributes a flag shows up here.  ``POST /run`` with the
page's per-session token launches the composed command as a child
``python -m veles_tpu_torch ...`` (anything else is refused, ``-m
veles_tpu`` included), one run at a time; ``GET /status`` reports it.
A child composed without ``-d`` takes the card, as the command line
does, and where there is none it ends with ``no CUDA device`` before it
trains.  Served on the standard library's ``http.server``
(:mod:`veles_tpu_torch.http_util`).
"""

import html
import json
import shlex
import subprocess
import sys
import uuid

from veles_tpu_torch.http_util import BackgroundHTTPServer

__all__ = ["FrontendServer"]

#: the argv prefix every composed run must start with
COMMAND = ["-m", "veles_tpu_torch"]

_PAGE = """<!DOCTYPE html>
<html><head><title>veles_tpu_torch composer</title><style>
body { font: 14px system-ui, sans-serif; margin: 24px; max-width: 760px; }
label { display: block; margin-top: 8px; }
input[type=text] { width: 24em; }
#cmd { background: #f3f3f1; padding: 8px; display: block;
       margin-top: 16px; word-break: break-all; }
.help { color: #52514e; font-size: 12px; }
</style></head><body>
<h1>compose a veles_tpu_torch run</h1>
<form id="form">
<label>workflow file <input type="text" name="workflow" data-pos="1">
</label>
<label>config file <input type="text" name="config" data-pos="2"></label>
%s
</form>
<code id="cmd"></code>
<p><button onclick="run()">run</button> <span id="status"></span></p>
<script>
var EXE = %s, TOKEN = %s;
function compose() {
  var head = [EXE, "-m", "veles_tpu_torch"];
  var tail = [];
  var form = document.getElementById("form");
  var positional = [];
  Array.prototype.forEach.call(form.elements, function (el) {
    if (!el.name) return;
    if (el.dataset.pos) {
      if (el.value) positional[+el.dataset.pos - 1] = el.value;
    } else if (el.type === "checkbox") {
      if (el.checked) tail.push(el.name);
    } else if (el.value) {
      tail.push(el.name, el.value);
    }
  });
  var parts = head.concat(positional.filter(Boolean)).concat(tail);
  document.getElementById("cmd").textContent = parts.join(" ");
  return parts;
}
document.getElementById("form").addEventListener("input", compose);
function run() {
  fetch("/run", {method: "POST",
                 body: JSON.stringify({argv: compose().slice(1),
                                       token: TOKEN})})
    .then(function (r) { return r.json(); })
    .then(function (d) {
      document.getElementById("status").textContent =
        d.error || ("started pid " + d.pid);
    });
}
compose();
</script></body></html>
"""


def _field(action):
    name = action.option_strings[-1] if action.option_strings else None
    if name in (None, "--help", "--frontend"):
        return ""
    help_text = html.escape(action.help or "")
    if action.nargs == 0 or action.const is True:
        control = "<input type='checkbox' name='%s'>" % name
    else:
        control = "<input type='text' name='%s'>" % name
    return ("<label>%s %s <span class='help'>%s</span></label>"
            % (html.escape(name), control, help_text))


class FrontendServer(object):
    """Serves the composer; launched by ``--frontend [PORT]``."""

    def __init__(self, parser, port=0):
        fields = "".join(_field(a) for a in parser._actions)
        # per-session token: a cross-origin page can POST to localhost
        # without a CORS preflight, but it cannot read this page to
        # learn the token
        self.token = uuid.uuid4().hex
        self.page = (_PAGE % (fields, json.dumps(sys.executable),
                              json.dumps(self.token))).encode("utf-8")
        self.process = None
        self.command = None
        self._server = BackgroundHTTPServer(self._app, port=port)

    def _app(self, method, path, headers, body):
        if (method, path) == ("GET", "/"):
            return 200, {"Content-Type": "text/html; charset=UTF-8"}, \
                self.page
        if (method, path) == ("POST", "/run"):
            return 200, None, self._run(body)
        if (method, path) == ("GET", "/status"):
            proc = self.process
            return 200, None, {
                "command": self.command,
                "running": proc is not None and proc.poll() is None,
                "returncode": None if proc is None else proc.poll()}
        return 404, None, {"error": "not found"}

    def _run(self, body):
        payload = json.loads(body or b"{}")
        argv = payload.get("argv") or []
        if not isinstance(argv, list) or \
                any(not isinstance(a, str) for a in argv):
            return {"error": "argv must be a string list"}
        if payload.get("token") != self.token:
            return {"error": "bad or missing token"}
        if argv[:2] != COMMAND:
            # only veles_tpu_torch runs may be composed
            return {"error": "argv must start with -m veles_tpu_torch"}
        if self.process is not None and self.process.poll() is None:
            return {"error": "a run is already active (pid %d)"
                    % self.process.pid}
        try:
            self.process = subprocess.Popen([sys.executable] + argv)
        except OSError as exc:
            return {"error": str(exc)}
        self.command = " ".join(shlex.quote(a) for a in argv)
        return {"pid": self.process.pid}

    @property
    def port(self):
        return self._server.port

    def start_background(self):
        return self._server.start()

    def stop(self):
        """Stop serving; a composed run still going is terminated and
        reaped."""
        self._server.stop()
        proc = self.process
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
