"""Publishing backends: the report writers.

Counterpart of ``veles_tpu/publishing/backends.py``, with its output
text: Markdown and HTML (byte for byte the JAX package's for the same
info dict), PDF through matplotlib's ``PdfPages`` (``ImportError`` where
matplotlib is not installed) and Confluence over its REST API (create
or version the page, a de-duplicated title, attachments versioned, not
duplicated).  Host services: they touch no device.
"""

import json
import os

__all__ = ["MarkdownBackend", "HTMLBackend", "PDFBackend",
           "ConfluenceBackend"]


class BackendBase(object):
    def __init__(self, output_dir):
        self.output_dir = output_dir

    def render(self, info):
        raise NotImplementedError


class MarkdownBackend(BackendBase):
    def render(self, info):
        os.makedirs(self.output_dir, exist_ok=True)
        lines = [
            "# Training report: %s" % info["name"],
            "",
            "- date: %s" % info["date"],
            "- checksum: `%s`" % info["checksum"],
            "- epochs: %s" % info["epochs"],
            "",
            "## Metrics",
            "",
            "| split | value |",
            "|---|---|",
        ]
        for split in ("test", "validation", "train", "best"):
            lines.append("| %s | %s |" % (split,
                                          info["metrics"].get(split)))
        lines += [
            "",
            "## Dataset",
            "",
            "| split | samples |",
            "|---|---|",
        ]
        for split in ("test", "validation", "train"):
            lines.append("| %s | %s |" % (split,
                                          info["dataset"].get(split)))
        lines += ["", "## Unit run times", "",
                  "| unit | runs | seconds |", "|---|---|---|"]
        for u in info["units"]:
            lines.append("| %s | %d | %.4f |" % (u["name"], u["runs"],
                                                 u["time"]))
        if info.get("results"):
            lines += ["", "## Results", "", "```json",
                      json.dumps(info["results"], indent=1,
                                 default=repr),
                      "```"]
        path = os.path.join(self.output_dir, "report.md")
        with open(path, "w") as fout:
            fout.write("\n".join(lines) + "\n")
        return path


class HTMLBackend(BackendBase):
    def render(self, info):
        os.makedirs(self.output_dir, exist_ok=True)
        rows = "".join(
            "<tr><td>%s</td><td>%s</td></tr>" % (k, info["metrics"][k])
            for k in ("test", "validation", "train", "best"))
        units = "".join(
            "<tr><td>%s</td><td>%d</td><td>%.4f</td></tr>" %
            (u["name"], u["runs"], u["time"]) for u in info["units"])
        html = (
            "<html><head><title>%s</title></head><body>"
            "<h1>%s</h1><p>%s — epochs: %s</p>"
            "<h2>Metrics</h2><table border=1>%s</table>"
            "<h2>Units</h2><table border=1>"
            "<tr><th>unit</th><th>runs</th><th>s</th></tr>%s</table>"
            "</body></html>" % (
                info["name"], info["name"], info["date"],
                info["epochs"], rows, units))
        path = os.path.join(self.output_dir, "report.html")
        with open(path, "w") as fout:
            fout.write(html)
        return path


class PDFBackend(BackendBase):
    """PDF report through matplotlib's PdfPages."""

    def render(self, info):
        import matplotlib
        matplotlib.use("Agg", force=False)
        from matplotlib.backends.backend_pdf import PdfPages
        import matplotlib.pyplot as plt

        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir, "report.pdf")
        with PdfPages(path) as pdf:
            fig = plt.figure(figsize=(8.27, 11.69))  # A4
            fig.text(0.5, 0.95, "Training report: %s" % info["name"],
                     ha="center", size=16, weight="bold")
            fig.text(0.1, 0.90, "date: %s" % info["date"], size=10)
            fig.text(0.1, 0.88, "checksum: %s" % info["checksum"],
                     size=8, family="monospace")
            fig.text(0.1, 0.86, "epochs: %s" % info["epochs"], size=10)

            ax = fig.add_axes([0.1, 0.62, 0.8, 0.20])
            ax.axis("off")
            rows = [[split, str(info["metrics"].get(split))]
                    for split in ("test", "validation", "train", "best")]
            table = ax.table(cellText=rows,
                             colLabels=["split", "metric"],
                             loc="center")
            table.scale(1, 1.4)
            ax.set_title("Metrics")

            ax2 = fig.add_axes([0.1, 0.40, 0.8, 0.16])
            ax2.axis("off")
            rows2 = [[split, str(info["dataset"].get(split))]
                     for split in ("test", "validation", "train")]
            ax2.table(cellText=rows2,
                      colLabels=["split", "samples"], loc="center")
            ax2.set_title("Dataset")

            units = info["units"][:20]
            if units:
                ax3 = fig.add_axes([0.1, 0.05, 0.8, 0.30])
                ax3.axis("off")
                rows3 = [[u["name"], str(u["runs"]),
                          "%.4f" % u["time"]] for u in units]
                ax3.table(cellText=rows3,
                          colLabels=["unit", "runs", "seconds"],
                          loc="center")
                ax3.set_title("Unit run times")
            pdf.savefig(fig)
            plt.close(fig)

            plots_dir = info.get("plots_dir")
            if plots_dir and os.path.isdir(plots_dir):
                for fname in sorted(os.listdir(plots_dir)):
                    if not fname.endswith(".png"):
                        continue
                    img = plt.imread(os.path.join(plots_dir, fname))
                    fig = plt.figure(figsize=(8.27, 11.69))
                    ax = fig.add_axes([0.05, 0.05, 0.9, 0.9])
                    ax.imshow(img)
                    ax.axis("off")
                    ax.set_title(fname)
                    pdf.savefig(fig)
                    plt.close(fig)
        return path


class ConfluenceBackend(BackendBase):
    """Publishes the report to Atlassian Confluence over the REST API
    in storage format: create or version the page, de-duplicate the
    title, attach the plots and the workflow graph.

    ``server`` is the base URL (e.g. http://confluence:8090); auth is a
    bearer ``token`` or a ``username`` / ``password`` basic pair.
    """

    def __init__(self, server, space, page=None, parent_id=None,
                 token=None, username=None, password=None,
                 output_dir=None):
        super(ConfluenceBackend, self).__init__(output_dir)
        self.server = server.rstrip("/")
        self.space = space
        self.page = page
        self.parent_id = parent_id
        self.token = token
        self.username = username
        self.password = password
        self.url = None

    # -- HTTP plumbing ------------------------------------------------------

    def _headers(self):
        import base64
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = "Bearer %s" % self.token
        elif self.username is not None:
            headers["Authorization"] = "Basic %s" % base64.b64encode(
                ("%s:%s" % (self.username, self.password or ""))
                .encode()).decode()
        return headers

    def _request(self, method, path, payload=None, headers=None,
                 body=None):
        import urllib.request
        data = body
        if payload is not None:
            data = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.server + path, data=data, method=method,
            headers={**self._headers(), **(headers or {})})
        with urllib.request.urlopen(req, timeout=15) as resp:
            return json.loads(resp.read() or b"{}")

    # -- storage-format rendering -------------------------------------------

    @staticmethod
    def _table(headers, rows):
        import html
        head = "".join("<th>%s</th>" % html.escape(str(h))
                       for h in headers)
        body = "".join(
            "<tr>%s</tr>" % "".join(
                "<td>%s</td>" % html.escape(str(c)) for c in row)
            for row in rows)
        return "<table><tbody><tr>%s</tr>%s</tbody></table>" % (
            head, body)

    def render_storage(self, info):
        import html
        parts = [
            "<p>date: %s<br/>checksum: <code>%s</code><br/>"
            "epochs: %s</p>" % (html.escape(str(info["date"])),
                                html.escape(str(info["checksum"])),
                                html.escape(str(info["epochs"]))),
            "<h2>Metrics</h2>",
            self._table(("split", "value"),
                        [(s, info["metrics"].get(s))
                         for s in ("test", "validation", "train",
                                   "best")]),
            "<h2>Dataset</h2>",
            self._table(("split", "samples"),
                        [(s, info["dataset"].get(s))
                         for s in ("test", "validation", "train")]),
            "<h2>Unit run times</h2>",
            self._table(("unit", "runs", "seconds"),
                        [(u["name"], u["runs"], "%.4f" % u["time"])
                         for u in info["units"]]),
        ]
        if info.get("results"):
            parts += [
                "<h2>Results</h2>",
                "<ac:structured-macro ac:name=\"code\"><ac:plain-text-"
                "body><![CDATA[%s]]></ac:plain-text-body>"
                "</ac:structured-macro>" % json.dumps(
                    info["results"], indent=1, default=repr),
            ]
        return "".join(parts)

    # -- Confluence REST calls ----------------------------------------------

    def _find_page(self, title):
        import urllib.parse
        found = self._request(
            "GET", "/rest/api/content?spaceKey=%s&title=%s"
            "&expand=version" % (
                urllib.parse.quote(self.space),
                urllib.parse.quote(title)))
        results = found.get("results", [])
        return results[0] if results else None

    def _attach(self, page_id, filename, data):
        import urllib.parse
        boundary = "veles-tpu-attachment"
        body = (
            "--%s\r\nContent-Disposition: form-data; name=\"file\"; "
            "filename=\"%s\"\r\nContent-Type: application/octet-stream"
            "\r\n\r\n" % (boundary, filename)).encode() + data + \
            ("\r\n--%s--\r\n" % boundary).encode()
        headers = {"Content-Type":
                   "multipart/form-data; boundary=%s" % boundary,
                   "X-Atlassian-Token": "nocheck"}
        # re-publishing must version an existing attachment, not POST a
        # duplicate filename (Confluence rejects those with 400)
        existing = self._request(
            "GET", "/rest/api/content/%s/child/attachment?filename=%s"
            % (page_id, urllib.parse.quote(filename))).get("results", [])
        if existing:
            self._request(
                "POST", "/rest/api/content/%s/child/attachment/%s/data"
                % (page_id, existing[0]["id"]),
                headers=headers, body=body)
        else:
            self._request(
                "POST", "/rest/api/content/%s/child/attachment" % page_id,
                headers=headers, body=body)

    def render(self, info):
        # de-duplicate the title exactly like the reference: first free
        # "name", "name (1)", ... unless an explicit page was given
        # (then it is updated in place with a version bump)
        title = self.page
        existing = None
        if title is None:
            title = info["name"]
            index = 1
            while self._find_page(title) is not None:
                title = "%s (%d)" % (info["name"], index)
                index += 1
        else:
            existing = self._find_page(title)
        content = self.render_storage(info)
        payload = {
            "type": "page", "title": title,
            "space": {"key": self.space},
            "body": {"storage": {"value": content,
                                 "representation": "storage"}},
        }
        if self.parent_id:
            payload["ancestors"] = [{"id": self.parent_id}]
        if existing is None:
            created = self._request(
                "POST", "/rest/api/content", payload)
        else:
            payload["version"] = {
                "number": existing.get(
                    "version", {}).get("number", 1) + 1}
            created = self._request(
                "PUT", "/rest/api/content/%s" % existing["id"], payload)
        page_id = created["id"]
        self.url = "%s/pages/%s" % (self.server, page_id)
        if info.get("graph_dot"):
            self._attach(page_id, "workflow.dot",
                         info["graph_dot"].encode())
        plots_dir = info.get("plots_dir")
        if plots_dir and os.path.isdir(plots_dir):
            for fname in sorted(os.listdir(plots_dir)):
                if fname.endswith(".png"):
                    with open(os.path.join(plots_dir, fname),
                              "rb") as fin:
                        self._attach(page_id, fname, fin.read())
        self.page = title
        return self.url
