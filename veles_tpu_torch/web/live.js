/* Live session view: polls the web-status JSON endpoints and renders
 * an auto-updating multi-series metric chart plus the post/event
 * tables.  Plain ES5-ish DOM code, no dependencies: the port's copy of
 * veles_tpu/web/live.js, the equivalent of the reference's web/ status
 * frontend (ref web/, ~2.9k LoC JS; this client covers its live-status
 * role against the /session/<sid>.json and /events/<sid>.json API).
 *
 * Chart rules (dataviz method): line form for change-over-time; at
 * most 4 categorical series in fixed order (validated palette, CSS
 * vars --series-1..4); legend + last-value direct labels; recessive
 * grid; crosshair + tooltip on hover; the posts table below is the
 * table view of the same data.
 */
(function () {
  "use strict";
  var sid = document.body.getAttribute("data-sid");
  if (!sid) return;
  var POLL_MS = 3000;
  var MAX_SERIES = 4;
  var chartBox = document.getElementById("chart");
  var lastStamp = null;

  function seriesColor(i) {
    return "var(--series-" + (i + 1) + ")";
  }

  // decision.epoch_metrics posts are [test, validation, train]
  var LIST_NAMES = ["test", "validation", "train"];

  function numeric(v) {
    return typeof v === "number" && isFinite(v);
  }

  function extractSeries(history) {
    // {key -> {name, points: [{x, y, t}]}} in first-seen order
    var order = [], byKey = {};
    history.forEach(function (post, idx) {
      var m = post.metrics;
      var entries = [];
      if (Array.isArray(m)) {
        m.forEach(function (v, i) {
          entries.push(["#" + i, LIST_NAMES[i] || "series " + i, v]);
        });
      } else if (m && typeof m === "object") {
        Object.keys(m).forEach(function (k) {
          entries.push([k, k, m[k]]);
        });
      }
      entries.forEach(function (e) {
        if (!numeric(e[2])) return;
        if (!byKey[e[0]]) {
          byKey[e[0]] = { name: e[1], points: [] };
          order.push(e[0]);
        }
        byKey[e[0]].points.push(
          { x: idx, y: e[2], t: post.updated || "" });
      });
    });
    return order.slice(0, MAX_SERIES).map(function (k) {
      return byKey[k];
    });
  }

  function fmt(v) {
    return Math.abs(v) >= 1000 ? v.toFixed(0) : v.toPrecision(4);
  }

  function esc(v) {
    var d = document.createElement("div");
    d.textContent = v == null ? "" : String(v);
    return d.innerHTML;
  }

  function el(tag, attrs) {
    var node = document.createElementNS(
      "http://www.w3.org/2000/svg", tag);
    Object.keys(attrs || {}).forEach(function (k) {
      node.setAttribute(k, attrs[k]);
    });
    return node;
  }

  function drawChart(series, nPosts) {
    var W = 560, H = 200, padL = 8, padR = 60, padY = 14;
    var svg = el("svg", { width: W, height: H, "class": "chart",
                          role: "img" });
    var lo = Infinity, hi = -Infinity;
    series.forEach(function (s) {
      s.points.forEach(function (p) {
        if (p.y < lo) lo = p.y;
        if (p.y > hi) hi = p.y;
      });
    });
    if (!isFinite(lo)) return svg;
    if (hi === lo) { hi += 1; lo -= 1; }
    var plotW = W - padL - padR, plotH = H - 2 * padY;
    var X = function (x) {
      return padL + plotW * (nPosts > 1 ? x / (nPosts - 1) : 0.5);
    };
    var Y = function (y) {
      return padY + plotH * (1 - (y - lo) / (hi - lo));
    };
    // recessive grid: 3 horizontal lines + min/max text labels
    [lo, (lo + hi) / 2, hi].forEach(function (gy) {
      svg.appendChild(el("line", { x1: padL, x2: padL + plotW,
                                   y1: Y(gy), y2: Y(gy),
                                   "class": "grid" }));
      var t = el("text", { x: padL + plotW + 4, y: Y(gy) + 4,
                           "class": "axis" });
      t.textContent = fmt(gy);
      svg.appendChild(t);
    });
    series.forEach(function (s, i) {
      var d = s.points.map(function (p, j) {
        return (j ? "L" : "M") + X(p.x).toFixed(1) + " " +
               Y(p.y).toFixed(1);
      }).join(" ");
      var path = el("path", { d: d, fill: "none",
                              stroke: seriesColor(i),
                              "stroke-width": 2 });
      svg.appendChild(path);
      var last = s.points[s.points.length - 1];
      if (last) {
        var lbl = el("text", { x: X(last.x) + 4,
                               y: Y(last.y) - 4, "class": "axis" });
        lbl.textContent = fmt(last.y);
        svg.appendChild(lbl);
      }
    });
    // crosshair + shared tooltip (nearest post index)
    var cross = el("line", { y1: padY, y2: padY + plotH,
                             "class": "cross", visibility: "hidden" });
    svg.appendChild(cross);
    var tipBox = document.getElementById("tip");
    svg.addEventListener("mousemove", function (ev) {
      var rect = svg.getBoundingClientRect();
      var frac = (ev.clientX - rect.left - padL) / plotW;
      var idx = Math.max(0, Math.min(nPosts - 1,
        Math.round(frac * (nPosts - 1))));
      cross.setAttribute("x1", X(idx));
      cross.setAttribute("x2", X(idx));
      cross.setAttribute("visibility", "visible");
      var lines = [];
      series.forEach(function (s, i) {
        s.points.forEach(function (p) {
          // esc(): metric keys / timestamps come from unauthenticated
          // POST /update — never raw into innerHTML
          if (p.x === idx) {
            lines.push("<span class='swatch' style='background:" +
                       seriesColor(i) + "'></span>" + esc(s.name) +
                       ": " + fmt(p.y) +
                       (p.t ? " <small>(" + esc(p.t) + ")</small>"
                            : ""));
          }
        });
      });
      tipBox.innerHTML = lines.join("<br>");
      tipBox.style.visibility = lines.length ? "visible" : "hidden";
    });
    svg.addEventListener("mouseleave", function () {
      cross.setAttribute("visibility", "hidden");
      tipBox.style.visibility = "hidden";
    });
    return svg;
  }

  function legend(series) {
    if (series.length < 2) return null;  // one series: title names it
    var box = document.createElement("div");
    box.className = "legend";
    series.forEach(function (s, i) {
      var item = document.createElement("span");
      item.innerHTML = "<span class='swatch' style='background:" +
        seriesColor(i) + "'></span>" + esc(s.name);
      box.appendChild(item);
    });
    return box;
  }

  function renderTables(history, events) {
    var rows = history.slice(-100).map(function (p) {
      return "<tr><td>" + esc(p.updated) + "</td><td class='num'>" +
        esc(p.epoch) + "</td><td>" + esc(JSON.stringify(p.metrics)) +
        "</td><td class='num'>" + esc(p.slaves) + "</td></tr>";
    }).join("");
    document.getElementById("posts").innerHTML =
      "<tr><th>time</th><th>epoch</th><th>metrics</th><th>slaves</th>" +
      "</tr>" + rows;
    var evRows = events.slice(-100).map(function (e) {
      return "<tr><td>" + esc(e[0]) + "</td><td>" + esc(e[1]) +
        "</td></tr>";
    }).join("");
    document.getElementById("events").innerHTML =
      "<tr><th>time</th><th>event</th></tr>" + evRows;
  }

  function refresh() {
    if (document.hidden) return;
    Promise.all([
      fetch("/session/" + encodeURIComponent(sid) + ".json")
        .then(function (r) { return r.json(); }),
      fetch("/events/" + encodeURIComponent(sid) + ".json")
        .then(function (r) { return r.json(); })
    ]).then(function (res) {
      var history = res[0], events = res[1];
      var stamp = history.length && JSON.stringify(
        history[history.length - 1]);
      if (stamp === lastStamp) return;
      lastStamp = stamp;
      var series = extractSeries(history);
      chartBox.innerHTML = "";
      var lg = legend(series);
      if (lg) chartBox.appendChild(lg);
      chartBox.appendChild(drawChart(series, history.length));
      renderTables(history, events);
    }).catch(function () { /* server gone; keep last view */ });
  }

  refresh();
  setInterval(refresh, POLL_MS);
})();
