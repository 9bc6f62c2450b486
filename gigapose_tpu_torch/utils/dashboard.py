"""Static HTML training dashboard (port of gigapose_tpu/utils/dashboard.py):
the reference's bokeh Plotter (src/megapose/utils/logs_bokeh.py:42-339:
load_logs over run ids, plot_train_fields / plot_eval_fields overlays,
show_configs diff) as one self-contained HTML file: inline SVG, no external
assets. Per metric a line chart overlaying the runs, a config-diff table,
and a gallery of each run's vis/ images.

A run directory is what the port's trainer writes as its log_dir
(training/loop.py -> utils/metrics.py: <save_dir>/logs/metrics.jsonl), with
an optional config.json or config.yaml beside it (read by utils/config.py's
YAML reader). Charts: categorical series colours in a fixed order (runs
past the eighth share the last colour), one y-axis per chart, 2 px lines,
a light grid, legend and end labels, a hover tooltip, a data table per
chart, light and dark schemes through CSS custom properties. Given the same
title, the page is the JAX package's byte for byte on the same run
directories.

Usage:
    python -m gigapose_tpu_torch.utils.dashboard run_dirs=<dir>[,<dir>...] \
        [out=dashboard.html] [fields=train/loss,val/matching] [max_images=12]
"""

from __future__ import annotations

import base64
import html
import json
import os
import os.path as osp
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from gigapose_tpu_torch.utils.config import load_yaml

# categorical slots (validated order, light / dark) — see repo viz standard
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767"]

_W, _H = 560, 240
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 52, 96, 14, 30


def load_run_metrics(run_dir: str) -> Dict[str, List[Tuple[float, float]]]:
    """metrics.jsonl -> {field: [(step, value), ...]} (sorted by step)."""
    path = osp.join(run_dir, "metrics.jsonl")
    out: Dict[str, List[Tuple[float, float]]] = {}
    if not osp.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:  # torn tail line from a live run
                continue
            step = rec.get("step", 0)
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, (int, float)):
                    continue
                out.setdefault(k, []).append((float(step), float(v)))
    for k in out:
        out[k].sort(key=lambda p: p[0])
    return out


def load_run_config(run_dir: str) -> Dict[str, object]:
    """Flattened dotted-key config from any yaml/json config file in the run
    dir (the runner saves one; absent files -> {})."""
    for name in ("config.yaml", "config.yml", "config.json"):
        path = osp.join(run_dir, name)
        if not osp.exists(path):
            continue
        try:
            if name.endswith(".json"):
                with open(path) as f:
                    cfg = json.load(f)
            else:
                cfg = load_yaml(path)
        except (OSError, ValueError):  # a torn or malformed file shows no config
            return {}
        return _flatten(cfg)
    return {}


def _flatten(d, prefix="") -> Dict[str, object]:
    out = {}
    if not isinstance(d, dict):
        return {prefix or "value": d}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _nice_ticks(lo: float, hi: float, n: int = 4) -> List[float]:
    if hi <= lo:
        hi = lo + 1.0
    import math

    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    step = min(s * mag for s in (1, 2, 5, 10) if s * mag >= raw)
    t0 = math.ceil(lo / step) * step
    ticks = []
    t = t0
    while t <= hi + 1e-12 * abs(hi):
        ticks.append(t)
        t += step
    return ticks


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.2e}"
    return f"{v:.4g}"


def _downsample(pts: Sequence[Tuple[float, float]], cap: int = 400):
    if len(pts) <= cap:
        return list(pts)
    stride = len(pts) / cap
    keep = [pts[int(i * stride)] for i in range(cap)]
    if keep[-1] != pts[-1]:
        keep.append(pts[-1])
    return keep


def _svg_chart(
    field: str, series: Dict[str, List[Tuple[float, float]]], chart_id: str
) -> str:
    """One metric, all runs overlaid. Returns an <figure> block."""
    pts_all = [p for pts in series.values() for p in pts]
    if not pts_all:
        return ""
    xs = [p[0] for p in pts_all]
    ys = [p[1] for p in pts_all]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y0, y1 = y0 - 0.5, y1 + 0.5
    yr = y1 - y0
    y0 -= 0.05 * yr
    y1 += 0.05 * yr
    iw = _W - _PAD_L - _PAD_R
    ih = _H - _PAD_T - _PAD_B

    def sx(x):
        return _PAD_L + (x - x0) / (x1 - x0) * iw

    def sy(y):
        return _PAD_T + (1.0 - (y - y0) / (y1 - y0)) * ih

    grid, labels = [], []
    for t in _nice_ticks(y0, y1):
        yy = sy(t)
        grid.append(
            f'<line x1="{_PAD_L}" y1="{yy:.1f}" x2="{_W - _PAD_R}" y2="{yy:.1f}" '
            f'class="grid"/>'
        )
        labels.append(
            f'<text x="{_PAD_L - 6}" y="{yy + 3.5:.1f}" class="tick" '
            f'text-anchor="end">{_fmt(t)}</text>'
        )
    for t in _nice_ticks(x0, x1):
        xx = sx(t)
        labels.append(
            f'<text x="{xx:.1f}" y="{_H - _PAD_B + 16}" class="tick" '
            f'text-anchor="middle">{_fmt(t)}</text>'
        )

    paths, endlabels, tables = [], [], []
    data_json = {}
    for i, (run, pts) in enumerate(series.items()):
        if not pts:
            continue
        slot = min(i, len(_SERIES_LIGHT) - 1)
        pts_ds = _downsample(pts)
        d = " ".join(
            f"{'M' if j == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
            for j, (x, y) in enumerate(pts_ds)
        )
        paths.append(
            f'<path d="{d}" class="s{slot}" fill="none" stroke-width="2" '
            f'stroke-linejoin="round"/>'
        )
        lx, ly = pts_ds[-1]
        if len(series) > 1 and i < 4:  # direct labels for the first few series
            endlabels.append(
                f'<text x="{sx(lx) + 5:.1f}" y="{sy(ly) + 3.5:.1f}" '
                f'class="endlabel">{html.escape(run)}</text>'
            )
        data_json[run] = pts_ds
        rows = "".join(
            f"<tr><td>{_fmt(x)}</td><td>{_fmt(y)}</td></tr>" for x, y in pts_ds
        )
        tables.append(
            f"<details><summary>{html.escape(run)} data</summary>"
            f"<table><thead><tr><th>step</th><th>{html.escape(field)}</th></tr>"
            f"</thead><tbody>{rows}</tbody></table></details>"
        )

    legend = ""
    if len(series) > 1:
        items = []
        for i, run in enumerate(series):
            slot = min(i, len(_SERIES_LIGHT) - 1)
            items.append(
                f'<span class="legend-item"><span class="swatch b{slot}"></span>'
                f"{html.escape(run)}</span>"
            )
        legend = f'<div class="legend">{"".join(items)}</div>'

    payload = html.escape(json.dumps(data_json), quote=True)
    return f"""
<figure class="chart" id="{chart_id}" data-series="{payload}"
        data-x0="{x0}" data-x1="{x1}" data-y0="{y0}" data-y1="{y1}">
<figcaption>{html.escape(field)}</figcaption>
{legend}
<svg viewBox="0 0 {_W} {_H}" role="img" aria-label="{html.escape(field)}">
{''.join(grid)}
<line x1="{_PAD_L}" y1="{_H - _PAD_B}" x2="{_W - _PAD_R}" y2="{_H - _PAD_B}" class="axis"/>
{''.join(labels)}
{''.join(paths)}
{''.join(endlabels)}
<line class="cross" x1="0" y1="{_PAD_T}" x2="0" y2="{_H - _PAD_B}" style="display:none"/>
</svg>
<div class="tooltip" style="display:none"></div>
{''.join(tables)}
</figure>"""


_CSS = f"""
:root {{ color-scheme: light dark; }}
body {{
  margin: 24px; font: 14px/1.45 system-ui, sans-serif;
  background: var(--surface-1); color: var(--text-primary);
  --surface-1: #fcfcfb; --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e8e7e4; --axis: #b5b4b0;
  {'; '.join(f'--s{i}: {c}' for i, c in enumerate(_SERIES_LIGHT))};
}}
@media (prefers-color-scheme: dark) {{
  body {{
    --surface-1: #1a1a19; --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #33332f; --axis: #55544f;
    {'; '.join(f'--s{i}: {c}' for i, c in enumerate(_SERIES_DARK))};
  }}
}}
h1 {{ font-size: 20px; }} h2 {{ font-size: 16px; margin-top: 28px; }}
.charts {{ display: flex; flex-wrap: wrap; gap: 18px; }}
figure.chart {{ margin: 0; position: relative; width: {_W}px; }}
figcaption {{ font-weight: 600; margin-bottom: 2px; }}
svg {{ width: 100%; height: auto; display: block; }}
.grid {{ stroke: var(--grid); stroke-width: 1; }}
.axis {{ stroke: var(--axis); stroke-width: 1; }}
.cross {{ stroke: var(--axis); stroke-width: 1; stroke-dasharray: 3 3; }}
.tick, .endlabel {{ font: 11px system-ui, sans-serif; fill: var(--text-secondary); }}
.endlabel {{ fill: var(--text-primary); }}
{chr(10).join(f'.s{i} {{ stroke: var(--s{i}); }} .b{i} {{ background: var(--s{i}); }}' for i in range(len(_SERIES_LIGHT)))}
.legend {{ display: flex; gap: 14px; flex-wrap: wrap; margin: 2px 0 4px; }}
.legend-item {{ display: inline-flex; align-items: center; gap: 5px;
  color: var(--text-secondary); font-size: 12px; }}
.swatch {{ width: 10px; height: 10px; border-radius: 2px; display: inline-block; }}
.tooltip {{ position: absolute; pointer-events: none; background: var(--surface-1);
  border: 1px solid var(--axis); border-radius: 4px; padding: 4px 7px;
  font-size: 12px; color: var(--text-primary); white-space: nowrap; z-index: 2; }}
details {{ font-size: 12px; color: var(--text-secondary); }}
table {{ border-collapse: collapse; max-height: 200px; display: block;
  overflow-y: auto; }}
td, th {{ padding: 1px 10px 1px 0; text-align: left; }}
.gallery {{ display: flex; flex-wrap: wrap; gap: 10px; }}
.gallery figure {{ margin: 0; width: 260px; }}
.gallery img {{ width: 100%; border: 1px solid var(--grid); border-radius: 4px; }}
.gallery figcaption {{ font-size: 11px; color: var(--text-secondary);
  font-weight: 400; }}
.cfg td, .cfg th {{ border-bottom: 1px solid var(--grid); padding: 3px 12px 3px 0; }}
"""

_JS = """
document.querySelectorAll('figure.chart').forEach(fig => {
  const svg = fig.querySelector('svg');
  const cross = fig.querySelector('.cross');
  const tip = fig.querySelector('.tooltip');
  const series = JSON.parse(fig.dataset.series);
  const x0 = +fig.dataset.x0, x1 = +fig.dataset.x1;
  const PADL = %d, PADR = %d, W = %d;
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect();
    const fx = (ev.clientX - r.left) / r.width * W;
    if (fx < PADL || fx > W - PADR) { cross.style.display = 'none';
      tip.style.display = 'none'; return; }
    const x = x0 + (fx - PADL) / (W - PADL - PADR) * (x1 - x0);
    cross.setAttribute('x1', fx); cross.setAttribute('x2', fx);
    cross.style.display = '';
    let rows = [];
    for (const [run, pts] of Object.entries(series)) {
      let best = pts[0];
      for (const p of pts) if (Math.abs(p[0]-x) < Math.abs(best[0]-x)) best = p;
      rows.push(run + ': ' + best[1].toPrecision(4) + ' @ ' + best[0]);
    }
    tip.textContent = rows.join('  |  ');
    tip.style.left = Math.min(ev.clientX - r.left + 12, r.width - 160) + 'px';
    tip.style.top = (ev.clientY - r.top + 14) + 'px';
    tip.style.display = '';
  });
  svg.addEventListener('mouseleave', () => {
    cross.style.display = 'none'; tip.style.display = 'none';
  });
});
""" % (_PAD_L, _PAD_R, _W)


def build_dashboard(
    run_dirs: Dict[str, str],
    out_html: str,
    fields: Optional[Sequence[str]] = None,
    max_images: int = 12,
    title: str = "gigapose_tpu_torch runs",
) -> str:
    """Render {run_name: log_dir} into one self-contained HTML file. Returns
    the output path. Mirrors logs_bokeh.Plotter: metric overlays (train +
    eval fields), config diff, image gallery."""
    metrics = {name: load_run_metrics(d) for name, d in run_dirs.items()}
    configs = {name: load_run_config(d) for name, d in run_dirs.items()}

    all_fields = sorted({f for m in metrics.values() for f in m})
    if fields:
        all_fields = [f for f in all_fields if f in set(fields)]

    charts = []
    for i, field in enumerate(all_fields):
        series = {
            name: m[field] for name, m in metrics.items() if field in m
        }
        charts.append(_svg_chart(field, series, f"chart{i}"))

    # config diff table (keys whose values differ across runs; all keys when
    # there is a single run) — logs_bokeh.show_configs(diff=True)
    cfg_html = ""
    nonempty = {n: c for n, c in configs.items() if c}
    if nonempty:
        keys = sorted({k for c in nonempty.values() for k in c})
        if len(nonempty) > 1:
            keys = [
                k
                for k in keys
                if len({json.dumps(c.get(k), default=str) for c in nonempty.values()}) > 1
            ]
        if keys:
            head = "".join(f"<th>{html.escape(n)}</th>" for n in nonempty)
            rows = "".join(
                "<tr><td>{}</td>{}</tr>".format(
                    html.escape(k),
                    "".join(
                        f"<td>{html.escape(str(c.get(k, '—')))}</td>"
                        for c in nonempty.values()
                    ),
                )
                for k in keys
            )
            cfg_html = (
                "<h2>Config diff</h2><table class='cfg'><thead>"
                f"<tr><th>key</th>{head}</tr></thead><tbody>{rows}</tbody></table>"
            )

    gallery = []
    for name, d in run_dirs.items():
        vis = osp.join(d, "vis")
        if not osp.isdir(vis):
            continue
        pngs = sorted(
            (f for f in os.listdir(vis) if f.endswith(".png")),
            key=lambda f: osp.getmtime(osp.join(vis, f)),
            reverse=True,
        )[:max_images]
        for f in pngs:
            with open(osp.join(vis, f), "rb") as fh:
                b64 = base64.b64encode(fh.read()).decode()
            gallery.append(
                f'<figure><img src="data:image/png;base64,{b64}" '
                f'alt="{html.escape(f)}"/>'
                f"<figcaption>{html.escape(name)} / {html.escape(f)}"
                f"</figcaption></figure>"
            )
    gallery_html = (
        f'<h2>Images</h2><div class="gallery">{"".join(gallery)}</div>'
        if gallery
        else ""
    )

    doc = f"""<!doctype html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>{_CSS}</style></head>
<body>
<h1>{html.escape(title)}</h1>
<p style="color: var(--text-secondary)">runs: {html.escape(', '.join(run_dirs))}</p>
<div class="charts">{''.join(charts)}</div>
{cfg_html}
{gallery_html}
<script>{_JS}</script>
</body></html>"""
    os.makedirs(osp.dirname(osp.abspath(out_html)), exist_ok=True)
    with open(out_html, "w") as f:
        f.write(doc)
    return out_html


def main(argv=None):
    kv = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    dirs = kv["run_dirs"].split(",")
    run_dirs = {osp.basename(osp.normpath(d)) or d: d for d in dirs}
    out = build_dashboard(
        run_dirs,
        kv.get("out", "dashboard.html"),
        fields=kv["fields"].split(",") if "fields" in kv else None,
        max_images=int(kv.get("max_images", 12)),
    )
    print(out)


if __name__ == "__main__":
    main()
