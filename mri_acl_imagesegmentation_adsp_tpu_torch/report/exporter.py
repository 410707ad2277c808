"""Run report exporter.

The port's own copy of ``mri_acl_imagesegmentation_adsp_tpu/report/
exporter.py`` (``export_run_report``, ``main``): it aggregates a run
directory's ``summary.json``, ``history.json``, ``args.json`` and
``samples/*.png`` into one self-contained ``report.html`` and a compact
``report_metrics.json``, byte for byte what the JAX package writes for the
same directory.

  python -m mri_acl_imagesegmentation_adsp_tpu_torch.report.exporter \
      --run-dir runs/unet2d [--out report.html]
"""

from __future__ import annotations

import argparse
import base64
import json
from pathlib import Path
from typing import Dict, List, Optional


def _svg_curve(history: List[dict], keys: List[str], title: str,
               w: int = 460, h: int = 220) -> str:
    """Tiny dependency-free SVG line chart of per-epoch series."""
    if not history:
        return ""
    pad = 34
    colors = ["#2563eb", "#dc2626", "#059669", "#d97706"]
    series = {k: [float(row[k]) for row in history] for k in keys
              if k in history[0]}
    if not series:
        return ""
    all_vals = [v for vs in series.values() for v in vs]
    lo, hi = min(all_vals), max(all_vals)
    if hi - lo < 1e-12:
        hi = lo + 1.0
    n = len(history)

    def sx(i):
        return pad + (w - 2 * pad) * (i / max(1, n - 1))

    def sy(v):
        return h - pad - (h - 2 * pad) * ((v - lo) / (hi - lo))

    parts = [f'<svg width="{w}" height="{h}" '
             f'xmlns="http://www.w3.org/2000/svg">',
             f'<text x="{w//2}" y="16" text-anchor="middle" '
             f'font-size="13" font-family="sans-serif">{title}</text>',
             f'<line x1="{pad}" y1="{h-pad}" x2="{w-pad}" y2="{h-pad}" '
             'stroke="#888"/>',
             f'<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h-pad}" '
             'stroke="#888"/>',
             f'<text x="{pad-4}" y="{h-pad}" text-anchor="end" '
             f'font-size="10" font-family="sans-serif">{lo:.3g}</text>',
             f'<text x="{pad-4}" y="{pad+4}" text-anchor="end" '
             f'font-size="10" font-family="sans-serif">{hi:.3g}</text>']
    for ci, (k, vs) in enumerate(series.items()):
        pts = " ".join(f"{sx(i):.1f},{sy(v):.1f}" for i, v in enumerate(vs))
        c = colors[ci % len(colors)]
        parts.append(f'<polyline points="{pts}" fill="none" stroke="{c}" '
                     'stroke-width="1.5"/>')
        parts.append(f'<text x="{w-pad}" y="{pad + 14*ci}" text-anchor="end" '
                     f'font-size="11" fill="{c}" '
                     f'font-family="sans-serif">{k}</text>')
    parts.append("</svg>")
    return "".join(parts)


def export_run_report(run_dir: str, out_path: Optional[str] = None) -> str:
    """Build <run_dir>/report.html (+ report_metrics.json). Returns path."""
    run = Path(run_dir)
    out = Path(out_path) if out_path else run / "report.html"

    summary: Dict = {}
    history: List[dict] = []
    args_cfg: Dict = {}
    if (run / "summary.json").exists():
        summary = json.loads((run / "summary.json").read_text())
    if (run / "history.json").exists():
        history = json.loads((run / "history.json").read_text())
    if (run / "args.json").exists():
        args_cfg = json.loads((run / "args.json").read_text())

    html = ["<!doctype html><html><head><meta charset='utf-8'>",
            f"<title>Run report: {run.name}</title>",
            "<style>body{font-family:sans-serif;margin:24px;max-width:1100px}"
            "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
            "padding:4px 10px;font-size:13px}code{background:#f5f5f5;"
            "padding:1px 4px}img{max-width:100%}</style></head><body>",
            f"<h1>Run report: <code>{run.name}</code></h1>"]

    if summary.get("best"):
        b = summary["best"]
        html.append("<h2>Best epoch</h2><table><tr>"
                    + "".join(f"<th>{k}</th>" for k in b) + "</tr><tr>"
                    + "".join(f"<td>{v:.5g}</td>" if isinstance(v, float)
                              else f"<td>{v}</td>" for v in b.values())
                    + "</tr></table>")

    if history:
        html.append("<h2>Curves</h2>")
        html.append(_svg_curve(history, ["train_loss", "val_loss"], "loss"))
        html.append(_svg_curve(history, ["val_dice", "val_iou"], "metrics"))
        html.append(_svg_curve(history, ["lr"], "learning rate"))

    if args_cfg:
        html.append("<h2>Config</h2><table>")
        for k, v in args_cfg.items():
            html.append(f"<tr><th>{k}</th><td><code>{v}</code></td></tr>")
        html.append("</table>")

    samples = sorted((run / "samples").glob("*.png")) if (
        run / "samples").is_dir() else []
    if samples:
        html.append("<h2>Samples (Input | GT | Pred | Overlay)</h2>")
        for s in samples[:6]:
            b64 = base64.b64encode(s.read_bytes()).decode()
            html.append(f"<div><code>{s.name}</code><br>"
                        f"<img src='data:image/png;base64,{b64}'></div>")

    html.append("</body></html>")
    out.write_text("".join(html), encoding="utf-8")

    metrics = {"run": str(run), "best": summary.get("best", {}),
               "final": summary.get("final", {}),
               "epochs": len(history)}
    (out.parent / "report_metrics.json").write_text(
        json.dumps(metrics, indent=2), encoding="utf-8")
    return str(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("Export a run report")
    p.add_argument("--run-dir", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    path = export_run_report(args.run_dir, args.out)
    print(f"[report] wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
