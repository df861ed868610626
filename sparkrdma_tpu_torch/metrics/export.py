"""Snapshot writers over the metrics registry.

Two dump formats plus a diff helper shared with the CLI renderer
(tools/metrics_report.py):

- :func:`to_prometheus` — Prometheus text exposition (v0.0.4): one
  ``# TYPE`` line per family, cumulative ``_bucket{le=...}`` series per
  histogram.  Note the registry's buckets use EXCLUSIVE upper bounds
  (a sample on an edge lands above it — the reference reader-stats
  placement), a hair stricter than Prometheus' inclusive ``le``.
- :func:`write_json_snapshot` — the ``registry.snapshot()`` dict as a
  JSON file; :func:`diff_snapshots` subtracts two of them so a bench
  or test can attribute deltas to one run.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

from sparkrdma_tpu_torch.metrics.registry import MetricsRegistry, get_registry


def _escape(v: object) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry as Prometheus text exposition."""
    snap = (registry or get_registry()).snapshot()
    lines = []
    seen_type = set()

    def type_line(name: str, kind: str) -> None:
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for c in snap["counters"]:
        type_line(c["name"], "counter")
        lines.append(
            f'{c["name"]}{_fmt_labels(c["labels"])} '
            f'{_fmt_value(c["value"])}'
        )
    for g in snap["gauges"]:
        type_line(g["name"], "gauge")
        lines.append(
            f'{g["name"]}{_fmt_labels(g["labels"])} '
            f'{_fmt_value(g["value"])}'
        )
    for h in snap["histograms"]:
        type_line(h["name"], "histogram")
        cum = 0
        for edge, n in zip(h["edges"], h["counts"]):
            cum += n
            lab = dict(h["labels"], le=_fmt_value(edge))
            lines.append(f'{h["name"]}_bucket{_fmt_labels(lab)} {cum}')
        lab = dict(h["labels"], le="+Inf")
        lines.append(
            f'{h["name"]}_bucket{_fmt_labels(lab)} {h["count"]}'
        )
        lines.append(
            f'{h["name"]}_sum{_fmt_labels(h["labels"])} '
            f'{_fmt_value(h["sum"])}'
        )
        lines.append(
            f'{h["name"]}_count{_fmt_labels(h["labels"])} {h["count"]}'
        )
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str,
                     registry: Optional[MetricsRegistry] = None) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


def write_json_snapshot(path: str,
                        registry: Optional[MetricsRegistry] = None) -> None:
    with open(path, "w") as f:
        json.dump((registry or get_registry()).snapshot(), f, indent=1)


def _series_key(rec: Dict) -> tuple:
    return (rec["name"], tuple(sorted(rec["labels"].items())))


def diff_snapshots(new: Dict, old: Dict) -> Dict:
    """``new - old`` over the snapshot dict shape: counter values and
    histogram counts/sums subtract (series missing from ``old`` keep
    their ``new`` value); gauges are point-in-time, so the diff keeps
    the NEW reading."""
    old_counters = {_series_key(c): c for c in old.get("counters", [])}
    old_hists = {_series_key(h): h for h in old.get("histograms", [])}
    out = {
        "ts": new.get("ts"),
        "ts_base": old.get("ts"),
        "counters": [],
        "gauges": [dict(g) for g in new.get("gauges", [])],
        "histograms": [],
    }
    for c in new.get("counters", []):
        base = old_counters.get(_series_key(c))
        out["counters"].append({
            "name": c["name"], "labels": dict(c["labels"]),
            "value": c["value"] - (base["value"] if base else 0),
        })
    for h in new.get("histograms", []):
        base = old_hists.get(_series_key(h))
        counts = list(h["counts"])
        hsum, cnt = h["sum"], h["count"]
        if base and list(base.get("edges", [])) == list(h["edges"]):
            counts = [a - b for a, b in zip(counts, base["counts"])]
            hsum -= base["sum"]
            cnt -= base["count"]
        out["histograms"].append({
            "name": h["name"], "labels": dict(h["labels"]),
            "edges": list(h["edges"]), "counts": counts,
            "sum": hsum, "count": cnt,
        })
    return out
