"""Fleet-wide observability collection: per-process dump + merge.

Multi-process runs (the simfleet harness, the test cluster fixtures)
each write ONE flight-recorder dump at teardown via
:func:`write_dump`; :func:`merge_dumps` folds any number of per-process
dumps into one merged document whose events carry their origin
``pid``/``host`` — the input ``tools/trace_report.py`` renders as a
single cross-process waterfall (requester and server spans of one
``trace_id`` interleaved on the shared epoch clock).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from sparkrdma_tpu_torch.obs.recorder import RECORDER


def write_dump(path: str, reason: str = "collect") -> Optional[str]:
    """Dump THIS process's recorder to ``path`` (fixture teardown /
    simfleet close hook).  None when the recorder is off."""
    if not RECORDER.enabled:
        return None
    return RECORDER.dump(reason, path=path)


def load_dump(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge_dumps(paths: Sequence[str]) -> dict:
    """Fold per-process dumps into one merged trace document."""
    processes: List[dict] = []
    for p in sorted(paths):
        processes.append(load_dump(p))
    return {"merged": True, "processes": processes}


def merged_events(doc: dict) -> List[dict]:
    """Flatten a dump or merged document into one time-sorted event
    list; each event dict carries t / plane / name / fields / pid /
    host.  This is the normal form trace_report renders from."""
    procs = doc["processes"] if doc.get("merged") else [doc]
    out: List[dict] = []
    for proc in procs:
        pid, host = proc.get("pid"), proc.get("host")
        for plane, rec in proc.get("planes", {}).items():
            for t, name, fields in rec.get("events", []):
                out.append({
                    "t": t, "plane": plane, "name": name,
                    "fields": fields or {}, "pid": pid, "host": host,
                })
    out.sort(key=lambda e: e["t"])
    return out
