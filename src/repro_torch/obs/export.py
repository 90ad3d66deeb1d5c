"""Trace export and comparison (§12): Chrome trace-event / Perfetto JSON,
structural validation, summary tables, and the real-vs-sim timeline diff.

The export maps the shared span schema onto the Chrome trace-event format
(loadable in ``chrome://tracing`` and https://ui.perfetto.dev): each track
(``real`` / ``sim``) becomes a process, each worker/channel a thread,
durational spans become complete (``"ph": "X"``) events, catalog
admit/release become instants, and ``catalog.bytes`` samples become counter
(``"ph": "C"``) events — the Memory Catalog occupancy timeline renders as a
graph under each process. Span keys (mv, partition, round, nbytes) ride in
``args``. Each track's timestamps are rebased to start at zero so a real
run and its simulation overlay directly.

``validate_chrome_trace`` is the CI gate: well-formed events, non-negative
timestamps/durations, and every keyed event nested inside its round's frame
span. ``diff_tracks`` aligns the two tracks per (mv, partition, round) task
and reports modeled-vs-measured duration — the quickest read on cost-model
drift before reaching for the full ``obs.audit`` report.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, Sequence

from .trace import Span

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "summarize",
    "overlay_timelines",
    "diff_tracks",
]

_US = 1e6  # trace-event timestamps are microseconds


def to_chrome_trace(spans: Sequence[Span]) -> dict[str, Any]:
    """Render spans as a Chrome trace-event document (one process per
    track, one thread per worker, counters for occupancy samples)."""
    tracks = sorted({s.track for s in spans})
    pid_of = {t: i + 1 for i, t in enumerate(tracks)}
    base_ts = {
        t: min((s.ts for s in spans if s.track == t), default=0.0)
        for t in tracks
    }
    tid_of: dict[tuple[str, str], int] = {}
    events: list[dict[str, Any]] = []
    for t in tracks:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid_of[t], "tid": 0,
            "args": {"name": f"sc-{t}"},
        })

    def tid(track: str, worker: str) -> int:
        key = (track, worker)
        if key not in tid_of:
            tid_of[key] = len([k for k in tid_of if k[0] == track]) + 1
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid_of[track],
                "tid": tid_of[key], "args": {"name": worker},
            })
        return tid_of[key]

    for s in spans:
        pid = pid_of[s.track]
        ts = (s.ts - base_ts[s.track]) * _US
        args = {
            "mv": s.mv, "partition": s.partition, "round": s.round,
            "nbytes": s.nbytes,
        }
        if s.cat == "counter":
            events.append({
                "name": s.name, "ph": "C", "pid": pid, "tid": 0,
                "ts": ts, "args": {"bytes": s.value},
            })
        elif s.dur == 0.0 and s.cat in ("admit", "release"):
            events.append({
                "name": f"{s.cat}:{s.name}", "cat": s.cat, "ph": "i",
                "pid": pid, "tid": tid(s.track, s.worker), "ts": ts,
                "s": "t", "args": args,
            })
        else:
            events.append({
                "name": f"{s.cat}:{s.name}", "cat": s.cat, "ph": "X",
                "pid": pid, "tid": tid(s.track, s.worker), "ts": ts,
                "dur": s.dur * _US, "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str | Path, spans: Sequence[Span]) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(to_chrome_trace(spans)))
    return p


def validate_chrome_trace(doc: dict[str, Any]) -> list[str]:
    """Structural checks on an exported trace document; returns the list of
    problems (empty = valid). Checked: the event array exists, every event
    has name/ph/pid, timed events have non-negative ts and dur, and every
    keyed (args.round >= 0) X/i event lies within its (pid, round) frame
    span — 'spans nest within rounds'."""
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    frames: dict[tuple[int, int], tuple[float, float]] = {}
    for e in events:
        for field in ("name", "ph", "pid"):
            if field not in e:
                problems.append(f"event missing {field!r}: {e}")
        if e.get("ph") in ("X", "i", "C"):
            ts = e.get("ts", -1.0)
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"negative/missing ts: {e.get('name')}")
        if e.get("ph") == "X":
            dur = e.get("dur", -1.0)
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"negative/missing dur: {e.get('name')}")
            if e.get("cat") == "round":
                key = (e["pid"], e.get("args", {}).get("round", -1))
                frames[key] = (e["ts"], e["ts"] + e["dur"])
    eps = 1.0  # µs of clock skew tolerated at frame edges
    for e in events:
        if e.get("ph") not in ("X", "i") or e.get("cat") in ("round", None):
            continue
        r = e.get("args", {}).get("round", -1)
        if r < 0:
            continue
        frame = frames.get((e.get("pid"), r))
        if frame is None:
            problems.append(
                f"{e.get('name')}: no round frame {r} on pid {e.get('pid')}"
            )
            continue
        lo, hi = frame
        end = e["ts"] + e.get("dur", 0.0)
        if e["ts"] < lo - eps or end > hi + eps:
            problems.append(
                f"{e.get('name')}: [{e['ts']:.1f}, {end:.1f}]µs outside "
                f"round {r} frame [{lo:.1f}, {hi:.1f}]µs"
            )
    return problems


def summarize(spans: Iterable[Span]) -> dict[str, dict[str, float]]:
    """Per-(track, category) totals: span count, total seconds, total bytes."""
    out: dict[str, dict[str, float]] = {}
    for s in spans:
        key = f"{s.track}/{s.cat}"
        agg = out.setdefault(key, {"count": 0, "seconds": 0.0, "bytes": 0.0})
        agg["count"] += 1
        agg["seconds"] += s.dur
        agg["bytes"] += s.nbytes
    return out


def overlay_timelines(
    real: Sequence[tuple[str, float, float]],
    sim: Sequence[tuple[str, float, float]],
) -> list[dict[str, Any]]:
    """Align a real ``RunReport.timeline`` with a ``SimReport.timeline`` by
    node name (both are ``(name, start, end)`` triples): one row per node
    present in either, with per-side start/duration and the sim/real
    duration ratio (None when a side is missing)."""
    rmap = {name: (s, e) for name, s, e in real}
    smap = {name: (s, e) for name, s, e in sim}
    rows = []
    for name in sorted(set(rmap) | set(smap)):
        rr, ss = rmap.get(name), smap.get(name)
        rdur = (rr[1] - rr[0]) if rr else None
        sdur = (ss[1] - ss[0]) if ss else None
        rows.append({
            "node": name,
            "real_start": rr[0] if rr else None,
            "real_dur": rdur,
            "sim_start": ss[0] if ss else None,
            "sim_dur": sdur,
            "sim_over_real": (sdur / rdur) if rr and ss and rdur else None,
        })
    return rows


def diff_tracks(
    spans: Sequence[Span], cat: str = "task"
) -> list[dict[str, Any]]:
    """Real-vs-sim duration comparison per (mv, partition, round) for one
    span category (default: whole-node ``task`` spans). Durations on each
    side are summed — a partitioned MV refreshed across workers contributes
    all its task spans."""
    sides: dict[str, dict[tuple[str, int, int], float]] = {"real": {}, "sim": {}}
    for s in spans:
        if s.cat != cat or s.track not in sides:
            continue
        key = (s.mv, s.partition, s.round)
        sides[s.track][key] = sides[s.track].get(key, 0.0) + s.dur
    rows = []
    for key in sorted(set(sides["real"]) | set(sides["sim"])):
        mv, part, rnd = key
        rdur = sides["real"].get(key)
        sdur = sides["sim"].get(key)
        rows.append({
            "mv": mv, "partition": part, "round": rnd,
            "real_s": rdur, "sim_s": sdur,
            "sim_over_real": (sdur / rdur) if rdur and sdur is not None else None,
        })
    return rows
