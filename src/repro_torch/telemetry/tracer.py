"""Structured span/event timeline with JSONL and Chrome-trace export.

Every event carries a *simulated* timestamp (seconds on the discrete-event
clock) plus two routing labels: ``pid`` — the process lane the event belongs
to (a tenant, ``"fabric"``, ``"cosim"``) — and ``tid`` — the track within it
(an EP name, a link, ``"requests"``, ``"retune"``).  Exported artifacts
never contain wall-clock time, so two seeded runs export byte-identical
traces.

Two export formats:

  * **JSONL** — one compact, key-sorted JSON object per event, in record
    order.  The grep-friendly form.
  * **Chrome trace-event JSON** — the ``{"traceEvents": [...]}`` format
    Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load
    directly.  String pids/tids are mapped to stable small integers in
    first-seen order, with ``process_name``/``thread_name`` metadata events
    emitted first, so tenants render as processes and EPs/links as named
    tracks.  Timestamps are exported in microseconds, spans as complete
    (``"ph": "X"``) events, instants as ``"ph": "i"``, counter samples
    (:meth:`SpanTracer.counter` — e.g. per-chiplet temperature) as
    ``"ph": "C"``, which Perfetto renders as a value track per counter
    name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(slots=True)
class TraceEvent:
    """One span (``dur`` set), instant (``dur`` None) or counter sample
    (``ph == "C"``) on the timeline.

    Slotted: serving hot paths construct one of these per batch and per
    completed request (they append straight to ``SpanTracer.events`` — see
    ``ServingSimulator._bind_metrics``), so construction cost is part of
    the instrumented/bare overhead ratio the selfbench floor test pins."""

    ts: float  # simulated seconds
    name: str
    cat: str
    pid: str
    tid: str
    dur: float | None = None
    args: dict | None = None
    #: explicit Chrome phase override; only ``"C"`` (counter) is used —
    #: spans and instants keep inferring their phase from ``dur``
    ph: str | None = None


class SpanTracer:
    """Append-only event log; recording order is the export order."""

    def __init__(self):
        self.events: list[TraceEvent] = []

    def span(
        self,
        name: str,
        ts: float,
        dur: float,
        *,
        cat: str = "span",
        pid: str = "sim",
        tid: str = "main",
        args: dict | None = None,
    ) -> None:
        self.events.append(TraceEvent(ts, name, cat, pid, tid, dur, args))

    def instant(
        self,
        name: str,
        ts: float,
        *,
        cat: str = "event",
        pid: str = "sim",
        tid: str = "main",
        args: dict | None = None,
    ) -> None:
        self.events.append(TraceEvent(ts, name, cat, pid, tid, None, args))

    def counter(
        self,
        name: str,
        ts: float,
        value: float,
        *,
        cat: str = "counter",
        pid: str = "sim",
        tid: str = "counters",
    ) -> None:
        """One sample of a numeric track (Chrome ``"C"`` phase).

        Perfetto groups samples by (pid, name) into a stairstep value
        track — how per-chiplet temperatures and package watts render
        alongside the request spans.
        """
        self.events.append(
            TraceEvent(ts, name, cat, pid, tid, None, {"value": value}, "C")
        )

    def __len__(self) -> int:
        return len(self.events)

    # -- exports ------------------------------------------------------------

    def to_jsonl(self) -> str:
        """One key-sorted JSON object per line, record order."""
        lines = []
        for e in self.events:
            row = {
                "ts": e.ts,
                "name": e.name,
                "cat": e.cat,
                "pid": e.pid,
                "tid": e.tid,
            }
            if e.dur is not None:
                row["dur"] = e.dur
            if e.ph is not None:
                row["ph"] = e.ph
            if e.args:
                row["args"] = e.args
            lines.append(json.dumps(row, sort_keys=True, separators=(",", ":")))
        return "\n".join(lines) + ("\n" if lines else "")

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event JSON object (Perfetto-loadable)."""
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        tid_counts: dict[str, int] = {}
        meta: list[dict] = []
        body: list[dict] = []

        def pid_of(label: str) -> int:
            p = pids.get(label)
            if p is None:
                p = pids[label] = len(pids) + 1
                meta.append(
                    {
                        "name": "process_name",
                        "ph": "M",
                        "pid": p,
                        "tid": 0,
                        "args": {"name": label},
                    }
                )
            return p

        def tid_of(pid_label: str, tid_label: str) -> int:
            key = (pid_label, tid_label)
            t = tids.get(key)
            if t is None:
                t = tids[key] = tid_counts.get(pid_label, 0) + 1
                tid_counts[pid_label] = t
                meta.append(
                    {
                        "name": "thread_name",
                        "ph": "M",
                        "pid": pid_of(pid_label),
                        "tid": t,
                        "args": {"name": tid_label},
                    }
                )
            return t

        for e in self.events:
            row = {
                "name": e.name,
                "cat": e.cat,
                "pid": pid_of(e.pid),
                "tid": tid_of(e.pid, e.tid),
                "ts": round(e.ts * 1e6, 3),
            }
            if e.ph is not None:
                row["ph"] = e.ph
            elif e.dur is None:
                row["ph"] = "i"
                row["s"] = "t"
            else:
                row["ph"] = "X"
                row["dur"] = round(e.dur * 1e6, 3)
            if e.args:
                row["args"] = e.args
            body.append(row)
        return {
            "traceEvents": meta + body,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "simulated"},
        }

    def write_jsonl(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl())
        return p

    def write_chrome(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome(), sort_keys=True, indent=1))
        return p
