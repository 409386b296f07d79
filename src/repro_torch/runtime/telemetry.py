"""Serving observability (port of ``repro.runtime.telemetry``): request
lifecycle tracing, metrics snapshots and quantization-health telemetry.

Three independent collectors, bundled by :class:`ServeTelemetry` and
threaded through the scheduler as one optional handle (``telemetry=None``
keeps every hot-loop call site a no-op):

- :class:`Tracer` — lifecycle events (enqueue, admit, prefix-hit, chunk,
  decode-batch, block grow, copy-on-write, preempt, swap, resume,
  radix-evict, retire) with the scheduler's step index and a host-clock
  timestamp, exported as Chrome-trace-event JSON (Perfetto loads it).
  Phases (admit / chunk / decode / swap) are duration events on a "steps"
  track; each request becomes a span on its lane's track. Per-phase
  step-latency histograms (p50 / p95 / p99) come with it. Phase times are
  host time: the admit, chunk and decode phases end in the greedy
  readback, so they cover the device work; swap-in copies without
  blocking, so its phase covers the dispatch only.
- :class:`MetricsLogger` — periodic gauge snapshots (queue depth, resident
  lanes, free / evictable blocks, refcounts, prefix hit rate, preemptions)
  as JSON lines, and the latest one as Prometheus text.
- :class:`QuantHealth` — host-side aggregation of the
  ``[n_clipped, n_total, amax, cal_range]`` site vectors that steps built
  with ``quant_telemetry=True`` return (``runtime.steps``), keyed
  ``{layer}/site``, plus the distribution of the quantized KV cache's
  scales.

Recording an event appends to a list; span assembly, percentiles and
serialization happen once, at export.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, TextIO, Tuple

import numpy as np

from repro_torch.models.attention import PagedQuantKVCache, QuantKVCache

# Event names. Phase events carry a duration; the rest are instants on the
# emitting request's lane track.
PHASES = ("admit", "chunk", "decode_batch", "swap_out", "swap_in")
EVENTS = ("enqueue", "admit", "prefix_hit", "chunk", "decode_batch",
          "block_grow", "cow", "preempt", "swap_out", "drop", "resume",
          "radix_evict", "retire")


@dataclasses.dataclass
class TraceEvent:
    """One lifecycle event. ``ts`` is seconds since the tracer started
    (exported as µs); ``step`` is the scheduler's step index."""
    name: str
    step: int
    ts: float
    rid: Optional[int] = None      # request id, when request-scoped
    lane: Optional[int] = None     # decode lane, when resident
    dur: float = 0.0               # seconds; > 0 only for phase events
    args: Optional[Dict[str, Any]] = None


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"n": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, dtype=np.float64)
    p50, p95, p99 = np.percentile(a, [50, 95, 99])
    return {"n": int(a.size), "p50": float(p50), "p95": float(p95),
            "p99": float(p99), "mean": float(a.mean()),
            "max": float(a.max())}


class Tracer:
    """Lifecycle event recorder with Chrome-trace export: :meth:`event`
    records an instant, :meth:`phase` times a model call. The scheduler
    holds no tracer when tracing is off."""

    def __init__(self) -> None:
        self.events: List[TraceEvent] = []
        self._t0 = time.perf_counter()
        self._phase_s: Dict[str, List[float]] = {p: [] for p in PHASES}

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def event(self, name: str, step: int, *, rid: Optional[int] = None,
              lane: Optional[int] = None, **args: Any) -> None:
        self.events.append(TraceEvent(name, step, self.now(), rid=rid,
                                      lane=lane, args=args or None))

    def phase(self, name: str, step: int) -> "_PhaseTimer":
        return _PhaseTimer(self, name, step)

    def _end_phase(self, name: str, step: int, t_start: float,
                   dur: float, args: Optional[Dict[str, Any]]) -> None:
        self.events.append(TraceEvent(name, step, t_start, dur=dur,
                                      args=args))
        self._phase_s.setdefault(name, []).append(dur)

    def latency_histograms(self) -> Dict[str, Dict[str, float]]:
        """Per-phase step-latency percentiles, in milliseconds."""
        return {p: _percentiles([s * 1e3 for s in xs])
                for p, xs in self._phase_s.items() if xs}

    def request_spans(self) -> Dict[int, Dict[str, Any]]:
        """Per-request lifecycles rebuilt from the events: {rid:
        {enqueue_ts, admits, lanes, preempts, resumes, retire_ts,
        retired}}, what the tests reconcile with ``ServeStats``."""
        spans: Dict[int, Dict[str, Any]] = {}
        for e in self.events:
            if e.rid is None:
                continue
            r = spans.setdefault(e.rid, {
                "enqueue_ts": None, "admits": [], "lanes": [],
                "preempts": 0, "resumes": 0, "retire_ts": None,
                "retired": False})
            if e.name == "enqueue":
                r["enqueue_ts"] = e.ts
            elif e.name in ("admit", "resume"):
                r["admits"].append((e.ts, e.lane))
                if e.lane is not None and e.lane not in r["lanes"]:
                    r["lanes"].append(e.lane)
                if e.name == "resume":
                    r["resumes"] += 1
            elif e.name == "preempt":
                r["preempts"] += 1
            elif e.name == "retire":
                r["retire_ts"] = e.ts
                r["retired"] = True
        return spans

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace event format (µs timestamps). pid 1 / tid 0 is the
        scheduler's "steps" track with the phase durations; decode lane i
        is tid i + 1, with one span per residency of a request (admit or
        resume to preempt or retire) and the request-scoped instants."""
        out: List[Dict[str, Any]] = [
            {"name": "process_name", "ph": "M", "pid": 1,
             "args": {"name": "serve"}},
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "steps"}},
        ]
        lanes_seen = set()
        for e in self.events:
            if e.lane is not None and e.lane not in lanes_seen:
                lanes_seen.add(e.lane)
                out.append({"name": "thread_name", "ph": "M", "pid": 1,
                            "tid": e.lane + 1,
                            "args": {"name": f"lane{e.lane}"}})
        ends: Dict[int, List[Tuple[float, str]]] = {}
        for e in self.events:
            if e.rid is not None and e.name in ("preempt", "retire"):
                ends.setdefault(e.rid, []).append((e.ts, e.name))
        for rid, r in self.request_spans().items():
            rends = sorted(ends.get(rid, []))
            for ts, lane in r["admits"]:
                end = next(((t, n) for t, n in rends if t >= ts), None)
                if end is None or lane is None:
                    continue
                out.append({"name": f"req{rid}", "ph": "X", "pid": 1,
                            "tid": lane + 1, "ts": ts * 1e6,
                            "dur": max((end[0] - ts) * 1e6, 1.0),
                            "args": {"rid": rid, "end": end[1]}})
        for e in self.events:
            base = {"name": e.name, "pid": 1,
                    "ts": e.ts * 1e6, "args": dict(e.args or {})}
            base["args"]["step"] = e.step
            if e.rid is not None:
                base["args"]["rid"] = e.rid
            if e.dur > 0.0:                       # phase duration event
                base.update(ph="X", tid=0, dur=e.dur * 1e6)
            else:                                 # instant
                base.update(ph="i", s="t",
                            tid=0 if e.lane is None else e.lane + 1)
            out.append(base)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


class _PhaseTimer:
    """Times one phase as a context manager; ``args`` become the event's
    arguments."""

    def __init__(self, tracer: Tracer, name: str, step: int) -> None:
        self._tracer, self._name, self._step = tracer, name, step
        self.args: Dict[str, Any] = {}

    def __enter__(self) -> "_PhaseTimer":
        self._start = self._tracer.now()
        return self

    def __exit__(self, *exc) -> None:
        dur = self._tracer.now() - self._start
        self._tracer._end_phase(self._name, self._step, self._start, dur,
                                self.args or None)


class MetricsLogger:
    """Periodic scheduler gauge snapshots: ``emit(step, gauges)`` keeps one
    (and writes one JSON line to ``sink``, when given);
    :meth:`prometheus_text` renders the latest as Prometheus gauges."""

    def __init__(self, every: int = 0,
                 sink: Optional[TextIO] = None) -> None:
        self.every = every
        self.sink = sink
        self.snapshots: List[Dict[str, Any]] = []
        self._last_step = -1

    def due(self, step: int) -> bool:
        """True at most once per scheduler step (a loop iteration without a
        model call leaves the step as it was and must not emit again)."""
        return (self.every > 0 and step % self.every == 0
                and step != self._last_step)

    def emit(self, step: int, gauges: Dict[str, Any]) -> None:
        self._last_step = step
        snap = {"step": step, "ts": time.time()}
        snap.update(gauges)
        self.snapshots.append(snap)
        if self.sink is not None:
            self.sink.write(json.dumps(snap) + "\n")

    def jsonl(self) -> str:
        return "".join(json.dumps(s) + "\n" for s in self.snapshots)

    def prometheus_text(self) -> str:
        """The latest snapshot as Prometheus gauges (``serve_*``)."""
        if not self.snapshots:
            return ""
        lines = []
        for k, v in self.snapshots[-1].items():
            if k == "ts" or not isinstance(v, (int, float, np.integer,
                                               np.floating)):
                continue
            name = f"serve_{k}"
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {float(v):g}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Quantization health
# ---------------------------------------------------------------------------

class QuantHealth:
    """Aggregates the site vectors of the armed steps.

    Each vector is ``[n_clipped, n_total, amax, cal_range]``: counts add,
    ``amax`` and ``cal_range`` take the max (in float64 on the host).
    Stacked superblock sites arrive as (n_super, 4) arrays keyed
    ``layer/<site>`` and fan out to ``layer{i}/<site>``. Per site:

    - ``clip_fraction`` = n_clipped / n_total: the share of values on or
      past the calibrated grid's edges (paper §3: outliers past the
      fixed-point range are what break int8 transformers);
    - ``amax_ratio`` = observed amax / calibrated range: above 1, live
      traffic exceeds what calibration saw.
    """

    def __init__(self) -> None:
        self.sites: Dict[str, np.ndarray] = {}
        self.kv_scale_stats: Dict[str, Dict[str, float]] = {}
        self.steps_observed = 0

    def update(self, telemetry: Optional[Dict[str, Any]]) -> None:
        """Fold one step's {site: vector} dict of host arrays."""
        if not telemetry:
            return
        self.steps_observed += 1
        for site, vec in telemetry.items():
            arr = np.asarray(vec, dtype=np.float64)
            if arr.ndim == 2:                     # stacked: (n_super, 4)
                for i in range(arr.shape[0]):
                    self._fold(site.replace("layer/", f"layer{i}/", 1)
                               if site.startswith("layer/")
                               else f"{site}[{i}]", arr[i])
            else:
                self._fold(site, arr)

    def _fold(self, site: str, vec: np.ndarray) -> None:
        cur = self.sites.get(site)
        if cur is None:
            self.sites[site] = vec.copy()
        else:
            cur[0] += vec[0]
            cur[1] += vec[1]
            cur[2] = max(cur[2], vec[2])
            cur[3] = max(cur[3], vec[3])

    def update_kv_scales(self, cache: Any, dist: Any = None) -> None:
        """Distribution of the quantized KV cache's per-cell scales
        (``k_s`` / ``v_s`` of ``QuantKVCache`` / ``PagedQuantKVCache`` and
        their int4 subclasses), unwritten (zero) cells left out. The layer
        caches are walked in the reference's order (``layers``, ``scan``,
        ``tail``) and, as there, each one's stats replace the previous
        one's: the report holds the last quantized layer cache's. Each
        scale tensor moves to the host once; call this at the end of a
        run. ``dist``: ``cache`` is a rank's, placed by
        ``parallel.sharding.place_cache``, and every rank must call this:
        each scale tensor is gathered whole over ``model`` first, so the
        stats are the whole cache's on every rank."""
        if not isinstance(cache, dict):
            return
        from repro_torch.parallel.sharding import gather_cache_field
        for key in ("layers", "scan", "tail"):
            for node in cache.get(key, []):
                if not isinstance(node, (QuantKVCache, PagedQuantKVCache)):
                    continue
                for tail in ("k_s", "v_s"):
                    a = gather_cache_field(getattr(node, tail), "." + tail,
                                           key == "scan", dist)
                    a = a.detach().cpu().double()
                    a = a.numpy().ravel()
                    a = a[a != 0.0]
                    if a.size == 0:
                        continue
                    self.kv_scale_stats[f"kv/{tail}"] = {
                        "n": int(a.size), "min": float(a.min()),
                        "max": float(a.max()), "mean": float(a.mean()),
                        "p50": float(np.percentile(a, 50)),
                        "p99": float(np.percentile(a, 99)),
                    }

    def report(self) -> Dict[str, Any]:
        per_site = {}
        for site, v in sorted(self.sites.items()):
            total = v[1]
            per_site[site] = {
                "clipped": int(v[0]), "total": int(total),
                "clip_fraction": float(v[0] / total) if total else 0.0,
                "observed_amax": float(v[2]),
                "calibrated_range": float(v[3]),
                "amax_ratio": float(v[2] / v[3]) if v[3] else 0.0,
            }
        return {"steps_observed": self.steps_observed, "sites": per_site,
                "kv_scales": self.kv_scale_stats}


@dataclasses.dataclass
class ServeTelemetry:
    """The one handle the scheduler threads around; any member may be None
    (``telemetry=None`` on the scheduler: all off)."""
    tracer: Optional[Tracer] = None
    metrics: Optional[MetricsLogger] = None
    quant: Optional[QuantHealth] = None

    @classmethod
    def create(cls, *, trace: bool = False, metrics_every: int = 0,
               quant: bool = False,
               metrics_sink: Optional[TextIO] = None) -> "ServeTelemetry":
        return cls(
            tracer=Tracer() if trace else None,
            metrics=MetricsLogger(metrics_every, metrics_sink)
            if metrics_every > 0 else None,
            quant=QuantHealth() if quant else None)
