"""Serving observability in the port (``repro_torch.runtime.telemetry`` and
its hooks in the Scheduler, the engine, the steps and the models) against
the reference, on the CPU.

* The 12 test functions of ``tests/test_telemetry.py`` on the port's
  Scheduler and stub model: lifecycle conservation against ``ServeStats``,
  the Chrome-trace schema, ``MetricsLogger`` cadence and exports,
  ``telemetry_stats`` against a numpy oracle, ``QuantCtx.act`` recording,
  ``QuantHealth`` fan-out and merge, tracing that calls the same steps
  as an untraced run, ``quant_telemetry=False`` returning the plain
  closure, and the tracer's unit cases.
* The same stub runs (over-commit drop and swap, and a prefix-cache run
  that evicts) through both packages' Schedulers: equal event sequences
  (name, step, rid, lane, args), Chrome-trace documents equal once ``ts``
  and ``dur`` are taken out, equal metrics JSON lines (less the wall-clock
  ``ts``) and Prometheus text.
* ``telemetry_stats``, ``deploy.site_stats`` (per-tensor, PEG G=4, with a
  permutation) and ``deploy.qtensor_stats`` on the same numpy inputs as
  the reference's: exact counts, amax and range within rel 1e-6. The
  inputs are drawn so that no value lies near a rounding tie (the two
  packages divide and round in f32 in other orders).
* ``QuantHealth``: the reference's vectors fan out and merge alike, and
  the KV scale walk gives the reference's stats on a converted cache.
* The reduced gemma2-2b deploy step with an armed ctx, on params and
  calibration copied from the reference: the report's site keys
  (``layer{i}/...`` per superblock) and totals are the reference's, clip
  counts exact on this tie-free seed, amax and range within rel 1e-6, the
  ``wo_in`` site present at decode rows (the unfused path), and the logits
  those of the disarmed step, bit for bit.
* The launcher's over-commit run A with ``--trace --metrics-every 2
  --quant-telemetry --stats-json``: the reference launcher's counts, and
  the same tokens as without the flags.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import Mode as JMode
from repro.core import QuantCtx as JQuantCtx
from repro.core import build_deploy as jbuild_deploy
from repro.core import deploy as jdeploy
from repro.core import peg_policy as jpeg_policy
from repro.core.pipeline import ptq as jptq
from repro.core.quantizer import QuantParams as JQuantParams
from repro.core.quantizer import telemetry_stats as jtelemetry_stats
from repro.models import transformer as jtfm
from repro.runtime import BlockPool as JBlockPool
from repro.runtime import QuantHealth as JQuantHealth
from repro.runtime import RadixCache as JRadixCache
from repro.runtime import Request as JRequest
from repro.runtime import ServeTelemetry as JServeTelemetry
from repro.runtime import serve_continuous as jserve_continuous
from repro.runtime.steps import make_decode_step as jmake_decode
from repro_torch.configs import get_config
from repro_torch.convert import (act_state_from_jax, caches_from_jax,
                                 params_from_jax)
from repro_torch.core import Mode, QuantCtx, build_deploy, peg_policy
from repro_torch.core import deploy, w8a8_policy
from repro_torch.core.quantizer import (QuantParams, fake_quant,
                                        params_from_range, telemetry_stats)
from repro_torch.models import transformer as tfm
from repro_torch.runtime import (BlockPool, MetricsLogger, QuantHealth,
                                 RadixCache, Request, ServeTelemetry, Tracer,
                                 serve, serve_continuous)
from repro_torch.runtime.steps import (make_admit_step,
                                       make_chunk_prefill_step,
                                       make_decode_step, make_prefill_step)

pytestmark = [pytest.mark.serve, pytest.mark.obs]

VOCAB = 32
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module: the reduced model's ops are tiny,
    and a pool's threads, oversubscribed by parallel test workers, slow
    them down by tens of times. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(prompt, n):
    out, tok = [], int(prompt[-1])
    for _ in range(n):
        tok = (2 * tok + 1) % VOCAB
        out.append(tok)
    return out


class _Stub:
    """The reference test's stub: next token (2 * tok + 1) % VOCAB as
    one-hot logits, with swap steps carrying a dummy payload; records the
    calls of its steps (kind, argument count)."""

    def __init__(self, zeros, onehot):
        self.zeros, self.onehot = zeros, onehot
        self.calls = []

    def init_cache(self, batch):
        return {"kv": self.zeros((batch, 4))}

    def _step(self, kind, tokens, cache, n_args):
        self.calls.append((kind, n_args))
        return self.onehot((2 * np.asarray(tokens) + 1) % VOCAB), cache

    def admit(self, tokens, positions, admit_mask, cache):
        return self._step("admit", tokens, cache, 4)

    def chunk(self, tokens, positions, reset_mask, cache):
        return self._step("chunk", tokens, cache, 4)

    def decode(self, tokens, pos, cache):
        return self._step("decode", tokens, cache, 3)

    def swap_out(self, cache, ids):
        return {"blocks": self.zeros((len(ids), 1))}

    def swap_in(self, cache, ids, payload):
        return cache


def _jstub():
    return _Stub(lambda s: jnp.zeros(s, jnp.float32),
                 lambda t: jnp.eye(VOCAB, dtype=jnp.float32)[
                     jnp.asarray(t) % VOCAB])


def _tstub():
    return _Stub(lambda s: torch.zeros(s),
                 lambda t: torch.nn.functional.one_hot(
                     torch.as_tensor(t).long() % VOCAB, VOCAB).float())


def _oc_reqs(cls=Request):
    return [cls(rid=i, prompt=np.full(4, 3 + i, np.int32),
                max_new_tokens=12) for i in range(4)]


def _prefix_reqs(cls=Request):
    """Every other prompt opens with the same 8 tokens (two blocks of 4),
    the others with their own: on a 6-block pool the donated blocks of
    retired prompts run the free list dry, so the radix cache evicts."""
    shared = np.arange(1, 9, dtype=np.int32)
    return [cls(rid=i, prompt=np.concatenate(
        [shared if i % 2 == 0 else np.full(8, 11 + i, np.int32),
         np.full(1 + i % 3, 20 + i, np.int32)]),
        max_new_tokens=2 + i % 3) for i in range(8)]


# the runs both Schedulers serve: (requests, pool blocks, radix, swap)
RUNS = {"drop": (_oc_reqs, 6, False, False),
        "swap": (_oc_reqs, 6, False, True),
        "prefix": (_prefix_reqs, 6, True, False)}


def _serve_oc(reqs, tel, *, swap=False, num_blocks=6, radix=False,
              package="port"):
    """The reference test's over-commit stub serve (a pool below worst-case
    demand, so lanes are preempted), through either package."""
    if package == "port":
        m, pool_cls, radix_cls, run = (_tstub(), BlockPool, RadixCache,
                                       serve_continuous)
        extra = {"device": CPU}
    else:
        m, pool_cls, radix_cls, run = (_jstub(), JBlockPool, JRadixCache,
                                       jserve_continuous)
        extra = {}
    stats = run(m.admit, m.decode, m.init_cache, reqs, batch_slots=2,
                block_pool=pool_cls(num_blocks, 4, 2, 8), chunk_fn=m.chunk,
                prefill_chunk=4, over_commit=True,
                radix_cache=radix_cls(4) if radix else None,
                swap_out_fn=m.swap_out if swap else None,
                swap_in_fn=m.swap_in if swap else None,
                telemetry=tel, **extra)
    return stats


# ---------------------------------------------------------------------------
# The reference's test_telemetry.py, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("swap", [False, True])
def test_spans_reconcile_with_serve_stats(swap):
    tel = ServeTelemetry.create(trace=True)
    reqs = _oc_reqs()
    stats = _serve_oc(reqs, tel, swap=swap)
    for r in reqs:
        assert r.tokens_out == _golden(r.prompt, 12)
    assert stats.preemptions > 0
    spans = tel.tracer.request_spans()
    assert sorted(spans) == [r.rid for r in reqs]
    for rid, s in spans.items():
        assert s["retired"], f"rid {rid} never retired"
        assert len(s["admits"]) == s["resumes"] + 1
        assert s["preempts"] == s["resumes"]
        assert s["enqueue_ts"] is not None
        assert s["enqueue_ts"] <= s["admits"][0][0] <= s["retire_ts"]
        assert [t for t, _ in s["admits"]] == sorted(
            t for t, _ in s["admits"])
    assert sum(s["preempts"] for s in spans.values()) == stats.preemptions
    names = [e.name for e in tel.tracer.events]
    assert names.count("decode_batch") == stats.decode_steps
    assert names.count("admit") + names.count("chunk") \
        - sum(len(s["admits"]) - s["resumes"]
              for s in spans.values()) == stats.prefill_calls
    assert names.count("enqueue") == len(reqs)
    assert names.count("retire") == len(reqs)
    mode = "swap" if swap else "drop"
    preempts = [e for e in tel.tracer.events if e.name == "preempt"]
    assert preempts and all(e.args["mode"] == mode for e in preempts)
    if swap:
        assert "swap_out" in names and "swap_in" in names
    hist = tel.tracer.latency_histograms()
    assert hist["decode_batch"]["n"] == stats.decode_steps
    assert all(h["p50"] <= h["p95"] <= h["p99"] for h in hist.values())


def test_tokens_identical_with_and_without_tracing():
    traced, plain = _oc_reqs(), _oc_reqs()
    _serve_oc(traced, ServeTelemetry.create(trace=True, metrics_every=2))
    _serve_oc(plain, None)
    for a, b in zip(traced, plain):
        assert a.tokens_out == b.tokens_out


def test_trace_is_valid_chrome_trace_json(tmp_path):
    tel = ServeTelemetry.create(trace=True)
    _serve_oc(_oc_reqs(), tel, swap=True)
    path = tmp_path / "trace.json"
    tel.tracer.dump(str(path))
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert evs
    for e in evs:
        assert {"name", "ph", "pid"} <= set(e)
        assert e["ph"] in ("M", "X", "i")
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] > 0
        if e["ph"] == "i":
            assert e["s"] == "t" and "ts" in e
    named = {e["tid"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    spans = [e for e in evs if e["ph"] == "X" and e["name"].startswith("req")]
    assert spans
    assert all(e["tid"] in named and e["tid"] >= 1 for e in spans)
    assert any(e["ph"] == "X" and e["tid"] == 0 for e in evs)


def test_due_fires_once_per_step():
    m = MetricsLogger(every=4)
    assert not m.due(3)
    assert m.due(4)
    m.emit(4, {"queue_depth": 1})
    assert not m.due(4)                      # same step: no second emit
    assert m.due(8)
    assert not MetricsLogger(every=0).due(0)


def test_snapshots_jsonl_and_prometheus():
    tel = ServeTelemetry.create(metrics_every=2)
    stats = _serve_oc(_oc_reqs(), tel)
    snaps = tel.metrics.snapshots
    assert snaps
    steps = [s["step"] for s in snaps]
    assert steps == sorted(set(steps))
    assert all(s % 2 == 0 for s in steps)
    assert {"queue_depth", "resident_lanes", "blocks_free",
            "refcount_total", "preemptions",
            "prefix_hit_rate"} <= set(snaps[0])
    lines = tel.metrics.jsonl().splitlines()
    assert len(lines) == len(snaps)
    last = json.loads(lines[-1])
    assert 0 < last["tokens_generated"] <= stats.tokens_generated
    assert last["preemptions"] <= stats.preemptions
    prom = tel.metrics.prometheus_text()
    assert "# TYPE serve_queue_depth gauge" in prom
    assert f"serve_tokens_generated {last['tokens_generated']:g}" in prom


def _grid():
    pol = w8a8_policy()
    cfg = pol.act_config("x")
    qp = params_from_range(torch.tensor(-1.0), torch.tensor(1.0), cfg)
    return pol, cfg, qp


def _oracle(x, qp, cfg):
    """Independent numpy recomputation of the calibrated grid."""
    s = max(float(qp.scale), np.finfo(np.float32).tiny)
    z = float(qp.zero_point)
    t = np.round(np.asarray(x, np.float64) / s) + z
    clipped = int(np.sum((t < cfg.qmin) | (t > cfg.qmax)))
    rng = max(abs(s * (cfg.qmin - z)), abs(s * (cfg.qmax - z)))
    return clipped, float(np.max(np.abs(x))), rng


def test_telemetry_stats_matches_numpy_oracle():
    pol, cfg, qp = _grid()
    x = np.random.RandomState(0).randn(512).astype(np.float32) * 2.0
    vec = telemetry_stats(torch.from_numpy(x), qp, cfg).numpy()
    clipped, amax, rng = _oracle(x, qp, cfg)
    assert clipped > 0                       # range [-1, 1] vs 2 sigma
    assert int(vec[0]) == clipped
    assert int(vec[1]) == x.size
    assert vec[2] == pytest.approx(amax, rel=1e-6)
    assert vec[3] == pytest.approx(rng, rel=1e-6)


def test_ctx_act_emits_counters():
    pol, cfg, qp = _grid()
    ctx = QuantCtx(policy=pol, mode=Mode.APPLY, act_state={"x": qp})
    ctx.telemetry = {}
    x = torch.from_numpy(
        np.random.RandomState(1).randn(256).astype(np.float32) * 2.0)
    y = ctx.act("x", x)
    assert torch.equal(y, fake_quant(x, qp, cfg))
    vec = ctx.telemetry["x"].numpy()
    clipped, _, _ = _oracle(x.numpy(), qp, cfg)
    assert int(vec[0]) == clipped and clipped > 0
    assert int(vec[1]) == x.numel()
    ctx.act("x", x)                          # a second hit folds in
    vec2 = ctx.telemetry["x"].numpy()
    assert vec2[0] == 2 * vec[0] and vec2[1] == 2 * vec[1]
    assert vec2[2] == vec[2] and vec2[3] == vec[3]


STACKED = np.asarray([[1, 10, 0.5, 1.0], [3, 10, 2.0, 1.0]], np.float32)
HEAD = np.asarray([2, 20, 4.0, 2.0], np.float32)


def test_quant_health_fanout_and_merge():
    q = QuantHealth()
    q.update({"layer/site": STACKED, "head": HEAD})
    q.update({"layer/site": STACKED})        # counts add, amax maxes
    rep = q.report()
    assert set(rep["sites"]) == {"layer0/site", "layer1/site", "head"}
    s1 = rep["sites"]["layer1/site"]
    assert s1["clipped"] == 6 and s1["total"] == 20
    assert s1["clip_fraction"] == pytest.approx(0.3)
    assert s1["observed_amax"] == 2.0
    assert s1["amax_ratio"] == pytest.approx(2.0)
    assert rep["sites"]["head"]["clip_fraction"] == pytest.approx(0.1)
    assert rep["steps_observed"] == 2


def test_tracing_calls_the_same_steps():
    """Tracing is host-side only: a traced and metered run calls the very
    step functions of an untraced run, as often and with the same
    arguments, and gets the same tokens (the port's counterpart of the
    reference's zero-retrace guard)."""
    def run(tel):
        m = _tstub()
        reqs = [Request(rid=i, prompt=np.asarray([3 + i, 5 + i]),
                        max_new_tokens=4) for i in range(3)]
        serve_continuous(m.admit, m.decode, m.init_cache, reqs,
                         batch_slots=2, telemetry=tel, device=CPU)
        return reqs, m.calls

    plain, plain_calls = run(None)
    traced, traced_calls = run(ServeTelemetry.create(trace=True,
                                                     metrics_every=2))
    assert traced_calls == plain_calls
    assert {kind for kind, _ in plain_calls} == {"admit", "decode"}
    for a, b in zip(plain, traced):
        assert a.tokens_out == b.tokens_out


def test_disabled_telemetry_returns_plain_step():
    """quant_telemetry=False hands back the plain 2-output closure itself,
    True the armed ``_t`` closure."""
    cfg = get_config("gemma2-2b").reduced()
    for make, name in ((make_admit_step, "admit"),
                       (make_decode_step, "decode"),
                       (make_chunk_prefill_step, "chunk"),
                       (make_prefill_step, "prefill")):
        assert make(cfg).__name__ == name
        assert make(cfg, quant_telemetry=False).__name__ == name
        assert make(cfg, quant_telemetry=True).__name__ == f"{name}_t"


def test_phase_timer_records_duration_and_args():
    tr = Tracer()
    with tr.phase("decode_batch", 3) as ph:
        ph.args["lanes"] = 2
    (e,) = tr.events
    assert e.name == "decode_batch" and e.step == 3
    assert e.dur >= 0.0 and e.args == {"lanes": 2}
    assert tr.latency_histograms()["decode_batch"]["n"] == 1


def test_event_args_survive_export():
    tr = Tracer()
    tr.event("prefix_hit", 1, rid=7, lane=0, tokens=16)
    doc = tr.to_chrome_trace()
    (hit,) = [e for e in doc["traceEvents"] if e["name"] == "prefix_hit"]
    assert hit["args"]["tokens"] == 16
    assert hit["args"]["rid"] == 7
    assert hit["tid"] == 1                   # lane 0 -> tid 1
    json.dumps(doc)


# ---------------------------------------------------------------------------
# The same stub runs through both Schedulers
# ---------------------------------------------------------------------------

def _strip(doc):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in doc["traceEvents"]]


def _no_ts(jsonl):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in jsonl.splitlines()]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_stub_telemetry_matches_reference(run):
    make, num_blocks, radix, swap = RUNS[run]
    out = {}
    for package, req_cls, tel_cls in (("ref", JRequest, JServeTelemetry),
                                      ("port", Request, ServeTelemetry)):
        tel = tel_cls.create(trace=True, metrics_every=2)
        reqs = make(req_cls)
        stats = _serve_oc(reqs, tel, swap=swap, num_blocks=num_blocks,
                          radix=radix, package=package)
        out[package] = (reqs, stats, tel)
    (jreqs, jstats, jtel), (reqs, stats, tel) = out["ref"], out["port"]
    for a, b in zip(jreqs, reqs):
        assert a.tokens_out == b.tokens_out == _golden(b.prompt,
                                                       b.max_new_tokens)
    assert stats.preemptions == jstats.preemptions > 0

    def seq(t):
        return [(e.name, e.step, e.rid, e.lane, e.args)
                for e in t.tracer.events]
    assert seq(tel) == seq(jtel)
    names = {e.name for e in tel.tracer.events}
    if run == "prefix":
        assert {"radix_evict", "prefix_hit"} <= names
    if run == "swap":
        assert {"swap_out", "swap_in"} <= names
    assert _strip(tel.tracer.to_chrome_trace()) == \
        _strip(jtel.tracer.to_chrome_trace())
    assert tel.tracer.request_spans().keys() == \
        jtel.tracer.request_spans().keys()
    assert _no_ts(tel.metrics.jsonl()) == _no_ts(jtel.metrics.jsonl())
    assert tel.metrics.prometheus_text() == jtel.metrics.prometheus_text()


def test_static_serve_rejects_telemetry():
    with pytest.raises(ValueError, match="continuous-scheduler feature"):
        serve(None, None, None, None, [], scheduler="static", batch_slots=1,
              telemetry=ServeTelemetry.create(trace=True), device=CPU)


# ---------------------------------------------------------------------------
# Site vectors against the reference's
# ---------------------------------------------------------------------------

def _tie_free(rng, shape, s, z, lo, hi):
    """Values whose integer images x / s + z lie in [lo, hi] and at least
    0.1 away from any rounding tie (k + 0.5)."""
    t = rng.uniform(lo, hi, shape)
    frac = t - np.floor(t)
    t = np.where(np.abs(frac - 0.5) < 0.1, t + 0.25, t)
    return ((t - z) * s).astype(np.float32)


def _assert_vec(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape == (4,)
    assert got[0] == want[0] and got[1] == want[1]
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("granularity", ["tensor", "channel", "group"])
def test_telemetry_stats_matches_reference(granularity):
    from repro.core import w8a8_policy as jw8a8
    rng = np.random.RandomState(5)
    cfg = w8a8_policy().act_config("x")
    assert jw8a8().act_config("x").qmin == cfg.qmin
    d = 16
    gi = None
    if granularity == "tensor":
        s, z = np.float32(0.02), np.float32(-7.0)
        scale, zp = s, z
        x = _tie_free(rng, (6, d), s, z, -140, 400)
    else:
        k = d if granularity == "channel" else 4
        scale = rng.uniform(0.01, 0.03, k).astype(np.float32)
        zp = np.round(rng.uniform(-20, 20, k)).astype(np.float32)
        gi = (np.arange(d) if k == d else rng.randint(0, k, d)).astype(
            np.int32)
        s, z = scale[gi], zp[gi]
        x = _tie_free(rng, (6, d), s, z, -140, 400)
        cfg = dataclasses.replace(cfg, channel_axis=-1)
    qp = QuantParams(torch.from_numpy(np.asarray(scale)),
                     torch.from_numpy(np.asarray(zp)),
                     None if gi is None else torch.from_numpy(gi).long())
    jqp = JQuantParams(jnp.asarray(scale), jnp.asarray(zp),
                       None if gi is None else jnp.asarray(gi))
    got = telemetry_stats(torch.from_numpy(x), qp, cfg)
    want = jtelemetry_stats(jnp.asarray(x), jqp, cfg)
    assert got[0] > 0
    _assert_vec(got.numpy(), want)


def _act_quants(rng, g, perm, d=16):
    """The same ActQuant in both packages (shifted int8 grid, qmin -128)."""
    scales = rng.uniform(0.01, 0.03, g).astype(np.float32)
    zps = np.round(rng.uniform(-20, 20, g)).astype(np.float32)
    p = rng.permutation(d).astype(np.int32) if perm else None
    aq = deploy.ActQuant(scales=torch.from_numpy(scales),
                         zps=torch.from_numpy(zps), qmin=-128, qmax=127,
                         perm=None if p is None else
                         torch.from_numpy(p).long())
    jaq = jdeploy.ActQuant(scales=jnp.asarray(scales), zps=jnp.asarray(zps),
                           qmin=-128, qmax=127,
                           perm=None if p is None else jnp.asarray(p))
    return aq, jaq, scales, zps, p


@pytest.mark.parametrize("case", ["per-tensor", "peg", "peg-permuted"])
def test_site_stats_matches_reference(case):
    rng = np.random.RandomState(6)
    g = 1 if case == "per-tensor" else 4
    d = 16
    aq, jaq, scales, zps, perm = _act_quants(rng, g, case == "peg-permuted",
                                             d)
    # the permuted column j holds source column perm[j] and group j // 4
    col_group = np.repeat(np.arange(g), d // g)
    s_col, z_col = np.empty(d, np.float32), np.empty(d, np.float32)
    src = perm if perm is not None else np.arange(d)
    s_col[src], z_col[src] = scales[col_group], zps[col_group]
    x = _tie_free(rng, (3, 5, d), s_col, z_col, -160, 150)
    got = deploy.site_stats(torch.from_numpy(x), aq)
    want = jdeploy.site_stats(jnp.asarray(x), jaq)
    assert got[0] > 0
    _assert_vec(got.numpy(), want)


def test_qtensor_stats_matches_reference():
    rng = np.random.RandomState(7)
    aq, jaq, *_ = _act_quants(rng, 1, False)
    q = rng.randint(-128, 128, (4, 64)).astype(np.int8)
    q[0, :3] = (-128, 127, 127)
    got = deploy.qtensor_stats(deploy.QTensor(torch.from_numpy(q),
                                              aq.scales, aq.zps), aq)
    want = jdeploy.qtensor_stats(jdeploy.QTensor(jnp.asarray(q), jaq.scales,
                                                 jaq.zps), jaq)
    assert got[0] >= 3
    _assert_vec(got.numpy(), want)


def test_quant_health_matches_reference_on_its_vectors():
    steps = [{"layer/site": STACKED, "head": HEAD},
             {"layer/site": STACKED * [1, 1, 3, 1], "tail/x": HEAD}]
    q, jq = QuantHealth(), JQuantHealth()
    for tel in steps:
        q.update(tel)
        jq.update({k: jnp.asarray(v) for k, v in tel.items()})
    q.update({}), jq.update({})
    assert q.report() == jq.report()


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("paged", [False, True])
def test_kv_scale_stats_match_reference(kv_bits, paged):
    """The reference walks its cache pytree; the port its cache classes:
    the same stats on the same (converted) cache, zero scales left out."""
    jcfg = jget_config("gemma2-2b").reduced()
    rng = np.random.RandomState(kv_bits + paged)
    kw = dict(paged=True, block_size=4, num_blocks=8) if paged else {}
    jc = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32, kv_bits=kv_bits,
                         **kw)

    def fill(x):
        a = np.asarray(x)
        if a.dtype == np.float32:
            a = rng.uniform(0.01, 0.05, a.shape).astype(np.float32)
            a[..., :2, :] = 0.0              # unwritten cells
        return a
    jc = jax.tree.map(fill, jc)
    q, jq = QuantHealth(), JQuantHealth()
    jq.update_kv_scales(jc)
    q.update_kv_scales(caches_from_jax(jc, CPU))
    assert set(jq.kv_scale_stats) == {"kv/k_s", "kv/v_s"}
    assert q.kv_scale_stats.keys() == jq.kv_scale_stats.keys()
    for name, st in jq.kv_scale_stats.items():
        assert q.kv_scale_stats[name]["n"] == st["n"]
        for key in ("min", "max", "mean", "p50", "p99"):
            assert q.kv_scale_stats[name][key] == pytest.approx(
                st[key], rel=1e-12), (name, key)


# ---------------------------------------------------------------------------
# The reduced gemma2-2b deploy step with an armed ctx
# ---------------------------------------------------------------------------

def _share(act_state):
    shared = {}
    for site, qp in act_state.items():
        base = "layer/" + site.split("/", 1)[1] \
            if site.startswith("layer") else site
        shared.setdefault(base, qp)
    return shared


@pytest.fixture(scope="module")
def deployed():
    """The reference's reduced params and PEG calibration, deployed in both
    packages (the port's from the reference's arrays)."""
    jcfg = jget_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    key = jax.random.PRNGKey(0)
    jstacked = jtfm.init_params(jcfg, key, stacked=True, dtype=jnp.float32)
    jflat = jtfm.init_params(jcfg, key, stacked=False, dtype=jnp.float32)
    calib = np.random.RandomState(10).randint(0, cfg.vocab_size, (2, 12))
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               jflat, [{"tokens": jnp.asarray(calib)}], jpeg_policy(4),
               collect_inputs=True)
    jshared = _share(jqm.act_state)
    jpacked, jacts = jbuild_deploy(jcfg, jstacked, jpeg_policy(4), jshared)
    shared = act_state_from_jax(jax.tree.map(np.asarray, jshared), CPU)
    stacked = params_from_jax(jax.tree.map(np.asarray, jstacked), CPU)
    packed, acts = build_deploy(cfg, stacked, peg_policy(4), shared)

    def ctx():
        return QuantCtx(policy=peg_policy(4), mode=Mode.DEPLOY,
                        act_state=shared, deploy_acts=acts)

    def jctx():
        return JQuantCtx(policy=jpeg_policy(4), mode=JMode.DEPLOY,
                         act_state=jshared, deploy_acts=jacts)
    return dict(jcfg=jcfg, cfg=cfg, jpacked=jpacked, packed=packed,
                ctx=ctx, jctx=jctx)


@pytest.mark.deploy
@pytest.mark.parametrize("paged", [False, True])
def test_armed_deploy_decode_step_matches_reference(deployed, paged):
    """One decode step (B = 2, kv8: K5 dense, K6 paged) on a cache filled
    by the reference's prefill and carried across. The port's armed step:
    the reference's site keys, totals and clip counts (this seed has no
    value on a rounding tie), amax and range within rel 1e-6 (the two
    forwards sum f32 rows in other orders), ``wo_in`` recorded at decode
    rows through the unfused path (no emit), and the disarmed step's
    logits and cache, bit for bit."""
    s = deployed
    jcfg, cfg = s["jcfg"], s["cfg"]
    kw = dict(paged=True, block_size=4) if paged else {}
    toks = np.random.RandomState(3).randint(1, cfg.vocab_size, (2, 9))
    jcache = jtfm.init_cache(jcfg, 2, 16, dtype=jnp.float32, kv_bits=8,
                             **kw)
    _, jcache = jtfm.prefill(jcfg, s["jpacked"], jnp.asarray(toks), jcache,
                             ctx=s["jctx"]())
    cur = np.array([[5], [17]], np.int32)
    pos = np.full((2, 1), 9, np.int32)
    cache_np = jax.tree.map(np.asarray, jcache)
    _, _, jtel = jax.jit(jmake_decode(jcfg, ctx_factory=s["jctx"],
                                      quant_telemetry=True))(
        s["jpacked"], jnp.asarray(cur), jnp.asarray(pos), jcache)
    jq = JQuantHealth()
    jq.update(jtel)

    decode = make_decode_step(cfg, ctx_factory=s["ctx"])
    decode_t = make_decode_step(cfg, ctx_factory=s["ctx"],
                                quant_telemetry=True)
    c_plain = caches_from_jax(cache_np, CPU)
    c_armed = caches_from_jax(cache_np, CPU)
    logits, c_plain = decode(s["packed"], torch.from_numpy(cur),
                             torch.from_numpy(pos), c_plain)
    logits_t, c_armed, tel = decode_t(s["packed"], torch.from_numpy(cur),
                                      torch.from_numpy(pos), c_armed)
    assert torch.equal(logits, logits_t)
    for a, b in zip(tfm._cache_nodes(c_plain), tfm._cache_nodes(c_armed)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert "layer/attn/wo_in" in tel
    assert tel["layer/attn/wo_in"].shape == (cfg.n_super, 4)
    q = QuantHealth()
    q.update({k: v.numpy() for k, v in tel.items()})
    rep, jrep = q.report(), jq.report()
    assert set(rep["sites"]) == set(jrep["sites"])
    assert {f"layer{i}/attn/wo_in" for i in range(cfg.n_super)} <= \
        set(rep["sites"])
    for site, want in jrep["sites"].items():
        got = rep["sites"][site]
        assert (got["clipped"], got["total"]) == (want["clipped"],
                                                   want["total"]), site
        for key in ("observed_amax", "calibrated_range"):
            assert got[key] == pytest.approx(want[key], rel=1e-6), (site,
                                                                    key)


@pytest.mark.deploy
@pytest.mark.parametrize("swap", [False, True])
def test_armed_serving_emits_the_same_tokens(deployed, swap):
    """The reduced deploy model served with over-commit on a 4-block pool
    (kv8, paged), with every collector on and the armed steps, against the
    same requests served plainly: the same greedy tokens and counts; every
    event kind of the run is traced and the report covers every
    superblock's sites."""
    s = deployed
    cfg = s["cfg"]
    from repro_torch.runtime.steps import make_swap_steps

    def run(armed):
        tel = (ServeTelemetry.create(trace=True, metrics_every=2,
                                     quant=True) if armed else None)
        rng = np.random.RandomState(3)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  size=n),
                        max_new_tokens=q)
                for i, (n, q) in enumerate([(10, 12), (9, 12), (11, 10)])]
        so, si = make_swap_steps() if swap else (None, None)
        stats = serve(None, make_decode_step(cfg, ctx_factory=s["ctx"],
                                             quant_telemetry=armed),
                      lambda b: tfm.init_cache(
                          cfg, b, 32, dtype=torch.float32, kv_bits=8,
                          paged=True, block_size=8, num_blocks=4,
                          mapped=False, device=CPU),
                      s["packed"], reqs, scheduler="continuous",
                      batch_slots=2, max_len=32,
                      admit_step=make_admit_step(
                          cfg, ctx_factory=s["ctx"], quant_telemetry=armed),
                      chunk_step=make_chunk_prefill_step(
                          cfg, ctx_factory=s["ctx"], quant_telemetry=armed),
                      block_pool=BlockPool(4, 8, 2, 4), prefill_chunk=8,
                      over_commit=True, swap_out_fn=so, swap_in_fn=si,
                      write_caps=tfm.attn_write_caps(cfg, 32, 8),
                      telemetry=tel, device=CPU)
        return reqs, stats, tel

    plain, pstats, _ = run(False)
    armed, astats, tel = run(True)
    assert [r.tokens_out for r in armed] == [r.tokens_out for r in plain]
    assert (astats.decode_steps, astats.preemptions) == (
        pstats.decode_steps, pstats.preemptions)
    assert astats.preemptions > 0
    names = {e.name for e in tel.tracer.events}
    assert {"enqueue", "admit", "chunk", "decode_batch", "block_grow",
            "preempt", "resume", "retire"} <= names
    assert ({"swap_out", "swap_in"} <= names) == swap
    rep = tel.quant.report()
    assert rep["steps_observed"] == astats.decode_steps + astats.chunk_steps
    for i in range(cfg.n_super):
        for site in ("attn_in", "ffn_in", "attn/wo_in", "ffn/hidden"):
            assert f"layer{i}/{site}" in rep["sites"]
    assert {"embed/sum", "head/logits"} <= set(rep["sites"])
    assert set(rep["kv_scales"]) == {"kv/k_s", "kv/v_s"}


def test_armed_decode_step_quantizes_wo_in_through_k4(deployed,
                                                      monkeypatch):
    """Armed, the decode step's attention returns its f32 output and K4
    quantizes it (no fused emit); disarmed it emits."""
    from repro_torch.kernels import ops
    s = deployed
    cfg = s["cfg"]
    calls = {"peg": 0, "emit": 0}
    orig_peg, orig_pad = ops.peg_quantize, ops.paged_int8_attend_decode

    def peg(*a, **k):
        calls["peg"] += 1
        return orig_peg(*a, **k)

    def pad(*a, **k):
        calls["emit"] += "out_scale" in k
        return orig_pad(*a, **k)
    monkeypatch.setattr(ops, "peg_quantize", peg)
    monkeypatch.setattr(ops, "paged_int8_attend_decode", pad)
    cache = tfm.init_cache(cfg, 2, 16, dtype=torch.float32, kv_bits=8,
                           paged=True, block_size=4, device=CPU)
    cur = torch.tensor([[5], [17]], dtype=torch.int32)
    pos = torch.tensor([[0], [0]], dtype=torch.int32)
    for armed, want in ((False, {"peg": 0, "emit": cfg.num_layers}),
                        (True, {"peg": cfg.num_layers, "emit": 0})):
        calls.update(peg=0, emit=0)
        step = make_decode_step(cfg, ctx_factory=s["ctx"],
                                quant_telemetry=armed)
        step(s["packed"], cur, pos, tfm.clone_cache(cache))
        assert calls == want, armed


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

RUN_A = ["--arch", "gemma2-2b", "--reduced", "--quantize", "--deploy-int8",
         "--kv-bits", "8", "--scheduler", "continuous", "--paged-kv",
         "--block-size", "8", "--prefill-chunk", "8", "--requests", "6",
         "--new-tokens", "12", "--batch-slots", "4", "--num-blocks", "10",
         "--over-commit"]
# the reference launcher's telemetry lines for run A with --trace
# --metrics-every 2 --quant-telemetry (a CPU run of repro.launch.serve)
RUN_A_TRACE = "[trace] 106 events, 6/6 requests retired"
RUN_A_PHASES = ("chunk: n=17", "decode_batch: n=27")
RUN_A_METRICS = "[metrics] 17 snapshots"
RUN_A_HEALTH = "[quant-health] 28 sites over 44 telemetry steps"


def test_launcher_serves_run_a_with_telemetry(capsys, tmp_path):
    from repro_torch.launch import serve as launcher
    trace = tmp_path / "t.json"
    stats_path = tmp_path / "stats.json"
    plain = launcher.main(RUN_A, device=CPU)
    capsys.readouterr()
    stats = launcher.main(RUN_A + [
        "--trace", str(trace), "--metrics-every", "2", "--quant-telemetry",
        "--stats-json", str(stats_path)], device=CPU)
    out = capsys.readouterr().out
    assert f"{RUN_A_TRACE} -> {trace}" in out
    phases = re.findall(r"^\[trace\] (\w+: n=\d+) p50", out, re.M)
    assert tuple(phases) == RUN_A_PHASES
    assert f"{RUN_A_METRICS} -> {trace}.metrics.jsonl" in out
    assert RUN_A_HEALTH in out
    assert "serve_tokens_generated 72\n" in out
    assert re.search(r"^\[quant-health\] kv/k_s: n=\d+", out, re.M)
    assert f"[stats] ServeStats -> {stats_path}" in out
    doc = json.loads(trace.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert len((tmp_path / "t.json.metrics.jsonl").read_text()
               .splitlines()) == 17
    saved = json.loads(stats_path.read_text())
    assert saved["tokens_generated"] == stats.tokens_generated == 72
    assert (stats.decode_steps, stats.preemptions) == (
        plain.decode_steps, plain.preemptions)


def test_launcher_checks_the_telemetry_flags():
    from repro_torch.launch.serve import _check_args, build_parser
    ap = build_parser()
    base = ["--arch", "gemma2-2b", "--reduced", "--quantize"]
    _check_args(ap, ap.parse_args(base + [
        "--scheduler", "continuous", "--trace", "t.json",
        "--metrics-every", "2", "--quant-telemetry", "--stats-json",
        "s.json"]))
    _check_args(ap, ap.parse_args(base + ["--stats-json", "s.json"]))
    # --tp 2 with --reduced passes the reference launcher's checks, the
    # telemetry flags with it (tests/test_torch_tp_flags.py serves them)
    _check_args(ap, ap.parse_args(base + ["--scheduler", "continuous",
                                          "--tp", "2"]))
    _check_args(ap, ap.parse_args(base + ["--scheduler", "continuous",
                                          "--trace", "t.json", "--tp",
                                          "2"]))
    for bad in (["--trace", "t.json"], ["--metrics-every", "2"],
                ["--scheduler", "continuous", "--metrics-every", "-1"],
                ["--scheduler", "continuous", "--async", "--trace",
                 "t.json"]):
        with pytest.raises(SystemExit):
            _check_args(ap, ap.parse_args(base + bad))
    with pytest.raises(SystemExit):
        _check_args(ap, ap.parse_args(["--arch", "gemma2-2b", "--quantize",
                                       "--scheduler", "continuous", "--tp",
                                       "2"]))
    with pytest.raises(SystemExit):
        _check_args(ap, ap.parse_args(["--arch", "gemma2-2b",
                                       "--scheduler", "continuous",
                                       "--quant-telemetry"]))
