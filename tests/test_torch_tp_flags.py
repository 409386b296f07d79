"""The serving flags under ``--tp`` in the port (``--prefix-cache``,
``--over-commit`` with and without ``--swap-blocks``, ``--trace``,
``--metrics-every``, ``--quant-telemetry``, ``--stats-json``) on the CPU,
held to the port's unsharded runs and to the reference launcher's counts.

One spawn of 2 gloo ranks (``torch_tp_ranks.flag_scenarios``) serves, in
the launcher's default layout (KV caches on their sequence dim):

* reduced gemma2-2b with chip_smoke's ``REDUCED_PREFIX`` runs A and B and
  ``REDUCED_OC`` runs A and B (``--parity`` each), and run B of the
  over-commit workload with ``--trace --metrics-every 4
  --quant-telemetry --stats-json``. Both ranks' greedy tokens and rank 0's
  lines (serve counts, prefix, over-commit and tier notes, parity, trace,
  metrics and quant-health lines; not the host times or the rank's peak
  KV-cache bytes) equal the unsharded run's in this process; the
  reference launcher's counts hold (``PREFIX_COUNTS``, ``RUN_B_COW``,
  ``OC_COUNTS``, ``RUN_B_TEL``); a rank's swap payloads are half the
  unsharded ones; only rank 0 writes the trace, its metrics and the stats;
  every rank's trace events, request spans and metrics snapshots equal the
  unsharded run's (host times aside), and every rank's quant-health report
  (counts exact, amax and range within 1e-6 relative, KV scale stats
  equal).
* Units: the armed steps' raw site vectors in both cache layouts, APPLY
  and deploy (the per-site rule: a site each rank holds a part of adds its
  counts over the ranks, any other counts once; summed that way every
  site's total is the unsharded total); the KV scale stats of placed
  caches; ``cache_copy_block`` / ``cache_gather_blocks`` /
  ``cache_scatter_blocks`` on placed kv16 / kv8 / kv4 arenas and the
  whole-cells read of a cloned block; the weight grid of a rank's slice
  (``estimate_weight_params(split=)``) and its gradients.
"""
import contextlib
import io
import math
import re
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch.launch import serve
from repro_torch.launch.mesh import run_ranks

import torch_tp_ranks as ranks

pytestmark = [pytest.mark.serve]

CPU = "cpu"
TEL = ["--trace", "{dir}/trace.json", "--metrics-every", "4",
       "--quant-telemetry", "--stats-json", "{dir}/stats.json"]
RUNS = {
    "prefix-A": cs.REDUCED_PREFIX,
    "prefix-B": cs.REDUCED_PREFIX + ["--skew", "10"],
    "oc-A": cs.REDUCED_OC,
    "oc-B": cs.REDUCED_OC + list(cs.OC_EXTRA["B"]),
    "telemetry": [a for a in cs.REDUCED_OC if a != "--parity"]
    + list(cs.OC_EXTRA["B"]) + TEL,
    "telemetry-off": [a for a in cs.REDUCED_OC if a != "--parity"]
    + list(cs.OC_EXTRA["B"]),
}


def _argv(name, where):
    return [a.format(dir=where) for a in RUNS[name]]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (and for each spawned rank)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flags():
    """One spawn of 2 CPU ranks (every run and unit of
    ``torch_tp_ranks.flag_scenarios``) beside the unsharded runs in this
    process, each under ``torch_tp_ranks.flag_counters``."""
    with tempfile.TemporaryDirectory() as tmp:
        tp_dir, un_dir = Path(tmp) / "tp", Path(tmp) / "un"
        tp_dir.mkdir()
        un_dir.mkdir()
        got = []
        spawn = threading.Thread(target=lambda: got.append(run_ranks(
            ranks.flag_scenarios, 2, ({n: _argv(n, tp_dir) for n in RUNS},),
            device=CPU, threads=1)))
        spawn.start()
        un = {}
        try:
            for name in RUNS:
                report = []
                out = io.StringIO()
                with ranks.flag_counters() as counts, \
                        contextlib.redirect_stdout(out):
                    serve.main(_argv(name, un_dir), device=CPU,
                               report=report)
                un[name] = (out.getvalue(), report[0], counts)
        finally:
            spawn.join(timeout=900)
        assert not spawn.is_alive() and got, "the ranks did not report"
        files = {p.name: p.read_text() for p in tp_dir.iterdir()}
    return dict(ranks=got[0], un=un, files=files, tp_dir=str(tp_dir),
                un_dir=str(un_dir))


def _lines(text, where):
    """The launcher's lines less what a run's host clock and a rank's
    share set (``chip_smoke._flag_lines``) and the files' directory."""
    return cs._flag_lines(text.replace(where, "DIR"))


@pytest.mark.parametrize("name", list(RUNS))
def test_tokens_equal_the_unsharded_run(flags, name):
    """Both ranks emit the unsharded run's greedy tokens."""
    want = flags["un"][name][1]["tokens"]
    for r in flags["ranks"]:
        assert r["runs"][name][1]["tokens"] == want


@pytest.mark.parametrize("name", list(RUNS))
def test_rank0_lines_equal_the_unsharded_lines(flags, name):
    """Rank 0 prints the unsharded run's lines: the startup checks, the
    serve counts and notes, the tier lines, every ``[parity] OK``, the
    trace, metrics, Prometheus and quant-health lines (host times, the
    rank's peak KV-cache bytes and the files' directory aside); the other
    rank prints nothing."""
    text = flags["ranks"][0]["runs"][name][0]
    assert _lines(text, flags["tp_dir"]) == _lines(flags["un"][name][0],
                                                   flags["un_dir"])
    assert flags["ranks"][1]["runs"][name][0] == ""
    n_ok = 0 if name.startswith("telemetry") else 4
    assert text.count("[parity] OK") == n_ok


@pytest.mark.parametrize("name", ["prefix-A", "prefix-B", "oc-A", "oc-B"])
def test_the_reference_launchers_counts_hold(flags, name):
    """Rank 0's serve line carries the reference launcher's counts (runs A
    and B of the prefix and over-commit workloads, chip_smoke's pinned
    lines), every rank's ``ServeStats`` counts are the unsharded run's,
    and prefix run B makes the reference's copy-on-writes on every rank:
    52 ``BlockPool.cow`` calls, 4 of them copying a block through
    ``cache_copy_block``."""
    text = flags["ranks"][0]["runs"][name][0]
    run = name[-1]
    if name.startswith("prefix"):
        counts, blocks = cs.PREFIX_COUNTS[run]
        m = re.search(r"\] (\d+) tokens, (\d+) decode steps, (\d+) "
                      r"prefills, .*blocks (\d+)/.*\((\d+) chunk steps", text)
        assert tuple(map(int, m.groups())) == counts
        assert blocks in text and cs.PREFIX_HITS in text
    else:
        head, note, tiers = cs.OC_COUNTS[run]
        line = re.search(r"^\[serve:continuous\] (.*)$", text, re.M).group(1)
        assert line.startswith(head) and note in line
        assert tuple(re.findall(r"^\[tier \d+\] .*$", text, re.M)) == tiers
    un = flags["un"][name][1]["stats"]
    keys = ("tokens_generated", "decode_steps", "prefill_calls",
            "chunk_steps", "blocks_in_use", "prefix_hit_tokens",
            "prefill_tokens_saved", "shared_blocks", "preemptions",
            "swapped_blocks", "recomputed_tokens", "queue_wait_steps")
    for r in flags["ranks"]:
        stats = r["runs"][name][1]["stats"]
        assert {k: getattr(stats, k) for k in keys} == \
            {k: getattr(un, k) for k in keys}
        assert stats.tier_latency == un.tier_latency
        cow, un_cow = r["runs"][name][2]["cow"], flags["un"][name][2]["cow"]
        assert cow == un_cow
        if name == "prefix-B":
            assert (cow["cow"], cow["copy_block"]) == cs.RUN_B_COW


@pytest.mark.parametrize("name", ["oc-B", "telemetry"])
def test_a_ranks_swap_payloads_are_half(flags, name):
    """Swap mode moves a rank's share of every preempted block (its cells
    of every block, all heads): each rank's swap-out and swap-in bytes are
    half the unsharded run's, for the same 16 blocks."""
    un = flags["un"][name][2]["swaps"]
    assert un["out_bytes"] > 0 and un["out_bytes"] == un["in_bytes"]
    for r in flags["ranks"]:
        c = r["runs"][name][2]["swaps"]
        assert 2 * c["out_bytes"] == un["out_bytes"]
        assert 2 * c["in_bytes"] == un["in_bytes"]
        assert r["runs"][name][1]["stats"].swapped_blocks == 16


def test_only_rank0_writes_the_files(flags):
    """Rank 0 writes the trace, its metrics and the stats, once each; the
    other rank writes nothing; the files are the unsharded run's kinds of
    record (a Chrome trace of 105 events, 8 metrics lines, the run's
    ServeStats)."""
    import json
    names = ("trace.json", "trace.json.metrics.jsonl", "stats.json")

    def written(r):
        return sorted(Path(p).name for p in r["runs"]["telemetry"][2]["files"]
                      if p.startswith(flags["tp_dir"]))
    assert written(flags["ranks"][0]) == sorted(names)
    assert written(flags["ranks"][1]) == []
    files = flags["files"]
    assert sorted(files) == sorted(names)
    assert json.loads(files["trace.json"])["displayTimeUnit"] == "ms"
    assert len(files["trace.json.metrics.jsonl"].splitlines()) == 8
    assert json.loads(files["stats.json"])["tokens_generated"] == 72
    text = flags["ranks"][0]["runs"]["telemetry"][0]
    assert cs.RUN_B_TEL[0] in text and cs.RUN_B_TEL[2] in text
    assert cs.RUN_B_TEL[3] in text
    assert all(f"[trace] {ph}" in text for ph in cs.RUN_B_TEL[1])


def _events(tel):
    return [(e.name, e.step, e.rid, e.lane, e.dur > 0, e.args)
            for e in tel.tracer.events]


def _spans(tel):
    return {rid: (len(s["admits"]), s["lanes"], s["preempts"],
                  s["resumes"], s["retired"])
            for rid, s in tel.tracer.request_spans().items()}


def _snapshots(tel):
    return [{k: v for k, v in s.items() if k != "ts"}
            for s in tel.metrics.snapshots]


def test_every_rank_traces_the_unsharded_event_stream(flags):
    """Every rank runs its tracer and metrics: its events (names, order,
    steps, requests, lanes and arguments), request spans and metrics
    snapshots equal the unsharded run's, host times aside."""
    un = flags["un"]["telemetry"][1]["telemetry"]
    assert len(un.tracer.events) == 105
    for r in flags["ranks"]:
        tel = r["runs"]["telemetry"][1]["telemetry"]
        assert _events(tel) == _events(un)
        assert _spans(tel) == _spans(un)
        assert _snapshots(tel) == _snapshots(un)
        assert dict(cs.RUN_B_GAUGES) == {
            k: v for k, v in _snapshots(tel)[-1].items()
            if k in dict(cs.RUN_B_GAUGES)}
        assert tel.metrics.prometheus_text() == un.metrics.prometheus_text()


def test_every_ranks_quant_health_report_is_the_unsharded_one(flags):
    """The armed steps' site vectors folded over the ranks (one all-gather
    a step): every rank's report equals the unsharded report, its counts
    exactly, amax and range within 1e-6 relative; the KV scale stats are
    the whole cache's."""
    want = flags["un"]["telemetry"][1]["telemetry"].quant.report()
    assert len(want["sites"]) == 28 and want["steps_observed"] == 33
    for r in flags["ranks"]:
        got = r["runs"]["telemetry"][1]["telemetry"].quant.report()
        assert got["steps_observed"] == want["steps_observed"]
        assert sorted(got["sites"]) == sorted(want["sites"])
        for site, w in want["sites"].items():
            g = got["sites"][site]
            assert (g["clipped"], g["total"]) == (w["clipped"], w["total"])
            for k in ("observed_amax", "calibrated_range"):
                assert math.isclose(g[k], w[k], rel_tol=1e-6, abs_tol=0)
        assert got["kv_scales"] == want["kv_scales"]
        assert set(got["kv_scales"]) == {"kv/k_s", "kv/v_s"}


def test_one_all_gather_folds_an_armed_step(flags):
    """Each armed step's site rows reach the sink folded over the ranks by
    one all-gather: the telemetry run makes as many all-gathers more than
    the same run unarmed as it has armed steps, plus the end's gathers of
    the KV scales (``k_s`` and ``v_s`` of each quantized layer arena)."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-2b").reduced()
    arenas = len(cfg.block_pattern) + len(cfg.tail_pattern)
    for r in flags["ranks"]:
        on = r["runs"]["telemetry"][1]
        off = r["runs"]["telemetry-off"][1]
        steps = on["telemetry"].quant.report()["steps_observed"]
        extra = (on["collective_calls"]["all_gather"]
                 - off["collective_calls"]["all_gather"])
        assert extra == steps + 2 * arenas
        for kind in ("all_reduce", "reduce_scatter"):
            assert on["collective_calls"].get(kind) == \
                off["collective_calls"].get(kind)


# which sites' tensors a rank holds a part of, by layout and mode: the
# vocab-cut logits, the float FFN's d_ff slice and, with the caches on
# their KV heads, the rank's heads (q, k, v, the softmax and a float wo's
# input); everything else is whole on every rank
def _expected_parts(layout, mode):
    parts = {"head/logits"}
    if mode == "apply":
        parts.add("layer/ffn/hidden")
    if layout == "kvhead":
        parts |= {f"layer/attn/{s}" for s in ("q", "k", "v", "softmax_in",
                                              "softmax_out")}
        if mode == "apply":
            parts.add("layer/attn/wo_in")
    return parts


SITE_CASES = [(lay, mode) for lay in ("seq", "kvhead")
              for mode in ("apply", "deploy")]


@pytest.mark.parametrize("layout,mode", SITE_CASES,
                         ids=[f"{a}-{b}" for a, b in SITE_CASES])
def test_site_totals_sum_to_the_unsharded_totals(flags, layout, mode):
    """Per armed step (admit, chunk, decode) and site: the ranks mark the
    same sites as their part of a cut tensor, those of the layout's rule;
    such a site's total summed over the ranks, and any other site's total
    on each rank, equals the unsharded total; folded, the clipped counts
    equal the unsharded ones and amax / range the unsharded values within
    1e-6 relative."""
    r0, r1 = (r["sites"][layout, mode] for r in flags["ranks"])
    for i, (un, _) in enumerate(r0["un"]):
        (v0, p0), (v1, p1) = r0["rank"][i], r1["rank"][i]
        assert p0 == p1 == _expected_parts(layout, mode) & set(un)
        assert sorted(v0) == sorted(v1) == sorted(un)
        for site, want in un.items():
            a, b = v0[site], v1[site]
            if site in p0:
                assert np.array_equal(a[..., 1] + b[..., 1], want[..., 1])
                assert (a[..., 1] < want[..., 1]).all()
                clipped = a[..., 0] + b[..., 0]
            else:
                assert np.array_equal(a[..., :2], want[..., :2])
                assert np.array_equal(b[..., :2], want[..., :2])
                clipped = a[..., 0]
            assert np.array_equal(clipped, want[..., 0]), (i, site)
            np.testing.assert_allclose(np.maximum(a[..., 2:], b[..., 2:]),
                                       want[..., 2:], rtol=1e-6, atol=0)


@pytest.mark.parametrize("layout", ["seq", "kvhead"])
def test_kv_scale_stats_of_placed_caches_are_the_whole_caches(flags,
                                                              layout):
    """``QuantHealth.update_kv_scales(cache, dist)`` on a rank's placed
    int8 / int4 cache, dense and paged (every token its own grid), gathers
    the scales whole: n, min, p50, p99, max and mean equal the whole
    cache's, on every rank."""
    for r in flags["ranks"]:
        for key, (whole, rank) in r["kv_scales"][layout].items():
            assert whole and rank == whole, key
            assert whole["kv/k_s"]["n"] > 0 and \
                whole["kv/k_s"]["min"] < whole["kv/k_s"]["max"]


BLOCK_CASES = [(lay, kv) for lay in ("seq", "kvhead") for kv in (16, 8, 4)]


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("layout,kv_bits", BLOCK_CASES,
                         ids=[f"{a}-kv{b}" for a, b in BLOCK_CASES])
def test_block_ops_on_placed_arenas(flags, layout, kv_bits):
    """Block ids are global (the block table is whole on every rank), so
    copy-on-write and the swaps run on the rank's own fields with no
    collective: on every field of the arena (payloads, the ``*_s`` scales
    cut with them, ``pos`` cut with the cells in the sequence layout, the
    stacked leaves' block axis at 1) the copy, the gathered payload and
    the scatter equal the whole cache's op placed; a payload's bytes are
    half the whole's in the sequence layout (in the KV-head layout ``pos``
    stays whole)."""
    for r in flags["ranks"]:
        got = r["blocks"][layout][kv_bits]
        _equal(*got["copy"])
        pay, want, whole = got["gather"]
        _equal(pay, want)
        _equal(*got["scatter"])
        nbytes = {k: v.nbytes for k, v in pay.items()}
        whole_bytes = {k: v.nbytes for k, v in whole.items()}
        for k, n in nbytes.items():
            cut = layout == "seq" or not k.endswith(".pos")
            assert (2 * n if cut else n) == whole_bytes[k], k


@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_whole_cells_read_the_cloned_block(flags, kv_bits):
    """A chunk step reads a prefix-hit block through ``_whole_cells`` in
    the sequence layout: after ``cache_copy_block`` on the placed arenas,
    that read is the whole cache after the copy, the clone included."""
    for r in flags["ranks"]:
        got, want = r["blocks"]["seq"][kv_bits]["whole_cells"]
        _equal(got, want)
        k = next(k for k in want if k.endswith((".k", ".k_q")))
        assert np.array_equal(want[k][5], want[k][2])


GRID_CASES = [(e, g, d) for e in ("minmax", "mse")
              for g in ("tensor", "channel") for d in (0, 1)]


@pytest.mark.parametrize("est,gran,dim", GRID_CASES,
                         ids=[f"{e}-{g}-dim{d}" for e, g, d in GRID_CASES])
def test_a_slices_weight_grid_is_the_whole_weights(flags, est, gran, dim):
    """``estimate_weight_params(split=)`` on a rank's slice: the whole
    weight's grid (this rank's channels of it where the cut dim is the
    channel axis), and the gradient of sum(fake_quant(w) * r) through it
    the rank's slice of the whole weight's gradient within 1e-6 of its
    max (the grid's gradient, summed over the ranks, reaches the rank
    holding the extreme)."""
    from repro_torch.core.quant_config import (Granularity,
                                               QuantizerConfig,
                                               RangeEstimator)
    from repro_torch.core.quantizer import fake_quant
    from repro_torch.core.range_estimation import estimate_weight_params
    gen = torch.Generator().manual_seed(11)
    w = torch.randn(12, 10, generator=gen).requires_grad_(True)
    r = torch.randn(12, 10, generator=gen)
    qcfg = QuantizerConfig(
        bits=8, symmetric=True,
        granularity=(Granularity.PER_TENSOR if gran == "tensor"
                     else Granularity.PER_CHANNEL),
        estimator=(RangeEstimator.CURRENT_MINMAX if est == "minmax"
                   else RangeEstimator.MSE))
    qp = estimate_weight_params(w, qcfg)
    g, = torch.autograd.grad(torch.sum(fake_quant(w, qp, qcfg) * r), [w])
    g = g.numpy()
    per = (gran == "channel" and dim == 1)
    for i, rank in enumerate(flags["ranks"]):
        scale, zp, grad = rank["grids"][est, gran, dim]
        want_s = qp.scale.detach().numpy()
        if per:
            want_s = want_s[i * 5:(i + 1) * 5]
        assert np.array_equal(scale, want_s)
        n = w.shape[dim] // 2
        want_g = np.take(g, range(i * n, (i + 1) * n), axis=dim)
        assert np.abs(grad - want_g).max() <= 1e-6 * np.abs(g).max()
