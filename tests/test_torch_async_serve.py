"""The async serving front-end in the port (``repro_torch.runtime.
async_serve``) against the reference, on the CPU.

* Every case of ``tests/test_async_serve.py`` on the port's engine with the
  reference test's deterministic stub LM (next = (2*tok+1) % 32, one-hot
  logits) over a one-layer dense cache: concurrent producers out of order,
  per-stream ordering observed while decoding runs, cancellation of a
  resident and of a queued request, ``close(drain=False)``, and the seeded
  and hypothesis sweeps (the reference's settings) against the port's
  continuous Scheduler; the seeded sweep's streams also equal the
  reference ``AsyncServer``'s.
* The deviation from the reference: a scheduler-thread failure (a step
  that raises) closes every queued and resident stream with that error,
  which ``result()``, iteration, ``close()`` and later submits raise within
  seconds (the reference's thread dies silently and its consumers wait out
  their timeouts).
* The launcher's ``--reduced --async --parity`` at kv8 and at W4/kv4: the
  reference launcher's ``[serve:async]`` count and ``[parity]`` lines.
"""
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import KVCache as JKVCache
from repro.runtime import AsyncServer as JAsyncServer
from repro.runtime.engine import Engine as JEngine
from repro_torch.models.attention import KVCache
from repro_torch.runtime import AsyncServer, Request, serve_continuous
from repro_torch.runtime.engine import Engine

try:
    import hypothesis
    import hypothesis.strategies as st
    HAS_HYPOTHESIS = True
except ImportError:            # optional, like tests/test_properties.py
    HAS_HYPOTHESIS = False

pytestmark = [pytest.mark.engine, pytest.mark.serve]

CPU = "cpu"
VOCAB = 32
PAD = 12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the module (see tests/test_torch_engine.py).
    Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def golden(prompt, n):
    out, tok = [], int(prompt[-1])
    for _ in range(n):
        tok = (2 * tok + 1) % VOCAB
        out.append(tok)
    return out


def _onehot(tokens):
    nxt = (2 * torch.as_tensor(tokens).long() + 1) % VOCAB
    return torch.nn.functional.one_hot(nxt, VOCAB).float()


def _stub_cache(b):
    """A whole-model-shaped dense cache (one KVCache layer), so the
    engine's lane extract and insert have a real structure to move."""
    return {"layers": [KVCache(k=torch.zeros((b, 2, 1, 1)),
                               v=torch.zeros((b, 2, 1, 1)),
                               pos=torch.full((b, 2), -1,
                                              dtype=torch.int32))]}


def _stub_admit(tokens, positions, admit_mask, cache):
    return _onehot(tokens), cache


def _stub_decode(tokens, pos, cache):
    return _onehot(tokens), cache


def _stub_engine(batch_slots=3, decode=_stub_decode, admit=_stub_admit):
    return Engine(admit, decode, _stub_cache, batch_slots=batch_slots,
                  prompt_pad_len=PAD, device=CPU)


def _jstub_engine(batch_slots):
    """The reference test's stub engine."""
    def cache(b):
        return {"layers": [JKVCache(k=jnp.zeros((b, 2, 1, 1)),
                                    v=jnp.zeros((b, 2, 1, 1)),
                                    pos=jnp.full((b, 2), -1, jnp.int32))]}

    def step(tokens, *rest):
        nxt = (2 * np.asarray(tokens) + 1) % VOCAB
        return jnp.eye(VOCAB, dtype=jnp.float32)[nxt], rest[-1]
    return JEngine(step, step, cache, batch_slots=batch_slots,
                   prompt_pad_len=PAD)


def _prompt(rng, n):
    return rng.randint(1, VOCAB, size=n).astype(np.int32)


class TestConcurrentProducers:
    def test_out_of_order_enqueue(self):
        """8 producer threads submit with jittered delays — arrival order
        is scrambled, every stream still gets its own golden tokens."""
        results = {}
        lock = threading.Lock()

        def producer(i, srv, rng):
            time.sleep(rng.uniform(0, 0.02))
            prompt = _prompt(rng, 3 + i % 5)
            s = srv.submit(prompt, 2 + i % 4, rid=i)
            got = s.result(timeout=30)
            with lock:
                results[i] = (prompt, 2 + i % 4, got)

        with AsyncServer(_stub_engine(batch_slots=2)) as srv:
            threads = [threading.Thread(
                target=producer, args=(i, srv, np.random.RandomState(100 + i)))
                for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert len(results) == 8
        for i, (prompt, quota, got) in results.items():
            assert got == golden(prompt, quota), f"producer {i}"

    def test_zero_quota_closes_without_admission(self):
        with AsyncServer(_stub_engine()) as srv:
            s = srv.submit(_prompt(np.random.RandomState(0), 4), 0)
            assert s.result(timeout=5) == []
            assert s.done and not s.cancelled


class TestStreamOrdering:
    def test_tokens_arrive_in_generation_order(self):
        """Consume a stream INCREMENTALLY while the scheduler thread is
        still decoding: every observed prefix is the golden prefix."""
        prompt = _prompt(np.random.RandomState(1), 5)
        exp = golden(prompt, 24)
        with AsyncServer(_stub_engine(batch_slots=1)) as srv:
            s = srv.submit(prompt, 24)
            seen = []
            for tok in s:
                seen.append(tok)
                assert seen == exp[:len(seen)]
        assert seen == exp

    def test_interleaved_streams_stay_ordered(self):
        rng = np.random.RandomState(2)
        prompts = [_prompt(rng, 4), _prompt(rng, 6)]
        with AsyncServer(_stub_engine(batch_slots=2)) as srv:
            streams = [srv.submit(p, 16, rid=i)
                       for i, p in enumerate(prompts)]
            outs = [s.result(timeout=30) for s in streams]
        for p, got in zip(prompts, outs):
            assert got == golden(p, 16)


class TestCancellation:
    def test_cancel_mid_generation(self):
        """Cancel a huge-quota request once a few tokens have streamed: the
        stream closes cancelled with a golden PREFIX, and the freed lane
        serves the next request to completion."""
        prompt = _prompt(np.random.RandomState(3), 4)
        with AsyncServer(_stub_engine(batch_slots=1)) as srv:
            s = srv.submit(prompt, 10_000_000, rid="doomed")
            it = iter(s)
            first = [next(it) for _ in range(3)]
            srv.cancel(s)
            got = s.result(timeout=30)
            assert s.cancelled
            assert got[:3] == first
            assert got == golden(prompt, len(got))
            p2 = _prompt(np.random.RandomState(4), 5)
            s2 = srv.submit(p2, 6, rid="after")
            assert s2.result(timeout=30) == golden(p2, 6)
            assert not s2.cancelled

    def test_cancel_queued_request_never_admits(self):
        rng = np.random.RandomState(5)
        with AsyncServer(_stub_engine(batch_slots=1)) as srv:
            busy = srv.submit(_prompt(rng, 4), 10_000_000, rid="busy")
            queued = srv.submit(_prompt(rng, 4), 8, rid="queued")
            next(iter(busy))
            srv.cancel(queued)
            assert queued.result(timeout=30) == []
            assert queued.cancelled
            srv.cancel(busy)
        assert busy.cancelled

    def test_close_without_drain_cancels_everything(self):
        rng = np.random.RandomState(6)
        srv = AsyncServer(_stub_engine(batch_slots=1))
        a = srv.submit(_prompt(rng, 3), 10_000_000)
        b = srv.submit(_prompt(rng, 3), 10_000_000)
        next(iter(a))
        srv.close(drain=False)
        assert a.done and a.cancelled
        assert b.done and b.cancelled
        with pytest.raises(RuntimeError):
            srv.submit(_prompt(rng, 3), 4)


class TestSchedulerFailure:
    """A deliberate deviation from the reference (its scheduler thread has
    no handler): a failure reaches every consumer instead of hanging it."""

    @pytest.mark.parametrize("where,fail_at", [("generate", 3),
                                               ("prefill", 2)])
    def test_failure_closes_every_stream_with_the_error(self, where,
                                                        fail_at):
        """One lane: request A (quota 2) finishes; B fails while resident
        (in its prefill, or in its second decode step) and C is queued
        behind it. A keeps its tokens; B and C raise the failure."""
        calls = [0]

        def failing(tokens, *rest):
            calls[0] += 1
            if calls[0] == fail_at:
                raise RuntimeError(f"{where} failed on the device")
            return _onehot(tokens), rest[-1]
        kw = {"decode" if where == "generate" else "admit": failing}
        rng = np.random.RandomState(7)
        t0 = time.perf_counter()
        srv = AsyncServer(_stub_engine(batch_slots=1, **kw))
        prompts = [_prompt(rng, 4) for _ in range(3)]
        a, b, c = (srv.submit(p, q, rid=rid) for p, q, rid in
                   zip(prompts, (2, 50, 50), "ABC"))
        for s in (b, c):
            with pytest.raises(RuntimeError, match=f"{where} failed"):
                s.result(timeout=10)
        assert a.result(timeout=10) == golden(prompts[0], 2)
        with pytest.raises(RuntimeError, match=f"{where} failed"):
            list(b)
        assert b.error is c.error is not None and a.error is None
        with pytest.raises(RuntimeError, match=f"{where} failed"):
            srv.submit(_prompt(rng, 4), 2)
        with pytest.raises(RuntimeError, match=f"{where} failed"):
            srv.close()
        assert time.perf_counter() - t0 < 10

    def test_failure_on_the_first_call_raises_from_close(self):
        def broken(*args):
            raise ValueError("no kernel image for this device")
        srv = AsyncServer(_stub_engine(admit=broken))
        s = srv.submit(_prompt(np.random.RandomState(8), 3), 4)
        with pytest.raises(ValueError, match="no kernel image"):
            with srv:
                s.result(timeout=10)


def _sync_scheduler_tokens(reqs, batch_slots):
    serve_continuous(_stub_admit, _stub_decode, _stub_cache, reqs,
                     batch_slots=batch_slots, device=CPU)
    return {r.rid: r.tokens_out for r in reqs}


def _streams(server, reqs):
    with server as srv:
        streams = [srv.submit(r.prompt, r.max_new_tokens, rid=r.rid)
                   for r in reqs]
        return {s.rid: s.result(timeout=60) for s in streams}


def _async_vs_sync_sweep(seed, n_requests, batch_slots, reference=False):
    """One sweep case: the same requests through the AsyncServer and the
    synchronous continuous Scheduler (and, with ``reference``, the
    reference's AsyncServer) give the same streams."""
    rng = np.random.RandomState(seed)
    spec = [(int(rng.randint(1, PAD + 1)), int(rng.randint(1, 9)))
            for _ in range(n_requests)]
    reqs = [Request(rid=i, prompt=_prompt(rng, n), max_new_tokens=q)
            for i, (n, q) in enumerate(spec)]
    sync = _sync_scheduler_tokens(
        [Request(rid=r.rid, prompt=r.prompt,
                 max_new_tokens=r.max_new_tokens) for r in reqs],
        batch_slots)
    outs = _streams(AsyncServer(_stub_engine(batch_slots=batch_slots)), reqs)
    assert outs == sync, f"seed {seed}: async != sync scheduler"
    if reference:
        assert outs == _streams(JAsyncServer(_jstub_engine(batch_slots)),
                                reqs), f"seed {seed}: port != reference"


class TestAsyncMatchesSyncScheduler:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_seeded_sweep(self, seed):
        _async_vs_sync_sweep(seed, n_requests=1 + seed % 7,
                             batch_slots=1 + seed % 3, reference=True)

    if HAS_HYPOTHESIS:
        @hypothesis.given(seed=st.integers(0, 2**16),
                          n_requests=st.integers(1, 8),
                          batch_slots=st.integers(1, 4))
        @hypothesis.settings(max_examples=20, deadline=None)
        def test_hypothesis_sweep(self, seed, n_requests, batch_slots):
            _async_vs_sync_sweep(seed, n_requests, batch_slots)


# the reference launcher's lines (a CPU run of repro.launch.serve with the
# same flags): (extra flags, the [parity] lines)
ASYNC_RUNS = {
    "kv8": (["--kv-bits", "8"],
            ["[parity] OK: async engine and static scheduler emit identical "
             "greedy tokens for all 8 requests",
             "[parity] OK: async engine and continuous scheduler emit "
             "identical greedy tokens for all 8 requests"]),
    "w4-kv4": (["--kv-bits", "4", "--weight-bits", "4"],
               ["[parity] async engine vs static scheduler: 64/64 greedy "
                "tokens match (100.0%) — int4 drift reported, not asserted",
                "[parity] async engine vs continuous scheduler: 64/64 "
                "greedy tokens match (100.0%) — int4 drift reported, not "
                "asserted"])}


@pytest.mark.deploy
@pytest.mark.parametrize("run", sorted(ASYNC_RUNS))
def test_launcher_serves_async_with_parity(capsys, run):
    from repro_torch.launch import serve as launcher
    extra, parity = ASYNC_RUNS[run]
    reqs = launcher.main(["--arch", "gemma2-2b", "--reduced", "--quantize",
                          "--deploy-int8", "--async", "--parity"] + extra,
                         device=CPU)
    out = capsys.readouterr().out
    assert re.search(r"^\[serve:async\] 64 tokens from 8 streamed requests, "
                     r".*engine step signatures \{'prefill': 1, 'extract': "
                     r"1, 'insert': 1, 'generate': 1\} \(cpu\)$", out, re.M)
    assert re.findall(r"^\[parity\] .*$", out, re.M) == parity
    assert [len(r.tokens_out) for r in reqs] == [8] * 8


def test_launcher_rejects_async_with_the_reference_message(capsys):
    """``--async`` with the paged, chunked, prefix, over-commit or
    telemetry flags stops with the reference launcher's message."""
    from repro_torch.launch.serve import _check_args, build_parser
    ap = build_parser()
    base = ["--arch", "gemma2-2b", "--reduced", "--async"]
    _check_args(ap, ap.parse_args(base + ["--scheduler", "continuous"]))
    for bad in (["--paged-kv"], ["--scheduler", "continuous",
                                 "--prefill-chunk", "4"],
                ["--stats-json", "s.json"],
                ["--scheduler", "continuous", "--trace", "t.json"]):
        with pytest.raises(SystemExit):
            _check_args(ap, ap.parse_args(base + bad))
        assert ("--async serves through the bare engine triad (dense cache, "
                "FIFO admission) — incompatible with --paged-kv/"
                "--prefill-chunk/--prefix-cache/--over-commit and the "
                "telemetry/--stats-json flags") in capsys.readouterr().err
