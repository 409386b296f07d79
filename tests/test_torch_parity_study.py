"""``chip_smoke.py``'s parity studies on the CPU, on reduced internlm2-20b
with the README quickstart's serving flags: ``deploy_tie_gap`` (the
integer path held against fake-quant site by site, rounding ties taken
the integer path's way) and ``serving_sites`` / ``scheduler_pair_apart``
(the ``--parity`` scheduler pair bisected site by site). At this size the
two paths and the two schedulers agree everywhere, so each study is also
shown a planted difference, which it must find where it was planted."""
import collections
import contextlib
import io
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import calibration as cal
from repro_torch.launch import serve as launcher

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

ARGV = ("--arch internlm2-20b --reduced --quantize --deploy-int8 "
        "--kv-bits 8 --scheduler continuous --paged-kv --prefill-chunk 8 "
        "--requests 6 --prompt-len 24 --new-tokens 6 --batch-slots 4 "
        "--block-size 16 --max-len 128").split()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them faster than a pool that
    parallel test workers oversubscribe. Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _planted(when, steps):
    """The DEPLOY path's site input moved by ``steps`` grid steps (random
    signs, seed 0) in row 0 at the calls ``when(site, x)`` picks."""
    real = cal.QuantCtx._apply
    gen = torch.Generator().manual_seed(0)

    def apply(c, site, x, qcfg):
        if c.mode == cal.Mode.DEPLOY:
            if when(site, x):
                s = float(c.act_state[site].scale.max())
                x = x.clone()
                x[0] += steps * s * torch.randn(x[0].shape,
                                                generator=gen).sign()
        return real(c, site, x, qcfg)
    cal.QuantCtx._apply = apply
    try:
        yield
    finally:
        cal.QuantCtx._apply = real


def _deploy_forwards():
    with chip_smoke.parity_forwards() as got, \
            contextlib.redirect_stdout(io.StringIO()):
        launcher.main(ARGV, device="cpu")
    return got


def test_deploy_tie_gap_finds_a_planted_value_apart():
    """No value apart at this size; a value of layer 0's ``q`` moved 1.3
    steps in the integer path is listed as apart in study mode (and taken
    its way), and fails the strict check."""
    got = _deploy_forwards()
    assert chip_smoke.deploy_tie_gap("clean", got, strict=False) == (
        0.0, 0.0, [], [])
    calls = collections.Counter()

    def first(site, x):
        calls[site] += 1
        return site == "layer/attn/q" and calls[site] == 1
    with _planted(first, 1.3):
        before, after, ties, apart = chip_smoke.deploy_tie_gap(
            "planted", got, strict=False)
    assert after <= 1e-4
    assert [(a[0], a[1]) for a in apart] == [("layer/attn/q", 0)]
    assert apart[0][2] >= 1 and apart[0][4] > chip_smoke.TIE_REL
    calls.clear()
    with _planted(first, 1.3), pytest.raises(chip_smoke.SmokeFailure,
                                             match="not one step on a "
                                                   "rounding tie"):
        chip_smoke.deploy_tie_gap("planted", got)


@pytest.mark.parametrize("planted", [False, True])
def test_scheduler_pair_apart_finds_a_planted_value(planted):
    """The quickstart with ``--parity``: both schedulers emit the same
    tokens and nothing is reported; with the static run's last-layer
    ``ffn_out`` of row 0 (request 0) moved 300 steps at its fourth decode
    step (position 27), request 0 parts from there, and the bisect names
    that site, layer and position as the first value apart."""
    n_layers = launcher.get_config("internlm2-20b").reduced().num_layers
    hit = 3 * n_layers + n_layers          # 4th decode step, last layer
    calls = collections.Counter()

    def when(site, x):
        if not (planted and len(sites["runs"]) == 2 and x.shape[1] == 1
                and site == "layer/ffn_out"):
            return False
        calls[site] += 1
        return calls[site] == hit
    with chip_smoke.serving_sites() as sites, _planted(when, 300), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        try:
            launcher.main(ARGV + ["--parity"], device="cpu")
        except SystemExit as e:
            print(e.code)
    assert [len(r) for r in sites["requests"]] == [6, 6]
    res = chip_smoke.scheduler_pair_apart("study", sites)
    if not planted:
        assert "[parity] OK: continuous and static" in out.getvalue()
        assert res == []
        # the values before rounding it records round to the codes it
        # records (K1's recomputed by the plain norm), or lie past them
        # outwards (clipped at the grid's end, under 2 % of them)
        near = total = 0
        for fwd in sites["runs"][0]:
            for site, _, y, x, st in fwd["sites"]:
                if x is not None:
                    d = (y - x).abs() / st.expand(y.shape)
                    assert bool(((d <= 0.5 + 1e-3)
                                 | ((x - y) * y.sign() > 0)).all()), site
                    near += int((d <= 0.5 + 1e-3).sum())
                    total += d.numel()
        assert total > 0 and near >= 0.98 * total, (near, total)
        return
    assert "[parity] FAIL: request ids [0] diverge" in out.getvalue()
    assert len(res) == 1
    rid, pos, site, k, n, steps, dist = res[0]
    assert (rid, pos, site, k) == (0, 27, "layer/ffn_out", n_layers - 1)
    assert n >= 1 and steps >= 1 and dist > chip_smoke.TIE_REL


def test_unrolled_views_are_views_of_the_stacked_draw():
    """Inside ``_unrolled_views`` an unrolled draw after a stacked one of
    the same config and seed holds the same values as a real unrolled
    draw, in the stacked leaves' storage, and the launcher's contexts keep
    no weight memo; outside it both are as before."""
    from repro_torch.core import peg_policy
    from repro_torch.models import transformer as tfm
    cfg = launcher.get_config("internlm2-20b").reduced()
    kw = dict(dtype=torch.float32, device="cpu")
    want = tfm.init_params(cfg, 0, stacked=False, **kw)
    real_init, real_ctx = tfm.init_params, launcher.QuantCtx
    with chip_smoke._unrolled_views():
        stacked = tfm.init_params(cfg, 0, stacked=True, **kw)
        got = tfm.init_params(cfg, 0, stacked=False, **kw)
        ctx = launcher.QuantCtx(policy=peg_policy(4))
    assert tfm.init_params is real_init and launcher.QuantCtx is real_ctx
    assert ctx.weight_cache is None
    assert len(got["layers"]) == len(want["layers"]) == cfg.num_layers
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    base = {t.untyped_storage().data_ptr() for t in _leaves(stacked)}
    assert all(t.untyped_storage().data_ptr() in base
               for t in _leaves(got["layers"]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []



def test_take_ties_takes_only_rounding_ties():
    """``take_ties`` (phase 48's rerun): a byte moved by f32 noise at a
    value one ulp from a rounding boundary is a tie and is taken the
    reference's way; a byte a whole step away is not, and stays."""
    s = 0.5
    f = torch.tensor([[1.0, 2.0, -3.0, 0.75]])         # 0.75 / s = 1.5

    def emit(vals):
        return torch.clamp(torch.round(vals / s), -128, 127).to(torch.int8)
    q = emit(f)
    assert chip_smoke.take_ties(q, f, q, f, s)[1:] == (0, 0)
    tied = f.clone()
    tied[0, 3] = torch.nextafter(torch.tensor(0.75), torch.tensor(0.0))
    moved = tied.clone()
    moved[0, 0] += s                                   # a whole step
    got, n_off, n_taken = chip_smoke.take_ties(emit(moved), moved, q, f, s)
    assert (n_off, n_taken) == (2, 1)
    assert got[0, 3] == q[0, 3] and got[0, 0] == emit(moved)[0, 0] != q[0, 0]


def test_ties_taken_counts_what_parts_from_the_recorded_run():
    """``_emit_records`` then ``_ties_taken`` over the same emitting calls
    (here the merge of partials, plain version): a replay of the recorded
    calls parts nowhere; a planted difference of whole steps parts and is
    not taken."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(0)
    part = torch.randn(2, 1, 4, 2, 10, generator=gen)
    part[..., -1] = part[..., -1].abs() + 1            # the l of each row
    kw = dict(mode="one_pass", out_scale=torch.tensor([0.01]),
              out_zp=torch.tensor([0.0]))
    with chip_smoke._emit_records() as ref:
        a = ops.merge_partials(part, **kw)
        ops.merge_partials(part, mode="one_pass")       # no emit: not a call
    assert len(ref) == 1 and torch.equal(ref[0][1], a)
    with chip_smoke._ties_taken(ref) as same:
        assert torch.equal(ops.merge_partials(part, **kw), a)
    assert same == {"first": None, "taken": 0, "apart": 0, "calls": 1}
    shifted = part.clone()
    shifted[..., 0] += 1.0
    with chip_smoke._ties_taken(ref) as apart:
        ops.merge_partials(shifted, **kw)
    assert apart["first"] == 0 and apart["taken"] == 0
    assert apart["apart"] > 0


def test_k1_emits_are_recorded_and_taken_at_ties():
    """``_emit_records`` records K1 (``rms_quantize``) with its f32 norm
    values and per-column group steps; ``_ties_taken`` takes a byte that
    parts at a rounding tie the recorded way (a tensor step), and a whole
    step apart is counted, not taken."""
    from repro_torch.kernels import fused_ln_quant as lnq
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 16, generator=gen)
    g = torch.zeros(16)
    scale, zp = torch.tensor([0.02, 0.03]), torch.zeros(2)
    kw = dict(qmin=-128, qmax=127)
    with chip_smoke._emit_records() as ref:
        q = ops.rms_quantize(x, g, scale, zp, **kw)
    assert len(ref) == 1
    f, emit, step = ref[0]
    assert torch.equal(emit, q)
    torch.testing.assert_close(f, lnq._normalize(x, g, None, 1e-6, False))
    assert torch.equal(step.reshape(-1), scale.repeat_interleave(8))
    with chip_smoke._ties_taken(ref) as same:
        assert torch.equal(ops.rms_quantize(x, g, scale, zp, **kw), q)
    assert same == {"first": None, "taken": 0, "apart": 0, "calls": 1}
    # plant a tie: move one value onto its rounding boundary in the record
    s0 = step.reshape(-1)[0]
    edge = (torch.floor(f[0, 0] / s0) + 0.5) * s0
    tied_f = f.clone()
    tied_f[0, 0] = edge
    tied_q = q.clone()
    tied_q[0, 0] += 1 if float(f[0, 0]) < float(edge) else -1
    got, n_off, n_taken = chip_smoke.take_ties(q, f, tied_q, tied_f, step)
    assert (n_off, n_taken) == (1, 0)        # this run's value is no tie
    got, n_off, n_taken = chip_smoke.take_ties(tied_q, tied_f, q, tied_f,
                                               step)
    assert (n_off, n_taken) == (1, 1) and torch.equal(got, q)
    shifted = x.clone()
    shifted[1, :4] += 2.0                      # RMSNorm is scale-free
    with chip_smoke._ties_taken(ref) as apart:
        ops.rms_quantize(shifted, g, scale, zp, **kw)
    assert apart["first"] == 0 and apart["apart"] > 0


def test_site_ties_taken_takes_only_rounding_ties():
    """``_site_records`` then ``_site_ties_taken`` over the same
    fake-quant sites: a replay parts nowhere; a value moved onto a
    rounding tie in both runs is taken the recorded way; a value moved by
    whole steps is counted apart."""
    from repro_torch.core import Mode, QuantCtx, peg_policy
    from repro_torch.core.quantizer import QuantParams
    qp = QuantParams(scale=torch.tensor(0.1), zero_point=torch.tensor(0.0))
    ctx = QuantCtx(policy=peg_policy(1), mode=Mode.APPLY,
                   act_state={"layer/ffn_out": qp})
    x = torch.tensor([[0.12, -0.31, 0.449999, 1.0]])
    with chip_smoke._site_records() as ref:
        y = ctx.act("layer/ffn_out", x)
    assert len(ref) == 1 and ref[0][0] == "layer/ffn_out"
    with chip_smoke._site_ties_taken(ref) as same:
        assert torch.equal(ctx.act("layer/ffn_out", x), y)
    assert same == {"first": None, "taken": 0, "apart": 0, "calls": 1}
    tie = x.clone()
    tie[0, 2] = 0.4500001                     # across the boundary at 0.45
    with chip_smoke._site_ties_taken(ref) as got:
        assert torch.equal(ctx.act("layer/ffn_out", tie), y)
    assert got["taken"] == 1 and got["apart"] == 0 and got["first"] == 0
    far = x.clone()
    far[0, 0] = 0.52
    with chip_smoke._site_ties_taken(ref) as apart:
        ctx.act("layer/ffn_out", far)
    assert apart["apart"] == 1 and apart["taken"] == 0
