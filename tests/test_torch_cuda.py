"""The port's CUDA kernels against their plain PyTorch versions on the GPU
(marked ``cuda``; every test skips without a CUDA device). This file
imports no JAX, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Bounds as in ``tests/test_torch_kernels.py``: ``peg_quantize`` and
``peg_fake_quant`` bit-exact, the norm kernels (``rms_quantize``,
``ln_quantize`` and the fake-quant twins) and int8 requant outputs within
1 LSB (one grid step) on at most 0.1 % of elements, f32 matmul outputs
within 1e-5 of max|out| (the build's ``-fmad=false`` makes them agree
exactly in practice). The 4-bit variants (``w_bits=4``, ``kv_bits=4``)
have the bounds of their 8-bit kernels; a w4 matmul also equals the 8-bit
kernel on the unpacked weight.

The decode-attention kernels (K5-K7) take their float reductions in
another order than the plain versions (tiles with an online softmax
against one softmax over all cells): without ``softmax_out`` the outputs
agree within 1e-5 of max|out|; with it a probability within float rounding
of a grid tie may land one step away, so at most 0.1 % of the output rows
may differ, each by at most one ``softmax_out`` step x max|v|.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_ln_quant as lnq
from repro_torch.kernels import int8_attend_decode as iad
from repro_torch.kernels import int8_matmul as imm
from repro_torch.kernels import nibble
from repro_torch.kernels import paged_attend_decode as pad
from repro_torch.kernels import peg_quant as pq
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_lsb(got, want):
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()


def _assert_close(got, want):
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _grid(gen, g):
    s = 0.01 + 0.04 * torch.rand(g, generator=gen, device="cuda")
    z = torch.round(-20 + 40 * torch.rand(g, generator=gen, device="cuda"))
    return s, z


@pytest.mark.parametrize("rows,d,g,dtype", [
    (96, 64, 4, torch.float32), (5, 2304, 1, torch.bfloat16),
    (7, 80, 4, torch.float32)])
def test_rms_quantize(gen, rows, d, g, dtype):
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    gamma = torch.randn(d, generator=gen, device="cuda") * 0.1
    s, z = _grid(gen, g)
    kw = dict(qmin=-128, qmax=127)
    _assert_lsb(lnq.rms_quantize_cuda(x, gamma, s, z, **kw),
                lnq.rms_quantize_plain(x, gamma, s, z, **kw))


@pytest.mark.parametrize("rows,d,g", [(96, 64, 4), (3, 2048, 1), (5, 18, 2)])
def test_peg_quantize(gen, rows, d, g):
    x = torch.randn(rows, d, generator=gen, device="cuda") * 2
    s, z = _grid(gen, g)
    kw = dict(qmin=-128, qmax=127)
    assert torch.equal(pq.peg_quantize_cuda(x, s, z, **kw),
                       pq.peg_quantize_plain(x, s, z, **kw))


@pytest.mark.parametrize("m,k,n", [(37, 64, 128), (1, 80, 48),
                                   (300, 2304, 96)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul(gen, m, k, n, requant):
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    cs = ref.w_colsum_groups(w, 1)[0]
    kw = dict(z_a=5.0, w_colsum=cs, bias=torch.randn(
        n, generator=gen, device="cuda"), activation="relu")
    if requant:
        kw.update(out_scale=0.5, out_zp=-3.0)
    got = imm.int8_matmul_cuda(a, w, 0.03, 0.01, **kw)
    want = imm.int8_matmul_plain(a, w, 0.03, 0.01, **kw)
    (_assert_lsb if requant else _assert_close)(got, want)


@pytest.mark.parametrize("m,k,n,g", [(37, 64, 128, 4), (4, 80, 48, 4),
                                     (20, 2304, 64, 6)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_peg(gen, m, k, n, g, requant):
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s, z = _grid(gen, g)
    cs = ref.w_colsum_groups(w, g)
    kw = {}
    if requant:
        kw = dict(activation="gelu", out_scale=0.04, out_zp=-7.0,
                  mul=torch.randn(m, n, generator=gen, device="cuda"))
    got = imm.int8_matmul_peg_cuda(a, w, s, z, 0.02, cs, **kw)
    want = imm.int8_matmul_peg_plain(a, w, s, z, 0.02, cs, **kw)
    (_assert_lsb if requant else _assert_close)(got, want)


def assert_attend_close(got, want, smo_step, v_absmax):
    """The decode-attention bounds of the module docstring; returns the
    max |got - want|."""
    err = (got - want).abs()
    worst = float(err.max())
    if smo_step is None:
        assert worst <= 1e-5 * float(want.abs().max()), worst
        return worst
    rows = err.amax(dim=-1)
    off = rows > 1e-5 * float(want.abs().max())
    assert int(off.sum()) <= 1e-3 * rows.numel(), int(off.sum())
    assert worst <= smo_step * v_absmax * (1 + 1e-5), worst
    return worst


def _attend_inputs(gen, b, s_len, kv, g, hd, *, zero_points):
    """int8 queries (b, kv, g, hd) and a (b, s_len, kv, hd) int8 cache
    with its scales; zero-points round in [-20, 20] or zeros."""
    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def ru(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    def zp(*shape):
        return torch.round(ru(-20, 20, *shape)) if zero_points else \
            torch.zeros(shape, device="cuda")
    return dict(q_q=ri(b, kv, g, hd), q_scale=ru(0.01, 0.03, b, kv, g) / 16,
                k_q=ri(b, s_len, kv, hd),
                k_scale=ru(0.01, 0.05, b, s_len, kv),
                v_q=ri(b, s_len, kv, hd),
                v_scale=ru(0.01, 0.05, b, s_len, kv), q_zp=zp(b, kv, g),
                k_zp=zp(b, kv), v_zp=zp(b, kv))


def _v_absmax(x):
    """An upper bound of max |(v - z_v) * v_scale|."""
    return float((x["v_q"].float().abs().max() + x["v_zp"].abs().max())
                 * x["v_scale"].max())


SITES = {"none": {},
         "softmax_in": dict(sm_quant=[0.05, 128.0], sm_qmin=0, sm_qmax=255),
         "softmax_out": dict(sm_quant=[0.05, 128.0], sm_qmin=0, sm_qmax=255,
                             smo_quant=[1 / 255, 0.0], smo_qmin=0,
                             smo_qmax=255)}


def _site_kw(name):
    kw = dict(sm_quant=None, sm_qmin=0, sm_qmax=255, smo_quant=None,
              smo_qmin=0, smo_qmax=255)
    for k, v in SITES[name].items():
        kw[k] = torch.tensor(v, device="cuda") if isinstance(v, list) else v
    return kw


@pytest.mark.parametrize("b,s_len,kv,g,hd,window", [
    (4, 128, 4, 2, 256, 64), (3, 40, 2, 2, 16, 16), (2, 300, 1, 8, 64, None)])
@pytest.mark.parametrize("site", list(SITES))
def test_int8_attend_decode(gen, b, s_len, kv, g, hd, window, site):
    x = _attend_inputs(gen, b, s_len, kv, g, hd, zero_points=site != "none")
    k_pos = torch.arange(s_len, device="cuda", dtype=torch.int32).repeat(
        b, 1)
    k_pos[0, :3] = -1
    q_pos = torch.full((b,), s_len - 1, device="cuda", dtype=torch.int32)
    q_pos[-1] = -1                                      # an idle lane
    kw = dict(window=window, logit_softcap=50.0, **_site_kw(site))
    args = (x["q_q"], x["q_scale"], x["q_zp"], x["k_zp"], x["v_zp"],
            x["k_q"], x["k_scale"], x["v_q"], x["v_scale"], k_pos, q_pos)
    got = iad.int8_attend_decode_cuda(*args, **kw)
    want = iad.int8_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                        else None, _v_absmax(x))


def _table(gen, b, nb, n_blocks):
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    table[0, -1] = -1                                    # unmapped tail
    return table


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", [
    (4, 8, 16, 4, 2, 256, 128, 64), (3, 8, 8, 2, 2, 16, 16, 16),
    (4, 4, 16, 2, 2, 32, 64, None)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("quant", [True, False])
def test_paged_attend_decode(gen, b, nb, bs, kv, g, hd, s_cap, window, site,
                             quant):
    n_blocks = b * nb + 3
    table = _table(gen, b, nb, n_blocks)
    q_pos = torch.tensor([s_cap + 5, s_cap // 2, 0, -1][:b], device="cuda",
                         dtype=torch.int32)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              **_site_kw(site))
    x = _attend_inputs(gen, n_blocks, bs, kv, g, hd,
                       zero_points=site != "none" and quant)
    q_q = x["q_q"][:b].contiguous()
    cols = table[:, :-(-s_cap // bs)].contiguous()
    if quant:
        args = (q_q, x["q_scale"][:b], x["q_zp"][:b], x["k_zp"][:b],
                x["v_zp"][:b], x["k_q"], x["k_scale"], x["v_q"],
                x["v_scale"], cols, q_pos)
        got = pad.paged_int8_attend_decode_cuda(*args, **kw)
        want = pad.paged_int8_attend_decode_plain(*args, **kw)
        v_abs = _v_absmax(x)
    else:
        q = q_q.float() * 0.01
        kf = x["k_q"].float() * 0.02
        vf = (x["v_q"].float() * 0.02).to(torch.bfloat16)
        args = (q, kf, vf.float(), cols, q_pos)
        got = pad.paged_attend_decode_cuda(*args, **kw)
        want = pad.paged_attend_decode_plain(*args, **kw)
        assert_attend_close(
            pad.paged_attend_decode_cuda(q, kf.to(torch.bfloat16), vf, cols,
                                         q_pos, **kw),
            pad.paged_attend_decode_plain(q, kf.to(torch.bfloat16), vf,
                                          cols, q_pos, **kw),
            1 / 255 if site == "softmax_out" else None,
            float(vf.float().abs().max()))
        v_abs = float(vf.float().abs().max())
    torch.cuda.synchronize()
    assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)


@pytest.mark.parametrize("rows,d,g,dtype", [
    (96, 64, 4, torch.float32), (64, 2304, 4, torch.bfloat16),
    (7, 80, 1, torch.float32)])
@pytest.mark.parametrize("kernel", ["ln_quantize", "ln_fake_quant",
                                    "rms_fake_quant"])
def test_norm_quant_variants(gen, rows, d, g, dtype, kernel):
    """K8, K9b, K9a: the int8 emit within 1 LSB on at most 0.1 % of
    elements; the fake-quant outputs equal but for such flips (one grid
    step each, plus the rounding of a bf16 output)."""
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    gamma = 1 + torch.randn(d, generator=gen, device="cuda") * 0.1
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    s, z = _grid(gen, g)
    affine = (gamma, beta) if kernel.startswith("ln") else (gamma,)
    kw = dict(qmin=-128, qmax=127)
    got = getattr(lnq, kernel + "_cuda")(x, *affine, s, z, **kw)
    want = getattr(lnq, kernel + "_plain")(x, *affine, s, z, **kw)
    torch.cuda.synchronize()
    if kernel == "ln_quantize":
        _assert_lsb(got, want)
        return
    assert got.dtype == x.dtype
    err = (got.float() - want.float()).abs()
    step = s.repeat_interleave(d // g)[None, :]
    off = err > 0
    assert int(off.sum()) <= 1e-3 * err.numel()
    eps = torch.finfo(dtype).eps          # the output dtype's rounding
    assert bool((err <= step * 1.01 + want.float().abs() * eps).all())


@pytest.mark.parametrize("rows,d,g,dtype", [
    (96, 64, 4, torch.float32), (5, 18, 2, torch.float32),
    (64, 2304, 1, torch.bfloat16)])
def test_peg_fake_quant(gen, rows, d, g, dtype):
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 2).to(dtype)
    s, z = _grid(gen, g)
    kw = dict(qmin=-128, qmax=127)
    got = pq.peg_fake_quant_cuda(x, s, z, **kw)
    assert got.dtype == dtype
    assert torch.equal(got, pq.peg_fake_quant_plain(x, s, z, **kw))


def _w4(gen, k, n):
    w = torch.randint(-7, 8, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    return w, nibble.pack_rows(w)


@pytest.mark.parametrize("m,k,n", [(37, 64, 128), (1, 80, 48),
                                   (64, 2304, 96), (4, 2304, 64)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_w4(gen, m, k, n, requant):
    """w_bits=4 against the plain version, and against the 8-bit kernel on
    the unpacked weight (the same integer product)."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w, w_pk = _w4(gen, k, n)
    cs = ref.w_colsum_groups(w, 1)[0]
    kw = dict(z_a=5.0, w_colsum=cs, bias=torch.randn(
        n, generator=gen, device="cuda"), activation="relu")
    if requant:
        kw.update(out_scale=0.5, out_zp=-3.0)
    got = imm.int8_matmul_cuda(a, w_pk, 0.03, 0.01, w_bits=4, **kw)
    want = imm.int8_matmul_plain(a, w_pk, 0.03, 0.01, w_bits=4, **kw)
    (_assert_lsb if requant else _assert_close)(got, want)
    assert torch.equal(got, imm.int8_matmul_cuda(a, w, 0.03, 0.01, **kw))


@pytest.mark.parametrize("m,k,n,g", [(37, 64, 128, 4), (4, 64, 48, 4),
                                     (20, 2304, 64, 4), (4, 80, 64, 2)])
@pytest.mark.parametrize("requant", [False, True])
def test_int8_matmul_peg_w4(gen, m, k, n, g, requant):
    """PEG at w_bits=4; K = 64, G = 4 are the reduced width's 16-wide
    groups (8 packed rows, a zero-padded k32 step each)."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w, w_pk = _w4(gen, k, n)
    s, z = _grid(gen, g)
    cs = ref.w_colsum_groups(w, g)
    kw = {}
    if requant:
        kw = dict(activation="gelu", out_scale=0.04, out_zp=-7.0,
                  mul=torch.randn(m, n, generator=gen, device="cuda"))
    got = imm.int8_matmul_peg_cuda(a, w_pk, s, z, 0.02, cs, w_bits=4, **kw)
    want = imm.int8_matmul_peg_plain(a, w_pk, s, z, 0.02, cs, w_bits=4,
                                     **kw)
    (_assert_lsb if requant else _assert_close)(got, want)
    assert torch.equal(got, imm.int8_matmul_peg_cuda(a, w, s, z, 0.02, cs,
                                                     **kw))


def _kv4(x, gen):
    """Replace the int8 cache of an _attend_inputs case by int4 values,
    nibble-packed, with int4 zero-points."""
    for name in ("k_q", "v_q"):
        vals = torch.randint(-8, 8, x[name].shape, generator=gen,
                             device="cuda", dtype=torch.int8)
        x[name] = nibble.pack_nibbles(vals)
    for name in ("k_zp", "v_zp"):
        x[name] = torch.clamp(x[name], -3, 3)
    return x


def _v4_absmax(x):
    return float((8 + x["v_zp"].abs().max()) * x["v_scale"].max())


@pytest.mark.parametrize("b,s_len,kv,g,hd,window", [
    (4, 128, 4, 2, 256, 64), (3, 40, 2, 2, 16, 16)])
@pytest.mark.parametrize("site", list(SITES))
def test_int8_attend_decode_kv4(gen, b, s_len, kv, g, hd, window, site):
    x = _kv4(_attend_inputs(gen, b, s_len, kv, g, hd,
                            zero_points=site != "none"), gen)
    k_pos = torch.arange(s_len, device="cuda", dtype=torch.int32).repeat(
        b, 1)
    k_pos[0, :3] = -1
    q_pos = torch.full((b,), s_len - 1, device="cuda", dtype=torch.int32)
    q_pos[-1] = -1                                      # an idle lane
    kw = dict(window=window, logit_softcap=50.0, kv_bits=4, **_site_kw(site))
    args = (x["q_q"], x["q_scale"], x["q_zp"], x["k_zp"], x["v_zp"],
            x["k_q"], x["k_scale"], x["v_q"], x["v_scale"], k_pos, q_pos)
    got = iad.int8_attend_decode_cuda(*args, **kw)
    want = iad.int8_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                        else None, _v4_absmax(x))


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", [
    (4, 8, 16, 4, 2, 256, 128, 64), (3, 8, 8, 2, 2, 16, 16, 16)])
@pytest.mark.parametrize("site", list(SITES))
def test_paged_int8_attend_decode_kv4(gen, b, nb, bs, kv, g, hd, s_cap,
                                      window, site):
    n_blocks = b * nb + 3
    table = _table(gen, b, nb, n_blocks)
    q_pos = torch.tensor([s_cap + 5, s_cap // 2, 0, -1][:b], device="cuda",
                         dtype=torch.int32)
    x = _kv4(_attend_inputs(gen, n_blocks, bs, kv, g, hd,
                            zero_points=site != "none"), gen)
    cols = table[:, :-(-s_cap // bs)].contiguous()
    args = (x["q_q"][:b].contiguous(), x["q_scale"][:b], x["q_zp"][:b],
            x["k_zp"][:b], x["v_zp"][:b], x["k_q"], x["k_scale"], x["v_q"],
            x["v_scale"], cols, q_pos)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0, kv_bits=4,
              **_site_kw(site))
    got = pad.paged_int8_attend_decode_cuda(*args, **kw)
    want = pad.paged_int8_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                        else None, _v4_absmax(x))


def test_reduced_deploy_serve_launches_every_kernel(gen):
    from repro_torch.launch import serve
    fns = (lnq.rms_quantize_cuda, pq.peg_quantize_cuda,
           imm.int8_matmul_cuda, imm.int8_matmul_peg_cuda)
    for fn in fns:
        fn.launches = 0
    stats = serve.main(["--arch", "gemma2-2b", "--reduced", "--requests", "3",
                        "--prompt-len", "8", "--new-tokens", "3",
                        "--quantize", "--deploy-int8"])
    assert stats.tokens_generated == 9
    assert all(fn.launches > 0 for fn in fns)
    assert np.isfinite(stats.tokens_per_s)


def test_quickstart_serves_launch_the_attention_kernels(gen):
    """The README quickstart at reduced width goes through K1-K6; the same
    command with an f32 paged cache goes through K7 and its int8 emit."""
    from repro_torch.launch import serve
    argv = ["--arch", "gemma2-2b", "--reduced", "--requests", "6",
            "--prompt-len", "24", "--new-tokens", "6", "--max-len", "64",
            "--quantize", "--deploy-int8", "--scheduler", "continuous",
            "--paged-kv", "--block-size", "8", "--prefill-chunk", "8"]
    fns = (lnq.rms_quantize_cuda, pq.peg_quantize_cuda, imm.int8_matmul_cuda,
           imm.int8_matmul_peg_cuda, iad.int8_attend_decode_cuda,
           pad.paged_int8_attend_decode_cuda, pad.paged_attend_decode_cuda)
    for kv_bits, used in (("8", fns[:6]), ("16", fns[6:])):
        for fn in fns:
            fn.launches = 0
        pad.paged_attend_decode_cuda.launches_emit = 0
        stats = serve.main(argv + ["--kv-bits", kv_bits, "--parity"])
        assert stats.tokens_generated == 36
        assert all(fn.launches > 0 for fn in used), kv_bits
    # the kv16 decode steps emit wo's int8 input from K7's merge
    assert pad.paged_attend_decode_cuda.launches_emit > 0


def test_4bit_quickstart_launches_the_4bit_variants(gen):
    """The quickstart at --weight-bits 4 --kv-bits 4 goes through the w4
    matmuls (K2, K3) and the kv4 decode kernels (K5 in the [kv-int4] check,
    K6 in every decode step), and serves the reference's counts."""
    from repro_torch.launch import serve
    for fn in (imm.int8_matmul_cuda, imm.int8_matmul_peg_cuda):
        fn.launches_w4 = 0
    for fn in (iad.int8_attend_decode_cuda,
               pad.paged_int8_attend_decode_cuda):
        fn.launches_kv4 = 0
    stats = serve.main([
        "--arch", "gemma2-2b", "--reduced", "--requests", "6",
        "--prompt-len", "24", "--new-tokens", "6", "--max-len", "64",
        "--quantize", "--deploy-int8", "--kv-bits", "4", "--weight-bits",
        "4", "--scheduler", "continuous", "--paged-kv", "--block-size", "8",
        "--prefill-chunk", "8"])
    assert (stats.tokens_generated, stats.decode_steps, stats.prefill_calls,
            stats.blocks_in_use, stats.chunk_steps) == (36, 10, 6, 16, 6)
    assert imm.int8_matmul_cuda.launches_w4 > 0
    assert imm.int8_matmul_peg_cuda.launches_w4 > 0
    assert iad.int8_attend_decode_cuda.launches_kv4 > 0
    assert pad.paged_int8_attend_decode_cuda.launches_kv4 > 0


# -- the split kernels: K3 split-K, K6 split-KV ------------------------------

@pytest.mark.parametrize("m,k,n", [(4, 2304, 2048), (1, 2304, 48),
                                   (16, 2304, 1024), (17, 2304, 2304),
                                   (64, 2304, 2048), (4, 80, 48),
                                   (5, 4160, 96), (3, 2312, 40)])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_int8_matmul_split_k(gen, m, k, n, w_bits):
    """Split-K at split-boundary shapes (M 16 / 17 switches the row tile,
    K = 80 is one split, K = 4160 an odd tile count, K = 2312 and N = 40
    no multiples of 16, so the tiles are loaded without cp.async): the f32
    output is bit-identical to the plain version and over three calls; the
    requant output within 1 LSB."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    if w_bits == 4:
        w, w_q = _w4(gen, k, n)
    else:
        w = w_q = torch.randint(-127, 128, (k, n), generator=gen,
                                device="cuda", dtype=torch.int8)
    kw = dict(z_a=5.0, w_colsum=ref.w_colsum_groups(w, 1)[0],
              bias=torch.randn(n, generator=gen, device="cuda"),
              activation="relu", w_bits=w_bits)
    got = [imm.int8_matmul_cuda(a, w_q, 0.03, 0.01, **kw) for _ in range(3)]
    want = imm.int8_matmul_plain(a, w_q, 0.03, 0.01, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)
    assert all(torch.equal(x, got[0]) for x in got[1:])
    kw.update(out_scale=0.5, out_zp=-3.0)
    _assert_lsb(imm.int8_matmul_cuda(a, w_q, 0.03, 0.01, **kw),
                imm.int8_matmul_plain(a, w_q, 0.03, 0.01, **kw))


def _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site, kv_bits):
    """A K6 case with holes: a whole split unmapped on lane 0, an
    unmapped tail on lane 1, lane 2 idle, lane 3 wrapped past s_cap."""
    n_blocks = b * nb + 3
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    if splits > 2:
        table[0, bps:2 * bps] = -1
    table[1, nb - 1:] = -1
    q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1][:b],
                         device="cuda", dtype=torch.int32)
    x = _attend_inputs(gen, n_blocks, bs, kv, g, hd,
                       zero_points=site != "none")
    if kv_bits == 4:
        x = _kv4(x, gen)
    args = (x["q_q"][:b].contiguous(), x["q_scale"][:b], x["q_zp"][:b],
            x["k_zp"][:b], x["v_zp"][:b], x["k_q"], x["k_scale"], x["v_q"],
            x["v_scale"], table, q_pos)
    v_abs = _v4_absmax(x) if kv_bits == 4 else _v_absmax(x)
    return args, v_abs


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", [
    (4, 37, 16, 4, 2, 256, 587, 200), (4, 52, 8, 2, 2, 64, 413, None),
    (4, 256, 16, 4, 2, 256, 4096, 2048), (3, 8, 8, 2, 2, 16, 64, 16)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_int8_attend_decode_splits(gen, b, nb, bs, kv, g, hd, s_cap,
                                         window, site, kv_bits):
    """Split-KV at split boundaries (nb not a multiple of the blocks per
    split, bs 8, 32 splits of 8 blocks, a hole covering a whole split, an
    idle lane): against the plain version, and bit-identical over three
    calls (fixed merge order, no float atomics)."""
    args, v_abs = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site,
                              kv_bits)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              kv_bits=kv_bits, **_site_kw(site))
    got = [pad.paged_int8_attend_decode_cuda(*args, **kw) for _ in range(3)]
    want = pad.paged_int8_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got[0], want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)
    assert all(torch.equal(x, got[0]) for x in got[1:])


def test_split_workspaces_are_left_clean(gen):
    """Back-to-back calls of other shapes share each kernel's workspace
    and arrival counters; every call still equals its plain version, so no
    call leaves a counter or a partial behind for the next."""
    for m, k, n in ((4, 2304, 2048), (64, 2304, 2048), (1, 2304, 48),
                    (17, 4160, 96), (4, 2304, 2048)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        assert torch.equal(imm.int8_matmul_cuda(a, w, 0.03, 0.01),
                           imm.int8_matmul_plain(a, w, 0.03, 0.01))
    for shape, site, kv_bits in (
            ((4, 8, 16, 4, 2, 256, 128, 64), "softmax_out", 8),
            ((4, 256, 16, 4, 2, 256, 4096, 2048), "none", 8),
            ((3, 8, 8, 2, 2, 16, 64, 16), "softmax_out", 4),
            ((4, 8, 16, 4, 2, 256, 128, 64), "none", 4),
            ((4, 8, 16, 4, 2, 256, 128, 64), "softmax_out", 8)):
        b, nb, bs, kv, g, hd, s_cap, window = shape
        args, v_abs = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site,
                                  kv_bits)
        kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                  kv_bits=kv_bits, **_site_kw(site))
        got = pad.paged_int8_attend_decode_cuda(*args, **kw)
        want = pad.paged_int8_attend_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                            else None, v_abs)


# -- the row split of K1, K8, K9; K5 on the split-KV body --------------------

NORM_KERNELS = ("rms_quantize", "ln_quantize", "rms_fake_quant",
                "ln_fake_quant")


def _norm_case(gen, kernel, rows, d, g, dtype):
    x = (torch.randn(rows, d, generator=gen, device="cuda") * 3).to(dtype)
    gamma = 1 + torch.randn(d, generator=gen, device="cuda") * 0.1
    beta = torch.randn(d, generator=gen, device="cuda") * 0.1
    s, z = _grid(gen, g)
    affine = (gamma, beta) if kernel.startswith("ln") else (gamma,)
    return (x, *affine, s, z)


def _assert_norm_close(kernel, got, want, s, d):
    """The int8 emit within 1 LSB on at most 0.1 % of elements; a
    fake-quant output equal but for such flips (one grid step each, plus
    the rounding of its dtype)."""
    if kernel.endswith("_quantize"):
        _assert_lsb(got, want)
        return
    assert got.dtype == want.dtype
    err = (got.float() - want.float()).abs()
    step = s.repeat_interleave(d // s.numel())[None, :]
    assert int((err > 0).sum()) <= 1e-3 * err.numel()
    eps = torch.finfo(got.dtype).eps
    assert bool((err <= step * 1.01 + want.float().abs() * eps).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("d", [64, 2304, 4096])
@pytest.mark.parametrize("rows", [1, 4, 64, 4096])
@pytest.mark.parametrize("kernel", NORM_KERNELS)
def test_norm_quant_cluster_boundaries(gen, kernel, rows, d, g, dtype):
    """K1, K8, K9a, K9b at the row split's boundaries: C = 16 for 1 and 4
    rows at d 2304 and 4096, C = 2 for 64 rows, C = 1 for 4096 rows and at
    d = 64 (fused_ln_quant.plan_row_split). Against the plain version, and
    bit-identical over two calls (a fixed exchange order, no atomics)."""
    args = _norm_case(gen, kernel, rows, d, g, dtype)
    kw = dict(qmin=-128, qmax=127)
    cuda = getattr(lnq, kernel + "_cuda")
    got = [cuda(*args, **kw) for _ in range(2)]
    want = getattr(lnq, kernel + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    _assert_norm_close(kernel, got[0], want, args[-2], d)
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,d,g", [(4, 602, 1), (64, 1802, 2),
                                      (3, 80, 4)])
@pytest.mark.parametrize("kernel", NORM_KERNELS)
def test_norm_quant_one_column_vectors(gen, kernel, rows, d, g, dtype):
    """Widths and groups that go in no whole 8-column vectors take the
    1-column body (C = 1), with 1, 2 and 4 vectors per thread."""
    args = _norm_case(gen, kernel, rows, d, g, dtype)
    kw = dict(qmin=-128, qmax=127)
    got = getattr(lnq, kernel + "_cuda")(*args, **kw)
    want = getattr(lnq, kernel + "_plain")(*args, **kw)
    torch.cuda.synchronize()
    _assert_norm_close(kernel, got, want, args[-2], d)


def test_norm_quant_back_to_back_shapes(gen):
    """Calls of other shapes, splits and dtypes in a row, and an unaligned
    row view (the 1-column vector path): each equals its plain version and
    a repeat of the first shape repeats its bits."""
    kw = dict(qmin=-128, qmax=127)
    first = None
    for kernel, rows, d, g, dtype in (
            ("rms_quantize", 4, 2304, 1, torch.bfloat16),
            ("rms_quantize", 64, 2304, 4, torch.bfloat16),
            ("ln_fake_quant", 4096, 4096, 8, torch.float32),
            ("rms_fake_quant", 1, 2304, 6, torch.bfloat16),
            ("ln_quantize", 96, 64, 4, torch.float32),
            ("rms_quantize", 7, 80, 4, torch.float32)):
        args = _norm_case(gen, kernel, rows, d, g, dtype)
        got = getattr(lnq, kernel + "_cuda")(*args, **kw)
        _assert_norm_close(kernel, got,
                           getattr(lnq, kernel + "_plain")(*args, **kw),
                           args[-2], d)
        if first is None:
            first = (args, got)
    again = lnq.rms_quantize_cuda(*first[0], **kw)
    assert torch.equal(again, first[1])
    x, gamma, s, z = first[0]
    view = x.new_empty(x.numel() + 1)[1:].view(x.shape)
    view.copy_(x)                               # rows not 16-byte aligned
    assert view.data_ptr() % 16 != 0
    _assert_lsb(lnq.rms_quantize_cuda(view, gamma, s, z, **kw),
                lnq.rms_quantize_plain(view, gamma, s, z, **kw))


def _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits):
    """A K5 case at the split boundaries: an empty run over a whole split
    (lane 0), a short lane with an empty prefix (lane 1), an idle lane
    (lane 2) and a ring that wrapped (lane 3: slot c holds the newest
    position congruent to c)."""
    x = _attend_inputs(gen, b, s_len, kv, g, hd, zero_points=site != "none")
    if kv_bits == 4:
        x = _kv4(x, gen)
    splits, cps = iad.plan_dense_kv_splits(b, kv, s_len)
    cells = torch.arange(s_len, device="cuda", dtype=torch.int32)
    q_pos = torch.tensor([s_len - 1, s_len // 3, -1, 2 * s_len - 6][:b],
                         device="cuda", dtype=torch.int32)
    k_pos = cells.repeat(b, 1)
    if splits > 2:
        k_pos[0, cps:2 * cps] = -1
    k_pos[1, :5] = -1
    if b > 3:
        k_pos[3] = q_pos[3] - (q_pos[3] - cells) % s_len
    args = (x["q_q"], x["q_scale"], x["q_zp"], x["k_zp"], x["v_zp"],
            x["k_q"], x["k_scale"], x["v_q"], x["v_scale"], k_pos, q_pos)
    return args, _v4_absmax(x) if kv_bits == 4 else _v_absmax(x)


@pytest.mark.parametrize("b,s_len,kv,g,hd,window", [
    (4, 587, 4, 2, 256, 200), (4, 413, 2, 2, 64, None),
    (4, 4096, 4, 2, 256, 2048), (3, 40, 2, 2, 16, 16),
    (4, 16, 4, 2, 256, None), (2, 300, 1, 8, 64, None)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_int8_attend_decode_splits(gen, b, s_len, kv, g, hd, window, site,
                                   kv_bits):
    """K5 and K5-kv4 on the split-KV body at split boundaries (S not a
    multiple of the split length, one split, 32 splits of 128 cells, G =
    8), with an empty split, an empty prefix, an idle lane and a wrapped
    ring: against the plain version, and bit-identical over three calls."""
    args, v_abs = _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits)
    kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
              **_site_kw(site))
    got = [iad.int8_attend_decode_cuda(*args, **kw) for _ in range(3)]
    want = iad.int8_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got[0], want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)
    assert all(torch.equal(x, got[0]) for x in got[1:])


def test_dense_split_workspace_is_left_clean(gen):
    """K5 and K6 share the split-KV workspace and counters of a stream:
    calls of both, at other shapes and schedules, back to back, each equal
    to its plain version."""
    for kind, shape, site, kv_bits in (
            ("dense", (4, 128, 4, 2, 256, 64), "softmax_out", 8),
            ("paged", (4, 8, 16, 4, 2, 256, 128, 64), "none", 8),
            ("dense", (4, 4096, 4, 2, 256, 2048), "none", 4),
            ("dense", (3, 40, 2, 2, 16, 16), "softmax_out", 4),
            ("paged", (4, 256, 16, 4, 2, 256, 4096, 2048), "softmax_out", 8),
            ("dense", (4, 128, 4, 2, 256, 64), "softmax_out", 8)):
        if kind == "dense":
            b, s_len, kv, g, hd, window = shape
            args, v_abs = _dense_case(gen, b, s_len, kv, g, hd, site,
                                      kv_bits)
            kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
                      **_site_kw(site))
            got = iad.int8_attend_decode_cuda(*args, **kw)
            want = iad.int8_attend_decode_plain(*args, **kw)
        else:
            b, nb, bs, kv, g, hd, s_cap, window = shape
            args, v_abs = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site,
                                      kv_bits)
            kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                      kv_bits=kv_bits, **_site_kw(site))
            got = pad.paged_int8_attend_decode_cuda(*args, **kw)
            want = pad.paged_int8_attend_decode_plain(*args, **kw)
        torch.cuda.synchronize()
        assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                            else None, v_abs)


# -- K2 split by PEG group spans; K5/K6 emitting the int8 wo input ----------

@pytest.mark.parametrize("m,k,n,g", [
    (64, 2304, 512, 4), (4, 2304, 1024, 4), (17, 2304, 256, 6),
    (8, 64, 128, 4), (1, 1024, 48, 1), (16, 4096, 128, 4),
    (4, 1152, 64, 36), (3, 80, 40, 5), (33, 192, 96, 2)])
@pytest.mark.parametrize("w_bits", [8, 4])
def test_int8_matmul_peg_splits(gen, m, k, n, g, w_bits):
    """K2 on the split mainloop at its plan's boundaries (one run per
    group, several, one-tile 16-wide groups, G = 36 walked in rounds of 16,
    N = 40 and 16-wide groups of K = 80 loaded without cp.async): the f32
    output is bit-identical to the plain version (the group fold in group
    order) and over three calls; the requant output within 1 LSB; at 4
    bits equal to the 8-bit kernel on the unpacked weight."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    if w_bits == 4:
        w, w_q = _w4(gen, k, n)
    else:
        w = w_q = torch.randint(-127, 128, (k, n), generator=gen,
                                device="cuda", dtype=torch.int8)
    s, z = _grid(gen, g)
    cs = ref.w_colsum_groups(w, g)
    kw = dict(w_bits=w_bits, bias=torch.randn(n, generator=gen,
                                              device="cuda"))
    got = [imm.int8_matmul_peg_cuda(a, w_q, s, z, 0.02, cs, **kw)
           for _ in range(3)]
    want = imm.int8_matmul_peg_plain(a, w_q, s, z, 0.02, cs, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want)
    assert all(torch.equal(x, got[0]) for x in got[1:])
    kw.update(activation="gelu", out_scale=0.04, out_zp=-7.0,
              mul=torch.randn(m, n, generator=gen, device="cuda"))
    got = imm.int8_matmul_peg_cuda(a, w_q, s, z, 0.02, cs, **kw)
    _assert_lsb(got, imm.int8_matmul_peg_plain(a, w_q, s, z, 0.02, cs, **kw))
    if w_bits == 4:
        kw["w_bits"] = 8
        assert torch.equal(got, imm.int8_matmul_peg_cuda(a, w, s, z, 0.02,
                                                         cs, **kw))


def _emit_grid(f):
    """A per-tensor int8 grid that spans the f32 output ``f``."""
    return (torch.tensor([float(f.abs().max()) / 100], device="cuda"),
            torch.tensor([3.0], device="cuda"))


def _assert_emit(fn, args, kw):
    """The int8 emit of one decode-attention call equals K4's kernel on
    the same call's f32 output, bit for bit."""
    f = fn(*args, **kw)
    s_o, z_o = _emit_grid(f)
    got = fn(*args, **kw, out_scale=s_o, out_zp=z_o, qmin=-128, qmax=127)
    want = pq.peg_quantize_cuda(f.reshape(f.shape[0], -1), s_o, z_o,
                                qmin=-128, qmax=127)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", [
    (4, 8, 16, 4, 2, 256, 128, 64), (4, 37, 16, 4, 2, 256, 587, 200),
    (4, 52, 8, 2, 2, 64, 413, None), (3, 8, 8, 2, 2, 16, 64, 16)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_paged_int8_attend_decode_emit(gen, b, nb, bs, kv, g, hd, s_cap,
                                       window, site, kv_bits):
    """K6 emitting the wo input from its merge, one and two passes, at split
    boundaries with a whole split unmapped and an idle lane: K4's bytes on
    K6's own f32 output; the emit is counted apart."""
    args, _ = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site, kv_bits)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              kv_bits=kv_bits, **_site_kw(site))
    fn = pad.paged_int8_attend_decode_cuda
    before = fn.launches_emit
    _assert_emit(fn, args, kw)
    assert fn.launches_emit == before + 1


@pytest.mark.parametrize("b,s_len,kv,g,hd,window", [
    (4, 128, 4, 2, 256, 64), (4, 587, 4, 2, 256, 200),
    (4, 413, 2, 2, 64, None), (3, 40, 2, 2, 16, 16)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_int8_attend_decode_emit(gen, b, s_len, kv, g, hd, window, site,
                                 kv_bits):
    """K5 emitting the wo input, with an empty split, an empty prefix, an
    idle lane and a wrapped ring: K4's bytes on K5's own f32 output."""
    args, _ = _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits)
    kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
              **_site_kw(site))
    fn = iad.int8_attend_decode_cuda
    before = fn.launches_emit
    _assert_emit(fn, args, kw)
    assert fn.launches_emit == before + 1


def test_peg_and_emit_back_to_back_shapes(gen):
    """K2 calls of other plans back to back, and K5 / K6 emitting and f32
    calls alternating on their shared workspace: each equal to its plain
    version or to K4 on the f32 output."""
    for m, k, n, g in ((64, 2304, 512, 4), (8, 64, 128, 4), (4, 1152, 64, 36),
                       (17, 2304, 256, 6), (64, 2304, 512, 4)):
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        s, z = _grid(gen, g)
        cs = ref.w_colsum_groups(w, g)
        assert torch.equal(imm.int8_matmul_peg_cuda(a, w, s, z, 0.02, cs),
                           imm.int8_matmul_peg_plain(a, w, s, z, 0.02, cs))
    for kind, shape, site, kv_bits in (
            ("paged", (4, 8, 16, 4, 2, 256, 128, 64), "softmax_out", 8),
            ("dense", (4, 128, 4, 2, 256, 64), "softmax_out", 4),
            ("paged", (4, 37, 16, 4, 2, 256, 587, 200), "none", 4),
            ("dense", (3, 40, 2, 2, 16, 16), "softmax_in", 8),
            ("paged", (4, 8, 16, 4, 2, 256, 128, 64), "softmax_out", 8)):
        if kind == "dense":
            b, s_len, kv, g, hd, window = shape
            args, _ = _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits)
            kw = dict(window=window, logit_softcap=50.0, kv_bits=kv_bits,
                      **_site_kw(site))
            _assert_emit(iad.int8_attend_decode_cuda, args, kw)
        else:
            b, nb, bs, kv, g, hd, s_cap, window = shape
            args, _ = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap, site,
                                  kv_bits)
            kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                      kv_bits=kv_bits, **_site_kw(site))
            _assert_emit(pad.paged_int8_attend_decode_cuda, args, kw)


@pytest.mark.parametrize("rows,d,g", [(64, 2304, 4), (4, 2048, 1),
                                      (7, 72, 9), (5, 36, 3)])
def test_peg_quant_bf16_vectors(gen, rows, d, g):
    """K4 and K10 on bf16 rows: 16-byte vectors where d and the group size
    are multiples of 8 (2304 in groups of 576, 2048, 72 in groups of 8),
    one element at a time where they are not (36 in groups of 12) and for
    rows 2 bytes off 16-byte alignment: bit-exact against the plain
    versions."""
    x = (torch.randn(rows, d + 1, generator=gen, device="cuda") * 2).to(
        torch.bfloat16)
    s, z = _grid(gen, g)
    kw = dict(qmin=-128, qmax=127)
    for view in (x[:, :d].contiguous(), x.reshape(-1)[1:rows * d + 1]
                 .reshape(rows, d)):
        assert torch.equal(pq.peg_quantize_cuda(view, s, z, **kw),
                           pq.peg_quantize_plain(view, s, z, **kw))
        got = pq.peg_fake_quant_cuda(view, s, z, **kw)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, pq.peg_fake_quant_plain(view, s, z, **kw))


# -- K7 on the split-KV body -------------------------------------------------

def _float_case(gen, b, nb, bs, kv, g, hd, s_cap, dtype):
    """A K7 case with the holes of ``_paged_case``: f32 queries (scale
    folded in) and f32 or bf16 arenas."""
    n_blocks = b * nb + 3
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    table = perm[:b * nb].reshape(b, nb).to(torch.int32)
    splits, bps = pad.plan_kv_splits(b, kv, nb, bs)
    if splits > 2:
        table[0, bps:2 * bps] = -1
    table[1, nb - 1:] = -1
    q_pos = torch.tensor([s_cap + 37, s_cap // 3, -1, 2 * s_cap - 1][:b],
                         device="cuda", dtype=torch.int32)
    k, v = (torch.randn(n_blocks, bs, kv, hd, generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    q = torch.randn(b, kv, g, hd, generator=gen, device="cuda") * 0.3 / \
        hd ** 0.5
    return (q, k, v, table, q_pos), float(v.float().abs().max())


K7_SPLIT_SHAPES = [
    (4, 37, 16, 4, 2, 256, 587, 200), (4, 52, 8, 2, 2, 64, 413, None),
    (4, 256, 16, 4, 2, 256, 4096, 2048), (3, 8, 8, 2, 2, 16, 64, 16),
    (4, 8, 16, 4, 2, 256, 128, 64)]


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", K7_SPLIT_SHAPES)
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_decode_splits(gen, b, nb, bs, kv, g, hd, s_cap,
                                    window, site, dtype):
    """K7 at split boundaries (nb not a multiple of the blocks per split,
    bs 8, 32 splits of 8 blocks, a hole covering a whole split, an idle
    lane), f32 arenas at hd 256 (16-cell stages) and bf16 at hd 256
    (32-cell stages): against the plain version, and bit-identical over
    three calls (fixed merge order, no float atomics)."""
    args, v_abs = _float_case(gen, b, nb, bs, kv, g, hd, s_cap, dtype)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              **_site_kw(site))
    got = [pad.paged_attend_decode_cuda(*args, **kw) for _ in range(3)]
    want = pad.paged_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert_attend_close(got[0], want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)
    assert all(torch.equal(x, got[0]) for x in got[1:])


def _shifted(x):
    """A copy of ``x`` whose data start 4 bytes past a 16-byte boundary."""
    pad_el = 4 // x.element_size()
    flat = torch.empty(x.numel() + pad_el, dtype=x.dtype, device=x.device)
    view = flat[pad_el:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", [
    (3, 8, 8, 2, 2, 16, 64, 16), (4, 52, 8, 2, 2, 12, 413, None)])
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_decode_4_byte_copies(gen, b, nb, bs, kv, g, hd, s_cap,
                                           window, site, dtype):
    """K7 on arenas 4 bytes past a 16-byte boundary (the 4-byte cp.async
    path) computes the same bytes as on an aligned copy of the same values
    (16-byte copies where the rows are whole 16-byte vectors; the bf16
    rows of hd 12, 24 bytes, take 4-byte copies either way), which is held
    to the plain version."""
    args, v_abs = _float_case(gen, b, nb, bs, kv, g, hd, s_cap, dtype)
    q, k, v, table, q_pos = args
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              **_site_kw(site))
    got = pad.paged_attend_decode_cuda(*args, **kw)
    shifted = pad.paged_attend_decode_cuda(q, _shifted(k), _shifted(v),
                                           table, q_pos, **kw)
    want = pad.paged_attend_decode_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(shifted, got)
    assert_attend_close(got, want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)


@pytest.mark.parametrize("b,nb,bs,kv,g,hd,s_cap,window", K7_SPLIT_SHAPES)
@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attend_decode_emit(gen, b, nb, bs, kv, g, hd, s_cap, window,
                                  site, dtype):
    """K7 emitting the wo input from its merge, one and two passes, at split
    boundaries with a whole split unmapped and an idle lane: K4's bytes on
    K7's own f32 output; the emit is counted apart."""
    args, _ = _float_case(gen, b, nb, bs, kv, g, hd, s_cap, dtype)
    kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
              **_site_kw(site))
    fn = pad.paged_attend_decode_cuda
    before = fn.launches_emit
    _assert_emit(fn, args, kw)
    assert fn.launches_emit == before + 1


def test_k6_and_k7_back_to_back_on_the_shared_workspace(gen):
    """K6 and K7 calls of other shapes alternating on the workspace and
    counters they share with K5: each equals its plain version (or, when
    it emits, K4 on its own f32 output)."""
    for kind, shape, site, extra in (
            ("K6", (4, 8, 16, 4, 2, 256, 128, 64), "softmax_out", 8),
            ("K7", (4, 256, 16, 4, 2, 256, 4096, 2048), "none",
             torch.bfloat16),
            ("K6", (4, 37, 16, 4, 2, 256, 587, 200), "softmax_in", 4),
            ("K7", (3, 8, 8, 2, 2, 16, 64, 16), "softmax_out",
             torch.float32),
            ("K7", (4, 37, 16, 4, 2, 256, 587, 200), "softmax_out",
             torch.float32),
            ("K6", (4, 8, 16, 4, 2, 256, 128, 64), "none", 8)):
        b, nb, bs, kv, g, hd, s_cap, window = shape
        kw = dict(s_cap=s_cap, window=window, logit_softcap=50.0,
                  **_site_kw(site))
        step = 1 / 255 if site == "softmax_out" else None
        if kind == "K6":
            args, v_abs = _paged_case(gen, b, nb, bs, kv, g, hd, s_cap,
                                      site, extra)
            kw["kv_bits"] = extra
            fn, plain = (pad.paged_int8_attend_decode_cuda,
                         pad.paged_int8_attend_decode_plain)
        else:
            args, v_abs = _float_case(gen, b, nb, bs, kv, g, hd, s_cap,
                                      extra)
            fn, plain = (pad.paged_attend_decode_cuda,
                         pad.paged_attend_decode_plain)
        got = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        assert_attend_close(got, want, step, v_abs)
        _assert_emit(fn, args, kw)
