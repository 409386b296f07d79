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
import contextlib

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


@pytest.mark.parametrize("m", [4, 32])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("g", [1, 4])
def test_int8_matmul_mlp_epilogue(gen, m, activation, g):
    """The MLP FFN's ``w_in`` at seamless-m4t's width, (m, 1024) x (1024,
    4096): bias + ReLU / GELU + int8 requant in the epilogue, on K2 (PEG, 4
    groups of 256) and K3 (per-tensor), within 1 LSB on at most 0.1 % of
    elements; then ``w_out`` (4096 -> 1024) on K3 with its bias, f32."""
    k, n = 1024, 4096
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    bias = torch.randn(n, generator=gen, device="cuda") * 0.1
    kw = dict(bias=bias, activation=activation, out_scale=0.05,
              out_zp=-100.0 if activation == "relu" else -60.0)
    if g == 1:
        cs = ref.w_colsum_groups(w, 1)[0]
        got = imm.int8_matmul_cuda(a, w, 0.02, 0.001, z_a=3.0, w_colsum=cs,
                                   **kw)
        want = imm.int8_matmul_plain(a, w, 0.02, 0.001, z_a=3.0,
                                     w_colsum=cs, **kw)
    else:
        s, z = _grid(gen, g)
        s = s / 20
        cs = ref.w_colsum_groups(w, g)
        got = imm.int8_matmul_peg_cuda(a, w, s, z, 0.001, cs, **kw)
        want = imm.int8_matmul_peg_plain(a, w, s, z, 0.001, cs, **kw)
    _assert_lsb(got, want)
    h = torch.randint(-128, 128, (m, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    w2 = torch.randint(-127, 128, (n, k), generator=gen, device="cuda",
                       dtype=torch.int8)
    cs2 = ref.w_colsum_groups(w2, 1)[0]
    kw2 = dict(z_a=-100.0, w_colsum=cs2,
               bias=torch.randn(k, generator=gen, device="cuda"))
    _assert_close(imm.int8_matmul_cuda(h, w2, 0.05, 0.001, **kw2),
                  imm.int8_matmul_plain(h, w2, 0.05, 0.001, **kw2))


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
    (7, 80, 1, torch.float32),
    # the LayerNorm serving rows: bert-base (d 768) and seamless-m4t's
    # decoder (d 1024, PEG 4 x 256), decode and chunk rows
    (4, 768, 1, torch.bfloat16), (4, 1024, 4, torch.bfloat16),
    (32, 1024, 1, torch.bfloat16)])
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
    (4, 256, 16, 4, 2, 256, 4096, 2048), (3, 8, 8, 2, 2, 16, 64, 16),
    (4, 37, 16, 32, 1, 96, 592, None), (4, 8, 16, 12, 1, 64, 128, None)])
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
    (4, 16, 4, 2, 256, None), (2, 300, 1, 8, 64, None),
    # phi3-vision (MHA, hd 96: 96-byte int8 rows) and bert-base (hd 64)
    (4, 592, 32, 1, 96, None), (4, 128, 32, 1, 96, None),
    (4, 128, 12, 1, 64, None)])
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
    (4, 52, 8, 2, 2, 64, 413, None), (3, 8, 8, 2, 2, 16, 64, 16),
    (4, 37, 16, 32, 1, 96, 592, None)])
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
    (4, 413, 2, 2, 64, None), (3, 40, 2, 2, 16, 16),
    (4, 592, 32, 1, 96, None)])
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


# ---------------------------------------------------------------------------
# In-place cache writes and the copy-on-write block copy on CUDA arenas
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _no_sync(device):
    """On the card, make any call that waits for it raise."""
    if device != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _arena_pair(kind, gen):
    """The same randomly filled cache on the card and on the CPU."""
    from repro_torch.models import attention as attn
    acfg = attn.AttnConfig(num_heads=8, num_kv_heads=4, head_dim=256)
    init = {"paged-16": lambda d: attn.init_paged_kv_cache(
                12, 16, acfg, torch.bfloat16, d),
            "paged-8": lambda d: attn.init_paged_quant_kv_cache(12, 16, acfg,
                                                                d),
            "paged-4": lambda d: attn.init_paged_quant4_kv_cache(12, 16,
                                                                 acfg, d),
            "dense-16": lambda d: attn.init_kv_cache(3, 40, acfg,
                                                     torch.bfloat16, d),
            "dense-8": lambda d: attn.init_quant_kv_cache(3, 40, acfg, d)}
    dev = init[kind]("cuda")
    for t in dev:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-128, 128, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int8))
        elif t.dtype == torch.int32:
            t.copy_(torch.randint(-1, 64, t.shape, generator=gen,
                                  device="cuda", dtype=torch.int32))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    return dev, type(dev)(*(t.cpu() for t in dev)), acfg


@pytest.mark.parametrize("kind", ["paged-16", "paged-8", "paged-4",
                                  "dense-16", "dense-8"])
def test_in_place_cache_writes_on_cuda_match_the_cpu(gen, kind):
    """A prefill with dead cells and an unmapped block, then a decode step
    with an idle lane, written in place into a CUDA arena: the same bytes
    as the same writes on the CPU, in the same tensors, and no call that
    waits for the card (``torch.cuda.set_sync_debug_mode("error")``)."""
    from repro_torch.models import attention as attn
    dev, cpu, acfg = _arena_pair(kind, gen)
    ptrs = [t.data_ptr() for t in dev]
    table = torch.tensor([[3, 7, 1], [0, 2, 5], [9, -1, -1]],
                         dtype=torch.int32)
    pw = torch.arange(30, dtype=torch.int32).repeat(3, 1)
    pw[0, :5] = -1
    for step_pw in (pw, torch.tensor([[25], [30], [-1]], dtype=torch.int32)):
        T = step_pw.shape[1]
        k = torch.randn(3, T, 4, 256, generator=gen, device="cuda")
        v = torch.randn(3, T, 4, 256, generator=gen, device="cuda")
        for cache, d in ((dev, "cuda"), (cpu, "cpu")):
            args = (k.to(d), v.to(d), step_pw.to(d))
            tab = table.to(d)
            torch.cuda.synchronize()
            with _no_sync(d):
                if kind.startswith("paged"):
                    out = attn._write_paged_kv(cache, *args, tab, None)
                else:
                    out = attn._write_kv(cache, *args, None)
            assert out is cache
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in dev] == ptrs
    for a, b in zip(dev, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("kv_bits", [16, 8, 4])
def test_cache_copy_block_on_cuda_matches_the_cpu(gen, stacked, kv_bits):
    """cache_copy_block on a whole-model paged cache on the card, with
    block ids as Python ints and as 0-d CUDA tensors: the same bytes as
    on the CPU, in place (with device ids, no call that waits for the
    card)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    cfg = get_config("gemma2-2b").reduced()
    dev = tfm.init_cache(cfg, 2, 32, stacked=stacked, kv_bits=kv_bits,
                         paged=True, block_size=4, device="cuda")
    for node in tfm._cache_nodes(dev):
        for t in node:
            t.copy_(torch.randint(-100, 100, t.shape, generator=gen,
                                  device="cuda").to(t.dtype))
    cpu = tfm.clone_cache(dev)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else
               [type(n)(*(t.cpu() for t in n)) for n in v])
           for k, v in cpu.items()}
    calls = tfm.cache_copy_block.calls
    for src, dst in ((1, 9), (2, 3), (9, 0)):
        ids = (src, dst) if src != 2 else (
            torch.tensor(src, device="cuda"), torch.tensor(dst,
                                                           device="cuda"))
        torch.cuda.synchronize()
        with _no_sync("cuda" if src == 2 else "cpu"):
            assert tfm.cache_copy_block(dev, *ids) is dev
        tfm.cache_copy_block(cpu, src, dst)
    torch.cuda.synchronize()
    assert tfm.cache_copy_block.calls == calls + 6
    for a, b in zip(tfm._cache_nodes(dev), tfm._cache_nodes(cpu)):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)


# ---------------------------------------------------------------------------
# Block swap (over-commit preemption) on CUDA arenas
# ---------------------------------------------------------------------------

def _node_axes(cache):
    return [(n, 1 if key == "scan" else 0)
            for key in ("layers", "scan", "tail") for n in cache.get(key, [])]


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("kv_bits", [8, 4])
def test_block_swap_on_cuda_restores_the_arenas(gen, stacked, kv_bits):
    """The engine swaps blocks (5, 2, 9) of a whole-model paged cache on the
    card out to pinned host memory (the gather, ``cache_gather_blocks``);
    the victim's blocks are then rewritten, as a lane that takes them over
    would; the swap-in writes the payload into blocks (1, 7, 3): those
    hold the swapped-out bytes bit for bit, every other block is as it was,
    the arena types (the int4 marker) are kept, and the scatter
    (``cache_scatter_blocks`` with ids and payload on the card) makes no
    call that waits for the card. The engine's own swap-in gives the same
    bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.engine import Engine
    from repro_torch.runtime.steps import make_swap_steps
    cfg = get_config("gemma2-2b").reduced()
    cache = tfm.init_cache(cfg, 2, 32, stacked=stacked, kv_bits=kv_bits,
                           paged=True, block_size=4, num_blocks=12,
                           device="cuda")
    for n, _ in _node_axes(cache):
        for t in n:
            t.copy_(torch.randint(-100, 100, t.shape, generator=gen,
                                  device="cuda").to(t.dtype))
    live, new = [5, 2, 9], [1, 7, 3]
    so, si = make_swap_steps()
    eng = Engine(None, None, None, batch_slots=1, swap_out_fn=so,
                 swap_in_fn=si, device="cuda")
    want = [t.index_select(axis, torch.tensor(live, device="cuda")).cpu()
            for n, axis in _node_axes(cache) for t in n]
    payload = eng.swap_out(cache, np.asarray(live, np.int32))
    got = [t for n, _ in _node_axes(payload) for t in n]
    assert all(t.device.type == "cpu" and t.is_pinned() for t in got)
    assert [type(n) for n, _ in _node_axes(payload)] == \
        [type(n) for n, _ in _node_axes(cache)]
    for n, axis in _node_axes(cache):               # the victim's blocks
        for t in n:                                 # are taken over
            t.index_fill_(axis, torch.tensor(live, device="cuda"), 3)
    torch.cuda.synchronize()
    before = [t.clone() for n, _ in _node_axes(cache) for t in n]
    twin = tfm.clone_cache(cache)
    dev = tfm._map(lambda x: x.to("cuda"), payload)
    ids = torch.tensor(new, device="cuda")
    torch.cuda.synchronize()
    with _no_sync("cuda"):
        assert tfm.cache_scatter_blocks(cache, ids, dev) is cache
    assert eng.swap_in(twin, np.asarray(new, np.int32), payload) is twin
    torch.cuda.synchronize()
    keep = torch.tensor([b for b in range(12) if b not in new],
                        device="cuda")
    after = [(t, axis) for n, axis in _node_axes(cache) for t in n]
    for (t, axis), t0, w, p, u in zip(
            after, before, want, got,
            [t for n, _ in _node_axes(twin) for t in n]):
        assert torch.equal(p, w)
        assert torch.equal(t.index_select(axis, ids).cpu(), w)
        assert torch.equal(t.index_select(axis, keep),
                           t0.index_select(axis, keep))
        assert torch.equal(u, t)


# ---------------------------------------------------------------------------
# Serving telemetry on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_deploy():
    """The reduced gemma2-2b on the card, calibrated and packed by the
    launcher's own ``_quantize`` (kv8): (cfg, params, ctx_factory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    cfg = get_config("gemma2-2b").reduced()
    ap = serve.build_parser()
    args = ap.parse_args(["--arch", "gemma2-2b", "--reduced", "--quantize",
                          "--deploy-int8", "--kv-bits", "8",
                          "--prompt-len", "12"])
    params = tfm.init_params(cfg, 0, dtype=torch.float32, device="cuda")
    params, ctx = serve._quantize(cfg, args, params, torch.float32, "cuda")
    return cfg, params, ctx


def _decode_engine(reduced_deploy, armed, sink):
    """An engine over the reduced deploy steps (armed or plain) and a
    mapped paged kv8 cache of 2 lanes, with both lanes admitted."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.engine import DecodeState, Engine
    from repro_torch.runtime.steps import make_admit_step, make_decode_step
    cfg, params, ctx = reduced_deploy
    eng = Engine(
        lambda t, p, m, c: make_admit_step(cfg, ctx_factory=ctx)(
            params, t, p, m, c),
        lambda t, p, c: make_decode_step(
            cfg, ctx_factory=ctx, quant_telemetry=armed)(params, t, p, c),
        lambda b: tfm.init_cache(cfg, b, 32, dtype=torch.float32,
                                 kv_bits=8, paged=True, block_size=8,
                                 device="cuda"),
        batch_slots=2, telemetry_sink=sink, device="cuda")
    state = eng.init_state()
    toks = np.random.RandomState(4).randint(1, cfg.vocab_size, (2, 12))
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    first, cache = eng.admit(toks.astype(np.int32), pos,
                             np.ones(2, bool), state.cache)
    return eng, DecodeState(first, np.full((2, 1), 12, np.int32), cache)


def _syncs(fn):
    """(result, the calls that waited for the card while ``fn`` ran)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def test_armed_decode_step_syncs_once_and_swaps_the_emit_for_k4(
        reduced_deploy):
    """One engine decode step on the card, plain and armed, from the same
    state: the same tokens and cache bytes; as many host syncs (the site
    vectors ride the tokens' read-back); armed, K4 quantizes wo's input in
    every layer in place of K6's emit, and the report holds every
    superblock's wo_in site."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.engine import DecodeState
    from repro_torch.runtime.telemetry import QuantHealth
    cfg = reduced_deploy[0]
    runs = {}
    for armed in (False, True):
        health = QuantHealth()
        eng, state = _decode_engine(reduced_deploy, armed, health.update)
        eng.generate(DecodeState(state.tokens, state.pos,
                                 tfm.clone_cache(state.cache)))  # warm-up
        pq.peg_quantize_cuda.launches = 0
        pad.paged_int8_attend_decode_cuda.launches_emit = 0
        (toks, cache), syncs = _syncs(lambda: eng.generate(state))
        torch.cuda.synchronize()
        runs[armed] = (toks, cache, syncs, pq.peg_quantize_cuda.launches,
                       pad.paged_int8_attend_decode_cuda.launches_emit,
                       health.report())
    (t0, c0, s0, k4_0, e0, _), (t1, c1, s1, k4_1, e1, rep) = (runs[False],
                                                             runs[True])
    assert np.array_equal(t0, t1)
    for a, b in zip(tfm._cache_nodes(c0), tfm._cache_nodes(c1)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert s1 == s0 and s0 >= 1, (s0, s1)
    assert (k4_0, e0) == (0, cfg.num_layers)
    assert (k4_1, e1) == (cfg.num_layers, 0)
    assert rep["steps_observed"] == 2          # the warm-up and the step
    assert all(f"layer{i}/attn/wo_in" in rep["sites"]
               for i in range(cfg.n_super))


def _profiled_ops(step):
    """Wrap a decode step so that its third call runs under the profiler;
    the wrapper's ``ops`` list gets that call's device operations."""
    from torch.profiler import ProfilerActivity, profile
    calls, ops = [0], []

    def decode(*args):
        calls[0] += 1
        if calls[0] != 3:
            return step(*args)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = step(*args)
            torch.cuda.synchronize()
        ops.extend(e.name for e in prof.events()
                   if e.device_type.name == "CUDA")
        return out
    decode.ops = ops
    return decode


def test_tracing_adds_no_device_operations_and_keeps_the_tokens(
        reduced_deploy):
    """The reduced deploy model served on the card with over-commit (swap)
    on a 4-block pool: untraced, traced and metered with the plain steps
    (disarmed), and with every collector on and the armed steps. All three
    emit the same greedy tokens; the disarmed run's profiled decode step
    runs exactly the untraced one's device operations; the armed one runs
    more (the site reductions), with its quant-health report filled."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import (BlockPool, Request, ServeTelemetry,
                                     make_admit_step,
                                     make_chunk_prefill_step,
                                     make_decode_step, make_swap_steps,
                                     serve)
    cfg, params, ctx = reduced_deploy
    so, si = make_swap_steps()

    def run(tel, armed):
        rng = np.random.RandomState(3)
        reqs = [Request(rid=i, prompt=rng.randint(1, cfg.vocab_size,
                                                  size=n),
                        max_new_tokens=q, priority=i % 2)
                for i, (n, q) in enumerate([(10, 12), (9, 12), (11, 10),
                                            (10, 11)])]
        decode = _profiled_ops(make_decode_step(
            cfg, ctx_factory=ctx, quant_telemetry=armed))
        stats = serve(None, decode,
                      lambda b: tfm.init_cache(
                          cfg, b, 32, dtype=torch.float32, kv_bits=8,
                          paged=True, block_size=8, num_blocks=4,
                          mapped=False, device="cuda"),
                      params, reqs, scheduler="continuous", batch_slots=2,
                      max_len=32,
                      admit_step=make_admit_step(cfg, ctx_factory=ctx,
                                                 quant_telemetry=armed),
                      chunk_step=make_chunk_prefill_step(
                          cfg, ctx_factory=ctx, quant_telemetry=armed),
                      block_pool=BlockPool(4, 8, 2, 4), prefill_chunk=8,
                      over_commit=True, swap_out_fn=so, swap_in_fn=si,
                      write_caps=tfm.attn_write_caps(cfg, 32, 8),
                      telemetry=tel, device="cuda")
        return [r.tokens_out for r in reqs], stats, decode.ops

    plain, pstats, plain_ops = run(None, False)
    tel = ServeTelemetry.create(trace=True, metrics_every=2)
    traced, _, traced_ops = run(tel, False)
    full = ServeTelemetry.create(trace=True, metrics_every=2, quant=True)
    armed, astats, armed_ops = run(full, True)
    assert pstats.preemptions > 0 and pstats.swapped_blocks > 0
    assert plain == traced == armed
    assert astats.decode_steps == pstats.decode_steps
    assert len(traced_ops) == len(plain_ops) > 0
    assert len(armed_ops) > len(plain_ops)
    names = [e.name for e in tel.tracer.events]
    assert names.count("decode_batch") == pstats.decode_steps
    assert {"swap_out", "swap_in", "preempt", "resume"} <= set(names)
    rep = full.quant.report()
    assert rep["steps_observed"] == astats.decode_steps + \
        astats.chunk_steps
    assert set(rep["kv_scales"]) == {"kv/k_s", "kv/v_s"}


@pytest.mark.parametrize("case", ["telemetry_stats", "per-tensor", "peg",
                                  "qtensor"])
def test_site_vectors_on_cuda_match_the_cpu(gen, case):
    """The quant-health reductions on card tensors give the CPU's vectors:
    exact counts, amax and range within rel 1e-6."""
    from repro_torch.core import deploy
    from repro_torch.core.quant_config import QuantizerConfig
    from repro_torch.core.quantizer import QuantParams, telemetry_stats
    x = torch.randn(4, 16, 256, generator=gen, device="cuda") * 3
    s, z = _grid(gen, 4)
    perm = torch.randperm(256, generator=gen, device="cuda")

    def vec(dev):
        if case == "telemetry_stats":
            gi = torch.arange(256, device="cuda") % 4
            qp = QuantParams(s.to(dev), z.to(dev), gi.to(dev))
            return telemetry_stats(x.to(dev), qp, QuantizerConfig(
                bits=8, symmetric=False, channel_axis=-1))
        if case == "qtensor":
            aq = deploy.ActQuant(s[:1].to(dev), z[:1].to(dev), -128, 127,
                                 None)
            q = torch.clamp(torch.round(x / s[0]) + z[0], -128, 127)
            return deploy.qtensor_stats(deploy.QTensor(
                q.to(torch.int8).to(dev), aq.scales, aq.zps), aq)
        g = 1 if case == "per-tensor" else 4
        aq = deploy.ActQuant(s[:g].to(dev), z[:g].to(dev), -128, 127,
                             None if g == 1 else perm.to(dev))
        return deploy.site_stats(x.to(dev), aq)
    got, want = vec("cuda").cpu(), vec("cpu")
    assert got.device.type == "cpu" and got[0] > 0
    assert got[0] == want[0] and got[1] == want[1]
    torch.testing.assert_close(got[2:], want[2:], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The engine's decomposed API and the async front-end on the card
# ---------------------------------------------------------------------------

def _card_engine(reduced_deploy, batch_slots, **kw):
    """The reduced deploy model behind ``make_engine`` with a dense kv8
    cache on the card (decode through K5 with its emit)."""
    from repro_torch.runtime import make_engine
    cfg, params, ctx = reduced_deploy
    return make_engine(cfg, params, batch_slots=batch_slots,
                       prompt_pad_len=12, max_len=32, dtype=torch.float32,
                       kv_bits=8, ctx_factory=ctx, device="cuda", **kw)


def test_insert_on_cuda_touches_only_its_lane(reduced_deploy):
    """``insert`` into lane 1 on the card leaves lanes 0 and 2 bit for bit
    as they were, writes in place and replaces lane 1; the payload equals
    the scratch lane it was taken from."""
    from repro_torch.models import transformer as tfm
    cfg = reduced_deploy[0]
    eng = _card_engine(reduced_deploy, 3)
    rng = np.random.RandomState(13)
    state = eng.init_state()
    nodes = tfm._cache_nodes(state.cache)
    ptrs = [x.data_ptr() for n in nodes for x in n]

    def lane(i):
        return [x[:, i].clone() for n in state.cache["scan"] for x in n]
    for slot, n in ((0, 5), (2, 7)):
        _, payload = eng.prefill(rng.randint(1, cfg.vocab_size, size=n))
        state = eng.insert(payload, slot, state)
    before = {i: lane(i) for i in (0, 2)}
    _, payload = eng.prefill(rng.randint(1, cfg.vocab_size, size=6))
    scratch = [x[:, 0:1] for n in eng._scratch["scan"] for x in n]
    for p, x in zip((x for n in payload.kv["scan"] for x in n), scratch):
        assert torch.equal(p, x)
    mid = lane(1)
    state = eng.insert(payload, 1, state)
    for i in (0, 2):
        assert all(torch.equal(a, b) for a, b in zip(lane(i), before[i]))
    assert not all(torch.equal(a, b) for a, b in zip(lane(1), mid))
    assert ptrs == [x.data_ptr() for n in tfm._cache_nodes(state.cache)
                    for x in n]


def test_async_server_on_cuda_matches_the_continuous_scheduler(
        reduced_deploy):
    """Eight 12-token requests streamed through the AsyncServer on 2 lanes
    (inserts into reused slots) give the continuous scheduler's greedy
    tokens on the same model; K5 and its emit serve every decode step and
    each engine step sees one shape signature."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import (AsyncServer, Request, make_admit_step,
                                     make_decode_step, serve)
    cfg, params, ctx = reduced_deploy
    rng = np.random.RandomState(21)
    prompts = [rng.randint(1, cfg.vocab_size, size=12) for _ in range(8)]
    quotas = [3 + i % 4 for i in range(8)]
    eng = _card_engine(reduced_deploy, 2)
    iad.int8_attend_decode_cuda.launches_emit = 0
    with AsyncServer(eng) as srv:
        streams = [srv.submit(p, q, rid=i)
                   for i, (p, q) in enumerate(zip(prompts, quotas))]
        got = [s.result(timeout=120) for s in streams]
    assert iad.int8_attend_decode_cuda.launches_emit > 0
    reqs = [Request(rid=i, prompt=p, max_new_tokens=q)
            for i, (p, q) in enumerate(zip(prompts, quotas))]
    serve(None, make_decode_step(cfg, ctx_factory=ctx),
          lambda b: tfm.init_cache(cfg, b, 32, dtype=torch.float32,
                                   kv_bits=8, device="cuda"),
          params, reqs, scheduler="continuous", batch_slots=2, max_len=32,
          admit_step=make_admit_step(cfg, ctx_factory=ctx), device="cuda")
    assert got == [r.tokens_out for r in reqs]
    assert [len(t) for t in got] == quotas
    assert eng.signature_counts == {"prefill": 1, "extract": 1, "insert": 1,
                                    "generate": 1}


def test_async_server_on_cuda_reports_a_failed_launch(reduced_deploy):
    """A decode step whose kernel wrapper refuses its arguments on the
    third call (a tensor off the card) fails the scheduler thread: the
    resident and the queued stream raise that error within seconds, and so
    does ``close()``; nothing falls back to the plain version."""
    import time
    from repro_torch.runtime import AsyncServer
    from repro_torch.runtime.steps import make_decode_step
    cfg, params, ctx = reduced_deploy
    eng = _card_engine(reduced_deploy, 1)
    decode, calls = make_decode_step(cfg, ctx_factory=ctx), [0]

    def failing(tokens, pos, cache):
        calls[0] += 1
        if calls[0] == 3:
            pq.peg_quantize_cuda(torch.zeros(1, 8), torch.ones(1),
                                 torch.zeros(1), qmin=-128, qmax=127)
        return decode(params, tokens, pos, cache)
    eng.decode_fn = failing
    rng = np.random.RandomState(22)
    t0 = time.perf_counter()
    srv = AsyncServer(eng)
    streams = [srv.submit(rng.randint(1, cfg.vocab_size, size=6), 8)
               for _ in range(2)]
    for s in streams:
        with pytest.raises(ValueError, match="CUDA kernel got a tensor"):
            s.result(timeout=60)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor"):
        srv.close()
    assert time.perf_counter() - t0 < 60
    assert len(streams[0].tokens_so_far()) == 3


# ---------------------------------------------------------------------------
# the paper's BERT path on the card (plain PyTorch: no kernel is on it)
# ---------------------------------------------------------------------------

def _paper_case():
    """bert.tiny() (3 labels) with the reference quickstart's planted
    outliers, syn-mnli batches at T 32, on the CPU."""
    import dataclasses
    from repro_torch.data.synthetic import GLUE_SUITE, SyntheticGLUE
    from repro_torch.models import bert
    from repro_torch.paper.common import to_device
    cfg = bert.tiny(num_labels=3)
    params = bert.init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        for p in params["layers"]:
            for j, dim in enumerate((5, 40, 77, 100)):
                p["w_out"][:, dim] *= 100.0 - 10 * j
    src = SyntheticGLUE(dataclasses.replace(GLUE_SUITE[5], seq_len=32,
                                            vocab_size=cfg.vocab_size))
    batches = [to_device(src.batch(8, i), "cpu") for i in range(3)]
    return cfg, params, batches


def _to_cuda(tree):
    from repro_torch.optim.tree import tree_map
    return tree_map(lambda t: t.cuda() if isinstance(t, torch.Tensor)
                    else t, tree)


def test_bert_forward_and_a_qat_step_on_cuda_match_the_cpu(gen):
    """The tiny BERT's FP32 logits within 1e-5 of their largest magnitude
    (f32 matmuls sum in another order on the card; no TF32), and one QAT
    step from the same CPU-calibrated W8A8 state: its loss within 1e-3
    relative and its gradient tree (weights and quantizer ranges, as one
    vector) at a cosine of at least 0.9 with the CPU's. The W8A8 STE
    gradient is not continuous: a value that rounds one grid step the other
    way, or onto a clip bound (half the gradient there), moves it. On the
    CPU alone, weights scaled by 1 + 1e-6 noise move this loss by 1.3e-4
    relative and the gradient to a cosine of 0.971."""
    from repro_torch.core import Mode, QuantCtx, ptq, w8a8_policy
    from repro_torch.core.qat import init_qat_params
    from repro_torch.models import bert
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.paper.common import value_and_grad
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, params, batches = _paper_case()

    def fwd(p, b, ctx):
        return bert.classify(cfg, p, b["tokens"], type_ids=b["type_ids"],
                             pad_mask=b["pad_mask"], ctx=ctx)
    pol = w8a8_policy()
    qm = ptq(fwd, params, batches[:2], pol,
             named_weights=bert.named_weight_sites(cfg, params))
    results = []
    for dev in ("cpu", "cuda"):
        conv = _to_cuda if dev == "cuda" else (lambda t: t)
        p, b = conv(params), conv(batches[2])
        act, wst = conv(qm.act_state), conv(qm.weight_state)
        with torch.no_grad():
            logits = fwd(p, b, None)
        tr = {"model": p, "quant": init_qat_params(act, wst)}

        def loss(t):
            ctx = QuantCtx(policy=pol, mode=Mode.QAT, act_state=act,
                           weight_state=wst, qat_params=t["quant"])
            return bert.loss_fn(cfg, t["model"], b, ctx=ctx)
        l, g = value_and_grad(loss, tr)
        results.append((logits.cpu(), l.cpu(),
                        [x.cpu() for x in tree_leaves(g)]))
    (l_cpu, loss_cpu, g_cpu), (l_gpu, loss_gpu, g_gpu) = results
    assert len(g_cpu) == len(g_gpu)
    a = torch.cat([x.flatten() for x in g_gpu])
    c = torch.cat([x.flatten() for x in g_cpu])
    diffs = {"logits": float((l_gpu - l_cpu).abs().max()) /
             float(l_cpu.abs().max()),
             "loss": abs(float(loss_gpu) / float(loss_cpu) - 1),
             "cosine": float(a @ c / (a.norm() * c.norm()))}
    assert diffs["logits"] <= 1e-5 and diffs["loss"] <= 1e-3 and \
        diffs["cosine"] >= 0.9, diffs


def _close_to(got, want, frac):
    assert float((got - want).abs().max()) <= frac * max(
        float(want.abs().max()), 1e-30)


def test_ptq_with_adaround_on_cuda(gen):
    """``ptq(..., adaround_sites=...)`` on the card: the refined weight
    lies on the site's grid, next to floor / ceil of each weight, and its
    output error is below nearest rounding's (the reference's 64 x 32
    case; the batches come from a CUDA generator)."""
    from repro_torch.core import (FP32, QuantizationPolicy, QuantizerConfig,
                                  RangeEstimator, fake_quant, ptq)
    from repro_torch.core.adaround import AdaRoundConfig
    wcfg = QuantizerConfig(bits=4, symmetric=True,
                           estimator=RangeEstimator.MSE)
    pol = QuantizationPolicy(weight_default=wcfg, act_default=FP32)
    w = torch.randn(64, 32, generator=gen, device="cuda") / 8.0
    x = torch.randn(256, 64, generator=gen, device="cuda")
    qm = ptq(lambda p, b, ctx: None, None, [], pol,
             named_weights={"w": w}, adaround_sites={"w": (w, x)},
             adaround_cfg=AdaRoundConfig(iterations=300, batch_size=128))
    w_ada, qp = qm.adarounded_weights["w"], qm.weight_state["w"]
    assert w_ada.device.type == "cuda" and torch.isfinite(w_ada).all()
    s = float(qp.scale)
    grid = torch.round(w_ada / s)
    assert float((w_ada - grid * s).abs().max()) <= 1e-5
    lo = torch.floor(w / s)
    assert bool(((grid == lo.clamp(wcfg.qmin, wcfg.qmax)) |
                 (grid == (lo + 1).clamp(wcfg.qmin, wcfg.qmax))).all())
    err = lambda wq: float(torch.mean(torch.square(x @ w - x @ wq)))  # noqa
    assert err(w_ada) < err(fake_quant(w, qp, wcfg))


# ---------------------------------------------------------------------------
# the training stack on the card (no kernel of the port is on its path)
# ---------------------------------------------------------------------------

def _train_steps(cfg, dev, steps=2, **kw):
    """Two steps of ``make_train_step`` on ``dev`` from the same CPU-drawn
    params and numpy batches (B 4 x T 32)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import (adam_init, linear_warmup_linear_decay,
                                   qadam_init, tree_map)
    from repro_torch.runtime import make_train_step
    p = tree_map(lambda t: t.to(dev), tfm.init_params(
        cfg, 5, dtype=torch.float32, device="cpu"))
    o = (qadam_init if kw.get("optimizer") == "adam8bit" else adam_init)(p)
    step = make_train_step(cfg, lr_schedule=linear_warmup_linear_decay(
        1e-3, 10), **kw)
    rng = np.random.RandomState(11)
    ms = []
    for _ in range(steps):
        t = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(4, 32))
                             .astype(np.int32)).to(dev)
        p, o, m = step(p, o, {"tokens": t, "labels": t})
        ms.append({k: float(v) for k, v in m.items()})
    return p, o, ms


@pytest.mark.parametrize("microbatches", [1, 2])
def test_reduced_train_steps_on_cuda_match_the_cpu(gen, microbatches):
    """Reduced gemma2-2b, f32 Adam, two steps: losses and gradient norms
    within 1e-5 relative (f32 matmuls and the embedding's atomic backward
    sum in other orders on the card; no TF32), each f32 moment leaf within
    1e-4 of its L2 norm (sums of cancelling terms move single elements by
    more than their own rounding), updated params within 1e-5 relative
    plus 1e-6 of the leaf's largest magnitude on all but at most 1 % of
    them, each within 2 x lr a step (Adam's normalized update magnifies
    float noise where a gradient is near its eps or the first moment
    cancels across steps)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import tree_leaves
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("gemma2-2b").reduced()
    pc, oc, mc = _train_steps(cfg, "cuda", microbatches=microbatches)
    pp, op, mp = _train_steps(cfg, "cpu", microbatches=microbatches)
    for a, b in zip(mc, mp):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])
        assert a["lr"] == b["lr"]
    for a, b in zip(tree_leaves((oc.mu, oc.nu)), tree_leaves((op.mu,
                                                              op.nu))):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm())
    loose = 0
    for a, b in zip(tree_leaves(pc), tree_leaves(pp)):
        d = (a.cpu().double() - b.double()).abs()
        tight = 1e-5 * b.abs().double() + 1e-6 * float(b.abs().max())
        assert float(d.max()) <= 2 * 1e-3 * 2 + float(tight.max())
        loose += int((d > tight).sum())
    assert loose <= 1e-2 * sum(t.numel() for t in tree_leaves(pp))


def test_8bit_moments_on_cuda_within_one_lsb_of_the_cpu(gen):
    """8-bit Adam on reduced gemma2-2b with a 4096 x 256 tied embedding
    (its moments are int8), two steps on the card and on the CPU: the int8
    moments within 1 LSB on at most 1e-3 of the bytes, their row scales
    within 1e-4 of their L2 norm (as the f32 moments of the test above)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("gemma2-2b").reduced(),
                              vocab_size=4096, d_model=256)
    _, oc, mc = _train_steps(cfg, "cuda", optimizer="adam8bit")
    _, op, mp = _train_steps(cfg, "cpu", optimizer="adam8bit")
    assert abs(mc[-1]["loss"] - mp[-1]["loss"]) <= 1e-5 * mp[-1]["loss"]
    for mom in ("mu", "nu"):
        a, b = getattr(oc, mom)["embed"], getattr(op, mom)["embed"]
        d = (a["q"].cpu().int() - b["q"].int()).abs()
        assert int(d.max()) <= 1 and int((d > 0).sum()) <= 1e-3 * d.numel()
        s_a, s_b = a["s"].cpu(), b["s"]
        assert float((s_a - s_b).norm()) <= 1e-4 * float(s_b.norm())


def test_checkpoint_round_trip_of_cuda_bf16_leaves(gen, tmp_path):
    """bf16 params and f32 Adam moments on the card save (async, host copy
    at the call) and restore onto the card bit for bit; a tensor updated
    in place after ``save`` returns does not reach the file."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adam_init, tree_leaves
    cfg = get_config("gemma2-2b").reduced()
    params = tfm.init_params(cfg, 3, dtype=torch.bfloat16, device="cuda")
    opt = adam_init(params)
    for t in tree_leaves(opt.mu):
        t.normal_(generator=gen)
    want = [t.clone() for t in tree_leaves((params, opt))]
    ck = Checkpointer(str(tmp_path))
    ck.save(2, (params, opt), extra={"data_state": {"seed": 0, "step": 2}})
    params["embed"].add_(1.0)
    ck.wait()
    (p2, o2), meta = ck.restore((params, opt))
    assert meta["data_state"]["step"] == 2
    for got, w in zip(tree_leaves((p2, o2)), want):
        assert got.device.type == "cuda" and got.dtype == w.dtype
        assert torch.equal(got, w)


def test_train_launcher_reduced_on_cuda(gen, capsys):
    """``launch.train.main`` with ``--reduced`` and no ``device``: trains on
    the card and prints the reference launcher's last line."""
    import math
    from repro_torch.launch import train
    out = train.main(["--arch", "gemma2-2b", "--reduced", "--steps", "3"],
                     log_every=1)
    assert out["step"] == 3
    assert out["params"]["embed"].device.type == "cuda"
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "[train] finished at step 3; 0 straggler events"
    assert [ln.split(" loss ")[0] for ln in lines[:3]] == [
        f"[train] step {i}" for i in (1, 2, 3)]


# ---------------------------------------------------------------------------
# The attention-decoder zoo: K5-K7 past 8 query heads a kv head, MoE and
# the new configs' train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,kv_bits", [
    ("dense", 8), ("dense", 4), ("paged", 8), ("paged", 4), ("float", 16)])
@pytest.mark.parametrize("kv,g", [(4, 16), (1, 48)])
@pytest.mark.parametrize("site", list(SITES))
def test_decode_kernels_past_8_query_heads(gen, kernel, kv_bits, kv, g,
                                           site):
    """K5, K6 (kv 8 and 4) and K7 (bf16 arenas) at qwen3-moe's G = 16 and
    granite-20b's G = 48, hd 128, 128 cells with holes, a short lane and
    an idle one: against the plain version, bit-identical over three
    calls, and the emit equal to K4's bytes on the f32 output."""
    b, hd, s_len, bs = 4, 128, 128, 16
    if kernel == "dense":
        args, v_abs = _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits)
        fn, plain = iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain
        kw = dict(window=None, kv_bits=kv_bits)
    elif kernel == "paged":
        args, v_abs = _paged_case(gen, b, s_len // bs, bs, kv, g, hd, s_len,
                                  site, kv_bits)
        fn, plain = (pad.paged_int8_attend_decode_cuda,
                     pad.paged_int8_attend_decode_plain)
        kw = dict(s_cap=s_len, window=None, kv_bits=kv_bits)
    else:
        args, v_abs = _float_case(gen, b, s_len // bs, bs, kv, g, hd, s_len,
                                  torch.bfloat16)
        fn, plain = (pad.paged_attend_decode_cuda,
                     pad.paged_attend_decode_plain)
        kw = dict(s_cap=s_len, window=None)
    kw.update(logit_softcap=30.0, **_site_kw(site))
    got = [fn(*args, **kw) for _ in range(3)]
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (b, kv, g, hd)
    assert_attend_close(got[0], want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)
    assert all(torch.equal(x, got[0]) for x in got[1:])
    _assert_emit(fn, args, kw)


@pytest.mark.parametrize("kernel,kv_bits", [
    ("dense", 8), ("dense", 4), ("paged", 8), ("float", 16)])
@pytest.mark.parametrize("s_len", [128, 2048])
@pytest.mark.parametrize("site", list(SITES))
def test_decode_kernels_at_10_heads_of_256(gen, kernel, kv_bits, s_len,
                                           site):
    """K5 (kv 8 and 4), K6 and K7 (bf16 arenas) at recurrentgemma's local
    attention (MQA: G = 10 query heads of hd 256 on one kv head, the G <=
    16 instantiation), 128 and 2048 cells with the holes of the cases
    above: against the plain version, bit-identical over three calls, the
    emit equal to K4's bytes."""
    b, kv, g, hd, bs = 4, 1, 10, 256, 16
    if kernel == "dense":
        args, v_abs = _dense_case(gen, b, s_len, kv, g, hd, site, kv_bits)
        fn, plain = iad.int8_attend_decode_cuda, iad.int8_attend_decode_plain
        kw = dict(window=None, kv_bits=kv_bits)
    elif kernel == "paged":
        args, v_abs = _paged_case(gen, b, s_len // bs, bs, kv, g, hd, s_len,
                                  site, kv_bits)
        fn, plain = (pad.paged_int8_attend_decode_cuda,
                     pad.paged_int8_attend_decode_plain)
        kw = dict(s_cap=s_len, window=None, kv_bits=kv_bits)
    else:
        args, v_abs = _float_case(gen, b, s_len // bs, bs, kv, g, hd, s_len,
                                  torch.bfloat16)
        fn, plain = (pad.paged_attend_decode_cuda,
                     pad.paged_attend_decode_plain)
        kw = dict(s_cap=s_len, window=None)
    kw.update(logit_softcap=None, **_site_kw(site))
    got = [fn(*args, **kw) for _ in range(3)]
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got[0].shape == (b, kv, g, hd)
    assert_attend_close(got[0], want, 1 / 255 if site == "softmax_out"
                        else None, v_abs)
    assert all(torch.equal(x, got[0]) for x in got[1:])
    _assert_emit(fn, args, kw)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1p6b"])
def test_recurrent_reduced_serve_on_cuda_matches_the_cpu(gen, arch):
    """The reduced recurrent quickstart (``--quantize --deploy-int8
    --kv-bits 8``, static, 2 slots) on the card and on the CPU from the
    same CPU-drawn weights: the same serve counts and greedy tokens; recurrentgemma's decode steps go
    through K1, K2, K3 and the emitting K5, rwkv6's through none."""
    import sys
    from pathlib import Path
    from repro_torch.launch import serve as launcher
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import cpu_drawn_params
    argv = (f"--arch {arch} --reduced --requests 4 --prompt-len 12 "
            f"--new-tokens 4 --batch-slots 2 --quantize --deploy-int8 "
            f"--kv-bits 8").split()
    calls, real = [], launcher.serve

    def spy(*a, **k):
        calls.append(a[4])
        return real(*a, **k)
    iad.int8_attend_decode_cuda.launches_emit = 0
    imm.int8_matmul_peg_cuda.launches = 0
    launcher.serve = spy
    try:
        # both runs serve the CPU's draws: the card's generator draws others
        with cpu_drawn_params():
            card = launcher.main(argv)
            cpu = launcher.main(argv, device="cpu")
    finally:
        launcher.serve = real
    for f in ("tokens_generated", "decode_steps", "prefill_calls",
              "cache_bytes", "slot_utilization"):
        assert getattr(card, f) == getattr(cpu, f), f
    assert [r.tokens_out for r in calls[0]] == \
        [r.tokens_out for r in calls[1]]
    emits = iad.int8_attend_decode_cuda.launches_emit
    k2 = imm.int8_matmul_peg_cuda.launches
    assert (emits > 0 and k2 > 0) == (arch == "recurrentgemma-2b")


def test_decode_kernels_refuse_more_than_48_query_heads(gen):
    """Past the kernel's limit the wrapper raises; nothing falls back."""
    args, _ = _dense_case(gen, 2, 32, 1, 49, 128, "none", 8)
    with pytest.raises(ValueError, match="attention decode kernel"):
        iad.int8_attend_decode_cuda(*args, window=None, logit_softcap=None,
                                    **_site_kw("none"))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "grok1-314b"])
def test_reduced_moe_on_cuda_matches_the_cpu(gen, arch):
    """The reduced MoE block and forward on the card against the CPU, from
    the same CPU-drawn params: top-k experts and the dispatch integers bit
    for bit, the block's output and the logits within 1e-5 of their
    largest magnitude; the card's combine gives the same bits twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_map
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, 3, dtype=torch.float32, device="cpu")
    p = tree_map(lambda t: t[0], params["scan"][0]["moe"])
    x = torch.randn(24, cfg.d_model, generator=torch.Generator().manual_seed(
        1))
    cap = moe._capacity(24, cfg.moe)
    out = {}
    for dev in ("cpu", "cuda"):
        pd, xd = tree_map(lambda t: t.to(dev), p), x.to(dev)
        _, top_p, top_e = moe.router_probs(pd, xd, cfg.moe)
        idx = moe._dispatch_indices(top_e, cfg.moe.num_experts, cap)
        y = moe.moe_apply(pd, xd, cfg.moe)
        assert torch.equal(y, moe.moe_apply(pd, xd, cfg.moe))
        out[dev] = (top_e.cpu(), [i.cpu() for i in idx], y.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.equal(a, b)
    _assert_close(out["cuda"][2], out["cpu"][2])
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want, _ = tfm.forward(cfg, params, toks)
        got, _ = tfm.forward(cfg, tree_map(lambda t: t.cuda(), params),
                             toks.cuda())
    _assert_close(got.cpu(), want)


@pytest.mark.parametrize("arch", ["internlm2-20b", "granite-20b",
                                  "qwen3-moe-235b", "grok1-314b"])
def test_zoo_train_step_on_cuda_matches_the_cpu(gen, arch):
    """One reduced f32 Adam step of each new config, card against CPU: the
    loss and gradient norm within 1e-5 relative; the updated params within
    1e-5 relative plus 1e-6 of the leaf's largest magnitude on all but at
    most 1 % of them, each within 2 x lr (as the gemma2-2b case)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import tree_leaves
    cfg = get_config(arch).reduced()
    pc, _, mc = _train_steps(cfg, "cuda", steps=1)
    pp, _, mp = _train_steps(cfg, "cpu", steps=1)
    for k in ("loss", "grad_norm"):
        assert abs(mc[0][k] - mp[0][k]) <= 1e-5 * abs(mp[0][k]), k
    loose = 0
    for a, b in zip(tree_leaves(pc), tree_leaves(pp)):
        d = (a.cpu().double() - b.double()).abs()
        tight = 1e-5 * b.abs().double() + 1e-6 * float(b.abs().max())
        assert float(d.max()) <= 2 * 1e-3 + float(tight.max())
        loose += int((d > tight).sum())
    assert loose <= 1e-2 * sum(t.numel() for t in tree_leaves(pp))


@pytest.mark.parametrize("arch", ["qwen3-moe-235b", "grok1-314b"])
def test_reduced_moe_tp2_on_cuda_matches_the_cpu(gen, arch):
    """The reduced MoE quickstart with ``--tp 2`` (expert-parallel, 2 of
    the 4 experts a rank) on two ranks on the card and on two CPU ranks,
    from the same CPU-drawn weights: the same greedy tokens on every rank;
    each card rank launches K6 in partial mode and both merges."""
    import sys
    from pathlib import Path
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch_tp_ranks
    argv = (f"--arch {arch} --reduced --requests 6 --prompt-len 24 "
            f"--new-tokens 6 --max-len 64 --quantize --deploy-int8 "
            f"--kv-bits 8 --scheduler continuous --paged-kv --block-size 8 "
            f"--prefill-chunk 8 --tp 2").split()
    card = run_ranks(torch_tp_ranks.cpu_drawn_serve, 2, (argv,),
                     device="cuda")
    cpu = run_ranks(torch_tp_ranks.cpu_drawn_serve, 2, (argv,),
                    device="cpu")
    assert sum(map(len, cpu[0][0])) == 36
    assert [t for t, _ in card] == [t for t, _ in cpu]
    for _, launches in card:
        for name in ("paged_int8_attend_decode_partials", "merge_partials",
                     "merge_partials_emit"):
            assert launches.get(name, 0) > 0, name


@pytest.mark.parametrize("opt,variant", [("adam", "base"),
                                         ("adam8bit", "wide")])
def test_train_step_on_a_2x2_mesh_matches_the_unsharded_step(gen, opt,
                                                              variant):
    """Reduced gemma2-2b in f32 on a (2, 2) rank mesh of 4 ranks on the
    card (FSDP over data, tensor-parallel over model; Adam, and 8-bit
    Adam on the 4096 x 256 embedding variant): 2 steps, each within the
    bounds of ``tests/test_torch_train_mesh.py`` of the unsharded step on
    the card from the same state."""
    import sys
    from pathlib import Path
    from repro_torch.launch.mesh import run_ranks
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_train_ranks as ranks
    cfg = ranks.case_config("gemma2-2b", variant)
    rng = np.random.RandomState(9)
    batches = [rng.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
               for _ in range(2)]
    cases = {"c": ((2, 2), "gemma2-2b", variant, opt, 1, batches)}
    got = run_ranks(ranks.step_scenarios, 4, (cases,), device="cuda",
                    shape=(2, 2))
    state = None
    for i, (rec, toks) in enumerate(zip(got[0]["c"], batches)):
        want = ranks.unsharded_step(cfg, state, toks, optimizer=opt,
                                    dev="cuda")
        ranks.assert_step_close(rec, want, opt, i)
        state = rec["params"] + rec["opt"]
