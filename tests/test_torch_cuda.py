"""The port's CUDA kernels against their plain PyTorch versions on the GPU
(marked ``cuda``; every test skips without a CUDA device). This file
imports no JAX, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Bounds as in ``tests/test_torch_kernels.py``: ``peg_quantize`` bit-exact,
``rms_quantize`` and int8 requant outputs within 1 LSB on at most 0.1 % of
elements, f32 matmul outputs within 1e-5 of max|out| (the build's
``-fmad=false`` makes them agree exactly in practice).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_ln_quant as lnq
from repro_torch.kernels import int8_matmul as imm
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
