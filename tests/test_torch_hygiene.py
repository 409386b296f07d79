"""Boundaries of the PyTorch port: it stands alone (no JAX, nothing of the
reference package), its entry points default to the GPU and refuse to
carry on without one, and ``chip_smoke.py`` fails without a GPU or without
the port next to it."""
import ast
import importlib.util
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "scripts" / "engine_bench_torch.py",
     REPO / "scripts" / "paper_tables_torch.py"] + \
    sorted((REPO / "examples").glob("torch_*.py"))


TRAINING_FILES = ["src/repro_torch/launch/train.py",
                  "src/repro_torch/runtime/train_loop.py",
                  "src/repro_torch/runtime/fault_tolerance.py",
                  "src/repro_torch/checkpoint/checkpointer.py",
                  "src/repro_torch/data/pipeline.py",
                  "src/repro_torch/optim/quantized_adam.py",
                  "src/repro_torch/core/grad_compression.py",
                  "src/repro_torch/configs/h2o_danube3_4b.py",
                  "examples/torch_train_e2e.py"]


ZOO_FILES = ["src/repro_torch/models/moe.py",
             "src/repro_torch/configs/internlm2_20b.py",
             "src/repro_torch/configs/granite_20b.py",
             "src/repro_torch/configs/qwen3_moe_235b.py",
             "src/repro_torch/configs/grok1_314b.py",
             "src/repro_torch/models/rglru.py",
             "src/repro_torch/models/rwkv6.py",
             "src/repro_torch/configs/recurrentgemma_2b.py",
             "src/repro_torch/configs/rwkv6_1p6b.py"]


def test_the_import_check_covers_the_training_stack():
    assert {str(p.relative_to(REPO)) for p in PORT_FILES} >= \
        set(TRAINING_FILES)


def test_the_import_check_covers_the_zoo():
    assert {str(p.relative_to(REPO)) for p in PORT_FILES} >= set(ZOO_FILES)


MULTIMODAL_FILES = ["src/repro_torch/models/encdec.py",
                    "src/repro_torch/models/frontends.py",
                    "src/repro_torch/configs/seamless_m4t_medium.py",
                    "src/repro_torch/configs/phi3_vision_4p2b.py",
                    "src/repro_torch/configs/bert_base.py"]


def test_the_import_check_covers_the_multimodal_slice():
    assert {str(p.relative_to(REPO)) for p in PORT_FILES} >= \
        set(MULTIMODAL_FILES)


# The reference launcher's reduced quickstart on the CPU, for each arch:
#   PYTHONPATH=src python -m repro.launch.serve --arch ARCH --reduced \
#       --requests 6 --prompt-len 24 --new-tokens 6 --max-len 64 \
#       --quantize --deploy-int8 --kv-bits 8 --scheduler continuous \
#       --paged-kv --block-size 8 --prefill-chunk 8 --parity
# prints this serve line (and three [parity] OK lines); its greedy tokens
# per request, captured from its serve call:
MM_QUICKSTART = ("--reduced --requests 6 --prompt-len 24 --new-tokens 6 "
                 "--max-len 64 --quantize --deploy-int8 --kv-bits 8 "
                 "--scheduler continuous --paged-kv --block-size 8 "
                 "--prefill-chunk 8 --parity").split()
MM_SERVE_LINE = (r"\[serve:continuous\] 36 tokens, 10 decode steps, 6 "
                 r"prefills, \S+s \(\S+ tok/s\), slot-utilization 75%, peak "
                 r"kv-cache 21 KiB \(kv-bits 8, blocks 16/32 \(frag 22%, "
                 r"block-size 8\), chunked prefill \(6 chunk steps @ <= 8 "
                 r"tokens\), cpu\)")
MM_TOKENS = {
    "phi3-vision-4p2b": [[61, 105, 45, 45, 26, 61], [105, 23, 121, 3, 30, 121],
                         [125, 10, 119, 33, 11, 11],
                         [120, 117, 120, 117, 120, 117],
                         [89, 123, 48, 4, 107, 66], [85, 94, 33, 69, 100, 42]],
    "bert-base": [[47, 103, 103, 52, 47, 52], [23, 23, 77, 23, 52, 85],
                  [1, 107, 107, 107, 107, 107], [1, 98, 51, 51, 51, 51],
                  [95, 100, 100, 100, 95, 109], [115, 107, 72, 72, 52, 72]],
}


# (request, token index) where the port's tokens part from the reference's
# on an exact tie at the top logit
MM_TIES = {"phi3-vision-4p2b": [(2, 5)], "bert-base": []}


@pytest.mark.parametrize("arch", list(MM_TOKENS))
def test_multimodal_archs_serve_the_reference_quickstart(arch, monkeypatch,
                                                         capsys):
    """The serving launcher takes phi3-vision-4p2b and bert-base. With the
    reference's weights and calibration carried across (its own draws
    differ), the reduced quickstart with ``--parity`` prints the
    reference's serve line and three ``[parity] OK`` lines, and emits the
    reference launcher's greedy tokens (phi3-vision's request 2 up to its
    last token, where two tokens tie exactly at the top logit); the FFN
    (GLU / MLP with biases)
    and the attention projections serve on the integer kernels in both
    layers."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config as jget_config
    from repro.core import peg_policy as jpeg_policy
    from repro.core.pipeline import ptq as jptq
    from repro.models import transformer as jtfm
    from repro_torch.convert import act_state_from_jax, params_from_jax
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    jcfg = jget_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    layouts = {}
    for stacked in (True, False):
        jp = jtfm.init_params(jcfg, key, stacked=stacked, dtype=jnp.float32)
        layouts[stacked] = (jp, params_from_jax(
            jax.tree.map(np.asarray, jp), "cpu"))
    calib = [{"tokens": jax.random.randint(jax.random.PRNGKey(10 + i),
                                           (2, 24), 0, jcfg.vocab_size)}
             for i in range(2)]
    jqm = jptq(lambda p, b, c: jtfm.forward(jcfg, p, b["tokens"], ctx=c)[0],
               layouts[False][0], calib, jpeg_policy(4), collect_inputs=True)

    class QM:
        act_state = act_state_from_jax(
            jax.tree.map(np.asarray, jqm.act_state), "cpu")
        peg_specs = {}
    monkeypatch.setattr(tfm, "init_params", lambda cfg, seed, stacked=True,
                        **kw: layouts[stacked][1])
    monkeypatch.setattr(serve, "ptq", lambda *a, **k: QM)
    served = []
    real_serve = serve.serve

    def spy(*a, **k):
        served.append(a[4])
        return real_serve(*a, **k)
    monkeypatch.setattr(serve, "serve", spy)
    ties = []              # per decode row: the tokens at its top logit
    real_decode = serve.make_decode_step

    def decode_step(cfg, **kw):
        step = real_decode(cfg, **kw)

        def run(*a):
            out = step(*a)
            last = out[0][:, -1]
            top = last.max(dim=-1, keepdim=True).values
            ties.extend(set(torch.nonzero(row == t)[:, 0].tolist())
                        for row, t in zip(last, top))
            return out
        return run
    monkeypatch.setattr(serve, "make_decode_step", decode_step)
    stats = serve.main(["--arch", arch] + MM_QUICKSTART, device="cpu")
    out = capsys.readouterr().out
    assert stats.tokens_generated == 36
    line = re.search(r"^\[serve:continuous\].*$", out, re.M).group(0)
    assert re.fullmatch(MM_SERVE_LINE, line), line
    assert len(re.findall(r"^\[parity\] OK", out, re.M)) == 3, out
    assert "[deploy-int8] max |fake-quant - int8| logits diff 0.00000 (rel " \
        "0.0000%)" in out, out
    assert "attention projections in 2/2 layers, FFN in 2/2 layers" in out
    # a request's tokens are the reference's up to a token that differs,
    # which must be one of two or more tokens tied exactly at the top logit
    # of a decode row (the head/logits site's grid: with other summation
    # orders the reference's fake-quant puts one of them a step higher)
    differ = []
    for r, want in zip(served[0], MM_TOKENS[arch]):
        got = list(r.tokens_out)
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                differ.append((r.rid, i))
                assert any({a, b} <= t for t in ties), (r.rid, i, a, b)
                break
        else:
            assert got == want
    assert differ == MM_TIES[arch]


def test_seamless_serve_stops_after_the_reference_startup_lines(capsys):
    """seamless-m4t-medium through the serving launcher runs what the
    reference runs — PTQ, ``build_deploy`` and the ``[deploy-int8]`` /
    ``[kv-int8]`` checks on the decoder-only view (both 0 there, as the
    reference prints) — then stops with a ``SystemExit`` naming the cause
    where the reference raises ``KeyError: 'dec_pos'``."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "seamless-m4t-medium"] + MM_QUICKSTART,
                   device="cpu")
    out = capsys.readouterr().out
    assert "[deploy-int8] max |fake-quant - int8| logits diff 0.00000 (rel " \
        "0.0000%)" in out, out
    assert "[kv-int8] max rel logits diff over prefill + 4 decode steps vs " \
        "bf16 cache: 0.0000%" in out, out
    assert "[serve:" not in out
    assert "encoder-decoder" in str(e.value) and "'dec_pos'" in str(e.value)


def test_seamless_train_stops_on_the_missing_frames():
    """The training launcher trains seamless-m4t-medium through
    ``encdec.train_loss``, whose batch needs ``frames``, which the
    launcher's token pipeline does not make: it stops there, as the
    reference launcher does (``KeyError: 'frames'``)."""
    from repro_torch.launch import train
    with pytest.raises(KeyError, match="frames"):
        train.main(["--arch", "seamless-m4t-medium", "--reduced", "--steps",
                    "1"], device="cpu")


@pytest.mark.parametrize("arch", ["phi3-vision-4p2b", "bert-base"])
def test_train_launcher_takes_the_multimodal_archs(arch, capsys):
    """phi3-vision-4p2b and bert-base train one reduced step (token
    batches, as the reference launcher feeds them)."""
    from repro_torch.launch import train
    assert train.main(["--arch", arch, "--reduced", "--steps", "1"],
                      device="cpu")["step"] == 1
    assert capsys.readouterr().out == \
        "[train] finished at step 1; 0 straggler events\n"


@pytest.mark.parametrize("arch,state", [("recurrentgemma-2b", "RGLRUState"),
                                        ("rwkv6-1p6b", "RWKVState")])
def test_recurrent_archs_serve_static_only(arch, state, capsys):
    """Both launchers take the recurrent archs (reduced: one static serve,
    one training step); ``--scheduler continuous`` and ``--paged-kv`` stop
    with the reference's errors (recurrent state has no per-lane validity
    and no block layout)."""
    from repro_torch.launch import serve, train
    small = ["--arch", arch, "--reduced", "--requests", "2", "--prompt-len",
             "4", "--new-tokens", "2"]
    stats = serve.main(small, device="cpu")
    assert stats.tokens_generated == 4
    assert train.main(["--arch", arch, "--reduced", "--steps", "1"],
                      device="cpu")["step"] == 1
    with pytest.raises(ValueError) as e:
        serve.main(small + ["--scheduler", "continuous"], device="cpu")
    assert str(e.value) == (
        f"cache_reset_slots: continuous batching supports attention caches "
        f"only, got {state} (recurrent state has no per-slot validity to "
        f"reset)")
    with pytest.raises(ValueError) as e:
        serve.main(small + ["--paged-kv"], device="cpu")
    assert str(e.value) == (
        "paged KV cache supports attention layers only, got 'rec' "
        "(recurrent state has no block layout)"
        if arch == "recurrentgemma-2b"
        else "rwkv6-1.6b-reduced: no attention layers to page")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_has_no_cuda_build_at_import():
    """Importing every module builds nothing and needs no nvcc."""
    code = ("import importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n    importlib.import_module(m.name)\n"
            "import sys; assert 'jax' not in sys.modules\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LIBS\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_launcher_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None would serve on it")
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "gemma2-2b", "--reduced", "--requests", "1"])


@pytest.mark.parametrize("entry", ["init_params", "init_cache", "serve",
                                   "bert_init", "train_task",
                                   "paper_tables", "train_main",
                                   "train_e2e", "serve_main_zoo",
                                   "init_params_zoo"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: device=None would run on it")
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import Request, serve
    from repro_torch.data.synthetic import GLUE_SUITE
    from repro_torch.models import bert
    from repro_torch.paper import common as paper
    sys.path.insert(0, str(REPO / "scripts"))
    import paper_tables_torch
    from repro_torch.launch import train
    spec = importlib.util.spec_from_file_location(
        "torch_train_e2e", REPO / "examples" / "torch_train_e2e.py")
    e2e = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(e2e)
    cfg = get_config("gemma2-2b").reduced()
    calls = {
        "train_main": lambda: train.main(["--arch", "gemma2-2b",
                                          "--reduced", "--steps", "1"]),
        "train_e2e": lambda: e2e.main(["--steps", "1"]),
        "bert_init": lambda: bert.init_params(bert.tiny(), 0),
        "train_task": lambda: paper.train_task(GLUE_SUITE[0], steps=1),
        "paper_tables": lambda: paper_tables_torch.main(["--sections",
                                                         "t1"]),
        "init_params": lambda: tfm.init_params(cfg, 0),
        "serve_main_zoo": lambda: __import__(
            "repro_torch.launch.serve", fromlist=["main"]).main(
                ["--arch", "qwen3-moe-235b", "--reduced", "--requests",
                 "1"]),
        "init_params_zoo": lambda: tfm.init_params(
            get_config("granite-20b").reduced(), 0),
        "init_cache": lambda: tfm.init_cache(cfg, 2, 16, kv_bits=8,
                                             paged=True, block_size=8),
        "serve": lambda: serve(None, None, None, None,
                               [Request(rid=0, prompt=[1, 2])],
                               batch_slots=1)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_launcher_rejects_unported_flags(capsys):
    """A misused flag stops the launcher before it builds a model
    (``--prefix-cache`` and ``--over-commit`` without ``--paged-kv``,
    ``--async`` with it, ``--quant-telemetry`` without ``--quantize``, and
    ``--tp`` without ``--reduced``, with the reference's messages); ``--tp
    2 --reduced`` passes the checks, and the 4-bit flags are ported and
    parse."""
    from repro_torch.launch.serve import _check_args, build_parser, main
    for extra in (["--prefix-cache"], ["--over-commit"],
                  ["--async", "--paged-kv"]):
        with pytest.raises(SystemExit):
            main(["--arch", "gemma2-2b", "--reduced", "--quantize",
                  "--deploy-int8"] + extra, device="cpu")
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main(["--arch", "gemma2-2b", "--quantize", "--deploy-int8", "--tp",
              "2"], device="cpu")
    assert ("--tp is the host-simulated tensor-parallel mode (--reduced); "
            "the full-size path builds its own production mesh"
            in capsys.readouterr().err)
    ap = build_parser()
    _check_args(ap, ap.parse_args(["--arch", "gemma2-2b", "--reduced",
                                   "--quantize", "--deploy-int8", "--tp",
                                   "2"]))
    with pytest.raises(SystemExit):
        main(["--arch", "gemma2-2b", "--reduced", "--scheduler",
              "continuous", "--quant-telemetry"], device="cpu")
    assert ("--quant-telemetry requires --quantize (clip fractions are "
            "measured against the calibrated quantization grids)"
            in capsys.readouterr().err)
    ap = build_parser()
    args = ap.parse_args(["--arch", "gemma2-2b", "--reduced", "--quantize",
                          "--deploy-int8", "--weight-bits", "4",
                          "--kv-bits", "4"])
    _check_args(ap, args)
    assert (args.weight_bits, args.kv_bits) == (4, 4)


def test_train_launcher_rejects_unported_flags(capsys):
    """``--multi-pod`` (the production mesh) stops the training launcher
    before it builds a model; ``--mesh`` and the other reference flags
    parse."""
    from repro_torch.launch.serve import _reject_unported
    from repro_torch.launch.train import _PORTED, build_parser, main
    with pytest.raises(SystemExit):
        main(["--arch", "gemma2-2b", "--reduced", "--multi-pod"],
             device="cpu")
    assert "is not yet ported" in capsys.readouterr().err
    ap = build_parser()
    _reject_unported(ap, ap.parse_args(["--arch", "gemma2-2b", "--mesh",
                                        "2x2"]), _PORTED)
    args = ap.parse_args(["--arch", "gemma2-2b", "--reduced", "--shape",
                          "train_4k", "--steps", "2", "--lr", "1e-3",
                          "--batch", "2", "--seq", "8", "--microbatches",
                          "2", "--checkpoint-dir", "x", "--checkpoint-every",
                          "1", "--no-resume", "--seed", "1"])
    _reject_unported(ap, args, _PORTED)


def test_chip_smoke_fails_without_gpu_or_without_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    runs = [(REPO, REPO / "chip_smoke.py")]
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append((tmp_path, tmp_path / "chip_smoke.py"))
    for cwd, script in runs:
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
