"""Boundaries of the PyTorch port: it stands alone (no JAX, nothing of the
reference package), its entry points default to the GPU and refuse to
carry on without one, and ``chip_smoke.py`` fails without a GPU or without
the port next to it."""
import ast
import os
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
                                   "paper_tables"])
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
    cfg = get_config("gemma2-2b").reduced()
    calls = {
        "bert_init": lambda: bert.init_params(bert.tiny(), 0),
        "train_task": lambda: paper.train_task(GLUE_SUITE[0], steps=1),
        "paper_tables": lambda: paper_tables_torch.main(["--sections",
                                                         "t1"]),
        "init_params": lambda: tfm.init_params(cfg, 0),
        "init_cache": lambda: tfm.init_cache(cfg, 2, 16, kv_bits=8,
                                             paged=True, block_size=8),
        "serve": lambda: serve(None, None, None, None,
                               [Request(rid=0, prompt=[1, 2])],
                               batch_slots=1)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_launcher_rejects_unported_flags(capsys):
    """Flags outside the ported slice stop the launcher before it builds a
    model (``--tp``), as does a misused flag (``--prefix-cache`` and
    ``--over-commit`` without ``--paged-kv``, ``--async`` with it,
    ``--quant-telemetry`` without ``--quantize``, with the reference's
    message); the 4-bit flags are ported and parse."""
    from repro_torch.launch.serve import _check_args, build_parser, main
    for extra in (["--tp", "2"], ["--prefix-cache"], ["--over-commit"],
                  ["--async", "--paged-kv"]):
        with pytest.raises(SystemExit):
            main(["--arch", "gemma2-2b", "--reduced", "--quantize",
                  "--deploy-int8"] + extra, device="cpu")
    capsys.readouterr()
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
