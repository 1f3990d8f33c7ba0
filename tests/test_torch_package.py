"""The PyTorch port stands alone: no file under paddle_tpu_torch/, and
not chip_smoke.py, imports `jax` or the JAX package `paddle_tpu`.  The
match is on exact module names — `paddle_tpu_torch` starts with
`paddle_tpu`, so a prefix test would be wrong both ways."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "paddle_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    """Absolute module names a file imports, by statement or by a
    string passed to `import_module` / `__import__`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            fname = getattr(fn, "attr", getattr(fn, "id", ""))
            if fname in ("import_module", "__import__"):
                yield node.args[0].value


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_matcher_is_exact():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("paddle_tpu") and _forbidden("paddle_tpu.models")
    assert not _forbidden("paddle_tpu_torch")
    assert not _forbidden("paddle_tpu_torch.models")
    assert not _forbidden("jaxlib_like") and not _forbidden("numpy")


def test_port_files_import_neither_jax_nor_paddle_tpu():
    files = _port_files()
    assert len(files) > 10 and files[-1].exists()
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"paddle_tpu_torch/ops/gmm.py", "paddle_tpu_torch/ops/moe_ops.py",
            "paddle_tpu_torch/ops/wo_int8_matmul.py",
            "paddle_tpu_torch/generation.py",
            "paddle_tpu_torch/nn/moe.py",
            "paddle_tpu_torch/inference/overload.py",
            "paddle_tpu_torch/inference/router.py",
            "paddle_tpu_torch/observability/timeseries.py",
            "paddle_tpu_torch/amp/__init__.py",
            "paddle_tpu_torch/quantization/__init__.py",
            "paddle_tpu_torch/quantization/int8.py",
            "paddle_tpu_torch/nn/layer/conv.py",
            "paddle_tpu_torch/ops/int8_linear.py"} <= names
    bad = [(str(p.relative_to(ROOT)), name) for p in files
           for name in _imports(p) if _forbidden(name)]
    assert not bad, bad


def _run(code_or_args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_port_imports_with_jax_blocked(tmp_path):
    """Importing the whole port (and chip_smoke) succeeds in a process
    where `jax` and `paddle_tpu` cannot be imported at all."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['paddle_tpu'] = None; "
            "import paddle_tpu_torch, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.ops.paged_attention, paddle_tpu_torch.ops.gmm, "
            "paddle_tpu_torch.ops.moe_ops, paddle_tpu_torch.nn.moe, "
            "paddle_tpu_torch.ops.wo_int8_matmul, "
            "paddle_tpu_torch.generation, "
            "paddle_tpu_torch.inference.overload, "
            "paddle_tpu_torch.inference.router, "
            "paddle_tpu_torch.observability.timeseries, "
            "paddle_tpu_torch.amp, paddle_tpu_torch.quantization, "
            "paddle_tpu_torch.nn.layer.conv, "
            "paddle_tpu_torch.ops.int8_linear, "
            "paddle_tpu_torch.models, chip_smoke; print('ok')")
    out = _run(["-c", code], tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA card, and in a directory holding nothing else of the repo."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_roofline_peaks_are_the_cards_own():
    """The bound's rates come from the card's own data sheet: H100 SXM
    and PCIe are told apart, and a card not in the tables raises
    instead of borrowing some other device's rates."""
    from paddle_tpu_torch.observability import roofline
    assert roofline.peak_hbm_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_hbm_bw("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak_flops("NVIDIA H100 PCIe", "float32") == 51e12
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3",
                               "float32_3xtf32") == 495e12 / 3
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3", "int8") == 1979e12
    assert roofline.peak_flops("NVIDIA H100 PCIe", "int8") == 1513e12
    assert roofline.peak_flops("NVIDIA H100 80GB HBM3", "float16") == 989e12
    assert roofline.peak_host_link_bw("NVIDIA H100 80GB HBM3") == 64e9
    for fn in (roofline.peak_hbm_bw, roofline.peak_flops,
               roofline.peak_host_link_bw):
        with pytest.raises(KeyError):
            fn("NVIDIA A100-SXM4-80GB")
        with pytest.raises(KeyError):
            fn("cpu")


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.amp", "paddle_tpu_torch.quantization",
    "paddle_tpu_torch.quantization.int8", "paddle_tpu_torch.nn.layer.conv",
    "paddle_tpu_torch.ops.int8_linear"])
def test_new_modules_export_what_they_list(module):
    """Every name in the module's `__all__` exists; `quantization`
    exports every name of the JAX package's and `amp` the JAX module's
    public surface (read from the JAX sources as text: nothing of
    `paddle_tpu` is imported here)."""
    import importlib
    mod = importlib.import_module(module)
    assert mod.__all__ and all(hasattr(mod, n) for n in mod.__all__)
    if module == "paddle_tpu_torch.quantization":
        src = (ROOT / "paddle_tpu" / "quantization" / "__init__.py")
        tree = ast.parse(src.read_text())
        jax_all = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                target = node.targets[0] if isinstance(node, ast.Assign) \
                    else node.target
                if getattr(target, "id", None) == "__all__":
                    jax_all |= set(ast.literal_eval(node.value))
        assert len(jax_all) == 11 and jax_all <= set(mod.__all__)
    if module == "paddle_tpu_torch.amp":
        assert {"auto_cast", "amp_guard", "decorate", "GradScaler",
                "WHITE_LIST", "BLACK_LIST", "amp_state"} <= set(mod.__all__)
