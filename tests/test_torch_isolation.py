"""The port stands alone: `paddle_tpu_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, and nothing runs on a device the
caller did not ask for."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "paddle_tpu_torch"


def _run(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=str(cwd),
                          capture_output=True, text=True, timeout=120)


def test_imports_with_jax_and_reference_blocked():
    proc = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.ops_cuda._build\n"
        "import paddle_tpu_torch.models.weights\n"
        "import paddle_tpu_torch.nn, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.framework\n"
        "import paddle_tpu_torch.ops_cuda.flash_attention\n"
        "import paddle_tpu_torch.quantization.kv\n"
        "import paddle_tpu_torch.serving.paged_kv\n"
        "import paddle_tpu_torch.ops_cuda.int8_linear\n"
        "import paddle_tpu_torch.quantization\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "paddle_tpu"), (path, n)


def test_resolve_device_raises_without_a_card(monkeypatch):
    from paddle_tpu_torch import core
    from paddle_tpu_torch.models import gpt_small
    from paddle_tpu_torch.serving import KVCacheManager
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        core.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        core.resolve_device(None)                # the default is cuda
    with pytest.raises(RuntimeError, match="cuda"):
        gpt_small()                              # fails before the init
    with pytest.raises(RuntimeError, match="cuda"):
        KVCacheManager(2, 3, 16, 4, 8)           # slabs default to the card
    assert core.resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card_or_without_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=str(cwd), capture_output=True, text=True,
                              timeout=120, env=env)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
