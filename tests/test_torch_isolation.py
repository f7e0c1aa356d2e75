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
        "import paddle_tpu_torch.testing.faults\n"
        "import paddle_tpu_torch.serving.graphs\n"
        "import paddle_tpu_torch.obs, paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.obs.__main__\n"
        "import paddle_tpu_torch.framework.io\n"
        "import paddle_tpu_torch.ps, paddle_tpu_torch.native\n"
        "import paddle_tpu_torch.serving.fleet\n"
        "import paddle_tpu_torch.serving.kv_tier\n"
        "import paddle_tpu_torch.serving.autoscale\n"
        "import paddle_tpu_torch.serving.__main__\n"
        "import paddle_tpu_torch.serving.server\n"
        "import paddle_tpu_torch.serving.slo\n"
        "import paddle_tpu_torch.serving.sharded_kv, paddle_tpu_torch.nn.tp\n"
        "import paddle_tpu_torch.models.resnet, paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.nn.initializer\n"
        "import paddle_tpu_torch.nn.layers_conv\n"
        "import paddle_tpu_torch.nn.layers_norm\n"
        "import paddle_tpu_torch.nn.layers_pooling\n"
        "import paddle_tpu_torch.nn.layers_common\n"
        "import paddle_tpu_torch.nn.layers_loss\n"
        "import paddle_tpu_torch.vision.datasets\n"
        "import paddle_tpu_torch.vision.transforms.functional\n"
        "import paddle_tpu_torch.vision.transforms.transforms\n"
        "import paddle_tpu_torch.metric, paddle_tpu_torch.hapi.model\n"
        "import paddle_tpu_torch.hapi.callbacks\n"
        "import paddle_tpu_torch.models.bert, paddle_tpu_torch.text\n"
        "import paddle_tpu_torch.nn.layers_transformer\n"
        "import paddle_tpu_torch.jit, paddle_tpu_torch.jit.dy2static\n"
        "import paddle_tpu_torch.static, paddle_tpu_torch.inference\n"
        "import paddle_tpu_torch.parallel, paddle_tpu_torch.nn.ranks\n"
        "import paddle_tpu_torch.parallel.fleet\n"
        "import paddle_tpu_torch.parallel.fleet_metrics\n"
        "import paddle_tpu_torch.parallel.sharding\n"
        "import paddle_tpu_torch.parallel.collective\n"
        "import paddle_tpu_torch.parallel.random_\n"
        "import paddle_tpu_torch.parallel.tp_layers\n"
        "import paddle_tpu_torch.parallel.sequence\n"
        "import paddle_tpu_torch.parallel.moe\n"
        "import paddle_tpu_torch.parallel.pipeline\n"
        "import paddle_tpu_torch.parallel.compression\n"
        "import paddle_tpu_torch.parallel.localsgd\n"
        "import paddle_tpu_torch.parallel.multislice\n"
        "import paddle_tpu_torch.parallel.auto\n"
        "import paddle_tpu_torch.parallel.launch\n"
        "import paddle_tpu_torch.parallel.elastic\n"
        "import paddle_tpu_torch.framework.auto_checkpoint\n"
        "import paddle_tpu_torch.ops, paddle_tpu_torch.ops.creation\n"
        "import paddle_tpu_torch.ops.math, paddle_tpu_torch.ops.linalg\n"
        "import paddle_tpu_torch.ops.manipulation\n"
        "import paddle_tpu_torch.ops.extras\n"
        "import paddle_tpu_torch.ops.registry\n"
        "import paddle_tpu_torch.autograd, paddle_tpu_torch.nn.layer\n"
        "import paddle_tpu_torch.testing.op_cases\n"
        "import paddle_tpu_torch.models.vision\n"
        "import paddle_tpu_torch.models.vision_extra\n"
        "import paddle_tpu_torch.hapi.model_summary\n"
        "import paddle_tpu_torch.vision.transforms\n"
        "assert paddle_tpu_torch.ops.registry.coverage()['missing'] == 0\n"
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
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.models import resnet18, resnet50
    with pytest.raises(RuntimeError, match="cuda"):
        resnet50()                               # fails before the init
    with pytest.raises(RuntimeError, match="cuda"):
        resnet18(num_classes=10)
    with pytest.raises(RuntimeError, match="cuda"):
        DataLoader(TensorDataset([torch.zeros(2)]), to_device="cuda")
    from paddle_tpu_torch.models import googlenet, mobilenet_v2
    with pytest.raises(RuntimeError, match="cuda"):
        mobilenet_v2(num_classes=102)            # fails before the init
    with pytest.raises(RuntimeError, match="cuda"):
        googlenet()
    assert core.resolve_device("cpu").type == "cpu"


# each JAX module of the vision zoo and its tools, and its port counterpart
COUNTERPARTS = [
    ("models.vision", "models.vision"),
    ("models.vision_extra", "models.vision_extra"),
    ("nn.layers_pooling", "nn.layers_pooling"),
    ("nn.layers_conv", "nn.layers_conv"),
    ("quantization", "quantization"),
    ("vision.transforms.transforms", "vision.transforms.transforms"),
    ("vision.transforms.functional", "vision.transforms.functional"),
    ("vision.datasets", "vision.datasets"),
    ("hapi.callbacks", "hapi.callbacks"),
    ("hapi.model_summary", "hapi.model_summary")]


@pytest.mark.parametrize("jax_mod,port_mod", COUNTERPARTS,
                         ids=[c[0] for c in COUNTERPARTS])
def test_every_public_name_has_its_port_counterpart(jax_mod, port_mod):
    """Each public name of the JAX module (its `__all__`, or else its
    public classes and functions) is a name of the port's module."""
    import importlib
    import inspect
    ref = importlib.import_module(f"paddle_tpu.{jax_mod}")
    port = importlib.import_module(f"paddle_tpu_torch.{port_mod}")
    names = getattr(ref, "__all__", None) or [
        n for n, v in vars(ref).items() if not n.startswith("_")
        and (inspect.isclass(v) or inspect.isfunction(v))
        and v.__module__ == ref.__name__]
    assert names
    assert sorted(n for n in names if not hasattr(port, n)) == []


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
