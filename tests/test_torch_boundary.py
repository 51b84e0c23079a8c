"""Import boundary of the PyTorch port.

``src/repro_torch``, ``chip_smoke.py`` and the port's timing tools
(``tools/torch_step_times.py``, ``tools/torch_kernel_times.py``) must import neither ``jax`` nor anything of the JAX package ``repro`` (the
port keeps its own copy of what it needs; the GPU machine has no JAX), and
the port's entry points must not drop to the CPU on their own.
"""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCRIPTS = [ROOT / "tools" / "torch_step_times.py",
           ROOT / "tools" / "torch_kernel_times.py", ROOT / "chip_smoke.py"]
FILES = PORT_FILES + SCRIPTS


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES}
    assert "repro_torch/core/robust_step.py" in names
    assert "repro_torch/kernels/ops.py" in names
    assert "repro_torch/launch/serve.py" in names
    assert "repro_torch/configs/base.py" in names
    assert all(p.exists() for p in SCRIPTS)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from repro_torch.core import RobustConfig, make_federated_step
    from repro_torch.data import logreg_loss, mnist_like
    from repro_torch.models import paper_nn
    from repro_torch.optim import get_optimizer
    data = {"a": torch.zeros(2, 3, 22), "b": torch.ones(2, 3)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_federated_step(logreg_loss(), data, RobustConfig(),
                            get_optimizer("sgd", 0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist_like(0, n=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_nn.init_params(0)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    model = build_model(get_config("qwen2-7b").reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2-7b", "--reduced"])


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    from repro_torch import quickstart
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
