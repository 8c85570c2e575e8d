import pytest
import torch


@pytest.fixture(autouse=True)
def _own_registry(tmp_path, monkeypatch):
    """Every test resolves plans in a registry file of its own."""
    monkeypatch.setenv("REPRO_TORCH_PLAN_REGISTRY",
                       str(tmp_path / "plans.json"))


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
