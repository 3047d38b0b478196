import os
import sys
from types import ModuleType

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
# the trainer's log goes through tensorboard, which imports TensorFlow (and
# with it JAX) where they are installed; its own switch keeps it on its stub
sys.modules.setdefault("tensorboard.compat.notf", ModuleType("tensorboard.compat.notf"))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The card, for a test marked ``cuda``; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The scene cache in a temporary directory."""
    from portbench import harness

    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    return tmp_path
