"""The benchmark's own tests (CPU unless marked ``cuda``):

    python -m pytest benchmark/tests -q

Cases marked ``cuda`` need an NVIDIA card and skip where there is none;
they are decided inside the test, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT.parent), str(ROOT / "reference"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
