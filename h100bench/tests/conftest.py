"""Paths for the harness's tests, and the card fixture: tests marked
``gpu`` skip, with a reason, where no CUDA card is present, decided inside
the fixture and never while a module is imported."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (BENCH / "tests", BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with pytest -m gpu h100bench/tests on the H100")
    return torch.device("cuda", 0)
