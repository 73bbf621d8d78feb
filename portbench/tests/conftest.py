"""The benchmark's own tests: `python -m pytest portbench/tests` from the
root of the repository. A test marked `cuda` needs the card and decides
inside its fixture whether one is there."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip with the reason."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card: python -m "
                    "pytest portbench/tests -m cuda)")
    return torch.device("cuda", 0)
