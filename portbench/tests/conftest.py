"""The benchmark's tests: CPU ones at tiny sizes, and `cuda`-marked ones
that skip without a card (decided in the `cuda` fixture, at run time).

    python -m pytest -p no:cacheprovider portbench/tests
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")
