"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — smoke tests
must see the real single CPU device; multi-device tests go through
subprocesses (see tests/util.py run_subprocess)."""
import os
import sys
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parent.parent / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (run with -m cuda)")


@pytest.fixture(scope="session")
def paper_numbers():
    return {
        "lifecycle": {
            "montage": {"kubeadaptor": 129.85, "batchjob": 169.83, "argo": 229.57},
            "epigenomics": {"kubeadaptor": 111.12, "batchjob": 162.34, "argo": 197.18},
            "cybershake": {"kubeadaptor": 83.36, "batchjob": 125.44, "argo": 151.19},
            "ligo": {"kubeadaptor": 92.46, "batchjob": 143.80, "argo": 181.22},
        },
        "exec": {"montage": 12.82, "epigenomics": 12.49,
                 "cybershake": 12.67, "ligo": 12.84},
    }
