"""Shared pieces of the benchmark's CPU tests: tiny versions of each cell
(the same configuration and traffic, the batch and the budgets cut so that
the plain PyTorch route runs them in seconds)."""

import pytest

from portbench import spec

TINY = {
    "ldpc1200_msa.deep": {"run_config": {"batch": 32},
                          "traffic": {"max_words": 96}},
    "margulis_admm.bsc06": {"run_config": {"batch": 16, "iter_cap": 100},
                            "traffic": {"points": [0.08], "min_wec": 3,
                                        "max_words": 64}},
    "ldpc1200_msa.sweep": {"run_config": {"batch": 32},
                           "traffic": {"min_wec": 3}},
    # four ranks over gloo on the CPU, 16 words a rank a chunk, at 2.0 dB
    # so that every rank's chunks hold word errors
    "ldpc1200_msa_x4.deep16m": {"run_config": {"batch": 64},
                                "traffic": {"points": [2.0],
                                            "max_words": 192},
                                "backend": None},
}


@pytest.fixture(scope="session")
def bench():
    return spec.benchmark()


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """The plain route's small tensors gain nothing from a thread pool, and
    several test workers share the cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
