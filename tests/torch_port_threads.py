"""The thread budget of the port's CPU tests, in one place.

The tier-1 run puts several test processes on the same cores, and torch's
default intra-op pool (one thread a core in each process) then slows these
small CPU runs a hundredfold. So every port test file that runs torch on
the CPU takes ``one_thread`` by one import line::

    from torch_port_threads import one_thread  # noqa: F401 (autouse)

and every process a port test spawns gets ``env()``.
"""

from __future__ import annotations

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, restored after it. Module scope,
    so that the module's own fixtures (JAX inits, exported artifacts) run
    under it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def env(**extra) -> dict:
    """The environment of a process a port test spawns: this one's, with
    ``OMP_NUM_THREADS=1`` (the child's intra-op pool, as ``one_thread``
    sets this process's), and ``extra``."""
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)
