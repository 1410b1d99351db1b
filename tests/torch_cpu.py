"""Imported by every port test module (tests/test_torch_*.py) for one
effect: PyTorch runs each test process's CPU ops on one intra-op thread.

The suite runs in several worker processes at once (pytest-xdist), and
each would otherwise start as many threads as the host has cores for
tensors of a few thousand cells: on an 8-core host, 6 workers ran the
port's tests about 4x slower in all than with one thread each. Results
do not depend on it: the tests hold the port to the JAX package and to its
plain versions with tolerances that hold either way. Spawned ranks
(tests/torch_ranks.py) set the same.
"""

import torch

torch.set_num_threads(1)
