"""K3 (the cell restriction) of the PyTorch port: its plain version, which
CPU tensors take, against the JAX package at 64^3 in float64, rel <= 1e-12
(rel = max|port - jax| / max|jax|): against the JAX Pallas kernel run by the
Pallas interpreter (restrict_j_einsum(restrict_ik_pallas(x))) and against
the XLA path (ops/transfer.py:restrict_cell). Plus the wrapper's dispatch,
counters and input checks. The CUDA kernel runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpgmg_tpu.kernels.stencils as JK
from hpgmg_tpu.kernels import restrict as JR
from hpgmg_tpu.ops.transfer import restrict_cell as jrestrict
from hpgmg_tpu_torch.kernels import restrict as R
from hpgmg_tpu_torch.ops import transfer

TOL = 1e-12


def rel(port, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(port.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(64).standard_normal((64, 64, 64))


def test_restrict_plain_matches_pallas_interpret(x64, monkeypatch):
    monkeypatch.setattr(JK, "INTERPRET", True)
    want = JR.restrict_j_einsum(JR.restrict_ik_pallas(jnp.asarray(x64)))
    out = R.restrict_cell(torch.tensor(x64))
    assert tuple(out.shape) == want.shape == (32, 32, 32)
    assert rel(out, want) <= TOL


def test_restrict_plain_matches_xla(x64):
    out = transfer.restrict_cell(torch.tensor(x64))
    assert rel(out, jrestrict(jnp.asarray(x64))) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restrict_cpu_dispatch_counts_plain(dtype):
    x = torch.arange(4 ** 3, dtype=dtype).reshape(4, 4, 4)
    plain, launches = R.restrict_cell_plain.calls, R.restrict_cell_cuda.launches
    out = R.restrict_cell(x)
    assert R.restrict_cell_plain.calls == plain + 1
    assert R.restrict_cell_cuda.launches == launches
    # coarse (0,0,0) averages x[0:2, 0:2, 0:2] = {0,1,4,5,16,17,20,21}
    assert out.dtype == dtype and out.shape == (2, 2, 2)
    assert float(out[0, 0, 0]) == 10.5


def test_restrict_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="even"):
        R.restrict_cell(torch.zeros((5, 5, 5), dtype=torch.float64))
    with pytest.raises(ValueError, match="cube"):
        R.restrict_cell(torch.zeros((4, 4, 2), dtype=torch.float64))
    with pytest.raises(TypeError):
        R.restrict_cell(torch.zeros((4, 4, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        R.restrict_cell(torch.zeros((4, 4, 4), dtype=torch.float64).transpose(0, 1))
    with pytest.raises(ValueError, match="CUDA"):
        R.restrict_cell_cuda(torch.zeros((4, 4, 4), dtype=torch.float64))
