"""The gates that route levels to the two thread-block-cluster kernels (K2c,
csrc/fv4_gsrb2_cluster.cu; K4, csrc/tail.cu) admit only levels the kernels
take: the Python constants agree with the CUDA sources' own, and the
largest level each gate admits fits a block's shared memory in float64.
Runs on the CPU: it reads the sources, it launches nothing. Also: the
launch plans the two kernels' wrappers keep on a level (``Level.plan``)
are made once and go with the level, and every kernel's C entry takes
what its ctypes signature declares.
"""

import ctypes
import dataclasses
import gc
import re
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu_torch.core.config import SolverConfig
from hpgmg_tpu_torch.core.level import Level
from hpgmg_tpu_torch.kernels import build as B
from hpgmg_tpu_torch.kernels import stencils as S
from hpgmg_tpu_torch.kernels import tail as T

CSRC = Path(S.__file__).resolve().parent / "csrc"


def _constant(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_k2c_gate_within_the_kernels_limit():
    assert S.GSRB2_CLUSTER_MAX_N == _constant("fv4_gsrb2_cluster.cu", "kGsrb2ClusterMaxN")
    assert S.GSRB2_MAX_DIM <= S.GSRB2_CLUSTER_MAX_N
    smem = _constant("cluster.cuh", "kMaxClusterSmem")
    assert S.gsrb2_cluster_smem(S.GSRB2_CLUSTER_MAX_N, 8) <= smem
    assert S.gsrb2_cluster_smem(S.GSRB2_CLUSTER_MAX_N + 2, 8) > smem
    assert 6 <= _constant("fv4_gsrb2_cluster.cu", "kGsrb2Cluster") \
        <= _constant("cluster.cuh", "kMaxCluster")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tail_gates_within_the_kernels_limits(dtype):
    assert T.MAX_TAIL == _constant("tail.cu", "kMaxTail")
    assert T.MAX_SMEM == _constant("cluster.cuh", "kMaxClusterSmem")
    blocks = _constant("tail.cu", "kTailCluster")
    assert 1 <= blocks <= _constant("cluster.cuh", "kMaxCluster")
    itemsize = torch.empty((), dtype=dtype).element_size()
    for n0 in (8, 16, 32, 64):  # tail.cu:tail_smem with the source's cluster
        planes = -(-n0 // blocks)
        planes += planes & 1
        assert T.tail_smem(n0, itemsize) == \
            2 * (planes + 4) * ((((n0 + 4) ** 2) + 3) & ~3) * itemsize
    # the first level of a span is at most TAIL_MAX_DIM; coarser levels
    # reuse its buffers
    assert T.tail_smem(T.TAIL_MAX_DIM, itemsize) <= T.MAX_SMEM
    assert T.tail_smem(T.TAIL_MAX_DIM, itemsize) >= T.tail_smem(T.TAIL_MAX_DIM // 2, itemsize)


def test_level_keeps_its_launch_plans():
    n, made = 8, []
    beta = [torch.ones(s) for s in ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))]
    lv = Level(dim=n, h=1.0 / n, depth=0, beta_i=beta[0], beta_j=beta[1], beta_k=beta[2])
    cfg = SolverConfig()

    class Plan(SimpleNamespace):  # weakly referable
        pass

    def make():
        made.append(1)
        return Plan(held=cfg)

    plan = lv.plan(("k", id(cfg)), make)
    assert lv.plan(("k", id(cfg)), make) is plan and len(made) == 1
    # a replaced level (new operands) starts with no plans
    assert dataclasses.replace(lv, h=0.5).plans == {}
    assert lv == dataclasses.replace(lv) and "plans" not in repr(lv)
    gone = weakref.ref(plan), weakref.ref(lv)
    del lv, plan
    gc.collect()
    assert gone[0]() is None and gone[1]() is None


def _ctype(param: str):
    kind = param.rsplit(None, 1)[0] if "*" not in param else "*"
    return {"*": ctypes.c_void_p, "int": ctypes.c_int, "double": ctypes.c_double}[kind]


def test_c_entries_match_their_ctypes_signatures():
    """Every C entry of the kernel sources takes the arguments that
    ``build._SIGNATURES`` declares for it, in kind and number (a mismatch
    shows only on the card, as a TypeError or a wrong argument)."""
    entries = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            entries[name] = tuple(_ctype(p.strip()) for p in params.split(","))
    assert set(entries) == set(B._SIGNATURES)
    for name, types in entries.items():
        assert B._SIGNATURES[name] == types, name
