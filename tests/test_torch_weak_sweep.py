"""The rank-count sweep of ``python -m hpgmg_tpu_torch.bench.weak`` on the
CPU over gloo: the JAX sweep's line per count (hpgmg_tpu/bench/weak.py:
84-93) with weak-eff and serial-eff, the cube sized as JAX sizes it (the
port's (sx, sy, 1) grid equals JAX's ``_factor3`` for 1, 2 and 4), and
``--trace``: one Chrome trace per rank and rank 0's wall shares.
"""

import json
import os
import re

import torch_cpu  # noqa: F401  (one intra-op thread a test process)

from hpgmg_tpu.parallel.mesh import _factor3 as jfactor3
from hpgmg_tpu_torch.bench import weak
from hpgmg_tpu_torch.parallel.mesh import mesh_ij_shape
from hpgmg_tpu_torch.utils.profiler import read_trace

LINE = re.compile(r"devices=\s*(\d+) mesh=\((\d+), (\d+), (\d+)\) n=\s*(\d+)\s+"
                  r"([0-9.]+) ms/solve ([0-9.e+-]+) DOF/s "
                  r"weak-eff=\s*([0-9.]+) serial-eff=\s*([0-9.]+)")


def test_grid_equals_jax_factor3():
    for n in (1, 2, 4):
        assert mesh_ij_shape(n) == jfactor3(n)


def test_sweep_prints_the_jax_lines(capsys):
    rc = weak.main(["--ranks", "1", "2", "--per-rank", "8", "--device", "cpu",
                    "--backend", "gloo", "--dynamic-range", "1", "--timeout", "240"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    jax_lines = [m for m in map(LINE.fullmatch, lines) if m]
    assert len(jax_lines) == 2
    first, second = jax_lines
    assert first.group(0).endswith("weak-eff= 1.00 serial-eff= 1.00")
    assert first.groups()[:5] == ("1", "1", "1", "1", "8")
    assert second.groups()[:5] == ("2", "2", "1", "1", "16")
    # each JAX line is followed by its count's JSON line; the last line is JSON
    records = [json.loads(line) for line in lines if line.startswith("{")]
    assert [r["ranks"] for r in records] == [1, 2] and lines[-1].startswith("{")
    t1, t2 = (r["seconds_per_solve"] for r in records)
    assert float(second.group(8)) == round(t1 / t2, 2)
    assert float(second.group(9)) == round(min(2 * t1 / t2, 1.0), 2)
    assert float(second.group(6)) == round(t2 * 1e3, 2)


def test_trace_writes_each_rank_and_rank0_shares(capsys, tmp_path):
    rc = weak.main(["--ranks", "2", "--per-rank", "8", "--device", "cpu",
                    "--backend", "gloo", "--dynamic-range", "1", "--reps", "2",
                    "--trace", str(tmp_path), "--timeout", "240"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tr = out["trace"]
    assert tr["dir"] == os.path.join(str(tmp_path), "rank0") and tr["solves"] == 2
    for r in (0, 1):
        names = {e["name"] for e in read_trace(str(tmp_path / f"rank{r}"))
                 if e.get("cat") == "user_annotation"}
        assert "weak.chain" in names and "mg.L0.smooth" in names
        assert {"comm.p2p", "comm.all_reduce"} <= names
    assert tr["wall_ms"] > 0.0
    assert 0.0 < tr["comm_share"] < 1.0
    assert tr["kernel_share"] == 0.0  # no device on the CPU
    assert abs(tr["neither_share"] + tr["comm_share"] - 1.0) <= 1e-9
