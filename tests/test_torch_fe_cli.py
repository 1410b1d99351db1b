"""The port's FE sampler, action CLI and log analyzer on the CPU
(hpgmg_tpu_torch/fe/sampler.py, fe/cli.py, bench/analyze.py).

The sampler's grid lists and analytic flop counts equal the JAX
package's; on 8 gloo ranks (tests/torch_ranks.py:fe_sample_body, and the
CLI's ``-ranks 8 -backend gloo``) it prints, from rank 0 alone, the
``P[  2  2  2]`` lines of the JAX sampler's sizes for that grid; the
CLI's actions print what the JAX CLI prints
(tests/test_fe_cli_actions.py's goldens; fmg and mgv line for line);
the analyzer reads the port's sampler and FV benchmark lines.
"""

import io
from contextlib import redirect_stdout

import pytest
import torch
import torch_cpu  # noqa: F401  (one intra-op thread a test process)
import torch_ranks

from hpgmg_tpu.fe import cli as jcli
from hpgmg_tpu.fe import sampler as jsampler
from hpgmg_tpu.fe.grid import FEGrid as JGrid
from hpgmg_tpu_torch.bench import analyze
from hpgmg_tpu_torch.fe import cli, sampler
from hpgmg_tpu_torch.fe.grid import FEGrid
from hpgmg_tpu_torch.fe.op import get_fe_op


def run_action(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


@pytest.mark.parametrize("local,procs", [((8, 512), (1, 1, 1)),
                                         ((50, 10000), (1, 1, 1)),
                                         ((50, 2097152), (1, 1, 1)),
                                         ((262144, 2097152), (1, 1, 1)),
                                         ((8, 100000), (2, 2, 1))])
def test_sample_grids_equal_jax(local, procs):
    sizes = sampler.sample_grid_range(*local, procs)
    assert sizes == jsampler.sample_grid_range(*local, procs)
    for k in (1, 2, 5, 8):
        assert sampler.thin_samples(sizes, k) == jsampler.thin_samples(sizes, k)


@pytest.mark.parametrize("M,degree,addquadpts", [((4, 4, 4), 1, 0), ((8, 8, 8), 2, 0),
                                                 ((16, 16, 24), 2, 0), ((6, 8, 8), 2, 1),
                                                 ((128, 128, 128), 2, 0)])
def test_flop_counts_equal_jax(M, degree, addquadpts):
    g, jg = FEGrid(M, degree, addquadpts=addquadpts), JGrid(M, degree, addquadpts=addquadpts)
    assert sampler._apply_flops_per_elem(g) == jsampler._apply_flops_per_elem(jg)
    for kw in ({}, {"pre": 3, "post": 3, "cg_iters": 1}, {"cg_iters": 37}):
        assert sampler.fcycle_flops(g, **kw) == jsampler.fcycle_flops(jg, **kw)


def test_sample_on_grid_runs_on_cpu():
    r = sampler.sample_on_grid(get_fe_op("poisson2"), (2, 2, 2), degree=2,
                               dtype=torch.float64, repeat=1, mintime=0.0,
                               chain=2, device="cpu")
    assert r.M == (2, 2, 2)
    assert r.seconds > 0 and r.meq_per_s > 0 and r.gflops > 0
    assert r.meq_per_s == pytest.approx(5 ** 3 / r.seconds / 1e6)


def test_run_sample_on_8_ranks_prints_p222(tmp_path):
    """run_sample under a group of 8 gloo ranks runs on the (2, 2, 2) grid:
    the sizes of the JAX sample_grid_range for it, P[  2  2  2], printed by
    rank 0 alone, every rank with the same (slowest) seconds."""
    ranks, = torch_ranks.spawn([(torch_ranks.fe_sample_body, 8, tmp_path, (8, 16), 3)])
    want = jsampler.thin_samples(jsampler.sample_grid_range(8, 16, (2, 2, 2)), 3)
    assert want == [(4, 4, 4), (4, 4, 6), (4, 4, 8)]
    lines = [ln for ln in ranks[0]["text"].splitlines() if ln.startswith("Q2 ")]
    assert [ln.split("P[")[0] for ln in lines] == [
        f"Q2 G[{M[0]:5d}{M[1]:5d}{M[2]:5d}] " for M in want]
    assert all("P[  2  2  2]" in ln for ln in lines)
    assert all(res["text"] == "" for res in ranks[1:])
    samples = ranks[0]["samples"]
    assert [s[0] for s in samples] == want and all(s[1] > 0 for s in samples)
    assert all(res["samples"] == samples for res in ranks[1:])


def test_run_sample_needs_a_group_of_n_devices():
    with pytest.raises(ValueError, match="-ranks 2"):
        sampler.run_sample(get_fe_op("poisson2"), n_devices=2, device="cpu")


def test_sample_action_on_ranks_line_parses():
    out = run_action(cli.main, ["sample", "-local", "8,8", "--ranks", "8", "--backend",
                                "gloo", "-repeat", "1", "-mintime", "0", "-device", "cpu"])
    lines = [ln for ln in out.splitlines() if ln.startswith("Q2 ")]
    assert len(lines) == 1 and "G[    4    4    4] P[  2  2  2]" in lines[0], out
    fe, fv = analyze.parse(lines)
    assert fv == [] and len(fe) == 1
    assert (fe[0]["degree"], fe[0]["elements"]) == (2, 64)
    assert fe[0]["meqs"] > 0 and fe[0]["gf"] > 0


def test_spawn_ranks_echoes_rank_0_and_raises_on_a_failed_rank(capsys):
    """parallel/launch.py:spawn_ranks, the launcher of the CLI's ranks and
    of bench/weak.py: rank 0's result and its printed line come back; a
    rank that raises makes the call raise."""
    from hpgmg_tpu_torch.parallel.launch import spawn_ranks

    assert spawn_ranks(2, "gloo", "cpu", torch_ranks.launched_body, (-1,),
                       timeout=240.0) == {"rank": 0, "device": "cpu"}
    assert capsys.readouterr().out == "rank 0 of 2 on cpu\n"
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_ranks(2, "gloo", "cpu", torch_ranks.launched_body, (1,), timeout=240.0)


def test_cli_refuses_nccl_without_cards():
    with pytest.raises(ValueError, match="-backend gloo"):
        cli.main(["sample", "-ranks", "2", "-device", "cpu"])


def test_sample_action_line_parses():
    out = run_action(cli.main, ["sample", "-local", "8,8", "-maxsamples", "1",
                                "-repeat", "1", "-mintime", "0",
                                "-device", "cpu"])
    lines = [ln for ln in out.splitlines() if ln.startswith("Q2 ")]
    assert len(lines) == 1 and "P[  1  1  1]" in lines[0], out
    fe, fv = analyze.parse(lines)
    assert fv == [] and len(fe) == 1
    assert (fe[0]["degree"], fe[0]["elements"]) == (2, 8)
    assert fe[0]["meqs"] > 0 and fe[0]["gf"] > 0


def test_cli_without_cuda_exits_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["fmg", "-M", "2,2,2"]) == 1
    assert "-device cpu" in capsys.readouterr().err


def test_grid_ladder_golden():
    out = run_action(cli.main, ["test-grid", "-M", "4,8,8", "-device", "cpu"])
    assert out.splitlines() == [
        "Level 0: M [4 8 8]  nodes [9 17 17]  neq 1575",
        "Level 1: M [2 4 4]  nodes [5 9 9]  neq 147",
        "Level 2: M [1 2 2]  nodes [3 5 5]  neq 9",
    ]


def test_feinject_values_encode_coordinates():
    out = run_action(cli.main, ["test-feinject", "-M", "4,4,4", "-op_type",
                                "poisson1", "-device", "cpu"])
    lines = [ln for ln in out.splitlines() if ln.startswith("coarse")]
    assert len(lines) == 3 ** 3
    for ln in lines:
        val = float(ln.split("=")[1].split("at")[0])
        x, y, z = (float(t) for t in ln.split("at")[1].split())
        assert abs(val - (1e6 * x + 1e3 * y + z)) < 1e-6, ln


def test_fespace_numbering_is_lexicographic():
    out = run_action(cli.main, ["test-fespace", "-M", "2,2,2", "-op_type",
                                "poisson1", "-device", "cpu"])
    lines = [ln for ln in out.splitlines() if ln.startswith("u[")]
    ids = [int(ln.split("[")[1].split("]")[0]) for ln in lines]
    assert ids == list(range(3 ** 3))
    assert out == run_action(jcli.main, ["test-fespace", "-M", "2,2,2",
                                         "-op_type", "poisson1"])


@pytest.mark.parametrize("argv", [
    ["fmg", "-M", "4,4,4", "-op_type", "poisson1", "-smooth", "3,3",
     "-mg_eig_target", "2,0.2"],
    ["mgv", "-M", "2,2,4", "-op_type", "poisson2", "-cycles", "2"],
    ["test-kspsolve", "-M", "4,4,6", "-op_type", "poisson1"],
])
def test_action_prints_the_jax_lines(argv):
    assert run_action(cli.main, argv + ["-device", "cpu"]) == run_action(jcli.main, argv)


def test_analyze_reads_the_port_lines(tmp_path):
    sample = "Q2 G[  128  128  128] P[  1  1  1]   0.050000 s   123.456 GF   339.492 MEq/s"
    fv = ("  fv4 F-cycle on NVIDIA H100 80GB HBM3: 512^3 grid, 40 solves, "
          "0.055466 s/solve, 2.420000e+09 DOF/s, rel_res=4.586611e-04, order=3.432960")
    fe_rows, fv_rows = analyze.parse([sample, fv])
    assert fe_rows == [dict(degree=2, elements=128 ** 3, time=0.05, gf=123.456,
                            meqs=339.492)]
    assert fv_rows == [dict(op="fv4", device="NVIDIA H100 80GB HBM3", n=512,
                            time=0.055466, dofs=2.42e9)]
    log = tmp_path / "run.log"
    log.write_text(f"{sample}\n{fv}\n")
    out = run_action(analyze.main, [str(log)]).splitlines()
    assert out[1] == ("  Q2 elements=   2097152 t=0.050000s   123.46 GF  339.492 MEq/s"
                      "  eff= 1.00")
    assert out[2] == "FV fv4 on NVIDIA H100 80GB HBM3 n=512^3 t=0.0555s 2.420e+09 DOF/s"
