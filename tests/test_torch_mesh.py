"""The ``(dp, tp)`` grid of the port (``dist/topology.py``,
``launch/mesh.py``, ``serve --mesh``), on gloo processes on the CPU.

* ``MeshPlan`` parses, prints and refuses as the reference's, on the
  reference's own cases (``tests/test_dist.py``), ``ep`` not dividing
  ``dp`` included; ``local_model_ranks`` numbers the grid row-major.
* ``mesh.run(..., dp=2)``: each process's row group holds its row's
  ``tp`` ranks and its data group its column's ``dp`` ranks.
* ``dp2xtp2`` from the smoke tp=2 artifact (the serve CLI's per-process
  body in the grid that checks the groups) and ``serve --mesh dp2xtp1``
  from the tp=1 one: each process reads only its model-axis rank file,
  and the greedy ids of the lockstep batch (4 rows, 2 a data rank) equal
  the ``dp1`` grid's at the same tp, row for row (torch's CPU GEMM rows
  of M=2 and M=4 calls are equal).  A grid whose tp is not the
  plan's, a batch that does not split over ``dp``, and ``--http`` over
  several processes are refused."""

import re

import pytest
import torch
import torch.distributed as dist

from repro_torch.core.policy import ExecutionPolicy
from repro_torch.dist.topology import MeshPlan, local_model_ranks
from repro_torch.launch import mesh, serve
from repro_torch.runtime.serve import check_mesh


@pytest.mark.parametrize("short", ["dp1xtp1", "dp2xtp4", "dp4xtp2xep2"])
def test_mesh_plan_shorthand_round_trips_as_jax(short):
    from repro.dist import MeshPlan as JaxMeshPlan

    plan = MeshPlan.parse(short)
    assert plan.shorthand() == short == JaxMeshPlan.parse(short).shorthand()
    assert MeshPlan.parse(plan.shorthand()) == plan
    assert MeshPlan.parse(plan) is plan
    assert MeshPlan.parse(None) == MeshPlan(dp=1, tp=1)


def test_mesh_plan_parse_is_order_insensitive_print_is_canonical():
    assert MeshPlan.parse("tp4xdp2") == MeshPlan(dp=2, tp=4)
    assert MeshPlan.parse("tp4xdp2").shorthand() == "dp2xtp4"
    assert MeshPlan.parse("ep2xtp2xdp4") == MeshPlan(dp=4, tp=2, ep=2)


@pytest.mark.parametrize("bad,match", [
    ("dp2xdp4", "repeats"),
    ("dp2", "both dp and tp"),
    ("tp0xdp2", "positive int"),
    ("banana", "unknown mesh spec"),
    ("dp2xtp4xep3", "must divide"),
])
def test_mesh_plan_rejects_malformed_specs_as_jax(bad, match):
    from repro.dist import MeshPlan as JaxMeshPlan

    with pytest.raises(ValueError, match=match):
        JaxMeshPlan.parse(bad)
    with pytest.raises(ValueError, match=match):
        MeshPlan.parse(bad)


def test_mesh_plan_geometry_and_policy_field():
    plan = MeshPlan(dp=2, tp=4)
    assert plan.size == 8
    pol = ExecutionPolicy(mesh="dp2xtp4")
    assert pol.mesh == plan
    hash(pol)
    assert ExecutionPolicy().mesh == MeshPlan()
    with pytest.raises(ValueError, match="positive int"):
        MeshPlan(dp=0, tp=2)
    # row-major: process p at data rank p // tp, model rank p % tp
    assert [local_model_ranks(plan, p) for p in range(8)] == \
        [(0,), (1,), (2,), (3,), (0,), (1,), (2,), (3,)]
    with pytest.raises(ValueError, match="not one of"):
        local_model_ranks(plan, 8)
    # an engine checks the TP degree only: each row of dp2xtp4 is 4 ranks
    check_mesh(pol, 4)
    with pytest.raises(ValueError, match="plans tp=4"):
        check_mesh(pol, 2)


def _grid(ctx, argv):
    """This process's place in the grid, what its row and data groups sum,
    and its share of the lockstep batch as the serve CLI serves it
    (``launch/serve._serve_mesh``)."""
    me = torch.tensor([float(ctx.process)])
    row, col = me.clone(), me.clone()
    dist.all_reduce(row, group=ctx.group)
    dist.all_reduce(col, group=ctx.data_group)
    args = serve.serve_parser().parse_args(argv)
    args.tp = ctx.tp
    return {"place": (ctx.process, ctx.dp_rank, ctx.rank),
            "sums": (float(row), float(col)), "transport": ctx.transport,
            "served": serve._serve_mesh(ctx, args)}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The smoke tp=1 and tp=2 artifacts, prepared by the port's CLI."""
    out = {}
    for tp in (1, 2):
        out[tp] = serve.main([
            "prepare", "--smoke", "--tp", str(tp), "--device", "cpu",
            "--collective", "quant-int8:fused" if tp > 1 else "psum",
            "--out", str(tmp_path_factory.mktemp(f"tp{tp}"))])
    return out


ARGS = ["--device", "cpu", "--max-batch", "4", "--max-new", "6",
        "--temperature", "0"]


@pytest.fixture(scope="module")
def grid(artifacts):
    """``dp2xtp2`` over the tp=2 artifact: four spawned processes."""
    return mesh.run(_grid, 2, ["--artifact", artifacts[2], "--mesh",
                               "dp2xtp2"] + ARGS,
                    dp=2, device_type="cpu", timeout=120)


def test_mesh_run_makes_row_and_data_groups(grid):
    assert [r["place"] for r in grid] == [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                          (3, 1, 1)]
    # rows {0, 1} and {2, 3}; columns {0, 2} and {1, 3}
    assert [r["sums"] for r in grid] == [(1.0, 2.0), (1.0, 4.0), (5.0, 2.0),
                                         (5.0, 4.0)]
    assert grid[0]["transport"] == "gloo, 4 ranks (dp2 x tp2) on the CPU"


def test_serve_mesh_dp2xtp2_equals_dp1_row_for_row(artifacts, grid):
    """Each process of ``dp2xtp2`` reads only its model-axis rank file,
    its row's ranks emit the same ids, and the batch's greedy ids equal
    the CLI's ``--mesh dp1xtp2`` run's row for row."""
    want = serve.main(["--artifact", artifacts[2], "--mesh", "dp1xtp2"]
                      + ARGS)
    got = []
    for r in grid:
        s = r["served"]
        assert s["rows"] == ((0, 2) if r["place"][1] == 0 else (2, 4))
        loaded, total, rank = map(int, re.fullmatch(
            r"resident_artifact_bytes=(\d+)/(\d+) ranks=\[(\d)\]",
            s["resident"]).groups())
        assert rank == r["place"][2] and loaded < total
        assert s["ids"] == grid[r["place"][0] - rank]["served"]["ids"]
        if rank == 0:
            got += s["ids"]
        assert s["policy"].mesh.shorthand() == "dp2xtp2"
    assert len(got) == 4 and all(len(row) == 6 for row in got)
    assert got == want


def test_serve_mesh_dp2xtp1_cli_equals_dp1_row_for_row(artifacts, capsys):
    """``serve --mesh dp2xtp1``: each process prints its resident line
    (its one rank file, model rank 0), and the ids equal the in-process
    ``dp1xtp1`` run's row for row."""
    capsys.readouterr()
    got = serve.main(["--artifact", artifacts[1], "--mesh", "dp2xtp1"]
                     + ARGS)
    out = capsys.readouterr().out
    want = serve.main(["--artifact", artifacts[1], "--mesh", "dp1xtp1"]
                      + ARGS)
    assert len(got) == 4 and got == want
    lines = re.findall(r"mesh=dp2xtp1 process=(\d)/2 "
                       r"resident_artifact_bytes=(\d+)/(\d+) ranks=\[0\]",
                       out)
    assert [int(p) for p, *_ in lines] == [0, 1]
    assert all(a == b for _, a, b in lines)
    assert "mesh=dp2xtp1 (gloo, 2 ranks (dp2 x tp1) on the CPU)" in out
    assert "decode step: eager (cpu)" in out


def test_serve_mesh_refusals(artifacts):
    with pytest.raises(SystemExit, match="disagrees with the plan's TP "
                                         "degree 2"):
        serve.main(["--artifact", artifacts[2], "--mesh", "dp2xtp1"] + ARGS)
    with pytest.raises(SystemExit, match="does not split over the 3 data"):
        serve.main(["--artifact", artifacts[1], "--mesh", "dp3xtp1"] + ARGS)
    with pytest.raises(SystemExit, match="item 9"):
        serve.main(["--artifact", artifacts[1], "--mesh", "dp2xtp1",
                    "--http", "127.0.0.1:0"] + ARGS)
