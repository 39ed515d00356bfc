"""The port's communication model (``owl_path_tracer_tpu_torch/tools/
comm_model.py``) against the repository's ``tools/comm_model.py`` (which
imports no JAX) and against the collectives ``parallel/shard.py`` really
issues.

* ``allreduce_s`` and the model's rows equal the JAX tool's formulas on the
  same inputs (its link names given the card's; the port's frame adds the
  ray-count all-gather, 8 bytes per rank, below the rows' rounding).
* ``comm_inventory`` equals the calls, in order, and the bytes that pass
  through ``shard._all_reduce_sum`` and ``shard._all_gather`` (recorded by
  wrapping them) in a small sharded wavefront frame, scan frame and
  ``sharded_loss_and_grad`` step over gloo on the CPU: at world size 1 in
  this process and on two spawned ranks.
* ``--write`` writes ``out/SCALING_h100.json`` and nothing else, and the
  defaults hold no TPU figure.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import pytest
import torch

from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import rng as rng_mod
from owl_path_tracer_tpu_torch.parallel import shard
from owl_path_tracer_tpu_torch.render import film as tfilm
from owl_path_tracer_tpu_torch.tools import comm_model

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H, CHUNK = 10, 6, 16  # 60 pixels: at two ranks 30 each, two scan chunks of 16
SETTINGS = tscene.RenderSettings(width=W, height=H, max_samples=2, max_path_depth=2, environment_auto=True)
JAX_INPUTS = [  # (t1, size, mats, load balance, bw within a node, bw across hosts)
    (22.0, 1024, 12, 0.977, 45e9, 25e9),  # the JAX tool's defaults
    (3.5, 512, 30, 0.8756, 450e9, 50e9),
]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_comm_model", REPO / "tools" / "comm_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_rows(monkeypatch, t1, size, mats, lb, bw1, bw2):
    argv = ["comm_model.py", "--t1", repr(t1), "--size", str(size), "--mats", str(mats), "--load-balance",
            repr(lb), "--bw-ici", repr(bw1), "--bw-dcn", repr(bw2)]
    out = io.StringIO()
    with monkeypatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", argv)
        _jax_tool().main()
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_allreduce_s_equals_jax():
    jax_tool = _jax_tool()
    for n in (1, 2, 3, 8, 9, 64):
        for size in (0, 4, 12582912):
            for bw in (25e9, 450e9):
                assert comm_model.allreduce_s(size, n, bw) == jax_tool.allreduce_s(size, n, bw)


@pytest.mark.parametrize("inputs", JAX_INPUTS, ids=["jax_defaults", "h100_like"])
def test_rows_equal_jax_formulas(monkeypatch, inputs):
    t1, size, mats, lb, bw1, bw2 = inputs
    want = _jax_rows(monkeypatch, *inputs)
    got = comm_model.model_rows(t1, size, mats, lb, bw1, bw2)
    assert [r["devices"] for r in got] == [r["devices"] for r in want] == list(comm_model.DEVICES)
    jax_tool = _jax_tool()
    for g, w in zip(got, want):
        n = g["devices"]
        assert g["film_allreduce_bytes"] == w["film_allreduce_bytes"] == size * size * 12
        assert g["t_allreduce_nvlink_ms"] == w["t_allreduce_ici_ms"]
        assert g["t_allreduce_net_ms"] == w["t_allreduce_dcn_ms"]
        assert g["t_compute_s"] == w["t_compute_s"]
        assert g["implied_efficiency_nvlink"] == w["implied_efficiency_ici"]
        assert g["implied_efficiency_net_hosts"] == w["implied_efficiency_dcn_hosts"]
        # one all-reduce per material field and one for the loss, where JAX counts one [M,17] psum
        assert g["grad_allreduce_bytes_per_step"] == w["grad_allreduce_bytes_per_step"] + 4
        assert g["grad_allreduces_per_step"] == 16
        # unrounded: the JAX formula, with the port's frame collectives as t_comm
        t_comm = jax_tool.allreduce_s(size * size * 12, n, bw1) + comm_model.allgather_s(8, n, bw1)
        assert comm_model.implied_efficiency(t1, n, lb, t_comm) == (t1 / n) / (t1 / (n * lb) + t_comm)


def test_material_fields_are_the_jax_psum_columns():
    fields = comm_model.material_field_bytes()
    assert len(fields) == 15 and sum(fields.values()) == 17 * 4
    assert fields["base_color"] == 12


def _recording():
    """Wrap shard's two collectives -> (undo, the list they append (op, bytes) to)."""
    calls = []
    reduce_, gather = shard._all_reduce_sum, shard._all_gather

    def all_reduce(mesh, x):
        calls.append(("all_reduce", x.numel() * x.element_size()))
        return reduce_(mesh, x)

    def all_gather(mesh, x):
        calls.append(("all_gather", x.numel() * x.element_size()))
        return gather(mesh, x)

    shard._all_reduce_sum, shard._all_gather = all_reduce, all_gather

    def undo():
        shard._all_reduce_sum, shard._all_gather = reduce_, gather

    return undo, calls


def record_collectives(mesh):
    """Every sharded entry point on a small cornell-box frame, each
    collective recorded -> ({path: [(op, bytes), ...]}, materials)."""
    sc = tscene.compile_scene(REPO / "assets", "cornell-box", (W, H), device="cpu")
    accel = tfilm.make_accel(sc, "cluster", cluster_size=64)
    undo, calls = _recording()
    out = {}
    try:
        shard.render_image_wavefront_sharded(sc, SETTINGS, mesh=mesh, accel=accel, lanes_per_chip=64,
                                             iters_per_launch=4)
        out["wavefront_frame"], calls[:] = list(calls), []
        shard.render_image_sharded(sc, SETTINGS, mesh=mesh, accel=accel, pixel_chunk=CHUNK)
        out["scan_frame"], calls[:] = list(calls), []
        px = tfilm._pixel_grid(W, H, "cpu")
        per = px.shape[0] // mesh.size
        px = px[mesh.rank * per : (mesh.rank + 1) * per]
        fn = shard.sharded_loss_and_grad(mesh, sc, SETTINGS, accel, 1)
        fn(sc.materials, px, rng_mod.seed(px[:, 0], px[:, 1]), torch.zeros((per, 3)))
        out["gradient_step"] = list(calls)
    finally:
        undo()
    return out, sc.materials.count


def _expanded(inventory):
    return {path: [(e["op"], e["bytes"]) for e in entries for _ in range(e["count"])]
            for path, entries in inventory.items()}


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    store = tmp_path_factory.mktemp("store1") / "store"
    mesh = shard.make_pixel_mesh("cpu", init_method=store.as_uri(), rank=0, world_size=1)
    yield mesh
    mesh.close()


def test_inventory_equals_recorded_collectives_world1(world1):
    recorded, mats = record_collectives(world1)
    assert _expanded(comm_model.comm_inventory(W, H, mats, 1, pixel_chunk=CHUNK)) == recorded
    assert recorded["scan_frame"][:4] == [("all_reduce", 8)] * 4  # 60 pixels in chunks of 16


def test_inventory_equals_recorded_collectives_two_ranks(tmp_path):
    results = shard.spawn_ranks(record_collectives, 2, device="cpu", timeout_s=600, store_dir=tmp_path)
    (rank0, mats), (rank1, _) = results
    assert rank0 == rank1
    want = _expanded(comm_model.comm_inventory(W, H, mats, 2, pixel_chunk=CHUNK))
    assert want == rank0
    assert rank0["scan_frame"] == [("all_reduce", 8)] * 2 + [("all_gather", 30 * 12)]
    assert len(rank0["gradient_step"]) == 16 and rank0["gradient_step"][0] == ("all_reduce", 4)


def test_inventory_of_an_odd_split_pads_the_scan_shard():
    inv = comm_model.comm_inventory(W, H, 3, 7, pixel_chunk=4)["scan_frame"]
    assert inv == [{"op": "all_reduce", "what": "ray count per pixel chunk", "count": 3, "bytes": 8},
                   {"op": "all_gather", "what": "image shard", "count": 1, "bytes": 9 * 12}]


def test_write_goes_under_out_only(monkeypatch, tmp_path, capsys):
    assert comm_model.OUT_DIR == REPO / "out"
    assert "out/" in (REPO / ".gitignore").read_text().splitlines()
    monkeypatch.setattr(comm_model, "OUT_DIR", tmp_path / "out")
    monkeypatch.chdir(tmp_path)
    out = comm_model.main(["--write"])
    assert sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*")) == ["out", "out/SCALING_h100.json"]
    assert json.loads((tmp_path / "out" / "SCALING_h100.json").read_text()) == json.loads(json.dumps(out))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(comm_model.DEVICES) + 2 and lines[-1].startswith("wrote ")


def test_defaults_hold_no_tpu_figure(capsys):
    args = comm_model.parse_args([])
    assert "launches" not in vars(args)
    for got, tpu in ((args.t1, 22.0), (args.load_balance, 0.977), (args.bw_nvlink, 45e9), (args.bw_net, 25e9)):
        assert got != tpu
    out = comm_model.main([])
    assert out["inputs"]["bandwidths"].startswith("assumed (spec), not measured")
    assert "H100" in out["inputs"]["t1_source"] and "measure_balance" in out["inputs"]["load_balance_source"]
    assert all(0.0 < r[k] <= 1.0 for r in out["model"] for k in r if k.startswith("implied_efficiency_"))
    given = comm_model.main(["--bw-nvlink", "45e9"])["inputs"]
    assert given["bandwidths"] == "given, not measured"
    assert len(capsys.readouterr().out.splitlines()) == 2 * (len(comm_model.DEVICES) + 1)
