"""The port's throughput bench (``owl_path_tracer_tpu_torch/tools/bench.py``)
against the repository's ``bench.py``, on the CPU at small sizes.

* Its flags are ``bench.py``'s (names and defaults) plus ``--device``;
  ``bench.py`` parses before it imports anything of the JAX package, so its
  flags are read from ``python bench.py --help`` and from its parser's
  namespace, stopped right after parsing.
* ``main`` prints the device line, the trend line and the headline LAST;
  ``--quick`` is 256^2, spp 2, subdivision 6 and no trend (``run_config``
  replaced, so nothing renders).
* At tiny configs (cornell-box and the sphere, 16^2, spp 2, depth 2,
  ``fused2`` and ``cluster``, wavefront and scan) the port's live rays equal
  the JAX package's ``render_image_wavefront`` / ``add_samples`` rays
  exactly (Pallas in interpret mode on the CPU).
* The label equals ``bench.run_config``'s with ``readback_f16=False``.
* Without a card the default ``--device cuda`` raises.
"""
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu.render import film as jfilm
from owl_path_tracer_tpu.render import wavefront as jwf
from owl_path_tracer_tpu_torch.tools import bench

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMI = "NVIDIA H100 80GB HBM3, 700.00 W"
TINY = ["--device", "cpu", "--size", "16", "--spp", "2", "--depth", "2", "--lanes", "256", "--pixel-chunk", "128"]


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _jax_namespace(monkeypatch, argv):
    """``bench.py``'s parsed arguments for ``argv``, stopped right after parsing."""
    import argparse

    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", stop)
        mp.setattr(sys, "argv", ["bench.py", *argv])
        with pytest.raises(_Parsed) as parsed:
            _jax_bench().main()
    return parsed.value.args[0]


def _flags(text):
    return set(re.findall(r"(?<![\w-])--[a-z0-9][a-z0-9-]*", text))


def test_flags_are_bench_py_flags_plus_device(capsys):
    proc = subprocess.run([sys.executable, "bench.py", "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    with pytest.raises(SystemExit):
        bench.parse_args(["--help"])
    port = _flags(capsys.readouterr().out)
    want = _flags(proc.stdout)
    assert len(want) >= 19 and port == want | {"--device"}, (port ^ want)


def test_defaults_equal_bench_py(monkeypatch):
    want = vars(_jax_namespace(monkeypatch, []))
    got = vars(bench.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_intersector_choices_equal_bench_py(monkeypatch):
    for kind in bench.INTERSECTORS:
        assert _jax_namespace(monkeypatch, ["--intersector", kind]).intersector == kind
    with pytest.raises(SystemExit):
        bench.parse_args(["--intersector", "mxu"])


def test_no_readback_f16_is_accepted_and_changes_nothing():
    a, b = bench.parse_args([]), bench.parse_args(["--no-readback-f16"])
    assert a.readback_f16 and not b.readback_f16
    kw = dict(scene_name="dragon7", n_tris=327684, size=1024, spp=64, depth=4)
    assert bench.label(a, **kw) == bench.label(b, **kw)
    assert "f16-readback" not in bench.label(a, **kw)


class _Recorder:
    """``run_config`` stand-in: records its calls, renders nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, args, scene_name, size, spp, depth, nee=False):
        self.calls.append(dict(intersector=args.intersector, scene=scene_name, size=size, spp=spp, depth=depth,
                               nee=nee, sub=args.dragon_sub))
        n_tris = {"dragon": 81924, "dragon7": 327684}.get(scene_name, 1000)
        return 5.0 + len(self.calls), bench.label(args, scene_name, n_tris, size, spp, depth, nee), 1000, 0.2


@pytest.fixture
def recorded(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(bench, "run_config", rec)
    monkeypatch.setattr(bench.pc, "generated_dragon", lambda sub: "dragon" if sub <= 6 else f"dragon{sub}")
    monkeypatch.setattr(bench.pc, "device_name", lambda device: SMI)
    return rec


def test_trend_line_first_and_headline_last(recorded, capsys):
    records = bench.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == records and len(lines) == 3
    info, trend, head = lines
    assert info == {"device": SMI, "configs": [
        {"metric": "dragon 81k tris 512^2 spp=4 depth=4, fused2 intersector, wavefront", "rays": 1000,
         "seconds": 0.2},
        {"metric": "dragon7 327k tris 1024^2 spp=64 depth=4, fused2-bf16 intersector, wavefront", "rays": 1000,
         "seconds": 0.2}]}
    assert trend["metric"] == "trend Mrays/s (frozen: dragon 81k tris 512^2 spp=4 depth=4, fused2 intersector, " \
                              "wavefront)"
    assert head["metric"] == "fwd Mrays/s (dragon7 327k tris 1024^2 spp=64 depth=4, fused2-bf16 intersector, " \
                             "wavefront)"
    for rec, value in ((trend, 6.0), (head, 7.0)):
        assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
        assert rec["value"] == value and rec["unit"] == "Mrays/s"
        assert rec["vs_baseline"] == round(value / bench.BASELINE_MRAYS, 4)
    assert recorded.calls == [
        dict(intersector="fused2", scene="dragon", size=512, spp=4, depth=4, nee=False, sub=7),
        dict(intersector="fused2-bf16", scene="dragon7", size=1024, spp=64, depth=4, nee=False, sub=7)]


def test_trend_follows_depth_and_keeps_the_rest_frozen(recorded, capsys):
    bench.main(["--device", "cpu", "--depth", "6", "--spp", "8", "--size", "64", "--intersector", "cluster",
                "--nee"])
    trend, head = recorded.calls
    assert trend == dict(intersector="fused2", scene="dragon", size=512, spp=4, depth=6, nee=False, sub=7)
    assert head == dict(intersector="cluster", scene="dragon7", size=64, spp=8, depth=6, nee=True, sub=7)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"].endswith("wavefront, nee)")


def test_quick_is_small_and_has_no_trend(recorded, capsys):
    args = bench.parse_args(["--quick"])
    assert (args.size, args.spp, args.dragon_sub, args.no_trend) == (256, 2, 6, True)
    bench.main(["--device", "cpu", "--quick"])
    assert recorded.calls == [dict(intersector="fused2-bf16", scene="dragon", size=256, spp=2, depth=4, nee=False,
                                   sub=6)]
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[-1])["metric"].startswith("fwd Mrays/s (dragon 81k tris 256^2")


@pytest.mark.parametrize("flags", [["--no-trend"], ["--scene", "cornell-box"]], ids=["no_trend", "not_dragon"])
def test_no_trend_line(recorded, monkeypatch, capsys, flags):
    monkeypatch.setattr(bench.pc, "generate", lambda code: "")
    bench.main(["--device", "cpu", *flags])
    assert len(recorded.calls) == 1 and len(capsys.readouterr().out.strip().splitlines()) == 2


def test_default_device_raises_without_a_card(monkeypatch, recorded):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench.main(["--quick"])
    assert recorded.calls == []


def _jax_rays(name, kind, renderer):
    js = jscene.compile_scene(REPO / "assets", name, (16, 16))
    s = jscene.RenderSettings(width=16, height=16, max_samples=2, max_path_depth=2, environment_auto=True,
                              environment_intensity=1.0)
    accel = jfilm.make_accel(js, kind, cluster_size=None)
    if renderer == "wavefront":
        return jwf.render_image_wavefront(js, s, accel=accel, lanes=256, fused2_block=256, fused2_sort=True,
                                          readback_f16=False, iters_per_launch=32, fused_nee=False)[1]
    return jfilm.add_samples(js, s, jfilm.new_film(s), 2, pixel_chunk=128, accel=accel).rays_traced


@pytest.mark.parametrize("renderer", ["wavefront", "scan"])
@pytest.mark.parametrize("kind", ["fused2", "cluster"])
@pytest.mark.parametrize("name", ["cornell-box", "sphere"])
def test_live_rays_equal_jax(name, kind, renderer):
    args = bench.parse_args([*TINY, "--scene", name, "--intersector", kind, "--renderer", renderer])
    mrays, label, rays, seconds = bench.run_config(args, name, 16, 2, 2)
    want = int(_jax_rays(name, kind, renderer))
    assert rays == want > 16 * 16 * 2
    assert seconds > 0 and mrays == rays / seconds / 1e6
    assert label.startswith(f"{name} ")
    assert label.endswith(f"tris 16^2 spp=2 depth=2, {kind} intersector, {renderer}")


@pytest.mark.parametrize("renderer,nee,kind", [("wavefront", False, "cluster"), ("scan", True, "brute"),
                                               ("wavefront", True, "brute")])
def test_label_equals_bench_py_without_f16_readback(monkeypatch, renderer, nee, kind):
    jargs = _jax_namespace(monkeypatch, [])
    jargs.intersector, jargs.renderer, jargs.readback_f16 = kind, renderer, False
    jargs.lanes, jargs.pixel_chunk = 256, 128
    monkeypatch.chdir(REPO)  # bench.py reads "assets" from the working directory
    _, want = _jax_bench().run_config(jargs, "cornell-box", 8, 1, 2, nee=nee)
    assert "f16-readback" not in want
    args = bench.parse_args([*TINY, "--intersector", kind, "--renderer", renderer])
    assert args.readback_f16  # the flag's default: bench.py would add ", f16-readback" here
    _, label, rays, _ = bench.run_config(args, "cornell-box", 8, 1, 2, nee=nee)
    assert label == want and rays > 0
