"""The port's latency probe (ops/latency_probe.py, tools/latency_probe.py)
against the JAX reference, ``tools/tpu_probe6.py``'s ``mini_kernel``.

The reference runs as it is: its ``main()`` with ``load`` and ``timeit``
replaced by small ones (cornell-box, C = 64, 2048 bounce rays, blocks of
128), ``jax.jit`` made the identity and every ``pallas_call`` run in
interpret mode, capturing its inputs and [G,B,16] output.  The port's plain
version runs on the same inputs.  Tolerances:
  * column 0's hit/miss mask (t < t_max) equal; at most 0.5% of the rays may
    differ where a slot sits on the window's edge (measured: none);
  * t where both hit, rtol 5e-6: XLA's dot blocks its sums and contracts
    them with FMA, the port sums the 16 products in row order without it
    (measured 1.8e-6);
  * ``*_recip`` variants (``pick_dma_mm_bf16`` among them), rtol 4e-3: the
    reference's approximate reciprocal lowers, off the TPU, to the
    reciprocal of the divisor rounded to bf16, rounded to bf16 (at most
    2^-8 relative); the port's plain version divides exactly (measured
    3.9e-3);
  * columns 1-15 zero.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jpl

from owl_path_tracer_tpu.models import scene as jscene
from owl_path_tracer_tpu_torch.models import scene as tscene
from owl_path_tracer_tpu_torch.ops import fused2 as tf2
from owl_path_tracer_tpu_torch.ops import latency_probe as lp
from owl_path_tracer_tpu_torch.tools import latency_probe as tool
from owl_path_tracer_tpu_torch.tools import probe_common

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ASSETS = ROOT / "assets"
ALL_VARIANTS = [*lp.VARIANTS, "interleave2", "interleave4"]
ITERS = (0, 4, 8)
C, N, B = 64, 2048, 128


@pytest.fixture(scope="module")
def reference():
    """{(variant, iters): (rays [G,B,8], boxes, planes, output [G,B,16])} of
    the reference's own main() in interpret mode, and its JSON lines."""
    sys.path.insert(0, str(ROOT / "tools"))
    sys.path.insert(0, str(ASSETS))
    import tpu_probe6

    captured = []
    orig = jpl.pallas_call

    def interpret_call(*args, **kw):
        kw["interpret"] = True
        call = orig(*args, **kw)

        def run(*operands):
            out = call(*operands)
            captured.append(([np.asarray(x) for x in operands], np.asarray(out)))
            return out

        return run

    def load(sub):
        return (jscene.compile_scene(ASSETS, "cornell-box", (64, 64)),
                jscene.RenderSettings(width=64, height=64, max_samples=1, max_path_depth=4))

    argv = ["tpu_probe6.py", "--c", str(C), "--n", str(N), "--b", str(B), "--iters", ",".join(map(str, ITERS)),
            "--variants", ",".join(ALL_VARIANTS)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpl, "pallas_call", interpret_call)
        mp.setattr(jax, "jit", lambda f=None, **kw: f)
        mp.setattr(tpu_probe6, "load", load)
        mp.setattr(tpu_probe6, "timeit", lambda fn, repeats=3: 1e-3)
        mp.setattr(sys, "argv", argv)
        tpu_probe6.main()
    keys = [(name, it) for name in ALL_VARIANTS for it in ITERS]
    assert len(captured) == len(keys)
    return dict(zip(keys, captured))


@pytest.mark.parametrize("name", ALL_VARIANTS)
def test_plain_matches_jax_mini_kernel(reference, name):
    v = lp.variant(name)
    for it in ITERS:
        (rays, boxes, planes), want = reference[(name, it)]
        planes_t = torch.as_tensor(planes.astype(np.float32)).to(torch.bfloat16 if v.bf16 else torch.float32)
        got = lp.latency_probe(torch.as_tensor(rays.reshape(-1, 8)), torch.as_tensor(boxes), planes_t, name, it,
                               B).numpy()
        assert got.shape == want.shape == (N // B, B, 16)
        assert (got[..., 1:] == 0).all() and (want[..., 1:] == 0).all()
        t_max = rays[..., 6]
        hit_g, hit_w = got[..., 0] < t_max, want[..., 0] < t_max
        assert (hit_g != hit_w).mean() <= 0.005, f"{name} iters {it}"
        both = hit_g & hit_w
        np.testing.assert_allclose(got[..., 0][both], want[..., 0][both], rtol=4e-3 if v.recip else 5e-6,
                                   err_msg=f"{name} iters {it}")
        np.testing.assert_array_equal(got[..., 0][~hit_g & ~hit_w], t_max[~hit_g & ~hit_w])
        if not (v.mm and v.copy) or it == 0:
            assert not hit_g.any()  # nothing to hit: no product, a zero buffer, or no iteration
        elif it == ITERS[-1]:
            assert hit_g.any(), f"{name}: no ray hits"


def test_port_builds_the_reference_inputs(reference):
    """The port's own scene, clusters and probe rays give the reference's
    boxes and planes bit for bit and its rays to the tolerance of
    tests/test_torch_scene.py's primary rays."""
    sys.path.insert(0, str(ROOT / "tools"))
    import tpu_probe2

    (rays, boxes, planes), _ = reference[("pick_dma_mm", ITERS[-1])]
    scene = tscene.compile_scene(ASSETS, "cornell-box", (64, 64), device="cpu")
    fb = tf2.build_fused2_scene(scene, cluster_size=C)
    np.testing.assert_array_equal(fb.boxes.numpy(), boxes)
    np.testing.assert_array_equal(fb.planes.numpy(), planes)
    for kind in ("primary", "bounce"):
        o, d = probe_common.make_rays(scene, N, kind)
        o_j, d_j = tpu_probe2.make_rays(jscene.compile_scene(ASSETS, "cornell-box", (64, 64)), N, kind)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=1e-6, atol=2.4e-7)
    o, d = probe_common.make_rays(scene, N, "bounce")
    np.testing.assert_allclose(tf2.pack_rays(o, d, 1e10).numpy(), rays.reshape(-1, 8), rtol=1e-6, atol=1e-6)


def test_variant_table():
    assert list(lp.VARIANTS) == ["nop_loop", "pick_only", "sched_mm", "sched_mm_bf16", "sched_mm_recip",
                                 "sched_dma", "sched_dma_bf16", "sched_dma_mm", "pick_dma_mm", "pick_dma_mm_bf16"]
    assert lp.variant("pick_dma_mm_bf16") == lp.Variant("pick_dma_mm_bf16", True, True, True, True, True)
    v = lp.variant("interleave4")
    assert (v.pick, v.copy, v.mm, v.bf16, v.recip, v.chains) == (True, True, True, False, False, 4)
    assert v.flags == 7 and lp.variant("sched_mm_recip").flags == 4 | 16
    assert [lp.trips(v, i) for i in (0, 3, 4, 16)] == [0, 0, 1, 4]
    for bad in ("interleave", "interleave0", f"interleave{lp.MAX_CHAINS + 1}", "pipe", "pick_dma"):
        with pytest.raises(ValueError):
            lp.variant(bad)
    with pytest.raises(ValueError, match="bfloat16"):  # a bf16 variant needs bf16 planes
        lp.latency_probe_plain(torch.zeros((128, 8)), torch.zeros((8, 4)), torch.zeros((4, 16, 32)),
                               "sched_mm_bf16", 1, 128)


def test_pick_retires_lowest_id_of_the_minimum():
    bent = torch.tensor([[torch.inf, 2.0, 1.0, 1.0, torch.inf]])
    col = torch.arange(5)
    assert [int(lp._pick(bent, col, 5)) for _ in range(5)] == [2, 3, 1, 0, 0]  # an all-inf row keeps picking 0
    assert torch.isinf(bent).all()


H100_SMEM = 232448  # opt-in shared memory per block of an H100


def test_tile_sizing():
    """Whole clusters where P buffers fit, halved tiles where not; the
    formula is the kernel source's."""
    k, b = 768, 256
    head = 4 * ((k + 10 * b + 64 + 3) & ~3)
    assert lp.shared_bytes(k, 1, b, 512, False) == head + 16 * 4 * 512 * 4  # 131 KB of planes
    assert [lp.tile_cols(512, k, p, b, False, H100_SMEM) for p in (1, 2, 4)] == [512, 256, 128]
    assert [lp.tile_cols(512, k, p, b, True, H100_SMEM) for p in (1, 2, 4)] == [512, 512, 256]
    assert lp.tile_cols(64, 300, 16, 128, False, H100_SMEM) == 32  # 16 whole clusters of C=64 need 262 KB
    for p in (1, 2, 4, 16):
        tile = lp.tile_cols(512, k, p, b, False, H100_SMEM)
        assert lp.shared_bytes(k, p, b, tile, False) <= H100_SMEM and 512 % tile == 0 and tile % lp.TILE_ALIGN == 0
    with pytest.raises(ValueError, match="even with tiles of 8 slots"):
        lp.tile_cols(512, k, 4, b, False, 20000)
    with pytest.raises(ValueError, match="multiple of 8"):
        lp.tile_cols(60, k, 1, b, False, H100_SMEM)


def test_cuda_request_raises_instead_of_falling_back(monkeypatch):
    """A non-CPU request goes to the kernel path, which raises without a
    CUDA device; the plain version is never called for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(lp, "latency_probe_plain", no_fallback)
    launches = dict(lp.LAUNCHES)
    args = torch.zeros((128, 8), device="meta"), torch.zeros((8, 4), device="meta"), \
        torch.zeros((4, 16, 32), device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        lp.latency_probe(*args, "pick_dma_mm", 4, 128)
    with pytest.raises(RuntimeError, match="CUDA"):  # the kernel path refuses CPU tensors too
        lp._latency_probe_cuda(torch.zeros((128, 8)), torch.zeros((8, 4)), torch.zeros((4, 16, 32)),
                               lp.variant("pick_dma_mm"), 4, 128)
    assert lp.LAUNCHES == launches


def test_tool_prints_the_reference_keys(capsys, monkeypatch):
    """The tool's JSON line per variant: the reference's keys, plus the
    tile, the medians and the device; on the CPU it runs the plain version."""
    import json

    monkeypatch.setattr(tool, "REPEATS", 1)
    args = tool.parse_args(["--device", "cpu", "--sub", "2", "--c", "16", "--n", "256", "--b", "128",
                            "--iters", "0,1,2", "--variants", "nop_loop,pick_dma_mm"])  # the dragon at subdivision 2
    _, records = tool.run(args)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == records and [r["variant"] for r in records] == ["nop_loop", "pick_dma_mm"]
    reference_keys = {"probe", "variant", "b", "k", "kind", "ms_at", "us_per_block_iter"}
    for r in records:
        assert reference_keys | {"tile", "ms_median_at", "device"} == set(r)
        assert r["probe"] == "latency" and r["b"] == 128 and r["kind"] == "bounce" and r["device"] == "cpu"
        assert list(r["ms_at"]) == ["0", "1", "2"] and r["tile"] is None
    assert tool.parse_args([]).variants.split(",") == list(lp.DEFAULT_VARIANTS)
