"""The host side of K5's block-wide step (``ops/fused.py``): its entries and
their registry, the plain versions of the pre-pass (``block_weights``) and
block order (``block_order``) against direct counts and the kernel's rank
rule, and the wrappers' checks, which raise without a CUDA device instead of
falling back.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` holds it
to the plain version there.  Counts and orders are integers and compared
exactly.
"""
import re

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu_torch.ops import cluster as tcl
from owl_path_tracer_tpu_torch.ops import fused as tfu

torch.set_num_threads(2)


def _soup(n_tris=600, seed=0):
    r = np.random.default_rng(seed)
    tri = r.uniform(-4, 4, (n_tris, 1, 3)) + r.normal(0, 0.4, (n_tris, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(n_tris, 3)
    return verts, idx, r


@pytest.fixture(scope="module")
def scene():
    """600 random triangles in clusters of C=8 and 256 rays (a quarter with
    a short t_max); the last 64 rays point away from every box (no cluster
    entered), so block 3 of 64 has no active ray."""
    verts, idx, r = _soup()
    fb = tfu.build_fused(tcl.build_clusters(verts, idx, 8, device="cpu"))
    n = 256
    o = r.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    o[-64:] = np.float32([0.0, 0.0, 50.0])
    d[-64:] = np.float32([0.0, 0.0, 1.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(r.random(n) < 0.25, r.uniform(1.0, 4.0, n), 1e10).astype(np.float32)
    return fb, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax)


def test_step_registry():
    """One traversal entry, counted in LAUNCHES and reset by reset_counts
    (the profile entry is not counted); the profile rows carry each block's
    phases, steps, launch rank and weight, the count rows each ray's
    rescans, boxes and clusters tested."""
    assert tfu.ENTRY == "owlpt_fused_traverse" and tfu.PROFILE_ENTRY == "owlpt_fused_traverse_profile"
    assert set(tfu.LAUNCHES) == {tfu.ENTRY}
    assert tfu.COUNT_COLS == ("rescans", "boxes", "clusters")
    assert tfu.PROFILE_COLS[:6] == ("setup", "pick_stage", "slot_loop", "rescans", "total", "steps")
    assert tfu.PROFILE_COLS[6:] == ("rank", "weight")
    saved = dict(tfu.LAUNCHES)
    try:
        for name in tfu.LAUNCHES:
            tfu.LAUNCHES[name] = 3
        tfu.reset_counts()
        assert all(v == 0 for v in tfu.LAUNCHES.values()) and tfu.UNRESOLVED_RAYS == 0
    finally:
        tfu.LAUNCHES.update(saved)


def test_source_declares_the_registry():
    """The kernel source's entries and profile widths are the registry's:
    the traversal, profile and resource entries are its only extern "C"
    functions, kProfileCols is len(PROFILE_COLS) and kCountCols
    len(COUNT_COLS)."""
    src = tfu.CSRC.read_text()
    declared = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert declared == {tfu.ENTRY, tfu.PROFILE_ENTRY, f"{tfu.ENTRY}_resources"}
    assert re.search(rf"constexpr int kProfileCols = {len(tfu.PROFILE_COLS)};", src)
    assert re.search(rf"constexpr int kCountCols = {len(tfu.COUNT_COLS)};", src)


@pytest.mark.parametrize("max_steps", [0, 1, 3, tfu.MAX_STEPS])
def test_cpu_tensors_take_the_plain_version_for_every_step(scene, max_steps):
    """On CPU tensors the sweep gives the plain version's output at every
    max_steps and launches nothing."""
    fb, o, d, tmax = scene
    launches = dict(tfu.LAUNCHES)
    got = tfu.fused_traverse(o, d, tmax, fb, 64, max_steps)
    want = tfu.fused_traverse_plain(o, d, tmax, fb, 64, max_steps)
    assert torch.equal(got, want) and tfu.LAUNCHES == launches
    assert (got[:, 6] <= max_steps).all()


def test_cuda_requests_raise_without_a_device(scene, monkeypatch):
    """Without a CUDA device the kernel path raises, and so do the profile
    entry and the resource query; the plain version is not called and no
    launch is counted."""
    fb, o, d, tmax = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_fallback(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(tfu, "fused_traverse_plain", no_fallback)
    launches = dict(tfu.LAUNCHES)
    meta = lambda x: torch.zeros(x.shape, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu.fused_traverse(meta(o), meta(d), meta(tmax), fb.to("meta"), 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu._fused_traverse_cuda(tfu.pack_rays(o, d, tmax), fb, 64, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu.fused_traverse_profile(o, d, tmax, fb, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfu.kernel_resources(fb, 64)
    assert tfu.LAUNCHES == launches


@pytest.mark.parametrize("block", [32, 64, 128])
def test_block_weights_count_the_distinct_entered_groups(scene, block):
    """block_weights: per block the distinct group boxes its rays enter
    within their t_max, counted here ray by ray from each group box's slab
    entry (the kernel's ops: ops/cluster.py _cluster_entries); a block whose
    rays enter no box weighs 0 and the plain version retires nothing
    there."""
    fb, o, d, tmax = scene
    got = tfu.block_weights(o, d, tmax, fb, block)
    gent = tcl._cluster_entries(o, d, tfu._boxes_as_clusters(fb.groups), tfu.m.T_MIN, tmax)
    want = []
    for g in range(o.shape[0] // block):
        entered = set()
        for i in range(g * block, (g + 1) * block):
            entered.update(j for j in range(fb.groups.shape[1]) if torch.isfinite(gent[i, j]))
        want.append(len(entered))
    assert got.tolist() == want
    steps = tfu.fused_traverse_plain(o, d, tmax, fb, block)[:, 6].view(-1, block)[:, 0]
    live = o.shape[0] // block - 64 // block  # the blocks before those of the last 64 rays
    assert (got[live:] == 0).all() and (got[:live] > 0).all()
    assert (steps[live:] == 0).all() and (steps[:live] > 0).all()


def test_block_weights_need_whole_blocks(scene):
    fb, o, d, tmax = scene
    with pytest.raises(ValueError, match="multiple"):
        tfu.block_weights(o[:100], d[:100], tmax[:100], fb, 64)


def _rank_rule(weights):
    """csrc/fused_traverse.cu order_blocks, as written there: block i goes
    to rank = #{j: w_j > w_i or (w_j == w_i and j < i)}."""
    order = [None] * len(weights)
    for i, e in enumerate(weights):
        rank = sum(1 for j, f in enumerate(weights) if f > e or (f == e and j < i))
        order[rank] = i
    return order


@pytest.mark.parametrize("weights", [
    [5, 1, 9, 9, 0, 3, 9, 1],
    [4] * 7,
    list(range(12)),
    [0, 0, 2, 0, 2, 1],
    np.random.default_rng(3).integers(0, 40, 100).tolist(),
], ids=["ties", "all_equal", "ascending", "zeros", "random"])
def test_block_order_is_the_kernels_rank_rule(weights):
    """block_order equals order_blocks' stable counting rank: a permutation
    of the blocks, weights non-increasing along it, equal weights in block
    order."""
    order = tfu.block_order(torch.tensor(weights, dtype=torch.int32))
    assert order.tolist() == _rank_rule(weights)
    assert sorted(order.tolist()) == list(range(len(weights)))
    w = torch.tensor(weights)[order]
    assert (w[:-1] >= w[1:]).all()


def test_block_order_puts_the_heaviest_block_first(scene):
    """On the scene's rays at block 32: the first block launched enters the
    most group boxes, and the block with no active ray goes last."""
    fb, o, d, tmax = scene
    w = tfu.block_weights(o, d, tmax, fb, 32)
    order = tfu.block_order(w)
    assert w[order[0]] == w.max() and int(order[-1]) == o.shape[0] // 32 - 1
