"""Where a fused2 block keeps its frontier row: the choice of form
(``fused2.pick_row_form``, fed on the card by the kernel library's count of
a block's bytes, ``<entry>_shared_bytes``, and the blocks per SM of each
form): the row stays in shared memory wherever the block's bytes fit under
the device's opt-in limit and it loses no block per SM by it, else it goes
to device memory, and what fits in neither form raises a ValueError
that names K, C, the block, the bytes and the limit -- here on the CPU,
with an H100's limit passed in and the bytes from :func:`block_bytes`, this
file's copy of the kernel source's ``shared_bytes`` / ``slot_shared_bytes``
(the one Python copy; tests/test_torch_cuda.py pins the library to it on
the card).  And chip_smoke.py phase 4e's widened clusters (the limit soup's
clusters padded to C=512, where a slot-parallel block of rays is a thread
block cluster of 4 CTAs sharing one row in device memory): pad slots change
no answer of the plain version.

The old cluster limits (the most K whose row fits in shared memory) are
the table that the repair lifted: at block 256 on an H100 (232,448 bytes),
C=512: 35,436 clusters (bf16 tensor entries), 36,236 (f32 tensor), 46,272
(exact CUDA-core), 49,052 (slot-parallel closest hit and mixed), 41,372
(slot-parallel any-hit); C=128: 50,796, 50,828, 53,568, 49,052, 49,052.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from owl_path_tracer_tpu_torch.ops import fused2 as tf2

H100_SMEM = 232448  # opt-in shared memory per block of an H100
BLOCK = 256

# the slot-parallel body's shape (csrc slot_ctas, slot_span): a thread block
# cluster of up to 4 CTAs per block of rays, each testing at least 4 32-slot
# chunks of a cluster; any-hit keeps one CTA up to 64 chunks
SLOT_CLUSTER, MIN_CTA_CHUNKS, ANY_HIT_CHUNKS = 4, 4, 64
# rows a block stages per cluster on CUDA cores: component p0 e1 e2 + tri
# id; MXU the 19 non-zero feature rows
STAGED_ROWS = {"component": 10, "mxu_f32": 19, "mxu_bf16": 19}


def slot_ctas(c: int, mode: str) -> int:
    """CTAs per block of rays of the slot-parallel body at C slots."""
    chunks = (c + 31) >> 5
    n = chunks // MIN_CTA_CHUNKS
    if (mode == "any_hit" and chunks <= ANY_HIT_CHUNKS) or n < 1:
        return 1
    return min(n, SLOT_CLUSTER)


def tensor_buffer_bytes(layout: str, c: int) -> int:
    """One ring buffer of the tensor-core path (csrc tensor_ops.cuh
    tensor_buffer_bytes): bf16 [10][8 C' + 16] bytes, f32 [19][row words]
    floats, C' = C rounded up to whole 8-slot n-tiles."""
    cols = (c + 7) & ~7
    if layout == "mxu_bf16":
        return 10 * (8 * cols + 16)
    return 19 * (cols + ((8 - cols) & 31)) * 4


def block_bytes(layout: str, mode: str, k: int, c: int, block: int, exact: bool = False, serial: bool = False,
                global_row: bool = False) -> int:
    """Dynamic shared memory of one block (one CTA of the slot-parallel
    body): the frontier row [K] f32, padded to a multiple of 4, unless
    ``global_row`` (then it lies in device memory), the block's ray rows
    and reductions, and the staged clusters."""
    row = 0 if global_row else (k + 3) & ~3
    if layout == "component" and not serial:
        ctas = slot_ctas(c, mode)
        span = (((c + 31) >> 5) + ctas - 1) // ctas * 32
        return 4 * 2 * 10 * span + 16 * 2 * block + 8 * 2 * block + 4 * (row + 8 * block + 5 * block + 36 + 64)
    tail = 4 * (row + 8 * block + 64)
    if layout != "component" and not exact:  # the tensor-core ring of two clusters and a zero row
        return 2 * tensor_buffer_bytes(layout, c) + 16 + tail
    return 4 * STAGED_ROWS[layout] * c + tail


def old_limit(layout, mode, c, exact=False):
    """The most K whose row fits in shared memory (the shared form's limit)."""
    return max((H100_SMEM - block_bytes(layout, mode, 0, c, BLOCK, exact)) // 4 & ~3, 0)


def form(layout, mode, k, c, exact=False, force=None):
    """fused2.pick_row_form on this file's byte counts at an H100's limit."""
    nbytes = {f: block_bytes(layout, mode, k, c, BLOCK, exact, global_row=f == "global") for f in tf2.ROW_FORMS}
    return tf2.pick_row_form(f"{layout} {mode}", k, c, BLOCK, nbytes, H100_SMEM, force)


# (layout, mode, exact) of each column of the table
COLUMNS = {
    "bf16 tensor": ("mxu_bf16", "closest", False),
    "f32 tensor": ("mxu_f32", "closest", False),
    "exact CUDA-core": ("mxu_f32", "closest", True),
    "slot-parallel closest / mixed": ("component", "closest", False),
    "slot-parallel any-hit": ("component", "any_hit", False),
}
TABLE = {
    512: {"bf16 tensor": 35436, "f32 tensor": 36236, "exact CUDA-core": 46272,
          "slot-parallel closest / mixed": 49052, "slot-parallel any-hit": 41372},
    128: {"bf16 tensor": 50796, "f32 tensor": 50828, "exact CUDA-core": 53568,
          "slot-parallel closest / mixed": 49052, "slot-parallel any-hit": 49052},
}


@pytest.mark.parametrize("c", list(TABLE))
@pytest.mark.parametrize("column", list(COLUMNS))
def test_old_limit_table(column, c):
    """The byte count gives ROADMAP's table of old cluster limits; the
    mixed sweep's equals closest hit's, and K one above the limit is the
    first K whose row no longer fits."""
    layout, mode, exact = COLUMNS[column]
    want = TABLE[c][column]
    assert old_limit(layout, mode, c, exact) == want
    assert block_bytes(layout, mode, want, c, BLOCK, exact) <= H100_SMEM
    assert block_bytes(layout, mode, want + 1, c, BLOCK, exact) > H100_SMEM
    if mode == "closest" and not exact:
        assert old_limit(layout, "mixed", c) == want


@pytest.mark.parametrize("c", list(TABLE))
@pytest.mark.parametrize("column", list(COLUMNS))
def test_row_form_goes_to_device_memory_above_the_limit(column, c):
    """Up to the old limit the row stays in shared memory; above it the
    global form launches, whose bytes do not depend on K (the row is gone
    from shared memory), at any K."""
    layout, mode, exact = COLUMNS[column]
    old = TABLE[c][column]
    assert form(layout, mode, old, c, exact) == "shared"
    for k in (old + 1, 4 * old, 10**6):
        assert form(layout, mode, k, c, exact) == "global"
    global_bytes = {block_bytes(layout, mode, k, c, BLOCK, exact, global_row=True) for k in (1, old, 10**6)}
    assert len(global_bytes) == 1 and global_bytes.pop() <= H100_SMEM


def test_global_form_bytes_leave_out_the_padded_row():
    """The shared form counts the row [K] padded to a multiple of 4 floats;
    the global form counts none of it, for every body."""
    for layout, mode, exact, serial in (("mxu_bf16", "closest", False, False), ("mxu_f32", "any_hit", False, False),
                                        ("mxu_f32", "closest", True, False), ("component", "mixed", False, False),
                                        ("component", "closest", False, True)):
        for k in (1, 5, 768, 1001):
            shared = block_bytes(layout, mode, k, 512, BLOCK, exact, serial)
            glob = block_bytes(layout, mode, k, 512, BLOCK, exact, serial, global_row=True)
            assert shared - glob == 4 * ((k + 3) & ~3)


def test_unlaunchable_block_raises_value_error_naming_k_and_the_limit():
    """bf16 tensor entries at C=2560: two staged clusters alone exceed an
    H100's shared memory, so neither form launches; the wrapper's check
    raises a ValueError naming K, C, the block, the bytes and the limit.  A
    forced form that does not fit raises the same way."""
    with pytest.raises(ValueError, match=r"K=20 clusters of C=2560, block 256: 418384 bytes .* limit of 232448 bytes"):
        form("mxu_bf16", "closest", 20, 2560)
    assert form("mxu_f32", "closest", 40000, 512, force="global") == "global"
    with pytest.raises(ValueError, match="K=40000 .* in shared memory, above the device's limit of 232448"):
        form("mxu_f32", "closest", 40000, 512, force="shared")
    with pytest.raises(ValueError, match="row form"):
        form("mxu_f32", "closest", 40000, 512, force="registers")


@pytest.mark.parametrize("blocks, want", [
    (None, "shared"), ({"shared": 2, "global": 2}, "shared"), ({"shared": 1, "global": 2}, "global"),
    ({"shared": 3, "global": 2}, "shared")])
def test_row_form_follows_blocks_per_sm(blocks, want):
    """Where both forms fit, the row stays in shared memory unless the
    device-memory form keeps more blocks per SM (the f32 tensor-core
    entries: 132 registers with the row in shared memory, 1 block of 256
    per SM; 127 in device memory, 2 blocks); above the old limit it goes to
    device memory whatever the blocks; a forced form ignores them."""
    k, c = 10752, 128
    nbytes = {f: block_bytes("mxu_f32", "closest", k, c, BLOCK, global_row=f == "global") for f in tf2.ROW_FORMS}
    assert tf2.pick_row_form("mxu_f32 closest", k, c, BLOCK, nbytes, H100_SMEM, blocks=blocks) == want
    assert tf2.pick_row_form("mxu_f32 closest", k, c, BLOCK, nbytes, H100_SMEM, "shared", blocks) == "shared"
    big = {f: block_bytes("mxu_f32", "closest", 10**5, c, BLOCK, global_row=f == "global") for f in tf2.ROW_FORMS}
    assert tf2.pick_row_form("mxu_f32 closest", 10**5, c, BLOCK, big, H100_SMEM, blocks=blocks) == "global"


def test_slot_shape_copy():
    """The byte count's copy of the slot-parallel shape (csrc slot_ctas): up
    to 4 CTAs of at least 4 32-slot chunks; any-hit one CTA up to 2048
    slots (pinned to the library's on the card)."""
    assert [slot_ctas(c, "closest") for c in (8, 60, 128, 512, 1024, 2560)] == [1, 1, 1, 4, 4, 4]
    assert [slot_ctas(c, "any_hit") for c in (512, 2048, 2080, 2560)] == [1, 1, 4, 4]


@pytest.mark.parametrize("mode, attrs", [("closest", True), ("any_hit", False), ("mixed", True), ("closest", False)])
def test_widened_clusters_give_the_same_answers(mode, attrs):
    """chip_smoke.widen pads each cluster with slots of zero planes, tri id
    -1 and zero attributes: the plain version's answers at the wider C equal
    those at the narrow C in every column, so the kernels at C=512 (4 CTAs)
    can be held bit for bit to the same clusters at C=8 (one CTA)."""
    mesh, (o, d, tmax) = chip_smoke.soup_arrays()
    narrow = tf2.build_fused2(*mesh[:2], 8, *mesh[2:], mxu=False, device="cpu")
    wide = chip_smoke.widen(narrow, 64)
    assert wide.cluster_size == 64 and wide.num_clusters == narrow.num_clusters and not wide.mxu
    assert (wide.planes[:, 9, 8:] == -1).all() and (wide.planes[:, :9, 8:] == 0).all()
    shadow, t = None, torch.as_tensor(tmax)
    if mode == "mixed":
        sh = np.arange(len(o)) % 2 == 1
        shadow = torch.as_tensor(sh)
        t = torch.as_tensor(np.where(sh, np.random.default_rng(3).uniform(2, 20, len(o)), 1e10).astype(np.float32))
    rays = tf2.pack_rays(torch.as_tensor(o), torch.as_tensor(d), t, shadow)
    a = tf2.fused2_traverse_packed_plain(rays, narrow, mode, attrs)
    b = tf2.fused2_traverse_packed_plain(rays, wide, mode, attrs)
    assert int(a[:, 4].sum()) > 0
    assert chip_smoke.differing_columns(a, b) == {}


def test_limit_bundles_by_seed():
    """Phase 4e's seeds draw other ray bundles over one and the same soup;
    the widened clusters' C puts 4 CTAs on a block of rays and their K
    (about 81,000) lies above those CTAs' old limit."""
    (v5, i5, *_), (o5, d5, s5, t5) = chip_smoke.limit_soup_arrays(32, 5)
    (v6, i6, *_), (o6, d6, s6, t6) = chip_smoke.limit_soup_arrays(32, 6)
    assert np.array_equal(v5, v6) and np.array_equal(i5, i6) and np.array_equal(s5, s6)
    assert o5.shape == o6.shape == (chip_smoke.LIMIT_BUNDLES * 32, 3) and not np.array_equal(o5, o6)
    assert len(chip_smoke.LIMIT_SEEDS) >= 3 and slot_ctas(chip_smoke.LIMIT_WIDE_C, "closest") == 4
    assert old_limit("component", "closest", chip_smoke.LIMIT_WIDE_C) < chip_smoke.LIMIT_MIN_K
