"""Retirement-loop latency decomposition (counterpart of ``tools/tpu_probe6.py``).

Times the latency-probe kernel (``ops/latency_probe.py``, kernel
``csrc/latency_probe.cu``) in its tensor form -- the copy and product
stages that the fused2 traversal's tensor-core form (K1b) runs -- at
several loop trip counts for each variant and prints one JSON line per
variant: the time at each ``--iters`` value and the slope per block and loop
iteration, which splits one iteration of the traversal loop into pick, copy,
product and loop control (see the variants in ``ops/latency_probe.py``).

    python -m owl_path_tracer_tpu_torch.tools.latency_probe [--sub 7] [--c 512] [--n 131072] [--b 256]
        [--kind bounce] [--variants nop_loop,...] [--iters 0,8,16] [--device cuda]

Times are CUDA events around each launch on the card (min and median of
REPEATS after a warm-up); ``--device cpu`` runs the plain version and
times it on the host clock, for checks at small sizes only.  Each line adds
to the reference's keys the tile width of the copies (``tile``, slots per
copy; null on the CPU), the medians and the device (``nvidia-smi`` name and
power limit).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from ..ops import fused2
from ..ops import latency_probe as lp
from ..utils.cli import resolve_device
from . import probe_common as pc

REPEATS = 3  # timed launches per point, after one warm-up (the reference's timeit)


@dataclasses.dataclass
class Probe:
    """The probe's inputs on one device."""

    rays: torch.Tensor  # [N,8] packed rays, t_max 1e10
    boxes: torch.Tensor  # [8,K]
    planes: torch.Tensor  # [K,16,4C] float32 (MXU layout)
    planes_bf16: torch.Tensor  # the same rounded to bf16

    def planes_for(self, name: str) -> torch.Tensor:
        return self.planes_bf16 if lp.variant(name).bf16 else self.planes


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sub", type=int, default=7)
    ap.add_argument("--c", type=int, default=512)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--b", type=int, default=256)
    ap.add_argument("--kind", default="bounce")
    ap.add_argument("--variants", default=",".join(lp.DEFAULT_VARIANTS))
    ap.add_argument("--iters", default="0,8,16")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain version)")
    return ap.parse_args(argv)


def setup(sub: int, c: int, n: int, kind: str, device) -> Probe:
    """The dragon at subdivision ``sub``, its fused2 clusters of C=``c``
    (MXU layout) and ``n`` rays of ``kind``, on ``device``."""
    scene, _ = pc.load(sub, device=device)
    fb = fused2.build_fused2_scene(scene, cluster_size=c)
    o, d = pc.make_rays(scene, n, kind)
    return Probe(rays=fused2.pack_rays(o, d, 1e10), boxes=fb.boxes, planes=fb.planes,
                 planes_bf16=fb.planes.to(torch.bfloat16))


def measure(probe: Probe, name: str, iters: list, block: int, kind: str, device_line: str) -> dict:
    """Time one variant at each trip count -> its JSON record."""
    planes = probe.planes_for(name)
    k = probe.boxes.shape[1]
    dev = probe.rays.device
    tile = lp.kernel_tile(probe.rays, probe.boxes, planes, name, block) if dev.type == "cuda" else None
    mins, medians = [], []
    for it in iters:
        t_min, t_med = pc.time_ms(lambda: lp.latency_probe(probe.rays, probe.boxes, planes, name, it, block), dev,
                                  REPEATS)
        mins.append(t_min)
        medians.append(t_med)
    blocks = probe.rays.shape[0] // block
    span = iters[-1] - iters[0]
    return {
        "probe": "latency", "variant": name, "b": block, "k": k, "kind": kind,
        "ms_at": {str(i): t for i, t in zip(iters, mins)},
        "us_per_block_iter": (mins[-1] - mins[0]) / max(span, 1) / blocks * 1e3,
        "ms_median_at": {str(i): t for i, t in zip(iters, medians)},
        "tile": tile, "device": device_line,
    }


def run(args) -> tuple:
    """The probe of ``args`` (from :func:`parse_args`) -> (probe inputs,
    records); prints each record as one JSON line."""
    device = resolve_device(args.device)
    probe = setup(args.sub, args.c, args.n, args.kind, device)
    device_line = pc.device_name(device)
    iters = [int(x) for x in args.iters.split(",")]
    records = []
    for name in args.variants.split(","):
        rec = measure(probe, name, iters, args.b, args.kind, device_line)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return probe, records


def main(argv=None) -> list:
    return run(parse_args(argv))[1]


if __name__ == "__main__":
    main()
