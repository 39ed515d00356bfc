"""Communication model of the sharded renderers (counterpart of
``tools/comm_model.py``): the collectives ``parallel/shard.py`` issues per
frame or per step, an all-reduce time model for them, and the implied
scaling efficiency at N = 2..64 cards from a single-card frame time.

    python -m owl_path_tracer_tpu_torch.tools.comm_model                      # the defaults below
    python -m owl_path_tracer_tpu_torch.tools.comm_model --t1 23.1 --write    # -> out/SCALING_h100.json

Inventory (``comm_inventory``; each collective with its count and the bytes
one rank hands it), as ``parallel/shard.py`` issues them:
  * wavefront frame (``render_image_wavefront_sharded``): the film
    ``st.acc`` [W*H, 3] f32 all-reduced once, and each rank's live-ray count
    (int64) all-gathered once;
  * scan frame (``render_image_sharded``): each pixel chunk's ray count
    (int64) all-reduced, then each rank's shard of the image [W*H/N, 3] f32
    all-gathered;
  * gradient step (``sharded_loss_and_grad``): the loss (f32) and each of
    the 15 ``Materials`` fields ([M, 3] or [M] f32, 17 columns in all) in
    an all-reduce of its own, 16 collectives per step where the JAX package
    issues one psum of [M, 17];
  * nothing else crosses ranks: scene, accelerator and materials are
    replicated, each rank's pool is its own, and its status reads are local.

Time model (ring collectives over N ranks, bandwidth only, as the JAX tool):
    all-reduce  t = 2 * S * (N-1) / N / BW     (S: the buffer)
    all-gather  t = S * (N-1) / BW             (S: one rank's shard)
    T_N = T_1 / (N * load_balance) + t_comm    (t_comm: the frame's collectives)
    eff(N) = (T_1 / N) / T_N
within one HGX H100 node over NVLink, and across ``N // 8 + 1`` hosts (an
HGX node holds 8 cards) over the network, each host counted at one port's
rate.  The bandwidths are published specs, assumed and not measured (a
one-card machine cannot measure them): NVLink 4 on the H100 SXM5, 900 GB/s per card in
both directions, 450 GB/s each way (NVIDIA H100 Tensor Core GPU datasheet);
one ConnectX-7 NDR 400 Gb/s port per card, 50 GB/s each way (NVIDIA DGX
H100 user guide).  The model has no per-collective latency, so it cannot
tell the gradient step's 16 all-reduces from one fused all-reduce.

The JAX tool's ``--launches`` is parsed there and read nowhere; it is left
out here.  ``--write`` writes ``out/SCALING_h100.json`` at the repository
root (gitignored).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..models import material
from . import probe_common as pc

DEVICES = (2, 4, 8, 16, 32, 64)
CARDS_PER_HOST = 8
OUT_DIR = pc.REPO_ROOT / "out"

# the headline frame's seconds (dragon7 1024x1024 spp 64 depth 4,
# fused2-bf16, wavefront; python -m owl_path_tracer_tpu_torch.tools.bench),
# the median of three runs (16.460, 17.393, 17.668 s) on one NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit (PERF.md §2)
T1_S = 17.393
# live rays, mean over max of 8 ranks: python -m
# owl_path_tracer_tpu_torch.tools.measure_balance --device cpu --ranks 8
# (dragon7 256x256 spp 16, the "sample" split; a count, the same on any device)
LOAD_BALANCE = 0.9998
BW_NVLINK = 450e9  # assumed (spec): NVLink 4, H100 SXM5, one direction (NVIDIA H100 datasheet)
BW_NET = 50e9  # assumed (spec): one NDR 400 Gb/s port per card (NVIDIA DGX H100 user guide)
SPEC_SOURCE = ("assumed (spec), not measured: NVLink 4 on the H100 SXM5, 450 GB/s each way (NVIDIA H100 Tensor Core "
               "GPU datasheet); one ConnectX-7 NDR 400 Gb/s port per card, 50 GB/s each way (NVIDIA DGX H100 user "
               "guide)")
F32, I64 = 4, 8


def allreduce_s(bytes_, n, bw):
    """Seconds of a ring all-reduce of a ``bytes_`` buffer over ``n`` ranks."""
    if n <= 1:
        return 0.0
    return 2.0 * bytes_ * (n - 1) / n / bw


def allgather_s(bytes_, n, bw):
    """Seconds of a ring all-gather of ``bytes_`` from each of ``n`` ranks."""
    if n <= 1:
        return 0.0
    return bytes_ * (n - 1) / bw


def collective_s(entry: dict, n: int, bw: float) -> float:
    """Seconds of one inventory entry (all its calls) over ``n`` ranks."""
    one = allreduce_s if entry["op"] == "all_reduce" else allgather_s
    return entry["count"] * one(entry["bytes"], n, bw)


def material_field_bytes() -> dict:
    """Bytes per material of each ``Materials`` field, in field order."""
    one = material.single(device="cpu")
    return {f.name: getattr(one, f.name).numel() * getattr(one, f.name).element_size()
            for f in dataclasses.fields(one)}


def comm_inventory(width: int, height: int, materials: int, world_size: int, pixel_chunk: int = 65536) -> dict:
    """The collectives one rank issues, in order, for a ``width`` x
    ``height`` frame over ``world_size`` ranks and a table of ``materials``
    materials -> {path: [{"op", "what", "count", "bytes"}, ...]}; ``bytes``
    is what the rank hands one call (an all-gather's shard, an
    all-reduce's buffer)."""
    pixels = width * height
    per = -(-pixels // world_size)  # render_image_sharded pads to a multiple of the world size
    chunks = -(-per // pixel_chunk)
    grads = [{"op": "all_reduce", "what": f"gradient {name}", "count": 1, "bytes": materials * b}
             for name, b in material_field_bytes().items()]
    return {
        "wavefront_frame": [
            {"op": "all_reduce", "what": "film st.acc", "count": 1, "bytes": pixels * 3 * F32},
            {"op": "all_gather", "what": "live-ray count", "count": 1, "bytes": I64},
        ],
        "scan_frame": [
            {"op": "all_reduce", "what": "ray count per pixel chunk", "count": chunks, "bytes": I64},
            {"op": "all_gather", "what": "image shard", "count": 1, "bytes": per * 3 * F32},
        ],
        "gradient_step": [{"op": "all_reduce", "what": "loss", "count": 1, "bytes": F32}, *grads],
    }


def implied_efficiency(t1: float, n: int, load_balance: float, t_comm: float) -> float:
    """(T_1 / N) / (T_1 / (N * load_balance) + t_comm)."""
    return (t1 / n) / (t1 / (n * load_balance) + t_comm)


def model_rows(t1: float, size: int, mats: int, load_balance: float, bw_nvlink: float, bw_net: float) -> list:
    """One row per card count of the wavefront frame's model (the JAX tool's
    rows, with its link names given the card's)."""
    rows = []
    for n in DEVICES:
        inventory = comm_inventory(size, size, mats, n)
        film, count = inventory["wavefront_frame"]
        step = inventory["gradient_step"]
        links = {"nvlink": (n, bw_nvlink), "net": (min(n // CARDS_PER_HOST + 1, n), bw_net)}
        t_film = {link: collective_s(film, *k_bw) for link, k_bw in links.items()}
        t_count = {link: collective_s(count, *k_bw) for link, k_bw in links.items()}
        rows.append({
            "devices": n,
            "film_allreduce_bytes": film["bytes"],
            "rays_allgather_bytes": count["bytes"],
            "grad_allreduce_bytes_per_step": sum(e["bytes"] * e["count"] for e in step),
            "grad_allreduces_per_step": sum(e["count"] for e in step),
            "t_allreduce_nvlink_ms": round(t_film["nvlink"] * 1e3, 3),
            "t_allreduce_net_ms": round(t_film["net"] * 1e3, 3),
            "t_allgather_nvlink_ms": round(t_count["nvlink"] * 1e3, 6),
            "t_allgather_net_ms": round(t_count["net"] * 1e3, 6),
            "t_compute_s": round(t1 / (n * load_balance), 4),
            "implied_efficiency_nvlink": round(
                implied_efficiency(t1, n, load_balance, t_film["nvlink"] + t_count["nvlink"]), 4),
            "implied_efficiency_net_hosts": round(
                implied_efficiency(t1, n, load_balance, t_film["net"] + t_count["net"]), 4),
        })
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t1", type=float, default=T1_S,
                    help="single-card frame seconds (default: the H100 headline frame of tools/bench.py)")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--mats", type=int, default=12)
    ap.add_argument("--load-balance", type=float, default=LOAD_BALANCE,
                    help="mean over max of the ranks' live rays (default: tools/measure_balance.py --device cpu "
                         "--ranks 8, sample split; a ray count is the same whether the CPU or the card made it)")
    ap.add_argument("--bw-nvlink", type=float, default=BW_NVLINK,
                    help="bytes/s each way per card within a node (default: NVLink 4 spec, assumed)")
    ap.add_argument("--bw-net", type=float, default=BW_NET,
                    help="bytes/s each way per host across nodes (default: one NDR 400 Gb/s port, assumed)")
    ap.add_argument("--write", action="store_true", help="write out/SCALING_h100.json at the repository root")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print the rows (one JSON line each), then the summary -> the summary."""
    args = parse_args(argv)
    rows = model_rows(args.t1, args.size, args.mats, args.load_balance, args.bw_nvlink, args.bw_net)
    for row in rows:
        print(json.dumps(row))
    spec = (args.bw_nvlink, args.bw_net) == (BW_NVLINK, BW_NET)
    out = {
        "note": ("comm model of the port's sharded wavefront renderer: one film all-reduce and one ray-count "
                 "all-gather per frame; ring collectives, bandwidth only (no per-collective latency)"),
        "inputs": {
            "t1_frame_s": args.t1,
            "t1_source": ("tools/bench.py's headline frame (dragon7 1024^2 spp=64 depth=4, fused2-bf16, "
                          "wavefront), NVIDIA H100 80GB HBM3, 700.00 W (PERF.md §2)" if args.t1 == T1_S else "given"),
            "load_balance": args.load_balance,
            "load_balance_source": ("tools/measure_balance.py --device cpu --ranks 8, sample split"
                                    if args.load_balance == LOAD_BALANCE else "given"),
            "bw_nvlink": args.bw_nvlink,
            "bw_net": args.bw_net,
            "bandwidths": SPEC_SOURCE if spec else "given, not measured",
            "config": f"{args.size}^2 film, {args.mats} materials",
        },
        "inventory_8_cards": comm_inventory(args.size, args.size, args.mats, 8),
        "model": rows,
    }
    print(json.dumps({k: out[k] for k in ("note", "inputs")}))
    if args.write:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / "SCALING_h100.json"
        path.write_text(json.dumps(out, indent=1))
        print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
