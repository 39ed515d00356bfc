"""Scene files of the benchmark's configurations, made from numpy alone.

A configuration's ``scene`` block names where its mesh comes from
(``generator``): ``"file"``, an OBJ file of the repository (``obj``, a path
from the repository's root) pinned by its ``sha256`` (``obj_sha256``), or a
frozen copy of a stand-in mesh generator (``"dragon"``: the displaced
icosphere that stands in for the Stanford dragon), so that no run executes
``assets/generate.py`` or imports the JAX package it uses.  The camera and
the materials are in the block itself.  ``materialize`` writes the scene as
the program reads it (``<scene>.json`` and ``<scene>.obj.scene``) into a
cache directory inside the checkout, once, and beside it ``reference.npz``:
the flattened triangle soup the plain reference renders, parsed back from
the very bytes the OBJ file holds (``read_obj``), so both sides see the same
float32 values.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache" / "scenes"


# ── meshes (frozen from assets/generate.py) ───────────────────────────────


def quad(p0, p1, p2, p3):
    v = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(v[1] - v[0], v[3] - v[0])
    n = n / np.linalg.norm(n)
    return v, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32), np.tile(n.astype(np.float32), (4, 1))


def bumpy_blob(center, radius, n_sub, seed=0, bump=0.18):
    """The displaced icosphere: 20 * 4**n_sub triangles."""
    t = (1 + 5**0.5) / 2
    verts = np.asarray(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.asarray(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
         [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
         [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(n_sub):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (verts[a] + verts[b]) / 2
                m = m / np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    rng = np.random.default_rng(seed)
    disp = np.zeros(len(verts))
    for _ in range(6):
        k = rng.normal(size=3) * 4.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += np.sin(verts @ k + phase)
    r = 1.0 + bump * disp / 6.0
    v = verts * r[:, None]

    p = v[faces]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    normals = np.zeros_like(v)
    for c in range(3):
        np.add.at(normals, faces[:, c], fn)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)
    v = center + radius * v
    return v.astype(np.float32), faces.astype(np.int32), normals.astype(np.float32)


def dragon_meshes(subdivision: int):
    """The dragon scene's objects, named as ``dragon.json``'s materials."""
    return [
        ("dragon", bumpy_blob(np.array([0, 1.0, 0.0]), 0.9, subdivision)),
        ("ground", quad([-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6])),
        ("areaLight", quad([-1.5, 4, -1.5], [-1.5, 4, 1.5], [1.5, 4, 1.5], [1.5, 4, -1.5])),
    ]


GENERATORS = {
    "dragon": lambda p: dragon_meshes(int(p["subdivision"])),
}


# ── file formats ──────────────────────────────────────────────────────────


def obj_text(meshes) -> str:
    """OBJ text as the repository's generator writes it: one ``o`` per
    mesh, ``v`` with 6 decimals, ``vn`` with 4, faces ``f v//vn``."""
    out = ["# owl_path_tracer_tpu generated\n"]
    base = 1
    for name, (v, idx, n) in meshes:
        out.append(f"o {name}\n")
        out += [f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v.tolist()]
        out += [f"vn {a:.4f} {b:.4f} {c:.4f}\n" for a, b, c in n.tolist()]
        out += [f"f {a}//{a} {b}//{b} {c}//{c}\n" for a, b, c in (idx.astype(np.int64) + base).tolist()]
        base += len(v)
    return "".join(out)


def read_obj(data: bytes, materials) -> tuple:
    """The triangle soup the program's scene compiler makes of an OBJ file's
    bytes and the configuration's materials, per triangle: vertices [T,3,3]
    and shading normals [T,3,3] float32, material id [T] int32.

    Read as the compiler reads it: an ``o`` or ``g`` line starts an object,
    which is kept iff a material has its name (that material's index is its
    id); a polygon is a fan from its first corner; a value is parsed as
    float64 and rounded to float32; and within its object a vertex takes the
    normal of the first face corner that uses it.  Every corner has a vertex
    and a normal index, counted from 1 (``f a//b`` or ``f a/b/c``).
    """
    names = [m["name"] for m in materials]
    verts, norms, corners, objects = [], [], [], []  # objects: (name, first corner, end)
    name, start = "default", 0
    for line in data.decode().splitlines():
        if line.startswith("v "):
            verts.append(line.split()[1:4])
        elif line.startswith("vn "):
            norms.append(line.split()[1:4])
        elif line.startswith(("o ", "g ")):
            objects.append((name, start, len(corners)))
            name, start = line[2:].strip(), len(corners)
        elif line.startswith("f "):
            c = line.split()[1:]
            for k in range(1, len(c) - 1):
                corners += (c[0], c[k], c[k + 1])
    objects.append((name, start, len(corners)))
    fields = " ".join(corners).replace("//", "/0/").replace(" ", "/").split("/")
    if len(fields) != 3 * len(corners):
        raise ValueError("OBJ: every face corner needs a vertex and a normal index (f a//b or f a/b/c)")
    idx = np.asarray(fields, np.int64).reshape(-1, 3)[:, [0, 2]] - 1
    if len(idx) and idx.min() < 0:
        raise ValueError("OBJ: face indices are counted from 1")
    verts = np.asarray(verts, np.float64).astype(np.float32).reshape(-1, 3)
    norms = np.asarray(norms, np.float64).astype(np.float32).reshape(-1, 3)
    p, n, mat = [], [], []
    for name, lo, hi in objects:
        if lo == hi or name not in names:
            continue
        v, vn = idx[lo:hi, 0], idx[lo:hi, 1]
        _, first, inverse = np.unique(v, return_index=True, return_inverse=True)
        p.append(verts[v])
        n.append(norms[vn[first][inverse]])
        mat.append(np.full((hi - lo) // 3, names.index(name), np.int32))
    if not mat:
        raise ValueError(f"OBJ: no object is named as a material ({names})")
    return np.concatenate(p).reshape(-1, 3, 3), np.concatenate(n).reshape(-1, 3, 3), np.concatenate(mat)


# ── a configuration's scene on disk ───────────────────────────────────────


def scene_key(config: dict) -> str:
    blob = json.dumps(config["scene"], sort_keys=True).encode()
    return f"{config['name']}-{hashlib.sha256(blob).hexdigest()[:12]}"


def pinned_obj(scene: dict) -> bytes:
    """A ``"file"`` scene's OBJ bytes, checked against the hash the
    configuration pins."""
    path = (ROOT / scene["obj"]).resolve()
    if ROOT not in path.parents:
        raise ValueError(f"scene file {scene['obj']!r} lies outside the repository")
    data = path.read_bytes()
    got = hashlib.sha256(data).hexdigest()
    if got != scene["obj_sha256"]:
        raise ValueError(f"scene file {scene['obj']}: sha256 {got}, the configuration pins {scene['obj_sha256']}")
    return data


def materialize(config: dict, cache: pathlib.Path = CACHE) -> pathlib.Path:
    """Write the configuration's scene files once -> their directory (a
    ``"file"`` scene's hash is checked in every call)."""
    sc = config["scene"]
    data = pinned_obj(sc) if sc["generator"] == "file" else None
    out = cache / scene_key(config)
    done = out / "done"
    if done.exists():
        return out
    out.mkdir(parents=True, exist_ok=True)
    if data is None:
        data = obj_text(GENERATORS[sc["generator"]](sc)).encode()
    name = sc["name"]
    (out / f"{name}.json").write_text(json.dumps({"camera": sc["camera"], "materials": sc["materials"]}, indent=1))
    _replace_write(out / f"{name}.obj.scene", data)
    tri_p, tri_n, tri_mat = read_obj(data, sc["materials"])
    with open(out / "reference.npz.tmp", "wb") as f:
        np.savez(f, tri_p=tri_p, tri_n=tri_n, tri_mat=tri_mat)
    os.replace(out / "reference.npz.tmp", out / "reference.npz")
    done.write_text("ok\n")
    return out


def _replace_write(path: pathlib.Path, data: bytes):
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)
