"""The shading routers of ``render/integrator.py`` on the CPU: ``trace_bounce``
takes the plain ``_shade_bounce`` for CPU tensors and while autograd
records, and ``trace_bounce_nee`` the plain ``_shade_bounce_nee`` for CPU
tensors, while autograd records, in the immediate form and with an
environment light; ``ops/shade.py`` (the kernels' wrapper) imports and
refuses CPU tensors without a card.  The kernels themselves are held to the
plain versions on the card (``tests/test_torch_cuda.py``), on the random
bounces :func:`random_bounce` and :func:`random_nee_bounce` make here.

Imports nothing of JAX.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from owl_path_tracer_tpu_torch.models import lights as lights_mod
from owl_path_tracer_tpu_torch.models import material as material_mod
from owl_path_tracer_tpu_torch.models.scene import RenderSettings, compile_scene
from owl_path_tracer_tpu_torch.ops import disney, shade
from owl_path_tracer_tpu_torch.ops.intersect import HitRecord
from owl_path_tracer_tpu_torch.render import integrator

ASSETS = pathlib.Path(__file__).resolve().parents[1] / "assets"

# one material per lobe and case the kernel branches on: the lobe picked by
# the weights, glass's transmit / TIR / Fresnel reflect (by direction and
# ior), sheen, emission, a black base (luminance 0), a mirror metal (alpha
# at its floor), an infinite base colour (a non-finite f: the retry) and a
# mixture of every lobe
MATERIALS = [
    dict(base_color=(0.8, 0.6, 0.4), roughness=0.5),  # diffuse
    dict(base_color=(0.9, 0.7, 0.3), metallic=1.0, roughness=0.3, anisotropic=0.5, specular=0.5,
         specular_tint=0.3),  # metal
    dict(base_color=(0.2, 0.4, 0.8), clearcoat=1.0, clearcoat_gloss=0.7),  # clearcoat 20%
    dict(base_color=(1.0, 1.0, 1.0), specular_transmission=1.0, specular_transmission_roughness=0.2,
         roughness=0.1, ior=1.5),  # glass
    dict(base_color=(0.9, 1.0, 0.8), specular_transmission=1.0, specular_transmission_roughness=0.6,
         roughness=0.4, anisotropic=0.3, ior=1.33),  # rough glass
    dict(base_color=(0.6, 0.3, 0.3), roughness=0.8, sheen=1.0, sheen_tint=0.5),  # sheen
    dict(base_color=(1.0, 1.0, 1.0), emission=5.0),  # emissive
    dict(base_color=(0.5, 0.5, 0.5), metallic=0.4, clearcoat=0.5, clearcoat_gloss=0.2, specular_transmission=0.3,
         specular=0.5, specular_tint=0.5, sheen=0.3, sheen_tint=0.2, roughness=0.6),  # every lobe
    dict(base_color=(0.0, 0.0, 0.0), roughness=0.2, metallic=0.5, sheen=0.5),  # black base
    dict(base_color=(0.7, 0.7, 0.7), metallic=1.0, roughness=0.0),  # mirror metal
    dict(base_color=(float("inf"), 0.5, 0.5), roughness=0.5),  # non-finite f
]
# the materials that read a texture (mat_tex) when textures are on
TEXTURED = {0: 0, 5: 1, 7: 1}


def _materials(device):
    fields = [f.name for f in dataclasses.fields(material_mod.Materials) if f.name != "base_color"]
    rows = [{**{k: 0.0 for k in fields}, "ior": 1.5, **m} for m in MATERIALS]
    return material_mod.Materials(
        base_color=torch.tensor([r["base_color"] for r in rows], dtype=torch.float32, device=device),
        **{k: torch.tensor([float(r[k]) for r in rows], dtype=torch.float32, device=device) for k in fields})


def _unit(r, n):
    d = r.normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def random_bounce(device, n: int = 4096, seed: int = 0, env: str = "auto", parity: bool = True):
    """A bounce to shade, made from ``seed`` with numpy -> (scene, settings,
    PathState, HitRecord, attribute blob [N,16]).

    The cornell box's geometry with MATERIALS on random triangles, two random
    textures (TEXTURED), a random environment map; lanes dead (10%), missing
    (15%, tri -1), on random triangles with random barycentrics, directions
    from both sides of the random blob normals (a few degenerate), random
    throughput, result, LCG state, previous lobe (glass with wo below the
    surface forces the BTDF) and depth (0-6, Russian roulette above 3).
    ``env``: "auto" (the sky), "map" or "color"."""
    r = np.random.default_rng(seed)
    scene = compile_scene(ASSETS, "cornell-box", (32, 32), env_map_path=None, device="cpu")
    t_count, m = scene.num_tris, len(MATERIALS)
    mat_tex = np.full(m, -1, np.int32)
    for k, v in TEXTURED.items():
        mat_tex[k] = v
    textures = np.zeros((2, 16, 24, 3), np.float32)
    textures[0, :16, :24] = r.uniform(0, 1, (16, 24, 3))
    textures[1, :8, :12] = r.uniform(0, 1, (8, 12, 3))
    scene = dataclasses.replace(
        scene, materials=_materials("cpu"), tri_mat=torch.as_tensor(r.integers(0, m, t_count).astype(np.int32)),
        mat_tex=torch.as_tensor(mat_tex), textures=torch.as_tensor(textures),
        tex_hw=torch.tensor([[16.0, 24.0], [8.0, 12.0]]),
        env_map=torch.as_tensor(r.uniform(0, 2, (12, 20, 3)).astype(np.float32)))
    settings = RenderSettings(width=32, height=32, max_samples=1, max_path_depth=8, environment_use=env == "map",
                              environment_auto=env == "auto", environment_color=(0.3, 0.6, 0.9),
                              environment_intensity=1.7, parity=parity)

    tri = r.integers(0, t_count, n)
    tri[r.random(n) < 0.15] = -1
    uv = r.uniform(0, 1, (n, 2)).astype(np.float32)
    flip = uv.sum(-1) > 1
    uv[flip] = 1 - uv[flip]
    normals = [_unit(r, n) for _ in range(3)]
    normals[0][r.random(n) < 0.02] = 0.0  # a degenerate blob normal: the +z fallback
    tc = r.uniform(-0.2, 1.2, (n, 6)).astype(np.float32)
    mat_id = r.integers(0, m, n).astype(np.float32)
    blob = np.concatenate([*normals, tc, mat_id[:, None]], 1)
    blob[tri < 0] = 0.0
    hit = HitRecord(t=torch.as_tensor(np.where(tri >= 0, r.uniform(0.1, 5.0, n), 1e10).astype(np.float32)),
                    tri=torch.as_tensor(tri), uv=torch.as_tensor(np.where(tri[:, None] >= 0, uv, 0.0)))
    ray_d = _unit(r, n)
    ray_d[r.random(n) < 0.01] = (0.0, -1.0, 0.0)  # straight down: the onb's second branch on some normals
    state = integrator.PathState(
        ray_o=torch.as_tensor(r.uniform(-2, 2, (n, 3)).astype(np.float32)), ray_d=torch.as_tensor(ray_d),
        result=torch.as_tensor(r.uniform(0, 1, (n, 3)).astype(np.float32)),
        throughput=torch.as_tensor(r.uniform(0.01, 1, (n, 3)).astype(np.float32)),
        rng=torch.as_tensor(r.integers(0, 2**32, n, dtype=np.int64)), alive=torch.as_tensor(r.random(n) > 0.1),
        prev_lobe=torch.as_tensor(r.integers(disney.LOBE_NONE, disney.LOBE_GLASS + 1, n)),
        depth=torch.as_tensor(r.integers(0, 7, n)), prev_pdf=torch.as_tensor(r.uniform(0, 1, n).astype(np.float32)))
    return (scene.to(device), settings, state.to(device), hit.to(device), torch.as_tensor(blob).to(device))


def test_shade_module_imports_and_refuses_cpu_tensors():
    """ops/shade.py imports without a card; its wrapper launches the kernel
    or raises, and counts nothing when it raises."""
    scene, settings, state, hit, blob = random_bounce("cpu", n=64)
    launches = dict(shade.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        shade.shade_bounce(scene, settings, state, hit, blob, False)
    assert shade.LAUNCHES == launches and set(launches) == {shade.ENTRY, shade.PLAIN_CUDA, shade.ENTRY_NEE,
                                                            shade.PLAIN_CUDA_NEE}


@pytest.mark.parametrize("surface", ["blob", "gather"])
def test_cpu_tensors_take_the_plain_version(monkeypatch, surface):
    """trace_bounce on CPU tensors shades through _shade_bounce and never the
    kernel's wrapper; the result is _shade_bounce's own."""
    scene, settings, state, hit, blob = random_bounce("cpu", n=256, seed=1)
    blob = blob if surface == "blob" else None

    def no_kernel(*a, **k):
        raise AssertionError("the shading kernel's wrapper was called for CPU tensors")

    monkeypatch.setattr(shade, "shade_bounce", no_kernel)
    launches = dict(shade.LAUNCHES)
    got = integrator.trace_bounce(scene, settings, state, lambda o, d: (hit, blob) if blob is not None else hit, True)
    want = integrator._shade_bounce(scene, settings, state, hit, blob, True)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    assert shade.LAUNCHES == launches


def _meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else t


@pytest.mark.parametrize("recording", [False, True])
def test_recording_takes_the_plain_version(monkeypatch, recording):
    """On a non-CPU device, trace_bounce shades through the kernel's wrapper,
    and through the plain version, counted as PLAIN_CUDA, while autograd
    records a gradient of the materials (render/diff.py's route: the kernel
    has no backward).  Runs on the meta device, with both routes stubbed."""
    scene, settings, state, hit, blob = random_bounce("cpu", n=64, seed=2)
    mats = scene.materials
    if recording:
        mats = dataclasses.replace(mats, roughness=mats.roughness.clone().requires_grad_(True))
    scene = dataclasses.replace(scene, materials=mats)
    state, hit, blob = state.to("meta"), hit.to("meta"), blob.to("meta")
    calls = []
    monkeypatch.setattr(shade, "shade_bounce", lambda *a: calls.append("kernel") or {
        k: getattr(state, k) for k in ("ray_o", "ray_d", "result", "throughput", "rng", "alive", "prev_lobe", "depth")})
    monkeypatch.setattr(integrator, "_shade_bounce", lambda *a: calls.append("plain") or state)
    shade.reset_counts()
    out = integrator.trace_bounce(scene, settings, state, lambda o, d: (hit, blob), False)
    assert calls == ["plain" if recording else "kernel"] and out.prev_pdf is state.prev_pdf
    assert shade.LAUNCHES[shade.PLAIN_CUDA] == int(recording)
    with torch.no_grad():
        integrator.trace_bounce(scene, settings, state, lambda o, d: (hit, blob), False)
    assert calls[-1] == "kernel"


def test_material_table_is_cached_until_a_field_changes():
    """The kernel's [M,17] table is built once per Materials, equals the
    plain path's table, and is rebuilt after an in-place write."""
    mats = _materials("cpu")
    scene = dataclasses.replace(random_bounce("cpu", n=8)[0], materials=mats)
    table = shade.material_table(mats)
    assert torch.equal(table, integrator._material_blob(scene)) and table.shape == (len(MATERIALS), 17)
    assert shade.material_table(mats) is table
    mats.roughness[0] = 0.25
    again = shade.material_table(mats)
    assert again is not table and again[0, 7] == 0.25


@pytest.mark.parametrize(("settings", "env_map", "kind"), [
    (dict(environment_use=True), (4, 8, 3), shade.ENV_MAP),
    (dict(environment_use=True, environment_auto=True), (1, 1, 3), shade.ENV_AUTO),
    (dict(environment_auto=True), (4, 8, 3), shade.ENV_AUTO),
    (dict(), (4, 8, 3), shade.ENV_COLOR),
])
def test_environment_kind(settings, env_map, kind):
    scene = dataclasses.replace(random_bounce("cpu", n=8)[0], env_map=torch.zeros(env_map))
    assert shade.environment_kind(scene, RenderSettings(width=1, height=1, max_samples=1, max_path_depth=1,
                                                        **settings)) == kind


def _draws(before, after, most: int = 8):
    """LCG steps from ``before`` to ``after`` per lane (-1 beyond ``most``)."""
    out = torch.full_like(before, -1)
    s = before.clone()
    for k in range(most + 1):
        out = torch.where((out < 0) & (s == after), k, out)
        s = (16807 * s + 1013904223) & 0xFFFFFFFF
    return out


@pytest.mark.parametrize("parity", [True, False], ids=["parity", "corrected"])
def test_random_bounce_reaches_every_case(parity):
    """The card test's bounces (seed 11, 16,384 lanes) reach every case the
    kernel branches on, as the plain version shades them: each lobe, glass's
    4 / 5 / 6 draws (transmit, TIR, Fresnel reflect), the forced BTDF (5 or
    6 draws on a material without transmission), Russian roulette's kill,
    the pdf kill, the retry of a non-finite f, emission, misses and dead
    lanes."""
    scene, settings, state, hit, blob = random_bounce("cpu", n=16384, seed=11, parity=parity)
    out = integrator._shade_bounce(scene, settings, state, hit, blob, False)
    draws = _draws(state.rng, out.rng)
    advanced = out.depth > state.depth
    mat = blob[:, 15].long()
    transmits = scene.materials.specular_transmission[mat] > 0
    lobes = out.prev_lobe[advanced]
    cases = {
        **{f"lobe {v}": int((lobes == v).sum()) for v in (disney.LOBE_DIFFUSE, disney.LOBE_CLEARCOAT,
                                                         disney.LOBE_METALLIC, disney.LOBE_GLASS)},
        **{f"{k} draws": int((draws == k).sum()) for k in (3, 4, 5, 6)},
        "forced btdf": int((~transmits & (draws >= 5)).sum()),
        "roulette kill": int((advanced & ~out.alive).sum()),
        "pdf kill": int((~out.alive & ~advanced & (draws > 0)).sum()),
        "retry": int((out.alive & ~advanced & (draws > 0)).sum()),
        "emission": int((state.alive & hit.hit & (scene.materials.emission[mat] > 0)).sum()),
        "miss": int((state.alive & ~hit.hit).sum()),
        "dead": int((~state.alive).sum()),
    }
    assert (draws >= 0).all() and min(cases.values()) > 0, str(cases)


# the light table of random_nee_bounce: the box's two light triangles and
# three random ones (emissive material 6), one of emission 0, and one floor
# triangle (y = 0, normal +y) whose samples graze the other floor triangles
N_EMISSIVE_LIGHTS = 6
FLOOR_EMISSION = 2.0


def random_nee_bounce(device, n: int = 4096, seed: int = 0, env: str = "auto", parity: bool = True):
    """A deferred NEE bounce to shade, made from ``seed`` -> (scene,
    settings, LightTable, PathState, HitRecord, attribute blob [N,16],
    allow_nee [N] bool).

    :func:`random_bounce`'s bounce with a light table over some triangles
    (N_EMISSIVE_LIGHTS of material 6, one of them of emission 0 in the
    table, and a floor triangle of emission FLOOR_EMISSION that keeps its
    diffuse material): lanes that hit a light with its emissive material
    (10%), lanes that hit an emissive triangle that is no light (material 6
    elsewhere), lanes on the other floor triangles, whose light samples on
    the floor light graze it (pdf 0; 5%, on the floor plane in the blob's
    positions too), depth 0 and prev_pdf 0 lanes (10%), allow_nee false on
    20% of the lanes, and the non-finite base colour's non-finite light
    contributions."""
    scene, settings, state, hit, blob = random_bounce("cpu", n=n, seed=seed, env=env, parity=parity)
    r = np.random.default_rng(seed + 7919)
    verts, tris = scene.vertices.numpy(), scene.tri_idx.numpy()
    on_floor = (verts[tris][:, :, 1] == 0.0).all(1)
    floor = np.flatnonzero(on_floor)
    box_lights = scene.emissive_tris.numpy()
    others = np.setdiff1d(np.arange(scene.num_tris), np.concatenate([floor, box_lights]))
    emissive = np.concatenate([box_lights, r.choice(others, N_EMISSIVE_LIGHTS - len(box_lights), replace=False)])
    light_ids = np.concatenate([emissive, floor[:1]])
    tri_mat = scene.tri_mat.numpy().copy()  # random: emissive non-lights among them
    tri_mat[emissive] = 6
    tri_mat[floor] = 0

    p = verts[tris[light_ids]]  # [L,3,3]
    nrm = scene.normals.numpy()[tris[light_ids]]
    nrm[-1] = (0.0, 1.0, 0.0)
    emission = np.full(len(light_ids), 5.0, np.float32)
    emission[N_EMISSIVE_LIGHTS - 1] = 0.0
    emission[-1] = FLOOR_EMISSION
    area = 0.5 * np.linalg.norm(np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    lights = lights_mod.LightTable(p0=t(p[:, 0]), p1=t(p[:, 1]), p2=t(p[:, 2]), n0=t(nrm[:, 0]), n1=t(nrm[:, 1]),
                                   n2=t(nrm[:, 2]), emission=t(emission), area=t(area),
                                   tri_id=torch.as_tensor(light_ids.astype(np.int32)))

    tri, blob_np = hit.tri.numpy().copy(), blob.numpy().copy()
    ray_o, ray_d = state.ray_o.numpy().copy(), state.ray_d.numpy().copy()
    on_light = r.random(n) < 0.10
    tri[on_light] = r.choice(emissive, on_light.sum())
    blob_np[on_light, 15] = 6.0
    grazing = ~on_light & (r.random(n) < 0.05)
    tri[grazing] = r.choice(floor[1:], grazing.sum())
    blob_np[grazing, 15] = 0.0
    ray_o[grazing, 1] = 0.0
    phi = r.uniform(0, 2 * np.pi, grazing.sum())
    ray_d[grazing] = np.stack([np.cos(phi), np.zeros_like(phi), np.sin(phi)], -1)
    hit_now = tri >= 0
    uv = hit.uv.numpy().copy()
    fresh = (on_light | grazing) & (uv.sum(-1) == 0)
    uv[fresh] = 0.25
    blob_np[hit_now & (blob_np[:, :9] == 0).all(1), 0:9] = np.tile([0.0, 1.0, 0.0], 3)
    t_hit = np.where(hit_now, np.where(hit.t.numpy() < 1e9, hit.t.numpy(), 1.0), 1e10).astype(np.float32)
    prev_pdf = state.prev_pdf.numpy().copy()
    prev_pdf[r.random(n) < 0.10] = 0.0

    scene = dataclasses.replace(scene, tri_mat=torch.as_tensor(tri_mat))
    hit = HitRecord(t=torch.as_tensor(t_hit), tri=torch.as_tensor(tri), uv=torch.as_tensor(uv))
    state = dataclasses.replace(state, ray_o=torch.as_tensor(ray_o), ray_d=torch.as_tensor(ray_d),
                                prev_pdf=torch.as_tensor(prev_pdf))
    allow = torch.as_tensor(r.random(n) > 0.2)
    return (scene.to(device), settings, lights.to(device), state.to(device), hit.to(device),
            torch.as_tensor(blob_np).to(device), allow.to(device))


def test_nee_wrapper_refuses_cpu_tensors():
    """The NEE kernel's wrapper launches the kernel or raises, and counts
    nothing when it raises."""
    scene, settings, lights, state, hit, blob, allow = random_nee_bounce("cpu", n=64)
    launches = dict(shade.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        shade.shade_bounce_nee(scene, settings, lights, state, hit, blob, False, allow)
    assert shade.LAUNCHES == launches


def test_reset_counts_zeroes_every_count():
    for k in shade.LAUNCHES:
        shade.LAUNCHES[k] += 3
    shade.reset_counts()
    assert shade.LAUNCHES == {shade.ENTRY: 0, shade.PLAIN_CUDA: 0, shade.ENTRY_NEE: 0, shade.PLAIN_CUDA_NEE: 0}


_NEE_STATE = ("ray_o", "ray_d", "result", "throughput", "rng", "alive", "prev_lobe", "depth", "prev_pdf")


@pytest.mark.parametrize("case", ["kernel", "cpu", "recording", "immediate", "env_light", "no_lights"])
def test_nee_router(monkeypatch, case):
    """trace_bounce_nee shades a deferred bounce with area lights through the
    NEE kernel's wrapper, inside ``owlpt.nee``, on non-CPU tensors while
    autograd records nothing; every other case takes _shade_bounce_nee, and
    on non-CPU tensors counts PLAIN_CUDA_NEE: CPU tensors (not counted), a
    gradient of the materials being recorded, the immediate form, an
    environment light, no light table.  Runs on the meta device, with both
    routes stubbed."""
    scene, settings, lights, state, hit, blob, allow = random_nee_bounce("cpu", n=64, seed=3)
    if case == "recording":
        mats = scene.materials
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            mats, metallic=mats.metallic.clone().requires_grad_(True)))
    if case != "cpu":
        state, hit, blob, allow, lights = (x.to("meta") for x in (state, hit, blob, allow, lights))
    calls = []
    pending = (state.ray_o, state.ray_d, state.prev_pdf, state.result, state.alive)

    def kernel(*a):
        calls.append("kernel")
        return {k: getattr(state, k) for k in _NEE_STATE}, pending

    def plain(*a):
        calls.append("plain")
        return (state, pending) if a[-1] else state

    monkeypatch.setattr(shade, "shade_bounce_nee", kernel)
    monkeypatch.setattr(integrator, "_shade_bounce_nee", plain)
    shade.reset_counts()
    kw = dict(allow_nee=allow, deferred=case != "immediate", precomputed=(hit, blob))
    if case == "env_light":
        kw.update(env_light=object(), deferred=False)
    out = integrator.trace_bounce_nee(scene, settings, None if case == "no_lights" else lights, state,
                                      None, None, False, **kw)
    kernel_route = case == "kernel"
    assert calls == ["kernel" if kernel_route else "plain"]
    if kw["deferred"]:
        assert out[1] is pending and isinstance(out[0], integrator.PathState)
    assert shade.LAUNCHES[shade.PLAIN_CUDA_NEE] == int(not kernel_route and case != "cpu")


def test_nee_kernel_route_opens_nee_inside_shade(monkeypatch):
    """On the kernel route the launch runs inside ``owlpt.nee``, itself
    inside ``owlpt.shade``, once each."""
    scene, settings, lights, state, hit, blob, allow = random_nee_bounce("cpu", n=32, seed=4)
    state, hit, blob, allow, lights = (x.to("meta") for x in (state, hit, blob, allow, lights))
    opened, seen = [], []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(self.name)

        def __exit__(self, *exc):
            opened.remove(self.name)

    monkeypatch.setattr(integrator, "span", Range)
    monkeypatch.setattr(shade, "shade_bounce_nee", lambda *a: seen.append(list(opened)) or (
        {k: getattr(state, k) for k in _NEE_STATE}, (state.ray_o,) * 5))
    integrator.trace_bounce_nee(scene, settings, lights, state, None, None, False, allow_nee=allow, deferred=True,
                                precomputed=(hit, blob))
    assert seen == [["owlpt.shade", "owlpt.nee"]] and opened == []


class _Recorder:
    """Wraps a function and keeps its outputs, call by call."""

    def __init__(self, fn):
        self.fn, self.outs = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.outs.append(out)
        return out


@pytest.mark.parametrize("surface", ["blob", "gather"])
@pytest.mark.parametrize("parity", [True, False], ids=["parity", "corrected"])
def test_random_nee_bounce_reaches_every_case(monkeypatch, parity, surface):
    """The card test's NEE bounces (seed 12, 16,384 lanes) reach every case
    the NEE kernel branches on, as the plain deferred _shade_bounce_nee
    shades them: emissive hits on lights under MIS and as a path's first
    vertex (depth 0, prev_pdf 0), on emissive triangles that are no light,
    light samples with allow_nee off, grazing the light (pdf 0), of a light
    of emission 0 and with a non-finite contribution, pending shadow rays,
    each lobe, the compensated roulette's kill and survival, the pdf kill,
    the retry, misses and dead lanes."""
    scene, settings, lights, state, hit, blob, allow = random_nee_bounce("cpu", n=16384, seed=12, parity=parity)
    blob = blob if surface == "blob" else None
    samples = _Recorder(lights_mod.sample_lights)
    evals = _Recorder(disney.eval_all)
    monkeypatch.setattr(lights_mod, "sample_lights", samples)
    monkeypatch.setattr(disney, "eval_all", evals)
    out, pend = integrator._shade_bounce_nee(scene, settings, lights, state, hit, blob, None, False, allow, None,
                                             True)
    ls, (f_l, _) = samples.outs[0], evals.outs[0]
    mat = blob[:, 15].long() if blob is not None else scene.tri_mat[hit.tri.clamp(min=0)].long()
    live = state.alive & hit.hit
    emissive = live & (scene.materials.emission[mat] > 0)
    sampled = live & ~emissive
    is_light = (hit.tri[:, None] == lights.tri_id[None, :].long()).any(-1)
    first = (state.depth == 0) | (state.prev_pdf <= 0)
    advanced = out.depth > state.depth
    roulette = advanced & (state.depth > settings.rr_start_depth)
    lobes = out.prev_lobe[advanced]
    cases = {
        "light hit, MIS": int((emissive & is_light & ~first).sum()),
        "light hit, depth 0": int((emissive & is_light & (state.depth == 0)).sum()),
        "light hit, prev_pdf 0": int((emissive & is_light & (state.depth > 0) & (state.prev_pdf == 0)).sum()),
        "emissive non-light": int((emissive & ~is_light).sum()),
        "allow_nee off": int((sampled & ~allow).sum()),
        "grazing pdf 0": int((sampled & (ls.pdf == 0) & (ls.emission > 0)).sum()),
        "emission 0 light": int((sampled & (ls.emission == 0)).sum()),
        "non-finite contribution": int((sampled & allow & (ls.pdf > 0) & ~torch.isfinite(f_l).all(-1)).sum()),
        "pending": int(pend[4].sum()),
        **{f"lobe {v}": int((lobes == v).sum()) for v in (disney.LOBE_DIFFUSE, disney.LOBE_CLEARCOAT,
                                                         disney.LOBE_METALLIC, disney.LOBE_GLASS)},
        "roulette kill": int((roulette & ~out.alive).sum()),
        "roulette survival": int((roulette & out.alive).sum()),
        "pdf kill": int((sampled & ~out.alive & ~advanced).sum()),
        "retry": int((sampled & out.alive & ~advanced).sum()),
        "miss": int((state.alive & ~hit.hit).sum()),
        "dead": int((~state.alive).sum()),
    }
    assert min(cases.values()) > 0, str(cases)
    assert not (pend[4] & ~sampled).any() and (pend[3][~pend[4]] == 0).all()
