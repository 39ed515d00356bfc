"""The 5-lobe Disney BSDF, batched (counterpart of ``owl_path_tracer_tpu/ops/disney.py``).

All lobes are sampled for the whole wavefront and combined with selects.
Reference semantics kept as the JAX package keeps them: the returned pdf is
the per-lobe pdf (parity mode), sheen is added to any sampled lobe, the
metallic lobe samples the NDF, glass is forced when exiting glass, and glass
consumes a branch-dependent number of LCG draws (TIR draws no choice random)
so the stream stays aligned draw for draw.

RNG draws per ``sample`` call: 1 (lobe) + 2 (sampler) = 3 for
diffuse/metal/clearcoat; glass: transmit 4, TIR 5, Fresnel reflect 6.
"""
from __future__ import annotations

import dataclasses

import torch

from ..render.metrics import host_copy
from . import math as m
from . import rng as rng_mod
from . import sampling as sm

LOBE_NONE = -1
LOBE_DIFFUSE = 0
LOBE_CLEARCOAT = 1
LOBE_METALLIC = 2
LOBE_GLASS = 3


def schlick_weight(cos_t):
    w = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    return w * w * w * w * w


def relative_eta(wo, ior):
    entering = m.cos_theta(wo) > 0.0
    eta_i = torch.where(entering, 1.0, ior)
    eta_t = torch.where(entering, ior, 1.0)
    return eta_i, eta_t, eta_i / eta_t


def roughness_to_alpha(roughness):
    return torch.clamp(torch.clamp(m.sqr(roughness), 0.0, 1.0), min=m.ALPHA_MIN)


def roughness_to_alpha_aniso(roughness, anisotropy):
    aspect = torch.sqrt(1.0 - 0.9 * anisotropy)
    ax = torch.clamp(m.sqr(roughness) / aspect, min=m.ALPHA_MIN)
    ay = torch.clamp(m.sqr(roughness) * aspect, min=m.ALPHA_MIN)
    return ax, ay


def fresnel_dielectric(i, mfn, eta_i, eta_t):
    """Full dielectric Fresnel (1 on total internal reflection)."""
    c = torch.abs(m.dot(i, mfn))
    denom = m.sqr(eta_t / eta_i) - 1.0 + m.sqr(c)
    g = torch.sqrt(torch.clamp(denom, min=0.0))
    sq = m.sqr(c * (g - c) + 1.0)
    r = (
        0.5
        * m.sqr((g - c) / torch.where(g + c == 0.0, 1.0, g + c))
        * (1.0 + m.sqr(c * (g + c) - 1.0) / torch.where(sq == 0.0, 1.0, sq))
    )
    return torch.where(denom < 0.0, 1.0, r)


def _tint(base_color):
    lum = m.luminance(base_color)
    safe = torch.where(lum > 0.0, lum, 1.0)[..., None]
    return torch.where((lum > 0.0)[..., None], base_color / safe, 1.0)


def smith_lambda(w, ax, ay):
    tan_t = m.tan_theta(w)
    inf = torch.isinf(tan_t)
    tan_safe = torch.where(inf, 1.0, tan_t)
    alpha0 = torch.sqrt(m.sqr(m.cos_phi(w) * ax) + m.sqr(m.sin_phi(w) * ay))
    inv_a2 = m.sqr(alpha0 * tan_safe)
    lam = (-1.0 + torch.sqrt(1.0 + inv_a2)) / 2.0
    return torch.where(inf, 0.0, lam)


def g1_smith(w, ax, ay):
    return 1.0 / (1.0 + smith_lambda(w, ax, ay))


def g2_smith_separable(wo, wi, ax, ay):
    return g1_smith(wo, ax, ay) * g1_smith(wi, ax, ay)


def g2_smith_correlated(wo, wi, ax, ay):
    return 1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay))


def d_gtr2(wm, ax, ay):
    """Anisotropic GGX NDF."""
    tan2 = m.sqr(m.tan_theta(wm))
    inf = torch.isinf(tan2)
    tan2_safe = torch.where(inf, 0.0, tan2)
    cos4 = m.sqr(m.sqr(m.cos_theta(wm)))
    e = 1.0 + tan2_safe * (m.sqr(m.cos_phi(wm)) / m.sqr(ax) + m.sqr(m.sin_phi(wm)) / m.sqr(ay))
    denom = m.PI * ax * ay * cos4 * m.sqr(e)
    d = 1.0 / torch.where(denom == 0.0, 1.0, denom)
    return torch.where(inf | (denom == 0.0), 0.0, d)


def d_gtr1(wh, alpha):
    """GTR gamma=1 (clearcoat)."""
    a2 = m.sqr(alpha)
    val = (a2 - 1.0) / (m.PI * torch.log(a2) * (1.0 + (a2 - 1.0) * m.sqr(m.cos_theta(wh))))
    return torch.where(alpha >= 1.0, m.INV_PI, val)


def sample_gtr2_ndf(wo, ax, ay, u):
    """Anisotropic GTR2 NDF sample with the reference's phi formula
    ``atan(ay/ax * tan(2 pi u1 + 1/pi)) (+ pi if u1 > .5)``."""
    u0, u1 = u[..., 0], u[..., 1]
    phi = torch.atan(ay / ax * torch.tan(m.TWO_PI * u1 + m.INV_PI))
    phi = torch.where(u1 > 0.5, phi + m.PI, phi)
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
    alpha2 = 1.0 / (m.sqr(cos_phi) / m.sqr(ax) + m.sqr(sin_phi) / m.sqr(ay))
    tan_theta2 = alpha2 * u0 / torch.clamp(1.0 - u0, min=1e-20)
    cos_t = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_t = torch.sqrt(torch.clamp(1.0 - m.sqr(cos_t), min=0.0))
    wh = m.spherical_direction_sincos(sin_t, cos_t, phi)
    return wh / torch.sqrt(m.dot(wh, wh))[..., None]


def sample_gtr2_vndf(wo, ax, ay, u):
    """Heitz 2018 visible-normal sampling (the corrected, parity=False mode)."""
    n = torch.stack([ax * wo[..., 0], ay * wo[..., 1], wo[..., 2]], dim=-1)
    n = n / torch.sqrt(m.dot(n, n))[..., None]
    len_sq = m.sqr(n[..., 0]) + m.sqr(n[..., 1])
    inv = 1.0 / torch.sqrt(torch.where(len_sq > 0.0, len_sq, 1.0))
    x_axis = host_copy("owlpt.sync.x_axis", [1.0, 0.0, 0.0], dtype=wo.dtype, device=wo.device).expand(n.shape)
    t = torch.where(
        (len_sq > 0.0)[..., None],
        torch.stack([-n[..., 1] * inv, n[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        x_axis,
    )
    b = m.cross(n, t)
    r = torch.sqrt(u[..., 0])
    phi = m.TWO_PI * u[..., 1]
    t1 = r * torch.cos(phi)
    b1 = r * torch.sin(phi)
    s = 0.5 * (1.0 + n[..., 2])
    b1 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - m.sqr(t1), min=0.0)) + s * b1
    nh = (
        t1[..., None] * t
        + b1[..., None] * b
        + torch.sqrt(torch.clamp(1.0 - m.sqr(t1) - m.sqr(b1), min=0.0))[..., None] * n
    )
    wh = torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    return wh / torch.sqrt(torch.clamp(m.dot(wh, wh), min=1e-20))[..., None]


def sample_gtr1_ndf(wo, alpha, u):
    """GTR1 sample, flipped into wo's hemisphere."""
    a2 = m.sqr(alpha)
    num = 1.0 - torch.pow(a2, 1.0 - u[..., 0])
    den = torch.where(a2 == 1.0, 1.0, 1.0 - a2)
    cos_t = torch.sqrt(torch.clamp(num / den, min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - m.sqr(cos_t), min=0.0))
    phi = m.TWO_PI * u[..., 1]
    wh = m.spherical_direction_sincos(sin_t, cos_t, phi)
    return torch.where(m.same_hemisphere(wo, wh)[..., None], wh, -wh)


def sample_gtr2_walter(alpha, u):
    """Walter-07 microfacet sample."""
    theta = torch.atan(alpha * torch.sqrt(u[..., 0]) / torch.sqrt(torch.clamp(1.0 - u[..., 0], min=1e-20)))
    return m.spherical_direction(theta, m.TWO_PI * u[..., 1])


# ── lobe evals (f [N,3], pdf [N]) ─────────────────────────────────────────


def eval_diffuse(mat, wo, wi):
    f_o = schlick_weight(m.cos_theta(wo))
    f_i = schlick_weight(m.cos_theta(wi))
    lambert = mat.base_color * m.INV_PI
    fd = (1.0 - 0.5 * f_o) * (1.0 - 0.5 * f_i)
    rr = mat.roughness * (m.dot(wo, wi) + 1.0)
    fr = rr * (f_i + f_o + f_o * f_i * (rr - 1.0))
    return lambert * (fd + fr)[..., None], sm.pdf_cosine_hemisphere(wi)


def eval_specular_brdf(mat, wo, wh, wi, corrected=False):
    """Metallic GGX lobe.  Parity pdf g1*d*max(0,wo.wh)/(4 cos wo);
    ``corrected`` gives the VNDF density d*g1/(4|cos wo|)."""
    c_tint = _tint(mat.base_color)
    c_spec = m.lerp(
        0.08 * mat.specular[..., None] * m.lerp(torch.ones_like(c_tint), c_tint, mat.specular_tint[..., None]),
        mat.base_color,
        mat.metallic[..., None],
    )
    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    d = d_gtr2(wh, ax, ay)
    g = g2_smith_correlated(wo, wi, ax, ay)
    f = m.lerp(c_spec, torch.ones_like(c_spec), schlick_weight(m.dot(wi, wh))[..., None])
    cos_o = m.cos_theta(wo)
    cos_safe = torch.where(cos_o == 0.0, 1.0, cos_o)
    if corrected:
        pdf = d * g1_smith(wo, ax, ay) / (4.0 * torch.abs(cos_safe))
    else:
        pdf = d * g1_smith(wo, ax, ay) * torch.clamp(m.dot(wo, wh), min=0.0) / (4.0 * cos_safe)
    pdf = torch.where(cos_o == 0.0, 0.0, pdf)
    val = d * g / (4.0 * torch.abs(cos_safe))
    val = torch.where(cos_o == 0.0, 0.0, val)
    return f * val[..., None], pdf


def eval_specular_bsdf(mat, wo, wh, wi):
    """Glass lobe (Walter-07 style reflection / transmission)."""
    eta_i, eta_t, eta = relative_eta(wo, mat.ior)
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    cos_i = torch.abs(m.cos_theta(wi))
    cos_safe = torch.where(cos_i == 0.0, 1.0, cos_i)
    refl = m.same_hemisphere(wo, wi)
    pdf = torch.where(refl, r / (r + t), t / (r + t))
    f_refl = mat.base_color * (r / cos_safe)[..., None]
    f_trans = torch.sqrt(torch.clamp(mat.base_color, min=0.0)) * (t / cos_safe / m.sqr(eta))[..., None]
    f = torch.where(refl[..., None], f_refl, f_trans)
    f = torch.where((cos_i == 0.0)[..., None], 0.0, f)
    return f, pdf


def eval_clearcoat(mat, wo, wh, wi, corrected=False):
    """GTR1 clearcoat; ``corrected`` adds the cos(theta_h) the parity pdf omits."""
    alpha = m.lerp(0.1, 0.001, mat.clearcoat_gloss)
    d = d_gtr1(wh, alpha)
    f = m.lerp(1.0, schlick_weight(m.cos_theta(wi)), 0.04)
    g = g2_smith_separable(wo, wi, 0.25, 0.25)
    dwh_wi = m.dot(wh, wi)
    num = d * torch.abs(m.cos_theta(wh)) if corrected else d
    pdf = num / torch.where(dwh_wi == 0.0, 1.0, 4.0 * dwh_wi)
    pdf = torch.where(dwh_wi == 0.0, 0.0, pdf)
    denom = 4.0 * torch.abs(m.cos_theta(wo)) * torch.abs(m.cos_theta(wi))
    val = d * g * f / torch.where(denom == 0.0, 1.0, denom)
    val = torch.where(denom == 0.0, 0.0, val)
    active = mat.clearcoat > 0.0
    fv = torch.where(active[..., None], val[..., None].expand(val.shape + (3,)), 0.0)
    return fv, torch.where(active, pdf, 0.0)


def eval_sheen(mat, wo, wi):
    """Additive sheen (no pdf)."""
    wh = wi + wo
    wh_zero = m.dot(wh, wh) == 0.0
    wh_n = wh / torch.sqrt(torch.where(wh_zero, 1.0, m.dot(wh, wh)))[..., None]
    lum = m.luminance(m.srgb_to_linear_gamma22(mat.base_color))
    tint = torch.where(
        (lum > 0.0)[..., None],
        mat.base_color / torch.where(lum > 0.0, lum, 1.0)[..., None],
        1.0,
    )
    cos_d = m.dot(wi, wh_n)
    val = (
        m.lerp(torch.ones_like(tint), tint, mat.sheen_tint[..., None])
        * mat.sheen[..., None]
        * schlick_weight(cos_d)[..., None]
    )
    inactive = (mat.sheen <= 0.0) | wh_zero
    return torch.where(inactive[..., None], 0.0, val)


# ── lobe samplers ─────────────────────────────────────────────────────────


def sample_specular_brdf(mat, wo, u, corrected=False):
    """NDF (or, corrected, VNDF) sample, flip wh to wo's side, reflect."""
    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    wh = sample_gtr2_vndf(wo, ax, ay, u) if corrected else sample_gtr2_ndf(wo, ax, ay, u)
    wh = torch.where((m.dot(wo, wh) < 0.0)[..., None], -wh, wh)
    wi = m.reflect(wo, wh)
    f, pdf = eval_specular_brdf(mat, wo, wh, wi, corrected=corrected)
    dead = m.cos_theta(wi) <= 0.0
    return wi, torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


def sample_clearcoat(mat, wo, u, corrected=False):
    alpha = m.lerp(0.1, 0.001, mat.clearcoat_gloss)
    wh = sample_gtr1_ndf(wo, alpha, u)
    wh = torch.where((m.dot(wh, wo) < 0.0)[..., None], -wh, wh)
    wh = wh / torch.sqrt(m.dot(wh, wh))[..., None]
    wi = m.reflect(wo, wh)
    f, pdf = eval_clearcoat(mat, wo, wh, wi, corrected=corrected)
    dead = ~m.same_hemisphere(wo, wi)
    return wi, torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


def sample_diffuse(mat, wo, u):
    wi = sm.sample_cosine_hemisphere(u)
    f, pdf = eval_diffuse(mat, wo, wi)
    return wi, f, pdf


def sample_glass(mat, wo, u_wh, u_choice, u_ndf_tir, u_ndf_choice):
    """Glass with exact draw accounting -> (wi, f, pdf, consumed): consumed
    is 4 (transmit), 5 (TIR -> reflect; the choice draw is short-circuited
    away) or 6 (Fresnel reflect)."""
    a_t = roughness_to_alpha(mat.specular_transmission_roughness)
    wh = sample_gtr2_walter(a_t, u_wh)
    flip = (m.cos_theta(wo) < 0.0) & ~m.same_hemisphere(wo, wh)
    wh = torch.where(flip[..., None], -wh, wh)

    eta_i, eta_t, eta = relative_eta(wo, mat.ior)
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    ok, wi_refr = m.refract(wo, wh, eta)
    choose_reflect = (~ok) | (u_choice < r / (r + t))

    ax, ay = roughness_to_alpha_aniso(mat.roughness, mat.anisotropic)
    wh_r = torch.where(
        ok[..., None],
        sample_gtr2_ndf(wo, ax, ay, u_ndf_choice),
        sample_gtr2_ndf(wo, ax, ay, u_ndf_tir),
    )
    wi_refl = m.reflect(wo, wh_r)
    wi_refl = wi_refl / torch.sqrt(m.dot(wi_refl, wi_refl))[..., None]

    wi = torch.where(choose_reflect[..., None], wi_refl, wi_refr)
    wh_used = torch.where(choose_reflect[..., None], wh_r, wh)
    f, pdf = eval_specular_bsdf(mat, wo, wh_used, wi)
    consumed = torch.where(~ok, 5, torch.where(choose_reflect, 6, 4))
    return wi, f, pdf, consumed


def lobe_probabilities(mat):
    """Normalized discrete lobe weights (metal, diffuse, clearcoat, glass)."""
    dw = (1.0 - mat.specular_transmission) * (1.0 - mat.metallic)
    mw = mat.metallic
    cw = 0.25 * mat.clearcoat
    gw = (1.0 - mat.metallic) * mat.specular_transmission
    factor = 1.0 / (mw + gw + dw + cw)
    return mw * factor, dw * factor, cw * factor, gw * factor


@dataclasses.dataclass
class BsdfSample:
    f: torch.Tensor  # [N,3] reflectance (sheen included)
    wi: torch.Tensor  # [N,3] local frame
    pdf: torch.Tensor  # [N] per-lobe pdf (parity: no selection probability)
    lobe: torch.Tensor  # [N] LOBE_*
    state: torch.Tensor  # [N] int64 advanced LCG state


def sample(mat, wo, state, prev_lobe, corrected: bool = False) -> BsdfSample:
    """Sample the Disney BSDF for every lane.

    mat: per-ray Materials; wo [N,3] local; state [N] int64 LCG state;
    prev_lobe [N] (the previous bounce's lobe).  ``corrected=True``
    (RenderSettings.parity=False) samples the metal VNDF, uses the full
    clearcoat pdf and multiplies the pdf by the lobe-selection probability,
    with the same draw accounting.

    Every lobe runs on every lane and the selected lane values are picked,
    so unselected lanes may hold non-finite values that the pick discards.
    While autograd records (and ``mat`` or ``wo`` requires gradients), each
    lobe runs on its selected lanes' inputs and on benign constants
    elsewhere, as in the JAX package: a lane's zero cotangent then never
    meets an inf or NaN partial of a lobe it did not select.  The selected
    lanes' values are the same either way, so the forward is bit-equal with
    and without recording.  The sample (``wi``, ``pdf``, lobe, stream) is
    detached: gradients flow through ``f`` only.
    """
    u, states = rng_mod.next_f32_n(state, 6)
    p = u[0]
    u2 = torch.stack([u[1], u[2]], dim=-1)

    p_metal, p_diff, p_cc, p_glass = lobe_probabilities(mat)
    force_btdf = (m.cos_theta(wo) < 0.0) & (prev_lobe == LOBE_GLASS)
    c1 = p_metal
    c2 = p_metal + p_cc
    c3 = p_metal + p_cc + p_diff
    sel_metal = ~force_btdf & (p <= c1)
    sel_cc = ~force_btdf & (p > c1) & (p <= c2)
    sel_diff = ~force_btdf & (p > c2) & (p <= c3)
    sel_glass = ~(sel_metal | sel_cc | sel_diff)

    u_t = (u[3], torch.stack([u[3], u[4]], dim=-1), torch.stack([u[4], u[5]], dim=-1))
    ins = {k: (mat, wo, u2, u_t) for k in ("m", "c", "d", "g")}
    if torch.is_grad_enabled() and (wo.requires_grad or any(
            getattr(mat, f.name).requires_grad for f in dataclasses.fields(mat))):
        ins = {k: _lobe_inputs(sel, mat, wo, u2, u_t)
               for k, sel in (("m", sel_metal), ("c", sel_cc), ("d", sel_diff), ("g", sel_glass))}
    wi_m, f_m, pdf_m = sample_specular_brdf(*ins["m"][:3], corrected=corrected)
    wi_c, f_c, pdf_c = sample_clearcoat(*ins["c"][:3], corrected=corrected)
    wi_d, f_d, pdf_d = sample_diffuse(*ins["d"][:3])
    wi_g, f_g, pdf_g, consumed_g = sample_glass(*ins["g"][:3], *ins["g"][3])

    def pick(vm, vc, vd, vg):
        sel = [s[..., None] if vm.dim() > s.dim() else s for s in (sel_metal, sel_cc, sel_diff)]
        return torch.where(sel[0], vm, torch.where(sel[1], vc, torch.where(sel[2], vd, vg)))

    wi = pick(wi_m, wi_c, wi_d, wi_g)
    f = pick(f_m, f_c, f_d, f_g)
    pdf = pick(pdf_m, pdf_c, pdf_d, pdf_g)
    if corrected:
        pdf = pdf * pick(p_metal, p_cc, p_diff, p_glass)
    lobe = pick(*(torch.full_like(prev_lobe, v) for v in
                  (LOBE_METALLIC, LOBE_CLEARCOAT, LOBE_DIFFUSE, LOBE_GLASS)))

    consumed = torch.where(sel_glass, consumed_g, 3)
    new_state = torch.where(
        consumed == 3, states[2],
        torch.where(consumed == 4, states[3], torch.where(consumed == 5, states[4], states[5])),
    )
    f = f + eval_sheen(mat, wo, wi)
    return BsdfSample(f=f, wi=wi.detach(), pdf=pdf.detach(), lobe=lobe, state=new_state)


def _lobe_inputs(sel, mat, wo, u2, u_t):
    """A lobe's inputs: the real ones on its selected lanes ``sel`` [N],
    benign constants elsewhere (0.5 for material fields, ior 1.5, wo +z,
    uniforms 0.25)."""
    def keep(v, other):
        return torch.where(sel[..., None] if v.dim() > sel.dim() else sel, v, other)

    benign = dataclasses.replace(mat, **{f.name: keep(getattr(mat, f.name), 1.5 if f.name == "ior" else 0.5)
                                         for f in dataclasses.fields(mat)})
    up = torch.tensor([0.0, 0.0, 1.0], dtype=wo.dtype, device=wo.device).expand(wo.shape)
    return benign, keep(wo, up), keep(u2, 0.25), tuple(keep(x, 0.25) for x in u_t)


# ── combined eval for NEE/MIS ─────────────────────────────────────────────


def eval_all(mat, wo, wi):
    """Full-BSDF value and mixture pdf for a given ``wi`` -> (f [N,3], pdf [N]).

    The parity sampler's per-lobe pdf (no selection probability) makes its
    estimator integrate f_eff = sum_k p_k f_k (+ sheen), so each lobe's f is
    weighted by its selection probability here too, and the pdf is the
    mixture sum_k p_k pdf_k: NEE and BSDF sampling then estimate the same
    transport.
    """
    p_metal, p_diff, p_cc, p_glass = lobe_probabilities(mat)
    refl = m.same_hemisphere(wo, wi)

    # reflection half-vector, oriented towards wo's hemisphere
    wh_r = wo + wi
    wh_len = torch.sqrt(torch.clamp(m.dot(wh_r, wh_r), min=1e-20))
    wh_r = wh_r / wh_len[..., None]
    wh_r = torch.where((m.dot(wh_r, wo) < 0.0)[..., None], -wh_r, wh_r)

    f_d, pdf_d = eval_diffuse(mat, wo, wi)
    f_m, pdf_m = eval_specular_brdf(mat, wo, wh_r, wi)
    f_c, pdf_c = eval_clearcoat(mat, wo, wh_r, wi)

    both_up = refl & (m.cos_theta(wo) > 0.0) & (m.cos_theta(wi) > 0.0)
    f_d = torch.where(both_up[..., None], f_d, 0.0)
    pdf_d = torch.where(both_up, pdf_d, 0.0)
    f_m = torch.where(both_up[..., None], f_m, 0.0)
    pdf_m = torch.where(both_up, pdf_m, 0.0)
    f_c = torch.where(both_up[..., None], f_c, 0.0)
    pdf_c = torch.where(both_up, pdf_c, 0.0)

    # glass: transmission half-vector -(eta_i wo + eta_t wi) (Walter eq. 16)
    eta_i, eta_t, _ = relative_eta(wo, mat.ior)
    wh_t = -(eta_i[..., None] * wo + eta_t[..., None] * wi)
    wh_t_len = torch.sqrt(torch.clamp(m.dot(wh_t, wh_t), min=1e-20))
    wh_t = wh_t / wh_t_len[..., None]
    wh_g = torch.where(refl[..., None], wh_r, wh_t)
    f_g, pdf_g = eval_specular_bsdf(mat, wo, wh_g, wi)

    f = (
        p_diff[..., None] * f_d
        + p_metal[..., None] * f_m
        + p_cc[..., None] * f_c
        + torch.where((p_glass > 0.0)[..., None], p_glass[..., None] * f_g, 0.0)
    )
    pdf = (
        p_diff * pdf_d
        + p_metal * pdf_m
        + p_cc * pdf_c
        + p_glass * torch.where(p_glass > 0.0, pdf_g, 0.0)
    )
    f = f + torch.where(refl[..., None], eval_sheen(mat, wo, wi), 0.0)
    return f, pdf
