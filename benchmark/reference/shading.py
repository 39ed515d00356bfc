"""The Disney BSDF's sampling as the reference program renders it (its
parity mode: per-lobe pdf, sheen added to the sampled lobe, the metallic
lobe sampling the NDF, glass forced when leaving glass, glass drawing 4, 5
or 6 numbers), the shading frame and the sky, batched over rays in float32.

Every lobe is evaluated on every ray and the sampled one is picked, in the
same operation order as the program's eager shading, so that a ray that
hits the same point gets the same bits.
"""
from __future__ import annotations

import torch

from . import rng

PI = 3.14159265358979323
TWO_PI = 6.28318530717958648
PI_OVER_TWO = 1.57079632679489661
PI_OVER_FOUR = 0.78539816339744830
INV_PI = 0.31830988618379067
T_MIN = 1e-3
T_MAX = 1e10
ALPHA_MIN = 1e-3

LOBE_NONE, LOBE_DIFFUSE, LOBE_CLEARCOAT, LOBE_METALLIC, LOBE_GLASS = -1, 0, 1, 2, 3
FIELDS = ("base_color", "subsurface", "metallic", "specular", "specular_tint", "roughness", "anisotropic",
          "sheen", "sheen_tint", "clearcoat", "clearcoat_gloss", "ior", "specular_transmission",
          "specular_transmission_roughness", "emission")


# ── vectors ───────────────────────────────────────────────────────────────


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def sqr(x):
    return x * x


def lerp(a, b, t):
    return a + (b - a) * t


def cos_theta(w):
    return w[..., 2]


def sin_theta(w):
    return torch.sqrt(torch.clamp(1.0 - sqr(w[..., 2]), min=0.0))


def tan_theta(w):
    return sin_theta(w) / cos_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    safe = torch.where(st == 0.0, 1.0, st)
    return torch.where(st == 0.0, 1.0, torch.clamp(w[..., 0] / safe, -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    safe = torch.where(st == 0.0, 1.0, st)
    return torch.where(st == 0.0, 1.0, torch.clamp(w[..., 1] / safe, -1.0, 1.0))


def same_hemisphere(a, b):
    return cos_theta(a) * cos_theta(b) > 0.0


def spherical_direction(theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def spherical_direction_sincos(sin_t, cos_t, phi):
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def reflect(w, n):
    return 2.0 * dot(w, n)[..., None] * n - w


def refract(w, n, eta):
    """-> (ok, wi); ok is False on total internal reflection; eta 1 passes straight."""
    cos_i = dot(w, n)
    sin2_i = torch.clamp(1.0 - sqr(cos_i), min=0.0)
    sin2_t = sqr(eta) * sin2_i
    ok = sin2_t <= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi = eta[..., None] * -w + (eta * cos_i - cos_t)[..., None] * n
    straight = eta == 1.0
    wi = torch.where(straight[..., None], -w, wi)
    return ok | straight, wi


def onb(n):
    """Tangent frame (t, b) of n: the branchy (1,1,1) x n construction."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    t_a = torch.stack([nz - ny, nx - nz, ny - nx], dim=-1)
    t_b = torch.stack([nz - ny, nx + nz, -ny - nx], dim=-1)
    use_a = (nx != ny) | (nx != nz)
    t = torch.where(use_a[..., None], t_a, t_b)
    t = t / torch.sqrt(dot(t, t))[..., None]
    return t, torch.linalg.cross(n, t, dim=-1)


def to_local(t, b, n, w):
    v = torch.stack([dot(w, t), dot(w, b), dot(w, n)], dim=-1)
    return v / torch.sqrt(dot(v, v))[..., None]


def to_world(t, b, n, w):
    v = w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n
    return v / torch.sqrt(dot(v, v))[..., None]


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def sky(d):
    """The auto sky: white to (0.5, 0.7, 1.0) with the direction's height."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = torch.ones(d.shape[:-1] + (3,), dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device).expand(white.shape)
    return lerp(white, blue, t[..., None])


# ── microfacet pieces ─────────────────────────────────────────────────────


def schlick_weight(c):
    w = torch.clamp(1.0 - c, 0.0, 1.0)
    return w * w * w * w * w


def relative_eta(wo, ior):
    entering = cos_theta(wo) > 0.0
    eta_i = torch.where(entering, 1.0, ior)
    eta_t = torch.where(entering, ior, 1.0)
    return eta_i, eta_t, eta_i / eta_t


def alpha_of(roughness):
    return torch.clamp(torch.clamp(sqr(roughness), 0.0, 1.0), min=ALPHA_MIN)


def alpha_aniso(roughness, anisotropy):
    aspect = torch.sqrt(1.0 - 0.9 * anisotropy)
    return (torch.clamp(sqr(roughness) / aspect, min=ALPHA_MIN), torch.clamp(sqr(roughness) * aspect, min=ALPHA_MIN))


def fresnel_dielectric(i, mfn, eta_i, eta_t):
    c = torch.abs(dot(i, mfn))
    denom = sqr(eta_t / eta_i) - 1.0 + sqr(c)
    g = torch.sqrt(torch.clamp(denom, min=0.0))
    sq = sqr(c * (g - c) + 1.0)
    r = (0.5 * sqr((g - c) / torch.where(g + c == 0.0, 1.0, g + c))
         * (1.0 + sqr(c * (g + c) - 1.0) / torch.where(sq == 0.0, 1.0, sq)))
    return torch.where(denom < 0.0, 1.0, r)


def _tint(base):
    lum = luminance(base)
    safe = torch.where(lum > 0.0, lum, 1.0)[..., None]
    return torch.where((lum > 0.0)[..., None], base / safe, 1.0)


def smith_lambda(w, ax, ay):
    tan_t = tan_theta(w)
    inf = torch.isinf(tan_t)
    tan_safe = torch.where(inf, 1.0, tan_t)
    alpha0 = torch.sqrt(sqr(cos_phi(w) * ax) + sqr(sin_phi(w) * ay))
    lam = (-1.0 + torch.sqrt(1.0 + sqr(alpha0 * tan_safe))) / 2.0
    return torch.where(inf, 0.0, lam)


def g1_smith(w, ax, ay):
    return 1.0 / (1.0 + smith_lambda(w, ax, ay))


def d_gtr2(wm, ax, ay):
    tan2 = sqr(tan_theta(wm))
    inf = torch.isinf(tan2)
    tan2_safe = torch.where(inf, 0.0, tan2)
    cos4 = sqr(sqr(cos_theta(wm)))
    e = 1.0 + tan2_safe * (sqr(cos_phi(wm)) / sqr(ax) + sqr(sin_phi(wm)) / sqr(ay))
    denom = PI * ax * ay * cos4 * sqr(e)
    d = 1.0 / torch.where(denom == 0.0, 1.0, denom)
    return torch.where(inf | (denom == 0.0), 0.0, d)


def d_gtr1(wh, alpha):
    a2 = sqr(alpha)
    val = (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * sqr(cos_theta(wh))))
    return torch.where(alpha >= 1.0, INV_PI, val)


def sample_gtr2_ndf(ax, ay, u):
    u0, u1 = u[..., 0], u[..., 1]
    phi = torch.atan(ay / ax * torch.tan(TWO_PI * u1 + INV_PI))
    phi = torch.where(u1 > 0.5, phi + PI, phi)
    sin_p, cos_p = torch.sin(phi), torch.cos(phi)
    alpha2 = 1.0 / (sqr(cos_p) / sqr(ax) + sqr(sin_p) / sqr(ay))
    tan_theta2 = alpha2 * u0 / torch.clamp(1.0 - u0, min=1e-20)
    cos_t = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_t = torch.sqrt(torch.clamp(1.0 - sqr(cos_t), min=0.0))
    wh = spherical_direction_sincos(sin_t, cos_t, phi)
    return wh / torch.sqrt(dot(wh, wh))[..., None]


def sample_gtr1_ndf(wo, alpha, u):
    a2 = sqr(alpha)
    num = 1.0 - torch.pow(a2, 1.0 - u[..., 0])
    den = torch.where(a2 == 1.0, 1.0, 1.0 - a2)
    cos_t = torch.sqrt(torch.clamp(num / den, min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - sqr(cos_t), min=0.0))
    wh = spherical_direction_sincos(sin_t, cos_t, TWO_PI * u[..., 1])
    return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)


def sample_gtr2_walter(alpha, u):
    theta = torch.atan(alpha * torch.sqrt(u[..., 0]) / torch.sqrt(torch.clamp(1.0 - u[..., 0], min=1e-20)))
    return spherical_direction(theta, TWO_PI * u[..., 1])


def cosine_hemisphere(u):
    """Concentric disk, lifted to the hemisphere."""
    dx = 2.0 * u[..., 0] - 1.0
    dy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(dx) > torch.abs(dy)
    safe_dx = torch.where(dx == 0.0, 1.0, dx)
    safe_dy = torch.where(dy == 0.0, 1.0, dy)
    r = torch.where(use_x, dx, dy)
    phi = torch.where(use_x, PI_OVER_FOUR * (dy / safe_dx), PI_OVER_TWO - PI_OVER_FOUR * (dx / safe_dy))
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
    d = torch.where(((dx == 0.0) & (dy == 0.0))[..., None], 0.0, d)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


# ── lobes: value and pdf ──────────────────────────────────────────────────


def eval_diffuse(mat, wo, wi):
    f_o = schlick_weight(cos_theta(wo))
    f_i = schlick_weight(cos_theta(wi))
    lambert = mat["base_color"] * INV_PI
    fd = (1.0 - 0.5 * f_o) * (1.0 - 0.5 * f_i)
    rr = mat["roughness"] * (dot(wo, wi) + 1.0)
    fr = rr * (f_i + f_o + f_o * f_i * (rr - 1.0))
    return lambert * (fd + fr)[..., None], torch.abs(cos_theta(wi)) * INV_PI


def eval_metal(mat, wo, wh, wi):
    c_tint = _tint(mat["base_color"])
    c_spec = lerp(0.08 * mat["specular"][..., None]
                  * lerp(torch.ones_like(c_tint), c_tint, mat["specular_tint"][..., None]),
                  mat["base_color"], mat["metallic"][..., None])
    ax, ay = alpha_aniso(mat["roughness"], mat["anisotropic"])
    d = d_gtr2(wh, ax, ay)
    g = 1.0 / (1.0 + smith_lambda(wo, ax, ay) + smith_lambda(wi, ax, ay))
    f = lerp(c_spec, torch.ones_like(c_spec), schlick_weight(dot(wi, wh))[..., None])
    cos_o = cos_theta(wo)
    cos_safe = torch.where(cos_o == 0.0, 1.0, cos_o)
    pdf = d * g1_smith(wo, ax, ay) * torch.clamp(dot(wo, wh), min=0.0) / (4.0 * cos_safe)
    pdf = torch.where(cos_o == 0.0, 0.0, pdf)
    val = d * g / (4.0 * torch.abs(cos_safe))
    val = torch.where(cos_o == 0.0, 0.0, val)
    return f * val[..., None], pdf


def eval_glass(mat, wo, wh, wi):
    eta_i, eta_t, eta = relative_eta(wo, mat["ior"])
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    cos_i = torch.abs(cos_theta(wi))
    cos_safe = torch.where(cos_i == 0.0, 1.0, cos_i)
    refl = same_hemisphere(wo, wi)
    pdf = torch.where(refl, r / (r + t), t / (r + t))
    f_refl = mat["base_color"] * (r / cos_safe)[..., None]
    f_trans = torch.sqrt(torch.clamp(mat["base_color"], min=0.0)) * (t / cos_safe / sqr(eta))[..., None]
    f = torch.where(refl[..., None], f_refl, f_trans)
    return torch.where((cos_i == 0.0)[..., None], 0.0, f), pdf


def eval_clearcoat(mat, wo, wh, wi):
    alpha = lerp(0.1, 0.001, mat["clearcoat_gloss"])
    d = d_gtr1(wh, alpha)
    f = lerp(1.0, schlick_weight(cos_theta(wi)), 0.04)
    g = g1_smith(wo, 0.25, 0.25) * g1_smith(wi, 0.25, 0.25)
    dwh_wi = dot(wh, wi)
    pdf = d / torch.where(dwh_wi == 0.0, 1.0, 4.0 * dwh_wi)
    pdf = torch.where(dwh_wi == 0.0, 0.0, pdf)
    denom = 4.0 * torch.abs(cos_theta(wo)) * torch.abs(cos_theta(wi))
    val = d * g * f / torch.where(denom == 0.0, 1.0, denom)
    val = torch.where(denom == 0.0, 0.0, val)
    active = mat["clearcoat"] > 0.0
    return torch.where(active[..., None], val[..., None].expand(val.shape + (3,)), 0.0), torch.where(active, pdf, 0.0)


def eval_sheen(mat, wo, wi):
    wh = wi + wo
    wh_zero = dot(wh, wh) == 0.0
    wh_n = wh / torch.sqrt(torch.where(wh_zero, 1.0, dot(wh, wh)))[..., None]
    base = mat["base_color"]
    lum = luminance(torch.pow(torch.clamp(base, min=0.0), 2.2))
    tint = torch.where((lum > 0.0)[..., None], base / torch.where(lum > 0.0, lum, 1.0)[..., None], 1.0)
    val = (lerp(torch.ones_like(tint), tint, mat["sheen_tint"][..., None]) * mat["sheen"][..., None]
           * schlick_weight(dot(wi, wh_n))[..., None])
    return torch.where(((mat["sheen"] <= 0.0) | wh_zero)[..., None], 0.0, val)


# ── lobes: samples ────────────────────────────────────────────────────────


def sample_metal(mat, wo, u):
    ax, ay = alpha_aniso(mat["roughness"], mat["anisotropic"])
    wh = sample_gtr2_ndf(ax, ay, u)
    wh = torch.where((dot(wo, wh) < 0.0)[..., None], -wh, wh)
    wi = reflect(wo, wh)
    f, pdf = eval_metal(mat, wo, wh, wi)
    dead = cos_theta(wi) <= 0.0
    return wi, torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


def sample_clearcoat(mat, wo, u):
    alpha = lerp(0.1, 0.001, mat["clearcoat_gloss"])
    wh = sample_gtr1_ndf(wo, alpha, u)
    wh = torch.where((dot(wh, wo) < 0.0)[..., None], -wh, wh)
    wh = wh / torch.sqrt(dot(wh, wh))[..., None]
    wi = reflect(wo, wh)
    f, pdf = eval_clearcoat(mat, wo, wh, wi)
    dead = ~same_hemisphere(wo, wi)
    return wi, torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


def sample_diffuse(mat, wo, u):
    wi = cosine_hemisphere(u)
    f, pdf = eval_diffuse(mat, wo, wi)
    return wi, f, pdf


def sample_glass(mat, wo, u_wh, u_choice, u_ndf_tir, u_ndf_choice):
    wh = sample_gtr2_walter(alpha_of(mat["specular_transmission_roughness"]), u_wh)
    flip = (cos_theta(wo) < 0.0) & ~same_hemisphere(wo, wh)
    wh = torch.where(flip[..., None], -wh, wh)
    eta_i, eta_t, eta = relative_eta(wo, mat["ior"])
    r = fresnel_dielectric(wo, wh, eta_i, eta_t)
    t = 1.0 - r
    ok, wi_refr = refract(wo, wh, eta)
    choose_reflect = (~ok) | (u_choice < r / (r + t))
    ax, ay = alpha_aniso(mat["roughness"], mat["anisotropic"])
    wh_r = torch.where(ok[..., None], sample_gtr2_ndf(ax, ay, u_ndf_choice), sample_gtr2_ndf(ax, ay, u_ndf_tir))
    wi_refl = reflect(wo, wh_r)
    wi_refl = wi_refl / torch.sqrt(dot(wi_refl, wi_refl))[..., None]
    wi = torch.where(choose_reflect[..., None], wi_refl, wi_refr)
    wh_used = torch.where(choose_reflect[..., None], wh_r, wh)
    f, pdf = eval_glass(mat, wo, wh_used, wi)
    used = torch.where(~ok, 5, torch.where(choose_reflect, 6, 4))
    return wi, f, pdf, used


def sample_bsdf(mat, wo, state, prev_lobe):
    """-> (f, wi, pdf, lobe, state): six draws, of which the lobe consumes 3
    (glass 4, 5 or 6)."""
    u, states = [], []
    s = state
    for _ in range(6):
        x, s = rng.draw(s)
        u.append(x)
        states.append(s)
    p = u[0]
    u2 = torch.stack([u[1], u[2]], dim=-1)
    dw = (1.0 - mat["specular_transmission"]) * (1.0 - mat["metallic"])
    mw = mat["metallic"]
    cw = 0.25 * mat["clearcoat"]
    gw = (1.0 - mat["metallic"]) * mat["specular_transmission"]
    factor = 1.0 / (mw + gw + dw + cw)
    p_metal, p_diff, p_cc = mw * factor, dw * factor, cw * factor
    force_btdf = (cos_theta(wo) < 0.0) & (prev_lobe == LOBE_GLASS)
    c1 = p_metal
    c2 = p_metal + p_cc
    c3 = p_metal + p_cc + p_diff
    sel_m = ~force_btdf & (p <= c1)
    sel_c = ~force_btdf & (p > c1) & (p <= c2)
    sel_d = ~force_btdf & (p > c2) & (p <= c3)
    sel_g = ~(sel_m | sel_c | sel_d)

    wi_m, f_m, pdf_m = sample_metal(mat, wo, u2)
    wi_c, f_c, pdf_c = sample_clearcoat(mat, wo, u2)
    wi_d, f_d, pdf_d = sample_diffuse(mat, wo, u2)
    wi_g, f_g, pdf_g, used_g = sample_glass(mat, wo, u2, u[3], torch.stack([u[3], u[4]], dim=-1),
                                            torch.stack([u[4], u[5]], dim=-1))

    def pick(vm, vc, vd, vg):
        sel = [s_[..., None] if vm.dim() > s_.dim() else s_ for s_ in (sel_m, sel_c, sel_d)]
        return torch.where(sel[0], vm, torch.where(sel[1], vc, torch.where(sel[2], vd, vg)))

    wi = pick(wi_m, wi_c, wi_d, wi_g)
    f = pick(f_m, f_c, f_d, f_g)
    pdf = pick(pdf_m, pdf_c, pdf_d, pdf_g)
    lobe = pick(*(torch.full_like(prev_lobe, v) for v in (LOBE_METALLIC, LOBE_CLEARCOAT, LOBE_DIFFUSE, LOBE_GLASS)))
    used = torch.where(sel_g, used_g, 3)
    new_state = torch.where(used == 3, states[2],
                            torch.where(used == 4, states[3], torch.where(used == 5, states[4], states[5])))
    return f + eval_sheen(mat, wo, wi), wi, pdf, lobe, new_state
