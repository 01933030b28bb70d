"""Fused per-bounce shade and its adjoint (kernels B and B′ of
``csrc/shadebounce.cu``, replacing
``materialist_tpu/ops/pallas/shadebounce.py``).

One differentiable path vertex: two Disney BRDF evaluations, two bilinear
emitter fetches from the recorded tap coords, balance-heuristic MIS, and
the (throughput', Δradiance) update. The record layout is the JAX
package's:

    blob  (M, 5)  f32 : albedo rgb, roughness, metallic   [differentiable]
    thr   (M, 3)  f32 : path throughput                   [differentiable]
    nrmf  (M, 3)  f16 : shading normal
    auxf  (M, 8)  bf16: wo(3), win(3), gate_nee, gate_miss
    recb  (M, 13) bf16: pdf_e, pdf_at, wi_e(3), uvf(4), uvi(4)

``shade_bounce_fwd_plain`` is the plain forward (``_bounce_math``).
Kernel B′ returns (d_blob, d_thr, d_env): on the card it sums the envmap
gradient itself, each look's fetch cotangent into its four bilinear
taps. Its plain version, ``shade_bounce_bwd_plain``, is the composite the
JAX package runs: ``shade_bounce_bwd_explicit`` (the plain transcription
of the hand-derived adjoint, which returns the fetch cotangents d_le),
then ``_denv_from_dle``, the float32 one-hot contraction that the JAX
package keeps outside its Pallas kernels. ``denv_taps`` is the same sum
as four taps a look through ``index_add_`` (float64 by default), the
checks' reference for the kernel's d_env.
"""

from __future__ import annotations

import math

import torch

from materialist_tpu_torch.ops.brdf import pow5
from materialist_tpu_torch.ops.kernels import _lib

PI = math.pi
N_BLOB, N_NRM, N_AUX, N_REC = 5, 3, 8, 13
SMALL_ENV_AXIS = 64  # the emitter lives in shared memory


def _unpack(nrmf, auxf, recb):
    """Detached planes of the records as float32 columns."""
    n = nrmf.to(torch.float32)
    a = auxf.to(torch.float32)
    r = recb.to(torch.float32)
    return dict(n=n, wo=a[:, 0:3], win=a[:, 3:6], g_nee=a[:, 6] > 0.0,
                g_miss=a[:, 7] > 0.0, pdf_e=r[:, 0], pdf_at=r[:, 1],
                wie=r[:, 2:5], uvf=r[:, 5:9], uvi=r[:, 9:13].to(torch.int64))


def _lookup4(env, u0, v0, du, dv):
    h, w = env.shape[0], env.shape[1]
    flat = env.reshape(h * w, 3)
    u1 = torch.where(u0 + 1 >= w, 0, u0 + 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    du = du[:, None]
    dv = dv[:, None]
    acc = (1.0 - du) * (1.0 - dv) * flat[v0 * w + u0]
    acc = acc + du * (1.0 - dv) * flat[v0 * w + u1]
    acc = acc + (1.0 - du) * dv * flat[v1 * w + u0]
    return acc + du * dv * flat[v1 * w + u1]


def _fetches(env, det):
    uvf, uvi = det["uvf"], det["uvi"]
    le = _lookup4(env, uvi[:, 0], uvi[:, 1], uvf[:, 0], uvf[:, 1])
    lm = _lookup4(env, uvi[:, 2], uvi[:, 3], uvf[:, 2], uvf[:, 3])
    return le, lm


def _geom(wi, wo, n):
    """Detached geometry (no_l, no_v, vo_h, no_h) of one evaluation."""
    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]
    hv = wi + wo
    hn = torch.clamp_min(torch.sqrt(dot(hv, hv)), 1e-12)
    hv = hv / hn[:, None]
    return (torch.clamp_min(dot(n, wi), 0.0), torch.clamp_min(dot(n, wo), 0.0),
            torch.clamp_min(dot(wo, hv), 0.0), torch.clamp_min(dot(n, hv), 0.0))


def _disney(a, rough, metal, geo):
    """``_disney_soa``: (f (M, 3), pdf (M,)) and the intermediates."""
    no_l, no_v, vo_h, no_h = geo
    alpha = rough * rough
    alpha2 = alpha * alpha
    den = no_h * no_h * (alpha2 - 1.0) + 1.0 + 1e-6
    d = alpha2 / (PI * den * den)
    pdf = 0.5 * (d / (4.0 * torch.clamp_min(vo_h, 1e-6)) * no_h) \
        + 0.5 * (no_l / PI)
    one_m = 1.0 - metal
    f_d90 = 0.5 + 2.0 * vo_h * vo_h * rough
    f_out = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_v)
    f_in = 1.0 + (f_d90 - 1.0) * pow5(1.0 - no_l)
    diff_s = one_m / PI * f_out * f_in * no_l
    r1 = rough + 1.0
    k = r1 * r1 / 8.0
    ga = no_l * (1.0 - k) + k + 1e-6
    gb = no_v * (1.0 - k) + k + 1e-6
    g = 1.0 / (ga * gb)
    dg4 = d * g / 4.0 * no_l
    p5 = pow5(1.0 - vo_h)
    c0 = one_m[:, None] * 0.04 + metal[:, None] * a
    fm = c0 + (1.0 - c0) * p5[:, None]
    f = a * diff_s[:, None] + dg4[:, None] * fm
    return f, pdf, dict(d=d, den=den, g=g, ga=ga, gb=gb, f_out=f_out,
                        f_in=f_in, diff_s=diff_s, dg4=dg4, p5=p5,
                        one_m=one_m, fm=fm)


def _vertex(env, blob, thr, det):
    """Forward values of one bounce (the plain ``_bounce_math``)."""
    a, rough, metal = blob[:, 0:3], blob[:, 3], blob[:, 4]
    le, lm = _fetches(env, det)
    geo_e = _geom(det["wie"], det["wo"], det["n"])
    fe, pdf_be, ie = _disney(a, rough, metal, geo_e)
    pdf_e = det["pdf_e"]
    w_mis = pdf_e / (pdf_e + pdf_be.detach() + 1e-9)
    s_nee = (w_mis / (pdf_e + 1e-9))[:, None]
    geo_b = _geom(det["win"], det["wo"], det["n"])
    fb, pdf_b, ib = _disney(a, rough, metal, geo_b)
    pdf_b = pdf_b.detach()
    ok = (pdf_b > 1e-6)[:, None]
    inv = (1.0 / (pdf_b + 1e-6))[:, None]
    wc = torch.where(ok, fb * inv, 0.0)
    w = torch.nan_to_num(wc, nan=0.0, posinf=0.0, neginf=0.0)
    w_mis_b = (pdf_b / (pdf_b + det["pdf_at"] + 1e-9))[:, None]
    return dict(a=a, rough=rough, metal=metal, le=le, lm=lm, geo_e=geo_e,
                geo_b=geo_b, fe=fe, fb=fb, ie=ie, ib=ib, s_nee=s_nee, w=w,
                dw=torch.where(ok & torch.isfinite(wc), inv, 0.0),
                w_mis_b=w_mis_b)


def shade_bounce_fwd_plain(env, blob, thr, nrmf, auxf, recb):
    """Plain forward of kernel B: (thr' (M, 3), Δrad (M, 3)).
    Differentiable in env, blob and thr under torch.autograd."""
    det = _unpack(nrmf, auxf, recb)
    v = _vertex(env, blob, thr, det)
    cn = torch.where(det["g_nee"][:, None],
                     thr * v["fe"] * v["s_nee"] * v["le"], 0.0)
    cm = torch.where(det["g_miss"][:, None],
                     thr * v["w"] * v["w_mis_b"] * v["lm"], 0.0)
    return thr * v["w"], cn + cm


def _disney_bwd(a, rough, metal, geo, o, ct):
    """Hand-derived adjoint of ``_disney`` for f-cotangents ct (M, 3):
    (d_albedo (M, 3), d_rough (M,), d_metal (M,)); the pdf is detached."""
    no_l, no_v, vo_h, no_h = geo
    alpha2 = rough * rough * rough * rough
    pd2 = PI * o["den"] * o["den"]
    dd_da2 = 1.0 / pd2 - 2.0 * alpha2 * no_h * no_h / (pd2 * o["den"])
    dd_dr = dd_da2 * 4.0 * rough * rough * rough
    dg_dk = -o["g"] * ((1.0 - no_l) / o["ga"] + (1.0 - no_v) / o["gb"])
    dg_dr = dg_dk * (rough + 1.0) * 0.25
    ddg4_dr = (dd_dr * o["g"] + o["d"] * dg_dr) * 0.25 * no_l
    dfd90_dr = 2.0 * vo_h * vo_h
    dfout_dr = dfd90_dr * pow5(1.0 - no_v)
    dfin_dr = dfd90_dr * pow5(1.0 - no_l)
    ddiff_dr = o["one_m"] / PI * no_l * (dfout_dr * o["f_in"]
                                          + o["f_out"] * dfin_dr)
    ddiff_dm = -(1.0 / PI) * o["f_out"] * o["f_in"] * no_l
    q5 = (1.0 - o["p5"])[:, None]
    da = ct * (o["diff_s"][:, None] + o["dg4"][:, None] * q5
               * metal[:, None])
    dr = torch.sum(ct * (a * ddiff_dr[:, None] + ddg4_dr[:, None] * o["fm"]),
                   dim=-1)
    dm = torch.sum(ct * (a * ddiff_dm[:, None]
                         + o["dg4"][:, None] * q5 * (a - 0.04)), dim=-1)
    return da, dr, dm


def shade_bounce_bwd_explicit(env, blob, thr, nrmf, auxf, recb, ct_thr,
                              ct_rad):
    """Plain transcription of kernel B′'s adjoint: (d_blob (M, 5), d_thr
    (M, 3), d_le (M, 6)) for output cotangents ct_thr, ct_rad (M, 3);
    d_le holds the two fetches' cotangents, which the kernel sums into
    d_env itself."""
    det = _unpack(nrmf, auxf, recb)
    v = _vertex(env, blob, thr, det)
    gn = torch.where(det["g_nee"][:, None], ct_rad, 0.0)
    gm = torch.where(det["g_miss"][:, None], ct_rad, 0.0)
    ct_tw = ct_thr + gm * v["lm"] * v["w_mis_b"]
    ct_tfe = gn * v["le"] * v["s_nee"]
    d_thr = ct_tw * v["w"] + ct_tfe * v["fe"]
    ct_fb = ct_tw * thr * v["dw"]
    ct_fe = ct_tfe * thr
    d_le = torch.cat([gn * (thr * v["fe"] * v["s_nee"]),
                      gm * (thr * v["w"] * v["w_mis_b"])], dim=-1)
    a, r, m = v["a"], v["rough"], v["metal"]
    da1, dr1, dm1 = _disney_bwd(a, r, m, v["geo_e"], v["ie"], ct_fe)
    da2, dr2, dm2 = _disney_bwd(a, r, m, v["geo_b"], v["ib"], ct_fb)
    d_blob = torch.cat([da1 + da2, (dr1 + dr2)[:, None],
                        (dm1 + dm2)[:, None]], dim=-1)
    return d_blob, d_thr, d_le


def _denv_from_dle(envmap, recb, dle):
    """Emitter-table gradient (H, W, 3) from the per-query fetch
    cotangents dle (M, 6): a separable bilinear one-hot contraction in
    float32, d_env[v,u,c] = Σ_q voh[q,v]·uoh[q,u]·cot[q,c]."""
    h, w = envmap.shape[0], envmap.shape[1]
    r = recb.to(torch.float32)
    uvf = r[:, 5:9]
    uvi = r[:, 9:13].to(torch.int64)
    iu = torch.arange(w, device=dle.device)
    iv = torch.arange(h, device=dle.device)
    g = torch.zeros((h, w, 3), dtype=torch.float32, device=dle.device)
    for look in range(2):
        u0 = uvi[:, 2 * look]
        v0 = uvi[:, 2 * look + 1]
        u1 = torch.where(u0 + 1 >= w, 0, u0 + 1)
        v1 = torch.clamp_max(v0 + 1, h - 1)
        du = uvf[:, 2 * look, None]
        dv = uvf[:, 2 * look + 1, None]
        cot = dle[:, 3 * look:3 * look + 3]
        uoh = ((u0[:, None] == iu) * (1 - du) + (u1[:, None] == iu) * du)
        voh = ((v0[:, None] == iv) * (1 - dv) + (v1[:, None] == iv) * dv)
        g = g + torch.einsum("qv,qwc->vwc", voh,
                             uoh[:, :, None] * cot[:, None, :])
    return g.to(envmap.dtype)


def denv_taps(h, w, recb, d_le, dtype=torch.float64):
    """The envmap gradient (h, w, 3) as kernel B′ sums it, in ``dtype``:
    each look's cotangent d_le[:, 3l:3l+3] times its four bilinear
    weights, added to its taps through ``index_add_`` (u1 wraps at the
    seam, v1 clamps at the pole)."""
    uvf = recb[:, 5:9].to(dtype)
    uvi = recb[:, 9:13].to(torch.int64)
    out = torch.zeros((h * w, 3), dtype=dtype, device=d_le.device)
    for look in range(2):
        u0, v0 = uvi[:, 2 * look], uvi[:, 2 * look + 1]
        u1 = torch.where(u0 + 1 >= w, 0, u0 + 1)
        v1 = torch.clamp_max(v0 + 1, h - 1)
        du = uvf[:, 2 * look, None]
        dv = uvf[:, 2 * look + 1, None]
        ct = d_le[:, 3 * look:3 * look + 3].to(dtype)
        for v, u, wt in ((v0, u0, (1 - du) * (1 - dv)),
                         (v0, u1, du * (1 - dv)), (v1, u0, (1 - du) * dv),
                         (v1, u1, du * dv)):
            out.index_add_(0, v * w + u, wt * ct)
    return out.reshape(h, w, 3)


def shade_bounce_bwd_plain(env, blob, thr, nrmf, auxf, recb, ct_thr,
                           ct_rad, env_grad=True):
    """Plain version of kernel B′: (d_blob (M, 5), d_thr (M, 3), d_env
    (H, W, 3), or None without ``env_grad``)."""
    d_blob, d_thr, d_le = shade_bounce_bwd_explicit(
        env, blob, thr, nrmf, auxf, recb, ct_thr, ct_rad)
    return d_blob, d_thr, (_denv_from_dle(env, recb, d_le) if env_grad
                           else None)


# -------------------------------------------------------------- kernels

def _check_inputs(env, blob, thr, nrmf, auxf, recb):
    dev = blob.device
    m = blob.shape[0]
    h, w = env.shape[0], env.shape[1]
    _lib.expect(env, "env", torch.float32, (h, w, 3), dev)
    _lib.expect(blob, "blob", torch.float32, (m, N_BLOB), dev)
    _lib.expect(thr, "thr", torch.float32, (m, 3), dev)
    _lib.expect(nrmf, "nrmf", torch.float16, (m, N_NRM), dev)
    _lib.expect(auxf, "auxf", torch.bfloat16, (m, N_AUX), dev)
    _lib.expect(recb, "recb", torch.bfloat16, (m, N_REC), dev)
    if h > SMALL_ENV_AXIS or w > SMALL_ENV_AXIS:
        raise ValueError(f"env: {h}x{w}, the kernels take at most "
                         f"{SMALL_ENV_AXIS}x{SMALL_ENV_AXIS}")
    return m, h, w


def shade_bounce_fwd(env, blob, thr, nrmf, auxf, recb):
    """Kernel B on CUDA tensors (plain forward on CPU tensors)."""
    if blob.device.type == "cpu":
        return shade_bounce_fwd_plain(env, blob, thr, nrmf, auxf, recb)
    m, h, w = _check_inputs(env, blob, thr, nrmf, auxf, recb)
    thr_out = torch.empty((m, 3), dtype=torch.float32, device=blob.device)
    rad = torch.empty((m, 3), dtype=torch.float32, device=blob.device)
    if m:
        _lib.check(_lib.lib().shade_bounce_fwd_launch(
            env.data_ptr(), blob.data_ptr(), thr.data_ptr(), nrmf.data_ptr(),
            auxf.data_ptr(), recb.data_ptr(), thr_out.data_ptr(),
            rad.data_ptr(), m, h, w, _lib.stream_ptr(blob)),
            "shade_bounce_fwd")
        _lib.count_launch("shade_bounce_fwd", (m, h, w))
    return thr_out, rad


def shade_bounce_bwd(env, blob, thr, nrmf, auxf, recb, ct_thr, ct_rad,
                     env_grad=True):
    """Kernel B′ on CUDA tensors (its plain version on CPU tensors):
    (d_blob (M, 5), d_thr (M, 3), d_env (H, W, 3), or None without
    ``env_grad``)."""
    if blob.device.type == "cpu":
        return shade_bounce_bwd_plain(env, blob, thr, nrmf, auxf, recb,
                                      ct_thr, ct_rad, env_grad)
    m, h, w = _check_inputs(env, blob, thr, nrmf, auxf, recb)
    _lib.expect(ct_thr, "ct_thr", torch.float32, (m, 3), blob.device)
    _lib.expect(ct_rad, "ct_rad", torch.float32, (m, 3), blob.device)
    dev = blob.device
    d_blob = torch.empty((m, N_BLOB), dtype=torch.float32, device=dev)
    d_thr = torch.empty((m, 3), dtype=torch.float32, device=dev)
    d_env = (torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
             if env_grad else None)
    if m:
        _lib.check(_lib.lib().shade_bounce_bwd_launch(
            env.data_ptr(), blob.data_ptr(), thr.data_ptr(), nrmf.data_ptr(),
            auxf.data_ptr(), recb.data_ptr(), ct_thr.data_ptr(),
            ct_rad.data_ptr(), d_blob.data_ptr(), d_thr.data_ptr(),
            None if d_env is None else d_env.data_ptr(), m, h, w,
            _lib.stream_ptr(blob)), "shade_bounce_bwd")
        _lib.count_launch("shade_bounce_bwd", (m, h, w))
    return d_blob, d_thr, d_env


class _BounceOp(torch.autograd.Function):
    """Custom VJP of the fused bounce (``_get_bounce_op``)."""

    @staticmethod
    def forward(ctx, envmap, blob, thr, nrmf, auxf, recb):
        ctx.save_for_backward(envmap, blob, thr, nrmf, auxf, recb)
        with torch.no_grad():
            return shade_bounce_fwd(envmap, blob, thr, nrmf, auxf, recb)

    @staticmethod
    def backward(ctx, ct_thr, ct_rad):
        envmap, blob, thr, nrmf, auxf, recb = ctx.saved_tensors
        # no envmap gradient where nothing wants one (the material phases)
        d_blob, d_thr, d_env = shade_bounce_bwd(
            envmap, blob, thr, nrmf, auxf, recb, ct_thr.contiguous(),
            ct_rad.contiguous(), env_grad=ctx.needs_input_grad[0])
        return d_env, d_blob, d_thr, None, None, None


def shade_bounce_fused(envmap, blob5, thr, nrmf, auxf, recb):
    """One fused differentiable bounce on (s, n, C) planes; returns
    (thr_out (s, n, 3), rad_delta (s, n, 3))."""
    shape = thr.shape[:-1]

    def flat(x, c):
        return x.reshape(-1, c).contiguous()

    thr_out, rad = _BounceOp.apply(
        envmap.contiguous(), flat(blob5, N_BLOB), flat(thr, 3),
        flat(nrmf, N_NRM), flat(auxf, N_AUX), flat(recb, N_REC))
    return thr_out.reshape(*shape, 3), rad.reshape(*shape, 3)
