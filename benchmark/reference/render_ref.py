"""Plain PyTorch reference of one SPPM pass's stages, written from the
reference renderer's semantics (wondergo2017/raytrace3: Raytracer.h,
Scene.h, Obj.h, Bezier.h, Element.h, Camera.h, Light.h).

It imports nothing of the program and takes only the benchmark's inputs
(``harness.inputs.scene_arrays``) and the stage inputs a check hands it:
each stage is a plain function of the state before it and the uniforms it
draws.  Every operation is float32, elementwise, with dot products summed
x + y + z from the left; there is no matmul, so TF32 cannot enter.

``precision="tf32"`` makes the control: the same stages with every float
input and output rounded to TF32 (10 mantissa bits, round to nearest even),
the nearest precision below the configuration's float32.
"""

from __future__ import annotations

import math

import torch

#: Reference epsilon (Vec3.h:6) and the miss distance.
EPS = 1e-4
MAX_DIST = 1e9
#: Newton acceptance on |residual|^2 (Bezier.h:140) and its clamps.
RES2_EPS = 1e-4
DET_EPS = 1e-12
#: PPM shrink factor (Raytracer.h:45) and the normal test of a deposit
#: (Raytracer.h:154).
ALPHA = 0.7
NORMAL_DOT_MIN = 1e-3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to 10 mantissa bits, to nearest even."""
    if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
        return x
    b = x.contiguous().view(torch.int32)
    keep = torch.bitwise_and(torch.bitwise_right_shift(b, 13), 1)
    r = torch.bitwise_and(b + 0xFFF + keep, ~0x1FFF)
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


def _round_tree(x, fn):
    if isinstance(x, (tuple, list)):
        return type(x)(_round_tree(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _round_tree(v, fn) for k, v in x.items()}
    return fn(x)


def in_precision(fn, precision: str):
    """``fn`` as computed in ``precision``: itself for float32, or with
    every float tensor in and out rounded to TF32."""
    if precision == "fp32":
        return fn
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")

    def lowered(*args, **kw):
        args = _round_tree(args, tf32)
        kw = {k: _round_tree(v, tf32) for k, v in kw.items()}
        return _round_tree(fn(*args, **kw), tf32)
    return lowered


# -- vectors ---------------------------------------------------------------

def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    n2 = dot(v, v)[..., None]
    small = n2 < EPS * EPS
    return torch.where(small, v, v / torch.sqrt(torch.where(small, 1.0, n2)))


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Snell with the total-internal-reflection fallback (Vec3.h:124-134)."""
    cos_i = -dot(n, d)
    cos_r2 = 1.0 - (1.0 - cos_i * cos_i) * eta * eta
    ok = cos_r2 > EPS
    cos_r = torch.sqrt(torch.where(ok, cos_r2, 1.0))
    out = d * eta[..., None] + n * (eta * cos_i - cos_r)[..., None]
    return torch.where(ok[..., None], out, reflect(d, n))


def unit_sphere(z, phi):
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def cosine_dir(u1, u2, n):
    """Cosine-weighted direction about ``n`` (Vec3.h:90-98), in the
    branchless frame of Duff et al."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    t2 = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    ct = torch.sqrt(u1)
    st = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    phi = 2.0 * math.pi * u2
    return (t1 * (st * torch.cos(phi))[..., None] + t2 * (st * torch.sin(phi))[..., None]
            + n * ct[..., None])


# -- camera ----------------------------------------------------------------

def camera_rays(base_pos, base_look, jitter: float, width: int, height: int, z, phi):
    """Camera rays of a pass (Raytracer.h:429-441, Camera.h:18-54): the pose
    jittered by ``jitter`` times the unit vector of (z, phi), 50 degree
    field of view, row-major pixels.  Returns (org (HW, 3), dir (HW, 3))."""
    pos = base_pos + jitter * unit_sphere(z, phi)
    up = torch.zeros_like(pos)
    up[2] = 1.0
    d = normalize(base_look - pos)
    du = normalize(cross(d, up))
    dv = normalize(-cross(d, du))
    fov = torch.deg2rad(torch.tensor(50.0, dtype=torch.float32))
    d = d * float(0.5 / torch.tan(fov / 2.0))
    dev = pos.device
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width - 0.5
    y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height - 0.5
    rays = du[None, None, :] * x[None, :, None] + dv[None, None, :] * y[:, None, None] + d
    return pos.expand(height * width, 3), normalize(rays).reshape(height * width, 3)


# -- intersection ------------------------------------------------------------

def _slab_open(o, d, lo, hi):
    """(R, B): ray r meets box b at some t >= 0 (IEEE slabs; a NaN slab is
    open)."""
    inv = 1.0 / d[:, None, :]
    t0 = (lo[None] - o[:, None, :]) * inv
    t1 = (hi[None] - o[:, None, :]) * inv
    near = torch.nan_to_num(torch.minimum(t0, t1), nan=-math.inf).amax(-1)
    far = torch.nan_to_num(torch.maximum(t0, t1), nan=math.inf).amin(-1)
    return far >= torch.clamp_min(near, 0.0)


def _bern(t):
    s = 1.0 - t
    return [s * s * s, 3.0 * t * s * s, 3.0 * t * t * s, t * t * t]


def _dbern(t):
    s = 1.0 - t
    return [-3.0 * s * s, 3.0 * s * s - 6.0 * t * s, 6.0 * t * s - 3.0 * t * t, 3.0 * t * t]


def _surface(g, u, v, derivs: bool):
    """S(u, v) (and dS/du, dS/dv) of per-lane patches ``g`` (N, 4, 4, 3);
    g[:, i, k] pairs the v basis with i and the u basis with k."""
    def rows(b):
        return [sum(b[k][:, None] * g[:, i, k] for k in range(4)) for i in range(4)]

    def cols(b, r):
        return sum(b[i][:, None] * r[i] for i in range(4))

    bu, bv = _bern(u), _bern(v)
    ru = rows(bu)
    if not derivs:
        return cols(bv, ru)
    return cols(bv, ru), cols(bv, rows(_dbern(u))), cols(_dbern(v), ru)


def restart_starts(restarts: int, device) -> torch.Tensor:
    """(restarts, 2) start (u0, v0): the centres of a gu x gv grid, gu the
    largest divisor of ``restarts`` not above its square root, u-major."""
    gu = math.isqrt(restarts)
    while restarts % gu:
        gu -= 1
    gv = restarts // gu
    u = (torch.arange(gu, dtype=torch.float32, device=device) + 0.5) / gu
    v = (torch.arange(gv, dtype=torch.float32, device=device) + 0.5) / gv
    return torch.stack([u.repeat_interleave(gv), v.repeat(gu)], -1)


def open_pairs(o, d, ctrl, chunk: int = 1 << 18):
    """(ray, patch) index pairs, (P,) each, whose patch box the ray meets."""
    g = ctrl.reshape(ctrl.shape[0], 16, 3)
    lo, hi = g.amin(1), g.amax(1)
    rays, patches = [], []
    for a in range(0, o.shape[0], chunk):
        r, p = torch.nonzero(_slab_open(o[a:a + chunk], d[a:a + chunk], lo, hi), as_tuple=True)
        rays.append(r + a)
        patches.append(p)
    return torch.cat(rays), torch.cat(patches)


def newton_hits(o, d, ctrl, iters: int, restarts: int):
    """Nearest ray-teapot hit (Bezier.h:112-159, 240-282): Newton on
    o + t d = S(u, v) from each of ``restarts`` starts on every patch whose
    box the ray meets, ``iters`` clamped Cramer steps, a root accepted after
    any step when |residual|^2 < 1e-4, u, v in [0, 1] and t > 1e-4.
    Returns t (R,) (MAX_DIST on a miss), hit, u, v, the viewer-facing unit
    normal (R, 3), and the (ray, patch) pairs run."""
    R = o.shape[0]
    dev = o.device
    ray, patch = open_pairs(o, d, ctrl)
    starts = restart_starts(restarts, dev)
    G = starts.shape[0]
    lr = ray.repeat_interleave(G)
    g = ctrl[patch.repeat_interleave(G)]
    u = starts[:, 0].repeat(ray.shape[0])
    v = starts[:, 1].repeat(ray.shape[0])
    lo, ld = o[lr], d[lr]
    t = dot(_surface(g, u, v, False) - lo, ld)
    best_t = torch.full_like(t, MAX_DIST)
    best_u, best_v = torch.zeros_like(t), torch.zeros_like(t)
    for _ in range(iters):
        s, su, sv = _surface(g, u, v, True)
        r = lo + t[:, None] * ld - s
        c = cross(su, sv)
        det = dot(ld, c)
        ok = (det.abs() > DET_EPS).to(t.dtype)
        inv = 1.0 / torch.where(det.abs() > DET_EPS, det, 1.0)
        dt = -dot(r, c) * inv
        du = dot(ld, cross(r, sv)) * inv
        dv = dot(ld, cross(su, r)) * inv
        t = torch.clamp(t + torch.clamp(dt, -1e4, 1e4) * ok, -1e4, 1e4)
        u = torch.clamp(u + torch.clamp(du, -8.0, 8.0) * ok, -8.0, 8.0)
        v = torch.clamp(v + torch.clamp(dv, -8.0, 8.0) * ok, -8.0, 8.0)
        a = lo + t[:, None] * ld - _surface(g, u, v, False)
        acc = ((dot(a, a) < RES2_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
               & (t > EPS) & (t < best_t))
        best_t = torch.where(acc, t, best_t)
        best_u = torch.where(acc, u, best_u)
        best_v = torch.where(acc, v, best_v)
    # The nearest accepted root of each ray over its lanes; of lanes tied
    # at it, the first (patch, then start, in order).
    out_t = torch.full((R,), MAX_DIST, dtype=o.dtype, device=dev)
    out_t = out_t.scatter_reduce(0, lr, best_t, "amin")
    win = (best_t < MAX_DIST) & (best_t == out_t[lr])
    none = lr.numel()
    lane = torch.full((R,), none, dtype=torch.int64, device=dev)
    lane = lane.scatter_reduce(0, lr[win], torch.nonzero(win)[:, 0], "amin")
    hit = lane < none
    if none == 0:
        zero = torch.zeros_like(out_t)
        n = torch.zeros_like(o)
        n[:, 2] = 1.0
        return out_t, hit, zero, zero, n, (ray, patch)
    li = torch.clamp_max(lane, none - 1)
    uu = torch.where(hit, best_u[li], 0.0)
    vv = torch.where(hit, best_v[li], 0.0)
    pid = patch.repeat_interleave(G)[li]
    _, su, sv = _surface(ctrl[pid], uu, vv, True)
    n = cross(su, sv)
    n = normalize(torch.where((dot(n, d) > 0.0)[:, None], -n, n))
    return out_t, hit, uu, vv, n, (ray, patch)


def _sample_atlas(atlas, tex, u, v):
    """Bilinear, wrapped (Element.h:61-72)."""
    T, H, W, _ = atlas.shape
    tid = torch.clamp(tex, 0, T - 1).long()
    row = (u - torch.floor(u)) * H
    col = (v - torch.floor(v)) * W
    r1 = torch.floor(row + 1e-10).to(torch.int64)
    c1 = torch.floor(col + 1e-10).to(torch.int64)
    dr = (r1 + 1 - row)[:, None]
    dc = (c1 + 1 - col)[:, None]
    r1 = torch.where(r1 >= 0, torch.where(r1 >= H, 0, r1), H - 1)
    c1 = torch.where(c1 >= 0, torch.where(c1 >= W, 0, c1), W - 1)
    r2, c2 = (r1 + 1) % H, (c1 + 1) % W
    return (atlas[tid, r1, c1] * dr * dc + atlas[tid, r1, c2] * dr * (1.0 - dc)
            + atlas[tid, r2, c1] * (1.0 - dr) * dc + atlas[tid, r2, c2] * (1.0 - dr) * (1.0 - dc))


def intersect(sc: dict, o, d, newton_iters: int, newton_restarts: int,
              observe=None) -> dict:
    """Nearest hit over planes, spheres and the teapot (Scene.h:165-182):
    t, hit, pos, n (as the reference stores it), inside, obj (-1 on a
    miss) and the surface colour.  ``observe(rays, patches)``, if given,
    sees the (ray, patch) pairs the teapot's Newton solve ran."""
    P, S = sc["plane_p0"].shape[0], sc["sph_c"].shape[0]
    pn, p0 = sc["plane_n"], sc["plane_p0"]
    proj = dot(d[:, None, :], pn[None])
    num = dot(p0[None] - o[:, None, :], pn[None])
    tp = num / torch.where(proj.abs() < EPS, 1.0, proj)
    tp = torch.where((proj.abs() >= EPS) & (tp > EPS), tp, MAX_DIST)

    L = sc["sph_c"][None] - o[:, None, :]
    sproj = dot(L, d[:, None, :])
    det2 = sc["sph_r"][None] ** 2 - (dot(L, L) - sproj * sproj)
    miss = det2 < EPS
    det = torch.sqrt(torch.where(miss, 1.0, det2))
    d1, d2 = sproj - det, sproj + det
    ins = d1 < EPS
    ts = torch.where(~miss & (d2 >= EPS), torch.where(ins, d2, d1), MAX_DIST)

    tb, hb, ub, vb, nb, pairs = newton_hits(o, d, sc["ctrl"], newton_iters, newton_restarts)
    if observe is not None:
        observe(*pairs)
    t_all = torch.cat([tp, ts, torch.where(hb, tb, MAX_DIST)[:, None]], 1)
    obj = torch.argmin(t_all, 1)
    t = t_all.amin(1)
    hit = t < MAX_DIST
    pos = o + torch.clamp_max(t, 1e6)[:, None] * d
    is_pl, is_sp = obj < P, (obj >= P) & (obj < P + S)
    is_bz = ~is_pl & ~is_sp
    pi, si = torch.clamp(obj, 0, P - 1), torch.clamp(obj - P, 0, S - 1)
    n = torch.where(is_sp[:, None], normalize(pos - sc["sph_c"][si]), pn[pi])
    n = torch.where(is_bz[:, None], nb, n)
    inside = is_sp & ins.gather(1, si[:, None])[:, 0]

    # Planar UV: the last axis with a nonzero normal component is the
    # plane's; u takes the next one over |texV|, v the one after over |texU|.
    pnr = pn[pi]
    nz = pnr != 0.0
    ndir = torch.where(nz[:, 2], 2, torch.where(nz[:, 1], 1, 0))
    rel = pos - p0[pi]
    up = 0.5 + rel.gather(1, ((ndir + 1) % 3)[:, None])[:, 0] / sc["plane_vmod"][pi]
    vp = 0.5 + rel.gather(1, ((ndir + 2) % 3)[:, None])[:, 0] / sc["plane_umod"][pi]
    # Spherical UV about the poles tex_v, tex_u (Obj.h:140-153).
    ns = normalize(pos - sc["sph_c"][si])
    lim = 1.0 - 1e-6
    theta = torch.acos(torch.clamp(dot(ns, sc["sph_tv"]), -lim, lim))
    st = torch.sin(theta)
    ph = torch.acos(torch.clamp(dot(ns, sc["sph_tu"]) / torch.where(st < 1e-12, 1e-12, st),
                                -lim, lim))
    us = theta / math.pi
    vs = ph / (2.0 * math.pi)
    vs = torch.where(dot(ns, cross(sc["sph_tu"], sc["sph_tv"])) < 0.0, 1.0 - vs, vs)
    u = torch.where(is_sp, us, up)
    v = torch.where(is_sp, vs, vp)
    u = torch.where(is_bz, ub, u)
    v = torch.where(is_bz, t if sc["uv_quirk"] else vb, v)

    oc = torch.clamp(obj, 0, sc["obj_color"].shape[0] - 1)
    tex = sc["obj_tex"][oc]
    color = torch.where((tex >= 0)[:, None], _sample_atlas(sc["atlas"], tex, u, v),
                        sc["obj_color"][oc])
    return {"t": t, "hit": hit, "pos": pos, "n": n, "inside": inside,
            "obj": torch.where(hit, obj, -1), "color": color}


def _lobes(sc: dict):
    """Per object: which lobes are on (no channel within 1e-4 of 0), their
    powers (channel means) and the refraction index."""
    on = lambda m: ~(m.abs() < EPS).any(-1)
    m = sc["mat_diff"], sc["mat_refl"], sc["mat_refr"]
    return [on(x) for x in m], [x.mean(-1) for x in m]


def _eta(rn, inside):
    safe = torch.where(rn.abs() < 1e-6, 1.0, rn)
    return torch.where(inside, safe, 1.0 / safe)


def eye_segment(sc: dict, lanes, newton_iters: int, newton_restarts: int, observe=None):
    """One eye segment (Raytracer.h:298-365) on lanes (org, dir, weight,
    pixel, active): a diffuse hit stores a hit-point row (pos | n | weight x
    colour x diff | pixel | valid) and specular hits continue (the
    reflection, else the refraction; a second lobe is dropped and counted).
    Returns (lanes, dropped, rows)."""
    o, d, w, px, act = lanes
    rec = intersect(sc, o, d, newton_iters, newton_restarts, observe)
    obj = torch.clamp(rec["obj"], 0, sc["obj_color"].shape[0] - 1)
    (isd, isl, isr), _ = _lobes(sc)
    hit = rec["hit"] & act
    diff_v = hit & isd[obj]
    rows = torch.cat([rec["pos"], rec["n"], rec["color"] * w * sc["mat_diff"][obj],
                      px.to(torch.float32)[:, None], diff_v.to(torch.float32)[:, None]], 1)
    refl_v, refr_v = hit & isl[obj], hit & isr[obj]
    n = rec["n"]
    d_refl = normalize(reflect(d, n))
    d_refr = normalize(refract(d, torch.where(rec["inside"][:, None], -n, n),
                               _eta(sc["mat_refrn"][obj], rec["inside"])))
    new_d = torch.where(refl_v[:, None], d_refl, d_refr)
    new_w = torch.where(refl_v[:, None], rec["color"] * w * sc["mat_refl"][obj],
                        rec["color"] * w * sc["mat_refr"][obj])
    dropped = (refl_v & refr_v).sum(dtype=torch.int32)
    return (rec["pos"], new_d, new_w, px, refl_v | refr_v), dropped, rows


def photon_segment(sc: dict, carry, draws, segs: int, newton_iters: int,
                   newton_restarts: int, observe=None):
    """One segment of the persistent-lane photon walk (Raytracer.h:117-209,
    Light.h:8-13): dead lanes are refilled from the lights, round-robin over
    the refills, with a uniform direction from (z, phi) and flux colour x
    4 pi; every lane intersects, records a deposit (pos, n, arrival flux) at
    a diffuse surface, and takes one lobe by roulette on the lobe powers
    without dividing by its probability.

    ``carry``: (org, dir, flux, alive, depth, refill offset, emitted per
    light); ``draws``: (z, phi, roulette, u1, u2), each (N,).  Returns
    (carry, record (pos, n, flux, valid))."""
    o, d, f, alive, depth, rr_off, emitted = carry
    z, phi, ur, u1, u2 = draws
    lp, lc = sc["light_pos"], sc["light_color"]
    L = lp.shape[0]
    need = ~alive
    rank = torch.clamp_min(torch.cumsum(need.to(torch.int64), 0) - 1, 0)
    lid = (rr_off.to(torch.int64) + rank) % L
    o = torch.where(need[:, None], lp[lid], o)
    d = torch.where(need[:, None], unit_sphere(z, phi), d)
    f = torch.where(need[:, None], lc[lid] * (4.0 * math.pi), f)
    emitted = emitted + torch.zeros_like(emitted).index_add_(
        0, lid[need], torch.ones_like(lid[need], dtype=emitted.dtype))
    depth = torch.where(need, 0, depth)
    rr_off = ((rr_off.to(torch.int64) + need.sum()) % L).to(rr_off.dtype)

    rec = intersect(sc, o, d, newton_iters, newton_restarts, observe)
    obj = torch.clamp(rec["obj"], 0, sc["obj_color"].shape[0] - 1)
    (isd, _, _), (dp, rp, rr) = _lobes(sc)
    record = (rec["pos"], rec["n"], f, rec["hit"] & isd[obj])
    dp, rp, rr = dp[obj], rp[obj], rr[obj]
    r = ur * (dp + rp + rr)
    branch = torch.where(dp > r, 0, torch.where(dp + rp > r, 1, 2))
    n = rec["n"]
    d_diff = cosine_dir(u1, u2, n)
    d_refl = normalize(reflect(d, n))
    d_refr = normalize(refract(d, torch.where(rec["inside"][:, None], -n, n),
                               _eta(sc["mat_refrn"][obj], rec["inside"])))
    new_d = torch.where((branch == 0)[:, None], d_diff,
                        torch.where((branch == 1)[:, None], d_refl, d_refr))
    depth = depth + 1
    return ((rec["pos"], new_d, rec["color"] * f, rec["hit"] & (depth < segs), depth,
             rr_off, emitted), record)


# -- deposit, update, estimate --------------------------------------------------

def deposit(h_pos, h_n, h_r2, d_pos, d_n, d_flux, d_valid, max_pairs: int = 1 << 23):
    """Every (deposit, hit point) pair with |h - d|^2 <= r2 of the hit point
    and n_h . n_d > 1e-3 (Raytracer.h:154-157), over valid deposits and hit
    points with r2 > 0.  Found through a grid of cells no smaller than the
    largest radius, so every pair inside a radius is tested exactly once.

    Returns (count (C,) float32, raw flux (C, 3) float32 summed in float64,
    pairs inside radii)."""
    dev = h_pos.device
    C = h_pos.shape[0]
    cnt = torch.zeros((C,), dtype=torch.float64, device=dev)
    flux = torch.zeros((C, 3), dtype=torch.float64, device=dev)
    hv = torch.nonzero(h_r2 > 0)[:, 0]
    dv = torch.nonzero(d_valid)[:, 0]
    if hv.numel() == 0 or dv.numel() == 0:
        return cnt.float(), flux.float(), 0
    # Cells in float64: far-field points (up to 1e6 away) would otherwise
    # round a near pair into cells two apart.
    cell = float(torch.sqrt(h_r2[hv].max().double())) * (1.0 + 1e-6)
    hp, dp = h_pos[hv].double(), d_pos[dv].double()
    lo = torch.minimum(hp.amin(0), dp.amin(0))
    hc = torch.floor((hp - lo) / cell).to(torch.int64) + 1
    dc = torch.floor((dp - lo) / cell).to(torch.int64) + 1
    ext = torch.maximum(hc.amax(0), dc.amax(0)) + 2
    key = lambda c: (c[:, 0] * ext[1] + c[:, 1]) * ext[2] + c[:, 2]
    hkey, order = torch.sort(key(hc))
    hidx = hv[order]
    inside = 0
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]
    for off in offs:
        k = key(dc + torch.tensor(off, device=dev))
        s = torch.searchsorted(hkey, k)
        e = torch.searchsorted(hkey, k, right=True)
        lens = e - s
        ends = torch.cumsum(lens, 0)
        total = int(ends[-1])
        for a in range(0, total, max_pairs):
            item = torch.arange(a, min(a + max_pairs, total), device=dev)
            j = torch.searchsorted(ends, item, right=True)
            hi = hidx[s[j] + item - (ends[j] - lens[j])]
            di = dv[j]
            hx, dx_ = h_pos[hi], d_pos[di]
            ddx = hx[:, 0] - dx_[:, 0]
            ddy = hx[:, 1] - dx_[:, 1]
            ddz = hx[:, 2] - dx_[:, 2]
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            hn, dn = h_n[hi], d_n[di]
            nd = hn[:, 0] * dn[:, 0] + hn[:, 1] * dn[:, 1] + hn[:, 2] * dn[:, 2]
            m = (d2 <= h_r2[hi]) & (nd > NORMAL_DOT_MIN)
            inside += int(m.sum())
            cnt.index_add_(0, hi[m], torch.ones_like(hi[m], dtype=torch.float64))
            flux.index_add_(0, hi[m], d_flux[di[m]].double())
    return cnt.float(), flux.float(), inside


def ppm_update(r2, tao, nphot, d_nphot, d_tao, alpha: float = ALPHA):
    """The progressive radius update (SPPM, Raytracer.h:69-79 as intended):
    k = (N + a dN) / (N + dN); r2 *= k; tao = (tao + dtao) k; N += a dN,
    where dN > 0."""
    has = d_nphot > 0.0
    k = torch.where(has, (nphot + alpha * d_nphot) / torch.where(has, nphot + d_nphot, 1.0), 1.0)
    return r2 * k, (tao + d_tao) * k[:, None], nphot + alpha * d_nphot


def estimate(tao, r2, valid, pixel, n_pixels: int, photons):
    """Radiance per pixel: the sum over its hit points of tao / (pi r2
    photons) (Raytracer.h:281-294), summed in float64."""
    scale = torch.where(valid, 1.0 / (math.pi * r2 * photons), 0.0)
    img = torch.zeros((n_pixels, 3), dtype=torch.float64, device=tao.device)
    img.index_add_(0, pixel[valid].long(), (tao * scale[:, None])[valid].double())
    return img.float()
