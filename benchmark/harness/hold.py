"""Hold a replayed render pass to the plain reference, stage by stage.

The photon and eye walks are chaotic: one float32 operation rounded another
way moves a hit by an ulp, and a few bounces later a path takes another
decision.  So the reference does not run a pass free beside the program.
It follows the program step by step from the program's own state: every
eye segment, photon segment, deposit, radius update and the estimate of the
replayed pass is recomputed by the reference from the inputs the program
handed that stage, and the two outputs are compared.  What the program does
between those stages (the camera, gathering the eye's hit points, the
stage and round hand-overs, the deposit layout) is checked on its own as
identities that must hold exactly.

The replay runs the very pass function the window timed, on the pass's own
random source, and its image must equal the window's image of that pass bit
for bit (the pass is deterministic), so what is held is what the window
produced.

``subject="control"`` puts the reference computed in TF32 in the program's
place at every stage (the program still drives the states), to show that
the comparison fails one computed a precision lower.
"""

from __future__ import annotations

import contextlib
import inspect
import math

import torch

from ..reference import render_ref as ref

# Lane tolerances of the walks.  Hit positions relative to |origin| + t:
# sphere roots lose digits at grazing incidence, and the Newton kernel
# contracts multiply-adds that the reference rounds twice.
POS_RTOL = 3e-5
NORMAL_ATOL = 2e-3
DIR_ATOL = 2e-3
COLOR_RTOL = 2e-3
# Hits beyond FAR_FIELD lie outside the room (its planes are unbounded):
# grazing angles magnify a last-bit difference in the direction.
FAR_FIELD = 1e3
FAR_POS_RTOL = 1e-3
FAR_COLOR_RTOL = 5e-2
# Hits within SELF_HIT of the origin: Newton accepts a root once its
# residual^2 is below 1e-4, so both sides' roots are good to 1e-2 there.
SELF_HIT = 0.1
SELF_POS_ATOL = 1e-2
SELF_NORMAL_ATOL = 5e-2
SELF_COLOR_RTOL = 0.5
# A deposit's flux sums a hit point's photons in another order.
FLUX_RTOL = 1e-4


def _mx(x):
    return x.abs().amax(-1) if x.dim() > 1 else x.abs()


def _norm(x):
    return torch.sqrt(ref.dot(x, x))


def _rel(got, want):
    return _mx(got - want) / torch.clamp_min(_mx(want), 1e-30)


def _not_le(err, tol):
    """err > tol, with NaN counted as beyond."""
    return ~(err <= tol)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(a, b))


def _hit_lanes(origin, g_pos, w_pos, g_n, w_n, live):
    """Per lane: (bad position or normal, near, far) of the live lanes."""
    t_w, t_g = _norm(w_pos - origin), _norm(g_pos - origin)
    near = torch.minimum(t_w, t_g) < SELF_HIT
    far = _mx(w_pos) > FAR_FIELD
    scale = _norm(origin) + t_w
    pos_tol = torch.where(near, SELF_POS_ATOL / scale,
                          torch.where(far, FAR_POS_RTOL, POS_RTOL))
    n_tol = torch.where(near, SELF_NORMAL_ATOL, NORMAL_ATOL)
    bad = _not_le(_mx(g_pos - w_pos) / scale, pos_tol) | _not_le(_mx(g_n - w_n), n_tol)
    return bad & live, near, far


def _colour_tol(near, far):
    return torch.where(far, FAR_COLOR_RTOL, torch.where(near, SELF_COLOR_RTOL, COLOR_RTOL))


def eye_mismatch(lanes_in, got, want):
    """(lanes that differ, lanes compared) of one eye segment."""
    (g_l, g_drop, g_rows), (w_l, w_drop, w_rows) = got, want
    g_valid, w_valid = g_rows[:, 10] > 0.5, w_rows[:, 10] > 0.5
    live = g_valid | w_valid | g_l[4] | w_l[4]
    dec = ((g_valid != w_valid) | (g_l[4] != w_l[4]) | (g_l[3] != w_l[3])
           | (g_rows[:, 9] != w_rows[:, 9]))
    bad, near, far = _hit_lanes(lanes_in[0], g_rows[:, 0:3], w_rows[:, 0:3],
                                g_rows[:, 3:6], w_rows[:, 3:6], live)
    ctol = _colour_tol(near, far)
    dtol = torch.where(near, SELF_NORMAL_ATOL, DIR_ATOL)
    bad |= w_valid & _not_le(_rel(g_rows[:, 6:9], w_rows[:, 6:9]), ctol)
    bad |= w_l[4] & (_not_le(_mx(g_l[1] - w_l[1]), dtol) | _not_le(_rel(g_l[2], w_l[2]), ctol))
    bad |= dec
    if not bool(torch.equal(g_drop, w_drop)):
        bad |= live
    return int(bad.sum()), int(live.sum())


def photon_mismatch(carry_in, light_pos, got, want):
    """(lanes that differ, lanes compared) of one photon segment."""
    (g_c, g_rec), (w_c, w_rec) = got, want
    o, _, _, alive, _, rr_off, _ = carry_in
    need = ~alive
    rank = torch.clamp_min(torch.cumsum(need.to(torch.int64), 0) - 1, 0)
    lid = (rr_off.to(torch.int64) + rank) % light_pos.shape[0]
    origin = torch.where(need[:, None], light_pos[lid], o)
    live = g_rec[3] | w_rec[3] | g_c[3] | w_c[3]
    dec = (g_rec[3] != w_rec[3]) | (g_c[3] != w_c[3]) | (g_c[4] != w_c[4])
    bad, near, far = _hit_lanes(origin, g_rec[0], w_rec[0], g_rec[1], w_rec[1], live)
    ctol = _colour_tol(near, far)
    dtol = torch.where(near, SELF_NORMAL_ATOL, DIR_ATOL)
    bad |= w_c[3] & (_not_le(_mx(g_c[1] - w_c[1]), dtol) | _not_le(_rel(g_c[2], w_c[2]), ctol))
    bad |= w_rec[3] & _not_le(_rel(g_rec[2], w_rec[2]), COLOR_RTOL)
    bad |= dec
    if not (bool(torch.equal(g_c[5], w_c[5])) and bool(torch.equal(g_c[6], w_c[6]))):
        bad |= live
    return int(bad.sum()), int(live.sum())


class Hold:
    """One held replay: patch the program's stage functions (``patched``),
    run the pass, ``finish``, then read the counters (``lanes``, ``slots``,
    ``update_err``, ``estimate_err``, ``faults``) and the kernels' ``work``.

    ``sc``: the reference's scene (``inputs.on_device``); ``cfg``: the
    configuration's settings; ``deposit_fn``: the program's deposit object
    the pass was built with; ``draws``: the replay's ``RecordingDraws``;
    ``pose``: the camera's (position, look-at) tensors.
    """

    def __init__(self, sc: dict, cfg: dict, deposit_fn, draws, pose, subject: str = "program"):
        if subject not in ("program", "control"):
            raise ValueError(f"unknown subject {subject!r}")
        self.sc, self.cfg, self.deposit_fn, self.draws = sc, cfg, deposit_fn, draws
        self.pose = pose
        self.subject = subject
        self.iters, self.restarts = cfg["newton_iters"], cfg["newton_restarts"]
        self.segs = cfg["max_depth"] + 1
        self.lanes = [0, 0]          # walk lanes that differ, compared
        self.slots = [0, 0]          # deposit slots that differ, compared
        self.update_err = 0.0
        self.estimate_err = 0.0
        self.faults: list[str] = []
        self.work = {"newton": [], "deposit": []}
        self.calls = {"eye": 0, "photon": 0, "deposit": 0, "update": 0, "estimate": 0}
        self._eye_prev = None
        self._eye_rows = []
        self._eye_drops = 0
        self._hp = None
        self._carry = None
        self._records = []
        self._slot_valid = None
        self._wgt_pad = None
        self._state = None
        self._last_dep = None
        self._emitted = 0.0

    # -- helpers ---------------------------------------------------------------
    def fault(self, what: str) -> None:
        self.faults.append(what)

    def _ref(self, fn):
        """The reference stage, and the stage that stands in for the
        program under ``subject="control"``."""
        return fn, (ref.in_precision(fn, "tf32") if self.subject == "control" else None)

    def _observe(self, ray, patch):
        """The Newton kernel's work on a reference intersection's inputs:
        the (ray, patch) pairs whose box the ray meets, and their rays."""
        self.work["newton"].append((int(ray.numel()), int(torch.unique(ray).numel()),
                                    self.sc["ctrl"].shape[0]))

    # -- the stages --------------------------------------------------------------
    def eye_segment(self, real):
        sig = inspect.signature(real)

        def held(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            lanes = a["lanes"]
            out = real(*args, **kw)
            self.calls["eye"] += 1
            drawn = self.draws.take()
            if self._eye_prev is None:
                self._camera(lanes, drawn)
            else:
                self._eye_handover(self._eye_prev, lanes)
                if drawn:
                    self.fault("an eye segment drew uniforms")
            fn, ctl = self._ref(ref.eye_segment)
            want = fn(self.sc, lanes, self.iters, self.restarts, self._observe)
            got = out if ctl is None else ctl(self.sc, lanes, self.iters, self.restarts)
            bad, n = eye_mismatch(lanes, got, want)
            self.lanes[0] += bad
            self.lanes[1] += n
            self._eye_prev = out[0]
            self._eye_rows.append(out[2])
            self._eye_drops += int(out[1])
            return out
        return held

    def _camera(self, lanes, drawn):
        if len(drawn) != 2:
            self.fault(f"the camera drew {len(drawn)} arrays, not (z, phi)")
            return
        c = self.cfg
        fn, ctl = self._ref(lambda p, l, z, phi: ref.camera_rays(
            p, l, c["jitter"], c["width"], c["height"], z, phi))
        want = fn(*self.pose, *drawn)
        got = (lanes[0], lanes[1]) if ctl is None else ctl(*self.pose, *drawn)
        bad = (_not_le(_mx(got[0] - want[0]) / torch.clamp_min(_norm(want[0]), 1.0), POS_RTOL)
               | _not_le(_mx(got[1] - want[1]), DIR_ATOL))
        self.lanes[0] += int(bad.sum())
        self.lanes[1] += bad.numel()
        if self.subject == "program" and not (bool(lanes[4].all()) and bool(torch.equal(
                lanes[3].long(), torch.arange(lanes[3].numel(), device=lanes[3].device)))):
            self.fault("the first eye segment is not every pixel's camera ray")

    def _eye_handover(self, prev, cur):
        """The next segment's lanes are the previous ones, or the first of
        their active lanes, in order, gathered into a narrower buffer; the
        active lanes beyond its width are dropped (and must be counted)."""
        if prev[0].shape == cur[0].shape:
            if not _same(prev, cur):
                self.fault("eye lanes changed between segments")
            return
        pa, ca = prev[4], cur[4]
        n_prev, n_cur = int(pa.sum()), int(ca.sum())
        width = cur[0].shape[0]
        if n_cur != min(n_prev, width) or not all(
                torch.equal(p[pa][:n_cur], c[ca]) for p, c in zip(prev[:4], cur[:4])):
            self.fault("the eye compaction lost or changed lanes")
        self._eye_drops += max(n_prev - width, 0)

    def eye_pass(self, real):
        def held(*args, **kw):
            hp, stats = real(*args, **kw)
            rows = torch.cat(self._eye_rows, 0)
            rows = rows[rows[:, 10] > 0.5]
            cap = hp.valid.shape[0]
            drops = self._eye_drops + max(rows.shape[0] - cap, 0)
            if int(stats["dropped"]) != drops:
                self.fault(f"the eye counted {int(stats['dropped'])} rays dropped, not {drops}")
            rows = rows[:cap]
            n = rows.shape[0]
            v = hp.valid
            ok = (int(v.sum()) == n and bool(v[:n].all()) and int(stats["count"]) == n
                  and torch.equal(hp.pos[:n], rows[:, 0:3]) and torch.equal(hp.n[:n], rows[:, 3:6])
                  and torch.equal(hp.wgt[:n], rows[:, 6:9])
                  and torch.equal(hp.pixel[:n], rows[:, 9].to(torch.int32))
                  and bool((hp.r2[v] == self.cfg["init_r2"]).all())
                  and bool((hp.nphot[v] == 0).all()) and bool((hp.tao[v] == 0).all()))
            if not ok:
                self.fault("the hit points are not the eye segments' diffuse rows")
            self._hp = hp
            return hp, stats
        return held

    def photon_segment(self, real):
        sig = inspect.signature(real)

        def held(*args, **kw):
            a = sig.bind(*args, **kw).arguments
            carry = a["carry"]
            out = real(*args, **kw)
            self.calls["photon"] += 1
            drawn = self.draws.take()
            if self._carry is None:
                N = carry[0].shape[0]
                cold = (torch.zeros_like(carry[0]), torch.ones_like(carry[1]),
                        torch.zeros_like(carry[2]), torch.zeros_like(carry[3]),
                        torch.zeros_like(carry[4]), torch.zeros_like(carry[5]),
                        torch.zeros_like(carry[6]))
                if N != self.cfg["photons_per_round"] * self.sc["light_pos"].shape[0] or \
                        not _same(carry, cold):
                    self.fault("the photon walk did not start cold")
            else:
                first = (self.calls["photon"] - 1) % self.segs == 0
                emitted = torch.zeros_like(carry[6]) if first else self._carry[6]
                if not (_same(carry[:6], self._carry[:6]) and _same(carry[6], emitted)):
                    self.fault("photon lanes changed between segments")
            if len(drawn) != 5:
                self.fault(f"a photon segment drew {len(drawn)} arrays, not 5")
                return out
            fn, ctl = self._ref(ref.photon_segment)
            want = fn(self.sc, carry, drawn, self.segs, self.iters, self.restarts, self._observe)
            got = out if ctl is None else ctl(self.sc, carry, drawn, self.segs, self.iters,
                                              self.restarts)
            bad, n = photon_mismatch(carry, self.sc["light_pos"], got, want)
            self.lanes[0] += bad
            self.lanes[1] += n
            self._carry = out[0]
            self._records.append(out[1])
            if self.calls["photon"] % self.segs == 0:
                self._emitted = self._emitted + out[0][6]
            return out
        return held

    def unheld(self, name: str):
        def held(*args, **kw):
            self.fault(f"{name} ran, which this check does not hold")
            raise RuntimeError(f"{name} is not held by the render check")
        return held

    def packed_call(self, real):
        def held(r2_pad, dep, prep):
            out = real(r2_pad, dep, prep)
            self.calls["deposit"] += 1
            recs = [torch.cat(x, 0) for x in zip(*self._records)]
            self._records = []
            if not (len(recs) == 4 and _same((dep.pos, dep.n, dep.flux, dep.valid), tuple(recs))):
                self.fault("a round's deposits are not its segments' records")
            hp = self._hp
            if self._slot_valid is None:
                v = hp.valid
                slot = torch.zeros_like(r2_pad, dtype=torch.bool)
                slot[prep.g[v]] = True
                self._slot_valid = slot
                self._wgt_pad = torch.zeros((r2_pad.shape[0], 3), dtype=hp.wgt.dtype,
                                            device=hp.wgt.device)
                self._wgt_pad[prep.g] = hp.wgt
                if not (torch.equal(prep.packed[prep.g[v], 0:3], hp.pos[v])
                        and torch.equal(prep.packed[prep.g[v], 3:6], hp.n[v])
                        and torch.equal(r2_pad[prep.g[v]], hp.r2[v])
                        and bool((r2_pad[~slot] <= 0).all())):
                    self.fault("the deposit layout does not hold the hit points")
                self._state = (r2_pad, torch.zeros_like(self._wgt_pad),
                               torch.zeros_like(r2_pad))
            elif not torch.equal(r2_pad, self._state[0]):
                self.fault("the deposit saw other radii than the last update's")
            slot = self._slot_valid
            pos, n = prep.packed[:, 0:3], prep.packed[:, 3:6]
            fn, ctl = self._ref(ref.deposit)
            cnt_w, raw_w, inside = fn(pos, n, r2_pad, dep.pos, dep.n, dep.flux, dep.valid)
            cnt_g, raw_g = (out[0], out[1]) if ctl is None else ctl(
                pos, n, r2_pad, dep.pos, dep.n, dep.flux, dep.valid)[:2]
            bad = slot & ((cnt_g != cnt_w) | _not_le(_rel(raw_g, raw_w), FLUX_RTOL))
            self.slots[0] += int(bad.sum())
            self.slots[1] += int(slot.sum())
            n_slots = int(slot.sum())
            n_dep = dep.valid.shape[0]
            self.work["deposit"].append((inside, n_slots, n_dep))
            self._last_dep = (out[0], out[1])
            return out
        return held

    def update(self, real):
        def held(r2, tao, nphot, d_nphot, d_tao, *rest, **kw):
            out = real(r2, tao, nphot, d_nphot, d_tao, *rest, **kw)
            self.calls["update"] += 1
            slot = self._slot_valid
            if self._last_dep is None or slot is None:
                self.fault("an update ran before a deposit")
                return out
            s_r2, s_tao, s_n = self._state
            if not (torch.equal(r2, s_r2) and torch.equal(tao[slot], s_tao[slot])
                    and torch.equal(nphot[slot], s_n[slot])
                    and torch.equal(d_nphot, self._last_dep[0])):
                self.fault("an update did not start from the last state and deposit")
            fn, ctl = self._ref(lambda r, t, n, dn, raw, w: (
                w * raw / math.pi, *ref.ppm_update(r, t, n, dn, w * raw / math.pi)))
            want = fn(r2, tao, nphot, d_nphot, self._last_dep[1], self._wgt_pad)
            got = (d_tao, *out) if ctl is None else ctl(
                r2, tao, nphot, d_nphot, self._last_dep[1], self._wgt_pad)
            for g, w in zip(got, want):
                err = (g[slot] - w[slot]).abs() / torch.clamp_min(w[slot].abs(), 1e-30)
                self.update_err = max(self.update_err, float(err.max()) if err.numel() else 0.0)
            self._state = out
            return out
        return held

    def estimate(self, real):
        def held(hp, n_pixels, total):
            img = real(hp, n_pixels, total)
            self.calls["estimate"] += 1
            e, v = self._hp, hp.valid
            ok = (e is not None and torch.equal(v, e.valid) and torch.equal(hp.pos, e.pos)
                  and torch.equal(hp.n, e.n) and torch.equal(hp.wgt, e.wgt)
                  and torch.equal(hp.pixel, e.pixel))
            if ok and self._state is not None:
                g = self.deposit_fn_prep_g
                r2, tao, nph = self._state
                ok = (torch.equal(hp.r2[v], r2[g][v]) and torch.equal(hp.tao[v], tao[g][v])
                      and torch.equal(hp.nphot[v], nph[g][v]))
            if ok and self._carry is not None:
                ok = bool(torch.equal(torch.as_tensor(total), self._emitted.mean()))
            if not ok:
                self.fault("the estimate did not read the last state")
            fn, ctl = self._ref(ref.estimate)
            want = fn(hp.tao, hp.r2, hp.valid, hp.pixel, n_pixels, total)
            got = img if ctl is None else ctl(hp.tao, hp.r2, hp.valid, hp.pixel, n_pixels, total)
            floor = 1e-6 * float(want.abs().max()) if want.numel() else 0.0
            err = _mx(got - want) / torch.clamp_min(_mx(want), max(floor, 1e-30))
            self.estimate_err = max(self.estimate_err, float(err.max()) if err.numel() else 0.0)
            return img
        return held

    # -- patching ----------------------------------------------------------------
    @contextlib.contextmanager
    def patched(self):
        """Within the block the program's stage functions are held."""
        from raytrace3_tpu_torch.render import eye, photon, sppm

        fn = self.deposit_fn
        real_prepare = fn.prepare

        def prepare(hp):
            prep = real_prepare(hp)
            self.deposit_fn_prep_g = prep.g
            return prep

        swaps = [(eye, "eye_segment", self.eye_segment(eye.eye_segment)),
                 (sppm, "eye_pass", self.eye_pass(sppm.eye_pass)),
                 (photon, "regen_segment", self.photon_segment(photon.regen_segment)),
                 (photon, "static_segment", self.unheld("the static photon walk")),
                 (sppm, "ppm_update_arrays", self.update(sppm.ppm_update_arrays)),
                 (sppm, "estimate_image", self.estimate(sppm.estimate_image))]
        saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, f in swaps:
            setattr(m, n, f)
        fn.packed_call = self.packed_call(type(fn).packed_call.__get__(fn))
        fn.prepare = prepare
        try:
            yield self
        finally:
            for m, n, f in saved:
                setattr(m, n, f)
            del fn.packed_call
            del fn.prepare

    def finish(self, rounds: int) -> None:
        """Check that every stage of the pass ran as often as the
        configuration says."""
        want = {"eye": self.segs, "photon": rounds * self.segs, "deposit": rounds,
                "update": rounds, "estimate": 1}
        for k, n in want.items():
            if self.calls[k] != n:
                self.fault(f"{self.calls[k]} {k} calls, not {n}")
