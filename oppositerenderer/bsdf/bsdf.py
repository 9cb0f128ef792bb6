"""Composite BSDF, vectorized over lanes.

Wavefront re-design of the reference's pbrt-style BSDF/VcmBSDF
(``renderer/BSDF.h:80-645``, ``renderer/BxDF.h``): instead of a byte-array of
up to two BxDFs with "fake virtual" dispatch macros, every lane carries dense
coefficients for all four BxDF kinds — Lambertian(kd), Phong(ks, exponent),
SpecularReflection(kr, fresnel), SpecularTransmission(kt, ior) — and all four
are evaluated branchlessly; absent components have zero coefficients and zero
pick probability. This removes all lane divergence and keeps
the math differentiable w.r.t. the coefficients.

Semantics follow VcmBSDF (albedo-weighted component picking, localDirFix
convention, forward+reverse pdfs, adjoint-aware transmission) with two
deliberate fixes, both documented against the reference:

* BSDF.h:528 ``sampleF`` scales other components' pdfs by the *sampled*
  component's pick probability (``_bxdfPickProb[index]``); we use each
  component's own pick probability so ``sample`` and ``pdf`` agree — required
  for consistent MIS.
* Phong sampling (BxDF.h:335-375) can return f>0 for directions below the
  shading horizon; we reject those (energy conservation).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from ..core import pytree as struct

from ..core.math import (Array, Frame, INV_PI, dot, local_reflect, luminance,
                         max3, normalize)
from ..core.sampling import (power_cos_hemisphere_pdf_w,
                             sample_power_cos_hemisphere)
from .fresnel import fresnel, fresnel_dielectric

EPS_COSINE = 1e-6   # reference config.h:42
EPS_PHONG = 1e-3    # reference BxDF.h:265

# component indices
LAMBERTIAN, PHONG, SPEC_REFL, SPEC_TRANS = 0, 1, 2, 3
N_COMPONENTS = 4


@struct.dataclass
class BSDF:
    """Per-lane composite BSDF bound to a hit point (VcmBSDF equivalent).

    All fields batched over leading dims. ``local_dir_fix`` is the stored
    incident direction in the shading frame ("fix" vs "gen", SmallVCM
    convention — BSDF.h:310-312).
    """

    frame: Frame            # shading frame
    ng: Array               # geometric normal [...,3]
    kd: Array               # [...,3] Lambertian reflectance
    ks: Array               # [...,3] Phong reflectance
    phong_exp: Array        # [...]
    kr: Array               # [...,3] specular reflection reflectance
    kt: Array               # [...,3] specular transmission transmittance
    ior: Array              # [...] eta_t (eta_i = 1) for fresnel/refraction
    kr_is_dielectric: Array  # [...] bool: kr fresnel dielectric vs no-op
    local_dir_fix: Array    # [...,3]

    # -- construction ------------------------------------------------------
    @classmethod
    def make(cls, shading_normal: Array, geometric_normal: Array,
             incident_dir_world: Array, kd: Array, ks: Array,
             phong_exp: Array, kr: Array, kt: Array, ior: Array,
             kr_is_dielectric: Array) -> "BSDF":
        """``incident_dir_world`` points away from the surface (toward the
        previous path vertex), like VcmBSDF's aIncidentDir."""
        frame = Frame.from_normal(shading_normal)
        return cls(frame=frame, ng=geometric_normal, kd=kd, ks=ks,
                   phong_exp=phong_exp, kr=kr, kt=kt, ior=ior,
                   kr_is_dielectric=kr_is_dielectric,
                   local_dir_fix=frame.to_local(incident_dir_world))

    # -- derived quantities ------------------------------------------------
    def is_valid(self) -> Array:
        """VcmBSDF::isValid — incident dir above shading horizon."""
        return self.local_dir_fix[..., 2] > EPS_COSINE

    def world_dir_fix(self) -> Array:
        return self.frame.to_world(self.local_dir_fix)

    def _fresnel_refl(self) -> Array:
        """Fresnel reflectance for the kr component at the fixed dir."""
        cos_fix = self.local_dir_fix[..., 2]
        return fresnel(cos_fix, jnp.ones_like(self.ior), self.ior,
                       self.kr_is_dielectric)

    def _fresnel_trans(self) -> Array:
        """(1-R) dielectric factor for the kt component."""
        cos_fix = self.local_dir_fix[..., 2]
        return 1.0 - fresnel_dielectric(cos_fix, jnp.ones_like(self.ior),
                                        self.ior)

    def pick_probs(self) -> Array:
        """Unnormalized component pick probabilities [...,4]
        (VcmBSDF::AddBxDF albedo = luminance, fresnel-scaled for speculars)."""
        r = self._fresnel_refl()
        t = self._fresnel_trans()
        return jnp.stack([
            luminance(self.kd),
            luminance(self.ks),
            r * luminance(self.kr),
            t * luminance(self.kt),
        ], axis=-1)

    def continuation_prob(self) -> Array:
        """RR continuation prob (VcmBSDF::AddBxDF accumulation, clamped 1).
        Detached: it is a sampling probability, not part of the integrand
        (detached-sampling differentiable rendering)."""
        r = self._fresnel_refl()
        has_kt = max3(self.kt) > 0.0
        total = (max3(self.kd) + max3(self.ks) + r * max3(self.kr)
                 + jnp.where(has_kt, self._fresnel_trans(), 0.0))
        return jax.lax.stop_gradient(jnp.minimum(1.0, total))

    def is_specular(self) -> Array:
        """True when only specular components are present (BSDF::isSpecular)."""
        return (luminance(self.kd) + luminance(self.ks)) <= 0.0

    def _matched_mask(self, world_dir_gen: Array) -> Array:
        """Side selection by geometric normal (BSDF.h:180-184): same side
        -> reflection components; opposite side -> transmission. [...,4]."""
        same = (dot(self.ng, world_dir_gen)
                * dot(self.ng, self.world_dir_fix())) >= 0.0
        return jnp.stack([same, same, same, ~same], axis=-1)

    # -- per-component math (local frame) ---------------------------------
    def _lambertian_f_pdf(self, local_gen: Array):
        """vcmF semantics (BxDF.h:247-262): zero unless both dirs above the
        shading horizon; reverse pdf swaps fix/gen cosines."""
        fix_z = self.local_dir_fix[..., 2]
        gen_z = local_gen[..., 2]
        ok = (fix_z >= EPS_COSINE) & (gen_z >= EPS_COSINE)
        f = jnp.where(ok[..., None], self.kd * INV_PI, 0.0)
        dpdf = jnp.where(ok, jnp.maximum(0.0, gen_z) * INV_PI, 0.0)
        rpdf = jnp.where(ok, jnp.maximum(0.0, fix_z) * INV_PI, 0.0)
        return f, dpdf, rpdf

    def _phong_f_pdf(self, local_gen: Array):
        """Modified Phong about the mirror of dir_fix (BxDF.h:283-333);
        direct and reverse pdfs coincide (BxDF.h:387-396)."""
        fix_z = self.local_dir_fix[..., 2]
        gen_z = local_gen[..., 2]
        refl = local_reflect(self.local_dir_fix)
        dot_r = dot(refl, local_gen)
        ok = ((fix_z >= EPS_COSINE) & (gen_z >= EPS_COSINE)
              & (dot_r > EPS_PHONG))
        rho = self.ks * ((self.phong_exp + 2.0) * 0.5 * INV_PI)[..., None]
        f = jnp.where(ok[..., None],
                      rho * jnp.power(jnp.maximum(dot_r, EPS_PHONG),
                                      self.phong_exp)[..., None], 0.0)
        pdf = jnp.where(ok, power_cos_hemisphere_pdf_w(refl, local_gen,
                                                       self.phong_exp), 0.0)
        return f, pdf, pdf

    # -- public evaluation -------------------------------------------------
    def f(self, world_dir_gen: Array):
        """VcmBSDF::vcmF (BSDF.h:577-639).

        Returns ``(f, cos_gen, direct_pdf_w, reverse_pdf_w)``; pdfs are
        pick-probability weighted over side-matched components.
        """
        local_gen = self.frame.to_local(world_dir_gen)
        matched = self._matched_mask(world_dir_gen)
        pick = self.pick_probs() * matched
        pick_sum = jnp.sum(pick, axis=-1)
        safe_sum = jnp.where(pick_sum > 0.0, pick_sum, 1.0)
        w = pick / safe_sum[..., None]

        f_l, d_l, r_l = self._lambertian_f_pdf(local_gen)
        f_p, d_p, r_p = self._phong_f_pdf(local_gen)

        ml = matched[..., LAMBERTIAN]
        mp = matched[..., PHONG]
        f = (jnp.where(ml[..., None], f_l, 0.0)
             + jnp.where(mp[..., None], f_p, 0.0))
        dpdf = w[..., LAMBERTIAN] * jnp.where(ml, d_l, 0.0) \
            + w[..., PHONG] * jnp.where(mp, d_p, 0.0)
        rpdf = w[..., LAMBERTIAN] * jnp.where(ml, r_l, 0.0) \
            + w[..., PHONG] * jnp.where(mp, r_p, 0.0)

        ok = pick_sum > 0.0
        f = jnp.where(ok[..., None], f, 0.0)
        cos_gen = local_gen[..., 2]
        # pdfs are sampling densities: detach so estimator gradients use the
        # detached-sampling form (they only enter weights and MIS terms)
        dpdf = jax.lax.stop_gradient(jnp.where(ok, dpdf, 0.0))
        rpdf = jax.lax.stop_gradient(jnp.where(ok, rpdf, 0.0))
        return f, cos_gen, dpdf, rpdf

    def pdf(self, world_dir_gen: Array, reverse: bool = False) -> Array:
        """VcmBSDF::pdf (BSDF.h:414-435)."""
        _, _, dpdf, rpdf = self.f(world_dir_gen)
        return rpdf if reverse else dpdf

    def sample(self, u3: Array, adjoint: bool = False):
        """VcmBSDF::vcmSampleF (BSDF.h:463-567): pick a component by albedo
        probability, sample it, combine pdfs/f over matched components.

        ``u3``: [...,3] uniforms. ``adjoint``: True on light subpaths
        (importance transport — flips the eta^2 factor in transmission).

        Returns :class:`SampleResult`.
        """
        fix = self.local_dir_fix
        fix_z = fix[..., 2]
        pick = self.pick_probs()           # sampling uses aSampleType=All
        pick_sum = jnp.sum(pick, axis=-1)
        safe_sum = jnp.where(pick_sum > 0.0, pick_sum, 1.0)
        cdf = jnp.cumsum(pick / safe_sum[..., None], axis=-1)
        u0 = u3[..., 0]
        idx = jnp.sum((u0[..., None] >= cdf[..., :-1]).astype(jnp.int32),
                      axis=-1)
        u2 = u3[..., 1:3]

        # --- candidate: Lambertian (cosine hemisphere, local frame) ------
        cos_l = jnp.sqrt(u2[..., 0])
        sin_l = jnp.sqrt(jnp.maximum(0.0, 1.0 - u2[..., 0]))
        phi_l = 2.0 * jnp.pi * u2[..., 1]
        dir_lamb = jnp.stack([sin_l * jnp.cos(phi_l), sin_l * jnp.sin(phi_l),
                              cos_l], axis=-1)

        # --- candidate: Phong lobe about localReflect(fix) ---------------
        lobe, _ = sample_power_cos_hemisphere(u2, self.phong_exp)
        refl_fix = local_reflect(fix)
        lobe_frame = Frame.from_normal(refl_fix)
        dir_phong = lobe_frame.to_world(lobe)

        # --- candidate: specular reflection ------------------------------
        dir_srefl = local_reflect(fix)
        r_refl = self._fresnel_refl()
        f_srefl = (r_refl[..., None] * self.kr
                   / jnp.maximum(jnp.abs(fix_z), EPS_COSINE)[..., None])

        # --- candidate: specular transmission (BxDF.h:524-571) -----------
        entering = fix_z > 0.0
        ei = jnp.where(entering, 1.0, self.ior)
        et = jnp.where(entering, self.ior, 1.0)
        eta = ei / et
        sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - fix_z * fix_z)
        tir = sin2_t >= 1.0
        cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
        cos_t = jnp.where(entering, -cos_t, cos_t)
        dir_strans = jnp.stack([-eta * fix[..., 0], -eta * fix[..., 1],
                                cos_t], axis=-1)
        t_frac = 1.0 - fresnel_dielectric(fix_z, jnp.ones_like(self.ior),
                                          self.ior)
        # Radiance transport compresses by eta^2 = (ei/et)^2; adjoint (light)
        # transport does not [Veach 5.2; BxDF.h:559-571].
        weight = t_frac if adjoint else t_frac * eta * eta
        f_strans = (weight[..., None] * self.kt
                    / jnp.maximum(jnp.abs(cos_t), EPS_COSINE)[..., None])
        f_strans = jnp.where(tir[..., None], 0.0, f_strans)

        # --- select sampled direction ------------------------------------
        local_gen = jnp.where(
            (idx == LAMBERTIAN)[..., None], dir_lamb,
            jnp.where((idx == PHONG)[..., None], dir_phong,
                      jnp.where((idx == SPEC_REFL)[..., None], dir_srefl,
                                dir_strans)))
        local_gen = normalize(local_gen)
        world_gen = self.frame.to_world(local_gen)
        is_spec = idx >= SPEC_REFL

        # --- combined pdf and f over matched components ------------------
        matched = self._matched_mask(world_gen)
        w = pick / safe_sum[..., None]

        f_l, d_l, _ = self._lambertian_f_pdf(local_gen)
        f_p, d_p, _ = self._phong_f_pdf(local_gen)

        sel_l = idx == LAMBERTIAN
        sel_p = idx == PHONG
        sel_sr = idx == SPEC_REFL
        sel_st = idx == SPEC_TRANS

        # specular picks: pdf = pick_w, f = precomputed dirac weight
        pdf = jnp.where(sel_sr, w[..., SPEC_REFL],
                        jnp.where(sel_st, w[..., SPEC_TRANS], 0.0))
        f = jnp.where(sel_sr[..., None], f_srefl, 0.0) \
            + jnp.where(sel_st[..., None], f_strans, 0.0)

        # non-specular picks: sum matched non-spec components (diffuse+phong)
        nonspec_pick = ~is_spec
        ml = matched[..., LAMBERTIAN] & nonspec_pick
        mp = matched[..., PHONG] & nonspec_pick
        pdf = pdf + jnp.where(ml, w[..., LAMBERTIAN] * d_l, 0.0) \
            + jnp.where(mp, w[..., PHONG] * d_p, 0.0)
        f = f + jnp.where(ml[..., None], f_l, 0.0) \
            + jnp.where(mp[..., None], f_p, 0.0)

        # rejections: zero total pick prob, sampled-component zero pdf
        comp_ok = jnp.where(
            sel_l, d_l > 0.0,
            jnp.where(sel_p, d_p > 0.0,
                      jnp.where(sel_st, ~tir, jnp.full_like(tir, True))))
        ok = (pick_sum > 0.0) & comp_ok & (pdf > 0.0)
        f = jnp.where(ok[..., None], f, 0.0)
        pdf = jax.lax.stop_gradient(jnp.where(ok, pdf, 0.0))
        cos_out = jnp.abs(local_gen[..., 2])
        return SampleResult(f=f, world_dir=world_gen, pdf_w=pdf,
                            cos_theta=cos_out, is_specular=is_spec, valid=ok)


class SampleResult(NamedTuple):
    f: Array            # [...,3] BSDF value (speculars pre-divided by |cos|)
    world_dir: Array    # [...,3] sampled direction
    pdf_w: Array        # [...] solid-angle pdf (x dirac weight for speculars)
    cos_theta: Array    # [...] |cos| of sampled dir to shading normal
    is_specular: Array  # [...] bool
    valid: Array        # [...] bool: sample accepted
