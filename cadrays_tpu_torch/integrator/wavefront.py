"""Wavefront path-tracing integrator (forward).

One statically sized batch of rays advances bounce by bounce; dead
lanes are masked, never compacted. Each bounce step does:

  trace (K1 closest-hit) -> medium absorption -> emission -> NEE
  (light sample + one fused any-hit shadow trace, K1 again) -> BSDF
  sample -> Russian roulette -> coherence sort of the wavefront.

Every random number is PCG4D of (pixel, sample id, dimension, seed), so
per-pixel results do not depend on lane order. Sample ids are int64
holding uint32 values (arithmetic on them wraps at 2**32, as the
reference's uint32 does).
"""
from __future__ import annotations

import torch

from cadrays_tpu_torch.core import rng as crng
from cadrays_tpu_torch.core import vecmath as vm
from cadrays_tpu_torch.core.bsdf import absorption_sigma, eval_bsdf, sample_bsdf
from cadrays_tpu_torch.core.camera import Camera
from cadrays_tpu_torch.core.lights import pack_lights, sample_light_rows
from cadrays_tpu_torch.integrator.params import RenderParams
from cadrays_tpu_torch.ops.hit import (build_shade_table, gather_rows,
                                       hit_attributes_packed)
from cadrays_tpu_torch.ops.intersect import INF, offset_ray_origin
from cadrays_tpu_torch.ops.texture import sample_texture
from cadrays_tpu_torch.ops.traverse import _coherence_key, trace
from cadrays_tpu_torch.scene.flatten import SceneData

# RNG dimension allocation per bounce (decorrelated streams)
_DIM_PIXEL = 0
_DIM_LENS = 1
_DIM_BSDF = 2
_DIM_NEE = 3
_DIM_RR = 4
_DIMS_PER_BOUNCE = 8
U32 = 0xFFFFFFFF


def _rng_dim(bounce, slot):
    return _DIMS_PER_BOUNCE * bounce + slot + 16  # 0..15 reserved for camera


def _check_supported(scene: SceneData) -> None:
    if scene.envmap.enabled:
        raise NotImplementedError(
            "environment-map lighting is not ported yet: ROADMAP item 11")
    if scene.emissive.count > 0:
        raise NotImplementedError(
            "emissive-triangle NEE is not ported yet: ROADMAP item 11")


def build_wavefront(scene: SceneData, camera: Camera, params: RenderParams,
                    width: int, height: int, sample_id, pixel_ids):
    """Initial wavefront state + the bounce function (state, bounce) ->
    (state, live-lane count). Shared by render_sample and the
    persistent renderer."""
    _check_supported(scene)
    dev = pixel_ids.device
    camera = camera.to(dev)
    R = pixel_ids.shape[0]
    seed = int(params.seed) & U32
    pixel_ids = pixel_ids.long()
    sample_id = int(sample_id) & U32

    px = (pixel_ids % width).to(torch.float32)
    py = (pixel_ids // width).to(torch.float32)
    jx, jy, ul0, ul1 = crng.sample4(pixel_ids, sample_id, _DIM_PIXEL, seed)
    origin, direction = camera.generate_rays(px + jx, py + jy, ul0, ul1,
                                             width, height)

    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    state = dict(
        origin=origin,
        direction=direction,
        throughput=torch.ones((R, 3), **f32),
        radiance=torch.zeros((R, 3), **f32),
        alive=torch.ones((R,), dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros((R,), **f32),
        prev_delta=torch.ones((R,), dtype=torch.bool, device=dev),
        sigma=torch.zeros((R, 3), **f32),
        pix=pixel_ids,
        lane=torch.arange(R, **i64),
        sid=torch.full((R,), sample_id, **i64),
        bdepth=torch.zeros((R,), **i64),
        done_sum=torch.zeros((R, 3), **f32),
        done_cnt=torch.zeros((R,), **i64),
    )

    n_lights = scene.lights.count
    geom = scene.geometry
    shade_tab = build_shade_table(geom, scene.materials)
    light_tab = pack_lights(scene.lights) if n_lights > 0 else None
    background = torch.tensor(params.background_color, **f32)

    def rng4(pix, sid, bounce, slot):
        pid = torch.zeros_like(pix) if params.coherent else pix
        return crng.sample4(pid, sid, _rng_dim(bounce, slot), seed)

    def bounce_step(state, bounce: int):
        o = state["origin"].contiguous()
        d = state["direction"].contiguous()
        alive0 = state["alive"]
        bd0 = state["bdepth"] == 0  # first bounce of this lane's sample
        # dead lanes trace with t_max = 0 and report a miss
        res = trace(geom, o, d, torch.where(alive0, INF, 0.0))
        h, mat = hit_attributes_packed(geom, shade_tab, o, d, res["tri"])
        hit = h["hit"] & alive0
        miss = (~h["hit"]) & alive0
        if not params.two_sided:
            hit = hit & (h["front"] | (vm.luminance(mat.kt) > 0.0))

        # Beer-Lambert absorption through the current medium
        seg = torch.where(h["hit"], h["t"], 0.0)
        transmittance = torch.exp(-state["sigma"] * seg[..., None])
        throughput = state["throughput"] * transmittance
        radiance = state["radiance"]

        bg = torch.where(bd0 & miss, 1.0, 0.0)
        radiance = radiance + bg[..., None] * background

        tex = sample_texture(scene.textures, mat.tex_id, h["uv"], mat.uv_scale)
        ks_tex = sample_texture(scene.textures, mat.ks_tex_id, h["uv"],
                                mat.uv_scale)
        mat = mat.replace(kd=mat.kd * tex, ks=mat.ks * ks_tex)

        n = h["n_shade"]
        wo = -d

        le = mat.le
        emitting = vm.luminance(le) > 0.0
        emit_mask = hit & emitting & h["front"]  # one-sided emitters
        radiance = radiance + torch.where(emit_mask[..., None],
                                          throughput * le, 0.0)

        # ---- next-event estimation: one fused any-hit shadow trace ----
        if n_lights > 0:
            u = rng4(state["pix"], state["sid"], bounce, _DIM_NEE)
            if n_lights == 1:
                lrows = light_tab[0].expand(R, light_tab.shape[1])
            else:
                lsel = torch.clamp((u[0] * n_lights).to(torch.int64),
                                   max=n_lights - 1)
                lrows = gather_rows(light_tab, lsel)
            ls = sample_light_rows(lrows, h["position"], u[1], u[2])
            f, _ = eval_bsdf(mat, wo, ls["wi"], n)
            cos_i = torch.clamp(vm.dot(ls["wi"], n), 0.0, 1.0)
            vis_need = hit & ls["valid"] & (cos_i > 0.0)
            contrib = ls["contrib"] * f * (cos_i * n_lights)[..., None]
            # positional-light shadow rays run from the light toward the
            # surface (occlusion is symmetric; a shared origin is coherent)
            rev = (ls["dist"] < 1e29)[..., None]
            lpt = h["position"] + ls["wi"] * ls["dist"][..., None]
            o_sh = torch.where(rev, lpt, offset_ray_origin(
                h["position"], h["n_geom"], ls["wi"]))
            d_sh = torch.where(rev, -ls["wi"], ls["wi"])
            tm_sh = torch.where(vis_need, ls["dist"] * (1.0 - 1e-4), 0.0)
            occ = trace(geom, o_sh.contiguous(), d_sh.contiguous(), tm_sh,
                        any_hit=True)["tri"] >= 0
            nee = torch.where((vis_need & ~occ)[..., None], contrib, 0.0)
            radiance = radiance + throughput * nee

        # ---- BSDF sampling --------------------------------------------
        u = torch.stack(rng4(state["pix"], state["sid"], bounce, _DIM_BSDF),
                        dim=-1)
        bs = sample_bsdf(mat, wo, n, u, front=h["front"])
        new_dir = bs["wi"]
        new_origin = offset_ray_origin(h["position"], h["n_geom"], new_dir)
        throughput_next = throughput * bs["weight"]

        sig_mat = absorption_sigma(mat)
        entering = bs["transmitted"] & h["front"]
        exiting = bs["transmitted"] & (~h["front"])
        sigma = state["sigma"]
        sigma = torch.where(entering[..., None], sig_mat, sigma)
        sigma = torch.where(exiting[..., None], 0.0, sigma)

        alive = hit & bs["valid"] & (vm.luminance(throughput_next) > 0.0)

        # Russian roulette (unbiased)
        ur = rng4(state["pix"], state["sid"], bounce, _DIM_RR)[0]
        p_sur = torch.clamp(throughput_next.amax(dim=-1), 0.05, 0.95)
        do_rr = state["bdepth"] >= params.rr_start
        survive = torch.where(do_rr, ur < p_sur, True)
        throughput_next = torch.where((do_rr & survive)[..., None],
                                      throughput_next / p_sur[..., None],
                                      throughput_next)
        alive = alive & survive
        # per-lane depth cutoff: the sample ends after ray_depth bounces
        alive = alive & (state["bdepth"] + 1 < params.ray_depth)

        new_state = dict(
            origin=new_origin,
            direction=new_dir,
            throughput=torch.where(alive[..., None], throughput_next, 0.0),
            radiance=radiance,
            alive=alive,
            prev_pdf=bs["pdf"],
            prev_delta=bs["is_delta"],
            sigma=sigma,
            pix=state["pix"],
            lane=state["lane"],
            sid=state["sid"],
            bdepth=state["bdepth"] + 1,
            done_sum=state["done_sum"],
            done_cnt=state["done_cnt"],
        )
        if params.sort_rays and bounce % max(params.sort_every, 1) == 0:
            # one permutation of the packed state: live lanes sorted by
            # (octant, origin Morton cell), dead lanes to the tail
            key = _coherence_key(geom, new_state["origin"],
                                 new_state["direction"])
            key = torch.where(new_state["alive"], key, 1 << 30)
            perm = torch.argsort(key, stable=True)
            new_state = _unpack_state(_pack_state(new_state)[perm])
        return new_state, alive0.sum()

    return state, bounce_step


def render_sample(scene: SceneData, camera: Camera, params: RenderParams,
                  width: int, height: int, sample_id, pixel_ids=None,
                  return_stats: bool = False):
    """Trace one sample per pixel; returns (R, 3) linear radiance in
    pixel_ids order (default: all H*W pixels in scanline order)."""
    dev = scene.device
    with torch.no_grad():
        if pixel_ids is None:
            pixel_ids = torch.arange(width * height, device=dev)
        state, bounce_fn = build_wavefront(scene, camera, params, width,
                                           height, sample_id, pixel_ids)
        n_alive = []
        for b in range(params.ray_depth):
            state, na = bounce_fn(state, b)
            n_alive.append(na)

        radiance = state["radiance"]
        if params.sort_rays:
            radiance = torch.zeros_like(radiance).index_copy(
                0, state["lane"], radiance)
        radiance = clamp_radiance(radiance, params.radiance_clamp)
        radiance = torch.nan_to_num(radiance, nan=0.0, posinf=0.0,
                                    neginf=0.0)
    if return_stats:
        return radiance, n_alive
    return radiance


def clamp_radiance(rad, radiance_clamp: float):
    """Bound a sample's contribution (peak channel <= clamp, clamp >= 1)."""
    clamp = max(float(radiance_clamp), 1.0)
    peak = rad.amax(dim=-1, keepdim=True)
    return rad * torch.where(peak > clamp,
                             clamp / torch.clamp(peak, min=1e-12), 1.0)


def _bits(x):
    return x.to(torch.int32).view(torch.float32)[:, None]


def _pack_state(s):
    """Wavefront state dict -> one (R, 26) f32 matrix (ints and bools
    encoded losslessly) so a lane permutation is one row gather."""
    return torch.cat([
        s["origin"], s["direction"], s["throughput"], s["radiance"],
        s["sigma"], s["prev_pdf"][:, None],
        s["alive"].to(torch.float32)[:, None],
        s["prev_delta"].to(torch.float32)[:, None],
        _bits(s["pix"]), _bits(s["lane"]), _bits(s["sid"]),
        _bits(s["bdepth"]), s["done_sum"], _bits(s["done_cnt"]),
    ], dim=1)


def _unpack_state(m):
    def bi(c):
        return m[:, c].contiguous().view(torch.int32).to(torch.int64)

    return dict(
        origin=m[:, 0:3], direction=m[:, 3:6], throughput=m[:, 6:9],
        radiance=m[:, 9:12], sigma=m[:, 12:15], prev_pdf=m[:, 15],
        alive=m[:, 16] > 0.5, prev_delta=m[:, 17] > 0.5,
        pix=bi(18), lane=bi(19), sid=bi(20) & U32, bdepth=bi(21),
        done_sum=m[:, 22:25], done_cnt=bi(25),
    )
