"""Instanced-patch renderers: device instancer -> conditioned MLP ->
composite (counterpart of nerftex_tpu/render/instance_renderer.py, sorted
and dense grid paths): InstanceRenderer and its mip variant,
MipInstanceRenderer."""

import torch

from nerftex_torch.ops import volume
from nerftex_torch.render.renderer import Renderer, chunked_apply
from nerftex_torch.utils import jax_rng
from nerftex_torch.utils.util import instantiate


class InstanceRenderer(Renderer):
    """Eval-only renderer marching rays through instanced patch volumes.
    With ``blur_idx`` the parameter slot of that index is scaled per sample
    by cone_scale * t / patch_scale, the ray's footprint at the sample in
    patch units (the filtered configs' blur conditioning)."""

    def __init__(
        self,
        instancer_config=None,
        step_size: float = 0.002,
        density_scale: float = 1,
        density_reweighting: bool = True,
        false_color: bool = False,
        sample_budget_per_ray: int = 0,
        sorted_blocks: bool = True,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        if self.raw_noise_std:
            raise NotImplementedError("raw_noise_std > 0 on InstanceRenderer is not ported (no "
                                      "shipped render config sets it; ROADMAP Queue 1)")
        if false_color:
            raise NotImplementedError("false_color comes with the compact-path slice")
        if sample_budget_per_ray > 0:
            raise NotImplementedError("sample_budget_per_ray > 0 (the compact path) comes "
                                      "with the compact-path slice")
        if isinstance(instancer_config, dict):
            self.instancer = instantiate(instancer_config, device=self.device)
            self.patch_scale = instancer_config["patch_scale"]
        else:
            # A pre-built Instancer (tests, embedding).
            self.instancer = instancer_config
            self.patch_scale = float(self.instancer.scene.patch_scale)
        self.step_size = step_size
        self.density_scale = density_scale
        self.density_reweighting = density_reweighting
        self.sorted_blocks = sorted_blocks

    def render_rays(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd,
                    bkgd_color, key, training: bool = False) -> dict:
        if training:
            raise ValueError("network.renderer.InstanceRenderer can only be used for evaluation")
        dev_inst = self.instancer.device_instancer
        # The instancer's key, as the JAX renderer splits it off.
        k_inst = jax_rng.split(key)[0]
        if self.sorted_blocks:
            def shade_block(inst_block, extra_block):
                (cone_block,) = extra_block
                return self._shade(inst_block, cone_block)

            def empty_block(ray_block, extra_block):
                # Zero marching steps: every sample alpha is exactly 0 (the
                # +1e-10 cumprod guard rounds to 1.0f), so the composite
                # reduces to the terminator term alpha_last * color_last.
                color = ray_block["alpha_last"] * ray_block["color_last"][:, 0, :]
                return color, ray_block["alpha_last"][:, 0]

            (color_map, alpha_map), inst = dev_inst.render_grid_sorted(
                rays_o, rays_d, parameters, self.n_samples, self.step_size, shade_block,
                extra=(cone_scale,), empty_block=empty_block, key=k_inst,
            )
        else:
            inst = dev_inst.get_model_input(rays_o, rays_d, parameters, self.n_samples,
                                            self.step_size, key=k_inst)
            color_map, alpha_map = self._shade(inst, cone_scale)

        # Rays culled by the proxy (t = inf) contribute nothing; instancer
        # misses already have zero weights.
        miss = torch.isinf(t[:, 0]) | ~inst["hit"]
        valid = (~miss).float()
        color_map = color_map * valid[:, None]
        alpha_map = alpha_map * valid
        if composite_bkgd:
            bkgd = torch.as_tensor(bkgd_color, dtype=torch.float32, device=color_map.device)
            color_map = color_map + (1.0 - alpha_map)[:, None] * bkgd
        return {
            "color_pred": color_map,
            "alpha_pred": alpha_map,
            "_overflow_hits": inst["overflow_hits"],
            "_overflow_steps": inst["overflow_steps"],
        }

    def _report_diagnostics(self, out: dict) -> None:
        # Never drop anything silently (instancer.cpp:1036's buffer warning).
        hits = out.pop("_overflow_hits", 0)
        steps = out.pop("_overflow_steps", 0)
        if hits:
            print(f"WARNING: hit capacity exceeded, dropped {hits} farthest "
                  f"ray-instance intervals (raise max_hits).")
        if steps:
            print(f"WARNING: sample capacity exceeded, dropped {steps} deepest "
                  f"samples (raise n_samples / max_steps_per_ray).")

    def _eval_mlp(self, pos, dirs, prms, mask):
        """The MLP on the valid samples only (mask [R,S]); invalid slots
        get color logits and density 0, as the JAX path's masking does."""
        r, s = mask.shape
        color = pos.new_zeros(r, s, 3)
        density = pos.new_zeros(r, s)
        c, d = chunked_apply(self.model.infer, (pos[mask], dirs[mask], prms[mask]),
                             self.net_chunk)
        color[mask] = c
        density[mask] = d[:, 0]
        return color, density

    def _model_inputs(self, inst, cone_scale):
        """The per-sample model positions [R,S,3] and parameters [R,S,P],
        the blur slot scaled by cone_scale [R,1] * t [R,S] / patch_scale in
        the JAX package's order of operations (_model_inputs), before the
        Fourier lift."""
        prms = inst["parameters"]
        if self.blur_idx is None:
            return inst["pts"], prms
        blur_scale = cone_scale[:, None, :] * inst["t"][:, :, None] / self.patch_scale
        b = self.blur_idx
        return inst["pts"], torch.cat([prms[..., :b], prms[..., b, None] * blur_scale,
                                       prms[..., b + 1:]], -1)

    def _shade(self, inst, cone_scale):
        pos, prms = self._model_inputs(inst, cone_scale)
        color, density = self._eval_mlp(pos, inst["rays_d"], prms, inst["dists"] > 0)
        if self.density_reweighting:
            density = density * inst["alpha_weight"]
        density = density * self.density_scale
        return volume.composite_precomputed_alpha(
            color, density, inst["dists"], inst["color_last"], inst["alpha_last"],
            self.patch_scale, map_exr=self.map_exr,
        )


class MipInstanceRenderer(InstanceRenderer):
    """The integrated-positional-encoding variant (counterpart of the JAX
    ``MipInstanceRenderer``, grid paths): each sample's model position
    (``_model_inputs``) is [pts, cone_sample_cov(local direction, t,
    radius, dists)] in patch-local coordinates, with the radius
    params[blur_idx] * cone_scale / patch_scale; the blur slot is spliced
    out of the sample's parameters.  ``blur_idx`` is kept from the base
    class (as ``blur_idx_mip``), which therefore scales no parameter per
    sample."""

    def __init__(self, blur_idx: int = None, **kwargs):
        super().__init__(**kwargs)
        self.blur_idx_mip = blur_idx

    def _model_inputs(self, inst, cone_scale):
        b = self.blur_idx_mip
        prms = inst["parameters"]
        radii = prms[..., b] * cone_scale[..., None, 0] / self.patch_scale
        prms = torch.cat([prms[..., :b], prms[..., b + 1:]], -1)
        r, s = inst["t"].shape
        cov = volume.cone_sample_cov(inst["rays_d"].reshape(r * s, 3), inst["t"].reshape(r * s),
                                     radii.reshape(r * s),
                                     inst["dists"].reshape(r * s)).reshape(r, s, 3)
        return torch.cat([inst["pts"], cov], -1), prms
