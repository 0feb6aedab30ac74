"""Instanced-patch renderers: device instancer -> conditioned MLP ->
composite (counterpart of nerftex_tpu/render/instance_renderer.py: the
compact, sorted and dense grid paths): InstanceRenderer and its mip
variant, MipInstanceRenderer."""

import torch

from nerftex_torch.ops import volume
from nerftex_torch.render.renderer import Renderer, chunked_apply
from nerftex_torch.utils import jax_rng, rng, trace
from nerftex_torch.utils.util import as_f32, instantiate


class InstanceRenderer(Renderer):
    """Eval-only renderer marching rays through instanced patch volumes.
    With ``blur_idx`` the parameter slot of that index is scaled per sample
    by cone_scale * t / patch_scale, the ray's footprint at the sample in
    patch units (the filtered configs' blur conditioning).

    Paths: ``sample_budget_per_ray`` > 0 runs the compact path (each ray
    block's valid samples packed into budget x rays MLP rows, the deepest
    dropped and counted when a block needs more); otherwise the sorted grid
    (``sorted_blocks``) or the dense grid.  ``false_color`` composites each
    sample in its instance's palette color, uniform(stream_key(
    STREAM_FALSE_COLOR), [n_instances, 3]) under the seed at construction;
    ``raw_noise_std`` adds normal density noise before the relu."""

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
        self.sample_budget_per_ray = sample_budget_per_ray
        self.sorted_blocks = sorted_blocks
        self.false_color = false_color
        if false_color:
            self.instance_color = jax_rng.uniform(rng.stream_key(rng.STREAM_FALSE_COLOR),
                                                  (self.instancer.n_instances(), 3), self.device)

    def render_rays(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd,
                    bkgd_color, key, training: bool = False) -> dict:
        if training:
            raise ValueError("network.renderer.InstanceRenderer can only be used for evaluation")
        dev_inst = self.instancer.device_instancer
        # The instancer's and the density noise's keys, as the JAX renderer
        # splits them.
        k_inst, k_noise = jax_rng.split(key)
        if self.sample_budget_per_ray > 0:
            inst = dev_inst.get_model_input_compact(
                rays_o, rays_d, parameters, self.n_samples, self.step_size,
                self.sample_budget_per_ray, key=k_inst)
            color_map, alpha_map = self._shade_compact(inst, cone_scale, k_noise)
        elif self.sorted_blocks:
            def shade_block(inst_block, extra_block, k_shade):
                (cone_block,) = extra_block
                return self._shade(inst_block, cone_block, k_shade)

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
            color_map, alpha_map = self._shade(inst, cone_scale, k_noise)

        # Rays culled by the proxy (t = inf) contribute nothing; instancer
        # misses already have zero weights.
        miss = torch.isinf(t[:, 0]) | ~inst["hit"]
        valid = (~miss).float()
        color_map = color_map * valid[:, None]
        alpha_map = alpha_map * valid
        if composite_bkgd:
            bkgd = as_f32(bkgd_color, color_map.device)
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
        trace.count("dropped.hits", hits)
        trace.count("dropped.steps", steps)
        if hits:
            print(f"WARNING: hit capacity exceeded, dropped {hits} farthest "
                  f"ray-instance intervals (raise max_hits).")
        if steps:
            print(f"WARNING: sample capacity exceeded, dropped {steps} deepest "
                  f"samples (raise n_samples / sample_budget_per_ray / max_steps_per_ray).")

    def _eval_mlp(self, pos, dirs, prms, mask):
        """The MLP over every slot of the [R,S] grid, as the JAX path
        evaluates it, with no host read; invalid slots (mask [R,S] false)
        get color logits and density exactly 0, set with where, not by a
        product: a padding slot may hold inf."""
        r, s = mask.shape
        if trace.is_recording():
            trace.count("mlp.valid", mask.sum())
        color, density = chunked_apply(
            self.model.infer, tuple(x.reshape(r * s, -1) for x in (pos, dirs, prms)),
            self.net_chunk)
        return (torch.where(mask[..., None], color.reshape(r, s, 3), 0.0),
                torch.where(mask, density.reshape(r, s), 0.0))

    def _model_inputs(self, inst, cone_scale):
        """The per-sample model positions [R,S,3] and parameters [R,S,P],
        the blur slot scaled by cone_scale [R,1] * t [R,S] / patch_scale in
        the JAX package's order of operations (_model_inputs), before the
        Fourier lift."""
        prms = inst["parameters"]
        if self.blur_idx is None:
            return inst["pts"], prms
        return inst["pts"], self._scale_blur(
            prms, cone_scale[:, None, :] * inst["t"][:, :, None] / self.patch_scale)

    def _scale_blur(self, prms, blur_scale):
        """prms [..., P] with the blur slot times blur_scale [..., 1]."""
        b = self.blur_idx
        return torch.cat([prms[..., :b], prms[..., b, None] * blur_scale, prms[..., b + 1:]], -1)

    def _weigh(self, inst, density):
        """Density reweighting and scale, and the false-color override (the
        palette color of each sample's instance, else None), over the
        samples of ``inst`` in either layout ([R,S] grid or [B] compact)."""
        if self.density_reweighting:
            density = density * inst["alpha_weight"]
        density = density * self.density_scale
        false_color = self.instance_color[inst["instance_id"]] if self.false_color else None
        return density, false_color

    @trace.span("renderer.composite")
    def _composite(self, inst, color, density, noise_key):
        """The composite with the terminator over [R,S] fields, the
        samples weighed by _weigh."""
        density, false_color = self._weigh(inst, density)
        return volume.composite_precomputed_alpha(
            color, density, inst["dists"], inst["color_last"], inst["alpha_last"],
            self.patch_scale, raw_noise_std=self.raw_noise_std, noise_key=noise_key,
            map_exr=self.map_exr, false_color=false_color, noise_width=inst.get("draw_width"))

    @trace.span("renderer.shade")
    def _shade(self, inst, cone_scale, noise_key):
        pos, prms = self._model_inputs(inst, cone_scale)
        color, density = self._eval_mlp(pos, inst["rays_d"], prms, inst["dists"] > 0)
        return self._composite(inst, color, density, noise_key)

    # -- compact path ---------------------------------------------------------

    def _mlp_inputs_compact(self, inst, cone_scale):
        """The compacted samples' model positions [B,3], directions and
        parameters [B,P], the blur slot scaled as on the grid paths."""
        prms = inst["parameters"]
        if self.blur_idx is not None:
            cone = cone_scale[_ray_rows(inst, cone_scale)]                    # [B,1]
            prms = self._scale_blur(prms, cone * inst["t"][:, None] / self.patch_scale)
        return inst["pts"], inst["rays_d"], prms

    def _shade_compact(self, inst, cone_scale, noise_key):
        """The MLP over the [B] compacted rows (untaken rows zeroed with
        where, not by a product: padding may hold inf), then the colors
        and densities scattered into the dense [R,S] fields and
        composited."""
        pos, dirs, prms = self._mlp_inputs_compact(inst, cone_scale)
        taken = inst["taken"][:, None]
        color_c, density_c = chunked_apply(
            self.model.infer, tuple(torch.where(taken, x, 0.0) for x in (pos, dirs, prms)),
            self.net_chunk)
        return self._scatter_composite(inst, color_c, density_c[:, 0], noise_key)

    def _scatter_composite(self, inst, color_c, density_c, noise_key):
        """Dense [R,S] color and density from the compacted samples',
        weighed by _weigh (the taken ones add their values, the others
        exact zeros, at their own slot or, past the last ray, at slot 0),
        composited over the dense dists and terminator."""
        density_c, false_c = self._weigh(inst, density_c)
        if false_c is not None:
            color_c = false_c
        r, S = inst["dists"].shape
        taken = inst["taken"]
        flat_idx = torch.where(taken, inst["ray_idx"] * S + inst["i_idx"], 0)
        color = color_c.new_zeros(r * S, 3).index_add_(
            0, flat_idx, torch.where(taken[:, None], color_c, 0.0)).reshape(r, S, 3)
        density = density_c.new_zeros(r * S).index_add_(
            0, flat_idx, torch.where(taken, density_c, 0.0)).reshape(r, S)
        return volume.composite_precomputed_alpha(
            color, density, inst["dists"], inst["color_last"], inst["alpha_last"],
            self.patch_scale, raw_noise_std=self.raw_noise_std, noise_key=noise_key,
            map_exr=self.map_exr, false_color=color if self.false_color else None)


def _ray_rows(inst, per_ray):
    """Each compacted sample's row in the chunk's per-ray table ``per_ray``
    (samples of padding rays, never taken, read the last row)."""
    return torch.clamp(inst["ray_idx"], max=per_ray.shape[0] - 1)


class MipInstanceRenderer(InstanceRenderer):
    """The integrated-positional-encoding variant (counterpart of the JAX
    ``MipInstanceRenderer``): each sample's model position
    (``_model_inputs``; ``_mlp_inputs_compact`` with the compacted
    samples' dists_c) is [pts, cone_sample_cov(local direction, t,
    radius, dists)] in patch-local coordinates, with the radius
    params[blur_idx] * cone_scale / patch_scale; the blur slot is spliced
    out of the sample's parameters.  ``blur_idx`` is kept from the base
    class (as ``blur_idx_mip``), which therefore scales no parameter per
    sample."""

    def __init__(self, blur_idx: int = None, **kwargs):
        super().__init__(**kwargs)
        self.blur_idx_mip = blur_idx

    def _radii(self, prms, cone):
        """The cone radius params[blur] * cone / patch_scale of each sample
        and its parameters without the blur slot."""
        b = self.blur_idx_mip
        return (prms[..., b] * cone / self.patch_scale,
                torch.cat([prms[..., :b], prms[..., b + 1:]], -1))

    def _model_inputs(self, inst, cone_scale):
        radii, prms = self._radii(inst["parameters"], cone_scale[..., None, 0])
        r, s = inst["t"].shape
        cov = volume.cone_sample_cov(inst["rays_d"].reshape(r * s, 3), inst["t"].reshape(r * s),
                                     radii.reshape(r * s),
                                     inst["dists"].reshape(r * s)).reshape(r, s, 3)
        return torch.cat([inst["pts"], cov], -1), prms

    def _mlp_inputs_compact(self, inst, cone_scale):
        radii, prms = self._radii(inst["parameters"], cone_scale[_ray_rows(inst, cone_scale), 0])
        cov = volume.cone_sample_cov(inst["rays_d"], inst["t"], radii, inst["dists_c"])
        return torch.cat([inst["pts"], cov], -1), inst["rays_d"], prms
