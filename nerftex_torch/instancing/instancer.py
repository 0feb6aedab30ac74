"""Public Instancer: the reference's constructor surface over the port's
scene compiler and device instancer (counterpart of
nerftex_tpu/instancing/instancer.py)."""

import numpy as np
import torch

from nerftex_torch.instancing.device import DeviceInstancer
from nerftex_torch.instancing.scene import Scene
from nerftex_torch.utils.util import resolve_device


class Instancer:
    def __init__(
        self,
        b_0: list,
        b_1: list,
        cast_shadow_rays: bool = False,
        textures: list = (),
        transformations: list = (),
        mesh_path: str = None,
        patch_scale: float = 1.0,
        patch_origins_path: str = "",
        min_shadow_samples: int = 4,
        n_shadow_samples: int = 512,
        min_texture_samples: int = 4,
        n_texture_samples: int = 512,
        jitter_amount: float = 0,
        instance_sampling_method: str = "random",
        use_mean_distance: bool = False,
        auxiliary_meshes: list = (),
        transformation_export_path: str = None,
        max_hits: int = 64,
        ray_block: int = 256,
        shadow_samples: int = 32,
        max_steps_per_ray: int = 512,
        cull_budget: int = 0,
        tri_cull_budget: int = 0,
        shadow_cull_budget: int = 0,
        shadow_tri_cull_budget: int = 0,
        seed: int = 0,
        deterministic_offset: bool = False,
        pallas_selk: bool = False,
        matmul_precision: str = "float32",
        device=None,
    ):
        # pallas_selk is accepted so that the JAX package's configs load, and
        # ignored: the overlap pick always runs the selk_resolve kernel on
        # the card (its plain version on the CPU).
        del pallas_selk
        device = resolve_device(device)
        self.scene = Scene(
            b_0, b_1,
            cast_shadow_rays=cast_shadow_rays,
            textures=textures,
            min_shadow_samples=min_shadow_samples,
            n_shadow_samples=n_shadow_samples,
            min_texture_samples=min_texture_samples,
            n_texture_samples=n_texture_samples,
            jitter_amount=jitter_amount,
            instance_sampling_method=instance_sampling_method,
            use_mean_distance=use_mean_distance,
            seed=seed,
        )
        for transformation in transformations:
            self.scene.add_instance(np.asarray(transformation, np.float32))
        if mesh_path is not None:
            self.scene.distribute_instances_on_mesh(mesh_path, patch_scale, patch_origins_path)
            if transformation_export_path is not None:
                self.scene.export_transformations(transformation_export_path)
        for aux_mesh_path, aux_texture_path in auxiliary_meshes:
            self.scene.add_mesh(aux_mesh_path, aux_texture_path)

        self.device_instancer = DeviceInstancer(
            self.scene,
            device,
            max_hits=max_hits,
            ray_block=ray_block,
            max_steps_per_ray=max_steps_per_ray,
            cull_budget=cull_budget,
            tri_cull_budget=tri_cull_budget,
            shadow_samples=shadow_samples,
            shadow_cull_budget=shadow_cull_budget,
            shadow_tri_cull_budget=shadow_tri_cull_budget,
            deterministic_offset=deterministic_offset,
            matmul_precision=matmul_precision,
            seed=seed,
        )

    def n_instances(self) -> int:
        return self.scene.n_instances()

    def get_model_input(self, rays_o, rays_d, parameters, n_samples, step_size):
        """The reference's ten outputs (instancer.pyx:54) as tensors on the
        instancer's device: (rays_d, pts, t, dists, color_last, alpha_last,
        alpha_weight, instance_id, hit_idxs, parameters), hit_idxs [H, 1]
        the indices of the rays that hit anything.  Each call draws under
        the device instancer's next keyless key."""
        out = self.device_instancer.get_model_input(
            np.asarray(rays_o, np.float32), np.asarray(rays_d, np.float32),
            np.asarray(parameters, np.float32), n_samples, step_size)
        hit_idxs = torch.nonzero(out["hit"])
        return (out["rays_d"], out["pts"], out["t"], out["dists"], out["color_last"],
                out["alpha_last"], out["alpha_weight"], out["instance_id"], hit_idxs,
                out["parameters"])

    def get_model_input_dict(self, rays_o, rays_d, parameters, n_samples, step_size, key=None):
        """The fixed-shape dict of DeviceInstancer.get_model_input (masks
        instead of hit indices)."""
        return self.device_instancer.get_model_input(rays_o, rays_d, parameters, n_samples,
                                                     step_size, key)
