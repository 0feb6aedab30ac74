"""Adopted per-scene render operating points (the port's own copy of
nerftex_tpu/operating_points.py, with the same values so that a served
frame matches the JAX package's at the same point).

Each entry:
  - "instancer": overrides merged into renderer_config.instancer_config
  - "renderer":  overrides merged into renderer_config
  - "compute_dtype": model compute dtype for the adopted point

The values were measured for a TPU; the port ignores ``pallas_selk`` (its
overlap pick always runs the selk_resolve kernel).  Consumer:
render/serve.RenderSession(operating_point=...).
"""

import os

OPERATING_POINTS = {
    "carpet": {
        "compute_dtype": "bfloat16",
        "renderer": {"sorted_blocks": True},
        "instancer": {
            "ray_block": 1024,
            "max_hits": 48,
            "max_steps_per_ray": 320,
            "cull_budget": 448,
            "tri_cull_budget": 384,
        },
    },
    "grass": {
        "compute_dtype": "bfloat16",
        "renderer": {"sorted_blocks": True},
        "instancer": {
            "ray_block": 2048,
            "max_hits": 96,
            "max_steps_per_ray": 1024,
            "cull_budget": 512,
            "tri_cull_budget": 1024,
            "shadow_cull_budget": 512,
            "shadow_tri_cull_budget": 2048,
        },
    },
    "plush": {
        "compute_dtype": "bfloat16",
        "renderer": {"sorted_blocks": True},
        "instancer": {
            "ray_block": 2048,
            "max_hits": 128,
            "max_steps_per_ray": 1280,
            "cull_budget": 384,
            "tri_cull_budget": 1024,
            "shadow_cull_budget": 768,
            "shadow_tri_cull_budget": 1536,
            "pallas_selk": 1,
        },
    },
}

# Scenes sharing a base geometry reuse its point.
ALIASES = {
    "carpet10k": "carpet",
    "grass_filtered": "grass",
    "fur": "plush",
}


def resolve(name):
    """Operating point for a scene stem, or None if unknown."""
    if name in ALIASES:
        name = ALIASES[name]
    return OPERATING_POINTS.get(name)


def infer_scene(config_module_or_path: str):
    """'configs/config_carpet_render.py' / 'configs.config_carpet_render'
    -> 'carpet' (None if the name doesn't follow the config_<scene>_<mode>
    convention)."""
    s = str(config_module_or_path)
    if s.endswith(".py"):
        s = s[:-3]
    stem = os.path.basename(s.replace(".", "/"))
    if stem.startswith("config_") and "_" in stem[7:]:
        return stem[7:].rsplit("_", 1)[0]
    return None
