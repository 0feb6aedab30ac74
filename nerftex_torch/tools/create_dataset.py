"""Dataset creation: distribution-driven swatch renders -> NeRF folder
(the port's own copy of nerftex_tpu/tools/create_dataset.py: the same
folder, json and PNG bytes for the same config).

Capability mirror of reference data/create_dataset.py (a Blender/bpy script):
the same config schema (subsets with pose/parameter distributions, driver
collections, resolution, resumable append with 'offset' for multi-machine
splits, periodic pose-file saves, per-frame device-independent sha1 seeds,
create_dataset.py:20-23,129-146,233-249) with two render backends:

  - **blender**: when running inside Blender (`blender <scene.blend>
    --background --python -m nerftex_torch.tools.create_dataset -- <config>`),
    drives Cycles like the reference: spawns a camera over the sampled
    positions, sets hair/material/light drivers per frame, renders PNG/EXR.
  - **analytic** (default in this repo, no Blender available): renders the
    parameter-conditioned analytic swatch field (tools/synth.py, its numpy
    integrator) so the full train->render pipeline is exercisable end to end.

Output: <target>/<subset>/cam_XXXX.png + transforms_<subset>.json, the exact
folder layout nerf2tfr consumes.

    python -m nerftex_torch.tools.create_dataset <config.py> [--backend analytic]
"""

import argparse
import hashlib
import importlib
import json
import math
import os
import sys

import numpy as np

from nerftex_torch.utils import util
from nerftex_torch.utils.util import EasyDict


def set_seed(identifier: str) -> None:
    """Device-independent per-frame seed (create_dataset.py:20-23)."""
    digest = hashlib.sha1(identifier.encode("UTF-8")).hexdigest()
    np.random.seed(int(digest[:7], 16))


def cam_name(i: int, min_chars: int = 7) -> str:
    return "cam_" + ("{:0" + str(min_chars) + "d}").format(i)


def _analytic_render(pose, params, collection_args, resolution, angle, b_0, b_1):
    """Map driver samples onto the analytic field and integrate."""
    from nerftex_torch.tools.synth import render_swatch

    n_geo = len(collection_args.get("hair_drivers", []))
    return render_swatch(
        pose, np.asarray(params, np.float32), max(n_geo, 1), resolution, angle,
        np.asarray(b_0, np.float32), np.asarray(b_1, np.float32),
    )


def render_views(config: EasyDict, backend: str = None) -> None:
    """Render every subset of ``config`` into <target_path>/<subset>/ with
    its transforms json, appending to a folder that already holds frames
    (``offset`` adds a machine's start index); backend "blender" inside
    bpy (the default there), else "analytic"."""
    try:
        import bpy  # noqa: F401

        in_blender = True
    except ImportError:
        in_blender = False
    if backend is None:
        backend = "blender" if in_blender else "analytic"
    if backend == "blender" and not in_blender:
        raise RuntimeError("blender backend requested outside a bpy session")

    dataset_dir = config.target_path
    os.makedirs(dataset_dir, exist_ok=True)
    with open(os.path.join(dataset_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=4)

    resolution = config.get("resolution", 512)
    angle = config.get("angle", 0.63)
    b_0 = config.get("swatch_b_0", [-1.5, -1.3, -0.2])
    b_1 = config.get("swatch_b_1", [1.3, 1.3, 1.9])

    if backend == "blender":
        _blender_setup(config)

    for subset in config.subsets:
        distribution = util.instantiate(EasyDict(subset["pose_dist_config"]))
        driver_sampler = util.instantiate(EasyDict(subset["parameter_dist_config"]))

        offset = config.get("offset", 0)

        path_transforms = os.path.join(
            dataset_dir, config.get("pose_file_prefix", "transforms_") + subset["name"] + ".json"
        )
        if os.path.exists(path_transforms):
            with open(path_transforms) as f:
                transforms = json.load(f)
            offset += len(transforms["frames"])
            distribution.sampler.idx = offset
            driver_sampler.sampler.idx = offset
        else:
            transforms = {"camera_angle_x": angle, "frames": []}

        subset_dir = os.path.join(dataset_dir, subset["name"])
        os.makedirs(subset_dir, exist_ok=True)

        n_samples = max(distribution.sampler.n, driver_sampler.sampler.n)
        min_chars = max(1, math.ceil(np.log10(max(n_samples, 2))))

        i = 0
        while not (distribution.sampler.done() or driver_sampler.sampler.done()):
            set_seed(str(config.get("seed", 0)) + subset["name"] + str(i + offset))
            name = cam_name(i + offset, min_chars)

            cam_pos = subset["cam_radius"] * distribution()
            param_sample = np.atleast_1d(driver_sampler())

            collection_args = config.collections[np.random.choice(len(config.collections))]

            # Record drivers in insertion order (matches the loader's
            # order-preserving read, dataset.py:174-196).
            driver_params = {}
            idx = 0
            for driver in collection_args.get("hair_drivers", []):
                driver_params[driver] = float(param_sample[idx]); idx += 1
            for driver in collection_args.get("material_drivers", []):
                driver_params[driver] = float(param_sample[idx]); idx += 1
            for driver in collection_args.get("light_drivers", []):
                if driver in ("LightDirection", "lightPosition"):
                    driver_params["LightX"] = float(param_sample[idx])
                    driver_params["LightY"] = float(param_sample[idx + 1])
                    driver_params["LightZ"] = float(param_sample[idx + 2])
                    idx += 3
                else:
                    driver_params[driver] = float(param_sample[idx]); idx += 1

            if backend == "blender":
                pose = _blender_render(
                    config, subset, collection_args, cam_pos, param_sample,
                    os.path.join(subset_dir, name),
                )
            else:
                from nerftex_torch.ops.rays import look_at
                from nerftex_torch.utils.image import write_image

                pose = look_at(np.asarray(cam_pos, np.float64))
                if "cam_offset" in subset:
                    pose = pose.copy()
                    pose[:3, 3] += np.asarray(subset["cam_offset"], np.float32)
                rgba = _analytic_render(
                    pose, param_sample, collection_args, resolution, angle, b_0, b_1
                )
                write_image(os.path.join(subset_dir, name + ".png"), rgba)
                pose = pose.tolist()

            transforms["frames"].append(
                {
                    "file_path": "./" + subset["name"] + "/" + name,
                    "transform_matrix": pose,
                    "driver_parameters": driver_params,
                }
            )

            interval = config.get("pose_file_save_interval")
            if interval and (i + 1) % interval == 0:
                with open(path_transforms, "w") as f:
                    json.dump(transforms, f, sort_keys=False, indent=4)
            i += 1

        with open(path_transforms, "w") as f:
            json.dump(transforms, f, sort_keys=False, indent=4)


# ---------------------------------------------------------------------------
# Blender backend (only runs inside bpy; kept separate so the analytic path
# has no Blender imports)
# ---------------------------------------------------------------------------


def _blender_setup(config):
    import bpy

    scene = bpy.context.scene
    if "resolution" in config:
        scene.render.resolution_x = scene.render.resolution_y = config["resolution"]
    if "samples" in config:
        scene.cycles.samples = config["samples"]
    image_settings = scene.render.image_settings
    image_settings.file_format = "PNG"
    if config.get("file_format") == "exr":
        image_settings.file_format = "OPEN_EXR"
        image_settings.color_depth = "32"
    prefs = bpy.context.preferences.addons["cycles"].preferences
    prefs.compute_device_type = config.get("compute_device", "NONE")
    scene.cycles.device = "GPU" if config.get("compute_device", "CPU") != "CPU" else "CPU"

    cam = bpy.data.cameras.new("cam")
    if "angle" in config:
        cam.angle = config["angle"]
    cam_object = bpy.data.objects.new("cam", cam)
    scene.collection.objects.link(cam_object)
    scene.camera = cam_object


def _blender_render(config, subset, collection_args, cam_pos, params, out_path):
    import bpy
    from mathutils import Vector

    cam_object = bpy.context.scene.camera
    cam_object.location = Vector(cam_pos.tolist())
    cam_rot_quat = (-cam_object.location).to_track_quat("-Z", "Y")
    cam_object.rotation_euler = cam_rot_quat.to_euler()
    if "cam_offset" in subset:
        cam_object.location += Vector(subset["cam_offset"])
    bpy.context.view_layer.update()

    obj_name = collection_args["name"]
    idx = 0
    for driver in collection_args.get("hair_drivers", []):
        bpy.data.particles[obj_name][driver] = float(params[idx]); idx += 1
    for driver in collection_args.get("material_drivers", []):
        bpy.data.objects[obj_name].material_slots[0].material[driver] = float(params[idx]); idx += 1
    for driver in collection_args.get("light_drivers", []):
        if driver in ("LightDirection", "lightPosition"):
            light_obj = bpy.data.objects[config["light"]]
            light_obj["x"], light_obj["y"], light_obj["z"] = (
                float(params[idx]), float(params[idx + 1]), float(params[idx + 2])
            )
            idx += 3
        else:
            bpy.data.lights[config["light"]][driver] = float(params[idx]); idx += 1

    ext = ".exr" if config.get("file_format") == "exr" else ".png"
    bpy.context.scene.render.filepath = out_path + ext
    bpy.ops.render.render(write_still=True)

    return [list(row) for row in cam_object.matrix_world]


def main():
    # Configs resolve relative to the caller's cwd (python puts the script's
    # dir, not cwd, on sys.path for direct invocations).
    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    argv = sys.argv
    if "--" in argv:
        argv = argv[argv.index("--") + 1 :]
    else:
        argv = argv[1:]
    ap = argparse.ArgumentParser(description="Render a swatch dataset from a config file.")
    ap.add_argument("config", help="Path to config file.")
    ap.add_argument("--backend", default=None, choices=[None, "blender", "analytic"])
    args = ap.parse_args(argv)

    config_path = args.config[:-3] if args.config.endswith(".py") else args.config
    config = EasyDict(importlib.import_module(config_path.replace("/", ".")).config)
    render_views(config, args.backend)


if __name__ == "__main__":
    main()
