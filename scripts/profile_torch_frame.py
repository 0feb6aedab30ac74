"""Where the time of one frame goes in the PyTorch port (CUDA card).

Builds the bench frame's renderer (``--scene bench``, the 512x512 carpet
frame), the plush frame's (``--scene plush``, 800x800) or the grass
frame's (``--scene grass``, 512x512), the carpet and carpet10k frames'
(``--scene carpet|carpet10k``, 512x512, 900 and 10,000 patches) exactly as
chip_smoke.py does, the bench frame with an f32 ParamNerf (``--scene
bench_f32``, chip_smoke.py's f32 bench frame), or the first frame that
``nerftex_torch.main configs/config_grass_filtered_render.py`` renders
(``--scene grass_filtered``: the config's own f32 renderer, blur_idx 0,
render_chunk 16384, the committed grass_filtered weights), or the first frame
that ``nerftex_torch.main configs/demo_grass_mip_render.py`` renders
(``--scene grass_mip``: 256x256, the config's MipInstanceRenderer, the
JAX init weights that tests/torch_grass_mip_inputs.npz digests), renders the frame twice to warm up, then profiles one
render with torch.profiler and prints: the wall time, the summed device
time of all kernels, the device idle share (1 - busy / wall), the number
of kernel launches, the kernels ranked by device time, and the port's own
kernels (tex_fetch, mlp_fused, selk_resolve) whatever their rank.  It also times
the render's stages with synchronised host clocks: the per-ray stage
(culls, slab tests, top-K, event walk, and within it the shadow pass), the
per-sample stage (arc-to-world map, overlap pick, local frames, texture
fetch) and the rest (sort, MLP, composite).

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_torch_frame.py [--scene bench|bench_f32|plush|grass|carpet|carpet10k|grass_filtered|grass_mip] \
        [--top 25] [--root DIR]

``--root`` is a checkout of this repo (default: this one) whose
nerftex_torch and chip_smoke.py are profiled, for before/after runs.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel names of nerftex_torch/kernels/csrc, old and new (matched anywhere
# in the profiler's name, which may be demangled or not).
PORT_KERNELS = ("tex_fetch_kernel", "mlp_fused_kernel", "mlp_wgmma_kernel", "mlp_f32_kernel",
                "mlp_tf32_kernel", "selk_resolve_kernel")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("bench", "bench_f32", "plush", "grass", "carpet",
                                        "carpet10k", "grass_filtered", "grass_mip"),
                    default="bench")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_frame: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from nerftex_torch.instancing.device import DeviceInstancer
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    torch.backends.cuda.matmul.allow_tf32 = False
    if args.scene in ("bench", "bench_f32"):
        inputs = np.load(os.path.join(root, "tests", "torch_bench_inputs.npz"))
        params = {k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")}
        dtype = "float32" if args.scene == "bench_f32" else "bfloat16"
        model = instantiate(chip_smoke.model_config("bfloat16", compute_dtype=dtype), device="cuda")
        r_cfg = chip_smoke.renderer_config("bfloat16")
        data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                          [1, 1, 1, 0.1, 0, 0, 1.0])
    elif args.scene == "plush":
        data, params, _, _ = chip_smoke.scene_data("plush")
        model = instantiate(chip_smoke.plush_model_config(), device="cuda")
        r_cfg = chip_smoke.plush_renderer_config()
    elif args.scene == "grass":
        data, params, _, _ = chip_smoke.scene_data("grass")
        model = instantiate(chip_smoke.grass_model_config(), device="cuda")
        r_cfg = chip_smoke.grass_renderer_config()
    elif args.scene in ("carpet", "carpet10k"):
        data, _, _ = chip_smoke.config_item(args.scene)
        params = chip_smoke.npz_params("torch_bench_inputs.npz")
        m_cfg, r_cfg = chip_smoke.carpet_configs(args.scene)
        model = instantiate(m_cfg, device="cuda")
    elif args.scene == "grass_mip":
        from configs.demo_grass_mip_render import config
        from nerftex_torch.utils import rng

        rng.set_seed(config["seed"])
        data = next(iter(instantiate(config["test_dataset_config"]).take(1)))
        model = chip_smoke.mip_init_model(
            config, np.load(os.path.join(root, "tests", chip_smoke.MIP_INPUTS)))
        params = None
        r_cfg = config["renderer_config"]
    else:
        from configs.config_grass_filtered_render import config

        data, _, _ = chip_smoke.config_item("grass_filtered")
        params = chip_smoke.npz_params("torch_grass_filtered_inputs.npz")
        model = instantiate(config["model_config"], device="cuda")
        r_cfg = config["renderer_config"]
    kw = {"key": jax_rng.key(1)}
    if params is not None:
        load_jax_params(model, params)
    renderer = instantiate(dict(r_cfg, model=model, device="cuda"))
    for _ in range(2):
        renderer(**data, **kw)
    torch.cuda.synchronize()

    # Stage split: synchronised host time of each stage's calls in one render.
    stages = {"_per_ray": 0.0, "_shadow_blocked_sparse": 0.0, "_per_sample_grid": 0.0}
    originals = {name: getattr(DeviceInstancer, name) for name in stages}

    def timed(name):
        def run(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[name](self, *a, **k)
            torch.cuda.synchronize()
            stages[name] += time.perf_counter() - t0
            return out
        return run

    for name in stages:
        setattr(DeviceInstancer, name, timed(name))
    t0 = time.perf_counter()
    renderer(**data, **kw)
    torch.cuda.synchronize()
    split_wall = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(DeviceInstancer, name, fn)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        renderer(**data, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    n_launches = sum(a.count for a in kernels)
    by_name = {a.key: (a.count, a.self_device_time_total) for a in kernels}
    print(f"card: {chip_smoke.card_line()}  scene: {args.scene}  root: "
          f"{os.path.relpath(root, ROOT)}")
    print(f"stage split (synchronised): per-ray stage {stages['_per_ray'] * 1e3:.1f} ms "
          f"(shadow pass {stages['_shadow_blocked_sparse'] * 1e3:.1f} ms), per-sample stage "
          f"{stages['_per_sample_grid'] * 1e3:.1f} ms, of {split_wall * 1e3:.1f} ms")
    print(f"profiled render: wall {wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, "
          f"idle share {1 - busy_us / 1e6 / wall:.3f}, kernel launches {n_launches}")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(f"{t / 1e3:10.2f} {t / busy_us:6.3f} {n:6d}  {name[:110]}")
    print("the port's kernels:")
    for name, (n, t) in sorted(by_name.items()):
        if any(k in name for k in PORT_KERNELS):
            print(f"{t / 1e3:10.3f} {t / busy_us:6.3f} {n:6d}  {name[:110]}")


if __name__ == "__main__":
    main()
