"""Where the time of one bench frame goes in the PyTorch port (CUDA card).

Builds the bench renderer exactly as chip_smoke.py does, renders the frame
twice to warm up, then profiles one render with torch.profiler and prints:
the wall time, the summed device time of all kernels, the device idle share
(1 - busy / wall), the number of kernel launches, and the kernels ranked by
device time.  It also times the render's two stages separately with
synchronised host clocks: the per-ray stage (culls, slab tests, top-K,
event walk) and the rest (sort, per-sample stage, MLP, composite).

Run from the repo root on a machine with a CUDA card:

    python3 scripts/profile_torch_frame.py [--top 25]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_frame: needs a CUDA card")
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from chip_smoke import card_line, model_config, renderer_config
    from nerftex_torch.instancing.device import DeviceInstancer
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils.util import instantiate

    torch.backends.cuda.matmul.allow_tf32 = False
    inputs = np.load(os.path.join(ROOT, "tests", "torch_bench_inputs.npz"))
    params = {k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")}
    model = instantiate(model_config("bfloat16"), device="cuda")
    load_jax_params(model, params)
    renderer = instantiate(dict(renderer_config("bfloat16"), model=model, device="cuda"))
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    u_offset = inputs["u_offset"][None]
    for _ in range(2):
        renderer(**data, u_offset=u_offset)
    torch.cuda.synchronize()

    # Stage split: time _per_ray calls inside one render.
    per_ray_s = [0.0]
    orig = DeviceInstancer._per_ray

    def timed(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, *a, **kw)
        torch.cuda.synchronize()
        per_ray_s[0] += time.perf_counter() - t0
        return out

    DeviceInstancer._per_ray = timed
    t0 = time.perf_counter()
    renderer(**data, u_offset=u_offset)
    torch.cuda.synchronize()
    split_wall = time.perf_counter() - t0
    DeviceInstancer._per_ray = orig

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        renderer(**data, u_offset=u_offset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in kernels)
    n_launches = sum(a.count for a in kernels)
    by_name = {a.key: (a.count, a.self_device_time_total) for a in kernels}
    print(f"card: {card_line()}")
    print(f"stage split (synchronised): per-ray stage {per_ray_s[0] * 1e3:.1f} ms of "
          f"{split_wall * 1e3:.1f} ms")
    print(f"profiled render: wall {wall * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms, "
          f"idle share {1 - busy_us / 1e6 / wall:.3f}, kernel launches {n_launches}")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(f"{t / 1e3:10.2f} {t / busy_us:6.3f} {n:6d}  {name[:110]}")


if __name__ == "__main__":
    main()
