"""Wall time of a frame in the PyTorch port, for A/B runs of two checkouts
on one card: the bench frame (bench.py's 512x512 carpet frame) or the
800x800 plush frame.

Builds the frame's renderer exactly as the checkout's chip_smoke.py does
(bench: its model_config and renderer_config, the bench weights of its
tests/torch_bench_inputs.npz, JAX's draws for key(1); plush: its
plush_model_config and plush_renderer_config, the weights and rays of
tests/torch_plush_inputs.npz, key(1)), renders once to warm up, then
times ``--renders`` renders, each synchronised, and prints one JSON line:
the checkout, the frame, the card's name and power limit, every render's
ms, the best and the median, rays/s at each, and the kernels' launches per
frame.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/time_torch_frame.py [--root DIR] [--scene bench|plush] [--renders 5]

``--root`` is a checkout of this repo (default: this one); its
nerftex_torch and chip_smoke.py are the ones timed, so this script can time
an older checkout as well.  A checkout whose bench frame still read stored
offsets (a ``u_offset`` array in its tests/torch_bench_inputs.npz) is timed
as it ran with that checkout's own copy of this script.  Alternate the checkouts over several processes
(A, B, B, A, ...): the host's share of the frame varies from run to run.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--scene", choices=("bench", "plush"), default="bench")
    ap.add_argument("--renders", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_torch_frame: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from nerftex_torch.kernels import mlp_fused, tex_gather
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    counters = {"tex_fetch": tex_gather.sample_channel, "mlp_fused": mlp_fused.mlp_fused}
    try:
        from nerftex_torch.kernels import selk_resolve
        counters["selk_resolve"] = selk_resolve.selk_resolve
    except ImportError:
        pass

    torch.backends.cuda.matmul.allow_tf32 = False
    key = {"key": jax_rng.key(1)}
    if args.scene == "bench":
        inputs = np.load(os.path.join(root, "tests", "torch_bench_inputs.npz"))
        params = {k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")}
        model_config = chip_smoke.model_config("bfloat16")
        renderer_config = chip_smoke.renderer_config("bfloat16")
        data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                          [1, 1, 1, 0.1, 0, 0, 1.0])
    else:
        # scene_data is plush_data in checkouts from before the grass frame.
        scene_data = getattr(chip_smoke, "scene_data", None)
        data, params, _, _ = scene_data("plush") if scene_data else chip_smoke.plush_data()
        model_config = chip_smoke.plush_model_config()
        renderer_config = chip_smoke.plush_renderer_config()
    model = instantiate(model_config, device="cuda")
    load_jax_params(model, params)
    renderer = instantiate(dict(renderer_config, model=model, device="cuda"))
    n_rays = int(np.prod(data["rays_o"].shape[:-1]))
    renderer(**data, **key)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for _ in range(args.renders):
        t0 = time.perf_counter()
        renderer(**data, **key)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "root": os.path.relpath(root, ROOT), "scene": args.scene, "card": chip_smoke.card_line(),
        "ms": times, "best_ms": min(times), "median_ms": statistics.median(times),
        "rays_per_s_best": n_rays / min(times) * 1e3,
        "rays_per_s_median": n_rays / statistics.median(times) * 1e3,
        "launches_per_frame": {k: fn.launches // args.renders for k, fn in counters.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
