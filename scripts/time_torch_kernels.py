"""Device time of the PyTorch port's kernels at the frames' shapes, for A/B
runs of two checkouts on one card.

For the checkout at ``--root`` (default: this one), times on the CUDA card:

  tex_fetch     both frames' textures (smooth_checkerboard.png,
                checkerboard.png) at 1,048,576 and 327,680 (one bench ray
                block) uniform uv samples, beside grid_sample;
  mlp_fused     bf16 with the bench weights at 262,144 and 32,768 (the
                bench net_chunk) samples and the plush weights at 65,536
                (its net_chunk), beside the same layer chain as bf16 cuBLAS
                calls, with the max and mean |kernel - plain|;
  selk_resolve  each frame's overlap-pick shape and method.

Each time is chip_smoke.device_ms (calls captured in a CUDA graph and
replayed: the card's own time) beside chip_smoke.time_ms (event time over
back-to-back calls, host dispatch included).  A checkout whose tex_gather
has ``byte_quads`` runs its byte_quad variant, an older one its f32 fetch.
Prints one JSON line.  Helpers and inputs come from this checkout's
chip_smoke.py; the kernels from ``--root``'s nerftex_torch.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/time_torch_kernels.py [--root DIR]

Alternate the checkouts over several processes (A, B, B, A) in one call.
"""

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_torch_kernels: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nerftex_torch.instancing.scene import load_texture_channels
    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk, tex_gather
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils.util import instantiate

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    result = {"root": os.path.relpath(root, ROOT), "card": cs.card_line(), "tex_fetch": {},
              "mlp_fused": {}, "selk_resolve": {}}

    for texture in ("smooth_checkerboard.png", "checkerboard.png"):
        tex = torch.tensor(load_texture_channels(os.path.join(ROOT, "meshes", texture))[0],
                           device=dev).contiguous()
        quads = tex_gather.byte_quads(tex) if hasattr(tex_gather, "byte_quads") else None
        extra = () if quads is None else (quads,)
        w, h = tex.shape
        image = tex.T.reshape(1, 1, h, w)
        rows = {}
        for n in cs.TEX_SAMPLES:
            uv = torch.tensor(np.random.RandomState(0).uniform(-0.05, 1.05, (n, 2))
                              .astype(np.float32), device=dev)
            grid = (uv * 2 - 1).reshape(1, 1, -1, 2)

            def kernel():
                return tex_gather.sample_channel(tex, uv, *extra)

            def library():
                return torch.nn.functional.grid_sample(image, grid, mode="bilinear",
                                                       padding_mode="border", align_corners=True)

            rows[n] = {"variant": "f32" if quads is None else "byte_quad",
                       "max_abs_err": float((kernel() - tex_gather.sample_channel_plain(tex, uv))
                                            .abs().max()),
                       "device_ms": cs.device_ms(kernel), "ms": cs.time_ms(kernel, iters=50),
                       "library_device_ms": cs.device_ms(library),
                       "library_ms": cs.time_ms(library, iters=50)}
        result["tex_fetch"][texture] = rows

    nets = {"bench": (cs.model_config("float32"), "torch_bench_inputs.npz"),
            "plush": (cs.plush_model_config(), "torch_plush_inputs.npz")}
    for frame, (cfg, npz) in nets.items():
        model = instantiate(cfg, device="cuda")
        load_jax_params(model, cs.npz_params(npz))
        packed = model.packed()
        chain = cs.cublas_chain(packed)
        rows = {}
        for n in cs.MLP_SAMPLES[frame]:
            rs = np.random.RandomState(1)
            pos = torch.tensor(rs.uniform(-1, 1, (n, 3)).astype(np.float32), device=dev)
            dirs = torch.nn.functional.normalize(
                torch.tensor(rs.normal(size=(n, 3)).astype(np.float32), device=dev), dim=-1)
            prms = torch.tensor(rs.uniform(0, 1, (n, model.n_geo + model.n_app))
                                .astype(np.float32), device=dev)
            with torch.no_grad():
                pos_map, dir_map = model.feature_maps(pos, dirs, prms)
            err = (fused.mlp_fused(pos_map, dir_map, packed)
                   - fused.mlp_fused_plain(pos_map, dir_map, packed)).abs()
            pos_b = torch.nn.functional.pad(pos_map, (0, packed.pos_pad - packed.pos_dim)).bfloat16()
            dir_b = torch.nn.functional.pad(dir_map, (0, packed.dir_pad - packed.dir_dim)).bfloat16()
            dt = cs.device_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed), iters=20)
            rows[n] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                       "device_ms": dt, "tflops": 2 * packed.macs * n / dt / 1e9,
                       "ms": cs.time_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed)),
                       "cublas_layers_device_ms": cs.device_ms(lambda: chain(pos_b, dir_b),
                                                               iters=20)}
        result["mlp_fused"][frame] = rows

    for frame in ("bench", "plush"):
        sel_args, _ = cs.selk_inputs(*cs.SELK_SHAPE[frame])
        method = cs.SELK_METHODS[frame][-1]

        def pick():
            return selk.selk_resolve(*sel_args, method=method, blend_range=cs.SELK_BLEND)

        result["selk_resolve"][frame] = {"method": method, "device_ms": cs.device_ms(pick),
                                         "ms": cs.time_ms(pick)}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
