"""Device time of the PyTorch port's kernels at the frames' shapes, for A/B
runs of two checkouts on one card.

For the checkout at ``--root`` (default: this one), times on the CUDA card:

  tex_fetch     both frames' textures (smooth_checkerboard.png,
                checkerboard.png) at 1,048,576 and 327,680 (one bench ray
                block) uniform uv samples, beside grid_sample;
  mlp_fused     bf16 with the bench weights at 262,144 and 32,768 (the
                bench net_chunk) samples, the plush weights at 65,536 (its
                net_chunk) and the grass weights at 32,768 (its net_chunk),
                beside the same layer chain as bf16 cuBLAS calls, and the
                f32 variant (bench_f32: the checkout's own, wgmma_tf32x3 or
                the older fma_f32) with the bench weights at 262,144 and
                32,768 beside the chain as f32 cuBLAS calls (TF32 off),
                with the max and mean |kernel - plain|;
  selk_resolve  every method at each frame's check shape
                (chip_smoke.SELK_SHAPE) and at the render-layout inputs of
                each hit tier (chip_smoke.SELK_RENDER_SHAPES); then each
                frame (bench, plush, and grass where the checkout renders
                it) is rendered once with every selk_resolve call's
                inputs captured (chip_smoke.selk_capture), and each
                captured launch is timed: the frame's launch histogram (Rb,
                S, K, method, launches, window slots, valid slots, device
                ms), its summed device time and bound
                (chip_smoke.selk_bound), and the wall time of one more
                (uncaptured) render of the frame, as rays/s.

Each time is chip_smoke.device_ms (calls captured in a CUDA graph and
replayed: the card's own time) beside chip_smoke.time_ms (event time over
back-to-back calls, host dispatch included).  A checkout whose tex_gather
has ``byte_quads`` runs its byte_quad variant, an older one its f32 fetch.
Prints one JSON line.  Helpers and inputs come from this checkout's
chip_smoke.py; the kernels and the renderers from ``--root``'s
nerftex_torch.

``--save-selk FILE`` also writes selk_resolve's outputs on all those
fixed-seed inputs (and on an unsorted layout with holes) to FILE (.npz), as
a 64-bit digest of each output row, with a digest of each captured frame
launch's inputs; ``--compare-selk A B`` (no card needed) then counts the
rows that differ between two such files, for a bit-for-bit comparison of
two checkouts' kernels.

Run from the repo root on a machine with a CUDA card:

    python3 scripts/time_torch_kernels.py [--root DIR] [--save-selk FILE] [--only mlp_fused]
    python3 scripts/time_torch_kernels.py --compare-selk A.npz B.npz

``--only`` times the named kernels alone (tex_fetch, mlp_fused,
selk_resolve; default all three).

Alternate the checkouts over several processes (A, B, B, A) in one call.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ["tex_fetch", "mlp_fused", "selk_resolve"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--save-selk", metavar="FILE")
    ap.add_argument("--compare-selk", nargs=2, metavar=("A", "B"))
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS)
    args = ap.parse_args()
    if args.compare_selk:
        print(json.dumps(compare_selk(*args.compare_selk)), flush=True)
        return
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

    for texture in ("smooth_checkerboard.png", "checkerboard.png") if "tex_fetch" in args.only else ():
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

    nets = {"bench": (cs.model_config("float32"), "torch_bench_inputs.npz",
                      cs.MLP_SAMPLES["bench"]),
            "plush": (cs.plush_model_config(), "torch_plush_inputs.npz",
                      cs.MLP_SAMPLES["plush"]),
            "grass": (cs.grass_model_config(), "torch_grass_inputs.npz", (32768,)),
            "bench_f32": (cs.model_config("float32", compute_dtype="float32"),
                          "torch_bench_inputs.npz", (262144, 32768))}
    for frame, (cfg, npz, sizes) in nets.items() if "mlp_fused" in args.only else ():
        model = instantiate(cfg, device="cuda")
        load_jax_params(model, cs.npz_params(npz))
        packed = model.packed()
        dtype = torch.float32 if frame == "bench_f32" else torch.bfloat16
        chain = cs.cublas_chain(packed, dtype)
        rows = {}
        for n in sizes:
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
            pos_b, dir_b = cs.cublas_inputs(packed, pos_map, dir_map, dtype)
            dt = cs.device_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed), iters=20)
            rows[n] = {"variant": fused.VARIANTS[packed.dtype],
                       "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                       "device_ms": dt, "tflops": 2 * packed.macs * n / dt / 1e9,
                       "ms": cs.time_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed)),
                       "cublas_layers_device_ms": cs.device_ms(lambda: chain(pos_b, dir_b),
                                                               iters=20)}
        result["mlp_fused"][frame] = rows

    if "selk_resolve" in args.only:
        result["selk_resolve"], digests = time_selk(cs, selk)
        if args.save_selk:
            np.savez(args.save_selk, **digests)
    print(json.dumps(result), flush=True)


def row_digests(x):
    """A 64-bit digest of each row of x [Rb, ...]."""
    rows = x.contiguous().cpu().numpy().view(np.uint8).reshape(x.shape[0], -1)
    return np.array([int.from_bytes(hashlib.blake2b(r.tobytes(), digest_size=8).digest(), "little")
                     for r in rows], dtype=np.uint64)


def general_inputs(cs, rb, s, k):
    """Unsorted overlap-resolution inputs with holes (valid slots at random,
    one all-invalid ray, one ray no sample reaches): the kernel's scan path."""
    rs = np.random.RandomState(5)
    tk0 = rs.uniform(0.0, 2.0, (rb, k))
    tk1 = tk0 + rs.uniform(0.05, 0.8, (rb, k))
    kvalid = rs.uniform(size=(rb, k)) > 0.3
    kvalid[0] = False
    tk0[1], tk1[1] = tk0[1] + 10.0, tk1[1] + 10.0
    c = rs.uniform(0.0, 2.5, (rb, k))
    return cs.selk_tensors(tk0, tk1, kvalid, c * c + rs.uniform(0.0, 0.2, (rb, k)), -c,
                           rs.uniform(-0.1, 2.6, (rb, s)), rs.uniform(size=(rb, s)))


def frame_renderer(cs, frame):
    """The frame's renderer as chip_smoke.py builds it, its call's keyword
    arguments and its ray count."""
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    if frame == "bench":
        model = instantiate(cs.model_config("bfloat16"), device="cuda")
        load_jax_params(model, cs.npz_params("torch_bench_inputs.npz"))
        r_cfg = cs.renderer_config("bfloat16")
        kw = dict(frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                             [1, 1, 1, 0.1, 0, 0, 1.0]), key=jax_rng.key(1))
        n_rays = 512 * 512
    else:
        data, params, h, w = cs.scene_data(frame)
        model = instantiate(getattr(cs, f"{frame}_model_config")(), device="cuda")
        load_jax_params(model, params)
        r_cfg = getattr(cs, f"{frame}_renderer_config")()
        kw = dict(data, key=jax_rng.key(1))
        n_rays = h * w
    return instantiate(dict(r_cfg, model=model, device="cuda")), kw, n_rays


def capture_frame(cs, frame):
    """Render ``frame`` once with each selk_resolve call captured
    (chip_smoke.selk_capture, arguments kept), then once more, timed.
    Returns (calls, render seconds, rays)."""
    renderer, kw, n_rays = frame_renderer(cs, frame)
    with cs.selk_capture(keep_inputs=True) as calls:
        renderer(**kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer(**kw)
    torch.cuda.synchronize()
    return calls, time.perf_counter() - t0, n_rays


def time_selk(cs, selk):
    """selk_resolve's device times (see the module docstring) and the
    digests of its outputs."""
    digests = {}
    out = {"check": {}, "render_layout": {}, "frames": {}}

    def run(name, sel_args, methods, timed=True):
        rows = {}
        for method in methods:
            def pick():
                return selk.selk_resolve(*sel_args, method=method, blend_range=cs.SELK_BLEND)

            for label, x in zip(("sel", "p", "n"), pick()):
                digests[f"{name}.{method}.{label}"] = row_digests(x)
            if timed:
                rows[method] = {"device_ms": cs.device_ms(pick, iters=20),
                                "ms": cs.time_ms(pick)}
        return rows

    for frame, shape in cs.SELK_SHAPE.items():
        out["check"]["x".join(map(str, shape))] = run(f"check.{frame}", cs.selk_inputs(*shape),
                                                      tuple(selk.METHODS))
    for shape in sorted({s for shapes in cs.SELK_RENDER_SHAPES.values() for s in shapes}):
        name = "x".join(map(str, shape))
        out["render_layout"][name] = run(f"render.{name}", cs.selk_render_inputs(*shape),
                                         tuple(selk.METHODS))
    run("general", general_inputs(cs, 1000, 300, 37), tuple(selk.METHODS), timed=False)

    for frame in ("bench", "plush", "grass"):
        try:
            calls, render_s, n_rays = capture_frame(cs, frame)
        except NotImplementedError as e:  # a checkout older than the grass frame
            out["frames"][frame] = {"skipped": str(e)}
            continue
        works = torch.stack([c["work"] for c in calls]).tolist()
        hist, total, bound = {}, 0.0, 0.0
        for i, (call, work) in enumerate(zip(calls, works)):
            a, k = call["args"]
            dt = cs.device_ms(lambda: selk.selk_resolve(*a, **k), iters=20)
            n, w, v, t = hist.get(call["key"], (0, 0, 0, 0.0))
            hist[call["key"]] = (n + 1, w + work[0], v + work[2], t + dt)
            total += dt
            bound += cs.selk_bound(*call["key"], work)[0]
            h = hashlib.blake2b(digest_size=8)
            for x in a:
                if x is not None:
                    h.update(x.contiguous().cpu().numpy().tobytes())
            digests[f"frame.{frame}.{i}.inputs"] = np.array([int.from_bytes(h.digest(), "little")],
                                                            dtype=np.uint64)
            for label, x in zip(("sel", "p", "n"), selk.selk_resolve(*a, **k)):
                digests[f"frame.{frame}.{i}.{label}"] = row_digests(x)
        out["frames"][frame] = {
            "launches": len(calls), "device_ms": total, "bound_ms": bound,
            "histogram": [[*key, *vals] for key, vals in sorted(hist.items())],
            "render_ms": render_s * 1e3, "rays_per_s": n_rays / render_s,
        }
        del calls
        torch.cuda.empty_cache()
    return out, digests


def compare_selk(path_a, path_b):
    """Rows of each saved selk_resolve output that differ between two
    --save-selk files, and whether each frame launch's inputs matched."""
    a, b = np.load(path_a), np.load(path_b)
    if sorted(a.files) != sorted(b.files):
        return {"error": "the files hold different entries",
                "only_a": sorted(set(a.files) - set(b.files)),
                "only_b": sorted(set(b.files) - set(a.files))}
    rows = {"rows": 0, "rows_differing": 0, "entries": 0, "entries_differing": [],
            "frame_launches_with_other_inputs": []}
    for name in sorted(a.files):
        if name.endswith(".inputs"):
            if not np.array_equal(a[name], b[name]):
                rows["frame_launches_with_other_inputs"].append(name)
            continue
        d = int((a[name] != b[name]).sum())
        rows["entries"] += 1
        rows["rows"] += a[name].size
        rows["rows_differing"] += d
        if d:
            rows["entries_differing"].append([name, d])
    return rows


if __name__ == "__main__":
    main()
