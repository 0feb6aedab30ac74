"""Chip smoke test of the PyTorch port on one CUDA card (H100).

Run from the repo root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card name and power limit, torch and CUDA versions;
  2. build of every kernel from nerftex_torch/kernels/csrc (one nvcc per
     source, started together);
  3. each kernel against its plain PyTorch version on the card at the main
     path's shapes, with times (kernel, plain, library call) and the bound;
  4. the bench frame (bench.py's 512x512 carpet workload) rendered through
     the config-built port with the transplanted bench weights and the
     JAX-drawn per-ray offsets (tests/torch_bench_inputs.npz), checked
     against tests/golden_bench_frame.npz at bench.py's 55 dB floor, with
     both kernels' launch counts from that render, then timed (best of 3).
The last two lines of stdout are the kernels JSON and the device JSON.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PSNR_DB = 55.0                 # bench.py's floor
TEX_SAMPLES = 1 << 20                 # >= 1M uv samples
MLP_SAMPLES = 262144                  # one render chunk's worth of samples
# Tolerances, kernel vs plain version on the same card:
#  tex_fetch: both round every lerp operation separately (no fma), so they
#    agree to the bit; 4e-7 is the JAX package's <= 2 ulp contract
#    (tests/test_tex_kernel.py).
#  mlp_fused f32: FMA accumulation vs cuBLAS f32 (TF32 off) over K <= 337,
#    relative error ~K * 2^-24 per layer through 13 layers.
#  mlp_fused bf16: every layer's output is rounded to bf16 (2^-8 relative);
#    a different summation order flips single roundings, which propagate.
TEX_ATOL = 4e-7
MLP_F32_TOL = 1e-4                    # x max(1, max|plain|)
MLP_BF16_TOL = 5e-2                   # x max(1, max|plain|)

H100_BYTES_PER_S = 3.35e12            # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12              # dense tensor-core bf16
H100_F32_FLOPS = 67e12                # f32 outside the tensor cores


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def model_config(matmul_precision, compute_dtype="bfloat16"):
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n,
                "matmul_precision": matmul_precision}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 6],
            "compute_dtype": compute_dtype}


def renderer_config(matmul_precision):
    """scripts/bench_render.build's render config at bench.py's settings and
    the carpet operating point (nerftex_tpu/operating_points.py)."""
    return {
        "module": "network.renderer.InstanceRenderer",
        "n_samples": 1024, "render_chunk": 262144, "net_chunk": 32768,
        "step_size": 0.002, "sample_budget_per_ray": 0, "sorted_blocks": True,
        "instancer_config": {
            "module": "instancer.instancer.Instancer",
            "b_0": [-1.4, -1.2, -0.1], "b_1": [1.2, 1.2, 1.8],
            "cast_shadow_rays": False,
            "textures": ["meshes/smooth_checkerboard.png", "", "", "", "light"],
            "mesh_path": "meshes/cloth_mesh.ply",
            "patch_origins_path": "meshes/cloth_anchor_points.ply",
            "patch_scale": 0.09, "jitter_amount": 1.0,
            "instance_sampling_method": "nearest",
            "max_hits": 48, "ray_block": 1024, "max_steps_per_ray": 320,
            "cull_budget": 448, "tri_cull_budget": 384,
            "matmul_precision": matmul_precision,
        },
    }


def golden_psnr(out):
    """bench.py _check_golden's comparison."""
    color = out["color_pred"][0].float().cpu().numpy()
    alpha = out["alpha_pred"][0].float().cpu().numpy()
    if color.shape != (512 * 512, 3) or alpha.shape != (512 * 512,):
        raise AssertionError(f"frame shapes {color.shape} {alpha.shape}")
    if not (np.isfinite(color).all() and np.isfinite(alpha).all()):
        raise AssertionError("frame has non-finite values")
    g = np.load(os.path.join(ROOT, "tests", "golden_bench_frame.npz"))
    err = np.concatenate([color - g["color"].astype(np.float32),
                          alpha[:, None] - g["alpha"].astype(np.float32)[:, None]], -1)
    return 10 * np.log10(1.0 / max(float(np.mean(err * err)), 1e-12))


def check_tex(tex_gather, channel):
    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    uv = torch.tensor(rs.uniform(-0.05, 1.05, (TEX_SAMPLES, 2)).astype(np.float32), device=dev)
    tex = torch.tensor(channel, device=dev).contiguous()
    got = tex_gather.sample_channel(tex, uv)
    ref = tex_gather.sample_channel_plain(tex, uv)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    log(f"tex_fetch: {TEX_SAMPLES} samples, max |kernel - plain| = {err:.3g} (tol {TEX_ATOL})")
    if not err <= TEX_ATOL:
        raise AssertionError(f"tex_fetch disagrees with its plain version: {err}")
    w, h = tex.shape
    grid = (uv * 2 - 1).reshape(1, 1, -1, 2)
    image = tex.T.reshape(1, 1, h, w)
    lib_out = torch.nn.functional.grid_sample(image, grid, mode="bilinear",
                                              padding_mode="border", align_corners=True)
    lib_err = float((lib_out.reshape(-1) - ref).abs().max())
    nbytes = TEX_SAMPLES * (8 + 4) + tex.numel() * 4
    row = {
        "name": "tex_fetch", "route": "cuda",
        "source": "nerftex_torch/kernels/csrc/tex_fetch.cu",
        "replaces": "nerftex_tpu/kernels/tex_gather.py:121",
        "max_abs_err": err,
        "ms": time_ms(lambda: tex_gather.sample_channel(tex, uv), iters=50),
        "plain_ms": time_ms(lambda: tex_gather.sample_channel_plain(tex, uv), iters=50),
        "bound_ms": max(nbytes / H100_BYTES_PER_S, TEX_SAMPLES * 20 / H100_F32_FLOPS) * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: torch.nn.functional.grid_sample(
            image, grid, mode="bilinear", padding_mode="border", align_corners=True), iters=50),
        "library": "torch.nn.functional.grid_sample (bilinear, border, align_corners)",
        "library_max_abs_err": lib_err,
    }
    log(f"tex_fetch: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"grid_sample {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    return row


def cublas_chain(packed):
    """The packed layer chain as bf16 torch.nn.functional.linear calls
    (cuBLAS), for timing only."""
    from nerftex_torch.kernels import mlp_fused as fused

    layers = []
    for w_off, b_off, s0, k0, s1, k1, n_pad, dst, n_out, col, relu in packed.table.tolist():
        k = k0 + (k1 if s1 >= 0 else 0)
        w = packed.weights[w_off:w_off + k * n_pad].view(k, n_pad).T.contiguous().bfloat16()
        b = packed.biases[b_off:b_off + n_pad].bfloat16()
        layers.append((s0, s1, w, b, dst, relu))

    def run(pos, dirs):
        bufs = {fused.BUF_POS: pos, fused.BUF_DIR: dirs}
        outs = []
        for s0, s1, w, b, dst, relu in layers:
            x = torch.cat([bufs[s0], bufs[s1]], 1) if s1 >= 0 else bufs[s0]
            y = torch.nn.functional.linear(x, w, b)
            if relu:
                y = torch.relu(y)
            if dst == fused.OUT:
                outs.append(y)
            else:
                bufs[dst] = y
        return outs

    return run


def check_mlp(fused, model, dtype_name):
    """The fused MLP of ``model`` (compute dtype ``dtype_name``) against its
    plain version on random encodable inputs."""
    dev = torch.device("cuda")
    rs = np.random.RandomState(1)
    pos = torch.tensor(rs.uniform(-1, 1, (MLP_SAMPLES, 3)).astype(np.float32), device=dev)
    dirs = torch.tensor(rs.normal(size=(MLP_SAMPLES, 3)).astype(np.float32), device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    prms = torch.tensor(rs.uniform(0, 1, (MLP_SAMPLES, 7)).astype(np.float32), device=dev)
    packed = model.packed()
    with torch.no_grad():
        pos_map, dir_map = model.feature_maps(pos, dirs, prms)
        got = fused.mlp_fused(pos_map, dir_map, packed)
        ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"mlp_fused {dtype_name}: non-finite output")
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    tol = (MLP_BF16_TOL if dtype_name == "bfloat16" else MLP_F32_TOL) * scale
    log(f"mlp_fused {dtype_name}: N={MLP_SAMPLES}, max |kernel - plain| = {err:.3g} "
        f"(tol {tol:.3g}, max|plain| {scale:.3g}), mean err {float((got - ref).abs().mean()):.3g}")
    if not err <= tol:
        raise AssertionError(f"mlp_fused {dtype_name} disagrees with its plain version: {err}")
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (MLP_SAMPLES * (packed.pos_pad + packed.dir_pad) * elt
              + packed.weights.numel() * elt + packed.biases.numel() * 4 + MLP_SAMPLES * 16)
    flops = 2 * packed.macs * MLP_SAMPLES
    peak = H100_BF16_FLOPS if dtype_name == "bfloat16" else H100_F32_FLOPS
    row = {
        "name": "mlp_fused", "route": "cuda",
        "source": "nerftex_torch/kernels/csrc/mlp_fused.cu",
        "replaces": "nerftex_tpu/kernels/mlp_pallas.py:119",
        "max_abs_err": err,
        "ms": time_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed)),
        "plain_ms": time_ms(lambda: fused.mlp_fused_plain(pos_map, dir_map, packed)),
        "bound_ms": max(nbytes / H100_BYTES_PER_S, flops / peak) * 1e3,
        "bound_by": "operations" if flops / peak > nbytes / H100_BYTES_PER_S else "bytes",
        "library_ms": None,
        "macs_per_sample": packed.macs,
    }
    if dtype_name == "bfloat16":
        run = cublas_chain(packed)
        pos_b = torch.nn.functional.pad(pos_map, (0, packed.pos_pad - packed.pos_dim)).bfloat16()
        dir_b = torch.nn.functional.pad(dir_map, (0, packed.dir_pad - packed.dir_dim)).bfloat16()
        row["cublas_layers_ms"] = time_ms(lambda: run(pos_b, dir_b))
    log(f"mlp_fused {dtype_name}: kernel {row['ms']:.3f} ms "
        f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain {row['plain_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.3f} ms"
        + (f", cuBLAS bf16 layers {row['cublas_layers_ms']:.3f} ms" if "cublas_layers_ms" in row else ""))
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from nerftex_torch.instancing.scene import load_texture_channels
    from nerftex_torch.kernels import build, mlp_fused as fused, tex_gather
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils.util import instantiate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")

    # -- kernels vs plain --------------------------------------------------------
    inputs = np.load(os.path.join(ROOT, "tests", "torch_bench_inputs.npz"))
    params = {k[len("param/"):]: inputs[k] for k in inputs.files if k.startswith("param/")}
    channel = load_texture_channels(os.path.join(ROOT, "meshes", "smooth_checkerboard.png"))[0]
    rows = {"tex_fetch": check_tex(tex_gather, channel)}
    mlp = {}
    for name in ("bfloat16", "float32"):
        probe = instantiate(model_config("float32", compute_dtype=name), device="cuda")
        load_jax_params(probe, params)
        mlp[name] = check_mlp(fused, probe, name)
    # The main path runs the bf16 variant; the f32 one rides along in its row.
    rows["mlp_fused"] = dict(mlp["bfloat16"], float32_variant={
        k: mlp["float32"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")})

    # -- the bench frame -------------------------------------------------------
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    u_offset = inputs["u_offset"][None]

    def build_renderer(precision):
        model = instantiate(model_config(precision), device="cuda")
        load_jax_params(model, params)
        return instantiate(dict(renderer_config(precision), model=model, device="cuda"))

    # The golden frame was rendered on a TPU, where the slab test's and the
    # Fourier lift's f32 matmuls run at DEFAULT precision (bf16 operands);
    # the port reproduces that with matmul_precision="bfloat16".
    renderer = build_renderer("bfloat16")
    tex_gather.sample_channel.launches = 0
    fused.mlp_fused.launches = 0
    t0 = time.perf_counter()
    out = renderer(**data, u_offset=u_offset)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"tex_fetch": tex_gather.sample_channel.launches,
                "mlp_fused": fused.mlp_fused.launches}
    log(f"bench frame (first render {first_s:.2f} s): launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path did not launch {name}")
    psnr = golden_psnr(out)
    log(f"golden check: {psnr:.2f} dB (floor {GOLDEN_PSNR_DB})")
    if not psnr >= GOLDEN_PSNR_DB:
        raise AssertionError(f"bench frame diverged from golden: {psnr:.2f} dB")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = renderer(**data, u_offset=u_offset)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    rays_per_s = 512 * 512 / best
    log(f"bench frame: best of 3 warm renders {best * 1e3:.1f} ms -> {rays_per_s:.1f} rays/s "
        f"on {card}")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Informational: the same frame with every matmul operand in f32.
    f32_out = build_renderer("float32")(**data, u_offset=u_offset)
    log(f"golden check with float32 matmul operands: {golden_psnr(f32_out):.2f} dB (not gated)")

    kernels = [dict(row, launches=launches[name]) for name, row in rows.items()]
    log(json.dumps({"frame": {"rays_per_s": rays_per_s, "best_ms": best * 1e3,
                              "golden_psnr_db": psnr, "card": card}}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
