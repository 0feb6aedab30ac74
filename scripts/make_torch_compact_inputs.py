"""Write tests/torch_compact_inputs.npz: the JAX package's compact-path
render of two 1,024-ray blocks of the bench frame, which chip_smoke.py's
compact phase holds the port's render of the same rays to on the card.

The frame is bench.py's (carpet, 512x512, 900 patches on the cloth mesh,
nearest picks, smooth_checkerboard.png, the carpet operating point: ray
block 1,024, max_hits 48, step cap 320, culls 448/384) with the bench
weights (tests/torch_bench_inputs.npz) in float32 (compute_dtype
"float32", float32 dots) and sample_budget_per_ray BUDGET, under key(1).
Ray blocks draw their offsets and picks by block index, so the batch keeps
blocks 128 and 150 of the frame at their indices among 151 blocks whose
other rays miss the scene (the layout of
tests/test_torch_render.py::test_bench_rays_match_tpu_golden).  Stored:

  rays           int64 [2048] the two blocks' ray indices in the frame
  color, alpha   float32 [2048, 3], [2048] JAX's render of those rays
  overflow       int64 [2] (dropped hits, dropped samples) of the render
  budget         the sample budget per ray

Run from the repo root (about two minutes of CPU):
    JAX_PLATFORMS=cpu python scripts/make_torch_compact_inputs.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_compact_inputs.npz")
BLOCKS = (128, 150)
BUDGET = 32


def frame_inputs():
    """The bench frame's rays with every ray outside BLOCKS replaced by one
    that misses the scene, cut after the last of BLOCKS; and the indices
    of the kept rays."""
    from nerftex_torch.ops.rays import frame_rays

    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    sel = np.concatenate([np.arange(b * 1024, (b + 1) * 1024) for b in BLOCKS])
    n = (max(BLOCKS) + 1) * 1024
    sub = {"parameters": data["parameters"],
           "rays_o": np.broadcast_to(np.float32([0, 0, 50.0]), (1, n, 3)).copy(),
           "rays_d": np.broadcast_to(np.float32([0, 0, 1.0]), (1, n, 3)).copy(),
           "t": np.full((1, n, 2), np.inf, np.float32),
           "cone_scale": np.zeros((1, n, 1), np.float32)}
    for k in ("rays_o", "rays_d", "t", "cone_scale"):
        sub[k][:, sel] = data[k][:, sel]
    return sub, sel


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    os.chdir(ROOT)
    import jax

    import chip_smoke
    from nerftex_tpu.render.instance_renderer import InstanceRenderer
    from nerftex_tpu.utils import util

    # The bench weights are the JAX factory's for seed 0 and init counter 0
    # (scripts/make_torch_bench_inputs.py bench_params); checked leaf by
    # leaf against the file.
    import nerftex_tpu.models.mlp as mlp_mod
    from nerftex_tpu.utils import rng
    from make_torch_bench_inputs import _flat_params

    rng.set_seed(0)
    mlp_mod._INIT_COUNTER[0] = 0
    ff = {"module": "network.model.FourierFeatures"}
    model = util.instantiate(util.EasyDict({
        "module": "network.model.ParamNerf", "pos_embedding": dict(ff, n_freq_bands=10),
        "dir_embedding": dict(ff, n_freq_bands=4), "param_embedding": dict(ff, n_freq_bands=4),
        "n_parameters": [1, 6], "compute_dtype": "float32"}))["model"]
    inputs = np.load(os.path.join(ROOT, "tests", "torch_bench_inputs.npz"))
    for name, leaf in _flat_params(model).items():
        if not np.array_equal(np.asarray(leaf), inputs[f"param/{name}"]):
            raise AssertionError(f"{name} differs from tests/torch_bench_inputs.npz")
    cfg = dict(chip_smoke.renderer_config("float32"), sample_budget_per_ray=BUDGET, model=model)
    # The JAX instancer has no matmul_precision: its dots are float32 on the CPU.
    cfg["instancer_config"] = dict(cfg["instancer_config"])
    del cfg["instancer_config"]["matmul_precision"]
    renderer = util.instantiate(util.EasyDict(cfg))
    assert isinstance(renderer, InstanceRenderer)
    sub, sel = frame_inputs()
    drops = []
    real = InstanceRenderer._report_diagnostics

    def report(self, out):
        drops.append((int(out.get("_overflow_hits", 0)), int(out.get("_overflow_steps", 0))))
        return real(self, out)

    InstanceRenderer._report_diagnostics = report
    out = renderer(**sub, training=False, key=jax.random.key(1))
    color = np.asarray(out["color_pred"])[0, sel].astype(np.float32)
    alpha = np.asarray(out["alpha_pred"])[0, sel].astype(np.float32)
    rest = np.asarray(out["alpha_pred"])[0, np.setdiff1d(np.arange(sub["t"].shape[1]), sel)]
    if rest.any() or not alpha.max() > 0.5 or len(drops) != 1:
        raise AssertionError(f"unexpected render: alpha max {alpha.max()}, rest {rest.max()}, "
                             f"drops {drops}")
    np.savez_compressed(OUT, rays=sel.astype(np.int64), color=color, alpha=alpha,
                        overflow=np.asarray(drops[0], np.int64), budget=np.int64(BUDGET))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): alpha mean {alpha.mean():.4f}, "
          f"dropped (hits, samples) {drops[0]}")


if __name__ == "__main__":
    main()
