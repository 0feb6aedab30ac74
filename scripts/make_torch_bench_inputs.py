"""Write tests/torch_bench_inputs.npz and tests/torch_plush_inputs.npz: the
JAX side of the bench frame and of the plush frame for the PyTorch port.

A bench frame (bench.py) depends on two things the port cannot make itself:
the carpet ParamNerf's initial weights (JAX's PRNG, as
scripts/bench_render.build initialises them) and the per-ray stratified
offsets that the timed render's key(1) draws.  This tool computes both with
the JAX package and stores them:

  param/<layer>/<w|b>  the ParamNerf parameter tree, "/"-joined keys
                       (nerftex_torch.render.checkpoint.load_jax_params)
  u_offset             [262144] float32 per-ray offsets of the 512x512 frame

The plush frame (configs/config_plush_render.py, as scripts/bench_scene.py
renders it for tests/golden_scene_plush.npz) needs the plush ParamNerf's
initial weights and its camera; the port draws the frame's random numbers
itself (nerftex_torch.utils.jax_rng), so no offsets are stored:

  param/<layer>/<w|b>  the plush ParamNerf parameter tree
  eye, target          float64 [3] camera position and look-at point
  angle                float64 field of view (GenerateData's focal is
                       width / tan(angle / 2) / 2, a Python float)
  parameters           float32 [P] the frame's parameter vector
  height, width        the frame size

Run from the repo root:  JAX_PLATFORMS=cpu python scripts/make_torch_bench_inputs.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_bench_inputs.npz")
PLUSH_OUT = os.path.join(ROOT, "tests", "torch_plush_inputs.npz")

# bench.py's frame: 512x512 rays in one render chunk, ray_block 1024.
BENCH_RAYS = 512 * 512
BENCH_RENDER_CHUNK = 262144
BENCH_RAY_BLOCK = 1024


def jax_u_offsets(key, n_rays: int, render_chunk: int, ray_block: int) -> np.ndarray:
    """The per-ray u_off that an InstanceRenderer(sorted_blocks=True) call
    with ``key`` draws: Renderer.__call__ folds the chunk offset into the
    key, render_rays splits off k_inst, and render_grid_sorted draws
    uniform((block,)) from split(fold_in(k_inst, block_idx))[0] for each
    ray block of the chunk (device.py _per_ray)."""
    import jax

    chunk = min(render_chunk, n_rays)
    out = []
    for i in range(0, n_rays, chunk):
        k_inst = jax.random.split(jax.random.fold_in(key, i))[0]
        block = min(ray_block, chunk)
        for idx in range(-(-chunk // block)):
            bk = jax.random.split(jax.random.fold_in(k_inst, idx))[0]
            out.append(np.asarray(jax.random.uniform(bk, (block,))))
    return np.concatenate(out)[:n_rays].astype(np.float32)


def _flat_params(model) -> dict:
    """A JAX model's parameter tree flattened to "/"-joined keys."""
    import jax

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model.params)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[name] = np.asarray(leaf, np.float32)
    return flat


def bench_params() -> dict:
    """The carpet ParamNerf parameters exactly as scripts/bench_render.build
    initialises them, flattened to "/"-joined keys."""
    sys.path.insert(0, ROOT)
    import nerftex_tpu.models.mlp as mlp_mod
    from nerftex_tpu.utils import rng, util
    from nerftex_tpu.utils.util import EasyDict

    rng.set_seed(0)
    mlp_mod._INIT_COUNTER[0] = 0
    model = util.instantiate(EasyDict({
        "module": "network.model.ParamNerf",
        "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 10},
        "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 4},
        "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 4},
        "n_parameters": [1, 6], "compute_dtype": "bfloat16"}))["model"]
    return _flat_params(model)


def plush_inputs() -> dict:
    """The plush ParamNerf's parameters as scripts/bench_scene.py plush
    initialises them (config seed 0, init counter 0, bf16, after the test
    dataset), and the camera and parameter vector of that dataset's first
    item."""
    import importlib

    sys.path.insert(0, ROOT)
    import nerftex_tpu.models.mlp as mlp_mod
    from nerftex_tpu.utils import rng, util
    from nerftex_tpu.utils.util import EasyDict

    cfg = EasyDict(importlib.import_module("configs.config_plush_render").config)
    rng.set_seed(cfg.seed)
    np.random.seed(cfg.seed)
    mlp_mod._INIT_COUNTER[0] = 0
    ds = util.instantiate(cfg.test_dataset_config)
    model_config = EasyDict(cfg.model_config)
    model_config.setdefault("n_parameters", ds.n_parameters)
    model_config["compute_dtype"] = "bfloat16"
    model = util.instantiate(model_config)["model"]
    out = {f"param/{k}": v for k, v in _flat_params(model).items()}

    # GenerateData places the camera at pose_dist() * radius, looking at the
    # origin; the first record is the frame bench_scene.py renders.
    loader = cfg.test_dataset_config.data_loader_config
    eye = np.asarray(util.instantiate(loader.pose_dist_config)(), np.float64) * loader.radius
    record = ds.source[0]
    out.update(eye=eye, target=np.zeros(3), angle=np.float64(loader.angle),
               parameters=np.asarray(record["parameters"], np.float32).reshape(-1),
               height=np.int64(ds.height), width=np.int64(ds.width))
    return out


def main():
    import jax

    arrays = {f"param/{k}": v for k, v in bench_params().items()}
    arrays["u_offset"] = jax_u_offsets(jax.random.key(1), BENCH_RAYS, BENCH_RENDER_CHUNK,
                                       BENCH_RAY_BLOCK)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays) - 1} parameter arrays, "
          f"{arrays['u_offset'].shape[0]} offsets")
    plush = plush_inputs()
    np.savez_compressed(PLUSH_OUT, **plush)
    print(f"wrote {PLUSH_OUT}: {sum(k.startswith('param/') for k in plush)} parameter arrays, "
          f"camera at {plush['eye'].tolist()}")


if __name__ == "__main__":
    main()
