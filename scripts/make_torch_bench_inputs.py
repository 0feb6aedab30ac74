"""Write tests/torch_bench_inputs.npz, tests/torch_plush_inputs.npz,
tests/torch_grass_inputs.npz and tests/torch_grass_filtered_inputs.npz:
the JAX side of the bench, plush, grass and grass_filtered frames for the
PyTorch port.

Each frame depends on a ParamNerf's initial weights, which only JAX's PRNG
makes; the port draws every random number of a render itself
(nerftex_torch.utils.jax_rng reproduces JAX's draws for the same key).  The
bench file holds the carpet ParamNerf's weights as
scripts/bench_render.build initialises them:

  param/<layer>/<w|b>  the ParamNerf parameter tree, "/"-joined keys
                       (nerftex_torch.render.checkpoint.load_jax_params)

The plush, grass and grass_filtered files (configs/config_<scene>_render.py,
as scripts/bench_scene.py renders them for tests/golden_scene_<scene>.npz)
hold the scene's ParamNerf weights and its camera:

  param/<layer>/<w|b>  the ParamNerf parameter tree
  eye, target          float64 [3] camera position and look-at point
  angle                float64 field of view (GenerateData's focal is
                       width / tan(angle / 2) / 2, a Python float)
  parameters           float32 [P] the frame's parameter vector
  height, width        the frame size

The carpet and carpet10k configs initialise the bench file's weights
(``scene_inputs("carpet")`` and ``scene_inputs("carpet10k")`` equal
``bench_params()``: the same seed, init counter and ParamNerf), so their
frames load tests/torch_bench_inputs.npz and no file of their own is
written; ``main`` checks that they still agree.

``jax_u_offsets`` computes the per-ray offsets a JAX render draws, for
tests that hold the port's draws against them.

Run from the repo root:  JAX_PLATFORMS=cpu python scripts/make_torch_bench_inputs.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_bench_inputs.npz")
SCENE_OUT = os.path.join(ROOT, "tests", "torch_{}_inputs.npz")


def jax_u_offsets(key, n_rays: int, render_chunk: int, ray_block: int) -> np.ndarray:
    """The per-ray offsets that a JAX InstanceRenderer(sorted_blocks=True)
    call with ``key`` draws: Renderer.__call__ folds the chunk offset into the
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


def scene_inputs(scene: str) -> dict:
    """The ParamNerf parameters of configs/config_<scene>_render.py as
    scripts/bench_scene.py initialises them (config seed, init counter 0,
    bf16, after the test dataset), and the camera and parameter vector of
    that dataset's first item."""
    import importlib

    sys.path.insert(0, ROOT)
    import nerftex_tpu.models.mlp as mlp_mod
    from nerftex_tpu.utils import rng, util
    from nerftex_tpu.utils.util import EasyDict

    cfg = EasyDict(importlib.import_module(f"configs.config_{scene}_render").config)
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
    # origin; the first record is the frame bench_scene.py renders.  A
    # radius that is itself a distribution: the first record's camera.
    loader = cfg.test_dataset_config.data_loader_config
    record = ds.source[0]
    if isinstance(loader.radius, dict):
        eye = np.asarray(record["pose"][:3, 3], np.float64)
    else:
        eye = np.asarray(util.instantiate(loader.pose_dist_config)(), np.float64) * loader.radius
    out.update(eye=eye, target=np.zeros(3), angle=np.float64(loader.angle),
               parameters=np.asarray(record["parameters"], np.float32).reshape(-1),
               height=np.int64(ds.height), width=np.int64(ds.width))
    return out


def plush_inputs() -> dict:
    return scene_inputs("plush")


def grass_inputs() -> dict:
    return scene_inputs("grass")


def main():
    arrays = {f"param/{k}": v for k, v in bench_params().items()}
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} parameter arrays")
    for scene in ("carpet", "carpet10k"):
        inputs = scene_inputs(scene)
        if not all(np.array_equal(inputs[k], arrays[k]) for k in arrays):
            raise AssertionError(f"{scene}'s weights differ from the bench weights")
    for scene, make in (("plush", plush_inputs), ("grass", grass_inputs),
                        ("grass_filtered", lambda: scene_inputs("grass_filtered"))):
        inputs = make()
        np.savez_compressed(SCENE_OUT.format(scene), **inputs)
        print(f"wrote {SCENE_OUT.format(scene)}: "
              f"{sum(k.startswith('param/') for k in inputs)} parameter arrays, "
              f"camera at {inputs['eye'].tolist()}")


if __name__ == "__main__":
    main()
