"""Write tests/torch_grass_mip_inputs.npz: the JAX side of the mip paths at
full width for the PyTorch port (chip_smoke.py's mip phase, which has no
JAX).

configs/demo_grass_mip_train.py's model (ParamNerf 8 x 256, f32,
IntegratedPositionalEncoding with 10 bands on n_pos 6, n_parameters
[1, 3]), MipRenderer, loss, batch shape and Adam schedule, on a synthetic
TFRecord with the dataset's 5 parameters (nerftex_tpu.tools.synth, 32
swatches of 64x64, n_parameters (2, 3), seed 0) in place of the Blender
swatches:

  digest/<layer>/<w|b>   sha256 of the float32 bytes of each leaf of the
                         JAX factory's init under seed 0 (the port's init
                         must reproduce it: no weights are stored)
  batch<s>/<name>        the s-th training batch of the JAX Dataset (4 images
                         x 256 Proxy rays), s = 0 .. K - 1
  loss                   float32 [K]: the loss of step s under
                         fold_in(stream_key(STREAM_PERTURB), s), each after
                         the Adam updates of the steps before it
  grad/<layer>/<w|b>     the gradient of step 0
  imp/loss               the same K losses with
                         configs/demo_grass_mip_imp_train.py's renderer (256
                         importance posts, mip_importance) on the same batches
  imp/grad/<leaf>        its step-0 gradient of IMP_LEAVES
  frame/<name>           configs/demo_grass_mip_render.py's first camera
                         (radius 20) at 64x64: rays_o, rays_d, t, cone_scale,
                         parameters, and the JAX MipInstanceRenderer's
                         color and alpha with the init weights under
                         stream_key(STREAM_PERTURB, 0); overflow, its
                         (dropped hits, dropped samples)
  frame2/<name>          the same for a second camera of the render config,
                         its pose and angle at radius FRAME2_RADIUS, where
                         the grass fills most of the frame (the first
                         camera's draws 4.2 % of its rays)
  sweep/overflow         int64 [5, 2]: the same per frame of the render
                         config's own sweep (five 256x256 frames, radius 20
                         down to 5, frame i under stream_key(STREAM_PERTURB,
                         i) as the JAX package's Render draws it), rendered with a
                         depth-1, width-16 model: what the instancer drops
                         does not depend on the model

The steps run jitted with remat_net_chunks=True (value- and
gradient-identical to the config's False, one net_chunk of activations at
a time).

Run from the repo root:  JAX_PLATFORMS=cpu python scripts/make_torch_mip_inputs.py
With ``--frame2`` it adds (or rewrites) only the frame2/ arrays of an
existing file and keeps every other array as it is.
"""

import copy
import hashlib
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_grass_mip_inputs.npz")
K = 3
N_IMAGES, SIZE = 32, 64
FRAME_SIZE = 64
FRAME2_RADIUS = 2.5
IMP_LEAVES = ("trunk/0/w", "trunk/7/w", "alpha/w", "color_layers/0/w", "color/w")


def flatten_params(tree: dict) -> dict:
    """{"trunk/0/w": array, ...}: the "/"-joined keys of a ParamNerf tree."""
    flat = {}
    for key, value in tree.items():
        if isinstance(value, list):
            for i, layer in enumerate(value):
                for name in ("w", "b"):
                    flat[f"{key}/{i}/{name}"] = np.asarray(layer[name])
        else:
            for name in ("w", "b"):
                flat[f"{key}/{name}"] = np.asarray(value[name])
    return flat


def leaf_digest(a) -> np.ndarray:
    """sha256 of a leaf's float32 bytes (C order) as uint8 [32]."""
    data = np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()
    return np.frombuffer(hashlib.sha256(data).digest(), np.uint8)


def record_drops(renderer) -> list:
    """A list that gets each call's (dropped hits, dropped samples) as the
    renderer reports them."""
    drops = []
    real = renderer._report_diagnostics

    def report(out):
        drops.append((int(out.get("_overflow_hits", 0)), int(out.get("_overflow_steps", 0))))
        real(out)

    renderer._report_diagnostics = report
    return drops


def jax_frame(render_stock, model, prefix, radius=None) -> dict:
    """The render config's first camera (at ``radius``, if given) at
    FRAME_SIZE^2 through the JAX MipInstanceRenderer with ``model`` under
    stream_key(STREAM_PERTURB, 0): <prefix>/ rays, color, alpha and
    overflow."""
    from nerftex_tpu.utils import rng, util

    rcfg = copy.deepcopy(render_stock)
    loader = rcfg["test_dataset_config"]["data_loader_config"]
    loader.update(height=FRAME_SIZE, width=FRAME_SIZE)
    if radius is not None:
        loader["radius"] = radius
    rng.set_seed(rcfg["seed"])
    data = next(iter(util.instantiate(util.EasyDict(rcfg["test_dataset_config"]))))
    renderer = util.instantiate(util.EasyDict(dict(rcfg["renderer_config"], model=model)))
    drops = record_drops(renderer)
    frame = renderer(**data, training=False, key=rng.stream_key(rng.STREAM_PERTURB, 0))
    out = {f"{prefix}/overflow": np.asarray(drops[0], np.int64)}
    for k in ("rays_o", "rays_d", "t", "cone_scale", "parameters"):
        out[f"{prefix}/{k}"] = np.asarray(data[k], np.float32)
    out[f"{prefix}/color"] = np.asarray(frame["color_pred"], np.float32)
    out[f"{prefix}/alpha"] = np.asarray(frame["alpha_pred"], np.float32)
    print(f"{prefix}: alpha mean {out[f'{prefix}/alpha'].mean():.4f}, "
          f"{(out[f'{prefix}/alpha'] > 0.01).mean():.3f} of the rays drawn, dropped (hits, "
          f"samples) {drops[0]}", flush=True)
    return out


def add_frame2() -> None:
    """Rewrite OUT with its frame2/ arrays (re)computed and every other
    array as it was."""
    sys.path.insert(0, ROOT)
    import nerftex_tpu.models.mlp as jax_mlp
    from configs.demo_grass_mip_render import config as render_stock
    from configs.demo_grass_mip_train import config as stock
    from nerftex_tpu.utils import rng, util

    with np.load(OUT) as f:
        out = {k: f[k] for k in f.files if not k.startswith("frame2/")}
    rng.set_seed(stock["seed"])
    jax_mlp._INIT_COUNTER[0] = 0
    model = util.instantiate(util.EasyDict(copy.deepcopy(stock["model_config"])))["model"]
    import jax

    for k, v in flatten_params(jax.tree.map(np.asarray, model.params)).items():
        if not np.array_equal(leaf_digest(v), out[f"digest/{k}"]):
            raise AssertionError(f"the init's {k} is not the one the file holds")
    out.update(jax_frame(render_stock, model, "frame2", radius=FRAME2_RADIUS))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import nerftex_tpu.models.mlp as jax_mlp
    from configs.demo_grass_mip_imp_train import config as imp_stock
    from configs.demo_grass_mip_render import config as render_stock
    from configs.demo_grass_mip_train import config as stock
    from nerftex_tpu.render.train import make_optimizer, make_train_step
    from nerftex_tpu.tools.synth import make_synthetic_tfrecord
    from nerftex_tpu.utils import rng, util

    cfg = copy.deepcopy(stock)
    out = {}
    proxy = cfg["train_dataset_config"]["proxy_config"]
    with tempfile.TemporaryDirectory() as tmp:
        tfr = os.path.join(tmp, "train.tfr")
        make_synthetic_tfrecord(tfr, n_images=N_IMAGES, size=SIZE, seed=0, n_parameters=(2, 3),
                                b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
        cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
        cfg["train_dataset_config"]["prefetch"] = 0
        rng.set_seed(cfg["seed"])
        jax_mlp._INIT_COUNTER[0] = 0
        dataset = util.instantiate(util.EasyDict(cfg["train_dataset_config"]))
        batches = list(dataset.take(K))
    model = util.instantiate(util.EasyDict(cfg["model_config"]))["model"]
    params0 = {"model": model.params}
    for k, v in flatten_params(jax.tree.map(np.asarray, model.params)).items():
        out[f"digest/{k}"] = leaf_digest(v)
    for s, data in enumerate(batches):
        for k, v in data.items():
            out[f"batch{s}/{k}"] = np.asarray(v, np.float32)
    loss_fn = util.instantiate(util.EasyDict(cfg["loss_config"]))
    base = rng.stream_key(rng.STREAM_PERTURB)

    def run(renderer_config, prefix):
        renderer = util.instantiate(util.EasyDict(dict(renderer_config, model=model,
                                                       remat_net_chunks=True)))
        optimizer = make_optimizer(cfg["lrate"], cfg["lrate_decay"])
        params = params0
        opt_state = optimizer.init(params)

        def loss_of(p, batch, key):
            pred = renderer.apply(p, batch, key, composite_bkgd=dataset.composite_bkgd,
                                  bkgd_color=dataset.bkgd_color, training=True)
            return loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)

        step = make_train_step(renderer, loss_fn, optimizer, dataset.composite_bkgd,
                               dataset.bkgd_color, donate=False)
        losses, grads = [], None
        for s, data in enumerate(batches):
            batch = {k: jnp.asarray(v) for k, v in data.items()}
            key = jax.random.fold_in(base, s)
            if s == 0:
                g = jax.jit(jax.grad(loss_of))(params, batch, key)
                grads = flatten_params(jax.tree.map(np.asarray, g["model"]))
            params, opt_state, loss = step(params, opt_state, batch, key)
            losses.append(float(loss))
            print(f"{prefix or 'mip'} step {s}: loss {losses[-1]:.8f}", flush=True)
        return np.asarray(losses, np.float32), grads

    out["loss"], grads = run(cfg["renderer_config"], "")
    for k, v in grads.items():
        out[f"grad/{k}"] = v
    out["imp/loss"], grads = run(imp_stock["renderer_config"], "imp")
    for k in IMP_LEAVES:
        out[f"imp/grad/{k}"] = grads[k]

    out.update(jax_frame(render_stock, model, "frame"))
    out.update(jax_frame(render_stock, model, "frame2", radius=FRAME2_RADIUS))

    # The sweep's drops at the render config's own settings.
    rcfg = copy.deepcopy(render_stock)
    rcfg["model_config"].update(depth=1, width=16, skips=[])
    rng.set_seed(rcfg["seed"])
    jax_mlp._INIT_COUNTER[0] = 0
    small = util.instantiate(util.EasyDict(rcfg["model_config"]))["model"]
    renderer = util.instantiate(util.EasyDict(dict(rcfg["renderer_config"], model=small)))
    drops = record_drops(renderer)
    for i, item in enumerate(util.instantiate(util.EasyDict(rcfg["test_dataset_config"]))):
        renderer(**item, training=False, key=rng.stream_key(rng.STREAM_PERTURB, i))
        print(f"sweep frame {i}: dropped (hits, samples) {drops[-1]}", flush=True)
    out["sweep/overflow"] = np.asarray(drops, np.int64)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 2**20:.2f} MiB)")


if __name__ == "__main__":
    if sys.argv[1:] == ["--frame2"]:
        add_frame2()
    else:
        main()
