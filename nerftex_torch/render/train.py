"""The training loop (counterpart of nerftex_tpu/render/train.py, its
host-fed path).

One step renders the batch differentiably (``Renderer.apply``: the models'
plain forward on autograd and cuBLAS), takes the loss, backpropagates and
applies Adam: the JAX step's ``value_and_grad`` plus optax Adam.  Adam
takes betas (0.9, 0.999) and eps 1e-7 (keras's, as the JAX package), with
the learning rate of optax's non-staircase exponential decay,
``lrate * 0.1 ** (count / (lrate_decay * 1e3))``, where ``count`` is the
number of updates already done.  Step s renders under
``fold_in(stream_key(STREAM_PERTURB), s)`` and its batch is the s-th of
``train_dataset.take``, so the same seed gives the JAX package's batches
and draws.

The JAX package's device-resident path (``device_resident``,
``steps_per_dispatch > 1``, ``flat_params``, and the renderer's
``net_chunk_unroll`` and ``cast_params_once``) comes with a later slice
and raises here.
"""

import torch

from nerftex_torch.models.mlp import model_dict
from nerftex_torch.render.renderer import DEFERRED
from nerftex_torch.utils import jax_rng, rng, util
from nerftex_torch.utils.util import EasyDict, resolve_device


class TrainState:
    """Mutable holder the Logger checkpoints: the optimizer and the step."""

    def __init__(self):
        self.optimizer = None
        self.step = 0


def learning_rate(lrate: float, lrate_decay: float, count: int) -> float:
    """The rate of the update after ``count`` updates."""
    if lrate_decay > 0:
        return lrate * 0.1 ** (count / (lrate_decay * 1e3))
    return lrate


def update_count(optimizer) -> int:
    """Updates the optimizer has applied (its state's step)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            return int(optimizer.state.get(p, {}).get("step", 0))
    return 0


def make_optimizer(params, lrate: float, lrate_decay: float) -> torch.optim.Adam:
    """Adam as the JAX package's ``make_optimizer``; its ``schedule(count)``
    is the rate of the update after ``count`` updates (optimizer_step sets
    it before each update)."""
    optimizer = torch.optim.Adam(list(params), lr=lrate, betas=(0.9, 0.999), eps=1e-7)
    optimizer.schedule = lambda count: learning_rate(lrate, lrate_decay, count)
    return optimizer


def optimizer_step(optimizer) -> None:
    """Apply the gradients at the scheduled rate of this update."""
    for group in optimizer.param_groups:
        group["lr"] = optimizer.schedule(update_count(optimizer))
    optimizer.step()


def make_train_step(renderer, loss_fn, optimizer, composite_bkgd, bkgd_color):
    """The update: step(batch, key) -> loss (a 0-d tensor on the device).
    batch holds tensors on the renderer's device."""

    def step(batch: dict, key) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        pred = renderer.apply(batch, key, composite_bkgd=composite_bkgd, bkgd_color=bkgd_color,
                              training=True)
        loss = loss_fn(color_true=batch.get("color"), alpha_true=batch.get("alpha"), **pred)
        loss.backward()
        optimizer_step(optimizer)
        return loss.detach()

    return step


def build_step(train_dataset_config: EasyDict, model_config: EasyDict, loss_config: EasyDict,
               lrate: float, lrate_decay: float, renderer_config: EasyDict, device,
               state: TrainState):
    """Train's set-up of the update: the training dataset (its sampler reads
    the step from ``state``), the models, the renderer, Adam (kept in
    ``state.optimizer``) and the step.  Returns (train_dataset, models,
    renderer, train_step)."""
    train_dataset_config = EasyDict(train_dataset_config)
    train_dataset_config.update({"step": state})
    train_dataset = util.instantiate(train_dataset_config)

    model_config = EasyDict(model_config)
    model_config.setdefault("n_parameters", train_dataset.n_parameters)
    models = model_dict(util.instantiate(model_config, device=device))
    for model in models.values():
        model.summary()

    renderer_config = EasyDict(renderer_config)
    renderer_config.update(models)
    renderer = util.instantiate(renderer_config, device=device)
    loss_fn = util.instantiate(loss_config)
    state.optimizer = make_optimizer((p for m in models.values() for p in m.parameters()),
                                     lrate, lrate_decay)
    train_step = make_train_step(renderer, loss_fn, state.optimizer,
                                 train_dataset.composite_bkgd, train_dataset.bkgd_color)
    return train_dataset, models, renderer, train_step


def Train(
    target_path: str,
    train_dataset_config: EasyDict,
    val_dataset_config: EasyDict,
    model_config: EasyDict,
    loss_config: EasyDict,
    n_iters: int,
    lrate: float,
    lrate_decay: float,
    renderer_config: EasyDict,
    logger_config: EasyDict,
    steps_per_dispatch: int = 1,
    flat_params: bool = False,
    device=None,
    **kwargs,
) -> dict:
    """Set up and run supervised training; returns the models.  device:
    where the models train (CUDA unless given)."""
    if int(steps_per_dispatch) > 1:
        raise NotImplementedError(f"steps_per_dispatch > 1 comes with {DEFERRED}")
    if flat_params:
        raise NotImplementedError(f"flat_params comes with {DEFERRED}")
    device = resolve_device(device)
    state = TrainState()
    train_dataset, models, renderer, train_step = build_step(
        train_dataset_config, model_config, loss_config, lrate, lrate_decay, renderer_config,
        device, state)
    val_dataset = util.instantiate(val_dataset_config)

    # The Logger restores the models, the optimizer and the step from the
    # latest checkpoint if there is one.
    logger_config = EasyDict(logger_config)
    logger_config.update({
        "target_path": target_path,
        "checkpoint_variables": dict(models, state=state),
        "dataset": val_dataset,
        "renderer": renderer,
        "n_iters": n_iters,
    })
    logger = util.instantiate(logger_config)

    base_key = rng.stream_key(rng.STREAM_PERTURB)
    for data in train_dataset.take(int(n_iters) - logger.step):
        key = jax_rng.fold_in(base_key, logger.step)
        batch = {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in data.items()}
        loss = train_step(batch, key)
        state.step = logger.step + 1
        logger({"Loss": loss})
    return models
