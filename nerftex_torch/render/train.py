"""The training loop (counterpart of nerftex_tpu/render/train.py).

One step renders the batch differentiably (``Renderer.apply``: the models'
plain forward on autograd and cuBLAS), takes the loss, backpropagates and
applies Adam: the JAX step's ``value_and_grad`` plus optax Adam.  Adam
takes betas (0.9, 0.999) and eps 1e-7 (keras's, as the JAX package), with
the learning rate of optax's non-staircase exponential decay,
``lrate * 0.1 ** (count / (lrate_decay * 1e3))``, where ``count`` is the
number of updates already done.  Step s renders under
``fold_in(stream_key(STREAM_PERTURB), s)``.

Two paths, as in the JAX package:

- host-fed: step s's batch is the s-th of ``train_dataset.take`` (host
  numpy, copied to the card), so the same seed gives the JAX package's
  batches and draws;
- device-resident (``device_resident`` on the train dataset, which then
  has a ``device_sampler``): ``FusedStep`` samples step s's batch on the
  card from ``fold_in(stream_key(STREAM_DATA), s)`` (the JAX package's
  ``make_fused_train_step``).  The step index, the keys and the learning
  rate are tensors on the card, and each step advances them there.  On
  CUDA the whole step (sampling, forward, backward, Adam with
  ``capturable=True``) is captured once as a CUDA graph and replayed;
  ``steps_per_dispatch`` K replays it K times into a [K] loss buffer that
  the host reads once per chunk (``make_fused_multi_step``), each chunk
  clipped to the next validation or checkpoint step.  On the CPU the same
  step runs eagerly.

``flat_params`` gives each model one flat float32 parameter in the JAX
package's ``ravel_pytree`` order, its layers' weights and biases views into
it, so Adam updates one tensor per model (``apply_flat_param_space``).
"""

import math

import torch

from nerftex_torch.models.mlp import model_dict
from nerftex_torch.render.checkpoint import jax_flat_layout
from nerftex_torch.utils import jax_rng, rng, trace, util
from nerftex_torch.utils.debug import check_finite, debug_checks_enabled
from nerftex_torch.utils.util import EasyDict, resolve_device

# Device-resident steps of this process: graph captures, graph replays,
# the discarded warm-up runs before each capture, and steps run eagerly.
step_counts = dict.fromkeys(("captures", "graph_replays", "warmup_runs", "eager_steps"), 0)


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
            count = optimizer.state.get(p, {}).get("step", 0)
            if isinstance(count, torch.Tensor) and count.device.type != "cpu":
                with trace.host_read("update_count"):
                    return int(count)
            return int(count)
    return 0


def make_optimizer(params, lrate: float, lrate_decay: float,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam as the JAX package's ``make_optimizer``; its ``schedule(count)``
    is the rate of the update after ``count`` updates (optimizer_step sets
    it before each update).  capturable (CUDA parameters): the rate is a
    tensor on the card that FusedStep sets there, and the state's step
    counts on the card, so a CUDA graph can capture the update."""
    params = list(params)
    if capturable:
        lr = torch.tensor(lrate, dtype=torch.float32, device=params[0].device)
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-7,
                                     capturable=True, foreach=True)
    else:
        optimizer = torch.optim.Adam(params, lr=lrate, betas=(0.9, 0.999), eps=1e-7)
    optimizer.schedule = lambda count: learning_rate(lrate, lrate_decay, count)
    optimizer.lrate, optimizer.lrate_decay = float(lrate), float(lrate_decay)
    return optimizer


def optimizer_step(optimizer) -> None:
    """Apply the gradients at the scheduled rate of this update."""
    for group in optimizer.param_groups:
        group["lr"] = optimizer.schedule(update_count(optimizer))
    optimizer.step()


def make_train_step(renderer, loss_fn, optimizer, composite_bkgd, bkgd_color):
    """The host-fed update: step(batch, key) -> loss (a 0-d tensor on the
    device).  batch holds tensors on the renderer's device."""

    @trace.span("train.step")
    def step(batch: dict, key) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        with trace.span("step.forward"):
            pred = renderer.apply(batch, key, composite_bkgd=composite_bkgd,
                                  bkgd_color=bkgd_color, training=True)
        with trace.span("step.loss"):
            loss = loss_fn(color_true=batch.get("color"), alpha_true=batch.get("alpha"), **pred)
        with trace.span("step.backward"):
            loss.backward()
        with trace.span("step.optimizer"):
            optimizer_step(optimizer)
        return loss.detach()

    return step


def apply_flat_param_space(models: dict) -> None:
    """Give each model one flat float32 ``nn.Parameter`` (``model.flat``)
    holding its weights and biases in the JAX package's ``ravel_pytree``
    order (render/checkpoint.py ``jax_flat_layout``), and make each
    layer's weight and bias a view into it: an optimizer over
    ``model.parameters()`` then updates one tensor per model, and the model,
    the renderer and the checkpoints work on the views unchanged.  The
    values, and so every step, are those of the per-layer parameters.  Run
    it once the models are on their device (moving a model afterwards
    would move the flat parameter and leave the views behind); a model
    that already has its flat parameter is left as it is."""
    for model in models.values():
        if getattr(model, "flat", None) is not None:
            continue
        layout = jax_flat_layout(model)
        with torch.no_grad():
            flat = torch.nn.Parameter(torch.cat([
                (layer.weight.t() if leaf == "w" else layer.bias).reshape(-1)
                for _, leaf, layer, _, _ in layout]))
        for _, leaf, layer, _, _ in layout:
            del layer._parameters["weight" if leaf == "w" else "bias"]
        model.register_parameter("flat", flat)
        for _, leaf, layer, offset, shape in layout:
            view = flat[offset:offset + math.prod(shape)].view(shape)
            # JAX keeps w as [in, out]: nn.Linear's [out, in] is its transpose.
            setattr(layer, "weight" if leaf == "w" else "bias", view.t() if leaf == "w" else view)
        model.drop_packed()


class FusedStep:
    """The device-resident step (the JAX package's ``make_fused_train_step``
    and ``make_fused_multi_step``): step s samples its batch from
    ``sampler`` under ``fold_in(stream_key(STREAM_DATA), s)``, renders
    under ``fold_in(stream_key(STREAM_PERTURB), s)``, backpropagates the
    loss and applies Adam at the scheduled rate of its update count.

    ``run(start, k)`` takes steps start .. start + k - 1 and returns their
    losses (one read to the host).  On CUDA the first run captures the step
    as a CUDA graph: it warms up once on a side stream, puts every
    parameter, Adam state, counter and buffer back as it was, captures,
    and from then on only replays.  A failed capture raises: nothing runs
    the step eagerly on the card, but under NERFTEX_DEBUG_NANS
    (utils/debug.py), whose checks a capture refuses.  On the CPU each step
    runs eagerly.  The tracer (utils/trace.py) sees a capture as the span
    ``train.capture`` and each replay's launch as a span ``train.launch``,
    and counts each run's steps as ``train.replays`` or ``train.eager``,
    beside ``step_counts``.
    ``_loss`` is the part of the step between sampling and Adam, which the
    data-parallel step (parallel/mesh.py) replaces."""

    def __init__(self, renderer, loss_fn, optimizer, sampler, composite_bkgd, bkgd_color,
                 lrate: float, lrate_decay: float, max_steps: int = 1):
        self.renderer = renderer
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.sampler = sampler
        self.composite_bkgd = composite_bkgd
        self.lrate = float(lrate)
        self.lrate_decay = float(lrate_decay)
        self.device = device = sampler.device
        self.bkgd_color = torch.as_tensor(bkgd_color, dtype=torch.float32, device=device)
        self.data_key = rng.stream_key(rng.STREAM_DATA).to(device)
        self.perturb_key = rng.stream_key(rng.STREAM_PERTURB).to(device)
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = torch.zeros(max(1, int(max_steps)), dtype=torch.float32, device=device)
        self.slot = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = None
        self.capturable = device.type == "cuda"
        if self.capturable and not optimizer.defaults["capturable"]:
            raise ValueError("the step on CUDA needs make_optimizer(..., capturable=True)")

    def _params(self):
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _init_adam_state(self) -> None:
        """Adam's state as its first update creates it, where missing (a
        restored state stays): the update count is there to schedule from."""
        for p in self._params():
            state = self.optimizer.state[p]
            if not state:
                state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device)
                                 if self.capturable else torch.tensor(0.0))
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _set_lr(self) -> None:
        count = self.optimizer.state[self._params()[0]]["step"]
        for group in self.optimizer.param_groups:
            if not self.capturable:
                group["lr"] = learning_rate(self.lrate, self.lrate_decay, int(count))
            elif self.lrate_decay > 0:
                group["lr"].copy_(torch.pow(0.1, count.double() / (self.lrate_decay * 1e3))
                                  * self.lrate)

    def _body(self) -> None:
        """One step; its loss goes to losses[slot]; slot and step advance."""
        s = self.step
        batch = self.sampler.sample_from(self.sampler.tables,
                                         jax_rng.fold_in(self.data_key, s))
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(batch, jax_rng.fold_in(self.perturb_key, s))
        self._set_lr()
        self.optimizer.step()
        self.losses.index_copy_(0, self.slot.view(1), loss.view(1))
        self.slot += 1
        self.step += 1

    def _loss(self, batch: dict, key) -> torch.Tensor:
        """The batch's loss (detached), its gradient in the parameters."""
        pred = self.renderer.apply(batch, key, composite_bkgd=self.composite_bkgd,
                                   bkgd_color=self.bkgd_color, training=True)
        loss = self.loss_fn(color_true=batch["color"], alpha_true=batch["alpha"], **pred)
        loss.backward()
        return loss.detach()

    def _state_tensors(self):
        """Every tensor a step updates in place."""
        tensors = self._params() + [self.step, self.slot, self.losses]
        for p in self._params():
            tensors += [t for t in self.optimizer.state[p].values()
                        if isinstance(t, torch.Tensor)]
        return tensors + [g["lr"] for g in self.optimizer.param_groups
                          if isinstance(g["lr"], torch.Tensor)]

    @trace.span("train.capture")
    def _capture(self) -> None:
        tensors = self._state_tensors()
        with torch.no_grad():
            saved = [t.detach().clone() for t in tensors]
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        step_counts["warmup_runs"] += 1
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._body()
        self.graph = graph
        step_counts["captures"] += 1

    @trace.span("train.replay")
    def run(self, start: int, k: int) -> torch.Tensor:
        """Steps start .. start + k - 1 (k at most max_steps); their losses
        [k] on the host."""
        if not 1 <= k <= self.losses.shape[0]:
            raise ValueError(f"{k} steps in one dispatch; this step holds {self.losses.shape[0]}")
        self._init_adam_state()
        self.step.fill_(int(start))
        self.slot.zero_()
        if self.capturable and not debug_checks_enabled():
            if self.graph is None:
                self._capture()
            for _ in range(k):
                with trace.span("train.launch"):
                    self.graph.replay()
            step_counts["graph_replays"] += k
            trace.count("train.replays", k)
        else:
            for _ in range(k):
                self._body()
            step_counts["eager_steps"] += k
            trace.count("train.eager", k)
        with trace.host_read("losses"):
            return self.losses[:k].cpu()


def build_step(train_dataset_config: EasyDict, model_config: EasyDict, loss_config: EasyDict,
               lrate: float, lrate_decay: float, renderer_config: EasyDict, device,
               state: TrainState, flat_params: bool = False, steps_per_dispatch: int = 1):
    """Train's set-up of the update: the training dataset (its sampler reads
    the step from ``state``; with ``device_resident`` it holds the data on
    ``device``), the models (``flat_params``: one flat parameter each), the
    renderer, Adam (kept in ``state.optimizer``) and the step: a FusedStep
    of up to ``steps_per_dispatch`` steps per run where the dataset has a
    device sampler, else the host-fed step.  Returns (train_dataset,
    models, renderer, train_step)."""
    device = torch.device(device)
    train_dataset_config = EasyDict(train_dataset_config)
    train_dataset_config.update({"step": state})
    if train_dataset_config.get("device_resident"):
        train_dataset_config["device"] = device
    train_dataset = util.instantiate(train_dataset_config)
    sampler = getattr(train_dataset, "device_sampler", None)

    model_config = EasyDict(model_config)
    model_config.setdefault("n_parameters", train_dataset.n_parameters)
    models = model_dict(util.instantiate(model_config, device=device))
    for model in models.values():
        model.summary()
    if flat_params:
        apply_flat_param_space(models)

    renderer_config = EasyDict(renderer_config)
    renderer_config.update(models)
    renderer = util.instantiate(renderer_config, device=device)
    loss_fn = util.instantiate(loss_config)
    state.optimizer = make_optimizer((p for m in models.values() for p in m.parameters()),
                                     lrate, lrate_decay,
                                     capturable=sampler is not None and device.type == "cuda")
    if sampler is not None:
        train_step = FusedStep(renderer, loss_fn, state.optimizer, sampler,
                               train_dataset.composite_bkgd, train_dataset.bkgd_color, lrate,
                               lrate_decay, max_steps=steps_per_dispatch)
    else:
        train_step = make_train_step(renderer, loss_fn, state.optimizer,
                                     train_dataset.composite_bkgd, train_dataset.bkgd_color)
    return train_dataset, models, renderer, train_step


def dispatch_sizes(start: int, end: int, steps_per_dispatch: int, cadences) -> list:
    """The device-resident run's chunks from step ``start`` to ``end``: at
    most steps_per_dispatch steps each, each ending at or before the next
    multiple of every cadence (the Logger's i_img and i_checkpoint), so
    the Logger crosses each of those steps at the end of a chunk."""
    sizes = []
    step = start
    while step < end:
        k = min(int(steps_per_dispatch), end - step)
        for c in cadences:
            if c > 0:
                k = min(k, c - step % c)
        sizes.append(k)
        step += k
    return sizes


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
    where the models train (CUDA unless given).  steps_per_dispatch counts
    the device-resident path's steps per dispatch (the host-fed path takes
    one step at a time whatever it says, as the JAX package's does); the
    Logger's i_trace needs it at 1 there."""
    device = resolve_device(device)
    steps_per_dispatch = max(1, int(steps_per_dispatch))
    state = TrainState()
    train_dataset, models, renderer, train_step = build_step(
        train_dataset_config, model_config, loss_config, lrate, lrate_decay, renderer_config,
        device, state, flat_params=flat_params, steps_per_dispatch=steps_per_dispatch)
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

    if isinstance(train_step, FusedStep):
        if steps_per_dispatch > 1 and logger.i_trace > 0:
            raise ValueError("i_trace traces single steps: it needs steps_per_dispatch = 1")
        step = logger.step
        for k in dispatch_sizes(step, int(n_iters), steps_per_dispatch,
                                (logger.i_img, logger.i_checkpoint)):
            losses = train_step.run(step, k)
            check_finite(f"training steps {step}-{step + k - 1}", loss=losses)
            for model in models.values():
                model.drop_packed()
            for loss in losses:
                state.step = logger.step + 1
                logger({"Loss": loss})
            step += k
        return models

    base_key = rng.stream_key(rng.STREAM_PERTURB)
    for data in train_dataset.take(int(n_iters) - logger.step):
        key = jax_rng.fold_in(base_key, logger.step)
        with trace.span("train.copy"):
            batch = {k: torch.as_tensor(v).to(device, non_blocking=True)
                     for k, v in data.items()}
        loss = train_step(batch, key)
        check_finite(f"training step {logger.step}", loss=loss)
        state.step = logger.step + 1
        logger({"Loss": loss})
    return models
