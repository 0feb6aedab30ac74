"""Logging, checkpoints and validation renders (counterpart of
nerftex_tpu/render/logger.py ``Logger``).

The Logger restores the latest checkpoint under ``<source_path>/checkpoints``
(the JAX package's pickle layout, through render/checkpoint.py) into the
models on construction, and in training mode the optimizer and the step
too: the port's own Adam state (``extra["torch_adam"]``) or, from a JAX
checkpoint, its optax state (``extra["opt_state"]``).  Either may hold the
parameter tree or, from a JAX run with ``flat_params``, flat vectors, and
either restores into models with or without a flat parameter
(render/checkpoint.py); the Logger always saves the tree, so
``flat_params`` can change across a resume.

Training mode, one call per step: scalars to ``<target>/scalars.jsonl``
every ``i_summary`` steps (and to TensorBoard when
``torch.utils.tensorboard`` imports and ``NERFTEX_NO_TENSORBOARD`` is
unset), a print every ``i_print``, the validation dataset rendered to
``media/validation/<step>/`` every ``i_img``, a checkpoint every
``i_checkpoint`` (models in the JAX layout, so either package restores
them; the newest ``max_to_keep`` kept plus one every
``keep_every_n_hours``), and with ``i_trace`` a torch.profiler trace of
``trace_steps`` steps every ``i_trace`` steps under ``<target>/profile``.

Eval mode (``is_training=False``) renders every item of the test dataset
in order to ``<target_path>/media/test/<i>.png`` (or ``.exr``) at once.
"""

import json
import os
import time
from typing import Any

import numpy as np
import torch

from nerftex_torch.ops.interpolate import filtered_downsample
from nerftex_torch.render.checkpoint import (CheckpointManager, adam_state_tree,
                                             export_jax_params, load_adam_state, load_jax_opt_state,
                                             load_jax_params)
from nerftex_torch.utils import trace, util
from nerftex_torch.utils.debug import check_finite
from nerftex_torch.utils.image import write_image


class Logger:
    def __init__(
        self,
        target_path: str,
        checkpoint_variables: dict,
        source_path: str = None,
        dataset=None,
        is_training: bool = True,
        renderer: Any = None,
        n_iters: int = 5e5,
        i_summary: int = 10,
        i_print: int = 100,
        i_img: int = 5e3,
        i_checkpoint: int = 1e3,
        max_to_keep: int = 3,
        keep_every_n_hours: int = 12,
        write_exr: bool = False,
        downsampling_factor: int = 1,
        i_trace: int = 0,
        trace_steps: int = 3,
        **kwargs,
    ) -> None:
        self.target_path = target_path
        self.source_path = source_path if source_path is not None else target_path
        self.dataset = dataset
        self.is_training = is_training
        self.renderer = renderer
        self.n_iters = int(n_iters)
        self.i_summary = int(i_summary)
        self.i_print = int(i_print)
        self.i_img = int(i_img)
        self.i_checkpoint = int(i_checkpoint)
        self.write_exr = write_exr
        self.downsampling_factor = downsampling_factor
        self.time_print = time.perf_counter()
        self.i_trace = int(i_trace)
        self.trace_steps = int(trace_steps)
        self._profiler = None
        self._tracing_until = None

        # checkpoint_variables: {model_name: model, ...} plus, in training,
        # "state": an object with .optimizer and .step (train.TrainState).
        self.models = {k: v for k, v in checkpoint_variables.items()
                       if isinstance(v, torch.nn.Module)}
        self.state = checkpoint_variables.get("state")
        self.step = 0

        self.checkpoint_manager = CheckpointManager(
            os.path.join(self.source_path, "checkpoints"),
            max_to_keep=max_to_keep,
            keep_every_n_hours=keep_every_n_hours,
        )
        self._restore()

        self._summary_writer = None
        if is_training:
            os.makedirs(self.target_path, exist_ok=True)
            self._scalar_file = open(os.path.join(self.target_path, "scalars.jsonl"), "a")
            if not os.environ.get("NERFTEX_NO_TENSORBOARD"):
                self._summary_writer = _try_tensorboard(self.target_path)
            self.imgs_path = os.path.join(self.target_path, "media/validation")
            os.makedirs(self.imgs_path, exist_ok=True)
        else:
            self._scalar_file = None
            self.imgs_path = os.path.join(self.target_path, "media/test")
            self.render_images(self.imgs_path)

    # -- checkpointing ----------------------------------------------------------

    def _restore(self) -> None:
        saved = self.checkpoint_manager.restore_latest()
        if saved is None:
            return
        for name, model in self.models.items():
            if name in saved.get("models", {}):
                load_jax_params(model, saved["models"][name])
        extra = saved.get("extra", {})
        self.step = int(extra.get("step", self.step))
        if self.state is not None:
            self.state.step = self.step
            if "torch_adam" in extra:
                adam = extra["torch_adam"]
                load_adam_state(self.state.optimizer, self.models, adam["count"], adam["mu"],
                                adam["nu"])
            elif "opt_state" in extra:
                load_jax_opt_state(self.state.optimizer, self.models, extra["opt_state"])
        print(f"Restored model{' & optimizer' if self.state else ''} from "
              f"{self.checkpoint_manager.latest_checkpoint}.")

    def save_checkpoint(self, step: int) -> str:
        state = {"models": {k: export_jax_params(m) for k, m in self.models.items()}}
        extra = {"step": step}
        if self.state is not None:
            extra["torch_adam"] = adam_state_tree(self.state.optimizer, self.models)
        state["extra"] = extra
        return self.checkpoint_manager.save(state, step)

    # -- per-step hook ----------------------------------------------------------

    def __call__(self, loss: dict) -> None:
        self.step += 1
        step = self.step

        if self.i_trace > 0:
            self._trace(step)

        if step % self.i_summary == 0:
            record = {"step": step}
            for key, value in loss.items():
                record[key] = _host_float(value)
                if self._summary_writer is not None:
                    self._summary_writer.add_scalar(key, record[key], step)
            self._scalar_file.write(json.dumps(record) + "\n")
            self._scalar_file.flush()

        if step % self.i_print == 0:
            parts = [f"Step {step}"]
            for key, value in loss.items():
                parts.append(f"{key} {_host_float(value):.3g}")
            parts.append(f"Duration {time.perf_counter() - self.time_print:.3g}")
            print(" | ".join(parts))
            self.time_print = time.perf_counter()

        if step % self.i_img == 0 and self.dataset is not None:
            print("Rendering validation images.")
            imgs = self.render_images(
                os.path.join(self.imgs_path, util.format_name("", step, self.n_iters, "")),
                return_imgs=self._summary_writer is not None,
            )
            if self._summary_writer is not None and imgs:
                for i, img in enumerate(imgs):
                    self._summary_writer.add_image(f"Validation Rendering/{i}", np.asarray(img),
                                                   step, dataformats="HWC")

        if step % self.i_checkpoint == 0:
            path = self.save_checkpoint(step)
            print(f"Saved checkpoint to {path}.")

    def _trace(self, step: int) -> None:
        """From every i_trace-th step, profile the next trace_steps steps
        (host and CUDA activity) into a Chrome trace under <target>/profile.
        A trace that would end past n_iters is not started: nothing would
        stop it, and a profiler left running keeps the process recording
        (utils/trace.py).  What the tracer recorded under the profiler is in
        the exported trace and is then forgotten, unless a
        ``trace.recording()`` block is still open."""
        trace_dir = os.path.join(self.target_path, "profile")
        if (self._profiler is None and step % self.i_trace == 0
                and step + self.trace_steps <= self.n_iters):
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
            self._tracing_until = step + self.trace_steps
        elif self._profiler is not None and step >= self._tracing_until:
            self._profiler.stop()
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"trace_{self._tracing_until - self.trace_steps}.json")
            self._profiler.export_chrome_trace(path)
            self._profiler = None
            if not trace.is_recording():
                trace.reset()
            self._tracing_until = None
            print(f"Wrote profiler trace to {path}.")

    # -- rendering --------------------------------------------------------------

    def render_images(self, imgs_path: str, return_imgs: bool = False):
        """Render the dataset's items in order, one file each."""
        os.makedirs(imgs_path, exist_ok=True)
        max_idx = self.dataset.cardinality()
        if max_idx < 0:
            max_idx = 256
        imgs = []
        for i, data in enumerate(self.dataset):
            img = self.render_image(data)
            name = util.format_name("", i, max_idx, ".exr" if self.write_exr else ".png")
            write_image(os.path.join(imgs_path, name), img)
            if return_imgs:
                imgs.append(img)
        return imgs if return_imgs else None

    def render_image(self, data: dict) -> np.ndarray:
        """One item as float32 [H, W, 4]: straight alpha for PNG output,
        premultiplied for EXR."""
        pred = self.renderer(
            **data,
            composite_bkgd=self.dataset.composite_bkgd,
            bkgd_color=self.dataset.bkgd_color,
            training=False,
        )
        check_finite("rendered frame", color_pred=pred["color_pred"],
                     alpha_pred=pred["alpha_pred"])
        with trace.host_read("readback"):
            color = pred["color_pred"].float().cpu().numpy()
        with trace.host_read("readback"):
            alpha = pred["alpha_pred"].float().cpu().numpy()
        img = np.concatenate([color.reshape(-1, 3), alpha.reshape(-1, 1)], -1).reshape(
            self.dataset.height, self.dataset.width, 4)
        if self.downsampling_factor > 1:
            img = filtered_downsample(img, self.downsampling_factor).numpy()
        if not self.write_exr:
            eps = 1e-5
            img = np.concatenate([img[..., :3] / (img[..., 3:] + eps), img[..., 3:]], -1)
        return img


def _host_float(value) -> float:
    """A logged value as a host float: a tensor is read from its device (a
    host read wherever it lies, as a card would wait for it)."""
    if isinstance(value, torch.Tensor):
        with trace.host_read("loss"):
            return float(value)
    return float(value)


def _try_tensorboard(path: str):
    """A TensorBoard SummaryWriter on ``path``, or None where the
    tensorboard package is missing."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(path)
