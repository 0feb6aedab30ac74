"""Checkpoint restore and render execution in eval mode (counterpart of
nerftex_tpu/render/logger.py ``Logger`` with ``is_training=False``).

The Logger restores the latest checkpoint under
``<source_path>/checkpoints`` (the JAX package's pickle layout, through
render/checkpoint.py) into the models on construction, then renders every
item of the test dataset in order and writes each as
``<target_path>/media/test/<i>.png`` (or ``.exr``).  Training mode
(scalars, TensorBoard, validation renders, checkpoint saves, the profiler
trace) comes with the training slice.
"""

import os
from typing import Any

import numpy as np
import torch

from nerftex_torch.ops.interpolate import filtered_downsample
from nerftex_torch.render.checkpoint import CheckpointManager, load_jax_params
from nerftex_torch.utils import util
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
        write_exr: bool = False,
        downsampling_factor: int = 1,
        **kwargs,
    ) -> None:
        if is_training:
            raise NotImplementedError("the Logger's training mode comes with the training slice")
        self.target_path = target_path
        self.source_path = source_path if source_path is not None else target_path
        self.dataset = dataset
        self.renderer = renderer
        self.write_exr = write_exr
        self.downsampling_factor = downsampling_factor
        self.models = {k: v for k, v in checkpoint_variables.items()
                       if isinstance(v, torch.nn.Module)}
        # Eval mode only restores, so the retention policy does not apply.
        self.checkpoint_manager = CheckpointManager(os.path.join(self.source_path, "checkpoints"))
        self._restore()
        self.imgs_path = os.path.join(self.target_path, "media/test")
        self.render_images(self.imgs_path)

    def _restore(self) -> None:
        saved = self.checkpoint_manager.restore_latest()
        if saved is None:
            return
        for name, model in self.models.items():
            if name in saved.get("models", {}):
                load_jax_params(model, saved["models"][name])
        print(f"Restored model from {self.checkpoint_manager.latest_checkpoint}.")

    def render_images(self, imgs_path: str) -> None:
        """Render the dataset's items in order, one file each."""
        os.makedirs(imgs_path, exist_ok=True)
        max_idx = self.dataset.cardinality()
        if max_idx < 0:
            max_idx = 256
        for i, data in enumerate(self.dataset):
            name = util.format_name("", i, max_idx, ".exr" if self.write_exr else ".png")
            write_image(os.path.join(imgs_path, name), self.render_image(data))

    def render_image(self, data: dict) -> np.ndarray:
        """One item as float32 [H, W, 4]: straight alpha for PNG output,
        premultiplied for EXR."""
        pred = self.renderer(
            **data,
            composite_bkgd=self.dataset.composite_bkgd,
            bkgd_color=self.dataset.bkgd_color,
            training=False,
        )
        img = np.concatenate(
            [pred["color_pred"].float().cpu().numpy().reshape(-1, 3),
             pred["alpha_pred"].float().cpu().numpy().reshape(-1, 1)],
            -1,
        ).reshape(self.dataset.height, self.dataset.width, 4)
        if self.downsampling_factor > 1:
            img = filtered_downsample(img, self.downsampling_factor).numpy()
        if not self.write_exr:
            eps = 1e-5
            img = np.concatenate([img[..., :3] / (img[..., 3:] + eps), img[..., 3:]], -1)
        return img
