"""Render driver (counterpart of nerftex_tpu/render/render.py): builds the
test dataset, model and renderer, then the Logger in eval mode, which
restores the checkpoint and renders every dataset item to a file."""

from nerftex_torch.models.mlp import model_dict
from nerftex_torch.utils import util
from nerftex_torch.utils.util import EasyDict, resolve_device


def Render(
    target_path: str,
    test_dataset_config: EasyDict,
    model_config: EasyDict,
    renderer_config: EasyDict,
    logger_config: EasyDict,
    source_path: str = None,
    override: bool = True,
    device=None,
    **kwargs,
):
    """device: where the model renders; CUDA unless given."""
    device = resolve_device(device)
    test_dataset = util.instantiate(test_dataset_config)

    model_config = EasyDict(model_config)
    model_config.setdefault("n_parameters", test_dataset.n_parameters)
    models = model_dict(util.instantiate(model_config, device=device))

    renderer_config = EasyDict(renderer_config)
    renderer_config.update(models)
    renderer = util.instantiate(renderer_config, device=device)

    logger_config = EasyDict(logger_config)
    logger_config.update(
        {
            "target_path": target_path,
            "checkpoint_variables": dict(models),
            "source_path": source_path,
            "dataset": test_dataset,
            "is_training": False,
            "renderer": renderer,
        }
    )
    util.instantiate(logger_config)
    return renderer
