"""CLI entry point of the port: load a config module and run the function it
names on the card (counterpart of the repo's main.py).

    python -m nerftex_torch.main configs/config_carpet_train.py
    python -m nerftex_torch.main configs/config_grass_filtered_render.py
    python -m nerftex_torch.main configs/config_carpet_render.py --device cpu

It seeds the host and device streams from the config's seed, makes
``target_path``, copies the config there (``config_train.py`` when the
config's module path names train, else ``config_render.py``) with the checkout's
git hash appended, and instantiates the config: ``Train`` trains and
writes scalars, validation images and checkpoints under ``target_path``;
``Render`` restores ``<target_path>/checkpoints`` and renders the test
dataset into ``<target_path>/media/test``.  The kernels' nvcc builds are
cached by kernels/build.py.  ``NERFTEX_DEBUG_NANS=1`` makes the run raise
on its first non-finite value (utils/debug.py).
"""

import argparse
import importlib
import os
import shutil
import sys

from nerftex_torch.utils import rng, util
from nerftex_torch.utils.debug import maybe_enable_debug_checks
from nerftex_torch.utils.util import EasyDict


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run the pipeline described by a config file.")
    parser.add_argument("config", help="Path to config file.")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    if os.getcwd() not in sys.path:
        sys.path.insert(0, os.getcwd())
    config_path = args.config[:-3] if args.config.endswith(".py") else args.config
    config_module = config_path.replace("/", ".")
    config = EasyDict(importlib.import_module(config_module).config)

    # Forward the full config (minus the logger's own) to the logger for
    # experiment bookkeeping, as the repo's main.py does.
    config_copy = EasyDict(config)
    if "logger_config" in config_copy:
        del config_copy.logger_config
        config.logger_config.update({"info": config_copy})

    rng.set_seed(config.get("seed"))
    maybe_enable_debug_checks()

    os.makedirs(config.target_path, exist_ok=config.get("override", False))
    infix = "train" if "train" in config.module else "render"
    config_copy_path = os.path.join(config.target_path, "config_" + infix + ".py")
    try:
        shutil.copy(config_path + ".py", config_copy_path)
    except shutil.SameFileError:
        pass
    with open(config_copy_path, "a") as f:
        f.write("\n# GIT COMMIT HASH: " + util.get_git_hash())

    util.instantiate(config, device=args.device)


if __name__ == "__main__":
    main()
