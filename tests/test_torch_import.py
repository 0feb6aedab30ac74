"""nerftex_torch stands alone: no file of the package, nor chip_smoke.py,
imports jax, optax, nerftex_tpu or the config shims that resolve to it; the
package (the serving modules included) imports with all of them blocked;
and an entry point given no device raises when CUDA is absent instead of
running on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "nerftex_tpu", "network", "instancer", "util", "data")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "nerftex_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imported_roots(p)
           if m in FORBIDDEN]
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    modules = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files() if p.startswith(os.path.join(ROOT, "nerftex_torch"))
    )
    for m in ("nerftex_torch.utils.rng", "nerftex_torch.data.sampler",
              "nerftex_torch.data.distribution", "nerftex_torch.operating_points",
              "nerftex_torch.render.serve", "nerftex_torch.render.checkpoint"):
        assert m in modules, m
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("ok")


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    from nerftex_torch.instancing.instancer import Instancer
    from nerftex_torch.models.mlp import ParamNerf
    from nerftex_torch.utils.util import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    ff = {"module": "network.model.FourierFeatures", "n_freq_bands": 2}
    with pytest.raises(RuntimeError, match="CUDA"):
        ParamNerf(ff, ff, ff, [1, 6], depth=2, width=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        Instancer(b_0=[-1, -1, -1], b_1=[1, 1, 1], instance_sampling_method="nearest",
                  transformations=[list(map(list, torch.eye(4).tolist()))])
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_foreign_devices():
    """A tensor that is neither on the CPU nor on CUDA reaches no fallback."""
    from nerftex_torch.kernels import tex_gather

    uv = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError):
        tex_gather.sample_channel(torch.zeros(2, 2, device="meta"), uv)
