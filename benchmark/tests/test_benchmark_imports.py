"""No JAX in a run, by top-level module name; no program in the
reference; and the benchmark's frozen arithmetic equal to the smoke
test's (chip_smoke.py) on fixed shapes."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import manifest as mf
from benchmark.harness.imports import FORBIDDEN, forbidden_loaded
from benchmark.reference.mlp import flops_per_row, spec_of

ROOT = mf.ROOT


def test_top_level_names_compared_whole():
    assert forbidden_loaded(["nerftex_torch", "nerftex_torch.models.mlp", "numpy"]) == []
    assert forbidden_loaded(["nerftex_tpu.render", "jax.numpy", "network.model"]) == [
        "jax", "nerftex_tpu", "network"]
    assert forbidden_loaded(["jaxlib", "optax", "flax.linen", "util.util", "data", "instancer"]) \
        == sorted(["jaxlib", "optax", "flax", "util", "data", "instancer"])
    assert forbidden_loaded(["jax_rng", "database", "utility"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_no_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            got = _imports(os.path.join(ref, name))
            assert not got & (set(FORBIDDEN) | {"nerftex_torch"}), (name, got)


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process: no forbidden module,
    and the reference alone loads no program."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import benchmark.reference.render, benchmark.reference.train, benchmark.reference.scene\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules} & {'nerftex_torch', %s})\n"
        "import benchmark.run, benchmark.harness.cell, benchmark.harness.session\n"
        "import benchmark.harness.train, nerftex_torch.render.serve, nerftex_torch.render.train\n"
        "from benchmark.harness.imports import forbidden_loaded\n"
        "print(json.dumps([ref, forbidden_loaded()]))\n"
    ) % (ROOT, ", ".join(repr(f) for f in FORBIDDEN))
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[[], []]"


def test_without_a_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal path is not reached")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "carpet.frames",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_selk_arithmetic_is_the_smoke_tests():
    import chip_smoke

    metric = mf.reader("selk_resolve_roofline.frame")
    g = torch.Generator().manual_seed(3)
    rb, s, k = 64, 40, 12
    t0 = torch.sort(torch.rand(rb, k, generator=g) * 4, -1).values
    t1 = t0 + torch.rand(rb, k, generator=g)
    valid = torch.arange(k)[None, :] < torch.randint(0, k + 1, (rb, 1), generator=g)
    t0, t1 = torch.where(valid, t0, float("inf")), torch.where(valid, t1, float("inf"))
    t_pt = torch.rand(rb, s, generator=g) * 5
    want = chip_smoke.selk_work(t0, t1, valid, t_pt)
    got = metric.selk_work(t0, t1, valid, t_pt)
    assert torch.equal(got, want)
    work = [int(x) for x in want.tolist()]
    for method in ("nearest", "random", "nearest_blend"):
        ms, why = chip_smoke.selk_bound(rb, s, k, method, work)
        sec, why2 = metric.selk_bound(rb, s, k, method, work)
        assert sec * 1e3 == pytest.approx(ms, rel=1e-12) and why == why2


def test_mlp_count_is_the_programs():
    """2 x the multiply-adds of the layer widths: the program's packed
    chain counts the same (chip_smoke.mlp_bounds uses packed.macs)."""
    import chip_smoke
    from nerftex_torch.utils.util import instantiate

    for n_parameters in ([1, 6], [1, 4]):
        config = chip_smoke.model_config("float32", compute_dtype="float32")
        config["n_parameters"] = n_parameters
        model = instantiate(config, device="cpu")
        spec = spec_of(config)
        assert flops_per_row(spec) == 2 * model.packed().macs
        rows = 32768
        ms = chip_smoke.mlp_bounds(model.packed(), rows, "float32")[2]["bound_tf32x3_ms"]
        ops = flops_per_row(spec) * rows
        assert ms == pytest.approx(3 * ops / chip_smoke.H100_TF32_FLOPS * 1e3, rel=1e-12)
