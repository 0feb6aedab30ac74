"""Traffic of kind "train": free-running host-fed training steps of the
configuration's training setup, built as the program's Train builds it
(render/train.py build_step: the TFRecord dataset with its prefetch
thread, the model, the renderer, the loss, Adam), on a swatch set made
from the seed (swatches.py).  Logging, validation renders and checkpoint
saves are not part of a step.

Set-up takes the first ``check_steps`` steps through the window's own
feed and call; their batches, losses, the optimizer's state after the
first and the parameters after the last are what the check compares
(check_train.py).  The window then runs steps back to back for the given
seconds and closes with a synchronise after the last step, whose loss is
read back.
"""

import copy
import gc
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import check_train
from benchmark.harness.profile import profiled
from benchmark.harness.swatches import swatch_set
from benchmark.harness.weights import make_weights
from benchmark.reference.mlp import spec_of

_LISTS = ("param_geo", "param_app", "trunk", "color_layers")
_SINGLE = ("alpha", "bottleneck", "pre_color", "color")


def program_leaves(model, pick):
    """{"trunk/0/w": [in, out], ...} of ``pick(tensor)`` for each weight
    and bias of the program's model, in the weight table's layout."""
    out = {}
    for key in _LISTS:
        for i, layer in enumerate(getattr(model, key)):
            out[f"{key}/{i}/w"], out[f"{key}/{i}/b"] = pick(layer.weight).T, pick(layer.bias)
    for key in _SINGLE:
        layer = getattr(model, key)
        out[f"{key}/w"], out[f"{key}/b"] = pick(layer.weight).T, pick(layer.bias)
    return out


class TrainCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from nerftex_torch.render.checkpoint import load_jax_params
        from nerftex_torch.render.train import TrainState, build_step
        from nerftex_torch.utils import rng

        self.device = torch.device(device)
        self.train = train = copy.deepcopy(cfg["train"])
        self.spec = spec_of(train["model_config"])
        self.set_spec = dict(mix["swatches"], n_parameters=[self.spec["n_geo"],
                                                            self.spec["n_app"]])
        self._swatches = tempfile.TemporaryDirectory(prefix="benchmark_swatches_")
        tfr = swatch_set(self.set_spec, seed, self._swatches.name, self.device)
        train["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
        rng.set_seed(train["seed"])
        # The pixel and record draws of the data pipeline follow the run's seed.
        np.random.seed(int(seed) % 2**32)
        self.state = TrainState()
        self.dataset, models, _, self.step = build_step(
            train["train_dataset_config"], train["model_config"], train["loss_config"],
            train["lrate"], train["lrate_decay"], train["renderer_config"], self.device,
            self.state)
        self.model = next(iter(models.values()))
        self.weights = make_weights(self.spec, seed, self.device)
        load_jax_params(self.model, self.weights)
        self.model.drop_packed()
        self.batches = iter(self.dataset.take(None))
        self.base = rng.stream_key(rng.STREAM_PERTURB)
        self.s = 0
        self.data_wait = 0.0
        self.samples_per_step = None

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self):
        """One step; returns (loss tensor, the host batch)."""
        from nerftex_torch.utils import jax_rng

        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function("bench:data"):
            data = next(self.batches)
        self.data_wait += time.perf_counter() - t0
        with torch.autograd.profiler.record_function("bench:step"):
            batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                     for k, v in data.items()}
            loss = self.step(batch, jax_rng.fold_in(self.base, self.s))
        self.s += 1
        self.state.step = self.s
        if self.samples_per_step is None:
            b, r = data["rays_o"].shape[:2]
            self.samples_per_step = b * r * int(self.train["renderer_config"]["n_samples"])
        return loss, data

    def checked_steps(self, n: int) -> dict:
        """The first n steps, with what the check compares."""
        record = {"batches": [], "losses": []}
        for s in range(n):
            loss, data = self.unit()
            record["batches"].append({k: np.array(v) for k, v in data.items()})
            record["losses"].append(float(loss))
            if s == 0:
                opt = self.state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                # No first moment: the optimizer was never handed a gradient.
                record["grad0"] = program_leaves(
                    self.model, lambda p: opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)).detach().clone() / (1 - beta1))
        record["after"] = program_leaves(self.model, lambda p: p.detach().clone())
        return record

    def free(self):
        self.step = self.model = self.dataset = self.batches = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._swatches.cleanup()


def run(cfg, mix, limits, seed, seconds, trace, device, root, control=False):
    cell = TrainCell(cfg, mix, seed, device)
    record = cell.checked_steps(int(mix["check_steps"]))
    for _ in range(int(mix["warm_units"])):
        cell.unit()
    cell.sync()
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    ready = time.perf_counter()
    rec, stats, steps = None, {}, 0
    if not trace:
        cell.data_wait = 0.0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loss, _ = cell.unit()
            steps += 1
        float(loss)
        wall = time.perf_counter() - t0
        stats = {"steps_per_s": steps / wall, "units": steps}
    else:
        rec = traced(cell, mix)
        steps = rec["part1"]["units"] + rec["part2"]["units"]
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    set_spec, spec, weights, train = cell.set_spec, cell.spec, cell.weights, cell.train
    cell.free()
    checks = check_train.check(record, set_spec, spec, weights, train, seed, limits, device,
                               control=control)
    return stats, rec, steps + len(record["losses"]), 0, peak, checks, ready


def traced(cell: TrainCell, mix: dict) -> dict:
    """Unprofiled steps (model-FLOP rate, the wait for data), then profiled
    ones (launches, device busy time, the breakdown)."""
    n1, n2 = int(mix["trace_units"]), int(mix["profile_units"])
    cell.data_wait = 0.0
    t0 = time.perf_counter()
    for _ in range(n1):
        loss, _ = cell.unit()
    float(loss)
    wall1 = time.perf_counter() - t0
    wait1 = cell.data_wait

    def steps():
        for _ in range(n2):
            loss, _ = cell.unit()
        float(loss)

    prof = profiled(steps, cell.sync)
    return {"kind": "train", "spec": cell.spec,
            "part1": {"wall_s": wall1, "units": n1, "data_wait_s": wait1,
                      "samples": n1 * cell.samples_per_step},
            "part2": dict(prof, units=n2)}

