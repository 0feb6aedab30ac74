"""Traffic of kind "train_device": the device-resident training step of the
configuration, free-running, built as the program's Train builds it
(render/train.py build_step with ``device_resident`` on the dataset and
``steps_per_dispatch`` steps a dispatch): the swatch set's views decoded
once into a u8 table on the card, each step sampling its own batch there
(data/device_dataset.py DeviceResidentSampler) inside one captured CUDA
graph with the forward, AlphaLoss, the backward and capturable Adam, and
FusedStep.run replaying it a dispatch's steps at a time, then reading
their losses back.  The views are made from the seed (swatches.py).
Logging, validation renders and checkpoint saves are not part of a step.

Set-up runs the first ``check_steps`` steps as graph replays (one
dispatch of one step, which captures the graph, then one of the rest):
their losses, the gradient of the first (Adam's first moment after it)
and the parameters after the last are what the check compares, with each
step's batch drawn again by the program's sampler under the step's key.
Then ``warm_units`` dispatches.  The window runs whole dispatches back to
back for the given seconds; a dispatch started before they ran out is
finished, and the window closes when its losses are read back.

The comparison that decides ``correct`` (limits with their reasons in
benchmark/limits/<cell>.json):

- ``data_bad_rows``: rows whose view or pixel differs from the plain
  sampler's draw (reference/device_sampler.py) under the same key, the
  draws compared exactly (limit 0);
- ``data_max_err.<field>``: the largest difference of a row's field from
  the plain sampler's rework of that row from the view's image and camera;
- ``loss0_gap``, ``grad_gap``, ``update_gap``: as check_train.py defines
  them, between the program's graph-replayed steps and the float32
  reference (reference/train.py) on the same batches under the same
  perturbation keys; ``update_err``: the relative error of the parameters'
  change over those steps, |d - d_ref| / |d_ref| with every leaf in one
  vector.  Adam moves most elements by about the rate whatever their
  gradient's size, so this counts the elements whose gradients' signs the
  step's rounding turned: the one number of these that tells the
  configuration's bf16 from the next lower precision.  The later steps'
  loss gaps are printed, not compared.  With ``control`` the reference at
  the next lower precision, e4m3 (reference/precision.py), takes the
  program's place, and the run must come out not correct;
  train_device_controls.py reads the bf16 control and two faults;
- ``eager_steps``: steps of the run that did not run from the graph
  (render/train.py ``step_counts``; limit 0).
"""

import contextlib
import copy
import gc
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import check_train, spans
from benchmark.harness.profile import profiled
from benchmark.harness.swatches import draw, swatch_set, views
from benchmark.harness.train import program_leaves
from benchmark.harness.weights import make_weights
from benchmark.reference import precision as ref_precision
from benchmark.reference.device_sampler import ReferenceSampler
from benchmark.reference.mlp import spec_of

FIELDS = ("rays_o", "rays_d", "t", "cone_scale", "color", "alpha", "parameters")
# The upstream Proxy pixel sampler's grid, where the configuration names none.
DOWNSAMPLE = 8


class DeviceTrainCell:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from nerftex_torch.render.checkpoint import load_jax_params
        from nerftex_torch.render.train import FusedStep, TrainState, build_step
        from nerftex_torch.utils import rng

        self.device = torch.device(device)
        self.train = train = copy.deepcopy(cfg["train"])
        self.spec = spec_of(train["model_config"])
        self.set_spec = dict(mix["swatches"], n_parameters=[self.spec["n_geo"],
                                                            self.spec["n_app"]])
        self._swatches = tempfile.TemporaryDirectory(prefix="benchmark_swatches_")
        t0 = time.perf_counter()
        tfr = swatch_set(self.set_spec, seed, self._swatches.name, self.device)
        print(f"swatch set: {self.set_spec['views']} views of {self.set_spec['size']}^2 in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        train["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
        rng.set_seed(train["seed"])
        self.state = TrainState()
        self.k = int(train["steps_per_dispatch"])
        self.dataset, models, _, self.step = build_step(
            train["train_dataset_config"], train["model_config"], train["loss_config"],
            train["lrate"], train["lrate_decay"], train["renderer_config"], self.device,
            self.state, flat_params=train.get("flat_params", False), steps_per_dispatch=self.k)
        if not isinstance(self.step, FusedStep):
            raise ValueError("the configuration's training step is not device-resident")
        self.model = next(iter(models.values()))
        self.weights = make_weights(self.spec, seed, self.device)
        load_jax_params(self.model, self.weights)
        self.model.drop_packed()
        self.sampler = self.dataset.device_sampler
        self.s = 0
        n_rays = self.sampler.batchsize * self.sampler.n_samples
        self.samples_per_step = n_rays * int(train["renderer_config"]["n_samples"])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dispatch(self, k: int = None) -> torch.Tensor:
        """One dispatch of k steps (the configuration's unless given); their
        losses on the host."""
        k = self.k if k is None else k
        losses = self.step.run(self.s, k)
        self.s += k
        self.state.step = self.s
        return losses

    def checked_steps(self, n: int) -> dict:
        """The first n steps as graph replays, with what the check compares."""
        from nerftex_torch.utils import jax_rng

        record = {"losses": self.dispatch(1).tolist()}
        opt = self.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        record["grad0"] = program_leaves(
            self.model, lambda p: opt.state[p]["exp_avg"].detach().clone() / (1 - beta1))
        if n > 1:
            record["losses"] += self.dispatch(n - 1).tolist()
        record["after"] = program_leaves(self.model, lambda p: p.detach().clone())
        record["batches"] = []
        for s in range(n):
            batch, aux = self.sampler.sample_from(
                self.sampler.tables, jax_rng.fold_in(self.step.data_key, s), with_aux=True)
            batch.update(aux)
            record["batches"].append({k: v.cpu().numpy() for k, v in batch.items()})
        return record

    def free(self):
        self.step = self.model = self.dataset = self.sampler = self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._swatches.cleanup()


def run(cfg, mix, limits, seed, seconds, trace, device, root, control=False):
    from nerftex_torch.render.train import step_counts
    from nerftex_torch.utils import trace as tracer

    eager0 = step_counts["eager_steps"]
    start_ns = time.perf_counter_ns()
    with tracer.recording() if trace else contextlib.nullcontext():
        cell = DeviceTrainCell(cfg, mix, seed, device)
        record = cell.checked_steps(int(mix["check_steps"]))
        for _ in range(int(mix["warm_units"])):
            cell.dispatch()
        cell.sync()
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    ready = time.perf_counter()
    rec, stats = None, {}
    if not trace:
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            steps += len(cell.dispatch())
        wall = time.perf_counter() - t0
        stats = {"steps_per_s": steps / wall, "units": steps}
    else:
        rec = traced(cell, mix)
        print("set-up: " + ", ".join(f"{k} {v}" for k, v in setup_spans(start_ns).items()),
              file=sys.stderr)
        steps = rec["part1"]["steps"] + rec["part2"]["steps"]
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    record["eager_steps"] = step_counts["eager_steps"] - eager0
    set_spec, spec, weights, train = cell.set_spec, cell.spec, cell.weights, cell.train
    cell.free()
    checks = check(record, set_spec, spec, weights, train, seed, limits, device,
                   precision="e4m3" if control else None)
    return stats, rec, steps + len(record["losses"]), 0, peak, checks, ready


def setup_spans(start_ns: int) -> dict:
    """The set-up's view table and graph capture as the program's tracer
    saw them since ``start_ns``: seconds in ``data.table`` and
    ``train.capture`` spans, and the counts ``data.table_bytes`` and
    ``data.table_views``; each None where the program recorded none."""
    out = {}
    snap = spans.snapshot()
    for name, key in (("data.table", "table_s"), ("train.capture", "capture_s")):
        got = [spans.seconds(s) for s in snap["spans"]
               if s["name"] == name and s["start_ns"] >= start_ns]
        out[key] = sum(got) if got else None
    for name, key in (("data.table_bytes", "table_bytes"), ("data.table_views", "table_views")):
        out[key] = spans.count(snap, None, name) or None
    return out


def traced(cell: DeviceTrainCell, mix: dict) -> dict:
    """Whole dispatches with the program's tracer recording (the model-FLOP
    rate, the host's time to issue a replay), then whole dispatches under
    the profiler (launches, device busy time, the breakdown)."""
    from nerftex_torch.utils import trace as tracer

    n1, n2 = int(mix["trace_units"]), int(mix["profile_units"])
    t0_ns = time.perf_counter_ns()
    with tracer.recording():
        t0 = time.perf_counter()
        steps = sum(len(cell.dispatch()) for _ in range(n1))
        wall1 = time.perf_counter() - t0
    t1_ns = time.perf_counter_ns()

    def dispatches():
        for _ in range(n2):
            cell.dispatch()

    prof = profiled(dispatches, cell.sync)
    return {"kind": "train_device", "spec": cell.spec,
            "part1": {"wall_s": wall1, "units": n1, "steps": steps,
                      "samples": steps * cell.samples_per_step, "start_ns": t0_ns,
                      "end_ns": t1_ns},
            "part2": dict(prof, units=n2, steps=n2 * cell.k, start_ns=t1_ns,
                          end_ns=time.perf_counter_ns())}


def dispatch_roots(trace, part: str):
    """(the program's snapshot, ids of the ``train.replay`` root spans that
    began inside the traced run's ``part``) of a run of kind
    "train_device"; None unless there is one a dispatch of the part."""
    if trace.get("kind") != "train_device":
        return None
    snap = spans.snapshot()
    if snap is None:
        return None
    p = trace[part]
    ids = {s["id"] for s in snap["spans"] if s["name"] == "train.replay"
           and s["parent"] is None and p["start_ns"] <= s["start_ns"] <= p["end_ns"]}
    if len(ids) != p["units"]:
        return None
    return snap, ids


def check_data(record, sampler: ReferenceSampler, seed: int):
    """(bad rows, {field: largest difference}) of the program's batches
    against the plain sampler's draws and rows."""
    bad, err = 0, dict.fromkeys(FIELDS, 0.0)
    for s, got in enumerate(record["batches"]):
        want, aux = sampler.batch(seed, s)
        same = ((got["img_idx"] == aux["img_idx"])[:, None]
                & (got["loc"] == aux["loc"]).all(-1))
        bad += int((~same).sum())
        for k in FIELDS:
            g = np.asarray(got[k], np.float32)
            w = np.asarray(want[k], np.float32)
            if k == "parameters":
                keep = same.all(-1)
                g, w = g[keep], w[keep]
            else:
                g, w = g[same], w[same]
            if not g.size:
                continue
            if (np.isfinite(g) != np.isfinite(w)).any():
                err[k] = float("inf")
                continue
            fin = np.isfinite(w)
            if fin.any():
                err[k] = max(err[k], float(np.abs(g[fin] - w[fin]).max()))
    return bad, err


def relative_error(got: dict, want: dict) -> float:
    """|got - want| / |want|, every leaf of both taken together as one vector."""
    diff = sum(float(torch.linalg.norm(got[k].float() - want[k].float())) ** 2 for k in want)
    norm = sum(float(torch.linalg.norm(want[k].float())) ** 2 for k in want)
    return (diff / norm) ** 0.5


def check(record, set_spec, spec, weights, train, seed, limits, device, precision=None) -> dict:
    dev = torch.device(device)
    vs = views(set_spec["views"], set_spec["n_parameters"], set_spec["radius"], seed)
    data = train["train_dataset_config"]
    sampler = ReferenceSampler(
        [pose for pose, _ in vs], [params for _, params in vs], set_spec["size"],
        set_spec["angle"], data["proxy_config"], data["batchsize"],
        data["pixel_sampler_config"]["n_samples"],
        data["pixel_sampler_config"].get("downsample_factor", DOWNSAMPLE),
        lambda i: draw(*vs[i], set_spec["size"], set_spec["angle"], dev))
    bad, err = check_data(record, sampler, train["seed"])
    # The steps follow the program's batches, which the data check holds to
    # the plain sampler's rows within the sampler's own tolerances.
    batches = [{k: v for k, v in b.items() if k in FIELDS} for b in record["batches"]]
    ref = ref_precision.run_steps(spec, weights, batches, train["seed"], train, dev)
    if precision:
        got = ref_precision.run_steps(spec, weights, batches, train["seed"], train, dev,
                                      precision=precision)
    else:
        got = {"losses": record["losses"], "grad0": record["grad0"],
               "delta": {k: record["after"][k].to(dev) - torch.as_tensor(weights[k], device=dev)
                         for k in weights}}
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    print("loss gap by step: " + ", ".join(f"{g:.3g}" for g in gaps), file=sys.stderr)
    g_norm = {k: float(torch.linalg.norm(v)) for k, v in ref["grad0"].items()}
    g_floor = float(np.median(list(g_norm.values())))
    keep = {k: v >= check_train.SMALL_LEAF * g_floor for k, v in g_norm.items()}
    grad0 = {k: v.to(dev) for k, v in got["grad0"].items()}
    checks = {"data_bad_rows": {"value": bad, "limit": limits["data_bad_rows"]}}
    for k in FIELDS:
        checks[f"data_max_err.{k}"] = {"value": err[k], "limit": limits["data_max_err"][k]}
    checks.update({
        "loss0_gap": {"value": gaps[0], "limit": limits["loss0_gap"]},
        "grad_gap": {"value": check_train._norm_gap("grad_gap", grad0, ref["grad0"]),
                     "limit": limits["grad_gap"]},
        "update_gap": {"value": check_train._norm_gap("update_gap", got["delta"], ref["delta"],
                                                      keep),
                       "limit": limits["update_gap"]},
        "update_err": {"value": relative_error(got["delta"], ref["delta"]),
                       "limit": limits["update_err"]},
        "eager_steps": {"value": record["eager_steps"], "limit": limits["eager_steps"]},
    })
    return checks
