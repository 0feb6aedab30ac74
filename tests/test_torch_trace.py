"""nerftex_torch/utils/trace.py: the tracer itself, and the spans, counts
and host reads that the render and training paths record on the CPU."""

import importlib
import os
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from nerftex_torch.utils import trace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _spans(name=None):
    return [s for s in trace.snapshot()["spans"] if name is None or s["name"] == name]


def _by_name():
    return {s["name"]: s for s in _spans()}


def test_spans_nest_with_parent_unit_and_self_time():
    with trace.recording():
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.004)
                with trace.span("leaf"):
                    pass
            with trace.span("inner2"):
                pass
        with trace.span("second"):
            pass
    s = _by_name()
    outer, inner, leaf, second = s["outer"], s["inner"], s["leaf"], s["second"]
    assert outer["parent"] is None and outer["unit"] == outer["id"]
    assert inner["parent"] == outer["id"] and s["inner2"]["parent"] == outer["id"]
    assert leaf["parent"] == inner["id"]
    assert inner["unit"] == leaf["unit"] == s["inner2"]["unit"] == outer["id"]
    assert second["parent"] is None and second["unit"] == second["id"] != outer["id"]
    assert outer["start_ns"] <= inner["start_ns"] <= leaf["start_ns"]
    assert leaf["end_ns"] <= inner["end_ns"] <= outer["end_ns"]
    children = sum(x["end_ns"] - x["start_ns"] for x in (inner, s["inner2"]))
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - children
    assert outer["self_ns"] >= 2_000_000 and inner["self_ns"] >= 4_000_000
    assert leaf["self_ns"] == leaf["end_ns"] - leaf["start_ns"]


def test_a_root_takes_the_unit_it_is_given_and_a_decorator_spans_each_call():
    @trace.span("work")
    def work(x):
        trace.count("items", x)
        return 2 * x

    with trace.recording():
        with trace.span("batch", unit=7):
            assert work(3) == 6
        assert work(4) == 8
    batch, first, second = sorted(_spans(), key=lambda s: s["start_ns"])
    assert batch["unit"] == first["unit"] == 7 and first["parent"] == batch["id"]
    assert second["name"] == "work" and second["parent"] is None
    assert second["unit"] == second["id"]
    counts = {(c["span"], c["unit"]): c["n"] for c in trace.snapshot()["counts"]}
    assert counts == {("work", 7): 3, ("work", second["id"]): 4}


def test_counts_go_to_the_innermost_open_span_and_its_unit():
    with trace.recording():
        trace.count("loose", 2)
        with trace.span("request"):
            trace.count("rows", 5)
            with trace.span("block"):
                trace.count("rows", 3)
                trace.count("rows")
    root = _by_name()["request"]["id"]
    got = {(c["name"], c["span"], c["unit"]): c["n"] for c in trace.snapshot()["counts"]}
    assert got == {("loose", None, None): 2, ("rows", "request", root): 5,
                   ("rows", "block", root): 4}
    assert trace.totals() == {"loose": 2, "rows": 9}


def test_host_read_counts_one_sync_and_times_the_read():
    x = torch.arange(10.0)
    with trace.recording():
        with trace.span("frame"):
            for _ in range(3):
                with trace.host_read("readback"):
                    time.sleep(0.001)
                    total = float(x.sum())
    assert total == 45.0
    frame = _by_name()["frame"]
    reads = _spans("sync.readback")
    assert len(reads) == 3 and all(r["parent"] == frame["id"] for r in reads)
    assert all(r["end_ns"] - r["start_ns"] >= 1_000_000 for r in reads)
    assert {(c["name"], c["span"]): c["n"] for c in trace.snapshot()["counts"]} == {
        ("sync", "frame"): 3}
    assert frame["self_ns"] == (frame["end_ns"] - frame["start_ns"]
                                - sum(r["end_ns"] - r["start_ns"] for r in reads))
    with pytest.raises(TypeError):
        trace.host_read("site")(lambda: None)


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened while the tracer is off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not trace.is_recording()

    @trace.span("decorated")
    def f():
        return 1

    with trace.span("off"):
        trace.count("n", 3)
        with trace.host_read("site"):
            value = int(torch.ones(2).sum())
        assert f() == 1
        assert trace.open_spans() == []
    assert value == 2
    assert trace.snapshot() == {"spans": [], "counts": [], "dropped": 0}
    with pytest.raises(AssertionError, match="record_function opened"):
        with trace.recording(), trace.span("on"):
            pass


def test_recording_opens_a_profiler_range_for_each_span():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            with trace.host_read("site"):
                torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"nerftex.outer", "nerftex.sync.site"} <= names


def test_a_profiler_turns_recording_on_on_every_thread():
    """Recording follows torch.autograd.profiler._is_profiler_enabled, a
    private flag that torch.profiler.profile sets for the whole process
    (torch._C._autograd._profiler_enabled() reads False on another thread
    while a profile is open): a span on a second thread is recorded."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    started, release = threading.Event(), threading.Event()

    def worker():
        started.wait()
        with trace.span("thread.work", unit=("thread", 0)):
            trace.count("thread.items", 2)
        release.set()

    t = threading.Thread(target=worker)
    t.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert trace.is_recording()
        with trace.span("main.work"):
            pass
        started.set()
        assert release.wait(10)
    t.join()
    assert not trace.is_recording()
    with trace.span("after"):
        pass
    s = _by_name()
    assert set(s) == {"main.work", "thread.work"}
    assert s["thread.work"]["thread"] != s["main.work"]["thread"]
    assert s["thread.work"]["unit"] == ("thread", 0)
    assert trace.totals() == {"thread.items": 2}


def test_snapshot_is_a_copy_and_reset_clears():
    with trace.recording():
        with trace.span("a"):
            trace.count("c")
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["a"]
    assert set(snap["spans"][0]) == set(trace.SPAN_FIELDS)
    with trace.recording():
        with trace.span("b"):
            pass
    assert [s["name"] for s in snap["spans"]] == ["a"]
    assert [s["name"] for s in trace.snapshot()["spans"]] == ["a", "b"]
    trace.reset()
    assert trace.snapshot() == {"spans": [], "counts": [], "dropped": 0}
    assert trace.totals() == {}


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("s"):
                pass
    snap = trace.snapshot()
    assert len(snap["spans"]) == 3 and snap["dropped"] == 2


def test_counts_under_keys_past_the_cap_are_counted_not_kept(monkeypatch):
    """A count under a new key past MAX_SPANS keys is dropped; a count under
    a key that is kept still adds up."""
    monkeypatch.setattr(trace, "MAX_SPANS", 2)
    with trace.recording():
        for unit in range(4):
            with trace.span("step", unit=unit):
                trace.count("n", 5)
                trace.count("n", 1)
    assert trace.totals() == {"n": 12}
    # Two of the four spans and the four counts of units 2 and 3.
    assert trace.snapshot()["dropped"] == 2 + 4


# -- the render path ------------------------------------------------------------

CARPET_POINT = {"compute_dtype": "float32", "renderer": {"sorted_blocks": True},
                "instancer": {"ray_block": 64, "max_hits": 48, "max_steps_per_ray": 320,
                              "cull_budget": 448, "tri_cull_budget": 384}}


@pytest.fixture(scope="module")
def carpet_session(tmp_path_factory):
    """configs/config_carpet_render.py at 16x16 on the CPU, its culls on
    and ray blocks of 64 (four a frame), random weights."""
    from nerftex_torch.render.serve import RenderSession

    cfg = dict(importlib.import_module("configs.config_carpet_render").config,
               target_path=str(tmp_path_factory.mktemp("carpet")))
    cfg["renderer_config"] = dict(cfg["renderer_config"])
    inst = cfg["renderer_config"]["instancer_config"] = dict(
        cfg["renderer_config"]["instancer_config"])
    for k in ("mesh_path", "patch_origins_path"):
        inst[k] = os.path.join(ROOT, inst[k])
    inst["textures"] = [os.path.join(ROOT, t) if t.endswith(".png") else t
                        for t in inst["textures"]]
    session = RenderSession(cfg, height=16, width=16, operating_point=CARPET_POINT,
                            device="cpu")
    session.render([0.3, -0.7, 0.65])       # the first request uploads the proxy box
    return session


def test_a_render_session_request_records_its_layers(carpet_session, monkeypatch):
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    valid = []
    real = InstanceRenderer._eval_mlp

    def eval_mlp(self, pos, dirs, prms, mask):
        valid.append(int(mask.sum()))
        return real(self, pos, dirs, prms, mask)

    monkeypatch.setattr(InstanceRenderer, "_eval_mlp", eval_mlp)
    with trace.recording():
        img = carpet_session.render([0.3, -0.7, 0.65])
    assert img.shape == (16, 16, 4) and img[..., 3].max() > 0
    spans = _spans()
    names = Counter(s["name"] for s in spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["session.render"]
    assert {s["unit"] for s in spans} == {roots[0]["id"]}
    n_blocks = 256 // 64
    assert names["instancer.per_ray"] == n_blocks
    for child in ("per_ray.mesh_hit", "per_ray.slabs", "per_ray.events"):
        assert names[child] == n_blocks
    totals = trace.totals()
    assert names["instancer.block"] == totals["blocks"] == n_blocks
    shaded = n_blocks - totals.get("blocks.empty", 0)
    assert shaded == len(valid) > 0
    assert names["renderer.shade"] == names["instancer.per_sample"] == shaded
    # The MLP runs over every slot of the sorted grid and counts the
    # valid ones on the card.
    assert totals["mlp.rows"] == totals["grid.samples"]
    assert totals["mlp.valid"] == sum(valid)
    assert totals["cull.fit"] + totals["cull.full"] == 2 * n_blocks
    assert totals["dropped.hits"] >= 0 and totals["dropped.steps"] >= 0
    # Every host read, site by site: the pose, the parameters and the
    # offsets' keys in, the fan's axis and two culls a ray block, the
    # sorted blocks' table, the two drop counts and the two read-backs; a
    # shaded block reads nothing.
    sites = Counter(s["name"] for s in spans if s["name"].startswith("sync."))
    assert sites == Counter({"sync.pose": 1, "sync.copy": 1, "sync.keys": 1,
                             "sync.fan": n_blocks, "sync.cull": 2 * n_blocks,
                             "sync.block_table": 1,
                             "sync.overflow": 2, "sync.readback": 2})
    assert totals["sync"] == sum(sites.values())


PLUSH_POINT = {"compute_dtype": "float32", "renderer": {"sorted_blocks": True},
               "instancer": {"ray_block": 64, "max_hits": 128, "max_steps_per_ray": 1280,
                             "cull_budget": 384, "tri_cull_budget": 1024,
                             "shadow_cull_budget": 768, "shadow_tri_cull_budget": 1536}}
PLUSH_VIEW = ([0.2472136, -0.76084521, 0.6], [1, 1, 0.5, 0.3, 0.6])


@pytest.fixture(scope="module")
def plush_session(tmp_path_factory):
    """configs/config_plush_render.py (instances on the bunny's vertices,
    ``nearest_blend``, a directional light with shadows) at 16x16 on the
    CPU in ray blocks of 64, random weights."""
    from nerftex_torch.render.serve import RenderSession

    cfg = dict(importlib.import_module("configs.config_plush_render").config,
               target_path=str(tmp_path_factory.mktemp("plush")))
    cfg["renderer_config"] = dict(cfg["renderer_config"])
    inst = cfg["renderer_config"]["instancer_config"] = dict(
        cfg["renderer_config"]["instancer_config"])
    inst["mesh_path"] = os.path.join(ROOT, inst["mesh_path"])
    inst["textures"] = [os.path.join(ROOT, t) if t.endswith(".png") else t
                        for t in inst["textures"]]
    session = RenderSession(cfg, height=16, width=16, operating_point=PLUSH_POINT,
                            device="cpu")
    session.render(*PLUSH_VIEW, radius=4)
    return session


def _plush_request(session, monkeypatch):
    """One traced plush request: (totals, host-read sites, the samples
    under the MLP's mask whose pick weighed two or more active slots)."""
    from nerftex_torch.instancing import device
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    n_active, masks = [], []
    real_selk, real_eval = device.selk_resolve, InstanceRenderer._eval_mlp

    def selk_resolve(*args, **kwargs):
        out = real_selk(*args, **kwargs)
        n_active.append(out[2])
        return out

    def eval_mlp(self, pos, dirs, prms, mask):
        masks.append(mask)
        return real_eval(self, pos, dirs, prms, mask)

    monkeypatch.setattr(device, "selk_resolve", selk_resolve)
    monkeypatch.setattr(InstanceRenderer, "_eval_mlp", eval_mlp)
    trace.reset()
    with trace.recording():
        session.render(*PLUSH_VIEW, radius=4)
    monkeypatch.undo()
    assert len(n_active) == len(masks) > 0
    blended = sum(int((m & (n > 1)).sum()) for n, m in zip(n_active, masks))
    sites = Counter(s["name"] for s in _spans() if s["name"].startswith("sync."))
    return trace.totals(), sites, blended


def test_the_blended_pick_is_counted_on_the_device_without_a_host_read(plush_session,
                                                                       monkeypatch):
    ds = plush_session.renderer.instancer.device_instancer.ds
    assert ds.instance_sampling_method == "nearest_blend"
    totals, sites, blended = _plush_request(plush_session, monkeypatch)
    assert 0 < totals["pick.blend"] == blended < totals["mlp.valid"]
    ds.instance_sampling_method = "nearest"
    try:
        totals_n, sites_n, blended_n = _plush_request(plush_session, monkeypatch)
    finally:
        ds.instance_sampling_method = "nearest_blend"
    # Under ``nearest`` nothing is counted; the blended pick's count adds
    # no host read.
    assert blended_n > 0 and totals_n.get("pick.blend", 0) == 0
    assert sites == sites_n and totals["sync"] == totals_n["sync"]


# -- the training path ----------------------------------------------------------

def _train_dataset_config(tfr_path, prefetch):
    return {
        "module": "network.dataset.Dataset",
        "data_loader_config": {"module": "network.dataset.TFRecord", "tfr_path": tfr_path,
                               "cache_size": 2},
        "pixel_sampler_config": {"module": "network.pixel_sampler.Proxy", "n_samples": 32,
                                 "downsample_factor": 2},
        "ray_sampler_config": {"module": "network.ray_sampler.Proxy"},
        "proxy_config": {"module": "network.proxy.AABB", "b_0": [-1.5, -1.3, -0.2],
                         "b_1": [1.3, 1.3, 1.9]},
        "batchsize": 2,
        "shuffle_buffer_size": 8,
        "prefetch": prefetch,
    }


@pytest.fixture(scope="module")
def tfr_path(tmp_path_factory):
    from nerftex_torch.tools.synth import make_synthetic_tfrecord

    path = str(tmp_path_factory.mktemp("data") / "train.tfr")
    make_synthetic_tfrecord(path, n_images=8, size=16)
    return path


def test_a_host_fed_step_records_its_phases_and_the_decode_cache(tfr_path):
    """Three host-fed steps on eight images through a decode cache of two:
    each train.step holds its forward, loss, backward and optimizer spans,
    reads nothing back, and the cache counts a hit or a miss for every
    image read, a data.decode span for every miss."""
    from nerftex_torch.render.train import TrainState, build_step
    from nerftex_torch.utils import jax_rng, rng

    rng.set_seed(0)
    model_config = {
        "module": "network.model.ParamNerf",
        "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "n_parameters": [1, 6], "depth": 2, "width": 32, "skips": [],
    }
    loss_config = {"module": "network.loss.AlphaLoss", "loss_fn": "network.loss.smape",
                   "alpha_loss_fn": "network.loss.mse"}
    renderer_config = {"module": "network.renderer.Renderer", "n_samples": 8, "perturb": True}
    dataset, _, _, step = build_step(_train_dataset_config(tfr_path, 0), model_config,
                                     loss_config, 5e-3, 500, renderer_config, "cpu",
                                     TrainState())
    base = rng.stream_key(rng.STREAM_PERTURB)
    with trace.recording():
        for s, data in enumerate(dataset.take(3)):
            batch = {k: torch.as_tensor(v) for k, v in data.items()}
            loss = step(batch, jax_rng.fold_in(base, s))
    assert np.isfinite(float(loss))
    spans = _spans()
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == 3 and all(s["parent"] is None for s in steps)
    for root in steps:
        children = sorted(s["name"] for s in spans if s["parent"] == root["id"])
        assert children == ["step.backward", "step.forward", "step.loss", "step.optimizer"]
    units = {s["id"] for s in steps}
    assert sum(c["n"] for c in trace.snapshot()["counts"]
               if c["name"] == "sync" and c["unit"] in units) == 0
    totals = trace.totals()
    assert totals.get("decode.hit", 0) + totals["decode.miss"] == 3 * 2
    assert totals["decode.miss"] == len([s for s in spans if s["name"] == "data.decode"]) > 0


def test_the_prefetch_thread_records_each_batch_under_its_index(tfr_path):
    from nerftex_torch.utils.util import instantiate

    cfg = dict(_train_dataset_config(tfr_path, 2), n_epochs=1)
    dataset = instantiate(cfg)
    n = len(dataset)
    with trace.recording():
        batches = list(dataset.take(None))
    assert len(batches) == n == 4
    spans = _spans()
    made = sorted((s for s in spans if s["name"] == "data.batch"), key=lambda s: s["unit"])
    # One span a batch and one for the call that found the stream's end,
    # under units that no span id (a request's or a step's unit) can equal.
    assert [s["unit"] for s in made] == [("batch", i) for i in range(n + 1)]
    assert all(s["parent"] is None and s["thread"] != threading.get_ident() for s in made)
    waits = [s for s in spans if s["name"] == "data.wait"]
    assert len(waits) == n + 1 and all(s["thread"] == threading.get_ident() for s in waits)
    decodes = [s for s in spans if s["name"] == "data.decode"]
    assert decodes and all(s["unit"] in [("batch", i) for i in range(n + 1)] for s in decodes)


def _device_resident_run(tfr_path, device):
    """A FusedStep of 3 steps a dispatch built with ``device_resident``
    under the tracer, run for 2 steps, then 3; (its dataset, the spans)."""
    from nerftex_torch.render.train import FusedStep, TrainState, build_step
    from nerftex_torch.utils import rng

    rng.set_seed(0)
    model_config = {
        "module": "network.model.ParamNerf",
        "pos_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "dir_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "param_embedding": {"module": "network.model.FourierFeatures", "n_freq_bands": 2},
        "n_parameters": [1, 6], "depth": 2, "width": 32, "skips": [],
    }
    loss_config = {"module": "network.loss.AlphaLoss", "loss_fn": "network.loss.smape",
                   "alpha_loss_fn": "network.loss.mse"}
    renderer_config = {"module": "network.renderer.Renderer", "n_samples": 8, "perturb": True}
    with trace.recording():
        dataset, _, _, step = build_step(
            dict(_train_dataset_config(tfr_path, 0), device_resident=True), model_config,
            loss_config, 5e-3, 500, renderer_config, device, TrainState(), steps_per_dispatch=3)
        assert isinstance(step, FusedStep)
        step.run(0, 2)
        step.run(2, 3)
    return dataset, _spans()


def _steps_by_dispatch(roots, kind: str) -> list:
    return [sum(c["n"] for c in trace.snapshot()["counts"]
                if c["name"] == kind and c["unit"] == root["id"])
            for root in sorted(roots, key=lambda s: s["start_ns"])]


def test_a_device_resident_run_records_its_table_and_counts_its_steps(tfr_path):
    """The device-resident path on the CPU: building the sampler records one
    ``data.table`` span with the u8 table's bytes (N x H x W x 4 for PNG
    records) and views; each FusedStep run is a ``train.replay`` root whose
    ``train.replays`` and ``train.eager`` add up to the steps it ran (all
    eager on the CPU, where nothing is captured or launched)."""
    dataset, spans = _device_resident_run(tfr_path, "cpu")
    tables = [s for s in spans if s["name"] == "data.table"]
    assert len(tables) == 1 and tables[0]["parent"] is None
    sampler = dataset.device_sampler
    n, h, w = sampler.n_images, sampler.height, sampler.width
    counts = {c["name"]: c for c in trace.snapshot()["counts"]}
    assert counts["data.table_bytes"]["n"] == n * h * w * 4 == sampler.images.numel()
    assert counts["data.table_views"]["n"] == n == 8
    assert counts["data.table_bytes"]["unit"] == tables[0]["id"]
    roots = [s for s in spans if s["name"] == "train.replay"]
    assert len(roots) == 2 and all(s["parent"] is None for s in roots)
    assert [a + b for a, b in zip(_steps_by_dispatch(roots, "train.replays"),
                                  _steps_by_dispatch(roots, "train.eager"))] == [2, 3]
    totals = trace.totals()
    assert totals.get("train.replays", 0) + totals["train.eager"] == 5
    assert not [s for s in spans if s["name"] in ("train.capture", "train.launch")]


@pytest.mark.gpu
def test_a_device_resident_run_on_the_card_records_its_capture_and_launches(tfr_path):
    """On a CUDA card the first run captures the step once (one
    ``train.capture`` span under its ``train.replay`` root) and every step
    of both runs is a replay, each launch a ``train.launch`` span under its
    dispatch's root."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, spans = _device_resident_run(tfr_path, "cuda")
    roots = sorted((s for s in spans if s["name"] == "train.replay"),
                   key=lambda s: s["start_ns"])
    assert len(roots) == 2 and all(s["parent"] is None for s in roots)
    assert _steps_by_dispatch(roots, "train.replays") == [2, 3]
    assert _steps_by_dispatch(roots, "train.eager") == [0, 0]
    captures = [s for s in spans if s["name"] == "train.capture"]
    assert len(captures) == 1 and captures[0]["parent"] == roots[0]["id"]
    launches = [s for s in spans if s["name"] == "train.launch"]
    assert [sum(s["parent"] == r["id"] for s in launches) for r in roots] == [2, 3]
