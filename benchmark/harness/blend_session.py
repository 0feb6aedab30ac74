"""Traffic of kind "blend_session": the "session" kind's closed loop of whole
frames (benchmark/harness/session.py: its requests, window, statistics and
traced stretches, whose record keeps the kind "session"), for a
configuration whose instances may sit on the mesh's vertices and whose
overlaps may resolve by ``nearest_blend``.

Its settings admit ``nearest`` and ``nearest_blend`` and stop on any other
pick.  Its check is check_render.check's comparison (the same frames and
pixels drawn from the seed, the same ratios against the TF32 reference,
the same limits) with benchmark/reference/blend.py as the reference: the
blended pick draws each sample's uniform by the ray's place in the frame
sorted by step count, so every checked frame is first laid out whole by
the reference.
"""

import copy
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import session
from benchmark.harness.check_render import _premult, _ratio
from benchmark.harness.session import Requests, end_to_end, mlp_variants, traced, window
from benchmark.harness.weights import make_weights, write_checkpoint
from benchmark.reference.blend import BlendRenderer, scene_tables
from benchmark.reference.mlp import ReferenceMLP, spec_of
from benchmark.reference.render import look_at, pixel_rays, proxy_t, straight_rgba

SUPPORTED = dict(session.SUPPORTED, instance_sampling_method=("nearest", "nearest_blend"))


def settings_in_effect(cfg: dict) -> dict:
    """session.settings_in_effect, held to this kind's SUPPORTED."""
    op = cfg["operating_point"]
    r_cfg = cfg["render"]["renderer_config"]
    s = dict(cfg["instancer_defaults"])
    s.update({k: v for k, v in r_cfg["instancer_config"].items() if k != "module"})
    s.update(op["instancer"])
    s.update(cfg["renderer_defaults"])
    s.update({k: v for k, v in r_cfg.items() if k not in ("module", "instancer_config")})
    s.update(op["renderer"])
    for key, allowed in SUPPORTED.items():
        if s.get(key) not in allowed:
            raise ValueError(f"{key}={s.get(key)!r} in effect: the reference implements "
                             f"{allowed}")
    return s


class BlendSessionCell(session.SessionCell):
    """session.SessionCell under this kind's settings."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from nerftex_torch.render.serve import RenderSession

        self.cfg, self.device = cfg, torch.device(device)
        self.settings = settings_in_effect(cfg)
        render = copy.deepcopy(cfg["render"])
        loader = render["test_dataset_config"]["data_loader_config"]
        size = mix.get("size", "config")
        self.height, self.width = ((loader["height"], loader["width"]) if size == "config"
                                   else tuple(size))
        self.spec = spec_of(dict(render["model_config"]))
        self.weights = make_weights(self.spec, seed, self.device)
        self._ckpt = tempfile.TemporaryDirectory(prefix="benchmark_ckpt_")
        render["target_path"] = write_checkpoint(self.weights, self._ckpt.name)
        session.note_table_drift(cfg)
        op = {"compute_dtype": cfg["compute_dtype"],
              "renderer": dict(cfg["operating_point"]["renderer"]),
              "instancer": dict(cfg["operating_point"]["instancer"])}
        self.session = RenderSession(render, self.height, self.width, operating_point=op,
                                     device=self.device)
        self._hold_to_settings()
        self.requests = Requests(cfg, seed)
        self.calls = 0
        self.records = []


def reference(cfg, settings, weights, spec, root, device) -> BlendRenderer:
    """The reference of the configuration's frames: the float32 MLP and the
    TF32 control's."""
    dev = torch.device(device)
    return BlendRenderer(scene_tables(settings, root), settings,
                         [ReferenceMLP(spec, weights, dev),
                          ReferenceMLP(spec, weights, dev, tf32=True)], dev)


def check(records, cfg, settings, weights, spec, size, seed, limits, mix, root, device,
          control=False) -> dict:
    dev = torch.device(device)
    render = cfg["render"]
    loader = render["test_dataset_config"]["data_loader_config"]
    proxy = render["test_dataset_config"]["proxy_config"]
    height, width = size
    ref = reference(cfg, settings, weights, spec, root, dev)
    rng = np.random.default_rng([int(seed), 2])
    answered = [r for r in records if r["img"] is not None]
    n_frames = min(int(mix["check_frames"]), len(answered))
    picks = sorted(rng.choice(len(answered), size=n_frames, replace=False).tolist())
    errors, tf32 = [], []
    t0 = time.perf_counter()
    for i in picks:
        rec = answered[i]
        c2w = look_at(rec["direction"] * cfg["camera"]["radius"])
        all_px = torch.arange(height * width)
        o, d = pixel_rays(c2w, height, width, loader["angle"], all_px, dev)
        t = proxy_t(o, d, proxy["b_0"], proxy["b_1"])
        inside = torch.nonzero(torch.isfinite(t[:, 0])).flatten().cpu().numpy()
        if len(inside) == 0:
            continue
        px = np.sort(rng.choice(inside, size=min(int(mix["check_pixels"]), len(inside)),
                                replace=False))
        px_t = torch.as_tensor(px, device=dev)
        want, low = (_premult(straight_rgba(*out)) for out in
                     ref.render_frame(o, d, t, rec["params"], render.get("seed", 0),
                                      rec["call"], px))
        got = low if control else _premult(
            torch.as_tensor(rec["img"].reshape(-1, 4), device=dev)[px_t])
        drawn = want[:, 3] > 0
        errors.append((got - want).abs().amax(-1)[drawn])
        tf32.append((low - want).abs().amax(-1)[drawn])
    print(f"check: {len(picks)} frames against the reference in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    err = torch.cat(errors) if errors else torch.zeros(0, device=dev)
    base = torch.cat(tf32) if tf32 else torch.zeros(0, device=dev)
    return {
        "median_vs_tf32": {"value": _ratio(err, base, 0.5), "limit": limits["median_vs_tf32"]},
        "p90_vs_tf32": {"value": _ratio(err, base, 0.9), "limit": limits["p90_vs_tf32"]},
        "failed_requests": {"value": len(records) - len(answered), "limit": 0},
    }


def run(cfg, mix, limits, seed, seconds, trace, device, root, control=False):
    """One run of the cell, as session.run."""
    cell = BlendSessionCell(cfg, mix, seed, device)
    for _ in range(int(mix["warm_units"])):
        cell.unit()
    cell.sync()
    cell.records.clear()
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    ready = time.perf_counter()

    rec = None
    if not trace:
        lat, wall = window(cell, seconds)
        stats = end_to_end(lat, wall, cell.height * cell.width)
        stats["units"] = len(lat)
    else:
        rec = traced(cell, mix)
        stats = {}
    variants = mlp_variants()
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0
    failed = sum(1 for r in cell.records if r["img"] is None)
    attempted = len(cell.records)
    records, weights, settings, spec, size = (cell.records, cell.weights, cell.settings,
                                              cell.spec, (cell.height, cell.width))
    cell.free()
    checks = check(records, cfg, settings, weights, spec, size, seed, limits, mix, root, device,
                   control=control)
    checks["bf16_launches"] = {"value": variants.get("wgmma_bf16", 0), "limit": 0}
    return stats, rec, attempted, failed, peak, checks, ready
