"""Traffic of kind "session": one client in a closed loop, each request a
pose and parameters handed to the program's RenderSession.render and
answered with a straight-alpha RGBA array on the host.

The mix file gives the image size (or "config": the configuration's own),
how many requests warm up, how many the traced run profiles, and how many
frames and pixels the check compares.  The configuration gives the
camera (a fixed direction, or an orbit: sphere coordinate u fixed, v in a
range) and the parameters (constants, with a light direction placed like
the camera where it names one).  Request i's v is the seed's offset plus i
times the golden ratio's fraction, mod 1, scaled to the range: any run's
requests cover the range evenly, so the seed orders the views but does not
change how much work a window holds, and two runs of one seed send the
same requests.
"""

import copy
import gc
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark.harness import check_render, probes
from benchmark.harness.profile import profiled
from benchmark.harness.weights import make_weights, write_checkpoint
from benchmark.reference.mlp import spec_of

# Instancer and renderer settings that the reference implements; any other
# value in effect stops the run (the reference would not be the program's
# function).
SUPPORTED = {"instance_sampling_method": ("nearest",), "texture_lookup": ("jacobian",),
             "deterministic_offset": (False,), "matmul_precision": ("float32",),
             "raw_noise_std": (0, 0.0), "false_color": (False,), "sample_budget_per_ray": (0,),
             "blur_idx": (None,), "use_mean_distance": (False,)}
# Settings read back from the built program, to hold it to the settings above.
INSTANCER_ATTRS = ("max_hits", "ray_block", "max_steps_per_ray", "shadow_samples",
                   "cull_budget", "tri_cull_budget", "shadow_cull_budget",
                   "shadow_tri_cull_budget", "deterministic_offset", "matmul_precision",
                   "texture_lookup")
RENDERER_ATTRS = ("step_size", "n_samples", "density_scale", "raw_noise_std", "false_color",
                  "sample_budget_per_ray", "blur_idx", "sorted_blocks")


def settings_in_effect(cfg: dict) -> dict:
    """The program's defaults, then the configuration, then the operating
    point frozen in the configuration, flattened into one dict.  The
    program is built at this point and the reference follows it, so a
    re-tuning of the program's own table changes neither: it has to come
    as a change of the configuration file."""
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


def note_table_drift(cfg: dict):
    """Say on standard error where the program's adopted point for the
    scene differs from the one the configuration freezes (the run keeps to
    the configuration's)."""
    from nerftex_torch import operating_points

    frozen = cfg["operating_point"]
    table = operating_points.resolve(frozen["scene"]) or {}
    drift = {f"{part}.{k}": (table.get(part, {}).get(k), v)
             for part in ("instancer", "renderer")
             for k, v in {**table.get(part, {}), **frozen[part]}.items()
             if table.get(part, {}).get(k) != frozen[part].get(k)}
    if drift:
        print(f"note: the program's operating point for {frozen['scene']!r} differs from the "
              f"configuration's (program, configuration): {drift}; the run keeps to the "
              f"configuration's", file=sys.stderr)


GOLDEN = (5 ** 0.5 - 1) / 2


class Requests:
    """The requests of one run: (unit camera direction, parameters [P])."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg = cfg
        # The camera's and the light's offsets on their ranges.
        self.offset = np.random.default_rng([int(seed), 1]).random(2)
        self.i = 0

    def _v(self, which: int, v_range) -> float:
        v0, v1 = v_range
        return v0 + (self.offset[which] + self.i * GOLDEN) % 1.0 * (v1 - v0)

    @staticmethod
    def _sphere(u, v):
        z = 1 - 2 * u
        az = 2 * np.pi * v
        ring = np.sqrt(max(1.0 - z * z, 0.0))
        return np.array([np.cos(az) * ring, np.sin(az) * ring, z])

    def __next__(self):
        cam = self.cfg["camera"]
        if "direction" in cam:
            direction = np.asarray(cam["direction"], np.float64)
        else:
            direction = self._sphere(cam["u"], self._v(0, cam["v"]))
        params = np.asarray(self.cfg["parameters"], np.float64)
        light = self.cfg.get("light")
        if light:
            params[light["slots"]] = self._sphere(light["u"], self._v(1, light["v"]))
        self.i += 1
        return direction, params.astype(np.float32)


class SessionCell:
    """One configuration's RenderSession at the mix's image size, its
    weights made from the seed and restored from a checkpoint."""

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
        note_table_drift(cfg)
        op = {"compute_dtype": cfg["compute_dtype"],
              "renderer": dict(cfg["operating_point"]["renderer"]),
              "instancer": dict(cfg["operating_point"]["instancer"])}
        self.session = RenderSession(render, self.height, self.width, operating_point=op,
                                     device=self.device)
        self._hold_to_settings()
        self.requests = Requests(cfg, seed)
        self.calls = 0          # renderer calls made: the next request's frame key
        self.records = []

    def _hold_to_settings(self):
        r = self.session.renderer
        inst = r.instancer.device_instancer
        got = {k: getattr(inst, k) for k in INSTANCER_ATTRS}
        got.update({k: getattr(r, k) for k in RENDERER_ATTRS})
        wrong = {k: (v, self.settings.get(k)) for k, v in got.items()
                 if v != self.settings.get(k)}
        if r.model.compute_dtype != torch.float32:
            wrong["compute_dtype"] = (r.model.compute_dtype, torch.float32)
        if wrong:
            raise ValueError(f"the program runs other settings than the reference: {wrong}")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def unit(self) -> float:
        """One request; its latency in seconds (inf if it failed)."""
        direction, params = next(self.requests)
        call = self.calls
        self.calls += 1
        t0 = time.perf_counter()
        try:
            img = self.session.render(direction, params, radius=self.cfg["camera"]["radius"])
        except Exception as e:  # a failed request misses every latency and fails the check
            self.records.append({"call": call, "direction": direction, "params": params,
                                 "img": None, "error": repr(e)})
            return float("inf")
        dt = time.perf_counter() - t0
        self.records.append({"call": call, "direction": direction, "params": params, "img": img})
        return dt

    def free(self):
        """Drop the program's state (the session and its device memory)."""
        self.session = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._ckpt.cleanup()


def window(cell: SessionCell, seconds: float):
    """Requests back to back until ``seconds`` have passed; the last one
    started inside the window is finished.  (latencies, wall seconds)."""
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        lat.append(cell.unit())
    return lat, time.perf_counter() - t0


def end_to_end(lat, wall, pixels) -> dict:
    """The loop's statistics, by the names a mix's "metrics" map from."""
    ok = [x for x in lat if np.isfinite(x)]
    ms = np.asarray(lat, np.float64) * 1e3
    return {
        "rays_per_s": pixels * len(ok) / wall,
        "latency_p95_ms": float(np.percentile(ms, 95)),
        "latency_p50_ms": float(np.percentile(ms, 50)),
        "latency_min_ms": float(ms.min()),
        "latency_max_ms": float(ms.max()),
    }


def run(cfg, mix, limits, seed, seconds, trace, device, root, control=False):
    """One run of the cell.  Returns (end-to-end statistics, the traced
    stretches' record or None, attempted, failed, memory peak, checks, the
    window's start on the perf_counter clock)."""
    cell = SessionCell(cfg, mix, seed, device)
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
    checks = check_render.check(records, cfg, settings, weights, spec, size, seed, limits, mix,
                                root, device, control=control)
    checks["bf16_launches"] = {"value": variants.get("wgmma_bf16", 0), "limit": 0}
    return stats, rec, attempted, failed, peak, checks, ready


def mlp_variants() -> dict:
    from nerftex_torch.kernels.mlp_fused import mlp_fused

    return dict(mlp_fused.variant_launches)


def traced(cell: SessionCell, mix: dict):
    """The traced run's three stretches: unprofiled requests (for the
    model-FLOP rate), profiled ones (launches, device busy time, kernel
    times, the breakdown) and synchronised ones (the stage split)."""
    n1, n2 = int(mix["trace_units"]), int(mix["profile_units"])
    with probes.mlp_rows() as rows1:
        t0 = time.perf_counter()
        for _ in range(n1):
            cell.unit()
        cell.sync()
        wall1 = time.perf_counter() - t0
    layers = ("session", "renderer", "per_ray", "shadow", "per_sample", "mlp")
    with probes.labels(layers), probes.mlp_rows() as rows2, probes.selk_inputs() as selk:
        prof = profiled(lambda: [cell.unit() for _ in range(n2)], cell.sync)
    with probes.stage_timer(layers[:5], cell.sync) as stages:
        for _ in range(n2):
            cell.unit()
    rec = {
        "kind": "session", "spec": cell.spec, "pixels": cell.height * cell.width,
        "part1": {"wall_s": wall1, "units": n1, "rows": rows1["infer"]},
        "part2": dict(prof, units=n2, mlp_launch_rows=rows2["launches"], selk=selk),
        "part3": {"units": n2, "seconds": dict(stages)},
    }
    return rec
