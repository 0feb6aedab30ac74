"""The comparison that decides ``correct`` for frames and previews.

Once the window has closed and the program's state is freed, frames drawn
from the seed among those the run answered are rendered again by the
reference (benchmark/reference) at pixels drawn from the seed among those
whose ray meets the proxy box, from the same pose, parameters and
weights, and with the marching offsets of that request's frame key, once
with the float32 MLP and once with every product's operands rounded to
TF32 (the lower-precision control).  A pixel's error is the largest
difference of its premultiplied color and alpha from the float32
reference's; the pixels compared are those that the reference draws
(alpha above 0).  How far a pixel's value moves under rounding depends on
the seed's weights, so each number is taken in units of the same number
for the TF32 reference on the same pixels:

- ``median_vs_tf32``: the median error over the TF32 reference's median
  error; a lower precision anywhere in the MLP moves it on every pixel,
  and a rare knife edge (a sample on a tie of two anchors, a shadow
  bucket's edge) does not;
- ``p90_vs_tf32``: the same for the 90th percentiles, which a wrong
  answer on a tenth of the pixels or more moves as well;
- ``failed_requests``: requests that raised (limit 0).

With ``control`` the TF32 reference takes the program's place, and both
ratios read 1.
"""

import numpy as np
import torch

from benchmark.reference.mlp import ReferenceMLP
from benchmark.reference.render import (ReferenceRenderer, frame_offsets, look_at, pixel_rays,
                                        proxy_t, straight_rgba)
from benchmark.reference.scene import SceneTables


def _ratio(err, base, q):
    """The q-quantile of err over that of base: inf with nothing to
    compare, or where base's is 0 and err's is not."""
    if not len(err):
        return float("inf")
    e, b = (float(torch.quantile(x.double(), q)) for x in (err, base))
    return e / b if b > 0 else (0.0 if e == 0 else float("inf"))


def _premult(rgba):
    return torch.cat([rgba[:, :3] * rgba[:, 3:], rgba[:, 3:]], -1)


def check(records, cfg, settings, weights, spec, size, seed, limits, mix, root, device,
          control=False) -> dict:
    dev = torch.device(device)
    render = cfg["render"]
    loader = render["test_dataset_config"]["data_loader_config"]
    proxy = render["test_dataset_config"]["proxy_config"]
    height, width = size
    scene = SceneTables(settings, root)
    ref = ReferenceRenderer(scene, settings, [ReferenceMLP(spec, weights, dev),
                                              ReferenceMLP(spec, weights, dev, tf32=True)], dev)
    rng = np.random.default_rng([int(seed), 2])
    answered = [r for r in records if r["img"] is not None]
    n_frames = min(int(mix["check_frames"]), len(answered))
    picks = sorted(rng.choice(len(answered), size=n_frames, replace=False).tolist())
    errors, tf32 = [], []
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
        u_off = frame_offsets(render.get("seed", 0), rec["call"], height * width,
                              int(settings["ray_block"]), px, dev)
        params = torch.as_tensor(rec["params"], device=dev)[None].expand(len(px), -1)
        want, low = (_premult(straight_rgba(*out)) for out in
                     ref.render(o[px_t], d[px_t], t[px_t], params, u_off))
        got = low if control else _premult(
            torch.as_tensor(rec["img"].reshape(-1, 4), device=dev)[px_t])
        drawn = want[:, 3] > 0
        errors.append((got - want).abs().amax(-1)[drawn])
        tf32.append((low - want).abs().amax(-1)[drawn])
    err = torch.cat(errors) if errors else torch.zeros(0, device=dev)
    base = torch.cat(tf32) if tf32 else torch.zeros(0, device=dev)
    return {
        "median_vs_tf32": {"value": _ratio(err, base, 0.5), "limit": limits["median_vs_tf32"]},
        "p90_vs_tf32": {"value": _ratio(err, base, 0.9), "limit": limits["p90_vs_tf32"]},
        "failed_requests": {"value": len(records) - len(answered), "limit": 0},
    }
