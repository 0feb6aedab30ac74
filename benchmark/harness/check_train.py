"""The comparison that decides ``correct`` for the training cell.

The reference (benchmark/reference/train.py) follows the program's first
steps from the same weights on the same batches.  It takes the batches as
the program's data pipeline made them, so that stage is checked by itself
first: each row's view is found by its parameters among the set's
(swatches.views), its pixel by inverting the view's camera at the row's
direction, and its origin, direction, proxy interval, cone footprint,
color and alpha are worked out again from the pixel and the image
(swatches.draw).  The numbers compared:

- ``data_max_err``: the largest difference of a row from its rework;
- ``data_bad_rows``: rows whose pixel is not a whole pixel of a view, that
  repeat another row of their view in the batch, or whose whole batch
  repeats an earlier one (limit 0);
- ``loss0_gap``: the relative gap of the first step's loss.  The later
  steps' losses are printed, not compared: after Adam's first update they
  part by the sign of near-zero gradients, which moves a parameter by the
  learning rate whatever its gradient's size (one seed in fifteen read
  2.6e-4 at step 3 against 8e-6 for its first gradient);
- ``grad_gap``: by the worst leaf, the gap between the program's and the
  reference's norm of the first gradient (the program's worked out from
  Adam's first moment after one step), over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same for the parameters' change over the steps.

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding, such as a bias under a softmax) are left out
of ``update_gap``: Adam moves them by round-off alone.  With ``control``
the reference in TF32 takes the program's place.
"""

import math
import sys

import numpy as np
import torch

from benchmark.harness.swatches import draw, views
from benchmark.reference.train import run_steps

SMALL_LEAF = 1e-3


def _norm_gap(name: str, got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap of norms (printed with its leaf)."""
    norms = {k: float(torch.linalg.norm(v.float())) for k, v in want.items()}
    floor = float(np.median(list(norms.values())))
    gaps = {k: abs(float(torch.linalg.norm(got[k].float())) - norms[k]) / max(norms[k], floor)
            for k in want if keep is None or keep[k]}
    worst = max(gaps, key=gaps.get)
    print(f"{name}: worst leaf {worst} ({gaps[worst]:.3g}; its norm {norms[worst]:.3g}, the "
          f"median leaf's {floor:.3g}); median leaf gap {float(np.median(list(gaps.values()))):.3g}",
          file=sys.stderr)
    return gaps[worst]


def _rays(pose, loc, size, angle, proxy):
    """Rays of integer pixels loc [N, 2] as the training set's camera makes
    them: origin, unit direction, proxy interval, cone footprint (float32
    arithmetic throughout: the focal length is a Python float)."""
    focal = size / math.tan(angle / 2) / 2
    loc = loc.astype(np.float32)
    dirs = np.stack([(loc[:, 1] + 0.5 - 0.5 * size) / focal,
                     -(loc[:, 0] + 0.5 - 0.5 * size) / focal,
                     -np.ones(len(loc), np.float32)], -1)
    d = np.sum(dirs[:, None, :] * pose[:3, :3], -1)
    o = np.broadcast_to(pose[:3, -1], d.shape)
    cone = np.cos(np.arctan(np.linalg.norm(dirs[:, :2], axis=-1))) \
        / np.linalg.norm(dirs, axis=-1) / focal
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    b_0, b_1 = (np.asarray(proxy[k], np.float32) for k in ("b_0", "b_1"))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        t_a, t_b = (b_0 - o) * inv, (b_1 - o) * inv
    t0, t1 = np.minimum(t_a, t_b).max(-1), np.maximum(t_a, t_b).min(-1)
    hit = t0 < t1
    t = np.stack([np.where(hit, t0, np.inf), np.where(hit, t1, np.inf)], -1).astype(np.float32)
    return o.astype(np.float32), d, t, cone[:, None].astype(np.float32)


def check_data(batches, set_spec, seed, proxy, device):
    """(largest difference of a row from its rework, bad rows)."""
    vs = views(set_spec["views"], set_spec["n_parameters"], set_spec["radius"], seed)
    by_params = {p.tobytes(): (pose, p) for pose, p in vs}
    # The records hold the camera's angle as float32, as the loader reads it.
    size, angle = set_spec["size"], float(np.float32(set_spec["angle"]))
    focal = size / math.tan(angle / 2) / 2
    err, bad, seen = 0.0, 0, set()
    for batch in batches:
        for b in range(batch["parameters"].shape[0]):
            view = by_params.get(np.asarray(batch["parameters"][b], np.float32).tobytes())
            if view is None:
                bad += batch["rays_o"].shape[1]
                continue
            pose, params = view
            img = draw(pose, params, size, angle, device).astype(np.float32) / 255.0
            # The camera's frame is not orthonormal to float32 near the pole
            # (look_at's guards): invert it rather than transpose it.
            cam = np.linalg.solve(pose[:3, :3].astype(np.float64),
                                  batch["rays_d"][b].astype(np.float64).T).T
            col = cam[:, 0] / -cam[:, 2] * focal - 0.5 + 0.5 * size
            row = -cam[:, 1] / -cam[:, 2] * focal - 0.5 + 0.5 * size
            loc = np.stack([np.rint(row), np.rint(col)], -1)
            whole = ((np.abs(loc - np.stack([row, col], -1)).max(-1) < 1e-2)
                     & (loc >= 0).all(-1) & (loc < size).all(-1))
            bad += int((~whole).sum())
            loc = np.clip(loc, 0, size - 1).astype(np.int64)
            o, d, t, cone = _rays(pose, loc, size, angle, proxy)
            px = img[loc[:, 0], loc[:, 1]]
            want = {"rays_o": o, "rays_d": d, "t": t, "cone_scale": cone,
                    "color": px[:, :3] * px[:, 3:], "alpha": px[:, 3]}
            for k, v in want.items():
                got = np.asarray(batch[k][b], np.float32)
                fin = np.isfinite(v) & np.isfinite(got)
                if (np.isfinite(v) != np.isfinite(got)).any():
                    bad += 1
                if fin.any():
                    err = max(err, float(np.abs(got[fin] - v[fin]).max()))
            bad += len(loc) - len({(r, c) for r, c in loc.tolist()})
        digest = batch["rays_d"].tobytes()
        bad += batch["rays_d"].shape[0] * batch["rays_d"].shape[1] if digest in seen else 0
        seen.add(digest)
    return err, bad


def check(record, set_spec, spec, weights, train, seed, limits, device, control=False) -> dict:
    dev = torch.device(device)
    proxy = train["train_dataset_config"]["proxy_config"]
    data_err, data_bad = check_data(record["batches"], set_spec, seed, proxy, dev)
    ref = run_steps(spec, weights, record["batches"], train["seed"], train, dev)
    if control:
        got = run_steps(spec, weights, record["batches"], train["seed"], train, dev, tf32=True)
    else:
        got = {"losses": record["losses"], "grad0": record["grad0"],
               "delta": {k: record["after"][k].to(dev) - torch.as_tensor(weights[k], device=dev)
                         for k in weights}}
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    print("loss gap by step: " + ", ".join(f"{g:.3g}" for g in gaps), file=sys.stderr)
    g_norm = {k: float(torch.linalg.norm(v)) for k, v in ref["grad0"].items()}
    g_floor = float(np.median(list(g_norm.values())))
    keep = {k: v >= SMALL_LEAF * g_floor for k, v in g_norm.items()}
    grad0 = {k: v.to(dev) for k, v in got["grad0"].items()}
    return {
        "data_max_err": {"value": data_err, "limit": limits["data_max_err"]},
        "data_bad_rows": {"value": data_bad, "limit": 0},
        "loss0_gap": {"value": gaps[0], "limit": limits["loss0_gap"]},
        "grad_gap": {"value": _norm_gap("grad_gap", grad0, ref["grad0"]),
                     "limit": limits["grad_gap"]},
        "update_gap": {"value": _norm_gap("update_gap", got["delta"], ref["delta"], keep),
                       "limit": limits["update_gap"]},
    }
