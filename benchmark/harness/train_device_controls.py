"""Readings behind the limits of the carpet_full.train_device cell's
comparison (benchmark/limits/carpet_full.train_device.json): the
program's, those of the two controls in its place, and two faults'.  The
controls are the plain reference at the configuration's precision, bf16,
which must pass, and at the next lower one, e4m3, which must not
(reference/precision.py).  The faults must not pass either: a frozen
state (Adam's step does nothing, so the parameters never change) and half
the batch (the loss sees the first half of each step's rays).

    python3 -m benchmark.harness.train_device_controls --seed <n> [--fault frozen|half]

builds the cell's step as its harness does (train_device.py), at the
cell's size, runs its checked steps, under the fault if one is named, and
compares them as the harness does: the program's, then, on the same
batches, each control's in its place.  It prints one JSON line: each
comparison's readings, and the limits each fails.  It runs on a CUDA
card, or on the CPU without one.
"""

import argparse
import contextlib
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import manifest as mf  # noqa: E402
from benchmark.harness import train_device  # noqa: E402

CELL = "carpet_full.train_device"
CONTROLS = ("bf16", "e4m3")


@contextlib.contextmanager
def frozen():
    """Adam's step does nothing."""
    real = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, *args, **kwargs: None
    try:
        yield
    finally:
        torch.optim.Adam.step = real


@contextlib.contextmanager
def half():
    """The loss sees the first half of each step's rays."""
    from nerftex_torch.render.loss import AlphaLoss

    real = AlphaLoss.__call__

    def first_half(self, **kwargs):
        kwargs = {k: v[:v.shape[0] // 2] if torch.is_tensor(v) and v.dim() else v
                  for k, v in kwargs.items()}
        return real(self, **kwargs)

    AlphaLoss.__call__ = first_half
    try:
        yield
    finally:
        AlphaLoss.__call__ = real


FAULTS = {"frozen": frozen, "half": half}


def failing(checks: dict) -> list:
    return sorted(k for k, c in checks.items() if not c["value"] <= c["limit"])


def readings(cfg, mix, limits, seed, device, fault=None) -> dict:
    """{"program" | control: {"checks": {name: reading}, "failing": [...]}}
    of one seed's checked steps, under ``fault`` (a name of FAULTS)."""
    from nerftex_torch.render.train import step_counts

    eager0 = step_counts["eager_steps"]
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        cell = train_device.DeviceTrainCell(cfg, mix, seed, device)
        record = cell.checked_steps(int(mix["check_steps"]))
    record["eager_steps"] = step_counts["eager_steps"] - eager0
    setup = (cell.set_spec, cell.spec, cell.weights, cell.train)
    cell.free()
    out = {}
    for who in (None,) + CONTROLS:
        checks = train_device.check(record, *setup, seed, limits, device, precision=who)
        out[who or "program"] = {"checks": {k: c["value"] for k, c in checks.items()},
                                 "failing": failing(checks)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = mf.load()
    w = mf.cell(manifest, CELL)
    mix = mf.traffic(w["traffic"])
    device = "cuda" if torch.cuda.is_available() else "cpu"
    got = readings(mf.config(manifest, w["config"]), mix, mf.limits(CELL), args.seed, device,
                   args.fault)
    print(json.dumps({"seed": args.seed, "fault": args.fault,
                      "views": mix["swatches"]["views"], **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
