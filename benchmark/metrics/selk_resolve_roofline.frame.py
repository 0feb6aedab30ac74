"""selk_resolve's share of its roofline over the traced run's profiled
frames: the least time its launches could take, summed, over their summed
device time.  A launch's least time is the larger of its bytes (each
input and output once) over the memory rate and its operations (per
window slot and per binary-search step that these inputs need) over the
float32 rate outside the tensor cores; ``selk_work`` and ``selk_bound``
are frozen copies of the smoke test's arithmetic (chip_smoke.py)."""

import torch

from benchmark.harness import peaks

KERNEL = "selk_resolve"
OPS_PER_SLOT = 15       # per (sample, slot of its stabbing window)
OPS_PER_STEP = 4        # per binary-search step: midpoint, load, compare, select


def selk_work(tk0, tk1, kvalid, t_pt):
    """[window slots, search steps, valid slots] that one launch needs.  A
    ray in render layout (valid slots a prefix, tk0 non-decreasing, each
    finite with tk0 < tk1) looks at the slots from the first whose prefix
    max of tk1 exceeds t to the last with tk0 <= t, found by two binary
    searches, and at least one; any other ray at each valid slot."""
    K = kvalid.shape[-1]
    n_valid = kvalid.sum(-1)
    prefix = (kvalid == (torch.arange(K, device=kvalid.device) < n_valid[:, None])).all(-1)
    t0 = torch.where(kvalid, tk0, float("inf"))
    t1 = torch.where(kvalid, tk1, -float("inf"))
    finite = torch.where(kvalid, torch.isfinite(tk0) & torch.isfinite(tk1) & (tk0 < tk1),
                         True).all(-1)
    flagged = prefix & finite & (t0[:, 1:] >= t0[:, :-1]).all(-1)
    t = t_pt.contiguous()
    hi = torch.searchsorted(t0.contiguous(), t, right=True)
    lo = torch.searchsorted(torch.cummax(t1, -1).values.contiguous(), t, right=True)
    slots = torch.where(flagged[:, None], (hi - lo).clamp(min=1), n_valid.clamp(min=1)[:, None])
    steps = (flagged * 2 * torch.ceil(torch.log2(n_valid + 1.0))).long().sum() * t.shape[1]
    return torch.stack([slots.sum(), steps, n_valid.sum()])


def selk_bound(rb, s, k, method, work):
    """(least seconds, what bounds it) of one launch that needs ``work``."""
    slots, steps, valid = work
    planes = 4 if method == "nearest" else 8
    record = 8 if method == "random" else 16
    t_bytes = (rb * s * (planes + 12) + rb * k + valid * record) / peaks.BYTES_PER_S
    t_ops = (OPS_PER_SLOT * slots + OPS_PER_STEP * steps) / peaks.F32_FLOPS
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes"


def read(trace):
    if trace.get("kind") != "session":
        return None
    p = trace["part2"]
    device = sum(s for name, (_, s) in p["ops"].items() if KERNEL in name)
    if not device or not p["selk"]:
        return None
    least = 0.0
    for method, tk0, tk1, kvalid, t_pt in p["selk"]:
        work = [int(x) for x in selk_work(tk0, tk1, kvalid, t_pt).tolist()]
        least += selk_bound(tk0.shape[0], t_pt.shape[1], tk0.shape[1], method, work)[0]
    return 100.0 * least / device
