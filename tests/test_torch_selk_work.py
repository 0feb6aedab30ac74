"""chip_smoke.selk_work, the work selk_resolve's bound counts, against a
count made slot by slot: on a ray in render layout each sample's stabbing
window (slots with tk0 <= t whose prefix max of tk1 exceeds t, at least
one) holds every active slot; any other ray counts its valid slots."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _render(rs, rb, s, k):
    n_valid = rs.randint(0, k + 1, rb)
    n_valid[::5] = k
    kvalid = np.arange(k)[None, :] < n_valid[:, None]
    tk0 = np.sort(rs.uniform(0.5, 3.0, (rb, k)), -1)
    tk1 = tk0 + rs.uniform(0.01, 0.6, (rb, k))
    t_pt = np.sort(rs.uniform(0.0, 4.0, (rb, s)), -1)
    return np.where(kvalid, tk0, np.inf), np.where(kvalid, tk1, np.inf), kvalid, t_pt


def _mixed(rs, rb, s, k):
    """Render layout but for a few rays: a hole in the prefix, tk0 out of
    order, an empty interval."""
    tk0, tk1, kvalid, t_pt = _render(rs, rb, s, k)
    kvalid[0, :] = True
    kvalid[0, 1] = False
    tk0[1, :2] = tk0[1, 1::-1]
    tk1[2, 0] = tk0[2, 0]
    return tk0, tk1, kvalid, t_pt


@pytest.mark.parametrize("layout", ["render", "mixed"])
def test_selk_work_counts_windows(layout):
    cs = _chip_smoke()
    rb, s, k = 40, 30, 12
    make = {"render": _render, "mixed": _mixed}[layout]
    tk0, tk1, kvalid, t_pt = make(np.random.RandomState(7), rb, s, k)
    f32 = lambda x: torch.tensor(x.astype(np.float32))  # noqa: E731
    args = (f32(tk0), f32(tk1), torch.tensor(kvalid), f32(t_pt))
    slots, steps, valid = cs.selk_work(*args).tolist()

    tk0, tk1, t_pt = (x.numpy().astype(np.float64) for x in (args[0], args[1], args[3]))
    want_slots = want_steps = scanned = 0
    for r in range(rb):
        kv = kvalid[r]
        n = int(kv.sum())
        iv = tk0[r][kv], tk1[r][kv]
        flagged = (kv[:n].all() and np.isfinite(iv).all() and (iv[0] < iv[1]).all()
                   and (np.diff(iv[0]) >= 0).all())
        if not flagged:
            scanned += 1
            want_slots += s * max(n, 1)
            continue
        pmax = np.maximum.accumulate(np.where(kv, tk1[r], -np.inf))
        want_steps += s * 2 * int(np.ceil(np.log2(n + 1)))
        for t in t_pt[r]:
            window = kv & (tk0[r] <= t) & (pmax > t)
            active = kv & (tk0[r] <= t) & (t < tk1[r])
            assert not (active & ~window).any()
            assert np.flatnonzero(window).size == 0 or np.all(np.diff(np.flatnonzero(window)) == 1)
            want_slots += max(int(window.sum()), 1)
    assert (slots, steps, valid) == (want_slots, want_steps, int(kvalid.sum()))
    assert (scanned == 0) == (layout == "render")
