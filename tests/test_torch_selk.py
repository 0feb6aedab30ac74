"""nerftex_torch's selk_resolve_plain (the CPU path of the selk_resolve
kernel and the port's overlap-resolution chain) against the JAX package's
Pallas kernel in interpret mode and against its XLA chain
(tests/test_selk_kernel.py's _ref_chain), on that file's cases and
tolerances: sel_k and n_active exact for nearest and random; a
nearest_blend pick may differ only where u sits within 1e-6 of a cum value
(the sums associate differently); p_sel within rtol 1e-4 where the picks
agree.  The plain version rounds the anchor distance as XLA does
(selk_resolve.anchor_d2): over 40 seeds of these shapes no pick differed
and p_sel stayed within 7.7e-5 relative; rounding each operation instead
flipped picks 6.4e-6 from a cum value and moved p_sel by 8e-4."""

import os
import sys
import zlib

import jax
import numpy as np
import pytest
import torch

from nerftex_tpu.kernels.selk_resolve import selk_resolve as jax_selk
from nerftex_torch.kernels.selk_resolve import selk_resolve, selk_resolve_plain
from tests.test_selk_kernel import _inputs, _ref_chain

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_reference import group, recorded  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

MODULE = "test_torch_selk"
BLEND = 0.15
METHODS = ["nearest_blend", "nearest", "random"]
SHAPES = [(16, 32, 24), (8, 130, 128), (12, 17, 48)]


def _torch(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


def _check(got, want, method, u, cum):
    (sel, p, n), (w_sel, w_p, w_n) = [tuple(np.asarray(x) for x in o) for o in (got, want)]
    assert sel.dtype == n.dtype == np.int32 and p.dtype == np.float32
    np.testing.assert_array_equal(n, w_n)
    mism = sel != w_sel
    if method != "nearest_blend":
        assert not mism.any(), f"{method}: {mism.sum()} picks differ"
    elif mism.any():
        edge = np.min(np.abs(np.asarray(u)[..., None] - np.asarray(cum)), -1)
        assert (edge[mism] <= 1e-6).all(), f"max edge {edge[mism].max()}"
        assert mism.mean() < 1e-2
    np.testing.assert_allclose(p[~mism], w_p[~mism], rtol=1e-4, atol=1e-7)


def _jax_chain_and_kernel(method, rb, s, k):
    """The case's inputs (drawn from its key), and the XLA chain's and the
    Pallas kernel's (interpret mode) sel_k, p_sel, n_active; the chain's
    cum where a nearest_blend pick may sit on its knife edge."""
    args = _inputs(jax.random.key(zlib.crc32(f"{method}{rb},{s},{k}".encode()) % 2**31), rb, s, k)
    chain = jax.jit(_ref_chain, static_argnums=(7,))(*args, method, BLEND)
    kernel = jax_selk(*args, method=method, blend_range=BLEND, interpret=True)
    out = {f"args/{i}": np.asarray(a) for i, a in enumerate(args)}
    out.update({f"chain/{i}": np.asarray(x) for i, x in enumerate(chain[:3])})
    out.update({f"kernel/{i}": np.asarray(x) for i, x in enumerate(kernel)})
    if method == "nearest_blend":
        out["cum"] = np.asarray(chain[3])
    return out


def _outputs(arrays):
    return tuple(arrays[str(i)] for i in range(len(arrays)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("rb,s,k", SHAPES)
def test_plain_matches_jax_kernel_and_chain(method, rb, s, k):
    want = recorded(MODULE, f"test_plain_matches_jax_kernel_and_chain[{rb}-{s}-{k}-{method}]")
    args = _outputs(group(want, "args/"))
    cum = want.get("cum")
    got = selk_resolve_plain(*_torch(args), method=method, blend_range=BLEND)
    _check(got, _outputs(group(want, "chain/")), method, args[-1], cum)
    _check(got, _outputs(group(want, "kernel/")), method, args[-1], cum)


def _fallback_args():
    rb, s, k = 8, 16, 24
    tk0 = np.tile(np.linspace(10.0, 12.0, k, dtype=np.float32)[None], (rb, 1))
    kvalid = np.ones((rb, k), bool)
    kvalid[0] = False
    return (tk0, tk0 + 0.5, kvalid, np.full((rb, k), 4.0, np.float32),
            -np.ones((rb, k), np.float32),
            np.tile(np.linspace(0.0, 2.0, s, dtype=np.float32)[None], (rb, 1)),
            np.full((rb, s), 0.5, np.float32))


def _jax_fallback():
    """The Pallas kernel (interpret mode) on _fallback_args() by method."""
    return {f"{method}/{i}": np.asarray(x) for method in METHODS
            for i, x in enumerate(jax_selk(*_fallback_args(), method=method, blend_range=0.1,
                                           interpret=True))}


def test_plain_fallback_and_all_invalid():
    """No active interval: the nearest interval alone; all-invalid rows
    pick slot 0 with n_active 1."""
    args = _fallback_args()
    recording = recorded(MODULE, "test_plain_fallback_and_all_invalid")
    for method in METHODS:
        want = _outputs(group(recording, f"{method}/"))
        sel, p, n = selk_resolve_plain(*_torch(args), method=method, blend_range=0.1)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(n.numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(p.numpy(), np.asarray(want[1]), rtol=1e-6)
        assert (n.numpy() == 1).all() and (sel.numpy()[0] == 0).all()


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = _torch(_inputs(jax.random.key(3), 5, 9, 7))
    before = selk_resolve.launches
    for a, b in zip(selk_resolve(*args, method="nearest"),
                    selk_resolve_plain(*args, method="nearest")):
        assert torch.equal(a, b)
    assert selk_resolve.launches == before
    with pytest.raises(ValueError):
        selk_resolve(*(a.to("meta") for a in args), method="nearest")


JAX_CASES = {
    **{f"test_plain_matches_jax_kernel_and_chain[{rb}-{s}-{k}-{method}]":
       (lambda method=method, rb=rb, s=s, k=k: _jax_chain_and_kernel(method, rb, s, k))
       for method in METHODS for rb, s, k in SHAPES},
    "test_plain_fallback_and_all_invalid": _jax_fallback,
}
