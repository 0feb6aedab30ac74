"""Spans and counts that the benchmark takes around its calls into the
program's layers, by wrapping them for the length of a ``with`` block.

- ``labels``: a profiler range (torch.autograd.profiler.record_function,
  named ``bench:<layer>``) around each layer call, so that an idle gap on
  the device can be put down to what the host was doing; no
  synchronisation.
- ``stage_timer``: synchronised host time of each layer call, summed.
- ``mlp_rows``: the rows of every ParamNerf.infer call and of every
  mlp_fused launch, read from the shapes (no synchronisation).
- ``selk_inputs``: a copy of the inputs of every selk_resolve launch, for
  its work count after the stretch.
"""

import contextlib
import time

import torch

# (module, attribute path) of each layer entry the benchmark wraps.
LAYERS = {
    "session": ("nerftex_torch.render.serve", "RenderSession.render"),
    "renderer": ("nerftex_torch.render.instance_renderer", "InstanceRenderer.__call__"),
    "per_ray": ("nerftex_torch.instancing.device", "DeviceInstancer._per_ray"),
    "shadow": ("nerftex_torch.instancing.device", "DeviceInstancer._shadow_blocked_sparse"),
    "per_sample": ("nerftex_torch.instancing.device", "DeviceInstancer._per_sample_grid"),
    "mlp": ("nerftex_torch.models.mlp", "ParamNerf.infer"),
}


def _owner(layer):
    import importlib

    module, path = LAYERS[layer]
    obj = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        obj = getattr(obj, p)
    return obj, attr


@contextlib.contextmanager
def wrapped(layers, make):
    """Each layer's entry replaced by make(layer, real) inside the block."""
    saved = []
    try:
        for layer in layers:
            owner, attr = _owner(layer)
            own = owner.__dict__.get(attr)
            setattr(owner, attr, make(layer, getattr(owner, attr)))
            saved.append((owner, attr, own))
        yield
    finally:
        for owner, attr, own in reversed(saved):
            if own is None:
                delattr(owner, attr)      # it was inherited
            else:
                setattr(owner, attr, own)


def labels(layers):
    """Profiler ranges ``bench:<layer>`` around the layers' calls."""
    def make(layer, real):
        def call(*a, **k):
            with torch.autograd.profiler.record_function(f"bench:{layer}"):
                return real(*a, **k)
        return call
    return wrapped(layers, make)


@contextlib.contextmanager
def stage_timer(layers, sync):
    """Yields {layer: seconds}: each call's host time between a
    synchronisation before it and one after it, summed per layer."""
    seconds = dict.fromkeys(layers, 0.0)

    def make(layer, real):
        def call(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = real(*a, **k)
            sync()
            seconds[layer] += time.perf_counter() - t0
            return out
        return call

    with wrapped(layers, make):
        yield seconds


@contextlib.contextmanager
def mlp_rows():
    """Yields {"infer": rows through ParamNerf.infer, "launches": [rows of
    each mlp_fused launch]}."""
    import nerftex_torch.models.mlp as mlp

    counts = {"infer": 0, "launches": []}
    real_module = mlp.fused
    real_infer = mlp.ParamNerf.__dict__["infer"]

    class Kernel:
        """The kernel module as ParamNerf.infer sees it, counting launches."""

        def __getattr__(self, name):
            return getattr(real_module, name)

        @staticmethod
        def mlp_fused(pos_map, dir_map, packed):
            counts["launches"].append(int(pos_map.shape[0]))
            return real_module.mlp_fused(pos_map, dir_map, packed)

    def infer(self, pos, dirs, prms):
        counts["infer"] += int(pos.shape[0])
        return real_infer(self, pos, dirs, prms)

    mlp.fused = Kernel()
    mlp.ParamNerf.infer = infer
    try:
        yield counts
    finally:
        mlp.fused = real_module
        mlp.ParamNerf.infer = real_infer


@contextlib.contextmanager
def selk_inputs():
    """Yields a list of (method, tk0, tk1, kvalid, t_pt) copies, one per
    selk_resolve launch of the render path."""
    import nerftex_torch.instancing.device as device

    real = device.selk_resolve
    calls = []

    def capture(*a, **k):
        tk0, tk1, kvalid, t_pt = a[0], a[1], a[2], a[5]
        calls.append((k.get("method"), tk0.clone(), tk1.clone(), kvalid.clone(), t_pt.clone()))
        return real(*a, **k)

    device.selk_resolve = capture
    try:
        yield calls
    finally:
        device.selk_resolve = real
