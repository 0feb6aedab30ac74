"""Renderer base: the chunked batch loop (counterpart of
nerftex_tpu/render/renderer.py ``Renderer.__call__`` and ``chunked_apply``).
Given a key (utils.jax_rng), the chunk that starts at ray i renders under
fold_in(key, i), as the JAX package's loop does; a call without one draws
utils.rng.stream_key(STREAM_PERTURB, n) for its n-th keyless call, as the
JAX package's Renderer does, so the same seed renders the same frames.

Inference only in this slice: the stratified training renderer, remat and
importance sampling come with the training slice, and so does the plain
renderer's ``blur_idx``; ``InstanceRenderer`` scales its blur slot.
"""

import torch

from nerftex_torch.utils import jax_rng, rng
from nerftex_torch.utils.util import resolve_device


def chunked_apply(fn, inputs, net_chunk: int):
    """fn(*inputs) over the leading axis in pieces of at most net_chunk rows;
    the outputs (a tuple) are concatenated back."""
    n = inputs[0].shape[0]
    if n <= net_chunk:
        return fn(*inputs)
    outs = [fn(*(x[i:i + net_chunk] for x in inputs)) for i in range(0, n, net_chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


class Renderer:
    """Chunked ray-batch loop; subclasses implement ``render_rays``."""

    # Whether the subclass applies blur_idx (the per-sample blur slot).
    supports_blur = False

    def __init__(
        self,
        model=None,
        n_samples: int = 64,
        render_chunk: int = 32768,
        net_chunk: int = 65536,
        raw_noise_std: float = 0,
        blur_idx: int = None,
        map_exr: bool = False,
        device=None,
        **kwargs,
    ) -> None:
        if raw_noise_std:
            raise NotImplementedError("raw_noise_std > 0 comes with the training slice")
        if blur_idx is not None and not self.supports_blur:
            raise NotImplementedError(f"blur_idx on {type(self).__name__} comes with the "
                                      f"training slice")
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device)
        self.n_samples = n_samples
        self.render_chunk = render_chunk
        self.net_chunk = net_chunk
        self.map_exr = map_exr
        self.blur_idx = blur_idx
        self._call_counter = 0

    def render_rays(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd,
                    bkgd_color, key) -> dict:
        raise NotImplementedError

    @torch.inference_mode()
    def __call__(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd: bool = False,
                 bkgd_color=(1, 1, 1.0), training: bool = False, key=None, **kwargs) -> dict:
        """Render a [B, R] ray grid in chunks of render_chunk rays.

        rays_o/rays_d [B,R,3], t [B,R,2] (inf on proxy miss), parameters
        [B,P], cone_scale [B,R,1]; key, a jax_rng key whose draws are the
        JAX package's for the same key (default: this renderer's next
        STREAM_PERTURB key).  Returns
        {"color_pred": [B,R,3], "alpha_pred": [B,R]} as tensors on the
        renderer's device."""
        if training:
            raise NotImplementedError("training renders come with the training slice")
        if key is None:
            key = rng.stream_key(rng.STREAM_PERTURB, self._call_counter)
            self._call_counter += 1

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

        rays_o, rays_d, t, cone_scale = f32(rays_o), f32(rays_d), f32(t), f32(cone_scale)
        b, r = rays_o.shape[0], rays_o.shape[1]
        n = b * r
        parameters = f32(parameters).reshape(b, -1)
        flat = {
            "rays_o": rays_o.reshape(n, 3),
            "rays_d": rays_d.reshape(n, 3),
            "t": t.reshape(n, 2),
            "parameters": parameters.repeat_interleave(r, 0),
            "cone_scale": cone_scale.reshape(n, -1),
        }

        chunk = min(self.render_chunk, n)
        n_pad = -(-n // chunk) * chunk
        if n_pad > n:
            flat = {k: torch.cat([v, v.new_full((n_pad - n,) + v.shape[1:],
                                                float("inf") if k == "t" else 0.0)])
                    for k, v in flat.items()}

        outs = []
        for i in range(0, n_pad, chunk):
            c = {k: v[i:i + chunk] for k, v in flat.items()}
            outs.append(self.render_rays(
                c["rays_o"], c["rays_d"], c["t"], c["parameters"], c["cone_scale"],
                composite_bkgd, bkgd_color, jax_rng.fold_in(key, i),
            ))

        out = {}
        for name in outs[0]:
            if name.startswith("_"):
                out[name] = sum(int(o[name]) for o in outs)
                continue
            v = torch.cat([o[name] for o in outs])[:n]
            out[name] = v.reshape((b, r) + v.shape[1:])
        self._report_diagnostics(out)
        return out

    def _report_diagnostics(self, out: dict) -> None:
        pass
