"""Stratified-sampling volume renderer and the chunked batch loop
(counterpart of nerftex_tpu/render/renderer.py ``Renderer`` and
``chunked_apply``).

``Renderer.apply`` is the differentiable whole-batch render the training
step runs: the models' plain ``forward`` on autograd, as the JAX step
differentiates ``ParamNerf.apply``.  ``Renderer.__call__`` is the eval loop
under ``torch.inference_mode``: the chunk that starts at ray i renders
under fold_in(key, i), as the JAX package's loop does, and the models run
``infer`` (the fused MLP kernel on a CUDA tensor).  A call without a key
draws utils.rng.stream_key(STREAM_PERTURB, n) for its n-th keyless call,
as the JAX package's Renderer does, so the same seed renders the same
frames.  Each ray splits its key into the jitter, coarse noise, fine noise
and importance keys in JAX's order; every draw is the JAX package's
(utils.jax_rng).  ``InstanceRenderer`` overrides ``render_rays``.
"""

import torch
from torch.utils.checkpoint import checkpoint

from nerftex_torch.ops import volume
from nerftex_torch.utils import jax_rng, rng, trace
from nerftex_torch.utils.util import as_f32, resolve_device


def chunked_apply(fn, inputs, net_chunk: int, remat: "bool | str" = False,
                  cast_params: bool = False):
    """fn(*inputs) over the leading axis in pieces of at most net_chunk rows;
    the outputs (a tuple) are concatenated back.

    remat (training): True runs each piece under torch.utils.checkpoint,
    so the backward recomputes its activations instead of keeping them;
    "save_encodings" keeps ``fn.encode``'s output of each piece and
    recomputes only ``fn.chain`` (``fn`` is then the model).  Both give the
    gradients of remat=False.  The pieces draw nothing from torch's
    generators, so the recompute keeps no generator state (restoring one is
    refused under CUDA graph capture).

    cast_params (training; ``fn`` is then the model) casts the model's
    float32 weights to its compute dtype once, before the pieces
    (``ParamNerf.cast_weights``), instead of in every piece: autograd then
    sums each weight's gradients over the pieces in the compute dtype and
    converts the sum to float32 once, as the JAX package's
    ``cast_params`` does.  With a float32 compute dtype the cast is the
    weights themselves and nothing changes, bit for bit."""
    if isinstance(remat, str) and remat != "save_encodings":
        raise ValueError(f"remat={remat!r}: the only string policy is 'save_encodings' "
                         f"(bool for plain on/off)")
    kw = {"weights": fn.cast_weights()} if cast_params else {}
    if remat == "save_encodings":
        def body(*xs):
            return checkpoint(fn.chain, *fn.encode(*xs), use_reentrant=False,
                              preserve_rng_state=False, **kw)
    elif remat:
        def body(*xs):
            return checkpoint(fn, *xs, use_reentrant=False, preserve_rng_state=False, **kw)
    else:
        def body(*xs):
            return fn(*xs, **kw)
    n = inputs[0].shape[0]
    if n <= net_chunk:
        return body(*inputs)
    outs = [body(*(x[i:i + net_chunk] for x in inputs)) for i in range(0, n, net_chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _read_count(n) -> int:
    """A drop count as a host int: a tensor is read from its device (a host
    read wherever it lies, as a card would wait for it)."""
    if not isinstance(n, torch.Tensor):
        return int(n)
    with trace.host_read("overflow"):
        return int(n)


class Renderer:
    """Stratified-sampling volume renderer; defaults are the reference's."""

    def __init__(
        self,
        model=None,
        model_fine=None,
        n_samples: int = 64,
        n_importance: int = 0,
        perturb: bool = True,
        raw_noise_std: float = 0,
        render_chunk: int = 32768,
        net_chunk: int = 65536,
        downsampling_factor: int = 1,
        blur_idx: int = None,
        map_exr: bool = False,
        remat_net_chunks=False,
        net_chunk_unroll: int = 1,
        cast_params_once: bool = False,
        device=None,
        **kwargs,
    ) -> None:
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device)
        self.model_fine = None if model_fine is None else model_fine.to(self.device)
        self.n_samples = n_samples
        self.n_importance = n_importance
        self.perturb = perturb
        self.raw_noise_std = raw_noise_std
        self.render_chunk = render_chunk
        self.net_chunk = net_chunk
        self.downsampling_factor = downsampling_factor
        self.blur_idx = blur_idx
        self.map_exr = map_exr
        self.remat_net_chunks = remat_net_chunks
        # cast_params_once: chunked_apply's cast_params in the training
        # render.  net_chunk_unroll is the JAX package's chunk-scan unroll
        # factor: an eager loop over the chunks, and a CUDA graph's replay
        # of it, has no scan to unroll, so it is accepted and changes
        # nothing.
        self.cast_params_once = bool(cast_params_once)
        self._call_counter = 0

    # -- the per-ray render ----------------------------------------------------

    def render_rays(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd,
                    bkgd_color, key, training: bool = False, differentiable: bool = False,
                    rows=None) -> dict:
        """March a flat chunk of rays [R, ...] under ``key``.  The models run
        ``forward`` (autograd) when ``differentiable``, else ``infer``;
        ``training`` turns on the stratified jitter (with ``perturb``).
        ``rows`` [R] (int64): the rays' rows in a larger batch, whose draws
        they take (ops/volume.py); None is rows 0 .. R - 1."""
        k_perturb, k_noise, k_noise2, k_imp = jax_rng.split(key, 4)
        miss = torch.isinf(t[:, 0])
        t_safe = torch.where(miss[:, None], torch.zeros_like(t), t)
        rays_d_n = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

        z_vals = volume.stratified_z_vals(t_safe, self.n_samples, self.perturb and training,
                                          k_perturb, rows=rows)
        pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        color, density = self._evaluate_model(self.model, pts, rays_d_n, parameters, cone_scale,
                                              z_vals, differentiable)
        color_map, alpha_map, weights, _ = volume.composite(
            color, density, z_vals, rays_d, raw_noise_std=self.raw_noise_std, noise_key=k_noise,
            map_exr=self.map_exr, rows=rows)
        out = {"color_pred": color_map, "alpha_pred": alpha_map}

        if self.n_importance > 0:
            z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            # det=self.perturb is the reference's own (inverted) sense.
            z_samples = volume.sample_pdf(z_vals_mid, weights[..., 1:-1], self.n_importance,
                                          det=self.perturb, key=k_imp, rows=rows).detach()
            z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
            pts = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
            fine = self.model if self.model_fine is None else self.model_fine
            color_i, density_i = self._evaluate_model(fine, pts, rays_d_n, parameters, cone_scale,
                                                      z_all, differentiable)
            color_map_i, alpha_map_i, _, _ = volume.composite(
                color_i, density_i, z_all, rays_d, raw_noise_std=self.raw_noise_std,
                noise_key=k_noise2, map_exr=self.map_exr, rows=rows)
            out = {"color_pred": color_map_i, "alpha_pred": alpha_map_i,
                   "color_pred_coarse": color_map, "alpha_pred_coarse": alpha_map}

        # Missed rays contribute nothing; with composite_bkgd they show the
        # background color.
        valid = (~miss).float()
        for name in list(out):
            v = out[name]
            v = v * (valid[:, None] if v.ndim == 2 else valid)
            if composite_bkgd and "color" in name:
                alpha = torch.where(miss, torch.zeros_like(valid), out[name.replace("color",
                                                                                    "alpha")])
                bkgd = as_f32(bkgd_color, v.device)
                v = v + (1.0 - alpha)[:, None] * bkgd
            out[name] = v
        return out

    def _evaluate_model(self, model, pos, dirs, parameters, cone_scale, z_vals, differentiable):
        """The MLP on the flattened [R*S] samples in net_chunk pieces.  With
        blur_idx, that parameter is scaled by the cone footprint
        cone_scale * z of each sample."""
        r, s = pos.shape[0], pos.shape[1]
        pos_flat = pos.reshape(r * s, pos.shape[-1])
        dirs_flat = dirs.repeat_interleave(s, 0)
        params_flat = parameters.repeat_interleave(s, 0)
        if self.blur_idx is not None:
            blur_scale = (cone_scale[..., None, :] * z_vals[..., :, None]).reshape(r * s, 1)
            b = self.blur_idx
            params_flat = torch.cat([params_flat[:, :b], params_flat[:, b, None] * blur_scale,
                                     params_flat[:, b + 1:]], -1)
        if differentiable:
            color, density = chunked_apply(model, (pos_flat, dirs_flat, params_flat),
                                           self.net_chunk, remat=self.remat_net_chunks,
                                           cast_params=self.cast_params_once)
        else:
            color, density = chunked_apply(model.infer, (pos_flat, dirs_flat, params_flat),
                                           self.net_chunk)
        return color.reshape(r, s, 3), density.reshape(r, s)

    # -- whole-batch entry points ----------------------------------------------

    def _flatten_batch(self, data: dict) -> dict:
        """[B, R, ...] ray data (numpy or tensors) as flat float32 [B*R, ...]
        tensors on the renderer's device; parameters [B, P] repeat per ray."""
        def f32(x):
            return as_f32(x, self.device)

        rays_o = f32(data["rays_o"])
        b, r = rays_o.shape[0], rays_o.shape[1]
        n = b * r
        parameters = f32(data["parameters"])
        return {
            "rays_o": rays_o.reshape(n, -1),
            "rays_d": f32(data["rays_d"]).reshape(n, -1),
            "t": f32(data["t"]).reshape(n, -1),
            "parameters": parameters.reshape(b, parameters.shape[-1]).repeat_interleave(r, 0),
            "cone_scale": f32(data["cone_scale"]).reshape(n, -1),
        }

    def apply(self, data: dict, key, composite_bkgd: bool = False, bkgd_color=(1, 1, 1.0),
              training: bool = True, rows=None) -> dict:
        """Differentiable render of a whole batch (the training step's):
        data {rays_o [B,R,3], rays_d, t [B,R,2], parameters [B,P],
        cone_scale [B,R,1]} -> {name: [B,R,...]}, through the models'
        ``forward``.  ``rows`` [B*R] (int64): each ray's flat row b * R' + r'
        in the whole batch [B, R'] that this one is a shard of (a
        data-parallel step's, parallel/mesh.py), so that every draw is that
        row's of the whole batch's draw; None: this batch is the whole.
        The draws need no row count: row i of a draw of width W takes the
        positions i * W .. i * W + W - 1 however many rows it has."""
        b, r = data["rays_o"].shape[0], data["rays_o"].shape[1]
        flat = self._flatten_batch(data)
        out = self.render_rays(flat["rays_o"], flat["rays_d"], flat["t"], flat["parameters"],
                               flat["cone_scale"], composite_bkgd, bkgd_color, key,
                               training=training, differentiable=True, rows=rows)
        return {k: v.reshape((b, r) + v.shape[1:]) for k, v in out.items()}

    @torch.inference_mode()
    def __call__(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd: bool = False,
                 bkgd_color=(1, 1, 1.0), training: bool = False, key=None, **kwargs) -> dict:
        """Render a [B, R] ray grid in chunks of render_chunk rays.

        rays_o/rays_d [B,R,3], t [B,R,2] (inf on proxy miss), parameters
        [B,P], cone_scale [B,R,1]; key, a jax_rng key whose draws are the
        JAX package's for the same key (default: this renderer's next
        STREAM_PERTURB key).  Returns
        {"color_pred": [B,R,3], "alpha_pred": [B,R], ...} as tensors on the
        renderer's device."""
        key = self.frame_key(key)
        b, r = rays_o.shape[0], rays_o.shape[1]
        flat, chunk = self.chunk_rays({"rays_o": rays_o, "rays_d": rays_d, "t": t,
                                       "parameters": parameters, "cone_scale": cone_scale})
        out = self.render_chunks(flat, range(0, flat["t"].shape[0], chunk), chunk, key,
                                 composite_bkgd, bkgd_color, training)
        out = self.frame_of(out, b, r)
        with trace.span("renderer.diagnostics"):
            self._report_diagnostics(out)
        return out

    def frame_key(self, key=None):
        """``key``, or for a call without one this renderer's next key,
        rng.stream_key(STREAM_PERTURB, n) for its n-th keyless call."""
        if key is None:
            key = rng.stream_key(rng.STREAM_PERTURB, self._call_counter)
            self._call_counter += 1
        return key

    def chunk_rays(self, data: dict):
        """(flat, chunk): the [B, R] ray grid ``data`` as flat tensors
        (_flatten_batch) padded with missing rays (t = inf) to whole render
        chunks of ``chunk`` rays."""
        flat = self._flatten_batch(data)
        n = flat["t"].shape[0]
        chunk = min(self.render_chunk, n)
        n_pad = -(-n // chunk) * chunk
        if n_pad > n:
            flat = {k: torch.cat([v, v.new_full((n_pad - n,) + v.shape[1:],
                                                float("inf") if k == "t" else 0.0)])
                    for k, v in flat.items()}
        return flat, chunk

    def render_chunks(self, flat: dict, starts, chunk: int, key, composite_bkgd, bkgd_color,
                      training: bool) -> dict:
        """The chunks of ``flat`` that start at the ray indices ``starts``,
        each rendered under fold_in(key, start), their outputs concatenated
        in order; drop counts (names that start with "_") summed as ints."""
        outs = []
        for i in starts:
            c = {k: v[i:i + chunk] for k, v in flat.items()}
            with trace.span("renderer.chunk"):
                outs.append(self.render_rays(
                    c["rays_o"], c["rays_d"], c["t"], c["parameters"], c["cone_scale"],
                    composite_bkgd, bkgd_color, jax_rng.fold_in(key, i), training=training,
                ))
        return {name: sum(_read_count(o[name]) for o in outs) if name.startswith("_")
                else torch.cat([o[name] for o in outs]) for name in outs[0]}

    @staticmethod
    def frame_of(out: dict, b: int, r: int) -> dict:
        """Flat chunk outputs as the [B, R] grid's: padding cut, each output
        [B, R, ...]; drop counts as they are."""
        return {name: v if name.startswith("_") else v[:b * r].reshape((b, r) + v.shape[1:])
                for name, v in out.items()}

    def _report_diagnostics(self, out: dict) -> None:
        pass


class MipRenderer(Renderer):
    """Cone-marching renderer with integrated positional encodings, for
    training prefiltered models (counterpart of the JAX ``MipRenderer``).

    Each ray marches n_samples segments between n_samples + 1 stratified
    fence posts; the blur parameter (``blur_idx``) is spliced out of the
    parameters as the cone radius blur * cone_scale, and the model takes
    each segment's Gaussian [mean, diagonal covariance] as its [.., 6]
    position.  ``blur_idx`` is kept from the base class (as
    ``blur_idx_mip``), which therefore scales no parameter per sample.

    ``mip_importance`` (the JAX package's extension; without it
    n_importance > 0 raises, as the reference does) draws n_importance new
    posts from the coarse segment weights, by sample_pdf with stratified
    draws while training with perturb and evenly spaced ones otherwise,
    and re-marches the sorted union of posts with ``model_fine`` (else
    ``model``)."""

    def __init__(self, blur_idx: int = None, mip_importance: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.blur_idx_mip = blur_idx
        self.mip_importance = mip_importance

    def _march(self, model, rays_o, rays_d, rays_d_n, z_vals, blur, parameters, noise_key,
               differentiable, rows):
        """Shade and composite the segments between the posts z_vals:
        (color [R, 3], alpha [R], weights [R, S])."""
        mean, cov_diag = volume.cone_segment_gaussians(rays_o, rays_d, z_vals, blur)
        color, density = self._evaluate_model(model, torch.cat([mean, cov_diag], -1), rays_d_n,
                                              parameters, None, None, differentiable)
        color_map, alpha_map, weights, _ = volume.composite(
            color, density, z_vals, rays_d, raw_noise_std=self.raw_noise_std,
            noise_key=noise_key, map_exr=self.map_exr, repeat_last_dist=False, rows=rows)
        return color_map, alpha_map, weights

    def render_rays(self, rays_o, rays_d, t, parameters, cone_scale, composite_bkgd,
                    bkgd_color, key, training: bool = False, differentiable: bool = False,
                    rows=None) -> dict:
        if self.n_importance > 0 and not self.mip_importance:
            raise NotImplementedError(
                "Importance sampling for mip-NeRF style rendering is not implemented "
                "(opt in with mip_importance: true).")
        k_perturb, k_noise, k_noise2, k_imp = jax_rng.split(key, 4)
        miss = torch.isinf(t[:, 0])
        t_safe = torch.where(miss[:, None], torch.zeros_like(t), t)
        rays_d_n = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        z_vals = volume.stratified_z_vals(t_safe, self.n_samples + 1, self.perturb and training,
                                          k_perturb, rows=rows)
        b = self.blur_idx_mip
        blur = parameters[..., b, None] * cone_scale
        parameters = torch.cat([parameters[..., :b], parameters[..., b + 1:]], -1)

        color_map, alpha_map, weights = self._march(self.model, rays_o, rays_d, rays_d_n, z_vals,
                                                    blur, parameters, k_noise, differentiable,
                                                    rows)
        out = {"color_pred": color_map, "alpha_pred": alpha_map}
        if self.n_importance > 0:
            z_samples = volume.sample_pdf(z_vals, weights, self.n_importance,
                                          det=not (self.perturb and training),
                                          key=k_imp, rows=rows).detach()
            z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
            fine = self.model if self.model_fine is None else self.model_fine
            color_i, alpha_i, _ = self._march(fine, rays_o, rays_d, rays_d_n, z_all, blur,
                                              parameters, k_noise2, differentiable, rows)
            out = {"color_pred": color_i, "alpha_pred": alpha_i,
                   "color_pred_coarse": color_map, "alpha_pred_coarse": alpha_map}

        # As the JAX MipRenderer: every color, the coarse one included,
        # takes the background behind the final alpha.
        valid = (~miss).float()
        for name in list(out):
            v = out[name]
            v = v * (valid[:, None] if v.ndim == 2 else valid)
            if composite_bkgd and "color" in name:
                alpha = torch.where(miss, torch.zeros_like(valid), out["alpha_pred"])
                bkgd = as_f32(bkgd_color, v.device)
                v = v + (1.0 - alpha)[:, None] * bkgd
            out[name] = v
        return out
