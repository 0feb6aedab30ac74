"""Conditioned NeRF MLP (counterpart of nerftex_tpu/models/mlp.py ParamNerf).

``ParamNerf.forward`` is the plain path, the one training differentiates:
the JAX ``apply`` written with PyTorch ops, including its compute-dtype
rounding (``_dense``/``_dense_cat``: every partial product and the bias add
round to ``compute_dtype``).  It is ``chain(*encode(...))``, so a
checkpoint can keep the encodings and recompute the dense chain.
``ParamNerf.infer`` is the inference path of the renderers: encodings and
parameter MLPs in float32, then the dense chain through
``kernels.mlp_fused`` (the CUDA kernel on a CUDA tensor, its plain version
on the CPU).

Weights are initialised as the JAX factories initialise them: the n-th
model built in a process draws from ``fold_in(base_key, 1000 + n)`` under
utils.rng's seed, so the same seed and order give the JAX package's
weights (``_INIT_COUNTER`` mirrors the JAX package's counter of that name).
"""

from typing import Union

import torch
from torch import nn

from nerftex_torch.kernels import mlp_fused as fused
from nerftex_torch.utils import jax_rng, rng, trace
from nerftex_torch.utils.util import EasyDict, instantiate, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Models built so far in this process: the next one's init key index.
_INIT_COUNTER = [0]


def _next_init_key():
    key = jax_rng.fold_in(rng.base_key(), 1000 + _INIT_COUNTER[0])
    _INIT_COUNTER[0] += 1
    return key


def model_dict(models) -> dict:
    """{name: model} of a model factory's result (a model, or CoarseFine's dict)."""
    return models if isinstance(models, dict) else {models.name: models}


def _dense(layer: nn.Linear, x: torch.Tensor, dtype, weights=None) -> torch.Tensor:
    return _dense_cat(layer, [x], dtype, weights)


def _dense_cat(layer: nn.Linear, xs, dtype, weights=None) -> torch.Tensor:
    """dense(concat(xs)) as a sum of row-block products in ``dtype``,
    starting from the bias, as the JAX ``_dense_cat`` does.  ``weights``
    ({layer: (weight, bias)} already in ``dtype``, from
    ``ParamNerf.cast_weights``) replaces the cast of the layer's own."""
    if weights is not None:
        w, out = weights[layer]
    else:
        w, out = layer.weight.to(dtype), layer.bias.to(dtype)
    off = 0
    for x in xs:
        d = x.shape[-1]
        out = out + x.to(dtype) @ w[:, off:off + d].T
        off += d
    if off != w.shape[1]:
        raise ValueError(f"inputs cover {off} of {w.shape[1]} weight rows")
    return out


class ParamNerf(nn.Module):
    """NeRF MLP conditioned on geometry/appearance parameters.  Constructor
    arguments follow the JAX factory (``models/mlp.py:201``); weights are
    the JAX factory's glorot-uniform draws (see the module docstring)."""

    def __init__(
        self,
        pos_embedding: dict,
        dir_embedding: dict,
        param_embedding: dict,
        n_parameters: Union[int, list],
        n_pos: int = 3,
        param_depth: int = 0,
        param_width: int = 128,
        depth: int = 8,
        width: int = 256,
        skips: list = (4,),
        color_depth: int = 1,
        embedding_config: dict = None,
        include_param_dims: bool = False,
        name: str = "model",
        compute_dtype: str = "float32",
        device=None,
    ) -> None:
        super().__init__()
        if isinstance(n_parameters, int):
            n_parameters = [n_parameters, 0]
        self.name = name
        self.n_geo, self.n_app = int(n_parameters[0]), int(n_parameters[1])
        self.n_pos = int(n_pos)
        self.include_param_dims = bool(include_param_dims)
        self.depth, self.width = int(depth), int(width)
        self.skips = tuple(skips)
        self.color_depth = int(color_depth)
        self.compute_dtype = _DTYPES[compute_dtype]

        self.pos_fm = instantiate(pos_embedding)
        self.dir_fm = instantiate(dir_embedding)
        self.param_fm = instantiate(param_embedding)
        # Extra features of the position (and, with include_param_dims, the
        # parameters), joined after the position encoding.
        self.extra_fm = instantiate(embedding_config) if embedding_config else None

        device = resolve_device(device)
        # One key per dense layer, drawn in the JAX factory's layer order.
        keys = iter(jax_rng.split(_next_init_key(), depth + 2 * param_depth + color_depth + 8))

        def dense(fan_in, fan_out):
            layer = nn.Linear(fan_in, fan_out, device=device)
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            with torch.no_grad():
                w = jax_rng.uniform_range(next(keys), (fan_in, fan_out), -limit, limit)
                layer.weight.copy_(w.T)
                layer.bias.zero_()
            return layer

        geo_dim = 0
        self.param_geo = nn.ModuleList()
        if self.n_geo > 0:
            geo_dim = self.param_fm.out_dim(self.n_geo)
            for _ in range(param_depth):
                self.param_geo.append(dense(geo_dim, param_width))
                geo_dim = param_width
        app_dim = 0
        self.param_app = nn.ModuleList()
        if self.n_app > 0:
            app_dim = self.param_fm.out_dim(self.n_app)
            for _ in range(param_depth):
                self.param_app.append(dense(app_dim, param_width))
                app_dim = param_width

        self.pos_dim = self.pos_fm.out_dim(self.n_pos) + geo_dim
        if self.extra_fm is not None:
            extra_in = self.n_pos + (self.n_geo + self.n_app if self.include_param_dims else 0)
            self.pos_dim += self.extra_fm.out_dim(extra_in)
        self.dir_dim = self.dir_fm.out_dim(3) + app_dim
        self.trunk = nn.ModuleList()
        in_dim = self.pos_dim
        for i in range(self.depth):
            self.trunk.append(dense(in_dim, width))
            in_dim = width + (self.pos_dim if i in self.skips else 0)
        self.alpha = dense(in_dim, 1)
        self.bottleneck = dense(in_dim, width)
        in_dim = width + self.dir_dim
        self.color_layers = nn.ModuleList()
        for _ in range(self.color_depth):
            self.color_layers.append(dense(in_dim, width))
            in_dim = width
        self.pre_color = dense(in_dim, width // 2)
        self.color = dense(width // 2, 3)
        self._packed = {}
        # Set by parallel.mesh while the trunk's layers hold only this
        # process's blocks of a tensor-parallel job: the trunk's forward.
        self.sharded_trunk = None

    def summary(self) -> None:
        print(f"Model '{self.name}': {sum(p.numel() for p in self.parameters()):,} parameters")

    # -- plain path -------------------------------------------------------

    @staticmethod
    def _param_part(layers, g, dtype, weights=None):
        """The parameter MLP on a parameter encoding ``g``."""
        g = g.to(dtype)
        for layer in layers:
            g = torch.relu(_dense(layer, g, dtype, weights))
        return g

    def cast_weights(self) -> dict:
        """{layer: (weight, bias)} cast to ``compute_dtype`` (a
        differentiable cast; the tensors themselves when that is float32),
        for ``forward(..., weights=)``: a caller that casts once and runs
        many chunks through them has autograd sum each weight's chunk
        gradients in ``compute_dtype`` and convert them to float32 once."""
        cdt = self.compute_dtype
        return {layer: (layer.weight.to(cdt), layer.bias.to(cdt))
                for layer in self.modules() if isinstance(layer, nn.Linear)}

    def _extra(self, pos, prms):
        """The extra features (embedding_config) in float32, or None."""
        if self.extra_fm is None:
            return None
        return self.extra_fm(torch.cat([pos, prms], -1) if self.include_param_dims else pos)

    def encode(self, pos, dirs, prms):
        """The encodings in ``compute_dtype``: (pos, dirs, geometry
        parameters, appearance parameters, extra features), each of the last
        three None when the model has no such input."""
        cdt = self.compute_dtype
        geo = self.param_fm(prms[:, : self.n_geo]).to(cdt) if self.n_geo > 0 else None
        app = self.param_fm(prms[:, self.n_geo:]).to(cdt) if self.n_app > 0 else None
        extra = self._extra(pos, prms)
        return (self.pos_fm(pos).to(cdt), self.dir_fm(dirs).to(cdt), geo, app,
                None if extra is None else extra.to(cdt))

    def forward(self, pos, dirs, prms, weights=None):
        """(color logits [N, 3], density [N, 1]), float32, computed in
        ``compute_dtype`` as the JAX ``apply``; ``weights`` as
        ``cast_weights`` gives them, else each layer casts its own."""
        return self.chain(*self.encode(pos, dirs, prms), weights=weights)

    def chain(self, pos_enc, dir_enc, geo_enc, app_enc, extra_enc=None, weights=None):
        """``forward`` from the encodings on: the parameter MLPs and the
        dense chain.  The trunk's input rows are the position encoding's,
        then the extra features', then the geometry features'.  A model
        placed by a tensor-parallel step holds its blocks of the trunk and
        runs it through ``sharded_trunk`` (parallel/mesh.py ShardedTrunk)."""
        cdt = self.compute_dtype
        pos_parts = [pos_enc] if extra_enc is None else [pos_enc, extra_enc]
        dir_parts = [dir_enc]
        if geo_enc is not None:
            pos_parts.append(self._param_part(self.param_geo, geo_enc, cdt, weights))
        if app_enc is not None:
            dir_parts.append(self._param_part(self.param_app, app_enc, cdt, weights))
        if self.sharded_trunk is not None:
            parts = self.sharded_trunk(self, pos_parts, cdt, weights)
        else:
            parts = list(pos_parts)
            for i, layer in enumerate(self.trunk):
                h = torch.relu(_dense_cat(layer, parts, cdt, weights))
                parts = pos_parts + [h] if i in self.skips else [h]
        density = _dense_cat(self.alpha, parts, cdt, weights)
        h = _dense_cat(self.bottleneck, parts, cdt, weights)
        parts = dir_parts + [h]
        for layer in self.color_layers:
            h = torch.relu(_dense_cat(layer, parts, cdt, weights))
            parts = [h]
        h = torch.relu(_dense_cat(self.pre_color, parts, cdt, weights))
        color = _dense(self.color, h, cdt, weights)
        return color.float(), density.float()

    # -- fused inference path ---------------------------------------------

    def feature_maps(self, pos, dirs, prms):
        """pos_map [N, pos_dim] and dir_map [N, dir_dim] in float32: the
        encodings with the extra and parameter features joined in the
        trunk's row order, built outside the kernel."""
        pos_map = [self.pos_fm(pos)]
        dir_map = [self.dir_fm(dirs)]
        extra = self._extra(pos, prms)
        if extra is not None:
            # The JAX Pallas wrapper leaves these out (its pos_map is the
            # position and geometry features only); the JAX model's apply,
            # which this follows, has them.
            pos_map.append(extra)
        if self.n_geo > 0:
            pos_map.append(self._param_part(self.param_geo, self.param_fm(prms[:, : self.n_geo]),
                                            torch.float32))
        if self.n_app > 0:
            dir_map.append(self._param_part(self.param_app, self.param_fm(prms[:, self.n_geo:]),
                                            torch.float32))
        return torch.cat(pos_map, -1), torch.cat(dir_map, -1)

    def fused_layers(self):
        """The dense chain as kernels.mlp_fused.pack's layer list."""
        P, D, HA, HB, OUT = fused.BUF_POS, fused.BUF_DIR, fused.BUF_HA, fused.BUF_HB, fused.OUT
        layers = []
        cur = None
        for i, layer in enumerate(self.trunk):
            segs = [P] if i == 0 else ([P, cur] if (i - 1) in self.skips else [cur])
            nxt = HA if cur != HA else HB
            layers.append((layer.weight, layer.bias, segs, nxt, True, 0))
            cur = nxt
        segs = [P, cur] if (self.depth - 1) in self.skips else [cur]
        nxt = HA if cur != HA else HB
        layers.append((self.alpha.weight, self.alpha.bias, segs, OUT, False, 3))
        layers.append((self.bottleneck.weight, self.bottleneck.bias, segs, nxt, False, 0))
        cur, segs = nxt, [D, nxt]
        for layer in list(self.color_layers) + [self.pre_color]:
            nxt = HA if cur != HA else HB
            layers.append((layer.weight, layer.bias, segs, nxt, True, 0))
            cur, segs = nxt, [nxt]
        layers.append((self.color.weight, self.color.bias, segs, OUT, False, 0))
        return layers

    def drop_packed(self) -> None:
        """Forget the packed weights: a caller that changed them where the
        parameter versions do not see it (a CUDA graph's replay) calls this."""
        self._packed = {}

    def packed(self) -> fused.PackedMLP:
        """The fused kernel's weight layout, rebuilt whenever the compute
        dtype or a parameter changes (keyed by storage and in-place version:
        an optimizer step bumps every parameter's version)."""
        if self.sharded_trunk is not None:
            raise RuntimeError("this model holds only its blocks of a tensor-parallel trunk: "
                               "render inside nerftex_torch.parallel.gathered(...)")
        key = (self.compute_dtype,) + tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed.get("key") != key:
            with torch.no_grad():
                self._packed = {"key": key, "value": fused.pack(
                    self.fused_layers(), self.pos_dim, self.dir_dim, self.compute_dtype)}
        return self._packed["value"]

    @trace.span("mlp.infer")
    @torch.no_grad()
    def infer(self, pos, dirs, prms):
        """Inference forward through the fused MLP: (color [N, 3], density [N, 1])."""
        trace.count("mlp.rows", pos.shape[0])
        pos_map, dir_map = self.feature_maps(pos, dirs, prms)
        out = fused.mlp_fused(pos_map, dir_map, self.packed())
        return out[:, :3], out[:, 3:4]


class Nerf(ParamNerf):
    """Classic NeRF MLP (counterpart of the JAX ``Nerf`` factory,
    ``models/mlp.py:131``): a ParamNerf without parameter inputs or color
    layers.  Accepts and ignores a parameter input, as the reference does."""

    def __init__(self, pos_embedding: dict, dir_embedding: dict, depth: int = 8,
                 width: int = 256, skips: list = (4,), name: str = "model",
                 compute_dtype: str = "float32", device=None, **kwargs) -> None:
        super().__init__(pos_embedding, dir_embedding, None, [0, 0], depth=depth, width=width,
                         skips=skips, color_depth=0, name=name, compute_dtype=compute_dtype,
                         device=device)


def CoarseFine(model_config: dict, device=None, **kwargs) -> dict:
    """Two models from one config (counterpart of the JAX ``CoarseFine``):
    {name: coarse, name + "_fine": fine}.  ``kwargs`` fill keys the config
    lacks (n_parameters, as ``Train`` sets it)."""
    model_config = EasyDict(model_config)
    for key, value in kwargs.items():
        model_config.setdefault(key, value)
    coarse = model_dict(instantiate(model_config, device=device))
    model_config["name"] = next(iter(coarse)) + "_fine"
    fine = model_dict(instantiate(model_config, device=device))
    return dict(coarse, **fine)
