"""Checkpoints in the JAX package's format, and the weight transplant.

``CheckpointManager`` is the counterpart of
nerftex_tpu/render/checkpoint.py: one pickle of a numpy pytree per step
under ``<dir>/ckpt-<step>.pkl``, the newest ``max_to_keep`` kept plus one
every ``keep_every_n_hours`` (tf.train.CheckpointManager's retention), and
restore-latest.  It reads the JAX package's files, whose ``extra`` may hold
optax state: the restore imports only the globals that numpy arrays and
builtin containers pickle to and stands a plain tuple in for any other, so
it needs neither jax nor optax.

A JAX ParamNerf keeps its parameters as a pytree of numpy arrays: dense
layers are ``{"w": [in, out], "b": [out]}`` under the keys ``trunk``,
``param_geo``, ``param_app`` and ``color_layers`` (lists) and ``alpha``,
``bottleneck``, ``pre_color`` and ``color``; ``load_jax_params`` copies
one into the port's module, and ``export_jax_params`` writes one, so a
port-trained model restores in either package.  A flat mapping with
``/``-joined keys (``"trunk/0/w"``, as ``flatten_params`` writes) is
accepted too.

A JAX model trained with ``flat_params`` keeps one vector instead, its
leaves in ``ravel_pytree``'s order (``jax_flat_layout``); the loaders take
it too, and a port model with its own flat parameter
(render/train.py ``apply_flat_param_space``) loads either layout.  The
port always writes the tree, so a checkpoint restores whichever layout
the restoring run uses.

Adam's state travels in the same layout.  ``load_jax_opt_state`` reads a
JAX train checkpoint's optax state (``extra["opt_state"]``, restored as
Opaque tuples holding ``ScaleByAdamState(count, mu, nu)``) into a torch
Adam.  The port saves its own Adam state as ``adam_state_tree`` gives it,
under ``extra["torch_adam"]`` and never under ``extra["opt_state"]``, so
the JAX package never reads it as optax state; ``load_adam_state`` reads
either back.
"""

import os
import pickle
import re
import time

import numpy as np
import torch
import torch.distributed as dist

# Builtins a checkpoint may name: containers and scalars, nothing callable
# beyond their constructors.
_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "complex", "bool",
                  "str", "bytes", "bytearray", "slice", "range", "object"}
# The other globals that pickles of numpy arrays, dtypes and scalars name
# (numpy 1.x spells the private modules numpy.core, numpy 2 numpy._core),
# and those of the protocols' own containers and byte strings.
_SAFE_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("collections", "OrderedDict"), ("copyreg", "_reconstructor"),
                 ("_codecs", "encode")} | {
    (f"numpy.{core}.{mod}", name) for core in ("core", "_core")
    for mod, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                      ("numeric", "_frombuffer"))}


class Opaque(tuple):
    """Stands in for a class the restore does not import (an optax state
    namedtuple, say): a tuple of its constructor arguments, with any
    pickled attributes in ``__dict__``."""

    module = name = ""

    def __new__(cls, *args, **kwargs):
        return tuple.__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    """Imports only the globals above.  Any other global, class or function,
    becomes an Opaque stand-in whose call only records its arguments, so
    loading a file runs no code that the file names."""

    def find_class(self, module, name):
        if (module == "builtins" and name in _SAFE_BUILTINS) or (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        return type(name, (Opaque,), {"module": module, "name": name})


def _to_numpy(tree):
    """Every leaf of a pytree (dicts, lists, tuples) as a numpy array;
    None stays None."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, keep_every_n_hours: float = 12):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_every_n_seconds = keep_every_n_hours * 3600
        os.makedirs(directory, exist_ok=True)
        self._save_times = {}
        self._preserved = set()  # steps kept permanently (hourly policy)
        self._last_preserved = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pkl")

    def checkpoints(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt-(\d+)\.pkl", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    @property
    def latest_checkpoint(self):
        steps = self.checkpoints()
        return self._path(steps[-1]) if steps else None

    def save(self, state: dict, step: int) -> str:
        """Write ``state`` as step ``step``'s checkpoint; returns its path.
        In a torch.distributed job every process materialises the state
        (a device-to-host copy) but only rank 0 writes and sweeps: a single
        writer, as the JAX package's process 0."""
        path = self._path(step)
        state_np = _to_numpy(state)
        if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
            return path
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state_np, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        self._save_times[step] = time.time()
        self._sweep(step)
        return path

    def _sweep(self, new_step: int) -> None:
        """The newest max_to_keep stay; an older checkpoint about to be
        deleted is instead kept for good if keep_every_n_hours have passed
        since the last one kept (the clock starts at the first save)."""
        now = time.time()
        if self._last_preserved is None:
            self._last_preserved = self._save_times.get(new_step, now)
        active = [s for s in self.checkpoints() if s not in self._preserved]
        while len(active) > self.max_to_keep:
            victim = active.pop(0)
            t = self._save_times.get(victim, now)
            if t - self._last_preserved >= self.keep_every_n_seconds:
                self._preserved.add(victim)
                self._last_preserved = t
                continue
            try:
                os.remove(self._path(victim))
            except OSError:
                pass

    def restore_latest(self):
        path = self.latest_checkpoint
        if path is None:
            return None
        with open(path, "rb") as f:
            return _Unpickler(f).load()


_LISTS = ("trunk", "param_geo", "param_app", "color_layers")
_SINGLE = ("alpha", "bottleneck", "pre_color", "color")


def flatten_params(tree: dict) -> dict:
    """{"trunk/0/w": array, ...} from a nested parameter pytree."""
    flat = {}
    for key in _LISTS:
        for i, layer in enumerate(tree.get(key, [])):
            for name in ("w", "b"):
                flat[f"{key}/{i}/{name}"] = np.asarray(layer[name])
    for key in _SINGLE:
        for name in ("w", "b"):
            flat[f"{key}/{name}"] = np.asarray(tree[key][name])
    return flat


def unflatten_params(flat: dict) -> dict:
    """The nested parameter pytree (the JAX package's checkpoint layout) of
    a flat ``"trunk/0/w"`` mapping; the inverse of flatten_params."""
    tree = {}
    for name, value in flat.items():
        parts = name.split("/")
        if parts[0] in _LISTS:
            layers = tree.setdefault(parts[0], [])
            i = int(parts[1])
            layers.extend({} for _ in range(i + 1 - len(layers)))
            layers[i][parts[2]] = np.asarray(value)
        else:
            tree.setdefault(parts[0], {})[parts[1]] = np.asarray(value)
    return tree


def _layers(model) -> dict:
    """{"trunk/0": nn.Linear, ..., "alpha": nn.Linear, ...} of a ParamNerf."""
    layers = {}
    for key in _LISTS:
        for i, layer in enumerate(getattr(model, key)):
            layers[f"{key}/{i}"] = layer
    for key in _SINGLE:
        layers[key] = getattr(model, key)
    return layers


def as_jax_tree(model, arrays) -> dict:
    """The JAX parameter tree of ``model`` holding ``arrays(tensor)`` for
    each weight (transposed to [in, out]) and bias; every list key is
    present, empty or not, as the JAX factory's tree has it."""
    tree = {key: [] for key in _LISTS}
    for key, layer in _layers(model).items():
        leaf = {"w": arrays(layer.weight).T.copy(), "b": arrays(layer.bias).copy()}
        if "/" in key:
            tree[key.split("/")[0]].append(leaf)
        else:
            tree[key] = leaf
    return tree


def export_jax_params(model) -> dict:
    """``model``'s parameters as the JAX ParamNerf tree (numpy float32)."""
    return as_jax_tree(model, lambda p: p.detach().cpu().numpy())


def jax_flat_layout(model) -> list:
    """[(key, leaf, layer, offset, shape)] of a ParamNerf's weights and
    biases in the order JAX's ``ravel_pytree`` flattens its parameter tree:
    keys sorted, list items in order, each layer's "b" [out] before its
    "w" [in, out] (row major); ``offset`` is where the leaf starts in the
    flat vector."""
    def order(key):
        top, _, index = key.partition("/")
        return top, int(index) if index else -1

    layers = _layers(model)
    layout, offset = [], 0
    for key in sorted(layers, key=order):
        layer = layers[key]
        for leaf, shape in (("b", (layer.out_features,)),
                            ("w", (layer.in_features, layer.out_features))):
            layout.append((key, leaf, layer, offset, shape))
            offset += int(np.prod(shape))
    return layout


def _moment_tree(model, vector) -> dict:
    """The JAX parameter tree of a flat vector laid out by jax_flat_layout,
    every list key present as as_jax_tree has them."""
    tree = {key: [] for key in _LISTS}
    tree.update(unflatten_params(_flat(vector, model)))
    return tree


def adam_state_tree(optimizer, models: dict) -> dict:
    """A torch Adam's state over ``models``' parameters as {"count",
    "mu": {name: tree}, "nu": {name: tree}}, optax's names and layout;
    zero moments before the first step."""
    def moment(name, model):
        def arrays(p):
            st = optimizer.state.get(p, {})
            return (st[name] if name in st else torch.zeros_like(p)).detach().cpu().numpy()
        if getattr(model, "flat", None) is not None:
            return _moment_tree(model, arrays(model.flat))
        return as_jax_tree(model, arrays)

    first = next(iter(next(iter(models.values())).parameters()))
    count = int(optimizer.state.get(first, {}).get("step", 0))
    return {"count": np.int32(count),
            "mu": {k: moment("exp_avg", m) for k, m in models.items()},
            "nu": {k: moment("exp_avg_sq", m) for k, m in models.items()}}


@torch.no_grad()
def load_adam_state(optimizer, models: dict, count, mu: dict, nu: dict) -> None:
    """Set a torch Adam's state over ``models``' parameters: ``count``
    updates done, first and second moments from ``mu[name]`` and
    ``nu[name]`` (parameter trees in the JAX layout, or flat vectors in
    jax_flat_layout's order), for per-layer parameters or a flat one.  A
    capturable Adam keeps its count on the parameters' device."""
    capturable = optimizer.defaults.get("capturable", False)
    for name, model in models.items():
        mu_flat, nu_flat = _flat(mu[name], model), _flat(nu[name], model)
        if getattr(model, "flat", None) is not None:
            layout = jax_flat_layout(model)
            targets = [(model.flat, *(torch.tensor(np.concatenate(
                [np.asarray(flat[f"{key}/{leaf}"], np.float32).reshape(-1)
                 for key, leaf, _, _, _ in layout])) for flat in (mu_flat, nu_flat)), name)]
        else:
            targets = []
            for key, layer in _layers(model).items():
                for leaf, p in (("w", layer.weight), ("b", layer.bias)):
                    m = torch.tensor(np.asarray(mu_flat[f"{key}/{leaf}"], np.float32))
                    v = torch.tensor(np.asarray(nu_flat[f"{key}/{leaf}"], np.float32))
                    if leaf == "w":
                        m, v = m.T, v.T
                    targets.append((p, m, v, f"{name} {key}/{leaf}"))
        for p, m, v, what in targets:
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"{what}: moments {tuple(m.shape)}, parameter {tuple(p.shape)}")
            optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32,
                                     device=p.device if capturable else "cpu"),
                "exp_avg": m.to(p.device).contiguous(),
                "exp_avg_sq": v.to(p.device).contiguous(),
            }


def load_jax_opt_state(optimizer, models: dict, opt_state) -> None:
    """Read the optax Adam state of a JAX train checkpoint (its
    ``extra["opt_state"]`` as CheckpointManager restores it: Opaque tuples,
    one of them ``ScaleByAdamState(count, mu, nu)``) into a torch Adam."""
    def find(node):
        if isinstance(node, Opaque) and node.name == "ScaleByAdamState":
            return node
        if isinstance(node, tuple):
            for child in node:
                found = find(child)
                if found is not None:
                    return found
        return None

    adam = find(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimizer state")
    count, mu, nu = adam
    load_adam_state(optimizer, models, count, mu, nu)


def _flat(tree, model=None) -> dict:
    """{"trunk/0/w": array, ...} of a parameter tree, of such a flat
    mapping, or, given the model, of a flat vector in its
    jax_flat_layout's order."""
    if isinstance(tree, dict):
        return tree if any("/" in k for k in tree) else flatten_params(tree)
    vector = np.asarray(tree)
    if model is None or vector.ndim != 1:
        raise ValueError(f"expected a parameter tree (dict) or a flat parameter vector, got "
                         f"{type(tree).__name__} of shape {vector.shape}")
    layout = jax_flat_layout(model)
    key, leaf, _, offset, shape = layout[-1]
    if vector.size != offset + int(np.prod(shape)):
        raise ValueError(f"a flat parameter vector of {vector.size} values for a model of "
                         f"{offset + int(np.prod(shape))} parameters")
    return {f"{key}/{leaf}": vector[offset:offset + int(np.prod(shape))].reshape(shape)
            for key, leaf, _, offset, shape in layout}


@torch.no_grad()
def load_jax_params(model, tree) -> None:
    """Copy a JAX ParamNerf's parameters into ``model`` (a nerftex_torch
    ParamNerf), transposing each ``w`` to nn.Linear's [out, in]: a tree, a
    flat ``"trunk/0/w"`` mapping, or a flat vector (a JAX model trained
    with flat_params).  Shapes must match exactly; nothing is
    re-initialised."""
    flat = _flat(tree, model)
    targets = _layers(model)
    expected = {f"{k}/{n}" for k in targets for n in ("w", "b")}
    if set(flat) != expected:
        raise KeyError(f"parameter keys differ: missing {sorted(expected - set(flat))}, "
                       f"unexpected {sorted(set(flat) - expected)}")
    for key, layer in targets.items():
        w = torch.tensor(np.asarray(flat[f"{key}/w"], np.float32)).T
        b = torch.tensor(np.asarray(flat[f"{key}/b"], np.float32))
        if w.shape != layer.weight.shape or b.shape != layer.bias.shape:
            raise ValueError(f"{key}: got w {tuple(w.shape)} b {tuple(b.shape)}, model has "
                             f"{tuple(layer.weight.shape)} {tuple(layer.bias.shape)}")
        layer.weight.copy_(w)
        layer.bias.copy_(b)
