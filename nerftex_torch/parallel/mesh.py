"""Data and tensor parallelism over torch.distributed processes
(counterpart of nerftex_tpu/parallel/mesh.py).

The JAX package lays its devices out as a ("data", "model") mesh of shape
(dp, tp) and lets GSPMD insert the collectives: the sharded program is the
global program.  Here each process holds one device, the process of
global rank d * tp + m sits at (d, m) (as JAX's reshape of its device list
places device d * tp + m), and the shards meet through explicit
collectives over two kinds of process group: a data column (the dp
processes of one model rank) and a model row (the tp processes of one data
rank).

  - "data": the train steps render this data rank's contiguous slice of
    the batch's rays, with every draw at the rays' global rows
    (``Renderer.apply``'s ``rows``), so a shard draws exactly its rows of
    the whole batch's draw; the tp processes of a model row hold the same
    rays and draw the same rows, as GSPMD's global program does.  They
    backpropagate the shard's mean loss, all-reduce each model's gradients
    in one buffer over the data column (SUM, then times 1 / dp: gloo has
    no AVG) and the loss, and apply Adam.  Shards must be equal, so that
    the mean of the shard losses is the global mean.  Not
    DistributedDataParallel: ``chunked_apply`` calls the model once per
    net_chunk, under recomputation too, which DDP's reducer does not
    take, and the device-resident step captures its all-reduce in a CUDA
    graph;
  - "model" (``shard_model=True``): ``model_shardings``' Megatron layout
    of every ParamNerf trunk, each process holding its blocks and running
    the trunk through ``ShardedTrunk``: Megatron's conjugate pair over the
    model row (identity forward and all-reduce backward into a
    column-parallel layer, all-reduce forward and identity backward out of
    a row-parallel one), so each layer gives what the unsharded layer
    gives, and every replicated parameter gets the same gradient on every
    process of the row;
  - ``shard_render`` renders contiguous ranges of whole render chunks
    over the data column, each under its global key, and gathers the
    frame in ray order; a tensor-parallel model renders inside
    ``gathered``, whole.
"""

import contextlib

import torch
import torch.distributed as dist

from nerftex_torch.render.train import FusedStep, optimizer_step
from nerftex_torch.utils.util import resolve_device


class Mesh:
    """This process's place in the job: ``rank`` of ``world`` processes,
    each on one device (``device``, this process's), on the axes ("data",
    "model") of shape (dp, tp) = (world / tp, tp), at data rank
    ``rank // tp`` and model rank ``rank % tp``.  Its collectives run over
    ``data_group`` (this process's data column) and ``model_group`` (its
    model row), which make_mesh creates (None is the whole job), and need
    the ``backend``; a mesh built without one (backend None) only places
    and checks."""

    axis_names = ("data", "model")

    def __init__(self, rank: int, world: int, device, backend: str = None, tp: int = 1):
        self.rank = int(rank)
        self.world = int(world)
        self.tp = int(tp)
        if self.tp < 1 or self.world % self.tp:
            raise ValueError(f"a 'model' axis of {tp} in a job of {world} processes: the mesh "
                             f"is (world / tp, tp)")
        self.dp = self.world // self.tp
        self.data_rank, self.model_rank = divmod(self.rank, self.tp)
        self.device = torch.device(device)
        self.backend = backend
        self.data_group = self.model_group = None

    @property
    def shape(self) -> tuple:
        return (self.dp, self.tp)

    def shard_size(self, n: int) -> int:
        """The rays of each data rank's shard of ``n``; raises unless dp
        divides ``n``."""
        if n % self.dp:
            raise ValueError(f"{n} rays do not split evenly over {self.dp} data ranks: the "
                             f"shards must be equal for the mean of their losses to be the "
                             f"batch's")
        return n // self.dp

    def shard(self, value: torch.Tensor, axis: int) -> torch.Tensor:
        """This data rank's contiguous slice of ``value`` along ``axis``."""
        size = self.shard_size(value.shape[axis])
        return value.narrow(axis, self.data_rank * size, size)

    def global_rows(self, batch: int, rays: int) -> torch.Tensor:
        """[batch * rays] int64 on the device: the flat row b * R + r0 + r,
        in the whole [batch, R = rays * dp] batch, of each of this
        process's rays (b, r), whose shard starts at ray r0."""
        b = torch.arange(batch, dtype=torch.int64, device=self.device)[:, None]
        r = torch.arange(rays, dtype=torch.int64, device=self.device)[None, :]
        return (b * (rays * self.dp) + self.data_rank * rays + r).reshape(-1)

    def all_reduce_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data column and divided by dp, in place
        (gloo has no AVG); gloo takes CUDA tensors for this."""
        dist.all_reduce(x, group=self.data_group)
        return x.mul_(1.0 / self.dp)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data column, where ``x`` lies (NCCL is
        sent a copy on the device, gloo one on the host)."""
        y = x.to(self.device) if self.backend == "nccl" else x.cpu()
        dist.all_reduce(y, group=self.data_group)
        return y.to(x.device)

    def _all_gather(self, x: torch.Tensor, group, n: int) -> torch.Tensor:
        """[n * rows, ...] on x's device: ``x`` [rows, ...] (the same shape
        on each) of the n processes of ``group`` in rank order.  Under NCCL
        one all_gather_into_tensor on the device; gloo gathers no CUDA
        tensor, so under gloo the parts go through host tensors."""
        if self.backend == "nccl":
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous(), group=group)
            return out
        host = x.cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts).to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[dp * n, ...]: every data rank's ``x`` [n, ...] in data-rank order."""
        return self._all_gather(x, self.data_group, self.dp)

    def model_all_gather(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The blocks ``x`` of this model row's processes joined along
        ``axis`` in model-rank order."""
        whole = self._all_gather(x.movedim(axis, 0), self.model_group, self.tp)
        return whole.movedim(0, axis).contiguous()

    def model_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over this model row, summed in float32 and returned
        in x's dtype (a new tensor)."""
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=self.model_group)
        return y.to(x.dtype)


class Sharding:
    """Where an array lives on the mesh (JAX's ``NamedSharding(mesh,
    P(*spec))``): axis i of ``spec`` names the mesh axis it splits over
    ("data" or "model") or None; an empty spec replicates."""

    def __init__(self, mesh: Mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def local(self, value: torch.Tensor) -> torch.Tensor:
        """This process's block of the whole array ``value``."""
        for axis, name in enumerate(self.spec):
            if name == "data":
                value = self.mesh.shard(value, axis)
            elif name == "model":
                size = value.shape[axis] // self.mesh.tp
                value = value.narrow(axis, self.mesh.model_rank * size, size)
        return value


def make_mesh(n_devices: int = None, shape=None, axis_names=("data", "model"),
              device=None) -> Mesh:
    """The mesh of the initialised torch.distributed job (init_distributed):
    its processes on the axes ("data", "model") of ``shape`` (dp, tp),
    default (world, 1), global rank d * tp + m at (d, m); ``device`` is
    this process's (default: its card, utils.util.resolve_device).
    ``n_devices``, where given, must be the world size.  Every process
    creates every data-column and model-row group, in the same order
    (dist.new_group's rule); a group that spans the whole job is the
    default group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed job: call "
                           "nerftex_torch.parallel.init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices in a job of {world} processes: one "
                         f"process holds one device")
    shape = (world, 1) if shape is None else tuple(int(n) for n in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} for a job of {world} processes: (dp, tp) with "
                         f"dp * tp = {world}")
    if tuple(axis_names) != Mesh.axis_names:
        raise ValueError(f"axis names {tuple(axis_names)}, not {Mesh.axis_names}")
    dp, tp = shape
    mesh = Mesh(dist.get_rank(), world, resolve_device(device), backend=dist.get_backend(),
                tp=tp)

    def group(ranks):
        return None if len(ranks) == world else dist.new_group(ranks)

    for m in range(tp):
        column = group([d * tp + m for d in range(dp)])
        if m == mesh.model_rank:
            mesh.data_group = column
    if tp > 1:
        for d in range(dp):
            row = group([d * tp + m for m in range(tp)])
            if d == mesh.data_rank:
                mesh.model_group = row
    return mesh


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, batch: dict) -> dict:
    """Shard the ray axis (axis 1 of [B, R, ...]) across the 'data' axis;
    per-image tensors (parameters [B, P]) replicate."""
    return {key: Sharding(mesh, (None, "data")) if value.ndim >= 2 and key != "parameters"
            else replicated(mesh) for key, value in batch.items()}


def model_shardings(params: dict, mesh: Mesh) -> dict:
    """Megatron-style alternating column/row sharding of every model's MLP
    trunk (the JAX package's ``model_shardings``): {model name: {parameter
    name, as ``named_parameters`` gives it: Sharding}}.

    Trunk layer i splits over "model": an even layer is column-parallel
    (weight and bias split on the output features), an odd one
    row-parallel (weight split on the input features, bias replicated).
    Every other parameter replicates, and so does a model with one flat
    parameter (``flat_params``), as the JAX package's flat theta falls
    through to full replication.  JAX keeps w as [in, out], so its specs
    read P(None, "model") (column) and P("model", None) (row); nn.Linear
    keeps weight as [out, in], so the same blocks read ("model", None) and
    (None, "model") here.  A row-parallel layer's input block is JAX's
    row block of the concatenated input, which at a skip layer ([pos | h])
    does not line up with the previous layer's column block: ShardedTrunk
    gathers h there.  A sharded dimension that tp does not divide raises
    ValueError naming the model, the layer and the dimension, as JAX
    refuses to place such a leaf."""
    shardings = {}
    for name, model in params.items():
        specs = {pname: replicated(mesh) for pname, _ in model.named_parameters()}
        shardings[name] = specs
        if getattr(model, "flat", None) is not None:
            continue
        for i, layer in enumerate(getattr(model, "trunk", ())):
            column = i % 2 == 0
            n = layer.out_features if column else layer.in_features
            if n % mesh.tp:
                raise ValueError(
                    f"model {name!r}, trunk layer {i} ({'column' if column else 'row'}-"
                    f"parallel): its {'output' if column else 'input'} dimension of {n} (JAX's w "
                    f"[{layer.in_features}, {layer.out_features}], dimension "
                    f"{1 if column else 0}) does not split over the {mesh.tp} processes of the "
                    f"'model' axis")
            specs[f"trunk.{i}.weight"] = Sharding(mesh, ("model", None) if column
                                                  else (None, "model"))
            if column:
                specs[f"trunk.{i}.bias"] = Sharding(mesh, ("model",))
    return shardings


class _CopyToModel(torch.autograd.Function):
    """Into a column-parallel layer: identity forward, the gradient summed
    over the model row backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    """Out of a row-parallel layer: the partial products summed over the
    model row forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """A column-parallel output's blocks joined along the features forward;
    backward keeps this process's block of the (row-wide, already summed)
    gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.model_all_gather(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.model_rank * ctx.width
        return grad[..., start:start + ctx.width].contiguous(), None


class ShardedTrunk:
    """The trunk forward of a ParamNerf whose trunk layers hold this
    process's blocks of model_shardings' layout (``shardings``: the
    sharded parameters' Sharding); place_params installs it as the model's
    ``sharded_trunk``.

    A column-parallel layer takes its whole input (the row-wide sum of its
    gradient backward) and gives its output block; a row-parallel layer
    multiplies its input block by its weight block and sums the products
    over the row, then adds its bias.  Its input block is the previous
    layer's output block where that is its whole input; at a skip layer
    ([pos | h], whose row blocks straddle h's column blocks) h is gathered
    and the concatenation sliced.  A trunk of odd depth ends on a
    column-parallel layer, whose output is gathered for the heads.  Every
    process of the row holds the same whole activations outside the
    trunk, so the heads and parameter MLPs, replicated, get the same
    gradients on each."""

    def __init__(self, mesh: Mesh, shardings: dict):
        self.mesh = mesh
        self.shardings = shardings

    def __call__(self, model, pos_parts, dtype, weights=None):
        mesh = self.mesh
        parts, block = list(pos_parts), None
        for i, layer in enumerate(model.trunk):
            if weights is not None:
                w, b = weights[layer]
            else:
                w, b = layer.weight.to(dtype), layer.bias.to(dtype)
            if i % 2 == 0:
                x = _CopyToModel.apply(torch.cat(parts, -1), mesh)
                block = torch.relu(b + x @ w.T)
                continue
            if i - 1 in model.skips:
                whole = torch.cat(pos_parts + [_GatherFromModel.apply(block, mesh)], -1)
                k = w.shape[1]
                x = _CopyToModel.apply(whole, mesh)[:, mesh.model_rank * k:
                                                    (mesh.model_rank + 1) * k]
            else:
                x = block
            h = torch.relu(_ReduceFromModel.apply(x @ w.T, mesh) + b)
            parts, block = (pos_parts + [h] if i in model.skips else [h]), None
        if block is not None:
            h = _GatherFromModel.apply(block, mesh)
            parts = pos_parts + [h] if model.depth - 1 in model.skips else [h]
        return parts


@contextlib.contextmanager
def gathered(params: dict, mesh: Mesh):
    """Inside the block every model of ``params`` ({name: module}) holds
    its whole parameters, gathered over its model row, and runs its
    unsharded forward: a validation render (``ParamNerf.infer`` through
    the fused kernel) or rank 0's checkpoint sees what the single-process
    model holds.  On leaving, each process holds its blocks again as they
    were (a change made inside is not kept).  Models that are not sharded
    are left as they are."""
    held = []
    with torch.no_grad():
        for model in params.values():
            trunk = getattr(model, "sharded_trunk", None)
            if trunk is None:
                continue
            named = dict(model.named_parameters())
            blocks = {}
            for pname, sharding in trunk.shardings.items():
                blocks[pname] = named[pname].data
                named[pname].data = mesh.model_all_gather(blocks[pname],
                                                          sharding.spec.index("model"))
            model.sharded_trunk = None
            model.drop_packed()
            held.append((model, trunk, named, blocks))
    try:
        yield params
    finally:
        for model, trunk, named, blocks in held:
            for pname, block in blocks.items():
                named[pname].data = block
            model.sharded_trunk = trunk
            model.drop_packed()


def _placer(mesh: Mesh, shardings: dict = None):
    """place_params(params): rank 0's parameters of every model in
    ``params`` ({name: module}) on every process, in place, so the
    replicas start bit-equal (the packed inference weights are dropped);
    with ``shardings`` (model_shardings) and tp > 1, each process then
    keeps only its blocks of the sharded parameters (the same Parameter
    objects, so an optimizer built before keeps them; it must not have
    stepped) and the model runs its trunk through ShardedTrunk."""

    def place_params(params: dict) -> dict:
        with torch.no_grad():
            for name, model in params.items():
                if getattr(model, "sharded_trunk", None) is not None:
                    raise ValueError(f"model {name!r} is already placed: it holds its blocks")
                for p in model.parameters():
                    dist.broadcast(p.detach(), src=0)
                sharded = {pname: s for pname, s in (shardings or {}).get(name, {}).items()
                           if s.spec}
                if sharded and mesh.tp > 1:
                    for pname, p in model.named_parameters():
                        if pname in sharded:
                            p.data = sharded[pname].local(p.data).clone()
                    model.sharded_trunk = ShardedTrunk(mesh, sharded)
                if hasattr(model, "drop_packed"):
                    model.drop_packed()
        return params

    return place_params


def _all_reduce_step(models: dict, mesh: Mesh, loss: torch.Tensor) -> torch.Tensor:
    """The gradient all-reduce: each model's gradients in one buffer (its
    flat parameter's own gradient with flat_params, else a concatenation
    of this process's blocks and replicated parameters), averaged over the
    data column and written back; returns the averaged loss (detached).
    The processes of a column hold the same blocks; those of a model row
    hold the same replicated gradients already (ShardedTrunk)."""
    for model in models.values():
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if len(grads) == 1:
            mesh.all_reduce_mean_(grads[0])
        elif grads:
            buf = mesh.all_reduce_mean_(torch.cat([g.reshape(-1) for g in grads]))
            for g, part in zip(grads, buf.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
    return mesh.all_reduce_mean_(loss.detach().reshape(1).clone())[0]


def make_parallel_train_step(renderer, loss_fn, optimizer, mesh: Mesh, composite_bkgd,
                             bkgd_color, example_batch, params, shard_model: bool = False):
    """The data-parallel (optionally also tensor-parallel) host-fed step
    (the JAX package's ``make_parallel_train_step``): returns (step,
    place_params, place_batch).

    ``params`` is {name: module} of the models ``optimizer`` updates;
    ``place_params(params)`` broadcasts rank 0's and, with
    ``shard_model`` on a mesh with tp > 1, keeps this process's blocks of
    model_shardings' layout (see ``gathered`` for the whole parameters).
    ``place_batch(batch)`` gives this process its data rank's shard of a
    whole [B, R, ...] batch (host numpy or tensors) on its device: axis 1
    of every key but ``parameters``.  ``step(local_batch, key)`` renders
    the shard with the draws of its global rows, backpropagates its mean
    loss, all-reduces the gradients and the loss over the data column,
    applies Adam (render/train.py ``optimizer_step``) and returns the
    batch's mean loss, the same on every process.  Every process must be
    given the same whole batch and key; ``example_batch`` fixes which keys
    shard, and a ray count dp does not divide, or a trunk dimension tp
    does not divide (model_shardings), raises before any collective."""
    place_params = _placer(mesh, model_shardings(params, mesh) if shard_model else None)
    shardings = batch_sharding(mesh, example_batch)
    for key, sharding in shardings.items():
        if sharding.spec:
            mesh.shard_size(example_batch[key].shape[1])

    def step(batch: dict, key) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        b, r = batch["rays_o"].shape[0], batch["rays_o"].shape[1]
        pred = renderer.apply(batch, key, composite_bkgd=composite_bkgd, bkgd_color=bkgd_color,
                              training=True, rows=mesh.global_rows(b, r))
        loss = loss_fn(color_true=batch.get("color"), alpha_true=batch.get("alpha"), **pred)
        loss.backward()
        loss = _all_reduce_step(params, mesh, loss)
        optimizer_step(optimizer)
        return loss

    def place_batch(batch: dict) -> dict:
        return {k: shardings[k].local(torch.as_tensor(v, device=mesh.device)).contiguous()
                for k, v in batch.items()}

    return step, place_params, place_batch


class ParallelFusedStep(FusedStep):
    """The device-resident step of one process of a data-parallel (and
    optionally tensor-parallel) job (render/train.py ``FusedStep``): every
    process samples the whole batch under the step's data key, as the JAX
    package's step samples it replicated, keeps its data rank's ray shard,
    renders it with the draws of its global rows (a sharded trunk through
    its model row's collectives), and all-reduces the gradients and the
    loss over the data column between the backward and Adam.  On CUDA the
    collectives are captured in the step's CUDA graph, so the backend must
    be NCCL (gloo's collectives are not captured); FusedStep's warm-up runs
    them once first, outside the graph, which creates the communicators.
    On the CPU (gloo) each step runs eagerly."""

    def __init__(self, mesh: Mesh, models: dict, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.capturable and mesh.backend != "nccl":
            raise ValueError(f"the device-resident step on CUDA captures its all-reduce in a "
                             f"CUDA graph, which needs the NCCL backend, not {mesh.backend}")
        self.mesh = mesh
        self.models = models
        b, n = self.sampler.batchsize, self.sampler.n_samples
        self.rows = mesh.global_rows(b, mesh.shard_size(n))

    def _loss(self, batch: dict, key) -> torch.Tensor:
        shardings = batch_sharding(self.mesh, batch)
        local = {k: shardings[k].local(v) for k, v in batch.items()}
        pred = self.renderer.apply(local, key, composite_bkgd=self.composite_bkgd,
                                   bkgd_color=self.bkgd_color, training=True, rows=self.rows)
        loss = self.loss_fn(color_true=local["color"], alpha_true=local["alpha"], **pred)
        loss.backward()
        return _all_reduce_step(self.models, self.mesh, loss)


def make_parallel_fused_train_step(renderer, loss_fn, optimizer, sampler, mesh: Mesh,
                                   composite_bkgd, bkgd_color, params,
                                   shard_model: bool = False, max_steps: int = 1):
    """The data-parallel (optionally also tensor-parallel) device-resident
    step (the JAX package's ``make_parallel_fused_train_step``): returns
    (step, place_params, place_tables).  ``step`` is a ParallelFusedStep: ``step.run(start, k)``
    takes steps start .. start + k - 1 (k at most ``max_steps``) and
    returns their all-reduced losses.  The tables replicate: each process
    builds its own ``sampler`` from the same records, and
    ``place_tables()`` returns them.  ``optimizer`` is render/train.py's
    ``make_optimizer`` (capturable on CUDA); ``params``, ``shard_model``
    and ``place_params`` as in make_parallel_train_step: a flat-parameter
    model replicates over "model", and its flat gradient all-reduces over
    the data column."""
    place_params = _placer(mesh, model_shardings(params, mesh) if shard_model else None)
    step = ParallelFusedStep(mesh, params, renderer, loss_fn, optimizer, sampler,
                             composite_bkgd, bkgd_color, optimizer.lrate, optimizer.lrate_decay,
                             max_steps=max_steps)
    return step, place_params, lambda: sampler.tables


def shard_render(renderer, mesh: Mesh):
    """``renderer.__call__`` with the frame's render chunks split over the
    data axis: the chunks are cut as the renderer cuts them, data rank p
    renders a contiguous range of whole chunks (the first n % dp one
    more; the processes of a model row render the same chunks), each under its global fold_in(key, start), so the
    sorted instanced path sorts and keys its blocks as in the unsharded
    render; the outputs are gathered in ray order onto every process's
    device (one all_gather_into_tensor each under NCCL; through host
    tensors under gloo, which gathers no CUDA tensor), and the drop counts
    (``_overflow_*``) summed over the processes before the renderer
    reports them.  Every process gets the unsharded render's result for
    the same rays and key.  Fewer chunks than data ranks raises.  A
    tensor-parallel model renders inside ``gathered``."""

    @torch.inference_mode()
    def call(rays_o, rays_d, t, parameters, cone_scale, composite_bkgd: bool = False,
             bkgd_color=(1, 1, 1.0), training: bool = False, key=None, **kwargs) -> dict:
        key = renderer.frame_key(key)
        b, r = rays_o.shape[0], rays_o.shape[1]
        flat, chunk = renderer.chunk_rays({"rays_o": rays_o, "rays_d": rays_d, "t": t,
                                           "parameters": parameters, "cone_scale": cone_scale})
        n_chunks = flat["t"].shape[0] // chunk
        if n_chunks < mesh.dp:
            raise ValueError(f"{n_chunks} render chunks of {chunk} rays for {mesh.dp} data "
                             f"ranks: each renders whole chunks (lower render_chunk)")
        base, extra = divmod(n_chunks, mesh.dp)
        counts = [base + (p < extra) for p in range(mesh.dp)]
        first = sum(counts[:mesh.data_rank])
        local = renderer.render_chunks(
            flat, range(first * chunk, (first + counts[mesh.data_rank]) * chunk, chunk), chunk,
            key, composite_bkgd, bkgd_color, training)

        held = max(counts) * chunk  # every process's part padded to this many rays
        out = {}
        for name, v in local.items():
            if name.startswith("_"):
                continue
            padded = torch.cat([v, v.new_zeros((held - v.shape[0],) + tuple(v.shape[1:]))])
            whole = mesh.all_gather(padded)
            out[name] = torch.cat([whole[p * held:p * held + counts[p] * chunk]
                                   for p in range(mesh.dp)])
        drops = [name for name in local if name.startswith("_")]
        if drops:
            summed = mesh.all_reduce_sum(torch.tensor([local[k] for k in drops],
                                                      dtype=torch.int64))
            out.update(zip(drops, summed.tolist()))
        out = renderer.frame_of(out, b, r)
        renderer._report_diagnostics(out)
        return out

    return call
