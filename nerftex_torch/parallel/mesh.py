"""Data parallelism over torch.distributed processes (counterpart of
nerftex_tpu/parallel/mesh.py).

The JAX package shards the ray axis of a batch over a device mesh and lets
GSPMD insert the collectives: the sharded program is the global program.
Here each process holds one device and computes its own shard, and the
shards meet through explicit collectives:

  - the train steps render this process's contiguous slice of the batch's
    rays, with every draw at the rays' global rows (``Renderer.apply``'s
    ``rows``), so a shard draws exactly its rows of the whole batch's
    draw; they backpropagate the shard's mean loss, all-reduce each
    model's gradients in one buffer (SUM, then times 1 / world: gloo has
    no AVG) and the loss, and apply Adam.  Shards must be equal, so that
    the mean of the shard losses is the global mean.  Not
    DistributedDataParallel: ``chunked_apply`` calls the model once per
    net_chunk, under recomputation too, which DDP's reducer does not
    take, and the device-resident step captures its all-reduce in a CUDA
    graph;
  - ``shard_render`` renders contiguous ranges of whole render chunks,
    each under its global key, and gathers the frame in ray order.

The mesh is ("data", "model") of shape (world, 1): the tensor-parallel
width sharding (the JAX package's ``model_shardings``, ``shard_model``) is
not ported yet (ROADMAP.md, Queue 1, item 3), and asking for it raises.
"""

import torch
import torch.distributed as dist

from nerftex_torch.render.train import FusedStep, optimizer_step
from nerftex_torch.utils.util import resolve_device

_TENSOR_PARALLEL = ("tensor-parallel width sharding (the JAX package's model_shardings, "
                    "shard_model=True, a 'model' axis over 1) is not ported yet: ROADMAP.md, "
                    "Queue 1, item 3")


class Mesh:
    """This process's place in the job: ``rank`` of ``world`` processes,
    each on one device (``device``, this process's), on the axes ("data",
    "model") of shape (world, 1).  Its collectives run on the default
    process group, whose ``backend`` they need to know; a mesh built
    without one (backend None) only places and checks."""

    axis_names = ("data", "model")

    def __init__(self, rank: int, world: int, device, backend: str = None):
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.backend = backend

    @property
    def shape(self) -> tuple:
        return (self.world, 1)

    def shard_size(self, n: int) -> int:
        """The rays of each process's shard of ``n``; raises unless the
        world divides ``n``."""
        if n % self.world:
            raise ValueError(f"{n} rays do not split evenly over {self.world} processes: the "
                             f"shards must be equal for the mean of their losses to be the "
                             f"batch's")
        return n // self.world

    def shard(self, value: torch.Tensor, axis: int) -> torch.Tensor:
        """This process's contiguous slice of ``value`` along ``axis``."""
        size = self.shard_size(value.shape[axis])
        return value.narrow(axis, self.rank * size, size)

    def global_rows(self, batch: int, rays: int) -> torch.Tensor:
        """[batch * rays] int64 on the device: the flat row b * R + r0 + r,
        in the whole [batch, R = rays * world] batch, of each of this
        process's rays (b, r), whose shard starts at ray r0."""
        b = torch.arange(batch, dtype=torch.int64, device=self.device)[:, None]
        r = torch.arange(rays, dtype=torch.int64, device=self.device)[None, :]
        return (b * (rays * self.world) + self.rank * rays + r).reshape(-1)

    def all_reduce_mean_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes and divided by their number, in
        place (gloo has no AVG); gloo takes CUDA tensors for this."""
        dist.all_reduce(x)
        return x.mul_(1.0 / self.world)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes, where ``x`` lies (NCCL is sent
        a copy on the device, gloo one on the host)."""
        y = x.to(self.device) if self.backend == "nccl" else x.cpu()
        dist.all_reduce(y)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[world * n, ...] on the device: every process's ``x`` [n, ...]
        (the same shape on each) in rank order.  Under NCCL one
        all_gather_into_tensor on the device; gloo gathers no CUDA tensor,
        so under gloo the parts go through host tensors."""
        if self.backend == "nccl":
            out = x.new_empty((self.world * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous())
            return out
        host = x.cpu().contiguous()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(parts, host)
        return torch.cat(parts).to(self.device)


class Sharding:
    """Where an array lives on the mesh (JAX's ``NamedSharding(mesh,
    P(*spec))``): axis i of ``spec`` names the mesh axis it splits over
    ("data") or None; an empty spec replicates."""

    def __init__(self, mesh: Mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def local(self, value: torch.Tensor) -> torch.Tensor:
        """This process's block of the whole array ``value``."""
        for axis, name in enumerate(self.spec):
            if name == "data":
                value = self.mesh.shard(value, axis)
        return value


def make_mesh(n_devices: int = None, shape=None, axis_names=("data", "model"),
              device=None) -> Mesh:
    """The mesh of the initialised torch.distributed job (init_distributed):
    its processes on the "data" axis, shape (world, 1); ``device`` is this
    process's (default: its card, utils.util.resolve_device).
    ``n_devices``, where given, must be the world size; a shape other than
    (world, 1) is tensor parallelism, which raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed job: call "
                           "nerftex_torch.parallel.init_distributed first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices in a job of {world} processes: one "
                         f"process holds one device")
    if shape is not None and tuple(shape) != (world, 1):
        raise NotImplementedError(f"mesh shape {tuple(shape)}: {_TENSOR_PARALLEL}")
    if tuple(axis_names) != Mesh.axis_names:
        raise ValueError(f"axis names {tuple(axis_names)}, not {Mesh.axis_names}")
    return Mesh(dist.get_rank(), world, resolve_device(device), backend=dist.get_backend())


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh)


def batch_sharding(mesh: Mesh, batch: dict) -> dict:
    """Shard the ray axis (axis 1 of [B, R, ...]) across the 'data' axis;
    per-image tensors (parameters [B, P]) replicate."""
    return {key: Sharding(mesh, (None, "data")) if value.ndim >= 2 and key != "parameters"
            else replicated(mesh) for key, value in batch.items()}


def _place_params(params: dict) -> dict:
    """Rank 0's parameters of every model in ``params`` ({name: module})
    on every process, in place, so the replicas start bit-equal (the
    packed inference weights are dropped)."""
    with torch.no_grad():
        for model in params.values():
            for p in model.parameters():
                dist.broadcast(p.detach(), src=0)
            if hasattr(model, "drop_packed"):
                model.drop_packed()
    return params


def _all_reduce_step(models: dict, mesh: Mesh, loss: torch.Tensor) -> torch.Tensor:
    """The gradient all-reduce: each model's gradients in one buffer (its
    flat parameter's own gradient with flat_params, else a concatenation),
    averaged over the processes and written back; returns the averaged
    loss (detached)."""
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
    """The data-parallel host-fed step (the JAX package's
    ``make_parallel_train_step``): returns (step, place_params,
    place_batch).

    ``params`` is {name: module} of the models ``optimizer`` updates;
    ``place_params(params)`` broadcasts rank 0's.  ``place_batch(batch)``
    gives this process its shard of a whole [B, R, ...] batch (host numpy
    or tensors) on its device: axis 1 of every key but ``parameters``.
    ``step(local_batch, key)`` renders the shard with the draws of its
    global rows, backpropagates its mean loss, all-reduces the gradients
    and the loss, applies Adam (render/train.py ``optimizer_step``) and
    returns the batch's mean loss, the same on every process.  Every
    process must be given the same whole batch and key; ``example_batch``
    fixes which keys shard, and a ray count the world does not divide
    raises."""
    if shard_model:
        raise NotImplementedError(_TENSOR_PARALLEL)
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

    return step, _place_params, place_batch


class ParallelFusedStep(FusedStep):
    """The device-resident step of one process of a data-parallel job
    (render/train.py ``FusedStep``): every process samples the whole batch
    under the step's data key, as the JAX package's step samples it
    replicated, keeps its ray shard, renders it with the draws of its
    global rows, and all-reduces the gradients and the loss between the
    backward and Adam.  On CUDA the all-reduce is captured in the step's
    CUDA graph, so the backend must be NCCL (gloo's collectives are not
    captured); FusedStep's warm-up runs it once first, outside the graph,
    which creates the communicator.  On the CPU (gloo) each step runs
    eagerly."""

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
    """The data-parallel device-resident step (the JAX package's
    ``make_parallel_fused_train_step``): returns (step, place_params,
    place_tables).  ``step`` is a ParallelFusedStep: ``step.run(start, k)``
    takes steps start .. start + k - 1 (k at most ``max_steps``) and
    returns their all-reduced losses.  The tables replicate: each process
    builds its own ``sampler`` from the same records, and
    ``place_tables()`` returns them.  ``optimizer`` is render/train.py's
    ``make_optimizer`` (capturable on CUDA); ``params`` and
    ``place_params`` as in make_parallel_train_step."""
    if shard_model:
        raise NotImplementedError(_TENSOR_PARALLEL)
    step = ParallelFusedStep(mesh, params, renderer, loss_fn, optimizer, sampler,
                             composite_bkgd, bkgd_color, optimizer.lrate, optimizer.lrate_decay,
                             max_steps=max_steps)
    return step, _place_params, lambda: sampler.tables


def shard_render(renderer, mesh: Mesh):
    """``renderer.__call__`` with the frame's render chunks split over the
    processes: the chunks are cut as the renderer cuts them, process p
    renders a contiguous range of whole chunks (the first n % world
    processes one more), each under its global fold_in(key, start), so the
    sorted instanced path sorts and keys its blocks as in the unsharded
    render; the outputs are gathered in ray order onto every process's
    device (one all_gather_into_tensor each under NCCL; through host
    tensors under gloo, which gathers no CUDA tensor), and the drop counts
    (``_overflow_*``) summed over the processes before the renderer
    reports them.  Every process gets the unsharded render's result for
    the same rays and key.  Fewer chunks than processes raises."""

    @torch.inference_mode()
    def call(rays_o, rays_d, t, parameters, cone_scale, composite_bkgd: bool = False,
             bkgd_color=(1, 1, 1.0), training: bool = False, key=None, **kwargs) -> dict:
        key = renderer.frame_key(key)
        b, r = rays_o.shape[0], rays_o.shape[1]
        flat, chunk = renderer.chunk_rays({"rays_o": rays_o, "rays_d": rays_d, "t": t,
                                           "parameters": parameters, "cone_scale": cone_scale})
        n_chunks = flat["t"].shape[0] // chunk
        if n_chunks < mesh.world:
            raise ValueError(f"{n_chunks} render chunks of {chunk} rays for {mesh.world} "
                             f"processes: each renders whole chunks (lower render_chunk)")
        base, extra = divmod(n_chunks, mesh.world)
        counts = [base + (p < extra) for p in range(mesh.world)]
        first = sum(counts[:mesh.rank])
        local = renderer.render_chunks(
            flat, range(first * chunk, (first + counts[mesh.rank]) * chunk, chunk), chunk, key,
            composite_bkgd, bkgd_color, training)

        held = max(counts) * chunk  # every process's part padded to this many rays
        out = {}
        for name, v in local.items():
            if name.startswith("_"):
                continue
            padded = torch.cat([v, v.new_zeros((held - v.shape[0],) + tuple(v.shape[1:]))])
            whole = mesh.all_gather(padded)
            out[name] = torch.cat([whole[p * held:p * held + counts[p] * chunk]
                                   for p in range(mesh.world)])
        drops = [name for name in local if name.startswith("_")]
        if drops:
            summed = mesh.all_reduce_sum(torch.tensor([local[k] for k in drops],
                                                      dtype=torch.int64))
            out.update(zip(drops, summed.tolist()))
        out = renderer.frame_of(out, b, r)
        renderer._report_diagnostics(out)
        return out

    return call
