"""A plain reference of the training step: a batch of rays through the
patch MLP with stratified samples, the alpha loss, its gradient and Adam.

Per step s (the NeRF-Tex training step as its configuration states it):
each ray's n_samples depths evenly spaced over its proxy interval and
jittered within their bins by uniform draws under
fold_in(fold_in(fold_in(key(seed), STREAM_PERTURB), 0), s) (split in four,
the first); the MLP (mlp.py) at each sample, the ray's normalised
direction and the view's parameters; the composite (alpha 1 - exp(-relu
(density) * spacing), the last spacing repeated); the loss smape of the
colors inside the true alpha mask plus the mse of alpha; autograd; Adam
with betas (0.9, 0.999), eps 1e-7 and the rate lrate * 0.1 ** (count /
(lrate_decay * 1000)).  Every product is float32 (with ``tf32``, on
operands and gradients rounded to TF32: the lower-precision control).
"""

import torch

from benchmark.reference import jax_rng
from benchmark.reference.mlp import ReferenceMLP, round_tf32

STREAM_PERTURB = 1
BETAS, EPS = (0.9, 0.999), 1e-7


class _TF32Matmul(torch.autograd.Function):
    """x @ w with both operands, and the gradients' operands, rounded to TF32."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_tf32(g)
        return gr @ wr.T, xr.T @ gr


class _GradMLP(ReferenceMLP):
    """ReferenceMLP over leaf tensors that autograd differentiates."""

    def __init__(self, spec, params: dict, tf32: bool):
        self.spec, self.tf32, self.w = spec, tf32, params

    def dense(self, name, parts, relu=True):
        x = torch.cat(parts, -1)
        w = self.w[f"{name}/w"]
        y = (_TF32Matmul.apply(x, w) if self.tf32 else x @ w) + self.w[f"{name}/b"]
        return torch.relu(y) if relu else y


def step_key(seed: int, s: int):
    base = jax_rng.fold_in(jax_rng.fold_in(jax_rng.key(seed), STREAM_PERTURB), 0)
    return jax_rng.fold_in(base, s)


def forward_loss(mlp, batch: dict, key, n_samples: int):
    """The loss of one batch {rays_o, rays_d, t [B, R, ...], parameters [B,
    P], color, alpha} under ``key``."""
    b, r = batch["rays_o"].shape[:2]
    o = batch["rays_o"].reshape(b * r, 3).float()
    d = batch["rays_d"].reshape(b * r, 3).float()
    t = batch["t"].reshape(b * r, 2).float()
    prm = batch["parameters"].float().repeat_interleave(r, 0)
    miss = torch.isinf(t[:, 0])
    t = torch.where(miss[:, None], torch.zeros_like(t), t)
    d_n = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    k_perturb = jax_rng.split(key, 4)[0]
    lin = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float32, device=o.device)
    z = t[:, None, 0] * (1 - lin) + t[:, None, 1] * lin
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    z = lower + (upper - lower) * jax_rng.uniform(k_perturb, z.shape, device=o.device)
    pts = o[:, None, :] + d[:, None, :] * z[..., None]
    n = b * r
    logits, density = mlp(pts.reshape(n * n_samples, 3), d_n.repeat_interleave(n_samples, 0),
                          prm.repeat_interleave(n_samples, 0))
    logits, density = logits.reshape(n, n_samples, 3), density.reshape(n, n_samples)
    dists = z[:, 1:] - z[:, :-1]
    dists = torch.cat([dists, dists[:, -1:]], -1) * torch.linalg.norm(d[:, None, :], dim=-1)
    alpha = 1.0 - torch.exp(-torch.relu(density) * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
    weights = alpha * trans
    color = torch.sum(weights[..., None] * torch.sigmoid(logits), -2)
    alpha_map = torch.sum(weights, -1)
    valid = (~miss).float()
    color, alpha_map = color * valid[:, None], alpha_map * valid
    c_true = batch["color"].reshape(n, 3).float()
    a_true = batch["alpha"].reshape(n).float()
    mask = (a_true[:, None] > 0).float()
    c_true, c_pred = c_true * mask, color * mask
    smape = torch.mean(torch.abs(c_true - c_pred) / (c_true + c_pred + 1e-2))
    return smape + torch.mean(torch.square(a_true - alpha_map))


def run_steps(spec, weights: dict, batches: list, seed: int, train: dict, device,
              tf32: bool = False) -> dict:
    """The first len(batches) steps from ``weights``: {"losses": [..],
    "grad0": {leaf: first gradient}, "delta": {leaf: parameters after the
    steps minus before}}."""
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone().requires_grad_()
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mlp = _GradMLP(spec, params, tf32)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad0 = [], None
    n_samples = int(train["renderer_config"]["n_samples"])
    for s, batch in enumerate(batches):
        batch = {k: torch.as_tensor(x, device=device) for k, x in batch.items()}
        loss = forward_loss(mlp, batch, step_key(seed, s), n_samples)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        g = dict(zip(params, grads))
        if grad0 is None:
            grad0 = {k: x.detach().clone() for k, x in g.items()}
        lr = train["lrate"] * 0.1 ** (s / (train["lrate_decay"] * 1e3))
        with torch.no_grad():
            for k, p in params.items():
                m[k].mul_(BETAS[0]).add_(g[k], alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g[k], g[k], value=1 - BETAS[1])
                mhat = m[k] / (1 - BETAS[0] ** (s + 1))
                vhat = v2[k] / (1 - BETAS[1] ** (s + 1))
                p.sub_(lr * mhat / (vhat.sqrt() + EPS))
    return {"losses": losses, "grad0": grad0,
            "delta": {k: params[k].detach() - start[k] for k in params}}
