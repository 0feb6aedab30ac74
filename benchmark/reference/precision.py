"""The training step's plain reference (train.py) at a stated precision.

``float32`` is train.py's step as it stands: every product in IEEE
float32.  ``bf16`` and ``e4m3`` round both operands of every product of
the MLP, and the gradient that flows into it, to the mantissa of bfloat16
(7 bits) or of fp8 e4m3 (3 bits), to nearest even, and multiply the
rounded values in float32; everything else (encodings, biases, the
composite, the loss, Adam) stays float32.  The exponent is float32's in
both: the rounding models a format's precision, as a scaled fp8 step
keeps its values in range, not its overflow or underflow.  bf16 is the
precision the training configurations state; e4m3 is the next lower
one, the control that a comparison must be able to tell apart.

TF32 is off for every product here: a float32 product on the card may
otherwise run in TF32.
"""

import torch

from benchmark.reference import train as ref_train

MANTISSA_BITS = {"bf16": 7, "e4m3": 3}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x rounded to ``bits`` mantissa bits (to nearest even), as float32."""
    drop = 23 - bits
    v = x.float().contiguous().view(torch.int32).to(torch.int64)
    v = (v + ((1 << (drop - 1)) - 1) + ((v >> drop) & 1)) & ~((1 << drop) - 1)
    v = torch.where(v >= 2**31, v - 2**32, v)
    return v.to(torch.int32).view(torch.float32)


class _RoundedMatmul(torch.autograd.Function):
    """x @ w with both operands, and the gradients' operands, rounded."""

    @staticmethod
    def forward(ctx, x, w, bits):
        xr, wr = round_mantissa(x, bits), round_mantissa(w, bits)
        ctx.save_for_backward(xr, wr)
        ctx.bits = bits
        return xr @ wr

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_mantissa(g, ctx.bits)
        return gr @ wr.T, xr.T @ gr, None


class _RoundedMLP(ref_train._GradMLP):
    def __init__(self, spec, params: dict, bits: int):
        super().__init__(spec, params, tf32=False)
        self.bits = bits

    def dense(self, name, parts, relu=True):
        y = _RoundedMatmul.apply(torch.cat(parts, -1), self.w[f"{name}/w"], self.bits) \
            + self.w[f"{name}/b"]
        return torch.relu(y) if relu else y


def run_steps(spec, weights: dict, batches: list, seed: int, train: dict, device,
              precision: str = "float32") -> dict:
    """train.py's ``run_steps`` at ``precision`` (float32, bf16 or e4m3):
    {"losses", "grad0", "delta"} of the first len(batches) steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if precision == "float32":
        return ref_train.run_steps(spec, weights, batches, seed, train, device)
    bits = MANTISSA_BITS[precision]
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone().requires_grad_()
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    mlp = _RoundedMLP(spec, params, bits)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad0 = [], None
    beta1, beta2 = ref_train.BETAS
    for s, batch in enumerate(batches):
        batch = {k: torch.as_tensor(x, device=device) for k, x in batch.items()}
        loss = ref_train.forward_loss(mlp, batch, ref_train.step_key(seed, s),
                                      int(train["renderer_config"]["n_samples"]))
        g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = {k: x.detach().clone() for k, x in g.items()}
        lr = train["lrate"] * 0.1 ** (s / (train["lrate_decay"] * 1e3))
        with torch.no_grad():
            for k, p in params.items():
                m[k].mul_(beta1).add_(g[k], alpha=1 - beta1)
                v2[k].mul_(beta2).addcmul_(g[k], g[k], value=1 - beta2)
                mhat = m[k] / (1 - beta1 ** (s + 1))
                vhat = v2[k] / (1 - beta2 ** (s + 1))
                p.sub_(lr * mhat / (vhat.sqrt() + ref_train.EPS))
    return {"losses": losses, "grad0": grad0,
            "delta": {k: params[k].detach() - start[k] for k in params}}
