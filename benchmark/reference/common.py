"""What the plain references share: rounding to a lower precision (the
GKN's ratio scale and control), the plain MLP, mean aggregation and Adam
with L2 weight decay, in float32 PyTorch with TF32 off."""
from __future__ import annotations

import contextlib

import torch


def exact(t):
    return t


def _ste(t, rounded):
    # rounded in the forward, the identity in the backward
    return t + (rounded - t).detach()


def fp8(t):
    """float8 e4m3 rounding of a GEMM operand in the forward (the step
    below bf16); the backward passes the gradient through unrounded."""
    return _ste(t, t.to(torch.float8_e4m3fn).to(torch.float32))


def _scaled(t, dtype):
    """``t`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, as FP8 training scales
    gradients so that they do not underflow."""
    amax = t.abs().amax()
    scale = torch.where(amax > 0, torch.finfo(dtype).max / amax,
                        torch.ones_like(amax))
    return (t * scale).to(dtype).to(torch.float32) / scale


class _Fp8Both(torch.autograd.Function):
    """The forward rounds as ``fp8`` does; the backward rounds the
    gradient that flows back through the operand to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.float8_e4m3fn).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2)


def fp8_both(t):
    """float8 rounding of a GEMM operand in the forward (e4m3, as
    ``fp8``) and of the gradient through it in the backward (e5m2, under
    a per-tensor scale): FP8 training's usual pair of formats."""
    return _Fp8Both.apply(t)


ROUNDING = {"float32": exact, "float8_e4m3": fp8,
            "float8_e4m3_e5m2": fp8_both}


@contextlib.contextmanager
def fp32_exact():
    """float32 matmuls without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def mlp(p: dict, name: str, n_layers: int, x, q=exact):
    """A ReLU MLP stored as {name}.{j}.w / .b, no output activation; q
    rounds each product's operands."""
    for j in range(n_layers):
        x = q(x) @ q(p[f"{name}.{j}.w"]) + p[f"{name}.{j}.b"]
        if j != n_layers - 1:
            x = torch.relu(x)
    return x


def contract(x_src, k, width: int, q=exact):
    """msg[e, o] = sum_i x_src[e, i] * K[e, i * width + o]."""
    kk = q(k).view(-1, x_src.shape[1], width)
    return torch.bmm(q(x_src)[:, None, :], kk)[:, 0, :]


def mean_into(msg, receivers, degree, n: int):
    """Sum of the messages per receiver over the degree (clamped to 1,
    so a node without edges gets zeros)."""
    out = msg.new_zeros((n, msg.shape[1])).index_add(0, receivers, msg)
    return out / degree.clamp_min(1.0)[:, None]


def degree(receivers, n: int, device):
    return torch.zeros(n, device=device).index_add(
        0, receivers, torch.ones(receivers.shape[0], device=device))


def adam_step(params: dict, grads: dict, state: dict, lr: float, wd: float,
              betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """One Adam step with the weight decay added to the gradient (L2, as
    torch.optim.Adam); returns the gradient the moments took."""
    b1, b2 = betas
    state["t"] = t = state.get("t", 0) + 1
    taken = {}
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k] + wd * p
            taken[k] = g
            m = state.setdefault(("m", k), torch.zeros_like(p))
            v = state.setdefault(("v", k), torch.zeros_like(p))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
            p.sub_(lr / (1 - b1 ** t) * m / denom)
    return taken


def train_three(params: dict, loss_fn, batches: list, lr: float, wd: float):
    """The reference's steps on ``batches`` from ``params`` (float32
    leaves, updated in place): each step's loss, the gradient the first
    step's optimizer took, and the parameters after the last step."""
    state, losses, first = {}, [], None
    for batch in batches:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        for v in leaves.values():
            v.requires_grad_(False)
        taken = adam_step(params, dict(zip(leaves, grads)), state, lr, wd)
        if first is None:
            first = {k: g.detach().clone() for k, g in taken.items()}
    return {"loss": losses, "grad1": first,
            "params": {k: v.detach().clone() for k, v in params.items()}}
