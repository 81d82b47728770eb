"""Switch-style mixture-of-experts layer (counterpart of
``petastorm_tpu/models/moe.py``).

Top-1 (Switch) routing with a static per-expert capacity and the dense
GShard dispatch and combine: every expert processes exactly ``capacity``
token slots, tokens past it are dropped and pass through as zero (the
caller's residual carries them), and the standard auxiliary
load-balancing loss ``E * sum_e f_e * p_e`` (fraction of tokens routed to
``e`` times the mean router probability of ``e``) is minimized at uniform
routing. Routing runs in f32; the expert matmuls run in ``config.dtype``
with f32 accumulation, as the JAX package leaves them to XLA.

The experts live on the one device. The JAX package shards them over a
mesh axis and routes per sequence shard under ``shard_map``
(``seq_axis=``); both wait for ROADMAP.md Queue 1 item 8.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.errors import unported


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: object = torch.bfloat16


class MoE(nn.Module):
    """The JAX layer's parameters as an ``nn.Module``: ``router``
    ``(d_model, E)``, ``w_in`` ``(E, d_model, d_ff)`` and ``w_out``
    ``(E, d_ff, d_model)``, f32."""

    def __init__(self, config):
        super().__init__()
        c = config
        self.router = nn.Parameter(torch.empty((c.d_model, c.n_experts)))
        self.w_in = nn.Parameter(torch.empty((c.n_experts, c.d_model, c.d_ff)))
        self.w_out = nn.Parameter(torch.empty((c.n_experts, c.d_ff, c.d_model)))
        self._scales = (c.d_model ** -0.5, c.d_model ** -0.5, c.d_ff ** -0.5)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Normal draws from ``generator`` at the JAX init's scales:
        ``d_model**-0.5`` for the router and ``w_in``, ``d_ff**-0.5`` for
        ``w_out``."""
        for p, scale in zip((self.router, self.w_in, self.w_out), self._scales):
            p.copy_(torch.randn(p.shape, generator=generator) * scale)


def init_moe(seed, config, device=None):
    """An :class:`MoE` with weights drawn from a CPU ``torch.Generator``
    seeded ``seed``, on ``device`` (``None`` means the card)."""
    layer = MoE(config)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return layer.to(torch.device('cuda' if device is None else device))


def expert_capacity(n_tokens, n_experts, capacity_factor):
    """Static per-expert token budget (ceil of the uniform share x factor)."""
    return max(1, int(np.ceil(n_tokens / n_experts * capacity_factor)))


def moe_forward(layer, x, config, capacity=None, seq_axis=None):
    """Apply the MoE layer (the JAX version's ``params`` are the
    :class:`MoE` ``layer``'s parameters).

    :param x: ``(..., d_model)`` activations; leading axes are flattened
        into a token axis for routing and restored on return.
    :param capacity: per-expert token slots (default from
        :func:`expert_capacity`).
    :param seq_axis: routing local to each sequence shard; not ported
        (ROADMAP.md Queue 1 item 8).
    :return: ``(y, aux_loss)``: ``y`` shaped like ``x`` in its dtype,
        ``aux_loss`` the scalar f32 Switch load-balancing loss.
    """
    if seq_axis is not None:
        raise unported('moe_forward(seq_axis=) (routing per sequence shard)', 8)
    c = config
    router, w_in, w_out = layer.router, layer.w_in, layer.w_out
    lead_shape = x.shape[:-1]
    tokens = x.reshape(-1, c.d_model)
    if capacity is None:
        capacity = expert_capacity(tokens.shape[0], c.n_experts, c.capacity_factor)

    # routing, in f32: a router decision must not flip in bf16
    probs = torch.softmax(torch.matmul(tokens.float(), router.float()), dim=-1)  # (T, E)
    onehot = F.one_hot(probs.argmax(dim=-1), c.n_experts).float()
    # the gate through the one-hot contraction, as the JAX layer takes it
    gate = (probs * onehot).sum(dim=-1)                                         # (T,)
    # each token's place in its expert's queue, counted in integers (an f32
    # running count merges slots past 2**24 tokens an expert)
    ionehot = onehot.to(torch.int64)
    position = (torch.cumsum(ionehot, dim=0) * ionehot - ionehot).sum(dim=-1)   # (T,)
    keep = position < capacity
    gate = gate * keep

    # the Switch aux loss, before the drop: it penalizes the router's intent
    aux_loss = c.n_experts * (onehot.mean(dim=0) * probs.mean(dim=0)).sum()

    # dense (T, E, C) dispatch and combine; a dropped token's slot index is
    # `capacity`, whose one-hot column is cut away (all zeros, as
    # jax.nn.one_hot gives for an index out of range)
    slot = F.one_hot(torch.where(keep, position, capacity), capacity + 1)[:, :capacity].float()
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
    combine = dispatch * gate[:, None, None]

    dtype = c.dtype
    expert_in = torch.einsum('tec,td->ecd', dispatch.to(dtype), tokens.to(dtype))
    h = torch.matmul(expert_in, w_in.to(dtype)).float()
    h = F.gelu(h, approximate='tanh').to(dtype)
    expert_out = torch.matmul(h, w_out.to(dtype)).float()
    y = torch.einsum('tec,ecd->td', combine, expert_out)
    return y.reshape(lead_shape + (c.d_model,)).to(x.dtype), aux_loss


def dense_oracle(layer, x, config):
    """Loop-based semantics oracle for tests: every token goes to its argmax
    expert with NO capacity bound; gate-weighted expert MLP, in f32 numpy
    (gelu's tanh approximation through torch)."""
    c = config
    router, w_in, w_out = (w.detach().cpu().numpy()
                           for w in (layer.router, layer.w_in, layer.w_out))
    x = np.asarray(torch.as_tensor(x).detach().cpu(), np.float32)
    lead_shape = x.shape[:-1]
    tokens = x.reshape(-1, c.d_model)
    logits = tokens @ router
    e_x = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e_x / e_x.sum(axis=-1, keepdims=True)
    out = np.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        e = int(np.argmax(probs[t]))
        h = F.gelu(torch.from_numpy(tokens[t] @ w_in[e]), approximate='tanh').numpy()
        out[t] = probs[t, e] * (h @ w_out[e])
    return out.reshape(lead_shape + (c.d_model,))

