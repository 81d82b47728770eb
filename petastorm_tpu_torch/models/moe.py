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

Across ranks (``mesh=``, a :mod:`petastorm_tpu_torch.parallel.mesh` mesh)
the experts split over the mesh dim ``axis`` (``'expert'``), as the JAX
package's ``moe_param_specs`` shards them: rank ``r`` of ``ep`` holds
experts ``[r·E/ep, (r+1)·E/ep)`` of ``w_in`` and ``w_out`` and the whole
router. Every expert rank routes the same tokens, runs the dispatch,
expert MLP and combine for its own experts, and the partial outputs sum
over the dim (the Megatron pair of
:mod:`petastorm_tpu_torch.parallel.collectives` around that path only, so
the router's and the input's gradients count each expert once).

The tokens that share one capacity budget and one set of aux statistics
are the ones the JAX function sees as one array. When that array is split
over ranks (a :class:`TokenSplit`: rows over ``'data'``, positions over
the sequence dim) the capacity comes from its global token count, a
token's queue position adds the count of earlier tokens of its expert on
the other ranks (gathered as small per-row integer counts), and the aux
statistics sum over the ranks before their product: every rank gets the
global array's routing and aux loss. ``moe_forward(seq_axis=)`` is the
reference's manual-axis form: routing local to each sequence shard, the
statistics summed over the shards.
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel.collectives import (
    all_reduce, copy_to_model, reduce_from_model, size_and_rank,
)
from petastorm_tpu_torch.parallel.mesh import EXPERT_AXIS, axis as mesh_axis


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 64
    d_ff: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: object = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """How the token array that routes as one lies over ranks.

    ``rows``: the group whose ranks hold consecutive blocks of its rows
    (``'data'``, in equal blocks unless ``members`` is set).
    ``members`` and ``rows_total``: a pipeline microbatch of
    ``rows_total`` rows held, unequally, by the ranks at ``members`` of
    that group; every rank of it joins the collectives, one outside
    ``members`` with no rows. ``positions``: the group whose ranks hold
    consecutive blocks of every row's positions (the sequence dim), routed
    together. ``stats``: a group over which only the aux statistics sum,
    routing staying local to each rank (the reference's manual
    ``seq_axis``). None everywhere: the array is this rank's own."""
    rows: object = None
    members: Optional[Tuple[int, ...]] = None
    positions: object = None
    stats: object = None
    rows_total: Optional[int] = None


class MoE(nn.Module):
    """The JAX layer's parameters as an ``nn.Module``: ``router``
    ``(d_model, E)``, ``w_in`` ``(E, d_model, d_ff)`` and ``w_out``
    ``(E, d_ff, d_model)``, f32. With a ``mesh`` whose dim ``axis`` has
    ``ep`` ranks, ``w_in`` and ``w_out`` hold this rank's ``E / ep``
    experts (``E % ep != 0`` raises ``ValueError``, as the reference's
    even sharding does)."""

    def __init__(self, config, mesh=None, axis=EXPERT_AXIS):
        super().__init__()
        c = config
        self.mesh = mesh
        self.group, self.ep, self.ep_rank = mesh_axis(mesh, axis)
        if c.n_experts % self.ep:
            raise ValueError('n_experts=%d does not split over the %d ranks of mesh dim %r'
                             % (c.n_experts, self.ep, axis))
        self.n_local = c.n_experts // self.ep
        self.expert_lo = self.ep_rank * self.n_local
        self.router = nn.Parameter(torch.empty((c.d_model, c.n_experts)))
        self.w_in = nn.Parameter(torch.empty((self.n_local, c.d_model, c.d_ff)))
        self.w_out = nn.Parameter(torch.empty((self.n_local, c.d_ff, c.d_model)))
        self._shapes = ((c.d_model, c.n_experts), (c.n_experts, c.d_model, c.d_ff),
                        (c.n_experts, c.d_ff, c.d_model))
        self._scales = (c.d_model ** -0.5, c.d_model ** -0.5, c.d_ff ** -0.5)

    def shard(self, name, full):
        """This rank's part of the full parameter ``name`` (see
        :func:`expert_shard`)."""
        return expert_shard(name, full, self.ep, self.ep_rank)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Normal draws from ``generator`` at the JAX init's scales:
        ``d_model**-0.5`` for the router and ``w_in``, ``d_ff**-0.5`` for
        ``w_out``. Each draw is of all the experts, so a rank holds its
        slice of the unsplit layer's weights."""
        for name, shape, scale in zip(('router', 'w_in', 'w_out'), self._shapes,
                                      self._scales):
            full = torch.randn(shape, generator=generator) * scale
            getattr(self, name).copy_(self.shard(name, full))


def expert_shard(name, full, ep, rank):
    """The part of the full MoE parameter ``name`` (a ``state_dict`` key)
    that rank ``rank`` of ``ep`` expert ranks holds: ``w_in`` and
    ``w_out`` by expert, the router whole."""
    if ep > 1 and name.rsplit('.', 1)[-1] in ('w_in', 'w_out'):
        n = full.shape[0] // ep
        return full[rank * n:(rank + 1) * n].contiguous()
    return full


def init_moe(seed, config, device=None, mesh=None, axis=EXPERT_AXIS):
    """An :class:`MoE` with weights drawn from a CPU ``torch.Generator``
    seeded ``seed``, on ``device`` (``None`` means the card); with a
    ``mesh``, this rank's experts of those weights."""
    layer = MoE(config, mesh, axis)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return layer.to(torch.device('cuda' if device is None else device))


def expert_capacity(n_tokens, n_experts, capacity_factor):
    """Static per-expert token budget (ceil of the uniform share x factor)."""
    return max(1, int(np.ceil(n_tokens / n_experts * capacity_factor)))


def _split_sum(t, group, members=None):
    """``t`` summed over ``group`` (over the ranks at ``members`` of it when
    set), from a table of every rank's ``t``; the backward is the
    identity, each rank's gradient its own part."""
    n, me = size_and_rank(group)
    table = torch.zeros((n,) + t.shape, dtype=t.dtype, device=t.device)
    table[me] = t.detach()
    table = all_reduce(table, group, name='moe_stats')
    total = (table if members is None else table[list(members)]).sum(0)
    return total + (t - t.detach())


def _queue_positions(ionehot, n_rows, split):
    """Each token's place in its expert's queue over the whole routed
    array: its place among this rank's tokens of its row, plus the tokens
    of its expert that come earlier in the array's row-major order (earlier
    rows anywhere, earlier position blocks of its own row), counted from
    every rank's per-row, per-expert integer counts."""
    e = ionehot.shape[-1]
    per_row = ionehot.reshape(n_rows, -1, e)
    within = torch.cumsum(per_row, dim=1) - per_row
    n_r, r = size_and_rank(split.rows)
    n_p, p = size_and_rank(split.positions)
    table = torch.zeros((n_r, n_rows, n_p, e), dtype=ionehot.dtype, device=ionehot.device)
    table[r, :, p] = per_row.sum(dim=1)
    table = all_reduce(all_reduce(table, split.positions, name='moe_counts'), split.rows,
                       name='moe_counts')
    if split.members is not None:
        # a rank outside the members has no tokens: any index will do
        r = split.members.index(r) if r in split.members else 0
        table = table[list(split.members)]
    before = torch.cumsum(table.reshape(-1, e), dim=0).reshape(table.shape) - table
    position = within + before[r, :, p][:, None, :]
    return (position * per_row).sum(dim=-1).reshape(-1)


def _routed_tokens(split, lead_shape):
    """The token count of the whole routed array ``x`` (``lead_shape``
    ``x.shape[:-1]``) is this rank's part of."""
    if split.members is not None:
        tokens = split.rows_total * int(np.prod(lead_shape[1:]))
    else:
        tokens = int(np.prod(lead_shape)) * size_and_rank(split.rows)[0]
    return tokens * size_and_rank(split.positions)[0]


def moe_forward(layer, x, config, capacity=None, seq_axis=None, mesh=None, split=None):
    """Apply the MoE layer (the JAX version's ``params`` are the
    :class:`MoE` ``layer``'s parameters).

    :param x: ``(..., d_model)`` activations; leading axes are flattened
        into a token axis for routing and restored on return.
    :param capacity: per-expert token slots (default from
        :func:`expert_capacity` of the routed array's token count).
    :param seq_axis: a mesh dim (of ``mesh``, default the layer's) whose
        ranks each hold a block of the sequence: routing and the capacity
        stay local to each shard's tokens and the aux statistics sum over
        the shards before their product, as the reference does inside its
        manual region.
    :param split: a :class:`TokenSplit` when ``x`` is this rank's part of
        an array that routes as one (the layered transformer's global
        batch); ``x`` is then ``(rows, positions, d_model)`` when the
        positions are split.
    :return: ``(y, aux_loss)``: ``y`` shaped like ``x`` in its dtype,
        ``aux_loss`` the scalar f32 Switch load-balancing loss of the
        routed array, the same on every rank that shares it.
    """
    c = config
    split = split or TokenSplit()
    if seq_axis is not None:
        seq_mesh = mesh if mesh is not None else layer.mesh
        if seq_mesh is None:
            raise ValueError('moe_forward(seq_axis=%r) needs the mesh (the layer\'s or '
                             'mesh=)' % (seq_axis,))
        split = dataclasses.replace(split, stats=mesh_axis(seq_mesh, seq_axis)[0])
    router, w_in, w_out = layer.router, layer.w_in, layer.w_out
    lead_shape = x.shape[:-1]
    tokens = x.reshape(-1, c.d_model)
    n_tokens = _routed_tokens(split, lead_shape)
    if capacity is None:
        capacity = expert_capacity(n_tokens, c.n_experts, c.capacity_factor)

    # routing, in f32: a router decision must not flip in bf16
    probs = torch.softmax(torch.matmul(tokens.float(), router.float()), dim=-1)  # (T, E)
    onehot = F.one_hot(probs.argmax(dim=-1), c.n_experts).float()
    # the gate through the one-hot contraction, as the JAX layer takes it
    gate = (probs * onehot).sum(dim=-1)                                         # (T,)
    # each token's place in its expert's queue, counted in integers (an f32
    # running count merges slots past 2**24 tokens an expert)
    ionehot = onehot.to(torch.int64)
    n_rows = int(np.prod(lead_shape[:-1])) if split.positions is not None else 1
    position = _queue_positions(ionehot, n_rows, split)                         # (T,)
    keep = position < capacity
    gate = gate * keep

    # the Switch aux loss, before the drop: it penalizes the router's intent;
    # the fraction and mean probability of the whole array, summed over its
    # ranks before the product
    stats = torch.stack([onehot.sum(dim=0), probs.sum(dim=0)])
    for group, members in ((split.positions, None), (split.rows, split.members),
                           (split.stats, None)):
        stats = _split_sum(stats, group, members)
    fraction, mean_prob = (stats / (n_tokens * size_and_rank(split.stats)[0])).unbind()
    aux_loss = c.n_experts * (fraction * mean_prob).sum()

    # dense (T, E_local, C) dispatch and combine for this rank's experts; a
    # dropped token's slot index is `capacity`, whose one-hot column is cut
    # away (all zeros, as jax.nn.one_hot gives for an index out of range)
    if layer.ep > 1:
        # the expert path is this rank's part: its input's gradient sums
        # over the expert ranks, its output sums in the forward
        tokens = copy_to_model(tokens, layer.group)
        gate = copy_to_model(gate, layer.group)
    local = onehot[:, layer.expert_lo:layer.expert_lo + layer.n_local]
    slot = F.one_hot(torch.where(keep, position, capacity), capacity + 1)[:, :capacity].float()
    dispatch = local[:, :, None] * slot[:, None, :] * keep[:, None, None]
    combine = dispatch * gate[:, None, None]

    dtype = c.dtype
    expert_in = torch.einsum('tec,td->ecd', dispatch.to(dtype), tokens.to(dtype))
    h = torch.matmul(expert_in, w_in.to(dtype)).float()
    h = F.gelu(h, approximate='tanh').to(dtype)
    expert_out = torch.matmul(h, w_out.to(dtype)).float()
    y = reduce_from_model(torch.einsum('tec,ecd->td', combine, expert_out), layer.group)
    return y.reshape(lead_shape + (c.d_model,)).to(x.dtype), aux_loss


def dense_oracle(layer, x, config):
    """Loop-based semantics oracle for tests: every token goes to its argmax
    expert with NO capacity bound; gate-weighted expert MLP, in f32 numpy
    (gelu's tanh approximation through torch). On an expert-split layer it
    gives this rank's experts' share: the shares sum to the whole layer's
    output."""
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
    lo = layer.expert_lo
    for t in range(tokens.shape[0]):
        e = int(np.argmax(probs[t]))
        if not lo <= e < lo + w_in.shape[0]:
            continue
        h = F.gelu(torch.from_numpy(tokens[t] @ w_in[e - lo]), approximate='tanh').numpy()
        out[t] = probs[t, e] * (h @ w_out[e - lo])
    return out.reshape(lead_shape + (c.d_model,))
