"""Decoder-only transformer LM: the port's LM consumer.

Counterpart of the layered dense model in ``petastorm_tpu/models/transformer.py``:
the same config fields and checks, the same parameter tree in the same
``(d_in, d_out)`` weight layout (f32 parameters, cast to ``config.dtype``
for each matmul), pre-norm RMSNorm blocks, learned or rotary positions,
grouped-query attention, gelu or swiglu FFNs, rematerialization and the
chunked next-token loss. Attention is ``'dense'`` (plain torch) or
``'flash'`` (:func:`petastorm_tpu_torch.ops.flash_attention.flash_attention_fused`,
the hand-written kernels on the card). The large matmuls are
``torch.matmul`` in ``config.dtype`` (bf16 with f32 accumulation on the
card), as the JAX package leaves them to XLA; norms, softmax and the loss
run in f32.

Weights carry across from the JAX package with :func:`params_from_jax`.
:func:`transformer_masked_loss` trains on the loader's padded or bucketed
batches. ``n_experts > 0`` swaps every block's dense FFN for a Switch-MoE
layer (:mod:`petastorm_tpu_torch.models.moe`) whose aux loss joins the
train loss; decoding is :mod:`petastorm_tpu_torch.models.generate`.

Across ranks (``init_transformer(mesh=)``, a
:mod:`petastorm_tpu_torch.parallel.mesh` mesh) each rank holds its shards
of the JAX package's Megatron layout (``_param_specs`` in
``petastorm_tpu/models/transformer.py``): over ``'model'``, ``qkv`` is
split by head (each rank's query heads and the K/V heads they read),
``attn_out`` by the same heads' rows, ``mlp_in``/``mlp_gate`` by columns,
``mlp_out`` by rows and ``lm_head`` by vocabulary; ``embed``,
``pos_embed`` and the norm gains are replicated, as is every weight over a
dim the mesh lacks. ``config.seq_axis`` splits the sequence over that
mesh dim and runs attention through ring or Ulysses attention. An MoE block's
experts split over ``config.expert_axis`` (``'expert'``), and its routing
runs over the whole global batch (:class:`~petastorm_tpu_torch.models.moe.TokenSplit`).

The pipelined transformer (:func:`init_pipelined_transformer`) holds one
stage's blocks on each rank of ``'pipe'`` and runs them as a GPipe
pipeline (:mod:`petastorm_tpu_torch.parallel.pipeline`); the embedding and
the head run on every stage. It composes with ``'model'``, ``'expert'``,
``'data'`` and ``config.seq_axis`` as the layered model does.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.parallel.collectives import (
    all_reduce, copy_to_model, reduce_from_model,
)
from petastorm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PIPE_AXIS, axis,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq_len: int = 128
    dtype: object = torch.bfloat16
    # n_experts > 0 swaps every block's dense FFN for a Switch-MoE layer;
    # its aux loss joins the train loss weighted by moe_aux_weight; the
    # experts split over the mesh dim expert_axis.
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    expert_axis: str = 'expert'
    # sequence parallelism: a mesh dim name (e.g. 'seq') splits the
    # sequence of every activation over that dim of the model's mesh, and
    # attention runs through seq_impl: 'ring' (K/V blocks passed round the
    # ring; any head count) or 'ulysses' (all-to-all head split; needs
    # n_heads % n_seq_shards == 0). As in the JAX package, attn_impl is
    # ignored then: ring and Ulysses own the split-sequence case.
    seq_axis: Optional[str] = None
    seq_impl: str = 'ring'
    # 'dense' materializes the (B, H, S, S) scores; 'flash' runs the fused
    # kernels (plain versions on CPU tensors)
    attn_impl: str = 'dense'
    # grouped-query attention: n_kv_heads < n_heads shares each K/V head
    # across n_heads // n_kv_heads query heads; None means n_heads
    n_kv_heads: Optional[int] = None
    # 'learned' (a (max_seq_len, d_model) table) or 'rope' (GPT-NeoX
    # split-half rotation of q/k)
    pos_encoding: str = 'learned'
    rope_theta: float = 10000.0
    # 'gelu' (tanh approximation, as jax.nn.gelu) or 'swiglu' (an extra
    # (d_model, d_ff) gate matrix)
    ffn: str = 'gelu'
    # recompute every block in the backward (torch.utils.checkpoint)
    remat: bool = False
    # N > 0: head matmul + cross-entropy in position chunks of N, each
    # recomputed in the backward, so the (B, S, V) logits never exist
    loss_chunk: int = 0

    def __post_init__(self):
        if self.seq_impl not in ('ring', 'ulysses'):
            raise ValueError("seq_impl must be 'ring' or 'ulysses'; got %r"
                             % (self.seq_impl,))
        if self.attn_impl not in ('dense', 'flash'):
            raise ValueError("attn_impl must be 'dense' or 'flash'; got %r"
                             % (self.attn_impl,))
        if self.n_kv_heads is not None:
            if not 1 <= self.n_kv_heads <= self.n_heads:
                raise ValueError('n_kv_heads must be in [1, n_heads=%d]; got %r'
                                 % (self.n_heads, self.n_kv_heads))
            if self.n_heads % self.n_kv_heads != 0:
                raise ValueError('n_heads (%d) must be a multiple of n_kv_heads (%d)'
                                 % (self.n_heads, self.n_kv_heads))
        if self.pos_encoding not in ('learned', 'rope'):
            raise ValueError("pos_encoding must be 'learned' or 'rope'; got %r"
                             % (self.pos_encoding,))
        if self.pos_encoding == 'rope' and (self.d_model // self.n_heads) % 2 != 0:
            raise ValueError('rope needs an even head_dim; got %d'
                             % (self.d_model // self.n_heads))
        if self.ffn not in ('gelu', 'swiglu'):
            raise ValueError("ffn must be 'gelu' or 'swiglu'; got %r" % (self.ffn,))
        if self.ffn != 'gelu' and self.n_experts > 0:
            raise ValueError('ffn=%r applies to dense blocks only; MoE configs '
                             '(n_experts > 0) own their expert FFN' % (self.ffn,))

    @property
    def kv_heads(self):
        """Effective K/V head count (n_kv_heads, defaulting to n_heads)."""
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    def moe_config(self):
        from petastorm_tpu_torch.models.moe import MoEConfig
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
                         capacity_factor=self.capacity_factor, dtype=self.dtype)


def _param(*shape):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32))


class Parallel:
    """How one rank's model splits over a mesh (``mesh=None``: not at all).

    Over ``'model'`` (``tp`` ranks) the attention splits by head when
    ``n_heads % tp == 0``: rank r holds query heads ``[r·H/tp, (r+1)·H/tp)``
    and the K/V heads those queries read. When ``kv_heads % tp != 0`` (GQA
    with fewer K/V heads than ranks, or groups that straddle two ranks) a
    K/V head is held by every rank that reads it, and :meth:`sync_grads`
    sums its gradient over them. When ``n_heads % tp != 0`` the attention
    is replicated. The FFN splits its hidden width and the head its
    vocabulary; both must divide by ``tp``, as the JAX package's even
    shardings must. ``config.seq_axis`` names the mesh dim the sequence
    splits over, ``'data'`` the one the batch splits over. An MoE block's
    experts split over ``config.expert_axis`` (``ep`` ranks; ``n_experts``
    must divide over them). ``pipe_axis`` (the pipelined model only) names
    the dim whose ranks each hold one stage; a layered model is replicated
    over a ``'pipe'`` dim, as the reference's specs replicate over an axis
    they do not name. ``head=False`` (the ViT's blocks) leaves the LM head
    out of the checks."""

    def __init__(self, config, mesh=None, head=True, pipe_axis=None):
        from petastorm_tpu_torch.models.moe import TokenSplit
        c = config
        self.mesh = mesh
        self.seq_axis = c.seq_axis
        self.model_group, self.tp, self.tp_rank = axis(mesh, MODEL_AXIS)
        self.data_group, self.dp, self.dp_rank = axis(mesh, DATA_AXIS)
        self.expert_group, self.ep, self.ep_rank = (
            axis(mesh, c.expert_axis) if c.n_experts > 0 else (None, 1, 0))
        if c.n_experts % self.ep:
            raise ValueError('n_experts=%d does not split over the %d ranks of mesh dim %r'
                             % (c.n_experts, self.ep, c.expert_axis))
        self.pipe_axis = pipe_axis
        self.pipe_group, self.pp, self.stage = (
            axis(mesh, pipe_axis) if pipe_axis is not None else (None, 1, 0))
        self.seq_group, self.seq_size, self.seq_rank = (
            axis(mesh, c.seq_axis) if c.seq_axis is not None else (None, 1, 0))
        self.batch_axis = DATA_AXIS if self.dp > 1 else None
        # the layered forward routes the global batch as one array
        self.moe_split = TokenSplit(rows=self.data_group if self.dp > 1 else None,
                                    positions=self.seq_group)
        tp, r = self.tp, self.tp_rank
        if tp > 1:
            if c.d_ff % tp:
                raise ValueError('d_ff=%d does not split over the %d ranks of mesh dim %r'
                                 % (c.d_ff, tp, MODEL_AXIS))
            if head and c.vocab_size % tp:
                raise ValueError('vocab_size=%d does not split over the %d ranks of mesh '
                                 'dim %r' % (c.vocab_size, tp, MODEL_AXIS))
        self.split_heads = tp > 1 and c.n_heads % tp == 0
        self.head_dim = hd = c.d_model // c.n_heads
        self.heads = c.n_heads // tp if self.split_heads else c.n_heads
        q0 = r * self.heads if self.split_heads else 0
        group = c.n_heads // c.kv_heads
        self.kv_lo = q0 // group
        self.kv_heads = (q0 + self.heads - 1) // group + 1 - self.kv_lo
        self.kv_total = c.kv_heads
        self.kv_shared = self.split_heads and c.kv_heads % tp != 0
        # local query head j reads local K/V head kv_index[j]; None leaves
        # it to the unsplit model's expansion (_expand_kv_heads)
        index = [(q0 + j) // group - self.kv_lo for j in range(self.heads)]
        self.kv_index = (index if self.split_heads and index != list(range(self.heads))
                         else None)
        # the fused qkv's columns this rank holds: its q heads, then its K/V
        # heads in the K part and in the V part
        kv_cols = range(self.kv_lo * hd, (self.kv_lo + self.kv_heads) * hd)
        self._qkv_cols = (list(range(q0 * hd, (q0 + self.heads) * hd))
                          + [(c.n_heads + part * c.kv_heads) * hd + i
                             for part in (0, 1) for i in kv_cols])
        self._head_rows = slice(q0 * hd, (q0 + self.heads) * hd)
        ff = c.d_ff // tp
        self._ff = slice(r * ff, (r + 1) * ff)
        vocab = c.vocab_size // tp
        self.vocab_start = r * vocab
        self._vocab = slice(r * vocab, (r + 1) * vocab)

    @property
    def holds_shards(self):
        """Whether this rank's parameters differ from another rank's (a
        split over ``'model'`` or ``'expert'``, or a pipeline stage)."""
        return self.tp > 1 or self.ep > 1 or self.pp > 1

    def shard(self, name, full):
        """This rank's part of the full-width parameter ``name`` (a
        ``state_dict`` key)."""
        leaf = name.rsplit('.', 1)[-1]
        if leaf in ('w_in', 'w_out'):
            from petastorm_tpu_torch.models.moe import expert_shard
            return expert_shard(name, full, self.ep, self.ep_rank)
        if self.split_heads and leaf == 'qkv':
            return full[:, self._qkv_cols].contiguous()
        if self.split_heads and leaf == 'attn_out':
            return full[self._head_rows].contiguous()
        if self.tp > 1 and leaf in ('mlp_in', 'mlp_gate'):
            return full[:, self._ff].contiguous()
        if self.tp > 1 and leaf == 'mlp_out':
            return full[self._ff].contiguous()
        if self.tp > 1 and leaf == 'lm_head':
            return full[:, self._vocab].contiguous()
        return full

    def seq_slice(self, t):
        """This rank's block of ``t``'s dim 1 (the sequence), or ``t``
        itself when the sequence is not split."""
        if self.seq_group is None:
            return t
        s = t.shape[1]
        if s % self.seq_size:
            raise ValueError('sequence length %d does not split over the %d ranks of mesh '
                             'dim %r' % (s, self.seq_size, self.seq_axis))
        n = s // self.seq_size
        return t[:, self.seq_rank * n:(self.seq_rank + 1) * n]

    @torch.no_grad()
    def sync_grads(self, model):
        """Make each rank's gradients its shards of the global loss's: a K/V
        head held by several ranks sums its gradient over them, and every
        gradient sums over ``'data'`` and the sequence dim (each rank's
        loss is the global one, its backward only its own rows' and
        positions' part, see :meth:`batch_sum`). Nothing sums over
        ``'expert'`` or ``'pipe'``: an expert shard's gradient is whole on
        its rank, and so is a replicated weight's (the expert path sums its
        input's gradient itself, the pipeline hands the batch's gradient
        to every stage)."""
        if self.kv_shared:
            self._sum_shared_kv(model.blocks)
        if self.seq_group is None and self.dp == 1:
            return
        params = list(model.parameters())
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        flat = all_reduce(all_reduce(flat, self.seq_group, name='grad_sync'),
                          self.data_group, name='grad_sync')
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).clone()
            offset += p.numel()

    def _sum_shared_kv(self, blocks):
        """Sum the K and V columns' gradients over the ranks that hold
        them: each rank writes its columns into zeros of the full K/V width,
        one all-reduce over ``'model'`` adds them, and each reads its own
        back."""
        hd = self.head_dim
        q_w, width, lo = self.heads * hd, self.kv_heads * hd, self.kv_lo * hd
        first = blocks[0].qkv
        buf = torch.zeros((len(blocks), 2, first.shape[0], self.kv_total * hd),
                          dtype=first.grad.dtype, device=first.device)
        for i, block in enumerate(blocks):
            for part in (0, 1):
                start = q_w + part * width
                buf[i, part, :, lo:lo + width] = block.qkv.grad[:, start:start + width]
        buf = all_reduce(buf, self.model_group, name='grad_sync')
        for i, block in enumerate(blocks):
            for part in (0, 1):
                start = q_w + part * width
                block.qkv.grad[:, start:start + width] = buf[i, part, :, lo:lo + width]

    def batch_sum(self, t):
        """``t`` summed over the ranks that hold the batch's other rows
        (``'data'``) and positions (``config.seq_axis``). The backward is the
        identity: each rank's gradient is its own rows' and positions' part,
        and :meth:`sync_grads` sums the parts."""
        return reduce_from_model(reduce_from_model(t, self.seq_group), self.data_group)


class _Block(nn.Module):
    def __init__(self, c, par):
        super().__init__()
        hd = c.d_model // c.n_heads
        self.qkv = _param(c.d_model, (par.heads + 2 * par.kv_heads) * hd)
        self.attn_out = _param(par.heads * hd, c.d_model)
        self.ln1 = _param(c.d_model)
        self.ln2 = _param(c.d_model)
        if c.n_experts > 0:
            from petastorm_tpu_torch.models.moe import MoE
            self.moe = MoE(c.moe_config(), par.mesh, c.expert_axis)
            return
        ff = c.d_ff // par.tp
        self.mlp_in = _param(c.d_model, ff)
        if c.ffn == 'swiglu':
            self.mlp_gate = _param(c.d_model, ff)
        self.mlp_out = _param(ff, c.d_model)


@torch.no_grad()
def reset_block(block, c, generator, par):
    """A block's weights as the JAX init scales them (``fan_in**-0.5``
    normals, norm gains of one), drawn from ``generator`` at full width
    and cut to this rank's shards by ``par`` (a :class:`Parallel`)."""
    hd = c.d_model // c.n_heads

    def normal(name, full_shape, scale):
        full = torch.randn(full_shape, generator=generator) * scale
        getattr(block, name).copy_(par.shard(name, full))

    normal('qkv', (c.d_model, (c.n_heads + 2 * c.kv_heads) * hd), c.d_model ** -0.5)
    normal('attn_out', (c.d_model, c.d_model), c.d_model ** -0.5)
    block.ln1.fill_(1.0)
    block.ln2.fill_(1.0)
    if c.n_experts > 0:
        block.moe.reset_parameters(generator)
        return
    normal('mlp_in', (c.d_model, c.d_ff), c.d_model ** -0.5)
    if c.ffn == 'swiglu':
        normal('mlp_gate', (c.d_model, c.d_ff), c.d_model ** -0.5)
    normal('mlp_out', (c.d_ff, c.d_model), c.d_ff ** -0.5)


class Transformer(nn.Module):
    """The JAX model's parameter tree as an ``nn.Module``: ``embed``,
    ``pos_embed`` (learned positions only), ``lm_head``, ``ln_f`` and
    ``blocks.<i>.{qkv, attn_out, ln1, ln2, mlp_in, mlp_gate, mlp_out}``,
    with ``blocks.<i>.moe.{router, w_in, w_out}`` in place of the dense
    FFN's matrices when ``n_experts > 0``. With a ``mesh`` each parameter
    is this rank's shard (see :class:`Parallel`, ``model.parallel``)."""

    def __init__(self, config, mesh=None, pipe_axis=None):
        super().__init__()
        c = self.config = config
        self.parallel = par = Parallel(config, mesh, pipe_axis=pipe_axis)
        if c.n_layers % par.pp:
            raise ValueError('n_layers=%d not divisible into %d pipeline stages'
                             % (c.n_layers, par.pp))
        # a pipeline stage holds layers [first_layer, first_layer + len(blocks))
        n_blocks = c.n_layers // par.pp
        self.first_layer = par.stage * n_blocks
        self.embed = _param(c.vocab_size, c.d_model)
        if c.pos_encoding == 'learned':
            self.pos_embed = _param(c.max_seq_len, c.d_model)
        self.lm_head = _param(c.d_model, c.vocab_size // par.tp)
        self.ln_f = _param(c.d_model)
        self.blocks = nn.ModuleList(_Block(c, par) for _ in range(n_blocks))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Normal draws from ``generator`` in the JAX init's order and
        scales (0.02 for tables and the head, ``fan_in**-0.5`` for block
        matrices); norm gains are ones. Each draw is full width, so a rank
        of a split model holds its shards of the unsplit model's weights."""
        c = self.config

        def normal(p, scale):
            p.copy_(torch.randn(p.shape, generator=generator) * scale)

        normal(self.embed, 0.02)
        if c.pos_encoding == 'learned':
            normal(self.pos_embed, 0.02)
        self.lm_head.copy_(self.parallel.shard('lm_head', torch.randn(
            (c.d_model, c.vocab_size), generator=generator) * 0.02))
        self.ln_f.fill_(1.0)
        other_stage = None
        for layer in range(c.n_layers):
            index = layer - self.first_layer
            if 0 <= index < len(self.blocks):
                block = self.blocks[index]
            else:
                # another stage's layer: drawn all the same, so the
                # generator's sequence is the unsplit model's
                if other_stage is None:
                    other_stage = _Block(c, self.parallel)
                block = other_stage
            reset_block(block, c, generator, self.parallel)

    def forward(self, tokens):
        """tokens ``(B, S)`` int → logits ``(B, S, V)`` f32."""
        return transformer_forward(self, tokens)


def init_transformer(seed, config, device=None, mesh=None):
    """A :class:`Transformer` with weights drawn from a CPU
    ``torch.Generator`` seeded ``seed`` (the same weights on every
    device), on ``device`` (``None`` means the card). With a ``mesh``
    (:mod:`petastorm_tpu_torch.parallel.mesh`) the model holds this rank's
    shards of those weights, cut from the full-width draws."""
    device = torch.device('cuda' if device is None else device)
    model = Transformer(config, mesh)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


class PipelinedTransformer(Transformer):
    """The pipelined model's parameters on one rank of ``pipe_axis``:
    ``embed``, ``pos_embed``, ``lm_head`` and ``ln_f`` as the layered
    model's (on every stage), and ``blocks`` this stage's ``n_layers /
    n_stages`` blocks (``blocks.<i>`` is layer ``first_layer + i``), each
    with its ``'model'`` and ``'expert'`` shards."""

    def __init__(self, config, mesh, pipe_axis=None):
        super().__init__(config, mesh, pipe_axis=PIPE_AXIS if pipe_axis is None else pipe_axis)

    def forward(self, tokens):
        """tokens ``(B, S)`` int → logits, through the pipeline."""
        return pipelined_transformer_forward(self, tokens)


def params_from_jax(params, mesh=None, config=None):
    """A :class:`Transformer` ``state_dict`` from the JAX model's parameter
    pytree (numpy arrays): the same names and layouts, as f32 tensors; a
    nested dict (an MoE block's ``moe``) joins its names with dots. With a
    ``mesh`` (and the ``config``, which says how the heads split) each
    entry is this rank's shard of the full array."""
    state = {}
    for name in ('embed', 'pos_embed', 'lm_head', 'ln_f'):
        if name in params:
            state[name] = torch.tensor(np.asarray(params[name], np.float32))

    def add(prefix, tree):
        for name, value in tree.items():
            if isinstance(value, dict):
                add('%s%s.' % (prefix, name), value)
            else:
                state[prefix + name] = torch.tensor(np.asarray(value, np.float32))

    for i, block in enumerate(params['blocks']):
        add('blocks.%d.' % i, block)
    return shard_state(state, mesh, config)


def shard_state(state, mesh, config, head=True, pipe_axis=None):
    """Each full-width entry of ``state`` cut to this rank's shard of
    ``mesh`` (``state`` itself without a mesh)."""
    if mesh is None:
        return state
    if config is None:
        raise ValueError('splitting weights over a mesh needs the model config '
                         '(it says how the heads split)')
    par = Parallel(config, mesh, head=head, pipe_axis=pipe_axis)
    return {name: par.shard(name, value) for name, value in state.items()}


def pipelined_params_from_jax(params, mesh, config, pipe_axis=None):
    """A :class:`PipelinedTransformer` ``state_dict`` for this rank from
    the JAX pipelined model's parameters: its ``stages`` tree (leaves
    ``(n_stages, per_stage, ...)``) read at this rank's stage, each block
    cut to its ``'model'`` and ``'expert'`` shards, and the embedding,
    positions, norm and head as :func:`params_from_jax` reads them."""
    pipe_axis = PIPE_AXIS if pipe_axis is None else pipe_axis
    stage = axis(mesh, pipe_axis)[2]

    def layer(tree, i):
        return {name: layer(value, i) if isinstance(value, dict)
                else np.asarray(value)[stage, i] for name, value in tree.items()}

    stages = params['stages']
    per_stage = next(iter(stages.values())).shape[1]
    layered = {name: value for name, value in params.items() if name != 'stages'}
    layered['blocks'] = [layer(stages, i) for i in range(per_stage)]
    return shard_state(params_from_jax(layered), mesh, config, pipe_axis=pipe_axis)


def _matmul(x, w, dtype):
    return torch.matmul(x, w.to(dtype))


def _rmsnorm(x, gain):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * gain).to(x.dtype)


def _split_qkv(qkv, n_heads, kv_heads, head_dim):
    """Split the fused projection ``(…, (H + 2·KV)·Dh)`` into q ``(…, H·Dh)``
    and k, v ``(…, KV·Dh)``, as views."""
    q_w = n_heads * head_dim
    kv_w = kv_heads * head_dim
    return qkv[..., :q_w], qkv[..., q_w:q_w + kv_w], qkv[..., q_w + kv_w:]


def _rope_rotate(t_bshd, positions, theta):
    """Rotary position embedding (GPT-NeoX split-half): rotate each
    head-dim pair ``(i, i + Dh/2)`` of ``t`` ``(B, S, H, Dh)`` by
    ``positions``-dependent angles, in f32."""
    half = t_bshd.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=t_bshd.device) / half)
    angles = positions.float()[:, None] * freqs
    cos = angles.cos()[None, :, None, :]
    sin = angles.sin()[None, :, None, :]
    t1 = t_bshd[..., :half].float()
    t2 = t_bshd[..., half:].float()
    return torch.cat([t1 * cos - t2 * sin, t1 * sin + t2 * cos], dim=-1).to(t_bshd.dtype)


def _expand_kv_heads(t_bshd, n_heads):
    """``(B, S, KV, Dh)`` → ``(B, S, H, Dh)``: repeat each shared K/V head
    across its query-head group."""
    kv = t_bshd.shape[2]
    if kv == n_heads:
        return t_bshd
    return t_bshd.repeat_interleave(n_heads // kv, dim=2)


def _reduce_partial(out, par, dtype):
    """A row-split matmul's partial product summed over ``'model'`` (in
    f32), then in ``dtype``."""
    return reduce_from_model(out.float(), par.model_group).to(dtype)


def _attention(x, qkv_w, out_w, config, par, causal=True):
    """Pre-projected attention of one block on this rank's heads (all of
    them unsplit). The sequence-split case (``config.seq_axis``) runs ring
    or Ulysses attention over global positions, whatever ``attn_impl``
    says, as the JAX package does."""
    c = config
    b, s, _ = x.shape
    hd = par.head_dim
    heads, kv_heads = par.heads, par.kv_heads
    if par.split_heads:
        x = copy_to_model(x, par.model_group)
    q, k, v = _split_qkv(_matmul(x, qkv_w, c.dtype), heads, kv_heads, hd)
    q = q.reshape(b, s, heads, hd)
    k = k.reshape(b, s, kv_heads, hd)
    v = v.reshape(b, s, kv_heads, hd)
    if c.pos_encoding == 'rope':
        # global positions: a sequence shard starts at its rank's offset
        positions = torch.arange(s, device=x.device) + par.seq_rank * s
        q = _rope_rotate(q, positions, c.rope_theta)
        k = _rope_rotate(k, positions, c.rope_theta)
    if par.kv_index is not None:
        index = torch.tensor(par.kv_index, device=x.device)
        k, v = k.index_select(2, index), v.index_select(2, index)
    else:
        k = _expand_kv_heads(k, heads)
        v = _expand_kv_heads(v, heads)

    if c.seq_axis is not None:
        if c.seq_impl == 'ring':
            from petastorm_tpu_torch.ops.ring_attention import ring_attention as attend
        else:
            from petastorm_tpu_torch.ops.ulysses_attention import ulysses_attention as attend
        ctx = attend(q, k, v, par.mesh, axis_name=c.seq_axis, causal=causal,
                     batch_axis=par.batch_axis).reshape(b, s, heads * hd)
    elif c.attn_impl == 'flash':
        from petastorm_tpu_torch.ops.flash_attention import flash_attention_fused
        ctx = flash_attention_fused(q, k, v, causal=causal).reshape(b, s, heads * hd)
    else:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(c.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, heads * hd)
    out = _matmul(ctx, out_w, c.dtype)
    return _reduce_partial(out, par, c.dtype) if par.split_heads else out


def _block_attention_half(block, x, config, par, causal=True):
    """Pre-norm attention sublayer with its residual."""
    return x + _attention(_rmsnorm(x, block.ln1), block.qkv, block.attn_out, config, par,
                          causal=causal)


def _block_dense_ffn_half(block, x, config, par=None):
    """Pre-norm dense-FFN sublayer with its residual: the gelu MLP, or the
    gated silu one when ``config.ffn == 'swiglu'``; over ``'model'`` the
    hidden width is split (``par``)."""
    dtype = config.dtype
    split = par is not None and par.tp > 1
    h = _rmsnorm(x, block.ln2)
    if split:
        h = copy_to_model(h, par.model_group)
    up = _matmul(h, block.mlp_in, dtype).float()
    if config.ffn == 'swiglu':
        gate = _matmul(h, block.mlp_gate, dtype).float()
        h = (F.silu(gate) * up).to(dtype)
    else:
        h = F.gelu(up, approximate='tanh').to(dtype)
    out = _matmul(h, block.mlp_out, dtype)
    if split:
        return x + _reduce_partial(out, par, dtype)
    return x + out.to(dtype)


def _block_forward(block, x, config, par, causal=True):
    """One dense pre-norm block: attention then the dense FFN, each
    residual (the layered forward's and, with ``causal=False``, the
    ViT's)."""
    x = _block_attention_half(block, x, config, par, causal=causal)
    return _block_dense_ffn_half(block, x, config, par=par)


def _block_moe_half(block, x, config, split):
    """MoE FFN sublayer (RMSNorm, Switch MoE, residual) routing the array
    ``split`` describes. Returns ``(x, aux)``."""
    from petastorm_tpu_torch.models.moe import moe_forward
    ffn_out, aux = moe_forward(block.moe, _rmsnorm(x, block.ln2), config.moe_config(),
                               split=split)
    return x + ffn_out.to(config.dtype), aux


def _moe_block_forward(block, x, config, par, split):
    return _block_moe_half(block, _block_attention_half(block, x, config, par), config, split)


def _dense_block_forward(block, x, config, par, split):
    return _block_forward(block, x, config, par), None


def _run_block(block, x, config, par, split=None):
    """``(x, aux or None)`` after one block: the one place the MoE/dense
    branch and ``config.remat`` (the whole block, MoE half included,
    recomputed in the backward) meet. ``split`` (default the layered
    forward's, ``par.moe_split``) says which array an MoE block routes."""
    forward = _moe_block_forward if config.n_experts > 0 else _dense_block_forward
    split = par.moe_split if split is None else split
    if config.remat:
        return checkpoint(forward, block, x, config, par, split, use_reentrant=False)
    return forward(block, x, config, par, split)


def _embed(model, tokens):
    """The embedded ``(B, S, D)`` activations of this rank's rows (its
    block of positions with ``config.seq_axis``)."""
    c, par = model.config, model.parallel
    if c.seq_axis is not None:
        if par.mesh is None:
            raise ValueError('config.seq_axis=%r needs the mesh passed to the '
                             'forward/train step (ring attention runs a '
                             'collective over that axis)' % (c.seq_axis,))
        tokens = par.seq_slice(tokens)
    x = F.embedding(tokens.long(), model.embed).to(c.dtype)
    if c.pos_encoding == 'learned':
        start = par.seq_rank * tokens.shape[1]
        x = x + model.pos_embed[start:start + tokens.shape[1]].to(c.dtype)
    return x


def _features_with_aux(model, tokens):
    """Post-``ln_f`` hidden states ``(B, S, D)`` and the aux loss: the
    Switch loss summed over the MoE blocks (0.0 for a dense model), the
    forward without the head. With ``config.seq_axis`` ``tokens`` are the
    global rows and the states this rank's block of positions."""
    c, par = model.config, model.parallel
    if par.pipe_axis is not None:
        raise ValueError('a pipelined model holds one stage\'s blocks: run it through '
                         'pipelined_transformer_forward and its train step')
    x = _embed(model, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        x, aux = _run_block(block, x, c, par)
        if aux is not None:
            aux_total = aux_total + aux
    return _rmsnorm(x, model.ln_f), aux_total


def transformer_forward_with_aux(model, tokens):
    """tokens ``(B, S)`` int → (logits ``(B, S, V)`` f32, aux loss). On a
    split model the logits are this rank's block: ``S / n_seq`` positions
    (``config.seq_axis``) by ``V / tp`` vocabulary entries (``'model'``)."""
    x, aux = _features_with_aux(model, tokens)
    x = copy_to_model(x, model.parallel.model_group)
    return _matmul(x, model.lm_head, model.config.dtype).float(), aux


def transformer_forward(model, tokens):
    """tokens ``(B, S)`` int → logits ``(B, S, V)`` f32 (this rank's
    block on a split model, see :func:`transformer_forward_with_aux`)."""
    return transformer_forward_with_aux(model, tokens)[0]


class _VocabParallelNll(torch.autograd.Function):
    """Next-token NLL from logits split by vocabulary over ``group``: the
    row max and the sum of exponentials are all-reduced, and the target's
    logit comes from the rank that holds it. The backward is local:
    ``softmax - onehot(target)`` on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, vocab_start, group):
        from torch.distributed import ReduceOp
        n = logits.shape[-1]
        m = all_reduce(logits.amax(dim=-1), group, op=ReduceOp.MAX, name='vocab_max')
        e = torch.exp(logits - m[..., None])
        local = targets - vocab_start
        owned = (local >= 0) & (local < n)
        index = local.clamp(0, n - 1)
        target_logit = (logits.gather(-1, index[..., None])[..., 0] - m) * owned
        sums = all_reduce(torch.stack([e.sum(dim=-1), target_logit]), group,
                          name='vocab_sum')
        ctx.save_for_backward(e / sums[0][..., None], index, owned)
        return sums[0].log() - sums[1]

    @staticmethod
    def backward(ctx, g):
        softmax, index, owned = ctx.saved_tensors
        grad = softmax * g[..., None]
        grad.scatter_add_(-1, index[..., None], -(g * owned)[..., None])
        return grad, None, None, None


def _chunk_nll(xc, lm_head, tc, mc, dtype, par=None):
    logits = _matmul(xc, lm_head, dtype).float()
    if par is not None and par.tp > 1:
        nll = _VocabParallelNll.apply(logits, tc, par.vocab_start, par.model_group)
        return (nll * mc).sum(), mc.sum()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, tc[..., None])[..., 0]
    return -(ll * mc).sum(), mc.sum()


def _chunked_next_token_nll(x, lm_head, targets, mask, chunk, dtype, par=None):
    """``(sum_nll, count)`` over position chunks of ``chunk``: each chunk's
    head matmul, log-softmax and gather run under
    ``torch.utils.checkpoint``, so only one chunk's logits exist at a time,
    in the backward too. ``mask`` weights positions."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.float()
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s + pad, chunk):
        part = slice(start, start + chunk)
        nll_c, cnt_c = checkpoint(_chunk_nll, x[:, part], lm_head, targets[:, part],
                                  mask[:, part], dtype, par, use_reentrant=False)
        nll = nll + nll_c
        cnt = cnt + cnt_c
    return nll, cnt


def _next_token_nll(model, inputs, targets, mask, features=None):
    """``(sum_nll, count, aux)`` over the global batch: this rank's sums
    over its rows, positions (``config.seq_axis``) and vocabulary (split
    over ``'model'``), added up over the ranks by :meth:`Parallel.batch_sum`.
    ``targets`` and ``mask`` are this rank's rows, shifted before the
    sequence split, so a shard's last target is the next shard's first
    token. ``aux`` is the global batch's Switch loss, the same on every
    rank. ``features`` (default the layered forward's) gives the
    post-``ln_f`` states and the aux."""
    c, par = model.config, model.parallel
    x, aux = (features or _features_with_aux)(model, inputs)
    targets, mask = par.seq_slice(targets), par.seq_slice(mask).float()
    x = copy_to_model(x, par.model_group)
    if c.loss_chunk > 0:
        nll, cnt = _chunked_next_token_nll(x, model.lm_head, targets, mask, c.loss_chunk,
                                           c.dtype, par)
    else:
        nll, cnt = _chunk_nll(x, model.lm_head, targets, mask, c.dtype, par)
    nll, cnt = par.batch_sum(torch.stack([nll, cnt])).unbind()
    return nll, cnt, aux


def transformer_loss(model, tokens):
    """Next-token cross-entropy over ``(B, S)`` int token batches: positions
    ``[:-1]`` predict ``[1:]``, so attention runs at S − 1.
    ``config.loss_chunk > 0`` computes it chunked. On a split model each
    rank passes its rows (the whole sequence: the shift comes before the
    sequence split) and gets the loss of the global batch."""
    targets = tokens[:, 1:].long()
    mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    nll, cnt, aux = _next_token_nll(model, tokens[:, :-1], targets, mask)
    return nll / cnt + model.config.moe_aux_weight * aux


def transformer_masked_loss(model, tokens, lengths):
    """Next-token cross-entropy over right-padded ``(B, S)`` batches:
    position ``i`` predicts ``i + 1`` and counts only when ``i + 1 <
    min(length, S)``, with ``lengths`` the loader's ``<field>_len`` column
    (a truncated row's length exceeds S and saturates). The mean is over
    real targets, so the gradient's scale does not depend on padding; a
    batch without one gives 0. Causal attention over right-padded rows
    needs no key mask: a real position attends only to positions before
    it, all real. ``config.loss_chunk > 0`` computes it chunked. On a
    split model the sums and counts run over the global batch, as in
    :func:`transformer_loss`.

    Dense configs only, as the JAX version: the Switch router's
    load-balancing statistics run over every position, padding
    included, so an MoE config raises ``NotImplementedError``."""
    if model.config.n_experts > 0:
        raise NotImplementedError(
            'transformer_masked_loss supports dense configs only: the Switch aux '
            'statistics would include padding positions. Use packed batches '
            '(examples.lm_pretrain) for MoE.')
    targets = tokens[:, 1:].long()
    positions = torch.arange(targets.shape[1], device=tokens.device)
    limit = torch.clamp(lengths.to(device=tokens.device, dtype=torch.long),
                        max=tokens.shape[1])
    mask = (positions[None, :] + 1 < limit[:, None]).float()
    nll, cnt, _ = _next_token_nll(model, tokens[:, :-1], targets, mask)
    return nll / torch.clamp(cnt, min=1)


def _step_parallel(model, mesh):
    """The model's :class:`Parallel`; a train step's ``mesh`` must be the
    one the model was built on."""
    par = model.parallel
    if mesh is not None and mesh is not par.mesh:
        raise ValueError('the train step\'s mesh must be the one the model was built on '
                         '(init_transformer(mesh=) / init_vit(mesh=))')
    return par


def transformer_masked_train_step(model, optimizer, mesh=None):
    """A ``(tokens, lengths) -> loss`` step over padded or bucketed batches
    (see :func:`transformer_masked_loss`): forward, backward and one
    optimizer update. Nothing is compiled per shape, so one step serves
    every bucket's width. On a split model (``mesh``, default the
    model's) the gradients sync as :meth:`Parallel.sync_grads` says and
    the loss is the global batch's, over all its real targets."""
    par = _step_parallel(model, mesh)

    def step(tokens, lengths):
        optimizer.zero_grad(set_to_none=True)
        loss = transformer_masked_loss(model, tokens, lengths)
        loss.backward()
        par.sync_grads(model)
        optimizer.step()
        return loss.detach()

    return step


def transformer_train_step(model, optimizer, mesh=None, accum_steps=1):
    """A ``tokens -> loss`` step: forward, backward and one optimizer update.

    ``mesh`` (default the model's) must be the mesh the model was built
    on: each rank passes its rows of the batch (the whole sequence when it
    is split), the gradients sync over the ranks as
    :meth:`Parallel.sync_grads` says (summed over ``'data'`` and the
    sequence dim; the ``'model'`` shards need no sync) and the loss
    returned is the global batch's.

    ``accum_steps=k`` splits the ``(B, S)`` batch into k microbatches of
    B/k rows and averages their gradients before the one update: the
    arithmetic of a B-row step at the activation memory of a B/k-row step
    (exact for the dense model, where every position carries a target; for
    an MoE model the aux loss becomes the mean of the microbatches' Switch
    losses, as in the JAX step)."""
    if accum_steps < 1:
        raise ValueError('accum_steps must be >= 1; got %r' % (accum_steps,))
    par = _step_parallel(model, mesh)

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = transformer_loss(model, tokens)
            loss.backward()
        else:
            b = tokens.shape[0]
            if b % accum_steps:
                raise ValueError('batch size %d not divisible by accum_steps %d'
                                 % (b, accum_steps))
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for chunk in tokens.reshape(accum_steps, b // accum_steps, tokens.shape[1]):
                micro = transformer_loss(model, chunk)
                (micro / accum_steps).backward()
                loss = loss + micro.detach()
            loss = loss / accum_steps
        par.sync_grads(model)
        optimizer.step()
        return loss.detach()

    return step


def init_pipelined_transformer(seed, config, mesh, pipe_axis=None, device=None):
    """A :class:`PipelinedTransformer` for this rank's stage of ``mesh``'s
    ``pipe_axis`` (default ``'pipe'``): the weights :func:`init_transformer`
    draws from ``seed``, this stage's layers and this rank's ``'model'`` and
    ``'expert'`` shards of them, on ``device`` (``None`` means the card).
    ``config.n_layers`` must divide over the stages."""
    device = torch.device('cuda' if device is None else device)
    model = PipelinedTransformer(config, mesh, pipe_axis)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def _microbatch_plan(par, n_microbatches, rows):
    """``(each local microbatch's rows, their TokenSplits, whether each
    rank's microbatches are its own)`` of a pipeline of ``n_microbatches``
    global microbatches (default one a stage) over a batch whose ``rows`` a
    rank holds. A global microbatch is rows ``[m·B/M, (m+1)·B/M)`` of the
    global batch, as in the reference. With ``M`` a multiple of ``dp`` each
    data rank holds ``M/dp`` whole ones and routes each alone. Otherwise
    every data rank runs all ``M``, each with its rows of it (none for one
    it does not touch), and the ranks a microbatch straddles route it as
    one array; every data rank then runs the same schedule, so the
    routing collectives meet. MoE routing is local to a rank's block of
    positions with the aux statistics summed over the sequence dim, as the
    reference's manual region routes."""
    from petastorm_tpu_torch.models.moe import TokenSplit
    m = par.pp if n_microbatches is None else n_microbatches
    batch, dp = rows * par.dp, par.dp
    if m < 1 or batch % m:
        raise ValueError('batch %d not divisible into %d microbatches' % (batch, m))
    size = batch // m
    if m % dp == 0:
        return [size] * (m // dp), [TokenSplit(stats=par.seq_group)] * (m // dp), True

    def overlap(start, n):
        return [max(0, min((k + 1) * size, start + n) - max(k * size, start))
                for k in range(m)]

    sizes = overlap(par.dp_rank * rows, rows)
    held = [overlap(r * rows, rows) for r in range(dp)]
    splits = [TokenSplit(rows=par.data_group, stats=par.seq_group, rows_total=size,
                         members=tuple(r for r in range(dp) if held[r][k]))
              for k in range(m)]
    return sizes, splits, False


def _pipelined_features_with_aux(model, tokens, n_microbatches=None):
    """The pipelined counterpart of :func:`_features_with_aux`: the
    embedding on every stage, this stage's blocks as a GPipe stage, and
    ``ln_f`` on the last stage's output, which every stage receives. The
    aux is the Switch loss summed over layers and averaged over the
    global microbatches, each counted once, as in the reference."""
    from petastorm_tpu_torch.parallel.pipeline import run_pipeline
    c, par = model.config, model.parallel
    x = _embed(model, tokens)
    sizes, splits, own = _microbatch_plan(par, n_microbatches, x.shape[0])
    moe = c.n_experts > 0

    def stage_fn(blocks, x, index):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for block in blocks:
            x, aux = _run_block(block, x, c, par, splits[index])
            if aux is not None:
                aux_total = aux_total + aux
        return (x, aux_total) if moe else x

    x, aux = run_pipeline(stage_fn, list(model.blocks), x, par.pipe_group, sizes,
                          with_aux=moe)
    if moe and own and par.dp > 1:
        # each data rank's own microbatches: their mean over 'data' (a
        # rank that ran every microbatch has the global mean already, its
        # gradient its own rows' part)
        aux = reduce_from_model(aux, par.data_group) / par.dp
    return _rmsnorm(x, model.ln_f), aux


def pipelined_transformer_forward_with_aux(model, tokens, n_microbatches=None):
    """tokens ``(B, S)`` int → (logits f32, aux) through the pipeline:
    this rank's block of the logits (its rows, positions and vocabulary
    on a split model), on every stage."""
    x, aux = _pipelined_features_with_aux(model, tokens, n_microbatches)
    x = copy_to_model(x, model.parallel.model_group)
    return _matmul(x, model.lm_head, model.config.dtype).float(), aux


def pipelined_transformer_forward(model, tokens, n_microbatches=None):
    """tokens ``(B, S)`` int → logits f32 through the pipeline (aux
    discarded)."""
    return pipelined_transformer_forward_with_aux(model, tokens, n_microbatches)[0]


def pipelined_transformer_loss(model, tokens, n_microbatches=None):
    """:func:`transformer_loss` through the pipeline: the global batch's
    next-token cross-entropy (chunked with ``config.loss_chunk``) plus the
    weighted aux, on every stage."""
    def features(m, inputs):
        return _pipelined_features_with_aux(m, inputs, n_microbatches)

    targets = tokens[:, 1:].long()
    mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
    nll, cnt, aux = _next_token_nll(model, tokens[:, :-1], targets, mask, features)
    return nll / cnt + model.config.moe_aux_weight * aux


def pipelined_transformer_train_step(model, optimizer, mesh=None, pipe_axis=None,
                                     n_microbatches=None):
    """A ``tokens -> loss`` step of the pipelined model: each rank passes
    its rows of the batch, the GPipe forward and backward run over the
    stages, the gradients sync as :meth:`Parallel.sync_grads` says and
    the optimizer updates this rank's parameters. ``mesh`` and
    ``pipe_axis`` default to the model's and must be them."""
    par = _step_parallel(model, mesh)
    if pipe_axis is not None and pipe_axis != par.pipe_axis:
        raise ValueError('the train step\'s pipe_axis %r is not the model\'s %r'
                         % (pipe_axis, par.pipe_axis))

    def step(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = pipelined_transformer_loss(model, tokens, n_microbatches)
        loss.backward()
        par.sync_grads(model)
        optimizer.step()
        return loss.detach()

    return step


def adamw(model, learning_rate=1e-3):
    """``torch.optim.AdamW`` with optax ``adamw``'s defaults (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4; torch's own weight decay
    default is 0.01), the optimizer of every recipe in the port."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
