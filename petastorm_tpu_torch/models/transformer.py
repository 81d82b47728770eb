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
batches. MoE blocks, sequence parallelism, the pipelined forward and
decoding are not ported yet (``ROADMAP.md`` Queue 1 item 8).
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from petastorm_tpu_torch.errors import unported


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_seq_len: int = 128
    dtype: object = torch.bfloat16
    # MoE (n_experts > 0) and sequence parallelism (seq_axis) are not
    # ported yet; the fields stay so configs carry across
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    expert_axis: str = 'expert'
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
        if self.n_experts > 0:
            raise unported('TransformerConfig(n_experts > 0) (MoE blocks)', 8)
        if self.seq_axis is not None:
            raise unported('TransformerConfig(seq_axis=) (ring/Ulysses attention)', 8)

    @property
    def kv_heads(self):
        """Effective K/V head count (n_kv_heads, defaulting to n_heads)."""
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads


def _param(*shape):
    return nn.Parameter(torch.empty(shape, dtype=torch.float32))


class _Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        head_dim = c.d_model // c.n_heads
        self.qkv = _param(c.d_model, (c.n_heads + 2 * c.kv_heads) * head_dim)
        self.attn_out = _param(c.d_model, c.d_model)
        self.ln1 = _param(c.d_model)
        self.ln2 = _param(c.d_model)
        self.mlp_in = _param(c.d_model, c.d_ff)
        if c.ffn == 'swiglu':
            self.mlp_gate = _param(c.d_model, c.d_ff)
        self.mlp_out = _param(c.d_ff, c.d_model)


@torch.no_grad()
def reset_block(block, c, generator):
    """A block's weights as the JAX init scales them (``fan_in**-0.5``
    normals, norm gains of one), drawn from ``generator``."""
    def normal(p, scale):
        p.copy_(torch.randn(p.shape, generator=generator) * scale)

    normal(block.qkv, c.d_model ** -0.5)
    normal(block.attn_out, c.d_model ** -0.5)
    block.ln1.fill_(1.0)
    block.ln2.fill_(1.0)
    normal(block.mlp_in, c.d_model ** -0.5)
    if c.ffn == 'swiglu':
        normal(block.mlp_gate, c.d_model ** -0.5)
    normal(block.mlp_out, c.d_ff ** -0.5)


class Transformer(nn.Module):
    """The JAX model's parameter tree as an ``nn.Module``: ``embed``,
    ``pos_embed`` (learned positions only), ``lm_head``, ``ln_f`` and
    ``blocks.<i>.{qkv, attn_out, ln1, ln2, mlp_in, mlp_gate, mlp_out}``."""

    def __init__(self, config):
        super().__init__()
        c = self.config = config
        self.embed = _param(c.vocab_size, c.d_model)
        if c.pos_encoding == 'learned':
            self.pos_embed = _param(c.max_seq_len, c.d_model)
        self.lm_head = _param(c.d_model, c.vocab_size)
        self.ln_f = _param(c.d_model)
        self.blocks = nn.ModuleList(_Block(c) for _ in range(c.n_layers))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Normal draws from ``generator`` in the JAX init's order and
        scales (0.02 for tables and the head, ``fan_in**-0.5`` for block
        matrices); norm gains are ones."""
        c = self.config

        def normal(p, scale):
            p.copy_(torch.randn(p.shape, generator=generator) * scale)

        normal(self.embed, 0.02)
        if c.pos_encoding == 'learned':
            normal(self.pos_embed, 0.02)
        normal(self.lm_head, 0.02)
        self.ln_f.fill_(1.0)
        for block in self.blocks:
            reset_block(block, c, generator)

    def forward(self, tokens):
        """tokens ``(B, S)`` int → logits ``(B, S, V)`` f32."""
        return transformer_forward(self, tokens)


def init_transformer(seed, config, device=None):
    """A :class:`Transformer` with weights drawn from a CPU
    ``torch.Generator`` seeded ``seed`` (the same weights on every
    device), on ``device`` (``None`` means the card)."""
    device = torch.device('cuda' if device is None else device)
    model = Transformer(config)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device)


def params_from_jax(params):
    """A :class:`Transformer` ``state_dict`` from the JAX model's parameter
    pytree (numpy arrays): the same names and layouts, as f32 tensors."""
    state = {}
    for name in ('embed', 'pos_embed', 'lm_head', 'ln_f'):
        if name in params:
            state[name] = torch.tensor(np.asarray(params[name], np.float32))
    for i, block in enumerate(params['blocks']):
        for name, value in block.items():
            state['blocks.%d.%s' % (i, name)] = torch.tensor(np.asarray(value, np.float32))
    return state


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


def _attention(x, qkv_w, out_w, n_heads, dtype, attn_impl='dense', causal=True,
               kv_heads=None, rope_theta=None):
    b, s, d = x.shape
    head_dim = d // n_heads
    kv_heads = n_heads if kv_heads is None else kv_heads
    q, k, v = _split_qkv(_matmul(x, qkv_w, dtype), n_heads, kv_heads, head_dim)
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, kv_heads, head_dim)
    v = v.reshape(b, s, kv_heads, head_dim)
    if rope_theta is not None:
        positions = torch.arange(s, device=x.device)
        q = _rope_rotate(q, positions, rope_theta)
        k = _rope_rotate(k, positions, rope_theta)
    k = _expand_kv_heads(k, n_heads)
    v = _expand_kv_heads(v, n_heads)

    if attn_impl == 'flash':
        from petastorm_tpu_torch.ops.flash_attention import flash_attention_fused
        ctx = flash_attention_fused(q, k, v, causal=causal).reshape(b, s, d)
    else:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(head_dim)
        if causal:
            mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, dim=-1).to(dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
    return _matmul(ctx, out_w, dtype)


def _block_forward(block, x, config, causal=True):
    """One pre-norm block: attention then the dense FFN, each residual."""
    c = config
    dtype = c.dtype
    x = x + _attention(_rmsnorm(x, block.ln1), block.qkv, block.attn_out, c.n_heads,
                       dtype, attn_impl=c.attn_impl, causal=causal, kv_heads=c.kv_heads,
                       rope_theta=c.rope_theta if c.pos_encoding == 'rope' else None)
    h = _rmsnorm(x, block.ln2)
    up = _matmul(h, block.mlp_in, dtype).float()
    if c.ffn == 'swiglu':
        gate = _matmul(h, block.mlp_gate, dtype).float()
        h = (F.silu(gate) * up).to(dtype)
    else:
        h = F.gelu(up, approximate='tanh').to(dtype)
    return x + _matmul(h, block.mlp_out, dtype).to(dtype)


def _features_with_aux(model, tokens):
    """Post-``ln_f`` hidden states ``(B, S, D)`` and the aux loss (0.0 for
    the dense model): the forward without the head."""
    c = model.config
    x = F.embedding(tokens.long(), model.embed).to(c.dtype)
    if c.pos_encoding == 'learned':
        x = x + model.pos_embed[:tokens.shape[1]].to(c.dtype)
    for block in model.blocks:
        if c.remat:
            x = checkpoint(_block_forward, block, x, c, use_reentrant=False)
        else:
            x = _block_forward(block, x, c)
    return _rmsnorm(x, model.ln_f), torch.zeros((), dtype=torch.float32, device=x.device)


def transformer_forward_with_aux(model, tokens):
    """tokens ``(B, S)`` int → (logits ``(B, S, V)`` f32, aux loss)."""
    x, aux = _features_with_aux(model, tokens)
    return _matmul(x, model.lm_head, model.config.dtype).float(), aux


def transformer_forward(model, tokens):
    """tokens ``(B, S)`` int → logits ``(B, S, V)`` f32."""
    return transformer_forward_with_aux(model, tokens)[0]


def _chunk_nll(xc, lm_head, tc, mc, dtype):
    logits = _matmul(xc, lm_head, dtype).float()
    ll = torch.log_softmax(logits, dim=-1).gather(-1, tc[..., None])[..., 0]
    return -(ll * mc).sum(), mc.sum()


def _chunked_next_token_nll(x, lm_head, targets, mask, chunk, dtype):
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
                                  mask[:, part], dtype, use_reentrant=False)
        nll = nll + nll_c
        cnt = cnt + cnt_c
    return nll, cnt


def transformer_loss(model, tokens):
    """Next-token cross-entropy over ``(B, S)`` int token batches: positions
    ``[:-1]`` predict ``[1:]``, so attention runs at S − 1.
    ``config.loss_chunk > 0`` computes it chunked."""
    c = model.config
    targets = tokens[:, 1:].long()
    if c.loss_chunk > 0:
        x, aux = _features_with_aux(model, tokens[:, :-1])
        mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
        nll, cnt = _chunked_next_token_nll(x, model.lm_head, targets, mask, c.loss_chunk,
                                           c.dtype)
        return nll / cnt + c.moe_aux_weight * aux
    logits, aux = transformer_forward_with_aux(model, tokens[:, :-1])
    ll = torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    return -ll.mean() + c.moe_aux_weight * aux


def transformer_masked_loss(model, tokens, lengths):
    """Next-token cross-entropy over right-padded ``(B, S)`` batches:
    position ``i`` predicts ``i + 1`` and counts only when ``i + 1 <
    min(length, S)``, with ``lengths`` the loader's ``<field>_len`` column
    (a truncated row's length exceeds S and saturates). The mean is over
    real targets, so the gradient's scale does not depend on padding; a
    batch without one gives 0. Causal attention over right-padded rows
    needs no key mask: a real position attends only to positions before
    it, all real. ``config.loss_chunk > 0`` computes it chunked. Dense
    configs only, as the JAX version (the port has no MoE blocks)."""
    c = model.config
    targets = tokens[:, 1:].long()
    positions = torch.arange(targets.shape[1], device=tokens.device)
    limit = torch.clamp(lengths.to(device=tokens.device, dtype=torch.long),
                        max=tokens.shape[1])
    mask = (positions[None, :] + 1 < limit[:, None]).float()
    if c.loss_chunk > 0:
        x, aux = _features_with_aux(model, tokens[:, :-1])
        nll, cnt = _chunked_next_token_nll(x, model.lm_head, targets, mask, c.loss_chunk,
                                           c.dtype)
        return nll / torch.clamp(cnt, min=1) + c.moe_aux_weight * aux
    logits, aux = transformer_forward_with_aux(model, tokens[:, :-1])
    ll = torch.log_softmax(logits, dim=-1).gather(-1, targets[..., None])[..., 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1) + c.moe_aux_weight * aux


def transformer_masked_train_step(model, optimizer):
    """A ``(tokens, lengths) -> loss`` step over padded or bucketed batches
    (see :func:`transformer_masked_loss`): forward, backward and one
    optimizer update. Nothing is compiled per shape, so one step serves
    every bucket's width."""

    def step(tokens, lengths):
        optimizer.zero_grad(set_to_none=True)
        loss = transformer_masked_loss(model, tokens, lengths)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def transformer_train_step(model, optimizer, accum_steps=1):
    """A ``tokens -> loss`` step: forward, backward and one optimizer update.

    ``accum_steps=k`` splits the ``(B, S)`` batch into k microbatches of
    B/k rows and averages their gradients before the one update: the
    arithmetic of a B-row step at the activation memory of a B/k-row step
    (exact for the dense model, where every position carries a target)."""
    if accum_steps < 1:
        raise ValueError('accum_steps must be >= 1; got %r' % (accum_steps,))

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
        optimizer.step()
        return loss.detach()

    return step


def adamw(model, learning_rate=1e-3):
    """``torch.optim.AdamW`` with optax ``adamw``'s defaults (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4; torch's own weight decay
    default is 0.01), the optimizer of every recipe in the port."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)
