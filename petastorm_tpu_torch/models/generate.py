"""Autoregressive decoding for the transformer LM with a static KV cache
(counterpart of ``petastorm_tpu/models/generate.py``).

Training (:mod:`petastorm_tpu_torch.models.transformer`) recomputes
attention over the whole sequence; decoding that way costs O(S²) a
token. Here:

* one **static KV cache** ``(n_layers, B, max_seq_len, KV, Dh)`` for keys
  and one for values, in ``config.dtype``, is allocated once a call and
  written in place at each position (``KV = config.kv_heads``: with
  grouped-query attention the cache and its reads shrink by the group
  factor; it is never expanded to the query heads);
* **prefill** runs the prompt through the blocks once, over the prompt's
  own ``(P, P)`` causal mask, recording K/V (rotated under rope);
* each **decode step** feeds one token per row and attends to the cache
  up to its position.

A Python loop under ``torch.inference_mode()`` takes the place of the JAX
package's ``lax.scan``; each step attends to ``cache[:, :, :pos + 1]``
where the JAX step masks the static length, and each weight is cast to
``config.dtype`` once a call where the JAX step casts it once a token:
both give the same values. Greedy decoding equals the recompute oracle
(:func:`reference_greedy_generate`) token for token.

The model carries its config, as everywhere in the port: the functions
take the :class:`~petastorm_tpu_torch.models.transformer.Transformer`
where the JAX ones take ``(params, ..., config)``, and decode on the
model's device. Dense configs only: an MoE config or one with
``seq_axis`` raises ``NotImplementedError``, as the JAX package's does,
and a pipelined model (one stage's blocks) raises ``ValueError``.

A model split over a mesh (``init_transformer(mesh=)`` or
``params_from_jax(params, mesh, config)``) decodes on its ``'data'`` and
``'model'`` dims, as the JAX package's decode runs under GSPMD on a tree
placed over them. Each rank passes its own ``'data'`` rows (the ranks of
one ``'model'`` group the same ones) and gets them back. A rank projects
and caches its own heads (``model.parallel``'s ``heads`` and
``kv_heads``: the cache is ``(n_layers, B, max_seq_len, kv_heads, Dh)``),
a query head reads its K/V head through ``kv_index`` only where GQA groups
straddle ranks (else the heads group over the cache as in one process), and attention is whole on every rank when the heads do
not split. The attention output and the FFN output are row-split
products summed over ``'model'`` in f32, as in training; the head's
vocabulary block of logits is gathered over ``'model'``, so the choice
of token (and ``on_logits``) sees the whole ``(B, V)`` row. A decode
step runs ``2 x n_layers`` all-reduces (``n_layers`` when the heads do
not split) and one all-gather over ``'model'``; a sampled decode adds a
broadcast of model-rank 0's tokens, so every rank emits the same token
(each draws from the same row with a generator in the same state).
"""

import math
import types

import torch
import torch.nn.functional as F

from petastorm_tpu_torch.models.transformer import (
    _block_dense_ffn_half, _reduce_partial, _rmsnorm, _rope_rotate, _split_qkv,
    transformer_forward,
)
from petastorm_tpu_torch.parallel.collectives import all_gather, broadcast

_MATRICES = ('qkv', 'attn_out', 'mlp_in', 'mlp_gate', 'mlp_out')


def _cast_block(block, dtype):
    """A block's weights for one decode call: the matrices cast to
    ``dtype`` once, the norm gains as they are (f32)."""
    weights = {name: getattr(block, name).to(dtype) for name in _MATRICES
               if hasattr(block, name)}
    return types.SimpleNamespace(ln1=block.ln1, ln2=block.ln2, **weights)


def _block_kv(block, x, config, par, positions):
    """One block's normalized-input QKV projection on this rank's heads
    (``par``, the model's :class:`~petastorm_tpu_torch.models.transformer.Parallel`):
    q ``(B, S, H, Dh)``, k and v ``(B, S, KV, Dh)``, as the training
    attention computes them. With rope, ``positions`` ``(S,)`` rotates q
    and k here, so the cache holds rotated keys."""
    c = config
    b, s, _ = x.shape
    n, kv, dh = par.heads, par.kv_heads, par.head_dim
    qkv = torch.matmul(_rmsnorm(x, block.ln1), block.qkv.to(c.dtype))
    q, k, v = _split_qkv(qkv, n, kv, dh)
    q, k, v = q.reshape(b, s, n, dh), k.reshape(b, s, kv, dh), v.reshape(b, s, kv, dh)
    if c.pos_encoding == 'rope':
        q = _rope_rotate(q, positions, c.rope_theta)
        k = _rope_rotate(k, positions, c.rope_theta)
    return q, k, v


def _kv_read_index(par, device):
    """The index through which this rank's query heads read its K/V heads
    (``par.kv_index`` on the device), or None where they group
    contiguously over them (``H / KV`` query heads each, as in the unsplit
    model): only GQA groups that straddle ranks need it."""
    if par.kv_index is None:
        return None
    group = par.heads // par.kv_heads
    if par.heads % par.kv_heads == 0 and par.kv_index == [j // group
                                                          for j in range(par.heads)]:
        return None
    return torch.tensor(par.kv_index, device=device)


def _attend(q, keys, values, valid_mask, out_w, config, par, kv_index=None):
    """q ``(B, S_q, H, Dh)`` over ``keys``/``values`` ``(B, S_k, KV, Dh)``,
    masked by ``valid_mask`` ``(S_q, S_k)`` (None: every key is valid).
    With GQA the query heads are grouped over their shared K/V head in the
    matmul itself: the cache is read at KV width. Where this rank's query
    heads straddle GQA groups, each reads its K/V head through
    ``kv_index`` (:func:`_kv_read_index`) instead. Scores are f32 products
    of the ``config.dtype`` values scaled by the training path's op
    (``scores / sqrt(Dh)``), masked with ``-1e30``. On split heads the
    output projection is this rank's partial product, summed over
    ``'model'``."""
    dtype = config.dtype
    if kv_index is not None:
        keys, values = keys.index_select(2, kv_index), values.index_select(2, kv_index)
    b, s_q, n, dh = q.shape
    s_k, kv = keys.shape[1], keys.shape[2]
    group = n // kv
    # (B, KV, G·S_q, Dh): row g·S_q + i is query head kv·G + g at position i
    qg = q.reshape(b, s_q, kv, group, dh).permute(0, 2, 3, 1, 4).reshape(b, kv, group * s_q, dh)
    scores = torch.matmul(qg.float(), keys.permute(0, 2, 3, 1).float()) / math.sqrt(dh)
    scores = scores.reshape(b, kv, group, s_q, s_k)
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1).to(dtype).reshape(b, kv, group * s_q, s_k)
    ctx = torch.matmul(probs, values.transpose(1, 2))                 # (B, KV, G·S_q, Dh)
    ctx = ctx.reshape(b, kv, group, s_q, dh).permute(0, 3, 1, 2, 4).reshape(b, s_q, n * dh)
    out = torch.matmul(ctx, out_w.to(dtype))
    return _reduce_partial(out, par, dtype) if par.split_heads else out


def _head_logits(model, x_last, lm_head):
    """``(B, V)`` f32 logits of the last position's hidden state: on a
    model split over ``'model'`` the ranks' vocabulary blocks gathered."""
    logits = torch.matmul(_rmsnorm(x_last, model.ln_f), lm_head).float()
    return all_gather(logits, model.parallel.model_group, dim=-1)


def greedy_generate(model, prompt, max_new_tokens, eos_token=None):
    """Greedy decode: ``prompt`` ``(B, P)`` int → ``(B, P + max_new_tokens)``
    on the model's device, in the prompt's dtype.

    Requires ``P + max_new_tokens <= config.max_seq_len`` and a dense
    config. ``eos_token``: a row that emits it keeps emitting it (the
    other rows decode on). The JAX version is
    ``greedy_generate(params, prompt, config, max_new_tokens, eos_token)``;
    here ``model`` carries both."""
    return _generate(model, prompt, max_new_tokens, generator=None, eos_token=eos_token)


def sample_generate(model, prompt, max_new_tokens, generator, temperature=1.0, top_k=0,
                    top_p=0.0, eos_token=None):
    """Stochastic decode: categorical sampling at ``temperature``,
    optionally restricted to the ``top_k`` highest logits (0 = the full
    vocabulary) and/or the nucleus of cumulative probability ``top_p``
    (0 = off; both set = their intersection). The same static-cache decode
    as :func:`greedy_generate`.

    ``generator`` is a ``torch.Generator`` on the model's device, where the
    JAX version takes a PRNG key ``rng``: the same generator state gives
    the same tokens."""
    if temperature <= 0:
        raise ValueError('temperature must be > 0; for deterministic decoding use '
                         'greedy_generate')
    if not 0.0 <= top_p <= 1.0:
        raise ValueError('top_p must be in [0, 1]; got %r' % (top_p,))
    return _generate(model, prompt, max_new_tokens, generator=generator,
                     temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos_token)


def _select(logits, generator, temperature, top_k, top_p=0.0):
    """One next-token choice from ``(B, V)`` logits: the argmax without a
    generator; else the JAX package's top-k threshold and top-p nucleus
    rules, then a draw at ``temperature``."""
    if generator is None:
        return logits.argmax(dim=-1)
    vocab = logits.shape[-1]
    neg_inf = torch.full_like(logits, -math.inf)
    if 0 < top_k < vocab:          # top_k >= V is the full vocabulary
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, neg_inf)
    if 0.0 < top_p < 1.0:
        # the smallest prefix of descending-probability tokens whose mass
        # reaches top_p: a token is inside while the mass before it is
        # < top_p (the top token always is); the threshold is the smallest
        # logit inside
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits / temperature, dim=-1)
        inside = torch.cumsum(probs, dim=-1) - probs < top_p
        kth = torch.where(inside, sorted_logits, torch.full_like(sorted_logits, math.inf))
        logits = torch.where(logits >= kth.min(dim=-1, keepdim=True).values, logits, neg_inf)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _generate(model, prompt, max_new_tokens, generator, temperature=1.0, top_k=0, top_p=0.0,
              eos_token=None, on_logits=None, on_cache=None):
    """The decode behind both entry points, under ``torch.inference_mode()``;
    the tokens come back as an ordinary tensor. ``on_logits(logits)``, when
    given, sees the ``(B, V)`` f32 logits each emitted token was chosen
    from, in order (for teacher-forced checks); ``on_cache(k_cache,
    v_cache)`` sees the static caches once they are allocated."""
    with torch.inference_mode():
        tokens = _decode(model, prompt, max_new_tokens, generator, temperature, top_k, top_p,
                         eos_token, on_logits, on_cache)
    return tokens.clone()


def _decode(model, prompt, max_new_tokens, generator, temperature, top_k, top_p, eos_token,
            on_logits, on_cache):
    c, par = model.config, model.parallel
    if c.n_experts > 0 or c.seq_axis is not None:
        raise NotImplementedError('greedy_generate/sample_generate support dense, '
                                  'unsharded-sequence configs')
    if par.pipe_axis is not None:
        raise ValueError('a pipelined model holds one stage\'s blocks and cannot decode '
                         '(nor can the JAX package decode a stacked stage tree); decode '
                         'the layered model')
    if max_new_tokens < 1:
        raise ValueError('max_new_tokens must be >= 1; got %d' % max_new_tokens)
    device = model.embed.device
    prompt = torch.as_tensor(prompt).to(device)
    b, p = prompt.shape
    if p + max_new_tokens > c.max_seq_len:
        raise ValueError('prompt (%d) + max_new_tokens (%d) exceeds max_seq_len (%d)'
                         % (p, max_new_tokens, c.max_seq_len))
    dtype = c.dtype
    blocks = [_cast_block(block, dtype) for block in model.blocks]
    lm_head = model.lm_head.to(dtype)

    def emit(logits):
        if on_logits is not None:
            on_logits(logits)
        token = _select(logits, generator, temperature, top_k, top_p).to(prompt.dtype)
        if generator is not None:
            # every rank drew from the same row and state: model-rank 0's
            # draw is theirs, bit for bit
            token = broadcast(token, par.model_group)
        return token

    # prefill: the prompt through every block over its own (P, P) causal
    # mask, its K/V (this rank's heads) written into the static cache
    k_cache = torch.zeros((len(blocks), b, c.max_seq_len, par.kv_heads, par.head_dim),
                          dtype=dtype, device=device)
    v_cache = torch.zeros_like(k_cache)
    if on_cache is not None:
        on_cache(k_cache, v_cache)
    kv_index = _kv_read_index(par, device)
    x = F.embedding(prompt.long(), model.embed).to(dtype)
    if c.pos_encoding == 'learned':
        x = x + model.pos_embed[:p].to(dtype)
    causal = torch.ones((p, p), dtype=torch.bool, device=device).tril()
    positions = torch.arange(p + max_new_tokens, device=device)
    for i, block in enumerate(blocks):
        q, k, v = _block_kv(block, x, c, par, positions[:p])
        k_cache[i, :, :p] = k
        v_cache[i, :, :p] = v
        x = x + _attend(q, k, v, causal, block.attn_out, c, par, kv_index)
        x = _block_dense_ffn_half(block, x, c, par)
    token = emit(_head_logits(model, x[:, -1], lm_head))
    done = (torch.zeros((b,), dtype=torch.bool, device=device) if eos_token is None
            else token == eos_token)
    out = [token]

    # decode: max_new_tokens - 1 steps, each feeding the token just chosen
    # (the prefill chose the first)
    for pos in range(p, p + max_new_tokens - 1):
        x = F.embedding(token.long(), model.embed).to(dtype)[:, None, :]
        if c.pos_encoding == 'learned':
            x = x + model.pos_embed[pos].to(dtype)
        for i, block in enumerate(blocks):
            q, k, v = _block_kv(block, x, c, par, positions[pos:pos + 1])
            k_cache[i, :, pos] = k[:, 0]
            v_cache[i, :, pos] = v[:, 0]
            x = x + _attend(q, k_cache[i, :, :pos + 1], v_cache[i, :, :pos + 1], None,
                            block.attn_out, c, par, kv_index)
            x = _block_dense_ffn_half(block, x, c, par)
        token = emit(_head_logits(model, x[:, 0], lm_head))
        if eos_token is not None:
            # finished rows keep emitting EOS
            token = torch.where(done, torch.full_like(token, eos_token), token)
            done = done | (token == eos_token)
        out.append(token)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def reference_greedy_generate(model, prompt, max_new_tokens):
    """Oracle: recompute the FULL forward for every new token (O(S²) a
    token); :func:`greedy_generate` matches it exactly. A split model's
    vocabulary blocks are gathered over ``'model'``."""
    tokens = torch.as_tensor(prompt).to(model.embed.device)
    group = model.parallel.model_group
    with torch.no_grad():
        for _ in range(max_new_tokens):
            logits = all_gather(transformer_forward(model, tokens)[:, -1], group, dim=-1)
            nxt = logits.argmax(dim=-1).to(tokens.dtype)
            tokens = torch.cat([tokens, nxt[:, None]], dim=1)
    return tokens
