"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of ``petastorm_tpu/ops/ring_attention.py``. Each rank holds
one ``(B, S/N, H, D)`` block of q, k and v along a mesh dim; in ``N``
steps it folds the key/value block it holds into an online-softmax
accumulator (f32 scores, the causal mask over global positions) and then
passes that block to the next rank of the ring
(:func:`petastorm_tpu_torch.parallel.collectives.ppermute`), so after N
steps every query block has seen every key block. The reference's ring is
plain einsum (no Pallas), and so is this one: plain torch on each rank,
differentiable through the ring. :func:`reference_attention` is the
unsharded oracle.
"""

import torch

from petastorm_tpu_torch.parallel.mesh import SEQ_AXIS, axis


def _online_block(o, m, l, k_blk, v_blk, q, q_pos, kv_pos, causal, scale):
    """Fold one KV block into the running (output, row max, denominator)."""
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k_blk.float()) * scale
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = scores.masked_fill(~mask, float('-inf'))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # guard fully-masked rows: exp(-inf - -inf) otherwise
    safe_m = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(torch.where(torch.isneginf(scores), scores, scores - safe_m[..., None]))
    correction = torch.where(torch.isneginf(m), torch.zeros_like(m), torch.exp(m - safe_m))
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum('bhqk,bkhd->bqhd', p, v_blk.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return o_new, m_new, l_new


def ring_attention(q, k, v, mesh, axis_name=SEQ_AXIS, causal=True, scale=None,
                   batch_axis=None):
    """Exact multi-head attention with the sequence split over
    ``mesh[axis_name]``.

    :param q, k, v: this rank's ``(B, S/N, H, D)`` blocks, block i of the
        sequence on the rank at index i of ``axis_name``.
    :param causal: a causal mask over GLOBAL positions.
    :param scale: score scale (default ``1/sqrt(D)``).
    :param batch_axis: the mesh dim B is split over, if any; the ring talks
        over ``axis_name`` only, so batch sharding needs nothing here.
    :return: this rank's ``(B, S/N, H, D)`` output block, in ``q.dtype``.
    """
    del batch_axis  # transparent to the ring
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group, n_shards, my_idx = axis(mesh, axis_name)
    from petastorm_tpu_torch.parallel.collectives import ppermute
    b, s_local, h, _ = q.shape
    arange = torch.arange(s_local, device=q.device)
    q_pos = my_idx * s_local + arange
    o = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), float('-inf'), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for t in range(n_shards):
        kv_owner = (my_idx - t) % n_shards
        kv_pos = kv_owner * s_local + arange
        o, m, l = _online_block(o, m, l, k_blk, v_blk, q, q_pos, kv_pos, causal, scale)
        # rotate AFTER consuming: the block from rank j moves to j + 1
        k_blk = ppermute(k_blk, group)
        v_blk = ppermute(v_blk, group)
    # fully-masked rows have l == 0: emit zeros for them
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / denom.transpose(1, 2)[..., None]).to(q.dtype)


def reference_attention(q, k, v, causal=True, scale=None):
    """Unsharded attention: f32 scores, ``-inf`` causal mask, softmax, and
    the output cast to ``q.dtype``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float('-inf'))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum('bhqk,bkhd->bqhd', probs, v.float())
    return out.to(q.dtype)
