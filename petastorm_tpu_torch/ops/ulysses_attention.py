"""Ulysses-style all-to-all sequence parallelism for attention.

Counterpart of ``petastorm_tpu/ops/ulysses_attention.py``, the second of
the two long-context strategies (the other is
:mod:`petastorm_tpu_torch.ops.ring_attention`). Two tiled all-to-alls
(:func:`petastorm_tpu_torch.parallel.collectives.all_to_all`) turn each
rank's sequence block of every head into the full sequence of a subset of
heads; each rank runs exact attention over the full sequence for its
heads (f32 scores and f32 probabilities through the PV product, as the
ring's accumulator), and the inverse all-to-all restores the sequence
split. Plain torch on each rank, as the reference is plain einsum.
"""

import torch

from petastorm_tpu_torch.parallel.mesh import SEQ_AXIS, axis


def ulysses_attention(q, k, v, mesh, axis_name=SEQ_AXIS, causal=True, scale=None,
                      batch_axis=None):
    """Exact multi-head attention with the sequence split over
    ``mesh[axis_name]``, computed head-parallel through all-to-alls.

    :param q, k, v: this rank's ``(B, S/N, H, D)`` blocks. Needs ``H %
        N == 0``: each rank takes a subset of the heads.
    :param causal: a causal mask over global positions.
    :param scale: score scale (default ``1/sqrt(D)``).
    :param batch_axis: the mesh dim B is split over, if any; the
        all-to-alls talk over ``axis_name`` only.
    :return: this rank's ``(B, S/N, H, D)`` output block.
    """
    from petastorm_tpu_torch.parallel.collectives import all_to_all
    del batch_axis  # transparent to the exchange
    group, n, _ = axis(mesh, axis_name)
    if q.shape[2] % n:
        raise ValueError(
            'ulysses_attention needs n_heads %% n_devices == 0 (got %d heads '
            'over %d devices on axis %r); use ring_attention instead'
            % (q.shape[2], n, axis_name))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # sequence-split -> head-split: split heads (dim 2), gather the sequence (dim 1)
    qh, kh, vh = (all_to_all(t, group, split_dim=2, concat_dim=1) for t in (q, k, v))
    scores = torch.einsum('bqhd,bkhd->bhqk', qh.float(), kh.float()) * scale
    if causal:
        s = qh.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float('-inf'))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum('bhqk,bkhd->bqhd', probs, vh.float()).to(q.dtype)
    # head-split -> sequence-split: split the sequence, gather the heads
    return all_to_all(out, group, split_dim=1, concat_dim=2)
