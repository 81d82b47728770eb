"""Dense attention oracle in the framework's ``(B, S, H, D)`` layout.

Counterpart of ``reference_attention`` in ``petastorm_tpu/ops/ring_attention.py``.
The ring and Ulysses sequence-parallel strategies are not ported yet
(``ROADMAP.md`` Queue 1 item 8).
"""

import torch


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
