"""Differentiable collectives on one mesh dim's process group.

The port's counterparts of the XLA collectives the JAX package's tensor-
and sequence-parallel code relies on, each a ``torch.autograd.Function``
that runs eagerly on every rank of ``group``:

* :func:`copy_to_model` (identity forward, all-reduce backward) and
  :func:`reduce_from_model` (all-reduce forward, identity backward): the
  Megatron pair around a column-split then a row-split matmul;
* :func:`all_gather` along one dim, with a reduce-scatter backward;
* :func:`ppermute`: send to the next rank of the group, receive from the
  previous one (``lax.ppermute(perm=[(j, j + 1)])``); its backward is the
  reverse permutation;
* :func:`all_to_all` (``lax.all_to_all(tiled=True)``): split one dim over
  the ranks and concatenate the received chunks along another; its
  backward is the inverse exchange.

Gloo refuses CUDA tensors for point-to-point and all-to-all, and NCCL
refuses two ranks on one GPU, so on a gloo group a CUDA tensor goes
through a pinned host copy and back; the compute stays on the card.
``counts()`` reports the collectives run and the host seconds those
copies took (the device-to-host copy waits for the kernels queued before
it, so its seconds include that wait). A group of None or of one rank
makes every function the identity, with nothing counted.
"""

import time

import torch
import torch.distributed as dist

_calls = {}
_host_copy_seconds = 0.0


def reset_counts():
    """Zero the counts :func:`counts` reports."""
    global _host_copy_seconds
    _calls.clear()
    _host_copy_seconds = 0.0


def counts():
    """``{'calls': {name: n}, 'host_copy_seconds': s}`` since the last
    :func:`reset_counts`."""
    return {'calls': dict(_calls), 'host_copy_seconds': _host_copy_seconds}


def _trivial(group):
    return group is None or dist.get_world_size(group) == 1


def _on_host(group, t):
    return t.is_cuda and dist.get_backend(group) == 'gloo'


def _run(name, group, tensors, body):
    """Run ``body(tensors) -> outputs`` (lists of tensors) where ``group``'s
    backend can take them: CUDA tensors on a gloo group go through pinned
    host copies, timed."""
    global _host_copy_seconds
    _calls[name] = _calls.get(name, 0) + 1
    device = tensors[0].device
    if not _on_host(group, tensors[0]):
        return body([t.contiguous() for t in tensors])
    t0 = time.perf_counter()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t) for t in tensors]
    _host_copy_seconds += time.perf_counter() - t0
    outputs = body(host)
    t0 = time.perf_counter()
    outputs = [o.to(device) for o in outputs]
    _host_copy_seconds += time.perf_counter() - t0
    return outputs


def all_reduce(t, group, op=None, name='all_reduce'):
    """A reduced copy of ``t`` over ``group`` (``op`` default a sum; not
    differentiable: the building block of the functions below and of
    gradient syncs)."""
    if _trivial(group):
        return t

    def body(ts):
        out = ts[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=group)
        return [out]

    return _run(name, group, [t], body)[0]


def _peer(group, shift):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    return (dist.get_global_rank(group, (me + shift) % n),
            dist.get_global_rank(group, (me - shift) % n))


def _permute(t, group, shift):
    if _trivial(group):
        return t
    to, frm = _peer(group, shift)

    def body(ts):
        out = torch.empty_like(ts[0])
        reqs = [dist.isend(ts[0], to, group=group), dist.irecv(out, frm, group=group)]
        for req in reqs:
            req.wait()
        return [out]

    return _run('ppermute', group, [t], body)[0]


def _exchange(t, group, split_dim, concat_dim):
    """``lax.all_to_all(tiled=True)``: chunk i of ``split_dim`` goes to
    rank i; the chunk from rank i lands at block i of ``concat_dim``."""
    if _trivial(group):
        return t
    n = dist.get_world_size(group)
    if t.shape[split_dim] % n:
        raise ValueError('all_to_all: dim %d of size %d does not split over %d ranks'
                         % (split_dim, t.shape[split_dim], n))
    moved = t.movedim(split_dim, 0)

    def body(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0], group=group)
        return [out]

    out = _run('all_to_all', group, [moved], body)[0]
    chunk = out.shape[0] // n
    blocks = out.reshape(n, chunk, *out.shape[1:]).movedim(1, split_dim + 1)
    return torch.cat(blocks.unbind(0), dim=concat_dim)


def _reduce_scatter(t, group, dim):
    """Chunk i of ``t``'s ``dim`` summed over ``group``, on rank i: an
    all-to-all sends each rank its chunk (the bytes of a reduce-scatter;
    gloo has no reduce-scatter) and the received copies are added here."""
    n = dist.get_world_size(group)
    moved = t.movedim(dim, 0)

    def body(ts):
        out = torch.empty_like(ts[0])
        dist.all_to_all_single(out, ts[0], group=group)
        return [out]

    out = _run('reduce_scatter', group, [moved], body)[0]
    return out.reshape(n, out.shape[0] // n, *out.shape[1:]).sum(0).movedim(0, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, name='copy_to_model'), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, name='reduce_from_model')

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)

        def body(ts):
            parts = [torch.empty_like(ts[0]) for _ in range(n)]
            dist.all_gather(parts, ts[0], group=group)
            return parts

        return torch.cat(_run('all_gather', group, [x], body), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _exchange(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.concat_dim, ctx.split_dim), None, None, None


def copy_to_model(x, group):
    """Identity forward; the backward sums the gradient over ``group``
    (the input of a column-split matmul)."""
    return x if _trivial(group) else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Sum over ``group`` forward; identity backward (the output of a
    row-split matmul)."""
    return x if _trivial(group) else _ReduceFromModel.apply(x, group)


def all_gather(x, group, dim):
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward reduce-scatters the gradient (this rank's chunk, summed over
    the group). No path of the port runs it yet: it is kept beside the
    others as the gather the JAX package's collectives include."""
    return x if _trivial(group) else _AllGather.apply(x, group, dim)


def ppermute(x, group, shift=1):
    """Send ``x`` to the rank ``shift`` ahead in ``group`` and return the
    one received from the rank ``shift`` behind."""
    return x if _trivial(group) else _PPermute.apply(x, group, shift)


def all_to_all(x, group, split_dim, concat_dim):
    """The tiled all-to-all: ``x`` split into ``group``'s size chunks along
    ``split_dim``, chunk i sent to rank i, and the received chunks
    concatenated in rank order along ``concat_dim``."""
    return x if _trivial(group) else _AllToAll.apply(x, group, split_dim, concat_dim)
