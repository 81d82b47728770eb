"""Pipeline parallelism: GPipe-style microbatched stage execution.

Counterpart of ``petastorm_tpu/parallel/pipeline.py``. Each rank of the
mesh dim ``'pipe'`` holds one stage's weights (:func:`shard_stage_params`
cuts a stacked ``(n_stages, ...)`` tree to this rank's stage). The batch,
replicated over the dim, splits into ``n_microbatches``; stage 0 takes
them in order, every stage passes each finished microbatch to the next
one, and the GPipe schedule runs ``n_microbatches + n_stages - 1`` ticks
with each stage busy on the ticks where a microbatch is inside it. The
port runs that schedule eagerly: a stage receives microbatch ``m`` from
the previous stage, computes it and sends it on, so it idles on the
bubble ticks instead of computing zeros (the results are the same). The
last stage's output reaches every stage.

The schedule is one ``torch.autograd.Function``: its forward keeps each
(stage, microbatch) graph and its backward runs the reverse schedule,
each stage receiving its output's gradient from the next stage (the last
one takes the output's gradient, once) and sending its input's gradient
to the previous one. The stage weights' gradients accumulate into their
``.grad`` there, so train through ``loss.backward()`` (not
``torch.autograd.grad``). The batch's gradient reaches every stage, as the
reference's replicated input gets its whole cotangent: a layer before the
pipeline (the embedding) and one after it (the head) train on every stage
with no sum over ``'pipe'``.
"""

import torch
from torch.utils._pytree import tree_leaves, tree_map

from petastorm_tpu_torch.parallel.collectives import (
    all_reduce, recv_from, send_to, size_and_rank,
)
from petastorm_tpu_torch.parallel.mesh import PIPE_AXIS, axis


def pipeline_supported():
    """Whether :func:`pipeline_apply` runs here: always (the reference
    gates on its tracer's replication tracking, which eager autograd does
    not need)."""
    return True


def shard_stage_params(stage_params, mesh, axis_name=PIPE_AXIS):
    """This rank's stage of a pytree (dicts, lists) whose leaves carry a
    leading ``n_stages`` axis: each leaf's entry at the rank's index on
    ``axis_name``, as a tensor."""
    _, n_stages, stage = axis(mesh, axis_name)
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError('a stage leaf of leading size %d on the %d ranks of mesh dim %r'
                             % (leaf.shape[0], n_stages, axis_name))
    return tree_map(lambda leaf: torch.as_tensor(leaf[stage]).clone(), stage_params)


class _Schedule:
    """One call's GPipe schedule on this rank: the forward keeps each
    microbatch's graph, the backward walks them in reverse. ``sizes``
    holds each microbatch's rows; one of none is computed (the stage may
    run collectives with other ranks' parts of it) but never sent."""

    def __init__(self, stage_fn, stage, group, sizes, with_aux):
        self.stage_fn, self.stage, self.group = stage_fn, stage, group
        self.sizes, self.n_micro, self.with_aux = sizes, len(sizes), with_aux
        self.n_stages, self.index = size_and_rank(group)

    def forward(self, x, keep_graph):
        last = self.index == self.n_stages - 1
        chunks = x.detach().split(self.sizes)
        self.graphs, outs, sends = [], [], []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for m in range(self.n_micro):
            if self.index == 0 or not self.sizes[m]:
                a = chunks[m].detach()
            else:
                a = recv_from(chunks[m].shape, x.dtype, x.device, self.group, self.index - 1)
            with torch.set_grad_enabled(keep_graph):
                a = a.requires_grad_(keep_graph)
                result = self.stage_fn(self.stage, a, m)
                y, aux = result if self.with_aux else (result, None)
            if y.shape != a.shape or y.dtype != a.dtype:
                raise ValueError('a stage must return its input\'s shape and dtype; got %s %s '
                                 'for %s %s' % (tuple(y.shape), y.dtype, tuple(a.shape),
                                                a.dtype))
            if aux is not None:
                aux_total = aux_total + aux.detach().float()
            if keep_graph:
                self.graphs.append((a, y, aux))
            if last:
                outs.append(y.detach())
            elif self.sizes[m]:
                sends.append(send_to(y.detach(), self.group, self.index + 1))
        for done in sends:
            done()
        out = torch.cat(outs) if last else torch.zeros_like(x)
        out = all_reduce(out.reshape(x.shape), self.group, name='pipe_out')
        aux_total = all_reduce(aux_total, self.group, name='pipe_aux') / self.n_micro
        return out, aux_total

    def backward(self, g_out, g_aux, need_input_grad):
        last = self.index == self.n_stages - 1
        g_chunks = g_out.split(self.sizes)
        aux_coef = g_aux / self.n_micro
        grads, sends = [None] * self.n_micro, []
        for m in reversed(range(self.n_micro)):
            a, y, aux = self.graphs[m]
            if last or not self.sizes[m]:
                gy = g_chunks[m]
            else:
                gy = recv_from(y.shape, y.dtype, y.device, self.group, self.index + 1)
            outputs, cotangents = [y], [gy.to(y.dtype)]
            if aux is not None and aux.requires_grad:
                outputs.append(aux)
                cotangents.append(aux_coef.to(aux.dtype).reshape(aux.shape))
            torch.autograd.backward(outputs, cotangents)
            ga = a.grad if a.grad is not None else torch.zeros_like(a)
            if self.index > 0 and self.sizes[m]:
                sends.append(send_to(ga, self.group, self.index - 1))
            else:
                grads[m] = ga
        for done in sends:
            done()
        self.graphs = []
        if not need_input_grad:
            return None
        gx = torch.cat(grads) if self.index == 0 else torch.zeros_like(g_out)
        return all_reduce(gx.reshape(g_out.shape), self.group, name='pipe_grad')


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, schedule, keep_graph):
        ctx.schedule = schedule
        return schedule.forward(x, keep_graph)

    @staticmethod
    def backward(ctx, g_out, g_aux):
        return ctx.schedule.backward(g_out, g_aux, ctx.needs_input_grad[0]), None, None, None


def run_pipeline(stage_fn, stage, x, group, n_microbatches, with_aux=False):
    """The GPipe schedule of ``stage_fn(stage, microbatch, index)`` over
    the ranks of ``group`` on this rank's ``x`` (its rows and positions):
    ``(output, aux)``, the output the last stage's on every stage and
    ``aux`` the stages' scalars summed over (stage, microbatch) pairs and
    divided by the microbatch count (zero without ``with_aux``).
    ``n_microbatches`` is a count that divides ``x``'s rows evenly, or the
    list of each microbatch's rows (a zero among them: this rank holds
    none of that one)."""
    if isinstance(n_microbatches, int):
        if x.shape[0] % n_microbatches:
            raise ValueError('batch %d not divisible into %d microbatches'
                             % (x.shape[0], n_microbatches))
        n_microbatches = [x.shape[0] // n_microbatches] * n_microbatches
    schedule = _Schedule(stage_fn, stage, group, list(n_microbatches), with_aux)
    keep_graph = torch.is_grad_enabled()
    # the stage weights train through this function's backward, so its
    # output needs a gradient even when x needs none: the anchor asks for it
    anchor = torch.empty(0, device=x.device, requires_grad=keep_graph)
    return _GPipe.apply(x, anchor, schedule, keep_graph)


class _GatherReplicated(torch.autograd.Function):
    """The seq ranks' blocks concatenated along dim 1; the output is used
    alike on every rank, so each block's gradient is that rank's slice."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.index, ctx.width = index, x.shape[1]
        table = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        table[index] = x
        table = all_reduce(table, group, name='seq_gather')
        return torch.cat(table.unbind(0), dim=1)

    @staticmethod
    def backward(ctx, g):
        start = ctx.index * ctx.width
        return g[:, start:start + ctx.width], None, None, None


def pipeline_apply(stage_fn, stage, x, mesh, axis_name=PIPE_AXIS, n_microbatches=None,
                   with_aux=False, seq_axis=None):
    """Apply the ``n_stages`` stages of ``mesh[axis_name]`` in order to ``x``.

    :param stage_fn: ``(stage, microbatch) -> microbatch``: one stage's
        computation, its output shaped and typed as its input. With
        ``with_aux`` it returns ``(microbatch, scalar)`` and the call
        returns ``(output, aux)``, ``aux`` the scalars summed over stages
        and averaged over microbatches (bubble ticks excluded).
    :param stage: this rank's stage (see :func:`shard_stage_params`),
        passed to ``stage_fn`` as is.
    :param x: ``(batch, ...)`` input, the same on every stage.
    :param n_microbatches: pipeline chunking (default ``n_stages``); must
        divide the batch.
    :param seq_axis: a second mesh dim that splits ``x``'s dim 1 (the
        sequence): ``stage_fn`` sees this rank's block and runs any
        collective attention over ``seq_axis`` itself; ``x.shape[1]`` must
        divide over it. Each rank's gradients (the stage's weights' and
        ``x``'s) are then its block's part, as the port's other
        sequence-split functions give them: sum them over ``seq_axis``
        (:meth:`~petastorm_tpu_torch.models.transformer.Parallel.sync_grads`
        does for a model).
    :return: ``(batch, ...)`` output on every stage, equal to applying the
        stages in order; plus the aux scalar with ``with_aux``.
    """
    group, n_stages, _ = axis(mesh, axis_name)
    if n_microbatches is None:
        n_microbatches = n_stages
    if x.shape[0] % n_microbatches:
        raise ValueError('batch %d not divisible into %d microbatches'
                         % (x.shape[0], n_microbatches))
    seq_group, n_seq, seq_index = (axis(mesh, seq_axis) if seq_axis is not None
                                   else (None, 1, 0))
    if seq_axis is not None:
        if x.dim() < 2 or x.shape[1] % n_seq:
            raise ValueError('x dim 1 (%s) not divisible over %d seq shards'
                             % (tuple(x.shape[1:2]) or 'absent', n_seq))
        width = x.shape[1] // n_seq
        x = x[:, seq_index * width:(seq_index + 1) * width]
    out, aux = run_pipeline(lambda p, a, m: stage_fn(p, a), stage, x, group, n_microbatches,
                            with_aux)
    if n_seq > 1:
        out = _GatherReplicated.apply(out, seq_group, n_seq, seq_index)
    return (out, aux) if with_aux else out


def reference_pipeline(stage_fn, stage_params, x, with_aux=False):
    """Sequential oracle: apply each stage of the stacked tree (leaves
    with a leading ``n_stages`` axis) in order on the whole batch; with
    ``with_aux`` the stages' scalars summed."""
    n_stages = tree_leaves(stage_params)[0].shape[0]
    aux_total = torch.zeros((), dtype=torch.float32)
    for s in range(n_stages):
        params = tree_map(lambda leaf: leaf[s], stage_params)
        if with_aux:
            x, aux = stage_fn(params, x)
            aux_total = aux_total + aux.float()
        else:
            x = stage_fn(params, x)
    return (x, aux_total) if with_aux else x
