"""What each spawned rank of the port's multi-rank tests runs.

A module, not a test file (see ``tests/torch_ranks.py``): every function
here is a ``body(rank, world, payload)`` that builds a
:mod:`petastorm_tpu_torch.parallel.mesh` mesh on the CPU over the live
gloo group, runs the port, and returns plain tensors and numbers for the
test process to hold against the JAX package. Payloads carry numpy
weights and inputs made from one seed; nothing here imports JAX.
"""

import torch


def _config(kw):
    from petastorm_tpu_torch.models.transformer import TransformerConfig
    kw = dict(kw)
    kw['dtype'] = getattr(torch, kw.pop('dtype', 'float32'))
    return TransformerConfig(**kw)


def _vit_config(kw):
    from petastorm_tpu_torch.models.vit import ViTConfig
    kw = dict(kw)
    kw['dtype'] = getattr(torch, kw.pop('dtype', 'float32'))
    return ViTConfig(**kw)


def _grads(model):
    return {name: p.grad.detach().clone() for name, p in model.named_parameters()}


def _data_rows(t, mesh):
    """This rank's rows of a global batch: block ``i`` of ``'data'``."""
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, axis
    _, n, i = axis(mesh, DATA_AXIS)
    rows = t.shape[0] // n
    return t[i * rows:(i + 1) * rows]


def _coordinate(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares type and text
        return type(e).__name__, str(e)
    return None


def mesh_body(rank, world, payload):
    """Meshes over the world and the reference's error cases."""
    from petastorm_tpu_torch.parallel import mesh as pm
    out = {'meshes': {}, 'errors': {}}
    for label, (kind, args) in payload['meshes'].items():
        make = pm.make_mesh if kind == 'make_mesh' else pm.make_named_mesh
        m = make(*args, device_type='cpu')
        out['meshes'][label] = {
            'names': list(m.mesh_dim_names), 'grid': m.mesh.tolist(),
            'coordinate': None if m.get_coordinate() is None else list(m.get_coordinate()),
            'data_sharding': (_error(lambda: pm.data_sharding(m, 2))
                              or [repr(p) for p in pm.data_sharding(m, 2)]),
            'replicated': [repr(p) for p in pm.replicated(m)],
            'group_sizes': [m.size(d) for d in range(m.ndim)]}
    for label, (kind, args) in payload['errors'].items():
        make = pm.make_mesh if kind == 'make_mesh' else pm.make_named_mesh
        out['errors'][label] = _error(lambda: make(*args, device_type='cpu'))
    out['collectives'] = collectives_part(rank, payload['collectives'])
    return out


def tp_body(rank, world, payload):
    """dp x tp: each LM case's loss (the global batch's), this rank's
    logits block and its gradient shards, and the masked loss with its
    gradient shards; the ViT's the same way."""
    from petastorm_tpu_torch.models import transformer as tt
    from petastorm_tpu_torch.models import vit as tv
    from petastorm_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(data=payload['data'], model=payload['model'], device_type='cpu')
    out = {'coordinate': _coordinate(mesh), 'lm': {}, 'vit': {}}
    for name, case in payload['lm'].items():
        config = _config(case['config'])
        model = tt.Transformer(config, mesh)
        model.load_state_dict(tt.params_from_jax(case['params'], mesh, config))
        tokens = _data_rows(torch.from_numpy(case['tokens']), mesh)
        with torch.no_grad():
            logits = tt.transformer_forward(model, tokens[:, :-1])
        step = tt.transformer_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
        loss = step(tokens)
        out['lm'][name] = {'loss': float(loss), 'logits': logits, 'grads': _grads(model),
                           'shapes': {k: tuple(v.shape) for k, v in model.state_dict().items()}}
        masked = tt.transformer_masked_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0))
        out['lm'][name]['masked_loss'] = float(masked(
            tokens, _data_rows(torch.from_numpy(case['lengths']), mesh)))
        out['lm'][name]['masked_grads'] = _grads(model)
    for name, case in payload['vit'].items():
        config = _vit_config(case['config'])
        model = tv.ViT(config, mesh)
        model.load_state_dict(tv.vit_params_from_jax(case['params'], mesh, config))
        images = _data_rows(torch.from_numpy(case['images']), mesh)
        labels = _data_rows(torch.from_numpy(case['labels']), mesh)
        with torch.no_grad():
            logits = tv.vit_forward(model, images)
        step = tv.vit_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
        loss = step(images, labels)
        out['vit'][name] = {'loss': float(loss), 'logits': logits, 'grads': _grads(model)}
    return out


def seq_ops_body(rank, world, payload):
    """Ring and Ulysses attention alone: each case's output block, and the
    Ulysses head-count error."""
    from petastorm_tpu_torch.ops.ring_attention import ring_attention
    from petastorm_tpu_torch.ops.ulysses_attention import ulysses_attention
    from petastorm_tpu_torch.parallel.mesh import axis, make_named_mesh
    out = {'cases': {}, 'errors': {}}
    for label, mesh_axes in payload['meshes'].items():
        mesh = make_named_mesh(mesh_axes, device_type='cpu')
        _, n, i = axis(mesh, 'seq')
        batch_axis = 'data' if 'data' in mesh_axes else None
        for name, case in payload['cases'].items():
            q, k, v = (_data_rows(torch.from_numpy(case[x]), mesh) for x in 'qkv')
            s = q.shape[1] // n
            q, k, v = (t[:, i * s:(i + 1) * s] for t in (q, k, v))
            for impl, fn in (('ring', ring_attention), ('ulysses', ulysses_attention)):
                out['cases'][label, name, impl] = fn(q, k, v, mesh, causal=case['causal'],
                                                     batch_axis=batch_axis)
        q = torch.zeros((1, 2 * n, 3, 4))
        out['errors'][label] = _error(lambda: ulysses_attention(q, q, q, mesh))
        out['coordinate', label] = _coordinate(mesh)
    return out


def seq_lm_body(rank, world, payload):
    """``TransformerConfig(seq_axis=)`` training: each case's loss (its
    data rows, over the whole sequence), masked loss and gradients."""
    from petastorm_tpu_torch.models import transformer as tt
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    mesh = make_named_mesh(payload['mesh'], device_type='cpu')
    out = {'coordinate': _coordinate(mesh), 'cases': {}}
    for name, case in payload['cases'].items():
        config = _config(case['config'])
        model = tt.Transformer(config, mesh)
        model.load_state_dict(tt.params_from_jax(case['params'], mesh, config))
        tokens = _data_rows(torch.from_numpy(case['tokens']), mesh)
        lengths = _data_rows(torch.from_numpy(case['lengths']), mesh)
        step = tt.transformer_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0))
        loss = step(tokens)
        result = {'loss': float(loss), 'grads': _grads(model)}
        masked = tt.transformer_masked_train_step(
            model, torch.optim.SGD(model.parameters(), lr=0.0))
        result['masked_loss'] = float(masked(tokens, lengths))
        result['masked_grads'] = _grads(model)
        out['cases'][name] = result
    return out


def _patched_init(payload):
    """``init_transformer`` replaced by one that loads the JAX example's
    seed-0 weights (``payload['params']``), split over the mesh."""
    from petastorm_tpu_torch.models import transformer as tt

    def init_from_jax(seed, config, device=None, mesh=None):
        assert seed == 0
        model = tt.Transformer(config, mesh)
        model.load_state_dict(tt.params_from_jax(payload['params'], mesh, config))
        return model.to(device)

    tt.init_transformer = init_from_jax


def pretrain_example_body(rank, world, payload):
    """``pretrain_example(model_axis=)`` from the JAX example's weights;
    then, on ``payload['aligned_url']`` (a row-group a batch), an unbroken
    run of ``2 * half`` steps, and a run checkpointed at ``half`` steps and
    resumed from that checkpoint in fresh objects."""
    from petastorm_tpu_torch.examples import lm_pretrain
    _patched_init(payload)
    kw = dict(model_axis=payload['model_axis'], device='cpu', reader_pool_type='dummy')
    result = lm_pretrain.pretrain_example(payload['url'], steps=payload['steps'], **kw)
    out = {'losses': result['losses'], 'batch_devices': result['batch_devices']}
    half, url = payload['half'], payload['aligned_url']
    out['unbroken'] = lm_pretrain.pretrain_example(url, steps=2 * half, **kw)['losses']
    kw.update(checkpoint_dir=payload['checkpoint_dir'], checkpoint_every=half)
    out['head'] = lm_pretrain.pretrain_example(url, steps=half, **kw)['losses']
    resumed = lm_pretrain.pretrain_example(url, steps=2 * half, **kw)
    out['tail'], out['start_step'] = resumed['losses'], resumed['start_step']
    return out


def long_context_body(rank, world, payload):
    """``pretrain_long_context`` from the JAX example's weights: every
    step's loss and what it prints."""
    import contextlib
    import io

    from petastorm_tpu_torch.examples import long_context
    from petastorm_tpu_torch.models import transformer as tt
    _patched_init(payload)
    losses = []
    make_step = tt.transformer_train_step

    def recording_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(tokens):
            loss = step(tokens)
            losses.append(float(loss))
            return loss
        return run

    tt.transformer_train_step = recording_step
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        final = long_context.pretrain_long_context(
            payload['url'], batch_size=payload['batch_size'], steps=payload['steps'],
            seq_len=payload['seq_len'], seq_shards=payload['seq_shards'], device='cpu',
            reader_pool_type='dummy')
    return {'losses': losses, 'final': final, 'printed': printed.getvalue()}


def to_numpy(tree):
    """Tensors in a nested result as numpy arrays (for the test side)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return tree


def loader_order_body(rank, world, payload):
    """The ``id`` column of each batch a loader over ``payload['mesh']``
    (whose ``'seq'`` dim replicates a batch) gives this rank, two epochs:
    from a thread pool of four workers, which finish row-groups in any
    order, and from the dummy pool, which reads them in ventilation
    order."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, make_named_mesh
    mesh = make_named_mesh(payload['mesh'], device_type='cpu')
    out = {'coordinate': _coordinate(mesh)}
    for pool, kw in (('thread', dict(workers_count=4)), ('dummy', {})):
        with make_torch_loader(payload['url'], 4, mesh, (DATA_AXIS,), fields=['^id$'],
                               num_epochs=2, shuffle_row_groups=True, device='cpu',
                               reader_pool_type=pool, **kw) as loader:
            out[pool] = [b['id'].tolist() for b in loader]
    return out


def seq_body(rank, world, payload):
    """:func:`seq_ops_body` on ``payload['ops']``, :func:`seq_lm_body` on
    ``payload['lm']`` and :func:`loader_order_body` on
    ``payload['loader']``, in one spawn."""
    return {'ops': seq_ops_body(rank, world, payload['ops']),
            'lm': seq_lm_body(rank, world, payload['lm']),
            'loader': loader_order_body(rank, world, payload['loader'])}


#: the collectives :func:`collectives_part` runs: (name, forward, x's shape
#: over a group of n ranks, the output's)
COLLECTIVES = {
    'copy_to_model': (lambda c, x, g: c.copy_to_model(x, g), lambda n: (2, 3, 4),
                      lambda n: (2, 3, 4)),
    'reduce_from_model': (lambda c, x, g: c.reduce_from_model(x, g), lambda n: (2, 3, 4),
                          lambda n: (2, 3, 4)),
    'all_gather': (lambda c, x, g: c.all_gather(x, g, 1), lambda n: (2, 3, 4),
                   lambda n: (2, 3 * n, 4)),
    'ppermute': (lambda c, x, g: c.ppermute(x, g), lambda n: (2, 3, 4), lambda n: (2, 3, 4)),
    'all_to_all': (lambda c, x, g: c.all_to_all(x, g, 0, 2), lambda n: (2 * n, 3, 4),
                   lambda n: (2, 3, 4 * n)),
}


def collectives_part(rank, payload):
    """Each collective forward and backward on each group of
    ``payload``'s meshes: its output and the gradient of ``(out *
    g).sum()`` with this rank's ``x`` and ``g`` from the payload."""
    from petastorm_tpu_torch.parallel import collectives
    from petastorm_tpu_torch.parallel import mesh as pm
    out = {}
    for label, (kind, args, dim) in payload.items():
        make = pm.make_mesh if kind == 'make_mesh' else pm.make_named_mesh
        group = pm.axis(make(*args, device_type='cpu'), dim)[0]
        for name, (fn, _, _) in COLLECTIVES.items():
            x = torch.from_numpy(payload_inputs(label, name, rank)[0]).requires_grad_()
            g = torch.from_numpy(payload_inputs(label, name, rank)[1])
            y = fn(collectives, x, group)
            (y * g).sum().backward()
            out[label, name] = (y.detach(), x.grad)
    return out


def payload_inputs(label, name, rank):
    """The ``x`` and ``g`` rank ``rank`` feeds collective ``name`` on the
    group of ``label`` (seeded, so the test side makes the same)."""
    import zlib

    import numpy as np
    n = {'whole-world': 4, 'model-pairs': 2, 'data-pairs': 2}[label]
    rng = np.random.RandomState(zlib.crc32(('%s/%s/%d' % (label, name, rank)).encode()))
    _, x_shape, y_shape = COLLECTIVES[name]
    return (rng.randn(*x_shape(n)).astype(np.float32),
            rng.randn(*y_shape(n)).astype(np.float32))


# -- expert parallelism, the routing scope and the pipeline -------------------------

_MESHES = {}


def _named_mesh(axes):
    """One mesh per layout for the whole spawn (every rank builds the same
    ones in the same order, as the group creation needs)."""
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = make_named_mesh(dict(axes), device_type='cpu')
    return _MESHES[key]


def _sum_over(t, mesh, names):
    """``t`` summed over the mesh dims ``names`` (the sync a standalone
    layer's replicated weights need)."""
    from petastorm_tpu_torch.parallel.collectives import all_reduce
    from petastorm_tpu_torch.parallel.mesh import axis
    for name in names:
        t = all_reduce(t, axis(mesh, name)[0])
    return t


def lm_case(case, mesh):
    """One LM case, layered or pipelined: this rank's logits block and aux
    from the forward, then one step (AdamW at ``case['lr']``, default 0):
    the loss, the synced gradients and the parameters after the step."""
    from petastorm_tpu_torch.models import transformer as tt
    config = _config(case['config'])
    m = case.get('n_microbatches')
    if case.get('pipelined'):
        model = tt.PipelinedTransformer(config, mesh)
        model.load_state_dict(tt.pipelined_params_from_jax(case['params'], mesh, config))

        def forward(t):
            return tt.pipelined_transformer_forward_with_aux(model, t, m)

        def make_step(opt):
            return tt.pipelined_transformer_train_step(model, opt, n_microbatches=m)
    else:
        model = tt.Transformer(config, mesh)
        model.load_state_dict(tt.params_from_jax(case['params'], mesh, config))

        def forward(t):
            return tt.transformer_forward_with_aux(model, t)

        def make_step(opt):
            return tt.transformer_train_step(model, opt)
    tokens = _data_rows(torch.from_numpy(case['tokens']), mesh)
    with torch.no_grad():
        logits, aux = forward(tokens[:, :-1])
    loss = make_step(tt.adamw(model, case.get('lr', 0.0)))(tokens)
    return {'loss': float(loss), 'aux': float(aux), 'logits': logits, 'grads': _grads(model),
            'params': {k: v.detach().clone() for k, v in model.state_dict().items()},
            'first_layer': getattr(model, 'first_layer', 0)}


def moe_layer_case(case, mesh):
    """The MoE layer alone on ``mesh``: rows split over ``'data'`` (routed
    as one array), experts over ``'expert'``, and with ``case['seq_axis']``
    the sequence over ``'seq'`` under ``moe_forward(seq_axis=)``. Returns
    ``y`` and ``x``'s gradient for this rank's block, the aux, and the
    weights' gradients of ``(y * g).sum() + aux`` summed over ``'data'``
    and ``'seq'``."""
    from petastorm_tpu_torch.models import moe as tm
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, axis
    cfg = tm.MoEConfig(dtype=torch.float32, **case['config'])
    layer = tm.MoE(cfg, mesh)
    layer.load_state_dict({k: layer.shard(k, torch.from_numpy(v))
                           for k, v in case['params'].items()})
    x, g = (_data_rows(torch.from_numpy(case[k]), mesh) for k in ('x', 'g'))
    seq_axis = case.get('seq_axis')
    if seq_axis is not None:
        _, n, i = axis(mesh, seq_axis)
        width = x.shape[1] // n
        x, g = (t[:, i * width:(i + 1) * width] for t in (x, g))
    data_group, dp, _ = axis(mesh, DATA_AXIS)
    split = tm.TokenSplit(rows=data_group if dp > 1 else None)
    x = x.clone().requires_grad_()
    y, aux = tm.moe_forward(layer, x, cfg, capacity=case.get('capacity'), seq_axis=seq_axis,
                            mesh=mesh, split=split)
    ((y * g).sum() + aux).backward()
    names = [n for n in (DATA_AXIS, seq_axis) if n is not None]
    return {'y': y.detach(), 'aux': float(aux), 'x_grad': x.grad,
            'grads': {k: _sum_over(p.grad, mesh, names) for k, p in layer.named_parameters()}}


def pipe_apply_case(case, mesh):
    """``pipeline_apply`` on stacked numpy weights: the output, the aux,
    this stage's weights' gradients and the input's (and an upstream
    weight's) gradient of ``(out ** 2).sum() + aux``, summed over the
    sequence dim when it splits."""
    import torch.nn.functional as F

    from petastorm_tpu_torch.parallel.pipeline import pipeline_apply, shard_stage_params
    stage = shard_stage_params({k: torch.from_numpy(v) for k, v in case['params'].items()},
                               mesh)
    for leaf in stage.values():
        leaf.requires_grad_()
    kind, with_aux = case['kind'], case.get('with_aux', False)

    def stage_fn(p, x):
        if kind == 'multilayer':
            for i in range(p['w'].shape[0]):
                x = torch.tanh(x @ p['w'][i])
        else:
            x = F.gelu(x @ p['w'] + p['b'], approximate='tanh')
        return (x, x.mean() ** 2) if with_aux else x

    x = torch.from_numpy(case['x']).requires_grad_(case.get('input_grad', True))
    h = x
    up = None
    if 'w_up' in case:
        up = torch.from_numpy(case['w_up']).requires_grad_()
        h = torch.tanh(x @ up)
    out = pipeline_apply(stage_fn, stage, h, mesh, n_microbatches=case.get('n_microbatches'),
                         with_aux=with_aux, seq_axis=case.get('seq_axis'))
    out, aux = out if with_aux else (out, torch.zeros(()))
    ((out ** 2).sum() + aux).backward()
    names = [case['seq_axis']] if case.get('seq_axis') else []
    return {'out': out.detach(), 'aux': float(aux),
            'grads': {k: _sum_over(v.grad, mesh, names) for k, v in stage.items()},
            'x_grad': _sum_over(x.grad, mesh, names),
            'up_grad': None if up is None else _sum_over(up.grad, mesh, names)}


def _run_case(case):
    mesh = _named_mesh(case['mesh'])
    kind = case['kind']
    if kind == 'lm':
        out = lm_case(case, mesh)
    elif kind == 'moe_layer':
        out = moe_layer_case(case, mesh)
    else:
        out = pipe_apply_case(case, mesh)
    out['coordinate'] = _coordinate(mesh)
    return out


def _error_case(case):
    """The error a refused call raises: a pipelined model whose layers do
    not divide over the stages, a pipeline over an indivisible batch or
    sequence, a pipelined transformer's batch that does not divide into
    its microbatches, an expert count that does not divide."""
    from petastorm_tpu_torch.models import moe as tm
    from petastorm_tpu_torch.models import transformer as tt
    from petastorm_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = _named_mesh(case['mesh'])
    what = case['what']
    if what == 'layers':
        return _error(lambda: tt.init_pipelined_transformer(0, _config(case['config']), mesh,
                                                            device='cpu'))
    if what == 'experts':
        return _error(lambda: tm.MoE(tm.MoEConfig(n_experts=case['n_experts']), mesh))
    if what == 'microbatches':
        return _error(lambda: pipeline_apply(lambda p, x: x, None, torch.zeros((7, 8)), mesh,
                                             n_microbatches=3))
    if what == 'seq-width':
        return _error(lambda: pipeline_apply(lambda p, x: x, None, torch.zeros((8, 5, 16)), mesh,
                                             seq_axis='seq'))
    model = tt.init_pipelined_transformer(0, _config(case['config']), mesh, device='cpu')
    tokens = _data_rows(torch.zeros(case['batch'], 9, dtype=torch.long), mesh)
    return _error(lambda: tt.pipelined_transformer_loss(model, tokens, case['n_microbatches']))


def resume_case(case, mesh):
    """A model split over ``mesh`` trained ``2 * half`` steps on a loader
    that replicates every batch, unbroken; then ``half`` steps, a
    ``TrainCheckpointer`` save, fresh model, optimizer and loader restored
    from it, and ``half`` more. Returns both runs' batch ids and
    losses."""
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.models import transformer as tt
    config = _config(case['config'])
    pipelined = case.get('pipelined', False)

    def fresh():
        if pipelined:
            model = tt.init_pipelined_transformer(1, config, mesh, device='cpu')
            optimizer = tt.adamw(model, 1e-2)
            step = tt.pipelined_transformer_train_step(model, optimizer, n_microbatches=2)
        else:
            model = tt.init_transformer(1, config, 'cpu', mesh=mesh)
            optimizer = tt.adamw(model, 1e-2)
            step = tt.transformer_train_step(model, optimizer)
        return model, optimizer, step

    def tokens(ids):
        return torch.from_numpy(case['table'][ids.numpy()])

    def loader():
        return make_torch_loader(case['url'], 4, mesh, (), fields=['^id$'], num_epochs=1,
                                 device='cpu', reader_pool_type='dummy')

    def train(step, batches, n, out):
        for _ in range(n):
            ids = next(batches)['id']
            out['ids'].append(ids.tolist())
            out['losses'].append(float(step(tokens(ids))))

    unbroken = {'ids': [], 'losses': []}
    _, _, step = fresh()
    with loader() as ld:
        train(step, iter(ld), 2 * case['half'], unbroken)
    resumed = {'ids': [], 'losses': []}
    ckpt = TrainCheckpointer(case['dir'])
    model, optimizer, step = fresh()
    with loader() as ld:
        train(step, iter(ld), case['half'], resumed)
        ckpt.save(case['half'], {'model': model, 'optimizer': optimizer}, ld)
    model, optimizer, step = fresh()
    ckpt.restore_state({'model': model, 'optimizer': optimizer})
    with loader() as ld:
        ckpt.restore_loader(ld)
        train(step, iter(ld), case['half'], resumed)
    import os
    files = sorted(os.listdir(os.path.join(case['dir'], str(case['half']), 'train_state')))
    return {'unbroken': unbroken, 'resumed': resumed, 'files': files}


def parallel_cases_body(rank, world, payload):
    """Every case of ``payload['cases']`` (LM, MoE layer or
    ``pipeline_apply``), the refused calls of ``payload['errors']``, the
    loaders of ``payload['loaders']`` (:func:`loader_order_body`) and the
    resumes of ``payload['resumes']``, in one spawn."""
    out = {'cases': {name: _run_case(case) for name, case in payload['cases'].items()},
           'errors': {name: _error_case(case) for name, case in payload.get('errors', {}).items()},
           'loaders': {}, 'resumes': {}}
    for name, case in payload.get('loaders', {}).items():
        out['loaders'][name] = loader_order_body(rank, world, case)
    for name, case in payload.get('resumes', {}).items():
        case = dict(case, dir='%s/%s' % (case['dir'], name))
        out['resumes'][name] = resume_case(case, _named_mesh(case['mesh']))
    return out


# -- an in-order loader over a row-group that yields no rows -----------------------


def emptied_rowgroup_ids(url, in_order, epochs, batch_size=8, workers=2, mesh=None,
                         num_epochs=None):
    """The ``id`` batches of ``epochs`` epochs' worth of a loader (endless
    unless ``num_epochs``) over ``url`` whose predicate keeps no row of ids
    8-15 (row-group 1 of the test's dataset), on a thread pool of
    ``workers``: in ventilation order (``in_order``) or as the pool
    delivers, and the loader's ``state_dict`` after them. With ``mesh``
    the loader takes it (a mesh that replicates a batch turns the order
    on)."""
    from petastorm_tpu_torch.device.loader import TorchLoader, make_torch_loader
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader import make_batch_reader
    kw = dict(num_epochs=num_epochs, reader_pool_type='thread', workers_count=workers,
              predicate=in_lambda(['id'], lambda v: not 8 <= v['id'] < 16))
    per_epoch = 56 // batch_size
    if mesh is not None:
        loader = make_torch_loader(url, batch_size, mesh, (DATA_AXIS,), fields=['^id$'],
                                   device='cpu', **kw)
        assert loader._in_order
    else:
        loader = TorchLoader(make_batch_reader(url, schema_fields=['id'], **kw), batch_size,
                             device='cpu', in_order=in_order)
    with loader:
        it = iter(loader)
        batches = [next(it)['id'].tolist() for _ in range(epochs * per_epoch)]
        return batches, loader.state_dict()


def emptied_rowgroup_body(rank, world, payload):
    """:func:`emptied_rowgroup_ids` on a ``{'data': 1, 'model': 2}`` mesh
    (both ranks replicate every batch)."""
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    mesh = make_named_mesh({'data': 1, 'model': 2}, device_type='cpu')
    ids, state = emptied_rowgroup_ids(payload['url'], True, payload['epochs'], mesh=mesh)
    return {'coordinate': _coordinate(mesh), 'ids': ids, 'state': state}


# -- decoding a model split over 'model' -------------------------------------------


def decode_case(case, mesh):
    """One split decode: greedy tokens and the gathered logits each token
    was chosen from (``on_logits``), the K and V caches' shapes
    (``on_cache``) and whether the heads read them through an index, an
    EOS-stopped greedy decode (on ``case['eos']``), the recompute oracle's
    tokens on the split model, and top-k and top-p sampled tokens with the
    same tokens from the unsplit model on this rank's rows and the same
    generator seed. Collective calls of the greedy decode are counted."""
    from petastorm_tpu_torch.models import generate as tg
    from petastorm_tpu_torch.models import transformer as tt
    from petastorm_tpu_torch.parallel import collectives
    config = _config(case['config'])
    model = tt.Transformer(config, mesh)
    model.load_state_dict(tt.params_from_jax(case['params'], mesh, config))
    unsplit = tt.Transformer(config)
    unsplit.load_state_dict(tt.params_from_jax(case['params']))
    prompt = _data_rows(torch.from_numpy(case['prompt']), mesh)
    n = case['new_tokens']
    logits = []
    shapes = []
    collectives.reset_counts()
    greedy = tg._generate(model, prompt, n, None, on_logits=logits.append,
                          on_cache=lambda k, v: shapes.extend((tuple(k.shape), tuple(v.shape))))
    calls = collectives.counts()['calls']
    out = {'greedy': greedy, 'logits': torch.stack(logits), 'cache_shapes': shapes,
           'reads_through_index': tg._kv_read_index(model.parallel, 'cpu') is not None,
           'calls': calls, 'eos_greedy': tg.greedy_generate(model, prompt, n,
                                                            eos_token=case['eos']),
           'oracle': tg.reference_greedy_generate(model, prompt, n),
           'heads': model.parallel.heads, 'kv_heads': model.parallel.kv_heads}
    for label, kw in case['sampling'].items():
        def draw(m):
            return tg.sample_generate(m, prompt, n, torch.Generator().manual_seed(kw['seed']),
                                      temperature=kw['temperature'], top_k=kw['top_k'],
                                      top_p=kw['top_p'])
        out['sampled_' + label] = draw(model)
        out['unsplit_' + label] = draw(unsplit)
    return out


def tp_generate_body(rank, world, payload):
    """Every decode case of ``payload['cases']`` on each mesh of
    ``payload['meshes']``: ``{'data': 1, 'model': 2}`` on ranks (0, 1) and
    again on (2, 3), and ``{'data': 2, 'model': 2}`` over the four; then
    the refusals of a pipelined and an expert-split model."""
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    pairs = [make_named_mesh({'data': 1, 'model': 2}, devices=[0, 1], device_type='cpu'),
             make_named_mesh({'data': 1, 'model': 2}, devices=[2, 3], device_type='cpu')]
    meshes = {'data1-model2': pairs[rank // 2],
              'data2-model2': make_named_mesh({'data': 2, 'model': 2}, device_type='cpu')}
    out = {'coordinates': {label: _coordinate(m) for label, m in meshes.items()}, 'cases': {}}
    for label, mesh in meshes.items():
        out['cases'][label] = {name: decode_case(case, mesh)
                               for name, case in payload['cases'].items()}
    out['refusals'] = decode_refusals(payload['refusal_config'])
    return out


def decode_refusals(kw):
    """The errors decoding raises for a pipelined model over ``{'pipe':
    4}`` and an MoE model whose experts split over ``{'expert': 4}``."""
    from petastorm_tpu_torch.models import generate as tg
    from petastorm_tpu_torch.models import transformer as tt
    from petastorm_tpu_torch.parallel.mesh import make_named_mesh
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    pipelined = tt.init_pipelined_transformer(
        0, _config(kw), make_named_mesh({'pipe': 4}, device_type='cpu'), device='cpu')
    moe = tt.init_transformer(0, _config(dict(kw, n_experts=4)), 'cpu',
                              mesh=make_named_mesh({'expert': 4}, device_type='cpu'))
    return {'pipelined': _error(lambda: tg.greedy_generate(pipelined, prompt, 2)),
            'expert-split': _error(lambda: tg.greedy_generate(moe, prompt, 2))}
