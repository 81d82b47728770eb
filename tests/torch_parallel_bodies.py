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
