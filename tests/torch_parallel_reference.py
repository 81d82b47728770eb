"""The JAX side of the port's multi-rank tests, and the cases both sides
share: weights and inputs made with numpy from one seed, the reference's
loss, logits and gradients under its own meshes on the virtual 8-device
CPU platform, and the slice of a full array each rank should hold.

Tolerances (f32, max-abs error relative to the reference's max-abs):
forward, loss and gradients 1e-4; ring and Ulysses attention against the
reference's 1e-5.
"""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from petastorm_tpu.models import transformer as jt
from petastorm_tpu.models import vit as jv
from petastorm_tpu.parallel.mesh import make_mesh, make_named_mesh

MODEL_TOL = 1e-4
ATTENTION_TOL = 1e-5


def close(got, want, tol=MODEL_TOL):
    """``max|got - want| <= tol * max|want|``, with the numbers in the
    message."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, 'max-abs error %g > %g x max-abs %g' % (err, tol, scale)


def lm_params(kw, seed):
    """Numpy weights in the JAX transformer's tree for config ``kw``:
    normals at the init's scales (the head at 0.2, so the loss is not
    flat) and norm gains near one."""
    rng = np.random.RandomState(seed)
    d, h, v = kw['d_model'], kw['n_heads'], kw['vocab_size']
    kv = kw.get('n_kv_heads') or h
    hd, ff = d // h, kw['d_ff']

    def normal(scale, *shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    def gain():
        return (1 + rng.randn(d) * 0.1).astype(np.float32)

    params = {'embed': normal(0.02, v, d), 'lm_head': normal(0.2, d, v), 'ln_f': gain(),
              'blocks': []}
    if kw.get('pos_encoding', 'learned') == 'learned':
        params['pos_embed'] = normal(0.02, kw['max_seq_len'], d)
    for _ in range(kw['n_layers']):
        block = {'qkv': normal(d ** -0.5, d, (h + 2 * kv) * hd),
                 'attn_out': normal(d ** -0.5, d, d), 'ln1': gain(), 'ln2': gain(),
                 'mlp_in': normal(d ** -0.5, d, ff), 'mlp_out': normal(ff ** -0.5, ff, d)}
        if kw.get('ffn', 'gelu') == 'swiglu':
            block['mlp_gate'] = normal(d ** -0.5, d, ff)
        params['blocks'].append(block)
    return params


def vit_params(kw, seed):
    """Numpy weights in the JAX ViT's tree (a random head, not the init's
    zeros, so every gradient is non-zero)."""
    rng = np.random.RandomState(seed)
    d, patch = kw['d_model'], kw['patch_size'] ** 2 * kw['channels']
    blocks = lm_params(dict(vocab_size=2, d_model=d, n_heads=kw['n_heads'],
                            n_layers=kw['n_layers'], d_ff=kw['d_ff'], max_seq_len=1),
                       seed + 1)['blocks']
    n_patches = (kw['image_size'] // kw['patch_size']) ** 2
    return {'patch_embed': (rng.randn(patch, d) * patch ** -0.5).astype(np.float32),
            'pos_embed': (rng.randn(n_patches, d) * 0.02).astype(np.float32),
            'blocks': blocks, 'ln_f': (1 + rng.randn(d) * 0.1).astype(np.float32),
            'head': (rng.randn(d, kw['n_classes']) * 0.2).astype(np.float32)}


def jax_config(kw):
    return jt.TransformerConfig(dtype=jnp.float32, **kw)


def jax_vit_config(kw):
    return jv.ViTConfig(dtype=jnp.float32, **kw)


def _place(params, specs, mesh):
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, jt._restrict_spec_to_mesh(s, mesh))),
        params, specs, is_leaf=lambda x: isinstance(x, np.ndarray))


def _on_data(x, mesh):
    spec = P('data', *([None] * (x.ndim - 1))) if 'data' in mesh.axis_names else P()
    return jax.device_put(x, NamedSharding(mesh, spec))


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tp_mesh(data, model):
    return make_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def seq_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return make_named_mesh(axes, devices=jax.devices()[:n])


def lm_reference(kw, params, tokens, mesh, lengths=None):
    """The reference's loss, logits (of ``tokens[:, :-1]``) and gradients
    under ``mesh``; with ``lengths``, also its masked loss (the mean over
    the real targets of the whole batch) and that loss's gradients."""
    config = jax_config(kw)
    placed = _place(params, jt._param_specs(config), mesh)
    toks = _on_data(tokens, mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jt.transformer_loss(p, t, config, mesh)))(placed, toks)
    out = {'loss': float(loss), 'grads': _numpy(grads)}
    if config.seq_axis is None:
        out['logits'] = np.asarray(jax.jit(
            lambda p, t: jt.transformer_forward(p, t, config, mesh))(placed, toks[:, :-1]))
    if lengths is not None:
        masked, masked_grads = jax.jit(jax.value_and_grad(
            lambda p, t, n: jt.transformer_masked_loss(p, t, n, config, mesh)))(
                placed, toks, _on_data(lengths, mesh))
        out['masked_loss'] = float(masked)
        out['masked_grads'] = _numpy(masked_grads)
    return out


def vit_reference(kw, params, images, labels, mesh):
    config = jax_vit_config(kw)
    block_specs = jt._param_specs(config.block_config())['blocks']
    specs = {'patch_embed': P(None, None), 'pos_embed': P(None, None), 'blocks': block_specs,
             'ln_f': P(None), 'head': P(None, None)}
    placed = _place(params, specs, mesh)
    x, y = _on_data(images, mesh), _on_data(labels, mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, a, b: jv.vit_loss(p, a, b, config)))(placed, x, y)
    return {'loss': float(loss), 'grads': _numpy(grads),
            'logits': np.asarray(jax.jit(lambda p, a: jv.vit_forward(p, a, config))(placed, x))}


def full_state(params):
    """The reference's tree flattened to the port's ``state_dict`` names."""
    state = {k: v for k, v in params.items() if k != 'blocks'}
    for i, block in enumerate(params['blocks']):
        state.update({'blocks.%d.%s' % (i, k): v for k, v in block.items()})
    return state


def expected_shard(name, full, kw, tp, index):
    """The part of the full array ``name`` the rank at ``index`` of a
    ``tp``-way ``'model'`` dim holds: qkv by head (its query heads, then
    the K/V heads they read), attn_out by the same heads' rows, the FFN by
    hidden width, the LM head by vocabulary; the rest whole. Attention is
    whole when the heads do not divide over ``tp``."""
    leaf = name.rsplit('.', 1)[-1]
    if tp == 1:
        return full
    if leaf in ('mlp_in', 'mlp_gate', 'lm_head'):
        return np.split(full, tp, axis=1)[index]
    if leaf == 'mlp_out':
        return np.split(full, tp, axis=0)[index]
    h = kw['n_heads']
    if h % tp or leaf not in ('qkv', 'attn_out'):
        return full
    kv = kw.get('n_kv_heads') or h
    hd = kw['d_model'] // h
    per = h // tp
    first, last = index * per, (index + 1) * per - 1
    if leaf == 'attn_out':
        return full[first * hd:(last + 1) * hd]
    lo, hi = first // (h // kv), last // (h // kv) + 1
    k0, v0 = h * hd, (h + kv) * hd
    return np.concatenate([full[:, first * hd:(last + 1) * hd],
                           full[:, k0 + lo * hd:k0 + hi * hd],
                           full[:, v0 + lo * hd:v0 + hi * hd]], axis=1)


# -- expert parallelism, the routing scope and the pipeline -------------------------


def moe_params(kw, rng):
    """Numpy weights of one Switch-MoE layer (router at 1.0 / sqrt(d), so
    routing is not flat)."""
    d, e, ff = kw['d_model'], kw['n_experts'], kw['d_ff']
    return {'router': (rng.randn(d, e) * d ** -0.5).astype(np.float32),
            'w_in': (rng.randn(e, d, ff) * d ** -0.5).astype(np.float32),
            'w_out': (rng.randn(e, ff, d) * ff ** -0.5).astype(np.float32)}


def moe_lm_params(kw, seed):
    """:func:`lm_params` with every block's dense FFN swapped for an MoE
    layer's weights when ``kw['n_experts'] > 0``."""
    params = lm_params(kw, seed)
    if kw.get('n_experts', 0) > 0:
        rng = np.random.RandomState(seed + 100)
        for block in params['blocks']:
            for name in ('mlp_in', 'mlp_out', 'mlp_gate'):
                block.pop(name, None)
            block['moe'] = moe_params(kw, rng)
    return params


def stack_stages(params, n_stages):
    """The reference's pipelined tree from a layered one: the blocks
    stacked into ``stages`` leaves of ``(n_stages, per_stage, ...)``."""
    blocks = params['blocks']
    per = len(blocks) // n_stages
    stacked = jax.tree_util.tree_map(
        lambda *leaves: np.stack(leaves).reshape((n_stages, per) + leaves[0].shape), *blocks)
    out = {k: v for k, v in params.items() if k != 'blocks'}
    out['stages'] = stacked
    return out


def unstack_stages(tree):
    """The layered tree of a pipelined one (gradients included)."""
    stages = tree['stages']
    n, per = jax.tree_util.tree_leaves(stages)[0].shape[:2]
    out = {k: np.asarray(v) for k, v in tree.items() if k != 'stages'}
    out['blocks'] = [jax.tree_util.tree_map(lambda leaf: np.asarray(leaf[s, i]), stages)
                     for s in range(n) for i in range(per)]
    return out


def full_state_nested(params):
    """:func:`full_state` with an MoE block's ``moe`` dict joined by dots."""
    state = {k: v for k, v in params.items() if k != 'blocks'}
    for i, block in enumerate(params['blocks']):
        for k, v in block.items():
            if isinstance(v, dict):
                state.update({'blocks.%d.%s.%s' % (i, k, n): w for n, w in v.items()})
            else:
                state['blocks.%d.%s' % (i, k)] = v
    return state


def _adamw_update(params, grads, lr):
    import optax
    opt = optax.adamw(lr)
    updates, _ = opt.update(grads, opt.init(params), params)
    return _numpy(optax.apply_updates(params, updates))


def _pipelined_loss(config, mesh, n_microbatches):
    """The reference's pipelined train-step loss (``loss_fn`` of
    ``pipelined_transformer_train_step``), for its gradients."""
    def loss_fn(params, tokens):
        targets = tokens[:, 1:]
        if config.loss_chunk > 0:
            x, aux = jt._pipelined_features_with_aux(params, tokens[:, :-1], config, mesh,
                                                     n_microbatches=n_microbatches)
            nll, cnt = jt._chunked_next_token_nll(x, params['lm_head'], targets,
                                                  jnp.ones(targets.shape, jnp.float32),
                                                  config.loss_chunk, config.dtype)
            return nll / cnt + config.moe_aux_weight * aux
        logits, aux = jt.pipelined_transformer_forward_with_aux(
            params, tokens[:, :-1], config, mesh, n_microbatches=n_microbatches)
        logp = jax.nn.log_softmax(logits, axis=-1)
        ll = jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
        return -ll.mean() + config.moe_aux_weight * aux
    return loss_fn


def lm_step_reference(kw, params, tokens, axes=None, n_microbatches=None, lr=0.0):
    """The reference's loss, aux, logits (of ``tokens[:, :-1]``, None for a
    sequence-split config), gradients and AdamW-updated weights, as
    layered trees: layered on the mesh of ``axes`` (one device without),
    or pipelined over its ``'pipe'`` dim with ``n_microbatches``."""
    config = jax_config(kw)
    mesh = seq_mesh(axes or {'data': 1})
    toks = _on_data(tokens, mesh)
    if 'pipe' in (axes or {}):
        tree = jax.tree_util.tree_map(jnp.asarray, stack_stages(params, axes['pipe']))
        loss_fn = _pipelined_loss(config, mesh, n_microbatches)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree, toks)
        logits, aux = jax.jit(lambda p, t: jt.pipelined_transformer_forward_with_aux(
            p, t, config, mesh, n_microbatches=n_microbatches))(tree, toks[:, :-1])
        updated = _adamw_update(tree, grads, lr)
        return {'loss': float(loss), 'aux': float(aux), 'logits': np.asarray(logits),
                'grads': unstack_stages(_numpy(grads)), 'updated': unstack_stages(updated)}
    placed = _place(params, jt._param_specs(config), mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jt.transformer_loss(p, t, config, mesh)))(placed, toks)
    logits, aux = jax.jit(lambda p, t: jt.transformer_forward_with_aux(p, t, config, mesh))(
        placed, toks[:, :-1])
    return {'loss': float(loss), 'aux': float(aux),
            'logits': None if config.seq_axis is not None else np.asarray(logits),
            'grads': _numpy(grads), 'updated': _adamw_update(placed, grads, lr)}


def moe_layer_reference(kw, params, x, g, axes, capacity=None, seq_axis=None):
    """The reference MoE layer under the mesh of ``axes``: experts sharded
    by ``moe_param_specs``, ``x`` split over ``'data'``; with ``seq_axis``
    inside a ``shard_map`` manual over it, as the pipelined pp×sp×ep
    forward runs it. ``y``, aux, and the gradients of ``(y * g).sum() +
    aux`` for the weights and ``x``."""
    from petastorm_tpu.models import moe as jm
    cfg = jm.MoEConfig(dtype=jnp.float32, **kw)
    mesh = seq_mesh(axes)
    placed = _place(params, jm.moe_param_specs(cfg), mesh)
    xs, gs = _on_data(x, mesh), _on_data(g, mesh)
    if seq_axis is None:
        def fwd(p, a):
            return jm.moe_forward(p, a, cfg, capacity=capacity)
    else:
        from jax import shard_map
        spec = P(None, seq_axis, None)
        fwd = shard_map(lambda p, a: jm.moe_forward(p, a, cfg, capacity=capacity,
                                                    seq_axis=seq_axis),
                        mesh=mesh, in_specs=(P(), spec), out_specs=(spec, P()),
                        axis_names={seq_axis}, check_vma=True)

    def loss(p, a, b):
        y, aux = fwd(p, a)
        return jnp.sum(y * b) + aux

    y, aux = jax.jit(fwd)(placed, xs)
    grads, x_grad = jax.jit(jax.grad(loss, argnums=(0, 1)))(placed, xs, gs)
    return {'y': np.asarray(y), 'aux': float(aux), 'grads': _numpy(grads),
            'x_grad': np.asarray(x_grad)}


def pipe_apply_reference(case):
    """The sequential oracle (``reference_pipeline``) of a
    ``pipeline_apply`` case, or the reference's own ``pipeline_apply`` for
    an aux over several microbatches: the output, the aux and the
    gradients of ``(out ** 2).sum() + aux`` for the stacked weights, the
    input and the upstream weight."""
    from petastorm_tpu.parallel import pipeline as jp
    kind, with_aux = case['kind'], case.get('with_aux', False)

    def stage_fn(p, x):
        if kind == 'multilayer':
            for i in range(p['w'].shape[0]):
                x = jnp.tanh(x @ p['w'][i])
        else:
            x = jax.nn.gelu(x @ p['w'] + p['b'])
        return (x, jnp.mean(x) ** 2) if with_aux else x

    m = case.get('n_microbatches') or case['mesh']['pipe']
    run_pipeline = with_aux and m > 1
    mesh = seq_mesh({'pipe': case['mesh']['pipe']}) if run_pipeline else None

    def loss(params, x, w_up):
        h = jnp.tanh(x @ w_up) if w_up is not None else x
        if run_pipeline:
            out = jp.pipeline_apply(stage_fn, params, h, mesh, n_microbatches=m, with_aux=True)
        else:
            out = jp.reference_pipeline(stage_fn, params, h, with_aux=with_aux)
        out, aux = out if with_aux else (out, jnp.zeros(()))
        return jnp.sum(out ** 2) + aux, (out, aux)

    params = jax.tree_util.tree_map(jnp.asarray, case['params'])
    w_up = jnp.asarray(case['w_up']) if 'w_up' in case else None
    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2), has_aux=True))
    (g_params, g_x, g_up), (out, aux) = grad(params, jnp.asarray(case['x']), w_up)
    return {'out': np.asarray(out), 'aux': float(aux), 'grads': _numpy(g_params),
            'x_grad': np.asarray(g_x), 'up_grad': None if w_up is None else np.asarray(g_up)}


def expert_part(name, full, ep, index):
    """The part of a full array a rank at ``index`` of an ``ep``-way
    ``'expert'`` dim holds: ``w_in``/``w_out`` by expert, the rest whole."""
    if ep > 1 and name.rsplit('.', 1)[-1] in ('w_in', 'w_out'):
        return np.split(full, ep, axis=0)[index]
    return full


def rank_part(name, full, kw, coordinate, axes):
    """What the rank at ``coordinate`` of the mesh ``axes`` holds of the
    full layered array ``name`` (its ``'model'`` and ``'expert'``
    shards)."""
    full = expected_shard(name, full, kw, axes.get('model', 1), coordinate.get('model', 0))
    return expert_part(name, full, axes.get('expert', 1), coordinate.get('expert', 0))
