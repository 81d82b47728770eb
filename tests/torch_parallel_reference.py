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
