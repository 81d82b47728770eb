"""petastorm_tpu_torch ViT against the JAX package's on the CPU.

Weights carry across with ``vit_params_from_jax``; images and labels are
made with numpy from a seed. Size: image 32, patch 8 (16 patches), d_model
64, 2 heads, 2 layers, d_ff 128, 10 classes, f32. ``attn_impl='flash'``
runs the port's plain kernel versions through the flash
``autograd.Function`` (JAX runs exact dense attention at 16 patches,
where its kernel is not supported: the same function). Tolerance: atol
1e-4 on logits, the loss, its gradients and the parameters after one
AdamW step (both sides compute in f32; sums run in another order).
Also: ``train_vit``'s resize path yields the JAX loader's batches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from petastorm_tpu.models import vit as jv
from petastorm_tpu_torch.models import vit as tv
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse

SMALL = dict(image_size=32, patch_size=8, n_classes=10, d_model=64, n_heads=2, n_layers=2,
             d_ff=128)


def _models(attn_impl='dense', seed=0):
    jax_config = jv.ViTConfig(dtype=jnp.float32, attn_impl=attn_impl, **SMALL)
    torch_config = tv.ViTConfig(dtype=torch.float32, attn_impl=attn_impl, **SMALL)
    params = jv.init_vit_params(jax.random.PRNGKey(seed), jax_config)
    # JAX's head starts at zero; a random one makes the comparison bite
    params['head'] = jax.random.normal(jax.random.PRNGKey(seed + 1), params['head'].shape) * 0.1
    model = tv.ViT(torch_config)
    model.load_state_dict(tv.vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jax_config, params, model


def _batch(b=3, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, b).astype(np.int32))


def test_params_from_jax_fill_every_parameter():
    _, params, model = _models()
    state = tv.vit_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(state) == sorted(model.state_dict())
    np.testing.assert_array_equal(model.patch_embed.detach().numpy(), params['patch_embed'])
    np.testing.assert_array_equal(model.blocks[1].mlp_out.detach().numpy(),
                                  params['blocks'][1]['mlp_out'])


def test_patchify_matches_jax():
    images, _ = _batch()
    config = tv.ViTConfig(**SMALL)
    want = np.asarray(jv._patchify(jnp.asarray(images), jv.ViTConfig(**SMALL)))
    np.testing.assert_array_equal(tv._patchify(torch.from_numpy(images), config).numpy(), want)


@pytest.mark.parametrize('attn_impl', ['dense', 'flash'])
def test_logits_match_jax(attn_impl):
    jax_config, params, model = _models(attn_impl)
    images, _ = _batch()
    want = np.asarray(jv.vit_forward(params, jnp.asarray(images), jax_config))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('attn_impl', ['dense', 'flash'])
def test_loss_and_grads_match_jax(attn_impl):
    jax_config, params, model = _models(attn_impl)
    images, labels = _batch(4, seed=2)
    loss, grads = jax.value_and_grad(jv.vit_loss)(params, jnp.asarray(images),
                                                  jnp.asarray(labels), jax_config)
    got = tv.vit_loss(model, torch.from_numpy(images), torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-4)
    named = dict(model.named_parameters())
    for name in ('patch_embed', 'pos_embed', 'ln_f', 'head'):
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(grads[name]),
                                   atol=1e-4, err_msg=name)
    for i, block in enumerate(grads['blocks']):
        for name, value in block.items():
            np.testing.assert_allclose(named['blocks.%d.%s' % (i, name)].grad.numpy(),
                                       np.asarray(value), atol=1e-4,
                                       err_msg='blocks.%d.%s' % (i, name))


def test_adamw_step_matches_optax():
    jax_config, params, model = _models('flash')
    images, labels = _batch(4, seed=3)
    optimizer = optax.adamw(1e-3)
    step = jv.vit_train_step(jax_config, optimizer)
    new_params, _, loss = step(params, optimizer.init(params), jnp.asarray(images),
                               jnp.asarray(labels))
    torch_step = tv.vit_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4))
    got_loss = torch_step(torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_loss), float(loss), atol=1e-4)
    want = tv.vit_params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(), atol=1e-4, err_msg=name)


def test_bf16_forward_runs_and_init_is_seeded():
    config = tv.ViTConfig(attn_impl='flash', **SMALL)
    a, b = tv.init_vit(0, config, 'cpu'), tv.init_vit(0, config, 'cpu')
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    assert not a.head.any()  # JAX's zero head
    images, _ = _batch()
    logits = a(torch.from_numpy(images))
    assert logits.dtype == torch.float32 and logits.shape == (3, 10)


def test_init_vit_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tv.init_vit(0, tv.ViTConfig(**SMALL))


def test_config_checks():
    with pytest.raises(ValueError, match='divisible'):
        tv.ViTConfig(image_size=30, patch_size=8)
    with pytest.raises(ValueError, match='attn_impl'):
        tv.ViTConfig(attn_impl='sparse')
    config = tv.ViTConfig(image_size=384, patch_size=12, d_model=768, n_heads=12)
    assert config.n_patches == 1024 and config.patch_dim == 432
    assert config.block_config().max_seq_len == 1024


# -- the example's variable-size (resize) path ---------------------------------


@pytest.fixture(scope='module')
def imagenet_url(tmp_path_factory):
    from petastorm_tpu_torch.examples.imagenet import generate_petastorm_imagenet
    url = 'file://' + str(tmp_path_factory.mktemp('imagenet')) + '/ds'
    generate_petastorm_imagenet(url, num_rows=40)
    return url


def test_resize_path_batches_match_jax_loader(imagenet_url):
    """The worker-side cv2 resize and label transform: the port's loader
    and the JAX loader yield the same images and labels."""
    from examples.imagenet.vit_example import _train_transform as jax_transform
    from petastorm_tpu.jax import make_jax_loader
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.examples.imagenet import _train_transform
    kw = dict(batch_size=8, reader_pool_type='dummy', shuffle_row_groups=True, seed=3)
    with make_jax_loader(imagenet_url, transform_spec=jax_transform(32, 16), **kw) as loader:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in loader]
    with make_torch_loader(imagenet_url, transform_spec=_train_transform(32, 16),
                           device='cpu', **kw) as loader:
        got = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a['image'], b['image'])
        np.testing.assert_array_equal(a['label'], b['label'])


def test_train_vit_resize_path(imagenet_url):
    from petastorm_tpu_torch.examples.imagenet import train_vit
    losses = train_vit(imagenet_url, batch_size=4, steps=4, size=32, patch_size=8,
                       device='cpu', log=lambda line: None)
    assert len(losses) == 4 and all(np.isfinite(losses))
