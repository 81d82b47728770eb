"""Training consumers of the port (counterpart of ``petastorm_tpu/models``).

The reference's exports are resolved lazily (PEP 562), so importing this
package loads no model module. Parameters are made by ``init_transformer``
and ``init_vit`` (the reference's ``init_*_params``)."""

_GENERATE_API = ('greedy_generate', 'sample_generate')
_MNIST_API = ('MnistCNN', 'mnist_train_step')
_TRANSFORMER_API = ('TransformerConfig', 'transformer_forward',
                    'transformer_masked_train_step', 'transformer_train_step')
_VIT_API = ('ViTConfig', 'vit_forward', 'vit_train_step')

__all__ = _GENERATE_API + _MNIST_API + _TRANSFORMER_API + _VIT_API


def __getattr__(name):
    if name in _GENERATE_API:
        from petastorm_tpu_torch.models import generate
        return getattr(generate, name)
    if name in _MNIST_API:
        from petastorm_tpu_torch.models import mnist
        return getattr(mnist, name)
    if name in _TRANSFORMER_API:
        from petastorm_tpu_torch.models import transformer
        return getattr(transformer, name)
    if name in _VIT_API:
        from petastorm_tpu_torch.models import vit
        return getattr(vit, name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
