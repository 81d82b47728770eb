"""Device-side ops of the port; each kernel sits beside its plain version.

The reference's exports are resolved lazily (PEP 562): importing this
package loads no op module, so no kernel library is looked up."""

_AUGMENT_API = ('random_crop', 'random_cutout', 'random_flip_horizontal')
_NORMALIZE_API = ('normalize_images',)

__all__ = _NORMALIZE_API + _AUGMENT_API


def __getattr__(name):
    if name in _NORMALIZE_API:
        from petastorm_tpu_torch.ops import normalize
        return getattr(normalize, name)
    if name in _AUGMENT_API:
        from petastorm_tpu_torch.ops import augment
        return getattr(augment, name)
    raise AttributeError('module %r has no attribute %r' % (__name__, name))
