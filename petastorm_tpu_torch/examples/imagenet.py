"""ImageNet-style images on the card: Parquet → make_torch_loader → augment
and the normalize kernel → ViT train steps.

Counterpart of ``examples/imagenet/{schema,generate_petastorm_imagenet,
jax_example,vit_example}.py``, in two shapes:

* **Variable-size images** (:data:`ImagenetSchema`, PNG of any size, as
  ImageNet is): a worker-side TransformSpec resizes each row-group with
  cv2 to a fixed shape, so the images decode on the workers
  (:func:`read_imagenet`, :func:`train_vit`).
* **Fixed-shape images** (:func:`imagenet_like_schema`, e.g. 384×384×3
  JPEG or PNG plus an int32 label, no transform): the loader leaves the
  cells encoded and decodes them straight into its pinned staging slots
  with the native decoders (:func:`generate_imagenet_like`,
  :func:`train_vit_fused`, which runs ViT-Base as ``bench.py``'s
  ``vit_train`` section configures it).

    python -m petastorm_tpu_torch.examples.imagenet --generate --steps 20
"""

import argparse
import time

import numpy as np
import pyarrow as pa
import torch

from petastorm_tpu_torch.codecs import CompressedImageCodec, NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

IMAGENET_MEAN = [0.485, 0.456, 0.406]
IMAGENET_STD = [0.229, 0.224, 0.225]

#: ViT-Base on a 32 × 32 patch grid (1024 patches of 12 × 12, head dim
#: 64): ``bench.py``'s ``_VIT_TRAIN_SNIPPET`` configuration
VIT_BASE_KW = dict(image_size=384, patch_size=12, n_classes=1000, d_model=768, n_heads=12,
                   n_layers=12, d_ff=3072)

ImagenetSchema = Unischema('ImagenetSchema', [
    UnischemaField('noun_id', np.str_, (), ScalarCodec(pa.string()), False),
    UnischemaField('text', np.str_, (), ScalarCodec(pa.string()), False),
    UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('png'), False),
])

_SYNSET_WORDS = ['tabby cat', 'golden retriever', 'steam locomotive', 'espresso',
                 'lighthouse']


def generate_petastorm_imagenet(output_url, num_rows=128, seed=0):
    """Variable-size synthetic images (180–320 pixels a side) with noun ids
    and texts of five classes, in 64-row row-groups: the JAX example's
    rows for the same seed."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(num_rows):
        cls = i % len(_SYNSET_WORDS)
        h = int(rng.randint(180, 320))
        w = int(rng.randint(180, 320))
        rows.append({'noun_id': 'n%08d' % cls, 'text': _SYNSET_WORDS[cls],
                     'image': (rng.rand(h, w, 3) * 100 + cls * 30).astype(np.uint8)})
    write_dataset(output_url, ImagenetSchema, rows, rowgroup_size_rows=64)
    return num_rows


def resize_frame_images(frame, size):
    """Resize the frame's ``image`` column to ``size`` × ``size`` in place
    (cv2, area interpolation)."""
    import cv2
    frame['image'] = [cv2.resize(im, (size, size), interpolation=cv2.INTER_AREA)
                      for im in frame['image']]
    return frame


def _resize_transform(size):
    from petastorm_tpu_torch.transform import TransformSpec
    # strings have no tensor form: keep only the image
    return TransformSpec(lambda frame: resize_frame_images(frame, size),
                         edit_fields=[('image', np.uint8, (size, size, 3), False)],
                         selected_fields=['image'])


def read_imagenet(dataset_url, batch_size=16, batches=4, size=224, device=None):
    """``batches`` normalized bf16 image batches of the variable-size
    dataset, resized on the workers; returns the last."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.ops.normalize import normalize_images
    images = None
    with make_torch_loader(dataset_url, batch_size=batch_size,
                           transform_spec=_resize_transform(size), num_epochs=None,
                           shuffle_row_groups=True, device=device) as loader:
        for batch in loader.iter_steps(batches):
            images = normalize_images(batch['image'], IMAGENET_MEAN, IMAGENET_STD)
    return images


def _train_transform(size, n_classes):
    """Resize, and take the label from the noun id's digits (the
    synthetic ids are ``n%08d``)."""
    from petastorm_tpu_torch.transform import TransformSpec

    def rows(frame):
        frame = resize_frame_images(frame, size)
        frame['label'] = np.asarray(
            [int(''.join(ch for ch in nid if ch.isdigit()) or 0) % n_classes
             for nid in frame['noun_id']], np.int32)
        return frame

    return TransformSpec(rows, edit_fields=[('image', np.uint8, (size, size, 3), False),
                                            ('label', np.int32, (), False)],
                         selected_fields=['image', 'label'])


def _prepare(images, generator, augment, cutout):
    """Augment (random flips, cutout) and normalize a uint8 NHWC batch on
    its device; bf16 out of the normalize kernel on the card."""
    from petastorm_tpu_torch.ops.augment import random_cutout, random_flip_horizontal
    from petastorm_tpu_torch.ops.normalize import normalize_images
    if augment:
        images = random_flip_horizontal(generator, images)
        images = random_cutout(generator, images, cutout)
    return normalize_images(images, IMAGENET_MEAN, IMAGENET_STD)


def train_vit(dataset_url, batch_size=8, steps=8, size=64, patch_size=16, n_classes=16,
              learning_rate=1e-3, augment=True, device=None, log=print):
    """A small ViT (d 64, 4 heads, 2 layers) over the variable-size
    dataset, resized on the workers, with flips and cutout on the device;
    returns the losses. AdamW carries optax ``adamw``'s defaults."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.transformer import adamw
    from petastorm_tpu_torch.models.vit import ViTConfig, init_vit, vit_train_step
    device = resolve_device(device)
    config = ViTConfig(image_size=size, patch_size=patch_size, n_classes=n_classes,
                       d_model=64, n_heads=4, n_layers=2, d_ff=256)
    model = init_vit(0, config, device)
    step = vit_train_step(model, adamw(model, learning_rate))
    generator = torch.Generator(device=device).manual_seed(1)
    losses = []
    with make_torch_loader(dataset_url, batch_size=batch_size,
                           transform_spec=_train_transform(size, n_classes), num_epochs=None,
                           shuffle_row_groups=True, device=device) as loader:
        for i, batch in enumerate(loader.iter_steps(steps)):
            images = _prepare(batch['image'], generator, augment, size // 8)
            losses.append(float(step(images, batch['label'])))
            if i % 4 == 0 or i == steps - 1:
                log('step %3d  loss %.4f' % (i, losses[-1]))
    return losses


def imagenet_like_schema(size=384, image_codec='jpeg'):
    """Fixed-shape images (``size`` × ``size`` × 3 uint8: JPEG at quality
    90, PNG, or ``'npy'``, raw ``NdarrayCodec`` arrays) with an int32 label
    in [0, 1000)."""
    codec = (NdarrayCodec() if image_codec == 'npy'
             else CompressedImageCodec(image_codec, quality=90))
    return Unischema('ImagenetLikeSchema', [
        UnischemaField('image', np.uint8, (size, size, 3), codec, False),
        UnischemaField('label', np.int32, (), ScalarCodec(pa.int32()), False),
    ])


def imagenet_like_rows(num_rows, size=384, n_classes=10, seed=7):
    """``(image, label)`` rows with ``bench.py``'s ImageNet-like content:
    an 8×8 random base upsampled (cubic) plus uniform noise of 60, so
    encoded sizes resemble natural images'. Each of ``n_classes`` classes
    has its own base and a label id drawn from [0, 1000); each row draws
    its class, so a batch mixes classes and a model can learn them from
    the low-frequency content."""
    import cv2
    rng = np.random.RandomState(seed)
    bases = [cv2.resize((rng.rand(8, 8, 3) * 180).astype(np.uint8), (size, size),
                        interpolation=cv2.INTER_CUBIC).astype(np.float64)
             for _ in range(n_classes)]
    label_ids = rng.choice(1000, n_classes, replace=False).astype(np.int32)
    for cls in rng.randint(0, n_classes, num_rows):
        noise = rng.rand(size, size, 3) * 60
        yield np.clip(bases[cls] + noise, 0, 255).astype(np.uint8), label_ids[cls]


def generate_imagenet_like(url, num_rows=1024, size=384, image_codec='jpeg', seed=7,
                           rowgroup_size_rows=64):
    """Write :func:`imagenet_like_rows` with :func:`imagenet_like_schema`."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    rows = [{'image': image, 'label': label}
            for image, label in imagenet_like_rows(num_rows, size, seed=seed)]
    write_dataset(url, imagenet_like_schema(size, image_codec), rows,
                  rowgroup_size_rows=rowgroup_size_rows)
    return url


def train_vit_fused(dataset_url, steps=20, batch_size=16, model_kw=None, attn_impl='flash',
                    augment=True, learning_rate=1e-3, seed=0, device=None, **reader_kwargs):
    """``steps`` AdamW steps of the bf16 ViT (``VIT_BASE_KW`` unless
    ``model_kw``) on the fixed-shape dataset: cells decoded straight into
    the loader's pinned slots, flips and cutout of 1/8 the side on the
    card, the normalize kernel, then the step. ``reader_kwargs`` go to the
    reader (e.g. ``filters=[('label', 'in', (...))]`` trains on a subset,
    decoding only its images). Returns ``{'losses', 'images_per_s',
    'steps_per_s', 'batch_devices', 'diagnostics'}``; the rates are timed
    on the host from the first step's start to the last loss."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.transformer import adamw
    from petastorm_tpu_torch.models.vit import ViTConfig, init_vit, vit_train_step
    device = resolve_device(device)
    config = ViTConfig(attn_impl=attn_impl, **(VIT_BASE_KW if model_kw is None else model_kw))
    model = init_vit(seed, config, device)
    step = vit_train_step(model, adamw(model, learning_rate))
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    losses, devices = [], set()
    with make_torch_loader(dataset_url, batch_size=batch_size,
                           fields=['^image$', '^label$'], num_epochs=None,
                           shuffle_row_groups=True, seed=seed, device=device,
                           **reader_kwargs) as loader:
        start = time.perf_counter()
        for batch in loader.iter_steps(steps):
            devices.update(str(t.device) for t in batch.values())
            images = _prepare(batch['image'], generator, augment, config.image_size // 8)
            losses.append(step(images, batch['label']))
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
        diagnostics = loader.diagnostics
    return {'losses': losses, 'images_per_s': steps * batch_size / elapsed,
            'steps_per_s': steps / elapsed, 'batch_devices': sorted(devices),
            'diagnostics': diagnostics}


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/imagenet_like_torch')
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--image-codec', default='jpeg', choices=('jpeg', 'png', 'npy'))
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.generate:
        generate_imagenet_like(args.dataset_url, image_codec=args.image_codec)
    result = train_vit_fused(args.dataset_url, steps=args.steps, device=args.device)
    print('final loss %.4f, %.1f images/s, decode %s'
          % (result['losses'][-1], result['images_per_s'],
             result['diagnostics']['fused_decode_mode']))
