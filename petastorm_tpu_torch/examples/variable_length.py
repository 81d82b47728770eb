"""LM training on variable-length documents, one document a row, no packing.

Counterpart of ``examples/lm/variable_length_example.py``. Packing
(:mod:`petastorm_tpu_torch.examples.lm_pretrain`) blurs document
boundaries; per-document objectives keep each row one document:

1. Documents on disk: the C4-like ``(None,)`` int32 token rows.
2. Length-bucketed loader: ``make_torch_loader(bucket_boundaries=
   {'tokens': BOUNDARIES})`` routes each document to the smallest bound
   that fits, pads it only to that bound and adds a ``tokens_len`` column
   of true lengths.
3. Masked train step:
   :func:`~petastorm_tpu_torch.models.transformer.transformer_masked_train_step`,
   next-token loss over real targets only. Attention runs at the
   bucket's bound − 1 positions, so the flash kernels see a new S
   whenever the bucket changes.

    python -m petastorm_tpu_torch.examples.variable_length \
        --dataset-url file:///path/to/docs --generate --steps 20
"""

import argparse
import time

import torch

BOUNDARIES = (64, 128, 256, 512)

#: the JAX example's model: vocab 256, d_model 64, 4 heads, 2 layers, d_ff 4 x d_model
EXAMPLE_MODEL_KW = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=256)


def train_variable_length(dataset_url, batch_size=16, steps=20, learning_rate=1e-2,
                          boundaries=BOUNDARIES, model_kw=None, attn_impl='flash',
                          loss_chunk=0, dtype=torch.bfloat16, device=None, log=None,
                          **loader_kwargs):
    """``steps`` AdamW steps of the transformer (seed 0) over bucketed
    variable-length batches; ``loader_kwargs`` go to
    :func:`~petastorm_tpu_torch.device.loader.make_torch_loader`.

    AdamW carries optax ``adamw``'s defaults (betas 0.9/0.999, eps 1e-8,
    weight decay 1e-4). Returns ``{'losses', 'bucket_steps'}`` (bucket
    bound → steps), ``'widths'`` and ``'max_lens'`` (each step's batch
    width and longest ``tokens_len``), ``'batch_devices'``, the loader's
    ``'diagnostics'``, and the rates timed from the first step's start to
    the last loss on the host: ``'steps_per_s'``, ``'target_tokens_per_s'``
    (real next-token targets) and ``'padded_positions_per_s'`` (``batch ×
    (width − 1)`` positions, padding included); on a CUDA device also
    ``'step_ms_by_bucket'``, each bucket's mean step time from CUDA events
    around its steps."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_masked_train_step,
    )

    device = resolve_device(device)
    config = TransformerConfig(max_seq_len=int(boundaries[-1]), attn_impl=attn_impl,
                               loss_chunk=loss_chunk, dtype=dtype,
                               **(EXAMPLE_MODEL_KW if model_kw is None else model_kw))
    model = init_transformer(0, config, device)
    step = transformer_masked_train_step(model, adamw(model, learning_rate))
    loader_kwargs.setdefault('shuffle_row_groups', True)
    losses, widths, max_lens, targets, events = [], [], [], [], []
    devices = set()
    with make_torch_loader(dataset_url, batch_size=batch_size, fields=['^tokens$'],
                           num_epochs=None, bucket_boundaries={'tokens': list(boundaries)},
                           device=device, **loader_kwargs) as loader:
        start = time.perf_counter()
        for i, batch in enumerate(loader.iter_steps(steps)):
            tokens, lengths = batch['tokens'], batch['tokens_len']
            width = tokens.shape[1]
            devices.add(str(tokens.device))
            if device.type == 'cuda':
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            losses.append(step(tokens, lengths))
            if events:
                events[-1][1].record()
            # device-side counts, read once at the end: no sync per step
            widths.append(width)
            max_lens.append(lengths.max())
            targets.append((torch.clamp(lengths, max=width) - 1).clamp(min=0).sum())
            if log is not None and (i % 5 == 0 or i == steps - 1):
                log('step %3d  bucket %3d  loss %.4f' % (i, width, float(losses[-1])))
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
        diagnostics = loader.diagnostics
    bucket_steps, bucket_ms = {}, {}
    for i, width in enumerate(widths):
        bucket_steps[width] = bucket_steps.get(width, 0) + 1
        if events:
            bucket_ms.setdefault(width, []).append(events[i][0].elapsed_time(events[i][1]))
    result = {
        'losses': losses, 'bucket_steps': dict(sorted(bucket_steps.items())),
        'widths': widths, 'max_lens': [int(m) for m in max_lens],
        'batch_devices': sorted(devices), 'diagnostics': diagnostics,
        'steps_per_s': steps / elapsed,
        'target_tokens_per_s': int(sum(int(t) for t in targets)) / elapsed,
        'padded_positions_per_s': batch_size * sum(w - 1 for w in widths) / elapsed,
    }
    if events:
        result['step_ms_by_bucket'] = {w: sum(ms) / len(ms)
                                       for w, ms in sorted(bucket_ms.items())}
    return result


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', required=True)
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.generate:
        from petastorm_tpu_torch.examples.lm_pretrain import generate_c4_like
        generate_c4_like(args.dataset_url)
    result = train_variable_length(args.dataset_url, batch_size=args.batch_size,
                                   steps=args.steps, device=args.device, log=print)
    print('final loss %.4f; steps per bucket: %s'
          % (result['losses'][-1], result['bucket_steps']))
