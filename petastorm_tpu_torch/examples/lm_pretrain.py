"""LM pretraining on the card: packed Parquet tokens → make_torch_loader →
transformer through the flash-attention kernels → AdamW steps.

Counterpart of ``examples/lm/pretrain_example.py``, at the width of the
repository's flagship LM (``bench.py``'s ``FLAGSHIP_LM_KW``). Documents
are variable-length int32 token arrays (``NdarrayCodec``); a worker-side
``TransformSpec`` packs each row-group's documents, EOS-separated, into
fixed rows of ``seq_len + 1`` tokens. The loss shifts a row by one, so
attention runs at exactly ``seq_len`` positions.

    python -m petastorm_tpu_torch.examples.lm_pretrain --generate --steps 20
"""

import argparse
import time

import numpy as np
import pyarrow as pa
import torch

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

EOS = 1  # token id separating packed documents

#: the flagship LM (~335M parameters): bench.py's FLAGSHIP_LM_KW
FLAGSHIP_LM_KW = dict(vocab_size=16384, d_model=1536, n_heads=16, n_layers=10, d_ff=6144)

C4LikeSchema = Unischema('C4LikeSchema', [
    UnischemaField('doc_id', np.int64, (), ScalarCodec(pa.int64()), False),
    UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False),
])


def generate_c4_like(url, num_docs=512, vocab_size=256, seed=0, rowgroup_size_rows=64):
    """Synthetic C4 stand-in: documents of 20-400 tokens with zipf-ish ids
    (the JAX example's draws for the same seed)."""
    from petastorm_tpu_torch.etl.dataset_metadata import write_dataset
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(num_docs):
        length = int(rng.randint(20, 400))
        # skewed id distribution, reserving 0 (pad) and EOS
        tokens = rng.zipf(1.5, size=length) % (vocab_size - 2) + 2
        rows.append({'doc_id': i, 'tokens': tokens.astype(np.int32)})
    write_dataset(url, C4LikeSchema, rows, rowgroup_size_rows=rowgroup_size_rows)
    return url


def packing_transform(seq_len):
    """TransformSpec packing a row-group's documents into ``seq_len``-token
    rows: concatenate with EOS separators, cut, drop the ragged tail. The
    edit makes the ``(None,)`` column a static ``(seq_len,)`` one."""
    from petastorm_tpu_torch.transform import TransformSpec

    def pack(frame):
        import pandas as pd
        stream = np.concatenate(
            [np.append(np.asarray(d, dtype=np.int32), np.int32(EOS))
             for d in frame['tokens']])
        n_rows = len(stream) // seq_len
        packed = stream[:n_rows * seq_len].reshape(n_rows, seq_len)
        return pd.DataFrame({'tokens': list(packed)})

    return TransformSpec(pack, edit_fields=[('tokens', np.int32, (seq_len,), False)],
                         selected_fields=['tokens'])


def pretrain(dataset_url, batch_size=8, steps=20, seq_len=1024, model_kw=None,
             attn_impl='flash', device=None):
    """``steps`` AdamW steps of the bf16 transformer (seed 0) on packed
    rows of ``seq_len + 1`` tokens, so attention runs at ``seq_len``
    positions; the loss is chunked by 256 positions, as the flagship
    benchmark runs it.

    AdamW carries optax ``adamw(1e-3)``'s defaults (betas 0.9/0.999, eps
    1e-8, weight decay 1e-4; torch's own default decay is 0.01). Returns
    ``{'losses', 'tokens_per_s', 'steps_per_s', 'batch_devices'}``; the
    rates are timed from the first step's start to the last loss on the
    host, and count ``batch_size * seq_len`` trained positions a step."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, adamw, init_transformer, transformer_train_step,
    )

    device = resolve_device(device)
    config = TransformerConfig(max_seq_len=seq_len, loss_chunk=256, attn_impl=attn_impl,
                               **(FLAGSHIP_LM_KW if model_kw is None else model_kw))
    model = init_transformer(0, config, device)
    step = transformer_train_step(model, adamw(model))
    losses = []
    devices = set()
    with make_torch_loader(dataset_url, batch_size=batch_size, fields=['^tokens$'],
                           transform_spec=packing_transform(seq_len + 1), num_epochs=None,
                           shuffle_row_groups=True, device=device) as loader:
        start = time.perf_counter()
        for batch in loader.iter_steps(steps):
            devices.add(str(batch['tokens'].device))
            losses.append(step(batch['tokens']))
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
    return {'losses': losses, 'tokens_per_s': steps * batch_size * seq_len / elapsed,
            'steps_per_s': steps / elapsed, 'batch_devices': sorted(devices)}


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/c4_like_torch')
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    if args.generate:
        generate_c4_like(args.dataset_url, num_docs=8192,
                         vocab_size=FLAGSHIP_LM_KW['vocab_size'])
    result = pretrain(args.dataset_url, batch_size=args.batch_size, steps=args.steps,
                      device=args.device)
    print('final loss %.4f, %.1f tokens/s' % (result['losses'][-1], result['tokens_per_s']))
