"""LM pretraining on the card: packed Parquet tokens → make_torch_loader →
transformer through the flash-attention kernels → AdamW steps.

Counterpart of ``examples/lm/pretrain_example.py``, at the width of the
repository's flagship LM (``bench.py``'s ``FLAGSHIP_LM_KW``). Documents
are variable-length int32 token arrays (``NdarrayCodec``); a worker-side
``TransformSpec`` packs each row-group's documents, EOS-separated, into
fixed rows of ``seq_len + 1`` tokens. The loss shifts a row by one, so
attention runs at exactly ``seq_len`` positions. :func:`pretrain_mixture`
trains the same way on a weighted mixture of corpora packed on the host
(``make_torch_loader(mixture=)``); both resume from a
``checkpoint_dir``. :func:`pretrain_example` is the JAX example's own
recipe: the default ``TransformerConfig`` at 128 positions under Adam.

    python -m petastorm_tpu_torch.examples.lm_pretrain --generate --steps 20
"""

import argparse
import os
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


def write_token_corpus(url, num_docs, seed):
    """A plain-Parquet token corpus, as ``bench.py``'s
    ``_build_mixture_source`` writes it: ``doc_id`` and list<int64>
    ``tokens`` with ids 2-999 and lengths 20-399, in two files of 64-row
    groups. The mixture recipes' input."""
    import pyarrow.parquet as pq
    path = url[len('file://'):]
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    per_file = (num_docs + 1) // 2
    doc_id = 0
    for file_idx in range(2):
        n = min(per_file, num_docs - doc_id)
        tokens = [rng.randint(2, 1000, size=int(rng.randint(20, 400))).tolist()
                  for _ in range(n)]
        table = pa.table({'doc_id': np.arange(doc_id, doc_id + n), 'tokens': tokens})
        pq.write_table(table, os.path.join(path, 'part-%d.parquet' % file_idx),
                       row_group_size=64)
        doc_id += n
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


def lm_config(seq_len, model_kw=None, attn_impl='flash'):
    """The transformer config the recipes train (and the generate example
    restores): ``model_kw`` (default ``FLAGSHIP_LM_KW``) at ``seq_len``
    positions, bf16, the loss chunked by 256 positions."""
    from petastorm_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(max_seq_len=seq_len, loss_chunk=256, attn_impl=attn_impl,
                             **(FLAGSHIP_LM_KW if model_kw is None else model_kw))


def _tree_bytes(path):
    return sum(os.path.getsize(os.path.join(root, name))
               for root, _, names in os.walk(path) for name in names)


def _train(make_loader, steps, batch_size, seq_len, config, make_optimizer, device,
           checkpoint_dir, checkpoint_every, on_step, report=None):
    """The loop every recipe shares (see :func:`pretrain`): the transformer
    of ``config`` (seed 0) under ``make_optimizer(model)``, ``seq_len``
    attention positions a row; ``report(loader)`` adds entries to the
    result at the end."""
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    from petastorm_tpu_torch.device.loader import resolve_device
    from petastorm_tpu_torch.models.transformer import init_transformer, transformer_train_step

    device = resolve_device(device)
    model = init_transformer(0, config, device)
    optimizer = make_optimizer(model)
    step = transformer_train_step(model, optimizer)
    state = {'model': model, 'optimizer': optimizer}
    ckpt = TrainCheckpointer(checkpoint_dir) if checkpoint_dir is not None else None
    losses = []
    devices = set()
    saves = []
    restore_s = None
    with make_loader(device) as loader:
        start_step = 0
        if ckpt is not None:
            t0 = time.perf_counter()
            start_step = ckpt.restore_loader(loader)
            ckpt.restore_state(state)
            restore_s = time.perf_counter() - t0
            if start_step >= steps:
                print('checkpoint already at step %d >= requested %d steps; nothing '
                      'to train' % (start_step, steps))
                return None
        start = time.perf_counter()
        for i, batch in enumerate(loader.iter_steps(steps - start_step), start_step + 1):
            devices.add(str(batch['tokens'].device))
            loss = step(batch['tokens'])
            losses.append(loss)
            if on_step is not None:
                on_step(i, batch, loss)
            if ckpt is not None and i % checkpoint_every == 0:
                float(loss)  # the step finishes before the save is timed
                t0 = time.perf_counter()
                path = ckpt.save(i, state, loader)
                saves.append({'step': i, 'seconds': time.perf_counter() - t0,
                              'bytes': _tree_bytes(path)})
        losses = [float(loss) for loss in losses]
        elapsed = time.perf_counter() - start
        trained = steps - start_step
        result = {'losses': losses, 'start_step': start_step,
                  'tokens_per_s': trained * batch_size * seq_len / elapsed,
                  'steps_per_s': trained / elapsed, 'batch_devices': sorted(devices),
                  'diagnostics': loader.diagnostics, 'restore_s': restore_s,
                  'saves': saves}
        if report is not None:
            result.update(report(loader))
        return result


def pretrain(dataset_url, batch_size=8, steps=20, seq_len=1024, model_kw=None,
             attn_impl='flash', device=None, checkpoint_dir=None, checkpoint_every=10,
             on_step=None, learning_rate=1e-3, **reader_kwargs):
    """``steps`` AdamW steps of the bf16 transformer (seed 0) on packed
    rows of ``seq_len + 1`` tokens, so attention runs at ``seq_len``
    positions; the loss is chunked by 256 positions, as the flagship
    benchmark runs it.

    AdamW carries optax ``adamw(learning_rate)``'s defaults (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4; torch's own default decay is
    0.01). With
    ``checkpoint_dir``, the run resumes from the latest checkpoint there
    (model, optimizer and data position, see
    :class:`~petastorm_tpu_torch.checkpoint.TrainCheckpointer`), returns
    None without training when that checkpoint is at ``steps`` or past
    it, and saves all three every ``checkpoint_every`` steps: rows in
    flight at a save are re-read on resume, rows already trained on are
    not (at-least-once row-groups). ``on_step(step, batch, loss)`` sees
    each step (1-based). Returns ``{'losses', 'start_step',
    'tokens_per_s', 'steps_per_s', 'batch_devices', 'diagnostics',
    'restore_s', 'saves'}`` for the steps this call trained; the rates are
    timed from the first step's start to the last loss on the host (saves
    included), and count ``batch_size * seq_len`` trained positions a
    step. ``restore_s`` is the host seconds of the restore (None without
    a checkpoint directory) and ``saves`` lists each save's step, host
    seconds and bytes on disk. ``reader_kwargs`` go to the reader (e.g.
    ``workers_count=1`` delivers the row-groups in ventilation order)."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.models.transformer import adamw

    def make_loader(device):
        return make_torch_loader(dataset_url, batch_size=batch_size, fields=['^tokens$'],
                                 transform_spec=packing_transform(seq_len + 1),
                                 num_epochs=None, shuffle_row_groups=True, device=device,
                                 **reader_kwargs)

    return _train(make_loader, steps, batch_size, seq_len,
                  lm_config(seq_len, model_kw, attn_impl),
                  lambda model: adamw(model, learning_rate), device, checkpoint_dir,
                  checkpoint_every, on_step)


def pretrain_example(dataset_url, batch_size=16, steps=20, learning_rate=1e-2, seq_len=128,
                     device=None, checkpoint_dir=None, checkpoint_every=10, on_step=None,
                     **reader_kwargs):
    """The JAX example's recipe (``examples/lm/pretrain_example.py``
    ``pretrain``, at its defaults): the default ``TransformerConfig`` (vocab
    256, d_model 64, 4 heads, 2 layers, bf16, dense attention) at
    ``seq_len`` positions, Adam (optax ``adam``'s betas 0.9/0.999 and eps
    1e-8) at ``learning_rate``, on packed rows of ``seq_len`` tokens, so
    attention runs at ``seq_len - 1`` positions. Checkpoints, ``on_step``,
    the result and ``reader_kwargs`` are :func:`pretrain`'s."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.models.transformer import TransformerConfig

    def make_loader(device):
        return make_torch_loader(dataset_url, batch_size=batch_size, fields=['^tokens$'],
                                 transform_spec=packing_transform(seq_len), num_epochs=None,
                                 shuffle_row_groups=True, device=device, **reader_kwargs)

    def adam(model):
        return torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)

    return _train(make_loader, steps, batch_size, seq_len - 1,
                  TransformerConfig(max_seq_len=seq_len), adam, device, checkpoint_dir,
                  checkpoint_every, on_step)


def pretrain_mixture(spec, batch_size=8, steps=20, model_kw=None, attn_impl='flash',
                     device=None, checkpoint_dir=None, checkpoint_every=10, on_step=None,
                     **reader_kwargs):
    """:func:`pretrain`'s loop on a weighted mixture of token corpora:
    ``make_torch_loader(mixture=spec)`` packs the documents into rows of
    ``spec.seq_len`` tokens on the host, so attention runs at
    ``spec.seq_len - 1`` positions. The mixture never runs dry (its
    sources repeat their epochs), and a checkpoint taken at a step
    boundary resumes the same rows, bit for bit. ``reader_kwargs`` go to
    every source's reader (pool type, workers).

    Adds to :func:`pretrain`'s result ``'pack_stats'`` (the packer's rows,
    fill ratio, split documents), ``'source_docs'`` (documents drawn from
    each source) and ``'realized_deviation'`` (the largest gap, over the
    draws so far, between a source's count and its exact share); all
    three count what the mixture produced, prefetched rows included."""
    from petastorm_tpu_torch.device.loader import make_torch_loader
    from petastorm_tpu_torch.mixture import InterleaveSchedule, realized_deviation
    from petastorm_tpu_torch.models.transformer import adamw

    if spec.seq_len is None:
        raise ValueError('pretrain_mixture needs a MixtureSpec with seq_len')

    def make_loader(device):
        return make_torch_loader(None, batch_size=batch_size, mixture=spec, num_epochs=None,
                                 device=device, **reader_kwargs)

    def report(loader):
        stream = loader.reader.stream
        docs = stream.source_doc_counts
        order = InterleaveSchedule.order(spec.weights, spec.seed, 0, sum(docs))
        return {'pack_stats': stream.pack_stats, 'source_docs': dict(zip(spec.names, docs)),
                'realized_deviation': realized_deviation(order, spec.weights)}

    return _train(make_loader, steps, batch_size, spec.seq_len - 1,
                  lm_config(spec.seq_len - 1, model_kw, attn_impl), adamw, device,
                  checkpoint_dir, checkpoint_every, on_step, report)


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/c4_like_torch')
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--device', default=None)
    parser.add_argument('--checkpoint-dir', default=None,
                        help='joint model and data checkpoints; rerun the same '
                             'command to resume after an interruption')
    args = parser.parse_args()
    if args.generate:
        generate_c4_like(args.dataset_url, num_docs=8192,
                         vocab_size=FLAGSHIP_LM_KW['vocab_size'])
    result = pretrain(args.dataset_url, batch_size=args.batch_size, steps=args.steps,
                      device=args.device, checkpoint_dir=args.checkpoint_dir)
    if result is not None:
        print('final loss %.4f, %.1f tokens/s' % (result['losses'][-1],
                                                 result['tokens_per_s']))
