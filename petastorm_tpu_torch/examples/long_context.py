"""Long-context LM training: the sequence split over ranks, end to end.

Counterpart of ``examples/lm/long_context_example.py``. The same C4-like
documents and worker-side packing as :mod:`.lm_pretrain`, packed into much
longer rows, trained with the sequence split over the ranks of a
``{'data': None, 'seq': seq_shards}`` mesh:

1. **Packing to long rows**: the ``TransformSpec`` re-chunks documents
   into ``seq_len + 1`` tokens; every activation downstream is
   ``seq_len / seq_shards`` positions a rank.
2. **data x seq mesh**: the loader shards batches over ``'data'``; each
   rank of a ``'seq'`` group reads the same rows.
3. **Ring attention inside the transformer**
   (``TransformerConfig(seq_axis='seq')``): the only cross-token op runs
   as ``seq_shards`` steps that pass K/V blocks round the ring, exact
   attention at ``O(seq_len / seq_shards)`` positions a rank.

Each rank runs the recipe after joining the process group, e.g. two
ranks on the CPU::

    torchrun --nproc-per-node 2 -m petastorm_tpu_torch.examples.long_context \\
        --generate --device cpu --steps 10 --seq-len 1024
"""

import argparse


def pretrain_long_context(dataset_url, batch_size=4, steps=10, learning_rate=1e-2,
                          seq_len=1024, seq_shards=None, device=None, **reader_kwargs):
    """``steps`` Adam steps (optax ``adam``'s defaults) of the default
    ``TransformerConfig`` at ``seq_len + 1`` positions with the sequence
    split ``seq_shards`` ways (default: up to 4 ranks) over the live
    process group; the rest of the ranks form ``'data'``. Prints the mesh,
    the loss every 5 steps and the positions a rank attends over, as the
    JAX example does, and returns the last loss. ``reader_kwargs`` go to
    the reader."""
    import torch
    import torch.distributed as dist

    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.examples.lm_pretrain import packing_transform
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_train_step,
    )
    from petastorm_tpu_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, make_named_mesh

    device = resolve_device(device)
    n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if seq_shards is None:
        seq_shards = min(4, n_devices)
    mesh = make_named_mesh({DATA_AXIS: None, SEQ_AXIS: seq_shards}, device_type=device.type)
    print('mesh: %d-way data x %d-way seq over %d devices'
          % (mesh.size(0), seq_shards, n_devices))

    # +1 token so next-token targets keep seq_len divisible by the shards
    config = TransformerConfig(max_seq_len=seq_len + 1, seq_axis=SEQ_AXIS)
    model = init_transformer(0, config, device, mesh=mesh)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    step = transformer_train_step(model, optimizer, mesh)

    loss = None
    with make_torch_loader(dataset_url, batch_size, mesh, (DATA_AXIS,), fields=['^tokens$'],
                           transform_spec=packing_transform(seq_len + 1), num_epochs=None,
                           shuffle_row_groups=True, device=device, **reader_kwargs) as loader:
        for i, batch in enumerate(loader.iter_steps(steps)):
            loss = step(batch['tokens'])
            if i % 5 == 0:
                print('step %d loss %.4f' % (i, float(loss)))
    # a rank's attention state is O(seq_len / seq_shards): report it
    local_seq = seq_len // seq_shards
    print('per-chip attention rows: %d of %d global (%d-way seq sharding)'
          % (local_seq, seq_len, seq_shards))
    return float(loss) if loss is not None else float('nan')


if __name__ == '__main__':
    parser = argparse.ArgumentParser()
    parser.add_argument('--dataset-url', default='file:///tmp/c4_long_torch')
    parser.add_argument('--generate', action='store_true')
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--batch-size', type=int, default=4)
    parser.add_argument('--seq-len', type=int, default=1024)
    parser.add_argument('--seq-shards', type=int, default=None)
    parser.add_argument('--device', default=None)
    args = parser.parse_args()
    import torch.distributed as dist
    dist.init_process_group('gloo')
    try:
        if args.generate and dist.get_rank() == 0:
            from petastorm_tpu_torch.examples.lm_pretrain import generate_c4_like
            # longer documents so packing reaches seq_len rows quickly
            generate_c4_like(args.dataset_url, num_docs=256)
        dist.barrier()
        pretrain_long_context(args.dataset_url, batch_size=args.batch_size,
                              steps=args.steps, seq_len=args.seq_len,
                              seq_shards=args.seq_shards, device=args.device)
    finally:
        dist.destroy_process_group()
