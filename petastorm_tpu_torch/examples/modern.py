"""A LLaMA-style pretrain recipe with every modern model knob composed
(counterpart of ``examples/lm/modern_example.py``).

The Parquet → packed batches pipeline of
:mod:`petastorm_tpu_torch.examples.lm_pretrain`, with the model configured
the way current LMs ship:

* ``pos_encoding='rope'``: rotary positions, no learned table;
* ``n_kv_heads=2``: grouped-query attention (the decode KV cache and its
  per-token reads shrink by the query-group factor);
* ``ffn='swiglu'``: the gated-silu MLP;
* ``remat=True``: each block recomputed in the backward;
* ``transformer_train_step(accum_steps=2)``: gradient accumulation under
  one optimizer update. The JAX example also passes ``donate=True``
  (XLA updates the train state in place); torch's optimizers update the
  parameters in place already, so there is no counterpart.

After training it greedy-decodes a continuation from the grouped KV cache
with the same parameters. It runs on the card unless ``device='cpu'`` is
passed:

    python -m petastorm_tpu_torch.examples.modern --generate \\
        --dataset-url file:///tmp/c4_like_torch --steps 20
"""

import argparse

import numpy as np
import torch

from petastorm_tpu_torch.examples.lm_pretrain import generate_c4_like, packing_transform

SEQ_LEN = 128  # the JAX pretrain example's row length


def modern_pretrain(dataset_url, batch_size=8, steps=12, accum_steps=2, learning_rate=1e-2,
                    seq_len=SEQ_LEN, decode_tokens=8, device=None, on_step=None,
                    return_model=False):
    """Train the modern-config model (seed 0, Adam as optax ``adam``:
    betas 0.9/0.999, eps 1e-8) on packed rows of ``seq_len`` tokens, then
    greedy-decode ``decode_tokens`` tokens from two 8-token prompts drawn
    from ``RandomState(0)``. Returns ``(final_loss, decoded_ids)`` (numpy),
    and the model after them with ``return_model``. ``on_step(step,
    batch, loss)`` sees each step (1-based)."""
    from petastorm_tpu_torch.device.loader import make_torch_loader, resolve_device
    from petastorm_tpu_torch.models.generate import greedy_generate
    from petastorm_tpu_torch.models.transformer import (
        TransformerConfig, init_transformer, transformer_train_step,
    )

    device = resolve_device(device)
    config = TransformerConfig(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                               d_ff=128, max_seq_len=seq_len, dtype=torch.float32,
                               pos_encoding='rope', ffn='swiglu', remat=True)
    model = init_transformer(0, config, device)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    step = transformer_train_step(model, optimizer, accum_steps=accum_steps)
    loss = None
    with make_torch_loader(dataset_url, batch_size=batch_size, fields=['^tokens$'],
                           num_epochs=None, shuffle_row_groups=True,
                           transform_spec=packing_transform(seq_len), device=device) as loader:
        for i, batch in enumerate(loader.iter_steps(steps), 1):
            loss = step(batch['tokens'])
            if on_step is not None:
                on_step(i, batch, loss)
    final_loss = float(loss)

    # inference from the SAME parameters: the decode cache holds only the
    # grouped K/V heads
    prompt = torch.from_numpy(np.random.RandomState(0).randint(2, 256, (2, 8)).astype(np.int32))
    decoded = greedy_generate(model, prompt, max_new_tokens=decode_tokens).cpu().numpy()
    if return_model:
        return final_loss, decoded, model
    return final_loss, decoded


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/c4_like_torch')
    parser.add_argument('--generate', action='store_true',
                        help='write the synthetic dataset first')
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--batch-size', type=int, default=8)
    parser.add_argument('--accum-steps', type=int, default=2)
    parser.add_argument('--device', default=None, help='default: the card')
    args = parser.parse_args(argv)
    if args.generate:
        generate_c4_like(args.dataset_url)
    loss, decoded = modern_pretrain(args.dataset_url, batch_size=args.batch_size,
                                    steps=args.steps, accum_steps=args.accum_steps,
                                    device=args.device)
    print('final loss: %.4f' % loss)
    print('decoded continuation (first row): %s' % decoded[0].tolist())


if __name__ == '__main__':
    main()
