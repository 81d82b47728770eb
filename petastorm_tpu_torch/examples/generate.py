"""Generate from a trained LM checkpoint: the inference end of the loop
(counterpart of ``examples/lm/generate_example.py``).

Parquet → packed batches → train steps → :class:`~petastorm_tpu_torch.checkpoint.TrainCheckpointer`
(model, optimizer and data position) → restore → KV-cache decode
(:mod:`petastorm_tpu_torch.models.generate`): greedy, temperature/top-k/top-p
sampling, EOS stop. The checkpoint is what
:func:`petastorm_tpu_torch.examples.lm_pretrain.pretrain` writes with a
``checkpoint_dir``, so the two compose as two commands over one directory:

    python -m petastorm_tpu_torch.examples.lm_pretrain --generate --steps 20 \\
        --checkpoint-dir /tmp/lm_ckpt_torch
    python -m petastorm_tpu_torch.examples.generate --checkpoint-dir /tmp/lm_ckpt_torch \\
        --max-new-tokens 32 --temperature 0.8 --top-p 0.9

It decodes on the card unless ``device='cpu'`` is passed.
"""

import argparse
import os

import numpy as np
import torch

from petastorm_tpu_torch.examples.lm_pretrain import EOS

SEQ_LEN = 1024  # lm_pretrain.pretrain's default seq_len


def generate_from_checkpoint(checkpoint_dir, prompt_tokens=None, max_new_tokens=32,
                             temperature=0.0, top_k=0, top_p=0.0, eos_token=EOS,
                             seq_len=SEQ_LEN, model_kw=None, seed=0, log=print, device=None):
    """Restore the latest checkpoint's model and decode; returns the
    ``(B, P + N)`` token array (numpy). ``temperature`` 0 decodes greedily
    (``top_k``/``top_p`` then make no sense and are rejected).
    ``eos_token`` defaults to the packing separator, so decoding stops at
    the document boundary the model was trained on (None decodes past
    it). ``seq_len`` and ``model_kw`` (default ``FLAGSHIP_LM_KW``) are the
    ones the checkpoint was trained with. ``seed`` seeds a
    ``torch.Generator`` on ``device`` (None means the card) where the JAX
    example seeds a PRNG key."""
    from petastorm_tpu_torch.checkpoint import TrainCheckpointer
    from petastorm_tpu_torch.device.loader import resolve_device
    from petastorm_tpu_torch.examples.lm_pretrain import lm_config
    from petastorm_tpu_torch.models.generate import greedy_generate, sample_generate
    from petastorm_tpu_torch.models.transformer import Transformer

    if temperature <= 0 and (top_k or top_p):
        raise ValueError('top_k/top_p require temperature > 0 (sampling); '
                         'temperature<=0 decodes greedily')
    missing = FileNotFoundError('no checkpoint under %r; run the pretrain example with '
                                '--checkpoint-dir first' % checkpoint_dir)
    if not os.path.isdir(checkpoint_dir):
        # before the checkpointer, which would create the directory
        raise missing
    ckpt = TrainCheckpointer(checkpoint_dir)
    step = ckpt.latest_step
    if step is None:
        raise missing
    device = resolve_device(device)
    model = Transformer(lm_config(seq_len, model_kw)).to(device)
    ckpt.restore_state({'model': model}, step)
    log('restored step %d from %s' % (step, checkpoint_dir))

    if prompt_tokens is None:
        # an EOS-led prompt: "start of a document", the packing separator
        prompt_tokens = np.full((2, 1), EOS, np.int32)
    prompt = torch.from_numpy(np.asarray(prompt_tokens, np.int32))
    if temperature <= 0:
        out = greedy_generate(model, prompt, max_new_tokens, eos_token=eos_token)
    else:
        generator = torch.Generator(device).manual_seed(seed)
        out = sample_generate(model, prompt, max_new_tokens, generator,
                              temperature=temperature, top_k=top_k, top_p=top_p,
                              eos_token=eos_token)
    return out.cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--checkpoint-dir', required=True)
    parser.add_argument('--max-new-tokens', type=int, default=32)
    parser.add_argument('--temperature', type=float, default=0.0, help='0 = greedy')
    parser.add_argument('--top-k', type=int, default=0)
    parser.add_argument('--top-p', type=float, default=0.0)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--no-eos-stop', action='store_true',
                        help='decode past document boundaries')
    parser.add_argument('--device', default=None, help='default: the card')
    args = parser.parse_args(argv)
    out = generate_from_checkpoint(
        args.checkpoint_dir, max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_token=None if args.no_eos_stop else EOS, seed=args.seed, device=args.device)
    for row in out:
        print('generated:', ' '.join(str(t) for t in row.tolist()))


if __name__ == '__main__':
    main()
