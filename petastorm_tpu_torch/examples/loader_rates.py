"""MNIST rows/s, LM tokens/s and ViT images/s of the port in a given
checkout, on the card.

    python3 petastorm_tpu_torch/examples/loader_rates.py --tree DIR

Runs ``petastorm_tpu_torch`` as found under ``DIR`` (another commit's
checkout, or this one) through ``chip_smoke.py``'s ``main_path``,
``lm_path`` and ``vit_path`` settings: 50 SGD steps of the MNIST CNN on
60,000 synthetic rows, 20 AdamW steps of the flagship LM on 8192 C4-like
documents, and 20 AdamW steps of ViT-Base on 1024 ImageNet-like 384² PNG
rows (the codec the H100 machine's decoders build for). The kernels
build first, and a 5-step MNIST run and a 3-step ViT run warm the card's
libraries, so no timed step pays for either. Prints one JSON line
with the rates, the host stage seconds and the card. Run it as a script,
not as a module, so that the package is imported from ``DIR`` only;
and compare two checkouts on one card, in turns.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--tree', required=True, help='checkout holding petastorm_tpu_torch')
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from petastorm_tpu_torch.examples.lm_pretrain import (
        FLAGSHIP_LM_KW, generate_c4_like, pretrain,
    )
    from petastorm_tpu_torch.examples.imagenet import generate_imagenet_like, train_vit_fused
    from petastorm_tpu_torch.examples.mnist import generate_synthetic_mnist, train
    from petastorm_tpu_torch.ops import build
    from petastorm_tpu_torch.telemetry import get_registry, reset_registry
    # the kernels build before any timed step
    build.build(['normalize', 'flash_attention'])

    def stage_seconds():
        prefix = 'petastorm_tpu_stage_seconds_total{stage="'
        return {k[len(prefix):-2]: v for k, v in get_registry().snapshot()['counters'].items()
                if k.startswith(prefix)}

    out = {'tree': tree}
    with tempfile.TemporaryDirectory() as tmp:
        url = 'file://' + os.path.join(tmp, 'mnist')
        generate_synthetic_mnist(url, num_rows=60000)
        train(url, batch_size=64, steps=5, device='cuda')
        reset_registry()
        mnist = train(url, batch_size=64, steps=50, device='cuda')
        out.update(mnist_rows_per_s=mnist['rows_per_s'], mnist_stage_seconds=stage_seconds())
        lm_url = 'file://' + os.path.join(tmp, 'c4_like')
        generate_c4_like(lm_url, num_docs=8192, vocab_size=FLAGSHIP_LM_KW['vocab_size'], seed=0)
        reset_registry()
        lm = pretrain(lm_url, batch_size=8, steps=20, seq_len=1024, model_kw=FLAGSHIP_LM_KW,
                      attn_impl='flash', device='cuda')
        out.update(lm_tokens_per_s=lm['tokens_per_s'], lm_stage_seconds=stage_seconds())
        vit_url = 'file://' + os.path.join(tmp, 'imagenet_like')
        generate_imagenet_like(vit_url, num_rows=1024, size=384, image_codec='png')
        train_vit_fused(vit_url, steps=3, batch_size=16, device='cuda')
        reset_registry()
        vit = train_vit_fused(vit_url, steps=20, batch_size=16, device='cuda')
        out.update(vit_images_per_s=vit['images_per_s'], vit_stage_seconds=stage_seconds())
    out['card'] = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                  '--format=csv,noheader'], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
