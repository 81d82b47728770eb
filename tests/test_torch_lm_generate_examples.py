"""The port's generate and modern LM examples on the CPU.

``examples/generate.py`` restores what the port's ``pretrain`` writes with a
``checkpoint_dir`` (a tiny model: vocab 64, d_model 32, 2 layers, 32
positions, 4 steps on the dummy pool) and decodes; its greedy output
equals ``greedy_generate`` on the restored model, and it refuses what the
JAX example refuses, in the same order. ``examples/modern.py`` trains its
own config (rope, GQA, swiglu, remat, two accumulated microbatches, f32)
and decodes; the decode equals the port's recompute oracle exactly (f32).
Both are held against the port itself: the JAX examples train with other
weights (a PRNG key) on other loaders.
"""

import os

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.examples import generate as gen_example
from petastorm_tpu_torch.examples import lm_pretrain, modern
from petastorm_tpu_torch.models import generate as tg
from petastorm_tpu_torch.models.transformer import Transformer
from tests.torch_cpu_threads import few_torch_threads  # noqa: F401 - autouse
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

SEQ = 32
MODEL_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)


@pytest.fixture(scope='module')
def c4_url(tmp_path_factory):
    url = 'file://%s' % tmp_path_factory.mktemp('c4')
    lm_pretrain.generate_c4_like(url, num_docs=256, vocab_size=64, seed=0)
    return url


@pytest.fixture(scope='module')
def checkpoint(c4_url, tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ckpt'))
    result = lm_pretrain.pretrain(c4_url, batch_size=4, steps=4, seq_len=SEQ, model_kw=MODEL_KW,
                                  attn_impl='dense', device='cpu', checkpoint_dir=path,
                                  checkpoint_every=2, reader_pool_type='dummy')
    assert [s['step'] for s in result['saves']] == [2, 4]
    return path


def _restored(path):
    model = Transformer(lm_pretrain.lm_config(SEQ, MODEL_KW))
    state = torch.load(os.path.join(path, '4', 'train_state', 'state.pt'), weights_only=True)
    model.load_state_dict(state['model'])
    return model


def _generate(path, **kw):
    return gen_example.generate_from_checkpoint(path, seq_len=SEQ, model_kw=MODEL_KW,
                                                device='cpu', log=lambda *a: None, **kw)


def test_greedy_equals_greedy_generate_on_the_restored_model(checkpoint):
    prompt = np.random.RandomState(0).randint(2, 64, (3, 5)).astype(np.int32)
    got = _generate(checkpoint, prompt_tokens=prompt, max_new_tokens=12, eos_token=None)
    want = tg.greedy_generate(_restored(checkpoint), torch.from_numpy(prompt), 12)
    assert isinstance(got, np.ndarray) and got.shape == (3, 17)
    np.testing.assert_array_equal(got, want.numpy())


def test_default_prompt_stops_at_eos(checkpoint):
    got = _generate(checkpoint, max_new_tokens=10)
    want = tg.greedy_generate(_restored(checkpoint), torch.full((2, 1), lm_pretrain.EOS,
                                                                dtype=torch.int32), 10,
                              eos_token=lm_pretrain.EOS)
    assert got.shape == (2, 11) and (got[:, 0] == lm_pretrain.EOS).all()
    np.testing.assert_array_equal(got, want.numpy())
    for row in got[:, 1:]:
        if (row == lm_pretrain.EOS).any():
            assert (row[int(np.argmax(row == lm_pretrain.EOS)):] == lm_pretrain.EOS).all()


def test_sampling_is_seeded(checkpoint):
    kw = dict(max_new_tokens=16, temperature=0.8, top_p=0.9, eos_token=None)
    a = _generate(checkpoint, seed=1, **kw)
    np.testing.assert_array_equal(a, _generate(checkpoint, seed=1, **kw))
    assert ((a >= 0) & (a < 64)).all()
    want = tg.sample_generate(_restored(checkpoint), torch.full((2, 1), lm_pretrain.EOS,
                                                                dtype=torch.int32), 16,
                              torch.Generator().manual_seed(1), temperature=0.8, top_p=0.9)
    np.testing.assert_array_equal(a, want.numpy())


def test_missing_checkpoint_is_refused_before_anything_is_made(tmp_path):
    missing = str(tmp_path / 'typo')
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        _generate(missing)
    assert not os.path.exists(missing)
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        _generate(str(tmp_path))


@pytest.mark.parametrize('kw', [dict(top_k=5), dict(top_p=0.9)])
def test_top_k_or_top_p_without_temperature_is_refused(tmp_path, kw):
    with pytest.raises(ValueError, match='temperature'):
        _generate(str(tmp_path / 'never'), **kw)
    assert not os.path.exists(tmp_path / 'never')


def test_cli_prints_the_decode(checkpoint, monkeypatch, capsys):
    calls = []
    real = gen_example.generate_from_checkpoint

    def with_tiny_model(path, **kw):
        calls.append(kw)
        return real(path, model_kw=MODEL_KW, seq_len=SEQ, log=lambda *a: None, **kw)

    monkeypatch.setattr(gen_example, 'generate_from_checkpoint', with_tiny_model)
    gen_example.main(['--checkpoint-dir', checkpoint, '--max-new-tokens', '4',
                      '--no-eos-stop', '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(line.startswith('generated: ') for line in lines)
    assert len(lines[0].split()) == 1 + 5 and calls[0]['eos_token'] is None


def test_the_card_is_the_default(checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gen_example.generate_from_checkpoint(checkpoint, seq_len=SEQ, model_kw=MODEL_KW,
                                             log=lambda *a: None)


def test_modern_example_trains_and_decodes(c4_url):
    losses = []
    loss, decoded, model = modern.modern_pretrain(
        c4_url, batch_size=4, steps=6, device='cpu', return_model=True,
        on_step=lambda step, batch, loss: losses.append(float(loss)))
    c = model.config
    assert (c.pos_encoding, c.kv_heads, c.ffn, c.remat, c.dtype) == (
        'rope', 2, 'swiglu', True, torch.float32)
    assert len(losses) == 6 and all(np.isfinite(losses)) and losses[-1] == loss
    assert losses[-1] < losses[0]
    prompt = np.random.RandomState(0).randint(2, 256, (2, 8)).astype(np.int32)
    assert decoded.shape == (2, 16) and (decoded[:, :8] == prompt).all()
    want = tg.reference_greedy_generate(model, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(decoded, want.numpy())
