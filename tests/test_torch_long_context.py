"""``petastorm_tpu_torch.examples.long_context`` against
``examples/lm/long_context_example.py``, on the CPU.

Both write the same C4-like documents (the port's writer; the JAX
example's draws for the same seed) and pack them into rows of ``seq_len +
1`` tokens. The JAX example runs in this process over the conftest's
eight virtual devices (``{'data': None, 'seq': 2}``: four data blocks of
one row); the port's ``pretrain_long_context`` runs as two spawned gloo
ranks (``{'data': None, 'seq': 2}``: one data block of four rows), both
from the JAX example's seed-0 weights and both loaders on the dummy pool,
so every step trains on the same four rows with the sequence split two
ways. Held: each step's loss within 5e-3 absolute of the JAX example's
(bf16, as ``test_torch_lm_pretrain.py`` holds the one-device recipe), both
ranks report the same losses, and the port prints the example's step and
per-chip lines.
"""

import functools
import re

import numpy as np
import pytest

from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

STEPS, BATCH, SEQ_LEN, SHARDS = 6, 4, 32, 2


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax

    import petastorm_tpu.jax as jax_loader_module
    from examples.lm import long_context_example as jax_example
    from petastorm_tpu.models import transformer as jt
    from petastorm_tpu_torch.examples import lm_pretrain
    root = tmp_path_factory.mktemp('c4_long')
    url = 'file://%s/c4' % root
    lm_pretrain.generate_c4_like(url, num_docs=256, seed=0)
    params = jt.init_transformer_params(
        jax.random.PRNGKey(0), jt.TransformerConfig(max_seq_len=SEQ_LEN + 1, seq_axis='seq'))
    payload = {'url': url, 'steps': STEPS, 'batch_size': BATCH, 'seq_len': SEQ_LEN,
               'seq_shards': SHARDS, 'params': jax.tree_util.tree_map(np.asarray, params)}
    ranks = Ranks(root / 'ranks', 2, 'tests.torch_parallel_bodies:long_context_body', payload)
    want = []
    make_step = jt.transformer_train_step

    def recording_step(config, optimizer, *args, **kwargs):
        step = make_step(config, optimizer, *args, **kwargs)

        def run(p, opt_state, tokens):
            out = step(p, opt_state, tokens)
            want.append(float(out[2]))
            return out
        return run

    saved = (jt.transformer_train_step, jax_loader_module.make_jax_loader)
    jt.transformer_train_step = recording_step
    jax_loader_module.make_jax_loader = functools.partial(saved[1], reader_pool_type='dummy')
    try:
        final = jax_example.pretrain_long_context(url, batch_size=BATCH, steps=STEPS,
                                                  seq_len=SEQ_LEN, seq_shards=SHARDS)
    finally:
        jt.transformer_train_step, jax_loader_module.make_jax_loader = saved
    return ranks.results(), want, final


def test_losses_match_the_jax_example(runs):
    got, want, final = runs
    assert len(want) == STEPS and want[-1] == final
    for r in got:
        np.testing.assert_allclose(r['losses'], want, atol=5e-3, rtol=0)
        assert r['final'] == r['losses'][-1]
    assert got[0]['losses'] == got[1]['losses']


def test_prints_the_examples_lines(runs):
    got, _, _ = runs
    for r in got:
        lines = r['printed'].splitlines()
        assert lines[0] == 'mesh: 1-way data x 2-way seq over 2 devices'
        assert [int(m.group(1)) for m in map(re.compile(r'step (\d+) loss \d+\.\d{4}$').match,
                                             lines) if m] == list(range(0, STEPS, 5))
        assert lines[-1] == ('per-chip attention rows: %d of %d global (%d-way seq '
                             'sharding)' % (SEQ_LEN // SHARDS, SEQ_LEN, SHARDS))
