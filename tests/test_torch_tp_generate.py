"""Decoding a model split over ``'model'`` in the port against the JAX
package's decode, on the CPU.

The port runs as four spawned gloo ranks (one spawn for the module): a
``{'data': 1, 'model': 2}`` mesh on ranks (0, 1) and another on (2, 3),
then ``{'data': 2, 'model': 2}`` over the four. Each rank loads its
shards with ``params_from_jax(params, mesh, config)`` and decodes its
``'data'`` rows of a 4-row, 4-token prompt for 8 new tokens, for the six
head layouts of ``tests/test_torch_tensor_parallel.py`` (multi-head, GQA
split evenly with rope and swiglu, fewer K/V heads than ranks, GQA
groups that straddle the ranks with rope, heads that do not split, and
the flash config, which decode runs as plain attention). The reference
decodes in this process while the ranks run: ``greedy_generate`` on the
unsplit weights and on the weights placed over ``tp_mesh(1, 2)`` and
``tp_mesh(2, 2)`` (its GSPMD path on the virtual CPU devices).

Held: greedy tokens exactly equal to all three of the reference's (f32
on both sides; an argmax flips only on a near-tie, and none of these
seeds lands on one); the gathered logits each token was chosen from
within 1e-4 (f32, max-abs error over the reference's max-abs) of the
reference's ``transformer_forward`` over the decoded sequence; the
port's recompute oracle on the split model equal to its decode; an EOS
stop equal to the reference's; top-k and top-p sampled tokens equal on
every rank of a ``'model'`` group and equal to the unsplit port's with
the same generator seed on the same rows (a ``torch.Generator`` has no
JAX counterpart); each rank's KV cache as wide as its own K/V heads; the
collective calls a decode makes; and the refusals of a pipelined and an
expert-split model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from petastorm_tpu.models import generate as jg
from petastorm_tpu.models import transformer as jt
from tests import torch_parallel_reference as ref
from tests.test_torch_tensor_parallel import BASE, LM_CASES
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

BATCH, PROMPT, NEW = 4, 4, 8
MESHES = {'data1-model2': (1, 2), 'data2-model2': (2, 2)}
SAMPLING = {'top_k': dict(seed=1, temperature=0.8, top_k=8, top_p=0.0),
            'top_p': dict(seed=2, temperature=1.0, top_k=0, top_p=0.9)}


def _kw(name):
    return dict(BASE, **LM_CASES[name])


def _unsplit_port_greedy(kw, params, prompt):
    from petastorm_tpu_torch.models import generate as tg
    from petastorm_tpu_torch.models import transformer as tt
    model = tt.Transformer(tt.TransformerConfig(dtype=torch.float32, **kw))
    model.load_state_dict(tt.params_from_jax(params))
    return tg.greedy_generate(model, torch.from_numpy(prompt), NEW).numpy()


def _reference(kw, params, prompt, eos):
    config = ref.jax_config(kw)
    tree = jax.tree_util.tree_map(jnp.asarray, params)
    toks = jnp.asarray(prompt.astype(np.int32))
    out = {'greedy': np.asarray(jg.greedy_generate(tree, toks, config, NEW)),
           'eos': np.asarray(jg.greedy_generate(tree, toks, config, NEW, eos_token=eos))}
    for label, (data, model) in MESHES.items():
        placed = ref._place(params, jt._param_specs(config), ref.tp_mesh(data, model))
        out['placed_' + label] = np.asarray(jg.greedy_generate(placed, toks, config, NEW))
    # the logits each token was chosen from, teacher-forced over the
    # decoded sequence
    logits = jt.transformer_forward(tree, jnp.asarray(out['greedy'][:, :-1]), config)
    out['logits'] = np.asarray(logits)[:, PROMPT - 1:]
    return out


@pytest.fixture(scope='module')
def decoded(tmp_path_factory):
    rng = np.random.RandomState(0)
    payload = {'cases': {}, 'refusal_config': dict(BASE, n_layers=4)}
    for i, name in enumerate(LM_CASES):
        kw = _kw(name)
        params = ref.lm_params(kw, i)
        prompt = rng.randint(0, kw['vocab_size'], (BATCH, PROMPT)).astype(np.int64)
        # an EOS row 0 emits third: rows stop at different steps
        eos = int(_unsplit_port_greedy(kw, params, prompt)[0, PROMPT + 2])
        payload['cases'][name] = {'config': kw, 'params': params, 'prompt': prompt,
                                  'new_tokens': NEW, 'eos': eos, 'sampling': SAMPLING}
    ranks = Ranks(tmp_path_factory.mktemp('tp_generate'), 4,
                  'tests.torch_parallel_bodies:tp_generate_body', payload)
    want = {name: _reference(case['config'], case['params'], case['prompt'], case['eos'])
            for name, case in payload['cases'].items()}
    from tests.torch_parallel_bodies import to_numpy
    return [to_numpy(r) for r in ranks.results()], want, payload


def _each(got):
    """``(rank's results, mesh label, its coordinate there)`` of every
    rank's run on every mesh."""
    for r in got:
        for label in MESHES:
            yield r, label, r['coordinates'][label]


def _rows(x, label, c):
    return np.split(x, MESHES[label][0], axis=0)[c['data']]


def test_ranks_sit_on_the_meshes(decoded):
    got, _, _ = decoded
    assert [(r['coordinates']['data1-model2']['data'], r['coordinates']['data1-model2']['model'])
            for r in got] == [(0, 0), (0, 1), (0, 0), (0, 1)]
    assert [(r['coordinates']['data2-model2']['data'], r['coordinates']['data2-model2']['model'])
            for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize('name', LM_CASES)
def test_split_greedy_matches_jax_exactly(decoded, name):
    """Every rank's tokens are its rows of the reference's, which are the
    same on the unsplit weights and on both placements."""
    got, want, _ = decoded
    w = want[name]
    for label in MESHES:
        np.testing.assert_array_equal(w['placed_' + label], w['greedy'])
    for r, label, c in _each(got):
        result = r['cases'][label][name]
        assert result['greedy'].shape == (BATCH // MESHES[label][0], PROMPT + NEW)
        np.testing.assert_array_equal(result['greedy'], _rows(w['greedy'], label, c))


@pytest.mark.parametrize('name', LM_CASES)
def test_split_greedy_equals_the_split_recompute_oracle(decoded, name):
    """``reference_greedy_generate`` on the split model (a full forward a
    token, its vocabulary blocks gathered) gives the KV-cache decode's
    tokens."""
    got, _, _ = decoded
    for r, label, _ in _each(got):
        result = r['cases'][label][name]
        np.testing.assert_array_equal(result['oracle'], result['greedy'])


@pytest.mark.parametrize('name', LM_CASES)
def test_teacher_forced_logits_match(decoded, name):
    """``on_logits`` sees the whole gathered ``(B, V)`` row of each step,
    within 1e-4 of the reference's forward over the decoded sequence."""
    got, want, _ = decoded
    for r, label, c in _each(got):
        logits = r['cases'][label][name]['logits']              # (NEW, B_local, V)
        assert logits.shape == (NEW, BATCH // MESHES[label][0], BASE['vocab_size'])
        ref.close(logits.transpose(1, 0, 2), _rows(want[name]['logits'], label, c))


@pytest.mark.parametrize('name', LM_CASES)
def test_eos_freezing_matches_jax(decoded, name):
    got, want, payload = decoded
    eos = payload['cases'][name]['eos']
    assert (want[name]['eos'][0, PROMPT + 2:] == eos).all()
    for r, label, c in _each(got):
        np.testing.assert_array_equal(r['cases'][label][name]['eos_greedy'],
                                      _rows(want[name]['eos'], label, c))


@pytest.mark.parametrize('name', LM_CASES)
def test_sampled_tokens_agree_over_model_and_with_the_unsplit_port(decoded, name):
    """Top-k and top-p draws: the same tokens on both ranks of a
    ``'model'`` group, and the unsplit port's on the same rows with the
    same generator seed."""
    got, _, _ = decoded
    by_group = {}
    for rank, r in enumerate(got):
        for label in MESHES:
            result, c = r['cases'][label][name], r['coordinates'][label]
            # the two 1 x 2 meshes are separate 'model' groups
            group = (label, c['data'], rank // 2 if label == 'data1-model2' else 0)
            for kind in SAMPLING:
                np.testing.assert_array_equal(result['sampled_' + kind],
                                              result['unsplit_' + kind])
                by_group.setdefault(group + (kind,), []).append(result['sampled_' + kind])
    for draws in by_group.values():
        assert len(draws) == 2
        np.testing.assert_array_equal(draws[0], draws[1])


def _local_kv_heads(kw, tp, index):
    """The K/V heads a rank's query heads read: its heads' groups, or
    every K/V head when the heads do not split over ``tp``."""
    heads, kv = kw['n_heads'], kw.get('n_kv_heads') or kw['n_heads']
    if heads % tp:
        return kv
    mine = range(index * heads // tp, (index + 1) * heads // tp)
    return len({h // (heads // kv) for h in mine})


@pytest.mark.parametrize('name', LM_CASES)
def test_each_ranks_cache_holds_its_kv_heads(decoded, name):
    got, _, _ = decoded
    kw = _kw(name)
    dh = kw['d_model'] // kw['n_heads']
    for r, label, c in _each(got):
        result = r['cases'][label][name]
        kv = _local_kv_heads(kw, 2, c['model'])
        assert result['kv_heads'] == kv
        want = (kw['n_layers'], BATCH // MESHES[label][0], kw['max_seq_len'], kv, dh)
        assert result['cache_shapes'] == [want, want]         # K, then V
        # the heads group over the cache as in one process unless their
        # GQA groups straddle the ranks
        assert result['reads_through_index'] == ('straddling' in name)
        total = kw.get('n_kv_heads') or kw['n_heads']
        if kw['n_heads'] % 2 == 0 and total % 2 == 0:
            # K/V heads that split evenly: half of one process's cache
            assert kv == total // 2


@pytest.mark.parametrize('name', LM_CASES)
def test_collective_calls_of_a_decode(decoded, name):
    """One all-gather of the logits a token, and a sum over ``'model'``
    for each block's attention (when its heads split) and its FFN."""
    got, _, _ = decoded
    kw = _kw(name)
    per_token = kw['n_layers'] * (2 if kw['n_heads'] % 2 == 0 else 1)
    for r, label, _ in _each(got):
        assert r['cases'][label][name]['calls'] == {'reduce_from_model': per_token * NEW,
                                                    'all_gather': NEW}


def test_pipelined_and_expert_split_models_are_refused(decoded):
    """A pipelined model holds one stage's blocks (the reference cannot
    decode a stacked tree either); an MoE model, expert-split or not,
    keeps the dense-only refusal, which is checked first."""
    got, _, _ = decoded
    for r in got:
        kind, text = r['refusals']['pipelined']
        assert kind == 'ValueError' and 'pipelined model' in text and 'decode' in text
        assert r['refusals']['expert-split'] == (
            'NotImplementedError',
            'greedy_generate/sample_generate support dense, unsharded-sequence configs')
