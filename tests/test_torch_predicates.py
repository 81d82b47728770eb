"""petastorm_tpu_torch.predicates against petastorm_tpu.predicates.

Each case builds the same predicate in both packages and evaluates it on
the same seeded columns: the columnar masks, the per-row votes and the
fields read must be equal (exact: booleans). ``in_pseudorandom_split``
must put every value in the same subset as the JAX package does.
"""

import numpy as np
import pytest

from petastorm_tpu import predicates as jp
from petastorm_tpu_torch import predicates as tp
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse


def _row_loop(pred, columns):
    fields = sorted(pred.get_fields())
    n = len(columns[fields[0]])
    return np.array([pred.do_include({f: columns[f][i] for f in fields}) for i in range(n)],
                    dtype=bool)


def _columns():
    rng = np.random.RandomState(0)
    return {
        'id': np.arange(50),
        'f': rng.rand(50).astype(np.float32),
        'k': ['s%d' % (i % 4) for i in range(50)],
        'obj': np.array(['x', 'y', None, 'x', 'z'] * 10, dtype=object),
        'tags': [list('abcd'[:i % 4]) for i in range(50)],
    }


# name -> a function of the module that makes the same predicate in either package
CASES = {
    'in_set_numeric': lambda m: m.in_set({3, 7, 49, 1000}, 'id'),
    'in_set_strings': lambda m: m.in_set({'s1', 's3', 'zzz'}, 'k'),
    'in_set_object_with_none': lambda m: m.in_set({'x', None}, 'obj'),
    'in_set_mixed_types': lambda m: m.in_set({1, 'a'}, 'id'),
    'in_intersection': lambda m: m.in_intersection({'b'}, 'tags'),
    'in_negate': lambda m: m.in_negate(m.in_set({1, 2}, 'id')),
    'in_reduce_all': lambda m: m.in_reduce([m.in_set(set(range(0, 50, 3)), 'id'),
                                            m.in_set({'s1', 's2'}, 'k')], all),
    'in_reduce_any': lambda m: m.in_reduce([m.in_set(set(range(0, 50, 3)), 'id'),
                                            m.in_set({'s1', 's2'}, 'k')], any),
    'in_reduce_custom': lambda m: m.in_reduce([m.in_set(set(range(10)), 'id'),
                                               m.in_set(set(range(5, 15)), 'id'),
                                               m.in_set(set(range(8, 40)), 'id')],
                                              lambda votes: votes.count(True) >= 2),
    'pseudorandom_split': lambda m: m.in_pseudorandom_split([0.3, 0.3, 0.4], 1, 'id'),
    'pseudorandom_split_float': lambda m: m.in_pseudorandom_split([0.5, 0.5], 0, 'f'),
    'in_lambda': lambda m: m.in_lambda(['id'], lambda v: v['id'] % 2 == 0),
    'in_lambda_state': lambda m: m.in_lambda(['id', 'k'],
                                             lambda v, s: v['k'] == s and v['id'] > 9, 's2'),
    'in_negate_of_lambda': lambda m: m.in_negate(m.in_lambda(['id'], lambda v: v['id'] > 3)),
    'in_reduce_with_lambda': lambda m: m.in_reduce([m.in_set({1}, 'id'),
                                                    m.in_lambda(['id'], lambda v: True)], all),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_masks_and_votes_are_the_references(case):
    columns = _columns()
    jax_pred, torch_pred = CASES[case](jp), CASES[case](tp)
    assert torch_pred.get_fields() == jax_pred.get_fields()
    want, got = jax_pred.do_include_batch(columns), torch_pred.do_include_batch(columns)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(np.asarray(got, bool), np.asarray(want, bool))
        # the columnar form agrees with the per-row votes
        np.testing.assert_array_equal(np.asarray(got, bool), _row_loop(torch_pred, columns))
    np.testing.assert_array_equal(_row_loop(torch_pred, columns), _row_loop(jax_pred, columns))


@pytest.mark.parametrize('fractions', [[0.4, 0.3, 0.3], [0.25, 0.25, 0.5], [0.1, 0.9]])
def test_pseudorandom_split_buckets_are_the_references(fractions):
    values = (['%d' % i for i in range(300)] + ['key_%d' % i for i in range(300)]
              + list(range(300)))
    counts = np.zeros(len(values), int)
    for subset in range(len(fractions)):
        ours = tp.in_pseudorandom_split(fractions, subset, 'f')
        theirs = jp.in_pseudorandom_split(fractions, subset, 'f')
        mask = [ours.do_include({'f': v}) for v in values]
        assert mask == [theirs.do_include({'f': v}) for v in values]
        counts += np.array(mask)
    assert (counts == 1).all()
    assert tp._string_to_bucket('key_7') == jp._string_to_bucket('key_7')


@pytest.mark.parametrize('args', [([0.5, 0.5], 2), ([0.7, 0.7], 0)],
                         ids=['subset-out-of-range', 'fractions-over-one'])
def test_pseudorandom_split_refusals_are_the_references(args):
    with pytest.raises(ValueError) as want:
        jp.in_pseudorandom_split(*args, 'f')
    with pytest.raises(ValueError) as got:
        tp.in_pseudorandom_split(*args, 'f')
    assert str(got.value) == str(want.value)


def test_split_without_its_field_raises_as_the_reference():
    with pytest.raises(ValueError) as want:
        jp.in_pseudorandom_split([1.0], 0, 'f').do_include({'g': 1})
    with pytest.raises(ValueError) as got:
        tp.in_pseudorandom_split([1.0], 0, 'f').do_include({'g': 1})
    assert str(got.value) == str(want.value)


def test_in_set_and_in_reduce_expose_what_the_planner_reads():
    pred = tp.in_reduce([tp.in_set([1, None], 'x')], any)
    assert pred.reduce_func is any and len(pred.predicates) == 1
    assert pred.predicates[0].values == frozenset([1, None])
    assert pred.predicates[0].field == 'x'
