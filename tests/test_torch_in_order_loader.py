"""An in-order loader over a row-group that yields no rows reads on.

A loader whose mesh replicates a batch (ranks that differ only on
``'model'``) takes row-groups in the reader's ventilation order through
``mixture.engine.Resequencer``. A row-group whose predicate keeps no row
publishes no batch; the resequencer once learned of it only when the
reader drained, which an endless read never does, so its bound raised
``Resequencer overflow`` after the first batch. The worker now reports
such an item (``ZeroRowItem``) and the resequencer releases it in its
turn. Held on the CPU: 64 rows in 8 row-groups of 8, a predicate that
empties row-group 1, ``num_epochs=None`` and two thread workers; each of
three epochs' rows equal, as a multiset, an unordered one-epoch read's
(ids 0-7 and 16-63), in one process and on two spawned gloo ranks over
``{'data': 1, 'model': 2}``, whose batches are equal. The in-order
loader counts the emptied item delivered, so its checkpoint moves on
with the epochs; the unordered loader's stays at epoch 0, as the JAX
loader's does. A mixture source (the same resequencer) reads on too, a
difference from the JAX package on purpose.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.torch_parallel_bodies import emptied_rowgroup_ids
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

EPOCHS = 3
PER_EPOCH = 7     # 56 surviving rows in batches of 8
SURVIVORS = sorted(set(range(64)) - set(range(8, 16)))


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    root = tmp_path_factory.mktemp('emptied')
    pq.write_table(pa.table({'id': np.arange(64, dtype=np.int64)}),
                   str(root / 'part-0.parquet'), row_group_size=8)
    return 'file://%s' % root


@pytest.fixture(scope='module')
def two_ranks(url, tmp_path_factory):
    ranks = Ranks(tmp_path_factory.mktemp('ranks'), 2,
                  'tests.torch_parallel_bodies:emptied_rowgroup_body',
                  {'url': url, 'epochs': EPOCHS})
    return ranks.results()


def _epochs(batches):
    return [sorted(i for b in batches[e * PER_EPOCH:(e + 1) * PER_EPOCH] for i in b)
            for e in range(len(batches) // PER_EPOCH)]


def test_unordered_read_is_the_oracle(url):
    """The unordered loader (the JAX loader's behaviour): one epoch's rows
    are the predicate's survivors. Read endless, it never delivers the
    emptied item, so its checkpoint stays at epoch 0 (the thread pool
    finishes row-groups in any order, so its endless batches are not
    split into epochs here)."""
    batches, _ = emptied_rowgroup_ids(url, False, 1, num_epochs=1)
    assert _epochs(batches) == [SURVIVORS]
    _, state = emptied_rowgroup_ids(url, False, EPOCHS)
    assert state['epoch'] == 0 and 1 not in state['consumed_items']


def test_endless_in_order_loader_reads_on_past_an_emptied_row_group(url):
    batches, state = emptied_rowgroup_ids(url, True, EPOCHS)
    assert _epochs(batches) == [SURVIVORS] * EPOCHS
    assert state['epoch'] == EPOCHS


def test_replicas_read_on_past_an_emptied_row_group(two_ranks):
    """Two ranks of ``{'data': 1, 'model': 2}``: the same batches on both,
    three epochs, each the unordered read's rows."""
    assert [(r['coordinate']['data'], r['coordinate']['model']) for r in two_ranks] == \
        [(0, 0), (0, 1)]
    assert two_ranks[0]['ids'] == two_ranks[1]['ids']
    assert _epochs(two_ranks[0]['ids']) == [SURVIVORS] * EPOCHS
    assert all(r['state']['epoch'] == EPOCHS for r in two_ranks)


def test_mixture_source_reads_on_past_an_emptied_row_group(url):
    """An ordered mixture source over the same endless reader: three
    epochs of documents, each the survivors, and a state past them."""
    from petastorm_tpu_torch.mixture.engine import _OrderedDocSource
    from petastorm_tpu_torch.predicates import in_lambda
    from petastorm_tpu_torch.reader import make_batch_reader
    with make_batch_reader(url, num_epochs=None, reader_pool_type='thread', workers_count=2,
                           predicate=in_lambda(['id'], lambda v: not 8 <= v['id'] < 16)) \
            as reader:
        source = _OrderedDocSource(reader, 'id')
        docs = [int(next(source)[0]) for _ in range(EPOCHS * len(SURVIVORS))]
        state = source.state_dict()
    n = len(SURVIVORS)
    assert [sorted(docs[e * n:(e + 1) * n]) for e in range(EPOCHS)] == [SURVIVORS] * EPOCHS
    assert state['reader']['epoch'] == EPOCHS and state['partial'] is None
