"""Shard defaults from ``torch.distributed`` and
``make_torch_loader(mesh=, data_axes=)``, against the JAX package's
``default_shard_info`` and ``make_jax_loader(mesh=)``.

The rules of ``tests/test_sharding.py`` hold for the port's
``default_shard_info``; with a live group of 2 ranks (stood in for by
monkeypatching the probe, as the JAX tests monkeypatch
``_jax_process_info``) the port's reader gives rank r the row-groups, rows
and state the JAX reader gives shard r of 2 (exact). A two-process gloo
run on the CPU, in spawned subprocesses with a timeout, shards by the
live group and rebuilds the global batch with ``DTensor.from_local``. No
test leaves a process group, an environment variable or a warning flag
behind.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from petastorm_tpu.jax import make_jax_loader
from petastorm_tpu.parallel import sharding as jax_sharding
from petastorm_tpu.reader import make_batch_reader as jax_make_batch_reader
from petastorm_tpu_torch.device.loader import make_torch_loader, mesh_shard, resolve_mesh
from petastorm_tpu_torch.parallel import sharding
from petastorm_tpu_torch.parallel.sharding import default_shard_info
from petastorm_tpu_torch.reader import make_batch_reader as torch_make_batch_reader
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('args', [(2, 4), (0, 1), (1, None), (None, 4), (4, 4), (-1, 4)],
                         ids=['valid', 'one', 'shard-only', 'count-only', 'too-big',
                              'negative'])
def test_explicit_values_are_the_references(args):
    try:
        want = jax_sharding.default_shard_info(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            default_shard_info(*args)
        assert str(got.value) == str(e)
    else:
        assert default_shard_info(*args) == want == args


def test_no_group_gives_no_sharding():
    assert not torch.distributed.is_initialized()
    assert default_shard_info(None, None) == (None, None)


def test_live_group_defaults_shard(monkeypatch):
    monkeypatch.setattr(sharding, '_process_group_info', lambda: (3, 8))
    assert default_shard_info(None, None) == (3, 8)
    # explicit values always win
    assert default_shard_info(0, 2) == (0, 2)


def test_world_of_one_gives_no_sharding(monkeypatch):
    monkeypatch.setattr(sharding, '_process_group_info', lambda: (0, 1))
    assert default_shard_info(None, None) == (None, None)


def test_launcher_without_a_group_warns_once_and_never_initializes(monkeypatch, caplog):
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setattr(sharding, '_warned_uninitialized', False)
    with caplog.at_level('WARNING', logger=sharding.__name__):
        assert default_shard_info(None, None) == (None, None)
        assert default_shard_info(None, None) == (None, None)
    assert len([r for r in caplog.records if 'WORLD_SIZE=2' in r.getMessage()]) == 1
    assert not torch.distributed.is_initialized()


def test_probe_imports_nothing():
    """Without ``torch.distributed`` imported there is no group, and the
    probe does not import it."""
    code = ('import sys; sys.path.insert(0, %r); '
            'from petastorm_tpu_torch.parallel.sharding import default_shard_info; '
            'print(default_shard_info(None, None), "torch" in sys.modules)' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], check=True, capture_output=True,
                         text=True, timeout=120).stdout
    assert out.strip() == '(None, None) False'


def _shard_read(package, url, rank, monkeypatch, **kw):
    if package == 'jax':
        monkeypatch.setattr(jax_sharding, '_jax_process_info', lambda: (rank, 2))
        make = jax_make_batch_reader
    else:
        monkeypatch.setattr(sharding, '_process_group_info', lambda: (rank, 2))
        make = torch_make_batch_reader
    with make(url, reader_pool_type='dummy', **kw) as reader:
        ids = [int(i) for b in reader for i in b.id]
        out = (list(reader._piece_indices), ids, reader.cur_shard, reader.shard_count,
               reader.state_dict())
    monkeypatch.undo()
    return out


@pytest.mark.parametrize('rank', [0, 1])
@pytest.mark.parametrize('kw', [dict(shuffle_row_groups=False), dict(seed=4),
                                dict(filters=[('id', '>=', 35)], seed=1)],
                         ids=['ordered', 'shuffled', 'filtered'])
def test_group_rank_reads_the_jax_shard(synthetic_dataset, monkeypatch, rank, kw):
    want = _shard_read('jax', synthetic_dataset.url, rank, monkeypatch, **kw)
    got = _shard_read('torch', synthetic_dataset.url, rank, monkeypatch, **kw)
    assert got == want
    assert got[2:4] == (rank, 2)


def test_group_ranks_split_the_epoch(synthetic_dataset, monkeypatch):
    shards = [_shard_read('torch', synthetic_dataset.url, r, monkeypatch) for r in (0, 1)]
    assert not set(shards[0][0]) & set(shards[1][0])
    assert sorted(shards[0][1] + shards[1][1]) == list(range(100))


# -- the mesh ------------------------------------------------------------------


class FakeMesh:
    """The three things the loader reads of a DeviceMesh."""

    def __init__(self, names, sizes, coordinate):
        self.mesh_dim_names = names
        self._sizes = sizes
        self._coordinate = coordinate

    def size(self, dim):
        return self._sizes[dim]

    def get_coordinate(self):
        return self._coordinate


def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh
    devices = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devices, names)


@pytest.mark.parametrize('case', ['unknown-axis', 'unknown-axis-of-two'])
def test_mesh_rejections_are_make_jax_loaders(scalar_dataset, case):
    batch, shape, names, axes = {
        'unknown-axis': (4, (2,), ('dp',), ('nope',)),
        'unknown-axis-of-two': (4, (2, 2), ('dp', 'tp'), ('dp', 'nope')),
    }[case]
    with pytest.raises(KeyError) as want:
        make_jax_loader(scalar_dataset.url, batch, _jax_mesh(shape, names), axes,
                        reader_pool_type='dummy')
    with pytest.raises(KeyError) as got:
        make_torch_loader(scalar_dataset.url, batch, FakeMesh(names, shape, [0] * len(shape)),
                          axes, reader_pool_type='dummy', device='cpu')
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize('case', ['indivisible', 'indivisible-two-axes'])
def test_one_rank_per_mesh_position_always_divides(scalar_dataset, case):
    """``make_jax_loader`` rejects these layouts because one host drives
    every device of the mesh with ``batch`` rows in all; a rank drives one
    mesh position with ``batch`` rows of its own shard, so the same mesh
    holds ``batch`` times its ranks and the port accepts it."""
    batch, shape, names = {
        'indivisible': (3, (4,), ('dp',)),
        'indivisible-two-axes': (6, (4, 2), ('dp', 'tp')),
    }[case]
    with pytest.raises(ValueError, match='must divide evenly'):
        make_jax_loader(scalar_dataset.url, batch, _jax_mesh(shape, names), names,
                        reader_pool_type='dummy')
    coordinate = [s - 1 for s in shape]
    with make_torch_loader(scalar_dataset.url, batch, FakeMesh(names, shape, coordinate),
                           names, fields=['^id$'], reader_pool_type='dummy',
                           device='cpu') as loader:
        n_shards = int(np.prod(shape))
        assert (loader.reader.cur_shard, loader.reader.shard_count) == (n_shards - 1,
                                                                       n_shards)
        assert all(len(b['id']) == batch for b in loader)


def test_mesh_needs_dim_names():
    with pytest.raises(ValueError, match='mesh_dim_names'):
        resolve_mesh(FakeMesh(None, (2,), [0]), None, 4)


@pytest.mark.parametrize('names,sizes,coordinate,axes,want', [
    (('dp',), (2,), [1], None, (1, 2)),
    (('dp', 'tp'), (2, 2), [1, 0], ('dp',), (1, 2)),
    (('dp', 'tp'), (2, 2), [1, 1], ('dp',), (1, 2)),
    (('dp', 'tp'), (2, 2), [1, 1], None, (3, 4)),
    (('dp', 'tp'), (2, 2), [0, 1], ('tp',), (1, 2)),
    (('dp',), (1,), [0], None, (0, 1)),
    (('dp', 'tp'), (1, 2), [0, 1], ('dp',), (0, 1)),
], ids=['dp', 'dp-of-dp-tp', 'dp-replica', 'both-axes', 'tp-only', 'one-shard',
        'one-shard-tp-replica'])
def test_mesh_shard_is_the_data_coordinate(names, sizes, coordinate, axes, want):
    from torch.distributed.tensor import Replicate, Shard
    mesh, placements = resolve_mesh(FakeMesh(names, sizes, coordinate), axes, 8)
    assert placements == tuple(Shard(0) if n in (axes or names) else Replicate()
                               for n in names)
    assert mesh_shard(mesh, placements) == want


def test_rank_outside_the_mesh_raises(scalar_dataset):
    with pytest.raises(ValueError, match='not in the mesh'):
        make_torch_loader(scalar_dataset.url, 4, FakeMesh(('dp',), (2,), None),
                          reader_pool_type='dummy', device='cpu')


def test_explicit_shard_wins_over_the_mesh(scalar_dataset):
    with make_torch_loader(scalar_dataset.url, 10, FakeMesh(('dp',), (2,), [1]),
                           cur_shard=0, shard_count=1, fields=['^id$'],
                           reader_pool_type='dummy', device='cpu') as loader:
        assert loader.reader.shard_count == 1
        assert sorted(int(i) for b in loader for i in b['id']) == list(range(100))


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_world_of_one_group_mesh_in_process(scalar_dataset):
    """A live one-rank gloo group: no sharding, and ``sharding`` rebuilds
    the (one-rank) global batch; the group is destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % _free_port(),
                            rank=0, world_size=1)
    try:
        assert default_shard_info(None, None) == (None, None)
        mesh = init_device_mesh('cpu', (1,), mesh_dim_names=('dp',))
        with make_torch_loader(scalar_dataset.url, 10, mesh, ('dp',), fields=['^id$'],
                               reader_pool_type='dummy', shuffle_row_groups=False,
                               device='cpu') as loader:
            assert loader.sharding == (mesh, (Shard(0),))
            batch = next(iter(loader))['id']
            full = DTensor.from_local(batch, *loader.sharding).full_tensor()
        assert torch.equal(full, batch)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


RANK_SCRIPT = textwrap.dedent('''
    import json, sys
    from datetime import timedelta
    sys.path.insert(0, sys.argv[1])
    import torch
    import torch.distributed as dist
    rank, port, url, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % port, rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        from petastorm_tpu_torch.device.loader import make_torch_loader
        from petastorm_tpu_torch.reader import make_batch_reader
        with make_batch_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
            result = {'pieces': list(r._piece_indices), 'shard': [r.cur_shard, r.shard_count],
                      'ids': [int(i) for b in r for i in b.id], 'state': r.state_dict()}
        mesh = init_device_mesh('cpu', (2,), mesh_dim_names=('dp',))
        with make_torch_loader(url, 8, mesh, ('dp',), fields=['^id$'],
                               reader_pool_type='dummy', shuffle_row_groups=False,
                               device='cpu') as loader:
            local = next(iter(loader))['id']
            result['loader_shard'] = [loader.reader.cur_shard, loader.reader.shard_count]
            result['placements'] = [repr(p) for p in loader.sharding[1]]
            result['local'] = local.tolist()
            result['global'] = DTensor.from_local(local, *loader.sharding).full_tensor().tolist()
        gathered = [None, None]
        dist.all_gather_object(gathered, result['local'])
        result['gathered'] = gathered
        with open(out, 'w') as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
''')


def _run_ranks(tmp_path, script_text, world, url):
    """Run ``script_text`` as ``world`` gloo ranks in spawned subprocesses
    (a 240 s timeout; a rank left running is killed) and return each
    rank's JSON result."""
    script = tmp_path / 'rank.py'
    script.write_text(script_text)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ('WORLD_SIZE', 'RANK')}
    procs = [subprocess.Popen([sys.executable, str(script), ROOT, str(rank), str(port),
                               url, str(tmp_path / ('%d.json' % rank)), str(world)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in range(world)]
    try:
        logs = [p.communicate(timeout=240)[0].decode(errors='replace') for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [json.loads((tmp_path / ('%d.json' % rank)).read_text()) for rank in range(world)]


def test_two_gloo_ranks_shard_and_rebuild_the_global_batch(synthetic_dataset, tmp_path,
                                                           monkeypatch):
    results = _run_ranks(tmp_path, RANK_SCRIPT, 2, synthetic_dataset.url)
    for rank, result in enumerate(results):
        want = _shard_read('jax', synthetic_dataset.url, rank, monkeypatch,
                           shuffle_row_groups=False)
        assert result['pieces'] == want[0] and result['ids'] == want[1]
        assert result['shard'] == [rank, 2] == result['loader_shard']
        assert result['state'] == json.loads(json.dumps(want[4]))
        assert result['placements'] == ['Shard(dim=0)']
        assert result['global'] == results[0]['local'] + results[1]['local']
        assert result['gathered'] == [results[0]['local'], results[1]['local']]
    assert not set(results[0]['pieces']) & set(results[1]['pieces'])
    assert sorted(results[0]['ids'] + results[1]['ids']) == list(range(100))


MESH_SCRIPT = textwrap.dedent('''
    import json, sys
    from datetime import timedelta
    sys.path.insert(0, sys.argv[1])
    import torch.distributed as dist
    rank, port, url, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    world = int(sys.argv[6])
    dist.init_process_group('gloo', init_method='tcp://127.0.0.1:%d' % port, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor
        from petastorm_tpu_torch.device.loader import make_torch_loader
        MESH, BATCH
        result = {}
        try:
            loader = make_torch_loader(url, BATCH, mesh, ('dp',), fields=['^id$'],
                                       reader_pool_type='dummy', shuffle_row_groups=False,
                                       device='cpu')
        except ValueError as e:
            result['error'] = str(e)
        else:
            with loader:
                batches = [b['id'] for b in loader]
                result['shard'] = [loader.reader.cur_shard, loader.reader.shard_count]
                result['placements'] = [repr(p) for p in loader.sharding[1]]
                result['ids'] = [int(i) for b in batches for i in b]
                result['local'] = batches[0].tolist()
                result['global'] = DTensor.from_local(
                    batches[0], *loader.sharding).full_tensor().tolist()
        with open(out, 'w') as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
''')


def _mesh_script(mesh, batch):
    return MESH_SCRIPT.replace('MESH, BATCH', 'mesh = %s; BATCH = %d' % (mesh, batch))


def test_ranks_of_a_one_shard_data_dim_read_the_same_rows(synthetic_dataset, tmp_path):
    """A (1, 2) ('dp', 'tp') mesh over a live two-rank group: the data dim
    holds one shard, so both tp ranks read the whole epoch in the same
    order, whatever the group's rank, and ``DTensor.from_local`` rebuilds
    each local batch as the global one."""
    script = _mesh_script("DeviceMesh('cpu', [[0, 1]], mesh_dim_names=('dp', 'tp'))", 8)
    results = _run_ranks(tmp_path, script, 2, synthetic_dataset.url)
    with torch_make_batch_reader(synthetic_dataset.url, reader_pool_type='dummy',
                                 shuffle_row_groups=False, schema_fields=['^id$']) as r:
        epoch = [int(i) for b in r for i in b.id]
    for result in results:
        assert result['shard'] == [0, 1]
        assert result['placements'] == ['Shard(dim=0)', 'Replicate()']
        assert result['ids'] == epoch[:len(epoch) // 8 * 8]
        assert result['global'] == result['local'] == epoch[:8]


def test_a_mesh_over_part_of_the_group_divides_over_its_own_ranks(synthetic_dataset,
                                                                    tmp_path):
    """A two-rank data mesh inside a three-rank group, one row a rank: the
    global batch is the mesh's two rows, so the mesh's ranks split the
    epoch and the rank outside the mesh is refused."""
    script = _mesh_script("DeviceMesh('cpu', [0, 1], mesh_dim_names=('dp',))", 1)
    results = _run_ranks(tmp_path, script, 3, synthetic_dataset.url)
    for rank in (0, 1):
        assert results[rank]['shard'] == [rank, 2]
        assert results[rank]['placements'] == ['Shard(dim=0)']
        assert results[rank]['global'] == results[0]['local'] + results[1]['local']
    assert not set(results[0]['ids']) & set(results[1]['ids'])
    assert sorted(results[0]['ids'] + results[1]['ids']) == list(range(100))
    assert 'not in the mesh' in results[2]['error']
