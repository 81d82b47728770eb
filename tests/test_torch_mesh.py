"""``petastorm_tpu_torch.parallel.mesh`` against ``petastorm_tpu/parallel/mesh.py``,
and the differentiable collectives of ``petastorm_tpu_torch.parallel.collectives``.

The reference's meshes are built in this process over the first four of
the conftest's virtual CPU devices; the port's over four spawned gloo
ranks (one spawn for the module, every case in it). Held: the axis names
equal; each mesh's dim names, shape and grid (device ids against ranks)
equal, the ``None`` axis absorbing the remaining ranks, a mesh smaller
than the world taking its first ranks (the others outside it); each
rank's coordinate is its place in the grid; ``data_sharding`` and
``replicated`` as DTensor placements (``Shard(0)`` on ``'data'``,
``Replicate()`` elsewhere); the reference's ``ValueError``s (a
non-divisible count, two ``None`` axes, a mesh that does not cover every
rank, more ranks asked than exist) with the same type and text. In this
process, where no group is initialized, a ``'cuda'`` mesh without CUDA
and a CPU mesh without a group raise, and no group is left behind. The
collectives run forward and backward on the same ranks, over a 1-D mesh
of the world and over both dims of a (2, 2) mesh (the ``'data'`` groups
hold ranks 0 and 2, 1 and 3), each against its semantics in numpy.
"""

import jax
import numpy as np
import pytest
import torch

from petastorm_tpu.parallel import mesh as jax_mesh
from petastorm_tpu_torch.parallel import mesh as pm
from tests.torch_ranks import Ranks
from tests.torch_telemetry_common import plane_guard  # noqa: F401 - autouse

WORLD = 4
MESHES = {
    'make_mesh-2x2': ('make_mesh', (2, 2)),
    'make_mesh-default-data': ('make_mesh', (None, 2)),
    'make_mesh-1x2-of-4': ('make_mesh', (1, 2)),
    'named-data-model': ('make_named_mesh', ({'data': 2, 'model': 2},)),
    'named-none-absorbs': ('make_named_mesh', ({'data': None, 'seq': 2},)),
    'named-three-dims': ('make_named_mesh', ({'data': 1, 'model': 2, 'seq': 2},)),
    'named-one-dim': ('make_named_mesh', ({'seq': None},)),
}
ERRORS = {
    'model-not-dividing': ('make_mesh', (None, 3)),
    'mesh-too-big': ('make_mesh', (3, 2)),
    'two-none-axes': ('make_named_mesh', ({'a': None, 'b': None},)),
    'fixed-not-dividing': ('make_named_mesh', ({'data': None, 'seq': 3},)),
    'not-covering': ('make_named_mesh', ({'data': 2, 'seq': 1},)),
}


#: the groups the collectives run on: a 1-D mesh of the world, and the
#: ``'model'`` and ``'data'`` dims of a (2, 2) mesh, whose ranks are
#: [[0, 1], [2, 3]] and [[0, 2], [1, 3]] (a group's index is not the
#: global rank)
GROUPS = {'whole-world': ('make_named_mesh', ({'seq': None},), 'seq'),
          'model-pairs': ('make_mesh', (2, 2), 'model'),
          'data-pairs': ('make_mesh', (2, 2), 'data')}
MEMBERS = {'whole-world': [[0, 1, 2, 3]], 'model-pairs': [[0, 1], [2, 3]],
           'data-pairs': [[0, 2], [1, 3]]}


def _expected(name, xs, gs):
    """Each member's output and input gradient, from the members' ``x``
    and ``g`` in group order: the collectives' semantics in numpy (as
    ``lax.ppermute(perm=[(j, j + 1)])``, ``lax.all_to_all(tiled=True)``,
    ``lax.all_gather(tiled=True)`` and the Megatron pair define them)."""
    n = len(xs)
    if name == 'copy_to_model':
        return xs, [sum(gs)] * n
    if name == 'reduce_from_model':
        return [sum(xs)] * n, gs
    if name == 'all_gather':
        return ([np.concatenate(xs, axis=1)] * n,
                np.split(sum(gs), n, axis=1))
    if name == 'ppermute':
        return ([xs[(j - 1) % n] for j in range(n)], [gs[(j + 1) % n] for j in range(n)])
    # all_to_all: split dim 0 over the ranks, concatenate along dim 2
    return ([np.concatenate([np.split(x, n, axis=0)[j] for x in xs], axis=2)
             for j in range(n)],
            [np.concatenate([np.split(g, n, axis=2)[i] for g in gs], axis=0)
             for i in range(n)])


def _jax(kind, args):
    devices = jax.devices()[:WORLD]
    if kind == 'make_mesh':
        return jax_mesh.make_mesh(*args, devices=devices)
    return jax_mesh.make_named_mesh(*args, devices=devices)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from tests.torch_parallel_bodies import to_numpy
    got = Ranks(tmp_path_factory.mktemp('mesh'), WORLD, 'tests.torch_parallel_bodies:mesh_body',
                {'meshes': MESHES, 'errors': ERRORS, 'collectives': GROUPS}).results()
    return [to_numpy(r) for r in got]


def test_axis_names_are_the_references():
    for name in ('DATA_AXIS', 'MODEL_AXIS', 'EXPERT_AXIS', 'PIPE_AXIS', 'SEQ_AXIS'):
        assert getattr(pm, name) == getattr(jax_mesh, name)


@pytest.mark.parametrize('label', MESHES)
def test_mesh_is_the_references(ranks, label):
    want = _jax(*MESHES[label])
    grid = np.asarray(want.device_ids)
    for rank, r in enumerate(ranks):
        got = r['meshes'][label]
        assert got['names'] == list(want.axis_names)
        assert got['group_sizes'] == list(want.devices.shape)
        assert got['grid'] == grid.tolist()
        where = np.argwhere(grid == rank)
        assert got['coordinate'] == ([int(i) for i in where[0]] if len(where) else None)


@pytest.mark.parametrize('label', MESHES)
def test_placements_shard_data_and_replicate_the_rest(ranks, label):
    """Both shard rows over ``'data'`` and replicate elsewhere; a mesh
    without ``'data'`` is refused by both with a ``ValueError``."""
    want = _jax(*MESHES[label])
    assert jax_mesh.replicated(want).spec == jax.sharding.PartitionSpec()
    try:
        spec = jax_mesh.data_sharding(want, 2).spec
    except ValueError:
        spec = None
    for r in ranks:
        got = r['meshes'][label]
        assert got['replicated'] == ['Replicate()'] * len(got['names'])
        if spec is None:
            assert got['data_sharding'][0] == 'ValueError'
            continue
        assert spec == jax.sharding.PartitionSpec('data', None)
        assert got['data_sharding'] == ['Shard(dim=0)' if n == 'data' else 'Replicate()'
                                        for n in got['names']]


@pytest.mark.parametrize('label', ERRORS)
def test_errors_are_the_references(ranks, label):
    with pytest.raises(ValueError) as want:
        _jax(*ERRORS[label])
    for r in ranks:
        assert r['errors'][label] == ('ValueError', str(want.value))


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('this check is for a host without CUDA')
    with pytest.raises(RuntimeError, match="'cuda' mesh needs CUDA"):
        pm.make_mesh(model=1)
    with pytest.raises(RuntimeError, match="'cuda' mesh needs CUDA"):
        pm.make_named_mesh({'data': None})


def test_a_mesh_never_brings_a_group_up():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='initialized torch.distributed process group'):
        pm.make_mesh(device_type='cpu')
    with pytest.raises(RuntimeError, match='initialized torch.distributed process group'):
        pm.make_named_mesh({'seq': None}, device_type='cpu')
    assert not dist.is_initialized()


def test_axis_of_no_mesh_is_one_rank():
    assert pm.axis(None, 'model') == (None, 1, 0)


@pytest.mark.parametrize('group', GROUPS)
@pytest.mark.parametrize('name', ['copy_to_model', 'reduce_from_model', 'all_gather',
                                  'ppermute', 'all_to_all'])
def test_collectives_forward_and_backward(ranks, group, name):
    """Each differentiable collective's output and input gradient on every
    member of a group, f32 within 1e-6 of the numpy semantics."""
    from tests.torch_parallel_bodies import payload_inputs
    for members in MEMBERS[group]:
        inputs = [payload_inputs(group, name, rank) for rank in members]
        outs, grads = _expected(name, [x for x, _ in inputs], [g for _, g in inputs])
        for j, rank in enumerate(members):
            got_out, got_grad = ranks[rank]['collectives'][group, name]
            np.testing.assert_allclose(got_out, outs[j], rtol=0, atol=1e-6)
            np.testing.assert_allclose(got_grad, grads[j], rtol=0, atol=1e-6)
