"""Device meshes over ``torch.distributed`` ranks: the canonical axis names.

Counterpart of ``petastorm_tpu/parallel/mesh.py``. Axes used across the
port's models, ops and loader:

* ``'data'``   — batch (data-parallel) axis; the loader shards batches here.
* ``'model'``  — tensor-parallel axis; models split weights and heads here.
* ``'expert'`` — expert-parallel axis (not ported yet).
* ``'pipe'``   — pipeline-parallel axis (not ported yet).
* ``'seq'``    — sequence axis (ring / Ulysses attention).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the live default process group: the JAX mesh's devices are the port's
ranks, one device each. Nothing here brings a group up, as
:mod:`petastorm_tpu_torch.parallel.sharding` never joins a rendezvous: the
caller initializes the group (address, world size and rank) first. The
mesh's device type is ``'cuda'`` unless the caller asks for ``'cpu'``. The
JAX module's ``manual_shard_map`` and ``match_vma`` are tracing shims: the
port's collectives run eagerly on each rank
(:mod:`petastorm_tpu_torch.parallel.collectives`), so they have no
counterpart.
"""

import torch

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
EXPERT_AXIS = 'expert'
PIPE_AXIS = 'pipe'
SEQ_AXIS = 'seq'


def _ranks(devices, device_type):
    """The ranks a mesh is laid over: ``devices`` (a list of ranks) or every
    rank of the live default group."""
    import torch.distributed as dist
    if device_type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh needs CUDA, and torch.cuda.is_available() is "
                           "False; pass device_type='cpu' for a CPU mesh")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError('a mesh needs an initialized torch.distributed process group; '
                           'call torch.distributed.init_process_group() first (the mesh '
                           'never brings one up)')
    return list(devices if devices is not None else range(dist.get_world_size()))


def _mesh(device_type, ranks, sizes, names):
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(ranks, dtype=torch.int).reshape(sizes)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(names))


def make_mesh(data=None, model=1, devices=None, device_type='cuda'):
    """A ``DeviceMesh`` of shape ``(data, model)`` named ``('data', 'model')``.

    :param data: data-parallel size (default: all ranks / model).
    :param model: tensor-parallel size.
    :param devices: explicit rank list (default every rank of the group);
        a mesh smaller than it takes its first ``data * model`` ranks.
    :param device_type: ``'cuda'`` (the default) or ``'cpu'``.
    """
    devices = _ranks(devices, device_type)
    if data is None:
        if len(devices) % model:
            raise ValueError('device count %d not divisible by model=%d'
                             % (len(devices), model))
        data = len(devices) // model
    n = data * model
    if n > len(devices):
        raise ValueError('mesh %dx%d needs %d devices, have %d'
                         % (data, model, n, len(devices)))
    return _mesh(device_type, devices[:n], (data, model), (DATA_AXIS, MODEL_AXIS))


def make_named_mesh(axes, devices=None, device_type='cuda'):
    """A ``DeviceMesh`` with arbitrary named axes.

    :param axes: ordered ``{axis_name: size}`` mapping (e.g. ``{'data': 2,
        'seq': 2}``). One axis may be ``None`` to absorb the remaining ranks.
    :param devices: explicit rank list (default every rank of the group).
    :param device_type: ``'cuda'`` (the default) or ``'cpu'``.
    """
    devices = _ranks(devices, device_type)
    names = list(axes)
    sizes = list(axes.values())
    wild = [i for i, s in enumerate(sizes) if s is None]
    if len(wild) > 1:
        raise ValueError('at most one axis size may be None; got %r' % (axes,))
    fixed = 1
    for s in sizes:
        fixed *= (s if s is not None else 1)
    if wild:
        if len(devices) % fixed:
            raise ValueError('device count %d not divisible by fixed axes '
                             'product %d (%r)' % (len(devices), fixed, axes))
        sizes[wild[0]] = len(devices) // fixed
        fixed = len(devices)
    if fixed != len(devices):
        # never silently drop ranks: a typo'd axis size halving the job is
        # far worse than this error
        raise ValueError('mesh %r covers %d devices but %d were provided; '
                         'use a None axis size to absorb the remainder or '
                         'pass an explicit devices= slice'
                         % (axes, fixed, len(devices)))
    return _mesh(device_type, devices, sizes, names)


def data_sharding(mesh, ndim=1):
    """DTensor placements that shard dim 0 over ``'data'`` and replicate
    over every other mesh dim (the JAX ``PartitionSpec('data', None, ...)``
    of an ``ndim``-dimensional array). A mesh without a ``'data'`` dim
    raises ``ValueError``, as the JAX sharding does."""
    from torch.distributed.tensor import Replicate, Shard
    if ndim < 1:
        raise ValueError('data_sharding needs ndim >= 1; got %r' % (ndim,))
    if DATA_AXIS not in mesh.mesh_dim_names:
        raise ValueError('Resource axis: %s of data_sharding is not found in mesh: %r.'
                         % (DATA_AXIS, tuple(mesh.mesh_dim_names)))
    return tuple(Shard(0) if name == DATA_AXIS else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh):
    """DTensor placements that replicate over every mesh dim."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def axis(mesh, name):
    """``(group, size, index)`` of this rank along mesh dim ``name``, or
    ``(None, 1, 0)`` when the mesh is None or lacks the dim (the JAX specs
    replicate over an axis the mesh does not name). Raises for a rank
    outside the mesh."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    if mesh.get_coordinate() is None:
        raise ValueError('this rank is not in the mesh')
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.size(dim), mesh.get_local_rank(name)
