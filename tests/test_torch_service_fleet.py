"""Mixed fleets: the port's worker server serves the JAX package's
``ServicePool(endpoint=)`` and the JAX package's worker server serves the
port's, over the byte-compatible wire; each epoch is the thread pool's
multiset, also through a worker killed mid-epoch. And the pipeline
report's ``service`` section after a service read has the JAX package's
keys."""

import pytest

from tests.torch_service_common import (
    FAST, PACKAGES, both, cli_worker_servers, read_id_multiset, reap, spawn_cli_worker,
)
from tests.torch_stub_workers import slow_batch_identity
from tests.torch_telemetry_common import telemetry_guard  # noqa: F401 - autouse

pytestmark = pytest.mark.service


@pytest.fixture(scope='module')
def url(tmp_path_factory):
    from tests.test_common import create_test_scalar_dataset
    url = 'file://' + str(tmp_path_factory.mktemp('fleet') / 'dataset')
    create_test_scalar_dataset(url, num_rows=100, num_files=10)
    return url


@pytest.mark.parametrize('consumer,servers', [('jax', 'torch'), ('torch', 'jax')],
                         ids=['port-servers-jax-pool', 'jax-servers-port-pool'])
def test_the_other_packages_worker_servers_serve_the_pool(url, consumer, servers):
    """Two CLI worker servers of one package serve two jobs, one after the
    other, of the other package's pool: each epoch exact."""
    expected = read_id_multiset(PACKAGES['jax'], url, 'thread')
    pkg = PACKAGES[consumer]
    endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
    with cli_worker_servers(PACKAGES[servers], endpoint, 2):
        for _ in range(2):
            pool = pkg.ServicePool(endpoint=endpoint, expected_workers=2, **FAST)
            assert read_id_multiset(pkg, url, pool) == expected


@pytest.mark.parametrize('consumer', ['jax', 'torch'])
def test_a_mixed_fleet_keeps_the_epoch_exact_through_a_kill(url, consumer):
    """One worker server of each package; the one of the other package is
    killed after the first batch: the survivor finishes the epoch and it is
    exact."""
    pkg = PACKAGES[consumer]
    other = 'torch' if consumer == 'jax' else 'jax'
    expected = read_id_multiset(PACKAGES['jax'], url, 'thread', transform=slow_batch_identity)
    endpoint = 'tcp://127.0.0.1:%d' % pkg.protocol.free_tcp_port()
    procs = {name: spawn_cli_worker(PACKAGES[name], endpoint, worker_id=i)
             for i, name in enumerate((consumer, other))}
    try:
        pool = pkg.ServicePool(endpoint=endpoint, expected_workers=2, **FAST)
        got = read_id_multiset(pkg, url, pool, kill_proc_after_first=procs[other],
                               transform=slow_batch_identity)
        assert got == expected
        assert pool.diagnostics['workers_seen'] == 2
    finally:
        reap(list(procs.values()))


def test_service_report_section_is_the_references(url):
    def run(pkg):
        pkg.telemetry.reset_for_tests()
        read_id_multiset(pkg, url, pkg.ServicePool(spawn_local_workers=2, **FAST))
        report = pkg.telemetry.pipeline_report()
        return report['service'], pkg.telemetry.format_pipeline_report(report)

    out = both(run)
    assert set(out['torch'][0]) == set(out['jax'][0])
    for section, text in out.values():
        assert section['workers_registered'] == 2 and section['poisoned'] == 0
        assert 'service fleet:' in text
