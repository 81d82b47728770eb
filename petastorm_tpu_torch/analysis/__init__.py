"""pipecheck for the port (counterpart of ``petastorm_tpu/analysis``): an
AST-level contract and concurrency analyzer.

The port's concurrency surface — a thread pool and its ventilator, the
staging thread with its CUDA events, the observability server's threads,
the ``nvcc`` build lock — rests on contracts no runtime test sees on every
path: canonical stage/metric/event names, ``PETASTORM_TPU_*`` knobs going
through one registry, threads that are daemonized or joined, no blocking
calls under a lock, pickle-safe payloads across process boundaries, no
borrowed zero-copy view escaping its owner. This package verifies them
statically::

    python -m petastorm_tpu_torch.analysis               # exit 0 on a clean tree

Library API::

    from petastorm_tpu_torch.analysis import analyze_paths, analyze_source
    findings = analyze_paths(['petastorm_tpu_torch'])    # [] on a clean tree

Six composable passes (nine rules) — see
:data:`~petastorm_tpu_torch.analysis.core.RULE_DESCRIPTIONS`. Passes are
per-module (``run(module)``), whole-program (``run_project(modules)`` —
the pipesan ``buffer-escape``/``buffer-write`` ownership pass and the
call-graph half of ``lock-order``, both over
:mod:`~petastorm_tpu_torch.analysis.callgraph`), or both. Findings are
structured ``(path, line, rule, message)``; a ``# pipecheck:
disable=<rule>`` comment on the offending line suppresses a finding (use
sparingly, with a justification comment), and a ``# pipesan: owns``
annotation records an intentional buffer-ownership transfer. The
contracts (:mod:`~petastorm_tpu_torch.analysis.contracts`) are the
objects of the port's one registry,
:mod:`petastorm_tpu_torch.telemetry.names`, which the telemetry and the
runtime sanitizer (:mod:`petastorm_tpu_torch.sanitizer`) read at runtime
— one source of truth, enforced from both sides. The CLI's
``--baseline``/``--fail-on-new`` let a new rule gate strictly on new code
before its backlog hits zero.

Stdlib-only by design (it imports no torch): the analyzer runs in tier-1
on a CPU-only box and on the GPU machine from the same code.
"""

from petastorm_tpu_torch.analysis import contracts  # noqa: F401

#: public API, resolved lazily (PEP 562): importing the package (or its
#: contracts) loads only the contracts data — never the whole ast/tokenize
#: analyzer — so a process that only reads the contracts pays nothing.
_CORE_API = ('ALL_RULES', 'PASSES', 'RULE_DESCRIPTIONS', 'analyze_paths',
             'analyze_source', 'iter_python_files', 'run_passes')
_FINDINGS_API = ('Finding', 'SourceModule')

__all__ = ('contracts',) + _CORE_API + _FINDINGS_API


def __getattr__(name):
    if name in _CORE_API:
        from petastorm_tpu_torch.analysis import core
        return getattr(core, name)
    if name in _FINDINGS_API:
        from petastorm_tpu_torch.analysis import findings
        return getattr(findings, name)
    raise AttributeError('module %r has no attribute %r'
                         % (__name__, name))
