"""Streaming mixture engine: deterministic multi-dataset mixing and
token-budget sequence packing (counterpart of ``petastorm_tpu/mixture``).

Public surface::

    from petastorm_tpu_torch.mixture import (
        MixtureSpec, MixtureSource,      # declarative mixture description
        MixtureStream,                   # the packed-row iterator
        MixtureBatchReader,              # reader-shaped adapter (TorchLoader)
        InterleaveSchedule,              # arithmetic source order
        SequencePacker,                  # doc -> fixed-row packing
        merge_mixture_states,            # N -> M elastic resume
    )
"""

from petastorm_tpu_torch.mixture.adapter import MixtureBatchReader  # noqa: F401
from petastorm_tpu_torch.mixture.engine import (  # noqa: F401
    MixtureStream, build_source_readers, merge_mixture_states,
)
from petastorm_tpu_torch.mixture.interleave import (  # noqa: F401
    InterleaveSchedule, realized_deviation,
)
from petastorm_tpu_torch.mixture.packing import SequencePacker  # noqa: F401
from petastorm_tpu_torch.mixture.spec import (  # noqa: F401
    MixtureSource, MixtureSpec,
)
