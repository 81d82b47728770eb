"""The contracts pipecheck verifies, read from the port's one registry
(:mod:`petastorm_tpu_torch.telemetry.names`): the runtime and the
analyzer hold the same objects, so a name cannot be canonical to one and
not the other.
"""

from petastorm_tpu_torch.telemetry.names import (  # noqa: F401
    ANOMALY_KINDS, BORROW_ATTRS, BORROW_CALL_KWARGS, BORROW_CALLS, DISABLED_VALUES,
    ENABLED_VALUES, EVENT_NAMES, FAULTPOINTS, KNOB_PREFIX, KNOWN_KNOBS, METRIC_NAMES,
    OWNS_ANNOTATION_RE, STAGES,
)
