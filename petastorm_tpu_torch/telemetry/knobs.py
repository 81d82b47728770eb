"""The port's one reader of ``PETASTORM_TPU_*`` environment knobs
(counterpart of ``petastorm_tpu/telemetry/knobs.py``). Reading a name
missing from :data:`~petastorm_tpu_torch.telemetry.names.KNOWN_KNOBS`
raises, so a typo'd knob fails loudly."""

import logging
import os

from petastorm_tpu_torch.telemetry.names import DISABLED_VALUES, KNOWN_KNOBS

logger = logging.getLogger(__name__)


def get_str(name, default=''):
    """Stripped string value of a registered knob."""
    if name not in KNOWN_KNOBS:
        raise ValueError('Unregistered environment knob %r: add it to '
                         'petastorm_tpu_torch/telemetry/names.py' % (name,))
    return os.environ.get(name, default).strip()


def is_disabled(name):
    """True when the knob carries a disable spelling; unset is not."""
    return get_str(name).lower() in DISABLED_VALUES


def get_int(name, default, floor=None):
    """Integer value of a registered knob; an unparseable value logs a
    warning and falls back to ``default``; ``floor`` clamps from below."""
    text = get_str(name)
    value = default
    if text:
        try:
            value = int(text)
        except ValueError:
            logger.warning('Unparseable %s=%r; using %r', name, text, default)
    if floor is not None:
        value = max(floor, value)
    return value
