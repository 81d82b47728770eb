"""The port's one reader of ``PETASTORM_TPU_*`` environment knobs
(counterpart of ``petastorm_tpu/telemetry/knobs.py``). Reading a name
missing from :data:`~petastorm_tpu_torch.telemetry.names.KNOWN_KNOBS`
raises, so a typo'd knob fails loudly. Cache-free: call sites that cache
a knob re-read it through :func:`petastorm_tpu_torch.telemetry.refresh`."""

import logging
import os

from petastorm_tpu_torch.telemetry.names import DISABLED_VALUES, ENABLED_VALUES, KNOWN_KNOBS

logger = logging.getLogger(__name__)


def _check(name):
    if name not in KNOWN_KNOBS:
        raise ValueError('Unregistered environment knob %r: add it to '
                         'petastorm_tpu_torch/telemetry/names.py' % (name,))


def raw(name, default=None):
    """The raw string value of a registered knob (``default`` when unset)."""
    _check(name)
    return os.environ.get(name, default)


def get_str(name, default=''):
    """Stripped string value of a registered knob."""
    value = raw(name, default)
    return value.strip() if isinstance(value, str) else value


def is_disabled(name):
    """True when the knob carries a disable spelling; unset is not."""
    return get_str(name).lower() in DISABLED_VALUES


def is_enabled(name):
    """True when the knob carries an enable spelling; unset is not."""
    return get_str(name).lower() in ENABLED_VALUES


def _get_number(name, default, floor, parse):
    text = get_str(name)
    value = default
    if text:
        try:
            value = parse(text)
        except ValueError:
            logger.warning('Unparseable %s=%r; using %r', name, text, default)
    if floor is not None and value is not None:
        value = max(floor, value)
    return value


def get_int(name, default, floor=None):
    """Integer value of a registered knob; an unparseable value logs a
    warning and falls back to ``default``; ``floor`` clamps from below."""
    return _get_number(name, default, floor, int)


def get_float(name, default, floor=None):
    """Float value of a registered knob; same fallback rules as
    :func:`get_int`."""
    return _get_number(name, default, floor, float)


def set_env(name, value):
    """Write a registered knob into this process's environment (a script
    arming ``PETASTORM_TPU_TRACE`` before any reader exists). Call sites
    that already cached the knob see it after ``telemetry.refresh()``."""
    _check(name)
    os.environ[name] = value
