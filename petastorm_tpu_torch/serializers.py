"""The pools' result codec (counterpart of the reference's
``PickleSerializer`` in ``petastorm_tpu/serializers.py``).

:class:`PickleSerializer` has two forms. The process pool's multipart form
(``serialize_frames``) writes a worker result as a pickle protocol-5 stream
and ships every ndarray payload as its own out-of-band frame: the stream
carries only metadata, and the receiving side rebuilds the arrays as views
over the received frames (zero-copy). The decode service's framed messages
carry one payload frame per result (``serialize``), the reference's bytes.
The reference's pluggable base and its ``ArrowTableSerializer`` have no
caller in the port.
"""

import pickle

from petastorm_tpu_torch import sanitizer


class PickleSerializer:
    """The pools' payload codec."""

    def serialize(self, value):
        """One frame: the value's highest-protocol pickle."""
        return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, payload):
        return pickle.loads(payload)

    def serialize_frames(self, value):
        """Frame 0 is the protocol-5 stream; every buffer-exporting payload
        (ndarrays, Arrow buffers) follows as its own raw frame."""
        buffers = []
        head = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
        return [head] + [b.raw() for b in buffers]

    def deserialize_frames(self, frames):
        """Out-of-band arrays come back as views over ``frames[1:]``.
        Under ``PETASTORM_TPU_SANITIZE=1`` every array of the result is
        made read-only, so a consumer writing into a wire buffer raises at
        the write."""
        value = pickle.loads(frames[0], buffers=frames[1:])
        if sanitizer.sanitize_enabled():
            sanitizer.guard_payload(value)
        return value
