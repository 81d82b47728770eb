"""Training consumers of the port (counterpart of ``petastorm_tpu/models``)."""
