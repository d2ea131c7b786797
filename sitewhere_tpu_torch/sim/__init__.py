"""Synthetic traffic of the port (``sitewhere_tpu/sim``)."""
