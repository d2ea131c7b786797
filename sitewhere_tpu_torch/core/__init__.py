"""Domain model helpers of the port (``sitewhere_tpu/core``)."""
