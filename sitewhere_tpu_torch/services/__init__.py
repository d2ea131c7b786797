"""Services of the port (``sitewhere_tpu/services``)."""
