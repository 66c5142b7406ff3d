"""Data ingest of the port (counterpart of ``paddle_tpu/io``): so far the
trainer's double-buffered host-to-device stage (``dataloader``)."""
