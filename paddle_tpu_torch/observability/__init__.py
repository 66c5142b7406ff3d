"""Observability of the PyTorch/CUDA port (counterpart of
``paddle_tpu/observability/``): so far the serving engine's decode-step
roofline model, :mod:`.roofline`."""
