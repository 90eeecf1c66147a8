"""PyTorch/CUDA port of the ReStore reproduction (``src/repro`` is the
JAX reference).  Subpackages import directly, e.g.
``repro_torch.core.restore``; see ``device.py`` for the device rule."""
