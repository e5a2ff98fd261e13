"""Measurement scripts of the PyTorch/CUDA port, run on one NVIDIA GPU
(each says how); ``device_timing`` holds the device-only timer that
``chip_smoke.py`` and ``kernel_turns.py`` share."""
