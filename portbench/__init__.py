"""The benchmark of `repro_torch`, the PyTorch and CUDA port: one command
runs one cell once (`run.py`; see `README.md`)."""
