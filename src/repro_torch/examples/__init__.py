"""The repository's example scripts (`examples/*.py` beside the JAX
package) on the port: each a module with `main(argv=None)`, run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

with the reference script's flags, defaults, seeds and printed lines.
Those that touch a device take `--device` (default `cuda`, which raises
without a card; the tests pass `cpu`). Nothing runs at import.
"""
