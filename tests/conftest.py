"""Registers the marker of tests that need an NVIDIA GPU.  Such tests decide
inside the test whether a card is present and skip without one; on the
machine with the card run them with `python -m pytest tests/ -m cuda`.

Before any file is collected, every test process builds the JAX package's
native library through `native_lib.ensure_built` (one process at a time,
under a file lock), so the files that build it at import find it complete
and do not build it concurrently."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
    try:
        from native_lib import ensure_built
    except ImportError:  # no JAX package in this environment
        return
    ensure_built()
