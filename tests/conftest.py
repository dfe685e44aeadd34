"""Registers the marker of tests that need an NVIDIA GPU.  Such tests decide
inside the test whether a card is present and skip without one; on the
machine with the card run them with `python -m pytest tests/ -m cuda`."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
