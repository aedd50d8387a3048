"""Registers the marker of tests that need an NVIDIA GPU (they skip on a
machine without one; run them there with ``pytest -m cuda``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)")
