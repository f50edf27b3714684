"""Pytest settings for the whole repository that tests/conftest.py does not carry."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc; skips elsewhere (run on the card with -m cuda)")
