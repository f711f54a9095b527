"""Markers of the repository's tests."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one (run on the card with "
                   "`python -m pytest -q -m card tests/test_torch_tracing.py`)")
