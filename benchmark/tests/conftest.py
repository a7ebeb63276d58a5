"""The benchmark's own tests: CPU tests at small sizes, and tests marked
``cuda`` that need a card and skip without one (they decide inside the
test, never at import).  Run them from the root of the repository:

    python -m pytest benchmark/tests -q
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one.")
