def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one (run on "
        "the card with: PYTHONPATH=src python -m pytest -m cuda "
        "tests/test_torch_cuda.py)")
