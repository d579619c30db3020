"""An autouse fixture for the port's tests that run a driver's ``main``:
each test runs from its own temporary directory, so the end-of-run
checkpoint a driver writes by default (``./checkpoints/<prog>``) lands
there, not in the checkout, and parallel test workers never share one.
A test module takes it with ``from _torch_tmp_cwd import tmp_cwd``."""

import pytest


@pytest.fixture(autouse=True)
def tmp_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path
