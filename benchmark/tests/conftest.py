import pytest

from . import tiny


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A checkout with the tiny cells (fp32 compute), made once."""
    return tiny.checkout(tmp_path_factory.mktemp("bench"))
