"""The data-parallel cell's tests; importing the package registers the
cell's CPU sizes (`conftest`)."""

from benchmark.tests.dp import conftest  # noqa: F401
