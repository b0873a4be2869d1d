"""pytest set-up for every test of the repository: the time limit on each
test call and the xdist queue of tests/suite_plan.py. It sits above tests/ so
that tests/conftest.py stays the JAX reference's own."""

pytest_plugins = ["tests.suite_plan"]
