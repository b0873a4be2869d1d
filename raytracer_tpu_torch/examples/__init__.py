"""The port's examples (counterparts of the repository's ``examples/``)."""
