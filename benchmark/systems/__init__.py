"""The systems under test, one module a configuration ``family``: each
maps the benchmark's fields and weights onto the program's entry
points."""
