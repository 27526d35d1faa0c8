"""Plain references of the benchmark's model families, one module each,
named by a configuration's ``family``. They import nothing of the
program."""
