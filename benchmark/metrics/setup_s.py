"""Seconds from the start of the benchmark's process to the first timed
call: imports, weights and inputs made from the seed, the kernel build on a
checkout's first run, and the warm-up of the cell's own shapes."""


def read(run: dict):
    return run["setup_s"]
