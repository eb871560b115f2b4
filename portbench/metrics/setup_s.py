"""Seconds from the process's start to the first timed request or step:
imports, the weights, the cache, the warm-up and any kernel build."""


def read(run):
    return run.setup_s
