"""The port's rematerialization without recomputation: every segment runs
once and keeps its activations, as a step without ``remat`` does."""

import contextlib


def saved(*args):
    return args[-1]()


def segment(fn, *modules):
    return fn()


@contextlib.contextmanager
def segmented(generator=None):
    yield
