"""One-process identities of the port's data-parallel helpers: the
reference runs the global batch in one process."""

import contextlib


def active():
    return None


@contextlib.contextmanager
def sharded(shard):
    yield


def rows_of(x):
    return x


def embed_rows(x, fill):
    return x


def draw_rows(shape, draw):
    return draw(tuple(shape))


def mean_over_shard(x, differentiable=False):
    return x


def sum_over_shard(x):
    return x
