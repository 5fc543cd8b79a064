"""Unique name generator for program variables (counterpart of
``paddle_tpu/unique_name.py``): per-prefix counters with guard-based
scoping, so both packages name the same program's variables alike."""

import contextlib

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    """Generates names like ``fc_0.w_0``, ``tmp_3`` from per-prefix counters."""

    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}

    def __call__(self, key):
        tmp = self.ids.get(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
