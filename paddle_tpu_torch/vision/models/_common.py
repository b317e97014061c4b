"""What the zoo's models share: building every layer on the model's
device from the model's own seed."""

from __future__ import annotations

import contextlib

from ...core.device import current_device, device_scope
from ...core.random import generator_scope, make_generator


@contextlib.contextmanager
def building(device, seed: int):
    """Inside the block, layers built without a ``device`` land on
    ``device`` (None: the current device, the card unless
    ``set_device("cpu")`` chose the host; without a card it raises) and
    draw their weights from a generator seeded with ``seed`` there; a
    ``norm_layer`` factory that passes no device lands there too."""
    dev = current_device(device)
    with device_scope(dev), generator_scope(make_generator(seed, dev)):
        yield dev
