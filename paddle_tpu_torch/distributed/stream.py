"""paddle.distributed.stream namespace (counterpart of
``paddle_tpu/distributed/stream.py``; parity:
python/paddle/distributed/communication/stream/): the stream-explicit
collectives. ``sync_op=False`` starts the collective on torch's
``async_op`` work handle and returns a task whose ``wait()`` finishes it
and gives the result; ``use_calc_stream`` is accepted for the API (NCCL
runs on its own stream, ordered after the compute stream's work)."""

from __future__ import annotations

import functools

from . import collective as _c


def _streamified(fn):
    @functools.wraps(fn)
    def wrapper(*args, sync_op=True, use_calc_stream=False, **kw):
        return fn(*args, sync_op=sync_op, **kw)

    return wrapper


all_reduce = _streamified(_c.all_reduce)
all_gather = _streamified(_c.all_gather)
reduce_scatter = _streamified(_c.reduce_scatter)
broadcast = _streamified(_c.broadcast)
reduce = _streamified(_c.reduce)
scatter = _streamified(_c.scatter)
alltoall = _streamified(_c.alltoall)
alltoall_single = _streamified(_c.alltoall_single)
send = _streamified(_c.send)
recv = _streamified(_c.recv)
