"""paddle_tpu_torch.io — the port's native I/O (counterpart of
``paddle_tpu/io/native.py``): the token-bin data loader and the parallel
checkpoint chunk writer, both C++ built with ``g++`` at first use."""

from .native import TokenBinDataset, load_ckpt_writer  # noqa: F401
