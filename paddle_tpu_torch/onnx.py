"""``paddle.onnx`` (counterpart of ``paddle_tpu/onnx.py``): ``export``
raises, as in JAX. The port's export format is ``torch.export``'s
program archive: ``paddle_tpu_torch.jit.save(layer, path, input_spec)``
and ``jit.load`` (no ``onnx`` package is needed or used)."""

from __future__ import annotations


def export(layer, path, input_spec=None, opset_version=9, **configs):
    raise NotImplementedError(
        "ONNX export is not provided: the port exports with "
        "paddle_tpu_torch.jit.save(layer, path, input_spec) (a "
        "torch.export program) and loads with paddle_tpu_torch.jit.load")
