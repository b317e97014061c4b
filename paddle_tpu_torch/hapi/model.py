"""High-level Model API (counterpart of ``paddle_tpu/hapi/model.py``;
parity: python/paddle/hapi/model.py:
``paddle.Model(net).prepare(optimizer, loss, metrics)`` then
``fit/evaluate/predict/save/load``).

The train step is the JAX one: the network is evaluated at a dict of
parameter values (``core.functional.functional_call``), the loss and
the gradients of every parameter are taken (``torch.autograd.grad``;
JAX's ``value_and_grad``), and the optimizer's functional
``update(grads, opt_state, params)`` writes the new values. As in JAX,
those values are the step's own copy of the parameters: the network's
parameters change only when an epoch ends, when ``fit`` writes the
trained values back, before that epoch's ``evaluate``. Each step reads
its loss to the host (``float``), as JAX's does. ``fit`` enters
``torch.enable_grad()``, so it trains inside ``no_grad()`` too, as
JAX's does.

Batches are moved to ``device``: the network's device, or the card for
a network without parameters (raising without one); ``evaluate`` and
``predict`` run under ``torch.no_grad()``. ``predict`` returns numpy
arrays, bfloat16 outputs as float32 (numpy has no bfloat16).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.device import current_device
from ..core.functional import extract_params, functional_call
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import Callback, CallbackList, ProgBarLogger


def _host(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self.stop_training = False
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._opt_state = None
        first = next(iter(network.parameters()), None)
        self.device = current_device(first.device if first is not None
                                     else None)

    def prepare(self, optimizer=None, loss=None, metrics=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = list(metrics or [])
        return self

    # ------------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle):
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle)
        raise TypeError(f"unsupported data type {type(data)}")

    def _to_device(self, a) -> torch.Tensor:
        """A batch part on the model's device (numpy arrays and tensors
        alike)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, non_blocking=True)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    def _train_step(self, params, x, y):
        """Loss, output and the in-place update of ``params`` and the
        optimizer state (JAX's ``train_step``)."""
        with torch.enable_grad():
            out = functional_call(self.network, params, x)
            lv = self._loss(out, y)
            grads = torch.autograd.grad(lv, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        self._optimizer.update(dict(zip(params, grads)), self._opt_state,
                               params)
        return lv.detach(), out.detach()

    def fit(
        self,
        train_data=None,
        eval_data=None,
        batch_size: int = 1,
        epochs: int = 1,
        verbose: int = 1,
        callbacks: Optional[List[Callback]] = None,
        shuffle: bool = True,
        log_freq: int = 10,
    ):
        loader = self._loader(train_data, batch_size, shuffle)
        cbs = CallbackList(callbacks)
        if verbose:
            cbs.append(ProgBarLogger(log_freq, verbose))
        cbs.set_model(self)
        # the step's own copy of every parameter (JAX's params pytree)
        params = {n: p.detach().clone().requires_grad_(True)
                  for n, p in extract_params(self.network).items()}
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(
                {n: p.detach() for n, p in params.items()})
        cbs.on_train_begin()
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbs.on_epoch_begin(epoch)
            epoch_loss = 0.0
            nb = 0
            if hasattr(loader.batch_sampler, "set_epoch"):
                loader.batch_sampler.set_epoch(epoch)
            for step, batch in enumerate(loader):
                cbs.on_train_batch_begin(step)
                x, y = self._to_device(batch[0]), self._to_device(batch[1])
                lv, out = self._train_step(params, x, y)
                lv = float(lv)
                epoch_loss += lv
                nb += 1
                logs = {"loss": lv}
                for m in self._metrics:
                    m.update(_host(out), _host(y))
                    logs[m.name()] = m.accumulate()
                del out
                cbs.on_train_batch_end(step, logs)
            # write the trained parameters back into the network
            objs = dict(self.network.named_parameters())
            with torch.no_grad():
                for n, v in params.items():
                    if n in objs:
                        objs[n].copy_(v)
            logs = {"loss": epoch_loss / max(nb, 1)}
            if eval_data is not None:
                eval_logs = self.evaluate(
                    eval_data, batch_size=batch_size, verbose=0
                )
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbs.on_eval_end(eval_logs)
            for m in self._metrics:
                m.reset()
            cbs.on_epoch_end(epoch, logs)
        cbs.on_train_end()
        return self

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size: int = 1, verbose: int = 1):
        loader = self._loader(eval_data, batch_size, shuffle=False)
        self.network.eval()
        params = extract_params(self.network)
        total, nb = 0.0, 0
        for m in self._metrics:
            m.reset()
        for batch in loader:
            x, y = self._to_device(batch[0]), self._to_device(batch[1])
            out = functional_call(self.network, params, x)
            total += float(self._loss(out, y))
            nb += 1
            for m in self._metrics:
                m.update(_host(out), _host(y))
        self.network.train()
        logs = {"loss": total / max(nb, 1)}
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        if verbose:
            print("Eval:", logs)
        return logs

    @torch.no_grad()
    def predict(self, test_data, batch_size: int = 1):
        loader = self._loader(test_data, batch_size, shuffle=False)
        self.network.eval()
        params = extract_params(self.network)
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (tuple, list)) else batch
            outs.append(_host(functional_call(self.network, params,
                                              self._to_device(x))))
        self.network.train()
        return np.concatenate(outs, axis=0)

    def save(self, path: str):
        from ..framework import io as fio

        fio.save(self.network.state_dict(), path + ".pdparams")
        if self._opt_state is not None:
            fio.save(self._opt_state, path + ".pdopt")

    def load(self, path: str):
        import os

        from ..framework import io as fio

        self.network.set_state_dict(fio.load(path + ".pdparams",
                                             device=self.device))
        if os.path.exists(path + ".pdopt"):
            self._opt_state = fio.load(path + ".pdopt", device=self.device)
        return self

    def parameters(self):
        return self.network.parameters()

    def summary(self):
        n_params = sum(int(np.prod(tuple(p.shape)))
                       for p in self.network.parameters())
        lines = [repr(self.network), f"Total params: {n_params:,}"]
        text = "\n".join(lines)
        print(text)
        return {"total_params": n_params}
