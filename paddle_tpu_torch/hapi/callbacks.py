"""High-level training callbacks (counterpart of
``paddle_tpu/hapi/callbacks.py``; parity: python/paddle/hapi/callbacks.py:
the Callback base, ProgBarLogger, ModelCheckpoint, EarlyStopping,
LRScheduler, VisualDL as a generic scalar logger, and MetricsLogger
publishing through the observability registry).

Scalar emission (ProgBarLogger prints, VisualDL JSONL) is also routed
through ``observability.record_scalars``, so hapi training feeds the
process-wide telemetry registry. The callbacks take Python numbers and
make the JAX package's decisions."""

from __future__ import annotations

import os
import time
from typing import List, Optional

from ..observability import record_scalars


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)

            return dispatch
        raise AttributeError(name)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)


class ProgBarLogger(Callback):
    def __init__(self, log_freq: int = 10, verbose: int = 1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.t0 = time.perf_counter()
        if self.verbose:
            print(f"Epoch {epoch + 1}")

    def on_train_batch_end(self, step, logs=None):
        if step % self.log_freq == 0:
            record_scalars("hapi_train", logs)
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (logs or {}).items()
            )
            print(f"  step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.perf_counter() - self.t0
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (logs or {}).items()
            )
            print(f"  epoch {epoch + 1} done in {dt:.1f}s - {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: str = "ckpt"):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"epoch_{epoch}")
            self.model.save(path)


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0,
                 min_delta=0.0, baseline=None):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = min_delta
        self.best = baseline
        self.wait = 0
        self.stopped_epoch = None

    def _better(self, cur, best):
        if best is None:
            return True
        if self.mode == "min":
            return cur < best - self.min_delta
        return cur > best + self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if self._better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True


class LRSchedulerCallback(Callback):
    """Steps the optimizer's LR scheduler per epoch (parity: hapi
    LRScheduler callback; per-step scheduling happens inside TrainStep)."""

    def __init__(self, by_step: bool = False):
        self.by_step = by_step

    def on_epoch_end(self, epoch, logs=None):
        sched = getattr(self.model._optimizer, "_lr_scheduler", None)
        if sched is not None and not self.by_step:
            sched.step()


# paddle name: callbacks.LRScheduler
LRScheduler = LRSchedulerCallback


class ReduceLROnPlateau(Callback):
    """Parity: hapi callbacks.ReduceLROnPlateau — shrink the scheduler
    LR when ``monitor`` stops improving."""

    def __init__(self, monitor="loss", factor=0.1, patience=10,
                 mode="min", min_delta=1e-4, cooldown=0, min_lr=0.0,
                 verbose=1):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.verbose = verbose
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(cur):
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = self.model._optimizer
            sched = getattr(opt, "_lr_scheduler", None)
            target = sched if sched is not None else opt
            old = float(getattr(target, "base_lr",
                                getattr(target, "learning_rate", 0.0)))
            new = max(old * self.factor, self.min_lr)
            if hasattr(target, "base_lr"):
                target.base_lr = new
            else:
                target.learning_rate = new
            if self.verbose:
                print(f"ReduceLROnPlateau: lr {old:.3g} -> {new:.3g}")
            self.wait = 0
            self.cooldown_counter = self.cooldown


class VisualDL(Callback):
    """Parity: hapi callbacks.VisualDL. The visualdl package is not
    available in this environment; scalars are appended to a JSONL
    file a local VisualDL/TensorBoard shim can tail."""

    def __init__(self, log_dir="vdl_log"):
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, logs):
        import json

        record_scalars(f"hapi_{tag}", logs)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "scalars.jsonl")
        rec = {"tag": tag, "step": self._step}
        for k, v in (logs or {}).items():
            try:
                rec[k] = float(v[0] if isinstance(v, (list, tuple)) else v)
            except (TypeError, ValueError):
                continue
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % 10 == 0:
            self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


class MetricsLogger(Callback):
    """Publish every hapi train/eval scalar through the observability
    registry (``pt_hapi_train_*`` / ``pt_hapi_eval_*`` gauges plus step
    and epoch counters), so ``Model.fit`` runs show up on the same
    ``/metrics`` scrape as TrainStep and the serving engine."""

    def __init__(self, log_freq: int = 1):
        self.log_freq = max(1, int(log_freq))

    def on_train_begin(self, logs=None):
        from ..observability import get_registry

        reg = get_registry()
        self._steps = reg.counter(
            "pt_hapi_steps_total", "hapi train batches")
        self._epochs = reg.counter(
            "pt_hapi_epochs_total", "hapi epochs completed")

    def on_train_batch_end(self, step, logs=None):
        self._steps.inc()
        if step % self.log_freq == 0:
            record_scalars("hapi_train", logs)

    def on_epoch_end(self, epoch, logs=None):
        self._epochs.inc()
        record_scalars("hapi_train", logs)

    def on_eval_end(self, logs=None):
        record_scalars("hapi_eval", logs)
