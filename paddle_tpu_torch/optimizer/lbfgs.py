"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``: the closure
API of paddle.optimizer.LBFGS, ``opt.step(closure)``, with
``history_size`` curvature pairs and an optional strong-Wolfe line
search).

L-BFGS is driven from the host by nature: its convergence tests and the
line search's length depend on the data. The port keeps the JAX
version's control flow and arithmetic: the flat vectors are float32
tensors on the parameters' device, and the scalars its tests and the
two-loop recursion read (``float(y @ s)``, the loss, the gradient's max)
come to the host where the JAX version reads them, one sync each.

The closure computes the loss and calls ``backward()``; the optimizer
reads ``p.grad`` of the parameters it was given (a parameter without one
counts as a zero gradient). Clear the gradients in the closure
(``opt.clear_grad()``) so they do not accumulate across evaluations.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _cubic_interpolate(x1, f1, g1, x2, f2, g2):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2); the
    midpoint when the cubic has no real minimum between them."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 * d1 - g1 * g2
    xmin, xmax = min(x1, x2), max(x1, x2)
    if d2_square >= 0:
        d2 = math.sqrt(d2_square)
        if x1 <= x2:
            denom = g2 - g1 + 2 * d2
            if denom != 0:
                t = x2 - (x2 - x1) * ((g2 + d2 - d1) / denom)
                return min(max(t, xmin), xmax)
        else:
            denom = g1 - g2 + 2 * d2
            if denom != 0:
                t = x1 - (x1 - x2) * ((g1 + d2 - d1) / denom)
                return min(max(t, xmin), xmax)
    return (xmin + xmax) / 2.0


def _flatten(tensors):
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


class LBFGS:
    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.lr = float(learning_rate)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        # the state kept across step() calls
        self._state = {
            "func_evals": 0, "n_iter": 0,
            "old_sks": [], "old_yks": [], "ro": [],
            "d": None, "t": None, "prev_flat_grad": None, "H_diag": 1.0,
        }

    # -- parameter plumbing ----------------------------------------------
    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    @torch.no_grad()
    def _scatter(self, flat):
        i = 0
        for p in self._params():
            n = p.numel()
            p.copy_(flat[i:i + n].view(p.shape))
            i += n

    def _eval(self, closure, flat_x):
        """Set the parameters to ``flat_x``, run the closure, return
        (loss, flat_grad)."""
        self._scatter(flat_x)
        with torch.enable_grad():
            loss = closure()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params()]
        self._state["func_evals"] += 1
        return float(loss), _flatten(grads)

    # -- strong Wolfe (cubic-interpolation zoom) -------------------------
    def _strong_wolfe(self, closure, x, t, d, f, g, gtd,
                      c1=1e-4, c2=0.9, max_ls=25):
        d_norm = float(torch.max(torch.abs(d)))
        g_prev, f_prev, t_prev = g, f, 0.0
        ls_iter = 0
        # bracket phase
        f_new, g_new = self._eval(closure, x + t * d)
        gtd_new = float(g_new @ d)
        bracket = None
        while ls_iter < max_ls:
            if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
                bracket = (t_prev, t, f_prev, f_new, g_prev, g_new)
                break
            if abs(gtd_new) <= -c2 * gtd:
                return f_new, g_new, t, ls_iter
            if gtd_new >= 0:
                bracket = (t_prev, t, f_prev, f_new, g_prev, g_new)
                break
            t_prev, f_prev, g_prev = t, f_new, g_new
            t = 2.0 * t  # bracket expansion
            f_new, g_new = self._eval(closure, x + t * d)
            gtd_new = float(g_new @ d)
            ls_iter += 1
        if bracket is None:
            return f_new, g_new, t, ls_iter
        lo_t, hi_t, lo_f, hi_f, lo_g, hi_g = bracket
        if lo_f > hi_f:
            lo_t, hi_t, lo_f, hi_f, lo_g, hi_g = \
                hi_t, lo_t, hi_f, lo_f, hi_g, lo_g
        lo_gtd, hi_gtd = float(lo_g @ d), float(hi_g @ d)
        # zoom phase: cubic interpolation with the insufficient-progress
        # safeguard (toward the bounds, then bisection)
        insuf_progress = False
        while ls_iter < max_ls:
            if abs(hi_t - lo_t) * d_norm < self.tolerance_change:
                break
            xmin, xmax = min(lo_t, hi_t), max(lo_t, hi_t)
            t = _cubic_interpolate(lo_t, lo_f, lo_gtd, hi_t, hi_f, hi_gtd)
            eps = 0.1 * (xmax - xmin)
            if min(xmax - t, t - xmin) < eps:
                if insuf_progress or t >= xmax or t <= xmin:
                    t = xmax - eps if abs(t - xmax) < abs(t - xmin) \
                        else xmin + eps
                    insuf_progress = False
                else:
                    insuf_progress = True
            else:
                insuf_progress = False
            f_new, g_new = self._eval(closure, x + t * d)
            gtd_new = float(g_new @ d)
            ls_iter += 1
            if f_new > (f + c1 * t * gtd) or f_new >= lo_f:
                hi_t, hi_f, hi_g, hi_gtd = t, f_new, g_new, gtd_new
            else:
                if abs(gtd_new) <= -c2 * gtd:
                    return f_new, g_new, t, ls_iter
                if gtd_new * (hi_t - lo_t) >= 0:
                    hi_t, hi_f, hi_g, hi_gtd = lo_t, lo_f, lo_g, lo_gtd
                lo_t, lo_f, lo_g, lo_gtd = t, f_new, g_new, gtd_new
        return lo_f, lo_g, lo_t, ls_iter

    # -- main --------------------------------------------------------------
    @torch.no_grad()
    def step(self, closure: Callable[[], torch.Tensor]) -> torch.Tensor:
        """One L-BFGS step (up to ``max_iter`` inner iterations); returns
        the loss of the last evaluation as a float32 0-d tensor on the
        parameters' device."""
        st = self._state
        params = self._params()
        device = params[0].device if params else "cpu"
        x0 = _flatten(params)
        loss, flat_grad = self._eval(closure, x0)
        if float(torch.max(torch.abs(flat_grad))) <= self.tolerance_grad:
            return torch.tensor(loss, dtype=torch.float32, device=device)

        x = x0
        n_inner = 0
        while n_inner < self.max_iter:
            n_inner += 1
            st["n_iter"] += 1
            # the direction by the two-loop recursion
            if st["prev_flat_grad"] is None:
                d = -flat_grad
                st["H_diag"] = 1.0
            else:
                y = flat_grad - st["prev_flat_grad"]
                s = st["d"] * st["t"]
                ys = float(y @ s)
                if ys > 1e-10:
                    if len(st["old_sks"]) >= self.history_size:
                        st["old_sks"].pop(0)
                        st["old_yks"].pop(0)
                        st["ro"].pop(0)
                    st["old_sks"].append(s)
                    st["old_yks"].append(y)
                    st["ro"].append(1.0 / ys)
                    st["H_diag"] = ys / float(y @ y)
                q = -flat_grad
                alphas = []
                for s_i, y_i, ro_i in zip(reversed(st["old_sks"]),
                                          reversed(st["old_yks"]),
                                          reversed(st["ro"])):
                    alpha = ro_i * float(s_i @ q)
                    alphas.append(alpha)
                    q = q - alpha * y_i
                d = q * st["H_diag"]
                for (s_i, y_i, ro_i), alpha in zip(
                        zip(st["old_sks"], st["old_yks"], st["ro"]),
                        reversed(alphas)):
                    beta = ro_i * float(y_i @ d)
                    d = d + s_i * (alpha - beta)
            st["prev_flat_grad"] = flat_grad

            gtd = float(flat_grad @ d)
            if gtd > -self.tolerance_change:
                break
            t = (min(1.0, 1.0 / float(torch.sum(torch.abs(flat_grad))))
                 * self.lr if st["n_iter"] == 1 else self.lr)

            if self.line_search_fn == "strong_wolfe":
                loss, flat_grad, t, _ = self._strong_wolfe(
                    closure, x, t, d, loss, flat_grad, gtd)
                x = x + t * d
                self._scatter(x)
            else:
                x = x + t * d
                loss, flat_grad = self._eval(closure, x)
            st["d"], st["t"] = d, t

            if st["func_evals"] >= self.max_eval:
                break
            if float(torch.max(torch.abs(flat_grad))) <= self.tolerance_grad:
                break
            if float(torch.max(torch.abs(t * d))) <= self.tolerance_change:
                break
        return torch.tensor(loss, dtype=torch.float32, device=device)

    # the Optimizer surface that schedulers and trainers use -------------
    def get_lr(self):
        return self.lr

    def clear_grad(self):
        for p in self._params():
            p.grad = None

    def state_dict(self):
        st = dict(self._state)
        # a snapshot of the curvature history, which step() keeps
        # appending to and popping from
        for k in ("old_sks", "old_yks", "ro"):
            st[k] = list(st[k])
        return {"lr": self.lr, "state": st}

    def set_state_dict(self, d):
        self.lr = d.get("lr", self.lr)
        self._state.update(d.get("state", {}))
