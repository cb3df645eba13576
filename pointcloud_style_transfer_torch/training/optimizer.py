"""The JAX trainer's optimizer (``training/trainer.py::make_optimizer``),
written out on tensors the way optax 0.2.6 computes it:

    MultiSteps(chain(clip_by_global_norm(max_norm),
                     scale_by_adam(b1=0.9, b2=0.95, eps=1e-8, eps_root=0),
                     add_decayed_weights(weight_decay),
                     scale(-1)),
               every_k_schedule=k)

and the learning rate multiplied in afterwards, as the JAX train step does.
``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: they round in
another order, and torch clips by ``max_norm / (norm + 1e-6)``.

The per-step arithmetic, element by element:

* accumulate: ``acc + (g - acc) / (mini_step + 1)`` (the running mean);
* the inner chain runs on ``acc`` at every mini-step, but its state is kept
  only when the step emits (``mini_step == k - 1``), and the update applied
  is ``emit * update`` (so a non-emitting step adds zeros);
* clip: ``acc`` if ``norm < max_norm`` else ``acc / norm * max_norm``;
* Adam: ``mu = 0.1 g + 0.9 mu``, ``nu = 0.05 g^2 + 0.95 nu``, bias
  corrections ``1 - b**count`` in float32, ``mu_hat / (sqrt(nu_hat) + eps)``;
* ``+ weight_decay * param``, ``* -1``, then ``* lr`` and added to the
  parameter;
* on emit ``acc`` is reset to 0 and ``gradient_step`` advances.

The moments and the accumulator are kept as flat float32 buffers over all
parameters (in the order of the dict given at construction), so one step is a
handful of kernels whatever the number of tensors. The global norm is one
sum over that buffer, where optax sums leaf by leaf: the two agree to
float32 rounding.

The whole state lives on the parameters' device, in tensors whose addresses
never change: the counters are 0-d int32 tensors (optax's), ``emit`` is
computed there, and the new state is selected with ``torch.where(emit, new,
old)`` and written in place, as optax's ``MultiSteps`` selects it inside the
JAX package's jitted, donated step. So a step reads nothing back to the
host, and a CUDA graph of it (``training/trainer.py``) reads and writes the
state where it stands. ``state_dict`` reads the counters once, as ints.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import torch

Params = Dict[str, torch.Tensor]


class MultiStepsAdamW:
    b1, b2, eps = 0.9, 0.95, 1e-8  # scale_by_adam(0.9, 0.95), optax's eps
    COUNTERS = ("mini_step", "gradient_step", "count")  # count: Adam's

    def __init__(self, params: Params, *, max_norm: float = 1.0,
                 weight_decay: float = 1e-4, every_k: int = 3):
        self.names = list(params)
        self.shapes = [p.shape for p in params.values()]
        self.sizes = [p.numel() for p in params.values()]
        device = next(iter(params.values())).device
        n = sum(self.sizes)
        self.max_norm, self.weight_decay = max_norm, weight_decay
        self.every_k = max(1, every_k)
        self.mu = torch.zeros(n, device=device)
        self.nu = torch.zeros(n, device=device)
        self.acc_grads = torch.zeros(n, device=device)
        for name in self.COUNTERS:
            setattr(self, name, torch.zeros((), dtype=torch.int32,
                                            device=device))
        self._decay = {b: torch.tensor(b, dtype=torch.float32, device=device)
                       for b in (self.b1, self.b2)}

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor a step reads or writes in place, by name: the state
        and the decays of the bias corrections."""
        return {**{name: getattr(self, name)
                   for name in ("mu", "nu", "acc_grads", *self.COUNTERS)},
                **{f"decay{b}": t for b, t in self._decay.items()}}

    def _flat(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat([t.detach().reshape(-1).float() for t in tensors])

    def _unflat(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view(s) for v, s in zip(flat.split(self.sizes), self.shapes)]

    def _bias_correction(self, decay: float, count: torch.Tensor
                         ) -> torch.Tensor:
        """1 - decay**count in float32, as optax computes it."""
        return 1 - self._decay[decay] ** count.float()

    @torch.no_grad()
    def step(self, params: Params, grads: Sequence[torch.Tensor],
             lr: Union[float, torch.Tensor]) -> torch.Tensor:
        """One mini-step: accumulate ``grads`` (in the order of ``params``),
        run the inner chain, add ``lr * emit * update`` to ``params`` in
        place. ``lr`` is a float or a 0-d float32 tensor (the same product
        either way). Returns whether this mini-step emitted (a real
        optimizer step) as a 0-d bool tensor on the device."""
        plist = [params[k] for k in self.names]
        g = self._flat(grads)
        n = self.mini_step
        acc = self.acc_grads + (g - self.acc_grads) / (n + 1)

        norm = torch.sqrt(torch.sum(acc * acc))
        clipped = torch.where(norm < self.max_norm, acc,
                              acc / norm * self.max_norm)
        mu = (1 - self.b1) * clipped + self.b1 * self.mu
        nu = (1 - self.b2) * (clipped * clipped) + self.b2 * self.nu
        count = self.count + 1
        mu_hat = mu / self._bias_correction(self.b1, count)
        nu_hat = nu / self._bias_correction(self.b2, count)
        update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        update = update + self.weight_decay * self._flat(plist)
        update = -1.0 * update

        emit = n == self.every_k - 1
        update = update * emit
        torch._foreach_add_(plist, self._unflat(update * lr))
        # the state optax keeps: the inner chain's only on emit, then the
        # accumulator reset and the gradient step advanced
        self.mu.copy_(torch.where(emit, mu, self.mu))
        self.nu.copy_(torch.where(emit, nu, self.nu))
        self.count.copy_(torch.where(emit, count, self.count))
        self.acc_grads.copy_(torch.where(emit, 0.0, acc))
        self.gradient_step.add_(emit)
        self.mini_step.copy_((n + 1) % self.every_k)
        return emit

    def state_dict(self) -> dict:
        """Counters (ints) and, by parameter name, ``mu``, ``nu``,
        ``acc_grads`` (optax's ``MultiStepsState`` in the port's names)."""
        def named(flat):
            return {k: v.clone() for k, v in zip(self.names,
                                                 self._unflat(flat))}
        return {**{name: int(getattr(self, name)) for name in self.COUNTERS},
                "mu": named(self.mu), "nu": named(self.nu),
                "acc_grads": named(self.acc_grads)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copies into the existing tensors: a captured step goes on
        reading and writing the loaded state."""
        for key in ("mu", "nu", "acc_grads"):
            getattr(self, key).copy_(self._flat(
                [state[key][k] for k in self.names]))
        for name in self.COUNTERS:
            getattr(self, name).fill_(int(state[name]))
