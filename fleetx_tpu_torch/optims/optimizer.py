"""AdamW with the name-based decay mask and one global-norm clip (port of
``fleetx_tpu/optims/optimizer.py:30-135, 153-184``).

The JAX package chains ``clip_by_precomputed_norm`` → ``scale_by_adam``
(f32 moments) → ``add_decayed_weights`` (masked) →
``scale_by_learning_rate``. ``AdamW.update`` is that chain written out as
a loop over the parameter tensors, updating them in place:

- one global norm ``sqrt(sum of squares)`` over every grad; grads are
  scaled by ``max_norm / g_norm`` only when ``g_norm >= max_norm`` (a NaN
  norm propagates into the update). This is not
  ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm;
- ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, bias-corrected
  with the step count ``t + 1``, ``u = mu_hat / (sqrt(nu_hat) + eps)``;
- ``u += weight_decay · p`` where the decay mask is True;
- ``p += -lr(t) · u``.

``flat_state`` / ``load_flat_state`` turn the state into the flat named
dict a checkpoint holds (``count``, ``decay``, ``mu/<leaf path>``,
``nu/<leaf path>``) and back, bit for bit.

On a mesh each rank passes its blocks of the leaves (the engine's ZeRO
slices, its tensor-parallel blocks) and the norm covers the whole tree:
``global_norm(grads, axes, mesh)`` psums each leaf's sum of squares over
the mesh axes that leaf is split on, so a replicated leaf counts once.
The update itself is elementwise and runs on whatever blocks it is given.

``Momentum`` (``sgd``, :138-150) is ``optax.sgd`` after the same clip:
``trace = g + momentum · trace`` (zeros at init, the parameter's dtype),
``p += -lr(t) · trace``; no weight decay, as in the JAX chain.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

import torch

NO_DECAY_SUBSTRINGS = ("bias", "norm", "layernorm")
NO_DECAY_EXACT = ("ln", "ln1", "ln2", "ln_f")


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> Iterator:
    """``(path, leaf)`` pairs of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    else:
        yield path, tree


def is_no_decay_path(path: tuple) -> bool:
    """True if a param path is excluded from weight decay: a key contains
    "bias" or "norm", or is a LayerNorm module name."""
    for k in (str(p).lower() for p in path):
        if any(tok in k for tok in NO_DECAY_SUBSTRINGS) or k in NO_DECAY_EXACT:
            return True
    return False


def decay_mask(params: Any, path: tuple = ()) -> Any:
    """Nested dict of bools: True where weight decay applies."""
    if isinstance(params, dict):
        return {k: decay_mask(v, path + (k,)) for k, v in params.items()}
    return not is_no_decay_path(path)


def global_norm(grads: list, axes: Optional[list] = None,
                mesh: Any = None) -> torch.Tensor:
    """``sqrt`` of the sum of every grad's sum of squares (a 0-d tensor).
    With ``axes`` (per grad, the mesh axes its block is split over) the
    sum covers the whole tree of a mesh: the leaves split the same way
    are summed, that sum psum'd over their axes."""
    if axes is None or mesh is None:
        return torch.sqrt(sum((g * g).sum() for g in grads))
    from fleetx_tpu_torch.parallel.mesh import psum_axes

    groups: dict = {}
    for g, ax in zip(grads, axes):
        key = tuple(sorted(set(ax)))
        groups[key] = groups.get(key, 0) + (g * g).sum()
    return torch.sqrt(sum(psum_axes(v, k, mesh)
                          for k, v in sorted(groups.items())))


class AdamW:
    """AdamW + global-norm clip + name-based decay mask, f32 moments."""

    def __init__(self, learning_rate: Callable[[int], float], *,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 1.0,
                 multi_precision: bool = True):
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None
        self.multi_precision = multi_precision

    def init(self, params: dict) -> dict:
        """Optimizer state: step count, moments, decay flags (flat lists
        in ``tree_leaves_with_path`` order)."""
        leaves = list(tree_leaves_with_path(params))
        mu_dtype = torch.float32 if self.multi_precision else None
        return {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for _, p in leaves],
            "nu": [torch.zeros_like(p) for _, p in leaves],
            "decay": [not is_no_decay_path(path) for path, _ in leaves],
        }

    @torch.no_grad()
    def grad_norm(self, grads: list, grad_scale: float = 1.0,
                  axes: Optional[list] = None,
                  mesh: Any = None) -> torch.Tensor:
        """The global norm of ``grads · grad_scale`` (a 0-d tensor), taken
        on the grads as given and scaled after: with the loss scaler's
        power-of-two ``grad_scale`` the product is exact, so this equals
        the norm of the unscaled grads without a pass that unscales
        them. ``axes`` / ``mesh``: a mesh's blocks (``global_norm``)."""
        g_norm = global_norm(grads, axes, mesh)
        return g_norm if grad_scale == 1.0 else g_norm * grad_scale

    @torch.no_grad()
    def update(self, params: list, grads: list, state: dict,
               g_norm: Optional[torch.Tensor] = None,
               grad_scale: float = 1.0) -> torch.Tensor:
        """One step on the flat parameter list, in place; returns the
        global grad norm (before clipping) as a 0-d tensor.

        ``grad_scale`` unscales loss-scaled grads (``1 / loss_scale``, a
        power of two) without a pass of its own: the clip divides the
        scaled grads by the unscaled norm, and the moment updates take
        ``grad_scale`` (squared for ``nu``) into the ``alpha`` they
        already multiply by. Scaling by a power of two is exact, so the
        moments and params are bit for bit those of the unscaled grads.
        ``g_norm`` is ``grad_norm(grads, grad_scale)`` when the caller has
        it already."""
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        if g_norm is None:
            g_norm = self.grad_norm(grads, grad_scale)
        count = state["count"]
        lr = float(self.learning_rate(count))
        t = count + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        if self.grad_clip is not None:
            trigger = g_norm < self.grad_clip
        for i, (p, g) in enumerate(zip(params, grads)):
            if self.grad_clip is not None:
                g = torch.where(trigger, g, (g / g_norm) * self.grad_clip)
            mu, nu = state["mu"][i], state["nu"][i]
            mu.mul_(b1).add_(g.to(mu.dtype), alpha=(1.0 - b1) * grad_scale)
            nu.mul_(b2).add_(g * g, alpha=(1.0 - b2) * grad_scale ** 2)
            del g
            # the chain's arithmetic, op for op, with the temporaries
            # updated in place: two leaf-sized buffers at a time
            denom = torch.sqrt(nu / c2).add_(eps)
            u = (mu / c1).div_(denom)
            del denom
            if self.weight_decay and state["decay"][i]:
                u.add_(self.weight_decay * p)
            p.add_(u.mul_(-lr).to(p.dtype))
        state["count"] = t
        return g_norm

    @staticmethod
    def flat_state(state: dict, params: dict) -> dict:
        """The state as a flat named dict for a checkpoint: ``count``,
        ``decay`` (one flag per leaf) and ``mu/<leaf path>`` /
        ``nu/<leaf path>``, the tensors themselves (not copies)."""
        paths = ["/".join(p) for p, _ in tree_leaves_with_path(params)]
        flat = {"count": int(state["count"]),
                "decay": [bool(d) for d in state["decay"]]}
        for key in ("mu", "nu"):
            flat.update({f"{key}/{p}": t for p, t in zip(paths, state[key])})
        return flat

    @staticmethod
    def load_flat_state(state: dict, flat: dict, params: dict) -> None:
        """Restore ``flat_state`` output into ``state`` in place, bit for
        bit (the moments are copied into the existing tensors); raises on
        a missing leaf or a shape that differs."""
        paths = ["/".join(p) for p, _ in tree_leaves_with_path(params)]
        decay = [bool(d) for d in torch.as_tensor(flat["decay"]).tolist()]
        if len(decay) != len(paths):
            raise ValueError(f"checkpoint has {len(decay)} decay flags for "
                             f"{len(paths)} parameters")
        for key in ("mu", "nu"):
            for p, t in zip(paths, state[key]):
                saved = flat[f"{key}/{p}"]
                if tuple(saved.shape) != tuple(t.shape):
                    raise ValueError(f"{key}/{p}: checkpoint shape "
                                     f"{tuple(saved.shape)} != "
                                     f"{tuple(t.shape)}")
                t.copy_(saved)
        state["count"] = int(flat["count"])
        state["decay"] = decay


class Momentum:
    """SGD with heavy-ball momentum after the global-norm clip; the
    interface of ``AdamW`` (``init``, ``grad_norm``, ``update``,
    ``flat_state``, ``load_flat_state``)."""

    def __init__(self, learning_rate: Callable[[int], float], *,
                 momentum: float = 0.9, grad_clip: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.grad_clip = grad_clip if grad_clip and grad_clip > 0 else None

    def init(self, params: dict) -> dict:
        """Step count and one momentum trace per leaf (flat, in
        ``tree_leaves_with_path`` order)."""
        return {"count": 0,
                "trace": [torch.zeros_like(p)
                          for _, p in tree_leaves_with_path(params)]}

    @torch.no_grad()
    def grad_norm(self, grads: list, grad_scale: float = 1.0,
                  axes: Optional[list] = None,
                  mesh: Any = None) -> torch.Tensor:
        """As ``AdamW.grad_norm``."""
        g_norm = global_norm(grads, axes, mesh)
        return g_norm if grad_scale == 1.0 else g_norm * grad_scale

    @torch.no_grad()
    def update(self, params: list, grads: list, state: dict,
               g_norm: Optional[torch.Tensor] = None,
               grad_scale: float = 1.0) -> torch.Tensor:
        """One step on the flat parameter list, in place; returns the
        global grad norm before clipping. ``grad_scale`` unscales
        loss-scaled grads (a power of two, so exactly) inside the trace
        update."""
        if g_norm is None:
            g_norm = self.grad_norm(grads, grad_scale)
        lr = float(self.learning_rate(state["count"]))
        if self.grad_clip is not None:
            trigger = g_norm < self.grad_clip
        for p, g, tr in zip(params, grads, state["trace"]):
            if self.grad_clip is not None:
                g = torch.where(trigger, g, (g / g_norm) * self.grad_clip)
            tr.mul_(self.momentum).add_(g.to(tr.dtype), alpha=grad_scale)
            p.add_((tr * -lr).to(p.dtype))
        state["count"] += 1
        return g_norm

    @staticmethod
    def flat_state(state: dict, params: dict) -> dict:
        """``count`` and ``trace/<leaf path>`` (the tensors themselves)."""
        paths = ["/".join(p) for p, _ in tree_leaves_with_path(params)]
        flat = {"count": int(state["count"])}
        flat.update({f"trace/{p}": t for p, t in zip(paths, state["trace"])})
        return flat

    @staticmethod
    def load_flat_state(state: dict, flat: dict, params: dict) -> None:
        """Restore ``flat_state`` output in place, bit for bit; raises on
        a shape that differs."""
        paths = ["/".join(p) for p, _ in tree_leaves_with_path(params)]
        for p, t in zip(paths, state["trace"]):
            saved = flat[f"trace/{p}"]
            if tuple(saved.shape) != tuple(t.shape):
                raise ValueError(f"trace/{p}: checkpoint shape "
                                 f"{tuple(saved.shape)} != {tuple(t.shape)}")
            t.copy_(saved)
        state["count"] = int(flat["count"])


def build_optimizer(cfg: dict, lr_schedule):
    """Config-driven optimizer factory (the reference YAML keys: ``name``,
    ``beta1/beta2/epsilon``, ``weight_decay``, ``grad_clip.clip_norm``,
    ``multi_precision``; ``momentum`` for ``Momentum`` / ``sgd``)."""
    cfg = dict(cfg or {})
    name = cfg.get("name", "AdamW")
    if name not in ("FusedAdamW", "AdamW", "adamw", "Momentum", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    clip = cfg.get("grad_clip")
    clip_norm = None
    if isinstance(clip, dict):
        clip_norm = float(clip.get("clip_norm", 1.0))
    elif clip is not None:
        clip_norm = float(clip)
    if name in ("Momentum", "sgd"):
        return Momentum(lr_schedule, momentum=float(cfg.get("momentum", 0.9)),
                        grad_clip=clip_norm)
    return AdamW(lr_schedule,
                 beta1=float(cfg.get("beta1", 0.9)),
                 beta2=float(cfg.get("beta2", 0.999)),
                 epsilon=float(cfg.get("epsilon", 1e-8)),
                 weight_decay=float(cfg.get("weight_decay", 0.01)),
                 grad_clip=clip_norm,
                 multi_precision=bool(cfg.get("multi_precision", True)))
