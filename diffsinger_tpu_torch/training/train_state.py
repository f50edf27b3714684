"""Optimizer, gradient clipping, parameter freezing and fine-tune filtering
(counterpart of diffsinger_tpu/training/train_state.py and the parameter
helpers of diffsinger_tpu/training/base_task.py).

The optimizers are torch's own classes, built from the reference's
``optimizer_args`` with the JAX package's defaults (Adam betas (0.9, 0.98),
eps 1e-8, no weight decay). Torch takes ``amsgrad``, ``dampening`` and
``lr_decay`` itself, so the JAX package's refusals of them have no copy here.
Gradient accumulation is the trainer's: it averages the gradients of
``accumulate_grad_batches`` micro-batches before one update, as
``optax.MultiSteps`` does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch


def build_optimizer(params: Iterable[torch.nn.Parameter], hp: dict) -> torch.optim.Optimizer:
    """The optimizer that ``hp["optimizer_args"]`` names (AdamW by default)."""
    opt_args = hp["optimizer_args"]
    cls = opt_args.get("optimizer_cls", "torch.optim.AdamW").rsplit(".", 1)[-1]
    lr = opt_args["lr"]
    wd = opt_args.get("weight_decay", 0.0)
    if cls in ("AdamW", "Adam"):
        return getattr(torch.optim, cls)(
            params, lr=lr, betas=(opt_args.get("beta1", 0.9), opt_args.get("beta2", 0.98)),
            eps=opt_args.get("eps", 1e-8), weight_decay=wd,
            amsgrad=opt_args.get("amsgrad", False))
    if cls == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=opt_args.get("momentum", 0.0),
                               dampening=opt_args.get("dampening", 0.0),
                               nesterov=opt_args.get("nesterov", False), weight_decay=wd)
    if cls == "RMSprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=opt_args.get("alpha", 0.99),
                                   eps=opt_args.get("eps", 1e-8), weight_decay=wd,
                                   momentum=opt_args.get("momentum", 0.0),
                                   centered=opt_args.get("centered", False))
    if cls == "Adagrad":
        return torch.optim.Adagrad(
            params, lr=lr, lr_decay=opt_args.get("lr_decay", 0.0), weight_decay=wd,
            initial_accumulator_value=opt_args.get("initial_accumulator_value", 0.0),
            eps=opt_args.get("eps", 1e-10))
    raise NotImplementedError(f"Unsupported optimizer: {cls}")


def clip_grad_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients to a global norm of at most ``max_norm`` (no
    scaling when it is 0), as ``optax.clip_by_global_norm``: g * max_norm /
    norm where norm > max_norm. Returns the norm before clipping, on the
    device (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if max_norm:
        scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
        torch._foreach_mul_(grads, scale)
    return norm


def norm_param_prefix(p: str) -> str:
    """A reference-style prefix ('model.fs2.txt_embed') as the port names it:
    no Lightning 'model.' wrapper, and the legacy token-embedding name
    'fs2.encoder.embed_tokens' mapped to 'fs2.txt_embed'."""
    if p.startswith("model."):
        p = p[len("model."):]
    return p.replace("fs2.encoder.embed_tokens", "fs2.txt_embed")


def freeze_params(module: torch.nn.Module, frozen_prefixes: Iterable[str]) -> List[str]:
    """Set ``requires_grad=False`` on every parameter under a frozen prefix, as
    the reference does; returns their names."""
    prefixes = [norm_param_prefix(p) for p in frozen_prefixes]
    frozen = []
    for name, p in module.named_parameters():
        if any(name.startswith(pre) for pre in prefixes):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def filter_finetune_params(template: Dict[str, torch.Tensor], loaded: Dict[str, torch.Tensor],
                           ignored_prefixes: Iterable[str],
                           strict_shapes: bool = True) -> Dict[str, torch.Tensor]:
    """The model's state dict with a fine-tune checkpoint's tensors put in:
    keys under an ignored prefix keep the template's value, as do keys of
    another shape unless ``strict_shapes`` (then they raise); keys the model
    lacks are dropped."""
    prefixes = [norm_param_prefix(p) for p in ignored_prefixes]
    out = dict(template)
    skipped = []
    for k, v in loaded.items():
        if any(k.startswith(p) or p in k for p in prefixes):
            skipped.append(k)
            continue
        if k in template:
            if tuple(template[k].shape) == tuple(v.shape):
                out[k] = v
            elif strict_shapes:
                raise ValueError(f"Shape mismatch for finetune param {k}: "
                                 f"{tuple(v.shape)} vs {tuple(template[k].shape)}")
            else:
                skipped.append(k)
    if skipped:
        print(f"| finetune: skipped {len(skipped)} params")
    return out
