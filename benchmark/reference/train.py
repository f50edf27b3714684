"""Plain reference of the acoustic model's training steps: float32 PyTorch.

A frozen copy of the math of the port's
``models/toplevel.py::DiffSingerAcoustic.forward_train`` (rectified flow with
the shallow-diffusion aux decoder: the aux decoder fed ``cond * g +
cond.detach() * (1 - g)``, the state ``noise + t (x1 - noise)``, the
denoiser at ``t * time_scale_factor``, the target ``x1 - noise``),
``models/losses.py``'s ``aux_mel_loss`` (L1, scaled by
``lambda_aux_mel_loss``) and ``reflow_loss`` (L2, without log-norm weights),
each a mean over the batch's true frames and mel bins, and
``training/train_state.py``'s ``clip_grad_norm``, over the modules of
``acoustic.py``. The optimizer is ``torch.optim.AdamW`` with the config's
settings, stepped once a batch (``accumulate_grad_batches`` 1) at a constant
LR (StepLR's first 10,000 steps).

The draws (t, noise) and the dropout masks are the ones the program drew,
handed in; everything else is worked out here. A batch runs in blocks of
rows, each block's loss divided by the whole batch's frame count, so that
the gradients add up to the batch's.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .acoustic import AcousticReference
from .common import name_sites, pointwise

TRAINED = {"diffusion_type": "reflow", "main_loss_type": "l2", "main_loss_log_norm": False,
           "accumulate_grad_batches": 1}


class TrainReference(AcousticReference):
    """:meth:`steps` runs the optimizer over a few batches and reports each
    step's loss, the first clipped gradient and the change of every leaf."""

    def __init__(self, hp: dict, vocab: int, lowp=None):
        super().__init__(hp, vocab, lowp=lowp)
        off = {k: hp.get(k) for k, v in TRAINED.items() if hp.get(k, v) != v}
        shallow = hp["shallow_diffusion_args"]
        sched = hp["lr_scheduler_args"]
        if (off or not shallow["train_aux_decoder"] or not shallow["train_diffusion"]
                or sched.get("scheduler_cls", "StepLR").rsplit(".", 1)[-1] != "StepLR"
                or hp["optimizer_args"].get("optimizer_cls", "AdamW").rsplit(".", 1)[-1]
                != "AdamW"):
            raise ValueError(f"the training reference covers the benchmark's config only {off}")
        name_sites(self)

    def losses(self, tokens, mel2ph, f0, mel, t, noise, frames: torch.Tensor):
        """(aux loss, flow loss) of these rows, each summed over them and
        divided by ``frames`` (the whole batch's true frames x mel bins)."""
        ops, hp = self.ops, self.hp
        cond = self.fs2(ops, tokens, mel2ph, f0)
        g = hp["shallow_diffusion_args"]["aux_decoder_grad"]
        aux = self.aux_decoder.decoder(ops, cond * g + cond.detach() * (1 - g))
        mask = (mel2ph > 0).float()[:, :, None]
        spec = (mel.float() - self.smin) / (self.smax - self.smin) * 2 - 1
        aux_loss = hp["lambda_aux_mel_loss"] * ((aux - spec).abs() * mask).sum() / frames
        t = t.float()
        x_t = noise + t[:, None, None] * (spec - noise)
        net = self.diffusion.velocity_fn
        projs = [pointwise(ops, layer.conditioner_projection, cond)
                 for layer in net.residual_layers]
        v = net(ops, x_t, t * hp["time_scale_factor"], projs)
        flow_loss = ((v - (spec - noise)).square() * mask).sum() / frames
        return aux_loss, flow_loss

    def steps(self, batches: List[Dict], block_rows: int = 16) -> Dict:
        """``batches``: dicts of tokens, mel2ph, f0, mel, t, noise and masks
        ({module name: [(keep, p), ...]}). Returns {"loss": [each step's
        total], "grad1": {name: norm of the first clipped gradient},
        "change": {name: norm of the change after the last step}}."""
        hp = self.hp
        named = [(n, p) for n, p in self.named_parameters()]
        params = [p for _, p in named]
        opt_args = hp["optimizer_args"]
        optimizer = torch.optim.AdamW(
            params, lr=opt_args["lr"], betas=(opt_args.get("beta1", 0.9),
                                              opt_args.get("beta2", 0.98)),
            eps=opt_args.get("eps", 1e-8), weight_decay=opt_args.get("weight_decay", 0.0))
        start = [p.detach().clone() for p in params]
        max_norm = float(hp.get("clip_grad_norm", 0) or 0)
        out = {"loss": []}
        with self.ops.backend():
            for i, batch in enumerate(batches):
                optimizer.zero_grad(set_to_none=True)
                n_mels = batch["mel"].shape[-1]
                frames = torch.clamp((batch["mel2ph"] > 0).sum().float() * n_mels, min=1.0)
                total = 0.0
                for r0 in range(0, batch["tokens"].shape[0], block_rows):
                    rows = slice(r0, r0 + block_rows)
                    self.ops.masks = {site: [(keep[rows], p) for keep, p in queue]
                                      for site, queue in batch["masks"].items()}
                    aux_loss, flow_loss = self.losses(
                        *(batch[k][rows] for k in ("tokens", "mel2ph", "f0", "mel", "t",
                                                   "noise")), frames)
                    (aux_loss + flow_loss).backward()
                    total += float(aux_loss.detach() + flow_loss.detach())
                self.ops.masks = None
                out["loss"].append(total)
                grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
                norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
                if max_norm and float(norm) > max_norm:
                    for g in grads:
                        g.mul_(max_norm / norm)
                for p, g in zip(params, grads):
                    p.grad = g
                if i == 0:
                    out["grad1"] = {n: float(g.norm()) for (n, _), g in zip(named, grads)}
                optimizer.step()
        out["change"] = {n: float((p.detach() - p0).norm()) for (n, p), p0 in zip(named, start)}
        return out

