"""The legacy loss registry: the grounding, QA and pretraining heads' losses.

Counterpart of ``msr3d_tpu/optim/losses.py``, with the same names, keys and
semantics. MSR3D computes its own loss inside the model; these drive the
legacy heads (``nn/grounding.py``):

  * per-position cross-entropy over the class axis with logits (B, N, C)
    and labels (B, N), reduced over the last axis;
  * the multi-label BCE losses sum and divide by the batch;
  * the masked-LM loss ignores the label -1.

Every function takes a ``data_dict`` (a dict of tensors) and returns a
scalar tensor. ``get_losses`` evaluates a list of them and sums a subset;
``Loss`` is the config-selected bundle, ``ULIPWithImageLoss`` the
tri-modal contrastive loss, ``no_decay_mask`` the weight-decay mask of a
module's parameters (biases and norm weights get none).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from msr3d_tpu_torch.registry import LOSS_REGISTRY

# ---------------------------------------------------------------------------
# primitives


def _log_softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE over the last axis of ``logits`` (no reduction), for
    integer ``labels`` over the leading dims."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _bce_with_logits_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Summed BCE with logits, in the stable form
    ``max(x, 0) - x t + log1p(exp(-|x|))``."""
    x = logits
    t = targets.to(logits.dtype)
    return torch.sum(torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs())))


# ---------------------------------------------------------------------------
# registered losses


def og3d_loss(data_dict):
    """Grounding CE over the object logits."""
    labels = data_dict["tgt_object_id"].reshape(-1)
    return torch.mean(_log_softmax_ce(data_dict["og3d_logits"], labels))


def og3d_multi_loss(data_dict):
    """Multi-target grounding BCE, summed / batch."""
    tgt = data_dict["tgt_object_id"]
    return _bce_with_logits_sum(data_dict["og3d_logits"], tgt) / float(tgt.shape[0])


def txt_cls_loss(data_dict):
    """Text → object-class CE."""
    labels = data_dict["tgt_object_label"].reshape(-1)
    return torch.mean(_log_softmax_ce(data_dict["txt_cls_logits"], labels))


def txt_cls_multi_loss(data_dict):
    """Multi-label text classification BCE, summed / batch."""
    tgt = data_dict["tgt_object_label"]
    return _bce_with_logits_sum(data_dict["txt_cls_logits"], tgt) / float(tgt.shape[0])


def _masked_obj_cls(logits, labels, mask):
    """Per-object CE averaged over ``mask``."""
    ce = _log_softmax_ce(logits, labels)  # (B, N)
    m = mask.to(ce.dtype)
    return torch.sum(ce * m) / torch.sum(m)


def obj_cls_raw_loss(data_dict):
    return _masked_obj_cls(
        data_dict["obj_cls_raw_logits"], data_dict["obj_labels"], data_dict["obj_masks"]
    )


def obj_cls_pre_loss(data_dict):
    return _masked_obj_cls(
        data_dict["obj_cls_pre_logits"], data_dict["obj_labels"], data_dict["obj_masks"]
    )


def obj_cls_post_loss(data_dict):
    return _masked_obj_cls(
        data_dict["obj_cls_post_logits"], data_dict["obj_labels"], data_dict["obj_masks"]
    )


def answer_loss(data_dict):
    """QA answer-vocabulary BCE, summed / batch."""
    scores = data_dict["answer_scores"]
    return _bce_with_logits_sum(scores, data_dict["answer_label"]) / float(scores.shape[0])


def lm_cls_loss(data_dict):
    """Masked-LM CE; the label -1 is ignored."""
    labels = data_dict["masked_lm_labels"]
    valid = labels != -1
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = _log_softmax_ce(data_dict["txt_lm_cls_logits"], safe)
    m = valid.to(ce.dtype)
    return torch.sum(ce * m) / torch.sum(m)


def _sem_masked_obj_cls(logits, labels, mask, sem_mask, *, masked: bool):
    """obj-cls CE over the objects whose semantics are masked (or not)."""
    sem = sem_mask.bool()
    sel = mask.bool() & (~sem if masked else sem)
    ce = _log_softmax_ce(logits, labels)
    m = sel.to(ce.dtype)
    return torch.sum(ce * m) / torch.sum(m)


def obj_cls_pre_loss_mask(data_dict):
    return _sem_masked_obj_cls(
        data_dict["obj_cls_pre_logits"], data_dict["obj_labels"],
        data_dict["obj_masks"], data_dict["obj_sem_masks"], masked=True,
    )


def obj_cls_pre_loss_unmask(data_dict):
    return _sem_masked_obj_cls(
        data_dict["obj_cls_pre_logits"], data_dict["obj_labels"],
        data_dict["obj_masks"], data_dict["obj_sem_masks"], masked=False,
    )


def obj_cls_post_loss_mask(data_dict):
    return _sem_masked_obj_cls(
        data_dict["obj_cls_post_logits"], data_dict["obj_labels"],
        data_dict["obj_masks"], data_dict["obj_sem_masks"], masked=True,
    )


def obj_cls_post_loss_unmask(data_dict):
    return _sem_masked_obj_cls(
        data_dict["obj_cls_post_logits"], data_dict["obj_labels"],
        data_dict["obj_masks"], data_dict["obj_sem_masks"], masked=False,
    )


def mse_loss(data_dict):
    """Image-reconstruction MSE."""
    diff = data_dict["pred_images"] - data_dict["target_images"]
    return torch.mean(diff * diff)


BUILTIN_LOSSES = {
    fn.__name__: fn
    for fn in (
        og3d_loss, og3d_multi_loss, txt_cls_loss, txt_cls_multi_loss, obj_cls_raw_loss,
        obj_cls_pre_loss, obj_cls_post_loss, answer_loss, lm_cls_loss,
        obj_cls_pre_loss_mask, obj_cls_pre_loss_unmask, obj_cls_post_loss_mask,
        obj_cls_post_loss_unmask, mse_loss,
    )
}


def get_losses(
    data_dict: Dict, all_keys: List[str], selected_keys: List[str]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Evaluate every loss in ``all_keys`` (the functions above first, then
    ``LOSS_REGISTRY``) and sum the ``selected_keys`` subset, unless the
    model already wrote ``data_dict['loss']``."""
    all_losses: Dict[str, torch.Tensor] = {}
    for k in all_keys:
        fn = BUILTIN_LOSSES.get(k)
        if fn is None:
            fn = LOSS_REGISTRY.get(k)
            if isinstance(fn, type):
                fn = fn()
        all_losses[k] = fn(data_dict)
    selected = {k: all_losses[k] for k in selected_keys}
    total = data_dict["loss"] if "loss" in data_dict else sum(selected.values())
    all_losses["total_loss"] = total
    return total, all_losses


class Loss:
    """The config-selected loss bundle: ``model.vis_loss_list`` evaluated,
    ``model.loss_list`` summed."""

    def __init__(self, cfg):
        self.all_keys = list(cfg.model.vis_loss_list)
        self.selected_keys = list(cfg.model.loss_list)

    def __call__(self, data_dict):
        return get_losses(data_dict, self.all_keys, self.selected_keys)


@LOSS_REGISTRY.register()
class ULIPWithImageLoss:
    """Tri-modal contrastive loss: symmetric InfoNCE between point-cloud ↔
    text and point-cloud ↔ image embeddings. The caller passes ``labels``
    in ``outputs``."""

    def __call__(self, outputs):
        def norm(x):
            return x / torch.linalg.norm(x, dim=-1, keepdim=True)

        pc = norm(outputs["pc_embed"])
        text = norm(outputs["text_embed"])
        image = norm(outputs["image_embed"])
        scale = outputs["logit_scale"]
        labels = outputs["labels"]

        def ce(logits):
            return torch.mean(_log_softmax_ce(logits, labels))

        l_pt = scale * pc @ text.T
        l_pi = scale * pc @ image.T
        return (ce(l_pt) + ce(l_pt.T)) / 2 + (ce(l_pi) + ce(l_pi.T)) / 2


# ---------------------------------------------------------------------------
# no-decay parameter grouping

_NO_DECAY_TOKENS = ("bias", "scale")
_NORMS = (torch.nn.LayerNorm, torch.nn.GroupNorm)


def no_decay_mask(module: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: True if it takes weight decay} over
    ``module.named_parameters()``. As the JAX package's mask exempts every
    leaf whose path holds ``bias`` or ``scale`` (flax's name of a norm's
    weight), a name holding either and the ``weight`` of a norm layer
    (LayerNorm, GroupNorm, the port's BatchNorm and RMSNorm) take none."""
    exempt = set()
    for prefix, sub in module.named_modules():
        is_norm = isinstance(sub, _NORMS) or type(sub).__name__ in ("BatchNorm", "RMSNorm")
        if is_norm and isinstance(getattr(sub, "weight", None), torch.nn.Parameter):
            exempt.add(f"{prefix}.weight" if prefix else "weight")
    return {name: name not in exempt and not any(tok in name for tok in _NO_DECAY_TOKENS)
            for name, _ in module.named_parameters()}
