"""Medusa training losses — counterpart of whisper_medusa_tpu/training/losses.py.

Reference semantics (whisper_medusa/utils/losses.py):
  * per-head shifted cross-entropy over a stack of head logits (H', B, T, V):
    stack index i is trained against the labels shifted by ``shift0 + i``
    (``shift0`` 0 with the base head in the stack, ``loss_on_original``, else
    1); a head whose shift leaves no supervised position gives no loss (the
    reference breaks out of its loop on NaN; here a validity flag masks it);
  * per-head batchmean KL of each head's log-softmax against the softmax of
    the detached teacher logits at the shifted positions, times ``lamda``,
    with label padding not masked (as in the reference).

Labels use -100 for positions without CE.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def _shifted_ce(logits: torch.Tensor, labels: torch.Tensor,
                shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE of ``logits[:, t]`` against ``labels[:, t + shift]``, ignoring
    -100; (loss, valid), valid False when no position is supervised."""
    t = logits.shape[1]
    if shift >= t:
        return logits.new_zeros((), dtype=torch.float32), torch.tensor(False)
    lg = logits[:, : t - shift] if shift else logits
    lb = labels[:, shift:]
    mask = lb != IGNORE_INDEX
    logp = F.log_softmax(lg.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(mask, lb, 0).long()[..., None])[..., 0]
    denom = mask.sum()
    return torch.where(mask, nll, 0.0).sum() / denom.clamp(min=1), denom > 0


def medusa_cross_entropy(stack_logits: torch.Tensor, labels: torch.Tensor,
                         loss_on_original: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head shifted CE (H',) and validity (H',); the stack must already
    leave the base head out when ``loss_on_original`` is False."""
    shift0 = 0 if loss_on_original else 1
    out = [_shifted_ce(stack_logits[i], labels, shift0 + i)
           for i in range(stack_logits.shape[0])]
    return (torch.stack([l for l, _ in out]),
            torch.stack([v.to(stack_logits.device) for _, v in out]))


def medusa_kl(stack_logits: torch.Tensor, teacher_logits: torch.Tensor, lamda: float,
              loss_on_original: bool) -> torch.Tensor:
    """Per-head KL(teacher || head), torch's 'batchmean' (sum / B), times
    ``lamda``; the caller detaches ``teacher_logits``."""
    shift0 = 0 if loss_on_original else 1
    teacher = F.softmax(teacher_logits.float(), dim=-1)
    b, t, _ = teacher.shape
    out = []
    for i in range(stack_logits.shape[0]):
        shift = shift0 + i
        if shift >= t:
            out.append(teacher.new_zeros(()))
            continue
        lg = stack_logits[i][:, : t - shift] if shift else stack_logits[i]
        logp = F.log_softmax(lg.float(), dim=-1)
        tp = teacher[:, shift:]
        out.append((tp * (torch.log(tp.clamp(min=1e-30)) - logp)).sum() / b * lamda)
    return torch.stack(out)


def medusa_losses_streaming(
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    head_stack: torch.Tensor,            # (H', B, T, D)
    labels: torch.Tensor,                # (B, T), -100 padded
    loss_on_original: bool,
    teacher_hidden: Optional[torch.Tensor] = None,   # (B, T, D): KL when given
    kl_lamda: float = 0.0,
    chunk: int = 64,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-head shifted CE (and KL) without the (H', B, T, V) logits stack.

    T-chunks of ``chunk`` rows go through ``project_fn`` under
    ``torch.utils.checkpoint``, so only one chunk's (H', B, C, V) logits
    exist at a time, forward and backward (the backward projects the chunk
    again).  The teacher rows are projected per chunk at each head's shift
    and detached after the projection, so the projection weight gets no
    teacher-branch gradient.  Same reduction as :func:`medusa_cross_entropy`
    and :func:`medusa_kl` up to the order of the sums.

    ``reduce`` (data parallelism: a sum over the data ranks, no gradient)
    makes the terms this rank's share of the global batch's: its NLL sums
    over the global supervised-token counts, its KL sums over the global
    batch size, so the ranks' losses add up to the single-process loss on
    the whole batch (JAX's one loss over the global batch), whatever the
    ranks' ``-100`` padding.

    Returns (per_head_ce (H',), valid (H',), per_head_kl (H',) or None)."""
    nh, b, t, _ = head_stack.shape
    shift0 = 0 if loss_on_original else 1
    max_shift = shift0 + nh - 1
    n_chunks = -(-t // chunk)
    t_pad = n_chunks * chunk
    extra = t_pad - t + max_shift + chunk
    labels_pad = F.pad(labels.long(), (0, extra), value=IGNORE_INDEX)
    head_pad = F.pad(head_stack, (0, 0, 0, t_pad - t))
    teacher_pad = None if teacher_hidden is None else F.pad(teacher_hidden, (0, 0, 0, extra))
    cols = torch.arange(chunk, device=head_stack.device)

    nll_sum = head_stack.new_zeros((nh,), dtype=torch.float32)
    kl_sum = head_stack.new_zeros((nh,), dtype=torch.float32)
    cnt_sum = torch.zeros((nh,), dtype=torch.long, device=head_stack.device)
    for ci in range(n_chunks):
        t0 = ci * chunk
        lbs = [labels_pad[:, t0 + shift0 + i: t0 + shift0 + i + chunk] for i in range(nh)]
        masks = [lb != IGNORE_INDEX for lb in lbs]

        def chunk_losses(rows, t0=t0, lbs=lbs, masks=masks):
            logp = F.log_softmax(project_fn(rows).float(), dim=-1)     # (H', B, C, V)
            nlls, kls = [], []
            for i in range(nh):
                safe = torch.where(masks[i], lbs[i], 0)
                nll = -logp[i].gather(-1, safe[..., None])[..., 0]
                nlls.append(torch.where(masks[i], nll, 0.0).sum())
                if teacher_pad is not None:
                    s = t0 + shift0 + i
                    with torch.no_grad():
                        tp = F.softmax(project_fn(teacher_pad[:, s: s + chunk]).float(), -1)
                    in_range = (t0 + cols < t - (shift0 + i))[None, :, None]
                    kl = tp * (torch.log(tp.clamp(min=1e-30)) - logp[i])
                    kls.append(torch.where(in_range, kl, 0.0).sum())
            kl_v = torch.stack(kls) if kls else torch.zeros_like(nll_sum)
            return torch.stack(nlls), kl_v

        rows = head_pad[:, :, t0: t0 + chunk]
        if torch.is_grad_enabled():
            nll_c, kl_c = checkpoint(chunk_losses, rows, use_reentrant=False)
        else:
            nll_c, kl_c = chunk_losses(rows)
        nll_sum = nll_sum + nll_c
        kl_sum = kl_sum + kl_c
        cnt_sum = cnt_sum + torch.stack([m.sum() for m in masks])
    if reduce is not None:
        cnt_sum = reduce(cnt_sum)
        b = int(reduce(torch.tensor([b], device=cnt_sum.device))[0])
    valid = cnt_sum > 0
    per_head_ce = nll_sum / cnt_sum.clamp(min=1)
    per_head_kl = kl_sum / b * kl_lamda if teacher_hidden is not None else None
    return per_head_ce, valid, per_head_kl
