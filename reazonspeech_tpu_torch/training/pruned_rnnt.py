"""Pruned and simple transducer losses (PyTorch).

Port of ``reazonspeech_tpu.training.pruned_rnnt``: the pruned-transducer
loss pair of Kuang et al., "Pruned RNN-T for fast, memory-efficient ASR
training" (Interspeech 2022), as icefall trains with it.

1. :func:`rnnt_loss_simple`: a trivial joiner ``am[t,v] + lm[u,v]``,
   whose per-cell normaliser is one product of exponentials, so nothing of
   shape T·U·V exists; the lattice DP is ``losses``' wavefront.
2. :func:`prune_ranges`: each frame's window of ``s_range`` label
   positions, placed where the simple lattice's occupancy mass is largest
   (the occupancies from one ``torch.autograd.grad`` of the simple NLL by
   the transition log-probs, on detached inputs), then projected onto the
   feasible set by three running reductions.
3. :func:`rnnt_loss_pruned`: the full joint on the gathered
   [B, T, s_range, V] band only, with a window-relative DP over frames.
"""

import torch

from ..models.layers import dense, dense_init
from ..models.rnnt import _joint_act
from .losses import _NEG_INF, transducer_nll_from_transitions

__all__ = ["init_simple_joint", "simple_transitions", "rnnt_loss_simple", "prune_ranges",
           "rnnt_loss_pruned", "pruned_loss_bundle"]


def init_simple_joint(gen, cfg, device="cpu"):
    """The trivial joiner's two projections to the logit space (icefall's
    ``simple_am_proj`` / ``simple_lm_proj``)."""
    return {"am": dense_init(gen, cfg.enc_dim, cfg.num_classes, device=device),
            "lm": dense_init(gen, cfg.pred_hidden, cfg.num_classes, device=device)}


def simple_transitions(am, lm, labels, blank_id):
    """Per-cell transition log-probs of the trivial joiner.

    Args:
      am: [B, T, V] frame logits; lm: [B, U+1, V] label-context logits
      labels: [B, U] int; blank_id: the blank logit

    Returns (lp_blank [B, T, U+1], lp_label [B, T, U]), each
    ``am[t,v] + lm[u,v] - logsumexp_v(am[t] + lm[u])`` at its token.
    """
    f32 = torch.float32
    am, lm = am.to(f32), lm.to(f32)
    am_max = am.amax(dim=-1)  # [B, T]
    lm_max = lm.amax(dim=-1)  # [B, U+1]
    # the normaliser as one product of exponentials in fp32 (no TF32: it
    # feeds a log, as the reference's HIGHEST precision)
    s = torch.einsum("btv,buv->btu", torch.exp(am - am_max[..., None]),
                     torch.exp(lm - lm_max[..., None]))
    z = torch.log(torch.clamp(s, min=1e-38)) + am_max[:, :, None] + lm_max[:, None, :]
    lp_blank = am[..., blank_id][:, :, None] + lm[..., blank_id][:, None, :] - z
    k = am.shape[-1]
    u = labels.shape[1]
    lab = torch.clamp(labels, max=k - 1).long()
    am_lab = torch.gather(am, 2, lab[:, None, :].expand(-1, am.shape[1], -1))  # [B, T, U]
    lm_lab = torch.gather(lm[:, :u, :], 2, lab[:, :, None])[..., 0]  # [B, U]
    lp_label = am_lab + lm_lab[:, None, :] - z[:, :, :u]
    return lp_blank, lp_label


def rnnt_loss_simple(am, lm, logit_lengths, labels, label_lengths, blank_id):
    """Transducer NLL of the trivial joiner ([B]), equal in value and
    gradient to ``losses.rnnt_loss`` on ``am[:, :, None] + lm[:, None]``."""
    lp_blank, lp_label = simple_transitions(am, lm, labels, blank_id)
    return transducer_nll_from_transitions(lp_blank, lp_label, logit_lengths, label_lengths)


def _monotone_band(start, s_range, logit_lengths, label_lengths, u):
    """Project raw window starts onto the feasible set: non-decreasing, a
    step of at most s_range - 1 a frame, start[0] = 0, the terminal cell
    (T_b-1, U_b) covered, within [0, U+1-s]; each projection a closed-form
    running reduction, as the reference's."""
    b, t = start.shape
    dev = start.device
    sm1 = s_range - 1
    ts = torch.arange(t, device=dev, dtype=start.dtype)
    hi = max(u + 1 - s_range, 0)

    start = torch.clamp(start, 0, hi)
    start = torch.cat([torch.zeros_like(start[:, :1]), start[:, 1:]], dim=1)
    start = torch.cummax(start, dim=1).values  # non-decreasing
    # a step of at most s-1: the running min of start - t(s-1), plus t(s-1)
    start = torch.minimum(start, torch.cummin(start - ts[None, :] * sm1, dim=1).values
                          + ts[None, :] * sm1)
    tb = logit_lengths.to(device=dev, dtype=start.dtype)
    ub = label_lengths.to(device=dev, dtype=start.dtype)
    lb = (ub - sm1)[:, None] - (tb[:, None] - 1 - ts[None, :]) * sm1
    start = torch.maximum(start, torch.clamp(lb, max=hi))
    return torch.clamp(start, 0, hi)


def prune_ranges(am, lm, logit_lengths, labels, label_lengths, blank_id, s_range):
    """Window starts [B, T] int32 for the pruned loss, from the simple
    lattice's occupancies (no gradient flows)."""
    with torch.enable_grad():
        lp_blank, lp_label = simple_transitions(am.detach(), lm.detach(), labels, blank_id)
        lp_blank = lp_blank.detach().requires_grad_(True)
        lp_label = lp_label.detach().requires_grad_(True)
        total = transducer_nll_from_transitions(lp_blank, lp_label, logit_lengths,
                                                label_lengths).sum()
        gb, gl = torch.autograd.grad(total, (lp_blank, lp_label))
    # -d NLL / d lp[t, u]: the probability that a path passes (t, u) by that
    # transition; their sum is the cell's occupancy
    occ = -gb + torch.nn.functional.pad(-gl, (0, 1))  # [B, T, U+1]
    b, t, u1 = occ.shape
    s = min(s_range, u1)
    cum = torch.nn.functional.pad(torch.cumsum(occ, dim=2), (1, 0))  # cum[u] = Σ occ[:u]
    n_start = u1 - s + 1
    mass = cum[:, :, s:s + n_start] - cum[:, :, :n_start]  # [B, T, n_start]
    # the first maximum, as jnp.argmax
    best = mass.amax(dim=2, keepdim=True)
    idx = torch.arange(n_start, device=occ.device)
    start = torch.where(mass == best, idx, n_start).amin(dim=2).to(torch.int32)
    return _monotone_band(start, s, logit_lengths, label_lengths, u1 - 1)


def _pruned_transitions(joint_params, enc, pred, ranges, labels, label_lengths, cfg, s_range):
    """The full joint's transition log-probs on the band only: (lp_blank,
    lp_label), each [B, T, s], column j of frame t at cell (t, ranges[t]+j)."""
    dt = cfg.dtype
    u1 = pred.shape[1]
    idx = torch.clamp(ranges[:, :, None].long()
                      + torch.arange(s_range, device=enc.device), 0, u1 - 1)  # [B, T, s]
    f = dense(joint_params["enc"], enc, dtype=dt)  # [B, T, J]
    g = dense(joint_params["pred"], pred, dtype=dt)  # [B, U+1, J]
    bi = torch.arange(enc.shape[0], device=enc.device)[:, None, None]
    g_win = g[bi, idx]  # [B, T, s, J]
    z = _joint_act(f[:, :, None, :] + g_win, cfg)
    logits = dense(joint_params["out"], z, dtype=dt).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)  # [B, T, s, V]
    lp_blank = logp[..., cfg.blank_id]
    k = logp.shape[-1]
    lab_pad = torch.nn.functional.pad(labels.long(), (0, 1))  # the label at u (u < U_b)
    lab_win = torch.clamp(lab_pad[bi, idx], max=k - 1)
    lp_label = torch.gather(logp, 3, lab_win[..., None])[..., 0]
    # no label transition out of a cell at u >= U_b
    valid = idx < label_lengths.to(enc.device)[:, None, None]
    return lp_blank, torch.where(valid, lp_label, _NEG_INF)


def rnnt_loss_pruned(joint_params, enc, pred, ranges, labels, logit_lengths, label_lengths,
                     cfg, s_range):
    """Transducer NLL over the paths inside the pruned band ([B]).

    Args:
      joint_params: the real joint (``models.rnnt.init_joint``'s layout)
      enc: [B, T, E]; pred: [B, U+1, H] (``predictor_sequence``'s output)
      ranges: [B, T] window starts (:func:`prune_ranges`)
      cfg: the RNNTConfig; s_range: the band's width
    """
    lp_blank, lp_label = _pruned_transitions(joint_params, enc, pred, ranges, labels,
                                             label_lengths, cfg, s_range)
    b, t, s = lp_blank.shape
    dev = enc.device
    ranges = ranges.detach().long()

    def row(a_in, lp_label_t):
        # the in-row label accumulation, unrolled over the (small) band width
        cols = [a_in[:, 0]]
        for j in range(1, s):
            cols.append(torch.logaddexp(a_in[:, j], cols[-1] + lp_label_t[:, j - 1]))
        return torch.stack(cols, dim=1)

    js = torch.arange(s, device=dev)
    alpha = row(torch.where(js[None, :] == 0, 0.0, _NEG_INF) * torch.ones((b, 1), device=dev),
                lp_label[:, 0])
    alphas = [alpha]
    delta = ranges[:, 1:] - ranges[:, :-1]  # [B, T-1], in [0, s-1]
    for i in range(t - 1):
        # blank into row t: cell (t, r_t + j) <- (t-1, r_{t-1} + j + d)
        src = js[None, :] + delta[:, i:i + 1]
        ok = src < s
        src = torch.clamp(src, max=s - 1)
        a_in = torch.where(ok, torch.gather(alpha + lp_blank[:, i], 1, src), _NEG_INF)
        alpha = row(a_in, lp_label[:, i + 1])
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # [T, B, s]

    tb = torch.clamp(logit_lengths.to(dev).long() - 1, 0, t - 1)
    bi = torch.arange(b, device=dev)
    j_fin = torch.clamp(label_lengths.to(dev).long() - ranges[bi, tb], 0, s - 1)
    return -(alphas[tb, bi, j_fin] + lp_blank[bi, tb, j_fin])


def pruned_loss_bundle(simple_params, joint_params, enc, pred, labels, logit_lengths,
                       label_lengths, cfg, s_range=5, simple_scale=0.5, pruned_scale=1.0):
    """icefall's objective: the simple loss (the alignment teacher) plus the
    pruned full-joint loss on the bands it picks. Returns (loss [B], {simple,
    pruned, ranges})."""
    f32 = torch.float32
    am = dense(simple_params["am"], enc.to(f32))
    lm = dense(simple_params["lm"], pred.to(f32))
    simple = rnnt_loss_simple(am, lm, logit_lengths, labels, label_lengths, cfg.blank_id)
    ranges = prune_ranges(am, lm, logit_lengths, labels, label_lengths, cfg.blank_id, s_range)
    s_eff = min(s_range, pred.shape[1])
    pruned = rnnt_loss_pruned(joint_params, enc, pred, ranges, labels, logit_lengths,
                              label_lengths, cfg, s_eff)
    loss = simple_scale * simple + pruned_scale * pruned
    return loss, {"simple": simple, "pruned": pruned, "ranges": ranges}
