"""Transducer (RNN-T) and CTC losses (PyTorch).

Port of ``reazonspeech_tpu.training.losses``. The RNN-T forward variable
is the reference's anti-diagonal wavefront: diagonal d holds every lattice
cell (t, u) with t + u = d, so the T×U trellis completes in T+U-1
sequential steps, each vectorised over the diagonal and the batch. The
per-cell transition log-probs of every diagonal are gathered once before
the loop (one gather each, one scatter each in the backward), so a step is
a few elementwise kernels.

The CTC loss is optax's algorithm (``optax.ctc_loss``, which the
reference wraps) written out: a scan over frames of blank and label
forward variables with ``log_epsilon = -1e5`` in place of log(0), so a row
whose labels cannot fit its frames gets a large finite loss, as optax's,
where ``torch.nn.functional.ctc_loss`` returns inf.
"""

import torch

__all__ = ["rnnt_loss", "ctc_loss", "transducer_nll_from_transitions"]

_NEG_INF = -1e30


def rnnt_loss(logits, logit_lengths, labels, label_lengths, blank_id):
    """Transducer negative log-likelihood.

    Args:
      logits: [B, T, U+1, K] joint outputs (unnormalized)
      logit_lengths: [B] valid encoder frames per element
      labels: [B, U] int label sequences (padded arbitrarily)
      label_lengths: [B] valid label counts
      blank_id: index of the blank logit

    Returns [B] negative log-likelihoods (fp32).
    """
    b, t, u1, k = logits.shape
    u = u1 - 1
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    lp_blank = logp[..., blank_id]  # [B, T, U+1]
    lab = torch.clamp(labels, max=k - 1).long()  # a safe gather
    lp_label = torch.gather(logp[:, :, :u, :], 3,
                            lab[:, None, :, None].expand(b, t, u, 1))[..., 0]  # [B, T, U]
    return transducer_nll_from_transitions(lp_blank, lp_label, logit_lengths, label_lengths)


def transducer_nll_from_transitions(lp_blank, lp_label, logit_lengths, label_lengths):
    """Transducer NLL from per-cell transition log-probs: the lattice DP
    shared by :func:`rnnt_loss` and ``pruned_rnnt.rnnt_loss_simple``.

    Args:
      lp_blank: [B, T, U+1] log p(blank | t, u)
      lp_label: [B, T, U] log p(y_{u+1} | t, u)
      logit_lengths, label_lengths: [B]

    Returns [B] negative log-likelihoods.
    """
    b, t, u1 = lp_blank.shape
    u = u1 - 1
    dev = lp_blank.device
    n_diag = t + u1 - 1  # diagonals d = 1 .. T+U after the start cell
    d = torch.arange(1, n_diag + 1, device=dev)[:, None]  # [D, 1]
    u_idx = torch.arange(u1, device=dev)[None, :]  # [1, U+1]
    t_idx = d - u_idx  # [D, U+1]
    valid = (t_idx >= 0) & (t_idx < t)
    # from (t-1, u): blank; from (t, u-1): the u-th label
    blank_ok = t_idx > 0
    label_ok = u_idx > 0
    t_im1 = torch.clamp(t_idx - 1, 0, t - 1)
    t_cur = torch.clamp(t_idx, 0, t - 1)
    u_b = u_idx.expand_as(t_idx)
    blank_tab = lp_blank[:, t_im1, u_b]  # [B, D, U+1]
    if u > 0:
        u_im1 = torch.clamp(u_idx - 1, 0, u - 1).expand_as(t_idx)
        label_tab = lp_label[:, t_cur, u_im1]  # [B, D, U+1]
    else:
        label_tab = torch.full((b, n_diag, u1), _NEG_INF, device=dev)

    diag = torch.full((b, u1), _NEG_INF, device=dev, dtype=lp_blank.dtype)
    diag = torch.where(u_idx == 0, 0.0, diag)  # alpha[0, 0] = 0
    diags = [diag]
    for i in range(n_diag):
        blank_in = torch.where(blank_ok[i], diag + blank_tab[:, i], _NEG_INF)
        prev_u = torch.roll(diag, 1, dims=1)  # diag[u-1] at slot u
        label_in = torch.where(label_ok[0], prev_u + label_tab[:, i], _NEG_INF)
        diag = torch.where(valid[i], torch.logaddexp(blank_in, label_in), _NEG_INF)
        diags.append(diag)
    diags = torch.stack(diags)  # [T+U+1, B, U+1]

    # terminal: alpha[T_b - 1, U_b] + log blank(T_b - 1, U_b)
    tb = logit_lengths.to(device=dev, dtype=torch.long)
    ub = label_lengths.to(device=dev, dtype=torch.long)
    bi = torch.arange(b, device=dev)
    alpha_final = diags[tb - 1 + ub, bi, ub]
    blank_final = lp_blank[bi, torch.clamp(tb - 1, 0, t - 1), ub]
    return -(alpha_final + blank_final)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id, log_epsilon=-1e5):
    """CTC negative log-likelihood, optax's ``ctc_loss`` over paddings.

    Args:
      logits: [B, T, K]; logit_lengths: [B]
      labels: [B, N] int (right-padded); label_lengths: [B]

    Returns [B] fp32.
    """
    f32 = torch.float32
    b, t, k = logits.shape
    n = labels.shape[1]
    dev = logits.device
    logit_pad = (torch.arange(t, device=dev)[None, :]
                 >= logit_lengths.to(dev)[:, None]).to(f32)  # [B, T]
    labels = labels.to(dev).long()
    labellens = label_lengths.to(device=dev, dtype=torch.long)
    logprobs = torch.log_softmax(logits.to(f32), dim=-1)
    # repeat[b, n] = 1 when label n equals label n+1
    repeat = torch.nn.functional.pad((labels[:, :-1] == labels[:, 1:]).to(f32), (0, 1))
    lp_phi = logprobs[:, :, blank_id].transpose(0, 1)[..., None]  # [T, B, 1]
    lp_emit = torch.gather(logprobs, 2, labels[:, None, :].expand(b, t, n)).transpose(0, 1)

    phi = torch.full((b, n + 1), log_epsilon, device=dev, dtype=f32)
    phi = torch.where(torch.arange(n + 1, device=dev) == 0, 0.0, phi)
    emit = torch.full((b, n), log_epsilon, device=dev, dtype=f32)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    for i in range(t):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit[i], emit + lp_emit[i])
        next_phi = prev_phi + lp_phi[i]
        next_phi = update_phi(next_phi, emit + lp_phi[i] + log_epsilon * (1.0 - repeat))
        pad = logit_pad[:, i:i + 1]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -last.gather(1, labellens[:, None])[:, 0]
