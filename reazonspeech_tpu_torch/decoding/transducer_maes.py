"""Alignment-synchronous transducer beam search (mAES), PyTorch.

Port of ``reazonspeech_tpu.decoding.transducer_maes``: ESPnet's
``search_type="maes"``, the *modified Adaptive Expansion Search* of Kim &
Sung (IEEE SPL 2020), in the reference's fixed-shape batched reading. Per
encoder frame, instead of Graves' serial pop loop:

1. *prefix merge* (``prefix_alpha`` 1): a hypothesis whose label sequence
   is another's minus its last label donates its probability of emitting
   that label this frame, by log-add-exp over the [B, K, K] pair grid;
2. ``nstep`` *expansion steps*, each one [B·K]-row joint → blank log-prob
   and top-(beam + beta) labels (``ops/beam_topk.topm_logsoftmax``: the
   row-3 kernel on CUDA tensors when ``topk_impl="pallas"``, else and on CPU
   tensors its plain twin) → pruning to candidates within
   ``expansion_gamma`` of the hypothesis' best → the global top-K label
   expansions → one [B·K]-row predictor step. Blank extensions go to a
   kept pool; after the last step the surviving expansions are
   blank-terminated and one merge keeps the top K of every generation.

The bounds of the reference keep shapes static: the working set is pruned
to ``beam_size`` after every step, each hypothesis offers blank plus its
top ``beam_size + expansion_beta`` labels, ``max_tokens`` caps emissions
(default T) and ``prefix_alpha`` is 0 or 1. The top-K picks are a stable
descending sort (ties to the lower index, as ``lax.top_k``); no decoder
of the port calls ``torch.topk``, which promises no order among equal
values on CUDA. The best hypothesis is ESPnet's ``sort_nbest``:
``score / (len + 1)`` when ``score_norm``.

Every frame runs the same ``nstep`` batched expansions: there is no
data-dependent inner loop and no host sync. The one-shot decode reads the
lengths once and runs ``max(lengths)`` frame bodies; a segment runs
exactly ``n_frames`` (or ``min(n_frames, frames_left)``), lanes past their
length masked, so extra frames change nothing.

``maes_state_init`` / ``maes_beam_segment`` / ``maes_finalize`` are the
segmented API behind ``serving/continuous.py``: the state carried between
segments is each lane's survivor tuple (:class:`MAESBeamState`), lanes
flagged in ``reset_mask`` restart from the blank-primed start, and each
lane's result equals a dedicated :func:`maes_beam_decode` under the same
``max_tokens``.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import param_device
from ..models.rnnt import (
    RNNTConfig, joint_precompute_enc, joint_step_from_enc_proj, predictor_step,
    predictor_zero_state,
)
from ..ops.beam_topk import topm_logsoftmax, topm_logsoftmax_plain

__all__ = ["MAESBeamConfig", "MAESBeamState", "maes_beam_decode", "maes_state_init",
           "maes_beam_segment", "maes_finalize"]

_DEAD = -1.0e30
_ALIVE = -1.0e25


@dataclass(frozen=True)
class MAESBeamConfig:
    """Field names and defaults as in the JAX package."""

    beam_size: int = 20
    nstep: int = 2  # expansion steps a frame (ESPnet maes_num_steps)
    expansion_beta: int = 2  # label candidates a hypothesis: beam_size + expansion_beta
    expansion_gamma: float = 2.3  # keep candidates within this of the hypothesis' best
    prefix_alpha: int = 1  # 1: merge length-gap-1 prefixes; 0: off
    score_norm: bool = True  # select by score / (len + 1)
    max_tokens: int = 0  # emission buffer; 0 -> T (must be set for the segments)
    topk_impl: str = "xla"  # "pallas": the port's top-m kernel


class MAESBeamState(NamedTuple):
    """Cross-segment survivor state, one row per lane. ``dec`` is each
    hypothesis' prediction-network output, ``ph``/``pc`` the matching
    post-step LSTM state; score ``_DEAD`` marks an empty slot."""

    fidx: torch.Tensor  # [B] int32 next encoder frame
    cs: torch.Tensor  # [B, K] fp32 scores
    st: torch.Tensor  # [B, K, U] int32 tokens
    sf: torch.Tensor  # [B, K, U] int32 emission frames
    sc: torch.Tensor  # [B, K] int32 token counts
    dec: torch.Tensor  # [B, K, H] fp32
    ph: torch.Tensor  # [B, K, L, H] fp32
    pc: torch.Tensor  # [B, K, L, H] fp32


def _validate(rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig):
    if rnnt_cfg.predictor_kind != "lstm":
        raise NotImplementedError("maes beam search: LSTM predictors only")
    if not rnnt_cfg.blank_first:
        raise NotImplementedError("espnet convention: blank id 0")
    if cfg.nstep < 1:
        raise ValueError("maes: nstep must be >= 1")
    if cfg.prefix_alpha not in (0, 1):
        raise NotImplementedError("maes: prefix_alpha > 1 needs per-token dec_out history")
    if cfg.topk_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown topk_impl {cfg.topk_impl!r}")


def _sos_step(pred_params, b, rnnt_cfg: RNNTConfig, device):
    """The blank-primed start (ESPnet's initial hypothesis): dec_out [B, H]
    and the post-step state [B, L, H] of feeding blank to the zero state."""
    toks = torch.full((b,), rnnt_cfg.blank_id, dtype=torch.int32, device=device)
    g, (h, c) = predictor_step(pred_params, toks, predictor_zero_state(b, rnnt_cfg, device),
                               rnnt_cfg)
    return g, h.transpose(0, 1), c.transpose(0, 1)


def _fresh_state(pred_params, b, rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig, u_buf, device):
    k = min(cfg.beam_size, rnnt_cfg.num_classes)
    g0, h0, c0 = _sos_step(pred_params, b, rnnt_cfg, device)
    i32 = dict(dtype=torch.int32, device=device)
    cs = torch.full((b, k), _DEAD, dtype=torch.float32, device=device)
    cs[:, 0] = 0.0
    dec = torch.zeros((b, k) + g0.shape[1:], dtype=torch.float32, device=device)
    dec[:, 0] = g0
    ph = torch.zeros((b, k) + h0.shape[1:], dtype=torch.float32, device=device)
    ph[:, 0] = h0
    pc = torch.zeros_like(ph)
    pc[:, 0] = c0
    return MAESBeamState(fidx=torch.zeros((b,), **i32), cs=cs,
                         st=torch.zeros((b, k, u_buf), **i32),
                         sf=torch.zeros((b, k, u_buf), **i32), sc=torch.zeros((b, k), **i32),
                         dec=dec, ph=ph, pc=pc)


def _apply_reset(pred_params, state: MAESBeamState, reset, rnnt_cfg: RNNTConfig,
                 cfg: MAESBeamConfig):
    """Lanes flagged in ``reset`` [B] take the fresh state (a new request
    joins); the others keep theirs."""
    fresh = _fresh_state(pred_params, state.cs.shape[0], rnnt_cfg, cfg, state.st.shape[-1],
                         state.cs.device)
    return MAESBeamState(*(
        torch.where(reset.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)
        for new, old in zip(fresh, state)))


def _take(a, idx):
    """``a`` [B, N, ...] gathered along the slot axis at ``idx`` [B, M]."""
    return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]


def _top(x, k):
    """The top ``k`` values of each row and their columns, ties to the lower
    column (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _run_frames(pred_params, joint_params, enc_proj, lane_len, state: MAESBeamState,
                rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig, n_frames):
    """Run ``n_frames`` frame bodies: every lane still short of its
    ``lane_len`` advances one frame of its own utterance; the others are
    masked and keep their state."""
    b, t_buf, _ = enc_proj.shape
    k = state.cs.shape[1]
    u_buf = state.st.shape[-1]
    v = rnnt_cfg.num_classes
    m_lab = min(cfg.beam_size + cfg.expansion_beta, v - 1)
    blank = rnnt_cfg.blank_id  # == 0
    layers, hid = rnnt_cfg.pred_rnn_layers, rnnt_cfg.pred_hidden
    dev = enc_proj.device
    bi = torch.arange(b, device=dev)
    upos = torch.arange(u_buf, device=dev)
    topm_fn = topm_logsoftmax if cfg.topk_impl == "pallas" else topm_logsoftmax_plain

    def joint_rows(enc_row, dec):
        """[B, J] x [B, K, H] -> raw logits [B, K, V] fp32."""
        enc_rows = enc_row[:, None, :].expand(b, k, enc_row.shape[-1]).reshape(b * k, -1)
        return joint_step_from_enc_proj(joint_params, enc_rows, dec.reshape(b * k, -1),
                                        rnnt_cfg).reshape(b, k, v)

    def pred_rows(tokens, pre_h, pre_c):
        """[B, K] tokens and [B, K, L, H] states -> (dec [B, K, H], h', c')."""
        r = b * k
        g, (nh, nc) = predictor_step(
            pred_params, tokens.reshape(r),
            (pre_h.reshape(r, layers, hid).transpose(0, 1),
             pre_c.reshape(r, layers, hid).transpose(0, 1)), rnnt_cfg)
        return (g.reshape(b, k, -1), nh.transpose(0, 1).reshape(b, k, layers, hid),
                nc.transpose(0, 1).reshape(b, k, layers, hid))

    def topm(logits):
        """[B, K, V] -> (lp_blank [B, K], top_lp [B, K, m], top_tok [B, K, m])."""
        lpb, tl, tt = topm_fn(logits.reshape(b * k, v), m_lab, blank)
        return lpb.reshape(b, k), tl.reshape(b, k, m_lab), tt.reshape(b, k, m_lab)

    def prefix_merge(s, st, sc, logits):
        """ESPnet's prefix search at alpha 1: donor i (alive), whose labels
        are receiver j's minus its last, adds ``score_i + logp(missing |
        dec_i)`` into j by log-add-exp. Donors give their pre-merge scores
        (a receiver is strictly longer than its donor)."""
        alive = s > _ALIVE
        dmask = upos[None, None, :] < sc[:, :, None]  # [B, i, U]
        eq = st[:, None, :, :] == st[:, :, None, :]  # [B, j, i, U]
        prefix_eq = (eq | ~dmask[:, None]).all(dim=-1)
        match = (prefix_eq & (sc[:, :, None] == sc[:, None, :] + 1)
                 & alive[:, :, None] & alive[:, None, :])
        # the label j has and i misses: st[b, j, sc_i]
        pos = sc.clamp(0, u_buf - 1).long()  # [B, i]
        missing = st.gather(2, pos[:, None, :].expand(b, k, k))  # [B, j, i]
        logz = torch.logsumexp(logits, dim=-1)  # [B, K]
        lg = logits.gather(2, missing.transpose(1, 2).long())  # [B, i, j]
        lp = (lg - logz[:, :, None]).transpose(1, 2)  # [B, j, i]
        cand = torch.where(match, s[:, None, :] + lp, -torch.inf)
        boost = torch.logsumexp(cand, dim=-1)
        return torch.where(match.any(dim=-1), torch.logaddexp(s, boost), s)

    fidx, cs, st, sf, sc, dec, ph, pc = state
    for _ in range(n_frames):
        in_frame = fidx < lane_len  # [B]
        enc_row = enc_proj[bi, fidx.clamp(max=t_buf - 1)]  # [B, J], each lane's frame

        # generation 0 is the beam; each step records (parent, token, write
        # position) and one merge at the frame's end picks the winners
        ws, wsc, wdec, wph, wpc = cs, sc, dec, ph, pc
        blank_s, chain = [], []
        gen_sc, gen_dec, gen_ph, gen_pc = [sc], [dec], [ph], [pc]
        for n in range(cfg.nstep):
            logits = joint_rows(enc_row, wdec)
            if n == 0 and cfg.prefix_alpha:
                ws = prefix_merge(ws, st, sc, logits)
            lp_blank, top_lp, top_tok = topm(logits)

            alive = ws > _ALIVE
            tot_blank = torch.where(alive, ws + lp_blank, _DEAD)  # [B, K]
            tot_lab = torch.where(alive[:, :, None], ws[:, :, None] + top_lp, _DEAD)
            # gamma pruning against the hypothesis' best candidate, blank included
            best = torch.maximum(tot_lab.amax(dim=-1), tot_blank)
            keep_b = alive & (tot_blank >= best - cfg.expansion_gamma)
            keep_l = ((tot_lab >= (best - cfg.expansion_gamma)[:, :, None])
                      & alive[:, :, None] & (wsc < u_buf)[:, :, None])
            blank_s.append(torch.where(keep_b, tot_blank, _DEAD))

            # the global top-K label expansions
            vals, idx = _top(torch.where(keep_l, tot_lab, _DEAD).reshape(b, k * m_lab), k)
            parent = idx // m_lab
            new_alive = vals > _ALIVE
            tok_new = top_tok.reshape(b, k * m_lab).gather(1, idx)  # [B, K]
            p_sc = wsc.gather(1, parent)
            chain.append((parent, tok_new, p_sc))
            wdec, wph, wpc = pred_rows(tok_new, _take(wph, parent), _take(wpc, parent))
            ws = torch.where(new_alive, vals, _DEAD)
            wsc = p_sc + new_alive.to(torch.int32)
            gen_sc.append(wsc)
            gen_dec.append(wdec)
            gen_ph.append(wph)
            gen_pc.append(wpc)

        # blank-terminate the surviving expansions: the blank column less
        # the log-sum-exp, with no full log-softmax
        logits = joint_rows(enc_row, wdec)
        lp_blank = logits[..., blank] - torch.logsumexp(logits, dim=-1)
        fin_s = torch.where(ws > _ALIVE, ws + lp_blank, _DEAD)

        # one merge over every generation's candidates
        vals, win = _top(torch.cat(blank_s + [fin_s], dim=1), k)  # [B, K]
        new_cs = torch.where(vals > _ALIVE, vals, _DEAD)
        gen, col = win // k, win % k  # generation (nstep: the finals), slot in it
        new_sc = torch.cat(gen_sc, dim=1).gather(1, win)
        n_dec = _take(torch.cat(gen_dec, dim=1), win)
        n_ph = _take(torch.cat(gen_ph, dim=1), win)
        n_pc = _take(torch.cat(gen_pc, dim=1), win)

        # token and frame rows: each winner's parent chain back to its root
        # beam slot, one column write a level
        idx, writes = col, []
        for j in reversed(range(cfg.nstep)):
            applies = gen > j  # the winner descends through expansion step j
            parent, tok_j, pos_j = chain[j]
            writes.append((applies, tok_j.gather(1, idx), pos_j.gather(1, idx)))
            idx = torch.where(applies, parent.gather(1, idx), idx)
        n_st, n_sf = _take(st, idx), _take(sf, idx)
        for applies, tok_w, pos_w in writes:
            put = applies[:, :, None] & (upos[None, None, :] == pos_w[:, :, None])
            n_st = torch.where(put, tok_w[:, :, None], n_st)
            n_sf = torch.where(put, fidx[:, None, None], n_sf)

        def sel(new, old):
            return torch.where(in_frame.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

        cs, st, sf, sc = sel(new_cs, cs), sel(n_st, st), sel(n_sf, sf), sel(new_sc, sc)
        dec, ph, pc = sel(n_dec, dec), sel(n_ph, ph), sel(n_pc, pc)
        fidx = fidx + in_frame.to(torch.int32)
    return MAESBeamState(fidx, cs, st, sf, sc, dec, ph, pc)


def _select_best(state: MAESBeamState, lane_len, cfg: MAESBeamConfig):
    """ESPnet ``sort_nbest`` over the beam: (tokens, frames, counts,
    scores); lanes of length 0 count 0."""
    key = state.cs
    if cfg.score_norm:
        key = torch.where(state.cs > _ALIVE, state.cs / (state.sc.to(torch.float32) + 1.0),
                          _DEAD)
    best = key.argmax(dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    counts = torch.where(lane_len <= 0, 0, state.sc[rows, best])
    return state.st[rows, best], state.sf[rows, best], counts, state.cs[rows, best]


def maes_beam_decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                     cfg: MAESBeamConfig = MAESBeamConfig()):
    """mAES beam search over a batch.

    Args:
      enc: [B, T, E] fp32; enc_lengths: [B] int

    Returns (tokens [B, U] int32, frames [B, U] int32, counts [B] int32,
    scores [B] fp32 raw).
    """
    _validate(rnnt_cfg, cfg)
    b, t, _ = enc.shape
    lane_len = enc_lengths.to(device=enc.device, dtype=torch.int32)
    enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
    state = _fresh_state(pred_params, b, rnnt_cfg, cfg, cfg.max_tokens or t, enc.device)
    n_frames = min(t, int(lane_len.max())) if b else 0  # the call's one read of the lengths
    state = _run_frames(pred_params, joint_params, enc_proj, lane_len, state, rnnt_cfg, cfg,
                        n_frames)
    return _select_best(state, lane_len, cfg)


# --- resumable per-lane segments (continuous batching) -----------------------


def maes_state_init(pred_params, b, rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig) -> MAESBeamState:
    """Fresh survivor state for ``b`` lanes on the predictor's device
    (``cfg.max_tokens`` must be set: a segment cannot default the emission
    buffer to T)."""
    _validate(rnnt_cfg, cfg)
    if cfg.max_tokens <= 0:
        raise ValueError("maes_state_init: cfg.max_tokens must be set for segmented decode "
                         "(the emission buffer cannot default to T)")
    return _fresh_state(pred_params, b, rnnt_cfg, cfg, cfg.max_tokens, param_device(pred_params))


def maes_beam_segment(pred_params, joint_params, enc_ring, lane_len, reset_mask,
                      state: MAESBeamState, rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig,
                      n_frames: int, frames_left=None) -> MAESBeamState:
    """Advance every lane by up to ``n_frames`` frames of its own utterance.

    Args:
      enc_ring: [B, T_buf, J] per-lane joint encoder projections
      lane_len: [B] int32 valid frames per lane (0 = idle)
      reset_mask: [B] bool, lanes re-initialised before stepping
      frames_left: the most frames any lane has left, where the caller
        mirrors the lanes' clocks on the host; the segment then runs
        ``min(n_frames, frames_left)`` frame bodies, else ``n_frames``

    Returns the updated state; a lane is finished once ``fidx >= lane_len``.
    """
    _validate(rnnt_cfg, cfg)
    lane_len = lane_len.to(torch.int32)
    state = _apply_reset(pred_params, state, reset_mask, rnnt_cfg, cfg)
    if frames_left is not None:
        n_frames = min(n_frames, int(frames_left))
    return _run_frames(pred_params, joint_params, enc_ring, lane_len, state, rnnt_cfg, cfg,
                       n_frames)


def maes_finalize(state: MAESBeamState, lane_len, rnnt_cfg: RNNTConfig, cfg: MAESBeamConfig):
    """(tokens [B, U], frames [B, U], counts [B], scores [B]) of each lane's
    best hypothesis."""
    return _select_best(state, lane_len, cfg)
