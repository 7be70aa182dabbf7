"""Batched label-looping greedy transducer decode (PyTorch).

Port of ``reazonspeech_tpu.decoding.rnnt_greedy.rnnt_greedy_decode``: each
iteration advances every element by one encoder frame (blank, or after
``max_symbols_per_step`` emissions at one frame) or by one emitted label,
so the joint runs T + U times per utterance. The loop body is fixed-shape
tensor ops; finished elements are frozen by masks, and the host checks for
termination once every ``CHECK_EVERY`` iterations. Runs no kernel.

``frame_window`` W > 1 is the reference's blank-run skipping: each
iteration runs the joint over the W frames from the element's clock
against its current prediction output (a blank does not change it), takes
the first maximum of each (``torch.argmax``, as ``jnp.argmax``), counts
frames past the element's length as blank, and jumps the leading blank run
(a cumulative product) in one iteration; where frame 0 emits, the
iteration emits as with W = 1. The outputs are W = 1's up to the
reassociation of the [B, W, J] joint's sums, which can only move a
near-tie. Each iteration still advances a frame or emits, so the bounds
hold.

The predictor state is either an LSTM ``(h, c)`` pair ([L, B, H] each) or
the stateless predictor's [B, context_size-1] token context; the loop keeps
it batch-leading (the reference's ``_state_to_bl`` / ``_state_from_bl``) so
that one row mask updates either form.

``greedy_state_init`` / ``greedy_segment`` / ``greedy_finalize`` expose the
same search as a resumable per-lane state machine (the reference's
segmented API, behind the continuous-batching executor in
``serving/continuous.py``): a fixed pool of lanes advances exactly
``n_steps`` loop iterations per call over a ring of pre-projected encoder
frames, with no host sync; finished lanes are masked, and lanes flagged in
``reset_mask`` restart. The loop body is shared with
:func:`rnnt_greedy_decode`, so each lane's result equals a dedicated decode
under the same ``max_tokens``.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import param_device
from ..models.rnnt import (
    RNNTConfig, joint_precompute_enc, joint_step_from_enc_proj, predictor_step,
    predictor_zero_state,
)

__all__ = ["GreedyDecodeConfig", "rnnt_greedy_decode", "GreedyLaneState", "greedy_state_init",
           "greedy_segment", "greedy_finalize", "greedy_step_bound"]

CHECK_EVERY = 32  # loop iterations between host-side termination checks


@dataclass(frozen=True)
class GreedyDecodeConfig:
    """Field names and defaults as in the JAX package."""

    max_symbols_per_step: int = 10
    max_tokens: int = 0  # 0 -> T
    frame_window: int = 1  # frames a blank run may jump in one iteration


class GreedyLaneState(NamedTuple):
    """Cross-segment greedy decode state (one row per lane)."""

    tokens: torch.Tensor  # [B, U] int32 (blank-padded)
    frames: torch.Tensor  # [B, U] int32
    counts: torch.Tensor  # [B] int32
    time_idx: torch.Tensor  # [B] int32 encoder frame clock
    sym_at_frame: torch.Tensor  # [B] int32 emissions at the current frame
    last_tok: torch.Tensor  # [B] int32
    pred_out: torch.Tensor  # [B, H] fp32
    pred_state: tuple  # the predictor's state, batch-leading (see _state_to_bl)


def _state_to_bl(pred_state, cfg: RNNTConfig):
    """The predictor's state with the batch leading, as a tuple of tensors."""
    if cfg.predictor_kind == "stateless":
        return (pred_state,)
    return tuple(x.transpose(0, 1) for x in pred_state)


def _state_from_bl(state, cfg: RNNTConfig):
    if cfg.predictor_kind == "stateless":
        return state[0]
    return tuple(x.transpose(0, 1) for x in state)


def _rows(mask, x):
    """``mask`` [B] shaped to broadcast over the rows of ``x``."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _greedy_init(pred_params, b, u_max, rnnt_cfg: RNNTConfig, device):
    blank = rnnt_cfg.blank_id
    i32 = dict(dtype=torch.int32, device=device)
    last_tok = torch.full((b,), blank, **i32)
    pred_out, pred_state = predictor_step(
        pred_params, last_tok, predictor_zero_state(b, rnnt_cfg, device), rnnt_cfg)
    return GreedyLaneState(
        tokens=torch.full((b, u_max), blank, **i32), frames=torch.zeros((b, u_max), **i32),
        counts=torch.zeros((b,), **i32), time_idx=torch.zeros((b,), **i32),
        sym_at_frame=torch.zeros((b,), **i32), last_tok=last_tok, pred_out=pred_out,
        pred_state=_state_to_bl(pred_state, rnnt_cfg))


def _make_body(pred_params, joint_params, enc_proj, enc_lengths, emit_cap, u_max,
               rnnt_cfg: RNNTConfig, decode_cfg: GreedyDecodeConfig):
    """(active, body) over GreedyLaneState with ``u_max`` emission slots,
    shared by the one-shot decode and the segments."""
    b, t, _ = enc_proj.shape
    blank = rnnt_cfg.blank_id
    w = max(int(decode_cfg.frame_window), 1)
    rows = torch.arange(b, device=enc_proj.device)
    slots = torch.arange(u_max, device=enc_proj.device)[None, :]
    window = torch.arange(w, device=enc_proj.device)[None, :]

    def active(s: GreedyLaneState):
        return (s.time_idx < enc_lengths) & (s.counts < emit_cap)

    def body(s: GreedyLaneState) -> GreedyLaneState:
        act = active(s)
        force_advance = s.sym_at_frame >= decode_cfg.max_symbols_per_step
        if w == 1:
            enc_frame = enc_proj[rows, torch.clamp(s.time_idx, max=t - 1)]
            logits = joint_step_from_enc_proj(joint_params, enc_frame, s.pred_out, rnnt_cfg)
            tok = logits.argmax(dim=-1).to(torch.int32)  # first max, as jnp.argmax
            is_blank = (tok == blank) | force_advance
            emit = act & ~is_blank
            advance_n = (act & is_blank).to(torch.int32)
        else:
            # the joint over W frames against the current prediction output
            at = s.time_idx[:, None] + window  # [B, W]
            enc_frames = enc_proj[rows[:, None], torch.clamp(at, max=t - 1)]  # [B, W, J]
            logits = joint_step_from_enc_proj(joint_params, enc_frames, s.pred_out[:, None, :],
                                              rnnt_cfg)  # [B, W, V]
            tok_w = logits.argmax(dim=-1).to(torch.int32)
            tok = tok_w[:, 0]
            blank_w = (tok_w == blank) | (at >= enc_lengths[:, None])  # past the end: blank
            blank_w[:, 0] |= force_advance
            lead = blank_w.to(torch.int32).cumprod(dim=1).sum(dim=1)  # the leading blank run
            emit = act & (lead == 0)
            advance_n = torch.where(act, lead, 0).to(torch.int32)

        put = (slots == s.counts[:, None]) & emit[:, None]
        tokens = torch.where(put, tok[:, None], s.tokens)
        frames = torch.where(put, s.time_idx[:, None], s.frames)
        counts = s.counts + emit.to(torch.int32)
        sym_at_frame = torch.where(emit, s.sym_at_frame + 1, s.sym_at_frame)
        time_idx = s.time_idx + advance_n
        sym_at_frame = torch.where(advance_n > 0, 0, sym_at_frame)

        last_tok = torch.where(emit, tok, s.last_tok)
        step_out, step_state = predictor_step(
            pred_params, last_tok, _state_from_bl(s.pred_state, rnnt_cfg), rnnt_cfg)
        pred_out = torch.where(emit[:, None], step_out, s.pred_out)
        pred_state = tuple(torch.where(_rows(emit, new), new, old)
                           for new, old in zip(_state_to_bl(step_state, rnnt_cfg),
                                               s.pred_state))
        return GreedyLaneState(tokens, frames, counts, time_idx, sym_at_frame, last_tok,
                               pred_out, pred_state)

    return active, body


def rnnt_greedy_decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                       decode_cfg: GreedyDecodeConfig = GreedyDecodeConfig()):
    """Greedy decode a batch of encoded utterances.

    Args:
      enc: [B, T, E] fp32; enc_lengths: [B] int

    Returns (tokens [B, U] int32 padded with blank_id, frames [B, U] int32
    encoder frame of each emission, counts [B] int32).
    """
    b, t, _ = enc.shape
    u_max = decode_cfg.max_tokens or t
    enc_lengths = enc_lengths.to(torch.int32)
    # emission cap tied to the valid length: results do not depend on padding
    emit_cap = torch.clamp(enc_lengths * decode_cfg.max_symbols_per_step, max=u_max)
    enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
    state = _greedy_init(pred_params, b, u_max, rnnt_cfg, enc.device)
    active, body = _make_body(pred_params, joint_params, enc_proj, enc_lengths, emit_cap,
                              u_max, rnnt_cfg, decode_cfg)
    # every iteration advances a frame or emits: T + u_max bounds the loop
    max_iters, it = t + u_max, 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            state = body(state)
            it += 1
        if not bool(active(state).any()):
            break
    return state.tokens, state.frames, state.counts


# --- resumable per-lane segments (continuous batching) -----------------------


def greedy_step_bound(lane_len: int, cfg: GreedyDecodeConfig) -> int:
    """Upper bound on one lane's loop iterations: each advances a frame or
    emits one token (the emission cap bounds the latter)."""
    cap = int(lane_len) * int(cfg.max_symbols_per_step)
    if cfg.max_tokens:
        cap = min(cap, int(cfg.max_tokens))
    return int(lane_len) + cap


def greedy_state_init(pred_params, b: int, rnnt_cfg: RNNTConfig,
                      cfg: GreedyDecodeConfig) -> GreedyLaneState:
    """Fresh lane-pool state on the predictor's device (``cfg.max_tokens``
    must be set: a segment cannot default the emission buffer to T)."""
    if cfg.max_tokens <= 0:
        raise ValueError("greedy_state_init: cfg.max_tokens must be set for segmented "
                         "decode (the emission buffer cannot default to T)")
    return _greedy_init(pred_params, b, cfg.max_tokens, rnnt_cfg, param_device(pred_params))


def greedy_segment(pred_params, joint_params, enc_ring, lane_len, reset_mask,
                   state: GreedyLaneState, rnnt_cfg: RNNTConfig, cfg: GreedyDecodeConfig,
                   n_steps: int):
    """Advance every lane by ``n_steps`` loop iterations (finished lanes are
    masked; no host sync).

    Args:
      enc_ring: [B, T_buf, J] per-lane joint encoder projections
      lane_len: [B] int32 valid encoder frames per lane (0 = idle)
      reset_mask: [B] bool, lanes re-initialised before stepping

    Returns ``(state, done)``; ``done`` [B] bool is True once a lane has
    consumed its frames or reached its emission cap.
    """
    b, u_max = state.tokens.shape
    lane_len = lane_len.to(torch.int32)
    fresh = _greedy_init(pred_params, b, u_max, rnnt_cfg, enc_ring.device)
    state = GreedyLaneState(*(
        tuple(torch.where(_rows(reset_mask, o), n, o) for n, o in zip(new, old))
        if isinstance(old, tuple) else torch.where(_rows(reset_mask, old), new, old)
        for new, old in zip(fresh, state)))
    emit_cap = torch.clamp(lane_len * cfg.max_symbols_per_step, max=u_max)
    active, body = _make_body(pred_params, joint_params, enc_ring, lane_len, emit_cap, u_max,
                              rnnt_cfg, cfg)
    for _ in range(n_steps):
        state = body(state)
    return state, ~active(state)


def greedy_finalize(state: GreedyLaneState, lane_len):
    """(tokens [B, U], frames [B, U], counts [B]) of the lanes; idle lanes
    (``lane_len`` 0) count 0."""
    return state.tokens, state.frames, torch.where(lane_len <= 0, 0, state.counts)
