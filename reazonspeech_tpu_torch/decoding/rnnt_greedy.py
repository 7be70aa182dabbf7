"""Batched label-looping greedy transducer decode (PyTorch).

Port of ``reazonspeech_tpu.decoding.rnnt_greedy.rnnt_greedy_decode``: each
iteration advances every element by one encoder frame (blank, or after
``max_symbols_per_step`` emissions at one frame) or by one emitted label,
so the joint runs T + U times per utterance. The loop body is fixed-shape
tensor ops; finished elements are frozen by masks, and the host checks for
termination once every ``CHECK_EVERY`` iterations. Runs no kernel.

The predictor state is either an LSTM ``(h, c)`` pair ([L, B, H] each) or
the stateless predictor's [B, context_size-1] token context; the loop keeps
it batch-leading (the reference's ``_state_to_bl`` / ``_state_from_bl``) so
that one row mask updates either form.
"""

from dataclasses import dataclass

import torch

from ..models.rnnt import (
    RNNTConfig, joint_precompute_enc, joint_step_from_enc_proj, predictor_step,
    predictor_zero_state,
)

__all__ = ["GreedyDecodeConfig", "rnnt_greedy_decode"]

CHECK_EVERY = 32  # loop iterations between host-side termination checks


@dataclass(frozen=True)
class GreedyDecodeConfig:
    """Field names and defaults as in the JAX package."""

    max_symbols_per_step: int = 10
    max_tokens: int = 0  # 0 -> T
    frame_window: int = 1  # blank-run skipping is not ported yet


def _state_to_bl(pred_state, cfg: RNNTConfig):
    """The predictor's state with the batch leading, as a tuple of tensors."""
    if cfg.predictor_kind == "stateless":
        return (pred_state,)
    return tuple(x.transpose(0, 1) for x in pred_state)


def _state_from_bl(state, cfg: RNNTConfig):
    if cfg.predictor_kind == "stateless":
        return state[0]
    return tuple(x.transpose(0, 1) for x in state)


def rnnt_greedy_decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                       decode_cfg: GreedyDecodeConfig = GreedyDecodeConfig()):
    """Greedy decode a batch of encoded utterances.

    Args:
      enc: [B, T, E] fp32; enc_lengths: [B] int

    Returns (tokens [B, U] int32 padded with blank_id, frames [B, U] int32
    encoder frame of each emission, counts [B] int32).
    """
    if decode_cfg.frame_window != 1:
        raise ValueError("frame_window > 1 is not ported yet")
    b, t, _ = enc.shape
    dev = enc.device
    blank = rnnt_cfg.blank_id
    u_max = decode_cfg.max_tokens or t
    enc_lengths = enc_lengths.to(torch.int32)
    # emission cap tied to the valid length: results do not depend on padding
    emit_cap = torch.clamp(enc_lengths * decode_cfg.max_symbols_per_step, max=u_max)
    enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
    rows = torch.arange(b, device=dev)
    slots = torch.arange(u_max, device=dev)[None, :]

    i32 = dict(dtype=torch.int32, device=dev)
    tokens = torch.full((b, u_max), blank, **i32)
    frames = torch.zeros((b, u_max), **i32)
    counts = torch.zeros((b,), **i32)
    time_idx = torch.zeros((b,), **i32)
    sym_at_frame = torch.zeros((b,), **i32)
    last_tok = torch.full((b,), blank, **i32)
    pred_out, pred_state = predictor_step(
        pred_params, last_tok, predictor_zero_state(b, rnnt_cfg, dev), rnnt_cfg)
    pred_state = _state_to_bl(pred_state, rnnt_cfg)

    def active():
        return (time_idx < enc_lengths) & (counts < emit_cap)

    # every iteration advances a frame or emits: T + u_max bounds the loop
    max_iters, it = t + u_max, 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            act = active()
            force_advance = sym_at_frame >= decode_cfg.max_symbols_per_step
            enc_frame = enc_proj[rows, torch.clamp(time_idx, max=t - 1)]
            logits = joint_step_from_enc_proj(joint_params, enc_frame, pred_out, rnnt_cfg)
            tok = logits.argmax(dim=-1).to(torch.int32)  # first max, as jnp.argmax
            is_blank = (tok == blank) | force_advance
            emit = act & ~is_blank
            advance = act & is_blank

            put = (slots == counts[:, None]) & emit[:, None]
            tokens = torch.where(put, tok[:, None], tokens)
            frames = torch.where(put, time_idx[:, None], frames)
            counts = counts + emit.to(torch.int32)
            sym_at_frame = torch.where(emit, sym_at_frame + 1, sym_at_frame)
            time_idx = time_idx + advance.to(torch.int32)
            sym_at_frame = torch.where(advance, 0, sym_at_frame)

            last_tok = torch.where(emit, tok, last_tok)
            step_out, step_state = predictor_step(
                pred_params, last_tok, _state_from_bl(pred_state, rnnt_cfg), rnnt_cfg)
            pred_out = torch.where(emit[:, None], step_out, pred_out)
            pred_state = tuple(
                torch.where(emit.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
                for new, old in zip(_state_to_bl(step_state, rnnt_cfg), pred_state))
            it += 1
        if not bool(active().any()):
            break
    return tokens, frames, counts
