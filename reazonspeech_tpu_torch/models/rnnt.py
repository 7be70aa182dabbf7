"""RNN-T prediction and joint networks (PyTorch).

Port of ``reazonspeech_tpu.models.rnnt``, both prediction networks:

- ``predictor_kind="lstm"`` (NeMo): an LSTM with ``blank_id == vocab_size``
  (the last logit; blank and start-of-sequence embed to the zero vector),
  gates packed (i, f, g, o); its state is ``(h, c)``, each [L, B, H].
- ``predictor_kind="stateless"`` (k2/icefall): the embeddings of the last
  ``context_size`` tokens, concatenated, through ``ctx_proj`` and a ReLU;
  blank is id 0 and has an embedding row; its state is the [B,
  context_size-1] int32 token context, blank-padded at the start.

The joint is ``W_out · act(W_enc·enc + W_pred·pred)``. The dtype chains are
the reference's: ``_lstm_cell`` sums its gate terms in the compute dtype
and runs the cell in fp32; the stateless projection and the joint run in
the compute dtype, and the joint returns fp32 logits.
"""

import math
from dataclasses import dataclass

import torch

from .layers import dense, dense_init, embedding_init

__all__ = [
    "RNNTConfig", "init_predictor", "init_joint", "predictor_zero_state",
    "predictor_step", "predictor_sequence", "joint_step", "joint_full",
    "joint_precompute_enc", "joint_step_from_enc_proj",
]


@dataclass(frozen=True)
class RNNTConfig:
    """Field names and defaults as in the JAX package."""

    vocab_size: int = 3000
    enc_dim: int = 1024
    pred_hidden: int = 640
    pred_rnn_layers: int = 1
    joint_hidden: int = 640
    joint_activation: str = "relu"  # relu | tanh | sigmoid
    compute_dtype: str = "bfloat16"
    predictor_kind: str = "lstm"  # lstm | stateless
    context_size: int = 2
    blank_position: str = "auto"  # auto | first | last

    @property
    def blank_first(self) -> bool:
        if self.blank_position != "auto":
            return self.blank_position == "first"
        return self.predictor_kind == "stateless"

    @property
    def blank_id(self) -> int:
        return 0 if self.blank_first else self.vocab_size

    @property
    def num_classes(self) -> int:
        return self.vocab_size if self.blank_first else self.vocab_size + 1

    @property
    def dtype(self):
        return getattr(torch, self.compute_dtype)

    @staticmethod
    def tiny(**overrides) -> "RNNTConfig":
        cfg = dict(vocab_size=64, enc_dim=64, pred_hidden=32, joint_hidden=32)
        cfg.update(overrides)
        return RNNTConfig(**cfg)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_predictor(gen, cfg: RNNTConfig, device="cpu"):
    if cfg.predictor_kind == "stateless":
        return {
            "embed": embedding_init(gen, cfg.vocab_size, cfg.pred_hidden, device=device),
            "ctx_proj": dense_init(gen, cfg.context_size * cfg.pred_hidden, cfg.pred_hidden,
                                   device=device),
        }
    s = 1.0 / math.sqrt(cfg.pred_hidden)
    h4 = 4 * cfg.pred_hidden

    def u(*shape):
        return (torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0) * s

    embed = embedding_init(gen, cfg.vocab_size, cfg.pred_hidden, device=device)
    layers = [
        {"w_ih": u(cfg.pred_hidden, h4), "w_hh": u(cfg.pred_hidden, h4),
         "b_ih": u(h4), "b_hh": u(h4)}
        for _ in range(cfg.pred_rnn_layers)
    ]
    return {"embed": embed, "lstm": layers}


def init_joint(gen, cfg: RNNTConfig, device="cpu"):
    return {
        "enc": dense_init(gen, cfg.enc_dim, cfg.joint_hidden, device=device),
        "pred": dense_init(gen, cfg.pred_hidden, cfg.joint_hidden, device=device),
        "out": dense_init(gen, cfg.joint_hidden, cfg.num_classes, device=device),
    }


# ---------------------------------------------------------------------------
# prediction network
# ---------------------------------------------------------------------------


def predictor_zero_state(batch, cfg: RNNTConfig, device="cpu"):
    """LSTM: (h, c), each [L, B, H] fp32. Stateless: the [B, context_size-1]
    int32 context of the last tokens, all blank."""
    if cfg.predictor_kind == "stateless":
        return torch.full((batch, cfg.context_size - 1), cfg.blank_id, dtype=torch.int32,
                          device=device)
    shape = (cfg.pred_rnn_layers, batch, cfg.pred_hidden)
    return (torch.zeros(shape, device=device), torch.zeros(shape, device=device))


def _lstm_cell(p, x, h, c):
    dt = x.dtype
    gates = (
        x @ p["w_ih"].to(dt) + h.to(dt) @ p["w_hh"].to(dt) + (p["b_ih"] + p["b_hh"]).to(dt)
    ).to(torch.float32)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _embed_tokens(p, tokens, cfg: RNNTConfig):
    """Blank-last convention: ids ≥ vocab_size (blank / SOS) embed to zeros.
    Blank-first: every id, blank included, has a row."""
    table = p["embed"]["table"]
    if cfg.blank_first:
        return table[tokens.long()]
    emb = table[torch.clamp(tokens, max=cfg.vocab_size - 1).long()]
    return torch.where((tokens >= cfg.vocab_size)[..., None], 0.0, emb)


def predictor_step(params, tokens, state, cfg: RNNTConfig):
    """One decode step: tokens [B] int (blank_id for start-of-sequence),
    state as :func:`predictor_zero_state` gives it -> (g [B, H] fp32,
    new_state)."""
    dt = cfg.dtype
    if cfg.predictor_kind == "stateless":
        context = torch.cat([state, tokens.to(state.dtype)[:, None]], dim=1)  # [B, ctx]
        emb = _embed_tokens(params, context, cfg).to(dt)  # [B, ctx, H]
        g = torch.relu(dense(params["ctx_proj"], emb.reshape(emb.shape[0], -1), dtype=dt))
        return g.to(torch.float32), context[:, 1:]
    x = _embed_tokens(params, tokens, cfg).to(dt)
    h, c = state
    hs, cs = [], []
    for li, layer in enumerate(params["lstm"]):
        h_new, c_new = _lstm_cell(layer, x, h[li], c[li])
        hs.append(h_new)
        cs.append(c_new)
        x = h_new.to(dt)
    return x.to(torch.float32), (torch.stack(hs), torch.stack(cs))


def predictor_sequence(params, tokens, cfg: RNNTConfig, state=None):
    """Teacher-forced prediction over a whole label sequence (training).

    Args:
      tokens: [B, U] int label sequences (no SOS: blank is prepended here)
      state: the start state (default :func:`predictor_zero_state`)

    Returns g [B, U+1, H] fp32; g[:, 0] is the SOS context's output. One
    :func:`predictor_step` a position, as the reference's scan."""
    b = tokens.shape[0]
    sos = torch.full((b, 1), cfg.blank_id, dtype=tokens.dtype, device=tokens.device)
    inp = torch.cat([sos, tokens], dim=1)
    if state is None:
        state = predictor_zero_state(b, cfg, tokens.device)
    gs = []
    for u in range(inp.shape[1]):
        g, state = predictor_step(params, inp[:, u], state, cfg)
        gs.append(g)
    return torch.stack(gs, dim=1)


# ---------------------------------------------------------------------------
# joint network
# ---------------------------------------------------------------------------


def _joint_act(x, cfg: RNNTConfig):
    if cfg.joint_activation == "relu":
        return torch.relu(x)
    if cfg.joint_activation == "tanh":
        return torch.tanh(x)
    if cfg.joint_activation == "sigmoid":
        return torch.sigmoid(x)
    raise ValueError(cfg.joint_activation)


def joint_step(params, enc_frame, pred_out, cfg: RNNTConfig):
    """Pointwise joint: enc_frame [B, E], pred_out [B, H] -> logits
    [B, num_classes] fp32."""
    dt = cfg.dtype
    z = dense(params["enc"], enc_frame, dtype=dt) + dense(params["pred"], pred_out, dtype=dt)
    return dense(params["out"], _joint_act(z, cfg), dtype=dt).to(torch.float32)


def joint_full(params, enc, pred, cfg: RNNTConfig):
    """The whole lattice's joint, for the training loss: enc [B, T, E],
    pred [B, U+1, H] -> logits [B, T, U+1, num_classes] fp32 (the hidden
    layer in the compute dtype)."""
    dt = cfg.dtype
    f = dense(params["enc"], enc, dtype=dt)  # [B, T, J]
    g = dense(params["pred"], pred, dtype=dt)  # [B, U+1, J]
    z = _joint_act(f[:, :, None, :] + g[:, None, :, :], cfg)
    return dense(params["out"], z, dtype=dt).to(torch.float32)


def joint_precompute_enc(params, enc, cfg: RNNTConfig):
    """Encoder side of the joint, hoisted out of the decode loop:
    [B, T, E] -> [B, T, J] fp32."""
    return dense(params["enc"], enc, dtype=cfg.dtype).to(torch.float32)


def joint_step_from_enc_proj(params, enc_proj_frame, pred_out, cfg: RNNTConfig):
    """Joint logits [R, num_classes] fp32 from enc_proj [R, J] and the
    predictor output [R, H]."""
    dt = cfg.dtype
    z = enc_proj_frame.to(dt) + dense(params["pred"], pred_out, dtype=dt)
    return dense(params["out"], _joint_act(z, cfg), dtype=dt).to(torch.float32)
