"""ALSD beam search for transducers (PyTorch).

Port of ``reazonspeech_tpu.decoding.rnnt_beam.rnnt_beam_decode``, NeMo's
Alignment-Length Synchronous Decoding with the reference's semantics:

- every live hypothesis advances one alignment step per iteration, by a
  blank (one encoder frame) or one label, so all share t+u;
- per step each proposes its blank extension and its top ``beam_size``
  labels; the best ``beam_size`` proposals survive (ties to the lowest
  proposal index, as ``lax.top_k``);
- a blank extension at the last encoder frame is a final: it is recorded as
  a value snapshot and leaves the beam; the best final under ``score_norm``
  is the result, else the best live hypothesis;
- hypotheses with equal label sequences merge their scores by log-sum-exp
  into the earliest slot; the duplicate keeps its own slot and score
  (NeMo's ``recombine_hypotheses``) unless ``recombine_dedup``;
- each utterance's budget is ``T + int(alsd_max_target_len·T)`` steps.

The loop body is fixed-shape tensor ops over [B, K] beams, with no host
sync. Elements outside their budget are frozen by masks, so extra steps are
no-ops: the host checks for termination once every ``CHECK_EVERY`` steps
(one sync each), bounded by ``alsd_step_bound`` of the padded length.

On a CUDA device :func:`rnnt_beam_decode` replays each full block of
``CHECK_EVERY`` bodies as one CUDA graph: one host launch a block in place
of some 170 kernel launches a body. A block is captured once for each
shape, weights, configuration and calling stream, over static buffers
(the encoder projection, the lengths, the budgets and the beam state) that
each call copies its inputs into and that the block's last step writes
back to; :data:`GRAPHS_KEPT` captures are cached, the least recently used
dropped first. The graph runs the eager body's kernels on the same inputs
in the same order, so its results are the eager loop's, bit for bit. A
CPU decode, a batch shorter than one block and a last partial block run
the eager loop.

:func:`rnnt_beam_decode` records the span ``decode`` (``utils.profiling``;
attrs ``steps``, the bodies run, ``checks``, ``max_steps`` and
``graph_steps``, the bodies run by a graph's replay) with the children
``decode.setup`` (all before the loop), ``decode.capture`` (a block's
capture, where the cache has none), ``decode.dispatch`` (a block of
``CHECK_EVERY`` bodies, or its replay), ``decode.check`` (the termination
sync) and ``decode.select``, and adds to the counters ``decode.steps``,
``decode.checks``, ``decode.graph_captures`` and ``decode.graph_replays``
(the last two on CUDA only); :func:`alsd_segment` adds its ``n_steps`` to
``decode.steps``. Nothing is recorded per step. A replay adds to the
``launch.<kernel>`` counters the launches its capture recorded, so a
graphed decode counts the kernels that ran.

The per-step joint tail runs, as in the reference:

- ``joint_impl="pallas"``: the joint and the top-m in one op
  (``ops/beam_topk.joint_topm``, fp32; ``topk_impl`` is then unused);
- else the joint, then the log-softmax + blank split + top-m in
  ``ops/beam_topk.topm_logsoftmax`` when ``topk_impl="pallas"``, else in its
  plain twin.

``lstm_impl="pallas"`` steps each predictor LSTM layer with
``ops/lstm_step.lstm_cell_step`` in fp32, for an LSTM predictor with
``pred_hidden % 128 == 0`` (else it is ignored, as in the reference). The ops
launch their kernels on CUDA tensors and run their plain twins on CPU ones.
The predictor state is an LSTM ``(h, c)`` pair or, for a stateless (k2)
predictor, its token context.

``alsd_state_init`` / ``alsd_segment`` / ``alsd_finalize`` expose the same
search as a resumable per-lane state machine (the reference's segmented
API, behind ``serving/continuous.py``): a fixed pool of lanes, each with
its own alignment-step clock, runs exactly ``n_steps`` bodies per call with
no host sync; lanes flagged in ``reset_mask`` restart from the fresh state.
The body has no cross-lane op, so each lane's result equals a dedicated
:func:`rnnt_beam_decode` under the same ``max_tokens``. ``state.step``
advances as the reference's does (every step while any lane of the pool is
active), so the host clock ``min(step + n_steps, alsd_step_bound(len))``
holds.
"""

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import param_device
from ..models.rnnt import (
    RNNTConfig, _embed_tokens, joint_precompute_enc, joint_step_from_enc_proj, predictor_step,
    predictor_zero_state,
)
from ..ops._kernels import deferred_launches
from ..ops.beam_topk import joint_topm, take_workspaces, topm_logsoftmax, topm_logsoftmax_plain
from ..ops.lstm_step import lstm_cell_step
from ..utils.profiling import count, span

__all__ = ["BeamDecodeConfig", "rnnt_beam_decode", "ALSDBeamState", "alsd_state_init",
           "alsd_segment", "alsd_finalize", "alsd_step_bound"]

CHECK_EVERY = 32  # alignment steps between host-side termination checks
GRAPHS_KEPT = 8  # captured blocks cached; the least recently used is dropped
_DEAD = -1.0e30  # score of an empty/killed beam slot
_ALIVE = -1.0e25  # scores above this are live hypotheses


@dataclass(frozen=True)
class BeamDecodeConfig:
    """Field names and defaults as in the JAX package."""

    beam_size: int = 4
    alsd_max_target_len: float = 1.0
    score_norm: bool = True
    recombine_dedup: bool = False
    max_tokens: int = 0  # emission buffer; 0 -> T + u_max
    topk_impl: str = "xla"  # "pallas": the port's top-m kernel
    joint_impl: str = "xla"  # "pallas": the port's joint + top-m kernel
    lstm_impl: str = "xla"  # "pallas": the port's LSTM-cell kernel (pred_hidden % 128 == 0)
    unroll: int = 1  # exact in the reference; the eager loop needs no unrolling


class ALSDBeamState(NamedTuple):
    scores: torch.Tensor  # [B, K] fp32 (_DEAD = empty slot)
    time_idx: torch.Tensor  # [B, K] int32 encoder frame per hypothesis
    counts: torch.Tensor  # [B, K] int32 emissions per hypothesis
    tokens: torch.Tensor  # [B, K, U] int32
    frames: torch.Tensor  # [B, K, U] int32
    last_tok: torch.Tensor  # [B, K] int32
    pred_out: torch.Tensor  # [B, K, H] fp32
    pred_state: object  # LSTM: (h, c), each [B, K, L, H] fp32; stateless: [B, K, ctx-1] int32
    step: torch.Tensor  # [B] int32 alignment-step clock
    fin_key: torch.Tensor  # [B] fp32 best final in the selection metric
    fin_raw: torch.Tensor  # [B] fp32 its raw score
    fin_tokens: torch.Tensor  # [B, U] int32
    fin_frames: torch.Tensor  # [B, U] int32
    fin_count: torch.Tensor  # [B] int32
    fin_any: torch.Tensor  # [B] bool


def alsd_step_bound(lane_len: int, cfg: BeamDecodeConfig) -> int:
    """Upper bound on one utterance's alignment steps."""
    return int(lane_len) + int(cfg.alsd_max_target_len * int(lane_len))


def _check_supported(cfg: BeamDecodeConfig):
    for name in ("topk_impl", "joint_impl", "lstm_impl"):
        if getattr(cfg, name) not in ("xla", "pallas"):
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")


def _norm_key(cfg, score, counts):
    if not cfg.score_norm:
        return score
    return score / (counts.to(torch.float32) + 1.0)


def lstm_kernel_step(pred_params, rnnt_cfg: RNNTConfig, lstm_impl: str):
    """The predictor step through the LSTM cell kernel where ``lstm_impl``
    is "pallas" and the predictor an LSTM with ``pred_hidden % 128 == 0``
    (the reference's guard), else None. The step maps tokens [R] and the
    layers' states (sequences of [R, H]) to (output [R, H] fp32, [h'], [c'])."""
    if not (lstm_impl == "pallas" and rnnt_cfg.predictor_kind == "lstm"
            and rnnt_cfg.pred_hidden % 128 == 0):
        return None
    layers = [(p["w_ih"], p["w_hh"], p["b_ih"] + p["b_hh"]) for p in pred_params["lstm"]]

    def step(tokens, hs, cs):
        # fp32 between layers, without predictor_step's casts to the compute
        # dtype: the reference's kernel branch
        x = _embed_tokens(pred_params, tokens, rnnt_cfg).to(torch.float32)
        h_new, c_new = [], []
        for (w_ih, w_hh, bias), h, c in zip(layers, hs, cs):
            x, c_next = lstm_cell_step(w_ih, w_hh, bias, x, h.contiguous(), c.contiguous(),
                                       compute_dtype="float32")
            h_new.append(x)
            c_new.append(c_next)
        return x, h_new, c_new

    return step


def joint_tail(joint_params, rnnt_cfg: RNNTConfig, cfg, m):
    """The beam decoders' per-step joint tail, chosen by ``cfg.joint_impl``
    and ``cfg.topk_impl``: (enc rows [R, J], predictor rows [R, H]) ->
    (lp_blank [R], top_lp [R, m], top_tok [R, m])."""
    blank = rnnt_cfg.blank_id
    if cfg.joint_impl == "pallas":
        pred, out = joint_params["pred"], joint_params["out"]
        return lambda enc_rows, dec_rows: joint_topm(
            pred["w"], pred["b"], out["w"], out["b"], enc_rows, dec_rows, m, blank,
            activation=rnnt_cfg.joint_activation, compute_dtype="float32")
    topm = topm_logsoftmax if cfg.topk_impl == "pallas" else topm_logsoftmax_plain
    return lambda enc_rows, dec_rows: topm(
        joint_step_from_enc_proj(joint_params, enc_rows, dec_rows, rnnt_cfg), m, blank)


def _make_pred_step(pred_params, rnnt_cfg: RNNTConfig, cfg: BeamDecodeConfig):
    """predictor_step over flat [R] token rows, through the LSTM cell kernel
    where :func:`lstm_kernel_step` applies; the state stays ``(h, c)``
    [L, R, H] (or the stateless context [R, ctx-1]) either way."""
    fused = lstm_kernel_step(pred_params, rnnt_cfg, cfg.lstm_impl)
    if fused is None:
        return lambda tokens, state: predictor_step(pred_params, tokens, state, rnnt_cfg)

    def pred_step(tokens, state):
        out, hs, cs = fused(tokens, *state)
        return out, (torch.stack(hs), torch.stack(cs))

    return pred_step


def _to_rows(state, rnnt_cfg):
    """Beam-layout predictor state [B, K, ...] -> the predictor's flat form."""
    if rnnt_cfg.predictor_kind == "stateless":
        return state.flatten(0, 1)
    return tuple(s.flatten(0, 1).transpose(0, 1) for s in state)


def _to_beams(state, rnnt_cfg, b, k):
    """The predictor's flat state -> beam layout [B, K, ...]."""
    if rnnt_cfg.predictor_kind == "stateless":
        return state.reshape(b, k, -1)
    return tuple(s.transpose(0, 1).reshape(b, k, *s.shape[::2]) for s in state)


def _map_state(fn, *states):
    """fn over the tensors of one or more predictor states of the same kind."""
    if isinstance(states[0], tuple):
        return tuple(fn(*parts) for parts in zip(*states))
    return fn(*states)


def _init_state(pred_params, b, rnnt_cfg: RNNTConfig, cfg: BeamDecodeConfig, u_buf,
                device):
    """Slot 0 holds the initial hypothesis (blank consumed by one predictor
    step, through the same branch as the loop's); the other slots are dead."""
    k = cfg.beam_size
    blank = rnnt_cfg.blank_id
    i32 = dict(dtype=torch.int32, device=device)
    pred_step = _make_pred_step(pred_params, rnnt_cfg, cfg)
    pred_out, pred_state = pred_step(torch.full((b * k,), blank, **i32),
                                     predictor_zero_state(b * k, rnnt_cfg, device))
    scores = torch.full((b, k), _DEAD, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    return ALSDBeamState(
        scores=scores,
        time_idx=torch.zeros((b, k), **i32),
        counts=torch.zeros((b, k), **i32),
        tokens=torch.full((b, k, u_buf), blank, **i32),
        frames=torch.zeros((b, k, u_buf), **i32),
        last_tok=torch.full((b, k), blank, **i32),
        pred_out=pred_out.reshape(b, k, -1),
        pred_state=_to_beams(pred_state, rnnt_cfg, b, k),
        step=torch.zeros((b,), **i32),
        fin_key=torch.full((b,), _DEAD, dtype=torch.float32, device=device),
        fin_raw=torch.full((b,), _DEAD, dtype=torch.float32, device=device),
        fin_tokens=torch.full((b, u_buf), blank, **i32),
        fin_frames=torch.zeros((b, u_buf), **i32),
        fin_count=torch.zeros((b,), **i32),
        fin_any=torch.zeros((b,), dtype=torch.bool, device=device),
    )


def _el_active(s: ALSDBeamState, enc_lengths, u_max_el):
    """Elements inside their ALSD budget with a live hypothesis."""
    return (s.step < enc_lengths + u_max_el) & (s.scores > _ALIVE).any(dim=1)


def _make_body(pred_params, joint_params, enc_proj, enc_lengths, u_max_el,
               rnnt_cfg: RNNTConfig, cfg: BeamDecodeConfig):
    """One ALSD alignment step over the batch (no cross-element ops)."""
    b, t, _ = enc_proj.shape
    k = cfg.beam_size
    m = min(k, rnnt_cfg.num_classes - 1)  # label expansions per hypothesis
    bk = b * k
    dev = enc_proj.device
    rows = torch.arange(b, device=dev)[:, None]
    jidx = torch.arange(k, device=dev)
    blank = rnnt_cfg.blank_id
    pred_step = _make_pred_step(pred_params, rnnt_cfg, cfg)
    joint_topm_step = joint_tail(joint_params, rnnt_cfg, cfg, m)
    last_frame = enc_lengths[:, None] - 1

    def body(s: ALSDBeamState) -> ALSDBeamState:
        u_buf = s.tokens.shape[-1]
        active_el = _el_active(s, enc_lengths, u_max_el)  # [B]
        alive = s.scores > _ALIVE  # [B, K]

        enc_frames = enc_proj[rows, torch.clamp(s.time_idx, max=t - 1)]  # [B, K, J]
        lp_blank, top_lp, top_tok = joint_topm_step(enc_frames.reshape(bk, -1),
                                                    s.pred_out.reshape(bk, -1))
        lp_blank = lp_blank.reshape(b, k)
        top_lp = top_lp.reshape(b, k, m)
        top_tok = top_tok.reshape(b, k, m)

        blank_scores = torch.where(alive, s.scores + lp_blank, _DEAD)
        can_emit = alive & (s.counts < u_buf)
        emit_scores = torch.where(can_emit[..., None], s.scores[..., None] + top_lp, _DEAD)

        # --- finals: blank extension of a hypothesis at its last frame ----
        finalize = alive & (s.time_idx == last_frame)
        f_key = torch.where(finalize, _norm_key(cfg, blank_scores, s.counts), _DEAD)
        best_k = f_key.argmax(dim=1, keepdim=True)  # [B, 1], first max
        best_key = f_key.gather(1, best_k)[:, 0]
        improved = active_el & (best_key > s.fin_key)
        g1 = lambda x: x.gather(1, best_k)[:, 0]  # noqa: E731
        g2 = lambda x: x[rows, best_k][:, 0]  # noqa: E731
        fin_key = torch.where(improved, best_key, s.fin_key)
        fin_raw = torch.where(improved, g1(blank_scores), s.fin_raw)
        fin_tokens = torch.where(improved[:, None], g2(s.tokens), s.fin_tokens)
        fin_frames = torch.where(improved[:, None], g2(s.frames), s.fin_frames)
        fin_count = torch.where(improved, g1(s.counts), s.fin_count)
        fin_any = s.fin_any | (improved & finalize.any(dim=1))

        # --- beam selection: top-K of all blank + label proposals ---------
        flat_scores = torch.cat([blank_scores[..., None], emit_scores], dim=-1).reshape(
            b, k * (m + 1))
        # a stable descending sort keeps ties in index order (lax.top_k's)
        new_scores, flat_idx = torch.sort(flat_scores, dim=1, descending=True, stable=True)
        new_scores, flat_idx = new_scores[:, :k], flat_idx[:, :k]
        src = flat_idx // (m + 1)
        cand = flat_idx % (m + 1)  # 0 = blank, >= 1 = label index

        n_time, n_counts, n_tokens, n_frames, n_last, n_pred_out, n_top = (
            x[rows, src] for x in (s.time_idx, s.counts, s.tokens, s.frames, s.last_tok,
                                   s.pred_out, top_tok))
        n_state = _map_state(lambda x: x[rows, src], s.pred_state)
        new_tok = n_top.gather(-1, torch.clamp(cand - 1, min=0)[..., None])[..., 0]

        sel_alive = new_scores > _ALIVE
        is_blank = cand == 0
        emit = ~is_blank & sel_alive
        advance = is_blank & sel_alive

        put = (torch.arange(u_buf, device=dev)[None, None, :] == n_counts[..., None]) \
            & emit[..., None]
        n_tokens = torch.where(put, new_tok[..., None], n_tokens)
        n_frames = torch.where(put, n_time[..., None], n_frames)
        n_counts = n_counts + emit.to(torch.int32)
        n_time = n_time + advance.to(torch.int32)

        # a hypothesis that consumed its last frame was finalised above
        new_scores = torch.where(n_time >= enc_lengths[:, None], _DEAD, new_scores)

        # --- recombination (identical label sequences merge) --------------
        valid = new_scores > _ALIVE
        eq = (
            (n_tokens[:, :, None, :] == n_tokens[:, None, :, :]).all(dim=-1)
            & (n_counts[:, :, None] == n_counts[:, None, :])
            & valid[:, :, None] & valid[:, None, :]
        )  # [B, K, K]
        leader = torch.where(eq, jidx[None, None, :], k).min(dim=-1).values
        leader = torch.where(valid, leader, jidx[None, :])
        is_leader = leader == jidx[None, :]
        member = leader[:, :, None] == jidx[None, None, :]  # [B, K(i), K(j)]
        member_scores = torch.where(member, new_scores[:, :, None], _DEAD)
        mmax = member_scores.max(dim=1).values  # [B, K(j)]
        merged = mmax + torch.log(torch.exp(member_scores - mmax[:, None, :]).sum(dim=1))
        new_scores = torch.where(is_leader, merged, _DEAD if cfg.recombine_dedup else new_scores)

        # --- prediction network advances where a label was emitted --------
        stepped_tok = torch.where(emit, new_tok, n_last)
        out, stepped = pred_step(stepped_tok.reshape(bk), _to_rows(n_state, rnnt_cfg))
        n_pred_out = torch.where(emit[..., None], out.reshape(b, k, -1), n_pred_out)
        n_state = _map_state(
            lambda new, old: torch.where(emit.reshape(b, k, *(1,) * (new.dim() - 2)), new, old),
            _to_beams(stepped, rnnt_cfg, b, k), n_state)

        # --- freeze elements outside their budget -------------------------
        def keep(new, old):
            return torch.where(active_el.reshape((b,) + (1,) * (new.dim() - 1)), new, old)

        return ALSDBeamState(
            scores=keep(new_scores, s.scores), time_idx=keep(n_time, s.time_idx),
            counts=keep(n_counts, s.counts), tokens=keep(n_tokens, s.tokens),
            frames=keep(n_frames, s.frames), last_tok=keep(stepped_tok, s.last_tok),
            pred_out=keep(n_pred_out, s.pred_out),
            pred_state=_map_state(keep, n_state, s.pred_state), step=s.step + 1,
            fin_key=fin_key, fin_raw=fin_raw, fin_tokens=fin_tokens,
            fin_frames=fin_frames, fin_count=fin_count, fin_any=fin_any)

    return body


def _select_best(s: ALSDBeamState, cfg: BeamDecodeConfig):
    """Best recorded final, else the best live hypothesis."""
    beam_key = torch.where(s.scores > _ALIVE, _norm_key(cfg, s.scores, s.counts), _DEAD)
    best = beam_key.argmax(dim=1, keepdim=True)  # [B, 1]
    rows = torch.arange(best.shape[0], device=best.device)[:, None]
    take1 = lambda x: x.gather(1, best)[:, 0]  # noqa: E731
    take2 = lambda x: x[rows, best][:, 0]  # noqa: E731
    fa = s.fin_any
    tokens = torch.where(fa[:, None], s.fin_tokens, take2(s.tokens))
    frames = torch.where(fa[:, None], s.fin_frames, take2(s.frames))
    counts = torch.where(fa, s.fin_count, take1(s.counts))
    scores = torch.where(fa, s.fin_raw, take1(s.scores))
    return tokens, frames, counts, scores


def rnnt_beam_decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                     cfg: BeamDecodeConfig = BeamDecodeConfig()):
    """ALSD beam-search decode a batch.

    Args:
      enc: [B, T, E] fp32; enc_lengths: [B] int

    Returns (tokens [B, U] int32 of the best hypothesis, frames [B, U] int32,
    counts [B] int32, scores [B] fp32 raw).
    """
    with span("decode") as root, contextlib.ExitStack() as held:
        with span("decode.setup"):
            _check_supported(cfg)
            b, t, _ = enc.shape
            enc_lengths = enc_lengths.to(torch.int32)
            enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
            max_steps = alsd_step_bound(t, cfg)
            u_buf = cfg.max_tokens or max_steps
            u_max_el = torch.floor(
                cfg.alsd_max_target_len * enc_lengths.to(torch.float32)).to(torch.int32)
            state = _init_state(pred_params, b, rnnt_cfg, cfg, u_buf, enc.device)
            block = None
            if _graphable(enc_proj, max_steps):
                block = _block_graph(torch.cuda.current_stream(enc.device).cuda_stream,
                                     pred_params, joint_params, enc_proj, state, rnnt_cfg, cfg)
                held.enter_context(block.lock)  # the static buffers are this call's
                block.load(enc_proj, enc_lengths, u_max_el, state)
                enc_proj, enc_lengths, u_max_el, state = (
                    block.enc_proj, block.enc_lengths, block.u_max_el, block.state)
            body = _make_body(pred_params, joint_params, enc_proj, enc_lengths, u_max_el,
                              rnnt_cfg, cfg)
        if block is not None and block.graph is None:
            with span("decode.capture"):
                block.capture(pred_params, joint_params, rnnt_cfg, cfg)
            count("decode.graph_captures")
        steps = checks = graph_steps = 0
        while steps < max_steps:
            n = min(CHECK_EVERY, max_steps - steps)
            with span("decode.dispatch"):
                if block is not None and n == CHECK_EVERY:
                    block.replay()  # reads and writes back the static state
                    graph_steps += n
                else:
                    for _ in range(n):
                        state = body(state)
            steps += n
            checks += 1
            with span("decode.check"):
                active = bool(_el_active(state, enc_lengths, u_max_el).any())
            if not active:
                break
        with span("decode.select"):
            out = _select_best(state, cfg)
        root.set(steps=steps, checks=checks, max_steps=max_steps, graph_steps=graph_steps)
    count("decode.steps", steps)
    count("decode.checks", checks)
    if block is not None:
        count("decode.graph_replays", graph_steps // CHECK_EVERY)
    return out


# --- the block of CHECK_EVERY bodies as a CUDA graph -------------------------


def _graphable(enc_proj, max_steps):
    """Whether the loop replays its full blocks as a CUDA graph: a decode on
    a CUDA device with at least one full block."""
    return enc_proj.is_cuda and max_steps >= CHECK_EVERY


def _leaves(state):
    """The tensors of a beam state in field order (an LSTM state's two)."""
    return [t for x in state for t in (x if isinstance(x, tuple) else (x,))]


def _weights(tree):
    """The tensors of a parameter tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [w for x in tree for w in _weights(x)]


class _BlockGraph:
    """One block of ``CHECK_EVERY`` bodies captured as a CUDA graph over
    static buffers: the encoder projection, the lengths, the budgets and the
    beam state, which the block reads and, at its last step, writes back.
    It holds every tensor the graph reads (the weights, the buffers, the
    kernels' workspaces), so no captured address is freed while it lives;
    ``lock`` is held by the call that uses its buffers."""

    def __init__(self, weights, enc_proj, state):
        self.weights = weights
        self.lock = threading.Lock()
        self.graph = None
        with torch.inference_mode(False):  # a buffer any caller may copy into
            self.enc_proj = torch.empty_like(enc_proj)
            b = enc_proj.shape[0]
            self.enc_lengths, self.u_max_el = (
                torch.empty((b,), dtype=torch.int32, device=enc_proj.device) for _ in range(2))
            self.state = ALSDBeamState(*(_map_state(torch.empty_like, x) for x in state))

    def _buffers(self):
        return [self.enc_proj, self.enc_lengths, self.u_max_el, *_leaves(self.state)]

    def load(self, enc_proj, enc_lengths, u_max_el, state):
        """Copy a call's inputs and fresh state into the static buffers."""
        with torch.no_grad():
            for dst, src in zip(self._buffers(), [enc_proj, enc_lengths, u_max_el,
                                                  *_leaves(state)]):
                dst.copy_(src)

    def capture(self, pred_params, joint_params, rnnt_cfg, cfg):
        """Capture the block on the device's capture stream, which no
        caller runs on. One body runs there first, outside the capture, so
        that lazy library handles and the kernels' workspaces exist before
        it (its launches ran and count); the graph then takes those
        workspaces for its own. The body is built inside the capture, so
        what it derives from the lengths and weights is computed anew at
        each replay.

        One capture at a time in the process: a capture begins with a
        device-wide synchronise, and a synchronise of the device from any
        thread invalidates a capture under way."""
        dev = self.enc_proj.device
        caller = torch.cuda.current_stream(dev)
        make = lambda: _make_body(pred_params, joint_params, self.enc_proj,  # noqa: E731
                                  self.enc_lengths, self.u_max_el, rnnt_cfg, cfg)
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.no_grad(), torch.cuda.device(dev):
            side = _capture_streams.get(dev)
            if side is None:  # one a device: PyTorch's pool of 32 streams wraps round
                side = _capture_streams[dev] = torch.cuda.Stream(dev)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                make()(self.state)
            with deferred_launches() as launches, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                body, s = make(), self.state
                for _ in range(CHECK_EVERY):
                    s = body(s)
                for dst, src in zip(_leaves(self.state), _leaves(s)):
                    dst.copy_(src)
            self.workspaces = take_workspaces(dev, side.cuda_stream)
        for buf in self.workspaces:  # replays run on the caller's stream
            buf.record_stream(caller)
        self.graph, self.launches = graph, launches

    def replay(self):
        """Run the block on the current stream; count its kernels."""
        self.graph.replay()
        for name, n in self.launches.items():
            count(name, n)


_graphs = OrderedDict()  # key -> _BlockGraph, the least recently used first
_graphs_lock = threading.Lock()
_capture_lock = threading.Lock()  # held through a capture
_capture_streams = {}  # device -> the stream captures run on, in turn


def _block_graph(stream, pred_params, joint_params, enc_proj, state, rnnt_cfg, cfg):
    """The cached :class:`_BlockGraph` for a decode on ``stream`` (the
    caller's, as ``cuda_stream``) at these shapes, weights and
    configurations; a new one, not yet captured, where none matches."""
    weights = _weights((pred_params, joint_params))
    key = (enc_proj.device, stream, tuple(enc_proj.shape), enc_proj.dtype,
           tuple((t.dtype, tuple(t.shape)) for t in _leaves(state)), rnnt_cfg, cfg,
           tuple(w.data_ptr() for w in weights))
    with _graphs_lock:
        entry = _graphs.pop(key, None) or _BlockGraph(weights, enc_proj, state)
        _graphs[key] = entry
        while len(_graphs) > GRAPHS_KEPT:
            _graphs.popitem(last=False)
    return entry


# --- resumable per-lane segments (continuous batching) -----------------------


def _apply_reset(state: ALSDBeamState, reset, fresh: ALSDBeamState) -> ALSDBeamState:
    """Lanes flagged in ``reset`` [B] take the fresh state (a new request
    joins); the others keep theirs."""
    def pick(new, old):
        return torch.where(reset.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

    return ALSDBeamState(*(_map_state(pick, new, old) for new, old in zip(fresh, state)))


def alsd_state_init(pred_params, b: int, rnnt_cfg: RNNTConfig,
                    cfg: BeamDecodeConfig) -> ALSDBeamState:
    """Fresh lane-pool state on the predictor's device (``cfg.max_tokens``
    must be set: a segment cannot default the emission buffer to T)."""
    _check_supported(cfg)
    if cfg.max_tokens <= 0:
        raise ValueError("alsd_state_init: cfg.max_tokens must be set for segmented decode "
                         "(the emission buffer cannot default to T)")
    return _init_state(pred_params, b, rnnt_cfg, cfg, cfg.max_tokens, param_device(pred_params))


def alsd_segment(pred_params, joint_params, enc_ring, lane_len, reset_mask,
                 state: ALSDBeamState, rnnt_cfg: RNNTConfig, cfg: BeamDecodeConfig,
                 n_steps: int):
    """Advance every lane by ``n_steps`` alignment steps (lanes outside
    their budget are frozen; no host sync).

    Where the whole pool goes inactive inside the segment, the reference
    leaves its loop and ``state.step`` stops there; here every lane's step
    runs on to ``n_steps``. Nothing else differs: an inactive lane stays
    inactive as its step grows, a reset puts the step back to 0, and the
    executor's lane clock is kept on the host, not read from ``step``.

    Args:
      enc_ring: [B, T_buf, J] per-lane joint encoder projections (each
        lane's utterance at rows 0..len-1)
      lane_len: [B] int32 valid encoder frames per lane (0 = idle)
      reset_mask: [B] bool, lanes re-initialised before stepping

    Returns ``(state, done)``; ``done`` [B] bool is True once a lane's
    search is over (budget spent, or no live hypothesis left).
    """
    lane_len = lane_len.to(torch.int32)
    b = state.scores.shape[0]
    fresh = _init_state(pred_params, b, rnnt_cfg, cfg, state.tokens.shape[-1], enc_ring.device)
    state = _apply_reset(state, reset_mask, fresh)
    u_max_el = torch.floor(cfg.alsd_max_target_len * lane_len.to(torch.float32)).to(torch.int32)
    body = _make_body(pred_params, joint_params, enc_ring, lane_len, u_max_el, rnnt_cfg, cfg)
    for _ in range(n_steps):
        state = body(state)
    count("decode.steps", n_steps)
    return state, ~_el_active(state, lane_len, u_max_el)


def alsd_finalize(state: ALSDBeamState, lane_len, rnnt_cfg: RNNTConfig, cfg: BeamDecodeConfig):
    """(tokens [B, U], frames [B, U], counts [B], scores [B]) of each lane's
    best hypothesis; idle lanes (``lane_len`` 0) count 0."""
    tokens, frames, counts, scores = _select_best(state, cfg)
    return tokens, frames, torch.where(lane_len <= 0, 0, counts), scores
