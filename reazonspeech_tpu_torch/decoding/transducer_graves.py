"""Graves-style transducer beam search (ESPnet default_beam_search), PyTorch.

Port of ``reazonspeech_tpu.decoding.transducer_graves.graves_beam_decode``.
Per encoder frame the search repeatedly pops the best pending hypothesis,
keeps its blank extension and pushes its top-``beam`` label extensions,
until at least ``beam`` kept hypotheses outscore every pending one (ESPnet's
termination test). The reference runs it batched with fixed shapes, and so
does the port:

- each pop appends a node (its token/frame row and LSTM states) to a
  per-frame node arena; children reference their parent node, so a pop is
  one [B]-wide predictor step, the joint and an O(U) row copy;
- the pending and kept sets live in fixed-capacity tensors; lanes whose
  frame is done are masked (their writes land in scratch or repeat what is
  there), so a pop issued after a lane's frame ended changes nothing of it;
- survivors are compacted into node slots 0..KC-1 once per frame for the
  whole batch (the per-frame barrier);
- the bounds ESPnet does not have keep the shapes static:
  ``max_pops_per_frame`` (default 6·beam+8; a frame that reaches it keeps
  its best ``beam`` kept hypotheses and ``saturated`` reports it),
  ``kept_capacity`` (default beam+12) and ``max_tokens`` (default T).

Output selection matches ESPnet ``sort_nbest``: the best kept hypothesis by
``score / (len + 1)`` when ``score_norm``, raw score otherwise.

Host syncs: the frame loop runs ``max(lengths)`` frames (one read of the
lengths a call). Every frame needs at least ``beam`` pops (the termination
test counts kept hypotheses, one a pop), so those are issued without a
look; after each further pop the frame's done flag is copied to pinned host
memory asynchronously and read once its copy has landed. The host waits on
a flag only when more than ``_MAX_LAG`` flags are in flight (the device is
behind); extra pops issued meanwhile are masked no-ops. No pop reads a
device value on the host (``.item()``). On CPU tensors the flag is read
after each pop.

The per-pop log-softmax + blank split + top-m runs in ``ops/beam_topk``
when ``topk_impl="pallas"`` (the kernel on CUDA tensors), else in its plain
twin. ``multipop``, ``unroll``, ``joint_impl`` and ``lstm_impl`` other than
their defaults, and the segmented API, are not ported (ROADMAP).
"""

import collections
from dataclasses import dataclass

import torch

from ..models.rnnt import RNNTConfig, joint_precompute_enc, joint_step_from_enc_proj, predictor_step
from ..ops.beam_topk import topm_logsoftmax, topm_logsoftmax_plain

__all__ = ["GravesBeamConfig", "graves_beam_decode", "graves_beam_decode_stats"]

_DEAD = -1.0e30
_ALIVE = -1.0e25
_MAX_LAG = 2  # done flags in flight before the host waits for the oldest


@dataclass(frozen=True)
class GravesBeamConfig:
    """Field names and defaults as in the JAX package."""

    beam_size: int = 20
    score_norm: bool = True
    max_pops_per_frame: int = 0  # 0 -> 6*beam + 8
    kept_capacity: int = 0  # 0 -> beam + 12
    max_tokens: int = 0  # 0 -> T
    topk_impl: str = "xla"  # "pallas": the port's top-m kernel
    joint_impl: str = "xla"  # fused joint + top-m kernel: not ported yet
    lstm_impl: str = "xla"  # fused LSTM-cell kernel: not ported yet
    unroll: int = 1
    multipop: int = 1
    multipop_arena_factor: float = 1.5


def _check_supported(rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig):
    if rnnt_cfg.predictor_kind != "lstm":
        raise NotImplementedError("graves beam search: LSTM predictors only")
    if not rnnt_cfg.blank_first:
        raise NotImplementedError("espnet convention: blank id 0")
    for name, default in (("joint_impl", "xla"), ("lstm_impl", "xla"), ("multipop", 1),
                          ("unroll", 1)):
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"GravesBeamConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                "(ROADMAP.md, queue 1 item 15: the opt-in knobs)")
    if cfg.topk_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown topk_impl {cfg.topk_impl!r}")


def _dims(rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig, t):
    """(k, beam_k, p_max, kc, u_buf, n_nodes, c_pend) as in the reference."""
    v = rnnt_cfg.num_classes
    k = min(cfg.beam_size, v)
    beam_k = min(k, v - 1)
    p_max = cfg.max_pops_per_frame or (6 * k + 8)
    kc = cfg.kept_capacity or (k + 12)
    u_buf = cfg.max_tokens or t
    n_nodes = kc + p_max + 1  # +1 scratch row
    c_pend = kc + p_max * beam_k + beam_k  # + scratch block
    return k, beam_k, p_max, kc, u_buf, n_nodes, c_pend


class _Frame:
    """One frame's pop state machine over the batch (the reference's
    ``pop_body``), on the node arenas of the whole decode."""

    def __init__(self, arenas, cs, in_frame, enc_row, f, pred_params, joint_params,
                 rnnt_cfg, topm, dims):
        self.a = arenas
        self.k, self.beam_k, self.p_max, self.kc, self.u_buf, _, c_pend = dims
        self.pred_params, self.joint_params, self.rnnt_cfg = pred_params, joint_params, rnnt_cfg
        self.topm, self.enc_row, self.f = topm, enc_row, f
        b, dev = cs.shape[0], cs.device
        self.c_pend = c_pend
        self.bi = torch.arange(b, device=dev)
        self.upos = torch.arange(self.u_buf, device=dev)[None, :]
        # pending = the survivors of lanes in this frame; kept empty
        self.ps = torch.full((b, c_pend), _DEAD, dtype=torch.float32, device=dev)
        self.ps[:, :self.kc] = torch.where(in_frame[:, None], cs, _DEAD)
        self.pnode = torch.zeros((b, c_pend), dtype=torch.long, device=dev)
        self.pnode[:, :self.kc] = torch.arange(self.kc, device=dev)
        self.ptok = torch.full((b, c_pend), -1, dtype=torch.int32, device=dev)
        self.ks = torch.full((b, self.p_max + 1), _DEAD, dtype=torch.float32, device=dev)
        self.knode = torch.zeros((b, self.p_max + 1), dtype=torch.long, device=dev)
        self.pop_i = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.frame_done = ~in_frame
        self.saturated = torch.zeros((b,), dtype=torch.bool, device=dev)

    def pop(self, it):
        """Pop ``it`` of this frame: every active lane pops its best pending
        hypothesis; its node goes to arena slot kc + it."""
        a, bi, kc = self.a, self.bi, self.kc
        active = ~self.frame_done
        sel = self.ps.argmax(dim=1)  # the first max: lax.argmax's tie order
        score = self.ps.gather(1, sel[:, None])[:, 0]
        self.ps.scatter_(1, torch.where(active, sel, self.c_pend - 1)[:, None], _DEAD)
        node = self.pnode.gather(1, sel[:, None])[:, 0]
        tok = self.ptok.gather(1, sel[:, None])[:, 0]
        is_ext = tok >= 0

        ext3 = is_ext[:, None, None]
        pre_h = torch.where(ext3, a["post_h"][bi, node], a["pre_h"][bi, node])  # [B, L, H]
        pre_c = torch.where(ext3, a["post_c"][bi, node], a["pre_c"][bi, node])
        last = torch.where(is_ext, tok, a["last"][bi, node])
        parent_cnt = a["cnt"][bi, node]
        cnt = parent_cnt + is_ext.to(torch.int32)
        dec_out, (post_h, post_c) = predictor_step(
            self.pred_params, last, (pre_h.transpose(0, 1), pre_c.transpose(0, 1)),
            self.rnnt_cfg)

        # the node: the parent's rows with the token appended when it extends
        q = kc + it
        put = is_ext[:, None] & (self.upos == parent_cnt[:, None])
        a["tokens"][:, q] = torch.where(put, tok[:, None], a["tokens"][bi, node])
        a["frames"][:, q] = torch.where(put, self.f, a["frames"][bi, node])
        a["cnt"][:, q] = cnt
        a["last"][:, q] = last
        a["pre_h"][:, q] = pre_h
        a["pre_c"][:, q] = pre_c
        a["post_h"][:, q] = post_h.transpose(0, 1)
        a["post_c"][:, q] = post_c.transpose(0, 1)

        logits = joint_step_from_enc_proj(self.joint_params, self.enc_row, dec_out,
                                          self.rnnt_cfg)
        lp_blank, top_lp, top_tok = self.topm(logits, self.beam_k, self.rnnt_cfg.blank_id)

        # kept: the blank extension (done lanes write _DEAD: theirs is frozen)
        self.ks[:, it] = torch.where(active, score + lp_blank, _DEAD)
        self.knode[:, it] = q
        # pending: the top label extensions
        can_ext = active & (cnt < self.u_buf)
        base = kc + it * self.beam_k
        self.ps[:, base:base + self.beam_k] = torch.where(can_ext[:, None],
                                                          score[:, None] + top_lp, _DEAD)
        self.pnode[:, base:base + self.beam_k] = q
        self.ptok[:, base:base + self.beam_k] = top_tok
        self.pop_i += active.to(torch.int32)

        # ESPnet's termination test
        n_above = (self.ks > self.ps.amax(dim=1)[:, None]).sum(dim=1)
        hit_cap = self.pop_i >= self.p_max
        self.frame_done |= active & ((n_above >= self.k) | hit_cap)
        self.saturated |= active & hit_cap & (n_above < self.k)

    def run(self, waits):
        """Issue pops until every lane's frame is done (see the module notes
        on host syncs); returns the pops issued. ``waits`` counts the times
        the host waited for a flag that had not landed."""
        it = 0
        for _ in range(min(self.k, self.p_max)):
            self.pop(it)
            it += 1
        if self.ps.device.type != "cuda":
            while it < self.p_max and not bool(self.frame_done.all()):
                self.pop(it)
                it += 1
            return it
        flags = torch.empty((self.p_max + 1,), dtype=torch.bool, pin_memory=True)
        in_flight = collections.deque()

        def post(i):
            flags[i].copy_(self.frame_done.all(), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            in_flight.append((i, event))

        post(it)
        while it < self.p_max:
            done = False
            while in_flight and (len(in_flight) > _MAX_LAG or in_flight[0][1].query()):
                i, event = in_flight.popleft()
                if not event.query():
                    waits[0] += 1
                    event.synchronize()
                if bool(flags[i]):
                    done = True
                    break
            if done:
                break
            self.pop(it)
            it += 1
            post(it)
        return it


def _decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg, cfg):
    _check_supported(rnnt_cfg, cfg)
    b, t, _ = enc.shape
    dev = enc.device
    lane_len = enc_lengths.to(device=dev, dtype=torch.int32)
    dims = _dims(rnnt_cfg, cfg, t)
    k, _, _, kc, u_buf, n_nodes, _ = dims
    layers, hid = rnnt_cfg.pred_rnn_layers, rnnt_cfg.pred_hidden
    enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
    topm = topm_logsoftmax if cfg.topk_impl == "pallas" else topm_logsoftmax_plain

    i32 = dict(dtype=torch.int32, device=dev)
    state = dict(dtype=torch.float32, device=dev)
    arenas = {
        "tokens": torch.zeros((b, n_nodes, u_buf), **i32),
        "frames": torch.zeros((b, n_nodes, u_buf), **i32),
        "cnt": torch.zeros((b, n_nodes), **i32),
        "last": torch.full((b, n_nodes), rnnt_cfg.blank_id, **i32),
        "pre_h": torch.zeros((b, n_nodes, layers, hid), **state),
        "pre_c": torch.zeros((b, n_nodes, layers, hid), **state),
        "post_h": torch.zeros((b, n_nodes, layers, hid), **state),
        "post_c": torch.zeros((b, n_nodes, layers, hid), **state),
    }
    survivors = ("tokens", "frames", "cnt", "last", "pre_h", "pre_c")
    cs = torch.full((b, kc), _DEAD, **state)
    cs[:, 0] = 0.0
    saturated = torch.zeros((b,), dtype=torch.bool, device=dev)
    pmax = torch.zeros((b,), **i32)
    ptot = torch.zeros((b,), **i32)
    bi = torch.arange(b, device=dev)[:, None]
    slot = torch.arange(kc, device=dev)[None, :]
    n_frames = min(t, int(lane_len.max())) if b else 0  # the call's one read of the lengths
    host = {"frames": n_frames, "pops_issued": 0, "waits": 0}
    waits = [0]

    for f in range(n_frames):
        in_frame = f < lane_len  # [B]
        frame = _Frame(arenas, cs, in_frame, enc_proj[:, f], f, pred_params, joint_params,
                       rnnt_cfg, topm, dims)
        host["pops_issued"] += frame.run(waits)
        saturated |= frame.saturated

        # compact the survivors into node slots 0..kc-1 (once per frame)
        above = frame.ks > frame.ps.amax(dim=1)[:, None]
        thr_ok = above.sum(dim=1) >= k  # termination, not the pop cap
        masked = torch.where(thr_ok[:, None], torch.where(above, frame.ks, _DEAD), frame.ks)
        # a stable descending sort keeps ties in index order (lax.top_k's)
        vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :kc], idx[:, :kc]
        valid = (vals > _ALIVE) & (thr_ok[:, None] | (slot < k))
        src = frame.knode.gather(1, idx)  # [B, KC] node slots, all >= kc
        keep = in_frame[:, None]
        for name in survivors:
            x = arenas[name]
            rows = x[bi, src]
            sel = keep.reshape(keep.shape + (1,) * (rows.dim() - 2))
            x[:, :kc] = torch.where(sel, rows, x[:, :kc])
        cs = torch.where(keep, torch.where(valid, vals, _DEAD), cs)
        pmax = torch.maximum(pmax, frame.pop_i)
        ptot = ptot + frame.pop_i
    host["waits"] = waits[0]

    # ESPnet sort_nbest over the survivors
    counts_kc = arenas["cnt"][:, :kc]
    key = cs
    if cfg.score_norm:
        key = torch.where(cs > _ALIVE, cs / (counts_kc.to(torch.float32) + 1.0), _DEAD)
    best = key.argmax(dim=1)
    rows = torch.arange(b, device=dev)
    tokens = arenas["tokens"][rows, best]
    frames = arenas["frames"][rows, best]
    counts = torch.where(lane_len <= 0, 0, counts_kc[rows, best])
    scores = cs[rows, best]
    return (tokens, frames, counts, scores, saturated), (pmax, ptot, host)


def graves_beam_decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                       cfg: GravesBeamConfig = GravesBeamConfig()):
    """ESPnet default beam search over a batch.

    Args:
      enc: [B, T, E] fp32; enc_lengths: [B] int

    Returns (tokens [B, U] int32, frames [B, U] int32, counts [B] int32,
    scores [B] fp32 raw, saturated [B] bool: True if a frame hit
    ``max_pops_per_frame`` before ESPnet's termination test).
    """
    return _decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg, cfg)[0]


def graves_beam_decode_stats(pred_params, joint_params, enc, enc_lengths, rnnt_cfg: RNNTConfig,
                             cfg: GravesBeamConfig = GravesBeamConfig()):
    """:func:`graves_beam_decode` plus the pop telemetry: ``(pmax [B], ptot
    [B], host)``, the most pops a lane needed in one frame, each lane's
    total, and the host's counters {frames, pops_issued, waits}."""
    out, (pmax, ptot, host) = _decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg,
                                      cfg)
    return out + (pmax, ptot, host)
