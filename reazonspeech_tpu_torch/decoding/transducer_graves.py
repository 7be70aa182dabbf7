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
- each lane has its own frame clock ``fidx``: at a frame barrier every
  lane still short of its length pops at its own frame (its encoder row
  gathered there) until the frame is done for all of them, then the
  survivors of those lanes are compacted into node slots 0..KC-1 (idle and
  finished lanes keep theirs);
- the bounds ESPnet does not have keep the shapes static:
  ``max_pops_per_frame`` (default 6·beam+8; a frame that reaches it keeps
  its best ``beam`` kept hypotheses and ``saturated`` reports it),
  ``kept_capacity`` (default beam+12) and ``max_tokens`` (default T).

Output selection matches ESPnet ``sort_nbest``: the best kept hypothesis by
``score / (len + 1)`` when ``score_norm``, raw score otherwise.

Host syncs: a one-shot decode runs ``max(lengths)`` barriers (one read of
the lengths a call). Every frame needs at least ``beam`` pops (the termination
test counts kept hypotheses, one a pop), so those are issued without a
look; after each further pop the frame's done flag is copied to pinned host
memory asynchronously and read once its copy has landed. The host waits on
a flag only when more than ``_MAX_LAG`` flags are in flight (the device is
behind); extra pops issued meanwhile are masked no-ops. No pop reads a
device value on the host (``.item()``). On CPU tensors the flag is read
after each pop.

The per-pop joint tail and the predictor step take ALSD's branches
(``rnnt_beam.joint_tail`` and ``rnnt_beam.lstm_kernel_step``): with
``joint_impl="pallas"`` the joint and the top-m in one op
(``ops/beam_topk.joint_topm``, fp32), else the joint, then the log-softmax
+ blank split + top-m in ``ops/beam_topk.topm_logsoftmax`` when
``topk_impl="pallas"`` or in its plain twin; with ``lstm_impl="pallas"`` and
``pred_hidden % 128 == 0`` each predictor LSTM layer in
``ops/lstm_step.lstm_cell_step`` (fp32; else it is ignored, as in the
reference). The ops launch their kernels on CUDA tensors and run their plain
twins on CPU ones. ``unroll`` is accepted
and changes nothing (the reference's unrolling is exact, and the eager loop
has nothing to unroll).

``multipop`` M > 1 is the reference's speculative round: the top M pending
hypotheses (a stable descending sort, ties to the lower column as
``lax.top_k``) take one predictor step and one joint tail on B·M rows, and
the round accepts exactly the prefix the serial loop would have popped
(a child scores no more than its parent, so the i-th snapshot entry comes
before any child of entries 1..i-1 iff it scores at least their best
child, by a cumulative max) and ESPnet's termination test is evaluated at
each prefix position. The outputs are ``multipop=1``'s; the rounds are
fewer. Node slots advance by the round's largest accepted count, in an
arena of ``max_pops_per_frame · multipop_arena_factor`` pops; a frame that
exhausts it ends for its still-active lanes, which ``saturated`` reports.
The write windows start at a device index, so a round reads nothing on the
host. A frame needs at least ``beam`` pops and a round accepts at most M,
so the first ``ceil(beam / M)`` rounds go out without a look; the lagged
done flags follow, as for the pops.

``graves_state_init`` / ``graves_beam_segment`` / ``graves_finalize`` are
the reference's segmented API (behind ``serving/continuous.py``): the state
carried between segments is the compacted survivor set of each lane
(:class:`GravesBeamState`), a segment runs up to ``n_frames`` barriers, and
lanes flagged in ``reset_mask`` restart from the fresh state without
touching their neighbours. Pops are lane-local, so each lane's result
equals a dedicated :func:`graves_beam_decode` under the same
``max_tokens``; the one-shot decode is itself fresh state, one segment of
``max(lengths)`` frames, then the selection.
"""

import collections
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.rnnt import RNNTConfig, joint_precompute_enc, predictor_step
from .rnnt_beam import joint_tail, lstm_kernel_step

__all__ = ["GravesBeamConfig", "GravesBeamState", "graves_beam_decode", "graves_beam_decode_stats",
           "graves_state_init", "graves_beam_segment", "graves_finalize"]

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
    joint_impl: str = "xla"  # "pallas": the port's joint + top-m kernel
    lstm_impl: str = "xla"  # "pallas": the port's LSTM-cell kernel (pred_hidden % 128 == 0)
    unroll: int = 1  # exact in the reference; the eager loop needs no unrolling
    multipop: int = 1
    multipop_arena_factor: float = 1.5


def _check_supported(rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig):
    if rnnt_cfg.predictor_kind != "lstm":
        raise NotImplementedError("graves beam search: LSTM predictors only")
    if not rnnt_cfg.blank_first:
        raise NotImplementedError("espnet convention: blank id 0")
    for name in ("topk_impl", "joint_impl", "lstm_impl"):
        if getattr(cfg, name) not in ("xla", "pallas"):
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}")


class _Dims(NamedTuple):
    k: int  # beam
    beam_k: int  # label expansions a pop
    p_max: int  # pops a frame
    kc: int  # survivor slots
    u_buf: int  # emission buffer
    m_pop: int  # pops a round (multipop)
    cap_pops: int  # node-arena pop budget a frame
    n_nodes: int  # node-arena slots
    c_pend: int  # pending columns


def _dims(rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig, t) -> _Dims:
    """The reference's static sizes."""
    v = rnnt_cfg.num_classes
    k = min(cfg.beam_size, v)
    beam_k = min(k, v - 1)
    p_max = cfg.max_pops_per_frame or (6 * k + 8)
    kc = cfg.kept_capacity or (k + 12)
    u_buf = cfg.max_tokens or t
    m_pop = max(1, min(cfg.multipop, p_max))
    if m_pop > 1:
        # slots advance by each round's largest accepted count; the budget
        # past p_max absorbs skew across lanes, the last m_pop rows are an
        # overflow scratch window nothing references
        cap_pops = max(p_max, int(p_max * cfg.multipop_arena_factor + 0.5))
        n_nodes = kc + cap_pops + 2 * m_pop
        c_pend = kc + (cap_pops + 2 * m_pop) * beam_k
    else:
        cap_pops = p_max
        n_nodes = kc + p_max + 1  # +1 scratch row
        c_pend = kc + p_max * beam_k + beam_k  # + scratch block
    return _Dims(k, beam_k, p_max, kc, u_buf, m_pop, cap_pops, n_nodes, c_pend)


class _Frame:
    """One frame's pop state machine over the batch (the reference's
    ``pop_body``), on the node arenas of the whole decode."""

    def __init__(self, arenas, cs, in_frame, enc_row, f, pred_step, joint_step, dims):
        self.a, self.d = arenas, dims
        self.k, self.beam_k, self.p_max, self.kc, self.u_buf = dims[:5]
        self.pred_step, self.joint_step = pred_step, joint_step
        self.enc_row, self.f = enc_row, f
        b, dev = cs.shape[0], cs.device
        self.c_pend = c_pend = dims.c_pend
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
        self.nbase = torch.full((), self.kc, dtype=torch.long, device=dev)  # a round's first slot

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
        dec_out, post_h, post_c = self.pred_step(last, pre_h, pre_c)

        # the node: the parent's rows with the token appended when it extends
        q = kc + it
        put = is_ext[:, None] & (self.upos == parent_cnt[:, None])
        a["tokens"][:, q] = torch.where(put, tok[:, None], a["tokens"][bi, node])
        a["frames"][:, q] = torch.where(put, self.f, a["frames"][bi, node])
        a["cnt"][:, q] = cnt
        a["last"][:, q] = last
        a["pre_h"][:, q] = pre_h
        a["pre_c"][:, q] = pre_c
        a["post_h"][:, q] = post_h
        a["post_c"][:, q] = post_c

        lp_blank, top_lp, top_tok = self.joint_step(self.enc_row, dec_out)

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

    def round(self, it):
        """One multipop round (the reference's ``round_body``): every active
        lane expands its top ``m_pop`` pending hypotheses at once and accepts
        the prefix the serial pops would have taken; their nodes go to arena
        slots ``nbase``.. (the overflow window once the budget is spent), not
        to ``it``'s, which only a pop uses."""
        a, bi, kc, m = self.a, self.bi, self.kc, self.d.m_pop
        beam_k, p_max = self.beam_k, self.p_max
        b, dev = self.ps.shape[0], self.ps.device
        layers, hid = a["pre_h"].shape[2:]
        mi = torch.arange(m, device=dev)
        active = ~self.frame_done
        # overflow: no write window left; the round accepts nothing, its
        # writes land in the tail window and the active lanes end saturated
        ovf = self.nbase + m > kc + self.d.cap_pops + m
        nbase = torch.where(ovf, kc + self.d.cap_pops + m, self.nbase)

        # the top-M pending snapshot, in the serial argmax order, ties included
        vals, idx = torch.sort(self.ps, dim=1, descending=True, stable=True)
        s, idxm, p_rest = vals[:, :m], idx[:, :m], vals[:, m]
        node = self.pnode.gather(1, idxm)  # [B, M]
        tok = self.ptok.gather(1, idxm)
        is_ext = tok >= 0

        def prow(name):
            return a[name][bi[:, None], node]

        ext4 = is_ext[:, :, None, None]
        pre_h = torch.where(ext4, prow("post_h"), prow("pre_h"))  # [B, M, L, H]
        pre_c = torch.where(ext4, prow("post_c"), prow("pre_c"))
        last = torch.where(is_ext, tok, prow("last"))
        cnt_parent = prow("cnt")
        cnt = cnt_parent + is_ext.to(torch.int32)

        bm = b * m
        dec_out, post_h, post_c = self.pred_step(last.reshape(bm), pre_h.reshape(bm, layers, hid),
                                                 pre_c.reshape(bm, layers, hid))
        enc_rows = self.enc_row[:, None, :].expand(b, m, self.enc_row.shape[-1]).reshape(bm, -1)
        lp_blank, top_lp, top_tok = self.joint_step(enc_rows, dec_out)
        lp_blank = lp_blank.reshape(b, m)
        top_lp, top_tok = top_lp.reshape(b, m, beam_k), top_tok.reshape(b, m, beam_k)

        # the serial order: entry i is popped before any child of entries
        # 0..i-1 iff it scores at least their best child
        kb = s + lp_blank  # each pop's kept (blank extension) score
        can_ext = cnt < self.u_buf
        inc_cmax = torch.where(can_ext, s + top_lp[:, :, 0], _DEAD).cummax(dim=1).values
        exc_cmax = torch.cat([torch.full((b, 1), -torch.inf, device=dev), inc_cmax[:, :-1]],
                             dim=1)
        vpfx = (s >= exc_cmax).to(torch.int32).cumprod(dim=1).bool()
        # the best pending after pop i (the children of pops 0..i included)
        m_after = torch.maximum(torch.cat([s[:, 1:], p_rest[:, None]], dim=1), inc_cmax)
        n_old = (self.ks[:, None, :] > m_after[:, :, None]).sum(dim=2)
        tri = torch.ones((m, m), dtype=torch.bool, device=dev).tril()  # [i, j]: j <= i
        n_new = ((kb[:, None, :] > m_after[:, :, None]) & tri).sum(dim=2)
        term = (n_old + n_new) >= self.k
        cap = (self.pop_i[:, None] + 1 + mi) >= p_max
        done_eff = vpfx & (term | cap)
        any_done = done_eff.any(dim=1)
        first = torch.where(done_eff, mi, m).amin(dim=1).clamp(max=m - 1)  # the first done
        a_cnt = torch.where(any_done, first + 1, vpfx.sum(dim=1))
        a_cnt = torch.where(active & ~ovf, a_cnt, 0).to(torch.int32)
        acc = mi < a_cnt[:, None]  # [B, M]
        sat_i = (cap & ~term).gather(1, first[:, None])[:, 0]
        self.saturated |= active & ((~ovf & any_done & sat_i) | ovf)
        self.frame_done |= active & (ovf | any_done)

        # the accepted pops leave the pending set
        self.ps.scatter_(1, idxm, torch.where(acc, _DEAD, s))
        # kept: the accepted pops' blank extensions at columns pop_i + j
        cols = torch.arange(p_max + 1, device=dev)
        hit = (cols == (self.pop_i[:, None] + mi)[:, :, None]) & acc[:, :, None]  # [B, M, P+1]
        hit_any = hit.any(dim=1)
        q = nbase + mi  # the round's node slots
        self.ks = torch.where(hit_any, torch.where(hit, kb[:, :, None], 0.0).sum(dim=1), self.ks)
        self.knode = torch.where(hit_any, torch.where(hit, q[:, None], 0).sum(dim=1),
                                 self.knode)
        # pending: the accepted pops' label extensions at lane-uniform columns
        # (an unaccepted pop's block is dead and past every accepted region)
        cols = kc + (nbase - kc) * beam_k + torch.arange(m * beam_k, device=dev)
        child_s = torch.where((acc & can_ext)[:, :, None], s[:, :, None] + top_lp, _DEAD)
        self.ps.index_copy_(1, cols, child_s.reshape(b, -1))
        self.pnode.index_copy_(1, cols, q.repeat_interleave(beam_k).expand(b, -1))
        self.ptok.index_copy_(1, cols, top_tok.reshape(b, -1))

        # the node arena: one [B, M] window a tensor
        put = is_ext[:, :, None] & (self.upos[None] == cnt_parent[:, :, None])
        rows = {"tokens": torch.where(put, tok[:, :, None], prow("tokens")),
                "frames": torch.where(put, self.f[:, :, None], prow("frames")),
                "cnt": cnt, "last": last, "pre_h": pre_h, "pre_c": pre_c,
                "post_h": post_h.reshape(b, m, layers, hid),
                "post_c": post_c.reshape(b, m, layers, hid)}
        for name, blk in rows.items():
            a[name].index_copy_(1, q, blk)
        self.pop_i += a_cnt
        self.nbase = torch.where(ovf, self.nbase, self.nbase + a_cnt.max())

    def run(self, waits):
        """Issue pops (rounds where ``multipop`` > 1) until every lane's
        frame is done (see the module notes on host syncs); returns the
        iterations issued. ``waits`` counts the times the host waited for a
        flag that had not landed."""
        m = self.d.m_pop
        step = self.pop if m == 1 else self.round
        it = 0
        for _ in range(min(-(-self.k // m), self.p_max)):
            step(it)
            it += 1
        if self.ps.device.type != "cuda":
            while it < self.p_max and not bool(self.frame_done.all()):
                step(it)
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
            step(it)
            it += 1
            post(it)
        return it


def _make_pred_step(pred_params, rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig):
    """One predictor step on [B] tokens with the arena's state layout
    [B, L, H]: (dec_out [B, H] fp32, post_h, post_c [B, L, H]); through the
    LSTM cell kernel where ``rnnt_beam.lstm_kernel_step`` applies."""
    fused = lstm_kernel_step(pred_params, rnnt_cfg, cfg.lstm_impl)
    if fused is None:
        def pred_step(tokens, pre_h, pre_c):
            dec_out, (post_h, post_c) = predictor_step(
                pred_params, tokens, (pre_h.transpose(0, 1), pre_c.transpose(0, 1)), rnnt_cfg)
            return dec_out, post_h.transpose(0, 1), post_c.transpose(0, 1)

        return pred_step

    def pred_step(tokens, pre_h, pre_c):
        dec_out, hs, cs = fused(tokens, pre_h.unbind(1), pre_c.unbind(1))
        return dec_out, torch.stack(hs, dim=1), torch.stack(cs, dim=1)

    return pred_step


class GravesBeamState(NamedTuple):
    """Cross-segment survivor state, one row per lane: the kept hypotheses
    compacted into node slots 0..KC-1 at the lane's last frame boundary."""

    fidx: torch.Tensor  # [B] int32 next encoder frame (frames consumed)
    saturated: torch.Tensor  # [B] bool
    cs: torch.Tensor  # [B, KC] fp32 survivor scores (_DEAD = empty slot)
    st: torch.Tensor  # [B, KC, U] int32 tokens
    sf: torch.Tensor  # [B, KC, U] int32 emission frames
    sc: torch.Tensor  # [B, KC] int32 token counts
    slast: torch.Tensor  # [B, KC] int32 last token (blank at the start)
    sph: torch.Tensor  # [B, KC, L, H] fp32 pre-step LSTM h
    spc: torch.Tensor  # [B, KC, L, H] fp32 pre-step LSTM c
    pmax: torch.Tensor  # [B] int32 most pops in one frame so far
    ptot: torch.Tensor  # [B] int32 pops over all frames


# arena name of each survivor field, in GravesBeamState order
_SURVIVORS = (("st", "tokens"), ("sf", "frames"), ("sc", "cnt"), ("slast", "last"),
              ("sph", "pre_h"), ("spc", "pre_c"))


def _fresh_state(b, rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig, u_buf, device):
    kc = _dims(rnnt_cfg, cfg, u_buf).kc
    layers, hid = rnnt_cfg.pred_rnn_layers, rnnt_cfg.pred_hidden
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    cs = torch.full((b, kc), _DEAD, **f32)
    cs[:, 0] = 0.0
    return GravesBeamState(
        fidx=torch.zeros((b,), **i32), saturated=torch.zeros((b,), dtype=torch.bool, device=device),
        cs=cs, st=torch.zeros((b, kc, u_buf), **i32), sf=torch.zeros((b, kc, u_buf), **i32),
        sc=torch.zeros((b, kc), **i32), slast=torch.full((b, kc), rnnt_cfg.blank_id, **i32),
        sph=torch.zeros((b, kc, layers, hid), **f32), spc=torch.zeros((b, kc, layers, hid), **f32),
        pmax=torch.zeros((b,), **i32), ptot=torch.zeros((b,), **i32))


def _apply_reset(state: GravesBeamState, reset, rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig):
    """Lanes flagged in ``reset`` [B] take the fresh state (a new request
    joins); the others keep theirs."""
    fresh = _fresh_state(state.cs.shape[0], rnnt_cfg, cfg, state.st.shape[-1], state.cs.device)
    return GravesBeamState(*(
        torch.where(reset.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)
        for new, old in zip(fresh, state)))


def _run_frames(pred_params, joint_params, enc_proj, lane_len, state: GravesBeamState,
                rnnt_cfg, cfg, n_frames, host):
    """Advance every lane by up to ``n_frames`` frames of its own utterance,
    one frame barrier each: every lane still short of its ``lane_len`` pops
    at its own frame ``fidx`` (its encoder row gathered there) until the
    frame is done for all of them, then its survivors are compacted into
    node slots 0..KC-1; idle and finished lanes are masked and keep their
    survivors. ``host`` counts the barriers run, the pops issued and the
    host's waits on a done flag."""
    b, t_buf, _ = enc_proj.shape
    dev = enc_proj.device
    dims = _dims(rnnt_cfg, cfg, state.st.shape[-1])
    k, beam_k, kc, u_buf, n_nodes = dims.k, dims.beam_k, dims.kc, dims.u_buf, dims.n_nodes
    layers, hid = rnnt_cfg.pred_rnn_layers, rnnt_cfg.pred_hidden
    pred_step = _make_pred_step(pred_params, rnnt_cfg, cfg)
    joint_step = joint_tail(joint_params, rnnt_cfg, cfg, beam_k)

    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    arenas = {
        "tokens": torch.zeros((b, n_nodes, u_buf), **i32),
        "frames": torch.zeros((b, n_nodes, u_buf), **i32),
        "cnt": torch.zeros((b, n_nodes), **i32),
        "last": torch.full((b, n_nodes), rnnt_cfg.blank_id, **i32),
        "pre_h": torch.zeros((b, n_nodes, layers, hid), **f32),
        "pre_c": torch.zeros((b, n_nodes, layers, hid), **f32),
        "post_h": torch.zeros((b, n_nodes, layers, hid), **f32),
        "post_c": torch.zeros((b, n_nodes, layers, hid), **f32),
    }
    for field, name in _SURVIVORS:
        arenas[name][:, :kc] = getattr(state, field)
    fidx, cs, saturated = state.fidx, state.cs, state.saturated
    pmax, ptot = state.pmax, state.ptot
    bi = torch.arange(b, device=dev)
    slot = torch.arange(kc, device=dev)[None, :]
    waits = [0]

    for _ in range(n_frames):
        in_frame = fidx < lane_len  # [B]
        enc_row = enc_proj[bi, torch.clamp(fidx, max=t_buf - 1)]  # [B, J], each lane's frame
        frame = _Frame(arenas, cs, in_frame, enc_row, fidx[:, None], pred_step, joint_step, dims)
        host["pops_issued"] += frame.run(waits)
        host["frames"] += 1
        saturated = saturated | frame.saturated

        # compact the survivors of the lanes in frame into node slots 0..kc-1
        above = frame.ks > frame.ps.amax(dim=1)[:, None]
        thr_ok = above.sum(dim=1) >= k  # termination, not the pop cap
        masked = torch.where(thr_ok[:, None], torch.where(above, frame.ks, _DEAD), frame.ks)
        # a stable descending sort keeps ties in index order (lax.top_k's)
        vals, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        vals, idx = vals[:, :kc], idx[:, :kc]
        valid = (vals > _ALIVE) & (thr_ok[:, None] | (slot < k))
        src = frame.knode.gather(1, idx)  # [B, KC] node slots, all >= kc
        keep = in_frame[:, None]
        for _, name in _SURVIVORS:
            x = arenas[name]
            rows = x[bi[:, None], src]
            sel = keep.reshape(keep.shape + (1,) * (rows.dim() - 2))
            x[:, :kc] = torch.where(sel, rows, x[:, :kc])
        cs = torch.where(keep, torch.where(valid, vals, _DEAD), cs)
        pmax = torch.maximum(pmax, frame.pop_i)
        ptot = ptot + frame.pop_i
        fidx = fidx + in_frame.to(torch.int32)
    host["waits"] += waits[0]
    return GravesBeamState(fidx, saturated, cs,
                           *(arenas[name][:, :kc].clone() for _, name in _SURVIVORS),
                           pmax, ptot)


def _select_best(state: GravesBeamState, lane_len, cfg: GravesBeamConfig):
    """ESPnet ``sort_nbest`` over the survivors: (tokens, frames, counts,
    scores, saturated); lanes of length 0 count 0."""
    key = state.cs
    if cfg.score_norm:
        key = torch.where(state.cs > _ALIVE, state.cs / (state.sc.to(torch.float32) + 1.0), _DEAD)
    best = key.argmax(dim=1)
    rows = torch.arange(best.shape[0], device=best.device)
    counts = torch.where(lane_len <= 0, 0, state.sc[rows, best])
    return (state.st[rows, best], state.sf[rows, best], counts, state.cs[rows, best],
            state.saturated)


def _decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg, cfg):
    _check_supported(rnnt_cfg, cfg)
    b, t, _ = enc.shape
    lane_len = enc_lengths.to(device=enc.device, dtype=torch.int32)
    enc_proj = joint_precompute_enc(joint_params, enc, rnnt_cfg)  # [B, T, J]
    state = _fresh_state(b, rnnt_cfg, cfg, cfg.max_tokens or t, enc.device)
    n_frames = min(t, int(lane_len.max())) if b else 0  # the call's one read of the lengths
    host = {"frames": 0, "pops_issued": 0, "waits": 0}
    state = _run_frames(pred_params, joint_params, enc_proj, lane_len, state, rnnt_cfg, cfg,
                        n_frames, host)
    return _select_best(state, lane_len, cfg), (state.pmax, state.ptot, host)


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
    total, and the host's counters {frames, pops_issued, waits}
    (``pops_issued``: the pops, or with ``multipop`` > 1 the rounds, the
    host issued)."""
    out, (pmax, ptot, host) = _decode(pred_params, joint_params, enc, enc_lengths, rnnt_cfg,
                                      cfg)
    return out + (pmax, ptot, host)


# --- resumable per-lane segments (continuous batching) -----------------------


def graves_state_init(b, rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig,
                      device) -> GravesBeamState:
    """Fresh survivor state for ``b`` lanes on ``device``, that of the ring
    the segments read (``cfg.max_tokens`` must be set: a segment cannot
    default the emission buffer to T)."""
    _check_supported(rnnt_cfg, cfg)
    if cfg.max_tokens <= 0:
        raise ValueError("graves_state_init: cfg.max_tokens must be set for segmented decode "
                         "(the emission buffer cannot default to T)")
    return _fresh_state(b, rnnt_cfg, cfg, cfg.max_tokens, torch.device(device))


def graves_beam_segment(pred_params, joint_params, enc_ring, lane_len, reset_mask,
                        state: GravesBeamState, rnnt_cfg: RNNTConfig, cfg: GravesBeamConfig,
                        n_frames: int, frames_left=None) -> GravesBeamState:
    """Advance every lane by up to ``n_frames`` frames of its own utterance.

    Args:
      enc_ring: [B, T_buf, J] per-lane joint encoder projections (each
        lane's utterance at rows 0..len-1)
      lane_len: [B] int32 valid frames per lane (0 = idle)
      reset_mask: [B] bool, lanes re-initialised before stepping
      frames_left: the most frames any lane has left, where the caller
        mirrors the lanes' clocks on the host; the segment then runs
        ``min(n_frames, frames_left)`` barriers (the rest would change
        nothing), else ``n_frames``

    Returns the updated state; a lane is finished once ``fidx >= lane_len``.
    """
    _check_supported(rnnt_cfg, cfg)
    lane_len = lane_len.to(torch.int32)
    state = _apply_reset(state, reset_mask, rnnt_cfg, cfg)
    if frames_left is not None:
        n_frames = min(n_frames, int(frames_left))
    return _run_frames(pred_params, joint_params, enc_ring, lane_len, state, rnnt_cfg, cfg,
                       n_frames, {"frames": 0, "pops_issued": 0, "waits": 0})


def graves_finalize(state: GravesBeamState, lane_len, rnnt_cfg: RNNTConfig,
                    cfg: GravesBeamConfig):
    """(tokens [B, U], frames [B, U], counts [B], scores [B], saturated [B])
    of each lane's best survivor."""
    return _select_best(state, lane_len, cfg)
