"""Plain transducer prediction and joint networks, the served alignment's
log-probabilities, and ALSD beam search, in fp32 (products via ``Numerics``).

The prediction network is NeMo's: blank is the last class (id
``vocab_size``) and embeds, as start-of-sequence, to zeros; one LSTM layer,
gates (i, f, g, o). The joint is ``W_out · act(W_enc·enc + W_pred·pred)``.
"""

import torch

__all__ = ["Transducer"]


class Transducer:
    def __init__(self, params, cfg, nm):
        if cfg["predictor_kind"] != "lstm" or cfg["pred_rnn_layers"] != 1:
            raise ValueError("the reference has one LSTM layer as its prediction network")
        self.pred, self.joint, self.cfg, self.nm = params["predictor"], params["joint"], cfg, nm
        self.blank = cfg["vocab_size"]
        self.num_classes = cfg["vocab_size"] + 1

    # -- prediction network ---------------------------------------------------

    def _embed(self, tokens):
        table = self.pred["embed"]["table"]
        emb = table[torch.clamp(tokens, max=self.cfg["vocab_size"] - 1)]
        return torch.where((tokens >= self.cfg["vocab_size"])[..., None], 0.0, emb)

    def zero_state(self, rows, device):
        h = torch.zeros(rows, self.cfg["pred_hidden"], device=device)
        return (h, h.clone())

    def step(self, tokens, state):
        """tokens [R] -> (output [R, H], state)."""
        nm = self.nm
        (lstm,) = self.pred["lstm"]
        h, c = state
        gates = (nm.q(self._embed(tokens)) @ nm.q(lstm["w_ih"]) + nm.q(h) @ nm.q(lstm["w_hh"])
                 + lstm["b_ih"] + lstm["b_hh"])
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def sequence(self, tokens):
        """[U] label ids -> [U+1, H]: the output after start-of-sequence and
        after each label."""
        state = self.zero_state(1, tokens.device)
        tok = torch.full((1,), self.blank, dtype=torch.long, device=tokens.device)
        outs = []
        for u in range(tokens.shape[0] + 1):
            g, state = self.step(tok, state)
            outs.append(g[0])
            if u < tokens.shape[0]:
                tok = tokens[u:u + 1]
        return torch.stack(outs)

    # -- joint --------------------------------------------------------------

    def enc_proj(self, enc):
        return self.nm.dense(self.joint["enc"], enc)

    def log_probs(self, enc_rows, pred_rows):
        """enc_proj rows [R, J], prediction rows [R, H] -> [R, classes]."""
        z = enc_rows + self.nm.dense(self.joint["pred"], pred_rows)
        act = {"relu": torch.relu, "tanh": torch.tanh}[self.cfg["joint_activation"]](z)
        return torch.log_softmax(self.nm.dense(self.joint["out"], act), dim=-1)

    # -- the served alignment -------------------------------------------------

    def alignment(self, enc_proj, n_frames, tokens, frames, blanks=None):
        """The alignment a transducer search took: every label at (its
        frame, its index), and a blank at (frame, labels emitted up to it)
        for each of the first ``blanks`` frames (default all): the frames
        the hypothesis moved past. Returns (log-probs [P, classes] of the
        points, symbols [P])."""
        dev = enc_proj.device
        u = len(tokens)
        blanks = n_frames if blanks is None else blanks
        tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        fr = torch.as_tensor(frames, dtype=torch.long, device=dev)
        per_frame = torch.bincount(fr, minlength=blanks)[:blanks]
        upto = torch.cumsum(per_frame, 0)  # labels emitted at frames <= t
        t_idx = torch.cat([fr, torch.arange(blanks, device=dev)])
        u_idx = torch.cat([torch.arange(u, device=dev), upto])
        sym = torch.cat([tok, torch.full((blanks,), self.blank, device=dev)])
        g = self.sequence(tok)
        return self.log_probs(enc_proj[t_idx], g[u_idx]), sym

    # -- ALSD beam search (NeMo's alignment-length synchronous decoding) ----

    def _stack_states(self, states):
        return tuple(torch.stack(part) for part in zip(*states))

    def _unstack_state(self, state, i):
        return tuple(part[i] for part in state)

    def alsd(self, enc_proj, n_frames, beam, max_target_len=1.0):
        """One utterance: enc_proj [T, J], n_frames valid frames.

        Each round every live hypothesis proposes its blank (one frame on)
        and its ``beam`` best labels; a hypothesis at the last frame also
        offers its blank extension as a final, and the best final by score
        / (labels + 1) is kept (first of equals); the best ``beam``
        proposals survive (ties to the lower proposal index, proposals
        ordered by slot, blank first); a blank past the last frame leaves
        the beam; hypotheses with equal labels merge by log-sum-exp into
        the earliest slot and the later ones keep their own score; the
        budget is ``n + floor(max_target_len·n)`` rounds. Returns the best
        final, else the best live hypothesis, as (tokens, frames)."""
        k, m = beam, min(beam, self.num_classes - 1)
        dev = enc_proj.device
        g0, st0 = self.step(torch.full((1,), self.blank, dtype=torch.long, device=dev),
                            self.zero_state(1, dev))
        # (tokens, frames, frame, score, prediction output, predictor state)
        hyps = [([], [], 0, 0.0, g0[0], self._unstack_state(st0, 0))]
        best = None  # (key, tokens, frames)
        for _ in range(n_frames + int(max_target_len * n_frames)):
            if not hyps:
                break
            lp = self.log_probs(enc_proj[[h[2] for h in hyps]],
                                torch.stack([h[4] for h in hyps]))
            lp_blank = lp[:, self.blank].double().cpu().tolist()
            labels = lp.clone()
            labels[:, self.blank] = float("-inf")
            top = torch.topk(labels, m, dim=-1)
            top_lp, top_tok = top.values.double().cpu().tolist(), top.indices.cpu().tolist()
            fin = [((h[3] + lp_blank[i]) / (len(h[0]) + 1), i)
                   for i, h in enumerate(hyps) if h[2] == n_frames - 1]
            if fin:
                key, i = max(fin, key=lambda f: (f[0], -f[1]))
                if best is None or key > best[0]:
                    best = (key, hyps[i][0], hyps[i][1])
            props = []
            for i, h in enumerate(hyps):
                props.append((h[3] + lp_blank[i], i, None))
                props += [(h[3] + top_lp[i][j], i, top_tok[i][j]) for j in range(m)]
            chosen = sorted(range(len(props)), key=lambda x: (-props[x][0], x))[:k]
            emit = [x for x in chosen if props[x][2] is not None]
            if emit:
                toks = torch.tensor([props[x][2] for x in emit], dtype=torch.long, device=dev)
                g, st = self.step(toks, self._stack_states([hyps[props[x][1]][5] for x in emit]))
                stepped = {x: (g[j], self._unstack_state(st, j)) for j, x in enumerate(emit)}
            new = []
            for x in chosen:
                score, i, label = props[x]
                toks, frs, t, _, g, st = hyps[i]
                if label is None:
                    if t + 1 < n_frames:
                        new.append((toks, frs, t + 1, score, g, st))
                else:
                    new.append((toks + [label], frs + [t], t, score) + stepped[x])
            merged = []
            for j, h in enumerate(new):
                lead = next(i for i, h2 in enumerate(new) if h2[0] == h[0])
                if lead == j:
                    s = torch.tensor([h2[3] for h2 in new if h2[0] == h[0]], dtype=torch.float64)
                    h = h[:3] + (float(torch.logsumexp(s, 0)),) + h[4:]
                merged.append(h)
            hyps = merged
        if best is not None:
            return best[1], best[2]
        live = max(hyps, key=lambda h: h[3] / (len(h[0]) + 1))
        return live[0], live[1]
