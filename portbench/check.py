"""How ``correct`` is decided: the program's encoder output and its served
tokens against the plain reference.

For a sample of the utterances a run served, the reference (fp32, TF32
off, ``reference/``) recomputes the features and the encoder, and reads
two numbers, each held to the cell's limit in ``checks/<cell>.json``:

- ``enc_rel_l2``: the program's encoder output, captured on the timed path
  for the sampled rows of every call, projected by the joint's encoder
  layer (in fp32), against the reference's projection over the valid
  frames: the widest relative L2 distance over the sample. It holds the
  frontend and the encoder; the control (``control.py``, the reference in
  fp8 in the program's place) reads an order of magnitude above a sound
  run on every seed.
- ``token_gap``: the joint's log-probabilities along the alignment the
  program served, each label at (its frame, its index) and a blank at
  (frame, labels so far) for each frame the hypothesis moved past: the
  widest gap by which a served symbol lies below the reference's best at
  its point. It holds the prediction network, the joint and the search: a
  label altered or an answer left out reads the spread of the logits.
"""
import numpy as np
import torch

from .reference.frontend import log_mel
from .reference.numerics import Numerics
from .reference.transducer import Transducer

__all__ = ["alignment_blanks", "enc_rel_l2", "judge", "pad_like_program", "reference_encode",
           "token_gap"]


def pad_like_program(waves, cfg):
    """The program's batch padding: ``pad_seconds`` of silence each side,
    then zeros to a multiple of ``bucket_samples``. -> (buf [B, N], lengths)."""
    pad = int(cfg["pad_seconds"] * 16000)
    lengths = np.asarray([len(w) + 2 * pad for w in waves], np.int64)
    bucket = cfg["bucket_samples"]
    n = max(bucket, -(-int(lengths.max()) // bucket) * bucket)
    buf = np.zeros((len(waves), n), np.float32)
    for i, w in enumerate(waves):
        buf[i, pad:pad + len(w)] = w
    return buf, lengths


def reference_encode(family, cfg, params, waves, device, nm, block=4, raw=False):
    """The reference's joint encoder projections (``raw``: its encoder
    outputs) and valid frames of each wave, computed ``block`` utterances
    at a time. -> list of ([T, J] or [T, D], n)."""
    td = Transducer(params, cfg["rnnt"], nm)
    out = []
    for i in range(0, len(waves), block):
        buf, lengths = pad_like_program(waves[i:i + block], cfg)
        wav = torch.from_numpy(buf).to(device)
        lens = torch.from_numpy(lengths).to(device)
        feats, flens = log_mel(wav, lens, cfg["frontend"])
        with torch.no_grad():
            enc, elens = family.reference_encode(cfg, params, feats, flens, nm)
            proj = enc if raw else td.enc_proj(enc)
        out += [(proj[j], int(elens[j])) for j in range(proj.shape[0])]
    return out


def alignment_blanks(cfg, n, labels):
    """Frames an ALSD hypothesis moved past: all ``n`` for a finished one;
    one with more labels than the budget's floor(ratio·n) never finished
    (all hypotheses of a round share frames + labels) and moved past
    n + floor(ratio·n) - labels."""
    budget = int(cfg["decoding"]["alsd_max_target_len"] * n)
    return n if labels <= budget else n + budget - labels


def enc_rel_l2(cfg, params, encoded, captured):
    """The widest relative L2 distance between the joint's encoder
    projection of the program's captured encoder outputs (``captured``:
    [(enc [T', D], valid frames)], each against its wave in ``encoded``,
    the fp32 reference's ``reference_encode``) and the reference's. A
    differing number of valid frames reads infinity."""
    td = Transducer(params, cfg["rnnt"], Numerics("fp32"))
    worst = 0.0
    with torch.no_grad():
        for (ref, n), (enc, m) in zip(encoded, captured):
            if m != n:
                return float("inf")
            got = td.enc_proj(enc[:n].to(ref.device, torch.float32))
            worst = max(worst, float((got - ref[:n]).norm() / ref[:n].norm()))
    return worst


def token_gap(cfg, params, encoded, served):
    """The widest gap below the reference's best of any symbol of the
    served (tokens, frames) of utterances ``encoded``."""
    td = Transducer(params, cfg["rnnt"], Numerics("fp32"))
    gaps = []
    with torch.no_grad():
        for (proj, n), (toks, frs) in zip(encoded, served):
            lp, sym = td.alignment(proj, n, toks, frs, alignment_blanks(cfg, n, len(toks)))
            gaps.append(lp.max(dim=1).values - lp.gather(1, sym[:, None])[:, 0])
    return float(torch.cat(gaps).max())


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    rows = [(k, numbers.get(k), limits.get(k)) for k in sorted(set(numbers) | set(limits))]
    ok = all(v is not None and lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
