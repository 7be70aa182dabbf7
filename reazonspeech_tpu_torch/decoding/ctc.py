"""CTC utilities: blank-run detection and forced alignment (PyTorch).

Port of ``reazonspeech_tpu.decoding.ctc``:

- :func:`find_blank` and :func:`find_blank_runs` are host numpy scans over
  the CTC probability matrix, copies of the reference's (including the
  quirks of the longest-blank-run scan: runs that start at frame 0 are
  skipped, a trailing run that never closes is dropped, and the sentinel
  (nsamples, nsamples) is returned when nothing qualifies);
- :func:`ctc_viterbi_align` is forced alignment as a Viterbi DP over the
  blank-interleaved CTC state graph: the forward pass is fixed-shape tensor
  ops per frame on the matrix's device (states vectorized; no host sync
  inside it), the backtracking runs on the host over the backpointers;
- :func:`get_timings` gives per-token timings in the reference's units
  (samples, ``index_duration = nsamples / (T + 1)``).
"""

import collections

import numpy as np
import torch

__all__ = ["Blank", "find_blank_runs", "find_blank", "ctc_viterbi_align", "get_timings"]

Blank = collections.namedtuple("Blank", ["start", "end"])

_NEG_INF = -1e30


def find_blank(lpz, nsamples, blank_id=0, threshold=0.98):
    """Find the longest no-speech run in a CTC probability matrix.

    Args:
      lpz: [T, V] softmax probabilities (host numpy, or a tensor)
      nsamples: waveform sample count the matrix describes
    """
    lpz = np.asarray(lpz.cpu() if isinstance(lpz, torch.Tensor) else lpz)
    blanks = [Blank(nsamples, nsamples)]
    start = None
    denom = lpz.shape[0] + 1
    for idx, prob in enumerate(lpz.T[blank_id]):
        if prob > threshold:
            if start is None:
                start = int(idx / denom * nsamples)
        else:
            if start and start > 0:
                end = int(idx / denom * nsamples)
                blanks.append(Blank(start, end))
            start = None
    return max(blanks, key=lambda b: b.end - b.start)


def find_blank_runs(lpz, blank_id=0, threshold=0.98):
    """All (start_frame, end_frame) blank runs (every pause, not just the
    longest)."""
    lpz = np.asarray(lpz.cpu() if isinstance(lpz, torch.Tensor) else lpz)
    mask = lpz.T[blank_id] > threshold
    runs = []
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            runs.append((start, i))
            start = None
    if start is not None:
        runs.append((start, len(mask)))
    return runs


@torch.inference_mode()
def _viterbi_forward(log_probs, states):
    """CTC Viterbi over the blank-interleaved state sequence.

    log_probs: [T, V] fp32 log softmax; states: [S] token id per CTC state
    (blank, c1, blank, c2, ... blank), on one device. Returns (final scores
    [S], backpointers [T-1, S] int32: 0 stay, 1 diagonal, 2 skip).
    """
    t = log_probs.shape[0]
    s = states.shape[0]
    dev = log_probs.device
    state_lp = log_probs[:, states.long()]  # [T, S]

    # allowed skip (s-2 -> s): only onto non-blank states whose token differs
    # from the previous non-blank (standard CTC topology)
    idx = torch.arange(s, device=dev)
    same_label = torch.where(idx >= 2, states == torch.roll(states, 2), True)
    can_skip = (idx % 2 == 1) & (idx >= 2) & ~same_label

    neg = torch.full((2,), _NEG_INF, dtype=torch.float32, device=dev)
    delta = torch.full((s,), _NEG_INF, dtype=torch.float32, device=dev)
    delta[0] = state_lp[0, 0]
    delta[1] = state_lp[0, 1]  # s = 2L+1 >= 3
    bps = torch.empty((max(t - 1, 0), s), dtype=torch.int32, device=dev)
    for ti in range(1, t):
        diag = torch.cat([neg[:1], delta[:-1]])
        skip = torch.where(can_skip, torch.cat([neg, delta[:-2]]), _NEG_INF)
        choices = torch.stack([delta, diag, skip])
        bps[ti - 1] = choices.argmax(dim=0)  # the first max on ties, as jnp.argmax
        delta = choices.amax(dim=0) + state_lp[ti]
    return delta, bps


def ctc_viterbi_align(log_probs, token_ids, blank_id=0):
    """Force-align a token sequence to a CTC log-prob matrix.

    Args:
      log_probs: [T, V] log softmax over tokens (numpy, or a tensor, on
        whose device the forward pass runs)
      token_ids: [L] reference tokens (no blanks)

    Returns:
      frames: [L] int32 numpy, the first frame occupied by each token on the
      Viterbi path (empty if L == 0 or no valid path).
    """
    log_probs = torch.as_tensor(log_probs).to(torch.float32)
    token_ids = np.asarray(token_ids, np.int32)
    n_tok = len(token_ids)
    t = log_probs.shape[0]
    if n_tok == 0 or t < n_tok:
        return np.zeros((0,), np.int32)

    states = np.full(2 * n_tok + 1, blank_id, np.int32)
    states[1::2] = token_ids
    final, bps = _viterbi_forward(log_probs, torch.from_numpy(states).to(log_probs.device))
    final = final.cpu().numpy()
    bps = bps.cpu().numpy()  # [T-1, S]

    s = 2 * n_tok + 1
    cur = s - 1 if final[s - 1] >= final[s - 2] else s - 2
    if max(final[s - 1], final[s - 2]) <= _NEG_INF / 2:
        return np.zeros((0,), np.int32)

    path = np.zeros(t, np.int32)
    path[t - 1] = cur
    for ti in range(t - 2, -1, -1):
        cur = cur - bps[ti, cur]
        path[ti] = cur

    frames = np.zeros(n_tok, np.int32)
    for i in range(n_tok):
        occ = np.nonzero(path == 2 * i + 1)[0]
        frames[i] = occ[0] if len(occ) else (frames[i - 1] if i else 0)
    return frames


def get_timings(lpz_log, token_ids, nsamples, blank_id=0):
    """Per-token sample-offset timings: sample = frame · nsamples / (T + 1)."""
    frames = ctc_viterbi_align(lpz_log, token_ids, blank_id)
    t = lpz_log.shape[0]
    return frames.astype(np.float64) * (nsamples / (t + 1))
