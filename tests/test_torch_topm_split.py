"""The split-and-merge argument under the CUDA top-m kernels, on the CPU.

``csrc/beam_topk.cu`` (``topm_logsoftmax``) and ``csrc/joint_topm.cu``
(``joint_topm``) never sort a row: they split it (threads, warps, row parts;
column tiles), keep each piece's best m candidates under (value desc, column
asc), and merge the pieces' picks, cutting more slots than one warp holds
(512) down a chunk at a time. That is exact because a row's top m lie among
the top m of every piece that holds them. A small numpy model of those
partitions and merges is held here to the JAX kernels run in interpret mode
and to the port's plain twins, at the card tests' edge cases (m = 1, the
served sizes and one past each, the rounds path; integer ties; rows at or
below -1e30; blank first and last; a row that starts off a 16-byte
boundary; bf16 logits; a row over several parts; merges of more than one
chunk). The kernels themselves are held to the twins on the card
(``tests/test_torch_cuda.py``).
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.ops import beam_topk as jtopk
from reazonspeech_tpu_torch.ops.beam_topk import joint_topm_plain, topm_logsoftmax_plain

EXCLUDED = float(np.float32(-1.0e30))  # the kernels compare in fp32
THREADS, PART, ROUNDS_PART = 256, 4096, 8192  # csrc/beam_topk.cu
M_MAX = 40  # csrc/beam_topk.cu: picks from keys up to m = 40, then rounds
CHUNK = 512  # csrc/topm.cuh: slots one warp holds as keys
TILE, JOINT_WARPS, JOINT_LM = 32, 16, 40  # csrc/joint_topm.cu: columns of V a block, its
# warps, the largest m merged over the whole block


def _best(pairs, k):
    """The best k of (value, column) pairs in lax.top_k's order."""
    return sorted(pairs, key=lambda p: (-p[0], p[1]))[:k]


def _share(i, head, tail, elems):
    """The thread that holds column i of a part (beam_topk.cu's Share): a
    scalar head, 16-byte vectors dealt out in turn, a scalar tail."""
    if i < head:
        return i
    if i < tail:
        return (i - head) // elems % THREADS
    return i - tail


def _merge_slots(slots, m):
    """topm.cuh's merge of candidate slots by one warp (None: empty): past
    one chunk and for m < CHUNK, each chunk's best m replace the slots, in
    chunk order, until they fit one chunk; then the best m."""
    while len(slots) > CHUNK and m < CHUNK:
        slots = [p for c0 in range(0, len(slots), CHUNK)
                 for p in _best([s for s in slots[c0:c0 + CHUNK] if s is not None], m)]
    return _best([s for s in slots if s is not None], m)


def _block_merge(slots, m, warps):
    """topm.cuh's block_merge: warp w merges the w-th of ``warps`` equal
    runs of the slots, and the warps' picks meet in one merge."""
    n = len(slots)
    runs = [slots[n * w // warps:n * (w + 1) // warps] for w in range(warps)]
    return _best([p for run in runs if run for p in _merge_slots(run, m)], m)


def _finish(x, m, blank, picks, lse):
    """The row's results from its picks: past them the EXCLUDED pool (the
    subtractions in fp32, as the kernels round them)."""
    low = min(c for c in range(len(x)) if x[c] >= EXCLUDED)
    f32 = np.float32
    vals = [f32(v) - f32(lse) for v, _ in picks] + [f32(EXCLUDED) - f32(lse)] * (m - len(picks))
    toks = [c for _, c in picks] + [min(blank, low)] * (m - len(picks))
    return f32(x[blank]) - f32(lse), np.array(vals), np.array(toks)


def model_topm(x, m, blank, *, misaligned=0, elems=4):
    """One row of topm_logsoftmax as the kernel splits it: row parts, each
    a block whose warps take the best m of their threads' values (m <= 40)
    and whose warps' picks meet in the block, or (m > 40) whose rounds take
    the part's best m; the parts' best m (m slots each) merged last; (max,
    Σexp) per part, combined in part order. ``misaligned`` elements before
    the row's first 16-byte boundary, ``elems`` values a 16-byte load."""
    x = np.asarray(x, np.float64)
    v, keys = len(x), m <= M_MAX
    part = PART if keys else ROUNDS_PART
    part_lists, stats = [], []
    for p0 in range(0, v, part):
        n = min(part, v - p0)
        mis = (misaligned + p0) % elems
        head = min(n, (elems - mis) % elems)
        tail = head + (n - head) // elems * elems
        cands = [(x[c], c) for c in range(p0, p0 + n) if c != blank and x[c] > EXCLUDED]
        if keys:  # warps over their threads' values, then the block
            warps = defaultdict(list)
            for val, c in cands:
                warps[_share(c - p0, head, tail, elems) // 32].append((val, c))
            block = _best([p for pairs in warps.values() for p in _best(pairs, m)], m)
        else:  # rounds over the cached part
            block = _best(cands, m)
        part_lists.append(block + [None] * (m - len(block)))
        seg = x[p0:p0 + n]
        mx = seg.max()
        stats.append((mx, np.exp(seg - mx).sum() if mx > -np.inf else 0.0))
    mx = max(s[0] for s in stats)
    total = sum(s * np.exp(pm - mx) for pm, s in stats if pm > -np.inf)
    slots = [p for pl in part_lists for p in pl]  # the last block's merge
    picks = _block_merge(slots, m, THREADS // 32) if keys else _merge_slots(slots, m)
    return _finish(x, m, blank, picks, mx + np.log(total))


def model_joint(logits, m, blank):
    """One row of joint_topm's merge: tiles of 32 columns each keep their
    best min(m, 32) candidates (empty slots past them); a block merges the
    tiles' slots (one warp where m > 40)."""
    x = np.asarray(logits, np.float64)
    k = min(m, TILE)
    slots = []
    for t0 in range(0, len(x), TILE):
        cands = [(x[c], c) for c in range(t0, min(len(x), t0 + TILE))
                 if c != blank and x[c] > EXCLUDED]
        best = _best(cands, k)
        slots += best + [None] * (k - len(best))
    mx = x.max()
    picks = _block_merge(slots, m, JOINT_WARPS) if m <= JOINT_LM else _merge_slots(slots, m)
    return _finish(x, m, blank, picks, mx + np.log(np.exp(x - mx).sum()))


def _check(model, jax_out, twin_out, atol):
    """Indices equal across the three; values within ``atol``."""
    for r, (lpb, vals, toks) in enumerate(model):
        np.testing.assert_array_equal(toks, np.asarray(jax_out[2])[r])
        np.testing.assert_array_equal(toks, twin_out[2][r].numpy())
        np.testing.assert_allclose(vals, np.asarray(jax_out[1])[r], atol=atol, rtol=0)
        np.testing.assert_allclose(vals, twin_out[1][r].numpy(), atol=atol, rtol=0)
        np.testing.assert_allclose(lpb, np.asarray(jax_out[0])[r], atol=atol, rtol=0)


def _run_topm(x, m, blank, **model_kw):
    """The model on each row of fp32 ``x`` against JAX (interpret) and the twin."""
    want = jtopk.topm_logsoftmax(jnp.asarray(x), m, blank, interpret=True)
    twin = topm_logsoftmax_plain(torch.from_numpy(np.asarray(x, np.float32)), m, blank)
    model = [model_topm(row, m, blank, **model_kw) for row in np.asarray(x, np.float32)]
    _check(model, want, twin, 1e-5)
    return model


@pytest.mark.parametrize("m", [1, 4, 5, 20, 21, 40, 41, 64])
def test_split_topm_list_sizes(m):
    """The served sizes (4, 20, 40), one past each, and the rounds path
    (V = 3,001)."""
    x = (np.random.default_rng(m).standard_normal((2, 3001)) * 3.0).astype(np.float32)
    _run_topm(x, m, 3000)


@pytest.mark.parametrize("v,m", [(3001, 4), (3001, 40), (20000, 4), (20000, 64)])
def test_split_topm_integer_ties(v, m):
    """Integer logits in [-3, 3]: every pick a tie across threads, warps and
    (V = 20,000) parts, the lowest column winning; blank first and last."""
    x = np.random.default_rng(v + m).integers(-3, 4, (2, v)).astype(np.float32)
    for blank in (0, v - 1):
        model = _run_topm(x, m, blank)
        assert all((toks[1:] > toks[:-1]).all() for _, _, toks in model)


@pytest.mark.parametrize("m", [4, 30, 64])
def test_split_topm_all_excluded(m):
    """Rows at or below -1e30 everywhere (-1e30, -1e31, -inf): no candidate,
    every pick the EXCLUDED pool's lowest column; and few candidates."""
    x = np.full((3, 300), EXCLUDED, np.float32)
    x[0, :150] = -np.inf
    x[1, 1::2] = -1e31
    x[2, :7] = -1e31
    x[2, [40, 200]] = [0.5, -1.0]
    for blank in (0, 5, 299):
        _run_topm(x, m, blank)


@pytest.mark.parametrize("misaligned", [1, 2, 3])
def test_split_topm_unaligned_rows(misaligned):
    """A row that starts off a 16-byte boundary shifts every thread's share
    (head, vectors, tail): the picks do not move."""
    x = (np.random.default_rng(misaligned).standard_normal((2, 3001)) * 3.0).astype(np.float32)
    aligned = _run_topm(x, 20, 7)
    shifted = _run_topm(x, 20, 7, misaligned=misaligned)
    for a, s in zip(aligned, shifted):
        np.testing.assert_array_equal(a[2], s[2])


def test_split_topm_bf16():
    """bf16 logits (8 values a 16-byte load), ties included: JAX and the
    twin take them in fp32, as the kernel does."""
    x = (np.random.default_rng(16).standard_normal((2, 2182)) * 3.0).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x32 = xb.float().numpy()
    for m in (4, 20):
        want = jtopk.topm_logsoftmax(jnp.asarray(x32, dtype=jnp.bfloat16), m, 0, interpret=True)
        twin = topm_logsoftmax_plain(xb, m, 0)
        model = [model_topm(row, m, 0, elems=8, misaligned=1) for row in x32]
        _check(model, want, twin, 1e-5)


@pytest.mark.parametrize("m", [4, 40])
def test_split_topm_several_parts(m):
    """V = 50,000: thirteen parts, each block's best m, merged last by the
    block's 8 warps, each a run of the parts' picks."""
    x = (np.random.default_rng(50 + m).standard_normal((2, 50000)) * 3.0).astype(np.float32)
    _run_topm(x, m, 49999)


@pytest.mark.parametrize("m", [4, 20, 40, 64])
@pytest.mark.parametrize("v", [301, 2182])
def test_split_joint_tiles(v, m):
    """joint_topm's 32-column tiles and its merge (16 warps, each a run of
    the tiles' picks; one warp, cutting them down a chunk at a time, at
    m = 64), on the logits of a small fp32 joint, blank first."""
    rng = np.random.default_rng(v + m)
    r, h, j = 5, 32, 64

    def randn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (randn(h, j, scale=0.2), randn(j, scale=0.1), randn(j, v, scale=0.2), randn(v, scale=0.1),
            randn(r, j), randn(r, h))
    want = jtopk.joint_topm(*map(jnp.asarray, args), m, 0, activation="tanh",
                            compute_dtype="float32", block_r=8, interpret=True)
    twin = joint_topm_plain(*map(torch.from_numpy, args), m, 0, activation="tanh",
                            compute_dtype="float32")
    wp, bp, wo, bo, enc, dec = (a.astype(np.float64) for a in args)
    logits = np.tanh(enc + (dec @ wp + bp)) @ wo + bo
    model = [model_joint(row, m, 0) for row in logits]
    _check(model, want, twin, 1e-5)
