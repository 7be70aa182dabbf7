"""The split and the sum order of the CUDA LSTM cell kernel, on the CPU.

``csrc/lstm_step.cu`` (``lstm_cell_step``) splits the gate columns over
clusters of blocks (32 hidden units a cluster, each thread a quad: four
consecutive units of one gate, one 16-byte piece of a W row) and the
depth over a cluster's ``ranks`` blocks: W_ih's rows, then W_hh's, cut into
stages, each block a contiguous share of the stages, and a thread's depth
slot d rows 4d .. 4d + 3 of each of its block's stages. Each 16-row tile runs
against the same stages. The sums meet in a fixed order: a thread's k in
order, the warp's four slots in a reduce-scatter, the block's warps, then
the ranks in rank order (pushed into the owning block's shared memory), then
the bias. A numpy model of that order, with the split the kernel picks
(modelled here by :func:`split`), is held to the JAX kernel in interpret
mode and to the port's plain twin, at fp32, within 1e-5 on h' and c'. The
kernel itself, and the split it takes on the card, are held to the twin and
to these splits in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.ops import lstm_step as jlstm
from reazonspeech_tpu_torch.ops import lstm_step as tlstm

# csrc/lstm_step.cu: units a cluster, rows a stage, rows a tile, the largest
# cluster; the shared memory one block may hold on the H100 (227 KB)
UNITS, STAGE_ROWS, RT, MAX_RANKS, MAX_SMEM = 32, 32, 16, 8, 232448


def stages(h_in, h):
    """The depth's stages: W_ih's rows, then W_hh's, in runs of STAGE_ROWS."""
    return -(-h_in // STAGE_ROWS) + -(-h // STAGE_ROWS)


def smem_bytes(ranks, slots, aligned=True):
    """Shared memory of a block (the kernel's Layout::smem_bytes): alignment
    slack, ``slots`` ring slots of W (4 gates x STAGE_ROWS x UNITS, 4
    columns more where H_in or H is not a multiple of 4) and of the tile's
    x|h, the second depth half's partial sums, the ranks' pushed sums, the
    cell's b and c, and the barriers."""
    nu = -(-UNITS // ranks)
    stage = 4 * STAGE_ROWS * (UNITS + (0 if aligned else 4))
    return (128 + slots * (4 * stage + RT * STAGE_ROWS * 4) + RT * 4 * UNITS * 4
            + ranks * RT * 4 * nu * 4 + (4 + RT) * nu * 4 + (slots + 1) * 8)


def split(h_in, h):
    """(ranks, slots, fills) as the kernel's split() picks them on the H100:
    clusters of 8 blocks (fewer below 8 stages), each block 1/ranks of the
    stages; all of a block's stages in its ring where they fit, else the
    fewest even fills of it that fit."""
    ranks = min(MAX_RANKS, stages(h_in, h))
    most = -(-stages(h_in, h) // ranks)
    aligned = h_in % 4 == 0 and h % 4 == 0
    fills = 1
    while fills < most and smem_bytes(ranks, -(-most // fills), aligned) > MAX_SMEM:
        fills += 1
    return ranks, -(-most // fills), fills


def _inputs(r, h_in, h, seed):
    """fp32 inputs from numpy; the weights shrink past a depth of 1,280 so
    that the gates keep the spread they have at nemo's width."""
    rng = np.random.default_rng(seed)
    scale = 0.1 * min(1.0, (1280 / (h_in + h)) ** 0.5)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    return (f(h_in, 4 * h, s=scale), f(h, 4 * h, s=scale), f(4 * h, s=0.1), f(r, h_in), f(r, h),
            f(r, h))


def _sigmoid(v):
    return (1.0 / (1.0 + np.exp(-v))).astype(np.float32)


def model_lstm(w_ih, w_hh, bias, x, h, c, ranks):
    """(h', c') as the kernel sums them, in fp32 (a matmul stands for a
    thread's run of FMAs over its k's: the order within it is not modelled)."""
    r, h_in = x.shape
    hid = h.shape[1]
    a, w = np.concatenate([x, h], axis=1), np.concatenate([w_ih, w_hh], axis=0)
    k = h_in + hid
    units, slots, sr = UNITS, 8, STAGE_ROWS  # 8 depth slots: 4 lanes x 2 warps
    clusters = -(-hid // units)

    # the columns: cluster j, quad q of gate q // (units / 4) -> four units
    cols = np.zeros(4 * hid, int)
    for j in range(clusters):
        for q in range(units):
            gate, u = q // (units // 4), j * units + 4 * (q % (units // 4))
            cols[[gate * hid + v for v in range(u, min(u + 4, hid))]] += 1
    assert (cols == 1).all(), "every gate column in exactly one quad"

    # the stages: runs of sr rows of W_ih, then of W_hh, as rows of [W_ih; W_hh]
    runs = [list(range(row, min(row + sr, h_in))) for row in range(0, h_in, sr)]
    runs += [list(range(h_in + row, h_in + min(row + sr, hid))) for row in range(0, hid, sr)]
    assert len(runs) == stages(h_in, hid)
    # each rank's W slice by depth slot: rows 4d .. 4d + 3 of each of its stages
    seen = np.zeros(k, int)
    slices = []
    for p in range(ranks):
        mine = runs[p * len(runs) // ranks:(p + 1) * len(runs) // ranks]
        rank = []
        for d in range(slots):
            ks = [run[i] for run in mine for i in range(4 * d, 4 * d + 4) if i < len(run)]
            seen[ks] += 1
            rank.append((ks, w[ks]))
        slices.append(rank)
    assert (seen == 1).all(), "every depth row in exactly one slot of one rank"

    gates = np.zeros((r, 4 * hid), np.float32)
    for r0 in range(0, r, RT):  # every row tile against the same slices
        at = np.zeros((RT, k), np.float32)
        at[:min(RT, r - r0)] = a[r0:r0 + RT]
        sums = []
        for rank in slices:
            part = [at[:, ks] @ ws if ks else np.zeros((RT, 4 * hid), np.float32)
                    for ks, ws in rank]
            warps = []
            for wd in range(slots // 4):  # lane s keeps rows 4s .. 4s + 3 of the tile
                p4 = part[4 * wd:4 * wd + 4]
                out = np.empty((RT, 4 * hid), np.float32)
                for s in range(4):
                    rows = slice(4 * s, 4 * s + 4)
                    out[rows] = ((p4[s][rows] + p4[s ^ 2][rows])
                                 + (p4[s ^ 1][rows] + p4[s ^ 3][rows]))
                warps.append(out)
            total = warps[0]
            for v in warps[1:]:  # the block's warps in order
                total = total + v
            sums.append(total)
        tile = sums[0]
        for v in sums[1:]:  # the ranks in order
            tile = tile + v
        gates[r0:r0 + RT] = (tile + bias)[:min(RT, r - r0)]

    # rank p applies the cell to units [ceil(p U / ranks), ceil((p + 1) U / ranks))
    # of each cluster, the units u with u ranks // U == p
    owned = np.zeros(hid, int)
    for j in range(clusters):
        for p in range(ranks):
            lo, hi = -(-p * units // ranks), -(-(p + 1) * units // ranks)
            assert all(u * ranks // units == p for u in range(lo, hi))
            owned[j * units + lo:min(j * units + hi, hid)] += 1
    assert (owned == 1).all(), "every unit applied by exactly one rank"
    i, f, g, o = np.split(gates, 4, axis=1)
    c_new = _sigmoid(f) * c + _sigmoid(i) * np.tanh(g)
    return _sigmoid(o) * np.tanh(c_new), c_new


# (r, h_in, h): nemo ALSD beam 4, espnet Graves 20, nemo ALSD beam 40 x 4
# lanes, ragged tiles, widths not multiples of 4 (8 ranks), a depth of 3,072
# (the ring in two fills) at one tile and at three; then depths of 3, 5 and
# 6 stages: 3, 5 and 6 ranks, whose units a rank are uneven (the pushes one
# float at a time)
CASES = [(16, 640, 640), (4, 256, 256), (160, 640, 640), (37, 128, 384), (4, 130, 258),
         (5, 1536, 1536), (37, 1536, 1536), (4, 64, 32), (4, 96, 64), (4, 64, 128)]


@pytest.mark.parametrize("r,h_in,h", CASES)
def test_model_matches_jax_and_twin(r, h_in, h):
    args = _inputs(r, h_in, h, seed=r + h_in + 7 * h)
    got = model_lstm(*args, split(h_in, h)[0])
    want = jlstm.lstm_cell_step(*map(jnp.asarray, args), compute_dtype="float32", interpret=True)
    twin = tlstm.lstm_cell_step_plain(*map(torch.from_numpy, args), compute_dtype="float32")
    for g, w, t in zip(got, want, twin):
        assert g.shape == (r, h)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g, t.numpy(), atol=1e-5, rtol=0)


# (h_in, h, ranks, blocks, fills): nemo's width (two blocks of it fit an
# SM), espnet's, a depth of 3,072 (in two even fills of the ring), the
# deepest slices the ring holds whole (11 stages, 10 at widths not
# multiples of 4) and the first past them, and 3, 5 and 6 stages
@pytest.mark.parametrize("h_in,h,ranks,blocks,fills", [
    (640, 640, 8, 160, 1), (256, 256, 8, 64, 1), (1536, 1536, 8, 384, 2),
    (1408, 1408, 8, 352, 1), (1440, 1440, 8, 360, 2), (1278, 1278, 8, 320, 1),
    (1290, 1290, 8, 328, 2), (64, 32, 3, 3, 1), (96, 64, 5, 10, 1), (64, 128, 6, 24, 1)])
def test_split(h_in, h, ranks, blocks, fills):
    """Clusters of 8 (fewer where the depth has fewer stages); each block's
    whole slice in its ring where it fits (W read once a call at any R),
    else the fewest even fills of it (W read once a row tile)."""
    got_ranks, slots, got_fills = split(h_in, h)
    assert (got_ranks, -(-h // UNITS) * got_ranks, got_fills) == (ranks, blocks, fills)
    aligned = h_in % 4 == 0 and h % 4 == 0
    most = -(-stages(h_in, h) // ranks)
    assert slots * fills >= most and smem_bytes(ranks, slots, aligned) <= MAX_SMEM
    assert h != 640 or 2 * (smem_bytes(ranks, slots) + 1024) <= 228 * 1024


def test_split_streams_past_shared_memory():
    """A depth whose slice cannot stay in shared memory streams through a
    ring that fits."""
    ranks, slots, fills = split(20000, 20000)
    most = -(-stages(20000, 20000) // ranks)
    assert smem_bytes(ranks, slots) <= MAX_SMEM
    assert smem_bytes(ranks, most) > MAX_SMEM and slots < most and fills > 1
