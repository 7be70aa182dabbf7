#!/usr/bin/env python3
"""Where a call of the LSTM cell kernel (row 13, csrc/lstm_step.cu) spends
its time on the card, phase by phase (GPU only).

    python3 tools/torch_lstm_trace.py

Builds csrc/lstm_step.cu with RS_LSTM_TRACE defined (thread 0 of each block
stamps %globaltimer and clock64 at seven points) into build/torch_lstm_trace/
(the port's own library is left alone), and runs it at the kernel's own
split on nemo's predictor (R=16, H_in=H=640), espnet's (R=4, H=256) and
nemo ALSD beam 40 x 4 lanes (R=160), each warm (back-to-back) and cold (a
64 MB buffer written before the call). Per shape and state one line: the
span from the first block's start to the last block's end (µs, globaltimer),
the spread of block starts and of the times the ranks' sums of the first
tile met, the SMs the blocks ran on, and the median and largest clock64
cycles of each phase over the blocks:

  0  start -> the first stage's W and x|h have landed
  1  -> the first tile's last stage is multiplied
  2  -> the warps' sums are in shared memory (reduce-scatter, block barrier)
  3  -> past the cluster barrier before the pushes
  4  -> every rank's pushed sums have landed (the pushes, the wait)
  5  -> the block's end: the first tile's cell (at R > 16, every later tile)

Each call's h' and c' are also held to torch.lstm_cell (max abs error).
The script prints the card's name and power limit first.
"""

import ctypes
import os
import statistics
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "reazonspeech_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "torch_lstm_trace")
BLOCKS = 4096  # the most blocks stamped (csrc/lstm_step.cu's g_lstm_stamps)
UNITS = 32  # hidden units a cluster


def build():
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "liblstm_stamped.so")
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                           "-Xcompiler", "-fPIC", "-DRS_LSTM_TRACE", "-I", SRC, "-shared", "-o",
                           so, os.path.join(SRC, "lstm_step.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.rs_lstm_cell_step.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.rs_lstm_stamps.argtypes = [ctypes.c_void_p]
    return lib


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(16 * 2 ** 20, device=dev)  # 64 MB

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    for label, r, h in (("nemo R=16 H=640", 16, 640), ("espnet R=4 H=256", 4, 256),
                        ("nemo beam 40 R=160 H=640", 160, 640)):
        split = [ctypes.c_int() for _ in range(3)]
        if lib.rs_lstm_split(h, h, *map(ctypes.byref, split)):
            raise RuntimeError("rs_lstm_split failed")
        ranks, slots = split[0].value, split[1].value
        blocks = -(-h // UNITS) * ranks
        w_ih, w_hh = rand(h, 4 * h, scale=h ** -0.5), rand(h, 4 * h, scale=h ** -0.5)
        bias, x, hp, cp = rand(4 * h, scale=0.1), rand(r, h), rand(r, h, scale=0.5), rand(r, h)
        h_out, c_out = torch.empty(r, h, device=dev), torch.empty(r, h, device=dev)
        want = torch.lstm_cell(x, (hp, cp), w_ih.t().contiguous(), w_hh.t().contiguous(), bias,
                               torch.zeros_like(bias))

        def call():
            err = lib.rs_lstm_cell_step(x.data_ptr(), hp.data_ptr(), cp.data_ptr(),
                                        w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
                                        h_out.data_ptr(), c_out.data_ptr(), r, h, h,
                                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"rs_lstm_cell_step: CUDA error {err}")

        for cold in (False, True):
            for _ in range(6):
                if cold:
                    flush.fill_(1.0)
                call()
            torch.cuda.synchronize()
            err = max((h_out - want[0]).abs().max().item(), (c_out - want[1]).abs().max().item())
            buf = (ctypes.c_ulonglong * (BLOCKS * 16))()
            if lib.rs_lstm_stamps(buf):
                raise RuntimeError("rs_lstm_stamps failed")
            rows = [buf[b * 16:(b + 1) * 16] for b in range(min(blocks, BLOCKS))]
            t0 = min(s[0] for s in rows)
            starts = sorted((s[0] - t0) / 1e3 for s in rows)
            met = sorted((s[5] - t0) / 1e3 for s in rows)
            phases = [[s[9 + i] - s[8 + i] for s in rows] for i in range(6)]
            print(f"{label} split (ranks {ranks}, slots {slots}), "
                  f"{'cold' if cold else 'warm'}: max abs err {err:.1e}; span "
                  f"{(max(s[6] for s in rows) - t0) / 1e3:.2f} us; block starts "
                  f"{starts[0]:.2f}..{starts[-1]:.2f} us; first tile's sums met "
                  f"{met[0]:.2f}..{met[-1]:.2f} us; SMs {len({s[15] for s in rows})}; "
                  f"phase cycles median {[int(statistics.median(p)) for p in phases]}, "
                  f"largest {[max(p) for p in phases]}", flush=True)


if __name__ == "__main__":
    main()
