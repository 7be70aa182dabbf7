"""Subprocess helper for the port's SIGTERM graceful-drain test (the port's
copy of tests/_tiny_server.py): runs the real ``serve()`` entry of
``reazonspeech_tpu_torch`` (main thread, so the signal handlers install) on a
tiny random-weight nemo model on the CPU. Imports nothing of JAX.
Usage: python _tiny_torch_server.py PORT [WAIT_MS]."""

import sys

from reazonspeech_tpu_torch.models.fastconformer import FastConformerConfig
from reazonspeech_tpu_torch.models.rnnt import RNNTConfig
from reazonspeech_tpu_torch.nemo.asr.model import load_model
from reazonspeech_tpu_torch.serving.http import serve

if __name__ == "__main__":
    port = int(sys.argv[1])
    wait_ms = float(sys.argv[2]) if len(sys.argv) > 2 else 20.0
    enc = FastConformerConfig.tiny(compute_dtype="float32")
    rnnt = RNNTConfig.tiny(enc_dim=enc.d_model, compute_dtype="float32")
    model = load_model("cpu", checkpoint="random", enc_cfg=enc, rnnt_cfg=rnnt)
    serve(model, "127.0.0.1", port, max_batch=2, max_wait_ms=wait_ms)
